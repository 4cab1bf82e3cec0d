"""Multi-device runs (port of ``parallel/``).

The JAX package runs one program over a ``(data, model)`` mesh. The port
keeps its single-program semantics with two designs:

- inference (``--n_devices`` on ``stitch``, ``stitch-multi``, ``metric``
  and ``export-motions``): one process holds a replica of the nets on
  each device and deals the chunks round-robin
  (``pipeline/motion.py``, ``pipeline/stitcher.py``), so N devices give
  the frames of one bit for bit;
- training (``cli train --n_devices``): N processes under
  ``torch.distributed`` (:mod:`.train`), each on its rows of the global
  batch, with BatchNorm statistics over the global batch
  (``models/backbone.py:BatchNorm2d``) and the gradients averaged before
  the clip (``train/common.py:Optimizer``).

The ``model`` axis (tensor parallelism over the conv channels) is a GSPMD
layout of the same function and is not ported as a layout.
"""

from stabstitch2_tpu_torch.parallel.devices import (backend_for,
                                                    resolve_device,
                                                    resolve_devices)

__all__ = ["backend_for", "resolve_device", "resolve_devices"]
