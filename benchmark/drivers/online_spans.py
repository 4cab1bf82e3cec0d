"""The online driver (``online.py``) whose profiled slice also gives the
device seconds of the operations launched inside the program's
``composite`` annotation (``lib/trace.py:Slice``), which
``metrics/composite_ms.online.py`` reads. The traffic, the window, the
comparison that decides ``correct`` and the control are ``online.py``'s.
"""

from __future__ import annotations

from benchmark.drivers import online
from benchmark.drivers.online import CONTROL, check, control  # noqa: F401
from benchmark.lib.trace import Slice

SPANS = ("composite",)


class Driver(online.Driver):
    def traced_slice(self):
        pads = []
        with Slice(SPANS) as s:
            for _ in range(self.mix["slice_pushes"]):
                self.push()
                pads.append((self.online.canvas.pad_h,
                             self.online.canvas.pad_w))
        if s.summary is not None:
            s.summary.units = len(pads)
            s.summary.notes["pads"] = pads
        return s.summary
