"""Command-line entry point of the port: ``stitch``.

    python -m stabstitch2_tpu_torch.cli stitch --test_path <dataset> \
        --output_path <dir> [--reference_pth_dir <dir>] [--preset ssd|tra] \
        [--fusion_mode AVERAGE|LINEAR] [--warp_mode NORMAL|FAST] \
        [--download_format yuv420|bgr] [--upload_format i420|bgr] \
        [--trace_dir <dir>] [--no_phase_sync] [--device cuda|cpu]

Each <dataset>/<video>/video1 + video2 directory of jpgs becomes
<output_path>/<video>.mp4. At the defaults, as the JAX CLI: bfloat16
trunks, frames packed to I420 on the host (1.5 bytes per pixel; BGR for
odd sizes), unpacked and resized to the model input on the device, the
fused composite kernel, the yuv420 download; a loader thread decodes the
next video while the device stitches this one, and video k+1 is begun
before video k is finished and encoded. Without ``--reference_pth_dir``
the models carry random weights drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

# one loaded video: (its directory, (hi1, lo1, hi2, lo2) or None, the
# error that kept it from loading or None)
Loaded = Tuple[str, Optional[tuple], Optional[BaseException]]


def load_videos(videos: Iterable[str], model_size: Tuple[int, int],
                upload_format: str = "i420") -> Iterator[Loaded]:
    """Decode each video directory; with ``upload_format`` 'i420' pack
    the frames to I420 (odd sizes stay BGR). A video that fails to load
    is yielded with its error, for the consumer to report."""
    from stabstitch2_tpu_torch.data.video_io import (bgr_to_i420,
                                                     load_video_pair)

    for vd in videos:
        try:
            hi1, _, hi2, _ = load_video_pair(vd, model_size=model_size)
        except (OSError, ValueError) as e:
            yield vd, None, e
            continue
        if upload_format == "i420":
            try:
                hi1, hi2 = bgr_to_i420(hi1), bgr_to_i420(hi2)
            except ValueError:
                pass
        yield vd, (hi1, None, hi2, None), None


def threaded(items: Iterable[Loaded]) -> Iterator[Loaded]:
    """Iterate ``items`` on a loader thread that stays one item ahead
    (cv2 releases the interpreter lock while it decodes)."""
    q: queue.Queue = queue.Queue(maxsize=1)

    def run():
        try:
            for item in items:
                q.put((item, None))
        except Exception as e:  # handed to the consumer, raised there
            q.put((None, e))
        q.put(None)

    threading.Thread(target=run, daemon=True).start()
    while (got := q.get()) is not None:
        item, err = got
        if err is not None:
            raise err
        yield item


def stitch_stream(stitcher, loaded: Iterable[Loaded],
                  sink: Callable[[str, object], None],
                  trace_dir: Optional[str] = None) -> Tuple[int, int]:
    """Stitch every loaded video, two deep: video k+1 is begun before
    video k is finished and handed to ``sink(name, result)``. One video
    that fails to load, begin, finish or sink is reported and skipped.
    ``trace_dir`` traces each ``stitch_begin`` (``utils/profiling.py``).
    Returns (stitched, failed)."""
    from stabstitch2_tpu_torch.utils.profiling import trace

    done = failed = 0

    def finish(name, pending, t0):
        nonlocal done, failed
        try:
            result = stitcher.stitch_finish(pending)
            sink(name, result)
        except Exception as e:  # noqa: BLE001 - the run goes on
            print(f"{name}: stitch failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            return
        done += 1
        print(f"{name}: {len(result.frames)} frames "
              f"canvas={result.canvas.out_w}x{result.canvas.out_h} "
              f"ms={ {k: round(v, 1) for k, v in result.ms.items()} } "
              f"fps={ {k: round(v, 1) for k, v in result.fps.items()} } "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

    in_flight = None
    for vd, arrays, err in loaded:
        name = os.path.basename(vd)
        if err is not None:
            print(f"{name}: load failed: {err}", file=sys.stderr)
            failed += 1
            continue
        t0 = time.perf_counter()
        try:
            with trace(trace_dir):
                pending = stitcher.stitch_begin(*arrays)
        except Exception as e:  # noqa: BLE001 - too short, canvas too big
            print(f"{name}: stitch failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            continue
        if in_flight is not None:
            finish(*in_flight)
        in_flight = (name, pending, t0)
    if in_flight is not None:
        finish(*in_flight)
    return done, failed


def mp4_sink(output_path: str) -> Callable[[str, object], None]:
    """A sink that encodes each result to <output_path>/<name>.mp4."""
    from stabstitch2_tpu_torch.data.video_io import write_video

    def sink(name, result):
        t0 = time.perf_counter()
        write_video(os.path.join(output_path, name + ".mp4"), result.frames,
                    frame_format=result.frame_format)
        result.fps["encode"] = len(result.frames) / max(
            time.perf_counter() - t0, 1e-9)

    return sink


def build_stitcher(args):
    """The stitcher of the ``stitch`` flags."""
    from stabstitch2_tpu_torch.config import StitchConfig, preset_fusion_mode
    from stabstitch2_tpu_torch.utils.checkpoint import stitcher_from_checkpoint

    config = StitchConfig(
        fusion_mode=preset_fusion_mode(args.preset, args.fusion_mode),
        warp_mode=args.warp_mode, download_format=args.download_format)
    stitcher = stitcher_from_checkpoint(
        reference_pth_dir=args.reference_pth_dir, rng_seed=args.seed,
        config=config, chunk=args.chunk, device=args.device)
    stitcher.sync_phases = not args.no_phase_sync
    return stitcher


def cmd_stitch(args) -> int:
    import torch

    from stabstitch2_tpu_torch.data.video_io import list_videos

    # float32 means float32 where it runs (SmoothNet, the geometry, and
    # the trunks of float32 parity runs): no TF32 convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stitcher = build_stitcher(args)
    videos = list_videos(args.test_path)
    if not videos:
        print(f"no videos under {args.test_path}", file=sys.stderr)
        return 1
    os.makedirs(args.output_path, exist_ok=True)
    loaded = threaded(load_videos(videos, (stitcher.model_h, stitcher.model_w),
                                  args.upload_format))
    done, failed = stitch_stream(stitcher, loaded, mp4_sink(args.output_path),
                                 trace_dir=args.trace_dir)
    if done == 0:
        print("no videos stitched", file=sys.stderr)
        return 1
    if failed:
        print(f"{done} stitched, {failed} failed or skipped", file=sys.stderr)
    return 0


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="stabstitch2_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("stitch", help="stitch two-view videos into mp4s")
    p.add_argument("--test_path", required=True,
                   help="dataset directory of <video>/video1+video2 jpgs")
    p.add_argument("--output_path", required=True)
    p.add_argument("--reference_pth_dir", default=None,
                   help="directory with the reference's spatial_warp.pth, "
                        "temporal_warp.pth and smooth_warp.pth")
    p.add_argument("--preset", choices=["ssd", "tra"], default="ssd",
                   help="reference preset: ssd fuses AVERAGE, tra LINEAR")
    p.add_argument("--fusion_mode", choices=["AVERAGE", "LINEAR"],
                   default=None, help="overrides the preset's fusion")
    p.add_argument("--warp_mode", choices=["NORMAL", "FAST"], default="NORMAL")
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of each "
                        "video's stitch_begin (host and card) here")
    p.add_argument("--download_format", choices=["bgr", "yuv420"],
                   default="yuv420",
                   help="composite transfer format: yuv420 (default; "
                        "encoder-native I420, half the device->host bytes) "
                        "or bgr")
    p.add_argument("--upload_format", choices=["i420", "bgr"],
                   default="i420",
                   help="frame upload packing: i420 (default; 1.5 bytes "
                        "per pixel, BGR for odd sizes) or bgr")
    p.add_argument("--no_phase_sync", action="store_true",
                   help="enqueue each video without the per-phase waits "
                        "(the phase ms become enqueue times)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random model weights")
    p.set_defaults(fn=cmd_stitch)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
