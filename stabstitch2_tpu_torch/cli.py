"""Command-line entry point of the port: ``stitch``, ``stitch-multi``,
``metric``, ``train`` and ``export-motions``.

    python -m stabstitch2_tpu_torch.cli stitch --test_path <dataset> \
        [--output_path <dir>] [shared flags]
    python -m stabstitch2_tpu_torch.cli stitch-multi --video_dir <dir> \
        [--output <mp4 or dir>] [shared flags]
    python -m stabstitch2_tpu_torch.cli metric --test_path <dataset> \
        [--max_videos N] [--out_json <file>] [shared flags]

    python -m stabstitch2_tpu_torch.cli train {spatial,temporal,smooth} \
        --train_path <dataset> [--test_path <dataset>] [--preset ssd|tra] \
        [--model_dir <dir>] [--summary_dir <dir>] [--max_epoch N] \
        [--max_steps_per_epoch N] [--vgg_pth <file>] [--n_devices N] \
        [--device cuda|cpu] [--seed N]
    python -m stabstitch2_tpu_torch.cli export-motions --train_path <dataset> \
        [--which spatial|temporal|both] [shared flags]

Shared flags: [--reference_pth_dir <dir>] [--preset ssd|tra]
[--fusion_mode AVERAGE|LINEAR] [--warp_mode NORMAL|FAST] [--chunk N]
[--download_format yuv420|bgr] [--upload_format i420|bgr]
[--no_phase_sync] [--trace_dir <dir>] [--n_devices N] [--device cuda|cpu]
[--seed N] [--eager_motion] [--fused_motion]; ``--trace_dir`` traces
``stitch`` only, the other commands ignore it. As in the JAX CLI, the
motion and smoothing of a video run as captured programs (CUDA graphs on
the card, ``utils/graphs.py``); ``--eager_motion`` runs them eagerly, and
``--fused_motion``, the default, is accepted. The per-video phase ms read
the card's time from CUDA events, which no phase waits for;
``--no_phase_sync`` reads the host's clock at each phase instead (the
times the phases were enqueued). ``--n_devices N`` deals the chunks of every video over N cards
(N replicas on the CPU with ``--device cpu``), with the frames of one
card; it raises when fewer cards are visible.

``stitch``: each <dataset>/<video>/video1 + video2 directory of jpgs
becomes <output_path>/<video>.mp4 (default ``results/``; ``stitch-multi``
writes ``out.mp4`` by default). Frames are decoded by the native loader
(``data/native.py``, built on first use with g++ and libjpeg), with cv2
as the fallback; the log names the decoder. At the defaults, as the JAX CLI:
bfloat16 trunks, frames packed to I420 on the host (1.5 bytes per pixel;
BGR for odd sizes), unpacked and resized to the model input on the
device, the fused composite kernel, the yuv420 download; a loader thread
decodes the next video while the device stitches this one, and video k+1
is begun before video k is finished and encoded.

``stitch-multi``: a clip of video1..videoN views (or a dataset of such
clips, one mp4 each) is stitched as a chain of adjacent pairs, with the
same defaults; clip k+1 is begun before clip k is finished.

``metric``: PSNR, SSIM, stability and distortion per video, per
StabStitch-D category and on average, from uint8 BGR uploads by default;
a video is one captured program per 16-frame length bucket (one replay
per video, ``metrics/harness.py``), eager at its true length with
``--eager_motion``.

``train``: one stage's trainer (``train/loop.py``), float32 with TF32
off, writing ``step_<N>.pth`` checkpoints to ``--model_dir`` (default
``model_<stage>_<preset>``) and resuming from the latest there. A
trainer's checkpoint is a reference-style ``{'model': state_dict, ...}``
file: copied into one directory as ``spatial_warp.pth``,
``temporal_warp.pth`` and ``smooth_warp.pth``, the three load through
``--reference_pth_dir``. The tra preset's perceptual term needs
torchvision's VGG-19 weights (``--vgg_pth``).

``export-motions``: the stitcher's spatial and temporal nets write the
Spatial/TemporalMotion npy streams the smooth trainer reads; with
``--reference_pth_dir`` only ``spatial_warp.pth`` and
``temporal_warp.pth`` need to exist there.

Without ``--reference_pth_dir`` the models carry random weights drawn
from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

# one loaded video: (its directory, (hi1, lo1, hi2, lo2) or None, the
# error that kept it from loading or None)
Loaded = Tuple[str, Optional[tuple], Optional[BaseException]]


def load_videos(videos: Iterable[str], upload_format: str = "i420"
                ) -> Iterator[Loaded]:
    """Decode each video directory (native, cv2 as the fallback; no
    model-size frames: the stitcher makes the model input on the device);
    with ``upload_format`` 'i420' pack the frames to I420 (odd sizes stay
    BGR). A video that fails to load is yielded with its error, for the
    consumer to report."""
    from stabstitch2_tpu_torch.data.video_io import (bgr_to_i420,
                                                     load_video_pair)

    for vd in videos:
        try:
            hi1, _, hi2, _ = load_video_pair(vd, model_size=None)
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


def two_deep(loaded: Iterable[Loaded], begin: Callable,
             finish: Callable) -> Tuple[int, int]:
    """Begin every loaded item, ``begin(arrays) -> pending``, and finish
    each, ``finish(name, pending, t0)``, only after the next one is begun.
    An item that fails to load, begin or finish is reported and skipped.
    Returns (done, failed)."""
    done = failed = 0

    def end(name, pending, t0):
        nonlocal done, failed
        try:
            finish(name, pending, t0)
        except Exception as e:  # noqa: BLE001 - the run goes on
            print(f"{name}: stitch failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            return
        done += 1

    in_flight = None
    for path, arrays, err in loaded:
        name = os.path.basename(path.rstrip("/"))
        if err is not None:
            print(f"{name}: load failed: {err}", file=sys.stderr)
            failed += 1
            continue
        t0 = time.perf_counter()
        try:
            pending = begin(arrays)
        except Exception as e:  # noqa: BLE001 - too short, canvas too big
            print(f"{name}: stitch failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            continue
        if in_flight is not None:
            end(*in_flight)
        in_flight = (name, pending, t0)
    if in_flight is not None:
        end(*in_flight)
    return done, failed


def stitch_stream(stitcher, loaded: Iterable[Loaded],
                  sink: Callable[[str, object], None],
                  trace_dir: Optional[str] = None) -> Tuple[int, int]:
    """Stitch every loaded video, two deep (:func:`two_deep`): video k+1
    is begun before video k is finished and handed to ``sink(name,
    result)``. ``trace_dir`` traces each ``stitch_begin``
    (``utils/profiling.py``). Returns (stitched, failed)."""
    from stabstitch2_tpu_torch.utils.profiling import trace

    def begin(arrays):
        with trace(trace_dir):
            return stitcher.stitch_begin(*arrays)

    def finish(name, pending, t0):
        result = stitcher.stitch_finish(pending)
        sink(name, result)
        print(f"{name}: {len(result.frames)} frames "
              f"canvas={result.canvas.out_w}x{result.canvas.out_h} "
              f"ms={ {k: round(v, 1) for k, v in result.ms.items()} } "
              f"fps={ {k: round(v, 1) for k, v in result.fps.items()} } "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

    return two_deep(loaded, begin, finish)


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


def report_decoder(done: bool = False) -> None:
    """Log the frame decoder: before a run, whether the native loader is
    available (the build's message where it is not); after it, how many
    view loads each decoder ran (``data/video_io.py:DECODED``)."""
    from stabstitch2_tpu_torch.data import native
    from stabstitch2_tpu_torch.data.video_io import DECODED

    if done:
        print(f"frame decoder: {dict(DECODED)} view loads", flush=True)
    elif not native.available():
        print("frame decoder: cv2 (native loader unavailable: "
              f"{native.build_error()})", file=sys.stderr, flush=True)


def no_tf32() -> None:
    """float32 means float32 where it runs (SmoothNet, the geometry, the
    trainers and float32 parity runs): no TF32 convolutions or products."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_stitcher(args, files=None):
    """The stitcher of the shared flags (:func:`add_stitcher_args`);
    ``files`` limits the ``.pth`` files read from ``--reference_pth_dir``
    (default: the triad)."""
    from stabstitch2_tpu_torch.config import StitchConfig, preset_fusion_mode
    from stabstitch2_tpu_torch.utils.checkpoint import (TRIAD,
                                                        stitcher_from_checkpoint)

    no_tf32()
    config = StitchConfig(
        fusion_mode=preset_fusion_mode(args.preset, args.fusion_mode),
        warp_mode=args.warp_mode, download_format=args.download_format)
    stitcher = stitcher_from_checkpoint(
        reference_pth_dir=args.reference_pth_dir, files=files or TRIAD,
        rng_seed=args.seed, config=config, chunk=args.chunk,
        n_devices=args.n_devices, device=args.device)
    stitcher.sync_phases = not args.no_phase_sync
    stitcher.fused_motion = not args.eager_motion
    return stitcher


def cmd_stitch(args) -> int:
    from stabstitch2_tpu_torch.data.video_io import list_videos

    stitcher = build_stitcher(args)
    videos = list_videos(args.test_path)
    if not videos:
        print(f"no videos under {args.test_path}", file=sys.stderr)
        return 1
    os.makedirs(args.output_path, exist_ok=True)
    report_decoder()
    loaded = threaded(load_videos(videos, args.upload_format))
    done, failed = stitch_stream(stitcher, loaded, mp4_sink(args.output_path),
                                 trace_dir=args.trace_dir)
    report_decoder(done=True)
    if done == 0:
        print("no videos stitched", file=sys.stderr)
        return 1
    if failed:
        print(f"{done} stitched, {failed} failed or skipped", file=sys.stderr)
    return 0


def multi_clips(root: str) -> Tuple[List[str], bool]:
    """The clips under ``stitch-multi --video_dir``: the directory itself
    when it holds video1..videoN (one clip), else each subdirectory that
    does (a dataset). Returns (clips, dataset mode)."""
    from stabstitch2_tpu_torch.pipeline.threeview import view_dirs

    if view_dirs(root):
        return [root], False
    return [os.path.join(root, d) for d in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, d))
            and view_dirs(os.path.join(root, d))], True


def cmd_stitch_multi(args) -> int:
    from stabstitch2_tpu_torch.data.video_io import (bgr_to_i420, load_view,
                                                     write_video)
    from stabstitch2_tpu_torch.pipeline.threeview import (stitch_multi_begin,
                                                          stitch_multi_finish,
                                                          view_dirs)

    stitcher = build_stitcher(args)
    clips, dataset = multi_clips(args.video_dir)
    if not clips:
        print(f"no videoN subdirectories under {args.video_dir}",
              file=sys.stderr)
        return 1
    # a dataset writes <output>/<name>.mp4, even for one clip; a single
    # clip writes --output itself
    if dataset:
        os.makedirs(args.output, exist_ok=True)
    report_decoder()

    def load():
        for vd in clips:
            try:
                his = [load_view(vd, v, model_size=None)[0]
                       for v in view_dirs(vd)]
            except (OSError, ValueError) as e:
                yield vd, None, e
                continue
            if args.upload_format == "i420":
                try:
                    his = [bgr_to_i420(h) for h in his]
                except ValueError:      # odd sizes stay BGR
                    pass
            yield vd, his, None

    def finish(name, pending, t0):
        frames, fmt = stitch_multi_finish(pending)
        out = (os.path.join(args.output, name + ".mp4") if dataset
               else args.output)
        write_video(out, frames, frame_format=fmt)
        h = frames.shape[1] if fmt == "bgr" else frames.shape[1] * 2 // 3
        print(f"{name}: {len(frames)} frames -> {out} ({frames.shape[2]}x{h}, "
              f"{len(frames) / (time.perf_counter() - t0):.2f} fps)",
              flush=True)

    done, failed = two_deep(threaded(load()),
                            lambda his: stitch_multi_begin(stitcher, his),
                            finish)
    report_decoder(done=True)
    if done == 0:
        print("no videos stitched", file=sys.stderr)
        return 1
    if failed:
        print(f"{done} stitched, {failed} failed or skipped", file=sys.stderr)
    return 0


def cmd_metric(args) -> int:
    from stabstitch2_tpu_torch.metrics.harness import evaluate_dataset

    stitcher = build_stitcher(args)
    report_decoder()
    report = evaluate_dataset(stitcher, args.test_path,
                              max_videos=args.max_videos,
                              upload=args.upload_format)
    report_decoder(done=True)
    print(json.dumps({k: v for k, v in report.items() if k != "per_video"},
                     indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return 0


def cmd_train(args) -> int:
    import dataclasses

    from stabstitch2_tpu_torch import config as C
    from stabstitch2_tpu_torch.train import loop

    no_tf32()
    presets = {"spatial": C.spatial_train_preset,
               "temporal": C.temporal_train_preset,
               "smooth": C.smooth_train_preset}
    cfg = presets[args.stage](args.preset)
    if args.max_epoch:
        cfg = dataclasses.replace(cfg, max_epoch=args.max_epoch)
    common = dict(model_dir=args.model_dir, summary_dir=args.summary_dir,
                  seed=args.seed, max_steps_per_epoch=args.max_steps_per_epoch,
                  n_devices=args.n_devices, device=args.device)
    if args.stage == "spatial":
        vgg = None
        # the ~550 MB state_dict is read only when the recipe uses it
        if args.vgg_pth and cfg.perception_weight > 0:
            import torch

            from stabstitch2_tpu_torch.models.vgg import vgg19_state_dict

            vgg = vgg19_state_dict(torch.load(args.vgg_pth,
                                              map_location="cpu",
                                              weights_only=True))
        loop.train_spatial(args.train_path, args.test_path, cfg,
                           vgg_state_dict=vgg, **common)
    elif args.stage == "temporal":
        loop.train_temporal(args.train_path, cfg, **common)
    else:
        loop.train_smooth(args.train_path, cfg, **common)
    return 0


def cmd_export(args) -> int:
    from stabstitch2_tpu_torch.train.export import (export_spatial_motions,
                                                    export_temporal_motions)
    from stabstitch2_tpu_torch.utils.checkpoint import TRIAD

    stitcher = build_stitcher(args, files=TRIAD[:2])
    if args.which in ("spatial", "both"):
        n = export_spatial_motions(stitcher, args.train_path)
        print(f"exported {n} spatial motion frames")
    if args.which in ("temporal", "both"):
        n = export_temporal_motions(stitcher, args.train_path)
        print(f"exported {n} temporal motion frames")
    return 0


def add_stitcher_args(p: argparse.ArgumentParser, download: str,
                      upload: str) -> None:
    """The flags every command shares: the stitcher and its config, the
    transfer formats (defaults per command) and the device."""
    p.add_argument("--reference_pth_dir", default=None,
                   help="directory with the reference's spatial_warp.pth, "
                        "temporal_warp.pth and smooth_warp.pth")
    p.add_argument("--preset", choices=["ssd", "tra"], default="ssd",
                   help="reference preset: ssd fuses AVERAGE, tra LINEAR")
    p.add_argument("--fusion_mode", choices=["AVERAGE", "LINEAR"],
                   default=None, help="overrides the preset's fusion")
    p.add_argument("--warp_mode", choices=["NORMAL", "FAST"], default="NORMAL")
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--download_format", choices=["bgr", "yuv420"],
                   default=download,
                   help="composite transfer format: yuv420 (encoder-native "
                        "I420, half the device->host bytes) or bgr; "
                        f"default {download}")
    p.add_argument("--upload_format", choices=["i420", "bgr"],
                   default=upload,
                   help="frame upload packing: i420 (1.5 bytes per pixel, "
                        "BGR for odd sizes) or bgr; default " + upload)
    p.add_argument("--no_phase_sync", action="store_true",
                   help="report each phase's ms on the host's clock (the "
                        "time it was enqueued) instead of the card's time "
                        "from CUDA events; neither waits for the card")
    p.add_argument("--trace_dir", default=None,
                   help="stitch: write a torch.profiler Chrome trace of each "
                        "video's stitch_begin (host and card) here; the "
                        "other commands accept it and ignore it")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel inference: deal the frame chunks over "
                        "this many cards (replicas on the CPU with --device "
                        "cpu); raises if fewer cards are visible")
    p.add_argument("--fused_motion", action="store_true",
                   help="(the default) run the motion and smoothing of a "
                        "video as captured programs: CUDA graphs on the card; "
                        "accepted for compatibility")
    p.add_argument("--eager_motion", action="store_true",
                   help="run the motion and smoothing eagerly, kernel by "
                        "kernel")
    add_device_args(p)


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random model weights")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="stabstitch2_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("stitch", help="stitch two-view videos into mp4s")
    p.add_argument("--test_path", required=True,
                   help="dataset directory of <video>/video1+video2 jpgs")
    p.add_argument("--output_path", default="results/")
    add_stitcher_args(p, download="yuv420", upload="i420")
    p.set_defaults(fn=cmd_stitch)

    p = sub.add_parser("stitch-multi",
                       help="stitch N >= 2 views into one panorama mp4")
    p.add_argument("--video_dir", required=True,
                   help="a clip directory of video1..videoN jpg folders, or "
                        "a dataset directory of such clips")
    p.add_argument("--output", default="out.mp4",
                   help="the mp4 of a single clip, or the directory of "
                        "<clip>.mp4 for a dataset")
    add_stitcher_args(p, download="yuv420", upload="i420")
    p.set_defaults(fn=cmd_stitch_multi)

    p = sub.add_parser("metric",
                       help="PSNR, SSIM, stability and distortion over a "
                            "dataset")
    p.add_argument("--test_path", required=True,
                   help="dataset directory of <video>/video1+video2 jpgs")
    p.add_argument("--max_videos", type=int, default=None)
    p.add_argument("--out_json", default=None,
                   help="write the report, per video included, here")
    add_stitcher_args(p, download="bgr", upload="bgr")
    p.set_defaults(fn=cmd_metric)

    p = sub.add_parser("train", help="train one stage")
    p.add_argument("stage", choices=["spatial", "temporal", "smooth"])
    p.add_argument("--train_path", required=True,
                   help="dataset directory of <video>/video1+video2 jpgs "
                        "(smooth: with the export-motions streams)")
    p.add_argument("--test_path", default=None,
                   help="spatial: score SSIM here after each epoch and keep "
                        "the best checkpoint")
    p.add_argument("--preset", choices=["ssd", "tra"], default="ssd",
                   help="the reference recipe")
    p.add_argument("--model_dir", default=None,
                   help="checkpoint directory (default model_<stage>_<preset>)")
    p.add_argument("--summary_dir", default=None,
                   help="tensorboard scalars here (needs tensorboardX)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--vgg_pth", default=None,
                   help="torchvision vgg19 state_dict (.pth) for the tra "
                        "recipe's perceptual term (spatial stage); required "
                        "when the preset weighs it")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel training: this many processes "
                        "(torch.distributed; NCCL over cards, gloo on the "
                        "CPU), each on its rows of the batch, BatchNorm over "
                        "the global batch; raises if fewer cards are visible")
    add_device_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("export-motions",
                       help="write the Spatial/TemporalMotion npy streams")
    p.add_argument("--train_path", required=True)
    p.add_argument("--which", choices=["spatial", "temporal", "both"],
                   default="both")
    add_stitcher_args(p, download="bgr", upload="bgr")
    p.set_defaults(fn=cmd_export)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.cmd == "train" and args.model_dir is None:
        args.model_dir = f"model_{args.stage}_{args.preset}"
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
