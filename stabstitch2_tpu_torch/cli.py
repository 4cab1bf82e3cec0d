"""Command-line entry point of the port: ``stitch``.

    python -m stabstitch2_tpu_torch.cli stitch --test_path <dataset> \
        --output_path <dir> [--fusion_mode AVERAGE|LINEAR] [--device cuda]

Each <dataset>/<video>/video1 + video2 directory of jpgs becomes
<output_path>/<video>.mp4. The models carry random float32 weights drawn
from ``--seed``; loading trained checkpoints is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def cmd_stitch(args) -> int:
    import torch

    from stabstitch2_tpu_torch.config import StitchConfig
    from stabstitch2_tpu_torch.data.video_io import list_videos
    from stabstitch2_tpu_torch.pipeline.stitcher import init_stitcher

    # the slice is float32 end to end: no TF32 convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stitcher = init_stitcher(rng_seed=args.seed,
                             config=StitchConfig(fusion_mode=args.fusion_mode),
                             chunk=args.chunk, device=args.device)
    videos = list_videos(args.test_path)
    if not videos:
        print(f"no videos under {args.test_path}", file=sys.stderr)
        return 1
    os.makedirs(args.output_path, exist_ok=True)
    failed = 0
    for vd in videos:
        name = os.path.basename(vd)
        out = os.path.join(args.output_path, name + ".mp4")
        t0 = time.perf_counter()
        try:
            result = stitcher.stitch_video_dir(vd, out)
        except (ValueError, OSError, NotImplementedError) as e:
            print(f"{name}: stitch failed: {e}", file=sys.stderr)
            failed += 1
            continue
        print(f"{name}: {len(result.frames)} frames -> {out} "
              f"canvas={result.canvas.out_w}x{result.canvas.out_h} "
              f"ms={ {k: round(v, 1) for k, v in result.ms.items()} } "
              f"({time.perf_counter() - t0:.1f}s)")
    if failed == len(videos):
        print("no videos stitched", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stabstitch2_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("stitch", help="stitch two-view videos into mp4s")
    p.add_argument("--test_path", required=True,
                   help="dataset directory of <video>/video1+video2 jpgs")
    p.add_argument("--output_path", required=True)
    p.add_argument("--fusion_mode", choices=["AVERAGE", "LINEAR"],
                   default="AVERAGE")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random model weights")
    p.add_argument("--chunk", type=int, default=8)
    p.set_defaults(fn=cmd_stitch)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
