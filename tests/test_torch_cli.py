"""The port's CLI flags against the JAX package's, on the CPU.

Argument lists written for the JAX CLI (defaults left out, then with
``--trace_dir``) parse with both parsers; the keys both define must hold
the same values, ``--n_devices`` among them (the four stitcher commands
and ``train``). The JAX CLI keeps the transfer formats None and resolves
them per command when it runs (``stabstitch2_tpu/cli.py:_build_stitcher``,
``cmd_metric``); the port's parser holds the resolved values, so JAX's
None is read as its resolution. ``--fused_motion`` (the default, accepted)
and ``--eager_motion`` are shared keys of the four stitcher commands, and
the port's ``build_stitcher`` applies ``--eager_motion`` as JAX's
``_build_stitcher`` does. Flags left out of the port by design
(``--ckpt_dir``, ``convert``) are not shared keys.
"""

import pytest

import stabstitch2_tpu.cli as jcli
from stabstitch2_tpu_torch import cli

# what the JAX commands make of download_format / upload_format None
RESOLVED = {"stitch": ("yuv420", "i420"), "stitch-multi": ("yuv420", "i420"),
            "metric": ("bgr", "bgr"), "export-motions": ("bgr", "bgr")}
HANDLERS = {"stitch": "cmd_stitch", "stitch-multi": "cmd_stitch_multi",
            "metric": "cmd_metric", "export-motions": "cmd_export",
            "train": "cmd_train"}
ARGV = {
    "stitch": ["stitch", "--test_path", "data"],
    "stitch-multi": ["stitch-multi", "--video_dir", "clip"],
    "metric": ["metric", "--test_path", "data", "--max_videos", "2"],
    "export-motions": ["export-motions", "--train_path", "data"],
}
FLAGS = ["--preset", "tra", "--warp_mode", "FAST", "--chunk", "4",
         "--download_format", "bgr", "--upload_format", "bgr",
         "--no_phase_sync", "--reference_pth_dir", "triad",
         "--n_devices", "2"]


def jax_args(argv, monkeypatch):
    """The namespace the JAX CLI's parser makes of ``argv`` (its handler
    replaced by a recorder)."""
    got = []
    monkeypatch.setattr(jcli, HANDLERS[argv[0]], lambda a: got.append(a) or 0)
    assert jcli.main(argv) == 0
    return vars(got[0])


def shared(j, t, cmd):
    j = dict(j)
    if cmd in RESOLVED:
        down, up = RESOLVED[cmd]
        j["download_format"] = j["download_format"] or down
        j["upload_format"] = j["upload_format"] or up
    keys = (set(j) & set(t)) - {"fn"}
    return {k: j[k] for k in keys}, {k: t[k] for k in keys}


@pytest.mark.parametrize("cmd", list(ARGV))
@pytest.mark.parametrize("extra", [[], ["--trace_dir", "traces"], FLAGS,
                                   ["--eager_motion"], ["--fused_motion"]])
def test_jax_argv_parses_the_same(cmd, extra, monkeypatch):
    argv = ARGV[cmd] + extra
    j, t = shared(jax_args(argv, monkeypatch),
                  vars(cli.make_parser().parse_args(argv)), cmd)
    assert j == t and {"trace_dir", "fused_motion", "eager_motion"} <= set(j)
    assert t["trace_dir"] == ("traces" if "--trace_dir" in extra else None)
    assert t["eager_motion"] == ("--eager_motion" in extra)


@pytest.mark.parametrize("extra", [[], ["--fused_motion"], ["--eager_motion"]])
def test_eager_motion_builds_an_eager_stitcher(extra, monkeypatch):
    """``build_stitcher`` sets ``fused_motion`` as JAX's ``_build_stitcher``
    does: off with ``--eager_motion``, on otherwise."""
    import stabstitch2_tpu_torch.utils.checkpoint as ckpt

    class Stub:
        fused_motion = True

    monkeypatch.setattr(ckpt, "stitcher_from_checkpoint",
                        lambda **kw: Stub())
    args = cli.make_parser().parse_args(ARGV["stitch"] + extra
                                        + ["--device", "cpu"])
    assert cli.build_stitcher(args).fused_motion == (extra != [
        "--eager_motion"])


@pytest.mark.parametrize("extra", [[], ["--n_devices", "2"]])
def test_jax_train_argv_parses_the_same(extra, monkeypatch):
    argv = ["train", "temporal", "--train_path", "data", "--model_dir", "m",
            "--max_epoch", "3"] + extra
    j, t = shared(jax_args(argv, monkeypatch),
                  vars(cli.make_parser().parse_args(argv)), "train")
    assert j == t and "n_devices" in j
    assert t["n_devices"] == (2 if extra else None)


def test_output_defaults():
    args = cli.make_parser().parse_args(["stitch", "--test_path", "d"])
    assert args.output_path == "results/"
    args = cli.make_parser().parse_args(["stitch-multi", "--video_dir", "c"])
    assert args.output == "out.mp4"
