"""The port's native frame loader (``stabstitch2_tpu_torch/native/``,
``data/native.py``) against the JAX package's, and the loaders on top of
it, on the CPU.

The port's library is built here with g++ and libjpeg
(``utils/native_build.py``); the tests skip only where g++ or libjpeg is
missing. The JAX package's library is built as
``tests/test_pipeline.py::TestNativeLoader`` builds it (``make -C
native``). Both decode the same jpgs bit for bit; against cv2 the decode
holds TestNativeLoader's bounds (hires: mean < 1.5, max <= 24 levels;
the resize: mean < 2.0), since libjpeg's IDCT and the float resize may
round differently from cv2's.
"""

import os
import pathlib
import shutil
import subprocess

import cv2
import numpy as np
import pytest

from stabstitch2_tpu_torch import cli
from stabstitch2_tpu_torch.data import datasets as td
from stabstitch2_tpu_torch.data import native as tn
from stabstitch2_tpu_torch.data import video_io as tv
from stabstitch2_tpu_torch.utils import native_build

from synthetic import make_two_view_clip, write_clip_dirs

REPO = pathlib.Path(__file__).resolve().parent.parent
MH, MW = 64, 80


@pytest.fixture(scope="module")
def port_lib():
    if shutil.which(native_build.compiler()) is None:
        pytest.skip(f"no {native_build.compiler()} to build the loader")
    if not tn.available():
        if native_build.libjpeg_missing(tn.build_error()):
            pytest.skip(f"libjpeg is missing: {tn.build_error()}")
        pytest.fail(f"the loader did not build: {tn.build_error()}")
    assert os.path.dirname(tn.BUILD.path).startswith(
        native_build.BUILD_DIR) and "native/libframeloader" not in (
            tn.BUILD.path)
    return tn


@pytest.fixture(scope="module")
def jax_lib(port_lib):
    from stabstitch2_tpu.data import native as jn

    if not jn.available():
        r = subprocess.run(["make", "-C", str(REPO / "native")],
                           capture_output=True)
        jn._TRIED = False  # re-probe
        if r.returncode != 0 or not jn.available():
            pytest.skip("the JAX package's native frameloader is unavailable")
    return jn


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    """Three 90x120 frames as quality-95 jpgs, TestNativeLoader's clip."""
    d = tmp_path_factory.mktemp("jpgs")
    v1, _ = make_two_view_clip(num_frames=3, height=90, width=120, seed=7)
    paths = []
    for t in range(3):
        p = str(d / f"{t}.jpg")
        cv2.imwrite(p, v1[t], [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two videos at 128x160, the second with a view one frame longer."""
    root = str(tmp_path_factory.mktemp("tree"))
    for seed, n in ((1, 5), (2, 4)):
        write_clip_dirs(root, num_frames=n, height=128, width=160, seed=seed,
                        video_name=f"v{seed}")
    v = os.path.join(root, "v2", "video1")
    shutil.copy(os.path.join(v, "000003.jpg"), os.path.join(v, "000004.jpg"))
    return root


@pytest.mark.parametrize("lo_size,want_hi,threads",
                         [((45, 60), True, 4), (None, True, 1),
                          ((64, 80), False, 2)])
def test_decode_equals_jax(port_lib, jax_lib, jpgs, lo_size, want_hi,
                           threads):
    got = port_lib.decode_batch(jpgs, lo_size=lo_size, threads=threads,
                                want_hi=want_hi)
    want = jax_lib.decode_batch(jpgs, lo_size=lo_size, threads=threads,
                                want_hi=want_hi)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
    assert port_lib.probe(jpgs[0]) == jax_lib.probe(jpgs[0]) == (120, 90)


def test_decode_against_cv2(port_lib, jpgs):
    hi, lo = port_lib.decode_batch(jpgs, lo_size=(45, 60))
    assert hi.shape == (3, 90, 120, 3) and lo.shape == (3, 45, 60, 3)
    ref = np.stack([cv2.imread(p) for p in jpgs]).astype(int)
    d = np.abs(hi.astype(int) - ref)
    assert d.mean() < 1.5 and d.max() <= 24
    ref_lo = np.stack([cv2.resize(r.astype(np.uint8), (60, 45)) for r in ref])
    assert np.abs(lo.astype(int) - ref_lo.astype(int)).mean() < 2.0


def test_decode_errors(port_lib, jpgs, tmp_path):
    small = str(tmp_path / "small.jpg")
    cv2.imwrite(small, np.zeros((10, 12, 3), np.uint8))
    with pytest.raises(IOError, match="1 frames failed"):
        port_lib.decode_batch(jpgs[:2] + [small])
    with pytest.raises(IOError, match="failed to probe"):
        port_lib.probe(str(tmp_path / "missing.jpg"))


def test_prefetcher_equals_decode_batch(port_lib, jpgs):
    paths = jpgs * 3
    hi, lo = port_lib.decode_batch(paths, lo_size=(32, 40))
    with port_lib.FramePrefetcher(paths, lo_size=(32, 40), ring=2) as pf:
        frames = [pf.get(i) for i in range(len(paths))]
    for i, (h, l) in enumerate(frames):
        np.testing.assert_array_equal(h, hi[i])
        np.testing.assert_array_equal(l, lo[i])
    with port_lib.FramePrefetcher(paths[:2]) as pf:
        assert pf.get(0)[1] is None


@pytest.mark.parametrize("use_native", [True, False])
def test_load_view_equals_jax(port_lib, jax_lib, tree, use_native):
    from stabstitch2_tpu.data import video_io as jv

    before = dict(tv.DECODED)
    for kw in (dict(), dict(want_hi=False, normalize=False)):
        for view in ("video1", "video2"):
            got = tv.load_view(os.path.join(tree, "v1"), view, (MH, MW),
                               use_native=use_native, **kw)
            want = jv.load_view(os.path.join(tree, "v1"), view, (MH, MW),
                                use_native=use_native, **kw)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
    got = tv.load_video_pair(os.path.join(tree, "v2"), (MH, MW))
    want = jv.load_video_pair(os.path.join(tree, "v2"), (MH, MW))
    assert got[0].shape[0] == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    which = "native" if use_native else "cv2"
    assert tv.DECODED[which] - before.get(which, 0) == 4 + (
        2 if use_native else 0)


def test_load_view_falls_back_to_cv2(port_lib, tree, tmp_path):
    """A frame libjpeg refuses (a png under a .jpg name) goes through cv2,
    which reads it; the count says so."""
    vd = tmp_path / "v"
    shutil.copytree(os.path.join(tree, "v1"), vd)
    frame = str(vd / "video1" / "000000.jpg")
    img = cv2.imread(frame)
    cv2.imwrite(str(tmp_path / "f.png"), img)
    os.replace(tmp_path / "f.png", frame)
    before = tv.DECODED["cv2"]
    hi, lo = tv.load_view(str(vd), "video1", (MH, MW))
    assert tv.DECODED["cv2"] == before + 1
    hi_cv2, lo_cv2 = tv.load_view(str(vd), "video1", (MH, MW),
                                  use_native=False)
    np.testing.assert_array_equal(hi, hi_cv2)
    np.testing.assert_array_equal(lo, lo_cv2)
    np.testing.assert_array_equal(hi[0], img)


def test_decode_many_equals_jax(port_lib, jax_lib, tree, monkeypatch):
    from stabstitch2_tpu.data import datasets as jd

    paths = tv.list_frames(os.path.join(tree, "v1"), "video1")
    paths += tv.list_frames(os.path.join(tree, "v2"), "video2")
    got = td._decode_many(paths, MH, MW)
    assert got.shape == (len(paths), MH, MW, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jd._decode_many(paths, MH, MW))
    monkeypatch.setattr(tn, "available", lambda: False)
    monkeypatch.setattr(jax_lib, "available", lambda: False)
    np.testing.assert_array_equal(td._decode_many(paths, MH, MW),
                                  jd._decode_many(paths, MH, MW))


@pytest.mark.parametrize("upload", ["i420", "bgr"])
def test_cli_frames_unchanged_without_the_resize(port_lib, jax_lib, tree,
                                                 upload):
    """``cli stitch`` decodes no model-size frames now; the frames it hands
    to ``stitch_begin`` equal those of the JAX CLI's loader (which makes
    and drops the resize) and of the port's loader with the resize."""
    from stabstitch2_tpu.data.video_io import bgr_to_i420 as j_bgr_to_i420
    from stabstitch2_tpu.data.video_io import load_video_pair as j_load_pair

    videos = tv.list_videos(tree)
    for vd, arrays, err in cli.load_videos(videos, upload):
        assert err is None and arrays[1] is None and arrays[3] is None
        j1, _, j2, _ = j_load_pair(vd, model_size=(MH, MW))
        p1, _, p2, _ = tv.load_video_pair(vd, model_size=(MH, MW))
        for got, want, mine in ((arrays[0], j1, p1), (arrays[2], j2, p2)):
            if upload == "i420":
                want, mine = j_bgr_to_i420(want), tv.bgr_to_i420(mine)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, mine)
    hi, lo = tv.load_view(videos[0], "video1", model_size=None,
                          use_native=False)
    assert lo is None and hi.shape == (5, 128, 160, 3)


def test_cli_logs_the_decoder(port_lib, tree, capsys, monkeypatch):
    cli.report_decoder()
    cli.report_decoder(done=True)
    out = capsys.readouterr()
    assert "frame decoder: {" in out.out and out.err == ""
    monkeypatch.setattr(tn, "_TRIED", True)
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_ERROR", "cannot find -ljpeg")
    cli.report_decoder()
    assert "cv2 (native loader unavailable: cannot find -ljpeg)" in (
        capsys.readouterr().err)
    assert native_build.libjpeg_missing("cannot find -ljpeg")
    assert native_build.libjpeg_missing(
        "fatal error: jpeglib.h: No such file or directory")
    assert not native_build.libjpeg_missing("error: expected ';'")
