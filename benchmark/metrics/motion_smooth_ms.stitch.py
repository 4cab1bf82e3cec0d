"""Device ms per frame of the motion and smoothing over the profiled
slice of steady videos: the device time of the operations launched inside
the stitcher's ``spatial``, ``temporal`` and ``smooth`` annotations (with
fused motion, the replays of the motion and smoothing programs), over the
slice's frames."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    s = sum(t.span_s.get(k, 0.0) for k in ("spatial", "temporal", "smooth"))
    return 1e3 * s / t.units if s else None
