"""Device ms per frame of the composite over the profiled slice of steady
videos: the device time of the operations launched inside the stitcher's
``composite`` annotation (the TPS solves, K2, the fusion, the 4:2:0
conversion and the copies to the host), over the slice's frames."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    s = t.span_s.get("composite", 0.0)
    return 1e3 * s / t.units if s else None
