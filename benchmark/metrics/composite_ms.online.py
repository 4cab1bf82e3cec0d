"""Device ms per push of the online composite over the profiled slice of
steady pushes: the device time of the operations launched inside the
online stitcher's ``composite`` annotation (the meshes' scaling and
extent, the TPS solve, K2, the fusion, the crop and the copies of the
panorama and the extent to the host), over the slice's pushes."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    s = t.span_s.get("composite", 0.0)
    return 1e3 * s / t.units if s else None
