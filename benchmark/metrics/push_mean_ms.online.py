"""The mean host ms of a push: the window's seconds over the pushes it
made, a steadier reading beside the 95th percentile that the cell is
judged by."""


def read(run):
    lat = run.layer.get("push_ms")
    return 1e3 * run.layer["window_s"] / len(lat) if lat else None
