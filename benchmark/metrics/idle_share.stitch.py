"""Share of the profiled slice of steady videos in which no kernel, copy
or fill ran on the card, in %."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share
