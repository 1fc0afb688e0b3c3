"""study_s: the window's host-clock time over the studies it completed."""


def read(run):
    n = len(run.latencies_s)
    return run.window_s / n if n else None
