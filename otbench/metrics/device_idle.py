"""device_idle: 1 - (the union of the device's busy intervals over the
traced window's host-clock length), in %."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
