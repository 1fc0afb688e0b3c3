"""device_ms_per_call: the union of the device's busy intervals in the
traced window over its calls, in ms: the card's side of a call."""


def read(run):
    s = run.summary
    if s is None or not run.latencies_s:
        return None
    return 1e3 * s.busy_s / len(run.latencies_s)
