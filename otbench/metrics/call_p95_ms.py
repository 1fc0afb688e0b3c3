"""call_p95_ms: the 95th percentile (linear between order statistics) of
the host-clock latency of every call in the window, each ending in a
synchronize."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3 if run.latencies_s else None
