"""models_per_s: source models evaluated with their gradient, over the
window's whole host-clock time (every unit counted finished inside it)."""

from otbench.generator import models_per_unit


def read(run):
    n = len(run.latencies_s)
    return n * models_per_unit(run.cell.traffic) / run.window_s if n else None
