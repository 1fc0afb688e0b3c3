"""graph_kernels: the kernel nodes of the CUDA graph that the window's calls
replayed, per call: over the graphs the port's ``inversion/cuda_graph.py``
holds, their kernel nodes (counted once, at capture) weighted by their
replays. The warm-up call captures and the window's calls replay, so the
replays are the window's. Read from the module the system already loaded,
without importing the port; None where the port keeps no such count or no
graph was replayed."""

import sys


def read(run):
    mod = sys.modules.get("waveform_ot_torch.inversion.cuda_graph")
    graphs = getattr(mod, "graphs", None)
    if graphs is None:
        return None
    held = [g for g in graphs() if g["replays"] > 0]
    replays = sum(g["replays"] for g in held)
    if not replays:
        return None
    return sum(g["kernels"] * g["replays"] for g in held) / replays
