"""The table of peaks and the distance-field kernel's least time.

A frozen copy of ``chip_smoke.kernel_bound`` and its constants (commit
8a4dc96): the work the inputs need, not what the kernel does. bx = px - x0x
and bx*cx depend only on the grid column and the segment, by and by*cy only
on the row and the segment: 2 operations per (line, segment) pair. Each
point-segment pair then needs 12: 1 add for b.c, 1 scale by 1/|c|^2, 2 for
the clip, 4 for dx and dy, 3 for dsq, 1 compare. These at the dtype's peak
outside the tensor cores, or the inputs read once and d, iclose, lam, dvec
written once at the HBM rate, whichever is longer.
"""

from __future__ import annotations

OPS_PER_PAIR = 12
OPS_PER_LINE = 2
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}


def kernel_bound_s(traces: int, nt: int, nu: int, ntg: int, dtype: str) -> float:
    """Least seconds for one distance field of ``traces`` polylines of nt
    vertices on an (nu, ntg) grid on one H100."""
    es = ITEMSIZE[dtype]
    ops = traces * (nt - 1) * (OPS_PER_PAIR * nu * ntg + OPS_PER_LINE * (nu + ntg))
    nbytes = es * traces * (2 * nt + ntg + nu) + traces * nu * ntg * (4 * es + 4)
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES)
