"""Wrapper of the CUDA distance-field kernel (``csrc/distance_field.cu``).

Replaces the Pallas TPU kernel ``waveform_ot_tpu/ops/pallas_distance.py``
(``_kernel``). The kernel's design and what bounds it are described in the
CUDA source. This module checks the inputs, picks the kernel's split with
:func:`plan`, allocates the outputs, launches on PyTorch's current stream
without synchronizing, and raises if the launch is refused. The plain
version is :func:`waveform_ot_torch.ops.fingerprint.distance_field_torch`.

The split rule. A thread owns P = 4 consecutive time points of one
amplitude row, which gives B*nu*ceil(ntg/4) point groups. S (a power of two,
at most 32) doubles while either

  * the groups times S are fewer than LANES_PER_SM on each of the card's
    SMs and each lane keeps at least MIN_SEGMENTS_PER_LANE segments, or
  * each lane keeps at least LONG_LANE segments,

and S lanes then split each group's segments between them. The constants
fit a sweep of every S at the main path's shapes and at loc/CMT batches of
3, 12 and 48 traces (``ab_distance_field.py``; its readings are in
PERF.md): S = 1 for the loc/CMT batch (192 traces, 79x61 grid, 60
segments), 8 for one trace's 80x512 Ricker grid (255 segments), 4 for the
800x600 fingerprint (625 segments) and for 3 or 12 loc/CMT traces.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from waveform_ot_torch import _build

LAUNCHES = 0
"""Kernel launches in this process; incremented once per launch."""
LAUNCHES_BY_DEVICE: dict[str, int] = {}
"""Kernel launches in this process by device ("cuda:0", ...)."""
_COUNT_LOCK = threading.Lock()   # a mesh's per-device threads launch at once

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "wot_distance_field_f32",
            torch.float64: "wot_distance_field_f64"}
THREADS = 128        # threads per block, fixed in the kernel
POINTS = 4           # grid points per thread, fixed in the kernel
MAX_BLOCKS = 2 ** 31 - 1  # gridDim.x, which holds every trace's blocks
MAX_S = 32           # lanes per point group: one warp
LANES_PER_SM = 512
"""Below this many lanes per SM a split still pays: Ricker's 10,240 groups
gain up to S = 8 (620 lanes per SM) and lose at 16."""
MIN_SEGMENTS_PER_LANE = 8
"""The fill clause's floor: 3 loc/CMT traces gain up to S = 4 (15 of the 60
segments per lane) and lose at 8."""
LONG_LANE = 128
"""A lane this long splits whatever the fill: the 800x600 fingerprint gains
up to S = 4 (156 of 625 segments per lane) and loses at 8."""


def plan(bsz: int, nu: int, ntg: int, nseg: int, sms: int) -> int:
    """S, the lanes per point group, for a (bsz, nu, ntg) grid and nseg
    segments on a card with ``sms`` SMs (the rule is in the module docstring)."""
    groups = bsz * nu * -(-ntg // POINTS)
    s = 1
    while s < MAX_S and (
            (groups * s < sms * LANES_PER_SM and nseg >= 2 * s * MIN_SEGMENTS_PER_LANE)
            or nseg >= 2 * s * LONG_LANE):
        s *= 2
    return s


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("distance_field")
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.wot_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wot_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, device, shape):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def distance_field_cuda(verts, tgrid, ugrid):
    """(d, iclose, lam, dvec) of each trace's polyline on its grid.

    verts (B, nt, 2), tgrid (B, ntg), ugrid (B, nu): contiguous CUDA tensors
    of one dtype, float32 or float64, on one device. Returns d, lam
    (B, nu, ntg), iclose (B, nu, ntg) int32 and dvec (B, nu, ntg, 2).
    """
    if verts.device.type != "cuda":
        raise ValueError(f"verts must be a CUDA tensor, got {verts.device}")
    if verts.dtype not in _SYMBOLS:
        raise TypeError(f"unsupported dtype {verts.dtype}; expected float32 or float64")
    if verts.dim() != 3 or verts.shape[2] != 2 or verts.shape[1] < 2:
        raise ValueError(f"verts must be (B, nt>=2, 2), got {tuple(verts.shape)}")
    bsz, nt = verts.shape[0], verts.shape[1]
    if tgrid.dim() != 2 or ugrid.dim() != 2:
        raise ValueError("tgrid and ugrid must be (B, ntg) and (B, nu)")
    ntg, nu = tgrid.shape[1], ugrid.shape[1]
    dev, dt = verts.device, verts.dtype
    _check("verts", verts, dt, dev, (bsz, nt, 2))
    _check("tgrid", tgrid, dt, dev, (bsz, ntg))
    _check("ugrid", ugrid, dt, dev, (bsz, nu))
    if bsz == 0 or nu * ntg == 0:
        raise ValueError(f"batch {bsz} and grid ({nu}, {ntg}) must be non-empty")
    if nu * ntg * 2 >= 2 ** 31 or 2 * nt >= 2 ** 31:
        raise ValueError("one trace's grid or polyline is too large for int32 indexing")

    lib = _library()
    s = plan(bsz, nu, ntg, nt - 1, _sm_count(dev.index))
    groups = nu * -(-ntg // POINTS)                  # point groups per trace
    blocks = bsz * -(-groups // (THREADS // s))
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{bsz} traces need {blocks} blocks, more than one launch holds")
    d = torch.empty(bsz, nu, ntg, dtype=dt, device=dev)
    iclose = torch.empty(bsz, nu, ntg, dtype=torch.int32, device=dev)
    lam = torch.empty(bsz, nu, ntg, dtype=dt, device=dev)
    dvec = torch.empty(bsz, nu, ntg, 2, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _SYMBOLS[dt])(
            verts.data_ptr(), tgrid.data_ptr(), ugrid.data_ptr(), d.data_ptr(),
            iclose.data_ptr(), lam.data_ptr(), dvec.data_ptr(),
            bsz, nt, ntg, nu, s, stream)
    if rc != 0:
        msg = lib.wot_cuda_error_string(rc).decode()
        raise RuntimeError(f"distance_field kernel launch failed: {msg} ({rc})")
    count_launch(dev)
    return d, iclose, lam, dvec


def count_launch(device: torch.device) -> None:
    """Add one launch on ``device`` to LAUNCHES and LAUNCHES_BY_DEVICE."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_DEVICE[str(device)] = LAUNCHES_BY_DEVICE.get(str(device), 0) + 1
