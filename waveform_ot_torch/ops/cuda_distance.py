"""Wrapper of the CUDA distance-field kernel (``csrc/distance_field.cu``).

Replaces the Pallas TPU kernel ``waveform_ot_tpu/ops/pallas_distance.py``
(``_kernel``). The kernel's design and what bounds it are described in the
CUDA source. This module checks the inputs, allocates the outputs, launches
on PyTorch's current stream without synchronizing, and raises if the launch
is refused. The plain version is
:func:`waveform_ot_torch.ops.fingerprint.distance_field_torch`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from waveform_ot_torch import _build

LAUNCHES = 0
"""Kernel launches in this process; incremented once per launch."""

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "wot_distance_field_f32",
            torch.float64: "wot_distance_field_f64"}
_MAX_BATCH = 65535  # gridDim.y


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
    global LAUNCHES
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
    if not 0 < bsz <= _MAX_BATCH or nu * ntg == 0:
        raise ValueError(f"batch {bsz} must be in [1, {_MAX_BATCH}] and the grid "
                         f"({nu}, {ntg}) non-empty")
    if nu * ntg * 2 >= 2 ** 31 or nt >= 2 ** 31:
        raise ValueError("grid or polyline too large for int32 indexing")

    lib = _library()
    d = torch.empty(bsz, nu, ntg, dtype=dt, device=dev)
    iclose = torch.empty(bsz, nu, ntg, dtype=torch.int32, device=dev)
    lam = torch.empty(bsz, nu, ntg, dtype=dt, device=dev)
    dvec = torch.empty(bsz, nu, ntg, 2, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _SYMBOLS[dt])(
            verts.data_ptr(), tgrid.data_ptr(), ugrid.data_ptr(), d.data_ptr(),
            iclose.data_ptr(), lam.data_ptr(), dvec.data_ptr(),
            bsz, nt, ntg, nu, stream)
    if rc != 0:
        msg = lib.wot_cuda_error_string(rc).decode()
        raise RuntimeError(f"distance_field kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return d, iclose, lam, dvec
