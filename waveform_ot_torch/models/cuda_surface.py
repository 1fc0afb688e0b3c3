"""Wrapper of the CUDA stage-A kernel (``csrc/surface_operator.cu``).

One launch computes a frequency band's whole surface operator for K source
depths: the fields of ``_Reverb`` and ``_SourceLayer`` and, with the
tangent, the fields of ``_depth_tangent`` (the kernel's design is described
in the CUDA source). This module checks the inputs, allocates the outputs
in the plain version's shapes and layout, launches on PyTorch's current
stream without synchronizing, and raises if the launch is refused. The
plain version is :func:`waveform_ot_torch.models.layered._surface_operator`,
which CPU tensors take; :func:`waveform_ot_torch.models.layered._band_operator`
launches the kernel for every band of a stage-A call on the card, through
:class:`waveform_ot_torch.models.layered._KernelStageA`, which differentiates
it in the source depth.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from waveform_ot_torch import _build

LAUNCHES = 0
"""Kernel launches in this process, one per band of each stage-A call on
the card. A launch recorded by a CUDA graph capture counts once, at the
capture; a replay runs no Python and counts nothing."""

REVERB = ("W2", "RA2", "RB2", "inner2", "Wsh", "RAsh", "RBsh", "innersh")
"""The fields of ``_Reverb`` (and of its depth tangent), in the kernel's order."""
_MATRIX = {"W2", "RA2", "RB2", "inner2"}   # (K, nf, nk, 2, 2); the others (K, nf, nk)
_FIELDS = len(REVERB) * 2 + 5              # reverb, ga, gb, chi, vs, rho, tangent
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("surface_operator")
    lib.wot_surface_operator.argtypes = _ARGTYPES
    lib.wot_surface_operator.restype = ctypes.c_int
    lib.wot_surface_error_string.argtypes = [ctypes.c_int]
    lib.wot_surface_error_string.restype = ctypes.c_char_p
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


def surface_operator_cuda(k, om_c, iface, vp, vs, rho, z, free_surface: bool,
                          tangent: bool):
    """(rev, src, drev) of one band: ``rev`` the :data:`REVERB` fields (W2,
    RA2, RB2, inner2 (K, nf, nk, 2, 2), the SH scalars (K, nf, nk)), ``src``
    (ga, gb, chi (K, nf, nk), vs, rho (K,)), ``drev`` the z-derivatives of
    ``rev``'s fields when ``tangent``, else None. Complex outputs are
    complex128, vs and rho float64.

    k (nk,) float64 wavenumbers, om_c (nf,) complex128 frequencies, iface
    (nlay-1,) interface depths and vp, vs, rho (nlay,) float64, all
    contiguous; z (K,) float64 source depths, contiguous. All on one CUDA
    device.
    """
    if not z.is_cuda:
        raise ValueError(f"z must be a CUDA tensor, got {z.device}")
    if z.dim() != 1 or k.dim() != 1 or om_c.dim() != 1 or vp.dim() != 1:
        raise ValueError("z, k, om_c and vp must be 1-D")
    dev, f64 = z.device, torch.float64
    nsrc, nk, nf, nlay = z.shape[0], k.shape[0], om_c.shape[0], vp.shape[0]
    if min(nsrc, nk, nf, nlay) == 0:
        raise ValueError(f"sources {nsrc}, wavenumbers {nk}, frequencies {nf} and "
                         f"layers {nlay} must be non-empty")
    _check("z", z, f64, dev, (nsrc,))
    _check("k", k, f64, dev, (nk,))
    _check("om_c", om_c, torch.complex128, dev, (nf,))
    _check("iface", iface, f64, dev, (nlay - 1,))
    for name, v in (("vp", vp), ("vs", vs), ("rho", rho)):
        _check(name, v, f64, dev, (nlay,))

    lib = _library()
    pts = (nsrc, nf, nk)

    def empty(name):
        shape = pts + (2, 2) if name in _MATRIX else pts
        return torch.empty(shape, dtype=torch.complex128, device=dev)

    rev = tuple(empty(n) for n in REVERB)
    src = tuple(torch.empty(pts, dtype=torch.complex128, device=dev) for _ in range(3)) + \
        tuple(torch.empty(nsrc, dtype=f64, device=dev) for _ in range(2))
    drev = tuple(empty(n) for n in REVERB) if tangent else None
    outs = rev + src + (drev or (None,) * len(REVERB))
    ptrs = (ctypes.c_void_p * _FIELDS)(*(None if t is None else t.data_ptr() for t in outs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wot_surface_operator(
            k.data_ptr(), om_c.data_ptr(), iface.data_ptr(), vp.data_ptr(), vs.data_ptr(),
            rho.data_ptr(), z.data_ptr(), ptrs, nsrc, nf, nk, nlay, int(free_surface),
            int(tangent), stream)
    if rc != 0:
        msg = lib.wot_surface_error_string(rc).decode()
        raise RuntimeError(f"surface_operator kernel launch failed: {msg} ({rc})")
    global LAUNCHES
    LAUNCHES += 1
    return rev, src, drev
