"""waveform-ot on PyTorch: the fingerprint W2 misfit and its gradient.

The counterpart of ``waveform_ot_tpu`` (JAX) with the same module layout
and public names. Functions take tensors with an explicit leading trace
batch; the polyline distance field runs as a hand-written CUDA kernel on
CUDA tensors and as plain PyTorch on CPU tensors. This package never
imports JAX.
"""

from waveform_ot_torch import inversion, models, ops, parallel, utils  # noqa: F401
