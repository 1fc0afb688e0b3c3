"""Typed error taxonomy for the OT core (counterpart of waveform_ot_tpu.ops.errors).

The same classes and reference spellings as the JAX package, so code that
catches them works against either backend. PyTorch runs eagerly, so these
can be raised wherever a condition is known on the host.
"""

from __future__ import annotations


class OTError(Exception):
    """Base class for all waveform-ot OT errors."""


class PDFShapeError(OTError):
    """Amplitude and location arrays of a density have mismatched shapes."""

    def __init__(self, msg: str = "pdf amplitude/location shape mismatch"):
        super().__init__(msg)


class PDFSignError(OTError):
    """A density was constructed with negative amplitudes."""

    def __init__(self, msg: str = "pdf amplitudes must be non-negative"):
        super().__init__(msg)


class TargetSourceCDFError(OTError):
    """Source and target CDFs share a common value (derivatives undefined)."""

    def __init__(self, common=None):
        self.common = common
        super().__init__(
            "source and target CDFs share common values; derivatives are "
            f"not defined at ties: {common}"
        )


class TargetSource2DShapeError(OTError):
    """A 2-D operation (marginals, slicing) was applied to a 1-D density."""

    def __init__(self, msg: str = "operation requires a 2-D density"):
        super().__init__(msg)


class SlicedWassersteinError(OTError):
    """Invalid parameters passed to a sliced-Wasserstein routine."""


class UnknownOTDistanceTypeError(OTError):
    """Unrecognized distance specification (expected 'W1'|'W2'|'W12'|array)."""

    def __init__(self, distfunc=None):
        super().__init__(f"unknown OT distance specification: {distfunc!r}")


class DistfuncShapeError(OTError):
    """A precomputed cost array does not match (source_n, target_n)."""


class MarginalWassersteinError(OTError):
    """Invalid mode for marginal Wasserstein (e.g. 'W12' not supported)."""

    def __init__(self, mset="W12"):
        super().__init__(f"marginal Wasserstein does not support mode {mset!r}")


class WaveformFPderivError(OTError):
    """Fingerprint derivative requested before the distance field exists."""


class FingerprintMethodError(OTError):
    """Unknown distance-field method or density exponent."""

    def __init__(self, method=None):
        super().__init__(f"unknown fingerprint method: {method!r}")


class FMMLibraryError(OTError):
    """The optional scikit-fmm dependency is not installed."""

    def __init__(self):
        super().__init__("scikit-fmm is not installed; FMM method unavailable")


class POTLibraryError(OTError):
    """The optional POT (python optimal transport) dependency is missing."""

    def __init__(self):
        super().__init__("POT library is not installed")


# reference spellings (see waveform_ot_tpu.ops.errors)
Error = OTError
POTlibraryError = POTLibraryError
WaveformPFderivError = WaveformFPderivError
FMMlibraryError = FMMLibraryError
