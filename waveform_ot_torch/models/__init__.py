"""Forward models: Ricker wavelets and far-field seismograms."""

from waveform_ot_torch.models.ricker import ricker, ricker_wavelet  # noqa: F401
from waveform_ot_torch.models.seismo import (  # noqa: F401
    MediumConfig, StationSet, moment_tensor_from_sdr, mxyz_from_upper,
    synthetic_seismograms,
)
