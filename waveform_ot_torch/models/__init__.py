"""Forward models: Ricker wavelets and far-field seismograms."""

from waveform_ot_torch.models.ricker import (  # noqa: F401
    ricker, ricker_wavelet, ricker_wavelet_with_jacobian,
)
from waveform_ot_torch.models.seismo import (  # noqa: F401
    MediumConfig, StationSet, moment_tensor_from_sdr, moment_tensor_ls,
    mxyz_from_upper, synthetic_seismograms, upper_from_mxyz,
)
