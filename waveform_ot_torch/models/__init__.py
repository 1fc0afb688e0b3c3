"""Forward models: Ricker wavelets, far-field and layered-medium seismograms,
Gaussian-process noise."""

from waveform_ot_torch.models.ricker import (  # noqa: F401
    ricker, ricker_wavelet, ricker_wavelet_noisy, ricker_wavelet_with_jacobian,
)
from waveform_ot_torch.models.seismo import (  # noqa: F401
    MediumConfig, StationSet, moment_tensor_from_sdr, moment_tensor_ls,
    mxyz_from_upper, synthetic_seismograms, upper_from_mxyz,
)
from waveform_ot_torch.models.layered import (  # noqa: F401
    LayeredModel, bessel_j0123, fukuoka_model, layered_model_from_table,
    layered_seismograms, make_layered_forward, make_layered_stages,
    uniform_model, wholespace_seismograms,
)
from waveform_ot_torch.models.gp_noise import (  # noqa: F401
    correlated_noise, covariance, create_curve,
)
from waveform_ot_torch.models import pyprop8_bridge  # noqa: F401
