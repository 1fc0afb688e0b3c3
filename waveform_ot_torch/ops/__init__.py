"""Core numerics: 1-D optimal transport and waveform fingerprints."""

from waveform_ot_torch.ops import errors  # noqa: F401
from waveform_ot_torch.ops.otpdf import (  # noqa: F401
    Density1D, make_density_1d, marginals_raw,
)
from waveform_ot_torch.ops.wasser import wasserstein_1d  # noqa: F401
from waveform_ot_torch.ops.marginal import marg_wasserstein_value  # noqa: F401
from waveform_ot_torch.ops.fingerprint import (  # noqa: F401
    DistanceField, DistanceFieldDiff, FingerprintSpec, Window,
    density_from_distance, distance_field, distance_field_diff,
    distance_field_torch, fingerprint_density, grid_axes, make_window,
    normalize_vertices,
)
from waveform_ot_torch.ops.transforms import arctan_transform  # noqa: F401
