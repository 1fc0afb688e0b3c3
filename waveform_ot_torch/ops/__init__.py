"""Core numerics: 1-D and sliced optimal transport, Sinkhorn, barycenters
and waveform fingerprints."""

from waveform_ot_torch.ops import errors  # noqa: F401
from waveform_ot_torch.ops.otpdf import (  # noqa: F401
    Density1D, Density2D, make_density, make_density_1d, make_density_2d,
    marginals, marginals_raw, validate_density,
)
from waveform_ot_torch.ops.wasser import (  # noqa: F401
    check_common_cdf, common_cdf_mask, transport_plan_1d, transport_plan_jacobian, wasser,
    wasserstein_1d, wasserstein_1d_autodiff, wasserstein_1d_cost,
)
from waveform_ot_torch.ops.marginal import (  # noqa: F401
    marg_wasserstein, marg_wasserstein_value,
)
from waveform_ot_torch.ops.fingerprint import (  # noqa: F401
    DistanceField, DistanceFieldDiff, FingerprintSpec, Window,
    density_from_distance, distance_field, distance_field_diff,
    distance_field_nn, distance_field_torch, fingerprint_density, grid_axes,
    make_window, normalize_vertices, point_distance, window_from_waveform,
)
from waveform_ot_torch.ops.sliced import (  # noqa: F401
    SlicedProjections, project_sliced, projection_angles, sliced_plan_jacobian,
    sliced_wasserstein, sliced_wasserstein_plan_cost, sliced_wasserstein_value,
)
from waveform_ot_torch.ops.sinkhorn import (  # noqa: F401
    gaussian_filter, sinkhorn_dense, sinkhorn_gaussian, sinkhorn_log,
)
from waveform_ot_torch.ops.barycenter import (  # noqa: F401
    barycenter_continuous, barycenter_pointmass,
)
from waveform_ot_torch.ops.transforms import arctan_transform  # noqa: F401
from waveform_ot_torch.ops import fmm, pot_bridge  # noqa: F401
