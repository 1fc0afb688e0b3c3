"""Inversion layer: pipelines and objectives."""

from waveform_ot_torch.inversion.pipeline import (  # noqa: F401
    Targets, TraceConfig, apply_transform, build_fingerprint, build_target,
    grid6_to_window, trace_misfit,
)
from waveform_ot_torch.inversion.objective import (  # noqa: F401
    RickerObjective, RickerProblem, make_ricker_problem, ricker_misfit,
    ricker_value_and_grad,
)
from waveform_ot_torch.inversion.windows import (  # noqa: F401
    build_windows, unit_amplitude_windows,
)
from waveform_ot_torch.inversion.loc_cmt import (  # noqa: F401
    InvOptions, LocCMTObjective, LocCMTProblem, build_loc_cmt_problem,
    loc_cmt_misfit, loc_cmt_value_and_grad, misfit_from_seis,
    predicted_seismograms,
)
