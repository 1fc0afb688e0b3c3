"""Inversion layer: pipelines, objectives, optimizers, traces."""

from waveform_ot_torch.inversion.pipeline import (  # noqa: F401
    Targets, TraceConfig, apply_transform, auto_grid6, build_fingerprint,
    build_target, calc_wasser_waveform, dg_scale, grid6_to_window,
    trace_misfit,
)
from waveform_ot_torch.inversion.objective import (  # noqa: F401
    RickerObjective, RickerProblem, make_ricker_problem, ricker_misfit,
    ricker_objective, ricker_value_and_grad,
)
from waveform_ot_torch.inversion.windows import (  # noqa: F401
    build_windows, default_grid_dims, unit_amplitude_windows,
)
from waveform_ot_torch.inversion.loc_cmt import (  # noqa: F401
    InvOptions, LocCMTObjective, LocCMTProblem, build_loc_cmt_problem,
    layered_misfit_grid, loc_cmt_misfit, loc_cmt_value_and_grad,
    misfit_from_seis, misfit_grid, misfit_grid_sharded, predicted_seismograms,
)
from waveform_ot_torch.inversion.lbfgs import (  # noqa: F401
    LBFGSResult, minimize_lbfgs, minimize_lbfgs_batched, minimize_lbfgs_batched_host,
    minimize_multi_start, minimize_multi_start_sharded, minimize_scipy,
)
from waveform_ot_torch.inversion.trace import InversionTrace  # noqa: F401
from waveform_ot_torch.inversion.l2 import ls_misfit, window_union  # noqa: F401
from waveform_ot_torch.inversion.analysis import (  # noqa: F401
    check_convergence, solution_report,
)
