"""launches_per_eval: kernel launch calls (cudaLaunchKernel, cuLaunchKernel
and their Ex forms) in the traced window, over its batched evaluations."""


def read(run):
    s = run.summary
    if s is None or not run.evaluations or not s.launches:
        return None
    return s.launches / run.evaluations
