"""launches_per_call: kernel launch calls (cudaLaunchKernel, cuLaunchKernel
and their Ex forms) in the traced window, over its calls."""


def read(run):
    s = run.summary
    if s is None or not run.latencies_s or not s.launches:
        return None
    return s.launches / len(run.latencies_s)
