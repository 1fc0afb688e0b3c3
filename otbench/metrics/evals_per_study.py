"""evals_per_study: batched objective calls the solver made (each value or
value+grad of all starts at once), counted by the harness's wrapper around
the function it hands the solver, over the studies of the window."""


def read(run):
    n = len(run.latencies_s)
    return run.evaluations / n if n else None
