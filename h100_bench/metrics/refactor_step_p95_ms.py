"""refactor_step_p95_ms (ms): the 95th percentile of the window's step
latencies, each from the call to the return of the synchronise."""


def read(run):
    return run.p95_s * 1e3
