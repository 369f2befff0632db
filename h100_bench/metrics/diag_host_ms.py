"""diag_host_ms.* (ms): the median over the traced steps of the host time
in the program's ``lu.ldiv.diag`` spans (the level-step solve's diagonal
steps), from the profiler's trace. Serves every ``diag_host_ms.<kind>``."""

from h100_bench import spans


def read(run):
    return spans.step_median_ms(run.trace, "lu.ldiv.diag")
