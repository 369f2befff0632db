"""ldiv_launch_host_ms.* (ms): the median over the traced steps of the
host time in the program's ``lu.ldiv.launch`` spans (a direct solve's
checks, buffers and kernel launch), from the profiler's trace. Serves
every ``ldiv_launch_host_ms.<kind>``."""

from h100_bench import spans


def read(run):
    return spans.step_median_ms(run.trace, "lu.ldiv.launch")
