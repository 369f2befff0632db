"""chain_launch_host_ms.* (ms): the median over the traced steps of the
host time in the program's ``lu.ldiv.chain`` spans (a chain solve's
checks, buffer and kernel launch), from the profiler's trace. Serves
every ``chain_launch_host_ms.<kind>``."""

from h100_bench import spans


def read(run):
    return spans.step_median_ms(run.trace, "lu.ldiv.chain")
