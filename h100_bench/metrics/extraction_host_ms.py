"""extraction_host_ms (ms): the median over the traced steps of the host
time in the program's ``lu.refactor.extract`` span (the solve banks'
tiles and the pivot growth, after the elimination), from the profiler's
trace."""

from h100_bench import spans


def read(run):
    return spans.step_median_ms(run.trace, "lu.refactor.extract")
