"""tracing_cost_ms.refactor (ms): what the profiler adds to a step's phases:
the mean host ms a step in the program's spans but the set-up ones under
the traced window's profiler, less the same without one, from the
program's registry."""

from h100_bench import untraced


def read(run):
    return untraced.tracing_cost_ms(untraced.REFACTOR_STEP)
