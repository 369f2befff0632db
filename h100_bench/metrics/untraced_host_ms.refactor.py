"""untraced_host_ms.refactor (ms): the mean host time a step in the program's
spans but the set-up ones, over the calls made while no profiler recorded
(set-up, warm-up and the window), from the program's registry; steps
counted by the ``.refactor_solve`` cells (``lu.step.inputs``)."""

from h100_bench import untraced


def read(run):
    return untraced.host_ms(untraced.REFACTOR_STEP)
