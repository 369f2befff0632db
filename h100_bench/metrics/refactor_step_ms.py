"""refactor_step_ms (ms): the window over the steps completed in it."""


def read(run):
    return run.step_s * 1e3
