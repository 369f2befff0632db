"""launch_host_us.refactor (us): unprofiled host µs a hand-written launch: the
registry's seconds of the step's spans that launched at least once, over
their launches; a mean."""

from h100_bench import untraced


def read(run):
    return untraced.launch_host_us(untraced.REFACTOR_STEP)
