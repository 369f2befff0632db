"""launches.refactor (launches a step): the program's hand-written kernel
launches a step while no profiler recorded, those under no span
(``lu.unspanned``) included, from the program's registry; a mean.
PyTorch's and the libraries' operations are not counted."""

from h100_bench import untraced


def read(run):
    return untraced.launches(untraced.REFACTOR_STEP)
