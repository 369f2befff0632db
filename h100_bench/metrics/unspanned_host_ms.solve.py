"""unspanned_host_ms.solve (ms): the mean of the window's dispatch times
less ``untraced_host_ms.solve``: host time inside the entry that no span
of the program covers. Means, not medians; not clamped."""

from h100_bench import untraced


def read(run):
    return untraced.unspanned_host_ms(run, untraced.SOLVE_STEP)
