"""factorize_s (s): the host factorization of the run's construction,
the program's ``lu.setup.factorize`` span (SuperLU with its column
ordering, or the pattern-only factors), from the program's registry."""

from h100_bench import spans


def read(run):
    return spans.registry_s("lu.setup.factorize")
