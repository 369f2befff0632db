"""plan_s (s): the symbolic plan of the run's construction, the program's
``lu.setup.plan`` span (levels, blocked fill, the tile maps), from the
program's registry."""

from h100_bench import spans


def read(run):
    return spans.registry_s("lu.setup.plan")
