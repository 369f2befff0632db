"""order_s (s): the fill-reducing ordering of the run's construction, the
program's ``lu.setup.order`` span (nested dissection), from the program's
registry."""

from h100_bench import spans


def read(run):
    return spans.registry_s("lu.setup.order")
