"""refactor_plan_s (s): the device refactorization's plan, the program's
``lu.setup.refactor_plan`` span in ``enable_device_refactor()`` (closure
solve plans, refactor plan, its upload), from the program's registry."""

from h100_bench import spans


def read(run):
    return spans.registry_s("lu.setup.refactor_plan")
