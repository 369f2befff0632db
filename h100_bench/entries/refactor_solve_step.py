"""The varying-coefficient stepper's entry: the step that
``ParallelSparseLU.make_refactor_solve_step()`` makes.

Each call refactorizes on the device from the step's same-pattern values
of ``A`` (assembly, elimination, bank extraction) and solves for the
step's right-hand sides.
"""

SPAN = "api.refactor_solve_step"


def make(F):
    return F.make_refactor_solve_step()
