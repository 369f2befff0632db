"""The fixed-coefficient stepper's entry on a chain:
``ParallelSparseLU.ldiv`` where it runs the chain solve.

The step solves the deployment's own ``A`` for the step's right-hand
sides, as ``entries/ldiv.py`` does. A chain deployment is measured on the
chain solve, one launch of the chain kernel a step: a solver that would
take the tile solve instead (or a program that cannot say which path it
takes) is not this deployment, so the run fails before it is timed.
"""

SPAN = "api.ldiv"


def make(F):
    path = getattr(F, "solve_path", None)
    if path != "chain":
        raise RuntimeError(
            f"entry ldiv_chain needs a solver whose ldiv runs the chain "
            f"solve (solve_path 'chain'), got solve_path {path!r}")

    def step(values, b):
        return F.ldiv(b)

    return step
