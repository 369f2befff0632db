"""The fixed-coefficient stepper's entry on the substitution solve:
``ParallelSparseLU.ldiv`` on a float64 solver at ``tri_mode="trsm"``.

The step solves the deployment's own ``A`` for the step's right-hand
sides, as ``entries/ldiv.py`` does. The deployment solves by substitution
in float64: each level's diagonal tiles by a triangular solve, with no
pre-inverted diagonal blocks. A solver in another mode or precision, one
whose ``ldiv`` takes the chain solve, or a program that cannot say which
it runs, is not this deployment, so the run fails before it is timed. The
guard reads the mode, not the launches: a program that runs the same
substitution in fewer launches is still this deployment.
"""

import torch

SPAN = "api.ldiv"


def make(F):
    got = (getattr(getattr(F, "config", None), "tri_mode", None),
           getattr(F, "dtype", None), getattr(F, "solve_path", None))
    if got != ("trsm", torch.float64, "tiles"):
        raise RuntimeError(
            f"entry ldiv_trsm needs a float64 solver whose ldiv runs the "
            f"tile solve at tri_mode 'trsm', got tri_mode {got[0]!r}, "
            f"dtype {got[1]}, solve_path {got[2]!r}")

    def step(values, b):
        return F.ldiv(b)

    return step
