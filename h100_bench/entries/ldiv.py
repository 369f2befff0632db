"""The fixed-coefficient stepper's entry: ``ParallelSparseLU.ldiv``.

The step solves the deployment's own ``A`` for the step's right-hand
sides; the mix changes no values.
"""

SPAN = "api.ldiv"


def make(F):
    def step(values, b):
        return F.ldiv(b)

    return step
