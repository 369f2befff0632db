"""The float64 stepper's entry: the solve that
``ParallelSparseLU.make_f64_ldiv()`` makes.

The deployment factors once in float32 and needs float64 answers: each
step is one float32 direct solve and ``REFINE_STEPS`` sweeps of iterative
refinement, ``x += solve_f32(b - A x)``, with the residual and ``x`` in
float64. The step returns a float64 ``(n, R)`` tensor; the mix changes no
values.
"""

SPAN = "api.f64_ldiv"
REFINE_STEPS = 2


def make(F):
    solve = F.make_f64_ldiv(refine_steps=REFINE_STEPS)

    def step(values, b):
        return solve(b)

    return step
