"""refine_roofline.* (%): the least time of the float64 tier's refinement
(``refine_work``, counted from A's pattern, n, R and the sweeps of the
entry ``f64_ldiv``) over its device time a step (``refine_ms``). No kernel
of the program's own: the share of the library operations the refinement
launches. Serves every ``refine_roofline.<kind>``."""

from h100_bench import harness, refine_work


def read(run):
    s = refine_work.step_s(run.trace)
    if not s:
        return None
    sweeps = harness.Bench({}).module("entries", "f64_ldiv").REFINE_STEPS
    least = refine_work.count(run.work, sweeps).least_s
    return 100.0 * least / s if least else None
