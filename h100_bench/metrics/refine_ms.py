"""refine_ms.* (ms): device time a step of every operation of the float64
tier's step other than the direct solve's ``ldiv_fused_kernel``: the
float64 residual products, subtractions, casts and updates of the
refinement sweeps (and the right-hand side's conversion to float64), read
as ``extraction_ms`` reads. Serves every ``refine_ms.<kind>``."""

from h100_bench import refine_work


def read(run):
    s = refine_work.step_s(run.trace)
    return None if s is None else s * 1e3
