"""ldiv_launches.* (launches a step): launches of the program's direct
solve, ``ldiv_fused_kernel``, over the traced steps; the float64 tier
makes one and one a refinement sweep. Serves every
``ldiv_launches.<kind>``."""

KERNEL = r"\bldiv_fused_kernel\b"


def read(run):
    t = run.trace
    n = 0 if t is None or not t.steps else t.launches(KERNEL)
    if not n:
        return None
    return n / t.steps
