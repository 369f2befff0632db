"""diag_step_ms.* (ms): device time a step of every operation of the
level-step solve other than its ``perm_gather`` and ``wave_apply``
kernels: the diagonal steps (at ``tri_mode="trsm"`` the gathers, the
library's triangular solves and the scatters), read as ``extraction_ms``
reads. None in a window without the level-step solve's kernels. Serves
every ``diag_step_ms.<kind>``."""

LEVEL_KERNELS = r"\b(perm_gather_kernel|wave_apply_kernel)\b"


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.launches(LEVEL_KERNELS):
        return None
    return (t.op_s("") - t.op_s(LEVEL_KERNELS)) / t.steps * 1e3
