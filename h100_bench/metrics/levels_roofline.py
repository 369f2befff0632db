"""levels_roofline.* (%): the least time of the solve
(``work.Work.ldiv_s``, from the factors' patterns in the solver's dtype,
the yardstick of ``ldiv_fused_roofline.solve``) over the device time a
step of every operation of the level-step solve: its ``perm_gather`` and
``wave_apply`` kernels and the diagonal steps' library operations. None in
a window without the level-step solve's kernels. Serves every
``levels_roofline.<kind>``."""

LEVEL_KERNELS = r"\b(perm_gather_kernel|wave_apply_kernel)\b"


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.launches(LEVEL_KERNELS):
        return None
    return 100.0 * run.work.ldiv_s / (t.op_s("") / t.steps)
