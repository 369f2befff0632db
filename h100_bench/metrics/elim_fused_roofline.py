"""elim_fused_roofline (%): the least time of the elimination
(``work.Work.elim_s``) over the device time of a launch of the program's
``elim_fused_kernel``."""

KERNEL = r"\belim_fused_kernel\b"


def read(run):
    t = run.trace
    n = 0 if t is None else t.launches(KERNEL)
    if not n:
        return None
    return 100.0 * run.work.elim_s / (t.op_s(KERNEL) / n)
