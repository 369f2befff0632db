"""bidiag_roofline.solve (%): the least time of the solve
(``work.Work.ldiv_s``, from the factors' patterns, the same yardstick as
``ldiv_fused_roofline.solve``) over the device time of a launch of the
program's chain kernel, ``bidiag_kernel``."""

KERNEL = r"\bbidiag_kernel\b"


def read(run):
    t = run.trace
    n = 0 if t is None else t.launches(KERNEL)
    if not n:
        return None
    return 100.0 * run.work.ldiv_s / (t.op_s(KERNEL) / n)
