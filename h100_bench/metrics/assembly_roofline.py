"""assembly_roofline (%): the least time of the assembly
(``work.Work.assembly_s``) over the device time of the program's two
assembly kernels, ``tiles_kernel`` and ``closure_kernel``, a step."""

TILES = r"\btiles_kernel\b"
CLOSURE = r"\bclosure_kernel\b"


def read(run):
    t = run.trace
    n = 0 if t is None else t.launches(TILES)
    if not n:
        return None
    return 100.0 * run.work.assembly_s / ((t.op_s(TILES) + t.op_s(CLOSURE)) / n)
