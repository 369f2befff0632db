"""extraction_ms (ms): device time a step of every operation of the step
other than the elimination, the assembly and the solve: the refactor
pipeline's bank extraction and growth, ``tri_kernel_from_bank``."""

OTHERS = r"\b(elim_fused_kernel|tiles_kernel|closure_kernel|ldiv_fused_kernel)\b"


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.ops:
        return None
    return (t.op_s("") - t.op_s(OTHERS)) / t.steps * 1e3
