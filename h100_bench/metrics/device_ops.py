"""device_ops.* (launches a step): device operations (kernels, copies and
sets) over the traced steps. Serves every ``device_ops.<kind>``."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.ops:
        return None
    return len(t.ops) / t.steps
