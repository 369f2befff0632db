"""construct_s (s): the deployment's construction on the host:
``ParallelSparseLU(...)`` (ordering, host factorization, symbolic plan,
pack) and, in cells whose values change, ``enable_device_refactor()``
(the refactor plan)."""


def read(run):
    return run.construct_s
