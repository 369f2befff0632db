"""setup_s (s): from the start of the run to the first timed step: the
imports, the deployment's construction, the ring, the warm-up (and, in the
first run of a checkout, the kernels' build)."""


def read(run):
    return run.setup_s
