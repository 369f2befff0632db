"""host_dispatch_ms.* (ms): the median over the window's steps of the host
time from the call into the program to its return, before the
synchronise. Serves every ``host_dispatch_ms.<kind>``."""

import numpy as np


def read(run):
    return float(np.median(run.dispatch_s)) * 1e3
