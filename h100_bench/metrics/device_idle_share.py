"""device_idle_share.* (%): the share of the traced window in which no
operation ran on the device. Serves every ``device_idle_share.<kind>``."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
