"""program_idle_share.* (%): the share of the traced window in which the
device was idle while the host was inside one of the program's spans
(``lu.*``): the idle time a shorter program phase could take away.
Serves every ``program_idle_share.<kind>``."""

from h100_bench import spans


def read(run):
    t = run.trace
    idle = spans.program_idle_s(t)
    if idle is None or t.window_s <= 0:
        return None
    return 100.0 * idle / t.window_s
