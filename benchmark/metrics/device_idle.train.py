"""The share of the traced window in which no kernel, copy or set ran on
the device."""


def read(run):
    s = run.summary
    if s is None or not run.window_s:
        return None
    return 100.0 * (1.0 - s.busy_s / run.window_s)
