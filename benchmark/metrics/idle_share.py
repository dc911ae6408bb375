"""idle_share (%; device): 100 * (1 - the union of device activity over
the traced span / the traced span's length)."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
