"""idle_share.serve: the share of the traced window, in %, in which no
operation ran on the device (1 - the union of its records / the window)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
