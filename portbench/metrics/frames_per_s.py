"""frames_per_s: every frame completed in the window over the window's
time (host clock, from its start to the end of the last request: its
last frame on the host)."""


def read(run):
    return sum(u["frames"] for u in run.units) / run.window_s
