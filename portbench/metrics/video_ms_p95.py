"""video_ms_p95: the 95th percentile of the latency of every request in
the window, from its start (before prepare_trajectory) to its last frame
copied to the host (host clock)."""

from portbench.lib.common import percentile


def read(run):
    return percentile([(u["t1"] - u["t0"]) * 1e3 for u in run.units], 95)
