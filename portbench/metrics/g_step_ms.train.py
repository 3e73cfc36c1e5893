"""g_step_ms.train: mean ms of an iteration's G update over the traced
iterations: its G step and, where the schedule runs it, its path
regularisation step, each timed on the device (CUDA events)."""

from portbench.lib.readers import mean


def read(run):
    if run.trace is None:
        return None
    g = run.trace.timed_ms.get("g_step", [])
    path = run.trace.timed_ms.get("path_step", [])
    # an iteration's path step follows its G step: spread them by count
    per_iter = list(g)
    spans = [n for n, _, _ in run.trace.spans if n in ("g_step", "path_step")]
    at, k = -1, 0
    for n in spans:
        if n == "g_step":
            at += 1
        elif at >= 0 and k < len(path):
            per_iter[at] += path[k]
            k += 1
    return mean(per_iter)
