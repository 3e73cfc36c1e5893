"""d_step_ms.train: mean ms of the plain D steps (no lazy R1) of the
traced iterations, timed on the device (CUDA events at the step's ends)."""

from portbench.lib.readers import mean


def read(run):
    return None if run.trace is None else mean(run.trace.timed_ms.get("d_step", []))
