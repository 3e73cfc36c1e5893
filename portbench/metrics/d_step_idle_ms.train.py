"""d_step_idle_ms.train: device-idle ms a traced iteration in the gaps
between device records whose midpoint lies in the program's D step span
(`train.d_step`, or `train.d_step_r1` with lazy R1)."""

from portbench.lib.program_spans import per_unit_idle_ms


def read(run):
    return per_unit_idle_ms(run, {"train.d_step", "train.d_step_r1"})
