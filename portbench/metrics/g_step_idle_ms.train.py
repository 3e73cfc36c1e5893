"""g_step_idle_ms.train: device-idle ms a traced iteration in the gaps
between device records whose midpoint lies in the program's G step span
(`train.g_step`) or its path regularisation step (`train.path_step`)."""

from portbench.lib.program_spans import per_unit_idle_ms


def read(run):
    return per_unit_idle_ms(run, {"train.g_step", "train.path_step"})
