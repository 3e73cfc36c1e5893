"""prepare_ms.serve: mean ms of serving.prepare_trajectory (mapping,
SIREN and modulated-weight folds) over the traced requests, its span
synchronised on the device."""

from portbench.lib.readers import mean, span_ms


def read(run):
    return mean(span_ms(run, "prepare"))
