"""data_wait_ms.train: mean ms the training loop waited for its next
batch (`prefetch_to_device`'s next(), host clock of the profiler) over the
traced iterations."""

from portbench.lib.readers import mean, span_ms


def read(run):
    return mean(span_ms(run, "data_wait"))
