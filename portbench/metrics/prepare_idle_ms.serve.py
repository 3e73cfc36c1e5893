"""prepare_idle_ms.serve: device-idle ms a traced request in the gaps
between device records whose midpoint lies in the program's
`serve.prepare` span."""

from portbench.lib.program_spans import per_unit_idle_ms


def read(run):
    return per_unit_idle_ms(run, {"serve.prepare"})
