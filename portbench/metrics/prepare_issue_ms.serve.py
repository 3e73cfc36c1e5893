"""prepare_issue_ms.serve: mean host ms of the program's `serve.prepare`
span (all of `serving.prepare_trajectory`: the launches it issues and its
host reads) over the traced requests; the benchmark's synchronisation
after it lies outside."""

from portbench.lib.program_spans import spans
from portbench.lib.readers import mean


def read(run):
    found = spans(run, {"serve.prepare"})
    return None if not found else mean([(e - s) / 1e6 for s, e in found])
