"""What the readers of the program's own spans and counter share.

While a profiler runs, the port opens a host range `cips.<name>` around
each of its layers and leaves an instant range `cips.count.<what>` for
each counted event (cips3dpp_torch/utils/profiling.py); they reach the
trace among its host operations (`Trace.cpu_ops`), on the clock of the
device records. A run of a program without them reads nothing: every
function here returns None there.

Only what lies in the traced units counts: a unit opens with the span
`UNIT_OPENERS` names (a request's prepare, an iteration's wait for its
batch), and what starts at or after the opening of the unit past the
last traced one is left out. The training trace stops inside that unit's
D step, whose span the profiler ends at the stop.
"""

from __future__ import annotations

import bisect
import math

SPAN = "cips."
MARKER = "cips.count."
UNIT_OPENERS = ("serve.prepare", "train.data_wait")


def _program(run):
    """[(name without "cips.", start, end)] of the program's ranges in the
    traced units, markers included; None without a trace or any range."""
    tr = run.trace
    if tr is None:
        return None
    ranges = sorted(((n[len(SPAN):], s, e) for n, s, e in tr.cpu_ops if n.startswith(SPAN)),
                    key=lambda r: r[1])
    if not ranges or not tr.units:
        return None
    opens = [s for n, s, _ in ranges if n in UNIT_OPENERS]
    cut = opens[tr.units] if len(opens) > tr.units else math.inf
    return [r for r in ranges if r[1] < cut]


def spans(run, names):
    """[(start, end)] of the traced spans named in `names`; None as
    `_program`."""
    ranges = _program(run)
    return None if ranges is None else [(s, e) for n, s, e in ranges if n in names]


def per_unit_count(run, what: str):
    """`cips.count.<what>` markers in the traced units, a unit."""
    ranges = _program(run)
    if ranges is None:
        return None
    name = MARKER[len(SPAN):] + what
    return sum(n == name for n, _, _ in ranges) / run.trace.units


def per_unit_idle_ms(run, names):
    """Device-idle ms a traced unit in the gaps between device records
    whose midpoint lies in a span named in `names`."""
    found = spans(run, names)
    if not found or not run.trace.device:
        return None
    found.sort()  # spans of one thread, these apart from each other
    starts = [s for s, _ in found]
    busy = run.trace.intervals()
    idle = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < found[i][1]:
            idle += s1 - e0
    return idle / 1e6 / run.trace.units
