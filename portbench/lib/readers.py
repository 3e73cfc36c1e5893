"""What several metric readers share: the traced units' frames and
calls, the kernels of the render calls by layer, span lengths."""

from __future__ import annotations

from ..work.kernels import kind


def traced_units(run):
    tr = run.trace
    return [] if tr is None else run.units[:tr.units]


def call_kernels(run, layer=None):
    """The device kernels that ran inside the traced requests' render calls
    (the "calls" spans), of one layer (work.kernels.kind) or all."""
    ks = run.trace.in_spans("calls")
    return ks if layer is None else [k for k in ks if kind(k[0]) == layer]


def traced_frames(run) -> int:
    return sum(u["frames"] for u in traced_units(run))


def traced_calls(run) -> int:
    return sum(u["calls"] for u in traced_units(run))


def span_ms(run, name):
    """Lengths in ms of the traced spans of `name`."""
    if run.trace is None:
        return []
    return [(e - s) / 1e6 for n, s, e in run.trace.spans if n == name]


def mean(xs):
    return sum(xs) / len(xs) if xs else None
