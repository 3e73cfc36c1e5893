"""The traced part of a `--trace 1` run: torch.profiler over the first
units of the window, read into plain lists that the metric readers take.

Spans are the benchmark's own `record_function` ranges around calls into
the program (named "pb.<what>"); kernels are the profiler's device
records. Both are in the profiler's clock, in ns.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Trace:
    """A profiler session: `start()`, spans by `span(name)` or, timed on
    the device, `timed(name)`, `stop()`; then `kernels` [(name, start_ns,
    dur_ns)], `device` (every device record, copies and fills too), `spans`
    [(name, start_ns, end_ns)], `timed_ms` {name: [ms]} and `window_s`
    (host clock)."""

    def __init__(self):
        self.prof = None
        self.kernels, self.device, self.spans, self.cpu_ops = [], [], [], []
        self.window_s = None
        self.timed_ms = collections.defaultdict(list)
        self._events = []
        self.units = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def span(self, name: str):
        return torch.profiler.record_function(f"pb.{name}")

    @contextlib.contextmanager
    def timed(self, name: str):
        """A span whose length is the device's: CUDA events recorded on the
        stream at both ends (no host synchronisation), read at `stop()`
        into `timed_ms[name]`; off the card, the host's clock."""
        with self.span(name):
            if torch.cuda.is_available():
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                yield
                end.record()
                self._events.append((name, start, end))
            else:
                t0 = time.perf_counter()
                yield
                self.timed_ms[name].append((time.perf_counter() - t0) * 1e3)

    def stop(self):
        from torch.autograd import DeviceType

        _sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        for name, start, end in self._events:
            self.timed_ms[name].append(start.elapsed_time(end))
        self._events = []
        for ev in self.prof.profiler.kineto_results.events():
            name, start, dur = ev.name(), _ns(ev, "start"), _ns(ev, "duration")
            if ev.device_type() == DeviceType.CUDA:
                if name.startswith("pb."):  # a span's mirror on the device timeline
                    continue
                self.device.append((name, start, dur))
                if not name.startswith(("Memcpy", "Memset", "cudaMem")):
                    self.kernels.append((name, start, dur))
            elif name.startswith("pb."):
                self.spans.append((name[3:], start, start + dur))
            elif not name.startswith(("cuda", "cu", "ProfilerStep")):
                self.cpu_ops.append((name, start, start + dur))
        self.kernels.sort(key=lambda k: k[1])
        self.spans.sort(key=lambda s: s[1])
        self.prof = None

    # ----- what the metric readers and the result line take -------------

    def intervals(self):
        """The device's busy intervals: the union of its records, merged."""
        out = []
        for _, s, d in sorted(self.device, key=lambda k: k[1]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def in_spans(self, name: str):
        """Kernels whose start lies in a span of `name`."""
        spans = [(s, e) for n, s, e in self.spans if n == name]
        return [k for k in self.kernels if any(s <= k[1] < e for s, e in spans)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps,
        summed by what the host was doing: the innermost benchmark span
        around the gap's middle, else the program operation there."""
        by_op = collections.Counter()
        for name, _, dur in self.device:
            by_op[name] += dur / 1e9
        gaps = collections.Counter()
        busy = self.intervals()
        spans, ops = _Ranges(self.spans), _Ranges(self.cpu_ops)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = (e0 + s1) // 2
            label = spans.label(mid, "span ") or ops.label(mid, "op ") or "host, no span"
            gaps[label] += (s1 - e0) / 1e9
        return {"device_ops": [[_short(n), s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def _short(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list, at most `width` long."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name if cut < 0 else name[:cut])[:width]


class _Ranges:
    """Named ranges sorted by start; `label(t)` names the innermost one
    around t: the latest-starting range that still covers it (ranges of
    one thread nest)."""

    def __init__(self, ranges, lookback: int = 256):
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self.starts = [r[1] for r in self.ranges]
        self.lookback = lookback

    def label(self, t, prefix):
        i = bisect.bisect_right(self.starts, t)
        for name, s, e in reversed(self.ranges[max(0, i - self.lookback):i]):
            if e > t:
                return prefix + name
        return None
