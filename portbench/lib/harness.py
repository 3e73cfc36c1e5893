"""From a cell's name to its result: the cell's entry in BENCHMARK.json,
its configuration and traffic files, the system that runs them, and the
metric readers. Nothing here names a cell, a configuration or a metric:
each is found by the name BENCHMARK.json gives it."""

from __future__ import annotations

import math
import types

import torch

from .common import ROOT, load_json, load_named
from .trace import Trace


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json at the checkout's root")
    return load_json(path)


def find_cell(name: str, bench: dict | None = None) -> dict:
    bench = benchmark() if bench is None else bench
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or with
    the trace its per-layer ones; a metric with `workloads` only in those
    cells."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            out.append(m)
    return out


class Context(types.SimpleNamespace):
    """What a system's `run(ctx)` gets: config, traffic, seed, seconds,
    device, t_start, trace (bool), precision ("program" or the control's
    "fp8" / "tf32"), cell, cache (a directory) and `new_trace()`."""

    def new_trace(self):
        return Trace() if self.trace else None


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, t_start,
            bench: dict | None = None, config: dict | None = None,
            precision: str = "program", cache=None) -> dict:
    """One run of `cell`: the result line's dict ("checks" last). `config`
    replaces the cell's configuration file (the tests' small models);
    `precision` other than "program" puts the reference at the control's
    precision in the program's place for the check; `cache` is where data
    made once a checkout is kept (default portbench_cache/ at its root)."""
    bench = benchmark() if bench is None else bench
    config = load_named("configs", cell["config"]) if config is None else config
    mix = load_named("traffic", cell["traffic"])
    system = load_named("systems", config["system"], ".py")
    ctx = Context(config=config, traffic=mix, seed=seed, seconds=seconds, device=device,
                  t_start=t_start, trace=trace, precision=precision, cell=cell,
                  cache=ROOT / "portbench_cache" if cache is None else cache)
    out = system.run(ctx)
    run = types.SimpleNamespace(**out, config=config, traffic=mix, cell=cell, seconds=seconds)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load_named("metrics", m["name"], ".py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    correct = all(_within(c["value"], c["limit"]) for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    tr = out["trace"]
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def _within(value, limit) -> bool:
    """A number within its limit (None: read, not compared)."""
    if limit is None:
        return True
    return isinstance(value, (int, float)) and math.isfinite(value) and value <= limit
