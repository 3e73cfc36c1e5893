"""The readers of the program's own spans and counter, on traced runs of
both cells at small models on the CPU: each of the six metrics reads a
finite number, and the host-sync metrics count every read of a tensor's
value on the host inside the program's spans in the traced units
(`aten::_local_scalar_dense` in the same trace), but Adam's reads of its
step counts, which it keeps on the host."""

from __future__ import annotations

import math
import types

import pytest
import torch

from portbench.lib import harness
from portbench.lib.common import load_named
from portbench.lib.program_spans import UNIT_OPENERS

from .portbench_small import run_small, small_config, small_train_config

VIDEO = "ffhq_r1024_serve.video36_f12"
TRAIN = "ffhq_r1024_train.iters_b4"
METRICS = {
    VIDEO: ("prepare_issue_ms.serve", "prepare_idle_ms.serve", "host_syncs_per_request.serve"),
    TRAIN: ("host_syncs_per_iter.train", "d_step_idle_ms.train", "g_step_idle_ms.train"),
}
NOT_DEVICE_READS = ("Optimizer.step#Adam.step",)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _traced(monkeypatch, cell, config, seconds, cache=None):
    """The result of a traced run of `cell` and its Trace."""
    made = []
    new_trace = harness.Context.new_trace
    monkeypatch.setattr(harness.Context, "new_trace",
                        lambda ctx: made.append(new_trace(ctx)) or made[-1])
    result = run_small(cell, config, seconds=seconds, trace=True, cache=cache)
    return result, made[0]


def _host_reads_per_unit(trace):
    """Host reads inside the program's spans in the traced units, a unit."""
    ops = sorted(trace.cpu_ops, key=lambda r: r[1])
    opens = [s for n, s, _ in ops if n[len("cips."):] in UNIT_OPENERS]
    cut = opens[trace.units] if len(opens) > trace.units else math.inf
    spans = [r for r in ops if r[0].startswith("cips.") and not r[0].startswith("cips.count.")]
    exempt = [r for r in ops if r[0] in NOT_DEVICE_READS]
    inside = lambda rs, s, e: any(a <= s and e <= b for _, a, b in rs)
    reads = [r for r in ops if r[0] == "aten::_local_scalar_dense" and r[1] < cut
             and inside(spans, r[1], r[2]) and not inside(exempt, r[1], r[2])]
    return len(reads) / trace.units


def _check(result, trace, cell, syncs_metric):
    """Every metric of the cell reads a finite number, the host's
    operations standing in for the device records the CPU has none of;
    the host syncs are the host reads. Returns the readings."""
    assert result["metrics"][syncs_metric]["value"] == _host_reads_per_unit(trace)
    assert not trace.device
    trace.device = [(n, s, e - s) for n, s, e in trace.cpu_ops if n.startswith("aten::")]
    run = types.SimpleNamespace(trace=trace)
    got = {name: load_named("metrics", name, ".py").read(run) for name in METRICS[cell]}
    for name, value in got.items():
        assert value is not None and math.isfinite(value) and value >= 0, name
    # the harness's breakdown of the same idle by its own spans around the
    # calls: its prepare span holds the program's, the program's D and G
    # step spans hold the harness's
    by_span = dict(trace.breakdown(top=100)["idle_gaps"])
    ms = lambda *labels: sum(by_span.get("span " + n, 0.0) for n in labels) * 1e3 / trace.units
    tol = 1e-9
    if cell == VIDEO:
        assert 0 < got["prepare_idle_ms.serve"] <= ms("prepare") + tol
    else:
        assert got["d_step_idle_ms.train"] >= ms("d_step", "d_step_r1") - tol
        assert got["g_step_idle_ms.train"] >= ms("g_step", "path_step") - tol
    return got


def test_serving_readers(monkeypatch):
    cfg = small_config("ffhq_r1024_serve")
    cfg["serving"]["mean_latent_samples"] = 256
    result, trace = _traced(monkeypatch, VIDEO, cfg, 0.0)
    _check(result, trace, VIDEO, "host_syncs_per_request.serve")
    assert result["metrics"]["host_syncs_per_request.serve"]["value"] == 2  # K1's constants


def test_training_readers(monkeypatch, tmp_path):
    """The D step's fakes through K1's plain version, as on the card."""
    from cips3dpp_torch.kernels.siren_render import kernel_route_refusal
    from cips3dpp_torch.train import steps

    def route(*args):
        why = kernel_route_refusal(*args)
        return why is None, why

    monkeypatch.setattr(steps, "default_kernel_route", route)
    cfg = small_train_config()
    result, trace = _traced(monkeypatch, TRAIN, cfg, 1.5, cache=tmp_path)
    assert trace.units >= 1
    _check(result, trace, TRAIN, "host_syncs_per_iter.train")
    # K1's two constants an item, and the G step's backward through the
    # plain renderer's cumprod
    assert result["metrics"]["host_syncs_per_iter.train"]["value"] == \
        2 * cfg["train"]["batch"] + 1
