"""The port's spans and host-sync counter (utils/profiling.py) on the CPU,
over a small serving request (prepare_trajectory, render_frame,
render_camera) and one small training iteration through Trainer.train
(the D step's fakes through K1's plain version, as on the card):

- with no profiler running nothing opens a range, and the outputs are
  bit-equal to the same work under the profiler;
- under the profiler each span appears once a call, inside the span
  around it;
- every read of a tensor's value on the host inside a span
  (`aten::_local_scalar_dense`) leaves one `cips.count.host_sync`
  marker, and `COUNTS["host_sync"]` grows by as many;
- a span still open when the profiler stops closes without error;
- in `profiling.trace`'s Chrome trace the spans are operator ranges, not
  user annotations (which the profiler copies onto the device timeline).
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cips3dpp_torch.utils import profiling

# Host reads that read no device value on the card, by the range they run
# in: torch.optim.Adam keeps its step counts on the host (not capturable)
# and reads them for its bias corrections.
NOT_DEVICE_READS = ("Optimizer.step#Adam.step",)

SERVE_SPANS = {
    ("serve.prepare", None): 1, ("serve.map_zs", "serve.prepare"): 1,
    ("k1.prepare", "serve.prepare"): 1, ("decoder.prepare", "serve.prepare"): 1,
    ("serve.render", None): 3, ("serve.rays", "serve.render"): 3,
    ("k1.render", "serve.render"): 3, ("decoder.render", "serve.render"): 3,
}
BATCH = 2


def _train_spans(d_step, path):
    spans = {
        ("train.data_wait", None): 1, (d_step, None): 1, ("train.d.fakes", d_step): 1,
        ("k1.prepare", "train.d.fakes"): BATCH, ("k1.render", "train.d.fakes"): BATCH,
        ("train.d.grads", d_step): 1, ("train.d.optim", d_step): 1,
        ("train.g_step", None): 1, ("train.g.forward", "train.g_step"): 1,
        ("train.g.grads", "train.g_step"): 1, ("train.g.optim", "train.g_step"): 1,
        ("train.ema", None): 1, ("train.log", None): 1,
    }
    if path:
        spans[("train.path_step", None)] = 1
    return spans


# (start iteration, D span, path step): with d_reg_every 4 and g_reg_every
# 2, iteration 4 is a plain one, iteration 3 takes lazy R1 and a path step
ITERATIONS = {"plain": (4, "train.d_step", False), "r1_path": (3, "train.d_step_r1", True)}


def _gen_cfg():
    from cips3dpp_torch.models.generator import (
        DecoderConfig, GeneratorConfig, RendererConfig,
    )

    return GeneratorConfig(
        renderer=RendererConfig(n_layers=2, hidden_dim=32),
        decoder=DecoderConfig(size_end=16, upsample_list=(16,), style_dim=64,
                              mapping_n_layers=2),
        img_size=8, n_samples=4)


def _serve():
    """prepare_trajectory, two render_frame calls and one render_camera
    call of a seeded small generator: their outputs."""
    from cips3dpp_torch import serving
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.models.generator import Generator

    cfg = _gen_cfg()
    g = Generator(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    zs = [torch.randn((1, cfg.mapping.z_dim), generator=gen) for _ in range(2)]
    noise = g.decoder.make_noise(gen, cfg.img_size, device="cpu")
    prep = serving.prepare_trajectory(g, zs, noise_bufs=noise, truncation=0.7, device="cpu")
    outs = [serving.render_frame(g, prep, torch.tensor([a, -a]), torch.zeros(2), device="cpu")
            for a in (0.1, 0.2)]
    cam = camera_from_angles(torch.tensor([0.05]), torch.tensor([0.02]), cfg.img_size,
                             fov_ang=cfg.fov_ang, dist_radius=cfg.dist_radius)
    outs.append(serving.render_camera(g, prep, cam, device="cpu"))
    return [prep["siren"]["consts"]] + [o[k] for o in outs for k in sorted(o)]


def _train(tmp_path, start, monkeypatch, stop_in_d_step=None):
    """One iteration of a seeded small Trainer at `start` with a log point,
    the D step's fakes through K1's plain version; the state's tensors.
    `stop_in_d_step`, a profiler, is stopped as the D step starts."""
    from cips3dpp_torch.kernels.siren_render import kernel_route_refusal
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.train import TrainConfig, Trainer
    from cips3dpp_torch.train import steps

    def route(*args):  # K1 wherever its geometry allows, as on the card
        why = kernel_route_refusal(*args)
        return why is None, why

    monkeypatch.setattr(steps, "default_kernel_route", route)
    cfg = _gen_cfg()
    tcfg = TrainConfig(batch=BATCH, d_reg_every=4, g_reg_every=2, fade_steps=16,
                       warmup_iters=0, ema_start=0, data_img_size=16)
    tr = Trainer(Generator(cfg, device="cpu"),
                 DStyleGANProgressive(input_size=16, channel_multiplier=1, device="cpu"),
                 DVolumeRenderProgressive(input_size=8, device="cpu"), cfg, tcfg,
                 str(tmp_path / f"logs{start}"), log_every=1)
    state = tr.init_state(torch.Generator().manual_seed(1))
    if stop_in_d_step is not None:
        d_step, *rest = tr.steps

        def stopping(*args, **kwargs):
            stop_in_d_step.stop()
            return d_step(*args, **kwargs)

        tr.steps = (stopping, *rest)
    images = np.random.default_rng(0).uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    state = tr.train(state, iter([images]), torch.Generator().manual_seed(5),
                     start_iter=start, total_iters=start + 1)
    out = {}
    for k in ("g", "g_ema", "d", "d_render"):
        out.update({f"{k}.{n}": v for n, v in getattr(state, k).state_dict().items()})
    return out


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _ranges(events):
    """The spans, without the counter's markers: [(name, start, end)]."""
    return [(n[5:], s, e) for n, s, e in events
            if n.startswith("cips.") and not n.startswith("cips.count.")]


def _around(ranges, s, e):
    """The innermost range of `ranges` around [s, e], or None."""
    inner = [r for r in ranges if r[1] <= s and e <= r[2]]
    return min(inner, key=lambda r: r[2] - r[1], default=None)


def _nesting(events):
    spans = _ranges(events)
    return collections.Counter(
        (n, (_around([r for r in spans if r != (n, s, e)], s, e) or (None,))[0])
        for n, s, e in spans)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _events(prof)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _no_ranges(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range opened with no profiler running: {name}")

    monkeypatch.setattr(profiling, "_Range", refuse)


def test_off_opens_nothing_and_changes_no_output(tmp_path, monkeypatch):
    with monkeypatch.context() as m:
        _no_ranges(m)
        serve_off = _serve()
        train_off = _train(tmp_path / "off", 3, monkeypatch)
    serve_on, _ = _profiled(_serve)
    train_on, _ = _profiled(lambda: _train(tmp_path / "on", 3, monkeypatch))
    assert _equal(serve_off, serve_on)
    assert _equal(train_off, train_on)


def test_serving_spans_nest_once_a_call():
    _, events = _profiled(_serve)
    assert _nesting(events) == SERVE_SPANS


@pytest.mark.parametrize("kind", sorted(ITERATIONS))
def test_training_spans_nest_once_a_call(tmp_path, monkeypatch, kind):
    start, d_span, path = ITERATIONS[kind]
    _, events = _profiled(lambda: _train(tmp_path, start, monkeypatch))
    assert _nesting(events) == _train_spans(d_span, path)


def _host_reads(events):
    """The host reads of tensor values inside spans, but those that read
    no device value on the card (NOT_DEVICE_READS)."""
    spans = [r for r in events if r[0].startswith("cips.")
             and not r[0].startswith("cips.count.")]
    exempt = [r for r in events if r[0] in NOT_DEVICE_READS]
    return [(n, s, e) for n, s, e in events if n == "aten::_local_scalar_dense"
            and _around(spans, s, e) and not _around(exempt, s, e)]


@pytest.mark.parametrize("run", ["serve", *sorted(ITERATIONS)])
def test_every_host_read_is_counted(tmp_path, monkeypatch, run):
    before = profiling.COUNTS["host_sync"]
    if run == "serve":
        _, events = _profiled(_serve)
    else:
        _, events = _profiled(lambda: _train(tmp_path, ITERATIONS[run][0], monkeypatch))
    markers = [r for r in events if r[0] == "cips.count.host_sync"]
    reads = _host_reads(events)
    assert reads, "no host read in the run"
    assert len(markers) == len(reads)
    assert profiling.COUNTS["host_sync"] - before == len(markers)
    # each marker lies in the span of the read it counts
    spans = _ranges(events)
    where = lambda rs: sorted((_around(spans, s, e) or (None,))[0] for _, s, e in rs)
    assert where(markers) == where(reads)


def test_counted_with_the_profiler_off():
    before = profiling.COUNTS["host_sync"]
    _serve()
    assert profiling.COUNTS["host_sync"] - before == 2  # K1's two constants


def test_a_span_open_when_the_profiler_stops_closes(tmp_path, monkeypatch):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    _train(tmp_path, 4, monkeypatch, stop_in_d_step=prof)
    names = [n for n, _, _ in _events(prof)]
    assert "cips.train.data_wait" in names and "cips.train.d_step" in names
    assert "cips.train.d.fakes" not in names  # after the stop
    assert profiling.span("x") is profiling.span("x")  # off again: the shared no-op


def test_chrome_trace_spans_are_operator_ranges(tmp_path):
    with profiling.trace(str(tmp_path)):
        _serve()
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    cats = collections.Counter(e.get("cat") for e in events
                               if str(e.get("name", "")).startswith("cips."))
    assert sum(cats.values()) == sum(SERVE_SPANS.values()) + 2  # and two markers
    assert set(cats) == {"cpu_op"}


def test_counters_share_one_registry():
    from cips3dpp_torch.kernels import _lib

    assert _lib.LAUNCHES is profiling.COUNTERS["launches"]
    assert profiling.COUNTS is profiling.COUNTERS["counts"]
    _lib.LAUNCHES["probe"] += 1
    _lib.reset_launches()
    assert "probe" not in _lib.LAUNCHES
