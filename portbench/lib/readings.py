"""What the training check reads from a training state, the program's or
the reference's alike (their modules have the same parameter names), and
how the two are compared."""

from __future__ import annotations

import statistics

import torch

MODULES = ("g", "d", "d_render", "g_ema")
OPTIMIZERS = {"g": "opt_g", "d": "opt_d", "d_render": "opt_d_render"}
LOSSES = ("d_loss_total", "g_loss_total", "g_loss_weighted_path")
# the first D step's readings on the real batch: taken before any update
# and away from the D step's fakes (which K1 renders with bf16 products),
# so in f32 the program and the reference agree to the last bits
REAL = ("d_logits_real_decoder", "d_logits_real_render", "d_loss_r1_render")
# leaves whose first reference gradient is under this share of their
# module's median leaf move by round-off alone under Adam; left out of the
# change
ROUNDOFF_SHARE = 1e-3


class FirstFakes:
    """The images of the first G step, the first call of `g` with
    gradients on: they depend on G's weights and the draws alone, before
    any update and away from the D step, so they read G's forward (the
    plain renderer and the decoder) by themselves. `close()` removes the
    hook and returns them (on the host, f32), or None if G never ran."""

    def __init__(self, g):
        self.rgb = None
        self._hook = g.register_forward_hook(self._take)

    def _take(self, module, args, out):
        if self.rgb is None and torch.is_grad_enabled():
            self.rgb = out["rgb"].detach().float().cpu()

    def close(self):
        self._hook.remove()
        return self.rgb


def _leaves(state, mod):
    return ((f"{mod}.{n}", p) for n, p in getattr(state, mod).named_parameters())


@torch.no_grad()
def first_grads(state) -> dict:
    """The norm of each leaf's gradient as the optimizer got it in its one
    step so far (clipped): Adam's first moment with beta1 = 0 is it."""
    out = {}
    for mod, opt in OPTIMIZERS.items():
        moments = getattr(state, opt).adam.state
        for name, p in _leaves(state, mod):
            m = moments.get(p, {}).get("exp_avg")
            out[name] = 0.0 if m is None else float(m.float().norm())
    return out


@torch.no_grad()
def snapshot(state) -> dict:
    return {name: p.detach().clone() for mod in MODULES for name, p in _leaves(state, mod)}


@torch.no_grad()
def change_norms(state, snap) -> dict:
    return {name: float((p.detach().float() - snap[name].float()).norm())
            for mod in MODULES for name, p in _leaves(state, mod)}


def losses(metrics: dict) -> dict:
    return {k: float(metrics[k]) for k in LOSSES + REAL if k in metrics}


def _rel(p, r, floor=1e-30):
    return float("inf") if p is None else abs(p - r) / max(abs(r), floor)


def _module(leaf):
    return leaf.split(".")[0]


def compare(prog: dict, ref: dict) -> dict:
    """{"real_gap", "fake_gap", "loss_gap", "grad_gap", "step_gap"}: the
    worst relative gap of the first D step's real-batch readings (REAL,
    over the larger of the reference's value and 1); the worst image's mean
    absolute gap of the first G step's fakes (FirstFakes); of a loss (LOSSES)
    over the iterations; of a leaf's first-gradient norm; of a leaf's change
    after the iterations. A leaf's gap is between the two norms, over the
    larger of the reference's norm of that leaf and of its module's median
    leaf; the change leaves out the leaves whose first reference gradient
    is round-off (ROUNDOFF_SHARE)."""
    inf = float("inf")
    # a mean logit can lie near zero: its gap is taken on a scale of at
    # least one, where the logistic loss turns
    real_gap = max(_rel(prog["losses"][0].get(k), r, floor=1.0)
                   for k, r in ref["losses"][0].items() if k in REAL)
    fake_gap = _image_gap(prog.get("fakes"), ref["fakes"])
    loss_gap = 0.0 if len(prog["losses"]) == len(ref["losses"]) else inf
    for p, r in zip(prog["losses"], ref["losses"]):
        loss_gap = max([loss_gap] + [_rel(p.get(k), rv) for k, rv in r.items() if k in LOSSES])
    med_g = {m: statistics.median([v for k, v in ref["grad1"].items()
                                   if _module(k) == m and v > 0] or [0.0])
             for m in OPTIMIZERS}
    grad_gap = max(abs(prog["grad1"][k] - r) / max(r, med_g[_module(k)], 1e-30)
                   for k, r in ref["grad1"].items())
    grad_of = lambda k: ref["grad1"][k.replace("g_ema.", "g.", 1)]
    med_of = lambda k: med_g["g" if _module(k) == "g_ema" else _module(k)]
    moved = [k for k in ref["delta"] if grad_of(k) > 0 and grad_of(k) >= ROUNDOFF_SHARE * med_of(k)]
    med_d = {m: statistics.median([ref["delta"][k] for k in moved if _module(k) == m] or [0.0])
             for m in MODULES}
    step_gap = max(abs(prog["delta"][k] - ref["delta"][k])
                   / max(ref["delta"][k], med_d[_module(k)], 1e-30) for k in moved)
    return {"real_gap": real_gap, "fake_gap": fake_gap, "loss_gap": loss_gap,
            "grad_gap": grad_gap, "step_gap": step_gap}


def _image_gap(prog, ref) -> float:
    """The largest over the batch of an image's mean absolute gap; inf
    where the program's images are missing or of another shape."""
    if prog is None or prog.shape != ref.shape:
        return float("inf")
    return float((prog - ref).abs().flatten(1).mean(1).max())
