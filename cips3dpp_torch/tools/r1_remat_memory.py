"""Peak device memory of the image D's lazy-R1 pass in three forms, on the
card, and where the bytes alive at each peak were allocated.

    python -m cips3dpp_torch.tools.r1_remat_memory [--batch 4] [--size 1024] [--history]

Builds a seeded DStyleGANProgressive(size, channel multiplier 2) (the
train_r1024 image D) and `batch` fake and real images, and takes the D
step's image-D part: the logits of the fakes and the reals, the GAN loss
and the R1 penalty on the reals, and the gradient of their sum with
respect to every D parameter. The forms:

  plain       the D step without remat_d;
  checkpoint  torch.utils.checkpoint around each logit and R1 on the
              checkpointed logit (the port's remat_d before its R1 region);
  region      the fakes' logit checkpointed, the reals' logit and R1
              penalty one recomputed region (train/steps.py: _RematR1,
              remat_d now).

The forms run in turns (plain, checkpoint, region, region, checkpoint,
plain). A form's peak is max_memory_allocated above the bytes allocated
before it. Its R1 value and gradients are held against the plain form's
(largest difference relative to a tensor's largest gradient). With
--history the allocator records every run (python stacks), and the bytes
alive at the run's peak that it allocated are grouped by the innermost
frame in cips3dpp_torch ("recompute: ..." where the checkpoint's
recomputation made them; "autograd engine" where no python frame did: a
backward formula). Prints one JSON line with the card's name; f32, TF32
off.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch
from torch.utils.checkpoint import checkpoint

FORMS = ("plain", "checkpoint", "region")
ORDER = ("plain", "checkpoint", "region", "region", "checkpoint", "plain")


def image_d_part(d, fake, real, form):
    """(R1 value, gradients) of the image D's GAN loss + R1 on the reals
    (at train_r1024's lambda_gp 10 and d_reg_every 16) in `form`."""
    from ..train.losses import d_logistic_loss, r1_penalty
    from ..train.steps import _logit_and_r1, _RematR1

    params = list(d.parameters())
    fn = lambda v: d(v, 0.5).float()
    if form == "plain":
        fake_pred = fn(fake)
        real_pred, r1 = _logit_and_r1(fn, real)
    elif form == "checkpoint":
        fake_pred = checkpoint(fn, fake, use_reentrant=False)
        x = real.detach().requires_grad_(True)
        real_pred = checkpoint(fn, x, use_reentrant=False)
        r1 = r1_penalty(real_pred, x)
    else:
        fake_pred = checkpoint(fn, fake, use_reentrant=False)
        real_pred, r1 = _RematR1.apply(fn, real, *params)
    loss = d_logistic_loss(real_pred, fake_pred) + 10 * 0.5 * 16 * r1
    return r1.detach(), torch.autograd.grad(loss, params, allow_unused=True)


def peak_above_start(fn, dev):
    """(fn's result, its peak bytes above the bytes allocated before it)."""
    torch.cuda.synchronize(dev)
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - start


def _where(frames):
    """The group of an allocation from its python stack (innermost first)."""
    recompute = any("utils/checkpoint.py" in f["filename"] for f in frames)
    for f in frames:
        name = f["filename"]
        if "cips3dpp_torch" in name and "tools/r1_remat_memory" not in name:
            key = f"{name[name.rindex('cips3dpp_torch'):]}:{f['line']} {f['name']}"
            return ("recompute: " if recompute else "") + key
    return "recompute: (checkpoint)" if recompute else "autograd engine"


def live_at_peak(fn, dev, top=12):
    """Run fn with the allocator's history on: (fn's result, the groups of
    the bytes alive at the run's peak, largest first)."""
    torch.cuda.synchronize(dev)
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        out = fn()
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][dev.index or 0]

    def replay(stop=None):
        live, cur, peak, at = {}, 0, 0, -1
        for i, ev in enumerate(trace):
            if stop is not None and i > stop:
                break
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
            elif ev["action"] in ("free_requested", "free_completed"):
                e = live.pop(ev["addr"], None)
                cur -= e["size"] if e is not None else 0
            if cur > peak:
                peak, at = cur, i
        return live, peak, at

    _, _, at = replay()
    live, _, _ = replay(at)
    groups = collections.Counter()
    for ev in live.values():
        groups[_where(ev.get("frames") or [])] += ev["size"]
    return out, [{"where": k, "bytes": v} for k, v in groups.most_common(top)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--history", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("r1_remat_memory: needs a CUDA device")
    from ..kernels.siren_render import plain_precision
    from ..models.discriminator import DStyleGANProgressive

    plain_precision()
    dev = torch.device("cuda", 0)
    d = DStyleGANProgressive(args.size, 2, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (args.batch, args.size, args.size, 3)
    fake = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    real = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    peaks = {f: [] for f in FORMS}
    live = {f: [] for f in FORMS}
    got = {}
    for form in ORDER:
        run = lambda: image_d_part(d, fake, real, form)
        if args.history:
            (got[form], groups), peak = peak_above_start(lambda: live_at_peak(run, dev), dev)
            live[form].append(groups)
        else:
            got[form], peak = peak_above_start(run, dev)
        peaks[form].append(peak)
    r1_plain, g_plain = got["plain"]
    gaps = {}
    for form in FORMS[1:]:
        r1, grads = got[form]
        gaps[form] = {
            "r1_rel": float((r1 - r1_plain).abs() / r1_plain.abs()),
            "grad_rel": max(float((g - w).abs().max() / w.abs().max())
                            for g, w in zip(grads, g_plain) if w is not None),
        }
    del got
    out = {"batch": args.batch, "size": args.size, "peak_bytes": peaks, "vs_plain": gaps,
           "card": torch.cuda.get_device_name(dev)}
    if args.history:
        out["live_at_peak"] = live
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
