# Frozen copy of cips3dpp_torch/models/diffaug.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""DiffAugment: differentiable color / translation / cutout augmentations
(counterpart of cips3dpp_tpu/models/diffaug.py; contract
exp/cips3d/models/diffaug.py:9-85, policy 'color,translation,cutout').

NHWC. The random parameters are tensors, drawn by `diffaug_draws` from a
`torch.Generator` or given by the caller, so the same draws can be fed to
both packages.
"""

from __future__ import annotations

import torch

POLICY = "color,translation,cutout"
# this fork's cutout ratio (exp/cips3d/models/diffaug.py:67), not the
# published DiffAugment default of 0.5
CUTOUT_RATIO = 0.2
TRANSLATION_RATIO = 0.125


def _per_sample(v, x):
    return v.to(device=x.device, dtype=x.dtype).reshape(-1, 1, 1, 1)


def diffaug_draws(generator: torch.Generator | None, batch: int, h: int, w: int,
                  policy: str = POLICY, device=None) -> dict:
    """The draws of one augmentation of a (batch, h, w, C) image, each
    (batch,): brightness, saturation, contrast in U(0, 1); translation
    shifts ty in [-sh, sh], tx in [-sw, sw]; cutout centres oy in
    [0, h + 1 - ch % 2), ox likewise."""
    gdev = generator.device if generator is not None else "cpu"
    kw = dict(generator=generator, device=gdev)
    out = {}
    parts = policy.split(",")
    if "color" in parts:
        for k in ("brightness", "saturation", "contrast"):
            out[k] = torch.rand((batch,), **kw)
    if "translation" in parts:
        sh, sw = int(h * TRANSLATION_RATIO + 0.5), int(w * TRANSLATION_RATIO + 0.5)
        out["ty"] = torch.randint(-sh, sh + 1, (batch,), **kw)
        out["tx"] = torch.randint(-sw, sw + 1, (batch,), **kw)
    if "cutout" in parts:
        ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
        out["oy"] = torch.randint(0, h + (1 - ch % 2), (batch,), **kw)
        out["ox"] = torch.randint(0, w + (1 - cw % 2), (batch,), **kw)
    return {k: v.to(device) for k, v in out.items()}


def rand_brightness(x, u):
    return x + (_per_sample(u, x) - 0.5)


def rand_saturation(x, u):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (_per_sample(u, x) * 2.0) + mean


def rand_contrast(x, u):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (_per_sample(u, x) + 0.5) + mean


def rand_translation(x, ty, tx):
    """Per-sample integer shift with zero fill."""
    b, h, w, c = x.shape
    gy = torch.arange(h, device=x.device)[None, :, None] + ty.to(x.device).reshape(b, 1, 1)
    gx = torch.arange(w, device=x.device)[None, None, :] + tx.to(x.device).reshape(b, 1, 1)
    valid = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)  # (B, H, W)
    gy = gy.clamp(0, h - 1)
    gx = gx.clamp(0, w - 1)
    out = torch.gather(x, 1, gy[..., None].expand(b, h, w, c))
    out = torch.gather(out, 2, gx[..., None].expand(b, h, w, c))
    return out * valid[..., None].to(x.dtype)


def rand_cutout(x, oy, ox):
    b, h, w, _ = x.shape
    ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
    oy = oy.to(x.device).reshape(b, 1, 1)
    ox = ox.to(x.device).reshape(b, 1, 1)
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    inside = ((gy >= oy - ch // 2) & (gy < oy + ch - ch // 2)
              & (gx >= ox - cw // 2) & (gx < ox + cw - cw // 2))
    return x * (1.0 - inside[..., None].to(x.dtype))


def diff_augment(x: torch.Tensor, draws: dict, policy: str = POLICY) -> torch.Tensor:
    """Apply the policy's augmentations in order with the given draws."""
    for p in policy.split(","):
        if p == "color":
            x = rand_brightness(x, draws["brightness"])
            x = rand_saturation(x, draws["saturation"])
            x = rand_contrast(x, draws["contrast"])
        elif p == "translation":
            x = rand_translation(x, draws["ty"], draws["tx"])
        elif p == "cutout":
            x = rand_cutout(x, draws["oy"], draws["ox"])
        else:
            raise ValueError(f"diff_augment: unknown policy {p!r}")
    return x
