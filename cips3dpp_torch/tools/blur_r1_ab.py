"""The discriminator's R1 gradient with its blurs as separable slices (what
the port runs) against the same blurs as one depthwise convolution, on the
card.

    python -m cips3dpp_torch.tools.blur_r1_ab [--batch 4] [--size 1024] [--iters 2]

Builds a seeded DStyleGANProgressive(1024, channel multiplier 2) (the
train_r1024 image D), draws `batch` images of size^2 and times the
gradient of the R1 penalty with respect to every D parameter (a gradient
of a gradient, as the D step takes it) in turns: separable, depthwise,
depthwise, separable, with CUDA events. Prints one JSON line with the ms of
each form, their ratio, the largest difference of the two gradients
relative to the largest gradient, and the card's name. f32, TF32 off.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models import layers
from ..ops.upfirdn2d import upfirdn2d


def depthwise_blur(x, taps, pad):
    """The blur as one depthwise convolution of the 2-D kernel."""
    k2d = torch.outer(torch.tensor(taps), torch.tensor(taps))
    return upfirdn2d(x, k2d, pad=pad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("blur_r1_ab: needs a CUDA device")
    from ..kernels.siren_render import plain_precision
    from ..models.discriminator import DStyleGANProgressive
    from ..train.losses import r1_penalty

    plain_precision()
    dev = torch.device("cuda", 0)
    d = DStyleGANProgressive(1024, 2, device=dev, seed=0)
    params = list(d.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    real = torch.rand((args.batch, args.size, args.size, 3), generator=gen, device=dev) * 2 - 1
    separable = layers.blur

    def r1_grads():
        x = real.detach().requires_grad_(True)
        return torch.autograd.grad(r1_penalty(d(x, 0.5), x), params, allow_unused=True)

    def timed(blur_fn):
        layers.blur = blur_fn
        try:
            grads = r1_grads()  # warm-up
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                r1_grads()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.iters, grads
        finally:
            layers.blur = separable

    runs = {"separable": [], "depthwise": []}
    grads = {}
    for name in ("separable", "depthwise", "depthwise", "separable"):
        ms, grads[name] = timed(separable if name == "separable" else depthwise_blur)
        runs[name].append(ms)
    scale = max(float(g.abs().max()) for g in grads["depthwise"] if g is not None)
    diff = max(float((a - b).abs().max()) for a, b in zip(grads["separable"], grads["depthwise"])
               if a is not None)
    out = {"batch": args.batch, "size": args.size, "ms": runs,
           "separable_ms": sum(runs["separable"]) / 2, "depthwise_ms": sum(runs["depthwise"]) / 2,
           "grad_max_rel_diff": diff / scale, "device": torch.cuda.get_device_name(0)}
    out["depthwise_over_separable"] = out["depthwise_ms"] / out["separable_ms"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
