"""Weights made on the device from the seed, in two large draws.

`Pool` holds one buffer of N(0, 1) and one of U(0, 1) values, drawn by a
`torch.Generator` on the device, and hands out consecutive slices of
them. The reference modules' initialisers (`reference/plain/models/
layers.py`) take it in place of a torch.Generator, so every parameter
gets the distribution its layer's initialiser gives it, from the seed,
without a draw a leaf. The same seed gives the same weights: the program
and the reference each load them from a pool of that seed.
"""

from __future__ import annotations

import math

import torch


class Pool:
    def __init__(self, numel: int, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        self._normal = torch.randn(numel, generator=gen, device=device)
        self._uniform = torch.rand(numel, generator=gen, device=device)
        self._at = {"normal": 0, "uniform": 0}

    def _take(self, kind: str, shape) -> torch.Tensor:
        n = math.prod(shape)
        buf = self._normal if kind == "normal" else self._uniform
        at = self._at[kind]
        if at + n > buf.numel():
            raise ValueError(f"weight pool: {kind} draws past its {buf.numel()} values")
        self._at[kind] = at + n
        return buf[at:at + n].reshape(shape)

    def randn(self, shape) -> torch.Tensor:
        return self._take("normal", tuple(shape))

    def rand(self, shape) -> torch.Tensor:
        return self._take("uniform", tuple(shape))


def draw_weights(modules, seed: int, device) -> None:
    """Every parameter of `modules` (reference modules built with
    seed=None) from its layer's initialiser, the zero-initialised noise
    weights and biases made nonzero (so the noise and bias paths are
    checked), all from one pool of `seed`."""
    from ..reference.plain.models.layers import init_parameters, randomize_zero_init_

    numel = sum(p.numel() for m in modules for p in m.parameters())
    pool = Pool(2 * numel, seed, device)
    for m in modules:
        init_parameters(m, pool)
        randomize_zero_init_(m, pool)
