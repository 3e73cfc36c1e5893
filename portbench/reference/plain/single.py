"""What the copied modules took from the program's `parallel.mesh` and
`kernels` packages, for one process: the collectives are identities off a
mesh (as the source's are with mesh=None), and the kernel route is the
program's rule, which the reference follows at K1's precision."""

from __future__ import annotations


def all_gather_batch(x, mesh=None):
    return x


def shard_batch(x, mesh=None):
    return x


def global_mean(x, mesh=None):
    return x


def global_means(metrics, mesh=None):
    return metrics


def default_kernel_route(depth, width, n_samples, with_sdf, device):
    """(take K1, why not), by the program's rule (kernels/siren_render.py):
    on the card, for a depth-2 SDF renderer of any width and sample count.
    Where it is taken, the reference's renderer computes K1's precision
    plainly (`models/renderer.py:k1_precision_network`)."""
    import torch

    if torch.device(device).type != "cuda":
        return False, None
    if depth != 2 or not with_sdf or width < 1 or n_samples < 1:
        return False, "K1 renders depth-2 SDF renderers"
    return True, None
