# Frozen copy of cips3dpp_torch/train/losses.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""GAN and geometry losses (counterpart of cips3dpp_tpu/train/losses.py;
contract exp/stylesdf/losses.py:7-69).

The gradient penalties take the tensors the reference's torch functions
take: `r1_penalty(real_pred, real_imgs)` differentiates the logits with
respect to the images (which must require grad) with create_graph, so
the penalty trains the discriminator (grad of grad).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred, fake_pred):
    """softplus(-real) + softplus(fake) (losses.py:27-31)."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """softplus(-fake) (losses.py:43-46)."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(real_pred, real_imgs):
    """Sum of squares of d(sum real_pred)/d(real_imgs) per sample, meaned
    (losses.py:34-40)."""
    (grad,) = torch.autograd.grad(real_pred.sum(), real_imgs, create_graph=True)
    return grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()


def eikonal_loss(eikonal_term):
    """(|grad sdf| - 1)^2 (losses.py:13-18)."""
    return (torch.linalg.norm(eikonal_term, dim=-1) - 1.0).square().mean()


def minimal_surface_loss(sdf, beta: float = 100.0):
    """exp(-beta * |sdf|) (losses.py:20-24)."""
    return torch.exp(-beta * sdf.abs()).mean()


def viewpoint_loss(pred, target):
    """Smooth-L1 (Huber, beta 1) on (azim, elev) (losses.py:7-10)."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).mean()


def path_length_penalty(fake_img, latents_grad, mean_path_length, decay=0.01, mesh=None):
    """StyleGAN2 path-length regulariser (losses.py:49-69). latents_grad:
    d(sum(fake * noise)) / d(style_decoder), (B, L, D), taken by the
    caller with create_graph. Returns (penalty, new mean path length
    (detached), path lengths (B,)). Under a data `mesh` the batch mean of
    the path lengths is the global batch's."""
    from ..single import global_mean  # portbench

    path_lengths = torch.sqrt(latents_grad.square().sum(dim=2).mean(dim=1))
    batch_mean = global_mean(path_lengths.mean(), mesh)
    path_mean = mean_path_length + decay * (batch_mean - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    return penalty, path_mean.detach(), path_lengths


def path_noise(generator: torch.Generator | None, fake_img, batch: int | None = None):
    """randn / sqrt(H*W), image-shaped (B, H, W, C) (losses.py:53-55),
    drawn from `generator` on its own device; `batch` rows instead of B."""
    b, h, w, c = fake_img.shape
    gdev = generator.device if generator is not None else "cpu"
    noise = torch.randn((b if batch is None else batch, h, w, c), generator=generator,
                        dtype=fake_img.dtype, device=gdev)
    return noise.to(fake_img.device) / math.sqrt(h * w)
