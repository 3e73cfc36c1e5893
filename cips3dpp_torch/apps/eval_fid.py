"""FID and KID evaluation (counterpart of cips3dpp_tpu/apps/eval_fid.py).

Behavioural contract: exp/cips3d/scripts/eval_fid.py (torch-fidelity FID
and KID over real and generated images), gen_images.py (random-camera
sampling, sharded by rank) and setup_evaluation.py (the real set).
Generation runs the generator as the JAX package's `generate_images` does
(the plain renderer, perturbed z-values, drawn noise buffers); features
come from InceptionV3 (`models/inception.py`) on the card; FID and KID
are closed-form float64 numpy on the host, the same code as the JAX
package's (this package's own copy of it).

Under a data mesh each rank generates its rows of every global batch
from the draws of the whole batch (the same generator on every rank),
and the features of every batch are gathered on every rank, so each rank
computes the same FID.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..parallel.mesh import all_gather_batch, shard_batch

# ---------------------------------------------------------------- metrics --


def _sym_eigvals(m):
    """Eigenvalues of a symmetric PSD matrix, robust to LAPACK dsyevd
    non-convergence on degenerate or badly scaled spectra (rank-deficient
    covariances at small sample counts): normalised by the largest entry,
    with singular values (= the eigenvalues of a PSD matrix) as the
    fallback."""
    m = (m + m.T) / 2
    scale = float(np.max(np.abs(m)))
    if not np.isfinite(scale):
        raise ValueError("non-finite covariance product in FID")
    if scale == 0.0:
        return np.zeros(len(m))
    try:
        return np.linalg.eigvalsh(m / scale) * scale
    except np.linalg.LinAlgError:
        return np.linalg.svd(m / scale, compute_uv=False) * scale


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """FID between two feature Gaussians: |mu1 - mu2|^2 + tr(S1 + S2 -
    2 sqrtm(S1 S2)), the trace of the matrix square root taken as that of
    sqrtm(sqrtm(S1) S2 sqrtm(S1)) by eigendecompositions."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1, s2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = mu1 - mu2

    va, ua = np.linalg.eigh(s1 + eps * np.eye(len(s1)))
    sq1 = ua @ np.diag(np.sqrt(np.maximum(va, 0))) @ ua.T
    inner = sq1 @ (s2 + eps * np.eye(len(s2))) @ sq1
    vi = _sym_eigvals(inner)
    tr_covmean = np.sum(np.sqrt(np.maximum(vi, 0)))

    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * tr_covmean)


def kid(features_a, features_b, n_subsets: int = 100, subset_size: int = 1000,
        seed: int = 0):
    """Kernel Inception Distance: the unbiased polynomial-kernel MMD^2 with
    torch-fidelity's defaults (degree 3, gamma 1/dim, coef 1), mean and
    std over subsets."""
    a = np.asarray(features_a, np.float64)
    b = np.asarray(features_b, np.float64)
    n = min(subset_size, len(a), len(b))
    d = a.shape[1]
    rng = np.random.RandomState(seed)

    def poly(x, y):
        return (x @ y.T / d + 1.0) ** 3

    vals = []
    for _ in range(n_subsets):
        xa = a[rng.choice(len(a), n, replace=False)]
        xb = b[rng.choice(len(b), n, replace=False)]
        kaa, kbb, kab = poly(xa, xa), poly(xb, xb), poly(xa, xb)
        sum_aa = (kaa.sum() - np.trace(kaa)) / (n * (n - 1))
        sum_bb = (kbb.sum() - np.trace(kbb)) / (n * (n - 1))
        sum_ab = kab.mean()
        vals.append(sum_aa + sum_bb - 2 * sum_ab)
    return float(np.mean(vals)), float(np.std(vals))


def feature_stats(features):
    f = np.asarray(features, np.float64)
    return f.mean(axis=0), np.cov(f, rowvar=False)


# ----------------------------------------------------------- feature pipe --


class InceptionExtractor:
    """fidelity_protocol=True (default) is the reference's pipeline end to
    end: images are quantised to uint8 as `save_image_dir` writes them (by
    truncation), then fed through torch-fidelity's input path (TF1 resize,
    (x - 128) / 128). False feeds the [-1, 1] floats. `batch_size` is kept
    for the JAX package's interface; each batch given is run whole."""

    def __init__(self, inception, batch_size: int = 32, fidelity_protocol: bool = True):
        self.inception = inception
        self.batch_size = batch_size
        self.fidelity_protocol = fidelity_protocol

    @torch.no_grad()
    def __call__(self, images: Iterable, mesh=None) -> np.ndarray:
        """NHWC [-1, 1] batches (numpy or tensors) -> (N, 2048) float32;
        under a mesh each batch is the rank's rows and the features are
        the whole batch's, gathered from every rank."""
        dev = next(self.inception.parameters()).device
        feats = []
        for batch in images:
            x = torch.as_tensor(batch).to(dev, torch.float32)
            if self.fidelity_protocol:
                x = torch.floor((x.clamp(-1.0, 1.0) + 1.0) * 127.5)
            f = self.inception(x, fidelity_u8=self.fidelity_protocol)
            feats.append(all_gather_batch(f, mesh).cpu().numpy())
        return np.concatenate(feats, axis=0)


# ------------------------------------------------------------- generation --


@torch.no_grad()
def generate_images(model, n_images: int, batch_size: int,
                    generator: torch.Generator | None = None, to_host: bool = True,
                    callback: Callable | None = None, *, draws: Sequence | None = None,
                    mesh=None):
    """Batches of random z's and random cameras (gen_images.py:33-92) as
    NHWC [-1, 1] images: numpy (`to_host`) or tensors on the model's
    device. Each batch draws zs, cameras, perturbation and noise buffers
    from `generator` (default: seed 0 on the model's device), or takes
    them from `draws` (`train.steps.Draws`, one a batch). Off the mesh the
    last batch is cut to n_images; under a mesh each rank yields its rows
    of every whole batch (cut after the gather, by `eval_fid`)."""
    from ..train.state import TrainConfig
    from ..train.steps import draw_inputs, shard_draws

    dev = model.device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    given = iter(draws) if draws is not None else None
    done = 0
    while done < n_images:
        d = next(given) if given is not None else draw_inputs(
            generator, batch_size, model.cfg, TrainConfig(), dev, decoder=model.decoder)
        d = shard_draws(d, mesh)
        cam = d.cam
        out = model(zs=d.zs, cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near,
                    far=cam.far, noise_bufs=d.noise, t_rand=d.t_rand)
        imgs = out["rgb"].clamp(-1.0, 1.0)
        take = min(batch_size, n_images - done)
        if mesh is None:
            imgs = imgs[:take]
        done += take
        if callback:
            callback(done)
        yield imgs.float().cpu().numpy() if to_host else imgs


def save_image_dir(batches: Iterable[np.ndarray], outdir: str, start: int = 0,
                   fmt: str = "jpg"):
    """Write [-1, 1] batches as numbered images (the setup_evaluation /
    gen_images file layout). Needs PIL."""
    from PIL import Image

    os.makedirs(outdir, exist_ok=True)
    idx = start
    for batch in batches:
        for img in batch:
            u8 = ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8)
            Image.fromarray(u8).save(f"{outdir}/{idx}.{fmt}")
            idx += 1
    return idx


# ------------------------------------------------------------ entry point --


@dataclasses.dataclass
class FIDResult:
    fid: float
    kid_mean: float | None
    kid_std: float | None
    n_real: int
    n_fake: int


def eval_fid(model, real_batches: Iterable, inception, n_fake: int = 2048,
             batch_size: int = 16, generator: torch.Generator | None = None,
             with_kid: bool = False, *, draws: Sequence | None = None,
             mesh=None) -> FIDResult:
    """End-to-end FID (eval_fid.py:81-162): the reals' features, fakes
    generated and featurised, the Frechet distance (and KID). `real_batches`
    are whole batches; under a mesh every rank reads them all and takes its
    rows. `generator` defaults to seed 0 on the model's device, as the JAX
    package's key defaults to PRNGKey(0), and is the only stream drawn
    from."""
    extractor = InceptionExtractor(inception, batch_size)
    real_feats = extractor((shard_batch(b, mesh) for b in real_batches), mesh)
    fake_feats = extractor(
        generate_images(model, n_fake, batch_size, generator, draws=draws, mesh=mesh),
        mesh)[:n_fake]

    mu_r, sig_r = feature_stats(real_feats)
    mu_f, sig_f = feature_stats(fake_feats)
    fid = frechet_distance(mu_f, sig_f, mu_r, sig_r)
    if with_kid:
        kid_mean, kid_std = kid(fake_feats, real_feats)
    else:
        kid_mean = kid_std = None
    return FIDResult(fid, kid_mean, kid_std, len(real_feats), len(fake_feats))
