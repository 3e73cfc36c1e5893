"""Train steps: D update (with lazy R1), G update (with eikonal and
minimal-surface terms), path-length regulariser, sphere init, EMA
(counterpart of cips3dpp_tpu/train/steps.py; contract
train_v10.py:58-494, 595-668).

`make_train_steps(gen_cfg, cfg, mesh=None)` returns (d_step, g_step,
path_reg_step, sphere_init_step). Each step updates the modules and
optimizers of a `TrainState` in place and returns (state, metrics),
metrics as 0-d tensors on the state's device (read them with float()).
Each takes its random draws as a `Draws` (`draws=`), or makes them from
a `torch.Generator`; the draws of the JAX package (threefry) cannot be
reproduced by torch, so parity tests hand the same draws to both.

The D step's generator forward runs under no_grad (JAX's stop_gradient on
its fakes) and, with cfg.fused_renderer_d (the default), through the SIREN
render kernel: one launch per batch item. The route is decided once from
the configuration (`kernel_route_refusal`): a renderer K1 does not take
(depth 8, another width) renders plainly, and the steps say so once, as
the JAX package's renderer gates its kernel on depth 2; the same rule
holds for cfg.fused_renderer_g. Gradients are taken with
torch.autograd.grad with respect to the updated module only, so no
`.grad` of another module is touched.

The image D's options of the JAX steps (cips3dpp_tpu/train/steps.py:
144-400): `d_dtype` (its input cast at entry, its logit back to f32, in
the D and G steps), `remat_d` (torch.utils.checkpoint around each image-D
apply), `d_r1_chunk` (lazy R1 over real-batch chunks, the mean of the
chunk means), `d_seq` (the fake and real passes one after the other, their
gradients summed) and `d_cat` (one batch-2n pass with a per-half
minibatch stddev and a sign-split loss). With `d_seq` or `d_cat`, R1 runs
as one chunk of the whole batch after the GAN passes, as in JAX. With
diffaug, `d_cat` augments each half with the fake and real passes' draws
and the chunks take their rows of the R1 pass's draws.

Under a data `mesh` (parallel/mesh.py) a step on N ranks is the step on
one process at the same global batch, as under the JAX package's mesh
(its `_sample_inputs` with `constrain_batch`, cips3dpp_tpu/train/steps.py:
94-116): every rank draws the global batch's inputs (or takes the same
`Draws`) and keeps its rows; the image D's minibatch stddev is the global
batch's; the optimizers average the gradients over the ranks before the
clip; the path-length mean and the metrics are global means. `real_imgs`
is then the rank's rows, and `TrainConfig.batch` the global batch.
"""

from __future__ import annotations

import dataclasses
import sys

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.camera import CameraParams, sample_cameras
from ..kernels.siren_render import kernel_route_refusal
from ..models.diffaug import diff_augment, diffaug_draws
from ..models.generator import torch_dtype
from ..ops.resize import resize
from ..parallel.mesh import all_gather_batch, global_means, shard_batch
from .losses import (
    d_logistic_loss,
    eikonal_loss,
    g_nonsaturating_loss,
    minimal_surface_loss,
    path_length_penalty,
    path_noise,
    r1_penalty,
    viewpoint_loss,
)
from .state import TrainConfig, TrainState, check_config


def downsample_to(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """Real images (B, H, W, C) -> (B, size, size, C) thumbnails for the
    pose D: the lanczos3 resize of the JAX package (the reference uses a
    PIL-Lanczos conv, train_v10.py:65-74)."""
    return resize(imgs, (size, size), "lanczos3")


def sample_pixel_idx(generator, batch: int, cam_size: int, gen_size: int, mode: str,
                     device=None):
    """Per-sample ray-subset indices (train_v10.py:177-199): 'patch' is a
    random window, 'default' a sorted random subset without replacement.
    Returns (idx_h, idx_w), each (batch, gen_size) int64."""
    gdev = generator.device if generator is not None else "cpu"

    def one_axis():
        if mode == "patch":
            off = torch.randint(0, cam_size - gen_size + 1, (batch, 1),
                                generator=generator, device=gdev)
            return off + torch.arange(gen_size, device=gdev)[None]
        r = torch.rand((batch, cam_size), generator=generator, device=gdev)
        return torch.sort(torch.argsort(r, dim=1)[:, :gen_size], dim=1).values

    return one_axis().to(device), one_axis().to(device)


def gather_image_pixels(imgs, idx_h, idx_w, factor: int = 1):
    """Real pixels matching a generator ray subset: ray i of the camera grid
    owns the pixels [i*factor, (i+1)*factor) of the full image.
    imgs (B, cam*f, cam*f, C) -> (B, gen*f, gen*f, C)."""
    b, _, w, c = imgs.shape

    def expand(idx):
        px = idx[..., None] * factor + torch.arange(factor, device=idx.device)
        return px.reshape(b, -1)

    ph, pw = expand(idx_h), expand(idx_w)
    out = torch.gather(imgs, 1, ph[:, :, None, None].expand(-1, -1, w, c))
    return torch.gather(out, 2, pw[:, None, :, None].expand(-1, out.shape[1], -1, c))


@dataclasses.dataclass
class Draws:
    """The random inputs of one step. zs: two (B, z_dim) latents; cam: the
    sampled cameras; t_rand: (B, H, W, 1) perturbation offsets in [0, 1)
    (zeros give the unperturbed z-values); noise: the decoder's noise
    buffers, (B, h, w, 1) each; sample_idx: pixel sub-sampling indices;
    aug: diffaug draws by D pass ("fake", "real", "r1", "g"); path_noise:
    the path-length step's image-shaped noise, already / sqrt(H*W)."""

    zs: tuple
    cam: CameraParams
    t_rand: torch.Tensor
    noise: list | None = None
    sample_idx: tuple | None = None
    aug: dict | None = None
    path_noise: torch.Tensor | None = None


def draw_inputs(generator, batch, gen_cfg, cfg: TrainConfig, device, decoder=None,
                aug_passes=(), sample_idx=False) -> Draws:
    """The draws of one step from `generator` (on its own device), in this
    order: zs, camera, perturbation, pixel indices, noise buffers, diffaug."""
    gdev = generator.device if generator is not None else "cpu"
    zs = tuple(torch.randn((batch, gen_cfg.mapping.z_dim), generator=generator,
                           device=gdev).to(device) for _ in range(2))
    cam = sample_cameras(
        generator, batch, gen_cfg.img_size, azim_range=gen_cfg.azim_range,
        elev_range=gen_cfg.elev_range, fov_ang=gen_cfg.fov_ang,
        dist_radius=gen_cfg.dist_radius, uniform=gen_cfg.uniform_camera, device=device)
    size = gen_cfg.img_size
    t_rand = torch.rand((batch, size, size, 1), generator=generator,
                        device=gdev).to(device)
    idx = None
    if sample_idx:
        idx = sample_pixel_idx(generator, batch, cfg.cam_img_size, cfg.gen_img_size,
                               cfg.sample_mode, device)
        size = cfg.gen_img_size
    noise = (None if decoder is None
             else decoder.make_noise(generator, size, batch=batch, device=device))
    aug = None
    if aug_passes:
        out = size * 2 ** len(gen_cfg.decoder.upsample_list)
        aug = {p: diffaug_draws(generator, batch, out, out, device=device)
               for p in aug_passes}
    return Draws(zs, cam, t_rand, noise, idx, aug)


def shard_draws(draws: Draws, mesh) -> Draws:
    """The rank's rows of every batch-leading draw of the global batch."""
    if mesh is None:
        return draws

    def rows(x):
        if isinstance(x, torch.Tensor):
            return shard_batch(x, mesh)
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, CameraParams):
            return CameraParams(*map(rows, x))
        if isinstance(x, (list, tuple)):
            return type(x)(map(rows, x))
        return x

    return Draws(**{f.name: rows(getattr(draws, f.name)) for f in dataclasses.fields(draws)})


def _add(grads, more):
    """Elementwise sum of two gradient lists (None for an unused parameter)."""
    return [b if a is None else a if b is None else a + b for a, b in zip(grads, more)]


def make_train_steps(gen_cfg, cfg: TrainConfig, mesh=None):
    """(d_step, g_step, path_reg_step, sphere_init_step) for a generator of
    `gen_cfg` trained under `cfg`, data-parallel over `mesh` if given."""
    check_config(cfg)
    # pixel sub-sampling / patch training (train_v10.py:156-199, 339-353)
    sub_pixels = gen_cfg.enable_decoder and cfg.gen_img_size < cfg.cam_img_size
    if sub_pixels and cfg.cam_img_size != gen_cfg.img_size:
        raise ValueError("patch training expects cam_img_size == the generator's "
                         "NeRF resolution")
    up_factor = 2 ** len(gen_cfg.decoder.upsample_list)
    world = 1 if mesh is None else mesh.world
    d_dt = torch_dtype(cfg.d_dtype)
    # d_cat takes precedence over d_seq; both need the image D
    d_cat = cfg.d_cat and gen_cfg.enable_decoder
    d_seq = cfg.d_seq and gen_cfg.enable_decoder and not d_cat
    routes = {}

    def fused_route(flag: bool, step: str, device) -> bool:
        """K1 for this step's render when `flag` asks for it and K1 takes
        the renderer; decided once a device, said once when refused."""
        if not flag:
            return False
        key = (step, torch.device(device).type)
        if key not in routes:
            r = gen_cfg.renderer
            why = kernel_route_refusal(r.n_layers, r.hidden_dim, gen_cfg.n_samples,
                                       r.with_sdf, device)
            routes[key] = why is None
            if why is not None and (mesh is None or mesh.rank == 0):
                print(f"[train] the {step} step renders with the plain renderer, not K1: "
                      f"{why}", file=sys.stderr)
        return routes[key]

    def inputs(state, generator, batch, draws, aug_passes=(), decoder=True):
        """The draws of the global `batch` (given, or from `generator`),
        this rank's rows."""
        if draws is None:
            diffaug = getattr(state.d, "diffaug", False) and gen_cfg.enable_decoder
            draws = draw_inputs(
                generator, batch, gen_cfg, cfg, state.g.device,
                decoder=state.g.decoder if decoder and gen_cfg.enable_decoder else None,
                aug_passes=aug_passes if diffaug else (), sample_idx=sub_pixels)
        return shard_draws(draws, mesh)

    def g_forward(g, draws, eikonal_reg, renderer_detach, fused):
        cam = draws.cam
        return g(zs=draws.zs, cam_poses=cam.extrinsics, focals=cam.focal,
                 near=cam.near, far=cam.far, noise_bufs=draws.noise,
                 t_rand=draws.t_rand, eikonal_reg=eikonal_reg,
                 renderer_detach=renderer_detach, sample_idx=draws.sample_idx,
                 fused_renderer=fused)

    def remat(fn, *args):
        """fn(*args), its activations recomputed in the backward with remat_d."""
        if cfg.remat_d and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def image_d(d, x, alpha, aug=None, on=mesh):
        """The image D's logit in f32, computed in cfg.d_dtype: the input
        is cast at entry (cips3dpp_tpu/train/steps.py:144-152); `on` is the
        mesh its minibatch stddev gathers over."""
        return remat(lambda v: d(v.to(d_dt), alpha, aug=aug, mesh=on).float(), x)

    def r1_chunks(d, real, aug, alpha, chunk):
        """Lazy R1 of the image D over chunks of `chunk` rows of the global
        batch, the mean of the chunk means, each chunk's minibatch stddev
        over its own rows (cips3dpp_tpu/train/steps.py:346-380). Returns
        (value, gradients); one chunk of the whole batch is the plain
        penalty. Under a mesh with several chunks every rank gathers the
        batch and takes chunks rank, rank + world, ..., scaled by
        world / chunks, so the ranks' mean is the one-process value."""
        coef = cfg.lambda_gp * 0.5 * cfg.d_reg_every
        b = real.shape[0] * world
        if b % chunk:
            raise ValueError(f"d_r1_chunk {chunk} does not divide the batch {b}")
        nc = b // chunk
        pd = list(d.parameters())
        if nc == 1:
            parts, scale, on = [(real, aug)], 1.0, mesh
        else:
            if world > 1:
                with torch.no_grad():
                    real = all_gather_batch(real.detach(), mesh)
                    aug = None if aug is None else {k: all_gather_batch(v, mesh)
                                                    for k, v in aug.items()}
            rows = lambda x, i: x[i * chunk:(i + 1) * chunk]
            mine = range(mesh.rank if world > 1 else 0, nc, world)
            parts = [(rows(real, i), None if aug is None else
                      {k: rows(v, i) for k, v in aug.items()}) for i in mine]
            scale, on = world / nc, None
        value, grads = torch.zeros((), device=real.device), [None] * len(pd)
        for x, a in parts:
            x = x.detach().requires_grad_(True)
            v = coef * scale * r1_penalty(image_d(d, x, alpha, a, on=on), x)
            grads = _add(grads, torch.autograd.grad(v, pd, allow_unused=True))
            value = value + v.detach()
        return value, grads

    def d_step(state: TrainState, real_imgs, generator, alpha, d_regularize: bool,
               draws: Draws | None = None):
        """update_D (train_v10.py:136-241): the pose D (R1 every step, pose
        loss) and the image D (lazy R1 when d_regularize) on fakes of the
        current G."""
        batch = real_imgs.shape[0] * world
        draws = inputs(state, generator, batch, draws, ("fake", "real", "r1"))
        with torch.no_grad():
            ret = g_forward(state.g, draws, False, None,
                            fused_route(cfg.fused_renderer_d, "D", state.g.device))
        fake_rgb, fake_thumb = ret["rgb"], ret["thumb_rgb"]
        if draws.sample_idx is not None:
            real_imgs = gather_image_pixels(real_imgs, *draws.sample_idx, up_factor)
        real_thumb = downsample_to(real_imgs, fake_thumb.shape[1]).detach().requires_grad_(True)
        aug = draws.aug or {}
        zero = torch.zeros((), device=fake_thumb.device)
        # R1 in chunks (d_r1_chunk below the batch), or as one chunk after
        # the GAN passes when they are split (d_cat, d_seq)
        chunk = None
        if gen_cfg.enable_decoder and d_regularize:
            if cfg.d_r1_chunk is not None and cfg.d_r1_chunk < batch:
                chunk = cfg.d_r1_chunk
            elif d_cat or d_seq:
                chunk = batch

        fake_pred_r, fake_view = state.d_render(fake_thumb, alpha)
        real_pred_r, _ = state.d_render(real_thumb, alpha)
        d_gan_r = d_logistic_loss(real_pred_r, fake_pred_r)
        r1_r = cfg.lambda_gp * 0.5 * r1_penalty(real_pred_r, real_thumb)
        pose = (cfg.lambda_pose * viewpoint_loss(fake_view, draws.cam.viewpoint)
                if cfg.lambda_pose > 0 else zero)
        d_gan = r1_d = zero
        if not gen_cfg.enable_decoder:  # StyleSDF stage 1: no image D
            fake_pred = real_pred = torch.zeros((1, 1), device=zero.device)
        elif not (d_cat or d_seq):
            real = real_imgs.detach().requires_grad_(d_regularize and chunk is None)
            fake_pred = image_d(state.d, fake_rgb, alpha, aug.get("fake"))
            real_pred = image_d(state.d, real, alpha, aug.get("real"))
            d_gan = d_logistic_loss(real_pred, fake_pred)
            if d_regularize and chunk is None:
                # with diffaug the penalty sees its own augmentation; without,
                # its pass is the real pass itself (the same function)
                r1_pred = image_d(state.d, real, alpha, aug["r1"]) if aug else real_pred
                r1_d = cfg.lambda_gp * 0.5 * cfg.d_reg_every * r1_penalty(r1_pred, real)
        total = d_gan_r + r1_r + pose + d_gan + r1_d

        pd, pr = list(state.d.parameters()), list(state.d_render.parameters())
        grads = torch.autograd.grad(total, pd + pr, allow_unused=True)
        gd, gr = list(grads[:len(pd)]), grads[len(pd):]
        total = total.detach()
        if d_cat:
            bf = fake_rgb.shape[0]

            def cat_forward(fake, real):
                xf, xr = fake.to(d_dt), real.to(d_dt)
                if aug:  # each half with its pass's draws
                    xf, xr = diff_augment(xf, aug["fake"]), diff_augment(xr, aug["real"])
                return state.d(torch.cat([xf, xr]), alpha, stddev_split=bf,
                               skip_augment=True, mesh=mesh).float()

            pred = remat(cat_forward, fake_rgb, real_imgs.detach())
            fake_pred, real_pred = pred[:bf], pred[bf:]
            d_gan = F.softplus(fake_pred).mean() + F.softplus(-real_pred).mean()
            gd = _add(gd, torch.autograd.grad(d_gan, pd, allow_unused=True))
            total = total + d_gan.detach()
        elif d_seq:
            preds, vals = [], []
            for img, sign, a in ((fake_rgb, 1.0, aug.get("fake")),
                                 (real_imgs.detach(), -1.0, aug.get("real"))):
                pred = image_d(state.d, img, alpha, a)
                v = F.softplus(sign * pred).mean()
                gd = _add(gd, torch.autograd.grad(v, pd, allow_unused=True))
                preds.append(pred.detach())
                vals.append(v.detach())
            fake_pred, real_pred = preds
            d_gan = vals[0] + vals[1]
            total = total + d_gan
        if chunk is not None:
            r1_d, g1 = r1_chunks(state.d, real_imgs, aug.get("r1"), alpha, chunk)
            gd = _add(gd, g1)
            total = total + r1_d
        state.opt_d.step({"d": gd})
        state.opt_d_render.step({"d": gr})
        metrics = {
            "d_loss_gan_render": d_gan_r, "d_loss_r1_render": r1_r,
            "d_loss_pose_render": pose, "d_loss_gan_decoder": d_gan,
            "d_loss_gp_decoder": r1_d, "d_logits_real_decoder": real_pred.mean(),
            "d_logits_fake_decoder": fake_pred.mean(),
            "d_logits_real_render": real_pred_r.mean(),
            "d_logits_fake_render": fake_pred_r.mean(), "d_loss_total": total,
        }
        return state, global_means({k: v.detach() for k, v in metrics.items()}, mesh)

    def g_step(state: TrainState, generator, alpha, renderer_detach: bool | None = None,
               draws: Draws | None = None):
        """update_G (train_v10.py:303-405): GAN + pose + eikonal +
        minimal surface on the thumbnail, GAN on the image."""
        draws = inputs(state, generator, cfg.batch, draws, ("g",))
        ret = g_forward(state.g, draws, cfg.eikonal_reg, renderer_detach,
                        fused_route(cfg.fused_renderer_g, "G", state.g.device))
        zero = torch.zeros((), device=ret["rgb"].device)
        fake_pred_r, fake_view = state.d_render(ret["thumb_rgb"], alpha)
        g_gan_r = g_nonsaturating_loss(fake_pred_r)
        pose = (cfg.lambda_pose * viewpoint_loss(fake_view, draws.cam.viewpoint)
                if cfg.lambda_pose > 0 else zero)
        eik = (cfg.lambda_eikonal * eikonal_loss(ret["eikonal_term"])
               if cfg.lambda_eikonal > 0 and ret["eikonal_term"] is not None else zero)
        min_surf = (cfg.lambda_min_surf * minimal_surface_loss(ret["sdf"], cfg.min_surf_beta)
                    if cfg.lambda_min_surf > 0 and cfg.sdf_reg else zero)
        g_gan = zero
        if gen_cfg.enable_decoder:
            aug = (draws.aug or {}).get("g")
            g_gan = g_nonsaturating_loss(image_d(state.d, ret["rgb"], alpha, aug))
        total = g_gan_r + pose + eik + min_surf + g_gan

        groups = state.opt_g.groups
        n = len(groups["renderer"])
        grads = torch.autograd.grad(total, groups["renderer"] + groups["decoder"],
                                    allow_unused=True)
        state.opt_g.step({"renderer": grads[:n], "decoder": grads[n:]})
        state.step += 1
        metrics = {
            "g_loss_gan_render": g_gan_r, "g_loss_pose_render": pose,
            "g_loss_eikonal_render": eik, "g_loss_minimal_surface_render": min_surf,
            "g_loss_gan_decoder": g_gan, "g_loss_total": total,
        }
        return state, global_means({k: v.detach() for k, v in metrics.items()}, mesh)

    def path_reg_step(state: TrainState, generator, draws: Draws | None = None):
        """Path-length regularisation (train_v10.py:408-480) with respect to
        the decoder styles (cut from the mapping, model_v3.py:1334-1341);
        the renderer group's gradients are zero (the reference clips them
        to norm 0), so only the decoder group moves."""
        batch = max(1, cfg.batch // cfg.path_batch_shrink)
        draws = inputs(state, generator, batch, draws)
        g, cam = state.g, draws.cam
        sr, sd = g.map_zs(draws.zs)
        sd = sd.detach().requires_grad_(True)
        rgb = g(style_render=sr, style_decoder=sd, cam_poses=cam.extrinsics,
                focals=cam.focal, near=cam.near, far=cam.far, noise_bufs=draws.noise,
                t_rand=draws.t_rand)["rgb"]
        noise = draws.path_noise
        if noise is None:  # the global batch's, this rank's rows
            noise = shard_batch(path_noise(generator, rgb, batch=batch), mesh)
        (latents_grad,) = torch.autograd.grad((rgb * noise).sum(), sd, create_graph=True)
        penalty, new_mean, plens = path_length_penalty(rgb, latents_grad,
                                                       state.mean_path_length, mesh=mesh)
        weighted = cfg.path_regularize * cfg.g_reg_every * penalty
        groups = state.opt_g.groups
        grads = torch.autograd.grad(weighted, groups["decoder"], allow_unused=True)
        state.opt_g.step({"renderer": [torch.zeros_like(p) for p in groups["renderer"]],
                          "decoder": grads})
        state.mean_path_length = new_mean
        return state, global_means({"g_loss_weighted_path": weighted.detach(),
                                    "path_length_mean": plens.mean().detach()}, mesh)

    def sphere_init_step(state: TrainState, generator, draws: Draws | None = None):
        """SDF sphere initialisation (train_v10.py:595-668): L1 between the
        renderer's sdf and |pts| - (far - near)/4 at stratified samples of 4
        random cameras."""
        draws = inputs(state, generator, 4, draws, decoder=False)
        cam = draws.cam
        sdf, target = state.g.init_forward(draws.zs, cam.extrinsics, cam.focal,
                                           cam.near, cam.far)
        loss = (sdf - target).abs().mean()
        groups = state.opt_g.groups
        n = len(groups["renderer"])
        grads = torch.autograd.grad(loss, groups["renderer"] + groups["decoder"],
                                    allow_unused=True)
        state.opt_g.step({"renderer": grads[:n], "decoder": grads[n:]})
        return state, global_means({"sphere_init_l1": loss.detach()}, mesh)

    return d_step, g_step, path_reg_step, sphere_init_step


@torch.no_grad()
def ema_update(state: TrainState, decay: float) -> TrainState:
    """g_ema = decay * g_ema + (1 - decay) * g (cips3d/utils.py:63-79);
    decay is 0 before ema_start (train_v10.py:933-936)."""
    ema = list(state.g_ema.parameters())
    new = torch._foreach_add(torch._foreach_mul(ema, decay),
                             torch._foreach_mul(list(state.g.parameters()), 1.0 - decay))
    torch._foreach_copy_(ema, new)
    return state


def fade_alpha(step: int, fade_steps: int, fade: bool = True) -> float:
    """Progressive fade-in schedule (train_v10.py:895-898)."""
    if not fade:
        return 1.0
    return min(1.0, step / fade_steps)
