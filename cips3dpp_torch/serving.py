"""Trajectory serving: prepare once per identity, render per frame
(counterpart of cips3dpp_tpu/serving.py).

The reference's multi-view app computes the w latents once per video and
re-renders only the camera-dependent half per frame
(render_video_web_v10.py:1695-1824, noise buffers fixed at :1792).
`prepare_trajectory` folds everything that depends only on (weights, zs,
noise): mapping MLPs, FiLM folds, modulated conv weights, noise casts.
`render_frame` consumes that with a camera: rays -> SIREN render kernel
-> decoder with one kernel per upsample block.

Every entry point runs on the card unless `device="cpu"` is passed; the
model must already live on that device.
"""

from __future__ import annotations

import torch

from .core.camera import camera_from_angles
from .core.rays import prepare_nerf_inputs
from .device import check_on, resolve_device
from .kernels.decoder_fused import decoder_fused_prepare, decoder_fused_render
from .kernels.siren_render import siren_prepare, siren_render_prepared


def _device_for(model, device) -> torch.device:
    dev = resolve_device(device)
    check_on(model.renderer.sigmoid_beta, dev, "model")
    return dev


@torch.no_grad()
def prepare_trajectory(
    model,  # models.generator.Generator (depth-2 renderer)
    zs,  # (z_render, z_decoder[, z_decoder_2]), each (1, z_dim)
    *,
    noise_bufs=None,  # fixed per trajectory: list of num_layers (1, h, w, 1)
    noise_seed=None,  # or a uint32: hash noise, made in the block kernels
    # (layer i takes hash_noise_map of layer_seed(noise_seed, i)); one of
    # the two is required and the buffers win
    truncation: float = 1.0,
    mean_latents=None,
    inject_index=None,
    fold_rgb: bool = True,  # fold ToRGB into the block kernels; pass the
    # same value to render_frame
    near=None,  # the trajectory's depth range (scalars); default that of
    far=None,  # the config's camera
    device=None,
):
    """Trajectory-invariant state for `render_frame` / `render_camera`."""
    dev = _device_for(model, device)
    if noise_bufs is None and noise_seed is None:
        raise ValueError("serving trajectories use fixed noise: pass noise_bufs "
                         "or noise_seed")
    cfg = model.cfg
    style_render, style_decoder = model.map_zs(
        zs, truncation, mean_latents, inject_index
    )
    if style_render.shape[0] != 1:
        raise ValueError("batch-1 serving path: one identity per trajectory")
    # near/far depend on dist_radius alone, so the SIREN scale fold is
    # trajectory-invariant
    if near is None or far is None:
        zero = torch.zeros((1,), device=dev)
        cam0 = camera_from_angles(zero, zero, cfg.img_size, fov_ang=cfg.fov_ang,
                                  dist_radius=cfg.dist_radius)
        near, far = cam0.near, cam0.far
    return {
        "siren": siren_prepare(model.renderer, style_render[0],
                               near.reshape(-1)[0], far.reshape(-1)[0]),
        "dec": decoder_fused_prepare(
            model.decoder, style_decoder, noise_bufs, fold_rgb=fold_rgb,
            noise_seed=noise_seed, feat_size=cfg.img_size),
    }


@torch.no_grad()
def render_frame(model, prep, azim, elev, *, img_size: int | None = None,
                 fold_rgb: bool = True, device=None):
    """F frames of the prepared identity from camera angles azim/elev (F,),
    through one launch of each kernel. Returns {"rgb": (F, out, out, 3),
    "thumb_rgb": (F, img, img, 3), "depth": (F, img, img, 1),
    "xyz": (F, img, img, 3)}."""
    cfg = model.cfg
    img_size = img_size or cfg.img_size
    cam = camera_from_angles(azim, elev, img_size, fov_ang=cfg.fov_ang,
                             dist_radius=cfg.dist_radius)
    return render_camera(model, prep, cam, img_size=img_size, fold_rgb=fold_rgb,
                         device=device)


@torch.no_grad()
def render_camera(model, prep, cam, *, img_size: int | None = None,
                  fold_rgb: bool = True, device=None):
    """`render_frame` from F cameras (core.camera.CameraParams) whose depth
    range is the prepared one."""
    _device_for(model, device)
    cfg = model.cfg
    img_size = img_size or cfg.img_size
    pts, rays_d, viewdirs, z_vals = prepare_nerf_inputs(
        cam.focal, img_size, cam.extrinsics, cam.near, cam.far, cfg.n_samples,
        perturb=False, static_viewdirs=cfg.static_viewdirs,
    )
    b, h, w, _, _ = pts.shape
    flat = lambda a: a.reshape(b * h * w, *a.shape[3:])
    thumb, feat, _, maskd, xyz = siren_render_prepared(
        prep["siren"], flat(pts), flat(viewdirs), flat(z_vals), flat(rays_d)
    )
    rgb = decoder_fused_render(model.decoder, prep["dec"],
                               feat.reshape(b, h, w, -1), fold_rgb=fold_rgb)
    return {"rgb": rgb, "thumb_rgb": thumb.reshape(b, h, w, 3),
            "depth": maskd[:, 1].reshape(b, h, w, 1), "xyz": xyz.reshape(b, h, w, 3)}


@torch.no_grad()
def render_trajectory_scan(model, prep, yaws, elev=None, *, fold_rgb=True,
                           frames_per_step: int = 1, device=None):
    """All frames of a trajectory in a loop of `render_frame` calls of
    `frames_per_step` frames each; returns the checksum sum over frames of
    each frame's mean rgb (the JAX package's scan returns the same)."""
    _device_for(model, device)
    if elev is None:
        elev = torch.zeros_like(yaws)
    fps_ = frames_per_step
    if yaws.shape[0] % fps_:
        raise ValueError(f"{yaws.shape[0]} yaws do not split into steps of {fps_}")
    checksum = torch.zeros((), device=yaws.device)
    for az, el in zip(yaws.reshape(-1, fps_), elev.reshape(-1, fps_)):
        out = render_frame(model, prep, az, el, fold_rgb=fold_rgb, device=device)
        checksum = checksum + out["rgb"].float().mean(dim=(1, 2, 3)).sum()
    return checksum
