"""The serving cells' reference frames: the plain generator of
`plain/models/generator.py` in f32, from the inputs the harness handed
the program: the weights of the seed's pool, the same mean-latent z's,
each checked request's z's and noise buffers and camera angles. It
recomputes everything the program's `prepare_trajectory` folds (mapping,
truncation, FiLM and modulated weights) and renders each frame through
the plain camera, rays, SIREN renderer with SDF integration and decoder."""

from __future__ import annotations

import torch

from .plain.core.camera import camera_from_angles
from .plain.models import generator as G
from .precision import f32_no_tf32, to_fp8


def generator_config(model: dict, dtype: str | None = None, module=G):
    """A GeneratorConfig of `module` (the reference's or the program's
    generator module: their configs are copies) from a config file's
    "model"; `dtype` replaces the renderer's and decoder's dtypes."""
    r, d = dict(model["renderer"]), dict(model["decoder"])
    if dtype is not None:
        r["dtype"] = d["dtype"] = dtype
    d["upsample_list"] = tuple(d["upsample_list"])
    top = {k: v for k, v in model.items() if k not in ("renderer", "mapping", "decoder")}
    return module.GeneratorConfig(renderer=module.RendererConfig(**r),
                                  mapping=module.MappingConfig(**model["mapping"]),
                                  decoder=module.DecoderConfig(**d), **top)


def build(model: dict, device, weights_fn, precision: str = "float32"):
    """The reference generator in f32 with weights from `weights_fn(modules)`;
    precision "fp8" is the control (`precision.to_fp8`)."""
    f32_no_tf32()
    g = G.Generator(generator_config(model, "float32"), device=device, seed=None)
    weights_fn([g])
    g.requires_grad_(False)
    if precision == "fp8":
        to_fp8(g)
    elif precision != "float32":
        raise ValueError(f"reference precision {precision!r}: float32 or fp8")
    return g


@torch.no_grad()
def mean_latents(g, z_render, z_decoder):
    return (g.mapping_renderer_w(z_render).mean(0, keepdim=True),
            g.mapping_decoder_w(z_decoder).mean(0, keepdim=True))


@torch.no_grad()
def frames(g, zs, noise, azim, elev, truncation, means, block: int):
    """Frames at camera angles azim / elev (F,) of one identity (zs, each
    (1, z_dim); noise (1, h, w, 1) buffers), `block` frames a pass.
    Yields (rgb (b, out, out, 3), thumb (b, img, img, 3)) f32 per block."""
    cfg = g.cfg
    for i in range(0, azim.shape[0], block):
        az, el = azim[i:i + block], elev[i:i + block]
        b = az.shape[0]
        cam = camera_from_angles(az, el, cfg.img_size, fov_ang=cfg.fov_ang,
                                 dist_radius=cfg.dist_radius)
        out = g(zs=[z.expand(b, -1) for z in zs], cam_poses=cam.extrinsics,
                focals=cam.focal, near=cam.near, far=cam.far, truncation=truncation,
                mean_latents=means, noise_bufs=noise, perturb=False)
        yield out["rgb"].float(), out["thumb_rgb"].float()


def frame_errors(rgb, thumb, ref_rgb, ref_thumb):
    """Per frame: the mean absolute gap of the image and of the thumbnail."""
    e_rgb = (rgb.float() - ref_rgb).abs().mean(dim=(1, 2, 3))
    e_thumb = (thumb.float() - ref_thumb).abs().mean(dim=(1, 2, 3))
    return e_rgb.tolist(), e_thumb.tolist()


