"""CIPS-3D++ generator: mapping nets + SIREN volume renderer + CIPS decoder
(counterpart of cips3dpp_tpu/models/generator.py; contract
model_v3.py:808-1490).

The config dataclasses and presets are copies of the JAX package's, so the
same configuration builds either model. `Generator` owns its weights (an
nn.Module), drawn from `seed` at construction or loaded from a state dict
(`io/jax_params.py` converts a JAX param tree).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.rays import prepare_nerf_inputs
from ..device import resolve_device
from .decoder import Decoder
from .layers import EqualLinear, MappingLinear, PixelNorm, init_parameters
from .renderer import VolumeFeatureRenderer


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    n_layers: int = 2  # v10 r1024 flagship (train_cips3d_ffhq_v10.yaml:285)
    hidden_dim: int = 256
    input_dim: int = 3
    view_dim: int = 3
    with_sdf: bool = True
    dtype: str = "float32"  # SIREN storage dtype; "bfloat16" for serving
    remat: bool = False  # training option of the JAX package; unused here


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    z_dim: int = 256
    style_dim: int = 256
    n_layers: int = 3
    lr_mul: float = 1.0


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    size_start: int = 4
    size_end: int = 1024
    channel_multiplier: int = 2
    kernel_size: int = 1
    upsample_list: tuple = (128, 256, 512, 1024)
    style_dim: int = 512
    mapping_n_layers: int = 5
    mapping_lr_mul: float = 0.01
    dtype: str = "float32"  # conv compute dtype; "bfloat16" for serving
    skip_dtype: str = "float32"
    remat: bool = False  # training option of the JAX package; unused here


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    renderer: RendererConfig = RendererConfig()
    mapping: MappingConfig = MappingConfig()
    decoder: DecoderConfig = DecoderConfig()
    renderer_detach: bool = False
    freeze_renderer: bool = False
    enable_decoder: bool = True
    img_size: int = 64
    n_samples: int = 24
    static_viewdirs: bool = False
    fov_ang: float = 6.0
    dist_radius: float = 0.12
    azim_range: float = 0.3
    elev_range: float = 0.15
    uniform_camera: bool = False

    @property
    def out_size(self) -> int:
        return self.img_size * (2 ** len(self.decoder.upsample_list))


def preset_r1024():
    """Flagship FFHQ r1024 (config section train_r1024_r64_ks1)."""
    return GeneratorConfig()


def preset_r512():
    return dataclasses.replace(
        GeneratorConfig(),
        decoder=dataclasses.replace(
            DecoderConfig(), size_end=512, upsample_list=(128, 256, 512)
        ),
    )


def preset_r64():
    """Thumbnail-only model: deep renderer, no spatial upsample."""
    return dataclasses.replace(
        GeneratorConfig(),
        renderer=dataclasses.replace(RendererConfig(), n_layers=8),
        decoder=dataclasses.replace(DecoderConfig(), upsample_list=()),
    )


def preset_serving():
    """Flagship r1024 in bf16 serving mode: SIREN storage + decoder compute
    in bf16 (phase math, integration and the RGB skip stay f32)."""
    return dataclasses.replace(
        GeneratorConfig(),
        renderer=dataclasses.replace(RendererConfig(), dtype="bfloat16"),
        decoder=dataclasses.replace(DecoderConfig(), dtype="bfloat16"),
    )


def preset_compcars():
    """CompCars: 360deg azimuth, wider fov (train_cips3d_compcars_v10.yaml:97-107)."""
    import math

    return dataclasses.replace(
        GeneratorConfig(), azim_range=math.pi, elev_range=0.15, fov_ang=15.0,
        dist_radius=0.3, uniform_camera=True,
    )


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Generator(nn.Module):
    """Weights are drawn from `seed` on the CPU (the same weights on every
    device), then moved to `device` (default: the card)."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(), device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        m = c.mapping
        self.style = nn.Sequential(*[
            MappingLinear(m.z_dim if i == 0 else m.style_dim, m.style_dim,
                          activation="fused_lrelu")
            for i in range(m.n_layers)
        ])
        d = c.decoder
        self.style_decoder = nn.Sequential(PixelNorm(), *[
            EqualLinear(m.z_dim if i == 0 else d.style_dim, d.style_dim,
                        lr_mul=d.mapping_lr_mul, activation="fused_lrelu")
            for i in range(d.mapping_n_layers)
        ])
        r = c.renderer
        self.renderer = VolumeFeatureRenderer(
            r.n_layers, r.hidden_dim, r.input_dim, r.view_dim, m.style_dim,
            r.with_sdf, torch_dtype(r.dtype),
        )
        self.decoder = Decoder(
            d.size_start, d.size_end, r.hidden_dim, d.style_dim,
            d.channel_multiplier, d.upsample_list, torch_dtype(d.dtype),
            torch_dtype(d.skip_dtype),
        )
        gen = torch.Generator().manual_seed(seed)
        init_parameters(self, gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.renderer.sigmoid_beta.device

    # ----- mapping networks ------------------------------------------------

    def mapping_renderer_w(self, z):
        return self.style(z)

    def mapping_decoder_w(self, z):
        return self.style_decoder(z)

    @torch.no_grad()
    def mean_latents(self, generator: torch.Generator | None = None, n: int = 10_000):
        """Mean w's over n random z's drawn from `generator` (model_v3.py:
        1285-1297). Compute once and pass to map_zs."""
        zd = self.cfg.mapping.z_dim
        z1 = torch.randn((n, zd), generator=generator).to(self.device)
        z2 = torch.randn((n, zd), generator=generator).to(self.device)
        return (self.mapping_renderer_w(z1).mean(0, keepdim=True),
                self.mapping_decoder_w(z2).mean(0, keepdim=True))

    def map_zs(self, zs, truncation=1.0, mean_latents=None, inject_index=None):
        """zs = (z_render, z_decoder[, z_decoder_2]) -> per-layer styles
        (style_render (B, L+1, D), style_decoder (B, n_latent, D'))."""
        w_render = self.mapping_renderer_w(zs[0])
        w_decs = [self.mapping_decoder_w(z) for z in zs[1:]]
        if mean_latents is not None:
            wr_mean, wd_mean = mean_latents
            w_render = wr_mean + truncation * (w_render - wr_mean)
            w_decs = [wd_mean + truncation * (w - wd_mean) for w in w_decs]
        n_render = self.cfg.renderer.n_layers + 1
        n_latent = self.decoder.n_latent
        style_render = w_render[:, None, :].repeat(1, n_render, 1)
        if len(w_decs) == 1:
            return style_render, w_decs[0][:, None, :].repeat(1, n_latent, 1)
        if inject_index is None:
            inject_index = n_latent  # model_v3.py:1369-1371
        if not 0 < inject_index <= n_latent:
            raise ValueError(f"inject_index {inject_index} not in (0, {n_latent}]")
        s1 = w_decs[0][:, None, :].repeat(1, inject_index, 1)
        s2 = w_decs[1][:, None, :].repeat(1, n_latent - inject_index, 1)
        return style_render, torch.cat([s1, s2], dim=1)

    # ----- forward ---------------------------------------------------------

    def forward(
        self,
        zs=None,
        cam_poses=None,  # (B, 3, 4)
        focals=None,  # (B, 1, 1)
        near=None,
        far=None,
        img_size: int | None = None,
        truncation: float = 1.0,
        mean_latents=None,
        style_render=None,
        style_decoder=None,
        noise_bufs=None,  # list[num_layers] or None -> drawn from `generator`
        perturb: bool = False,
        ray_chunk: int | None = None,  # plain renderer: rays per tile
        fused_renderer: bool = False,  # SIREN render kernel
        fused_decoder: bool = False,  # decoder block kernels (batch 1)
        inject_index: int | None = None,
        generator: torch.Generator | None = None,  # perturb + noise draws
        noise_seed: int | None = None,  # uint32: the hash noise realization
        # of that seed instead of drawn buffers (made in the block kernels
        # with fused_decoder); explicit noise_bufs take priority
    ):
        c = self.cfg
        img_size = img_size or c.img_size
        if fused_decoder and c.enable_decoder and cam_poses.shape[0] != 1:
            raise ValueError(f"fused_decoder=True: the decoder block kernels "
                             f"serve batch 1, got batch {cam_poses.shape[0]}")
        if style_render is None or style_decoder is None:
            style_render, style_decoder = self.map_zs(
                zs, truncation, mean_latents, inject_index
            )
        pts, rays_d, viewdirs, z_vals = prepare_nerf_inputs(
            focals, img_size, cam_poses, near, far, c.n_samples,
            perturb=perturb, static_viewdirs=c.static_viewdirs,
            generator=generator,
        )
        b, h, w, n, _ = pts.shape
        flat = lambda a: a.reshape(b, h * w, *a.shape[3:])
        thumb, features, sdf, mask_depth, xyz, _ = self.renderer(
            flat(pts), flat(rays_d), flat(viewdirs), flat(z_vals), near, far,
            style_render, fused=fused_renderer, ray_chunk=ray_chunk,
        )
        thumb = thumb.reshape(b, h, w, 3)
        features = features.reshape(b, h, w, -1)
        if c.enable_decoder:
            if noise_bufs is None and noise_seed is None:
                noise_bufs = self.decoder.make_noise(
                    generator, features.shape[1], device=features.device)
            if fused_decoder:
                from ..kernels.decoder_fused import decoder_fused_apply

                rgb = decoder_fused_apply(
                    self.decoder, features, style_decoder, noise_bufs,
                    fold_rgb=True, noise_seed=noise_seed,
                )
            else:
                if noise_bufs is None:
                    noise_bufs = self.decoder.hash_noise(
                        noise_seed, features.shape[1], device=features.device)
                rgb = self.decoder(features, style_decoder, noise_bufs)
        else:
            rgb = thumb
        return {
            "rgb": rgb,
            "thumb_rgb": thumb,
            "sdf": sdf.reshape(b, h, w, n, 1),
            "mask": mask_depth[..., 0].reshape(b, h, w, 1),
            "depth": mask_depth[..., 1].reshape(b, h, w, 1),
            "xyz": xyz.reshape(b, h, w, 3),
        }
