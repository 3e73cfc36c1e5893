"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: they skip on a host without a CUDA device (the CPU runs
only the plain versions, covered by the other test_torch_port_* files).
On a machine with the card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file does not use.)

The tolerances are those of the CPU parity tests for the same pair of
computations: same rounding points, different f32 summation order.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cips3dpp_torch.kernels.siren_render import plain_precision

    plain_precision()
    return torch.device("cuda", 0)


def test_siren_render_kernel_matches_plain(dev):
    """Full width, ragged ray count (not a multiple of the 4-ray tile)."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import (
        siren_prepare, siren_render_plain, siren_render_prepared,
    )
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(0)
    rend = init_parameters(VolumeFeatureRenderer(depth=2), gen).to(dev)
    r, s = 1001, 24
    styles = torch.randn((3, 256), generator=gen).to(dev)
    pts = (0.1 * torch.randn((r, s, 3), generator=gen)).to(dev)
    vd = torch.nn.functional.normalize(torch.randn((r, 3), generator=gen), dim=-1).to(dev)
    z = (torch.linspace(0.88, 1.12, s)[None] + 1e-3 * torch.randn((r, 1), generator=gen)).to(dev)
    rd = 1.05 * vd
    prep = siren_prepare(rend, styles, torch.tensor(0.88, device=dev),
                         torch.tensor(1.12, device=dev))
    before = _lib.LAUNCHES["siren_render"]
    got = siren_render_prepared(prep, pts, vd, z, rd)
    assert _lib.LAUNCHES["siren_render"] == before + 1
    want = siren_render_plain(prep, pts, vd, z, torch.linalg.norm(rd, dim=-1, keepdim=True))
    again = siren_render_prepared(prep, pts, vd, z, rd)
    torch.cuda.synchronize()
    atol = (1e-2, 6e-2, 1e-2, 1e-2, 1e-3)  # thumb, feat, sdf, mask_depth, xyz
    for g, w, g2, tol in zip(got, want, again, atol):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
        assert torch.equal(g, g2)  # fixed summation order: same bits every launch


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("frames", [1, 2])
def test_decoder_block_kernel_matches_plain(dev, c, frames):
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_packed, decoder_block_plain, decoder_block_prepare,
    )

    gen = torch.Generator().manual_seed(c + frames)
    hp, wp = 16, 32
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    prep = decoder_block_prepare(
        rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1), rnd(c, c) / c**0.5,
        0.1 * rnd(c), 0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5,
    )
    y1 = rnd(frames * hp, wp, c).to(torch.bfloat16)
    for emit_feat in (True, False):
        before = _lib.LAUNCHES["decoder_block"]
        got = decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat, frames=frames)
        assert _lib.LAUNCHES["decoder_block"] == before + 1
        want = decoder_block_plain(y1, prep, emit_feat, frames)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=1.6e-2, atol=2e-2)


def test_generator_fused_route_matches_render_frame(dev):
    """Generator.forward(fused_renderer=True, fused_decoder=True) at batch 1
    launches 1 K1 + one K2 per upsample block and gives the frame that
    prepare_trajectory + render_frame give: the same kernels on the same
    folded weights, so only f32 noise is allowed."""
    import dataclasses

    from cips3dpp_torch import serving
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.models.generator import Generator, preset_serving
    from cips3dpp_torch.models.layers import randomize_zero_init_

    base = preset_serving()  # SIREN width 256, 24 samples: K1's shape
    cfg = dataclasses.replace(
        base, img_size=16,
        decoder=dataclasses.replace(base.decoder, upsample_list=(128, 256)))
    model = Generator(cfg, device=dev, seed=3)
    randomize_zero_init_(model, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    zs = [torch.randn((1, 256), generator=gen).to(dev) for _ in range(2)]
    noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
    azim = torch.full((1,), 0.2, device=dev)
    elev = torch.full((1,), -0.1, device=dev)
    cam = camera_from_angles(azim, elev, cfg.img_size, fov_ang=cfg.fov_ang,
                             dist_radius=cfg.dist_radius)
    before = dict(_lib.LAUNCHES)
    with torch.no_grad():
        got = model(zs, cam.extrinsics, cam.focal, cam.near, cam.far,
                    noise_bufs=noise, fused_renderer=True, fused_decoder=True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["siren_render"] == before["siren_render"] + 1
    assert _lib.LAUNCHES["decoder_block"] == before["decoder_block"] + 2
    prep = serving.prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
    want = serving.render_frame(model, prep, azim, elev, device=dev)
    assert got["rgb"].shape == want["rgb"].shape == (1, 64, 64, 3)
    for k in ("rgb", "thumb_rgb"):
        assert torch.isfinite(got[k]).all()
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)
