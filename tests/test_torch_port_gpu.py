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


# (storage, noise): the serving mode (bf16, buffers), the f32 decoder
# config's mode, and hash noise made in the kernel in either storage
MODES = [("bf16", "buffers"), ("f32", "buffers"), ("bf16", "hash"), ("f32", "hash")]


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("frames", [1, 2])
def test_decoder_block_kernel_matches_plain(dev, c, frames, mode):
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_packed, decoder_block_plain, decoder_block_prepare, launch_name,
    )

    gen = torch.Generator().manual_seed(c + frames)
    hp, wp = 16, 32
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[mode[0]]
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    prep = decoder_block_prepare(
        rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1), rnd(c, c) / c**0.5,
        0.1 * rnd(c), 0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5, dtype=dt,
        noise_seeds=(123, 456) if mode[1] == "hash" else None,
    )
    y1 = rnd(frames * hp, wp, c).to(dt)
    name = launch_name(prep)
    assert name == {("bf16", "buffers"): "decoder_block", ("f32", "buffers"): "decoder_block_f32",
                    ("bf16", "hash"): "decoder_block_hash",
                    ("f32", "hash"): "decoder_block_hash_f32"}[mode]
    for emit_feat in (True, False):
        before = dict(_lib.LAUNCHES)
        got = decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat, frames=frames)
        assert _lib.LAUNCHES[name] == before.get(name, 0) + 1
        assert sum(_lib.LAUNCHES.values()) == sum(before.values()) + 1
        want = decoder_block_plain(y1, prep, emit_feat, frames)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            # bf16: a flip of a stored feature is one bf16 ulp; f32: nothing
            # is stored in bf16 and conv_b's bf16 operands are rounded from
            # the same f32 values, so only f32 sum orders differ, and 1e-3
            # lies under one bf16 ulp of a stored feature
            tol = (dict(rtol=0, atol=1e-3) if dt == torch.float32
                   else dict(rtol=1.6e-2, atol=2e-2))
            torch.testing.assert_close(g.float(), w.float(), **tol)


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


def test_hash_noise_in_kernel_matches_its_map(dev):
    """The kernel's hash noise is hash_noise_map's realization: the f32
    block fed the map as buffers gives what the seeds give."""
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_packed, decoder_block_prepare, hash_noise_map,
    )

    gen = torch.Generator().manual_seed(7)
    c, hp, wp = 64, 16, 32
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    w2, b1, b2, wrgb = rnd(c, c) / c**0.5, 0.1 * rnd(c), 0.1 * rnd(c), rnd(c, 3) / c**0.5
    maps = [hash_noise_map(2 * hp, 2 * wp, s, dev) for s in (11, 22)]
    y1 = rnd(2 * hp, wp, c)
    kw = dict(dtype=torch.float32)
    by_seed = decoder_block_packed(
        y1, frames=2, prepared=decoder_block_prepare(
            None, None, w2, b1, b2, 0.3, -0.2, wrgb, noise_seeds=(11, 22), **kw))
    by_map = decoder_block_packed(
        y1, frames=2, prepared=decoder_block_prepare(
            maps[0], maps[1], w2, b1, b2, 0.3, -0.2, wrgb, **kw))
    torch.cuda.synchronize()
    for g, w in zip(by_seed, by_map):
        torch.testing.assert_close(g, w, rtol=0, atol=5e-3)


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_decoder_block_fused_kernel_matches_plain(dev, c):
    """K3, the v1 block: f32 in and out, bias and upsampled-skip epilogue."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_fused, decoder_block_fused_plain,
    )

    gen = torch.Generator().manual_seed(100 + c)
    hp, wp = 32, 16
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    args = (rnd(hp, wp, c), rnd(hp, wp, 3), rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1),
            rnd(c, c) / c**0.5, rnd(c, 3) / c**0.5, 0.1 * rnd(c), 0.1 * rnd(c),
            0.1 * rnd(3), 0.3, 0.2)
    before = _lib.LAUNCHES["decoder_block_fused"]
    got = decoder_block_fused(*args)
    assert _lib.LAUNCHES["decoder_block_fused"] == before + 1
    want = decoder_block_fused_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
    # feat: f32, as K2's f32 mode; rgb multiplies bf16(feat), which flips a
    # bf16 ulp where feat differs in its last f32 bits
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=1.6e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elem_probe_kernel_is_bit_equal_to_plain(dev, dtype):
    """P1: every product and sum rounded alone, in the plain chain's order."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.tools.elem_dtype_probe import SHAPE, elem_chain, elem_chain_plain

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(SHAPE, generator=gen).to(dev, dtype)
    n = torch.randn(SHAPE, generator=gen).to(dev, dtype)
    name = "elem_probe_bf16" if dtype == torch.bfloat16 else "elem_probe_f32"
    before = _lib.LAUNCHES[name]
    got = elem_chain(x, n)
    assert _lib.LAUNCHES[name] == before + 1
    want = elem_chain_plain(x, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


def test_f32_fused_trajectory_with_hash_noise(dev):
    """The f32-decoder config through render_trajectory(fused=True,
    noise_seed=...): one K1 and one f32 hash-mode K2 per upsample block a
    frame, and the frames the same seed's hash_noise_map buffers give
    through the f32 buffer-mode kernel."""
    import dataclasses

    from cips3dpp_torch.apps.sample import render_trajectory, yaw_trajectory
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.models.generator import Generator, preset_r1024
    from cips3dpp_torch.models.layers import randomize_zero_init_

    base = preset_r1024()  # f32 decoder storage
    cfg = dataclasses.replace(
        base, img_size=16,
        decoder=dataclasses.replace(base.decoder, upsample_list=(128, 256)))
    model = Generator(cfg, device=dev, seed=8)
    randomize_zero_init_(model, torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(9)
    zs = [torch.randn((1, 256), generator=gen).to(dev) for _ in range(2)]
    cams = yaw_trajectory(2, cfg.img_size, device=dev)
    _lib.reset_launches()
    by_seed = render_trajectory(model, zs, cams, fused=True, noise_seed=31)
    assert dict(_lib.LAUNCHES) == {"siren_render": 2, "decoder_block_hash_f32": 4}
    bufs = model.decoder.hash_noise(31, cfg.img_size, device=dev)
    by_bufs = render_trajectory(model, zs, cams, fused=True, noise_bufs=bufs)
    assert _lib.LAUNCHES["decoder_block_f32"] == 4
    assert by_seed["rgb"].shape == (2, 64, 64, 3)
    assert torch.isfinite(torch.from_numpy(by_seed["rgb"])).all()
    # the same realization: tests/test_kernels.py:387's bound
    torch.testing.assert_close(torch.from_numpy(by_seed["rgb"]),
                               torch.from_numpy(by_bufs["rgb"]), rtol=0, atol=1e-2)
