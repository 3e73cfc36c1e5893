"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: they skip on a host without a CUDA device (the CPU runs
only the plain versions, covered by the other test_torch_port_* files).
On a machine with the card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file does not use.)

The tolerances are those of the CPU parity tests for the same pair of
computations: same rounding points, different f32 summation order. K1's
are tighter, set from its readings on the card.
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


# 1001 = 8*125 + 1 is ragged against the 8-ray tile, 5 is less than one
# tile, and 64*64 is the serving shape, where the tiles outnumber the SMs
@pytest.mark.parametrize("r", [1001, 5, 4096])
def test_siren_render_kernel_matches_plain(dev, r):
    """Full width, 24 samples a ray, at R rays."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import (
        siren_prepare, siren_render_plain, siren_render_prepared,
    )
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(0)
    rend = init_parameters(VolumeFeatureRenderer(depth=2), gen).to(dev)
    s = 24
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
    # only f32 sum orders differ: the bounds sit 10x (feat) to 90x (xyz)
    # above the largest readings on the H100 (PERF.md section 6)
    atol = {"thumb": 1e-3, "feat": 5e-3, "sdf": 1e-3, "mask_depth": 1e-4, "xyz": 1e-4}
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(atol, got, want)}
    print(f"R={r}: max |kernel - plain| {errs}")
    for g, w, g2, tol in zip(got, want, again, atol.values()):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
        assert torch.equal(g, g2)  # fixed summation order: same bits every launch


def test_siren_phase_split_counts_every_phase(dev):
    """The instrumented K1 build computes what the plain build computes
    (checked inside `measure`) and counts cycles in every phase."""
    from cips3dpp_torch.tools.siren_phase_split import PHASES, measure

    out = measure(64, 2, dev)
    assert list(out["share"]) == list(PHASES)
    assert all(v > 0 for v in out["share"].values())
    assert abs(sum(out["share"].values()) - 1.0) < 1e-9
    assert out["ms"] > 0 and out["instrumented_ms"] > 0


# (storage, noise): the serving mode (bf16, buffers), the f32 decoder
# config's mode, and hash noise made in the kernel in either storage
MODES = [("bf16", "buffers"), ("f32", "buffers"), ("bf16", "hash"), ("f32", "hash")]
# y1 (F*Hp, Wp) by name: the first two as before; Wp = 48 is ragged against
# the tile width at C = 32 and 64 (64 and 32 input columns) with F = 3;
# Hp = 1 puts every row at a frame edge; "large" gives every persistent
# block several tiles, so the staging ring wraps
SHAPES = {"16x32": (16, 32, 1), "16x32-f2": (16, 32, 2), "ragged-f3": (8, 48, 3),
          "hp1-f2": (1, 32, 2), "large-f2": None}


def _block_shape(name, c):
    if name == "large-f2":
        return (256, 256, 2) if c <= 64 else (128, 128, 2)
    return SHAPES[name]


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_decoder_block_kernel_matches_plain(dev, c, shape, mode):
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_packed, decoder_block_plain, decoder_block_prepare, launch_name,
    )

    hp, wp, frames = _block_shape(shape, c)
    gen = torch.Generator().manual_seed(c + frames + hp)
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
        before = _lib.LAUNCHES.copy()  # a Counter: 0 for a kernel not launched yet
        got = decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat, frames=frames)
        assert _lib.LAUNCHES[name] == before.get(name, 0) + 1
        assert sum(_lib.LAUNCHES.values()) == sum(before.values()) + 1
        again = decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat, frames=frames)
        want = decoder_block_plain(y1, prep, emit_feat, frames)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        for g, a, w in zip(got, again, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, a)  # fixed summation order: same bits every launch
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
    before = _lib.LAUNCHES.copy()  # a Counter: 0 for a kernel not launched yet
    with torch.no_grad():
        got = model(zs, cam.extrinsics, cam.focal, cam.near, cam.far,
                    noise_bufs=noise, perturb=False, fused_renderer=True,
                    fused_decoder=True)
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


# K3 takes one frame: the same shapes as K2's, F = 1
K3_SHAPES = {"32x16": (32, 16), "ragged": (8, 48), "hp1": (1, 32), "large": None}


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_decoder_block_fused_kernel_matches_plain(dev, c, shape):
    """K3, the v1 block: f32 in and out, bias and upsampled-skip epilogue."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_fused, decoder_block_fused_plain,
    )

    hp, wp = K3_SHAPES[shape] or ((256, 256) if c <= 64 else (128, 128))
    gen = torch.Generator().manual_seed(100 + c + hp)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    args = (rnd(hp, wp, c), rnd(hp, wp, 3), rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1),
            rnd(c, c) / c**0.5, rnd(c, 3) / c**0.5, 0.1 * rnd(c), 0.1 * rnd(c),
            0.1 * rnd(3), 0.3, 0.2)
    before = _lib.LAUNCHES["decoder_block_fused"]
    got = decoder_block_fused(*args)
    assert _lib.LAUNCHES["decoder_block_fused"] == before + 1
    again = decoder_block_fused(*args)
    want = decoder_block_fused_plain(*args)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert torch.equal(g, a)
    # feat: f32, as K2's f32 mode; rgb multiplies bf16(feat), which flips a
    # bf16 ulp where feat differs in its last f32 bits
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=1.6e-2, atol=2e-2)


def test_decoder_block_phase_split_counts_every_phase(dev):
    """The instrumented K2 build computes what the plain build computes and
    counts cycles in every phase; at y1 (256, 256, 64) every block walks
    several tiles. (The tool's timings are not taken here.)"""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.tools.decoder_block_phase_split import (
        DEFINES, PHASES, block_inputs, phase_cycles,
    )

    prep, y1 = block_inputs(256, 64, torch.bfloat16, False, dev)
    want = kdb.decoder_block_packed(y1, prepared=prep)
    phase_cycles(reset=True)
    got = kdb._launch(y1, prep, True, 1, DEFINES)
    torch.cuda.synchronize()
    cycles = phase_cycles(reset=False)
    print(dict(zip(PHASES, cycles)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(cycles) == len(PHASES) and all(c > 0 for c in cycles)


def test_decoder_block_resources(dev):
    """Every K2 / K3 instantiation fits on the card with no spill, and tiles
    hold 8192 values at every C."""
    from cips3dpp_torch.kernels.decoder_block import KERNEL_CHANNELS, decoder_block_info

    for dt, hashed, k3 in ((torch.bfloat16, False, False), (torch.bfloat16, True, False),
                           (torch.float32, False, False), (torch.float32, True, False),
                           (torch.float32, False, True)):
        for c in KERNEL_CHANNELS:
            info = decoder_block_info(c, dt, hashed, k3)
            print(dt, hashed, k3, c, info)
            assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
            assert info["smem_bytes"] <= 232448
            assert info["tile_pixels"] * c == 8192
            assert info["tile_input_columns"] * 4 == info["tile_pixels"]


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


# the serving shape and one ragged against the 8-ray tile
@pytest.mark.parametrize("r", [4096, 1001])
def test_siren_render_gradients_kernel_forward(dev, r):
    """SirenRender on the card: K1's forward (one launch, its outputs) and
    the replayed backward, whose gradients with respect to styles, pts and
    every renderer parameter equal autograd's through the replayed
    function (the same arithmetic on the same inputs)."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import (
        SirenRender, siren_prepare, siren_render_prepared, siren_render_reference,
    )
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(1)
    rend = init_parameters(VolumeFeatureRenderer(depth=2), gen).to(dev)
    s = 24
    styles = torch.randn((3, 256), generator=gen).to(dev).requires_grad_(True)
    pts = (0.1 * torch.randn((r, s, 3), generator=gen)).to(dev).requires_grad_(True)
    vd = torch.nn.functional.normalize(torch.randn((r, 3), generator=gen), dim=-1).to(dev)
    z = (torch.linspace(0.88, 1.12, s)[None] + 1e-3 * torch.randn((r, 1), generator=gen)).to(dev)
    rd = 1.05 * vd
    near, far = torch.tensor(0.88, device=dev), torch.tensor(1.12, device=dev)
    params = list(rend.parameters())
    before = _lib.LAUNCHES["siren_render"]
    outs = SirenRender.apply(rend, styles, pts, vd, z, rd, near, far, *params)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["siren_render"] == before + 1
    with torch.no_grad():
        kernel = siren_render_prepared(siren_prepare(rend, styles, near, far), pts, vd, z, rd)
    for o, k in zip(outs, kernel):
        assert torch.equal(o, k)  # K1 sums in a fixed order
    cots = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
    got = torch.autograd.grad(outs, [styles, pts] + params, cots)
    want = torch.autograd.grad(siren_render_reference(rend, styles, pts, vd, z, rd, near, far),
                               [styles, pts] + params, cots)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


def test_siren_render_camera_gradients_batch2(dev):
    """The projector's camera path: VolumeFeatureRenderer.forward(fused=
    True) at batch 2, width 256, R = 4096 rays x 24 samples, with pts,
    rays_d (viewdirs are its normalisation), z_vals and the styles as
    leaves. K1 launches once per item; the gradients equal autograd's
    through the replayed function (siren_render_reference, the same bf16
    products; 1e-5 of each gradient's largest value) and agree with
    autograd through the plain f32 renderer (bf16 products against f32
    ones: cosine above 0.99, max error within 0.25 of the largest value,
    chip_smoke.py phase 7's bounds)."""
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.core.rays import prepare_nerf_inputs
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import siren_render_reference
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(7)
    rend = init_parameters(VolumeFeatureRenderer(depth=2), gen).to(dev).requires_grad_(False)
    cam = camera_from_angles(torch.tensor([0.25, -0.25], device=dev),
                             torch.tensor([0.05, 0.05], device=dev), 64)
    pts, rays_d, _, z_vals = prepare_nerf_inputs(cam.focal, 64, cam.extrinsics, cam.near,
                                                 cam.far, 24, perturb=True,
                                                 t_rand=torch.rand((2, 64, 64, 1),
                                                                   generator=gen).to(dev))
    flat = lambda x: x.reshape(2, 4096, *x.shape[3:]).detach().requires_grad_(True)
    pts, rays_d, z_vals = flat(pts), flat(rays_d), flat(z_vals)
    styles = torch.randn((2, 3, 256), generator=gen).to(dev).requires_grad_(True)
    leaves = [pts, rays_d, z_vals, styles]

    def render(fused):
        vd = torch.nn.functional.normalize(rays_d, dim=-1)
        return rend(pts, rays_d, vd, z_vals, cam.near, cam.far, styles, fused=fused)[:5]

    _lib.reset_launches()
    outs = render(True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["siren_render"] == 2
    cots = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
    got = torch.autograd.grad(outs, leaves, cots)
    vd = torch.nn.functional.normalize(rays_d, dim=-1)
    ref = [siren_render_reference(rend, styles[i], pts[i], vd[i], z_vals[i], rays_d[i],
                                  cam.near[0, 0, 0], cam.far[0, 0, 0]) for i in range(2)]
    want = torch.autograd.grad([torch.stack(o) for o in zip(*ref)], leaves, cots)
    want32 = torch.autograd.grad(render(False), leaves, cots)
    for name, g, w, w32 in zip(("pts", "rays_d", "z_vals", "styles"), got, want, want32):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
        cos = torch.nn.functional.cosine_similarity(g.flatten().double(),
                                                    w32.flatten().double(), dim=0)
        assert float(cos) > 0.99, (name, float(cos))
        assert float((g - w32).abs().max()) <= 0.25 * float(w32.abs().max()), name


def test_d_step_launches_k1_once_per_item(dev):
    """The D step renders its fakes through K1, one launch per batch item,
    and moves both discriminators (a width-256, 24-sample generator at 16^2
    rays with one upsample block)."""
    import dataclasses

    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import Generator, preset_r1024
    from cips3dpp_torch.train import TrainConfig, create_train_state, make_train_steps

    base = preset_r1024()
    cfg = dataclasses.replace(base, img_size=16, decoder=dataclasses.replace(
        base.decoder, upsample_list=(128,)))
    tcfg = TrainConfig(batch=3)
    state = create_train_state(tcfg, Generator(cfg, device=dev, seed=2),
                               DStyleGANProgressive(1024, 1, device=dev, seed=3),
                               DVolumeRenderProgressive(64, device=dev, seed=4))
    d_step = make_train_steps(cfg, tcfg)[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    real = torch.rand((3, 32, 32, 3), generator=gen, device=dev) * 2 - 1
    before = [p.clone() for p in state.d.parameters()]
    launches = _lib.LAUNCHES["siren_render"]
    state, metrics = d_step(state, real, gen, 1.0, True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["siren_render"] == launches + 3
    assert all(torch.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(p, q) for p, q in zip(state.d.parameters(), before))


def test_prefetch_to_device_delivers_every_batch_intact(dev):
    """50 batches through the side-stream prefetcher while the consuming
    stream is kept busy: each batch is read on the consumer only after
    queued work and after its last Python reference is dropped, so a batch
    whose memory were reused too early would arrive changed."""
    import numpy as np

    from cips3dpp_torch.parallel import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((4, 128, 128, 3)).astype(np.float32) for _ in range(50)]
    a = torch.randn((2048, 2048), device=dev)
    clones = []
    for batch in prefetch_to_device(iter(batches), dev, size=2):
        assert batch.device == dev
        for _ in range(4):  # queued work ahead of the read
            a = torch.tanh(a @ a * 1e-3)
        clones.append(batch * 1)
        del batch
    torch.cuda.synchronize()
    assert len(clones) == 50
    for i, (c, b) in enumerate(zip(clones, batches)):
        assert np.array_equal(c.cpu().numpy(), b), i


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A TrainState of CUDA tensors saved and restored into fresh modules
    on the same device: every tensor equal, and the restored optimizers'
    next update equal to the saved ones'."""
    from cips3dpp_torch.io.checkpoint import CheckpointManager
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.train import TrainConfig, create_train_state

    cfg = GeneratorConfig(renderer=RendererConfig(hidden_dim=16),
                          decoder=DecoderConfig(upsample_list=(16,), style_dim=32,
                                                mapping_n_layers=1),
                          img_size=8, n_samples=4)

    def state(seed):
        return create_train_state(
            TrainConfig(), Generator(cfg, device=dev, seed=seed),
            DStyleGANProgressive(16, 1, device=dev, seed=seed + 1),
            DVolumeRenderProgressive(8, device=dev, seed=seed + 2))

    gen = torch.Generator(device=dev).manual_seed(0)

    def step(s):
        for name in ("opt_g", "opt_d", "opt_d_render"):
            opt = getattr(s, name)
            opt.step({k: [torch.randn(p.shape, generator=gen, device=dev) for p in ps]
                      for k, ps in opt.groups.items()})

    def flat(s):
        out = {}
        for k in s.MODULES:
            out.update({f"{k}.{n}": t for n, t in getattr(s, k).state_dict().items()})
        for k in s.OPTIMIZERS:
            for i, st in getattr(s, k).state_dict()["state"].items():
                out.update({f"{k}.{i}.{n}": t for n, t in st.items()})
        out["mean_path_length"] = s.mean_path_length
        return out

    a = state(1)
    step(a)
    a.mean_path_length = torch.tensor(0.25, device=dev)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, a)
    b = state(5)
    mgr.restore(b)
    fa, fb = flat(a), flat(b)
    for k, t in fa.items():
        assert fb[k].device == t.device and torch.equal(fb[k], t), k
    gen_state = gen.get_state()
    step(a)
    gen.set_state(gen_state)
    step(b)
    fa, fb = flat(a), flat(b)
    assert all(torch.equal(fb[k], fa[k]) for k in fa)


def _small_train(dev, seed=1):
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.train import TrainConfig

    cfg = GeneratorConfig(renderer=RendererConfig(hidden_dim=16),
                          decoder=DecoderConfig(upsample_list=(16,), style_dim=32,
                                                mapping_n_layers=1),
                          img_size=8, n_samples=4)
    tcfg = TrainConfig(batch=4, data_img_size=16, cam_img_size=8, gen_img_size=16,
                       fused_renderer_d=False)
    return cfg, tcfg, (Generator(cfg, device=dev, seed=seed),
                       DStyleGANProgressive(16, 1, device=dev, seed=seed + 1),
                       DVolumeRenderProgressive(8, device=dev, seed=seed + 2))


def test_one_rank_nccl_steps_bit_equal_unsharded(dev):
    """A D step with lazy R1, a G step and a path-length step on a one-rank
    NCCL group end on the same tensors as without a mesh, bit for bit (the
    all-reduce of one rank divides by 1; the gathered stddev batch is the
    batch). With cuDNN's deterministic algorithms: its default backward
    algorithms do not repeat themselves on the card. The unsharded steps
    are run twice first: they must repeat, or bit-equality says nothing."""
    from cips3dpp_torch.parallel import make_mesh, replicate
    from cips3dpp_torch.train import create_train_state, make_train_steps

    def run(mesh):
        cfg, tcfg, mods = _small_train(dev)
        state = replicate(create_train_state(tcfg, *mods, mesh), mesh)
        d_step, g_step, path_step, _ = make_train_steps(cfg, tcfg, mesh)
        gen = torch.Generator(device=dev).manual_seed(3)
        real = torch.rand((4, 16, 16, 3), generator=gen, device=dev) * 2 - 1
        d_step(state, real, gen, 0.5, True)
        g_step(state, gen, 0.5)
        path_step(state, gen)
        torch.cuda.synchronize()
        return [t.clone() for k in state.MODULES for t in getattr(state, k).state_dict().values()]

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        plain = run(None)
        assert all(torch.equal(a, b) for a, b in zip(plain, run(None))), "not repeatable"
        mesh = make_mesh(1)
        try:
            assert mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0)
            got = run(mesh)
            assert mesh.counts["grad_all_reduce"] == 4  # D, pose D, G, G (path reg)
        finally:
            mesh.close()
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_inception_on_the_card_matches_cpu(dev):
    """The FID Inception on cuDNN (TF32 off) against the CPU, same seeded
    weights, batch 2 at 64^2 in both input protocols: within 1e-5 of the
    largest |feature| (f32 sums in other orders)."""
    from cips3dpp_torch.models.inception import init_inception

    gpu = init_inception(torch.Generator().manual_seed(0), device=dev)
    cpu = init_inception(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    for u8, x in ((True, torch.randint(0, 256, (2, 64, 64, 3), generator=gen).float()),
                  (False, torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1)):
        with torch.no_grad():
            got, want = gpu(x.to(dev), fidelity_u8=u8).cpu(), cpu(x, fidelity_u8=u8)
        assert got.shape == (2, 2048) and torch.isfinite(got).all()
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_native_loader_into_the_prefetcher(dev, tmp_path):
    """The native loader's batches through the side-stream prefetcher arrive
    on the card unchanged (a second loader of the same seed gives the
    reference)."""
    import numpy as np

    from cips3dpp_torch.io.native_loader import open_native_loader
    from cips3dpp_torch.parallel import prefetch_to_device

    rng = np.random.default_rng(0)
    np.save(tmp_path / "images-64-0000.npy", rng.integers(0, 256, (16, 64, 64, 3), np.uint8))
    fed = open_native_loader(str(tmp_path), 4, seed=2, n_threads=1)
    ref = open_native_loader(str(tmp_path), 4, seed=2, n_threads=1)
    try:
        for i, batch in zip(range(10), prefetch_to_device(fed, dev)):
            assert batch.device == dev
            assert np.array_equal(batch.cpu().numpy(), next(ref)), i
    finally:
        fed.close()
        ref.close()
