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


def _siren_inputs(dev, width, s, r, seed=0):
    """A seeded depth-2 renderer of `width` and its prepared operands, and
    r rays x s samples of inputs, on `dev`."""
    from cips3dpp_torch.kernels.siren_render import siren_prepare
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(seed)
    rend = init_parameters(VolumeFeatureRenderer(depth=2, hidden_dim=width), gen).to(dev)
    styles = torch.randn((3, 256), generator=gen).to(dev)
    pts = (0.1 * torch.randn((r, s, 3), generator=gen)).to(dev)
    vd = torch.nn.functional.normalize(torch.randn((r, 3), generator=gen), dim=-1).to(dev)
    z = (torch.linspace(0.88, 1.12, s)[None] + 1e-3 * torch.randn((r, 1), generator=gen)).to(dev)
    prep = siren_prepare(rend, styles, torch.tensor(0.88, device=dev),
                         torch.tensor(1.12, device=dev))
    return prep, pts, vd, z, 1.05 * vd


# The serving geometry (width 256, 24 samples: its own build) at R = 1001
# = 8*125 + 1, ragged against the 8-ray tile, 5, less than one tile, and
# 64*64, the serving shape, where the tiles outnumber the SMs; then the
# width builds (the sample count taken at launch) at widths 32, 128 and 512
# (the wide kernel: 8-ray tiles of 8-sample chunks), 1 sample, 12 (a part
# chunk), 20 (no multiple of the 24- or 8-sample chunk) and 48 (whole
# chunks); and at width 512 also 24 (three whole chunks) and 64. Then the
# widths no build has as its own, run zero-padded: 96 (the width-128
# build), 200 (the serving build at 24 samples, the width-256 build at
# 48), 384 and 300 (the width-512 build); sample counts past 64: 65 (one
# past a 24- and an 8-sample chunk), 72 and 96, 128 and 256 (many
# chunks); and the run-time-width build (64-row units, h0 and h1 staged
# through its scratch) at 640 (10 chunks a pass, 5 passes: an odd count),
# 1024 and 2048 at 1, 20 (no multiple of the 8-sample unit), 24 and 65
# samples over 1001 and 4096 rays; at 8 (one whole unit) and 96 samples
# there and at 2049 (padded to 2176), 2176, 3000 (padded to 3072) and
# 4096, which also run 1 and 24 samples; 4096 at 24 over 4096 rays; 700
# (padded to 768) and 1152 (9 passes)
K1_GEOMETRIES = [(256, 24, r) for r in (1001, 5, 4096)] + [
    (w, s, r) for w in (32, 128, 512) for s in (1, 12, 20, 48) for r in (1001, 4096)] + [
    (512, s, r) for s in (24, 64) for r in (1001, 4096)] + [
    (96, 24, 1001), (96, 65, 4096), (200, 24, 4096), (200, 48, 1001), (384, 24, 4096),
    (300, 72, 1001), (256, 65, 1001), (256, 96, 4096), (128, 256, 1001), (512, 128, 1001),
    (512, 96, 4096)] + [
    (w, s, r) for w in (640, 1024, 2048) for s in (1, 20, 24, 65) for r in (1001, 4096)] + [
    (w, s, 1001) for w in (640, 1024, 2048, 2049, 2176, 3000, 4096) for s in (8, 96)] + [
    (w, s, 1001) for w in (2049, 2176, 3000, 4096) for s in (1, 24)] + [
    (4096, 24, 4096), (700, 24, 1001), (1152, 48, 1001)]


@pytest.mark.parametrize("width,s,r", K1_GEOMETRIES)
def test_siren_render_kernel_matches_plain(dev, width, s, r):
    """K1 against its plain version at `width` x `s` samples, R rays."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import siren_render_plain, siren_render_prepared
    from cips3dpp_torch.tools.frame_gap_split import k1_bounds

    prep, pts, vd, z, rd = _siren_inputs(dev, width, s, r)
    dnorm = torch.linalg.norm(rd, dim=-1, keepdim=True)
    before = _lib.LAUNCHES["siren_render"]
    got = siren_render_prepared(prep, pts, vd, z, rd)
    assert _lib.LAUNCHES["siren_render"] == before + 1
    want = siren_render_plain(prep, pts, vd, z, dnorm)
    again = siren_render_prepared(prep, pts, vd, z, rd)
    torch.cuda.synchronize()
    # only f32 sum orders differ: the bounds sit 10x (feat) to 90x (xyz)
    # above the largest readings at 256 / 24 on the H100 (PERF.md section
    # 6); past width 512 the larger of them and 1.5x the plain version's
    # own spread under another sum order of its products (k1_bounds)
    atol = k1_bounds({"thumb": 1e-3, "feat": 5e-3, "sdf": 1e-3, "mask_depth": 1e-4,
                      "xyz": 1e-4}, prep, pts, vd, z, dnorm)
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(atol, got, want)}
    print(f"W={width} S={s} R={r}: max |kernel - plain| {errs}, bounds {atol}")
    for g, w, g2, tol in zip(got, want, again, atol.values()):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
        assert torch.equal(g, g2)  # fixed summation order: same bits every launch


@pytest.mark.parametrize("width,s", [(256, 24), (128, 48), (512, 20), (512, 24), (96, 65),
                                     (640, 20), (1024, 24), (2048, 65), (2176, 24), (4096, 8)])
def test_siren_render_ray_slices_equal_the_whole(dev, width, s):
    """Each ray's arithmetic is independent of its tile: two launches over
    the halves of 4096 rays give the bits of one launch over all (what the
    mesh's ray axis relies on)."""
    from cips3dpp_torch.kernels.siren_render import siren_render_prepared

    prep, pts, vd, z, rd = _siren_inputs(dev, width, s, 4096, seed=3)
    whole = siren_render_prepared(prep, pts, vd, z, rd)
    halves = [siren_render_prepared(prep, pts[i:i + 2048], vd[i:i + 2048], z[i:i + 2048],
                                    rd[i:i + 2048]) for i in (0, 2048)]
    for w, a, b in zip(whole, *halves):
        assert torch.equal(w, torch.cat([a, b]))


def test_siren_render_refuses_other_geometries(dev):
    """Every width and any sample count launch K1 (a width no build has
    as its own zero-padded, feat at the renderer's width), past 2048 too
    (2049 at 2176, 4096); a sample count below 1 raises before launching,
    naming it."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import siren_render_prepared

    for width, s in ((96, 24), (256, 65), (1024, 24), (2048, 96), (2049, 24), (4096, 24)):
        prep, pts, vd, z, rd = _siren_inputs(dev, width, s, 8)
        before = _lib.LAUNCHES["siren_render"]
        out = siren_render_prepared(prep, pts, vd, z, rd)
        assert _lib.LAUNCHES["siren_render"] == before + 1 and out[1].shape == (8, width)
    prep, pts, vd, z, rd = _siren_inputs(dev, 2049, 24, 8)
    before = _lib.LAUNCHES["siren_render"]
    with pytest.raises(ValueError, match="0 samples, K1 takes widths 1 and up and 1 or more"):
        siren_render_prepared(prep, pts[:, :0], vd, z[:, :0], rd)
    assert _lib.LAUNCHES["siren_render"] == before


@pytest.mark.parametrize("width", [640, 2176])
def test_siren_wide_scratch_holds_h0_and_h1(dev, width):
    """The run-time-width build stages h0 and h1 through its scratch in
    the layout `wide_activation_layout` describes: after a launch over one
    unit (8 rays x 8 samples, the first CTA's), the CTA's two tiles hold
    the plain version's h0 and h1 in bf16, a value off by at most one bf16
    step where another f32 sum order flips a rounding (layer 0's three
    terms, layer 1's products), and few of them."""
    from cips3dpp_torch.kernels import siren_render as ksr

    prep, pts, vd, z, rd = _siren_inputs(dev, width, 8, 8)
    dnorm = torch.linalg.norm(rd, dim=-1, keepdim=True)
    kw = prep["weights"][3].shape[0]
    per_cta = ksr.wide_scratch_bytes(kw)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.zeros(sms * per_cta, dtype=torch.uint8, device=dev)
    ksr._launch(prep, pts, vd, z, dnorm, scratch=scratch)
    torch.cuda.synchronize()
    w0, g0, be0, w1, g1, be1 = prep["weights"][:6]
    x = (pts * prep["consts"][0]).reshape(64, 3)  # rows ray-major, as the kernel's unit
    h0 = ksr.fast_sin(g0 * ksr._bdot(x, w0) + be0).to(torch.bfloat16)
    h1 = ksr.fast_sin(g1 * ksr._bdot(h0, w1) + be1).to(torch.bfloat16)
    tiles = scratch[:per_cta].view(torch.bfloat16)
    for name, want, got in (("h0", h0, tiles[:64 * kw]), ("h1", h1, tiles[64 * kw:])):
        d = (got.float() - ksr.wide_activation_layout(want).float()).abs()
        off = float((d > 0).float().mean())
        print(f"W={width} {name}: max |scratch - plain| {float(d.max()):.3e}, share off {off:.4f}")
        assert float(d.max()) <= 2**-7 and off <= 0.01, (name, float(d.max()), off)


# sha1 of each entry's SASS instructions (sass_diff.parse_sass, the text
# and first encoding word of each line) in the K1 builds up to width 512:
# the serving build and the width builds 32-512, by (defines, the PAD
# instantiation). Recorded on the H100 machine (CUDA 12.8) from the
# libraries those builds compiled to before the run-time-width build was
# redesigned, identical to them line for line (sass_diff): that redesign
# leaves these builds' code as it was.
NARROW_SASS = {
    ((), 0): "966f5e04f46e6f8af0912b536dadad4f8921172e",
    ((), 1): "01e0379cecf92039ff6825246939c7f7ab9c68bf",
    (("-DK1_W=32", "-DK1_FIXED_S=0"), 0): "001d1d9ecef3bb5eae802814c9d997c2d77eb344",
    (("-DK1_W=32", "-DK1_FIXED_S=0"), 1): "fc52dab23df5e85577b3e7da63f2f76c7a6c10eb",
    (("-DK1_W=64", "-DK1_FIXED_S=0"), 0): "60612654bfa2194d44df534920eabaf19e0ad38e",
    (("-DK1_W=64", "-DK1_FIXED_S=0"), 1): "d3e1298c33aac03b018f0e8955a44a0300109cbf",
    (("-DK1_W=128", "-DK1_FIXED_S=0"), 0): "f5ce1f8e939e313ece2ecacc334301d41aab67d3",
    (("-DK1_W=128", "-DK1_FIXED_S=0"), 1): "d8152ec4cd4e1c573c9dd9c52a1e662e6d94c1ca",
    (("-DK1_W=256", "-DK1_FIXED_S=0"), 0): "c65866f8717c381198f6a918a5f9baf5b7f2623b",
    (("-DK1_W=256", "-DK1_FIXED_S=0"), 1): "0588285464f390e701315366a56cacd45191d324",
    (("-DK1_W=512", "-DK1_FIXED_S=0"), 0): "df13a3ac32285946d27d8b1d230ff3fc082d4318",
    (("-DK1_W=512", "-DK1_FIXED_S=0"), 1): "779a1818a847a23bafdc52dd0c12e5cc3c4dfbee",
}


def test_siren_narrow_builds_keep_their_sass(dev):
    """The K1 builds up to width 512 compile to the SASS in NARROW_SASS,
    entry by entry (both instantiations of each), so the run-time-width
    build's code shares none of their instructions' fate."""
    import hashlib
    import subprocess

    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.tools import sass_diff

    builds = [(n, d) for n, d in ksr.kernel_builds() if ksr.RUN_TIME_WIDTH_DEFINE not in d]
    _lib.build(builds)
    seen = {}
    for name, defines in builds:
        text = subprocess.run([sass_diff._cuobjdump(), "-sass", str(_lib._lib_path(name, defines))],
                              capture_output=True, text=True, check=True).stdout
        for entry, ins in sass_diff.parse_sass(text).items():
            seen[(defines, int("ILb1" in entry))] = hashlib.sha1("\n".join(ins).encode()).hexdigest()
    assert seen == NARROW_SASS, {k: v for k, v in seen.items() if NARROW_SASS.get(k) != v}


def test_siren_phase_split_counts_every_phase(dev):
    """The instrumented K1 build computes what the plain build computes
    (checked inside `measure`) and counts cycles in every phase."""
    from cips3dpp_torch.tools.siren_phase_split import PHASES, measure

    out = measure(64, 2, dev)
    assert list(out["share"]) == list(PHASES)
    assert all(v > 0 for v in out["share"].values())
    assert abs(sum(out["share"].values()) - 1.0) < 1e-9
    assert out["ms"] > 0 and out["instrumented_ms"] > 0


def test_siren_wide_phase_split_counts_every_phase(dev):
    """The same for the width-512 kernel's instrumented build, whose warps
    count their own cycles (the producer's waits among them)."""
    from cips3dpp_torch.tools.siren_phase_split import WIDE_PHASES, measure

    out = measure(64, 2, dev, 512, 20)
    assert list(out["share"]) == list(WIDE_PHASES)
    assert all(v > 0 for v in out["share"].values())
    assert abs(sum(out["share"].values()) - 1.0) < 1e-9
    assert out["ms"] > 0 and out["instrumented_ms"] > 0


@pytest.mark.parametrize("width,s,r", [(512, 24, 4096), (512, 12, 1001), (1024, 24, 4096),
                                       (2176, 24, 1001)])
def test_siren_wide_planted_ring_fault_is_caught(dev, width, s, r):
    """A wide build (512, and the run-time-width build at 1024 and 2176) with a
    planted fault (-DK1_PLANT_RING_FAULT: each consumer reads the ring
    slot after the one whose full barrier it waited for) launches and
    returns, and the comparison the tests above make against the plain
    version fails: they can catch a broken ring."""
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.tools.frame_gap_split import k1_bounds

    prep, pts, vd, z, rd = _siren_inputs(dev, width, s, r)
    dnorm = torch.linalg.norm(rd, dim=-1, keepdim=True)
    got = ksr._launch(prep, pts, vd, z, dnorm, ("-DK1_PLANT_RING_FAULT",))
    want = ksr.siren_render_plain(prep, pts, vd, z, dnorm)
    torch.cuda.synchronize()
    atol = k1_bounds({"thumb": 1e-3, "feat": 5e-3, "sdf": 1e-3, "mask_depth": 1e-4,
                      "xyz": 1e-4}, prep, pts, vd, z, dnorm)
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(atol, got, want)}
    print(f"planted ring fault, W={width} S={s} R={r}: max |kernel - plain| {errs}")
    assert any(not e <= atol[k] for k, e in errs.items()), errs


# (storage, noise): the serving mode (bf16, buffers), the f32 decoder
# config's mode, and hash noise made in the kernel in either storage
MODES = [("bf16", "buffers"), ("f32", "buffers"), ("bf16", "hash"), ("f32", "hash")]
# y1 (F*Hp, Wp) by name: the first two as before; Wp = 48 is ragged against
# the tile width at C = 16, 32 and 64 (128, 64 and 32 input columns) with
# F = 3; Hp = 1 puts every row at a frame edge; "large"
# gives every persistent block several tiles, so the staging ring (and from
# C = 384 up the weight ring, across tiles) wraps. The streamed kernel's
# clusters walk CL neighbouring tiles: "cluster-ragged" has 15 and 30
# tiles at its 64- and 32-pixel tiles, a multiple of no cluster of 4 (and
# of none of 2 at 64 pixels; at 32 pixels a tile count is even at every
# Wp % 16 == 0), so the last cluster has CTAs past the last tile;
# "cluster-short" has 1 and 2 tiles, fewer than a cluster of 4
SHAPES = {"16x32": (16, 32, 1), "16x32-f2": (16, 32, 2), "ragged-f3": (8, 48, 3),
          "hp1-f2": (1, 32, 2), "large-f2": None, "cluster-ragged": (1, 80, 3),
          "cluster-short": (1, 16, 1)}
# the cluster sizes the streamed kernel runs at on the cluster shapes: the
# plain library's, and a library built with clusters of 4
CLUSTER_SIZES = (2, 4)


def _block_shape(name, c):
    if name == "large-f2":
        return (256, 256, 2) if c <= 64 else (128, 128, 2)
    return SHAPES[name]


def _cluster_builds(shape, c):
    """[(cluster, defines)]: the libraries to run the kernel in at `shape`
    and C = c, each with its streamed kernel's cluster size (None: the
    plain library, its cluster not asserted)."""
    from cips3dpp_torch.kernels.decoder_block import is_streamed
    from cips3dpp_torch.tools.k2_times import cluster_defines

    if not (shape.startswith("cluster") and is_streamed(c)):
        return [(None, ())]
    return [(cl, () if cl == CLUSTER_SIZES[0] else cluster_defines(cl))
            for cl in CLUSTER_SIZES]


# every resident C, and the streamed kernel at each tile size (64 pixels
# at 192-1024, 32 at 1088-2048), with C fixed (384, 512, 1024, 2048) and
# at run time (640, 1152), and with a tail pass of 64 channels, C fixed
# (192, 320) and at run time at each tile size (576, 1088)
BLOCK_CHANNELS = [16, 32, 64, 128, 256, 384, 512, 640, 1024, 1152, 2048, 192, 320, 576, 1088]


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("c", BLOCK_CHANNELS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_decoder_block_kernel_matches_plain(dev, c, shape, mode):
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        _launch, decoder_block_info, decoder_block_packed, decoder_block_plain,
        decoder_block_prepare, launch_name,
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
    for (cl, defines), emit_feat in [(b, e) for b in _cluster_builds(shape, c)
                                     for e in (True, False)]:
        if cl is not None:
            info = decoder_block_info(c, dt, mode[1] == "hash", defines=defines)
            assert info["cluster"] == cl
        run = ((lambda: _launch(y1, prep, emit_feat, frames, defines)) if defines else
               (lambda: decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat,
                                             frames=frames)))
        before = _lib.LAUNCHES.copy()  # a Counter: 0 for a kernel not launched yet
        got = run()
        assert _lib.LAUNCHES[name] == before.get(name, 0) + 1
        assert sum(_lib.LAUNCHES.values()) == sum(before.values()) + 1
        again = run()
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


@pytest.mark.parametrize("m", [1, 4, 8])
def test_fused_frames_at_channel_multipliers(dev, m):
    """preset_serving at channel multiplier 1 (the 1024^2 block at C = 16),
    4 (the 128^2 block at C = 512) and 8 (the 128^2 block at C = 1024, the
    256^2 block at 512): an r1024 frame through
    prepare_trajectory / render_frame launches 1 K1 + 4 K2 and lies within
    chip_smoke.py phase 5's bounds of the frame through K2's plain
    version. Against the plain versions of both kernels its mean gap is
    K1's bf16 flips through the 14 bf16 layers, as large as the plain
    path's own under another GEMM order (F = 4; python -m
    cips3dpp_torch.tools.frame_gap_split): at most 1.5x that."""
    import dataclasses

    from cips3dpp_torch import serving
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.kernels import decoder_fused as kdf
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.generator import Generator, preset_serving
    from cips3dpp_torch.models.layers import randomize_zero_init_

    base = preset_serving()
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, channel_multiplier=m))
    model = Generator(cfg, device=dev, seed=20 + m)
    randomize_zero_init_(model, torch.Generator().manual_seed(20 + m))
    gen = torch.Generator().manual_seed(30 + m)
    zs = [torch.randn((1, 256), generator=gen).to(dev) for _ in range(2)]
    noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
    prep = serving.prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
    assert [b["bp"]["w2t"].shape[0] for b in prep["dec"]["blocks"] if "bp" in b] == [
        128 * m, 64 * m, 32 * m, 16 * m]
    yaw, zero = torch.full((1,), 0.2, device=dev), torch.zeros(1, device=dev)
    _lib.reset_launches()
    got = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"siren_render": 1, "decoder_block": 4}
    saved = serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed
    kdf.decoder_block_packed = lambda y1, prepared, emit_feat=True, frames=1: \
        kdb.decoder_block_plain(y1, prepared, emit_feat, frames)
    try:
        want_k2 = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
        serving.siren_render_prepared = ksr.siren_render_prepared = (
            lambda p, pts, vd, z, d: ksr.siren_render_plain(
                p, pts, vd, z, torch.linalg.norm(d, dim=-1, keepdim=True)))
        want = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
        yaws = torch.cat([yaw, torch.zeros(3, device=dev)])
        own = serving.render_frame(model, prep, yaws, yaws * 0, device=dev)["rgb"][:1]
    finally:
        serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed = saved
    assert got.shape == (1, 1024, 1024, 3) and torch.isfinite(got).all()
    d_k2, d, d_own = (got - want_k2).abs(), (got - want).abs(), (own - want).abs()
    assert float(d_k2.max()) <= 0.5 and float(d_k2.mean()) <= 1e-2, float(d_k2.mean())
    assert float(d.max()) <= 0.5 and float(d.mean()) <= 1.5 * float(d_own.mean()), (
        float(d.max()), float(d.mean()), float(d_own.mean()))


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


# K2 at the (C, Hp, Wp, F) no built kernel runs as they are, each JAX's
# packed block admits: C = 1-8 padded to 16 (Wp a multiple of 128 // C),
# 144 to 256, 272 and 288 to 384, 576 to 640, 1088 to 1152, widths padded
# to a multiple of 16 (Wp = 8 at C = 16, 6 at 64, 24 at 256, 20 and 40
# streamed, with hash noise counting in the caller's width), and the
# streamed kernel's staged build past C = 2048 (2176-8192, and past 8192,
# where the port once stopped: 8320, 8193 run at 8320, and 16384); at Hp =
# 1 the cluster shapes, also run with clusters of 4
PADDED_BLOCKS = [(1, 8, 128, 1), (2, 4, 64, 2), (4, 8, 32, 1), (8, 8, 16, 2), (8, 2, 48, 3),
                 (16, 4, 8, 2), (64, 4, 6, 1), (144, 8, 16, 2), (144, 3, 20, 1),
                 (256, 8, 24, 2), (272, 4, 16, 1), (288, 4, 40, 2), (576, 8, 16, 1),
                 (1088, 4, 16, 1), (2112, 4, 16, 1), (2112, 1, 20, 2), (2176, 8, 16, 2),
                 (2176, 1, 20, 1), (4096, 8, 16, 1),
                 (4224, 1, 16, 1), (8192, 4, 16, 1), (8192, 1, 24, 2), (8320, 4, 16, 1),
                 (8193, 1, 20, 3), (16384, 2, 16, 1)]


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("c,hp,wp,frames", PADDED_BLOCKS,
                         ids=[f"C{c}-{hp}x{wp}-f{f}" for c, hp, wp, f in PADDED_BLOCKS])
def test_decoder_block_kernel_at_padded_counts(dev, c, hp, wp, frames, mode):
    """K2 through its entry point at C and Wp it runs padded: one launch a
    call, twice bit-equal, against decoder_block_packed_plain (the same
    route with the plain version in the kernel's place) at the card tests'
    bounds, outputs at the caller's C and width."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        _launch, _padded, decoder_block_info, decoder_block_packed,
        decoder_block_packed_plain, decoder_block_prepare, launch_name,
    )
    from cips3dpp_torch.tools.k2_times import cluster_defines

    gen = torch.Generator().manual_seed(c + 10 * wp + frames)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[mode[0]]
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    prep = decoder_block_prepare(
        rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1), rnd(c, c) / c**0.5,
        0.1 * rnd(c), 0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5, dtype=dt,
        noise_seeds=(123, 456) if mode[1] == "hash" else None,
    )
    y1 = rnd(frames * hp, wp, c).to(dt)
    name = launch_name(prep)
    builds = [()] + ([cluster_defines(4)] if c > 2048 and hp == 1 else [])
    for defines, emit_feat in [(d, e) for d in builds for e in (True, False)]:
        if defines:
            assert decoder_block_info(c, dt, mode[1] == "hash", defines=defines)["cluster"] == 4
            run = lambda: _padded(
                lambda x, *a, **k: _launch(x, *a, defines=defines, **k),
                y1, prep, emit_feat, frames)
        else:
            run = lambda: decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat,
                                               frames=frames)
        before = _lib.LAUNCHES.copy()
        got = run()
        assert _lib.LAUNCHES[name] == before.get(name, 0) + 1
        assert sum(_lib.LAUNCHES.values()) == sum(before.values()) + 1
        again = run()
        want = decoder_block_packed_plain(y1, prep, emit_feat, frames)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        assert got[-1].shape[:2] == (2 * frames * hp, 2 * wp)
        if emit_feat:
            assert got[0].shape == (2 * frames * hp, 2 * wp, c)
        for g, a, w in zip(got, again, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, a)
            tol = (dict(rtol=0, atol=1e-3) if dt == torch.float32
                   else dict(rtol=1.6e-2, atol=2e-2))
            torch.testing.assert_close(g.float(), w.float(), **tol)


# K3 at the C and Wp it runs padded (its JAX block takes every C): C = 3,
# 48 and 144 as the CPU tests, 2176-8192 on the staged build, and past 8192;
# then full-size blocks on it: y1 (64, 64, 4096 / 8192) and (8, 16, 16384)
K3_PADDED = [(3, 8, 16), (48, 8, 24), (144, 8, 16), (144, 2, 20), (272, 8, 16), (2112, 2, 16),
             (2176, 4, 16),
             (4224, 2, 20), (8192, 1, 16), (8320, 2, 16), (16384, 1, 16), (4096, 64, 64),
             (8192, 64, 64), (16384, 8, 16)]


@pytest.mark.parametrize("c,hp,wp", K3_PADDED, ids=[f"C{c}-{h}x{w}" for c, h, w in K3_PADDED])
def test_decoder_block_fused_kernel_at_padded_counts(dev, c, hp, wp):
    """K3 through its entry point at C and Wp it runs padded: one launch,
    twice bit-equal, against its plain version at the caller's shape."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_fused, decoder_block_fused_plain, fused_launch_name,
    )

    gen = torch.Generator().manual_seed(200 + c + wp)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    args = (rnd(hp, wp, c), rnd(hp, wp, 3), rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1),
            rnd(c, c) / c**0.5, rnd(c, 3) / c**0.5, 0.1 * rnd(c), 0.1 * rnd(c),
            0.1 * rnd(3), 0.3, 0.2)
    name = fused_launch_name(c)
    assert name == "decoder_block_fused" + ("_staged" if c > 2048 else "")
    before = _lib.LAUNCHES[name]
    got = decoder_block_fused(*args)
    assert _lib.LAUNCHES[name] == before + 1
    again = decoder_block_fused(*args)
    want = decoder_block_fused_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (2 * hp, 2 * wp, c) and got[1].shape == (2 * hp, 2 * wp, 3)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=1.6e-2, atol=2e-2)


# K3 takes one frame: the same shapes as K2's, F = 1 ("cluster-ragged":
# 5 and 10 tiles; "cluster-short": 1 and 2)
K3_SHAPES = {"32x16": (32, 16), "ragged": (8, 48), "hp1": (1, 32), "large": None,
             "cluster-ragged": (1, 80), "cluster-short": (1, 16)}


@pytest.mark.parametrize("c", [16, 32, 64, 128, 256, 384, 512, 640, 1024, 1152, 2048, 192,
                               320, 576, 1088])
@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_decoder_block_fused_kernel_matches_plain(dev, c, shape):
    """K3, the v1 block: f32 in and out, bias and upsampled-skip epilogue."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.decoder_block import (
        _launch_fused, decoder_block_fused, decoder_block_fused_plain, decoder_block_info,
    )

    hp, wp = K3_SHAPES[shape] or ((256, 256) if c <= 64 else (128, 128))
    gen = torch.Generator().manual_seed(100 + c + hp)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    args = (rnd(hp, wp, c), rnd(hp, wp, 3), rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1),
            rnd(c, c) / c**0.5, rnd(c, 3) / c**0.5, 0.1 * rnd(c), 0.1 * rnd(c),
            0.1 * rnd(3), 0.3, 0.2)
    want = decoder_block_fused_plain(*args)
    for cl, defines in _cluster_builds(shape, c):
        if cl is not None:
            assert decoder_block_info(c, k3=True, defines=defines)["cluster"] == cl
        run = ((lambda: _launch_fused(*args, defines)) if defines else
               (lambda: decoder_block_fused(*args)))
        before = _lib.LAUNCHES["decoder_block_fused"]
        got = run()
        assert _lib.LAUNCHES["decoder_block_fused"] == before + 1
        again = run()
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
            assert torch.equal(g, a)
        # feat: f32, as K2's f32 mode; rgb multiplies bf16(feat), which flips
        # a bf16 ulp where feat differs in its last f32 bits
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


@pytest.mark.parametrize("c", [1024, 1088, 4096])
def test_decoder_block_streamed_phase_split_counts_every_phase(dev, c):
    """The instrumented streamed-weight kernel at y1 (64, 64, 1024), with a
    tail pass at (64, 64, 1088) and, in its staged build, (64, 64, 4096)
    computes what the plain build computes
    and counts cycles in each of its phases (producer, consumers' waits,
    wgmma, upsample, epilogue); the producer's waits for a tile's ready
    barrier are the staged build's alone."""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.tools.decoder_block_phase_split import (
        DEFINES, WIDE_PHASES, block_inputs, phase_cycles,
    )

    prep, y1 = block_inputs(64, c, torch.bfloat16, False, dev)
    want = kdb.decoder_block_packed(y1, prepared=prep)
    phase_cycles(reset=True, streamed=True)
    got = kdb._launch(y1, prep, True, 1, DEFINES)
    torch.cuda.synchronize()
    cycles = dict(zip(WIDE_PHASES, phase_cycles(reset=False, streamed=True)))
    print(cycles)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(cycles) == len(WIDE_PHASES)
    assert all(v > 0 for k, v in cycles.items() if k != "producer_wait_ready")
    assert (cycles["producer_wait_ready"] > 0) == kdb.is_staged(c)


def test_decoder_block_resources(dev):
    """Every K2 / K3 instantiation fits on the card with no spill, at every
    C the built kernels run to 8320 and at 16384; tiles hold 8192 values
    at C = 16 to 256, and 64 or 32 pixels (16 or 8 input columns) with
    the weight streamed (C = 192 and 320-1024, 1088-2048: every multiple
    of 64), and 64 past 2048 in the
    staged build, whose shared memory is the same at every C (2176, 8192,
    16384: nothing in it grows with C), by clusters of CLUSTER_SIZES[0]
    CTAs, the plain library's, the card can place (1 for the resident
    kernel). A C no built kernel runs is run by the next one's
    instantiation (144 and 8193 among them); a C JAX's packed block refuses
    raises for K2 and is taken by K3; C past 8192, where the kernels once
    stopped, is taken by both."""
    from cips3dpp_torch.kernels.decoder_block import (
        RESIDENT_CHANNELS, decoder_block_info, is_staged, is_streamed, kernel_channels,
        tile_pixels,
    )

    for dt, hashed, k3 in ((torch.bfloat16, False, False), (torch.bfloat16, True, False),
                           (torch.float32, False, False), (torch.float32, True, False),
                           (torch.float32, False, True)):
        staged = {}
        for c in RESIDENT_CHANNELS + (192,) + tuple(range(320, 8321, 64)) + (16384,):
            info = decoder_block_info(c, dt, hashed, k3)
            print(dt, hashed, k3, c, info)
            assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
            assert info["smem_bytes"] <= 232448
            assert info["tile_pixels"] == tile_pixels(c)
            assert info["tile_pixels"] == (8192 // c if c in RESIDENT_CHANNELS
                                           else 32 if 1024 < c <= 2048 else 64)
            assert info["tile_input_columns"] * 4 == info["tile_pixels"]
            assert info["cluster"] == (CLUSTER_SIZES[0] if is_streamed(c) else 1)
            assert info["clusters_on_card"] >= 1
            if is_staged(c):
                staged[c] = info
        # one staged instantiation a mode: the same resources at every C
        assert staged[2176] == staged[8192] == staged[16384]
        for c in (1, 8, 144, 160, 288, 2176, 4096, 8000, 8193):
            assert decoder_block_info(c, dt, hashed, k3) == decoder_block_info(
                kernel_channels(c), dt, hashed, k3)
        for c in (3, 48, 96):
            if k3:
                assert decoder_block_info(c, dt, hashed, k3) == decoder_block_info(
                    kernel_channels(c), dt, hashed, k3)
            else:
                with pytest.raises(ValueError, match="c >= 128"):
                    decoder_block_info(c, dt, hashed, k3)
        assert decoder_block_info(8192 + 128, dt, hashed, k3) == staged[8320]


# SHA-1 of each decoder_block entry's SASS at C <= 2048 (block_kernel at
# 16-256, block_kernel_wide's 64- and 32-pixel tiles), in every mode
# (sass_diff.parse_sass: instructions without their addresses): the
# resident builds and the streamed builds with C fixed at 384-2048 as the
# build before the staged build compiled them, the run-time-C builds and
# the builds fixed at 192 and 320 as recorded once they took the
# 64-channel tail pass. A change to the staged build leaves their code as
# it was.
NARROW_DBLOCK_SASS = {
    "_ZN6dblock12block_kernelILi128E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "27251f0c5212b6c8109065a4e2542da3f219258a",
    "_ZN6dblock12block_kernelILi128E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "94d703dc30b891cb3e6e8d43a7edd4a369868ad2",
    "_ZN6dblock12block_kernelILi128EfLb0ELb0EEEvNS_6ParamsE":
        "32de66cc94632686569cc50ccd104c413aa06723",
    "_ZN6dblock12block_kernelILi128EfLb0ELb1EEEvNS_6ParamsE":
        "197d8dd9c2fa8008ead5018cd2ca64d088c46cee",
    "_ZN6dblock12block_kernelILi128EfLb1ELb0EEEvNS_6ParamsE":
        "7acc12650243a370864c04b71f041a5498f26d93",
    "_ZN6dblock12block_kernelILi16E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "2d1f3a1dab97adde92ef7c0dbb34c3139a514a32",
    "_ZN6dblock12block_kernelILi16E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "3bff56eb1b3fa03f6d6ef69035d140280b857f9c",
    "_ZN6dblock12block_kernelILi16EfLb0ELb0EEEvNS_6ParamsE":
        "8f4119a3bcafd7d689c9e21e19bd63be988fbae0",
    "_ZN6dblock12block_kernelILi16EfLb0ELb1EEEvNS_6ParamsE":
        "eab32a716944bf3425e2740ba2d60b0f323b447e",
    "_ZN6dblock12block_kernelILi16EfLb1ELb0EEEvNS_6ParamsE":
        "3af3d9cabaee3027669b1b18fae2005acaf81a66",
    "_ZN6dblock12block_kernelILi256E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "55a6cb580832c22f58a0019c6f1eb005cf81b717",
    "_ZN6dblock12block_kernelILi256E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "5a22aa08a5ea0baa649a47cb981828e089d4acb8",
    "_ZN6dblock12block_kernelILi256EfLb0ELb0EEEvNS_6ParamsE":
        "3105a2598fd96855753bfbf10233cc481c535f3b",
    "_ZN6dblock12block_kernelILi256EfLb0ELb1EEEvNS_6ParamsE":
        "a1ce1927dd2e82f1a89b4aed014840b0a81625f3",
    "_ZN6dblock12block_kernelILi256EfLb1ELb0EEEvNS_6ParamsE":
        "353c2bcc4eeb7c220794b97b16a73989c48e88f9",
    "_ZN6dblock12block_kernelILi32E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "0e35dbdd24c0b6f16fb52732560c7c3981051e09",
    "_ZN6dblock12block_kernelILi32E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "0e0b65d9b55faa9b260f66dd1a0a9073d5f5be71",
    "_ZN6dblock12block_kernelILi32EfLb0ELb0EEEvNS_6ParamsE":
        "c352b6465a24bac97f23166bc2ce68960bd81d44",
    "_ZN6dblock12block_kernelILi32EfLb0ELb1EEEvNS_6ParamsE":
        "6a99bafb8b072c5f9446152dd2c8d2a064f7a2d9",
    "_ZN6dblock12block_kernelILi32EfLb1ELb0EEEvNS_6ParamsE":
        "c9dd01e02ea8d16db09f6453fa1901a70c3b15d8",
    "_ZN6dblock12block_kernelILi64E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "ffc6d1c494e4b0cd7050b17e18fe529587b79660",
    "_ZN6dblock12block_kernelILi64E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "7d504829c2d801a877eab76031a01ac5db93c140",
    "_ZN6dblock12block_kernelILi64EfLb0ELb0EEEvNS_6ParamsE":
        "7b22c012d5d76af3f56a83ba697005ca04c93a28",
    "_ZN6dblock12block_kernelILi64EfLb0ELb1EEEvNS_6ParamsE":
        "c7514b1c9aa476e0615f275b819894a38d15771e",
    "_ZN6dblock12block_kernelILi64EfLb1ELb0EEEvNS_6ParamsE":
        "aa8fa58b60eb47148ef83256395fbbd5175be49d",
    "_ZN6dblock17block_kernel_wideILi32ELi0E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "318b5689414839bae8441844e41cd7add8349469",
    "_ZN6dblock17block_kernel_wideILi32ELi0E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "a71ef0fb9e56f84e4b74dfdfc341479e5845c942",
    "_ZN6dblock17block_kernel_wideILi32ELi0EfLb0ELb0EEEvNS_6ParamsE":
        "838ab8c216d703cc7492aac73a7bbcc68b4161b1",
    "_ZN6dblock17block_kernel_wideILi32ELi0EfLb0ELb1EEEvNS_6ParamsE":
        "854758377411d6982f07b9b54b949a39930037f6",
    "_ZN6dblock17block_kernel_wideILi32ELi0EfLb1ELb0EEEvNS_6ParamsE":
        "3a9ae4ee62e3d98b785b0102dc9920a5686f1ec4",
    "_ZN6dblock17block_kernel_wideILi32ELi2048E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "697e79b1e623072c0f71ecd5b3ed762f911b2781",
    "_ZN6dblock17block_kernel_wideILi32ELi2048E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "ab1237300676c149ffff19de9af8dc272defdd57",
    "_ZN6dblock17block_kernel_wideILi32ELi2048EfLb0ELb0EEEvNS_6ParamsE":
        "1f3ee3f2d7360283761abbdd8b27e94832e0f0fd",
    "_ZN6dblock17block_kernel_wideILi32ELi2048EfLb0ELb1EEEvNS_6ParamsE":
        "ea265eb16967db98804429e050e8e22021ad9c98",
    "_ZN6dblock17block_kernel_wideILi32ELi2048EfLb1ELb0EEEvNS_6ParamsE":
        "62da9b1643f5cd265f570a36bc61c7c218ef2a05",
    "_ZN6dblock17block_kernel_wideILi64ELi0E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "bf4bf22345dbaa6bbcbc8fd2e41ed2e5ab094522",
    "_ZN6dblock17block_kernel_wideILi64ELi0E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "e4e09d5d2ef966910111eb29bc8d742fb09b8ff2",
    "_ZN6dblock17block_kernel_wideILi64ELi0EfLb0ELb0EEEvNS_6ParamsE":
        "8725c3b1de56bdd9e3155d00fbe2028919e958a3",
    "_ZN6dblock17block_kernel_wideILi64ELi0EfLb0ELb1EEEvNS_6ParamsE":
        "49f13e1956cc197fbef21ba4c7cbd0bb71d24e07",
    "_ZN6dblock17block_kernel_wideILi64ELi0EfLb1ELb0EEEvNS_6ParamsE":
        "380851825a698a2144882c901526c0167df9a52d",
    "_ZN6dblock17block_kernel_wideILi64ELi1024E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "1f30f36d71f9efc63dfb874e4d5aed755f21ffbc",
    "_ZN6dblock17block_kernel_wideILi64ELi1024E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "cffb416a10b795e0927560f4620ccb0bff4b84e3",
    "_ZN6dblock17block_kernel_wideILi64ELi1024EfLb0ELb0EEEvNS_6ParamsE":
        "f4f0cdff7a6e5a80a370b073d03c308a6d6cb02a",
    "_ZN6dblock17block_kernel_wideILi64ELi1024EfLb0ELb1EEEvNS_6ParamsE":
        "c695e09c328a1116c3ebd814deae73091c8718b2",
    "_ZN6dblock17block_kernel_wideILi64ELi1024EfLb1ELb0EEEvNS_6ParamsE":
        "5d01f7580ed554883868a38b9db67413fd223c1d",
    "_ZN6dblock17block_kernel_wideILi64ELi192E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "6850ae9e3e3f3de50197bf79813d1e32d6b4dbd3",
    "_ZN6dblock17block_kernel_wideILi64ELi192E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "e2cf0c7da9b87044ae87a7dd5efec2d6977f7a13",
    "_ZN6dblock17block_kernel_wideILi64ELi192EfLb0ELb0EEEvNS_6ParamsE":
        "011200892aa03f931a3a68b278af2ab5f5b422e1",
    "_ZN6dblock17block_kernel_wideILi64ELi192EfLb0ELb1EEEvNS_6ParamsE":
        "71a4a44faa32e2db5e28bcd74d147c2212252c46",
    "_ZN6dblock17block_kernel_wideILi64ELi192EfLb1ELb0EEEvNS_6ParamsE":
        "5ef2119da521830e5213fd429a097a21a2e0d3df",
    "_ZN6dblock17block_kernel_wideILi64ELi320E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "e4c8e57c775155109f2bfaad684510feb393376b",
    "_ZN6dblock17block_kernel_wideILi64ELi320E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "af3f2538fec8945ad44a6154ffde4812acd17742",
    "_ZN6dblock17block_kernel_wideILi64ELi320EfLb0ELb0EEEvNS_6ParamsE":
        "8ecb7cc0a8758dab7347800d9f81e836ef812504",
    "_ZN6dblock17block_kernel_wideILi64ELi320EfLb0ELb1EEEvNS_6ParamsE":
        "dfc30510e88342a1792e82fe29ee9be088897553",
    "_ZN6dblock17block_kernel_wideILi64ELi320EfLb1ELb0EEEvNS_6ParamsE":
        "6b6ae3825ca3991aaf4c0148bd6216d80d2dd88c",
    "_ZN6dblock17block_kernel_wideILi64ELi384E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "dfdbf1c194e187419dad4dc94413b2d9ca1acb7c",
    "_ZN6dblock17block_kernel_wideILi64ELi384E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "a3423fc48a18a4c25f0f703211016c4ce0adba43",
    "_ZN6dblock17block_kernel_wideILi64ELi384EfLb0ELb0EEEvNS_6ParamsE":
        "752d9ccb206f1597be9e92a36fabbca55aa658c9",
    "_ZN6dblock17block_kernel_wideILi64ELi384EfLb0ELb1EEEvNS_6ParamsE":
        "66387d3a12f8c7de30e1754d33446069c7c34611",
    "_ZN6dblock17block_kernel_wideILi64ELi384EfLb1ELb0EEEvNS_6ParamsE":
        "2902397077cc9350bba8833ef13a6bf046a3300f",
    "_ZN6dblock17block_kernel_wideILi64ELi512E13__nv_bfloat16Lb0ELb0EEEvNS_6ParamsE":
        "aa753995fae7b9bde2c5a32279c111e1ed354e33",
    "_ZN6dblock17block_kernel_wideILi64ELi512E13__nv_bfloat16Lb1ELb0EEEvNS_6ParamsE":
        "b1be99eb9b4a719a481b686264ccf0f2c2010e92",
    "_ZN6dblock17block_kernel_wideILi64ELi512EfLb0ELb0EEEvNS_6ParamsE":
        "bf61bda5f64cd8389124ba51982bc2b4f50ee63f",
    "_ZN6dblock17block_kernel_wideILi64ELi512EfLb0ELb1EEEvNS_6ParamsE":
        "19a9a424f937753cdef03a68aaad0c7d50f98ae6",
    "_ZN6dblock17block_kernel_wideILi64ELi512EfLb1ELb0EEEvNS_6ParamsE":
        "6d837bdec2f44eea3cf64cad2af1e0fea38f3491",
}


def test_decoder_block_narrow_builds_keep_their_sass(dev):
    """Every entry of the decoder_block library that runs C <= 2048
    compiles to the SASS in NARROW_DBLOCK_SASS, entry by entry."""
    import hashlib
    import subprocess

    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.tools import sass_diff

    _lib.build([("decoder_block", ())])
    text = subprocess.run([sass_diff._cuobjdump(), "-sass",
                           str(_lib._lib_path("decoder_block"))],
                          capture_output=True, text=True, check=True).stdout
    seen = {entry: hashlib.sha1("\n".join(ins).encode()).hexdigest()
            for entry, ins in sass_diff.parse_sass(text).items() if entry in NARROW_DBLOCK_SASS}
    assert seen == NARROW_DBLOCK_SASS, {k: v for k, v in NARROW_DBLOCK_SASS.items()
                                        if seen.get(k) != v}


def _planted_fault_caught(dev, define, c, hp, wp):
    """K2 in the library built with the planted fault `define`, through the
    entry point's padding (bf16 storage, feat and rgb), against the same
    route with the plain version (decoder_block_packed_plain): whether the
    comparison the tests above make (K2_TOL in bf16 storage) fails for any
    output, and the max gaps."""
    from cips3dpp_torch.kernels.decoder_block import (
        _launch, _padded, decoder_block_packed_plain, decoder_block_prepare,
    )

    gen = torch.Generator().manual_seed(c + hp)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    prep = decoder_block_prepare(
        rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1), rnd(c, c) / c**0.5, 0.1 * rnd(c),
        0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5)
    y1 = rnd(hp, wp, c).to(torch.bfloat16)
    got = _padded(lambda x, *a, **k: _launch(x, *a, defines=(define,), **k), y1, prep, True, 1)
    want = decoder_block_packed_plain(y1, prep)
    torch.cuda.synchronize()
    errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    print(f"planted {define}, C={c} y1=({hp},{wp}): max |kernel - plain| {errs}")
    caught = []
    for g, w in zip(got, want):
        try:
            torch.testing.assert_close(g.float(), w.float(), rtol=1.6e-2, atol=2e-2)
            caught.append(False)
        except AssertionError:
            caught.append(True)
    return any(caught), errs


# the staged build with a planted fault (-DDBLOCK_PLANT_RING_FAULT: its
# producer copies a tile's activation chunks without waiting for the
# tile's ready barrier), at y1 (64, 64, 2176), (8, 16, 8320) and
# (2, 16, 16384)
PLANTED = [(2176, 64, 64), (8320, 8, 16), (16384, 2, 16)]


@pytest.mark.parametrize("c,hp,wp", PLANTED, ids=[f"C{c}-{h}x{w}" for c, h, w in PLANTED])
def test_decoder_block_staged_planted_ring_fault_is_caught(dev, c, hp, wp):
    """The planted build launches and returns, and the comparison the tests
    above make against the plain version (K2_TOL in bf16 storage) fails:
    they can catch activation chunks copied before the upsample wrote
    them."""
    caught, errs = _planted_fault_caught(dev, "-DDBLOCK_PLANT_RING_FAULT", c, hp, wp)
    assert caught, errs


# a planted fault in the tail pass (-DDBLOCK_PLANT_TAIL_FAULT: 3 of each
# tail chunk's 4 k16 wgmmas), at each build a tail runs in: C = 272 (run at
# 320, 64-pixel tiles), 1088 (32-pixel tiles) and 2112 (staged)
TAIL_PLANTED = [(272, 16, 16), (1088, 8, 16), (2112, 8, 16)]


@pytest.mark.parametrize("c,hp,wp", TAIL_PLANTED,
                         ids=[f"C{c}-{h}x{w}" for c, h, w in TAIL_PLANTED])
def test_decoder_block_planted_tail_fault_is_caught(dev, c, hp, wp):
    """The build with the tail pass's planted fault launches and returns,
    and the comparison against the plain version at K2_TOL fails: the
    tests can catch a tail pass that drops input channels."""
    caught, errs = _planted_fault_caught(dev, "-DDBLOCK_PLANT_TAIL_FAULT", c, hp, wp)
    assert caught, errs


@pytest.mark.parametrize("mode", MODES[:3], ids=["-".join(m) for m in MODES[:3]])
@pytest.mark.parametrize("c", [2176, 8320])
def test_decoder_block_staged_scratch_holds_the_tiles(dev, c, mode):
    """The staged build writes each tile's conv_b input to its CTA's
    scratch in the layout staged_tiles_plain gives: after a launch on y1
    (2, 32, C), 2 frames of one row (4 tiles, one a CTA of the grid of 4),
    the scratch holds the plain version's upsampled, noised, biased and
    lrelu'd tiles in bf16, a value off by at most one bf16 step where
    another f32 rounding of the blend flips it, and few of them."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    gen = torch.Generator().manual_seed(c)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[mode[0]]
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    hp, wp, frames = 1, 32, 2
    prep = kdb.decoder_block_prepare(
        rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1), rnd(c, c) / c**0.5, 0.1 * rnd(c),
        0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5, dtype=dt,
        noise_seeds=(123, 456) if mode[1] == "hash" else None)
    y1 = rnd(frames * hp, wp, c).to(dt)
    per_cta = kdb.staged_scratch_bytes(c)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.zeros(sms * per_cta, dtype=torch.uint8, device=dev)
    kdb._launch(y1, prep, True, frames, scratch=scratch)
    want = kdb.staged_tiles_plain(y1, prep, frames)
    torch.cuda.synchronize()
    assert want.shape == (4, per_cta // 2)
    got = scratch[:4 * per_cta].view(torch.bfloat16).reshape(want.shape)
    d = (got.float() - want.float()).abs()
    step = 2.0 ** (torch.floor(torch.log2(want.float().abs().clamp_min(2.0**-100))) - 7)
    off = float((d > 0).float().mean())
    print(f"C={c} {'-'.join(mode)}: max |scratch - plain| {float(d.max()):.3e}, share off "
          f"{off:.5f}")
    assert bool((d <= step).all()) and off <= 0.01, (float(d.max()), off)
    assert not scratch[4 * per_cta:].any()  # the grid's 4 CTAs wrote nothing past their own


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


def test_siren_render_gradients_kernel_forward_width_512(dev):
    """SirenRender at width 512, 20 samples (the wide kernel's forward, a
    part chunk): one launch whose outputs are the kernel's, and the
    replayed backward's gradients equal autograd's through the replayed
    function, as at width 256."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels.siren_render import (
        SirenRender, siren_prepare, siren_render_prepared, siren_render_reference,
    )
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(2)
    rend = init_parameters(VolumeFeatureRenderer(depth=2, hidden_dim=512), gen).to(dev)
    r, s = 1001, 20
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


def test_fused_frame_with_a_width_512_renderer(dev):
    """preset_serving with a width-512 renderer (the decoder then takes 512
    input channels): an r1024 frame through prepare_trajectory /
    render_frame launches 1 K1 (the wide kernel) + 4 K2, gives the same
    bits for the same camera, and lies within chip_smoke.py phase 5's
    bounds of the frame through K2's plain version; against the plain
    versions of both kernels its mean gap, K1's bf16 flips through the 14
    bf16 layers, is at most 1.5x the plain path's own: the larger of its
    spread under another GEMM order (F = 4), which holds the frames at
    other multipliers, and under another sum order of K1's products
    (frame_gap_split.k1_sums_reordered); its max at 1.5x the latter's
    where that passes phase 5's 0.5. At width 512 K1's flips move the
    frame 1.7-2.1x as far as the first, through the kernel before this
    design too (python -m cips3dpp_torch.tools.frame_gap_split --width
    512)."""
    import dataclasses

    from cips3dpp_torch import serving
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.kernels import decoder_fused as kdf
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.generator import Generator, preset_serving
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch.tools.frame_gap_split import k1_sums_reordered

    base = preset_serving()
    cfg = dataclasses.replace(base, renderer=dataclasses.replace(base.renderer, hidden_dim=512))
    model = Generator(cfg, device=dev, seed=40)
    randomize_zero_init_(model, torch.Generator().manual_seed(40))
    gen = torch.Generator().manual_seed(41)
    zs = [torch.randn((1, 256), generator=gen).to(dev) for _ in range(2)]
    noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
    prep = serving.prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
    assert "w1c" in prep["siren"]
    yaw, zero = torch.full((1,), 0.2, device=dev), torch.zeros(1, device=dev)
    _lib.reset_launches()
    got = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"siren_render": 1, "decoder_block": 4}
    again = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
    assert torch.equal(got, again)
    saved = serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed
    kdf.decoder_block_packed = lambda y1, prepared, emit_feat=True, frames=1: \
        kdb.decoder_block_plain(y1, prepared, emit_feat, frames)
    try:
        want_k2 = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
        serving.siren_render_prepared = ksr.siren_render_prepared = (
            lambda p, pts, vd, z, d: ksr.siren_render_plain(
                p, pts, vd, z, torch.linalg.norm(d, dim=-1, keepdim=True)))
        want = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
        yaws = torch.cat([yaw, torch.zeros(3, device=dev)])
        own = serving.render_frame(model, prep, yaws, yaws * 0, device=dev)["rgb"][:1]
        with k1_sums_reordered():
            reord = serving.render_frame(model, prep, yaw, zero, device=dev)["rgb"]
    finally:
        serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed = saved
    assert got.shape == (1, 1024, 1024, 3) and torch.isfinite(got).all()
    d_k2, d, d_own, d_reord = ((got - want_k2).abs(), (got - want).abs(), (own - want).abs(),
                               (reord - want).abs())
    spread = max(float(d_own.mean()), float(d_reord.mean()))
    print(f"width-512 frame: to K2's plain {float(d_k2.max()):.3e} / {float(d_k2.mean()):.3e}, "
          f"to the plain kernels {float(d.max()):.3e} / {float(d.mean()):.3e}, the plain "
          f"path's own {float(d_own.max()):.3e} / {float(d_own.mean()):.3e}, with K1's "
          f"products summed in 16-wide slices {float(d_reord.max()):.3e} / "
          f"{float(d_reord.mean()):.3e}")
    assert float(d_k2.max()) <= 0.5 and float(d_k2.mean()) <= 1e-2, float(d_k2.mean())
    assert float(d.max()) <= max(0.5, 1.5 * float(d_reord.max())), float(d.max())
    assert float(d.mean()) <= 1.5 * spread, (float(d.mean()), spread)


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


SYNC_WARNING = "called a synchronizing CUDA operation"


def _sync_warnings(fn):
    """(growth of COUNTS["host_sync"], the place of each synchronising CUDA
    call: its innermost frames in the port) over fn() under
    torch.cuda.set_sync_debug_mode("warn")."""
    import traceback
    import warnings

    from cips3dpp_torch.utils import profiling

    sites = []

    def record(message, *args, **kwargs):
        if SYNC_WARNING in str(message):
            stack = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()[:-1] if "cips3dpp_torch" in f.filename]
            sites.append(" < ".join(reversed(stack[-3:])))

    torch.cuda.synchronize()
    before = profiling.COUNTS["host_sync"]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return profiling.COUNTS["host_sync"] - before, sites


def test_host_syncs_counted_are_the_card_syncs(dev, tmp_path):
    """The port's `host_sync` count against the card: a serving request
    (prepare_trajectory, one render_frame call) and a training iteration
    at a log point (the D step's fakes through K1, a path step), each after
    one of its kind, under torch.cuda.set_sync_debug_mode("warn"): every
    synchronising CUDA call warns once, and the warnings equal the count's
    growth: K1's two constants a prepare, the camera's up vector copied
    from the host a camera, the lanczos scale copied from the host an axis
    of the D step's real thumbnails, the G step's cumprod backward and each
    metric read at the log point."""
    import dataclasses

    import numpy as np

    from cips3dpp_torch import serving
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import Generator, preset_r1024, preset_serving
    from cips3dpp_torch.train import TrainConfig, Trainer, TrainHooks

    def small(base):
        return dataclasses.replace(base, img_size=16, decoder=dataclasses.replace(
            base.decoder, upsample_list=(128,)))

    cfg = small(preset_serving())
    g = Generator(cfg, device=dev, seed=2)
    gen = torch.Generator().manual_seed(3)
    zs = [[torch.randn((1, cfg.mapping.z_dim), generator=gen).to(dev) for _ in range(2)]
          for _ in range(2)]
    noise = g.decoder.make_noise(gen, cfg.img_size, device=dev)
    azim, elev = torch.tensor([0.1, -0.1], device=dev), torch.zeros(2, device=dev)

    def request(z):
        prep = serving.prepare_trajectory(g, z, noise_bufs=noise, truncation=0.7, device=dev)
        serving.render_frame(g, prep, azim, elev, device=dev)

    request(zs[0])
    serve = _sync_warnings(lambda: request(zs[1]))

    cfg = small(preset_r1024())
    tcfg = TrainConfig(batch=2, d_reg_every=16, g_reg_every=4, cam_img_size=16,
                       gen_img_size=32, data_img_size=32)
    tr = Trainer(Generator(cfg, device=dev, seed=4),
                 DStyleGANProgressive(32, 1, device=dev, seed=5),
                 DVolumeRenderProgressive(16, device=dev, seed=6), cfg, tcfg, str(tmp_path),
                 log_every=1)
    state = tr.init_state()
    draws = torch.Generator(device=dev).manual_seed(7)
    images = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    state = tr.train(state, iter([images] * 2), draws, start_iter=2, total_iters=4)
    logged = []
    # iteration 7: a path step and a log point
    train = _sync_warnings(lambda: tr.train(
        state, iter([images]), draws, start_iter=7, total_iters=8,
        hooks=TrainHooks(on_metrics=lambda i, m: logged.append(m))))
    print("serving", serve, "training", train)
    for counted, sites in (serve, train):
        assert len(sites) == counted, sites
    # the prepare's camera and the call's; D, G and path steps' cameras
    assert serve[0] == 2 + 2
    n_metrics = len(logged[0]) - 2  # but alpha and iters_per_sec, host values
    assert train[0] == 2 * 2 + 3 + 2 + 1 + n_metrics


def test_remat_d_lowers_the_r1_step_peak(dev, tmp_path):
    """remat_d lowers the lazy-R1 D step's peak, JAX's reason for it
    (cips3dpp_tpu/train/state.py:71-75): train_r1024 (configs/ffhq.yaml),
    batch 4, f32, one step through Trainer.r1_step_peak on the same weights
    with and without it. A checkpoint of the image D's logit alone raised
    it: R1's input gradient kept the recomputation alive while the
    parameters' backward recomputed the logit again."""
    import dataclasses
    import os

    from cips3dpp_torch.io.config import (
        generator_config_from_dict, load_command_config, train_config_from_dict,
    )
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.train.train_loop import Trainer

    cfg = load_command_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                           "ffhq.yaml"), "train_r1024")
    gcfg, tcfg = generator_config_from_dict(cfg.get("G_cfg", {})), train_config_from_dict(cfg)
    assert tcfg.batch == 4 and not tcfg.remat_d
    g = Generator(gcfg, device=dev, seed=1)
    d = DStyleGANProgressive(1024, 2, device=dev, seed=2)
    d_render = DVolumeRenderProgressive(1024, device=dev, seed=3)
    peaks = {}
    for remat in (False, True, False):
        tr = Trainer(g, d, d_render, gcfg, dataclasses.replace(tcfg, remat_d=remat),
                     str(tmp_path / f"{remat}{len(peaks)}"))
        state = tr.init_state(torch.Generator().manual_seed(4))
        peaks.setdefault(remat, []).append(tr.r1_step_peak(state))
        del state, tr
        torch.cuda.empty_cache()
    print({k: [p / 2**30 for p in v] for k, v in peaks.items()})
    assert max(peaks[True]) < min(peaks[False])


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
