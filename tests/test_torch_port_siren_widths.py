"""K1 at the widths and sample counts only its padded and run-time-width
builds reach: every width >= 1 and every sample count, as JAX's kernel
takes them. On the CPU: the port's plain version (what the CUDA kernel
computes) against the Pallas kernel in interpret mode and against the
jnp oracle at widths 8, 96, 384 and 1024 and 65 and 96 samples (one
sample past K1's 64-sample mark, and a multiple of its 8- and 24-sample
chunks), and past 2048 at 2176 and 2200 (padded to 2304); the
zero-padded operands `siren_prepare` makes against the unpadded ones;
the build every width and sample count gets; and the wide kernel's
chunked weight layout and its activation staging layout at widths past
512. The kernel itself runs on the card only
(tests/test_torch_port_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_siren import ATOL_KERNEL, ATOL_ORACLE, NAMES, _make_renderer_params
from test_torch_port_siren_wide import _prepared, _unchunk
from torch_port_helpers import a, np_tree, port_renderer, t

# Per width, against the Pallas kernel and against the oracle: the
# tolerances of test_torch_port_siren.py, set at width 128, hold at 96,
# 384 and 1024 with the weights' std at 0.05 * sqrt(128 / W) (measured max
# |diff| to the Pallas kernel: feat 5.2e-2 at W = 96, S = 96; 2.8e-2 at
# 1024). At width 8 that std is 0.2, so each of the sdf head's 8 terms is
# 4x the fixture's and a bf16 flip of h moves sdf 4x as far: the port lies
# 9.9e-3 from the Pallas kernel there and the Pallas kernel itself 2.2e-2
# from the oracle, so sdf is held at 2e-2 / 4e-2.
TOL = {w: (ATOL_KERNEL, ATOL_ORACLE) for w in (96, 384, 1024)}
TOL[8] = ({**ATOL_KERNEL, "sdf": 2e-2}, {**ATOL_ORACLE, "sdf": 4e-2})


def _inputs(width, s, r):
    rng = np.random.default_rng(width + s)
    vd = rng.standard_normal((r, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return (rng.standard_normal((3, 256)).astype(np.float32),
            (0.1 * rng.standard_normal((r, s, 3))).astype(np.float32), vd,
            (np.linspace(0.88, 1.12, s)[None] + 1e-3 * rng.standard_normal((r, 1))).astype(
                np.float32),
            (1.05 * vd).astype(np.float32), np.float32(0.88), np.float32(1.12))


def _compare(got, want, atol, what):
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), (name, g.shape, w.shape)
        d = float(np.abs(a(g) - a(w)).max())
        assert d <= atol[name], f"{what} {name}: max |diff| {d:.3g} > {atol[name]}"


@pytest.mark.parametrize("s", [65, 96])
@pytest.mark.parametrize("width", [8, 96, 384, 1024])
def test_plain_matches_pallas_and_oracle_at_padded_widths(width, s):
    """K1's plain version on the operands padded to its build's width (32,
    128, 512, 1024), feat at the renderer's width, against JAX's Pallas
    kernel (interpret mode) and the jnp oracle, 64 rays."""
    from cips3dpp_tpu.kernels.siren_render import siren_render_fused as jfused
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.kernels.siren_render import kernel_build, siren_render_fused

    r = 64
    params = _make_renderer_params(jax.random.PRNGKey(width + s), width,
                                   scale=0.05 * (128 / width) ** 0.5)
    jargs = _inputs(width, s, r)
    jx = [jnp.asarray(x) for x in jargs]
    with torch.no_grad():
        got = siren_render_fused(port_renderer(np_tree(params), width), *(t(x) for x in jargs))
    assert got[1].shape == (r, width) and kernel_build(width, s).width >= width
    tol_kernel, tol_oracle = TOL[width]
    _compare(got, jfused(params, *jx, ray_tile=r, interpret=True), tol_kernel, "Pallas")
    _compare(got, jref(params, *jx), tol_oracle, "oracle")


@pytest.mark.parametrize("width", [8, 96, 200, 384, 700])
def test_padded_prepare_matches_unpadded(width):
    """`siren_prepare` pads every folded operand to the build's width with
    zeros; the plain version on the padded operands (feat sliced to the
    renderer's width) against it on the unpadded ones, model init, 64 rays
    x 24 samples. A padded unit's sine is exactly 0 and meets zero weight
    rows, so only the f32 order of the real terms' sums can differ
    (measured: 0 to 3.3e-5, at 700 wide); a bf16 flip of an activation
    would move an output by ~1e-3, so the bound is 1e-4."""
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    kw = ksr.kernel_build(width, 24).width
    rng = np.random.default_rng(width)
    r, s = 64, 24
    pts = torch.from_numpy((0.1 * rng.standard_normal((r, s, 3))).astype(np.float32))
    vd = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((r, 3)).astype(np.float32)), dim=-1)
    z = torch.from_numpy((np.linspace(0.88, 1.12, s)[None]
                          + 1e-3 * rng.standard_normal((r, 1))).astype(np.float32))
    dnorm = torch.linalg.norm(1.05 * vd, dim=-1, keepdim=True)
    gen = torch.Generator().manual_seed(width)
    rend = init_parameters(VolumeFeatureRenderer(depth=2, hidden_dim=width), gen)
    styles = torch.randn((3, 256), generator=gen)
    near, far = torch.tensor(0.88), torch.tensor(1.12)
    padded = ksr.siren_prepare(rend, styles, near, far)
    assert kw > width and padded["width"] == width and padded["weights"][3].shape == (kw, kw)
    assert ("w1c" in padded) == (kw >= ksr.WIDE_WIDTH)
    # the padding is zeros around the unpadded folds, which are its corner
    with torch.no_grad():
        folds = [w.float() for w in ksr._pack_siren_params(rend.network, styles)]
    for p, u in zip(padded["weights"], folds):
        corner = tuple(slice(0, n) for n in u.shape)
        rest = p.clone()
        rest[corner] = 0
        assert torch.equal(p[corner], u) and not rest.any()
    plain = {**padded, "weights": tuple(folds)}
    with torch.no_grad():
        got = ksr.siren_render_plain(padded, pts, vd, z, dnorm)
        want = ksr.siren_render_plain(plain, pts, vd, z, dnorm)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4, msg=name)


@pytest.mark.parametrize("field,source", [("w1c", "w1t"), ("wvhc", "wvht")])
@pytest.mark.parametrize("width", [640, 1024, 2048])
def test_wide_weight_chunks_invert_past_512(width, field, source):
    """At the run-time-width build's widths the chunked weight is
    (W / 128) passes x (W / 64) chunks of 128 output x 64 input features,
    and undoes to the (out, in) bf16 weight bit for bit."""
    prep = _prepared(width, seed=width)
    flat, w = prep[field], prep[source]
    assert flat.shape == (width * width,) and flat.dtype == torch.bfloat16
    assert torch.equal(_unchunk(flat, width), w)


@pytest.mark.parametrize("width", [2176, 2200])
def test_plain_matches_pallas_and_oracle_past_2048(width):
    """Past the width 2048 that was once K1's ceiling: the plain version on
    the operands padded to the run-time-width build's width (2176, 2304)
    against JAX's Pallas kernel (interpret mode) and the jnp oracle, 16
    rays x 12 samples (a full and a part 8-sample unit), at the
    tolerances of the narrower widths above (measured max |diff| of feat
    2.6e-2 / 1.4e-2 to the Pallas kernel and 5.8e-2 / 6.5e-2 to the
    oracle at 2176 / 2200, against 6e-2 and 1.5e-1)."""
    from cips3dpp_tpu.kernels.siren_render import siren_render_fused as jfused
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.kernels.siren_render import kernel_build, siren_render_fused

    r, s = 16, 12
    params = _make_renderer_params(jax.random.PRNGKey(width), width,
                                   scale=0.05 * (128 / width) ** 0.5)
    jargs = _inputs(width, s, r)
    jx = [jnp.asarray(x) for x in jargs]
    with torch.no_grad():
        got = siren_render_fused(port_renderer(np_tree(params), width), *(t(x) for x in jargs))
    assert got[1].shape == (r, width) and kernel_build(width, s).width == -(-width // 128) * 128
    _compare(got, jfused(params, *jx, ray_tile=r, interpret=True), ATOL_KERNEL, "Pallas")
    _compare(got, jref(params, *jx), ATOL_ORACLE, "oracle")


@pytest.mark.parametrize("width,s", [(513, 1), (2048, 24), (2049, 24), (2176, 96), (4096, 24),
                                     (4097, 300)])
def test_every_width_has_a_build(width, s):
    """No width ceiling: every width past 512 runs in the run-time-width
    build at the next multiple of 128 and any sample count, with a
    scratch of 256 bytes a feature a CTA (its h0 and h1 tiles); only a
    count below 1 is refused."""
    from cips3dpp_torch.kernels import siren_render as ksr

    kw = -(-width // 128) * 128
    assert ksr.kernel_build(width, s) == (kw, (ksr.RUN_TIME_WIDTH_DEFINE, "-DK1_FIXED_S=0"))
    assert ksr.kernel_defines(width, s) == (ksr.RUN_TIME_WIDTH_DEFINE, "-DK1_FIXED_S=0")
    assert ksr.wide_scratch_bytes(kw) == 2 * 64 * kw * 2
    assert isinstance(ksr.kernel_build(width, 0), str)
    assert ("siren_render", (ksr.RUN_TIME_WIDTH_DEFINE, "-DK1_FIXED_S=0")) in ksr.kernel_builds()


@pytest.mark.parametrize("width", [640, 2176])
def test_activation_staging_layout_is_the_weight_chunks_swizzle(width):
    """The run-time-width build stages h0 and h1 in its scratch as W / 64
    K-chunks of 64 rows x 64 features (`wide_activation_layout`), with the
    swizzle of the weight chunks: chunk k of a 64-row tile is the first 64
    rows of the first pass's weight chunk k of a square matrix whose first
    64 rows are the tile. It undoes to the tile bit for bit, and a few 16-byte groups sit
    where the kernel's act_offset(row, k) puts them."""
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.kernels.decoder_block import chunk_weight

    gen = torch.Generator().manual_seed(width)
    h = torch.randn((64, width), generator=gen).to(torch.bfloat16)
    flat = ksr.wide_activation_layout(h)
    assert flat.shape == (64 * width,) and flat.dtype == torch.bfloat16
    chunks = flat.reshape(width // 64, 64, 64)
    w = torch.cat([h, torch.zeros((width - 64, width), dtype=h.dtype)])  # (out, in)
    wchunks = chunk_weight(w).reshape(width // 128, width // 64, 128, 64)
    assert torch.equal(chunks, wchunks[0, :, :64])
    # undone: row n's 16-byte group j sits at j ^ (n % 8)
    groups = chunks.reshape(width // 64, 64, 8, 8)
    back = torch.stack([groups[:, n, [j ^ (n % 8) for j in range(8)]] for n in range(64)], 1)
    assert torch.equal(back.permute(1, 0, 2, 3).reshape(64, width), h)
    for row, k in ((0, 0), (13, 72), (63, width - 8)):
        off = (k >> 6) * 64 * 128 + row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4)
        assert torch.equal(flat[off // 2:off // 2 + 8], h[row, k:k + 8])


def test_activation_staging_layout_holds_every_value_once():
    """The staging layout is a permutation of the tile's positions."""
    from cips3dpp_torch.kernels import siren_render as ksr

    width = 768
    pos = torch.arange(64 * width).reshape(64, width)
    # bf16 holds integers exactly only to 256: three base-64 digits apart
    placed = sum(64**d * ksr.wide_activation_layout((pos // 64**d % 64).to(torch.bfloat16)).long()
                 for d in range(3))
    assert torch.equal(torch.sort(placed).values, torch.arange(64 * width))
