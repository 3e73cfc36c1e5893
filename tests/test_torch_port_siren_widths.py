"""K1 at the widths and sample counts only its padded and run-time-width
builds reach: every width from 1 to MAX_WIDTH (2048) and every sample
count, as JAX's kernel takes them. On the CPU: the port's plain version
(what the CUDA kernel computes) against the Pallas kernel in interpret
mode and against the jnp oracle at widths 8, 96, 384 and 1024 and 65 and
96 samples (one sample past K1's 64-sample mark, and a multiple of its 8-
and 24-sample chunks); the zero-padded operands `siren_prepare` makes
against the unpadded ones; and the wide kernel's chunked weight layout
at widths past 512. The kernel itself runs on the card only
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
    """At the run-time-width builds' widths the chunked weight is
    (W / 128) passes x (W / 64) chunks of 128 output x 64 input features,
    and undoes to the (out, in) bf16 weight bit for bit."""
    prep = _prepared(width, seed=width)
    flat, w = prep[field], prep[source]
    assert flat.shape == (width * width,) and flat.dtype == torch.bfloat16
    assert torch.equal(_unchunk(flat, width), w)
