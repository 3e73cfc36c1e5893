"""P1, the elementwise dtype probe: the port's plain chain (what the CUDA
kernel computes bit for bit on the card) against the same chain in jnp,
written here because the TPU probe has no interpret mode.

jnp runs op by op (not jitted), so every product and sum is rounded on
its own in both packages: the chains agree exactly in f32 and in bf16
(measured), and the test holds f32 to 1e-6 and bf16 to equality. A jitted
jnp chain is not the reference: XLA on the CPU contracts x + s*n into one
FMA and moves f32 results by up to 1e-3 relative where the sum cancels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a


def _jnp_chain(x, n):
    from cips3dpp_torch.tools.elem_dtype_probe import CONSTS, REPS

    c = {k: jnp.asarray(v, x.dtype) for k, v in CONSTS.items()}
    for _ in range(REPS):
        v = (x + c["s"] * n) + c["b"]
        x = jnp.maximum(v, c["slope"] * v) * c["sqrt2"]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_chain_matches_jnp(dtype):
    from cips3dpp_torch.tools.elem_dtype_probe import SHAPE, elem_chain

    rng = np.random.default_rng(0)
    shape = (64,) + SHAPE[1:]  # a slice of the probe's (1024, 16, 128)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    n = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    got = elem_chain(x, n)
    assert got.dtype == dt and got.shape == shape
    want = _jnp_chain(jnp.asarray(a(x)).astype(dtype), jnp.asarray(a(n)).astype(dtype))
    atol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(a(got), np.asarray(want, np.float32), rtol=0, atol=atol)
    assert np.abs(a(got)).max() > 100  # 12 passes of lrelu * sqrt2 grow the values


def test_probe_measures_the_card_only():
    from cips3dpp_torch.tools.elem_dtype_probe import probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe()
