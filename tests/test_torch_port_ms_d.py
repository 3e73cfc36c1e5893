"""The multi-scale discriminator (models/discriminator_multi_scale.py)
against the JAX package's on the CPU: one set of parameters, carried from
flax by `io/jax_params.py:jax_ms_d_params_to_state_dict`, takes inputs of
16^2 and 32^2 at alpha 0.5 and 1.0; the R1 penalty and its gradient with
respect to every parameter against jax.grad.

Bounds: the logits at rtol 1e-4, atol 1e-5 (f32 convolutions summed in
other orders through four ResBlocks); the R1 penalty at rtol 1e-5 and
each parameter's gradient within 1e-4 of its largest |value|, the image
D's bounds (tests/test_torch_port_train_modules.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, t

LOGIT = dict(rtol=1e-4, atol=1e-5)
REL_R1 = 1e-4


@pytest.fixture(scope="module")
def ms_d():
    """(flax module, its params with nonzero activation biases, the port's
    module with the same weights)."""
    from cips3dpp_tpu.models.discriminator_multi_scale import DiscriminatorMultiScale as JMS
    from cips3dpp_torch.io.jax_params import jax_ms_d_params_to_state_dict
    from cips3dpp_torch.models.discriminator_multi_scale import DiscriminatorMultiScale

    jd = JMS(max_size=32, channel_multiplier=1)
    variables = jd.init(jax.random.PRNGKey(0), jnp.zeros((4, 32, 32, 3)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("['act_bias']", "['bias']")) else v,
        np_tree(variables["params"]))
    td = DiscriminatorMultiScale(32, 1, device="cpu", seed=5)
    td.load_state_dict(jax_ms_d_params_to_state_dict(params), strict=True)
    return jd, jax.tree.map(jnp.asarray, params), td


CASES = [(16, 0.5), (16, 1.0), (32, 0.5), (32, 1.0)]


@pytest.mark.parametrize("size,alpha", CASES, ids=[f"{s}-alpha{al}" for s, al in CASES])
def test_ms_d_matches_jax(ms_d, size, alpha):
    jd, params, td = ms_d
    x = np.random.default_rng(size).standard_normal((4, size, size, 3)).astype(np.float32)
    want, wl, wp = jd.apply({"params": params}, jnp.asarray(x), alpha)
    with torch.no_grad():
        got, gl, gp = td(t(x), alpha)
    assert gl is None and gp is None and wl is None and wp is None
    assert got.shape == (4, 1)
    np.testing.assert_allclose(a(got), a(want), **LOGIT)


@pytest.mark.parametrize("size", [16, 32])
def test_ms_d_r1_matches_jax(ms_d, size):
    """The R1 penalty (train/losses.py) at alpha 0.5, and its gradient
    with respect to every D parameter (grad of grad) against jax.grad of
    JAX's r1_penalty."""
    from cips3dpp_tpu.train.losses import r1_penalty as jr1
    from cips3dpp_torch.io.jax_params import jax_ms_d_params_to_state_dict
    from cips3dpp_torch.train.losses import r1_penalty
    from torch_port_train_helpers import assert_rel, grads_by_name

    jd, params, td = ms_d
    x = (0.5 * np.random.default_rng(size + 1).standard_normal((4, size, size, 3))
         ).astype(np.float32)
    xt = t(x).requires_grad_(True)
    r1 = r1_penalty(td(xt, 0.5)[0], xt)
    jfn = lambda p: jr1(lambda im: jd.apply({"params": p}, im, 0.5)[0], jnp.asarray(x))
    jval, jgrads = jax.jit(jax.value_and_grad(jfn))(params)
    np.testing.assert_allclose(float(r1.detach()), float(jval), rtol=1e-5)
    want = jax_ms_d_params_to_state_dict(np_tree(jgrads))
    for name, g in grads_by_name(td, r1).items():
        assert_rel(g, want[name], rel=REL_R1, name=name)


def test_ms_d_state_dict_names():
    """The port's names follow the JAX tree: a 1x1 input conv for every
    resolution of the channel table, a ResBlock for each from max_size
    down to 8, and the head; a diffaug D wants its draws."""
    from cips3dpp_torch.models.discriminator_multi_scale import DiscriminatorMultiScale

    td = DiscriminatorMultiScale(32, 1, diffaug=True, device="cpu")
    keys = td.state_dict().keys()
    assert {k.split(".")[1] for k in keys if k.startswith("conv_in.")} == \
        {"4", "8", "16", "32", "64", "128", "256", "512", "1024"}
    assert {k.split(".")[1] for k in keys if k.startswith("blocks.")} == {"8", "16", "32"}
    assert {"final_conv.0.weight", "space_linear.weight", "out_linear.bias"} <= set(keys)
    with pytest.raises(ValueError, match="draws"):
        td(torch.zeros((2, 16, 16, 3)))
