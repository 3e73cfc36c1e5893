"""Shared pieces of the training parity tests
(tests/test_torch_port_train_*.py): the tiny configuration of
tests/test_train.py, seeded port discriminators with the same weights as
flax variables, and the gradient comparison.

Weights are drawn by the port from a seed (its zero-initialised biases
set to draws, so the bias paths count) and carried into the JAX package
through its own importers of reference state dicts; templates come from
jax.eval_shape, so no flax init runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import a

# Tolerances. Forward values: both sides run f32 (JAX at "highest" matmul
# precision), so the residue is f32 summation order: rtol 1e-5, atol 1e-5
# where values cross zero. Gradients: within REL of the largest |gradient|
# of their tensor, the same residue after a backward pass.
FWD = dict(rtol=1e-5, atol=1e-5)
REL = 1e-4


def k1_off_card(monkeypatch):
    """The train steps' fused flags reach K1's plain version on the CPU,
    where their default route renders plainly (as the JAX package's does
    off the TPU): the route takes K1 wherever its geometry allows."""
    from cips3dpp_torch.kernels.siren_render import kernel_route_refusal
    from cips3dpp_torch.train import steps

    def route(*args):
        why = kernel_route_refusal(*args)
        return why is None, why

    monkeypatch.setattr(steps, "default_kernel_route", route)


def assert_rel(got, want, rel=REL, name=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = a(got), a(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max err {err:.3e} > {rel} x {scale:.3e}"


def tiny_configs(img_size=8, upsample_list=(128,), n_samples=4):
    """tests/test_models.py:tiny_config for both packages: depth-2 SIREN of
    width 32, decoder style_dim 64 with 2 mapping layers."""
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=2, hidden_dim=32),
            decoder=m.DecoderConfig(channel_multiplier=2, kernel_size=1,
                                    upsample_list=upsample_list, style_dim=64,
                                    mapping_n_layers=2),
            img_size=img_size, n_samples=n_samples)

    return make(jg), make(tg)


def port_and_jax_d(seed: int, input_size=1024, channel_multiplier=1):
    """(flax module, its params, port module) of DStyleGANProgressive with
    the same weights."""
    from cips3dpp_tpu.io.torch_import import import_d_stylegan_state_dict
    from cips3dpp_tpu.models.discriminator import DStyleGANProgressive as JD
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.layers import randomize_zero_init_

    td = DStyleGANProgressive(input_size, channel_multiplier, device="cpu", seed=seed)
    randomize_zero_init_(td, torch.Generator().manual_seed(seed))
    jd = JD(input_size=input_size, channel_multiplier=channel_multiplier)
    tmpl = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    sd = {k: v.numpy() for k, v in td.state_dict().items()}
    return jd, import_d_stylegan_state_dict(sd, tmpl)["params"], td


def port_and_jax_pose_d(seed: int, input_size=64):
    """(flax module, its params, port module) of DVolumeRenderProgressive."""
    from cips3dpp_tpu.io.torch_import import import_d_pose_state_dict
    from cips3dpp_tpu.models.discriminator_pose import DVolumeRenderProgressive as JP
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive

    tp = DVolumeRenderProgressive(input_size, device="cpu", seed=seed)
    jp = JP(input_size=input_size)
    tmpl = jax.eval_shape(jp.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    sd = {k: v.numpy() for k, v in tp.state_dict().items()}
    return jp, import_d_pose_state_dict(sd, tmpl)["params"], tp


def grads_by_name(model, loss):
    """{parameter name: d loss / d parameter}, zeros where unused."""
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g)
            for n, p, g in zip(names, model.parameters(), gs)}
