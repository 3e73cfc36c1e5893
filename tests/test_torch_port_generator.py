"""The whole generator: the port's Generator.forward (unfused, f32) against
the flax Generator.apply with the same weights carried across by the
weight bridge, at a small-but-real config (depth-2 SIREN of width 64, two
upsample blocks to 64², 16² rays x 12 samples). Also the bridge itself
against the JAX package's exporter.

Both sides run the same f32 formulas, so the comparison is tight: the
residue is f32 summation order, amplified by gamma ~ 30-45 in the SIREN's
sin (measured max |diff| about 1e-5 on rgb).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, port_and_jax_generator, t


def _configs():
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=2, hidden_dim=64),
            decoder=m.DecoderConfig(upsample_list=(128, 256), style_dim=128),
            img_size=16, n_samples=12,
        )

    return jg, make(jg), tg, make(tg)


@pytest.fixture(scope="module")
def models():
    """Seeded port weights (nonzero noise weights and biases) -> flax
    variables -> back through the bridge into a second port model, which
    is the one compared."""
    from cips3dpp_torch.io.jax_params import load_jax_params

    jg, jcfg, tg, tcfg = _configs()
    _, variables = port_and_jax_generator(jcfg, tcfg, seed=5)
    tmodel = load_jax_params(tg.Generator(tcfg, device="cpu", seed=99),
                             np_tree(variables["params"]))
    return jg.Generator(jcfg), variables, tmodel


def _inputs(model_cfg, seed, b=2):
    from cips3dpp_tpu.models.decoder import Decoder

    rng = np.random.default_rng(seed)
    zs = [rng.standard_normal((b, 256)).astype(np.float32) for _ in range(2)]
    azim = (0.3 * rng.standard_normal(b)).astype(np.float32)
    elev = (0.15 * rng.standard_normal(b)).astype(np.float32)
    dec = Decoder(upsample_list=model_cfg.decoder.upsample_list)
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in dec.noise_shapes(model_cfg.img_size)]
    return zs, azim, elev, noise


def test_weight_bridge_matches_exporter(models):
    from cips3dpp_tpu.io.torch_import import export_generator_state_dict
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict

    _, variables, tmodel = models
    want = export_generator_state_dict(variables)
    got = jax_params_to_state_dict(variables["params"])
    assert sorted(got) == sorted(want)
    mine = tmodel.state_dict()
    assert sorted(mine) == sorted(want)  # module names == reference names
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape == tuple(mine[k].shape), k
        np.testing.assert_array_equal(a(mine[k]), np.asarray(w, np.float32), err_msg=k)


@pytest.mark.parametrize("truncation", [1.0, 0.7])
def test_forward_matches_flax(models, truncation):
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_torch.core.camera import camera_from_angles

    jmodel, variables, tmodel = models
    cfg = jmodel.cfg
    zs, azim, elev, noise = _inputs(cfg, seed=int(truncation * 10))
    mean = None
    if truncation != 1.0:
        rng = np.random.default_rng(3)
        mean = (rng.standard_normal((1, 256)).astype(np.float32),
                rng.standard_normal((1, 128)).astype(np.float32))
    jc = jcam(jnp.asarray(azim), jnp.asarray(elev), cfg.img_size)
    apply = jax.jit(lambda v, zs, noise, mean: jmodel.apply(
        v, zs=zs, cam_poses=jc.extrinsics, focals=jc.focal, near=jc.near,
        far=jc.far, truncation=truncation, mean_latents=mean,
        noise_bufs=noise, perturb=False,
    ))
    want = apply(variables, tuple(jnp.asarray(z) for z in zs),
                 [jnp.asarray(n) for n in noise], mean)
    c = camera_from_angles(t(azim), t(elev), cfg.img_size)
    with torch.no_grad():
        got = tmodel(
            [t(z) for z in zs], c.extrinsics, c.focal, c.near, c.far,
            truncation=truncation,
            mean_latents=None if mean is None else tuple(t(m) for m in mean),
            noise_bufs=[t(n) for n in noise], perturb=False,
        )
    assert got["rgb"].shape == (2, 64, 64, 3)
    for k in ("rgb", "thumb_rgb", "sdf", "mask", "depth", "xyz"):
        np.testing.assert_allclose(a(got[k]), a(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_map_zs_inject_index_matches_flax(models):
    jmodel, variables, tmodel = models
    rng = np.random.default_rng(9)
    zs = [rng.standard_normal((1, 256)).astype(np.float32) for _ in range(3)]
    want = jmodel.apply(variables, zs, 1.0, None, 5, method="map_zs")
    with torch.no_grad():
        got = tmodel.map_zs([t(z) for z in zs], inject_index=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(a(g), a(w), rtol=1e-5, atol=1e-5)
