"""The mesh's ray axis in cips3dpp_torch (parallel/mesh.py: make_mesh(ray=k),
shard_rays, gather_rays) on the CPU, against the JAX package's unsharded
render (the port's form of tests/test_mesh_equivalence.py::
test_ray_sharded_render_equivalence).

Two spawns of gloo ranks (parallel.run_ranks): data 1 x ray 2 and data 2
x ray 2. Each rank renders its batch rows and its half of the rays of the
same numpy inputs (a depth-2 SDF renderer of width 32, 8^2 rays x 4
samples, batch 4, tests/test_torch_port_siren.py's random tree) through
K1's route (its plain version on the CPU), and the ray axis gathers the
render. The gathered render is held to the port's one-process render at
JAX's own bound for its sharded render, rtol 1e-5 / atol 1e-6 (rays are
independent, so it is bit-equal), and to JAX's unsharded
siren_render_reference at tests/test_torch_port_siren.py's bound for K1's
plain version against that oracle (the two packages' sums differ in
order, and bf16 flips move feat by up to 3.6e-2 at this size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_siren import ATOL_ORACLE, NAMES, _make_renderer_params
from torch_port_helpers import a, np_tree, port_renderer, t

WIDTH, B, R, S = 32, 4, 64, 4
MESHES = {"data1-ray2": (2, 2), "data2-ray2": (4, 2)}


def _inputs():
    rng = np.random.default_rng(0)
    vd = rng.standard_normal((B, R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return {
        "pts": (0.1 * rng.standard_normal((B, R, S, 3))).astype(np.float32),
        "viewdirs": vd,
        "z_vals": (np.linspace(0.88, 1.12, S)[None, None]
                   + 1e-3 * rng.standard_normal((B, R, 1))).astype(np.float32),
        "rays_d": (1.05 * vd).astype(np.float32),
        "styles": rng.standard_normal((3, 256)).astype(np.float32),
        "near": np.array(0.88, np.float32), "far": np.array(1.12, np.float32),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from cips3dpp_torch.parallel import run_ranks
    from torch_port_ray_helpers import _ray_render_rank

    params = _make_renderer_params(jax.random.PRNGKey(0), WIDTH)
    renderer = port_renderer(np_tree(params), WIDTH)
    sd = {k: v.numpy() for k, v in renderer.state_dict().items()}
    inputs = _inputs()
    runs = {name: run_ranks(_ray_render_rank, world, sd, WIDTH, inputs, device="cpu",
                            ray=ray, workdir=str(tmp_path_factory.mktemp(name)), timeout=240)
            for name, (world, ray) in MESHES.items()}
    return params, renderer, inputs, runs


def _one_process(renderer, inputs):
    x = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    with torch.no_grad():
        return renderer(x["pts"], x["rays_d"], x["viewdirs"], x["z_vals"],
                        x["near"].expand(B, 1, 1), x["far"].expand(B, 1, 1),
                        x["styles"][None].expand(B, 3, 256), fused=True)[:5]


def _jax_unsharded(params, inputs):
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref

    near, far = jnp.asarray(inputs["near"]), jnp.asarray(inputs["far"])
    styles = jnp.asarray(inputs["styles"])
    f = jax.vmap(lambda p, v, z, d: jref(params, styles, p, v, z, d, near, far))
    return f(*(jnp.asarray(inputs[k]) for k in ("pts", "viewdirs", "z_vals", "rays_d")))


@pytest.mark.parametrize("name", list(MESHES))
def test_ray_sharded_render_equivalence(setup, name):
    params, renderer, inputs, runs = setup
    world, ray = MESHES[name]
    ranks = runs[name]
    assert [(r["data_rank"], r["ray_rank"]) for r in ranks] == [
        (i // ray, i % ray) for i in range(world)]
    rows = B // (world // ray)
    # every rank of a data row holds that row's batch rows, all rays
    got = [torch.cat([ranks[d * ray]["render"][k] for d in range(world // ray)])
           for k in range(5)]
    for r in ranks:
        d = r["data_rank"]
        for k in range(5):
            assert torch.equal(r["render"][k], got[k][d * rows:(d + 1) * rows])
        # the five outputs, y, and shard_rays's backward
        assert r["counts"]["ray_all_gather"] == 5 + 1 + 1
    one = _one_process(renderer, inputs)
    want = _jax_unsharded(params, inputs)
    for n, g, o, w in zip(NAMES, got, one, want):
        assert g.shape == o.shape and np.isfinite(a(g)).all(), n
        np.testing.assert_allclose(a(g), a(o), rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(a(g), a(w).reshape(a(g).shape), rtol=0,
                                   atol=ATOL_ORACLE[n], err_msg=n)


@pytest.mark.parametrize("name", list(MESHES))
def test_data_collectives_on_a_ray_mesh(setup, name):
    """On a ray mesh the batch gathers, gradients sync and global means run
    over the data axis only: each example once, the ray replicas apart.
    A rank's values are ray_rank + 1 + data_rank."""
    world, ray = MESHES[name]
    n_data = world // ray
    for r in setup[3][name]:
        c = r["collectives"]
        own = torch.full((2, 3), float(r["ray_rank"] + 1))
        column = [own + d for d in range(n_data)]  # the ranks of its ray index
        assert torch.equal(c["gathered"], torch.cat(column))
        assert torch.equal(c["synced"], sum(column) / n_data)
        assert torch.equal(c["mean"], sum(x.sum() for x in column) / n_data)


@pytest.mark.parametrize("name", list(MESHES))
def test_gather_rays_is_differentiable(setup, name):
    """y = gather_rays(3 * shard_rays(x)) on a replicated x: y = 3x, and
    the gradient of sum(y^2) is 18x, as in one process."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    for r in setup[3][name]:
        assert torch.equal(r["y"], 3.0 * x)
        assert torch.equal(r["gx"], 18.0 * x)


def test_shard_rays_off_the_mesh_and_uneven():
    """Off the mesh both are the identity; rays that do not split over the
    ray axis raise."""
    import types

    from cips3dpp_torch.parallel import gather_rays, shard_rays

    x = t(np.ones((2, 6, 3)))
    assert shard_rays(x, None) is x and gather_rays(x, None) is x
    mesh = types.SimpleNamespace(ray=4, ray_rank=1)
    with pytest.raises(ValueError, match="6 rays do not split over a ray axis of 4"):
        shard_rays(x, mesh)
