"""How far JAX's own f32 gradients of a tiny generator move between its
jitted and its eager evaluation, beside the port's distance from each.

The gradient is that of the image-D GAN term of a G step (decoder and
renderer parameters; the noise weights left out, as the step tests hold
them apart), in the configuration of test_torch_port_train_options.build.
Where JAX's two evaluations of one function lie far apart, the function is
ill-conditioned in f32 at that size, and a parity bound below that gap
would test rounding, not the port: the density and k x k step tests take
their gradient bounds from this script's output.

    JAX_PLATFORMS=cpu python tests/torch_port_jit_gap.py SEED sdf|density K

prints the two largest gaps (over each tensor's largest |gradient|) of
jit against eager, the port against eager, and the port against jit.
The eager evaluation takes about 40 s on the CPU.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_port_train_options as opts  # noqa: E402
from torch_port_helpers import a  # noqa: E402


def gaps(seed: int, with_sdf: bool, kernel_size: int) -> dict:
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict

    s = opts.build(seed=seed, with_sdf=with_sdf, kernel_size=kernel_size)
    noise, _, draws = opts.inputs(s, jax.random.PRNGKey(4), 4, 4)
    cam = draws.cam
    pd = jax.tree.map(jnp.asarray, s["pd"])
    p0 = jax.tree.map(jnp.asarray, s["pg"])

    def loss(p):
        o = JG(s["jcfg"]).apply(
            {"params": p}, zs=tuple(jnp.asarray(a(z)) for z in draws.zs),
            cam_poses=jnp.asarray(a(cam.extrinsics)), focals=jnp.asarray(a(cam.focal)),
            near=jnp.asarray(a(cam.near)), far=jnp.asarray(a(cam.far)),
            noise_bufs=[jnp.asarray(n) for n in noise], perturb=False)
        return jnp.mean(jax.nn.softplus(-s["jd"].apply({"params": pd}, o["rgb"], opts.ALPHA)))

    def by_name(tree):
        return jax_params_to_state_dict(jax.tree.map(np.asarray, tree))

    eager = by_name(jax.grad(loss)(p0))
    jit = by_name(jax.jit(jax.grad(loss))(p0))
    g = s["g"]
    out = g(zs=draws.zs, cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near,
            far=cam.far, noise_bufs=draws.noise, t_rand=draws.t_rand)
    l = torch.nn.functional.softplus(-s["d"](out["rgb"], opts.ALPHA)).mean()
    names = [n for n, _ in g.named_parameters()]
    port = {n: v for n, v in zip(names, torch.autograd.grad(l, list(g.parameters()),
                                                             allow_unused=True))
            if v is not None}

    def worst(x, ref):
        e = []
        for k in x:
            if k.endswith("noise.weight"):
                continue
            w = a(ref[k])
            e.append((float(np.abs(a(x[k]) - w).max() / max(np.abs(w).max(), 1e-12)), k))
        return sorted(e)[-2:]

    return {"jit vs eager": worst(jit, eager), "port vs eager": worst(port, eager),
            "port vs jit": worst(port, jit)}


if __name__ == "__main__":
    seed, mode, k = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
    for name, worst in gaps(seed, mode == "sdf", k).items():
        print(name, worst)
