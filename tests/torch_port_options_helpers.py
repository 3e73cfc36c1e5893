"""The rank side of tests/test_torch_port_train_options.py's mesh tests.
It imports torch and the port only, so the spawned ranks, which import
their function by name, load no JAX."""

import dataclasses
import time

import torch

# the parallel test's state (tests/test_torch_port_parallel.py: tiny
# generator without an upsample, 8^2 D's with DiffAugment on, batch 4),
# one D step with R1 under SGD(lr=1) per option
MESH_OPTIONS = {"d_cat": dict(d_cat=True), "d_seq": dict(d_seq=True),
                "d_r1_chunk": dict(d_r1_chunk=2), "remat_d": dict(remat_d=True)}


def _mesh_d_steps(mesh, options):
    import test_torch_port_parallel as par
    from cips3dpp_torch.parallel import replicate, shard_batch
    from cips3dpp_torch.train.state import create_train_state
    from cips3dpp_torch.train.steps import make_train_steps

    out = {}
    for name in options:
        gcfg, tcfg, g, d, dr = par._setup()
        tcfg = dataclasses.replace(tcfg, **MESH_OPTIONS[name])
        state = replicate(create_train_state(tcfg, g, d, dr, mesh), mesh)
        par._swap_sgd(state, 1.0)
        real = torch.from_numpy(shard_batch(par._images(par.BATCH), mesh))
        _, m = make_train_steps(gcfg, tcfg, mesh)[0](
            state, real, torch.Generator().manual_seed(par.SEED + 3), 0.5, True)
        out[name] = ({k: float(v) for k, v in m.items()},
                     par._snapshot(state, ("d", "d_render")))
    return out


def _per_rank_stddev(x, group_size=4, num_features=1, split=None, mesh=None):
    """The planted fault: each half's statistic over the rank's rows only."""
    return _ORIGINAL_STDDEV(x, group_size, num_features, split)


_ORIGINAL_STDDEV = None


def _mesh_rank(mesh):
    global _ORIGINAL_STDDEV
    from cips3dpp_torch.models import discriminator

    torch.set_num_threads(1)
    res = {"steps": _mesh_d_steps(mesh, MESH_OPTIONS)}
    _ORIGINAL_STDDEV = discriminator.minibatch_stddev
    discriminator.minibatch_stddev = _per_rank_stddev
    try:
        res["planted"] = _mesh_d_steps(mesh, ("d_cat",))
    finally:
        discriminator.minibatch_stddev = _ORIGINAL_STDDEV
    return res


def _sleep(mesh, seconds):
    """A rank that sleeps `seconds`, rank 1 twice as long (so the ranks
    end apart)."""
    time.sleep(seconds * (1 + mesh.rank))
