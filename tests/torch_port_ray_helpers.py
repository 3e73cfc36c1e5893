"""The rank side of the ray-mesh tests (tests/test_torch_port_ray_mesh.py,
tests/test_torch_port_parallel.py::test_mesh_options_raise and
tests/test_torch_port_train_loop.py::test_not_ported_options_raise). It
imports torch and the port only, so the spawned ranks, which import their
function by name, load no JAX."""

import torch


def _ray_axes(mesh):
    """The rank's place on the mesh."""
    return {"rank": mesh.rank, "data": mesh.data, "ray": mesh.ray,
            "data_rank": mesh.data_rank, "ray_rank": mesh.ray_rank}


def _renderer(state_dict, width):
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    r = VolumeFeatureRenderer(depth=2, hidden_dim=width)
    r.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    return r


def _ray_render_rank(mesh, state_dict, width, inputs):
    """The rank's batch rows (data axis) and rays (ray axis) of `inputs`
    rendered through K1's route (its plain version here), gathered over
    the ray axis; the data collectives on rank-dependent values; and the
    gradients through shard_rays and gather_rays of a replicated input."""
    from cips3dpp_torch.parallel import (
        all_gather_batch, gather_rays, global_mean, shard_batch, shard_rays, sync_grads,
    )

    torch.set_num_threads(1)
    pts, viewdirs, z_vals, rays_d, styles, near, far = (
        torch.from_numpy(inputs[k]) for k in
        ("pts", "viewdirs", "z_vals", "rays_d", "styles", "near", "far"))
    r = _renderer(state_dict, width)
    rows = lambda x: shard_rays(shard_batch(x, mesh), mesh)
    b = shard_batch(pts, mesh).shape[0]
    with torch.no_grad():
        out = r(rows(pts), rows(rays_d), rows(viewdirs), rows(z_vals),
                near.expand(b, 1, 1), far.expand(b, 1, 1),
                styles[None].expand(b, *styles.shape), fused=True)[:5]
        render = [gather_rays(o, mesh) for o in out]

    # values that differ along the ray axis: a collective over the data
    # axis must not mix them
    mine = torch.full((2, 3), float(mesh.ray_rank + 1)) + mesh.data_rank
    collectives = {
        "gathered": all_gather_batch(mine, mesh),
        "synced": sync_grads([mine], mesh)[0],
        "mean": global_mean(mine.sum(), mesh),
    }

    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3).requires_grad_(True)
    y = gather_rays(3.0 * shard_rays(x, mesh), mesh)
    (gx,) = torch.autograd.grad((y * y).sum(), x)
    return {**_ray_axes(mesh), "render": render, "collectives": collectives,
            "y": y.detach(), "gx": gx, "counts": dict(mesh.counts)}
