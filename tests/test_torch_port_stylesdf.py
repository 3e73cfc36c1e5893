"""The StyleSDF two-stage handoff in the port (io/checkpoint.py:
graft_renderer, `train --init-renderer-from`) against the JAX package's
(cips3dpp_tpu/io/checkpoint.py:68-106, tests/test_stylesdf.py:82), at the
tiny size of the step tests: a stage-1 generator (enable_decoder=False)
grafted into a fresh full pipeline renders as the JAX-grafted one does
(the same f32 function: rtol 1e-4 of each output's largest value), and the
two stages run through the command line on the CPU.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, port_and_jax_generator, t
from torch_port_train_helpers import assert_rel, tiny_configs


def _stages():
    """(JAX config, port config) of stage 1 (no decoder, 8^2) and stage 2
    (the full pipeline, one upsample to 16^2)."""
    j1, t1 = tiny_configs(img_size=8, upsample_list=(), n_samples=4)
    j2, t2 = tiny_configs(img_size=8, upsample_list=(16,), n_samples=4)
    return ((dataclasses.replace(j1, enable_decoder=False),
             dataclasses.replace(t1, enable_decoder=False)), (j2, t2))


def test_graft_renderer_copies_the_renderer_and_its_mapping():
    from cips3dpp_torch.io.checkpoint import graft_renderer
    from cips3dpp_torch.models.generator import Generator

    (_, c1), (_, c2) = _stages()
    g1, g2 = Generator(c1, device="cpu", seed=7), Generator(c2, device="cpu", seed=8)
    src, dst = g1.state_dict(), g2.state_dict()
    out = graft_renderer(dst, src)
    assert out.keys() == dst.keys()
    for k, v in out.items():
        top = k.split(".")[0]
        want = src[k] if top in ("renderer", "style") else dst[k]
        assert torch.equal(v, want), k
        assert v.data_ptr() not in (src[k].data_ptr() if k in src else -1, dst[k].data_ptr())
    assert any(k.startswith("style_decoder.") for k in out)  # kept fresh
    g2.load_state_dict(out)
    with pytest.raises(ValueError, match="no 'renderer'"):
        graft_renderer(dst, {k: v for k, v in src.items() if not k.startswith("renderer.")})
    wide = Generator(dataclasses.replace(c1, renderer=dataclasses.replace(
        c1.renderer, hidden_dim=16)), device="cpu", seed=9)
    with pytest.raises(ValueError, match="shape"):
        graft_renderer(dst, wide.state_dict())


def test_port_and_jax_grafts_render_alike():
    """A stage-1 generator grafted into a stage-2 one by each package renders
    the same frames (perturb off, the same noise buffers)."""
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.io.checkpoint import graft_renderer as jax_graft
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.io.checkpoint import graft_renderer
    from cips3dpp_torch.models.decoder import Decoder

    (j1, t1), (j2, t2) = _stages()
    g1, v1 = port_and_jax_generator(j1, t1, seed=11)
    g2, v2 = port_and_jax_generator(j2, t2, seed=12)
    g2.load_state_dict(graft_renderer(g2.state_dict(), g1.state_dict()))
    grafted = jax_graft(jax.tree.map(jnp.asarray, v2), jax.tree.map(jnp.asarray, v1))

    rng = np.random.default_rng(3)
    zs = [rng.standard_normal((2, 256)).astype(np.float32) for _ in range(2)]
    azim, elev = np.array([0.2, -0.1], np.float32), np.array([0.05, 0.0], np.float32)
    noise = [rng.standard_normal((2,) + s[1:]).astype(np.float32)
             for s in Decoder(upsample_list=(16,)).noise_shapes(8)]
    cam = jcam(jnp.asarray(azim), jnp.asarray(elev), 8)
    want = jax.jit(lambda p: JG(j2).apply(
        p, zs=tuple(jnp.asarray(z) for z in zs), cam_poses=cam.extrinsics,
        focals=cam.focal, near=cam.near, far=cam.far,
        noise_bufs=[jnp.asarray(n) for n in noise], perturb=False))(grafted)
    tc = camera_from_angles(t(azim), t(elev), 8)
    with torch.no_grad():
        got = g2(zs=[t(z) for z in zs], cam_poses=tc.extrinsics, focals=tc.focal,
                 near=tc.near, far=tc.far, noise_bufs=[t(n) for n in noise], perturb=False)
    for k in ("rgb", "thumb_rgb", "depth"):
        assert_rel(got[k], want[k], rel=1e-4, name=k)
    assert np.isfinite(a(got["rgb"])).all()


STAGE = """
stage1:
  G_cfg: {enable_decoder: false}
  D_cfg: {input_size: 16, channel_multiplier: 1}
  D_renderer_cfg: {input_size: 8}
  batch: 4
  data_img_size: 16
  cam_img_size: 8
  gen_img_size: 8
  d_reg_every: 2
  g_reg_every: -1
  ema_start: 1
  fade_steps: 10
  init_renderer: true
  init_iters: 2
stage2:
  base: stage1
  G_cfg: {enable_decoder: true, freeze_renderer: true, renderer_detach: true}
  g_reg_every: 2
  gen_img_size: 16
"""


def test_train_init_renderer_from_runs_both_stages(tmp_path, capsys, monkeypatch):
    """`train` of stage 1 (the pose D only, sphere init first), then stage 2
    with `--init-renderer-from <stage 1>/ckpt`: at its step 0 G and G_ema
    hold stage 1's G_ema renderer and mapping bit for bit and fresh
    decoders, no sphere init runs, and every logged loss is finite. A
    missing stage-1 directory fails before any step."""
    from cips3dpp_torch.apps.cli import main
    from cips3dpp_torch.io.checkpoint import CheckpointManager
    from cips3dpp_torch.train import train_loop
    from test_torch_port_cli import TINY_OPTS

    cfg = tmp_path / "stylesdf.yaml"
    cfg.write_text(STAGE)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "images-16-0000.npy",
            np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8))
    opts = [o for i in range(0, len(TINY_OPTS), 2) for o in TINY_OPTS[i:i + 2]
            if not TINY_OPTS[i].startswith("G_cfg.decoder.upsample_list")]
    sphere, seen = [], {}
    init = train_loop.Trainer.sphere_init
    monkeypatch.setattr(train_loop.Trainer, "sphere_init",
                        lambda self, *a_, **k: sphere.append(1) or init(self, *a_, **k))
    train = train_loop.Trainer.train

    def spy(self, state, *a_, **k):
        seen.update(g={n: v.clone() for n, v in state.g.state_dict().items()},
                    g_ema={n: v.clone() for n, v in state.g_ema.state_dict().items()})
        return train(self, state, *a_, **k)

    monkeypatch.setattr(train_loop.Trainer, "train", spy)

    def run(section, outdir, *extra):
        assert main(["train", "--cfg", str(cfg), "--section", section, "--device", "cpu",
                     "--data", str(data), "--outdir", str(outdir), "--total-iters", "2",
                     *extra, "--opts", *opts, "G_cfg.decoder.upsample_list", "[16]"]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert run("stage1", tmp_path / "s1")["done"] and len(sphere) == 1
    stage1 = CheckpointManager(str(tmp_path / "s1" / "ckpt")).restore_raw()["state"]
    fresh = dict(seen["g"])
    assert run("stage2", tmp_path / "s2", "--init-renderer-from",
               str(tmp_path / "s1" / "ckpt"))["done"]
    assert len(sphere) == 1  # the graft replaces the sphere init
    for which in ("g", "g_ema"):
        for k, v in seen[which].items():
            if k.split(".")[0] in ("renderer", "style"):
                assert torch.equal(v, stage1["g_ema"][k]), (which, k)
    # the decoder keeps the fresh weights of --seed 0
    dec = [k for k in seen["g"] if k.startswith("decoder.")]
    assert dec and all(torch.equal(seen["g"][k], fresh[k]) for k in dec)
    with open(tmp_path / "s2" / "logs" / "metrics.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert rows and all(np.isfinite(v) for r in rows for v in r.values()
                        if isinstance(v, float))
    with pytest.raises(FileNotFoundError, match="missing"):
        run("stage2", tmp_path / "s3", "--init-renderer-from", str(tmp_path / "missing"))
