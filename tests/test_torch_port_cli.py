"""The port's sampling CLI on the CPU (`--device cpu`, a tiny model from
`--opts` overrides), and its config loader against the JAX package's."""

import json
import os

import numpy as np
import pytest

TINY_OPTS = [
    "G_cfg.renderer.n_layers", "2",
    "G_cfg.renderer.hidden_dim", "32",
    "G_cfg.decoder.upsample_list", "[128]",
    "G_cfg.decoder.style_dim", "64",
    "G_cfg.decoder.mapping_n_layers", "2",
    "G_cfg.img_size", "8",
    "G_cfg.n_samples", "4",
]


def _run(argv, capsys):
    from cips3dpp_torch.apps.cli import main

    assert main(argv + ["--device", "cpu", "--opts", *TINY_OPTS]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sample_multi_view_writes_its_outputs(tmp_path, capsys):
    out = tmp_path / "out"
    res = _run(["sample-multi-view", "--outdir", str(out), "--n-frames", "3",
                "--truncation", "1.0"], capsys)
    assert res["frames"] == 3
    for key in ("video", "grid"):
        assert os.path.exists(res[key]), key
    names = os.listdir(out)
    for stem in ("video_thumb", "video_depth"):
        assert any(n.startswith(stem) for n in names), (stem, names)
    # the fused route with hash noise, on the CPU through the kernels'
    # plain versions
    res = _run(["sample-multi-view", "--outdir", str(tmp_path / "f"), "--n-frames", "2",
                "--fused", "--noise-seed", "3", "--truncation", "1.0"], capsys)
    assert res["frames"] == 2


def test_grid_commands_write_their_outputs(tmp_path, capsys):
    res = _run(["style-mixing", "--outdir", str(tmp_path / "m"), "--n-rows", "2",
                "--n-cols", "2"], capsys)
    assert os.path.exists(res["grid"]) and res["shape"] == [32, 32, 3]
    res = _run(["fixed-zs-multi-view", "--outdir", str(tmp_path / "z"), "--n-zs", "2",
                "--n-frames", "2", "--view-mode", "elev_circle"], capsys)
    assert res["n_zs"] == 2 and os.path.exists(res["grid"])


def test_help_unknown_and_checkpoints(tmp_path, capsys):
    import torch

    from cips3dpp_torch.apps.cli import _build_generator, main

    assert main([]) == 0 and "sample-multi-view" in capsys.readouterr().out
    assert main(["bogus"]) == 2
    with pytest.raises(NotImplementedError, match="orbax"):
        _build_generator({"network_pkl": str(tmp_path)}, "cpu")
    # a reference .pth state dict loads by name
    from cips3dpp_torch.io.config import apply_overrides

    cfg = apply_overrides({}, TINY_OPTS)
    model, _ = _build_generator(cfg, "cpu")
    sd = {k: v + 1.0 for k, v in model.state_dict().items()}
    torch.save(sd, tmp_path / "g.pth")
    loaded, _ = _build_generator({**cfg, "network_pkl": str(tmp_path / "g.pth")}, "cpu")
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k])


def test_config_loader_matches_jax(tmp_path):
    from cips3dpp_tpu.io import config as jc
    from cips3dpp_torch.io import config as tc

    yaml = pytest.importorskip("yaml")
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({
        "base": {"G_cfg": {"img_size": 32, "decoder": {"style_dim": 64}}, "lr": 1},
        "child": {"base": "base", "G_cfg": {"decoder": {"upsample_list": [64]}}, "x": 2},
    }))
    opts = ["G_cfg.renderer.hidden_dim", "16", "flag", "true", "name", "abc"]
    got = tc.apply_overrides(tc.load_command_config(str(path), "child"), opts)
    want = jc.apply_overrides(jc.load_command_config(str(path), "child"), opts)
    assert got == want
    gcfg = tc.generator_config_from_dict(got["G_cfg"])
    jcfg = jc.generator_config_from_dict(want["G_cfg"])
    assert (gcfg.img_size, gcfg.renderer.hidden_dim, gcfg.decoder.upsample_list) == (
        jcfg.img_size, jcfg.renderer.hidden_dim, jcfg.decoder.upsample_list) == (32, 16, (64,))
    np.testing.assert_equal(gcfg.decoder.style_dim, jcfg.decoder.style_dim)
