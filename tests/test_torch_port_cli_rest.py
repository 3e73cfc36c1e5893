"""The commands the port took last from the JAX CLI, on the CPU at a tiny
size (tests/test_torch_port_cli.py's TINY_OPTS: depth-2 SIREN of width 32,
8^2 rays x 4 samples, one upsample to 16^2): the reference-checkpoint
manifest and its check (io/torch_import.py) against the JAX package's on
the same `.pth`, `import-torch`, `verify-import` against a golden the JAX
command wrote (tol 1e-3, the JAX command's default: both render the same
f32 function) with a planted weight change that must
fail it, `rendering-time`, `extract-shape`, utils/profiling.py and the web
form against the JAX package's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_cli import TINY_OPTS
from test_web_smoke import _make_stub_streamlit


def _port(argv, capsys):
    """(rc, the last JSON line) of the port's command on the CPU."""
    from cips3dpp_torch.apps.cli import main

    rc = main(argv + ["--device", "cpu", "--opts", *TINY_OPTS])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tiny_generator(seed=3):
    from cips3dpp_torch.io.config import apply_overrides, generator_config_from_dict
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.models.layers import randomize_zero_init_

    gcfg = generator_config_from_dict(apply_overrides({}, TINY_OPTS)["G_cfg"])
    g = Generator(gcfg, device="cpu", seed=seed)
    randomize_zero_init_(g, torch.Generator().manual_seed(seed))
    return g, gcfg


def _reference_pth(path, sd):
    """A state dict as the reference writes it: the port's tensors plus the
    FIR and noise buffers the reference keeps and both packages ignore."""
    sd = {k: v.clone() for k, v in sd.items()}
    sd["decoder.convs.0.conv.blur.kernel"] = torch.ones(4, 4)
    sd["decoder.noises.noise_0"] = torch.zeros(1, 1, 8, 8)
    torch.save(sd, path)
    return str(path)


# ---------------------------------------------------------------- manifest --


def test_validation_reports_equal_the_jax_packages(tmp_path):
    """The same .pth through both packages' validate_torch_state_dict: the
    same report; a missing key and a wrong shape raise in both."""
    from cips3dpp_tpu.io import torch_import as jti
    from cips3dpp_torch.io import torch_import as tti
    from cips3dpp_tpu.io.config import generator_config_from_dict as jax_config
    from cips3dpp_torch.io.config import apply_overrides, generator_config_from_dict
    from torch_port_helpers import port_and_jax_generator

    gd = apply_overrides({}, TINY_OPTS)["G_cfg"]
    g, variables = port_and_jax_generator(jax_config(gd), generator_config_from_dict(gd),
                                          seed=4)
    sd = g.state_dict()
    sd["extra.weight"] = torch.zeros(3)
    path = _reference_pth(tmp_path / "g.pth", sd)
    tsd, jsd = tti.load_torch_checkpoint(path), jti.load_torch_checkpoint(path)
    assert tti.IGNORED_KEY_MARKERS == jti.IGNORED_KEY_MARKERS
    assert tti.state_dict_manifest(g) == jti.state_dict_manifest(variables)
    assert tti.validate_torch_state_dict(tsd, g) == jti.validate_torch_state_dict(jsd, variables)
    for bad in ({k: v for k, v in tsd.items() if k != "renderer.sigmoid_beta"},
                {**tsd, "style.0.weight": torch.zeros(3, 3)}):
        with pytest.raises(ValueError, match="does not match"):
            tti.validate_torch_state_dict(bad, g)
        with pytest.raises(ValueError, match="does not match"):
            jti.validate_torch_state_dict({k: v.numpy() for k, v in bad.items()}, variables)
        rep = tti.validate_torch_state_dict(bad, g, strict=False)
        assert rep == jti.validate_torch_state_dict({k: v.numpy() for k, v in bad.items()},
                                                    variables, strict=False)
        assert rep["n_matched"] == rep["n_expected"] - 1


def test_discriminator_manifests_equal_the_jax_exporters():
    """The image D's and the pose D's manifests are the key sets and shapes
    the JAX package's exporters write."""
    from cips3dpp_tpu.io import torch_import as jti
    from cips3dpp_torch.io.torch_import import state_dict_manifest
    from torch_port_train_helpers import port_and_jax_d, port_and_jax_pose_d

    _, pd, d = port_and_jax_d(seed=1, input_size=16)
    _, ppd, dp = port_and_jax_pose_d(seed=2, input_size=8)
    for module, exported in ((d, jti.export_d_stylegan_state_dict({"params": pd})),
                             (dp, jti.export_d_pose_state_dict({"params": ppd}))):
        assert state_dict_manifest(module) == {k: tuple(np.shape(v))
                                               for k, v in exported.items()}


def test_import_torch_writes_loadable_state_dicts(tmp_path, capsys):
    """import-torch of a G_ema, an image D and a pose D: a strict check,
    the ignored keys dropped, the file loadable as network_pkl; a
    checkpoint of another configuration fails before anything is
    written."""
    from cips3dpp_torch.apps.cli import _build_generator
    from cips3dpp_torch.io.config import apply_overrides
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive

    g, gcfg = _tiny_generator()
    pth = _reference_pth(tmp_path / "G_ema.pth", g.state_dict())
    rc, res = _port(["import-torch", "--pth", pth, "--outdir", str(tmp_path / "imp")], capsys)
    n = len(g.state_dict())
    assert rc == 0 and res == {"ckpt": str(tmp_path / "imp" / "g_ema.pth"), "model": "g_ema",
                                  "n_expected": n, "n_matched": n, "n_ignored": 2,
                                  "n_unexpected": 0}
    written = torch.load(res["ckpt"], weights_only=True)
    assert written.keys() == g.state_dict().keys()
    model, _ = _build_generator(apply_overrides({"network_pkl": res["ckpt"]}, TINY_OPTS), "cpu")
    assert all(torch.equal(model.state_dict()[k], v) for k, v in g.state_dict().items())
    for name, module in (("d", DStyleGANProgressive(gcfg.out_size, 2, device="cpu", seed=5)),
                         ("d_pose", DVolumeRenderProgressive(gcfg.img_size, device="cpu",
                                                             seed=6))):
        path = str(tmp_path / f"{name}_in.pth")
        torch.save(module.state_dict(), path)
        rc, res = _port(["import-torch", "--pth", path, "--model", name, "--outdir",
                         str(tmp_path / "imp")], capsys)
        got = torch.load(res["ckpt"], weights_only=True)
        assert res["n_matched"] == len(got) and all(
            torch.equal(got[k], v) for k, v in module.state_dict().items())
    other = dict(g.state_dict(), **{"style.0.weight": torch.zeros(256, 128)})
    torch.save(other, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="shape mismatch: style.0.weight"):
        _port(["import-torch", "--pth", str(tmp_path / "other.pth"), "--outdir",
               str(tmp_path / "bad")], capsys)
    assert not (tmp_path / "bad" / "g_ema.pth").exists()


def test_orbax_directory_names_the_exporter(tmp_path):
    from cips3dpp_torch.apps.cli import _build_generator

    with pytest.raises(NotImplementedError, match="export_generator_state_dict"):
        _build_generator({"network_pkl": str(tmp_path)}, "cpu")


# ----------------------------------------------------------- verify-import --


def test_verify_import_against_a_jax_golden(tmp_path, capsys):
    """The JAX command's `verify-import --save-golden` on a .pth, then the
    port's `verify-import --golden` on the same .pth passes (it renders the
    golden's own zs and azimuths); a golden of the port's own passes too;
    one renderer weight scaled by 1.01 fails with exit code 1."""
    from cips3dpp_tpu.apps import cli as jcli
    from cips3dpp_torch.apps.cli import main

    g, _ = _tiny_generator(seed=8)
    pth = _reference_pth(tmp_path / "G_ema.pth", g.state_dict())
    golden = str(tmp_path / "jax_golden.npz")
    assert jcli.main(["verify-import", "--save-golden", golden, "--opts", *TINY_OPTS,
                      "network_pkl", pth]) in (0, None)
    capsys.readouterr()

    def port(*argv):
        rc = main(["verify-import", *argv, "--device", "cpu", "--opts", *TINY_OPTS,
                   "network_pkl", pth])
        return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    rc, rep = port("--golden", golden)
    assert rc == 0 and rep["pass"] and rep["tol"] == 1e-3, rep
    assert rep["rgb"]["max_abs_err"] <= 1e-3 and rep["thumb_rgb"]["psnr"] > 60
    ref = np.load(golden)
    assert ref["rgb"].shape == (6, 16, 16, 3) and ref["zs"].shape == (2, 2, 256)
    rc, saved = port("--save-golden", str(tmp_path / "port_golden.npz"))
    assert rc == 0 and saved["n_images"] == 6
    assert port("--golden", str(tmp_path / "port_golden.npz"))[0] == 0
    sd = torch.load(pth, weights_only=True)
    sd["renderer.network.pts_linears.1.weight"] *= 1.01
    torch.save(sd, pth)
    rc, rep = port("--golden", golden)
    assert rc == 1 and not rep["pass"] and rep["rgb"]["max_abs_err"] > 1e-3, rep


# --------------------------------------------- rendering-time, extract-shape --


def test_rendering_time_and_extract_shape(tmp_path, capsys):
    rc, res = _port(["rendering-time", "--n-frames", "2"], capsys)
    assert {"metric", "value", "unit", "vs_baseline", "ms_per_frame", "n_frames",
            "peak_bytes", "card"} <= res.keys()
    assert res["unit"] == "fps" and res["value"] > 0 and res["n_frames"] == 2
    assert res["vs_baseline"] == pytest.approx(res["value"] / 46.93)
    rc, res = _port(["extract-shape", "--outdir", str(tmp_path), "--resolution", "16",
                     "--n-shapes", "2", "--frustum-align"], capsys)
    assert len(res) == 2
    for r in res:
        assert r["n_verts"] > 0 and os.path.exists(r["obj"]) and os.path.exists(r["img"])
        with open(r["obj"]) as fh:
            assert sum(line.startswith("v ") for line in fh) == r["n_verts"]


def test_profiling_utilities(tmp_path):
    from cips3dpp_torch.utils import profiling

    assert profiling.device_memory_stats("cpu") == dict.fromkeys(
        ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"))
    calls = []
    times = profiling.time_reps(lambda: torch.tensor(float(len(calls.append(1) or calls))),
                                "cpu", reps=2)
    assert len(times) == 2 and len(calls) == 3 and min(times) >= 0
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(tmp_path / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


# ------------------------------------------------------------------- web --


WEB_VALUES = {
    "view-mode": "circle", "n-frames": 3, "truncation": 0.5, "zero-noise": True,
    "fused": False, "n-zs": 2, "n-rows": 2, "n-cols": 5, "ckpt-b": "b.pth",
    "image": "face.png", "cam-param": "axis_angle", "inversion": "w.pkl",
    "inversions": "a.pkl b.pkl", "n-interp": 4, "resolution": 64,
}


@pytest.mark.parametrize("values", [{}, WEB_VALUES], ids=["defaults", "set"])
def test_web_build_argv_equals_the_jax_one(values):
    from cips3dpp_tpu.apps import web as jweb
    from cips3dpp_torch.apps import web

    assert web.MODES == jweb.MODES
    for mode in web.MODES:
        for cfg, section in ((None, None), ("configs/ffhq.yaml", "sample_multi_view")):
            args = (mode, values, cfg, section, "/tmp/o", 3)
            assert web.build_argv(*args) == jweb.build_argv(*args), mode


def test_web_main_under_a_stub_streamlit(monkeypatch, capsys):
    """Every mode's widgets are built and one submission reaches the port's
    cli.main (stubbed, as tests/test_web_smoke.py does); without streamlit
    main() points at the command line and returns 1."""
    from cips3dpp_torch.apps import cli, web

    calls = []

    def fake_cli_main(argv):
        calls.append(argv)
        with open(os.path.join(argv[argv.index("--outdir") + 1], "out.png"), "wb") as f:
            f.write(b"\x89PNG")

    monkeypatch.setattr(cli, "main", fake_cli_main)
    monkeypatch.setattr(sys, "argv", ["web.py"])
    for mode in web.MODES:
        rec = []
        monkeypatch.setitem(sys.modules, "streamlit", _make_stub_streamlit(rec, mode))
        assert web.main() == 0
        assert calls[-1][0] == web.MODES[mode][0]
        labels = {r[1] for r in rec if len(r) > 1}
        assert all(name in labels for name, _, _ in web.MODES[mode][1]), mode
        assert any(r[0] == "image" for r in rec) and any(
            r[0] == "code" and "cips3dpp_torch.apps.cli" in r[1] for r in rec), mode
    monkeypatch.setitem(sys.modules, "streamlit", None)
    assert web.main() == 1
    assert "python -m cips3dpp_torch.apps.cli" in capsys.readouterr().err


def test_the_cli_has_the_jax_commands(capsys):
    from cips3dpp_tpu.apps import cli as jcli
    from cips3dpp_torch.apps import cli

    assert list(cli.COMMANDS) == list(jcli.COMMANDS)
    assert cli.main(["--help"]) == 0
    assert capsys.readouterr().out.strip() == "commands: " + ", ".join(jcli.COMMANDS)
