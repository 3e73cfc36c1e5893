"""The port's inversion commands on the CPU (`invert` -> `render-inverted`
-> `lerp-inversions`, as tests/test_cli_extras.py:28-69, 128-175 drive the
JAX CLI), inversion artifacts across the two packages, the
standard-library PNG reader and the PIL-Lanczos counterpart of the
`invert` command's image preparation."""

import json
import os
import re
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import a, np_tree, port_and_jax_generator, t

from cips3dpp_torch.apps.cli import main

# the tiny generator of tests/test_torch_port_inversion.py: 8^2 rays x 4
# samples, a SIREN of width 32, two decoder blocks to 16^2
TINY_OPTS = [
    "G_cfg.renderer.n_layers", "2", "G_cfg.renderer.hidden_dim", "32",
    "G_cfg.decoder.size_end", "16", "G_cfg.decoder.upsample_list", "[16]",
    "G_cfg.decoder.style_dim", "64", "G_cfg.decoder.mapping_n_layers", "2",
    "G_cfg.img_size", "8", "G_cfg.n_samples", "4",
]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_invert_render_inverted_and_lerp(tmp_path, capsys, monkeypatch):
    """invert twice (the first with PIL hidden, so the image goes through
    the standard-library PNG reader; the second in axis_angle mode), then
    render-inverted from the first artifact and lerp-inversions over
    both: every output written, the report finite and provenance-tagged."""
    img = (np.random.RandomState(0).rand(40, 30, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "face.png")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("inv:\n  G_cfg: {}\n  n_steps_pose: 2\n  n_steps_app: 3\n"
                   "  n_steps_multiview: 0\n  flip_w_decoder_every: 2\n  w_avg_samples: 32\n")
    base = ["--device", "cpu", "--cfg", str(cfg), "--section", "inv", "--opts", *TINY_OPTS]
    inv = [tmp_path / "inv0", tmp_path / "inv1"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        assert main(["invert", *base, "--image", str(tmp_path / "face.png"),
                     "--outdir", str(inv[0]), "--azim-init", "0.05", "-0.05"]) == 0
    report = _last_json(capsys)
    assert main(["invert", *base, "--image", str(tmp_path / "face.png"), "--outdir",
                 str(inv[1]), "--seed", "1", "--cam-param", "axis_angle"]) == 0
    report_aa = _last_json(capsys)
    for rep, d in ((report, inv[0]), (report_aa, inv[1])):
        assert np.isfinite([rep["psnr"], rep["ssim"], rep["lpips"], rep["loss"]]).all()
        assert rep["vgg_weights"] == rep["lpips_weights"] == "random"
        assert json.loads((d / "report.json").read_text()) == rep
        assert Image.open(d / "proj.png").size == (16, 16)
        assert os.path.exists(d / "w.pt")
    assert len(report["azim"]) == 2 and len(report_aa["azim"]) == 6

    assert main(["render-inverted", *base, "--inversion", str(inv[0] / "w.pt"),
                 "--outdir", str(tmp_path / "views"), "--n-frames", "2"]) == 0
    res = _last_json(capsys)
    assert os.path.exists(res["grid"]) and os.path.exists(res["video"])
    assert main(["lerp-inversions", *base, "--inversions", str(inv[0] / "w.pt"),
                 str(inv[1] / "w.pt"), "--outdir", str(tmp_path / "lerp"),
                 "--n-interp", "2"]) == 0
    res = _last_json(capsys)
    assert res["frames"] == 4  # 2 pairs x 2 frames, cycling
    assert os.path.exists(res["video"])
    main([])
    assert capsys.readouterr().out.count(",") == 9  # 10 commands


def test_jax_inversion_artifacts_render_alike(tmp_path):
    """A w.pkl written by the JAX package's Projector.save_inversion, read
    by load_jax_inversion, renders (the plain path, perturbation off) what
    JAX renders from it; the port's own artifact written in JAX's format
    by chip_smoke.py's write_jax_inversion reads back bit-equal and
    renders in JAX what the port renders. Tolerance: 1e-4, f32 through the SIREN and decoder (as
    tests/test_torch_port_generator.py)."""
    from cips3dpp_tpu.apps.inversion import InversionConfig, Projector as JProjector
    from cips3dpp_tpu.apps.sample import make_frame_renderer as jframe
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_torch.apps.cli import _load_inversion
    from cips3dpp_torch.apps.inversion import restore_inverted
    from cips3dpp_torch.apps.sample import make_frame_renderer
    from cips3dpp_torch.core.camera import camera_from_angles
    from chip_smoke import write_jax_inversion
    from test_torch_port_inversion import tiny_configs

    jcfg, tcfg = tiny_configs()
    model, gvars = port_and_jax_generator(jcfg, tcfg, seed=51)
    gvars = jax.tree.map(jnp.asarray, gvars)
    jmodel = JG(jcfg)
    jp = JProjector(jmodel, gvars, None, InversionConfig(w_avg_samples=16), fused=False)
    state = jp.init_state(jax.random.PRNGKey(2), (0.2, -0.2))
    rng = np.random.default_rng(3)
    # move every saved leaf off the base model's values
    bump = lambda x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
    state = state.replace(w_render=bump(state.w_render), w_decoder=bump(state.w_decoder),
                          decoder_params=jax.tree.map(bump, state.decoder_params),
                          noise_bufs=[bump(b) for b in state.noise_bufs])
    path = jp.save_inversion(str(tmp_path / "w.pkl"), state)

    cam_args = (jnp.asarray([0.15]), jnp.asarray([0.05]), jcfg.img_size)
    render_j = jax.jit(lambda p, sr, sd, ext, f, n, fa, nb: jframe(jmodel, p)(
        sr, sd, ext, f, n, fa, nb)[0])
    jc = jcam(*cam_args, fov_ang=jcfg.fov_ang, dist_radius=jcfg.dist_radius)

    def jax_render(blob):
        params = {**gvars, "params": {**gvars["params"], "decoder": blob["decoder_params"],
                                      "renderer": blob["renderer_params"]}}
        return np.asarray(render_j(params, blob["w_render_opt"], blob["w_decoder_opt"],
                                   jc.extrinsics, jc.focal, jc.near, jc.far,
                                   [jnp.asarray(b) for b in blob["noise_bufs"]]))

    tc = camera_from_angles(t(cam_args[0]), t(cam_args[1]), tcfg.img_size,
                            fov_ang=tcfg.fov_ang, dist_radius=tcfg.dist_radius)

    def port_render(blob):
        restore_inverted(model, blob)
        rgb, *_ = make_frame_renderer(model)(blob["w_render_opt"], blob["w_decoder_opt"],
                                             tc.extrinsics, tc.focal, tc.near, tc.far,
                                             blob["noise_bufs"])
        return a(rgb)

    blob = _load_inversion(path)
    np.testing.assert_allclose(port_render(blob), jax_render(JProjector.load_inversion(path)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(a(blob["azim"]), np.asarray(state.azim))

    # the port's artifact in JAX's format, both ways
    port_blob = {**blob, "decoder_params": {k: v + 0.01 for k, v in
                                            blob["decoder_params"].items()}}
    back = _load_inversion(write_jax_inversion(str(tmp_path / "port.pkl"), port_blob))
    for k in ("azim", "elev", "w_render_opt", "w_decoder_opt"):
        assert torch.equal(back[k], port_blob[k]), k
    styled_bias = re.compile(r"^(conv1|convs\.\d+)\.bias$")
    for k in ("decoder_params", "renderer_params"):
        # the reference's unused StyledConv.bias comes back zero
        assert all(torch.equal(back[k][n], torch.zeros_like(v) if styled_bias.match(n) else v)
                   for n, v in port_blob[k].items()), k
    assert all(torch.equal(x, y) for x, y in zip(back["noise_bufs"], port_blob["noise_bufs"]))
    np.testing.assert_allclose(
        port_render(back), jax_render(JProjector.load_inversion(str(tmp_path / "port.pkl"))),
        rtol=1e-4, atol=1e-4)


def _png(path, img, filters):
    """Write (H, W, C) uint8 as an 8-bit PNG whose row y uses filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    bpp, raw = c, bytearray()
    rows = img.reshape(h, w * c).astype(np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                  0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_matches_pil(tmp_path, channels):
    """Gray, gray+alpha, RGB and RGBA with every row filter, and the same
    image as PIL writes it: read_png equals PIL's decoding bit for bit,
    and read_image_rgb without PIL equals PIL's convert("RGB")."""
    from cips3dpp_torch.apps import sample

    img = np.random.default_rng(channels).integers(0, 256, (13, 11, channels), dtype=np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    _png(tmp_path / "f.png", img, (0, 1, 2, 3, 4))
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(tmp_path / "p.png")
    for name in ("f.png", "p.png"):
        got = sample.read_png(str(tmp_path / name))
        want = np.asarray(Image.open(tmp_path / name))
        np.testing.assert_array_equal(got, want.reshape(got.shape))
        rgb = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        sys_pil = sys.modules.get("PIL")
        sys.modules["PIL"] = None
        try:
            np.testing.assert_array_equal(sample.read_image_rgb(str(tmp_path / name)), rgb)
        finally:
            sys.modules["PIL"] = sys_pil


@pytest.mark.parametrize("shape,size", [((40, 30), 16), ((17, 23), 32), ((100, 80), 37),
                                        ((64, 64), 64), ((300, 260), 64)])
def test_pil_lanczos_counterpart(shape, size):
    """center_crop + pil_lanczos_resize against PIL's crop and
    resize(Image.LANCZOS) (cips3dpp_tpu/apps/cli.py:487-491), down, up
    and the identity: within 1 u8 level."""
    from cips3dpp_torch.ops.resize import center_crop, pil_lanczos_resize

    img = np.random.default_rng(size).integers(0, 256, (*shape, 3), dtype=np.uint8)
    pil = Image.fromarray(img)
    w, h = pil.size
    s = min(w, h)
    pil = pil.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    want = np.asarray(pil.resize((size, size), Image.LANCZOS)).astype(np.int64)
    got = pil_lanczos_resize(center_crop(img), (size, size)).astype(np.int64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_weight_discovery_imports_torch_files(tmp_path, monkeypatch):
    """load_vgg and load_lpips find torchvision-named and lpips-named
    state dicts under $CIPS3DPP_WEIGHTS_DIR (or by explicit path) and tag
    them "imported"; without them, "random". The imported LPIPS equals the
    JAX package's import_lpips_torch of the same files on one pair of
    images (rtol 1e-4, f32 reductions in another order)."""
    from cips3dpp_tpu.utils import lpips as jl
    from cips3dpp_torch.io import weights
    from test_torch_port_inversion import images, vgg_tree

    tree = vgg_tree(11, lin=True)
    vgg_sd = {}
    for name, node in tree["vgg"]["params"].items():
        idx = name[len("conv_"):]
        vgg_sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(node["kernel"], (3, 2, 0, 1))))
        vgg_sd[f"features.{idx}.bias"] = torch.from_numpy(node["bias"])
    vgg_sd["classifier.0.weight"] = torch.zeros(2, 2)  # ignored
    lin_sd = {f"lin{k}.model.1.weight": torch.from_numpy(tree["lin"][str(i)]).reshape(1, -1, 1, 1)
              for k, i in enumerate(jl.LPIPS_TAPS)}
    torch.save(vgg_sd, tmp_path / "vgg16-397923af.pth")
    torch.save(lin_sd, tmp_path / "vgg.pth")

    monkeypatch.delenv(weights.WEIGHTS_DIR_ENV, raising=False)
    assert weights.load_vgg(device="cpu")[1] == weights.load_lpips(device="cpu")[1] == "random"
    vgg, prov = weights.load_vgg(path=str(tmp_path / "vgg16-397923af.pth"), device="cpu")
    assert prov == "imported" and torch.equal(vgg.features[28].weight,
                                              vgg_sd["features.28.weight"])
    monkeypatch.setenv(weights.WEIGHTS_DIR_ENV, str(tmp_path))
    assert weights.load_vgg(device="cpu")[1] == "imported"
    lp, prov = weights.load_lpips(device="cpu")
    assert prov == "imported"
    x, y = images(12, (1, 24, 24, 3)), images(13, (1, 24, 24, 3))
    jvars = jl.import_lpips_torch({k: v.numpy() for k, v in vgg_sd.items()},
                                  {k: v.numpy() for k, v in lin_sd.items()})
    np.testing.assert_allclose(float(lp(t(x), t(y))),
                               float(jl.lpips(jvars, jnp.asarray(x), jnp.asarray(y))), rtol=1e-4)
