"""Command-line launchers (counterpart of cips3dpp_tpu/apps/cli.py):

    python -m cips3dpp_torch.apps.cli <command> [--cfg configs/ffhq.yaml
        --section sample_multi_view] [--opts key.path value ...]
        [--device cuda|cpu] [--outdir DIR] [--seed N]

Commands (the JAX package's 16): train, sphere-init, sample-multi-view,
fixed-zs-multi-view, interpolate-z, lerp-inversions, style-mixing,
interpolate-decoder, invert, render-inverted, eval-fid, verify-import,
extract-shape, prepare-data, rendering-time, import-torch. Everything runs
on the card unless `--device cpu` is given (prepare-data runs on the
host). `--cfg` is read by PyYAML where it imports and by the
standard-library reader `io/yaml_lite.py` where it does not. The
generator is randomly initialised from a fixed seed, or loaded from what
the config's `network_pkl` (or `ckpt`) names: a reference `.pth` state
dict, checked strictly against the architecture first
(io/torch_import.py; the port's module names are the reference's), or a
checkpoint directory that `train` wrote (its latest step's G_ema).
`import-torch` checks a reference `.pth` of G_ema, the image D or the pose
D and writes the port's state dict; `verify-import` renders the
checkpoint-parity grid and compares it with a golden `.npz` (one the JAX
command wrote included); `rendering-time` times r1024 frames on the
serving path (1 K1 + 4 K2 launches a frame). `train` and the D step reach
K1 where it takes the renderer; of the sampling commands only
`sample-multi-view --fused` reaches the kernels (batch 1), the others run
the plain modules. `invert` renders through K1 under grad (`SirenRender`,
batch 2) with the plain decoder, and writes its artifact `w.pt`;
`render-inverted` and `lerp-inversions` read that or a `w.pkl` the JAX
package wrote, and render plainly. `train --n-devices` trains
data-parallel (`parallel/mesh.py`), `train --init-renderer-from` starts a
StyleSDF stage 2 from a stage-1 run; `eval-fid` generates with the plain
renderer and tags its Inception weights "imported" or "random".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device


def _base_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--cfg", type=str, default=None, help="YAML config file")
    p.add_argument("--section", type=str, default=None, help="config section")
    p.add_argument("--opts", nargs="*", default=[], help="dotted overrides")
    p.add_argument("--outdir", type=str, default="results/run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def _load_cfg(args) -> dict:
    from ..io.config import apply_overrides, load_command_config

    cfg = {} if args.cfg is None else load_command_config(args.cfg, args.section)
    return apply_overrides(cfg, args.opts)


def _load_state_dict(path: str) -> dict:
    """A generator state dict: a reference `.pth`, or the G_ema of the
    latest step in a checkpoint directory of this package."""
    if os.path.isdir(path):
        from ..io.checkpoint import CheckpointManager, checkpoint_steps

        if not checkpoint_steps(path):
            raise NotImplementedError(
                f"{path}: no checkpoint of this package (<step>.pt). The port reads "
                "reference .pth state dicts and its own checkpoint directories; a "
                "JAX orbax checkpoint becomes a .pth on a host with JAX through "
                "cips3dpp_tpu.io.torch_import.export_generator_state_dict")
        return CheckpointManager(path).restore_raw()["state"]["g_ema"]
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: the port reads reference .pth state dicts and its own "
            "checkpoint directories")
    from ..io.torch_import import load_torch_checkpoint

    return load_torch_checkpoint(path)


def _build_generator(cfg: dict, device, ckpt=None, gcfg=None):
    """The generator of cfg["G_cfg"] (or `gcfg`) on `device`: weights from
    what `ckpt` (default: the config's network_pkl or ckpt) names, a
    reference .pth or a checkpoint directory of `train`, checked strictly
    against the architecture, else random from seed 0."""
    from ..io.config import generator_config_from_dict
    from ..io.torch_import import load_validated
    from ..models.generator import Generator

    gcfg = gcfg or generator_config_from_dict(cfg.get("G_cfg", {}))
    model = Generator(gcfg, device=device, seed=0)
    ckpt = ckpt or cfg.get("network_pkl") or cfg.get("ckpt")
    if ckpt is None:
        print("[cli] no checkpoint given: using random init", file=sys.stderr)
    else:
        report = load_validated(model, _load_state_dict(ckpt))
        if report["unexpected"]:
            print(f"[cli] {len(report['unexpected'])} unexpected state-dict keys "
                  f"ignored: {report['unexpected'][:5]} ...", file=sys.stderr)
    model.eval()
    return model, gcfg


def _zs(gcfg, seed, device, n=1):
    gen = torch.Generator().manual_seed(seed)
    zd = gcfg.mapping.z_dim
    return tuple(torch.randn((n, zd), generator=gen).to(device) for _ in range(2))


def _means(model, truncation):
    if truncation >= 1:
        return None
    return model.mean_latents(torch.Generator().manual_seed(2), 10_000)


def _front_camera(gcfg, dev):
    from ..core.camera import camera_from_angles

    zero = torch.zeros(1, device=dev)
    return camera_from_angles(zero, zero, gcfg.img_size, fov_ang=gcfg.fov_ang,
                              dist_radius=gcfg.dist_radius)


def cmd_sample_multi_view(argv):
    p = _base_parser("multi-view video sampling")
    p.add_argument("--view-mode", default="yaw",
                   choices=["yaw", "circle", "translate_rotate"])
    p.add_argument("--n-frames", type=int, default=36)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--zero-noise", action="store_true")
    p.add_argument("--project-noise", action="store_true",
                   help="geometry-aware noise: fixed per-vertex noise of the "
                        "extracted surface, rasterized per frame (model_v3.py:344-415)")
    p.add_argument("--fused", action="store_true",
                   help="the SIREN render and decoder block kernels (batch 1)")
    p.add_argument("--noise-seed", type=int, default=None,
                   help="hash noise of this seed instead of drawn buffers")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from ..utils.mesh import xyz_to_mesh
    from ..utils.rasterize import shaded_mesh_image
    from .sample import (
        circle_trajectory, render_trajectory, save_image_grid, save_video,
        translate_rotate_trajectory, yaw_trajectory,
    )

    model, gcfg = _build_generator(cfg, dev)
    zs = _zs(gcfg, args.seed, dev)
    means = _means(model, args.truncation)
    kw = dict(dist_radius=gcfg.dist_radius, device=dev)
    cams = {
        "yaw": lambda: yaw_trajectory(args.n_frames, gcfg.img_size,
                                      fov_ang=gcfg.fov_ang, **kw),
        "circle": lambda: circle_trajectory(args.n_frames, gcfg.img_size, **kw),
        "translate_rotate": lambda: translate_rotate_trajectory(
            args.n_frames, gcfg.img_size, fov_ang=gcfg.fov_ang, **kw),
    }[args.view_mode]()
    out = render_trajectory(
        model, zs, cams, truncation=args.truncation, mean_latents=means,
        zero_noise=args.zero_noise, fused=args.fused, project_noise=args.project_noise,
        project_noise_generator=torch.Generator().manual_seed(args.seed + 1),
        noise_seed=args.noise_seed,
    )
    os.makedirs(args.outdir, exist_ok=True)
    vp = save_video(out["rgb"], f"{args.outdir}/video.mp4", fps=args.fps)
    save_video(out["thumb_rgb"], f"{args.outdir}/video_thumb.mp4", fps=args.fps)
    # depth-surface video: the xyz map's grid mesh, lambertian-shaded by the
    # software rasterizer (render_video_web_v10.py:1840-1882)
    depth_res = min(4 * gcfg.img_size, 256)
    depth_frames = []
    for i, xyz in enumerate(out["xyz"]):
        verts, faces = xyz_to_mesh(xyz)
        img, _ = shaded_mesh_image(
            verts, faces, cams.extrinsics[i],
            float(cams.focal[i].reshape(-1)[0]) * depth_res / gcfg.img_size,
            depth_res, device=dev)
        depth_frames.append(img)
    save_video(np.stack(depth_frames), f"{args.outdir}/video_depth.mp4", fps=args.fps)
    gp = save_image_grid(out["rgb"], f"{args.outdir}/frames.png")
    print(json.dumps({"video": vp, "grid": gp, "frames": len(out["rgb"])}))


def cmd_fixed_zs_multi_view(argv):
    """Grid video of several fixed identities sharing one camera sweep
    (_fixed_zs_multi_view_web, render_video_web_v10.py:2128-2322)."""
    p = _base_parser("fixed-zs multi-view grid video")
    p.add_argument("--n-zs", type=int, default=4, help="identities in the grid")
    p.add_argument("--view-mode", default="circle", choices=["circle", "elev_circle", "yaw"])
    p.add_argument("--n-frames", type=int, default=36)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--zero-noise", action="store_true")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from .sample import (
        circle_trajectory, elev_circle_trajectory, get_styles, make_frame_renderer,
        save_image_grid, save_video, tile_grid, yaw_trajectory,
    )

    model, gcfg = _build_generator(cfg, dev)
    n = args.n_zs
    style_render, style_decoder = get_styles(
        model, _zs(gcfg, args.seed, dev, n), args.truncation,
        _means(model, args.truncation))
    noise = model.decoder.make_noise(torch.Generator().manual_seed(3), gcfg.img_size,
                                     device=dev)
    if args.zero_noise:
        noise = [torch.zeros_like(b) for b in noise]
    noise = [b.repeat(n, 1, 1, 1) for b in noise]
    kw = dict(dist_radius=gcfg.dist_radius, device=dev)
    traj = {
        "yaw": lambda: yaw_trajectory(args.n_frames, gcfg.img_size,
                                      fov_ang=gcfg.fov_ang, **kw),
        "circle": lambda: circle_trajectory(args.n_frames, gcfg.img_size, **kw),
        "elev_circle": lambda: elev_circle_trajectory(args.n_frames, gcfg.img_size, **kw),
    }[args.view_mode]()

    frame = make_frame_renderer(model)
    rep = lambda a, i: a[i:i + 1].repeat(n, *([1] * (a.ndim - 1)))
    frames = []
    for i in range(traj.extrinsics.shape[0]):
        rgb, *_ = frame(style_render, style_decoder, rep(traj.extrinsics, i),
                        rep(traj.focal, i), rep(traj.near, i), rep(traj.far, i), noise)
        frames.append(tile_grid(rgb.float().cpu().numpy()))
    os.makedirs(args.outdir, exist_ok=True)
    vp = save_video(np.stack(frames), f"{args.outdir}/video.mp4", fps=args.fps)
    gp = save_image_grid(frames[0][None], f"{args.outdir}/frame0.png", n_cols=1)
    print(json.dumps({"video": vp, "grid": gp, "frames": len(frames), "n_zs": n}))


def cmd_interpolate_z(argv):
    """Latent slerp video (_interpolate_z_web)."""
    p = _base_parser("z-space slerp interpolation video")
    p.add_argument("--n-frames", type=int, default=24)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--truncation", type=float, default=0.7)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from .sample import render_trajectory, save_image_grid, save_video, slerp

    model, gcfg = _build_generator(cfg, dev)
    gen = torch.Generator().manual_seed(args.seed)
    za, zb = [[torch.randn((1, gcfg.mapping.z_dim), generator=gen).to(dev)
               for _ in range(2)] for _ in range(2)]
    means = _means(model, args.truncation)
    cam = _front_camera(gcfg, dev)
    frames = []
    for i in range(args.n_frames):
        t = i / max(args.n_frames - 1, 1)
        zs = (slerp(za[0], zb[0], t), slerp(za[1], zb[1], t))
        out = render_trajectory(model, zs, cam, truncation=args.truncation,
                                mean_latents=means, zero_noise=True)
        frames.append(out["rgb"][0])
    os.makedirs(args.outdir, exist_ok=True)
    vp = save_video(np.stack(frames), f"{args.outdir}/interp_z.mp4", args.fps)
    gp = save_image_grid(np.stack(frames), f"{args.outdir}/interp_z.png")
    print(json.dumps({"video": vp, "grid": gp}))


def cmd_style_mixing(argv):
    p = _base_parser("style mixing grid")
    p.add_argument("--n-rows", type=int, default=4)
    p.add_argument("--n-cols", type=int, default=4)
    p.add_argument("--truncation", type=float, default=0.7)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from .sample import _to_u8, style_mixing_grid, write_png

    model, gcfg = _build_generator(cfg, dev)
    grid = style_mixing_grid(
        model, torch.Generator().manual_seed(args.seed), args.n_rows, args.n_cols,
        _front_camera(gcfg, dev), truncation=args.truncation,
        mean_latents=_means(model, args.truncation))
    os.makedirs(args.outdir, exist_ok=True)
    path = write_png(f"{args.outdir}/style_mixing.png", _to_u8(grid))
    print(json.dumps({"grid": path, "shape": list(grid.shape)}))


def cmd_interpolate_decoder(argv):
    p = _base_parser("decoder weight interpolation (stylization)")
    p.add_argument("--ckpt-b", type=str, required=True, help="style model .pth")
    p.add_argument("--gammas", type=float, nargs="*", default=[0, 0.25, 0.5, 0.75, 1.0])
    p.add_argument("--n-frames", type=int, default=1,
                   help="taken and unused, as by the JAX command (the web form sends it)")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from .sample import interpolate_decoder_params, render_trajectory, save_image_grid

    model, gcfg = _build_generator(cfg, dev)
    state_a = {k: v.clone() for k, v in model.state_dict().items()}
    state_b = _build_generator(cfg, dev, ckpt=args.ckpt_b)[0].state_dict()
    zs = _zs(gcfg, args.seed, dev)
    cam = _front_camera(gcfg, dev)
    frames = []
    for g in args.gammas:
        model.load_state_dict(interpolate_decoder_params(state_a, state_b, g))
        frames.append(render_trajectory(model, zs, cam, zero_noise=True)["rgb"][0])
    model.load_state_dict(state_a)
    os.makedirs(args.outdir, exist_ok=True)
    path = save_image_grid(np.stack(frames), f"{args.outdir}/decoder_interp.png",
                           n_cols=len(args.gammas))
    print(json.dumps({"grid": path, "gammas": args.gammas}))


def cmd_train(argv):
    p = _base_parser("GAN training")
    p.add_argument("--data", type=str, required=True,
                   help="a directory of uint8 npy shards (N, H, W, 3), or of images")
    p.add_argument("--total-iters", type=int, default=None)
    p.add_argument("--no-sphere-init", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one a GPU (default: every visible GPU "
                        "when there is more than one)")
    p.add_argument("--finetune-dir", type=str, default=None,
                   help="checkpoint dir of this package to initialise G/G_ema/Ds "
                        "from (reference tl_finetune, train_v10.py:1225-1245)")
    p.add_argument("--init-renderer-from", type=str, default=None,
                   help="stage-1 (enable_decoder=False) checkpoint dir: graft its "
                        "trained volume renderer + mapping into the fresh full "
                        "pipeline (the StyleSDF train_full_pipeline.py:484 handoff)")
    p.add_argument("--fid-data", type=str, default=None,
                   help="real-image dataset for in-training FID at every checkpoint")
    p.add_argument("--inception", type=str, default=None,
                   help="pt_inception .pth for that FID (default: random, seed 0)")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    from .cli_train_impl import run_training

    run_training(args, cfg)


def cmd_sphere_init(argv):
    p = _base_parser("SDF sphere initialisation only")
    p.add_argument("--n-iters", type=int, default=10000)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    from .cli_train_impl import run_sphere_init

    run_sphere_init(args, cfg)


def cmd_eval_fid(argv):
    p = _base_parser("FID/KID evaluation")
    p.add_argument("--data", type=str, required=True)
    # the reference protocol: 50k real / 50k fake, KID on
    # (train_cips3d_ffhq_v10.yaml:801-806); the config or the flags override
    p.add_argument("--n-images", type=int, default=None)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--inception", type=str, default=None, help="pt_inception .pth weights")
    p.add_argument("--kid", action="store_true", default=None)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    if args.n_images is None:
        args.n_images = int(cfg.get("n_images", 50_000))
    if args.kid is None:
        args.kid = bool(cfg.get("kid", True))
    dev = resolve_device(args.device)

    from ..io.dataset import data_iterator, open_dataset
    from ..io.weights import load_inception
    from .eval_fid import eval_fid

    model, gcfg = _build_generator(cfg, dev)
    # --inception wins; otherwise $CIPS3DPP_WEIGHTS_DIR is consulted
    incep, incep_prov = load_inception(path=args.inception, device=dev)
    ds = open_dataset(args.data, resolution=gcfg.out_size)
    it = data_iterator(ds, args.batch, seed=args.seed)
    try:
        real = (next(it) for _ in range(args.n_images // args.batch))
        res = eval_fid(model, real, incep, n_fake=args.n_images, batch_size=args.batch,
                       generator=torch.Generator(dev).manual_seed(args.seed),
                       with_kid=args.kid)
    finally:
        it.close()
    out = dataclasses.asdict(res)
    out["inception_weights"] = incep_prov
    print(json.dumps(out))


def cmd_prepare_data(argv):
    p = _base_parser("dataset preparation (images -> npy shards or LMDB)")
    p.add_argument("--src", type=str, required=True)
    p.add_argument("--sizes", type=int, nargs="*", default=[1024])
    p.add_argument("--format", choices=["npy", "lmdb"], default="npy",
                   help="lmdb = the reference's multi-size format "
                        "(prepare_data.py:23-80), readable by both packages")
    p.add_argument("--n-workers", type=int, default=0,
                   help="multiprocessing resize workers (0 = in-process)")
    p.add_argument("--crop-size", type=int, nargs="*", default=None,
                   help="explicit centred crop W [H] before resizing "
                        "(the crop_data.py tool); default = the largest square")
    p.add_argument("--codec", choices=["png", "jpeg"], default="png",
                   help="lmdb image codec; png = lossless, byte-compatible "
                        "with the reference (prepare_data.py:44); jpeg needs PIL")
    p.add_argument("--quality", type=int, default=100,
                   help="jpeg quality (only with --codec jpeg)")
    args = p.parse_args(argv)
    from ..io.dataset import prepare_images, prepare_images_lmdb

    crop = args.crop_size
    if crop is not None:
        crop = tuple(crop) if len(crop) == 2 else int(crop[0])
    if args.format == "lmdb":
        out = prepare_images_lmdb(args.src, args.outdir, sizes=args.sizes,
                                  n_workers=args.n_workers, crop_size=crop,
                                  codec=args.codec, quality=args.quality)
    else:
        out = prepare_images(args.src, args.outdir, sizes=args.sizes,
                             n_workers=args.n_workers, crop_size=crop)
    print(json.dumps({"outdir": out, "format": args.format}))


def _load_inversion(path: str) -> dict:
    """An inversion artifact: the port's (a torch zip archive) or the JAX
    package's w.pkl."""
    import zipfile

    from ..io.jax_params import load_jax_inversion
    from .inversion import Projector

    return Projector.load_inversion(path) if zipfile.is_zipfile(path) else \
        load_jax_inversion(path)


def cmd_invert(argv):
    p = _base_parser("flip inversion")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--vgg", type=str, default=None,
                   help="torchvision vgg16 .pth for the perceptual loss")
    p.add_argument("--lpips", type=str, default=None,
                   help="lpips package vgg.pth lin weights (needs --vgg too)")
    p.add_argument("--azim-init", type=float, nargs=2, default=[0.0, 0.0])
    p.add_argument("--cam-param", choices=["angles", "axis_angle"], default=None,
                   help="camera parameterisation (axis_angle = the reference's "
                        "_flip_inversion_axis_angle_web mode)")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    if args.cam_param:
        cfg["cam_param"] = args.cam_param
    dev = resolve_device(args.device)

    from ..io.weights import load_lpips, load_vgg
    from ..ops.resize import center_crop, pil_lanczos_resize
    from .inversion import InversionConfig, Projector
    from .sample import _to_u8, read_image_rgb, write_png

    model, gcfg = _build_generator(cfg, dev)
    # --vgg / --lpips win; otherwise $CIPS3DPP_WEIGHTS_DIR is consulted
    vgg, vgg_prov = load_vgg(path=args.vgg, device=dev)
    lpips = load_lpips(vgg_path=args.vgg, lin_path=args.lpips, device=dev)
    fields = {f.name for f in dataclasses.fields(InversionConfig)}
    icfg = InversionConfig(**{k: v for k, v in cfg.items() if k in fields})
    size = gcfg.out_size
    img = pil_lanczos_resize(center_crop(read_image_rgb(args.image)), (size, size))
    target = img.astype(np.float32) / 127.5 - 1.0

    proj = Projector(model, vgg, icfg, lpips=lpips)
    os.makedirs(args.outdir, exist_ok=True)
    state, proj_img, report = proj.project(
        target, generator=torch.Generator().manual_seed(args.seed),
        azim_init=tuple(args.azim_init),
        logger=lambda s, m: print(f"step {s}: {m}", file=sys.stderr))
    # the weights' provenance, so random-VGG runs are never taken for
    # quality numbers
    report["vgg_weights"] = vgg_prov
    write_png(f"{args.outdir}/proj.png", _to_u8(proj_img[0]))
    proj.save_inversion(f"{args.outdir}/w.pt", state)
    with open(f"{args.outdir}/report.json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


def cmd_render_inverted(argv):
    p = _base_parser("multi-view rendering from a saved inversion")
    p.add_argument("--inversion", type=str, required=True,
                   help="the artifact of invert (w.pt) or a JAX w.pkl")
    p.add_argument("--n-frames", type=int, default=36)
    p.add_argument("--fps", type=int, default=12)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from .inversion import restore_inverted
    from .sample import make_frame_renderer, save_image_grid, save_video, yaw_trajectory

    model, gcfg = _build_generator(cfg, dev)
    blob = _load_inversion(args.inversion)
    # the fitted decoder and the renderer the inversion ran against
    # (render_video_web_v10.py:1039-1048)
    restore_inverted(model, blob)
    azim0 = float(blob["azim"][0, 0])
    cams = yaw_trajectory(args.n_frames, gcfg.img_size, azim_range=(azim0 - 0.3, azim0 + 0.3),
                          elev=float(blob["elev"][0, 0]), fov_ang=gcfg.fov_ang,
                          dist_radius=gcfg.dist_radius, device=dev)
    frame = make_frame_renderer(model)
    sr, sd = blob["w_render_opt"].to(dev), blob["w_decoder_opt"].to(dev)
    noise = [b.to(dev) for b in blob["noise_bufs"]]
    frames = []
    for i in range(args.n_frames):
        rgb, *_ = frame(sr, sd, cams.extrinsics[i:i + 1], cams.focal[i:i + 1],
                        cams.near[i:i + 1], cams.far[i:i + 1], noise)
        frames.append(rgb[0].float().cpu().numpy())
    os.makedirs(args.outdir, exist_ok=True)
    vp = save_video(np.stack(frames), f"{args.outdir}/inverted_views.mp4", args.fps)
    gp = save_image_grid(np.stack(frames), f"{args.outdir}/inverted_views.png")
    print(json.dumps({"video": vp, "grid": gp}))


def _lerp(x, y, t: float):
    if isinstance(x, dict):
        return {k: _lerp(v, y[k], t) for k, v in x.items()}
    if isinstance(x, list):
        return [_lerp(u, v, t) for u, v in zip(x, y)]
    return (1.0 - t) * x + t * y


def cmd_lerp_inversions(argv):
    """Interpolation gallery over saved inversions: the w's, decoder (and
    renderer) weights and noise buffers lerped between consecutive
    artifacts, cycling (lerp_image_list, projector_v10.py:732-821)."""
    p = _base_parser("video lerping between saved inversion artifacts")
    p.add_argument("--inversions", nargs="+", required=True,
                   help="two or more artifacts (w.pt or JAX w.pkl)")
    p.add_argument("--n-interp", type=int, default=12, help="frames per pair")
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from ..core.camera import camera_from_angles
    from .inversion import restore_inverted
    from .sample import make_frame_renderer, save_video

    model, gcfg = _build_generator(cfg, dev)
    blobs = [_load_inversion(pth) for pth in args.inversions]
    base_renderer = {k: v.clone() for k, v in model.renderer.state_dict().items()}
    frame = make_frame_renderer(model)
    keys = ("w_render_opt", "w_decoder_opt", "decoder_params", "noise_bufs")
    frames = []
    for idx, cur in enumerate(blobs):
        nxt = blobs[(idx + 1) % len(blobs)]
        for t in np.linspace(0.0, 1.0, args.n_interp, endpoint=False):
            t = float(t)
            mix = {k: _lerp(cur[k], nxt[k], t) for k in keys}
            both = "renderer_params" in cur and "renderer_params" in nxt
            mix["renderer_params"] = (_lerp(cur["renderer_params"], nxt["renderer_params"], t)
                                      if both else base_renderer)
            restore_inverted(model, mix)
            azim = _lerp(float(cur["azim"][0, 0]), float(nxt["azim"][0, 0]), t)
            elev = _lerp(float(cur["elev"][0, 0]), float(nxt["elev"][0, 0]), t)
            cam = camera_from_angles(torch.tensor([azim], device=dev),
                                     torch.tensor([elev], device=dev), gcfg.img_size,
                                     fov_ang=gcfg.fov_ang, dist_radius=gcfg.dist_radius)
            rgb, *_ = frame(mix["w_render_opt"].to(dev), mix["w_decoder_opt"].to(dev),
                            cam.extrinsics, cam.focal, cam.near, cam.far,
                            [b.to(dev) for b in mix["noise_bufs"]])
            frames.append(rgb[0].float().cpu().numpy())
    os.makedirs(args.outdir, exist_ok=True)
    vp = save_video(np.stack(frames), f"{args.outdir}/gallery.mp4", fps=args.fps)
    print(json.dumps({"video": vp, "frames": len(frames)}))


def cmd_extract_shape(argv):
    """Marching-tetrahedra shape export and an image a seed (reference
    generate_shapes_and_images.py)."""
    p = _base_parser("SDF iso-surface .obj export")
    p.add_argument("--n-shapes", type=int, default=1)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--frustum-align", action="store_true")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from ..utils.mesh import align_volume, marching_tetrahedra, sample_sdf_grid, save_obj
    from .sample import render_trajectory, save_image_grid

    model, gcfg = _build_generator(cfg, dev)
    means = model.mean_latents(torch.Generator().manual_seed(2), 10_000)
    cam = _front_camera(gcfg, dev)
    os.makedirs(args.outdir, exist_ok=True)
    results = []
    for i in range(args.n_shapes):
        zs = _zs(gcfg, args.seed * 100_003 + i, dev)
        with torch.no_grad():
            sr, _ = model.map_zs(zs, args.truncation, means)
        vol, lin = sample_sdf_grid(model, sr, resolution=args.resolution)
        if args.frustum_align:
            vol = align_volume(vol)
        verts, faces = marching_tetrahedra(vol, 0.0, coords=[lin, lin, lin])
        obj = save_obj(verts, faces, f"{args.outdir}/shape_{i}.obj")
        out = render_trajectory(model, zs, cam, truncation=args.truncation,
                                mean_latents=means, zero_noise=True)
        img = save_image_grid(out["rgb"], f"{args.outdir}/shape_{i}.png", n_cols=1)
        results.append({"obj": obj, "img": img, "n_verts": int(len(verts))})
    print(json.dumps(results))


def render_parity_grid(model, n_seeds: int = 2, n_views: int = 3, zs=None, azim=None):
    """The checkpoint-parity grid of the JAX command
    (cips3dpp_tpu/apps/cli.py:607-653): for each seed a yaw sweep over
    +-azim_range, perturb off, zero noise buffers, the plain modules.
    JAX's threefry draws (seeds 1000 + s) cannot be made here: the port
    draws its zs from torch seeds 1000 + s, or renders the given `zs`
    (S, 2, z_dim) and `azim` (V,), a golden's own. Returns dict(rgb
    (S*V, H, W, 3), thumb_rgb, zs (S, 2, z_dim), azim (V,)), numpy f32."""
    from ..core.camera import camera_from_angles

    gcfg, dev = model.cfg, model.device
    if azim is None:
        azim = np.linspace(-gcfg.azim_range, gcfg.azim_range, n_views)
    azim = np.asarray(azim, np.float32)
    cams = camera_from_angles(torch.from_numpy(azim).to(dev),
                              torch.zeros(len(azim), device=dev), gcfg.img_size,
                              fov_ang=gcfg.fov_ang, dist_radius=gcfg.dist_radius)
    noise = [torch.zeros(s, device=dev) for s in model.decoder.noise_shapes(gcfg.img_size)]
    if zs is None:
        zs = np.stack([np.concatenate([
            torch.randn((1, gcfg.mapping.z_dim), generator=g).numpy() for _ in range(2)])
            for g in (torch.Generator().manual_seed(1000 + s) for s in range(n_seeds))])
    zs = np.asarray(zs, np.float32)
    rgbs, thumbs = [], []
    with torch.no_grad():
        for pair in zs:
            z = [torch.from_numpy(pair[i:i + 1]).to(dev) for i in range(2)]
            for v in range(len(azim)):
                out = model(zs=z, cam_poses=cams.extrinsics[v:v + 1],
                            focals=cams.focal[v:v + 1], near=cams.near[v:v + 1],
                            far=cams.far[v:v + 1], noise_bufs=noise, perturb=False)
                rgbs.append(out["rgb"][0].float().cpu().numpy())
                thumbs.append(out["thumb_rgb"][0].float().cpu().numpy())
    return {"rgb": np.stack(rgbs), "thumb_rgb": np.stack(thumbs), "zs": zs, "azim": azim}


def cmd_verify_import(argv):
    """Checkpoint-parity harness: render a fixed (z, camera) grid from an
    imported G_ema.pth and compare it pixel by pixel with a stored golden.
    Run once with --save-golden on a trusted setup; a golden the JAX
    command wrote works too (its zs and azimuths are rendered). Exit code
    0 on a pass, 1 on a failure."""
    p = _base_parser("verify imported checkpoint against golden renders")
    p.add_argument("--golden", type=str, default=None, help="golden .npz to compare against")
    p.add_argument("--save-golden", type=str, default=None,
                   help="write the golden .npz instead of comparing")
    p.add_argument("--tol", type=float, default=1e-3,
                   help="max abs per-pixel tolerance in [-1,1] units")
    p.add_argument("--n-seeds", type=int, default=2)
    p.add_argument("--n-views", type=int, default=3)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    if not (args.golden or args.save_golden):
        p.error("one of --golden / --save-golden is required")
    dev = resolve_device(args.device)
    model, _ = _build_generator(cfg, dev)
    ref = None if args.save_golden else np.load(args.golden)
    grid = render_parity_grid(model, args.n_seeds, args.n_views,
                              zs=None if ref is None else ref["zs"],
                              azim=None if ref is None else ref["azim"])
    if args.save_golden:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_golden)), exist_ok=True)
        np.savez_compressed(args.save_golden, **grid)
        print(json.dumps({"saved": args.save_golden, "n_images": int(grid["rgb"].shape[0])}))
        return 0
    report, ok = {}, True
    for k in ("rgb", "thumb_rgb"):
        if ref[k].shape != grid[k].shape:
            report[k] = {"shape_mismatch": [list(ref[k].shape), list(grid[k].shape)]}
            ok = False
            continue
        err = np.abs(ref[k] - grid[k])
        mse = float(np.mean(np.square(ref[k] - grid[k])))
        report[k] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                     "psnr": float(10 * np.log10(4.0 / max(mse, 1e-12)))}
        ok = ok and err.max() <= args.tol
    report["tol"] = args.tol
    report["pass"] = bool(ok)
    print(json.dumps(report))
    return 0 if ok else 1


RENDER_REPS = 3  # timed sweeps of rendering-time, after one untimed


def cmd_rendering_time(argv):
    """r1024 rendering throughput on the serving path (the work bench.py
    times for the JAX package, which imports JAX and is not called):
    preset_serving (or the config's G_cfg), batch 1, a yaw sweep of
    --n-frames frames, fixed noise, perturb off, 1 K1 + 4 K2 launches a
    frame, CUDA events, the checksum read once a repetition; an untimed
    sweep, then RENDER_REPS timed ones (the best is 'value', as bench.py's
    best of reps). One JSON line with bench.py's keys."""
    p = _base_parser("rendering throughput benchmark")
    p.add_argument("--n-frames", type=int, default=128)
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from ..models.generator import preset_serving
    from ..utils.profiling import BASELINE_FPS, card, rendering_time

    gcfg = None if "G_cfg" in cfg else preset_serving()
    model, gcfg = _build_generator(cfg, dev, gcfg=gcfg)
    t0 = time.perf_counter()
    res = rendering_time(model, n_frames=args.n_frames, reps=RENDER_REPS)
    print(json.dumps({
        "metric": "r1024_multiview_render_throughput", "value": res["best_fps"],
        "unit": "fps", "vs_baseline": res["best_fps"] / BASELINE_FPS,
        "ms_per_frame": res["best_ms_per_frame"], "mean_ms_per_frame": res["ms_per_frame"],
        "n_frames": args.n_frames, "reps": RENDER_REPS, "out_size": gcfg.out_size,
        "peak_bytes": res["memory"]["peak_bytes_in_use"],
        "card": card() if dev.type == "cuda" else None, "device": str(dev),
        "wall_s": time.perf_counter() - t0,
    }))


def cmd_import_torch(argv):
    """Check a reference .pth (G_ema, D_StyleGAN_Progressive or
    D_VolumeRender_Progressive) strictly against the module the config
    builds and write it as the port's state dict, `<outdir>/<model>.pth`,
    with the reference's ignored keys (FIR and noise buffers) dropped; the
    file loads as `network_pkl`."""
    p = _base_parser("check a reference .pth (G_ema / D / D_renderer) and write "
                     "the port's state dict")
    p.add_argument("--pth", type=str, required=True)
    p.add_argument("--model", choices=["g_ema", "d", "d_pose"], default="g_ema",
                   help="which reference model the state dict holds: g_ema (the "
                        "released inversion ckpts), d = D_StyleGAN_Progressive or "
                        "d_pose = D_VolumeRender_Progressive (training ckpts)")
    args = p.parse_args(argv)
    cfg = _load_cfg(args)
    dev = resolve_device(args.device)

    from ..io.config import generator_config_from_dict
    from ..io.torch_import import load_torch_checkpoint, load_validated

    gcfg = generator_config_from_dict(cfg.get("G_cfg", {}))
    if args.model == "g_ema":
        from ..models.generator import Generator

        module = Generator(gcfg, device=dev)
    elif args.model == "d":
        from ..models.discriminator import DStyleGANProgressive

        module = DStyleGANProgressive(gcfg.out_size, gcfg.decoder.channel_multiplier,
                                      device=dev)
    else:
        from ..models.discriminator_pose import DVolumeRenderProgressive

        module = DVolumeRenderProgressive(gcfg.img_size, device=dev)
    report = load_validated(module, load_torch_checkpoint(args.pth))
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.abspath(os.path.join(args.outdir, f"{args.model}.pth"))
    torch.save({k: v.cpu() for k, v in module.state_dict().items()}, out)
    print(json.dumps({"ckpt": out, "model": args.model, "n_expected": report["n_expected"],
                      "n_matched": report["n_matched"], "n_ignored": len(report["ignored"]),
                      "n_unexpected": len(report["unexpected"])}))


COMMANDS = {  # the JAX package's order (cips3dpp_tpu/apps/cli.py:906-923)
    "train": cmd_train,
    "sphere-init": cmd_sphere_init,
    "sample-multi-view": cmd_sample_multi_view,
    "fixed-zs-multi-view": cmd_fixed_zs_multi_view,
    "interpolate-z": cmd_interpolate_z,
    "lerp-inversions": cmd_lerp_inversions,
    "style-mixing": cmd_style_mixing,
    "interpolate-decoder": cmd_interpolate_decoder,
    "invert": cmd_invert,
    "render-inverted": cmd_render_inverted,
    "eval-fid": cmd_eval_fid,
    "verify-import": cmd_verify_import,
    "extract-shape": cmd_extract_shape,
    "prepare-data": cmd_prepare_data,
    "rendering-time": cmd_rendering_time,
    "import-torch": cmd_import_torch,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("commands:", ", ".join(COMMANDS))
        return 0
    if argv[0] not in COMMANDS:
        print(f"unknown command {argv[0]!r}; have {sorted(COMMANDS)}", file=sys.stderr)
        return 2
    rc = COMMANDS[argv[0]](argv[1:])
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())
