"""Command-line launchers of the sampling apps (counterpart of the sampling
commands of cips3dpp_tpu/apps/cli.py):

    python -m cips3dpp_torch.apps.cli <command> [--cfg configs/ffhq.yaml
        --section sample_multi_view] [--opts key.path value ...]
        [--device cuda|cpu] [--outdir DIR] [--seed N]

Commands: sample-multi-view, fixed-zs-multi-view, interpolate-z,
style-mixing, interpolate-decoder. Everything runs on the card unless
`--device cpu` is given. The generator is randomly initialised from a
fixed seed, or loaded from a reference `.pth` state dict named by the
config's `network_pkl` (the port's module names are the reference's
state-dict names). Only `sample-multi-view --fused` reaches the kernels
(batch 1); the other commands run the plain modules. `--cfg` needs PyYAML;
`--opts` alone does not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: the port reads reference .pth state dicts only; orbax "
            "checkpoint directories wait for its io slice")
    return torch.load(path, map_location="cpu", weights_only=True)


def _build_generator(cfg: dict, device, ckpt=None):
    """The generator of cfg["G_cfg"] on `device`: weights from the .pth
    named by `ckpt` (default: the config's network_pkl), else random from
    seed 0."""
    from ..io.config import generator_config_from_dict
    from ..models.generator import Generator

    gcfg = generator_config_from_dict(cfg.get("G_cfg", {}))
    model = Generator(gcfg, device=device, seed=0)
    ckpt = ckpt or cfg.get("network_pkl") or cfg.get("ckpt")
    if ckpt is None:
        print("[cli] no checkpoint given: using random init", file=sys.stderr)
    else:
        res = model.load_state_dict(_load_state_dict(ckpt), strict=False)
        if res.missing_keys:
            raise KeyError(f"{ckpt}: missing {len(res.missing_keys)} keys, "
                           f"e.g. {res.missing_keys[:5]}")
        if res.unexpected_keys:
            print(f"[cli] {len(res.unexpected_keys)} unexpected state-dict keys "
                  f"ignored: {res.unexpected_keys[:5]} ...", file=sys.stderr)
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


COMMANDS = {
    "sample-multi-view": cmd_sample_multi_view,
    "fixed-zs-multi-view": cmd_fixed_zs_multi_view,
    "interpolate-z": cmd_interpolate_z,
    "style-mixing": cmd_style_mixing,
    "interpolate-decoder": cmd_interpolate_decoder,
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
