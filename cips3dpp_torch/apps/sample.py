"""Inference apps: multi-view trajectories, style mixing, decoder
interpolation (counterpart of cips3dpp_tpu/apps/sample.py).

Behavioural contract: render_video_web_v10.py — trajectories (:1731-1790,
__get_trans_rotation_cams :1587-1649), slerp (:375-385), style-mixing grid
(:1901-2126), decoder weight interpolation (:896-935). One per-frame
renderer (`make_frame_renderer`, a `Generator.forward` call) serves every
app. A fused trajectory (`render_trajectory(fused=True)`, batch 1) is the
serving path instead: `serving.prepare_trajectory` folds the styles,
weights and noise once, and each frame runs the SIREN render kernel once
and the decoder block kernel once per upsample block (`render_camera`).

Trajectories are built on the card unless `device="cpu"` is passed; the
renderers run where the model lives. Random draws take a
`torch.Generator`; the frame and grid writers and the PNG reader need
nothing outside the standard library and numpy (imageio is used for
videos and PIL for reading other image formats when they import).
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

from ..core.camera import CameraParams, camera_from_angles
from ..device import resolve_device
from ..serving import prepare_trajectory, render_camera

# ---------------------------------------------------------------- latents --


def slerp(z1, z2, t):
    """Spherical interpolation (render_video_web_v10.py:375-385)."""
    p = torch.sum(z1 * z2, dim=-1, keepdim=True)
    p = p / torch.linalg.norm(z1, dim=-1, keepdim=True)
    p = p / torch.linalg.norm(z2, dim=-1, keepdim=True)
    omega = torch.arccos(torch.clamp(p, -1.0, 1.0))
    so = torch.sin(omega)
    s1 = torch.sin((1.0 - t) * omega) / so
    s2 = torch.sin(t * omega) / so
    return s1 * z1 + s2 * z2


def lerp(a, b, t):
    return a + (b - a) * t


# ------------------------------------------------------------ trajectories --


def _steps(n, device):
    return torch.linspace(0.0, 1.0, n, device=resolve_device(device))


def yaw_trajectory(n_frames: int, img_size: int, azim_range=(-0.3, 0.3),
                   elev: float = 0.0, fov_ang: float = 6.0,
                   dist_radius: float = 0.12, device=None) -> CameraParams:
    """Sinusoidal yaw sweep (render_video_web_v10.py:1732-1748)."""
    t = _steps(n_frames, device)
    azim = azim_range[0] + (azim_range[1] - azim_range[0]) * torch.sin(t * math.pi)
    return camera_from_angles(azim, torch.full_like(t, elev), img_size,
                              fov_ang=fov_ang, dist_radius=dist_radius)


def circle_trajectory(n_frames: int, img_size: int, azim_range: float = 0.3,
                      elev: float = 0.15, fov_range=(5.0, 7.0),
                      dist_radius: float = 0.12, device=None) -> CameraParams:
    """Azimuth circle with a fov sweep (render_video_web_v10.py:1763-1784)."""
    t = _steps(n_frames, device)
    azim = azim_range * torch.sin(t * 2.0 * math.pi)
    fov = fov_range[0] + (fov_range[1] - fov_range[0]) * torch.sin(t * math.pi)
    return camera_from_angles(azim, torch.full_like(t, elev), img_size,
                              fov_ang=fov, dist_radius=dist_radius)


def elev_circle_trajectory(n_frames: int, img_size: int, azim_range=(-0.3, 0.3),
                           elev_range: float = 0.15, fov_range=(5.0, 7.0),
                           dist_radius: float = 0.12, device=None) -> CameraParams:
    """Elevation ramp, then an azimuth sweep with fov breathing
    (_fixed_zs_multi_view_web 'elev_circle', render_video_web_v10.py:2231-2263)."""
    t = _steps(n_frames // 2, device)
    azim1, elev1 = torch.zeros_like(t), elev_range * t
    fov1 = torch.full_like(t, fov_range[0])
    azim2 = azim_range[0] + (azim_range[1] - azim_range[0]) * t
    elev2 = torch.full_like(t, elev_range)
    fov2 = fov_range[0] + (fov_range[1] - fov_range[0]) * torch.sin(t * math.pi)
    return camera_from_angles(torch.cat([azim1, azim2]), torch.cat([elev1, elev2]),
                              img_size, fov_ang=torch.cat([fov1, fov2]),
                              dist_radius=dist_radius)


def translate_rotate_trajectory(n_frames: int, img_size: int, trans_max: float = 0.04,
                                fov_ang: float = 6.0, dist_radius: float = 0.12,
                                only_rotate: bool = False, device=None) -> CameraParams:
    """Camera x-translation, then an in-plane roll by rotating `up`
    (__get_trans_rotation_cams, render_video_web_v10.py:1587-1649)."""
    t = _steps(n_frames, device)
    zeros = torch.zeros_like(t)
    alpha = t * 2.0 * math.pi + 0.5 * math.pi
    ups = torch.stack([torch.cos(alpha), torch.sin(alpha), zeros], dim=-1)
    rot = camera_from_angles(zeros, zeros, img_size, fov_ang=fov_ang,
                             dist_radius=dist_radius, up=ups)
    if only_rotate:
        return rot
    # translation phase: identity rotation, sinusoidal x offset at z=1
    trans_x = trans_max * torch.sin(t * 2.0 * math.pi)
    eye = torch.eye(3, device=t.device).expand(n_frames, 3, 3)
    tvec = torch.stack([trans_x, zeros, torch.ones_like(t)], dim=-1)
    base = camera_from_angles(zeros, zeros, img_size, fov_ang=fov_ang,
                              dist_radius=dist_radius)
    trans = CameraParams(torch.cat([eye, tvec[:, :, None]], dim=-1), base.focal,
                         base.near, base.far, base.viewpoint)
    return CameraParams(*[torch.cat([a, b]) for a, b in zip(trans, rot)])


# -------------------------------------------------------------- rendering --


def make_frame_renderer(model, *, ray_chunk=None, fused=False, noise_seed=None):
    """One frame function shared by every trajectory app: styles are
    computed once (w space, truncation applied there), the camera varies
    per frame. fused=True runs the SIREN render kernel and the decoder
    block kernels (batch 1); noise_seed makes the noise realization of
    that seed (in the block kernels when fused) where a frame gets
    noise_bufs=None."""

    @torch.no_grad()
    def frame(style_render, style_decoder, extrinsics, focal, near, far, noise_bufs):
        out = model(
            style_render=style_render, style_decoder=style_decoder,
            cam_poses=extrinsics, focals=focal, near=near, far=far,
            noise_bufs=noise_bufs, perturb=False, ray_chunk=ray_chunk,
            fused_renderer=fused, fused_decoder=fused, noise_seed=noise_seed,
        )
        return out["rgb"], out["thumb_rgb"], out["depth"], out["xyz"]

    return frame


@torch.no_grad()
def get_styles(model, zs, truncation=1.0, mean_latents=None):
    return model.map_zs(zs, truncation, mean_latents)


def make_noise_projector(model, style_render, generator=None, *,
                         mesh_resolution: int = 128, max_res: int = 256,
                         bounds: float = 0.24, face_chunk: int = 1024):
    """Geometry-aware noise (model_v3.py:344-415): extract the surface of
    the identity once, attach fixed per-vertex noise drawn from
    `generator`, and per frame rasterize it from the camera, so the decoder
    noise sticks to the geometry across views. Buffers larger than max_res
    pass through unchanged.

    Returns project(noise_bufs, extrinsics, focal) -> new noise_bufs."""
    from ..utils.mesh import extract_shape
    from ..utils.rasterize import rasterize_mesh

    verts, faces = extract_shape(model, style_render, resolution=mesh_resolution,
                                 bounds=bounds)
    dev = model.device
    vert_noise = torch.randn((max(len(verts), 1), 1), generator=generator).to(dev)
    verts_t = torch.as_tensor(verts.reshape(-1, 3), dtype=torch.float32, device=dev)
    faces_t = torch.as_tensor(faces.reshape(-1, 3), dtype=torch.int64, device=dev)

    def project(noise_bufs, extrinsics, focal):
        if len(verts) == 0:  # no surface crossed the iso-level
            return list(noise_bufs)
        cache, out = {}, []
        for buf in noise_bufs:
            res = buf.shape[1]
            if res > max_res:
                out.append(buf)
                continue
            if res not in cache:
                color, _, hit = rasterize_mesh(verts_t, faces_t, vert_noise,
                                               extrinsics[0], focal.reshape(-1)[0],
                                               res, face_chunk=face_chunk)
                cache[res] = (color, hit)
            color, hit = cache[res]
            # the visible surface takes the projected noise, the rest keeps
            # the buffer (prev_noise, model_v3.py:408-414)
            out.append(torch.where(hit[None, :, :, None], color[None], buf))
        return out

    return project


@torch.no_grad()
def render_trajectory(model, zs, cams: CameraParams, *, truncation: float = 1.0,
                      mean_latents=None, noise_bufs=None, zero_noise: bool = False,
                      ray_chunk=None, fused: bool = False, project_noise: bool = False,
                      project_noise_generator=None, project_noise_max_res: int = 256,
                      noise_seed=None, generator=None):
    """Render every frame of a camera trajectory with fixed latents
    (_sample_multi_view_web, render_video_web_v10.py:1806-1824).

    Noise: `noise_bufs`, else the realization of `noise_seed` (hash noise),
    else buffers drawn from `generator` (default seed 0); zero_noise zeroes
    the buffers and overrides the seed. project_noise makes the noise
    geometry-aware (make_noise_projector; vertex noise from
    `project_noise_generator`, default seed 7). fused=True without
    project_noise folds everything once (serving.prepare_trajectory) and
    renders each frame through the kernels (serving.render_camera); with
    project_noise the noise changes per frame, so each frame is a fused
    Generator.forward. Returns a dict of stacked f32 numpy arrays: rgb
    (N, H, W, 3) in [-1, 1], thumb_rgb, depth, xyz."""
    dev = model.device
    if zero_noise:
        noise_seed = None  # zero buffers override the seed
    if noise_bufs is None and noise_seed is None:
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        noise_bufs = model.decoder.make_noise(gen, model.cfg.img_size, device=dev)
    if zero_noise:
        noise_bufs = [torch.zeros_like(b) for b in noise_bufs]
    outs = {"rgb": [], "thumb_rgb": [], "depth": [], "xyz": []}
    n_frames = cams.extrinsics.shape[0]
    if fused and not project_noise:
        # near/far depend on dist_radius alone: one depth range a trajectory
        prep = prepare_trajectory(model, zs, noise_bufs=noise_bufs, noise_seed=noise_seed,
                                  truncation=truncation, mean_latents=mean_latents,
                                  near=cams.near[0], far=cams.far[0], device=dev)
        for i in range(n_frames):
            res = render_camera(model, prep, CameraParams(*(c[i:i + 1] for c in cams)),
                                device=dev)
            for k in outs:
                outs[k].append(res[k][0].float().cpu().numpy())
        return {k: np.stack(v) for k, v in outs.items()}

    style_render, style_decoder = get_styles(model, zs, truncation, mean_latents)
    projector = None
    if project_noise:
        if noise_bufs is None:  # the projection edits buffers
            noise_bufs = model.decoder.hash_noise(noise_seed, model.cfg.img_size,
                                                  device=dev)
        pgen = (torch.Generator().manual_seed(7) if project_noise_generator is None
                else project_noise_generator)
        projector = make_noise_projector(model, style_render, pgen,
                                         max_res=project_noise_max_res)

    frame = make_frame_renderer(model, ray_chunk=ray_chunk, fused=fused,
                                noise_seed=noise_seed)
    for i in range(n_frames):
        frame_noise = noise_bufs
        if projector is not None:
            frame_noise = projector(noise_bufs, cams.extrinsics[i:i + 1],
                                    cams.focal[i:i + 1])
        res = frame(style_render, style_decoder, cams.extrinsics[i:i + 1],
                    cams.focal[i:i + 1], cams.near[i:i + 1], cams.far[i:i + 1],
                    frame_noise)
        for k, v in zip(outs, res):
            outs[k].append(v[0].float().cpu().numpy())
    return {k: np.stack(v) for k, v in outs.items()}


# ------------------------------------------------------------ style mixing --


@torch.no_grad()
def style_mixing_grid(model, generator, n_rows: int, n_cols: int, cam: CameraParams,
                      truncation: float = 0.7, mean_latents=None, noise_bufs=None,
                      z_rows=None, z_cols=None):
    """(rows: shape / renderer w) x (columns: appearance / decoder w) grid
    (_style_mixing_web, render_video_web_v10.py:1901-2126): cell (i, j)
    renders row i's renderer style with column j's decoder style, through
    the plain modules. z_rows (n_rows, z_dim) / z_cols are drawn from
    `generator` when not given; noise from seed 1 when not given. Returns
    an (n_rows*H, n_cols*W, 3) numpy image."""
    zd = model.cfg.mapping.z_dim
    dev = model.device
    if z_rows is None:
        z_rows = torch.randn((n_rows, zd), generator=generator)
    if z_cols is None:
        z_cols = torch.randn((n_cols, zd), generator=generator)
    z_rows, z_cols = z_rows.to(dev), z_cols.to(dev)
    if noise_bufs is None:
        noise_bufs = model.decoder.make_noise(torch.Generator().manual_seed(1),
                                              model.cfg.img_size, device=dev)
    frame = make_frame_renderer(model)
    rows = []
    for i in range(n_rows):
        sr, _ = get_styles(model, (z_rows[i:i + 1],) * 2, truncation, mean_latents)
        row = []
        for j in range(n_cols):
            _, sd = get_styles(model, (z_cols[j:j + 1],) * 2, truncation, mean_latents)
            rgb, *_ = frame(sr, sd, cam.extrinsics[:1], cam.focal[:1], cam.near[:1],
                            cam.far[:1], noise_bufs)
            row.append(rgb[0].float().cpu().numpy())
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


# -------------------------------------------------- decoder interpolation --


def interpolate_decoder_params(state_a, state_b, gamma: float, submodules=("decoder",)):
    """Per-tensor lerp of the decoder weights of two state dicts, the
    stylization of interp_state_dict_decoder (render_video_web_v10.py:
    896-935): gamma=0 gives a (the photo model), gamma=1 gives b (the style
    model); every other tensor comes from a."""
    prefixes = tuple(f"{m}." for m in submodules)
    return {k: ((1.0 - gamma) * v + gamma * state_b[k]) if k.startswith(prefixes) else v
            for k, v in state_a.items()}


# ---------------------------------------------------------------- writers --


def _to_u8(frames: np.ndarray) -> np.ndarray:
    return ((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)


def write_png(path: str, img_u8: np.ndarray) -> str:
    """(H, W, 3|1) uint8 -> PNG, standard library only (zlib)."""
    img = np.ascontiguousarray(img_u8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))
    return path


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA PNG ->
    (H, W, C) uint8, standard library only (zlib and the five row
    filters). Other PNGs raise ValueError."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: bit depth {depth}, color type {color_type}, interlace "
                         f"{interlace}; this reader takes 8-bit gray/RGB(A), not interlaced")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1).astype(np.int64)
        if ftype == 0:
            rec = line
        elif ftype == 1:  # Sub: a running sum per channel
            rec = np.cumsum(line.reshape(w, channels), axis=0).reshape(-1) % 256
        elif ftype == 2:  # Up
            rec = (line + prior) % 256
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left one
            rec_b, up, filt = bytearray(stride), prior.tolist(), line.tolist()
            for x in range(stride):
                left = rec_b[x - channels] if x >= channels else 0
                if ftype == 3:
                    pred = (left + up[x]) // 2
                else:
                    pred = _paeth(left, up[x], up[x - channels] if x >= channels else 0)
                rec_b[x] = (filt[x] + pred) & 0xFF
            rec = np.frombuffer(bytes(rec_b), np.uint8).astype(np.int64)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        out[y] = rec
        prior = rec
    return out.reshape(h, w, channels)


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8: read by PIL where it imports (any format), else by
    `read_png`; gray is repeated to RGB and alpha dropped, as PIL's
    convert("RGB") does."""
    try:
        from PIL import Image
    except ImportError:
        img = read_png(path)
        return img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3, axis=-1)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_video(frames: np.ndarray, path: str, fps: int = 30) -> str:
    """[-1, 1] float frames (N, H, W, 3) -> a video where imageio imports
    (mp4 with an ffmpeg backend, else an animated GIF beside the requested
    path); without imageio, a directory of PNG frames named after the
    path. Returns the path written."""
    u8 = _to_u8(frames)
    try:
        import imageio
    except ImportError:
        out_dir = path.rsplit(".", 1)[0] + "_frames"
        os.makedirs(out_dir, exist_ok=True)
        for i, f in enumerate(u8):
            write_png(os.path.join(out_dir, f"{i:05d}.png"), f)
        return out_dir
    try:
        imageio.mimwrite(path, u8, fps=fps)
    except (ValueError, ImportError):
        path = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimwrite(path, u8, duration=1000.0 / fps, loop=0)
    return path


def tile_grid(frames: np.ndarray, n_cols: int | None = None) -> np.ndarray:
    """Tile (N, H, W, C) into one (rH, cW, C) image, empty cells at -1
    (torchvision make_grid with padding=0)."""
    n, h, w, c = frames.shape
    if n_cols is None:
        n_cols = max(1, int(np.sqrt(n)))
    n_rows = (n + n_cols - 1) // n_cols
    grid = np.full((n_rows * h, n_cols * w, c), -1.0, frames.dtype)
    for i in range(n):
        r, cc = divmod(i, n_cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = frames[i]
    return grid


def save_image_grid(frames: np.ndarray, path: str, n_cols: int = 8) -> str:
    """[-1, 1] frames (N, H, W, 3) as one PNG grid, empty cells 0 (grey)."""
    n, h, w, c = frames.shape
    n_rows = (n + n_cols - 1) // n_cols
    grid = np.zeros((n_rows * h, n_cols * w, c), frames.dtype)
    for i in range(n):
        r, cc = divmod(i, n_cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = frames[i]
    return write_png(path, _to_u8(grid))
