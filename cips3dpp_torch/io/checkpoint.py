"""Checkpoint and resume, and the StyleSDF stage handoff
(counterpart of cips3dpp_tpu/io/checkpoint.py).

The reference saves per-model state dicts (G, D, D_render, G_ema and the
counters), keeps a rotation and snapshots the config next to the weights
(train_v10.py:496-522). Here one `torch.save` a step, `<dir>/<step>.pt`,
holds a `TrainState`'s `state_dict()` (the four modules, the three
optimizers, mean_path_length, step) and the step's metrics; the config
snapshot is `<dir>/config_command.yaml`. A checkpoint is written to a
temporary name and renamed, so a reader never sees half of one; the last
`keep` steps are kept. A `best_fid` slot (`<dir>/best_fid.pt`) sits beside
them. Everything is read on the CPU and copied into the state's own
tensors, on their devices. `graft_renderer` carries a stage-1 volume
renderer into a full pipeline.
"""

from __future__ import annotations

import os
import re
from typing import Mapping

import torch

from .config import load_snapshot, save_snapshot

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def checkpoint_steps(directory: str) -> list[int]:
    """The steps saved in `directory`, ascending ([] if none or no directory)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory)) if m)


def _write(obj, path: str) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep={keep}: at least one checkpoint is kept")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state, config: Mapping | None = None, metrics=None) -> str:
        """Write `state` as step `step`, drop all but the last `keep` steps,
        and snapshot `config` if given. Returns the checkpoint's path."""
        path = self.path(step)
        _write({"state": state.state_dict(), "metrics": dict(metrics or {})}, path)
        for old in checkpoint_steps(self.directory)[:-self.keep]:
            os.remove(self.path(old))
        if config is not None:
            save_snapshot(config, self.directory)
        return path

    def restore(self, state, step: int | None = None):
        """Load step `step` (default: the latest) into `state`, in place;
        None if there is no checkpoint."""
        raw = self.restore_raw(step)
        return None if raw is None else state.load_state_dict(raw["state"])

    def restore_raw(self, step: int | None = None) -> dict | None:
        """The saved dict of step `step` (default: the latest) on the CPU:
        {"state": TrainState.state_dict(), "metrics": {...}}."""
        step = self.latest_step() if step is None else step
        return None if step is None else _read(self.path(step))

    def latest_step(self) -> int | None:
        steps = checkpoint_steps(self.directory)
        return steps[-1] if steps else None

    def load_config(self) -> dict:
        return load_snapshot(self.directory)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX package's
        interface."""


def save_best(directory: str, state, tag: str = "best_fid") -> str:
    """The best-FID slot (train_v10.py:1034-1045), beside the steps."""
    path = os.path.join(os.path.abspath(directory), f"{tag}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write({"state": state.state_dict()}, path)
    return path


def load_best(directory: str, state, tag: str = "best_fid"):
    """Load the best-FID slot into `state`, in place."""
    return state.load_state_dict(_read(os.path.join(os.path.abspath(directory),
                                                    f"{tag}.pt"))["state"])


def _is_render_key(key: str) -> bool:
    """The volume renderer and its mapping (`style.*`), not the decoder's
    mapping (`style_decoder.*`)."""
    top = key.split(".")[0]
    return top in ("renderer", "style")


def graft_renderer(dst_state_dict: Mapping, src_state_dict: Mapping) -> dict:
    """The StyleSDF stage-1 -> stage-2 handoff (train_full_pipeline.py:484,
    train_volume_renderer.py:494-511): a copy of the generator state dict
    `dst_state_dict` (a fresh full pipeline) with the trained volume
    renderer and its mapping (`renderer.*`, `style.*`) of a stage-1
    (enable_decoder=False) generator's `src_state_dict`; the decoder and
    its mapping (`decoder.*`, `style_decoder.*`) keep the fresh weights.
    Raises ValueError when the source has no renderer or a key is missing
    from the target or has another shape there: a partial graft would
    train from garbage."""
    keys = [k for k in src_state_dict if _is_render_key(k)]
    if not any(k.startswith("renderer.") for k in keys):
        raise ValueError(f"source checkpoint has no 'renderer' tensors, not a generator "
                         f"checkpoint? keys: {sorted(src_state_dict)[:8]}")
    out = {k: v.clone() for k, v in dst_state_dict.items()}
    for k in keys:
        if k not in out:
            raise ValueError(f"target generator has no tensor {k!r}")
        src, dst = src_state_dict[k], out[k]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: shape {tuple(src.shape)} in the stage-1 checkpoint, "
                             f"{tuple(dst.shape)} in the target model")
        out[k] = src.detach().to(device=dst.device, dtype=dst.dtype, copy=True)
    return out
