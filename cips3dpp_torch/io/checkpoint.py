"""Checkpoint and resume (counterpart of cips3dpp_tpu/io/checkpoint.py,
without `graft_renderer`).

The reference saves per-model state dicts (G, D, D_render, G_ema and the
counters), keeps a rotation and snapshots the config next to the weights
(train_v10.py:496-522). Here one `torch.save` a step, `<dir>/<step>.pt`,
holds a `TrainState`'s `state_dict()` (the four modules, the three
optimizers, mean_path_length, step) and the step's metrics; the config
snapshot is `<dir>/config_command.yaml`. A checkpoint is written to a
temporary name and renamed, so a reader never sees half of one; the last
`keep` steps are kept. A `best_fid` slot (`<dir>/best_fid.pt`) sits beside
them. Everything is read on the CPU and copied into the state's own
tensors, on their devices.
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
