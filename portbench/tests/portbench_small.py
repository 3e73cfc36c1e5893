"""Small configurations of the benchmark's systems for the CPU tests: the
shipped configuration files with the model cut to a size the CPU runs in
seconds (every other key as shipped)."""

from __future__ import annotations

import copy

import torch

from portbench.lib import harness
from portbench.lib.common import load_named

SMALL_MODEL = {
    "renderer": {"n_layers": 2, "hidden_dim": 64},
    "mapping": {"z_dim": 32, "style_dim": 32, "n_layers": 2},
    "decoder": {"upsample_list": [32], "size_end": 32, "style_dim": 64,
                "mapping_n_layers": 2, "channel_multiplier": 1},
    "img_size": 16, "n_samples": 12,
}


def small_config(name: str, **extra) -> dict:
    cfg = copy.deepcopy(load_named("configs", name))
    m = cfg["model"]
    for k, v in SMALL_MODEL.items():
        if isinstance(v, dict):
            m[k].update(v)
        else:
            m[k] = v
    for k, v in extra.items():
        cfg[k] = v
    return cfg


def run_small(cell_name: str, config: dict, seed: int = 7, seconds: float = 0.0,
              trace: bool = False, precision: str = "program", cache=None):
    bench = harness.benchmark()
    cell = harness.find_cell(cell_name, bench)
    return harness.execute(cell, seed, seconds, trace, torch.device("cpu"), 0.0, bench=bench,
                           config=config, precision=precision, cache=cache)


SMALL_TRAIN = {
    "d": {"input_size": 32}, "d_render": {"input_size": 32},
    "train": {"batch": 2, "cam_img_size": 16, "gen_img_size": 32, "data_img_size": 32},
    "data": {"images": 8},
}


def small_train_config() -> dict:
    cfg = small_config("ffhq_r1024_train")
    for k, v in SMALL_TRAIN.items():
        cfg[k].update(v)
    return cfg
