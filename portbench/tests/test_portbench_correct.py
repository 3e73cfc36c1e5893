"""`correct` through the harness's whole run but the look for a chip, on
small models on the CPU: true for the program as it is, false for the
control (the reference at the precision below the configuration's, in
the program's place) and for each fault a cell can have, planted in the
program's timed path underneath."""

from __future__ import annotations

import pytest
import torch

from portbench import faults

from .portbench_small import run_small, small_config, small_train_config

VIDEO = "ffhq_r1024_serve.video36_f12"
TRAIN = "ffhq_r1024_train.iters_b4"


def serve_config():
    cfg = small_config("ffhq_r1024_serve")
    cfg["serving"]["mean_latent_samples"] = 256
    cfg["check"]["limits"] = {"rgb_err": 0.05, "thumb_err": 0.005}
    return cfg


def train_config():
    cfg = small_train_config()
    cfg["check"]["limits"] = {"real_gap": 1e-6, "fake_gap": 1e-4, "grad_gap": 1e-2,
                              "step_gap": 1e-2}
    return cfg


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_serving_program_is_correct():
    r = run_small(VIDEO, serve_config())
    assert r["correct"], r["checks"]
    assert r["checks"]["rgb_err"]["value"] > 0  # the bf16 program is not the f32 reference


def test_serving_control_is_not_correct():
    r = run_small(VIDEO, serve_config(), precision="fp8")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["altered_frame", "half_the_frames"])
def test_serving_faults_are_not_correct(fault):
    undo = faults.plant(fault)
    try:
        r = run_small(VIDEO, serve_config())
    finally:
        undo()
    assert not r["correct"], r["checks"]


def test_training_program_is_correct(tmp_path):
    r = run_small(TRAIN, train_config(), seconds=0.5, cache=tmp_path)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1


def test_training_decoder_bf16_is_not_correct(tmp_path):
    """G's decoder computed in bf16, the rest as the configuration states:
    the first G step's fakes catch it (the D step's numbers cannot)."""
    r = run_small(TRAIN, train_config(), seconds=0.0, precision="decoder_bf16",
                  cache=tmp_path)
    assert not r["correct"], r["checks"]
    assert r["checks"]["fake_gap"]["value"] > 1e-4


@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_batch"])
def test_training_faults_are_not_correct(tmp_path, fault):
    undo = faults.plant(fault)
    try:
        r = run_small(TRAIN, train_config(), seconds=0.0, cache=tmp_path)
    finally:
        undo()
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
def test_training_control_is_not_correct_on_the_card(tmp_path):
    """TF32 changes nothing on the CPU: the control reads only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only there")
    from portbench.lib import harness

    cell = harness.find_cell(TRAIN)
    r = harness.execute(cell, 11, 0.0, False, torch.device("cuda", 0), 0.0,
                        config=train_config(), precision="tf32", cache=tmp_path)
    assert not r["correct"], r["checks"]
