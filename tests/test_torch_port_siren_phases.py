"""The phase-clock build of K1 (`tools/siren_phase_split.py`) on the CPU:
its phase names match the marks in the kernel source, and it refuses to
run without the card (it measures the kernel, which has no plain
counterpart to time). The measurement itself is a card test in
test_torch_port_gpu.py."""

import re

import pytest
import torch

from cips3dpp_torch.kernels import _lib
from cips3dpp_torch.tools.siren_phase_split import PHASES, measure


def test_phase_names_match_the_kernel_marks():
    src = (_lib.CSRC / "siren_render.cu").read_text()
    marks = [int(k) for k in re.findall(r"PHASE_MARK\((\d+)\);", src)]
    assert marks == list(range(len(PHASES)))  # each phase marked once, in order
    assert f"NPHASES = {len(PHASES)};" in src


def test_instrumented_build_is_a_separate_library():
    plain = _lib._lib_path("siren_render")
    marked = _lib._lib_path("siren_render", ("-DSIREN_PHASE_CLOCKS",))
    assert plain != marked and plain.parent == marked.parent


def test_phase_split_needs_the_card():
    with pytest.raises(RuntimeError, match="card"):
        measure(8, 1, torch.device("cpu"))
