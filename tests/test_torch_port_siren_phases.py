"""The phase-clock builds of K1 (`tools/siren_phase_split.py`) on the CPU:
their phase names match the marks in the kernel source, and the tool
refuses to run without the card (it measures the kernel, which has no
plain counterpart to time). The measurement itself is a card test in
test_torch_port_gpu.py."""

import re

import pytest
import torch

from cips3dpp_torch.kernels import _lib
from cips3dpp_torch.kernels import siren_render as ksr
from cips3dpp_torch.tools.siren_phase_split import PHASES, WIDE_PHASES, measure, phases


def test_phase_names_match_the_kernel_marks():
    src = (_lib.CSRC / "siren_render.cu").read_text()
    marks = [int(k) for k in re.findall(r"PHASE_MARK\((\d+)\);", src)]
    assert marks == list(range(len(PHASES)))  # each phase marked once, in order
    assert f"NPHASES = {len(PHASES)};" in src


def test_wide_phase_names_match_the_kernel_marks():
    """The wide kernel's phases (every width past 256): its enum names
    them in the tool's order, and each is marked somewhere in the kernel."""
    src = (_lib.CSRC / "siren_render.cu").read_text()
    enum = re.search(r"enum WidePhase \{(.*?)NWIDE_PHASES", src, re.S).group(1)
    assert tuple(re.findall(r"WP_(\w+),", enum)) == WIDE_PHASES
    marked = set(re.findall(r"WIDE_MARK\(WP_(\w+)\);", src))
    assert marked == set(WIDE_PHASES)
    assert all(phases(w) == WIDE_PHASES for w in (257, 512, 640, 1024, 2048))
    assert all(phases(w) == PHASES for w in ksr.NARROW_WIDTHS + (8, 96, 200))


def test_instrumented_build_is_a_separate_library():
    plain = _lib._lib_path("siren_render")
    marked = _lib._lib_path("siren_render", ("-DSIREN_PHASE_CLOCKS",))
    assert plain != marked and plain.parent == marked.parent


def test_wide_instrumented_build_is_a_separate_library():
    defines = ksr.kernel_defines(ksr.WIDE_WIDTH, 24)
    plain = _lib._lib_path("siren_render", defines)
    marked = _lib._lib_path("siren_render", defines + ("-DSIREN_PHASE_CLOCKS",))
    assert plain != marked and plain.parent == marked.parent


def test_phase_split_needs_the_card():
    with pytest.raises(RuntimeError, match="card"):
        measure(8, 1, torch.device("cpu"))


def test_wide_phase_split_needs_the_card():
    with pytest.raises(RuntimeError, match="card"):
        measure(8, 1, torch.device("cpu"), ksr.WIDE_WIDTH, 12)
