"""The phase-clock build of K2 (`tools/decoder_block_phase_split.py`) on the
CPU: its phase names match the marks in the kernel source, it is a library
of its own, and it refuses to run without the card (it measures the
kernel). The measurement itself is a card test in test_torch_port_gpu.py."""

import re

import pytest
import torch

from cips3dpp_torch.kernels import _lib
from cips3dpp_torch.tools.decoder_block_phase_split import (
    DEFINES, PHASES, WIDE_PHASES, measure,
)


def test_phase_names_match_the_kernel_marks():
    src = (_lib.CSRC / "decoder_block.cu").read_text()
    marks = [int(k) for k in re.findall(r"PHASE_MARK\((\d+)\);", src)]
    assert marks == list(range(len(PHASES)))  # each phase marked once, in order
    assert f"NPHASES = {len(PHASES)};" in src


def test_streamed_phase_names_match_the_kernel_marks():
    """block_kernel_wide marks each of its phases (some in two places)."""
    src = (_lib.CSRC / "decoder_block.cu").read_text()
    marks = {int(k) for k in re.findall(r"WIDE_MARK\((\d+)\);", src)}
    assert marks == set(range(len(WIDE_PHASES)))
    assert f"NWIDE_PHASES = {len(WIDE_PHASES)};" in src


def test_default_cluster_is_the_kernels():
    """The cluster size is the kernel source's alone (2 unless a build sets
    -DDBLOCK_WIDE_CLUSTER): each other size is a library of its own beside
    the plain one."""
    from cips3dpp_torch.tools.k2_times import cluster_defines

    src = (_lib.CSRC / "decoder_block.cu").read_text()
    assert "#define DBLOCK_WIDE_CLUSTER 2 " in src
    assert "constexpr int WIDE_CLUSTER = DBLOCK_WIDE_CLUSTER;" in src
    paths = {_lib._lib_path("decoder_block", d)
             for d in ((), cluster_defines(1), cluster_defines(4))}
    assert len(paths) == 3 and len({p.parent for p in paths}) == 1


def test_instrumented_build_is_a_separate_library():
    plain = _lib._lib_path("decoder_block")
    marked = _lib._lib_path("decoder_block", DEFINES)
    assert plain != marked and plain.parent == marked.parent


def test_phase_split_needs_the_card():
    with pytest.raises(RuntimeError, match="card"):
        measure(torch.bfloat16, False, 1, torch.device("cpu"))


def test_streamed_phase_split_needs_the_card():
    with pytest.raises(RuntimeError, match="card"):
        measure(torch.bfloat16, False, 1, torch.device("cpu"), streamed=True)
