"""K2's least work (`decoder_block_work`, which chip_smoke.py turns into the
kernel's bound) against counts written out by hand at small shapes, and
its element-wise count against the plain version's operations."""

import pytest
import torch

from cips3dpp_torch.kernels.decoder_block import (
    HASH_OPS, K2_APART_PER_VALUE, decoder_block_work,
)


def test_k2_work_bf16_buffers_by_hand():
    # y1 (2, 16, 32) bf16, noise buffers, feat and rgb: 4*2*16 = 128 output pixels
    got = decoder_block_work(2, 16, 32, torch.bfloat16, hashed=False, emit_feat=True)
    assert got == {
        # y1 2*16*32*2 + noise 2*(4*2*16)*2 + feat 128*32*2 + rgb 128*3*4
        # + w2t 32*32*2 + b1, b2, nw 4*(2*32 + 2) + wrgb 3*32*2
        "bytes": 2048 + 512 + 8192 + 1536 + 2048 + 264 + 192,
        "bf16_flops": 2 * 128 * 32 * 32,
        "f32_dot": 2 * 128 * 3 * 32,  # ToRGB, one FMA a value and channel of rgb
        "f32_apart": 10.25 * 128 * 32 + 2 * 128,
    }


def test_k2_work_f32_hash_frames_by_hand():
    # y1 (2*1, 16, 64) f32 as 2 frames of Hp = 1, hash noise, no feat:
    # 4*2*1*16 = 128 output pixels, one 4*16 = 64-pixel noise map a seed
    got = decoder_block_work(1, 16, 64, torch.float32, hashed=True, emit_feat=False,
                             frames=2)
    assert got == {
        "bytes": 8192 + 1536 + 8192 + 520 + 768,  # y1, rgb, w2t, b1/b2/nw, wrgb
        "bf16_flops": 2 * 128 * 64 * 64,
        "f32_dot": 2 * 128 * 3 * 64 + 2 * 64 * HASH_OPS,
        "f32_apart": 10.25 * 128 * 64 + 2 * 128,
    }


@pytest.mark.parametrize("hashed", [False, True])
def test_k2_apart_count_follows_the_plain_version(hashed):
    """The f32 instructions decoder_block_plain's element-wise work takes on
    each output value at its rounding points: a blend pass is 1.5 an output
    (one .75 product shared by two outputs, one fused .25 multiply-add),
    the row pass makes half the values; noise1 + b1 (2), lrelu (2
    products), noise2 + b2 (2), lrelu (2)."""
    assert K2_APART_PER_VALUE == 1.5 / 2 + 1.5 + 2 + 2 + 2 + 2
    a = decoder_block_work(4, 16, 128, torch.bfloat16, hashed, emit_feat=True)
    b = decoder_block_work(4, 16, 128, torch.bfloat16, hashed, emit_feat=True, emit_rgb=False)
    assert a["f32_apart"] == b["f32_apart"] and b["f32_dot"] == (
        2 * (4 * 4 * 16) * HASH_OPS if hashed else 0)  # two maps of 2Hp x 2Wp
    assert a["bytes"] - b["bytes"] == 4 * 4 * 4 * 16 * 3 + 2 * 3 * 128


def test_k2_work_at_the_new_channel_counts_by_hand():
    # C = 512 (the streamed-weight kernel): y1 (1, 16, 512) bf16, noise
    # buffers, feat and rgb: 4*1*16 = 64 output pixels; the weight dominates
    got = decoder_block_work(1, 16, 512, torch.bfloat16, hashed=False, emit_feat=True)
    assert got == {
        # y1, noise, feat, rgb, w2t, b1/b2/nw, wrgb
        "bytes": 16384 + 256 + 65536 + 768 + 524288 + 4104 + 3072,
        "bf16_flops": 2 * 64 * 512 * 512,
        "f32_dot": 2 * 64 * 3 * 512,
        "f32_apart": 10.25 * 64 * 512 + 2 * 64,
    }
    # C = 16: y1 (2*1, 16, 16) f32 as 2 frames, hash noise, rgb only: 128
    # output pixels, one 64-pixel map a seed
    got = decoder_block_work(1, 16, 16, torch.float32, hashed=True, emit_feat=False, frames=2)
    assert got == {
        "bytes": 2048 + 1536 + 512 + 136 + 192,  # y1, rgb, w2t, b1/b2/nw, wrgb
        "bf16_flops": 2 * 128 * 16 * 16,
        "f32_dot": 2 * 128 * 3 * 16 + 2 * 64 * HASH_OPS,
        "f32_apart": 10.25 * 128 * 16 + 2 * 128,
    }


@pytest.mark.parametrize("c", [1024, 2048])
def test_k2_work_at_the_streamed_channel_counts_by_hand(c):
    """decoder_block_work is generic in C: at the channel counts of decoders
    at channel multipliers 8 and 16 (the streamed-weight kernel at 64- and
    32-pixel tiles) its terms are the same formulas, written out here for
    y1 (1, 16, C) bf16, noise buffers, feat and rgb: 64 output pixels."""
    got = decoder_block_work(1, 16, c, torch.bfloat16, hashed=False, emit_feat=True)
    assert got == {
        # y1, noise, feat, rgb, w2t, b1/b2/nw, wrgb
        "bytes": 16 * c * 2 + 256 + 64 * c * 2 + 768 + c * c * 2 + 4 * (2 * c + 2)
        + 3 * c * 2,
        "bf16_flops": 2 * 64 * c * c,
        "f32_dot": 2 * 64 * 3 * c,
        "f32_apart": 10.25 * 64 * c + 2 * 64,
    }


def test_k2_times_tool_refuses_a_host_without_the_card():
    """The timing tool (python -m cips3dpp_torch.tools.k2_times) times on the
    card only: on a host without one it stops with a message, never timing
    the plain version in the kernel's place."""
    from cips3dpp_torch.tools import k2_times

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        k2_times.main(["--shapes", "16x16x384"])
