"""The frozen work arithmetic against counts worked by hand at small
shapes, and the FLOP counter against known products."""

from __future__ import annotations

import pytest
import torch

from portbench.work import roofline as W
from portbench.work.flops import FlopCount
from portbench.work.kernels import kind


def test_k1_work_by_hand():
    # r = 2 rays x s = 3 samples at width 4: rows 6
    # bytes: 4 (6*3 + 2*3 + 6 + 2 + 2*(3 + 4 + 3 + 2) + 6) = 248, weights
    # 2*2*16 = 64 and 4 (4*17 + 4) = 288
    assert W.k1_work(2, 3, 4) == (600, 6 * 2 * 2 * 16, 6 * 4 * 14, 6 * 4 * 47)


def test_decoder_block_work_by_hand():
    # y1 (1, 2, 16), bf16 storage, buffers, feat and rgb out: 8 output pixels
    w = W.decoder_block_work(1, 2, 16, 2, hashed=False, emit_feat=True)
    # y1 64 + noise 32 + feat 256 + rgb 96 + w2 512 + biases 136 + wrgb 96
    assert w == {"bytes": 1192, "bf16_flops": 4096, "f32_dot": 768,
                 "f32_apart": 10.25 * 128 + 16}
    hashed = W.decoder_block_work(1, 2, 16, 2, hashed=True, emit_feat=False, frames=2)
    assert hashed["bytes"] == 128 + 4 * 16 * 3 + 512 + 136 + 96  # no noise, no feat
    assert hashed["f32_dot"] == 2 * 16 * 3 * 16 + 2 * 8 * W.HASH_OPS


def test_bound_takes_the_larger_time():
    ms, by = W.bound(3.35e9)  # 3.35 GB at 3.35 TB/s
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = W.bound(0, bf16_flops=989e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = W.bound(0, f32_flops=67e9, f32_apart=33.5e9)
    assert ms == pytest.approx(2.0)


def test_flop_count_of_known_products():
    a, b = torch.zeros(3, 5, device="meta"), torch.zeros(5, 7, device="meta")
    x = torch.zeros(2, 4, 8, 8, device="meta")
    w = torch.zeros(6, 4, 3, 3, device="meta")
    with FlopCount() as fc:
        a @ b
        torch.nn.functional.conv2d(x, w, padding=1)
        (a * 2).sum()
    assert fc.total == 2 * 3 * 5 * 7 + 2 * (2 * 6 * 8 * 8) * (4 * 9)


def test_kernel_kinds():
    assert kind("void (anonymous namespace)::siren_render_kernel<false>(float)") == "k1"
    assert kind("void block_kernel_wide<64, 320>(Params)") == "k2"
    assert kind("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8") == "gemm"
    assert kind("nvjet_tst_128x64_64x8_1x1_v_bz_TNT") == "gemm"
    assert kind("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
