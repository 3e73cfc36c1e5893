"""K1's width-512 build (siren_render_kernel_wide) on the CPU: the weight
layout `siren_prepare` makes for it. The kernel streams each 512 x 512
bf16 weight as 16 KB chunks of 128 output x 64 input features, pass by
pass, each row's 16-byte groups swizzled by row % 8 (`chunk_weight`); the
layout must hold every weight value once, invert to the (out, in) copy
bit for bit, and exist only at the width whose build reads it. The
kernel itself runs on the card only (tests/test_torch_port_gpu.py)."""

import pytest
import torch

from cips3dpp_torch.kernels import siren_render as ksr
from cips3dpp_torch.kernels.decoder_block import chunk_weight
from cips3dpp_torch.models.layers import init_parameters
from cips3dpp_torch.models.renderer import VolumeFeatureRenderer


def _prepared(width, seed=0):
    gen = torch.Generator().manual_seed(seed)
    rend = init_parameters(VolumeFeatureRenderer(depth=2, hidden_dim=width), gen)
    styles = torch.randn((3, 256), generator=gen)
    return ksr.siren_prepare(rend, styles, torch.tensor(0.88), torch.tensor(1.12))


def _unchunk(flat, width=512):
    """The inverse of the chunked layout: row n of chunk (pass p, chunk k)
    holds the input features 64k .. 64k + 63 of output feature 128p + n,
    its 16-byte group j at j ^ (n % 8)."""
    chunks = flat.reshape(width // 128, width // 64, 128, 8, 8)  # pass, chunk, row, group, value
    back = torch.empty((width, width), dtype=flat.dtype)
    for n in range(128):
        groups = chunks[:, :, n, [j ^ (n % 8) for j in range(8)]]  # (pass, chunk, j, value)
        back[n::128] = groups.reshape(width // 128, width)
    return back


@pytest.mark.parametrize("field,source", [("w1c", "w1t"), ("wvhc", "wvht")])
def test_wide_weight_chunks_invert(field, source):
    """The chunked weight undoes to the (out, in) bf16 weight bit for bit,
    and a few of its 16-byte groups sit where the kernel reads them."""
    prep = _prepared(ksr.WIDE_WIDTH)
    flat, w = prep[field], prep[source]
    assert flat.shape == (512 * 512,) and flat.dtype == torch.bfloat16 and flat.is_contiguous()
    assert torch.equal(_unchunk(flat), w)
    chunks = flat.reshape(4, 8, 128, 8, 8)
    for p, k, n, j in ((0, 0, 0, 0), (1, 2, 13, 3), (3, 7, 127, 7)):
        assert torch.equal(chunks[p, k, n, j ^ (n % 8)],
                           w[128 * p + n, 64 * k + 8 * j:64 * k + 8 * j + 8])


@pytest.mark.parametrize("field", ["w1c", "wvhc"])
def test_wide_weight_chunks_hold_every_value_once(field):
    """The layout is a permutation of the weight's positions: chunking the
    positions 0 .. W^2 - 1 themselves gives each exactly once."""
    prep = _prepared(ksr.WIDE_WIDTH, seed=1)
    # positions as values: bf16 holds integers exactly only to 256, so the
    # three base-64 digits of each position go through the layout apart
    pos = torch.arange(512 * 512).reshape(512, 512)
    placed = sum(64**d * chunk_weight((pos // 64**d % 64).to(torch.bfloat16)).long()
                 for d in range(3))
    assert torch.equal(torch.sort(placed).values, torch.arange(512 * 512))
    # and the prepared field is the weight moved by that permutation
    src = "w1t" if field == "w1c" else "wvht"
    assert torch.equal(prep[field], prep[src].reshape(-1)[placed])


@pytest.mark.parametrize("width", [32, 64, 128, 256, 512, 384, 640, 1024, 1152, 2176])
def test_wide_weight_chunks_only_at_width_512(width):
    """Only the wide kernel's builds read the chunked weights: siren_prepare
    makes them at every width they run (512, and past it each multiple of
    128, in the one run-time-width build) and at no width the mma.sync
    builds run, beside the (out, in) copies every build's checks see, all
    at the build's width."""
    prep = _prepared(width, seed=width)
    kw = ksr.kernel_build(width, 24).width
    wide = kw >= ksr.WIDE_WIDTH
    assert ("w1c" in prep) == wide and ("wvhc" in prep) == wide
    assert prep["w1t"].shape == prep["wvht"].shape == (kw, kw)
    build = f"-DK1_W={kw}" if kw <= ksr.WIDE_WIDTH else ksr.RUN_TIME_WIDTH_DEFINE
    assert ksr.kernel_defines(width, 24 if width != 256 else 20) == (build, "-DK1_FIXED_S=0")
