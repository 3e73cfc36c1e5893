"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the SIREN render (`siren_render`) and the decoder upsample block
(`decoder_block`), chained by `decoder_fused`."""

from ._lib import LAUNCHES, build_all, reset_launches

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
