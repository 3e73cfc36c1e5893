"""Which layer a device kernel of the trace belongs to, by its name: K1
(`siren_render*` in csrc/siren_render.cu), K2 (`block_kernel*` in
csrc/decoder_block.cu), the library GEMMs (cuBLAS / cuBLASLt / CUTLASS
names) and everything else, the element-wise and reduction passes of
eager PyTorch."""

from __future__ import annotations

import re

_GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|cublas|sm90_|sm80_|ampere_|s16816|s1688",
                   re.IGNORECASE)


def kind(name: str) -> str:
    if "siren_render" in name:
        return "k1"
    if "block_kernel" in name:
        return "k2"
    if _GEMM.search(name):
        return "gemm"
    return "elementwise"
