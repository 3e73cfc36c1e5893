# Frozen copy of cips3dpp_torch/ops/__init__.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
from .fused_act import fused_leaky_relu
from .upfirdn2d import blur, downsample2x, make_blur_kernel, upsample2x
from .modulated import (grouped_conv, modulate_weights_1x1, modulate_weights_kxk,
                        modulated_conv2d, modulated_matmul)

__all__ = [
    "blur", "downsample2x", "fused_leaky_relu", "make_blur_kernel",
    "upsample2x",
    "grouped_conv", "modulate_weights_1x1", "modulate_weights_kxk", "modulated_conv2d",
    "modulated_matmul",
]
