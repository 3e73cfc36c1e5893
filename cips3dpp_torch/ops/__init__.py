from .fused_act import fused_leaky_relu
from .upfirdn2d import blur, downsample2x, make_blur_kernel, upsample2x
from .modulated import modulate_weights_1x1, modulated_matmul

__all__ = [
    "blur", "downsample2x", "fused_leaky_relu", "make_blur_kernel",
    "upsample2x",
    "modulate_weights_1x1", "modulated_matmul",
]
