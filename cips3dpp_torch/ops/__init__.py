from .fused_act import fused_leaky_relu
from .upfirdn2d import make_blur_kernel, upsample2x
from .modulated import modulate_weights_1x1, modulated_matmul

__all__ = [
    "fused_leaky_relu", "make_blur_kernel", "upsample2x",
    "modulate_weights_1x1", "modulated_matmul",
]
