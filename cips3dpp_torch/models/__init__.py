from .decoder import Decoder
from .generator import (
    DecoderConfig,
    Generator,
    GeneratorConfig,
    MappingConfig,
    RendererConfig,
    preset_compcars,
    preset_r1024,
    preset_r512,
    preset_r64,
    preset_serving,
)
from .renderer import VolumeFeatureRenderer

__all__ = [
    "Decoder", "DecoderConfig", "Generator", "GeneratorConfig",
    "MappingConfig", "RendererConfig", "VolumeFeatureRenderer",
    "preset_compcars", "preset_r1024", "preset_r512", "preset_r64",
    "preset_serving",
]
