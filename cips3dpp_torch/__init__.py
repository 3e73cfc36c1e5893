"""CIPS-3D++ in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

The serving path of the JAX package (`cips3dpp_tpu`) ported module by
module: mapping MLPs -> camera/rays -> fused SIREN render + SDF
integration (CUDA kernel, `kernels/siren_render.py`) -> CIPS decoder whose
upsample blocks are one CUDA kernel each (`kernels/decoder_block.py`);
the sampling apps (`apps/`), the training steps (`train/`: both
discriminators, the losses, the per-group optimizers, the D step
rendering its fakes through the SIREN kernel), flip-inversion
(`apps/inversion.py`: the camera's gradient through the SIREN kernel),
data-parallel training over rank processes (`parallel/mesh.py`), FID
(`models/inception.py`, `apps/eval_fid.py`) and dataset preparation
(`io/dataset.py`, `io/native_loader.py`).

Layout follows the JAX package: NHWC at every public function, the same
module and function names. Entry points run on the card unless the caller
passes `device="cpu"`; CUDA code is built and loaded only when a kernel is
first launched, so the package imports on a host without a GPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
