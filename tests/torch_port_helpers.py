"""Shared helpers of the cips3dpp_torch parity tests (tests/test_torch_port_*.py).

Inputs are drawn with numpy from a seed and handed to both packages as
arrays; JAX stays on the CPU (tests/conftest.py) and the port runs with
device="cpu", i.e. through the plain versions of its kernels.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

# Tier-1 runs several xdist workers: keep each one's torch to one thread
torch.set_num_threads(1)


def np_tree(tree):
    """JAX param tree -> nested dict of float32 numpy arrays (a copy)."""
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def t(a) -> torch.Tensor:
    """numpy/JAX array -> CPU float32 torch tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def a(x) -> np.ndarray:
    """torch tensor or JAX array -> float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def port_and_jax_generator(jax_cfg, torch_cfg, seed: int):
    """A seeded port Generator whose zero-initialised parameters
    (NoiseInjection weights, act_bias, ToRGB bias) are set to nonzero draws,
    so the noise and bias paths are exercised, and the same weights as
    flax variables for the JAX Generator (through the JAX package's
    importer of reference state dicts)."""
    from cips3dpp_tpu.io.torch_import import import_generator_state_dict
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.models.layers import randomize_zero_init_

    model = Generator(torch_cfg, device="cpu", seed=seed)
    randomize_zero_init_(model, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = import_generator_state_dict(
        sd, jax_cfg.renderer.n_layers, len(model.decoder.to_rgbs),
        jax_cfg.mapping.n_layers, jax_cfg.decoder.mapping_n_layers,
    )
    return model, variables


def port_renderer(rparams, width: int, style_dim: int = 256):
    """cips3dpp_torch VolumeFeatureRenderer loaded from a JAX renderer tree."""
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    sd = jax_params_to_state_dict({"renderer": rparams})
    sd = {k[len("renderer."):]: v for k, v in sd.items()}
    r = VolumeFeatureRenderer(depth=2, hidden_dim=width, style_dim=style_dim)
    r.load_state_dict(sd, strict=True)
    return r
