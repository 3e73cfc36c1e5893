"""Weight bridge: the JAX package's generator param tree -> this package's
state dict.

The input is the nested dict of `variables["params"]` of the flax
Generator, as numpy arrays (or anything `np.asarray` takes). The output
uses the reference's torch state-dict names and layouts, which are this
package's module names, so `Generator.load_state_dict` takes it as is:

    flax Linear        (in, out)        -> (out, in)
    flax modulated conv (k, k, in, out) -> (1, out, in, k, k)

The mapping is this package's own copy of the JAX package's exporter
(`io/torch_import.py:export_generator_state_dict`); it imports nothing of
JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict of the whole generator tree, or of the parts present
    (a tree holding only "renderer" or "decoder" gives those keys)."""
    out: dict[str, np.ndarray] = {}

    def linear(w):
        return np.ascontiguousarray(np.asarray(w, np.float32).T)

    def modconv(w):
        w = np.asarray(w, np.float32)  # (k, k, in, out)
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))[None]

    def put_linear(prefix, node):
        out[f"{prefix}.weight"] = linear(node["weight"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)

    def put_film(prefix, node):
        put_linear(prefix, node)
        put_linear(f"{prefix}.gamma", node["gamma"])
        put_linear(f"{prefix}.beta", node["beta"])

    def put_modconv(prefix, node):
        out[f"{prefix}.weight"] = modconv(node["weight"])
        put_linear(f"{prefix}.modulation", node["modulation"])

    def put_styled(prefix, node):
        put_modconv(f"{prefix}.conv", node["conv"])
        out[f"{prefix}.noise.weight"] = np.asarray(node["noise"]["weight"], np.float32)
        bias = np.asarray(node["act_bias"], np.float32)
        out[f"{prefix}.activate.bias"] = bias
        # the reference's unused StyledConv.bias
        out[f"{prefix}.bias"] = np.zeros((1, bias.shape[0], 1, 1), np.float32)

    def put_torgb(prefix, node):
        put_modconv(f"{prefix}.conv", node["conv"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32).reshape(1, -1, 1, 1)

    i = 0
    while f"style_{i}" in params:
        put_linear(f"style.{i}", params[f"style_{i}"])
        i += 1
    i = 0
    while f"style_decoder_{i}" in params:
        # index 0 of the reference Sequential is PixelNorm
        put_linear(f"style_decoder.{i + 1}", params[f"style_decoder_{i}"])
        i += 1

    if "renderer" in params:
        rend = params["renderer"]
        out["renderer.sigmoid_beta"] = np.asarray(rend["sigmoid_beta"], np.float32)
        net = rend["network"]
        i = 0
        while f"pts_{i}" in net:
            put_film(f"renderer.network.pts_linears.{i}", net[f"pts_{i}"])
            i += 1
        put_film("renderer.network.views_linears", net["views"])
        put_linear("renderer.network.rgb_linear", net["rgb_head"])
        put_linear("renderer.network.sigma_linear", net["sigma_head"])

    if "decoder" in params:
        dec = params["decoder"]
        put_styled("decoder.conv1", dec["conv1"])
        put_torgb("decoder.to_rgb1", dec["to_rgb1"])
        i = 0
        while f"convs_{i}" in dec:
            put_styled(f"decoder.convs.{i}", dec[f"convs_{i}"])
            i += 1
        i = 0
        while f"to_rgbs_{i}" in dec:
            put_torgb(f"decoder.to_rgbs.{i}", dec[f"to_rgbs_{i}"])
            i += 1
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX generator param tree into `model` (strict: every key and
    shape must match)."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model
