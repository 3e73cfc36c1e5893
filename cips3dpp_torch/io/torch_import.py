"""Reference `.pth` checkpoints: reading and checking them against the
port's modules (counterpart of cips3dpp_tpu/io/torch_import.py:27-219).

The port's modules carry the reference's state-dict names and layouts
(model_v3.py's style.*, style_decoder.*, renderer.network.*, decoder.*;
discriminator.py's conv_in.*, blocks.*, final_*), so a released
`G_ema.pth` loads by name with no transposes. What this module adds is the
check before the load: the manifest of keys and shapes comes from the
module itself, and a checkpoint that does not match it fails with the keys
that differ, instead of loading part of its tensors.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

#: state-dict keys the reference writes and the port leaves out: the
#: Blur/Upsample FIR buffers (constants rebuilt from blur_kernel) and the
#: fixed noise buffers (explicit arguments here, model_v3.py:1044-1046).
#: The JAX package's list (cips3dpp_tpu/io/torch_import.py:150).
IGNORED_KEY_MARKERS = (".kernel", "noises.", "noise_")


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A `.pth` state dict on the CPU (weights_only: tensors and
    containers, no code); a pickled module is unwrapped to its state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def state_dict_manifest(module: nn.Module) -> dict[str, tuple]:
    """{key: shape} of the state dict `module` loads: the architecture is
    the manifest, so a checkpoint of another configuration fails loudly."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def validate_torch_state_dict(torch_sd: Mapping, module: nn.Module,
                              strict: bool = True) -> dict:
    """Check a state dict against `module`'s manifest. Returns
    {"n_expected", "n_matched", "missing": [...], "shape_mismatch":
    {key: (want, got)}, "ignored": [...], "unexpected": [...]}; with
    strict=True raises ValueError on a missing key or a shape mismatch
    (unexpected extra keys only warn, as in the JAX package)."""
    manifest = state_dict_manifest(module)
    missing = sorted(k for k in manifest if k not in torch_sd)
    shape_mismatch = {
        k: (manifest[k], tuple(torch_sd[k].shape))
        for k in manifest if k in torch_sd and tuple(torch_sd[k].shape) != manifest[k]
    }
    extra = [k for k in torch_sd if k not in manifest]
    ignored = sorted(k for k in extra if any(m in k for m in IGNORED_KEY_MARKERS))
    unexpected = sorted(set(extra) - set(ignored))
    report = {
        "n_expected": len(manifest),
        "n_matched": len(manifest) - len(missing) - len(shape_mismatch),
        "missing": missing,
        "shape_mismatch": shape_mismatch,
        "ignored": ignored,
        "unexpected": unexpected,
    }
    if strict and (missing or shape_mismatch):
        lines = [f"torch state dict does not match the model architecture "
                 f"({report['n_matched']}/{report['n_expected']} keys match):"]
        lines += [f"  missing: {k}  (want shape {manifest[k]})" for k in missing[:20]]
        lines += [f"  shape mismatch: {k}  want {want}, got {got}"
                  for k, (want, got) in list(shape_mismatch.items())[:20]]
        more = max(0, len(missing) - 20) + max(0, len(shape_mismatch) - 20)
        if more:
            lines.append(f"  ... and {more} more")
        lines.append("Check the G_cfg (renderer n_layers / decoder size_end / mapping "
                     "depths) matches the checkpoint's config_command.yaml.")
        raise ValueError("\n".join(lines))
    return report


def load_validated(module: nn.Module, torch_sd: Mapping, strict: bool = True) -> dict:
    """Validate `torch_sd` against `module` (strictly by default), then load
    the manifest's tensors into it. Returns the report."""
    report = validate_torch_state_dict(torch_sd, module, strict=strict)
    keep = {k: torch_sd[k] for k in state_dict_manifest(module)
            if k in torch_sd and k not in report["shape_mismatch"]}
    module.load_state_dict(keep, strict=strict)
    return report
