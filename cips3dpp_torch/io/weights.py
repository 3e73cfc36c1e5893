"""Real-weight discovery behind one environment variable,
``CIPS3DPP_WEIGHTS_DIR`` (counterpart of cips3dpp_tpu/io/weights.py).

The reference's metrics pull pretrained torch weights (the VGG16
perceptual loss, vgg_per_loss.py:202-340; LPIPS through the lpips
package). Nothing is bundled or fetched: each loader takes an explicit
path, else the first of the standard file names under
$CIPS3DPP_WEIGHTS_DIR, else falls back to random weights. Every result is
tagged "imported" or "random", so random-weight numbers are never taken
for comparable ones.

  vgg16-397923af.pth          torchvision VGG16 (perceptual loss and LPIPS trunk)
  lpips_vgg.pth  (or vgg.pth) LPIPS v0.1 vgg lin weights
  pt_inception-2015-12-05-6726825d.pth  torch-fidelity pt_inception (FID, KID)

The files are torch state dicts, read with `weights_only=True`.
"""

from __future__ import annotations

import os
import sys

import torch

from ..device import resolve_device

WEIGHTS_DIR_ENV = "CIPS3DPP_WEIGHTS_DIR"

VGG16_FILENAMES = ("vgg16-397923af.pth", "vgg16.pth")
LPIPS_FILENAMES = ("lpips_vgg.pth", "vgg.pth")
INCEPTION_FILENAMES = ("pt_inception-2015-12-05-6726825d.pth", "pt_inception.pth")


def find_weight(filenames, explicit: str | None = None) -> str | None:
    """An explicit path wins, else the first of `filenames` that exists
    under $CIPS3DPP_WEIGHTS_DIR, else None."""
    if explicit:
        return explicit
    d = os.environ.get(WEIGHTS_DIR_ENV)
    if not d:
        return None
    for name in filenames:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def _note(msg: str):
    print(f"[weights] {msg}", file=sys.stderr)


def _state_dict(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_vgg(generator: torch.Generator | None = None, path: str | None = None,
             device=None):
    """(VGG16Features, provenance): torchvision's VGG16 if a file is
    found, else `init_vgg(generator)` (default seed 0), the reference's
    'vgg16_conv_random' mode."""
    from ..models.vgg import VGG16Features, init_vgg

    p = find_weight(VGG16_FILENAMES, path)
    if p:
        _note(f"VGG16 perceptual trunk <- {p}")
        vgg = VGG16Features().requires_grad_(False)
        vgg.load_state_dict({k: v for k, v in _state_dict(p).items()
                             if k.startswith("features.")})
        return vgg.to(resolve_device(device)), "imported"
    _note("no VGG16 weights (set $CIPS3DPP_WEIGHTS_DIR): random-VGG perceptual "
          "metric (reference 'vgg16_conv_random' mode)")
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    return init_vgg(gen, device), "random"


def load_lpips(generator: torch.Generator | None = None, vgg_path: str | None = None,
               lin_path: str | None = None, device=None):
    """(LPIPS, provenance): real LPIPS needs both the VGG16 trunk and the
    lin weights; anything less falls back to the tagged random metric."""
    from ..utils.lpips import import_lpips_torch, init_lpips

    pv = find_weight(VGG16_FILENAMES, vgg_path)
    pl = find_weight(LPIPS_FILENAMES, lin_path)
    if pv and pl:
        _note(f"LPIPS <- trunk {pv} + lin {pl}")
        return import_lpips_torch(_state_dict(pv), _state_dict(pl), device), "imported"
    _note("no LPIPS weights (set $CIPS3DPP_WEIGHTS_DIR): random fallback")
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    return init_lpips(gen, device), "random"


def load_inception(generator: torch.Generator | None = None, path: str | None = None,
                   device=None):
    """(InceptionV3Features, provenance): torch-fidelity's pt_inception if
    a file is found (the reference's FID protocol, eval_fid.py:52-63), else
    `init_inception(generator)` (default seed 0), tagged "random": its FID
    and KID are comparable only with each other."""
    from ..models.inception import InceptionV3Features, init_inception

    p = find_weight(INCEPTION_FILENAMES, path)
    if p:
        _note(f"Inception (FID) <- {p}")
        model = InceptionV3Features(device="cpu")
        sd = _state_dict(p)
        # the file also holds the classifier (fc.*), which FID does not use
        model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("fc.")})
        return model.to(resolve_device(device)), "imported"
    _note("no Inception weights (set $CIPS3DPP_WEIGHTS_DIR): FID/KID numbers are NOT "
          "comparable to published values")
    return init_inception(generator, device), "random"
