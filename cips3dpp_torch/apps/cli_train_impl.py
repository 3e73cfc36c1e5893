"""The `train` and `sphere-init` commands (counterpart of
cips3dpp_tpu/apps/cli_train_impl.py).

Seeds as in the JAX package: the weights from `--seed`, sphere init from
`--seed + 1`, the loop's draws from `--seed + 2` (re-seeded on resume, as
the JAX command re-seeds its key). Everything runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..device import resolve_device


def _not_ported(args):
    """Flags of the JAX command whose paths the port does not have yet."""
    if (getattr(args, "n_devices", None) or 1) > 1:
        raise NotImplementedError("--n-devices > 1: data-parallel training is not "
                                  "ported (ROADMAP queue 1 item 2, parallel)")
    if getattr(args, "fid_data", None) or getattr(args, "inception", None):
        raise NotImplementedError("--fid-data / --inception: in-training FID is not "
                                  "ported (ROADMAP queue 1 item 5, FID)")
    if getattr(args, "init_renderer_from", None):
        raise NotImplementedError("--init-renderer-from: the StyleSDF stage handoff "
                                  "(graft_renderer) is not ported (ROADMAP queue 1 item 7)")


def _setup(args, cfg):
    from ..io.config import generator_config_from_dict, train_config_from_dict
    from ..models.discriminator import DStyleGANProgressive
    from ..models.discriminator_pose import DVolumeRenderProgressive
    from ..models.generator import Generator
    from ..train.train_loop import Trainer

    _not_ported(args)
    dev = resolve_device(args.device)
    gcfg = generator_config_from_dict(cfg.get("G_cfg", {}))
    tcfg = train_config_from_dict(cfg)
    d_cfg = cfg.get("D_cfg", {})
    dr_cfg = cfg.get("D_renderer_cfg", {})
    # the weights are drawn again from --seed by init_state
    gen = Generator(gcfg, device=dev)
    d_dec = DStyleGANProgressive(
        input_size=d_cfg.get("input_size", 1024),
        channel_multiplier=d_cfg.get("channel_multiplier", 2),
        pretrained_size=d_cfg.get("pretrained_size"),
        diffaug=d_cfg.get("diffaug", False), device=dev,
    )
    d_ren = DVolumeRenderProgressive(
        input_size=dr_cfg.get("input_size", 1024),
        viewpoint_loss=dr_cfg.get("viewpoint_loss", True),
        pretrained_size=dr_cfg.get("pretrained_size"), device=dev,
    )
    trainer = Trainer(gen, d_dec, d_ren, gcfg, tcfg, args.outdir, config_snapshot=cfg)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    return trainer, state, tcfg, dev


def _loop_generator(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def run_sphere_init(args, cfg):
    trainer, state, _, dev = _setup(args, cfg)
    state = trainer.sphere_init(state, _loop_generator(dev, args.seed + 1),
                                n_iters=getattr(args, "n_iters", None))
    trainer.checkpointer().save(0, state, config=cfg)
    print(json.dumps({"ckpt": os.path.join(args.outdir, "ckpt"), "step": 0}))


def run_training(args, cfg):
    from ..io.checkpoint import CheckpointManager
    from ..io.dataset import data_iterator, open_dataset

    trainer, state, tcfg, dev = _setup(args, cfg)

    start = 0
    if args.resume:
        restored, start = trainer.resume(state)
        if restored is not None:
            state = restored
            print(f"[train] resumed from step {start}", file=sys.stderr)

    if getattr(args, "finetune_dir", None) and start == 0:
        # Finetune (reference tl_finetune, train_v10.py:1225-1245): every
        # model from the source run (a checkpoint directory of this
        # package); G starts from G_ema, the step count from 0.
        src = CheckpointManager(args.finetune_dir)
        if src.restore(state) is None:
            raise FileNotFoundError(f"no checkpoint found in {args.finetune_dir}")
        state.g.load_state_dict(state.g_ema.state_dict())
        state.step = 0
        print(f"[train] finetuning from {args.finetune_dir}", file=sys.stderr)

    if tcfg.init_renderer and start == 0 and not args.no_sphere_init \
            and not getattr(args, "finetune_dir", None):
        state = trainer.sphere_init(state, _loop_generator(dev, args.seed + 1))

    ds = open_dataset(args.data, resolution=tcfg.data_img_size)
    it = data_iterator(ds, tcfg.batch, seed=args.seed)
    try:
        state = trainer.train(state, it, _loop_generator(dev, args.seed + 2),
                              start_iter=start, total_iters=args.total_iters)
    finally:
        it.close()
    trainer.checkpointer().save(args.total_iters or tcfg.total_iters, state, config=cfg)
    print(json.dumps({"outdir": args.outdir, "done": True}))
