"""The `train` and `sphere-init` commands (counterpart of
cips3dpp_tpu/apps/cli_train_impl.py).

Seeds as in the JAX package: the weights from `--seed`, sphere init from
`--seed + 1`, the loop's draws from `--seed + 2` (re-seeded on resume, as
the JAX command re-seeds its key). Everything runs on the card unless
`--device cpu` is given.

`train` runs data-parallel when `--n-devices` is given or more than one GPU
is visible, as the JAX command builds its mesh (cli_train_impl.py:37-38):
`--n-devices N > 1` spawns N ranks, one a GPU (gloo ranks with
`--device cpu`); `--n-devices 1` runs a one-rank NCCL group in this
process. Every rank seeds alike and takes its rows of the global batch.
`--fid-data` adds the in-training FID at every checkpoint, with the JAX
command's settings (cli_train_impl.py:119-141): 8 a batch, min(len, 512)
images, seed 1 for the reals, the generator's draws from seed 0 on a
generator of their own. `--init-renderer-from` grafts a StyleSDF stage-1
renderer (io/checkpoint.py:graft_renderer) into G and G_ema and skips the
sphere init, as the JAX command does.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..device import resolve_device


def _setup(args, cfg, mesh=None):
    from ..io.config import generator_config_from_dict, train_config_from_dict
    from ..models.discriminator import DStyleGANProgressive
    from ..models.discriminator_pose import DVolumeRenderProgressive
    from ..models.generator import Generator
    from ..train.train_loop import Trainer

    dev = resolve_device(args.device) if mesh is None else mesh.device
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
    trainer = Trainer(gen, d_dec, d_ren, gcfg, tcfg, args.outdir, mesh=mesh,
                      config_snapshot=cfg)
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


def _fid_hook(args, tcfg, dev, mesh):
    """The in-training FID of the JAX command (cli_train_impl.py:119-141),
    and the real-batch iterator it reads (to close)."""
    from ..io.dataset import data_iterator, open_dataset
    from ..models.inception import init_inception
    from ..train.train_loop import TrainHooks
    from .eval_fid import eval_fid

    if args.inception:
        from ..io.weights import load_inception

        incep, _ = load_inception(path=args.inception, device=dev)
    else:
        incep = init_inception(torch.Generator().manual_seed(0), device=dev)
    fid_ds = open_dataset(args.fid_data, resolution=tcfg.data_img_size)
    fid_it = data_iterator(fid_ds, 8, seed=1)
    n_eval = min(len(fid_ds), 512)

    def fid_hook(state):
        reals = (next(fid_it) for _ in range(max(n_eval // 8, 1)))
        # a stream of its own, so evaluating leaves the training draws as they are
        gen = torch.Generator(dev).manual_seed(0)
        return eval_fid(state.g_ema, reals, incep, n_fake=n_eval, batch_size=8,
                        generator=gen, mesh=mesh).fid

    return TrainHooks(eval_fid=fid_hook), fid_it


def run_training(args, cfg):
    """`train` on one process, on a one-rank group, or spawned over N ranks."""
    n_dev = getattr(args, "n_devices", None)
    dev = resolve_device(args.device)
    if n_dev is None and dev.type == "cuda" and torch.cuda.device_count() > 1:
        n_dev = torch.cuda.device_count()
    if n_dev is None:
        _train(args, cfg, None)
    elif n_dev > 1:
        from ..parallel.mesh import run_ranks

        run_ranks(_train_rank, n_dev, args, cfg, device=args.device)
    else:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(1, device=args.device)
        try:
            _train(args, cfg, mesh)
        finally:
            mesh.close()


def _train_rank(mesh, args, cfg):
    _train(args, cfg, mesh)
    return {"rank": mesh.rank}


def _train(args, cfg, mesh):
    from ..io.checkpoint import CheckpointManager, checkpoint_steps
    from ..io.dataset import data_iterator, open_dataset

    trainer, state, tcfg, dev = _setup(args, cfg, mesh)
    # open the datasets first: a bad path fails before any step
    ds = open_dataset(args.data, resolution=tcfg.data_img_size)
    hooks = fid_it = None
    if getattr(args, "fid_data", None):
        hooks, fid_it = _fid_hook(args, tcfg, dev, mesh)

    start = 0
    if args.resume:
        restored, start = trainer.resume(state)
        if restored is not None:
            state = restored
            if trainer.main:
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
        if trainer.main:
            print(f"[train] finetuning from {args.finetune_dir}", file=sys.stderr)

    graft_from = getattr(args, "init_renderer_from", None)
    if graft_from and start == 0:
        # the StyleSDF stage-1 -> stage-2 handoff (train_full_pipeline.py:484):
        # the trained volume renderer and its mapping (stage 1's G_ema) seed G
        # and G_ema; the decoder, the discriminators and the optimizers stay
        # fresh (cips3dpp_tpu/apps/cli_train_impl.py:89-113)
        from ..io.checkpoint import graft_renderer

        raw = CheckpointManager(graft_from).restore_raw() \
            if checkpoint_steps(graft_from) else None
        if raw is None:
            raise FileNotFoundError(f"no checkpoint found in {graft_from}")
        src = raw["state"]["g_ema"]
        for module in (state.g, state.g_ema):
            module.load_state_dict(graft_renderer(module.state_dict(), src))
        if trainer.main:
            print(f"[train] renderer grafted from {graft_from}", file=sys.stderr)

    if tcfg.init_renderer and start == 0 and not args.no_sphere_init \
            and not getattr(args, "finetune_dir", None) and not graft_from:
        state = trainer.sphere_init(state, _loop_generator(dev, args.seed + 1))

    it = data_iterator(ds, tcfg.batch, seed=args.seed)
    try:
        state = trainer.train(state, it, _loop_generator(dev, args.seed + 2),
                              start_iter=start, total_iters=args.total_iters, hooks=hooks)
    finally:
        it.close()
        if fid_it is not None:
            fid_it.close()
    trainer.save(args.total_iters or tcfg.total_iters, state)
    if trainer.main:
        print(json.dumps({"outdir": args.outdir, "done": True}))
