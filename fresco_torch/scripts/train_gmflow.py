"""GMFlow training driver on one device.

Counterpart of ``scripts/train_gmflow.py`` (the reference's vendored
trainer, src/ebsynth/deps/gmflow/main.py: AdamW wd 1e-4, one-cycle LR,
grad clip 1.0): ``parallel.flow_train``'s step, optax's one-cycle cosine
schedule and global-norm clipping as plain torch, ``utils.checkpoint``'s
parameter files, and validation with the reference's metric protocol
every ``--val-every`` steps.  Supervised with ``--dataset`` and
``--data-root`` (or ``--synthetic``), unsupervised video adaptation with
``--frame-dir``.  Runs on the card unless ``--device cpu`` is given.

    python -m fresco_torch.scripts.train_gmflow --synthetic --tiny --steps 2 --device cpu
    python -m fresco_torch.scripts.train_gmflow --synthetic --steps 4 --ckpt-every 2 --ckpt-dir ck
    python -m fresco_torch.scripts.train_gmflow --synthetic --steps 4 --resume ck/step_2

``--data-par N`` trains data parallel over N ranks, one process each
(F23), under ``torchrun --nproc-per-node N`` (or in a process group
already initialized): every rank assembles the same global batch and takes
its slice, the gradients are summed, and only rank 0 writes checkpoints
and logs.  Without a process group of N ranks it raises.

    torchrun --nproc-per-node 2 -m fresco_torch.scripts.train_gmflow --synthetic --steps 4 --data-par 2
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch


def build_index(args):
    from fresco_torch.parallel import flow_data as fd

    if args.frame_dir:
        return fd.index_frame_dir(args.frame_dir)
    builders = {
        "chairs": lambda: fd.index_flying_chairs(args.data_root),
        "sintel": lambda: fd.index_sintel(args.data_root),
        "things": lambda: fd.index_flying_things(args.data_root),
        "kitti": lambda: fd.index_kitti(args.data_root),
    }
    return builders[args.dataset]()


class SyntheticIndex:
    """Random image pairs and flows for offline smoke runs (the JAX
    driver's, draw for draw)."""

    sparse = False

    def __init__(self, size=8, hw=(64, 64), seed=0):
        self.size, self.hw = size, hw
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.size

    def load(self, i):
        h, w = self.hw
        img1 = self.rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        flow = self.rng.uniform(-2, 2, (h, w, 2)).astype(np.float32)
        img2 = np.roll(img1, 1, axis=1)
        return img1, img2, flow, np.ones((h, w), np.float32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="chairs", choices=["chairs", "sintel", "things", "kitti"])
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--frame-dir", default=None, help="unlabelled frames: unsupervised adaptation")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--crop", type=int, nargs=2, default=None)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--warmup-frac", type=float, default=0.05)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10_000)
    ap.add_argument("--val-every", type=int, default=10_000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns {'done': steps taken, 'losses': every logged loss,
    'model': the GMFlow module as it ends}."""
    args = parse_args(argv)
    from fresco_torch.parallel import distributed
    from fresco_torch.parallel.sharding import make_mesh

    if args.data_par > 1:
        distributed.initialize(device_type="cpu" if args.device == "cpu" else None)
    mesh = make_mesh(args.data_par)  # raises without a process group of data_par ranks (F23)
    main_rank = distributed.is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.layers import init_flax_default_
    from fresco_torch.parallel import flow_data as fd
    from fresco_torch.parallel.flow_eval import validate
    from fresco_torch.parallel.flow_train import flow_train_step, make_flow_train_state
    from fresco_torch.pipeline.runner import resolve_device
    from fresco_torch.utils.checkpoint import load_params, save_params

    dev = resolve_device(args.device)
    gcfg = GMFlowConfig.tiny() if args.tiny else GMFlowConfig()
    index = SyntheticIndex() if args.synthetic else build_index(args)
    supervised = args.frame_dir is None
    crop = tuple(args.crop) if args.crop else ((64, 64) if args.synthetic else (384, 512))
    augment = None
    if supervised and not args.synthetic:
        augment = fd.FlowAugmentor(fd.AugmentConfig(crop_size=crop), sparse=index.sparse, seed=args.seed)
    loader = fd.FlowLoader(index, args.batch_size, augment=augment, seed=args.seed, device=dev,
                           mesh=mesh if mesh.data > 1 else None)

    # init / resume
    gen = torch.Generator().manual_seed(args.seed)
    model = init_flax_default_(GMFlow(gcfg), gen).to(dev)
    if args.resume:
        restored = load_params(args.resume)
        if restored is not None:
            model.load_state_dict(restored)
            say(f"[train_gmflow] resumed params from {args.resume}")
    # optimizer: one-cycle cosine + AdamW + global-norm clip (main.py:188,353,409)
    state = make_flow_train_state(model, steps=args.steps, lr=args.lr, warmup_frac=args.warmup_frac,
                                  weight_decay=args.weight_decay, grad_clip=args.grad_clip)

    def save(name):
        if main_rank:
            save_params(os.path.join(args.ckpt_dir, name), model.state_dict())

    losses = []
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        for batch in loader:
            if done >= args.steps:
                break
            if supervised:
                state, loss = flow_train_step(state, batch["img0"], batch["img1"], batch["flow"], batch["valid"],
                                              mesh=mesh)
            else:
                state, loss = flow_train_step(state, batch["img0"], batch["img1"], mesh=mesh)
            done += 1
            if done % args.log_every == 0 or done == args.steps:
                loss_v = float(loss)
                losses.append(loss_v)
                rate = done / (time.perf_counter() - t0)
                say(f"[train_gmflow] step {done}/{args.steps} loss={loss_v:.4f} "
                      f"lr={state.schedule(done):.2e} {rate:.2f} it/s", flush=True)
                if not math.isfinite(loss_v):
                    raise FloatingPointError("training diverged (non-finite loss)")
            if args.ckpt_dir and done % args.ckpt_every == 0:
                save(f"step_{done}")
            if args.val_every and done % args.val_every == 0 and supervised and not args.synthetic and main_rank:
                res = validate(model, (index.load(i) for i in range(len(index))), max_samples=50)
                say(f"[train_gmflow] val@{done}: {res}", flush=True)
        if args.steps and done == 0:
            raise ValueError(f"the loader yields no batch: {len(index)} samples, batch size {args.batch_size}")

    if args.ckpt_dir:
        save("final")
    say(f"[train_gmflow] done: {done} steps")
    return {"done": done, "losses": losses, "model": model}


if __name__ == "__main__":
    main()
