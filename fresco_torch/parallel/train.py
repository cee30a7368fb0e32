"""Fine-tuning step for the SD UNet (epsilon prediction), on one device or
a mesh of ranks.

Counterpart of ``fresco_tpu/parallel/train.py``: the standard diffusion
fine-tuning objective, ``t`` uniform in [0, 1000), ``noise`` standard
normal, ``noisy = sqrt(ac)·x + sqrt(1 − ac)·noise`` from the scheduler's
``alphas_cumprod``, then the float32 MSE between the UNet's epsilon and
the noise.  The optimizer is ``optax.adamw(lr)``'s counterpart,
``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-4): both take ``p − lr·(u + wd·p)`` with ``u`` the
bias-corrected Adam direction (torch decays ``p`` first, which is the
same step).

Over a mesh (``parallel/sharding.py``): every rank draws ``t`` and the
noise for the whole batch and runs its ``data`` slice of it; each rank's
loss is its share of the whole batch's mean, the gradients are summed over
``data``, and a UNet split by ``shard_model_params`` runs its Megatron
layers over ``model`` (each rank updates its part of a split parameter).

Float32 parameters computing in bf16, as the JAX package's Flax modules
with ``dtype=bfloat16`` do: ``models.layers.set_compute_dtype(unet,
torch.bfloat16)``.  Every self-attention of the UNet then runs the flash
kernel on the card, with its gradient (``attention/flash.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from fresco_torch.core.comm import Mesh, all_reduce_grads, all_reduce_sum, local_frames
from fresco_torch.diffusion.scheduler import DDPMScheduler
from fresco_torch.parallel.flow_train import fill_missing_grads

# optax.adamw's defaults
ADAMW_DEFAULTS = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@dataclasses.dataclass
class TrainState:
    unet: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_state(unet: nn.Module, lr: float = 1e-4) -> TrainState:
    """``unet`` trains in place under AdamW at ``lr`` with optax's defaults."""
    params = [p for p in unet.parameters() if p.requires_grad]
    return TrainState(unet, torch.optim.AdamW(params, lr=lr, **ADAMW_DEFAULTS), 0)


def fold_in(seed: int, step: int) -> int:
    """A generator seed for ``step`` of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def train_step(state: TrainState, scheduler: DDPMScheduler, latents: torch.Tensor, text_embeds: torch.Tensor,
               *, t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
               seed: int = 0, mesh: Mesh | None = None) -> tuple[TrainState, torch.Tensor]:
    """One epsilon-prediction step.  latents [B,h,w,4] (clean, scaled),
    text_embeds [B,77,C], on the UNet's device: the whole batch, on every
    rank of a ``mesh``.  ``t`` [B] and ``noise`` (latents' shape) are drawn,
    where not given, from a generator seeded with ``fold_in(seed,
    state.step)``.  Returns the state with its step advanced (the UNet and
    optimizer updated in place) and the whole batch's loss, a float32
    scalar on the device."""
    mesh = mesh or Mesh()
    dev = latents.device
    b = latents.shape[0]
    if b % mesh.data:
        raise ValueError(f"train_step: a batch of {b} does not split over data={mesh.data}")
    if t is None or noise is None:
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed, state.step))
        if t is None:
            t = torch.randint(0, scheduler.num_train_timesteps, (b,), generator=gen, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=gen, device=dev, dtype=torch.float32)
    t, latents, text_embeds = (local_frames(x, mesh) for x in (t.to(dev), latents, text_embeds))
    noise = local_frames(noise.to(dev, torch.promote_types(latents.dtype, torch.float32)), mesh)
    ac = torch.as_tensor(scheduler.alphas_cumprod, device=dev)[t.long()][:, None, None, None]
    noisy = torch.sqrt(ac) * latents.to(noise.dtype) + torch.sqrt(1.0 - ac) * noise

    state.optimizer.zero_grad(set_to_none=True)
    eps = state.unet(noisy, t, text_embeds)
    err = (eps.to(noise.dtype) - noise) ** 2
    # this rank's share of the whole batch's mean (the mean itself on one rank)
    loss = torch.mean(err) if mesh.data == 1 else torch.sum(err) / (err.numel() * mesh.data)
    loss.backward()
    all_reduce_grads(state.optimizer, mesh)
    fill_missing_grads(state.optimizer)
    state.optimizer.step()
    return dataclasses.replace(state, step=state.step + 1), all_reduce_sum(loss.detach(), mesh.data_group, mesh.data)
