"""GMFlow fine-tuning on one device or data parallel over a mesh.

Counterpart of ``fresco_tpu/parallel/flow_train.py``: the supervised
objective of the reference's GMFlow trainer (gamma-weighted L1 over the
prediction sequence, pixels masked by validity and ``max_flow``) and an
unsupervised photometric + edge-aware smoothness objective for adapting
the flow to a video, one step each way.

The optimizer is ``scripts/train_gmflow.py:134-147``'s, ported as it is:
``optax.clip_by_global_norm`` (``clip_by_global_norm_``), then AdamW with
``optax.cosine_onecycle_schedule`` (``cosine_onecycle_schedule``, a plain
function of the update count; the first update reads count 0).

Data parallel (``flow_train_step(..., mesh=)``): each rank takes its slice
of the global batch (``FlowLoader(mesh=...)``), its loss over the data
ranks' count, and the gradients are summed over ``data`` before the
clipping, so every rank takes the single process's step on the whole
batch.  GMFlow stays whole on every rank (no split over ``model``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn as nn

from fresco_torch.core.comm import Mesh, all_reduce_grads, all_reduce_sum
from fresco_torch.ops.warp import flow_warp


def epe_loss(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Average end-point error.  pred/gt [B, H, W, 2]; valid [B, H, W] or None."""
    epe = torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1) + 1e-12)
    if valid is None:
        return epe.mean()
    return torch.sum(epe * valid) / torch.clamp(valid.sum(), min=1.0)


def flow_sequence_loss(flow_preds, gt: torch.Tensor, valid: torch.Tensor | None = None, gamma: float = 0.9,
                       max_flow: float = 400.0):
    """Gamma-weighted L1 over the prediction sequence (a tensor or a list),
    pixels masked by validity >= 0.5 and |gt| < ``max_flow``.  Returns
    (loss, metrics: epe and the >1/3/5 px rates of the last prediction)."""
    if not isinstance(flow_preds, (list, tuple)):
        flow_preds = [flow_preds]
    mag = torch.sqrt(torch.sum(gt ** 2, dim=-1))
    v = mag < max_flow
    if valid is not None:
        v = v & (valid >= 0.5)
    vf = v.float()[..., None]
    n = len(flow_preds)
    loss = 0.0
    for i, p in enumerate(flow_preds):
        loss = loss + gamma ** (n - i - 1) * torch.mean(vf * torch.abs(p - gt))
    epe = torch.sqrt(torch.sum((flow_preds[-1] - gt) ** 2, dim=-1))
    vm = vf[..., 0]
    denom = torch.clamp(vm.sum(), min=1.0)
    metrics = {"epe": torch.sum(epe * vm) / denom,
               "1px": torch.sum((epe > 1) * vm) / denom,
               "3px": torch.sum((epe > 3) * vm) / denom,
               "5px": torch.sum((epe > 5) * vm) / denom}
    return loss, metrics


def photometric_smoothness_loss(img0: torch.Tensor, img1: torch.Tensor, flow: torch.Tensor,
                                smooth_weight: float = 0.1) -> torch.Tensor:
    """Unsupervised objective: photometric L1 of img1 warped back by the
    flow, plus first-order edge-aware smoothness."""
    warped = flow_warp(img1, flow)
    photo = torch.mean(torch.abs(img0 - warped))
    gx_i = torch.mean(torch.abs(img0[:, :, 1:] - img0[:, :, :-1]), dim=-1, keepdim=True)
    gy_i = torch.mean(torch.abs(img0[:, 1:] - img0[:, :-1]), dim=-1, keepdim=True)
    gx_f = torch.abs(flow[:, :, 1:] - flow[:, :, :-1])
    gy_f = torch.abs(flow[:, 1:] - flow[:, :-1])
    smooth = torch.mean(gx_f * torch.exp(-gx_i)) + torch.mean(gy_f * torch.exp(-gy_i))
    return photo + smooth_weight * smooth


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``: from peak/div_factor up to the
    peak at ``int(pct_start·T)``, then down to peak/(div·final_div) at T,
    both halves cosine; the value at update count ``count``."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs a positive transition_steps")
    marks = sorted({int(pct_start * transition_steps): div_factor,
                    int(transition_steps): 1.0 / (div_factor * final_div_factor)}.items())
    bounds = [0] + [b for b, _ in marks]
    values = [peak_value / div_factor]
    for _, s in marks:
        values.append(values[-1] * s)

    def schedule(count: int) -> float:
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    g / norm · max_norm where the global norm is not below ``max_norm``,
    with no epsilon (``clip_grad_norm_`` adds 1e-6).  Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every parameter's gradient, zeros where the loss did not reach it:
    optax still decays such a parameter, where torch would skip it."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            out.append(p.grad)
    return out


@dataclasses.dataclass
class FlowTrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip: float = 1.0
    step: int = 0


def make_flow_train_state(model: nn.Module, *, steps: int, lr: float = 4e-4, warmup_frac: float = 0.05,
                          weight_decay: float = 1e-4, grad_clip: float = 1.0) -> FlowTrainState:
    """``scripts/train_gmflow.py``'s optimizer: the one-cycle schedule over
    ``steps`` (warmup at least one whole update, at most half), global-norm
    clipping at ``grad_clip``, AdamW (optax defaults) at the schedule."""
    steps = max(steps, 2)
    schedule = cosine_onecycle_schedule(steps, lr, pct_start=min(max(warmup_frac, 1.0 / steps), 0.5))
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return FlowTrainState(model, opt, schedule, grad_clip, 0)


def flow_train_step(state: FlowTrainState, img0: torch.Tensor, img1: torch.Tensor,
                    gt_flow: torch.Tensor | None = None, valid: torch.Tensor | None = None,
                    mesh: Mesh | None = None):
    """One step; supervised when ``gt_flow`` is given, else unsupervised.
    img0/img1 [B, H, W, 3] in [0, 255]: this rank's slice of the global
    batch over a ``mesh`` (equal slices).  Returns (state with its step
    advanced, the global batch's loss as a scalar on the device)."""
    mesh = mesh or Mesh()
    state.optimizer.zero_grad(set_to_none=True)
    fwd = state.model(img0, img1)[: img0.shape[0]]
    if gt_flow is not None:
        loss, _ = flow_sequence_loss(fwd, gt_flow, valid)
    else:
        loss = photometric_smoothness_loss(img0 / 255.0, img1 / 255.0, fwd)
    if mesh.data > 1:
        loss = loss / mesh.data  # this rank's share of the mean over equal slices
    loss.backward()
    all_reduce_grads(state.optimizer, mesh)
    loss = all_reduce_sum(loss.detach(), mesh.data_group, mesh.data)
    clip_by_global_norm_(fill_missing_grads(state.optimizer), state.grad_clip)
    for g in state.optimizer.param_groups:
        g["lr"] = state.schedule(state.step)
    state.optimizer.step()
    return dataclasses.replace(state, step=state.step + 1), loss.detach()
