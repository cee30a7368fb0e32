"""The (data, model) mesh of ranks and the collectives the port places by hand.

The JAX package is single-controller: one process drives every device and
GSPMD inserts each collective from the shardings alone
(``fresco_tpu/parallel/sharding.py``).  The port is SPMD: one process per
rank, and an explicit collective wherever frames or channels couple.  A
``Mesh`` names this rank's place in a ``(data, model)`` grid of
``torch.distributed`` ranks, laid out row-major as ``np.reshape(data,
model)`` lays out JAX devices (rank = data index * model + model index),
and holds a process group along each axis: ``data_group`` joins the ranks
that share this rank's model index, ``model_group`` those that share its
data index.  ``Mesh()`` is the single-process mesh, on which every helper
here is the identity.

Frames over ``data``.  A frame-major batch ``[chunk*F, ...]`` (chunk-major:
the CFG pair outermost) is held as ``[chunk*F_local, ...]`` on each rank,
frames ``[r*F_local, (r+1)*F_local)`` of every chunk on data rank r
(``local_frames``).  ``gather_frames`` is the all-gather that returns the
whole batch in the same chunk-major order (the raw gather is rank-major,
``[rank][chunk][F_local]``); its backward sums the gradient over the data
ranks and keeps this rank's frames, so a loss must hold only the terms of
this rank's frames (each rank's loss is its share of the whole).

Channels over ``model`` (Megatron): ``copy_to_model`` (identity forward,
all-reduce backward) in front of a column-parallel layer,
``reduce_from_model`` (all-reduce forward, identity backward) after a
row-parallel one, ``gather_from_model`` / ``scatter_to_model`` between a
split and a whole last axis.

Transport.  Every collective hands its operand to the group's backend as
it lies: NCCL takes CUDA tensors, and gloo takes CPU tensors and, where
ranks share one card, CUDA tensors too (it copies them through host memory
itself).  16-bit floats travel as their bytes, which every backend takes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``(data, model)`` grid of ranks."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def data_src(self, data_rank: int) -> int:
        """The global rank at ``data_rank`` in this rank's model column."""
        return data_rank * self.model + self.model_rank

    def for_frames(self, n: int) -> "Mesh":
        """The mesh a batch of ``n`` frames runs on: this one where ``data``
        divides ``n``, else the same ranks with the frames replicated over
        ``data`` (every data rank computes every frame; the JAX runner's
        ``_shard_batch`` replicates such a ragged batch too)."""
        if self.data == 1 or n % self.data == 0:
            return self
        return dataclasses.replace(self, data=1, rank=self.model_rank, data_group=None)

    def frame_slice(self, n: int) -> slice:
        """This rank's frames of an ``n``-frame batch."""
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


_HALF = (torch.bfloat16, torch.float16)


def all_gather_cat(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """The ``size`` ranks' ``x`` (equal shapes) concatenated along ``dim``
    in group-rank order (16-bit floats travel as their bytes)."""
    if size == 1:
        return x
    src = x.detach().contiguous()
    wire = src.view(torch.uint8) if src.dtype in _HALF else src
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim).view(src.dtype)


def all_reduce_sum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of ``x`` over the ``size`` ranks of ``group`` (a new tensor;
    16-bit floats are summed in float32 and rounded once)."""
    if size == 1:
        return x
    buf = x.detach().to(torch.float32 if x.dtype in _HALF else x.dtype, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


def broadcast_from(x: torch.Tensor, src: int, group, size: int) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group`` (``x`` gives the
    shape and dtype elsewhere)."""
    if size == 1:
        return x
    buf = x.detach().clone().contiguous()
    dist.broadcast(buf.view(torch.uint8) if buf.dtype in _HALF else buf, src=src, group=group)
    return buf


# ------------------------------------------------------------------ frames
def local_frames(x: torch.Tensor, mesh: Mesh, chunk: int = 1) -> torch.Tensor:
    """This rank's frames of a whole chunk-major batch ``[chunk*F, ...]``."""
    if mesh.data == 1:
        return x
    f = x.shape[0] // chunk
    sl = mesh.frame_slice(f)
    return x.reshape(chunk, f, *x.shape[1:])[:, sl].reshape(-1, *x.shape[1:])


def _rank_major_to_chunk_major(g: torch.Tensor, d: int, chunk: int) -> torch.Tensor:
    """``[d][chunk][F_local]`` -> ``[chunk][d * F_local]`` on the leading axis."""
    rest = g.shape[1:]
    fl = g.shape[0] // (d * chunk)
    return g.reshape(d, chunk, fl, *rest).transpose(0, 1).reshape(-1, *rest)


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, chunk: int):
        ctx.mesh, ctx.chunk = mesh, chunk
        g = all_gather_cat(x, mesh.data_group, mesh.data)
        return _rank_major_to_chunk_major(g, mesh.data, chunk)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        total = all_reduce_sum(grad, mesh.data_group, mesh.data)
        return local_frames(total, mesh, ctx.chunk), None, None


def gather_frames(x: torch.Tensor, mesh: Mesh, chunk: int = 1) -> torch.Tensor:
    """The whole chunk-major batch ``[chunk*F, ...]`` from every data rank's
    ``[chunk*F_local, ...]``.  Differentiable: the backward all-reduces the
    gradient over ``data`` and keeps this rank's frames."""
    if mesh.data == 1:
        return x
    return _GatherFrames.apply(x, mesh, chunk)


def frame_from_owner(x_local: torch.Tensor, frame: int, n_frames: int, mesh: Mesh,
                     chunk: int = 1) -> torch.Tensor:
    """Frame ``frame`` of every chunk, ``[chunk, ...]``, broadcast from the
    data rank that holds it (inference only: no gradient)."""
    fl = n_frames // mesh.data
    owner, i = divmod(frame, fl)
    mine = x_local.reshape(chunk, fl, *x_local.shape[1:])[:, i]
    return broadcast_from(mine, mesh.data_src(owner), mesh.data_group, mesh.data)


# ----------------------------------------------------------------- channels
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh.model_group, ctx.mesh.model), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, mesh.model_group, mesh.model)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _last_axis_part(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = x.shape[-1] // mesh.model
    return x[..., mesh.model_rank * n:(mesh.model_rank + 1) * n].contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_cat(x, mesh.model_group, mesh.model, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _last_axis_part(g, ctx.mesh), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _last_axis_part(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.mesh.model_group, ctx.mesh.model, dim=-1), None


def copy_to_model(x, mesh: Mesh):
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh: Mesh):
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh: Mesh):
    """The whole last axis from every model rank's part of it."""
    return _GatherFromModel.apply(x, mesh)


def scatter_to_model(x, mesh: Mesh):
    """This model rank's part of a whole last axis."""
    return _ScatterToModel.apply(x, mesh)


def all_reduce_grads(optimizer: torch.optim.Optimizer, mesh: Mesh) -> None:
    """Sum the gradient of every parameter ``optimizer`` holds over
    ``data``, in place (a parameter the loss did not reach is skipped, on
    every rank alike)."""
    if mesh.data == 1:
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                p.grad.copy_(all_reduce_sum(p.grad, mesh.data_group, mesh.data))
