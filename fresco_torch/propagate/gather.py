"""Row gather of a patch table: CUDA kernel wrapper and its plain version.

``gather_rows(table [N, W], idx [K] int32) -> [K, W]`` is the vote's
style-patch gather (``fresco_tpu/propagate/patchmatch.py:317-328``, the
``jnp.take`` at ``:322``).  For CUDA tensors it launches
``fresco_torch/csrc/row_gather.cu`` (which replaces the Pallas row-DMA
gathers of ``scripts/bench_pallas_gather.py``) and raises on what the
kernel does not take; for CPU tensors it runs ``gather_rows_plain``,
``torch.index_select``.
"""
from __future__ import annotations

import torch

from fresco_torch import kernels


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(table, 0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]``; table [N, W] (any dtype), idx [K] int32 in
    [0, N).  On the card an index outside [0, N) gives a zero row."""
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"gather_rows: table [N, W] and idx [K], got {tuple(table.shape)}, {tuple(idx.shape)}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    card = kernels.launch_card("gather_rows", table=table, idx=idx)
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: idx must be int32, got {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    n, w = table.shape
    out = torch.empty((idx.shape[0], w), dtype=table.dtype, device=card)
    kernels.call(gather_rows, "row_gather", card, table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                 idx.shape[0], w * table.element_size())
    return out


gather_rows.launches = 0
gather_rows.launches_by_card = {}
