"""FLATTEN pixel trajectories as a sort + segment-head selection.

Counterpart of ``fresco_tpu/ops/mapping.py`` (reference
src/flow_utils.py:56-138).  The reference's greedy loop keeps, for every
target pixel q of frame f0, the lexicographic argmin of
(colour_error(p), p) over the f1 pixels p that land on q; here that is
one lexicographic order by (q_eff, err, p), built from stable sorts
applied from the last key to the first, then the head of each q-segment.
An unstable sort would break ties differently from the greedy loop.
"""
from __future__ import annotations

import torch

from benchmark.reference.fresco_ref.ops.resize import resize_bilinear


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Indices sorting by keys[0], then keys[1], ... (stable passes from
    the least significant key up)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def single_mapping(bwd_flow, bwd_occ, frames, scale: float = 1.0):
    """Pixel correspondence between one frame pair.

    bwd_flow [H,W,2] (f1 grid -> f0); bwd_occ [H,W]; frames [2,H,W,3].
    Returns (mapping int64 [hw] permutation with f1[mapping[q]] ~ f0[q],
    unlinked bool [hw]).
    """
    H, W = bwd_occ.shape
    h, w = int(H // scale), int(W // scale)
    hw = h * w
    dev = bwd_flow.device

    flow = resize_bilinear(bwd_flow[None], (h, w))[0] / scale
    occ = resize_bilinear(bwd_occ[None, :, :, None], (h, w))[0, :, :, 0]
    fr = resize_bilinear(frames, (h, w))
    f0 = fr[0].reshape(hw, 3)
    f1 = fr[1].reshape(hw, 3)

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    tx = torch.round(xs + flow[..., 0])
    ty = torch.round(ys + flow[..., 1])
    valid = ((tx >= 0) & (tx < w) & (ty >= 0) & (ty < h) & ~(occ > 0.5)).reshape(hw)
    q = (torch.clamp(ty, 0, h - 1) * w + torch.clamp(tx, 0, w - 1)).to(torch.int64).reshape(hw)
    err = torch.mean((f1 - f0[q]) ** 2, dim=-1)

    p_idx = torch.arange(hw, device=dev)
    q_eff = torch.where(valid, q, torch.full_like(q, hw))
    order = _lexsort([q_eff, err, p_idx])
    q_sorted = q_eff[order]
    is_head = torch.ones(hw, dtype=torch.bool, device=dev)
    is_head[1:] = q_sorted[1:] != q_sorted[:-1]
    winner = is_head & (q_sorted < hw)

    mapping = torch.full((hw,), -1, dtype=torch.int64, device=dev)
    mapping[q_sorted[winner]] = order[winner]
    unlinked = mapping == -1
    used = torch.zeros(hw, dtype=torch.bool, device=dev)
    used[order[winner]] = True

    # pair unused p (ascending) with unlinked q (ascending)
    unused_sorted = torch.argsort(used.to(torch.int64) * hw + p_idx)
    rank = torch.cumsum(unlinked.to(torch.int64), 0) - 1
    filler = unused_sorted[torch.clamp(rank, 0, hw - 1)]
    return torch.where(unlinked, filler, mapping), unlinked


def batch_mappings(bwd_flows, bwd_occs, frames, scale: float = 1.0):
    """Chain per-pair mappings into batch trajectories
    (flow_utils.py:105-138).

    bwd_flows [N-1,H,W,2]; bwd_occs [N-1,H,W]; frames [N,H,W,3].
    Returns (fwd [N,hw] int64, bwd [N,hw] int64 inverse permutations,
    mask bool [hw,N,N]: which frame pairs of a trajectory may attend).
    """
    n = frames.shape[0]
    H, W = bwd_occs.shape[1:]
    hw = int(H // scale) * int(W // scale)
    dev = frames.device
    pairs = [
        single_mapping(bwd_flows[i], bwd_occs[i], frames[i : i + 2], scale)
        for i in range(n - 1)
    ]
    ident = torch.arange(hw, device=dev)
    fwd, bwd = [ident], [ident]
    mask = torch.ones((hw, n, n), dtype=torch.bool, device=dev)
    for i, (m, unlinked) in enumerate(pairs):
        # block attention across the broken link (flow_utils.py:124-133)
        one = torch.ones((n, n), dtype=torch.bool, device=dev)
        one[: i + 1, i + 1 :] = False
        one[i + 1 :, : i + 1] = False
        broken = unlinked[fwd[-1]]
        mask = torch.where(broken[:, None, None], mask & one[None], mask)
        fwd.append(m[fwd[-1]])
        bwd.append(torch.argsort(fwd[-1]))
    return torch.stack(fwd), torch.stack(bwd), mask
