"""FRESCO-guided self-attention.

Counterpart of ``fresco_tpu/attention/fresco_attention.py`` (reference
src/diffusion_hacked.py:142-403):

  1. cross-frame attention: every frame's queries against the union of
     valid keys of all frames, through the masked flash kernel, with the
     keys compacted valid-first (``cf_perms``);
  2. spatial-guided attention: q <- attn(q_ref, s·k_ref, q);
  3. temporal-guided (FLATTEN) attention along flow trajectories.

The per-step gates ``use_intra`` / ``use_inter`` are Python bools: the
sampler is a Python loop, so a gated-off mechanism costs nothing.  The
trajectory permutation is an index gather (the JAX package's one-hot
matmuls compute exactly the same thing).

Over a mesh (``FrescoAttnParams.mesh``, frames over ``data``) each rank
holds its frames' queries, keys and values, ``[chunk*F_local, hw, C]``:
the cross-frame attention gathers the keys and values of every frame (the
maskless mode broadcasts frame 0's from the rank that holds it) and the
trajectory attention the keys and values along each trajectory; both
compute only this rank's queries.  Masks, key permutations and
trajectories index the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fresco_torch.attention.flash import flash_attention
from fresco_torch.core import comm


@dataclasses.dataclass
class FrescoAttnParams:
    """Precomputed FRESCO attention inputs for one keyframe batch.

    Per-scale entries are dicts keyed by hw (h*w at that feature scale);
    ``None`` disables a mechanism."""

    cf_masks: Any = None       # {hw: bool [F, hw]}
    cf_perms: Any = None       # {hw: (perm int64 [K], mask bool [K])}
    ref_features: Any = None   # tuple of [B, hw, C], in FRESCO-layer order
    trajectories: Any = None   # {hw: (fwd_map [F,hw], bwd_map [F,hw], mask [hw,F,F])}
    use_intra: bool = False
    use_inter: bool = False
    intra_scale: float = 0.2
    inter_scale: float = 0.2
    chunk: int = 2
    mesh: Any = None           # comm.Mesh: frames over its data axis (None: one process)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, C] -> [B, H, S, D] (a view)."""
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def cross_frame_attention(q, k, v, key_mask, chunk: int, heads: int, key_perm=None, mesh=None):
    """q/k/v [chunk*F, hw, C]; key_mask bool [F, hw] or None (None = keys
    of frame 0 only, the reference's maskless mode).  ``key_perm`` =
    (perm [K], mask [K]) gathers keys valid-first to a cap K.  With a
    ``mesh`` q/k/v hold this rank's frames and the mask and permutation
    index the whole batch."""
    b, hw, c = q.shape
    d = 1 if mesh is None else mesh.data
    f = b // chunk * d
    qq = q.reshape(chunk, -1, c)
    if key_mask is None:
        if d == 1:
            kk, vv = k.reshape(chunk, -1, c)[:, :hw], v.reshape(chunk, -1, c)[:, :hw]
        else:
            kk = comm.frame_from_owner(k, 0, f, mesh, chunk)
            vv = comm.frame_from_owner(v, 0, f, mesh, chunk)
        mask = torch.ones((hw,), dtype=torch.bool, device=q.device)
    else:
        if d > 1:
            k, v = comm.gather_frames(k, mesh, chunk), comm.gather_frames(v, mesh, chunk)
        kk = k.reshape(chunk, f * hw, c)
        vv = v.reshape(chunk, f * hw, c)
        if key_perm is not None:
            perm, mask = key_perm
            kk = kk.index_select(1, perm)
            vv = vv.index_select(1, perm)
        else:
            mask = key_mask.reshape(-1)
    mask_b = mask[None].expand(chunk, mask.shape[0])
    out = flash_attention(
        _split_heads(qq, heads), _split_heads(kk, heads), _split_heads(vv, heads),
        key_mask=mask_b,
    )
    return _merge_heads(out).reshape(b, hw, c)


def spatial_guided_query(q, ref_q, ref_k, heads: int, scale_factor: float):
    """attn(query=ref_q, key=ref_k*scale_factor, value=q) per frame
    (diffusion_hacked.py:278-285)."""
    rk = _split_heads(ref_k * scale_factor, heads)
    out = flash_attention(_split_heads(ref_q, heads), rk, _split_heads(q, heads))
    return _merge_heads(out)


def trajectory_attention(q_raw, k_raw, hidden, fwd_map, bwd_map, traj_mask,
                         chunk: int, heads: int, scale_factor: float, mesh=None):
    """Attention across frames along each flow trajectory
    (diffusion_hacked.py:308-368).  q_raw/k_raw/hidden [chunk*F, hw, C];
    fwd_map/bwd_map int [F, hw] per-frame pixel permutations; traj_mask
    bool [hw, F, F].  With a ``mesh`` the inputs hold this rank's frames:
    the keys and values of every frame are gathered and only this rank's
    frames' outputs are computed."""
    loc = slice(None)
    if mesh is not None and mesh.data > 1:
        loc = mesh.frame_slice(q_raw.shape[0] // chunk * mesh.data)
        k_raw, hidden = comm.gather_frames(k_raw, mesh, chunk), comm.gather_frames(hidden, mesh, chunk)
    return trajectory_frames(q_raw, k_raw, hidden, fwd_map, bwd_map, traj_mask, loc, chunk, heads, scale_factor)


def trajectory_frames(q_raw, k_raw, hidden, fwd_map, bwd_map, traj_mask, loc: slice,
                      chunk: int, heads: int, scale_factor: float):
    """Trajectory attention's outputs for the frames ``loc`` of the whole
    batch: q_raw [chunk*F_loc, hw, C] holds those frames, k_raw and hidden
    [chunk*F, hw, C] every frame."""
    b, hw, c = q_raw.shape
    fl = b // chunk
    d = c // heads

    def permute(x, m):  # [chunk, n, hw, C]: out[:, i, p] = x[:, i, m[i, p]]
        frame = torch.arange(m.shape[0], device=x.device)[:, None]
        return x[:, frame, m]

    def traj_heads(x, m):
        return permute(x.reshape(chunk, -1, hw, c), m).reshape(chunk, -1, hw, heads, d)

    qh = traj_heads(q_raw, fwd_map[loc])
    kh = traj_heads(k_raw, fwd_map) * scale_factor
    vh = traj_heads(hidden, fwd_map)
    work = torch.promote_types(qh.dtype, torch.float32)
    s = torch.einsum("cfphd,cgphd->cphfg", qh, kh).to(work) * (d**-0.5)
    s = torch.where(traj_mask[None, :, None, loc], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    o = torch.einsum("cphfg,cgphd->cfphd", p, vh)
    return permute(o.reshape(chunk, fl, hw, c), bwd_map[loc]).reshape(b, hw, c)


def fresco_self_attention(x, wq, wk, wv, wo, heads: int, fresco: FrescoAttnParams | None,
                          layer_index: int):
    """FRESCO self-attention for one UNet layer.  x [B, hw, C]
    (normalized hidden states); w* projection callables."""
    q, k, v = wq(x), wk(x), wv(x)
    if fresco is None:
        out = flash_attention(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads))
        return wo(_merge_heads(out))

    hw = x.shape[1]
    q_raw, k_raw = q, k
    if fresco.ref_features is not None and fresco.use_intra:
        ref = fresco.ref_features[layer_index]
        q = spatial_guided_query(q, wq(ref), wk(ref), heads, fresco.intra_scale)

    if fresco.cf_masks is not None:
        cf_mask = fresco.cf_masks.get(hw)
        cf_perm = fresco.cf_perms.get(hw) if fresco.cf_perms is not None else None
        hidden = cross_frame_attention(q, k, v, cf_mask, fresco.chunk, heads, key_perm=cf_perm,
                                       mesh=fresco.mesh)
    else:
        out = flash_attention(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads))
        hidden = _merge_heads(out)

    if fresco.trajectories is not None and hw in fresco.trajectories and fresco.use_inter:
        fwd_map, bwd_map, traj_mask = fresco.trajectories[hw]
        hidden = trajectory_attention(q_raw, k_raw, hidden, fwd_map, bwd_map, traj_mask,
                                      fresco.chunk, heads, fresco.inter_scale, mesh=fresco.mesh)
    return wo(hidden)
