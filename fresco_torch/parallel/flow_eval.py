"""GMFlow evaluation on one device.

Counterpart of ``fresco_tpu/parallel/flow_eval.py``: the standard flow
benchmarks' metrics (EPE, >1/3/5 px rates, speed-bucketed EPE s0-10 /
s10-40 / s40+, KITTI F1-all = epe > 3 and epe / |gt| > 0.05) with the
reference's concatenate-then-mean pools, and the replicate padding of
its InputPadder (sintel: centred; kitti: the height at the bottom only).
The metrics are numpy on the host; the flows come from the model on its
own device, under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn as nn


def pad_to_multiple(img: np.ndarray, factor: int = 16, mode: str = "sintel"):
    """Replicate-pad H/W ([..., H, W, C]) up to a multiple of ``factor``.
    Returns (padded, crop), ``crop`` the (rows, cols) slices of the
    original region.  16 = GMFlow's upsample factor 8 x attn_splits 2."""
    h, w = img.shape[-3:-1]
    ph, pw = (-h) % factor, (-w) % factor
    rows = (ph // 2, ph - ph // 2) if mode == "sintel" else (0, ph)
    pads = (rows, (pw // 2, pw - pw // 2))
    out = np.pad(img, [(0, 0)] * (img.ndim - 3) + [pads[0], pads[1], (0, 0)], mode="edge")
    crop = (slice(pads[0][0], pads[0][0] + h), slice(pads[1][0], pads[1][0] + w))
    return out, crop


def _buckets(v: np.ndarray, mag: np.ndarray):
    return (("s0_10", v & (mag < 10)), ("s10_40", v & (mag >= 10) & (mag <= 40)), ("s40plus", v & (mag > 40)))


def flow_metrics(pred: np.ndarray, gt: np.ndarray, valid: np.ndarray | None = None,
                 speed_buckets: bool = False) -> dict:
    """Per-pair metrics over valid pixels."""
    epe = np.sqrt(((pred - gt) ** 2).sum(-1))
    mag = np.sqrt((gt ** 2).sum(-1))
    v = np.ones_like(epe, bool) if valid is None else (valid >= 0.5)
    e = epe[v]
    nan = float("nan")
    out = {
        "epe": float(e.mean()) if e.size else nan,
        "1px": float((e > 1).mean()) if e.size else nan,
        "3px": float((e > 3).mean()) if e.size else nan,
        "5px": float((e > 5).mean()) if e.size else nan,
        "f1_all": float(100.0 * ((e > 3.0) & (e / np.maximum(mag[v], 1e-12) > 0.05)).mean()) if e.size else nan,
        "n_valid": int(e.size),
    }
    if speed_buckets:
        for name, m in _buckets(v, mag):
            out[name] = float(epe[m].mean()) if m.any() else nan
    return out


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_flow_fn(gmflow: nn.Module) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """numpy [B,H,W,3] pair -> the FORWARD flow [B,H,W,2], through
    ``gmflow`` on its device with the frames padded to /16."""
    dev = _device(gmflow)

    @torch.no_grad()
    def run(img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
        p0, crop = pad_to_multiple(img0)
        p1, _ = pad_to_multiple(img1)
        x0, x1 = (torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(dev) for p in (p0, p1))
        flow = gmflow(x0, x1)[: img0.shape[0]].cpu().numpy()
        return flow[:, crop[0], crop[1]]

    return run


@torch.no_grad()
def validate(gmflow: nn.Module, samples: Iterable, *, speed_buckets: bool = False,
             max_samples: int | None = None, pad_mode: str = "sintel") -> dict:
    """Dataset validation: mean metrics over per-pixel pools, the
    reference's concatenate-then-mean protocol.  ``samples`` yields
    (img1, img2, flow_gt, valid_or_None) numpy tuples, e.g.
    ``(idx.load(i) for i in range(len(idx)))`` with a ``flow_data.FlowIndex``."""
    dev = _device(gmflow)
    epes, outs = [], []
    buckets = {"s0_10": [], "s10_40": [], "s40plus": []}
    for n, (img1, img2, gt, valid) in enumerate(samples):
        if max_samples is not None and n >= max_samples:
            break
        p0, crop = pad_to_multiple(np.asarray(img1, np.float32)[None], mode=pad_mode)
        p1, _ = pad_to_multiple(np.asarray(img2, np.float32)[None], mode=pad_mode)
        flow = gmflow(torch.from_numpy(p0).to(dev), torch.from_numpy(p1).to(dev))[0].cpu().numpy()
        flow = flow[crop[0], crop[1]]

        epe = np.sqrt(((flow - gt) ** 2).sum(-1)).ravel()
        mag = np.sqrt((gt ** 2).sum(-1)).ravel()
        v = np.ones_like(epe, bool) if valid is None else (valid.ravel() >= 0.5)
        epes.append(epe[v])
        outs.append((epe[v] > 3.0) & (epe[v] / np.maximum(mag[v], 1e-12) > 0.05))
        if speed_buckets:
            for name, m in _buckets(v, mag):
                if m.any():
                    buckets[name].append(epe[m])

    if not epes:
        return {}
    epe_all = np.concatenate(epes)
    out = {
        "epe": float(epe_all.mean()),
        "1px": float((epe_all > 1).mean()),
        "3px": float((epe_all > 3).mean()),
        "5px": float((epe_all > 5).mean()),
        "f1_all": float(100.0 * np.concatenate(outs).mean()),
        "n_pairs": len(epes),
    }
    if speed_buckets:
        for k, vals in buckets.items():
            out[k] = float(np.concatenate(vals).mean()) if vals else float("nan")
    return out
