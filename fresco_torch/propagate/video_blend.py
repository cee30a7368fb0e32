"""Full-video propagation: keyframe style -> all frames, then blend.

Counterpart of ``fresco_tpu/propagate/video_blend.py`` (reference
video_blend.py): for every keyframe interval, propagate the stylized
keyframe to the in-between frames from both ends (guided patch
synthesis), then per frame pick/blend the two candidates (error mask ->
histogram blend -> optional Poisson fusion).

``blend_video_frames`` is the whole stage in memory: uint8 BGR frames and
keys in, blended uint8 BGR frames out, on the card unless the caller
passes a CPU device.  ``blend_video`` wraps it with PNG files read and
written through Pillow, and with ``output`` encodes the blended frames as
an mp4 (``frames_to_video``; the video helpers need OpenCV).  Not ported
here: the multi-device interval wave (``parallel.py``).  ``flow_fn`` is required: the
caller supplies the flows (the CLI passes Farneback through OpenCV, or
the model bundle's GMFlow: ``FrescoPipeline.gmflow_flow_fn``).

Run: ``python -m fresco_torch.propagate.video_blend <dir> --key_ind 0 10``
(Farneback flows, so it needs OpenCV).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fresco_torch.ops.warp import forward_backward_consistency
from fresco_torch.pipeline.runner import resolve_device
from fresco_torch.propagate.guides import (
    GUIDE_WEIGHTS,
    edge_guide,
    positional_chain,
    temporal_guide,
    warp_nearest,
)
from fresco_torch.propagate.histogram import histogram_blend
from fresco_torch.propagate.patchmatch import PatchMatchConfig, TorchDraws, synthesize
from fresco_torch.propagate.poisson import poisson_fusion


class PhaseTimers:
    """Cumulative per-phase wall clock of the propagation pipeline.
    Thread-safe: the synthesis thread runs while the main thread blends,
    so phase sums can exceed the total wall (overlap)."""

    def __init__(self):
        self.t: dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.t[phase] = self.t.get(phase, 0.0) + dt


def error_mask(dist1: torch.Tensor, dist2: torch.Tensor, weight1: float, weight2: float) -> torch.Tensor:
    """Candidate selection mask (video_blend.py:40-58): 0 selects the
    forward candidate, 1 the backward one.  uint8."""
    out = (weight1 * dist1 >= weight2 * dist2).to(torch.uint8)
    if weight1 == 0:
        out.zero_()
    elif weight2 == 0:
        out.fill_(1)
    return out


@dataclasses.dataclass
class _FlowCache:
    """Flows of frame pairs, in memory and optionally as npz files in
    ``tmp_dir`` (the reference's FlowCalc cache)."""

    flow_fn: object  # [N,H,W,3] float32 pairs (a, b) -> [2N,H,W,2]: fwd block, bwd block
    device: torch.device
    cache: dict = dataclasses.field(default_factory=dict)
    tmp_dir: str | None = None
    timers: PhaseTimers | None = None

    def _path(self, tag: str):
        return None if self.tmp_dir is None else os.path.join(self.tmp_dir, f"flow_{tag}.npz")

    def _load(self, tag: str):
        p = self._path(tag)
        if tag not in self.cache and p and os.path.exists(p):
            z = np.load(p)
            self.cache[tag] = (torch.from_numpy(z["flow"]).to(self.device),
                               torch.from_numpy(z["occ"]).to(self.device))
        return self.cache.get(tag)

    def get_batch(self, frames: list[torch.Tensor], idxs: list[int], tags: list[str], max_batch: int = 8):
        """Backward flow + occlusion of each pair (frames[i] -> frames[i+1]),
        computed ``max_batch`` uncached pairs per ``flow_fn`` call."""
        missing = [(i, t) for i, t in zip(idxs, tags) if self._load(t) is None]
        tick = self.timers("flow") if self.timers else contextlib.nullcontext()
        with tick:
            for lo in range(0, len(missing), max_batch):
                chunk = missing[lo:lo + max_batch]
                n = len(chunk)
                a = torch.stack([frames[i] for i, _ in chunk]).float()
                b = torch.stack([frames[i + 1] for i, _ in chunk]).float()
                flow = self.flow_fn(a, b)
                fwd, bwd = flow[:n], flow[n:]
                _, bwd_occ = forward_backward_consistency(fwd, bwd)
                for j, (_, t) in enumerate(chunk):
                    self.cache[t] = (bwd[j], bwd_occ[j])
                    if self._path(t):
                        np.savez(self._path(t), flow=bwd[j].cpu().numpy(), occ=bwd_occ[j].cpu().numpy())
        return [self.cache[t] for t in tags]


def _stream_seed(*keys: int) -> int:
    """An independent seed per (seed, interval, position, direction)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1)[0])


def _guide_weights(device) -> torch.Tensor:
    return torch.tensor(
        [GUIDE_WEIGHTS[g] / 3 for g in ("color", "edge", "temporal", "positional") for _ in range(3)],
        dtype=torch.float32, device=device)


def _synthesize_chain_pair(key_imgs, frames_pair, flows_pair, cfg, seed: int,
                           inpaint_method: str = "pushpull", timers: PhaseTimers | None = None,
                           draw_device=None):
    """Advance the forward and backward chains of one interval in lockstep
    (video_blend.py:181-278).  Each chain synthesizes positions
    1..interval-1 only: the far keyframe is never blended.  Returns
    ((fwd_outs, fwd_errs), (bwd_outs, bwd_errs)) as uint8 / float32
    tensors, the backward lists in chain order."""
    tick = timers if timers is not None else (lambda _phase: contextlib.nullcontext())
    outs, errs = ([], []), ([], [])
    prev = [key_imgs[0], key_imgs[1]]
    h, w = frames_pair[0][0].shape[:2]
    dev = key_imgs[0].device
    with tick("guides"):
        pos_guides, src_stacks = [], []
        for d in range(2):
            frames, flows = frames_pair[d], flows_pair[d]
            pg = positional_chain(h, w, [f for f, _ in flows], [o for _, o in flows],
                                  method=inpaint_method, device=dev)
            pos_guides.append(pg)
            src_stacks.append(torch.cat([frames[0], edge_guide(frames[0]), key_imgs[d], pg[0]], -1).float())
    weights = _guide_weights(dev)
    styles = [k.float() for k in key_imgs]
    for j in range(1, len(frames_pair[0]) - 1):
        with tick("guides"):
            tgts = []
            for d in range(2):
                frames, flows = frames_pair[d], flows_pair[d]
                bwd_flow, bwd_occ = flows[j - 1]
                temporal = temporal_guide(prev[d], bwd_flow, bwd_occ, method=inpaint_method)
                tgts.append(torch.cat([frames[j], edge_guide(frames[j]), temporal, pos_guides[d][j]], -1).float())
        with tick("synth"):
            for d in range(2):
                out, err, _ = synthesize(styles[d], src_stacks[d], tgts[d], weights, cfg,
                                         draws=TorchDraws(_stream_seed(seed, j, d), dev, draw_device))
                out_u8 = out.clamp(0, 255).to(torch.uint8)  # truncation, as astype
                outs[d].append(out_u8)
                errs[d].append(err)
                prev[d] = out_u8
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return (outs[0], errs[0]), (outs[1], errs[1])


def blend_video_frames(
    frames,
    keys,
    key_ind: list[int],
    *,
    flow_fn,
    poisson: bool = True,
    use_histogram: bool = True,
    patch_cfg: PatchMatchConfig = PatchMatchConfig(),
    seed: int = 0,
    inpaint_method: str = "pushpull",
    tmp_dir: str | None = None,
    reuse_synthesis: bool = False,
    keep_tmp: bool = True,
    device: torch.device | str | None = None,
    draw_device: torch.device | str | None = None,
    timers_out: dict | None = None,
) -> dict[int, np.ndarray]:
    """The propagation stage in memory (video_blend.py:423-708).

    ``frames``: {index: uint8 [H,W,3] BGR} for key_ind[0]..key_ind[-1];
    ``keys``: {index: stylized uint8 BGR} for each of ``key_ind``;
    ``flow_fn``: float32 [N,H,W,3] pairs (a, b) on the device ->
    [2N,H,W,2] flows (forward block, then backward), as the keyframe
    stage's ``ModelBundle.flow_fn``.  ``tmp_dir``: flow and synthesis npz
    caches (``reuse_synthesis`` loads an interval's saved synthesis, the
    reference's ``-ne``).  ``draw_device``: where the random search draws
    are made (``TorchDraws``; the CPU makes a run on the card repeatable on
    the CPU).  Returns {index: blended uint8 [H,W,3] BGR};
    the keyframes pass through unchanged.  ``timers_out`` receives the
    per-phase wall seconds and ``wall_total``."""
    if flow_fn is None:
        raise ValueError(
            "blend_video_frames: flow_fn is required, e.g. the model bundle's GMFlow "
            "(FrescoPipeline.gmflow_flow_fn()) or Farneback (utils.classic_flow.pairwise_flow_fn())")
    dev = resolve_device(device)
    if tmp_dir is not None:
        os.makedirs(tmp_dir, exist_ok=True)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    frames_t = {i: up(frames[i]) for i in range(key_ind[0], key_ind[-1] + 1)}
    keys_t = {i: up(keys[i]) for i in key_ind}
    timers = PhaseTimers()
    fcache = _FlowCache(flow_fn, dev, tmp_dir=tmp_dir, timers=timers)
    n_seq = len(key_ind) - 1
    result: dict[int, np.ndarray] = {}

    def synth_cache(seq_i):
        beg, end = key_ind[seq_i], key_ind[seq_i + 1]
        return None if tmp_dir is None else os.path.join(tmp_dir, f"synth_{beg}_{end}.npz")

    def interval_inputs(seq_i):
        """(key_imgs, frames_pair, flows_pair) of interval seq_i; computes
        or loads the pair flows (flow thread)."""
        beg, end = key_ind[seq_i], key_ind[seq_i + 1]
        seq_frames = [frames_t[i] for i in range(beg, end + 1)]
        rev_frames = seq_frames[::-1]
        js = list(range(max(end - beg - 1, 0)))
        fwd_flows = fcache.get_batch(seq_frames, js, [f"f{beg}_{j}" for j in js])
        cache = synth_cache(seq_i)
        bwd_flows = None
        if not (reuse_synthesis and cache and os.path.exists(cache)):
            bwd_flows = fcache.get_batch(rev_frames, js, [f"b{end}_{j}" for j in js])
        return (keys_t[beg], keys_t[end]), (seq_frames, rev_frames), (fwd_flows, bwd_flows)

    def synth_interval(seq_i, inputs):
        """Both chains of one interval (synthesis thread).  Returns
        (fwd_out, fwd_err, bwd_out, bwd_err, fwd_flows)."""
        key_imgs, frames_pair, flows_pair = inputs
        cache = synth_cache(seq_i)
        if reuse_synthesis and cache and os.path.exists(cache):
            z = np.load(cache)
            return (*(list(up(x) for x in z[k]) for k in ("fwd_out", "fwd_err", "bwd_out", "bwd_err")),
                    flows_pair[0])
        (fo, fe), (bo, be) = _synthesize_chain_pair(
            key_imgs, frames_pair, flows_pair, patch_cfg, _stream_seed(seed, seq_i),
            inpaint_method=inpaint_method, timers=timers, draw_device=draw_device)
        bo, be = bo[::-1], be[::-1]
        if cache and keep_tmp and fo:
            np.savez(cache, **{k: torch.stack(v).cpu().numpy()
                               for k, v in (("fwd_out", fo), ("fwd_err", fe), ("bwd_out", bo), ("bwd_err", be))})
        return fo, fe, bo, be, flows_pair[0]

    def blend_interval(seq_i, fwd_out, fwd_err, bwd_out, bwd_err, fwd_flows):
        """Per-frame candidate selection + blending (video_blend.py:574-611).
        Both chains hold positions 1..interval-1, so after the reversal
        fwd_out[i] and bwd_out[i] both depict frame beg+i+1, and each
        candidate's own error map is used (ROADMAP C7)."""
        beg, end = key_ind[seq_i], key_ind[seq_i + 1]
        interval = end - beg
        result[beg] = keys[beg]
        p_mask = None
        for i in range(interval - 1):
            oa, ob = fwd_out[i], bwd_out[i]
            weight1 = i / (interval - 1) if interval > 1 else 0.5
            weight2 = 1 - weight1
            mask = error_mask(fwd_err[i], bwd_err[i], weight1, weight2)
            if p_mask is not None:
                p_mask = warp_nearest(p_mask, fwd_flows[i][0])
                mask = p_mask | mask
            p_mask = mask
            min_error_img = torch.where(mask[:, :, None] == 0, oa, ob)
            with timers("blend"):
                if use_histogram:
                    hb = histogram_blend(oa, ob, min_error_img, weight2, weight1)
                else:
                    hb = (weight2 * oa.float() + weight1 * ob.float()).to(torch.uint8)
            with timers("poisson"):
                res = poisson_fusion(hb, oa, ob, mask) if poisson else hb
                result[beg + i + 1] = res.cpu().numpy()

    # Three-stage pipeline (video_blend.py:625-694): the flow thread keeps
    # FLOW_AHEAD intervals of flows ready, the synthesis thread runs
    # interval k+1 while the main thread blends interval k.
    executor = ThreadPoolExecutor(max_workers=1)
    flow_ex = ThreadPoolExecutor(max_workers=1)
    flow_ahead = 2
    inputs_fut: dict = {}

    def launch(seq_i):
        for i in range(min(seq_i + 1 + flow_ahead, n_seq)):
            if i not in inputs_fut:
                inputs_fut[i] = flow_ex.submit(interval_inputs, i)
        return executor.submit(lambda: synth_interval(seq_i, inputs_fut.pop(seq_i).result()))

    t0 = time.perf_counter()
    try:
        if n_seq > 0:
            nxt = launch(0)
            for seq_i in range(n_seq):
                res = nxt.result()
                if seq_i + 1 < n_seq:
                    nxt = launch(seq_i + 1)
                blend_interval(seq_i, *res)
    finally:
        executor.shutdown(wait=False, cancel_futures=True)
        flow_ex.shutdown(wait=False, cancel_futures=True)
    result[key_ind[-1]] = keys[key_ind[-1]]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    if timers_out is not None:
        timers_out.update(timers.t)
        timers_out["wall_total"] = total
    return result


def _codec():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("blend_video reads and writes PNG files through Pillow, which is not "
                          "importable here; call blend_video_frames with arrays instead") from e
    return Image


def read_bgr(path: str) -> np.ndarray:
    img = np.asarray(_codec().open(path).convert("RGB"))
    return np.ascontiguousarray(img[..., ::-1])


def write_bgr(path: str, img: np.ndarray) -> None:
    _codec().fromarray(np.ascontiguousarray(img[..., ::-1])).save(path)


def blend_video(base_dir: str, key_ind: list[int], key_dir: str = "keys", output: str | None = None,
                fps: float = 30, n_proc: int = 8, *, flow_fn=None,
                poisson: bool = True, use_histogram: bool = True,
                patch_cfg: PatchMatchConfig = PatchMatchConfig(), seed: int = 0,
                reuse_synthesis: bool = False, keep_tmp: bool = True,
                inpaint_method: str = "pushpull", device: torch.device | str | None = None,
                timers_out: dict | None = None) -> str:
    """The reference's file layout around ``blend_video_frames``: reads
    base_dir/video/%04d.png and base_dir/<key_dir>/%04d.png, writes
    base_dir/blend/%04d.png (caches in base_dir/tmp) and, given
    ``output``, those frames as an mp4 at ``fps``.  ``n_proc`` is accepted
    for the CLI's sake and not used (as in the JAX package).  Returns the
    blend directory."""
    frames = {i: read_bgr(os.path.join(base_dir, "video", "%04d.png" % i))
              for i in range(key_ind[0], key_ind[-1] + 1)}
    keys = {i: read_bgr(os.path.join(base_dir, key_dir, "%04d.png" % i)) for i in key_ind}
    out = blend_video_frames(
        frames, keys, key_ind, flow_fn=flow_fn, poisson=poisson, use_histogram=use_histogram,
        patch_cfg=patch_cfg, seed=seed, inpaint_method=inpaint_method,
        tmp_dir=os.path.join(base_dir, "tmp"), reuse_synthesis=reuse_synthesis, keep_tmp=keep_tmp,
        device=device, timers_out=timers_out)
    blend_dir = os.path.join(base_dir, "blend")
    os.makedirs(blend_dir, exist_ok=True)
    for i, img in out.items():
        write_bgr(os.path.join(blend_dir, "%04d.png" % i), img)
    if output:
        frames_to_video(blend_dir, output, fps)
    return blend_dir


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not importable here; "
                          "pass frames in memory to blend_video_frames instead") from e
    return cv2


def video_to_frames(video_path: str, frame_dir: str, filename_pattern: str = "%04d.png",
                    frame_edit_func=None) -> int:
    """Decode a video to numbered frames on disk; returns the frame count
    (reference src/ebsynth/src/video_util.py:8-32)."""
    cv2 = _cv2(f"decoding {video_path!r}")
    os.makedirs(frame_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    count = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        if frame_edit_func is not None:
            img = frame_edit_func(img)
        cv2.imwrite(os.path.join(frame_dir, filename_pattern % count), img)
        count += 1
    cap.release()
    return count


def get_fps(video_path: str) -> float:
    """The container's frame rate as OpenCV reports it, 0 or less where it
    reads none (reference video_util.py:59-64)."""
    cv2 = _cv2(f"reading {video_path!r}")
    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return fps


def get_frame_count(video_path: str) -> int:
    """The container's frame count (reference video_util.py:67-73)."""
    cv2 = _cv2(f"reading {video_path!r}")
    cap = cv2.VideoCapture(video_path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def frames_to_video(frame_dir: str, output: str, fps: float) -> None:
    """The .png / .jpg files of ``frame_dir``, in name order, as an mp4v
    video at ``fps`` (reference src/ebsynth/src/video_util.py:35-56)."""
    cv2 = _cv2(f"writing {output!r}")
    files = sorted(f for f in os.listdir(frame_dir) if f.endswith((".png", ".jpg")))
    if not files:
        return
    h, w = cv2.imread(os.path.join(frame_dir, files[0])).shape[:2]
    vw = cv2.VideoWriter(output, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in files:
        vw.write(cv2.imread(os.path.join(frame_dir, f)))
    vw.release()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="fresco_torch video blending")
    p.add_argument("name", type=str)
    p.add_argument("--key_ind", type=int, nargs="+", required=True)
    p.add_argument("--key", type=str, default="keys")
    p.add_argument("-ps", action="store_true", help="Poisson fusion")
    p.add_argument("-ne", action="store_true", help="reuse previous synthesis outputs (resume)")
    p.add_argument("--trim", type=int, default=None, help="trim_seeded_levels tier")
    p.add_argument("--stop-threshold", type=float, default=None, help="ebsynth -stopthreshold")
    p.add_argument("--device", type=str, default=None, help="default: the card")
    a = p.parse_args(argv)
    pm_kw = {}
    if a.trim is not None:
        pm_kw["trim_seeded_levels"] = a.trim
    if a.stop_threshold is not None:
        pm_kw["stop_threshold"] = a.stop_threshold
    from fresco_torch.utils.classic_flow import pairwise_flow_fn

    blend_video(a.name, a.key_ind, a.key, flow_fn=pairwise_flow_fn(), poisson=a.ps, reuse_synthesis=a.ne,
                patch_cfg=PatchMatchConfig(**pm_kw), device=a.device)


if __name__ == "__main__":
    main()
