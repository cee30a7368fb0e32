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
an mp4 (``frames_to_video``; the video helpers need OpenCV).

The flow source, as in the JAX package: the caller's ``flow_fn``, else
``default_flow_fn()``: GMFlow from its checkpoint where one exists, else
Farneback through OpenCV.  With ``n_devices`` > 1 the intervals run in
waves, one chain per device (``_synthesize_chain_wave``,
``propagate/parallel.py``), with the same output as the serial path.
Under a process group of more than one rank the devices are its ranks:
every rank calls ``blend_video_frames`` (or ``blend_video``), each runs
one chain of a wave on its own device, and rank 0 alone blends.

Run: ``python -m fresco_torch.propagate.video_blend <dir> --key_ind 0 10``
(the JAX command line's flags, plus ``--device``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
import traceback
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
from fresco_torch.propagate.patchmatch import BACKEND_NAMES, PatchMatchConfig, TorchDraws, synthesize
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

    def table(self, total: float) -> str:
        """The phases, longest first, each with its share of ``total``."""
        rows = sorted(self.t.items(), key=lambda kv: -kv[1])
        body = "\n".join(f"  {k:<12s} {v:8.1f}s  ({100 * v / total:5.1f}% of wall)" for k, v in rows)
        return (f"[fresco_torch] propagation phase wall (total {total:.1f}s; "
                f"phases overlap across the prefetch thread):\n{body}")


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
                    self.put(t, bwd[j], bwd_occ[j])
        return [self.cache[t] for t in tags]

    def put(self, tag: str, flow: torch.Tensor, occ: torch.Tensor) -> None:
        """Keep a pair's flow and occlusion (and write them to ``tmp_dir``)."""
        self.cache[tag] = (flow, occ)
        if self._path(tag):
            np.savez(self._path(tag), flow=flow.cpu().numpy(), occ=occ.cpu().numpy())


def _stream_seed(*keys: int) -> int:
    """An independent seed per (seed, interval, position, direction)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1)[0])


def _guide_weights(device) -> torch.Tensor:
    return torch.tensor(
        [GUIDE_WEIGHTS[g] / 3 for g in ("color", "edge", "temporal", "positional") for _ in range(3)],
        dtype=torch.float32, device=device)


def _synthesize_chain(key_img, frames, flows, cfg, seed: int, d: int, inpaint_method: str = "pushpull",
                      timers: PhaseTimers | None = None, draw_device=None, backend: str = "jumpflood"):
    """One chain of an interval (video_blend.py:181-278), on ``key_img``'s
    device.  ``frames``: the interval's frames from the chain's keyframe
    on; ``flows``: the backward flow and occlusion of each pair.  The chain
    synthesizes positions 1..len(frames)-2 only: the far keyframe is never
    blended.  ``seed`` is the interval's; position j draws from
    ``TorchDraws(_stream_seed(seed, j, d))`` (``d``: 0 forward, 1
    backward).  Returns (outs, errs), uint8 / float32, in chain order."""
    tick = timers if timers is not None else (lambda _phase: contextlib.nullcontext())
    dev = key_img.device
    h, w = frames[0].shape[:2]
    with tick("guides"):
        pos = positional_chain(h, w, [f for f, _ in flows], [o for _, o in flows], method=inpaint_method, device=dev)
        src = torch.cat([frames[0], edge_guide(frames[0]), key_img, pos[0]], -1).float()
    weights = _guide_weights(dev)
    style = key_img.float()
    outs, errs, prev = [], [], key_img
    for j in range(1, len(frames) - 1):
        with tick("guides"):
            bwd_flow, bwd_occ = flows[j - 1]
            temporal = temporal_guide(prev, bwd_flow, bwd_occ, method=inpaint_method)
            tgt = torch.cat([frames[j], edge_guide(frames[j]), temporal, pos[j]], -1).float()
        with tick("synth"):
            out, err, _ = synthesize(style, src, tgt, weights, cfg,
                                     draws=TorchDraws(_stream_seed(seed, j, d), dev, draw_device), backend=backend)
            prev = out.clamp(0, 255).to(torch.uint8)  # truncation, as astype
            outs.append(prev)
            errs.append(err)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return outs, errs


def _synthesize_chain_pair(key_imgs, frames_pair, flows_pair, cfg, seed: int,
                           inpaint_method: str = "pushpull", timers: PhaseTimers | None = None,
                           draw_device=None, backend: str = "jumpflood"):
    """The forward and the backward chain of one interval
    (``_synthesize_chain`` with d = 0, 1).  Returns ((fwd_outs, fwd_errs),
    (bwd_outs, bwd_errs)), the backward lists in chain order."""
    return tuple(_synthesize_chain(key_imgs[d], frames_pair[d], flows_pair[d], cfg, seed, d, inpaint_method,
                                   timers, draw_device, backend) for d in range(2))


def _synthesize_chain_wave(wave, cfg, seed: int, devices, inpaint_method: str = "pushpull",
                           timers: PhaseTimers | None = None, draw_device=None):
    """Every chain of a wave of intervals, one chain per device
    (``fresco_tpu/propagate/video_blend.py:281-397``).

    ``wave``: [(seq_i, key_imgs, frames_pair, flows_pair)], each as
    ``_synthesize_chain_pair`` takes them; ``seed`` is the run's seed.
    Each interval gives two jobs (the forward and the backward chain); job
    k runs ``_synthesize_chain`` on ``devices[k]`` (``parallel.run_jobs``;
    the list may repeat a device), its inputs copied there, with the
    interval's seed ``_stream_seed(seed, seq_i)``, so the wave equals
    ``_synthesize_chain_pair`` bit for bit.  The chains are independent:
    each runs to its own end, with no lockstep between them (the JAX
    package's lockstep and re-feed serve its one program across the mesh).
    Returns {seq_i: ((fwd_outs, fwd_errs), (bwd_outs, bwd_errs))} on each
    job's device, the backward lists in chain order."""
    from fresco_torch.propagate.parallel import job_devices, run_jobs

    jobs = [(seq_i, d, key_imgs[d], frames_pair[d], flows_pair[d])
            for seq_i, key_imgs, frames_pair, flows_pair in wave for d in range(2)
            if len(frames_pair[d]) > 2]  # interval 1: nothing to synthesize
    results = {seq_i: [([], []), ([], [])] for seq_i, *_ in wave}
    devs = job_devices(len(jobs), devices)

    def chain(job, dev):
        seq_i, d, key, frames, flows = job
        return _synthesize_chain(key.to(dev), [f.to(dev) for f in frames], [(f.to(dev), o.to(dev)) for f, o in flows],
                                 cfg, _stream_seed(seed, seq_i), d, inpaint_method, timers, draw_device)

    outs = run_jobs(devs, [functools.partial(chain, job, dev) for job, dev in zip(jobs, devs)])
    for (seq_i, d, *_), out in zip(jobs, outs):
        results[seq_i][d] = out
    return {k: tuple(v) for k, v in results.items()}


def _clip_from_rank0(frames, keys, key_ind: list[int], dev: torch.device, wire: torch.device):
    """Rank 0's frames key_ind[0]..key_ind[-1] and keyframes on every rank
    of the group, as {index: uint8 tensor on ``dev``} (two broadcasts by
    way of ``wire``; the other ranks pass None for both)."""
    import torch.distributed as dist

    from fresco_torch.parallel.distributed import main_process_value

    lead = dist.get_rank() == 0
    out = []
    for imgs, idx in ((frames, range(key_ind[0], key_ind[-1] + 1)), (keys, list(key_ind))):
        t = torch.from_numpy(np.stack([imgs[i] for i in idx])).to(wire) if lead else None
        shape, dtype = main_process_value((tuple(t.shape), t.dtype) if lead else None)
        if not lead:
            t = torch.empty(shape, dtype=dtype, device=wire)
        dist.broadcast(t, 0)
        out.append(dict(zip(idx, t.to(dev).unbind(0))))
    return out


def default_flow_fn(gmflow_path: str | None = None, device: torch.device | str | None = None):
    """The propagation stage's flow source when the caller gives none
    (``fresco_tpu/propagate/video_blend.py:400-420``): GMFlow
    (``GMFlowConfig()``, float32) loaded from the checkpoint at
    ``gmflow_path`` (default ``FrescoConfig.gmflow_path``) onto ``device``
    (default the card) where that file exists, else Farneback through
    OpenCV.  Without either it raises ``ImportError``."""
    from fresco_torch.core.config import FrescoConfig

    path = gmflow_path or FrescoConfig.gmflow_path
    if path and os.path.exists(path):
        from fresco_torch.models.gmflow import GMFlow
        from fresco_torch.models.gmflow.convert import convert_gmflow
        from fresco_torch.pipeline.runner import _loaded_module

        model = _loaded_module(GMFlow, path, convert_gmflow, resolve_device(device), torch.float32, {}, "gmflow")

        @torch.no_grad()
        def flow_fn(a, b):
            return model(a.float(), b.float())

        return flow_fn
    from fresco_torch.utils.classic_flow import pairwise_flow_fn

    try:
        return pairwise_flow_fn()
    except ImportError as e:
        raise ImportError(f"no flow source: no GMFlow checkpoint at {path!r} (pass one with --gmflow / "
                          "gmflow_path) and OpenCV (cv2), which Farneback flows need, is not importable") from e


def blend_video_frames(
    frames,
    keys,
    key_ind: list[int],
    *,
    flow_fn=None,
    poisson: bool = True,
    use_histogram: bool = True,
    patch_cfg: PatchMatchConfig = PatchMatchConfig(),
    seed: int = 0,
    inpaint_method: str = "pushpull",
    synth_backend: str = "jumpflood",
    n_devices: int | str = 1,
    tmp_dir: str | None = None,
    reuse_synthesis: bool = False,
    keep_tmp: bool = True,
    device: torch.device | str | None = None,
    draw_device: torch.device | str | None = None,
    timers_out: dict | None = None,
) -> dict[int, np.ndarray] | None:
    """The propagation stage in memory (video_blend.py:423-708).

    ``frames``: {index: uint8 [H,W,3] BGR} for key_ind[0]..key_ind[-1];
    ``keys``: {index: stylized uint8 BGR} for each of ``key_ind``;
    ``flow_fn``: float32 [N,H,W,3] pairs (a, b) on the device ->
    [2N,H,W,2] flows (forward block, then backward), as the keyframe
    stage's ``ModelBundle.flow_fn``; None takes ``default_flow_fn``.
    ``synth_backend``: ``"jumpflood"`` (the device path) or ``"native"``
    (the C++ serpentine backend on the host).  ``n_devices``: 1 (serial),
    an int or ``"auto"`` (every visible card, 1 on the CPU; under a process
    group, its ranks: below): with more
    than one and jumpflood, intervals run in waves of ``n_devices // 2``,
    shortest first, one chain per device (the first ``n_devices`` cards;
    on the CPU, ``n_devices`` copies of it); the output equals the serial
    path's.  ``tmp_dir``: flow and synthesis npz caches
    (``reuse_synthesis`` loads an interval's saved synthesis, the
    reference's ``-ne``).  ``draw_device``: where the random search draws
    are made (``TorchDraws``; the CPU makes a run on the card repeatable on
    the CPU).  Returns {index: blended uint8 [H,W,3] BGR}; the keyframes
    pass through unchanged.  ``timers_out`` receives the per-phase wall
    seconds and ``wall_total``.

    Under a process group of more than one rank with ``n_devices``
    ``"auto"`` (or the group's size), every rank calls it with the same
    arguments, and the other ranks pass None for ``frames`` and ``keys``:
    they take rank 0's over the group.  The waves are the same, each of
    their chains runs on one rank, on that rank's device, with the serial
    path's seed, and the ranks send their chains' outputs, errors and
    forward flows to rank 0, which alone blends, reads and writes
    ``tmp_dir`` and returns the frames (the others return None).  Rank 0
    decides which intervals ``reuse_synthesis`` loads.  A rank that fails
    makes every rank raise.  ``timers_out`` also receives ``chains``: a dict
    per chain this rank synthesized (interval, direction, rank, device,
    frames, wall)."""
    from fresco_torch.propagate.parallel import dealt_over_group, device_scope, resolve_n_devices, wave_devices

    dev = resolve_device(device)
    if synth_backend not in ("jumpflood", "native"):
        raise ValueError(f"synth_backend {synth_backend!r}: expected 'jumpflood' or 'native'")
    dealt = dealt_over_group(n_devices, dev)
    n_devices = resolve_n_devices(n_devices, dev)
    devices = wave_devices(n_devices, dev) if n_devices > 1 and synth_backend == "jumpflood" and not dealt else None
    rank, wire, chains = 0, None, []
    if dealt:
        import torch.distributed as dist

        from fresco_torch.propagate.parallel import all_ranks, recv_from, send_to, wire_device

        rank, wire = dist.get_rank(), wire_device(dev)
        args = all_ranks((list(key_ind), seed, patch_cfg, inpaint_method, synth_backend, poisson, use_histogram),
                         what="blend_video_frames")
        if any(a != args[0] for a in args):  # every rank sees every rank's and raises alike
            raise ValueError(f"blend_video_frames: every rank must pass rank 0's arguments; by rank: {args}")
        tmp_dir = tmp_dir if rank == 0 else None  # rank 0 alone reads and writes the caches
    if flow_fn is None:
        flow_fn = default_flow_fn(device=dev)
    if tmp_dir is not None:
        os.makedirs(tmp_dir, exist_ok=True)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    if dealt:
        frames_t, keys_t = _clip_from_rank0(frames, keys, key_ind, dev, wire)
    else:
        frames_t = {i: up(frames[i]) for i in range(key_ind[0], key_ind[-1] + 1)}
        keys_t = {i: up(keys[i]) for i in key_ind}
    timers = PhaseTimers()
    fcache = _FlowCache(flow_fn, dev, tmp_dir=tmp_dir, timers=timers)
    n_seq = len(key_ind) - 1
    result: dict[int, np.ndarray] = {}

    def synth_cache(seq_i):
        beg, end = key_ind[seq_i], key_ind[seq_i + 1]
        return None if tmp_dir is None else os.path.join(tmp_dir, f"synth_{beg}_{end}.npz")

    def cached(seq_i):
        cache = synth_cache(seq_i)
        return reuse_synthesis and cache is not None and os.path.exists(cache)

    def chain_inputs(seq_i, d):
        """(key_img, frames, flows) of chain ``d`` of interval seq_i, the
        flows computed or loaded (flow thread)."""
        beg, end = key_ind[seq_i], key_ind[seq_i + 1]
        seq = [frames_t[i] for i in range(beg, end + 1)]
        js = list(range(max(end - beg - 1, 0)))
        if d == 0:
            return keys_t[beg], seq, fcache.get_batch(seq, js, [f"f{beg}_{j}" for j in js])
        return keys_t[end], seq[::-1], fcache.get_batch(seq[::-1], js, [f"b{end}_{j}" for j in js])

    def interval_inputs(seq_i):
        """(key_imgs, frames_pair, flows_pair) of interval seq_i; computes
        or loads the pair flows (flow thread)."""
        key_img, seq, fwd_flows = chain_inputs(seq_i, 0)
        bwd_flows = None if cached(seq_i) else chain_inputs(seq_i, 1)[2]
        return (key_img, keys_t[key_ind[seq_i + 1]]), (seq, seq[::-1]), (fwd_flows, bwd_flows)

    def load_synth(seq_i, fwd_flows):
        z = np.load(synth_cache(seq_i))
        return (*(list(up(x) for x in z[k]) for k in ("fwd_out", "fwd_err", "bwd_out", "bwd_err")), fwd_flows)

    def save_synth(seq_i, fo, fe, bo, be):
        cache = synth_cache(seq_i)
        if cache and keep_tmp and fo:
            np.savez(cache, **{k: torch.stack(v).cpu().numpy()
                               for k, v in (("fwd_out", fo), ("fwd_err", fe), ("bwd_out", bo), ("bwd_err", be))})

    def synth_interval(seq_i, inputs):
        """Both chains of one interval (synthesis thread).  Returns
        (fwd_out, fwd_err, bwd_out, bwd_err, fwd_flows)."""
        key_imgs, frames_pair, flows_pair = inputs
        if cached(seq_i):
            return load_synth(seq_i, flows_pair[0])
        (fo, fe), (bo, be) = _synthesize_chain_pair(
            key_imgs, frames_pair, flows_pair, patch_cfg, _stream_seed(seed, seq_i),
            inpaint_method=inpaint_method, timers=timers, draw_device=draw_device, backend=synth_backend)
        bo, be = bo[::-1], be[::-1]
        save_synth(seq_i, fo, fe, bo, be)
        return fo, fe, bo, be, flows_pair[0]

    def synth_wave(wave_idx, inputs_list):
        """A wave of intervals over ``devices`` (synthesis thread).
        Returns {seq_i: synth_interval's tuple}, on ``dev``."""
        results, wave = {}, []
        for seq_i, (key_imgs, frames_pair, flows_pair) in zip(wave_idx, inputs_list):
            if cached(seq_i):
                results[seq_i] = load_synth(seq_i, flows_pair[0])
            else:
                wave.append((seq_i, key_imgs, frames_pair, flows_pair))
        if wave:
            flows = {seq_i: flows_pair[0] for seq_i, _, _, flows_pair in wave}
            out = _synthesize_chain_wave(wave, patch_cfg, seed, devices, inpaint_method=inpaint_method,
                                         timers=timers, draw_device=draw_device)
            for seq_i, ((fo, fe), (bo, be)) in out.items():
                fo, fe, bo, be = ([x.to(dev) for x in v] for v in (fo, fe, bo[::-1], be[::-1]))
                save_synth(seq_i, fo, fe, bo, be)
                results[seq_i] = (fo, fe, bo, be, flows[seq_i])
        return results

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

    # The waves dealt over the group's ranks: wave wi's job k (its
    # intervals' chains in _synthesize_chain_wave's order) runs on rank k
    if dealt:
        per_wave = max(n_devices // 2, 1)
        order = sorted(range(n_seq), key=lambda i: key_ind[i + 1] - key_ind[i])
        dealt_waves = [order[i:i + per_wave] for i in range(0, n_seq, per_wave)]
        skip = set(all_ranks(sorted(i for i in range(n_seq) if cached(i)), what="blend_video_frames")[0])
        jobs = [[(s, d) for s in w if s not in skip and key_ind[s + 1] - key_ind[s] > 1 for d in range(2)]
                for w in dealt_waves]

        def rank_inputs(wi):
            """This rank's share of wave wi (flow thread): its job and the
            job's inputs, and on rank 0 the forward flows of the wave's
            cached intervals, which it blends without a chain."""
            job = jobs[wi][rank] if rank < len(jobs[wi]) else None
            fwd = {s: chain_inputs(s, 0)[2] for s in dealt_waves[wi] if s in skip} if rank == 0 else {}
            return job, (chain_inputs(*job) if job else None), fwd

        def dealt_wave(wi):
            """This rank's chain of wave wi, then the exchange (synthesis
            thread).  Returns {seq_i: synth_interval's tuple} on rank 0,
            None on the others."""
            payload, err = [], None
            try:
                job, inputs, fwd = take_inputs(wi)
                if job is not None:
                    (s, d), (key_img, chain_frames, flows) = job, inputs
                    t0 = time.perf_counter()
                    outs, errs = _synthesize_chain(key_img, chain_frames, flows, patch_cfg, _stream_seed(seed, s), d,
                                                   inpaint_method, timers, draw_device, synth_backend)
                    chains.append({"seq_i": s, "d": d, "rank": rank, "device": str(dev), "frames": len(outs),
                                   "wall_s": time.perf_counter() - t0})
                    payload = [torch.stack(outs), torch.stack(errs)]
                    if d == 0:  # the forward chain's flows: rank 0's blend reads them
                        payload += [torch.stack([f for f, _ in flows]), torch.stack([o for _, o in flows])]
            except Exception:  # every rank raises in all_ranks, with this traceback
                err = traceback.format_exc()
            with timers("exchange"):
                specs = all_ranks([(tuple(t.shape), t.dtype) for t in payload], err, f"propagation wave {wi}")
                if rank != 0:
                    send_to(payload, 0, wire)
                    return None
                got = {jobs[wi][r]: payload if r == 0 else recv_from(specs[r], r, wire, dev)
                       for r in range(len(jobs[wi]))}
            results = {}
            for s in dealt_waves[wi]:
                beg = key_ind[s]
                if s in skip:
                    results[s] = load_synth(s, fwd[s])
                elif (s, 0) not in got:  # an interval of one frame: no chain
                    results[s] = ([], [], [], [], [])
                else:
                    fo, fe, ff, focc = (list(t.unbind(0)) for t in got[(s, 0)])
                    bo, be = (list(t.unbind(0))[::-1] for t in got[(s, 1)])
                    if jobs[wi][0] != (s, 0):  # another rank's flows: kept (and written) as rank 0's own are
                        for j, (f, o) in enumerate(zip(ff, focc)):
                            fcache.put(f"f{beg}_{j}", f, o)
                    save_synth(s, fo, fe, bo, be)
                    results[s] = (fo, fe, bo, be, list(zip(ff, focc)))
            return results

    # Three-stage pipeline (video_blend.py:613-694): the flow thread keeps
    # FLOW_AHEAD intervals of flows ready, the synthesis thread runs
    # interval (or wave) k+1 while the main thread blends interval k.
    executor = ThreadPoolExecutor(max_workers=1)
    flow_ex = ThreadPoolExecutor(max_workers=1)
    flow_ahead = 2
    inputs_fut: dict = {}

    def scoped(fn, *args):
        """``fn(*args)`` with this rank's device current (the pool's threads
        start on cuda:0)."""
        with device_scope(dev):
            return fn(*args)

    def queue_inputs(order, pos, fn=interval_inputs):
        """Queue ``fn`` on the flow thread for the synthesis-order
        positions up to ``pos + flow_ahead``."""
        for i in order[: pos + 1 + flow_ahead]:
            if i not in inputs_fut:
                inputs_fut[i] = flow_ex.submit(scoped, fn, i)

    def take_inputs(seq_i):
        """One interval's inputs, released once taken (synthesis thread)."""
        inp = inputs_fut[seq_i].result()
        inputs_fut[seq_i] = None
        return inp

    t0 = time.perf_counter()
    try:
        if dealt and n_seq > 0:
            wave_order = list(range(len(dealt_waves)))

            def launch_dealt(wi):
                queue_inputs(wave_order, wi, rank_inputs)
                return executor.submit(scoped, dealt_wave, wi)

            nxt = launch_dealt(0)
            for wi, wave_idx in enumerate(dealt_waves):
                res = nxt.result()
                nxt = launch_dealt(wi + 1) if wi + 1 < len(dealt_waves) else None
                if rank != 0:
                    continue
                try:
                    for seq_i in sorted(wave_idx):
                        blend_interval(seq_i, *res[seq_i])
                except Exception:
                    if wi + 2 < len(dealt_waves):  # the ranks go on to wave wi + 2's exchange: fail it there
                        nxt.result()
                        scoped(all_ranks, [], traceback.format_exc(), f"propagation wave {wi + 2} (rank 0's blend)")
                    raise
        elif devices is not None and n_seq > 0:
            per_wave = max(n_devices // 2, 1)
            # intervals of similar length share a wave: a finished chain
            # waits for the wave's longest one
            order = sorted(range(n_seq), key=lambda i: key_ind[i + 1] - key_ind[i])
            waves = [order[i:i + per_wave] for i in range(0, n_seq, per_wave)]

            def launch_wave(wi):
                queue_inputs(order, min((wi + 1) * per_wave, n_seq) - 1)
                return executor.submit(lambda: synth_wave(waves[wi], [take_inputs(i) for i in waves[wi]]))

            nxt = launch_wave(0)
            for wi, wave_idx in enumerate(waves):
                res = nxt.result()
                if wi + 1 < len(waves):
                    nxt = launch_wave(wi + 1)
                for seq_i in sorted(wave_idx):
                    blend_interval(seq_i, *res[seq_i])
        elif n_seq > 0:
            order = list(range(n_seq))

            def launch(seq_i):
                queue_inputs(order, seq_i)
                return executor.submit(lambda: synth_interval(seq_i, take_inputs(seq_i)))

            nxt = launch(0)
            for seq_i in range(n_seq):
                res = nxt.result()
                if seq_i + 1 < n_seq:
                    nxt = launch(seq_i + 1)
                blend_interval(seq_i, *res)
    finally:
        executor.shutdown(wait=False, cancel_futures=True)
        flow_ex.shutdown(wait=False, cancel_futures=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    if timers_out is not None:
        timers_out.update(timers.t)
        timers_out["wall_total"] = total
        if dealt:
            timers_out["chains"] = chains
    if rank != 0:
        return None
    result[key_ind[-1]] = keys[key_ind[-1]]
    print(f"[fresco_torch] propagation+blend: {total:.1f}s")
    if timers.t:
        print(timers.table(total))
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
                reuse_synthesis: bool = False, keep_tmp: bool = True, synth_backend: str = "jumpflood",
                inpaint_method: str = "pushpull", n_devices: int | str = 1,
                device: torch.device | str | None = None, timers_out: dict | None = None) -> str | None:
    """The reference's file layout around ``blend_video_frames``: reads
    base_dir/video/%04d.png and base_dir/<key_dir>/%04d.png, writes
    base_dir/blend/%04d.png (caches in base_dir/tmp) and, given
    ``output``, those frames as an mp4 at ``fps``.  ``n_proc`` is accepted
    for the CLI's sake and not used (as in the JAX package); the other
    options are ``blend_video_frames``'s.  Returns the blend directory.
    Where ``blend_video_frames`` deals the chains over a process group,
    every rank calls it: rank 0 alone reads and writes files, and the
    other ranks return None."""
    import torch.distributed as dist

    from fresco_torch.propagate.parallel import dealt_over_group

    lead = not dealt_over_group(n_devices, resolve_device(device)) or dist.get_rank() == 0
    frames = keys = None
    if lead:
        frames = {i: read_bgr(os.path.join(base_dir, "video", "%04d.png" % i))
                  for i in range(key_ind[0], key_ind[-1] + 1)}
        keys = {i: read_bgr(os.path.join(base_dir, key_dir, "%04d.png" % i)) for i in key_ind}
    out = blend_video_frames(
        frames, keys, key_ind, flow_fn=flow_fn, poisson=poisson, use_histogram=use_histogram,
        patch_cfg=patch_cfg, seed=seed, inpaint_method=inpaint_method, synth_backend=synth_backend,
        n_devices=n_devices, tmp_dir=os.path.join(base_dir, "tmp"), reuse_synthesis=reuse_synthesis, keep_tmp=keep_tmp,
        device=device, timers_out=timers_out)
    if not lead:
        return None
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
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--backend", type=str, default="jumpflood", choices=sorted(BACKEND_NAMES),
                   help="patch-synthesis backend: jumpflood (also tpu, cuda) on the device, "
                        "native (also cpu) = the C++ serpentine backend on the host")
    p.add_argument("--inpaint", type=str, default="pushpull", choices=["pushpull", "telea"],
                   help="guide inpainting (telea = reference parity, needs OpenCV)")
    p.add_argument("--fps", type=float, default=30)
    p.add_argument("--key_ind", type=int, nargs="+", required=True)
    p.add_argument("--key", type=str, default="keys")
    p.add_argument("--n_proc", type=int, default=8)
    p.add_argument("--n_devices", type=str, default="1",
                   help="interval-parallel synthesis over this many cards ('auto' = every visible card)")
    p.add_argument("-ps", action="store_true", help="Poisson fusion")
    p.add_argument("-ne", action="store_true", help="reuse previous synthesis outputs (resume)")
    p.add_argument("-tmp", action="store_true", help="keep tmp caches")
    p.add_argument("--trim", type=int, default=None,
                   help="trim_seeded_levels tier (0 = full candidate sweep, 2 = throughput-first)")
    p.add_argument("--stop-threshold", type=float, default=None, help="ebsynth -stopthreshold (0 disables freezing)")
    p.add_argument("--gmflow", type=str, default=None,
                   help="GMFlow checkpoint for flows (default: the FrescoConfig location; Farneback where absent)")
    p.add_argument("--device", type=str, default=None, help="default: the card")
    a = p.parse_args(argv)
    pm_kw = {}
    if a.trim is not None:
        pm_kw["trim_seeded_levels"] = a.trim
    if a.stop_threshold is not None:
        pm_kw["stop_threshold"] = a.stop_threshold
    blend_video(a.name, a.key_ind, a.key, a.output, a.fps, a.n_proc, poisson=a.ps, reuse_synthesis=a.ne,
                keep_tmp=True, synth_backend=BACKEND_NAMES[a.backend], inpaint_method=a.inpaint,
                patch_cfg=PatchMatchConfig(**pm_kw),
                n_devices=a.n_devices if a.n_devices == "auto" else int(a.n_devices),
                flow_fn=default_flow_fn(a.gmflow, a.device) if a.gmflow else None, device=a.device)


if __name__ == "__main__":
    main()
