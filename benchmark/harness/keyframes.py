"""Traffic kind ``keyframes``: the keyframe stage of a clip, as a user runs
it offline, through ``FrescoPipeline.translate_keyframes``.

A call translates every keyframe of the configuration's clip (its
``keyframes`` list) in the pipeline's batches, the latent record carried
from batch to batch and every batch after the first anchored on two
earlier keyframes; calls follow each other with no pause (one client, a
closed loop).  The inputs are the configuration's frames (decoded and
sized once in set-up), the seeded weights and the seeded noise of every
batch; every call gets the same inputs.

The window closes at the end of the first call that ends ``seconds`` or
more after it opened, so it holds whole calls, each the same mix of
batches; ``keyframes_per_s`` is the keyframes of every batch finished in
the window over the wall from the window's start to the last batch's end.

The check: the decoded keyframes of the first ``compare_batches``
batches (the traffic file's number; they include an anchored batch) of
every call in the window, against the frozen reference's, run on the same frames,
weights and noise after the program is freed.  With random weights the
stage carries any rounding (another summation order in the reference
itself) into a pixel RMSE of some levels, spread over the frame with mean
nought; a lower precision moves each frame's colours as a whole.  So the
numbers compared are block means (``NUMBERS``).

``Traffic`` is this kind's generator, found by ``core.traffic_kind``.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import flops, stack, weights


def batch_sizes(spec: dict) -> list[tuple[int, int]]:
    """(images, keyframes) of each batch of a call."""
    from benchmark.reference.fresco_ref.core.config import keyframe_sublists

    subs = keyframe_sublists(list(spec["keyframes"]), spec["fresco"]["batch_size"])
    return [(len(s) + (2 if i else 0), len(s)) for i, s in enumerate(subs)]


def make_noise(spec: dict, seed: int, device) -> list[dict]:
    """Every batch's noise (the sampler's and the intra-frame pass's), drawn
    on ``device`` from the seed: standard normal, float32."""
    fr = spec["fresco"]
    h, w = spec["clip"]["height"] // 8, spec["clip"]["width"] // 8
    steps, warm = fr["num_inference_steps"], max(fr["num_warmup_steps"], 0)
    gen = torch.Generator(device=device).manual_seed(weights.model_seed(seed, "noise"))
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    out = []
    for n, _ in batch_sizes(spec):
        lat = (n, h, w, 4)
        g = int(np.gcd(n, 8))
        out.append({
            "intra_noise": randn(*lat), "intra_enc_noise": randn(*lat),
            "init_noise": randn(1, *lat[1:]).expand(lat) if fr.get("repeat_noise", True) else randn(*lat),
            "enc_noise": randn(*lat), "step_noise": randn(steps - warm, *lat),
            "bg_enc_noise": {s: [randn(g, *lat[1:]) for _ in range(n // g)]
                             for s in fr.get("bg_smoothing_steps", (16, 17)) if warm <= s < steps},
        })
    return out


def _ranged(name: str, fn):
    """``fn`` inside a ``record_function`` range of the harness."""
    def call(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return call


def block_gaps(ours: dict, ref: dict, grid: int = 0, px: int = 0) -> dict[int, float]:
    """For each keyframe of ``ref``: the frame cut into grid x grid blocks
    (or into blocks of px x px pixels), the root-mean-square over blocks and
    channels of the gap between the two sides' block means, in 8-bit levels
    (neither: of every pixel)."""
    out = {}
    for k in sorted(ref):
        a, b = ours[k].astype(np.float64), ref[k].astype(np.float64)
        if grid or px:
            h, w, c = a.shape
            gh, gw = (grid, grid) if grid else (h // px, w // px)
            a = a[: h - h % gh, : w - w % gw].reshape(gh, h // gh, gw, w // gw, c).mean(axis=(1, 3))
            b = b[: h - h % gh, : w - w % gw].reshape(gh, h // gh, gw, w // gw, c).mean(axis=(1, 3))
        out[k] = float(np.sqrt(np.mean((a - b) ** 2)))
    return out


# the numbers of the check, the worst keyframe's: name -> arguments of
# ``block_gaps``.  A cell's limits file says which it holds; the others are
# printed beside them, not compared.
NUMBERS = {"mean_gap": {"grid": 1}, "quadrant_gap": {"grid": 2}, "block64_gap": {"px": 64}}


def check_numbers(ours: dict, ref: dict) -> dict[str, float]:
    return {name: max(block_gaps(ours, ref, **kw).values()) for name, kw in NUMBERS.items()}


def reference_keyframes(spec: dict, seed: int, frames, device, n_batches: int, control: bool = False) -> dict:
    """The frozen reference's keyframes of a call's first ``n_batches``
    batches, on fresh weights and noise from the seed, float32 with TF32
    off but for operands that hold bfloat16 values; ``control``: the UNet, ControlNet and VAE computed in
    fp8 (``control.fp8_``), the control of the check."""
    from benchmark.harness import control as ctl
    from benchmark.reference.fresco_ref.pipeline.runner import FrescoPipeline

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    config, bundle = stack.build("reference", spec, seed, device)
    if control:
        ctl.fp8_(bundle.unet, bundle.controlnet, bundle.vae)
    pipe = FrescoPipeline(config, bundle)
    return pipe.translate_keyframes(frames, list(spec["keyframes"]), make_noise(spec, seed, device), n_batches)


@dataclasses.dataclass
class Keyframes:
    spec: dict
    traffic: dict
    seed: int
    device: torch.device
    frames: list

    def setup(self, traced: bool = False) -> None:
        """Kernels loaded (built once a checkout), the stack made from the
        seed, the noise drawn and every shape of the call warmed up.
        ``traced``: the pipeline syncs the device at each phase's end, so
        that ``FrescoPipeline.phases`` holds each phase's device work (a
        user's run, and an untraced one, do not sync)."""
        from fresco_torch import kernels
        from fresco_torch.pipeline.runner import FrescoPipeline

        if self.device.type == "cuda":
            t0 = time.perf_counter()
            kernels.load()
            print(f"benchmark: kernels loaded in {time.perf_counter() - t0:.3f} s "
                  "(nvcc builds them in a checkout's first run; inside setup_s)", file=sys.stderr)
        self.config, bundle = stack.build("program", self.spec, self.seed, self.device)
        bundle.detector = _ranged("bench::control_detector", bundle.detector)
        if bundle.saliency_fn is not None:
            bundle.saliency_fn = _ranged("bench::saliency", bundle.saliency_fn)
        self.pipe = FrescoPipeline(self.config, bundle)
        bundle.flow_fn = _ranged("bench::flow", self.pipe.gmflow_flow_fn())
        self.pipe.sync_phases = traced
        self.noise = make_noise(self.spec, self.seed, self.device)
        # warm-up: a whole call at a 4-step schedule whose 3 denoising
        # steps take every path of the cell's: the intra-frame and
        # inter-frame attentions (the first step, t >= step_interattn_end),
        # the feature optimization (all three), background smoothing (the last)
        warm = dataclasses.replace(self.config, num_inference_steps=4, num_warmup_steps=1, end_opt_step=4,
                                   bg_smoothing_steps=(3,))
        self.pipe.set_config(warm)
        self.pipe.translate_keyframes(self.frames, list(self.spec["keyframes"]))
        self.pipe.set_config(self.config)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        """Whole calls back to back until one ends ``seconds`` or more after the start."""
        from fresco_torch import kernels

        pipe = self.pipe
        pipe.phases = type(pipe.phases)()
        kernels.reset_launches()
        sizes = batch_sizes(self.spec)
        done, self.outputs = [], {}
        state = {"call": 0, "batch": 0}
        n_check = int(self.traffic["compare_batches"])
        t0 = time.perf_counter()

        def on_batch(keys: dict) -> None:
            # the keyframes are on the host: the batch has ended
            done.append((state["call"], state["batch"], time.perf_counter()))
            if state["batch"] < n_check:
                self.outputs.setdefault(state["call"], {}).update(keys)
            state["batch"] += 1

        while not done or done[-1][2] - t0 < seconds:
            state["batch"] = 0
            with record_function("bench::call"):
                pipe.translate_keyframes(self.frames, list(self.spec["keyframes"]), noise=self.noise,
                                         on_batch=on_batch)
            state["call"] += 1
        self.calls = state["call"]
        wall = done[-1][2] - t0
        height, width = self.spec["clip"]["height"], self.spec["clip"]["width"]
        keys = sum(sizes[b][1] for _, b, _ in done)
        return {
            "wall_s": wall,
            "keyframes": keys,
            "attempted": keys,
            "batches": len(done),
            "model_flops": sum(flops.denoise_batch_flops(self.spec, sizes[b][0], height, width) for _, b, _ in done),
            "phases": dict(pipe.phases.times),
            "launches": kernels.launches(),
            "batch_ends_s": [round(t - t0, 3) for _, _, t in done],
        }

    def end_to_end(self, stats: dict) -> dict:
        return {"keyframes_per_s": stats["keyframes"] / stats["wall_s"]}

    def release(self) -> None:
        """Free the program's models and state before the reference runs."""
        self.pipe = None
        self.noise = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict[str, float]:
        """The numbers that decide ``correct`` (``NUMBERS``), for the worst
        keyframe of the compared batches of every call in the window:
        its gap of whole-frame and of quadrant means against the reference,
        in 8-bit levels.  The pixel RMSE is printed beside them."""
        ref = reference_keyframes(self.spec, self.seed, self.frames, self.device, int(self.traffic["compare_batches"]))
        calls = range(self.calls)
        rmse = max(max(block_gaps(self.outputs[c], ref).values()) for c in calls)
        print(f"benchmark: {len(ref)} keyframes of {len(calls)} call(s) compared; worst pixel RMSE {rmse:.4f} "
              "(not compared)", file=sys.stderr)
        numbers = [check_numbers(self.outputs[c], ref) for c in calls]
        return {name: max(x[name] for x in numbers) for name in NUMBERS}


Traffic = Keyframes
