"""The keyframe stage's profiler ranges and work counters, on the CPU.

A tiny-model ``translate_keyframes`` with the feature optimization on runs
under ``torch.profiler``.  Every phase that ``FrescoPipeline.phases`` times
must show as its ``fresco::<phase>`` range once per phase call, the gram
and the attention as ``fresco::gram`` and ``fresco::attention``, and
``kernels.work_counts()`` must hold each ``_gram_l1_grad`` and
``flash_attention`` call at its full shape (spied on here);
``kernels.reset_launches()`` sets the counts to nought.
"""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fresco_torch import kernels
from fresco_torch.attention import fresco_attention
from fresco_torch.core.config import FrescoConfig
from fresco_torch.diffusion import guidance
from fresco_torch.models import vae
from fresco_torch.ops.image import resize_image
from fresco_torch.pipeline import runner
from fresco_torch.utils import clips

CFG = FrescoConfig(
    resolution=64, num_inference_steps=3, num_warmup_steps=1, end_opt_step=3, opt_iters=2,
    dtype="float32", gram_dtype="float32", batch_size=3, mininterv=2, maxinterv=2,
    controlnet_type="canny", use_saliency=False, use_fresco_opt=True, prompt="a woman",
    gmflow_path="missing/gmflow.pth", sod_path="missing/egnet.pth")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models are many small ops: one intra-op thread runs them as fast
    as eight, and leaves the suite's other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, module, name: str, shape_of, calls: Counter) -> None:
    """Count each call of ``module.name`` by ``shape_of(args)`` and run it."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls[shape_of(*args)] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_keyframe_stage_ranges_and_work_counts(monkeypatch):
    frames = [resize_image(f, CFG.resolution) for f in clips.read_frames(clips.bundled_clip("music.mp4"), 9)]
    pipe = runner.FrescoPipeline(CFG, runner.build_models(CFG, tiny=True, seed=CFG.seed, device="cpu"))
    grams, attns = Counter(), Counter()
    _spy(monkeypatch, guidance, "_gram_l1_grad", lambda v, *a: tuple(v.shape), grams)
    for module in (fresco_attention, vae):
        _spy(monkeypatch, module, "flash_attention", lambda q, k, *a: (*q.shape[:3], k.shape[2], q.shape[3]),
             attns)
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.translate_keyframes(frames)
    names = Counter(n for n in (e.name() for e in prof.profiler.kineto_results.events()) if n.startswith("fresco::"))

    phases = dict(pipe.phases.counts)
    assert {"upload_frames", "encode_prompts", "control_detector", "interframe_prep", "intraframe_prep",
            "attn_params", "denoise_loop", "vae_decode"} <= set(phases)
    assert {p: names[f"fresco::{p}"] for p in phases} == phases
    # at this size every reference gram fits the dense budget: each
    # optimize_feature call adds its one dense build to the gram's range
    assert names["fresco::gram"] == sum(grams.values()) + names["fresco::optimize_feature"]
    assert sum(grams.values()) > 0
    assert names["fresco::attention"] == sum(attns.values()) > 0
    assert kernels.work_counts() == {"gram": dict(grams), "attention": dict(attns)}
    # the gram's batch: CFG's 2 x each batch's images (two batches here)
    assert {shape[0] for shape in grams} == {2 * len(b[1]) for b in pipe.keyframe_batches(frames)} == {6, 8}
    kernels.reset_launches()
    assert kernels.work_counts() == {"gram": {}, "attention": {}}
