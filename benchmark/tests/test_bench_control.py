"""The check fails what it should: the control (the reference in fp8 in
the program's place) and a run with the timed path broken underneath, at
tiny widths on the CPU, against the cell's own limits."""
import json
import os

import pytest
import torch

from benchmark.harness import core, keyframes

CELLS = [w["name"] for w in json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))["workloads"]]


def _failed(numbers: dict, cell: str) -> bool:
    limits = core.load_json(core.BENCH_DIR, "limits", f"{cell}.json")
    return any(numbers[k] > limit for k, limit in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, tiny, cell):
    _, spec, traffic, kind = core.make_traffic(bench, cell, 21, torch.device("cpu"), overrides=tiny)
    n = traffic["compare_batches"]
    ref = keyframes.reference_keyframes(spec, 21, kind.frames, "cpu", n)
    ctl = keyframes.reference_keyframes(spec, 21, kind.frames, "cpu", n, control=True)
    assert _failed(keyframes.check_numbers(ctl, ref), cell)


def _step_unchanged(monkeypatch):
    """The denoise step returns its latents unchanged."""
    from fresco_torch.diffusion.scheduler import DDPMScheduler

    monkeypatch.setattr(DDPMScheduler, "step_from_x0", lambda self, latents, *a, **k: latents)


def _answer_altered(monkeypatch):
    """One decoded keyframe of each batch altered where it is produced."""
    from fresco_torch.pipeline.runner import FrescoPipeline

    decode = FrescoPipeline.decode

    def altered(self, latents):
        out = decode(self, latents).copy()
        out[-1, : out.shape[1] // 2] = 255 - out[-1, : out.shape[1] // 2]
        return out

    monkeypatch.setattr(FrescoPipeline, "decode", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_step_unchanged, _answer_altered])
def test_broken_program_is_not_correct(bench, tiny, monkeypatch, fault, cell):
    fault(monkeypatch)
    r = core.run(bench, cell, 22, 0.5, False, torch.device("cpu"), overrides=tiny)
    assert r["correct"] is False
