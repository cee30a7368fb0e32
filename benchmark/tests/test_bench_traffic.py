"""Each cell's traffic at tiny widths on the CPU: set-up, the window
through the program's public entry, and the check against the frozen
reference, which the program's plain CPU path matches."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import core, keyframes

CELLS = [w["name"] for w in json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_run, cell):
    r = tiny_run(cell)
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    for c in r["checks"].values():
        assert c["value"] <= 1.0  # the same float32 plain arithmetic on both sides


@pytest.mark.parametrize("cell", CELLS)
def test_inputs_follow_the_seed(bench, tiny, cell):
    """The same seed gives the same frames, weights and noise; another seed other noise."""
    _, spec, _, kind = core.make_traffic(bench, cell, 7, torch.device("cpu"), overrides=tiny)
    a, b = keyframes.make_noise(spec, 7, "cpu"), keyframes.make_noise(spec, 7, "cpu")
    c = keyframes.make_noise(spec, 8, "cpu")
    assert all(torch.equal(x["step_noise"], y["step_noise"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["step_noise"], c[0]["step_noise"])
    assert [n for n, _ in keyframes.batch_sizes(spec)] == [x["enc_noise"].shape[0] for x in a]
    assert len(kind.frames) == spec["clip"]["frames"]
    assert kind.frames[0].shape == (spec["clip"]["height"], spec["clip"]["width"], 3)
    assert kind.frames[0].dtype == np.uint8


def test_batches_of_the_cells(bench):
    """The batches that the configurations' keyframes give (images, keyframes)."""
    sizes = {}
    for cfg in bench["configs"]:
        sizes[cfg["name"]] = keyframes.batch_sizes(core.load_json(core.ROOT, cfg["file"]))
    assert sizes["sd15_hed_music"] == [(8, 8), (8, 6), (5, 3)]
    assert sizes["sd15_depth_boxer"] == [(8, 8), (7, 5), (5, 3)]
