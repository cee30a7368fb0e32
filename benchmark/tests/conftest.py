"""CPU tests of the benchmark at tiny widths.

``TINY`` replaces the configuration's widths, steps, dtypes and frame size
so that a whole run (set-up, window, check) takes seconds on the CPU,
where the program runs its plain paths.  Run from the root of a checkout:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

TINY = {
    "widths": {
        "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [8, 16], "layers_per_block": 1,
                 "cross_attention_dim": 32, "attention_heads": 2, "norm_groups": 4, "fresco_up_blocks": [1]},
        "controlnet": {"conditioning_embedding_out_channels": [4, 4, 8, 8]},
        "vae": {"in_channels": 3, "latent_channels": 4, "block_out_channels": [8, 8, 16, 16],
                "layers_per_block": 1, "norm_groups": 4},
        "text_encoder": {"vocab_size": 1000, "hidden_size": 32, "num_layers": 2, "num_heads": 4,
                         "intermediate_size": 64, "max_position_embeddings": 77},
        "gmflow": {"feature_channels": 16, "num_transformer_layers": 2},
    },
    "fresco": {"num_inference_steps": 4, "num_warmup_steps": 1, "end_opt_step": 3, "bg_smoothing_steps": [2, 3],
               "opt_iters": 2, "dtype": "float32", "gram_dtype": "float32", "aux_dtype": "float32"},
    "clip": {"height": 64, "width": 64},
}


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny():
    return TINY


_RUNS = {}


@pytest.fixture(scope="session")
def tiny_run(bench):
    """One CPU run of a cell at tiny widths (a 1 s window), cached by (cell, traced)."""
    import torch

    from benchmark.harness import core

    def run(cell: str, traced: bool = False) -> dict:
        if (cell, traced) not in _RUNS:
            _RUNS[cell, traced] = core.run(bench, cell, 12345, 1.0, traced, torch.device("cpu"), overrides=TINY)
        return _RUNS[cell, traced]

    return run
