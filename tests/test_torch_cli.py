"""The port's CLI end to end on the CPU: ``--tiny --device cpu`` on the
first 12 frames of data/music.mp4 resized to 64 px, with propagation on.
It must write the input frames, the keyframes, the blended frames,
phases.json and metrics.json, with finite metrics."""
import json
import os

import numpy as np
import yaml

from fresco_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_tiny_end_to_end(tmp_path):
    out = tmp_path / "out"
    cfg = dict(file_path=os.path.join(REPO, "data", "music.mp4"), save_path=str(out) + "/", frame_count=12,
               resolution=64, mininterv=2, maxinterv=4, batch_size=4, num_inference_steps=4, num_warmup_steps=1,
               end_opt_step=3, opt_iters=1, dtype="float32", gram_dtype="float32", run_ebsynth=True,
               prompt="a woman", gmflow_path=str(tmp_path / "none.pth"), sod_path=str(tmp_path / "none.pth"))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    cli.main([str(path), "--tiny", "--device", "cpu"])
    video = sorted(os.listdir(out / "video"))
    keys = sorted(os.listdir(out / "keys"))
    blend = sorted(os.listdir(out / "blend"))
    assert video == [f"{i:04d}.png" for i in range(12)]
    assert keys[0] == "0000.png" and keys[-1] == "0011.png" and len(keys) >= 3
    assert blend == video
    phases = json.loads((out / "phases.json").read_text())
    assert phases["keyframes"]["denoise_loop"] > 0 and phases["propagation"]["wall_total"] > 0
    metrics = json.loads((out / "metrics.json").read_text())
    for part in ("translated", "input"):
        assert np.isfinite(metrics[part]["warp_error"]) and np.isfinite(metrics[part]["frame_similarity"])
        assert metrics[part]["frame_similarity_is_clip"] is False
