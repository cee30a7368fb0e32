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


def test_cli_always_fuses_with_poisson(tmp_path, monkeypatch):
    """The reference CLI hands blend_video poisson=True whatever the
    config's use_poisson says (fresco_tpu/cli.py:72); so does the port."""
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner
    from fresco_torch.propagate import video_blend

    class StubPipeline:
        def __init__(self, config, tiny=False, device=None):
            self.device = "cpu"
            self.phases = runner.PhaseTimes()

        def translate_keyframe_files(self, reuse=False):
            return [0, 4]

        def consistency_flow_fn(self):
            return None

        def evaluate_consistency(self, frame_dir):
            return {}

    seen = {}

    def stub_blend_video(save_path, **kw):
        seen.update(kw)
        return str(tmp_path)

    monkeypatch.setattr(runner, "FrescoPipeline", StubPipeline)
    monkeypatch.setattr(video_blend, "blend_video", stub_blend_video)
    cfg = FrescoConfig(save_path=str(tmp_path) + "/", run_ebsynth=True, use_poisson=False)
    cli.run_config(cfg)
    assert seen["poisson"] is True


def test_keyframe_pngs_written_batch_by_batch(tmp_path, monkeypatch):
    """translate_keyframe_files writes each batch's keyframes as soon as
    the batch is decoded (fresco_tpu/pipeline/runner.py does the same):
    batch 1's PNGs are on disk when batch 2's prep begins."""
    import torch

    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

    frames = [np.full((16, 16, 3), i, np.uint8) for i in range(16)]
    keys = [0, 3, 6, 9, 12, 15]
    monkeypatch.setattr(runner, "read_video_rgb", lambda path, n: frames)
    monkeypatch.setattr(runner, "select_keyframes_from_frames", lambda f, lo, hi: keys)
    monkeypatch.setattr(runner, "resize_image", lambda f, res: f)
    cfg = FrescoConfig(save_path=str(tmp_path) + "/", batch_size=4, resolution=16)
    pipe = runner.FrescoPipeline.__new__(runner.FrescoPipeline)
    pipe.config, pipe.device, pipe.phases = cfg, torch.device("cpu"), runner.PhaseTimes()
    on_disk_at_prep = []

    def prepare(imgs, prompts, negs, noise, generator=None):
        on_disk_at_prep.append(sorted(os.listdir(tmp_path / "keys")))
        return len(imgs)

    pipe._prepare_batch = prepare
    pipe._run_batch = lambda n, record, propagation, noise, generator=None: (torch.zeros(n), None)
    pipe.decode = lambda lat: np.stack([np.full((16, 16, 3), 200, np.uint8)] * lat.shape[0])
    assert pipe.translate_keyframe_files(verbose=False) == keys
    assert on_disk_at_prep == [[], ["0000.png", "0003.png", "0006.png"]]
    assert sorted(os.listdir(tmp_path / "keys")) == [f"{k:04d}.png" for k in keys]
