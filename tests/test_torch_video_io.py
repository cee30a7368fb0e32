"""The port's video files against the JAX package's, on the CPU with
OpenCV: ``frames_to_video`` (mp4v, frames in name order) decoded back,
``video_to_frames``, ``get_fps`` and ``get_frame_count`` on the repo's
clips, ``blend_video(..., output=...)`` writing an mp4, and the CLI handing
``output``, ``fps`` and ``n_proc`` to ``blend_video`` as
``fresco_tpu/cli.py`` does.  Both packages call the same OpenCV, so the
probes and the decoded frames are compared for equality."""
import glob
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from fresco_torch import cli
from fresco_torch.propagate import video_blend as tvb
from fresco_torch.propagate.patchmatch import PatchMatchConfig
from fresco_tpu.propagate import video_blend as jvb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = sorted(glob.glob(os.path.join(REPO, "data", "*.mp4")))


def _frames(n=5, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _decode(path):
    cap = cv2.VideoCapture(path)
    fps, out = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    cap.release()
    return fps, out


def test_frames_to_video_matches_jax(tmp_path):
    frames = _frames()
    os.makedirs(tmp_path / "frames")
    # written out of order: both packages encode in name order
    for i in (3, 0, 4, 1, 2):
        cv2.imwrite(str(tmp_path / "frames" / ("%04d.png" % i)), frames[i])
    tvb.frames_to_video(str(tmp_path / "frames"), str(tmp_path / "port.mp4"), 12)
    jvb.frames_to_video(str(tmp_path / "frames"), str(tmp_path / "jax.mp4"), 12)
    fps_t, got_t = _decode(str(tmp_path / "port.mp4"))
    fps_j, got_j = _decode(str(tmp_path / "jax.mp4"))
    assert fps_t == fps_j == 12
    assert len(got_t) == len(got_j) == 5
    assert all(a.shape == b.shape == (48, 64, 3) for a, b in zip(got_t, got_j))
    assert all(np.array_equal(a, b) for a, b in zip(got_t, got_j))
    assert tvb.get_frame_count(str(tmp_path / "port.mp4")) == 5
    # decoded back to numbered frames, the same files in both packages
    n_t = tvb.video_to_frames(str(tmp_path / "port.mp4"), str(tmp_path / "dec_t"))
    n_j = jvb.video_to_frames(str(tmp_path / "port.mp4"), str(tmp_path / "dec_j"))
    assert n_t == n_j == 5
    assert sorted(os.listdir(tmp_path / "dec_t")) == sorted(os.listdir(tmp_path / "dec_j"))
    for f in os.listdir(tmp_path / "dec_t"):
        assert np.array_equal(cv2.imread(str(tmp_path / "dec_t" / f)), cv2.imread(str(tmp_path / "dec_j" / f)))


def test_frames_to_video_empty_dir_writes_nothing(tmp_path):
    tvb.frames_to_video(str(tmp_path), str(tmp_path / "out.mp4"), 30)
    assert not os.path.exists(tmp_path / "out.mp4")


@pytest.mark.parametrize("clip", [os.path.basename(p) for p in CLIPS])
def test_video_probes_match_jax(clip):
    path = os.path.join(REPO, "data", clip)
    assert tvb.get_fps(path) == jvb.get_fps(path) > 0
    assert tvb.get_frame_count(path) == jvb.get_frame_count(path) > 0


def test_video_helpers_name_opencv_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    for call in (lambda: tvb.get_fps("x.mp4"), lambda: tvb.get_frame_count("x.mp4"),
                 lambda: tvb.video_to_frames("x.mp4", str(tmp_path)),
                 lambda: tvb.frames_to_video(str(tmp_path), str(tmp_path / "o.mp4"), 30)):
        with pytest.raises(ImportError, match="cv2"):
            call()


def test_blend_video_writes_mp4(tmp_path):
    """Three static frames, keys at both ends: blend/ holds three PNGs and
    blend.mp4 three frames at the fps given."""
    pytest.importorskip("PIL")
    frames = _frames(3, seed=1)[:1] * 3
    key = np.ascontiguousarray(255 - frames[0])
    os.makedirs(tmp_path / "video")
    os.makedirs(tmp_path / "keys")
    for i, f in enumerate(frames):
        tvb.write_bgr(str(tmp_path / "video" / ("%04d.png" % i)), f)
    for i in (0, 2):
        tvb.write_bgr(str(tmp_path / "keys" / ("%04d.png" % i)), key)
    out = str(tmp_path / "blend.mp4")
    blend_dir = tvb.blend_video(str(tmp_path), [0, 2], output=out, fps=8, n_proc=3,
                                flow_fn=lambda a, b: torch.zeros(2 * a.shape[0], *a.shape[1:3], 2),
                                patch_cfg=PatchMatchConfig(pm_iters=1, sv_iters=1), device="cpu")
    assert sorted(os.listdir(blend_dir)) == ["0000.png", "0001.png", "0002.png"]
    fps, got = _decode(out)
    assert fps == 8 and len(got) == 3 and got[0].shape == (48, 64, 3)


def test_run_config_writes_blend_mp4_at_the_input_fps(tmp_path, monkeypatch):
    """As fresco_tpu/cli.py:63-72: output save_path/blend.mp4, the input's
    frame rate as the JAX CLI reads it (``get_fps(...) or 30``), n_proc =
    max_process."""
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

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

    seen = []
    monkeypatch.setattr(runner, "FrescoPipeline", StubPipeline)
    monkeypatch.setattr(tvb, "blend_video", lambda save_path, **kw: seen.append(kw) or str(tmp_path))
    music = os.path.join(REPO, "data", "music.mp4")
    for file_path in (music, str(tmp_path / "missing.mp4")):
        cfg = FrescoConfig(file_path=file_path, save_path=str(tmp_path) + "/", run_ebsynth=True, max_process=3)
        cli.run_config(cfg)
        assert seen[-1]["output"] == os.path.join(str(tmp_path) + "/", "blend.mp4")
        assert seen[-1]["fps"] == (jvb.get_fps(file_path) or 30) and seen[-1]["n_proc"] == 3
    assert seen[0]["fps"] == jvb.get_fps(music) > 0
