"""``fresco_torch.utils.clips`` against ``fresco_tpu.utils.clips`` on the
bundled boxer clip: the same path, and the same frames bit for bit, with
and without ``stride``; None where the clip cannot be read or OpenCV is
missing."""
import sys

import numpy as np
import pytest

from fresco_torch.utils import clips
from fresco_tpu.utils import clips as jclips

BOXER = "boxer-punching-towards-camera.mp4"


def test_bundled_clip_matches_jax():
    assert clips.bundled_clip(BOXER) == jclips.bundled_clip(BOXER)


@pytest.mark.parametrize("count,stride", [(5, 1), (6, 3), (100, 1)])
def test_read_frames_matches_jax(count, stride):
    path = clips.bundled_clip(BOXER)
    got, want = clips.read_frames(path, count, stride), jclips.read_frames(path, count, stride)
    assert want is not None and len(got) == len(want) == min(count, 32 // stride + (32 % stride > 0))
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (480, 480, 3)
        np.testing.assert_array_equal(g, w)


def test_unreadable_clip_gives_none(tmp_path):
    bad = tmp_path / "not_a_video.mp4"
    bad.write_bytes(b"no frames here")
    for path in (str(bad), str(tmp_path / "missing.mp4")):
        assert clips.read_frames(path, 4) is None
        assert jclips.read_frames(path, 4) is None


def test_missing_cv2_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    assert clips.read_frames(clips.bundled_clip(BOXER), 4) is None
