"""Frame preparation and keyframe selection, the port against OpenCV and
fresco_tpu on the CPU.

``gaussian_blur9`` and ``resize_image`` (LANCZOS4 upscaling, AREA
downscaling at integer and fractional scales) are OpenCV's uint8
arithmetic rebuilt in torch: they must equal ``cv2`` bit for bit.  The
keyframes of the first 60 frames of data/music.mp4 (640x512, kept at its
size) and data/car-turn.mp4 (480x480, upscaled to 512) are decoded here
with ``cv2`` and must equal fresco_tpu's, and so must the motion errors
(float64 MSE of the same uint8 images: 1e-12 relative).
"""
import os

import cv2
import numpy as np
import pytest

from fresco_torch.ops import image as timage
from fresco_torch.pipeline import keyframes as tkeys
from fresco_tpu.pipeline import keyframes as jkeys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("shape", [(512, 640, 3), (37, 53, 3), (480, 480, 3), (64, 64)])
def test_gaussian_blur9_equals_cv2(shape):
    img = _rand(shape)
    np.testing.assert_array_equal(timage.gaussian_blur9(img), cv2.GaussianBlur(img, (9, 9), 0.0))


@pytest.mark.parametrize("shape", [(480, 480, 3), (300, 451, 3), (1024, 1280, 3), (1536, 1920, 3),
                                   (2048, 2560, 3), (720, 1280, 3), (512, 640, 3)])
def test_resize_image_equals_cv2(shape):
    img = _rand(shape, 1)
    h2, w2 = timage.resolution_to_64(*shape[:2])
    interp = cv2.INTER_LANCZOS4 if 512 / min(shape[:2]) > 1 else cv2.INTER_AREA
    np.testing.assert_array_equal(timage.resize_image(img), cv2.resize(img, (w2, h2), interpolation=interp))


def _first_frames(name, n=60):
    cap = cv2.VideoCapture(os.path.join(REPO, "data", name))
    frames = []
    for _ in range(n):
        ok, f = cap.read()
        assert ok
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


@pytest.mark.parametrize("name,mininterv,maxinterv", [("music.mp4", 10, 30), ("car-turn.mp4", 3, 8)])
def test_keyframes_equal_jax(name, mininterv, maxinterv):
    frames = _first_frames(name)
    terr = tkeys.frame_motion_errors(frames)
    jerr = jkeys.frame_motion_errors(frames)
    np.testing.assert_allclose(terr, jerr, rtol=1e-12, atol=0)
    tk = tkeys.select_keyframes_from_errors(terr, mininterv, maxinterv)
    assert tk == jkeys.select_keyframes_from_errors(jerr, mininterv, maxinterv)
    assert len(tk) > 2


def test_select_keyframes_ties_and_bounds():
    err = np.array([0, 1, 5, 5, 2, 5, 1, 0, 3, 3, 0], float)
    assert tkeys.select_keyframes_from_errors(err, 2, 3) == jkeys.select_keyframes_from_errors(err, 2, 3)
    assert tkeys.select_keyframes(os.path.join(REPO, "data", "car-turn.mp4"), 20, 5, 5) == [0, 5, 10, 15]
