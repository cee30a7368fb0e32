"""Keyframe selection by maximal inter-frame motion.

Counterpart of ``fresco_tpu/pipeline/keyframes.py`` (reference
src/keyframe_selection.py:20-60): keyframes are inserted greedily at the
frame of largest MSE between consecutive blurred, resized frames, at
least ``mininterv`` apart, until no interval exceeds ``maxinterv``.  The
resize and blur are ``ops/image.py``'s (OpenCV's arithmetic, no OpenCV);
only reading a video file needs ``cv2``.
"""
from __future__ import annotations

import numpy as np

from fresco_torch.ops.image import gaussian_blur9, resize_image


def _max_interval(keys: list[int]) -> int:
    return max((b - a for a, b in zip(keys, keys[1:])), default=1)


def select_keyframes_from_errors(err: np.ndarray, mininterv: int, maxinterv: int) -> list[int]:
    """Greedy insertion given err[i] = motion error between frames i-1 and
    i (err[0] == 0); the argmax breaks ties to the lowest index
    (keyframe_selection.py:43-53)."""
    err = np.asarray(err, dtype=np.float64).copy()
    n_frames = len(err)
    keys = [0, n_frames - 1]
    err[0:mininterv] = -1
    err[len(err) - mininterv :] = -1
    while _max_interval(keys) > maxinterv:
        ind = int(np.argmax(err))
        if err[ind] == -1:
            break
        err[max(ind - mininterv, 0) : ind + mininterv] = -1
        for i, k in enumerate(keys):
            if ind < k:
                keys.insert(i, ind)
                break
    return keys


def frame_motion_errors(frames, resolution: int = 512) -> np.ndarray:
    """MSE (float64) between consecutive blurred, resized frames mapped to
    [-1, 1]; uint8 RGB [H, W, 3] frames in."""
    err = [0.0]
    prev = None
    for f in frames:
        cur = gaussian_blur9(resize_image(f, resolution)).astype(np.float64) / 255.0 * 2.0 - 1.0
        if prev is not None:
            err.append(float(np.mean((cur - prev) ** 2)))
        prev = cur
    return np.asarray(err)


def read_video_rgb(video_path: str, max_frames: int = int(1e10)) -> list[np.ndarray]:
    """Decode up to ``max_frames`` frames of a video file to uint8 RGB
    (needs OpenCV; the in-memory entry points take frames instead)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {video_path!r} needs OpenCV (cv2), which is not importable here; "
                          "decode the frames elsewhere and pass them in memory") from e
    cap = cv2.VideoCapture(video_path)
    n = max(1, min(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), max_frames))
    frames = []
    for _ in range(n):
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def select_keyframes_from_frames(frames, mininterv: int = 5, maxinterv: int = 20) -> list[int]:
    """Keyframe indices of in-memory uint8 RGB frames."""
    if maxinterv == mininterv:
        return list(range(0, len(frames), mininterv))
    return select_keyframes_from_errors(frame_motion_errors(frames), mininterv, maxinterv)


def select_keyframes(video_path: str, lastframen: int = int(1e10), mininterv: int = 5,
                     maxinterv: int = 20) -> list[int]:
    """Keyframe indices of a video file (keyframe_selection.py:20-60)."""
    if maxinterv == mininterv:
        return list(range(0, lastframen, mininterv))
    return select_keyframes_from_frames(read_video_rgb(video_path, lastframen), mininterv, maxinterv)
