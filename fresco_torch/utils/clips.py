"""The bundled demo clips and a frame reader for tools.

Counterpart of ``fresco_tpu/utils/clips.py``: ``bundled_clip`` names a
clip under the repo's ``data/`` and ``read_frames`` decodes the first
frames of a clip with OpenCV.  ``read_frames`` returns None where the clip
cannot be read; its callers decide what that means.  On the main path
(``chip_smoke.py``'s WebUI phase) it means failure: nothing there stands
in synthetic frames for a clip that did not decode.
"""
from __future__ import annotations

from pathlib import Path

#: the repo root (this file is fresco_torch/utils/clips.py)
_REPO_ROOT = Path(__file__).resolve().parents[2]


def bundled_clip(name: str) -> str:
    """The path of ``data/<name>`` in this repo, where the four demo clips
    of the reference ship.  The JAX function falls back to a reference
    checkout outside the repo when the file is absent; the port reads
    nothing outside its checkout, so it returns the repo path all the same
    and ``read_frames`` gives None for it."""
    return str(_REPO_ROOT / "data" / name)


def read_frames(path: str, count: int, stride: int = 1) -> list | None:
    """Up to ``count`` RGB uint8 frames [H, W, 3], one every ``stride``
    frames from the first.  None where OpenCV is missing, the clip cannot
    be opened or it yields no frame; fewer than ``count`` on a short clip."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    frames: list = []
    i = 0
    while len(frames) < count:
        ok, f = cap.read()
        if not ok:
            break
        if i % stride == 0:
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    return frames or None
