"""OpenPose body and hand pose networks, PyTorch/NHWC, and the body decode.

Counterpart of ``fresco_tpu/models/openpose.py`` (reference
src/ControlNet/annotator/openpose/: model.py bodypose_model /
handpose_model, body.py Body.__call__, util.py draw_bodypose): a VGG trunk
and six refinement stages of two branches run on the model's device and
return (PAF, heatmap) at 1/8 resolution; the peak finding, the limb
matching and the person assembly run on the host in numpy and scipy, the
same code as the JAX package's.  The detector's INTER_CUBIC resizes and
the drawing call OpenCV on the host, as the JAX package does; without
``cv2`` they raise an ImportError that names it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fresco_torch.models.layers import Conv2d

CHECKPOINT = "body_pose_model.pth"

# layer tables: (name, out channels, kernel, relu); pools are explicit markers
_POOL = ("pool", 0, 0, False)

_BODY_TRUNK = (
    ("conv1_1", 64, 3, True), ("conv1_2", 64, 3, True), _POOL,
    ("conv2_1", 128, 3, True), ("conv2_2", 128, 3, True), _POOL,
    ("conv3_1", 256, 3, True), ("conv3_2", 256, 3, True),
    ("conv3_3", 256, 3, True), ("conv3_4", 256, 3, True), _POOL,
    ("conv4_1", 512, 3, True), ("conv4_2", 512, 3, True),
    ("conv4_3_CPM", 256, 3, True), ("conv4_4_CPM", 128, 3, True),
)

_HAND_TRUNK = (
    ("conv1_1", 64, 3, True), ("conv1_2", 64, 3, True), _POOL,
    ("conv2_1", 128, 3, True), ("conv2_2", 128, 3, True), _POOL,
    ("conv3_1", 256, 3, True), ("conv3_2", 256, 3, True),
    ("conv3_3", 256, 3, True), ("conv3_4", 256, 3, True), _POOL,
    ("conv4_1", 512, 3, True), ("conv4_2", 512, 3, True),
    ("conv4_3", 512, 3, True), ("conv4_4", 512, 3, True),
    ("conv5_1", 512, 3, True), ("conv5_2", 512, 3, True),
    ("conv5_3_CPM", 128, 3, True),
)


def _stage1_body(branch: str, out: int):
    return (
        (f"conv5_1_CPM_{branch}", 128, 3, True),
        (f"conv5_2_CPM_{branch}", 128, 3, True),
        (f"conv5_3_CPM_{branch}", 128, 3, True),
        (f"conv5_4_CPM_{branch}", 512, 1, True),
        (f"conv5_5_CPM_{branch}", out, 1, False),
    )


def _stage_n_body(i: int, branch: str, out: int):
    # the reference's no-relu list names 'Mconv7_stage6_L1' twice instead
    # of '..._L2', so the stage-6 heatmap output is ReLU'd and every other
    # stage output is linear (model.py:29-32)
    relu_last = i == 6 and branch == "L2"
    return tuple((f"Mconv{j}_stage{i}_{branch}", 128, 7, True) for j in range(1, 6)) + (
        (f"Mconv6_stage{i}_{branch}", 128, 1, True),
        (f"Mconv7_stage{i}_{branch}", out, 1, relu_last),
    )


def _stage_n_hand(i: int):
    return tuple((f"Mconv{j}_stage{i}", 128, 7, True) for j in range(1, 6)) + (
        (f"Mconv6_stage{i}", 128, 1, True),
        (f"Mconv7_stage{i}", 22, 1, False),
    )


class _ConvStack(nn.Module):
    """A named sequence of convolutions and 2x2 max pools (make_layers)."""

    def __init__(self, cin: int, layers: tuple):
        super().__init__()
        self.layers = layers
        for name, out, k, _ in layers:
            if name != "pool":
                setattr(self, name, Conv2d(cin, out, k, 1, (k - 1) // 2))
                cin = out
        self.out_channels = cin

    def forward(self, x):
        for name, _, _, relu in self.layers:
            if name == "pool":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                continue
            x = getattr(self, name)(x)
            if relu:
                x = F.relu(x)
        return x


class BodyPose(nn.Module):
    """bodypose_model: [B, H, W, 3] (BGR / 256 - 0.5) -> (paf [B, h, w, 38],
    heatmap [B, h, w, 19]) at 1/8 resolution."""

    def __init__(self):
        super().__init__()
        self.model0 = _ConvStack(3, _BODY_TRUNK)
        feat = self.model0.out_channels
        self.model1_1 = _ConvStack(feat, _stage1_body("L1", 38))
        self.model1_2 = _ConvStack(feat, _stage1_body("L2", 19))
        for i in range(2, 7):
            setattr(self, f"model{i}_1", _ConvStack(38 + 19 + feat, _stage_n_body(i, "L1", 38)))
            setattr(self, f"model{i}_2", _ConvStack(38 + 19 + feat, _stage_n_body(i, "L2", 19)))

    @torch.no_grad()
    def forward(self, x):
        feat = self.model0(x)
        l1, l2 = self.model1_1(feat), self.model1_2(feat)
        for i in range(2, 7):
            h = torch.cat([l1, l2, feat], dim=-1)
            l1, l2 = getattr(self, f"model{i}_1")(h), getattr(self, f"model{i}_2")(h)
        return l1, l2


class HandPose(nn.Module):
    """handpose_model: heatmap [B, h, w, 22] at 1/8 resolution."""

    def __init__(self):
        super().__init__()
        self.model1_0 = _ConvStack(3, _HAND_TRUNK)
        feat = self.model1_0.out_channels
        self.model1_1 = _ConvStack(feat, (("conv6_1_CPM", 512, 1, True), ("conv6_2_CPM", 22, 1, False)))
        for i in range(2, 7):
            setattr(self, f"model{i}", _ConvStack(22 + feat, _stage_n_hand(i)))

    @torch.no_grad()
    def forward(self, x):
        feat = self.model1_0(x)
        out = self.model1_1(feat)
        for i in range(2, 7):
            out = getattr(self, f"model{i}")(torch.cat([out, feat], dim=-1))
        return out


def openpose_map(b) -> None:
    """``body_pose_model.pth`` / ``hand_pose_model.pth``: each convolution
    under the scope of its stack (``model0.conv1_1.weight``, the layout the
    JAX package's ``convert_openpose`` reads), or under its bare name, as
    the released files store it (the reference's ``util.transfer`` adds the
    scope when it loads them; every layer name is unique in a model)."""
    for key in sorted(b.own):
        scope, layer, leaf = key.split(".")
        if leaf != "weight":
            continue
        src = f"{scope}.{layer}"
        if b.ckpt is not None and f"{src}.weight" not in b.ckpt and f"{layer}.weight" in b.ckpt:
            src = layer
        b.raw_conv(f"{scope}/{layer}", src)


def convert_openpose(sd, hand: bool = False, strict: bool = False) -> dict[str, torch.Tensor]:
    """An OpenPose body (or, with ``hand``, hand) checkpoint -> the port's
    ``BodyPose`` / ``HandPose`` state dict."""
    from fresco_torch.models.convert import _meta_keys, convert

    return convert(sd, openpose_map, _meta_keys(HandPose if hand else BodyPose), strict)


# ------------------------------------------------------------ host decode
# COCO-18 limb sequence and PAF channel pairs (body.py:94-100)
_LIMB_SEQ = np.array(
    [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
     [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
     [1, 16], [16, 18], [3, 17], [6, 18]]) - 1
_PAF_IDX = np.array(
    [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
     [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
     [53, 54], [51, 52], [55, 56], [37, 38], [45, 46]]) - 19


def _find_peaks(heatmap: np.ndarray, thre: float) -> list[np.ndarray]:
    """Per part, the peaks [(x, y, score, id), ...] of the heatmap after a
    sigma-3 Gaussian (body.py:69-91)."""
    from scipy.ndimage import gaussian_filter

    all_peaks = []
    count = 0
    for part in range(18):
        m = heatmap[:, :, part]
        sm = gaussian_filter(m, sigma=3)
        pad = np.pad(sm, 1, constant_values=-np.inf)
        is_peak = (
            (sm >= pad[:-2, 1:-1]) & (sm >= pad[2:, 1:-1])
            & (sm >= pad[1:-1, :-2]) & (sm >= pad[1:-1, 2:]) & (sm > thre)
        )
        ys, xs = np.nonzero(is_peak)
        peaks = np.stack(
            [xs, ys, m[ys, xs], np.arange(count, count + len(xs))], axis=-1
        ) if len(xs) else np.zeros((0, 4))
        count += len(xs)
        all_peaks.append(peaks)
    return all_peaks


def _score_pairs(cand_a, cand_b, paf_xy, img_h, thre2, mid=10):
    """PAF line-integral scores of every A x B pair at once."""
    a = cand_a[:, None, :2]           # [na, 1, 2]
    b = cand_b[None, :, :2]           # [1, nb, 2]
    vec = b - a
    norm = np.maximum(np.linalg.norm(vec, axis=-1), 0.001)  # [na, nb]
    u = vec / norm[..., None]
    ts = np.linspace(0.0, 1.0, mid)[:, None, None, None]
    pts = np.round(a[None] + ts * vec[None]).astype(int)     # [mid, na, nb, 2]
    px = np.clip(pts[..., 0], 0, paf_xy.shape[1] - 1)
    py = np.clip(pts[..., 1], 0, paf_xy.shape[0] - 1)
    sampled = paf_xy[py, px]                                  # [mid, na, nb, 2]
    dots = sampled[..., 0] * u[None, ..., 0] + sampled[..., 1] * u[None, ..., 1]
    score = dots.mean(axis=0) + np.minimum(0.5 * img_h / norm - 1, 0)
    crit = ((dots > thre2).sum(axis=0) > 0.8 * mid) & (score > 0)
    return score, crit


def body_decode(heatmap: np.ndarray, paf: np.ndarray, img_h: int, thre1: float = 0.1, thre2: float = 0.05):
    """Peaks -> greedy limb matching -> person assembly (body.py:69-209).

    heatmap [H, W, 19] and paf [H, W, 38] at image resolution.  Returns
    (candidate [N, 4] = x, y, score, id; subset [P, 20])."""
    all_peaks = _find_peaks(heatmap, thre1)

    connection_all, special_k = [], []
    for k in range(len(_PAF_IDX)):
        cand_a = all_peaks[_LIMB_SEQ[k][0]]
        cand_b = all_peaks[_LIMB_SEQ[k][1]]
        if len(cand_a) == 0 or len(cand_b) == 0:
            special_k.append(k)
            connection_all.append(np.zeros((0, 5)))
            continue
        score, crit = _score_pairs(cand_a, cand_b, paf[:, :, _PAF_IDX[k]], img_h, thre2)
        ii, jj = np.nonzero(crit)
        order = np.argsort(-score[ii, jj])
        conn = []
        used_i, used_j = set(), set()
        for o in order:
            i, j = int(ii[o]), int(jj[o])
            if i in used_i or j in used_j:
                continue
            conn.append([cand_a[i, 3], cand_b[j, 3], score[i, j], i, j])
            used_i.add(i)
            used_j.add(j)
            if len(conn) >= min(len(cand_a), len(cand_b)):
                break
        connection_all.append(np.asarray(conn).reshape(-1, 5))

    candidate = (
        np.concatenate([p for p in all_peaks if len(p)], axis=0)
        if any(len(p) for p in all_peaks) else np.zeros((0, 4))
    )
    subset = -1 * np.ones((0, 20))
    for k in range(len(_PAF_IDX)):
        if k in special_k:
            continue
        ia, ib = _LIMB_SEQ[k]
        for pa, pb, sc, _, _ in connection_all[k]:
            found = [j for j in range(len(subset)) if subset[j][ia] == pa or subset[j][ib] == pb][:2]
            if len(found) == 1:
                j = found[0]
                if subset[j][ib] != pb:
                    subset[j][ib] = pb
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(pb), 2] + sc
            elif len(found) == 2:
                j1, j2 = found
                overlap = ((subset[j1][:-2] >= 0) & (subset[j2][:-2] >= 0)).sum()
                if overlap == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += sc
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][ib] = pb
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(pb), 2] + sc
            elif k < 17:
                row = -1 * np.ones(20)
                row[ia], row[ib] = pa, pb
                row[-1] = 2
                row[-2] = candidate[int(pa), 2] + candidate[int(pb), 2] + sc
                subset = np.vstack([subset, row])

    keep = [i for i in range(len(subset)) if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


_LIMB_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]


def _cv2():
    """OpenCV, imported at call time; an ImportError naming it where absent."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the OpenPose detector's resizes and drawing need OpenCV (cv2), which is not "
                          "importable here") from e
    return cv2


def draw_bodypose(canvas: np.ndarray, candidate, subset) -> np.ndarray:
    """util.py draw_bodypose: limb ellipses blended in, joint circles."""
    cv2 = _cv2()
    for k in range(17):
        for person in subset:
            idx = person[_LIMB_SEQ[k]]
            if -1 in idx:
                continue
            ys = candidate[idx.astype(int), 1]
            xs = candidate[idx.astype(int), 0]
            m_x, m_y = xs.mean(), ys.mean()
            length = ((xs[0] - xs[1]) ** 2 + (ys[0] - ys[1]) ** 2) ** 0.5
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            poly = cv2.ellipse2Poly((int(m_x), int(m_y)), (int(length / 2), 4), int(angle), 0, 360, 1)
            overlay = canvas.copy()
            cv2.fillConvexPoly(overlay, poly, _LIMB_COLORS[k])
            canvas = cv2.addWeighted(canvas, 0.4, overlay, 0.6, 0)
    for i in range(18):
        for person in subset:
            idx = int(person[i])
            if idx == -1:
                continue
            x, y = candidate[idx][0:2]
            cv2.circle(canvas, (int(x), int(y)), 4, _LIMB_COLORS[i % 18], -1)
    return canvas


def openpose_detector(model: BodyPose, img_rgb: np.ndarray, boxsize: int = 368, stride: int = 8,
                      scale_search=(0.5,)) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> the uint8 pose drawing [H, W, 3]
    (OpenposeDetector.__call__, body only; body.py:24-67): each scale's
    BGR image resized (INTER_CUBIC), edge-padded to the stride and run on
    the model's device, its maps resized back and averaged on the host,
    decoded and drawn."""
    cv2 = _cv2()
    dev = next(model.parameters()).device
    img = img_rgb[:, :, ::-1].copy()  # the reference works in BGR
    H, W = img.shape[:2]
    heat_avg = np.zeros((H, W, 19))
    paf_avg = np.zeros((H, W, 38))
    for s in scale_search:
        scale = s * boxsize / H
        resized = cv2.resize(img, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC)
        h0, w0 = resized.shape[:2]
        ph = (stride - h0 % stride) % stride
        pw = (stride - w0 % stride) % stride
        padded = np.pad(resized, ((0, ph), (0, pw), (0, 0)), mode="edge")
        x = torch.as_tensor(padded[None].astype(np.float32) / 256.0 - 0.5, device=dev)
        paf, heat = model(x)
        for out, acc in ((heat, heat_avg), (paf, paf_avg)):
            o = cv2.resize(out[0].float().cpu().numpy(), (0, 0), fx=stride, fy=stride,
                           interpolation=cv2.INTER_CUBIC)[:h0, :w0]
            acc += cv2.resize(o, (W, H), interpolation=cv2.INTER_CUBIC) / len(scale_search)
    candidate, subset = body_decode(heat_avg, paf_avg, H)
    return draw_bodypose(np.zeros_like(img), candidate, subset)
