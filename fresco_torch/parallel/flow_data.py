"""Optical-flow dataset pipeline for GMFlow training and evaluation.

The port's own copy of ``fresco_tpu/parallel/flow_data.py`` (which
rebuilds the reference's gmflow data/datasets.py, data/transforms.py and
utils/frame_utils.py in numpy): the file-format readers (.flo
Middlebury, .pfm, KITTI 16-bit png), the dataset index builders
(FlyingChairs / Sintel / FlyingThings3D / KITTI / a frame directory), a
numpy augmentor with the reference's crop / scale / flip / colour /
eraser semantics and the same numpy draws for the same seed, and a
loader whose background thread assembles the next batch while the device
runs the current step.  The loader yields tensors on a given device (the
card unless the caller passes the CPU).  KITTI pngs and the resizes need
OpenCV (``cv2``), imported at call time.
"""
from __future__ import annotations

import glob
import os
import queue
import re
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

TAG_FLO = 202021.25


# --------------------------------------------------------------------------
# file formats (frame_utils.py:10-115)
# --------------------------------------------------------------------------
def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32 (dx, dy)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(TAG_FLO):
            raise ValueError(f"{path}: not a .flo file")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * h * w)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(TAG_FLO).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """PFM (FlyingThings3D flow) -> [H, W] or [H, W, 3] float32."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        m = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("OpenCV (cv2) is needed for KITTI flow pngs and the augmentor's resizes") from e
    return cv2


def read_kitti_flow(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png -> (flow [H,W,2], valid [H,W]); u,v = (raw-2^15)/64
    (frame_utils.py:102-107)."""
    cv2 = _cv2()

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> (u, v, valid)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2**15) / 64.0, valid


def write_kitti_flow(path: str, flow: np.ndarray) -> None:
    cv2 = _cv2()

    uv = 64.0 * np.asarray(flow, np.float64) + 2**15
    valid = np.ones(uv.shape[:2] + (1,))
    cv2.imwrite(path, np.concatenate([uv, valid], -1).astype(np.uint16)[..., ::-1])


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), np.uint8)[..., :3]


def read_flow_gen(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Any-format flow read -> (flow, valid-or-None)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path), None
    if ext == ".pfm":
        return read_pfm(path)[..., :2], None
    if ext == ".png":
        return read_kitti_flow(path)
    raise ValueError(f"unknown flow format: {path}")


# --------------------------------------------------------------------------
# dataset indices (datasets.py:129-268)
# --------------------------------------------------------------------------
@dataclass
class FlowIndex:
    """A flat list of (img1, img2, flow, sparse) sample paths."""

    image_pairs: list[tuple[str, str]] = field(default_factory=list)
    flows: list[str | None] = field(default_factory=list)
    sparse: bool = False

    def __len__(self):
        return len(self.image_pairs)

    def load(self, i: int):
        p1, p2 = self.image_pairs[i]
        img1, img2 = read_image(p1), read_image(p2)
        flow = valid = None
        if self.flows[i] is not None:
            flow, valid = read_flow_gen(self.flows[i])
        return img1, img2, flow, valid


def index_flying_chairs(root: str, split: str = "train",
                        split_file: str | None = None) -> FlowIndex:
    """FlyingChairs_release/data + chairs_split.txt (1=train, 2=val);
    datasets.py:161-178."""
    images = sorted(glob.glob(os.path.join(root, "data", "*.ppm")))
    flows = sorted(glob.glob(os.path.join(root, "data", "*.flo")))
    assert len(images) // 2 == len(flows), "chairs: image/flow count mismatch"
    split_file = split_file or os.path.join(root, "chairs_split.txt")
    tags = np.loadtxt(split_file, dtype=np.int32)
    want = 1 if split == "train" else 2
    idx = FlowIndex()
    for i, flo in enumerate(flows):
        if tags[i] == want:
            idx.image_pairs.append((images[2 * i], images[2 * i + 1]))
            idx.flows.append(flo)
    return idx


def index_sintel(root: str, split: str = "training",
                 dstype: str = "clean") -> FlowIndex:
    """MPI-Sintel scene-wise consecutive pairs (datasets.py:129-158)."""
    image_root = os.path.join(root, split, dstype)
    flow_root = os.path.join(root, split, "flow")
    idx = FlowIndex()
    for scene in sorted(os.listdir(image_root)) if os.path.isdir(image_root) else []:
        frames = sorted(glob.glob(os.path.join(image_root, scene, "*.png")))
        for i in range(len(frames) - 1):
            idx.image_pairs.append((frames[i], frames[i + 1]))
            if split == "training":
                idx.flows.append(
                    os.path.join(flow_root, scene, f"frame_{i+1:04d}.flo")
                )
            else:
                idx.flows.append(None)
    return idx


def index_flying_things(root: str, dstype: str = "frames_cleanpass") -> FlowIndex:
    """FlyingThings3D TRAIN split, both directions (datasets.py:180-228)."""
    idx = FlowIndex()
    for cam in ["left"]:
        for direction in ["into_future", "into_past"]:
            image_dirs = sorted(glob.glob(os.path.join(root, dstype, "TRAIN/*/*")))
            image_dirs = [os.path.join(d, cam) for d in image_dirs]
            flow_dirs = sorted(
                glob.glob(os.path.join(root, "optical_flow", "TRAIN/*/*"))
            )
            flow_dirs = [os.path.join(d, direction, cam) for d in flow_dirs]
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob.glob(os.path.join(idir, "*.png")))
                flows = sorted(glob.glob(os.path.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        idx.image_pairs.append((images[i], images[i + 1]))
                        idx.flows.append(flows[i])
                    else:
                        idx.image_pairs.append((images[i + 1], images[i]))
                        idx.flows.append(flows[i + 1])
    return idx


def index_kitti(root: str, split: str = "training") -> FlowIndex:
    """KITTI-2015 sparse-GT pairs (datasets.py:230-250)."""
    root = os.path.join(root, split)
    images1 = sorted(glob.glob(os.path.join(root, "image_2", "*_10.png")))
    images2 = sorted(glob.glob(os.path.join(root, "image_2", "*_11.png")))
    idx = FlowIndex(sparse=True)
    for p1, p2 in zip(images1, images2):
        idx.image_pairs.append((p1, p2))
        idx.flows.append(
            os.path.join(root, "flow_occ", os.path.basename(p1))
            if split == "training" else None
        )
    return idx


def index_frame_dir(path: str, stride: int = 1) -> FlowIndex:
    """Unlabelled consecutive frames (for unsupervised video adaptation)."""
    frames = sorted(
        glob.glob(os.path.join(path, "*.png")) + glob.glob(os.path.join(path, "*.jpg"))
    )
    idx = FlowIndex()
    for i in range(len(frames) - stride):
        idx.image_pairs.append((frames[i], frames[i + stride]))
        idx.flows.append(None)
    return idx


# --------------------------------------------------------------------------
# augmentation (transforms.py FlowAugmentor/SparseFlowAugmentor semantics)
# --------------------------------------------------------------------------
@dataclass
class AugmentConfig:
    crop_size: tuple[int, int] = (384, 512)
    min_scale: float = -0.2
    max_scale: float = 0.5
    spatial_aug_prob: float = 0.8
    do_flip: bool = True
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    brightness: float = 0.4
    eraser_prob: float = 0.5
    eraser_bounds: tuple[int, int] = (50, 100)


class FlowAugmentor:
    """numpy re-implementation of the reference augmentor: photometric
    jitter (asymmetric-free simplified), eraser, random scale (bilinear,
    flow scaled), flips, random crop (transforms.py:7-150).  ``sparse``
    uses nearest-valid flow resampling (transforms.py:198-230)."""

    def __init__(self, cfg: AugmentConfig, sparse: bool = False, seed: int = 0):
        self.cfg = cfg
        self.sparse = sparse
        self.rng = np.random.default_rng(seed)

    def _color(self, img1, img2):
        c = self.cfg
        out = []
        for im in (img1, img2):
            im = im.astype(np.float32)
            im = im * self.rng.uniform(1 - c.brightness, 1 + c.brightness)
            mean = im.mean(axis=(0, 1), keepdims=True)
            im = (im - mean) * self.rng.uniform(0.6, 1.4) + mean  # contrast/sat
            out.append(np.clip(im, 0, 255))
        return out

    def _eraser(self, img1, img2):
        c = self.cfg
        h, w = img1.shape[:2]
        if self.rng.random() < c.eraser_prob:
            mean = img2.reshape(-1, 3).mean(0)
            for _ in range(self.rng.integers(1, 3)):
                x0 = int(self.rng.integers(0, w))
                y0 = int(self.rng.integers(0, h))
                dx = int(self.rng.integers(c.eraser_bounds[0], c.eraser_bounds[1]))
                dy = int(self.rng.integers(c.eraser_bounds[0], c.eraser_bounds[1]))
                img2[y0:y0 + dy, x0:x0 + dx] = mean
        return img1, img2

    def _resize(self, img, scale, nearest=False):
        cv2 = _cv2()

        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(img, None, fx=scale, fy=scale, interpolation=interp)

    def __call__(self, img1, img2, flow, valid=None):
        c = self.cfg
        img1, img2 = self._color(img1, img2)
        img1, img2 = self._eraser(img1, img2)

        h, w = img1.shape[:2]
        min_scale = max(
            (c.crop_size[0] + 8) / float(h), (c.crop_size[1] + 8) / float(w)
        )
        scale = 2.0 ** self.rng.uniform(c.min_scale, c.max_scale)
        scale = max(scale, min_scale)
        if self.rng.random() < c.spatial_aug_prob:
            img1 = self._resize(img1, scale)
            img2 = self._resize(img2, scale)
            if flow is not None:
                if self.sparse:
                    flow, valid = self._resize_sparse(flow, valid, scale)
                else:
                    flow = self._resize(flow, scale) * scale

        if c.do_flip and flow is not None:
            if self.rng.random() < c.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
                if valid is not None:
                    valid = valid[:, ::-1]
            if not self.sparse and self.rng.random() < c.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        h, w = img1.shape[:2]
        y0 = int(self.rng.integers(0, max(h - c.crop_size[0], 0) + 1))
        x0 = int(self.rng.integers(0, max(w - c.crop_size[1], 0) + 1))
        sl = np.s_[y0:y0 + c.crop_size[0], x0:x0 + c.crop_size[1]]
        img1, img2 = np.ascontiguousarray(img1[sl]), np.ascontiguousarray(img2[sl])
        if flow is not None:
            flow = np.ascontiguousarray(flow[sl])
        if valid is not None:
            valid = np.ascontiguousarray(valid[sl])
        elif flow is not None:
            valid = ((np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000))
            valid = valid.astype(np.float32)
        return img1.astype(np.float32), img2.astype(np.float32), flow, valid

    def _resize_sparse(self, flow, valid, scale):
        """Nearest-valid sparse-flow resampling (transforms.py:198-230)."""
        h, w = flow.shape[:2]
        coords = np.stack(
            np.meshgrid(np.arange(w), np.arange(h)), axis=-1
        ).reshape(-1, 2).astype(np.float32)
        flow_f = flow.reshape(-1, 2)
        valid_f = valid.reshape(-1) >= 1
        coords, flow_f = coords[valid_f], flow_f[valid_f]
        h1, w1 = int(round(h * scale)), int(round(w * scale))
        co = coords * scale
        fl = flow_f * scale
        xx = np.round(co[:, 0]).astype(np.int32)
        yy = np.round(co[:, 1]).astype(np.int32)
        ok = (xx >= 0) & (xx < w1) & (yy >= 0) & (yy < h1)
        flow_img = np.zeros((h1, w1, 2), np.float32)
        valid_img = np.zeros((h1, w1), np.float32)
        flow_img[yy[ok], xx[ok]] = fl[ok]
        valid_img[yy[ok], xx[ok]] = 1.0
        return flow_img, valid_img


# --------------------------------------------------------------------------
# device loader
# --------------------------------------------------------------------------
class FlowLoader:
    """Background-thread batch producer (the reference's DataLoader +
    DistributedSampler, main.py:160-186, on one device): one host thread
    assembles numpy batches (augmented, NHWC float32) while the device runs
    the current step; each batch arrives as tensors on ``device`` (the card
    unless the caller passes the CPU).  An error in the thread is raised on
    the caller's.  ``mesh`` (a ``core.comm.Mesh``): every rank assembles
    the same global batch and keeps its ``data`` slice of it, as the JAX
    loader's ``frame_sharding`` placement does (``_place``); the batch size
    must divide by ``data``."""

    def __init__(self, index: FlowIndex, batch_size: int,
                 augment: FlowAugmentor | None = None, mesh=None,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = True, device=None):
        from fresco_torch.core.comm import Mesh
        from fresco_torch.pipeline.runner import resolve_device

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"FlowLoader(mesh=...): expected a core.comm.Mesh (parallel.sharding.make_mesh), "
                            f"got {type(mesh).__name__}")
        if mesh is not None and batch_size % mesh.data:
            raise ValueError(f"FlowLoader: batch size {batch_size} does not split over data={mesh.data}")
        self.mesh = mesh

        self.index = index
        self.batch_size = batch_size
        self.augment = augment
        self.device = resolve_device(device)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def _assemble(self, ids):
        b1, b2, bf, bv = [], [], [], []
        for i in ids:
            img1, img2, flow, valid = self.index.load(int(i))
            if self.augment is not None:
                img1, img2, flow, valid = self.augment(img1, img2, flow, valid)
            b1.append(np.asarray(img1, np.float32))
            b2.append(np.asarray(img2, np.float32))
            if flow is not None:
                bf.append(np.asarray(flow, np.float32))
                bv.append(np.asarray(
                    valid if valid is not None else np.ones(flow.shape[:2]),
                    np.float32,
                ))
        out = {"img0": np.stack(b1), "img1": np.stack(b2)}
        if bf:
            out["flow"] = np.stack(bf)
            out["valid"] = np.stack(bv)
        return out

    def _place(self, batch):
        if self.mesh is not None and self.mesh.data > 1:
            sl = self.mesh.frame_slice(self.batch_size)
            batch = {k: v[sl] for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in batch.items()}

    def __iter__(self):
        order = np.arange(len(self.index))
        if self.shuffle:
            self.rng.shuffle(order)
        n = len(order) - (len(order) % self.batch_size if self.drop_last else 0)
        chunks = [
            order[i:i + self.batch_size] for i in range(0, n, self.batch_size)
        ]
        if not chunks:
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for ids in chunks:
                    if not put(("ok", self._assemble(ids))):
                        return
            except Exception as e:  # surface loader errors on the main thread
                put(("err", e))
                return
            put(("done", None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise item
                yield self._place(item)
        finally:  # also when the caller stops early: the thread ends, nothing is left running
            stop.set()
            t.join()
