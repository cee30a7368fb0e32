"""The port's flow data pipeline (``fresco_torch.parallel.flow_data``)
and GMFlow training driver against ``fresco_tpu``'s on the CPU.

Everything here is exact: the readers and writers, the index builders
and the augmentor are numpy (and OpenCV) code in both packages, so files
written by one read back bit for bit in the other, the same seed gives
the same crops, flips, colour and eraser draws, and the loader's batches
are equal arrays.  The driver (``--synthetic --tiny --device cpu``)
trains two steps, saves, and resumes from its checkpoint bit for bit.
"""
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fresco_torch.parallel import flow_data as td
from fresco_torch.scripts import train_gmflow as tdrv
from fresco_torch.utils.checkpoint import load_params
from fresco_tpu.parallel import flow_data as jd


def test_flo_pfm_kitti_readers_match_jax(tmp_path, rng):
    pytest.importorskip("cv2")  # KITTI pngs
    flow = (rng.standard_normal((13, 17, 2)) * 20).astype(np.float32)
    for writer, reader, tag in ((jd.write_flo, td.read_flo, "jt"), (td.write_flo, jd.read_flo, "tj")):
        p = str(tmp_path / f"{tag}.flo")
        writer(p, flow)
        np.testing.assert_array_equal(reader(p), flow)
    kflow = np.round(flow * 64) / 64
    for writer, reader, tag in ((jd.write_kitti_flow, td.read_kitti_flow, "jt"),
                                (td.write_kitti_flow, jd.read_kitti_flow, "tj")):
        p = str(tmp_path / f"{tag}.png")
        writer(p, kflow)
        got, valid = reader(p)
        ref, rvalid = (jd if reader is td.read_kitti_flow else td).read_kitti_flow(p)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(valid, rvalid)
        np.testing.assert_allclose(got, kflow, atol=1 / 64)
    for header, shape in ((b"Pf", (6, 10)), (b"PF", (6, 10, 3))):
        data = rng.standard_normal(shape).astype(np.float32)
        p = tmp_path / f"x{header.decode()}.pfm"
        with open(p, "wb") as f:
            f.write(header + b"\n10 6\n-1.0\n")
            np.flipud(data).astype("<f").tofile(f)
        np.testing.assert_array_equal(td.read_pfm(str(p)), jd.read_pfm(str(p)))
        np.testing.assert_array_equal(td.read_pfm(str(p)), data)
    for ext in (".flo", ".png", ".pfm"):
        p = str(tmp_path / ("jt.flo" if ext == ".flo" else "jt.png" if ext == ".png" else "xPF.pfm"))
        (a, av), (b, bv) = td.read_flow_gen(p), jd.read_flow_gen(p)
        np.testing.assert_array_equal(a, b)
        assert (av is None) == (bv is None)
    with pytest.raises(ValueError):
        td.read_flow_gen(str(tmp_path / "a.xyz"))
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        td.read_flo(str(tmp_path / "bad.flo"))


def _img(rng, path, hw=(8, 8), mode=None):
    Image.fromarray(rng.integers(0, 255, (*hw, 3)).astype(np.uint8)).save(path, format=mode)


def _same_index(a, b):
    assert a.image_pairs == b.image_pairs and a.flows == b.flows and a.sparse == b.sparse


def test_index_builders_match_jax(tmp_path, rng):
    # FlyingChairs: data/*.ppm + *.flo + chairs_split.txt
    ch = tmp_path / "chairs"
    (ch / "data").mkdir(parents=True)
    for i in range(1, 4):
        for k in (1, 2):
            _img(rng, ch / "data" / f"{i:05d}_img{k}.ppm", mode="PPM")
        jd.write_flo(str(ch / "data" / f"{i:05d}_flow.flo"), np.zeros((8, 8, 2), np.float32))
    np.savetxt(ch / "chairs_split.txt", [1, 2, 1], fmt="%d")
    for split in ("train", "val"):
        _same_index(td.index_flying_chairs(str(ch), split), jd.index_flying_chairs(str(ch), split))
    assert len(td.index_flying_chairs(str(ch), "train")) == 2
    # Sintel: training/{clean,flow}/<scene>/
    for scene in ("alley", "bamboo"):
        (tmp_path / "sintel/training/clean" / scene).mkdir(parents=True)
        for i in range(1, 4):
            _img(rng, tmp_path / "sintel/training/clean" / scene / f"frame_{i:04d}.png")
    _same_index(td.index_sintel(str(tmp_path / "sintel")), jd.index_sintel(str(tmp_path / "sintel")))
    assert len(td.index_sintel(str(tmp_path / "sintel"))) == 4
    # FlyingThings3D: frames_cleanpass/TRAIN/A/0000/left, optical_flow/TRAIN/A/0000/into_*/left
    ft = tmp_path / "things"
    (ft / "frames_cleanpass/TRAIN/A/0000/left").mkdir(parents=True)
    for i in range(3):
        _img(rng, ft / f"frames_cleanpass/TRAIN/A/0000/left/{i:04d}.png")
    for d in ("into_future", "into_past"):
        (ft / f"optical_flow/TRAIN/A/0000/{d}/left").mkdir(parents=True)
        for i in range(3):
            (ft / f"optical_flow/TRAIN/A/0000/{d}/left/{i:04d}.pfm").write_bytes(b"")
    _same_index(td.index_flying_things(str(ft)), jd.index_flying_things(str(ft)))
    assert len(td.index_flying_things(str(ft))) == 4
    # KITTI: training/image_2/*_10.png, *_11.png, flow_occ/
    (tmp_path / "kitti/training/image_2").mkdir(parents=True)
    for i in range(2):
        for f in (10, 11):
            _img(rng, tmp_path / f"kitti/training/image_2/{i:06d}_{f}.png")
    _same_index(td.index_kitti(str(tmp_path / "kitti")), jd.index_kitti(str(tmp_path / "kitti")))
    assert td.index_kitti(str(tmp_path / "kitti")).sparse
    # a frame directory, strides 1 and 2
    for stride in (1, 2):
        _same_index(td.index_frame_dir(str(tmp_path / "sintel/training/clean/alley"), stride),
                    jd.index_frame_dir(str(tmp_path / "sintel/training/clean/alley"), stride))


@pytest.mark.parametrize("sparse", [False, True])
def test_augmentor_draws_match_jax(rng, sparse):
    """The same seed gives the same colour, eraser, scale, flips and crop:
    several calls in a row, with the resize (cv2) taken."""
    pytest.importorskip("cv2")
    cfg = dict(crop_size=(32, 40), spatial_aug_prob=0.7, h_flip_prob=0.5, v_flip_prob=0.3, eraser_bounds=(4, 12))
    ours = td.FlowAugmentor(td.AugmentConfig(**cfg), sparse=sparse, seed=3)
    ref = jd.FlowAugmentor(jd.AugmentConfig(**cfg), sparse=sparse, seed=3)
    for _ in range(6):
        img1, img2 = (rng.integers(0, 255, (48, 60, 3)).astype(np.float32) for _ in range(2))
        flow = (rng.standard_normal((48, 60, 2)) * 3).astype(np.float32)
        valid = (rng.uniform(0, 1, (48, 60)) > 0.3).astype(np.float32) if sparse else None
        got = ours(img1.copy(), img2.copy(), flow.copy(), None if valid is None else valid.copy())
        want = ref(img1.copy(), img2.copy(), flow.copy(), None if valid is None else valid.copy())
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (32, 40, 3) and got[2].shape == (32, 40, 2) and got[3].shape == (32, 40)
    f2, v2 = ours._resize_sparse(np.full((20, 20, 2), 3.0, np.float32), np.eye(20, dtype=np.float32), 1.5)
    np.testing.assert_allclose(f2[v2 > 0], 4.5)


class _Index:
    sparse = False

    def __init__(self, n=5, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def load(self, i):
        if i == self.fail_at:
            raise OSError(f"sample {i} is unreadable")
        r = np.random.default_rng(i)
        return (r.uniform(0, 255, (8, 12, 3)).astype(np.float32), r.uniform(0, 255, (8, 12, 3)).astype(np.float32),
                r.standard_normal((8, 12, 2)).astype(np.float32), None)


def test_loader_batches_errors_and_thread(tmp_path):
    ours = list(td.FlowLoader(_Index(), 2, seed=4, device="cpu"))
    ref = list(jd.FlowLoader(_Index(), 2, seed=4))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"img0", "img1", "flow", "valid"}
        for k in a:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    assert len(list(td.FlowLoader(_Index(), 2, drop_last=False, device="cpu"))) == 3
    # an error in the thread is raised on the caller's
    with pytest.raises(OSError, match="unreadable"):
        list(td.FlowLoader(_Index(fail_at=3), 1, shuffle=False, device="cpu"))
    # stopping early ends the thread
    before = threading.active_count()
    for _ in td.FlowLoader(_Index(n=40), 1, prefetch=1, device="cpu"):
        break
    assert threading.active_count() == before
    with pytest.raises(TypeError, match="mesh"):  # a mesh must be a core.comm.Mesh
        td.FlowLoader(_Index(), 2, mesh=object(), device="cpu")
    # a frame directory: unsupervised batches, no flow
    for i in range(5):
        _img(np.random.default_rng(i), tmp_path / f"{i:04d}.png", hw=(16, 16))
    batches = list(td.FlowLoader(td.index_frame_dir(str(tmp_path)), 2, device="cpu"))
    assert len(batches) == 2 and batches[0]["img0"].shape == (2, 16, 16, 3) and "flow" not in batches[0]


def test_synthetic_index_draws_match_jax():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_gmflow", os.path.join(os.path.dirname(__file__), "..", "scripts", "train_gmflow.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    a, b = tdrv.SyntheticIndex(size=3, hw=(8, 12), seed=2), jmod.SyntheticIndex(size=3, hw=(8, 12), seed=2)
    for i in range(3):
        for x, y in zip(a.load(i), b.load(i)):
            np.testing.assert_array_equal(x, y)


def test_driver_trains_saves_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = tdrv.main(["--synthetic", "--tiny", "--steps", "2", "--batch-size", "2", "--log-every", "1",
                     "--ckpt-every", "1", "--ckpt-dir", ck, "--device", "cpu"])
    assert out["done"] == 2 and len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert sorted(os.listdir(ck)) == ["final", "step_1", "step_2"]
    saved = load_params(f"{ck}/final")
    for k, v in out["model"].state_dict().items():
        assert torch.equal(saved[k], v), k
    step1 = load_params(f"{ck}/step_1")
    assert any(not torch.equal(step1[k], saved[k]) for k in saved)  # the second step moved the weights
    res = tdrv.main(["--synthetic", "--tiny", "--steps", "0", "--resume", f"{ck}/step_1", "--device", "cpu"])
    assert res["done"] == 0
    for k, v in res["model"].state_dict().items():
        assert torch.equal(step1[k], v), k
    assert "resumed params from" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="mesh 2x1 needs 2 processes"):  # no world of 2 (F23)
        tdrv.main(["--synthetic", "--tiny", "--data-par", "2", "--device", "cpu"])

