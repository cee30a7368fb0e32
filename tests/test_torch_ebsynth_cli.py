"""The port's ebsynth-compatible command line against fresco_tpu's.

- ``parse_args``: equal option dicts on the same argv lists, the backend
  named as the port names it (JAX ``tpu`` -> ``jumpflood``), and the same
  refusals;
- ``write_error_bin``: the same bytes;
- ``main`` at 32x32 on the CPU: the PNG and the .bin equal to a direct
  ``synthesize`` with ``TorchDraws(0)`` (jump-flood), and with ``-backend
  cpu`` byte for byte equal to the JAX command line's files (both run the
  same C++ level, bit-equal; ``tests/test_torch_native.py``).
"""
import numpy as np
import pytest
import torch
from PIL import Image

from fresco_torch.propagate import ebsynth_cli as T
from fresco_tpu.propagate import ebsynth_cli as J

ARGVS = [
    "-style s.png -weight 2 -guide a.png b.png -weight 6 -guide c.png d.png -output o.png -uniformity 1000 "
    "-patchsize 7 -searchvoteiters 12 -patchmatchiters 6 -extrapass3x3 -backend cpu",
    "-style s -guide a b",
    "-guide a b -style s -weight 0.5 -pyramidlevels 3 -stopthreshold 0 -backend cuda",
    "-style s -guide a b -weight 3 -guide c d -backend TPU -output x/y.z.png",
]
BAD = ["-weight 2 -style s -guide a b", "-style s", "-guide a b", "-style s -guide a b -frobnicate"]
JAX_BACKEND = {"tpu": "jumpflood", "native": "native"}


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_jax(argv):
    t = T.parse_args(argv.split())
    j = J.parse_args(argv.split())
    assert t.pop("device") is None
    j["backend"] = JAX_BACKEND[j["backend"]]
    assert t == j


@pytest.mark.parametrize("argv", BAD)
def test_parse_args_refuses_as_jax(argv):
    for mod in (T, J):
        with pytest.raises(SystemExit):
            mod.parse_args(argv.split())


def test_write_error_bin_bytes_match(tmp_path):
    err = np.random.default_rng(0).uniform(0, 1e4, (7, 9)).astype(np.float32)
    T.write_error_bin(str(tmp_path / "t.bin"), torch.from_numpy(err))
    J.write_error_bin(str(tmp_path / "j.bin"), err)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def _files(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
    data = {"s.png": 255 - img, "a.png": img, "b.png": np.roll(img, 3, axis=1)}
    for name, arr in data.items():  # BGR arrays, written as the codec writes them
        Image.fromarray(np.ascontiguousarray(arr[..., ::-1])).save(tmp_path / name)
    return data


def _bin(path):
    raw = path.read_bytes()
    n = int(np.frombuffer(raw[:8], np.int64)[0])
    return n, np.frombuffer(raw[8:], np.float32)


def test_main_equals_direct_synthesize(tmp_path):
    from fresco_torch.propagate.patchmatch import TorchDraws, synthesize

    data = _files(tmp_path)
    opts = "-patchsize 5 -pyramidlevels 2 -searchvoteiters 2 -patchmatchiters 2"
    T.main(f"-style {tmp_path}/s.png -guide {tmp_path}/a.png {tmp_path}/b.png -weight 6 -output {tmp_path}/o.png "
           f"{opts} -backend cuda -device cpu".split())
    got = np.asarray(Image.open(tmp_path / "o.png").convert("RGB"))[..., ::-1]
    cfg = T.patch_config(T.parse_args(f"-style s -guide a b {opts}".split()))
    f = lambda x: torch.from_numpy(x.astype(np.float32))  # noqa: E731
    out, err, _ = synthesize(f(data["s.png"]), f(data["a.png"]), f(data["b.png"]), torch.full((3,), 2.0), cfg,
                             draws=TorchDraws(0))
    np.testing.assert_array_equal(got, out.clamp(0, 255).to(torch.uint8).numpy())
    n, e = _bin(tmp_path / "o.bin")
    assert n == 32 * 32
    np.testing.assert_array_equal(e, err.numpy().ravel())


def test_main_native_matches_jax_files(tmp_path):
    from fresco_torch.propagate.native import is_available

    if not is_available():
        pytest.skip("g++/OpenMP unavailable")
    _files(tmp_path)
    args = (f"-style {tmp_path}/s.png -guide {tmp_path}/a.png {tmp_path}/b.png -weight 6 -patchsize 5 "
            "-pyramidlevels 2 -searchvoteiters 2 -patchmatchiters 2 -backend cpu")
    T.main(f"{args} -output {tmp_path}/t.png -device cpu".split())
    J.main(f"{args} -output {tmp_path}/j.png".split())
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")), np.asarray(Image.open(tmp_path / "j.png")))
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
