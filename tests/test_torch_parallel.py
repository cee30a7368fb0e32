"""Interval waves of the port on the CPU: ``_synthesize_chain_wave`` over
``["cpu"] * n`` and ``blend_video_frames(n_devices=...)`` against the
serial path, bit for bit (each job draws from the serial path's stream).

48x48 frames, 9 of them, keys 0 / 3 / 8 (unequal intervals, so the chains
of one wave end at different steps); a reduced PatchMatchConfig keeps it
to seconds."""
import numpy as np
import pytest
import torch
from scipy import ndimage

from fresco_torch.propagate import parallel
from fresco_torch.propagate import video_blend as tvb
from fresco_torch.propagate.patchmatch import PatchMatchConfig

H = W = 48
KEYS = [0, 3, 8]
CFG = PatchMatchConfig(pm_iters=1, sv_iters=2, num_pyramid_levels=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These 48x48 tensors are too small for torch's thread pool, whose
    wake-ups cost more than the work; the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    base = ndimage.gaussian_filter(rng.uniform(0, 255, (H + 16, W + 16, 3)), (3, 3, 0))
    base = (base - base.min()) / (base.max() - base.min()) * 255
    frames = {i: np.ascontiguousarray(base[i: i + H, 8: 8 + W]).astype(np.uint8) for i in range(KEYS[-1] + 1)}
    keys = {k: np.ascontiguousarray(255 - frames[k][..., ::-1]) for k in KEYS}
    return frames, keys


def _flow_fn(a, b):
    """A deterministic flow of each pair, small and varied, so guides warp
    and some pixels are occluded."""
    f = torch.stack([(a - b)[..., 0], (b - a)[..., 1]], -1) / 32.0
    return torch.cat([f, -f])


def _interval(frames, keys, beg, end):
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    seq = [t(frames[i]) for i in range(beg, end + 1)]
    rev = seq[::-1]
    fc = tvb._FlowCache(_flow_fn, torch.device("cpu"))
    js = list(range(end - beg - 1))
    flows = (fc.get_batch(seq, js, [f"f{beg}_{j}" for j in js]), fc.get_batch(rev, js, [f"b{end}_{j}" for j in js]))
    return (t(keys[beg]), t(keys[end])), (seq, rev), flows


def test_chain_wave_equals_serial_chain_pairs():
    frames, keys = _clip()
    seed = 7
    wave = [(i, *_interval(frames, keys, KEYS[i], KEYS[i + 1])) for i in range(len(KEYS) - 1)]
    out = tvb._synthesize_chain_wave(wave, CFG, seed, ["cpu"] * 4)
    for seq_i, key_imgs, frames_pair, flows_pair in wave:
        ref = tvb._synthesize_chain_pair(key_imgs, frames_pair, flows_pair, CFG, tvb._stream_seed(seed, seq_i))
        for (wo, we), (so, se) in zip(out[seq_i], ref):
            assert len(wo) == len(so) == KEYS[seq_i + 1] - KEYS[seq_i] - 1
            for a, b in zip(wo + we, so + se):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="need 4 devices"):
        tvb._synthesize_chain_wave(wave, CFG, seed, ["cpu"] * 3)


BLEND_KW = dict(flow_fn=_flow_fn, patch_cfg=CFG, seed=3, device="cpu")


@pytest.fixture(scope="module")
def serial_blend():
    frames, keys = _clip(1)
    return frames, keys, tvb.blend_video_frames(frames, keys, KEYS, n_devices=1, **BLEND_KW)


@pytest.mark.parametrize("n_devices", [2, 4])  # waves of one interval, and one wave of both
def test_blend_video_frames_waves_equal_serial(serial_blend, n_devices):
    frames, keys, serial = serial_blend
    waves = tvb.blend_video_frames(frames, keys, KEYS, n_devices=n_devices, **BLEND_KW)
    assert sorted(serial) == sorted(waves) == list(range(KEYS[-1] + 1))
    for i in serial:
        np.testing.assert_array_equal(serial[i], waves[i])


def test_wave_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert parallel.wave_devices(3, cpu) == [cpu] * 3
    assert parallel.resolve_n_devices("auto", cpu) == 1 and parallel.resolve_n_devices("4", cpu) == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    card = torch.device("cuda", 0)
    assert parallel.resolve_n_devices("auto", card) == 2
    assert parallel.wave_devices(2, card) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="2 visible"):
        parallel.wave_devices(4, card)
