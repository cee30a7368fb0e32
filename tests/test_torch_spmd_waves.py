"""Propagation's interval waves dealt over a process group's ranks (F28),
on the CPU over gloo: under a group, every rank runs
``blend_video_frames``, each wave's chains go one a rank, and rank 0
alone blends.

The chain of parity: here, rank 0's frames equal the serial path's
(``n_devices=1``) bit for bit, at worlds 2 and 4 on
``tests/test_torch_parallel.py``'s tiny clip and flows, and through
``cli.run_config`` at mesh (2, 1) on frames of data/music.mp4 against a
serial ``blend_video`` of the same keys; and the serial path matches the
JAX package within ``tests/test_torch_blend.py``'s tolerance.  So the
dealt waves match the JAX package within that tolerance too.

Keys 0 / 1 / 3 / 8 of the 9-frame clip: an interval of one frame (no
chain), one of two and one of five, so at world 4 the first wave has two
chains for four ranks, and at world 2 a wave has none.  Every reference
runs with one torch thread, as the spawned ranks do.

This file imports no JAX, so its card test (two ranks on two cards over
NCCL, skipped with fewer) runs on the card's machine:
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_spmd_waves.py -q``.
"""
import functools
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from test_torch_parallel import CFG, _clip, _flow_fn

from fresco_torch.parallel import distributed
from fresco_torch.parallel.distributed import launch
from fresco_torch.propagate import parallel
from fresco_torch.propagate import video_blend as tvb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = [0, 1, 3, 8]
BLEND_KW = dict(flow_fn=_flow_fn, patch_cfg=CFG, seed=3)
CACHED = 2  # the interval (3, 8) whose synthesis rank 0's tmp dir holds in the reuse run
CLI_CFG = dict(file_path=os.path.join(REPO, "data", "music.mp4"), frame_count=5, resolution=64, mininterv=2,
               maxinterv=2, batch_size=4, num_inference_steps=2, num_warmup_steps=1, end_opt_step=1, opt_iters=1,
               dtype="float32", gram_dtype="float32", run_ebsynth=True, prompt="a woman", mesh_shape=[2, 1],
               max_process=4)


def _clip_keys():
    frames, _ = _clip(1)
    return frames, {k: np.ascontiguousarray(255 - frames[k][..., ::-1]) for k in KEYS}


def _forbidden(*a, **k):
    raise AssertionError("a thread wave ran under a process group")


def _failing_flow_fn(a, b):
    raise ValueError("this rank's flows fail")


def _cli_config(tmp: str, rank: int) -> str:
    """config_music's settings cut to 5 frames at 64 px on a mesh (2, 1),
    with a save path of this rank's own: no rank reads another's files."""
    cfg = dict(CLI_CFG, save_path=os.path.join(tmp, f"rank{rank}") + "/", gmflow_path=os.path.join(tmp, "none.pth"),
               sod_path=os.path.join(tmp, "none.pth"))
    path = os.path.join(tmp, f"config{rank}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _rank(rank, dev, tmp, cli):
    """Every check of one rank of a world: how ``"auto"`` resolves, the
    dealt blend, the reuse run, (``cli``) ``run_config`` at mesh (2, 1),
    and last a rank whose flows fail."""
    from fresco_torch.cli import run_config
    from fresco_torch.core.config import load_config

    world = distributed.world_size()
    frames, keys = _clip_keys()
    mine = (frames, keys) if rank == 0 else (None, None)
    out = {"auto_cpu": parallel.resolve_n_devices("auto", dev),
           "dealt": [parallel.dealt_over_group(n, dev) for n in ("auto", world, 1)]}
    count = torch.cuda.device_count
    torch.cuda.device_count = lambda: 4  # four visible cards: "auto" is still the group's ranks
    try:
        out["auto_card"] = parallel.resolve_n_devices("auto", torch.device("cuda", 0))
    finally:
        torch.cuda.device_count = count
    try:
        parallel.dealt_over_group(3, dev)
    except ValueError as e:
        out["bad_n"] = str(e)
    run_jobs, wave = parallel.run_jobs, tvb._synthesize_chain_wave
    parallel.run_jobs = tvb._synthesize_chain_wave = _forbidden
    try:
        timers, reuse_timers = {}, {}
        out["frames"] = tvb.blend_video_frames(*mine, KEYS, n_devices="auto", device=dev, timers_out=timers,
                                               **BLEND_KW)
        out["reuse"] = tvb.blend_video_frames(*mine, KEYS, n_devices=world, device=dev,
                                              tmp_dir=os.path.join(tmp, "reuse"), reuse_synthesis=True,
                                              keep_tmp=False, timers_out=reuse_timers, **BLEND_KW)
        out["chains"], out["reuse_chains"] = timers["chains"], reuse_timers["chains"]
        if cli:  # the reduced PatchMatchConfig keeps the run to seconds
            blend_video, readings = tvb.blend_video, {}
            tvb.blend_video = functools.partial(blend_video, patch_cfg=CFG)
            try:
                out["cli"] = run_config(load_config(_cli_config(tmp, rank)), tiny=True, device="cpu", readings=readings)
            finally:
                tvb.blend_video = blend_video
            out["cli_readings"] = readings
    finally:
        parallel.run_jobs, tvb._synthesize_chain_wave = run_jobs, wave
    try:
        tvb.blend_video_frames(*mine, KEYS, n_devices="auto", device=dev,
                               **dict(BLEND_KW, flow_fn=_failing_flow_fn if rank == 1 else _flow_fn))
        out["failure"] = None
    except RuntimeError as e:
        out["failure"] = str(e)
    return out


@pytest.fixture(scope="module")
def serial():
    """The serial frames of the clip (one torch thread, as the ranks run),
    and a tmp dir holding the synthesis of interval CACHED alone."""
    frames, keys = _clip_keys()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return frames, keys, tvb.blend_video_frames(frames, keys, KEYS, n_devices=1, device="cpu", **BLEND_KW)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, serial):
    """Worlds 2 (with the CLI run) and 4, each rank's readings."""
    frames, keys, _ = serial
    out = {}
    for world in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        reuse = os.path.join(tmp, "reuse")
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            tvb.blend_video_frames(frames, keys, KEYS, n_devices=1, device="cpu", tmp_dir=reuse, **BLEND_KW)
        finally:
            torch.set_num_threads(n)
        for f in os.listdir(reuse):
            if f.startswith("synth_") and f != f"synth_{KEYS[CACHED]}_{KEYS[CACHED + 1]}.npz":
                os.remove(os.path.join(reuse, f))
        out[world] = (tmp, launch(_rank, world, tmp, world == 2, device="cpu", tmp_dir=tmp, timeout_s=300))
    return out


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b) == list(range(KEYS[-1] + 1))
    for i in a:
        np.testing.assert_array_equal(a[i], b[i])


@pytest.mark.parametrize("world", [2, 4])
def test_auto_is_the_groups_ranks_and_no_thread_wave_runs(worlds, world):
    """F28: under a group "auto" means its ranks, on the CPU and where four
    cards are visible; any other count than 1 and the group's size raises;
    the blends ran with the thread wave's entry points made to raise."""
    for r in worlds[world][1]:
        assert r["auto_cpu"] == r["auto_card"] == world
        assert r["dealt"] == [True, True, False]
        assert f"process group of {world} ranks" in r["bad_n"]


@pytest.mark.parametrize("world", [2, 4])
def test_dealt_waves_equal_serial(worlds, serial, world):
    """Rank 0's frames equal the serial path's bit for bit; the other ranks
    return None; every chain ran once, on the rank its place in its wave
    gives it (an interval of one frame has none)."""
    ranks = worlds[world][1]
    _equal(ranks[0]["frames"], serial[2])
    assert all(r["frames"] is None for r in ranks[1:])
    ran = sorted((c["seq_i"], c["d"]) for r in ranks for c in r["chains"])
    assert ran == [(1, 0), (1, 1), (2, 0), (2, 1)]
    for r, out in enumerate(ranks):
        assert all(c["rank"] == r and c["frames"] == KEYS[c["seq_i"] + 1] - KEYS[c["seq_i"]] - 1
                   for c in out["chains"])
    if world == 4:  # one wave of two chains for four ranks, then one of two
        assert [len(r["chains"]) for r in ranks] == [2, 2, 0, 0]


@pytest.mark.parametrize("world", [2, 4])
def test_reuse_is_rank_0s_decision(worlds, serial, world):
    """Only rank 0's tmp dir holds interval CACHED's synthesis: no rank
    synthesizes its chains, and rank 0's frames still equal serial."""
    ranks = worlds[world][1]
    _equal(ranks[0]["reuse"], serial[2])
    ran = sorted((c["seq_i"], c["d"]) for r in ranks for c in r["reuse_chains"])
    assert ran == [(1, 0), (1, 1)]


def test_a_failing_rank_raises_on_every_rank(worlds):
    for world, (_, ranks) in worlds.items():
        for r in ranks:
            assert r["failure"] is not None and "rank(s) [1]" in r["failure"], (world, r["failure"])
            assert "this rank's flows fail" in r["failure"]


def test_run_config_on_a_mesh_equals_a_serial_blend_video(worlds, tmp_path):
    """``run_config`` at mesh (2, 1) with ``max_process`` 4: both ranks
    propagate, rank 0 writes blend/ and reports, rank 1 returns None and
    writes nothing of it; rank 0's blend/ equals a serial ``blend_video``
    of rank 0's frames and keys, one torch thread, Farneback's flows (the
    run's flow source without a GMFlow checkpoint) bit for bit.  Both take
    the reduced PatchMatchConfig."""
    from fresco_torch.utils.classic_flow import pairwise_flow_fn

    tmp, ranks = worlds[2]
    assert ranks[0]["cli"] is not None and ranks[1]["cli"] is None
    assert not os.path.exists(os.path.join(tmp, "rank1", "blend"))
    assert {c["rank"] for r in ranks for c in r["cli_readings"]["chains"]} == {0, 1}
    assert all(r["cli_readings"]["batch_walls_s"] for r in ranks)
    run = os.path.join(tmp, "rank0")
    base = tmp_path / "serial"
    for sub in ("video", "keys"):
        shutil.copytree(os.path.join(run, sub), base / sub)
    key_ind = sorted(int(f[:4]) for f in os.listdir(base / "keys"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        blend = tvb.blend_video(str(base), key_ind, flow_fn=pairwise_flow_fn(), poisson=True, n_devices=1,
                                device="cpu", patch_cfg=CFG)
    finally:
        torch.set_num_threads(n)
    names = sorted(os.listdir(blend))
    assert names == sorted(os.listdir(os.path.join(run, "blend"))) == [f"{i:04d}.png" for i in range(5)]
    for f in names:
        np.testing.assert_array_equal(tvb.read_bgr(os.path.join(blend, f)),
                                      tvb.read_bgr(os.path.join(run, "blend", f)), err_msg=f)


def _cards_rank(rank, dev):
    frames, keys = _clip_keys()
    mine = (frames, keys) if rank == 0 else (None, None)
    return tvb.blend_video_frames(*mine, KEYS, n_devices="auto", device=dev, draw_device="cpu", **BLEND_KW)


@pytest.mark.cuda
def test_two_cards_over_nccl_equal_serial():
    """Two ranks on two cards over NCCL: rank 0's frames equal the serial
    path's on cuda:0 bit for bit."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    frames, keys = _clip_keys()
    ref = tvb.blend_video_frames(frames, keys, KEYS, n_devices=1, device="cuda:0", draw_device="cpu", **BLEND_KW)
    ranks = launch(_cards_rank, 2, device="cuda", timeout_s=300)
    assert ranks[1] is None
    _equal(ranks[0], ref)
