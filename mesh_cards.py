"""The port's device mesh and its interval waves on four cards over NCCL.

    python3 mesh_cards.py [--seed 0] [--out artifacts/torch_mesh_cards/readings.json]
    python3 mesh_cards.py --cpu --tiny    # the same phases over gloo on the CPU at 64 px: a rehearsal
    python3 mesh_cards.py --clip [--out artifacts/torch_mesh_cards/clip.json]   # a whole clip alone
    python3 mesh_cards.py --clip --cpu --tiny --work DIR   # its rehearsal: four gloo ranks, 24 frames at 64 px

On the card it needs four visible cards and raises, naming the count it
sees, where there are fewer: ranks that share a card go over gloo, which
phase 17 of ``chip_smoke.py`` reads on one card.  Every rank gets a card of
its own (``parallel.distributed.launch`` deals them round-robin), so every
collective goes over NCCL between cards.  Phases, each ending in a summary
line:

  1. probe: nvidia-smi's name and power limit and ``nvidia-smi topo -m``;
     which cards reach each other's memory directly; NCCL's version; four ranks' backend, card and the card's name, the
     collectives' values, and a 2x4x4096x320 bf16 gather (cross-frame
     attention's K at 512 px) timed over four cards (the worlds' probe in
     phase 3 times it over two);
  2. kernels off the current card: with cuda:0 current, each of the five
     kernels on inputs that lie on cuda:1, 2 and 3, at a main-path shape,
     against its plain version with the bounds of its ``chip_smoke.py``
     phase, and its launch counted on that card (F27);
  3. worlds: ``chip_smoke.phase_mesh`` at (2, 1), (1, 2), (2, 2) and (4, 1)
     with phase 17's ``MESH_STEPS`` and bounds: config_music's batch of 8
     keyframes at 512 px, seeded random weights at full width, feature
     optimization off and on, GMFlow the flow source, the UNet, ControlNet,
     VAE, text encoder and GMFlow split over ``model``, each rank against
     the single process and its witness; the (2, 1) UNet training step;
  4. full steps: the (2, 2) world at config_music's 20 steps, held to
     phase 17's bounds against its witness and the single process;
  5. waves: ``chip_smoke.phase_waves`` over cuda:0..3 (a chain a card,
     each on a thread of this process) against the serial chains on
     cuda:0, bit for bit, with both walls and row_gather's and
     patch_eval's launches on each card; then the same chains each in a
     process of its own on its card, bit for bit, with their walls;
  6. dry run: ``dryrun_multichip(4, device="cuda")`` over NCCL.

``--clip`` runs one phase instead, the whole config_music clip, 240
frames at 512x640 with seeded random weights (``--random-aux-weights``),
and writes ``artifacts/torch_mesh_cards/clip.json``:

  a. one card, keyframes only: ``run_e2e --keyframes-only`` in one process
     on cuda:0, the keyframe stage's wall and its keys;
  b. four cards: ``run_e2e`` under torchrun (``python -m
     torch.distributed.run --nproc-per-node 4 --master-addr 127.0.0.1``)
     with ``mesh_shape: [4, 1]``, every rank on NCCL on its own card,
     propagation's chains dealt one a rank: TOTAL, each phase and each
     rank's card, batch walls, chain walls, peak and launches by card;
  c. one card, serial propagation: ``blend_video`` of (b)'s keys with
     ``n_devices=1`` on cuda:0 into a fresh directory, held to (b)'s
     blend/ frames bit for bit, with both propagation walls;
  d. (b)'s keys against (a)'s, each at least ``MESH_PSNR_FLOOR`` dB.

The YAML is config/config_music.yaml with the mesh (and, rehearsing, the
cut) added, written under ``--work``.

Every reading goes to one JSON file (``--out``), written after each phase.
A phase that fails is recorded there with its error and the next one
runs; any failure makes the exit code 1.  Imports neither jax nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

import chip_smoke as cs

CARDS = 4
OUT = "artifacts/torch_mesh_cards/readings.json"
CLIP_OUT = "artifacts/torch_mesh_cards/clip.json"
CLIP_CONFIG = "config/config_music.yaml"
CLIP_SHAPE = (4, 1)   # the fastest rank batch on four cards (readings.json), and no rank splits GMFlow
CLIP_WORK = "output/mesh_clip"
# the CPU rehearsal's cut of config_music: 24 frames at 64 px, intervals
# 4 / 8 (several waves of four chains), 4 steps, tiny models
CLIP_TINY = dict(frame_count=24, resolution=64, mininterv=4, maxinterv=8, num_inference_steps=4, num_warmup_steps=1,
                 end_opt_step=3)
WORLDS = ((2, 1), (1, 2), (2, 2), (4, 1))
FULL_SHAPE = (2, 2)
FULL_STEPS: dict = {}   # config_music's own: 20 steps, warmup 3, feature optimization to step 15


def need_cards(n_seen: int) -> None:
    """Raise unless ``CARDS`` cards are visible."""
    if n_seen < CARDS:
        raise RuntimeError(f"mesh_cards.py needs {CARDS} visible cards, one a rank over NCCL; it sees {n_seen} "
                           "(ranks sharing a card go over gloo: chip_smoke.py's phase 17 reads that)")


def _smi(*args: str) -> str:
    r = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else f"nvidia-smi failed (rc {r.returncode}): {r.stderr.strip()}"


def phase_probe(dev) -> dict:
    out = {"cards_visible": torch.cuda.device_count() if dev.type == "cuda" else 0}
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        out.update(card=cs.CARD, topo=_smi("topo", "-m"), names=[torch.cuda.get_device_name(i) for i in range(n)],
                   peer_access=[[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
                                for i in range(n)])
        print(f"nvidia-smi topo -m:\n{out['topo']}\ncard i reaches card j's memory directly (CUDA peer access): "
              f"{out['peer_access']}")
    out["world4"] = cs.mesh_probe(dev, CARDS)
    ranks = out["world4"]["ranks"]
    print(f"[mesh_cards] probe: NCCL {out['world4']['nccl_version']}; "
          + "; ".join(f"rank {i}: {r['backend']} on card {r['card']} ({r['name']}), gather {r.get('gather_ms')} ms"
                      for i, r in enumerate(ranks)))
    for r in ranks:
        if any(r[op] != "ok" for op in ("all_gather", "all_reduce", "broadcast")):
            cs.fail(f"probe: a collective failed or gave wrong values: {r}")
    cs.check_where("probe", ranks, dev)
    return out


def _rel_max(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    d = out.float() - ref.float()
    return float(d.abs().max()), float(d.norm() / ref.float().norm())


def kernels_on(dev, seed: int, tiny: bool) -> dict:
    """Each of the five kernels once on inputs on ``dev``, at a main-path
    shape (``tiny``: small ones), against its plain version with the bounds
    of its ``chip_smoke.py`` phase; returns the errors."""
    from fresco_torch.attention.flash import flash_attention
    from fresco_torch.ops import gemm
    from fresco_torch.ops import gram_kernel as gk
    from fresco_torch.propagate.gather import gather_rows, gather_rows_plain
    from fresco_torch.propagate.patch_eval import patch_eval, patch_eval_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    if tiny:
        b, s, hw, c, n_rows, pe_hw, radii = 2, 256, 256, 64, 4096, (64, 80), [16, 8, 4]
    else:  # the main path's: 512 px attention and grams, the 512x640 interval's finest level
        b, s, hw, c, n_rows, pe_hw, radii = 16, 4096, 4096, 640, 327_680, cs.PROP_HW, [160, 80, 40]
    out = {}
    # flash: the UNet's self-attention at 512 px, [B,S,H,D] memory as the head split gives it
    q, k, v = (bf(b, s, 8, 40).transpose(1, 2) for _ in range(3))
    err, rel = _rel_max(flash_attention(q, k, v), cs.plain_attention_chunked(q, k, v, None, 1024))
    out["flash_attn_fwd"] = {"max_abs": err, "rel_fro": rel}
    if not (err <= cs.FLASH_ATOL and rel <= cs.FLASH_REL_FRO):
        cs.fail(f"flash on {dev}: max|d| {err}, rel fro {rel}")
    del q, k, v
    # sign-gram (its apply on bmm): phase 3's bf16 case, flips only at near ties
    vr = torch.nn.functional.normalize(torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
    vv = torch.nn.functional.normalize(vr + 0.3 * torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
    vv = vv.to(torch.bfloat16).contiguous()
    corr = torch.matmul(vr.to(torch.bfloat16), vr.to(torch.bfloat16).transpose(1, 2)).contiguous()
    got = gk.sign_gram_apply(vv, corr)
    err, rel = _rel_max(got, gk.sign_gram_plain(vv, corr))
    d = torch.matmul(vv.float(), vv.float().transpose(1, 2)) - corr.float()
    s_k = gk.sign_matrix(vv, corr).float() if dev.type == "cuda" else torch.sign(d)  # the sign kernel alone
    flip = torch.sign(d) != s_k
    tie = float(d[flip].abs().max()) if bool(flip.any()) else 0.0
    _, apply_rel = _rel_max(got, torch.matmul(s_k, vv.float()))
    out["sign_gram"] = {"max_abs": err, "rel_fro": rel, "flips": int(flip.sum()), "tie_max": tie,
                        "apply_rel": apply_rel}
    if not (rel <= cs.GRAM_REL_FRO and tie <= cs.GRAM_TIE and apply_rel <= cs.GRAM_APPLY_REL):
        cs.fail(f"sign_gram on {dev}: {out['sign_gram']}")
    del vr, vv, corr, got, s_k, d, flip
    # bmm: phase 9's guidance-layout row
    a, x = bf(b // 2, hw, hw), bf(b // 2, hw, 2 * c)
    err, rel = _rel_max(gemm.bmm(a, x), gemm.bmm_plain(a, x))
    out["bmm"] = {"max_abs": err, "rel_fro": rel}
    if not rel <= cs.GEMM_REL_FRO:
        cs.fail(f"bmm on {dev}: rel fro {rel}")
    del a, x
    # row_gather: the vote's finest-level table, bit for bit
    table = torch.rand(n_rows, 75, generator=gen, device=dev) * 255
    idx = torch.randint(0, n_rows, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
    same = torch.equal(gather_rows(table, idx), gather_rows_plain(table, idx))
    out["row_gather"] = {"bit_equal": same}
    if not same:
        cs.fail(f"row_gather on {dev}: not bit-equal to index_select")
    del table, idx
    # patch_eval: phase 7's seeded 15-candidate case at the finest level
    src, tgt, weights, omega, nnf, deltas, *_ = cs._patch_eval_case(seed, dev, pe_hw, True, (1, 2, 4), radii)
    nnf0, e0 = patch_eval(src, tgt, weights, omega, nnf)
    args = (src, tgt, weights, omega, nnf0, e0, (1, 2, 4), deltas, None)
    err = cs._check_patch_eval(f"on {dev}", args, 5, patch_eval(*args), patch_eval_plain(*args))
    out["patch_eval"] = {"max_abs": err}
    return out


def phase_kernels(seed: int, dev, tiny: bool) -> dict:
    """Phase 2 (F27): each kernel on inputs on cuda:1..3 with cuda:0 current."""
    from fresco_torch import kernels

    devs = [torch.device("cuda", i) for i in range(1, CARDS)] if dev.type == "cuda" else [dev]
    out = {}
    for d in devs:
        if d.type == "cuda":
            torch.cuda.set_device(0)
        kernels.reset_launches()
        got = kernels_on(d, seed, tiny)
        current = torch.cuda.current_device() if d.type == "cuda" else None
        by_card = kernels.launches_by_card()
        out[str(d)] = {"current_device": current, "errors": got, "launches_by_card": by_card}
        print(f"[mesh_cards] kernels on {d}, current device {current}: {got}; launches by card {by_card}")
        if d.type == "cuda" and (current != 0 or any(set(n) != {d.index} for n in by_card.values())):
            cs.fail(f"kernels on {d}: current device {current}, launches by card {by_card}")
    return out


def _chain_rank(rank: int, dev, seed: int, hw, keys) -> dict:
    """Job ``rank`` of phase 13's wave over the keyframes ``keys`` (its jobs
    in ``_synthesize_chain_wave``'s order) alone in this process, on this
    rank's card: its outputs and errors on the host, and the wall from its
    inputs on the card to its last frame."""
    from fresco_torch import kernels
    from fresco_torch.propagate.patchmatch import PatchMatchConfig
    from fresco_torch.propagate.video_blend import _stream_seed, _synthesize_chain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.WAVE_KEYS = tuple(keys)  # the spawning process's, which a rehearsal sets
    *_, wave = cs.wave_inputs(seed, dev, hw)
    jobs = [(seq_i, d, keys[d], frames[d], flows[d]) for seq_i, keys, frames, flows in wave for d in range(2)
            if len(frames[d]) > 2]
    seq_i, d, key, frames, flows = jobs[rank]
    kernels.reset_launches()
    cs._sync(dev)
    t0 = time.perf_counter()
    outs, errs = _synthesize_chain(key, frames, flows, PatchMatchConfig(), _stream_seed(seed, seq_i), d)
    cs._sync(dev)
    return {"jobs": len(jobs), "seq_i": seq_i, "d": d, "wall_s": time.perf_counter() - t0,
            "card": dev.index, "launches_by_card": kernels.launches_by_card(),
            "outs": [o.cpu() for o in outs], "errs": [e.cpu() for e in errs]}


def phase_waves(seed: int, dev, wave_kw: dict) -> dict:
    """Phase 5: ``chip_smoke.phase_waves`` over cuda:0..3, a chain a card on
    a thread each in this process; then the same four chains each in a
    process of its own on its card, both bit for bit against the serial
    chains: the wall of one process driving four cards against that of
    four processes each driving one (from their inputs on the card; the
    spawn and the card's start-up come on top)."""
    from fresco_torch.parallel.distributed import launch

    devs = [torch.device("cuda", i) for i in range(CARDS)] if dev.type == "cuda" else [dev] * CARDS
    out = cs.phase_waves(seed, dev, devices=devs, **wave_kw)
    serial = out.pop("serial")
    out.pop("blend")
    t0 = time.perf_counter()
    ranks = launch(_chain_rank, CARDS, seed, wave_kw.get("hw", cs.PROP_HW), cs.WAVE_KEYS, device=dev.type,
                   timeout_s=cs.MESH_TIMEOUT_S)
    call = time.perf_counter() - t0
    same = all(r["jobs"] == CARDS for r in ranks) and all(
        len(r["outs"]) == len(serial[r["seq_i"]][r["d"]][0])
        and all(torch.equal(a, b.cpu()) for a, b in zip(r["outs"], serial[r["seq_i"]][r["d"]][0]))
        and all(torch.equal(a, b.cpu()) for a, b in zip(r["errs"], serial[r["seq_i"]][r["d"]][1])) for r in ranks)
    walls = [r["wall_s"] for r in ranks]
    out["processes"] = {"chain_walls_s": walls, "wall_s": max(walls), "call_wall_s": call, "bit_equal": same,
                        "cards": [r["card"] for r in ranks], "launches_by_card": [r["launches_by_card"] for r in ranks]}
    print(f"[mesh_cards] waves: serial chains {out['chains_serial_s']:.2f} s; one process, a thread a card "
          f"{out['chains_wave_s']:.2f} s; a process a card {max(walls):.2f} s (chains "
          + ", ".join(f"{w:.2f}" for w in walls) + f"; {call:.2f} s with the spawn), bit-equal {same} ({cs.CARD})")
    if not same:
        cs.fail("waves: a chain run in a process of its own differs from the serial chain")
    return out


def _clip_yaml(path: str, shape, cut: dict) -> str:
    """config_music's YAML with ``mesh_shape`` and ``cut`` set, at ``path``."""
    import yaml

    with open(CLIP_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg.update(cut, mesh_shape=list(shape))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _run_logged(cmd: list, log: str, timeout_s: float, env=None) -> float:
    """``cmd`` in a session of its own with its output in ``log``; its wall,
    or a raise with the log's end where it fails.  Past ``timeout_s`` the
    whole session is killed (torchrun's workers too)."""
    import signal

    t0 = time.perf_counter()
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        try:
            rc = p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            rc = f"killed at its {timeout_s:.0f} s limit"
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log) as f:
            tail = f.read()[-6000:]
        raise RuntimeError(f"{' '.join(cmd)} exited {rc} after {wall:.1f} s; the end of {log}:\n{tail}")
    return wall


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pngs(d: str) -> dict:
    from fresco_torch.propagate.video_blend import read_bgr

    return {int(f[:4]): read_bgr(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _by_card(launches: dict, name: str) -> dict:
    return {int(c): n for c, n in launches.get(name, {}).items()}


def phase_clip(dev, tiny: bool, work: str) -> dict:
    """The ``--clip`` phase (a-d of the docstring); returns the readings
    and fails (``cs.fail``) on a bound missed."""
    import shutil

    import numpy as np

    from fresco_torch import kernels
    from fresco_torch.core.config import load_config
    from fresco_torch.propagate.video_blend import blend_video
    from fresco_torch.utils.classic_flow import pairwise_flow_fn

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cut = CLIP_TINY if tiny else {}
    cpu = ["--device", "cpu", "--tiny"] if dev.type == "cpu" else []
    e2e = ["-m", "fresco_torch.scripts.run_e2e", "--random-aux-weights"]
    out = {"config": CLIP_CONFIG, "cut": cut, "mesh_shape": list(CLIP_SHAPE), "card": cs.CARD}
    d = {k: os.path.join(work, k) for k in ("single", "cards", "serial")}

    # (a) one card, keyframes only
    wall = _run_logged([sys.executable, *e2e, _clip_yaml(os.path.join(work, "single.yaml"), (1, 1), cut),
                        "--keyframes-only", "--save-path", d["single"] + "/",
                        "--readings", os.path.join(d["single"], "readings.json"), *cpu],
                       os.path.join(work, "single.log"), timeout_s=400)
    with open(os.path.join(d["single"], "readings.json")) as f:
        out["single_keyframes"] = {"call_wall_s": wall, **json.load(f)}
    single = out["single_keyframes"]
    print(f"[mesh_cards] clip (a) one card, keyframes only: keyframe stage {single['keyframes_s']:.1f} s "
          f"(batches {', '.join(f'{b:.2f}' for b in single['batch_walls_s'])} s), TOTAL {single['wall_s']:.1f} s, "
          f"peak {single.get('peak_gib', 0):.2f} GiB ({cs.CARD})", flush=True)

    # (b) four cards under torchrun
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or CARDS) // CARDS)))  # torchrun's default is 1
    out["omp_num_threads"] = env["OMP_NUM_THREADS"]
    wall = _run_logged([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(CARDS),
                        "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), *e2e,
                        _clip_yaml(os.path.join(work, "cards.yaml"), CLIP_SHAPE, cut), "--save-path", d["cards"] + "/",
                        "--readings", os.path.join(d["cards"], "rank{rank}.json"), *cpu],
                       os.path.join(work, "cards.log"), env=env, timeout_s=600)
    ranks = []
    for r in range(CARDS):
        with open(os.path.join(d["cards"], f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(d["cards"], "phases.json")) as f:
        phases = json.load(f)
    with open(os.path.join(d["cards"], "metrics.json")) as f:
        metrics = json.load(f)
    out["cards"] = {"call_wall_s": wall, "total_s": ranks[0]["wall_s"], "phases": phases, "metrics": metrics,
                    "ranks": ranks}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    for r, rk in enumerate(ranks):
        chains = rk["chains"]
        print(f"[mesh_cards] clip (b) rank {r} ({rk['backend']}, {rk['device']}): TOTAL {rk['wall_s']:.1f} s, "
              f"keyframes {rk['keyframes_s']:.1f} s (batches {', '.join(f'{b:.2f}' for b in rk['batch_walls_s'])}), "
              f"{len(chains)} chains ({sum(c['wall_s'] for c in chains):.1f} s: "
              + ", ".join(f"{c['seq_i']}{'fb'[c['d']]} {c['wall_s']:.2f}" for c in chains)
              + f"), propagation {rk['propagation']['wall_total']:.1f} s, peak {rk.get('peak_gib', 0):.2f} GiB, "
              f"launches by card {rk.get('launches_by_card')} ({cs.CARD})", flush=True)
        want = f"cuda:{r}" if dev.type == "cuda" else "cpu"
        if rk["backend"] != backend or rk["device"] != want or rk["world"] != CARDS:
            cs.fail(f"clip (b) rank {r}: {rk['backend']} on {rk['device']} in a world of {rk['world']}, "
                    f"expected {backend} on {want} in one of {CARDS}")
        if not chains:
            cs.fail(f"clip (b) rank {r} synthesized no chain")
        if dev.type == "cuda":
            for name in ("flash_attn_fwd", "sign_gram", "bmm", "row_gather", "patch_eval"):
                by_card = _by_card(rk["launches_by_card"], name)
                if set(by_card) != {r} or by_card[r] <= 0:
                    cs.fail(f"clip (b) rank {r}: {name} launched by card {by_card}, expected on card {r} alone")
    print(f"[mesh_cards] clip (b) four cards: TOTAL {ranks[0]['wall_s']:.1f} s (call {wall:.1f} s), keyframes "
          f"{ranks[0]['keyframes_s']:.1f} s, propagation {phases['propagation']['wall_total']:.1f} s, phases "
          f"{phases['propagation']}; metrics {metrics} ({cs.CARD})", flush=True)

    # (c) one card, serial propagation of (b)'s keys into a fresh directory
    cfg = load_config(os.path.join(work, "cards.yaml"))
    if os.path.exists(str(cfg.gmflow_path)):
        cs.fail(f"clip (c): a GMFlow checkpoint at {cfg.gmflow_path}: (c) takes Farneback's flows, as (b) does "
                "without one")
    os.makedirs(d["serial"])
    for sub in ("video", "keys"):
        os.symlink(os.path.abspath(os.path.join(d["cards"], sub)), os.path.join(d["serial"], sub))
    key_ind = sorted(_pngs(os.path.join(d["cards"], "keys")))
    timers: dict = {}
    kernels.reset_launches()
    cs._reset_peak(dev)
    t0 = time.perf_counter()
    blend_video(d["serial"], key_ind, flow_fn=pairwise_flow_fn(), poisson=True, n_devices=1, device=dev,
                timers_out=timers)
    cs._sync(dev)
    out["serial"] = {"wall_s": time.perf_counter() - t0, "propagation": timers, "peak_gib": cs._peak_gib(dev),
                     "launches": kernels.launches(), "key_ind": key_ind}
    got, ref = _pngs(os.path.join(d["cards"], "blend")), _pngs(os.path.join(d["serial"], "blend"))
    differ = sorted(i for i in ref if i not in got or not np.array_equal(got[i], ref[i]))
    out["serial"]["bit_equal"] = not differ and sorted(got) == sorted(ref)
    print(f"[mesh_cards] clip (c) one card, serial propagation of (b)'s {len(key_ind)} keys: propagation "
          f"{timers['wall_total']:.1f} s against {phases['propagation']['wall_total']:.1f} s on four cards; "
          f"{len(ref)} blend frames, bit-equal to (b)'s {out['serial']['bit_equal']} (differ: {differ[:10]}) "
          f"({cs.CARD})", flush=True)
    if not out["serial"]["bit_equal"]:
        cs.fail(f"clip (c): (b)'s blend frames differ from the serial propagation's at {differ[:10]}")

    # (d) the keys against one card's
    a_keys, b_keys = _pngs(os.path.join(d["single"], "keys")), _pngs(os.path.join(d["cards"], "keys"))
    if sorted(a_keys) != sorted(b_keys):
        cs.fail(f"clip (d): keyframes {sorted(a_keys)} on one card, {sorted(b_keys)} on four")
    psnr = {k: cs._psnr_u8(b_keys[k], a_keys[k]) for k in a_keys}
    out["keys_vs_single"] = {"psnr_db": psnr, "mean_db": float(np.mean([min(p, 99.0) for p in psnr.values()])),
                             "worst_db": min(psnr.values()), "floor_db": cs.MESH_PSNR_FLOOR}
    print(f"[mesh_cards] clip (d) keys on four cards against one card's: PSNR mean "
          f"{out['keys_vs_single']['mean_db']:.2f} dB (inf read as 99), worst {out['keys_vs_single']['worst_db']:.2f} "
          f"dB, floor {cs.MESH_PSNR_FLOOR} ({cs.CARD})", flush=True)
    if not out["keys_vs_single"]["worst_db"] >= cs.MESH_PSNR_FLOOR:
        cs.fail(f"clip (d): a key at {out['keys_vs_single']['worst_db']:.2f} dB against one card's, "
                f"floor {cs.MESH_PSNR_FLOOR}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help=f"default {OUT}, with --clip {CLIP_OUT}")
    ap.add_argument("--cpu", action="store_true", help="rehearse every phase on the CPU over gloo")
    ap.add_argument("--tiny", action="store_true", help="tiny models at 64 px (the CPU rehearsal)")
    ap.add_argument("--clip", action="store_true", help="only the whole config_music clip under torchrun")
    ap.add_argument("--work", default=CLIP_WORK, help="--clip's working directory (emptied first)")
    args = ap.parse_args(argv)
    args.out = args.out or (CLIP_OUT if args.clip else OUT)
    if not args.cpu:
        need_cards(torch.cuda.device_count() if torch.cuda.is_available() else 0)
    t_start = time.perf_counter()
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    os.environ.setdefault("NCCL_DEBUG", "WARN")  # the ranks inherit it: NCCL's warnings in the log
    # a world takes well under a minute: a rank that fails leaves its peers
    # waiting in a collective until this, and then the next phase runs
    cs.MESH_TIMEOUT_S = 180
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, mesh_kw, wave_kw = 512, {}, {}
    if args.cpu:
        from fresco_torch.models.unet import UNetConfig

        torch.set_num_threads(1)  # as the spawned ranks run: the in-process witness rounds as they do
        # bf16 on the CPU: the vs-single bounds and the PSNR floor are the card's
        cs.MESH_LATENT_REL, cs.MESH_PSNR_FLOOR, cs.PROP_PSNR_FLOOR = 1.0, 0.0, 0.0
        cs.WAVE_KEYS = (0, 3, 8)
        res, wave_kw = 64, {"hw": (64, 80)}
        mesh_kw = dict(tiny=args.tiny, res=res, train_res=64, train_cfg=UNetConfig(
            block_out_channels=(32, 32, 64, 64), layers_per_block=1, attention_heads=2, norm_groups=8,
            cross_attention_dim=32))
    else:
        from fresco_torch import kernels

        cs.CARD = _smi("--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
        print(cs.CARD)
        t0 = time.perf_counter()
        kernels.load()
        print(f"build: {len(kernels.build_info.paths)} libraries in {time.perf_counter() - t0:.2f} s")
    readings = {"card": cs.CARD, "torch": torch.__version__, "cuda": torch.version.cuda,
                "nccl": ".".join(map(str, torch.cuda.nccl.version())) if dev.type == "cuda" else None,
                "mesh_frames": cs.MESH_FRAMES, "res": res, "seed": args.seed,
                "bounds": {k: getattr(cs, k) for k in ("MESH_WITNESS_REL", "MESH_PSNR_WITNESS_FLOOR",
                                                       "MESH_LATENT_REL", "MESH_PSNR_FLOOR", "MESH_TRAIN_LOSS_REL",
                                                       "MESH_TRAIN_GRAD_REL")},
                "phases": {}, "failed": []}
    from fresco_torch.parallel.dryrun import dryrun_multichip

    phases = [("clip", lambda: phase_clip(dev, args.tiny, args.work))] if args.clip else [
        ("probe", lambda: phase_probe(dev)),
        ("kernels_off_current", lambda: phase_kernels(args.seed, dev, args.tiny)),
        ("worlds", lambda: cs.phase_mesh(args.seed, dev, shapes=WORLDS, dryrun=False, waves=False, **mesh_kw)),
        ("full_steps", lambda: cs.phase_mesh(args.seed, dev, shapes=(FULL_SHAPE,), dryrun=False, steps=FULL_STEPS,
                                             probe=False, waves=False, **mesh_kw)),
        ("waves", lambda: phase_waves(args.seed, dev, wave_kw)),
        ("dryrun", lambda: dryrun_multichip(CARDS, device=dev.type)),
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            got, err = run(), None
        except (Exception, SystemExit) as e:  # cs.fail exits: record the failure and go on
            got, err = None, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            readings["failed"].append(name)
        wall = time.perf_counter() - t0
        readings["phases"][name] = {"wall_s": wall, "error": err, "readings": got}
        readings["wall_s"] = time.perf_counter() - t_start
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1, default=str)
        print(f"[mesh_cards] phase {name}: {'FAILED' if err else 'ok'} in {wall:.1f} s "
              f"(total {readings['wall_s']:.1f} s){'' if err is None else chr(10) + err}", flush=True)
        if dev.type == "cuda":
            for i in range(torch.cuda.device_count()):
                with torch.cuda.device(i):
                    torch.cuda.empty_cache()
    print(f"[mesh_cards] {len(phases) - len(readings['failed'])} of {len(phases)} phases ok, failed "
          f"{readings['failed']}, wall {readings['wall_s']:.1f} s, readings in {args.out} ({cs.CARD})")
    return 1 if readings["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
