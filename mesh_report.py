"""Where a sharded rank departs from its one-process witness, module by module.

For each mesh shape, config_music's 8-keyframe batch (chip_smoke's phase-17
settings, feature optimization off) runs once in this process as the
witness (``parallel.smoke.rank_sized_layers``: a rank's arithmetic, no
collective) and once in spawned ranks on the same card, with the bundle's
GMFlow as the flow source.  Every output of every module of the text
encoder, GMFlow, the UNet, ControlNet and VAE through the first three UNet
calls (the prep, with the intra pass, and both denoise steps) is
fingerprinted by two exact integer sums of its bits, the witness's cut to
rank 0's frames and channels (inside GMFlow, which the witness runs a data
rank's frames at a time, its calls on rank 0's frames); the report counts
the calls that agree and lists the first that do not.  Then one convolution (``--probe``) is taken apart: its input and
output in both runs, and the convolution recomputed here on rank 0's input
fresh, on the witness's whole batch, and on the witness's contiguous half
(the rows of another rank's layout), so that a kernel that rounds a row by
its place in the batch shows.

    python3 mesh_report.py [--shapes 2x1,1x2,2x2] [--probe down_2_res_0.conv2]
    python3 mesh_report.py --cpu --probe down_1_res_0.conv2   # tiny models at 64 px, gloo on the CPU

Prints the card's name and power limit first; ``--out FILE`` also writes
the report as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import torch

import chip_smoke as cs

N_UNET_CALLS = 3  # the intra prep pass and the two denoise steps of MESH_STEPS


def fingerprint(t: torch.Tensor) -> tuple[int, int]:
    """Two exact integer sums of a tensor's bits (plain and position-weighted)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        v = t.contiguous().view(torch.int16)
    elif t.dtype == torch.float32:
        v = t.contiguous().view(torch.int32)
    else:
        v = t.contiguous().to(torch.float64).view(torch.int64)
    v = v.reshape(-1).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 9973 + 1
    return int(v.sum()), int((v * w).sum())


def _record(bundle, shape, witness: bool, probe: str, dumps: dict, piece: list):
    """Forward hooks on every module of the five models (those inside a
    text cross-attention excepted: the witness cuts its batch around them);
    ``piece``: the witness's ``[data rank]`` of the frames running inside a
    model cut by frames.  Returns the record and the hooks' remover."""
    from fresco_torch.core.comm import Mesh, local_frames
    from fresco_torch.models import layers
    from fresco_torch.models.unet import CrossAttention
    from fresco_torch.parallel.sharding import bundle_models, tp_plan

    d, m = shape
    rec, state = [], {"unet": 0}
    models = bundle_models(bundle)
    forms = {}
    if witness and m > 1:
        for key, mod in models.items():
            forms.update({f"{key}.{n}": f for n, f in tp_plan(mod, m, key)[1].items()})

    def cut(name, t):  # the witness's output as rank 0 holds it
        if not witness:
            return t
        if name in forms and forms[name][0] == "column":
            t = t.index_select(-1, layers.column_part(t.shape[-1], m, 0, forms[name][1]).to(t.device))
        elif m > 1 and name.endswith("ff_geglu") and f"{name}.proj" in forms:
            t = t[..., :t.shape[-1] // m]
        if name.startswith("text") or piece[0] is not None:
            return t  # every prompt on every rank; inside GMFlow, rank 0's frames already
        chunk = 2 if name.startswith(("unet", "controlnet")) or name == "gmflow" else 1
        if d > 1 and t.shape[0] % (chunk * d) == 0:
            t = local_frames(t, Mesh(d, 1, 0), chunk)
        return t

    def hook(name):
        def fn(mod, args, out):
            if state["unet"] >= N_UNET_CALLS or (witness and piece[0] not in (None, 0)):
                return
            for i, o in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.is_floating_point():
                    o = cut(name, o)
                    rec.append((name, i, tuple(o.shape), fingerprint(o)))
            if name == f"unet.{probe}" and "x" not in dumps:
                dumps.update(x=args[0].detach().cpu(), y=out.detach().cpu(), w=mod.weight.detach().cpu(),
                             b=None if mod.bias is None else mod.bias.detach().cpu())
        return fn

    handles = []
    for key, mod in models.items():
        named = dict(mod.named_modules())
        inner = {f"{n}.{c}" for n, sub in named.items() if isinstance(sub, CrossAttention)
                 for c, _ in sub.named_modules() if c}
        for n, sub in named.items():
            if n not in inner:
                handles.append(sub.register_forward_hook(hook(f"{key}.{n}" if n else key)))

    def unet_done(mod, args, out):
        state["unet"] += 1

    handles.append(bundle.unet.register_forward_hook(unet_done))
    return rec, lambda: [h.remove() for h in handles]


def run(dev, mesh_shape, witness_shape, probe: str, tiny: bool, res: int):
    """One opt-off batch on this process's mesh (or as the witness of
    ``witness_shape``), GMFlow the flow source: (record, latents, the
    probe's tensors)."""
    from fresco_torch.parallel.smoke import rank_sized_layers
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models

    cfg = cs.music_config(mesh_shape=tuple(mesh_shape), resolution=res, use_fresco_opt=False, **cs.MESH_STEPS)
    bundle = build_models(cfg, tiny=tiny, seed=0, device=dev, random_aux_weights=True)
    frames, _, detector = cs.make_inputs(0, cs.MESH_FRAMES, res)
    bundle.detector = detector
    pipe = FrescoPipeline(cfg, bundle)
    prompts, negs = cs.prompts_for(cfg, cs.MESH_FRAMES)
    dumps: dict = {}
    with rank_sized_layers(bundle, *witness_shape) if witness_shape else contextlib.nullcontext([None]) as piece:
        rec, remove = _record(bundle, witness_shape or mesh_shape, witness_shape is not None, probe, dumps, piece)
        latents, _ = pipe._translate_batch(frames, prompts, negs, None, False)
    remove()
    return rec, latents.float().cpu(), dumps


def _rank(rank, dev, shape, probe, tiny, res):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        from fresco_torch import kernels

        kernels.load()
    else:
        torch.set_num_threads(1)
    return run(dev, shape, None, probe, tiny, res)


def take_apart(w: dict, r: dict, dev, d: int) -> dict:
    """The probed convolution: witness vs rank 0 on its input and output,
    then recomputed here on rank 0's input in several batch layouts."""
    import torch.nn.functional as F

    from fresco_torch.core.comm import Mesh, local_frames

    mesh = Mesh(d, 1, 0)
    wt, b = r["w"].to(dev), None if r["b"] is None else r["b"].to(dev)

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), wt, b, 1, 1).permute(0, 2, 3, 1).cpu()

    whole = w["x"].to(dev)
    fl = r["x"].shape[0] // 2  # rank 0's frames a chunk
    ranked = conv(r["x"].to(dev))
    layouts = {"whole batch": local_frames(conv(whole), mesh, 2),
               "contiguous half": torch.cat([conv(h)[:fl] for h in whole.chunk(2)]),
               "rank 0's rows, fresh": ranked,
               "rank 0's rows, again": conv(r["x"].to(dev))}
    out = {"input_equal": torch.equal(local_frames(w["x"], mesh, 2), r["x"]),
           "output_equal": torch.equal(local_frames(w["y"], mesh, 2), r["y"]),
           "layouts_equal_to_rank": {k: torch.equal(v, r["y"]) for k, v in layouts.items()},
           "max_abs_vs_rank": {k: float((v.float() - r["y"].float()).abs().max()) for k, v in layouts.items()}}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="2x1,1x2,2x2")
    ap.add_argument("--probe", default="down_2_res_0.conv2")
    ap.add_argument("--cpu", action="store_true", help="tiny models at 64 px on the CPU (a rehearsal)")
    ap.add_argument("--out", help="write the report here as JSON")
    args = ap.parse_args()
    from fresco_torch import kernels
    from fresco_torch.parallel.distributed import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu:
        dev, card = torch.device("cpu"), "CPU"
        torch.set_num_threads(1)  # as each rank runs
    else:
        dev = torch.device("cuda", 0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
        kernels.load()
    print(card, flush=True)
    res = 64 if args.cpu else 512
    report = {"card": card}
    for shape in (tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")):
        t0 = time.perf_counter()
        w_rec, w_lat, w_dump = run(dev, (1, 1), shape, args.probe, args.cpu, res)
        ranks = launch(_rank, shape[0] * shape[1], shape, args.probe, args.cpu, res, device=dev.type, timeout_s=600)
        r_rec, r_lat, r_dump = ranks[0]
        wit: dict = {}
        for name, i, shp, fp in w_rec:
            wit.setdefault((name, i), []).append((shp, fp))
        seen: dict = {}
        same, differ = 0, []
        for name, i, shp, fp in r_rec:
            k = seen[(name, i)] = seen.get((name, i), -1) + 1
            cands = wit.get((name, i), [])
            if k < len(cands) and cands[k] == (shp, fp):
                same += 1
            else:
                differ.append(f"{name}[{i}] call {k}")
        row = {"latent_rel": float((r_lat - w_lat).norm() / w_lat.norm()), "calls": len(r_rec),
               "witness_calls": len(w_rec), "same": same, "differ": len(differ), "first_differing": differ[:10]}
        if shape[1] == 1 and shape[0] > 1 and w_dump and r_dump:
            row["probe"] = {"module": args.probe, **take_apart(w_dump, r_dump, dev, shape[0])}
        report[str(shape)] = row
        print(f"mesh {shape}: rank 0 vs witness latents rel fro {row['latent_rel']:.3e}; module calls {len(r_rec)} "
              f"(witness {len(w_rec)}), {same} equal, {len(differ)} differ; first: {differ[:3]}; "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        if "probe" in row:
            print(f"  probe {args.probe}: {json.dumps(row['probe'])}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
