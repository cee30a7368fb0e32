"""The mesh dry run: the training step and the whole sampler over n ranks,
each against its single-process run, then an interval wave of propagation.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:
69-230``).  ``dryrun_multichip(n)`` spawns n ranks (``distributed.launch``)
on a ``(data, model)`` mesh with ``model = 2`` where n is even, and runs:

  1. the UNet training step on a frame batch over ``data`` with the UNet
     split over ``model``: the loss and every rank's gradients (and, on the
     CPU, its parameters after the step) against the single-process step;
  2. ``smoke.run_full_sampler`` sharded against the single process (run
     here, in the calling process, without a process group), with the
     UNet, ControlNet, VAE, text encoder and GMFlow (the flow source) split
     over ``model``; each rank prints its split layers per model;
  3. an interval wave (``propagate/parallel.run_jobs``, one patch-synthesis
     job a card where n cards are visible, else all on one device)
     against the serial ``synthesize`` of its first job.

On the CPU (gloo) the model stack is tiny and float64, and step 2 holds
sharded == single within ``atol = rtol = 1e-5``, as the JAX dry run does
(``__graft_entry__.py:160-169``).  The card's kernels take bf16 only, so
with ``device="cuda"`` the widths are ``smoke.small_bundle``'s (head dims
16 and 32), the sampler runs in bf16 and the training step in bf16 compute
on float32 parameters, every rank on ``cuda:{rank % cards}`` (one card:
all of them, over gloo).  There kernels run at a rank's shapes round
otherwise, and the sampler's sign and threshold discontinuities amplify
that, so step 2 also runs the witness (``smoke.rank_sized_layers``: one
process doing a rank's arithmetic, no collective) and holds the sharded
latents to it (``CARD_WITNESS_REL``) as well as to the single run
(``CARD_SAMPLER_REL``, relative Frobenius); ``CARD_TRAIN_REL`` bounds the
loss's relative error and each gradient's max |d| / max |g|.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fresco_torch.core.comm import Mesh
from fresco_torch.parallel.distributed import launch
from fresco_torch.parallel.smoke import run_full_sampler, small_unet_config

CPU_ATOL = CPU_RTOL = 1e-5      # float64, as __graft_entry__.py:164
CPU_TRAIN_ATOL = 1e-10          # float64 parameters after one AdamW step
# bf16 on the card (H100 80GB HBM3, 700 W).  The witness (smoke.rank_sized_layers:
# one process doing a rank's arithmetic, no collective) reads 2.69e-2 from the
# single run, as the sharded run does; the sharded run reads 9.88e-7 from the
# witness (the feature optimization's sums over data ranks).  Read: loss 2.5e-4,
# gradients 4.69e-2 at most.  The bounds leave about 2x, the witness's 10x.
CARD_SAMPLER_REL = 6e-2         # latents vs single, relative Frobenius
CARD_WITNESS_REL = 1e-5         # latents vs the witness, relative Frobenius
CARD_TRAIN_REL = 0.1            # the loss, and each gradient's max |d| / max |g|


def _sampler_kw(data: int, device: str) -> dict:
    """The sampler's batch (its dtype and widths follow the device)."""
    return dict(frames=2 * data, res=64 if device == "cuda" else 32, steps=3, opt_iters=1, two_batches=False)


def _train_case(mesh: Mesh | None, dev: torch.device, frames: int, seed: int = 0):
    """One UNet training step on ``frames`` latents: (loss, {name: parameter
    after the step}, {name: its gradient})."""
    from fresco_torch.diffusion.scheduler import DDPMScheduler
    from fresco_torch.models.layers import init_flax_default_, set_compute_dtype
    from fresco_torch.models.unet import UNet2DCondition, UNetConfig
    from fresco_torch.parallel.sharding import shard_model_params
    from fresco_torch.parallel.train import make_train_state, train_step

    cuda = dev.type == "cuda"
    ucfg = small_unet_config() if cuda else UNetConfig.tiny()
    gen = torch.Generator().manual_seed(seed)
    unet = init_flax_default_(UNet2DCondition(ucfg), gen)
    unet = unet.to(dev) if cuda else unet.double()
    if cuda:
        set_compute_dtype(unet, torch.bfloat16)
    if mesh is not None and mesh.model > 1:
        shard_model_params(unet, mesh, "unet")
    dt = torch.float32 if cuda else torch.float64
    latents = torch.randn((frames, 8, 8, 4), generator=gen, dtype=dt).to(dev)
    ctx = torch.randn((frames, 7, ucfg.cross_attention_dim), generator=gen, dtype=dt).to(dev)
    state = make_train_state(unet, lr=1e-4)
    state, loss = train_step(state, DDPMScheduler(num_inference_steps=4), latents, ctx, seed=seed, mesh=mesh)
    return (float(loss), {k: v.detach().clone().cpu() for k, v in unet.named_parameters()},
            {k: v.grad.detach().clone().cpu() for k, v in unet.named_parameters()})


def _rank(rank: int, dev: torch.device, data: int, model: int, device: str) -> dict:
    from fresco_torch import kernels
    from fresco_torch.parallel.sharding import make_mesh

    mesh = make_mesh(data, model)
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss, params, grads = _train_case(mesh, dev, 2 * data)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    report: dict = {}
    latents = run_full_sampler((data, model), device=dev, report=report, **_sampler_kw(data, device))
    return {"loss": loss, "params": params, "grads": grads, "latents": latents, "train_s": t_train,
            "sampler_s": time.perf_counter() - t0, "launches": kernels.launches(), "model_rank": mesh.model_rank,
            "split": report["split"]}


def _expected_params(single: dict, model: int, model_rank: int, dev) -> dict:
    """The single step's parameters as rank ``model_rank`` of a model axis
    of ``model`` holds them (the split applied to a copy)."""
    from fresco_torch.models.unet import UNet2DCondition, UNetConfig
    from fresco_torch.parallel.sharding import shard_model_params

    ucfg = small_unet_config() if dev == "cuda" else UNetConfig.tiny()
    unet = UNet2DCondition(ucfg)
    for k, p in unet.named_parameters():
        p.data = single[k].clone()
    if model > 1:
        shard_model_params(unet, Mesh(1, model, model_rank), "unet")
    return {k: v.detach() for k, v in unet.named_parameters()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a.double() - b.double()).abs().max() / max(float(b.double().abs().max()), 1e-30))


def _wave_check(n_jobs: int, dev: torch.device) -> dict:
    """``n_jobs`` synthesize jobs as one wave, one job a card where that
    many cards are visible (else all on ``dev``), against the serial run of
    job 0 on ``dev``: the NNF bit for bit, the output within 1e-4; on the
    card, row_gather and patch_eval must launch on every card of the wave."""
    from fresco_torch import kernels
    from fresco_torch.propagate.parallel import run_jobs
    from fresco_torch.propagate.patchmatch import PatchMatchConfig, TorchDraws, synthesize

    cfg = PatchMatchConfig(patch_size=5, pm_iters=2, sv_iters=2, num_pyramid_levels=2)
    rng = np.random.default_rng(0)
    hw = 40
    styles = rng.uniform(0, 255, (n_jobs, hw, hw, 3)).astype(np.float32)
    src = rng.uniform(0, 255, (n_jobs, hw, hw, 3)).astype(np.float32)
    tgt = np.stack([np.roll(src[i], 2 + i, axis=0) for i in range(n_jobs)])
    cuda = dev.type == "cuda"
    devs = ([torch.device("cuda", i) for i in range(n_jobs)] if cuda and torch.cuda.device_count() >= n_jobs
            else [dev] * n_jobs)

    def job(i, d):
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(d)  # noqa: E731
        gw = torch.full((3,), 2.0, device=d)
        return lambda: synthesize(t(styles[i]), t(src[i]), t(tgt[i]), gw, cfg, draws=TorchDraws(11 + i, d))

    kernels.reset_launches()
    waved = run_jobs(devs, [job(i, d) for i, d in enumerate(devs)])
    by_card = {name: n for name, n in kernels.launches_by_card().items() if name in ("row_gather", "patch_eval")}
    out0, _, nnf0 = job(0, dev)()
    if not torch.equal(waved[0][2], nnf0):
        raise AssertionError("dryrun: the wave's NNF of job 0 differs from the serial run")
    err = float((waved[0][0] - out0).abs().max())
    if err > 1e-4:
        raise AssertionError(f"dryrun: the wave's output of job 0 differs from the serial run by {err}")
    if cuda and any(by_card[name].get(d.index, 0) <= 0 for name in by_card for d in devs):
        raise AssertionError(f"dryrun: a propagation kernel did not launch on every card of the wave: {by_card}")
    return {"jobs": n_jobs, "max_abs": err, "devices": [str(d) for d in devs], "launches_by_card": by_card}


def dryrun_multichip(n_devices: int, device: str | None = None, *, verbose: bool = True) -> dict:
    """Spawn ``n_devices`` ranks on a ``(data, model)`` mesh and run the
    three checks of the module docstring; raises where one fails.  Returns
    the readings: losses, errors, walls and each rank's launches.
    ``device``: "cuda" or "cpu" (``None``: the card; it raises without one)."""
    from fresco_torch.pipeline.runner import resolve_device

    device = resolve_device(device).type
    t_start = time.time()

    def say(msg: str) -> None:
        if verbose:
            print(f"[dryrun +{time.time() - t_start:5.1f}s] {msg}", flush=True)

    model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data = n_devices // model
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    say(f"mesh ({data} data x {model} model) over {n_devices} ranks on {device}")
    single_loss, single_params, single_grads = _train_case(None, dev, 2 * data)
    kw = _sampler_kw(data, device)
    single = run_full_sampler((1, 1), device=dev, **kw)
    say(f"single process: train loss {single_loss:.6f}, sampler latents {single.shape}")
    out = {"mesh": (data, model), "ranks": []}
    if device == "cuda":  # a rank's arithmetic in one process (smoke.rank_sized_layers)
        witness = run_full_sampler((1, 1), device=dev, witness=(data, model), **kw)
        out["witness_err"] = _rel(witness, single)
        say(f"witness (one process, a rank's arithmetic): sampler latents rel fro vs single {out['witness_err']:.2e}")
    ranks = launch(_rank, n_devices, data, model, device, device=device)
    for r, res in enumerate(ranks):
        expect = _expected_params(single_params, model, res["model_rank"], device)
        g_expect = _expected_params(single_grads, model, res["model_rank"], device)
        if device == "cuda":  # gradients (AdamW's first step is sign(g) where |g| >> eps: ill-conditioned)
            p_err = max(_max_rel(res["grads"][k], g_expect[k]) for k in g_expect if g_expect[k].abs().max() > 0)
            loss_err = abs(res["loss"] - single_loss) / abs(single_loss)
            lat_err = _rel(res["latents"], single)
            wit_err = _rel(res["latents"], witness)
            ok = p_err <= CARD_TRAIN_REL and loss_err <= CARD_TRAIN_REL and lat_err <= CARD_SAMPLER_REL
            ok = ok and wit_err <= CARD_WITNESS_REL
        else:
            p_err = max(float((res[n][k] - ref[k]).abs().max()) for n, ref in (("params", expect), ("grads", g_expect))
                        for k in ref)
            loss_err = abs(res["loss"] - single_loss)
            lat_err = float(np.abs(res["latents"] - single).max())
            ok = p_err <= CPU_TRAIN_ATOL and loss_err <= CPU_TRAIN_ATOL
            ok = ok and np.allclose(res["latents"], single, atol=CPU_ATOL, rtol=CPU_RTOL)
        row = {"rank": r, "loss": res["loss"], "loss_err": loss_err, "param_err": p_err, "latent_err": lat_err,
               "train_s": res["train_s"], "sampler_s": res["sampler_s"], "launches": res["launches"],
               "split": res["split"]}
        vs_witness = ""
        if device == "cuda":
            row["witness_err"] = wit_err
            vs_witness = f", vs witness {wit_err:.2e}"
        out["ranks"].append(row)
        say(f"rank {r}: train loss {res['loss']:.6f} (err {loss_err:.2e}, gradients {p_err:.2e}), sampler "
            f"sharded vs single {'rel fro' if device == 'cuda' else 'max |d|'} {lat_err:.2e}{vs_witness}, "
            f"{res['train_s']:.2f} + {res['sampler_s']:.2f} s, launches {res['launches']}; layers split over model: "
            + ", ".join(f"{k} {v['split']}/{v['layers']}" for k, v in res["split"].items()))
        if not ok:
            raise AssertionError(f"dryrun: rank {r} differs from the single process: {row}")
    say("1/3 sharded train step == single; 2/3 sampler sharded == single")
    out["wave"] = _wave_check(min(n_devices, 4), dev)
    say(f"3/3 propagation wave of {out['wave']['jobs']} jobs on {', '.join(out['wave']['devices'])} == serial "
        f"(max |d| {out['wave']['max_abs']:.2e}); launches by card {out['wave']['launches_by_card']}")
    out["single_loss"] = single_loss
    return out


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4, sys.argv[2] if len(sys.argv) > 2 else None)
