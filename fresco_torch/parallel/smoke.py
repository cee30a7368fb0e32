"""The whole FRESCO sampler on a mesh, to hold against the single process.

Counterpart of ``fresco_tpu/parallel/smoke.py``: one synthetic batch
through the real ``FrescoPipeline`` batch path (parameter prep, then the
sampler with cross-frame, spatial-guided and trajectory attention, feature
optimization, background smoothing on a stubbed saliency, record and
restore) on tiny models, over a ``(data, model)`` mesh of ranks or on one
process, so that the sharded run can be held equal to the single one.

Why float64: the sampler's sign and threshold discontinuities (the L1
losses of the feature optimization's Adam loop at lr 0.2, the occlusion
thresholds) amplify any reassociation difference between a sharded and a
single run (in float32 to O(1e-2)); in float64 it is ~1e-16 and almost
never crosses one, so sharded == single holds tightly.  The card's kernels
take bf16 only, so the float64 mode runs on the CPU, where the caller asks
for it (``device="cpu"``).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def rank_sized_layers(bundle, data: int = 1, model: int = 1):
    """A rank's arithmetic of a ``(data, model)`` mesh in one process, with
    no collective, so that a sharded run can be held against a single one
    that rounds as a rank does:

      * each layer of the UNet, ControlNet, VAE, text encoder and GMFlow
        that the mesh splits over ``model`` (``sharding.tp_plan``) computes
        every model rank's part and joins them as its collective would
        (output parts, the split convolutions' included, put back in place;
        the row forms' partial products summed in float32, rounded once, in
        model-rank order); the text cross-attention, trajectory attention
        and the text encoder's attention run each model rank's heads on
        their own;
      * every ``Conv2d``, ``Dense``, ``GroupNorm32``, ``LayerNorm32`` and
        text cross-attention of the UNet, VAE and ControlNet, and GMFlow as
        a whole, run each data rank's frames of a chunk-major batch on their
        own, in the rank's row order, and trajectory attention computes each
        data rank's query frames on their own.

    Every other operation is per element, per frame or per attention row,
    or sees the whole batch on a rank as well (the text encoder runs every
    prompt on every rank).  Yields ``[data rank]``: the data rank whose
    frames run at the moment inside a layer or model cut by frames, else
    ``[None]``."""
    from fresco_torch.attention import fresco_attention as fa
    from fresco_torch.core.comm import Mesh, local_frames
    from fresco_torch.models import layers
    from fresco_torch.models.clip_text import CLIPAttention
    from fresco_torch.models.unet import CrossAttention
    from fresco_torch.parallel.sharding import bundle_models, tp_plan

    inside = [0]  # the depth of batch splits: a layer inside a split one runs its piece whole
    piece = [None]
    groups = lambda heads: model if heads % model == 0 else 1  # noqa: E731  (tp_plan's rule)

    def split_model(layer, mode, geglu):
        op = layer._conv if isinstance(layer, layers.Conv2d) else layers._linear

        def forward(x):
            w, b = layers._in_compute_dtype(layer)
            if mode in ("column", "column_gather"):
                idx = [layers.column_part(w.shape[0], model, r, geglu).to(w.device) for r in range(model)]
                y = torch.cat([op(x, w[i].contiguous(), None if b is None else b[i]) for i in idx], -1)
                return y[..., torch.argsort(torch.cat(idx))]
            n = w.shape[1] // model
            parts = [op(x[..., r * n:(r + 1) * n].contiguous(), w[:, r * n:(r + 1) * n].contiguous(), None)
                     for r in range(model)]
            y = torch.stack([p.float() for p in parts]).sum(0).to(parts[0].dtype)
            return y if b is None else y + b

        return forward

    def heads_apart(attn, attend, *extra):
        """``attend(q, k, v, *extra, heads)`` on each model rank's heads."""
        def run(q, k, v):
            g = groups(attn.heads)
            n = q.shape[-1] // g
            return torch.cat([attend(*(t[..., r * n:(r + 1) * n].contiguous() for t in (q, k, v)), *extra,
                                     attn.heads // g) for r in range(g)], -1)

        return run

    def cross_heads(attn):
        def forward(x, context):
            return attn.to_out(heads_apart(attn, attn.attend)(attn.to_q(x), attn.to_k(context), attn.to_v(context)))

        return forward

    def text_heads(attn):
        def forward(x, causal_mask):
            qkv = attn.q_proj(x), attn.k_proj(x), attn.v_proj(x)
            return attn.out_proj(heads_apart(attn, attn.attend, causal_mask)(*qkv))

        return forward

    def split_batch(fwd, chunk: int, out_chunk: int | None = None):
        """``fwd`` on each data rank's frames of a chunk-major batch, its
        rows where the rank holds them (a kernel may round a row by its
        place in the batch), the outputs (``out_chunk`` chunks each, by
        default ``chunk``) put back in chunk-major order."""
        if data == 1:
            return fwd

        def forward(x, *a, **k):
            n = x.shape[0]
            if inside[0] or n % (chunk * data):
                return fwd(x, *a, **k)
            inside[0] += 1
            outs = []
            try:  # every tensor argument of the same batch is cut alike (the text context)
                cut = [[local_frames(t, Mesh(data, 1, r), chunk) for r in range(data)]
                       if isinstance(t, torch.Tensor) and t.shape[:1] == (n,) else [t] * data for t in (x, *a)]
                for r, p in enumerate(zip(*cut)):
                    piece[0] = r
                    outs.append(fwd(*p, **k))
            finally:
                inside[0] -= 1
                piece[0] = None
            oc = out_chunk or chunk
            return torch.stack([o.reshape(oc, -1, *o.shape[1:]) for o in outs], 1).reshape(-1, *outs[0].shape[1:])

        return forward

    def trajectory(q_raw, k_raw, hidden, fwd_map, bwd_map, traj_mask, chunk, heads, scale_factor, mesh=None):
        g = groups(heads)
        n = q_raw.shape[-1] // g
        f = q_raw.shape[0] // chunk
        outs = []
        for r in range(data):
            rank = Mesh(data, 1, r)  # only for its frame slice
            q_r, loc = (local_frames(q_raw, rank, chunk), rank.frame_slice(f)) if data > 1 else (q_raw, slice(None))
            heads_of = [[t[..., s * n:(s + 1) * n].contiguous() for t in (q_r, k_raw, hidden)] for s in range(g)]
            outs.append(torch.cat([fa.trajectory_frames(*h, fwd_map, bwd_map, traj_mask, loc, chunk, heads // g,
                                                        scale_factor) for h in heads_of], -1))
        # the ranks' frames back in chunk-major order
        return torch.stack([o.reshape(chunk, -1, *o.shape[1:]) for o in outs], 1).reshape(q_raw.shape)

    patched = set()

    def patch(m, fwd):
        m.forward = fwd
        patched.add(m)

    for key, mod in bundle_models(bundle).items():
        mods = dict(mod.named_modules())
        if model > 1:
            for name, (mode, geglu) in tp_plan(mod, model, key)[1].items():
                patch(mods[name], split_model(mods[name], mode, geglu))
        for m in mods.values():
            if isinstance(m, CrossAttention):
                patch(m, split_batch(cross_heads(m), 2))
            elif isinstance(m, CLIPAttention):
                patch(m, text_heads(m))
    kinds = (layers.Conv2d, layers.Dense, layers.GroupNorm32, layers.LayerNorm32)
    # the UNet and the ControlNet run the CFG pair (chunk 2), the VAE frames
    for mod, chunk in ((bundle.unet, 2), (bundle.vae, 1), (bundle.controlnet, 2)):
        for m in mod.modules():
            if isinstance(m, kinds):
                patch(m, split_batch(m.forward, chunk))
    if bundle.gmflow is not None:  # frames in, forward then backward flows out
        patch(bundle.gmflow, split_batch(bundle.gmflow.forward, 1, 2))
    traj, fa.trajectory_attention = fa.trajectory_attention, trajectory
    try:
        yield piece
    finally:
        fa.trajectory_attention = traj
        for m in patched:
            del m.forward


def run_full_sampler(
    mesh_shape: tuple[int, int] = (1, 1),
    *,
    frames: int = 4,
    res: int = 64,
    steps: int = 4,
    seed: int = 0,
    dtype: str | None = None,
    opt_iters: int = 2,
    two_batches: bool = True,
    verbose: bool = False,
    device: torch.device | str | None = None,
    widths: str | None = None,
    witness: tuple[int, int] | None = None,
    report: dict | None = None,
) -> np.ndarray:
    """Translate one synthetic batch through the real pipeline and return
    the final latents (whole, on every rank) as numpy.

    ``two_batches=True`` runs a second batch in propagation mode that
    consumes the first's latent record; ``two_batches=False`` runs one
    propagation-mode batch on a synthetic record, which exercises restore
    and record in one pass.  Over a mesh the process group must hold
    ``prod(mesh_shape)`` ranks (``parallel.distributed.launch``).
    ``device``: the card unless the CPU is asked for (``None``: this
    process's card; it raises without one).  ``dtype`` and ``widths``
    follow the device unless given: on the CPU "float64" and "tiny" (the
    tiny configs, head dim 4), on the card "bfloat16" and "small"
    (``small_bundle``: head dims 16 and 32, which the card's kernels
    take).  ``witness``: a single process that does a rank's arithmetic of
    that ``(data, model)`` mesh (``rank_sized_layers``).  ``report``, where
    given, receives the bundle's ``sharding.split_report`` under "split"."""
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline.runner import FrescoPipeline, frame_dtype, resolve_device

    device = resolve_device(device)
    on_cpu = device.type == "cpu"
    dtype = dtype or ("float64" if on_cpu else "bfloat16")
    widths = widths or ("tiny" if on_cpu else "small")
    say = print if verbose else (lambda *a, **k: None)
    config = FrescoConfig(
        mesh_shape=tuple(mesh_shape),
        resolution=res,
        batch_size=frames,
        num_inference_steps=steps,
        num_warmup_steps=1,
        end_opt_step=max(steps - 1, 1),
        bg_smoothing_steps=(steps - 2,),
        opt_iters=opt_iters,
        use_saliency=True,
        dtype=dtype,
        # an identity aux cast: bf16 aux forwards would round differently per
        # mesh and flip occlusion-threshold pixels
        aux_dtype="float32",
        prompt="a smoke test",
        seed=seed,
    )
    t0 = time.time()
    bundle = small_bundle(config, device, seed) if widths == "small" else None
    pipe = FrescoPipeline(config, bundle, tiny=True, device=device)
    # a stubbed saliency, so that background smoothing runs
    sal_dtype = frame_dtype(config)
    pipe.bundle.saliency_fn = lambda imgs: torch.full(
        (imgs.shape[0], res // 8, res // 8, 1), 0.5, dtype=sal_dtype, device=pipe.device)
    say(f"[smoke {mesh_shape}] models built {time.time() - t0:.1f}s")
    if report is not None:
        from fresco_torch.parallel.sharding import split_report

        report["split"] = split_report(pipe.bundle)

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (frames, res, res, 3)).astype(np.uint8)
    prompts = ["a smoke test"] * frames
    nprompts = ["bad"] * frames

    with rank_sized_layers(pipe.bundle, *witness) if witness else contextlib.nullcontext():
        if two_batches:
            t0 = time.time()
            latents, record = pipe._translate_batch(list(imgs), prompts, nprompts, None, False)
            say(f"[smoke {mesh_shape}] batch 1 (record) {time.time() - t0:.1f}s")
            t0 = time.time()
            latents2, _ = pipe._translate_batch(list(imgs), prompts, nprompts, record, True)
            say(f"[smoke {mesh_shape}] batch 2 (restore) {time.time() - t0:.1f}s")
            out = np.concatenate([latents.cpu().numpy(), latents2.cpu().numpy()])
        else:
            n_rec = steps - 1  # the steps after the one warmup step
            gen = torch.Generator(device=pipe.device).manual_seed(seed + 1)
            record = torch.randn((n_rec, 2, res // 8, res // 8, 4), generator=gen, device=pipe.device,
                                 dtype=frame_dtype(config))
            t0 = time.time()
            latents, record_out = pipe._translate_batch(list(imgs), prompts, nprompts, record, True)
            say(f"[smoke {mesh_shape}] batch (record+restore) {time.time() - t0:.1f}s")
            assert record_out.shape == record.shape
            out = latents.cpu().numpy()
    if not np.all(np.isfinite(out)):
        raise FloatingPointError("the sampler produced non-finite latents")
    return out


def small_unet_config():
    """UNet / ControlNet widths 32 and 64, two heads (head dims 16 and 32)."""
    from fresco_torch.models.clip_text import CLIPTextConfig
    from fresco_torch.models.unet import UNetConfig

    return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      cross_attention_dim=CLIPTextConfig.tiny().hidden_size, attention_heads=2, norm_groups=8,
                      fresco_up_blocks=(1,))


def small_bundle(config, device: torch.device, seed: int = 0):
    """A model stack at small widths (``small_unet_config``, a VAE of widths
    32 / 64, the tiny text encoder and GMFlow) with random weights drawn
    from a CPU generator seeded with ``seed``, in ``config.dtype``."""
    from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from fresco_torch.models.controlnet import ControlNet
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.layers import cast_model, init_flax_default_
    from fresco_torch.models.unet import UNet2DCondition
    from fresco_torch.models.vae import AutoencoderKL, VAEConfig
    from fresco_torch.pipeline.runner import ModelBundle, model_dtype
    from fresco_torch.pipeline.text import HashTokenizer

    ucfg, ccfg = small_unet_config(), CLIPTextConfig.tiny()
    gen = torch.Generator().manual_seed(seed)
    mods = [UNet2DCondition(ucfg), AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
                                                           norm_groups=8)),
            ControlNet(ucfg, (16, 16, 32, 32)), CLIPTextEncoder(ccfg), GMFlow(GMFlowConfig.tiny())]
    for m in mods:
        init_flax_default_(m, gen)
    dt = model_dtype(config)
    unet, vae, cn = (cast_model(m, dt).to(device).eval().requires_grad_(False) for m in mods[:3])
    text, gm = (m.to(device).eval().requires_grad_(False) for m in mods[3:])

    def edges(img):
        g = img.astype(np.float32).mean(-1)
        e = np.abs(np.diff(g, axis=0, prepend=g[:1])) + np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
        return np.clip(e * 4, 0, 255).astype(np.uint8)

    return ModelBundle(unet, vae, cn, text, HashTokenizer(ccfg.vocab_size), edges, device, gmflow=gm)
