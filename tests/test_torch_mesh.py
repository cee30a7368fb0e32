"""The port's device mesh (``fresco_torch/parallel/``) on the CPU: gloo worlds
of 2 and 4 spawned ranks, each piece sharded against the same piece run
whole in this process.

One world per mesh shape, (2, 1), (1, 2), (2, 2) and (4, 1), spawned once
in a module fixture (``parallel.distributed.launch``, a FileStore under
``tmp_path``, one torch thread a rank); every rank runs every check and
returns its readings, and the tests compare them here.  This file imports
no JAX, so that the ranks import it cheaply.

Tolerances.  Float64 pieces (the frame gather and its gradient, the
cross-frame, maskless and trajectory attentions, the temporal loss and its
gradient, the gram gradient, ``warp_and_fuse``, the tiny UNet forward and
the UNet training step's gradients and parameters) to 1e-10 absolute:
they differ from the whole by summation order only (measured: ~1e-15).
``run_full_sampler`` in float64 within atol = rtol = 1e-5 of the (1, 1)
run, as the JAX dry run holds it (``__graft_entry__.py:160-169``): the text
encoder and GMFlow compute in float32 in every mode, and split over
``model`` they round otherwise (read: 2.35e-7 in the (2, 2) dry run); in
bf16 within 1e-6 relative of one process doing a rank's arithmetic
(``smoke.rank_sized_layers``; read: bit for bit).  The
GMFlow step computes in float32 (``models/gmflow``): its loss to 1e-5
relative and its summed gradients to 1e-5 of the model's largest
gradient (summation order over the ranks; the downsample biases, which the
instance norm after them cancels, have gradients of rounding noise,
~1e-9).  The VAE and the text encoder split over ``model`` in float64 to 1e-5 of
the whole model's outputs, GMFlow's float32 flows to 1e-5 of the largest
flow.  The
loader's slices and the training script's ``--data-par 2``
batches are exact; its parameters after two steps are held to
2·(lr_0 + lr_1), the most AdamW moves an element whose gradient is
rounding noise (the bound of ``tests/test_torch_flow_train.py``), and its
logged losses to 1e-5.
"""
import numpy as np
import pytest
import torch

from fresco_torch.core import comm
from fresco_torch.parallel.distributed import launch

SHAPES = [(2, 1), (1, 2), (2, 2), (4, 1)]
F, HW, C, CHUNK, HEADS = 4, 16, 8, 2, 2
ATOL = 1e-10
SAMPLER_KW = dict(frames=4, res=32, steps=3, opt_iters=1, two_batches=False, device="cpu")
SCRIPT_ARGS = ["--synthetic", "--tiny", "--steps", "2", "--batch-size", "2", "--log-every", "1", "--device", "cpu"]


def _inputs():
    """Seeded float64 inputs of the frame-coupling pieces (whole batch)."""
    from fresco_torch.diffusion.guidance import warp_matrix

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    h = w = 4
    flows = r(F, h, w, 2) * 1.5
    occ = (torch.rand(F, h, w, generator=g) > 0.7).double()
    mask = torch.rand(F, HW, generator=g) > 0.4
    mask[0] = True
    flat = mask.reshape(-1).numpy()
    perm = np.argsort(~flat, kind="stable")[:40]
    fwd_map = torch.stack([torch.randperm(HW, generator=g) for _ in range(F)])
    bwd_map = torch.argsort(fwd_map, dim=1)
    return dict(
        x=r(CHUNK * F, 3, 5), wts=r(CHUNK * F, 3, 5),
        q=r(CHUNK * F, HW, C), k=r(CHUNK * F, HW, C), v=r(CHUNK * F, HW, C),
        mask=mask, perm=(torch.as_tensor(perm), torch.as_tensor(flat[perm])),
        fwd_map=fwd_map, bwd_map=bwd_map, traj_mask=torch.rand(HW, F, F, generator=g) > 0.3,
        cs=r(CHUNK * F, h, w, C), fwd_warp=warp_matrix(flows, torch.float64),
        bwd_warp=warp_matrix(-flows, torch.float64), fwd_occ=occ[..., None], bwd_occ=occ.flip(0)[..., None],
        vhat=torch.nn.functional.normalize(r(CHUNK * F, HW, C), dim=-1), corr=r(CHUNK * F, HW, C) * 0.3,
        sample=r(CHUNK * F, 8, 8, C), flow8=r(F, 8, 8, 2), bflow8=r(F, 8, 8, 2),
        occ8=(torch.rand(F, 8, 8, generator=g) > 0.8).double(), bocc8=(torch.rand(F, 8, 8, generator=g) > 0.8).double(),
        sal=torch.rand(F, 4, 4, 1, generator=g, dtype=torch.float64),
        latents=r(CHUNK * F, 8, 8, 4), ctx=r(CHUNK * F, 7, 32),
    )


def _tiny_unet():
    from fresco_torch.models.layers import init_flax_default_
    from fresco_torch.models.unet import UNet2DCondition, UNetConfig

    cfg = UNetConfig.tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "cross_attention_dim": 32})
    return init_flax_default_(UNet2DCondition(cfg), torch.Generator().manual_seed(3)).double().eval()


def _pieces(inp, mesh):
    """Every frame-coupling piece on ``mesh`` (``None``: whole): this rank's
    outputs (and gradients)."""
    from fresco_torch.attention import fresco_attention as fa
    from fresco_torch.diffusion import guidance as gd
    from fresco_torch.ops.blend import warp_and_fuse

    m = mesh or comm.Mesh()
    loc = lambda t, chunk=CHUNK: comm.local_frames(t, m, chunk)  # noqa: E731
    sl = m.frame_slice(F)
    out = {}
    x = loc(inp["x"]).clone().requires_grad_(True)
    whole = comm.gather_frames(x, m, CHUNK)
    out["gather"] = whole.detach()
    own = comm.local_frames(whole * inp["wts"], m, CHUNK).sum()  # this rank's terms only
    (out["gather_grad_own"],) = torch.autograd.grad(own, x, retain_graph=True)
    (out["gather_grad_all"],) = torch.autograd.grad((whole * inp["wts"]).sum(), x)
    q, k, v = loc(inp["q"]), loc(inp["k"]), loc(inp["v"])
    out["cf"] = fa.cross_frame_attention(q, k, v, inp["mask"], CHUNK, HEADS, mesh=mesh)
    out["cf_perm"] = fa.cross_frame_attention(q, k, v, inp["mask"], CHUNK, HEADS, key_perm=inp["perm"], mesh=mesh)
    out["cf_maskless"] = fa.cross_frame_attention(q, k, v, None, CHUNK, HEADS, mesh=mesh)
    out["traj"] = fa.trajectory_attention(q, k, v, inp["fwd_map"], inp["bwd_map"], inp["traj_mask"], CHUNK, HEADS,
                                          0.2, mesh=mesh)
    cs = loc(inp["cs"]).clone().requires_grad_(True)
    loss = gd.temporal_loss(cs, inp["fwd_warp"][sl], inp["bwd_warp"][sl], inp["fwd_occ"][sl], inp["bwd_occ"][sl],
                            CHUNK, mesh)
    (out["temporal_grad"],) = torch.autograd.grad(loss, cs)
    out["temporal_loss"] = comm.all_reduce_sum(loss.detach(), m.data_group, m.data)
    vh, corr = loc(inp["vhat"]), loc(inp["corr"])
    out["gram"] = gd._gram_l1_grad(vh, corr, torch.float64, 7, False, CHUNK * F)
    dense = torch.matmul(corr, corr.transpose(1, 2))
    out["gram_dense"] = gd._gram_l1_grad(vh, dense, torch.float64, 7, True, CHUNK * F)
    out["fuse"] = warp_and_fuse(loc(inp["sample"]), inp["flow8"], inp["bflow8"], inp["occ8"], inp["bocc8"],
                                inp["sal"], chunk=CHUNK, mesh=mesh)
    return out


def _unet_forward(inp, mesh):
    from fresco_torch.parallel.sharding import shard_model_params

    unet = _tiny_unet()
    m = mesh or comm.Mesh()
    if m.model > 1:
        shard_model_params(unet, m, "unet")
    with torch.no_grad():
        return unet(comm.local_frames(inp["latents"], m), 500, comm.local_frames(inp["ctx"], m))


def _unet_step(inp, mesh):
    """One float64 training step: (loss, gradients, parameters), this rank's parts."""
    from fresco_torch.diffusion.scheduler import DDPMScheduler
    from fresco_torch.parallel.sharding import shard_model_params
    from fresco_torch.parallel.train import make_train_state, train_step

    unet = _tiny_unet().train()
    m = mesh or comm.Mesh()
    if m.model > 1:
        shard_model_params(unet, m, "unet")
    state = make_train_state(unet, lr=1e-3)
    _, loss = train_step(state, DDPMScheduler(num_inference_steps=4), inp["latents"], inp["ctx"], seed=5, mesh=mesh)
    return (float(loss), {n: p.grad.clone() for n, p in unet.named_parameters()},
            {n: p.detach().clone() for n, p in unet.named_parameters()})


def _gmflow_step(mesh):
    """One supervised GMFlow step (float32) on this rank's slice of a batch of 4."""
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.layers import init_flax_default_
    from fresco_torch.parallel.flow_train import flow_train_step, make_flow_train_state

    g = torch.Generator().manual_seed(9)
    model = init_flax_default_(GMFlow(GMFlowConfig.tiny()), g)
    img0, img1 = torch.rand(4, 32, 32, 3, generator=g) * 255, torch.rand(4, 32, 32, 3, generator=g) * 255
    flow, valid = torch.randn(4, 32, 32, 2, generator=g), torch.ones(4, 32, 32)
    m = mesh or comm.Mesh()
    sl = m.frame_slice(4)
    state = make_flow_train_state(model, steps=4)
    _, loss = flow_train_step(state, img0[sl], img1[sl], flow[sl], valid[sl], mesh=mesh)
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}


def _loader(mesh):
    from fresco_torch.parallel import flow_data as fd
    from fresco_torch.scripts.train_gmflow import SyntheticIndex

    return [b["img0"] for b in fd.FlowLoader(SyntheticIndex(size=8, hw=(8, 8), seed=1), 4, seed=2, mesh=mesh,
                                             device="cpu")]


def _three_models(mesh):
    """The tiny VAE (encoder moments, decoder) and text encoder in float64
    and GMFlow (float32, as it always computes) on seeded inputs, split over
    ``mesh.model`` (``None``: whole): ({output: tensor}, {model: parameter
    bytes on this rank})."""
    from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.layers import init_flax_default_
    from fresco_torch.models.vae import AutoencoderKL, VAEConfig
    from fresco_torch.parallel.sharding import shard_model_params

    g = torch.Generator().manual_seed(11)
    mods = {"vae": init_flax_default_(AutoencoderKL(VAEConfig.tiny()), g).double(),
            "text": init_flax_default_(CLIPTextEncoder(CLIPTextConfig.tiny()), g).double(),
            "gmflow": init_flax_default_(GMFlow(GMFlowConfig.tiny()), g)}
    x = torch.rand(2, 32, 32, 3, generator=g, dtype=torch.float64) * 2 - 1
    z = torch.randn(2, 4, 4, 4, generator=g, dtype=torch.float64)
    ids = torch.randint(0, CLIPTextConfig.tiny().vocab_size, (2, 77), generator=g)
    img0, img1 = torch.rand(1, 32, 48, 3, generator=g) * 255, torch.rand(1, 32, 48, 3, generator=g) * 255
    m = mesh or comm.Mesh()
    nbytes = {}
    for name, mod in mods.items():
        if m.model > 1:
            shard_model_params(mod, m, name)
        nbytes[name] = sum(p.numel() * p.element_size() for p in mod.parameters())
    with torch.no_grad():
        out = {"vae_moments": torch.cat(mods["vae"].encode_moments(x), -1), "vae_decode": mods["vae"].decode(z),
               "text": mods["text"](ids), "gmflow": mods["gmflow"](img0, img1)}
    return out, nbytes


RANK0_LIMIT_S = 60  # rank 0's lone flow call; a wait on a collective no other rank joins would never end


def _flow_pair():
    g = torch.Generator().manual_seed(13)
    return torch.rand(2, 64, 64, 3, generator=g) * 255, torch.rand(2, 64, 64, 3, generator=g) * 255


def _rank0_flows(rank, shape):
    """Rank 0's flow source over a mesh that splits GMFlow: before the
    ranks put a whole GMFlow together it raises; after, rank 0 alone runs it
    (no OpenCV assumed, so ``consistency_flow_fn`` picks GMFlow) within
    RANK0_LIMIT_S while the other ranks have returned."""
    import threading
    import time

    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

    pipe = runner.FrescoPipeline(FrescoConfig(mesh_shape=shape, resolution=64), tiny=True, device="cpu")
    out = {}
    have, runner._have_cv2 = runner._have_cv2, lambda: False
    try:
        if rank == 0:
            try:
                pipe.consistency_flow_fn()
                out["before_join"] = "returned"
            except RuntimeError as e:
                out["before_join"] = str(e)
        pipe.whole_gmflow()
        if rank != 0:
            return out
        done = {}
        t = threading.Thread(target=lambda: done.update(flows=pipe.consistency_flow_fn()(*_flow_pair())),
                             daemon=True)
        t0 = time.perf_counter()
        t.start()
        t.join(RANK0_LIMIT_S)
        out.update(flows=done.get("flows"), seconds=time.perf_counter() - t0)
    finally:
        runner._have_cv2 = have
    return out


def _reuse_decided_by_rank_0(rank, shape):
    """``translate_keyframe_files(reuse=True)`` where each rank has a
    ``save_path`` of its own (hosts without a shared disk) and only rank
    0's holds the keyframes: the key indices, where no rank translated."""
    import os
    import tempfile

    from PIL import Image

    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

    frames = [np.full((64, 64, 3), 20 * i, np.uint8) for i in range(6)]

    def translate(*a, **k):
        raise AssertionError(f"rank {rank} translated although rank 0 holds every keyframe")

    with tempfile.TemporaryDirectory() as save:
        if rank == 0:
            os.makedirs(os.path.join(save, "keys"))
            for i, f in enumerate(frames):
                Image.fromarray(f).save(os.path.join(save, "keys", "%04d.png" % i))
        pipe = runner.FrescoPipeline(FrescoConfig(mesh_shape=shape, resolution=64, save_path=save,
                                                  file_path="clip.mp4"), tiny=True, device="cpu")
        pipe.translate_keyframes = translate
        read, runner.read_video_rgb = runner.read_video_rgb, lambda path, n: frames
        try:
            return pipe.translate_keyframe_files(verbose=False, reuse=True)
        finally:
            runner.read_video_rgb = read


def _world(rank, dev, shape):
    """Every check on one rank of a ``shape`` world."""
    from fresco_torch.parallel.sharding import make_mesh
    from fresco_torch.parallel.smoke import run_full_sampler
    from fresco_torch.scripts import train_gmflow

    mesh = make_mesh(*shape)
    inp = _inputs()
    out = {"pieces": _pieces(inp, mesh), "unet": _unet_forward(inp, mesh), "step": _unet_step(inp, mesh),
           "sampler": run_full_sampler(shape, **SAMPLER_KW),
           "sampler_bf16": run_full_sampler(shape, dtype="bfloat16", **SAMPLER_KW), "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank}
    out["gmflow"] = _gmflow_step(mesh)
    out["loader"] = _loader(mesh)
    if shape[1] > 1:
        out["models"] = _three_models(mesh)
        out["rank0"] = _rank0_flows(rank, shape)
    if shape == (2, 1):
        out["reuse_keys"] = _reuse_decided_by_rank_0(rank, shape)
        run = train_gmflow.main(SCRIPT_ARGS + ["--data-par", "2"])
        out["train_gmflow"] = (run["losses"], {k: v.clone() for k, v in run["model"].state_dict().items()})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    return {shape: launch(_world, shape[0] * shape[1], shape, device="cpu", tmp_dir=tmp, timeout_s=300)
            for shape in SHAPES}


@pytest.fixture(scope="module")
def whole():
    from fresco_torch.parallel.smoke import run_full_sampler

    inp = _inputs()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    try:
        witness = {shape: run_full_sampler((1, 1), dtype="bfloat16", witness=shape, **SAMPLER_KW) for shape in SHAPES}
        models = _three_models(None)
    finally:
        torch.set_num_threads(threads)
    return {"inp": inp, "pieces": _pieces(inp, None), "unet": _unet_forward(inp, None), "step": _unet_step(inp, None),
            "sampler": run_full_sampler((1, 1), **SAMPLER_KW), "gmflow": _gmflow_step(None), "loader": _loader(None),
            "bf16_witness": witness, "models": models}


def _mesh(shape, out):
    return comm.Mesh(shape[0], shape[1], out["data_rank"] * shape[1] + out["model_rank"])


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b.detach() if isinstance(b, torch.Tensor) else b), atol=atol, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gather_frames_forward_and_backward(worlds, whole, shape):
    """The gather returns the whole chunk-major batch on every rank; its
    backward sums over the data ranks, so a loss of this rank's terms gives
    this rank's gradient, and a loss of the whole batch on every rank gives
    ``data`` times it (why each rank's loss holds only its own frames)."""
    wts = whole["inp"]["wts"]
    for out in worlds[shape]:
        m = _mesh(shape, out)
        p = out["pieces"]
        _close(p["gather"], whole["inp"]["x"])
        _close(p["gather_grad_own"], comm.local_frames(wts, m, CHUNK))
        _close(p["gather_grad_all"], shape[0] * comm.local_frames(wts, m, CHUNK))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_coupling_pieces_sharded_equal_whole(worlds, whole, shape):
    """Cross-frame attention (masked, compacted, maskless), trajectory
    attention, the temporal loss and its gradient, the gram gradient
    (factored and dense) and warp_and_fuse: each rank's part equals the
    whole run's frames, and the ranks' temporal losses sum to the whole's."""
    for out in worlds[shape]:
        m = _mesh(shape, out)
        for key in ("cf", "cf_perm", "cf_maskless", "traj", "temporal_grad", "gram", "gram_dense", "fuse"):
            _close(out["pieces"][key], comm.local_frames(whole["pieces"][key], m, CHUNK))
        _close(out["pieces"]["temporal_loss"], whole["pieces"]["temporal_loss"])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tiny_unet_forward_sharded_equal_single(worlds, whole, shape):
    """The tiny UNet (float64) with frames over data and its layers split
    over model (Megatron pairs, whole heads, GEGLU halves split alike)."""
    for out in worlds[shape]:
        _close(out["unet"], comm.local_frames(whole["unet"], _mesh(shape, out)), atol=ATOL)


MODEL_SHAPES = [s for s in SHAPES if s[1] > 1]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_vae_text_gmflow_split_equal_whole(worlds, whole, shape):
    """The VAE (split convolutions gathered before each GroupNorm, the
    single-head mid attention whole with its ``to_out`` in the row form)
    and the text encoder (whole heads a rank, row-parallel ``out_proj`` and
    ``mlp_fc2``) in float64 within 1e-5 of the whole model's outputs (read:
    3.4e-15); GMFlow (split convolutions, ``merge`` and ``mlp_2`` in their
    row forms), which computes in float32 only, within 1e-5 of its largest
    flow (read: 2.05e-5 px of 16.9 px, ten float32 ulps there); each
    model's parameter bytes on a rank below the whole's."""
    want, whole_bytes = whole["models"]
    for out in worlds[shape]:
        got, nbytes = out["models"]
        for key, ref in want.items():
            if key == "gmflow":
                assert (got[key] - ref).abs().max() <= 1e-5 * ref.abs().max(), key
            else:
                _close(got[key], ref, atol=1e-5)
        for name, n in whole_bytes.items():
            assert nbytes[name] < n, (name, nbytes[name], n)


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_rank0_alone_gets_a_whole_gmflow(worlds, shape):
    """Over a mesh that splits GMFlow, ``consistency_flow_fn`` on rank 0
    alone raises until the ranks have put a whole GMFlow together
    (``whole_gmflow``); then it returns, within RANK0_LIMIT_S, the flows of
    the same GMFlow run whole in one process."""
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

    rank0 = worlds[shape][0]["rank0"]
    assert "whole_gmflow" in rank0["before_join"]
    assert rank0["flows"] is not None and rank0["seconds"] < RANK0_LIMIT_S
    single = runner.FrescoPipeline(FrescoConfig(resolution=64), tiny=True, device="cpu")
    with torch.no_grad():
        want = single.gmflow_flow_fn()(*_flow_pair())
    _close(rank0["flows"], want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_full_sampler_sharded_equal_single(worlds, whole, shape):
    """run_full_sampler in float64, with the bundle's GMFlow as the flow
    source (split over ``model`` with the VAE, the text encoder, the UNet
    and the ControlNet): every rank's whole latents within atol = rtol =
    1e-5 of the (1, 1) run."""
    for out in worlds[shape]:
        np.testing.assert_allclose(out["sampler"], whole["sampler"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_sampler_sharded_equal_its_witness(worlds, whole, shape):
    """run_full_sampler in bf16, where a (1, 2) split's partial sums move
    the latents ~5e-2 (relative Frobenius) from the (1, 1) run: every
    rank's latents equal those of one process doing a rank's arithmetic
    with no collective (``smoke.rank_sized_layers``, one thread as in a
    rank) within 1e-6 relative (read: bit for bit), so that nothing that
    crosses ranks adds to the split's rounding."""
    want = whole["bf16_witness"][shape]
    for out in worlds[shape]:
        assert np.linalg.norm(out["sampler_bf16"] - want) <= 1e-6 * np.linalg.norm(want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unet_train_step_sharded_equal_single(worlds, whole, shape):
    """The UNet step (float64, AdamW): the whole batch's loss, and each
    rank's gradients and updated parameters equal the single step's, split
    as the rank holds them."""
    from fresco_torch.parallel.sharding import shard_model_params

    loss, grads, params = whole["step"]
    for out in worlds[shape]:
        r_loss, r_grads, r_params = out["step"]
        assert abs(r_loss - loss) < ATOL
        for ref, got in ((grads, r_grads), (params, r_params)):
            unet = _tiny_unet()
            for n, p in unet.named_parameters():
                p.data = ref[n].clone()
            if shape[1] > 1:
                shard_model_params(unet, comm.Mesh(1, shape[1], out["model_rank"]), "unet")
            for n, p in unet.named_parameters():
                _close(got[n], p, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gmflow_step_and_loader_sharded(worlds, whole, shape):
    """GMFlow's step over data (whole on every model rank): the loss and the
    summed gradients equal the single step's on the whole batch (float32,
    1e-5 of the largest gradient); the loader's batches are the single
    loader's, sliced by data rank."""
    loss, grads = whole["gmflow"]
    for out in worlds[shape]:
        r_loss, r_grads = out["gmflow"]
        assert abs(r_loss - loss) <= 1e-5 * abs(loss)
        g_max = max(float(g.abs().max()) for g in grads.values())
        for n, g in grads.items():
            assert (r_grads[n] - g).abs().max() <= 1e-5 * g_max, n
        m = _mesh(shape, out)
        assert len(out["loader"]) == len(whole["loader"]) == 2
        for a, b in zip(out["loader"], whole["loader"]):
            assert torch.equal(a, b[m.frame_slice(4)])


def test_dryrun_multichip_on_the_cpu():
    """The dry run's three checks over 4 spawned ranks on a (2, 2) mesh: the
    training step and the float64 sampler sharded == single (the sampler to
    1e-5: its float32 text encoder and GMFlow are split), the wave ==
    serial (it raises where one fails)."""
    from fresco_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, "cpu", verbose=False)
    assert out["mesh"] == (2, 2) and len(out["ranks"]) == 4
    assert max(r["latent_err"] for r in out["ranks"]) < 1e-5 and out["wave"]["max_abs"] == 0.0


def test_train_gmflow_data_par_2_equals_data_par_1(worlds):
    """``train_gmflow --data-par 2`` in a world of 2 against ``--data-par 1``
    on the same global batches: the logged losses and the parameters."""
    from fresco_torch.parallel.flow_train import cosine_onecycle_schedule
    from fresco_torch.scripts import train_gmflow

    single = train_gmflow.main(SCRIPT_ARGS)
    sched = cosine_onecycle_schedule(2, 4e-4, pct_start=0.5)
    bound = 2 * (sched(0) + sched(1)) + 1e-7
    for out in worlds[(2, 1)]:
        losses, params = out["train_gmflow"]
        np.testing.assert_allclose(losses, single["losses"], rtol=1e-5)
        for k, v in single["model"].state_dict().items():
            assert (params[k] - v).abs().max() <= bound, k


def test_keyframe_reuse_is_rank_0s_decision(worlds):
    """Over a (2, 1) mesh where only rank 0's ``save_path`` holds the
    keyframes, ``translate_keyframe_files(reuse=True)`` skips the
    translation on both ranks (rank 0's decision, broadcast) and both
    return the same key indices."""
    keys = [out["reuse_keys"] for out in worlds[(2, 1)]]
    assert keys[0] == keys[1] and keys[0][0] == 0
