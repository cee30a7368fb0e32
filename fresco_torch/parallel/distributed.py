"""Multi-process rendezvous, the global mesh layout and a rank spawner.

Counterpart of ``fresco_tpu/parallel/distributed.py`` on
``torch.distributed``.  ``initialize`` joins a process group from explicit
arguments (an address ``host:port``, ``tcp://...`` or ``file://...``, a
process count and id), from the torchrun variables (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) or from
Slurm's (``SLURM_PROCID``, ``SLURM_NTASKS``, with ``MASTER_ADDR`` /
``MASTER_PORT``), and returns False when none names a rendezvous.  Where
one is named and it fails, it raises: the JAX version prints and goes on
as N independent runs (``:83-89``), which the port does not copy (F24).

The backend rule is explicit and printed: gloo for CPU ranks; NCCL where
every rank of the host has a card of its own; gloo where ranks share a
card (NCCL refuses two ranks on one GPU), which takes their CUDA tensors
and copies them through host memory itself.

``global_layout`` is the pure layout rule of ``make_global_mesh``: ranks
host-major, ``model`` inside a host (``LOCAL_WORLD_SIZE`` ranks a host),
so only ``data`` crosses hosts.  ``launch`` spawns ranks (the ``spawn``
start method: a forked child cannot use a card its parent has touched)
that rendezvous through a ``FileStore``, never a fixed port.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from fresco_torch.core.comm import Mesh


def choose_backend(device_type: str, local_world: int, n_cards: int) -> tuple[str, str]:
    """(backend, why) for ranks on ``device_type`` with ``local_world``
    ranks on this host and ``n_cards`` visible cards."""
    if device_type != "cuda":
        return "gloo", "CPU tensors"
    if local_world <= n_cards:
        return "nccl", f"{local_world} rank(s) on this host, {n_cards} card(s): one card a rank"
    return "gloo", f"{local_world} ranks share {n_cards} card(s): NCCL takes one rank a card"


def _init_method(address: str) -> str:
    if address.startswith(("tcp://", "file://", "env://")):
        return address
    return f"tcp://{address}"


def _env_rendezvous() -> tuple[str, int, int] | None:
    """(init method, world, rank) named by torchrun's or Slurm's variables."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        if "MASTER_ADDR" not in env:
            raise RuntimeError("Slurm rendezvous: set MASTER_ADDR (and MASTER_PORT) to rank 0's host")
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        return _init_method(addr), int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
    return None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device_type: str | None = None,
               timeout_s: float = 600.0) -> bool:
    """Join (or start) the process group.  Returns True when more than one
    process takes part, False for a single process (no rendezvous named,
    or a world of one).  ``device_type``: "cuda" or "cpu" for the backend
    rule (default: "cuda" where a card is visible).  A named rendezvous
    that fails within ``timeout_s`` raises (F24)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None:
            raise ValueError("initialize: pass coordinator_address and num_processes together")
        if process_id is None and "SLURM_PROCID" in os.environ:
            process_id = int(os.environ["SLURM_PROCID"])  # Slurm rendezvous parity (:76-77)
        if process_id is None:
            raise ValueError("initialize: process_id is missing (and SLURM_PROCID is not set)")
        method, world, rank = _init_method(coordinator_address), int(num_processes), int(process_id)
    else:
        named = _env_rendezvous()
        if named is None:
            return False
        method, world, rank = named
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, why = choose_backend(device_type, local_world,
                                  torch.cuda.device_count() if device_type == "cuda" else 0)
    if device_type == "cuda":  # this rank's card: LOCAL_RANK (torchrun), round-robin over the visible cards
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    if rank == 0:
        print(f"[fresco_torch] process group: {world} rank(s), backend {backend} ({why})", flush=True)
    try:
        dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # F24: a named rendezvous that fails is an error, never N single runs
        raise RuntimeError(f"rank {rank} of {world}: the rendezvous at {method} failed "
                           f"({type(e).__name__}: {e})") from e
    return world > 1


def is_main_process() -> bool:
    """Rank 0, or a single process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def main_process_value(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself in a single process):
    a decision rank 0 takes from what only it may see, such as its own
    files, so that every rank then takes the same path through the
    collectives."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_layout(world: int, per_host: int, model: int = 1, data: int | None = None) -> np.ndarray:
    """Ranks as a ``[data, model]`` array, host-major: ``model`` must divide
    the ranks a host holds, so a model group never straddles hosts
    (``fresco_tpu/parallel/distributed.py:99-121``)."""
    per_host = max(per_host, 1)
    if model > per_host or per_host % model != 0:
        raise ValueError(f"model={model} must divide ranks-per-host ({per_host}); "
                         "TP groups must stay inside one host")
    if data is None:
        data = world // model
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, have {world}")
    return np.arange(data * model).reshape(data, model)


def make_global_mesh(model: int = 1, *, data: int | None = None) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the process group."""
    from fresco_torch.parallel.sharding import make_mesh

    world = world_size()
    layout = global_layout(world, int(os.environ.get("LOCAL_WORLD_SIZE", world)), model, data)
    return make_mesh(*layout.shape)


def shard_batch_per_process(n_items: int) -> slice:
    """This process's contiguous slice of a globally ordered batch."""
    per = n_items // world_size()
    start = (dist.get_rank() if dist.is_initialized() else 0) * per
    return slice(start, start + per)


# ----------------------------------------------------------------- spawner
def _rank_main(rank: int, fn, args, world: int, store: str, device: str, out_dir: str,
               timeout_s: float) -> None:
    torch.set_num_threads(1)
    err = None
    try:
        initialize(f"file://{store}", world, rank, device_type=device, timeout_s=timeout_s)
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
        result = fn(rank, dev, *args)
    except BaseException:
        err = traceback.format_exc()
        result = None
    torch.save({"result": result, "error": err}, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        if err is None:
            dist.barrier()
        dist.destroy_process_group()


def launch(fn, world: int, *args, device: str | None = None, tmp_dir: str | None = None,
           timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, device, *args)`` in ``world`` spawned ranks joined by a
    process group.  ``device``: "cuda" (``None``: the card; it raises
    without one), the ranks round-robin over the visible cards with the
    backend of ``choose_backend``; or "cpu", over gloo.  ``fn`` must be
    importable by name.  Returns each rank's result; a rank's exception is
    raised here with its traceback.  ``timeout_s`` bounds the rendezvous
    and every collective."""
    import torch.multiprocessing as mp

    from fresco_torch.pipeline.runner import resolve_device

    device = resolve_device(device).type

    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        store = os.path.join(tmp, "store")
        env = {"LOCAL_WORLD_SIZE": str(world)}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            ctx = mp.start_processes(_rank_main, args=(fn, args, world, store, device, tmp, timeout_s), nprocs=world,
                                     join=False, start_method="spawn")
            while not ctx.join():
                pass
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    errors = [f"rank {r}:\n{o['error']}" for r, o in enumerate(outs) if o["error"]]
    if errors:
        raise RuntimeError("launch: a rank failed\n" + "\n".join(errors))
    return [o["result"] for o in outs]
