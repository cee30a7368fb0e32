"""Interval-parallel patch synthesis: one chain per device.

Counterpart of ``fresco_tpu/propagate/parallel.py``.  The reference fans
propagation out as up to 8 worker processes over keyframe intervals
(reference video_blend.py:114-139, MAX_PROCESS=8 :25).  The JAX package
runs a wave of chains as one ``shard_map`` program per pyramid level over
a ``jobs`` mesh, one job per device.  Here each job runs the same
single-job ``synthesize`` on its own device: the jobs of one device in
order on one thread, one thread per distinct device (the kernels'
launches go to the current device of the calling thread, and a level
reads its active count on the host, so a device needs a thread of its
own to overlap with the others).  Chains are independent given the
keyframes and flows, so nothing crosses devices.

A device list may repeat one device: ``["cpu"] * 4`` runs a wave on the
CPU, ``[cuda:0] * 4`` runs every chain of the wave on one card, one after
the other (the output is the same; the multi-card speed is not).

Under a process group of more than one rank the port is SPMD (F23): the
counterpart of the JAX ``jobs`` mesh is the group's ranks, each a process
with its own card, not threads of rank 0.  There ``"auto"`` means the
group's ranks, ``blend_video_frames`` runs on every rank and deals a
wave's chains one a rank (``dealt_over_group``); ``all_ranks``,
``send_to`` and ``recv_from`` carry a wave's status and its chains'
tensors between the ranks, on the rank's card over NCCL and through host
memory over gloo (``wire_device``).
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch


def resolve_n_devices(n_devices: int | str, device: torch.device) -> int:
    """``"auto"``: the group's ranks under a process group of more than
    one rank; else every visible card on the card, 1 on the CPU."""
    from fresco_torch.parallel.distributed import world_size

    if n_devices == "auto":
        if world_size() > 1:
            return world_size()
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return max(int(n_devices), 1)


def dealt_over_group(n_devices: int | str, device: torch.device) -> bool:
    """Whether a wave's chains go one a rank over the process group: under
    a group of more than one rank, unless ``n_devices`` is 1 (the serial
    path, on the rank that calls it).  Under a group any other count than
    1, ``"auto"`` and the group's size raises: the ranks are the devices."""
    from fresco_torch.parallel.distributed import world_size

    world = world_size()
    if world == 1:
        return False
    n = resolve_n_devices(n_devices, device)
    if n == 1:
        return False
    if n != world:
        raise ValueError(f"n_devices={n_devices!r} under a process group of {world} ranks: a wave's chains go one "
                         f"a rank, so pass 'auto' or {world} (or 1 for the serial path on one rank)")
    return True


def device_scope(dev: torch.device):
    """``dev`` current on the calling thread where it is a card (a new
    thread starts on cuda:0)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def wire_device(dev: torch.device) -> torch.device:
    """Where tensors travel between ranks: the rank's card over NCCL, host
    memory over gloo."""
    import torch.distributed as dist

    return dev if dist.get_backend() == "nccl" else torch.device("cpu")


def all_ranks(value, error: str | None = None, what: str = "a wave") -> list:
    """Every rank's ``value`` on every rank (``all_gather_object``), after a
    check that no rank failed: where any rank passes an ``error`` (its
    traceback), every rank raises, naming the ranks and their tracebacks.
    Over NCCL the calling thread must have the rank's card current."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (error, value))
    failed = [(r, e) for r, (e, _) in enumerate(got) if e]
    if failed:
        raise RuntimeError(f"{what}: rank(s) {[r for r, _ in failed]} of {len(got)} failed\n"
                           + "\n".join(f"rank {r}:\n{e}" for r, e in failed))
    return [v for _, v in got]


def send_to(tensors: Sequence[torch.Tensor], dst: int, wire: torch.device) -> None:
    """Each of ``tensors`` to rank ``dst``, in order, by way of ``wire``."""
    import torch.distributed as dist

    for t in tensors:
        dist.send(t.to(wire).contiguous(), dst)


def recv_from(specs: Sequence[tuple], src: int, wire: torch.device, dev: torch.device) -> list[torch.Tensor]:
    """The tensors that rank ``src`` sends with ``send_to``, of the
    (shape, dtype) ``specs``, on ``dev``."""
    import torch.distributed as dist

    out = []
    for shape, dtype in specs:
        buf = torch.empty(shape, dtype=dtype, device=wire)
        dist.recv(buf, src)
        out.append(buf.to(dev))
    return out


def wave_devices(n_devices: int, device: torch.device) -> list[torch.device]:
    """The devices of a wave: the first ``n_devices`` cards when ``device``
    is a card (more than are visible raises), else ``n_devices`` copies of
    ``device``."""
    if device.type != "cuda":
        return [device] * n_devices
    have = torch.cuda.device_count()
    if n_devices > have:
        raise ValueError(f"n_devices={n_devices}: need {n_devices} cards, {have} visible")
    return [torch.device("cuda", i) for i in range(n_devices)]


def job_devices(n_jobs: int, devices: Sequence) -> list[torch.device]:
    """The first ``n_jobs`` of ``devices`` (``jobs_mesh``); fewer raises."""
    if len(devices) < n_jobs:
        raise ValueError(f"need {n_jobs} devices, have {len(devices)}")
    return [torch.device(d) for d in devices[:n_jobs]]


def run_jobs(devices: Sequence[torch.device], tasks: Sequence[Callable]) -> list:
    """Run ``tasks[i]`` on ``devices[i]`` and return their results in
    order.  The tasks of one device run in order on one thread (the
    caller's when there is one device), with that device current and
    synchronized at the end; an exception in any task is raised here."""
    groups: dict[torch.device, list[int]] = {}
    for i, d in enumerate(devices[:len(tasks)]):
        groups.setdefault(torch.device(d), []).append(i)
    results: list = [None] * len(tasks)

    def run(dev: torch.device, idxs: list[int]) -> None:
        with device_scope(dev):
            for i in idxs:
                results[i] = tasks[i]()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    if len(groups) > 1:
        with ThreadPoolExecutor(max_workers=len(groups)) as ex:
            for f in [ex.submit(run, d, idxs) for d, idxs in groups.items()]:
                f.result()
    else:
        for d, idxs in groups.items():
            run(d, idxs)
    return results
