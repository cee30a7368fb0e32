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
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch


def resolve_n_devices(n_devices: int | str, device: torch.device) -> int:
    """``"auto"``: every visible card on the card, 1 on the CPU."""
    if n_devices == "auto":
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return max(int(n_devices), 1)


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
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
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
