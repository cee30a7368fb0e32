"""The device trace of a run's window, reduced to what the metrics read.

``Tracer`` runs the profiler around the window: the card's operations,
and on the host the ``record_function`` ranges and the CUDA runtime calls.  ``reduce`` reads the raw kineto events once
and keeps:

- the device's operations (kernels, copies, sets) as intervals, their
  union (``busy_s``) and their time by name;
- the device-side spans of the ``fresco::`` and ``bench::`` ranges (the
  program's and the harness's ``record_function`` ranges), by name;
- the host-side spans of the same ranges and of the CUDA runtime calls,
  which name what the host was doing in the longest idle gaps.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

RANGE_PREFIXES = ("fresco::", "bench::")
WINDOW = "bench::window"


def union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The disjoint union of intervals [starts, ends), sorted."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def overlap(a: tuple[np.ndarray, np.ndarray], b: tuple[np.ndarray, np.ndarray]) -> float:
    """Total length of the intersection of two disjoint, sorted unions."""
    total, i, j = 0, 0, 0
    (as_, ae), (bs, be) = a, b
    while i < as_.size and j < bs.size:
        lo, hi = max(as_[i], bs[j]), min(ae[i], be[j])
        if hi > lo:
            total += hi - lo
        if ae[i] < be[j]:
            i += 1
        else:
            j += 1
    return float(total)


@dataclasses.dataclass
class Trace:
    window_ns: tuple[int, int]
    busy: tuple[np.ndarray, np.ndarray]               # union of device operations
    ops_ns: dict[str, list]                            # name -> [ns, count]
    ranges: dict[str, tuple[np.ndarray, np.ndarray]]  # device-side range spans (unions), by name
    host_ranges: dict[str, tuple[np.ndarray, np.ndarray]]
    host_ops: tuple[np.ndarray, np.ndarray, list]      # starts, ends, names of host operations

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return float(np.sum(self.busy[1] - self.busy[0])) / 1e9

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name holds ``pattern``."""
        ns, n = 0, 0
        for name, (t, c) in self.ops_ns.items():
            if pattern in name:
                ns, n = ns + t, n + c
        return ns / 1e9, n

    def range_busy_s(self, name: str) -> float | None:
        """Device-busy seconds inside range ``name``'s device-side spans (None: no such range)."""
        if name not in self.ranges:
            return None
        return overlap(self.ranges[name], self.busy) / 1e9

    def top_ops(self, k: int = 10) -> list:
        items = sorted(self.ops_ns.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, t / 1e9] for name, (t, _) in items]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps between device operations inside the window,
        each named by the innermost host range, else the host operation,
        running at its middle."""
        s, e = self.busy
        lo, hi = self.window_ns
        starts = np.concatenate([[lo], e])
        ends = np.concatenate([s, [hi]])
        gaps = ends - starts
        out = []
        for i in np.argsort(-gaps)[:k]:
            if gaps[i] <= 0:
                break
            mid = (starts[i] + ends[i]) // 2
            out.append([self._host_label(mid), float(gaps[i]) / 1e9])
        return out

    def _host_label(self, t: int) -> str:
        best, best_len = None, None
        for name, (rs, re) in self.host_ranges.items():
            if name == WINDOW:
                continue
            k = np.searchsorted(rs, t, side="right") - 1
            if k >= 0 and re[k] > t and (best_len is None or re[k] - rs[k] < best_len):
                best, best_len = name, re[k] - rs[k]
        hs, he, hn = self.host_ops
        inside = np.flatnonzero((hs <= t) & (he > t))
        op = None
        if inside.size:
            op = hn[inside[np.argmin(he[inside] - hs[inside])]]
        if best and op:
            return f"{best} / {op}"
        return best or (f"host: {op}" if op else "host: outside any operation")


def reduce(kineto_results) -> Trace:
    """The trace of the events; its window is the host span of ``bench::window``."""
    dev_s, dev_e, dev_names = [], [], []
    ranges, host_ranges = defaultdict(lambda: ([], [])), defaultdict(lambda: ([], []))
    hs, he, hn = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    events = kineto_results.events()
    in_ns = bool(events) and hasattr(events[0], "start_ns")
    for ev in events:
        name = ev.name()
        if in_ns:
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        else:
            start = int(ev.start_us() * 1000)
            end = start + int(ev.duration_us() * 1000)
        is_range = name.startswith(RANGE_PREFIXES)
        if ev.device_type() == cuda:
            if is_range:
                ranges[name][0].append(start)
                ranges[name][1].append(end)
            else:
                dev_s.append(start)
                dev_e.append(end)
                dev_names.append(name)
        elif is_range:
            host_ranges[name][0].append(start)
            host_ranges[name][1].append(end)
        else:
            hs.append(start)
            he.append(end)
            hn.append(name)
    arr = lambda v: np.asarray(v, dtype=np.int64)  # noqa: E731
    as_union = lambda d: {k: union(arr(v[0]), arr(v[1])) for k, v in d.items()}  # noqa: E731
    win = host_ranges.get(WINDOW)
    if not win or not win[0]:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    window_ns = (min(win[0]), max(win[1]))
    dev = [x for x in zip(dev_s, dev_e, dev_names) if x[1] > window_ns[0] and x[0] < window_ns[1]]
    dev_s, dev_e, dev_names = ([x[i] for x in dev] for i in range(3))
    ops = defaultdict(lambda: [0, 0])
    for name, a, b in zip(dev_names, dev_s, dev_e):
        ops[name][0] += min(b, window_ns[1]) - max(a, window_ns[0])
        ops[name][1] += 1
    dev_s = [max(a, window_ns[0]) for a in dev_s]
    dev_e = [min(b, window_ns[1]) for b in dev_e]
    return Trace(window_ns=window_ns, busy=union(arr(dev_s), arr(dev_e)), ops_ns=dict(ops),
                 ranges=as_union(ranges), host_ranges=as_union(host_ranges),
                 host_ops=(arr(hs), arr(he), hn))


class Tracer:
    """The profiler around a block: CUDA activity, and on the host only the
    ``record_function`` ranges (the user scope), not every operation, so
    that tracing costs the host little and the trace stays small.  ``trace``
    holds the reduced trace after ``close``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self._on = False

    def __enter__(self):
        if self.enabled:
            from torch._C._profiler import ProfilerActivity, RecordScope
            from torch.autograd import _enable_profiler, _prepare_profiler

            activities = {ProfilerActivity.CPU}
            if torch.cuda.is_available():
                activities.add(ProfilerActivity.CUDA)
            config = torch.autograd.profiler.profile(use_kineto=True, use_cpu=True).config()
            _prepare_profiler(config, activities)
            _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
            self._on = True
        return self

    def _stop(self):
        from torch.autograd import _disable_profiler

        self._on = False
        return _disable_profiler()

    def close(self) -> None:
        """Stop the profiler and reduce its trace to the ``bench::window`` range's span."""
        if self._on:
            self.trace = reduce(self._stop())

    def __exit__(self, *exc):
        if self._on:
            self._stop()
        return False
