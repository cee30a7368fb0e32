"""The readers of the program's spans and work counters (``gram_share``,
``gram_roofline``, ``attention_roofline``, ``prep_idle.keyframes``,
``denoise_idle.keyframes``) on hand-built traces with known intervals and
counts: each exact value, None where the range or the counter is missing,
and both rooflines at no more than 100 % for work timed at exactly its
bound."""
import types

import numpy as np
import pytest

from benchmark.harness import core
from benchmark.harness.trace import Trace
from fresco_torch import kernels

NEW = ("gram_share", "gram_roofline", "attention_roofline", "prep_idle.keyframes", "denoise_idle.keyframes")


def _spans(*pairs):
    return np.array([a for a, _ in pairs], np.int64), np.array([b for _, b in pairs], np.int64)


def _ctx(busy, ranges=(), host=()):
    """A context whose trace has a window of [0, 10000) ns, the device busy
    over ``busy``, and device- and host-side range spans by name."""
    trace = Trace(window_ns=(0, 10_000), busy=_spans(*busy), ops_ns={},
                  ranges={k: _spans(*v) for k, v in dict(ranges).items()},
                  host_ranges={k: _spans(*v) for k, v in {"bench::window": [(0, 10_000)], **dict(host)}.items()},
                  host_ops=(np.zeros(0, np.int64), np.zeros(0, np.int64), []))
    return types.SimpleNamespace(trace=trace, stats={})


@pytest.fixture
def counts():
    """Set the program's work counts: {layer: {shape: calls}}; cleared after."""
    def put(work):
        kernels.reset_launches()
        for layer, shapes in work.items():
            for shape, n in shapes.items():
                for _ in range(n):
                    kernels.count_work(layer, shape)
    yield put
    kernels.reset_launches()


def _read(name, ctx):
    return core.metric_reader(name)(ctx)


# gram: B=989, hw=1000, c=1 is 3·989e6 FLOPs, 3000 ns at 989 TFLOP/s.
# attention: (1, 1, 1000, 1000, 989) is 4·989e9 FLOPs, 4000 ns (its
# 7.9 MB take 2,362 ns at 3.35 TB/s); (1, 1, 1, 3349, 1) is 13,400 bytes,
# 4 ns at 3.35 TB/s (its FLOPs 0.014 ns), 250 calls 1000 ns.
GRAM = {(989, 1000, 1): 1}
ATTN = {(1, 1, 1000, 1000, 989): 1, (1, 1, 1, 3349, 1): 250}


def test_exact_readings(counts):
    counts({"gram": GRAM, "attention": ATTN})
    ctx = _ctx(busy=[(0, 2000), (3000, 6000), (8000, 9000)],
               ranges={"fresco::gram": [(0, 2000), (3000, 4000), (5000, 6500)],
                       "fresco::attention": [(1000, 2000), (3000, 6000), (7000, 9000)]},
               host={"fresco::interframe_prep": [(1500, 3500)], "fresco::saliency": [(3200, 3300), (6000, 6100)],
                     "fresco::denoise_loop": [(6500, 10_500)], "fresco::vae_decode": [(500, 1000)]})
    # gram busy: 2000 + 1000 + 1000 of 6000; attention busy: 1000 + 3000 + 1000
    assert _read("gram_share", ctx) == pytest.approx(100 * 4000 / 6000, rel=1e-12)
    assert _read("gram_roofline", ctx) == pytest.approx(100 * 3000 / 4000, rel=1e-12)
    assert _read("attention_roofline", ctx) == pytest.approx(100 * 5000 / 5000, rel=1e-12)
    # prep: [1500, 3500) and [6000, 6100) held, 1000 of it busy; denoise: [6500, 10000), 1000 busy
    assert _read("prep_idle.keyframes", ctx) == pytest.approx(100 * 1100 / 10_000, rel=1e-12)
    assert _read("denoise_idle.keyframes", ctx) == pytest.approx(100 * 2500 / 10_000, rel=1e-12)
    idle = _read("device_idle.keyframes", ctx)
    assert _read("prep_idle.keyframes", ctx) + _read("denoise_idle.keyframes", ctx) <= idle


def test_rooflines_at_their_bound_stay_at_most_100(counts):
    counts({"gram": GRAM, "attention": ATTN})
    ctx = _ctx(busy=[(0, 3000), (4000, 9000)],
               ranges={"fresco::gram": [(0, 3000)], "fresco::attention": [(4000, 9000)]})
    for name in ("gram_roofline", "attention_roofline"):
        v = _read(name, ctx)
        assert v == pytest.approx(100.0, rel=1e-12) and v <= 100.0


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_range(counts, name):
    counts({"gram": GRAM, "attention": ATTN})
    assert _read(name, _ctx(busy=[(0, 5000)])) is None


@pytest.mark.parametrize("name", ["gram_roofline", "attention_roofline"])
def test_none_without_the_counter(counts, monkeypatch, name):
    ctx = _ctx(busy=[(0, 5000)], ranges={"fresco::gram": [(0, 1000)], "fresco::attention": [(0, 1000)]})
    counts({})
    assert _read(name, ctx) is None
    monkeypatch.delattr(kernels, "work_counts")  # a program that counts no work
    assert _read(name, ctx) is None
