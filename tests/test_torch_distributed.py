"""``fresco_torch.parallel.distributed`` against
``fresco_tpu.parallel.distributed`` on the 8 virtual CPU devices of
``tests/conftest.py``.

Exact comparisons (layouts, slices, raises): no arithmetic involved.  The
port's global layout is a pure function of (world, ranks a host, model,
data), held here against the JAX mesh of one process holding 8 devices.
F24: where a rendezvous is named and unreachable (a localhost port nothing
listens on, a 2 s timeout), the port raises, where the JAX version prints
and degrades to independent single runs.
"""
import socket

import numpy as np
import pytest
import torch.distributed as dist

from fresco_torch.parallel import distributed as td
from fresco_tpu.parallel import distributed as jd


def test_initialize_without_rendezvous_is_single_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert td.initialize() is False and jd.initialize() is False
    assert not dist.is_initialized()
    assert td.is_main_process() and jd.is_main_process()
    assert td.world_size() == 1
    mesh = td.make_global_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        td.make_global_mesh(1, data=2)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_global_layout_equals_jax_mesh(model):
    mesh = jd.make_global_mesh(model)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(td.global_layout(8, 8, model), ids)
    if model == 2:
        np.testing.assert_array_equal(ids, [[0, 1], [2, 3], [4, 5], [6, 7]])


def test_both_reject_model_groups_across_hosts():
    with pytest.raises(ValueError, match="ICI"):
        jd.make_global_mesh(3)  # 3 does not divide the 8 devices of the host
    with pytest.raises(ValueError, match="one host"):
        td.global_layout(8, 8, 3)
    with pytest.raises(ValueError, match="one host"):
        td.global_layout(8, 2, 4)  # 4 hosts of 2 ranks: a model group of 4 would straddle two
    with pytest.raises(ValueError, match="needs 16"):
        td.global_layout(8, 8, 2, data=8)
    np.testing.assert_array_equal(td.global_layout(8, 2, 2), [[0, 1], [2, 3], [4, 5], [6, 7]])


def test_shard_batch_per_process_equals_jax():
    for n in (8, 7, 1):
        assert td.shard_batch_per_process(n) == jd.shard_batch_per_process(n)


def test_backend_rule():
    assert td.choose_backend("cpu", 4, 0)[0] == "gloo"
    assert td.choose_backend("cuda", 4, 4)[0] == "nccl"
    assert td.choose_backend("cuda", 4, 1)[0] == "gloo"  # ranks share a card: NCCL takes one rank a card


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_unreachable_rendezvous_raises(monkeypatch):
    """F24: an explicit address, and torchrun's variables, naming a rank-0
    store that no process serves."""
    with pytest.raises(RuntimeError, match="rendezvous"):
        td.initialize(f"127.0.0.1:{_free_port()}", 2, 1, device_type="cpu", timeout_s=2)
    assert not dist.is_initialized()
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="rendezvous at env://"):
        td.initialize(device_type="cpu", timeout_s=2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        td.initialize("127.0.0.1:1")
