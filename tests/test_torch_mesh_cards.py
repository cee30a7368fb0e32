"""The four-card path's rules on the CPU, with the cards patched in where
one is needed: ``mesh_cards.py`` refuses fewer than four cards;
``initialize`` gives ranks 0-3 cards 0-3 and NCCL; ``run_e2e`` joins the
process group before it reads its device (F26); the kernel wrappers' device
guard names the devices of inputs that do not share one card (F27).

No arithmetic is compared: every check is exact.  This file imports no JAX.
"""
import os

import pytest
import torch
import torch.distributed as dist

from fresco_torch import kernels
from fresco_torch.parallel import distributed

MUSIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "config", "config_music.yaml")


@pytest.mark.parametrize("n_cards", [0, 1, 3])
def test_mesh_cards_refuses_fewer_than_four_cards(monkeypatch, n_cards):
    import mesh_cards

    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    with pytest.raises(RuntimeError, match=f"needs 4 visible cards.*sees {n_cards} "):
        mesh_cards.main([])


@pytest.mark.parametrize("local_rank", [False, True])
def test_initialize_gives_four_ranks_four_cards_over_nccl(monkeypatch, local_rank):
    """Ranks 0-3 of a world of four on a host with four cards: each sets its
    own card (``LOCAL_RANK`` as torchrun sets it, else the rank dealt
    round-robin as ``launch``'s ranks are) and picks NCCL."""
    seen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda card: seen.append(("card", card)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append(("group", backend, kw["rank"], kw["world_size"])))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    for rank in range(4):
        if local_rank:
            monkeypatch.setenv("LOCAL_RANK", str(rank))
        else:
            monkeypatch.delenv("LOCAL_RANK", raising=False)
        assert distributed.initialize("127.0.0.1:1", 4, rank, device_type="cuda") is True
    assert seen == [x for r in range(4) for x in (("card", r), ("group", "nccl", r, 4))]


def test_run_e2e_joins_the_group_before_it_reads_its_device(monkeypatch, tmp_path):
    """F26: under torchrun with a mesh, each rank's card is set when it joins
    the process group, so ``run_e2e`` must join before it resolves the
    device whose peak memory it resets and reads."""
    import fresco_torch.cli
    import fresco_torch.pipeline.runner
    from fresco_torch.scripts import run_e2e

    order = []
    monkeypatch.setattr(distributed, "initialize", lambda *a, **k: order.append("initialize") or True)
    monkeypatch.setattr(fresco_torch.pipeline.runner, "resolve_device",
                        lambda d: order.append("resolve_device") or torch.device("cpu"))
    monkeypatch.setattr(fresco_torch.cli, "run_config", lambda cfg, **kw: order.append(("run", cfg.mesh_shape)))
    cfg = tmp_path / "mesh.yaml"
    with open(MUSIC) as f:
        cfg.write_text(f.read() + "mesh_shape: [2, 1]\n")
    run_e2e.main([str(cfg), "--device", "cpu"])
    assert order == ["initialize", "resolve_device", ("run", (2, 1))]
    order.clear()
    run_e2e.main([MUSIC, "--device", "cpu"])  # one rank: no process group to join
    assert order == ["resolve_device", ("run", (1, 1))]


def test_launch_card_names_the_devices_of_mixed_inputs():
    """F27's guard: a launch runs on the one card its inputs share; inputs
    on two devices raise naming each, and inputs off the card raise."""
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match=r"bmm: inputs on different devices: a on cpu, x on meta"):
        kernels.launch_card("bmm", a=a, x=b, skipped=None)
    with pytest.raises(ValueError, match=r"row_gather: the kernel runs on a card, the inputs lie on cpu"):
        kernels.launch_card("row_gather", table=a, idx=a)


def test_wrappers_count_launches_by_card():
    """Each of the five wrappers keeps a count by card, which
    ``reset_launches`` clears with the totals."""
    ws = kernels.wrappers()
    kernels.reset_launches()
    for w in ws.values():
        w.launches_by_card[3] = 1
    assert all(n == {3: 1} for n in kernels.launches_by_card().values())
    kernels.reset_launches()
    assert kernels.launches_by_card() == {name: {} for name in ws}
    kernels.count_launch(ws["bmm"], card=torch.device("cuda", 2))
    assert kernels.launches()["bmm"] == 1 and kernels.launches_by_card()["bmm"] == {2: 1}
    kernels.reset_launches()


@pytest.mark.parametrize("current", [1, 0])
def test_call_launches_on_its_card_and_counts_there(monkeypatch, current):
    """``kernels.call`` hands the C entry point its arguments and the card's
    stream, makes the card current only where another one is, raises on a
    non-zero return code and counts the launch on that card."""
    import contextlib
    import types

    seen, inside = [], []

    class Lib:
        def fresco_row_gather(self, *args):
            seen.append((args, list(inside)))
            return args[0]

    @contextlib.contextmanager
    def device(card):
        inside.append(card.index)
        yield
        inside.pop()

    monkeypatch.setattr(kernels, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda card: types.SimpleNamespace(cuda_stream=100 + card.index))
    monkeypatch.setattr(torch.cuda, "device", device)
    card = torch.device("cuda", 1)
    wrapper = kernels.wrappers()["row_gather"]
    kernels.reset_launches()
    kernels.call(wrapper, "row_gather", card, 0, 7)
    assert seen == [((0, 7, 101), [] if current == 1 else [1])]
    assert kernels.launches_by_card()["row_gather"] == {1: 1} and kernels.launches()["row_gather"] == 1
    with pytest.raises(RuntimeError, match="row_gather: CUDA launch failed with cudaError_t 3"):
        kernels.call(wrapper, "row_gather", card, 3)
    assert kernels.launches()["row_gather"] == 1
    kernels.reset_launches()
