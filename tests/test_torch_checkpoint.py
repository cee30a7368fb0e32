"""``fresco_torch.utils.checkpoint``: pipeline state and parameters round
trip bit for bit (host tensors back, whatever device they were saved
from), a missing path loads as None (as ``fresco_tpu/utils/checkpoint.py``
returns), and files are read with ``weights_only=True``."""
import pickle

import pytest
import torch

from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
from fresco_torch.models.layers import init_flax_default_
from fresco_torch.utils import checkpoint as ck


@pytest.mark.parametrize("record", [None, "tensor"])
def test_pipeline_state_round_trip(tmp_path, record):
    rec = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0)) if record else None
    path = str(tmp_path / "run" / "state.pt")
    ck.save_pipeline_state(path, {"batch_ind": 3, "keys": [0, 5, 11], "record": rec})
    got = ck.load_pipeline_state(path)
    assert got["batch_ind"] == 3 and got["keys"] == [0, 5, 11]
    if rec is None:
        assert got["record"] is None
    else:
        assert torch.equal(got["record"], rec)
    ck.save_pipeline_state(path, {"batch_ind": 4, "keys": [0], "record": None})  # overwrites, as force=True
    assert ck.load_pipeline_state(path)["batch_ind"] == 4


def test_params_round_trip_into_a_module(tmp_path):
    src = init_flax_default_(GMFlow(GMFlowConfig.tiny()), torch.Generator().manual_seed(1))
    path = str(tmp_path / "step_2")
    ck.save_params(path, src.state_dict())
    dst = GMFlow(GMFlowConfig.tiny())
    dst.load_state_dict(ck.load_params(path))
    for (k, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        assert torch.equal(a, b), k
    assert not [f for f in (tmp_path).iterdir() if f.name.endswith(".tmp")]


def test_missing_paths_load_none(tmp_path):
    assert ck.load_params(str(tmp_path / "absent")) is None
    assert ck.load_pipeline_state(str(tmp_path / "absent")) is None


def test_files_are_read_weights_only(tmp_path):
    path = tmp_path / "evil.pt"
    torch.save({"x": ValueError("not a tensor")}, path)
    with pytest.raises(pickle.UnpicklingError):
        ck.load_params(str(path))
