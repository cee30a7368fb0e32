"""The port's flow source and command-line plumbing against fresco_tpu's.

- ``FrescoPipeline.consistency_flow_fn`` and ``cli.run_config`` take the
  bundle's GMFlow when a checkpoint exists at ``gmflow_path`` and Farneback
  otherwise (the JAX order; fresco_tpu/cli.py:50-60), and the bundle's GMFlow
  with a printed line when there is neither checkpoint nor OpenCV;
- ``default_flow_fn``: with a full-width GMFlow checkpoint written from a
  seeded port module, flows equal to that module's on one 32x32 pair (bit
  for bit: the same weights and arithmetic); without one, Farneback's; with
  neither, an ImportError naming cv2 and --gmflow; ``blend_video_frames``
  with ``flow_fn=None`` calls it;
- the ``video_blend`` command line and ``cli.run_config``: the same argv /
  config give the same ``blend_video`` arguments as the JAX package's,
  backend names translated (``tpu`` -> ``jumpflood``).
"""
import dataclasses
import inspect
import sys

import numpy as np
import pytest
import torch

from fresco_torch.core.config import FrescoConfig
from fresco_torch.pipeline import runner
from fresco_torch.propagate import video_blend as tvb
from fresco_torch.utils.classic_flow import pairwise_flow_fn


class _Bundle:
    """Just the flow source of a model bundle."""

    def __init__(self):
        self.gmflow = lambda a, b: torch.full((2 * a.shape[0], *a.shape[1:3], 2), 7.0)
        self.flow_fn = None


def _pipe(gmflow_path):
    pipe = runner.FrescoPipeline.__new__(runner.FrescoPipeline)
    pipe.config = FrescoConfig(gmflow_path=str(gmflow_path), aux_dtype="float32")
    pipe.bundle, pipe.device = _Bundle(), torch.device("cpu")
    return pipe


def _pair(seed=0, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (1, *hw, 3)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(np.roll(a, 2, axis=2).copy())


def _is_gmflow(fn) -> bool:
    a, b = _pair()
    return bool((fn(a, b) == 7.0).all())


def test_consistency_flow_fn_order(tmp_path, monkeypatch, capsys):
    ckpt = tmp_path / "gmflow.pth"
    ckpt.write_bytes(b"")
    assert _is_gmflow(_pipe(ckpt).consistency_flow_fn())
    far = _pipe(tmp_path / "none.pth").consistency_flow_fn()
    a, b = _pair()
    assert torch.equal(far(a, b), pairwise_flow_fn()(a, b))
    monkeypatch.setattr(runner, "_have_cv2", lambda: False)
    assert _is_gmflow(_pipe(tmp_path / "none.pth").consistency_flow_fn())
    assert "weights are random" in capsys.readouterr().out


def _gmflow_checkpoint(path):
    from fresco_torch.models.convert import to_checkpoint
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.gmflow.convert import gmflow_map
    from fresco_torch.models.layers import init_flax_default_

    gen = torch.Generator().manual_seed(5)
    m = init_flax_default_(GMFlow(GMFlowConfig()), gen).eval().requires_grad_(False)
    torch.save({"model": to_checkpoint(m.state_dict(), gmflow_map)}, path)
    return m


def test_default_flow_fn(tmp_path, monkeypatch):
    path = str(tmp_path / "gmflow_sintel-0c07dcb3.pth")
    module = _gmflow_checkpoint(path)
    a, b = _pair(1)
    with torch.no_grad():
        assert torch.equal(tvb.default_flow_fn(path, "cpu")(a, b), module(a, b))
    far = tvb.default_flow_fn(str(tmp_path / "absent.pth"), "cpu")
    assert torch.equal(far(a, b), pairwise_flow_fn()(a, b))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises
    with pytest.raises(ImportError) as e:
        tvb.default_flow_fn(str(tmp_path / "absent.pth"), "cpu")
    assert "cv2" in str(e.value) and "--gmflow" in str(e.value)


def test_blend_video_frames_without_flow_fn_takes_the_default(monkeypatch):
    seen = []

    def fake_default(gmflow_path=None, device=None):
        seen.append(device)
        return lambda a, b: torch.zeros(2 * a.shape[0], *a.shape[1:3], 2, device=a.device)

    monkeypatch.setattr(tvb, "default_flow_fn", fake_default)
    rng = np.random.default_rng(0)
    frames = {i: rng.integers(0, 256, (24, 24, 3)).astype(np.uint8) for i in range(3)}
    out = tvb.blend_video_frames(frames, {0: frames[0], 2: frames[2]}, [0, 2], device="cpu",
                                 patch_cfg=tvb.PatchMatchConfig(pm_iters=1, sv_iters=1, num_pyramid_levels=1))
    assert seen == [torch.device("cpu")] and sorted(out) == [0, 1, 2]


# ---------------------------------------------------------------- argument plumbing
BLEND_ARGVS = [
    "d --key_ind 0 5 9",
    "d --key_ind 0 4 --output o.mp4 --fps 24 --backend native --inpaint telea --n_proc 3 --n_devices auto "
    "-ps -ne -tmp --trim 0 --stop-threshold 2.5 --gmflow g.pth",
    "d --key_ind 2 4 8 --n_devices 2 --key k2 --trim 2",
]


def _bound(fn, args, kwargs) -> dict:
    b = inspect.signature(fn).bind(*args, **kwargs)
    b.apply_defaults()
    return dict(b.arguments)


def _capture(monkeypatch, module):
    calls = []
    real = module.blend_video
    monkeypatch.setattr(module, "blend_video", lambda *a, **k: calls.append(_bound(real, a, k)))
    monkeypatch.setattr(module, "default_flow_fn", lambda path=None, *_: ("default_flow_fn", path))
    return calls


@pytest.mark.parametrize("argv", BLEND_ARGVS)
def test_video_blend_main_matches_jax(argv, monkeypatch):
    from fresco_tpu.propagate import video_blend as jvb

    t_calls, j_calls = _capture(monkeypatch, tvb), _capture(monkeypatch, jvb)
    tvb.main(argv.split())
    jvb.main(argv.split())
    (t,), (j,) = t_calls, j_calls
    assert t.pop("device") is None
    j_cfg = j.pop("patch_cfg")
    assert t.pop("patch_cfg") == tvb.PatchMatchConfig(**{f.name: getattr(j_cfg, f.name)
                                                         for f in dataclasses.fields(j_cfg)})
    j["synth_backend"] = {"tpu": "jumpflood", "native": "native"}[j["synth_backend"]]
    assert t == j


@pytest.mark.parametrize("spelling,name", [("cuda", "jumpflood"), ("tpu", "jumpflood"), ("cpu", "native")])
def test_video_blend_backend_spellings(spelling, name, monkeypatch):
    calls = _capture(monkeypatch, tvb)
    tvb.main(f"d --key_ind 0 4 --backend {spelling} --device cpu".split())
    assert calls[0]["synth_backend"] == name and calls[0]["device"] == "cpu"


@pytest.mark.parametrize("max_process,gmflow", [(4, True), (1, False)])
def test_cli_run_config_matches_jax(tmp_path, monkeypatch, max_process, gmflow):
    """Both packages' run_config, their pipelines stubbed: the same
    blend_video arguments; the flow source GMFlow exactly when the
    checkpoint exists (Farneback otherwise in the port; JAX's blend_video
    falls back to it itself on flow_fn=None)."""
    from fresco_torch import cli as tcli
    from fresco_tpu import cli as jcli
    from fresco_tpu.core import cache
    from fresco_tpu.core.config import FrescoConfig as JaxConfig
    from fresco_tpu.pipeline import runner as jrunner
    from fresco_tpu.propagate import video_blend as jvb

    ckpt = tmp_path / "gmflow.pth"
    if gmflow:
        ckpt.write_bytes(b"")

    class TorchStub(runner.FrescoPipeline):
        def __init__(self, config, tiny=False, device=None):
            self.config, self.bundle, self.device = config, _Bundle(), torch.device("cpu")
            self.phases = runner.PhaseTimes()

        def translate_keyframe_files(self, reuse=False):
            return [0, 4, 7]

        def evaluate_consistency(self, frame_dir):
            return {}

    class JaxStub:
        def __init__(self, config, tiny=False):
            gm = type("GM", (), {"apply": staticmethod(lambda p, x, y: x)})
            self.bundle = type("B", (), {"gmflow": gm, "params": {"gmflow": None}})
            self.phases = type("P", (), {"times": {}})

        def translate_keyframes(self, reuse=False):
            return [0, 4, 7]

        def evaluate_consistency(self, frame_dir):
            return {}

    calls = {}

    def recorder(name):
        def blend_video(save_path, **kw):
            calls[name] = kw
            return str(tmp_path)
        return blend_video

    for name, mod, stub_mod, stub in (("t", tvb, runner, TorchStub), ("j", jvb, jrunner, JaxStub)):
        monkeypatch.setattr(stub_mod, "FrescoPipeline", stub)
        monkeypatch.setattr(mod, "blend_video", recorder(name))
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    kw = dict(save_path=str(tmp_path) + "/", run_ebsynth=True, max_process=max_process, gmflow_path=str(ckpt),
              file_path=str(tmp_path / "missing.mp4"))
    tcli.run_config(FrescoConfig(**kw))
    jcli.run_config(JaxConfig(**kw))
    t, j = calls["t"], calls["j"]
    assert _is_gmflow(t.pop("flow_fn")) is gmflow and (j.pop("flow_fn") is not None) is gmflow
    t.pop("device")
    assert t == j
    assert t["n_devices"] == ("auto" if max_process > 1 else 1)
