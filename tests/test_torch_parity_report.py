"""``fresco_torch.scripts.parity_report`` against ``scripts/parity_report.py``
on the CPU: ``make_table`` prints the same text for the same rows, the
``--reuse`` path builds the report without running the pipeline, and a
tiny sweep of the four bundled configs (9 frames at 64 px, 4 steps, tiny
random-weight models, ``--device cpu``) runs end to end into a 4-row table.
"""
import importlib.util
import json
import os

import pytest
import torch
import yaml

from fresco_torch.scripts import parity_report as pr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models are many small ops: one intra-op thread runs them as fast
    as eight, and does not fight the suite's other worker processes for
    the cores (eight threads a worker slowed this file many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_module():
    spec = importlib.util.spec_from_file_location("parity_report", os.path.join(REPO, "scripts", "parity_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROWS = [
    {"config": "config_music", "wall_s": 12.3,
     "input": {"warp_error": 1.39, "frame_similarity": 0.999, "frame_similarity_is_clip": False},
     "translated": {"warp_error": 32.3, "frame_similarity": 0.911, "frame_similarity_is_clip": False}},
    {"config": "config_dog", "wall_s": 1.0},  # missing metrics -> dashes
    {"config": "config_boxer", "wall_s": 1234.5678,
     "input": {"warp_error": 0.000123456, "frame_similarity": 1, "frame_similarity_is_clip": True},
     "translated": {"warp_error": None, "frame_similarity_is_clip": True}},
]


def test_make_table_matches_jax():
    table = pr.make_table(ROWS)
    assert table == _jax_module().make_table(ROWS)
    lines = table.splitlines()
    assert lines[0].count("|") == 8  # 7 columns
    assert "config_music" in lines[2] and "32.3" in lines[2] and "pixel proxy" in lines[2]
    assert "config_dog" in lines[3] and "—" in lines[3]
    assert "CLIP" in lines[4] and "1235" in lines[4]


def test_tiny_four_config_sweep(tmp_path, monkeypatch):
    """All four bundled demo configs run end to end from the repo alone:
    keyframe translation, propagation and metrics per config."""
    monkeypatch.chdir(REPO)  # configs use ./data/... relative paths
    out_json, out_md = tmp_path / "report.json", tmp_path / "PARITY_tiny.md"
    rc = pr.main([
        "--tiny", "--frame-count", "9", "--resolution", "64", "--steps", "4", "--device", "cpu",
        "--out-root", str(tmp_path / "runs"), "--out", str(out_json), "--md", str(out_md),
    ])
    assert rc == 0
    rows = json.loads(out_json.read_text())
    assert [r["config"] for r in rows] == ["config_boxer", "config_carturn", "config_dog", "config_music"]
    for r in rows:
        assert r["translated"]["warp_error"] is not None
        assert 0.0 < r["translated"]["frame_similarity"] <= 1.0
        assert r["input"]["warp_error"] is not None
        run = tmp_path / "runs" / r["config"]
        keys = sorted(int(f[:4]) for f in os.listdir(run / "keys"))
        assert keys[0] == 0 and sorted(os.listdir(run / "blend")) == [f"{i:04d}.png" for i in range(keys[-1] + 1)]
    md = out_md.read_text()
    assert md.count("config_") == 4 and pr.make_table(rows) in md


def test_reuse_path_builds_report_without_running(tmp_path, monkeypatch):
    save = tmp_path / "out"
    save.mkdir()
    metrics = {
        "translated": {"warp_error": 2.0, "frame_similarity": 0.95, "frame_similarity_is_clip": True},
        "input": {"warp_error": 1.0, "frame_similarity": 0.99, "frame_similarity_is_clip": True},
    }
    (save / "metrics.json").write_text(json.dumps(metrics))
    cfg_path = tmp_path / "config_fake.yaml"
    cfg_path.write_text(yaml.safe_dump({"file_path": "/nonexistent.mp4", "save_path": str(save) + "/",
                                        "prompt": "x"}))

    import fresco_torch.cli as cli

    def boom(*a, **k):
        raise AssertionError("run_config called despite --reuse")

    monkeypatch.setattr(cli, "run_config", boom)
    out_json, out_md = tmp_path / "report.json", tmp_path / "PARITY_test.md"
    rc = pr.main(["--configs", str(cfg_path), "--reuse", "--out", str(out_json), "--md", str(out_md)])
    assert rc == 0
    rows = json.loads(out_json.read_text())
    assert rows[0]["config"] == "config_fake"
    assert rows[0]["translated"]["warp_error"] == 2.0
    md = out_md.read_text()
    assert "CLIP" in md and "config_fake" in md


@pytest.mark.parametrize("argv,want", [
    (["--device", "cpu"], dict(tiny=False, keyframes_only=False, reuse_synthesis=False, sync_phases=False,
                               device="cpu", random_aux_weights=False)),
    (["--keyframes-only", "--reuse", "--sync-phases", "--random-aux-weights", "--device", "cpu",
      "--save-path", "elsewhere/"],
     dict(tiny=False, keyframes_only=True, reuse_synthesis=True, sync_phases=True, device="cpu",
          random_aux_weights=True)),
])
def test_run_e2e_forces_propagation(argv, want, monkeypatch):
    """run_e2e, the counterpart of scripts/run_e2e.py, hands run_config the
    config from its file with propagation forced on, its flags and a dict
    for the readings."""
    import fresco_torch.cli as cli
    from fresco_torch.core.config import load_config
    from fresco_torch.scripts import run_e2e

    calls = []
    monkeypatch.setattr(cli, "run_config", lambda cfg, **kw: calls.append((cfg, kw)) or {"translated": {}})
    path = os.path.join(REPO, "config", "config_music.yaml")
    assert run_e2e.main([path] + argv) == {"translated": {}}
    (cfg, kw), = calls
    assert isinstance(kw.pop("readings"), dict)  # the dict run_e2e writes with --readings
    base = load_config(path)
    assert cfg == base.replace(run_ebsynth=True, save_path="elsewhere/" if len(argv) > 2 else base.save_path)
    assert kw == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default is valid")
def test_run_e2e_defaults_to_the_card(monkeypatch):
    """Without --device run_e2e runs on the card, and raises on a machine
    without one before anything runs."""
    import fresco_torch.cli as cli
    from fresco_torch.scripts import run_e2e

    monkeypatch.setattr(cli, "run_config", lambda cfg, **kw: pytest.fail("ran without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_e2e.main([os.path.join(REPO, "config", "config_music.yaml")])


def test_run_config_random_aux_weights(tmp_path, monkeypatch):
    """run_config(random_aux_weights=True), which run_e2e and parity_report
    pass on, builds the models with seeded random detector and EGNet
    weights and hands that bundle to the pipeline."""
    from fresco_torch import cli
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

    seen = {}

    def fake_build(config, **kw):
        seen["build"] = kw
        return "bundle"

    class StubPipeline:
        def __init__(self, config, bundle=None, tiny=False, device=None):
            seen["pipeline"] = (bundle, tiny, device)
            self.phases = runner.PhaseTimes()
            self.batch_seconds = []

        def translate_keyframe_files(self, reuse=False):
            return [0]

    monkeypatch.setattr(runner, "build_models", fake_build)
    monkeypatch.setattr(runner, "FrescoPipeline", StubPipeline)
    cfg = FrescoConfig(save_path=str(tmp_path) + "/", seed=5)
    assert cli.run_config(cfg, tiny=True, device="cpu", random_aux_weights=True) is None
    assert seen == {"build": dict(tiny=True, seed=5, device="cpu", random_aux_weights=True),
                    "pipeline": ("bundle", True, "cpu")}
