"""``fresco_torch.webui`` against ``fresco_tpu.webui`` on the CPU: each of
tests/test_webui.py's nine tests has its counterpart here.

``ui_to_config`` and ``example_inputs`` are held field for field against
the JAX functions on the same arguments (exact equality of every
``FrescoConfig`` field).  ``launch`` runs under the recording-fake gradio
of tests/gradio_stub.py and must build the same Blocks tree as the JAX
module's (every control's type, label, value and options, in order; the
buttons; the example rows).  The three click handlers run end to end on
tiny random-weight models with ``device="cpu"`` on the first 9 frames of
data/music.mp4 at 64 px: keyframes, then propagation into blend.mp4, then
both, building the models once.
"""
import dataclasses
import glob
import inspect
import os
import sys

import pytest
import torch

from fresco_torch import webui as w
from fresco_torch.core.config import FrescoConfig
from fresco_torch.webui import GlobalState, example_inputs, ui_to_config
from fresco_tpu import webui as jw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.yaml")))

#: ui_to_config's positional parameter order == the Blocks `inputs` wiring
#: order (reference webUI.py:447-578 ips)
UI_PARAM_NAMES = [p.name for p in inspect.signature(ui_to_config).parameters.values()]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models are many small ops: one intra-op thread runs them as fast
    as eight, and does not fight the suite's other worker processes for
    the cores (eight threads a worker slowed this file many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub():
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        import gradio_stub
    finally:
        sys.path.pop(0)
    return gradio_stub


def _launch_stubbed(module, monkeypatch, **kwargs):
    """``module.launch()`` with the recording-fake gradio installed; returns
    the stub Blocks app."""
    monkeypatch.setitem(sys.modules, "gradio", _stub())
    return module.launch(**kwargs)


def _base_args(**over):
    args = dict(
        file_path="v.mp4", prompt="p", sd_path="runwayml/stable-diffusion-v1-5",
        seed=3, resolution=512, cond_scale=0.7, controlnet_type="hed",
        x0_strength=0.75, num_inference_steps=20, batch_size=8,
        mininterv=5, maxinterv=20, use_controlnet=True, use_cfattn=True,
        use_intraattn=True, use_interattn=True, use_optflow=True,
        use_saliency=True, use_freeu=False, save_path="./out/",
    )
    args.update(over)
    return list(args.values())


def _both(*args, **kw):
    """ui_to_config of both packages on the same arguments; the port's,
    after every field is checked equal to the JAX one's."""
    got, want = ui_to_config(*args, **kw), jw.ui_to_config(*args, **kw)
    assert type(got) is FrescoConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


def test_x0_strength_maps_to_warmup():
    cfg = _both(*_base_args(x0_strength=0.75, num_inference_steps=20))
    # num_warmup_steps = int(steps * (1 - strength)) (webUI.py:337-338)
    assert cfg.num_warmup_steps == 5
    assert _both(*_base_args(x0_strength=1.0)).num_warmup_steps == 0


def test_mechanism_toggles():
    assert _both(*_base_args(use_interattn=False)).step_interattn_end > 1000  # never reached
    assert _both(*_base_args(use_intraattn=False)).num_intraattn_steps == 0
    cfg = _both(*_base_args(use_cfattn=False, use_intraattn=False, use_interattn=False))
    assert cfg.use_fresco_attn is False
    assert _both(*_base_args(use_optflow=False)).use_fresco_opt is False


def test_global_state_rebuild_policy(monkeypatch):
    """The same rebuild list as fresco_tpu/webui.py:41-51: the models are
    built (build_models, on the state's device) only where a
    model-affecting field changes; everything else goes through set_config."""
    from fresco_torch.pipeline import runner

    builds = []

    class FakePipe:
        def __init__(self, config, bundle):
            self.config, self.bundle = config, bundle
            self.sampler_cfg_rebuilt = 0

        def set_config(self, config):
            self.config = config
            self.sampler_cfg_rebuilt += 1

    def fake_build(config, *, tiny, seed, device, random_aux_weights):
        builds.append((config, tiny, seed, device, random_aux_weights))
        return object()

    monkeypatch.setattr(runner, "FrescoPipeline", FakePipe)
    monkeypatch.setattr(runner, "build_models", fake_build)
    gs = GlobalState(device="cpu", random_aux_weights=True)
    cfg = ui_to_config(*_base_args())
    p1 = gs.get_pipeline(cfg)
    assert builds == [(cfg, False, 3, "cpu", True)]
    p2 = gs.get_pipeline(cfg.replace(prompt="other"))
    assert p1 is p2  # same models -> reuse (webUI hot-swap semantics)
    # sampler-level controls go through set_config, not a bare config swap
    assert p2.sampler_cfg_rebuilt == 1
    p2b = gs.get_pipeline(cfg.replace(num_inference_steps=30, seed=9, canny_low=7, freeu_b1=1.4))
    assert p2b is p1 and p2b.config.num_inference_steps == 30
    assert p2b.sampler_cfg_rebuilt == 2 and len(builds) == 1
    # model-affecting fields force a rebuild, each of them
    for field, value in (("use_freeu", True), ("sd_path", "stablediffusionapi/rev-animated"),
                         ("controlnet_type", "depth"), ("lora_path", "l.safetensors"), ("lora_scale", 0.5),
                         ("use_saliency", False), ("dtype", "float32")):
        n = len(builds)
        p = gs.get_pipeline(gs.config.replace(**{field: value}))
        assert p is not p1 and len(builds) == n + 1, field
        p1 = p


def test_x0_strength_above_one_gives_negative_warmup():
    """Slider max 1.05 (reference semantics: pure-noise init, all steps);
    the sampler consumes the negative warmup as pipe_FRESCO.py:155-157."""
    assert _both(*_base_args(x0_strength=1.05, num_inference_steps=20)).num_warmup_steps < 0


def test_advanced_controls_map_to_config():
    cfg = _both(
        *_base_args(),
        guidance_scale=11.5, a_prompt="ap", n_prompt="np",
        canny_low=10, canny_high=200,
        freeu_b1=1.3, freeu_b2=1.4, freeu_s1=0.9, freeu_s2=0.2,
        use_poisson=False, max_process=8, frame_count=120,
    )
    assert cfg.guidance_scale == 11.5
    assert cfg.a_prompt == "ap" and cfg.n_prompt == "np"
    assert (cfg.canny_low, cfg.canny_high) == (10, 200)
    assert (cfg.freeu_b1, cfg.freeu_b2, cfg.freeu_s1, cfg.freeu_s2) == (1.3, 1.4, 0.9, 0.2)
    assert cfg.use_poisson is False
    assert cfg.max_process == 8
    assert cfg.frame_count == 120


def test_advanced_controls_defaults():
    """Omitted advanced controls keep the typed-config defaults, frame_count
    0 -> None (all frames), FreeU factors untouched."""
    cfg = _both(*_base_args())
    d = FrescoConfig()
    assert cfg.guidance_scale == d.guidance_scale == 7.5
    assert cfg.a_prompt is None and cfg.n_prompt is None
    assert (cfg.canny_low, cfg.canny_high) == (50, 100)
    assert cfg.freeu_b1 == d.freeu_b1 and cfg.freeu_s2 == d.freeu_s2
    assert cfg.use_poisson is True
    assert cfg.frame_count is None


def _tree(app):
    """The Blocks tree as comparable data: each control's type, label,
    value, options and other arguments, in order; buttons; examples."""
    def control(c):
        return (type(c).__name__, c.label, c.value, c.args, sorted(c.kwargs.items()),
                getattr(c, "choices", None), getattr(c, "minimum", None), getattr(c, "maximum", None))

    index = {id(c): i for i, c in enumerate(app.components)}
    return ([control(c) for c in app.components],
            [(label, [index[id(c)] for c in ins], index[id(out)]) for label, _, ins, out in app.buttons],
            [(rows, [index[id(c)] for c in ins]) for rows, ins in app.examples])


def test_launch_constructs_under_stub(monkeypatch):
    """webui.launch() builds the full Blocks app: 34 controls wired in
    ui_to_config order, three buttons with handlers, an example row for
    every demo config, launch kwargs passed through; the same tree as
    fresco_tpu.webui.launch()'s."""
    monkeypatch.setattr(w, "STATE", GlobalState())
    app = _launch_stubbed(w, monkeypatch, tiny=True, device="cpu", server_port=7861)
    assert app.launched == {"server_port": 7861}
    assert w.STATE.device == "cpu"
    japp = _launch_stubbed(jw, monkeypatch, tiny=True, server_port=7861)
    assert _tree(app) == _tree(japp)
    assert len(app.markdown) == len(japp.markdown) == 1

    labels = [b[0] for b in app.buttons]
    assert labels == ["Run Key Frames", "Run Propagation", "Run All"]
    inputs = app.buttons[0][2]
    assert all(b[2] is inputs for b in app.buttons)
    assert len(inputs) == len(UI_PARAM_NAMES) == 34

    # the control defaults, fed positionally, land on the right fields: this
    # pins the inputs order to ui_to_config's signature
    cfg = _both(*[c.value for c in inputs])
    assert cfg.file_path == "./data/music.mp4"
    assert cfg.save_path == "./output/ui/"
    assert cfg.sd_path == "runwayml/stable-diffusion-v1-5"
    assert cfg.controlnet_type == "hed"
    assert cfg.num_inference_steps == 20 and cfg.num_warmup_steps == 5
    assert cfg.batch_size == 8
    assert (cfg.mininterv, cfg.maxinterv) == (5, 20)
    assert (cfg.canny_low, cfg.canny_high) == (50, 100)
    assert cfg.guidance_scale == 7.5
    assert cfg.use_poisson is True and cfg.max_process == 4
    assert cfg.frame_count is None

    rows, ex_inputs = app.examples[0]
    assert ex_inputs is inputs
    assert len(rows) == len(CONFIGS) >= 4
    assert all(len(r) == 34 for r in rows)


def test_launch_handlers_run_tiny(tmp_path, monkeypatch):
    """Each button's click handler runs end to end on tiny models on the
    CPU: Run Key Frames translates, Run Propagation blends from the written
    keys into blend.mp4, Run All does both on the same pipeline (the models
    are built once)."""
    import cv2

    from fresco_torch.pipeline import runner

    builds = []
    real_build = runner.build_models

    def counting_build(config, **kw):
        builds.append(kw)
        return real_build(config, **kw)

    monkeypatch.setattr(runner, "build_models", counting_build)
    monkeypatch.setattr(w, "STATE", GlobalState())
    app = _launch_stubbed(w, monkeypatch, tiny=True, device="cpu")
    inputs = app.buttons[0][2]
    v = dict(zip(UI_PARAM_NAMES, [c.value for c in inputs]))
    v.update(
        file_path=os.path.join(REPO, "data", "music.mp4"),
        save_path=str(tmp_path) + "/",
        prompt="a cartoon",
        resolution=64,
        num_inference_steps=4,
        x0_strength=0.5,
        mininterv=4,
        maxinterv=4,
        frame_count=9,             # keys 0,4,8 -> 2 tiny intervals
        controlnet_type="canny",   # no detector weights needed
        use_saliency=False,        # no EGNet weights offline
        use_freeu=False,
        use_poisson=False,
        max_process=1,
    )
    args = [v[n] for n in UI_PARAM_NAMES]
    handlers = {label: fn for label, fn, _, _ in app.buttons}

    log = handlers["Run Key Frames"](*args)
    assert log == "translated 3 keyframes: [0, 4, 8]"
    assert sorted(os.listdir(tmp_path / "keys")) == ["0000.png", "0004.png", "0008.png"]
    pipe = w.STATE.pipeline
    assert pipe.device == torch.device("cpu")

    out = handlers["Run Propagation"](*args)
    assert out == os.path.join(str(tmp_path) + "/", "blend.mp4") and os.path.exists(out)
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    cap.release()

    os.remove(out)
    out2 = handlers["Run All"](*args)
    assert os.path.exists(out2)
    assert w.STATE.pipeline is pipe and len(builds) == 1
    assert builds[0]["device"] == "cpu" and builds[0]["tiny"] is True


def test_example_inputs_roundtrip():
    """The example rows (reference webUI.py cfg_to_input) equal the JAX
    module's, and fed to ui_to_config reproduce each YAML config's values."""
    from fresco_torch.core.config import load_config

    assert CONFIGS, "demo configs missing"
    for p in CONFIGS:
        row = example_inputs(p)
        assert row == jw.example_inputs(p)
        cfg = _both(*row)
        want = load_config(p)
        assert cfg.prompt == want.prompt
        assert cfg.sd_path == want.sd_path
        assert cfg.controlnet_type == want.controlnet_type
        assert cfg.num_inference_steps == want.num_inference_steps
        assert cfg.num_warmup_steps == want.num_warmup_steps
        assert cfg.batch_size == want.batch_size
        assert (cfg.mininterv, cfg.maxinterv) == (want.mininterv, want.maxinterv)


def test_launch_without_gradio_raises_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    with pytest.raises(RuntimeError, match="gradio is not installed.*fresco_torch.cli"):
        w.launch()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default device is valid")
def test_pipeline_defaults_to_the_card():
    """Without a device the WebUI's models go to the card, and on a
    machine with none the build raises instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GlobalState().get_pipeline(ui_to_config(*_base_args()), tiny=True)


def test_a_clip_that_does_not_decode_raises(tmp_path, monkeypatch):
    """Run Key Frames on a file that yields no frame fails loudly; nothing
    stands in other frames."""
    bad = tmp_path / "not_a_video.mp4"
    bad.write_bytes(b"no frames here")
    monkeypatch.setattr(w, "STATE", GlobalState(device="cpu"))
    cfg = ui_to_config(*_base_args(file_path=str(bad), save_path=str(tmp_path / "out") + "/", resolution=64,
                                   controlnet_type="canny", use_saliency=False))
    with pytest.raises(RuntimeError, match="no frame could be decoded"):
        w.process1(cfg, tiny=True)
