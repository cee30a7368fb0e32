"""Gradio WebUI (PyTorch).

Counterpart of ``fresco_tpu/webui.py`` (reference webUI.py): prompt, seed
and resolution controls, a toggle for each FRESCO mechanism (cross-frame,
spatial-guided and temporal-guided attention, feature optimization,
background smoothing), SDEdit strength, ControlNet type and scale, FreeU,
the SD base, and the three actions Run Key Frames, Run Propagation and
Run All (webUI.py:631-635).

The models run on the card unless the caller asks for the CPU:
``STATE.device`` (``launch(device=...)``), as ``cli.run_config``'s
``device``.  gradio is optional: importing this module needs none, and
``launch()`` raises a clear error without it.

    python -m fresco_torch.webui
"""
from __future__ import annotations

import dataclasses
import os

import torch

from fresco_torch.core.config import FrescoConfig


@dataclasses.dataclass
class GlobalState:
    """Lazy model store with hot-swap (reference webUI.py:149-200).

    ``device``: where the models run (None: the card).
    ``random_aux_weights``: give the control detector and EGNet seeded
    random weights where their checkpoints are missing
    (``build_models``), so that they run without them."""

    config: FrescoConfig | None = None
    pipeline: object | None = None
    sd_path: str | None = None
    controlnet_type: str | None = None
    lora_path: str | None = None
    lora_scale: float | None = None
    device: torch.device | str | None = None
    random_aux_weights: bool = False

    def get_pipeline(self, config: FrescoConfig, tiny: bool = False):
        from fresco_torch.pipeline import runner

        # model-affecting fields force a rebuild (webUI.py:168-200
        # hot-swap); everything else is adopted in place by set_config, so
        # that sampler-level controls (steps, strength, toggles) take effect
        # without reloading weights.  The FreeU factors and the canny
        # thresholds are built into the models and force none, as in the
        # JAX package (ROADMAP F20).
        old = self.config
        rebuild = (
            self.pipeline is None
            or self.sd_path != config.sd_path
            or self.controlnet_type != config.controlnet_type
            or self.lora_path != config.lora_path
            or self.lora_scale != config.lora_scale
            or old is None
            or old.use_freeu != config.use_freeu
            or old.use_saliency != config.use_saliency
            or old.dtype != config.dtype
        )
        if rebuild:
            self.pipeline = None  # the old models go before the new are built
            bundle = runner.build_models(config, tiny=tiny, seed=config.seed, device=self.device,
                                         random_aux_weights=self.random_aux_weights)
            self.pipeline = runner.FrescoPipeline(config, bundle)
            self.sd_path = config.sd_path
            self.controlnet_type = config.controlnet_type
            self.lora_path = config.lora_path
            self.lora_scale = config.lora_scale
        else:
            self.pipeline.set_config(config)
        self.config = config
        return self.pipeline


STATE = GlobalState()


def ui_to_config(
    file_path, prompt, sd_path, seed, resolution, cond_scale, controlnet_type,
    x0_strength, num_inference_steps, batch_size, mininterv, maxinterv,
    use_controlnet, use_cfattn, use_intraattn, use_interattn, use_optflow,
    use_saliency, use_freeu, save_path, lora_path="", lora_scale=1.0,
    guidance_scale=7.5, a_prompt=None, n_prompt=None,
    canny_low=50, canny_high=100,
    freeu_b1=None, freeu_b2=None, freeu_s1=None, freeu_s2=None,
    use_poisson=True, max_process=4, frame_count=0,
) -> FrescoConfig:
    """UI controls -> typed config (reference webUI.py:115-146 inverse).
    The parameter order is the Blocks ``inputs`` wiring order.

    x0_strength maps to warmup steps:
    num_warmup_steps = int(steps * (1 - x0_strength)) (webUI.py:337-338).
    Control for control as reference webUI.py:447-578 ``ips``:
    input_path->file_path, prompt, sd_model->sd_path, seed,
    image_resolution->resolution, control_strength->cond_scale,
    x0_strength (above), control_type->controlnet_type,
    low/high_threshold->canny_low/high, ddpm_steps->num_inference_steps,
    scale->guidance_scale, a_prompt, n_prompt, frame_count, batch_size,
    mininterv, maxinterv, use_constraints->use_cfattn/use_intraattn/
    use_interattn/use_optflow, bg_smooth->use_saliency,
    use_poisson, max_process, b1/b2/s1/s2->freeu_b1/b2/s1/s2.
    """
    freeu = {
        k: float(v)
        for k, v in dict(
            freeu_b1=freeu_b1, freeu_b2=freeu_b2,
            freeu_s1=freeu_s1, freeu_s2=freeu_s2,
        ).items()
        if v is not None
    }
    return FrescoConfig(
        file_path=file_path,
        save_path=save_path,
        prompt=prompt,
        sd_path=sd_path,
        seed=int(seed),
        resolution=int(resolution),
        cond_scale=float(cond_scale),
        controlnet_type=controlnet_type,
        canny_low=int(canny_low),
        canny_high=int(canny_high),
        num_inference_steps=int(num_inference_steps),
        num_warmup_steps=int(num_inference_steps * (1 - x0_strength)),
        batch_size=int(batch_size),
        mininterv=int(mininterv),
        maxinterv=int(maxinterv),
        use_controlnet=bool(use_controlnet),
        use_fresco_attn=bool(use_cfattn or use_intraattn or use_interattn),
        use_cfattn=bool(use_cfattn),
        num_intraattn_steps=(
            FrescoConfig.num_intraattn_steps if use_intraattn else 0
        ),
        # past the largest timestep (1000), so it never fires; the enabled
        # value is the typed config's default
        step_interattn_end=(
            FrescoConfig.step_interattn_end if use_interattn else 1001
        ),
        use_fresco_opt=bool(use_optflow),
        use_saliency=bool(use_saliency),
        use_freeu=bool(use_freeu),
        lora_path=str(lora_path) or None,
        lora_scale=float(lora_scale),
        guidance_scale=float(guidance_scale),
        a_prompt=(str(a_prompt) if a_prompt else None),
        n_prompt=(str(n_prompt) if n_prompt else None),
        use_poisson=bool(use_poisson),
        max_process=int(max_process),
        frame_count=(int(frame_count) or None),
        **freeu,
    )


def example_inputs(config_path: str) -> list:
    """YAML demo config -> UI input values, in the Blocks ``inputs`` order
    (reference webUI.py:115-146 ``cfg_to_input`` for its example gallery;
    the prompt suffixes follow the model family, ``default_prompts``)."""
    from fresco_torch.core.config import default_prompts, load_config

    cfg = load_config(config_path)
    steps = cfg.num_inference_steps
    strength = (steps - cfg.num_warmup_steps) / steps
    a_prompt, n_prompt = default_prompts(cfg.sd_path)
    return [
        cfg.file_path, cfg.prompt, cfg.sd_path, cfg.seed, 512,
        cfg.cond_scale, cfg.controlnet_type, strength, steps,
        cfg.batch_size, cfg.mininterv, cfg.maxinterv,
        True, True, True, True, True,   # controlnet + 4 constraints
        cfg.use_saliency, False, cfg.save_path, "", 1.0,
        7.5, a_prompt, n_prompt, 50, 100,
        1.0, 1.0, 1.0, 1.0,             # FreeU sliders (reference value 1)
        True, 4, 0,
    ]


def process1(config: FrescoConfig, tiny: bool = False):
    """Run Key Frames (reference webUI.py:210-374): the keyframes of the
    config's video under save_path/keys/; returns their indices."""
    pipe = STATE.get_pipeline(config, tiny=tiny)
    return pipe.translate_keyframe_files()


def visible_devices(device: torch.device) -> int:
    """The devices an interval wave may use: the visible cards, or the one
    CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def process2(config: FrescoConfig, keys):
    """Run Propagation (reference webUI.py:377-407): save_path/blend/ and
    save_path/blend.mp4 from the keyframes under save_path/keys/; returns
    the mp4's path."""
    from fresco_torch.pipeline.runner import resolve_device
    from fresco_torch.propagate.video_blend import blend_video, get_fps

    device = resolve_device(STATE.device)
    fps = int(get_fps(config.file_path)) or 30
    out = os.path.join(config.save_path, "blend.mp4")
    # max_process (the reference's worker-process count) is the width of an
    # interval wave: one synthesis chain per device
    blend_video(config.save_path, list(keys), "keys", out, fps,
                config.max_process, poisson=config.use_poisson,
                n_devices=min(config.max_process, visible_devices(device)), device=device)
    return out


def process(config: FrescoConfig, tiny: bool = False):
    """Run All."""
    keys = process1(config, tiny=tiny)
    return process2(config, keys)


def launch(tiny: bool = False, device: torch.device | str | None = None, **launch_kwargs):
    """Build and launch the gradio Blocks app; its handlers run on
    ``device`` (None: the card)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; the WebUI requires "
            "`pip install gradio`. The same functionality is available via "
            "`python -m fresco_torch.cli <config.yaml>`."
        ) from e
    STATE.device = device

    with gr.Blocks() as app:
        gr.Markdown("## FRESCO video-to-video translation (PyTorch + CUDA)")
        with gr.Row():
            file_path = gr.Textbox(label="Input video", value="./data/music.mp4")
            save_path = gr.Textbox(label="Output dir", value="./output/ui/")
        prompt = gr.Textbox(label="Prompt")
        with gr.Row():
            sd_path = gr.Dropdown(
                label="SD base",
                choices=[
                    "runwayml/stable-diffusion-v1-5",
                    "stablediffusionapi/rev-animated",
                    "SG161222/Realistic_Vision_V2.0",
                    "wavymulder/flat-2d-animerge",
                ],
                value="runwayml/stable-diffusion-v1-5",
                allow_custom_value=True,
            )
            controlnet_type = gr.Radio(
                ["hed", "canny", "depth"], label="ControlNet", value="hed"
            )
        with gr.Row():
            lora_path = gr.Textbox(
                label="LoRA checkpoint (kohya .safetensors, optional)", value=""
            )
            lora_scale = gr.Slider(0.0, 2.0, value=1.0, label="LoRA scale")
        with gr.Row():
            seed = gr.Number(label="Seed", value=0, precision=0)
            resolution = gr.Slider(256, 768, value=512, step=64, label="Resolution")
            cond_scale = gr.Slider(0.0, 2.0, value=0.7, label="ControlNet scale")
            x0_strength = gr.Slider(0.0, 1.05, value=0.75, label="Denoise strength")
        with gr.Row():
            num_steps = gr.Slider(1, 50, value=20, step=1, label="DDPM steps")
            batch_size = gr.Slider(1, 8, value=8, step=1, label="Keyframe batch")
            mininterv = gr.Slider(1, 50, value=5, step=1, label="Min interval")
            maxinterv = gr.Slider(1, 100, value=20, step=1, label="Max interval")
        # advanced single-frame options (reference webUI.py:445-519)
        with gr.Accordion("Advanced options for single frame processing",
                          open=False):
            guidance_scale = gr.Slider(1.1, 30.0, value=7.5, step=0.1,
                                       label="CFG scale")
            a_prompt = gr.Textbox(label="Added prompt",
                                  value="best quality, extremely detailed")
            n_prompt = gr.Textbox(
                label="Negative prompt",
                value=("longbody, lowres, bad anatomy, bad hands, "
                       "missing fingers, extra digit, fewer digits, "
                       "cropped, worst quality, low quality"))
            with gr.Row():
                canny_low = gr.Slider(1, 255, value=50, step=1,
                                      label="Canny low threshold")
                canny_high = gr.Slider(1, 255, value=100, step=1,
                                       label="Canny high threshold")
            with gr.Row():
                freeu_b1 = gr.Slider(1.0, 1.6, value=1.0, step=0.01,
                                     label="FreeU first-stage backbone factor")
                freeu_b2 = gr.Slider(1.0, 1.6, value=1.0, step=0.01,
                                     label="FreeU second-stage backbone factor")
            with gr.Row():
                freeu_s1 = gr.Slider(0.0, 1.0, value=1.0, step=0.01,
                                     label="FreeU first-stage skip factor")
                freeu_s2 = gr.Slider(0.0, 1.0, value=1.0, step=0.01,
                                     label="FreeU second-stage skip factor")
        with gr.Accordion("FRESCO constraints", open=False):
            frame_count = gr.Slider(0, 300, value=0, step=1,
                                    label="Number of frames (0 = all)")
            use_controlnet = gr.Checkbox(label="ControlNet", value=True)
            use_cfattn = gr.Checkbox(label="Cross-frame attention", value=True)
            use_intraattn = gr.Checkbox(label="Spatial-guided attention", value=True)
            use_interattn = gr.Checkbox(label="Temporal-guided attention", value=True)
            use_optflow = gr.Checkbox(label="Feature optimization", value=True)
            use_saliency = gr.Checkbox(label="Background smoothing", value=True)
            use_freeu = gr.Checkbox(label="FreeU", value=False)
        # advanced full-video options (reference webUI.py:564-580)
        with gr.Accordion("Advanced options for the full video translation",
                          open=False):
            use_poisson = gr.Checkbox(
                label="Gradient blending", value=True,
                info="Blend the output video in gradient, to reduce "
                     "ghosting artifacts (but may increase flickers)")
            max_process = gr.Slider(
                1, 16, value=4, step=1,
                label="Number of parallel synthesis chains (devices)")
        with gr.Row():
            btn_keys = gr.Button("Run Key Frames")
            btn_prop = gr.Button("Run Propagation")
            btn_all = gr.Button("Run All")
        result = gr.Video(label="Result")
        log = gr.Textbox(label="Log")

        inputs = [
            file_path, prompt, sd_path, seed, resolution, cond_scale,
            controlnet_type, x0_strength, num_steps, batch_size, mininterv,
            maxinterv, use_controlnet, use_cfattn, use_intraattn,
            use_interattn, use_optflow, use_saliency, use_freeu, save_path,
            lora_path, lora_scale,
            guidance_scale, a_prompt, n_prompt, canny_low, canny_high,
            freeu_b1, freeu_b2, freeu_s1, freeu_s2,
            use_poisson, max_process, frame_count,
        ]

        # example-config gallery (reference webUI.py:582-594)
        cfg_dir = os.path.join(os.path.dirname(__file__), "..", "config")
        examples = sorted(
            os.path.join(cfg_dir, f)
            for f in (os.listdir(cfg_dir) if os.path.isdir(cfg_dir) else [])
            if f.endswith(".yaml")
        )
        if examples:
            gr.Examples(
                examples=[example_inputs(p) for p in examples],
                inputs=inputs,
            )

        def _run_keys(*args):
            cfg = ui_to_config(*args)
            keys = process1(cfg, tiny=tiny)
            return f"translated {len(keys)} keyframes: {keys}"

        def _run_prop(*args):
            cfg = ui_to_config(*args)
            keys = sorted(
                int(f.split(".")[0])
                for f in os.listdir(os.path.join(cfg.save_path, "keys"))
                if f.endswith(".png")
            )
            return process2(cfg, keys)

        def _run_all(*args):
            cfg = ui_to_config(*args)
            return process(cfg, tiny=tiny)

        btn_keys.click(_run_keys, inputs, log)
        btn_prop.click(_run_prop, inputs, result)
        btn_all.click(_run_all, inputs, result)

    app.launch(**launch_kwargs)
    return app


if __name__ == "__main__":
    launch()
