"""Gradio UI: audio upload + prompt -> image (port of
``clap2diffusion_tpu/apps/gradio_app.py``), with the reference app's knobs
(model, norm 10-200, steps 20-100, CFG 1-20, seed) and the port's
samplers, img2img, inpainting and two-audio mixing.

gradio is imported only by ``launch``; ``build_generator`` (the click
handler) runs and is tested without it. Best-of-N reranks N candidates by
CLIPScore on the card (``AudioToImagePipeline.generate_best_of``; it needs
the CLIP vision weights).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from clap2diffusion_tpu_torch.core.config import Config

_MODEL_TYPES = {
    "Hierarchical V4": "hierarchical",
    "SonicDiffusion": "sonic",
    "Baseline": "baseline",
    "Audio tokens only": "audio_tokens",
}


def build_generator(cfg: Config, device=None, pipe=None):
    """The click handler over ``pipe`` (or a new random-weight pipeline on
    ``device``, CUDA unless the caller asks for the CPU)."""
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    pipe = pipe or AudioToImagePipeline(cfg, device=device)
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)

    def generate(audio_path, prompt, model_name, norm_value, steps, cfg_scale,
                 seed, sampler="ddim", negative="", init_image=None,
                 strength=0.8, audio2_path=None, audio_mix=0.5,
                 mask_image=None, cfg_rescale=0.0, best_of=1):
        wav = pipe.load_audio(audio_path) if audio_path else None
        # the mask is decoded whether or not there is an init image, so that
        # the pipeline's "mask_image requires init_image" reaches the UI
        init = pipe.load_init_image(init_image) if init_image is not None else None
        mask = pipe.load_init_image(mask_image, mask=True) if mask_image is not None else None
        if int(best_of) > 1:
            if init is not None or mask is not None:
                raise ValueError("best-of-n is unsupported with init/mask images (candidates "
                                 "need per-lane seeds)")
            img, scores = pipe.generate_best_of(
                int(best_of),
                waveform=wav,
                text_ids=tok(prompt or ""),
                uncond_ids=tok(negative or ""),
                num_steps=int(steps),
                guidance_scale=float(cfg_scale),
                norm_target=float(norm_value),
                model_type=_MODEL_TYPES.get(model_name, "hierarchical"),
                seed=int(seed),
                sampler=str(sampler),
                waveform2=pipe.load_audio(audio2_path) if audio2_path else None,
                audio_mix=float(audio_mix),
                guidance_rescale=float(cfg_rescale),
            )
            info = (f"model={model_name} steps={int(steps)} cfg={cfg_scale} "
                    f"norm={norm_value} seed={int(seed)} sampler={sampler} "
                    f"best_of={int(best_of)} clip_scores={[round(float(s), 2) for s in scores]}")
            return np.asarray(img), info
        img = pipe.generate(
            waveform=wav,
            text_ids=tok(prompt or ""),
            uncond_ids=tok(negative or ""),
            num_steps=int(steps),
            guidance_scale=float(cfg_scale),
            norm_target=float(norm_value),
            model_type=_MODEL_TYPES.get(model_name, "hierarchical"),
            seed=int(seed),
            sampler=str(sampler),
            init_image=init,
            strength=float(strength),
            waveform2=pipe.load_audio(audio2_path) if audio2_path else None,
            audio_mix=float(audio_mix),
            mask_image=mask,
            guidance_rescale=float(cfg_rescale),
        )[0]
        info = (f"model={model_name} steps={int(steps)} cfg={cfg_scale} "
                f"norm={norm_value} seed={int(seed)} sampler={sampler}"
                + (f" strength={strength}" if init is not None else "")
                + (f" audio_mix={audio_mix}" if audio2_path else ""))
        return np.asarray(img), info

    return generate


def launch(cfg: Optional[Config] = None, host: str = "0.0.0.0", port: int = 7860,
           device=None):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; use the CLI or the HTTP server:\n"
            "  python -m clap2diffusion_tpu_torch.apps.main infer --audio x.wav --text '...'\n"
            "  python -m clap2diffusion_tpu_torch.apps.server --port 7860") from e

    cfg = cfg or Config()
    generate = build_generator(cfg, device=device)

    with gr.Blocks(title="CLAP2Diffusion (PyTorch/CUDA)") as demo:
        gr.Markdown("# CLAP2Diffusion: audio + text -> image")
        with gr.Row():
            with gr.Column():
                audio = gr.Audio(type="filepath", label="Audio (.wav)")
                prompt = gr.Textbox(label="Text prompt")
                negative = gr.Textbox(label="Negative prompt")
                model = gr.Dropdown(list(_MODEL_TYPES), value="Hierarchical V4", label="Model")
                norm = gr.Slider(10, 200, value=60, label="Audio norm target")
                steps = gr.Slider(20, 100, value=50, step=1, label="Steps")
                sampler = gr.Dropdown(["ddim", "dpmpp_2m", "dpmpp_2m_karras", "euler_a"],
                                      value="ddim",
                                      label="Sampler (dpmpp_2m: ~20 steps; euler_a: stochastic)")
                cfg_s = gr.Slider(1.0, 20.0, value=7.5, label="CFG scale")
                cfg_r = gr.Slider(0.0, 1.0, value=0.0, label="CFG rescale (0 = plain CFG)")
                seed = gr.Number(value=42, precision=0, label="Seed")
                best_of = gr.Slider(1, 8, value=1, step=1,
                                    label="Best-of-N (CLIPScore rerank; needs CLIP vision weights)")
                with gr.Accordion("img2img / composition", open=False):
                    init_img = gr.Image(label="Init image (SDEdit)")
                    strength = gr.Slider(0.05, 1.0, value=0.8, label="img2img strength")
                    mask_img = gr.Image(label="Inpaint mask (white = regenerate)")
                    audio2 = gr.Audio(type="filepath", label="Second audio (blend)")
                    mix = gr.Slider(0.0, 1.0, value=0.5, label="Blend weight of first audio")
                btn = gr.Button("Generate")
            with gr.Column():
                image = gr.Image(label="Generated image")
                info = gr.Textbox(label="Generation info")
        btn.click(generate,
                  [audio, prompt, model, norm, steps, cfg_s, seed, sampler, negative,
                   init_img, strength, audio2, mix, mask_img, cfg_r, best_of],
                  [image, info])

    auth = None
    user, pw = os.environ.get("GRADIO_USERNAME"), os.environ.get("GRADIO_PASSWORD")
    if user and pw:
        auth = (user, pw)
    demo.launch(server_name=host, server_port=port, auth=auth)
