"""End-to-end audio+text -> image pipeline (port of
``clap2diffusion_tpu/diffusion/pipeline.py``, the serving main path).

waveform (float, or PCM16 int16 dequantised on the device) -> log-mel ->
HTSAT CLAP tower -> hierarchical conditioning with Norm-60 -> one batched
CLIP-text call for the cond and uncond prompts -> DDIM with CFG folded into
one 2B-batch UNet forward per step -> VAE decode -> uint8.

Numerics follow the JAX program with bf16 parameters: the CLAP tower and
the conditioning stack compute in fp32 (the JAX package promotes their bf16
weights against the fp32 log-mel), the CLIP text encoder, the UNet and the
VAE compute in the parameter type.

Initial latents: the JAX program draws them with threefry from ``seed``,
which torch cannot reproduce. ``generate(seed=s)`` draws them here with
``torch.randn(..., generator=torch.Generator(device).manual_seed(s))`` on
the pipeline's device, in fp32, then casts to the compute type.
``_generate_from_latents`` is everything after that draw, so a caller (or
a test) can feed any latents.

Model types: ``hierarchical``, ``audio_tokens`` and ``baseline``; sampler
``ddim``. The ``sonic`` type, other samplers, img2img, inpainting,
two-audio mixing and per-lane seeds are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.core.device import resolve_device
from clap2diffusion_tpu_torch.diffusion.ddim import SAMPLERS, NoiseSchedule, cfg_eps_fn
from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram
from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
from clap2diffusion_tpu_torch.models.condition.hierarchical import (
    ROUTING_INIT,
    HierarchicalAudioEncoder,
)
from clap2diffusion_tpu_torch.models.unet import UNet2DCondition
from clap2diffusion_tpu_torch.models.vae import AutoencoderKL
from clap2diffusion_tpu_torch.ops.token_norm import rescale_to_norm

MODEL_TYPES = ("hierarchical", "audio_tokens", "baseline")
# towers that compute in fp32 whatever the parameter type (see module doc)
FP32_TOWERS = ("clap_audio", "hierarchical")


def build_modules(cfg: Config) -> Dict[str, nn.Module]:
    return {
        "clap_audio": ClapAudioTower(cfg.clap.audio),
        "clip_text": CLIPTextEncoder(cfg.diffusion.clip_text),
        "hierarchical": HierarchicalAudioEncoder(cfg.condition),
        "unet": UNet2DCondition(cfg.diffusion.unet),
        "vae": AutoencoderKL(cfg.diffusion.vae),
    }


def _special_init(cfg: Config) -> Dict[str, tuple]:
    """Parameters whose initial value is not the generic rule of
    ``random_init_``; these follow the JAX modules' initialisers."""
    gate = ("fill", cfg.condition.router_gate_init)
    return {
        "token_offsets": ("normal", 0.02), "level_anchors": ("normal", 0.02),
        "queries": ("normal", 0.02), "clip_pos_embed": ("normal", 0.02),
        "query_pos": ("fill", 0.0), "relative_position_bias_table": ("fill", 0.0),
        "alpha": ("fill", 0.0), "running_mean": ("fill", 0.0), "running_var": ("fill", 1.0),
        "routing_matrix": ("routing", None), "early": gate, "mid": gate, "late": gate,
    }


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 special: Dict[str, tuple]) -> nn.Module:
    """Fill every parameter and buffer from ``generator``: matrices and
    kernels ~ N(0, 1/fan_in) (lecun normal, the Flax default), embeddings
    ~ N(0, 1/dim), biases 0, norm scales 1, and the parameters named in
    ``special`` (by last name component). Values are drawn in fp32 and cast
    to the tensor's type, so one seed gives the same weights in every type."""
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        kind, arg = special.get(leaf, (None, None))
        if kind is None:
            if leaf.endswith("bias") or t.dim() == 1:
                kind, arg = "fill", 0.0 if leaf.endswith("bias") else 1.0
            else:
                kind, arg = "normal", 1.0 / math.sqrt(t[0].numel())
        if kind == "fill":
            t.fill_(arg)
        elif kind == "routing":
            t.copy_(torch.tensor(ROUTING_INIT))
        else:
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                                dtype=torch.float32) * arg)
    return module


def _dequantize_pcm16(waveform: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float, divided by its own peak (float input passes
    through), as the JAX program does on the device."""
    if waveform.dtype != torch.int16:
        return waveform
    wf = waveform.float()
    return wf / torch.clamp(wf.abs().amax(dim=-1, keepdim=True), min=1.0)


class AudioToImagePipeline:
    """Host-facing pipeline: ``generate(...)`` -> uint8 images [B, H, W, 3].

    ``params`` is the dict ``convert.from_flax`` returns (per-tower state
    dicts); its UNet's type is the compute type. ``params=None`` initialises
    the whole stack at random from ``seed`` with a ``torch.Generator`` on
    the device, in ``dtype``. ``device=None`` means CUDA and raises when
    CUDA is missing; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: Config, params: Optional[Dict] = None, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is not None:
            dtype = params["unet"][next(iter(params["unet"]))].dtype
        self.compute_dtype = dtype
        with torch.device("meta"):
            mods = build_modules(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, m in mods.items():
            m.to_empty(device=self.device)
            if params is None:
                random_init_(m.to(dtype), gen, _special_init(cfg))
            else:
                m.load_state_dict(params[name], strict=True)
            tower_type = torch.float32 if name in FP32_TOWERS else dtype
            m.to(tower_type).eval().requires_grad_(False)
        mods["unet"].to(memory_format=torch.channels_last)
        mods["vae"].to(memory_format=torch.channels_last)
        self.clap_audio = mods["clap_audio"]
        self.clip_text = mods["clip_text"]
        self.hierarchical = mods["hierarchical"]
        self.unet = mods["unet"]
        self.vae = mods["vae"]
        self.schedule = NoiseSchedule.create(cfg.diffusion.scheduler, device=self.device)

    # -- stages ---------------------------------------------------------------

    @torch.inference_mode()
    def encode_audio(self, waveform) -> torch.Tensor:
        """waveform [B, samples] (float32, or int16 PCM16) -> normalised CLAP
        embedding [B, 512] (fp32)."""
        wf = _dequantize_pcm16(torch.as_tensor(np.asarray(waveform), device=self.device))
        return self.clap_audio(log_mel_spectrogram(wf, self.cfg.clap.frontend))

    @torch.inference_mode()
    def encode_text(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=self.device)
        return self.clip_text(ids)

    def _condition(self, clap_emb: torch.Tensor, model_type: str, norm_target: float,
                   temperature: float):
        """CLAP [B,512] -> (tokens77, routed audio dict) per model type."""
        if model_type == "baseline":
            return None, None
        tokens77, info = self.hierarchical(clap_emb, temperature, return_all=True)
        routed = {lvl: rescale_to_norm(t, norm_target) for lvl, t in info["routed"].items()}
        return rescale_to_norm(tokens77, norm_target), routed

    # -- generation -----------------------------------------------------------

    def _prepare(self, waveform, text_ids, uncond_ids, batch: int, model_type: str,
                 sampler: str, guidance_rescale: float):
        if model_type not in MODEL_TYPES:
            raise ValueError(f"model_type {model_type!r} is not ported; available: "
                             f"{MODEL_TYPES}")
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; available: {sorted(SAMPLERS)}")
        if not 0.0 <= float(guidance_rescale) <= 1.0:
            raise ValueError(f"guidance_rescale must be in [0, 1], got {guidance_rescale}")
        max_len = self.cfg.diffusion.clip_text.max_length
        if text_ids is None:
            text_ids = np.zeros((batch, max_len), np.int32)
        if uncond_ids is None:
            uncond_ids = np.zeros((batch, max_len), np.int32)
        wav = None
        if waveform is not None:
            wav = np.asarray(waveform)
            if wav.dtype != np.int16:
                wav = wav.astype(np.float32)
            wav = wav[None] if wav.ndim == 1 else wav
        return wav, np.asarray(text_ids, np.int32), np.asarray(uncond_ids, np.int32)

    @torch.inference_mode()
    def _generate_from_latents(self, latents: torch.Tensor, waveform, text_ids, uncond_ids,
                               *, num_steps: int, guidance_scale: float, norm_target: float,
                               temperature: float, model_type: str, batch: int,
                               sampler: str = "ddim",
                               guidance_rescale: float = 0.0) -> torch.Tensor:
        """Everything after the initial-latent draw; returns uint8 images
        [B, H, W, 3] on the device."""
        dev = self.device
        clap_emb = None
        if waveform is not None:
            wf = _dequantize_pcm16(torch.as_tensor(waveform, device=dev))
            clap_emb = self.clap_audio(log_mel_spectrogram(wf, self.cfg.clap.frontend))
            if batch > 1 and clap_emb.shape[0] == 1:
                clap_emb = clap_emb.expand(batch, -1)
        ids = torch.as_tensor(np.concatenate([text_ids, uncond_ids], axis=0), device=dev)
        ehs_cond, ehs_uncond = self.clip_text(ids).chunk(2, dim=0)
        tokens77, routed = ((None, None) if clap_emb is None else
                            self._condition(clap_emb, model_type, norm_target, temperature))
        if model_type == "audio_tokens" and tokens77 is not None:
            ehs_cond = tokens77.to(ehs_cond.dtype)

        eps_fn = cfg_eps_fn(self.unet, ehs_cond, ehs_uncond, guidance_scale,
                            audio_cond=routed, audio_uncond=routed,
                            guidance_rescale=guidance_rescale)
        latents = SAMPLERS[sampler](eps_fn, self.schedule, latents.to(dev, self.compute_dtype),
                                    num_steps)
        img = self.vae.decode_latent(latents)
        return torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8)

    def draw_latents(self, seed: int, batch: int) -> torch.Tensor:
        """The port's seed -> initial noise mapping (see the module doc)."""
        lat = self.cfg.diffusion.image_size // 8
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        noise = torch.randn((batch, lat, lat, 4), generator=gen, device=self.device,
                            dtype=torch.float32)
        return noise.to(self.compute_dtype)

    def generate(self, waveform: Optional[np.ndarray] = None,
                 text_ids: Optional[np.ndarray] = None,
                 uncond_ids: Optional[np.ndarray] = None, *,
                 num_steps: Optional[int] = None, guidance_scale: Optional[float] = None,
                 norm_target: Optional[float] = None, temperature: float = 0.5,
                 model_type: str = "hierarchical", seed: int = 0, batch: int = 1,
                 sampler: Optional[str] = None,
                 guidance_rescale: float = 0.0) -> np.ndarray:
        """Generate images [B, H, W, 3] uint8 (blocking). Defaults: 50
        steps, CFG 7.5, Norm-60, as in the JAX package."""
        sch = self.cfg.diffusion.scheduler
        sampler = sampler or sch.sampler
        wav, tids, uids = self._prepare(waveform, text_ids, uncond_ids, batch, model_type,
                                        sampler, guidance_rescale)
        img = self._generate_from_latents(
            self.draw_latents(seed, batch), wav, tids, uids,
            num_steps=num_steps or sch.num_inference_steps,
            guidance_scale=sch.guidance_scale if guidance_scale is None else guidance_scale,
            norm_target=(self.cfg.condition.audio_norm_target if norm_target is None
                         else norm_target),
            temperature=temperature, model_type=model_type, batch=batch, sampler=sampler,
            guidance_rescale=guidance_rescale,
        )
        return img.cpu().numpy()
