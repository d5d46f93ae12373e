"""Configuration dataclasses of the ported slice.

Field names and defaults are those of ``clap2diffusion_tpu/core/config.py``
for the sections the port runs: the CLAP audio tower, the conditioning
stack, the UNet, the VAE, the CLIP text encoder and the scheduler. Sections
the port does not model yet (``data``, ``train``, ``clap.text``,
``diffusion.clip_vision``) are skipped when a YAML file or a dict names
them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# Sections of the reference config tree that the port does not model yet.
_NOT_PORTED = {"data", "train", "text", "clip_vision"}


@dataclass(frozen=True)
class AudioFrontendConfig:
    sample_rate: int = 48_000
    duration_s: float = 10.0
    n_fft: int = 1024
    hop_length: int = 480
    num_mel_bins: int = 64
    f_min: float = 0.0
    f_max: float = 14_000.0
    max_frames: int = 1024

    @property
    def num_samples(self) -> int:
        return int(self.sample_rate * self.duration_s)


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    patch_embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    num_mel_bins: int = 64
    hidden_size: int = 768
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    qkv_bias: bool = True


@dataclass(frozen=True)
class CLAPConfig:
    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    audio: HTSATConfig = field(default_factory=HTSATConfig)
    embed_dim: int = 512


@dataclass(frozen=True)
class ConditionConfig:
    clap_dim: int = 512
    token_dim: int = 768
    num_tokens: int = 10
    num_levels: int = 3
    num_output_tokens: int = 77
    num_adapter_tokens: int = 16
    level_prior: Tuple[float, float, float] = (0.5, 0.3, 0.2)
    similarity_scale: float = 10.0
    hierarchy_bottleneck: int = 192
    hierarchy_heads: int = 4
    projector_bottleneck: int = 256
    projector_heads: int = 8
    projector_layers: int = 4
    adapter_kv_hidden: int = 256
    adapter_self_attn_layers: int = 4
    adapter_heads: int = 8
    cross_attn_gate_init: float = -5.0
    processor_alpha_init: float = 0.0
    router_gate_init: float = 0.0
    audio_norm_target: float = 60.0
    temperature_initial: float = 2.0
    temperature_final: float = 0.5
    temperature_floor: float = 0.1
    temperature_warmup_steps: int = 200
    temperature_anneal_steps: int = 5_000
    temperature_schedule: str = "cosine"


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    down_block_levels: Tuple[str, ...] = ("early", "early", "late", "late")
    up_block_levels: Tuple[str, ...] = ("late", "late", "mid", "mid")
    mid_block_level: str = "mid"
    audio_inject: bool = True
    injection_mode: str = "add"
    injection_bottleneck: int = 64
    injection_max_concat_tokens: int = 4
    flash_attention: bool = True
    remat: bool = False


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49_408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    sampler: str = "ddim"


@dataclass(frozen=True)
class DiffusionConfig:
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip_text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    image_size: int = 512


@dataclass(frozen=True)
class Config:
    clap: CLAPConfig = field(default_factory=CLAPConfig)
    condition: ConditionConfig = field(default_factory=ConditionConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)


def from_dict(cls, d: Dict[str, Any]):
    """Build a frozen dataclass tree from nested dicts. Lists become tuples
    where the field is a tuple; sections the port does not model yet are
    skipped; any other unknown key raises."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in d.items():
        if key not in fields:
            if key in _NOT_PORTED:
                continue
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        f = fields[key]
        sub = _DATACLASSES.get(f.type if isinstance(f.type, str) else f.type.__name__)
        if isinstance(value, dict) and sub is not None:
            kwargs[key] = from_dict(sub, value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value) if "Tuple" in str(f.type) else value
        else:
            kwargs[key] = value
    return cls(**kwargs)


_DATACLASSES = {
    c.__name__: c
    for c in (
        AudioFrontendConfig, HTSATConfig, CLAPConfig, ConditionConfig,
        UNetConfig, VAEConfig, CLIPTextConfig, SchedulerConfig,
        DiffusionConfig, Config,
    )
}


def _deep_merge(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in upd.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: Optional[str] = None) -> Config:
    """Load ``Config`` from YAML (e.g. ``configs/default.yaml``); missing
    keys keep their defaults."""
    cfg = Config()
    if path is None:
        return cfg
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return from_dict(Config, _deep_merge(dataclasses.asdict(cfg), raw))
