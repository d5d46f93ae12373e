"""Configuration dataclasses of the port.

Field names and defaults are those of ``clap2diffusion_tpu/core/config.py``:
the CLAP audio and text towers, the conditioning stack, the UNet, the VAE,
the CLIP text and vision encoders, the scheduler, the data pipeline and the
training stages. ``apply_overrides`` takes ``a.b.c=value`` strings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


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
class CLAPTextConfig:
    """RoBERTa-style CLAP text tower (laion/clap-htsat-unfused geometry)."""

    vocab_size: int = 50_265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-12
    projection_dim: int = 512
    pad_token_id: int = 1


@dataclass(frozen=True)
class CLAPConfig:
    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    audio: HTSATConfig = field(default_factory=HTSATConfig)
    text: CLAPTextConfig = field(default_factory=CLAPTextConfig)
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
class CLIPVisionConfig:
    """OpenAI CLIP ViT-L/14 vision encoder (CLIPScore's image side)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
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
    # CLIPScore / frechet_clip_vision feature extractor (evaluation only)
    clip_vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    image_size: int = 512


@dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/audiocaps"
    latents_dir: str = "latents"
    audio_dir: str = "audio"
    metadata_file: str = "metadata_unified.json"
    batch_size: int = 8
    num_workers: int = 4
    prefetch: int = 2
    sample_rate: int = 48_000
    duration_s: float = 10.0
    latent_shape: Tuple[int, int, int] = (4, 64, 64)
    pairing: str = "matching"  # 'matching' | 'shifted' | 'random' | 'balanced'
    seed: int = 42


@dataclass(frozen=True)
class StageConfig:
    steps: int = 1000  # micro-steps (one batch each)
    lr: float = 1e-4
    batch_size: int = 8
    grad_accum: int = 1
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    lr_schedule: str = "warmup_cosine"
    min_lr: float = 0.0
    ema_decay: float = 0.9999
    use_ema: bool = False
    log_every: int = 50
    save_every: int = 500
    eval_every: int = 500
    eval_batches: int = 2
    # the JAX package runs this many steps in one compiled call; the port
    # runs eagerly and reads it only where it changes what is logged or saved
    steps_per_call: int = 1
    lora_rank: int = 0  # > 0: stage 2 trains LoRA adapters (train/lora.py)
    lora_alpha: float = 16.0
    loss_weights: Dict[str, float] = field(default_factory=dict)


def _default_stage1() -> StageConfig:
    return StageConfig(
        steps=3000, lr=1e-4, batch_size=8, grad_accum=2, grad_clip=1.0,
        use_ema=True, steps_per_call=50,
        loss_weights={"mse": 1.0, "infonce": 1.0},
    )


def _default_stage2() -> StageConfig:
    return StageConfig(
        steps=2000, lr=5e-5, batch_size=4, grad_accum=4, grad_clip=1.0,
        use_ema=True, steps_per_call=25,
        loss_weights={"diffusion": 1.0, "orthogonality": 0.1, "entropy": 0.01},
    )


def _default_stage3() -> StageConfig:
    return StageConfig(
        steps=1000, lr=1e-5, batch_size=2, grad_accum=8, grad_clip=0.5,
        lr_schedule="cosine", min_lr=1e-6,
        use_ema=True, steps_per_call=25,
        loss_weights={"diffusion": 2.0, "consistency": 0.5, "alignment": 0.3},
    )


@dataclass(frozen=True)
class TrainConfig:
    stage1: StageConfig = field(default_factory=_default_stage1)
    stage2: StageConfig = field(default_factory=_default_stage2)
    stage3: StageConfig = field(default_factory=_default_stage3)
    infonce_temperature: float = 0.07
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": -1})
    model_parallel: int = 1
    seed: int = 42
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class Config:
    clap: CLAPConfig = field(default_factory=CLAPConfig)
    condition: ConditionConfig = field(default_factory=ConditionConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def from_dict(cls, d: Dict[str, Any]):
    """Build a frozen dataclass tree from nested dicts. Lists become tuples
    where the field is a tuple; an unknown key raises."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in d.items():
        if key not in fields:
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
        AudioFrontendConfig, HTSATConfig, CLAPTextConfig, CLAPConfig, ConditionConfig,
        UNetConfig, VAEConfig, CLIPTextConfig, CLIPVisionConfig, SchedulerConfig,
        DiffusionConfig, DataConfig, StageConfig, TrainConfig, Config,
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


def _parse_scalar(s: str) -> Any:
    import yaml

    v = yaml.safe_load(s)
    if isinstance(v, str):  # YAML 1.1 reads "3e-4" as a string; Python does not
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``a.b.c=value`` overrides onto a frozen Config tree."""
    d = dataclasses.asdict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        path, _, raw = ov.partition("=")
        keys = path.strip().split(".")
        node = d
        for k in keys[:-1]:
            node = node[k]
        if keys[-1] not in node:
            raise KeyError(f"unknown config path {path!r}")
        node[keys[-1]] = _parse_scalar(raw)
    return from_dict(Config, d)


def load_config(path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> Config:
    """Load ``Config`` from YAML (e.g. ``configs/default.yaml``); missing
    keys keep their defaults; then the overrides."""
    cfg = Config()
    if path is not None:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        cfg = from_dict(Config, _deep_merge(dataclasses.asdict(cfg), raw))
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
