"""End-to-end audio+text -> image pipeline (port of
``clap2diffusion_tpu/diffusion/pipeline.py``: ``generate`` and its
streaming forms).

waveform (float, or PCM16 int16 dequantised on the device) -> log-mel ->
HTSAT CLAP tower -> conditioning with Norm-60 -> one batched CLIP-text call
for the cond and uncond prompts -> a sampler with CFG folded into one
2B-batch UNet forward per step -> VAE decode -> uint8.

Model types: ``hierarchical`` (routed early/mid/late injection and the CLIP
text context), ``audio_tokens`` (the 77 hierarchical tokens in place of the
text context), ``sonic`` (the audio adapter's tokens, Norm-60, at every
level) and ``baseline`` (text only). Samplers: ``ddim``, ``dpmpp_2m``,
``dpmpp_2m_karras`` and ``euler_a`` (``diffusion/ddim.py``). Beyond them,
as in the JAX package: SDEdit img2img (``init_image``, ``strength``),
inpainting (``mask_image``), two-audio mixing (``waveform2``,
``audio_mix``), per-lane seeds (``seeds``) and ``generate_stream``.

Numerics follow the JAX program with bf16 parameters: the CLAP tower and
the conditioning stack (hierarchical, adapter) compute in fp32 from the
bf16-rounded weights (the JAX package promotes their bf16 weights against
the fp32 CLAP input), apart from the few ops JAX runs on those parameters
alone, in their own type (the router's softmax and gates, the adapter's
query sum: ``param_dtype``); the CLIP text encoder, the UNet and the VAE
compute in the parameter type.

Random draws: the JAX program draws with threefry from ``key(seed)``,
which torch cannot reproduce. Every draw of a request here goes through
one ``RequestDraws`` that ``AudioToImagePipeline.draws`` makes (a test
replaces that method to feed the JAX draws): the initial latents from
``torch.Generator(device).manual_seed(seed)``, as before, and the VAE's
sample noise, the img2img noise and the stochastic sampler's noise each
from a generator of its own (see ``stream_seed``); with ``seeds``, each
lane's latents and sampler noise from that lane's seed alone.

Execution, as the JAX package's "one jit-compiled function per (batch,
steps, mode)": a request is host preparation (``_prepare``: every copy
from the host and every random draw, the stochastic sampler's per-step
noise drawn ahead, the dynamic scalars as 0-dim fp32 device tensors), then
the device program (``_program``), which reads only those tensors. On CUDA
the program is one replay of a CUDA graph, captured at the first request of
its static signature (``diffusion/program.py``: ``Signature``,
``Programs``); the CPU, and a pipeline under a model-parallel group, run it
eagerly (ROADMAP known delta 23).

Fetching: ``_dispatch_generate`` returns a ``HostCopy``, whose ``numpy()``
gives the images. On CUDA the copy to pinned host memory is enqueued right
after the request's last kernel, with an event behind it, so a fetch waits
for its own request and not for whatever was enqueued after it. The handle
also carries the request's stage times: its host preparation and replay,
its fetch, and its device program's stages, stamped on the device
(``ops/stage_clock.py``) and copied beside the images, each kept as a span
while recording (``utils/profiling.py``).

Weights I/O: ``init_params`` draws a random pipeline, ``save_pipeline``
writes the port's checkpoint format (one ``<tower>.safetensors`` per tower
in the type it is held in, and a ``pipeline.json``), ``load_pipeline``
checks it against the config and builds the pipeline, and
``cached_init_params`` keeps random pipelines on disk under
``C2D_PARAM_CACHE``. Towers beyond the core six (the evaluation and best-of
towers ``clip_vision``, ``clip_text_projection``, ``clap_text``,
``inception_v3``) ride along in ``pipe.extra_params`` and through the
round trip.

Best-of-n (``generate_best_of``): n candidates in one batched request with
per-lane seeds, scored by CLIPScore against the prompt on the device
(``clip_vision``, the CLIP text encoder and ``clip_text_projection``), the
argmax selected there; only the winner and the n scores are fetched.

Several processes (``generate_sharded``, ``shard_pipeline_for_serving``):
a batch spread over a mesh's data ranks and gathered, and the wide Dense
layers split over its model ranks (``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.core.device import resolve_device
from clap2diffusion_tpu_torch.diffusion.ddim import (
    SAMPLERS,
    STOCHASTIC,
    NoiseSchedule,
    cfg_eps_fn,
    generator_draw,
    img2img_timesteps,
    predraw,
    sampler_timesteps,
    stacked_draw,
)
from clap2diffusion_tpu_torch.diffusion.program import Inputs, Programs, Signature
from clap2diffusion_tpu_torch.models.clap.frontend import (
    fit_to_length,
    log_mel_spectrogram,
    prepare_waveform,
)
from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
from clap2diffusion_tpu_torch.models.clip_vision import (
    CLIPVisionEncoder,
    build_tower,
    clip_text_features,
    preprocess_images_device,
)
from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
from clap2diffusion_tpu_torch.models.condition.hierarchical import (
    ROUTING_INIT,
    HierarchicalAudioEncoder,
)
from clap2diffusion_tpu_torch.models.layers import DataSlice, draw
from clap2diffusion_tpu_torch.models.unet import UNet2DCondition
from clap2diffusion_tpu_torch.models.vae import AutoencoderKL
from clap2diffusion_tpu_torch.ops import stage_clock
from clap2diffusion_tpu_torch.ops.token_norm import rescale_to_norm
from clap2diffusion_tpu_torch.utils import profiling
from clap2diffusion_tpu_torch.utils.audio_io import peak_normalize, read_audio, read_wav_pcm16
from clap2diffusion_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors

MODEL_TYPES = ("hierarchical", "audio_tokens", "sonic", "baseline")
# towers that compute in fp32 whatever the parameter type (see module doc)
FP32_TOWERS = ("clap_audio", "hierarchical", "adapter")
# the towers every pipeline checkpoint holds (load_pipeline)
CORE_TOWERS = ("clap_audio", "clip_text", "hierarchical", "adapter", "unet", "vae")
# what best-of-n ranks with, beyond the core towers
BEST_OF_TOWERS = ("clip_vision", "clip_text_projection")
PIPELINE_FORMAT = "clap2diffusion_tpu_torch.pipeline.v1"
LEVELS = ("early", "mid", "late")
# the tags of a request's streams (stream_seed); the sampler's is the JAX
# program's fold_in tag
SAMPLER_TAG, VAE_TAG, IMG2IMG_TAG = 0x5A, 1, 2


def build_modules(cfg: Config) -> Dict[str, nn.Module]:
    return {
        "clap_audio": ClapAudioTower(cfg.clap.audio),
        "clip_text": CLIPTextEncoder(cfg.diffusion.clip_text),
        "hierarchical": HierarchicalAudioEncoder(cfg.condition),
        "unet": UNet2DCondition(cfg.diffusion.unet),
        "vae": AutoencoderKL(cfg.diffusion.vae),
        # last: random_init_ draws the towers from one generator in this
        # order, so a seed gives the other towers what it gave before
        "adapter": AudioAdapter(cfg.condition),
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


def init_params(cfg: Config, seed: int = 0, dtype: torch.dtype = torch.float32,
                device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights for every tower (the adapter included), tower ->
    state dict in ``dtype`` on ``device`` (CUDA unless the caller asks for
    the CPU), drawn from one ``torch.Generator`` seeded with ``seed`` by
    ``random_init_``'s rule. A seed draws other values on the CPU than on
    CUDA (other generators)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        mods = build_modules(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, m in mods.items():
        m.to_empty(device=dev)
        random_init_(m.to(dtype), gen, _special_init(cfg))
        out[name] = {k: v.detach() for k, v in m.state_dict().items()}
    return out


def save_pipeline(path: str, params: Dict[str, Dict[str, torch.Tensor]]) -> str:
    """Write a pipeline's weights (tower -> state dict: the six core towers
    and any other) as the port's checkpoint: ``<tower>.safetensors`` per
    tower, each tensor in the type it is held in, and ``pipeline.json``
    (the format tag, the towers and their types), written last. Returns
    the directory."""
    p = os.path.abspath(path)
    os.makedirs(p, exist_ok=True)
    towers = {}
    for tower, sd in params.items():
        tmp = os.path.join(p, f".{tower}.safetensors.tmp")
        save_safetensors(tmp, sd)
        os.replace(tmp, os.path.join(p, f"{tower}.safetensors"))
        towers[tower] = sorted({str(t.dtype).removeprefix("torch.") for t in sd.values()})
    with open(os.path.join(p, "pipeline.json"), "w") as f:
        json.dump({"format": PIPELINE_FORMAT, "towers": towers}, f, indent=1)
    return p


def restore_params_host(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A ``save_pipeline`` checkpoint as CPU tensors: every tower it lists,
    in the types they were saved in."""
    p = os.path.abspath(path)
    try:
        with open(os.path.join(p, "pipeline.json")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise ValueError(f"{path} is not a pipeline checkpoint of the port (no pipeline.json); "
                         "write one with clap2diffusion_tpu_torch.tools.convert_checkpoints "
                         "or save_pipeline") from None
    if meta.get("format") != PIPELINE_FORMAT:
        raise ValueError(f"{path}: unknown pipeline checkpoint format {meta.get('format')!r}")
    return {t: load_safetensors(os.path.join(p, f"{t}.safetensors")) for t in meta["towers"]}


def params_cache_path(cfg: Config, seed: int = 0, dtype: torch.dtype = torch.float32,
                      cache_dir: Optional[str] = None, device=None) -> Optional[str]:
    """Where ``cached_init_params`` keeps a (geometry, seed, dtype, device
    type) param set; None when no cache directory is configured (the
    ``cache_dir`` argument or ``C2D_PARAM_CACHE``). The device type is part
    of the key because the CPU's and CUDA's generators draw other values."""
    cache_dir = cache_dir or os.environ.get("C2D_PARAM_CACHE")
    if not cache_dir:
        return None
    dev = torch.device("cuda" if device is None else device)
    key = hashlib.sha256(json.dumps(
        [dataclasses.asdict(cfg), seed, str(dtype), dev.type], sort_keys=True, default=str
    ).encode()).hexdigest()[:16]
    return os.path.join(os.path.abspath(cache_dir), f"params_{key}")


def cached_init_params(cfg: Config, seed: int = 0, dtype: torch.dtype = torch.float32,
                       cache_dir: Optional[str] = None, device=None):
    """``init_params`` with an on-disk cache (``save_pipeline`` format) at
    ``params_cache_path``; without a cache directory, a fresh draw."""
    path = params_cache_path(cfg, seed, dtype, cache_dir, device)
    if path is None:
        return init_params(cfg, seed, dtype, device)
    if os.path.exists(os.path.join(path, "pipeline.json")):
        dev = resolve_device(device)
        return {t: {k: v.to(dev) for k, v in sd.items()}
                for t, sd in restore_params_host(path).items()}
    params = init_params(cfg, seed, dtype, device)
    save_pipeline(path, params)
    return params


def load_pipeline(cfg: Config, path: str, dtype: Optional[torch.dtype] = None,
                  device=None) -> "AudioToImagePipeline":
    """A pipeline from a ``save_pipeline`` checkpoint, on ``device`` (CUDA
    unless the caller asks for the CPU). The six core towers must be there
    and match ``cfg``'s geometry, name for name and shape for shape, or
    this raises before any weight reaches the device. ``dtype`` casts every
    tower, as the JAX ``load_pipeline`` does; the towers that compute in
    fp32 (``FP32_TOWERS``) then hold the cast values in fp32, the values
    the JAX program promotes, and the towers beyond the core six ride along
    on the CPU in ``pipe.extra_params``.

    ``C2D_INT8_WIRE=1``: after the cast, the large weights cross to the
    device as int8 with per-channel scales and are expanded there
    (``utils/wire.py``); ``pipe.wire_stats`` holds the raw and wire bytes
    and the leaf counts."""
    params = restore_params_host(path)
    missing = set(CORE_TOWERS) - set(params)
    if missing:
        raise ValueError(f"pipeline checkpoint at {path} is missing towers: {sorted(missing)}")
    with torch.device("meta"):
        mods = build_modules(cfg)
    for tower in sorted(CORE_TOWERS):
        expect = {k: tuple(v.shape) for k, v in mods[tower].state_dict().items()}
        got = {k: tuple(v.shape) for k, v in params[tower].items()}
        if expect != got:
            raise ValueError(f"pipeline checkpoint tower {tower!r} does not match the active "
                             "config's geometry (structure or shapes differ) — wrong --config "
                             "for this checkpoint?")
    if dtype is not None:
        params = {tower: {k: v.to(dtype) for k, v in sd.items()}
                  for tower, sd in params.items()}
    stats = None
    if os.environ.get("C2D_INT8_WIRE") == "1":
        from clap2diffusion_tpu_torch.utils import wire

        dev = resolve_device(device)
        payload, stats = wire.quantize_wire(params, wire.tower_layouts(cfg, params))
        params = wire.dequantize_wire(payload, {
            t: dev if t in mods else torch.device("cpu") for t in params})
    if dtype is not None:
        for tower in FP32_TOWERS:
            if tower in params:
                params[tower] = {k: v.to(torch.float32) for k, v in params[tower].items()}
    pipe = AudioToImagePipeline(cfg, params=params, device=device)
    pipe.wire_stats = stats
    return pipe


class HostCopy:
    """A request's images on their way to the host, with its stage times.

    On CUDA: the copy into pinned host memory, enqueued on the current
    stream right after the images' last kernel, the program's stage stamps
    (``ops/stage_clock.py``) copied beside them, and the CUDA event
    recorded behind both. ``numpy()`` waits on that event alone, so it
    never waits for work enqueued after the request. On the CPU the images
    are already there. ``dispatch_id`` names the request's spans
    (``utils/profiling.py``: ``pipeline.prepare`` and ``program.replay``,
    kept at dispatch; ``pipeline.fetch`` and the ``device.*`` stages, kept
    by the first ``numpy()``); ``stages`` holds their seconds, the device
    stages' and the fetch's once fetched."""

    def __init__(self, img: torch.Tensor, stamps: Optional[torch.Tensor] = None,
                 dispatch_id: Optional[int] = None, stages: Optional[Dict[str, float]] = None):
        self.device_images = img  # the images on the card (best-of scores them there)
        self.dispatch_id = dispatch_id
        self.stages = dict(stages or {})
        self._fetched = False
        if not img.is_cuda:
            self.host, self.host_stamps, self.event = img, stamps, None
            return
        self.host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        self.host.copy_(img, non_blocking=True)
        self.host_stamps = None
        if stamps is not None:
            self.host_stamps = torch.empty(stamps.shape, dtype=stamps.dtype, pin_memory=True)
            self.host_stamps.copy_(stamps, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(img.device))

    def numpy(self) -> np.ndarray:
        if self._fetched:
            return self.host.numpy()
        t0 = profiling.now()
        if self.event is not None:
            self.event.synchronize()
        t1 = profiling.now()
        self._fetched = True
        did = self.dispatch_id
        profiling.record("pipeline.fetch", t0, t1, id=did, parent=did)
        self.stages["fetch"] = (t1 - t0) / 1e9
        if self.host_stamps is not None:
            stamps = self.host_stamps.numpy()
            for i, name in enumerate(stage_clock.STAGES):
                profiling.record(name, int(stamps[i]), int(stamps[i + 1]), id=did, parent=did,
                                 clock="device")
            self.stages.update(stage_clock.durations(stamps))
        return self.host.numpy()


def _dequantize_pcm16(waveform: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float, divided by its own peak (float input passes
    through), as the JAX program does on the device."""
    if waveform.dtype != torch.int16:
        return waveform
    wf = waveform.float()
    return wf / torch.clamp(wf.abs().amax(dim=-1, keepdim=True), min=1.0)


def stream_seed(seed: int, tag: int) -> int:
    """The seed of a request's ``tag`` stream: a 63-bit mix of (seed, tag),
    apart from ``seed`` itself (the initial latents' stream) and from the
    other tags' streams, as the JAX program keeps its streams apart with
    ``split`` and ``fold_in``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(tag) * 0xBF58476D1CE4E5B9) % (1 << 63)


class RequestDraws:
    """Every random draw of one request, fp32 standard normals on
    ``device``, each from its own ``torch.Generator``:

    - ``latents(shape)``: the initial latents, from ``seed`` (with
      ``seeds``: lane i's [h, w, 4] from ``seeds[i]``, so that an image's
      noise is the same whatever batch it runs in);
    - ``vae(shape)``: the VAE posterior sample of img2img's init latent;
    - ``img2img(shape)``: the noise that takes the init latent to the first
      timestep of img2img's tail (and that inpainting re-applies);
    - ``sampler()``: the stochastic sampler's draw callable ``(i, shape)``,
      per lane with ``seeds``.

    ``rows=(index, count)`` makes these the rows of data rank ``index`` of
    ``count``: each draw of [b, ...] draws the whole batch's [b * count,
    ...] and keeps rows [index * b, (index + 1) * b)
    (``models/layers.py::DataSlice``), so the ranks' images are those of
    one request over the whole batch (``generate_sharded``; not with
    ``seeds``, whose lanes draw their own noise).
    """

    def __init__(self, device, seed: int, seeds: Optional[Iterable[int]] = None,
                 rows: Optional[Tuple[int, int]] = None):
        if rows is not None and seeds is not None:
            raise ValueError("rows slices the batch's draws; per-lane seeds draw their own")
        self.device = torch.device(device)
        self.seed = int(seed)
        self.seeds = None if seeds is None else [int(s) for s in seeds]
        self.rows = rows

    def _gen(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return gen if self.rows is None else DataSlice(gen, *self.rows)

    def _randn(self, shape, seed: int) -> torch.Tensor:
        return draw(torch.randn, shape, self._gen(seed), device=self.device,
                    dtype=torch.float32)

    def latents(self, shape) -> torch.Tensor:
        if self.seeds is None:
            return self._randn(shape, self.seed)
        return torch.stack([self._randn(shape[1:], s) for s in self.seeds])

    def vae(self, shape) -> torch.Tensor:
        return self._randn(shape, stream_seed(self.seed, VAE_TAG))

    def img2img(self, shape) -> torch.Tensor:
        return self._randn(shape, stream_seed(self.seed, IMG2IMG_TAG))

    def sampler(self) -> Callable[[int, tuple], torch.Tensor]:
        if self.seeds is None:
            return generator_draw(self._gen(stream_seed(self.seed, SAMPLER_TAG)))
        return generator_draw([self._gen(stream_seed(s, SAMPLER_TAG)) for s in self.seeds])


def _prep_wav(w) -> Optional[np.ndarray]:
    """A waveform argument as [B, samples]; int16 rides through (the PCM16
    path), anything else becomes float32."""
    if w is None:
        return None
    w = np.asarray(w)
    if w.dtype != np.int16:
        w = w.astype(np.float32)
    return w[None] if w.ndim == 1 else w


def _latent_mask(mask_image, size: int) -> np.ndarray:
    """A mask image [H, W] or [B, H, W] (nonzero = regenerate) -> the
    latent-resolution soft mask [B, H/8, W/8, 1] fp32: absolute
    normalisation (uint8 / 255, bool as is, float clipped to [0, 1]), so a
    pixel's meaning does not depend on the rest of the mask, then the mean
    of each 8x8 block."""
    m = np.asarray(mask_image)
    if m.shape[-2:] != (size, size):
        raise ValueError(f"mask_image must be {size}x{size}, got {m.shape[-2:]}")
    if m.ndim == 2:
        m = m[None]
    if m.dtype == np.uint8:
        m = m.astype(np.float32) / 255.0
    elif m.dtype == np.bool_:
        m = m.astype(np.float32)
    else:
        m = np.clip(m.astype(np.float32), 0.0, 1.0)
    lat = size // 8
    m = m.reshape(m.shape[0], lat, 8, lat, 8).mean(axis=(2, 4))
    return m[..., None].astype(np.float32)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L conversion (ITU-R 601-2 luma), in its integer form."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _image_without_pil(arr: np.ndarray, size: int, mask: bool) -> Optional[np.ndarray]:
    """``load_init_image`` of a uint8 array already at ``size``: RGB as is
    (grey replicated, alpha dropped), a mask as L. None where PIL is needed."""
    if arr.shape[:2] != (size, size) or arr.ndim not in (2, 3):
        return None
    if arr.ndim == 3 and arr.shape[2] not in (3, 4):
        return None
    if mask:
        return arr if arr.ndim == 2 else _luma(arr)
    return np.repeat(arr[..., None], 3, axis=-1) if arr.ndim == 2 else arr[..., :3].copy()


class AudioToImagePipeline:
    """Host-facing pipeline: ``generate(...)`` -> uint8 images [B, H, W, 3].

    ``params`` is the dict ``convert.from_flax`` returns (per-tower state
    dicts); its UNet's type is the compute type. Without an ``"adapter"``
    entry the pipeline has no adapter, and ``model_type="sonic"`` raises.
    Towers other than the modules' (``BEST_OF_TOWERS`` and the evaluation
    towers) are kept as given in ``extra_params``.
    ``params=None`` initialises the whole stack at random from ``seed`` with
    a ``torch.Generator`` on the device, in ``dtype``. ``device=None`` means
    CUDA and raises when CUDA is missing; pass ``device="cpu"`` to run on
    the CPU."""

    def __init__(self, cfg: Config, params: Optional[Dict] = None, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, dtype, self.device)
        dtype = params["unet"][next(iter(params["unet"]))].dtype
        self.compute_dtype = dtype
        with torch.device("meta"):
            mods = build_modules(cfg)
        # towers beyond the modules' (the evaluation and best-of towers)
        self.extra_params: Dict[str, Dict[str, torch.Tensor]] = {
            k: v for k, v in params.items() if k not in mods}
        self._scorer = None  # best-of's CLIP towers on the device, built on first use
        self.wire_stats = None  # load_pipeline's int8 wire: bytes and leaf counts
        if "adapter" not in params:
            del mods["adapter"]
        for name, m in mods.items():
            m.to_empty(device=self.device)
            m.load_state_dict(params[name], strict=True)
            tower_type = torch.float32 if name in FP32_TOWERS else dtype
            m.to(tower_type).eval().requires_grad_(False)
            for sub in m.modules():  # the ops JAX runs in the parameter type
                if hasattr(sub, "param_dtype"):
                    sub.param_dtype = dtype
        mods["unet"].to(memory_format=torch.channels_last)
        mods["vae"].to(memory_format=torch.channels_last)
        self.clap_audio = mods["clap_audio"]
        self.clip_text = mods["clip_text"]
        self.hierarchical = mods["hierarchical"]
        self.adapter = mods.get("adapter")
        self.unet = mods["unet"]
        self.vae = mods["vae"]
        self.schedule = NoiseSchedule.create(cfg.diffusion.scheduler, device=self.device)
        # a request is one replay of a CUDA graph on the card (Programs), an
        # eager run of the same program on the CPU and under a model-parallel
        # group (shard_pipeline_for_serving)
        self._capture = self.device.type == "cuda"
        self.programs = Programs(self._weights)
        self._grids: Dict[Tuple[str, int, int], Tuple[int, ...]] = {}

    def _weights(self) -> Iterable[torch.Tensor]:
        """Every parameter and buffer of the pipeline's modules: what a
        captured program reads by address."""
        for name in CORE_TOWERS:
            m = getattr(self, name)
            if m is not None:
                yield from m.parameters()
                yield from m.buffers()

    def _grid(self, sampler: str, num_steps: int, init_steps: int) -> Tuple[int, ...]:
        """The sampler's step grid as Python ints, computed on the host at
        its first use and kept: static, as JAX's grid is."""
        key = (sampler, num_steps, init_steps)
        if key not in self._grids:
            self._grids[key] = sampler_timesteps(sampler, self.schedule, num_steps, init_steps)
        return self._grids[key]

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The pipeline's weights, tower -> state dict, as its modules hold
        them, and the extra towers as given (what ``save_pipeline`` writes
        and ``merge_stage_params`` overlays)."""
        core = {n: getattr(self, n).state_dict() for n in CORE_TOWERS
                if getattr(self, n) is not None}
        return {**core, **self.extra_params}

    # -- host-side frontends --------------------------------------------------

    def load_audio(self, path: str) -> np.ndarray:
        """An audio file -> the waveform ``generate`` takes. A mono PCM16 WAV
        at the CLAP rate stays int16 (dequantised on the device), when
        cropping keeps its peak; anything else (any WAV, FLAC and mp3
        through the native loader, other containers through ffmpeg:
        ``utils/audio_io.py::read_audio``) is peak-normalised as a whole,
        then mixed to mono, resampled and fitted to length."""
        fe = self.cfg.clap.frontend
        pcm = read_wav_pcm16(path)
        if pcm is not None and pcm[1] == fe.sample_rate:
            x, n = pcm[0], fe.num_samples
            if len(x) <= n or np.abs(x[:n]).max() == np.abs(x).max():
                return fit_to_length(x, n)
        wav, sr = read_audio(path)
        return prepare_waveform(peak_normalize(wav), sr, fe)

    def load_init_image(self, source, mask: bool = False) -> np.ndarray:
        """An init image (or inpainting mask) from a path, file-like, PIL
        image or array -> uint8 [S, S, 3] (a mask: [S, S], grey) at the
        configured size. Float arrays are clipped to [0, 1] and rounded.
        PIL (Pillow) is imported only for files, PIL images and resizes
        (LANCZOS, masks NEAREST); a uint8 array already at the size needs
        none."""
        size = self.cfg.diffusion.image_size
        is_file = isinstance(source, (str, bytes, os.PathLike)) or hasattr(source, "read")
        if not is_file and not hasattr(source, "convert"):
            arr = np.asarray(source)
            if np.issubdtype(arr.dtype, np.floating):
                arr = (np.clip(arr, 0.0, 1.0) * 255.0).round()
            arr = arr.astype(np.uint8)
            out = _image_without_pil(arr, size, mask)
            if out is not None:
                return out
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("load_init_image needs PIL (Pillow) to read a file or a PIL "
                              f"image, or to resize to {size}x{size}") from e
        if is_file:
            img = Image.open(source)
        elif isinstance(source, Image.Image):
            img = source
        else:
            img = Image.fromarray(arr)
        if mask:
            return np.asarray(img.convert("L").resize((size, size), Image.NEAREST), np.uint8)
        return np.asarray(img.convert("RGB").resize((size, size), Image.LANCZOS), np.uint8)

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

    def _condition(self, clap_emb: torch.Tensor, model_type: str, norm_target, temperature):
        """CLAP [B,512] -> (tokens77, routed audio dict) per model type;
        ``norm_target`` and ``temperature`` are floats or 0-dim fp32
        tensors."""
        if model_type == "baseline":
            return None, None
        if model_type == "sonic":
            tokens = rescale_to_norm(self.adapter(clap_emb), norm_target)
            return None, {lvl: tokens for lvl in LEVELS}
        tokens77, info = self.hierarchical(clap_emb, temperature, return_all=True)
        routed = {lvl: rescale_to_norm(t, norm_target) for lvl, t in info["routed"].items()}
        return rescale_to_norm(tokens77, norm_target), routed

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the pipeline's device, without waiting for the
        card: on CUDA through pinned memory and an asynchronous copy (a copy
        from pageable memory synchronises the stream, which would stall
        the requests ``generate_stream`` keeps in flight)."""
        t = torch.from_numpy(np.require(x, requirements=["C", "W"]))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def draws(self, seed: int, seeds=None, rows=None) -> RequestDraws:
        """The request's random draws (see ``RequestDraws``); the one place
        a caller or a test replaces them."""
        return RequestDraws(self.device, seed, seeds, rows)

    # -- generation -----------------------------------------------------------

    def _prepare(self, draws: RequestDraws, wav, wav2, text_ids, uncond_ids, *,
                 num_steps: int, guidance_scale: float, model_type: str, batch: int,
                 norm_target: float, temperature: float, sampler: str, init_steps: int,
                 init: Optional[np.ndarray], audio_mix: float, mask: Optional[np.ndarray],
                 guidance_rescale: float, per_lane_seeds: bool) -> Tuple[Signature, Inputs]:
        """Host preparation of a request: every copy from the host and every
        random draw (the initial latents, or img2img's VAE and noising
        draws; the stochastic sampler's per-step noise, drawn ahead), and
        the dynamic scalars as 0-dim fp32 tensors, all on the device: the
        device program's inputs, and the request's ``Signature``."""
        dev = self.device
        x: Inputs = {}
        if wav is not None:
            x["waveform"] = self._upload(wav)
            if wav2 is not None:
                x["waveform2"] = self._upload(wav2)
        x["ids"] = self._upload(np.concatenate([text_ids, uncond_ids], axis=0))
        lat = self.cfg.diffusion.image_size // 8
        if init_steps > 0:
            x["init_image"] = self._upload(init)
            rows = batch if batch > 1 and init.shape[0] == 1 else init.shape[0]
            shape = (rows, lat, lat, self.cfg.diffusion.vae.latent_channels)
            x["vae_noise"] = draws.vae(shape)
            x["img2img_noise"] = draws.img2img(shape)
            if mask is not None:
                x["mask"] = self._upload(mask)
        else:
            shape = (batch, lat, lat, 4)
            x["latents"] = draws.latents(shape)
        if sampler in STOCHASTIC:
            x["sampler_noise"] = predraw(draws.sampler(), self._grid(sampler, num_steps, init_steps),
                                         shape, dev)
        for name, value in (("guidance_scale", guidance_scale), ("norm_target", norm_target),
                            ("temperature", temperature), ("audio_mix", audio_mix),
                            ("guidance_rescale", guidance_rescale)):
            x[name] = torch.full((), value, dtype=torch.float32, device=dev)
        x = {k: v.to(dev) for k, v in x.items()}  # a caller's draws may lie elsewhere
        sig = Signature.of(x, num_steps=num_steps, model_type=model_type, batch=batch,
                           sampler=sampler, init_steps=init_steps,
                           per_lane_seeds=per_lane_seeds)
        return sig, x

    def _program(self, sig: Signature, x: Inputs) -> torch.Tensor:
        """The device program, the JAX ``_generate_jit``: dequantise ->
        log-mel -> HTSAT -> conditioning -> CLIP text -> the sampler loop
        with folded CFG -> VAE decode -> uint8 [B, H, W, 3]. It reads only
        ``x`` (``_prepare``'s tensors) and ``sig``'s statics: no copy from
        the host, no read of a device value on the host. It marks its start
        and the end of the audio conditioning, CLIP text, the sampler loop
        and the decode on the current stage clock (``ops/stage_clock.py``;
        ``_staged``)."""
        mark = stage_clock.mark
        mark(0)
        clap_emb = None
        if "waveform" in x:
            wf = _dequantize_pcm16(x["waveform"])
            if "waveform2" in x:
                # both sources in one CLAP call, then the blend, renormalised
                # (CLAP embeddings lie on the unit sphere)
                wf = torch.cat([wf, _dequantize_pcm16(x["waveform2"])])
            clap_emb = self.clap_audio(log_mel_spectrogram(wf, self.cfg.clap.frontend))
            if "waveform2" in x:
                n = clap_emb.shape[0] // 2
                mix = x["audio_mix"]
                mixed = mix * clap_emb[:n] + (1.0 - mix) * clap_emb[n:]
                clap_emb = mixed / torch.clamp(
                    torch.linalg.vector_norm(mixed, dim=-1, keepdim=True), min=1e-8)
            if sig.batch > 1 and clap_emb.shape[0] == 1:
                clap_emb = clap_emb.expand(sig.batch, -1)
        tokens77, routed = ((None, None) if clap_emb is None else self._condition(
            clap_emb, sig.model_type, x["norm_target"], x["temperature"]))
        mark(1)
        ehs_cond, ehs_uncond = self.clip_text(x["ids"]).chunk(2, dim=0)
        mark(2)
        if sig.model_type == "audio_tokens" and tokens77 is not None:
            ehs_cond = tokens77.to(ehs_cond.dtype)

        eps_fn = cfg_eps_fn(self.unet, ehs_cond, ehs_uncond, x["guidance_scale"],
                            audio_cond=routed, audio_uncond=routed,
                            guidance_rescale=x["guidance_rescale"])
        sample = SAMPLERS[sig.sampler]
        rng = stacked_draw(x["sampler_noise"]) if "sampler_noise" in x else None
        ts = list(self._grid(sig.sampler, sig.num_steps, sig.init_steps))
        blend_fn = None
        if sig.init_steps > 0:
            # SDEdit img2img: encode the init image, noise it to the first
            # timestep of the grid's tail, denoise only that tail
            img = (x["init_image"].float() / 127.5 - 1.0).to(self.compute_dtype)
            if sig.batch > 1 and img.shape[0] == 1:
                img = img.expand(sig.batch, *img.shape[1:])
            x0 = self.vae.sample_latent(img, lambda shape: x["vae_noise"])
            noise = x["img2img_noise"].to(x0.dtype)
            dev = x0.device
            t0 = torch.full((x0.shape[0],), ts[0], dtype=torch.long, device=dev)
            latents = self.schedule.add_noise(x0, noise, t0)
            if "mask" in x:
                # inpainting: after every update, the known (mask 0) region
                # is the init latent noised to the step's level (x0 itself
                # at the final step)
                m = x["mask"]

                def blend_fn(lat: torch.Tensor, t_prev: int) -> torch.Tensor:
                    known = x0
                    if t_prev >= 0:
                        tp = torch.full((x0.shape[0],), t_prev, dtype=torch.long, device=dev)
                        known = self.schedule.add_noise(x0, noise, tp)
                    return (m * lat.float() + (1.0 - m) * known.float()).to(lat.dtype)
        else:
            latents = x["latents"].to(self.compute_dtype)
        latents = sample(eps_fn, self.schedule, latents, sig.num_steps, timesteps=ts,
                         blend_fn=blend_fn, rng=rng)
        mark(3)
        img = self.vae.decode_latent(latents)
        img = torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8)
        mark(4)
        return img

    def _staged(self, sig: Signature, x: Inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_program`` with a stage clock of its own: (images, stamps)."""
        with stage_clock.timing(stage_clock.StageClock(x["ids"].device)) as clock:
            return self._program(sig, x), clock.stamps

    @torch.inference_mode()
    def _generate(self, draws: RequestDraws, wav, wav2, text_ids, uncond_ids, *, t0: int,
                  **statics) -> HostCopy:
        """The JAX program ``_generate_jit``: host preparation, then the
        device program, on CUDA as one replay of the request's signature's
        CUDA graph (captured at the signature's first request;
        ``diffusion/program.py``), on the CPU and under a model-parallel
        group eagerly. Returns the handle of the uint8 images [B, H, W, 3]
        on the device, unsynchronised. ``t0`` is when the request's checks
        began (``profiling.now()``): they and the preparation are its
        ``pipeline.prepare`` span, the program's run on the host (a replay:
        the lock, the copies in, the replay and the output's clone) its
        ``program.replay``."""
        sig, x = self._prepare(draws, wav, wav2, text_ids, uncond_ids, **statics)
        t1 = profiling.now()
        if not self._capture:
            img, stamps = self._staged(sig, x)
        else:
            img, stamps = self.programs.run(sig, x, functools.partial(self._staged, sig))
        t2 = profiling.now()
        did = profiling.new_id()
        profiling.record("pipeline.prepare", t0, t1, id=did, parent=did)
        profiling.record("program.replay", t1, t2, id=did, parent=did)
        return HostCopy(img, stamps, did, {"prepare": (t1 - t0) / 1e9,
                                           "replay": (t2 - t1) / 1e9})

    def generate(self, *args, **kw) -> np.ndarray:
        """Generate images [B, H, W, 3] uint8 (blocking); the arguments of
        ``_dispatch_generate``. Defaults: 50 steps, CFG 7.5, Norm-60, as in
        the JAX package."""
        return self._dispatch_generate(*args, **kw).numpy()

    def _dispatch_generate(
        self,
        waveform: Optional[np.ndarray] = None,
        text_ids: Optional[np.ndarray] = None,
        uncond_ids: Optional[np.ndarray] = None,
        *,
        num_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        norm_target: Optional[float] = None,
        temperature: float = 0.5,
        model_type: str = "hierarchical",
        seed: int = 0,
        batch: int = 1,
        sampler: Optional[str] = None,
        init_image: Optional[np.ndarray] = None,
        strength: float = 0.8,
        waveform2: Optional[np.ndarray] = None,
        audio_mix: float = 0.5,
        mask_image: Optional[np.ndarray] = None,
        seeds: Optional[np.ndarray] = None,
        guidance_rescale: float = 0.0,
        draws: Optional[RequestDraws] = None,
    ):
        """Check and prepare the arguments, then enqueue the request;
        returns, without synchronising, the ``HostCopy`` whose ``numpy()``
        gives the uint8 images [B, H, W, 3] (see the module doc).

        ``seeds`` (int [batch]) draws each lane's initial latents and
        sampler noise from its own seed (not with ``init_image``).
        ``init_image`` (uint8 [H, W, 3] or [B, H, W, 3]) with ``strength``
        runs SDEdit img2img over the last ``round(steps * strength)``
        timesteps; ``mask_image`` (uint8 [H, W], nonzero = regenerate)
        makes it inpainting (``strength=1.0`` for pure inpainting);
        ``waveform2`` with ``audio_mix`` blends two sources' CLAP
        embeddings (``audio_mix`` is the first one's weight). ``draws``
        replaces ``self.draws(seed, seeds)`` for this request
        (``generate_sharded`` passes a data rank's rows of them)."""
        t0 = profiling.now()
        sch = self.cfg.diffusion.scheduler
        sampler = sampler or sch.sampler
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; available: {sorted(SAMPLERS)}")
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {model_type!r}; available: {MODEL_TYPES}")
        if model_type == "sonic" and self.adapter is None:
            raise ValueError("model_type='sonic' needs the audio adapter, and params has no "
                             "'adapter' (train stage 1 and merge_stage_params(..., stage=1))")
        num_steps = num_steps or sch.num_inference_steps
        guidance_scale = sch.guidance_scale if guidance_scale is None else guidance_scale
        norm_target = (self.cfg.condition.audio_norm_target if norm_target is None
                       else norm_target)
        max_len = self.cfg.diffusion.clip_text.max_length
        if text_ids is None:
            text_ids = np.zeros((batch, max_len), np.int32)
        if uncond_ids is None:
            uncond_ids = np.zeros((batch, max_len), np.int32)

        wav, wav2 = _prep_wav(waveform), _prep_wav(waveform2)
        if wav2 is not None and wav is None:
            raise ValueError("waveform2 requires waveform")
        if wav2 is not None and wav2.shape[0] != wav.shape[0]:
            # the CLAP output is split in equal halves: unequal batches
            # would blend the wrong rows
            raise ValueError(f"waveform2 batch {wav2.shape[0]} must match waveform "
                             f"batch {wav.shape[0]}")
        if mask_image is not None and init_image is None:
            raise ValueError("mask_image requires init_image")
        if not 0.0 <= float(guidance_rescale) <= 1.0:
            raise ValueError(f"guidance_rescale must be in [0, 1], got {guidance_rescale}")
        if seeds is not None:
            if init_image is not None:
                raise ValueError("per-lane seeds are unsupported with "
                                 "init_image (img2img uses the scalar seed)")
            seeds = np.asarray(seeds, np.int32).reshape(-1)
            if seeds.shape[0] != batch:
                raise ValueError(f"seeds has {seeds.shape[0]} entries for batch {batch}")
        init_steps, init, mask = 0, None, None
        if init_image is not None:
            # validates strength and fixes the tail's length
            init_steps = int(img2img_timesteps(num_steps, strength,
                                               self.schedule.num_train_timesteps).shape[0])
            init = np.asarray(init_image)
            if init.dtype != np.uint8:
                # a uint8 cast would truncate a float [0, 1] image to black
                raise ValueError(f"init_image must be uint8 (got {init.dtype}); use "
                                 "pipeline.load_init_image() to convert")
            if init.ndim == 3:
                init = init[None]
            size = self.cfg.diffusion.image_size
            if init.shape[1:3] != (size, size):
                raise ValueError(f"init_image must be {size}x{size}, got {init.shape[1:3]}")
            if mask_image is not None:
                mask = _latent_mask(mask_image, size)

        return self._generate(
            draws or self.draws(seed, seeds), wav, wav2, np.asarray(text_ids, np.int32),
            np.asarray(uncond_ids, np.int32), t0=t0, num_steps=num_steps,
            guidance_scale=float(guidance_scale), model_type=model_type, batch=batch,
            norm_target=float(norm_target), temperature=float(temperature), sampler=sampler,
            init_steps=init_steps, init=init, audio_mix=float(np.float32(audio_mix)),
            mask=mask, guidance_rescale=float(guidance_rescale),
            per_lane_seeds=seeds is not None)

    def generate_stream(self, requests, *, depth: int = 2, **shared):
        """Pipelined generation over an iterable of per-image ``generate``
        kwarg dicts (each merged over ``shared``); yields uint8 images in
        order. ``depth`` requests are in flight: the host enqueues the next
        request's work while the card runs the one before, and fetches an
        image only when it must."""
        for img, _ in self.generate_stream_timed(requests, depth=depth, **shared):
            yield img

    def generate_stream_timed(self, requests, *, depth: int = 2, **shared):
        """``generate_stream`` that also yields each request's service time:
        ``(image, seconds)`` from its dispatch to its fetch, queueing behind
        the requests in flight included. The gaps between yields measure
        throughput, not latency."""
        in_flight: deque = deque()

        def drain():
            t_dispatch, out = in_flight.popleft()
            img = out.numpy()  # waits for this request's copy alone
            return img, time.perf_counter() - t_dispatch

        for req in requests:
            in_flight.append((time.perf_counter(),
                              self._dispatch_generate(**dict(shared, **req))))
            if len(in_flight) >= max(1, depth):
                yield drain()
        while in_flight:
            yield drain()

    # -- best-of-n reranked serving -------------------------------------------

    def _best_of_scorer(self):
        """(CLIP vision tower, text projection weight) on the device, built
        once from ``extra_params``. The vision tower computes in fp32, as
        the JAX tower promotes its weights against the fp32 pixels."""
        src = tuple(id(self.extra_params[t]) for t in BEST_OF_TOWERS)
        if self._scorer is None or self._scorer[0] != src:
            vision = build_tower(CLIPVisionEncoder, self.cfg.diffusion.clip_vision,
                                 self.extra_params["clip_vision"], self.device)
            proj = self.extra_params["clip_text_projection"]["weight"].to(self.device)
            self._scorer = (src, vision, proj)
        return self._scorer[1:]

    @torch.inference_mode()
    def _select_best(self, imgs: torch.Tensor, text_ids: np.ndarray):
        """Score candidates [n, H, W, 3] uint8 (on the device) against ONE
        prompt by CLIPScore and select the best there: (best image
        [H, W, 3], scores [n] fp32), both on the device."""
        vision, proj = self._best_of_scorer()
        px = preprocess_images_device(imgs, self.cfg.diffusion.clip_vision.image_size)
        feats = vision(px)  # [n, proj], L2-normalised
        ids = self._upload(text_ids)
        tf = clip_text_features(self.clip_text(ids), ids, proj)  # [1, proj]
        scores = torch.clamp((feats.float() * tf).sum(-1) * 100.0, min=0.0)  # CLIPScore
        return imgs[torch.argmax(scores)], scores

    def _dispatch_best_of(self, n: int, *, waveform=None, text_ids=None, uncond_ids=None,
                          seed: int = 0, seeds=None, waveform2=None, **knobs):
        """Enqueue best-of-n: one batched request of n candidates with
        per-lane seeds (``seed .. seed+n-1`` unless ``seeds`` is given),
        then the on-device score and select; no fetch in between. Returns
        the handles (best image, scores); their ``numpy()`` fetches. One
        sound rides once with ``batch=n``, as ``generate`` expands it (the
        card may round the CLAP tower at batch n otherwise: ROADMAP known
        delta 15)."""
        if n < 1:
            raise ValueError(f"best-of n must be >= 1, got {n}")
        missing = set(BEST_OF_TOWERS) - set(self.extra_params)
        if missing:
            raise ValueError(
                "best-of-n ranks candidates by CLIPScore and needs the CLIP vision weights "
                f"(params missing {sorted(missing)}); convert with "
                "clap2diffusion_tpu_torch.tools.convert_checkpoints --clip-vision")
        if text_ids is None:
            raise ValueError("best-of-n ranks candidates against the text prompt; a text "
                             "prompt is required")
        if knobs.get("init_image") is not None:
            raise ValueError("best-of-n is unsupported with init_image (candidates need "
                             "per-lane seeds; img2img uses the scalar seed path)")
        if "batch" in knobs:
            raise ValueError("best-of-n sets batch=n itself")
        text_ids = np.asarray(text_ids, np.int32)
        if text_ids.ndim == 1:
            text_ids = text_ids[None]
        if text_ids.shape[0] != 1:
            raise ValueError(f"best-of-n takes ONE prompt, got {text_ids.shape[0]}")
        if uncond_ids is not None:
            uncond_ids = np.asarray(uncond_ids, np.int32)
            if uncond_ids.ndim == 1:
                uncond_ids = uncond_ids[None]
            if uncond_ids.shape[0] == 1:
                uncond_ids = np.repeat(uncond_ids, n, axis=0)
        if seeds is None:
            seeds = np.arange(seed, seed + n, dtype=np.int32)
        handle = self._dispatch_generate(
            waveform=waveform, text_ids=np.repeat(text_ids, n, axis=0), uncond_ids=uncond_ids,
            batch=n, seed=seed, seeds=seeds, waveform2=waveform2, **knobs)
        best, scores = self._select_best(handle.device_images, text_ids)
        if not best.is_cuda:
            return best, scores
        with torch.inference_mode():
            return HostCopy(best), HostCopy(scores)

    def generate_best_of(self, n: int, **kw):
        """Generate ``n`` candidates (per-lane seeds) and return ``(best
        image [H, W, 3] uint8, clip_scores [n])``: the candidate with the
        highest CLIPScore against the prompt, selected on the device. The
        arguments are ``generate``'s, without ``batch``, ``init_image`` or
        ``mask_image``. Needs the ``clip_vision`` and
        ``clip_text_projection`` towers (the converter's
        ``--clip-vision``)."""
        best, scores = self._dispatch_best_of(n, **kw)
        return best.numpy(), scores.numpy()


def shard_pipeline_for_serving(pipe: AudioToImagePipeline, mesh) -> AudioToImagePipeline:
    """Latency-mode tensor parallelism (port of the JAX function): every
    tower's wide Dense layers (``parallel/sharding.py::param_spec``: the
    UNet's GEGLU projections, CLIP text's and HTSAT's wide MLPs, the
    adapter's 256 -> 24,576 KV head) become column-parallel over the mesh's
    model axis, each rank holding its rows of their weights; the ranks of a
    model group then serve the same request in lockstep, gathering each
    sharded layer's output. ``pipe.params`` gives the shards afterwards. A
    mesh without a model axis is a no-op."""
    from clap2diffusion_tpu_torch.parallel.sharding import shard_params

    if mesh.size("model") == 1:
        return pipe
    for name in CORE_TOWERS:
        module = getattr(pipe, name)
        if module is not None:
            local = shard_params(module, module.state_dict(), mesh)
            module.load_state_dict(local, strict=True)
    pipe._scorer = None
    # the sharded layers gather over the group, which a CUDA graph does not
    # take (Gloo; ROADMAP known delta 23): requests run the program eagerly
    pipe.programs.clear()
    pipe._capture = False
    return pipe


def generate_sharded(pipe: AudioToImagePipeline, mesh, waveforms: np.ndarray,
                     text_ids: np.ndarray, uncond_ids: Optional[np.ndarray] = None,
                     num_steps: int = 50, guidance_scale: float = 7.5,
                     norm_target: float = 60.0, model_type: str = "hierarchical",
                     seed: int = 0, sampler: str = "ddim",
                     seeds: Optional[np.ndarray] = None) -> np.ndarray:
    """Serve a batch of requests over the mesh's data axis (port of the JAX
    function): each data rank runs its slice of the batch (which the data
    axis must divide) through the normal ``generate``, and the ranks gather
    the uint8 images, so every rank returns all [B, H, W, 3]. ``seeds``
    (int [B]) gives each lane its own noise, so a lane's image does not
    depend on the rank it lands on; without it each rank draws its rows of
    the batch's draws, as one ``generate(batch=B, seed=seed)`` draws them.
    A single-rank mesh is ``generate`` itself."""
    import torch.distributed as dist

    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; available: {sorted(SAMPLERS)}")
    b = text_ids.shape[0]
    if uncond_ids is None:
        uncond_ids = np.zeros_like(text_ids)
    if seeds is not None:
        seeds = np.asarray(seeds, np.int32).reshape(-1)
        if seeds.shape[0] != b:
            raise ValueError(f"seeds has {seeds.shape[0]} entries for batch {b}")
    count, index = mesh.size("data"), mesh.coord("data")
    if b % count:
        raise ValueError(f"batch {b} is not divisible by the data axis {count}")
    rows = slice(index * (b // count), (index + 1) * (b // count))
    kw = dict(num_steps=num_steps, guidance_scale=guidance_scale, norm_target=norm_target,
              temperature=0.5, model_type=model_type, seed=seed, batch=b // count,
              sampler=sampler, seeds=None if seeds is None else seeds[rows])
    if count == 1:
        return pipe.generate(waveforms, text_ids.astype(np.int32),
                             uncond_ids.astype(np.int32), **kw)
    if seeds is None:
        kw["draws"] = pipe.draws(seed, rows=(index, count))
    imgs = pipe.generate(np.asarray(waveforms)[rows], text_ids[rows].astype(np.int32),
                         uncond_ids[rows].astype(np.int32), **kw)
    group = mesh.group("data")
    local = torch.from_numpy(np.ascontiguousarray(imgs))
    if dist.get_backend(group) != "gloo":
        local = local.to(pipe.device)
    parts = [torch.empty_like(local) for _ in range(count)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).cpu().numpy()
