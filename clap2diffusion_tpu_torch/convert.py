"""Weight bridge: a JAX/Flax parameter tree -> the port's state dicts.

``from_flax(params)`` takes the tree that
``clap2diffusion_tpu/diffusion/pipeline.py::init_params`` builds (or any
checkpoint of that shape), as numpy arrays, and returns
``{"clap_audio", "clip_text", "hierarchical", "unet", "vae": state_dict}``
for ``AudioToImagePipeline(params=...)``. Dense ``kernel`` [in, out]
becomes ``weight`` [out, in]; conv ``kernel`` [kh, kw, cin, cout] becomes
``weight`` [cout, cin, kh, kw]; norm ``scale`` becomes ``weight``. Module
paths are renamed to the upstream torch names (diffusers, HF CLAP/CLIP,
the reference's conditioning modules), which are the inverse of the JAX
package's converters. The audio-injection branches have no diffusers name
and are mapped by hand to the reference's processor names. The audio
adapter (stage 1 and 3) is carried across under the reference's
``AudioAdapter`` names when the tree has one; the VAE's encoder and
``quant_conv`` (img2img and inpainting) are carried under diffusers' names.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

Rules = List[Tuple[str, str]]

_UNET_RULES: Rules = [
    (r"^(down|up)_(\d+)_resnet_(\d+)/", r"\1_blocks.\2.resnets.\3/"),
    (r"^(down|up)_(\d+)_attn_(\d+)/", r"\1_blocks.\2.attentions.\3/"),
    (r"^down_(\d+)_downsample/", r"down_blocks.\1.downsamplers.0/"),
    (r"^up_(\d+)_upsample/", r"up_blocks.\1.upsamplers.0/"),
    (r"^mid_resnet_(\d+)/", r"mid_block.resnets.\1/"),
    (r"^mid_attn/", r"mid_block.attentions.0/"),
    (r"/block_0/", r"/transformer_blocks.0/"),
    (r"/to_out/", r"/to_out.0/"),
    (r"/ff/proj_in/", r"/ff/net.0.proj/"),
    (r"/ff/proj_out/", r"/ff/net.2/"),
    (r"^audio_inject_(\w+?)/proj_fc1/", r"audio_inject.\1.audio_proj.0/"),
    (r"^audio_inject_(\w+?)/proj_fc2/", r"audio_inject.\1.audio_proj.3/"),
    (r"^audio_inject_(\w+?)/alpha$", r"audio_inject.\1.alpha"),
]

_VAE_RULES: Rules = [
    (r"^decoder/up_(\d+)_resnet_(\d+)/", r"decoder/up_blocks.\1.resnets.\2/"),
    (r"^decoder/up_(\d+)_upsample/", r"decoder/up_blocks.\1.upsamplers.0.conv/"),
    (r"^encoder/down_(\d+)_resnet_(\d+)/", r"encoder/down_blocks.\1.resnets.\2/"),
    (r"^encoder/down_(\d+)_downsample/", r"encoder/down_blocks.\1.downsamplers.0.conv/"),
    (r"^(en|de)coder/mid/resnet_(\d+)/", r"\1coder/mid_block.resnets.\2/"),
    (r"^(en|de)coder/mid/attn/", r"\1coder/mid_block.attentions.0/"),
    (r"/to_out/", r"/to_out.0/"),
]

_CLIP_RULES: Rules = [
    (r"^token_embedding/embedding$", "embeddings.token_embedding.weight"),
    (r"^position_embedding$", "embeddings.position_embedding.weight"),
    (r"^layer_(\d+)/", r"encoder.layers.\1/"),
    (r"/fc(\d)/", r"/mlp.fc\1/"),
]

_CLAP_RULES: Rules = [
    (r"^encoder/bn_scale$", "audio_encoder.batch_norm.weight"),
    (r"^encoder/bn_bias$", "audio_encoder.batch_norm.bias"),
    (r"^encoder/bn_mean$", "audio_encoder.batch_norm.running_mean"),
    (r"^encoder/bn_var$", "audio_encoder.batch_norm.running_var"),
    (r"^encoder/patch_embed/", "audio_encoder.patch_embed.proj/"),
    (r"^encoder/patch_norm/", "audio_encoder.patch_embed.norm/"),
    (r"^encoder/stage_(\d+)_layer_(\d+)/", r"audio_encoder.layers.\1.blocks.\2/"),
    (r"^encoder/stage_(\d+)_downsample/", r"audio_encoder.layers.\1.downsample/"),
    (r"^encoder/norm/", "audio_encoder.norm/"),
    (r"/attention/(query|key|value|relative_position_bias_table)",
     r"/attention.self.\1"),
    (r"/attention/output/", "/attention.output.dense/"),
    (r"/intermediate/", "/intermediate.dense/"),
    (r"/mlp_output/", "/output.dense/"),
    (r"^projection_(\d)/", r"audio_projection.linear\1/"),
]

_HIER_RULES: Rules = [
    (r"^decomposer/mlp_fc1/", "decomposer/shared_mlp.0/"),
    (r"^decomposer/mlp_norm/", "decomposer/shared_mlp.2/"),
    (r"^decomposer/mlp_fc2/", "decomposer/shared_mlp.4/"),
    (r"^decomposer/gate_fc1/", "decomposer/gating_head.0/"),
    (r"^decomposer/gate_fc2/", "decomposer/gating_head.2/"),
    (r"/cross_hierarchy_attn/mlp_fc1/", "/cross_hierarchy_attn/mlp.0/"),
    (r"/cross_hierarchy_attn/mlp_fc2/", "/cross_hierarchy_attn/mlp.3/"),
    (r"^router/gate_(\w+)$", r"router.level_gates.\1"),
    (r"^adaptive_weights/fc1/", "adaptive_weights.weight_network.0/"),
    (r"^adaptive_weights/norm/", "adaptive_weights.weight_network.2/"),
    (r"^adaptive_weights/fc2/", "adaptive_weights.weight_network.3/"),
    (r"^projector/block_(\d+)/out_proj/", r"projector/blocks.\1.cross_attn.out_proj/"),
    (r"^projector/block_(\d+)/ffn_norm/", r"projector/blocks.\1.ffn.0/"),
    (r"^projector/block_(\d+)/ffn_fc1/", r"projector/blocks.\1.ffn.1/"),
    (r"^projector/block_(\d+)/ffn_fc2/", r"projector/blocks.\1.ffn.4/"),
    (r"^projector/block_(\d+)/", r"projector/blocks.\1/"),
]

_ADAPTER_RULES: Rules = [
    (r"^token_generator/kv_fc1/", "token_generator/audio_to_kv.0/"),
    (r"^token_generator/kv_fc2/", "token_generator/audio_to_kv.3/"),
    (r"^token_generator/ln_(\d+)/", r"token_generator/layer_norms.\1/"),
    (r"^token_generator/self_attn_(\d+)/to_out/",
     r"token_generator/self_attn_layers.\1.to_out.0/"),
    (r"^token_generator/self_attn_(\d+)/", r"token_generator/self_attn_layers.\1/"),
    (r"^token_generator/output_proj/", "token_generator/output_proj.0/"),
    (r"^token_generator/output_norm/", "token_generator/output_proj.1/"),
]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _leaf(path: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    """Rename a Flax leaf to its torch name and transpose it."""
    head, _, name = path.rpartition("/")
    if name == "kernel":
        x = x.T if x.ndim == 2 else x.transpose(3, 2, 0, 1)
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return (f"{head}.{name}" if head else name).replace("/", "."), x


def _convert(tree, rules: Rules) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, x in _flatten(tree).items():
        for pat, rep in rules:
            path = re.sub(pat, rep, path)
        name, x = _leaf(path, x)
        sd[name] = torch.from_numpy(np.array(x, dtype=np.float32))
    return sd


def unet_from_flax(p) -> Dict[str, torch.Tensor]:
    return _convert(p, _UNET_RULES)


def vae_from_flax(p) -> Dict[str, torch.Tensor]:
    """The whole VAE under diffusers' names: ``decoder.*``,
    ``post_quant_conv.*``, ``encoder.*`` and ``quant_conv.*``."""
    return _convert(p, _VAE_RULES)


def clip_text_from_flax(p) -> Dict[str, torch.Tensor]:
    return _convert(p, _CLIP_RULES)


def clap_audio_from_flax(p) -> Dict[str, torch.Tensor]:
    return _convert(p, _CLAP_RULES)


def hierarchical_from_flax(p) -> Dict[str, torch.Tensor]:
    """The reference projector uses nn.MultiheadAttention: each block's q/k/v
    rows are stacked into ``in_proj_weight`` [3E, E] and ``in_proj_bias``."""
    sd = _convert(p, _HIER_RULES)
    blocks = sorted({m.group(1) for k in sd
                     if (m := re.match(r"projector\.blocks\.(\d+)\.q_proj\.", k))})
    for i in blocks:
        pre = f"projector.blocks.{i}."
        for kind in ("weight", "bias"):
            sd[f"{pre}cross_attn.in_proj_{kind}"] = torch.cat(
                [sd.pop(f"{pre}{c}_proj.{kind}") for c in "qkv"])
    return sd


def adapter_from_flax(p) -> Dict[str, torch.Tensor]:
    return _convert(p, _ADAPTER_RULES)


def from_flax(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX pipeline params -> the port's per-tower state dicts."""
    out = {
        "clap_audio": clap_audio_from_flax(params["clap_audio"]),
        "clip_text": clip_text_from_flax(params["clip_text"]),
        "hierarchical": hierarchical_from_flax(params["hierarchical"]),
        "unet": unet_from_flax(params["unet"]),
        "vae": vae_from_flax(params["vae"]),
    }
    if "adapter" in params:
        out["adapter"] = adapter_from_flax(params["adapter"])
    return out
