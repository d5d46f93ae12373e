"""Published checkpoints -> one pipeline checkpoint of the port (counterpart
of ``tools/convert_checkpoints.py``).

    python -m clap2diffusion_tpu_torch.tools.convert_checkpoints \
        --clap /path/clap_model.(bin|pt|safetensors) \
        --sd-unet /path/unet/diffusion_pytorch_model.safetensors \
        --sd-vae /path/vae/diffusion_pytorch_model.safetensors \
        --clip-text /path/text_encoder/model.safetensors \
        --hierarchical /path/hierarchical_v4_final.pth \
        --adapter /path/audio_projector_stage2.pth \
        [--clip-vision /path/clip/model.safetensors] [--inception /path/inception_v3.pth] \
        --out checkpoints/pipeline

Every slot reads ``.safetensors`` (``utils/safetensors_io``, no package
beyond torch) or a torch ``.pt/.bin/.pth`` (``torch.load`` with
``weights_only=True``). Any subset may be given: the towers not given keep
the random initialisation of seed 0, drawn on ``--device`` (CUDA unless
``--device cpu``), and are reported. The UNet keeps that initialisation's
audio-injection branches, which diffusers does not have. The output is a
``save_pipeline`` checkpoint for ``load_pipeline``, ``apps.main infer
--checkpoint`` and ``apps.server --checkpoint``. The evaluation and best-of
towers are added when given: ``--clap`` converts a ``ClapModel``'s text
tower too (``clap_text``; without one it stays out and the evaluator stamps
``clap_text_random_init``), ``--clip-vision`` the CLIP vision tower (and
``clip_text_projection`` from a whole ``CLIPModel`` dict), ``--inception``
torchvision's InceptionV3.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from clap2diffusion_tpu_torch.core.config import load_config
from clap2diffusion_tpu_torch.diffusion.pipeline import CORE_TOWERS, init_params, save_pipeline
from clap2diffusion_tpu_torch.models.clap.convert import (
    convert_clap_audio,
    convert_clap_text,
    has_text_tower,
)
from clap2diffusion_tpu_torch.models.clip_vision import (
    convert_clip_text_projection,
    convert_clip_vision,
)
from clap2diffusion_tpu_torch.models.condition.convert import (
    convert_audio_adapter,
    convert_hierarchical_encoder,
    unwrap,
)
from clap2diffusion_tpu_torch.models.convert import (
    convert_clip_text,
    convert_sd_unet,
    convert_sd_vae,
)
from clap2diffusion_tpu_torch.models.inception_v3 import convert_inception_v3
from clap2diffusion_tpu_torch.utils.safetensors_io import load_safetensors


def load_sd(path: str):
    """A state dict from ``.safetensors`` or a torch file (a top-level
    ``state_dict`` entry unwrapped)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="convert_checkpoints", description=__doc__.split("\n")[0])
    ap.add_argument("--clap", help="HF ClapModel / ClapAudioModelWithProjection state dict")
    ap.add_argument("--sd-unet", help="diffusers UNet state dict")
    ap.add_argument("--sd-vae", help="diffusers VAE state dict")
    ap.add_argument("--clip-text", help="transformers CLIPTextModel state dict")
    ap.add_argument("--hierarchical", help="reference hierarchical encoder .pth (soft V4)")
    ap.add_argument("--adapter", help="reference AudioAdapter .pth")
    ap.add_argument("--clip-vision", help="transformers CLIPModel / "
                    "CLIPVisionModelWithProjection state dict (CLIPScore, best-of, "
                    "frechet_clip_vision)")
    ap.add_argument("--inception", help="torchvision inception_v3 state dict (FID, KID and the "
                    "Inception Score)")
    ap.add_argument("--out", required=True, help="output pipeline checkpoint directory")
    ap.add_argument("--config", default=None, help="YAML config (needs PyYAML)")
    ap.add_argument("--device", default=None,
                    help="where the random towers are drawn (default cuda; 'cpu' on a host "
                         "without a GPU; a seed draws other values on each)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    params = init_params(cfg, seed=0, device=args.device)
    converted = []
    if args.clap:
        sd = load_sd(args.clap)
        params["clap_audio"] = convert_clap_audio(sd, cfg.clap.audio)
        converted.append("clap_audio")
        # a whole ClapModel dict carries the text tower: converted too, so
        # that the evaluator's audio_text_alignment is checkpoint-faithful
        if has_text_tower(sd):
            params["clap_text"] = convert_clap_text(sd, cfg.clap.text)
            converted.append("clap_text")
        else:
            print("note: --clap dict has no text tower keys; clap_text left at random init "
                  "(audio_text_alignment will be stamped clap_text_random_init)")
    if args.sd_unet:
        unet = convert_sd_unet(load_sd(args.sd_unet), cfg.diffusion.unet)
        # keep the (random) audio-injection branches: diffusers has none
        unet.update({k: v for k, v in params["unet"].items() if k.startswith("audio_inject.")})
        params["unet"] = unet
        converted.append("unet")
    if args.sd_vae:
        params["vae"] = convert_sd_vae(load_sd(args.sd_vae), cfg.diffusion.vae)
        converted.append("vae")
    if args.clip_text:
        params["clip_text"] = convert_clip_text(load_sd(args.clip_text), cfg.diffusion.clip_text)
        converted.append("clip_text")
    if args.hierarchical:
        sd = unwrap(load_sd(args.hierarchical), "hierarchical_state_dict")
        params["hierarchical"] = convert_hierarchical_encoder(sd, cfg.condition)
        converted.append("hierarchical")
    if args.adapter:
        sd = unwrap(load_sd(args.adapter), "adapter_state_dict")
        params["adapter"] = convert_audio_adapter(sd, cfg.condition)
        converted.append("adapter")
    if args.clip_vision:
        sd = load_sd(args.clip_vision)
        params["clip_vision"] = convert_clip_vision(sd, cfg.diffusion.clip_vision)
        converted.append("clip_vision")
        # a whole CLIPModel dict also carries the text projection CLIPScore needs
        if "text_projection.weight" in sd:
            params["clip_text_projection"] = convert_clip_text_projection(sd)
            converted.append("clip_text_projection")
    if args.inception:
        params["inception_v3"] = convert_inception_v3(load_sd(args.inception))
        converted.append("inception_v3")

    path = save_pipeline(args.out, params)
    missing = sorted(set(CORE_TOWERS) - set(converted))
    print(f"converted: {converted or 'none'}")
    if missing:
        print(f"random init kept for: {missing}")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
