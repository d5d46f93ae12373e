"""A tiny copy of the benchmark for CPU tests: the same cells, files,
metrics and model families under a temporary root, with a tiny model, 3
sampling steps, half a second of audio and small pools."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from perfbench.harness import common

ROOT = common.ROOT


def tiny_model() -> dict:
    from clap2diffusion_tpu_torch.core import config as C

    cfg = C.Config(
        clap=C.CLAPConfig(
            frontend=C.AudioFrontendConfig(num_mel_bins=16, duration_s=0.5),
            audio=C.HTSATConfig(spec_size=64, num_mel_bins=16, patch_embed_dim=8,
                                depths=(1, 1), num_heads=(2, 2), window_size=4,
                                hidden_size=16, projection_dim=32),
            embed_dim=32),
        condition=C.ConditionConfig(
            clap_dim=32, token_dim=48, num_tokens=4, num_output_tokens=7, num_adapter_tokens=4,
            hierarchy_bottleneck=24, hierarchy_heads=2, projector_bottleneck=16,
            projector_heads=2, projector_layers=1, adapter_kv_hidden=8,
            adapter_self_attn_layers=1, adapter_heads=2),
        diffusion=C.DiffusionConfig(
            unet=C.UNetConfig(block_out_channels=(16, 32, 32, 32), layers_per_block=1,
                              num_attention_heads=2, cross_attention_dim=48, norm_num_groups=8,
                              sample_size=8, flash_attention=False, injection_bottleneck=8),
            vae=C.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                            layers_per_block=1),
            clip_text=C.CLIPTextConfig(vocab_size=128, hidden_size=48, num_layers=1,
                                       num_heads=2, intermediate_size=96, max_length=7),
            scheduler=C.SchedulerConfig(num_inference_steps=3), image_size=64))
    return dataclasses.asdict(cfg)


def make_root(tmp: str, dtype: str = "float32") -> str:
    """A copy of BENCHMARK.json and the benchmark's data files under ``tmp``,
    cut to the tiny size, serving and training computing in ``dtype``
    (float32 by default: a sound run then reads next to nothing); returns
    ``tmp``."""
    bench = common.load_benchmark()
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(tmp, "perfbench", sub), exist_ok=True)
    for sub in ("metrics", "families"):
        shutil.copytree(os.path.join(ROOT, "perfbench", sub), os.path.join(tmp, "perfbench", sub),
                        dirs_exist_ok=True)
    model = tiny_model()
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            d = json.load(f)
        d["model"] = json.loads(json.dumps(model))
        d["model"]["train"]["compute_dtype"] = dtype
        if "serve" in d:
            d["serve"].update(steps=3, dtype=dtype)
        write(tmp, c["file"], d)
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "perfbench", "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        t["audio"]["seconds"] = 0.5
        for group in (t["audio"], t["prompts"]):
            if "pool" in group:
                group["pool"] = 8
        if "pool" in t:
            t["pool"] = 3
        if "trace_seconds" in t:
            t["trace_seconds"] = 1
        write(tmp, f"perfbench/traffic/{w['traffic']}.json", t)
    write(tmp, "BENCHMARK.json", bench)
    return tmp


def write(root: str, rel: str, obj) -> None:
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
