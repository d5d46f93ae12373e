"""Evaluation harness (port of ``clap2diffusion_tpu/eval/evaluate.py``):
generate over a dataset split, compute the metrics, return per-sample
records and a mean/std summary.

- ``audio_text_alignment``: the CLAP audio <-> text cosine; captions go
  through the RoBERTa BPE tokenizer and the CLAP text tower, audio through
  the HTSAT tower, both in chunks of ``clap_batch``.
- ``clip_score`` (per sample) and ``frechet_clip_vision`` /
  ``kid_clip_vision`` (generated against reference frames) when the params
  hold ``clip_vision`` and ``clip_text_projection``.
- ``fid``, ``kid`` (InceptionV3 pool3) and ``inception_score`` when they
  hold ``inception_v3``; ``fid_variant`` picks the pooling semantics
  (``models/inception_v3.py``) and is stamped in the summary.

Stamps, as in JAX: ``tokenizer_fallback`` (hash CLIP tokenizer),
``roberta_fallback`` (hash RoBERTa BPE) and ``clap_text_random_init`` (no
``clap_text`` weights) mark metrics that are structurally real but not
checkpoint-faithful. Per-sample ``service_s`` is a request's dispatch ->
fetch time (two requests in flight); ``throughput_img_s`` is images over
the generation's wall time. Fixed eval seed 42, as the reference's.

Reference frames are ``<data_root>/frames/<audio_id>.png|.jpg|.jpeg``: a PNG
at the image size is read by ``utils/png.py``; a JPEG, or a frame of
another size (resized to the image size, as JAX does), needs Pillow. The
metric towers run on the pipeline's device: CLIP vision and Inception in
fp32 (the JAX towers promote their weights against fp32 pixels), the CLAP
text tower in its weights' type; Inception always with its running
statistics (``BatchNorm``), built in eval mode.

``shard=True`` fans the generation out over the job's processes
(``diffusion/pipeline.py::generate_sharded`` on a 1-D data mesh of every
rank; one process per card, joined by ``initialize_distributed`` from the
``C2D_*`` variables, and a single process is a mesh of one): groups of as
many samples as ranks, the tail group padded with its last sample, every
lane seeded with the evaluation seed, so that each image is
``generate(seeds=[seed])`` of its sample wherever it runs. A sample's
service time is its group's wall time. Every rank computes the metrics.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.eval import metrics as M


def load_reference_frame(path: str, size) -> np.ndarray:
    """A reference frame as uint8 RGB [H, W, 3] at ``size`` (h, w): a PNG of
    that size through ``utils/png.py``; anything else through Pillow
    (``convert("RGB").resize``, as the JAX evaluator reads it)."""
    from clap2diffusion_tpu_torch.utils.png import read_rgb

    return read_rgb(path, size)


def run_evaluation(
    cfg: Config,
    data_root: Optional[str] = None,
    max_samples: int = 8,
    num_steps: int = 50,
    seed: int = 42,
    params: Optional[Dict] = None,
    sampler: Optional[str] = None,
    shard: bool = False,
    fid_variant: str = "torchvision",
    clap_batch: int = 32,
    device=None,
) -> Dict:
    """Generate ``max_samples`` images of the test split and score them; the
    result dict of the JAX ``run_evaluation`` (config, timings, samples,
    summary, image_stats and the three stamps). ``params``: tower -> state
    dict (the core towers and any of ``clip_vision``,
    ``clip_text_projection``, ``clap_text``, ``inception_v3``); None draws
    the pipeline from ``seed``. Runs on CUDA unless ``device="cpu"``."""
    if shard:
        from clap2diffusion_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(device=device)
    from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset
    from clap2diffusion_tpu_torch.diffusion.pipeline import (
        AudioToImagePipeline,
        _special_init,
        random_init_,
    )
    from clap2diffusion_tpu_torch.models.clap.text import ClapTextTower
    from clap2diffusion_tpu_torch.models.clip_vision import (
        CLIPVisionEncoder,
        build_tower,
        clip_text_features,
        preprocess_images_device,
    )
    from clap2diffusion_tpu_torch.models.inception_v3 import (
        build_inception,
        preprocess_images_inception_device,
    )
    from clap2diffusion_tpu_torch.models.roberta_tokenizer import RobertaTokenizer
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    pipe = AudioToImagePipeline(cfg, params=params, seed=seed, device=device)
    dev = pipe.device
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    root = data_root or cfg.data.data_root
    dataset = AudioCapsLatentDataset(root, split="test", audio_duration=cfg.data.duration_s,
                                     sample_rate=cfg.data.sample_rate,
                                     latent_hw=cfg.data.latent_shape[1])
    n = min(max_samples, len(dataset))

    # the CLAP text tower: converted weights, or a random one from ``seed``
    # (stamped clap_text_random_init)
    rtok = RobertaTokenizer()
    clap_text_random = not (params and "clap_text" in params)
    with torch.device("meta"):
        text_tower = ClapTextTower(cfg.clap.text)
    text_tower.to_empty(device=dev)
    if clap_text_random:
        random_init_(text_tower, torch.Generator(device=dev).manual_seed(seed),
                     _special_init(cfg))
    else:
        sd = params["clap_text"]
        text_tower.to(next(iter(sd.values())).dtype)
        text_tower.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    text_tower.eval().requires_grad_(False)

    per_sample: Dict[str, list] = {"audio_text_alignment": [], "image_std": [],
                                   "service_s": []}
    vision = proj = None
    if params and "clip_vision" in params and "clip_text_projection" in params:
        vision = build_tower(CLIPVisionEncoder, cfg.diffusion.clip_vision,
                             params["clip_vision"], dev)
        proj = params["clip_text_projection"]["weight"].to(dev)
        per_sample["clip_score"] = []
    inception = None
    if params and "inception_v3" in params:
        inception = build_inception(params["inception_v3"], dev, variant=fid_variant)

    @torch.inference_mode()
    def clip_features(imgs: np.ndarray) -> np.ndarray:
        px = preprocess_images_device(torch.from_numpy(imgs).to(dev),
                                      cfg.diffusion.clip_vision.image_size)
        return vision(px).float().cpu().numpy()

    @torch.inference_mode()
    def inception_out(imgs: np.ndarray, key: str) -> np.ndarray:
        px = preprocess_images_inception_device(torch.from_numpy(imgs).to(dev))
        return inception(px)[key].float().cpu().numpy()

    records = []
    items = [dataset[i] for i in range(n)]
    images: list = []
    service_times: list = []
    wall_start = time.perf_counter()
    if shard and n:
        from clap2diffusion_tpu_torch.core.mesh import make_mesh
        from clap2diffusion_tpu_torch.diffusion.pipeline import generate_sharded

        mesh = make_mesh({"data": -1})
        d = mesh.size("data")
        uncond = tok("")
        for i in range(0, n, d):
            chunk = items[i:i + d]
            k = len(chunk)
            # the tail group padded with its last sample: every group the same size
            wavs = np.stack([c["audio"] for c in chunk] + [chunk[-1]["audio"]] * (d - k))
            ids = np.concatenate([tok(c["caption"]) for c in chunk]
                                 + [tok(chunk[-1]["caption"])] * (d - k))
            t0 = time.perf_counter()
            imgs = generate_sharded(
                pipe, mesh, wavs, ids, uncond_ids=np.repeat(uncond, d, axis=0),
                num_steps=num_steps, guidance_scale=cfg.diffusion.scheduler.guidance_scale,
                norm_target=cfg.condition.audio_norm_target, seed=seed,
                sampler=sampler or cfg.diffusion.scheduler.sampler,
                seeds=np.full(d, seed, np.int32))
            dt = time.perf_counter() - t0
            images.extend(imgs[:k])
            service_times.extend([dt] * k)  # a sample completes with its group
    else:
        # two requests in flight: one image's host transfers overlap its
        # neighbour's compute; service_s is each request's dispatch -> fetch
        reqs = [{"waveform": item["audio"], "text_ids": tok(item["caption"])}
                for item in items]
        for img, dt in pipe.generate_stream_timed(iter(reqs), depth=2, uncond_ids=tok(""),
                                                  num_steps=num_steps, seed=seed,
                                                  sampler=sampler):
            images.append(img[0])
            service_times.append(dt)
    generation_wall_s = time.perf_counter() - wall_start
    timings: Dict[str, float] = {"generation_s": round(generation_wall_s, 2)}

    # the CLAP towers in fixed-size chunks, the tail padded with its last
    # sample and the padding sliced away
    if n:
        t_phase = time.perf_counter()
        chunk_n = min(max(1, clap_batch), n)
        audio_parts, text_parts = [], []
        for i in range(0, n, chunk_n):
            chunk = items[i:i + chunk_n]
            pad = chunk_n - len(chunk)
            wav = np.stack([c["audio"] for c in chunk] + [chunk[-1]["audio"]] * pad)
            audio_parts.append(pipe.encode_audio(wav).float().cpu().numpy()[:len(chunk)])
            rt = rtok([c["caption"] for c in chunk] + [chunk[-1]["caption"]] * pad)
            with torch.inference_mode():
                emb = text_tower(torch.from_numpy(rt["input_ids"]).to(dev),
                                 torch.from_numpy(rt["attention_mask"]).to(dev))
            text_parts.append(emb.float().cpu().numpy()[:len(chunk)])
        clap_audio_emb = np.concatenate(audio_parts)
        clap_text_emb = np.concatenate(text_parts)
        timings["clap_towers_s"] = round(time.perf_counter() - t_phase, 2)

    t_phase = time.perf_counter()
    for i, (item, img, dt) in enumerate(zip(items, images, service_times)):
        align = M.audio_text_alignment(clap_audio_emb[i:i + 1], clap_text_emb[i:i + 1])
        per_sample["audio_text_alignment"].append(align)
        per_sample["image_std"].append(float(img.std() / 255.0))
        per_sample["service_s"].append(dt)
        if vision is not None:
            ids = tok(item["caption"])
            img_feats = clip_features(img[None])
            ids_t = torch.from_numpy(np.asarray(ids, np.int32))
            txt_feats = clip_text_features(pipe.encode_text(ids), ids_t, proj)
            per_sample["clip_score"].append(M.clip_score(img_feats, txt_feats.cpu().numpy()))
        records.append({"id": item["audio_id"], "caption": item["caption"],
                        "service_s": dt, "audio_text_alignment": align})
    timings["per_sample_metrics_s"] = round(time.perf_counter() - t_phase, 2)
    image_arr = np.stack(images) if images else np.zeros((0, 8, 8, 3), np.uint8)
    summary = M.summarize(per_sample)
    if n:
        summary["throughput_img_s"] = n / generation_wall_s

    # Frechet metrics, generated against reference frames: ``fid`` over
    # InceptionV3 pool3, ``frechet_clip_vision`` over CLIP vision features
    # (not comparable with published FID numbers)
    if (vision is not None or inception is not None) and n >= 2:
        t_phase = time.perf_counter()
        frames_dir = os.path.join(root, "frames")
        refs = []
        for rec in records:
            for ext in (".png", ".jpg", ".jpeg"):
                p = os.path.join(frames_dir, rec["id"] + ext)
                if os.path.exists(p):
                    refs.append(load_reference_frame(p, image_arr.shape[1:3]))
                    break
        timings["load_reference_frames_s"] = round(time.perf_counter() - t_phase, 2)
        if len(refs) >= 2 and vision is not None:
            t_phase = time.perf_counter()
            f_gen = M.batched_features(image_arr, clip_features, batch_size=16)
            f_ref = M.batched_features(np.stack(refs), clip_features, batch_size=16)
            summary["frechet_clip_vision"] = M.frechet_distance(f_gen, f_ref)
            summary["kid_clip_vision"] = M.kid_from_features(f_gen, f_ref, seed=seed)
            timings["clip_vision_frechet_s"] = round(time.perf_counter() - t_phase, 2)
        if inception is not None:
            t_phase = time.perf_counter()
            summary["fid_variant"] = fid_variant
            if len(refs) >= 2:
                pool3 = lambda imgs: inception_out(imgs, "pool3")  # noqa: E731
                f_gen = M.batched_features(image_arr, pool3, batch_size=8)
                f_ref = M.batched_features(np.stack(refs), pool3, batch_size=8)
                summary["fid"] = M.frechet_distance(f_gen, f_ref)
                summary["kid"] = M.kid_from_features(f_gen, f_ref, seed=seed)
            logits = M.batched_features(image_arr, lambda imgs: inception_out(imgs, "logits"),
                                        batch_size=8)
            ex = np.exp(logits - logits.max(-1, keepdims=True))
            summary["inception_score"] = M.inception_score(ex / ex.sum(-1, keepdims=True))
            timings["inception_metrics_s"] = round(time.perf_counter() - t_phase, 2)

    return {
        "config": {"num_steps": num_steps, "seed": seed, "n": n, "shard": bool(shard)},
        "timings": timings,
        "samples": records,
        "summary": summary,
        "image_stats": M.image_stats(image_arr) if n else {},
        "tokenizer_fallback": bool(getattr(tok, "fallback", False)),
        "roberta_fallback": bool(getattr(rtok, "fallback", False)),
        "clap_text_random_init": bool(clap_text_random),
    }
