"""The whole training lifecycle of the port, end to end (counterpart of
``tools/run_lifecycle.py``).

    python -m clap2diffusion_tpu_torch.tools.run_lifecycle [--scale 1.0] \
        [--skip-eval] [--resume] [--root DIR]

The chain, on the card, at the reference's budgets times ``--scale``
(stages 1-3: 3,000, 2,000 and 1,000 micro-steps; never fewer than a
stage's ``steps_per_call``):

1. prepare: a fixture dataset at the configuration's geometry (256 train,
   16 val and 16 test samples of ``data.duration_s`` audio), a reference
   frame per sample at the image size, the VAE latents encoded from them on
   the card (``data/prepare.py::encode_latents``), and the frozen towers'
   embeddings (``tools/precompute_embeddings.py``); the fp32 weights from
   ``cached_init_params`` (seed ``train.seed``, cached under the root);
2-4. stages 1, 2 and 3 through ``run_stage``, each started from the one
   before through ``merge_stage_params`` (its live weights);
5. export: ``stage3_final`` in the reference's ``.pth`` layout
   (``apps.main export``);
6. serve: two images of the test split from the trained chain (stage 3's
   EMA weights, bf16);
7. evaluate (unless ``--skip-eval``): ``run_evaluation`` on 16 test
   samples with random CLIP vision, text-projection and Inception v3
   towers, in both FID variants and sharded.

``--resume`` takes a stage whose ``stage{N}_final`` already reached this
run's budget from disk instead of training it, and reuses the dataset.
Writes ``lifecycle_summary.json`` and per-stage JSONL logs under the root
(``.cache/lifecycle`` beside the package by default) and prints the wall
time of each phase. ``main`` builds ``Config()`` with periodic checkpoints
off and calls ``run``, which takes any configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES: List[Dict] = []


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)
    PHASES.append({"phase": name, "t0": time.perf_counter()})


def phase_done(**extra) -> None:
    p = PHASES[-1]
    p["wall_s"] = round(time.perf_counter() - p.pop("t0"), 1)
    p.update(extra)
    print(f"--- {p['phase']}: {p['wall_s']}s "
          f"{ {k: v for k, v in p.items() if k not in ('phase', 'wall_s')} }", flush=True)


def loss_curve(log_path: str) -> dict:
    """First and last train and val losses of a stage's JSONL log. Runs
    appended to one file (a smoke run, a preempted re-run) are split where
    the step decreases, and the run that reached the highest step is
    summarised."""
    with open(log_path) as f:
        rows = [json.loads(line) for line in f]
    runs: list = [[]]
    last_step = -1
    for r in rows:
        if r.get("step", 0) < last_step:
            runs.append([])
        runs[-1].append(r)
        last_step = r.get("step", 0)
    budget_run = max(runs, key=lambda rr: max((r.get("step", 0) for r in rr), default=-1))
    train = [r for r in budget_run if "total" in r]
    val = [r for r in budget_run if "val_total" in r]
    out = {}
    if train:
        out["first_total"] = round(train[0]["total"], 4)
        out["last_total"] = round(train[-1]["total"], 4)
        out["steps_per_s_last"] = round(train[-1].get("steps_per_s", 0), 2)
    if val:
        out["val_first"] = round(val[0]["val_total"], 4)
        out["val_last"] = round(val[-1]["val_total"], 4)
    return out


def reference_frame(k: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """A structured frame, distinct per sample (FID needs reference
    statistics that are not degenerate): two sinusoids and noise."""
    yy, xx = np.mgrid[0:size, 0:size]
    return np.stack([127 + 120 * np.sin(2 * np.pi * (k % 7 + 1) * xx / size),
                     127 + 120 * np.sin(2 * np.pi * (k % 5 + 1) * yy / size),
                     rng.integers(0, 255, (size, size))], axis=-1).clip(0, 255).astype(np.uint8)


def _random_tower(module, seed: int, device) -> Dict[str, torch.Tensor]:
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.diffusion.pipeline import _special_init, random_init_

    module.to_empty(device=device)
    random_init_(module, torch.Generator(device=device).manual_seed(seed), _special_init(Config()))
    return {k: v.detach() for k, v in module.state_dict().items()}


def run(cfg, root: str, scale: float = 1.0, skip_eval: bool = False, resume: bool = False,
        device=None, n_train: int = 256, n_val: int = 16, n_test: int = 16) -> Dict:
    """The lifecycle of ``cfg`` under ``root``; returns the summary it writes
    to ``root/lifecycle_summary.json``."""
    from clap2diffusion_tpu_torch.apps.main import main as cli_main
    from clap2diffusion_tpu_torch.apps.main import save_image
    from clap2diffusion_tpu_torch.core.device import resolve_device
    from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
    from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset
    from clap2diffusion_tpu_torch.data.prepare import encode_latents
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, cached_init_params
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
    from clap2diffusion_tpu_torch.tools.precompute_embeddings import precompute
    from clap2diffusion_tpu_torch.train.checkpoint import load_payload, merge_stage_params
    from clap2diffusion_tpu_torch.train.trainer import run_stage
    from clap2diffusion_tpu_torch.utils.png import encode_png

    dev = resolve_device(device)
    PHASES.clear()
    ds, ckpt = os.path.join(root, "ds"), os.path.join(root, "ckpt")
    logs, outdir = os.path.join(root, "logs"), os.path.join(root, "out")
    for d in (root, ckpt, logs, outdir):
        os.makedirs(d, exist_ok=True)
    budgets = {s: max(int(getattr(cfg.train, f"stage{s}").steps * scale),
                      getattr(cfg.train, f"stage{s}").steps_per_call) for s in (1, 2, 3)}
    print(f"device: {dev}; budgets: {budgets} (scale {scale})", flush=True)

    # -- 1. prepare ----------------------------------------------------------------
    phase("prepare: fixture dataset")
    rng = np.random.default_rng(0)
    n_made = 0
    if not os.path.exists(os.path.join(ds, "metadata_unified.json")):
        size = cfg.diffusion.image_size
        meta = make_fixture_dataset(ds, n_train=n_train, n_val=n_val, n_test=n_test,
                                    duration_s=cfg.data.duration_s,
                                    sample_rate=cfg.data.sample_rate, latent_hw=size // 8)
        frames = os.path.join(ds, "frames")
        os.makedirs(frames, exist_ok=True)
        for s in meta["samples"]:
            with open(os.path.join(frames, f"{s['id']}.png"), "wb") as f:
                f.write(encode_png(reference_frame(int(s["id"].split("_")[1]), size, rng)))
        n_made = len(meta["samples"])
    phase_done(samples=n_made or "cached")

    phase("prepare: params (cached init)")
    params = cached_init_params(cfg, seed=cfg.train.seed, dtype=torch.float32,
                                cache_dir=os.path.join(root, "params"), device=dev)
    phase_done()

    phase("prepare: VAE latent precompute (device)")
    n_lat = (encode_latents(ds, vae_params=params["vae"], vae_cfg=cfg.diffusion.vae,
                            image_size=cfg.diffusion.image_size, device=dev)
             if n_made else "cached")
    phase_done(latents=n_lat)

    phase("prepare: embedding precompute (device)")
    n_emb = precompute(cfg, params, ds, device=dev) if n_made else "cached"
    phase_done(embeddings=n_emb)

    # -- 2-4. the three stages, chained ----------------------------------------------
    stage_summaries = {}
    for stage in (1, 2, 3):
        payload, restore_s = None, 0.0
        if resume:
            t_r = time.perf_counter()
            try:
                cand = load_payload(ckpt, f"stage{stage}_final")
                payload = cand if int(cand["step"]) == budgets[stage] else None
            except FileNotFoundError:
                payload = None
            restore_s = round(time.perf_counter() - t_r, 1)
        if payload is not None:
            phase(f"stage {stage}: {budgets[stage]} steps (resumed)")
        else:
            phase(f"stage {stage}: {budgets[stage]} steps")
            run_stage(cfg, stage, params, data_root=ds, max_steps=budgets[stage],
                      checkpoint_dir=ckpt, log_dir=logs, device=dev)
            payload = load_payload(ckpt, f"stage{stage}_final")
            if int(payload["step"]) != budgets[stage]:
                raise RuntimeError(f"stage{stage}_final stopped at {payload['step']}")
        # the next stage starts from this stage's live weights (the EMA is
        # consumed at serving time only, as in the reference)
        params = merge_stage_params(params, payload, stage)
        del payload
        curve = loss_curve(os.path.join(logs, f"stage{stage}.jsonl"))
        stage_summaries[f"stage{stage}"] = curve
        phase_done(**(dict(curve, restore_s=restore_s) if restore_s else curve))

    # -- 5. export to the reference's format -----------------------------------------
    phase("export: stage3_final -> reference .pth")
    pth = os.path.join(outdir, "stage3_final.pth")
    if cli_main(["export", "--stage-checkpoint", os.path.join(ckpt, "stage3_final"),
                 "--out", pth]) != 0 or not os.path.exists(pth):
        raise RuntimeError("export of stage3_final failed")
    phase_done(bytes=os.path.getsize(pth))

    # -- 6. serve from the trained chain (EMA weights, bf16) ------------------------
    phase("serve: images from the trained checkpoint chain")
    serve_params = merge_stage_params(params, load_payload(ckpt, "stage3_final"), 3,
                                      use_ema=True, dtype=torch.bfloat16)
    serve_params = {t: {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                        for k, v in sd.items()} for t, sd in serve_params.items()}
    pipe = AudioToImagePipeline(cfg, params=serve_params, device=dev)
    test_ds = AudioCapsLatentDataset(ds, split="test", audio_duration=cfg.data.duration_s,
                                     sample_rate=cfg.data.sample_rate,
                                     latent_hw=cfg.data.latent_shape[1])
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    serve_times = []
    for i in range(2):
        item = test_ds[i]
        t0 = time.perf_counter()
        img = pipe.generate(waveform=item["audio"], text_ids=tok(item["caption"]), seed=i)
        serve_times.append(round(time.perf_counter() - t0, 2))
        save_image(os.path.join(outdir, f"serve_{i}.png"), img[0])
    phase_done(serve_s=serve_times)

    # -- 7. evaluate, every metric path ----------------------------------------------
    eval_results = {}
    if not skip_eval:
        from clap2diffusion_tpu_torch.eval.evaluate import run_evaluation
        from clap2diffusion_tpu_torch.models.clip_vision import CLIPVisionEncoder
        from clap2diffusion_tpu_torch.models.inception_v3 import InceptionV3

        phase("evaluate: init metric towers")
        vcfg = cfg.diffusion.clip_vision
        with torch.device("meta"):
            vision, inception = CLIPVisionEncoder(vcfg), InceptionV3()
        eval_params = {**serve_params,
                       "clip_vision": _random_tower(vision, 0, dev),
                       "clip_text_projection": {"weight": torch.from_numpy(
                           (0.02 * rng.standard_normal((vcfg.projection_dim,
                                                        cfg.diffusion.clip_text.hidden_size)))
                           .astype(np.float32)).to(dev)},
                       "inception_v3": _random_tower(inception, 1, dev)}
        phase_done()
        for label, kw in (("torchvision", dict(fid_variant="torchvision")),
                          ("pytorch_fid", dict(fid_variant="pytorch_fid")),
                          ("sharded", dict(fid_variant="torchvision", shard=True))):
            phase(f"evaluate: n={n_test}, {label}")
            res = run_evaluation(cfg, data_root=ds, max_samples=n_test,
                                 num_steps=cfg.diffusion.scheduler.num_inference_steps,
                                 params=eval_params, device=dev, **kw)
            eval_results[label] = {"summary": res["summary"], "timings": res["timings"]}
            with open(os.path.join(outdir, f"eval_{label}.json"), "w") as f:
                json.dump(res, f, indent=2, default=float)
            phase_done(**{k: round(v, 3) if isinstance(v, float) else v
                          for k, v in res["summary"].items()
                          if isinstance(v, (int, float, str))})

    summary = {"budgets": budgets, "scale": scale, "phases": list(PHASES),
               "stages": stage_summaries, "eval": eval_results,
               "total_wall_s": round(sum(p["wall_s"] for p in PHASES), 1)}
    with open(os.path.join(root, "lifecycle_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    print("\n==== lifecycle summary ====")
    print(json.dumps(summary, indent=2, default=float), flush=True)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="budget scale: 1.0 the reference's, 0.01 30/20/10 micro-steps")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="take a stage whose final checkpoint reached this budget from disk")
    ap.add_argument("--root", default=os.path.join(REPO, ".cache", "lifecycle"))
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from clap2diffusion_tpu_torch.core.config import Config, apply_overrides

    args = build_parser().parse_args(argv)
    # periodic step checkpoints off (a stage-2/3 checkpoint is several GB of
    # fp32 weights and optimizer state); stage{N}_final and _best still save
    cfg = apply_overrides(Config(), [f"train.stage{s}.save_every=1000000" for s in (1, 2, 3)])
    run(cfg, os.path.abspath(args.root), args.scale, args.skip_eval, args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())
