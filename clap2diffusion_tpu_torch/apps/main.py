"""Command line (port of ``clap2diffusion_tpu/apps/main.py``): infer,
train, evaluate, export, serve, app and prepare.

    python -m clap2diffusion_tpu_torch.apps.main infer --audio x.wav --text "..." \
        --output out.png [--checkpoint DIR] [--steps 50 --cfg 7.5 --seed 0 --norm 60] \
        [--best-of N]
    python -m clap2diffusion_tpu_torch.apps.main evaluate --data-root data/audiocaps \
        [--checkpoint DIR] [--stage-checkpoint DIR --ema] [--fid-variant pytorch_fid]
    python -m clap2diffusion_tpu_torch.apps.main train --stage 2 --data-root data/audiocaps \
        [--coordinator HOST:PORT --num-processes N --process-id I]
    python -m clap2diffusion_tpu_torch.apps.main export \
        --stage-checkpoint checkpoints/stage2_final --out hierarchical.pth [--ema]
    python -m clap2diffusion_tpu_torch.apps.main serve --checkpoint DIR --port 7860
    python -m clap2diffusion_tpu_torch.apps.main prepare --csv audiocaps.csv \
        --audio-dir raw/ --out data/audiocaps [--encode-latents --frames-dir frames/]
    python -m clap2diffusion_tpu_torch.apps.main prepare --create-sample --out data/fixture

Models run on CUDA unless ``--device cpu``; nothing falls back to the CPU
on its own. ``--config`` and ``--set`` need PyYAML; without them the
defaults (full SD v1.5 width) apply. PNG files are written without Pillow;
another image extension, ``--init-image`` and ``--mask-image`` need it.
``infer --best-of N`` and ``evaluate``'s CLIPScore and Frechet metrics need
the towers the converter's ``--clip-vision`` / ``--inception`` slots add to
a checkpoint.

Several cards: start one ``train`` process per card with the same
``--coordinator`` and ``--num-processes`` and its own ``--process-id`` (or
the ``C2D_COORDINATOR`` / ``C2D_NUM_PROCESSES`` / ``C2D_PROCESS_ID``
variables, or ``C2D_AUTO_DIST=1`` under torchrun); ``evaluate --shard``
reads the same variables and fans the generation out over the processes.
``prepare --encode-latents`` encodes the frames with the VAE on the card
(``--device cpu`` for the CPU), with random VAE weights, as the JAX CLI
does. ``C2D_INT8=1`` serves through the W8A8 UNet (``ops/quant.py``; ``train``
refuses it) and ``C2D_INT8_WIRE=1`` loads ``--checkpoint`` over the int8
weight wire (``utils/wire.py``), as in the JAX package.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

SAMPLERS = ["ddim", "dpmpp_2m", "dpmpp_2m_karras", "euler_a"]


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML config path (needs PyYAML)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="dot-path config override, e.g. train.stage1.lr=3e-4 (needs PyYAML)")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")


def _load_cfg(args):
    from clap2diffusion_tpu_torch.core.config import load_config

    return load_config(args.config, args.overrides)


def save_image(path: str, img: np.ndarray) -> None:
    """A uint8 image to ``path``: PNG with the standard library, any other
    extension through Pillow."""
    if path.lower().endswith(".png"):
        from clap2diffusion_tpu_torch.utils.png import encode_png

        with open(path, "wb") as f:
            f.write(encode_png(np.asarray(img)))
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"writing {path} needs Pillow (PIL); a .png output does not") from e
    Image.fromarray(np.asarray(img)).save(path)


def _merge_stage(pipeline_params, stage_ckpt: str, use_ema: bool, dtype: str):
    """Fold a ``run_stage`` checkpoint (its weights or their EMA shadow)
    into the pipeline's per-tower state dicts."""
    import torch

    from clap2diffusion_tpu_torch.train.checkpoint import (
        load_payload,
        merge_stage_params,
        stage_from_name,
    )

    path = os.path.abspath(stage_ckpt)
    payload = load_payload(os.path.dirname(path), os.path.basename(path))
    return merge_stage_params(pipeline_params, payload, stage_from_name(os.path.basename(path)),
                              use_ema=use_ema, dtype=getattr(torch, dtype))


def cmd_infer(args) -> int:
    from clap2diffusion_tpu_torch.core.dtypes import DTypePolicy
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, load_pipeline
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    cfg = _load_cfg(args)
    dtype = DTypePolicy.from_strings("float32", args.dtype).compute_dtype
    if args.checkpoint:
        pipe = load_pipeline(cfg, args.checkpoint, dtype=dtype, device=args.device)
    else:
        pipe = AudioToImagePipeline(cfg, seed=args.seed, dtype=dtype, device=args.device)
    if args.stage_checkpoint:
        merged = _merge_stage(pipe.params, args.stage_checkpoint, args.ema, args.dtype)
        pipe = AudioToImagePipeline(cfg, params=merged, device=args.device)
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    shared = dict(text_ids=tok(args.text or ""), uncond_ids=tok(args.negative_text or ""),
                  num_steps=args.steps, guidance_scale=args.cfg,
                  guidance_rescale=args.cfg_rescale, norm_target=args.norm,
                  model_type=args.model_type, seed=args.seed, sampler=args.sampler)

    if args.audio_dir:
        # pipelined: the next file's upload and dispatch overlap the card's
        # work on the one before; service = a request's dispatch -> fetch,
        # throughput = images / wall time
        wavs = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
        reqs = ({"waveform": pipe.load_audio(p)} for p in wavs)
        t_wall = time.perf_counter()
        n_done = 0
        for path, (img, service_s) in zip(wavs, pipe.generate_stream_timed(reqs, **shared)):
            stem = os.path.splitext(os.path.basename(path))[0]
            out = args.output.replace(".png", f"_{stem}.png")
            save_image(out, img[0])
            n_done += 1
            print(f"wrote {out} (service {service_s:.3f}s)")
        wall = time.perf_counter() - t_wall
        if n_done:
            print(f"throughput: {n_done / wall:.3f} img/s ({n_done} images in {wall:.2f}s)")
        return 0

    # the mask is decoded whether or not there is an init image, so that the
    # pipeline's "mask_image requires init_image" surfaces
    init = pipe.load_init_image(args.init_image) if args.init_image else None
    mask = pipe.load_init_image(args.mask_image, mask=True) if args.mask_image else None
    if args.best_of > 1:
        if not args.text:
            raise SystemExit("--best-of ranks candidates by CLIPScore against the prompt; "
                             "--text is required")
        if args.batch != 1:
            raise SystemExit("--best-of already batches candidates; --batch must stay 1")
        if args.init_image or args.mask_image:
            raise SystemExit("--best-of is unsupported with --init-image/--mask-image "
                             "(candidates need per-lane seeds)")
        img, scores = pipe.generate_best_of(
            args.best_of, waveform=pipe.load_audio(args.audio) if args.audio else None,
            waveform2=pipe.load_audio(args.audio2) if args.audio2 else None,
            audio_mix=args.audio_mix, **shared)
        save_image(args.output, img)
        print(f"wrote {args.output} (best of {args.best_of}; clip_scores="
              f"{[round(float(s), 3) for s in scores]})")
        return 0
    images = pipe.generate(
        waveform=pipe.load_audio(args.audio) if args.audio else None,
        batch=args.batch, init_image=init, strength=args.strength,
        waveform2=pipe.load_audio(args.audio2) if args.audio2 else None,
        audio_mix=args.audio_mix, mask_image=mask, **shared)
    for i, img in enumerate(images):
        out = args.output if args.batch == 1 else args.output.replace(".png", f"_{i}.png")
        save_image(out, img)
        print(f"wrote {out}")
    return 0


def cmd_train(args) -> int:
    from clap2diffusion_tpu_torch.diffusion.pipeline import init_params
    from clap2diffusion_tpu_torch.train.trainer import run_stage

    from clap2diffusion_tpu_torch.parallel.distributed import initialize_distributed

    # join the process group before anything touches the card: it picks
    # this rank's card (a no-op without a coordinator)
    initialize_distributed(coordinator=args.coordinator, num_processes=args.num_processes,
                           process_id=args.process_id, device=args.device)
    cfg = _load_cfg(args)
    params = init_params(cfg, seed=cfg.train.seed, device=args.device)
    run_stage(cfg, args.stage, params, data_root=args.data_root, max_steps=args.max_steps,
              checkpoint_dir=args.checkpoint_dir or cfg.train.checkpoint_dir,
              log_dir=cfg.train.log_dir, resume_from=args.restore, device=args.device)
    return 0


def cmd_evaluate(args) -> int:
    from clap2diffusion_tpu_torch.eval.evaluate import run_evaluation

    if args.shard:
        from clap2diffusion_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(device=args.device)
    cfg = _load_cfg(args)
    params = None
    if args.checkpoint:
        from clap2diffusion_tpu_torch.diffusion.pipeline import load_pipeline

        params = load_pipeline(cfg, args.checkpoint, device=args.device).params
    if args.stage_checkpoint:
        from clap2diffusion_tpu_torch.diffusion.pipeline import init_params

        base = params if params is not None else init_params(cfg, seed=args.seed,
                                                             device=args.device)
        params = _merge_stage(base, args.stage_checkpoint, args.ema, "float32")
    results = run_evaluation(cfg, data_root=args.data_root, max_samples=args.max_samples,
                             num_steps=args.steps, seed=args.seed, params=params,
                             sampler=args.sampler, shard=args.shard,
                             fid_variant=args.fid_variant, device=args.device)
    from clap2diffusion_tpu_torch.parallel.distributed import is_coordinator

    if not is_coordinator():  # every rank computes the results; one writes them
        return 0
    out = args.output or "evaluation_results.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results.get("summary", {}), indent=2))
    print(f"wrote {out}")
    return 0


def cmd_prepare(args) -> int:
    if args.create_sample:
        from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset

        meta = make_fixture_dataset(args.out, n_train=args.n_train, n_val=args.n_val,
                                    n_test=args.n_test)
        print(f"fixture dataset: {len(meta['samples'])} samples at {args.out}")
        return 0
    from clap2diffusion_tpu_torch.data.prepare import encode_latents, prepare_audiocaps

    if args.csv:
        meta = prepare_audiocaps(args.csv, args.audio_dir, args.out)
        print(f"prepared {len(meta['samples'])} samples")
    if args.encode_latents:
        n = encode_latents(args.out, frames_dir=args.frames_dir, device=args.device)
        print(f"encoded {n} latents")
    return 0


def cmd_app(args) -> int:
    from clap2diffusion_tpu_torch.apps.gradio_app import launch

    launch(_load_cfg(args), host=args.host, port=args.port, device=args.device)
    return 0


def cmd_serve(args) -> int:
    from clap2diffusion_tpu_torch.apps.server import load_service, serve

    server = serve(service=load_service(args), host=args.host, port=args.port)
    print(f"serving on {args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


def cmd_export(args) -> int:
    """Trained conditioning weights -> the reference's formats: ``.safetensors``
    flat (names prefixed ``hierarchical.`` / ``adapter.`` / ``unet_adapter.``),
    anything else the reference's nested ``.pth`` (``*_state_dict``
    sections and ``step``)."""
    import torch

    from clap2diffusion_tpu_torch.models.condition.export import (
        export_audio_adapter,
        export_hierarchical_encoder,
        export_injection_processors,
    )
    from clap2diffusion_tpu_torch.train.checkpoint import (
        load_payload,
        merge_stage_params,
        stage_from_name,
    )

    path = os.path.abspath(args.stage_checkpoint)
    payload = load_payload(os.path.dirname(path), os.path.basename(path))
    stage = stage_from_name(os.path.basename(path))
    # an empty base: only the stage's trained towers survive the merge (the
    # UNet body is not in the reference's formats, its injection branches are)
    merged = merge_stage_params({}, payload, stage, use_ema=args.ema)
    sections = {}
    if "adapter" in merged:
        sections["adapter_state_dict"] = export_audio_adapter(merged["adapter"])
    if "hierarchical" in merged:
        sections["hierarchical_state_dict"] = export_hierarchical_encoder(merged["hierarchical"])
    proc = export_injection_processors(merged["unet"]) if "unet" in merged else {}
    if proc:
        sections["unet_adapter_state_dict"] = proc
    if not sections:
        raise SystemExit("checkpoint holds no exportable conditioning towers")
    if args.out.endswith(".safetensors"):
        from clap2diffusion_tpu_torch.utils.safetensors_io import save_safetensors

        flat = {f"{sec.removesuffix('_state_dict')}.{k}": v
                for sec, tensors in sections.items() for k, v in tensors.items()}
        save_safetensors(args.out, flat,
                         metadata={"format": "clap2diffusion_tpu", "stage": str(stage)})
    else:
        torch.save({"step": int(payload.get("step", 0)), **sections}, args.out)
    n = sum(len(t) for t in sections.values())
    print(f"exported stage {stage} -> {args.out} ({n} tensors, sections: {sorted(sections)})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clap2diffusion_tpu_torch.apps.main")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("infer", help="audio+text -> image")
    pi.add_argument("--audio", default=None)
    pi.add_argument("--audio-dir", default=None,
                    help="run every .wav in this directory, pipelined")
    pi.add_argument("--text", default=None)
    pi.add_argument("--negative-text", default=None,
                    help="negative prompt (the CFG unconditional context; default: empty)")
    pi.add_argument("--output", default="output.png")
    pi.add_argument("--steps", type=int, default=50)
    pi.add_argument("--cfg", type=float, default=7.5)
    pi.add_argument("--cfg-rescale", type=float, default=0.0,
                    help="CFG-rescale weight 0..1 (0 = plain CFG)")
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--norm", type=float, default=60.0)
    pi.add_argument("--batch", type=int, default=1)
    pi.add_argument("--best-of", dest="best_of", type=int, default=1,
                    help="generate N candidates (one batched request, per-lane seeds "
                         "seed..seed+N-1), rank them by CLIPScore against --text on the card "
                         "and save the winner; needs a checkpoint with the CLIP vision towers "
                         "(the converter's --clip-vision)")
    pi.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="compute type of the towers that compute in the parameter type")
    pi.add_argument("--checkpoint", default=None,
                    help="pipeline checkpoint (save_pipeline / tools.convert_checkpoints)")
    pi.add_argument("--sampler", default=None, choices=SAMPLERS,
                    help="sampling algorithm (default: the config's)")
    pi.add_argument("--model-type", default="hierarchical",
                    choices=["hierarchical", "sonic", "baseline", "audio_tokens"])
    pi.add_argument("--init-image", default=None, help="img2img init image (needs Pillow)")
    pi.add_argument("--strength", type=float, default=0.8,
                    help="img2img strength in (0, 1]; lower keeps more of --init-image")
    pi.add_argument("--mask-image", default=None,
                    help="inpainting mask (grey; nonzero = regenerate; needs --init-image and "
                         "Pillow)")
    pi.add_argument("--audio2", default=None, help="second audio source, blended with --audio")
    pi.add_argument("--audio-mix", type=float, default=0.5,
                    help="blend weight of --audio when --audio2 is given")
    pi.add_argument("--stage-checkpoint", default=None,
                    help="run_stage checkpoint (e.g. checkpoints/stage3_final) to fold in")
    pi.add_argument("--ema", action="store_true",
                    help="use the stage checkpoint's EMA shadow weights")
    _add_common(pi)
    _add_device(pi)
    pi.set_defaults(fn=cmd_infer)

    pt = sub.add_parser("train", help="run a training stage")
    pt.add_argument("--stage", type=int, required=True, choices=[1, 2, 3])
    pt.add_argument("--data-root", default=None)
    pt.add_argument("--max-steps", type=int, default=None)
    pt.add_argument("--checkpoint-dir", default=None)
    pt.add_argument("--restore", default=None,
                    help="checkpoint name in checkpoint-dir to resume from")
    pt.add_argument("--coordinator", default=None,
                    help="several processes (one per card): the coordinator's host:port")
    pt.add_argument("--num-processes", type=int, default=None,
                    help="several processes: how many")
    pt.add_argument("--process-id", type=int, default=None,
                    help="several processes: this one's rank, 0 .. N-1")
    _add_common(pt)
    _add_device(pt)
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("evaluate", help="generate over the test split and compute the "
                                         "metrics (JSON)")
    pe.add_argument("--data-root", default=None)
    pe.add_argument("--max-samples", type=int, default=8)
    pe.add_argument("--steps", type=int, default=50)
    pe.add_argument("--sampler", default=None, choices=SAMPLERS)
    pe.add_argument("--seed", type=int, default=42)
    pe.add_argument("--shard", action="store_true",
                    help="fan the generation out over the job's processes (C2D_COORDINATOR, "
                         "C2D_NUM_PROCESSES, C2D_PROCESS_ID; one process is a job of one)")
    pe.add_argument("--fid-variant", default="torchvision", choices=["torchvision", "pytorch_fid"])
    pe.add_argument("--output", default=None)
    pe.add_argument("--checkpoint", default=None)
    pe.add_argument("--stage-checkpoint", default=None)
    pe.add_argument("--ema", action="store_true")
    _add_common(pe)
    _add_device(pe)
    pe.set_defaults(fn=cmd_evaluate)

    pp = sub.add_parser("prepare", help="AudioCaps CSV -> training data, frames -> latents, "
                                        "or fixture data (--create-sample)")
    pp.add_argument("--csv", default=None,
                    help="AudioCaps CSV (youtube_id, caption): the sources under --audio-dir "
                         "become 48 kHz WAVs with an 80/10/10 split")
    pp.add_argument("--audio-dir", default=None)
    pp.add_argument("--out", default="data/audiocaps")
    pp.add_argument("--frames-dir", default=None)
    pp.add_argument("--encode-latents", action="store_true",
                    help="encode the frames (--frames-dir, default <out>/frames) to "
                         "<out>/latents/{id}.npy with the VAE encoder, on the card; the VAE "
                         "weights are random (seed 0), as in the JAX CLI")
    pp.add_argument("--create-sample", action="store_true")
    pp.add_argument("--n-train", type=int, default=5)
    pp.add_argument("--n-val", type=int, default=2)
    pp.add_argument("--n-test", type=int, default=1)
    _add_common(pp)
    _add_device(pp)
    pp.set_defaults(fn=cmd_prepare)

    ps = sub.add_parser("serve", help="the standard-library HTTP server (/generate, "
                                      "/generate_batch, /healthz, /metrics)")
    _add_common(ps)
    _add_device(ps)
    ps.add_argument("--host", default="0.0.0.0")
    ps.add_argument("--port", type=int, default=7860)
    ps.add_argument("--checkpoint", default=None, help="pipeline checkpoint")
    ps.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ps.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="micro-batch concurrent same-knob /generate requests (0 = off)")
    ps.add_argument("--coalesce-max-batch", type=int, default=8)
    ps.set_defaults(fn=cmd_serve)

    px = sub.add_parser("export", help="trained conditioning weights -> the reference's "
                                       "formats (.pth / .safetensors)")
    px.add_argument("--stage-checkpoint", required=True,
                    help="run_stage checkpoint directory (stageN_final / stageN_stepK)")
    px.add_argument("--out", required=True,
                    help=".safetensors (flat names) or .pth (the reference's nested layout)")
    px.add_argument("--ema", action="store_true", help="export the EMA shadow weights")
    _add_common(px)
    px.set_defaults(fn=cmd_export)

    pa = sub.add_parser("app", help="the gradio UI (needs gradio)")
    pa.add_argument("--host", default="0.0.0.0")
    pa.add_argument("--port", type=int, default=7860)
    _add_common(pa)
    _add_device(pa)
    pa.set_defaults(fn=cmd_app)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
