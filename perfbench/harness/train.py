"""The training driver: stage-2 micro-steps back to back through
``train/stages.py::train_step``, fed as ``run_stage`` feeds it (a batch
dict of waveforms, captions and latents through ``EmbeddingFrontend``),
the optimizer applying an update every ``grad_accum`` micro-steps.

Set-up builds one training state from the seed's weights and drives it
through its first ``checked_steps`` micro-steps, on rows that all differ,
keeping what the check compares: each step's loss, the first gradient as
the optimizer holds it after one step (its accumulator), and the trainable
leaves after the checked steps. The window goes on with that same state.
After the window the reference follows the checked steps from the same
weights, batches and generator seed (``check_training``)."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import traffic as T
from perfbench.harness.common import device_info, log, namespace
from perfbench.harness.spans import span, wrap
from perfbench.harness.weights import draw_weights

TOWERS = ("clap_audio", "clip_text", "hierarchical", "unet")


class Feed:
    """A pool of distinct micro-batches drawn at set-up; micro-step ``i``
    takes pool entry ``i % pool``."""

    def __init__(self, spec: Dict, cfg_ns, seed: int):
        b, pool = spec["batch"], spec["pool"]
        audio = dict(spec["audio"], pool=b * pool, pcm16=False)
        prompts = dict(spec["prompts"], pool=b * pool)
        lat = cfg_ns.diffusion.image_size // 8
        self.b, self.pool = b, pool
        self.wavs = T.waveforms(audio, seed)
        self.captions = T.prompts(prompts, seed)
        self.latents = T.latents(seed, b * pool, (lat, lat, cfg_ns.diffusion.vae.latent_channels))

    def batch(self, i: int) -> Dict:
        r = slice((i % self.pool) * self.b, (i % self.pool + 1) * self.b)
        return {"audio": self.wavs[r], "caption": self.captions[r], "latent": self.latents[r]}


def generator_seed(seed: int) -> int:
    return int(T.rng(seed, 8).integers(0, 2**62))


def stage2(cell: Dict, args, device, t_process: float, trace: bool) -> Dict:
    from clap2diffusion_tpu_torch.core.config import Config, from_dict
    from clap2diffusion_tpu_torch.parallel.sharding import make_train_mesh
    from clap2diffusion_tpu_torch.train.stages import BATCH_KEYS, train_step
    from clap2diffusion_tpu_torch.train.trainer import EmbeddingFrontend, stage_state

    cfg_file, spec = cell["config"], cell["traffic"]
    ns = namespace(cfg_file["model"])
    cfg = from_dict(Config, cfg_file["model"])
    feed = Feed(spec, ns, args.seed)
    w = draw_weights(ns, args.seed, TOWERS, torch.float32, device)
    st, state, _ = stage_state(cfg, 2, w, make_train_mesh(1), device, args.seed)
    frontend = EmbeddingFrontend(cfg, w, device=device)
    del w
    gc.collect()
    keys = BATCH_KEYS[2]
    generator = torch.Generator(device=device).manual_seed(generator_seed(args.seed))
    wrap(state.opt, "step", "optimizer")
    wrap(st, "loss", "loss_forward")

    def micro(i: int):
        with span("feed"):
            emb = frontend.embed_batch(feed.batch(i))
        with span("train_step"):
            return train_step(st, state, {k: emb[k] for k in keys}, generator)

    k = spec["checked_steps"]
    p0 = {n: t.detach().clone() for n, t in state.trainable_leaves().items()}
    losses, grad1 = [], None
    for i in range(k):
        losses.append(float(micro(i)["total"]))
        if i == 0:
            grad1 = {n: a.detach().clone() for n, a in state.opt.acc.items()}
    pk = {n: t.detach().clone() for n, t in state.trainable_leaves().items()}
    ema = {n: t.detach().clone() for n, t in state.ema.items()}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    seconds = spec["trace_seconds"] if trace else args.seconds
    prof = None
    if trace:
        from perfbench.harness.reduce import profile

        prof = profile()
        prof.start()
    steps, step_s = k, []
    # the host's pace: CPU seconds of the main thread (the forward; autograd's
    # device thread runs the backward) and of the process, each step's seconds
    gc0 = [g["collections"] for g in gc.get_stats()]
    t0 = time.perf_counter()
    cpu0, proc0 = time.thread_time(), time.process_time()
    setup_s = t0 - t_process
    with span("window"):
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            micro(steps)
            step_s.append(time.perf_counter() - ts)
            steps += 1
        sync()
    t1 = time.perf_counter()
    log(phase="host", main_thread_cpu_s=time.thread_time() - cpu0,
        process_cpu_s=time.process_time() - proc0,
        step_s_quartiles=np.quantile(step_s, [0.25, 0.5, 0.75]).tolist(),
        step_s_max=max(step_s), step_s_half_medians=[float(np.median(h)) for h in
                                                     np.array_split(step_s, 2)],
        gc_collections=[g["collections"] - c for g, c in zip(gc.get_stats(), gc0)])
    if prof is not None:
        prof.stop()
    dev = device_info(torch, device)
    n = steps - k
    log(phase="window", micro_steps=n, samples=n * feed.b, window_s=t1 - t0, setup_s=setup_s,
        checked_losses=losses)
    del st, state, frontend, micro
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    program = {"losses": losses, "grad1": grad1, "p0": p0, "pk": pk, "ema": ema}
    return {
        "attempted": n * feed.b, "failed": 0, "device": dev,
        "e2e": {"train_samples_per_s": n * feed.b / (t1 - t0), "setup_s": setup_s},
        "ctx": {"window_s": t1 - t0, "micro_steps": n, "batch": feed.b, "prof": prof},
        "checks": check_training(cfg_file, args.seed, feed, k, program, device),
    }


def median_reached(norms: Dict[str, float]) -> float:
    """The median of the leaves' norms over the leaves that are not exactly
    zero: the stage-2 loss reaches no projector leaf, and those many zeros
    would make the median leaf zero."""
    nonzero = [v for v in norms.values() if v > 0]
    return float(np.median(nonzero)) if nonzero else 0.0


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: List[str]) -> Dict:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and the median leaf's norm."""
    pn = {n: float(torch.linalg.vector_norm(prog[n].float())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    med = median_reached(rn)
    gaps = {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return {"value": gaps[worst], "leaf": worst, "median_norm": med}


def reference_run(cfg_file: Dict, seed: int, feed: Feed, k: int, device, precision=None):
    """The reference's ``k`` micro-steps from the seed's weights: losses,
    the first step's gradients, the trainable leaves before and after, and
    the EMA."""
    from perfbench.harness.check import fp32
    from perfbench.reference.pipeline import Reference, Stage2
    from perfbench.reference.tokenizer import CLIPTokenizer

    ns = namespace(cfg_file["model"])
    tok = CLIPTokenizer(max_length=ns.diffusion.clip_text.max_length)
    with fp32(precision):
        w = draw_weights(ns, seed, TOWERS, torch.float32, device)
        ref = Reference(ns, w, device, TOWERS)
        del w
        s2 = Stage2(ref, ns.train.stage2)
        p0 = {n: t.detach().clone() for n, t in s2.train.items()}
        gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
        losses, grad1 = [], None
        for i in range(k):
            b = feed.batch(i)
            out = s2.micro_step(b["audio"], tok(list(b["caption"])),
                                torch.as_tensor(b["latent"], device=device), gen)
            losses.append(out["loss"])
            if i == 0:
                grad1 = out["grads"]
        res = {"losses": losses, "grad1": grad1, "p0": p0,
               "pk": {n: t.detach().clone() for n, t in s2.train.items()}, "ema": s2.ema}
        del s2, ref
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return res


def readings(program: Dict, ref: Dict) -> Dict:
    names = sorted(ref["grad1"])
    if sorted(program["grad1"]) != names:
        raise ValueError("the program's trainable leaves are not the reference's")
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(program["losses"], ref["losses"]))
    grad = leaf_gap(program["grad1"], ref["grad1"], names)
    gnorm = {n: float(torch.linalg.vector_norm(ref["grad1"][n])) for n in names}
    floor = 1e-3 * median_reached(gnorm)
    moved = [n for n in names if gnorm[n] > 0 and gnorm[n] >= floor]
    dp = {n: program["pk"][n] - program["p0"][n] for n in moved}
    dr = {n: ref["pk"][n] - ref["p0"][n] for n in moved}
    change = leaf_gap(dp, dr, moved)
    de_p = {n: program["ema"][n] - program["p0"][n] for n in moved}
    de_r = {n: ref["ema"][n] - ref["p0"][n] for n in moved}
    ema = leaf_gap(de_p, de_r, moved)
    return {"loss_rel_gap": loss_gap, "grad_norm_gap": grad["value"],
            "grad_worst_leaf": grad["leaf"], "change_norm_gap": change["value"],
            "change_worst_leaf": change["leaf"], "change_median_norm": change["median_norm"],
            "ema_change_norm_gap": ema["value"], "ema_change_median_norm": ema["median_norm"],
            "leaves": len(names), "leaves_compared_in_change": len(moved),
            "losses_program": program["losses"], "losses_reference": ref["losses"]}


def check_training(cfg_file: Dict, seed: int, feed: Feed, k: int, program: Dict,
                   device) -> List[Dict]:
    t0 = time.perf_counter()
    ref = reference_run(cfg_file, seed, feed, k, device)
    r = readings(program, ref)
    log(phase="check", reference_s=time.perf_counter() - t0, **r)
    lim = cfg_file["limits"]
    return [{"name": n, "value": r[n], "limit": lim[n], "ok": bool(r[n] <= lim[n])}
            for n in ("loss_rel_gap", "grad_norm_gap", "change_norm_gap", "ema_change_norm_gap")]
