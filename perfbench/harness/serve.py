"""The serving drivers: a closed loop into
``AudioToImagePipeline.generate`` (one client, requests back to back) and
an open loop into ``InferenceService.generate`` through its coalescer
(requests sent on their own threads at fixed due times).

Each builds the program from the configuration's file and the seed's
weights, warms up the signatures its traffic uses, and measures for the
run's seconds. Then it reads the peak memory, frees the program and holds
a sample of the served images, drawn from the seed, against the plain
reference (``check.py``)."""

from __future__ import annotations

import base64
import gc
import io
import threading
import time
import wave
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import check, traffic as T
from perfbench.harness.common import device_info, log, namespace
from perfbench.harness.spans import span
from perfbench.harness.weights import draw_weights

TOWERS = ("clap_audio", "clip_text", "hierarchical", "unet", "vae")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


class Inputs:
    """A serving mix's inputs: the waveform and prompt pools, drawn at
    set-up, and for request ``i`` (any index) its lanes' pool rows and
    seeds. The warm-up's requests take indices from ``WARMUP`` on, which no
    window reaches."""

    WARMUP = 1 << 40

    def __init__(self, spec: Dict, seed: int, per: int, max_length: int):
        from perfbench.reference.tokenizer import CLIPTokenizer

        self.wavs = T.waveforms(spec["audio"], seed)
        tok = CLIPTokenizer(max_length=max_length)
        self.prompts = T.prompts(spec["prompts"], seed)
        self.ids = tok(self.prompts)
        self.uncond = tok("")
        self.seed, self.per = seed, per
        self.wav_perm = T.rng(seed, 4).permutation(len(self.wavs))
        self.prompt_perm = T.rng(seed + 1, 4).permutation(len(self.prompts))

    def prompt_rows(self, i: int) -> np.ndarray:
        return T.lane_rows(self.prompt_perm, i, self.per)

    def request(self, i: int) -> Dict:
        return {"waveform": self.wavs[T.lane_rows(self.wav_perm, i, self.per)],
                "text_ids": self.ids[self.prompt_rows(i)],
                "uncond_ids": np.repeat(self.uncond, self.per, axis=0),
                "seeds": T.request_seeds(self.seed, i, self.per)}


def image_sample(seed: int, requests: int, batch: int, k: int) -> List[tuple]:
    """``k`` (request, lane) pairs of a closed loop's served images, drawn
    from the seed: distinct requests, and lanes in this order: the last,
    the first, then the others in a seeded order, so that three images of
    a batch of eight fall in three lanes, the two ends among them."""
    g = T.rng(seed, 7)
    lanes = [batch - 1] + ([0] if batch > 1 else [])
    lanes += [int(x) for x in g.permutation(np.arange(1, max(batch - 1, 1)))]
    picks = g.choice(requests, size=min(k, requests), replace=False)
    return [(int(r), lanes[j % len(lanes)]) for j, r in enumerate(picks)]


def build_pipeline(model: Dict, serve: Dict, seed: int, device):
    from clap2diffusion_tpu_torch.core.config import Config, from_dict
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline

    w = draw_weights(namespace(model), seed, TOWERS, DTYPES[serve["dtype"]], device)
    pipe = AudioToImagePipeline(from_dict(Config, model), params=w, device=device)
    del w
    return pipe


def max_length(cfg: Dict) -> int:
    return cfg["model"]["diffusion"]["clip_text"]["max_length"]


def knobs(serve: Dict) -> Dict:
    return dict(num_steps=serve["steps"], guidance_scale=serve["guidance_scale"],
                norm_target=serve["norm_target"], temperature=serve["temperature"],
                model_type=serve["model_type"], sampler=serve["sampler"])


def capture_seconds(pipe) -> float:
    return float(sum(c.capture_s for c in pipe.programs.captured.values()))


def release(device) -> None:
    """Return the freed program's memory to the card before the reference
    runs (the peak has been read by then)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def closed(cell: Dict, args, device, t_process: float, trace: bool) -> Dict:
    """``traffic["batch"]`` images a request, each lane its own seed, one
    request at a time through ``generate`` (its two halves, dispatch and
    fetch, each in a span) until the window's seconds have passed."""
    cfg, spec = cell["config"], cell["traffic"]
    serve, b = cfg["serve"], spec["batch"]
    seconds = spec["trace_seconds"] if trace else args.seconds
    t_in = time.perf_counter()
    inputs = Inputs(spec, args.seed, b, max_length(cfg))
    t_pipe = time.perf_counter()
    pipe = build_pipeline(cfg["model"], serve, args.seed, device)
    t_warm = time.perf_counter()
    kw = knobs(serve)

    def request(i: int) -> np.ndarray:
        r = inputs.request(i)
        with span("dispatch"):
            h = pipe._dispatch_generate(waveform=r["waveform"], text_ids=r["text_ids"],
                                        uncond_ids=r["uncond_ids"], batch=b,
                                        seeds=r["seeds"], **kw)
        with span("fetch"):
            return h if isinstance(h, torch.Tensor) else h.numpy()

    for j in range(spec.get("warmup_requests", 2)):
        request(Inputs.WARMUP + j)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    capture_s = capture_seconds(pipe)
    log(phase="setup", before_inputs_s=t_in - t_process, inputs_s=t_pipe - t_in,
        pipeline_s=t_warm - t_pipe, warmup_s=time.perf_counter() - t_warm, capture_s=capture_s)
    prof = None
    if trace:
        from perfbench.harness.reduce import profile

        prof = profile()
        prof.start()
    images, lat = [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    with span("window"):
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            images.append(np.asarray(request(len(images))))
            lat.append(time.perf_counter() - ts)
    t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    dev = device_info(torch, device)
    n = len(images)
    log(phase="window", requests=n, images=n * b, window_s=t1 - t0, setup_s=setup_s,
        capture_s=capture_s, p50_s=float(np.median(lat)))
    del pipe, request
    release(device)
    result = {
        "attempted": n * b, "failed": 0, "device": dev,
        "e2e": {"images_per_s": n * b / (t1 - t0), "latency_p50_s": float(np.median(lat)),
                "setup_s": setup_s},
        "ctx": {"capture_s": capture_s, "window_s": t1 - t0, "requests": n, "batch": b,
                "prof": prof},
    }
    jobs = []
    for i, lane in sorted(image_sample(args.seed, n, b, spec["check_images"])):
        r = inputs.request(i)
        jobs.append({"waveforms": list(r["waveform"]), "lane": lane,
                     "text_ids": r["text_ids"][lane:lane + 1],
                     "uncond_ids": r["uncond_ids"][lane:lane + 1],
                     "seed": int(r["seeds"][lane]), "image": images[i][lane]})
    result["checks"] = check.serving(cfg, args.seed, jobs, device)
    return result


# -- open loop -----------------------------------------------------------------

def wav_bytes(x: np.ndarray, rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(x, "<i2").tobytes())
    return buf.getvalue()


def groups_of(done: List[Dict]) -> List[List[Dict]]:
    """The coalesced groups, rebuilt from the responses: a group's members
    return together (one fetch releases them all) and carry its size and
    their lanes 0..n-1. Raises where the responses do not split so."""
    order = sorted(done, key=lambda d: d["t_done"])
    groups, i = [], 0
    while i < len(order):
        n = order[i]["batch"]
        g = order[i:i + n]
        if len(g) != n or sorted(d["lane"] for d in g) != list(range(n)) or any(
                d["batch"] != n for d in g):
            raise ValueError(f"responses {i}..{i + n} do not form one coalesced group")
        groups.append(sorted(g, key=lambda d: d["lane"]))
        i += n
    return groups


def open_loop(cell: Dict, args, device, t_process: float, trace: bool) -> Dict:
    """Exactly ``round(rate_per_s * seconds)`` requests, due at the times of
    the mix's fixed trace (``traffic.due_times``), each sent on its own
    thread at its due time into
    ``InferenceService.generate`` (audio as a 16-bit WAV, the prompt as
    text); each timed from its due time to its image. Every request due in
    the window is waited for."""
    from clap2diffusion_tpu_torch.apps.server import InferenceService
    from clap2diffusion_tpu_torch.utils.png import decode_png

    cfg, spec = cell["config"], cell["traffic"]
    serve = cfg["serve"]
    due = T.due_times(args.seed, spec["rate_per_s"], args.seconds, spec.get("trace_seed", 1))
    n = len(due)
    t_in = time.perf_counter()
    inputs = Inputs(spec, args.seed, 1, max_length(cfg))
    rate = spec["audio"]["rate"]

    def body(i: int) -> Dict:
        r = inputs.request(i)
        return {"audio_b64": base64.b64encode(wav_bytes(r["waveform"][0], rate)).decode(),
                "text": inputs.prompts[inputs.prompt_rows(i)[0]],
                "steps": serve["steps"], "cfg": serve["guidance_scale"],
                "norm": serve["norm_target"], "model_type": serve["model_type"],
                "sampler": serve["sampler"], "seed": int(r["seeds"][0])}

    bodies = [body(i) for i in range(n)]
    t_pipe = time.perf_counter()
    pipe = build_pipeline(cfg["model"], serve, args.seed, device)
    t_warm = time.perf_counter()
    svc = InferenceService(pipe=pipe, coalesce_ms=spec["coalesce_ms"],
                           coalesce_max_batch=spec["coalesce_max_batch"])
    # every padded group size the coalescer can dispatch, captured before the window
    kw = knobs(serve)
    for m in spec["warm_batches"]:
        r = inputs.request(Inputs.WARMUP)
        pipe.generate(waveform=np.repeat(r["waveform"], m, axis=0),
                      text_ids=np.repeat(r["text_ids"], m, axis=0),
                      uncond_ids=np.repeat(r["uncond_ids"], m, axis=0), batch=m,
                      seeds=np.arange(m, dtype=np.int32), **kw)
    svc.generate(body(Inputs.WARMUP))  # the HTTP path once: decode, coalescer, PNG
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    capture_s = capture_seconds(pipe)
    log(phase="setup", before_inputs_s=t_in - t_process, inputs_s=t_pipe - t_in,
        pipeline_s=t_warm - t_pipe, warmup_s=time.perf_counter() - t_warm, capture_s=capture_s)
    captures_before = len(pipe.programs.captured)
    base_metrics = svc.metrics()["coalesce"]

    done: List[Dict] = []
    lock = threading.Lock()

    def send(i: int, t_due: float):
        late = time.perf_counter() - t_due
        try:
            with span("request"):
                resp = svc.generate(dict(bodies[i]))
            t = time.perf_counter()
            rec = {"i": i, "t_send": t_due + late, "t_done": t, "latency": t - t_due,
                   "late": late,
                   "batch": resp["info"]["coalesced_batch"],
                   "lane": resp["info"]["coalesced_lane"], "png": resp["image_b64"]}
        except Exception as e:  # a failed request counts as missing
            rec = {"i": i, "error": repr(e), "late": late}
        with lock:
            done.append(rec)

    # the schedule: every send at its due time; in a traced run the profiler
    # covers the whole window, whose arrivals are the same in every run
    events = [(float(d), "send", i) for i, d in enumerate(due)]
    prof, window, tw = None, None, [0.0, 0.0]
    if trace:
        from perfbench.harness.reduce import profile

        prof = profile()
        events.append((float(args.seconds), "stop", None))
        prof.start()
        window = span("window")
        window.__enter__()
    threads = []
    t0 = tw[0] = time.perf_counter()
    setup_s = t0 - t_process
    for when, kind, i in events:
        delay = t0 + when - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if kind == "send":
            th = threading.Thread(target=send, args=(i, t0 + when), daemon=True)
            th.start()
            threads.append(th)
        else:
            window.__exit__(None, None, None)
            tw[1] = time.perf_counter()
            prof.stop()
            tw.append(time.perf_counter() - tw[1])
    for th in threads:
        th.join(timeout=max(1.0, args.seconds + 120 - (time.perf_counter() - t0)))
    t1 = time.perf_counter()
    dev = device_info(torch, device)
    svc_metrics = svc.metrics()["coalesce"]
    captures_in_window = len(pipe.programs.captured) - captures_before
    ok = [d for d in done if "error" not in d]
    failed = n - len(ok)
    lat = sorted(d["latency"] for d in ok) + [float("inf")] * failed
    lateness = sorted(d["late"] for d in done)
    by_due = [d["latency"] for d in sorted(ok, key=lambda d: d["i"])]
    third = max(1, len(by_due) // 3)
    backlog = {"at_window_end": sum(1 for d in ok if d["t_done"] > t0 + args.seconds),
               "drain_s": t1 - (t0 + args.seconds),
               "first_third_mean_s": float(np.mean(by_due[:third])) if ok else None,
               "last_third_mean_s": float(np.mean(by_due[-third:])) if ok else None}
    log(phase="window", requests=n, completed=len(ok), failed=failed, window_s=t1 - t0,
        setup_s=setup_s, capture_s=capture_s, sender_late_p50_s=float(np.median(lateness)),
        sender_late_max_s=float(max(lateness)), captures_in_window=captures_in_window,
        profiler_stop_s=tw[2] if prof is not None else None,
        p50_s=float(np.median(lat)), p90_s=float(np.quantile(lat, 0.9, method="higher")),
        **backlog)
    batches = svc_metrics["batches"] - base_metrics["batches"]
    images = svc_metrics["images"] - base_metrics["images"]
    p90 = float(np.quantile(lat, 0.9, method="higher"))
    result = {
        "attempted": n, "failed": failed, "device": dev,
        # more than a tenth of the requests failed: the tail is missing (1e9 s)
        "e2e": {"latency_p90_s": p90 if np.isfinite(p90) else 1e9,
                "setup_s": setup_s},
        "ctx": {"capture_s": capture_s, "window_s": t1 - t0, "requests": n,
                "coalesce_images": images, "coalesce_batches": batches,
                "responses": ok, "latency_p50_s": float(np.median(lat)),
                "captures_in_window": captures_in_window, "prof": prof,
                "backlog": backlog,
                "traced_window_s": tw[1] - tw[0] if prof is not None else None,
                # each request in flight, on the host clock: names the device's idle gaps
                "host_spans": [("request", d["t_send"], d["t_done"]) for d in ok],
                "host_t0": tw[0] if prof is not None else None},
    }
    # the coalescer's threads keep the service: take the program out of it
    pipe.programs.clear()
    svc.pipe = None
    del svc, pipe
    release(device)
    groups = groups_of(ok)
    by_i = {d["i"]: d for d in ok}
    pick = T.rng(args.seed, 7).choice(len(ok), size=min(spec["check_images"], len(ok)),
                                      replace=False) if ok else []
    ok_sorted = sorted(ok, key=lambda d: d["i"])
    jobs = []
    for k in sorted(int(s) for s in pick):
        d = ok_sorted[k]
        g = next(g for g in groups if d in g)
        m = 1 << (len(g) - 1).bit_length()
        lanes = g + [g[-1]] * (m - len(g))
        wavs = [inputs.request(x["i"])["waveform"][0] for x in lanes]
        r = inputs.request(d["i"])
        jobs.append({"waveforms": wavs, "lane": d["lane"], "text_ids": r["text_ids"],
                     "uncond_ids": r["uncond_ids"], "seed": int(r["seeds"][0]),
                     "image": decode_png(base64.b64decode(by_i[d["i"]]["png"]))})
    result["checks"] = check.serving(cfg, args.seed, jobs, device)
    if failed:
        result["checks"].append({"name": "requests_failed", "value": failed, "limit": 0,
                                 "ok": False})
    return result
