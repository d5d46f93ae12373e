"""HTTP server (standard library only) for audio+text -> image (port of
``clap2diffusion_tpu/apps/server.py``).

    POST /generate   JSON {audio_b64?: wav bytes, text?: str, steps?: int,
                           cfg?: float, cfg_rescale?: float (0..1), norm?: float,
                           seed?: int, model_type?: str, sampler?: str,
                           negative?: str, init_image_b64?: png/jpg bytes,
                           strength?: float, mask_image_b64?: grey png bytes,
                           audio2_b64?: wav bytes, audio_mix?: float,
                           best_of?: int, format?: "png"|"jpeg", quality?: int}
                     -> JSON {image_b64, info: {...}}; best_of > 1 generates N
                     candidates in one batched request, ranks them by
                     CLIPScore against ``text`` on the card and answers the
                     winner, with ``info.clip_scores`` (it needs the CLIP
                     vision weights, refuses init and mask images and
                     bypasses the coalescer).
    POST /generate_batch
                     JSON {requests: [{audio_b64?, text?, negative?, seed?}, ...],
                           steps?, cfg?, norm?, seed?, model_type?, sampler?}
                     -> JSON {images_b64: [...], info: {...}}; one batched
                     request, the scalar knobs shared, a per-request seed
                     switching every lane to its own seed's draws.
    GET  /healthz    -> 200 "ok"
    GET  /metrics    -> JSON {requests, errors, images, coalesce, latency_s:
                       {p50, p90, max, count}, stages: {<stage>: {p50, p90,
                       count}}}, each over a sliding window of 512.

The stages of a /generate request (``STAGES``, seconds; a stage the request
did not pass is not counted): ``decode`` the audio and image decoding and
the tokenising, before the coalescer; ``queue`` its wait in the coalescer's
queue, from its arrival to its group's forming; ``window`` its group's
window, from the worker's first wait on the group to its forming;
``prepare`` the request's checks and host preparation (``_prepare``: the
uploads and draws); ``replay`` the device program's run on the host (a
CUDA-graph replay: the lock, the copies in, the replay and the output's
clone); ``device.condition_audio``, ``device.text``, ``device.unet_loop``
and ``device.vae`` the device program's stages, timed on the card (the
dequantise, log-mel, HTSAT and conditioning; CLIP text; the sampler loop;
the VAE decode and the uint8 cast); ``fetch`` the wait for the images'
copy to the host; ``encode`` the image's encoding. A coalesced request
reports its group's ``window``, ``prepare``, ``replay``, device stages and
``fetch``. They are always measured (a few clock readings a request); while
``utils/profiling.py`` records, each is also a span (``service.request``,
``service.decode``, ``service.queue`` and ``service.encode`` under the
request's id; ``service.window``, ``pipeline.prepare``, ``program.replay``,
``pipeline.fetch`` and ``device.*`` under its dispatch's id, the window
listing the group's requests).

PNG answers go through the port's
standard-library encoder (``utils/png.py``); ``format: "jpeg"`` and the
uploaded init and mask images need Pillow, imported only then.

Concurrency: the card is one serial resource, but dispatch is
asynchronous. The lock covers only the enqueue of a request's work; its
fetch (``HostCopy.numpy()``, which waits for that request's own copy to
the host) happens outside it, so one request's upload, fetch and encoding
overlap its neighbour's compute. ``info.fetch_wait_s`` is the time a
request's fetch waited.

With ``--coalesce-ms N`` (off by default) the server micro-batches:
concurrent simple /generate requests whose scalar knobs match fold into
one batched request, padded to the next power of two, with per-lane
seeds. Contract: a coalesced group's images equal, bit for bit,
``generate(seeds=<the padded group's seeds>, batch=m)`` on the group's
waveforms (``_stack_wavs``: one waveform where they are all the same) and
prompts, and ``info.coalesced_batch`` says the
group's size (``info.coalesced_lane`` the request's lane in it). A coalesced image is not promised to equal the same request
served alone: the card's kernels may round a batch of m other than a
batch of 1.

    python -m clap2diffusion_tpu_torch.apps.server --port 7860 [--checkpoint DIR]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from clap2diffusion_tpu_torch.utils import profiling
from clap2diffusion_tpu_torch.utils.png import encode_png

# the stages of a request that /metrics reports, in the order a request
# passes them (see the module doc)
STAGES = ("decode", "queue", "window", "prepare", "replay", "device.condition_audio",
          "device.text", "device.unet_loop", "device.vae", "fetch", "encode")


class _Pending:
    """One request parked in the coalescer's queue."""

    __slots__ = ("key", "wav", "text_ids", "uncond_ids", "seed", "event", "result", "error",
                 "batch", "lane", "request_id", "t_queued", "t_taken", "dispatch_id", "stages")

    def __init__(self, key, wav, text_ids, uncond_ids, seed, request_id=None):
        self.key = key
        self.wav = wav
        self.text_ids = text_ids
        self.uncond_ids = uncond_ids
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.batch = 1
        self.lane = 0
        self.request_id = request_id
        self.t_queued = self.t_taken = 0
        self.dispatch_id = None
        self.stages: dict = {}


class RequestCoalescer:
    """Micro-batching of concurrent /generate requests.

    Requests whose scalar knobs (steps, cfg, norm, model_type, sampler,
    cfg_rescale, whether there is audio) match are grouped for up to
    ``window_ms``, at most ``max_batch`` a group; the seed is not part of
    the key (each lane draws from its own seed). A group is padded to the
    next power of two with copies of its last request. One thread forms
    groups and dispatches them; another fetches their images (at most two
    groups in flight), so a group's fetch overlaps the next group's
    compute."""

    def __init__(self, service: "InferenceService", window_ms: float = 15.0,
                 max_batch: int = 8):
        self.service = service
        self.window = max(window_ms, 0.0) / 1000.0
        self.max_batch = max(int(max_batch), 1)
        self._cv = threading.Condition()
        self._queue: list = []
        self._fetch_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._fetch_thread = threading.Thread(target=self._fetcher, daemon=True)
        self._fetch_thread.start()

    def submit(self, wav, text_ids, uncond_ids, params: dict,
               request_id: Optional[int] = None) -> _Pending:
        """Park one request until its group's images are fetched; returns
        it with its ``result`` (the image), ``batch`` (the group's size),
        ``lane`` (its place in the group) and ``stages`` (seconds: its
        ``queue``, the group's ``window`` and the group's dispatch's
        stages, ``HostCopy.stages``, its ``fetch`` among them). Its wait in
        the queue is span ``service.queue`` under ``request_id``."""
        key = (params["num_steps"], params["guidance_scale"], params["norm_target"],
               params["model_type"], params["sampler"], params["guidance_rescale"],
               wav is not None)
        p = _Pending(key, wav, text_ids, uncond_ids, params["seed"], request_id)
        with self._cv:
            p.t_queued = profiling.now()
            self._queue.append(p)
            self._cv.notify_all()
        p.event.wait()
        profiling.record("service.queue", p.t_queued, p.t_taken, id=request_id,
                         parent=request_id, dispatch=p.dispatch_id)
        if p.error is not None:
            raise p.error
        p.stages["queue"] = (p.t_taken - p.t_queued) / 1e9
        return p

    def _worker(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                key = self._queue[0].key
                t_open = profiling.now()
                deadline = time.monotonic() + self.window
                while True:
                    same = [p for p in self._queue if p.key == key]
                    remaining = deadline - time.monotonic()
                    if len(same) >= self.max_batch or remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                group = same[: self.max_batch]
                t_formed = profiling.now()
                for p in group:
                    self._queue.remove(p)
                    p.t_taken = t_formed
            self._run(group, t_open, t_formed)

    @staticmethod
    def padded(group: list) -> tuple:
        """(m, seeds, waveform, text_ids, uncond_ids) of a group padded to
        the next power of two m with copies of its last request."""
        n = len(group)
        m = 1 << (n - 1).bit_length()
        lanes = group + [group[-1]] * (m - n)
        wav = None
        if lanes[0].wav is not None:
            wav = InferenceService._stack_wavs([p.wav for p in lanes])
        return (m, np.asarray([p.seed for p in lanes], np.int32), wav,
                np.concatenate([p.text_ids for p in lanes]),
                np.concatenate([p.uncond_ids for p in lanes]))

    def _run(self, group: list, t_open: int, t_formed: int):
        """Dispatch a group formed by the window [t_open, t_formed] (span
        ``service.window`` under the dispatch's id, listing its requests)."""
        svc = self.service
        try:
            m, seeds, wav, text_ids, uncond_ids = self.padded(group)
            steps, cfg, norm, model_type, sampler, rescale, _ = group[0].key
            with svc._lock:
                handle = svc.pipe._dispatch_generate(
                    waveform=wav, text_ids=text_ids, uncond_ids=uncond_ids, batch=m,
                    num_steps=steps, guidance_scale=cfg, norm_target=norm,
                    model_type=model_type, seed=0, seeds=seeds, sampler=sampler,
                    guidance_rescale=rescale)
            did = handle.dispatch_id
            profiling.record("service.window", t_open, t_formed, id=did, parent=did,
                             requests=[p.request_id for p in group])
            handle.stages["window"] = (t_formed - t_open) / 1e9
            self._fetch_q.put((group, handle))
        except Exception as e:  # fail the group, keep serving
            for p in group:
                p.error = e
                p.event.set()

    def _fetcher(self):
        while True:
            group, handle = self._fetch_q.get()
            try:
                imgs = handle.numpy()
                for i, p in enumerate(group):
                    p.result, p.batch, p.lane = imgs[i], len(group), i
                    p.dispatch_id, p.stages = handle.dispatch_id, dict(handle.stages)
                self.service.record_coalesce(len(group))
            except Exception as e:
                for p in group:
                    p.error = e
            for p in group:
                p.event.set()


class InferenceService:
    """A pipeline behind a dispatch lock, with the serving counters.

    ``pipe`` serves as given; otherwise one is built from ``cfg`` and
    ``params`` (random weights when None) on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, cfg=None, params=None, coalesce_ms: float = 0.0,
                 coalesce_max_batch: int = 8, device=None, pipe=None):
        from clap2diffusion_tpu_torch.core.config import Config
        from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
        from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

        self.cfg = pipe.cfg if pipe is not None else (cfg or Config())
        self.pipe = pipe or AudioToImagePipeline(self.cfg, params=params, device=device)
        self.tok = CLIPTokenizer(max_length=self.cfg.diffusion.clip_text.max_length)
        self._lock = threading.Lock()
        # counters, under their own lock so that /metrics never waits on dispatch
        self._mlock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._images = 0
        self._latencies: list = []  # sliding window, seconds
        self._stages: dict = {name: [] for name in STAGES}  # sliding windows, seconds
        self._coalesced_batches = 0
        self._coalesced_images = 0
        self.coalescer: Optional[RequestCoalescer] = (
            RequestCoalescer(self, coalesce_ms, coalesce_max_batch) if coalesce_ms > 0 else None)

    def record(self, latency_s: float, images: int = 1, error: bool = False):
        with self._mlock:
            self._requests += 1
            if error:
                self._errors += 1
            else:
                self._images += images
                self._latencies.append(latency_s)
                if len(self._latencies) > 512:
                    self._latencies = self._latencies[-512:]

    def record_stages(self, stages: dict):
        """One request's stage times (seconds; see ``STAGES``) into their
        sliding windows."""
        with self._mlock:
            for name, v in stages.items():
                window = self._stages.get(name)
                if window is not None:
                    window.append(v)
                    if len(window) > 512:
                        del window[0]

    def record_coalesce(self, group_size: int):
        with self._mlock:
            self._coalesced_batches += 1
            self._coalesced_images += group_size

    def metrics(self) -> dict:
        with self._mlock:
            lats = sorted(self._latencies)
            out = {
                "requests": self._requests,
                "errors": self._errors,
                "images": self._images,
                "coalesce": {
                    "batches": self._coalesced_batches,
                    "images": self._coalesced_images,
                    "mean_batch": round(self._coalesced_images / self._coalesced_batches, 2)
                    if self._coalesced_batches else 0.0,
                },
                "latency_s": {},
                "stages": {},
            }
            if lats:
                n = len(lats)
                out["latency_s"] = {"p50": round(lats[n // 2], 4),
                                    "p90": round(lats[min(n - 1, int(n * 0.9))], 4),
                                    "max": round(lats[-1], 4), "count": n}
            for name, window in self._stages.items():
                if window:
                    v = sorted(window)
                    n = len(v)
                    out["stages"][name] = {"p50": round(v[n // 2], 6),
                                           "p90": round(v[min(n - 1, int(n * 0.9))], 6),
                                           "count": n}
            return out

    def _decode_audio(self, req: dict, key: str = "audio_b64"):
        if not req.get(key):
            return None
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(base64.b64decode(req[key]))
            f.flush()
            return self.pipe.load_audio(f.name)

    def _decode_init_image(self, req: dict, key: str = "init_image_b64", mask: bool = False):
        if not req.get(key):
            return None
        return self.pipe.load_init_image(io.BytesIO(base64.b64decode(req[key])), mask=mask)

    def _knobs(self, req: dict) -> dict:
        sch = self.cfg.diffusion.scheduler
        return {
            "num_steps": int(req.get("steps", sch.num_inference_steps)),
            "guidance_scale": float(req.get("cfg", sch.guidance_scale)),
            "norm_target": float(req.get("norm", self.cfg.condition.audio_norm_target)),
            "model_type": str(req.get("model_type", "hierarchical")),
            "seed": int(req.get("seed", 0)),
            "sampler": str(req.get("sampler", sch.sampler)),
            "guidance_rescale": float(req.get("cfg_rescale", 0.0)),
        }

    @staticmethod
    def _img_b64(img: np.ndarray, fmt: str = "png", quality: int = 92) -> str:
        """One image as base64: 'png' (lossless, the default, no Pillow)
        or 'jpeg' (Pillow)."""
        fmt = fmt.lower()
        if fmt not in ("png", "jpeg", "jpg"):
            raise ValueError(f"unknown image format {fmt!r} (png|jpeg)")
        if fmt == "png":
            return base64.b64encode(encode_png(np.asarray(img))).decode()
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("format 'jpeg' needs Pillow (PIL); ask for 'png'") from e
        buf = io.BytesIO()
        Image.fromarray(np.asarray(img)).save(buf, format="JPEG", quality=int(quality))
        return base64.b64encode(buf.getvalue()).decode()

    @staticmethod
    def _info(params: dict) -> dict:
        return {"steps": params["num_steps"], "cfg": params["guidance_scale"],
                "norm": params["norm_target"], "model_type": params["model_type"],
                "seed": params["seed"], "sampler": params["sampler"],
                "cfg_rescale": params["guidance_rescale"]}

    @staticmethod
    def _stack_wavs(wavs: list) -> np.ndarray:
        """Per-request waveforms as one batch. Identical sources ride as one
        waveform, which the pipeline encodes once and expands to every lane,
        so that a batch of one sound is conditioned as that sound alone (the
        card may round the CLAP tower at batch m otherwise: ROADMAP known
        delta 15). Else the stack: int16 (PCM16) only if every source is,
        otherwise each int16 source dequantised on the host (x / peak, as the
        device does)."""
        if all(w.dtype == wavs[0].dtype and np.array_equal(w, wavs[0]) for w in wavs[1:]):
            return wavs[0]
        if all(w.dtype == np.int16 for w in wavs):
            return np.stack(wavs)
        return np.stack([w.astype(np.float32) / max(float(np.abs(w).max()), 1.0)
                         if w.dtype == np.int16 else w for w in wavs])

    def _fetch(self, handle):
        t0 = time.perf_counter()
        return handle.numpy(), time.perf_counter() - t0

    def generate(self, req: dict) -> dict:
        """One /generate request; its stages are spans under a fresh
        request id, its whole ``service.request``, and their times go to
        the sliding windows of /metrics (see the module doc)."""
        rid = profiling.new_id()
        t0 = profiling.now()
        try:
            return self._generate(req, rid, t0)
        finally:
            profiling.record("service.request", t0, profiling.now(), id=rid)

    def _generate(self, req: dict, rid: int, t0: int) -> dict:
        # every host-side decode runs outside the lock, which covers only
        # the enqueue; the fetch waits outside it for this request's copy
        wav = self._decode_audio(req)
        params = self._knobs(req)
        fmt, quality = req.get("format", "png"), int(req.get("quality", 92))
        best_of = int(req.get("best_of", 1))
        text_ids = self.tok(req.get("text", ""))
        uncond_ids = self.tok(str(req.get("negative", "")))
        coalesce = best_of <= 1 and self.coalescer is not None and not any(
            req.get(k) for k in ("init_image_b64", "mask_image_b64", "audio2_b64"))
        extra = {}
        if best_of > 1:
            # one batched request of candidates and the on-device select;
            # only the winner and the scores are fetched. The coalescer's
            # per-lane seed slots are taken by the candidates: bypass it
            if any(req.get(k) for k in ("init_image_b64", "mask_image_b64")):
                raise ValueError("best_of is unsupported with init/mask images (candidates "
                                 "need per-lane seeds)")
            extra = dict(waveform2=self._decode_audio(req, "audio2_b64"),
                         audio_mix=float(req.get("audio_mix", 0.5)))
        elif not coalesce:
            extra = dict(
                init_image=self._decode_init_image(req), strength=float(req.get("strength", 0.8)),
                mask_image=self._decode_init_image(req, "mask_image_b64", mask=True),
                waveform2=self._decode_audio(req, "audio2_b64"),
                audio_mix=float(req.get("audio_mix", 0.5)))
        t_decoded = profiling.now()
        profiling.record("service.decode", t0, t_decoded, id=rid, parent=rid)
        stages = {"decode": (t_decoded - t0) / 1e9}
        if best_of > 1:
            with self._lock:
                best, scores = self.pipe._dispatch_best_of(
                    best_of, waveform=wav, text_ids=text_ids, uncond_ids=uncond_ids,
                    **extra, **params)
            img, fetch_s = self._fetch(best)
            info = {**self._info(params), "best_of": best_of,
                    "clip_scores": [round(float(v), 4) for v in scores.numpy()],
                    "fetch_wait_s": fetch_s}
        elif coalesce:
            p = self.coalescer.submit(wav, text_ids, uncond_ids, params, request_id=rid)
            img = p.result
            stages.update(p.stages)
            info = {**self._info(params), "coalesced_batch": p.batch,
                    "coalesced_lane": p.lane, "fetch_wait_s": p.stages["fetch"]}
        else:
            with self._lock:
                handle = self.pipe._dispatch_generate(
                    waveform=wav, text_ids=text_ids, uncond_ids=uncond_ids, **extra, **params)
            imgs, fetch_s = self._fetch(handle)
            img = imgs[0]
            stages.update(handle.stages)
            info = {**self._info(params), "fetch_wait_s": fetch_s}
        t_enc = profiling.now()
        image_b64 = self._img_b64(img, fmt, quality)
        t_done = profiling.now()
        profiling.record("service.encode", t_enc, t_done, id=rid, parent=rid)
        stages["encode"] = (t_done - t_enc) / 1e9
        self.record_stages(stages)
        return {"image_b64": image_b64, "info": info}

    def generate_batch(self, req: dict) -> dict:
        """A request group as one batched request: the scalar knobs shared;
        a request's own ``seed`` switches every lane to per-lane draws, so
        that each image depends on its own seed."""
        reqs = req.get("requests") or []
        if not reqs:
            raise ValueError("generate_batch needs a non-empty 'requests' list")
        params = self._knobs(req)
        seeds = None
        if any("seed" in r for r in reqs):
            seeds = np.asarray([int(r.get("seed", params["seed"])) for r in reqs], np.int32)
        wavs = [self._decode_audio(r) for r in reqs]
        if any(w is None for w in wavs) and not all(w is None for w in wavs):
            raise ValueError("generate_batch requests must either all carry audio_b64 or none")
        waveform = None if wavs[0] is None else self._stack_wavs(wavs)
        text_ids = np.concatenate([self.tok(r.get("text", "")) for r in reqs])
        uncond_ids = np.concatenate([self.tok(str(r.get("negative", ""))) for r in reqs])
        with self._lock:
            handle = self.pipe._dispatch_generate(
                waveform=waveform, text_ids=text_ids, uncond_ids=uncond_ids,
                batch=len(reqs), seeds=seeds, **params)
        imgs, fetch_s = self._fetch(handle)
        info = {**self._info(params), "batch": len(reqs), "fetch_wait_s": fetch_s}
        if seeds is not None:
            info["seeds"] = [int(s) for s in seeds]
        fmt, quality = req.get("format", "png"), int(req.get("quality", 92))
        return {"images_b64": [self._img_b64(im, fmt, quality) for im in imgs], "info": info}


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path in ("/", "/healthz"):
                self._send(200, b"ok", "text/plain")
            elif self.path == "/metrics":
                self._send(200, json.dumps(service.metrics()).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            routes = {"/generate": service.generate, "/generate_batch": service.generate_batch}
            fn = routes.get(self.path)
            if fn is None:
                self._send(404, b'{"error": "not found"}')
                return
            t0 = time.perf_counter()
            try:
                n = int(self.headers.get("Content-Length", 0))
                out = fn(json.loads(self.rfile.read(n) or b"{}"))
                service.record(time.perf_counter() - t0,
                               images=len(out["images_b64"]) if "images_b64" in out else 1)
                self._send(200, json.dumps(out).encode())
            except ValueError as e:  # a bad payload is the client's
                service.record(time.perf_counter() - t0, error=True)
                self._send(400, json.dumps({"error": str(e)}).encode())
            except Exception as e:  # report it as JSON and keep serving
                service.record(time.perf_counter() - t0, error=True)
                self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())

    return Handler


def serve(cfg=None, params=None, host: str = "0.0.0.0", port: int = 7860,
          service: Optional[InferenceService] = None, coalesce_ms: float = 0.0,
          coalesce_max_batch: int = 8, device=None) -> ThreadingHTTPServer:
    """The HTTP server over ``service`` (or a new one); the caller runs
    ``serve_forever`` and ``shutdown``."""
    service = service or InferenceService(cfg, params, coalesce_ms=coalesce_ms,
                                          coalesce_max_batch=coalesce_max_batch, device=device)
    return ThreadingHTTPServer((host, port), make_handler(service))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="clap2diffusion_tpu_torch.apps.server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--config", default=None, help="YAML config (needs PyYAML)")
    ap.add_argument("--checkpoint", default=None,
                    help="pipeline checkpoint (save_pipeline / tools.convert_checkpoints)")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="compute type of the checkpoint's towers")
    ap.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="fold concurrent /generate requests with matching knobs into one "
                         "batched request, waiting up to this many ms to form a group (0 = off)")
    ap.add_argument("--coalesce-max-batch", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def load_service(args) -> InferenceService:
    """The service a command line asks for: ``--checkpoint`` loaded in
    ``--dtype`` or random weights, on ``--device``."""
    import torch

    from clap2diffusion_tpu_torch.core.config import load_config
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, load_pipeline

    cfg = load_config(args.config, getattr(args, "overrides", None))
    dtype = getattr(torch, args.dtype)
    if args.checkpoint:
        pipe = load_pipeline(cfg, args.checkpoint, dtype=dtype, device=args.device)
    else:
        pipe = AudioToImagePipeline(cfg, dtype=dtype, device=args.device)
    return InferenceService(pipe=pipe, coalesce_ms=args.coalesce_ms,
                            coalesce_max_batch=args.coalesce_max_batch)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    server = serve(service=load_service(args), host=args.host, port=args.port)
    print(f"serving on {args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
