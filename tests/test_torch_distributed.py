"""The port's distributed runtime on the CPU against the JAX package:
``initialize_distributed`` without its variables, ``choose_mesh_axes``,
the set of tensors ``param_spec`` shards (by the JAX layout, at full width
and at the tiny width), and real 2-process Gloo launches (each with its own
free port and a timeout): one stage-2 update at ``data=2`` and at
``model=2`` against the single-process update within the JAX test's bounds
(``tests/test_distributed.py:298-313``), ``run_stage`` over both meshes
(the global batch, the replicas, the gathered checkpoint, a resume, and
a signal to one rank preempting both),
``run_evaluation(shard=True)`` and ``generate_sharded`` at ``data=2``, and
``generate_sharded`` after ``shard_pipeline_for_serving`` at ``model=2``
within the JAX image bounds (``tests/test_distributed.py:355-360``)."""

import dataclasses
import functools
import json
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import clap2diffusion_tpu.parallel.sharding as JS
from clap2diffusion_tpu_torch import convert as PC
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.parallel import distributed as PD
from clap2diffusion_tpu_torch.parallel import sharding as PS
from clap2diffusion_tpu_torch.train import checkpoint as ckpt
from clap2diffusion_tpu_torch.train import stages as PSt
from clap2diffusion_tpu_torch.train import trainer as PT
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

UPDATE_OVERRIDES = ["train.stage2.grad_accum=1", "train.compute_dtype=float32"]
RUN_OVERRIDES = [
    "data.latent_shape=[4,8,8]", "data.duration_s=0.5", "train.compute_dtype=float32",
    "train.stage2.batch_size=2", "train.stage2.grad_accum=1", "train.stage2.warmup_steps=1",
    "train.stage2.lr=1e-3", "train.stage2.eval_every=2", "train.stage2.eval_batches=2",
]
EVAL_SEED, GEN_SEED, UPDATE_SEED = 42, 3, 11
MODES = ("data", "model", "cli")


def _batch():
    lat = 64 // 8
    rng = np.random.default_rng(7)
    return {"clap": rng.normal(size=(8, 32)).astype(np.float32),
            "latent": rng.normal(size=(8, lat, lat, 4)).astype(np.float32),
            "text_ctx": rng.normal(size=(8, 7, 48)).astype(np.float32)}


def _wavs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, 24_000)) * 0.1).astype(np.float32), np.zeros((2, 7), np.int32)


_WORKER = r'''
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
port, rank, mode, out, data_root = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]

from clap2diffusion_tpu_torch.parallel import distributed as D
from clap2diffusion_tpu_torch.parallel import sharding as S
assert D.initialize_distributed(f"127.0.0.1:{{port}}", 2, rank, device="cpu")
assert D.initialize_distributed() and D.process_count() == 2
assert D.is_coordinator() == (rank == 0)

from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.core.mesh import make_mesh
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.models.layers import DataSlice
from clap2diffusion_tpu_torch.train import stages as St
from clap2diffusion_tpu_torch.train import trainer as T
inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
base = C.from_dict(C.Config, inp["cfg"])
EVAL_SEED, GEN_SEED, UPDATE_SEED = inp["seeds"]
RUN_OVERRIDES, UPDATE_OVERRIDES = inp["run_overrides"], inp["update_overrides"]
params = P.init_params(base, seed=0, device="cpu")
mp = 2 if mode == "model" else 1
if mode == "model":
    S.TP_MIN_WIDTH = 64
result = {{}}

# 1. one stage-2 update on the global batch of 8
cfg = C.apply_overrides(base, UPDATE_OVERRIDES)
mesh = S.make_train_mesh(2, model_parallel=mp)
st, state, sharded = T.stage_state(cfg, 2, params, mesh, torch.device("cpu"), 0)
assert bool(sharded) == (mode == "model")
batch = D.shard_host_batch(mesh, S.shard_batch(inp["batch"], mesh), device="cpu")
gen = torch.Generator().manual_seed(UPDATE_SEED)
if mesh.size("data") > 1:
    gen = DataSlice(gen, mesh.coord("data"), mesh.size("data"))
metrics = S.make_sharded_step(St.train_step, mesh)(st, state, batch, gen)
result["update_metrics"] = {{k: float(v) for k, v in metrics.items()}}
result["update_params"] = {{k: (S.gather_rows(t, mesh) if k in sharded else t).detach().clone()
                            for k, t in state.trainable_leaves().items()}}
result["sharded"] = sorted(sharded)

# 2. run_stage on the fixture data (the global batch, the replicas, the checkpoint)
cfg = C.apply_overrides(base, RUN_OVERRIDES + [f"train.model_parallel={{mp}}"])
seen, inner = [], T.PrefetchLoader.epoch
def spy(self, epoch_idx=0):
    for b in inner(self, epoch_idx):
        seen.append(list(b["audio_id"]))
        yield b
T.PrefetchLoader.epoch = spy
losses, step = [], T.train_step
def record(*a, **kw):
    m = step(*a, **kw)
    losses.append({{k: float(v) for k, v in m.items()}})
    return m
T.train_step = record
ck = os.path.join(out, "ck")
state = T.run_stage(cfg, 2, params, data_root=data_root, max_steps=2, checkpoint_dir=ck,
                    log_dir=os.path.join(out, f"logs{{rank}}"), device="cpu")
result["run_ids"], result["run_losses"] = seen, list(losses)
result["run_params"] = {{k: t.detach().clone() for k, t in state.trainable_leaves().items()}}
if mode == "model":  # a resume from the gathered checkpoint, one more step
    losses.clear()
    state = T.run_stage(cfg, 2, params, data_root=data_root, max_steps=3, checkpoint_dir=ck,
                        log_dir=os.path.join(out, f"logs{{rank}}"), device="cpu",
                        resume_from="stage2_final")
    result["resume_losses"] = list(losses)
T.train_step, T.PrefetchLoader.epoch = step, inner

# 2b. a SIGTERM to rank 1 alone, in its first micro-step: both ranks save the
# preemption checkpoint after that micro-step and re-raise the signal
if mode == "data":
    import signal
    class Preempted(Exception):
        pass
    def on_term(signum, frame):
        raise Preempted(signum)
    signal.signal(signal.SIGTERM, on_term)
    steps_run = []
    def signal_rank1(*a, **kw):
        m = step(*a, **kw)
        steps_run.append(1)
        if rank == 1 and len(steps_run) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return m
    T.train_step = signal_rank1
    try:
        T.run_stage(cfg, 2, params, data_root=data_root, max_steps=4,
                    checkpoint_dir=os.path.join(out, "ck_sig"),
                    log_dir=os.path.join(out, f"logs_sig{{rank}}"), device="cpu")
        result["preempted"] = None
    except Preempted as e:
        result["preempted"] = e.args[0]
    finally:
        T.train_step = step
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    result["preempt_steps"] = len(steps_run)

# 3. serving
wavs, ids = inp["wavs"]
if mode == "data":
    pipe = P.AudioToImagePipeline(base, params=params, device="cpu")
    result["gen_data"] = P.generate_sharded(pipe, make_mesh({{"data": -1}}), wavs, ids,
                                            num_steps=2, seed=GEN_SEED)
    result["gen_data_seeds"] = P.generate_sharded(pipe, make_mesh({{"data": -1}}), wavs, ids,
                                                  num_steps=2, seed=GEN_SEED,
                                                  seeds=np.array([5, 9]))
    from clap2diffusion_tpu_torch.eval import evaluate as E
    captured, gs = [], P.generate_sharded
    def cap(*a, **kw):
        imgs = gs(*a, **kw)
        captured.append(imgs)
        return imgs
    P.generate_sharded = cap
    res = E.run_evaluation(base, data_root=data_root, max_samples=3, num_steps=2,
                           seed=EVAL_SEED, params=params, shard=True, device="cpu")
    result["eval_images"] = np.concatenate(captured)
    result["eval_samples"] = res["samples"]
else:
    pipe = P.AudioToImagePipeline(base, params=params, device="cpu")
    P.shard_pipeline_for_serving(pipe, make_mesh({{"data": 1, "model": 2}}))
    result["tp_rows"] = int(pipe.unet.down_blocks[0].attentions[0].transformer_blocks[0]
                            .ff.net[0].proj.weight.shape[0])
    result["gen_model"] = P.generate_sharded(pipe, make_mesh({{"data": 1, "model": 2}}), wavs,
                                             ids, num_steps=2, seed=GEN_SEED)
torch.save(result, os.path.join(out, f"rank{{rank}}.pt"))
print(f"RANK{{rank}} DONE", flush=True)
'''


_CLI_WORKER = r'''
import os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
port, rank, out, data_root = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
from clap2diffusion_tpu_torch.apps import main as M
from clap2diffusion_tpu_torch.core import config as C
inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
tiny = C.apply_overrides(C.from_dict(C.Config, inp["cfg"]), inp["run_overrides"])
C.load_config = lambda path=None, overrides=None: tiny  # the CLI at the tiny geometry
assert M.main(["train", "--stage", "2", "--data-root", data_root, "--max-steps", "2",
               "--checkpoint-dir", os.path.join(out, "ck"), "--coordinator",
               f"127.0.0.1:{{port}}", "--num-processes", "2", "--process-id", str(rank),
               "--device", "cpu"]) == 0
assert M.main(["evaluate", "--shard", "--data-root", data_root, "--max-samples", "3",
               "--steps", "2", "--output", os.path.join(out, f"eval{{rank}}.json"),
               "--device", "cpu"]) == 0
print(f"RANK{{rank}} DONE", flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, mode, data_root):
    """Two ranks of the worker for ``mode`` (data, model or cli) over Gloo;
    the ranks' results (none for cli)."""
    out = tmp / mode
    out.mkdir()
    torch.save({"cfg": dataclasses.asdict(port_cfg(tiny_config())), "batch": _batch(),
                "wavs": _wavs(), "seeds": (EVAL_SEED, GEN_SEED, UPDATE_SEED),
                "run_overrides": RUN_OVERRIDES, "update_overrides": UPDATE_OVERRIDES},
               out / "inputs.pt")
    script = tmp / f"worker_{mode}.py"
    script.write_text((_CLI_WORKER if mode == "cli" else _WORKER).format(repo=REPO))
    port = str(_free_port())
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("C2D_COORDINATOR", "C2D_NUM_PROCESSES", "C2D_PROCESS_ID", "C2D_AUTO_DIST"):
        env.pop(k, None)
    args = [str(out), data_root] if mode == "cli" else [mode, str(out), data_root]
    # the CLI logs to the config's relative log_dir: run in the launch's directory
    procs = [subprocess.Popen([sys.executable, str(script), port, str(r), *args], env=env,
                              cwd=str(out), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:  # a rank that hangs fails the test instead of stalling the suite
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    if mode == "cli":
        return None
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The three 2-process launches (data=2, model=2 and the CLI), run side
    by side."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("dist")
    roots = {}
    for mode in MODES:
        roots[mode] = str(tmp / f"ds_{mode}")
        make_fixture_dataset(roots[mode], n_train=6, n_val=4, n_test=3, duration_s=0.5,
                             latent_hw=8)
    with ThreadPoolExecutor(len(MODES)) as pool:
        futs = {m: pool.submit(_launch, tmp, m, roots[m]) for m in MODES}
        return {m: f.result() for m, f in futs.items()}, roots, tmp


@pytest.fixture(scope="module")
def single():
    base = port_cfg(tiny_config())
    return base, P.init_params(base, seed=0, device="cpu")


# -- no process group --------------------------------------------------------------


def test_initialize_distributed_noop_single_process(monkeypatch):
    for k in ("C2D_COORDINATOR", "C2D_NUM_PROCESSES", "C2D_PROCESS_ID", "C2D_AUTO_DIST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(PD, "_INITIALIZED", False)
    assert PD.initialize_distributed() is False
    assert PD.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert PD.process_count() == 1 and PD.is_coordinator()
    mesh = PS.make_train_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None
    with pytest.raises(ValueError, match="needs 2 processes"):
        PS.make_train_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="coordinator address"):
        PD.initialize_distributed(coordinator="127.0.0.1:1", device="cpu")


MESH_CASES = [(8, 1, 4, 1), (8, 2, 4, 1), (8, 1, 3, 1), (8, 1, 4, 2), (8, 1, 2, 2),
              (8, 3, 4, 1), (1, 1, 4, 1), (2, 1, 4, 2), (2, 2, 4, 2), (4, 2, 3, 4)]


@pytest.mark.parametrize("case", MESH_CASES)
def test_choose_mesh_axes_matches_jax(case):
    from clap2diffusion_tpu.train.trainer import choose_mesh_axes as jax_choose

    outcomes = []
    for fn in (PT.choose_mesh_axes, jax_choose):
        try:
            outcomes.append(fn(*case))
        except ValueError as e:
            outcomes.append(re.sub(r"\s+", " ", str(e)))
    assert outcomes[0] == outcomes[1]


_RULES = {"unet": "_UNET_RULES", "clip_text": "_CLIP_RULES", "clap_audio": "_CLAP_RULES",
          "hierarchical": "_HIER_RULES", "adapter": "_ADAPTER_RULES", "vae": "_VAE_RULES"}


def _jax_sharded(cfg, width, monkeypatch):
    """The torch names of the leaves JAX's param_spec model-shards, through
    the converters' renaming rules (shapes only: jax.eval_shape)."""
    from clap2diffusion_tpu.diffusion.pipeline import init_params as jax_init

    monkeypatch.setattr(JS, "TP_MIN_WIDTH", width)
    shapes = jax.eval_shape(functools.partial(jax_init, cfg, 0))
    out = {}
    for tower, rules_name in _RULES.items():
        names = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[tower])[0]:
            if "model" not in str(JS.param_spec(path, leaf)):
                continue
            flat = "/".join(str(getattr(k, "key", k)) for k in path)
            for pat, rep in getattr(PC, rules_name):
                flat = re.sub(pat, rep, flat)
            names.add(PC._leaf(flat, np.zeros((1, 1)))[0])
        out[tower] = names
    return out


@pytest.mark.parametrize("width", ["full", "tiny"])
def test_param_spec_selects_the_jax_tensors(width, monkeypatch):
    """At TP_MIN_WIDTH 2048 on the full-width towers (the UNet's GEGLU
    projections, the adapter's KV head and to_qkv, CLIP text's and HTSAT's
    wide MLPs; no weights are drawn) and at 64 on the tiny config: the
    port's sharded weights are JAX's, by name through the converters."""
    from clap2diffusion_tpu.core.config import Config as JConfig

    jcfg, w = (JConfig(), 2048) if width == "full" else (tiny_config(), 64)
    want = _jax_sharded(jcfg, w, monkeypatch)
    monkeypatch.setattr(PS, "TP_MIN_WIDTH", w)
    with torch.device("meta"):
        mods = P.build_modules(port_cfg(jcfg))
    got = {tw: set(PS.sharded_leaves(mods[tw])) for tw in _RULES}
    assert got == want
    assert sum(map(len, got.values())) == (35 if width == "full" else 18)
    if width == "full":  # the adapter's 256 -> 24,576 KV head; an FFN down-projection is not
        assert "token_generator.audio_to_kv.3.weight" in got["adapter"]
        assert not any("ff.net.2" in n for n in got["unet"])


# -- the 2-process launches -------------------------------------------------------------


def _one_update(single, mode):
    base, params = single
    cfg = C.apply_overrides(base, UPDATE_OVERRIDES)
    mesh = PS.make_train_mesh()
    st, state, _ = PT.stage_state(cfg, 2, params, mesh, torch.device("cpu"), 0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    metrics = PSt.train_step(st, state, batch, torch.Generator().manual_seed(UPDATE_SEED))
    return ({k: float(v) for k, v in metrics.items()},
            {k: t.detach() for k, t in state.trainable_leaves().items()})


@pytest.mark.parametrize("mode", ["data", "model"])
def test_two_process_update_matches_single_process(launches, single, mode):
    """One stage-2 update at data=2 (each rank 4 of the 8 samples, its rows
    of the draws) and at model=2 (TP_MIN_WIDTH 64): both ranks' losses and
    updated parameters within the JAX test's bounds of one process's."""
    ranks = launches[0][mode]
    want_m, want_p = _one_update(single, mode)
    assert bool(ranks[0]["sharded"]) == (mode == "model")
    for r in ranks:
        for k, v in want_m.items():
            assert r["update_metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
        assert set(r["update_params"]) == set(want_p)
        for k, v in want_p.items():
            np.testing.assert_allclose(r["update_params"][k].numpy(), v.numpy(), rtol=2e-4,
                                       atol=1e-5, err_msg=k)
    assert ranks[0]["update_metrics"] == ranks[1]["update_metrics"]


def test_run_stage_data_parallel_global_batch_and_replicas(launches):
    """run_stage at data=2: each rank reads batch_size (2) samples a step,
    disjoint from the other's (the port's global batch is batch_size x data
    ranks, ROADMAP known delta 20); both ranks report the same losses and
    hold bit-identical parameters; the coordinator alone wrote the logs."""
    ranks, roots, tmp = launches
    r0, r1 = ranks["data"]
    assert len(r0["run_ids"]) == len(r1["run_ids"]) == 2
    for a, b in zip(r0["run_ids"], r1["run_ids"]):
        assert len(a) == len(b) == 2 and not set(a) & set(b)
    assert r0["run_losses"] == r1["run_losses"]
    for k, t in r0["run_params"].items():
        assert torch.equal(t, r1["run_params"][k]), k
    assert os.path.exists(tmp / "data" / "logs0" / "stage2.jsonl")
    assert not os.path.exists(tmp / "data" / "logs1")
    assert ckpt.load_payload(str(tmp / "data" / "ck"), "stage2_final")["step"] == 2
    # validation at step 2 ran on both ranks (a collective) and was logged once
    with open(tmp / "data" / "logs0" / "stage2.jsonl") as f:
        assert any("val_total" in json.loads(line) for line in f)


def test_run_stage_signal_to_one_rank_preempts_both(launches):
    """A SIGTERM to rank 1 alone during its first micro-step of a data=2
    run_stage: the ranks agree on it after that micro-step, so both save
    ``stage2_preempt`` at step 1 (a collective) and both re-raise SIGTERM;
    neither runs a second micro-step, and the coordinator logs it once."""
    import signal

    ranks, _, tmp = launches
    for r in ranks["data"]:
        assert r["preempted"] == signal.SIGTERM and r["preempt_steps"] == 1
    assert ckpt.load_payload(str(tmp / "data" / "ck_sig"), "stage2_preempt")["step"] == 1
    assert not os.path.exists(tmp / "data" / "ck_sig" / "stage2_final")
    with open(tmp / "data" / "logs_sig0" / "stage2.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [e.get("preempted_by_signal") for e in logged if "preempted_by_signal" in e] == \
        [float(signal.SIGTERM)]
    assert not os.path.exists(tmp / "data" / "logs_sig1")


def test_request_draws_rows_are_the_batch_rows():
    """``RequestDraws(rows=(index, count))``: each scalar-seeded draw of
    [b, ...] is rows [index * b, (index + 1) * b) of the whole batch's draw,
    the latents and every sampler step alike; per-lane seeds refuse rows."""
    whole = P.RequestDraws("cpu", 3)
    parts = [P.RequestDraws("cpu", 3, rows=(i, 2)) for i in (0, 1)]
    shape = (2, 4, 4, 4)
    want = whole.latents((4, 4, 4, 4))
    for i, d in enumerate(parts):
        assert torch.equal(d.latents(shape), want[2 * i:2 * i + 2])
        assert torch.equal(d.vae(shape), whole.vae((4, 4, 4, 4))[2 * i:2 * i + 2])
    draws = [whole.sampler()] + [d.sampler() for d in parts]
    for step in range(2):
        w, a, b = (fn(step, (4,) + shape[1:]) if k == 0 else fn(step, shape)
                   for k, fn in enumerate(draws))
        assert torch.equal(torch.cat([a, b]), w)
    with pytest.raises(ValueError, match="per-lane seeds"):
        P.RequestDraws("cpu", 3, seeds=[1, 2], rows=(0, 2))


def test_run_stage_model_parallel_matches_single_process(launches, single, tmp_path):
    """run_stage at model=2 (TP_MIN_WIDTH 64) against one process on the
    same data: losses and the gathered checkpoint within the JAX bounds;
    the resume from it (each rank slicing its rows) too."""
    ranks, roots, tmp = launches
    base, params = single
    r0, r1 = ranks["model"]
    cfg = C.apply_overrides(base, RUN_OVERRIDES)
    ck = str(tmp_path / "ck")
    losses, inner = [], PT.train_step

    def record(*a, **kw):
        m = inner(*a, **kw)
        losses.append({k: float(v) for k, v in m.items()})
        return m

    PT.train_step = record
    try:
        PT.run_stage(cfg, 2, params, data_root=roots["model"], max_steps=2, checkpoint_dir=ck,
                     log_dir=str(tmp_path), device="cpu")
        run_losses = list(losses)
        losses.clear()
        PT.run_stage(cfg, 2, params, data_root=roots["model"], max_steps=3, checkpoint_dir=ck,
                     log_dir=str(tmp_path), device="cpu", resume_from="stage2_final")
    finally:
        PT.train_step = inner
    for got, want in ((r0["run_losses"], run_losses), (r0["resume_losses"], losses)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert r0["run_losses"] == r1["run_losses"]
    got = ckpt.load_payload(str(tmp / "model" / "ck"), "stage2_final")
    want = ckpt.load_payload(ck, "stage2_final")
    for tw, sd in want["params"].items():
        for n, t in sd.items():
            np.testing.assert_allclose(got["params"][tw][n].numpy(), t.numpy(), rtol=2e-4,
                                       atol=1e-5, err_msg=f"{tw}.{n}")
    for part in ("mu", "nu"):
        for k, t in want["opt_state"][part].items():
            assert got["opt_state"][part][k].shape == t.shape, k


def _image_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert float(diff.mean()) < 0.5 and int(diff.max()) <= 8, (diff.mean(), diff.max())


def test_generate_sharded_model_parallel_matches_generate(launches, single):
    """shard_pipeline_for_serving at model=2 (TP_MIN_WIDTH 64: each rank
    holds half of every wide layer's rows) and generate_sharded: both ranks'
    images within the JAX bounds of the unsharded generate."""
    base, params = single
    ranks = launches[0]["model"]
    assert ranks[0]["tp_rows"] == 64  # the GEGLU projection's 128 rows, halved
    wavs, ids = _wavs()
    pipe = P.AudioToImagePipeline(base, params=params, device="cpu")
    want = pipe.generate(wavs, ids, ids, num_steps=2, seed=GEN_SEED, batch=2)
    for r in ranks:
        _image_close(r["gen_model"], want)


def test_generate_sharded_data_parallel_matches_generate(launches, single):
    """At data=2 each rank runs one lane: without seeds its rows of the
    batch's draws (generate(batch=2)'s images), with seeds each lane's
    own; both ranks return both images."""
    base, params = single
    r0, r1 = launches[0]["data"]
    wavs, ids = _wavs()
    pipe = P.AudioToImagePipeline(base, params=params, device="cpu")
    for key, kw in (("gen_data", {}), ("gen_data_seeds", {"seeds": np.array([5, 9])})):
        want = pipe.generate(wavs, ids, ids, num_steps=2, seed=GEN_SEED, batch=2, **kw)
        np.testing.assert_array_equal(r0[key], r1[key])
        _image_close(r0[key], want)
    solo = pipe.generate(wavs[1:], ids[1:], ids[1:], num_steps=2, seed=GEN_SEED, seeds=[9])
    _image_close(r0["gen_data_seeds"][1:], solo)


def test_run_evaluation_shard_matches_per_lane_seed_images(launches, single):
    """run_evaluation(shard=True) over 2 data ranks: 3 samples in groups of
    2 (the tail padded with its last sample), each image that of one
    process's generate(seeds=[eval seed]) on its sample."""
    from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    base, params = single
    ranks, roots, _ = launches
    r0, r1 = ranks["data"]
    np.testing.assert_array_equal(r0["eval_images"], r1["eval_images"])
    assert r0["eval_images"].shape[0] == 4 and len(r0["eval_samples"]) == 3
    ds = AudioCapsLatentDataset(roots["data"], split="test",
                                audio_duration=base.data.duration_s, latent_hw=8)
    tok = CLIPTokenizer(max_length=base.diffusion.clip_text.max_length)
    pipe = P.AudioToImagePipeline(base, params=params, device="cpu")
    for i in range(3):
        item = ds[i]
        want = pipe.generate(item["audio"], tok(item["caption"]), tok(""), num_steps=2,
                             seed=EVAL_SEED, seeds=[EVAL_SEED])
        _image_close(r0["eval_images"][i:i + 1], want)
        assert r0["eval_samples"][i]["id"] == item["audio_id"]


def test_cli_train_coordinator_and_evaluate_shard(launches):
    """``train --coordinator --num-processes 2 --process-id I --device cpu``
    and then ``evaluate --shard`` in the same two processes: the coordinator
    alone writes the checkpoint and the evaluation file, and its images are
    those of the per-lane seed (the evaluate CLI's seed, 42)."""
    _, roots, tmp = launches
    payload = ckpt.load_payload(str(tmp / "cli" / "ck"), "stage2_final")
    assert payload["step"] == 2
    with open(tmp / "cli" / "logs" / "stage2.jsonl") as f:  # the config's log_dir
        assert len(f.readlines()) >= 1
    assert os.path.exists(tmp / "cli" / "eval0.json")
    assert not os.path.exists(tmp / "cli" / "eval1.json")
    with open(tmp / "cli" / "eval0.json") as f:
        res = json.load(f)
    assert res["config"]["shard"] is True and res["config"]["n"] == 3
    assert len(res["samples"]) == 3 and all(np.isfinite(r["audio_text_alignment"])
                                            for r in res["samples"])
