"""The port's entry points on the CPU, against the JAX package where it
has the same one.

- the whole slice: the same synthetic published-layout artifacts (diffusers
  UNet and VAE, transformers CLIP text, an HF ClapModel with its audio and
  text towers, the reference's nested hierarchical and adapter ``.pth``)
  through the JAX ``tools/convert_checkpoints.py`` and its
  ``load_pipeline``, and through the port's converter tool and its
  ``load_pipeline``: every tower equals ``convert.from_flax`` of the JAX
  tree exactly (the UNet's audio-injection branches apart, which each tool
  draws at random from its own generator), and one tiny request each, with
  the JAX draws fed to the port and the JAX branches to its UNet, falls
  within ``tests/test_torch_generate.py``'s golden bounds;
- the converter's evaluation slots (``--clip-vision``, ``--inception``)
  against the JAX tool on the same synthetic artifacts;
- the CLI: ``infer`` writes the PNG of ``pipe.generate``'s bits (a
  checkpoint, ``--audio-dir``, ``--stage-checkpoint --ema``) and ``infer
  --best-of 2`` the winner of ``generate_best_of``, ``evaluate`` writes
  ``run_evaluation``'s results, ``export`` round-trips and equals the JAX
  export of the same weights, and what is not ported exits non-zero naming
  its ROADMAP item;
- the server at 2 steps: ``/generate``, ``/generate_batch``, ``/healthz``,
  ``/metrics``, a coalesced group of three padded to four against
  ``generate(seeds=..., batch=4)[:3]``, ``best_of > 1`` answering 400
  without the CLIP vision towers and the winner of ``generate_best_of``
  with them, and the standard-library PNG encoder's output decoded with
  zlib;
- ``gradio_app.build_generator`` (the click handler) without gradio, best-of
  included.

The geometry is ``tests/test_pipeline.py::tiny_config``, in fp32 where not
said; the whole-slice config has 4 projector and 4 adapter layers, the
counts the JAX converters read.
"""

import base64
import dataclasses
import importlib.util
import io
import json
import os
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch
import yaml

from clap2diffusion_tpu.core.config import load_config as jax_load_config
from clap2diffusion_tpu.diffusion.pipeline import init_params as jax_init_params
from clap2diffusion_tpu.diffusion.pipeline import load_pipeline as jax_load_pipeline
from clap2diffusion_tpu.models.condition import export as jexp
from clap2diffusion_tpu_torch import convert as bridge
from clap2diffusion_tpu_torch.apps import main as M
from clap2diffusion_tpu_torch.apps.server import InferenceService, serve
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.models.condition import convert as pcond
from clap2diffusion_tpu_torch.models.convert import template
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.tools import convert_checkpoints as port_tool
from clap2diffusion_tpu_torch.train import checkpoint as ckpt
from clap2diffusion_tpu_torch.utils.audio_io import write_wav
from clap2diffusion_tpu_torch.utils.png import decode_png, encode_png
from clap2diffusion_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors
from tests.golden_utils import synth_value
from tests.test_pipeline import tiny_config
from tests.test_torch_eval import clap_model_sd, clip_model_sd, eval_config
from tests.test_torch_generate import JaxDraws
from tests.test_torch_trainer import OVERRIDES
from tests.test_torch_weights_io import _clap_sd, _clip_sd, _unet_sd, _vae_sd

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
    return path


def wav_file(path, seed, n=24_000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000
    write_wav(path, (0.4 * np.sin(2 * np.pi * (200 + 50 * seed) * t)
                     + 0.05 * rng.normal(size=n)).astype(np.float32), 48_000)
    return path


def png_pixels_by_zlib(data: bytes) -> np.ndarray:
    """An RGB PNG with unfiltered rows, decoded by hand: chunks, zlib, rows."""
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            assert body[8:10] == b"\x08\x02"  # 8-bit RGB
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny config (JAX and port) as YAML, and a port pipeline from a
    saved checkpoint of it."""
    d = tmp_path_factory.mktemp("apps")
    cfg = tiny_config()
    path = write_yaml(str(d / "tiny.yaml"), cfg)
    pcfg = C.load_config(path)
    ck = P.save_pipeline(str(d / "ck"), P.init_params(pcfg, seed=5, device="cpu"))
    return cfg, pcfg, path, ck, d


# -- the whole slice against JAX -------------------------------------------------

def _slice_artifacts(d, cfg, pcfg):
    from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
    from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioEncoder

    paths = {k: str(d / name) for k, name in (
        ("sd_unet", "unet.safetensors"), ("sd_vae", "vae.bin"),
        ("clip_text", "text_encoder.safetensors"), ("clap", "clap.bin"),
        ("hierarchical", "hierarchical_v4_final.pth"),
        ("adapter", "audio_projector_stage2.pth"))}
    save_safetensors(paths["sd_unet"], _unet_sd(cfg))
    torch.save(_vae_sd(pcfg), paths["sd_vae"])
    save_safetensors(paths["clip_text"], _clip_sd(pcfg))
    # an HF ClapModel: its audio tower and its whole text tower
    torch.save({**_clap_sd(pcfg), **clap_model_sd(pcfg)}, paths["clap"])
    hier = {k: torch.from_numpy(synth_value("hier", k, tuple(s))) for k, s in
            template(HierarchicalAudioEncoder, pcfg.condition).items()}
    hier["decomposer.level_prior"] = torch.tensor([0.5, 0.3, 0.2])
    hier["decomposer.temperature"] = torch.tensor(2.0)
    torch.save({"step": 7, "hierarchical_state_dict": hier, "optimizer_state_dict": {}},
               paths["hierarchical"])
    adapter = {k: torch.from_numpy(synth_value("adapter", k, tuple(s))) for k, s in
               template(AudioAdapter, pcfg.condition).items()}
    torch.save({"adapter_state_dict": adapter}, paths["adapter"])
    return paths


def test_whole_slice_matches_jax(tmp_path, monkeypatch, capsys):
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, condition=dataclasses.replace(
        cfg.condition, projector_layers=4, adapter_self_attn_layers=4))
    yml = write_yaml(str(tmp_path / "slice.yaml"), cfg)
    jcfg, pcfg = jax_load_config(yml), C.load_config(yml)
    paths = _slice_artifacts(tmp_path, cfg, pcfg)
    flags = [a for k, p in paths.items() for a in (f"--{k.replace('_', '-')}", p)]

    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoints", os.path.join(ROOT, "tools", "convert_checkpoints.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    jout = str(tmp_path / "jax_ckpt")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoints", *flags, "--out", jout,
                                      "--config", yml])
    assert jtool.main() == 0
    pout = str(tmp_path / "port_ckpt")
    assert port_tool.main([*flags, "--out", pout, "--config", yml, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "clap_text" in out and "random init kept" not in out

    jpipe = jax_load_pipeline(jcfg, jout)
    want = bridge.from_flax(jax.tree.map(np.asarray, jpipe.params))
    ppipe = P.load_pipeline(pcfg, pout, device="cpu")
    got = ppipe.params
    assert sorted(got) == sorted(want) and "clap_text" in want
    # the CLAP text tower converted from --clap, as the JAX tool converts it
    assert sorted(ppipe.extra_params) == ["clap_text"]
    for tower in want:
        assert sorted(got[tower]) == sorted(want[tower]), tower
        for k, t in want[tower].items():
            if not k.startswith("audio_inject."):
                assert torch.equal(got[tower][k], t), (tower, k)

    # the UNet's random injection branches come from each tool's own
    # generator: give the port JAX's, and the JAX draws, for one request
    params = got
    params["unet"] = {**params["unet"], **{k: t for k, t in want["unet"].items()
                                           if k.startswith("audio_inject.")}}
    same = P.AudioToImagePipeline(pcfg, params=params, device="cpu")
    monkeypatch.setattr(same, "draws", lambda seed, seeds=None: JaxDraws(seed, seeds))
    kw = dict(waveform=(np.random.default_rng(2).normal(size=24_000) * 0.1).astype(np.float32),
              text_ids=(np.arange(7)[None] % 97).astype(np.int32), num_steps=3, seed=4)
    a, b = same.generate(**kw), jpipe.generate(**kw)
    assert a.shape == b.shape == (1, 64, 64, 3) and a.dtype == np.uint8 and a.std() > 0
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert float(diff.mean()) < 0.5 and float((diff > 2).mean()) < 0.01, (
        f"mean|d|={diff.mean():.3f}, >2 {(diff > 2).mean():.2%}")


# -- the CLI -----------------------------------------------------------------------

def _tok():
    return CLIPTokenizer(max_length=7)


def test_cli_infer_checkpoint_writes_generate_bits(tiny, tmp_path):
    _, pcfg, yml, ck, _ = tiny
    audio = wav_file(str(tmp_path / "a.wav"), 1)
    out = str(tmp_path / "out.png")
    assert M.main(["infer", "--config", yml, "--checkpoint", ck, "--audio", audio,
                   "--text", "rain on a roof", "--steps", "2", "--seed", "3",
                   "--output", out, "--device", "cpu"]) == 0
    pipe = P.load_pipeline(pcfg, ck, dtype=torch.bfloat16, device="cpu")  # --dtype's default
    want = pipe.generate(waveform=pipe.load_audio(audio), text_ids=_tok()("rain on a roof"),
                         uncond_ids=_tok()(""), num_steps=2, seed=3)
    with open(out, "rb") as f:
        assert np.array_equal(decode_png(f.read()), want[0])


def test_cli_infer_audio_dir(tiny, tmp_path, capsys):
    _, pcfg, yml, ck, _ = tiny
    d = tmp_path / "wavs"
    d.mkdir()
    files = [wav_file(str(d / f"{n}.wav"), s) for n, s in (("dog", 2), ("rain", 3))]
    out = str(tmp_path / "img.png")
    assert M.main(["infer", "--config", yml, "--checkpoint", ck, "--audio-dir", str(d),
                   "--steps", "2", "--output", out, "--device", "cpu",
                   "--dtype", "float32"]) == 0
    assert "throughput" in capsys.readouterr().out
    pipe = P.load_pipeline(pcfg, ck, dtype=torch.float32, device="cpu")
    for path in files:
        stem = os.path.splitext(os.path.basename(path))[0]
        want = pipe.generate(waveform=pipe.load_audio(path), text_ids=_tok()(""),
                             uncond_ids=_tok()(""), num_steps=2, seed=0)
        with open(out.replace(".png", f"_{stem}.png"), "rb") as f:
            assert np.array_equal(decode_png(f.read()), want[0]), stem


def test_cli_stage_checkpoint_ema_and_export(tiny, tmp_path):
    from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
    from clap2diffusion_tpu_torch.train.trainer import run_stage

    _, pcfg, yml, _, _ = tiny
    root, ckdir = str(tmp_path / "data"), str(tmp_path / "ck")
    make_fixture_dataset(root, n_train=2, n_val=0, n_test=0, duration_s=0.5, latent_hw=8)
    tcfg = C.apply_overrides(pcfg, OVERRIDES + ["train.stage2.eval_every=0"])
    run_stage(tcfg, 2, P.init_params(tcfg, seed=0, device="cpu"), data_root=root, max_steps=2,
              checkpoint_dir=ckdir, log_dir=str(tmp_path / "logs"), device="cpu")
    stage = os.path.join(ckdir, "stage2_final")
    out = str(tmp_path / "ema.png")
    assert M.main(["infer", "--config", yml, "--stage-checkpoint", stage, "--ema",
                   "--steps", "2", "--seed", "1", "--output", out, "--device", "cpu"]) == 0
    payload = ckpt.load_payload(ckdir, "stage2_final")
    base = P.AudioToImagePipeline(pcfg, seed=1, dtype=torch.bfloat16, device="cpu")
    merged = ckpt.merge_stage_params(base.params, payload, 2, use_ema=True, dtype=torch.bfloat16)
    name = "audio_inject.mid.audio_proj.3.weight"
    assert torch.equal(merged["unet"][name],
                       payload["ema_params"][f"unet.{name}"].to(torch.bfloat16))
    want = P.AudioToImagePipeline(pcfg, params=merged, device="cpu").generate(
        text_ids=_tok()(""), uncond_ids=_tok()(""), num_steps=2, seed=1)
    with open(out, "rb") as f:
        assert np.array_equal(decode_png(f.read()), want[0])

    # the EMA weights exported and read back through the converter
    st = str(tmp_path / "ema.safetensors")
    assert M.main(["export", "--stage-checkpoint", stage, "--out", st, "--ema"]) == 0
    flat = load_safetensors(st)
    hier = {k[len("hierarchical."):]: v for k, v in flat.items()
            if k.startswith("hierarchical.")}
    shadow = ckpt.merge_stage_params({}, payload, 2, use_ema=True)["hierarchical"]
    back = pcond.convert_hierarchical_encoder(hier, pcfg.condition)
    assert sorted(back) == sorted(shadow)
    assert all(torch.equal(back[k], shadow[k].float()) for k in shadow)


def _write_payload(path, params, step=11):
    os.makedirs(path, exist_ok=True)
    torch.save({"params": params, "opt_state": {}, "step": step, "ema_params": None},
               os.path.join(path, "state.pt"))


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_export_matches_jax(tiny, tmp_path, stage):
    cfg = tiny[0]
    jparams = jax.tree.map(np.asarray, jax_init_params(cfg, seed=0))
    ported = bridge.from_flax(jparams)
    if stage == 1:
        trained = {"adapter": ported["adapter"]}
        want = {"adapter_state_dict": jexp.export_audio_adapter(jparams["adapter"])}
    else:
        trained = {"hierarchical": ported["hierarchical"],
                   "unet": {k: t for k, t in ported["unet"].items() if "audio_inject" in k}}
        want = {"hierarchical_state_dict":
                jexp.export_hierarchical_encoder(jparams["hierarchical"]),
                "unet_adapter_state_dict": jexp.export_injection_processors(jparams["unet"])}
    stage_dir = str(tmp_path / f"stage{stage}_final")
    _write_payload(stage_dir, trained)
    pth, st = str(tmp_path / "out.pth"), str(tmp_path / "out.safetensors")
    assert M.main(["export", "--stage-checkpoint", stage_dir, "--out", pth]) == 0
    assert M.main(["export", "--stage-checkpoint", stage_dir, "--out", st]) == 0

    nested = ckpt.load_torch_checkpoint(pth)
    assert nested["step"] == 11
    flat = load_safetensors(st)
    for sec, tensors in want.items():
        prefix = sec.removesuffix("_state_dict") + "."
        assert sorted(nested[sec]) == sorted(tensors)
        assert sorted(k for k in flat if k.startswith(prefix)) == sorted(prefix + k
                                                                        for k in tensors)
        for k, v in tensors.items():
            np.testing.assert_array_equal(nested[sec][k].numpy(), v, err_msg=k)
            np.testing.assert_array_equal(flat[prefix + k].numpy(), v, err_msg=k)
    if stage == 2:  # and back through the converter to the tower
        back = pcond.convert_hierarchical_encoder(
            pcond.unwrap(nested, "hierarchical_state_dict"), tiny[1].condition)
        assert all(torch.equal(back[k], ported["hierarchical"][k]) for k in back)
        assert sorted(back) == sorted(ported["hierarchical"])


UNPORTED = {
    "evaluate_shard": (["evaluate", "--shard", "--data-root", "x"], "item 9"),
    "prepare_csv": (["prepare", "--csv", "x.csv", "--out", "x"], "item 8"),
    "train_coordinator": (["train", "--stage", "2", "--coordinator", "h:1", "--device", "cpu"],
                          "item 9"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_cli_unported_exits_naming_its_item(name):
    argv, item = UNPORTED[name]
    with pytest.raises(SystemExit, match=item) as e:
        M.main(argv)
    assert e.value.code not in (0, None)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoints", os.path.join(ROOT, "tools", "convert_checkpoints.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    return jtool


@pytest.mark.parametrize("slot", ["--clip-vision", "--inception"])
def test_convert_tool_eval_slots_match_jax(tmp_path, monkeypatch, slot):
    """The same synthetic artifact (a whole CLIPModel .safetensors; a
    torchvision inception_v3 .pth with its aux head and num_batches_tracked)
    through both tools: the towers equal ``from_flax`` of JAX's, exactly."""
    from tests.test_inception import synthetic_torch_state_dict

    cfg = eval_config()
    yml = write_yaml(str(tmp_path / "eval.yaml"), cfg)
    pcfg = C.load_config(yml)
    if slot == "--clip-vision":
        art = str(tmp_path / "clip.safetensors")
        save_safetensors(art, clip_model_sd(pcfg))
        towers = ["clip_vision", "clip_text_projection"]
    else:
        art = str(tmp_path / "inception.pth")
        torch.save({k: torch.as_tensor(v) for k, v in synthetic_torch_state_dict().items()}, art)
        towers = ["inception_v3"]
    jout, pout = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoints", slot, art, "--out", jout,
                                      "--config", yml])
    assert _jax_tool().main() == 0
    assert port_tool.main([slot, art, "--out", pout, "--config", yml, "--device", "cpu"]) == 0
    want = bridge.from_flax(jax.tree.map(np.asarray, jax_load_pipeline(
        jax_load_config(yml), jout).params))
    got = P.load_pipeline(pcfg, pout, device="cpu").extra_params
    assert sorted(got) == sorted(towers)
    for tower in towers:
        assert sorted(got[tower]) == sorted(want[tower]), tower
        for k, t in want[tower].items():
            assert torch.equal(got[tower][k], t), (tower, k)


@pytest.fixture(scope="module")
def eval_ck(tmp_path_factory):
    """The tiny config with a tiny CLIP vision tower, as YAML, and a
    checkpoint of it with every evaluation tower (converted from synthetic
    published-layout dicts by the port's converters), on a fixture dataset
    of three test samples with PNG reference frames."""
    from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
    from clap2diffusion_tpu_torch.models.clap.convert import convert_clap_text
    from clap2diffusion_tpu_torch.models.clip_vision import (
        convert_clip_text_projection,
        convert_clip_vision,
    )
    from clap2diffusion_tpu_torch.models.inception_v3 import convert_inception_v3
    from tests.test_inception import synthetic_torch_state_dict

    d = tmp_path_factory.mktemp("eval_apps")
    yml = write_yaml(str(d / "eval.yaml"), eval_config())
    pcfg = C.load_config(yml)
    clip = clip_model_sd(pcfg)
    params = {**P.init_params(pcfg, seed=5, device="cpu"),
              "clip_vision": convert_clip_vision(clip, pcfg.diffusion.clip_vision),
              "clip_text_projection": convert_clip_text_projection(clip),
              "clap_text": convert_clap_text(clap_model_sd(pcfg), pcfg.clap.text),
              "inception_v3": convert_inception_v3(synthetic_torch_state_dict())}
    ck = P.save_pipeline(str(d / "ck"), params)
    root = str(d / "data")
    meta = make_fixture_dataset(root, n_train=1, n_val=1, n_test=3, duration_s=0.5,
                                latent_hw=8)
    os.makedirs(os.path.join(root, "frames"))
    rng = np.random.default_rng(7)
    for smp in meta["samples"]:
        with open(os.path.join(root, "frames", f"{smp['id']}.png"), "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)))
    return pcfg, yml, ck, root


def test_cli_evaluate_writes_run_evaluation(eval_ck, tmp_path, capsys):
    from clap2diffusion_tpu_torch.eval.evaluate import run_evaluation

    pcfg, yml, ck, root = eval_ck
    out = str(tmp_path / "results.json")
    assert M.main(["evaluate", "--config", yml, "--checkpoint", ck, "--data-root", root,
                   "--max-samples", "3", "--steps", "2", "--fid-variant", "pytorch_fid",
                   "--output", out, "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    with open(out) as f:
        got = json.load(f)
    want = run_evaluation(pcfg, data_root=root, max_samples=3, num_steps=2,
                          params=P.load_pipeline(pcfg, ck, device="cpu").params,
                          fid_variant="pytorch_fid", device="cpu")
    assert got["clap_text_random_init"] is False and got["summary"]["fid_variant"] == "pytorch_fid"
    for key in ("audio_text_alignment", "clip_score", "image_std"):
        assert got["summary"][key] == want["summary"][key], key
    for key in ("fid", "frechet_clip_vision", "kid", "inception_score"):
        assert got["summary"][key] == want["summary"][key], key
    assert [r["id"] for r in got["samples"]] == [r["id"] for r in want["samples"]]


def test_cli_infer_best_of_writes_the_winner(eval_ck, tmp_path, capsys):
    pcfg, yml, ck, _ = eval_ck
    audio = wav_file(str(tmp_path / "a.wav"), 1)
    out = str(tmp_path / "best.png")
    assert M.main(["infer", "--config", yml, "--checkpoint", ck, "--audio", audio,
                   "--text", "rain on a roof", "--steps", "2", "--seed", "3", "--best-of", "2",
                   "--dtype", "float32", "--output", out, "--device", "cpu"]) == 0
    assert "best of 2" in capsys.readouterr().out
    pipe = P.load_pipeline(pcfg, ck, dtype=torch.float32, device="cpu")
    tok = _tok()
    best, scores = pipe.generate_best_of(2, waveform=pipe.load_audio(audio),
                                         text_ids=tok("rain on a roof"), uncond_ids=tok(""),
                                         num_steps=2, seed=3)
    with open(out, "rb") as f:
        assert np.array_equal(decode_png(f.read()), best)
    with pytest.raises(SystemExit, match="--text is required"):
        M.main(["infer", "--config", yml, "--checkpoint", ck, "--best-of", "2", "--steps", "1",
                "--device", "cpu"])


def test_cli_defaults_to_cuda_and_prepares_fixtures(tiny, tmp_path):
    yml = tiny[2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.main(["infer", "--config", yml, "--steps", "1", "--output", str(tmp_path / "x.png")])
    assert M.main(["prepare", "--create-sample", "--out", str(tmp_path / "fx"),
                   "--n-train", "2", "--n-val", "1", "--n-test", "0"]) == 0
    with open(tmp_path / "fx" / "metadata_unified.json") as f:
        assert len(json.load(f)["samples"]) == 3


# -- the server --------------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server_pipe(tiny):
    _, pcfg, _, ck, _ = tiny
    return P.load_pipeline(pcfg, ck, device="cpu")


def _running(service):
    server = serve(service=service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_server_endpoints(server_pipe, tmp_path):
    pipe = server_pipe
    server, thread = _running(InferenceService(pipe=pipe))
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert r.read() == b"ok"
        path = wav_file(str(tmp_path / "a.wav"), 4)
        with open(path, "rb") as f:
            audio = base64.b64encode(f.read()).decode()
        out = _post(port, "/generate", {"audio_b64": audio, "text": "a dog barks", "steps": 2,
                                        "seed": 3})
        png = base64.b64decode(out["image_b64"])
        tok, wav = _tok(), pipe.load_audio(path)
        want = pipe.generate(waveform=wav, text_ids=tok("a dog barks"), uncond_ids=tok(""),
                             num_steps=2, seed=3)
        assert np.array_equal(decode_png(png), want[0])
        assert np.array_equal(png_pixels_by_zlib(png), want[0])
        assert out["info"]["steps"] == 2 and out["info"]["fetch_wait_s"] >= 0

        out = _post(port, "/generate_batch", {
            "requests": [{"audio_b64": audio, "text": "wind", "seed": 7},
                         {"audio_b64": audio, "text": "wind", "seed": 5}], "steps": 2})
        # one sound in every lane: encoded once, as generate does with one waveform
        want = pipe.generate(waveform=wav, text_ids=tok(["wind", "wind"]),
                             uncond_ids=tok(["", ""]), num_steps=2, batch=2, seeds=[7, 5])
        assert out["info"]["seeds"] == [7, 5] and out["info"]["batch"] == 2
        for b64, w in zip(out["images_b64"], want):
            assert np.array_equal(decode_png(base64.b64decode(b64)), w)
        other = wav_file(str(tmp_path / "b.wav"), 6)
        with open(other, "rb") as f:
            audio2 = base64.b64encode(f.read()).decode()
        out = _post(port, "/generate_batch", {
            "requests": [{"audio_b64": audio, "text": "wind"},
                         {"audio_b64": audio2, "text": "wind"}], "steps": 2, "seed": 9})
        want = pipe.generate(waveform=np.stack([wav, pipe.load_audio(other)]),
                             text_ids=tok(["wind", "wind"]), uncond_ids=tok(["", ""]),
                             num_steps=2, batch=2, seed=9)
        assert "seeds" not in out["info"]
        for b64, w in zip(out["images_b64"], want):
            assert np.array_equal(decode_png(base64.b64decode(b64)), w)

        with pytest.raises(urllib.error.HTTPError) as e:  # no CLIP vision towers here
            _post(port, "/generate", {"text": "x", "steps": 2, "best_of": 2})
        assert e.value.code == 400 and "needs the CLIP vision weights" in json.loads(
            e.value.read())["error"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["requests"] == 4 and m["errors"] == 1 and m["images"] == 5
        assert m["latency_s"]["count"] == 3 and m["latency_s"]["p50"] > 0
    finally:
        _stop(server, thread)


def test_server_coalesces_three_requests_into_a_group_of_four(server_pipe):
    pipe = server_pipe
    service = InferenceService(pipe=pipe, coalesce_ms=2000, coalesce_max_batch=4)
    server, thread = _running(service)
    port = server.server_address[1]
    reqs = [("a dog barks", 3), ("rain falls", 11), ("a car engine", 4)]
    results = {}

    def post(text, seed):
        results[text] = _post(port, "/generate", {"text": text, "steps": 2, "seed": seed})

    try:
        threads = [threading.Thread(target=post, args=r) for r in reqs]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            m = json.loads(r.read())
    finally:
        _stop(server, thread)
    assert m["coalesce"] == {"batches": 1, "images": 3, "mean_batch": 3.0}
    lanes = sorted(reqs, key=lambda r: results[r[0]]["info"]["coalesced_lane"])
    assert [results[t]["info"]["coalesced_lane"] for t, _ in lanes] == [0, 1, 2]
    assert all(results[t]["info"]["coalesced_batch"] == 3 for t, _ in reqs)
    padded = lanes + [lanes[-1]]  # padded to 4 with the last request
    tok = _tok()
    want = pipe.generate(text_ids=tok([t for t, _ in padded]), uncond_ids=tok([""] * 4),
                         num_steps=2, batch=4, seeds=[s for _, s in padded])
    for i, (text, _) in enumerate(lanes):
        got = decode_png(base64.b64decode(results[text]["image_b64"]))
        assert np.array_equal(got, want[i]), text


def test_png_encoder_decodes_with_zlib():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(13, 29, 3)).astype(np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(png_pixels_by_zlib(data), img)
    assert np.array_equal(decode_png(data), img)
    grey = img[..., 0]
    assert np.array_equal(decode_png(encode_png(grey)), grey)
    try:  # and Pillow, where this machine has it
        from PIL import Image
    except ImportError:
        return
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", optimize=True)  # filtered rows
    assert np.array_equal(decode_png(buf.getvalue()), img)


def test_gradio_generator_without_gradio(server_pipe, tmp_path):
    from clap2diffusion_tpu_torch.apps.gradio_app import build_generator, launch

    pipe = server_pipe
    path = wav_file(str(tmp_path / "a.wav"), 5)
    generate = build_generator(pipe.cfg, pipe=pipe)
    img, info = generate(path, "a dog barks", "Hierarchical V4", norm_value=60, steps=2,
                         cfg_scale=7.5, seed=3)
    tok = _tok()
    want = pipe.generate(waveform=pipe.load_audio(path), text_ids=tok("a dog barks"),
                         uncond_ids=tok(""), num_steps=2, guidance_scale=7.5, norm_target=60.0,
                         seed=3, sampler="ddim")
    assert np.array_equal(img, want[0]) and "steps=2" in info and "seed=3" in info
    with pytest.raises(ValueError, match="needs the CLIP vision weights"):
        generate(path, "x", "Hierarchical V4", norm_value=60, steps=2, cfg_scale=7.5, seed=3,
                 best_of=2)
    if importlib.util.find_spec("gradio") is None:
        with pytest.raises(SystemExit, match="gradio is not installed"):
            launch(pipe.cfg, device="cpu")


@pytest.fixture(scope="module")
def best_of_pipe(eval_ck):
    pcfg, _, ck, _ = eval_ck
    return P.load_pipeline(pcfg, ck, device="cpu")


def test_server_best_of_answers_the_winner(best_of_pipe, tmp_path):
    pipe = best_of_pipe
    server, thread = _running(InferenceService(pipe=pipe, coalesce_ms=500))
    port = server.server_address[1]
    try:
        path = wav_file(str(tmp_path / "a.wav"), 4)
        with open(path, "rb") as f:
            audio = base64.b64encode(f.read()).decode()
        out = _post(port, "/generate", {"audio_b64": audio, "text": "a dog barks", "steps": 2,
                                        "seed": 3, "best_of": 2})
        tok = _tok()
        best, scores = pipe.generate_best_of(2, waveform=pipe.load_audio(path),
                                             text_ids=tok("a dog barks"), uncond_ids=tok(""),
                                             num_steps=2, seed=3)
        assert np.array_equal(decode_png(base64.b64decode(out["image_b64"])), best)
        assert out["info"]["best_of"] == 2 and "coalesced_batch" not in out["info"]
        assert out["info"]["clip_scores"] == [round(float(v), 4) for v in scores]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/generate", {"text": "x", "steps": 2, "best_of": 2,
                                      "init_image_b64": "aGk="})
        assert e.value.code == 400 and "init/mask" in json.loads(e.value.read())["error"]
    finally:
        _stop(server, thread)


def test_gradio_best_of(best_of_pipe, tmp_path):
    from clap2diffusion_tpu_torch.apps.gradio_app import build_generator

    pipe = best_of_pipe
    path = wav_file(str(tmp_path / "a.wav"), 5)
    generate = build_generator(pipe.cfg, pipe=pipe)
    img, info = generate(path, "a dog barks", "Hierarchical V4", norm_value=60, steps=2,
                         cfg_scale=7.5, seed=3, best_of=2)
    tok = _tok()
    best, scores = pipe.generate_best_of(2, waveform=pipe.load_audio(path),
                                         text_ids=tok("a dog barks"), uncond_ids=tok(""),
                                         num_steps=2, guidance_scale=7.5, norm_target=60.0,
                                         seed=3, sampler="ddim")
    assert np.array_equal(img, best)
    assert "best_of=2" in info and f"clip_scores={[round(float(v), 2) for v in scores]}" in info
