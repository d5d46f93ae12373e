"""The port's evaluation slice on the CPU, against the JAX package.

- the config's ``clap.text`` and ``diffusion.clip_vision`` sections;
- ``eval/metrics.py`` (a numpy copy: equal results on the same features);
- the RoBERTa tokenizer's ids (hash fallback and a real BPE pair);
- ``ClapTextTower`` with padding, ``CLIPVisionEncoder`` and
  ``clip_text_features`` at tiny configs, within 1e-4 of max|ref|;
- ``preprocess_images`` down from 512², up, and off-square, and the
  Inception preprocessing, against ``jax.image.resize`` (antialiased only
  where an axis shrinks): 1e-5 on square scales, 1e-4 where the two axes'
  scales differ (the normalised units of each; 1e-4 is 0.007 of a level);
- ``InceptionV3`` in both variants at 75² and 299², within 1e-4 of max|ref|;
- every converter against ``from_flax`` of the JAX converter, at
  tolerance 0;
- ``save_pipeline`` / ``load_pipeline`` carrying the evaluation towers;
- ``generate_best_of`` against the JAX one with the JAX draws fed in, and
  ``run_evaluation`` with every tower against JAX's, per sample.

Weights are synthetic in the published layouts (HF ``CLIPModel`` and
``ClapModel``, torchvision ``inception_v3``), read by both packages'
converters; everything is fp32.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.core import config as jc
from clap2diffusion_tpu.diffusion.pipeline import AudioToImagePipeline as JPipe
from clap2diffusion_tpu.diffusion.pipeline import init_params as jax_init_params
from clap2diffusion_tpu.eval import metrics as JM
from clap2diffusion_tpu.models import clip_vision as JV
from clap2diffusion_tpu.models import convert as jconv
from clap2diffusion_tpu.models import inception_v3 as JI
from clap2diffusion_tpu.models import roberta_tokenizer as JR
from clap2diffusion_tpu.models.clap import convert as jclap
from clap2diffusion_tpu.models.clap.text import ClapTextTower as JText
from clap2diffusion_tpu_torch import convert as bridge
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.eval import metrics as PM
from clap2diffusion_tpu_torch.models import clip_vision as PV
from clap2diffusion_tpu_torch.models import convert as pconv
from clap2diffusion_tpu_torch.models import inception_v3 as PI
from clap2diffusion_tpu_torch.models import roberta_tokenizer as PR
from clap2diffusion_tpu_torch.models.clap import convert as pclap
from clap2diffusion_tpu_torch.models.clap.text import ClapTextTower
from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
from clap2diffusion_tpu_torch.utils.png import encode_png
from tests.golden_utils import synth_value
from tests.test_inception import synthetic_torch_state_dict
from tests.test_pipeline import tiny_config
from tests.test_torch_generate import JaxDraws
from tests.test_torch_models import port_cfg
from tests.test_torch_weights_io import equal_dicts

torch.set_num_threads(2)

REL = 1e-4  # fp32 modules: XLA:CPU and torch sum in different orders
VISION = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, projection_dim=24)


def close(got, ref, rel=REL, msg=""):
    a = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = np.asarray(ref, np.float32)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * float(np.abs(b).max() or 1.0),
                               err_msg=msg)


def eval_config():
    """tests/test_pipeline.py::tiny_config (with its tiny CLAP text tower)
    and a tiny CLIP vision tower."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, clip_vision=jc.CLIPVisionConfig(**VISION)))


def filled(tag, shapes):
    return {k: torch.from_numpy(synth_value(tag, k, tuple(s))) for k, s in shapes.items()}


def clip_model_sd(pcfg, vision_prefix="vision_model."):
    """A transformers CLIPModel dict: the text model, the vision model (its
    prefix as given), both projections, the logit scale and position ids."""
    sd = {"text_model." + k: v for k, v in
          filled("cliptext", pconv.template(CLIPTextEncoder, pcfg.diffusion.clip_text)).items()}
    for k, v in filled("clipvision", pconv.template(PV.CLIPVisionEncoder,
                                                    pcfg.diffusion.clip_vision)).items():
        sd[vision_prefix + k[len("vision_model."):] if k.startswith("vision_model.") else k] = v
    sd["text_projection.weight"] = torch.from_numpy(synth_value(
        "clip", "text_projection.weight",
        (pcfg.diffusion.clip_vision.projection_dim, pcfg.diffusion.clip_text.hidden_size)))
    sd["logit_scale"] = torch.tensor(2.6592)
    sd[vision_prefix + "embeddings.position_ids"] = torch.arange(5)[None]
    return sd


def clap_model_sd(pcfg, prefix="text_model."):
    """The text side of an HF ClapModel dict (with its id buffers)."""
    sd = {}
    for k, v in filled("claptext", pconv.template(ClapTextTower, pcfg.clap.text)).items():
        sd[prefix + k[len("text_model."):] if k.startswith("text_model.") else k] = v
    sd[prefix + "embeddings.position_ids"] = torch.arange(514)[None]
    sd[prefix + "embeddings.token_type_ids"] = torch.zeros(1, 514, dtype=torch.long)
    return sd


def inception_sd():
    return {k: torch.as_tensor(v) for k, v in synthetic_torch_state_dict().items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = eval_config()
    pcfg = port_cfg(cfg)
    clip, clap = clip_model_sd(pcfg), clap_model_sd(pcfg)
    jparams = dict(jax.tree.map(np.asarray, jax_init_params(cfg, seed=0)))
    jparams["clip_vision"] = JV.convert_clip_vision(clip, cfg.diffusion.clip_vision)
    jparams["clip_text_projection"] = np.asarray(clip["text_projection.weight"]).T.copy()
    jparams["clap_text"] = jclap.convert_clap_text(clap, cfg.clap.text)
    jparams["inception_v3"] = JI.convert_inception_v3(synthetic_torch_state_dict())
    return cfg, pcfg, jparams


# -- configuration and metrics ------------------------------------------------------


def test_config_sections_match_jax():
    for path in (None, "configs/default.yaml"):
        assert dataclasses.asdict(C.load_config(path)) == dataclasses.asdict(
            jc.load_config(path)), path
    tree = dataclasses.asdict(eval_config())
    ours, ref = C.from_dict(C.Config, tree), jc._from_dict(jc.Config, tree)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.diffusion.clip_vision == C.CLIPVisionConfig(**VISION)
    assert ours.clap.text.vocab_size == 100 and C.Config().clap.text.pad_token_id == 1
    with pytest.raises(KeyError):
        C.from_dict(C.Config, {"diffusion": {"clip_vision": {"nope": 1}}})


def _features(seed, n=12, d=6):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


METRICS = {
    "audio_text_alignment": lambda M: M.audio_text_alignment(_features(0), _features(1)),
    "clip_score": lambda M: M.clip_score(_features(2), _features(3) + 1.0),
    "frechet_distance": lambda M: M.frechet_distance(_features(4), _features(5) * 1.5),
    "inception_score": lambda M: M.inception_score(np.abs(_features(6, 30, 10)) + 1e-3,
                                                   splits=3),
    "image_stats": lambda M: M.image_stats(
        np.random.default_rng(7).integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)),
    "summarize": lambda M: M.summarize({"a": [1.0, 2.5, 4.0], "b": [0.5]}),
    "polynomial_mmd2": lambda M: M.polynomial_mmd2(_features(8), _features(9)),
    "kid_subsets": lambda M: M.kid_from_features(_features(10, 20), _features(11, 15),
                                                 n_subsets=4, subset_size=5, seed=3),
    "kid_whole": lambda M: M.kid_from_features(_features(12), _features(13)),
    "fid_from_images": lambda M: M.fid_from_images(
        np.random.default_rng(14).integers(0, 256, (5, 4, 4, 3)).astype(np.uint8),
        np.random.default_rng(15).integers(0, 256, (6, 4, 4, 3)).astype(np.uint8),
        lambda x: x.reshape(len(x), -1)[:, :5].astype(np.float32) / 255.0, batch_size=4),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_metrics_equal_jax(name):
    """The same numpy code on the same features: equal results."""
    assert METRICS[name](PM) == METRICS[name](JM)


@pytest.mark.parametrize("bpe", [False, True], ids=["hash_fallback", "bpe_files"])
def test_roberta_ids_match_jax(tmp_path, monkeypatch, bpe):
    texts = ["A dog barks twice!", "rain on a tin roof, distant thunder", "", "x" * 300]
    kw = {}
    if bpe:
        vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "a": 4, "Ġ": 5, "d": 6, "o": 7,
                 "g": 8, "do": 9, "Ġdo": 10, "Ġdog": 11, "r": 12, "i": 13, "n": 14, "Ġr": 15,
                 "ain": 16, "Ġrain": 17, "ai": 18}
        (tmp_path / "vocab.json").write_text(json.dumps(vocab))
        (tmp_path / "merges.txt").write_text(
            "#version: 0.2\nd o\nĠ do\nĠdo g\na i\nai n\nĠ r\nĠr ain\n")
        kw = dict(vocab_path=str(tmp_path / "vocab.json"),
                  merges_path=str(tmp_path / "merges.txt"))
    monkeypatch.delenv("CLAP_BPE_DIR", raising=False)
    ours, ref = PR.RobertaTokenizer(max_length=16, **kw), JR.RobertaTokenizer(max_length=16, **kw)
    assert ours.fallback == ref.fallback == (not bpe)
    a, b = ours(texts), ref(texts)
    for key in ("input_ids", "attention_mask"):
        assert a[key].dtype == b[key].dtype == np.int32
        np.testing.assert_array_equal(a[key], b[key])
    assert ours.encode("a dog rain") == ref.encode("a dog rain")


# -- the towers ---------------------------------------------------------------------


def test_clap_text_tower_with_padding_matches_jax(tiny):
    cfg, pcfg, jparams = tiny
    ids = np.array([[0, 5, 6, 7, 2, 1, 1, 1], [0, 9, 2, 1, 1, 1, 1, 1],
                    [0, 3, 99, 150, 4, 8, 11, 2]], np.int32)  # 150: out of the tiny vocab
    mask = (ids != 1).astype(np.int32)
    tower = ClapTextTower(pcfg.clap.text)
    tower.load_state_dict(bridge.clap_text_from_flax(jparams["clap_text"]))
    jt = JText(cfg=cfg.clap.text)
    with torch.no_grad():
        for m in (mask, None):
            ref = jt.apply({"params": jparams["clap_text"]}, ids, m)
            got = tower(torch.from_numpy(ids), None if m is None else torch.from_numpy(m))
            close(got, ref, msg=f"mask {m is not None}")
        # a padded tail changes nothing of the rows it pads
        short = tower(torch.from_numpy(ids[:2, :5]), torch.from_numpy(mask[:2, :5]))
        close(short, tower(torch.from_numpy(ids[:2]), torch.from_numpy(mask[:2])).numpy())


def test_clip_vision_encoder_and_text_features_match_jax(tiny):
    cfg, pcfg, jparams = tiny
    px = np.random.default_rng(0).normal(size=(3, 28, 28, 3)).astype(np.float32)
    ref = JV.CLIPVisionEncoder(cfg=cfg.diffusion.clip_vision).apply(
        {"params": jparams["clip_vision"]}, px)
    tower = PV.build_tower(PV.CLIPVisionEncoder, pcfg.diffusion.clip_vision,
                           bridge.clip_vision_from_flax(jparams["clip_vision"]), "cpu")
    close(tower(torch.from_numpy(px)), ref)
    assert not tower.training
    hidden = np.random.default_rng(1).normal(size=(2, 7, 48)).astype(np.float32)
    ids = np.array([[49406, 5, 49407, 0, 0, 0, 0], [49406, 7, 8, 9, 49407, 49407, 0]], np.int32)
    proj = bridge.clip_text_projection_from_flax(jparams["clip_text_projection"])["weight"]
    want = JV.clip_text_features(hidden, ids, jparams["clip_text_projection"])
    close(PV.clip_text_features(torch.from_numpy(hidden), torch.from_numpy(ids), proj), want)


@pytest.mark.parametrize("shape,rel", [
    ((2, 512, 512, 3), 1e-5), ((1, 100, 100, 3), 1e-5), ((1, 300, 500, 3), 1e-4),
    ((1, 150, 90, 3), 1e-4)], ids=["down_512", "up_100", "down_off_square", "up_off_square"])
def test_clip_preprocess_matches_jax(shape, rel):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    got, want = PV.preprocess_images(img), JV.preprocess_images(img)
    assert got.shape == want.shape == (shape[0], 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=rel)


@pytest.mark.parametrize("shape,rel", [
    ((2, 512, 512, 3), 1e-5), ((1, 64, 64, 3), 1e-5), ((1, 300, 500, 3), 1e-4)],
    ids=["down_512", "up_64", "mixed_off_square"])
def test_inception_preprocess_matches_jax(shape, rel):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    got, want = PI.preprocess_images_inception(img), JI.preprocess_images_inception(img)
    assert got.shape == want.shape == (shape[0], 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel)
    same = np.random.default_rng(1).integers(0, 256, (1, 299, 299, 3)).astype(np.uint8)
    np.testing.assert_array_equal(PI.preprocess_images_inception(same),
                                  JI.preprocess_images_inception(same))


@pytest.fixture(scope="module")
def inception_weights():
    sd = inception_sd()
    return JI.convert_inception_v3(synthetic_torch_state_dict()), PI.convert_inception_v3(sd)


@pytest.mark.parametrize("size", [75, 299])
@pytest.mark.parametrize("variant", ["torchvision", "pytorch_fid"])
def test_inception_matches_jax(inception_weights, variant, size):
    jtree, sd = inception_weights
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    transform = size == 75 and variant == "torchvision"
    jmod = JI.InceptionV3(variant=variant, transform_input=transform)
    ref = jax.jit(lambda p, v: jmod.apply({"params": p}, v))(jtree, x)
    tower = PI.build_inception(sd, "cpu", variant, transform_input=transform)
    tower.train()  # BatchNorm uses the running statistics whatever the mode
    out = tower(torch.from_numpy(x))
    for key in ("pool3", "logits"):
        assert tuple(out[key].shape) == ref[key].shape
        close(out[key], ref[key], msg=key)
    with pytest.raises(ValueError, match="variant"):
        PI.InceptionV3("tf")


# -- converters ---------------------------------------------------------------------


@pytest.mark.parametrize("prefix", ["vision_model.", ""], ids=["CLIPModel", "bare"])
def test_convert_clip_vision_matches_jax(tiny, prefix):
    cfg, pcfg, _ = tiny
    sd = clip_model_sd(pcfg, prefix)
    want = bridge.clip_vision_from_flax(JV.convert_clip_vision(sd, cfg.diffusion.clip_vision))
    equal_dicts(PV.convert_clip_vision(sd, pcfg.diffusion.clip_vision), want)
    equal_dicts(PV.convert_clip_text_projection(sd), bridge.clip_text_projection_from_flax(
        np.asarray(sd["text_projection.weight"]).T))
    if prefix:
        # the whole-CLIPModel split (text, text projection, vision); JAX's
        # convert_clip_full reads the vision tower at the default geometry
        # only, so its parts are taken one by one here
        pt, pp, pv = pconv.convert_clip_full(sd, pcfg.diffusion.clip_text,
                                             pcfg.diffusion.clip_vision)
        equal_dicts(pt, bridge.clip_text_from_flax(jconv.convert_clip_text(
            sd, cfg.diffusion.clip_text)))
        equal_dicts(pp, bridge.clip_text_projection_from_flax(
            np.asarray(sd["text_projection.weight"]).T))
        equal_dicts(pv, bridge.clip_vision_from_flax(JV.convert_clip_vision(
            sd, cfg.diffusion.clip_vision)))
    del sd["visual_projection.weight"]
    got = PV.convert_clip_vision(sd, pcfg.diffusion.clip_vision)
    equal_dicts(got, bridge.clip_vision_from_flax(JV.convert_clip_vision(
        sd, cfg.diffusion.clip_vision)))
    assert "visual_projection.weight" not in got


@pytest.mark.parametrize("prefix", ["text_model.", ""], ids=["ClapModel", "bare"])
def test_convert_clap_text_matches_jax(tiny, prefix):
    cfg, pcfg, _ = tiny
    sd = clap_model_sd(pcfg, prefix)
    want = bridge.clap_text_from_flax(jclap.convert_clap_text(sd, cfg.clap.text))
    equal_dicts(pclap.convert_clap_text(sd, pcfg.clap.text), want)
    assert pclap.has_text_tower(sd)


@pytest.mark.parametrize("case", ["torchvision", "module_prefix", "no_fc"])
def test_convert_inception_matches_jax(case):
    sd = synthetic_torch_state_dict()
    if case == "module_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    if case == "no_fc":
        del sd["fc.weight"], sd["fc.bias"]
    got = PI.convert_inception_v3({k: torch.as_tensor(v) for k, v in sd.items()})
    equal_dicts(got, bridge.inception_v3_from_flax(JI.convert_inception_v3(sd)))
    with torch.device("meta"):
        assert sorted(PI.InceptionV3().state_dict()) == sorted(got)
    sd["Mixed_5b.branch1x1.extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        PI.convert_inception_v3(sd)
    with pytest.raises(ValueError, match="unconsumed"):
        JI.convert_inception_v3(sd)


def test_from_flax_carries_every_optional_tower(tiny):
    _, pcfg, jparams = tiny
    ported = bridge.from_flax(jparams)
    assert {"clip_vision", "clip_text_projection", "clap_text", "inception_v3"} <= set(ported)
    for tower, module in (("clip_vision", PV.CLIPVisionEncoder(pcfg.diffusion.clip_vision)),
                          ("clap_text", ClapTextTower(pcfg.clap.text))):
        module.load_state_dict(ported[tower], strict=True)
    PI.InceptionV3().load_state_dict(ported["inception_v3"], strict=True)
    assert tuple(ported["clip_text_projection"]["weight"].shape) == (24, 48)


def test_pipeline_checkpoint_carries_the_evaluation_towers(tiny, tmp_path):
    _, pcfg, jparams = tiny
    params = bridge.from_flax(jparams)
    path = P.save_pipeline(str(tmp_path / "ck"), params)
    pipe = P.load_pipeline(pcfg, path, device="cpu")
    extra = ("clip_vision", "clip_text_projection", "clap_text", "inception_v3")
    assert sorted(pipe.extra_params) == sorted(extra)
    for tower in extra:
        equal_dicts(pipe.extra_params[tower], params[tower])
    assert sorted(pipe.params) == sorted(params)
    # saved again from the pipeline, and cast as JAX's load_pipeline casts every tower
    again = P.save_pipeline(str(tmp_path / "again"), pipe.params)
    half = P.load_pipeline(pcfg, again, dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for tower in extra
               for t in half.extra_params[tower].values())
    assert next(iter(half.hierarchical.parameters())).dtype == torch.float32


def test_reference_frames_read_as_jax_reads_them(tmp_path, monkeypatch):
    """A PNG at the image size is read without Pillow; a frame of another
    size is resized by Pillow as the JAX evaluator resizes it, and without
    Pillow it (and a JPEG) raises ImportError naming Pillow."""
    import sys

    from PIL import Image

    from clap2diffusion_tpu_torch.eval.evaluate import load_reference_frame

    rng = np.random.default_rng(3)
    same, other = str(tmp_path / "same.png"), str(tmp_path / "other.png")
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    big = rng.integers(0, 256, (80, 96, 3)).astype(np.uint8)
    with open(same, "wb") as f:
        f.write(encode_png(img))
    with open(other, "wb") as f:
        f.write(encode_png(big))
    want = np.asarray(Image.open(other).convert("RGB").resize((64, 64)))
    np.testing.assert_array_equal(load_reference_frame(other, (64, 64)), want)
    jpg = str(tmp_path / "frame.jpg")
    Image.fromarray(img).save(jpg)
    monkeypatch.setitem(sys.modules, "PIL", None)  # an environment without Pillow
    np.testing.assert_array_equal(load_reference_frame(same, (64, 64)), img)
    for path in (other, jpg):
        with pytest.raises(ImportError, match="Pillow"):
            load_reference_frame(path, (64, 64))


# -- best-of-n and run_evaluation against JAX ---------------------------------------


def _wav(seed=2, n=24_000):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(np.float32)


def test_generate_best_of_matches_jax(tiny, monkeypatch):
    """The JAX draws fed to the port: the candidates within the golden
    bounds of JAX's (``tests/test_torch_generate.py``), the scores within
    1e-4 (score units, 0-100) and the same winner."""
    cfg, pcfg, jparams = tiny
    jpipe = JPipe(cfg, params=jparams)
    pipe = P.AudioToImagePipeline(pcfg, params=bridge.from_flax(jparams), device="cpu")
    monkeypatch.setattr(pipe, "draws", lambda seed, seeds=None: JaxDraws(seed, seeds))
    cands = {}
    real = pipe._dispatch_generate

    def spy(**kw):
        cands["port"] = real(**kw)
        cands["kw"] = kw
        return cands["port"]

    monkeypatch.setattr(pipe, "_dispatch_generate", spy)
    kw = dict(waveform=_wav(), text_ids=(np.arange(7)[None] % 97).astype(np.int32),
              uncond_ids=np.zeros((1, 7), np.int32), num_steps=2, seed=4)
    best, scores = pipe.generate_best_of(3, **kw)
    jbest, jscores = jpipe.generate_best_of(3, **kw)
    assert best.shape == jbest.shape == (64, 64, 3) and best.dtype == np.uint8
    assert scores.shape == (3,) and scores.dtype == np.float32
    # one sound rides once with batch=n; the prompt in every lane; seeds s..s+n-1
    assert cands["kw"]["waveform"].shape == (24_000,) and cands["kw"]["batch"] == 3
    np.testing.assert_array_equal(cands["kw"]["seeds"], [4, 5, 6])
    jcands = jpipe.generate(waveform=np.repeat(kw["waveform"][None], 3, 0),
                            text_ids=np.repeat(kw["text_ids"], 3, 0),
                            uncond_ids=np.repeat(kw["uncond_ids"], 3, 0), num_steps=2,
                            seed=4, seeds=np.arange(4, 7), batch=3)
    diff = np.abs(cands["port"].numpy().astype(np.int32) - jcands.astype(np.int32))
    assert float(diff.mean()) < 0.5 and float((diff > 2).mean()) < 0.01
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0, atol=1e-4)
    assert int(np.argmax(scores)) == int(np.argmax(jscores))
    assert np.array_equal(best, cands["port"].numpy()[int(np.argmax(scores))])


def test_best_of_refusals_match_jax(tiny):
    cfg, pcfg, jparams = tiny
    full = P.AudioToImagePipeline(pcfg, params=bridge.from_flax(jparams), device="cpu")
    bare = P.AudioToImagePipeline(pcfg, params=P.init_params(pcfg, device="cpu"),
                                  device="cpu")
    ids = np.zeros((1, 7), np.int32)
    cases = [
        (bare, dict(text_ids=ids), "needs the CLIP vision weights"),
        (full, dict(), "a text prompt is required"),
        (full, dict(text_ids=ids, init_image=np.zeros((64, 64, 3), np.uint8)),
         "unsupported with init_image"),
        (full, dict(text_ids=ids, batch=2), "sets batch=n itself"),
        (full, dict(text_ids=np.zeros((2, 7), np.int32)), "takes ONE prompt"),
    ]
    for pipe, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            pipe.generate_best_of(2, num_steps=1, **kw)
    with pytest.raises(ValueError, match="must be >= 1"):
        full.generate_best_of(0, text_ids=ids)


@pytest.fixture
def eval_data(tmp_path):
    from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset

    root = str(tmp_path / "ds")
    meta = make_fixture_dataset(root, n_train=1, n_val=1, n_test=3, duration_s=0.5,
                                latent_hw=8)
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    rng = np.random.default_rng(7)
    for s in meta["samples"]:
        with open(os.path.join(root, "frames", f"{s['id']}.png"), "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)))
    return root


def test_run_evaluation_matches_jax(tiny, eval_data, monkeypatch):
    """Every tower (CLIP vision + text projection, CLAP text, Inception at
    its 75² minimum in both packages, as the JAX test runs it), the JAX
    draws fed to the port: per-sample CLAP alignment within 1e-4, the image
    values within the golden bounds' reach (image_std and clip_score within
    1e-3), and the set metrics computed, finite and close."""
    import clap2diffusion_tpu.models.inception_v3 as JIM
    import clap2diffusion_tpu_torch.models.inception_v3 as PIM
    from clap2diffusion_tpu.eval.evaluate import run_evaluation as jax_run
    from clap2diffusion_tpu_torch.eval.evaluate import run_evaluation

    cfg, pcfg, jparams = tiny
    j75, p75 = JIM.preprocess_images_inception, PIM.preprocess_images_inception_device
    monkeypatch.setattr(JIM, "preprocess_images_inception", lambda imgs, image_size=75: j75(
        imgs, 75))
    monkeypatch.setattr(PIM, "preprocess_images_inception_device",
                        lambda imgs, image_size=75: p75(imgs, 75))
    monkeypatch.setattr(P.AudioToImagePipeline, "draws",
                        lambda self, seed, seeds=None: JaxDraws(seed, seeds))
    kw = dict(data_root=eval_data, max_samples=3, num_steps=2, seed=42, clap_batch=2)
    got = run_evaluation(pcfg, params=bridge.from_flax(jparams), device="cpu", **kw)
    want = jax_run(cfg, params=jparams, **kw)
    assert got["config"] == want["config"]
    for stamp in ("tokenizer_fallback", "roberta_fallback", "clap_text_random_init"):
        assert got[stamp] == want[stamp], stamp
    assert got["clap_text_random_init"] is False
    assert [r["id"] for r in got["samples"]] == [r["id"] for r in want["samples"]]
    assert set(got["summary"]) == set(want["summary"])
    assert set(got["timings"]) == set(want["timings"]) >= {
        "clap_towers_s", "clip_vision_frechet_s", "inception_metrics_s"}
    for a, b in zip(got["samples"], want["samples"]):
        assert abs(a["audio_text_alignment"] - b["audio_text_alignment"]) <= 1e-4
    s, w = got["summary"], want["summary"]
    for key, tol in (("audio_text_alignment", 1e-4), ("image_std", 1e-3), ("clip_score", 1e-3)):
        assert abs(s[key]["mean"] - w[key]["mean"]) <= tol, key
    for key in ("fid", "frechet_clip_vision"):
        assert np.isfinite(s[key]) and abs(s[key] - w[key]) <= 1e-2 * abs(w[key]), key
    for key in ("kid", "kid_clip_vision", "inception_score"):
        assert np.isfinite(s[key]["mean"])
        assert abs(s[key]["mean"] - w[key]["mean"]) <= 1e-2 * abs(w[key]["mean"]) + 1e-6, key
    assert s["fid_variant"] == "torchvision"
    with pytest.raises(NotImplementedError, match="item 9"):
        run_evaluation(pcfg, params=bridge.from_flax(jparams), device="cpu", shard=True, **kw)


def test_run_evaluation_random_clap_text_is_stamped(eval_data):
    from clap2diffusion_tpu_torch.eval.evaluate import run_evaluation

    pcfg = port_cfg(eval_config())
    res = run_evaluation(pcfg, data_root=eval_data, max_samples=2, num_steps=1, device="cpu")
    assert res["clap_text_random_init"] is True and res["tokenizer_fallback"] is True
    assert "clip_score" not in res["summary"] and "fid" not in res["summary"]
    assert len(res["samples"]) == 2
    assert all(np.isfinite(r["audio_text_alignment"]) for r in res["samples"])
