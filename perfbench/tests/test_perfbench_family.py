"""A configuration's model family (``perfbench/families/<family>.py``): the
readings of ``sd15_clap`` pinned to what they were before the family seam
(work counts, drawn weights, the reference image and the training
reference), a family that comes as new files only, a check that reads the
family's reference, a family that is missing, and a harness that names
no tower of its own."""

from __future__ import annotations

import ast
import contextlib
import hashlib
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from perfbench.harness import check, common, serve, train, weights
from perfbench.harness.runner import run_cell, work
from perfbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 7

# the parent's readings, recorded before the family seam existed
REQUEST_B1 = {
    "flops": 82883469717424.0, "attn_fwd_flops": 12281727418368.0,
    "attn_fwd_bytes": 9191817216.0, "attn_bwd_flops": 24563454836736.0,
    "attn_bwd_bytes": 18383634432.0, "attn_calls": 751, "gn_bytes": 19859505152.0,
    "gn_flops": 39719010304.0, "gn_calls": 3080}
REQUEST_B8 = {
    "flops": 663067757739392.0, "attn_fwd_flops": 98253819346944.0,
    "attn_fwd_bytes": 73534537728.0, "attn_bwd_flops": 196507638693888.0,
    "attn_bwd_bytes": 147069075456.0, "attn_calls": 751, "gn_bytes": 158876041216.0,
    "gn_flops": 317752082432.0, "gn_calls": 3080}
MICRO_STEP = {
    "flops": 6787703968848.0, "attn_fwd_flops": 489894707200.0, "attn_fwd_bytes": 367001600.0,
    "attn_bwd_flops": 979789414400.0, "attn_bwd_bytes": 734003200.0, "attn_calls": 15,
    "gn_bytes": 720896000.0}
WEIGHTS = {
    torch.float32: {
        "clap_audio": "4fd5d5be4df2d57d3f1cc03cc9a95ade988e25320b1f4b7aef18b93013df1570",
        "clip_text": "e16d8b2aeab5824f06b6882b93259483cc6a4f5e2274e27864a47fff60c7ecd1",
        "hierarchical": "436dd0e1e6e676d200c4fde502bf7541a5e02c82fc0b578c5c575890a82d3ac8",
        "unet": "10a19bb6ecd57a4e2c395c20bf6f635f68d016dfc317b244e066b3b61ee98b10",
        "vae": "03ae1fe52be4ea8264fd3f4c769f397b39570918593ab45da49e0c57f45fa7ca",
    },
    torch.bfloat16: {
        "clap_audio": "29919d803595254e63877a0a3f7aebc92d1db890b79fa24e7c820134b6647278",
        "clip_text": "f8c10799da0e796dd7b62bdf1d3054c5820b3dbcad191d5d482399cd4fc1419e",
        "hierarchical": "211df5aaf4baa434ba368994f331d3ccef40ae58932d09ca513425c0e4247c56",
        "unet": "5d5bde4a67f00b57e3b476a8fbfa5b6bef4e30cbd6ef19ab333fd30f1c67ba80",
        "vae": "0eb1d6e948cac48902e815dff525eb34a07651c22944159b3ecf17172c5d38bb",
    },
}
IMAGE = "76e0822ad134e9ebf822fad6d9aeb70b1012b47e65ecdfefd6c7a5c2548d3150"
TRAIN_LOSSES = [1.4806079864501953, 1.4844088554382324, 1.524082899093628, 1.3359334468841553,
                1.5238361358642578, 1.527342438697815, 1.2818224430084229, 1.4989123344421387]
TRAIN_LEAVES = {
    "pk": "bdd2ba1303f8f2b1e8892a5eaf18d3226c3bf59fdfaa87e2e09d10ea14fe4e0b",
    "ema": "6d5a484e439e2ebc5dbd7ae50e3a9420de0f299a187af888ade4fa48628bc4c6",
    "grad1": "511f5dabae8e2e6387911fa380fbdc9ff6ef7e49e0f4a1415bbdd0d38e678777",
}


def digest(sd) -> str:
    """sha256 of a state dict: each leaf's name, type, shape and bytes."""
    h = hashlib.sha256()
    for k in sorted(sd):
        t = sd[k].detach().contiguous().cpu()
        h.update(f"{k}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def one_thread():
    """Float sums on the CPU depend on how many threads split them: the
    pinned readings were taken on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def full_cell(name):
    return common.cell(common.load_benchmark(), name)


def test_every_configuration_names_the_sd15_clap_family():
    bench = common.load_benchmark()
    for w in bench["workloads"]:
        fam = common.family(common.cell(bench, w["name"]))
        assert fam.SALT == {"clap_audio": 1, "clip_text": 2, "hierarchical": 3, "unet": 4,
                            "vae": 5}
        assert set(fam.TRAIN_TOWERS) <= set(fam.SERVE_TOWERS) == set(fam.SALT)


@pytest.mark.parametrize("name,expected", [("serve-b1", REQUEST_B1), ("serve-b8", REQUEST_B8),
                                           ("train-s2", MICRO_STEP)])
def test_work_counts_are_the_parents_at_published_widths(name, expected):
    assert work(full_cell(name)) == expected


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drawn_weights_are_the_parents(dtype):
    fam = common.family(full_cell("serve-b1"))
    ns = common.namespace(tiny.tiny_model())
    w = weights.draw_weights(fam, ns, 2**31 + 99, fam.SERVE_TOWERS, dtype, "cpu")
    assert {t: digest(sd) for t, sd in w.items()} == WEIGHTS[dtype]


def lane_job(cell, request=3, lane=5):
    spec = cell["traffic"]
    inputs = serve.Inputs(spec, SEED, spec["batch"], serve.text_length(cell))
    r = inputs.request(request)
    return {"waveforms": list(r["waveform"]), "lane": lane,
            "text_ids": r["text_ids"][lane:lane + 1],
            "uncond_ids": r["uncond_ids"][lane:lane + 1], "seed": int(r["seeds"][lane])}


def test_reference_image_of_one_lane_is_the_parents(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = common.cell(common.load_benchmark(root), "serve-b8", root)
    with one_thread():
        img = check.reference_images(cell, SEED, [lane_job(cell)], CPU)[0]
    assert img.dtype == np.float32 and img.shape == (64, 64, 3)
    assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() == IMAGE


def test_training_reference_is_the_parents(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = common.cell(common.load_benchmark(root), "train-s2", root)
    ns = common.namespace(cell["config"]["model"])
    feed = train.Feed(cell["traffic"], common.family(cell).latent_shape(ns), SEED)
    with one_thread():
        ref = train.reference_run(cell, SEED, feed, cell["traffic"]["checked_steps"], CPU)
    assert ref["losses"] == TRAIN_LOSSES
    assert {k: digest(ref[k]) for k in TRAIN_LEAVES} == TRAIN_LEAVES


# -- a family of new files only ------------------------------------------------

TWIN = '''"""sd15_clap's parts under a name of their own."""
from perfbench.families.sd15_clap import (  # noqa: F401
    SALT, SERVE_TOWERS, SPECIAL, TRAIN_TOWERS, Reference, Stage2, build_reference,
    latent_shape, micro_step_work, request_work, text_length)
'''

DOUBLED = TWIN + '''

class Reference(Reference):
    def image(self, latents, cond_ids, uncond_ids, routed, steps, guidance):
        return super().image(latents, cond_ids, uncond_ids, routed, steps, 2 * guidance)
'''


def new_family_cell(root, family, source):
    """A family file, a configuration that names it and a cell of it,
    added under ``root`` as new files and entries only."""
    with open(os.path.join(root, "perfbench", "families", family + ".py"), "w") as f:
        f.write(source)
    with open(os.path.join(root, "perfbench/configs/sd15-clap-hier-serve.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-" + family, family=family)
    tiny.write(root, f"perfbench/configs/tiny-{family}.json", cfg)
    bench = common.load_benchmark(root)
    bench["configs"].append({"name": "tiny-" + family, "source": "test", "reduced": [],
                             "file": f"perfbench/configs/tiny-{family}.json", "why": "test"})
    bench["workloads"].append({"name": family + "-b1", "config": "tiny-" + family,
                               "traffic": "batch1-closed", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "serve-b1" in m.get("workloads", ()):
            m["workloads"].append(family + "-b1")
    tiny.write(root, "BENCHMARK.json", bench)
    return common.cell(common.load_benchmark(root), family + "-b1", root)


def run(cell, trace=0):
    args = common.parse_args(["--workload", cell["workload"]["name"], "--seed", "5",
                              "--seconds", "1", "--trace", str(trace)])
    with redirect_stdout(io.StringIO()):
        return run_cell(cell, args, CPU, 0.0)


def test_a_family_of_new_files_only_runs_on_the_cpu(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = new_family_cell(root, "twin", TWIN)
    assert common.family(cell).__file__ == os.path.join(root, "perfbench/families/twin.py")
    out = run(cell, trace=1)
    assert out["correct"], out
    assert work(cell) == work(common.cell(common.load_benchmark(root), "serve-b1", root))


def test_the_check_reads_the_familys_reference(tmp_path):
    root = tiny.make_root(str(tmp_path))
    out = run(new_family_cell(root, "doubled", DOUBLED))
    assert not out["correct"]
    assert out["checks"]["image_mae_levels"]["value"] > \
        out["checks"]["image_mae_levels"]["limit"]


def test_a_missing_family_fails_with_its_name(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = common.cell(common.load_benchmark(root), "serve-b1", root)
    cell["config"]["family"] = "no_such_family"
    with pytest.raises(SystemExit, match="no_such_family"):
        common.family(cell)
    del cell["config"]["family"]
    with pytest.raises(SystemExit, match="sd15-clap-hier-serve"):
        common.family(cell)


# -- the harness names no tower ------------------------------------------------

HARNESS = os.path.join(common.BENCH, "harness")
REFERENCE_MODELS = {"unet", "vae", "clip_text", "htsat", "hierarchical", "pipeline"}


def tower_names():
    names = set()
    for f in sorted(os.listdir(os.path.join(common.BENCH, "families"))):
        if f.endswith(".py"):
            cell = {"config": {"family": f[:-3]}, "root": common.ROOT}
            names |= set(common.family(cell).SALT)
    return names


def test_no_harness_file_names_a_tower_or_imports_a_reference_model():
    towers = tower_names()
    assert towers >= {"clap_audio", "clip_text", "hierarchical", "unet", "vae"}
    found = []
    for f in sorted(os.listdir(HARNESS)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(HARNESS, f)).read())
        # the program's own device stage marks, named by the program
        skip = {id(n) for a in ast.walk(tree) if isinstance(a, ast.Assign)
                and any(getattr(t, "id", None) == "STAGES" for t in a.targets)
                for n in ast.walk(a.value)} if f == "program_spans.py" else set()
        for n in ast.walk(tree):
            if id(n) in skip:
                continue
            if isinstance(n, ast.ImportFrom):
                mods = {n.module or ""} | {f"{n.module}.{a.name}" for a in n.names}
            elif isinstance(n, ast.Import):
                mods = {a.name for a in n.names}
            else:
                mods = set()
            for m in mods:
                parts = m.split(".")
                if parts[:2] == ["perfbench", "reference"] and len(parts) > 2 \
                        and parts[2] in REFERENCE_MODELS:
                    found.append((f, n.lineno, m))
            words = ({n.value} if isinstance(n, ast.Constant) and isinstance(n.value, str)
                     else {n.id} if isinstance(n, ast.Name)
                     else {n.attr} if isinstance(n, ast.Attribute) else set())
            found += [(f, n.lineno, w) for w in words & towers]
    assert found == []
