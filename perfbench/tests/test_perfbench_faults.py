"""``correct`` comes out false when the timed path is broken underneath: a
run at the tiny size on the CPU (the look for a chip skipped), once for
each fault a cell can have. Faults of the exchange between chips do not
apply: every cell runs on one chip. The control (the reference in float8
in the program's place) reads above a sound run, on the CPU at the tiny
size and, marked ``chip``, at the cells' own sizes on the card against
their limits."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from perfbench.harness import common
from perfbench.harness.runner import run_cell
from perfbench.tests import tiny


def run(root, name, seed=77, seconds=1.0):
    cell = common.cell(common.load_benchmark(root), name, root)
    args = common.parse_args(["--workload", name, "--seed", str(seed), "--seconds",
                              str(seconds), "--trace", "0"])
    with redirect_stdout(io.StringIO()):
        return run_cell(cell, args, torch.device("cpu"), 0.0)


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(str(tmp_path))


@pytest.mark.parametrize("name", ["serve-b1", "serve-b8"])
def test_an_image_altered_where_it_is_made_fails(root, name, monkeypatch):
    from clap2diffusion_tpu_torch.diffusion import pipeline

    program = pipeline.AudioToImagePipeline._program

    def altered(self, sig, x):
        img = program(self, sig, x)
        return torch.where(img > 127, img - 40, img + 40)

    assert run(root, name)["correct"]
    monkeypatch.setattr(pipeline.AudioToImagePipeline, "_program", altered)
    assert not run(root, name)["correct"]


def test_an_altered_answer_of_the_service_fails(root, monkeypatch):
    from clap2diffusion_tpu_torch.apps import server

    encode = server.InferenceService._img_b64

    def altered(img, fmt="png", quality=92):
        return encode(np.ascontiguousarray(255 - np.asarray(img)), fmt, quality)

    monkeypatch.setattr(server.InferenceService, "_img_b64", staticmethod(altered))
    assert not run(root, "serve-open", seconds=2.0)["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(root, monkeypatch):
    from clap2diffusion_tpu_torch.train import stages

    def unchanged(stage, state, batch, generator, mesh=None):
        total, losses = stage.loss(state, batch, generator)
        return {k: v.detach() for k, v in losses.items() if torch.is_tensor(v) and v.dim() == 0}

    assert run(root, "train-s2")["correct"]
    monkeypatch.setattr(stages, "train_step", unchanged)
    assert not run(root, "train-s2")["correct"]


def test_an_ema_left_unchanged_fails(root, monkeypatch):
    from clap2diffusion_tpu_torch.train import stages

    monkeypatch.setattr(stages, "ema_update", lambda ema, params, decay: None)
    out = run(root, "train-s2")
    assert not out["correct"]
    assert out["checks"]["ema_change_norm_gap"]["value"] > out["checks"]["ema_change_norm_gap"][
        "limit"]


def test_half_of_the_batch_left_out_fails(root, monkeypatch):
    from clap2diffusion_tpu_torch.train import stages

    step = stages.train_step

    def half(stage, state, batch, generator, mesh=None):
        h = batch["latent"].shape[0] // 2
        return step(stage, state, {k: v[:h] for k, v in batch.items()}, generator, mesh)

    monkeypatch.setattr(stages, "train_step", half)
    assert not run(root, "train-s2")["correct"]


def test_the_control_reads_above_a_sound_run_on_the_cpu(tmp_path):
    """At the tiny size, in bf16: the served image's gap to the float32
    reference, against the float8 control's gap."""
    from perfbench import calibrate
    from perfbench.harness import check, serve

    root = tiny.make_root(str(tmp_path), dtype="bfloat16")
    cell = common.cell(common.load_benchmark(root), "serve-b1", root)
    jobs = []
    serving = check.serving

    def keep(cfg, seed, j, dev):
        jobs.extend(j)
        return serving(cfg, seed, j, dev)

    check.serving = keep
    try:
        out = run(root, "serve-b1", seed=11)
    finally:
        check.serving = serving
    program = out["checks"]["image_mae_levels"]["value"]
    control = calibrate.serving_control(cell, 11, jobs, torch.device("cpu"))
    assert control["image_mae_levels"] > program


@pytest.mark.chip
@pytest.mark.parametrize("name", ["serve-b8", "train-s2", "serve-b1", "serve-open"])
def test_the_control_fails_and_sound_runs_pass_at_the_cell_size(chip, name, capsys):
    """The readings the limits were set from (``perfbench/calibrate.py``): a
    dozen seeds of the program under each limit, the control over one of
    them on three seeds."""
    from perfbench import calibrate

    calibrate.main(["--workload", name, "--seeds", "12", "--control", "3"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["summary"]
    limits = common.cell(common.load_benchmark(), name)["config"]["limits"]
    assert all(summary["program_max"][n] <= limits[n] for n in summary["program_max"])
    assert any(summary["control_min"][n] > limits[n] for n in summary["control_min"])
