"""The request as one device program (``diffusion/program.py``), on the CPU.

The JAX package compiles ``_generate_jit`` once per static signature
(``clap2diffusion_tpu/diffusion/pipeline.py:310``, ``static_argnums=(0, 5,
7, 9, 12, 13)``); the port captures its device program into a CUDA graph
once per ``Signature``. On the CPU the same program runs eagerly. At
``tests/test_pipeline.py::tiny_config`` in fp32, from the port's own
random weights:

- (a) the signature: dynamic values share a key; statics, input shapes
  and types, optional inputs and the opt-in routes do not;
- (b) the program reads no device value on the host and copies nothing
  from the host, for every request kind: it runs under a dispatch mode
  that raises on ``aten._local_scalar_dense``, ``aten.nonzero`` and
  ``aten.lift_fresh``, after one warm-up run, as a capture does;
- (c) the stochastic sampler's noise drawn ahead equals the loop's draws
  at tolerance 0, for one generator, per-lane seeds and ``DataSlice`` rows;
- (d) the dynamic scalars are read from their buffers: a buffer rewritten
  gives a fresh request's bits at the new value;
- (f) the cache of programs, with a stand-in for the CUDA graph: a weight
  update (``load_state_dict``, in place, ``.to()``) drops every graph and
  the next request is captured anew; at most ``CAPACITY`` graphs are kept,
  the least recently used dropped first; every kernel counter of the ops
  modules is in the registry a replay adds to.

Each kind's whole request against the JAX ``_generate_jit`` with the JAX
draws fed in is ``tests/test_torch_generate.py::
test_request_matches_jax_with_its_draws``, whose port side is this program.
"""

import functools
import importlib
import pkgutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from clap2diffusion_tpu_torch.core.config import SchedulerConfig
from clap2diffusion_tpu_torch.diffusion.ddim import (
    NoiseSchedule,
    euler_ancestral_sample,
    generator_draw,
    predraw,
    sampler_timesteps,
    stacked_draw,
)
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, RequestDraws
from clap2diffusion_tpu_torch import ops
from clap2diffusion_tpu_torch.diffusion import program as prog
from clap2diffusion_tpu_torch.diffusion.program import ROUTE_FLAGS, Programs, Signature
from clap2diffusion_tpu_torch.models.layers import DataSlice
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

SIZE, MAX_LEN, STEPS = 64, 7, 3  # tiny_config's image size and CLIP length
IDS = (np.arange(MAX_LEN)[None] % 97).astype(np.int32)
SCHEDULE = NoiseSchedule.create(SchedulerConfig())


def _wav(seed, n=24_000):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(np.float32)


def _init(seed):
    return np.random.default_rng(seed).integers(0, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)


def _half_mask():
    m = np.zeros((SIZE, SIZE), np.uint8)
    m[:, SIZE // 2:] = 255
    return m


@pytest.fixture(scope="module")
def pipe():
    return AudioToImagePipeline(port_cfg(tiny_config()), seed=0, device="cpu")


def prepared(pipe, **kw):
    """The (signature, inputs) that ``generate(**kw)`` gives its device
    program, by the same checks and host preparation."""
    got = {}

    def spy(sig, x):
        got["sig"], got["x"] = sig, x
        return torch.zeros((), dtype=torch.uint8)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(pipe, "_program", spy)
        pipe._dispatch_generate(**kw)
    return got["sig"], got["x"]


BASE = dict(waveform=_wav(0), text_ids=IDS, num_steps=STEPS, seed=0)


def test_dynamic_values_share_a_signature(pipe):
    key = prepared(pipe, **BASE)[0]
    same = [dict(guidance_scale=3.0), dict(seed=5), dict(norm_target=30.0),
            dict(temperature=0.9), dict(audio_mix=0.2), dict(guidance_rescale=0.5),
            dict(waveform=_wav(1)), dict(text_ids=IDS[:, ::-1].copy()),
            dict(uncond_ids=IDS)]
    for kw in same:
        assert prepared(pipe, **{**BASE, **kw})[0] == key, kw
    mix = dict(BASE, waveform2=_wav(2))
    assert prepared(pipe, **mix)[0] == prepared(pipe, **mix, audio_mix=0.9)[0]
    lanes = dict(BASE, text_ids=np.repeat(IDS, 2, 0), batch=2, seeds=[5, 7])
    assert prepared(pipe, **lanes)[0] == prepared(pipe, **dict(lanes, seeds=[1, 2]))[0]


def test_statics_shapes_and_presence_change_the_signature(pipe, monkeypatch):
    two = dict(text_ids=np.repeat(IDS, 2, 0), batch=2)
    variants = {
        "num_steps": dict(num_steps=STEPS + 1),
        "model_type": dict(model_type="sonic"),
        "batch": two,
        "sampler": dict(sampler="euler_a"),
        "init_steps": dict(init_image=_init(1), strength=0.67),
        "pcm16": dict(waveform=(_wav(0) * 3e4).astype(np.int16)),
        "samples": dict(waveform=_wav(0, n=12_000)),
        "text_only": dict(waveform=None),
        "waveform2": dict(waveform2=_wav(2)),
        "mask": dict(init_image=_init(1), strength=1.0, mask_image=_half_mask()),
        "seeds": dict(seeds=[3]),
        "clip_length": dict(text_ids=IDS[:, :5], uncond_ids=np.zeros((1, 5), np.int32)),
    }
    keys = {"base": prepared(pipe, **BASE)[0]}
    for name, kw in variants.items():
        keys[name] = prepared(pipe, **{**BASE, **kw})[0]
    # one waveform for a batch of 2 (expanded on the device) against two
    keys["batch_two_waveforms"] = prepared(
        pipe, **{**BASE, **two, "waveform": np.stack([_wav(0), _wav(1)])})[0]
    keys["strength"] = prepared(pipe, **{**BASE, "init_image": _init(1), "strength": 1.0})[0]
    for flag in ROUTE_FLAGS:
        monkeypatch.setenv(flag, "0" if flag in ("C2D_INT8_CONV", "C2D_FUSED_QKV") else "1")
        keys[flag] = prepared(pipe, **BASE)[0]
        monkeypatch.delenv(flag)
    assert len(set(keys.values())) == len(keys), [
        (a, b) for a in keys for b in keys if a < b and keys[a] == keys[b]]


class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a device value on the host or copies host
    data to a tensor: what a CUDA stream capture refuses."""

    BANNED = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.lift_fresh)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED:
            raise AssertionError(f"the device program calls {func}")
        return func(*args, **(kwargs or {}))


KINDS = {
    "ddim": dict(waveform=_wav(0), text_ids=IDS),
    "dpmpp_2m": dict(waveform=_wav(0), text_ids=IDS, sampler="dpmpp_2m"),
    "dpmpp_2m_karras": dict(waveform=_wav(0), text_ids=IDS, sampler="dpmpp_2m_karras"),
    "euler_a": dict(waveform=_wav(0), text_ids=IDS, sampler="euler_a"),
    "text_only": dict(text_ids=IDS),
    "pcm16": dict(waveform=(_wav(3) * 3e4).astype(np.int16), text_ids=IDS),
    "audio_mix": dict(waveform=_wav(5), waveform2=_wav(6), audio_mix=0.3, text_ids=IDS),
    "img2img": dict(waveform=_wav(1), text_ids=IDS, init_image=_init(7), strength=0.67),
    "inpainting": dict(waveform=_wav(2), text_ids=IDS, init_image=_init(13), strength=1.0,
                       mask_image=_half_mask()),
    "seeds": dict(waveform=_wav(7), text_ids=np.repeat(IDS, 2, 0), batch=2, seeds=[5, 7],
                  sampler="euler_a"),
    "sonic": dict(waveform=_wav(0), text_ids=IDS, model_type="sonic"),
    "baseline": dict(waveform=_wav(0), text_ids=IDS, model_type="baseline"),
    "audio_tokens": dict(waveform=_wav(0), text_ids=IDS, model_type="audio_tokens"),
}


@pytest.mark.parametrize("name", list(KINDS))
def test_program_reads_no_host_value(pipe, name):
    kw = dict(KINDS[name], num_steps=STEPS, seed=4)
    sig, x = prepared(pipe, **kw)
    with torch.inference_mode():
        warm = pipe._program(sig, x)  # the warm-up: constants made at first use
        with NoHostRead():
            got = pipe._program(sig, x)
    torch.testing.assert_close(got, warm, rtol=0, atol=0)
    assert got.shape == (kw.get("batch", 1), SIZE, SIZE, 3) and got.dtype == torch.uint8
    # and it is what generate returns
    np.testing.assert_array_equal(got.numpy(), pipe.generate(**kw))


def _spy_euler(rng, shape, steps=4):
    """euler_a on a fixed eps function with ``rng``: (latents, the draws it
    asked for, in order, the grid)."""
    asked = []

    def spy(i, s):
        asked.append(rng(i, s))
        return asked[-1]

    lat = torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)
    ts = list(sampler_timesteps("euler_a", SCHEDULE, steps))
    out = euler_ancestral_sample(lambda x, t: 0.1 * x + 1e-3 * t, SCHEDULE, lat, steps,
                                 timesteps=ts, rng=spy)
    return out, asked, ts


@pytest.mark.parametrize("source", ["one_generator", "per_lane_seeds", "data_slice_rows",
                                    "request_draws", "request_draws_seeds", "request_rows"])
def test_predrawn_noise_is_the_loops_draws(source):
    shape = (2, 8, 8, 4)
    makers = {
        "one_generator": lambda: generator_draw(torch.Generator().manual_seed(3)),
        "per_lane_seeds": lambda: generator_draw(
            [torch.Generator().manual_seed(s) for s in (5, 7)]),
        "data_slice_rows": lambda: generator_draw(
            DataSlice(torch.Generator().manual_seed(3), 1, 2)),
        "request_draws": lambda: RequestDraws("cpu", 11).sampler(),
        "request_draws_seeds": lambda: RequestDraws("cpu", 11, seeds=[5, 7]).sampler(),
        "request_rows": lambda: RequestDraws("cpu", 11, rows=(1, 3)).sampler(),
    }
    make = makers[source]
    want, asked, ts = _spy_euler(make(), shape)
    stack = predraw(make(), ts, shape)
    assert stack.shape == (len(ts) - 1, *shape) and len(asked) == len(ts) - 1
    torch.testing.assert_close(stack, torch.stack(asked), rtol=0, atol=0)
    got, _, _ = _spy_euler(stacked_draw(stack), shape)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_predraw_checks_lanes_and_draws_nothing_for_one_step():
    lanes = generator_draw([torch.Generator().manual_seed(s) for s in (5, 7)])
    with pytest.raises(ValueError, match="per-lane rng has 2 keys for batch 3"):
        predraw(lanes, (901, 1), (3, 8, 8, 4))
    assert predraw(lanes, (1,), (2, 8, 8, 4)).shape == (0, 2, 8, 8, 4)


@pytest.mark.parametrize("name,first,second", [("guidance_scale", 7.5, 3.0),
                                               ("temperature", 0.5, 2.0),
                                               ("norm_target", 60.0, 20.0)])
def test_dynamic_values_come_from_buffers(pipe, name, first, second):
    kw = dict(KINDS["ddim"], num_steps=STEPS, seed=2)
    sig, x = prepared(pipe, **kw, **{name: first})
    fresh_sig, fresh = prepared(pipe, **kw, **{name: second})
    assert fresh_sig == sig
    with torch.inference_mode():
        before = pipe._program(sig, x)
        x[name].fill_(second)  # the buffer rewritten, nothing rebuilt
        with NoHostRead():
            rewritten = pipe._program(sig, x)
        want = pipe._program(fresh_sig, fresh)
    torch.testing.assert_close(rewritten, want, rtol=0, atol=0)
    assert not torch.equal(before, want), f"{name} does not reach the image"


class StandIn:
    """A captured program on the CPU: the program run at every replay."""

    def __init__(self, program, inputs):
        self.program, self.replays, self.capture_s, self.pool_bytes = program, 0, 0.0, 0
        self.device_bytes = 0
        self.launches = {}

    def __call__(self, inputs):
        self.replays += 1
        return self.program(inputs)


def stand_in(monkeypatch, programs):
    """``programs`` captures stand-ins; returns the list of those made."""
    made = []

    def capture(program, inputs):
        made.append(StandIn(program, inputs))
        return made[-1]

    monkeypatch.setattr(programs, "_capture", capture)
    return made


def _sig(steps, x):
    return Signature.of(x, num_steps=steps, model_type="hierarchical", batch=1,
                        sampler="ddim", init_steps=0, per_lane_seeds=False)


def test_pipeline_weights_loaded_again_capture_again(pipe, monkeypatch):
    programs = Programs(pipe._weights)
    made = stand_in(monkeypatch, programs)
    sig, x = prepared(pipe, **BASE)
    program = functools.partial(pipe._program, sig)
    with torch.inference_mode():
        first = programs.run(sig, x, program)
        programs.run(sig, x, program)
    assert len(made) == 1 and made[0].replays == 2
    pipe.unet.load_state_dict(pipe.unet.state_dict())  # in place, the same values
    with torch.inference_mode():
        again = programs.run(sig, x, program)
    assert len(made) == 2 and list(programs.captured.values()) == [made[1]]
    torch.testing.assert_close(again, first, rtol=0, atol=0)


@pytest.mark.parametrize("update", ["none", "load_state_dict", "in_place", "to"])
def test_a_weight_update_drops_every_graph(monkeypatch, update):
    lin = torch.nn.Linear(3, 2).requires_grad_(False)
    programs = Programs(lin.parameters)
    made = stand_in(monkeypatch, programs)
    x = {"a": torch.ones(1, 3)}

    def program(inputs):
        return lin(inputs["a"].to(lin.weight.dtype))

    for steps in (1, 2):
        programs.run(_sig(steps, x), x, program)
    {"none": lambda: None,
     "load_state_dict": lambda: lin.load_state_dict({k: v + 1 for k, v in
                                                     lin.state_dict().items()}),
     "in_place": lambda: lin.bias.add_(1),
     "to": lambda: lin.to(torch.float64)}[update]()
    got = programs.run(_sig(1, x), x, program)
    torch.testing.assert_close(got, lin(x["a"].to(lin.weight.dtype)), rtol=0, atol=0)
    if update == "none":
        assert len(made) == 2 and made[0].replays == 2
    else:  # both graphs dropped, the request's captured anew
        assert len(made) == 3 and list(programs.captured.values()) == [made[2]]


def test_the_least_recently_used_graph_goes_first(monkeypatch):
    monkeypatch.setattr(prog, "CAPACITY", 2)
    programs = Programs(tuple)
    made = stand_in(monkeypatch, programs)
    x = {"a": torch.ones(1)}
    for steps in (1, 2, 1, 3):  # 1 used again after 2: 2 is dropped for 3
        programs.run(_sig(steps, x), x, lambda inputs: inputs["a"])
    assert [s.num_steps for s in programs.captured] == [1, 3]
    programs.run(_sig(2, x), x, lambda inputs: inputs["a"])
    assert [s.num_steps for s in programs.captured] == [3, 2] and len(made) == 4


def test_every_kernel_counter_is_registered():
    """A counter outside the registry would keep its capture's counts and
    miss its replays'."""
    modules = [importlib.import_module(f"{ops.__name__}.{info.name}")
               for info in pkgutil.iter_modules(ops.__path__)]
    registered = {(id(o), a) for o, a in prog.COUNTERS.values()}
    for module in modules:
        for value in vars(module).values():
            for attr in ("launches", "shapes", "calls", "designs"):
                if hasattr(value, attr) and not isinstance(value, type):
                    assert (id(value), attr) in registered, (module.__name__, value, attr)


def test_a_replay_adds_what_the_capture_counted():
    """The capture's counts are taken back out and added once per replay,
    a counter that joined the registry while the program ran included."""
    from clap2diffusion_tpu_torch.ops import counters
    from clap2diffusion_tpu_torch.ops import flash_attention as fa

    def late():
        pass

    before = prog._snapshot()
    try:
        fa.flash_attention.launches += 3
        fa.flash_attention.shapes["q"] += 3
        counters.kernel(late)  # a module imported during the capture
        late.launches += 2
        captured = prog._delta(before, prog._snapshot())
        prog._restore(before)
        assert (fa.flash_attention.launches, late.launches) == (before[
            "flash_attention.launches"], 0)
        for _ in range(2):
            prog._add(captured)
        assert fa.flash_attention.launches == before["flash_attention.launches"] + 6
        assert fa.flash_attention.shapes["q"] == before["flash_attention.shapes"]["q"] + 6
        assert late.launches == 4
    finally:
        for name in ("late.launches", "late.shapes"):
            counters.COUNTERS.pop(name, None)
        prog._restore(before)
