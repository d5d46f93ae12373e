"""The port's samplers against the JAX package's, on the CPU in fp32.

Each sampler runs on the same fixed eps function (it reads the latents
and t, so the loop's plumbing shows) from the same latents, with and
without an img2img tail grid and an inpainting ``blend_fn``. The
stochastic sampler gets JAX's own draws, ``normal(fold_in(key, i), shape)``
one per step (scalar key) or per lane (a key per image), through its draw
callable. Tolerance: 1e-5 (absolute and relative), fp32 summation and
transcendental differences between XLA:CPU and PyTorch, nothing more.
The timestep grids are integers and must be equal, errors included.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.core.config import SchedulerConfig
from clap2diffusion_tpu.diffusion import ddim as jd
from clap2diffusion_tpu_torch.core.config import SchedulerConfig as PortSchedulerConfig
from clap2diffusion_tpu_torch.diffusion import ddim as pd

torch.set_num_threads(2)

TOL = 1e-5
STEPS = 10


def to_torch(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def sched():
    return jd.NoiseSchedule.create(SchedulerConfig()), pd.NoiseSchedule.create(
        PortSchedulerConfig())


def _inputs(b=1, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    e = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    x0 = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    noise = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    m = np.zeros((1, 8, 8, 1), np.float32)
    m[:, :, 4:] = 1.0
    m[:, :, 3] = 0.5  # a soft column, as the 8x8 block mean gives at a mask's edge
    return x, e, x0, noise, m


def _eps_fns(e):
    return (lambda lat, t: lat * 0.1 + e * (t / 1000.0),
            lambda lat, t: lat * 0.1 + to_torch(e) * (t / 1000.0))


def _blend_fns(js, ps, x0, noise, m):
    """The pipeline's inpainting blend, written in each framework."""
    b = x0.shape[0]

    def jblend(lat, t_prev):
        tp = jnp.full((b,), jnp.maximum(t_prev, 0), jnp.int32)
        known = jnp.where(t_prev >= 0, js.add_noise(x0, noise, tp), x0)
        return (m * lat.astype(jnp.float32) + (1.0 - m) * known).astype(lat.dtype)

    px0, pnoise, pm = to_torch(x0), to_torch(noise), to_torch(m)

    def pblend(lat, t_prev):
        known = px0
        if t_prev >= 0:
            known = ps.add_noise(px0, pnoise, torch.full((b,), t_prev, dtype=torch.long))
        return (pm * lat.float() + (1.0 - pm) * known).to(lat.dtype)

    return jblend, pblend


@pytest.mark.parametrize("blend", [False, True], ids=["plain", "blend"])
@pytest.mark.parametrize("tail", [False, True], ids=["full_grid", "img2img_tail"])
@pytest.mark.parametrize("name", ["ddim", "dpmpp_2m", "dpmpp_2m_karras"])
def test_deterministic_sampler_matches_jax(sched, name, tail, blend):
    js, ps = sched
    x, e, x0, noise, m = _inputs()
    jeps, peps = _eps_fns(e)
    jts = jd.img2img_timesteps(STEPS, 0.6) if tail else None
    pts = pd.img2img_timesteps(STEPS, 0.6) if tail else None
    jblend, pblend = _blend_fns(js, ps, x0, noise, m) if blend else (None, None)
    ref = jd.SAMPLERS[name](jeps, js, x, STEPS, timesteps=jts, blend_fn=jblend)
    ours = pd.SAMPLERS[name](peps, ps, to_torch(x), STEPS, timesteps=pts, blend_fn=pblend)
    close(ours, ref)


def _jax_draw(key, per_lane):
    """JAX's euler_a draws as the port's draw callable."""
    def draw(i, shape):
        if per_lane:
            z = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, i), shape[1:]))(key)
        else:
            z = jax.random.normal(jax.random.fold_in(key, i), shape)
        return to_torch(z)
    return draw


@pytest.mark.parametrize("blend", [False, True], ids=["plain", "blend"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["scalar_key", "per_lane_keys"])
def test_euler_ancestral_matches_jax_with_its_draws(sched, per_lane, blend):
    js, ps = sched
    x, e, x0, noise, m = _inputs(b=2)
    jeps, peps = _eps_fns(e)
    key = jax.random.split(jax.random.key(11), 2) if per_lane else jax.random.key(7)
    jblend, pblend = _blend_fns(js, ps, x0, noise, m) if blend else (None, None)
    ref = jd.euler_ancestral_sample(jeps, js, x, STEPS, blend_fn=jblend, rng=key)
    ours = pd.euler_ancestral_sample(peps, ps, to_torch(x), STEPS, blend_fn=pblend,
                                     rng=_jax_draw(key, per_lane))
    close(ours, ref)
    # it is stochastic: the noise moved it off the DDIM path
    assert float((ours - pd.ddim_sample(peps, ps, to_torch(x), STEPS)).abs().mean()) > 1e-3


def test_euler_ancestral_img2img_tail_matches_jax(sched):
    js, ps = sched
    x, e, _, _, _ = _inputs()
    jeps, peps = _eps_fns(e)
    key = jax.random.key(3)
    ref = jd.euler_ancestral_sample(jeps, js, x, STEPS, timesteps=jd.img2img_timesteps(STEPS, 0.5),
                                    rng=key)
    ours = pd.euler_ancestral_sample(peps, ps, to_torch(x), STEPS,
                                     timesteps=pd.img2img_timesteps(STEPS, 0.5),
                                     rng=_jax_draw(key, False))
    close(ours, ref)


def test_euler_ancestral_rng_errors(sched):
    _, ps = sched
    x, e, _, _, _ = _inputs(b=2)
    _, peps = _eps_fns(e)
    with pytest.raises(ValueError, match="stochastic"):
        pd.euler_ancestral_sample(peps, ps, to_torch(x), 4)
    one = pd.generator_draw([torch.Generator().manual_seed(1)])
    with pytest.raises(ValueError, match="per-lane rng"):
        pd.euler_ancestral_sample(peps, ps, to_torch(x), 4, rng=one)


def test_generator_draw_lanes_are_batch_independent(sched):
    """A per-lane generator stream gives lane i the same noise whatever the
    batch: the coalescing contract of the per-lane keys."""
    _, ps = sched
    x = _inputs(b=2)[0]
    peps = lambda lat, t: torch.tanh(lat) * 0.1 + t / 1000.0  # noqa: E731  lane by lane
    gens = lambda *seeds: pd.generator_draw(  # noqa: E731
        [torch.Generator().manual_seed(s) for s in seeds])
    duo = pd.euler_ancestral_sample(peps, ps, to_torch(x), 6, rng=gens(7, 5))
    solo = pd.euler_ancestral_sample(peps, ps, to_torch(x[1:]), 6, rng=gens(5))
    torch.testing.assert_close(duo[1:], solo, rtol=0, atol=0)
    scalar = pd.generator_draw(torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(scalar(0, (1, 8, 8, 4)).numpy(),
                                  gens(5)(0, (1, 8, 8, 4)).numpy())


@pytest.mark.parametrize("steps", [1, 2, 3, 10, 20, 50, 200, 999, 1000, 1001, 1500])
def test_karras_timesteps_equal_jax(sched, steps):
    js, ps = sched
    try:
        want = np.asarray(jd.karras_timesteps(steps, js))
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            pd.karras_timesteps(steps, ps)
        return
    got = pd.karras_timesteps(steps, ps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diff(want) < 0).all()


@pytest.mark.parametrize("steps,strength", [(50, 0.6), (50, 1.0), (3, 1 / 3), (3, 0.67),
                                            (10, 0.05), (20, 0.5), (7, 0.999), (1, 0.3),
                                            (50, 0.0), (50, -0.2), (50, 1.5)])
def test_img2img_timesteps_equal_jax(steps, strength):
    try:
        want = np.asarray(jd.img2img_timesteps(steps, strength))
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            pd.img2img_timesteps(steps, strength)
        return
    np.testing.assert_array_equal(pd.img2img_timesteps(steps, strength).numpy(), want)


def test_sampler_registry_matches_jax():
    assert sorted(pd.SAMPLERS) == sorted(jd.SAMPLERS)
