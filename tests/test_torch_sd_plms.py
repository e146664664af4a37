"""The port's PLMS chain, ``SDModules.sample`` and the LDM lr schedules
against ``salun``.

- ``plms_steps`` against ``salun.diffusion.sampling.plms_steps`` with one
  eps function (a fixed linear map of x and t) at 1, 2, 4 and 6 steps, so
  that the bootstrap and each Adams-Bashforth order run: within 1e-5 of
  the largest value (fp32, other operation orders); the eps calls number
  one more than the grid's points.
- ``SDModules.sample(sampler="plms"|"ddim")`` against JAX's ``sample`` on
  the tiny yaml (``_torch_port.write_tiny_sd``) with the same weights and
  initial latents at 4 steps, with negative prompts and ``return_latents``
  on one side of each: latents and images within 1e-4 of their largest
  value (fp32 U-Net, VAE and CLIP summed in other orders).
- The three lr schedules against ``salun.sd.lr_schedules``: warm-up and
  linear values bitwise (the same fp32 operations); cosine values within
  1 ulp of the cosine times the half-range, since XLA's fp32 cosine and
  the port's (double, rounded) differ by up to 1 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nchw, nhwc, one_torch_thread, write_tiny_sd  # noqa: F401
from salun.diffusion.sampling import plms_steps as jax_plms
from salun.sd import import_compvis
from salun.sd import lr_schedules as jax_lr
from salun.sd.config import modules_from_yaml
from salun.sd.ldm import sd_schedule as jax_sd_schedule
from salun_torch.ckpt import load_compvis_state_dict
from salun_torch.diffusion.sampling import ldm_uniform_timesteps, plms_steps
from salun_torch.sd import lr_schedules
from salun_torch.sd.config import load_sd_config, modules_from_config
from salun_torch.sd.ldm import sd_schedule


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("steps", [1, 2, 4, 6])
@pytest.mark.parametrize("final", [True, False])
def test_plms_steps_match_jax(steps, final):
    seq = ldm_uniform_timesteps(1000, steps)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    port_s, jax_s = sd_schedule(), jax_sd_schedule()
    final_ab = float(port_s.alphas_cumprod[0]) if final else None
    calls = []

    def eps(xx, t):
        calls.append(t)
        return 0.3 * xx + 1e-3 * t.reshape(-1, 1, 1, 1)

    want, want_x0 = jax_plms(eps, jnp.asarray(x), seq, jax_s,
                             final_alpha_bar=final_ab)
    calls.clear()
    got, got_x0 = plms_steps(eps, nchw(x), seq, port_s,
                             final_alpha_bar=final_ab)
    _close(nhwc(got), want, 1e-5)
    _close(nhwc(got_x0), want_x0, 1e-5)
    assert len(calls) == len(seq) + 1
    # the bootstrap's second call is at t_next (−1 at one step), float32
    assert calls[1].dtype == torch.float32
    assert float(calls[1][0]) == (seq[-2] if steps > 1 else -1)


@pytest.fixture(scope="module")
def tiny_sd(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plms")
    cfg_path, ckpt = write_tiny_sd(tmp)
    port = modules_from_config(load_sd_config(str(cfg_path)))
    from salun_torch.ckpt import load_sd_modules

    sd = load_compvis_state_dict(str(ckpt))
    load_sd_modules(port, sd)
    jax_modules = modules_from_yaml(str(cfg_path))
    templates = jax.eval_shape(lambda k: jax_modules.init(k, image_size=8),
                               jax.random.PRNGKey(0))
    params = import_compvis({k: v.numpy() for k, v in sd.items()}, templates)
    return port, jax_modules, params


@pytest.mark.parametrize("sampler,negative,latents", [
    ("plms", True, True), ("plms", False, False), ("ddim", True, False)])
def test_sample_matches_jax(tiny_sd, sampler, negative, latents):
    port, jax_modules, params = tiny_sd
    prompts = ["an image of a tench", "the cat"]
    neg = ["blurry", ""] if negative else None
    z = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    kw = dict(negative_prompts=neg, guidance=3.0, steps=4, image_size=8,
              return_latents=latents, sampler=sampler)
    want = jax_modules.sample(params, jax.random.PRNGKey(0), prompts,
                              initial_latents=jnp.asarray(z), **kw)
    got = port.sample(prompts, initial_latents=nchw(z), **kw)
    assert tuple(got.shape) == ((2, 4, 8, 8) if latents else (2, 3, 64, 64))
    _close(nhwc(got), want, 1e-4)
    if not latents:
        assert 0.0 <= float(got.min()) <= float(got.max()) <= 1.0


def test_sample_rejects_an_unknown_sampler(tiny_sd):
    with pytest.raises(ValueError):
        tiny_sd[0].sample(["x"], steps=2, image_size=8, sampler="dpm")


def _ulp(x):
    return float(np.spacing(np.float32(abs(x))))


def test_warmup_cosine_matches_jax():
    args = (100, 0.01, 1.0, 0.001, 1000)
    got, want = lr_schedules.warmup_cosine(*args), jax_lr.warmup_cosine(*args)
    for n in [0, 1, 50, 99, 100, 101, 333, 500, 999, 1000, 5000]:
        g, w = got(n), np.float32(want(n))
        assert isinstance(g, np.float32)
        if n < 100:
            assert g == w, n
        else:
            assert abs(g - w) <= _ulp(0.5 * 0.99 * 2), n


@pytest.mark.parametrize("name", ["lambda_linear", "warmup_cosine2"])
def test_cycle_schedules_match_jax(name):
    args = ([100, 200], [0.0, 0.1], [1.0, 0.5], [1e-6, 1e-2], [1000, 2000])
    got, want = getattr(lr_schedules, name)(*args), getattr(jax_lr, name)(
        *args)
    for n in [0, 5, 99, 100, 500, 999, 1000, 1001, 1099, 1100, 1199, 1200,
              2500, 2999, 3000, 5000]:
        g, w = got(n), np.float32(want(n))
        c = 0 if n <= 1000 else 1
        in_warmup = n - (0, 1000)[c] < args[0][c]
        if name == "lambda_linear" or in_warmup:
            assert g == w, n
        else:
            assert abs(g - w) <= _ulp(args[2][c] - args[1][c]), n
