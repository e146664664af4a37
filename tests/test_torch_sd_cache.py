"""``--cache_vae_moments`` in the port: ``make_cache_batch_fn`` and the
cached random_label step (``salun_torch.sd.trainers``), against the port's
own uncached step and against ``salun.sd.trainers``' cached step, on the
tiny LatentDiffusion of ``tests/test_sd.py``.

Tolerances:
- port against port on the same generator: bitwise. The cache runs the
  same encoders on the same tensors, the cached loss draws the same
  numbers in the same order, so loss, gradients and the Adam update are
  the same operations on the same values;
- against JAX (fp32 on the CPU, other summation orders): the cached
  moments and contexts 1e-4 of their largest value; the loss 1e-5
  relative, the masked gradients 2e-4 of the largest, the U-Net within lr
  after the Adam step, as ``tests/test_torch_sd_trainers.py`` holds the
  uncached step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import salun.sd.trainers as jax_trainers
import salun_torch.sd.trainers as port_trainers
from _torch_port import nchw, nhwc, one_torch_thread  # noqa: F401
from _torch_port import keep_grads, sd_perturbed_params, sd_tiny_jax, sd_twin
from salun.sd.clip_text import tokenize as jax_tokenize
from salun_torch.ckpt import sd_mask_from_jax, sd_mask_to_jax
from salun_torch.sd.clip_text import tokenize

LR, ALPHA, T, B = 1e-5, 0.5, 40, 2
LATENT = (8, 8, 4)


@pytest.fixture(scope="module")
def jax_modules():
    return sd_tiny_jax(num_timesteps=T)


@pytest.fixture(scope="module")
def params(jax_modules):
    return sd_perturbed_params(jax_modules)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return {"remain_images": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(
                np.float32),
            "forget_images": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(
                np.float32),
            "remain_ids": ["an image of a church", "an image of a golf ball"],
            "forget_ids": ["an image of a tench"] * B,
            "pseudo_ids": ["an image of a english springer"] * B}


def _port_batch(bt):
    return {k: (nchw(v) if k.endswith("images") else tokenize(v, 8))
            for k, v in bt.items()}


def _port_run(jax_modules, params, bt, cached, mask, **step_kw):
    sd = sd_twin(jax_modules, params)
    opt = port_trainers.with_mask(sd.unet, LR, "full", mask)
    b = _port_batch(bt)
    if cached:
        b = port_trainers.make_cache_batch_fn(sd, cached)(b)
    loss = port_trainers.make_random_label_step(
        sd, opt, alpha=ALPHA, cached=cached)(b, **step_kw)
    return sd, loss


@pytest.fixture(scope="module")
def port_mask(params):
    rng = np.random.default_rng(8)
    return {k: torch.from_numpy((rng.random(tuple(v.shape)) < 0.5).astype(
        np.uint8)) for k, v in sd_mask_from_jax(params["unet"]).items()}


@pytest.mark.parametrize("mode", ["forget", "all"])
def test_cached_step_equals_uncached_bitwise(jax_modules, params, batch,
                                             port_mask, mode):
    runs = {}
    for cached in (False, mode):
        gen = torch.Generator().manual_seed(3)
        runs[cached] = _port_run(jax_modules, params, batch, cached,
                                 port_mask, generator=gen)
    (sd0, loss0), (sd1, loss1) = runs[False], runs[mode]
    assert torch.equal(loss0, loss1)
    theta0 = sd_mask_from_jax(params["unet"])
    moved = 0
    for (n, a), b in zip(sd0.unet.named_parameters(), sd1.unet.parameters()):
        assert torch.equal(a.grad, b.grad), n
        assert torch.equal(a.detach(), b.detach()), n
        moved += int((a.detach() != theta0[n]).sum())
    assert moved > 0


def _jax_draws(key):
    """The cached step's draws for step key ``key`` (trainers.py:232-258:
    k1 → the remain step's ke, kt, kn; then k2, k3, k4, k5)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    ke, kt, kn = jax.random.split(k1, 3)

    def normal(k):
        return nchw(np.asarray(jax.random.normal(k, (B,) + LATENT)))

    def randint(k):
        return torch.from_numpy(np.array(jax.random.randint(k, (B,), 0, T)))

    return {"remain_posterior": normal(ke), "remain_t": randint(kt),
            "remain_noise": normal(kn), "forget_posterior": normal(k2),
            "forget_t": randint(k3), "forget_noise": normal(k4),
            "pseudo_posterior": normal(k5)}


@pytest.mark.parametrize("mode", ["forget", "all"])
def test_cached_step_matches_jax(jax_modules, params, batch, port_mask,
                                 mode):
    frozen = jax.tree.map(jnp.asarray, params)
    jb = {k: (jnp.asarray(v) if k.endswith("images")
              else jnp.asarray(jax_tokenize(v, 8))) for k, v in batch.items()}
    cache = jax_trainers.make_cache_batch_fn(jax_modules, mode)(frozen, jb)

    sd = sd_twin(jax_modules, params)
    got_cache = port_trainers.make_cache_batch_fn(sd, mode)(
        _port_batch(batch))
    assert set(got_cache) == set(cache)
    for k, want in cache.items():
        for g, w in zip(*((got_cache[k], want) if isinstance(want, tuple)
                          else ((got_cache[k],), (want,)))):
            w = np.asarray(w)
            g = nhwc(g) if w.ndim == 4 else np.asarray(g)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)

    jmask = jax.tree.map(jnp.asarray, sd_mask_to_jax(port_mask))
    unet0 = frozen["unet"]
    tx = optax.chain(keep_grads(), jax_trainers.with_mask(
        jax_trainers.make_sd_optimizer(unet0, LR, "full"), jmask))
    step = jax_trainers.make_random_label_step(jax_modules, tx, alpha=ALPHA,
                                               cached=mode)
    key = jax.random.PRNGKey(60)
    carry = (jax.tree.map(jnp.copy, unet0), tx.init(unet0))
    carry, loss = step(carry, {} if mode == "all" else frozen, cache, key)
    want_unet = sd_mask_from_jax(jax.tree.map(np.asarray, carry[0]))
    want_g = sd_mask_from_jax(jax.tree.map(np.asarray, carry[1][0]["g"]))

    theta0 = {n: p.detach().clone() for n, p in sd.unet.named_parameters()}
    opt = port_trainers.with_mask(sd.unet, LR, "full", port_mask)
    got = port_trainers.make_random_label_step(sd, opt, alpha=ALPHA,
                                               cached=mode)(
        got_cache, draws=_jax_draws(key))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    g_max = max(float(v.abs().max()) for v in want_g.values())
    for n, p in sd.unet.named_parameters():
        keep = port_mask[n] > 0
        np.testing.assert_allclose(p.grad.numpy(), (want_g[n] * keep).numpy(),
                                   rtol=0, atol=2e-4 * g_max, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(), want_unet[n].numpy(),
                                   rtol=0, atol=LR, err_msg=n)
        assert torch.equal(p.detach()[~keep], theta0[n][~keep]), n
