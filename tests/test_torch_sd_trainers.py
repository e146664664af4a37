"""The port's SD SalUn trainers (``salun_torch.sd.trainers``) and sampler
(``SDModules.sample``) against ``salun.sd`` on the tiny LatentDiffusion of
``tests/test_sd.py``, with the JAX weights carried over by the bridge and
the JAX draws (posterior noise, t, noise) computed with the same
``jax.random`` calls as ``trainers.py:129-134,232,257-258`` and
``ldm.py:146-154``, then fed to the port.

Tolerances (fp32 on the CPU on both sides, other summation orders; the
networks agree to 1e-4 of their outputs, ``test_torch_sd_models.py``):
- the accumulated saliency: 2e-4 of its largest entry (each gradient sums
  over every latent pixel of the batch); the masks are exact-k on both
  sides and differ only at near-ties of the k-th value (within that
  tolerance of it), as for the DDPM mask;
- losses: 1e-5 relative;
- each step's masked gradients: 2e-4 of the largest (measured ~3e-6);
- the U-Net after one and two Adam steps (lr 1e-5): within lr. Adam
  scales every coordinate's update to about ±lr whatever its gradient's
  size, so a weight whose gradient is within rounding of 0 may move by up
  to lr either way (measured 0.35·lr and 0.52·lr at the worst weight);
  the updates of weights with gradients above 1e-3 of the largest agree
  to ~1e-4·lr after one step;
- masked-out weights: bitwise θ₀ (their grads are exactly 0, so Adam's
  m and v stay 0);
- sampled images in [0, 1]: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import salun.sd.trainers as jax_trainers
import salun_torch.sd.trainers as port_trainers
from _torch_port import nchw, one_torch_thread  # noqa: F401
from _torch_port import keep_grads, sd_perturbed_params, sd_tiny_jax, sd_twin
from salun.sd.clip_text import tokenize as jax_tokenize
from salun_torch.ckpt import sd_mask_from_jax
from salun_torch.sd.clip_text import tokenize

LR, ALPHA, T = 1e-5, 0.5, 40
LATENT = (8, 8, 4)


@pytest.fixture(scope="module")
def jax_modules():
    return sd_tiny_jax(num_timesteps=T)


@pytest.fixture(scope="module")
def params(jax_modules):
    return sd_perturbed_params(jax_modules)


def _images(rng, n):
    return rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)


def _to_port_layout(tree):
    return sd_mask_from_jax(jax.tree.map(np.asarray, tree))


# ------------------------------------------------------ mask generation


def _mask_draws(key, n, batch_size):
    """The draws of ``salun.sd.trainers.sd_generate_mask`` per batch."""
    out = []
    for i in range(0, n, batch_size):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        m = min(batch_size, n - i)
        out.append({
            "posterior": nchw(np.asarray(jax.random.normal(k1, (m,) + LATENT))),
            "t": torch.from_numpy(np.array(jax.random.randint(k2, (m,), 0,
                                                              T))),
            "noise": nchw(np.asarray(jax.random.normal(k3, (m,) + LATENT)))})
    return out


def test_generate_mask_matches_jax(jax_modules, params, monkeypatch):
    rng = np.random.default_rng(1)
    imgs = _images(rng, 4)
    prompts = ["an image of a tench"] * 4
    key = jax.random.PRNGKey(2)
    seen = {}

    def capture(tag, fn):
        def wrapped(abs_sal, thresholds):
            seen[tag] = abs_sal
            return fn(abs_sal, thresholds)
        return wrapped

    monkeypatch.setattr(jax_trainers, "generate_masks",
                        capture("jax", jax_trainers.generate_masks))
    monkeypatch.setattr(port_trainers, "generate_masks",
                        capture("port", port_trainers.generate_masks))
    want = jax_trainers.sd_generate_mask(
        jax_modules, jax.tree.map(jnp.asarray, params), jnp.asarray(imgs),
        prompts, key, guidance=7.5, batch_size=2, thresholds=(0.5,))
    sd = sd_twin(jax_modules, params)
    got = port_trainers.sd_generate_mask(
        sd, nchw(imgs), prompts, guidance=7.5, batch_size=2,
        thresholds=(0.5,), draws=_mask_draws(key, 4, 2))

    names = [n for n, _ in sd.unet.named_parameters()]
    want_sal = _to_port_layout(seen["jax"])
    scale = max(float(v.abs().max()) for v in want_sal.values())
    for name, g in zip(names, seen["port"]):
        np.testing.assert_allclose(g.numpy(), want_sal[name].numpy(),
                                   rtol=0, atol=2e-4 * scale)
    # exact-k on both sides; equal but for near-ties of the k-th value
    flat = torch.cat([want_sal[n].reshape(-1) for n in names]).numpy()
    n = flat.size
    kth = np.sort(flat)[::-1][n // 2 - 1]
    got_m = torch.cat([got[0.5][k].reshape(-1) for k in names]).numpy()
    want_m = sd_mask_from_jax(jax.tree.map(np.asarray, want[0.5]))
    want_m = torch.cat([want_m[k].reshape(-1) for k in names]).numpy()
    assert got[0.5][names[0]].dtype == torch.uint8
    assert got_m.sum() == want_m.sum() == n // 2
    differ = got_m != want_m
    assert differ.sum() <= 16
    assert np.all(np.abs(flat[differ] - kth) <= 2e-4 * scale)


# ------------------------------------------------------ random_label


def _rl_draws(key, b):
    """The draws of ``make_random_label_step``'s loss for step key
    ``key``: k1..k5, and the remain ``shared_step``'s ke, kt, kn of k1."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    ke, kt, kn = jax.random.split(k1, 3)

    def normal(k):
        return nchw(np.asarray(jax.random.normal(k, (b,) + LATENT)))

    def randint(k):
        return torch.from_numpy(np.array(jax.random.randint(k, (b,), 0, T)))

    return {"remain_posterior": normal(ke), "remain_t": randint(kt),
            "remain_noise": normal(kn), "forget_posterior": normal(k2),
            "forget_t": randint(k3), "forget_noise": normal(k4),
            "pseudo_posterior": normal(k5)}


def test_two_random_label_steps_match_jax(jax_modules, params):
    rng = np.random.default_rng(3)
    b = 2
    batches = []
    for _ in range(2):
        batches.append({
            "remain_images": _images(rng, b), "forget_images": _images(rng, b),
            "remain_ids": ["an image of a church", "an image of a golf ball"],
            "forget_ids": ["an image of a tench"] * b,
            "pseudo_ids": ["an image of a english springer"] * b})
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
    mask = jax.tree.map(lambda p: (rng.random(p.shape) < 0.5).astype(
        np.int8), params["unet"])

    def jax_batch(bt):
        return {k: (jnp.asarray(v) if k.endswith("images")
                    else jnp.asarray(jax_tokenize(v, 8)))
                for k, v in bt.items()}

    frozen = jax.tree.map(jnp.asarray, params)
    unet0 = frozen["unet"]
    # the JAX run: two steps with the masked Adam, the step's gradients
    # kept by a pass-through transformation in front of it
    tx = optax.chain(keep_grads(), jax_trainers.with_mask(
        jax_trainers.make_sd_optimizer(unet0, LR, "full"),
        jax.tree.map(jnp.asarray, mask)))
    step = jax_trainers.make_random_label_step(jax_modules, tx, alpha=ALPHA)
    carry = (jax.tree.map(jnp.copy, unet0), tx.init(unet0))
    want = []
    for bt, key in zip(batches, keys):
        carry, loss = step(carry, frozen, jax_batch(bt), key)
        want.append((float(loss), _to_port_layout(carry[0]),
                     _to_port_layout(carry[1][0]["g"])))

    sd = sd_twin(jax_modules, params)
    theta0 = {n: p.detach().clone() for n, p in sd.unet.named_parameters()}
    port_mask = sd_mask_from_jax(mask)
    opt = port_trainers.with_mask(sd.unet, LR, "full", port_mask)
    port_step = port_trainers.make_random_label_step(sd, opt, alpha=ALPHA)
    for i, (bt, key) in enumerate(zip(batches, keys)):
        batch = {k: (nchw(v) if k.endswith("images") else tokenize(v, 8))
                 for k, v in bt.items()}
        loss = port_step(batch, draws=_rl_draws(key, b))
        want_loss, want_unet, want_g = want[i]
        np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
        g_max = max(float(v.abs().max()) for v in want_g.values())
        for n, p in sd.unet.named_parameters():
            keep = port_mask[n] > 0
            np.testing.assert_allclose(p.grad.numpy(),
                                       (want_g[n] * keep).numpy(), rtol=0,
                                       atol=2e-4 * g_max)
            got = p.detach()
            np.testing.assert_allclose(got.numpy(), want_unet[n].numpy(),
                                       rtol=0, atol=LR)
            assert torch.equal(got[~keep], theta0[n][~keep]), n
    assert any(not torch.equal(p.detach(), theta0[n])
               for n, p in sd.unet.named_parameters())


# ------------------------------------------------------ sampling


def test_ddim_sample_matches_jax(jax_modules, params):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2,) + LATENT).astype(np.float32)
    prompts = ["an image of a tench", "an image of a church"]
    want = jax_modules.sample(jax.tree.map(jnp.asarray, params),
                              jax.random.PRNGKey(0), prompts, guidance=7.5,
                              steps=4, image_size=8, eta=0.0,
                              initial_latents=jnp.asarray(z))
    sd = sd_twin(jax_modules, params)
    got = sd.sample(prompts, guidance=7.5, steps=4, image_size=8, eta=0.0,
                    initial_latents=nchw(z))
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-4)
