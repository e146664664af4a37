"""The port's other SD trainers (``salun_torch.sd.trainers``: gradient
ascent, nsfw_removal, proximal) against ``salun.sd.trainers`` on the tiny
LatentDiffusion of ``tests/test_sd.py``, with the JAX weights carried over
by the bridge and the JAX draws fed to the port, as
``tests/test_torch_sd_trainers.py`` does for random_label.

Tolerances, as there (fp32 on the CPU on both sides, other summation
orders): losses 1e-5 relative; each step's masked gradients 2e-4 of the
largest; the U-Net after an Adam step within lr (a weight whose gradient
is within rounding of 0 may move by up to lr either way); masked-out
weights bitwise θ₀. The proximal shrink is held exactly: on the same
input τ equals JAX's bitwise, the set pinned to θ₀ is the same and every
shrunk weight equals JAX's bitwise (the same fp32 operations). The
shrink count schedule is integer arithmetic: equal.
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
from salun.dist.topk import kth_largest_threshold as jax_kth
from salun.sd.clip_text import tokenize as jax_tokenize
from salun_torch.ckpt import sd_mask_from_jax, sd_mask_to_jax
from salun_torch.sd import data as sd_data
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
def mask(params):
    rng = np.random.default_rng(7)
    return jax.tree.map(lambda p: (rng.random(p.shape) < 0.5).astype(
        np.int8), params["unet"])


@pytest.fixture(scope="module")
def jax_tx(params, mask):
    unet0 = jax.tree.map(jnp.asarray, params["unet"])
    return optax.chain(keep_grads(), jax_trainers.with_mask(
        jax_trainers.make_sd_optimizer(unet0, LR, "full"),
        jax.tree.map(jnp.asarray, mask)))


@pytest.fixture(scope="module")
def jax_rl_step(jax_modules, jax_tx):
    """salun's random_label step (= its nsfw_removal step), compiled once
    for this module."""
    assert jax_trainers.make_nsfw_removal_step is \
        jax_trainers.make_random_label_step
    return jax_trainers.make_nsfw_removal_step(jax_modules, jax_tx,
                                               alpha=ALPHA)


def _images(rng, n):
    return rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)


def _normal(k):
    return nchw(np.asarray(jax.random.normal(k, (B,) + LATENT)))


def _randint(k):
    return torch.from_numpy(np.array(jax.random.randint(k, (B,), 0, T)))


def _shared_step_draws(key, side):
    ke, kt, kn = jax.random.split(key, 3)
    return {f"{side}_posterior": _normal(ke), f"{side}_t": _randint(kt),
            f"{side}_noise": _normal(kn)}


def _rl_draws(key):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {**_shared_step_draws(k1, "remain"),
            "forget_posterior": _normal(k2), "forget_t": _randint(k3),
            "forget_noise": _normal(k4), "pseudo_posterior": _normal(k5)}


def _batch(rng, forget_prompt, pseudo_prompt, remain_prompts):
    return {"remain_images": _images(rng, B), "forget_images": _images(rng, B),
            "remain_ids": remain_prompts, "forget_ids": [forget_prompt] * B,
            "pseudo_ids": [pseudo_prompt] * B}


def _jax_batch(bt):
    return {k: (jnp.asarray(v) if k.endswith("images")
                else jnp.asarray(jax_tokenize(v, 8)))
            for k, v in bt.items()}


def _port_batch(bt):
    return {k: (nchw(v) if k.endswith("images") else tokenize(v, 8))
            for k, v in bt.items()}


def _run_jax(step, tx, params, batch, key):
    frozen = jax.tree.map(jnp.asarray, params)
    unet0 = frozen["unet"]
    carry = (jax.tree.map(jnp.copy, unet0), tx.init(unet0))
    carry, loss = step(carry, frozen, _jax_batch(batch), key)
    return (float(loss), sd_mask_from_jax(jax.tree.map(np.asarray, carry[0])),
            sd_mask_from_jax(jax.tree.map(np.asarray, carry[1][0]["g"])))


def _check_step(sd, loss, theta0, port_mask, want):
    want_loss, want_unet, want_g = want
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    g_max = max(float(v.abs().max()) for v in want_g.values())
    for n, p in sd.unet.named_parameters():
        keep = port_mask[n] > 0
        np.testing.assert_allclose(p.grad.numpy(), (want_g[n] * keep).numpy(),
                                   rtol=0, atol=2e-4 * g_max, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(), want_unet[n].numpy(),
                                   rtol=0, atol=LR, err_msg=n)
        assert torch.equal(p.detach()[~keep], theta0[n][~keep]), n
    assert any(not torch.equal(p.detach(), theta0[n])
               for n, p in sd.unet.named_parameters())


def _port(jax_modules, params, mask):
    sd = sd_twin(jax_modules, params)
    theta0 = {n: p.detach().clone() for n, p in sd.unet.named_parameters()}
    port_mask = sd_mask_from_jax(mask)
    return sd, theta0, port_mask, port_trainers.with_mask(
        sd.unet, LR, "full", port_mask)


def test_gradient_ascent_step_matches_jax(jax_modules, params, mask, jax_tx):
    bt = _batch(np.random.default_rng(1), "an image of a tench",
                "unused", ["an image of a church", "an image of a golf ball"])
    bt.pop("pseudo_ids")
    key = jax.random.PRNGKey(20)
    step = jax_trainers.make_gradient_ascent_step(jax_modules, jax_tx,
                                                  alpha=ALPHA)
    want = _run_jax(step, jax_tx, params, bt, key)
    sd, theta0, port_mask, opt = _port(jax_modules, params, mask)
    k1, k2 = jax.random.split(key)
    draws = {**_shared_step_draws(k1, "forget"),
             **_shared_step_draws(k2, "remain")}
    loss = port_trainers.make_gradient_ascent_step(sd, opt, alpha=ALPHA)(
        _port_batch(bt), draws=draws)
    _check_step(sd, loss, theta0, port_mask, want)


def test_nsfw_removal_step_matches_jax(jax_modules, params, mask, jax_tx,
                                       jax_rl_step):
    assert port_trainers.make_nsfw_removal_step is \
        port_trainers.make_random_label_step
    nude, wear = sd_data.WORD_NUDE, sd_data.WORD_WEAR
    assert (nude, wear) == ("a photo of a nude person",
                            "a photo of a person wearing clothes")
    bt = _batch(np.random.default_rng(2), nude, wear, [wear] * B)
    key = jax.random.PRNGKey(21)
    want = _run_jax(jax_rl_step, jax_tx, params, bt, key)
    sd, theta0, port_mask, opt = _port(jax_modules, params, mask)
    loss = port_trainers.make_nsfw_removal_step(sd, opt, alpha=ALPHA)(
        _port_batch(bt), draws=_rl_draws(key))
    _check_step(sd, loss, theta0, port_mask, want)


@pytest.fixture(scope="module")
def proximal_run(jax_modules, params, mask, jax_tx, jax_rl_step):
    """One random_label step on each side (the proximal subcommand's
    step) from the same weights and draws."""
    bt = _batch(np.random.default_rng(3), "an image of a tench",
                "an image of a english springer",
                ["an image of a church", "an image of a golf ball"])
    key = jax.random.PRNGKey(22)
    want = _run_jax(jax_rl_step, jax_tx, params, bt, key)
    sd, theta0, port_mask, opt = _port(jax_modules, params, mask)
    loss = port_trainers.make_random_label_step(sd, opt, alpha=ALPHA)(
        _port_batch(bt), draws=_rl_draws(key))
    return sd, theta0, port_mask, loss, want


def test_proximal_step_matches_jax(proximal_run):
    sd, theta0, port_mask, loss, want = proximal_run
    _check_step(sd, loss, theta0, port_mask, want)


@pytest.mark.parametrize("share", [0.25, 0.75], ids=["ties_at_zero",
                                                      "above_the_ties"])
def test_proximal_shrink_matches_jax(proximal_run, share):
    """The shrink on the port's post-step U-Net against JAX's on the same
    input. Half the weights are masked out and sit exactly at θ₀, so at
    ratio = n/4 τ is 0 (a mass of exact ties) and at 3n/4 τ > 0."""
    sd, theta0, _, _, _ = proximal_run
    names = [n for n, _ in sd.unet.named_parameters()]
    after = {n: p.detach().clone() for n, p in sd.unet.named_parameters()}
    n = sum(v.numel() for v in after.values())
    ratio = int(share * n)

    j_after = jax.tree.map(jnp.asarray, sd_mask_to_jax(after, np.float32))
    j_theta0 = jax.tree.map(jnp.asarray, sd_mask_to_jax(theta0, np.float32))
    diffs = jax.tree.map(lambda p, t: jnp.abs(p - t), j_after, j_theta0)
    want_tau = float(jax_kth(diffs, n - ratio + 1))
    want = sd_mask_from_jax(jax.tree.map(
        np.asarray, jax_trainers.proximal_shrink(
            jax.tree.map(jnp.copy, j_after), j_theta0, jnp.int32(ratio))))

    params = [after[k] for k in names]
    tau = port_trainers.proximal_shrink(params, [theta0[k] for k in names],
                                        ratio)
    assert float(tau) == want_tau and (want_tau == 0) == (share < 0.5)
    pinned = 0
    for k, p in zip(names, params):
        assert torch.equal(p, want[k]), k
        pinned += int((p == theta0[k]).sum())
    flat = torch.cat([(sd.unet.get_parameter(k).detach() - theta0[k])
                      .abs().reshape(-1) for k in names])
    # every |θ − θ₀| ≤ τ was pinned: at least ``ratio`` entries, more by
    # the ties at τ; after one Adam step most kept weights sit ≈ lr from
    # θ₀, so a few just above τ also round onto θ₀ when moved by τ
    assert pinned >= int((flat <= tau).sum()) >= ratio


def test_proximal_ratio_matches_jax():
    n_total = 859_520_964 + 83_653_863 + 123_060_480
    for epoch in range(3):
        for step in range(0, 40, 7):
            for nf, nr, epochs in ((4, 225, 3), (16, 2300, 5), (1, 1, 1)):
                args = (0.5, epoch, step, nf, nr, epochs, n_total)
                assert (port_trainers.proximal_ratio(*args)
                        == jax_trainers.proximal_ratio(*args)), args
