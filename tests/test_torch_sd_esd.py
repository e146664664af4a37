"""The port's ESD pieces (``salun_torch.sd.trainers``: ``esd_bucket``,
``partial_denoise``, ``make_esd_step``; ``SDModules.partial_sample_latent``)
against ``salun.sd`` on the tiny LatentDiffusion of ``tests/test_sd.py``,
the JAX weights carried over by the bridge and the JAX draws (t_enc,
t_ddpm, the chain's initial z) fed to the port.

Tolerances (fp32 on the CPU on both sides): the bucket edges exactly (fp32
arithmetic and half-to-even rounding on both sides); the partial chains
1e-4 of the latents' largest value (up to four CFG U-Net forwards, each
within 1e-4 of its outputs, ``test_torch_sd_models.py``); the ESD step's
loss 1e-5 relative, its gradients 2e-4 of the largest and the U-Net
within lr of JAX's after the Adam step, as
``tests/test_torch_sd_trainers.py`` holds random_label.
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

LR, T, DDIM = 1e-5, 40, 4
LATENT = (8, 8, 4)


@pytest.fixture(scope="module")
def jax_modules():
    return sd_tiny_jax(num_timesteps=T)


@pytest.fixture(scope="module")
def params(jax_modules):
    return jax.tree.map(jnp.asarray, sd_perturbed_params(jax_modules))


@pytest.fixture(scope="module")
def sd(jax_modules, params):
    return sd_twin(jax_modules, jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def contexts(jax_modules, params, sd):
    """(JAX, port) CLIP contexts of a concept word and of the empty
    prompt, batch 1."""
    out = {}
    for name, word in (("p", "nudity"), ("0", "")):
        out[name] = (jax_modules.encode_text(
            params, jnp.asarray(jax_tokenize([word], 8))),
            sd.encode_text(tokenize([word], 8)))
    return out


def test_esd_bucket_matches_jax():
    """og = round(t_enc/ddim_steps·T) half-to-even in fp32; (1, 16, 40)
    and (3, 16, 40) land on 2.5 and 7.5."""
    assert port_trainers.esd_bucket(1, 16, 40) == (2, 5)
    assert port_trainers.esd_bucket(3, 16, 40) == (8, 10)
    for ddim_steps, T_ in ((16, 40), (50, 1000), (3, 1000), (7, 1000),
                           (4, 10)):
        for t_enc in range(ddim_steps):
            t = jnp.asarray(t_enc)
            og = int(jnp.round(t.astype(jnp.float32) / ddim_steps * T_
                               ).astype(jnp.int32))
            og_lim = int(jnp.round((t + 1).astype(jnp.float32) / ddim_steps
                                   * T_).astype(jnp.int32))
            assert port_trainers.esd_bucket(t_enc, ddim_steps, T_) == (
                og, og_lim), (t_enc, ddim_steps, T_)


@pytest.fixture(scope="module")
def jax_partial_denoise(jax_modules):
    """salun's ``_partial_denoise`` jitted once, t_enc traced."""
    def run(p, ctx, ctx_0, t_enc, key):
        return jax_trainers._partial_denoise(jax_modules, p, ctx, t_enc,
                                             DDIM, 8, 3.0, ctx_0, key)

    return jax.jit(run)


@pytest.mark.parametrize("t_enc", [0, 1, 3])
def test_partial_denoise_matches_jax(params, sd, contexts,
                                     jax_partial_denoise, t_enc):
    key = jax.random.PRNGKey(30 + t_enc)
    (jp, pp), (j0, p0) = contexts["p"], contexts["0"]
    want = np.asarray(jax_partial_denoise(params, jp, j0, jnp.int32(t_enc),
                                          key))
    _, nk = jax.random.split(key)
    z0 = nchw(np.asarray(jax.random.normal(nk, (1,) + LATENT)))
    got = port_trainers.partial_denoise(sd, pp, t_enc, DDIM, 8, 3.0, p0,
                                        z=z0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4 * np.abs(want).max())
    if t_enc == DDIM - 1:  # the first grid step only: z moved
        assert not torch.equal(got, z0)


def test_partial_sample_latent_matches_jax(jax_modules, params, sd,
                                           contexts):
    (jp, pp), (j0, p0) = contexts["p"], contexts["0"]
    key = jax.random.PRNGKey(40)
    want = np.asarray(jax_modules.partial_sample_latent(
        params, key, jp, t_target=12, steps=DDIM, image_size=8,
        guidance=3.0, uncond_ctx=j0))
    _, nk = jax.random.split(key)
    z0 = nchw(np.asarray(jax.random.normal(nk, (1,) + LATENT)))
    got = sd.partial_sample_latent(pp, t_target=12, steps=DDIM,
                                   image_size=8, guidance=3.0,
                                   uncond_ctx=p0, initial_latents=z0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4 * np.abs(want).max())
    # nothing above the target: the initial noise itself
    top = sd.partial_sample_latent(pp, t_target=T, steps=DDIM, image_size=8,
                                   initial_latents=z0)
    assert torch.equal(top, z0)


def test_esd_step_matches_jax(jax_modules, params, contexts):
    tx = optax.chain(keep_grads(), jax_trainers.make_sd_optimizer(
        params["unet"], LR, "full"))
    step = jax_trainers.make_esd_step(jax_modules, tx, negative_guidance=1.0,
                                      start_guidance=3.0, ddim_steps=DDIM,
                                      image_size=8)
    (jp, pp), (j0, p0) = contexts["p"], contexts["0"]
    key = jax.random.PRNGKey(50)
    carry = (jax.tree.map(jnp.copy, params["unet"]), tx.init(params["unet"]))
    carry, loss = step(carry, params, jp, j0, jp, key)
    want_unet = sd_mask_from_jax(jax.tree.map(np.asarray, carry[0]))
    want_g = sd_mask_from_jax(jax.tree.map(np.asarray, carry[1][0]["g"]))

    # the step's draws: t_enc (k1), t_ddpm in its bucket (k2), z (k3)
    k1, k2, k3 = jax.random.split(key, 3)
    t_enc = int(jax.random.randint(k1, (), 0, DDIM))
    og, og_lim = port_trainers.esd_bucket(t_enc, DDIM, T)
    t_ddpm = np.array(jax.random.randint(k2, (1,), og, max(og_lim, og + 1)))
    _, nk = jax.random.split(k3)
    draws = {"t_enc": t_enc, "t_ddpm": torch.from_numpy(t_ddpm),
             "z": nchw(np.asarray(jax.random.normal(nk, (1,) + LATENT)))}

    port = sd_twin(jax_modules, jax.tree.map(np.asarray, params))
    teacher = port_trainers.frozen_copy(port.unet)
    theta0 = {n: p.detach().clone() for n, p in teacher.named_parameters()}
    opt = port_trainers.make_sd_optimizer(port.unet, LR, "full")
    got, got_t_enc = port_trainers.make_esd_step(
        port, opt, teacher, 1.0, 3.0, DDIM, 8)(pp, p0, pp, draws=draws)
    assert got_t_enc == t_enc
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    g_max = max(float(v.abs().max()) for v in want_g.values())
    for n, p in port.unet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), rtol=0,
                                   atol=2e-4 * g_max, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(), want_unet[n].numpy(),
                                   rtol=0, atol=LR, err_msg=n)
    # the teacher: outside the optimizer, unchanged bitwise
    for n, p in teacher.named_parameters():
        assert not p.requires_grad and p.grad is None
        assert torch.equal(p, theta0[n]), n
    assert not all(torch.equal(p.detach(), theta0[n])
                   for n, p in port.unet.named_parameters())
