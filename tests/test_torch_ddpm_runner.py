"""The port's DDPM runner (``salun_torch.diffusion.runner``) against
``salun.diffusion.runner`` on the TINY U-Net: mask generation with
injected t/e, one ``rl`` and one ``ga`` step with JAX's draws replayed,
and the clip → grad mask → Adam chain against the optax one.

Tolerances (fp32 on the CPU on both sides, other summation orders; the
U-Net itself agrees to ~1e-5 of its outputs, ``test_torch_ddpm.py``):
- losses: 1e-5 relative;
- gradients and the accumulated saliency: 2e-4 of the largest entry
  (each gradient sums over every pixel of the batch, and the clip divides
  by a norm that carries the same rounding);
- parameters after two Adam steps: 1e-6 absolute (one Adam step moves a
  weight by ≤ lr = 1e-3; torch and optax round the same formula at other
  places, a few ulp of that);
- masked-out weights: bitwise θ₀ (their grads are exactly 0, so Adam's
  m and v stay 0 and the update is exactly 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import salun.diffusion.runner as jax_runner_mod
import salun_torch.diffusion.runner as port_runner_mod
from _torch_port import ddpm_twin, nchw, perturb_vectors
from salun.diffusion import DiffusionSchedule as JaxSchedule
from salun.diffusion import UNetConfig as JaxUNetConfig
from salun.diffusion import antithetic_timesteps as jax_antithetic
from salun.diffusion.runner import DDPMRunner as JaxRunner
from salun.diffusion.runner import DDPMTrainConfig as JaxTrainConfig
from salun.diffusion.runner import make_optimizer as jax_make_optimizer
from salun_torch.ckpt import (ddpm_mask_from_jax, ddpm_mask_to_jax,
                              ddpm_state_dict_from_jax)
from salun_torch.core.masked_opt import clip_by_global_norm, mask_grads
from salun_torch.diffusion import DiffusionSchedule
from salun_torch.diffusion.runner import (DDPMRunner, DDPMTrainConfig,
                                          make_optimizer)
from salun_torch.diffusion.unet import ResnetBlock, UNetConfig

# cond-drop off: flax derives its cond-drop key from the module scope,
# which the port cannot replay; every other draw is replayed
TINY = JaxUNetConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), dropout=0.0, in_channels=3,
                     image_size=16, n_classes=4, cond_drop_prob=0.0)
T = 50


def _train_cfg(cls, **kw):
    base = dict(batch_size=8, lr=1e-3, method="rl", label_to_forget=1,
                alpha=0.5, cond_drop_prob=0.0, cond_scale=2.0)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def params():
    runner = JaxRunner(TINY, JaxSchedule.create(num_diffusion_timesteps=T),
                       JaxTrainConfig())
    init = jax.tree.map(np.asarray, runner.init(jax.random.PRNGKey(0)))
    return perturb_vectors(init, np.random.default_rng(1))


def _runners(**kw):
    jax_r = JaxRunner(TINY, JaxSchedule.create(num_diffusion_timesteps=T),
                      _train_cfg(JaxTrainConfig, **kw))
    port_r = DDPMRunner(UNetConfig(**{f.name: getattr(TINY, f.name)
                                      for f in dataclasses.fields(
                                          UNetConfig)}),
                        DiffusionSchedule.create(num_diffusion_timesteps=T),
                        _train_cfg(DDPMTrainConfig, **kw))
    return jax_r, port_r


def _batch(rng, n=8, label=None):
    img = rng.integers(0, 256, (n, 16, 16, 3)).astype(np.uint8)
    lab = (np.full(n, label) if label is not None
           else rng.integers(0, 4, n)).astype(np.int32)
    return {"image": img, "label": lab}


def _port_grads_in_jax_layout(model, grads):
    names = [n for n, _ in model.named_parameters()]
    return ddpm_mask_to_jax(dict(zip(names, grads)))


def _assert_trees_close(got, want, frac):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=frac * scale)


# ------------------------------------------------------ mask generation


def test_generate_mask_with_injected_t_e_matches_jax(params, monkeypatch):
    jax_r, port_r = _runners(random_flip=False)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        b = _batch(rng)
        b["t"] = rng.integers(0, T, 8).astype(np.int32)
        b["e"] = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
        batches.append(b)

    seen = {}

    def capture(tag, fn):
        def wrapped(abs_sal, thresholds):
            seen[tag] = abs_sal
            return fn(abs_sal, thresholds)
        return wrapped

    monkeypatch.setattr(jax_runner_mod, "generate_masks",
                        capture("jax", jax_runner_mod.generate_masks))
    monkeypatch.setattr(port_runner_mod, "generate_masks",
                        capture("port", port_runner_mod.generate_masks))
    want = jax_r.generate_mask(params, batches, jax.random.PRNGKey(0),
                               thresholds=(0.5,))
    model = ddpm_twin(TINY, params)
    port_batches = [dict(b, e=nchw(b["e"])) for b in batches]
    got = port_r.generate_mask(model, port_batches, thresholds=(0.5,))

    sal = _port_grads_in_jax_layout(model, seen["port"])
    _assert_trees_close(sal, seen["jax"], 2e-4)
    # Exact-k on both sides; the masks are equal except where two
    # saliencies within the tolerance of each other straddle the k-th
    # value (a near-tie that fp32 rounding may order either way).
    flat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(sal)])
    n = flat.size
    kth = np.sort(flat)[::-1][n // 2 - 1]
    tol = 2e-4 * float(flat.max())
    got_m = np.concatenate([np.ravel(x) for x in jax.tree.leaves(
        ddpm_mask_to_jax(got[0.5]))])
    want_m = np.concatenate([np.ravel(np.asarray(x))
                             for x in jax.tree.leaves(want[0.5])])
    assert got_m.sum() == want_m.sum() == n // 2
    differ = got_m != want_m
    assert differ.sum() <= 4
    assert np.all(np.abs(flat[differ] - kth) <= tol)


# ------------------------------------------------------ one unlearn step


def _capture_grads():
    """An optax transformation that applies no update and keeps the grads
    in its state: the JAX step's gradients, read from its carry."""
    def init(p):
        return {"g": jax.tree.map(jnp.zeros_like, p)}

    def update(g, state, p=None):
        return jax.tree.map(jnp.zeros_like, g), {"g": g}

    return optax.GradientTransformation(init, update)


def _jax_draws(key, n, shape):
    """The draws of ``make_saliency_unlearn_step``'s loss for step key
    ``key`` (split into k1..k5, kf1, kf2), NCHW for the port."""
    k1, k2, k3, k4, k5, kf1, kf2 = jax.random.split(key, 7)

    def half(kf, kt, ke):
        return {"flips": torch.from_numpy(np.array(
                    jax.random.bernoulli(kf, 0.5, (n,)))),
                "t": torch.from_numpy(np.array(jax_antithetic(kt, n, T))),
                "e": nchw(np.asarray(jax.random.normal(ke, shape)))}

    return {"remain": half(kf1, k1, k2), "forget": half(kf2, k4, k5)}


@pytest.mark.parametrize("method", ["rl", "ga"])
def test_unlearn_step_loss_and_grads_match_jax(params, method):
    jax_r, port_r = _runners(method=method)
    rng = np.random.default_rng(3)
    remain, forget = _batch(rng), _batch(rng, label=1)
    key = jax.random.PRNGKey(4)

    tx = _capture_grads()
    step = jax_r.make_saliency_unlearn_step(tx)
    p = jax.tree.map(jnp.asarray, params)
    (_, state, _), want_loss = step((p, tx.init(p), None), remain, forget,
                                    key)

    model = ddpm_twin(TINY, params)
    loss = port_r.unlearn_loss(model, remain, forget,
                               draws=_jax_draws(key, 8, (8, 16, 16, 3)))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(_port_grads_in_jax_layout(model, grads),
                        state["g"], 2e-4)


def test_rl_out_and_pseudo_share_cond_drop_and_dropout_masks(monkeypatch):
    """With dropout and cond-drop on, the ``out`` forward and the
    ``pseudo`` forward of ``rl`` draw the same masks (JAX shares one
    ``rngs`` dict between them, ``runner.py:306-316``)."""
    cfg = UNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), dropout=0.3, image_size=16,
                     n_classes=4, cond_drop_prob=0.5)
    runner = DDPMRunner(cfg, DiffusionSchedule.create(
        num_diffusion_timesteps=T), _train_cfg(DDPMTrainConfig,
                                               cond_drop_prob=0.5))
    model = runner.init(0)
    drawn = []
    rand = torch.rand

    def recording_rand(*args, **kw):
        out = rand(*args, **kw)
        drawn.append(out.clone())
        return out

    monkeypatch.setattr(torch, "rand", recording_rand)
    rng = np.random.default_rng(5)
    runner.unlearn_loss(model, _batch(rng), _batch(rng, label=1),
                        generator=torch.Generator().manual_seed(6))
    # one cond-drop draw, then one dropout draw per ResnetBlock
    per_forward = 1 + sum(isinstance(m, ResnetBlock) for m in model.modules())
    out_draws = drawn[-2 * per_forward:-per_forward]
    pseudo_draws = drawn[-per_forward:]
    assert out_draws[0].shape == (8,)  # the cond-drop draw comes first
    for a, b in zip(out_draws, pseudo_draws):
        assert torch.equal(a, b)


# ------------------------------------------------------ the optimizer


def test_clip_by_global_norm_is_optax_rule():
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):  # clips / leaves alone
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update(grads, clip.init(grads))
        got = clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                  max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
    masked = mask_grads([torch.ones(3)], [torch.tensor([1.0, 0.0, 1.0])])
    assert masked[0].tolist() == [1.0, 0.0, 1.0]


def test_two_steps_of_clip_mask_adam_match_optax(params):
    rng = np.random.default_rng(8)
    mask = jax.tree.map(lambda p: (rng.random(p.shape) < 0.5).astype(
        np.float32), params)
    # step 1 above the clip norm (clipped), step 2 below it (unchanged)
    steps = []
    for scale in (1.0, 1e-3):
        g = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)
                                    ).astype(np.float32), params)
        steps.append(g)
    cfg = _train_cfg(JaxTrainConfig)
    tx = jax_make_optimizer(cfg, mask=jax.tree.map(jnp.asarray, mask))
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)

    @jax.jit
    def apply(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for g in steps:
        p, state = apply(g, state, p)

    model = ddpm_twin(TINY, params)
    theta0 = {n: t.detach().clone() for n, t in model.named_parameters()}
    opt = make_optimizer(model, _train_cfg(DDPMTrainConfig),
                         ddpm_mask_from_jax(mask))
    for g in steps:
        sd = ddpm_state_dict_from_jax(g)
        for n, t in model.named_parameters():
            t.grad = sd[n].clone()
        opt.step()
    got = ddpm_state_dict_from_jax(jax.tree.map(np.asarray, p))
    kept = 0
    for n, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), got[n].numpy(),
                                   rtol=0, atol=1e-6)
        m = ddpm_mask_from_jax(mask)[n] > 0
        assert torch.equal(t.detach()[~m], theta0[n][~m])
        kept += int((t.detach()[m] != theta0[n][m]).sum())
    assert kept > 0


def test_step_keeps_the_ema_as_jax_ema_update(params):
    """With ``ema: true`` the step updates shadow ← (1−μ)·θ + μ·shadow
    after the optimizer step, as ``salun.diffusion.ema.ema_update``
    (one rounding of the same two products and sum: 1e-6 relative)."""
    from salun.diffusion.ema import ema_update as jax_ema_update

    _, port_r = _runners(ema=True, ema_rate=0.9)
    model = ddpm_twin(TINY, params)
    names = [n for n, _ in model.named_parameters()]
    theta0 = [p.detach().clone() for p in model.parameters()]
    step = port_r.make_saliency_unlearn_step(
        model, make_optimizer(model, port_r.cfg))
    rng = np.random.default_rng(9)
    step(_batch(rng), _batch(rng, label=1), torch.Generator().manual_seed(0))
    want = jax_ema_update(
        jax.tree.map(jnp.asarray, ddpm_mask_to_jax(
            dict(zip(names, model.parameters())))),
        jax.tree.map(jnp.asarray, ddpm_mask_to_jax(dict(zip(names, theta0)))),
        0.9)
    got = ddpm_mask_to_jax(step.shadow)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
