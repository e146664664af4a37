"""The port's DDPM model pieces against ``salun.diffusion`` on the TINY
U-Net of ``tests/test_ddpm.py``: the weight/mask bridge (against
``salun.ckpt.export_ddpm_unet`` as the oracle), eps with an explicit
``keep_mask`` and ``cfg_eps``, the schedule and both samplers, all on the
same numpy-seeded inputs and the same JAX draws.

Tolerances: both sides run fp32 on the CPU (JAX at "highest" matmul
precision) with other summation orders in convolutions, GroupNorm and
attention; eps outputs of magnitude ~2.5 agree to ~1e-5 (measured
3e-6 for eps, 8e-6 for CFG eps, whose (1+s)·eps_c − s·eps_∅ triples the
error), so the bound is 5e-5. A sampling chain feeds each step's output
to the next, so it gets 2e-4. Schedules are computed in float64 on both
sides and cast once: bitwise, or 1e-6 after the float32 square root.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ddpm_twin, nchw, nhwc, perturb_vectors
from salun.ckpt import export_ddpm_unet
from salun.diffusion import DiffusionSchedule as JaxSchedule
from salun.diffusion import UNetConfig as JaxUNetConfig
from salun.diffusion import antithetic_timesteps as jax_antithetic
from salun.diffusion import cfg_eps as jax_cfg_eps
from salun.diffusion import q_sample as jax_q_sample
from salun.diffusion.runner import DDPMRunner as JaxRunner
from salun.diffusion.runner import DDPMTrainConfig as JaxTrainConfig
from salun.diffusion.sampling import (ddpm_steps as jax_ddpm_steps,
                                      generalized_steps as jax_generalized,
                                      make_conditional_eps_fn)
from salun_torch.ckpt import (ddpm_mask_from_jax, ddpm_mask_to_jax,
                              ddpm_state_dict_from_jax, load_ddpm_states,
                              save_ddpm_states)
from salun_torch.diffusion import (DiffusionSchedule, antithetic_timesteps,
                                   cfg_eps, ddpm_steps, generalized_steps,
                                   q_sample)
from salun_torch.diffusion.unet import attention_sites
from salun_torch.kernels import flash_attention as fa

TINY = JaxUNetConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), dropout=0.0, in_channels=3,
                     image_size=16, n_classes=4, cond_drop_prob=0.1)
T = 50


@pytest.fixture(scope="module")
def jax_runner():
    return JaxRunner(TINY, JaxSchedule.create(num_diffusion_timesteps=T),
                     JaxTrainConfig())


@pytest.fixture(scope="module")
def params(jax_runner):
    init = jax.tree.map(np.asarray, jax_runner.init(jax.random.PRNGKey(0)))
    return perturb_vectors(init, np.random.default_rng(1))


@pytest.fixture(scope="module")
def apply(jax_runner):
    """The flax forward, jitted (eager flax dispatches op by op)."""
    return jax.jit(jax_runner.model.apply, static_argnames="train")


@pytest.fixture(scope="module")
def twin(params):
    return ddpm_twin(TINY, params)


def _inputs(rng, n=4):
    x = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, T, n).astype(np.float32)
    c = rng.integers(0, 4, n).astype(np.int32)
    return x, t, c


# ------------------------------------------------------------- bridge


def test_state_dict_from_jax_equals_export_ddpm_unet(params, twin):
    want = export_ddpm_unet(params)
    got = ddpm_state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    # the port's module names are exactly the reference's
    assert sorted(twin.state_dict()) == sorted(want)


def test_mask_bridge_round_trips(params, tmp_path):
    rng = np.random.default_rng(2)
    mask = jax.tree.map(lambda p: (rng.random(p.shape) < 0.5).astype(
        np.float32), params)
    sd = ddpm_mask_from_jax(mask)
    assert sorted(sd) == sorted(export_ddpm_unet(mask))
    for a, b in zip(jax.tree.leaves(ddpm_mask_to_jax(sd)),
                    jax.tree.leaves(mask)):
        np.testing.assert_array_equal(a, b)


def test_ddpm_states_writer_and_reader(twin, tmp_path):
    path = str(tmp_path / "ckpts" / "ckpt.pth")
    sd = twin.state_dict()
    save_ddpm_states(path, sd, {}, 7, ema_sd=sd)
    model_sd, step, ema_sd = load_ddpm_states(path)
    assert step == 7 and sorted(model_sd) == sorted(ema_sd) == sorted(sd)
    assert all(torch.equal(model_sd[k], sd[k]) for k in sd)


# ------------------------------------------------------------- U-Net


def test_eps_with_explicit_keep_mask_matches_flax(apply, params, twin):
    x, t, c = _inputs(np.random.default_rng(3))
    keep = np.array([True, False, True, False])
    want = apply({"params": params}, x, t, c, train=False, keep_mask=keep)
    got = twin(nchw(x), torch.from_numpy(t), torch.from_numpy(c),
               keep_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize("cond_scale", [0.0, 2.0])
def test_cfg_eps_matches_flax(jax_runner, params, twin, cond_scale):
    x, t, c = _inputs(np.random.default_rng(4))
    want = jax.jit(lambda x, t, c: jax_cfg_eps(
        jax_runner.model, {"params": params}, x, t, c, cond_scale))(x, t, c)
    before = fa.flash_attention_fwd.launches
    got = cfg_eps(twin, nchw(x), torch.from_numpy(t), torch.from_numpy(c),
                  cond_scale)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    assert fa.flash_attention_fwd.launches == before  # CPU: plain version


def test_attention_sites(twin):
    """One AttnBlock call (one K2 launch) per block, each called once per
    forward: 4 in TINY (down 1, mid 1, up 2 at 8x8), 6 in the CIFAR-10
    model (down 2, up 3 at 16x16, mid 1 at 4x4)."""
    from salun_torch.diffusion import UNetConfig
    from salun_torch.diffusion.unet import AttnBlock

    n_blocks = sum(isinstance(m, AttnBlock) for m in twin.modules())
    assert attention_sites(twin.cfg) == n_blocks == 4
    assert attention_sites(UNetConfig()) == 6


# ------------------------------------------------------------- schedule


def test_schedule_matches_jax():
    for kind in ("linear", "quad", "sigmoid"):
        want = JaxSchedule.create(beta_schedule=kind,
                                  num_diffusion_timesteps=T,
                                  var_type="fixedsmall")
        got = DiffusionSchedule.create(beta_schedule=kind,
                                       num_diffusion_timesteps=T,
                                       var_type="fixedsmall")
        for name in ("betas", "alphas_cumprod", "logvar"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name))
    sched = DiffusionSchedule.create(num_diffusion_timesteps=T)
    t = torch.tensor([-1, 0, 17, T - 1])
    np.testing.assert_array_equal(
        sched.alpha_bar(t).numpy(),
        np.asarray(JaxSchedule.create(num_diffusion_timesteps=T).alpha_bar(
            jnp.asarray(t.numpy()))))
    assert float(sched.alpha_bar(torch.tensor([-1]))[0]) == 1.0


def test_q_sample_matches_jax():
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    e = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 3, 20, T - 1])
    want = jax_q_sample(x0, jnp.asarray(t), e,
                        JaxSchedule.create(num_diffusion_timesteps=T))
    got = q_sample(nchw(x0), torch.from_numpy(t), nchw(e),
                   DiffusionSchedule.create(num_diffusion_timesteps=T))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n", [7, 8])
def test_antithetic_timesteps_on_injected_draws(n):
    key = jax.random.PRNGKey(n)
    want = np.asarray(jax_antithetic(key, n, T))
    base = np.array(jax.random.randint(key, (n // 2 + 1,), 0, T))
    got = antithetic_timesteps(n, T, base=torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = antithetic_timesteps(n, T,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (n,) and bool(((drawn >= 0) & (drawn < T)).all())
    torch.testing.assert_close(drawn[n // 2 + 1:],
                               T - 1 - drawn[:n - n // 2 - 1])


# ------------------------------------------------------------- samplers


def _chain_inputs(seed):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    c = np.array([1, 3], np.int32)
    return x_T, c


def _jax_step_noise(key, n_steps, shape):
    """The per-step noise JAX's chains draw: k, sub = split(k) per step."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(nchw(np.asarray(jax.random.normal(sub, shape))))
    return out


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_generalized_steps_matches_jax(jax_runner, params, twin, eta):
    x_T, c = _chain_inputs(6)
    seq = list(range(0, T, 10))
    key = jax.random.PRNGKey(7)
    eps_fn = make_conditional_eps_fn(jax_runner.model, {"params": params},
                                     jnp.asarray(c), 2.0)
    want, _ = jax_generalized(eps_fn, jnp.asarray(x_T), seq,
                              jax_runner.schedule, eta=eta, key=key)
    sched = DiffusionSchedule.create(num_diffusion_timesteps=T)
    tc = torch.from_numpy(c)
    with torch.no_grad():
        got, _ = generalized_steps(
            lambda x, t: cfg_eps(twin, x, t, tc, 2.0), nchw(x_T), seq, sched,
            eta=eta, noise=_jax_step_noise(key, len(seq), x_T.shape))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_ddpm_steps_matches_jax(jax_runner, params, twin):
    x_T, c = _chain_inputs(8)
    seq = list(range(0, T, 10))
    key = jax.random.PRNGKey(9)
    eps_fn = make_conditional_eps_fn(jax_runner.model, {"params": params},
                                     jnp.asarray(c), 2.0)
    want, want_x0 = jax_ddpm_steps(eps_fn, jnp.asarray(x_T), seq,
                                   jax_runner.schedule, key=key)
    sched = DiffusionSchedule.create(num_diffusion_timesteps=T)
    tc = torch.from_numpy(c)
    with torch.no_grad():
        got, got_x0 = ddpm_steps(
            lambda x, t: cfg_eps(twin, x, t, tc, 2.0), nchw(x_T), seq, sched,
            noise=_jax_step_noise(key, len(seq), x_T.shape))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(nhwc(got_x0), np.asarray(want_x0), rtol=2e-4,
                               atol=2e-4)
