"""The port's Selective-Amnesia ``forget`` (``compute_fim``,
``make_train_forget_step``, ``salun_torch.cli.ddpm_fim`` and ``ddpm_train
--mode forget``) against ``salun.diffusion.runner`` on the TINY U-Net,
JAX's draws replayed into the port.

Tolerances (fp32 on the CPU on both sides, other summation orders):
- the FIM: 1e-4 of each tensor's own largest entry (a mean of squared
  per-sample gradients, each held at 2e-4 of the largest in
  ``tests/test_torch_ddpm_runner.py``; squaring doubles the relative
  error of each term, the mean does not add to it); a tensor whose FIM
  is 0 in exact arithmetic, below 1e-9 of the largest entry over all
  tensors, is held at 1e-13 of that entry;
- the SA loss: 1e-5 relative; its gradients: 2e-4 of the largest entry;
- the CLI chain: the FIM file carries every parameter's name, loads into
  the JAX package through its ``.pt`` path, and ``forget`` runs on it
  with finite losses, never seeing the forgotten class.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import ddpm_twin, nchw, perturb_vectors
from _torch_port import one_torch_thread  # noqa: F401
from salun.ckpt import import_ddpm_unet
from salun.diffusion import DiffusionSchedule as JaxSchedule
from salun.diffusion import UNetConfig as JaxUNetConfig
from salun.diffusion import antithetic_timesteps as jax_antithetic
from salun.diffusion.runner import DDPMRunner as JaxRunner
from salun.diffusion.runner import DDPMTrainConfig as JaxTrainConfig
from salun_torch.ckpt import (ddpm_mask_to_jax, ddpm_state_dict_from_jax,
                              load_mask)
from salun_torch.cli import ddpm_fim, ddpm_sample, ddpm_train
from salun_torch.diffusion import DiffusionSchedule
from salun_torch.diffusion.runner import DDPMRunner, DDPMTrainConfig
from salun_torch.diffusion.unet import UNetConfig

TINY = JaxUNetConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), dropout=0.0, in_channels=3,
                     image_size=16, n_classes=4, cond_drop_prob=0.0)
T = 50


def _train_cfg(cls, **kw):
    base = dict(batch_size=4, lr=1e-3, cond_drop_prob=0.0, label_to_forget=1,
                gamma=0.5, lmbda=3.0)
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


def _batch(rng, n=4):
    return {"image": rng.integers(0, 256, (n, 16, 16, 3)).astype(np.uint8),
            "label": rng.integers(0, 4, n).astype(np.int32)}


def _leaves(model, tensors):
    names = [n for n, _ in model.named_parameters()]
    return jax.tree.leaves(ddpm_mask_to_jax(dict(zip(names, tensors))))


def test_compute_fim_matches_jax(params):
    jax_r, port_r = _runners()
    rng = np.random.default_rng(2)
    batches = [_batch(rng), _batch(rng)]
    n_ts, key = 2, jax.random.PRNGKey(3)
    want = jax_r.compute_fim(jax.tree.map(jnp.asarray, params), batches, key,
                             n_timestep_samples=n_ts)

    # compute_fim's draws: key, sub = split(key) a batch; kt, ke, kf =
    # split(sub, 3)
    port_batches = []
    for b in batches:
        key, sub = jax.random.split(key)
        kt, ke, kf = jax.random.split(sub, 3)
        port_batches.append(dict(
            b, flips=torch.from_numpy(np.array(
                jax.random.bernoulli(kf, 0.5, (4,)))),
            t=torch.from_numpy(np.array(jax.random.randint(
                kt, (4, n_ts), 0, T))),
            e=torch.from_numpy(np.ascontiguousarray(np.asarray(
                jax.random.normal(ke, (n_ts, 4, 16, 16, 3))).transpose(
                    0, 1, 4, 2, 3)))))
    model = ddpm_twin(TINY, params)
    got = port_r.compute_fim(model, port_batches, n_timestep_samples=n_ts)
    assert list(got) == [n for n, _ in model.named_parameters()]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    # a leaf's FIM is 0 in exact arithmetic where the loss cannot see the
    # parameter (attention's k bias; a bias added just before a GroupNorm
    # with one channel per group): there both sides hold rounding noise
    # of the squared zero, below 1e-9 of the largest entry
    floor = 1e-9 * max(float(w.max()) for w in want)
    for a, b in zip(_leaves(model, list(got.values())), want):
        assert (a >= 0).all()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(float(b.max()), floor))


def _capture_grads():
    def init(p):
        return {"g": jax.tree.map(jnp.zeros_like, p)}

    def update(g, state, p=None):
        return jax.tree.map(jnp.zeros_like, g), {"g": g}

    return optax.GradientTransformation(init, update)


def test_forget_step_loss_and_grads_match_jax(params):
    jax_r, port_r = _runners()
    rng = np.random.default_rng(4)
    remember = _batch(rng)
    fisher = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                          params)
    mle = jax.tree.map(lambda p: (p + 0.01 * rng.standard_normal(p.shape)
                                  ).astype(np.float32), params)
    key = jax.random.PRNGKey(5)
    tx = _capture_grads()
    p = jax.tree.map(jnp.asarray, params)
    step = jax_r.make_train_forget_step(tx, jax.tree.map(jnp.asarray, fisher),
                                        jax.tree.map(jnp.asarray, mle))
    (_, state, _), want_loss = step((p, tx.init(p), None), remember, key)

    # make_train_forget_step's draws: k1..k5, kf = split(key, 6)
    k1, k2, k3, k4, _, kf = jax.random.split(key, 6)
    shape = (4, 16, 16, 3)
    draws = {"flips": torch.from_numpy(np.array(
                 jax.random.bernoulli(kf, 0.5, (4,)))),
             "t": torch.from_numpy(np.array(jax_antithetic(k1, 4, T))),
             "x_forget": nchw(np.asarray(jax.random.uniform(k2, shape))),
             "e_forget": nchw(np.asarray(jax.random.normal(k3, shape))),
             "e_remember": nchw(np.asarray(jax.random.normal(k4, shape)))}
    model = ddpm_twin(TINY, params)
    names = [n for n, _ in model.named_parameters()]
    f_sd, m_sd = ddpm_state_dict_from_jax(fisher), ddpm_state_dict_from_jax(mle)
    loss = port_r.forget_loss(model, remember, [f_sd[n] for n in names],
                              [m_sd[n] for n in names], draws=draws)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = jax.tree.leaves(state["g"])
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for a, b in zip(_leaves(model, grads), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=2e-4 * scale)


FORGET_YML = """
data:
  dataset: synthetic
  image_size: 32
  channels: 3
  n_classes: 10
model:
  ch: 32
  ch_mult: [1, 2]
  num_res_blocks: 1
  attn_resolutions: [16]
  dropout: 0.1
  cond_drop_prob: 0.1
  ema: true
  ema_rate: 0.99
diffusion:
  num_diffusion_timesteps: 20
training:
  n_iters: 2
  batch_size: 8
  snapshot_freq: 100
  log_freq: 100
  gamma: 1.0
  lmbda: 10.0
optim:
  lr: 0.0001
  grad_clip: 1.0
"""


def test_fim_then_forget_through_the_clis(tmp_path):
    cfg = tmp_path / "tiny_forget.yml"
    cfg.write_text(FORGET_YML)
    base = tmp_path / "base"
    common = ["--config", str(cfg), "--device", "cpu", "--seed", "7"]
    ddpm_train.main(common + ["--mode", "train", "--n_iters", "1",
                              "--save_dir", str(base)])
    out = ddpm_fim.main(common + ["--ckpt_folder", str(base), "--save_dir",
                                  str(base), "--n_samples", "4",
                                  "--batch", "2", "--n_timestep_samples",
                                  "2"])
    fim = load_mask(str(base / "fisher.pt"))
    assert all(torch.equal(fim[k], out["fim"][k]) for k in fim)
    assert all((v >= 0).all() and torch.isfinite(v).all()
               for v in fim.values())
    assert sum(float(v.sum()) for v in fim.values()) > 0
    # the FIM file is a {param name: tensor} .pt, as the port's masks are:
    # the JAX package's .pt reader takes it
    bundle = _jax_bundle(str(cfg))
    template = JaxRunner(bundle.unet, bundle.schedule, bundle.train).init(
        jax.random.PRNGKey(0))
    import_ddpm_unet(fim, template)

    ddpm_sample.main(["--config", str(cfg), "--mode", "sample_classes",
                      "--ckpt_folder", str(base), "--save_dir",
                      str(base / "class_samples"), "--classes", "0,1,2",
                      "--n_samples_per_class", "3", "--batch", "3",
                      "--timesteps", "2", "--device", "cpu"])
    result = ddpm_train.main(common + ["--mode", "forget",
                                       "--label_to_forget", "1",
                                       "--ckpt_folder", str(base),
                                       "--save_dir", str(tmp_path / "sa")])
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["labels_seen"] == [0, 2]
    assert (tmp_path / "sa" / "ckpts" / "ckpt.pth").exists()


def _jax_bundle(path):
    from salun.cli.ddpm_config import load_config

    return load_config(path)
