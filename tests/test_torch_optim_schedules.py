"""The port's cosine-warmup schedule, FT_l1/GA_l1 coefficients and
grad-mask-only SGD against the JAX package.

- ``cosine_warmup_lr`` at every step of every epoch against
  ``salun.core.train.cosine_warmup_lr``: both compute in fp32; the cosine
  comes from numpy on one side and XLA on the other, so the tolerance is
  2 ulp (relative 2.4e-7).
- The l1 coefficient of FT_l1 (3 epochs, ``no_l1_epochs`` 1) and GA_l1 at
  every step, against the closure the JAX method hands its train step:
  bitwise (the same fp32 operations).
- ``GradMaskSGD`` against ``optax.chain(mask_grads(mask), sgd)`` over 6
  steps with a MultiStep lr: bitwise; masked-out weights still move under
  weight decay and momentum, and K1 is never called.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import salun.core.methods.iterative as jax_iterative
from salun.core.masked_opt import mask_grads, sgd
from salun.core.methods import UnlearnConfig as JaxConfig
from salun.core.train import TrainState
from salun.core.train import cosine_warmup_lr as jax_cosine_warmup_lr
from salun.core.train import multistep_lr as jax_multistep_lr
from salun.data import datasets as JD
from salun.data import loader as JL
import salun_torch.core.masked_opt as masked_opt
from salun_torch.core.masked_opt import FlatParams, GradMaskSGD
from salun_torch.core.methods import (UnlearnConfig, l1_schedule,
                                      make_unlearn_optimizer)
from salun_torch.core.train import cosine_warmup_lr, multistep_lr

SHAPES = {"a": (6, 4), "b": (3,), "c": (2, 3, 3, 3)}


@pytest.mark.parametrize("warmup,total", [(0, 7), (3, 10), (2, 2)])
def test_cosine_warmup_lr_matches_jax(warmup, total):
    spe = 5
    ours = cosine_warmup_lr(0.1, warmup, total, spe)
    theirs = jax_cosine_warmup_lr(0.1, warmup, total, spe)
    for step in range((total + 2) * spe):
        want = np.float32(theirs(jnp.int32(step)))
        got = ours(step)
        assert got == float(np.float32(got))  # an fp32 value
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0,
                                   err_msg=str(step))


class _Captured(Exception):
    pass


@pytest.mark.parametrize("name,mode", [("FT_l1", "decay"),
                                       ("GA_l1", "const")])
def test_l1_coefficient_matches_the_jax_closure(monkeypatch, name, mode):
    captured = {}

    def capture(model, tx, **kw):
        captured.update(kw)
        raise _Captured

    monkeypatch.setattr(jax_iterative, "make_train_step", capture)
    kw = dict(unlearn_epochs=3, no_l1_epochs=1, alpha=0.2, batch_size=32)
    loader = JL.BatchIterator(JD.synthetic(n=100, seed=1), 32)
    loaders = {"forget": loader, "retain": loader}
    state = TrainState.create({"params": {"w": jnp.zeros(2)}}, optax.sgd(1))
    with pytest.raises(_Captured):
        getattr(jax_iterative, name)(loaders, None, state, JaxConfig(**kw))
    spe = len(loader)
    assert spe == 4
    ours = l1_schedule(UnlearnConfig(**kw), mode, spe)
    values = []
    for step in range(4 * spe):
        want = np.float32(captured["l1_coeff"](jnp.int32(step)))
        assert np.float32(ours(step)) == want, step
        values.append(float(want))
    if mode == "decay":   # α, α/2, then 0 from epoch E = 2 on
        assert values[::spe] == [np.float32(0.2), np.float32(0.1), 0.0, 0.0]
    assert l1_schedule(UnlearnConfig(), "none", 4) is None


def test_grad_mask_sgd_matches_optax_chain(rng, monkeypatch):
    monkeypatch.setattr(masked_opt, "masked_sgd_update", None)  # no K1
    names = sorted(SHAPES)
    p0 = {k: rng.standard_normal(SHAPES[k]).astype(np.float32) for k in names}
    mask = {k: (rng.random(SHAPES[k]) > 0.5).astype(np.float32)
            for k in names}
    tx = optax.chain(mask_grads({k: jnp.asarray(mask[k]) for k in names}),
                     sgd(jax_multistep_lr(0.05, [1], 3), 0.9, 5e-4))
    jp = {k: jnp.asarray(p0[k]) for k in names}
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in names]
    flat = FlatParams(params)
    opt = GradMaskSGD(flat, multistep_lr(0.05, [1], 3), 0.9, 5e-4,
                      mask=flat.flatten([torch.from_numpy(mask[k])
                                         for k in names]))
    for _ in range(6):
        grads = [rng.standard_normal(SHAPES[k]).astype(np.float32)
                 for k in names]
        upd, state = tx.update(dict(zip(names, map(jnp.asarray, grads))),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        sum((p * torch.from_numpy(g)).sum()
            for p, g in zip(params, grads)).backward()
        opt.step()
    assert opt.count == 6
    for k, p in zip(names, params):
        got = p.detach().numpy()
        np.testing.assert_array_equal(got, np.asarray(jp[k]))
        out = mask[k] == 0
        assert np.all(got[out] != p0[k][out])  # decay moved them


def test_make_unlearn_optimizer_picks_by_mask_and_schedule():
    model = torch.nn.Linear(3, 2)
    mask = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    theta0 = [p.detach().clone() for p in model.parameters()]
    cfg = UnlearnConfig(unlearn_lr=0.1, unlearn_epochs=4, warmup=1,
                        decreasing_lr="2")
    pick = {(True, True): "MaskedSGD", (True, False): "GradMaskSGD",
            (False, False): "SGD"}
    for (m, t), want in pick.items():
        opt = make_unlearn_optimizer(cfg, torch.nn.Linear(3, 2), 5,
                                     mask if m else None,
                                     theta0 if t else None)
        assert type(opt).__name__ == want
        assert opt.sched(10) == multistep_lr(0.1, [2], 5)(10)
    cfg.imagenet_arch = True
    opt = make_unlearn_optimizer(cfg, torch.nn.Linear(3, 2), 5, retrain=True)
    cosine = cosine_warmup_lr(0.1, 1, 4, 5)
    assert [opt.sched(s) for s in range(0, 20, 5)] == [
        cosine(s) for s in range(0, 20, 5)]
    assert make_unlearn_optimizer(cfg, torch.nn.Linear(3, 2), 5).sched(
        10) == multistep_lr(0.1, [2], 5)(10)
