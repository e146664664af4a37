"""The port's ``boundary_shrink``, ``boundary_expanding`` and
``RL_proximal`` against ``salun.core.methods`` on resnet20s at batch 32,
the JAX run's draws replayed into the port.

Tolerance as ``tests/test_torch_unlearn_methods.py`` justifies it for
XLA:CPU train-mode BatchNorm: every tensor ends within 10% of the
distance the JAX run moved it. With a mask, every masked-out weight stays
at θ₀ bitwise (on the widened model: the grafted mask, the new output row
trainable) and every step is one masked SGD step, K1's plain version on
the CPU; RL_proximal never calls it. RL_proximal's τ and shrink equal the
JAX package's bitwise at each step, given the port's parameters.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.core.methods as JMeth
import salun_torch.core.masked_opt as masked_opt
from _torch_port import (jax_augment_draws, jax_key_source,
                         jax_model_and_vars, port_twin)
from _torch_port import one_torch_thread  # noqa: F401
from salun.core.masked_opt import sgd as jax_sgd
from salun.core.train import TrainState
from salun.data import datasets as JD
from salun.data import loader as JL
from salun.dist.topk import kth_largest_threshold as jax_kth
from salun.models import create_model as jax_create_model
from salun_torch.ckpt import mask_from_jax, mask_to_jax, state_dict_from_jax
from salun_torch.core.methods import UnlearnConfig, get_unlearn_method
from salun_torch.data import datasets as D
from salun_torch.data import loader as L

jprox = importlib.import_module("salun.core.methods.rl_proximal")
tprox = importlib.import_module("salun_torch.core.methods.rl_proximal")

FORGET, RETAIN, BS = 24, 32, 32
MOVED_FRACTION = 0.1
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def resnet20s():
    """The flax resnet20s with perturbed BatchNorm, built once."""
    return jax_model_and_vars("resnet20s", np.random.default_rng(0))


def _loaders(mod_d, mod_l, retain=RETAIN):
    return {"forget": mod_l.BatchIterator(mod_d.synthetic(n=FORGET, seed=4),
                                          BS, shuffle=True, seed=2),
            "retain": mod_l.BatchIterator(mod_d.synthetic(n=retain, seed=5),
                                          BS, shuffle=True, seed=2)}


def _state(params, stats):
    return TrainState.create({"params": jax.tree.map(jnp.asarray, params),
                              "batch_stats": jax.tree.map(jnp.asarray, stats)},
                             jax_sgd(0.013))


def _count_k1(monkeypatch):
    calls = []
    k1 = masked_opt.masked_sgd_update
    monkeypatch.setattr(masked_opt, "masked_sgd_update",
                        lambda *a, **k: calls.append(1) or k1(*a, **k))
    return calls


def _assert_moved_alike(got: dict, want: dict, theta0: dict, mask=None):
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        g, w, t0 = got[n].numpy(), w.numpy(), theta0[n].numpy()
        if mask is not None and n in mask:
            keep = mask[n].numpy() > 0
            np.testing.assert_array_equal(g[~keep], t0[~keep], err_msg=n)
        moved = np.abs(w - t0).max()
        assert moved > 0, n
        assert np.abs(g - w).max() <= MOVED_FRACTION * moved, n


def _random_mask(params, rng):
    return jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.4).astype(np.float32), params)


def _kw(**extra):
    return dict(dataset="cifar10", num_classes=10, arch="resnet20s",
                unlearn_lr=0.013, unlearn_epochs=2, batch_size=BS,
                decreasing_lr="1", seed=2, **extra)


def test_boundary_shrink_matches_jax(resnet20s, rng, monkeypatch):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    mask_tree = _random_mask(params, rng)
    key = jax.random.PRNGKey(13)
    state = JMeth.get_unlearn_method("boundary_shrink")(
        _loaders(JD, JL), model, _state(params, stats),
        JMeth.UnlearnConfig(**_kw()), mask=jax.tree.map(jnp.asarray,
                                                        mask_tree), key=key)

    chain = {"key": key}

    def source(batch_size, *, random_labels=False):
        # a batch: key, ka, sub = split(key, 3); ka augments (boundary.py)
        chain["key"], ka, _ = jax.random.split(chain["key"], 3)
        return jax_augment_draws(ka, batch_size)

    calls = _count_k1(monkeypatch)
    mask = mask_from_jax(mask_tree)
    out, opt = get_unlearn_method("boundary_shrink")(
        _loaders(D, L), twin, UnlearnConfig(**_kw()), mask=mask, device=CPU,
        source=source)
    assert opt.count == 2 and len(calls) == 2
    _assert_moved_alike(out.state_dict(), state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)),
        state_dict_from_jax(params, stats), mask)


def test_boundary_expanding_matches_jax_on_the_wide_model(resnet20s, rng,
                                                         monkeypatch):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    mask_tree = _random_mask(params, rng)
    key = jax.random.PRNGKey(17)
    wide_state, _ = JMeth.get_unlearn_method("boundary_expanding")(
        _loaders(JD, JL), model, _state(params, stats),
        JMeth.UnlearnConfig(**_kw()), mask=jax.tree.map(jnp.asarray,
                                                        mask_tree), key=key)

    # the JAX run's fresh head: the wide model's init at the split-off key
    key_steps, ek = jax.random.split(key)
    wide_params = jax_create_model("resnet20s", 11).init(
        ek, jnp.zeros((1, 32, 32, 3)), train=False)["params"]
    wide_init = state_dict_from_jax(jax.tree.map(np.asarray, wide_params),
                                    stats)
    calls = _count_k1(monkeypatch)
    mask = mask_from_jax(mask_tree)
    wide, opt = get_unlearn_method("boundary_expanding")(
        _loaders(D, L), twin, UnlearnConfig(**_kw()), mask=mask, device=CPU,
        source=jax_key_source(key_steps, 11), wide_init=wide_init)
    assert wide.fc.weight.shape == (11, 64) and opt.count == 2
    assert len(calls) == 2
    assert opt.flat.flat.numel() == sum(
        p.numel() for p in twin.parameters()) + 65

    theta0 = state_dict_from_jax(params, stats)
    wide0 = {n: wide_init[n].clone() for n in ("fc.weight", "fc.bias")}
    wide0["fc.weight"][:10], wide0["fc.bias"][:10] = (theta0["fc.weight"],
                                                      theta0["fc.bias"])
    got = wide.state_dict()
    # masked-out weights at θ₀ on the grafted mask; the new row trained
    for n, m in mask.items():
        g, t0 = got[n][tuple(slice(0, s) for s in m.shape)], theta0[n]
        assert torch.equal(g[m == 0], t0[m == 0]), n
    assert not torch.equal(got["fc.weight"][10], wide0["fc.weight"][10])
    want = state_dict_from_jax(jax.tree.map(np.asarray, wide_state.params),
                               jax.tree.map(np.asarray,
                                            wide_state.batch_stats))
    _assert_moved_alike(got, want, {**theta0, **wide0})


def _flat_to_jax(flat: torch.Tensor, model) -> dict:
    named = list(model.named_parameters())
    parts = torch.split(flat, [p.numel() for _, p in named])
    return jax.tree.map(jnp.asarray, mask_to_jax(
        {n: t.reshape(p.shape) for (n, p), t in zip(named, parts)}))


# (dataset, epochs, retain size, the step whose ratio each step uses): the
# CIFAR branch holds the ratio of the epoch's first step (2 steps an
# epoch); on svhn (1 forget and 2 retain batches) the retain pass adds its
# batch index
PROXIMAL = [("cifar10", 2, 32, [0, 0, 2, 2]), ("svhn", 1, 64, [0, 0, 1])]


@pytest.mark.parametrize("dataset,epochs,retain,ratio_steps", PROXIMAL,
                         ids=[c[0] for c in PROXIMAL])
def test_rl_proximal_matches_jax(resnet20s, monkeypatch, dataset, epochs,
                                 retain, ratio_steps):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    kw = _kw(mask_ratio=0.5)
    kw.update(dataset=dataset, unlearn_epochs=epochs)
    key = jax.random.PRNGKey(19)
    state = JMeth.get_unlearn_method("RL_proximal")(
        _loaders(JD, JL, retain), model, _state(params, stats),
        JMeth.UnlearnConfig(**kw), key=key)

    steps = []
    shrink = tprox.proximal_shrink

    def spy(flat, theta_init, ratio):
        before = flat.clone()
        tau = shrink(flat, theta_init, ratio)
        steps.append((before, theta_init.clone(), ratio, tau,
                      flat.clone()))
        return tau

    monkeypatch.setattr(tprox, "proximal_shrink", spy)
    calls = _count_k1(monkeypatch)
    loaders = _loaders(D, L, retain)
    total = epochs * (len(loaders["forget"]) + len(loaders["retain"]))
    out, opt = get_unlearn_method("RL_proximal")(
        loaders, twin, UnlearnConfig(**kw), device=CPU,
        source=jax_key_source(key, 10))
    assert not calls and len(steps) == opt.count == len(ratio_steps)
    n = opt.flat.flat.numel()
    for (before, t0, ratio, tau, after), step in zip(steps, ratio_steps):
        assert ratio == int(jprox_ratio(kw, n, total, step))
        p_j, t_j = _flat_to_jax(before, twin), _flat_to_jax(t0, twin)
        d = jax.tree.map(lambda a, b: jnp.abs(a - b), p_j, t_j)
        want_tau = jax_kth(d, max(n - ratio + 1, 1))
        assert np.asarray(tau).view(np.uint32) == np.asarray(
            want_tau).view(np.uint32)
        want = jprox._proximal_shrink(p_j, t_j, jnp.asarray(ratio,
                                                            jnp.int32))
        for a, b in zip(jax.tree.leaves(_flat_to_jax(after, twin)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int((after == t0).sum()) >= ratio
    _assert_moved_alike(out.state_dict(), state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)),
        state_dict_from_jax(params, stats))


def jprox_ratio(kw, n_params, total_steps, step):
    """The JAX package's ``ratio_at`` (``rl_proximal.py:63-66``)."""
    frac = (total_steps - (jnp.asarray(step, jnp.float32) + 1)) / total_steps
    return jnp.maximum((kw["mask_ratio"] * frac * n_params).astype(
        jnp.int32), 1)


def test_proximal_shrink_pins_the_element_at_tau_as_jax():
    """|d| == τ goes to θ_init exactly (RL_pro.py's else-branch). With
    θ and θ_init far apart, θ − sign(d)·τ differs from θ_init by
    rounding, so the comparison sees which branch ran."""
    p = torch.tensor([3.0, 0.5, -2.0, 10.0])
    t0 = torch.tensor([0.001, 0.2, 0.0, 0.0])
    # |d| = (2.999, 0.3, 2, 10): ratio 3 puts τ at element 0's |d|
    flat = p.clone()
    tau = tprox.proximal_shrink(flat, t0, 3)
    assert float(tau) == float(np.float32(3.0) - np.float32(0.001))
    want = jprox._proximal_shrink(jnp.asarray(p.numpy()),
                                  jnp.asarray(t0.numpy()),
                                  jnp.asarray(3, jnp.int32))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    assert flat[0] == t0[0] and flat[3] == 10.0 - tau
