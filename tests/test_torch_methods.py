"""The port's RL method (the slice's masked training path) against
``salun.core.methods.RL`` on resnet20s, with the JAX run's augment draws
and random labels replayed into the port, and the registry.

Trajectory tolerance. The runs are two steps long (one forget and one
retain step, or two steps over forget∪retain) at batch 32, and each tensor
must end within 10% of the distance the JAX run moved it
(``max|port − jax| <= 0.1·max|jax − θ₀|``); measured worst: 2% (CIFAR-10
regime) and 6% (CIFAR-100 regime). Why so loose: the JAX reference's train-mode gradients are
themselves off. XLA:CPU sums a 32,768-element fp32 mean with a relative
error of 6.8e-6 (torch: 1.3e-7); BatchNorm's backward subtracts such means
from each other, so at these sizes the JAX fp32 gradients of the early
layers differ from float64 finite differences by up to ~4%, while the
port's fp32 gradients agree with them to 5e-8 (relative, directional
derivative of layer2.1.conv1 on resnet20s at batch 8). Training a
BatchNorm network this small is also ill-conditioned: a 1e-6 relative
perturbation of θ moves the port's own 6-step result by up to 39% of the
distance travelled, so only short trajectories can be compared.
Masked-out weights are checked exactly: the port leaves them at θ₀
bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.core.methods as JaxMethods
from _torch_port import jax_key_source, jax_model_and_vars, port_twin
from salun.core.methods import RL as jax_RL
from salun.core.methods import UnlearnConfig as JaxConfig
from salun.core.masked_opt import sgd as jax_sgd
from salun.core.train import TrainState
from salun.data import datasets as JD
from salun.data import loader as JL
from salun_torch.ckpt import mask_from_jax, state_dict_from_jax
from salun_torch.core.methods import RL, UnlearnConfig, get_unlearn_method, raw
from salun_torch.data import datasets as D
from salun_torch.data import loader as L

FORGET, RETAIN, BS = 24, 32, 32
MOVED_FRACTION = 0.1


def _loaders(mod_d, mod_l, bs):
    forget = mod_d.synthetic(n=FORGET, seed=4)
    retain = mod_d.synthetic(n=RETAIN, seed=5)
    return {"forget": mod_l.BatchIterator(forget, bs, shuffle=True, seed=2),
            "retain": mod_l.BatchIterator(retain, bs, shuffle=True, seed=2)}


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_rl_matches_jax_with_replayed_randomness(rng, dataset):
    model, params, stats = jax_model_and_vars("resnet20s", rng)
    twin = port_twin("resnet20s", params, stats)
    mask_tree = jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.4).astype(np.float32), params)
    kw = dict(dataset=dataset, num_classes=10, arch="resnet20s",
              unlearn_lr=0.013, unlearn_epochs=1, batch_size=BS,
              decreasing_lr="1", seed=2)
    key = jax.random.PRNGKey(11)

    tx = jax_sgd(0.013)
    state = TrainState.create(
        {"params": jax.tree.map(jnp.asarray, params),
         "batch_stats": jax.tree.map(jnp.asarray, stats)}, tx)
    state = jax_RL(_loaders(JD, JL, BS), model, state, JaxConfig(**kw),
                   mask=jax.tree.map(jnp.asarray, mask_tree), key=key)

    out, opt = RL(_loaders(D, L, BS), twin, UnlearnConfig(**kw),
                  mask=mask_from_jax(mask_tree), device=torch.device("cpu"),
                  source=jax_key_source(key, 10))
    assert opt.count == 2

    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                               jax.tree.map(np.asarray, state.batch_stats))
    theta0 = state_dict_from_jax(params, stats)
    mask = mask_from_jax(mask_tree)
    got = out.state_dict()
    for name, w in want.items():
        g, w, t0 = got[name].numpy(), w.numpy(), theta0[name].numpy()
        if name in mask:
            keep = mask[name].numpy() > 0
            np.testing.assert_array_equal(g[~keep], t0[~keep], err_msg=name)
            assert not np.array_equal(g[keep], t0[keep]), name
        if name.endswith("num_batches_tracked"):
            continue
        moved = np.abs(w - t0).max()
        assert moved > 0, name
        assert np.abs(g - w).max() <= MOVED_FRACTION * moved, name


def test_registry_and_raw():
    assert get_unlearn_method("RL") is RL
    model = torch.nn.Linear(2, 2)
    assert raw({}, model, UnlearnConfig(), device="cpu")[0] is model
    # every name of the reference registry is ported
    for name in JaxMethods._METHODS:
        assert callable(get_unlearn_method(name)), name
    with pytest.raises(NotImplementedError):
        get_unlearn_method("nonsense")
    assert {f.name for f in dataclasses.fields(UnlearnConfig)} == {
        f.name for f in dataclasses.fields(JaxConfig)}


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_and_accuracy_match_jax(rng, weighted):
    from salun.core.train import cross_entropy as jax_ce
    from salun.core.train import weighted_accuracy as jax_acc
    from salun_torch.core.train import cross_entropy, weighted_accuracy

    logits = rng.standard_normal((12, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 12)
    labels[:4] = logits[:4].argmax(1)
    w = np.array([1.0] * 9 + [0.0] * 3, np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        tw)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), jw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = weighted_accuracy(torch.from_numpy(logits),
                            torch.from_numpy(labels), tw)
    assert float(got) == pytest.approx(float(jax_acc(
        jnp.asarray(logits), jnp.asarray(labels), jw)), rel=1e-6)
