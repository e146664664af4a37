"""The port's ``fisher``, ``fisher_new`` and ``wfisher`` against
``salun.core.methods`` on resnet20s (and the tiny pair for wfisher's
1,001-gradient stop), with the JAX run's augment draws and normals handed
to the port.

Tolerances. The FIM, fisher_new's class-weighted grad² and wfisher's
perturbation within 1e-4 relative in the 2-norm of the whole flat vector
(‖port − jax‖ ≤ 1e-4·‖jax‖), in eval mode (no train-mode BatchNorm
drift). In a few early BatchNorm tensors the two sides differ by more
than 1e-4 of the tensor, and the port's fp32 FIM, summed in chunks in
another order, sits within 1e-5 of a float64 run per tensor (checked
below; fp32 sums over a convolution's positions, in an order that
depends on torch's thread count). The final weights, with the JAX
normals injected, within 1e-5 absolute.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.core.methods as JMeth
from _tiny_pair import FlaxNet, TorchNet, flax_leaf, to_flax_layout
from _tiny_pair import transport
from _torch_port import (jax_augment_source, jax_model_and_vars, nchw,
                         port_twin)
from _torch_port import one_torch_thread  # noqa: F401
from salun.core.masked_opt import sgd as jax_sgd
from salun.core.train import TrainState
from salun.data import datasets as JD
from salun.data import loader as JL
from salun_torch.ckpt import mask_from_jax, state_dict_from_jax
from salun_torch.core.methods import UnlearnConfig, get_unlearn_method
from salun_torch.data import datasets as D
from salun_torch.data import loader as L
from salun_torch.data.loader import augment, to_device, to_float

# the packages' __init__ shadow these module names with the functions
jfisher = importlib.import_module("salun.core.methods.fisher")
tfisher = importlib.import_module("salun_torch.core.methods.fisher")

CPU = torch.device("cpu")
REL = 1e-4


def _loaders(mod_d, mod_l, n_forget=24, n_retain=32, bs=32,
             num_classes=10):
    def it(n, seed):
        ds = mod_d.synthetic(n=n, seed=seed, num_classes=num_classes)
        return mod_l.BatchIterator(ds, bs, shuffle=True, seed=2)

    return {"forget": it(n_forget, 4), "retain": it(n_retain, 5)}


def _state(params, stats):
    return TrainState.create({"params": jax.tree.map(jnp.asarray, params),
                              "batch_stats": jax.tree.map(jnp.asarray, stats)},
                             jax_sgd(0.01))


def _assert_rel(got: dict, want: dict, rel=REL):
    """‖got − want‖ ≤ rel·‖want‖ over all tensors as one flat vector."""
    err = sum(float((got[n].detach().double() - w.double()).norm()) ** 2
              for n, w in want.items())
    ref = sum(float(w.double().norm()) ** 2 for w in want.values())
    assert err ** 0.5 <= rel * ref ** 0.5, (err / ref) ** 0.5


def _jax_normals(params, key):
    """``salun.core.methods.fisher``'s per-leaf normals for ``key``, in the
    port's layout."""
    leaves, treedef = jax.tree.flatten(jax.tree.map(jnp.asarray, params))
    keys = jax.random.split(key, len(leaves))
    z = [np.asarray(jax.random.normal(k, l.shape, jnp.float32))
         for k, l in zip(keys, leaves)]
    return mask_from_jax(jax.tree.unflatten(treedef, z))


@pytest.fixture(scope="module")
def resnet20s():
    """The flax resnet20s with perturbed BatchNorm, built once: its init
    takes seconds."""
    return jax_model_and_vars("resnet20s", np.random.default_rng(0))


def test_fim_matches_jax_and_float64(resnet20s):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    key = jax.random.PRNGKey(7)
    cfg = UnlearnConfig(arch="resnet20s")
    want = jfisher.fisher_information(model, _state(params, stats),
                                      _loaders(JD, JL)["retain"], aug_key=key)
    got = tfisher.fisher_information(twin, _loaders(D, L)["retain"], CPU,
                                     jax_augment_source(key), cfg, chunk=12)
    _assert_rel(got, mask_from_jax(jax.tree.map(np.asarray, want)))
    # on 8 samples, the port's fp32 FIM against float64, sample by sample
    def small():
        return _loaders(D, L, n_retain=8, bs=8)["retain"]

    got = tfisher.fisher_information(twin, small(), CPU,
                                     jax_augment_source(key), cfg, chunk=3)
    twin64, acc = copy.deepcopy(twin).double().eval(), None
    batch = to_device(next(iter(small())), CPU)
    rand = jax_augment_source(key)(8)
    img = augment(to_float(batch["image"]).double(), rand["offsets"],
                  rand["flips"])
    for i in range(8):
        twin64.zero_grad()
        torch.log_softmax(twin64(img[i:i + 1])[0], -1)[
            batch["label"][i]].backward()
        sq = {n: (p.grad + tfisher.EPS) ** 2
              for n, p in twin64.named_parameters()}
        acc = sq if acc is None else {n: acc[n] + sq[n] for n in acc}
    for n, g in got.items():
        exact = acc[n] / 8
        err = (g.double() - exact).abs().max() / exact.abs().max()
        assert err <= 1e-5, (n, float(err))



def test_class_weighted_grad2_matches_jax_on_the_tiny_pair(rng):
    torch.manual_seed(0)
    tnet = TorchNet()
    img = rng.random((32, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jfisher._class_weighted_sq_grads, static_argnums=(0, 4))(
        FlaxNet(), transport(tnet), {}, jnp.asarray(img), 5)
    got = tfisher.class_weighted_sq_grads(tnet, nchw(img), 5)
    _assert_rel({n: torch.from_numpy(to_flax_layout(n, g.numpy()))
                 for n, g in got.items()},
                {n: torch.from_numpy(np.array(flax_leaf(want, n)))
                 for n in got})


CASES = [("fisher", False), ("fisher_new", True)]


@pytest.mark.parametrize("name,special", CASES,
                         ids=[f"{n}-{'special' if s else 'plain'}"
                              for n, s in CASES])
def test_method_matches_jax_with_injected_noise(resnet20s, name, special):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    kw = dict(dataset="cifar10", num_classes=10, arch="resnet20s",
              alpha=1e-6 if name == "fisher_new" else 0.2, seed=2,
              class_to_replace=3 if special else -1,
              num_indexes_to_replace=4500 if special else None)
    key = jax.random.PRNGKey(11)
    state = JMeth.get_unlearn_method(name)(
        _loaders(JD, JL), model, _state(params, stats),
        JMeth.UnlearnConfig(**kw), key=key)

    # both methods split one key off for the augment chain; the rest seeds
    # the per-leaf normals
    key_rest, key_aug = jax.random.split(key)
    normals = _jax_normals(params, key_rest)
    out, _ = get_unlearn_method(name)(
        _loaders(D, L), twin, UnlearnConfig(**kw), device=CPU,
        source=jax_augment_source(key_aug),
        noise=lambda n, p: normals[n])
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                               jax.tree.map(np.asarray, state.batch_stats))
    got = out.state_dict()
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
        assert not np.array_equal(w.numpy(), state_dict_from_jax(
            params, stats)[n].numpy()) or "running" in n, n
    if special:  # the forgotten class's output row is resampled around 0
        assert np.abs(got["fc.weight"][3].numpy()).max() < 0.2
        assert np.abs(got["fc.weight"][3].numpy()).max() < np.abs(
            want["fc.weight"].numpy()).max()


def _perturbation(after: dict, before: dict) -> dict:
    return {n: after[n] - before[n] for n in before}


def test_wfisher_stream_ends_by_exhaustion_and_masked(resnet20s, rng):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    mask_tree = jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.5).astype(np.float32), params)
    kw = dict(dataset="cifar10", num_classes=10, arch="resnet20s",
              alpha=0.2, seed=2)
    key = jax.random.PRNGKey(21)
    state = JMeth.get_unlearn_method("wfisher")(
        _loaders(JD, JL), model, _state(params, stats),
        JMeth.UnlearnConfig(**kw), mask=jax.tree.map(jnp.asarray, mask_tree),
        key=key)
    theta0 = state_dict_from_jax(params, stats)
    want = _perturbation(state_dict_from_jax(
        jax.tree.map(np.asarray, state.params), stats), theta0)

    out, _ = get_unlearn_method("wfisher")(
        _loaders(D, L), twin, UnlearnConfig(**kw),
        mask=mask_from_jax(mask_tree), device=CPU,
        source=_wfisher_source(key, n_forget=1, n_retain=1))
    got = _perturbation(out.state_dict(), theta0)
    mask = mask_from_jax(mask_tree)
    for n in mask:
        assert torch.all(got[n][mask[n] == 0] == 0), n
    _assert_rel({n: got[n] for n in mask}, {n: want[n] for n in mask})


def _wfisher_source(key, n_forget, n_retain, calls=None):
    """The JAX Wfisher's draws: the forget batches from one chain, the
    retain batches from a second, the batch-1 stream from a third."""
    _, kf, kr, ks = jax.random.split(key, 4)
    chains = ([jax_augment_source(kf)] * n_forget
              + [jax_augment_source(kr)] * n_retain)
    stream = jax_augment_source(ks, calls)

    def draw(batch_size, *, random_labels=False):
        return (chains.pop(0) if chains else stream)(batch_size)

    return draw


def test_wfisher_stops_after_1001_gradients_on_the_tiny_pair():
    torch.manual_seed(0)
    tnet = TorchNet()
    jparams = transport(tnet)
    kw = dict(dataset="cifar10", num_classes=5, arch="tiny", alpha=0.2,
              seed=2)
    key = jax.random.PRNGKey(3)
    sizes = dict(n_forget=40, n_retain=1010, bs=256, num_classes=5)
    state = TrainState.create({"params": jparams, "batch_stats": {}},
                              jax_sgd(0.01))
    state = JMeth.get_unlearn_method("wfisher")(
        _loaders(JD, JL, **sizes), FlaxNet(), state,
        JMeth.UnlearnConfig(**kw), key=key)
    before = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    calls = []
    out, _ = get_unlearn_method("wfisher")(
        _loaders(D, L, **sizes), tnet, UnlearnConfig(**kw), device=CPU,
        source=_wfisher_source(key, n_forget=1, n_retain=4, calls=calls))
    assert calls == [1] * 1001  # the batch-1 stream stopped early
    got = {n: torch.from_numpy(to_flax_layout(n, (p.detach() - before[n])
                                              .numpy()))
           for n, p in out.named_parameters()}
    _assert_rel(got, {n: torch.from_numpy(
        np.asarray(flax_leaf(state.params, n))
        - np.asarray(flax_leaf(jparams, n))) for n in got})
