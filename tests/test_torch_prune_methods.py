"""The port's ``FT_prune``, ``FT_prune_bi``, ``GA_prune`` and
``GA_prune_bi`` against ``salun.core.methods`` on resnet20s at batch 32,
the JAX run's draws (augment offsets and flips, random-prune uniforms)
replayed into the port.

Tolerance as ``tests/test_torch_unlearn_methods.py`` justifies it for
XLA:CPU train-mode BatchNorm: every tensor ends within 10% of the
distance the JAX run moved it. The prune masks equal the JAX package's
(L1 at the first epoch, on equal weights; random with the JAX uniforms),
so each variant's conv kernels hold exactly its prune count of zeros.
``FT_prune`` with a mask keeps every masked-out weight at θ₀ bitwise and
calls K1's plain version once a step; the three others never call it.
"""

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
from salun_torch.ckpt import mask_from_jax, state_dict_from_jax
from salun_torch.core.methods import UnlearnConfig, get_unlearn_method
from salun_torch.data import datasets as D
from salun_torch.data import loader as L

FORGET, RETAIN, BS = 24, 32, 32
MOVED_FRACTION = 0.1
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def resnet20s():
    """The flax resnet20s with perturbed BatchNorm, built once."""
    return jax_model_and_vars("resnet20s", np.random.default_rng(0))


def _loaders(mod_d, mod_l):
    return {"forget": mod_l.BatchIterator(mod_d.synthetic(n=FORGET, seed=4),
                                          BS, shuffle=True, seed=2),
            "retain": mod_l.BatchIterator(mod_d.synthetic(n=RETAIN, seed=5),
                                          BS, shuffle=True, seed=2)}


class PruneChain:
    """The JAX prune methods' one key chain: ``key, sub = split(key)`` a
    step, whose ``sub`` augments directly (``make_pruned_train_step``),
    and ``key, pk = split(key)`` a random prune round, whose uniforms are
    ``global_random_prune``'s for ``pk``."""

    def __init__(self, key, params):
        self.key, self.params = key, params

    def source(self, batch_size, *, random_labels=False):
        self.key, sub = jax.random.split(self.key)
        return jax_augment_draws(sub, batch_size)

    def prune_scores(self, params):
        self.key, pk = jax.random.split(self.key)
        leaves, treedef = jax.tree.flatten(self.params)
        keys = jax.random.split(pk, len(leaves))
        u = [np.asarray(jax.random.uniform(k, l.shape, jnp.float32))
             for k, l in zip(keys, leaves)]
        return mask_from_jax(jax.tree.unflatten(treedef, u))


# (method, random prune, masked, epochs, conv weights pruned / all)
CASES = [("FT_prune", False, True, 2, 0.0),
         ("FT_prune_bi", False, False, 2, 0.95),
         ("GA_prune_bi", True, False, 2, 0.95),
         ("GA_prune", True, False, 2, 0.05)]


@pytest.mark.parametrize("name,random_prune,masked,epochs,pruned", CASES,
                         ids=[c[0] for c in CASES])
def test_prune_method_matches_jax(resnet20s, rng, monkeypatch, name,
                                  random_prune, masked, epochs, pruned):
    model, params, stats = resnet20s
    twin = port_twin("resnet20s", params, stats)
    mask_tree = (jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.4).astype(np.float32), params)
        if masked else None)
    kw = dict(dataset="cifar10", num_classes=10, arch="resnet20s",
              unlearn_lr=0.013, unlearn_epochs=epochs, batch_size=BS,
              decreasing_lr="1", alpha=0.2, seed=2, rate=0.95,
              random_prune=random_prune)
    key = jax.random.PRNGKey(29)
    state = TrainState.create(
        {"params": jax.tree.map(jnp.asarray, params),
         "batch_stats": jax.tree.map(jnp.asarray, stats)}, jax_sgd(0.013))
    state = JMeth.get_unlearn_method(name)(
        _loaders(JD, JL), model, state, JMeth.UnlearnConfig(**kw),
        mask=None if mask_tree is None else jax.tree.map(jnp.asarray,
                                                         mask_tree),
        key=key)

    calls = []
    k1 = masked_opt.masked_sgd_update
    monkeypatch.setattr(masked_opt, "masked_sgd_update",
                        lambda *a, **k: calls.append(1) or k1(*a, **k))
    mask = None if mask_tree is None else mask_from_jax(mask_tree)
    extra = {}
    if name == "FT_prune":  # FT_l1's draws (make_train_step)
        extra["source"] = jax_key_source(key, 10)
    else:
        chain = PruneChain(key, jax.tree.map(jnp.asarray, params))
        extra.update(source=chain.source, prune_scores=chain.prune_scores)
    out, opt = get_unlearn_method(name)(
        _loaders(D, L), twin, UnlearnConfig(**kw), mask=mask, device=CPU,
        **extra)
    assert opt.count == epochs
    assert len(calls) == (epochs if masked else 0)

    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                               jax.tree.map(np.asarray, state.batch_stats))
    theta0 = state_dict_from_jax(params, stats)
    got = out.state_dict()
    param_names = {n for n, _ in out.named_parameters()}
    n_conv = sum(p.numel() for p in twin.parameters() if p.dim() == 4)
    zeros = sum(int((p == 0).sum()) for p in out.parameters()
                if p.dim() == 4)
    assert zeros == round(pruned * n_conv)
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        g, w, t0 = got[n].numpy(), w.numpy(), theta0[n].numpy()
        if w.ndim == 4:  # the same coordinates pruned on both sides
            np.testing.assert_array_equal(g == 0, w == 0, err_msg=n)
        if mask is not None and n in mask:
            keep = mask[n].numpy() > 0
            np.testing.assert_array_equal(g[~keep], t0[~keep], err_msg=n)
        moved = np.abs(w - t0).max()
        if name == "GA_prune" and n in param_names and w.ndim != 4:
            # rewound: every weight but the pruned conv ones is θ_init (the
            # BatchNorm statistics are not rewound)
            np.testing.assert_array_equal(g, t0, err_msg=n)
            continue
        assert moved > 0, n
        assert np.abs(g - w).max() <= MOVED_FRACTION * moved, n
