"""The port's GA, GA_l1, FT, FT_l1 and retrain against
``salun.core.methods`` on resnet20s at batch 32, with masks and without,
the JAX run's augment draws replayed into the port
(``_torch_port.jax_key_source``).

Each run is two steps: two epochs of one batch (24 forget or 32 retain
samples), so FT_l1's coefficient takes two values (α, α/2). Tolerance as
``tests/test_torch_methods.py`` justifies it for RL: every tensor must end
within 10% of the distance the JAX run moved it (``max|port − jax| <=
0.1·max|jax − θ₀|``), because the JAX package's XLA:CPU train-mode
gradients are themselves a few per cent off in the early layers; measured
worst: 2.0% (GA), 0.8% (GA_l1), 2.7% (FT, retrain), 7.4% (FT_l1). With a
mask, every masked-out weight stays at θ₀ bitwise and every step is one
masked SGD step (K1's plain version on the CPU); without one, K1 is never
called.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.core.methods as JMeth
import salun_torch.core.masked_opt as masked_opt
from _torch_port import jax_key_source, jax_model_and_vars, port_twin
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
CASES = [(m, masked) for m in ("GA", "GA_l1", "FT", "FT_l1")
         for masked in (True, False)] + [("retrain", False)]


def _loaders(mod_d, mod_l):
    forget = mod_d.synthetic(n=FORGET, seed=4)
    retain = mod_d.synthetic(n=RETAIN, seed=5)
    return {"forget": mod_l.BatchIterator(forget, BS, shuffle=True, seed=2),
            "retain": mod_l.BatchIterator(retain, BS, shuffle=True, seed=2)}


@pytest.mark.parametrize("name,masked", CASES,
                         ids=[f"{n}-{'mask' if m else 'nomask'}"
                              for n, m in CASES])
def test_method_matches_jax_with_replayed_randomness(rng, monkeypatch, name,
                                                     masked):
    model, params, stats = jax_model_and_vars("resnet20s", rng)
    twin = port_twin("resnet20s", params, stats)
    mask_tree = (jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.4).astype(np.float32), params)
        if masked else None)
    kw = dict(dataset="cifar10", num_classes=10, arch="resnet20s",
              unlearn_lr=0.013, unlearn_epochs=2, batch_size=BS,
              decreasing_lr="1", alpha=0.2, seed=2)
    key = jax.random.PRNGKey(13)

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
    out, opt = get_unlearn_method(name)(
        _loaders(D, L), twin, UnlearnConfig(**kw), mask=mask,
        device=torch.device("cpu"), source=jax_key_source(key, 10))
    assert opt.count == 2
    assert len(calls) == (2 if masked else 0)

    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                               jax.tree.map(np.asarray, state.batch_stats))
    theta0 = state_dict_from_jax(params, stats)
    got = out.state_dict()
    for n, w in want.items():
        g, w, t0 = got[n].numpy(), w.numpy(), theta0[n].numpy()
        if mask is not None and n in mask:
            keep = mask[n].numpy() > 0
            np.testing.assert_array_equal(g[~keep], t0[~keep], err_msg=n)
            assert not np.array_equal(g[keep], t0[keep]), n
        if n.endswith("num_batches_tracked"):
            continue
        moved = np.abs(w - t0).max()
        assert moved > 0, n
        assert np.abs(g - w).max() <= MOVED_FRACTION * moved, n
