"""Saliency masks in the port against ``salun.core.mask``.

Masks are compared bitwise. The tie order depends on the order and layout
of the tensors, so the port's function is given JAX's leaves in JAX's
flatten order (dict keys sorted) and layout (HWIO) where ties exist. The
saliency itself is compared at rtol 1e-4 / atol 1e-6: both sides sum the
same per-batch fp32 gradients in the same order, but each gradient comes
from convolutions summed in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_model_and_vars, nchw, port_twin
from salun.ckpt import import_mask
from salun.core.mask import DEFAULT_THRESHOLDS
from salun.core.mask import generate_masks as jax_generate_masks
from salun.core.train import cross_entropy as jax_ce
from salun_torch.ckpt import mask_from_jax, mask_to_jax
from salun_torch.ckpt.store import load_mask, save_mask
from salun_torch.core.mask import (accumulate_saliency, generate_masks,
                                   global_topk_masks)
from salun_torch.core.train import cross_entropy


def _assert_same_masks(port_masks, jax_masks):
    for t in DEFAULT_THRESHOLDS:
        leaves = jax.tree.leaves(jax_masks[t])
        assert len(leaves) == len(port_masks[t])
        for got, want in zip(port_masks[t], leaves):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"t={t}")


@pytest.mark.parametrize("kind", ["random", "heavy_ties"])
def test_masks_bit_identical_in_jax_leaf_order(rng, kind):
    shapes = {"b": (3, 3, 4, 8), "a": (37,), "c": {"x": (5, 11), "y": (3,)}}

    def draw(shape):
        if kind == "random":
            return np.abs(rng.standard_normal(shape)).astype(np.float32)
        # a 4-level grid: masses of exact ties across leaves and across
        # every threshold boundary
        return (rng.integers(0, 4, shape) * 0.25).astype(np.float32)

    sal = jax.tree.map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))
    want = jax_generate_masks(jax.tree.map(jnp.asarray, sal))
    got = generate_masks([torch.from_numpy(x) for x in jax.tree.leaves(sal)])
    _assert_same_masks(got, want)


def test_topk_edges_and_exact_counts(rng):
    sal = [torch.from_numpy((rng.integers(0, 3, s) * 1.0).astype(np.float32))
           for s in [(10,), (4, 5)]]
    assert all(float(m.sum()) == 0 for m in global_topk_masks(sal, 0))
    assert all(bool((m == 1).all()) for m in global_topk_masks(sal, 30))
    for k in range(31):
        assert sum(float(m.sum()) for m in global_topk_masks(sal, k)) == k


def test_saliency_and_masks_match_jax_on_resnet20s(rng):
    """The whole mask step on a model: −CE grads summed over batches (eval
    mode, fixed augmented images), |·|, masks at every threshold."""
    model, params, stats = jax_model_and_vars("resnet20s", rng)
    twin = port_twin("resnet20s", params, stats)
    batches = [(rng.random((8, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, 8).astype(np.int32),
                np.array([1] * 6 + [0] * 2, np.float32)) for _ in range(3)]

    def jax_loss(p, img, label, w):
        out = model.apply({"params": p, "batch_stats": stats}, img,
                          train=False)
        return -jax_ce(out, label, w)

    acc = jax.tree.map(jnp.zeros_like, params)
    for img, label, w in batches:
        g = jax.grad(jax_loss)(params, jnp.asarray(img), jnp.asarray(label),
                               jnp.asarray(w))
        acc = jax.tree.map(lambda a, b: a + b, acc, g)
    jax_sal = jax.tree.map(jnp.abs, acc)

    twin.eval()
    names = [n for n, _ in twin.named_parameters()]
    port_sal = accumulate_saliency(
        lambda b: -cross_entropy(twin(nchw(b[0])), torch.from_numpy(b[1]),
                                 torch.from_numpy(b[2])),
        list(twin.parameters()), batches)
    want = mask_from_jax(jax.tree.map(np.asarray, jax_sal))
    for n, s in zip(names, port_sal):
        np.testing.assert_allclose(s.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)

    # masks: the port's default order (named_parameters, OIHW) on JAX's
    # saliency equals JAX's masks (continuous values: no cross-leaf ties)
    jax_masks = jax_generate_masks(jax_sal)
    port_masks = generate_masks([want[n] for n in names])
    for t in DEFAULT_THRESHOLDS:
        ref = mask_from_jax(jax.tree.map(np.asarray, jax_masks[t]))
        for n, m in zip(names, port_masks[t]):
            np.testing.assert_array_equal(m.numpy(), ref[n].numpy(),
                                          err_msg=f"{n} t={t}")


def test_mask_bridge_round_trip_and_reference_format(rng, tmp_path):
    _, params, stats = jax_model_and_vars("resnet20s", rng)
    tree = jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.5).astype(np.float32), params)
    as_torch = mask_from_jax(tree)
    back = mask_to_jax(as_torch)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, y)

    twin = port_twin("resnet20s", params, stats)
    assert set(as_torch) == {n for n, _ in twin.named_parameters()}
    for n, p in twin.named_parameters():
        assert tuple(as_torch[n].shape) == tuple(p.shape)

    # a with_{t}.pt written by the port loads through the JAX importer
    path = str(tmp_path / "with_0.5.pt")
    save_mask(path, as_torch)
    imported = import_mask(path, params)
    for x, y in zip(jax.tree.leaves(imported), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(x), y)
    for n, t in load_mask(path).items():
        assert torch.equal(t, as_torch[n])
