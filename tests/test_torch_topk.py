"""The port's exact k-th value (``salun_torch.dist.topk``) against
``salun.dist.topk``: bitwise, over multi-tensor inputs, for k = 1, the
middle and N, with planted ties, signed zeros, infinities and a tensor k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from salun.dist import topk as jtopk
from salun_torch.dist import kth_largest, kth_largest_threshold


def _leaves(rng, kind):
    shapes = [(17, 9), (33,), (4, 5, 6), (2, 3, 3, 3)]
    if kind == "normal":
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if kind == "ties":  # a 5-level grid: masses of equal values
        return [np.round(rng.random(s) * 4).astype(np.float32) / 4
                for s in shapes]
    # signed zeros, infinities and repeated values around them
    pool = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 3.0, 3.0],
                    np.float32)
    return [pool[rng.integers(0, len(pool), s)] for s in shapes]


def _bits(x):
    return np.asarray(x, np.float32).reshape(1).view(np.uint32)[0]


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros_infs"])
def test_kth_largest_threshold_bitwise_equals_jax(rng, kind):
    leaves = _leaves(rng, kind)
    n = sum(a.size for a in leaves)
    for k in (1, 2, n // 2, n - 1, n):
        want = jtopk.kth_largest_threshold([jnp.asarray(a) for a in leaves],
                                           k)
        got = kth_largest_threshold([torch.from_numpy(a) for a in leaves], k)
        assert _bits(got) == _bits(want), (kind, k, float(got), float(want))
        got_t = kth_largest_threshold([torch.from_numpy(a) for a in leaves],
                                      torch.tensor(k))
        assert _bits(got_t) == _bits(want), (kind, k)


def test_kth_largest_of_one_tensor_bitwise_equals_jax(rng):
    flat = _leaves(rng, "zeros_infs")[0].reshape(-1)
    jax_kth = jax.jit(jtopk.kth_largest)
    for k in range(1, flat.size + 1):
        want = jax_kth(jnp.asarray(flat), jnp.asarray(k, jnp.int32))
        assert _bits(kth_largest(torch.from_numpy(flat), k)) == _bits(want)


def test_kth_largest_refuses_k_outside_range():
    with pytest.raises(ValueError):
        kth_largest(torch.ones(4), 0)
    with pytest.raises(ValueError):
        kth_largest(torch.ones(4), 5)
