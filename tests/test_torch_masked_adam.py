"""The port's masked Adam and ``build_optimizer`` against
``salun.core.masked_opt.build_optimizer`` with ``optax.apply_updates``.

Three tensors with random 0/1 masks, 8 steps of random gradients (the
same numbers on both sides) at a constant and a scheduled lr. Tolerance:
on kept coordinates the weights and both moments bitwise (the same fp32
operations in optax's order, the bias corrections in fp32); on
masked-out coordinates the port holds θ₀ bitwise and the moments at 0,
and JAX is within one rounding of θ₀ (it adds ``θ₀ − p`` to p). The
grad-mask-only and the unmasked Adam are held the same way, and the
factory's SGD kinds are the port's existing classes.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from salun.core.masked_opt import build_optimizer as jax_build_optimizer
from salun_torch.core.masked_opt import (SGD, Adam, FlatParams, GradMaskSGD,
                                         MaskedSGD, build_optimizer)

SHAPES = {"a": (6, 4), "b": (3,), "c": (2, 3, 3, 3)}
NAMES = sorted(SHAPES)


def _ulps(x):
    return np.spacing(np.abs(x).astype(np.float32))


def _run(rng, steps, lr, use_mask, use_theta0):
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    mask = {k: (rng.random(s) > 0.5).astype(np.float32)
            for k, s in SHAPES.items()}
    theta0 = {k: (p0[k] + 0.1 * rng.standard_normal(SHAPES[k])).astype(
        np.float32) for k in NAMES}
    tx = jax_build_optimizer(
        lr, mask={k: jnp.asarray(mask[k]) for k in NAMES} if use_mask
        else None,
        theta0={k: jnp.asarray(theta0[k]) for k in NAMES} if use_theta0
        else None, kind="adam")
    jp = {k: jnp.asarray(p0[k]) for k in NAMES}
    state = tx.init(jp)

    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in NAMES]
    flat = FlatParams(params)

    def flatten(d):
        return flat.flatten([torch.from_numpy(d[k]) for k in NAMES])

    opt = build_optimizer(flat, lr, mask=flatten(mask) if use_mask else None,
                          theta0=flatten(theta0) if use_theta0 else None,
                          kind="adam")
    assert isinstance(opt, Adam)
    for _ in range(steps):
        grads = [rng.standard_normal(SHAPES[k]).astype(np.float32)
                 for k in NAMES]
        upd, state = tx.update({k: jnp.asarray(g)
                                for k, g in zip(NAMES, grads)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        sum((p * torch.from_numpy(g)).sum()
            for p, g in zip(params, grads)).backward()
        opt.step()
    return params, jp, state, opt, mask, theta0, p0


def _adam_state(state):
    """The ``ScaleByAdamState`` inside a (possibly chained or masked) optax
    state."""
    found = []

    def visit(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append(s)
        elif isinstance(s, tuple):
            for x in s:
                visit(x)

    visit(state)
    [adam] = found
    return adam


@pytest.mark.parametrize("use_mask,use_theta0", [(True, True), (True, False),
                                                 (False, False)])
@pytest.mark.parametrize("lr", [1e-2, optax.linear_schedule(1e-2, 1e-3, 5)])
def test_adam_matches_build_optimizer(rng, use_mask, use_theta0, lr):
    params, jp, state, opt, mask, theta0, p0 = _run(
        rng, 8, lr, use_mask, use_theta0)
    adam = _adam_state(state)
    assert int(adam.count) == opt.count == 8
    offsets = np.cumsum([0] + [int(np.prod(SHAPES[k])) for k in NAMES])
    for i, (k, p) in enumerate(zip(NAMES, params)):
        got, want = p.detach().numpy(), np.asarray(jp[k])
        mu = opt.mu[offsets[i]:offsets[i + 1]].reshape(SHAPES[k]).numpy()
        nu = opt.nu[offsets[i]:offsets[i + 1]].reshape(SHAPES[k]).numpy()
        keep = mask[k] > 0 if use_mask else np.ones(SHAPES[k], bool)
        np.testing.assert_array_equal(got[keep], want[keep], err_msg=k)
        for ours, theirs in ((mu, adam.mu[k]), (nu, adam.nu[k])):
            np.testing.assert_array_equal(ours[keep], np.asarray(theirs)[keep],
                                          err_msg=k)
        if use_theta0:
            out = ~keep
            np.testing.assert_array_equal(got[out], theta0[k][out])
            assert not mu[out].any() and not nu[out].any()
            np.testing.assert_array_less(np.abs(want - theta0[k])[out],
                                         _ulps(theta0[k])[out] + 1e-30)
        elif use_mask:
            # grads masked only: masked-out weights never move under Adam
            np.testing.assert_array_equal(got[~keep], p0[k][~keep])
        assert (got[keep] != p0[k][keep]).all()  # kept weights moved


def test_build_optimizer_kinds():
    params = [torch.nn.Parameter(torch.zeros(3)),
              torch.nn.Parameter(torch.ones(2))]
    flat = FlatParams(params)
    m, t0 = torch.tensor([1, 0, 1, 1, 0.]), torch.zeros(5)
    assert type(build_optimizer(flat, 0.1)) is SGD
    assert type(build_optimizer(flat, 0.1, mask=m)) is GradMaskSGD
    assert type(build_optimizer(flat, 0.1, mask=m, theta0=t0)) is MaskedSGD
    opt = build_optimizer(flat, 0.1, theta0=t0, kind="adam")
    assert opt.mask is None and opt.theta0 is None  # θ₀ needs a mask
    with pytest.raises(ValueError):
        build_optimizer(flat, 0.1, kind="rmsprop")
