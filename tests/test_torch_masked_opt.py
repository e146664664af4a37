"""The port's flat-buffer optimizers against the JAX package's optax ones.

``MaskedSGD`` runs K1's plain version here (CPU tensors). Tolerance, over a
60-step trajectory with a MultiStep lr that crosses its milestone: bitwise
on the coordinates the mask keeps (same fp32 operations in the same order
as ``masked_sgd_fused``); on masked-out coordinates the port holds θ₀
exactly and the JAX path is within one rounding of θ₀ (it applies the
update ``θ₀ - p`` as ``p + (θ₀ - p)``), i.e. 1 ulp of max(|p|, |θ₀ - p|).
The unmasked ``SGD`` is bitwise equal to ``salun.core.masked_opt.sgd``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from salun.core.masked_opt import masked_sgd_fused, sgd
from salun.core.train import multistep_lr as jax_multistep_lr
from salun_torch.core.masked_opt import SGD, FlatParams, MaskedSGD
from salun_torch.core.train import multistep_lr

SHAPES = {"a": (6, 4), "b": (3,), "c": (2, 3, 3, 3)}


def _params(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _backward_with(params, grads):
    """A loss whose gradient w.r.t. each parameter is exactly ``grads``."""
    loss = sum((p * torch.from_numpy(g)).sum() for p, g in zip(params, grads))
    loss.backward()


def test_multistep_lr_matches_optax_schedule():
    ours = multistep_lr(0.013, [2, 5], 7)
    theirs = jax_multistep_lr(0.013, [2, 5], 7)
    for step in range(50):
        assert np.float32(ours(step)) == np.float32(theirs(step)), step


@pytest.mark.parametrize("steps", [60])
def test_masked_sgd_trajectory_matches_masked_sgd_fused(rng, steps):
    p0 = _params(rng)
    mask = {k: (rng.random(s) > 0.5).astype(np.float32)
            for k, s in SHAPES.items()}
    names = sorted(SHAPES)   # one order for both sides
    sched_args = (0.05, [2], 20)   # milestone at step 40

    tx = masked_sgd_fused(jax_multistep_lr(*sched_args), 0.9, 5e-4,
                          {k: jnp.asarray(mask[k]) for k in names},
                          {k: jnp.asarray(p0[k]) for k in names})
    jp = {k: jnp.asarray(p0[k]) for k in names}
    state = tx.init(jp)

    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in names]
    flat = FlatParams(params)
    opt = MaskedSGD(flat, multistep_lr(*sched_args), 0.9, 5e-4,
                    mask=flat.flatten([torch.from_numpy(mask[k])
                                       for k in names]),
                    theta0=flat.flatten([torch.from_numpy(p0[k])
                                         for k in names]))
    for _ in range(steps):
        grads = [rng.standard_normal(SHAPES[k]).astype(np.float32)
                 for k in names]
        upd, state = tx.update({k: jnp.asarray(g)
                                for k, g in zip(names, grads)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        _backward_with(params, grads)
        opt.step()

    assert opt.count == steps
    assert opt._lr_value == float(np.float32(0.1) * np.float32(0.05))
    for k, p in zip(names, params):
        got, want = p.detach().numpy(), np.asarray(jp[k])
        keep = mask[k] > 0
        np.testing.assert_array_equal(got[keep], want[keep])
        np.testing.assert_array_equal(got[~keep], p0[k][~keep])
        tol = np.spacing(np.maximum(np.abs(want), np.abs(p0[k] - want)))
        assert np.all(np.abs(want - p0[k])[~keep] <= tol[~keep])
    bufs = torch.split(opt.trace, [int(np.prod(SHAPES[k])) for k in names])
    for k, b in zip(names, bufs):
        np.testing.assert_array_equal(b.numpy().reshape(SHAPES[k]),
                                      np.asarray(state.trace[k]))


def test_sgd_matches_optax_chain(rng):
    p0 = _params(rng)
    names = sorted(SHAPES)
    tx = sgd(0.05, 0.9, 5e-4)
    jp = {k: jnp.asarray(p0[k]) for k in names}
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in names]
    opt = SGD(FlatParams(params), 0.05, 0.9, 5e-4)
    for _ in range(5):
        grads = [rng.standard_normal(SHAPES[k]).astype(np.float32)
                 for k in names]
        upd, state = tx.update(dict(zip(names, map(jnp.asarray, grads))),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        _backward_with(params, grads)
        opt.step()
    for k, p in zip(names, params):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp[k]))


def test_flat_grads_survive_backward_in_place(rng):
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 3))
    flat = FlatParams(model.parameters())
    ptrs = [p.grad.data_ptr() for p in model.parameters()]
    x = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    model(x).square().sum().backward()
    once = flat.grad.clone()
    assert once.abs().sum() > 0
    assert [p.grad.data_ptr() for p in model.parameters()] == ptrs
    model(x).square().sum().backward()   # autograd accumulates in place
    torch.testing.assert_close(flat.grad, 2 * once, rtol=0, atol=0)
    flat.check_grads()
    # the parameters are views into the flat buffer
    with torch.no_grad():
        flat.flat.zero_()
    assert all(float(p.detach().abs().sum()) == 0
               for p in model.parameters())
    flat.zero_grad()
    assert float(flat.grad.abs().sum()) == 0


def test_step_raises_when_a_grad_leaves_the_flat_buffer(rng):
    params = [torch.nn.Parameter(torch.zeros(3)),
              torch.nn.Parameter(torch.zeros(2))]
    flat = FlatParams(params)
    opt = MaskedSGD(flat, 0.1, mask=torch.ones(5), theta0=torch.zeros(5))
    params[1].grad = None
    with pytest.raises(RuntimeError, match="flat grad buffer"):
        opt.step()
    params[1].grad = torch.zeros(2)   # a copy outside the buffer
    with pytest.raises(RuntimeError, match="flat grad buffer"):
        opt.step()


def test_masked_sgd_rejects_a_non_binary_mask():
    flat = FlatParams([torch.nn.Parameter(torch.zeros(4))])
    with pytest.raises(ValueError, match="0/1"):
        MaskedSGD(flat, 0.1, mask=torch.tensor([0.0, 0.5, 1.0, 1.0]),
                  theta0=torch.zeros(4))
