"""Sequence-parallel ring attention (``salun_torch.dist.ring_attention``) on
the CPU, against ``salun.dist.ring_attention``.

Two spawned gloo ranks of ``make_mesh(2, 1)`` each hold half of a [B, N,
C] = [2, 64, 16] sequence (numpy, seed 0); each rank's loss is the sum of
squares of its rows of the output. The output and the gradients of q, k
and v, put back together from both ranks, are held against
``salun.dist.ring_attention`` on a 2-device CPU mesh, against
``salun.kernels.attention._xla_attention`` (the single-device oracle)
and against the port's one-process form on the whole sequence (rank 0,
no mesh). A ragged split (blocks of 7 and 6) raises ``ValueError`` on
both ranks, and the spawn returns.

Tolerances, those of ``tests/test_distributed.py:212-227`` for JAX's own
ring: the output to rtol 2e-5 / atol 2e-6, the gradients to 5e-5 / 5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _parallel_workers as pw
import _sharded_workers as workers
from _torch_port import one_torch_thread  # noqa: F401
from salun.dist import make_mesh as jax_make_mesh
from salun.dist import ring_attention as jax_ring_attention
from salun.kernels.attention import _xla_attention
from salun_torch.dist import ring_attention

FWD = {"rtol": 2e-5, "atol": 2e-6}
GRAD = {"rtol": 5e-5, "atol": 5e-6}


@pytest.fixture(scope="module")
def two_ranks():
    out = workers.spawn("ring", timeout=120)
    for o in out:
        assert "error" not in o, o["error"]
    return out


@pytest.fixture(scope="module")
def jax_sides():
    """{name: (out, (dq, dk, dv))} of JAX's ring on two devices and of the
    single-device oracle, loss Σout²."""
    q, k, v = (jnp.asarray(a) for a in pw.ring_inputs())
    mesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
    scale = pw.RING_C ** -0.5
    fns = {"jax_ring": lambda q, k, v: jax_ring_attention(
               q, k, v, mesh, seq_axis="data"),
           "xla": lambda q, k, v: _xla_attention(q, k, v, scale)}
    out = {}
    for name, fn in fns.items():
        grads = jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                         argnums=(0, 1, 2))(q, k, v)
        out[name] = (np.asarray(fn(q, k, v)),
                     tuple(np.asarray(g) for g in grads))
    return out


def _gathered(two_ranks):
    """The output and gradients of both ranks put back along the
    sequence."""
    ring = [o["ring"] for o in two_ranks]
    out = np.concatenate([r["out"] for r in ring], axis=1)
    grads = tuple(np.concatenate([r["grads"][i] for r in ring], axis=1)
                  for i in range(3))
    return out, grads


@pytest.mark.parametrize("oracle", ["jax_ring", "xla", "port_one_process"])
def test_ring_forward_and_grads_match(two_ranks, jax_sides, oracle):
    got_out, got_grads = _gathered(two_ranks)
    if oracle == "port_one_process":
        one = two_ranks[0]["one"]
        want_out, want_grads = one["out"], tuple(one["grads"])
    else:
        want_out, want_grads = jax_sides[oracle]
    np.testing.assert_allclose(got_out, want_out, **FWD)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, **GRAD)


def test_one_process_form_matches_jax_oracle(jax_sides):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in pw.ring_inputs())
    out = ring_attention(q, k, v)
    (out ** 2).sum().backward()
    want_out, want_grads = jax_sides["xla"]
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD)
    for t, w in zip((q, k, v), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), w, **GRAD)


def test_ragged_sequence_raises_on_every_rank(two_ranks):
    for o in two_ranks:
        assert o["ragged"].startswith("ValueError"), o["ragged"]
        assert "not divisible" in o["ragged"]
