"""The port's attention (``salun_torch.kernels.{attention,flash_attention}``)
against ``salun.kernels``: on the CPU the wrappers run the plain versions
of K2/K3a/K3b, which are held here against the JAX XLA attention, the
Pallas flash kernels in interpret mode (forward, lse, and the custom VJP)
and torch autograd through the plain math.

Tolerances: both sides compute in fp32 (JAX at "highest" matmul
precision, ``tests/conftest.py``) and sum in other orders, so outputs of
magnitude ≤ ~3 agree to a few 1e-6; 2e-5 for values (as
``tests/test_kernels.py`` holds Pallas against XLA), 2e-4 for the
gradients (as ``tests/test_kernels.py`` holds the Pallas VJP), and 1e-5
against torch's own autograd on the same math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from salun.kernels import attention as jax_attention
from salun.kernels.attention import _xla_attention
from salun.kernels.flash_attention import (_flash_fwd, flash_attention,
                                           flash_attention_trainable)
from salun_torch.kernels import flash_attention as fa
from salun_torch.kernels.attention import (multi_head_attention,
                                           scaled_dot_attention)


def _qkv(rng, b, nq, nk, d):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, nq, d), (b, nk, d), (b, nk, d)))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 16, 16, 256), (2, 100, 77, 40),
                                   (1, 256, 256, 128)], ids=str)
def test_plain_forward_matches_xla_attention(rng, shape):
    b, nq, nk, d = shape
    q, k, v = _qkv(rng, b, nq, nk, d)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          d ** -0.5)
    got = scaled_dot_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_forward_and_lse_match_pallas_interpret(rng):
    b, n, d = 2, 256, 128
    q, k, v = _qkv(rng, b, n, n, d)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want_o = flash_attention(jq, jk, jv, scale=scale, block_q=128,
                                 block_k=128)
        _, l, m = _flash_fwd(jq, jk, jv, scale, 128, 128)
    want_lse = np.asarray(m[..., 0] + jnp.log(l[..., 0]))
    o, lse = fa.flash_attention_fwd(*_t(q, k, v), scale, need_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)


def test_autograd_function_matches_pallas_vjp_interpret(rng):
    """Plain forward + plain K3a/K3b backward against JAX
    ``flash_attention_trainable``'s custom VJP, as
    ``tests/test_kernels.py:58-81`` runs it."""
    b, n, d = 2, 256, 128
    q, k, v = _qkv(rng, b, n, n, d)
    scale = d ** -0.5

    def loss_flash(q, k, v):
        return jnp.sum(jnp.sin(flash_attention_trainable(q, k, v, scale,
                                                         128, 128)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_flash, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    torch.sin(fa.FlashAttention.apply(*leaves, scale)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("shape", [(3, 16, 16, 256), (2, 100, 77, 40)],
                         ids=str)
def test_autograd_function_matches_torch_autograd(rng, shape):
    b, nq, nk, d = shape
    q, k, v = _qkv(rng, b, nq, nk, d)
    w = torch.from_numpy(rng.standard_normal((b, nq, d)).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: scaled_dot_attention(q, k, v),
               lambda q, k, v: torch.softmax(
                   q @ k.transpose(1, 2) * d ** -0.5, -1) @ v):
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_multi_head_attention_matches_jax(rng):
    b, nq, nk, h, d = 2, 64, 77, 8, 40
    q = rng.standard_normal((b, nq, h * d)).astype(np.float32)
    k = rng.standard_normal((b, nk, h * d)).astype(np.float32)
    v = rng.standard_normal((b, nk, h * d)).astype(np.float32)
    want = jax_attention.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), h)
    got = multi_head_attention(*_t(q, k, v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_cpu_wrappers_count_no_launch(rng):
    q, k, v = _t(*_qkv(rng, 2, 16, 16, 64))
    before = [f.launches for f in (fa.flash_attention_fwd,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    leaves = [t.requires_grad_() for t in (q, k, v)]
    scaled_dot_attention(*leaves).sum().backward()
    with torch.no_grad():
        scaled_dot_attention(q, k, v)
    assert [f.launches for f in (fa.flash_attention_fwd,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == before


@pytest.mark.parametrize("bad", ["d12", "d264", "bf16", "mismatch",
                                 "strided", "lse_shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    b, n, d = 2, 16, 64
    q, k, v = torch.zeros(b, n, d), torch.zeros(b, n, d), torch.zeros(b, n, d)
    lse, delta = torch.zeros(b, n), torch.zeros(b, n)
    if bad == "d12":
        q, k, v = (torch.zeros(b, n, 12) for _ in range(3))
    elif bad == "d264":  # K3a/K3b take D up to 256, K2 up to 512
        q, k, v = (torch.zeros(b, n, 264) for _ in range(3))
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dq(q, k, v, q, lse, delta, 0.125)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dkv(q, k, v, q, lse, delta, 0.125)
        with pytest.raises(ValueError):
            scaled_dot_attention(*(t.requires_grad_() for t in (q, k, v)))
        q, k, v = (torch.zeros(b, n, 520) for _ in range(3))
    elif bad == "bf16":
        q = q.bfloat16()
    elif bad == "mismatch":
        v = torch.zeros(b, n + 1, d)
    elif bad == "strided":
        k = torch.zeros(b, d, n).transpose(1, 2)
    else:
        lse = torch.zeros(b, n + 1)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dq(q, k, v, q, lse, delta, 0.125)
        return
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_fwd(q, k, v, 0.125)
