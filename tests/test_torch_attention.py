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


# K3b's split plan at the paths' shapes (B·heads, Nq, Nk, D): the DDPM
# U-Net's and the SD U-Net's self- and cross-attention
_SELF = [(128, 256, 256, 256), (256, 256, 256, 256), (128, 16, 16, 256),
         (32, 4096, 4096, 40), (32, 1024, 1024, 80), (32, 256, 256, 160)]
_CROSS = [(32, 4096, 77, 40), (32, 1024, 77, 80), (32, 256, 77, 160),
          (32, 64, 77, 160), (32, 64, 64, 160)]


@pytest.mark.parametrize("per_sm", [1, 2, 4])
@pytest.mark.parametrize("shape", _SELF + _CROSS + [(1, 4096, 5, 80),
                                                    (2, 1000, 77, 40),
                                                    (1, 5, 100, 40),
                                                    (3, 1, 1, 8)], ids=str)
def test_dkv_split_plan_covers_every_query_tile_once(shape, per_sm):
    """Split s covers query rows [s·rows, min(nq, (s+1)·rows)): each range
    is non-empty and a whole number of BQ-row tiles but the last, together
    they hold every query tile exactly once, and the grid stays within
    one wave of an H100's 132 SMs where it was split."""
    b, nq, nk, d = shape
    resident = 132 * per_sm
    splits, rows = fa.dkv_split_plan(b, nq, nk, d, resident)
    bk, bq = fa.dkv_tiles(d)
    assert rows % bq == 0 and 1 <= splits <= -(-nq // bq)
    assert splits == 1 or rows // bq >= fa.DKV_MIN_SPLIT_TILES
    starts = [s * rows for s in range(splits)]
    ends = [min(nq, s0 + rows) for s0 in starts]
    assert all(s0 < e for s0, e in zip(starts, ends))
    tiles = [t for s0, e in zip(starts, ends) for t in range(s0 // bq,
                                                             -(-e // bq))]
    assert tiles == list(range(-(-nq // bq)))
    if splits > 1:
        assert b * -(-nk // bk) * splits <= resident


def _blocks_per_sm(d):
    """K3b's resident blocks per SM by head width, from its registers and
    shared memory (``-Xptxas -v`` on sm_90a: 126, 156, 128 and 168
    registers for D ≤ 40, ≤ 64, ≤ 128, ≤ 256; 212 KB of shared memory at
    D = 256)."""
    return 4 if d <= 40 else 3 if d <= 64 else 2 if d <= 128 else 1


def test_dkv_split_plan_splits_only_the_short_key_walks():
    """For 132 SMs: one split at the DDPM and the SD self-attention shapes,
    several at SD cross-attention (Nk = 77) where B·⌈Nk/BK⌉ blocks leave
    SMs idle and the walk is long enough to share."""
    for b, nq, nk, d in _SELF + [(32, 64, 64, 160), (32, 64, 77, 160)]:
        assert fa.dkv_split_plan(b, nq, nk, d,
                                 132 * _blocks_per_sm(d))[0] == 1
    assert fa.dkv_split_plan(32, 4096, 77, 40, 132 * 4) == (8, 512)
    assert fa.dkv_split_plan(32, 1024, 77, 80, 132 * 2) == (4, 256)
    # 96 blocks of 32 keys on 132 SMs at one block each stay whole
    assert fa.dkv_split_plan(32, 256, 77, 160, 132)[0] == 1


@pytest.mark.parametrize("shape", [(2, 1000, 77, 40), (1, 300, 5, 80)],
                         ids=str)
def test_plain_dkv_summed_over_splits_matches_the_whole(rng, shape):
    """The split walk's premise: dk and dv are sums over query rows, so the
    plain K3b of each split's rows, summed in the order s = 0, 1, …,
    equals the whole within fp32 rounding."""
    b, nq, nk, d = shape
    q, k, v = _t(*_qkv(rng, b, nq, nk, d))
    do = torch.from_numpy(rng.standard_normal((b, nq, d)).astype(np.float32))
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    delta = (do * o).sum(-1)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                scale)
    splits, rows = fa.dkv_split_plan(b, nq, nk, d, 16)
    assert splits > 1
    got = [torch.zeros_like(k), torch.zeros_like(v)]
    for s in range(splits):
        r = slice(s * rows, (s + 1) * rows)
        part = fa.flash_attention_bwd_dkv_reference(
            q[:, r].contiguous(), k, v, do[:, r].contiguous(),
            lse[:, r].contiguous(), delta[:, r].contiguous(), scale)
        got = [acc + x for acc, x in zip(got, part)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
