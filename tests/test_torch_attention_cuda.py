"""K2, K3a and K3b on the card against their plain PyTorch versions
(``-m cuda``).

Skips where no CUDA device is present; the decision is taken inside the
fixture, never at import. Imports neither ``jax`` nor ``salun``: on the
card's machine run ``python -m pytest tests/test_torch_attention_cuda.py
-m cuda --noconftest -p no:cacheprovider``.

Tolerance: both sides compute to about fp32 precision (TF32 off for the
plain versions), but sum in other orders. K2 and K3b multiply on the
tensor cores in 3xTF32 (each operand split into two TF32 parts, three
products summed in fp32: about 22 of fp32's 24 bits), K2 over 64-wide key
tiles with an online softmax, K3b over 32- or 64-wide query tiles, split
over blocks where the grid is small; K3a uses sequential fp32 FMAs over
32-wide tiles; the plain versions cuBLAS SGEMM over materialised scores.
They differ by about 1e-6 of the largest value here. The bound ``1e-4 ·
max(1, max|want|)`` leaves 100× room and still fails plain TF32 (~5e-4
relative) or any indexing fault (O(1)); the K2 and K3b width tests also
hold 3xTF32 to 2e-5.
"""

import pytest
import torch

from salun_torch.kernels import flash_attention as fa
from salun_torch.kernels.attention import (multi_head_attention,
                                           scaled_dot_attention)
from salun_torch.utils.device import set_tf32

SHAPES = [  # (B, Nq, Nk, D)
    (128, 256, 256, 256),  # DDPM res-16 attention, bs 128
    (128, 16, 16, 256),    # DDPM mid block
    (3, 77, 77, 64),       # ragged N
    (2, 100, 77, 40),      # Nq ≠ Nk (SD cross-attention), D = 40
    (4, 33, 65, 160),
    (1, 1, 1, 8),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2/K3 have no CPU or interpret "
                    "mode)")
    set_tf32(False)
    return torch.device("cuda")


def _close(got, want, tol=1e-4):
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def _inputs(dev, b, nq, nk, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return rnd(b, nq, d), rnd(b, nk, d), rnd(b, nk, d), rnd(b, nq, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernels_match_plain_on_card(cuda, shape):
    b, nq, nk, d = shape
    q, k, v, do = _inputs(cuda, b, nq, nk, d)
    scale = d ** -0.5
    counts = [f.launches for f in (fa.flash_attention_fwd,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    o, lse = fa.flash_attention_fwd(q, k, v, scale, need_lse=True)
    want_o, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    _close(o, want_o)
    _close(lse, want_lse)
    o_only, none = fa.flash_attention_fwd(q, k, v, scale)
    assert none is None and torch.equal(o_only, o)

    delta = (do * want_o).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, want_lse, delta, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, want_lse, delta, scale)
    _close(dq, fa.flash_attention_bwd_dq_reference(q, k, v, do, want_lse,
                                                   delta, scale))
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, want_lse, delta, scale)
    _close(dk, want_dk)
    _close(dv, want_dv)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_attention_fwd,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == [
        counts[0] + 2, counts[1] + 1, counts[2] + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4096, 4096, 512), (2, 64, 64, 512),
                                   (2, 33, 77, 264), (1, 1, 5, 512)],
                         ids=str)
def test_k2_wide_heads_match_plain_on_card(cuda, shape):
    """K2 above D = 256 (32 query rows a block, four column-warps): the SD
    VAE mid block's [4, 4096, 4096, 512] and ragged shapes."""
    b, nq, nk, d = shape
    q, k, v, _ = _inputs(cuda, b, nq, nk, d)
    scale = d ** -0.5
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, scale, need_lse=True)
    want_o, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    _close(o, want_o)
    _close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 33, 77, 8), (2, 33, 77, 40), (2, 33, 77, 64), (2, 33, 77, 80),
    (2, 33, 77, 160), (2, 33, 77, 256), (2, 33, 77, 264), (2, 33, 77, 512),
    (2, 100, 77, 40),  # SD cross-attention
    (3, 16, 130, 80), (1, 1, 200, 256), (2, 130, 1, 512),
], ids=str)
def test_k2_every_width_matches_plain_on_card(cuda, shape):
    """K2 at every head width the port runs (one instantiation per range:
    D ≤ 64, ≤ 128, ≤ 256, ≤ 512), with ragged Nq ≠ Nk: within 1e-4 and,
    as 3xTF32 keeps about 1e-6, within 2e-5 of the largest value."""
    b, nq, nk, d = shape
    q, k, v, _ = _inputs(cuda, b, nq, nk, d, seed=3)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale, need_lse=True)
    want_o, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    for got, want in ((o, want_o), (lse, want_lse)):
        _close(got, want)
        _close(got, want, tol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 256, 256, 256), (32, 1024, 77, 80),
                                   (2, 300, 300, 512)], ids=str)
def test_k2_is_bitwise_deterministic_on_card(cuda, shape):
    """No atomics, a fixed summation order: two launches on the same inputs
    give the same o and lse, bit for bit."""
    b, nq, nk, d = shape
    q, k, v, _ = _inputs(cuda, b, nq, nk, d, seed=4)
    first = fa.flash_attention_fwd(q, k, v, d ** -0.5, need_lse=True)
    second = fa.flash_attention_fwd(q, k, v, d ** -0.5, need_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def _dkv_on_card(cuda, shape, seed):
    """K3b and its plain version on the same inputs (lse and δ from the
    plain forward): ``(dk, dv, want_dk, want_dv)``."""
    b, nq, nk, d = shape
    q, k, v, do = _inputs(cuda, b, nq, nk, d, seed=seed)
    scale = d ** -0.5
    want_o, lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    delta = (do * want_o).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                            delta, scale)
    torch.cuda.synchronize()
    return dk, dv, want_dk, want_dv


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 33, 77, 8), (2, 77, 33, 40), (2, 33, 77, 64), (2, 77, 33, 80),
    (2, 33, 77, 128), (2, 77, 33, 160), (2, 33, 77, 256),
    (3, 130, 16, 256),  # the DDPM mid block's N, ragged
], ids=str)
def test_k3b_every_width_matches_plain_on_card(cuda, shape):
    """K3b at every head width it instantiates (D ≤ 64, ≤ 128, ≤ 256) and
    D = 8, 40, 80, 160 inside them, ragged Nq ≠ Nk: within 1e-4 and, as
    3xTF32 keeps about 1e-6, within 2e-5 of the largest value."""
    dk, dv, want_dk, want_dv = _dkv_on_card(cuda, shape, seed=5)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        _close(got, want)
        _close(got, want, tol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1000, 77, 40), (1, 4096, 5, 80),
                                   (4, 300, 77, 160), (1, 5, 100, 40)],
                         ids=str)
def test_k3b_split_walk_matches_plain_on_card(cuda, shape):
    """Short Nk: the query walk is split over blocks (SD cross-attention's
    Nk = 77; one k-tile at Nk = 5) and the partials summed by a second
    kernel, still one counted launch; and Nq below one query tile."""
    b, nq, nk, d = shape
    splits, _ = fa.dkv_split_plan(b, nq, nk, d,
                                  fa.dkv_resident_blocks(cuda, d))
    assert (splits > 1) == (nq > 5)
    before = fa.flash_attention_bwd_dkv.launches
    dk, dv, want_dk, want_dv = _dkv_on_card(cuda, shape, seed=6)
    assert fa.flash_attention_bwd_dkv.launches == before + 1
    for got, want in ((dk, want_dk), (dv, want_dv)):
        _close(got, want)
        _close(got, want, tol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 256, 256, 256), (32, 4096, 77, 40),
                                   (2, 300, 300, 80)], ids=str)
def test_k3b_is_bitwise_deterministic_on_card(cuda, shape):
    """No atomics, a fixed summation order (the split walk's partials too):
    two launches on the same inputs give the same dk and dv, bit for
    bit."""
    b, nq, nk, d = shape
    q, k, v, do = _inputs(cuda, b, nq, nk, d, seed=7)
    lse = torch.randn(b, nq, device=cuda).abs() + 3.0
    delta = torch.randn(b, nq, device=cuda)
    first = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, d ** -0.5)
    second = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, d ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu_plain(cuda):
    """The autograd function with K2/K3 on the card against the same
    function on the CPU (plain forward and backward)."""
    b, n, d = 4, 77, 64
    q, k, v, w = (t.cpu() for t in _inputs(cuda, b, n, n, d, seed=1))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = scaled_dot_attention(*leaves)
        (out * w.to(dev)).sum().backward()
        grads[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        _close(got, want)


@pytest.mark.cuda
def test_multi_head_attention_on_card(cuda):
    b, n, h, d = 2, 64, 8, 40
    q, k, v, _ = _inputs(cuda, b, n, n, h * d, seed=2)
    got = multi_head_attention(q, k, v, h)
    want = multi_head_attention(q.cpu(), k.cpu(), v.cpu(), h)
    _close(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["d12", "d264", "bf16", "strided", "cpu_k"])
def test_unsupported_input_raises_on_card(cuda, bad):
    b, n, d = 2, 16, 64
    q, k, v, _ = _inputs(cuda, b, n, n, d)
    before = fa.flash_attention_fwd.launches
    if bad == "d12":
        q, k, v = (t[..., :12].contiguous() for t in (q, k, v))
    elif bad == "d264":  # a gradient: K3a/K3b take D up to 256
        q, k, v = (torch.randn(b, n, 264, device=cuda, requires_grad=True)
                   for _ in range(3))
    elif bad == "bf16":
        q = q.bfloat16()
    elif bad == "strided":
        q = torch.randn(b, d, n, device=cuda).transpose(1, 2)
    else:
        k = k.cpu()
    with pytest.raises((TypeError, ValueError)):
        scaled_dot_attention(q, k, v)
    assert fa.flash_attention_fwd.launches == before
