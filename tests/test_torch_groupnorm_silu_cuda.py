"""K4 and K4b (fused GroupNorm + SiLU, forward and backward) on the card
against their plain PyTorch versions (``-m cuda``).

Skips where no CUDA device is present; the decision is taken inside the
fixture, never at import. Imports neither ``jax`` nor ``salun``: on the
card's machine run ``python -m pytest tests/test_torch_groupnorm_silu_cuda.py
-m cuda --noconftest -p no:cacheprovider``.

Tolerances: both sides compute in fp32 but sum in other orders (the
kernels: a two-pass (count, mean, M2) per unit of ≤ 512 values, merged by
Chan's formula in unit, warp and cluster-rank order; dscale/dbias per
plane in unit order, then over ranks and batch; the plain versions:
torch's reductions), so they differ by fp32 rounding of sums of up to 2M
terms. Forward 1e-5 · max(1, max|want|) (outputs are O(1)); the
backward's dscale/dbias are sums over batch and space of O(1) terms, so
1e-4 · max(1, max|want|) on every output. Both fail an indexing fault
(O(1)) or a lost unit. Every sum has a fixed order, so two launches give
the same bits.
"""

import pytest
import torch

from salun_torch.kernels import groupnorm_silu as gn
from salun_torch.utils.device import set_tf32


def _cluster_edge(hw, backward):
    """The largest gc < 256 at which ``_plan`` cuts a slab (batch 2, 32
    groups of gc planes of hw values) over fewer blocks than at gc + 1."""
    ks = [gn._plan(2, 32 * gc, hw, 32, backward).cluster
          for gc in range(1, 257)]
    return max(gc for gc in range(1, 256) if ks[gc] > ks[gc - 1])


# (B, C, H, W, groups, eps)
SHAPES = [
    (8, 320, 64, 64, 32, 1e-5),    # SD U-Net level 0, CFG-doubled bs 4
    (4, 2560, 8, 8, 32, 1e-5),     # U-Net bottom (output_blocks.0)
    (4, 960, 64, 64, 32, 1e-5),    # the largest resident slab
    (4, 1920, 32, 32, 32, 1e-5),   # output_blocks.6 at bs 4
    (4, 128, 512, 512, 32, 1e-6),  # VAE encoder level 0
    (1, 256, 512, 512, 32, 1e-6),  # 2,097,152-value groups (gc 8)
    (2, 32, 50, 100, 32, 1e-5),    # plane of 5,000: a ragged last chunk
    (3, 6, 5, 7, 3, 1e-5),         # S = 35: the scalar path
    (2, 32, 1, 1, 32, 1e-6),       # gc = 1, H = W = 1
    (1, 1, 1, 1, 1, 1e-5),
] + [  # one plane under and one over a cluster-size edge, each way
    (2, 32 * gc, 32, 32, 32, 1e-5)
    for edge in (_cluster_edge(1024, False), _cluster_edge(1024, True))
    for gc in (edge, edge + 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4/K4b have no CPU or interpret "
                    "mode)")
    set_tf32(False)
    return torch.device("cuda")


def _close(got, want, tol):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


def _inputs(dev, b, c, h, w, offset=0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = b * c * h * w

    def rnd(*shape, scale=1.0, shift=0.0):
        size = 1
        for s in shape:
            size *= s
        flat = torch.randn(size + offset, generator=gen, device=dev)
        return (flat * scale + shift)[offset:].view(shape)

    x = rnd(b, c, h, w, scale=2.0, shift=0.5)
    weight = rnd(c, scale=0.3, shift=1.0)
    bias = rnd(c, scale=0.3)
    dy = rnd(b, c, h, w)
    assert x.numel() == n
    return x, weight, bias, dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k4_and_k4b_match_plain_on_card(cuda, shape):
    b, c, h, w, groups, eps = shape
    x, weight, bias, dy = _inputs(cuda, b, c, h, w)
    before = (gn.groupnorm_silu.launches,
              gn.groupnorm_silu_backward.launches)
    y, mean, rstd = gn.groupnorm_silu(x, weight, bias, groups, eps)
    want_y, want_mean, want_rstd = gn.groupnorm_silu_reference(
        x, weight, bias, groups, eps)
    got = gn.groupnorm_silu_backward(dy, x, weight, bias, mean, rstd, groups)
    want = gn.groupnorm_silu_backward_reference(dy, x, weight, bias,
                                                want_mean, want_rstd, groups)
    torch.cuda.synchronize()
    assert (gn.groupnorm_silu.launches,
            gn.groupnorm_silu_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
    _close(y, want_y, 1e-5)
    _close(mean, want_mean, 1e-5)
    _close(rstd, want_rstd, 1e-5)
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (2, 640, 64, 64),
                                   (1, 128, 512, 512)], ids=str)
def test_unaligned_input_takes_the_scalar_path(cuda, shape):
    """A contiguous view 4 bytes past a 16-byte boundary, at a shape that
    is otherwise resident (one block; a cluster) or streamed: same
    results, on the scalar path."""
    b, c, h, w = shape
    x, weight, bias, dy = _inputs(cuda, b, c, h, w, offset=1)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    assert gn._plan(b, c, h * w, 32, False, False).path == "scalar"
    y, mean, rstd = gn.groupnorm_silu(x, weight, bias, 32, 1e-5)
    want = gn.groupnorm_silu_reference(x, weight, bias, 32, 1e-5)
    for g, wnt in zip((y, mean, rstd), want):
        _close(g, wnt, 1e-5)
    got = gn.groupnorm_silu_backward(dy, x, weight, bias, mean, rstd, 32)
    want = gn.groupnorm_silu_backward_reference(dy, x, weight, bias, mean,
                                                rstd, 32)
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-4)


# one shape a path: resident in one block, resident over a cluster,
# streamed, scalar
BITWISE = [(4, 2560, 8, 8), (4, 256, 128, 128), (4, 640, 64, 64),
           (2, 128, 512, 512), (3, 6, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BITWISE, ids=str)
def test_k4_is_deterministic(cuda, shape):
    """y, mean and rstd bitwise equal from run to run."""
    x, weight, bias, _ = _inputs(cuda, *shape)
    groups = 3 if shape[1] == 6 else 32
    first = gn.groupnorm_silu(x, weight, bias, groups, 1e-6)
    second = gn.groupnorm_silu(x, weight, bias, groups, 1e-6)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BITWISE, ids=str)
def test_k4b_is_deterministic(cuda, shape):
    """Fixed-order sums instead of atomics: dx, dscale and dbias bitwise
    equal from run to run."""
    x, weight, bias, dy = _inputs(cuda, *shape)
    groups = 3 if shape[1] == 6 else 32
    _, mean, rstd = gn.groupnorm_silu(x, weight, bias, groups, 1e-6)
    first = gn.groupnorm_silu_backward(dy, x, weight, bias, mean, rstd,
                                       groups)
    second = gn.groupnorm_silu_backward(dy, x, weight, bias, mean, rstd,
                                        groups)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_module_autograd_on_card_matches_cpu_plain(cuda):
    x, weight, bias, dy = _inputs(cuda, 2, 64, 12, 12)
    sides = {}
    for dev in ("cpu", cuda):
        mod = gn.GroupNormSiLU(32, 64, eps=1e-5).to(dev)
        with torch.no_grad():
            mod.weight.copy_(weight)
            mod.bias.copy_(bias)
        xl = x.to(dev).clone().requires_grad_()
        out = mod(xl)
        out.backward(dy.to(dev))
        sides[str(dev)] = [t.cpu() for t in (out, xl.grad, mod.weight.grad,
                                             mod.bias.grad)]
    for g, w in zip(sides[str(cuda)], sides["cpu"]):
        _close(g, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bf16", "strided", "groups", "cpu_w"])
def test_unsupported_input_raises_on_card(cuda, bad):
    x, weight, bias, _ = _inputs(cuda, 2, 64, 8, 8)
    groups = 32
    if bad == "bf16":
        x = x.bfloat16()
    elif bad == "strided":
        x = x.transpose(2, 3)
    elif bad == "groups":
        groups = 48
    else:
        weight = weight.cpu()
    before = gn.groupnorm_silu.launches
    with pytest.raises((TypeError, ValueError)):
        gn.groupnorm_silu(x, weight, bias, groups, 1e-5)
    assert gn.groupnorm_silu.launches == before
