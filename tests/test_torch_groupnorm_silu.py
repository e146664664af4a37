"""The port's fused GroupNorm + SiLU (``salun_torch.kernels.groupnorm_silu``)
against ``salun.kernels.groupnorm_silu``: on the CPU the wrappers run the
plain versions of K4 and K4b, which are held here against the JAX XLA
reference, the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and ``jax.grad`` of
``groupnorm_silu_trainable`` (the ``_gn_silu_bwd`` VJP). NHWC on the JAX
side, NCHW in the port.

Tolerances: fp32 on both sides with sums in other orders (two-pass
variance in the port and the XLA reference; E[x²] − μ² in the Pallas
kernel and the VJP), outputs O(1): 1e-5 for the forward; 2e-4 for the
gradients, as ``tests/test_kernels.py`` holds the VJP (dscale and dbias sum
over batch and space).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from salun.kernels.groupnorm_silu import (groupnorm_silu as jax_gn_silu,
                                          groupnorm_silu_reference,
                                          groupnorm_silu_trainable)
from salun_torch.kernels import groupnorm_silu as gn

# (B, H, W, C, groups, eps)
SHAPES = [(2, 8, 8, 64, 32, 1e-5), (2, 5, 7, 96, 32, 1e-6),
          (3, 4, 4, 32, 32, 1e-6),   # gc = 1
          (2, 1, 1, 64, 32, 1e-5),   # H = W = 1
          (1, 3, 5, 12, 3, 1e-5)]


def _inputs(rng, b, h, w, c):
    x = (2.0 * rng.standard_normal((b, h, w, c)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_forward_matches_xla_reference(rng, shape):
    b, h, w, c, groups, eps = shape
    x, scale, bias, _ = _inputs(rng, b, h, w, c)
    want = groupnorm_silu_reference(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), groups=groups,
                                    eps=eps)
    y, mean, rstd = gn.groupnorm_silu(_nchw(x), torch.from_numpy(scale),
                                      torch.from_numpy(bias), groups, eps)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=0,
                               atol=1e-5)
    xg = x.reshape(b, h * w, groups, c // groups)
    np.testing.assert_allclose(mean.numpy(), xg.mean(axis=(1, 3)),
                               rtol=0, atol=1e-5)
    assert gn.groupnorm_silu.launches == 0  # plain on the CPU


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_plain_forward_matches_pallas_interpret(rng, eps):
    x, scale, bias, _ = _inputs(rng, 2, 8, 8, 64)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gn_silu(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias), groups=32, eps=eps)
    y = gn.groupnorm_silu(_nchw(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), 32, eps)[0]
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_vjp(rng, shape):
    b, h, w, c, groups, eps = shape
    x, scale, bias, dy = _inputs(rng, b, h, w, c)

    def loss(x, s, bb):
        return jnp.sum(groupnorm_silu_trainable(x, s, bb, groups, eps)
                       * jnp.asarray(dy))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    # K4b reads the forward's statistics; the VJP recomputes them as
    # E[x²] − μ², which at groups of two values (H = W = 1, gc = 2) differs
    # from the two-pass ones by far more than rounding. Fed the VJP's own
    # statistics, the two compute the same function.
    xg = jnp.asarray(x).reshape(b, h * w, groups, c // groups)
    mean = xg.mean(axis=(1, 3))
    rstd = jax.lax.rsqrt((xg * xg).mean(axis=(1, 3)) - mean * mean + eps)
    xt, st, bt = _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)
    dx, dscale, dbias = gn.groupnorm_silu_backward(
        _nchw(dy), xt, st, bt, torch.from_numpy(np.asarray(mean)),
        torch.from_numpy(np.asarray(rstd)), groups)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want[0]), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[1]), rtol=0,
                               atol=2e-4 * max(1.0, float(np.abs(
                                   np.asarray(want[1])).max())))
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[2]), rtol=0,
                               atol=2e-4 * max(1.0, float(np.abs(
                                   np.asarray(want[2])).max())))


def test_module_autograd_matches_torch_group_norm(rng):
    """The module's autograd function against torch's own autograd through
    ``F.group_norm`` → ``F.silu``: 1e-5 (the same fp32 math, other
    orders)."""
    x, scale, bias, dy = _inputs(rng, 2, 6, 6, 64)
    mod = gn.GroupNormSiLU(32, 64, eps=1e-6)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    xs = [_nchw(x).requires_grad_() for _ in range(2)]
    out = mod(xs[0])
    want = torch.nn.functional.silu(torch.nn.functional.group_norm(
        xs[1], 32, mod.weight, mod.bias, 1e-6))
    got = torch.autograd.grad(out, (xs[0], mod.weight, mod.bias),
                              _nchw(dy))
    ref = torch.autograd.grad(want, (xs[1], mod.weight, mod.bias),
                              _nchw(dy))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))
    assert set(dict(mod.named_parameters())) == {"weight", "bias"}


@pytest.mark.parametrize("bad", ["bf16", "strided", "groups", "shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, w, b = torch.zeros(2, 64, 4, 4), torch.ones(64), torch.zeros(64)
    groups = 32
    if bad == "bf16":
        x = x.bfloat16()
    elif bad == "strided":
        x = x.transpose(2, 3)
    elif bad == "groups":
        groups = 48
    else:
        w = torch.ones(32)
    with pytest.raises((TypeError, ValueError)):
        gn.groupnorm_silu(x, w, b, groups, 1e-5)


# ------------------------------------------------------------ the plan

# Every GroupNormSiLU input of the SD v1 U-Net ([C, H, W] at 64×64
# latents) and of the VAE at 512×512 (encoder and decoder)
UNET_CHW = [(320, 64, 64), (640, 64, 64), (960, 64, 64), (320, 32, 32),
            (640, 32, 32), (960, 32, 32), (1280, 32, 32), (1920, 32, 32),
            (640, 16, 16), (1280, 16, 16), (1920, 16, 16), (2560, 16, 16),
            (1280, 8, 8), (2560, 8, 8)]
VAE_512_CHW = [(128, 512, 512), (256, 512, 512)]
VAE_OTHER_CHW = [(512, 64, 64), (512, 128, 128), (256, 256, 256),
                 (512, 256, 256), (128, 256, 256)]


def _slices(plan, n, s):
    """The slices ``[lo, hi)`` of a slab of n values in planes of s, as
    ``geometry`` in ``groupnorm_silu.cu`` cuts them."""
    k, vec = plan.cluster, plan.path != "scalar"
    if vec and s < gn.UNIT and gn.UNIT % s == 0:  # whole planes
        start = [r * (n // s) // k * s for r in range(k + 1)]
    else:
        start = [(r * (n // 4) // k * 4 if vec else r * n // k)
                 for r in range(k + 1)]
    return list(zip(start[:-1], start[1:]))


@pytest.mark.parametrize("backward", [False, True], ids=["K4", "K4b"])
@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("chw", UNET_CHW, ids=str)
def test_plan_keeps_every_unet_slab_resident(chw, batch, backward):
    c, h, w = chw
    plan = gn._plan(batch, c, h * w, 32, backward)
    assert plan.path == "resident"
    assert plan.cap == plan.slice
    assert 1 <= plan.cluster <= 16
    assert plan.smem <= 232_448 - 1024 < gn.SMEM_MAX == 232_448


@pytest.mark.parametrize("backward", [False, True], ids=["K4", "K4b"])
@pytest.mark.parametrize("chw", VAE_512_CHW, ids=str)
def test_plan_streams_the_vae_512_slabs(chw, backward):
    c, h, w = chw
    plan = gn._plan(4, c, h * w, 32, backward)
    assert plan.path == "streamed"
    assert plan.cluster == 16
    assert 0 < plan.cap < plan.slice and plan.cap % 4 == 0
    assert plan.smem <= gn.SMEM_DYN
    # the resident share of the slice is kept, the rest read twice
    hbm = (2 * plan.slice + (plan.slice - plan.cap)) / plan.slice
    assert hbm <= 3.0


@pytest.mark.parametrize("backward", [False, True], ids=["K4", "K4b"])
@pytest.mark.parametrize("chw", VAE_OTHER_CHW, ids=str)
def test_plan_of_the_other_vae_slabs_fits(chw, backward):
    c, h, w = chw
    plan = gn._plan(4, c, h * w, 32, backward)
    assert plan.path in ("resident", "streamed")
    assert plan.smem <= gn.SMEM_DYN and plan.cluster <= 16
    slab_bytes = (8 if backward else 4) * (c // 32) * h * w
    if slab_bytes <= 16 * gn.SLICE_TARGET // 2:  # fits with room to spare
        assert plan.path == "resident"


@pytest.mark.parametrize("case", [
    (3, 6, 35, 3, True),      # S = 35
    (2, 32, 5000, 32, True),  # S = 50 x 100 is a multiple of 4: vector
    (2, 32, 1, 32, True),     # S = 1
    (2, 64, 256, 32, False),  # a pointer off a 16-byte boundary
], ids=str)
@pytest.mark.parametrize("backward", [False, True], ids=["K4", "K4b"])
def test_plan_scalar_path_for_ragged_or_unaligned(case, backward):
    b, c, s, groups, aligned = case
    plan = gn._plan(b, c, s, groups, backward, aligned)
    scalar = s % 4 != 0 or not aligned
    assert (plan.path == "scalar") == scalar
    if scalar:  # nothing resident: w and b, and K4b's per-unit sums
        assert plan.cap == 0
        affine = 8 * (c // groups)
        assert (plan.smem > affine) == backward and plan.smem >= affine
        assert plan.smem <= gn.SMEM_DYN


@pytest.mark.parametrize("backward", [False, True], ids=["K4", "K4b"])
@pytest.mark.parametrize("shape", [
    (8, 320, 4096, 32), (4, 960, 4096, 32), (4, 1920, 1024, 32),
    (4, 2560, 64, 32), (4, 2560, 256, 32), (4, 128, 262144, 32),
    (4, 256, 262144, 32), (2, 64, 16, 32),
    (3, 6, 35, 3), (2, 32, 5000, 32), (2, 32, 1, 32), (1, 1, 1, 1),
    (1, 96, 12, 32), (2, 64, 4, 1),
], ids=str)
def test_plan_slices_cover_the_slab_once(shape, backward):
    b, c, s, groups = shape
    plan = gn._plan(b, c, s, groups, backward)
    n = c // groups * s
    slices = _slices(plan, n, s)
    assert slices[0][0] == 0 and slices[-1][1] == n
    for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
        assert lo <= hi == lo2  # contiguous, no overlap
    for lo, hi in slices:
        assert hi - lo <= plan.slice
        if plan.path != "scalar":
            assert lo % 4 == 0
            if s < gn.UNIT and gn.UNIT % s == 0:
                assert lo % s == 0  # a packed unit holds whole planes
        if hi > lo:  # planes the slice touches fit K4b's scratch
            assert (hi - 1) // s - lo // s + 1 <= plan.pmax
    if plan.path == "resident":
        assert max(hi - lo for lo, hi in slices) <= plan.cap


@pytest.mark.parametrize("bad", ["dy_bf16", "mean_shape", "rstd_strided",
                                 "dy_shape"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, b = torch.zeros(2, 64, 4, 4), torch.ones(64), torch.zeros(64)
    dy = torch.zeros(2, 64, 4, 4)
    mean, rstd = torch.zeros(2, 32), torch.ones(2, 32)
    if bad == "dy_bf16":
        dy = dy.bfloat16()
    elif bad == "mean_shape":
        mean = torch.zeros(2, 16)
    elif bad == "rstd_strided":
        rstd = torch.ones(32, 2).t()
    else:
        dy = torch.zeros(2, 64, 16)
    with pytest.raises((TypeError, ValueError)):
        gn.groupnorm_silu_backward(dy, x, w, b, mean, rstd, 32)
