"""Fused GroupNorm + SiLU: kernels K4 (forward) and K4b (backward)
(``salun_torch/csrc/groupnorm_silu.cu``).

Counterpart of ``salun/kernels/groupnorm_silu.py``: ``groupnorm_silu``
(the Pallas ``_gn_silu_kernel``) and the VJP ``_gn_silu_bwd`` of
``groupnorm_silu_trainable``. Layout NCHW (any ``[B, C, *spatial]``), fp32,
contiguous; statistics in fp32 per (batch, group), y = silu((x − μ)·rstd·w
+ b) with rstd = 1/√(σ² + eps). The forward also returns μ and rstd
``[B, G]``, the residuals the backward reads (JAX recomputes them from x).

Each wrapper runs its plain PyTorch version (``*_reference``) for tensors
on the CPU, and launches its kernel for tensors on a CUDA device (building
it on first use) or raises; it counts its launches in ``.launches``. The
kernels sum in a fixed order (a second pass, no atomics), so dscale and
dbias are deterministic.

:class:`GroupNormSiLU` is the module: ``weight`` and ``bias`` as
``nn.GroupNorm`` has them, so CompVis state dicts load unchanged.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

# Values of one plane (one batch row, one channel) that one warp reduces;
# the kernels take any chunk ≤ the plane, a multiple of 4 when smaller.
CHUNK = 4096


# ------------------------------------------------------- plain versions


def _bcast(v, x):
    """A per-channel [C] vector shaped to broadcast over x [B, C, ...]."""
    return v.reshape(1, -1, *([1] * (x.dim() - 2)))


def groupnorm_stats_reference(x, groups: int, eps: float):
    """fp32 mean and rstd ``[B, G]``, two-pass variance (as
    ``groupnorm_silu_reference`` in JAX)."""
    xg = x.reshape(x.shape[0], groups, -1).to(torch.float32)
    mean = xg.mean(-1)
    var = (xg - mean.unsqueeze(-1)).square().mean(-1)
    return mean, torch.rsqrt(var + eps)


def _xhat(x, mean, rstd, groups):
    xg = x.reshape(x.shape[0], groups, -1)
    return ((xg - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)).reshape(x.shape)


def groupnorm_silu_reference(x, weight, bias, groups: int, eps: float):
    """``(y, mean, rstd)``: y = silu(x̂·w + b)."""
    mean, rstd = groupnorm_stats_reference(x, groups, eps)
    z = _xhat(x, mean, rstd, groups) * _bcast(weight, x) + _bcast(bias, x)
    return z * torch.sigmoid(z), mean, rstd


def groupnorm_silu_backward_reference(dy, x, weight, bias, mean, rstd,
                                      groups: int):
    """``(dx, dweight, dbias)`` as ``_gn_silu_bwd`` (``:144-169``), from the
    forward's mean and rstd."""
    xhat = _xhat(x, mean, rstd, groups)
    w = _bcast(weight, x)
    z = xhat * w + _bcast(bias, x)
    sig = torch.sigmoid(z)
    dz = dy * sig * (1.0 + z * (1.0 - sig))
    red = [0] + list(range(2, x.dim()))
    dbias = dz.sum(red)
    dweight = (dz * xhat).sum(red)
    b = x.shape[0]
    dxhat = (dz * w).reshape(b, groups, -1)
    xh = xhat.reshape(b, groups, -1)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xh).mean(-1, keepdim=True)
    dx = rstd.unsqueeze(-1) * (dxhat - m1 - xh * m2)
    return dx.reshape(x.shape), dweight, dbias


# ------------------------------------------------------------- wrappers


def _check(x, weight, bias, groups, **more):
    """Device, dtype, shape and contiguity; returns ``(B, C, S)``."""
    if x.dim() < 2:
        raise ValueError(f"x must be [B, C, ...], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    s = x[0, 0].numel()
    if b < 1 or c < 1 or s < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    shapes = {"x": tuple(x.shape), "weight": (c,), "bias": (c,),
              "dy": tuple(x.shape), "mean": (b, groups), "rstd": (b, groups)}
    for name, t in {"x": x, "weight": weight, "bias": bias, **more}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 runs on cuda or cpu tensors, not {x.device}")
    return b, c, s


def _units(b, c, s):
    chunk = min(s, CHUNK)
    return chunk, b * c * (-(-s // chunk))


def _launch(fn, name, x, *args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def groupnorm_silu(x, weight, bias, groups: int = 32, eps: float = 1e-6):
    """K4: ``(y, mean, rstd)``, y like x, mean/rstd ``[B, G]`` fp32."""
    b, c, s = _check(x, weight, bias, groups)
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, weight, bias, groups, eps)
    chunk, units = _units(b, c, s)
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    part = torch.empty(3 * units, dtype=torch.float32, device=x.device)
    _launch(_kernel("salun_gn_silu_fwd"), "K4", x, x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), b, c, s,
            groups, chunk, float(eps))
    groupnorm_silu.launches += 1
    return y, mean, rstd


def groupnorm_silu_backward(dy, x, weight, bias, mean, rstd,
                            groups: int = 32):
    """K4b: ``(dx, dweight, dbias)``."""
    b, c, s = _check(x, weight, bias, groups, dy=dy, mean=mean, rstd=rstd)
    if x.device.type == "cpu":
        return groupnorm_silu_backward_reference(dy, x, weight, bias, mean,
                                                 rstd, groups)
    chunk, units = _units(b, c, s)
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    part = torch.empty(2 * units, dtype=torch.float32, device=x.device)
    m12 = torch.empty(2 * b * groups, dtype=torch.float32, device=x.device)
    _launch(_kernel("salun_gn_silu_bwd"), "K4b", x, dy.data_ptr(),
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            db.data_ptr(), part.data_ptr(), m12.data_ptr(), b, c, s, groups,
            chunk)
    groupnorm_silu_backward.launches += 1
    return dx, dw, db


groupnorm_silu.launches = 0
groupnorm_silu_backward.launches = 0

_ARGS = {  # pointers, then batch, C, hw, groups, chunk, (eps)
    "salun_gn_silu_fwd": [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float],
    "salun_gn_silu_bwd": [ctypes.c_void_p] * 11 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong],
}


def _kernel(symbol: str):
    from ._build import load

    fn = getattr(load("groupnorm_silu"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[symbol] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------- autograd


class GroupNormSiLUFunction(torch.autograd.Function):
    """silu(groupnorm(x)·w + b) with K4 forward and K4b backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y, mean, rstd = groupnorm_silu(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = groupnorm_silu_backward(dy.contiguous(), x, weight,
                                             bias, mean, rstd, ctx.groups)
        return dx, dw, db, None, None


class GroupNormSiLU(nn.Module):
    """``nn.GroupNorm`` followed by SiLU, in one kernel each way.

    Parameters ``weight`` (ones) and ``bias`` (zeros) as ``nn.GroupNorm``'s,
    so a checkpoint's ``…norm1.weight`` loads into it unchanged.
    """

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        x = x.contiguous()
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return GroupNormSiLUFunction.apply(x, self.weight, self.bias,
                                               self.num_groups, self.eps)
        return groupnorm_silu(x, self.weight, self.bias, self.num_groups,
                              self.eps)[0]

    def extra_repr(self) -> str:
        return f"{self.num_groups}, {self.num_channels}, eps={self.eps}"
