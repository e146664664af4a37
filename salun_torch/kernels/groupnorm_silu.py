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
it on first use) or raises; it counts its launches in ``.launches``. Each
kernel is one launch of a thread-block cluster per (batch, group) slab
(K4b adds a small launch that sums dscale and dbias); :func:`_plan` picks
the cluster and how much of a slab stays in shared memory. Every sum is
taken in a fixed order (no atomics), so every output is bitwise equal run
to run.

:class:`GroupNormSiLU` is the module: ``weight`` and ``bias`` as
``nn.GroupNorm`` has them, so CompVis state dicts load unchanged.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch import nn

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


# ------------------------------------------------------------- the plan

# An H100 block's shared memory, and the part of it the kernels give to
# dynamic arrays (the rest holds their static ones); kept equal to
# SMEM_DYN_MAX in groupnorm_silu.cu.
SMEM_MAX = 232_448
SMEM_DYN = SMEM_MAX - 1024
# The constants below were chosen by timing on an H100
# (tools/time_groupnorm_silu.py --slice-target, --units-per-warp, ...).
# Bytes of shared memory a block's slice aims at (48, 72 and 96 KiB tried).
SLICE_TARGET = 72 * 1024
# Shared memory of a block on the streamed path, its resident share: more
# blocks an SM beat a larger resident share (48 KiB against 96 and 220).
STREAM_SMEM = 48 * 1024
MAX_CLUSTER = 16  # blocks a cluster; above 8 non-portable
# Blocks a launch aims at (132, 256 and 396 tried): 128 slabs (bs 4, 32
# groups) then take clusters of 2, which the card holds in one wave.
MIN_BLOCKS = 256
UNIT = 512        # values of a warp's unit (UNIT in groupnorm_silu.cu)
WARPS = 8         # warps a block (THREADS / 32 in groupnorm_silu.cu)
# Units a warp aims at (1, 2 and 4 tried): a warp waits out its units'
# loads in turn, so a slice of more units is cut over more blocks.
UNITS_PER_WARP = 4


class Plan(NamedTuple):
    """How K4 or K4b covers the slabs of one shape (see ``_plan``)."""
    path: str     # "resident", "streamed" or "scalar"
    cluster: int  # blocks a (batch, group) slab, one cluster
    slice: int    # values of the largest slice a block owns
    cap: int      # values of a slice kept in shared memory
    smem: int     # bytes of dynamic shared memory a block
    pmax: int     # planes a slice can touch (K4b's scratch stride)


@functools.lru_cache(maxsize=None)
def _plan(b: int, c: int, s: int, groups: int, backward: bool,
          aligned: bool = True) -> Plan:
    """The launch plan for x ``[b, c, s]`` in ``groups`` groups.

    A (batch, group) slab of n = (c / groups)·s values is cut into
    ``cluster`` slices, one block each, all in one thread-block cluster:
    float4-aligned near-equal parts, or whole planes where s divides
    ``UNIT`` (a unit then packs planes). ``cluster`` is the first of 1, 2,
    3, 4, 8, 16 (sizes that pack the GPCs well) from the one that fills
    ``MIN_BLOCKS`` blocks (down to two units a slice) whose slice fits
    ``SLICE_TARGET`` bytes of shared memory (x; x and dy for the backward)
    and ``UNITS_PER_WARP`` units a warp. Paths: ``resident``, the whole
    slice lies in shared memory, so HBM sees x once; ``streamed``, only its
    first ``cap`` values do (``STREAM_SMEM`` bytes a block), the rest is
    read again; ``scalar`` (s % 4 ≠ 0 or a tensor not 16-byte aligned),
    nothing is kept, scalar loads. ``smem`` adds w and b of a slab's
    channels and the backward's 12 bytes per entry of a slice. Stays in
    Python so that the CPU tests reach it; ``groupnorm_silu.cu`` checks
    what it is given and computes the same ``smem`` and ``pmax``.
    """
    gc = c // groups
    n = gc * s
    vec = aligned and s % 4 == 0
    packed = vec and s < UNIT and UNIT % s == 0  # units of whole planes
    per = 8 if backward else 4  # bytes of shared memory a resident value

    def cut(k):
        """(largest slice, pmax, most units a slice, table bytes) at k
        blocks a slab."""
        if packed:
            most = -(-gc // k) * s
        else:
            most = -(-(n // 4) // k) * 4 if vec else -(-n // k)
        pmax = -(-most // s) + 1
        bound = -(-most // UNIT) + pmax  # units, or planes where packed
        units = -(-most // UNIT) if packed else bound
        return most, pmax, units, 12 * bound if backward else 0

    def fits(k):
        most, _, units, table = cut(k)
        return (per * most + table <= SLICE_TARGET
                and units <= UNITS_PER_WARP * WARPS)

    # enough blocks to fill the card, none under two units
    top = min(MAX_CLUSTER, gc) if packed else MAX_CLUSTER
    least = min(top, -(-MIN_BLOCKS // (b * groups)),
                max(1, n // (2 * UNIT)))
    # sizes whose clusters pack the GPCs well (90-94% of the blocks
    # resident at once, cudaOccupancyMaxActiveClusters on the H100)
    ks = [k for k in (1, 2, 3, 4, 8, 16) if least <= k <= top] or [top]
    k = next((k for k in ks if fits(k)), ks[-1])
    most, pmax, _, table = cut(k)
    table += 8 * gc  # w and b of the slab's channels
    if not vec:
        path, cap = "scalar", 0
    elif per * most + table <= SMEM_DYN:
        path, cap = "resident", most
    else:
        path, cap = "streamed", (min(STREAM_SMEM, SMEM_DYN) - table) // per
        cap = cap // 4 * 4
    if table > SMEM_DYN or cap < 0:
        raise ValueError(f"K4/K4b take no slab of {c // groups} planes "
                         f"of {s} values")
    return Plan(path, k, most, cap, per * cap + table, pmax)


# ------------------------------------------------------------- wrappers


def _expect(name, t, device, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(x, weight, bias, groups, dy=None, mean=None, rstd=None):
    """Device, dtype, shape and contiguity; returns ``(B, C, S)``."""
    if x.dim() < 2:
        raise ValueError(f"x must be [B, C, ...], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    if b < 1 or c < 1 or s < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    dev = x.device
    _expect("x", x, dev, x.shape)
    _expect("weight", weight, dev, (c,))
    _expect("bias", bias, dev, (c,))
    if dy is not None:
        _expect("dy", dy, dev, x.shape)
        _expect("mean", mean, dev, (b, groups))
        _expect("rstd", rstd, dev, (b, groups))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 runs on cuda or cpu tensors, not {dev}")
    return b, c, s


def _launch(symbol, name, x, *args):
    fn = _fns.get(symbol) or _kernel(symbol)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def groupnorm_silu(x, weight, bias, groups: int = 32, eps: float = 1e-6):
    """K4: ``(y, mean, rstd)``, y like x, mean/rstd ``[B, G]`` fp32 (two
    views of one ``[2, B, G]`` tensor on the card)."""
    b, c, s = _check(x, weight, bias, groups)
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, weight, bias, groups, eps)
    plan = _plan(b, c, s, groups, False, x.data_ptr() % 16 == 0)
    y = torch.empty_like(x)
    stats = torch.empty((2, b, groups), dtype=torch.float32, device=x.device)
    _launch("salun_gn_silu_fwd", "K4", x, x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), stats.data_ptr(), b, c, s, groups,
            plan.cluster, plan.cap, plan.path != "scalar", float(eps))
    groupnorm_silu.launches += 1
    return y, stats[0], stats[1]


def groupnorm_silu_backward(dy, x, weight, bias, mean, rstd,
                            groups: int = 32):
    """K4b: ``(dx, dweight, dbias)`` (dweight and dbias two views of one
    buffer on the card)."""
    b, c, s = _check(x, weight, bias, groups, dy=dy, mean=mean, rstd=rstd)
    if x.device.type == "cpu":
        return groupnorm_silu_backward_reference(dy, x, weight, bias, mean,
                                                 rstd, groups)
    plan = _plan(b, c, s, groups, True,
                 (x.data_ptr() | dy.data_ptr()) % 16 == 0)
    dx = torch.empty_like(x)
    # dweight, dbias, then the per-(slab, block, plane) scratch
    buf = torch.empty(2 * c + 2 * b * groups * plan.cluster * plan.pmax,
                      dtype=torch.float32, device=x.device)
    _launch("salun_gn_silu_bwd", "K4b", x, dy.data_ptr(), x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), buf.data_ptr(),
            buf.data_ptr() + 8 * c, b, c, s, groups, plan.cluster, plan.cap,
            plan.pmax, plan.path != "scalar")
    groupnorm_silu_backward.launches += 1
    return dx, buf[:c], buf[c:2 * c]


groupnorm_silu.launches = 0
groupnorm_silu_backward.launches = 0

_ARGS = {  # pointers, then batch, C, S, groups, cluster, cap, (pmax), vec
    "salun_gn_silu_fwd": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float],
    "salun_gn_silu_bwd": [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int],
}
_fns: dict = {}  # symbol → ctypes function, argtypes set


def _library():
    from ._build import load

    return load("groupnorm_silu")


def _kernel(symbol: str):
    fn = getattr(_library(), symbol)
    fn.argtypes = _ARGS[symbol] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fns[symbol] = fn
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
