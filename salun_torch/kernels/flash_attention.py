"""Flash attention: kernels K2 (forward), K3a (dq) and K3b (dk, dv)
(``salun_torch/csrc/flash_attention.cu``).

Counterpart of ``salun/kernels/flash_attention.py``. Single head: q
``[B, Nq, D]``, k/v ``[B, Nk, D]``, fp32, contiguous (callers fold heads
into B). The kernels take any Nq, Nk ≥ 1 and any D that is a multiple of
8, up to 512; anything else raises.

Each wrapper runs its plain PyTorch version (``*_reference``) for tensors
on the CPU, and launches its kernel for tensors on a CUDA device (building
it on first use) or raises; it counts its launches in ``.launches``.

K3b cuts its walk over the query tiles into contiguous splits where one
block per k-tile would leave SMs idle (:func:`dkv_split_plan`); the
splits' partial dk, dv go to a workspace from PyTorch's caching allocator
and are summed in a fixed order inside the same entry point, which counts
as one launch.

:class:`FlashAttention` is the autograd function, as ``_fa_fwd_rule`` /
``_fa_bwd_rule``: K2 with the compact residual lse = m + log l saved
beside ``(q, k, v, o)``; backward δ = Σ_d do∘o in torch (outside the
Pallas kernels in JAX too), then K3a and K3b, through
:class:`FlashAttentionBackward`. Both work under ``torch.func`` (``grad``,
``vmap``, per-sample gradients as ``vmap(grad)``): their ``vmap`` rules
fold the vmapped dimension into the leading B·H dimension the kernels
take, so a vmapped call is still one launch of each kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

MAX_D_FWD = 512  # K2
MAX_D_BWD = 512  # K3a, K3b

# K3b's tiles by head width: (largest D, keys per block BK, queries per
# tile BQ), those of ``SALUN_DKV_CONFIG``'s instantiations in
# csrc/flash_attention.cu (its entry point refuses a split that is not a
# multiple of its BQ).
DKV_TILES = ((128, 64, 32), (256, 32, 32), (512, 16, 16))
# a split walks at least this many query tiles, so that the partials'
# extra traffic and the summing launch stay small beside the walk
DKV_MIN_SPLIT_TILES = 4


# ------------------------------------------------------- plain versions


def _scores(q, k, scale):
    return torch.matmul(q, k.transpose(1, 2)) * scale


def flash_attention_fwd_reference(q, k, v, scale):
    """Materialised fp32 scores, softmax, lse: ``(o, lse)``."""
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v) / l
    return o, (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, scale):
    """p = exp(s − lse) and ds = p∘(do·vᵀ − δ), recomputed from lse
    (``flash_attention.py:173-178``)."""
    p = torch.exp(_scores(q, k, scale) - lse.unsqueeze(-1))
    dp = torch.matmul(do, v.transpose(1, 2))
    return p, p * (dp - delta.unsqueeze(-1))


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale):
    """dq = scale · ds·k."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    return torch.matmul(ds, k) * scale


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale):
    """dk = scale · dsᵀ·q, dv = pᵀ·do."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    return (torch.matmul(ds.transpose(1, 2), q) * scale,
            torch.matmul(p.transpose(1, 2), do))


# ------------------------------------------------------------- wrappers


def _check(q, k, v, max_d=MAX_D_BWD, **more):
    """Device, dtype, shape, contiguity and alignment; returns
    ``(B, Nq, Nk, D)``."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, N, D]")
    b, nq, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, d) or v.shape != (b, nk, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if b < 1 or nq < 1 or nk < 1:
        raise ValueError("empty attention")
    if d % 8 or not 8 <= d <= max_d:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up "
                         f"to {max_d}")
    shapes = {"q": (b, nq, d), "k": (b, nk, d), "v": (b, nk, d),
              "do": (b, nq, d), "lse": (b, nq), "delta": (b, nq)}
    for name, t in {"q": q, "k": k, "v": v, **more}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu tensors, not "
                         f"{q.device}")
    return b, nq, nk, d


def _launch(fn, name, q, *args):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, scale: float, need_lse: bool = False):
    """K2: ``(o, lse)``, lse ``[B, Nq]`` fp32 when ``need_lse`` else None."""
    b, nq, nk, d = _check(q, k, v, MAX_D_FWD)
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_reference(q, k, v, scale)
        return o, (lse if need_lse else None)
    o = torch.empty_like(q)
    lse = (torch.empty((b, nq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    _launch(_kernel("salun_flash_fwd", 5), "K2", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), b, nq, nk,
            d, float(scale))
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float):
    """K3a: dq ``[B, Nq, D]``."""
    b, nq, nk, d = _check(q, k, v, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                scale)
    dq = torch.empty_like(q)
    _launch(_kernel("salun_flash_bwd_dq", 7), "K3a", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, nq, nk, d, float(scale))
    flash_attention_bwd_dq.launches += 1
    return dq


def dkv_tiles(d: int):
    """K3b's ``(BK, BQ)`` at head width ``d``."""
    for max_d, bk, bq in DKV_TILES:
        if d <= max_d:
            return bk, bq
    raise ValueError(f"head dim {d}: K3b takes D up to {MAX_D_BWD}")


def dkv_split_plan(batch: int, nq: int, nk: int, d: int,
                   resident_blocks: int):
    """How K3b cuts its query walk: ``(splits, rows_per_split)``.

    One block per (batch, k-tile) walks all ⌈nq/BQ⌉ query tiles. Where
    those blocks are fewer than the card holds at once
    (``resident_blocks``: SMs × K3b's blocks per SM), each walk is cut into
    ``splits`` contiguous ranges of ``rows_per_split`` query rows (a
    multiple of BQ; the last range ends at nq), one block each, so that
    the grid fills the card in one wave; each range holds at least
    ``DKV_MIN_SPLIT_TILES`` tiles. Split s covers rows
    ``[s · rows_per_split, min(nq, (s + 1) · rows_per_split))``.
    """
    bk, bq = dkv_tiles(d)
    n_qt = math.ceil(nq / bq)
    blocks = batch * math.ceil(nk / bk)
    splits = max(1, min(n_qt // DKV_MIN_SPLIT_TILES,
                        resident_blocks // blocks))
    per = math.ceil(n_qt / splits)
    return math.ceil(n_qt / per), per * bq


_resident = {}


def dkv_resident_blocks(device, d: int) -> int:
    """SMs × K3b's resident blocks per SM at head width ``d`` on
    ``device`` (registers and shared memory, from the CUDA runtime)."""
    key = (device.index, d)
    if key not in _resident:
        fn = getattr(_library(), "salun_flash_bwd_dkv_blocks_per_sm")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        with torch.cuda.device(device):
            per_sm = fn(d)
        if per_sm < 1:
            raise RuntimeError(f"K3b cannot run at head dim {d}: "
                               f"{per_sm} blocks per SM")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[key] = sms * per_sm
    return _resident[key]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """K3b: ``(dk, dv)``, each ``[B, Nk, D]``."""
    b, nq, nk, d = _check(q, k, v, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    splits, rows = dkv_split_plan(b, nq, nk, d,
                                  dkv_resident_blocks(q.device, d))
    # freed on return, but the caching allocator hands it out again only
    # to work queued behind this launch on the same stream
    work = (torch.empty((2, splits, b, nk, d), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    _launch(_kernel("salun_flash_bwd_dkv", 9, 5), "K3b", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(work), b,
            nq, nk, d, rows, float(scale))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def _library():
    from ._build import load

    return load("flash_attention")


def _kernel(symbol: str, n_ptrs: int, n_ints: int = 4):
    """The C entry point ``symbol``: ``n_ptrs`` pointers, then ``n_ints``
    ints (batch, nq, nk, d and, for K3b, rows_per_split), scale (float)
    and the stream."""
    fn = getattr(_library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------- autograd


def _fold(n: int, in_dims, tensors):
    """Each tensor with its vmapped dimension (``None``: not vmapped, so
    expanded) moved to the front and merged into the next one: [n, B, …]
    → [n·B, …], contiguous."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(n * t.shape[1], *t.shape[2:]).contiguous())
    return out


def _unfold(n: int, tensors):
    return tuple(t.reshape(n, t.shape[0] // n, *t.shape[1:])
                 for t in tensors)


class FlashAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale)·v with K2 forward and K3a/K3b backward;
    ``apply(q, k, v, scale)`` returns ``(o, lse)``, lse without
    gradient."""

    @staticmethod
    def forward(q, k, v, scale):
        return flash_attention_fwd(q, k, v, scale, need_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(q, k, v, o, lse,
                                                  do.contiguous(), ctx.scale)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale):
        n = info.batch_size
        out = FlashAttention.apply(*_fold(n, in_dims[:3], (q, k, v)), scale)
        return _unfold(n, out), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """``(dq, dk, dv)`` of :class:`FlashAttention` from its residuals and
    do: δ = Σ_d do∘o, then K3a and K3b. First-order only."""

    @staticmethod
    def forward(q, k, v, o, lse, do, scale):
        delta = (do * o).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, scale):
        n = info.batch_size
        out = FlashAttentionBackward.apply(
            *_fold(n, in_dims[:6], (q, k, v, o, lse, do)), scale)
        return _unfold(n, out), (0, 0, 0)
