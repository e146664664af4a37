"""Fused masked-SGD update: kernel K1 (``salun_torch/csrc/masked_sgd.cu``).

Counterpart of ``salun/kernels/masked_update.py``. One launch updates the
whole model: parameters, momentum, grads, mask and θ₀ are flat 1-D buffers
(``salun_torch.core.masked_opt.FlatParams``), p and the momentum buffer are
updated in place (the Pallas kernel's ``input_output_aliases``), and lr is
read from a 1-element fp32 device tensor.

Per element, with ``keep = mask > 0``::

    buf' = (momentum * buf + g * mask) + wd * p
    p'   = p - lr * buf'
    (p, buf) <- keep ? (p', buf') : (θ₀, 0)

The sum follows the JAX main path (``masked_sgd_fused``,
``salun/core/masked_opt.py:145-148``); the Pallas kernel adds ``g·m + wd·p``
first, which differs from it by rounding. The CUDA kernel and
:func:`masked_sgd_update_reference` do the same rounded operations in the
same order, so they agree bitwise.

The mask is uint8 (SalUn's masks are hard 0/1): 25 bytes move per element.
"""

from __future__ import annotations

import ctypes

import torch


def masked_sgd_update_reference(p, buf, g, mask, theta0, lr, *,
                                momentum: float = 0.9, wd: float = 5e-4):
    """The plain PyTorch version: returns ``(new_p, new_buf)``.

    Only separate ``*`` and ``+`` (no ``alpha=``, ``addcmul`` or ``lerp``),
    so no step is fused into an FMA and the result equals the kernel's.
    """
    m = mask.to(torch.float32)
    b_new = (momentum * buf + g * m) + wd * p
    p_new = p - lr * b_new
    keep = m > 0
    return (torch.where(keep, p_new, theta0),
            torch.where(keep, b_new, torch.zeros_like(b_new)))


def _check(p, buf, g, mask, theta0, lr):
    n = p.numel()
    for name, t, dtype in (("p", p, torch.float32), ("buf", buf, torch.float32),
                           ("g", g, torch.float32), ("mask", mask, torch.uint8),
                           ("theta0", theta0, torch.float32),
                           ("lr", lr, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if name != "lr" and t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} elements, p has {n}")
    if lr.numel() != 1:
        raise ValueError("lr must be a 1-element tensor")


def masked_sgd_update(p, buf, g, mask, theta0, lr, *, momentum: float = 0.9,
                      wd: float = 5e-4) -> None:
    """Update ``p`` and ``buf`` in place.

    On a CUDA tensor this launches K1 (building it on first use) or
    raises; the plain version runs only for tensors on the CPU.
    """
    _check(p, buf, g, mask, theta0, lr)
    if p.device.type == "cpu":
        new_p, new_b = masked_sgd_update_reference(
            p, buf, g, mask, theta0, lr, momentum=momentum, wd=wd)
        p.copy_(new_p)
        buf.copy_(new_b)
        return
    if p.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {p.device}")
    fn = _kernel()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), buf.data_ptr(), g.data_ptr(), mask.data_ptr(),
                 theta0.data_ptr(), lr.data_ptr(), momentum, wd, p.numel(),
                 stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    masked_sgd_update.launches += 1


masked_sgd_update.launches = 0


def _kernel():
    from ._build import load

    fn = load("masked_sgd").salun_masked_sgd_update
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
