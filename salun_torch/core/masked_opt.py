"""Saliency-masked SGD and Adam over flat parameter buffers, the
grad-mask-only SGD, the grad-mask pieces of the DDPM optimizer
(``clip_by_global_norm``, ``mask_grads``) and the optimizer factory
:func:`build_optimizer`.

Counterpart of ``salun/core/masked_opt.py``. SalUn's update rule
(reference Classification/unlearn/RL.py:11-34): masked grads, the SGD step,
masked-out weights restored to θ₀ and their momentum zeroed.

:class:`FlatParams` makes a module's parameters views into one flat fp32
buffer and their ``.grad``s views into one flat grad buffer, so that
:class:`MaskedSGD` updates the whole model with one launch of kernel K1
per step (``salun_torch.kernels.masked_update``). :class:`GradMaskSGD` is
``optax.chain(mask_grads(mask), sgd)``: only the gradient is masked, so
weight decay and momentum still move masked-out weights; it is not K1's
rule and never launches it. :class:`Adam` is ``optax.adam``, grad-masked
or fully SalUn-masked (θ₀ pinned, both moments masked), in plain tensor
operations: the JAX package has no fused kernel for it. Grads are zeroed in
place, never set to ``None``, so autograd accumulates into the flat buffer;
each step checks that it still does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from salun_torch.kernels.masked_update import masked_sgd_update


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ over tensors of Σ x²), as ``optax.global_norm``."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> list:
    """``optax.clip_by_global_norm``: the grads unchanged while the global
    norm is below ``max_norm``, else ``(g / norm) * max_norm``.

    Not ``torch.nn.utils.clip_grad_norm_``, which scales every grad by
    ``max_norm / (norm + 1e-6)`` clamped at 1. The choice is made on the
    device (``torch.where``), with no host sync.
    """
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def mask_grads(grads: Sequence[torch.Tensor],
               mask: Sequence[torch.Tensor]) -> list:
    """``grads *= mask`` (``salun/core/masked_opt.py:44-57``), the grad
    mask of the DDPM and SD workloads."""
    return [g * m.to(g.dtype) for g, m in zip(grads, mask, strict=True)]


class FlatParams:
    """One flat fp32 buffer behind ``params`` (in the given order)."""

    def __init__(self, params: Sequence[nn.Parameter]):
        self.params = list(params)
        if not self.params:
            raise ValueError("no parameters")
        device = self.params[0].device
        sizes = [p.numel() for p in self.params]
        n = sum(sizes)
        self.flat = torch.empty(n, dtype=torch.float32, device=device)
        self.grad = torch.zeros(n, dtype=torch.float32, device=device)
        offsets = np.cumsum([0] + sizes).tolist()
        with torch.no_grad():
            for p, lo, hi in zip(self.params, offsets, offsets[1:]):
                if p.dtype != torch.float32 or p.device != device:
                    raise TypeError("flat buffers hold fp32 parameters of "
                                    "one device")
                self.flat[lo:hi].copy_(p.reshape(-1))
                p.data = self.flat[lo:hi].view_as(p)
                p.grad = self.grad[lo:hi].view_as(p)
        self._grad_ptrs = [p.grad.data_ptr() for p in self.params]

    def zero_grad(self) -> None:
        self.grad.zero_()

    def check_grads(self) -> None:
        """Raise unless every ``.grad`` still lies in the flat buffer."""
        for p, ptr in zip(self.params, self._grad_ptrs):
            if p.grad is None or p.grad.data_ptr() != ptr:
                raise RuntimeError(
                    "a parameter's .grad no longer lies in the flat grad "
                    "buffer (was it set to None or replaced?)")

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Concatenate per-parameter tensors (same order and shapes) into
        one flat fp32 tensor on the buffer's device."""
        if len(tensors) != len(self.params):
            raise ValueError(f"{len(tensors)} tensors for "
                             f"{len(self.params)} parameters")
        for t, p in zip(tensors, self.params):
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(t.shape)} != {tuple(p.shape)}")
        return torch.cat([t.reshape(-1).to(device=self.flat.device,
                                           dtype=torch.float32)
                          for t in tensors])


class _FlatSGDBase:
    def __init__(self, flat: FlatParams, learning_rate, momentum: float = 0.9,
                 weight_decay: float = 5e-4):
        self.flat = flat
        self.sched = (learning_rate if callable(learning_rate)
                      else (lambda step, v=learning_rate: v))
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.trace = torch.zeros_like(flat.flat)
        self.count = 0
        # lr as a 1-element fp32 device tensor: the kernel reads it there,
        # and it is rewritten only when the schedule changes it.
        self.lr = torch.zeros(1, dtype=torch.float32, device=flat.flat.device)
        self._lr_value = None

    def zero_grad(self) -> None:
        self.flat.zero_grad()

    def _set_lr(self) -> None:
        v = float(np.float32(self.sched(self.count)))
        if v != self._lr_value:
            self.lr.fill_(v)
            self._lr_value = v


class MaskedSGD(_FlatSGDBase):
    """``masked_sgd_fused`` (masked_opt.py:115-166) as one K1 launch a step.

    ``mask`` is a flat 0/1 tensor (stored as uint8) and ``theta0`` a flat
    fp32 tensor, both in the order of ``flat``.
    """

    def __init__(self, flat: FlatParams, learning_rate, momentum: float = 0.9,
                 weight_decay: float = 5e-4, *, mask: torch.Tensor,
                 theta0: torch.Tensor):
        super().__init__(flat, learning_rate, momentum, weight_decay)
        n = flat.flat.numel()
        if mask.numel() != n or theta0.numel() != n:
            raise ValueError("mask and theta0 must cover every parameter")
        mask = mask.reshape(-1).to(flat.flat.device)
        if mask.dtype != torch.uint8:
            if not bool(((mask == 0) | (mask == 1)).all()):
                raise ValueError("SalUn masks are 0/1")
            mask = mask.to(torch.uint8)
        self.mask = mask.contiguous().clone()
        self.theta0 = theta0.reshape(-1).to(
            device=flat.flat.device, dtype=torch.float32).contiguous().clone()

    @torch.no_grad()
    def step(self) -> None:
        self.flat.check_grads()
        self._set_lr()
        masked_sgd_update(self.flat.flat, self.trace, self.flat.grad,
                          self.mask, self.theta0, self.lr,
                          momentum=self.momentum, wd=self.weight_decay)
        self.count += 1


class SGD(_FlatSGDBase):
    """torch.optim.SGD semantics (masked_opt.py:169-185): the optax chain
    ``add_decayed_weights → trace → scale_by_learning_rate``, i.e.
    ``buf = (g + wd·p) + μ·buf; p = p - lr·buf``, for unmasked runs."""

    def _grad(self) -> torch.Tensor:
        return self.flat.grad

    @torch.no_grad()
    def step(self) -> None:
        self.flat.check_grads()
        self._set_lr()
        p, buf = self.flat.flat, self.trace
        d = self._grad() + self.weight_decay * p
        buf.copy_(d + self.momentum * buf)
        p.copy_(p - self.lr * buf)
        self.count += 1


class GradMaskSGD(SGD):
    """``optax.chain(mask_grads(mask), sgd)`` (``salun/core/masked_opt.py:
    44``, ``:169``): :class:`SGD` on ``g·mask``. ``mask`` is a flat 0/1
    tensor in the order of ``flat``."""

    def __init__(self, flat: FlatParams, learning_rate, momentum: float = 0.9,
                 weight_decay: float = 5e-4, *, mask: torch.Tensor):
        super().__init__(flat, learning_rate, momentum, weight_decay)
        if mask.numel() != flat.flat.numel():
            raise ValueError("mask must cover every parameter")
        self.mask = mask.reshape(-1).to(device=flat.flat.device,
                                        dtype=torch.float32).clone()

    def _grad(self) -> torch.Tensor:
        return self.flat.grad * self.mask


class Adam:
    """``optax.adam(lr)`` (β 0.9/0.999, eps 1e-8, optax's bias correction)
    over flat buffers, in three forms, as ``salun/core/masked_opt.py:
    188-215`` builds them:

    - no ``mask``: plain Adam;
    - ``mask`` alone: ``optax.chain(mask_grads(mask), adam)``;
    - ``mask`` and ``theta0``: ``masked(adam, mask, theta0)``
      (``:66-105``): grads × mask, the Adam step, both moments × mask
      after it, masked-out weights written to θ₀ exactly (JAX adds
      ``θ₀ − p`` to p, within one rounding of θ₀).

    Each fp32 operation is optax's, in its order; the bias corrections
    ``1 − βᵗ`` are fp32 on the host. ``mask`` and ``theta0`` are flat
    tensors in the order of ``flat``.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults

    def __init__(self, flat: FlatParams, learning_rate, *, mask=None,
                 theta0=None):
        self.flat = flat
        self.sched = (learning_rate if callable(learning_rate)
                      else (lambda step, v=learning_rate: v))
        self.b1, self.b2 = np.float32(self.B1), np.float32(self.B2)
        # optax folds 1 − β in double, then rounds it to fp32
        self.c1, self.c2 = np.float32(1 - self.B1), np.float32(1 - self.B2)
        self.eps = np.float32(self.EPS)
        n, device = flat.flat.numel(), flat.flat.device
        self.mu = torch.zeros_like(flat.flat)
        self.nu = torch.zeros_like(flat.flat)
        self.count = 0
        self.mask = self.theta0 = None
        if mask is not None:
            if mask.numel() != n:
                raise ValueError("mask must cover every parameter")
            self.mask = mask.reshape(-1).to(device=device,
                                            dtype=torch.float32).clone()
            if theta0 is not None:
                if theta0.numel() != n:
                    raise ValueError("theta0 must cover every parameter")
                self.theta0 = theta0.reshape(-1).to(
                    device=device, dtype=torch.float32).clone()

    def zero_grad(self) -> None:
        self.flat.zero_grad()

    @torch.no_grad()
    def step(self) -> None:
        self.flat.check_grads()
        g = self.flat.grad
        if self.mask is not None:
            g = g * self.mask
        lr = np.float32(-self.sched(self.count))
        self.mu.copy_(g * self.c1 + self.mu * self.b1)
        self.nu.copy_((g * g) * self.c2 + self.nu * self.b2)
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1) - self.b1 ** t)
        bc2 = float(np.float32(1) - self.b2 ** t)
        u = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + self.eps)
        p = self.flat.flat
        if self.theta0 is None:
            p.copy_(p + u * lr)
            return
        keep = self.mask > 0
        p.copy_(torch.where(keep, p + u * lr, self.theta0))
        self.mu.mul_(self.mask)
        self.nu.mul_(self.mask)


def build_optimizer(flat: FlatParams, learning_rate, momentum: float = 0.9,
                    weight_decay: float = 5e-4, mask=None, theta0=None,
                    kind: str = "sgd"):
    """The optimizer factory (``salun/core/masked_opt.py:188-215``) over
    ``flat``. ``mask`` and ``theta0`` → the full SalUn masked optimizer
    (:class:`MaskedSGD` on K1, or masked :class:`Adam`); ``mask`` alone →
    grads masked only (:class:`GradMaskSGD`, or :class:`Adam` on masked
    grads); no mask → :class:`SGD` or :class:`Adam`."""
    if kind == "sgd":
        if mask is None:
            return SGD(flat, learning_rate, momentum, weight_decay)
        if theta0 is None:
            return GradMaskSGD(flat, learning_rate, momentum, weight_decay,
                               mask=mask)
        return MaskedSGD(flat, learning_rate, momentum, weight_decay,
                         mask=mask, theta0=theta0)
    if kind == "adam":
        return Adam(flat, learning_rate, mask=mask,
                    theta0=None if mask is None else theta0)
    raise ValueError(f"unknown optimizer kind {kind!r}")
