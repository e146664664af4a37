"""The work a configuration's forward needs, counted from its shapes.

A forward of a reference model runs on the ``meta`` device (shapes only)
while hooks note every convolution and linear layer and the reference's
attention and GroupNorm → SiLU calls. A multiply-add is 2 FLOPs.

- convolution: 2·N·C_out·H_out·W_out·(C_in/groups)·k_h·k_w;
- linear: 2·rows·in·out;
- attention over [B, Nq, Nk, D]: 4·B·Nq·Nk·D forward (q·kᵀ and p·v),
  8·B·Nq·Nk·D backward; its bytes read q, k, v once and write o once
  (backward: read q, k, v, o, dO, write dq, dk, dv), 4 bytes a value;
- GroupNorm → SiLU: bytes only, x read and y written (8 B a value),
  backward x and dY read and dX written (12 B a value).

A forward with a gradient costs its FLOPs again twice in the backward
(the input's and the weight's gradients); a forward without one counts
once. Recomputation for memory (checkpointing) is not counted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from benchmark_h100.reference import ops

FP32 = 4

# one NVIDIA H100 SXM (the data sheet's dense rates, 700 W)
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def conv2d_flops(n, cin, cout, h_out, w_out, kh, kw, groups=1) -> int:
    return 2 * n * cout * h_out * w_out * (cin // groups) * kh * kw


def linear_flops(rows, fan_in, fan_out) -> int:
    return 2 * rows * fan_in * fan_out


def attention_flops(b, nq, nk, d, backward=False) -> int:
    return (8 if backward else 4) * b * nq * nk * d


def attention_bytes(b, nq, nk, d, backward=False) -> int:
    q, kv = b * nq * d, b * nk * d
    if backward:  # read q, k, v, o, dO; write dq, dk, dv
        return FP32 * (3 * q + 2 * kv + q + 2 * kv)
    return FP32 * (2 * q + 2 * kv)


def gn_silu_bytes(numel, backward=False) -> int:
    return FP32 * (3 if backward else 2) * numel


@dataclass
class Work:
    """Counted work: FLOPs in all, and the attention and GroupNorm → SiLU
    calls that run on the fused kernels, each with its least time."""

    flops: float = 0.0
    attention: list = field(default_factory=list)   # (flops, bytes)
    gn_silu: list = field(default_factory=list)     # (flops, bytes)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops,
                    self.attention + other.attention,
                    self.gn_silu + other.gn_silu)

    def times(self, n: int) -> "Work":
        return Work(self.flops * n, self.attention * n, self.gn_silu * n)

    def least_seconds(self, which: str) -> float:
        """Σ over the calls of max(FLOPs / peak, bytes / bandwidth)."""
        return sum(max(f / PEAK_TF32_FLOPS, b / PEAK_HBM_BYTES)
                   for f, b in getattr(self, which))


def count(fn, grad: bool) -> Work:
    """The work of ``fn()``, a reference forward on meta tensors; with
    ``grad`` its backward too."""
    work = Work()
    mult = 3 if grad else 1

    def on_module(mod, inputs, output):
        if isinstance(mod, nn.Conv2d):
            n, cin = inputs[0].shape[:2]
            _, cout, ho, wo = output.shape
            kh, kw = mod.kernel_size
            work.flops += mult * conv2d_flops(n, cin, cout, ho, wo, kh, kw,
                                              mod.groups)
        elif isinstance(mod, nn.Linear):
            rows = inputs[0].numel() // mod.in_features
            work.flops += mult * linear_flops(rows, mod.in_features,
                                              mod.out_features)

    def on_op(kind, **s):
        if kind in ("attention", "text_attention"):
            dims = (s["b"], s["nq"], s["nk"], s["d"])
            f = attention_flops(*dims)
            work.flops += f
            calls = [(f, attention_bytes(*dims))]
            if grad:
                fb = attention_flops(*dims, backward=True)
                work.flops += fb
                calls.append((fb, attention_bytes(*dims, backward=True)))
            if kind == "attention":  # text attention is not on the kernels
                work.attention += calls
        elif kind == "gn_silu":
            work.gn_silu.append((0, gn_silu_bytes(s["numel"])))
            if grad:
                work.gn_silu.append((0, gn_silu_bytes(s["numel"], True)))

    handle = nn.modules.module.register_module_forward_hook(on_module)
    try:
        with ops.observe(on_op), torch.no_grad():
            fn()
    finally:
        handle.remove()
    return work


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")
