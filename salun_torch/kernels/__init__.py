"""Hand-written Hopper kernels of the port, one module per TPU kernel.

| Kernel | Replaces | Module | Source |
|---|---|---|---|
| K1 | ``salun/kernels/masked_update.py::_masked_sgd_kernel`` | ``masked_update`` | ``csrc/masked_sgd.cu`` |
| K2 | ``salun/kernels/flash_attention.py::_flash_kernel`` | ``flash_attention`` | ``csrc/flash_attention.cu`` |
| K3a | ``salun/kernels/flash_attention.py::_bwd_dq_kernel`` | ``flash_attention`` | ``csrc/flash_attention.cu`` |
| K3b | ``salun/kernels/flash_attention.py::_bwd_dkv_kernel`` | ``flash_attention`` | ``csrc/flash_attention.cu`` |
| K4 | ``salun/kernels/groupnorm_silu.py::_gn_silu_kernel`` | ``groupnorm_silu`` | ``csrc/groupnorm_silu.cu`` |
| K4b | ``salun/kernels/groupnorm_silu.py::_gn_silu_bwd`` (XLA in JAX) | ``groupnorm_silu`` | ``csrc/groupnorm_silu.cu`` |

Each wrapper launches its kernel on CUDA tensors (or raises), runs its
plain PyTorch version on CPU tensors only, and counts its launches in a
plain integer attribute ``launches``.

``attention`` is the attention entry point of the port's models.
"""

from .attention import multi_head_attention, scaled_dot_attention
from .flash_attention import (FlashAttention, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_fwd)
from .groupnorm_silu import GroupNormSiLU
from .masked_update import masked_sgd_update, masked_sgd_update_reference

__all__ = ["FlashAttention", "GroupNormSiLU", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd",
           "masked_sgd_update", "masked_sgd_update_reference",
           "multi_head_attention", "scaled_dot_attention"]
