"""Hand-written Hopper kernels of the port, one module per TPU kernel.

| Kernel | Replaces | Module | Source |
|---|---|---|---|
| K1 | ``salun/kernels/masked_update.py::_masked_sgd_kernel`` | ``masked_update`` | ``csrc/masked_sgd.cu`` |

Each wrapper launches its kernel on CUDA tensors (or raises), runs its
plain PyTorch version on CPU tensors only, and counts its launches in a
plain integer attribute ``launches``.
"""

from .masked_update import masked_sgd_update, masked_sgd_update_reference

__all__ = ["masked_sgd_update", "masked_sgd_update_reference"]
