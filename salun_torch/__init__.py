"""PyTorch/CUDA port of SalUn (saliency-mask machine unlearning).

Mirrors the layout of the JAX package ``salun`` module for module, so each
file here has a counterpart of the same name there. The port imports
``torch`` and never ``jax``; it keeps its own copy of the numpy helpers it
needs. Entry points run on ``cuda`` unless the caller asks for the CPU.

The hand-written Hopper kernels live in ``salun_torch/csrc`` and are built
with ``nvcc`` on first use (``salun_torch.kernels._build``).
"""

__version__ = "0.1.0"
