"""Influence unlearning, IU / Wfisher (counterpart of
``salun/core/methods/wfisher.py``; reference
Classification/unlearn/Wfisher.py:47-199).

- the sample-weighted mean gradient of CE over the forget and the retain
  set, combined as v = forget_grad/(Nf+Nr) − retain_grad·Nf/((Nf+Nr)·Nr)
  (Wfisher.py:171-173);
- woodfisher: over a batch-1 retain stream of gradients g_t,
  k ← k − (⟨k,g⟩/(N+⟨o,g⟩))·o and o ← o − (⟨o,g⟩/(N+⟨o,g⟩))·o with N =
  1000, the first gradient only seeding o (Wfisher.py:47-69); the stream is
  unshuffled and stops after 1,001 gradients;
- θ += α·k, times the saliency mask when one is given (Wfisher.py:31-44,
  197).

The vectors are the flat fp32 buffer of ``FlatParams`` (``named_parameters``
order); the mask multiplies in that order. Every gradient is taken in
eval mode on an augmented image (the reference's retain and forget
loaders carry the train transform; off for ImageNet archs), with the
crop and flip draws from ``source``.

As in the JAX package, the retain gradient always reads the retain set
(the reference's ImageNet branch reads the forget loader a second time,
Wfisher.py:136-147).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from salun_torch.core.masked_opt import FlatParams
from salun_torch.core.train import cross_entropy
from salun_torch.data.loader import augment, to_device, to_float

from .common import UnlearnConfig, mask_tensors
from .iterative import _default_source

WOODFISHER_N = 1000


def _flat_grad(model, flat: FlatParams, batch: dict, source,
               augmented: bool) -> torch.Tensor:
    """The gradient of the weighted CE of ``batch`` in eval mode, flat."""
    img = to_float(batch["image"])
    if augmented:
        rand = source(img.shape[0])
        img = augment(img, rand["offsets"], rand["flips"])
    flat.zero_grad()
    cross_entropy(model(img), batch["label"], batch["weight"]).backward()
    flat.check_grads()
    return flat.grad.clone()


def _sum_weighted_grads(model, flat, loader, device, source, augmented):
    acc = torch.zeros_like(flat.flat)
    total = 0.0
    for b in loader:
        n = float(b["weight"].sum())
        acc.add_(_flat_grad(model, flat, to_device(b, device), source,
                            augmented) * n)
        total += n
    return acc, total


def Wfisher(loaders, model, cfg: UnlearnConfig, mask: Optional[dict] = None,
            *, device, source: Optional[Callable] = None):
    """In place on ``model``; returns ``(model, None)``."""
    source = _default_source(source, cfg, device)
    augmented = not cfg.imagenet_arch
    model.eval()
    flat = FlatParams(model.parameters())
    forget_sum, n_f = _sum_weighted_grads(model, flat, loaders["forget"],
                                          device, source, augmented)
    retain_sum, n_r = _sum_weighted_grads(model, flat, loaders["retain"],
                                          device, source, augmented)
    v = forget_sum / (n_f + n_r) - retain_sum * (n_f / ((n_f + n_r) * n_r))

    # the batch-1 retain stream, unshuffled: at most N + 1 gradients
    ds = loaders["retain"].ds
    m = min(len(ds), WOODFISHER_N + 1)
    stream = to_device({"image": ds.data[:m], "label": ds.targets[:m],
                        "weight": torch.ones(m).numpy()}, device)
    k_vec, o_vec = v, None
    for i in range(m):
        g = _flat_grad(model, flat, {key: t[i:i + 1]
                                     for key, t in stream.items()},
                       source, augmented)
        if o_vec is None:
            o_vec = g
            continue
        tmp = torch.dot(o_vec, g)
        denom = WOODFISHER_N + tmp
        k_vec = k_vec - (torch.dot(k_vec, g) / denom) * o_vec
        o_vec = o_vec - (tmp / denom) * o_vec

    perturb = cfg.alpha * k_vec
    if mask is not None:
        perturb = perturb * flat.flatten(mask_tensors(model, mask))
    with torch.no_grad():
        flat.flat.copy_(flat.flat + perturb)
    return model, None
