"""Fisher-information unlearning, ``fisher`` and ``fisher_new``
(counterpart of ``salun/core/methods/fisher.py``; reference
Classification/unlearn/fisher.py).

- ``fisher`` (fisher.py:8-47): the diagonal FIM over the retain set from
  per-sample gradients of log p(y_i|x_i), squared after adding eps and
  averaged; then noise sqrt(α/FIM), clamped to 1e-3, ×10 on the output
  layer.
- ``fisher_new`` (fisher.py:50-115): per class y, the squared gradient of
  the batch-mean CE toward y weighted by the batch-mean softmax p(y);
  variance α/(F + eps) with clamps and per-output spreading, then weights
  resampled from N(θ, var), the forgotten class's row special-cased.

Per-sample gradients come from ``torch.func.vmap(grad)`` in eval mode,
in chunks of the batch (``salun_torch.core.train.per_sample_grads``).

Layouts. The JAX package finds the output layer as "last dim ==
num_classes" on its [in, out] and HWIO kernels; that dim is the out
features, dim 0 of a torch weight (OIHW, [out, in]) and the only dim of a
1-D tensor. Its mean over "all non-output axes" is the mean over dims 1…
here, and ``mu.at[..., c]`` is row (or entry) ``c`` on dim 0.

Randomness: the retain batches are augmented with draws from ``source``
(crop offsets and flips, off for ImageNet archs) and the noise comes from
``noise(name, param)``, a standard normal of the parameter's shape; both
default to a ``torch.Generator`` on ``device``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from salun_torch.core.train import per_sample_grads
from salun_torch.data.loader import augment, to_device, to_float

from .common import UnlearnConfig
from .iterative import _default_source

EPS = 1e-8


def _default_noise(noise, cfg: UnlearnConfig, device) -> Callable:
    if noise is not None:
        return noise
    # seeded apart from the default augment draws' generator (cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    return lambda name, p: torch.randn(p.shape, generator=gen,
                                       device=p.device)


def _batches(loader, device, source, cfg: UnlearnConfig):
    """Device batches of ``loader``, float images, augmented unless the
    arch is an ImageNet one."""
    for b in loader:
        batch = to_device(b, device)
        img = to_float(batch["image"])
        if not cfg.imagenet_arch:
            rand = source(img.shape[0])
            img = augment(img, rand["offsets"], rand["flips"])
        yield img, batch


def _logp_at_label(logits, y):
    return F.log_softmax(logits, dim=-1).gather(0, y[None])[0]


def fisher_information(model, loader, device, source, cfg: UnlearnConfig,
                       chunk: int = 32) -> dict:
    """Diagonal FIM (fisher.py:8-33) over ``loader``: the weighted mean
    over samples of (g + eps)², g the per-sample gradient of log p(y|x) in
    eval mode. ``{name: tensor}`` in ``named_parameters`` order."""
    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in model.named_parameters()}
    total = torch.zeros((), dtype=torch.float32, device=device)
    with torch.no_grad():
        for img, batch in _batches(loader, device, source, cfg):
            w = batch["weight"]
            for lo, grads in per_sample_grads(model, _logp_at_label, img,
                                              batch["label"], chunk):
                wc = w[lo:lo + chunk]
                for n, g in grads.items():
                    acc[n].add_(torch.tensordot(wc, (g + EPS) ** 2, dims=1))
            total += w.sum()
    return {n: a / total for n, a in acc.items()}


def _is_output(p: torch.Tensor, cfg: UnlearnConfig) -> bool:
    return p.dim() >= 1 and p.shape[0] == cfg.num_classes


def fisher(loaders, model, cfg: UnlearnConfig, mask: Optional[dict] = None,
           *, device, source: Optional[Callable] = None,
           noise: Optional[Callable] = None):
    """θ + sqrt(α/FIM)·N(0, 1), clamped at 1e-3, ×10 on the output layer;
    in place on ``model``, returns ``(model, None)``. ``mask`` is
    ignored."""
    source = _default_source(source, cfg, device)
    noise = _default_noise(noise, cfg, device)
    fim = fisher_information(model, loaders["retain"], device, source, cfg)
    with torch.no_grad():
        for n, p in model.named_parameters():
            sigma = torch.sqrt(cfg.alpha / fim[n]).clamp(max=1e-3)
            z = sigma * noise(n, p)
            if _is_output(p, cfg):
                z = z * 10.0
            p.copy_(p + z)
    return model, None


def class_weighted_sq_grads(model, img: torch.Tensor,
                            num_classes: int) -> dict:
    """Σ_y p̄(y)·(∇ CE(out, y))² for one batch (fisher.py:59-76), eval mode:
    p̄ the batch-mean softmax, CE the unweighted batch mean."""
    model.eval()
    params = dict(model.named_parameters())
    out = model(img).to(torch.float32)
    ll = F.log_softmax(out, dim=-1)
    probs = F.softmax(out.detach(), dim=-1).mean(0)
    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in params.items()}
    for y in range(num_classes):
        grads = torch.autograd.grad(-ll[:, y].mean(), list(params.values()),
                                    retain_graph=y < num_classes - 1)
        for a, g in zip(acc.values(), grads):
            a.add_(probs[y] * g ** 2)
    return acc


def fisher_new(loaders, model, cfg: UnlearnConfig,
               mask: Optional[dict] = None, *, device,
               source: Optional[Callable] = None,
               noise: Optional[Callable] = None):
    """Weights resampled from N(θ, var(F)) (fisher.py:50-115); in place on
    ``model``, returns ``(model, None)``. ``mask`` is ignored."""
    source = _default_source(source, cfg, device)
    noise = _default_noise(noise, cfg, device)
    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in model.named_parameters()}
    n_batches = 0
    for img, _ in _batches(loaders["retain"], device, source, cfg):
        sq = class_weighted_sq_grads(model, img, cfg.num_classes)
        acc = {n: acc[n] + sq[n] for n in acc}
        n_batches += 1
    special_forget = (
        (cfg.num_indexes_to_replace == 4500 and cfg.dataset == "cifar10")
        or (cfg.num_indexes_to_replace == 450 and cfg.dataset == "cifar100"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            g2 = acc[n] / max(n_batches, 1)
            var = (1.0 / (g2 + EPS)).clamp(max=1e3)
            output = _is_output(p, cfg)
            if output:
                var = var.clamp(max=1e2)
            var = cfg.alpha * var
            if p.dim() > 1:  # one variance per output row (fisher.py:86-87)
                var = var.mean(dim=tuple(range(1, p.dim())), keepdim=True)
                var = var.expand(p.shape).clone()
            mu = p.to(torch.float32).clone()
            if output and special_forget and cfg.class_to_replace >= 0:
                mu[cfg.class_to_replace] = 0.0
                var[cfg.class_to_replace] = 1e-4
            if output or p.dim() == 1:
                var = var * 10.0
            p.copy_(mu + torch.sqrt(var) * noise(n, p))
    return model, None
