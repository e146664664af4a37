"""Classification trainer (counterpart of ``salun/core/train.py``).

One train step augments on the device (unless asked not to), optionally
uses random labels or a prune mask on the forward, computes
``loss_sign·CE + l1_coeff(step)·Σ|θ|`` and runs the optimizer step (the
masked one launches K1). :func:`per_sample_grads` gives per-sample
gradients in eval mode (the fisher methods). Randomness comes
from a *source*: a callable ``(batch_size, *, random_labels) -> dict``
giving ``offsets``/``flips`` (augment) and, for random labels, ``labels``.
The default source draws from a ``torch.Generator``; the tests pass one
that returns the draws of the JAX package's keys. Metrics stay on the
device.

Under a ``--dp`` mesh (``salun_torch.dist.context``) a step draws for the
global batch, keeps this rank's rows of the batch and the draws, divides
the loss by the global batch's weight, takes BatchNorm's moments over the
global batch and sums the flat gradient over the ranks before the
optimizer reads it; :func:`validate` sums its counts over the ranks. A
batch that does not divide over the ranks runs whole on each, with no
collective.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad, vmap

from salun_torch.data.loader import augment, draw_augment, to_device, to_float
from salun_torch.dist import context as dist_ctx


def cross_entropy(logits, labels, weight=None, denom=None):
    """Mean CE over valid rows (nn.CrossEntropyLoss mean reduction); with
    ``weight``, ``sum(nll·w) / max(sum(w), 1)`` so padding rows count 0.
    ``denom`` replaces the denominator (a shard's rows over the global
    batch's ``max(sum(w), 1)``)."""
    ll = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -ll.gather(-1, labels.long()[:, None])[:, 0]
    return _weighted_mean(nll, weight, denom)


def weighted_accuracy(logits, labels, weight=None, denom=None):
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    return _weighted_mean(correct, weight, denom) * 100.0


def _weighted_mean(x, weight, denom):
    if weight is None and denom is None:
        return x.mean()
    if weight is not None:
        x = x * weight
    if denom is None:
        denom = torch.clamp(weight.sum(), min=1.0)
    return x.sum() / denom


def global_denominator(batch: dict) -> torch.Tensor:
    """``max(sum(w), 1)`` over a whole batch (its row count without
    weights): the loss denominator every rank's shard divides by."""
    w = batch.get("weight")
    if w is None:
        return torch.tensor(float(batch["image"].shape[0]))
    return torch.clamp(w.sum(), min=1.0)


def multistep_lr(base_lr: float, milestones_epochs, steps_per_epoch: int,
                 gamma: float = 0.1) -> Callable[[int], float]:
    """MultiStepLR stepped per epoch (impl.py:95-97), in fp32 like
    ``optax.piecewise_constant_schedule``: at step ``t`` the lr is
    ``base_lr`` times every ``gamma`` whose boundary is ``<= t``, each
    product rounded to fp32."""
    boundaries = sorted({int(m) * steps_per_epoch: gamma
                         for m in milestones_epochs}.items())

    def sched(step: int) -> float:
        v = np.float32(base_lr)
        for boundary, scale in boundaries:
            if step >= boundary:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return sched


def cosine_warmup_lr(base_lr: float, warmup_epochs: int, total_epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Per-epoch cosine with linear warmup (impl.py:76-92,
    main_train.py:66-80): the step is floored to an epoch, as the
    reference's per-epoch lambda does, and the arithmetic is fp32 like
    ``salun.core.train.cosine_warmup_lr``."""
    warmup = max(int(warmup_epochs), 0)
    f32 = np.float32

    def sched(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if epoch < warmup:
            scale = f32(epoch + 1) / f32(max(warmup, 1))
        else:
            prog = f32(epoch - warmup) / f32(max(total_epochs - warmup, 1))
            scale = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(f32(f32(base_lr) * f32(scale)))

    return sched


def generator_source(gen: torch.Generator, num_classes: int) -> Callable:
    """Randomness for one step, drawn on the generator's device: crop
    offsets and flips first, then labels (the JAX step's ``ka, kl``)."""

    def draw(batch_size: int, *, random_labels: bool = False) -> dict:
        out = {}
        out["offsets"], out["flips"] = draw_augment(gen, batch_size)
        if random_labels:
            out["labels"] = torch.randint(0, num_classes, (batch_size,),
                                          generator=gen, device=gen.device)
        return out

    return draw


def add_l1_grad(flat, coeff: float) -> torch.Tensor:
    """Add the gradient of ``coeff·Σ|θ|`` (``salun/utils/tree.py:52``
    ``tree_l1``) to the flat grad buffer of ``flat`` (a
    :class:`~salun_torch.core.masked_opt.FlatParams`); returns Σ|θ|.

    One pass over the flat buffer instead of an autograd term per
    parameter. The gradient is ``±coeff`` with +coeff at θ = 0, as JAX's
    ``abs`` has it (torch's ``abs`` gives 0 there, and a zero-initialised
    bias would miss the first step's pull); ``coeff`` is added to the
    cross-entropy gradient once, so the sum is the one autograd forms.
    """
    p = flat.flat
    flat.grad.add_(torch.where(p >= 0, coeff, -coeff))
    return p.abs().sum()


def train_step(model, opt, batch: dict, rand: dict, *,
               random_labels: bool = False, loss_sign: float = 1.0,
               l1_coeff: Optional[Callable[[int], float]] = None,
               use_augment: bool = True,
               prune_mask: Optional[dict] = None) -> dict:
    """One step on a device batch (``salun/core/train.py:92-148``);
    returns ``{"loss", "acc"}`` tensors.

    ``loss_sign=-1`` gives gradient ascent; ``l1_coeff(step)`` adds
    α·Σ|θ| at the optimizer's step count before this step (GA_l1, FT_l1;
    ``opt`` is one of the port's flat-buffer optimizers);
    ``use_augment=False`` skips crop and flip (``main_train --no-aug``).
    ``prune_mask`` (``{name: 0/1}`` over every parameter) makes the
    forward read ``p·m`` through ``functional_call``, so pruned
    coordinates get zero gradient by the chain rule while weight decay
    still sees the raw ``p`` (``make_pruned_train_step``,
    ``salun/core/methods/prune_variants.py:37-66``).

    ``batch`` and ``rand`` are the global batch's; under a ``--dp`` mesh
    the step keeps this rank's rows of both (see the module docstring).
    """
    rows = batch["image"].shape[0]
    denom = None
    if dist_ctx.rows(rows) is not None:
        denom = global_denominator(batch)
        batch, rand = dist_ctx.ingest(batch), dist_ctx.ingest(rand)
    img = to_float(batch["image"])
    if use_augment:
        img = augment(img, rand["offsets"], rand["flips"])
    label = rand["labels"] if random_labels else batch["label"]
    weight = batch.get("weight")
    model.train()
    opt.zero_grad()
    with dist_ctx.sharded(rows):
        if prune_mask is None:
            logits = model(img)
        else:
            logits = functional_call(
                model, {n: p * prune_mask[n].to(p.dtype)
                        for n, p in model.named_parameters()}, (img,))
        loss = loss_sign * cross_entropy(logits, label, weight, denom)
        loss.backward()
    acc = weighted_accuracy(logits.detach(), label, weight, denom)
    loss = loss.detach()
    if denom is not None:
        opt.flat.check_grads()
        dist_ctx.all_reduce_([opt.flat.grad])
        loss, acc = (v.to(torch.float32)
                     for v in dist_ctx.sum_scalars(loss, acc))
    if l1_coeff is not None:
        coeff = l1_coeff(opt.count)
        loss = loss + coeff * add_l1_grad(opt.flat, coeff)
    opt.step()
    return {"loss": loss, "acc": acc}


def run_epoch(model, opt, loader, source: Callable, device, *,
              random_labels: bool = False, **step_kw) -> Optional[dict]:
    """One pass over ``loader``; returns the last step's metrics.
    ``step_kw`` goes to :func:`train_step`."""
    m = None
    for b in loader:
        batch = to_device(b, device)
        rand = source(batch["image"].shape[0], random_labels=random_labels)
        m = train_step(model, opt, batch, rand, random_labels=random_labels,
                       **step_kw)
    return m


def per_sample_grads(model, sample_loss: Callable, img: torch.Tensor,
                     label: torch.Tensor, chunk: int = 32) -> Iterator:
    """Per-sample gradients of ``sample_loss(logits_row, label)`` with
    respect to every parameter, in eval mode (BatchNorm on its running
    statistics), from ``torch.func.vmap(grad)`` over ``functional_call``.

    Yields ``(start, {name: [b, *shape]})`` for chunks of at most
    ``chunk`` samples: a full-width ResNet-18's per-sample grads take
    45 MB a sample in fp32."""
    model.eval()
    params = {n: p.detach() for n, p in model.named_parameters()}
    buffers = dict(model.named_buffers())

    def one(p, x, y):
        out = functional_call(model, (p, buffers), (x[None],))
        return sample_loss(out[0], y)

    batched = vmap(grad(one), in_dims=(None, 0, 0))
    for lo in range(0, img.shape[0], chunk):
        yield lo, batched(params, img[lo:lo + chunk], label[lo:lo + chunk])


@torch.no_grad()
def validate(model, loader, device) -> float:
    """Top-1 accuracy in % over the weighted rows (trainer/val.py). Under a
    ``--dp`` mesh each rank counts its rows (rank 0 a batch that does not
    divide) and the counts are summed over the ranks."""
    model.eval()
    correct = torch.zeros((), dtype=torch.float64, device=device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for b in loader:
        n = len(b["label"])
        if dist_ctx.skips(n):
            continue
        batch = dist_ctx.ingest(to_device(b, device))
        pred = model(to_float(batch["image"])).argmax(dim=-1)
        hit = (pred == batch["label"]).to(torch.float32) * batch["weight"]
        correct += hit.sum()
        total += batch["weight"].sum()
    correct, total = dist_ctx.sum_scalars(correct, total)
    return 100.0 * float(correct) / max(float(total), 1.0)
