"""Classification trainer (counterpart of ``salun/core/train.py``).

One train step augments on the device, optionally uses random labels and
runs the optimizer step (the masked one launches K1). Randomness comes from
a *source*: a callable ``(batch_size, *, random_labels) -> dict`` giving
``offsets``/``flips`` (augment) and, for random labels, ``labels``. The
default source draws from a ``torch.Generator``; the tests pass one that
returns the draws of the JAX package's keys. Metrics stay on the device.
The loss sign and the l1 term of GA/FT_l1 come with those methods.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from salun_torch.data.loader import augment, draw_augment, to_device, to_float


def cross_entropy(logits, labels, weight=None):
    """Mean CE over valid rows (nn.CrossEntropyLoss mean reduction); with
    ``weight``, ``sum(nll·w) / max(sum(w), 1)`` so padding rows count 0."""
    ll = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -ll.gather(-1, labels.long()[:, None])[:, 0]
    if weight is None:
        return nll.mean()
    return (nll * weight).sum() / torch.clamp(weight.sum(), min=1.0)


def weighted_accuracy(logits, labels, weight=None):
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    if weight is None:
        return correct.mean() * 100.0
    return (correct * weight).sum() / torch.clamp(weight.sum(), min=1.0) * 100.0


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


def train_step(model, opt, batch: dict, rand: dict, *,
               random_labels: bool = False) -> dict:
    """One step on a device batch (always augmented, as every train step
    of the JAX package's methods is); returns ``{"loss", "acc"}`` tensors."""
    img = augment(to_float(batch["image"]), rand["offsets"], rand["flips"])
    label = rand["labels"] if random_labels else batch["label"]
    weight = batch.get("weight")
    model.train()
    opt.zero_grad()
    logits = model(img)
    loss = cross_entropy(logits, label, weight)
    loss.backward()
    opt.step()
    return {"loss": loss.detach(),
            "acc": weighted_accuracy(logits.detach(), label, weight)}


def run_epoch(model, opt, loader, source: Callable, device, *,
              random_labels: bool = False) -> Optional[dict]:
    """One pass over ``loader``; returns the last step's metrics."""
    m = None
    for b in loader:
        batch = to_device(b, device)
        rand = source(batch["image"].shape[0], random_labels=random_labels)
        m = train_step(model, opt, batch, rand, random_labels=random_labels)
    return m


@torch.no_grad()
def validate(model, loader, device) -> float:
    """Top-1 accuracy in % over the weighted rows (trainer/val.py)."""
    model.eval()
    correct = torch.zeros((), dtype=torch.float64, device=device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for b in loader:
        batch = to_device(b, device)
        pred = model(to_float(batch["image"])).argmax(dim=-1)
        hit = (pred == batch["label"]).to(torch.float32) * batch["weight"]
        correct += hit.sum()
        total += batch["weight"].sum()
    return 100.0 * float(correct) / max(float(total), 1.0)
