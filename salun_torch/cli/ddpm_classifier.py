"""DDPM forgotten-class classifier: training and evaluation (counterpart of
``salun/cli/ddpm_classifier.py``).

- ``train`` (DDPM/train_classifier.py): a ResNet-34 (ImageNet stem) at
  224×224 on CIFAR-10. Each batch is resized to 224 (bilinear,
  half-pixel centres, antialiased as ``jax.image.resize``) from [0, 1] and
  scaled back by 255, then the train step crops and flips it and takes one
  Adam step with L2 5e-4 added to the gradient: the body at ``--lr``, the
  ``fc`` head at ``--lr`` × 10 (train_classifier.py:138-148).
  ``--freeze_layers`` trains the head only; ``--init_weights`` starts the
  body from a local torchvision ImageNet ``.pth`` and keeps the fresh
  10-way head. Writes ``save_dir/classifier.pt`` (``{"state_dict": ...}``
  under torchvision names).
- ``eval`` (DDPM/classifier_evaluation.py:16-147): the softmax at 224 over
  a folder of generated samples of the forgotten class, then the average
  entropy, the forgotten class's average probability and the share of
  samples classified as it, written to ``save_dir/classifier_eval.json``.
  ``--ckpt`` is ``train``'s file or the reference's own
  ``{dataset}_resnet34.pth``.

Randomness (crop offsets, flips) comes from a ``torch.Generator`` seeded
by ``--seed``, or from a source the caller passes (the tests replay the
JAX run's draws).

Usage:
  python -m salun_torch.cli.ddpm_classifier train --data ./data \
      --save_dir results/classifier [--device cpu]
  python -m salun_torch.cli.ddpm_classifier eval --sample_path samples/0 \
      --label_of_forgotten_class 0 --ckpt results/classifier/classifier.pt
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from salun_torch.ckpt import load_state_dict, save_model
from salun_torch.cli.ddpm_evaluator import read_images_folder
from salun_torch.cli.setup import load_model
from salun_torch.core.train import generator_source, train_step
from salun_torch.data import datasets as D
from salun_torch.data.loader import BatchIterator, to_device
from salun_torch.models import create_model
from salun_torch.utils.device import (make_generator, resolve_device,
                                      seed_all, set_tf32)

IMG_SIZE = 224  # classifier_evaluation.py evaluates at 224
WEIGHT_DECAY = 5e-4


def resize_batch(x: torch.Tensor) -> torch.Tensor:
    """NCHW float → NCHW at IMG_SIZE (``jax.image.resize`` "bilinear")."""
    return F.interpolate(x, size=(IMG_SIZE, IMG_SIZE), mode="bilinear",
                         align_corners=False, antialias=True)


def load_init_weights(model, path: str) -> None:
    """A torchvision ImageNet ResNet-34 ``.pth`` into ``model``'s body; the
    fresh ``fc`` head stays (train_classifier.py:124-135)."""
    sd = {k: v for k, v in load_state_dict(path).items()
          if not k.startswith("fc.")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if unexpected or sorted(missing) != ["fc.bias", "fc.weight"]:
        raise KeyError(f"{path}: missing {missing[:5]}, unexpected "
                       f"{unexpected[:5]}")


def make_optimizer(model, lr: float, freeze_layers: bool):
    """Adam with L2 in the gradient: the body at ``lr`` (left out, and
    bitwise unchanged, under ``freeze_layers``), ``fc`` at ``lr`` × 10."""
    fc = [p for n, p in model.named_parameters() if n.startswith("fc.")]
    body = [p for n, p in model.named_parameters() if not n.startswith("fc.")]
    groups = [{"params": fc, "lr": lr * 10}]
    if freeze_layers:
        for p in body:
            p.requires_grad_(False)
    else:
        groups.insert(0, {"params": body, "lr": lr})
    return torch.optim.Adam(groups, weight_decay=WEIGHT_DECAY)


def train(args, source: Optional[Callable] = None) -> dict:
    device = resolve_device(args.device)
    set_tf32(True)
    if args.limit < 0:
        raise SystemExit("--limit must be >= 0")
    seed_all(args.seed)
    ds = D.load(args.dataset, args.data, train=True)
    if args.limit:
        ds = ds.select(range(min(args.limit, len(ds))))
    model = create_model("resnet34", ds.num_classes, seed=args.seed,
                         device=device)
    if args.init_weights:
        load_init_weights(model, args.init_weights)
    opt = make_optimizer(model, args.lr, args.freeze_layers)
    if source is None:
        source = generator_source(make_generator(args.seed, device),
                                  ds.num_classes)
    loader = BatchIterator(ds, args.batch_size, shuffle=True, seed=args.seed)
    steps, t0, t_first = 0, time.perf_counter(), None
    for epoch in range(args.epochs):
        for b in loader:
            batch = to_device(b, device)
            batch["image"] = resize_batch(
                batch["image"].to(torch.float32) / 255.0) * 255.0
            m = train_step(model, opt, batch,
                           source(batch["image"].shape[0]))
            steps += 1
            if t_first is None:  # steady-state clock starts after step 1
                _sync(device)
                t_first = time.perf_counter()
        print(f"epoch {epoch} train acc {float(m['acc']):.2f}")
    _sync(device)
    t_end = time.perf_counter()
    ms = 1e3 * (t_end - t_first) / (steps - 1) if steps > 1 else float("nan")
    print(f"classifier train: {steps} steps, first "
          f"{(t_first or t_end) - t0:.3f} s, then {ms:.3f} ms/step")
    path = save_model(os.path.join(args.save_dir, "classifier.pt"), model)
    return {"path": path, "steps": steps, "ms_per_step": ms,
            "first_step_seconds": (t_first or t_end) - t0}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def softmax_at_224(model, images: np.ndarray, batch_size: int,
                   device) -> np.ndarray:
    """Softmax of ``model`` over NHWC [0, 1] images resized to 224."""
    model.eval()
    probs = []
    for i in range(0, len(images), batch_size):
        x = torch.from_numpy(np.ascontiguousarray(
            images[i:i + batch_size])).to(device).permute(0, 3, 1, 2)
        out = model(resize_batch(x))
        probs.append(torch.softmax(out.to(torch.float32), -1).cpu().numpy())
    return np.concatenate(probs)


def evaluate(args) -> dict:
    device = resolve_device(args.device)
    set_tf32(True)
    if not args.ckpt.endswith((".pt", ".pth", ".pth.tar")):
        raise ValueError("the port reads torch .pt/.pth classifiers; orbax "
                         "checkpoints are the JAX package's")
    model = create_model("resnet34", 10, device=device)
    load_model(model, args.ckpt)
    probs = softmax_at_224(model, read_images_folder(args.sample_path),
                           args.batch_size, device)
    entropy = -(probs * np.log(np.maximum(probs, 1e-12))).sum(1)
    c = args.label_of_forgotten_class
    results = {
        "avg_entropy": float(entropy.mean()),
        "avg_prob_of_forgotten_class": float(probs[:, c].mean()),
        "accuracy_on_forgotten_class": float((probs.argmax(1) == c).mean()),
    }
    print(results)
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "classifier_eval.json"), "w") as f:
        json.dump(results, f, indent=2)
    return dict(results, probs=probs)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("--dataset", default="cifar10")
    tr.add_argument("--data", default="./data")
    tr.add_argument("--batch_size", type=int, default=64)
    tr.add_argument("--epochs", type=int, default=10)
    tr.add_argument("--lr", type=float, default=0.01)
    tr.add_argument("--seed", type=int, default=1)
    tr.add_argument("--save_dir", default="results/classifier")
    tr.add_argument("--limit", type=int, default=0,
                    help="cap train set size (smoke runs); 0 = full")
    tr.add_argument("--init_weights", default=None,
                    help="local torchvision ImageNet resnet34 .pth to "
                         "fine-tune from; default a seeded init")
    tr.add_argument("--freeze_layers", action="store_true",
                    help="train only the fc head")
    ev = sub.add_parser("eval")
    ev.add_argument("--sample_path", required=True)
    ev.add_argument("--label_of_forgotten_class", type=int, default=0)
    ev.add_argument("--ckpt", required=True)
    ev.add_argument("--batch_size", type=int, default=64)
    ev.add_argument("--save_dir", default="results/classifier")
    for q in (tr, ev):
        q.add_argument("--device", type=str, default="cuda",
                       help="torch device to run on (default cuda; cpu for "
                            "tests)")
    return p.parse_args(argv)


def main(argv=None, source: Optional[Callable] = None) -> dict:
    args = parse_args(argv)
    if args.cmd == "train":
        return train(args, source)
    return evaluate(args)


if __name__ == "__main__":
    main()
