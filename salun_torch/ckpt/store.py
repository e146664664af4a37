"""Artifacts on disk (counterpart of ``salun/ckpt/store.py``), in the
reference's torch formats:

- masks ``with_{t}.pt``: ``{torch_param_name: 0/1 fp32 tensor}``
  (Classification/generate_mask.py:82), readable by
  ``salun.ckpt.import_mask``;
- ``{unlearn}_checkpoint.pt`` and ``model_SA_best.pt``: ``{"state_dict":
  ...}`` (utils.py:44-52), readable by ``salun.ckpt.import_resnet`` /
  ``import_vgg``;
- ``{unlearn}_eval_result.json`` as ``salun.ckpt.save_eval_results`` writes
  it;
- ``main_train``'s ``checkpoint.pt``: the model, the optimizer's
  flat momentum and step count, the step-randomness generator's state,
  ``epoch``, ``best_sa`` and the curves, all a resumed run needs to
  continue bitwise as a straight run would.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch


def mask_path(save_dir: str, threshold: float) -> str:
    return os.path.join(save_dir, f"with_{threshold}.pt")


def save_mask(path: str, mask: Dict[str, torch.Tensor]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().to("cpu", torch.float32)
                for k, v in mask.items()}, path)


def load_mask(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    md = torch.load(path, map_location="cpu", weights_only=True)
    return {(k[len("module."):] if k.startswith("module.") else k):
            v.to(device) for k, v in md.items()}


def _cpu_state_dict(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_model(path: str, model: torch.nn.Module) -> str:
    """``model`` as ``{"state_dict": ...}`` at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": _cpu_state_dict(model)}, path)
    return path


def checkpoint_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}_checkpoint.pt")


def save_checkpoint(save_dir: str, name: str, model: torch.nn.Module) -> str:
    return save_model(checkpoint_path(save_dir, name), model)


def save_train_state(path: str, model: torch.nn.Module, opt,
                     gen: torch.Generator, *, epoch: int, best_sa: float,
                     curves: dict) -> None:
    """The pretraining checkpoint; ``opt`` is a flat-buffer optimizer
    (``salun_torch.core.masked_opt``)."""
    torch.save({"state_dict": _cpu_state_dict(model),
                "momentum": opt.trace.detach().cpu(), "count": opt.count,
                "generator": gen.get_state(), "epoch": int(epoch),
                "best_sa": float(best_sa),
                "curves": {k: [float(x) for x in v]
                           for k, v in curves.items()}}, path)


def load_train_state(path: str, model: torch.nn.Module, opt,
                     gen: torch.Generator) -> dict:
    """Restore what :func:`save_train_state` wrote into ``model``, ``opt``
    and ``gen`` (in place); returns ``{"epoch", "best_sa", "curves"}``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["state_dict"], strict=True)
    opt.trace.copy_(ck["momentum"])
    opt.count = int(ck["count"])
    gen.set_state(ck["generator"])
    return {"epoch": int(ck["epoch"]), "best_sa": float(ck["best_sa"]),
            "curves": {k: list(v) for k, v in ck["curves"].items()}}


def _floats(tree):
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree)


def save_eval_results(save_dir: str, name: str, results: dict) -> None:
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"{name}_eval_result.json"), "w") as f:
        json.dump(_floats(results), f, indent=2)
