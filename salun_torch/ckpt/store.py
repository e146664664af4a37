"""Artifacts on disk (counterpart of ``salun/ckpt/store.py``), in the
reference's torch formats:

- masks ``with_{t}.pt``: ``{torch_param_name: 0/1 fp32 tensor}``
  (Classification/generate_mask.py:82), readable by
  ``salun.ckpt.import_mask``;
- ``{unlearn}_checkpoint.pt``: ``{"state_dict": ...}`` (utils.py:44-52),
  readable by ``salun.ckpt.import_resnet``;
- ``{unlearn}_eval_result.json`` as ``salun.ckpt.save_eval_results`` writes
  it.
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


def save_checkpoint(save_dir: str, name: str, model: torch.nn.Module) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}_checkpoint.pt")
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, path)
    return path


def _floats(tree):
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree)


def save_eval_results(save_dir: str, name: str, results: dict) -> None:
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"{name}_eval_result.json"), "w") as f:
        json.dump(_floats(results), f, indent=2)
