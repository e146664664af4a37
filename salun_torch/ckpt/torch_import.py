"""The port's weight bridge (counterpart of ``salun/ckpt/torch_import.py``).

Moves weights and masks between the JAX package's numpy trees and the
port's torch state dicts, without importing anything of ``salun``:

- conv kernel HWIO → weight OIHW; Dense kernel → ``weight.T``;
- BatchNorm ``scale`` → ``weight``; ``mean``/``var`` → ``running_mean``/
  ``running_var``;
- module names ``layer1_0/downsample_conv`` → ``layer1.0.downsample.0``;
- for the DDPM U-Net, its own copy of the name map of
  ``salun/ckpt/torch_import.py:315-436`` (``temb_dense0`` ↔
  ``temb.dense.0``, ``down_1_attn_0/q`` ↔ ``down.1.attn.0.q``,
  ``mid_block_1`` ↔ ``mid.block_1``, Embed ``embedding`` ↔ ``weight``).

Also reads the reference's torch checkpoints (``{"state_dict": ...}``,
``module.`` prefixes, the ``normalize.*`` constants the port keeps as
non-persistent buffers).
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict → ``{"a/b/c": leaf}``, like flax ``flatten_dict``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):  # dict or flax FrozenDict
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def jax_path_to_torch(path: str) -> str:
    """A JAX module path → the torch module name:
    ``layer1_0/downsample_bn`` → ``layer1.0.downsample.1``."""
    parts = path.split("/")
    head = parts[0]
    if head.startswith("layer") and "_" in head:
        stage, block = head.rsplit("_", 1)
        rest = parts[1:]
        if rest and rest[0] in ("downsample_conv", "downsample_bn"):
            rest = ["downsample", "0" if rest[0] == "downsample_conv" else "1"
                    ] + rest[1:]
        return ".".join([stage, block] + rest)
    return ".".join(parts)


def torch_module_to_jax(module: str) -> str:
    """Inverse of :func:`jax_path_to_torch` for a module name."""
    parts = module.split(".")
    if parts[0].startswith("layer") and len(parts) >= 2:
        head = f"{parts[0]}_{parts[1]}"
        rest = parts[2:]
        if rest[:1] == ["downsample"]:
            rest = ["downsample_conv" if rest[1] == "0" else "downsample_bn"
                    ] + rest[2:]
        return "/".join([head] + rest)
    return "/".join(parts)


def _to_torch(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, order="C", copy=True))


def _leaf_to_torch(arr: np.ndarray, leaf: str):
    """(torch leaf name, array in torch layout) for one JAX param leaf."""
    if leaf == "kernel":
        return "weight", (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                          else arr.T)
    if leaf == "scale":
        return "weight", arr
    return leaf, arr


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` numpy trees → the port's state dict
    (every BatchNorm also gets ``num_batches_tracked = 0``)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        mod, leaf = path.rsplit("/", 1)
        tleaf, arr = _leaf_to_torch(np.asarray(v), leaf)
        sd[f"{jax_path_to_torch(mod)}.{tleaf}"] = _to_torch(arr)
    for path, v in _flatten(batch_stats).items():
        mod, leaf = path.rsplit("/", 1)
        base = jax_path_to_torch(mod)
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{base}.{name}"] = _to_torch(np.asarray(v))
        sd.setdefault(f"{base}.num_batches_tracked",
                      torch.zeros((), dtype=torch.int64))
    return sd


def mask_from_jax(mask_tree) -> Dict[str, torch.Tensor]:
    """JAX mask tree (param layout) → ``{torch_name: fp32 0/1 tensor}`` in
    torch layout, the reference ``with_{t}.pt`` format."""
    out = {}
    for path, v in _flatten(mask_tree).items():
        mod, leaf = path.rsplit("/", 1)
        tleaf, arr = _leaf_to_torch(np.asarray(v, np.float32), leaf)
        out[f"{jax_path_to_torch(mod)}.{tleaf}"] = _to_torch(arr)
    return out


def mask_to_jax(mask: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`mask_from_jax`: a nested dict of fp32 numpy arrays
    in the JAX layout (4-D weight → HWIO kernel, 2-D weight → kernel.T,
    1-D weight → scale)."""
    flat = {}
    for name, t in mask.items():
        arr = t.detach().cpu().numpy().astype(np.float32)
        module, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        flat[f"{torch_module_to_jax(module)}/{leaf}"] = (
            np.ascontiguousarray(arr))
    return _unflatten(flat)


def load_state_dict(path_or_sd) -> Dict[str, torch.Tensor]:
    """A reference-format classifier checkpoint (file or dict) → a plain
    state dict for the port's models."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.startswith("normalize."):
            continue  # the port keeps these constants inside the model
        out[k] = v
    return out


# --------------------------------------------------------------- DDPM

_DDPM_MODULES = (
    (r"(temb|cemb)_dense(\d+)", "{0}.dense.{1}"),
    (r"(classes_emb|conv_in|conv_out|norm_out)", "{0}"),
    (r"(down|up)_(\d+)_(block|attn)_(\d+)/(\w+)", "{0}.{1}.{2}.{3}.{4}"),
    (r"(down|up)_(\d+)_(downsample|upsample)/conv", "{0}.{1}.{2}.conv"),
    (r"mid_(\w+)/(\w+)", "mid.{0}.{1}"),
)


def ddpm_module_to_torch(module: str) -> str:
    """A JAX ``ConditionalUNet`` module path → the reference
    ``Conditional_Model`` module name (``export_ddpm_unet``'s map)."""
    for pattern, fmt in _DDPM_MODULES:
        m = re.fullmatch(pattern, module)
        if m:
            return fmt.format(*m.groups())
    raise KeyError(module)


def ddpm_module_to_jax(module: str) -> str:
    """Inverse of :func:`ddpm_module_to_torch` (``import_ddpm_unet``)."""
    p = module.split(".")
    if p[0] in ("temb", "cemb"):
        return f"{p[0]}_dense{p[2]}"
    if p[0] in ("classes_emb", "conv_in", "conv_out", "norm_out"):
        return p[0]
    if p[0] in ("down", "up") and p[2] in ("block", "attn"):
        return f"{p[0]}_{p[1]}_{p[2]}_{p[3]}/{p[4]}"
    if p[0] in ("down", "up") and p[2] in ("downsample", "upsample"):
        return f"{p[0]}_{p[1]}_{p[2]}/conv"
    if p[0] == "mid":
        return f"mid_{p[1]}/{p[2]}"
    raise KeyError(module)


def _ddpm_from_jax(tree, dtype=None) -> Dict[str, torch.Tensor]:
    out = {}
    for path, v in _flatten(tree).items():
        arr = np.asarray(v, dtype)
        if path == "null_classes_emb":
            out[path] = _to_torch(arr)
            continue
        mod, leaf = path.rsplit("/", 1)
        tleaf, arr = (("weight", arr) if leaf == "embedding"
                      else _leaf_to_torch(arr, leaf))
        out[f"{ddpm_module_to_torch(mod)}.{tleaf}"] = _to_torch(arr)
    return out


def ddpm_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``ConditionalUNet`` params (numpy tree) → the port's state dict:
    conv HWIO → OIHW, Dense kernel → ``.T``, GroupNorm ``scale`` →
    ``weight``, Embed ``embedding`` → ``weight``."""
    return _ddpm_from_jax(params)


def ddpm_mask_from_jax(mask_tree) -> Dict[str, torch.Tensor]:
    """A JAX DDPM mask tree → ``{torch name: fp32 0/1 tensor}``, the
    reference ``with_{t}.pt`` format."""
    return _ddpm_from_jax(mask_tree, np.float32)


def ddpm_mask_to_jax(mask: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`ddpm_mask_from_jax`: a nested dict of fp32 numpy
    arrays in the JAX layout."""
    flat = {}
    for name, t in mask.items():
        arr = t.detach().cpu().numpy().astype(np.float32)
        if name == "null_classes_emb":
            flat[name] = arr
            continue
        module, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            if module == "classes_emb":
                leaf = "embedding"
            elif arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        flat[f"{ddpm_module_to_jax(module)}/{leaf}"] = np.ascontiguousarray(arr)
    return _unflatten(flat)


def _strip_module(sd: dict) -> dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_ddpm_states(path: str):
    """A DDPM ``ckpt.pth``, the list ``[model_sd, optim_sd, step,
    (ema_sd)]`` (runners/diffusion.py:252-265) → ``(model_sd, step,
    ema_sd or None)``, ``module.`` prefixes stripped."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    step = int(states[2]) if len(states) > 2 else 0
    ema_sd = _strip_module(states[3]) if len(states) > 3 else None
    return _strip_module(states[0]), step, ema_sd


def save_ddpm_states(path: str, model_sd: dict, optim_sd=None, step: int = 0,
                     ema_sd=None) -> None:
    """Write ``[model_sd, optim_sd, step, (ema_sd)]``, on the CPU."""
    def cpu(sd):
        return {k: v.detach().cpu() for k, v in sd.items()}

    states = [cpu(model_sd), optim_sd or {}, int(step)]
    if ema_sd is not None:
        states.append(cpu(ema_sd))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(states, path)
