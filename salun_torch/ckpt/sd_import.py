"""CompVis ``sd-v1-*.ckpt`` ↔ the port's SD modules, and the bridge to the
JAX package's SD params: counterpart of ``salun/sd/import_ckpt.py``.

The port's modules carry CompVis's (and, for CLIP, HF's) own names, so a
CompVis state dict loads by a prefix split and ``load_state_dict``:

- ``model.diffusion_model.*``                     → the U-Net
- ``first_stage_model.*``                         → the VAE
- ``cond_stage_model.transformer.*``              → CLIP (``position_ids``
  buffers and every other key, EMA included, are skipped)

:func:`sd_state_dict_from_jax` is the port's own copy of
``export_compvis`` (``salun/sd/import_ckpt.py:209-276``): JAX params
(nested dicts of numpy arrays, flax names, HWIO) → one CompVis state dict
of torch tensors (OIHW, ``weight.T``, GroupNorm ``scale`` → ``weight``).
:func:`sd_mask_from_jax` / :func:`sd_mask_to_jax` move U-Net masks the same
way. Mask files hold ``{"model.diffusion_model.<name>": uint8 0/1}``,
which ``salun.cli.sd_train.load_unet_mask`` reads.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from .torch_import import _flatten, _unflatten

PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
            "clip": "cond_stage_model.transformer."}


# ------------------------------------------------------------ checkpoints


def load_compvis_state_dict(path: str) -> dict:
    """The state dict of a CompVis ``.ckpt`` (``{"state_dict": ...}`` or a
    bare dict), memory-mapped. A real sd-v1 checkpoint carries training
    state beside the weights, so it is read with ``weights_only=False``:
    load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      mmap=True)
    return ckpt.get("state_dict", ckpt)


def load_sd_modules(sd, state_dict: dict) -> None:
    """Load a CompVis state dict into an ``SDModules``, strictly per part,
    by its prefixes; other keys (EMA, schedule buffers, ``position_ids``)
    are dropped."""
    for part, prefix in PREFIXES.items():
        getattr(sd, part).load_state_dict(
            {k[len(prefix):]: v for k, v in state_dict.items()
             if k.startswith(prefix) and "position_ids" not in k},
            strict=True)


def compvis_state_dict(sd) -> dict:
    """The ``SDModules``' weights under CompVis keys, on the CPU."""
    return {prefix + k: v.detach().cpu()
            for part, prefix in PREFIXES.items()
            for k, v in getattr(sd, part).state_dict().items()}


def save_compvis(path: str, sd) -> None:
    """``{"state_dict": ...}``, as random_label.py's save_model and
    ``salun.sd.import_compvis`` read it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": compvis_state_dict(sd)}, path)


# ------------------------------------------------------------ masks


def save_sd_mask(path: str, mask: Dict[str, torch.Tensor]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({PREFIXES["unet"] + k: v.detach().to("cpu", torch.uint8)
                for k, v in mask.items()}, path)


def load_sd_mask(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """A U-Net mask ``.pt`` → ``{U-Net parameter name: 0/1 tensor}``."""
    md = torch.load(path, map_location="cpu", weights_only=True)
    return {k.split(PREFIXES["unet"])[-1]: v.to(device)
            for k, v in md.items()}


# ------------------------------------------------------------ from JAX


def _leaf_to_torch(name: str, arr):
    """flax leaf name and layout → torch (weight/bias) name and layout."""
    arr = np.asarray(arr)
    for flax_leaf in ("/kernel", "/scale", "/embedding"):
        if name.endswith(flax_leaf):
            base = name[: -len(flax_leaf)] + "/weight"
            if flax_leaf == "/kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            return base, arr
    return name, arr


def _unet_name(name: str) -> str:
    """``input_blocks_4_1/transformer_blocks_0/ff/net_0_proj/weight`` →
    ``input_blocks.4.1.transformer_blocks.0.ff.net.0.proj.weight``."""
    name = name.replace("/", ".")
    name = re.sub(r"(input_blocks|output_blocks)_(\d+)_(\d+)\.",
                  r"\1.\2.\3.", name)
    name = re.sub(r"middle_block_(\d+)\.", r"middle_block.\1.", name)
    name = re.sub(r"transformer_blocks_(\d+)\.", r"transformer_blocks.\1.",
                  name)
    for a, b in (("in_layers_0", "in_layers.0"), ("in_layers_2", "in_layers.2"),
                 ("emb_layers_1", "emb_layers.1"),
                 ("out_layers_0", "out_layers.0"),
                 ("out_layers_3", "out_layers.3"), ("to_out_0", "to_out.0"),
                 ("ff.net_0_proj", "ff.net.0.proj"), ("ff.net_2", "ff.net.2")):
        name = name.replace(a, b)
    name = re.sub(r"time_embed_(\d+)", r"time_embed.\1", name)
    return re.sub(r"^out_(\d+)", r"out.\1", name)


def _vae_name(name: str) -> str:
    name = re.sub(r"(encoder|decoder)/(down|up)_(\d+)_block_(\d+)/",
                  r"\1/\2/\3/block/\4/", name)
    name = re.sub(r"(encoder|decoder)/(down|up)_(\d+)_(downsample|upsample)",
                  r"\1/\2/\3/\4/conv", name)
    name = re.sub(r"(encoder|decoder)/mid_(block_\d+|attn_1)/",
                  r"\1/mid/\2/", name)
    return name.replace("/", ".")


def _clip_name(name: str) -> str:
    if name == "position_embedding/weight":
        return "text_model.embeddings.position_embedding.weight"
    name = re.sub(r"^layers_(\d+)/", r"encoder/layers/\1/", name)
    if name.startswith("token_embedding"):
        name = "embeddings/" + name
    return "text_model." + name.replace("/", ".")


_RENAME = {"unet": _unet_name, "vae": _vae_name, "clip": _clip_name}


def _torch_part(part: str, tree) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in _flatten(tree).items():
        if part == "clip" and k == "position_embedding":  # a bare leaf
            k = "position_embedding/embedding"
        name, arr = _leaf_to_torch(k, v)
        out[_RENAME[part](name)] = arr
    return out


def sd_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``{"unet", "vae", "clip"}`` params → one CompVis-keyed state
    dict (the names ``salun.sd.import_ckpt.export_compvis`` gives)."""
    return {PREFIXES[part] + k: torch.from_numpy(
                np.ascontiguousarray(v, dtype=np.float32))
            for part in PREFIXES if part in params
            for k, v in _torch_part(part, params[part]).items()}


def sd_mask_from_jax(mask_tree) -> Dict[str, torch.Tensor]:
    """A JAX U-Net mask pytree (or any U-Net-shaped tree) →
    ``{CompVis name: tensor}`` in torch layout, of the tree's dtype."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in _torch_part("unet", mask_tree).items()}


def _jax_unet_path(name: str) -> str:
    """CompVis U-Net module path → flax path (``map_unet_key``)."""
    k = re.sub(r"^(input_blocks|output_blocks)\.(\d+)\.(\d+)$", r"\1_\2_\3",
               name)
    k = re.sub(r"^(input_blocks|output_blocks)\.(\d+)\.(\d+)\.",
               r"\1_\2_\3/", k)
    k = re.sub(r"^middle_block\.(\d+)\.", r"middle_block_\1/", k)
    k = re.sub(r"^time_embed\.(\d+)$", r"time_embed_\1", k)
    k = re.sub(r"^out\.(\d+)$", r"out_\1", k)
    for a, b in (("in_layers.0", "in_layers_0"), ("in_layers.2", "in_layers_2"),
                 ("emb_layers.1", "emb_layers_1"),
                 ("out_layers.0", "out_layers_0"),
                 ("out_layers.3", "out_layers_3")):
        k = k.replace(a, b)
    k = re.sub(r"transformer_blocks\.(\d+)\.", r"transformer_blocks_\1/", k)
    k = k.replace("to_out.0", "to_out_0")
    k = k.replace("ff.net.0.proj", "ff/net_0_proj")
    k = k.replace("ff.net.2", "ff/net_2")
    return k.replace(".", "/")


def sd_mask_to_jax(mask: Dict[str, torch.Tensor], dtype=np.int8) -> dict:
    """``{CompVis U-Net name: 0/1 tensor}`` → a JAX mask pytree of int8
    (flax names, HWIO), as ``load_unet_mask`` builds it; any U-Net-shaped
    dict (weights) with another ``dtype``."""
    flat = {}
    for name, t in mask.items():
        base, leaf = name.rsplit(".", 1)
        path = _jax_unet_path(base)
        v = t.detach().cpu().numpy().astype(dtype)
        if leaf == "bias":
            flat[path + "/bias"] = v
        elif v.ndim == 4:
            flat[path + "/kernel"] = v.transpose(2, 3, 1, 0)
        elif v.ndim == 2:
            flat[path + "/kernel"] = v.T
        else:
            flat[path + "/scale"] = v
    return _unflatten(flat)
