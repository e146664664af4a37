"""The SD U-Net's CompVis state dict ↔ a diffusers-format state dict
(counterpart of ``salun/sd/diffusers_export.py``; reference
``savemodelDiffusers``, SD/train-scripts/convertModels.py:1006+, the HF
CompVis→diffusers converter), so the reference's diffusers-based eval
stack (generate-images.py:75-85) loads an unlearned U-Net directly.

Key map (sd-v1: 4 levels × 2 res blocks, attention at levels 0-2):
  time_embed.0/2              → time_embedding.linear_1/linear_2
  input_blocks.0.0            → conv_in
  input_blocks.{1+3l+j}.0     → down_blocks.{l}.resnets.{j}
  input_blocks.{1+3l+j}.1     → down_blocks.{l}.attentions.{j}
  input_blocks.{3(l+1)}.0.op  → down_blocks.{l}.downsamplers.0.conv
  middle_block.0/1/2          → mid_block.resnets.0 / attentions.0 / resnets.1
  output_blocks.{3l+j}.0      → up_blocks.{l}.resnets.{j}
  output_blocks.{3l+j}.1      → up_blocks.{l}.attentions.{j} (or upsampler)
  out.0/out.2                 → conv_norm_out / conv_out
ResBlock leaves: in_layers.0→norm1, in_layers.2→conv1,
emb_layers.1→time_emb_proj, out_layers.0→norm2, out_layers.3→conv2,
skip_connection→conv_shortcut. Inside a transformer the CompVis names are
the diffusers ones already.

The port's tensors are torch-layout (OIHW convs, [out, in] linears), so
nothing is transposed: a key changes, its tensor does not.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

_RES_LEAF = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}
_FIXED = {
    "time_embed.0": "time_embedding.linear_1",
    "time_embed.2": "time_embedding.linear_2",
    "out.0": "conv_norm_out",
    "out.2": "conv_out",
    "input_blocks.0.0": "conv_in",
}


def diffusers_key(name: str, num_levels: int = 4, num_res_blocks: int = 2,
                  attn_levels=(0, 1, 2)) -> str:
    """The diffusers name of the CompVis U-Net parameter ``name``
    (``input_blocks.1.0.in_layers.0.weight`` →
    ``down_blocks.0.resnets.0.norm1.weight``)."""
    mod, leaf = name.rsplit(".", 1)
    per_level = num_res_blocks + 1  # res blocks + the resample slot
    if mod in _FIXED:
        return f"{_FIXED[mod]}.{leaf}"

    m = re.match(r"input_blocks\.(\d+)\.(\d+)(?:\.(.*))?$", mod)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3) or ""
        level, pos = (i - 1) // per_level, (i - 1) % per_level
        if rest.startswith("op"):
            return f"down_blocks.{level}.downsamplers.0.conv.{leaf}"
        if j == 0:
            return f"down_blocks.{level}.resnets.{pos}.{_RES_LEAF[rest]}.{leaf}"
        return f"down_blocks.{level}.attentions.{pos}.{rest}.{leaf}"

    m = re.match(r"middle_block\.(\d+)\.(.*)$", mod)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        if i == 1:
            return f"mid_block.attentions.0.{rest}.{leaf}"
        return (f"mid_block.resnets.{0 if i == 0 else 1}."
                f"{_RES_LEAF[rest]}.{leaf}")

    m = re.match(r"output_blocks\.(\d+)\.(\d+)(?:\.(.*))?$", mod)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3) or ""
        level, pos = i // per_level, i % per_level
        if j >= 1 and rest == "conv":  # the upsampler (j 1 or 2)
            return f"up_blocks.{level}.upsamplers.0.conv.{leaf}"
        if j == 0:
            return f"up_blocks.{level}.resnets.{pos}.{_RES_LEAF[rest]}.{leaf}"
        # up blocks run the levels in reverse
        if num_levels - 1 - level in attn_levels and j == 1:
            return f"up_blocks.{level}.attentions.{pos}.{rest}.{leaf}"
        return f"up_blocks.{level}.upsamplers.0.conv.{leaf}"
    raise KeyError(name)


def export_diffusers_unet(unet_state_dict: Dict[str, torch.Tensor],
                          num_levels: int = 4, num_res_blocks: int = 2,
                          attn_levels=(0, 1, 2)) -> Dict[str, torch.Tensor]:
    """CompVis-keyed U-Net state dict → diffusers-keyed, the same
    tensors."""
    out = {}
    for name, t in unet_state_dict.items():
        key = diffusers_key(name, num_levels, num_res_blocks, attn_levels)
        if key in out:
            raise KeyError(f"{name} and another parameter both map to {key}")
        out[key] = t
    return out


def save_diffusers_unet(unet_state_dict: Dict[str, torch.Tensor], path: str,
                        **layout) -> None:
    """Write a torch-loadable diffusers U-Net state dict; ``layout``
    (``num_levels``, ``num_res_blocks``, ``attn_levels``) defaults to
    sd-v1's."""
    sd = export_diffusers_unet(unet_state_dict, **layout)
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
               path)


def import_diffusers_unet(sd: Dict[str, torch.Tensor],
                          template: Dict[str, torch.Tensor],
                          num_levels: int = 4, num_res_blocks: int = 2,
                          attn_levels=(0, 1, 2)) -> Dict[str, torch.Tensor]:
    """diffusers U-Net state dict → CompVis-keyed state dict with the
    keys and shapes of ``template`` (the port's U-Net state dict): the
    reverse of :func:`export_diffusers_unet` (convertModels.py's loop
    closed, so a diffusers checkpoint can be trained or evaluated here)."""
    out = {}
    for name, t in template.items():
        key = diffusers_key(name, num_levels, num_res_blocks, attn_levels)
        if key not in sd:
            raise KeyError(f"diffusers ckpt missing {key} (for {name})")
        v = torch.as_tensor(sd[key])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)}, the U-Net's "
                             f"{name} has {tuple(t.shape)}")
        out[name] = v
    return out
