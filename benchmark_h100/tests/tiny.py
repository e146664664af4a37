"""Tiny configurations of the benchmark's cells, for CPU tests."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def sd_config():
    cfg = load("configs", "sd-v1-4.json")
    cfg["unet"].update(model_channels=32, attention_resolutions=[1, 2],
                       channel_mult=[1, 2], num_heads=2, num_res_blocks=1,
                       context_dim=64)
    cfg["vae"].update(ch=32, ch_mult=[1, 1, 1, 1], num_res_blocks=1)
    cfg["clip"].update(hidden_size=64, num_layers=2, num_heads=2)
    return cfg


def ddpm_config():
    cfg = load("configs", "ddpm-cifar10.json")
    cfg["model"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1)
    cfg["data"]["image_size"] = 16
    cfg["model"]["attn_resolutions"] = [8]
    cfg["training"]["batch_size"] = 8
    return cfg


def traffic(name, **changes):
    t = copy.deepcopy(load("traffic", f"{name}.json"))
    t.update(changes)
    return t


CELLS = {
    "sd-salun-rl": (sd_config, "salun_rl_sd_4x4",
                    dict(forget_batch=2, remain_batch=2, image_size=32,
                         mask_images=4, trace_units=1)),
    "ddpm-salun-rl": (ddpm_config, "salun_rl_ddpm_128x128",
                      dict(per_class=12, trace_units=1)),
    "sd-ddim-sample": (sd_config, "ddim100_cfg_10img",
                       dict(images=4, image_size=32, steps=4,
                            check_images=2, trace_units=1)),
}


def files(cell, **traffic_changes):
    make_cfg, name, changes = CELLS[cell]
    changes = dict(changes, **traffic_changes)
    return {"cell": {"name": cell, "chips": 1}, "config": make_cfg(),
            "traffic": traffic(name, **changes),
            "limits": load("limits", f"{cell}.json")}
