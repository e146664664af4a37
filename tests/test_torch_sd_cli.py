"""The port's SD CLIs on the CPU (``--device cpu``), chained as a user runs
them: ``salun_torch.cli.sd_train generate_mask`` → ``random_label
--mask_path`` → ``salun_torch.cli.sd_generate_images``, on a tiny yaml
(U-Net ch 32, VAE ch 32; the yaml cannot shrink CLIP, so the text encoder
runs at full width, as in ``tests/test_sd_config.py``), a seeded
checkpoint and a synthetic ``imagenette2/train`` folder of non-square
PNGs. The files it writes are read back by the JAX package: the mask
``.pt`` by ``salun.cli.sd_train.load_unet_mask``, ``compvis.ckpt`` by
``salun.sd.import_compvis``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from _torch_port import write_tiny_imagenette, write_tiny_sd
from salun.cli.sd_train import load_unet_mask
from salun.sd import import_compvis
from salun.sd.config import modules_from_yaml
from salun_torch.ckpt import (load_compvis_state_dict, load_sd_mask,
                              sd_mask_to_jax)
from salun_torch.cli import sd_generate_images, sd_train


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sd_cli")
    cfg_path, ckpt = write_tiny_sd(tmp)
    write_tiny_imagenette(tmp, np.random.default_rng(0))
    common = ["--config", str(cfg_path), "--ckpt_path", str(ckpt),
              "--data", str(tmp / "data"), "--image_size", "64",
              "--batch_size", "2", "--device", "cpu"]
    masks = sd_train.main(["generate_mask", *common, "--num_samples", "2",
                           "--save_dir", str(tmp / "mask_out")])
    mask_file = tmp / "mask_out" / "mask" / "0" / "with_0.5.pt"
    result = sd_train.main(["random_label", *common, "--epochs", "2",
                            "--mask_path", str(mask_file), "--remat",
                            "--lr", "1e-4", "--save_dir", str(tmp / "rl")])
    csv = tmp / "prompts.csv"
    csv.write_text("case_number,prompt,evaluation_seed\n"
                   "0,an image of a tench,42\n3,the cat,7\n")
    stats = sd_generate_images.main([
        "--prompts_path", str(csv), "--config", str(cfg_path),
        "--ckpt_path", str(tmp / "rl" / "compvis.ckpt"),
        "--save_path", str(tmp / "gen"), "--num_samples", "1",
        "--ddim_steps", "2", "--image_size", "64", "--guidance_scale", "3.0",
        "--device", "cpu"])
    return {"tmp": tmp, "cfg": cfg_path, "ckpt": ckpt, "mask_file": mask_file,
            "masks": masks, "result": result, "stats": stats}


def _jax_templates(cfg_path):
    modules = modules_from_yaml(str(cfg_path))
    return jax.eval_shape(lambda k: modules.init(k, image_size=8),
                          jax.random.PRNGKey(0))


def test_mask_is_exact_k_and_loads_in_jax(chain):
    mask = load_sd_mask(str(chain["mask_file"]))
    assert mask == {} or next(iter(mask.values())).dtype == torch.uint8
    n = sum(v.numel() for v in mask.values())
    assert sum(int(v.sum()) for v in mask.values()) == n // 2
    for k, v in chain["masks"]["masks"][0.5].items():
        assert torch.equal(mask[k], v)

    class Args:
        mask_path = str(chain["mask_file"])

    templates = _jax_templates(chain["cfg"])
    got = load_unet_mask(Args, templates["unet"])
    want = sd_mask_to_jax(mask)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        assert np.array_equal(np.asarray(leaf), flat_want[path]), path


def test_random_label_pins_masked_weights_and_exports_compvis(chain):
    losses = chain["result"]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    before = load_compvis_state_dict(str(chain["ckpt"]))
    after = load_compvis_state_dict(str(chain["tmp"] / "rl" / "compvis.ckpt"))
    assert set(before) == set(after)
    mask = load_sd_mask(str(chain["mask_file"]))
    moved = 0
    for k, v in after.items():
        if not k.startswith("model.diffusion_model."):
            assert torch.equal(v, before[k]), k  # VAE and CLIP frozen
            continue
        keep = mask[k[len("model.diffusion_model."):]] > 0
        assert torch.equal(v[~keep], before[k][~keep]), k
        moved += int((v[keep] != before[k][keep]).sum())
    assert moved > 0
    params = import_compvis({k: v.numpy() for k, v in after.items()},
                            _jax_templates(chain["cfg"]))
    assert set(params) == {"unet", "vae", "clip"}


def test_generate_images_writes_the_flat_layout(chain):
    stats = chain["stats"]
    assert sorted(os.listdir(chain["tmp"] / "gen")) == ["0_0.png", "3_0.png"]
    assert stats["images"] == 2 and stats["finite"]
    assert 0.0 <= stats["min"] <= stats["max"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["gradient_ascent", "--dp", "2"], ["proximal", "--fsdp"],
    ["nsfw_removal", "--dp", "2"], ["esd", "--prompt", "x", "--fsdp"],
    ["random_label", "--cache_vae_moments", "--dp", "2"],
    ["random_label", "--dp", "2"], ["random_label", "--fsdp"]],
    ids=" ".join)
def test_unported_subcommands_and_flags_raise(argv):
    """--dp 2 raises ValueError outside a torchrun launch of 2 processes
    (salun_torch.dist.context), on any subcommand. --fsdp is ported and
    acts only with --dp (alone it changes nothing, as in JAX), so its cases
    run with --dp 2 and raise the same; tests/test_torch_dp_cli.py runs
    --dp 2 --fsdp under torchrun."""
    dp = [] if "--dp" in argv else ["--dp", "2"]
    with pytest.raises(ValueError, match="torchrun"):
        sd_train.main(argv + dp + ["--device", "cpu"])
