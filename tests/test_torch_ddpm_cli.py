"""The port's DDPM CLIs on the CPU (``--device cpu``), as a user runs
them: ``ddpm_train --mode generate_mask`` → ``--mode saliency_unlearn
--method rl`` → ``ddpm_sample --mode sample_classes`` on a tiny synthetic
config (as ``tests/test_ddpm_cli.py`` runs the JAX ones). Their artifacts
cross to the JAX package: the ``.pt`` mask through the JAX CLI's own
``.pt`` path (``import_ddpm_unet``), the ``ckpt.pth`` through
``load_ddpm_states``. Also: the config reader against
``salun.cli.ddpm_config`` on every ``configs/ddpm`` file, and the PNG
writer."""

import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from salun.cli.ddpm_config import load_config as jax_load_config
from salun.ckpt import import_ddpm_unet, load_ddpm_states
from salun.ckpt.torch_import import strip_module_prefix
from salun.diffusion.runner import DDPMRunner as JaxRunner
from salun_torch.ckpt import ddpm_mask_to_jax, load_mask
from salun_torch.cli import ddpm_sample, ddpm_train
from salun_torch.cli.ddpm_config import load_config
from salun_torch.diffusion.runner import DDPMRunner

ROOT = Path(__file__).resolve().parents[1]

TINY_YML = """
# a tiny CIFAR-shaped run: comments, flow lists, two-level mappings
data:
  dataset: synthetic
  image_size: 32
  channels: 3
  n_classes: 10
model:
  ch: 32
  out_ch: 3
  ch_mult: [1, 2]
  num_res_blocks: 1
  attn_resolutions: [16]
  dropout: 0.1
  cond_drop_prob: 0.1
  var_type: fixedlarge
  ema: false
diffusion:
  beta_schedule: linear
  beta_start: 0.0001
  beta_end: 0.02
  num_diffusion_timesteps: 20
training:
  n_iters: 2
  batch_size: 16
  snapshot_freq: 100
  log_freq: 1
  alpha: 0.001
  method: rl
optim:
  lr: 0.0001
  grad_clip: 1.0
sampling:
  cond_scale: 2.0
"""


@pytest.fixture
def tiny_config(tmp_path):
    p = tmp_path / "tiny.yml"
    p.write_text(TINY_YML)
    return str(p)


def test_mask_unlearn_sample_chain_on_cpu(tiny_config, tmp_path):
    common = ["--config", tiny_config, "--label_to_forget", "0",
              "--device", "cpu", "--seed", "3"]
    masks = ddpm_train.main(common + ["--mode", "generate_mask",
                                      "--save_dir", str(tmp_path / "m")])
    mask_file = tmp_path / "m" / "mask" / "0" / "with_0.5.pt"
    mask = load_mask(str(mask_file))
    n = sum(v.numel() for v in mask.values())
    assert sum(int(v.sum()) for v in mask.values()) == n // 2
    assert all(torch.equal(mask[k], masks[0.5][k]) for k in mask)

    # the JAX CLI's .pt mask path reads the port's mask
    # (salun/cli/ddpm_train.py:126-139)
    bundle = jax_load_config(tiny_config)
    template = JaxRunner(bundle.unet, bundle.schedule, bundle.train).init(
        jax.random.PRNGKey(0))
    md = torch.load(mask_file, map_location="cpu", weights_only=False)
    via_jax = import_ddpm_unet(
        {k: v.float() for k, v in strip_module_prefix(md).items()}, template)
    for a, b in zip(jax.tree.leaves(via_jax),
                    jax.tree.leaves(ddpm_mask_to_jax(mask))):
        np.testing.assert_array_equal(np.asarray(a), b)

    result = ddpm_train.main(common + [
        "--mode", "saliency_unlearn", "--method", "rl",
        "--mask_path", str(mask_file), "--save_dir", str(tmp_path / "u")])
    assert len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))

    # masked-out weights stayed at θ₀ (the U-Net seeded with --seed);
    # some kept weight moved
    port = load_config(tiny_config)
    theta0 = DDPMRunner(port.unet, port.schedule, port.train).init(
        3).state_dict()
    ckpt = tmp_path / "u" / "ckpts" / "ckpt.pth"
    sd, step, ema = load_ddpm_states(str(ckpt))  # the JAX package's reader
    assert step == 2 and ema is None
    moved = 0
    for k, m in mask.items():
        after = torch.as_tensor(np.asarray(sd[k]))
        assert torch.equal(after[m == 0], theta0[k][m == 0]), k
        moved += int((after[m > 0] != theta0[k][m > 0]).sum())
    assert moved > 0
    import_ddpm_unet(sd, template)  # the reference format loads in JAX

    stats = ddpm_sample.main([
        "--config", tiny_config, "--mode", "sample_classes",
        "--ckpt_folder", str(tmp_path / "u"), "--classes", "x0,1,2,3,4,5,6",
        "--n_samples_per_class", "3", "--batch", "2", "--timesteps", "4",
        "--save_dir", str(tmp_path / "s"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "s")) == ["7", "8", "9"]
    assert stats["images"] == 9 and stats["finite"]
    assert 0.0 <= stats["min"] <= stats["max"] <= 1.0
    img = Image.open(tmp_path / "s" / "9" / "2.png")
    assert img.size == (32, 32) and img.mode == "RGB"


@pytest.mark.parametrize("path", sorted((ROOT / "configs" / "ddpm")
                                        .glob("*.yml")), ids=lambda p: p.name)
def test_config_reader_matches_jax(path):
    overrides = dict(alpha=0.25, method="ga", cond_scale=3.0, n_iters=7)
    want = jax_load_config(str(path), **overrides)
    got = load_config(str(path), **overrides)
    assert got.dataset == want.dataset and got.raw == want.raw
    for f in dataclasses.fields(got.unet):
        assert getattr(got.unet, f.name) == getattr(want.unet, f.name), f.name
    assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train)
    for name in ("betas", "alphas_cumprod", "logvar"):
        np.testing.assert_array_equal(getattr(got.schedule, name).numpy(),
                                      getattr(want.schedule, name))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (17, 23, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    ddpm_sample.write_png(path, img[..., 0] if channels == 1 else img)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


@pytest.mark.parametrize("mode", ["train_esd"])
def test_unported_train_modes_raise(tiny_config, tmp_path, mode):
    """The reference dispatches a ``train_esd`` it does not have; the port
    raises, as JAX does."""
    with pytest.raises(NotImplementedError):
        ddpm_train.main(["--config", tiny_config, "--mode", mode,
                         "--device", "cpu", "--save_dir", str(tmp_path)])


def test_ddpm_cli_refuses_a_missing_card(tiny_config, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddpm_train.main(["--config", tiny_config, "--mode", "generate_mask",
                         "--save_dir", str(tmp_path)])
