"""STL-10 at 64×64 in the port against ``salun``: the binary reader
against ``salun.data.ddpm_data._stl10`` on synthetic files, the PIL
bilinear resize byte for byte, the attention's gradient at D = 512 (the
STL-10 U-Net's mid block: ``ch_mult [1, 2, 2, 2, 4]`` at 4×4, 16 tokens of
512 channels) against torch autograd of the plain math, also under
``vmap(grad)``, and the STL-10 config's shape through ``ddpm_train`` at a
small width.

Tolerances: data and resize exactly; the attention's gradients 1e-5 (the
plain K2/K3a/K3b versions against autograd of the same fp32 math, as
``tests/test_torch_attention.py`` holds them at narrower heads).
"""

import os

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from salun.data import ddpm_data as jax_ddpm_data
from salun_torch.cli import ddpm_train
from salun_torch.data import ddpm_data
from salun_torch.kernels import flash_attention as fa
from salun_torch.kernels.attention import scaled_dot_attention


def write_stl10(data_dir, images, labels, split="train"):
    """NHWC uint8 images and 0-based labels in STL-10's binary layout:
    each image CHW with every channel stored column-major, labels 1…10."""
    base = os.path.join(data_dir, "stl10_binary")
    os.makedirs(base, exist_ok=True)
    np.ascontiguousarray(images.transpose(0, 3, 2, 1)).tofile(
        os.path.join(base, f"{split}_X.bin"))
    (labels + 1).astype(np.uint8).tofile(os.path.join(base,
                                                      f"{split}_y.bin"))


@pytest.fixture
def stl_dir(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (12, 96, 96, 3)).astype(np.uint8)
    labels = np.arange(12) % 10
    write_stl10(str(tmp_path), images, labels)
    write_stl10(str(tmp_path), images[:3], labels[:3], split="test")
    return tmp_path, images, labels


@pytest.mark.parametrize("train", [True, False])
def test_stl10_reader_matches_jax(stl_dir, train):
    root, images, labels = stl_dir
    got = ddpm_data.stl10(str(root), train)
    want = jax_ddpm_data._stl10(str(root), train)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.targets, want.targets)
    n = 12 if train else 3
    np.testing.assert_array_equal(got.data, images[:n])
    assert got.targets.tolist() == labels[:n].tolist()
    assert got.data.flags["C_CONTIGUOUS"]


def test_resize_to_64_is_byte_equal_to_jax(stl_dir):
    root, _, _ = stl_dir
    got = ddpm_data.get_dataset("stl10", str(root), image_size=64)
    want = jax_ddpm_data.get_dataset("stl10", str(root), image_size=64)
    assert got.data.shape == (12, 64, 64, 3) and got.data.dtype == np.uint8
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert ddpm_data.get_dataset("stl10", str(root)).data.shape[1] == 96


def _plain(q, k, v):
    return torch.softmax(q @ k.transpose(1, 2) * q.shape[-1] ** -0.5,
                         -1) @ v


def test_attention_gradient_at_d512_matches_autograd():
    gen = torch.Generator().manual_seed(1)
    b, n, d = 3, 16, 512
    q, k, v, w = (torch.randn(b, n, d, generator=gen) for _ in range(4))
    grads = []
    for fn in (scaled_dot_attention, _plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_per_sample_gradients_at_d512_under_vmap():
    """``vmap(grad)`` through the attention at D = 512 equals a loop of
    single-sample gradients of the plain math; on the CPU the wrappers
    count no launch."""
    gen = torch.Generator().manual_seed(2)
    d, n = 512, 16
    wq = torch.randn(d, 3 * d, generator=gen) * d ** -0.5
    x = torch.randn(4, 2, n, d, generator=gen)

    def loss(w, x, fn):
        q, k, v = (t.contiguous() for t in (x @ w).split(d, dim=-1))
        return fn(q, k, v).square().sum()

    before = [f.launches for f in (fa.flash_attention_fwd,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    got = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0, None))(
        wq, x, scaled_dot_attention)
    want = torch.stack([torch.func.grad(loss)(wq, xi, _plain) for xi in x])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert [f.launches for f in (fa.flash_attention_fwd,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == before


STL_YML = """
# configs/ddpm/stl10_train.yml's shape (64x64, ch_mult [1, 2, 2, 2, 4],
# attention at 16) at a small width
data:
  dataset: stl10
  image_size: 64
  random_flip: true
  channels: 3
  n_classes: 10
model:
  ch: 32
  ch_mult: [1, 2, 2, 2, 4]
  num_res_blocks: 1
  attn_resolutions: [16]
  dropout: 0.1
  cond_drop_prob: 0.1
  ema: true
  ema_rate: 0.9999
diffusion:
  num_diffusion_timesteps: 20
training:
  n_iters: 2
  batch_size: 4
  snapshot_freq: 100
  log_freq: 100
optim:
  lr: 0.0002
  grad_clip: 1.0
"""


def test_stl10_config_trains_and_masks_through_the_cli(stl_dir, tmp_path):
    root, _, _ = stl_dir
    cfg = tmp_path / "stl10_tiny.yml"
    cfg.write_text(STL_YML)
    common = ["--config", str(cfg), "--data", str(root), "--device", "cpu",
              "--label_to_forget", "0", "--seed", "4"]
    result = ddpm_train.main(common + ["--mode", "train", "--save_dir",
                                       str(tmp_path / "base")])
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    masks = ddpm_train.main(common + [
        "--mode", "generate_mask", "--ckpt_folder", str(tmp_path / "base"),
        "--save_dir", str(tmp_path / "mask")])
    n = sum(m.numel() for m in masks[0.5].values())
    assert sum(int(m.sum()) for m in masks[0.5].values()) == n // 2
