"""The port's other DDPM sample modes, image folders, the FID reference set
and the checkpoint registry against ``salun``: the denoising trajectory
(``sample_trajectory``) and the class grid with JAX's draws injected,
``image_folder_dataset``, ``save_base_dataset`` and the two
``ddpm_save_base`` CLIs on the same data, ``diffusion.ckpt_util`` on a
temporary file, and every ``ddpm_sample`` mode through the CLI.

Tolerances: the trajectory 1e-4 absolute on images in [0, 1] (fp32 U-Net
forwards agree to ~1e-5 of their outputs, ``tests/test_torch_ddpm.py``;
five DDIM steps scale that by 1/√ᾱ ≤ 1.3 a step); images, folders and
file names exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from _torch_port import ddpm_twin, nchw, perturb_vectors
from _torch_port import one_torch_thread  # noqa: F401
from salun.cli import ddpm_sample as jax_sample_cli
from salun.cli import ddpm_save_base as jax_save_base_cli
from salun.data import ddpm_data as jax_ddpm_data
from salun.data.datasets import synthetic as jax_synthetic
from salun.diffusion import DiffusionSchedule as JaxSchedule
from salun.diffusion import UNetConfig as JaxUNetConfig
from salun.diffusion import ckpt_util as jax_ckpt_util
from salun.diffusion.runner import DDPMRunner as JaxRunner
from salun.diffusion.runner import DDPMTrainConfig as JaxTrainConfig
from salun_torch.cli import ddpm_sample, ddpm_save_base, ddpm_train
from salun_torch.data import ddpm_data
from salun_torch.data.datasets import synthetic
from salun_torch.diffusion import DiffusionSchedule, ckpt_util
from salun_torch.diffusion.runner import DDPMRunner, DDPMTrainConfig
from salun_torch.diffusion.unet import UNetConfig

TINY = JaxUNetConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), dropout=0.0, in_channels=3,
                     image_size=16, n_classes=4, cond_drop_prob=0.0)
T, STEPS = 50, 5


@pytest.fixture(scope="module")
def params():
    runner = JaxRunner(TINY, JaxSchedule.create(num_diffusion_timesteps=T),
                       JaxTrainConfig())
    init = jax.tree.map(np.asarray, runner.init(jax.random.PRNGKey(0)))
    return perturb_vectors(init, np.random.default_rng(1))


@pytest.mark.parametrize("sample_type", ["generalized", "ddpm_noisy"])
def test_trajectory_matches_jax(params, sample_type):
    classes = [0, 3, 1]
    jax_r = JaxRunner(TINY, JaxSchedule.create(num_diffusion_timesteps=T),
                      JaxTrainConfig(cond_scale=2.0))
    key = jax.random.PRNGKey(2)
    want_xs, want_x0s = jax_r.sample_trajectory(
        jax.tree.map(jnp.asarray, params), key, classes=classes,
        sample_type=sample_type, timesteps=STEPS)

    # sample_image's draws: key, nk = split(key) for x_T, then one
    # split of the chain's key a step for its noise
    key, nk = jax.random.split(key)
    shape = (len(classes), 16, 16, 3)
    x_T = nchw(np.asarray(jax.random.normal(nk, shape)))
    noise = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        noise.append(nchw(np.asarray(jax.random.normal(sub, shape))))
    port_r = DDPMRunner(UNetConfig(**{f.name: getattr(TINY, f.name)
                                      for f in dataclasses.fields(
                                          UNetConfig)}),
                        DiffusionSchedule.create(num_diffusion_timesteps=T),
                        DDPMTrainConfig(cond_scale=2.0))
    xs, x0s = port_r.sample_trajectory(
        ddpm_twin(TINY, params), classes=classes, sample_type=sample_type,
        timesteps=STEPS, x_T=x_T, noise=noise)
    assert xs.shape == x0s.shape == (STEPS, 3, 3, 16, 16)
    for got, want in ((xs, want_xs), (x0s, want_x0s)):
        np.testing.assert_allclose(got.movedim(2, -1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-4)


def test_grid_png_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    imgs = rng.random((7, 5, 6, 3)).astype(np.float32) * 1.2 - 0.1
    jax_sample_cli._save_grid(imgs, str(tmp_path / "jax.png"), 3)
    ddpm_sample.save_grid(nchw(imgs), str(tmp_path / "port.png"), 3)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == (15, 18, 3)
    np.testing.assert_array_equal(got, want)


def _write_images(folder, names, rng, size=(20, 14), mode="RGB"):
    os.makedirs(folder, exist_ok=True)
    for name in names:
        arr = rng.integers(0, 256, (size[1], size[0], 4)).astype(np.uint8)
        Image.fromarray(arr, "RGBA").convert(mode).save(
            os.path.join(folder, name))


@pytest.mark.parametrize("image_size", [None, 8])
def test_image_folder_dataset_matches_jax(tmp_path, image_size):
    rng = np.random.default_rng(4)
    root = tmp_path / "class_samples"
    for cls, mode in (("0", "RGB"), ("3", "L"), ("10", "RGBA")):
        _write_images(root / cls, ["10.png", "2.png", "1.png"], rng,
                      mode=mode)
    flat = tmp_path / "flat"
    _write_images(flat, ["b.png", "10.png", "a.png", "2.png"], rng)
    for folder, kw in ((root, {}), (flat, {"label": 5})):
        got = ddpm_data.image_folder_dataset(str(folder), image_size, **kw)
        want = jax_ddpm_data.image_folder_dataset(str(folder), image_size,
                                                  **kw)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.targets, want.targets)
        assert got.num_classes == want.num_classes
    # "10.png" comes before "2.png", and class 10 before class 3
    got = ddpm_data.image_folder_dataset(str(root), image_size)
    assert got.targets.tolist() == [0] * 3 + [10] * 3 + [3] * 3
    if image_size is None:
        for i, name in enumerate(["1.png", "10.png", "2.png"]):
            np.testing.assert_array_equal(got.data[i], np.asarray(
                Image.open(root / "0" / name).convert("RGB")))
    remember = ddpm_data.all_but_one_class_dataset(got, 3)
    assert sorted(set(remember.targets)) == [0, 10]


def test_save_base_dataset_and_cli_match_jax(tmp_path):
    got = ddpm_data.save_base_dataset(synthetic(n=80, seed=1), 2, 3)
    want = jax_ddpm_data.save_base_dataset(jax_synthetic(n=80, seed=1), 2, 3)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert 2 not in set(got.targets) and len(got) == 27

    args = ["--dataset", "synthetic", "--label_to_forget", "4",
            "--per_class", "2"]
    ddpm_save_base.main(args + ["--save_dir", str(tmp_path / "port")])
    jax_save_base_cli.main(args + ["--save_dir", str(tmp_path / "jax")])

    def listing(root):
        return sorted((d, f) for d in os.listdir(root)
                      for f in os.listdir(os.path.join(root, d)))

    files = listing(tmp_path / "port")
    assert files == listing(tmp_path / "jax") and len(files) == 18
    assert "4" not in {d for d, _ in files}
    for d, f in files:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / d / f)),
            np.asarray(Image.open(tmp_path / "jax" / d / f)))


@pytest.mark.parametrize("case", ["match", "mismatch", "missing"])
def test_ckpt_util_checks_local_files_as_jax(tmp_path, monkeypatch, case):
    for name in ("URL_MAP", "CKPT_MAP", "MD5_MAP"):
        assert getattr(ckpt_util, name) == getattr(jax_ckpt_util, name)
    path = tmp_path / ckpt_util.CKPT_MAP["ema_cifar10"]
    if case != "missing":
        path.parent.mkdir(parents=True)
        path.write_bytes(b"not a real checkpoint\n" * 1000)
        digest = ckpt_util.md5_hash(str(path))
        assert digest == jax_ckpt_util.md5_hash(str(path))
        if case == "match":
            for mod in (ckpt_util, jax_ckpt_util):
                monkeypatch.setitem(mod.MD5_MAP, "ema_cifar10", digest)
    for mod in (ckpt_util, jax_ckpt_util):
        if case == "match":
            assert mod.get_ckpt_path("ema_cifar10", str(tmp_path),
                                     check=True) == str(path)
        elif case == "mismatch":
            assert mod.get_ckpt_path("ema_cifar10", str(tmp_path)) == str(
                path)
            with pytest.raises(ValueError, match="md5"):
                mod.get_ckpt_path("ema_cifar10", str(tmp_path), check=True)
        else:
            with pytest.raises(FileNotFoundError, match="heibox"):
                mod.get_ckpt_path("ema_cifar10", str(tmp_path))


SAMPLE_YML = """
data:
  dataset: synthetic
  image_size: 16
  channels: 3
  n_classes: 10
model:
  ch: 32
  ch_mult: [1, 2]
  num_res_blocks: 1
  attn_resolutions: [8]
  dropout: 0.0
  cond_drop_prob: 0.1
diffusion:
  num_diffusion_timesteps: 20
training:
  n_iters: 1
sampling:
  cond_scale: 2.0
"""


def test_every_sample_mode_through_the_cli(tmp_path):
    cfg = tmp_path / "tiny_sample.yml"
    cfg.write_text(SAMPLE_YML)
    base = tmp_path / "base"
    ddpm_train.main(["--config", str(cfg), "--mode", "train", "--device",
                     "cpu", "--save_dir", str(base), "--data", "unused"])
    common = ["--config", str(cfg), "--ckpt_folder", str(base), "--device",
              "cpu", "--timesteps", "4", "--classes", "1,3"]
    out = {}
    for mode in ("sample", "sample_fid", "sample_visualization",
                 "sample_trajectory"):
        out[mode] = ddpm_sample.main(common + [
            "--mode", mode, "--save_dir", str(tmp_path / mode),
            "--n_samples_per_class", "3", "--batch", "2"])
        assert out[mode]["finite"]
        assert 0.0 <= out[mode]["min"] <= out[mode]["max"] <= 1.0
    for mode in ("sample", "sample_fid"):
        assert sorted(os.listdir(tmp_path / mode)) == ["1", "3"]
        assert sorted(os.listdir(tmp_path / mode / "3")) == [
            "0.png", "1.png", "2.png"]
    grid = np.asarray(Image.open(tmp_path / "sample_visualization" /
                                 "grid.png"))
    assert grid.shape == (10 * 16, 10 * 16, 3)  # 10 a class, 10 columns
    traj = np.load(tmp_path / "sample_trajectory" / "trajectory.npz")
    assert sorted(traj.files) == ["classes", "x0_preds", "xs"]
    assert traj["xs"].shape == traj["x0_preds"].shape == (4, 2, 16, 16, 3)
    assert traj["classes"].tolist() == [1, 3]
