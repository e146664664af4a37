"""The port's other ``sd_train`` subcommands through the CLI on the CPU
(``--device cpu``) on the tiny yaml of ``tests/test_torch_sd_cli.py``
(CLIP full width), a seeded checkpoint, a synthetic ``imagenette2/train``
folder and two flat PNG folders: ``gradient_ascent``, ``proximal`` and
``nsfw_removal`` with a 0.5 mask, ``esd``, and ``--cache_vae_moments`` on
``random_label`` and ``nsfw_removal`` against the same runs uncached.

Checks: losses finite and one a step as the loops imply; masked-out
weights bitwise θ₀ and the VAE and CLIP unchanged in ``compvis.ckpt``;
proximal's shrink counts as ``proximal_ratio`` − the frozen count gives
them, with at least that many U-Net weights at θ₀ after each shrink;
ESD's teacher is not written and the student moved. The cached runs draw
the same numbers in the same order from the same generator, so their
losses equal the uncached runs' to 1e-6 relative (the cached moments come
from batches of other images, the same float operations per image).
"""

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from _torch_port import write_tiny_imagenette, write_tiny_sd
from salun_torch.ckpt import load_compvis_state_dict, save_sd_mask
from salun_torch.cli import sd_train
from salun_torch.cli.ddpm_sample import write_png
from salun_torch.sd.trainers import proximal_ratio

PREFIX = "model.diffusion_model."


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sd_train_cli")
    cfg, ckpt = write_tiny_sd(tmp)
    rng = np.random.default_rng(0)
    write_tiny_imagenette(tmp, rng)
    for name, n in (("nsfw", 4), ("not-nsfw", 3)):
        d = tmp / name
        d.mkdir()
        for i in range(n):
            write_png(str(d / f"{i}.png"),
                      rng.integers(0, 256, (80, 64, 3)).astype(np.uint8))
    before = load_compvis_state_dict(str(ckpt))
    mask = {k[len(PREFIX):]: torch.from_numpy(
                (rng.random(tuple(v.shape)) < 0.5).astype(np.uint8))
            for k, v in before.items() if k.startswith(PREFIX)}
    save_sd_mask(str(tmp / "mask.pt"), mask)
    common = ["--config", str(cfg), "--ckpt_path", str(ckpt), "--data",
              str(tmp / "data"), "--image_size", "64", "--batch_size", "2",
              "--lr", "1e-4", "--device", "cpu"]
    return {"tmp": tmp, "common": common, "before": before, "mask": mask}


def _run(setup, name, *argv, masked=True):
    out = setup["tmp"] / name
    extra = ["--mask_path", str(setup["tmp"] / "mask.pt")] if masked else []
    result = sd_train.main([*argv, *setup["common"], *extra,
                            "--save_dir", str(out)])
    return result, load_compvis_state_dict(str(out / "compvis.ckpt"))


def _pinned_and_moved(setup, after, masked=True):
    before, mask = setup["before"], setup["mask"]
    assert set(after) == set(before)
    moved = 0
    for k, v in after.items():
        if not k.startswith(PREFIX):
            assert torch.equal(v, before[k]), k  # VAE and CLIP frozen
            continue
        if masked:
            keep = mask[k[len(PREFIX):]] > 0
            assert torch.equal(v[~keep], before[k][~keep]), k
        moved += int((v != before[k]).sum())
    assert moved > 0


def _finite(result, steps):
    losses = result["losses"]
    assert len(losses) == steps and all(np.isfinite(losses)), losses


def test_gradient_ascent_cli(setup):
    result, after = _run(setup, "ga", "gradient_ascent", "--epochs", "1")
    _finite(result, 1)  # 2 forget images of class 0 at batch 2
    _pinned_and_moved(setup, after)


def test_proximal_cli(setup):
    before = setup["before"]
    n_unet = sum(v.numel() for k, v in before.items() if k.startswith(PREFIX))
    n_total = sum(v.numel() for k, v in before.items()
                  if "position_ids" not in k)
    n_frozen = n_total - n_unet
    # the full-width CLIP is ~98% of this model, so the schedule reaches
    # the tiny U-Net only near ratio 1: pick the one that shrinks 3/4 of
    # it at the first step, above the masked-out half that sits at θ₀
    # (1 forget and ceil(18 / 2) = 9 remain batches an epoch, so
    # (total − cur)/total = 0.9)
    mask_ratio = (n_frozen + 0.75 * n_unet) / (0.9 * n_total)
    result, after = _run(setup, "prox", "proximal", "--epochs", "1",
                         "--mask_ratio", repr(mask_ratio))
    _finite(result, 1)
    assert (result["n_total"], result["n_frozen"]) == (n_total, n_frozen)
    ratio = proximal_ratio(mask_ratio, 0, 0, 1, 9, 1, n_total) - n_frozen
    assert 0.7 * n_unet < ratio < 0.8 * n_unet
    [shrink] = result["shrinks"]
    assert shrink["ratio"] == ratio and shrink["tau"] > 0
    assert shrink["pinned"] >= ratio
    _pinned_and_moved(setup, after)
    pinned = sum(int((v == before[k]).sum()) for k, v in after.items()
                 if k.startswith(PREFIX))
    assert pinned == shrink["pinned"]


def test_esd_cli(setup):
    result, after = _run(setup, "esd", "esd", "--prompt", "nudity, a cat",
                         "--iterations", "2", "--ddim_steps", "4",
                         "--train_method", "xattn", masked=False)
    _finite(result, 2)
    assert all(0 <= t < 4 for t in result["t_enc"])
    _pinned_and_moved(setup, after, masked=False)
    for k, v in after.items():  # xattn: only attn2 moved
        if k.startswith(PREFIX) and "attn2" not in k:
            assert torch.equal(v, setup["before"][k]), k


# nsfw_removal: 4 forget and 3 remain images at batch 2, so the second
# step's remain batch is short and skipped, as the JAX loop skips it
@pytest.mark.parametrize("argv,steps", [
    (["random_label", "--epochs", "2"], 2),
    (["nsfw_removal", "--epochs", "1", "--forget_dir", "{tmp}/nsfw",
      "--remain_dir", "{tmp}/not-nsfw"], 1)], ids=["random_label",
                                                   "nsfw_removal"])
def test_cache_vae_moments_cli_equals_uncached(setup, argv, steps):
    argv = [a.format(tmp=setup["tmp"]) for a in argv]
    plain, _ = _run(setup, f"{argv[0]}_plain", *argv)
    cached, after = _run(setup, f"{argv[0]}_cached", *argv,
                         "--cache_vae_moments")
    _finite(plain, steps)
    assert cached["cache_seconds"] > 0 and "cache_seconds" not in plain
    np.testing.assert_allclose(cached["losses"], plain["losses"], rtol=1e-6)
    _pinned_and_moved(setup, after)

