"""``--dp 2`` through the port's CLIs on the CPU: each runs as the user
runs it, ``python -m torch.distributed.run --standalone --nproc_per_node 2
-m salun_torch.cli.<cli> ... --dp 2 --device cpu`` (two gloo ranks, one
thread each), and is held against the same argv in one process:

- classification (resnet20s, CIFAR-10 files of a synthetic set):
  ``generate_mask`` masks agree ≥ 0.999, ``main_random --unlearn RL``
  parameters within ``test_cli_mesh._assert_params_match``'s bounds and
  its metrics within 2 points, ``main_forget --unlearn FT`` runs; against
  the JAX package's own CLIs at ``--dp 2`` (the conftest's 8 virtual CPU
  devices): ``generate_mask`` (``--no-aug``, so neither side draws) masks
  agree ≥ 0.999, and ``main_random --unlearn raw`` (no training, no draws)
  metrics within 2 points. RL's random labels come from different
  generators on the two sides, so its parameters are held to the port's
  own run, which ``tests/test_torch_methods.py`` holds to ``salun``;
- ``ddpm_train --mode saliency_unlearn`` on a tiny U-Net (rtol 1e-4, atol
  1e-5) and ``ddpm_sample --mode sample_fid`` at batch 8 (PNGs off by at
  most 1);
- ``sd_train random_label`` on the tiny SD config (rtol 1e-4, atol 1e-5 on
  all but a 1e-4 fraction of the U-Net, see ``test_sd_random_label``) and
  ``sd_generate_images`` (the same PNGs);
- ``sd_train random_label --dp 2 --fsdp`` (the U-Net, its Adam moments
  and the mask sharded over the two ranks) within the same bound of the
  one-process run, the counterpart of JAX's
  ``test_sd_random_label_dp2_and_fsdp_match_single_device``, as is
  ``random_label --cache_vae_moments --dp 2 --fsdp``; ``esd --dp 2
  --fsdp`` (a batch of 1 that stays whole on both ranks, a sharded frozen
  teacher) against one process's ``esd``; ``proximal --dp 2 --fsdp`` with
  τ (the sharded exact k-th value) bitwise the one-process τ;
- every training run ends with both ranks' parameters bitwise equal (the
  CLIs check it and print each rank's digest).

The launches run a few at a time, each with its own timeout; torchrun's
``--standalone`` rendezvous takes a free port.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import (one_torch_thread,  # noqa: F401
                         write_tiny_imagenette, write_tiny_sd)
from test_cli_mesh import _assert_params_match
from test_torch_ddpm_cli import TINY_YML

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 300  # seconds, each torchrun launch
PARALLEL = 4  # launches at once
N_TRAIN, N_TEST = 400, 128  # synthetic CIFAR-10 files


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["SALUN_CLIP_BPE"] = str(ROOT / "tests" / "_synthetic_clip_merges.txt")
    return env


def torchrun(cli: str, argv: list) -> str:
    """The CLI on 2 CPU ranks; returns the launch's output, failing the test
    with its tail when the launch fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", f"salun_torch.cli.{cli}", *argv,
           "--dp", "2", "--device", "cpu"]
    p = subprocess.run(cmd, env=_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=LAUNCH_TIMEOUT)
    out = p.stdout + p.stderr
    if p.returncode != 0:
        bad = [ln for ln in out.splitlines()
               if re.search(r"Error|error|terminate|Traceback|Abort", ln)]
        pytest.fail(f"{cli} --dp 2 failed (rc {p.returncode}):\n"
                    + "\n".join(bad[:40]) + "\n...\n" + out[-3000:])
    return out


def _digests(log: str) -> dict:
    return dict(re.findall(r"rank (\d): [^\n]*?digest ([0-9a-f]{16})", log))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every single-process run in this process, then every ``--dp 2``
    launch (a few at a time) and the JAX package's ``--dp 2`` runs."""
    from salun_torch.cli import (ddpm_sample, ddpm_train, generate_mask,
                                 main_random, sd_generate_images, sd_train)
    from salun_torch.data.datasets import synthetic
    from salun_torch.models import create_model

    sys.path.insert(0, str(ROOT))
    from chip_smoke import write_cifar10_files

    tmp = tmp_path_factory.mktemp("dp_cli")
    write_cifar10_files(tmp / "data", synthetic(n=N_TRAIN, seed=0),
                        synthetic(n=N_TEST, seed=1))
    torch.save({"state_dict": create_model("resnet20s", 10,
                                           seed=0).state_dict()},
               tmp / "r20.pt")
    cls = ["--dataset", "cifar10", "--data", str(tmp / "data"), "--arch",
           "resnet20s", "--model_path", str(tmp / "r20.pt"), "--batch_size",
           "64", "--num_indexes_to_replace", "32", "--class_to_replace",
           "-1"]
    mask = ["--no-aug", *cls]
    rl = [*cls, "--unlearn", "RL", "--unlearn_lr", "0.01",
          "--unlearn_epochs", "1", "--mask_path",
          str(tmp / "m1" / "with_0.5.pt")]
    (tmp / "tiny.yml").write_text(TINY_YML)
    ddpm = ["--config", str(tmp / "tiny.yml"), "--label_to_forget", "0",
            "--seed", "3"]
    unlearn = [*ddpm, "--mode", "saliency_unlearn", "--method", "rl",
               "--mask_path", str(tmp / "dm" / "mask" / "0" / "with_0.5.pt")]
    sample = ["--config", str(tmp / "tiny.yml"), "--mode", "sample_fid",
              "--ckpt_folder", str(tmp / "du1"), "--n_samples_per_class",
              "8", "--batch", "8", "--classes", "0", "--timesteps", "5"]
    cfg_path, ckpt = write_tiny_sd(tmp)
    write_tiny_imagenette(tmp, np.random.default_rng(0))
    sd = ["random_label", "--config", str(cfg_path), "--ckpt_path",
          str(ckpt), "--data", str(tmp / "data"), "--image_size", "64",
          "--batch_size", "2", "--epochs", "1", "--lr", "1e-4",
          "--class_to_forget", "0", "--train_method", "full"]
    (tmp / "prompts.csv").write_text("case_number,prompt,evaluation_seed\n"
                                     "0,a photo of a tench,11\n"
                                     "1,a photo of a church,22\n")
    gen = ["--prompts_path", str(tmp / "prompts.csv"), "--config",
           str(cfg_path), "--ckpt_path", str(ckpt), "--image_size", "64",
           "--ddim_steps", "4", "--num_samples", "1"]

    def cpu(argv, out, flag="--save_dir"):
        return [*argv, flag, str(tmp / out), "--device", "cpu"]

    # proximal on the tiny model: the full-width CLIP is ~98% of it, so
    # the ratio that shrinks 3/4 of the U-Net at the first step (as
    # test_torch_sd_train_cli.test_proximal_cli picks it)
    from salun_torch.ckpt import load_compvis_state_dict

    before = load_compvis_state_dict(str(ckpt))
    n_unet = sum(v.numel() for k, v in before.items()
                 if k.startswith("model.diffusion_model."))
    n_total = sum(v.numel() for k, v in before.items()
                  if "position_ids" not in k)
    ratio = (n_total - n_unet + 0.75 * n_unet) / (0.9 * n_total)
    prox = ["proximal", *sd[1:], "--mask_ratio", repr(ratio)]

    res = {"tmp": tmp}
    res["mask1"] = generate_mask.main(cpu(mask, "m1"))
    res["rl1"] = main_random.main(cpu(rl, "r1"))
    ddpm_train.main(cpu([*ddpm, "--mode", "generate_mask"], "dm"))
    res["du1"] = ddpm_train.main(cpu(unlearn, "du1"))
    ddpm_sample.main(cpu(sample, "ds1"))
    sd_train.main(cpu(sd, "sd1"))
    res["prox1"] = sd_train.main(cpu(prox, "prox1"))
    esd = ["esd", "--prompt", "a cat, a dog", "--iterations", "2",
           "--ddim_steps", "4", "--config", str(cfg_path), "--ckpt_path",
           str(ckpt), "--image_size", "64", "--lr", "1e-4"]
    sd_train.main(cpu(esd, "esd1"))
    sd_generate_images.main(cpu(gen, "sg1", "--save_path"))
    launches = {
        "mask": ("generate_mask", [*mask, "--save_dir", str(tmp / "m2")]),
        "rl": ("main_random", [*rl, "--save_dir", str(tmp / "r2")]),
        "raw": ("main_random", [*cls, "--unlearn", "raw", "--save_dir",
                                str(tmp / "raw2")]),
        "forget": ("main_forget", [*cls, "--unlearn", "FT",
                                   "--unlearn_epochs", "1", "--save_dir",
                                   str(tmp / "f2")]),
        "ddpm": ("ddpm_train", [*unlearn, "--save_dir", str(tmp / "du2")]),
        "sample": ("ddpm_sample", [*sample, "--save_dir", str(tmp / "ds2")]),
        "sd": ("sd_train", [*sd, "--save_dir", str(tmp / "sd2")]),
        "sd_fsdp": ("sd_train", [*sd, "--fsdp", "--save_dir",
                                 str(tmp / "sd_fsdp")]),
        "prox_fsdp": ("sd_train", [*prox, "--fsdp", "--save_dir",
                                   str(tmp / "prox_fsdp")]),
        "cache_fsdp": ("sd_train", [*sd, "--cache_vae_moments", "--fsdp",
                                    "--save_dir", str(tmp / "cache_fsdp")]),
        "esd_fsdp": ("sd_train", [*esd, "--fsdp", "--save_dir",
                                  str(tmp / "esd_fsdp")]),
        "gen": ("sd_generate_images", [*gen, "--save_path",
                                       str(tmp / "sg2")]),
    }
    with ThreadPoolExecutor(PARALLEL) as pool:
        futures = {k: pool.submit(torchrun, *v) for k, v in launches.items()}
        # the JAX package's CLIs at --dp 2, meanwhile, in this process
        from salun.cli import generate_mask as jax_generate_mask
        from salun.cli import main_random as jax_main_random

        jax_generate_mask.main([*mask, "--dp", "2", "--save_dir",
                                str(tmp / "jm")])
        res["jax_raw"] = jax_main_random.main(
            [*cls, "--unlearn", "raw", "--dp", "2", "--save_dir",
             str(tmp / "jraw")])
        res["logs"] = {k: f.result() for k, f in futures.items()}
    yield res
    shutil.rmtree(tmp, ignore_errors=True)  # ~1.5 GB of SD checkpoints


def _mask_agreement(a: dict, b: dict) -> float:
    return float(np.mean([float((a[k] == b[k]).float().mean()) for k in a]))


def test_generate_mask_dp2(runs):
    """Masks of the sharded saliency sum agree with one process's and with
    the JAX package's --dp 2 masks (fp accumulation order may flip rare
    ties)."""
    import jax

    from salun import ckpt as jax_ckpt
    from salun.ckpt import import_mask
    from salun_torch.ckpt import load_mask

    tmp = runs["tmp"]
    m1 = load_mask(str(tmp / "m1" / "with_0.5.pt"))
    m2 = load_mask(str(tmp / "m2" / "with_0.5.pt"))
    assert _mask_agreement(m1, m2) >= 0.999
    jm = jax_ckpt.restore(str(tmp / "jm" / "with_0.5"))["mask"]
    ported = import_mask(str(tmp / "m2" / "with_0.5.pt"), jm)
    same = np.mean([float((np.asarray(a) == np.asarray(b)).mean())
                    for a, b in zip(jax.tree.leaves(ported),
                                    jax.tree.leaves(jm))])
    assert same >= 0.999, same


def _params(path) -> dict:
    from salun_torch.ckpt import load_state_dict

    return {k: v.numpy() for k, v in load_state_dict(str(path)).items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def test_main_random_rl_dp2(runs):
    """RL with the mask: parameters within _assert_params_match's bounds
    (reduction order only, amplified by the dynamics), metrics within 2
    points, both ranks' parameters bitwise equal."""
    tmp = runs["tmp"]
    with open(tmp / "r2" / "RL_eval_result.json") as f:
        r2 = json.load(f)
    for k in ("retain", "forget", "val", "test", "UA"):
        assert abs(runs["rl1"][k] - r2[k]) <= 2.0, (k, runs["rl1"][k], r2[k])
    _assert_params_match(_params(tmp / "r1" / "RL_checkpoint.pt"),
                         _params(tmp / "r2" / "RL_checkpoint.pt"))
    d = _digests(runs["logs"]["rl"])
    assert set(d) == {"0", "1"} and d["0"] == d["1"], d


def test_main_random_raw_dp2_matches_jax(runs):
    """The sharded evaluation (UA/RA/TA) against the JAX package's --dp 2
    run of the same model."""
    tmp = runs["tmp"]
    with open(tmp / "raw2" / "raw_eval_result.json") as f:
        port = json.load(f)
    for k in ("retain", "forget", "val", "test", "UA"):
        assert abs(port[k] - runs["jax_raw"][k]) <= 2.0, (
            k, port[k], runs["jax_raw"][k])


def test_main_forget_dp2_runs(runs):
    tmp = runs["tmp"]
    with open(tmp / "f2" / "FT_eval_result.json") as f:
        res = json.load(f)
    assert all(np.isfinite(res[k]) for k in ("retain", "forget", "UA"))
    d = _digests(runs["logs"]["forget"])
    assert set(d) == {"0", "1"} and d["0"] == d["1"], d


def _ddpm_model(path) -> dict:
    from salun_torch.ckpt import load_ddpm_states

    return load_ddpm_states(str(path))[0]


def test_ddpm_saliency_unlearn_dp2(runs):
    tmp = runs["tmp"]
    one = _ddpm_model(tmp / "du1" / "ckpts" / "ckpt.pth")
    two = _ddpm_model(tmp / "du2" / "ckpts" / "ckpt.pth")
    for k, v in one.items():
        np.testing.assert_allclose(np.asarray(two[k]), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    d = _digests(runs["logs"]["ddpm"])
    assert set(d) == {"0", "1"} and d["0"] == d["1"], d


def test_ddpm_sample_fid_dp2(runs):
    tmp = runs["tmp"]
    for i in range(8):
        a = np.asarray(Image.open(tmp / "ds1" / "0" / f"{i}.png"), np.int16)
        b = np.asarray(Image.open(tmp / "ds2" / "0" / f"{i}.png"), np.int16)
        assert np.abs(a - b).max() <= 1, i


def test_sd_random_label_dp2(runs):
    """rtol 1e-4, atol 1e-5 on the U-Net (JAX's
    test_sd_random_label_dp2_and_fsdp_match_single_device without --fsdp),
    outside at most a 1e-4 fraction of it and never by more than the lr:
    Adam's first update is lr·g/(|g| + 1e-8), so a coordinate whose
    gradient is zero in exact arithmetic (a bias in front of a GroupNorm)
    moves by float noise on either side (31 of 1.57M coordinates,
    measured)."""
    from salun_torch.ckpt import load_compvis_state_dict

    tmp = runs["tmp"]
    a = load_compvis_state_dict(str(tmp / "sd1" / "compvis.ckpt"))
    b = load_compvis_state_dict(str(tmp / "sd2" / "compvis.ckpt"))
    keys = [k for k in a if k.startswith("model.diffusion_model.")]
    assert keys and set(a) == set(b)
    _assert_params_match({k: a[k].numpy() for k in keys},
                         {k: b[k].numpy() for k in keys},
                         rtol=1e-4, atol=1e-5, frac=1e-4, max_abs=1e-4)
    for k in a:
        if k not in keys:  # the frozen VAE and CLIP: untouched
            assert torch.equal(a[k], b[k]), k
    d = _digests(runs["logs"]["sd"])
    assert set(d) == {"0", "1"} and d["0"] == d["1"], d


def _sd_unets(tmp, a, b):
    from salun_torch.ckpt import load_compvis_state_dict

    a = load_compvis_state_dict(str(tmp / a / "compvis.ckpt"))
    b = load_compvis_state_dict(str(tmp / b / "compvis.ckpt"))
    assert set(a) == set(b)
    return a, b


@pytest.mark.parametrize("one, fsdp", [("sd1", "sd_fsdp"),
                                       ("sd1", "cache_fsdp"),
                                       ("esd1", "esd_fsdp")])
def test_sd_random_label_dp2_fsdp(runs, one, fsdp):
    """--fsdp: the bound of test_sd_random_label_dp2 against the
    one-process run (random_label, cached or not; ESD, whose batch of 1
    stays whole on both ranks, so FSDP divides the ranks' sum by 2); the
    frozen VAE and CLIP untouched; the ranks' gathered U-Nets bitwise
    equal (the CLI's digests)."""
    tmp = runs["tmp"]
    a, b = _sd_unets(tmp, one, fsdp)
    keys = [k for k in a if k.startswith("model.diffusion_model.")]
    _assert_params_match({k: a[k].numpy() for k in keys},
                         {k: b[k].numpy() for k in keys},
                         rtol=1e-4, atol=1e-5, frac=1e-4, max_abs=1e-4)
    for k in a:
        if k not in keys:
            assert torch.equal(a[k], b[k]), k
    log = runs["logs"][fsdp]
    assert "--fsdp:" in log and "sharded over 2 ranks" in log
    d = _digests(log)
    assert set(d) == {"0", "1"} and d["0"] == d["1"], d


def test_sd_proximal_dp2_fsdp_tau(runs):
    """τ of the sharded bisection over the ranks' shards equals the
    one-process sort's τ bitwise (printed with repr), as does the count
    it pins."""
    [shrink] = runs["prox1"]["shrinks"]
    got = re.findall(r"proximal shrink: ratio (\d+) tau (\S+) pinned (\d+)",
                     runs["logs"]["prox_fsdp"])
    assert len(got) == 2, got  # one line a rank
    for ratio, tau, pinned in got:
        assert int(ratio) == shrink["ratio"]
        assert float(tau) == shrink["tau"] > 0
        assert int(pinned) >= int(ratio)


def test_sd_generate_images_dp2(runs):
    """Both rows in one sharded call, each keeping its own evaluation_seed
    latents: the same PNGs as the per-row run."""
    tmp = runs["tmp"]
    for name in ("0_0.png", "1_0.png"):
        a = np.asarray(Image.open(tmp / "sg1" / name), np.int16)
        b = np.asarray(Image.open(tmp / "sg2" / name), np.int16)
        assert np.abs(a - b).max() <= 1, name
