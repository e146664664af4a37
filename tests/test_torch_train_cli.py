"""The port's pretraining and baseline CLIs on the CPU, as the user runs
them (``--device cpu``), on resnet20s and a shrunken synthetic set:

- ``main_train`` for 2 epochs straight against 1 epoch and ``--resume`` to
  2 in a fresh directory: the checkpoints (weights, BN statistics,
  momentum, step count, generator state, curves) are bitwise equal, with
  and without ``--no-aug``; ``model_SA_best.pt`` loads through
  ``salun.ckpt.import_resnet``;
- ``main_forget --unlearn FT`` and ``--unlearn retrain`` end to end: finite
  metrics, no K1 call, and retrain builds on the seeded init without
  reading ``--model_path``;
- ``main_random --resume`` loads ``{unlearn}_checkpoint.pt``, runs no
  unlearning method and evaluates the loaded model.
"""

import json
import math

import jax
import pytest
import torch

import salun_torch.cli.main_random as main_random
import salun_torch.core.masked_opt as masked_opt
from salun.ckpt import import_resnet
from salun_torch.ckpt import save_model
from salun_torch.cli import main_forget, main_train
from salun_torch.data import datasets as D
from salun_torch.models import create_model


@pytest.fixture
def small_synthetic(monkeypatch):
    orig = D.synthetic

    def small(n=512, seed=0, **kw):
        return orig(n=160 if n > 600 else 64, seed=seed, **kw)

    monkeypatch.setattr(D, "synthetic", small)


COMMON = ["--dataset", "synthetic", "--arch", "resnet20s", "--device", "cpu",
          "--batch_size", "32", "--seed", "2"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("no_aug", [False, True])
def test_main_train_resume_is_bitwise_a_straight_run(tmp_path,
                                                     small_synthetic, no_aug):
    flags = COMMON + ["--lr", "0.05", "--decreasing_lr", "1"] + (
        ["--no-aug"] if no_aug else [])
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    out = main_train.main(flags + ["--epochs", "2", "--save_dir",
                                   str(straight)])
    assert len(out["epoch_seconds"]) == 2
    first = main_train.main(flags + ["--epochs", "1", "--save_dir",
                                     str(resumed)])
    assert len(first["epoch_seconds"]) == 1
    after = main_train.main(flags + ["--epochs", "2", "--resume",
                                     "--save_dir", str(resumed)])
    assert len(after["epoch_seconds"]) == 1  # only epoch 1 ran

    a, b = _load(straight / "checkpoint.pt"), _load(resumed / "checkpoint.pt")
    assert a["count"] == b["count"] == 10 and a["epoch"] == b["epoch"] == 2
    assert torch.equal(a["momentum"], b["momentum"])
    assert torch.equal(a["generator"], b["generator"])
    assert a["curves"] == b["curves"] == out["curves"] == after["curves"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    init = create_model("resnet20s", 10, seed=2).state_dict()
    assert not torch.equal(a["state_dict"]["fc.weight"], init["fc.weight"])
    with open(straight / "train_curves.json") as f:
        assert json.load(f) == out["curves"]
    params, stats = import_resnet(str(straight / "model_SA_best.pt"))
    assert "layer3_2" in params and "bn1" in stats


def test_main_forget_ft_and_retrain(tmp_path, small_synthetic, monkeypatch):
    calls = []
    monkeypatch.setattr(masked_opt, "masked_sgd_update",
                        lambda *a, **k: calls.append(1))
    loaded = []
    real_load = main_random.load_model
    monkeypatch.setattr(main_random, "load_model",
                        lambda m, p: loaded.append(p) or real_load(m, p))
    model_path = str(tmp_path / "pretrained.pt")
    save_model(model_path, create_model("resnet20s", 10, seed=9))
    flags = COMMON + ["--save_dir", str(tmp_path), "--model_path", model_path,
                      "--num_indexes_to_replace", "16",
                      "--unlearn_lr", "0.01", "--unlearn_epochs", "1",
                      "--mask_path", str(tmp_path / "ignored.pt")]
    for method in ("FT", "retrain"):
        results = main_forget.main(flags + ["--unlearn", method])
        for k in ("retain", "forget", "val", "test", "UA"):
            assert math.isfinite(results[k]), (method, k)
        assert all(math.isfinite(v)
                   for v in results["SVC_MIA_forget_efficacy"].values())
        params, _ = import_resnet(str(tmp_path / f"{method}_checkpoint.pt"))
        assert jax.tree.structure(params)
    assert calls == [] and loaded == [model_path]  # retrain read no θ
    ft = _load(tmp_path / "FT_checkpoint.pt")["state_dict"]
    rt = _load(tmp_path / "retrain_checkpoint.pt")["state_dict"]
    pre = create_model("resnet20s", 10, seed=9).state_dict()
    init = create_model("resnet20s", 10, seed=1).state_dict()  # train_seed
    d_ft = (ft["fc.weight"] - pre["fc.weight"]).abs().max()
    d_rt = (rt["fc.weight"] - init["fc.weight"]).abs().max()
    assert 0 < d_ft < 0.1 and 0 < d_rt < 0.1


def test_main_random_resume_loads_and_skips_the_method(tmp_path,
                                                       small_synthetic,
                                                       monkeypatch):
    ckpt = tmp_path / "RL_checkpoint.pt"
    save_model(str(ckpt), create_model("resnet20s", 10, seed=7))
    before = _load(ckpt)["state_dict"]

    def no_method(name):
        raise AssertionError("--resume ran the unlearning method")

    monkeypatch.setattr(main_random, "get_unlearn_method", no_method)
    flags = COMMON + ["--save_dir", str(tmp_path), "--unlearn", "RL",
                      "--num_indexes_to_replace", "16"]
    results = main_random.main(flags + ["--resume"])
    for k in ("retain", "forget", "val", "test", "UA"):
        assert math.isfinite(results[k]), k
    after = _load(ckpt)["state_dict"]
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    # without --resume the method runs
    with pytest.raises(AssertionError, match="ran the unlearning method"):
        main_random.main(flags)
