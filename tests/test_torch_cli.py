"""The port's CLI chain on the CPU: ``generate_mask`` → ``main_random
--unlearn RL`` on resnet20s and a shrunken synthetic set, as the user runs
them (``--device cpu``). The ``with_{t}.pt`` masks must be exact-k and
load through the JAX package's ``salun.ckpt.import_mask``; the unlearned
checkpoint must load through ``salun.ckpt.import_resnet``."""

import json
import math

import jax
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from salun.ckpt import import_mask, import_resnet
from salun.models import create_model as jax_create_model
from salun_torch.cli import generate_mask, main_random
from salun_torch.data import datasets as D
from salun_torch.models import create_model


@pytest.fixture
def small_synthetic(monkeypatch):
    orig = D.synthetic

    def small(n=512, seed=0, **kw):
        return orig(n=240 if n > 600 else 96, seed=seed, **kw)

    monkeypatch.setattr(D, "synthetic", small)


def test_generate_mask_then_rl_on_cpu(tmp_path, small_synthetic):
    out = str(tmp_path)
    common = ["--dataset", "synthetic", "--arch", "resnet20s",
              "--device", "cpu", "--save_dir", out, "--batch_size", "32",
              "--num_indexes_to_replace", "24", "--seed", "2"]
    masks = generate_mask.main(common)
    assert sorted(masks) == [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                             1.0]
    n = sum(v.numel() for v in masks[0.5].values())
    for t, m in masks.items():
        assert sum(int(v.sum()) for v in m.values()) == int(n * t)

    # the reference-format masks load through the JAX importer
    variables = jax_create_model("resnet20s", 10).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    tree = import_mask(f"{out}/with_0.5.pt", variables["params"])
    assert sum(float(x.sum()) for x in jax.tree.leaves(tree)) == int(n * 0.5)

    results = main_random.main(common + [
        "--unlearn", "RL", "--mask_path", f"{out}/with_0.5.pt",
        "--unlearn_lr", "0.013", "--unlearn_epochs", "1"])
    for k in ("retain", "forget", "val", "test", "UA"):
        assert math.isfinite(results[k])
    assert set(results["SVC_MIA_forget_efficacy"]) == {
        "correctness", "confidence", "entropy", "m_entropy", "prob"}
    with open(f"{out}/RL_eval_result.json") as f:
        saved = json.load(f)
    assert saved["UA"] == results["UA"]

    params, _ = import_resnet(f"{out}/RL_checkpoint.pt")
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.tree.map(np.asarray, variables["params"]))
    # masked-out weights stayed at the pretrained (here: seeded) init
    sd = torch.load(f"{out}/RL_checkpoint.pt", weights_only=True)["state_dict"]
    theta0 = create_model("resnet20s", 10, seed=1).state_dict()  # train_seed
    m = masks[0.5]["layer1.0.conv1.weight"]
    assert torch.equal(sd["layer1.0.conv1.weight"][m == 0],
                       theta0["layer1.0.conv1.weight"][m == 0])
    assert not torch.equal(sd["layer1.0.conv1.weight"][m > 0],
                           theta0["layer1.0.conv1.weight"][m > 0])


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_mask.main(["--dataset", "synthetic", "--arch", "resnet20s",
                            "--save_dir", str(tmp_path)])
