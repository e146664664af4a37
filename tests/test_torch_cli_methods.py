"""Every one of the 17 names of the unlearning registry through the port's
CLIs on the CPU (``--device cpu``), on resnet20s and a shrunken synthetic
set: ``main_random`` with a saliency mask for the methods that read it,
``main_forget`` for the others. Each call must give finite UA/RA/TA and
SVC-MIA numbers and write its checkpoint and results; K1's plain version
runs once a step on the masked training methods and never on the rest;
``boundary_expanding``'s checkpoint is the widened model. The cases
cover every name of the JAX package's registry (16 methods and ``raw``)."""

import json
import math

import pytest
import torch

import salun.core.methods as JaxMethods
import salun_torch.core.masked_opt as masked_opt
from _torch_port import one_torch_thread  # noqa: F401
from salun_torch.ckpt import save_mask
from salun_torch.cli import main_forget, main_random
from salun_torch.core.methods import get_unlearn_method
from salun_torch.data import datasets as D
from salun_torch.models import create_model

# (name, reads the mask, K1 steps with the mask: forget batches "f",
# retain batches "r", both "fr", or none)
METHODS = [("RL", True, "fr"), ("GA", True, "f"), ("GA_l1", True, "f"),
           ("FT", True, "r"), ("FT_l1", True, "r"), ("FT_prune", True, "r"),
           ("boundary_shrink", True, "f"), ("boundary_expanding", True, "f"),
           ("wfisher", True, ""), ("retrain", False, ""),
           ("fisher", False, ""), ("fisher_new", False, ""),
           ("RL_proximal", False, ""), ("FT_prune_bi", False, ""),
           ("GA_prune", False, ""), ("GA_prune_bi", False, ""),
           ("raw", False, "")]


def test_cases_cover_every_registered_name():
    names = {m for m, _, _ in METHODS}
    assert names == set(JaxMethods._METHODS) and len(names) == 17
    for name in names:
        assert callable(get_unlearn_method(name)), name


@pytest.fixture
def small_synthetic(monkeypatch):
    orig = D.synthetic

    def small(n=512, seed=0, **kw):
        return orig(n=100 if n > 600 else 40, seed=seed, **kw)

    monkeypatch.setattr(D, "synthetic", small)


@pytest.mark.parametrize("name,masked,k1", METHODS,
                         ids=[m for m, _, _ in METHODS])
def test_method_runs_through_its_cli(tmp_path, small_synthetic, monkeypatch,
                                     name, masked, k1):
    model = create_model("resnet20s", 10, seed=1)
    gen = torch.Generator().manual_seed(0)
    mask = {n: (torch.rand(p.shape, generator=gen) > 0.5).float()
            for n, p in model.named_parameters()}
    save_mask(str(tmp_path / "mask.pt"), mask)
    calls = []
    update = masked_opt.masked_sgd_update
    monkeypatch.setattr(masked_opt, "masked_sgd_update",
                        lambda *a, **k: calls.append(1) or update(*a, **k))
    argv = ["--dataset", "synthetic", "--arch", "resnet20s", "--device",
            "cpu", "--batch_size", "32", "--seed", "2",
            "--num_indexes_to_replace", "16", "--unlearn", name,
            "--unlearn_lr", "0.01", "--unlearn_epochs", "1",
            "--save_dir", str(tmp_path / "out")]
    if masked:
        results = main_random.main(argv + ["--mask_path",
                                           str(tmp_path / "mask.pt")])
    else:
        results = main_forget.main(argv)
    for key in ("retain", "forget", "val", "test", "UA"):
        assert math.isfinite(results[key]), key
    mia = results["SVC_MIA_forget_efficacy"]
    assert len(mia) == 5 and all(math.isfinite(v) for v in mia.values())
    assert set(results["seconds"]) == {"unlearn", "accuracy", "mia"}
    with open(tmp_path / "out" / f"{name}_eval_result.json") as f:
        assert json.load(f)["UA"] == results["UA"]
    # 90 train images after the validation split: 16 forget, 74 retain
    steps = {"": 0, "f": 1, "r": 3, "fr": 4}[k1]
    assert len(calls) == steps
    sd = torch.load(tmp_path / "out" / f"{name}_checkpoint.pt",
                    weights_only=True)["state_dict"]
    want_rows = 11 if name == "boundary_expanding" else 10
    assert sd["fc.weight"].shape == (want_rows, 64)
