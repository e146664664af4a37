"""The port's DDPM classifier CLI (``salun_torch.cli.ddpm_classifier``)
against ``salun.cli.ddpm_classifier`` on the CPU: ``train`` for 2 steps of
ResNet-34 at 224 (8 synthetic CIFAR images, batch 4) from the JAX run's
initial weights with its crop and flip draws replayed into the port, each
step fed the resized batch in [0, 1] on both sides (the port's train
batch; ``salun``'s CLI scales it back to [0, 255], so its step gets it
divided by 255 again), with both Adam groups and, in a second run,
``--init_weights`` (a torchvision-named ``.pth``) with
``--freeze_layers``; then ``eval`` on the same PNG folder and the same
weights; and that ``train``'s batches lie in [0, 1].

Tolerances (fp32 on both sides):
- the resize to 224: the same bilinear arithmetic, 1e-5 of [0, 255];
- the optimizer alone (both Adam groups with L2 in the gradient, and the
  frozen body) on the same gradients for 3 steps: 1e-4·lr (optax forms
  Adam's bias corrections 1 − 0.999ᵗ in fp32, 1.3e-5 off at t = 1; torch
  in double);
- ``train``: Adam moves every coordinate by about ±lr whatever its
  gradient's size, so a weight whose gradient is within rounding of 0
  steps either way on each side (0.07% of them at step 1, measured), and
  the second step's gradients follow those weights. Hence: the first
  step's loss to 1e-5 relative (measured 2.3e-7), the second's to 5e-3
  (measured 1.0e-4; the loss is ~116 after an lr-0.01 step); after two
  steps at least 70% of the coordinates within 0.1·lr of JAX's (measured
  73.9%) and every BatchNorm running statistic within 10% of the distance
  the JAX run moved it (measured 6.3%), as
  ``tests/test_torch_unlearn_methods.py`` holds classification
  trajectories. Under ``--freeze_layers`` the body is bitwise the loaded
  weights;
- ``eval``: the probabilities to 1e-5 absolute, the metrics to 1e-5 and
  the argmax-based accuracy exactly.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.cli.ddpm_classifier as jax_cls
import salun_torch.cli.ddpm_classifier as port_cls
from _torch_port import jax_key_source, one_torch_thread  # noqa: F401
from _torch_port import port_twin
from salun.data.datasets import ArrayDataset as JaxArrayDataset
from salun_torch.ckpt import load_state_dict, state_dict_from_jax
from salun_torch.cli.ddpm_sample import write_png
from salun_torch.data.datasets import ArrayDataset
from salun_torch.models import create_model

LR, SEED, BS, N = 0.01, 1, 4, 8


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (N, 32, 32, 3)).astype(np.uint8),
            rng.integers(0, 10, N).astype(np.int64))


def _jax_train(monkeypatch, images, save_dir, **kw):
    """salun's ``train`` with its step fed [0, 1] batches: returns (initial
    variables, final payload, losses)."""
    x, y = images
    monkeypatch.setattr(jax_cls.D, "load", lambda *a, **k: JaxArrayDataset(
        x, y, 10, "cifar10"))
    seen = {}
    create = jax_cls.TrainState.create

    def capture(variables, tx):
        seen["init"] = jax.tree.map(np.asarray, variables)
        return create(variables, tx)

    monkeypatch.setattr(jax_cls.TrainState, "create", capture)
    make_step = jax_cls.make_train_step

    def counted_step(*a, **k):
        step = make_step(*a, **k)

        def run(state, batch, key):
            # the port trains on [0, 1] (the reference's ToTensor), where
            # salun's CLI scales the resized batch back to [0, 255]; the
            # resize is linear, so this is salun's step on the port's input
            batch = dict(batch, image=batch["image"] / 255.0)
            state, m = step(state, batch, key)
            seen.setdefault("losses", []).append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(jax_cls, "make_train_step", counted_step)
    monkeypatch.setattr(jax_cls.ckpt, "save",
                        lambda path, payload: seen.update(final=jax.tree.map(
                            np.asarray, payload)))
    args = types.SimpleNamespace(
        seed=SEED, dataset="cifar10", data="", limit=N, batch_size=BS,
        epochs=1, lr=LR, save_dir=str(save_dir), init_weights=None,
        freeze_layers=False)
    for k, v in kw.items():
        setattr(args, k, v)
    jax_cls.train(args)
    return seen["init"], seen["final"], seen["losses"]


def _port_train(monkeypatch, images, init, save_dir, *extra):
    x, y = images
    monkeypatch.setattr(port_cls.D, "load", lambda *a, **k: ArrayDataset(
        x, y, 10, "cifar10"))
    twin = port_twin("resnet34", init["params"], init["batch_stats"])
    monkeypatch.setattr(port_cls, "create_model", lambda *a, **k: twin)
    losses = []
    step = port_cls.train_step

    def counted_step(*a, **k):
        m = step(*a, **k)
        losses.append(float(m["loss"]))
        return m

    monkeypatch.setattr(port_cls, "train_step", counted_step)
    out = port_cls.main(
        ["train", "--limit", str(N), "--batch_size", str(BS), "--epochs", "1",
         "--lr", str(LR), "--seed", str(SEED), "--save_dir", str(save_dir),
         "--device", "cpu", *extra],
        source=jax_key_source(jax.random.PRNGKey(SEED), 10))
    assert out["steps"] == N // BS == len(losses)
    return load_state_dict(out["path"]), losses


def _close_to_jax(got, want, theta0, losses, want_losses):
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1], want_losses[1], rtol=5e-3)
    near = total = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = (got[k] - w).abs()
        if k.endswith(("running_mean", "running_var")):
            moved = float((w - theta0[k]).abs().max())
            assert float(err.max()) <= 0.1 * moved, k
            continue
        lr = LR * 10 if k.startswith("fc.") else LR
        near += int((err <= 0.1 * lr).sum())
        total += err.numel()
    assert near >= 0.7 * total, near / total


def test_resize_matches_jax():
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_cls._resize_batch(jnp.asarray(x)))
    got = port_cls.resize_batch(torch.from_numpy(
        x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got * 255, want * 255, rtol=0, atol=1e-5 * 255)


def test_train_two_steps_match_jax(monkeypatch, images, tmp_path):
    init, final, want_losses = _jax_train(monkeypatch, images,
                                          tmp_path / "jax")
    got, losses = _port_train(monkeypatch, images, init, tmp_path / "port")
    theta0 = state_dict_from_jax(init["params"], init["batch_stats"])
    want = state_dict_from_jax(final["params"], final["batch_stats"])
    assert set(got) >= {k for k in want}
    _close_to_jax(got, want, theta0, losses, want_losses)
    # both groups moved; the head by about 10× the body's step
    body = max(float((got[k] - theta0[k]).abs().max()) for k in theta0
               if k.endswith("conv1.weight"))
    head = float((got["fc.weight"] - theta0["fc.weight"]).abs().max())
    assert 0 < body <= 2.2 * LR and 2 * LR < head <= 22 * LR


def test_freeze_layers_with_init_weights_match_jax(monkeypatch, images,
                                                   tmp_path):
    # a torchvision-named ImageNet ResNet-34 (1,000-way head), BN moved
    net = create_model("resnet34", 1000, seed=5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith(("running_mean", "bias")):
                v.add_(0.1 * torch.randn(v.shape, generator=gen))
            elif k.endswith("running_var"):
                v.mul_(1.0 + 0.3 * torch.rand(v.shape, generator=gen))
    pth = tmp_path / "resnet34-imagenet.pth"
    torch.save(net.state_dict(), pth)
    init, final, want_losses = _jax_train(
        monkeypatch, images, tmp_path / "jax", init_weights=str(pth),
        freeze_layers=True)
    got, losses = _port_train(monkeypatch, images, init, tmp_path / "port",
                              "--init_weights", str(pth), "--freeze_layers")
    theta0 = state_dict_from_jax(init["params"], init["batch_stats"])
    loaded = net.state_dict()
    for k, v in got.items():
        if k.startswith("fc.") or not k.endswith(("weight", "bias")):
            continue
        assert torch.equal(v, loaded[k]), k  # the body: bitwise
    want = state_dict_from_jax(final["params"], final["batch_stats"])
    _close_to_jax(got, want, theta0, losses, want_losses)
    assert not torch.equal(got["fc.weight"], theta0["fc.weight"])
    assert not torch.equal(got["bn1.running_mean"], loaded["bn1.running_mean"])


@pytest.mark.parametrize("freeze", [False, True], ids=["both", "frozen"])
def test_optimizer_groups_match_optax(freeze):
    import optax

    model = create_model("resnet34", 10, seed=2)
    params = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    tree = {"fc": {k: v for k, v in params.items() if k.startswith("fc.")},
            "body": {k: v for k, v in params.items()
                     if not k.startswith("fc.")}}

    def group(lr):
        return optax.chain(optax.add_decayed_weights(5e-4), optax.adam(lr))

    # salun.cli.ddpm_classifier's transformation, over the same tree
    tx = optax.multi_transform(
        {"body": optax.set_to_zero() if freeze else group(LR),
         "fc": group(LR * 10)}, jax_cls._fc_labels(tree))
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    opt = port_cls.make_optimizer(model, LR, freeze)
    rng = np.random.default_rng(3)
    for _ in range(3):
        # gradients near the weight decay's size and of θ's sign, so that
        # the L2 term shows and never cancels them
        grads = {k: (1e-4 * np.sign(v) * (0.5 + rng.random(v.shape))
                     ).astype(np.float32) for k, v in params.items()}
        jg = {g: {k: jnp.asarray(grads[k]) for k in tree[g]} for g in tree}
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k]) if p.requires_grad else None
        opt.step()
    for k, p in model.named_parameters():
        g = "fc" if k.startswith("fc.") else "body"
        want = np.asarray(jp[g][k])
        if freeze and g == "body":
            assert np.array_equal(p.detach().numpy(), params[k]), k
            continue
        lr = LR * 10 if g == "fc" else LR
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-4 * lr, err_msg=k)


def test_init_weights_keeps_the_fresh_head(tmp_path):
    net = create_model("resnet34", 1000, seed=5)
    pth = tmp_path / "r34.pth"
    torch.save(net.state_dict(), pth)
    model = create_model("resnet34", 10, seed=7)
    head = model.fc.weight.detach().clone()
    port_cls.load_init_weights(model, str(pth))
    assert torch.equal(model.fc.weight, head)
    assert torch.equal(model.conv1.weight, net.conv1.weight)
    torch.save({k: v for k, v in net.state_dict().items()
                if not k.startswith("layer4")}, pth)
    with pytest.raises(KeyError):
        port_cls.load_init_weights(model, str(pth))


def test_train_batch_is_in_unit_range(monkeypatch, images, tmp_path):
    """The batches ``train`` hands its step lie in [0, 1] at 224, the range
    ``eval`` feeds, and reach near both ends of it."""
    x, y = images
    monkeypatch.setattr(port_cls.D, "load", lambda *a, **k: ArrayDataset(
        x, y, 10, "cifar10"))
    seen = []

    def record(model, opt, batch, draws):
        img = batch["image"]
        seen.append((tuple(img.shape), float(img.min()), float(img.max())))
        return {"acc": torch.zeros(()), "loss": torch.zeros(())}

    monkeypatch.setattr(port_cls, "train_step", record)
    port_cls.main(["train", "--limit", str(N), "--batch_size", str(BS),
                   "--epochs", "1", "--save_dir", str(tmp_path),
                   "--device", "cpu"])
    assert len(seen) == N // BS
    for shape, lo, hi in seen:
        assert shape == (BS, 3, 224, 224)
        assert 0.0 <= lo < 0.1 and 0.9 < hi <= 1.0, (lo, hi)


def test_limit_checks():
    with pytest.raises(SystemExit):
        port_cls.main(["train", "--limit", "-1", "--device", "cpu"])


def test_eval_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    folder = tmp_path / "samples"
    folder.mkdir()
    for i in range(5):
        write_png(str(folder / f"{i}.png"),
                  rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
    net = create_model("resnet34", 10, seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        net.fc.weight.mul_(20.0)  # confident, varied predictions
        for k, v in net.state_dict().items():
            if k.endswith("running_mean"):
                v.add_(0.1 * torch.randn(v.shape, generator=gen))
    ckpt = tmp_path / "cifar10_resnet34.pth"
    torch.save({"state_dict": net.state_dict()}, ckpt)
    common = ["--sample_path", str(folder), "--label_of_forgotten_class",
              "3", "--ckpt", str(ckpt), "--batch_size", "2"]
    want = jax_cls.evaluate(jax_cls_args(common, tmp_path / "jax"))
    got = port_cls.main(["eval", *common, "--save_dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    assert np.allclose(got.pop("probs").sum(1), 1.0, atol=1e-6)
    for k in ("avg_entropy", "avg_prob_of_forgotten_class"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    assert got["accuracy_on_forgotten_class"] == want[
        "accuracy_on_forgotten_class"]
    written = json.load(open(tmp_path / "port" / "classifier_eval.json"))
    assert written == got
    with pytest.raises(ValueError, match="orbax"):
        port_cls.main(["eval", "--sample_path", str(folder), "--ckpt",
                       str(tmp_path / "classifier"), "--device", "cpu"])


def jax_cls_args(common, save_dir):
    ns = types.SimpleNamespace(save_dir=str(save_dir))
    for flag, value in zip(common[::2], common[1::2]):
        name = flag[2:]
        setattr(ns, name, int(value) if name in (
            "label_of_forgotten_class", "batch_size") else value)
    return ns
