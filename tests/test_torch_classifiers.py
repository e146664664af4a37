"""The port's other classifiers against the flax models: resnet32s, 44s,
56s and 110s, resnet50 (Bottleneck, CIFAR stem), resnet34 and resnet18
with the ImageNet stem (at 64x64 input), vgg16_bn and vgg16_bn_lth.

Each port model gets a seeded init with every BatchNorm affine, running
statistic and bias moved off its init value; its state dict goes to flax
through the JAX package's own importer (``salun.ckpt.import_resnet`` /
``import_vgg``), and the port's bridge ``state_dict_from_jax`` must give
that state dict back exactly (masks likewise through ``mask_from_jax`` /
``mask_to_jax``).

Tolerance 1e-4 (absolute and relative) on logits and BatchNorm running
statistics, train and eval mode, as ``tests/test_torch_models.py`` states
it: both sides compute in fp32 but sum the convolutions in different
orders, and BN's running-stat update orders its terms differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.models as JM
import salun_torch.models as M
from _torch_port import nchw
from salun.ckpt import import_resnet, import_vgg
from salun_torch.ckpt import mask_from_jax, mask_to_jax, state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)

# (arch, constructor kwargs, input size)
CASES = [("resnet32s", {}, 32), ("resnet44s", {}, 32), ("resnet56s", {}, 32),
         ("resnet110s", {}, 32), ("resnet50", {}, 32),
         ("resnet34", {}, 64), ("resnet18", {"imagenet": True}, 64),
         ("vgg16_bn", {}, 32), ("vgg16_bn_lth", {}, 32)]
IDS = [c[0] + ("_imagenet" if c[1] else "") for c in CASES]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _pair(arch, kw, rng):
    """Flax model, the port's perturbed twin and its weights as the JAX
    importer reads them."""
    twin = getattr(M, arch)(10, generator=torch.Generator().manual_seed(0),
                            **kw)
    with torch.no_grad():
        for p in twin.parameters():
            if p.dim() == 1:  # BN affine, fc and conv biases
                p.add_(0.1 * torch.from_numpy(
                    rng.standard_normal(p.shape).astype(np.float32)))
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    1.0 + 0.5 * rng.random(n).astype(np.float32)))
    importer = import_vgg if arch.startswith("vgg") else import_resnet
    params, stats = importer(twin.state_dict())
    return getattr(JM, arch)(num_classes=10, **kw), params, stats, twin


@pytest.mark.parametrize("arch,kw,size", CASES, ids=IDS)
def test_logits_and_bn_stats_match_flax(rng, arch, kw, size):
    jmodel, params, stats, twin = _pair(arch, kw, rng)
    x = rng.random((4, size, size, 3)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}

    want_eval = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                        train=False))
    twin.eval()
    with torch.no_grad():
        np.testing.assert_allclose(twin(nchw(x)).numpy(), want_eval, **TOL)

    want_train, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
    twin.train()
    with torch.no_grad():
        got_train = twin(nchw(x)).numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), **TOL)
    want_sd = state_dict_from_jax(params, mutated["batch_stats"])
    sd = twin.state_dict()
    assert set(sd) == set(want_sd)
    for name, v in want_sd.items():
        if "running_" in name:
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("arch,kw,size", CASES, ids=IDS)
def test_state_dict_and_mask_bridge_invert_the_jax_importer(rng, arch, kw,
                                                            size):
    """The port's bridge gives back the state dict the JAX importer read,
    exactly; a mask crosses to torch and back unchanged."""
    _, params, stats, twin = _pair(arch, kw, rng)
    sd, back = twin.state_dict(), state_dict_from_jax(params, stats)
    assert set(sd) == set(back)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k

    mask_tree = jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.5).astype(np.float32), params)
    mask = mask_from_jax(mask_tree)
    assert {n: tuple(t.shape) for n, t in mask.items()} == {
        n: tuple(p.shape) for n, p in twin.named_parameters()}
    again = _flat(mask_to_jax(mask))
    for k, v in _flat(mask_tree).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_registry_builds_every_reference_arch():
    assert set(M.model_dict) == set(JM.model_dict)
    counts = {"resnet50": 23_520_842, "vgg16_bn": 15_311_818,
              "vgg16_bn_lth": 14_728_266, "resnet34": 21_289_802}
    for arch in M.model_dict:
        model = M.create_model(arch, 10, seed=1)
        n = sum(p.numel() for p in model.parameters())
        assert n == counts.get(arch, n) and n > 0, arch
    # resnet34 carries the ImageNet stem and normalisation by default
    r34 = M.create_model("resnet34", 10)
    assert r34.conv1.kernel_size == (7, 7) and r34.imagenet_stem
    assert torch.allclose(r34.normalize.mean.flatten(),
                          torch.tensor(M.resnet.IMAGENET_MEAN))
    assert M.create_model("resnet50", 10, imagenet=True).imagenet_stem
