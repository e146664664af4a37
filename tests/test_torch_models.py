"""The port's ResNet-18 (CIFAR stem) and resnet20s against the flax models,
with the weights carried by the port's bridge ``state_dict_from_jax``.

Tolerance 1e-4 (absolute and relative) on logits and BatchNorm running
statistics, train and eval mode: both sides compute in fp32 (the JAX tests
pin matmul precision to highest) but sum the convolutions in different
orders; BN's running-stat update also orders its three terms differently
(flax ``m·ra + (1-m)·new``, torch ``(1-m)·ra + m·new``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_model_and_vars, nchw, port_twin
from salun.ckpt import export_resnet
from salun_torch.ckpt import state_dict_from_jax
from salun_torch.ckpt.torch_import import jax_path_to_torch

TOL = dict(rtol=1e-4, atol=1e-4)


def _flat_stats(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_stats(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch", ["resnet18", "resnet20s"])
def test_logits_and_bn_stats_match_flax(rng, arch):
    model, params, stats = jax_model_and_vars(arch, rng)
    twin = port_twin(arch, params, stats)
    x = rng.random((4, 32, 32, 3)).astype(np.float32)

    want_eval = np.asarray(model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    twin.eval()
    with torch.no_grad():
        got_eval = twin(nchw(x)).numpy()
    np.testing.assert_allclose(got_eval, want_eval, **TOL)

    want_train, mutated = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=True, mutable=["batch_stats"])
    twin.train()
    with torch.no_grad():
        got_train = twin(nchw(x)).numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), **TOL)

    sd = twin.state_dict()
    for path, v in _flat_stats(mutated["batch_stats"]).items():
        mod, leaf = path.rsplit("/", 1)
        name = jax_path_to_torch(mod) + (".running_mean" if leaf == "mean"
                                         else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), v, **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["resnet18", "resnet20s"])
def test_bridge_names_and_values_match_export_resnet(rng, arch):
    """``salun.ckpt.export_resnet`` as an oracle: same names, same values,
    and the port model's own state dict has exactly those keys (plus
    ``num_batches_tracked``)."""
    _, params, stats = jax_model_and_vars(arch, rng)
    ours = state_dict_from_jax(params, stats)
    oracle = export_resnet(params, stats)
    assert set(oracle) == {k for k in ours
                           if not k.endswith("num_batches_tracked")}
    for k, v in oracle.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    model = port_twin(arch, params, stats)
    assert set(model.state_dict()) == set(ours)
    # parameter order is named_parameters order, the reference's
    names = [n for n, _ in model.named_parameters()]
    assert names[:2] == ["conv1.weight", "bn1.weight"]
    assert names[-2:] == ["fc.weight", "fc.bias"]


def test_resnet18_has_the_reference_parameter_count():
    from salun_torch.models import create_model

    model = create_model("resnet18", 10)
    assert sum(p.numel() for p in model.parameters()) == 11_173_962
    assert "layer2.0.downsample.0.weight" in model.state_dict()


def test_create_model_seeded_and_unported_archs():
    from salun_torch.models import create_model

    a = create_model("resnet20s", 10, seed=3)
    b = create_model("resnet20s", 10, seed=3)
    c = create_model("resnet20s", 10, seed=4)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    with pytest.raises(NotImplementedError):
        create_model("resnet50", 10)
