"""FSDP over the ``data`` axis (``salun_torch.dist.fsdp``) on the CPU:

- the layout rule against ``salun.dist.fsdp.fsdp_pspecs`` on the tiny SD
  U-Net at 2, 4 and 8 ranks and on the sd-v1 U-Net's shapes at 2: the same
  tensors sharded, each along a dimension of the same size (the port's
  OIHW/[out, in] weights and JAX's HWIO/[in, out] ones pick different
  logical axes of a tie, such as a 3×3 conv with C_in = C_out);
- across two spawned gloo ranks (``tests/_sharded_workers.py``), masked
  random_label steps of the FSDP-sharded tiny SD model against one
  process: the gradients before Adam (where a halved or doubled gradient
  shows, which Adam's scale invariance would hide in the weights) and
  the weights after it, at a sharded global batch of 2 (with and without
  remat) and at a batch of 1 that stays whole on both ranks; each
  parameter's local shard against the rule.

``sd_train --dp 2 --fsdp`` through the CLI is in
``tests/test_torch_dp_cli.py``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _sharded_workers as workers
from _torch_port import (one_torch_thread,  # noqa: F401
                         sd_perturbed_params, sd_tiny_jax)
from salun.dist import make_mesh as jax_make_mesh
from salun.dist.fsdp import count_sharded as jax_count_sharded
from salun.dist.fsdp import fsdp_pspecs as jax_fsdp_pspecs
from salun_torch.ckpt.sd_import import _RENAME, _leaf_to_torch
from salun_torch.ckpt.torch_import import _flatten
from salun_torch.dist.fsdp import count_sharded, fsdp_pspecs
from salun_torch.dist.mesh import Mesh

# the first step (both sides start from the same weights): each gradient
# within 1e-5 of its own largest entry (workers.rel_errs; gradients that
# are zero in exact arithmetic, float noise at 1e-9, within 1e-5 of the
# largest entry of all); the second, after Adam moved those noise
# coordinates by up to ±lr on each side differently, within 1e-4
GRAD_TOL = (1e-5, 1e-4)
# the U-Net after two Adam steps (lr 1e-4): test_sd_random_label_dp2's
# bound, entries beyond rtol 1e-4 + atol 1e-5 at most a 1e-4 share (the
# noise coordinates), none beyond 2 steps of lr
WEIGHT_FRAC, WEIGHT_MAX = 1e-4, 2 * 2 * workers.LR


def _mesh(n):
    return Mesh(data=n, rank=0, device=torch.device("cpu"), backend="gloo")


def _jax_sharded_sizes(params, specs) -> dict:
    """{CompVis name: the size of the dimension JAX shards, 0 if none}."""
    flat_p, flat_s = _flatten(params), _flatten(specs)
    out = {}
    for k, v in flat_p.items():
        spec = flat_s[k]
        size = next((v.shape[i] for i, a in enumerate(spec) if a), 0)
        name, _ = _leaf_to_torch(k, np.zeros((1,) * len(v.shape)))
        out[_RENAME["unet"](name)] = size
    return out


def _port_sharded_sizes(unet, specs) -> dict:
    return {n: (p.shape[specs[n]] if specs[n] is not None else 0)
            for n, p in unet.named_parameters()}


@pytest.fixture(scope="module")
def tiny():
    jax_modules = sd_tiny_jax()
    params = sd_perturbed_params(jax_modules)
    return params["unet"], workers.tiny_sd().unet


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_pspecs_match_jax_tiny(tiny, n):
    jax_params, unet = tiny
    jspecs = jax_fsdp_pspecs(jax_params, jax_make_mesh(data=n, model=8 // n))
    specs = fsdp_pspecs(unet, _mesh(n))
    assert count_sharded(specs) == jax_count_sharded(jspecs) > 0
    assert _port_sharded_sizes(unet, specs) == _jax_sharded_sizes(
        jax_params, jspecs)


def test_fsdp_pspecs_match_jax_sd_v1():
    """The sd-v1 U-Net (859.5M parameters) by shapes alone: JAX's
    ``eval_shape`` of its init, the port's U-Net on the meta device."""
    from salun.sd import SDUNetConfig as JaxConfig
    from salun.sd.unet import SDUNet as JaxUNet
    from salun_torch.sd.unet import SDUNet, SDUNetConfig

    jax_unet = JaxUNet(JaxConfig())
    shapes = jax.eval_shape(lambda k: jax_unet.init(
        k, jax.numpy.zeros((1, 8, 8, 4)), jax.numpy.zeros((1,)),
        jax.numpy.zeros((1, 77, 768)))["params"], jax.random.PRNGKey(0))
    jspecs = jax_fsdp_pspecs(shapes, jax_make_mesh(data=2, model=4))
    with torch.device("meta"):
        unet = SDUNet(SDUNetConfig())
    assert sum(p.numel() for p in unet.parameters()) == 859_520_964
    specs = fsdp_pspecs(unet, _mesh(2))
    assert count_sharded(specs) == jax_count_sharded(jspecs)
    assert _port_sharded_sizes(unet, specs) == _jax_sharded_sizes(shapes,
                                                                  jspecs)
    # a tie: input_blocks.1.0.in_layers.2 is 320→320, 3×3; the port shards
    # its output channels, JAX its input ones (HWIO axis 2), both of 320
    name = "input_blocks.1.0.in_layers.2.weight"
    assert specs[name] == 0
    assert _flatten(jspecs)["input_blocks_1_0/in_layers_2/kernel"] == P(
        None, None, "data", None)


@pytest.fixture(scope="module")
def two_ranks():
    out = workers.spawn("fsdp")
    for o in out:
        assert "error" not in o, o["error"]
    return out


@pytest.mark.parametrize("case", ["bs2", "bs2_remat", "bs1_whole"])
def test_fsdp_random_label_steps_match_one_process(two_ranks, case):
    for o in two_ranks:
        r = o[case]
        for err, tol in zip(r["grad_err"], GRAD_TOL):
            assert err <= tol, (o["rank"], case, r["grad_err"])
        got, want = r["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        share, worst = r["weights"]
        assert share <= WEIGHT_FRAC and worst <= WEIGHT_MAX, r["weights"]
        assert r["weights_moved"] >= workers.LR  # the steps moved them


def test_fsdp_local_shards_follow_the_rule(two_ranks):
    for o in two_ranks:
        assert o["shapes_bad"] == [] and o["n_sharded"] > 0, o
