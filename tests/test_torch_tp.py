"""Tensor parallelism over the ``model`` axis (``salun_torch.dist.sharding``)
on the CPU:

- ``sd_unet_pspecs`` against ``salun.dist.sharding.sd_unet_pspecs`` on the
  tiny SD U-Net and on the sd-v1 U-Net's shapes: the same weights sharded,
  JAX's ``P(None, "model")`` of an ``[in, out]`` kernel ↔ the port's
  ``Shard(0)`` of ``[out, in]``, ``P("model", None)`` ↔ ``Shard(1)``; the
  port also shards the GEGLU's bias with its rows, where JAX leaves it to
  GSPMD;
- the GEGLU's row permutation and its inverse;
- across two spawned gloo ranks at ``make_mesh(data=1, model=2)``, the
  tiny U-Net's loss and gathered gradients against the unsharded U-Net's
  (each rank holds one of the two heads, and half of each GEGLU half: the
  head-count and GEGLU traps), the gathered weights bitwise those it
  started from, and every parameter's placement as the rule says.
"""

import jax
import numpy as np
import pytest
import torch

import _sharded_workers as workers
from _torch_port import (one_torch_thread,  # noqa: F401
                         sd_perturbed_params, sd_tiny_jax)
from salun.dist.sharding import sd_unet_pspecs as jax_sd_unet_pspecs
from salun_torch.ckpt.sd_import import _RENAME, _leaf_to_torch
from salun_torch.ckpt.torch_import import _flatten
from salun_torch.dist.sharding import (count_sharded, geglu_perm,
                                       sd_unet_pspecs)

# loss relative; each gradient within 1e-5 of its own largest entry
# (workers.rel_errs: noise-level gradients against the largest of all)
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


def _jax_dims(jax_params) -> dict:
    """{CompVis name: the torch dimension JAX's spec shards, or None}: a
    2-D kernel's [in, out] is the port's [out, in] transposed."""
    specs = _flatten(jax_sd_unet_pspecs(jax_params))
    out = {}
    for k, v in _flatten(jax_params).items():
        spec = tuple(specs[k])
        axes = [i for i, a in enumerate(spec) if a]
        name, _ = _leaf_to_torch(k, np.zeros((1,) * len(v.shape)))
        out[_RENAME["unet"](name)] = (len(v.shape) - 1 - axes[0]
                                      if axes else None)
    return out


def _check(jax_params, unet):
    specs = sd_unet_pspecs(unet)
    want = _jax_dims(jax_params)
    extra = {n: d for n, d in specs.items() if d != want[n]}
    # the only departure: the GEGLU's bias follows its column-parallel rows
    assert extra and all(n.endswith("ff.net.0.proj.bias") and d == 0
                         for n, d in extra.items()), extra
    assert count_sharded(specs) == sum(d is not None
                                       for d in want.values()) + len(extra)
    assert {d for d in specs.values()} == {None, 0, 1}


def test_sd_unet_pspecs_match_jax_tiny():
    params = sd_perturbed_params(sd_tiny_jax())
    _check(params["unet"], workers.tiny_sd().unet)


def test_sd_unet_pspecs_match_jax_sd_v1():
    from salun.sd import SDUNetConfig as JaxConfig
    from salun.sd.unet import SDUNet as JaxUNet
    from salun_torch.sd.unet import SDUNet, SDUNetConfig

    jax_unet = JaxUNet(JaxConfig())
    shapes = jax.eval_shape(lambda k: jax_unet.init(
        k, jax.numpy.zeros((1, 8, 8, 4)), jax.numpy.zeros((1,)),
        jax.numpy.zeros((1, 77, 768)))["params"], jax.random.PRNGKey(0))
    with torch.device("meta"):
        unet = SDUNet(SDUNetConfig())
    _check(shapes, unet)


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_geglu_perm_gives_each_rank_matching_halves(parts):
    rows, inner = 32, 16
    perm = geglu_perm(rows, parts)
    assert sorted(perm.tolist()) == list(range(rows))
    c = inner // parts
    for r, block in enumerate(perm.chunk(parts)):
        h, gate = block.chunk(2)
        assert h.tolist() == list(range(r * c, (r + 1) * c))
        assert gate.tolist() == [inner + i for i in h.tolist()]
    assert torch.equal(perm[torch.argsort(perm)], torch.arange(rows))


@pytest.fixture(scope="module")
def two_ranks():
    out = workers.spawn("tp")
    for o in out:
        assert "error" not in o, o["error"]
    return out


def test_tp_mesh_is_one_by_two(two_ranks):
    for o in two_ranks:
        m = o["mesh"]
        assert m["shape"] == {"data": 1, "model": 2} and m["backend"] == "gloo"
        assert (m["model_size"], m["data_size"], m["data_index"]) == (2, 1, 0)
        assert m["rows"] == str(slice(0, 4))  # the batch stays whole


def test_tp_loss_and_gradients_match_unsharded(two_ranks):
    for o in two_ranks:
        got, want = o["loss"]
        assert abs(got - want) <= LOSS_TOL * abs(want), o["loss"]
        assert o["grad_err"] <= GRAD_TOL, o["grad_err"]
        # one of the tiny U-Net's 2 heads of 16 a rank: to_q's 32 rows halved
        assert o["local_q"] == [16, 32]


def test_tp_state_and_placements(two_ranks):
    for o in two_ranks:
        assert o["state_bitwise"] and o["placements_as_specs"], o
        assert o["n_sharded"] > 0
