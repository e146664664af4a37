"""The switch MoE layer over a mesh axis (``salun_torch.dist.moe``) on the
CPU, against ``salun.dist.moe.moe_apply``.

D = E = 8 experts (each ``gelu(h·w1)·w2``, hidden 16), T = 32 tokens,
numpy seeds. Spawned gloo ranks hold their share of the tokens and of the
experts; each rank's loss is Σy² of its rows + 0.01·aux. Held against
``salun``'s layer on a CPU mesh of the same shape, the dense per-token
oracle of ``tests/test_moe.py:34-45`` written in torch, and the port's
one-process form (rank 0, no mesh, capacity T):

- two ranks at capacity T/p = 16 (no token can drop): y, aux and the
  gradients of the router, the experts and x;
- two ranks at capacity 1: the dropped tokens exactly 0, the kept ones
  the dense oracle's, y and the gradients ``salun``'s at capacity 1;
- the bad shapes (7 experts; 3 a rank of the router's 8; token shares of
  16 and 15) raise ``ValueError`` on both ranks, and the spawn returns;
- four ranks of ``make_mesh(2, 2)``, the layer over ``data``: the model
  axis untouched (its two ranks get the same rows).

Tolerances, those of ``tests/test_moe.py``: y to rtol 2e-5 / atol 2e-6,
aux to 1e-5 / 1e-7, gradients to 2e-4 / 1e-5; a dropped token's output
to atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _parallel_workers as pw
import _sharded_workers as workers
from _torch_port import one_torch_thread  # noqa: F401
from salun.dist import make_mesh as jax_make_mesh
from salun.dist.moe import moe_apply as jax_moe_apply

Y = {"rtol": 2e-5, "atol": 2e-6}
AUX = {"rtol": 1e-5, "atol": 1e-7}
GRAD = {"rtol": 2e-4, "atol": 1e-5}
T, E = pw.MOE_T, pw.MOE_E


def _check(rank_outs):
    for o in rank_outs:
        assert "error" not in o, o["error"]
    return rank_outs


@pytest.fixture(scope="module")
def two_ranks():
    return _check(workers.spawn("moe", timeout=120))


@pytest.fixture(scope="module")
def four_ranks():
    return _check(workers.spawn("moe_2d", timeout=120, world=4))


def _jax_expert(params, h):
    return jax.nn.gelu(h @ params["w1"]) @ params["w2"]


def jax_moe(seed, data, model, capacity):
    """salun's y, aux and gradients (of experts, router, x) on a (data,
    model) CPU mesh, loss Σy² + 0.01·aux."""
    experts, gate_w, x = pw.moe_inputs(seed)
    mesh = jax_make_mesh(data, model, devices=jax.devices()[:data * model])

    def fn(e, g, x):
        return jax_moe_apply(_jax_expert, e, g, x, mesh, axis="data",
                             capacity=capacity)

    def loss(e, g, x):
        y, aux = fn(e, g, x)
        return jnp.sum(y ** 2) + 0.01 * aux

    args = (jax.tree.map(jnp.asarray, experts), jnp.asarray(gate_w),
            jnp.asarray(x))
    y, aux = jax.jit(fn)(*args)
    ge, gg, gx = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return {"y": np.asarray(y), "aux": float(aux), "gate_grad": np.asarray(gg),
            "expert_grads": {k: np.asarray(v) for k, v in ge.items()},
            "x_grad": np.asarray(gx)}


def dense_oracle(seed):
    """Every token through its argmax expert times its router probability
    (no drops), in torch, with its gradients."""
    experts, gate_w, x = pw.moe_inputs(seed)
    ep = {k: torch.tensor(v, requires_grad=True) for k, v in experts.items()}
    g = torch.tensor(gate_w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    probs = torch.softmax((xt @ g).to(torch.float32), -1)
    idx = probs.argmax(-1)
    gate = probs.gather(-1, idx[:, None])[:, 0]
    every = torch.func.vmap(pw.expert, in_dims=(0, None))(ep, xt)  # [E, T, d]
    y = every[idx, torch.arange(T)] * gate[:, None]
    f = torch.nn.functional.one_hot(idx, E).to(torch.float32).mean(0)
    aux = E * torch.sum(f * probs.mean(0))
    ((y ** 2).sum() + 0.01 * aux).backward()
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            "gate_grad": g.grad.numpy(),
            "expert_grads": {k: v.grad.numpy() for k, v in ep.items()},
            "x_grad": xt.grad.numpy()}


def gathered(rank_outs, key):
    """The whole result of the ranks along the data axis (one rank of
    each data index, in order)."""
    rs = [o[key] for o in rank_outs]
    return {"y": np.concatenate([r["y"] for r in rs]), "aux": rs[0]["aux"],
            "gate_grad": rs[0]["gate_grad"],
            "expert_grads": {k: np.concatenate([r["expert_grads"][k]
                                                for r in rs])
                             for k in rs[0]["expert_grads"]},
            "x_grad": np.concatenate([r["x_grad"] for r in rs])}


def assert_moe_close(got, want):
    np.testing.assert_allclose(got["y"], want["y"], **Y)
    np.testing.assert_allclose(got["aux"], want["aux"], **AUX)
    np.testing.assert_allclose(got["gate_grad"], want["gate_grad"], **GRAD)
    np.testing.assert_allclose(got["x_grad"], want["x_grad"], **GRAD)
    for k, w in want["expert_grads"].items():
        np.testing.assert_allclose(got["expert_grads"][k], w, **GRAD)


@pytest.mark.parametrize("oracle", ["jax", "dense", "port_one_process"])
def test_moe_no_drops_matches(two_ranks, oracle):
    got = gathered(two_ranks, "full")
    want = {"jax": lambda: jax_moe(0, 2, 1, T // 2),
            "dense": lambda: dense_oracle(0),
            "port_one_process": lambda: two_ranks[0]["one"]}[oracle]()
    assert_moe_close(got, want)
    # the router's gradient is summed over the axis: whole on each rank
    np.testing.assert_array_equal(two_ranks[1]["full"]["gate_grad"],
                                  got["gate_grad"])
    assert two_ranks[1]["full"]["aux"] == got["aux"]


def test_moe_capacity_one_drops_tokens_to_zero(two_ranks):
    got = gathered(two_ranks, "cap1")
    experts, gate_w, x = pw.moe_inputs(2)
    idx = torch.softmax(torch.tensor(x @ gate_w), -1).argmax(-1).numpy()
    kept = np.zeros(T, bool)
    for s in range(2):  # the first token of each expert in each shard
        seen = set()
        for i in range(s * T // 2, (s + 1) * T // 2):
            kept[i] = idx[i] not in seen
            seen.add(idx[i])
    assert kept.sum() < T, "seed produced no drops; test is vacuous"
    dense = dense_oracle(2)
    np.testing.assert_allclose(got["y"][kept], dense["y"][kept], **Y)
    np.testing.assert_allclose(got["y"][~kept], 0.0, atol=1e-7)
    assert_moe_close(got, jax_moe(2, 2, 1, 1))


@pytest.mark.parametrize("case,match", [
    ("bad_experts", "divisible"), ("bad_local", "divisible"),
    ("bad_tokens", "tokens")])
def test_moe_rejects_bad_shapes_on_every_rank(two_ranks, case, match):
    for o in two_ranks:
        assert o[case].startswith("ValueError") and match in o[case], o[case]


def test_moe_on_2d_mesh_data_axis(four_ranks):
    assert [o["coords"] for o in four_ranks] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    for a, b in ((0, 1), (2, 3)):  # the model axis: the same rows
        np.testing.assert_array_equal(four_ranks[a]["full"]["y"],
                                      four_ranks[b]["full"]["y"])
    got = gathered([four_ranks[0], four_ranks[2]], "full")
    assert_moe_close(got, jax_moe(3, 2, 2, T // 2))
    assert_moe_close(got, dense_oracle(3))
