"""The GPipe pipeline over a mesh axis (``salun_torch.dist.pipeline``) on
the CPU, against ``salun.dist.pipeline.pipeline_apply``.

Stages of the residual MLP ``h + w2·gelu(w1·h + b1)`` at d 8, hidden 16,
a batch of 16 (numpy seeds). Two spawned gloo ranks of ``make_mesh(1,
2)`` hold one stage each; held against ``salun``'s pipeline on a 2-device
CPU mesh and against applying the stages in sequence (torch):

- the output at 1, 4 and 16 microbatches (remat), the same on both ranks;
- the stage gradients of mean((out − y)²) at M = 4 (remat), and of Σout²
  without remat; x's gradient on stage 0 (none on stage 1);
- dp × pp on four ranks of ``make_mesh(2, 2)`` (stages over ``model``,
  rows over ``data``, ``batch_axis="data"``): two SGD steps at lr 0.1
  follow the sequential trajectory and ``salun``'s, each rank holding
  only its own stage throughout;
- the bad shapes (two stages on a rank; a batch of 6 at M = 4) raise
  ``ValueError``.

Tolerances, those of ``tests/test_pipeline.py``: the output to rtol 2e-5
/ atol 2e-6, the gradients to 1e-4 / 1e-6; without remat, against
``salun``'s pipeline, its 1e-2 / 1e-5 (XLA's sums through the stages in
another order: one gradient of 256 lands 1.2e-4 off), while against the
sequential torch stages the port holds 1e-4 / 1e-6 there too. The dp × pp
losses to 1e-5 / 1e-7 and the stages after two steps to 1e-4 / 1e-6.
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
from salun.dist.pipeline import pipeline_apply as jax_pipeline_apply
from salun.dist.pipeline import stack_stage_params as jax_stack
from salun_torch.dist import stack_stage_params

OUT = {"rtol": 2e-5, "atol": 2e-6}
GRAD = {"rtol": 1e-4, "atol": 1e-6}
LOSS = {"rtol": 1e-5, "atol": 1e-7}
GRAD_NO_REMAT_JAX = {"rtol": 1e-2, "atol": 1e-5}


def _check(rank_outs):
    for o in rank_outs:
        assert "error" not in o, o["error"]
    return rank_outs


@pytest.fixture(scope="module")
def two_ranks():
    return _check(workers.spawn("pipeline", timeout=120))


@pytest.fixture(scope="module")
def four_ranks():
    return _check(workers.spawn("pipeline_dp", timeout=120, world=4))


def _jax_stage(params, h):
    return h + jax.nn.gelu(h @ params["w1"] + params["b1"]) @ params["w2"]


def jax_pipeline(stages, x, micro, data=1, batch_axis=None, remat=True):
    mesh = jax_make_mesh(data, 2, devices=jax.devices()[:2 * data])
    stacked = jax_stack([jax.tree.map(jnp.asarray, s) for s in stages])
    return lambda p, x: jax_pipeline_apply(
        _jax_stage, p, x, mesh, axis="model", num_microbatches=micro,
        batch_axis=batch_axis, remat=remat), stacked, jnp.asarray(x)


def torch_sequential(stages, x, loss_fn):
    """The stages one after another: (output, loss, stacked stage
    gradients, x's gradient)."""
    ps = [{k: torch.tensor(v, requires_grad=True) for k, v in s.items()}
          for s in stages]
    xt = torch.tensor(x, requires_grad=True)
    h = xt
    for p in ps:
        h = pw.mlp_stage(p, h)
    loss = loss_fn(h)
    loss.backward()
    grads = stack_stage_params([{k: v.grad for k, v in p.items()}
                                for p in ps])
    return (h.detach().numpy(), float(loss.detach()),
            {k: v.numpy() for k, v in grads.items()}, xt.grad.numpy())


def _mse(y):
    return lambda out: ((out - torch.as_tensor(y)) ** 2).mean()


def _sum_sq(out):
    return (out ** 2).sum()


def _rank_grads(two_ranks, name):
    """The stage gradients of both ranks, stacked in stage order."""
    return {k: np.concatenate([o[name]["grads"][k] for o in two_ranks])
            for k in two_ranks[0][name]["grads"]}


@pytest.mark.parametrize("micro", pw.PIPE_MICRO)
def test_pipeline_forward_matches(two_ranks, micro):
    stages, x, _ = pw.pipe_inputs(2)
    got = [o[f"fwd_{micro}"] for o in two_ranks]
    np.testing.assert_array_equal(got[0], got[1])  # replicated
    fn, stacked, xj = jax_pipeline(stages, x, micro)
    np.testing.assert_allclose(got[0], np.asarray(jax.jit(fn)(stacked, xj)),
                               **OUT)
    want, _, _, _ = torch_sequential(stages, x, _sum_sq)
    np.testing.assert_allclose(got[0], want, **OUT)


@pytest.mark.parametrize("name,remat", [("grad", True),
                                        ("grad_no_remat", False)])
def test_pipeline_grads_match(two_ranks, name, remat):
    stages, x, y = pw.pipe_inputs(2)
    loss_t = _mse(y) if remat else _sum_sq
    got = _rank_grads(two_ranks, name)
    fn, stacked, xj = jax_pipeline(stages, x, 4, remat=remat)
    loss_j = ((lambda o: jnp.mean((o - jnp.asarray(y)) ** 2)) if remat
              else (lambda o: jnp.sum(o ** 2)))
    want_j = jax.jit(jax.grad(lambda p: loss_j(fn(p, xj))))(stacked)
    out, loss, want_t, x_grad = torch_sequential(stages, x, loss_t)
    for k, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want_j[k]),
                                   **(GRAD if remat else GRAD_NO_REMAT_JAX))
        np.testing.assert_allclose(g, want_t[k], **GRAD)
    for o in two_ranks:
        np.testing.assert_allclose(o[name]["out"], out, **OUT)
        np.testing.assert_allclose(o[name]["loss"], loss, **LOSS)
    np.testing.assert_allclose(two_ranks[0][name]["x_grad"], x_grad, **GRAD)
    assert two_ranks[1][name]["x_grad"] is None  # x is read on stage 0


def test_pipeline_dp_pp_two_sgd_steps(four_ranks):
    stages, x, y = pw.pipe_inputs(2, seed=2)
    assert [o["coords"] for o in four_ranks] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    fn, p, xj = jax_pipeline(stages, x, 4, data=2, batch_axis="data")

    @jax.jit
    def sgd(p):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((fn(p, xj) - jnp.asarray(y)) ** 2))(p)
        return jax.tree.map(lambda a, b: a - pw.SGD_LR * b, p, g), loss

    seq = [dict(s) for s in stages]
    for step in range(2):
        p, loss = sgd(p)
        _, seq_loss, grads, _ = torch_sequential(seq, x, _mse(y))
        seq = [{k: seq[i][k] - pw.SGD_LR * grads[k][i] for k in seq[i]}
               for i in range(2)]
        # the global loss: each data index's share, from one rank of it
        got = four_ranks[0]["losses"][step] + four_ranks[2]["losses"][step]
        np.testing.assert_allclose(got, float(loss), **LOSS)
        np.testing.assert_allclose(got, seq_loss, **LOSS)
        for o in four_ranks:
            stage = o["coords"][1]
            for k, v in o["after"][step].items():
                np.testing.assert_allclose(v[0], np.asarray(p[k])[stage],
                                           **GRAD)
                np.testing.assert_allclose(v[0], seq[stage][k], **GRAD)
    for o in four_ranks:  # one stage a rank, never gathered
        assert o["shapes"] == {"w1": [1, 8, 16], "b1": [1, 16],
                               "w2": [1, 16, 8]}


@pytest.mark.parametrize("case,match", [("bad_lead", "leading dim"),
                                        ("bad_batch", "divisible")])
def test_pipeline_rejects_bad_shapes(two_ranks, case, match):
    for o in two_ranks:
        assert o[case].startswith("ValueError") and match in o[case], o[case]
