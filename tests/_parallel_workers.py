"""Workers of ``test_torch_{ring_attention,moe,pipeline}.py``: the port's
sequence-, expert- and pipeline-parallel layers on the ranks of a gloo
group on the CPU (spawned by ``_sharded_workers.spawn``; no JAX), each
against its one-process form. The inputs come from numpy seeds, which the
tests feed to ``salun/`` too. Each rank reports numpy arrays of its shard;
a check that raises is reported as its error string."""

import numpy as np
import torch
import torch.nn.functional as F

from salun_torch.dist import (expert_sharding, moe_apply, pipeline_apply,
                              ring_attention, stage_sharding)
from salun_torch.dist.mesh import make_mesh

RING_B, RING_N, RING_C = 2, 64, 16
MOE_D, MOE_E, MOE_T = 8, 8, 32
PIPE_D, PIPE_H, PIPE_B = 8, 16, 16
PIPE_MICRO = (1, 4, 16)
SGD_LR = 0.1


def ring_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((RING_B, RING_N, RING_C)).astype(np.float32)
            for _ in range(3)]


def moe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    d, e = MOE_D, MOE_E
    experts = {
        "w1": (rng.standard_normal((e, d, 2 * d)) * d ** -0.5),
        "w2": (rng.standard_normal((e, 2 * d, d)) * (2 * d) ** -0.5)}
    gate_w = rng.standard_normal((d, e)) * d ** -0.5
    x = rng.standard_normal((MOE_T, d))
    return ({k: v.astype(np.float32) for k, v in experts.items()},
            gate_w.astype(np.float32), x.astype(np.float32))


def pipe_inputs(n_stages, seed=0):
    """Stages of the residual MLP (w1, b1, w2), the batch and a target."""
    rng = np.random.default_rng(seed)
    d, h = PIPE_D, PIPE_H
    stages = [{"w1": rng.standard_normal((d, h)) * d ** -0.5,
               "b1": 0.1 * rng.standard_normal(h),
               "w2": rng.standard_normal((h, d)) * h ** -0.5}
              for _ in range(n_stages)]
    stages = [{k: v.astype(np.float32) for k, v in s.items()} for s in stages]
    x = rng.standard_normal((PIPE_B, d)).astype(np.float32)
    y = rng.standard_normal((PIPE_B, d)).astype(np.float32)
    return stages, x, y


def expert(params, h):
    """One expert: ``gelu(h·w1)·w2`` (JAX's tanh GELU)."""
    return F.gelu(h @ params["w1"], approximate="tanh") @ params["w2"]


def mlp_stage(params, h):
    """One residual MLP stage: ``h + w2·gelu(w1·h + b1)``."""
    return h + F.gelu(h @ params["w1"] + params["b1"],
                      approximate="tanh") @ params["w2"]


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _np(t):
    return t.detach().numpy().copy()


def _error(fn) -> str:
    """The error ``fn()`` raises, as ``"<type>: <message>"``."""
    try:
        fn()
    except Exception as e:  # reported; the test asserts on its type
        return f"{type(e).__name__}: {e}"
    return "no error"


# -------------------------------------------------------------------- ring


def _ring(q, k, v, mesh):
    q, k, v = _leaf(q), _leaf(k), _leaf(v)
    out = ring_attention(q, k, v, mesh, seq_axis="data")
    (out ** 2).sum().backward()
    return {"out": _np(out), "grads": [_np(t.grad) for t in (q, k, v)]}


def case_ring(out):
    """Two ranks of ``make_mesh(2, 1)``, each with its half of the
    sequence: the output and the gradients of q, k and v (each rank's loss
    the sum of squares of its rows); rank 0 also the one-process form on
    the whole sequence; then a ragged split (7 and 6 of 13), which raises
    on both ranks."""
    mesh = make_mesh(data=2, model=1)
    q, k, v = ring_inputs()
    sl = slice(mesh.data_index * RING_N // 2,
               (mesh.data_index + 1) * RING_N // 2)
    out["ring"] = _ring(q[:, sl], k[:, sl], v[:, sl], mesh)
    if mesh.data_index == 0:
        out["one"] = _ring(q, k, v, None)
    n = 7 if mesh.data_index == 0 else 6
    x = torch.zeros(1, n, 8)
    out["ragged"] = _error(lambda: ring_attention(x, x, x, mesh))


# --------------------------------------------------------------------- MoE


def _moe(mesh, capacity, experts, gate_w, x):
    """This rank's y, aux and gradients over the data axis (its share of
    the tokens and experts; loss: Σy² + 0.01·aux)."""
    if mesh is not None:
        experts = {k: v[expert_sharding(mesh, MOE_E)]
                   for k, v in experts.items()}
        x = x[mesh.rows(MOE_T)]
    ep = {k: _leaf(v) for k, v in experts.items()}
    g, xt = _leaf(gate_w), _leaf(x)
    y, aux = moe_apply(expert, ep, g, xt, mesh, capacity=capacity)
    ((y ** 2).sum() + 0.01 * aux).backward()
    return {"y": _np(y), "aux": float(aux.detach()),
            "gate_grad": _np(g.grad),
            "expert_grads": {k: _np(v.grad) for k, v in ep.items()},
            "x_grad": _np(xt.grad)}


def case_moe(out):
    """Two ranks on ``make_mesh(2, 1)``'s data axis: capacity T/p (no
    drops) and 1 (drops), rank 0's one-process form at capacity T, and the
    bad shapes: 7 experts, 3 a rank of the router's 8, and unequal token
    shares (16 and 15)."""
    mesh = make_mesh(data=2, model=1)
    experts, gate_w, x = moe_inputs(seed=0)
    out["full"] = _moe(mesh, MOE_T // 2, experts, gate_w, x)
    if mesh.rank == 0:
        out["one"] = _moe(None, MOE_T, experts, gate_w, x)
    experts, gate_w, x = moe_inputs(seed=2)
    out["cap1"] = _moe(mesh, 1, experts, gate_w, x)
    experts, gate_w, x = moe_inputs(seed=0)
    local = {k: torch.tensor(v[:4]) for k, v in experts.items()}
    xs = torch.tensor(x[:16])
    out["bad_experts"] = _error(lambda: moe_apply(
        expert, local, torch.tensor(gate_w[:, :7]), xs, mesh))
    out["bad_local"] = _error(lambda: moe_apply(
        expert, {k: v[:3] for k, v in local.items()}, torch.tensor(gate_w),
        xs, mesh))
    out["bad_tokens"] = _error(lambda: moe_apply(
        expert, local, torch.tensor(gate_w),
        xs[:16 - mesh.data_index], mesh))


def case_moe_2d(out):
    """Four ranks on ``make_mesh(2, 2)``: the MoE over the data axis, the
    model axis untouched (its two ranks hold the same tokens and
    experts)."""
    mesh = make_mesh(data=2, model=2)
    experts, gate_w, x = moe_inputs(seed=3)
    out["full"] = _moe(mesh, MOE_T // 2, experts, gate_w, x)
    out["coords"] = (mesh.data_index, mesh.rank % mesh.model)


# ---------------------------------------------------------------- pipeline


def _stage_leaves(stages, mesh):
    """This rank's stage as leaves with a leading stage dimension of 1."""
    sl = stage_sharding(mesh, len(stages))
    return {k: _leaf(np.stack([s[k] for s in stages])[sl])
            for k in stages[0]}


def case_pipeline(out):
    """Two stages on ``make_mesh(1, 2)``'s model axis: the output at M of
    1, 4 and 16 (remat); the stage gradients of mean((out − y)²) at M = 4
    with remat and of Σout² without; the bad shapes."""
    mesh = make_mesh(data=1, model=2)
    stages, x, y = pipe_inputs(2)
    xt = torch.tensor(x)
    for m in PIPE_MICRO:
        params = _stage_leaves(stages, mesh)
        with torch.no_grad():
            got = pipeline_apply(mlp_stage, params, xt, mesh,
                                 num_microbatches=m)
        out[f"fwd_{m}"] = _np(got)
    for name, remat in (("grad", True), ("grad_no_remat", False)):
        params = _stage_leaves(stages, mesh)
        xg = _leaf(x)
        got = pipeline_apply(mlp_stage, params, xg, mesh, num_microbatches=4,
                             remat=remat)
        loss = (((got - torch.tensor(y)) ** 2).mean() if remat
                else (got ** 2).sum())
        loss.backward()
        out[name] = {"out": _np(got), "loss": float(loss),
                     "grads": {k: _np(v.grad) for k, v in params.items()},
                     "x_grad": None if xg.grad is None else _np(xg.grad)}
    params = _stage_leaves(stages, mesh)
    two = {k: torch.cat([v, v]) for k, v in params.items()}
    out["bad_lead"] = _error(lambda: pipeline_apply(
        mlp_stage, two, xt, mesh))
    out["bad_batch"] = _error(lambda: pipeline_apply(
        mlp_stage, params, xt[:6], mesh, num_microbatches=4))


def case_pipeline_dp(out):
    """dp × pp on ``make_mesh(2, 2)``: stages over model, rows over data,
    two SGD steps (lr 0.1) of mean((out − y)²) over the global batch; each
    rank's loss on its rows, its stage after each step and the shape it
    holds."""
    mesh = make_mesh(data=2, model=2)
    stages, x, y = pipe_inputs(2, seed=2)
    rows = mesh.rows(PIPE_B)
    xr, yr = torch.tensor(x[rows]), torch.tensor(y[rows])
    params = _stage_leaves(stages, mesh)
    losses, after = [], []
    for _ in range(2):
        got = pipeline_apply(mlp_stage, params, xr, mesh,
                             num_microbatches=4, batch_axis="data")
        loss = ((got - yr) ** 2).sum() / (PIPE_B * PIPE_D)
        loss.backward()
        with torch.no_grad():
            for p in params.values():
                p -= SGD_LR * p.grad
                p.grad = None
        losses.append(float(loss))
        after.append({k: _np(v) for k, v in params.items()})
    out.update(losses=losses, after=after,
               coords=(mesh.data_index, mesh.rank % mesh.model),
               shapes={k: list(v.shape) for k, v in params.items()})


CASES = {"ring": case_ring, "moe": case_moe, "moe_2d": case_moe_2d,
         "pipeline": case_pipeline, "pipeline_dp": case_pipeline_dp}
