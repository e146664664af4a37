"""The port's pruner and one-shot pruning (``salun_torch.core.pruner``,
``salun_torch.core.omp``) against ``salun.core.pruner`` and
``salun.core.omp``.

Masks on resnet20s's weights (bridged from the JAX tree) must equal the
JAX package's up to exact ties: the port breaks ties at the threshold in
its own flat order (OIHW, ``named_parameters``), the JAX package in its
(HWIO, sorted keys), so every coordinate where the two masks differ must
score exactly the threshold value, and both keep the same count. Random
pruning gets the JAX package's uniform draws. SNIP, GraSP and SynFlow
scores on the torch/flax tiny pair (``_tiny_pair``; the JAX SynFlow runs
on a BatchNorm-free model only) within 1e-5 of the largest score of each
tensor: fp32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

import salun_torch.core.pruner as tpruner
from _tiny_pair import FlaxNet, TorchNet, flax_leaf, to_flax_layout
from _tiny_pair import transport
from _torch_port import jax_key_source, jax_model_and_vars, port_twin
from _torch_port import one_torch_thread  # noqa: F401
from salun.core import omp as jomp
from salun.core import pruner as jpruner
from salun.core.masked_opt import sgd as jax_sgd
from salun.core.train import TrainState
from salun.data import datasets as JD
from salun.data import loader as JL
from salun_torch.ckpt import mask_from_jax, mask_to_jax
from salun_torch.core import omp as tomp
from salun_torch.core.masked_opt import SGD, FlatParams
from salun_torch.data import datasets as D
from salun_torch.data import loader as L

SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def resnet20s():
    """The flax resnet20s with perturbed BatchNorm, built once: its init
    takes seconds."""
    return jax_model_and_vars("resnet20s", np.random.default_rng(0))


@pytest.fixture
def resnet(resnet20s):
    model, params, stats = resnet20s
    return model, params, stats, port_twin("resnet20s", params, stats)


def _jax_tree(params):
    return jax.tree.map(jnp.asarray, params)


def _assert_equal_up_to_ties(got, want_tree, scores):
    """``got`` (port mask) equals the JAX mask ``want_tree`` except at
    coordinates whose ``scores`` tie exactly at the threshold."""
    want = mask_from_jax(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want)
    assert sum(float(m.sum()) for m in got.values()) == sum(
        float(m.sum()) for m in want.values())
    kept = torch.cat([scores[n][got[n] > 0].reshape(-1) for n in got
                      if tpruner.is_conv_kernel(got[n])])
    tau = kept.min() if kept.numel() else None
    for n, g in got.items():
        w = want[n]
        if not tpruner.is_conv_kernel(g):
            assert torch.equal(g, torch.ones_like(g)), n
            assert torch.equal(w, torch.ones_like(w)), n
            continue
        differ = g != w
        if differ.any():
            assert torch.all(scores[n][differ] == tau), n


def _jax_uniform(params, key):
    """The uniform draws of ``salun.core.pruner.global_random_prune``
    for ``key``, in the port's layout."""
    leaves, treedef = jax.tree.flatten(_jax_tree(params))
    keys = jax.random.split(key, len(leaves))
    u = [np.asarray(jax.random.uniform(k, l.shape, jnp.float32))
         for k, l in zip(keys, leaves)]
    return mask_from_jax(jax.tree.unflatten(treedef, u))


@pytest.mark.parametrize("px", [0.3, 0.95])
def test_l1_prune_matches_jax(resnet, px):
    _, params, _, twin = resnet
    tparams = dict(twin.named_parameters())
    got = tpruner.global_l1_prune(tparams, px)
    want = jpruner.global_l1_prune(_jax_tree(params), px)
    _assert_equal_up_to_ties(got, want, {n: p.detach().abs()
                                         for n, p in tparams.items()})


def test_random_prune_with_injected_uniforms_matches_jax(resnet):
    _, params, _, twin = resnet
    tparams = dict(twin.named_parameters())
    key = jax.random.PRNGKey(3)
    uniform = _jax_uniform(params, key)
    got = tpruner.global_random_prune(tparams, 0.5, uniform=uniform)
    want = jpruner.global_random_prune(_jax_tree(params), 0.5, key)
    _assert_equal_up_to_ties(got, want, uniform)


def test_two_rounds_compose_on_the_remaining_weights(resnet):
    _, params, _, twin = resnet
    tparams = dict(twin.named_parameters())
    jparams = _jax_tree(params)
    got = want = None
    for _ in range(2):
        got = tpruner.global_l1_prune(tparams, 0.3, got)
        want = jpruner.global_l1_prune(jparams, 0.3, want)
    eff = tpruner.apply_prune_mask(
        {n: p.detach() for n, p in tparams.items()}, got)
    scores = {n: torch.where(got[n] > 0, e.abs(), -torch.inf)
              for n, e in eff.items()}
    _assert_equal_up_to_ties(got, want, scores)
    n = sum(p.numel() for p in tparams.values() if p.dim() == 4)
    rem = n - round(0.3 * n)
    rem -= round(0.3 * rem)  # px of the REMAINING weights
    assert tpruner.check_sparsity(tparams, got) == pytest.approx(
        100.0 * rem / n, abs=1e-12)
    assert tpruner.check_sparsity(tparams, got) == pytest.approx(
        jpruner.check_sparsity(jparams, want), abs=1e-9)


def test_sparsity_extract_and_reverse_match_jax(resnet, rng):
    _, params, _, twin = resnet
    tparams = dict(twin.named_parameters())
    mask_tree = jax.tree.map(
        lambda p: (rng.random(p.shape) > 0.3).astype(np.float32)
        if p.ndim == 4 else np.ones(p.shape, np.float32), params)
    mask = mask_from_jax(mask_tree)
    jmask = _jax_tree(mask_tree)
    assert tpruner.check_sparsity(tparams, None) == 100.0
    assert tpruner.check_sparsity(tparams, mask) == pytest.approx(
        jpruner.check_sparsity(_jax_tree(params), jmask), abs=1e-9)
    conv = tpruner.extract_mask(mask)
    assert sorted(conv) == sorted(n for n, p in tparams.items()
                                  if p.dim() == 4)
    assert len(conv) == len(jpruner.extract_mask(jmask))
    rev = tpruner.reverse_mask(mask)
    want = mask_from_jax(jax.tree.map(np.asarray,
                                      jpruner.reverse_mask(jmask)))
    for n in mask:
        assert torch.equal(rev[n], want[n]), n
    masked = tpruner.apply_prune_mask(tparams, mask)
    assert torch.equal(masked["conv1.weight"],
                       tparams["conv1.weight"] * mask["conv1.weight"])


# ------------------------------------------------------------------ scores


def _tiny():
    torch.manual_seed(0)
    tnet = TorchNet()
    return tnet, transport(tnet), dict(tnet.named_parameters())


def _batch(rng):
    x = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, 6)
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             "y": torch.from_numpy(y)})


def _jax_loss_grad(temperature):
    model = FlaxNet()

    def loss(p, batch):
        logits = model.apply({"params": p}, batch["x"]) / temperature
        ll = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(ll, batch["y"][:, None], axis=-1).mean()

    return jax.grad(loss)


def _torch_loss(tnet, temperature):
    def loss(p, batch):
        return F.cross_entropy(
            functional_call(tnet, p, (batch["x"],)) / temperature,
            batch["y"])

    return loss


def _assert_scores_close(got, want_tree):
    for n, g in got.items():
        w = np.asarray(flax_leaf(want_tree, n))
        g = to_flax_layout(n, g.detach().numpy())
        assert np.abs(g - w).max() <= SCORE_TOL * np.abs(w).max(), n


@pytest.mark.parametrize("which", ["snip", "grasp"])
def test_snip_and_grasp_scores_match_jax(rng, which):
    tnet, jparams, tparams = _tiny()
    jb, tb = _batch(rng)
    temp = 1.0 if which == "snip" else tpruner.GRASP_TEMPERATURE
    jfn = jpruner.snip_scores if which == "snip" else jpruner.grasp_scores
    tfn = tpruner.snip_scores if which == "snip" else tpruner.grasp_scores
    want = jfn(_jax_loss_grad(temp), jparams, jb)
    got = tfn(_torch_loss(tnet, temp), tparams, tb)
    _assert_scores_close(got, want)
    # SNIP's one-shot mask from those scores
    if which == "snip":
        _assert_equal_up_to_ties(
            tpruner.prune_by_scores(tparams, got, 0.5),
            jpruner.prune_by_scores(jparams, want, 0.5),
            {n: s.detach() for n, s in got.items()})


def test_synflow_scores_and_iterative_mask_match_jax():
    tnet, jparams, tparams = _tiny()
    want = jpruner.synflow_scores(FlaxNet(), jparams, (1, 8, 8, 3))
    got = tpruner.synflow_scores(tnet, tparams, (1, 3, 8, 8))
    _assert_scores_close(got, want)
    assert tnet.training  # the mode is restored
    mask = tpruner.synflow_prune(tnet, tparams, 0.5, (1, 3, 8, 8),
                                 iterations=4)
    jmask = jpruner.synflow_prune(FlaxNet(), jparams, 0.5, (1, 8, 8, 3),
                                  iterations=4)
    for n, m in mask.items():
        np.testing.assert_array_equal(
            to_flax_layout(n, m.numpy()), np.asarray(flax_leaf(jmask, n)),
            err_msg=n)


# --------------------------------------------------------------------- omp


def _retain(mod_d, mod_l):
    return mod_l.BatchIterator(mod_d.synthetic(n=32, seed=5), 32,
                               shuffle=True, seed=2)


@pytest.mark.parametrize("score", ["random", "l1"])
def test_omp_prune_matches_jax(resnet, monkeypatch, score):
    model, params, stats, twin = resnet
    key = jax.random.PRNGKey(5)
    state = TrainState.create({"params": _jax_tree(params),
                               "batch_stats": _jax_tree(stats)},
                              jax_sgd(0.01))
    jstate, jmask = jomp.omp_prune(
        model, state, jax_sgd(0.01), _retain(JD, JL), rate=0.2, epochs=1,
        rewind_epoch=0, key=key, score=score)

    seen = []
    l1 = tpruner.global_l1_prune
    monkeypatch.setattr(tpruner, "global_l1_prune",
                        lambda p, *a: seen.append(
                            {n: t.detach().clone() for n, t in p.items()})
                        or l1(p, *a))
    theta0 = {n: p.detach().clone() for n, p in twin.named_parameters()}
    opt = SGD(FlatParams(twin.parameters()), 0.01)
    mask = tomp.omp_prune(
        twin, opt, _retain(D, L), rate=0.2, epochs=1, rewind_epoch=0,
        source=jax_key_source(key, 10), device=torch.device("cpu"),
        score=score,
        uniform=_jax_uniform(params, jax.random.split(key)[1]))
    # rewound to the start, with a fresh optimizer
    for n, p in twin.named_parameters():
        assert torch.equal(p.detach(), theta0[n]), n
    assert opt.count == 0 and not opt.trace.any()
    np.testing.assert_array_equal(
        np.asarray(jstate.params["conv1"]["kernel"]),
        params["conv1"]["kernel"])
    if score == "random":
        _assert_equal_up_to_ties(mask, jmask, _jax_uniform(
            params, jax.random.split(key)[1]))
    else:
        # the port prunes its own trained weights as the JAX pruner does
        trained, = seen
        want = jpruner.global_l1_prune(_jax_tree(mask_to_jax(trained)), 0.2)
        _assert_equal_up_to_ties(mask, want, {n: t.abs()
                                              for n, t in trained.items()})
