"""The port's FID statistics and InceptionV3 (``salun_torch.evalx``) and its
``ddpm_evaluator`` CLI against ``salun.evalx`` / ``salun.cli.ddpm_evaluator``
on the same seeded inputs.

Weights: a flax tree of the JAX network's shapes (``jax.eval_shape`` of its
init, so no init is compiled) filled from a numpy seed, carried to the
port by ``state_dict_from_flax``; the CLI test writes it as a
pytorch-fid-named ``.pth`` that both CLIs load.

Tolerances:
- the statistics: both sides are the same numpy/scipy code, so the same
  arrays give the same numbers; held at 1e-12 relative;
- the resize (32 → 299 up, 512 → 299 down): 1e-5 (the same triangle
  weights summed in other orders);
- each block and the whole network: 1e-4 of the output's largest value
  (fp32 convolutions in other summation orders through up to 48 layers);
  the softmax 1e-6 absolute;
- the CLI on 6 + 6 images: the features as the network's; the metrics,
  computed on the first 64 dims of each feature on both sides (a scipy
  sqrtm at 2,048 dims takes tens of seconds), to 1e-3 relative,
  precision and recall exactly.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salun.cli.ddpm_evaluator as jax_evaluator
import salun.evalx.fid as jax_fid
import salun.evalx.inception as jax_inc
import salun_torch.evalx.fid as fid
import salun_torch.evalx.inception as inc
from _torch_port import one_torch_thread  # noqa: F401
from salun_torch.cli import ddpm_evaluator
from salun_torch.cli.ddpm_sample import write_png


def _fill(shapes, rng):
    """Seeded numpy leaves for a flax shape tree: He-scaled kernels, BN
    scale near 1, small biases and means, variances in [0.5, 1.5]."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if name == "var":
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_vars(module, x_shape, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape))
    v = _fill(shapes, np.random.default_rng(seed))
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def network():
    """(flax params, batch stats, the port's network carrying them)."""
    params, stats = _flax_vars(jax_inc.InceptionV3(), (1, 32, 32, 3), 0)
    model = inc.InceptionV3()
    model.load_state_dict(inc.state_dict_from_flax(params, stats),
                          strict=True)
    return params, stats, model.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ------------------------------------------------------------ statistics


def test_fid_statistics_need_two_samples():
    one = np.zeros((1, 4))
    for mod in (jax_fid, fid):
        with pytest.raises(ValueError, match=">= 2 samples"):
            mod.FIDStatistics.from_activations(one)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((64, 12)), rng.standard_normal((48, 12)) + 0.3
    want = jax_fid.FIDStatistics.from_activations(a).frechet_distance(
        jax_fid.FIDStatistics.from_activations(b))
    sa, sb = (fid.FIDStatistics.from_activations(x) for x in (a, b))
    np.testing.assert_array_equal(sa.mu, a.mean(0))
    np.testing.assert_array_equal(sa.sigma, np.cov(a, rowvar=False))
    np.testing.assert_allclose(sa.frechet_distance(sb), want, rtol=1e-12)


def test_inception_score_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.random((23, 10))
    p /= p.sum(1, keepdims=True)
    for split in (5000, 7):
        np.testing.assert_allclose(fid.inception_score(p, split),
                                   jax_fid.inception_score(p, split),
                                   rtol=1e-12)


def test_pairwise_and_manifold_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((37, 6)).astype(np.float32)
    b = rng.standard_normal((29, 6)).astype(np.float32)
    np.testing.assert_allclose(fid._pairwise_sq_dists(a, b, block=8),
                               jax_fid._pairwise_sq_dists(a, b, block=8),
                               rtol=1e-12)
    got, want = fid.ManifoldEstimator(a, 3, 16), jax_fid.ManifoldEstimator(
        a, 3, 16)
    np.testing.assert_allclose(got.radii, want.radii, rtol=1e-12)
    np.testing.assert_array_equal(got.evaluate(b), want.evaluate(b))
    assert fid.precision_recall(a, b) == jax_fid.precision_recall(a, b)


def test_evaluate_all_matches_jax():
    rng = np.random.default_rng(3)
    real, gen = rng.standard_normal((40, 8)), rng.standard_normal((40, 8))
    rs, gs = rng.standard_normal((40, 5)), rng.standard_normal((40, 5))
    sm = rng.random((40, 10))
    sm /= sm.sum(1, keepdims=True)
    want = jax_fid.evaluate_all(real, gen, rs, gs, sm)
    got = fid.evaluate_all(real, gen, rs, gs, sm)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


# ------------------------------------------------------------ network


@pytest.mark.parametrize("size", [32, 512], ids=["up_32", "down_512"])
def test_resize_matches_jax_image_resize(size):
    rng = np.random.default_rng(size)
    x = rng.random((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       "bilinear"))
    got = inc.resize_299(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


BLOCKS = {  # name: (flax block, port block, input channels, spatial)
    "A": (lambda: jax_inc.InceptionA(32), lambda c: inc.InceptionA(c, 32),
          24, 7),
    "B": (lambda: jax_inc.InceptionB(), inc.InceptionB, 24, 9),
    "C": (lambda: jax_inc.InceptionC(40), lambda c: inc.InceptionC(c, 40),
          24, 7),
    "D": (lambda: jax_inc.InceptionD(), inc.InceptionD, 24, 9),
    "E_avg": (lambda: jax_inc.InceptionE("avg"),
              lambda c: inc.InceptionE(c, "avg"), 24, 5),
    "E_max": (lambda: jax_inc.InceptionE("max"),
              lambda c: inc.InceptionE(c, "max"), 24, 5),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name):
    make_jax, make_port, c, s = BLOCKS[name]
    jax_block = make_jax()
    params, stats = _flax_vars(jax_block, (2, s, s, c), 10)
    x = np.random.default_rng(11).standard_normal((2, s, s, c)).astype(
        np.float32)
    # the avg-pool branch's edge counts (count_include_pad=False) and the
    # max pools' padding show only off the centre: negative inputs too
    want = np.asarray(jax_block.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    block = make_port(c)
    block.load_state_dict(inc.state_dict_from_flax(params, stats),
                          strict=True)
    with torch.no_grad():
        got = block.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_network_matches_flax(network):
    params, stats, model = network
    x = np.random.default_rng(12).random((2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jax_inc.InceptionV3().apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model(nchw(x))
    for g, w, what in zip(got, want, ("pool", "spatial", "softmax")):
        w = np.asarray(w)
        assert g.shape == w.shape, what
        atol = 1e-6 if what == "softmax" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=what)
    assert got[1].shape == (2, 17 * 17 * 7) and got[2].shape == (2, 1008)


# ------------------------------------------------------------ the CLI


def _folders(tmp_path, n=6):
    rng = np.random.default_rng(13)
    for name in ("ref", "gen"):
        d = tmp_path / name / "class_0"  # the walk reaches subfolders
        d.mkdir(parents=True)
        for i in range(n):
            write_png(str(d / f"{i}.png"),
                      rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
    return str(tmp_path / "ref"), str(tmp_path / "gen")


def test_ddpm_evaluator_cli_matches_jax(network, tmp_path, monkeypatch):
    params, stats, model = network
    weights = tmp_path / "pt_inception.pth"
    torch.save(model.state_dict(), weights)
    ref, gen = _folders(tmp_path)
    np.testing.assert_array_equal(ddpm_evaluator.read_images_folder(ref),
                                  jax_evaluator.read_images_folder(ref))

    # scipy's sqrtm takes tens of seconds at 2,048 dims, so the statistics
    # see the first 64 dims of each feature on both sides (the full-width
    # statistics are held above on small arrays; the features are held in
    # full here)
    seen = {}

    def truncated(side, real):
        def evaluate_all(r, g, rs, gs, sm):
            out = real(r[:, :64], g[:, :64], rs[:, :64], gs[:, :64], sm)
            seen[side] = ((r, g, rs, gs, sm), out)
            return out
        return evaluate_all

    monkeypatch.setattr(jax_fid, "evaluate_all",
                        truncated("jax", jax_fid.evaluate_all))
    monkeypatch.setattr(ddpm_evaluator, "evaluate_all",
                        truncated("port", fid.evaluate_all))
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    jax_evaluator.main([ref, gen, "--inception_weights", str(weights),
                        "--output_csv", str(jax_csv), "--batch_size", "4"])
    got = ddpm_evaluator.main([ref, gen, "--inception_weights", str(weights),
                               "--output_csv", str(port_csv),
                               "--batch_size", "4", "--device", "cpu"])
    for g, w in zip(seen["port"][0], seen["jax"][0]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    want = seen["jax"][1]
    assert got is seen["port"][1] and list(got) == list(want)
    for k in ("precision", "recall"):
        assert got[k] == want[k], k
    for k in ("inception_score", "fid", "sfid"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    rows_j = list(csv.reader(open(jax_csv)))
    rows_p = list(csv.reader(open(port_csv)))
    assert rows_p[0] == rows_j[0] and len(rows_p) == 2
    assert rows_p[1][:2] == [ref, gen]
    # a second call appends a row under the same header
    ddpm_evaluator.main([ref, ref, "--inception_weights", str(weights),
                         "--output_csv", str(port_csv), "--batch_size", "4",
                         "--device", "cpu"])
    rows_p = list(csv.reader(open(port_csv)))
    assert len(rows_p) == 3
    assert float(rows_p[2][rows_p[0].index("fid")]) == pytest.approx(
        0.0, abs=1e-3)
