"""K1 (fused masked SGD) in the port: its plain version against the JAX
Pallas kernel (interpret mode on the CPU), the JAX reference function and
the JAX main path's update, plus the wrapper's checks.

Tolerances. The port (kernel and plain version) sums in the JAX main
path's order ``(μ·buf + g·m) + wd·p`` (``masked_sgd_fused``); the Pallas
kernel and ``masked_sgd_update_reference`` sum ``μ·buf + (g·m + wd·p)``.
Against those two the momentum may differ by one rounding of the
three-term sum: at most 1 ulp of ``|μ·buf| + |g·m| + |wd·p|``; p by
``lr`` times that plus the two roundings of ``p - lr·buf`` (1 ulp of
``lr·(that sum)`` and 1 ulp of p). Against the main path's own update the
port is bitwise equal where the mask keeps a coordinate. Where it does not,
the port writes θ₀ exactly, while ``masked_sgd_fused`` emits the update
``θ₀ - p`` and ``optax.apply_updates`` computes ``p + (θ₀ - p)``, which can
miss θ₀ by one rounding (1 ulp of the larger of |p| and |θ₀ - p|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from salun.kernels.masked_update import BLOCK
from salun.kernels.masked_update import masked_sgd_update as jax_kernel
from salun.kernels.masked_update import (
    masked_sgd_update_reference as jax_reference)
from salun_torch.kernels.masked_update import (masked_sgd_update,
                                               masked_sgd_update_reference)

MU, WD = 0.9, 5e-4


def _inputs(rng, n):
    p = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m = (rng.random(n) > 0.5).astype(np.float32)
    t0 = rng.standard_normal(n).astype(np.float32)
    return p, b, g, m, t0


def _port(p, b, g, m, t0, lr):
    tp, tb = torch.from_numpy(p.copy()), torch.from_numpy(b.copy())
    masked_sgd_update(tp, tb, torch.from_numpy(g),
                      torch.from_numpy(m.astype(np.uint8)),
                      torch.from_numpy(t0),
                      torch.tensor([lr], dtype=torch.float32),
                      momentum=MU, wd=WD)
    return tp.numpy(), tb.numpy()


def _assert_one_rounding(got, want, p, b, g, m, lr):
    gp, gb = got
    wp, wb = (np.asarray(x) for x in want)
    mag = (np.abs(np.float32(MU) * b) + np.abs(g * m)
           + np.abs(np.float32(WD) * p)).astype(np.float32)
    tol_b = np.spacing(mag)
    assert np.all(np.abs(gb - wb) <= tol_b)
    lr = np.float32(lr)
    tol_p = np.spacing(np.abs(wp)) + np.spacing(lr * mag) + lr * tol_b
    assert np.all(np.abs(gp - wp) <= tol_p)
    # masked-out coordinates are exact
    keep = m > 0
    np.testing.assert_array_equal(gp[~keep], wp[~keep])
    np.testing.assert_array_equal(gb[~keep], 0.0)


@pytest.mark.parametrize("lr", [0.01, 0.013])
def test_plain_k1_matches_pallas_interpret(rng, lr):
    p, b, g, m, t0 = _inputs(rng, BLOCK)
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernel(jnp.asarray(p), jnp.asarray(b), jnp.asarray(g),
                          jnp.asarray(m), jnp.asarray(t0), lr,
                          momentum=MU, wd=WD)
    _assert_one_rounding(_port(p, b, g, m, t0, lr), want, p, b, g, m, lr)


def test_plain_k1_matches_jax_reference(rng):
    p, b, g, m, t0 = _inputs(rng, 10_007)
    want = jax_reference(jnp.asarray(p), jnp.asarray(b), jnp.asarray(g),
                         jnp.asarray(m), jnp.asarray(t0), 0.013,
                         momentum=MU, wd=WD)
    _assert_one_rounding(_port(p, b, g, m, t0, 0.013), want, p, b, g, m,
                         0.013)


def test_plain_k1_matches_masked_sgd_fused_step(rng):
    """One update of the JAX main path's optimizer: bitwise on kept
    coordinates; exactly θ₀ (port) vs within one rounding of it (JAX) on
    masked-out ones."""
    import optax

    from salun.core.masked_opt import masked_sgd_fused

    p, b, g, m, t0 = _inputs(rng, 4_099)
    tx = masked_sgd_fused(0.013, MU, WD, {"w": jnp.asarray(m)},
                          {"w": jnp.asarray(t0)})
    state = tx.init({"w": jnp.asarray(p)})
    state = state._replace(trace={"w": jnp.asarray(b)})
    upd, state = tx.update({"w": jnp.asarray(g)}, state,
                           {"w": jnp.asarray(p)})
    want_p = np.asarray(optax.apply_updates({"w": jnp.asarray(p)}, upd)["w"])
    got_p, got_b = _port(p, b, g, m, t0, 0.013)
    keep = m > 0
    np.testing.assert_array_equal(got_p[keep], want_p[keep])
    np.testing.assert_array_equal(got_b, np.asarray(state.trace["w"]))
    np.testing.assert_array_equal(got_p[~keep], t0[~keep])
    tol = np.spacing(np.maximum(np.abs(p), np.abs(t0 - p)))[~keep]
    assert np.all(np.abs(want_p[~keep] - t0[~keep]) <= tol)


def test_wrapper_updates_in_place_and_counts_no_cpu_launch(rng):
    p, b, g, m, t0 = _inputs(rng, 1000)
    tp, tb = torch.from_numpy(p.copy()), torch.from_numpy(b.copy())
    ptr_p, ptr_b = tp.data_ptr(), tb.data_ptr()
    before = masked_sgd_update.launches
    lr = torch.tensor([0.01])
    masked_sgd_update(tp, tb, torch.from_numpy(g),
                      torch.from_numpy(m.astype(np.uint8)),
                      torch.from_numpy(t0), lr)
    assert (tp.data_ptr(), tb.data_ptr()) == (ptr_p, ptr_b)
    want_p, want_b = masked_sgd_update_reference(
        torch.from_numpy(p), torch.from_numpy(b), torch.from_numpy(g),
        torch.from_numpy(m.astype(np.uint8)), torch.from_numpy(t0), lr)
    assert torch.equal(tp, want_p) and torch.equal(tb, want_b)
    assert masked_sgd_update.launches == before  # the plain path is no launch


@pytest.mark.parametrize("bad", ["mask_dtype", "length", "lr_shape",
                                 "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    n = 64
    args = {"p": torch.zeros(n), "buf": torch.zeros(n), "g": torch.zeros(n),
            "mask": torch.ones(n, dtype=torch.uint8),
            "theta0": torch.zeros(n), "lr": torch.tensor([0.1])}
    if bad == "mask_dtype":
        args["mask"] = torch.ones(n)
    elif bad == "length":
        args["g"] = torch.zeros(n + 1)
    elif bad == "lr_shape":
        args["lr"] = torch.tensor([0.1, 0.2])
    else:
        args["theta0"] = torch.zeros(2 * n)[::2]
    with pytest.raises((TypeError, ValueError)):
        masked_sgd_update(*args.values())


def test_build_dir_is_the_checkouts_or_the_override(monkeypatch, tmp_path):
    from pathlib import Path

    from salun_torch.kernels import _build

    root = Path(_build.__file__).resolve().parents[2]
    monkeypatch.delenv("SALUN_TORCH_BUILD_DIR", raising=False)
    assert _build._build_dir() == root / "build" / "salun_torch_kernels"
    monkeypatch.setenv("SALUN_TORCH_BUILD_DIR", str(tmp_path))
    assert _build._build_dir() == tmp_path
