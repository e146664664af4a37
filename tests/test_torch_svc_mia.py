"""SVC-MIA in the port against ``salun.evalx.svc_mia``.

The port fits its own libsvm-style solver (``RBFSVC``) where the JAX
package calls scikit-learn's ``SVC(C=3, gamma='auto')``. Both stop at the
same tolerance (1e-3) on the same problem, by different paths (the port
does not shrink), so decision values agree to ~1e-3 and predictions agree
except for samples within about that distance of the boundary. Tolerance on each attack
accuracy: 2 target samples (2/len(target)). Probabilities from
``collect_prob`` agree to 1e-5 (fp32 convolutions summed in different
orders).
"""

import numpy as np
import pytest
import torch

import salun.evalx.svc_mia as J
from _torch_port import jax_model_and_vars, port_twin
from salun.data import datasets as JD
from salun.data import loader as JL
from salun_torch.data import datasets as D
from salun_torch.data import loader as L
from salun_torch.evalx import svc_mia as P


def _probs(rng, n, classes=10, sharp=3.0):
    logits = rng.standard_normal((n, classes)) * sharp
    p = np.exp(logits - logits.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32), \
        rng.integers(0, classes, n).astype(np.int64)


def test_mia_dict_matches_jax_on_the_same_probabilities(rng, monkeypatch):
    st, se, te = _probs(rng, 300, sharp=4.0), _probs(rng, 300), \
        _probs(rng, 120, sharp=3.5)
    loaders = {"st": st, "se": se, "te": te}
    monkeypatch.setattr(J, "collect_prob",
                        lambda m, p, s, ld: loaders[ld] if ld else (None, None))
    want = J.SVC_MIA(None, None, None, shadow_train="st", shadow_test="se",
                     target_train=None, target_test="te")
    got = P.svc_mia_from_probs(st, se, (None, None), te)
    assert set(got) == set(want) == {"correctness", "confidence", "entropy",
                                     "m_entropy", "prob"}
    for k in want:
        assert abs(got[k] - want[k]) <= 2 / len(te[0]), (k, got[k], want[k])


@pytest.mark.parametrize("dim,binary", [(1, False), (1, True), (10, False)])
def test_rbf_svc_predictions_match_sklearn(rng, dim, binary):
    from sklearn.svm import SVC

    n = 250
    a = rng.random((n, dim))
    b = rng.random((n, dim)) * 0.9 + 0.05
    if binary:
        a, b = (a > 0.3).astype(float), (b > 0.5).astype(float)
    X = np.concatenate([a, b])
    Y = np.concatenate([np.ones(n), np.zeros(n)])
    T = rng.random((400, dim))
    ours = P.RBFSVC(C=3).fit(X, Y)
    ref = SVC(C=3, gamma="auto", kernel="rbf").fit(X, Y)
    np.testing.assert_array_equal(ours.predict(T), ref.predict(T))
    np.testing.assert_allclose(ours.decision_function(T),
                               ref.decision_function(T), atol=5e-3)


def test_collect_prob_matches_jax(rng):
    model, params, stats = jax_model_and_vars("resnet20s", rng)
    twin = port_twin("resnet20s", params, stats)
    ds, jds = D.synthetic(n=20, seed=9), JD.synthetic(n=20, seed=9)
    got_p, got_y = P.collect_prob(twin, L.BatchIterator(ds, 8, shuffle=False),
                                  torch.device("cpu"))
    want_p, want_y = J.collect_prob(model, params, stats,
                                    JL.BatchIterator(jds, 8, shuffle=False))
    assert got_p.shape == (20, 10)   # the 4 padding rows are dropped
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    assert P.collect_prob(twin, None, "cpu") == (None, None)
