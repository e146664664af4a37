"""The port's threshold membership-inference benchmarks
(``salun_torch.evalx.BlackBoxBenchmarks``) against ``salun.evalx.mia`` on
seeded probabilities: the same host numpy on both sides, so every attack's
accuracy must agree to 1e-12 (absolute)."""

import numpy as np
import pytest

from salun.evalx.mia import BlackBoxBenchmarks as JaxBlackBox
from salun_torch.evalx import BlackBoxBenchmarks


def _set(rng, n, c, sharp):
    logits = rng.standard_normal((n, c)) * sharp
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    y = rng.integers(0, c, n)
    y[: n // 3] = p[: n // 3].argmax(1)  # some correct predictions
    return p.astype(np.float32), y


@pytest.mark.parametrize("num_classes,sizes", [
    (5, (60, 50, 40, 30)),
    (10, (12, 9, 7, 0)),        # classes with no sample; an empty target
])
def test_black_box_benchmarks_match_jax(rng, num_classes, sizes):
    sets = [_set(rng, n, num_classes, sharp)
            for n, sharp in zip(sizes, (4.0, 1.5, 3.0, 1.0))]
    if sizes[-1] == 0:
        sets[-1] = (np.zeros((0, num_classes), np.float32),
                    np.zeros(0, np.int64))
    ours = BlackBoxBenchmarks(*sets, num_classes=num_classes).run()
    theirs = JaxBlackBox(*sets, num_classes=num_classes).run()
    assert set(ours) == set(theirs) == {"correctness", "confidence",
                                         "entropy", "m_entropy"}
    for k, v in theirs.items():
        if np.isnan(v):
            assert np.isnan(ours[k]), k
        else:
            assert ours[k] == pytest.approx(v, rel=0, abs=1e-12), k
