"""Threshold black-box membership-inference benchmarks (counterpart of
``salun/evalx/mia.py``; reference Classification/evaluation/MIA.py:6-191,
Song & Mittal's "systematic evaluation" attacks).

The correctness attack, and per-class threshold attacks on confidence,
negative entropy and negative modified entropy, each threshold picked on
the shadow data to maximise balanced accuracy (MIA.py:81-123). Host numpy
over precomputed ``(probs, labels)`` pairs, as in the JAX package; a
library function on no CLI path.
"""

from __future__ import annotations

import numpy as np

from .svc_mia import entropy, m_entropy


def _confidence(prob, labels):
    return np.take_along_axis(prob, labels[:, None], axis=1)[:, 0]


def _best_threshold(tr_values, te_values):
    """Balanced-accuracy-maximising threshold (MIA.py:81-91): the first
    candidate, in shadow-train then shadow-test order, that reaches the
    best accuracy."""
    best_thre, best_acc = 0.0, 0.0
    for v in np.concatenate([tr_values, te_values]):
        tr_ratio = np.mean(tr_values >= v) if len(tr_values) else 0.0
        te_ratio = np.mean(te_values < v) if len(te_values) else 0.0
        acc = 0.5 * (tr_ratio + te_ratio)
        if acc > best_acc:
            best_thre, best_acc = v, acc
    return best_thre


class BlackBoxBenchmarks:
    """MIA.py ``black_box_benchmarks`` over ``(probs [N, C], labels [N])``
    pairs for the shadow and target train/test sets."""

    def __init__(self, shadow_train, shadow_test, target_train, target_test,
                 num_classes: int):
        self.num_classes = num_classes
        self.s_tr_p, self.s_tr_y = shadow_train
        self.s_te_p, self.s_te_y = shadow_test
        self.t_tr_p, self.t_tr_y = target_train
        self.t_te_p, self.t_te_y = target_test

    def _mem_inf_via_corr(self):
        t_tr = np.mean(np.argmax(self.t_tr_p, 1) == self.t_tr_y)
        t_te = 1.0 - np.mean(np.argmax(self.t_te_p, 1) == self.t_te_y)
        return 0.5 * (t_tr + t_te)

    def _mem_inf_thre(self, s_tr_v, s_te_v, t_tr_v, t_te_v):
        """Per-class threshold attack (MIA.py:107-123)."""
        tr_mem = te_non = 0
        for c in range(self.num_classes):
            thre = _best_threshold(s_tr_v[self.s_tr_y == c],
                                   s_te_v[self.s_te_y == c])
            tr_mem += np.sum(t_tr_v[self.t_tr_y == c] >= thre)
            te_non += np.sum(t_te_v[self.t_te_y == c] < thre)
        t_tr_acc = tr_mem / max(len(self.t_tr_y), 1)
        t_te_acc = te_non / max(len(self.t_te_y), 1)
        return 0.5 * (t_tr_acc + t_te_acc)

    def _attack(self, value):
        """The threshold attack on ``value(probs, labels)``."""
        return self._mem_inf_thre(value(self.s_tr_p, self.s_tr_y),
                                  value(self.s_te_p, self.s_te_y),
                                  value(self.t_tr_p, self.t_tr_y),
                                  value(self.t_te_p, self.t_te_y))

    def run(self) -> dict:
        return {"correctness": self._mem_inf_via_corr(),
                "confidence": self._attack(_confidence),
                "entropy": self._attack(lambda p, y: -entropy(p)),
                "m_entropy": self._attack(lambda p, y: -m_entropy(p, y))}
