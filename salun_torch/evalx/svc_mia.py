"""SVM membership-inference attack (counterpart of ``salun/evalx/svc_mia.py``).

Reference Classification/evaluation/SVC_MIA.py:25-150: softmax
probabilities are collected on the device; per-sample features
(correctness, confidence, entropy, modified entropy, raw prob) are numpy,
copied from the JAX package; an RBF SVC with C=3 and gamma='auto' is
fitted on shadow_train (members) vs shadow_test (non-members) and scored on
the targets.

The JAX package fits ``sklearn.svm.SVC``. The port carries its own solver,
:class:`RBFSVC`, because it must run where scikit-learn is not installed:
libsvm's SMO for C-SVC (second-order working-set selection, stopping
tolerance 1e-3, bias from the free support vectors) in float64 numpy, with
kernel columns computed on demand. It leaves out libsvm's shrinking, which
changes the path to the tolerance but not the problem solved.
"""

from __future__ import annotations

import numpy as np
import torch

from salun_torch.data.loader import to_device, to_float

_TAU = 1e-12
_EPS = 1e-3  # libsvm's stopping tolerance (scikit-learn's SVC default)


@torch.no_grad()
def collect_prob(model, loader, device):
    """Softmax probabilities and labels of the weighted rows of ``loader``
    (SVC_MIA.py:25-50); ``(None, None)`` for an absent or empty loader."""
    if loader is None:
        return None, None
    model.eval()
    ps, ys = [], []
    for b in loader:
        batch = to_device(b, device)
        out = model(to_float(batch["image"]))
        p = torch.softmax(out.to(torch.float32), dim=-1).cpu().numpy()
        w = np.asarray(b["weight"]) > 0
        ps.append(p[w])
        ys.append(np.asarray(b["label"])[w])
    if not ps:
        return None, None
    return np.concatenate(ps), np.concatenate(ys).astype(np.int64)


def entropy(p: np.ndarray) -> np.ndarray:
    logp = np.where(p > 0, np.log(np.maximum(p, 1e-30)), 0.0)
    return -(p * logp).sum(-1)


def m_entropy(p: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Modified prediction entropy (Song & Mittal)."""
    eps = 1e-30
    log_p = np.log(np.maximum(p, eps))
    rev = 1.0 - p
    log_rev = np.log(np.maximum(rev, eps))
    mod_p = p.copy()
    mod_logp = log_rev.copy()
    r = np.arange(len(labels))
    mod_p[r, labels] = rev[r, labels]
    mod_logp[r, labels] = log_p[r, labels]
    return -(mod_p * mod_logp).sum(-1)


def features(prob: np.ndarray, labels: np.ndarray) -> dict:
    corr = (np.argmax(prob, axis=1) == labels).astype(np.float64)[:, None]
    conf = np.take_along_axis(prob, labels[:, None], axis=1)
    return {
        "correctness": corr,
        "confidence": conf,
        "entropy": entropy(prob)[:, None],
        "m_entropy": m_entropy(prob, labels)[:, None],
        "prob": prob,
    }


class RBFSVC:
    """Binary C-SVC with the kernel ``exp(-gamma·|x - x'|²)``,
    ``gamma = 1/n_features`` (scikit-learn's ``gamma='auto'``), solved as
    libsvm solves it (Fan, Chen and Lin, JMLR 2005)."""

    def __init__(self, C: float = 3.0):
        self.C = float(C)

    def _column(self, i: int) -> np.ndarray:
        x, sq = self._x, self._sq
        return np.exp(-self._g * (sq + sq[i] - 2.0 * (x @ x[i])))

    def fit(self, X: np.ndarray, y01: np.ndarray) -> "RBFSVC":
        """Fit on labels 0/1. As in scikit-learn's libsvm, the samples are
        grouped by class (0 first) and class 0 is the solver's +1, which
        fixes the order in which ties are broken."""
        pos = np.asarray(y01) > 0
        order = np.concatenate([np.flatnonzero(~pos), np.flatnonzero(pos)])
        x = np.asarray(X, np.float64).reshape(len(X), -1)[order]
        y = np.where(pos[order], -1.0, 1.0)
        n, d = x.shape
        self._g = 1.0 / d
        self._x, self._sq = x, np.einsum("ij,ij->i", x, x)
        C, eps = self.C, _EPS
        alpha = np.zeros(n)
        G = -np.ones(n)            # gradient of ½αᵀQα − eᵀα at α = 0
        max_iter = max(10_000_000, 100 * n)
        for _ in range(max_iter):
            # working set (libsvm select_working_set, WSS 3); the last
            # index wins ties, as libsvm's >= / <= scans do
            up = np.where(y > 0, alpha < C, alpha > 0)       # I_up
            low = np.where(y > 0, alpha > 0, alpha < C)      # I_low
            yg = -y * G
            if not up.any() or not low.any():
                break
            cand = np.where(up, yg, -np.inf)
            i = n - 1 - int(np.argmax(cand[::-1]))
            gmax = cand[i]
            gmax2 = np.max(np.where(low, -yg, -np.inf))
            if gmax + gmax2 < eps:
                break
            Ki = self._column(i)
            b = gmax - yg
            ok = low & (b > 0)
            if not ok.any():
                break
            a = 2.0 - 2.0 * Ki     # K_ii + K_tt − 2K_it with K_tt = 1
            a = np.where(a > 0, a, _TAU)
            obj = np.where(ok, -(b * b) / a, np.inf)
            j = n - 1 - int(np.argmin(obj[::-1]))
            Kj = self._column(j)
            self._update(alpha, G, y, i, j, Ki, Kj)
        self._finish(alpha, G, y)
        return self

    def _update(self, alpha, G, y, i, j, Ki, Kj):
        """libsvm's two-variable step with clipping to the box."""
        C = self.C
        Qij = y[i] * y[j] * Ki[j]
        ai, aj = alpha[i], alpha[j]
        if y[i] != y[j]:
            quad = 2.0 + 2.0 * Qij
            quad = quad if quad > 0 else _TAU
            delta = (-G[i] - G[j]) / quad
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0:
                if aj < 0:
                    aj, ai = 0.0, diff
            elif ai < 0:
                ai, aj = 0.0, -diff
            if diff > 0:
                if ai > C:
                    ai, aj = C, C - diff
            elif aj > C:
                aj, ai = C, C + diff
        else:
            quad = 2.0 - 2.0 * Qij
            quad = quad if quad > 0 else _TAU
            delta = (G[i] - G[j]) / quad
            s = ai + aj
            ai -= delta
            aj += delta
            if s > C:
                if ai > C:
                    ai, aj = C, s - C
            elif aj < 0:
                aj, ai = 0.0, s
            if s > C:
                if aj > C:
                    aj, ai = C, s - C
            elif ai < 0:
                ai, aj = 0.0, s
        dai, daj = ai - alpha[i], aj - alpha[j]
        alpha[i], alpha[j] = ai, aj
        # G_k += Q_ki·Δα_i + Q_kj·Δα_j, Q_kt = y_k·y_t·K_kt
        G += y * (y[i] * dai * Ki + y[j] * daj * Kj)

    def _finish(self, alpha, G, y):
        """Bias as libsvm's calculate_rho; keep the support vectors."""
        C = self.C
        yG = y * G
        at_ub, at_lb = alpha >= C, alpha <= 0
        free = ~at_ub & ~at_lb
        if free.any():
            rho = float(yG[free].mean())
        else:
            ub_set = (at_ub & (y < 0)) | (at_lb & (y > 0))
            lb_set = (at_ub & (y > 0)) | (at_lb & (y < 0))
            ub = yG[ub_set].min() if ub_set.any() else np.inf
            lb = yG[lb_set].max() if lb_set.any() else -np.inf
            rho = float((ub + lb) / 2)
        sv = alpha > 0
        self.rho = rho
        self.sv_x = self._x[sv]
        self.sv_coef = (alpha * y)[sv]
        del self._x, self._sq

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """Signed distance, positive towards class 1 (scikit-learn's sign)."""
        x = np.asarray(X, np.float64).reshape(len(X), -1)
        sq_sv = np.einsum("ij,ij->i", self.sv_x, self.sv_x)
        out = np.empty(len(x))
        for lo in range(0, len(x), 4096):
            xb = x[lo:lo + 4096]
            sq = np.einsum("ij,ij->i", xb, xb)
            k = np.exp(-self._g * (sq[:, None] + sq_sv[None, :]
                                   - 2.0 * xb @ self.sv_x.T))
            out[lo:lo + 4096] = self.rho - k @ self.sv_coef
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Class 1 where the decision is >= 0 (libsvm picks class 0 only
        for a strictly positive solver value)."""
        return (self.decision_function(X) >= 0).astype(np.float64)


def svc_fit_predict(shadow_train, shadow_test, target_train, target_test):
    """SVC_MIA.py:53-82: fit member/non-member on shadows, score targets."""
    X = np.concatenate([shadow_train, shadow_test]).reshape(
        len(shadow_train) + len(shadow_test), -1)
    Y = np.concatenate([np.ones(len(shadow_train)), np.zeros(len(shadow_test))])
    clf = RBFSVC(C=3).fit(X, Y)

    accs = []
    if target_train is not None and len(target_train) > 0:
        accs.append(clf.predict(target_train.reshape(len(target_train), -1)).mean())
    if target_test is not None and len(target_test) > 0:
        accs.append(1 - clf.predict(target_test.reshape(len(target_test), -1)).mean())
    return float(np.mean(accs))


def SVC_MIA(model, *, shadow_train, shadow_test, target_train, target_test,
            device) -> dict:
    """Five attack accuracies (SVC_MIA.py:85-150); loaders may be None.

    Forget efficacy (main_random.py:165-186): shadow_train =
    retain[:len(test)], shadow_test = test, target_test = forget.
    """
    probs = [collect_prob(model, ld, device)
             for ld in (shadow_train, shadow_test, target_train, target_test)]
    return svc_mia_from_probs(*probs)


def svc_mia_from_probs(st, se, tt, te) -> dict:
    """The attack on collected ``(prob, label)`` pairs (either may be
    ``(None, None)``)."""
    widths = [p.shape[1] for p, _ in (st, se, tt, te) if p is not None]
    if not widths:
        raise ValueError("SVC_MIA: every split is empty")
    n_classes = widths[0]

    def _or_empty(p, y):
        if p is None:
            return (np.zeros((0, n_classes), np.float32),
                    np.zeros((0,), np.int64))
        return p, y

    st_p, st_y = _or_empty(*st)
    se_p, se_y = _or_empty(*se)
    tt_p, tt_y = _or_empty(*tt)
    te_p, te_y = _or_empty(*te)

    f_st = features(st_p, st_y)
    f_se = features(se_p, se_y)
    f_tt = features(tt_p, tt_y) if len(tt_p) else {k: None for k in f_st}
    f_te = features(te_p, te_y) if len(te_p) else {k: None for k in f_st}

    return {
        name: svc_fit_predict(f_st[name], f_se[name], f_tt[name], f_te[name])
        for name in ("correctness", "confidence", "entropy", "m_entropy", "prob")
    }
