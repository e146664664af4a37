"""Generative-model evaluation: FID, sFID, Inception Score, Precision/Recall
(counterpart of ``salun/evalx/fid.py``; the same numpy/scipy code, so the
same features give the same numbers).

Parity with DDPM/evaluator.py (the OpenAI guided-diffusion evaluator):
- ``FIDStatistics.frechet_distance``  (evaluator.py:108-157)
- Inception Score from softmax preds (evaluator.py:69-75)
- ``ManifoldEstimator`` k-NN precision/recall (evaluator.py:258-424)
- batched pairwise-distance blocks   (evaluator.py:425-498)

The features come from ``salun_torch.evalx.inception`` (on the card); the
statistics run on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray

    @classmethod
    def from_activations(cls, acts: np.ndarray) -> "FIDStatistics":
        if len(acts) < 2:
            # np.cov degenerates to a 0-d array and the distance errors
            # cryptically downstream
            raise ValueError(
                f"FID needs >= 2 samples per side, got {len(acts)}")
        return cls(mu=acts.mean(axis=0), sigma=np.cov(acts, rowvar=False))

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        """‖μ₁−μ₂‖² + Tr(Σ₁+Σ₂−2√(Σ₁Σ₂)) (evaluator.py:117-157)."""
        from scipy import linalg

        mu1, sigma1 = self.mu, self.sigma
        mu2, sigma2 = other.mu, other.sigma
        diff = mu1 - mu2

        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm(
                (sigma1 + offset).dot(sigma2 + offset)
            )
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                m = np.max(np.abs(covmean.imag))
                raise ValueError(f"Imaginary component {m}")
            covmean = covmean.real
        return float(
            diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean)
        )


def inception_score(softmax_preds: np.ndarray, split_size: int = 5000) -> float:
    """exp(E KL(p(y|x) ‖ p(y))) averaged over splits (evaluator.py IS)."""
    scores = []
    for i in range(0, len(softmax_preds), split_size):
        part = softmax_preds[i : i + split_size]
        kl = part * (np.log(part + 1e-10) - np.log(part.mean(0, keepdims=True) + 1e-10))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores))


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray, block: int = 1024) -> np.ndarray:
    """Blocked ‖a−b‖² matrix (evaluator.py:425-498 DistanceBlock)."""
    out = np.empty((len(a), len(b)), np.float32)
    b_sq = (b**2).sum(1)
    for i in range(0, len(a), block):
        ai = a[i : i + block]
        d = (ai**2).sum(1)[:, None] + b_sq[None, :] - 2.0 * ai @ b.T
        out[i : i + block] = np.maximum(d, 0.0)
    return out


class ManifoldEstimator:
    """k-NN manifold estimator for improved precision/recall
    (evaluator.py:258-424)."""

    def __init__(self, features: np.ndarray, nhood_size: int = 3,
                 block: int = 1024):
        self.features = features.astype(np.float32)
        d = _pairwise_sq_dists(self.features, self.features, block)
        # k-th smallest distance excluding self (evaluator's kth=nhood+1)
        self.radii = np.partition(d, nhood_size, axis=1)[:, nhood_size]
        self.block = block

    def evaluate(self, other: np.ndarray) -> np.ndarray:
        """fraction of ``other`` inside this manifold's k-NN hyperspheres."""
        d = _pairwise_sq_dists(other.astype(np.float32), self.features,
                               self.block)
        return (d <= self.radii[None, :]).any(axis=1)


def precision_recall(
    real_features: np.ndarray, gen_features: np.ndarray,
    nhood_size: int = 3,
) -> Tuple[float, float]:
    """(precision, recall) (evaluator.py compute_prec_recall)."""
    real_m = ManifoldEstimator(real_features, nhood_size)
    gen_m = ManifoldEstimator(gen_features, nhood_size)
    precision = float(real_m.evaluate(gen_features).mean())
    recall = float(gen_m.evaluate(real_features).mean())
    return precision, recall


def evaluate_all(
    real_pool: np.ndarray, gen_pool: np.ndarray,
    real_spatial: Optional[np.ndarray] = None,
    gen_spatial: Optional[np.ndarray] = None,
    gen_softmax: Optional[np.ndarray] = None,
) -> dict:
    """The evaluator.py headline metric set → dict (evaluator.py:69-101)."""
    out = {}
    if gen_softmax is not None:
        out["inception_score"] = inception_score(gen_softmax)
    out["fid"] = FIDStatistics.from_activations(real_pool).frechet_distance(
        FIDStatistics.from_activations(gen_pool)
    )
    if real_spatial is not None and gen_spatial is not None:
        out["sfid"] = FIDStatistics.from_activations(
            real_spatial
        ).frechet_distance(FIDStatistics.from_activations(gen_spatial))
    prec, rec = precision_recall(real_pool, gen_pool)
    out["precision"] = prec
    out["recall"] = rec
    return out
