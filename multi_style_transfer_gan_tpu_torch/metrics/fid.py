"""FID, the Frechet distance between two feature sets (a copy of the JAX
package's ``metrics/fid.py``, which has no framework dependency).

The statistic runs on the host in float64: the means and covariances of
the (N, D) features, and the matrix square roots through a symmetric
eigendecomposition (no scipy).

- ``fid_from_features(fa, fb)``: the statistic, given any (N, D) features
  (InceptionV3 pool features from ``metrics.inception``, or the harness's
  fallback features),
- ``frechet_distance(mu1, s1, mu2, s2)``: the closed form.
"""

from __future__ import annotations

import numpy as np


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    sym = (mat + mat.T) / 2.0
    w, v = np.linalg.eigh(sym)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w + eps)) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) — m_test.py:37-50 math."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1h @ sigma2 @ s1h)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats_a, feats_b) -> float:
    """FID between two (N, D) feature sets."""
    fa = np.asarray(feats_a, np.float64)
    fb = np.asarray(feats_b, np.float64)
    mu1, mu2 = fa.mean(0), fb.mean(0)
    s1 = np.cov(fa, rowvar=False)
    s2 = np.cov(fb, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)
