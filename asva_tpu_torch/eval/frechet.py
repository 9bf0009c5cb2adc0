"""Frechet distance between two feature sets (the FID / FVD reducer).

Port of asva_tpu/eval/frechet.py (:13-36): sample means and covariances in
float64 on the host, scipy's sqrtm of the covariance product, with the
epsilon fallback for a near-singular product.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def _sqrtm(m: np.ndarray) -> np.ndarray:
    from scipy import linalg
    out = linalg.sqrtm(m)
    return out[0] if isinstance(out, tuple) else out


def frechet_distance(x1, x2, eps: float = 1e-6) -> float:
    """x1 (n1, d), x2 (n2, d) features -> |mu1 - mu2|^2 + tr(S1) + tr(S2)
    - 2 tr(sqrtm(S1 S2))."""
    x1, x2 = _host(x1), _host(x2)
    mu1, mu2 = x1.mean(axis=0), x2.mean(axis=0)
    sigma1 = np.cov(x1, rowvar=False)
    sigma2 = np.cov(x2, rowvar=False)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("non-trivial imaginary component "
                             f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))
