"""Kernel Inception Distance: the unbiased MMD^2 with a polynomial kernel.

Port of `panopticdiffusionmodels_tpu/evaluation/kid.py` (Binkowski et al.
2018, arXiv:1801.01401), in float64 numpy on the host, with the same checks
and the same subset draws (`np.random.RandomState(seed)`).  FID's estimator
is biased at small N (with D = 2048 pool3 features and N < D the sample
covariance is singular); the unbiased MMD^2 under k(x, y) = (<x, y>/D + 1)^3
has expectation 0 when the two distributions match, at any N, and block
(subset) estimates give an error bar.  `exclude_matched=True` drops the
index-matched cross terms, for two runs that share their noise seeds and
conditioning index by index, whose matched pairs are correlated.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["polynomial_kernel", "mmd2_unbiased", "kid"]


def polynomial_kernel(
    x: np.ndarray,
    y: np.ndarray,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef0: float = 1.0,
) -> np.ndarray:
    """k(x, y) = (gamma <x, y> + coef0)^degree; gamma defaults to 1/D
    (the KID paper's kernel)."""
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def mmd2_unbiased(
    kxx: np.ndarray,
    kyy: np.ndarray,
    kxy: np.ndarray,
    exclude_matched: bool = False,
) -> float:
    """Unbiased MMD^2 from precomputed kernel blocks.

    Within-set terms drop their diagonals (the standard U-statistic).  With
    `exclude_matched=True` the cross term also drops its index-matched
    diagonal (requires square kxy) — see the module docstring for why the
    seed-paired gate runs need this.
    """
    m = kxx.shape[0]
    n = kyy.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    if exclude_matched:
        if kxy.shape[0] != kxy.shape[1]:
            raise ValueError("exclude_matched needs equally sized sets")
        sum_xy = (kxy.sum() - np.trace(kxy)) / (m * (n - 1))
    else:
        sum_xy = kxy.sum() / (m * n)
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def kid(
    acts_a: np.ndarray,
    acts_b: np.ndarray,
    subset_size: Optional[int] = None,
    n_subsets: int = 100,
    seed: int = 0,
    exclude_matched: bool = False,
    degree: int = 3,
) -> Tuple[float, float]:
    """(mean, std) of the unbiased MMD^2 over random subsets.

    Block estimation follows the KID paper / torch-fidelity: draw `n_subsets`
    subsets of `subset_size` (default min(N, 1000)) without replacement from
    each set, compute the unbiased estimator on each, report mean and std of
    the block estimates.  The std is the calibrated error bar the quality
    gate's verdict uses.

    With `exclude_matched=True`, both sets must be index-aligned (sample i of
    `acts_a` shares its seed/conditioning with sample i of `acts_b`): the SAME
    subset indices are drawn for both sets and the matched diagonal is
    excluded, so seed pairing cannot deflate the estimate.
    """
    a = np.ascontiguousarray(acts_a, np.float64)
    b = np.ascontiguousarray(acts_b, np.float64)
    if subset_size is None:
        subset_size = min(min(len(a), len(b)), 1000)
    if subset_size < 2:
        raise ValueError("subset_size must be >= 2")
    if exclude_matched and len(a) != len(b):
        raise ValueError("exclude_matched needs equally sized sets")
    rs = np.random.RandomState(seed)
    vals = np.empty(n_subsets)
    for i in range(n_subsets):
        ia = rs.choice(len(a), subset_size, replace=False)
        # matched mode: identical indices on both sides so that the kxy
        # diagonal is exactly the seed-paired terms to exclude
        ib = ia if exclude_matched else rs.choice(len(b), subset_size, replace=False)
        xa, xb = a[ia], b[ib]
        vals[i] = mmd2_unbiased(
            polynomial_kernel(xa, xa, degree=degree),
            polynomial_kernel(xb, xb, degree=degree),
            polynomial_kernel(xa, xb, degree=degree),
            exclude_matched=exclude_matched,
        )
    return float(vals.mean()), float(vals.std())
