"""Paired statistics for gap tables (gnngls_tpu/stats.py).

Comparisons of two guides rest on mean-gap differences of a few hundredths
of a percent over a few hundred instances; these put error bars on them:

  * bootstrap_mean_ci: percentile bootstrap CI on a mean, resampling
    instances;
  * paired_permutation_test: sign-flip test on per-instance differences
    between two guides evaluated on the same instances;
  * paired_compare: the bundle a results table quotes.

Pure numpy, deterministic under an explicit seed; the same draws as the JAX
package's copy.
"""

from __future__ import annotations

import numpy as np


def bootstrap_mean_ci(x, *, n_boot: int = 10_000, alpha: float = 0.05,
                      seed: int = 0):
    """Percentile bootstrap CI for the mean of x.

    Returns (mean, lo, hi)."""
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(n_boot, len(x)))
    means = x[idx].mean(axis=1)
    lo, hi = np.quantile(means, [alpha / 2, 1 - alpha / 2])
    return float(x.mean()), float(lo), float(hi)


def paired_permutation_test(a, b, *, n_perm: int = 20_000, seed: int = 0):
    """Two-sided paired sign-flip permutation test for mean(a - b) == 0.

    a, b: per-instance metrics on the same instances.  Under H0 (no guide
    effect) each per-instance difference is symmetric around 0, so flipping
    signs uniformly generates the null distribution of the mean difference.
    Returns (mean_diff, p_value).  With add-one smoothing the smallest
    reportable p is 1/(n_perm+1)."""
    d = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    obs = d.mean()
    rng = np.random.default_rng(seed)
    signs = rng.choice([-1.0, 1.0], size=(n_perm, len(d)))
    null = (signs * d).mean(axis=1)
    p = (1 + np.sum(np.abs(null) >= abs(obs))) / (n_perm + 1)
    return float(obs), float(p)


def paired_compare(gaps_a, gaps_b, *, label_a="regret_pred", label_b="weight",
                   n_boot: int = 10_000, n_perm: int = 20_000, seed: int = 0):
    """Full paired comparison of two per-instance gap arrays (same instances).

    Returns a JSON-ready dict: each guide's mean gap with bootstrap CI, the
    paired mean difference with CI (bootstrap over instance pairs), the
    sign-flip p-value, and the fraction of instances where a beats b.
    """
    gaps_a = np.asarray(gaps_a, dtype=np.float64)
    gaps_b = np.asarray(gaps_b, dtype=np.float64)
    assert gaps_a.shape == gaps_b.shape
    ma, loa, hia = bootstrap_mean_ci(gaps_a, n_boot=n_boot, seed=seed)
    mb, lob, hib = bootstrap_mean_ci(gaps_b, n_boot=n_boot, seed=seed + 1)
    d = gaps_a - gaps_b
    md, lod, hid = bootstrap_mean_ci(d, n_boot=n_boot, seed=seed + 2)
    _, p = paired_permutation_test(gaps_a, gaps_b, n_perm=n_perm, seed=seed + 3)
    return {
        label_a: {"mean": ma, "ci95": [loa, hia]},
        label_b: {"mean": mb, "ci95": [lob, hib]},
        "mean_diff": md,
        "diff_ci95": [lod, hid],
        "p_value_paired_sign_flip": p,
        "n_instances": int(len(d)),
        "frac_a_strictly_better": float((d < 0).mean()),
        "frac_tied": float((d == 0).mean()),
    }
