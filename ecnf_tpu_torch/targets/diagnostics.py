"""MCMC convergence diagnostics for the regenerated DW4/LJ13 datasets
(a copy of `ecnf_tpu/targets/diagnostics.py`, numpy only).

Acceptance rate alone cannot certify HMC samples (0.99 acceptance can mean
tiny steps and no mixing), so dataset generation is gated on:

- **split-R̂** (Gelman-Rubin with split chains): between/within-chain
  variance ratio of a scalar summary; values near 1 indicate the chains
  agree with each other and are stationary within themselves.
- **bulk ESS** via Geyer's initial-monotone-sequence autocorrelation sum:
  how many effectively independent draws the chains hold.

All functions take per-chain series ``[n_chains, n_samples]`` in numpy.
"""
from typing import Callable, Dict, Optional

import numpy as np


def split_chains(stats: np.ndarray) -> np.ndarray:
    """Split each chain in half: ``[C, S] -> [2C, S//2]`` (drops an odd tail)."""
    stats = np.asarray(stats, dtype=np.float64)
    assert stats.ndim == 2, stats.shape
    half = stats.shape[1] // 2
    assert half >= 2, "need at least 4 samples per chain to split"
    return np.concatenate([stats[:, :half], stats[:, half : 2 * half]], axis=0)


def split_rhat(stats: np.ndarray) -> float:
    """Split-R̂ of a per-chain scalar series ``[n_chains, n_samples]``.

    Standard Gelman-Rubin potential scale reduction on split chains;
    values ≲ 1.01 are excellent, > 1.05 indicates non-convergence.
    """
    x = split_chains(stats)
    m, t = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = t * chain_means.var(ddof=1)
    if w <= 0.0:
        return 1.0 if b <= 0.0 else np.inf
    var_hat = (t - 1) / t * w + b / t
    return float(np.sqrt(var_hat / w))


def _autocorr_fft(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation of one series via FFT."""
    x = x - x.mean()
    n = len(x)
    f = np.fft.rfft(x, n=2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:n] / n
    if acov[0] <= 0:
        return np.zeros(n)
    return acov / acov[0]


def bulk_ess(stats: np.ndarray) -> float:
    """Effective sample size of ``[n_chains, n_samples]`` scalar series.

    Chain-averaged autocorrelations truncated by Geyer's initial positive
    (monotone) sequence; returns the total ESS across chains.
    """
    x = split_chains(stats)
    m, t = x.shape
    rho = np.mean([_autocorr_fft(row) for row in x], axis=0)
    # Sum consecutive pairs; stop at the first non-positive pair, enforce
    # monotone decrease (Geyer 1992).
    pair_sums = rho[: t - t % 2].reshape(-1, 2).sum(axis=1)
    tau = 0.0
    prev = np.inf
    for p in pair_sums:
        if p <= 0:
            break
        p = min(p, prev)
        prev = p
        tau += p
    tau = max(2.0 * tau - 1.0, 1.0)  # integrated autocorrelation time
    return float(m * t / tau)


def mean_pairwise_distance(samples: np.ndarray) -> np.ndarray:
    """Mean inter-particle distance per configuration ``[..., N, D] -> [...]``."""
    x = np.asarray(samples, dtype=np.float64)
    diff = x[..., :, None, :] - x[..., None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    n = x.shape[-2]
    iu = np.triu_indices(n, k=1)
    return dist[..., iu[0], iu[1]].mean(-1)


def mcmc_diagnostics(
    samples: np.ndarray,
    n_chains: int,
    log_prob_fn: Optional[Callable] = None,
    extra_stats: Optional[Dict[str, Callable]] = None,
) -> Dict[str, float]:
    """Convergence report for chain-major flat HMC output.

    Args:
        samples: ``[n_chains * n_per_chain, N, D]`` in chain-major order
            (the layout `ecnf_tpu_torch.targets.mcmc.run_hmc` returns).
        n_chains: chain count used to fold the leading axis back.
        log_prob_fn: optional target log-prob (batched) for the energy
            statistic.
        extra_stats: optional ``{name: fn}`` of per-configuration scalar
            statistics ``[B, N, D] -> [B]``.

    Returns:
        ``{"rhat_<stat>", "ess_<stat>", "mean_<stat>"}`` per statistic.
    """
    samples = np.asarray(samples)
    by_chain = samples.reshape(n_chains, -1, *samples.shape[1:])
    stats: Dict[str, Callable] = {"dist": mean_pairwise_distance}
    if log_prob_fn is not None:
        stats["energy"] = lambda x: -np.asarray(log_prob_fn(x))
    stats.update(extra_stats or {})

    report: Dict[str, float] = {}
    for name, fn in stats.items():
        series = np.stack(
            [np.asarray(fn(chain)) for chain in by_chain]
        )  # [C, S]
        report[f"rhat_{name}"] = split_rhat(series)
        report[f"ess_{name}"] = bulk_ess(series)
        report[f"mean_{name}"] = float(series.mean())
    return report
