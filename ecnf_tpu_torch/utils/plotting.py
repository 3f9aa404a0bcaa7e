"""Evaluation figures: the metric-history panel and pairwise-distance
histograms (port of `ecnf_tpu/utils/plotting.py`), in torch on the data's
device, drawn as SVG by `utils.figure` (the card has no matplotlib).

As in the JAX package: each unordered pair's distance appears twice,
distances are clipped for binning, counts take ``[lower, upper)`` bins
(values out of range count in the denominator only), and the shared bin
edges of `bin_samples_by_dist` are computed as ``jnp.linspace`` computes
them (`jax_linspace`), so both packages bin the same distances alike.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ecnf_tpu_torch.ops.graph import pairwise_difference
from ecnf_tpu_torch.utils.figure import Figure

Tensor = torch.Tensor


def plot_history(history: dict) -> Optional[Figure]:
    """A one-column panel of scalar metric histories.  Non-finite entries
    are dropped per series, with their count in the panel's title; the
    rest keep their index on the x-axis, so gaps stay visible."""
    if not history:
        return None
    keys = list(history)
    figure = Figure(len(keys), 1, figsize=(7, 3 * len(keys)))
    for ax, key in zip(figure.axes, keys):
        series = np.asarray([_scalar(v) for v in history[key]], dtype=np.float64)
        finite = np.isfinite(series)
        ax.plot(np.nonzero(finite)[0], series[finite])
        n_dropped = int(series.size - finite.sum())
        ax.set_title(key if n_dropped == 0 else f"{key} ({n_dropped} non-finite dropped)")
    return figure


def _scalar(v) -> float:
    """``v`` as a float if it is a real number of shape (), else NaN."""
    a = np.asarray(v.tolist() if hasattr(v, "tolist") else v)
    if a.shape == () and np.issubdtype(a.dtype, np.number) and not np.iscomplexobj(a):
        return float(a)
    return float("nan")


def get_pairwise_distances_for_plotting(
    samples: Tensor, n_vertices: Optional[int] = None, max_distance: float = 7.99
) -> Tensor:
    """Distances of every ordered pair ``i != j`` of the first
    ``n_vertices`` nodes of ``samples [B, N, D]``, flattened (sample,
    receiver, sender) and clipped at ``max_distance`` (NaN stays NaN)."""
    assert samples.dim() == 3  # [batch, n_nodes, dim]
    n = samples.shape[1] if n_vertices is None else min(samples.shape[1], n_vertices)
    norms = torch.linalg.vector_norm(pairwise_difference(samples[:, :n]), dim=-1)
    rows, cols = np.where(~np.eye(n, dtype=bool))
    d = norms[:, torch.as_tensor(rows, device=samples.device), torch.as_tensor(cols, device=samples.device)]
    return d.flatten().clamp(max=max_distance)


def jax_linspace(start: Tensor, stop: Tensor, num: int) -> Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 by the formula XLA compiles
    it to on the CPU, ``fma(i, stop * r, start * (1 - i * r))`` with ``r``
    the f32 reciprocal of ``num - 1`` (the fused multiply-add done in
    float64, whose product is exact), the last point ``stop`` itself: the
    same points as JAX's, or an ulp apart."""
    start = torch.as_tensor(start, dtype=torch.float32)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=start.device)
    if num == 1:
        return start.reshape(1)
    r = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=start.device)
    head = start * (1 - i * r)
    out = (head.double() + i.double() * (stop * r.to(start.device)).double()).float()
    return torch.cat([out, stop.reshape(1)])


def default_bins() -> Tensor:
    """The JAX package's default bins, ``linspace(0, 8, 50)``."""
    return jax_linspace(torch.tensor(0.0), torch.tensor(8.0), 50)


def get_counts(distances: Tensor, bins: Optional[Tensor] = None, normalize: bool = True) -> Tensor:
    """Counts of ``distances [n]`` in the bins ``[bins[i], bins[i+1])``
    (default `default_bins`), over ``n`` when ``normalize``.  A value below
    the first edge, at or above the last, or NaN, lands in no bin but still
    counts in ``n``."""
    assert distances.dim() == 1
    bins = default_bins().to(distances.device) if bins is None else bins.to(distances.device)
    n_bins = bins.shape[0] - 1
    idx = torch.searchsorted(bins.contiguous(), distances.contiguous(), right=True) - 1
    in_range = (idx >= 0) & (idx < n_bins) & ~torch.isnan(distances)
    counts = torch.bincount(torch.where(in_range, idx, n_bins), minlength=n_bins + 1)[:n_bins]
    if normalize:
        return counts / distances.shape[0]
    return counts


def bin_samples_by_dist(
    samples_list: Sequence[Tensor],
    max_distance: float = 100.0,
    max_bin_fallback: float = 10.0,
    num_bins: int = 100,
) -> Tuple[Tensor, List[Tensor]]:
    """Shared edges ``linspace(0, top + 0.05, num_bins)``, ``top`` the
    largest finite distance of all the sample sets (``max_bin_fallback``
    when none is finite), and each set's normalized counts in them.
    Non-finite distances are sent to -1: below every bin, in the
    denominator."""
    sanitized = []
    for samples in samples_list:
        d = get_pairwise_distances_for_plotting(samples, max_distance=max_distance)
        sanitized.append(torch.where(torch.isfinite(d), d, torch.full_like(d, -1.0)))
    top = torch.stack([d.max() for d in sanitized]).max()
    top = torch.where(torch.isfinite(top), top, torch.full_like(top, max_bin_fallback))
    bins = jax_linspace(torch.zeros_like(top), top + 0.05, num_bins)
    # Normalized by the f32 reciprocal of the count, as the compiled JAX
    # function computes ``counts / n``.
    return bins, [get_counts(d, bins, normalize=False) * (torch.tensor(1.0) / d.shape[0]).to(d.device)
                  for d in sanitized]
