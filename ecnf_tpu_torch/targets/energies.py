"""Boltzmann target energies, batched over dense pairwise distances (port
of `ecnf_tpu/targets/energies.py`).

The sum over ordered pairs i != j equals the reference's loop over an
edge list that holds both directions of every pair, halved where the
reference halves.
"""
from typing import Union

import torch

from ecnf_tpu_torch.ops.graph import dense_edge_mask, pairwise_difference
from ecnf_tpu_torch.ops.numerics import safe_norm

Tensor = torch.Tensor


def _check_rank(x: Tensor) -> None:
    if x.dim() not in (2, 3):
        raise ValueError(f"expected [N, D] or [B, N, D] positions, got {tuple(x.shape)}")


def double_well_energy(
    x: Tensor,
    a: float = 0.0,
    b: float = -4.0,
    c: float = 0.9,
    d0: float = 4.0,
    tau: float = 1.0,
) -> Tensor:
    """Double-well energy of ``x [..., N, D]`` -> ``[...]``: over ordered
    pairs, ``a d + b d^2 + c d^4`` with ``d = |x_i - x_j| - d0``, halved
    and divided by ``tau`` (hyper-parameters of arXiv 2006.02425)."""
    n_nodes = x.shape[-2]
    d = safe_norm(pairwise_difference(x), dim=-1)  # the diagonal is masked below
    mask = dense_edge_mask(n_nodes, dtype=x.dtype, device=x.device)
    dm = d - d0
    per_edge = a * dm + b * dm**2 + c * dm**4
    return torch.sum(per_edge * mask, dim=(-1, -2)) / tau / 2.0


def double_well_log_prob(x: Tensor, temperature: float = 1.0) -> Tensor:
    """Unnormalised log density of ``[N, D]`` or ``[B, N, D]`` positions."""
    _check_rank(x)
    return -double_well_energy(x, tau=temperature)


def lennard_jones_energy(
    x: Tensor,
    epsilon: float = 1.0,
    tau: float = 1.0,
    r: Union[float, Tensor] = 1.0,
    harmonic_potential_coef: float = 0.5,
) -> Tensor:
    """Lennard-Jones 12-6 energy with a harmonic restraint to the centre of
    mass, for ``x [..., N, D]`` -> ``[...]``:

    ``eps / (2 tau) * sum_{i != j} (r_i/d_ij)^12 - 2 (r_i/d_ij)^6
    + coef * sum_i |x_i - com|^2``

    with ``r`` one radius or one per receiver ``i`` (``[N]``).
    """
    n_nodes = x.shape[-2]
    if not isinstance(r, Tensor) or r.dim() == 0:
        r = torch.ones(n_nodes, dtype=x.dtype, device=x.device) * r
    d = safe_norm(pairwise_difference(x), dim=-1)  # [..., N, N]; the diagonal is masked
    mask = dense_edge_mask(n_nodes, dtype=x.dtype, device=x.device)
    rr = r[:, None]  # the receiver's radius along axis i
    term = (rr / d) ** 12 - 2.0 * (rr / d) ** 6
    energy = epsilon / (2.0 * tau) * torch.sum(term * mask, dim=(-1, -2))

    com = torch.mean(x, dim=-2, keepdim=True)
    harmonic = harmonic_potential_coef * torch.sum((x - com) ** 2, dim=(-1, -2))
    return energy + harmonic


def lennard_jones_log_prob(x: Tensor) -> Tensor:
    """Unnormalised log density of ``[N, D]`` or ``[B, N, D]`` positions."""
    _check_rank(x)
    return -lennard_jones_energy(x)
