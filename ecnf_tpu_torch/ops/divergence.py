"""Divergence (Jacobian trace) of batched vector fields (port of `ecnf_tpu/ops/divergence.py`).

These are the forward-mode autodiff routes (``torch.func.jvp`` over the
field, vmapped over directions).  They serve ``SolveConfig(
structured_tangent=False)`` and are the oracle of the hand-linearised
tangent in `ops/tangent.py`.
"""
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

Tensor = torch.Tensor
BatchedField = Callable[[Tensor], Tensor]  # [B, D] -> [B, D]


def zero_com_trace_basis(n_nodes: int, dim: int, device=None) -> Tensor:
    """Orthonormal basis of the zero-centre-of-mass hyperplane, flattened.

    Returns ``[(n_nodes-1)*dim, n_nodes*dim]`` rows built from the Helmert
    basis of the zero-sum subspace of R^{n_nodes}; with the ``dim``
    uniform translations they complete an orthonormal basis.
    """
    w = np.zeros((n_nodes - 1, n_nodes))
    for k in range(1, n_nodes):
        norm = 1.0 / np.sqrt(k * (k + 1.0))
        w[k - 1, :k] = norm
        w[k - 1, k] = -k * norm
    basis = np.einsum("kn,dj->kdnj", w, np.eye(dim))
    return torch.as_tensor(
        basis.reshape((n_nodes - 1) * dim, n_nodes * dim),
        dtype=torch.float32, device=device,
    )


def value_and_exact_divergence(
    f: BatchedField,
    x: Tensor,
    basis: Optional[Tensor] = None,
    trace_offset: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """``(f(x) [B, D], sum_k u_k^T J u_k (+ trace_offset) [B])``.

    ``basis``: ``[K, D]`` rows shared by the batch (``None`` = identity,
    the full trace).  The field must act on each sample independently.
    """
    B, D = x.shape
    if basis is None:
        basis = torch.eye(D, dtype=x.dtype, device=x.device)
    basis = basis.to(x.dtype)

    def col(e):
        _, jv = jvp(f, (x,), (e.expand(B, D),))
        return (jv * e).sum(dim=-1)

    value = f(x)
    div = vmap(col)(basis).sum(dim=0)
    if trace_offset is not None:
        div = div + trace_offset
    return value, div


def value_and_hutchinson_divergence(
    f: BatchedField, x: Tensor, eps: Tensor
) -> Tuple[Tensor, Tensor]:
    """``(f(x), eps . (J eps))`` with one fixed probe ``eps [B, D]`` per sample."""
    value, jv = jvp(f, (x,), (eps,))
    return value, (jv * eps).sum(dim=-1)


def value_and_multi_probe_hutchinson(
    f: BatchedField, x: Tensor, eps: Tensor
) -> Tuple[Tensor, Tensor]:
    """Hutchinson estimate averaged over ``eps [K, B, D]`` probes."""

    def est(e):
        return (jvp(f, (x,), (e,))[1] * e).sum(dim=-1)

    return f(x), vmap(est)(eps).mean(dim=0)
