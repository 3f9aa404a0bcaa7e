"""Divergence (Jacobian trace) of batched vector fields (port of `ecnf_tpu/ops/divergence.py`).

These are the forward-mode autodiff routes (``torch.func.jvp`` over the
field, vmapped over directions).  They serve ``SolveConfig(
structured_tangent=False)``, a chunked exact trace, Hutch++ and every
field without a structured tangent (`StableMLP`), and are the oracle of the
hand-linearised tangent in `ops/tangent.py`; the exact route also runs
with its columns split over the ranks of a mesh.  Within one vmapped JVP
the primal is computed once (it does not depend on the direction), so a
chunk of columns costs one primal and its tangent streams.
"""
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ecnf_tpu_torch.parallel.mesh import all_reduce_sum, axis_size, rows

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
    column_chunk: Optional[int] = None,
    basis: Optional[Tensor] = None,
    trace_offset: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """``(f(x) [B, D], sum_k u_k^T J u_k (+ trace_offset) [B])``.

    ``basis``: ``[K, D]`` rows shared by the batch (``None`` = identity,
    the full trace).  The field must act on each sample independently.
    ``column_chunk``: take the columns this many at a time, which bounds
    the memory of the tangent streams to one chunk's; the chunks' sums are
    added in order, as the JAX package's scan adds them (its zero padding
    of the last chunk adds nothing).
    """
    B, D = x.shape
    if basis is None:
        basis = torch.eye(D, dtype=x.dtype, device=x.device)
    basis = basis.to(x.dtype)

    def col(e):
        _, jv = jvp(f, (x,), (e.expand(B, D),))
        return (jv * e).sum(dim=-1)

    value = f(x)
    if column_chunk is None or column_chunk >= basis.shape[0]:
        div = vmap(col)(basis).sum(dim=0)
    else:
        if column_chunk < 1:
            raise ValueError(f"column_chunk must be >= 1, got {column_chunk}")
        div = torch.zeros((B,), dtype=x.dtype, device=x.device)
        for chunk in basis.split(column_chunk):
            div = div + vmap(col)(chunk).sum(dim=0)
    if trace_offset is not None:
        div = div + trace_offset
    return value, div


def sharded_value_and_exact_divergence(
    f: BatchedField,
    x: Tensor,
    mesh,
    axis_name: str = "data",
    batch_axis: Optional[str] = None,
    basis: Optional[Tensor] = None,
    trace_offset: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact divergence with the trace's columns split over the ranks of a
    mesh (`ecnf_tpu_torch.parallel`), for small-batch scoring where the
    columns outnumber the samples.

    ``x [B, D]`` is the whole batch on every rank.  The basis rows
    (identity when None) are padded with zero rows to a multiple of the
    ranks along ``axis_name``; each rank takes its block of them and, with
    ``batch_axis``, its block of the batch, runs `value_and_exact_divergence`
    on them and sums the partial traces over ``axis_name`` with one
    ``all_reduce``.  Returns ``(f(x), divergence)`` for this rank's rows
    (all of them without ``batch_axis``).  ``mesh=None`` (a single process)
    is `value_and_exact_divergence`.
    """
    B, D = x.shape
    if basis is None:
        basis = torch.eye(D, dtype=x.dtype, device=x.device)
    basis = basis.to(x.dtype)
    n_pad = (-basis.shape[0]) % axis_size(mesh, axis_name)
    # Zero rows add nothing to the trace.
    basis = torch.cat([basis, basis.new_zeros((n_pad, D))])
    x_local = x if batch_axis is None else rows(x, mesh, batch_axis)
    value, div = value_and_exact_divergence(f, x_local, basis=rows(basis, mesh, axis_name))
    all_reduce_sum(div, mesh, axis_name)
    if trace_offset is not None:
        div = div + trace_offset
    return value, div


def exact_divergence(f: BatchedField, x: Tensor, column_chunk: Optional[int] = None) -> Tensor:
    """Exact per-sample divergence (see `value_and_exact_divergence`); the
    JAX package's `exact_divergence`, kept so its callers port by name."""
    return value_and_exact_divergence(f, x, column_chunk)[1]


def value_and_hutchinson_divergence(
    f: BatchedField, x: Tensor, eps: Tensor
) -> Tuple[Tensor, Tensor]:
    """``(f(x), eps . (J eps))`` with one fixed probe ``eps [B, D]`` per sample."""
    value, jv = jvp(f, (x,), (eps,))
    return value, (jv * eps).sum(dim=-1)


def hutchinson_divergence(f: BatchedField, x: Tensor, eps: Tensor) -> Tensor:
    """Hutchinson trace estimate (see `value_and_hutchinson_divergence`);
    the JAX package's `hutchinson_divergence`, kept so its callers port by
    name."""
    return value_and_hutchinson_divergence(f, x, eps)[1]


def value_and_multi_probe_hutchinson(
    f: BatchedField, x: Tensor, eps: Tensor
) -> Tuple[Tensor, Tensor]:
    """Hutchinson estimate averaged over ``eps [K, B, D]`` probes."""

    def est(e):
        return (jvp(f, (x,), (e,))[1] * e).sum(dim=-1)

    return f(x), vmap(est)(eps).mean(dim=0)


def value_and_hutchpp_divergence(
    f: BatchedField, x: Tensor, sketch: Tensor, probes: Tensor
) -> Tuple[Tensor, Tensor]:
    """Hutch++ trace estimate (Meyer, Musco, Musco & Woodruff 2021), the
    non-symmetric form of the JAX package's.

    Per sample, ``Q`` is the thin QR basis of the sketch ``Y = J S``, and
    ``tr(J) = tr(Q^T J Q) + E[g^T J g]`` with ``g = (I - Q Q^T) eps``: the
    estimate is unbiased for any Jacobian, and its random part sees only
    the spectrum outside the sketched subspace.  Neither term depends on
    which orthonormal basis of ``span(Y)`` the QR returns.

    ``sketch [M1, B, D]`` and ``probes [M2, B, D]`` are Gaussian draws;
    ``2 M1 + M2`` Jacobian-vector products.  With ``M2 = 0`` the result is
    the sketch's term alone (exact when ``J``'s rank is at most ``M1``).
    Returns ``(f(x) [B, D], divergence estimate [B])``.
    """

    def jv(e):
        return jvp(f, (x,), (e,))[1]

    value = f(x)
    y = vmap(jv)(sketch)  # [M1, B, D] = J s_k
    q, _ = torch.linalg.qr(y.permute(1, 2, 0))  # [B, D, M1]
    qk = q.permute(2, 0, 1)  # [M1, B, D]
    t_sketch = torch.einsum("kbd,kbd->b", vmap(jv)(qk), qk)
    if probes.shape[0] == 0:
        return value, t_sketch
    qte = torch.einsum("bdk,jbd->jbk", q, probes)
    g = probes - torch.einsum("bdk,jbk->jbd", q, qte)
    t_resid = torch.einsum("jbd,jbd->jb", vmap(jv)(g), g).mean(dim=0)
    return value, t_sketch + t_resid
