"""Hand-linearised EGNN trace (port of `ecnf_tpu/ops/pallas/tangent_kernel.py`).

One residual-capturing primal runs per field evaluation; K tangent
columns are then pushed through each EGNN block by explicit algebra.  The
geometry and node-level parts are plain torch ops over ``[K, B, ...]``;
the edge-level chains of each block go through `ops.edge_primal` (the
primal with its residuals) and `ops.edge_tangent`, whose CUDA kernels run
when the tensors are on a card.  Forward and trace only:
this path serves the log-density ODE solves, which are never
differentiated.  Scope: the plain-MLP EGNN.
"""
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ecnf_tpu_torch.ops import edge_primal as _primal
from ecnf_tpu_torch.ops import edge_tangent as _edge
from ecnf_tpu_torch.ops.graph import dense_edge_mask
from ecnf_tpu_torch.ops.numerics import timestep_embedding

Tensor = torch.Tensor


class BlockWeights(NamedTuple):
    """One EGNN block's parameters in the compute dtype: kernels in
    ``[in, out]`` form and contiguous (the layout the edge kernel reads),
    and the biases the primal needs (the tangent ignores them)."""

    cd_h: Tensor  # time-ConcatDense rows for h          [H, H]
    cd_t: Tensor  # time-ConcatDense rows for temb       [T, H]
    e_s: Tensor  # phi_e first-layer sender rows         [H, U]
    e_r: Tensor  # phi_e first-layer receiver rows       [H, U]
    e_l: Tensor  # phi_e first-layer length row          [U]
    e_tail: Tuple[Tensor, ...]  # phi_e Dense kernels    (L-1) x [U, U]
    x_tail: Tuple[Tensor, ...]  # phi_x Dense kernels    L x [U, U]
    x_out: Tensor  # phi_x output Dense(1) kernel        [U]
    g_out: Tensor  # gate Dense(1) kernel                [U]
    h_m: Tensor  # phi_h first-layer m_i rows            [U, U]
    h_h: Tensor  # phi_h first-layer h rows              [H, U]
    h_tail: Tuple[Tensor, ...]  # phi_h Dense kernels    (L-1) x [U, U]
    h_out: Tensor  # phi_h final Dense(H) kernel         [U, H]
    cd_b: Tensor  # time-ConcatDense bias                [H]
    e_b: Tuple[Tensor, ...]  # phi_e biases              L x [U]
    x_b: Tuple[Tensor, ...]  # phi_x biases              L x [U]
    x_out_b: Tensor  # phi_x output bias                 []
    g_out_b: Tensor  # gate bias                         []
    h_b: Tuple[Tensor, ...]  # phi_h biases              (L+1) x [U .. H]


def block_weights(egnn, i: int, cd: torch.dtype) -> BlockWeights:
    """Block ``i``'s parameters from an `models.egnn.EGNN`."""

    def k(layer) -> Tensor:  # torch [out, in] -> [in, out]
        return layer.weight.detach().T.to(cd).contiguous()

    def b(layer) -> Tensor:
        return layer.bias.detach().to(cd)

    H = egnn.time_dense[i].in_widths[0]
    U = egnn.mlp_units[-1]
    blk = egnn.blocks[i]
    e = [k(l) for l in blk.phi_e.layers]
    kt = k(egnn.time_dense[i])
    kh = k(blk.phi_h.layers[0])
    h = [k(l) for l in blk.phi_h.layers]
    return BlockWeights(
        cd_h=kt[:H].contiguous(),
        cd_t=kt[H:].contiguous(),
        e_s=e[0][:H].contiguous(),
        e_r=e[0][H : 2 * H].contiguous(),
        e_l=e[0][2 * H].contiguous(),
        e_tail=tuple(e[1:]),
        x_tail=tuple(k(l) for l in blk.phi_x.layers),
        x_out=k(blk.phi_x_out)[:, 0].contiguous(),
        g_out=k(blk.gate)[:, 0].contiguous(),
        h_m=kh[:U].contiguous(),
        h_h=kh[U:].contiguous(),
        h_tail=tuple(h[1:-1]),
        h_out=h[-1],
        cd_b=b(egnn.time_dense[i]),
        e_b=tuple(b(l) for l in blk.phi_e.layers),
        x_b=tuple(b(l) for l in blk.phi_x.layers),
        x_out_b=b(blk.phi_x_out)[0],
        g_out_b=b(blk.gate)[0],
        h_b=tuple(b(l) for l in blk.phi_h.layers),
    )


def trace_weights(field) -> List[BlockWeights]:
    """Every block's `BlockWeights` of a `cnf.build.FlatEGNNField`, in its
    compute dtype.  A solve takes them once, not at every field evaluation."""
    cd = field.compute_dtype or torch.float32
    return [block_weights(field.egnn, i, cd) for i in range(len(field.egnn.blocks))]


class BlockResiduals(NamedTuple):
    """Per-block primal quantities consumed by the tangent pass."""

    vec: Tensor  # block input coordinates            [B, N, D] f32
    l2: Tensor  # squared distances (clamped)         [B, N, N] f32
    active: Tensor  # clamp-inactive mask (raw > 0)   [B, N, N] bool
    lengths: Tensor  # safe distances                 [B, N, N] f32
    phi: Tensor  # phi_x output                       [B, N, N] f32
    w: Tensor  # masked coordinate weights            [B, N, N] f32
    d_e: Tuple[Tensor, ...]  # phi_e silu' factors    L x [B, N, N, U] cd
    d_x: Tuple[Tensor, ...]  # phi_x silu' factors    L x [B, N, N, U] cd
    m: Tensor  # edge messages m_ij                   [B, N, N, U] cd
    g: Tensor  # gate                                 [B, N, N] cd
    gd: Tensor  # gate derivative g * (1 - g)         [B, N, N] cd
    d_h: Tuple[Tensor, ...]  # phi_h silu' factors    L x [B, N, U] cd


def block_forward(
    vec: Tensor, h: Tensor, temb: Tensor, wt: BlockWeights,
    normalization_constant: float, with_residuals: bool = True, use_kernel: bool = False,
) -> Tuple[Tensor, Tensor, Optional[BlockResiduals]]:
    """One EGNN block, time ConcatDense included (the math of
    `models.egnn`, with its casts): ``vec [B, N, D]`` f32 and ``h [B, N, H]``
    f32 before the ConcatDense -> ``(vec_out, h_out, residuals or None)``.
    The h residual adds the post-ConcatDense h.  The edge chain runs the
    `edge_primal` kernel when residuals are asked for, ``use_kernel`` is
    set and `edge_primal.kernel_takes` the tensors (bf16 on a card);
    otherwise `edge_primal_reference`."""
    B, N, D = vec.shape
    C = normalization_constant
    mask = dense_edge_mask(N, vec.dtype, vec.device)
    cd = wt.e_s.dtype
    h = (
        h.to(cd) @ wt.cd_h + (temb.to(cd) @ wt.cd_t)[:, None, :] + wt.cd_b
    ).to(vec.dtype)

    gram = torch.einsum("bnd,bmd->bnm", vec, vec)
    r2 = torch.diagonal(gram, dim1=-2, dim2=-1)
    raw = r2[:, :, None] + r2[:, None, :] - 2.0 * gram
    l2 = torch.clamp(raw, min=0.0)
    lengths = torch.where(l2 == 0, 1.0, l2) ** 0.5

    def layer(z, ds):
        if with_residuals:
            ds.append(_primal.dsilu(z))
        return F.silu(z)

    hb = h.to(cd)
    a, b = hb @ wt.e_s, hb @ wt.e_r
    if with_residuals and use_kernel and _primal.kernel_takes(
        a.device, cd, N, a.shape[-1], len(wt.e_b)
    ):
        edge = _primal.edge_primal(a, b, l2, wt)
    else:
        edge = _primal.edge_primal_reference(a, b, l2, wt, with_residuals)
    phi, m_i = edge.phi, edge.m_i

    w = phi * mask / (C + lengths)
    shifts = w.sum(dim=2)[:, :, None] * vec - torch.einsum("bij,bjd->bid", w, vec)
    vec_out = vec + shifts / (N - 1)

    d_h = []
    a = layer(m_i.to(cd) @ wt.h_m + hb @ wt.h_h + wt.h_b[0], d_h)
    for k, bias in zip(wt.h_tail, wt.h_b[1:-1]):
        a = layer(a @ k + bias, d_h)
    h_out = (a @ wt.h_out + wt.h_b[-1]).to(h.dtype) + h

    res = None
    if with_residuals:
        res = BlockResiduals(
            vec=vec, l2=l2, active=raw > 0, lengths=lengths, phi=phi, w=w,
            d_e=edge.d_e, d_x=edge.d_x, m=edge.m, g=edge.g, gd=edge.gd,
            d_h=tuple(d_h),
        )
    return vec_out, h_out, res


def egnn_forward_residuals(
    pos: Tensor, h0: Tensor, temb: Tensor, weights: Sequence[BlockWeights],
    normalization_constant: float, final_scaling: Tensor, use_kernel: bool = False,
) -> Tuple[Tensor, List[BlockResiduals]]:
    """EGNN torso forward, returning ``(out [B, N, D] f32, per-block
    residuals)``; ``use_kernel`` as in `block_forward`."""
    pos_mean = pos.mean(dim=-2, keepdim=True)
    vec = pos - pos_mean
    initial_vec = vec
    h = h0
    residuals = []
    for wt in weights:
        vec, h, res = block_forward(
            vec, h, temb, wt, normalization_constant, use_kernel=use_kernel
        )
        residuals.append(res)
    out = (vec - initial_vec - pos_mean) * final_scaling
    return out, residuals


def _block_tangent(
    vec_t: Tensor, h_t: Tensor, res: BlockResiduals, wt: BlockWeights,
    cd: torch.dtype, normalization_constant: float, use_kernel: bool,
) -> Tuple[Tensor, Tensor]:
    """Propagate K tangent columns through one EGNN block.

    ``vec_t [K, B, N, D]`` f32, ``h_t [K, B, N, H]`` f32 (before the time
    ConcatDense).  ``use_kernel`` routes the edge chain through
    `edge_tangent` (the CUDA kernel on a card); otherwise it runs the plain
    `edge_tangent_reference` on any device.
    """
    K, B, N, D = vec_t.shape
    C = normalization_constant
    vec = res.vec
    mask = dense_edge_mask(N, torch.float32, vec.device)

    # Time-ConcatDense tangent (temb is constant), back to f32.
    hcd_t = (h_t.to(cd) @ wt.cd_h).float()

    # First-layer node tangents (cd) and geometry tangent (f32).
    hb_t = hcd_t.to(cd)
    a_t = hb_t @ wt.e_s
    b_t = hb_t @ wt.e_r
    gram_t = torch.einsum("kbnd,bmd->kbnm", vec_t, vec)
    gram_t = gram_t + gram_t.transpose(-1, -2)
    r2_t = 2.0 * (vec * vec_t).sum(dim=-1)
    raw_t = r2_t[..., :, None] + r2_t[..., None, :] - 2.0 * gram_t
    l2_t = torch.where(res.active, raw_t, 0.0)

    edge = _edge.edge_tangent if use_kernel else _edge.edge_tangent_reference
    phi_t, mi_t = edge(
        a_t, b_t, l2_t, res.d_e, res.d_x, res.m, res.g, res.gd,
        wt.e_l, wt.e_tail, wt.x_tail, wt.x_out, wt.g_out,
    )

    # Coordinate-update tangent: w = phi * mask / (C + len).
    den = C + res.lengths
    len_t = torch.where(res.l2 == 0, 0.0, 0.5 * l2_t / res.lengths)
    w_t = mask * (phi_t * den - res.phi * len_t) / (den * den)
    shifts_t = (
        w_t.sum(dim=-1)[..., None] * vec
        + res.w.sum(dim=-1)[..., None] * vec_t
        - torch.einsum("kbij,bjd->kbid", w_t, vec)
        - torch.einsum("bij,kbjd->kbid", res.w, vec_t)
    )
    vec_t_out = vec_t + shifts_t / (N - 1)

    # phi_h tangent (node level): fused first layer over [m_i, h'].
    t = res.d_h[0] * (mi_t.to(cd) @ wt.h_m + hb_t @ wt.h_h)
    for d, k in zip(res.d_h[1:], wt.h_tail):
        t = d * (t @ k)
    h_t_out = (t @ wt.h_out).float() + hcd_t
    return vec_t_out, h_t_out


@torch.no_grad()
def egnn_value_and_trace(
    field, x: Tensor, t: Tensor, features: Tensor, basis: Tensor,
    trace_offset: Optional[Tensor] = None, use_kernel: bool = True,
    weights: Optional[Sequence[BlockWeights]] = None,
) -> Tuple[Tensor, Tensor]:
    """Field value and restricted exact trace of a `cnf.build.FlatEGNNField`.

    Returns ``(f(x) [B, D], sum_k u_k^T J u_k (+ trace_offset) [B])``.
    ``weights`` is `trace_weights(field)`, taken once per solve by the
    caller; it is rebuilt here when not given.  The MLPs run in the dtype
    of the weights given (f32 weights give the f32 trace of a bf16 field).  Two basis forms:

    - ``[K, D]``: rows shared by the batch (the zero-CoM trace basis or
      identity columns);
    - ``[K, B, D]``: per-sample directions (Hutchinson probes); the caller
      averages over K.

    Both are exact for arbitrary directions: the seed is the zero-CoM
    projection and the translation component is reconstructed in the
    epilogue (the EGNN is translation-structured).
    """
    egnn = field.egnn
    n_nodes, dim = field.n_nodes, field.dim
    B = x.shape[0]
    K = basis.shape[0]
    pos = x.reshape(B, n_nodes, dim)
    h0 = field.embed(features.reshape(B, n_nodes).long())
    temb = timestep_embedding(t, field.time_embedding_dim)

    if weights is None:
        weights = trace_weights(field)
    cd = weights[0].e_s.dtype
    final_scaling = egnn.final_scaling.detach()
    out, residuals = egnn_forward_residuals(
        pos, h0, temb, weights, egnn.normalization_constant, final_scaling, use_kernel
    )
    value = out.reshape(B, n_nodes * dim)

    # Tangent seeds: the zero-CoM projection of each direction.
    if basis.dim() == 3:
        e = basis.float().reshape(K, B, n_nodes, dim)
        e_mean = e.mean(dim=2, keepdim=True)
        vec_t = e - e_mean
    else:
        e = basis.float().reshape(K, n_nodes, dim)
        e_mean = e.mean(dim=1, keepdim=True)[:, None]
        e = e[:, None]  # [K, 1, N, D], broadcasts against the batch
        vec_t = (e - e_mean).expand(K, B, n_nodes, dim)
    h_t = torch.zeros((K, B, n_nodes, h0.shape[-1]), dtype=torch.float32, device=x.device)

    for res, wt in zip(residuals, weights):
        vec_t, h_t = _block_tangent(
            vec_t, h_t, res, wt, cd, egnn.normalization_constant, use_kernel
        )

    # Epilogue: J e = fs * (V'(Px) Pe - Pe - e_mean).
    out_t = (vec_t - (e - e_mean) - e_mean) * final_scaling
    div = torch.einsum("kbnd,kbnd->b", out_t, e.expand_as(out_t))
    if trace_offset is not None:
        div = div + trace_offset
    return value, div
