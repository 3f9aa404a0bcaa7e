"""E(n)-equivariant GNN vector field on dense edges (port of `ecnf_tpu/models/egnn.py`).

The dtype boundaries are the JAX package's: geometry (Gram-matrix
distances, coordinate weights, aggregation) stays f32, the edge and node
MLPs run in the compute dtype, ``(m_ij * gate)`` is cast to f32 before the
masked sum over senders, and ``h`` is cast back to f32 after the time
ConcatDense.
"""
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ecnf_tpu_torch.models.mlp import MLP, ConcatDense
from ecnf_tpu_torch.ops.graph import dense_edge_mask

Tensor = torch.Tensor


class EGCL(nn.Module):
    """One E(n)-equivariant graph convolution layer (dense edges).

    Submodules and their flax names: ``phi_e`` = ``MLP_0``, ``phi_x`` =
    ``MLP_1``, ``phi_x_out`` = ``Dense_0``, ``gate`` = ``Dense_1``,
    ``phi_h`` = ``MLP_2``.
    """

    def __init__(
        self,
        mlp_units: Sequence[int],
        n_invariant_feat_hidden: int,
        normalization_constant: float = 1.0,
        variance_scaling_init: float = 0.001,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        H, U = n_invariant_feat_hidden, mlp_units[-1]
        cd = compute_dtype
        self.normalization_constant = normalization_constant
        self.phi_e = MLP((H, H, 1), mlp_units, activate_final=True, compute_dtype=cd)
        self.phi_x = MLP((U,), mlp_units, activate_final=True, compute_dtype=cd)
        self.phi_x_out = ConcatDense((U,), 1, cd, output_scale=variance_scaling_init)
        self.gate = ConcatDense((U,), 1, cd)
        self.phi_h = MLP((U, H), (*mlp_units, H), activate_final=False, compute_dtype=cd)

    def forward(self, vectors: Tensor, h: Tensor) -> Tuple[Tensor, Tensor]:
        """``vectors [B, N, D]``, ``h [B, N, H]`` -> same shapes."""
        B, N, D = vectors.shape
        gram = torch.einsum("bnd,bmd->bnm", vectors, vectors)
        r2 = torch.diagonal(gram, dim1=-2, dim2=-1)
        l2 = torch.clamp(r2[:, :, None] + r2[:, None, :] - 2.0 * gram, min=0.0)
        lengths = torch.where(l2 == 0, 1.0, l2) ** 0.5
        mask = dense_edge_mask(N, vectors.dtype, vectors.device)

        # phi_e on [h_sender j, h_receiver i, |x_i - x_j|^2].
        m_ij = self.phi_e(h[:, None, :, :], h[:, :, None, :], l2[..., None])

        phi = self.phi_x_out(self.phi_x(m_ij))
        w = phi[..., 0].to(vectors.dtype) * mask / (self.normalization_constant + lengths)
        shifts = w.sum(dim=2)[:, :, None] * vectors - torch.einsum(
            "bij,bjd->bid", w, vectors
        )
        vectors_out = shifts / (N - 1)

        gate = torch.sigmoid(self.gate(m_ij))
        m_i = ((m_ij * gate).to(vectors.dtype) * mask[None, :, :, None]).sum(
            dim=2
        ) / math.sqrt(N - 1)
        features_out = self.phi_h(m_i, h).to(h.dtype)
        return vectors_out + vectors, features_out + h


class EGNN(nn.Module):
    """EGNN torso: per-block time-conditioned EGCLs over dense edges.

    ``time_dense[i]`` is flax's ``ConcatDense_i`` and ``blocks[i]`` its
    ``EGCL_i``.
    """

    def __init__(
        self,
        n_blocks: int,
        mlp_units: Sequence[int],
        n_invariant_feat_hidden: int,
        time_embedding_dim: int,
        normalization_constant: float = 1.0,
        variance_scaling_init: float = 0.001,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        H, T = n_invariant_feat_hidden, time_embedding_dim
        self.mlp_units = tuple(mlp_units)
        self.compute_dtype = compute_dtype
        self.normalization_constant = normalization_constant
        self.time_dense = nn.ModuleList(
            ConcatDense((H, T), H, compute_dtype) for _ in range(n_blocks)
        )
        self.blocks = nn.ModuleList(
            EGCL(mlp_units, H, normalization_constant, variance_scaling_init, compute_dtype)
            for _ in range(n_blocks)
        )
        self.final_scaling = nn.Parameter(torch.ones(()))

    def forward(self, positions: Tensor, node_features: Tensor, global_features: Tensor) -> Tensor:
        """``positions [B, N, D]``, ``node_features [B, N, H]``, time
        embedding ``global_features [B, T]`` -> field ``[B, N, D]``."""
        pos_mean = positions.mean(dim=-2, keepdim=True)
        vectors = positions - pos_mean
        initial_vectors = vectors
        h = node_features
        for time_dense, block in zip(self.time_dense, self.blocks):
            h = time_dense(h, global_features[:, None, :]).to(positions.dtype)
            vectors, h = block(vectors, h)
        vectors = vectors - initial_vectors
        vectors = vectors - pos_mean
        return vectors * self.final_scaling
