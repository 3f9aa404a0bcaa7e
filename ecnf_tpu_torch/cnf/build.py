"""CNF factories (port of `ecnf_tpu/cnf/build.py`): zero-CoM Gaussian base +
EGNN vector field (`build_cnf`), and diagonal Gaussian base + plain MLP
field (`build_mlp_cnf`, the 2-D MoG)."""
import math
from functools import partial
from typing import Optional, Sequence

import torch
from torch import nn

from ecnf_tpu_torch.cnf.base import DiagGaussian, ZeroCoMGaussian
from ecnf_tpu_torch.cnf.core import FlowMatchingCNF, optimal_transport_conditional_vf
from ecnf_tpu_torch.models.egnn import EGNN
from ecnf_tpu_torch.models.mlp import ConcatDense
from ecnf_tpu_torch.models.vector_net import VectorNet
from ecnf_tpu_torch.ops.divergence import zero_com_trace_basis
from ecnf_tpu_torch.ops.egcl import egnn_weights
from ecnf_tpu_torch.ops.fused_trace import egnn_value_and_div_fused
from ecnf_tpu_torch.ops.numerics import timestep_embedding
from ecnf_tpu_torch.ops.tangent import egnn_value_and_trace, trace_weights

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


class FlatEGNNField(nn.Module):
    """Flat-coordinate adapter around the EGNN.

    ``x [B, N*D]`` positions, ``t [B]`` times and integer node features
    ``[B, N]`` -> flat field ``[B, N*D]``.  ``embed`` is flax's ``Embed_0``
    and ``egnn`` its ``EGNN_0``.
    """

    def __init__(
        self,
        n_nodes: int,
        dim: int,
        n_features: int,
        n_invariant_feat_hidden: int,
        time_embedding_dim: int,
        n_blocks_egnn: int,
        mlp_units: Sequence[int],
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.n_nodes = n_nodes
        self.dim = dim
        self.time_embedding_dim = time_embedding_dim
        self.compute_dtype = _DTYPES[compute_dtype]
        self.embed = nn.Embedding(n_features, n_invariant_feat_hidden)
        self.egnn = EGNN(
            n_blocks=n_blocks_egnn,
            mlp_units=mlp_units,
            n_invariant_feat_hidden=n_invariant_feat_hidden,
            time_embedding_dim=time_embedding_dim,
            compute_dtype=self.compute_dtype,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter from flax's initial distributions."""
        with torch.no_grad():
            std = math.sqrt(1.0 / self.embed.embedding_dim)
            self.embed.weight.normal_(0.0, std, generator=generator)
            for module in self.modules():
                if isinstance(module, ConcatDense):
                    module.reset_parameters(generator)
            self.egnn.final_scaling.fill_(1.0)

    def forward(self, positions: torch.Tensor, time: torch.Tensor, node_features: torch.Tensor) -> torch.Tensor:
        B = positions.shape[0]
        pos = positions.reshape(B, self.n_nodes, self.dim)
        h = self.embed(node_features.reshape(B, self.n_nodes).long())
        t_emb = timestep_embedding(time, self.time_embedding_dim)
        return self.egnn(pos, h, t_emb).reshape(B, self.n_nodes * self.dim)


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when None; the card's absence raises,
    so the CPU runs only when asked for (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return device


def build_cnf(
    n_frames: int,
    dim: int,
    sigma_min: float,
    base_scale: float,
    n_blocks_egnn: int,
    mlp_units: Sequence[int],
    n_invariant_feat_hidden: int,
    time_embedding_dim: int,
    n_features: int,
    compute_dtype: Optional[str] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> FlowMatchingCNF:
    """Build the molecular-coordinate CNF with a freshly initialised field.

    The field's parameters are drawn on the CPU from ``generator`` (flax's
    initial distributions) and then moved to ``device``: the CUDA card
    unless the caller names another (``device="cpu"``); without a card that
    default raises.  ``compute_dtype="bfloat16"`` runs the EGNN's MLPs in
    bf16; parameters and geometry stay f32.
    """
    device = resolve_device(device)
    base = ZeroCoMGaussian(n_nodes=n_frames, dim=dim, scale=base_scale)
    net = FlatEGNNField(
        n_nodes=n_frames,
        dim=dim,
        n_features=int(n_features),
        n_invariant_feat_hidden=n_invariant_feat_hidden,
        time_embedding_dim=time_embedding_dim,
        n_blocks_egnn=n_blocks_egnn,
        mlp_units=tuple(mlp_units),
        compute_dtype=compute_dtype,
    )
    net.reset_parameters(generator)
    net = net.to(device).eval()
    device = net.egnn.final_scaling.device

    # The EGNN is translation-invariant up to its output recentring, so the
    # `dim` uniform translations are Jacobian eigenvectors with eigenvalue
    # -final_scaling: the exact trace needs tangents only on the zero-CoM
    # basis, plus the analytic offset -dim * final_scaling.
    com_basis = zero_com_trace_basis(n_frames, dim, device=device)

    def exact_trace_plan():
        return com_basis, -dim * net.egnn.final_scaling.detach()

    def tangent(x, t, features, basis, trace_offset=None, use_kernel=True, weights=None):
        return egnn_value_and_trace(
            net, x, t, features, basis, trace_offset=trace_offset,
            use_kernel=use_kernel, weights=weights,
        )

    # Fused forward + exact-divergence kernel (`ops/fused_trace.py`), only
    # for the constant-width MLP EGNN, as in the JAX package.
    fused = fused_weights = None
    if len(set(mlp_units)) == 1:

        def fused(x, t, features, weights=None):
            return egnn_value_and_div_fused(net, x, t, features, weights=weights)

        fused_weights = partial(egnn_weights, net.egnn)

    return FlowMatchingCNF(
        field=net,
        sample_base=partial(base.sample, device=device),
        get_x_t_and_conditional_u_t=partial(
            optimal_transport_conditional_vf, sigma_min=sigma_min
        ),
        log_prob_base=base.log_prob,
        sample_and_log_prob_base=partial(base.sample_and_log_prob, device=device),
        exact_trace_plan=exact_trace_plan,
        tangent_value_and_div=tangent,
        trace_weights=partial(trace_weights, net),
        fused_value_and_div=fused,
        fused_weights=fused_weights,
    )


def build_mlp_cnf(
    dim: int,
    sigma_min: float,
    base_scale: float,
    features: Sequence[int] = (512, 512, 512),
    embedding_dim: int = 32,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> FlowMatchingCNF:
    """A plain-MLP CNF (`VectorNet`) on a diagonal Gaussian base, with its
    field initialised on the CPU from ``generator`` and moved to ``device``
    (the card unless the caller names another).  Its trace is the
    ``torch.func`` route: no structured tangent, no kernel."""
    device = resolve_device(device)
    base = DiagGaussian(dim=dim, scale=base_scale)
    net = VectorNet(dim, features=tuple(features), embedding_dim=embedding_dim)
    net.reset_parameters(generator)
    net = net.to(device).eval()
    return FlowMatchingCNF(
        field=net,
        sample_base=partial(base.sample, device=device),
        get_x_t_and_conditional_u_t=partial(
            optimal_transport_conditional_vf, sigma_min=sigma_min
        ),
        log_prob_base=base.log_prob,
        sample_and_log_prob_base=partial(base.sample_and_log_prob, device=device),
    )
