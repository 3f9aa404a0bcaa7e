"""Plain MLP vector field for targets without nodes, the 2-D MoG (port of
`ecnf_tpu/models/vector_net.py`).

Each hidden layer reads ``concat([x, t_embed])`` through one `ConcatDense`,
then GELU in its tanh form (flax's ``nn.activation.gelu`` default); a last
Dense maps back to the event dimension.  ``layers[i]`` is flax's
``ConcatDense_i`` and ``out`` its ``Dense_0``.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ecnf_tpu_torch.models.mlp import ConcatDense
from ecnf_tpu_torch.ops.numerics import timestep_embedding

Tensor = torch.Tensor


class VectorNet(nn.Module):
    """``x [B, D]``, ``t [B]`` -> ``[B, D]``; node features are ignored."""

    def __init__(self, event_dim: int, features: Sequence[int] = (512, 512, 512),
                 embedding_dim: int = 32):
        super().__init__()
        self.embedding_dim = embedding_dim
        widths = [event_dim] + list(features[:-1])
        self.layers = nn.ModuleList(
            ConcatDense((w, embedding_dim), f) for w, f in zip(widths, features)
        )
        self.out = ConcatDense((features[-1],), event_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter from flax's initial distributions."""
        for layer in (*self.layers, self.out):
            layer.reset_parameters(generator)

    def forward(self, x: Tensor, t: Tensor, features: Optional[Tensor] = None) -> Tensor:
        if x.dim() != 2 or t.dim() != 1:
            raise ValueError(f"x must be [B, D] and t [B], got {tuple(x.shape)}, {tuple(t.shape)}")
        t_embed = timestep_embedding(t, self.embedding_dim)
        for layer in self.layers:
            x = F.gelu(layer(x, t_embed), approximate="tanh")
        return self.out(x)
