"""Numerical utilities (port of `ecnf_tpu/ops/numerics.py`)."""
import math
from typing import Optional, Tuple

import torch


def safe_norm(
    x: torch.Tensor, dim: Optional[int] = None, keepdim: bool = False
) -> torch.Tensor:
    """L2 norm that reports 1 where ``sum(x**2) == 0`` (finite gradients)."""
    x2 = (x**2).sum() if dim is None else (x**2).sum(dim=dim, keepdim=keepdim)
    return torch.where(x2 == 0, 1.0, x2) ** 0.5


def timestep_embedding(timesteps: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: ``[B] -> [B, embedding_dim]``.

    ``t`` in [0, 1] is scaled by 1000; half the dim is sin, half cos, with
    frequencies ``exp(-k * log(10000) / (half_dim - 1))``.
    """
    if timesteps.dim() != 1:
        raise ValueError(f"timesteps must be [B], got {tuple(timesteps.shape)}")
    t = timesteps * 1000.0
    half_dim = embedding_dim // 2
    emb_scale = math.log(10_000) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
        * -emb_scale
    )
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def maybe_masked_mean(array: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of a rank-1 array, restricted by a 0/1 ``mask`` when one is
    given; 0 when the mask is empty."""
    if mask is None:
        return torch.mean(array)
    array = torch.where(mask.bool(), array, torch.zeros_like(array))
    divisor = torch.sum(mask)
    multiplier = torch.where(divisor == 0, 0.0, 1.0 / divisor)
    return torch.sum(array) * multiplier


def first_leaf(tree) -> torch.Tensor:
    """The first tensor of ``tree``: a tensor, or nested tuples or lists."""
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


def get_leading_axis_tree(tree, n_dims: int = 1) -> Tuple[int, ...]:
    """Leading shape of the first tensor of ``tree``."""
    return tuple(first_leaf(tree).shape[:n_dims])
