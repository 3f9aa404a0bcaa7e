"""Dense-graph edge utilities (port of `ecnf_tpu/ops/graph.py`)."""
from typing import Optional

import torch


def dense_edge_mask(
    n_nodes: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """``[N, N]`` mask with 0 on the diagonal, 1 elsewhere.

    ``mask[i, j] == 1`` means there is an edge with receiver ``i`` and
    sender ``j``.
    """
    return 1.0 - torch.eye(n_nodes, dtype=dtype, device=device)


def pairwise_difference(positions: torch.Tensor) -> torch.Tensor:
    """Dense pairwise differences, receiver minus sender:
    ``out[..., i, j, :] = positions[..., i, :] - positions[..., j, :]``
    for ``positions [..., N, D]`` -> ``[..., N, N, D]``."""
    return positions[..., :, None, :] - positions[..., None, :, :]
