"""The epoch runner (port of `ecnf_tpu/training/setup.py`'s ``_epoch``).

The rest of the JAX module (config, data, evaluation, plots) is not
ported yet.
"""
from typing import Callable, Dict, Optional, Tuple

import torch

from ecnf_tpu_torch.training.state import TrainingState

Tensor = torch.Tensor


def epoch(
    state: TrainingState,
    update: Callable[..., Tuple[TrainingState, Dict[str, Tensor]]],
    pos: Tensor,
    feats: Tensor,
    batch_size: int,
    perm: Optional[Tensor] = None,
) -> Tuple[TrainingState, Dict[str, Tensor]]:
    """One pass over ``pos [n, D]`` / ``feats [n, N]``: permute, drop the
    remainder, and run ``update`` on each minibatch in turn.

    The permutation is drawn from the state's generator unless ``perm``
    (a permutation of ``n``) is given.  Returns the state and each info
    key's values stacked over the minibatches.
    """
    n = pos.shape[0]
    n_batches = n // batch_size
    if n_batches < 1:
        raise ValueError(f"{n} samples make no batch of {batch_size}")
    if perm is None:
        perm = torch.randperm(n, generator=state.generator, device=state.generator.device)
    perm = perm.to(pos.device)[: n_batches * batch_size]
    pos_b = pos[perm].reshape(n_batches, batch_size, -1)
    feat_b = feats[perm].reshape(n_batches, batch_size, -1)
    infos = []
    for xb, fb in zip(pos_b, feat_b):
        state, info = update(state, xb, fb)
        infos.append(info)
    return state, {key: torch.stack([info[key] for info in infos]) for key in infos[0]}
