"""Evaluation engine: padded, masked batching and forward / reverse ESS
(port of `ecnf_tpu/training/evaluation.py`).

The batches run in a host loop, one call per batch.  The JAX module's
``use_scan`` and ``scan_chunk`` variants exist only to bound the length
and dispatch cost of XLA device programs and are not ported.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ecnf_tpu_torch.ops.numerics import first_leaf, get_leading_axis_tree

Tensor = torch.Tensor
Data = Any  # a tensor, or a tuple / list of tensors with one leading axis


def _tree_map(fn: Callable, tree):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _tree_stack(outs: list):
    """Stack a list of equally structured outputs along a new axis 0."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack([o[i] for o in outs]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _tree_stack([o[k] for o in outs]) for k in first}
    return torch.stack([torch.as_tensor(o) for o in outs])


def _logsumexp(a: Tensor, b: Tensor) -> Tensor:
    """``log(sum(b * exp(a)))`` over all entries, with ``b >= 0`` weights."""
    amax = torch.max(a)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.sum(b.to(a.dtype) * torch.exp(a - amax))) + amax


def calculate_forward_ess(log_w: Tensor, mask: Tensor) -> dict:
    """Forward effective sample size from ``log_w = log p(x) - log q(x)``,
    ``x ~ p``, over the entries where ``mask`` is 1.  Non-finite weights (a
    diverged or unfinished ODE sample scores NaN) are masked out."""
    mask = mask * torch.isfinite(log_w).to(mask.dtype)
    log_w = torch.where(mask.bool(), log_w, torch.zeros_like(log_w))
    log_n = torch.log(torch.sum(mask).to(log_w.dtype))
    log_z_inv = _logsumexp(-log_w, mask) - log_n
    log_z_expectation_p_over_q = _logsumexp(log_w, mask) - log_n
    log_forward_ess = -log_z_inv - log_z_expectation_p_over_q
    return {"forward_ess": torch.exp(log_forward_ess)}


def calculate_reverse_ess(log_w: Tensor) -> Tensor:
    """Normalised reverse ESS ``1 / sum(softmax(log_w)^2) / n`` of model
    samples; non-finite log weights get zero weight."""
    log_w = torch.where(torch.isfinite(log_w), log_w, -torch.inf)
    return 1.0 / torch.sum(torch.softmax(log_w, dim=0) ** 2) / log_w.shape[0]


def setup_padded_reshaped_data(
    data: Data, interval_length: int, reshape_axis: int = 1
) -> Tuple[Data, Tensor]:
    """Zero-pad axis 0 to a multiple of ``interval_length`` and split it,
    returning the data and an int32 validity mask of the same layout.

    ``reshape_axis=1`` gives ``[n_batches, interval_length, ...]`` (one
    batch per row); ``reshape_axis=0`` gives ``[interval_length,
    n_batches, ...]``.
    """
    if reshape_axis not in (0, 1):
        raise ValueError(f"reshape_axis must be 0 or 1, got {reshape_axis}")
    size = get_leading_axis_tree(data)[0]
    padding = (interval_length - size % interval_length) % interval_length
    padded_size = size + padding
    device = first_leaf(data).device
    data_padded = _tree_map(
        lambda x: torch.cat([x, torch.zeros((padding, *x.shape[1:]), dtype=x.dtype, device=x.device)]),
        data,
    )
    mask = torch.zeros(padded_size, dtype=torch.int32, device=device)
    mask[:size] = 1
    n_batches = padded_size // interval_length
    lead = (interval_length, n_batches) if reshape_axis == 0 else (n_batches, interval_length)
    reshape = lambda x: x.reshape(*lead, *x.shape[1:])
    return _tree_map(reshape, data_padded), reshape(mask)


def eval_fn(
    x: Data,
    eval_on_test_batch_fn: Optional[Callable[..., Union[Tuple[Any, dict], dict]]] = None,
    eval_batch_free_fn: Optional[Callable[..., dict]] = None,
    batch_size: Optional[int] = None,
    mask: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[dict, Optional[Any], Optional[Tensor]]:
    """Run a per-batch eval over padded test data and average its outputs
    with each batch weighted by its share of valid entries; then run a
    batch-free eval.

    ``eval_on_test_batch_fn(x_batch, mask=m_batch, generator=generator)``
    returns a dict of per-batch scalars, or ``(further, dict)`` where
    ``further`` holds per-item values (forward log weights, say), which come
    back flattened over the batches with their flat mask.
    ``eval_batch_free_fn(generator=generator)`` returns a dict.  Both draw
    from the one ``generator``, batches first.  Returns ``(info,
    further or None, flat mask or None)``.
    """
    info = {}
    further_info, flat_mask = None, None
    n_points = get_leading_axis_tree(x)[0]
    if mask is None:
        mask = torch.ones(n_points, dtype=torch.int32, device=first_leaf(x).device)

    if eval_on_test_batch_fn is not None:
        (x_batched, mask_batched), mask_new = setup_padded_reshaped_data(
            (x, mask), interval_length=batch_size, reshape_axis=1
        )
        mask_batched = mask_batched * mask_new
        n_batches = get_leading_axis_tree(x_batched)[0]
        outs = [
            eval_on_test_batch_fn(
                _tree_map(lambda v: v[i], x_batched), mask=mask_batched[i], generator=generator
            )
            for i in range(n_batches)
        ]
        batched_info = _tree_stack(outs)

        valid = torch.sum(mask_batched, dim=-1)
        per_batch_weighting = valid / torch.sum(valid)
        if isinstance(batched_info, dict):
            per_batch = batched_info
        else:
            further, per_batch = batched_info
            flat_mask, further_info = _tree_map(
                lambda v: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]),
                (mask_batched, further),
            )
        info.update({k: torch.sum(per_batch_weighting * v) for k, v in per_batch.items()})

    if eval_batch_free_fn is not None:
        info.update(eval_batch_free_fn(generator=generator))

    return info, further_info, flat_mask
