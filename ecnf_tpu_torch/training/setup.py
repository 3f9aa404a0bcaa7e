"""The epoch runner and the evaluation (port of the ``_epoch`` and the
evaluation half of `ecnf_tpu/training/setup.py`'s ``setup_training``).

The JAX module builds its evaluation as closures over a config; here it
is plain functions of the CNF and the settings.  The CNF is evaluated
with the parameters its field holds, so the caller chooses them (the EMA
parameters at the end of training: ``cnf.field.load_state_dict(
state.ema_params)``).  Config, data and plots are not ported yet.
"""
from typing import Callable, Dict, Optional, Tuple

import torch

from ecnf_tpu_torch.cnf.core import FlowMatchingCNF
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_tpu_torch.ops.numerics import maybe_masked_mean
from ecnf_tpu_torch.training.evaluation import (
    calculate_forward_ess,
    calculate_reverse_ess,
    eval_fn,
)
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


TargetLogProb = Callable[[Tensor], Tensor]  # [B, N, D] -> [B]


def _positions(x: Tensor, features: Tensor) -> Tensor:
    """Flat ``[B, N*D]`` points as ``[B, N, D]``, N from ``features [B, N]``."""
    return x.reshape(x.shape[0], features.shape[-1], -1)


def eval_data_batch(
    cnf: FlowMatchingCNF,
    data: Tuple[Tensor, Tensor],
    mask: Tensor,
    target_log_prob_fn: Optional[TargetLogProb] = None,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    eps: Optional[Tensor] = None,
) -> Tuple[Optional[Tensor], Dict[str, Tensor]]:
    """Score one test batch ``data = (pos [B, N*D], features [B, N])``.

    Returns the forward log weights ``log p - log q [B]`` (None without a
    target) and the masked means ``test_log_lik``, ``test_log_prob_base``,
    ``test_delta_log_lik`` over the entries of ``mask`` whose log q is
    finite (an ODE sample that diverged or ran out of steps scores NaN),
    with ``eval_ode_steps``, the solve's accepted steps.  The trace is
    exact, or Hutchinson with probes ``eps`` or drawn from ``generator``
    when ``exact_log_prob`` is False.
    """
    pos_b, feat_b = data
    log_q, log_prob_base, delta_log_lik, stats = get_log_prob(
        cnf, pos_b, feat_b, approx=not exact_log_prob, cfg=cfg,
        generator=generator, eps=eps, return_stats=True,
    )
    mask = mask * torch.isfinite(log_q).to(mask.dtype)
    info = {
        "test_log_lik": maybe_masked_mean(log_q, mask),
        "test_log_prob_base": maybe_masked_mean(log_prob_base, mask),
        "test_delta_log_lik": maybe_masked_mean(delta_log_lik, mask),
        "eval_ode_steps": torch.tensor(float(stats.num_steps), device=pos_b.device),
    }
    log_w = None
    if target_log_prob_fn is not None:
        log_w = target_log_prob_fn(_positions(pos_b, feat_b)) - log_q
    return log_w, info


def model_log_weights(
    cnf: FlowMatchingCNF,
    target_log_prob_fn: TargetLogProb,
    features: Tensor,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    eps: Optional[Tensor] = None,
) -> Tensor:
    """Reverse log weights ``log p - log q [B]`` of one batch of model
    samples, one per row of ``features [B, N]``."""
    samples, log_q = sample_and_log_prob_cnf(
        cnf, features.shape[0], features, approx=not exact_log_prob, cfg=cfg,
        generator=generator, x0=x0, eps=eps,
    )
    return target_log_prob_fn(_positions(samples, features)) - log_q


def reverse_ess(
    cnf: FlowMatchingCNF,
    target_log_prob_fn: TargetLogProb,
    features_row: Tensor,
    n_model_samples: int,
    batch_size: int,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    """``rv_ess`` over ``max(n_model_samples // b, 1)`` batches of ``b =
    min(batch_size, n_model_samples)`` model samples, each with the node
    features ``features_row [N]`` (the first training row).  ``x0 [n_batches,
    b, D]`` injects the base samples."""
    b = min(batch_size, n_model_samples)
    n_batches = max(n_model_samples // b, 1)
    feats = features_row.reshape(1, -1).repeat(b, 1)
    log_w = torch.cat([
        model_log_weights(
            cnf, target_log_prob_fn, feats, exact_log_prob, cfg, generator,
            x0=None if x0 is None else x0[i],
        )
        for i in range(n_batches)
    ])
    return {"rv_ess": calculate_reverse_ess(log_w)}


def evaluate(
    cnf: FlowMatchingCNF,
    test_pos: Tensor,
    test_features: Tensor,
    features_row: Tensor,
    batch_size: int,
    target_log_prob_fn: Optional[TargetLogProb] = None,
    n_model_samples: Optional[int] = None,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
) -> Dict[str, float]:
    """One evaluation, without the plots: test NLL terms over ``test_pos
    [n, N*D]`` / ``test_features [n, N]`` in padded batches of
    ``batch_size``; with a target, the forward ESS of the test points and,
    given ``n_model_samples``, the reverse ESS of model samples drawn with
    ``features_row``.  Probes and base samples come from ``generator``,
    test batches first."""

    def batch_free(generator):
        return reverse_ess(
            cnf, target_log_prob_fn, features_row, n_model_samples, batch_size,
            exact_log_prob, cfg, generator,
        )

    def on_batch(data, mask, generator):
        return eval_data_batch(
            cnf, data, mask, target_log_prob_fn, exact_log_prob, cfg, generator
        )

    with_rv = target_log_prob_fn is not None and n_model_samples is not None
    info, log_w_fwd, flat_mask = eval_fn(
        (test_pos, test_features),
        eval_on_test_batch_fn=on_batch,
        eval_batch_free_fn=batch_free if with_rv else None,
        batch_size=batch_size,
        generator=generator,
    )
    if target_log_prob_fn is not None and log_w_fwd is not None:
        info.update(calculate_forward_ess(log_w_fwd, mask=flat_mask))
    return {k: float(v) for k, v in info.items()}
