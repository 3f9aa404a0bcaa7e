"""Optimizer construction (port of `ecnf_tpu/training/optim.py`).

Adam or AdamW with a constant learning rate or optax's
``warmup_cosine_decay_schedule``, written as functional transforms with
optax's semantics: ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, where the caller applies ``params +
updates``.  The step needs the updates themselves (their global norm is
reported), so this is not ``torch.optim``.

Matches optax exactly in its choices: ``b1=0.9``, ``b2=0.999``, ``eps=1e-8``
outside the square root and none inside it; bias correction at ``count +
1``; the schedule read at the count before the increment, so the first
update uses ``lr(0)``; AdamW's decoupled decay ``weight_decay * p`` added to
the Adam direction before the learning rate, with optax's default of 1e-4.
Parameters, moments and updates are lists of tensors in one fixed order;
every list op is one ``torch._foreach_*`` call.
"""
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor
Schedule = Callable[[int], float]


class AdamState(NamedTuple):
    """``count`` is a host int (no device sync per step); ``mu`` and ``nu``
    are the first and second moments, one tensor per parameter."""

    count: int
    mu: List[Tensor]
    nu: List[Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Sequence[Tensor]], AdamState]
    update: Callable[..., tuple]


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """optax's schedule: a linear ramp from ``init_value`` to ``peak_value``
    over ``warmup_steps``, then a cosine from ``peak_value`` to
    ``end_value`` over ``decay_steps - warmup_steps``, then ``end_value``.
    ``warmup_steps <= 0`` has no ramp."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(
            f"the cosine phase needs decay_steps > warmup_steps, got {decay_steps=}, {warmup_steps=}"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


B1, B2, EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32 arithmetic, as optax computes it (in f64,
    ``1 - 0.999`` is 1.3e-5 away from its f32 value)."""
    one = np.float32(1.0)
    return float(one - np.float32(decay) ** np.float32(count))


def adam(
    learning_rate: Union[float, Schedule], weight_decay: Optional[float] = None
) -> GradientTransformation:
    """``optax.adam`` (``weight_decay=None``) or ``optax.adamw``, at optax's
    default ``b1``, ``b2`` and ``eps``."""

    def init(params: Sequence[Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    def update(grads: Sequence[Tensor], state: AdamState, params: Optional[Sequence[Tensor]] = None):
        grads = list(grads)
        mu = torch._foreach_mul(grads, 1.0 - B1)
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, B1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, B2))
        count = state.count + 1
        denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias_correction(B2, count)))
        torch._foreach_add_(denom, EPS)
        direction = torch._foreach_div(torch._foreach_div(mu, _bias_correction(B1, count)), denom)
        if weight_decay is not None:
            if params is None:
                raise ValueError("adamw needs the params")
            torch._foreach_add_(direction, torch._foreach_mul(list(params), weight_decay))
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        updates = torch._foreach_mul(direction, -lr)
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def learning_rate(
    init_lr: float,
    use_schedule: bool = False,
    peak_lr: Optional[float] = None,
    end_lr: Optional[float] = None,
    n_iter_warmup: int = 0,
    n_iter_total: Optional[int] = None,
) -> Union[float, Schedule]:
    """The constant rate, or the warmup-cosine schedule over the total
    number of minibatch steps."""
    if not use_schedule:
        return float(init_lr)
    if n_iter_total is None:
        raise ValueError("use_schedule needs n_iter_total")
    # Warmup clamped for debug-scale runs, as in the JAX package: the
    # cosine phase must be at least one step long.
    warmup = min(n_iter_warmup, max(n_iter_total - 1, 0))
    return warmup_cosine_decay_schedule(
        float(init_lr), float(peak_lr), warmup, n_iter_total, float(end_lr)
    )


def build_optimizer(
    init_lr: float,
    use_schedule: bool = False,
    peak_lr: Optional[float] = None,
    end_lr: Optional[float] = None,
    n_iter_warmup: int = 0,
    n_iter_total: Optional[int] = None,
    optimizer_name: str = "adam",
) -> GradientTransformation:
    lr = learning_rate(init_lr, use_schedule, peak_lr, end_lr, n_iter_warmup, n_iter_total)
    if optimizer_name == "adam":
        return adam(lr)
    if optimizer_name == "adamw":
        return adam(lr, weight_decay=1e-4)
    raise ValueError(f"unknown optimizer {optimizer_name!r}")
