"""Batched ODE integration: fixed-step and adaptive Dormand-Prince 5(4)
(port of `ecnf_tpu/ops/ode.py`).

``func(t [B], y [B, S]) -> [B, S]`` is evaluated once per stage on the
whole batch.  The fixed-step solvers are classic RK4 and Dopri5 with FSAL.
The adaptive solver gives each sample its own ``(t, dt, done)`` and an
I-controller (safety 0.9, factor clipped to [0.2, 10], exponent 1/5), as
the JAX ``lax.while_loop`` does; here the loop runs on the host and reads
``done`` from the device once per attempt.

`odeint` records each field evaluation as an ``ecnf.field`` span and each
host read of the adaptive loop as an ``ecnf.ode.sync`` span while a torch
profiler runs (`ecnf_tpu_torch.utils.spans`).
"""
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ecnf_tpu_torch.ops import flops
from ecnf_tpu_torch.utils.spans import span, traced

Tensor = torch.Tensor
VectorField = Callable[[Tensor, Tensor], Tensor]

# Dormand-Prince 5(4) Butcher tableau.
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = _A[6].copy()  # 5th-order weights == row 7 of A (FSAL)
_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
_E = _B5 - _B4  # error-estimate weights

_SAFETY = 0.9
_FACTOR_MIN = 0.2
_FACTOR_MAX = 10.0
_ERR_EXP = 1.0 / 5.0


class ODEStats(NamedTuple):
    """Per-solve statistics.  ``num_steps`` is the most accepted steps of
    any sample, ``num_attempts`` the loop iterations.  The adaptive solve
    also counts its host reads of device values (``num_syncs``)."""

    num_steps: int
    num_attempts: int
    num_syncs: int = 0


def _rms_norm(x: Tensor) -> Tensor:
    """Per-sample RMS norm over the state: ``[B, S] -> [B]``."""
    return torch.sqrt(torch.mean(x**2, dim=-1))


def _dopri5_stages(
    func: VectorField, t: Tensor, y: Tensor, dt: Tensor, k1: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """One Dopri5 step: ``(y5, y_err, k7)``; ``k1 = func(t, y)`` (FSAL)."""
    dt_ = dt[:, None]
    ks = [k1]
    for i in range(1, 7):
        yi = y + dt_ * sum(float(_A[i, j]) * ks[j] for j in range(i))
        ks.append(func(t + float(_C[i]) * dt, yi))
    y5 = y + dt_ * sum(float(_B5[j]) * ks[j] for j in range(6))
    y_err = dt_ * sum(float(_E[j]) * ks[j] for j in range(7))
    return y5, y_err, ks[6]


def _rk4_step(func: VectorField, t: Tensor, y: Tensor, dt: Tensor) -> Tensor:
    """One classic 4th-order Runge-Kutta step on the whole batch."""
    dt_ = dt[:, None]
    k1 = func(t, y)
    k2 = func(t + 0.5 * dt, y + 0.5 * dt_ * k1)
    k3 = func(t + 0.5 * dt, y + 0.5 * dt_ * k2)
    k4 = func(t + dt, y + dt_ * k3)
    return y + (dt_ / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def odeint_fixed(
    func: VectorField,
    y0: Tensor,
    t0: float,
    t1: float,
    step_size: float = 0.05,
    method: str = "dopri5",
) -> Tuple[Tensor, ODEStats]:
    """Integrate over [t0, t1] in ``ceil(span / step_size)`` equal steps.

    ``t1 < t0`` integrates backwards (negative ``dt``).  ``method`` is
    ``"dopri5"`` (6 new field evaluations per step after the first) or
    ``"rk4"`` (4 per step).
    """
    if method not in ("dopri5", "rk4"):
        raise ValueError(f"unknown fixed-step method {method!r}")
    if t0 == t1:
        return y0, ODEStats(0, 0)
    span = abs(t1 - t0)
    n_steps = max(1, int(math.ceil(span / step_size - 1e-12)))
    dt_val = (t1 - t0) / n_steps
    B = y0.shape[0]
    kw = dict(dtype=y0.dtype, device=y0.device)
    dt = torch.full((B,), dt_val, **kw)
    t_start = torch.full((B,), t0, **kw)

    def t_at(i):
        return t_start + torch.full((B,), float(i), **kw) * dt_val

    y = y0
    if method == "rk4":
        for i in range(n_steps):
            y = _rk4_step(func, t_at(i), y, dt)
        return y, ODEStats(n_steps, n_steps)

    k1 = func(t_start, y)
    for i in range(n_steps):
        y, _, k1 = _dopri5_stages(func, t_at(i), y, dt, k1)
    return y, ODEStats(n_steps, n_steps)


def _initial_step_size(
    func: VectorField, t0: Tensor, y0: Tensor, f0: Tensor, direction: float,
    rtol: float, atol: float,
) -> Tensor:
    """Hairer-Norsett-Wanner starting step per sample (Solving ODEs I,
    p.169), with the JAX package's exponent 1/5: ``[B]`` unsigned
    magnitudes.  One field evaluation."""
    scale = atol + rtol * torch.abs(y0)
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / torch.clamp(d1, min=1e-30))

    y1 = y0 + direction * h0[:, None] * f0
    f1 = func(t0 + direction * h0, y1)
    d2 = _rms_norm((f1 - f0) / scale) / torch.clamp(h0, min=1e-30)

    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.clamp(dmax, min=1e-30)) ** _ERR_EXP,
    )
    return torch.minimum(100.0 * h0, h1)


class _SyncCounter:
    """Counts the host's reads of device values, each an ``ecnf.ode.sync``
    span."""

    def __init__(self):
        self.count = 0

    def read(self, x: Tensor):
        with span("ecnf.ode.sync"):
            value = x.item()
        self.count += 1
        return value


def odeint_adaptive(
    func: VectorField,
    y0: Tensor,
    t0: float,
    t1: float,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    dtmin: float = 1e-5,
    max_steps: int = 4096,
) -> Tuple[Tensor, ODEStats]:
    """Integrate from t0 to t1 with adaptive Dopri5, per sample.

    The error of a step is the RMS over the whole state of ``y_err /
    (atol + rtol max(|y|, |y5|))``; a step is accepted when it is at most 1
    or when the step was already at ``dtmin`` (force-accept).  Each
    attempted step is clamped to the time that remains, and ``t`` snaps to
    ``t1`` within 1e-12.  A sample whose state is no longer finite is
    marked done at once; samples still short of ``t1`` after
    ``max_steps`` attempts come back as NaN.  Finished samples stay in the
    batch and are still evaluated (at ``t1`` with a zero step).  The loop
    checks ``done.all()`` before each attempt, so ``num_attempts`` equals
    the JAX ``while_loop``'s iterations; field evaluations are
    ``2 + 6 * num_attempts`` (the first stage, the initial-step probe,
    then six per attempt).  ``t1 < t0`` integrates backwards.  A running
    `ops.flops.count_fn_flops` is flagged ``has_while``: the attempts
    depend on the data.
    """
    if t0 == t1:
        return y0, ODEStats(0, 0)
    flops.note_while()
    direction = 1.0 if t1 > t0 else -1.0
    span = abs(t1 - t0)
    B = y0.shape[0]
    t = torch.full((B,), t0, dtype=y0.dtype, device=y0.device)
    f0 = func(t, y0)
    dt = torch.clamp(
        _initial_step_size(func, t, y0, f0, direction, rtol, atol), max=span
    ).to(y0.dtype)

    y, k1 = y0, f0
    done = torch.zeros((B,), dtype=torch.bool, device=y0.device)
    n_accept = torch.zeros((B,), dtype=torch.int32, device=y0.device)
    n_iter = 0
    syncs = _SyncCounter()
    while n_iter < max_steps and not syncs.read(done.all()):
        remaining = torch.abs(t1 - t)
        dt_mag = torch.minimum(dt, remaining)
        at_min = dt_mag <= dtmin
        dt_mag = torch.maximum(dt_mag, torch.clamp(remaining, max=dtmin))
        step_dt = direction * dt_mag

        y5, y_err, k7 = _dopri5_stages(func, t, y, step_dt, k1)

        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
        err_ratio = _rms_norm(y_err / scale)
        accept = (err_ratio <= 1.0) | at_min
        factor = torch.where(
            err_ratio == 0.0,
            _FACTOR_MAX,
            torch.clamp(_SAFETY * err_ratio ** (-_ERR_EXP), _FACTOR_MIN, _FACTOR_MAX),
        )
        dt_next = torch.clamp(dt_mag * factor, min=dtmin)

        # A sample whose state blew up would be rejected down to dtmin and
        # then force-accepted until max_steps: freeze it now.
        dead = ~torch.isfinite(y).all(dim=-1)
        step = accept & ~done & ~dead
        t_new = torch.where(step, t + step_dt, t)
        reached = torch.abs(t1 - t_new) <= 1e-12
        t = torch.where(step & reached, t1, t_new)
        y = torch.where(step[:, None], y5, y)
        k1 = torch.where(step[:, None], k7, k1)  # FSAL
        dt = torch.where(done, dt, dt_next)
        done = done | (step & reached) | dead
        n_accept = n_accept + step.to(torch.int32)
        n_iter += 1

    y1 = torch.where(done[:, None], y, torch.nan)
    num_steps = int(syncs.read(n_accept.max()))
    return y1, ODEStats(num_steps, n_iter, syncs.count)


def odeint(
    func: VectorField,
    y0: Tensor,
    t0: float,
    t1: float,
    use_fixed_step_size: bool = False,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    dtmin: float = 1e-5,
    step_size: float = 0.05,
    max_steps: int = 4096,
    method: str = "dopri5",
) -> Tuple[Tensor, ODEStats]:
    """Fixed-step (``method`` at ``step_size``) or adaptive Dopri5; each
    call of ``func`` is an ``ecnf.field`` span."""
    func = traced("ecnf.field", func)
    if use_fixed_step_size:
        return odeint_fixed(func, y0, t0, t1, step_size=step_size, method=method)
    return odeint_adaptive(
        func, y0, t0, t1, rtol=rtol, atol=atol, dtmin=dtmin, max_steps=max_steps
    )
