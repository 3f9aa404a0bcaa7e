"""Fixed-step ODE integration on batched states (port of `ecnf_tpu/ops/ode.py`).

``func(t [B], y [B, S]) -> [B, S]`` is evaluated once per stage on the
whole batch.  The fixed-step solvers are classic RK4 and Dormand-Prince
5(4) with FSAL; adaptive Dopri5 is not ported yet.
"""
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

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


class ODEStats(NamedTuple):
    num_steps: int
    num_attempts: int


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


def odeint(
    func: VectorField,
    y0: Tensor,
    t0: float,
    t1: float,
    use_fixed_step_size: bool = False,
    step_size: float = 0.05,
    method: str = "dopri5",
) -> Tuple[Tensor, ODEStats]:
    """Fixed-step integration; adaptive Dopri5 is not ported yet and raises."""
    if not use_fixed_step_size:
        raise NotImplementedError(
            "adaptive Dopri5 is not ported; use use_fixed_step_size=True"
        )
    return odeint_fixed(func, y0, t0, t1, step_size=step_size, method=method)
