"""Fixed-step ODE solvers (`ecnf_tpu_torch/ops/ode.py`) vs JAX and the closed form.

A linear field ``dy/dt = A y + c t`` has a closed-form solution; both
packages integrate it from the same ``y0``.  Port vs JAX: atol 1e-6 (the
same f32 arithmetic).  Vs the closed form: atol 1e-5 at step 0.05 (rk4's
global error is ~h^4, Dopri5's ~h^5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from ecnf_tpu.ops.ode import odeint_fixed as jax_odeint_fixed
from ecnf_tpu_torch.ops.ode import odeint, odeint_fixed

RNG = np.random.default_rng(0)
A = (RNG.normal(size=(3, 3)) * 0.5).astype(np.float32)
C = RNG.normal(size=3).astype(np.float32)
Y0 = RNG.normal(size=(4, 3)).astype(np.float32)


def _closed_form(t0, t1):
    """y(t1) for dy/dt = A y + c t from y(t0) = Y0, via the augmented
    linear system on z = [y, t, 1]."""
    M = np.zeros((5, 5))
    M[:3, :3], M[:3, 3], M[3, 4] = A, C, 1.0
    z0 = np.concatenate([Y0, np.full((4, 1), t0), np.ones((4, 1))], axis=1)
    return (z0 @ scipy.linalg.expm(M * (t1 - t0)).T)[:, :3]


def _torch_field(t, y):
    return y @ torch.from_numpy(A).T + t[:, None] * torch.from_numpy(C)


def _jax_field(t, y):
    return y @ jnp.asarray(A).T + t[:, None] * jnp.asarray(C)


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (1.0, 0.0)], ids=["forward", "reverse"])
def test_matches_jax_and_closed_form(method, t0, t1):
    y, stats = odeint_fixed(_torch_field, torch.from_numpy(Y0), t0, t1, 0.05, method)
    y_jax, _ = jax_odeint_fixed(_jax_field, jnp.asarray(Y0), t0, t1, 0.05, method)
    assert stats.num_steps == 20
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), atol=1e-6)
    np.testing.assert_allclose(y.numpy(), _closed_form(t0, t1), atol=1e-5)


def test_step_count_and_signed_dt():
    seen = []

    def field(t, y):
        seen.append(t[0].item())
        return torch.zeros_like(y)

    # span 1 / step 0.3 -> ceil(3.33) = 4 steps of -0.25 on the reverse solve.
    _, stats = odeint_fixed(field, torch.zeros(2, 1), 1.0, 0.0, 0.3, "rk4")
    assert stats.num_steps == 4 and len(seen) == 16
    np.testing.assert_allclose(seen[::4], [1.0, 0.75, 0.5, 0.25], atol=1e-7)
    seen.clear()
    _, stats = odeint_fixed(field, torch.zeros(2, 1), 0.0, 1.0, 0.5, "dopri5")
    assert stats.num_steps == 2 and len(seen) == 1 + 2 * 6  # FSAL


def test_unknown_method_raises():
    y0 = torch.zeros(2, 1)
    with pytest.raises(ValueError):
        odeint_fixed(_torch_field, y0, 0.0, 1.0, 0.1, method="euler")
    with pytest.raises(ValueError):
        odeint(_torch_field, y0, 0.0, 1.0, use_fixed_step_size=True, method="euler")
