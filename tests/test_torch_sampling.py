"""The ported slice end to end: exact-log-density sampling and scoring.

Port vs JAX on the same redrawn weights and the same injected points, f32,
fixed step 0.25.  Tolerances: ``log_q`` rtol 1e-4, ``x1`` atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.ops.ode import odeint_fixed as jax_odeint_fixed
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf

STEP = 0.25


def _cfg(method):
    return SolveConfig(use_fixed_step_size=True, step_size=STEP, method=method)


def _jax_cfg(method):
    return jax_sampling.SolveConfig(use_fixed_step_size=True, step_size=STEP, method=method)


def test_get_log_prob_matches_jax():
    jax_cnf, params, cnf = tp.make_pair(seed=7)
    x, _, feats = tp.inputs(seed=7)
    ref = jax_sampling.get_log_prob(
        jax_cnf, params, jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(feats),
        cfg=_jax_cfg("rk4"),
    )
    xt, ft = tp.to_torch(x, feats)
    out = get_log_prob(cnf, xt, ft, cfg=_cfg("rk4"))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4)


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_sample_and_log_prob_with_injected_x0_matches_jax(method):
    jax_cnf, params, cnf = tp.make_pair(seed=8)
    _, _, feats = tp.inputs(seed=8)
    noise = np.random.default_rng(8).normal(size=(tp.B, tp.N, tp.DIM)).astype(np.float32)
    x0 = cnf.sample_base((tp.B,), noise=torch.from_numpy(noise))
    ft = torch.from_numpy(feats)

    func = jax_sampling._augmented_field(
        jax_cnf, params, jnp.asarray(feats), False, None, _jax_cfg(method)
    )
    x0_j = jnp.asarray(x0.numpy())
    y0 = jnp.concatenate([x0_j, jnp.zeros((tp.B, 1))], axis=-1)
    y1, _ = jax_odeint_fixed(func, y0, 0.0, 1.0, step_size=STEP, method=method)
    log_q_ref = jax_cnf.log_prob_base(x0_j) - y1[:, -1]

    x1, log_q = sample_and_log_prob_cnf(cnf, tp.B, ft, cfg=_cfg(method), x0=x0)
    np.testing.assert_allclose(x1.numpy(), np.asarray(y1[:, :-1]), atol=1e-5)
    np.testing.assert_allclose(log_q.numpy(), np.asarray(log_q_ref), rtol=1e-4)
    # The network moved log q: it is not just the base density plus the offset.
    base_only = cnf.log_prob_base(x0) + 3.0  # delta = -dim * final_scaling * 1
    assert (log_q - base_only).abs().max() > 0.05


@pytest.mark.parametrize("approx,probes", [(False, 1), (True, 1), (True, 3)])
def test_tangent_and_jvp_routes_agree(approx, probes):
    _, _, cnf = tp.make_pair(seed=9)
    x, _, feats = tp.inputs(seed=9)
    xt, ft = tp.to_torch(x, feats)
    cfg = dataclasses.replace(_cfg("rk4"), hutchinson_probes=probes)
    eps = None
    if approx:
        shape = (tp.B, x.shape[1]) if probes == 1 else (probes, tp.B, x.shape[1])
        eps = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    on = get_log_prob(cnf, xt, ft, approx=approx, cfg=cfg, eps=eps)[0]
    off = get_log_prob(
        cnf, xt, ft, approx=approx, cfg=dataclasses.replace(cfg, structured_tangent=False), eps=eps
    )[0]
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-4)


def test_generator_draws_are_reproducible():
    _, _, cnf = tp.make_pair(seed=10)
    ft = torch.from_numpy(tp.inputs()[2])
    cfg = _cfg("rk4")
    a = sample_and_log_prob_cnf(cnf, tp.B, ft, cfg=cfg, generator=torch.Generator().manual_seed(1))
    b = sample_and_log_prob_cnf(cnf, tp.B, ft, cfg=cfg, generator=torch.Generator().manual_seed(1))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert torch.isfinite(u).all()
