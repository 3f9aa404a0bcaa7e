"""Adaptive Dopri5 (`ecnf_tpu_torch/ops/ode.py`) and the CNF solves at
`SolveConfig()` against the JAX package.

Analytic fields (those of `tests/test_ode.py`): equal ``num_steps`` and
``num_attempts``, ``y`` within 1e-6 relative of each sample's largest
entry, NaN where JAX has NaN, and the initial step within 1e-6 relative.
The one field with a sine is held to 4e-6: XLA's and torch's f32 sines
differ by an ulp at ~5% of arguments, and twelve steps of ``-5 y +
sin(10 t)`` carry that to ~1.2e-6.

The CNF (2 blocks of [32, 32], N=13, B=8, weights of
`torch_parity.make_pair(slow=True)`, ~12 accepted steps): accept/reject is
a threshold on an error ratio, and rounding differences of ~1e-7 between
the packages can flip a step, after which the step sequences part.  So
the solves are held to bands tied to rtol = atol = 1e-5 and the step
counts to a slack of 2 accepted steps and 4 attempts.  Each accepted step
keeps the RMS of its error over the D+1 state columns within atol + rtol
|y| (~4e-5 at |x| ~ 2.5), so one column may carry sqrt(D+1) ~ 6 times
that; over twelve steps in each of two packages, x1 may part by ~1e-3 and
the log-det column by ~1e-2, 2e-4 of |log q| ~ 50.  f32 bands: x1 within
1e-3 absolute, log p / log q within 3e-4 relative.  bf16: log p / log q
within 3e-2 relative, the port's bf16 band (ROADMAP Queue 3 item 5), and
x1 within 3e-2 absolute.  The bf16 cases are in
`tests/test_torch_adaptive_bf16.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.ops import ode as jax_ode
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_tpu_torch.ops import ode

RATES = np.array([[200.0], [0.1]], np.float32)


def _analytic_cases():
    rng = np.random.default_rng(0)
    return {
        # dy/dt = -y with per-component and per-sample scales.
        "decay": (lambda xp: (lambda t, y: -y), np.ones((4, 3), np.float32) * [1.0, 2.0, -3.0],
                  0.0, 1.0, dict(rtol=1e-6, atol=1e-8)),
        "per_sample_scales": (lambda xp: (lambda t, y: -y),
                              np.array([[1e-3], [1.0], [1e3]], np.float32), 0.0, 2.0,
                              dict(rtol=1e-6, atol=1e-12)),
        "backwards": (lambda xp: (lambda t, y: -y), np.full((2, 4), 0.3, np.float32), 1.0, 0.0,
                      dict(rtol=1e-7, atol=1e-9)),
        # dy/dt = 2t: the step depends on each sample's own t.
        "time_dependent": (lambda xp: (lambda t, y: (2.0 * t)[:, None] + 0.0 * y),
                           np.zeros((3, 2), np.float32), 0.0, 1.0, {}),
        "stiffish": (lambda xp: (lambda t, y: -5.0 * y + xp.sin(10.0 * t[:, None])),
                     rng.normal(size=(3, 5)).astype(np.float32), 0.0, 1.0,
                     dict(rtol=1e-6, atol=1e-8)),
        # Sample 0 blows up in finite time and freezes; sample 1 is benign.
        "diverged_freeze": (lambda xp: (lambda t, y: xp.asarray(RATES) * y * y),
                            np.array([[5.0], [0.5]], np.float32), 0.0, 1.0,
                            dict(rtol=1e-5, atol=1e-5, max_steps=512)),
        # The budget runs out: every sample comes back NaN.
        "max_steps_exhausted": (lambda xp: (lambda t, y: -y), np.ones((3, 2), np.float32),
                                0.0, 1.0, dict(rtol=1e-6, atol=1e-8, max_steps=3)),
    }


class _Torch:
    """The array functions the fields use, for torch tensors."""

    sin = staticmethod(torch.sin)
    asarray = staticmethod(torch.from_numpy)


CASES = _analytic_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_odeint_adaptive_matches_jax(name):
    field, y0, t0, t1, kw = CASES[name]
    y_j, s_j = jax_ode.odeint_adaptive(field(jnp), jnp.asarray(y0), t0, t1, **kw)
    y, stats = ode.odeint_adaptive(field(_Torch), torch.from_numpy(y0), t0, t1, **kw)
    y_j = np.asarray(y_j)
    assert (stats.num_steps, stats.num_attempts) == (int(s_j.num_steps), int(s_j.num_attempts))
    np.testing.assert_array_equal(np.isfinite(y.numpy()), np.isfinite(y_j))
    finite = np.isfinite(y_j).all(axis=1)
    scale = np.abs(y_j[finite]).max(axis=1, keepdims=True)
    rel = 4e-6 if name == "stiffish" else 1e-6
    assert (np.abs(y.numpy()[finite] - y_j[finite]) <= rel * scale).all()
    # One read of `done` before each attempt (and the last, unless the
    # budget ended the loop), one of the step count.
    budget_out = stats.num_attempts == kw.get("max_steps", 4096)
    assert stats.num_syncs == stats.num_attempts + (1 if budget_out else 2)
    if name == "max_steps_exhausted":
        assert stats.num_attempts == 3 and not np.isfinite(y.numpy()).any()
    if name == "diverged_freeze":
        assert not np.isfinite(y.numpy()[0]).any() and stats.num_attempts < 512
        np.testing.assert_allclose(y.numpy()[1], 0.5 / (1.0 - 0.05), rtol=1e-4)


@pytest.mark.parametrize("name", ["decay", "backwards", "time_dependent", "stiffish"])
def test_initial_step_matches_jax(name):
    field, y0, t0, t1, kw = CASES[name]
    rtol, atol = kw.get("rtol", 1e-5), kw.get("atol", 1e-5)
    direction = 1.0 if t1 > t0 else -1.0
    t_j = jnp.full((y0.shape[0],), t0, jnp.float32)
    f_j = field(jnp)(t_j, jnp.asarray(y0))
    ref = jax_ode._initial_step_size(field(jnp), t_j, jnp.asarray(y0), f_j, direction, rtol, atol)
    t = torch.full((y0.shape[0],), t0)
    f = field(_Torch)(t, torch.from_numpy(y0))
    out = ode._initial_step_size(field(_Torch), t, torch.from_numpy(y0), f, direction, rtol, atol)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_odeint_dispatches_to_the_adaptive_solver():
    y0 = torch.ones(2, 3)
    y, stats = ode.odeint(lambda t, y: -y, y0, 0.0, 1.0)
    y_a, stats_a = ode.odeint_adaptive(lambda t, y: -y, y0, 0.0, 1.0)
    torch.testing.assert_close(y, y_a, rtol=0, atol=0)
    assert stats[:2] == stats_a[:2] and stats.num_attempts > 0
    _, stats_f = ode.odeint(lambda t, y: -y, y0, 0.0, 1.0, use_fixed_step_size=True)
    assert stats_f == (20, 20, 0)


N_CNF, B_CNF, K = 13, 8, 4
# Step counts of the two packages' solves may differ by this much (see the
# module docstring).
STEP_SLACK, ATTEMPT_SLACK = 2, 4
BANDS = {None: dict(rel=3e-4, x1=1e-3), "bfloat16": dict(rel=3e-2, x1=3e-2)}


def _cnf_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B_CNF, N_CNF, 3)).astype(np.float32)
    x = (x - x.mean(axis=1, keepdims=True)).reshape(B_CNF, -1)
    feats = np.tile(np.arange(N_CNF) % tp.N_FEATURES, (B_CNF, 1)).astype(np.int32)
    eps = rng.normal(size=(K, B_CNF, N_CNF * 3)).astype(np.float32)
    return x, feats, eps


def _jax_solve(jax_cnf, params, feats, approx, eps, y0, t0, t1):
    func = jax_sampling._augmented_field(
        jax_cnf, params, jnp.asarray(feats), approx, jnp.asarray(eps) if approx else None,
        jax_sampling.SolveConfig(hutchinson_probes=K),
    )
    y1, stats = jax_ode.odeint_adaptive(func, jnp.asarray(y0), t0, t1)
    return np.asarray(y1), stats


def _check_steps(stats, jax_stats):
    assert abs(stats.num_steps - int(jax_stats.num_steps)) <= STEP_SLACK
    assert abs(stats.num_attempts - int(jax_stats.num_attempts)) <= ATTEMPT_SLACK


def check_get_log_prob(cdt, approx):
    jax_cnf, params, cnf = tp.make_pair(cdt=cdt, seed=21, n=N_CNF, slow=True)
    x, feats, eps = _cnf_inputs(22)
    y0 = np.concatenate([x, np.zeros((B_CNF, 1), np.float32)], axis=1)
    y1, jax_stats = _jax_solve(jax_cnf, params, feats, approx, eps, y0, 1.0, 0.0)
    ref = np.asarray(jax_cnf.log_prob_base(jnp.asarray(y1[:, :-1]))) + y1[:, -1]

    xt, ft, et = tp.to_torch(x, feats, eps)
    log_p, base, delta, stats = get_log_prob(
        cnf, xt, ft, approx=approx, cfg=SolveConfig(hutchinson_probes=K),
        eps=et if approx else None, return_stats=True,
    )
    assert torch.isfinite(log_p).all()
    np.testing.assert_allclose(log_p.numpy(), ref, rtol=BANDS[cdt]["rel"])
    torch.testing.assert_close(log_p, base + delta, rtol=0, atol=0)
    _check_steps(stats, jax_stats)


def check_sample_and_log_prob(cdt, approx):
    jax_cnf, params, cnf = tp.make_pair(cdt=cdt, seed=23, n=N_CNF, slow=True)
    x, feats, eps = _cnf_inputs(24)
    x0 = cnf.sample_base((B_CNF,), noise=torch.from_numpy(x))
    y0 = np.concatenate([x0.numpy(), np.zeros((B_CNF, 1), np.float32)], axis=1)
    y1, jax_stats = _jax_solve(jax_cnf, params, feats, approx, eps, y0, 0.0, 1.0)
    log_q_ref = np.asarray(jax_cnf.log_prob_base(jnp.asarray(y0[:, :-1]))) - y1[:, -1]

    ft, et = tp.to_torch(feats, eps)
    x1, log_q, stats = sample_and_log_prob_cnf(
        cnf, B_CNF, ft, approx=approx, cfg=SolveConfig(hutchinson_probes=K), x0=x0,
        eps=et if approx else None, return_stats=True,
    )
    np.testing.assert_allclose(x1.numpy(), y1[:, :-1], atol=BANDS[cdt]["x1"])
    np.testing.assert_allclose(log_q.numpy(), log_q_ref, rtol=BANDS[cdt]["rel"])
    _check_steps(stats, jax_stats)


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "hutchinson4"])
def test_get_log_prob_matches_jax(approx):
    check_get_log_prob(None, approx)


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "hutchinson4"])
def test_sample_and_log_prob_matches_jax(approx):
    check_sample_and_log_prob(None, approx)


def test_per_sample_time_reaches_every_row():
    # Each sample's own t drives its row of the field and of the trace: a
    # batch at eight different times equals eight single-sample calls.
    _, _, cnf = tp.make_pair(seed=25, n=N_CNF, slow=True)
    x, feats, _ = _cnf_inputs(26)
    xt, ft = tp.to_torch(x, feats)
    t = torch.linspace(0.05, 0.95, B_CNF)
    basis, offset = cnf.exact_trace_plan()
    v, div = cnf.tangent_value_and_div(xt, t, ft, basis, trace_offset=offset)
    for i in range(B_CNF):
        v_i, div_i = cnf.tangent_value_and_div(
            xt[i : i + 1], t[i : i + 1], ft[i : i + 1], basis, trace_offset=offset
        )
        torch.testing.assert_close(v[i : i + 1], v_i, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(div[i : i + 1], div_i, rtol=1e-5, atol=1e-5)
    # And the times matter: one shared t gives another field.
    v_same, _ = cnf.tangent_value_and_div(xt, torch.full((B_CNF,), 0.5), ft, basis)
    assert (v - v_same).abs().max() > 1e-2


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "hutchinson"])
def test_round_trip_scores_the_samples(approx):
    # Sampling x1 with log q and re-scoring x1 by the reverse solve agree to
    # the band of the JAX round-trip test (rtol = atol = 1e-3); the
    # Hutchinson route shares its probes between the two solves.
    _, _, cnf = tp.make_pair(seed=27, slow=True)
    ft = torch.from_numpy(tp.inputs()[2])
    gen = torch.Generator().manual_seed(28)
    eps = torch.randn((tp.B, tp.N * tp.DIM), generator=gen) if approx else None
    x1, log_q = sample_and_log_prob_cnf(cnf, tp.B, ft, approx=approx, generator=gen, eps=eps)
    log_p = get_log_prob(cnf, x1, ft, approx=approx, eps=eps)[0]
    torch.testing.assert_close(log_p, log_q, rtol=1e-3, atol=1e-3)
