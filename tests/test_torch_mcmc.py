"""The port's HMC and its diagnostics against the JAX package.

Diagnostics: numpy in both packages, held within 1e-12.  Leapfrog and the
accept rule: the same momenta and uniforms injected into both, on the DW4
and LJ13 log-densities, x, p and the accepted states within 1e-5
relative in f32 (the same f32 arithmetic; XLA and torch sum the pairwise
terms in other orders).  A port-only run recovers a Gaussian's moments
at the tolerance of `tests/test_mcmc.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecnf_tpu.targets import diagnostics as jax_diag
from ecnf_tpu.targets import energies as jax_energies
from ecnf_tpu.targets import mcmc as jax_mcmc
from ecnf_tpu_torch.targets import diagnostics, energies, mcmc

torch.set_num_threads(1)


def _series_cases():
    rng = np.random.default_rng(0)
    mixed = rng.normal(size=(8, 200))
    correlated = np.cumsum(rng.normal(size=(6, 151)), axis=1)
    stuck = rng.normal(size=(8, 100))
    stuck[0] += 7.0
    constant = np.ones((4, 40))
    return {"mixed": mixed, "correlated": correlated, "stuck": stuck, "constant": constant}


@pytest.mark.parametrize("case", sorted(_series_cases()))
def test_diagnostics_match_jax(case):
    series = _series_cases()[case]
    for name in ("split_chains",):
        np.testing.assert_array_equal(getattr(diagnostics, name)(series),
                                      getattr(jax_diag, name)(series))
    for name in ("split_rhat", "bulk_ess"):
        a, b = getattr(diagnostics, name)(series), getattr(jax_diag, name)(series)
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12), (name, a, b)
    np.testing.assert_allclose(diagnostics._autocorr_fft(series[0]), jax_diag._autocorr_fft(series[0]),
                               rtol=1e-12, atol=1e-12)


def test_mcmc_diagnostics_match_jax_including_stuck_chains():
    """The report on chain-major samples, as `tests/test_mcmc.py:156`'s
    stuck-chain case builds them, with one energy function for both."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(8 * 100, 4, 2))
    data[:100] += 7.0
    log_prob = lambda x: -np.asarray(x**2).sum((-1, -2))
    ours = diagnostics.mcmc_diagnostics(data, n_chains=8, log_prob_fn=log_prob)
    ref = jax_diag.mcmc_diagnostics(data, n_chains=8, log_prob_fn=log_prob)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
    np.testing.assert_allclose(diagnostics.mean_pairwise_distance(data[:7]),
                               jax_diag.mean_pairwise_distance(data[:7]), rtol=1e-12)


def test_icosahedron_matches_jax():
    ours = mcmc.icosahedron_with_center(3, noise=0.0, eps=torch.zeros(3, 13, 3))
    ref = jax_mcmc.icosahedron_with_center(3, jax.random.PRNGKey(0), noise=0.0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref, dtype=np.float32))


def _start(name, C, seed):
    rng = np.random.default_rng(seed)
    if name == "dw4":
        return rng.normal(size=(C, 4, 2)).astype(np.float32) * 1.5, 0.12, 5
    x0 = np.asarray(jax_mcmc.icosahedron_with_center(C, jax.random.PRNGKey(seed), noise=0.03))
    return x0.astype(np.float32), 0.012, 8


def _jax_step(log_prob, x, p, log_u, step_size, n_leapfrog):
    """One step of JAX `run_hmc`'s body, with its momenta and log-uniforms
    given."""
    grad_fn = jax.grad(lambda xs: jnp.sum(log_prob(xs)))
    lp = log_prob(x)
    ke0 = 0.5 * jnp.sum(p**2, axis=(-1, -2))
    x_new, p_new = jax_mcmc._leapfrog(grad_fn, x, p, step_size, n_leapfrog)
    lp_new = log_prob(x_new)
    ke1 = 0.5 * jnp.sum(p_new**2, axis=(-1, -2))
    accept = (log_u < (lp_new - ke1) - (lp - ke0)) & jnp.isfinite(lp_new)
    return x_new, p_new, jnp.where(accept[:, None, None], x_new, x), accept


@pytest.mark.parametrize("name", ["dw4", "lj13"])
def test_leapfrog_and_accept_match_jax(name):
    C = 6
    x0, step_size, n_leapfrog = _start(name, C, seed=1)
    log_prob = {"dw4": energies.double_well_log_prob, "lj13": energies.lennard_jones_log_prob}[name]
    jax_log_prob = {"dw4": jax_energies.double_well_log_prob,
                    "lj13": jax_energies.lennard_jones_log_prob}[name]
    rng = np.random.default_rng(2)
    p = rng.normal(size=x0.shape).astype(np.float32)
    # Half the chains take uniforms near 1 and half near 0, so both
    # branches of the rule run.
    u = np.where(np.arange(C) % 2 == 0, 0.999, 1e-6).astype(np.float32)
    log_u = np.log(u)
    vg = mcmc.value_and_grad(log_prob)
    xt, pt, lpt, gt = mcmc._leapfrog(vg, torch.from_numpy(x0), torch.from_numpy(p), step_size,
                                     n_leapfrog)
    lp0, g0 = vg(torch.from_numpy(x0))
    x1, lp1, g1, acc = mcmc.hmc_step(vg, torch.from_numpy(x0), lp0, g0, torch.from_numpy(p),
                                     torch.from_numpy(log_u), step_size, n_leapfrog)
    jx, jp, jx1, jacc = _jax_step(jax_log_prob, jnp.asarray(x0), jnp.asarray(p),
                                  jnp.asarray(log_u), step_size, n_leapfrog)
    for ours, ref in ((xt, jx), (pt, jp), (x1, jx1)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert 0 < int(acc.sum()) < C, "both branches of the accept rule should run"
    # The carried gradient equals a fresh one at the accepted points.
    lp_f, g_f = vg(x1)
    torch.testing.assert_close(g1, g_f, rtol=0, atol=0)
    torch.testing.assert_close(lp1, lp_f, rtol=0, atol=0)


def test_run_hmc_injected_draws_order_and_thinning():
    """With injected momenta and uniforms, `run_hmc` keeps the states of
    steps burn_in, burn_in + thin, ... of a plain `hmc_step` loop,
    chain-major, and counts acceptance over every step."""
    C, N, D, burn_in, thin, S = 3, 4, 2, 3, 2, 4
    total = burn_in + S * thin
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(C, N, D, generator=gen) * 1.5
    p = torch.randn(total, C, N, D, generator=gen)
    u = torch.rand(total, C, generator=gen)
    samples, acc = mcmc.run_hmc(energies.double_well_log_prob, S, C, N, D, step_size=0.12,
                                n_leapfrog=4, burn_in=burn_in, thin=thin, init_positions=x0,
                                momenta=p, uniforms=u, device="cpu")
    vg = mcmc.value_and_grad(energies.double_well_log_prob)
    x, (lp, g) = x0, vg(x0)
    states, accepted = [], 0
    for i in range(total):
        x, lp, g, a = mcmc.hmc_step(vg, x, lp, g, p[i], torch.log(u[i]), 0.12, 4)
        states.append(x)
        accepted += int(a.sum())
    kept = torch.stack(states[burn_in::thin][:S])  # [S, C, N, D]
    torch.testing.assert_close(samples, kept.transpose(0, 1).reshape(C * S, N, D), rtol=0, atol=0)
    assert acc == accepted / (total * C)


def test_gaussian_moments():
    def log_prob(x):
        return -0.5 * torch.sum(x**2, dim=(-1, -2))

    samples, acc = mcmc.run_hmc(log_prob, n_samples_per_chain=100, n_chains=32, n_nodes=4, dim=2,
                                step_size=0.3, n_leapfrog=8, burn_in=200, thin=5,
                                generator=torch.Generator().manual_seed(0), device="cpu")
    assert samples.shape == (3200, 4, 2)
    assert 0.4 < acc <= 1.0
    flat = samples.reshape(-1).double()
    assert abs(float(flat.mean())) < 0.05
    assert abs(float(flat.std()) - 1.0) < 0.05


def test_stuck_chain_restarts_from_the_next_moving_chain(capsys):
    """A chain that accepts nothing (here: a NaN start, whose proposals are
    never finite) stays stuck without the restart and, with it, takes over
    the next moving chain's state inside the burn-in; the other chains are
    untouched by the restart."""
    C, N, D, burn_in, thin, S = 4, 4, 2, 6, 1, 3
    total = burn_in + S * thin
    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn(C, N, D, generator=gen) * 1.5
    x0[1] = float("nan")
    draws = dict(momenta=torch.randn(total, C, N, D, generator=gen),
                 uniforms=torch.rand(total, C, generator=gen))
    kw = dict(step_size=0.12, n_leapfrog=3, burn_in=burn_in, thin=thin, init_positions=x0,
              device="cpu", **draws)
    stuck, _ = mcmc.run_hmc(energies.double_well_log_prob, S, C, N, D, **kw)
    restarted, _ = mcmc.run_hmc(energies.double_well_log_prob, S, C, N, D, restart_stuck_at=3, **kw)
    by_chain = restarted.reshape(C, S, N, D)
    assert torch.isnan(stuck.reshape(C, S, N, D)[1]).all()
    assert torch.isfinite(by_chain).all()
    torch.testing.assert_close(by_chain[[0, 2, 3]], stuck.reshape(C, S, N, D)[[0, 2, 3]],
                               rtol=0, atol=0)
    assert "restarting 1 chain(s) that accepted no step, [1], from [2]" in capsys.readouterr().out
    with pytest.raises(ValueError, match="inside the burn-in"):
        mcmc.run_hmc(energies.double_well_log_prob, S, C, N, D, restart_stuck_at=burn_in, **kw)
