"""The evaluation path against the JAX package: target energies, ESS,
padded batching, `eval_fn`, and the evaluation functions of
`ecnf_tpu_torch/training/setup.py` against the same composition of JAX
functions on the same inputs.

Bands: energies rtol 1e-5 (the same f32 sums in another order; LJ's
``d**12`` is a power in torch and repeated products in XLA); ESS and
masked means rtol 1e-6 on the same log weights.  The evaluation runs
through fixed-step rk4 (step 0.25) so that both packages integrate
along the same steps, and its log-densities are held to the rtol 1e-4
of `tests/test_torch_sampling.py`; the ESS values that follow from
them to 1e-3.  One evaluation at `SolveConfig()` (adaptive) is held to
the f32 bands of `tests/test_torch_adaptive.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.ops import ode as jax_ode
from ecnf_tpu.ops.graph import pairwise_difference as jax_pairwise_difference
from ecnf_tpu.ops.numerics import maybe_masked_mean as jax_maybe_masked_mean
from ecnf_tpu.targets import energies as jax_energies
from ecnf_tpu.training import evaluation as jax_eval
from ecnf_tpu_torch.cnf.sampling import SolveConfig
from ecnf_tpu_torch.ops.graph import pairwise_difference
from ecnf_tpu_torch.ops.numerics import maybe_masked_mean
from ecnf_tpu_torch.targets import energies
from ecnf_tpu_torch.training import evaluation, setup

RNG = np.random.default_rng(0)


def _configs(batch, n, dim, spread, seed):
    return (np.random.default_rng(seed).normal(size=(batch, n, dim)) * spread).astype(np.float32)


@pytest.mark.parametrize(
    "name,n,dim,spread,kw",
    [
        ("double_well", 4, 2, 2.0, {}),
        ("double_well", 4, 2, 2.0, dict(tau=0.7, d0=3.5)),
        ("lennard_jones", 13, 3, 1.0, {}),
        ("lennard_jones", 13, 3, 1.3, dict(epsilon=0.8, tau=1.5, harmonic_potential_coef=1.0)),
        ("lennard_jones", 4, 2, 1.0, {}),
        ("double_well", 13, 3, 2.0, {}),
    ],
)
def test_energies_match_jax(name, n, dim, spread, kw):
    x = _configs(7, n, dim, spread, seed=n + dim)
    jax_fn = getattr(jax_energies, f"{name}_energy")
    fn = getattr(energies, f"{name}_energy")
    ref = np.asarray(jax_fn(jnp.asarray(x), **kw))
    np.testing.assert_allclose(fn(torch.from_numpy(x), **kw).numpy(), ref, rtol=1e-5)
    # One configuration, unbatched, through the log-density.
    log_prob = getattr(energies, f"{name}_log_prob")
    jax_log_prob = getattr(jax_energies, f"{name}_log_prob")
    np.testing.assert_allclose(
        log_prob(torch.from_numpy(x[0])).numpy(), np.asarray(jax_log_prob(jnp.asarray(x[0]))),
        rtol=1e-5,
    )


def test_lennard_jones_per_receiver_radii():
    x = _configs(5, 13, 3, 1.2, seed=1)
    r = np.linspace(0.8, 1.2, 13).astype(np.float32)
    ref = np.asarray(jax_energies.lennard_jones_energy(jnp.asarray(x), r=jnp.asarray(r)))
    out = energies.lennard_jones_energy(torch.from_numpy(x), r=torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    # Per-receiver radii are not symmetric: they differ from their mean.
    uniform = energies.lennard_jones_energy(torch.from_numpy(x), r=float(r.mean()))
    assert (out - uniform).abs().max() > 1e-3


def test_log_prob_rejects_other_ranks():
    with pytest.raises(ValueError):
        energies.lennard_jones_log_prob(torch.zeros(2, 3, 4, 3))
    with pytest.raises(ValueError):
        energies.double_well_log_prob(torch.zeros(8))


def test_pairwise_difference_and_masked_mean_match_jax():
    x = _configs(3, 5, 3, 1.0, seed=2)
    np.testing.assert_array_equal(
        pairwise_difference(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pairwise_difference(jnp.asarray(x))),
    )
    a = RNG.normal(size=9).astype(np.float32)
    for mask in (None, np.array([1, 0, 1, 1, 0, 0, 1, 1, 0], np.int32), np.zeros(9, np.int32)):
        ref = jax_maybe_masked_mean(jnp.asarray(a), None if mask is None else jnp.asarray(mask))
        out = maybe_masked_mean(torch.from_numpy(a), None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


LOG_W = np.array([0.3, -1.2, np.nan, 2.0, np.inf, -0.5, -np.inf, 0.9], np.float32)


@pytest.mark.parametrize("mask", [np.ones(8, np.int32), np.array([1, 1, 1, 0, 1, 1, 1, 0], np.int32)])
def test_forward_ess_masks_non_finite_weights(mask):
    ref = jax_eval.calculate_forward_ess(jnp.asarray(LOG_W), jnp.asarray(mask))["forward_ess"]
    out = evaluation.calculate_forward_ess(torch.from_numpy(LOG_W), torch.from_numpy(mask))
    assert np.isfinite(float(ref))
    np.testing.assert_allclose(out["forward_ess"].numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("log_w", [LOG_W, LOG_W[np.isfinite(LOG_W)], np.zeros(6, np.float32)])
def test_reverse_ess_gives_non_finite_weights_zero_weight(log_w):
    ref = jax_eval.calculate_reverse_ess(jnp.asarray(log_w))
    out = evaluation.calculate_reverse_ess(torch.from_numpy(log_w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("reshape_axis", [0, 1])
@pytest.mark.parametrize("size", [12, 10])
def test_setup_padded_reshaped_data_matches_jax(reshape_axis, size):
    a = RNG.normal(size=(size, 3)).astype(np.float32)
    b = RNG.integers(0, 5, size=(size, 2)).astype(np.int32)
    (ja, jb), jmask = jax_eval.setup_padded_reshaped_data(
        (jnp.asarray(a), jnp.asarray(b)), 4, reshape_axis=reshape_axis
    )
    (ta, tb), tmask = evaluation.setup_padded_reshaped_data(
        tp.to_torch(a, b), 4, reshape_axis=reshape_axis
    )
    for out, ref in ((ta, ja), (tb, jb), (tmask, jmask)):
        assert out.shape == ref.shape and str(out.dtype).endswith(str(ref.dtype))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("with_further", [False, True])
def test_eval_fn_matches_jax_host_loop(with_further):
    x = RNG.normal(size=(11, 4)).astype(np.float32)
    mask = (RNG.uniform(size=11) > 0.3).astype(np.int32)

    def per_batch(xp):
        def fn(xb, mask, **_):
            m = mask.astype(xb.dtype) if xp is jnp else mask.to(xb.dtype)
            info = {"mean": (xb.sum(-1) * m).sum() / (m.sum() + 1.0), "first": xb[0, 0]}
            return (xb.sum(-1), info) if with_further else info
        return fn

    ref = jax_eval.eval_fn(
        jnp.asarray(x), jax.random.PRNGKey(0), eval_on_test_batch_fn=per_batch(jnp),
        eval_batch_free_fn=lambda key: {"free": jnp.float32(2.5)}, batch_size=4,
        mask=jnp.asarray(mask),
    )
    out = evaluation.eval_fn(
        torch.from_numpy(x), eval_on_test_batch_fn=per_batch(torch),
        eval_batch_free_fn=lambda generator: {"free": torch.tensor(2.5)}, batch_size=4,
        mask=torch.from_numpy(mask),
    )
    assert set(out[0]) == set(ref[0]) == {"mean", "first", "free"}
    for k in ref[0]:
        np.testing.assert_allclose(out[0][k].numpy(), np.asarray(ref[0][k]), rtol=1e-6)
    if with_further:
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    else:
        assert out[1] is None and out[2] is None and ref[1] is None


# The evaluation functions: the LJ target at N=5, D=3, on the CNF of
# `torch_parity.make_pair(slow=True)`.
N_EVAL, FIXED = 5, SolveConfig(use_fixed_step_size=True, step_size=0.25, method="rk4")
JAX_FIXED = jax_sampling.SolveConfig(use_fixed_step_size=True, step_size=0.25, method="rk4")


def _test_set(n_points, seed):
    pos = _configs(n_points, N_EVAL, 3, 1.1, seed)
    pos = (pos - pos.mean(axis=1, keepdims=True)).reshape(n_points, -1)
    feats = np.tile(np.arange(N_EVAL) % tp.N_FEATURES, (n_points, 1)).astype(np.int32)
    return pos, feats


def _jax_eval_batch(jax_cnf, params, pos_b, feat_b, mask, jcfg):
    """JAX `setup_training`'s `_eval_data_batch_impl`, composed of the same
    JAX functions, with the exact trace."""
    log_q, base, delta, stats = jax_sampling.get_log_prob(
        jax_cnf, params, pos_b, jax.random.PRNGKey(0), features=feat_b, cfg=jcfg,
        return_stats=True,
    )
    mask = mask * jnp.isfinite(log_q).astype(mask.dtype)
    info = {
        "test_log_lik": jax_maybe_masked_mean(log_q, mask),
        "test_log_prob_base": jax_maybe_masked_mean(base, mask),
        "test_delta_log_lik": jax_maybe_masked_mean(delta, mask),
        "eval_ode_steps": stats.num_steps.astype(jnp.float32),
    }
    log_p = jax_energies.lennard_jones_log_prob(pos_b.reshape(-1, N_EVAL, 3))
    return log_p - log_q, info


def test_eval_data_batch_matches_jax():
    jax_cnf, params, cnf = tp.make_pair(seed=31, n=N_EVAL, slow=True)
    pos, feats = _test_set(6, seed=32)
    mask = np.array([1, 1, 0, 1, 1, 1], np.int32)
    log_w_ref, ref = _jax_eval_batch(
        jax_cnf, params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask), JAX_FIXED
    )
    log_w, info = setup.eval_data_batch(
        cnf, tp.to_torch(pos, feats), torch.from_numpy(mask),
        energies.lennard_jones_log_prob, cfg=FIXED,
    )
    assert set(info) == set(ref)
    for k in ref:
        np.testing.assert_allclose(info[k].numpy(), np.asarray(ref[k]), rtol=1e-4)
    np.testing.assert_allclose(log_w.numpy(), np.asarray(log_w_ref), rtol=1e-4)
    # A sample whose log q is NaN leaves the means: the mean of the other
    # valid rows' log q from above.
    nan_pos = pos.copy()
    nan_pos[1] = np.nan
    _, info_nan = setup.eval_data_batch(
        cnf, tp.to_torch(nan_pos, feats), torch.from_numpy(mask), cfg=FIXED
    )
    log_q = energies.lennard_jones_log_prob(torch.from_numpy(pos).reshape(-1, N_EVAL, 3)) - log_w
    keep = mask.astype(bool) & (np.arange(6) != 1)
    np.testing.assert_allclose(info_nan["test_log_lik"].numpy(), log_q.numpy()[keep].mean(), rtol=1e-5)


def test_reverse_ess_matches_jax_composition():
    jax_cnf, params, cnf = tp.make_pair(seed=33, n=N_EVAL, slow=True)
    # 10 model samples in batches of min(4, 10) = 4: 10 // 4 = 2 batches.
    n_batches, b = 2, 4
    noise = np.random.default_rng(34).normal(size=(n_batches, b, N_EVAL, 3)).astype(np.float32)
    x0 = torch.stack([cnf.sample_base((b,), noise=torch.from_numpy(z)) for z in noise])
    row = torch.from_numpy(np.arange(N_EVAL) % tp.N_FEATURES)
    out = setup.reverse_ess(
        cnf, energies.lennard_jones_log_prob, row, n_model_samples=10, batch_size=4,
        cfg=FIXED, x0=x0,
    )
    log_ws = []
    feats = jnp.tile(jnp.asarray(row.numpy())[None], (b, 1))
    for x0_i in x0.numpy():
        func = jax_sampling._augmented_field(jax_cnf, params, feats, False, None, JAX_FIXED)
        y0 = jnp.concatenate([jnp.asarray(x0_i), jnp.zeros((b, 1))], axis=-1)
        y1, _ = jax_ode.odeint_fixed(func, y0, 0.0, 1.0, step_size=0.25, method="rk4")
        log_q = jax_cnf.log_prob_base(jnp.asarray(x0_i)) - y1[:, -1]
        log_p = jax_energies.lennard_jones_log_prob(y1[:, :-1].reshape(-1, N_EVAL, 3))
        log_ws.append(log_p - log_q)
    ref = jax_eval.calculate_reverse_ess(jnp.concatenate(log_ws))
    np.testing.assert_allclose(out["rv_ess"].numpy(), np.asarray(ref), rtol=1e-3)


@pytest.mark.parametrize("adaptive", [False, True], ids=["rk4", "adaptive"])
def test_evaluate_matches_jax_eval_fn(adaptive):
    jax_cnf, params, cnf = tp.make_pair(seed=35, n=N_EVAL, slow=True)
    pos, feats = _test_set(6 if adaptive else 10, seed=36)
    cfg, jcfg = (SolveConfig(), jax_sampling.SolveConfig()) if adaptive else (FIXED, JAX_FIXED)
    info = setup.evaluate(
        cnf, *tp.to_torch(pos, feats), features_row=torch.from_numpy(feats[0]), batch_size=4,
        target_log_prob_fn=energies.lennard_jones_log_prob, cfg=cfg,
    )

    def per_batch(data, key, mask):
        return _jax_eval_batch(jax_cnf, params, *data, mask, jcfg)

    ref, log_w, flat_mask = jax_eval.eval_fn(
        (jnp.asarray(pos), jnp.asarray(feats)), jax.random.PRNGKey(0),
        eval_on_test_batch_fn=per_batch, batch_size=4,
    )
    ref.update(jax_eval.calculate_forward_ess(log_w, mask=flat_mask))
    assert set(info) == set(ref)
    rel, ess_rel = (3e-4, 3e-2) if adaptive else (1e-4, 1e-3)
    for k in ("test_log_lik", "test_log_prob_base", "test_delta_log_lik"):
        np.testing.assert_allclose(info[k], float(ref[k]), rtol=rel)
    np.testing.assert_allclose(info["forward_ess"], float(ref["forward_ess"]), rtol=ess_rel)
    if adaptive:
        assert abs(info["eval_ode_steps"] - float(ref["eval_ode_steps"])) <= 2
    else:
        assert info["eval_ode_steps"] == float(ref["eval_ode_steps"]) == 4.0


def test_evaluate_with_reverse_ess_and_hutchinson():
    # The whole evaluation on the default solve: test NLL by Hutchinson,
    # forward ESS, and the reverse ESS of 2 batches of model samples.
    _, _, cnf = tp.make_pair(seed=37, n=N_EVAL, slow=True)
    pos, feats = _test_set(6, seed=38)
    kw = dict(features_row=torch.from_numpy(feats[0]), batch_size=4,
              target_log_prob_fn=energies.lennard_jones_log_prob, n_model_samples=8,
              exact_log_prob=False)
    info = setup.evaluate(cnf, *tp.to_torch(pos, feats), **kw,
                          generator=torch.Generator().manual_seed(0))
    assert set(info) == {"test_log_lik", "test_log_prob_base", "test_delta_log_lik",
                         "eval_ode_steps", "forward_ess", "rv_ess"}
    assert all(np.isfinite(v) for v in info.values())
    assert 0.0 < info["rv_ess"] <= 1.0 and 0.0 <= info["forward_ess"] <= 1.0
    again = setup.evaluate(cnf, *tp.to_torch(pos, feats), **kw,
                           generator=torch.Generator().manual_seed(0))
    assert again == info
