"""`python -m ecnf_tpu_torch.score --device cpu` on weights exported from
the JAX package, against JAX `get_log_prob` on the same configurations.

The network is the small one of `torch_parity` (N=5, 2 blocks of [32, 32],
hidden 16) with zero node features, its Dense kernels redrawn
(`torch_parity.redraw`, `slow_time`).  Bands: the adaptive solve (the
default) within 3e-4 relative, the f32 band of
`tests/test_torch_adaptive.py`; fixed-step rk4 within 1e-4, the band of
`tests/test_torch_sampling.py`.  The port scores 6 configurations in
batches of 4 (the last one padded), JAX in one batch: each sample's
adaptive solve does not depend on the others in its batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.cnf.build import build_cnf as build_jax_cnf
from ecnf_tpu_torch import score
from ecnf_tpu_torch.convert import flatten

N, DIM, N_DATA = tp.N, tp.DIM, 6
NET = ["--n-blocks", "2", "--mlp-units", "32", "32", "--hidden", str(tp.H),
       "--time-embedding-dim", str(tp.T), "--dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``(npz path, data path, jax cnf, jax params, zero-CoM data [n, N*D])``."""
    kw = dict(tp.cnf_kwargs(2, (32, 32), n=N, dim=DIM), n_features=1)
    jax_cnf = build_jax_cnf(**kw)
    x = jnp.zeros((2, N * DIM))
    params = jax.jit(jax_cnf.init)(jax.random.PRNGKey(3), x, jnp.zeros(2), jnp.zeros((2, N), jnp.int32))
    tree = tp.slow_time(tp.redraw(jax.tree_util.tree_map(np.asarray, params), seed=41))
    root = tmp_path_factory.mktemp("score")
    np.savez(root / "params.npz", **{k: v.astype(np.float32) for k, v in flatten(tree).items()})
    data = (np.random.default_rng(42).normal(size=(N_DATA, N, DIM)) * 1.2 + 0.7).astype(np.float32)
    np.save(root / "data.npy", data)
    centred = (data - data.mean(axis=1, keepdims=True)).reshape(N_DATA, -1)
    jax_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return root / "params.npz", root / "data.npy", jax_cnf, jax_params, centred


def _jax_log_p(exported, cfg):
    _, _, jax_cnf, params, centred = exported
    feats = jnp.zeros((N_DATA, N), jnp.int32)
    return np.asarray(jax_sampling.get_log_prob(
        jax_cnf, params, jnp.asarray(centred), jax.random.PRNGKey(0), feats, cfg=cfg
    )[0])


def _argv(exported, *extra):
    npz, data = exported[:2]
    return ["--data", str(data), "--params-npz", str(npz), "--batch-size", "4", *NET, *extra]


def test_adaptive_scores_match_jax_get_log_prob(exported, tmp_path, capsys):
    out_path = tmp_path / "log_p.npy"
    out = score.main(_argv(exported, "--output", str(out_path)))
    ref = _jax_log_p(exported, jax_sampling.SolveConfig())
    np.testing.assert_allclose(out["log_p"], ref, rtol=3e-4)
    np.testing.assert_array_equal(np.load(out_path), out["log_p"])
    printed = capsys.readouterr().out
    assert f"scored {N_DATA} configurations in" in printed and "exact trace" in printed
    assert "first batch of 4" in printed and "other 2" in printed and "(adaptive, float32)" in printed
    assert 0 < out["first_batch_seconds"] < out["seconds"] and out["steady_per_second"] > 0


def test_fixed_step_scores_match_jax_get_log_prob(exported):
    out = score.main(_argv(exported, "--method", "rk4", "--step-size", "0.25"))
    ref = _jax_log_p(exported, jax_sampling.SolveConfig(
        use_fixed_step_size=True, step_size=0.25, method="rk4"))
    np.testing.assert_allclose(out["log_p"], ref, rtol=1e-4)


def test_hutchinson_is_seeded_and_near_exact(exported, capsys):
    argv = _argv(exported, "--method", "rk4", "--step-size", "0.25", "--approx",
                 "--hutchinson-probes", "3")
    a = score.main(argv + ["--seed", "5"])["log_p"]
    b = score.main(argv + ["--seed", "5"])["log_p"]
    c = score.main(argv + ["--seed", "6"])["log_p"]
    exact = score.main(_argv(exported, "--method", "rk4", "--step-size", "0.25"))["log_p"]
    assert "Hutchinson trace" in capsys.readouterr().out
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-4
    # An unbiased estimate of the same trace: within a few units of the exact log p.
    assert np.isfinite(a).all() and np.abs(a - exact).max() < 0.5 * np.abs(exact).max()


def test_data_layout_and_centre_of_mass(exported, tmp_path):
    npz, data_path = exported[:2]
    data = np.load(data_path)
    flat = tmp_path / "flat.npy"
    np.save(flat, data.reshape(N_DATA, -1))
    with pytest.raises(SystemExit, match="flat layout is ambiguous"):
        score.main(["--data", str(flat), "--params-npz", str(npz), *NET])
    # A configuration and its translate score the same: the data are
    # zero-CoM'd first.
    shifted = tmp_path / "shifted.npy"
    np.save(shifted, data[:2] + np.array([3.0, -1.0, 2.0], np.float32))
    fixed = ["--method", "rk4", "--step-size", "0.25"]
    a = score.main(["--data", str(shifted), "--params-npz", str(npz), *NET, *fixed])["log_p"]
    b = score.main(_argv(exported, *fixed))["log_p"][:2]
    np.testing.assert_allclose(a, b, rtol=1e-5)
