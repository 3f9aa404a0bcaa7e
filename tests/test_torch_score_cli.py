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
import json
import shutil

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


# --- The reference surface: --config / --checkpoint-dir / --ema / overrides on
# checkpoints the JAX package's `save_checkpoint` writes.

from pathlib import Path  # noqa: E402

from ecnf_tpu.training import checkpoints as jax_ckpt  # noqa: E402
from ecnf_tpu.training.config import load_config as jax_load_config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LJ13 = str(REPO / "examples" / "configs" / "lj13.yaml")
# lj13.yaml cut to the small widths, in f32.
SMALL_CONFIG = [
    "flow.network.n_blocks_egnn=2", "flow.network.mlp_units=[32,32]",
    f"flow.network.n_invariant_feat_hidden={tp.H}", f"flow.network.time_embedding_dim={tp.T}",
    "flow.network.compute_dtype=float32",
]
RK4 = ["training.use_fixed_step_size=true", "training.ode_method=rk4"]
FIXTURE = REPO / "tests" / "torch_fixtures" / "jax_aldp"


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """``(root, data path, zero-CoM data)``: ``root/ema`` holds JAX
    checkpoints at steps 3 and 5 (params and EMA redrawn; the later one is
    served), ``root/no_ema`` one trained without EMA."""
    root = tmp_path_factory.mktemp("jax_checkpoints")
    _, _, old = tp.jax_training_state(use_ema=True, seed=7)
    jax_ckpt.save_checkpoint(str(root / "ema"), 3, old)
    _, _, state = tp.jax_training_state(use_ema=True, seed=41)
    jax_ckpt.save_checkpoint(str(root / "ema"), 5, state)
    _, _, no_ema = tp.jax_training_state(use_ema=False, seed=41)
    jax_ckpt.save_checkpoint(str(root / "no_ema"), 5, no_ema)
    data = (np.random.default_rng(43).normal(size=(N_DATA, N, DIM)) * 1.2).astype(np.float32)
    np.save(root / "data.npy", data)
    centred = (data - data.mean(axis=1, keepdims=True)).reshape(N_DATA, -1)
    return root, root / "data.npy", centred


def reference_log_p(checkpoint_dir, centred, overrides, ema=False, config=LJ13):
    """What `examples/score.py` computes: the network and the solve from the
    config, the latest checkpoint's (EMA) params, `get_log_prob`."""
    cfg = jax_load_config(config, overrides=overrides)
    net = cfg.flow.network
    cnf = build_jax_cnf(
        n_frames=N, dim=DIM, sigma_min=cfg.flow.sigma_min, base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net.n_blocks_egnn, mlp_units=tuple(net.mlp_units),
        n_invariant_feat_hidden=net.n_invariant_feat_hidden,
        time_embedding_dim=net.time_embedding_dim, n_features=1, stable_mlp=net.stable_mlp,
        compute_dtype=net.compute_dtype,
    )
    x = jnp.asarray(centred)
    feats = jnp.zeros((x.shape[0], N), jnp.int32)
    template = cnf.init(jax.random.PRNGKey(0), x[:2], jnp.zeros(2), feats[:2])
    latest = jax_ckpt.get_latest_checkpoint(str(checkpoint_dir))
    params = jax_ckpt.restore_serving_params(latest, template, ema=ema)
    solve = jax_sampling.SolveConfig(
        use_fixed_step_size=cfg.training.use_fixed_step_size, method=cfg.training.ode_method,
        hutchinson_probes=cfg.training.hutchinson_probes,
    )
    return np.asarray(jax_sampling.get_log_prob(cnf, params, x, jax.random.PRNGKey(0), feats, cfg=solve)[0])


@pytest.mark.parametrize("solve,ema,rtol", [("adaptive", False, 3e-4), ("adaptive", True, 3e-4),
                                            ("rk4", False, 1e-4), ("rk4", True, 1e-4)])
def test_checkpoint_dir_scores_match_jax(jax_checkpoints, capsys, solve, ema, rtol):
    root, data, centred = jax_checkpoints
    overrides = SMALL_CONFIG + (RK4 if solve == "rk4" else [])
    argv = ["--checkpoint-dir", str(root / "ema"), "--data", str(data), "--batch-size", "4",
            "--device", "cpu", *(["--ema"] if ema else []), *overrides]
    if solve == "rk4":
        argv = ["--config", LJ13] + argv  # the default config, named
    out = score.main(argv)
    printed = capsys.readouterr().out
    assert f"restoring {root / 'ema' / 'state_00000005'}" in printed
    assert f"({solve}, float32)" in printed
    np.testing.assert_allclose(out["log_p"], reference_log_p(root / "ema", centred, overrides, ema), rtol=rtol)
    other = score.main([a for a in argv if a != "--ema"] + ([] if ema else ["--ema"]))["log_p"]
    assert np.abs(other - out["log_p"]).max() > 1e-3  # --ema serves other weights


def test_checkpoint_dir_refusals(jax_checkpoints, tmp_path, exported):
    root, data, _ = jax_checkpoints
    base = ["--checkpoint-dir", str(root / "ema"), "--data", str(data), "--device", "cpu", *SMALL_CONFIG]
    for extra in (["--params-npz", str(exported[0])], ["--n-blocks", "2"], ["--method", "rk4"]):
        with pytest.raises(SystemExit) as exc:
            score.main(base + extra)
        assert exc.value.code == 2
    with pytest.raises(NotImplementedError, match="network.stable_mlp=True"):
        score.main(base + ["flow.network.stable_mlp=true"])
    with pytest.raises(SystemExit, match="use_ema=false"):
        score.main(["--checkpoint-dir", str(root / "no_ema"), "--data", str(data), "--device", "cpu",
                    "--ema", *SMALL_CONFIG])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint under"):
        score.main(["--checkpoint-dir", str(tmp_path / "empty"), "--data", str(data), "--device", "cpu"])
    for extra in (["--ema"], ["--config", LJ13], ["training.ode_method=rk4"]):
        with pytest.raises(SystemExit) as exc:
            score.main(["--data", str(data), "--device", "cpu", *extra])
        assert exc.value.code == 2
    # A _METADATA that says zarr v3 is refused by name.
    edited = tmp_path / "zarr3"
    shutil.copytree(root / "ema", edited)
    meta_path = edited / "state_00000005" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    meta["use_zarr3"] = True
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="use_zarr3"):
        score.main(["--checkpoint-dir", str(edited), "--data", str(data), "--device", "cpu", *SMALL_CONFIG])


@pytest.mark.parametrize("ema", [False, True])
def test_committed_jax_fixture_scores_as_jax(tmp_path, ema):
    """Two frames of the committed ALDP-width JAX checkpoint, as chip_smoke
    phase 15 scores all sixteen on the card."""
    expected = json.loads((FIXTURE / "expected.json").read_text())
    frames = np.load(FIXTURE / "frames.npy")[:2]
    np.save(tmp_path / "frames.npy", frames)
    out = score.main(["--config", str(REPO / expected["config"]), "--checkpoint-dir",
                      str(FIXTURE / "model_checkpoints"), "--features", "arange", "--data",
                      str(tmp_path / "frames.npy"), "--device", "cpu", *(["--ema"] if ema else []),
                      *expected["score_overrides"]])
    ref = expected["log_p"]["ema_params" if ema else "params"][:2]
    np.testing.assert_allclose(out["log_p"], ref, rtol=1e-4)
