"""The QM9 program of the port on the CPU: `epochs_per_dispatch`, the
``qm9`` entry point and ``measure_sampling_time`` on its checkpoints.

- ``epochs_per_dispatch`` 64 against 1 (the port's counterpart of the JAX
  package's `tests/test_examples_e2e.py` grouping test; the port accepts
  the option and ignores it): the same losses, bit for bit, the same
  logged iterations, evaluations and final state.
- The evaluation at iteration -1 that `setup_training` builds for
  `qm9.yaml` (no target, zero node features, f32) on the JAX package's
  initial weights (the time embedding's ``sin/cos(1000 t)`` rows zeroed
  by `torch_parity.slow_time`, without which accept/reject flips on
  last-bit differences: one ulp of the data moves the port's own step
  count by 3), carried across by `convert.from_flax`, against JAX's
  ``eval_and_plot`` on the same test set, with the exact trace and with
  Hutchinson (4 probes a sample, the same probes injected into both):
  ``test_log_lik`` and its two terms within 3e-4 relative and
  ``eval_ode_steps`` within 2 (the adaptive bands of
  `tests/test_torch_adaptive.py`).
- ``examples.qm9.run`` at the tiny overrides of the JAX package's QM9
  end-to-end test (f32, Hutchinson with 4 probes, EMA) on seeded
  positions, with `qm9.yaml`'s ``epochs_per_dispatch: 64`` and
  ``microbatch: 4``: finite losses and ``test_log_lik``, checkpoints, EMA.
- ``measure_sampling_time`` restores the newest of those checkpoints (its
  parameters equal the run's last) and times sampling; without a
  checkpoint it times the initial model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ecnf_tpu.cnf.sampling as jax_sampling
from ecnf_tpu.parallel.mesh import get_mesh
from ecnf_tpu.targets import data as jax_data
from ecnf_tpu.training import config as jax_config
from ecnf_tpu.training import setup as jax_setup
from ecnf_tpu_torch import measure_sampling_time
from ecnf_tpu_torch.cnf import sampling
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.examples import common, qm9
from ecnf_tpu_torch.training import config
from ecnf_tpu_torch.training import setup as torch_setup
from torch_parity import slow_time

torch.set_num_threads(1)

TINY_NET = [
    "flow.network.mlp_units=[8]",
    "flow.network.n_blocks_egnn=1",
    "flow.network.n_invariant_feat_hidden=4",
    "flow.network.time_embedding_dim=4",
]


def _tiny_overrides(save_dir, *extra):
    """`tests/test_examples_e2e.py: _tiny_overrides` with its QM9 extras."""
    return [
        "training.save=true", f"training.save_dir={save_dir}", "training.batch_size=8",
        "training.eval_batch_size=8", "training.n_training_iter=2",
        "training.train_set_size=32", "training.test_set_size=16",
        "training.plot_batch_size=8", "training.n_checkpoints=1", "training.n_eval=1",
        *TINY_NET, "flow.network.compute_dtype=null", "training.use_ema=true",
        "training.eval_exact_log_prob=false", "training.hutchinson_probes=4", *extra,
    ]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Seeded positions of QM9's shapes, unmarked (as the JAX test's)."""
    d = tmp_path_factory.mktemp("qm9_data")
    rng = np.random.default_rng(0)
    for name, n in [("train", 48), ("valid", 16), ("test", 16)]:
        np.save(d / f"qm9pos_{name}.npy", rng.normal(size=(n, 19, 3)).astype(np.float64))
    return d


def _run(overrides, data_dir):
    cfg = common.load_experiment_config(str(common.CONFIG_DIR / "qm9.yaml"), False, overrides)
    return cfg, qm9.run(cfg, device="cpu", data_dir=data_dir)


def test_epochs_per_dispatch_reproduces_single_epochs(tmp_path, data_dir):
    runs = {}
    for k in (1, 64):
        _, (logger, state) = _run(_tiny_overrides(
            tmp_path / f"k{k}", "training.n_training_iter=7", f"training.epochs_per_dispatch={k}",
            "training.n_eval=2", "training.n_checkpoints=1", "training.train_set_size=16",
        ), data_dir)
        runs[k] = (logger.history, state)
    (h1, s1), (h64, s64) = runs[1], runs[64]
    # Evaluations at 3 and 6, a checkpoint at 6.
    assert h64["iteration"] == h1["iteration"]
    assert h1["iteration"].count(3.0) == h1["iteration"].count(6.0) == 2 + 1  # batches, eval
    assert h64["loss"] == h1["loss"] and len(h1["loss"]) == 7 * 2
    for key in ("test_log_lik", "eval_ode_steps"):
        assert h64[key] == h1[key] and len(h1[key]) == 3
    for name, v in s1.params.items():
        assert torch.equal(s64.params[name], v), name
    assert s64.opt_state.count == s1.opt_state.count == 14
    assert sorted(p.name for p in (tmp_path / "k64" / "model_checkpoints").iterdir()) == [
        "state_00000006"]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hutchinson"])
def test_first_evaluation_matches_jax(tmp_path, data_dir, monkeypatch, exact):
    path = str(common.CONFIG_DIR / "qm9.yaml")
    overrides = _tiny_overrides(tmp_path, f"training.eval_exact_log_prob={str(exact).lower()}",
                                "training.eval_plots=false", "training.save=false")
    cfg, jax_cfg = config.load_config(path, overrides), jax_config.load_config(path, overrides)
    t = cfg.training
    if not exact:
        probes = np.random.default_rng(3).normal(
            size=(t.hutchinson_probes, t.eval_batch_size, 19 * 3)).astype(np.float32)
        monkeypatch.setattr(jax_sampling, "_draw_probes",
                            lambda key, B, D, solve_cfg: jnp.asarray(probes))
        monkeypatch.setattr(sampling, "_draw_probes",
                            lambda gen, B, D, solve_cfg, device: torch.from_numpy(probes).to(device))

    def jax_load(train_set_size, test_set_size):
        train, valid, _ = jax_data.load_qm9(train_set_size, path=data_dir)
        return train, valid[:test_set_size]

    jax_tc = jax_setup.setup_training(jax_cfg, jax_load, mesh=get_mesh(jax.devices()[:1]))
    jax_state = jax_tc.init_state(jax.random.PRNGKey(0))
    params = slow_time(jax.tree_util.tree_map(np.array, jax.device_get(jax_state.params)), 4, 4)
    jax_state = jax_state._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    ref = jax_tc.eval_and_plot_fn(jax_state, jax.random.PRNGKey(1), -1, False, None)

    tc = torch_setup.setup_training(cfg, lambda n_train, n_test: qm9.load_dataset(
        n_train, n_test, False, data_dir, "cpu"), device="cpu")
    state = tc.init_state(torch.Generator().manual_seed(0))
    weights = from_flax(params)
    state = state._replace(params={name: weights[name] for name in state.params})
    ours = tc.eval_and_plot_fn(state, torch.Generator().manual_seed(1), -1, False, None)

    assert set(ours) == set(ref) == {"test_log_lik", "test_log_prob_base",
                                     "test_delta_log_lik", "eval_ode_steps"}
    for key in ("test_log_lik", "test_log_prob_base", "test_delta_log_lik"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=3e-4, err_msg=key)
    assert abs(float(ours["eval_ode_steps"]) - float(ref["eval_ode_steps"])) <= 2


@pytest.fixture(scope="module")
def qm9_run(tmp_path_factory, data_dir):
    save_dir = tmp_path_factory.mktemp("qm9_run")
    cfg, (logger, state) = _run(_tiny_overrides(save_dir), data_dir)
    return cfg, save_dir, logger.history, state


def test_qm9_entry_point_trains_evaluates_and_saves(qm9_run):
    cfg, save_dir, h, state = qm9_run
    assert cfg.training.epochs_per_dispatch == 64 and cfg.training.microbatch == 4
    assert cfg.training.eval_n_model_samples is None and not cfg.training.eval_exact_log_prob
    assert len(h["loss"]) == 2 * (32 // 8) and np.isfinite(h["loss"]).all()
    assert np.isfinite(h["test_log_lik"]).all() and len(h["test_log_lik"]) == 2
    assert "rv_ess" not in h and "forward_ess" not in h
    assert h["iteration"][0] == -1.0 and h["iteration"][-1] == 1.0
    assert state.ema_params is not None
    ckpts = save_dir / "model_checkpoints"
    assert [p.name for p in ckpts.iterdir()] == ["state_00000001"]
    assert (ckpts / "state_00000001" / "ema_params.npz").exists()


def test_measure_sampling_time_restores_the_checkpoints(qm9_run, capsys):
    _, save_dir, _, state = qm9_run
    out = measure_sampling_time.main([
        "--checkpoint-dir", str(save_dir / "model_checkpoints"), "--batch-size", "4",
        "--reps", "2", "--device", "cpu", *TINY_NET,
    ])
    assert out["checkpoint"].endswith("state_00000001")
    assert out["params"].keys() == state.params.keys()
    for name, v in state.params.items():
        assert torch.equal(out["params"][name], v), name
    assert out["first_s"] > 0 and len(out["rep_s"]) == 2 and min(out["rep_s"]) > 0
    assert tuple(out["samples"].shape) == (4, 57) and torch.isfinite(out["samples"]).all()
    printed = capsys.readouterr().out
    assert "restoring" in printed and "best of 2" in printed and "host clock" in printed


def test_measure_sampling_time_without_checkpoints(tmp_path, capsys):
    out = measure_sampling_time.main([
        "--checkpoint-dir", str(tmp_path / "none"), "--batch-size", "2", "--reps", "1",
        "--device", "cpu", *TINY_NET,
    ])
    assert out["checkpoint"] is None and torch.isfinite(out["samples"]).all()
    assert "no checkpoint found" in capsys.readouterr().out
