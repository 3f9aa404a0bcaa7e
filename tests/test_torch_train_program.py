"""The DW4 training program of the port against the JAX package's, on the
CPU, at the examples' ``--local`` widths (2 blocks of [16], hidden 8,
time embedding 6, base scale 2) on a fixture data directory of short HMC
chains.

- The evaluation at iteration -1 (exact trace, adaptive Dopri5, f32) on
  the JAX package's initial weights, carried across by `convert.from_flax`:
  ``test_log_lik`` within 3e-4 relative, ``forward_ess`` within 1e-3 and
  ``eval_ode_steps`` within 2 of JAX's ``eval_and_plot`` on the same
  test set (the adaptive bands of `tests/test_torch_adaptive.py`).
- The learning-rate schedule `setup_training` builds equals JAX's at every
  step.
- The entry point's ``run`` with the config that ``--local --device cpu``
  gives trains, evaluates at -1 and at its last iteration and writes its
  checkpoints; a resumed run starts after the last one; ``score`` reads
  the ``params.npz`` it wrote.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from ecnf_tpu.parallel.mesh import get_mesh
from ecnf_tpu.targets import data as jax_data
from ecnf_tpu.targets import energies as jax_energies
from ecnf_tpu.training import config as jax_config
from ecnf_tpu.training import setup as jax_setup
from ecnf_tpu_torch import score
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.examples import common, dw4
from ecnf_tpu_torch.targets import data, energies, mcmc
from ecnf_tpu_torch.training import config, optim
from ecnf_tpu_torch.training import setup as torch_setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Short DW4 chains (16 chains x 25 samples), saved under both packages'
    cache names."""
    samples, _ = mcmc.run_hmc(
        energies.double_well_log_prob, n_samples_per_chain=25, n_chains=16, n_nodes=4, dim=2,
        step_size=0.12, n_leapfrog=15, burn_in=100, thin=2,
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    d = tmp_path_factory.mktemp("dw4_data")
    for name in ("dw4_generated.npy", data.DW4_CACHE):
        np.save(d / name, samples.double().numpy())
    return d


def _overrides(save_dir, *extra):
    return [
        "flow.network.compute_dtype=null", "training.eval_plots=false",
        "training.eval_dispatch_chunk=1", "training.test_set_size=18",
        f"training.save_dir={save_dir}", *extra,
    ]


def _configs(save_dir, *extra):
    path = str(common.CONFIG_DIR / "dw4.yaml")
    overrides = list(common.LOCAL_OVERRIDES) + list(dw4.LOCAL_EXTRA) + _overrides(save_dir, *extra)
    return config.load_config(path, overrides), jax_config.load_config(path, overrides)


def _setups(cfg, jax_cfg, data_dir):
    def jax_load(train_set_size, test_set_size):
        train, _, test = jax_data.load_dw4(train_set_size, path=data_dir)
        return train, test[:test_set_size]

    jax_tc = jax_setup.setup_training(
        jax_cfg, jax_load, jax_energies.double_well_log_prob, mesh=get_mesh(jax.devices()[:1])
    )
    tc = torch_setup.setup_training(
        cfg, lambda n_train, n_test: dw4.load_dataset(n_train, n_test, True, data_dir, "cpu"),
        energies.double_well_log_prob, device="cpu",
    )
    return jax_tc, tc


def test_first_evaluation_matches_jax(data_dir, tmp_path):
    cfg, jax_cfg = _configs(tmp_path)
    jax_tc, tc = _setups(cfg, jax_cfg, data_dir)
    jax_state = jax_tc.init_state(jax.random.PRNGKey(0))
    ref = jax_tc.eval_and_plot_fn(jax_state, jax.random.PRNGKey(1), -1, False, None)

    state = tc.init_state(torch.Generator().manual_seed(0))
    weights = from_flax(jax.device_get(jax_state.params))
    state = state._replace(params={name: weights[name] for name in state.params})
    ours = tc.eval_and_plot_fn(state, torch.Generator().manual_seed(1), -1, False, None)

    assert set(ours) == set(ref) == {"test_log_lik", "test_log_prob_base",
                                     "test_delta_log_lik", "eval_ode_steps", "forward_ess"}
    np.testing.assert_allclose(ours["test_log_lik"], ref["test_log_lik"], rtol=3e-4)
    np.testing.assert_allclose(ours["forward_ess"], ref["forward_ess"], atol=1e-3)
    assert abs(float(ours["eval_ode_steps"]) - float(ref["eval_ode_steps"])) <= 2
    assert 0.0 < float(ref["forward_ess"]) <= 1.0


def test_schedule_matches_jax(data_dir, tmp_path, monkeypatch):
    """The warmup-cosine schedule over n_training_iter x batches per epoch
    (10 x 10 at the --local sizes), step for step."""
    captured = {}
    orig_jax, orig_torch = optax.warmup_cosine_decay_schedule, optim.warmup_cosine_decay_schedule

    def spy(orig, name):
        def build(*args, **kwargs):
            captured[name] = orig(*args, **kwargs)
            return captured[name]
        return build

    monkeypatch.setattr(optax, "warmup_cosine_decay_schedule", spy(orig_jax, "jax"))
    monkeypatch.setattr(optim, "warmup_cosine_decay_schedule", spy(orig_torch, "torch"))
    cfg, jax_cfg = _configs(tmp_path, "training.optimizer.peak_lr=3e-4",
                            "training.optimizer.end_lr=1e-5")
    _setups(cfg, jax_cfg, data_dir)
    steps = cfg.training.n_training_iter * (cfg.training.train_set_size // cfg.training.batch_size)
    assert steps == 100
    ours = np.array([captured["torch"](c) for c in range(steps + 1)])
    ref = np.array([float(captured["jax"](c)) for c in range(steps + 1)])
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-12)
    assert ours.max() == pytest.approx(3e-4)


def _run(argv, data_dir):
    config_path, local, device, overrides = common.parse_args("dw4.yaml", argv)
    cfg = common.load_experiment_config(config_path, local, overrides, dw4.LOCAL_EXTRA)
    return dw4.run(cfg, device=device, data_dir=data_dir)


def test_entry_point_trains_checkpoints_resumes_and_scores(data_dir, tmp_path):
    save_dir = tmp_path / "run"
    argv = ["--local", "--device", "cpu", "training.save=true", f"training.save_dir={save_dir}",
            "training.n_eval=1", "training.n_checkpoints=2", "training.test_set_size=9"]
    logger, state = _run(argv + ["training.n_training_iter=2"], data_dir)
    h = logger.history
    assert h["iteration"] == [-1.0] + [0.0] * 10 + [1.0] * 10 + [1.0]
    assert len(h["loss"]) == 20 and np.isfinite(h["loss"]).all()
    assert len(h["test_log_lik"]) == 2 and np.isfinite(h["test_log_lik"]).all()
    ckpts = save_dir / "model_checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["state_00000000", "state_00000001"]

    logger, _ = _run(argv + ["training.n_training_iter=3", "training.resume=true"], data_dir)
    assert logger.history["iteration"] == [2.0] * 10 + [2.0]
    assert (ckpts / "state_00000002" / "params.npz").exists()

    test = data.load_dw4(80, path=data_dir, device="cpu")[2].positions[:9]
    np.save(tmp_path / "test.npy", test.numpy())
    out = score.main([
        "--data", str(tmp_path / "test.npy"), "--params-npz",
        str(ckpts / "state_00000002" / "params.npz"), "--device", "cpu", "--n-blocks", "2",
        "--mlp-units", "16", "--hidden", "8", "--time-embedding-dim", "6", "--base-scale", "2.0",
    ])
    assert out["log_p"].shape == (9,) and np.isfinite(out["log_p"]).all()


def test_setup_refuses_unported_options(tmp_path):
    # Only use_64_bit is left: the JAX package does not run it
    # (`test_torch_train_options.py`).
    assert list(torch_setup._UNPORTED) == [("training", "use_64_bit")]
    cfg = config.load_config(str(common.CONFIG_DIR / "dw4.yaml"),
                             ["training.use_64_bit=true", f"training.save_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="use_64_bit"):
        torch_setup.setup_training(cfg, lambda a, b: None, device="cpu")
