"""The ALDP program of the port on the CPU: `load_aldp`, the first
evaluation of `setup_training`, and the ``aldp`` entry point.

- `load_aldp` against the JAX package's on the repo's
  ``data/aldp_500K_train_mini.h5`` (read by the port's own HDF5 reader, by
  h5py in JAX), with skips and ``*_n_points``: positions and features
  equal, bit for bit.
- The evaluation at iteration -1 that `setup_training` builds for
  `aldp.yaml` at its ``--local`` widths (one EGNN block of ``[4]``, hidden
  8, time embedding 6, per-atom features, Hutchinson with one probe) on
  the JAX package's initial weights (the time embedding's
  ``sin/cos(1000 t)`` rows zeroed by `torch_parity.slow_time`, as in
  `tests/test_torch_qm9_program.py`), carried across by
  `convert.from_flax`, against JAX's ``eval_and_plot`` on the same test
  set with the same probes injected.  In f32 (``compute_dtype=null``, as
  the QM9 test): ``test_log_lik`` and its two terms within 3e-4 relative
  and ``eval_ode_steps`` within 2 (the adaptive bands of
  `tests/test_torch_adaptive.py`).  In bf16, the config's dtype: within
  the port's bf16 band, 3e-2 relative, and steps within 4
  (`tests/test_torch_adaptive_bf16.py`; XLA on the CPU keeps excess f32
  precision inside fused bf16 chains where the port rounds each op).
- ``python -m ecnf_tpu_torch.examples.aldp --local --device cpu`` (its
  ``main``, saving) trains, evaluates, and writes checkpoints and
  ``plot_000_iter_*.svg`` figures that parse.
"""
import xml.etree.ElementTree as ET

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
from ecnf_tpu_torch.cnf import sampling
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.examples import aldp, common
from ecnf_tpu_torch.targets import load_aldp
from ecnf_tpu_torch.training import config
from ecnf_tpu_torch.training import setup as torch_setup
from torch_parity import slow_time

torch.set_num_threads(1)

H5 = str(common.CONFIG_DIR.parent.parent / "data" / "aldp_500K_train_mini.h5")
# aldp.yaml's --local block: the shared one, then the ALDP extras.
LOCAL = list(common.LOCAL_OVERRIDES) + list(aldp.LOCAL_EXTRA)


@pytest.mark.parametrize("n_points,skip", [((None, None, None), (0, 0)),
                                           ((1600, 150, None), (1600, 1600)),
                                           ((40, None, 7), (1990, 3))])
def test_load_aldp_matches_jax(n_points, skip):
    paths = dict(train_path=H5, val_path=H5, test_path=H5)
    sizes = dict(zip(("train_n_points", "val_n_points", "test_n_points"), n_points))
    skips = dict(val_skip_n=skip[0], test_skip_n=skip[1])
    ours = load_aldp(**paths, **sizes, **skips, device="cpu")
    ref = jax_data.load_aldp(**paths, **sizes, **skips)
    for o, r in zip(ours, ref):
        assert o.positions.dtype == torch.float32 and o.features.dtype == torch.int32
        np.testing.assert_array_equal(o.positions.numpy(), np.asarray(r.positions))
        np.testing.assert_array_equal(o.features.numpy(), np.asarray(r.features))
    assert ours[0].features.shape[1:] == (22, 1)
    assert ours[1].positions.shape[0] == min(2000 - skip[0], n_points[1] or 2000)


def test_load_aldp_leaves_out_missing_paths():
    train, valid, test = load_aldp(train_path=H5, train_n_points=5, device="cpu")
    assert valid is None and test is None and train.positions.shape == (5, 22, 3)


@pytest.mark.parametrize("dtype,rtol,step_slack", [("null", 3e-4, 2), ("bfloat16", 3e-2, 4)],
                         ids=["f32", "bf16"])
def test_first_evaluation_matches_jax(monkeypatch, dtype, rtol, step_slack):
    path = str(common.CONFIG_DIR / "aldp.yaml")
    overrides = LOCAL + ["training.eval_plots=false", f"flow.network.compute_dtype={dtype}"]
    cfg, jax_cfg = config.load_config(path, overrides), jax_config.load_config(path, overrides)
    t, net = cfg.training, cfg.flow.network
    assert not t.eval_exact_log_prob and t.hutchinson_probes == 1 and tuple(net.mlp_units) == (4,)
    assert t.eval_batch_size == 2 and t.test_set_size == 8
    probes = np.random.default_rng(5).normal(size=(1, t.eval_batch_size, 22 * 3)).astype(np.float32)
    monkeypatch.setattr(jax_sampling, "_draw_probes",
                        lambda key, B, D, solve_cfg: jnp.asarray(probes))
    monkeypatch.setattr(sampling, "_draw_probes",
                        lambda gen, B, D, solve_cfg, device: torch.from_numpy(probes).to(device))

    def jax_load(train_set_size, test_set_size):
        train, _, test = jax_data.load_aldp(train_path=H5, val_path=H5, test_path=H5,
                                            train_n_points=train_set_size)
        return train, test[:test_set_size]

    jax_tc = jax_setup.setup_training(jax_cfg, jax_load, mesh=get_mesh(jax.devices()[:1]))
    jax_state = jax_tc.init_state(jax.random.PRNGKey(0))
    h, temb = net.n_invariant_feat_hidden, net.time_embedding_dim
    params = slow_time(jax.tree_util.tree_map(np.array, jax.device_get(jax_state.params)), h, temb)
    jax_state = jax_state._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    ref = jax_tc.eval_and_plot_fn(jax_state, jax.random.PRNGKey(1), -1, False, None)

    tc = torch_setup.setup_training(cfg, lambda n_train, n_test: aldp.load_dataset(
        n_train, n_test, True, H5, H5, H5, device="cpu"), device="cpu")
    state = tc.init_state(torch.Generator().manual_seed(0))
    weights = from_flax(params)
    state = state._replace(params={name: weights[name] for name in state.params})
    ours = tc.eval_and_plot_fn(state, torch.Generator().manual_seed(1), -1, False, None)

    assert set(ours) == set(ref) == {"test_log_lik", "test_log_prob_base",
                                     "test_delta_log_lik", "eval_ode_steps"}
    for key in ("test_log_lik", "test_log_prob_base", "test_delta_log_lik"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=rtol, err_msg=key)
    assert abs(float(ours["eval_ode_steps"]) - float(ref["eval_ode_steps"])) <= step_slack


def test_local_entry_point_trains_evaluates_and_saves(tmp_path):
    logger, state = aldp.main([
        "--local", "--device", "cpu", "training.save=true", f"training.save_dir={tmp_path}",
        "training.n_training_iter=3", "training.n_eval=1", "training.n_checkpoints=1",
    ])
    h = logger.history
    assert h["iteration"].count(-1.0) == 1 and h["iteration"].count(2.0) == 4 + 1  # batches, eval
    assert len(h["loss"]) == 3 * 4 and all(np.isfinite(h["loss"]))
    assert len(h["test_log_lik"]) == 2 and all(np.isfinite(h["test_log_lik"]))
    state_dir = tmp_path / "model_checkpoints" / "state_00000002"
    assert (state_dir / "params.npz").exists() and (state_dir / "ema_params.npz").exists()
    plots = sorted(p.name for p in (tmp_path / "plots").iterdir())
    assert plots == ["plot_000_iter_-0000001.svg", "plot_000_iter_00000002.svg"]
    for name in plots:
        root = ET.parse(tmp_path / "plots" / name).getroot()
        labels = [p.get("data-label") for p in root.iter("{http://www.w3.org/2000/svg}path")
                  if p.get("class") == "stairs"]
        assert labels == ["train samples", "flow samples"]
