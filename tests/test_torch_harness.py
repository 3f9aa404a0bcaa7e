"""The port's training harness against the JAX package: loggers,
checkpoints, the schedules and `run_training`'s sequence of logged rows,
evaluations, checkpoints and runtime-limit stop; and resume, which must
continue exactly as an uninterrupted run (bit for bit on the CPU)."""
import types

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ecnf_tpu.training import checkpoints as jax_ckpt
from ecnf_tpu.training import loggers as jax_loggers
from ecnf_tpu.training import loop as jax_loop
from ecnf_tpu_torch.targets.data import FullGraphSample
from ecnf_tpu_torch.training import checkpoints, loggers, loop
from ecnf_tpu_torch.training.config import load_config
from ecnf_tpu_torch.training.setup import setup_training

torch.set_num_threads(1)

ROWS = [
    {"loss": 1.5, "iteration": 0},
    {"loss": np.float32(1.25), "grad_norm": 3.0, "iteration": 0},
    {"test_log_lik": -2.0, "forward_ess": float("nan"), "iteration": 1},
    {"loss": 1.0, "iteration": 1},
    {"loss": 0.75, "iteration": 2},
    {"loss": 0.5, "update_norm": 1e-5, "iteration": 2},
    {"loss": 0.25, "iteration": 3},
]


def _torch_row(row):
    """The row as the port's loop writes it: f32 tensors."""
    return {k: torch.tensor(v, dtype=torch.float32) if k != "iteration" else v
            for k, v in row.items()}


def _jax_row(row):
    """The row as the JAX loop writes it: f32 arrays."""
    return {k: np.float32(v) if k != "iteration" else v for k, v in row.items()}


def test_list_logger_history_equals_jax():
    ours, ref = loggers.ListLogger(), jax_loggers.ListLogger()
    for row in ROWS:
        ours.write(_torch_row(row))
        ref.write(_jax_row(row))
    assert ours.history.keys() == ref.history.keys()
    for k in ref.history:
        np.testing.assert_array_equal(ours.history[k], ref.history[k])


@pytest.mark.parametrize("save_period", [1, 3, 100])
def test_csv_logger_file_equals_pandas(tmp_path, save_period):
    """Both loggers' files, as pandas reads them, are equal; also after
    reopening each file and writing more rows (resume)."""
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    for rows in (ROWS, ROWS[2:5]):
        ours = loggers.CSVLogger(save_path=str(ours_dir), save_period=save_period)
        ref = jax_loggers.CSVLogger(save_path=str(ref_dir), save_period=save_period)
        for row in rows:
            ours.write(_torch_row(row))
            ref.write(_jax_row(row))
        ours.close()
        ref.close()
        a = pd.read_csv(ours_dir / "logging_history.csv", index_col=0)
        b = pd.read_csv(ref_dir / "logging_history.csv", index_col=0)
        pd.testing.assert_frame_equal(a, b)
    assert len(a) == len(ROWS) + 3


def test_setup_logger_selects_as_jax(tmp_path):
    for cfg in ({"list_logger": None}, None, {"csv_logger": {"save_period": 5}},
                {"pandas_logger": None}, {"wandb": {"project": "x"}}):
        ours = loggers.setup_logger(cfg, save_dir=str(tmp_path))
        ref = jax_loggers.setup_logger(cfg, save_dir=str(tmp_path))
        assert type(ours).__name__ == type(ref).__name__
    with pytest.raises(ValueError, match="No logger"):
        loggers.setup_logger({"other": None})


@pytest.mark.parametrize("n_iteration", [1, 2, 3, 10, 17, 200, 16000])
@pytest.mark.parametrize("n_points", [1, 2, 4, 5, 10])
def test_schedule_equals_jax(n_iteration, n_points):
    np.testing.assert_array_equal(loop._schedule(n_iteration, n_points),
                                  jax_loop._schedule(n_iteration, n_points))


def test_latest_and_parse_as_jax(tmp_path):
    assert checkpoints.get_latest_checkpoint(str(tmp_path / "missing")) is None
    assert checkpoints.get_latest_checkpoint(str(tmp_path)) is None
    for i in (3, 10, 7):
        (tmp_path / ("state_%08i" % i)).mkdir()
    (tmp_path / "other").mkdir()
    latest = checkpoints.get_latest_checkpoint(str(tmp_path))
    assert latest == jax_ckpt.get_latest_checkpoint(str(tmp_path))
    assert checkpoints.parse_checkpoint_iteration(latest) == 10
    assert checkpoints.checkpoint_path("d", 7) == jax_ckpt.checkpoint_path("d", 7)
    with pytest.raises(ValueError, match="cannot parse"):
        checkpoints.parse_checkpoint_iteration(str(tmp_path / "other"))


# -- A small DW4-shaped experiment on synthetic data, f32, on the CPU. -----

def _dataset(n_train=16, n_test=9):
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.normal(size=(n_train + n_test, 4, 2)).astype(np.float32) * 2)
    feats = torch.zeros((n_train + n_test, 4, 1), dtype=torch.int32)
    return FullGraphSample(pos[:n_train], feats[:n_train]), FullGraphSample(pos[n_train:], feats[n_train:])


def _train_config(save_dir, n_iter=4, use_ema=True, extra=()):
    cfg = load_config(None, [
        "training.batch_size=8", "training.train_set_size=16", "training.test_set_size=9",
        "flow.network.mlp_units=[16]", "flow.network.n_blocks_egnn=2",
        "flow.network.n_invariant_feat_hidden=8", "flow.network.time_embedding_dim=6",
        f"training.n_training_iter={n_iter}", f"training.n_checkpoints={n_iter}",
        f"training.use_ema={str(use_ema).lower()}", "training.eval_plots=false",
        "training.optimizer.n_iter_warmup=3", "training.optimizer.peak_lr=1e-3",
        f"training.save_dir={save_dir}", *extra,
    ])
    train, test = _dataset()
    tc = setup_training(cfg, lambda n_train, n_test: (train, test), device="cpu")
    return tc._replace(eval_and_plot_fn=None)


def _assert_states_equal(a, b):
    for x, y in ((a.params, b.params), (a.ema_params, b.ema_params)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), k
    assert a.opt_state.count == b.opt_state.count
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_round_trip(tmp_path):
    tc = _train_config(tmp_path / "run")
    gen = torch.Generator().manual_seed(0)
    state, _ = tc.update_state(tc.init_state(gen))
    path = checkpoints.save_checkpoint(str(tmp_path / "ck"), 5, state)
    assert path.endswith("state_00000005")
    target = tc.init_state(torch.Generator().manual_seed(1))
    restored = checkpoints.restore_checkpoint(path, target)
    _assert_states_equal(restored, state)
    # numpy alone reads the parameters, under flax paths.
    with np.load(f"{path}/params.npz") as npz:
        assert "params/EGNN_0/final_scaling" in npz.files
    serving = checkpoints.restore_serving_params(path, ema=True)
    for k, v in state.ema_params.items():
        assert torch.equal(serving[k], v)


def test_serving_ema_without_ema_raises(tmp_path):
    tc = _train_config(tmp_path / "run", use_ema=False)
    state = tc.init_state(torch.Generator().manual_seed(0))
    path = checkpoints.save_checkpoint(str(tmp_path / "ck"), 0, state)
    assert set(checkpoints.restore_serving_params(path)) == set(state.params)
    with pytest.raises(ValueError, match="no EMA"):
        checkpoints.restore_serving_params(path, ema=True)


class _Interrupted(Exception):
    pass


def test_resume_equals_uninterrupted_run(tmp_path):
    """4 iterations straight equal 2, an interruption, and a resumed 2, bit
    for bit: parameters, EMA, Adam moments and count, the generator, and
    the logged losses."""
    straight = _train_config(tmp_path / "straight")
    logger, final = loop.run_training(straight)

    interrupted = _train_config(tmp_path / "resumed")
    calls = []

    def update_then_stop(state):
        if len(calls) == 2:
            raise _Interrupted
        calls.append(1)
        return interrupted.update_state(state)

    with pytest.raises(_Interrupted):
        loop.run_training(interrupted._replace(update_state=update_then_stop))
    resumed = _train_config(tmp_path / "resumed", extra=["training.resume=true"])
    r_logger, r_final = loop.run_training(resumed)
    _assert_states_equal(r_final, final)
    assert r_logger.history["iteration"] == [2.0] * 2 + [3.0] * 2
    assert r_logger.history["loss"] == logger.history["loss"][4:]


def _stub_pair(n_batches=3, eval_fn=True):
    """A JAX and a port `TrainConfig` with the same stub state and infos."""
    def jax_update(state):
        return state + 1, {"loss": np.arange(n_batches, dtype=np.float32) + state,
                           "aux": np.ones(n_batches, np.float32)}

    def torch_update(state):
        return state + 1, {"loss": torch.arange(n_batches, dtype=torch.float32) + state,
                           "aux": torch.ones(n_batches)}

    def evaluation(state, key, iteration_n, save, plots_dir):
        return {"metric": np.asarray(float(state) * 10)}

    common = dict(logger=None, seed=0, n_iteration=1, n_checkpoints=1, n_eval=1,
                  eval_and_plot_fn=evaluation if eval_fn else None)
    jax_tc = jax_loop.TrainConfig(init_state=lambda key: jnp.asarray(0), update_state=jax_update,
                                  **common)
    tc = loop.TrainConfig(init_state=lambda gen: 0, update_state=torch_update, **common)
    return jax_tc, tc


@pytest.mark.parametrize("n_iteration,n_eval", [(5, 2), (3, 1), (8, 8)])
def test_run_training_logs_as_jax(n_iteration, n_eval):
    jax_tc, tc = _stub_pair()
    kw = dict(n_iteration=n_iteration, n_eval=n_eval, n_checkpoints=2, save=False)
    ref, _ = jax_loop.run_training(jax_tc._replace(logger=jax_loggers.ListLogger(), **kw))
    ours, state = loop.run_training(tc._replace(logger=loggers.ListLogger(), **kw))
    assert state == n_iteration
    assert ours.history.keys() == ref.history.keys()
    for k in ref.history:
        np.testing.assert_array_equal(ours.history[k], ref.history[k], err_msg=k)


def test_runtime_limit_stops_as_jax(tmp_path, monkeypatch):
    """A clock that advances 0.1 h per epoch: both loops stop at the same
    checkpoint, having logged the same rows."""
    histories, saved = {}, {}
    for name, module, logs in (("jax", jax_loop, jax_loggers), ("torch", loop, loggers)):
        epochs, saved[name] = [0], []
        monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda e=epochs: 360.0 * e[0]))
        monkeypatch.setattr(module, "save_checkpoint", lambda d, i, s, out=saved[name]: out.append(i))
        tc = _stub_pair(eval_fn=False)[0 if name == "jax" else 1]

        def counted(state, update=tc.update_state, epochs=epochs):
            epochs[0] += 1
            return update(state)

        histories[name] = module.run_training(tc._replace(
            logger=logs.ListLogger(), update_state=counted, n_iteration=20, n_eval=1,
            n_checkpoints=5, save=True, save_dir=str(tmp_path / name), runtime_limit=1.0,
        ))[0].history
    assert saved["jax"] == saved["torch"] == [3, 7]
    assert histories["jax"]["iteration"] == histories["torch"]["iteration"]
    assert max(histories["torch"]["iteration"]) == 7
