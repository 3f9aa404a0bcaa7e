"""The port's programs on two gloo ranks against one process, on the CPU.

- `setup_training` + `run_training` at the DW4 ``--local`` widths in f32
  (`torch_ddp_worker.program_config`: one epoch of 10 steps, evaluations
  at -1 and 0 with the exact trace on fixed rk4 steps, one checkpoint) on
  seeded DW4-shaped data.  The evaluation batch of 9 is rounded up to 10
  on two ranks and its padding masked, and every loss and evaluation
  metric equals the single process's within 1e-5 relative (but
  ``eval_ode_steps``, which depends on the batch size); rank 0 alone
  writes the one checkpoint, once.  That solve is fixed-step because at
  the config's adaptive Dopri5 the two runs' ``test_log_lik`` part by
  ~3e-4 relative: the ranks' batches of 5 and the single process's of 9
  round their products differently, and at rtol 1e-5 such last-bit
  differences flip accept/reject decisions (the band of
  `tests/test_torch_adaptive.py`).
- The config's own adaptive Dopri5 evaluation (at iteration -1): two
  ranks at an evaluation batch of 10, each solving 5 rows, equal one
  process at a batch of 5 (the same groups of rows, as the solver steps
  each sample on its own) within 1e-5 relative.
- ``sample`` (exact and Hutchinson log q) and ``score`` (exact and
  Hutchinson) write the same ``.npy`` on two ranks as on one, within
  1e-5 relative (every rank draws the whole batch and keeps its rows).
- `parallel.dryrun.dryrun_multichip(2)` runs every data-parallel path.
"""
import numpy as np
import pytest
import torch

import torch_ddp_worker as worker
from ecnf_tpu_torch import sample, score
from ecnf_tpu_torch.targets.energies import double_well_log_prob
from ecnf_tpu_torch.training.loop import run_training
from ecnf_tpu_torch.training.setup import setup_training

torch.set_num_threads(1)
RTOL = 1e-5
# ``eval_ode_steps`` is a mean over test batches of each batch's most
# steps, so it moves with the batch size (9 against 10): not compared.
METRICS = ("test_log_lik", "test_log_prob_base", "test_delta_log_lik", "forward_ess")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("programs")
    pos = np.random.default_rng(1).normal(size=(6, 5, 3)).astype(np.float32)
    np.save(d / "frames.npy", pos)
    return d


@pytest.fixture(scope="module")
def ranks(workdir):
    return worker.launch("programs", 2, workdir, dict(score_data=str(workdir / "frames.npy")))


@pytest.fixture(scope="module")
def one_process(workdir):
    logger, state = run_training(setup_training(
        worker.program_config(workdir / "run_w1"), worker.program_dataset, double_well_log_prob,
        device="cpu",
    ))
    return logger.history, state


@pytest.fixture(scope="module")
def one_process_adaptive(workdir):
    return worker.initial_evaluation(worker.program_config(
        workdir / "adaptive_w1", fixed_step=False, eval_batch_size=5))


def _column(history, key):
    return np.asarray(history[key], dtype=np.float64)


def test_two_ranks_train_as_one_process(ranks, one_process):
    history, _ = one_process
    losses = _column(history, "loss")
    assert losses.shape == (10,)
    np.testing.assert_allclose(ranks["history"]["loss"].numpy(), losses, rtol=RTOL)
    for key in ("grad_norm", "update_norm"):
        np.testing.assert_allclose(ranks["history"][key].numpy(), _column(history, key), rtol=RTOL)


@pytest.mark.parametrize("metric", METRICS)
def test_two_ranks_evaluate_as_one_process(ranks, one_process, metric):
    history, _ = one_process
    ref = _column(history, metric)
    assert ref.shape == (2,)  # evaluations at -1 and 0
    np.testing.assert_allclose(ranks["history"][metric].numpy(), ref, rtol=RTOL)


@pytest.mark.parametrize("metric", METRICS)
def test_two_ranks_evaluate_adaptive_as_one_process(ranks, one_process_adaptive, metric):
    ref = float(one_process_adaptive[metric])
    assert np.isfinite(ref)
    np.testing.assert_allclose(ranks["adaptive"][metric].item(), ref, rtol=RTOL)


def test_rank_zero_writes_the_one_checkpoint(ranks, workdir):
    assert ranks["saves"].tolist() == [1, 0]
    written = sorted(p.name for p in (workdir / "run_w2" / "model_checkpoints").iterdir())
    assert written == ["state_00000000"]
    assert "eval_batch_size 9 -> 10 (rounded up to the 2-device mesh)" in ranks["log"]


@pytest.mark.parametrize("tag,extra", [("", ()), ("_approx", ("--approx",))],
                         ids=["exact", "hutchinson"])
def test_sample_and_score_on_two_ranks_write_one_process_files(ranks, workdir, tag, extra):
    sample.main(worker.sample_argv(workdir, "w1" + tag, *extra))
    score.main(worker.score_argv(workdir, workdir / "frames.npy", "w1" + tag, *extra))
    for name in ("x", "q", "p"):
        one, two = (np.load(workdir / f"{name}_{w}{tag}.npy") for w in ("w1", "w2"))
        assert np.isfinite(one).all()
        np.testing.assert_allclose(two, one, rtol=RTOL, atol=1e-6)


def test_dryrun_multichip_on_two_ranks(ranks):
    out = ranks["dryrun"]
    assert np.isfinite([out["loss"], out["loss_mb2"], out["rv_ess"]]).all()
    assert np.isfinite(out["epoch_losses"]).all() and np.shape(out["epoch_losses"]) == (2, 2)
    assert out["trace_err"] <= 1e-4
    assert "dryrun_multichip(2) OK" in ranks["log"]
