"""The check fails what it must: the control (the reference one precision
below the configuration's, in the program's place) and each fault a cell
can have, planted under a run that skips only the look for a card, at a
size the CPU tests can hold.  The program itself passes there."""
import pytest
import torch

from bench_cells import ALL, harness, load_cell, tiny_cell

import calibrate
from ecnf_tpu_torch.cnf import sampling
from ecnf_tpu_torch.training import state

CPU = torch.device("cpu")
SEED = 2**31 + 101
SAMPLING = [w for w in ALL if load_cell(w)["traffic"]["driver"] == "sample"]


def _run(cell) -> dict:
    return harness.run_cell(cell, SEED, 0.0, False, CPU, 0.0)


@pytest.mark.parametrize("workload", ALL)
def test_the_program_passes(workload):
    result = _run(tiny_cell(workload))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("workload", ALL)
def test_the_control_fails(workload):
    # The cell's own node count: the control's gap, like the program's,
    # grows with the nodes that each sample's rounding runs through.
    cell = tiny_cell(workload, n_nodes=load_cell(workload)["config"]["n_nodes"])
    run = harness.driver(cell).Run(cell, harness.reference(cell), SEED, CPU)
    run.window(0.0)
    run.release()
    checks = run.check(control=calibrate.control_precision(cell))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _unchanged(cnf, batch_size, features=None, approx=False, cfg=None, x0=None, eps=None,
               return_stats=False):
    """A solve that returns its state unchanged."""
    out = x0, cnf.log_prob_base(x0)
    return (*out, sampling.ODEStats(0, 0)) if return_stats else out


def _rows_moved(real):
    """A solve whose answers are altered where they are produced: each row
    gets its neighbour's sample and log q."""
    def solve(*args, **kwargs):
        x1, log_q, *rest = real(*args, **kwargs)
        return (x1.roll(1, 0), log_q.roll(1, 0), *rest)
    return solve


@pytest.mark.parametrize("workload", SAMPLING)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_sampling_faults_fail(monkeypatch, workload, fault):
    fake = _unchanged if fault == "unchanged" else _rows_moved(sampling.sample_and_log_prob_cnf)
    monkeypatch.setattr(sampling, "sample_and_log_prob_cnf", fake)
    result = _run(tiny_cell(workload))
    assert not result["correct"], result["checks"]


def _broken_update(make, fault):
    def make_update_fn(*args, **kwargs):
        update = make(*args, **kwargs)

        def broken(st, x, features, x0=None, t=None):
            if fault == "unchanged":
                return st, update(st, x, features, x0=x0, t=t)[1]
            half = x.shape[0] // 2
            return update(st, x[:half], features[:half], x0=x0[:half], t=t[:half])
        return broken
    return make_update_fn


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_fail(monkeypatch, fault):
    monkeypatch.setattr(state, "make_update_fn", _broken_update(state.make_update_fn, fault))
    result = _run(tiny_cell("qm9.train_mb1"))
    assert not result["correct"], result["checks"]


def test_a_window_that_leaves_the_state_unchanged_fails():
    """Set-up's steps sound, the timed window's steps returning their state
    unchanged (a captured step that stopped writing its state back)."""
    cell = tiny_cell("qm9.train_mb1")
    run = harness.driver(cell).Run(cell, harness.reference(cell), SEED, CPU)
    update = run.update
    run.update = lambda st, *args, **kwargs: (st, update(st, *args, **kwargs)[1])
    run.window(0.0)
    run.release()
    checks = run.check()
    assert checks["change_gap"]["value"] <= checks["change_gap"]["limit"], checks
    assert checks["window_change_gap"]["value"] > checks["window_change_gap"]["limit"], checks
