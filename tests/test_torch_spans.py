"""The port's profiler spans (`ecnf_tpu_torch/utils/spans.py`), on the CPU.

With no profiler running, the sampling and training paths enter no
profiler range.  Under `torch.profiler.profile`, a solve is one
``ecnf.solve`` span holding one ``ecnf.field`` span per field evaluation
(rk4 4 a step, fixed Dopri5 1 + 6 a step, adaptive Dopri5 2 + 6 an
attempt) and one ``ecnf.ode.sync`` span per host read of the adaptive
loop; a train step is one ``ecnf.train.step`` span holding each of its
parts once.  `run_training` with ``profile_dir`` writes the step spans into
its Chrome trace.
"""
import json

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import (
    SolveConfig,
    get_log_prob,
    sample_and_log_prob_cnf,
    sample_cnf,
)
from ecnf_tpu_torch.parallel.mesh import get_mesh
from ecnf_tpu_torch.training import loop, optim
from ecnf_tpu_torch.training.loggers import ListLogger
from ecnf_tpu_torch.training.state import init_training_state, make_update_fn
from ecnf_tpu_torch.utils import spans

N, DIM, B = 4, 2, 3
STEP = 0.25  # 4 steps over [0, 1]
TRAIN_CHILDREN = ["ecnf.train.grad", "ecnf.train.optim", "ecnf.train.ema"]


def _cnf():
    return build_cnf(n_frames=N, dim=DIM, sigma_min=1e-3, base_scale=1.0, n_blocks_egnn=1,
                     mlp_units=(8, 8), n_invariant_feat_hidden=8, time_embedding_dim=4,
                     n_features=1, device="cpu", generator=torch.Generator().manual_seed(0))


def _features():
    return torch.zeros((B, N), dtype=torch.int64)


def _spans(prof):
    """The ``ecnf.*`` host ranges of a trace: ``(name, start, end)`` in time order."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("ecnf.")]
    return sorted(out, key=lambda s: s[1])


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _update(cnf, mesh=None):
    opt = optim.build_optimizer(1e-3)
    state = init_training_state(cnf, opt, torch.Generator().manual_seed(1), use_ema=True)
    update = make_update_fn(cnf, opt, use_ema=True, mesh=mesh)
    x = cnf.sample_base((B,), generator=torch.Generator().manual_seed(2))
    return update, state, x


def test_no_profiler_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} was entered with no profiler running")

    monkeypatch.setattr(spans, "record_function", refuse)
    cnf = _cnf()
    cfg = SolveConfig(use_fixed_step_size=True, step_size=STEP, method="rk4")
    x1, log_q = sample_and_log_prob_cnf(cnf, B, _features(), cfg=cfg,
                                        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(log_q).all()
    update, state, x = _update(cnf)
    state, info = update(state, x, _features())
    assert torch.isfinite(info["loss"])


def _solve(entry, cnf, cfg, approx):
    """One call of a public entry of `cnf/sampling.py`; its `ODEStats`
    (None for `sample_cnf`, which returns none)."""
    gen = torch.Generator().manual_seed(0)
    if entry == "sample_cnf":
        sample_cnf(cnf, B, _features(), cfg=cfg, generator=gen)
        return None
    if entry == "get_log_prob":
        x = cnf.sample_base((B,), generator=gen)
        return get_log_prob(cnf, x, _features(), approx=approx, cfg=cfg, generator=gen,
                            return_stats=True)[-1]
    return sample_and_log_prob_cnf(cnf, B, _features(), approx=approx, cfg=cfg, generator=gen,
                                   return_stats=True)[-1]


SOLVES = {
    # name: (entry, solve settings, Hutchinson, field evaluations from the stats)
    "rk4_structured": ("sample_and_log_prob_cnf",
                       dict(use_fixed_step_size=True, step_size=STEP, method="rk4"), False,
                       lambda s: 4 * s.num_attempts),
    "rk4_hutchinson": ("sample_and_log_prob_cnf",
                       dict(use_fixed_step_size=True, step_size=STEP, method="rk4"), True,
                       lambda s: 4 * s.num_attempts),
    "rk4_fused": ("sample_and_log_prob_cnf",
                  dict(use_fixed_step_size=True, step_size=STEP, method="rk4", fused_trace=True),
                  False, lambda s: 4 * s.num_attempts),
    "rk4_jvp": ("get_log_prob",
                dict(use_fixed_step_size=True, step_size=STEP, method="rk4",
                     structured_tangent=False), False, lambda s: 4 * s.num_attempts),
    "rk4_sample_only": ("sample_cnf", dict(use_fixed_step_size=True, step_size=STEP,
                                           method="rk4"), False, None),
    "dopri5_fixed": ("get_log_prob",
                     dict(use_fixed_step_size=True, step_size=STEP, method="dopri5"), False,
                     lambda s: 1 + 6 * s.num_attempts),
    "dopri5_adaptive": ("sample_and_log_prob_cnf", dict(rtol=1e-3, atol=1e-3), False,
                        lambda s: 2 + 6 * s.num_attempts),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_a_solve_is_one_span_holding_a_span_per_field_evaluation(name):
    entry, settings, approx, evals = SOLVES[name]
    cnf = _cnf()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = _solve(entry, cnf, SolveConfig(**settings), approx)
    found = _spans(prof)
    # Plain host ranges: the profiler copies user annotations, and only
    # them, onto the device timeline, where they would pass for operations.
    assert not any(e.is_user_annotation for e in prof.events() if e.name.startswith("ecnf."))
    solves = [s for s in found if s[0] == "ecnf.solve"]
    fields = [s for s in found if s[0] == "ecnf.field"]
    syncs = [s for s in found if s[0] == "ecnf.ode.sync"]
    assert len(solves) == 1
    assert all(_inside(s, solves[0]) for s in fields + syncs)
    assert all(a[2] <= b[1] for a, b in zip(fields, fields[1:]))  # one after another
    n_steps = round(1 / STEP)
    if stats is not None:
        assert len(fields) == evals(stats)
        assert len(syncs) == stats.num_syncs
    if name.startswith("rk4"):
        assert len(fields) == 4 * n_steps and not syncs
    elif name == "dopri5_fixed":
        assert len(fields) == 1 + 6 * n_steps and not syncs
    else:
        assert stats.num_syncs == stats.num_attempts + 2 and stats.num_attempts > 0


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, taken down afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield get_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("meshed", [False, True], ids=["single", "mesh"])
def test_a_train_step_is_one_span_holding_each_part_once(meshed, request):
    mesh = request.getfixturevalue("world_of_one") if meshed else None
    update, state, x = _update(_cnf(), mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        update(state, x, _features())
    found = _spans(prof)
    children = TRAIN_CHILDREN + (["ecnf.train.allreduce"] if meshed else [])
    assert sorted(s[0] for s in found) == sorted(["ecnf.train.step"] + children)
    step = next(s for s in found if s[0] == "ecnf.train.step")
    assert all(_inside(s, step) for s in found)


def test_profile_dir_trace_holds_the_train_step_spans(tmp_path):
    cnf = _cnf()
    opt = optim.build_optimizer(1e-3)
    update = make_update_fn(cnf, opt, use_ema=True)
    x = cnf.sample_base((B,), generator=torch.Generator().manual_seed(2))
    config = loop.TrainConfig(
        n_iteration=4, logger=ListLogger(), seed=0, n_checkpoints=0, n_eval=0,
        init_state=lambda gen: init_training_state(cnf, opt, gen, use_ema=True),
        update_state=lambda state: update(state, x, _features()), eval_and_plot_fn=None,
        save=False, profile_dir=str(tmp_path / "profile"),
    )
    loop.run_training(config)
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e["name"].startswith("ecnf.")]
    # The profiler runs over the first three steps.
    assert sorted(names) == sorted((["ecnf.train.step"] + TRAIN_CHILDREN) * 3)
