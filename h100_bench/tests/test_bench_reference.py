"""The plain reference against the program's plain routes, on the CPU at a
small size, on the same weights and inputs, all in float32."""

import pytest
import torch

from bench_cells import harness, load_cell

TINY = dict(n_nodes=5, mlp_units=[32, 32], n_blocks_egnn=2, n_invariant_feat_hidden=16)


def tiny_cell(workload):
    cell = load_cell(workload)
    cell["config"].update(TINY)
    return cell

from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf
from ecnf_tpu_torch.training import optim, state

CPU = torch.device("cpu")



@pytest.mark.parametrize("workload,route", [
    ("lj13.sample_exact_rk4", "exact"), ("lj13.sample_fused_rk4", "fused"),
    ("qm9.sample_hutch1_rk4", "hutchinson"),
])
def test_samples_and_log_q_match_the_program(workload, route):
    cell = tiny_cell(workload)
    cfg, ref = cell["config"], harness.reference(cell)
    gen = torch.Generator().manual_seed(7)
    W = harness.make_weights(ref.param_shapes(cfg), gen, CPU)
    cnf = harness.build_cnf(cfg, CPU, compute_dtype=None)
    cnf.field.load_state_dict(W)
    B, S = 6, cfg["n_nodes"] * cfg["dim"]
    x0 = cfg["base_scale"] * harness.remove_mean(torch.randn(B, S, generator=gen), cfg["n_nodes"], 3)
    eps = torch.randn(B, S, generator=gen) if route == "hutchinson" else None
    feats = torch.zeros(B, cfg["n_nodes"], dtype=torch.int64)
    solve = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4",
                        fused_trace=route == "fused")
    x1, log_q = sample_and_log_prob_cnf(cnf, B, feats, approx=eps is not None, cfg=solve, x0=x0,
                                        eps=eps)
    r1, r_log_q = ref.sample_and_log_q(W, cfg, x0, feats, 20, probes=eps)
    torch.testing.assert_close(x1, r1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(log_q, r_log_q, rtol=1e-5, atol=1e-4)


def test_training_steps_match_the_program():
    cell = tiny_cell("qm9.train_mb1")
    cfg, ref = cell["config"], harness.reference(cell)
    gen = torch.Generator().manual_seed(8)
    W = harness.make_weights(ref.param_shapes(cfg), gen, CPU)
    cnf = harness.build_cnf(cfg, CPU, compute_dtype=None)
    cnf.field.load_state_dict(W)
    B, S, N = 6, cfg["n_nodes"] * cfg["dim"], cfg["n_nodes"]
    feeds = [dict(x=harness.remove_mean(1.5 * torch.randn(B, S, generator=gen), N, 3),
                  x0=2.0 * harness.remove_mean(torch.randn(B, S, generator=gen), N, 3),
                  t=torch.rand(B, generator=gen), features=torch.zeros(B, N, dtype=torch.int64))
             for _ in range(3)]
    opt = optim.build_optimizer(cfg["init_lr"], use_schedule=True, peak_lr=cfg["peak_lr"],
                                end_lr=cfg["end_lr"], n_iter_warmup=cfg["n_iter_warmup"],
                                n_iter_total=cfg["n_training_iter"])
    update = state.make_update_fn(cnf, opt, use_ema=True)
    st = state.init_training_state(cnf, opt, torch.Generator().manual_seed(0), use_ema=True)
    steps = ref.train(W, cfg, feeds)
    for feed, r in zip(feeds, steps):
        st, info = update(st, feed["x"], feed["features"], x0=feed["x0"], t=feed["t"])
        assert info["loss"].item() == pytest.approx(r["loss"], rel=1e-5)
    for name in W:
        torch.testing.assert_close(st.params[name], steps[-1]["params"][name], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(st.ema_params[name], steps[-1]["ema"][name], rtol=1e-5, atol=1e-8)


def test_the_controls_round_every_product():
    cell = tiny_cell("lj13.sample_exact_rk4")
    cfg, ref = cell["config"], harness.reference(cell)
    gen = torch.Generator().manual_seed(9)
    W = harness.make_weights(ref.param_shapes(cfg), gen, CPU)
    x = torch.randn(4, cfg["n_nodes"] * 3, generator=gen)
    t, f = torch.rand(4, generator=gen), torch.zeros(4, cfg["n_nodes"], dtype=torch.int64)
    exact = ref.field_and_divergence(W, cfg, x, t, f)
    for precision, low, high in (("tf32", 1e-6, 1e-2), ("fp8", 1e-3, 1.0)):
        v, div = ref.field_and_divergence(W, cfg, x, t, f, precision=precision)
        gap = (div - exact[1]).abs().max() / exact[1].abs().max()
        assert low < gap < high, (precision, gap)
        assert low / 10 < (v - exact[0]).abs().max() / exact[0].abs().max() < high
