"""The frozen FLOP formulas against the program's matmul counter
(`ops/flops.py: count_fn_flops`) on its plain routes, at the cells' own
widths and a batch of 2, bucket by bucket."""

import pytest
import torch

from bench_cells import ALL, harness, load_cell

from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf
from ecnf_tpu_torch.ops.edge_tangent import edge_tangent_reference
from ecnf_tpu_torch.ops.flops import count_fn_flops
from ecnf_tpu_torch.training import optim, state

B = 2
work = harness.load_module(harness.HERE / "work" / "egnn.py")



@pytest.mark.parametrize("workload", [w for w in ALL if load_cell(w)["traffic"]["driver"] == "sample"])
def test_field_evaluation_formula_equals_the_count(workload):
    cell = load_cell(workload)
    cfg, traffic = cell["config"], cell["traffic"]
    cnf = harness.build_cnf(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    S = cfg["n_nodes"] * cfg["dim"]
    x0 = cnf.sample_base((B,), generator=torch.Generator().manual_seed(1))
    eps = torch.randn(B, S) if traffic["trace"] == "hutchinson" else None
    solve = SolveConfig(use_fixed_step_size=True, step_size=1.0, method="rk4",
                        fused_trace=traffic["trace"] == "fused")
    feats = torch.zeros(B, cfg["n_nodes"], dtype=torch.int64)
    count = count_fn_flops(lambda: sample_and_log_prob_cnf(
        cnf, B, feats, approx=eps is not None, cfg=solve, x0=x0, eps=eps))
    bf16, f32 = work.field_eval_flops(cfg, B, *work.sample_route(cfg, traffic))
    assert (count.bf16, count.f32) == (4 * bf16, 4 * f32)  # one rk4 step, four evaluations


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N,U,L", [(36, 13, 128, 3), (1, 19, 256, 4)])
def test_edge_chain_formula_equals_the_count(K, N, U, L, dtype):
    g = torch.Generator().manual_seed(2)
    r = lambda *s: torch.randn(s, generator=g).to(dtype)
    args = (r(K, B, N, U), r(K, B, N, U), torch.randn(K, B, N, N),
            [r(B, N, N, U) for _ in range(L)], [r(B, N, N, U) for _ in range(L)], r(B, N, N, U),
            r(B, N, N), r(B, N, N), r(U), [r(U, U) for _ in range(L - 1)],
            [r(U, U) for _ in range(L)], r(U), r(U))
    count = count_fn_flops(edge_tangent_reference, *args)
    assert (count.bf16, count.f32) == work.edge_chain_flops(K, B, N, U, L, dtype == torch.bfloat16)


def test_train_step_formula_equals_the_count():
    cell = load_cell("qm9.train_mb1")
    cfg = cell["config"]
    cnf = harness.build_cnf(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    opt = optim.build_optimizer(1e-4)
    st = state.init_training_state(cnf, opt, torch.Generator().manual_seed(0), use_ema=True)
    update = state.make_update_fn(cnf, opt, use_ema=True, microbatch=cell["traffic"]["microbatch"])
    S = cfg["n_nodes"] * cfg["dim"]
    count = count_fn_flops(update, st, torch.randn(B, S), torch.zeros(B, cfg["n_nodes"], dtype=torch.int64))
    assert (count.bf16, count.f32) == work.train_step_flops(cfg, B)
    # The step at the cell's batch is the 1.3116 TFLOP that the program's count gives.
    assert sum(work.train_step_flops(cfg, 256)) == pytest.approx(1.3116e12, rel=1e-4)
