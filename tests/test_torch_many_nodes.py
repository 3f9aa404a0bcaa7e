"""The structured exact trace past 32 nodes, on the CPU.

The edge kernels take up to 64 nodes (the EGCL and fused-trace kernels
32).  Here the port's normal sampling path at N = 40 (`sample_and_log_prob_cnf`,
exact log q through the structured tangent over the 117 zero-CoM columns,
whose edge chains run their plain versions on the CPU) is held to the
benchmark's plain reference for many nodes, `h100_bench/reference/egnn_columns.py`
(forward-mode autodiff over all 120 identity columns), on the same seeded
weights and x0, in float32: small widths (U = 32, L = 2, one block, hidden
16), B = 2, rk4 at 0.25.  The fused trace and the EGCL route keep refusing
more than 32 nodes on a card; on the CPU they run their plain versions.

Tolerances: x1 within 1e-5 and log q within 1e-4 (absolute; log q is
about -170 here).  Both sides compute in float32 and differ only in the
order of their sums: the structured tangent's algebra against autodiff,
117 columns plus the constant CoM offset against 120, each a sum of O(1)
terms; at N = 5 the benchmark's own test holds the reference so, and a
gap of a tenth of a percent in any column of the trace would show here.
"""
import importlib.util
from pathlib import Path

import torch

from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf

BENCH = Path(__file__).resolve().parent.parent / "h100_bench"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location("h100_bench_" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_structured_exact_route_at_40_nodes_matches_the_reference():
    harness = _load(BENCH / "harness.py")
    reference = _load(BENCH / "reference" / "egnn_columns.py")
    cfg = dict(n_nodes=40, dim=3, n_features=1, sigma_min=0.01, base_scale=1.0,
               mlp_units=[32, 32], n_blocks_egnn=1, n_invariant_feat_hidden=16,
               time_embedding_dim=8, compute_dtype=None)
    gen = torch.Generator().manual_seed(40)
    W = harness.make_weights(reference.param_shapes(cfg), gen, torch.device("cpu"))
    cnf = harness.build_cnf(cfg, torch.device("cpu"))
    cnf.field.load_state_dict(W)
    B, S = 2, 40 * 3
    x0 = harness.remove_mean(torch.randn(B, S, generator=gen), 40, 3)
    features = torch.zeros(B, 40, dtype=torch.int64)
    solve = SolveConfig(use_fixed_step_size=True, step_size=0.25, method="rk4")
    x1, log_q = sample_and_log_prob_cnf(cnf, B, features, cfg=solve, x0=x0)
    r1, r_log_q = reference.sample_and_log_q(W, cfg, x0, features, 4)
    assert (x1 - x0).abs().max() > 0.01  # the field moves the samples
    torch.testing.assert_close(x1, r1, rtol=0, atol=1e-5)
    torch.testing.assert_close(log_q, r_log_q, rtol=0, atol=1e-4)
