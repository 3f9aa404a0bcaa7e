"""The EGCL-forward and fused-trace CUDA kernels against their plain
versions, on a card.

Marked ``gpu``; skipped without a CUDA device.  Imports no JAX, so it runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_fused_gpu.py`` (the suite's conftest imports JAX).
Limits, all f32: the EGCL forward, max |kernel - plain| / max |plain|
1e-4; the fused trace, value rel 1e-4 and the network's share of the
trace, ``div + dim * final_scaling``, rel 1e-4 of its largest magnitude.
"""
import math

import pytest
import torch

from ecnf_tpu_torch import sample
from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.ops import egcl, fused_trace

LIMIT = 1e-4
# (n_nodes, blocks, mlp_units, hidden, batch): small, and LJ13 width.
SHAPES = [(5, 2, (32, 32), 16, 6), (13, 3, (128, 128, 128), 64, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cnf(n, blocks, units, hidden, device, seed=0):
    """A CNF whose Dense kernels are redrawn at N(0, 1/fan_in) and biases at
    N(0, 0.1^2), so the network's share of the trace is O(1)."""
    cnf = build_cnf(
        n_frames=n, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
        n_features=1, device=device, generator=torch.Generator().manual_seed(seed),
    )
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in cnf.field.named_parameters():
            if name.startswith("embed"):
                continue
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return cnf


def _inputs(n, batch, device, seed=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, n * 3), generator=gen).to(device)
    t = torch.linspace(0.1, 0.9, batch, device=device)
    f = torch.zeros((batch, n), dtype=torch.int64, device=device)
    return x, t, f


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("n,blocks,units,hidden,batch", SHAPES)
def test_egcl_kernel_matches_plain_on_cuda(cuda, n, blocks, units, hidden, batch):
    cnf = _cnf(n, blocks, units, hidden, cuda)
    x, t, f = _inputs(n, batch, cuda)
    weights = egcl.egnn_weights(cnf.field.egnn)
    before = egcl.egcl_fused.launch_count
    out = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, weights)
    torch.cuda.synchronize()
    assert egcl.egcl_fused.launch_count == before + blocks
    plain = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, weights, use_kernel=False)
    assert torch.isfinite(out).all()
    assert _rel(out, plain) <= LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("n,blocks,units,hidden,batch", SHAPES)
def test_fused_trace_kernel_matches_plain_on_cuda(cuda, n, blocks, units, hidden, batch):
    cnf = _cnf(n, blocks, units, hidden, cuda)
    x, t, f = _inputs(n, batch, cuda)
    weights = cnf.fused_weights()
    before = fused_trace.egnn_value_and_div_fused.launch_count
    v, d = cnf.fused_value_and_div(x, t, f, weights=weights)
    torch.cuda.synchronize()
    assert fused_trace.egnn_value_and_div_fused.launch_count == before + 1
    v_p, d_p = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, use_kernel=False)
    offset = 3 * cnf.field.egnn.final_scaling.detach()
    net, net_p = d + offset, d_p + offset
    assert net_p.abs().max() > 0.1
    assert _rel(v, v_p) <= LIMIT
    assert _rel(net, net_p) <= LIMIT
    # Other column chunkings change only the order of div's f32 sum.
    for cols in (1, 2):
        v_c, d_c = fused_trace.egnn_value_and_div_fused(
            cnf.field, x, t, f, weights, columns_per_block=cols
        )
        torch.testing.assert_close(v_c, v, rtol=0, atol=0)
        assert _rel(d_c + offset, net) <= LIMIT
    # No float atomics: a second run agrees bit for bit.
    v2, d2 = cnf.fused_value_and_div(x, t, f, weights=weights)
    torch.testing.assert_close(v2, v, rtol=0, atol=0)
    torch.testing.assert_close(d2, d, rtol=0, atol=0)


@pytest.mark.gpu
def test_fused_serving_solve_launches_the_kernel(cuda):
    before = fused_trace.egnn_value_and_div_fused.launch_count
    out = sample.main([
        "--n-nodes", "5", "--n-samples", "6", "--batch-size", "6", "--with-log-prob",
        "--fused-trace", "--method", "rk4", "--n-blocks", "2", "--mlp-units", "32", "32",
        "--hidden", "16", "--device", "cuda",
    ])
    assert fused_trace.egnn_value_and_div_fused.launch_count == before + 80  # 20 steps x 4 stages
    assert torch.isfinite(torch.from_numpy(out["log_q"])).all()
    assert torch.isfinite(torch.from_numpy(out["samples"])).all()


@pytest.mark.gpu
def test_wrappers_reject_bad_arguments(cuda):
    cnf = _cnf(5, 2, (32, 32), 16, cuda)
    x, t, f = _inputs(5, 4, cuda)
    weights = egcl.egnn_weights(cnf.field.egnn)
    h = torch.zeros((4, 5, 16), device=cuda)
    vec = x.reshape(4, 5, 3).contiguous()
    temb = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        egcl.egcl_fused(vec, h, temb, weights.flat[0][:-4], (32, 32))
    with pytest.raises(TypeError):
        egcl.egcl_fused(vec.double(), h, temb, weights.flat[0], (32, 32))
    with pytest.raises(ValueError, match="contiguous"):
        egcl.egcl_fused(vec.transpose(0, 1).contiguous().transpose(0, 1), h, temb, weights.flat[0], (32, 32))
    with pytest.raises(RuntimeError, match="launch failed"):
        # 33 nodes: more than the kernels take.
        big = torch.zeros((1, 33, 3), device=cuda)
        egcl.egcl_fused(big, torch.zeros((1, 33, 16), device=cuda), temb[:1], weights.flat[0], (32, 32))
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, columns_per_block=16)
