"""The EGCL-forward and fused-trace CUDA kernels against their plain
versions, on a card.

Marked ``gpu``; skipped without a CUDA device.  Imports no JAX, so it runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_fused_gpu.py`` (the suite's conftest imports JAX).
Limits, all f32: the EGCL forward, max |kernel - plain| / max |plain|
1e-4; the fused trace, value rel 1e-4 and the network's share of the
trace, ``div + dim * final_scaling``, rel 1e-4 of its largest magnitude.
Both kernels take their dense products on the tensor cores in 3xTF32, in
16-row tiles: the ragged cases put S * N rows (S = columns + 1 slots) that
are not a multiple of 16 through them.  Both kernels also run at the
shipped DW4 (N=4, D=2) and ALDP (N=22, U=64, H=32, per-atom features)
shapes.
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
# The EGCL forward also at QM9 width (19 rows: two row tiles, one ragged).
EGCL_SHAPES = SHAPES + [(19, 2, (256,) * 4, 32, 4)]
# (n_nodes, blocks, mlp_units, hidden, batch, columns with S * N % 16 != 0)
RAGGED = [
    (5, 2, (32, 32), 16, 3, 2),
    (13, 2, (128, 128, 128), 64, 3, 8),
    (19, 2, (256,) * 4, 32, 2, 4),
]


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
@pytest.mark.parametrize("n,blocks,units,hidden,batch", EGCL_SHAPES)
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


def _largest_columns(cnf, x, t, f, weights):
    """The most columns per thread block that the kernel launches with."""
    for cols in range(x.shape[1], 0, -1):
        try:
            fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, columns_per_block=cols)
        except RuntimeError:
            continue
        return cols
    raise AssertionError("no column count launches")


@pytest.mark.gpu
@pytest.mark.parametrize("n,blocks,units,hidden,batch,ragged", RAGGED)
def test_fused_trace_ragged_rows_and_chunkings(cuda, n, blocks, units, hidden, batch, ragged):
    assert (ragged + 1) * n % 16 != 0
    cnf = _cnf(n, blocks, units, hidden, cuda, seed=n)
    x, t, f = _inputs(n, batch, cuda, seed=n + 1)
    weights = cnf.fused_weights()
    v_p, d_p = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, use_kernel=False)
    offset = 3 * cnf.field.egnn.final_scaling.detach()
    default = fused_trace.default_columns(0, batch, n, 3, hidden, 8, units[0])
    largest = _largest_columns(cnf, x, t, f, weights)
    assert largest >= max(default, ragged)
    v, d = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, columns_per_block=1)
    torch.cuda.synchronize()
    assert _rel(v, v_p) <= LIMIT
    assert _rel(d + offset, d_p + offset) <= LIMIT
    for cols in (default, largest, ragged):
        v_c, d_c = fused_trace.egnn_value_and_div_fused(
            cnf.field, x, t, f, weights, columns_per_block=cols
        )
        torch.cuda.synchronize()
        torch.testing.assert_close(v_c, v, rtol=0, atol=0)
        assert _rel(d_c + offset, d + offset) <= LIMIT
        assert _rel(d_c + offset, d_p + offset) <= LIMIT
        # Deterministic: a second run agrees bit for bit.
        v2, d2 = fused_trace.egnn_value_and_div_fused(
            cnf.field, x, t, f, weights, columns_per_block=cols
        )
        torch.testing.assert_close(v2, v_c, rtol=0, atol=0)
        torch.testing.assert_close(d2, d_c, rtol=0, atol=0)


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


# Shipped configurations (`examples/configs/`): (name, n_nodes, dim,
# n_blocks, mlp_units, hidden, features "zeros" or "arange").
SHIPPED = [
    ("dw4", 4, 2, 3, (128, 128, 128), 64, "zeros"),
    ("aldp", 22, 3, 3, (64, 64), 32, "arange"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,dim,blocks,units,hidden,features", SHIPPED,
                         ids=[s[0] for s in SHIPPED])
def test_kernels_at_shipped_shapes(cuda, name, n, dim, blocks, units, hidden, features):
    cnf = build_cnf(
        n_frames=n, dim=dim, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
        n_features=n if features == "arange" else 1, device=cuda,
        generator=torch.Generator().manual_seed(0),
    )
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, p in cnf.field.named_parameters():
            if pname.startswith("embed"):
                continue
            if pname.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
            elif pname.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    batch = 5
    x = torch.randn((batch, n * dim), generator=gen).to(cuda)
    t = torch.linspace(0.1, 0.9, batch, device=cuda)
    row = torch.arange(n) if features == "arange" else torch.zeros(n, dtype=torch.int64)
    f = row.repeat(batch, 1).to(cuda)

    weights = egcl.egnn_weights(cnf.field.egnn)
    before = egcl.egcl_fused.launch_count
    out = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, weights)
    assert egcl.egcl_fused.launch_count == before + blocks
    plain = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, weights, use_kernel=False)
    assert torch.isfinite(out).all()
    assert _rel(out, plain) <= LIMIT

    fused_w = cnf.fused_weights()
    before = fused_trace.egnn_value_and_div_fused.launch_count
    v, d = cnf.fused_value_and_div(x, t, f, weights=fused_w)
    assert fused_trace.egnn_value_and_div_fused.launch_count == before + 1
    v_p, d_p = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, fused_w, use_kernel=False)
    offset = dim * cnf.field.egnn.final_scaling.detach()
    assert (d_p + offset).abs().max() > 0.1
    assert _rel(v, v_p) <= LIMIT
    assert _rel(d + offset, d_p + offset) <= LIMIT


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
