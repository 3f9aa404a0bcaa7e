"""The edge-tangent CUDA kernel against its plain version, on a card.

Marked ``gpu``; skipped without a CUDA device.  Imports no JAX, so it runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_edge_tangent_gpu.py`` (the suite's conftest imports JAX).
Limits: the kernel's outputs, max |kernel - plain| / max |plain| 1e-4 in
float32 and 1e-2 in bfloat16; the whole trace at LJ13 widths and at the
shipped DW4 (N=4, D=2) and ALDP (N=22, U=64, H=32, per-atom features)
shapes, ``div - offset`` rtol 1e-4 / atol 1e-5 in float32 and 3e-2 of its
largest magnitude in bfloat16, and so the Hutchinson route's per-sample
probes (4 per sample) at QM9 width.  The field value (and x1 of a solve)
is bit for bit in float32, where both routes share the primal; in bfloat16
the kernel route's primal runs the `edge_primal` kernel, whose phi_x output
and sender sum add in their own order (phi may land one bf16 step from the
plain version's), so the value is held within ``VALUE_BAND`` of its
largest magnitude.  A thread block takes C tangent columns of one
(receiver, sample) as C * N rows in 16-row tensor-core tiles: the chunking
cases put ragged row counts (C * N % 16 != 0), a K that C does not divide,
and C = 1, the default and the largest C that launches through it.  Widths
the kernel does not take (U = 4, 16, 100) go through its zero-padding.
Past 32 nodes (N = 33, 55, 64) the kernel is held to its plain version at
the same limits, and the cost model's picks at the LJ13 and QM9 shapes are
pinned.
"""
import pytest
import torch

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.ops import edge_tangent as et
from ecnf_tpu_torch.ops.edge_primal import edge_primal
from torch_edge_inputs import edge_inputs, torch_args


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


LIMITS = [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)]


def _check(out, ref, limit):
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        assert ((o - r).abs().max() / r.abs().max()).item() <= limit


def _largest_columns(dtype, K, B, N, U, L):
    cols = 0
    for c in range(1, K + 1):
        try:
            et.launch_plan(0, dtype, K, B, N, U, L, c)
        except ValueError:
            break
        cols = c
    return cols


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", LIMITS)
@pytest.mark.parametrize("K,B,N,U,L", [(3, 4, 5, 32, 2), (36, 8, 13, 128, 3), (4, 4, 19, 256, 4)])
def test_kernel_matches_plain_on_cuda(cuda, K, B, N, U, L, dtype, limit):
    args = torch_args(edge_inputs(K, B, N, U, L, seed=1), dtype, cuda)
    before = et.edge_tangent.launch_count
    out = et.edge_tangent(**args)
    torch.cuda.synchronize()
    assert et.edge_tangent.launch_count == before + 1
    _check(out, et.edge_tangent_reference(**args), limit)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", LIMITS)
@pytest.mark.parametrize("K,B,N,U,L", [(2, 8, 5, 16, 2), (1, 4, 22, 4, 1), (36, 4, 13, 16, 2),
                                       (3, 2, 19, 100, 2)])
def test_padded_width_matches_plain_on_cuda(cuda, K, B, N, U, L, dtype, limit):
    # A width the kernel does not take (the `--local` widths 4 and 16) is
    # zero-padded to the next it takes; held to the plain version at U.
    args = torch_args(edge_inputs(K, B, N, U, L, seed=5), dtype, cuda)
    before = et.edge_tangent.launch_count
    out = et.edge_tangent(**args)
    torch.cuda.synchronize()
    assert et.edge_tangent.launch_count == before + 1
    assert out[1].shape == (K, B, N, U)
    _check(out, et.edge_tangent_reference(**args), limit)


# (K, B, N, U, L, C): C * N % 16 != 0 at N = 5, 13 and 19, and a K that C
# does not divide.
RAGGED = [(7, 3, 5, 32, 2, 3), (7, 2, 13, 128, 3, 2), (5, 2, 19, 256, 4, 2), (7, 2, 13, 64, 1, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", LIMITS)
@pytest.mark.parametrize("K,B,N,U,L,C", RAGGED)
def test_ragged_rows_and_columns_match_plain(cuda, K, B, N, U, L, C, dtype, limit):
    assert (C * N) % 16 != 0 and K % C != 0
    args = torch_args(edge_inputs(K, B, N, U, L, seed=4), dtype, cuda)
    out = et.edge_tangent(**args, columns_per_block=C)
    _check(out, et.edge_tangent_reference(**args), limit)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", LIMITS)
@pytest.mark.parametrize("K,B,N,U,L", [(36, 3, 13, 128, 3), (54, 2, 19, 256, 4)])
def test_chunkings_agree(cuda, K, B, N, U, L, dtype, limit):
    # C = 1, the default and the largest C that launches: each within the
    # limit of the plain version and of the default chunking.
    args = torch_args(edge_inputs(K, B, N, U, L, seed=5), dtype, cuda)
    ref = et.edge_tangent_reference(**args)
    default = et.default_columns(0, dtype, K, B, N, U, L)
    largest = _largest_columns(dtype, K, B, N, U, L)
    assert 1 <= default <= largest
    base = et.edge_tangent(**args, columns_per_block=default)
    _check(base, ref, limit)
    for cols in sorted({1, largest}):
        out = et.edge_tangent(**args, columns_per_block=cols)
        _check(out, ref, limit)
        _check(out, base, limit)


# Past the 32 nodes of the EGCL and fused-trace kernels (up to 64): a
# column's N sender rows span three or four 16-row tiles.  LJ55's widths at
# N = 55; a K that the default C does not divide.
MANY_NODES = [(9, 2, 33, 64, 2), (13, 2, 55, 128, 3), (6, 2, 64, 128, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", LIMITS)
@pytest.mark.parametrize("K,B,N,U,L", MANY_NODES)
def test_more_than_32_nodes_match_plain(cuda, K, B, N, U, L, dtype, limit):
    # C = 1, the default and the largest C that launches.
    args = torch_args(edge_inputs(K, B, N, U, L, seed=8), dtype, cuda)
    ref = et.edge_tangent_reference(**args)
    default = et.default_columns(0, dtype, K, B, N, U, L)
    largest = _largest_columns(dtype, K, B, N, U, L)
    assert 1 <= default <= largest
    for cols in sorted({1, default, largest}):
        before = et.edge_tangent.launch_count
        out = et.edge_tangent(**args, columns_per_block=cols)
        assert et.edge_tangent.launch_count == before + 1
        _check(out, ref, limit)


@pytest.mark.gpu
def test_64_nodes_at_the_widest_units(cuda):
    # bf16 takes U = 256 at N = 64; float32 does not (at 4 row tiles a
    # column the 3xTF32 pass would need 4 row tiles a warp, past its 3).
    K, B, N, U, L = 3, 2, 64, 256, 2
    args = torch_args(edge_inputs(K, B, N, U, L, seed=9), torch.bfloat16, cuda)
    _check(et.edge_tangent(**args), et.edge_tangent_reference(**args), 1e-2)
    with pytest.raises(ValueError, match="unsupported shapes"):
        et.default_columns(0, torch.float32, K, B, N, U, L)
    with pytest.raises(ValueError, match="unsupported N"):
        et.edge_tangent(**torch_args(edge_inputs(1, 1, 65, 32, 1, seed=9), torch.bfloat16, cuda))


# The cost model's picks and plans at the LJ13 (K=36, B=48) and QM9 (K=54,
# B=64) shapes of `chip_smoke.py`'s phase 3, as they were while the kernel
# took at most 32 nodes: taking more left them as they are.
PLANS = [
    (torch.bfloat16, (36, 48, 13, 128, 3), 18, (211072, 1, 4, 0)),
    (torch.float32, (36, 48, 13, 128, 3), 7, (99328, 2, 3, 0)),
    (torch.bfloat16, (54, 64, 19, 256, 4), 5, (191104, 1, 3, 0)),
    (torch.float32, (54, 64, 19, 256, 4), 2, (89856, 2, 3, 0)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,cols,plan", PLANS, ids=["lj13-bf16", "lj13-f32",
                                                             "qm9-bf16", "qm9-f32"])
def test_plans_up_to_32_nodes_are_pinned(cuda, dtype, shape, cols, plan):
    assert et.default_columns(0, dtype, *shape) == cols
    got = et.launch_plan(0, dtype, *shape, cols)
    assert (got["smem_bytes"], got["blocks_per_sm"], got["row_tiles"], got["staged"]) == plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeat_runs_agree_bit_for_bit(cuda, dtype):
    args = torch_args(edge_inputs(36, 4, 13, 128, 3, seed=6), dtype, cuda)
    first = et.edge_tangent(**args)
    for _ in range(2):
        again = et.edge_tangent(**args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_columns_per_block_rejected_outside_range(cuda, dtype):
    K, B, N, U, L = 36, 2, 13, 128, 3
    args = torch_args(edge_inputs(K, B, N, U, L, seed=7), dtype, cuda)
    before = et.edge_tangent.launch_count
    for cols in (0, -2):
        with pytest.raises(ValueError, match="columns_per_block"):
            et.edge_tangent(**args, columns_per_block=cols)
    largest = _largest_columns(dtype, K, B, N, U, L)
    for cols in (largest + 1, K + 1):
        with pytest.raises(RuntimeError, match="launch failed"):
            et.edge_tangent(**args, columns_per_block=cols)
    assert et.edge_tangent.launch_count == before


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16"])
def test_trace_through_kernel_matches_plain_on_cuda(cuda, cdt):
    # LJ13 widths, weights redrawn at N(0, 1/fan_in) so div - offset is O(1).
    cnf = build_cnf(
        n_frames=13, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=3,
        mlp_units=(128, 128, 128), n_invariant_feat_hidden=64,
        time_embedding_dim=8, n_features=1, compute_dtype=cdt, device=cuda,
        generator=torch.Generator().manual_seed(0),
    )
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cnf.field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
    x = torch.randn((8, 39), generator=gen).to(cuda)
    t = torch.linspace(0.1, 0.9, 8, device=cuda)
    f = torch.zeros((8, 13), dtype=torch.int64, device=cuda)
    basis, offset = cnf.exact_trace_plan()
    before = et.edge_tangent.launch_count
    v_k, d_k = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset)
    assert et.edge_tangent.launch_count == before + 3
    v_p, d_p = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset, use_kernel=False)
    d_k, d_p = d_k - offset, d_p - offset
    assert d_p.abs().max() > 0.1
    _value_band(v_k, v_p, cdt)
    if cdt is None:
        torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=1e-5)
    else:
        assert (d_k - d_p).abs().max() <= 3e-2 * d_p.abs().max()


# Shipped configurations (`examples/configs/`): (name, n_nodes, dim,
# n_blocks, mlp_units, hidden, features "zeros" or "arange").
SHIPPED = [
    ("dw4", 4, 2, 3, (128, 128, 128), 64, "zeros"),
    ("aldp", 22, 3, 3, (64, 64), 32, "arange"),
]


def _shipped_cnf(n, dim, blocks, units, hidden, features, cdt, device, batch, seed=0):
    """A CNF of a shipped configuration with its Dense kernels redrawn at
    N(0, 1/fan_in), and inputs ``x``, ``t``, ``f`` of ``batch`` samples."""
    cnf = build_cnf(
        n_frames=n, dim=dim, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
        n_features=n if features == "arange" else 1, compute_dtype=cdt, device=device,
        generator=torch.Generator().manual_seed(seed),
    )
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in cnf.field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
    x = torch.randn((batch, n * dim), generator=gen).to(device)
    t = torch.linspace(0.1, 0.9, batch, device=device)
    row = torch.arange(n) if features == "arange" else torch.zeros(n, dtype=torch.int64)
    return cnf, x, t, row.repeat(batch, 1).to(device)


# The bf16 field value's band, kernel route against plain route: about 10x
# the largest gap read on a card over 24 seeds of each of these tests'
# configurations (1.03e-4, the QM9 Hutchinson probes; 0 at their own seeds).
VALUE_BAND = 1e-3


def _value_band(v_k, v_p, cdt):
    if cdt is None:
        torch.testing.assert_close(v_k, v_p, rtol=0, atol=0)
    else:
        assert (v_k - v_p).abs().max() <= VALUE_BAND * v_p.abs().max()


def _trace_band(d_k, d_p, cdt):
    if cdt is None:
        torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=1e-5)
    else:
        assert (d_k - d_p).abs().max() <= 3e-2 * d_p.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,n,dim,blocks,units,hidden,features", SHIPPED,
                         ids=[s[0] for s in SHIPPED])
def test_trace_through_kernel_at_shipped_shapes(cuda, name, n, dim, blocks, units, hidden,
                                                features, cdt):
    cnf, x, t, f = _shipped_cnf(n, dim, blocks, units, hidden, features, cdt, cuda, batch=6)
    basis, offset = cnf.exact_trace_plan()
    assert basis.shape == ((n - 1) * dim, n * dim)
    before = et.edge_tangent.launch_count
    v_k, d_k = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset)
    assert et.edge_tangent.launch_count == before + blocks
    v_p, d_p = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset, use_kernel=False)
    d_k, d_p = d_k - offset, d_p - offset
    # DW4's network trace runs over only 6 columns and stays ~0.03.
    assert torch.isfinite(d_k).all() and d_p.abs().max() > 0.01
    _value_band(v_k, v_p, cdt)
    _trace_band(d_k, d_p, cdt)


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16"])
def test_hutchinson_probes_through_kernel(cuda, cdt):
    # The QM9 Hutchinson route (approx=True, 4 probes per sample): per-sample
    # [K, B, D] directions through the edge kernel, at QM9 width.
    cnf, x, t, f = _shipped_cnf(19, 3, 5, (256,) * 4, 32, "zeros", cdt, cuda, batch=4, seed=3)
    probes = torch.randn((4, 4, 57), generator=torch.Generator().manual_seed(4)).to(cuda)
    before = et.edge_tangent.launch_count
    v_k, d_k = cnf.tangent_value_and_div(x, t, f, probes)
    assert et.edge_tangent.launch_count == before + 5
    v_p, d_p = cnf.tangent_value_and_div(x, t, f, probes, use_kernel=False)
    assert torch.isfinite(d_k).all()
    _value_band(v_k, v_p, cdt)
    _trace_band(d_k, d_p, cdt)


@pytest.mark.gpu
def test_hutchinson_solve_launches_the_kernel(cuda):
    from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf

    cnf, _, _, f = _shipped_cnf(5, 3, 2, (32, 32), 16, "zeros", "bfloat16", cuda, batch=6)
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.25, method="rk4", hutchinson_probes=4)
    x0 = cnf.sample_base((6,), generator=torch.Generator().manual_seed(5))
    eps = torch.randn((4, 6, 15), generator=torch.Generator().manual_seed(6)).to(cuda)
    before = et.edge_tangent.launch_count
    primal = edge_primal.launch_count
    x1, log_q = sample_and_log_prob_cnf(cnf, 6, f, approx=True, cfg=cfg, x0=x0, eps=eps)
    assert et.edge_tangent.launch_count == before + 4 * 4 * 2  # steps x stages x blocks
    assert edge_primal.launch_count == primal + 4 * 4 * 2
    plain_cfg = SolveConfig(use_fixed_step_size=True, step_size=0.25, method="rk4",
                            hutchinson_probes=4, structured_tangent_kernel=False)
    x1_p, log_q_p = sample_and_log_prob_cnf(cnf, 6, f, approx=True, cfg=plain_cfg, x0=x0, eps=eps)
    _value_band(x1, x1_p, "bfloat16")
    assert (log_q - log_q_p).abs().max() <= 3e-2 * log_q_p.abs().max()


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_arguments(cuda):
    args = torch_args(edge_inputs(2, 2, 5, 32, 2, seed=2), torch.float32, cuda)
    bad = dict(args, a_t=args["a_t"].transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="contiguous"):
        et.edge_tangent(**bad)
    with pytest.raises(TypeError):
        et.edge_tangent(**dict(args, m=args["m"].double()))
    with pytest.raises(ValueError):
        et.edge_tangent(**dict(args, g=args["g"][..., None]))
