"""The primal edge-chain CUDA kernel against its plain version, on a card.

Marked ``gpu``; skipped without a CUDA device.  Imports no JAX, so it runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_edge_primal_gpu.py``.

Limits: each output of the kernel (the silu' factors, m, phi, g, gd, m_i)
within 1e-2 of the largest magnitude of the plain version's, the edge
tangent kernel's bf16 limit: both round every op to bf16 (a rounding is
2^-8 = 3.9e-3 of a value), and their products sum in another order, so a
value near a rounding boundary may land one bf16 step apart and carry
that step down the chain.  The shapes: QM9, LJ13, ALDP and DW4, a last
thread block with fewer receivers than the others (the kernel takes
floor(128 / N) whole receivers a block), and widths the kernel takes
zero-padded (U = 16, 100).  Through the whole field: the value and the
Hutchinson trace with both kernels against the plain route at QM9 width,
and the exact trace over LJ55's 162 zero-CoM columns at its widths, the
value within 1e-3 and the trace within 3e-2 of their largest magnitude
(the edge-tangent tests' bf16 bands).
"""
import pytest
import torch

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.ops import edge_primal as ep
from ecnf_tpu_torch.ops import edge_tangent as et
from ecnf_tpu_torch.ops import tangent

LIMIT = 1e-2
VALUE_BAND = 1e-3
TRACE_BAND = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _cnf(n, blocks, units, hidden, device, seed=0, dim=3):
    """A bf16 CNF with its Dense kernels redrawn at N(0, 1/fan_in)."""
    cnf = build_cnf(
        n_frames=n, dim=dim, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8, n_features=1,
        compute_dtype="bfloat16", device=device, generator=torch.Generator().manual_seed(seed),
    )
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in cnf.field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
    return cnf


def primal_inputs(B, N, U, L, hidden, device, seed=1, dim=3):
    """Block 0's bf16 weights of a CNF of these widths, and the kernel's
    inputs ``a``, ``b``, ``l2`` from random node features and positions."""
    wt = tangent.block_weights(_cnf(N, 1, (U,) * L, hidden, device, seed, dim).field.egnn, 0,
                               torch.bfloat16)
    gen = torch.Generator().manual_seed(seed + 2)
    hb = torch.randn((B, N, hidden), generator=gen).to(device, torch.bfloat16)
    pos = torch.randn((B, N, dim), generator=gen).to(device)
    l2 = torch.cdist(pos, pos) ** 2
    return (hb @ wt.e_s).contiguous(), (hb @ wt.e_r).contiguous(), l2.contiguous(), wt


def _check(out, ref, limit=LIMIT):
    outs = [*out.d_e, *out.d_x, out.m, out.phi, out.g, out.gd, out.m_i]
    refs = [*ref.d_e, *ref.d_x, ref.m, ref.phi, ref.g, ref.gd, ref.m_i]
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert torch.isfinite(o).all()
        err = ((o.float() - r.float()).abs().max() / r.float().abs().max()).item()
        assert err <= limit, err


# (B, N, U, L, hidden): QM9, LJ13, ALDP, DW4 (D=2 below), then the last
# thread block short of receivers (QM9: 6 a block, 5 x 19 = 95 receivers;
# LJ13: 9 a block, 104), the widths taken zero-padded, and more than 32
# nodes (3 receivers a block at N = 33, 2 at LJ55's N = 55 and at 64; 5 x 55
# receivers leave a last block of 1).
SHAPES = [(12, 19, 256, 4, 32), (8, 13, 128, 3, 64), (8, 22, 64, 2, 32), (16, 4, 128, 3, 64),
          (5, 19, 256, 4, 32), (8, 13, 128, 1, 64), (4, 5, 16, 2, 16), (3, 7, 100, 2, 16),
          (4, 33, 64, 2, 32), (5, 55, 128, 3, 64), (3, 64, 256, 4, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,U,L,hidden", SHAPES)
def test_kernel_matches_plain_on_cuda(cuda, B, N, U, L, hidden):
    a, b, l2, wt = primal_inputs(B, N, U, L, hidden, cuda, dim=2 if N == 4 else 3)
    before = ep.edge_primal.launch_count
    out = ep.edge_primal(a, b, l2, wt)
    torch.cuda.synchronize()
    assert ep.edge_primal.launch_count == before + 1
    _check(out, ep.edge_primal_reference(a, b, l2, wt))


@pytest.mark.gpu
def test_repeat_runs_agree_bit_for_bit(cuda):
    a, b, l2, wt = primal_inputs(12, 19, 256, 4, 32, cuda)
    first = ep.edge_primal(a, b, l2, wt)
    for _ in range(2):
        again = ep.edge_primal(a, b, l2, wt)
        for x, y in zip([*first.d_e, *first.d_x, *first[2:]], [*again.d_e, *again.d_x, *again[2:]]):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_wrapper_rejects_bad_arguments(cuda):
    a, b, l2, wt = primal_inputs(2, 5, 32, 2, 16, cuda)
    before = ep.edge_primal.launch_count
    with pytest.raises(ValueError, match="contiguous"):
        ep.edge_primal(a.transpose(0, 1).contiguous().transpose(0, 1), b, l2, wt)
    with pytest.raises(TypeError):
        ep.edge_primal(a, b, l2.double(), wt)
    with pytest.raises(ValueError):
        ep.edge_primal(a, b[:, :4], l2, wt)
    assert ep.edge_primal.launch_count == before


@pytest.mark.gpu
def test_hutchinson_trace_through_both_kernels(cuda):
    # QM9 width, 2 probes a sample: the primal through `edge_primal`, the
    # tangent through `edge_tangent`, against the plain route.
    cnf = _cnf(19, 5, (256,) * 4, 32, cuda, seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((6, 57), generator=gen).to(cuda)
    t = torch.linspace(0.1, 0.9, 6, device=cuda)
    f = torch.zeros((6, 19), dtype=torch.int64, device=cuda)
    probes = torch.randn((2, 6, 57), generator=gen).to(cuda)
    p0, t0 = ep.edge_primal.launch_count, et.edge_tangent.launch_count
    v_k, d_k = cnf.tangent_value_and_div(x, t, f, probes)
    assert ep.edge_primal.launch_count == p0 + 5 and et.edge_tangent.launch_count == t0 + 5
    v_p, d_p = cnf.tangent_value_and_div(x, t, f, probes, use_kernel=False)
    assert ep.edge_primal.launch_count == p0 + 5
    assert torch.isfinite(v_k).all() and torch.isfinite(d_k).all()
    assert (v_k - v_p).abs().max() <= VALUE_BAND * v_p.abs().max()
    assert (d_k - d_p).abs().max() <= TRACE_BAND * d_p.abs().max()


@pytest.mark.gpu
def test_lj55_exact_trace_through_both_kernels(cuda):
    # LJ55 (N=55) at the LJ13 network's widths: both kernels past 32 nodes.
    cnf = _cnf(55, 3, (128,) * 3, 64, cuda, seed=5)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 165), generator=gen).to(cuda)
    t = torch.tensor([0.3, 0.7], device=cuda)
    f = torch.zeros((2, 55), dtype=torch.int64, device=cuda)
    basis, offset = cnf.exact_trace_plan()
    assert basis.shape == (162, 165)
    p0, t0 = ep.edge_primal.launch_count, et.edge_tangent.launch_count
    v_k, d_k = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset)
    assert ep.edge_primal.launch_count == p0 + 3 and et.edge_tangent.launch_count == t0 + 3
    v_p, d_p = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset, use_kernel=False)
    d_k, d_p = d_k - offset, d_p - offset
    assert torch.isfinite(v_k).all() and torch.isfinite(d_k).all() and d_p.abs().max() > 0.1
    assert (v_k - v_p).abs().max() <= VALUE_BAND * v_p.abs().max()
    assert (d_k - d_p).abs().max() <= TRACE_BAND * d_p.abs().max()
