"""The primal edge chain's plain version and routing (`ops/edge_primal.py`).

`block_forward` hands its edge chain to `edge_primal_reference` (the
`edge_primal` kernel on a card, in bf16).  Held here, on the CPU:

- `edge_primal_reference` and `block_forward` give, bit for bit, what
  `block_forward` gave before the chain moved out of it (`_earlier_block_forward`
  below is that code, unchanged), at the QM9, LJ13, ALDP and DW4 shapes in
  bf16 and f32;
- the wrapper raises on a dtype, width, depth and node count the kernel
  does not take;
- the routing: only residuals asked for, ``use_kernel`` and
  `kernel_takes` (bf16 on a card) reach the kernel; CPU tensors,
  ``use_kernel=False``, ``with_residuals=False`` and f32 weights keep the
  plain path and ``launch_count`` at 0;
- `egnn_value_and_trace` on the CPU gives the same value and trace with
  and without ``use_kernel``;
- `edge_primal_flops` equals `count_fn_flops` of the plain version.

The kernel against its plain version on a card:
``tests/test_torch_edge_primal_gpu.py``.
"""
import math
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.ops import edge_primal as ep
from ecnf_tpu_torch.ops import tangent
from ecnf_tpu_torch.ops.flops import count_fn_flops
from ecnf_tpu_torch.ops.graph import dense_edge_mask

# (name, N, D, blocks, mlp_units, hidden): the shipped configurations.
SHAPES = [
    ("qm9", 19, 3, 2, (256,) * 4, 32),
    ("lj13", 13, 3, 2, (128,) * 3, 64),
    ("aldp", 22, 3, 2, (64, 64), 32),
    ("dw4", 4, 2, 2, (128,) * 3, 64),
]
DTYPES = [None, "bfloat16"]


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _earlier_block_forward(vec, h, temb, wt, normalization_constant, with_residuals=True):
    """`ops.tangent.block_forward` as it was before its edge chain moved to
    `ops.edge_primal`, unchanged: the oracle of the move."""
    B, N, D = vec.shape
    C = normalization_constant
    mask = dense_edge_mask(N, vec.dtype, vec.device)
    cd = wt.e_s.dtype
    h = (
        h.to(cd) @ wt.cd_h + (temb.to(cd) @ wt.cd_t)[:, None, :] + wt.cd_b
    ).to(vec.dtype)

    gram = torch.einsum("bnd,bmd->bnm", vec, vec)
    r2 = torch.diagonal(gram, dim1=-2, dim2=-1)
    raw = r2[:, :, None] + r2[:, None, :] - 2.0 * gram
    l2 = torch.clamp(raw, min=0.0)
    lengths = torch.where(l2 == 0, 1.0, l2) ** 0.5

    def layer(z, ds):
        if with_residuals:
            ds.append(_dsilu(z))
        return F.silu(z)

    hb = h.to(cd)
    z = (
        (hb @ wt.e_s)[:, None, :, :]
        + (hb @ wt.e_r)[:, :, None, :]
        + l2[..., None].to(cd) * wt.e_l
        + wt.e_b[0]
    )
    d_e = []
    a = layer(z, d_e)
    for k, bias in zip(wt.e_tail, wt.e_b[1:]):
        a = layer(a @ k + bias, d_e)
    m = a

    d_x = []
    for k, bias in zip(wt.x_tail, wt.x_b):
        a = layer(a @ k + bias, d_x)
    phi = (a @ wt.x_out + wt.x_out_b).to(vec.dtype)

    w = phi * mask / (C + lengths)
    shifts = w.sum(dim=2)[:, :, None] * vec - torch.einsum("bij,bjd->bid", w, vec)
    vec_out = vec + shifts / (N - 1)

    g = torch.sigmoid(m @ wt.g_out + wt.g_out_b)
    m_i = ((m * g[..., None]).to(vec.dtype) * mask[None, :, :, None]).sum(
        dim=2
    ) / math.sqrt(N - 1)

    d_h = []
    a = layer(m_i.to(cd) @ wt.h_m + hb @ wt.h_h + wt.h_b[0], d_h)
    for k, bias in zip(wt.h_tail, wt.h_b[1:-1]):
        a = layer(a @ k + bias, d_h)
    h_out = (a @ wt.h_out + wt.h_b[-1]).to(h.dtype) + h

    res = None
    if with_residuals:
        res = tangent.BlockResiduals(
            vec=vec, l2=l2, active=raw > 0, lengths=lengths, phi=phi, w=w,
            d_e=tuple(d_e), d_x=tuple(d_x), m=m, g=g, gd=g * (1.0 - g),
            d_h=tuple(d_h),
        )
    return vec_out, h_out, res, hb, l2, m_i


def _cnf(n, dim, blocks, units, hidden, cdt, seed=0):
    """A CPU CNF with its Dense kernels redrawn at N(0, 1/fan_in), so the
    chain's values are O(1)."""
    cnf = build_cnf(
        n_frames=n, dim=dim, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8, n_features=1,
        compute_dtype=cdt, device="cpu", generator=torch.Generator().manual_seed(seed),
    )
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in cnf.field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
    return cnf


def _block_inputs(n, dim, hidden, batch=3, seed=2):
    gen = torch.Generator().manual_seed(seed)
    vec = torch.randn((batch, n, dim), generator=gen)
    vec = vec - vec.mean(dim=1, keepdim=True)
    return vec, torch.randn((batch, n, hidden), generator=gen), torch.randn((batch, 8), generator=gen)


def _weights(cnf, cdt):
    cd = torch.bfloat16 if cdt else torch.float32
    return tangent.block_weights(cnf.field.egnn, 0, cd)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("cdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name,n,dim,blocks,units,hidden", SHAPES, ids=[s[0] for s in SHAPES])
def test_reference_equals_the_earlier_block_forward(name, n, dim, blocks, units, hidden, cdt):
    cnf = _cnf(n, dim, blocks, units, hidden, cdt)
    wt = _weights(cnf, cdt)
    vec, h, temb = _block_inputs(n, dim, hidden)
    C = cnf.field.egnn.normalization_constant
    vec_o, h_o, res_o, hb, l2, m_i = _earlier_block_forward(vec, h, temb, wt, C)
    assert res_o.d_e[0].dtype == (torch.bfloat16 if cdt else torch.float32)

    edge = ep.edge_primal_reference(hb @ wt.e_s, hb @ wt.e_r, l2, wt)
    _equal(edge.d_e, res_o.d_e)
    _equal(edge.d_x, res_o.d_x)
    _equal([edge.m, edge.phi, edge.g, edge.gd, edge.m_i], [res_o.m, res_o.phi, res_o.g, res_o.gd, m_i])

    for use_kernel in (False, True):  # on the CPU both are the plain path
        vec_n, h_n, res_n = tangent.block_forward(vec, h, temb, wt, C, use_kernel=use_kernel)
        _equal([vec_n, h_n], [vec_o, h_o])
        _equal(list(res_n), list(res_o))


@pytest.mark.parametrize("cdt", DTYPES, ids=["f32", "bf16"])
def test_block_forward_without_residuals_is_unchanged(cdt):
    cnf = _cnf(13, 3, 2, (128,) * 3, 64, cdt)
    wt = _weights(cnf, cdt)
    vec, h, temb = _block_inputs(13, 3, 64)
    C = cnf.field.egnn.normalization_constant
    vec_o, h_o, res_o, *_ = _earlier_block_forward(vec, h, temb, wt, C, with_residuals=False)
    vec_n, h_n, res_n = tangent.block_forward(vec, h, temb, wt, C, with_residuals=False,
                                              use_kernel=True)
    assert res_o is None and res_n is None
    _equal([vec_n, h_n], [vec_o, h_o])


def _fake_weights(U, L):
    return SimpleNamespace(e_b=[None] * L, e_tail=[None] * (L - 1), x_tail=[None] * L,
                           x_b=[None] * L)


@pytest.mark.parametrize("B,N,U,L,dtype,error", [
    (2, 19, 256, 4, torch.float32, TypeError),  # the kernel runs bf16 only
    (2, 19, 256, 4, torch.float16, TypeError),
    (2, 19, 512, 4, torch.bfloat16, ValueError),  # wider than 256
    (2, 19, 256, 9, torch.bfloat16, ValueError),  # deeper than 8
    (2, 33, 64, 2, torch.bfloat16, ValueError),  # more than 32 nodes
    (2, 1, 64, 2, torch.bfloat16, ValueError),  # one node: no edges
])
def test_wrapper_rejects_what_the_kernel_does_not_take(B, N, U, L, dtype, error):
    a = torch.zeros((B, N, U), dtype=dtype)
    l2 = torch.zeros((B, N, N))
    before = ep.edge_primal.launch_count
    with pytest.raises(error):
        ep.edge_primal(a, a, l2, _fake_weights(U, L))
    assert ep.edge_primal.launch_count == before


def test_wrapper_rejects_inconsistent_layer_counts():
    a = torch.zeros((2, 5, 32), dtype=torch.bfloat16)
    wt = SimpleNamespace(e_b=[None] * 2, e_tail=[None] * 2, x_tail=[None] * 2, x_b=[None] * 2)
    with pytest.raises(ValueError, match="layer counts"):
        ep.edge_primal(a, a, torch.zeros((2, 5, 5)), wt)


def test_wrapper_on_cpu_runs_the_plain_version():
    cnf = _cnf(5, 3, 1, (32, 32), 16, "bfloat16")
    wt = _weights(cnf, "bfloat16")
    vec, h, _ = _block_inputs(5, 3, 16)
    hb = h.to(torch.bfloat16)
    l2 = torch.cdist(vec, vec) ** 2
    before = ep.edge_primal.launch_count
    out = ep.edge_primal(hb @ wt.e_s, hb @ wt.e_r, l2, wt)
    assert ep.edge_primal.launch_count == before
    _equal(list(out), list(ep.edge_primal_reference(hb @ wt.e_s, hb @ wt.e_r, l2, wt)))


CUDA = torch.device("cuda")


@pytest.mark.parametrize("device,dtype,N,U,L,takes", [
    (CUDA, torch.bfloat16, 19, 256, 4, True),  # QM9
    (CUDA, torch.bfloat16, 13, 128, 3, True),  # LJ13
    (CUDA, torch.bfloat16, 22, 64, 2, True),  # ALDP
    (CUDA, torch.bfloat16, 4, 128, 3, True),  # DW4
    (CUDA, torch.bfloat16, 5, 16, 2, True),  # zero-padded to 32
    (CUDA, torch.bfloat16, 2, 100, 1, True),  # zero-padded to 128
    (torch.device("cpu"), torch.bfloat16, 19, 256, 4, False),
    (CUDA, torch.float32, 19, 256, 4, False),
    (CUDA, torch.bfloat16, 33, 64, 2, False),
    (CUDA, torch.bfloat16, 19, 257, 4, False),
    (CUDA, torch.bfloat16, 19, 256, 9, False),
    (CUDA, torch.bfloat16, 1, 64, 2, False),
])
def test_kernel_takes(device, dtype, N, U, L, takes):
    assert ep.kernel_takes(device, dtype, N, U, L) is takes


@pytest.mark.parametrize("with_residuals,use_kernel,cdt,routed", [
    (True, True, "bfloat16", True),
    (True, False, "bfloat16", False),
    (False, True, "bfloat16", False),
    (True, True, None, False),  # f32 weights
])
def test_routing(monkeypatch, with_residuals, use_kernel, cdt, routed):
    # Pretend the tensors lie on a card: only the three conditions of
    # `block_forward` and the dtype decide whether the wrapper is called.
    calls = []

    def takes(device, dtype, N, U, L):
        return dtype == torch.bfloat16

    def kernel(a, b, l2, wt):
        calls.append(a.shape)
        return ep.edge_primal_reference(a, b, l2, wt)

    monkeypatch.setattr(ep, "kernel_takes", takes)
    monkeypatch.setattr(ep, "edge_primal", kernel)
    cnf = _cnf(5, 3, 1, (32, 32), 16, cdt)
    wt = _weights(cnf, cdt)
    vec, h, temb = _block_inputs(5, 3, 16)
    out = tangent.block_forward(vec, h, temb, wt, 1.0, with_residuals=with_residuals,
                                use_kernel=use_kernel)
    assert len(calls) == int(routed)
    plain = _earlier_block_forward(vec, h, temb, wt, 1.0, with_residuals=with_residuals)
    _equal(list(out[:2]), list(plain[:2]))


@pytest.mark.parametrize("cdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("probes", [False, True], ids=["exact", "hutchinson"])
def test_value_and_trace_on_cpu_is_unchanged(cdt, probes):
    cnf = _cnf(13, 3, 2, (128,) * 3, 64, cdt, seed=3)
    gen = torch.Generator().manual_seed(4)
    B = 3
    x = torch.randn((B, 39), generator=gen)
    t = torch.linspace(0.2, 0.8, B)
    f = torch.zeros((B, 13), dtype=torch.int64)
    if probes:
        basis, offset = torch.randn((2, B, 39), generator=gen), None
    else:
        basis, offset = cnf.exact_trace_plan()
    before = ep.edge_primal.launch_count
    v_k, d_k = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset)
    v_p, d_p = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset, use_kernel=False)
    assert ep.edge_primal.launch_count == before
    _equal([v_k, d_k], [v_p, d_p])
    # The primal is the earlier one: the value through the earlier blocks.
    weights = tangent.trace_weights(cnf.field)
    egnn = cnf.field.egnn
    pos = x.reshape(B, 13, 3)
    pos_mean = pos.mean(dim=-2, keepdim=True)
    vec = pos - pos_mean
    h = cnf.field.embed(f)
    from ecnf_tpu_torch.ops.numerics import timestep_embedding

    temb = timestep_embedding(t, cnf.field.time_embedding_dim)
    v0 = vec
    for wt in weights:
        vec, h, *_ = _earlier_block_forward(vec, h, temb, wt, egnn.normalization_constant)
    value = ((vec - v0 - pos_mean) * egnn.final_scaling.detach()).reshape(B, 39)
    _equal(v_k, value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,U,L", [(256, 19, 256, 4), (48, 13, 128, 3), (256, 22, 64, 2),
                                     (64, 4, 128, 3), (3, 5, 16, 1)])
def test_flops_equal_the_plain_count(B, N, U, L, dtype):
    # Full-size shapes on `meta` tensors: shapes only, no arithmetic.
    meta = lambda *s, dt=dtype: torch.empty(s, dtype=dt, device="meta")
    wt = SimpleNamespace(
        e_l=meta(U), e_b=[meta(U) for _ in range(L)], e_tail=[meta(U, U) for _ in range(L - 1)],
        x_tail=[meta(U, U) for _ in range(L)], x_b=[meta(U) for _ in range(L)],
        x_out=meta(U), x_out_b=meta(), g_out=meta(U), g_out_b=meta(),
    )
    counted = count_fn_flops(ep.edge_primal_reference, meta(B, N, U), meta(B, N, U),
                             meta(B, N, N, dt=torch.float32), wt)
    assert counted == ep.edge_primal_flops(B, N, U, L, dtype)
    assert (counted.bf16 > 0) == (dtype == torch.bfloat16)
