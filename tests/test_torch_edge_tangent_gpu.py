"""The edge-tangent CUDA kernel against its plain version, on a card.

Marked ``gpu``; skipped without a CUDA device.  Imports no JAX, so it runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_edge_tangent_gpu.py`` (the suite's conftest imports JAX).
Limits: the kernel's outputs, max |kernel - plain| / max |plain| 1e-4 in
float32 and 1e-2 in bfloat16; the whole trace at LJ13 widths, ``div -
offset`` rtol 1e-4 / atol 1e-5 in float32 and 3e-2 of its largest
magnitude in bfloat16.
"""
import pytest
import torch

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.ops import edge_tangent as et
from torch_edge_inputs import edge_inputs, torch_args


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("K,B,N,U,L", [(3, 4, 5, 32, 2), (36, 8, 13, 128, 3), (4, 4, 19, 256, 4)])
def test_kernel_matches_plain_on_cuda(cuda, K, B, N, U, L, dtype, limit):
    args = torch_args(edge_inputs(K, B, N, U, L, seed=1), dtype, cuda)
    before = et.edge_tangent.launch_count
    out = et.edge_tangent(**args)
    torch.cuda.synchronize()
    assert et.edge_tangent.launch_count == before + 1
    ref = et.edge_tangent_reference(**args)
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        assert ((o - r).abs().max() / r.abs().max()).item() <= limit


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
    torch.testing.assert_close(v_k, v_p, rtol=0, atol=0)  # the primal is shared
    if cdt is None:
        torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=1e-5)
    else:
        assert (d_k - d_p).abs().max() <= 3e-2 * d_p.abs().max()


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
