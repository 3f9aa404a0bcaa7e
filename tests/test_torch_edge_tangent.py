"""Edge-tangent kernel module (`ecnf_tpu_torch/ops/edge_tangent.py`) on the CPU.

The plain version `edge_tangent_reference` against the JAX package's Pallas
kernel `_edge_tangent_pallas` in interpret mode, on random inputs of the
kernel's own shapes: f32 (rtol 1e-5) and bf16 (3e-2 of the output's
scale), the bf16 case pinning the rounding points that the CUDA kernel's
register epilogue reproduces.  The zero-padding of a width the kernel
does not take (`pad_units`) leaves the plain chain's outputs unchanged.  The CUDA kernel itself is checked against
the plain version in `test_torch_edge_tangent_gpu.py`, on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from ecnf_tpu.ops.pallas import tangent_kernel as jtk
from ecnf_tpu_torch.ops import edge_tangent as et
from torch_edge_inputs import edge_inputs, torch_args


def _jax_pallas(args, batch_tile, cd=jnp.float32):
    res = jtk.BlockResiduals(
        vec=None, l2=None, active=None, lengths=None, phi=None, w=None,
        d_e=tuple(map(jnp.asarray, args["d_e"])), d_x=tuple(map(jnp.asarray, args["d_x"])),
        m=jnp.asarray(args["m"]), g=jnp.asarray(args["g"]), gd=jnp.asarray(args["gd"]),
        d_h=None,
    )
    wt = jtk.BlockWeights(
        cd_h=None, e_s=None, e_r=None, e_l=jnp.asarray(args["e_l"])[None, :],
        e_tail=tuple(map(jnp.asarray, args["e_tail"])),
        x_tail=tuple(map(jnp.asarray, args["x_tail"])),
        x_out=jnp.asarray(args["x_out"])[:, None], g_out=jnp.asarray(args["g_out"])[:, None],
        h_m=None, h_h=None, h_tail=None, h_out=None,
    )
    phi_t, mi_t = jtk._edge_tangent_pallas(
        jnp.asarray(args["a_t"]), jnp.asarray(args["b_t"]), jnp.asarray(args["l2_t"]),
        res, wt, cd, batch_tile=batch_tile, interpret=True,
    )
    return np.asarray(phi_t), np.asarray(mi_t)


def _bf16_args(args):
    """`args` rounded to bf16 (``l2_t`` stays f32), as numpy f32 for JAX
    and as bf16 tensors for the port: the same values in both."""
    t = torch_args(args, torch.bfloat16)
    to_np = lambda v: [to_np(x) for x in v] if isinstance(v, list) else v.float().numpy()
    return {k: to_np(v) for k, v in t.items()}, t


_SHAPES = [(3, 4, 5, 32, 2), (2, 2, 6, 32, 3)]


@pytest.mark.parametrize(
    "K,B,N,U,L,dtype",
    [pytest.param(*s, "float32", id="-".join(map(str, s))) for s in _SHAPES]
    + [pytest.param(*s, "bfloat16", id="bf16-" + "-".join(map(str, s))) for s in _SHAPES],
)
def test_reference_matches_jax_pallas_interpret(K, B, N, U, L, dtype):
    args = edge_inputs(K, B, N, U, L, seed=K + L)
    if dtype == "float32":
        ref_phi, ref_mi = _jax_pallas(args, batch_tile=2)
        phi, mi = et.edge_tangent_reference(**torch_args(args))
        # rtol 1e-5 against the output's scale (elements near zero carry
        # the f32 rounding of their O(1) neighbours).
        rtol = 1e-5
    else:
        np_args, t_args = _bf16_args(args)
        jax_args = {
            k: (v if k == "l2_t" else
                [jnp.asarray(x, jnp.bfloat16) for x in v] if isinstance(v, list)
                else jnp.asarray(v, jnp.bfloat16))
            for k, v in np_args.items()
        }
        ref_phi, ref_mi = _jax_pallas(jax_args, batch_tile=2, cd=jnp.bfloat16)
        phi, mi = et.edge_tangent_reference(**t_args)
        # The port's bf16 band (3e-2 of the output's scale): both round at
        # the same points, but XLA on the CPU keeps excess f32 precision
        # inside fused elementwise chains where the port rounds each op.
        rtol = 3e-2
    assert phi.shape == (K, B, N, N) and mi.shape == (K, B, N, U)
    assert phi.dtype == mi.dtype == torch.float32
    for out, ref in ((phi.numpy(), np.asarray(ref_phi)), (mi.numpy(), np.asarray(ref_mi))):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_wrapper_takes_plain_version_on_cpu():
    args = torch_args(edge_inputs(2, 2, 5, 32, 2, seed=0))
    before = et.edge_tangent.launch_count
    out = et.edge_tangent(**args)
    ref = et.edge_tangent_reference(**args)
    assert et.edge_tangent.launch_count == before  # no kernel launched
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def test_wrapper_on_cpu_ignores_columns_per_block():
    # On CPU tensors the wrapper takes the plain version whatever the
    # chunking asked for, and still rejects a chunking below 1.
    args = torch_args(edge_inputs(3, 2, 5, 32, 2, seed=3))
    ref = et.edge_tangent_reference(**args)
    before = et.edge_tangent.launch_count
    for cols in (1, 2, 3, 100):
        out = et.edge_tangent(**args, columns_per_block=cols)
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert et.edge_tangent.launch_count == before
    for cols in (0, -1):
        with pytest.raises(ValueError, match="columns_per_block"):
            et.edge_tangent(**args, columns_per_block=cols)


@pytest.mark.parametrize("U", [4, 16])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-6), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
def test_padded_units_leave_the_chain_unchanged(U, L, dtype, limit):
    # The card's wrapper zero-pads a width the kernel does not take (the
    # `--local` widths) to the next one it takes.  On the plain version the
    # padded units of mi_t are exactly zero and the rest agree with the
    # unpadded chain up to the order of the f32 sums inside the products
    # (in bf16 such a last-bit change can flip one rounding to bf16: phase
    # 3's bf16 limit).
    args = torch_args(edge_inputs(3, 2, 5, U, L, seed=U + L), dtype)
    width = et.kernel_units(U)
    assert width == 32
    padded = et.pad_units(**args, width=width)
    assert padded[0].shape == (3, 2, 5, width)
    assert all(k.shape == (width, width) for k in padded[9] + padded[10])
    phi, mi = et.edge_tangent_reference(*padded)
    ref_phi, ref_mi = et.edge_tangent_reference(**args)
    assert mi.shape == (3, 2, 5, width) and bool((mi[..., U:] == 0).all())
    for out, ref in ((phi, ref_phi), (mi[..., :U], ref_mi)):
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= limit


def test_kernel_units():
    assert [et.kernel_units(u) for u in (1, 4, 16, 32, 33, 64, 100, 256)] == [
        32, 32, 32, 32, 64, 64, 128, 256]
    with pytest.raises(ValueError, match="wider"):
        et.kernel_units(257)


# The route rule at the shapes of the port's programs and cells:
# (dtype, K, B, N, U, L, resident).
ROUTES = [
    (torch.bfloat16, 162, 16, 55, 128, 3, True),    # the LJ55 cell
    (torch.bfloat16, 36, 48, 13, 128, 3, True),     # LJ13 exact (`sample --with-log-prob`)
    (torch.bfloat16, 36, 64, 13, 128, 3, True),     # LJ13's evaluation batch
    (torch.bfloat16, 63, 16, 22, 64, 2, True),      # the ALDP serving shape in bf16
    (torch.bfloat16, 6, 64, 4, 128, 3, False),      # the DW4 training program
    (torch.bfloat16, 1, 256, 19, 256, 4, False),    # the QM9 Hutchinson cell
    (torch.bfloat16, 1, 256, 22, 64, 2, False),     # ALDP Hutchinson
    (torch.bfloat16, 54, 64, 19, 256, 4, False),    # QM9 exact: U = 256
    (torch.float32, 162, 16, 55, 128, 3, False),    # float32
    (torch.float32, 36, 48, 13, 128, 3, False),
    (torch.bfloat16, 162, 16, 55, 128, 4, False),   # 7 weights past shared memory
    (torch.bfloat16, 162, 16, 65, 128, 3, False),   # past 64 nodes
    (torch.bfloat16, 162, 16, 55, 100, 3, True),    # zero-padded to 128
    (torch.bfloat16, 162, 16, 55, 16, 1, True),     # zero-padded to 32
]


@pytest.mark.parametrize("dtype,K,B,N,U,L,resident", ROUTES)
def test_resident_route(dtype, K, B, N, U, L, resident):
    assert et.resident_route(dtype, K, B, N, U, L) is resident


def test_resident_route_threshold():
    K = et.RESIDENT_MIN_COLUMNS
    assert et.resident_route(torch.bfloat16, K, 2, 13, 128, 3)
    assert not et.resident_route(torch.bfloat16, K - 1, 2, 13, 128, 3)


@pytest.mark.parametrize("U,L,nbytes", [(128, 3, 208_128), (128, 2, 140_544), (64, 2, 47_232),
                                        (32, 1, 14_464), (128, 4, 275_712)])
def test_resident_smem_bytes(U, L, nbytes):
    # The weights, the vectors, and two warpgroup stages (the a_t tile, two
    # buffers of 2L + 1 vectors and of 64 l2_t values), 128-byte aligned.
    assert et.resident_smem_bytes(U, L) == nbytes
    assert (nbytes <= et.SMEM_PER_BLOCK) == (L < 4)


def test_resident_wrapper_raises_on_cpu_tensors():
    args = torch_args(edge_inputs(2, 2, 5, 32, 2, seed=0), torch.bfloat16)
    before = (et.edge_tangent.launch_count, et.edge_tangent_resident.launch_count)
    with pytest.raises(ValueError, match="unsupported device"):
        et.edge_tangent_resident(**args)
    assert (et.edge_tangent.launch_count, et.edge_tangent_resident.launch_count) == before
