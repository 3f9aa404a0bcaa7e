"""Edge-tangent kernel module (`ecnf_tpu_torch/ops/edge_tangent.py`) on the CPU.

The plain version `edge_tangent_reference` against the JAX package's Pallas
kernel `_edge_tangent_pallas` in interpret mode, on random inputs of the
kernel's own shapes: f32 (rtol 1e-5) and bf16 (3e-2 of the output's
scale), the bf16 case pinning the rounding points that the CUDA kernel's
register epilogue reproduces.  The CUDA kernel itself is checked against
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
