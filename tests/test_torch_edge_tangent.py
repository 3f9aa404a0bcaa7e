"""Edge-tangent kernel module (`ecnf_tpu_torch/ops/edge_tangent.py`) on the CPU.

The plain version `edge_tangent_reference` against the JAX package's Pallas
kernel `_edge_tangent_pallas` in interpret mode, on random inputs of the
kernel's own shapes (f32, rtol 1e-5).  The CUDA kernel itself is checked
against the plain version in `test_torch_edge_tangent_gpu.py`, on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from ecnf_tpu.ops.pallas import tangent_kernel as jtk
from ecnf_tpu_torch.ops import edge_tangent as et
from torch_edge_inputs import edge_inputs, torch_args


def _jax_pallas(args, batch_tile):
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
        res, wt, jnp.float32, batch_tile=batch_tile, interpret=True,
    )
    return np.asarray(phi_t), np.asarray(mi_t)


@pytest.mark.parametrize("K,B,N,U,L", [(3, 4, 5, 32, 2), (2, 2, 6, 32, 3)])
def test_reference_matches_jax_pallas_interpret(K, B, N, U, L):
    args = edge_inputs(K, B, N, U, L, seed=K + L)
    ref_phi, ref_mi = _jax_pallas(args, batch_tile=2)
    phi, mi = et.edge_tangent_reference(**torch_args(args))
    assert phi.shape == (K, B, N, N) and mi.shape == (K, B, N, U)
    assert phi.dtype == mi.dtype == torch.float32
    # rtol 1e-5 against the output's scale (elements near zero carry the
    # f32 rounding of their O(1) neighbours).
    for out, ref in ((phi.numpy(), ref_phi), (mi.numpy(), ref_mi)):
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_wrapper_takes_plain_version_on_cpu():
    args = torch_args(edge_inputs(2, 2, 5, 32, 2, seed=0))
    before = et.edge_tangent.launch_count
    out = et.edge_tangent(**args)
    ref = et.edge_tangent_reference(**args)
    assert et.edge_tangent.launch_count == before  # no kernel launched
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
