"""Fused EGCL forward (`ecnf_tpu_torch/ops/egcl.py`) against the JAX package.

- Weight layout: a flax tree through `from_flax` and `block_weights(...,
  float32)` gives the JAX `_flatten_egcl_weights` list element for element,
  for every block, and the packed buffer unpacks to the same tensors.
- Forward: the port's `flat_egnn_apply_fused` (its plain version on the
  CPU) against the JAX `flat_egnn_apply_fused` in interpret mode and
  against the JAX `cnf.apply`, value atol 1e-5 (f32).  The fused path is
  f32 whatever the compute dtype, so a bf16-built field holds the same band.

The CUDA kernel itself is checked against the plain version in
`test_torch_fused_gpu.py`, on a card.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.ops.pallas.attic.egcl_kernel import _flatten_egcl_weights
from ecnf_tpu.ops.pallas.attic.egcl_kernel import flat_egnn_apply_fused as jax_fused
from ecnf_tpu_torch.cnf.build import build_cnf as build_torch_cnf
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.ops import egcl
from ecnf_tpu_torch.ops.tangent import block_weights

CASES = [(5, 2, (32, 32)), (13, 3, (32, 32)), (13, 2, (32, 32, 32))]


@pytest.mark.parametrize("n,blocks,units", CASES)
def test_weight_layout_matches_jax_flatten(n, blocks, units):
    tree = tp.redraw(tp._flax_tree(blocks, units, n, tp.DIM), seed=n)
    cnf = build_torch_cnf(**tp.cnf_kwargs(blocks, units, n=n), device="cpu")
    cnf.field.load_state_dict(from_flax(tree))
    egnn_tree = tree["params"]["EGNN_0"]
    packed = egcl.egnn_weights(cnf.field.egnn)
    assert packed.flat.shape[0] == blocks
    for i in range(blocks):
        ref = _flatten_egcl_weights(
            egnn_tree[f"ConcatDense_{i}"], egnn_tree[f"EGCL_{i}"], units, tp.H
        )
        wt = block_weights(cnf.field.egnn, i, torch.float32)
        ours = egcl.weight_list(wt)
        assert len(ours) == len(ref)
        for k, (a, b) in enumerate(zip(ours, ref)):
            b = np.asarray(b, np.float32)
            assert a.numel() == b.size, (i, k)
            np.testing.assert_array_equal(a.numpy().reshape(-1), b.reshape(-1), err_msg=f"block {i} weight {k}")
        # The kernel's packed buffer unpacks to the same tensors.
        for a, b in zip(egcl.weight_list(packed.blocks[i]), ours):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16_built"])
@pytest.mark.parametrize("n,blocks,units", CASES)
def test_forward_matches_jax_fused_and_apply(n, blocks, units, cdt):
    jax_cnf, params, cnf = tp.make_pair(blocks, units, cdt, seed=n + blocks, n=n)
    x, t, feats = tp.inputs(n, seed=n)
    ref_fused = np.asarray(jax_fused(
        params, x, t, feats, n_nodes=n, dim=tp.DIM, n_blocks=blocks, mlp_units=units,
        time_embedding_dim=tp.T, batch_tile=2, interpret=True,
    ))
    out = egcl.flat_egnn_apply_fused(cnf.field, *tp.to_torch(x, t, feats)).numpy()
    assert np.abs(ref_fused).max() > 0.1  # redrawn weights: an O(1) field
    np.testing.assert_allclose(out, ref_fused, atol=1e-5)
    if cdt is None:  # the f32 field itself
        np.testing.assert_allclose(out, np.asarray(jax_cnf.apply(params, x, t, feats)), atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    _, _, cnf = tp.make_pair(2, (32, 32))
    x, t, f = tp.to_torch(*tp.inputs())
    weights = egcl.egnn_weights(cnf.field.egnn)
    before = egcl.egcl_fused.launch_count
    out = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, weights)
    plain = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, weights, use_kernel=False)
    assert egcl.egcl_fused.launch_count == before  # no kernel launched
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(out, cnf.apply(x, t, f), rtol=1e-5, atol=1e-5)


def test_sample_only_solve_through_fused_forward():
    # The pure-sampling use of the fused forward: an rk4 solve whose field
    # is `flat_egnn_apply_fused` matches the solve through the module.
    from ecnf_tpu_torch.ops.ode import odeint

    _, _, cnf = tp.make_pair(2, (32, 32), seed=4)
    _, _, feats = tp.inputs()
    f = torch.from_numpy(feats)
    x0 = cnf.sample_base((tp.B,), generator=torch.Generator().manual_seed(0))
    weights = egcl.egnn_weights(cnf.field.egnn)
    kw = dict(use_fixed_step_size=True, step_size=0.25, method="rk4")
    x1, _ = odeint(lambda t, y: egcl.flat_egnn_apply_fused(cnf.field, y, t, f, weights), x0, 0.0, 1.0, **kw)
    with torch.no_grad():
        ref, _ = odeint(lambda t, y: cnf.apply(y, t, f), x0, 0.0, 1.0, **kw)
    torch.testing.assert_close(x1, ref, rtol=1e-5, atol=1e-5)


def test_non_constant_units_are_refused():
    cnf = build_torch_cnf(**tp.cnf_kwargs(2, (32, 16)), device="cpu")
    with pytest.raises(ValueError, match="constant-width"):
        egcl.egnn_weights(cnf.field.egnn)
    assert cnf.fused_value_and_div is None and cnf.fused_weights is None
