"""Hand-linearised trace (`ecnf_tpu_torch/ops/tangent.py`) vs JAX and vs autodiff.

The port's `egnn_value_and_trace` is compared with the JAX
`egnn_value_and_trace(use_kernel=True, interpret=True)` and with the port's
``torch.func.jvp`` oracle, for the shared ``[K, D]`` basis (exact trace plan)
and for per-sample ``[K, B, D]`` probes, on weights whose network trace is
O(1) (`torch_parity.make_pair`).  The comparison is on ``div - offset``.

Tolerances: f32 value atol 1e-5, ``div - offset`` rtol 1e-4 atol 1e-5.
bf16: value atol 2e-2 (the forward's bf16 band) and ``div - offset`` rtol
3e-2 atol 1e-5.

A planted fault in the edge chain must fail the same comparison.
"""
import math

import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.ops.pallas.tangent_kernel import egnn_value_and_trace as jax_trace
from ecnf_tpu_torch.ops import edge_tangent as et
from ecnf_tpu_torch.ops.divergence import (
    value_and_exact_divergence,
    value_and_multi_probe_hutchinson,
)
from ecnf_tpu_torch.ops.graph import dense_edge_mask

BLOCKS, UNITS = 3, (32, 32)


def assert_trace_close(value, div, ref_value, ref_div, cdt):
    value, div = np.asarray(value), np.asarray(div)
    ref_value, ref_div = np.asarray(ref_value), np.asarray(ref_div)
    if cdt is None:
        np.testing.assert_allclose(value, ref_value, atol=1e-5)
        np.testing.assert_allclose(div, ref_div, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(value, ref_value, atol=2e-2)
        np.testing.assert_allclose(div, ref_div, rtol=3e-2, atol=1e-5)


def _run(cdt, per_sample, seed=0):
    """Port and JAX trace on the same weights; ``div`` minus the offset."""
    jax_cnf, params, cnf = tp.make_pair(BLOCKS, UNITS, cdt, seed=seed)
    x, t, feats = tp.inputs(seed=seed)
    xt, tt, ft = tp.to_torch(x, t, feats)
    if per_sample:
        basis = np.random.default_rng(seed + 10).normal(size=(3, *x.shape)).astype(np.float32)
        off_j = off_t = None
        basis_t = torch.from_numpy(basis)
    else:
        basis, off_j = jax_cnf.exact_trace_plan(params)
        basis_t, off_t = cnf.exact_trace_plan()
    v_j, d_j = jax_trace(
        params, x, t, feats, basis, n_nodes=tp.N, dim=tp.DIM, n_blocks=BLOCKS,
        mlp_units=UNITS, time_embedding_dim=tp.T, compute_dtype=cdt,
        trace_offset=off_j, use_kernel=True, batch_tile=2, interpret=True,
    )
    v_t, d_t = cnf.tangent_value_and_div(xt, tt, ft, basis_t, trace_offset=off_t)
    off = 0.0 if per_sample else float(off_t)
    return (v_t.numpy(), d_t.numpy() - off, np.asarray(v_j), np.asarray(d_j) - off), (
        cnf, xt, tt, ft, basis_t, off_t,
    )


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared_basis", "probes"])
@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16"])
def test_matches_jax_tangent_and_jvp_oracle(cdt, per_sample):
    (v, d, v_j, d_j), (cnf, x, t, f, basis, off) = _run(cdt, per_sample)
    assert np.abs(d_j).max() > 0.1  # the network's trace is O(1), not ~0
    assert_trace_close(v, d, v_j, d_j, cdt)

    field = lambda xb: cnf.apply(xb, t, f)
    if per_sample:
        v_o, d_o = value_and_multi_probe_hutchinson(field, x, basis)
        d_o = d_o * basis.shape[0]  # the tangent path returns the sum over probes
    else:
        v_o, d_o = value_and_exact_divergence(field, x, basis=basis, trace_offset=off)
        d_o = d_o - off
    assert_trace_close(v, d, v_o.detach(), d_o.detach(), cdt)


def test_identity_basis_is_full_trace():
    _, _, cnf = tp.make_pair(BLOCKS, UNITS)
    x, t, f = tp.to_torch(*tp.inputs())
    D = x.shape[1]
    _, d_plan = cnf.tangent_value_and_div(x, t, f, *cnf.exact_trace_plan())
    _, d_full = cnf.tangent_value_and_div(x, t, f, torch.eye(D))
    torch.testing.assert_close(d_full, d_plan, rtol=1e-4, atol=1e-5)


def _faulty_reference(fault):
    """A copy of `edge_tangent_reference` with one planted fault:

    - ``"no_l2"``: the squared-distance term ``l2_t * e_l`` of the first
      layer is dropped (moves ``div - offset`` by ~20% here);
    - ``"no_m_gt"``: the ``m * g_t`` term of ``mi_t`` is dropped.  It
      reaches the trace only through ``h`` in later blocks (~0.2% here),
      below the bf16 noise (~0.7%), so it is a float32 check only; the
      kernel-module test pins ``mi_t`` itself at rtol 1e-5.
    """

    def reference(a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l, e_tail, x_tail, x_out, g_out):
        K, B, N, U = a_t.shape
        cd = a_t.dtype
        z_t = a_t[:, :, None] + b_t[:, :, :, None]
        if fault != "no_l2":
            z_t = z_t + l2_t[..., None].to(cd) * e_l
        t = d_e[0] * z_t
        for d, k in zip(d_e[1:], e_tail):
            t = d * (t @ k)
        m_t = p = t
        for d, k in zip(d_x, x_tail):
            p = d * (p @ k)
        phi_t = (p.float() @ x_out.float().reshape(U, 1))[..., 0]
        g_t = gd[..., None] * (m_t @ g_out.reshape(U, 1))
        terms = m_t * g[..., None] if fault == "no_m_gt" else m_t * g[..., None] + m * g_t
        mask = dense_edge_mask(N, torch.float32)
        mi_t = (terms.float() * mask[:, :, None]).sum(dim=3) / math.sqrt(N - 1)
        return phi_t, mi_t

    return reference


@pytest.mark.parametrize(
    "fault,cdt", [("no_l2", None), ("no_l2", "bfloat16"), ("no_m_gt", None)],
    ids=["no_l2-f32", "no_l2-bf16", "no_m_gt-f32"],
)
def test_planted_fault_fails_parity(fault, cdt, monkeypatch):
    monkeypatch.setattr(et, "edge_tangent_reference", _faulty_reference(fault))
    (v, d, v_j, d_j), _ = _run(cdt, per_sample=False)
    with pytest.raises(AssertionError):
        assert_trace_close(v, d, v_j, d_j, cdt)
