"""Fused forward + exact trace (`ecnf_tpu_torch/ops/fused_trace.py`) and the
``fused_trace=True`` sampling path, against the JAX package.

The port's `egnn_value_and_div_fused` (its plain version on the CPU: the
f32 hand-linearised trace over all N*D identity columns) against the JAX
`egnn_value_and_div_fused` in interpret mode, on weights whose network
trace is O(1) (`torch_parity.make_pair`).  Tolerances: value atol 1e-5;
the network's share of the trace, ``div + dim * final_scaling``, rtol 1e-4
atol 1e-5.  Both packages' fused paths are f32 whatever the compute dtype,
so a bf16-built CNF holds the same band.  End to end, log q at rtol 1e-4.

A planted fault in the plain path must fail the same comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.ops.ode import odeint_fixed as jax_odeint_fixed
from ecnf_tpu.ops.pallas.attic.trace_kernel import egnn_value_and_div_fused as jax_fused
from ecnf_tpu_torch import sample
from ecnf_tpu_torch.cnf.build import build_cnf as build_torch_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_tpu_torch.ops import edge_tangent as et
from ecnf_tpu_torch.ops import fused_trace
from test_torch_tangent import _faulty_reference

STEP = 0.25
CASES = [(5, 2, (32, 32)), (13, 2, (32, 32)), (5, 3, (32, 32, 32))]


def assert_fused_close(v, div, ref_v, ref_div, fs, dim=tp.DIM):
    np.testing.assert_allclose(np.asarray(v), np.asarray(ref_v), atol=1e-5)
    net, ref_net = np.asarray(div) + dim * fs, np.asarray(ref_div) + dim * fs
    np.testing.assert_allclose(net, ref_net, rtol=1e-4, atol=1e-5)


def _run(n, blocks, units, cdt=None, seed=0):
    jax_cnf, params, cnf = tp.make_pair(blocks, units, cdt, seed=seed, n=n)
    x, t, feats = tp.inputs(n, seed=seed)
    v_j, d_j = jax_fused(
        params, x, t, feats, n_nodes=n, dim=tp.DIM, n_blocks=blocks, mlp_units=units,
        time_embedding_dim=tp.T, batch_tile=2, interpret=True,
    )
    v, d = cnf.fused_value_and_div(*tp.to_torch(x, t, feats))
    fs = float(cnf.field.egnn.final_scaling.detach())
    return (v.numpy(), d.numpy(), np.asarray(v_j), np.asarray(d_j), fs)


@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16_built"])
@pytest.mark.parametrize("n,blocks,units", CASES)
def test_matches_jax_fused_trace(n, blocks, units, cdt):
    v, d, v_j, d_j, fs = _run(n, blocks, units, cdt, seed=n + blocks)
    assert np.abs(d_j + tp.DIM * fs).max() > 0.1  # the network's trace is O(1)
    assert_fused_close(v, d, v_j, d_j, fs)


@pytest.mark.parametrize("fault", ["no_l2", "no_m_gt"])
def test_planted_fault_fails_parity(fault, monkeypatch):
    monkeypatch.setattr(et, "edge_tangent_reference", _faulty_reference(fault))
    v, d, v_j, d_j, fs = _run(5, 3, (32, 32, 32), seed=8)
    with pytest.raises(AssertionError):
        assert_fused_close(v, d, v_j, d_j, fs)


def test_wrapper_takes_plain_version_on_cpu():
    _, _, cnf = tp.make_pair(2, (32, 32))
    x, t, f = tp.to_torch(*tp.inputs())
    before = fused_trace.egnn_value_and_div_fused.launch_count
    v, d = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f)
    v_p, d_p = fused_trace.egnn_value_and_div_reference(cnf.field, x, t, f)
    assert fused_trace.egnn_value_and_div_fused.launch_count == before
    torch.testing.assert_close(v, v_p, rtol=0, atol=0)
    torch.testing.assert_close(d, d_p, rtol=0, atol=0)
    # The full trace equals the zero-CoM plan's trace plus its offset.
    basis, offset = cnf.exact_trace_plan()
    _, d_plan = cnf.tangent_value_and_div(x, t, f, basis, trace_offset=offset)
    torch.testing.assert_close(d, d_plan, rtol=1e-4, atol=1e-5)


def _cfg(**kw):
    return SolveConfig(use_fixed_step_size=True, step_size=STEP, fused_trace=True, **kw)


def _jax_cfg(**kw):
    return jax_sampling.SolveConfig(
        use_fixed_step_size=True, step_size=STEP, fused_trace=True,
        fused_batch_tile=2, fused_interpret=True, **kw,
    )


@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16_built"])
def test_get_log_prob_matches_jax(cdt):
    jax_cnf, params, cnf = tp.make_pair(2, (32, 32), cdt, seed=11)
    x, _, feats = tp.inputs(seed=11)
    ref = jax_sampling.get_log_prob(
        jax_cnf, params, jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(feats),
        cfg=_jax_cfg(method="rk4"),
    )
    out = get_log_prob(cnf, *tp.to_torch(x, feats), cfg=_cfg(method="rk4"))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4)


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_sample_and_log_prob_with_injected_x0_matches_jax(method):
    jax_cnf, params, cnf = tp.make_pair(2, (32, 32), seed=12)
    _, _, feats = tp.inputs(seed=12)
    noise = np.random.default_rng(12).normal(size=(tp.B, tp.N, tp.DIM)).astype(np.float32)
    x0 = cnf.sample_base((tp.B,), noise=torch.from_numpy(noise))

    func = jax_sampling._augmented_field(
        jax_cnf, params, jnp.asarray(feats), False, None, _jax_cfg(method=method)
    )
    x0_j = jnp.asarray(x0.numpy())
    y0 = jnp.concatenate([x0_j, jnp.zeros((tp.B, 1))], axis=-1)
    y1, _ = jax_odeint_fixed(func, y0, 0.0, 1.0, step_size=STEP, method=method)
    log_q_ref = jax_cnf.log_prob_base(x0_j) - y1[:, -1]

    x1, log_q = sample_and_log_prob_cnf(
        cnf, tp.B, torch.from_numpy(feats), cfg=_cfg(method=method), x0=x0
    )
    np.testing.assert_allclose(x1.numpy(), np.asarray(y1[:, :-1]), atol=1e-5)
    np.testing.assert_allclose(log_q.numpy(), np.asarray(log_q_ref), rtol=1e-4)


def test_fused_flag_is_ignored_by_hutchinson_and_needs_a_hook():
    _, _, cnf = tp.make_pair(2, (32, 32), seed=13)
    x, _, feats = tp.inputs(seed=13)
    xt, ft = tp.to_torch(x, feats)
    eps = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    plain = SolveConfig(use_fixed_step_size=True, step_size=STEP)
    on = get_log_prob(cnf, xt, ft, approx=True, cfg=_cfg(), eps=eps)
    off = get_log_prob(cnf, xt, ft, approx=True, cfg=plain, eps=eps)
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    no_hook = build_torch_cnf(**tp.cnf_kwargs(2, (32, 16)))
    with pytest.raises(ValueError, match="no fused kernel"):
        get_log_prob(no_hook, xt, ft, cfg=_cfg())


def test_entry_point_fused_trace_matches_structured_path():
    args = [
        "--n-nodes", "5", "--n-samples", "8", "--batch-size", "4", "--with-log-prob",
        "--dtype", "float32", "--n-blocks", "2", "--mlp-units", "32", "32",
        "--hidden", "16", "--step-size", "0.25", "--seed", "3", "--device", "cpu",
    ]
    fused = sample.main(args + ["--fused-trace"])
    structured = sample.main(args)
    np.testing.assert_allclose(fused["samples"], structured["samples"], atol=1e-5)
    np.testing.assert_allclose(fused["log_q"], structured["log_q"], rtol=1e-4)
    # Without --with-log-prob the flag changes nothing: the solve is cnf.apply.
    sample_only = [a for a in args if a != "--with-log-prob"]
    a = sample.main(sample_only + ["--fused-trace"])["samples"]
    b = sample.main(sample_only)["samples"]
    np.testing.assert_array_equal(a, b)
