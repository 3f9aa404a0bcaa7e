"""The exact trace with its Jacobian columns split over ranks
(`ops.divergence.sharded_value_and_exact_divergence`, `get_log_prob(...,
trace_mesh=...)`) against the JAX package's, on the CPU.

The port runs on gloo ranks started by `torch_ddp_worker.launch`: two ranks
on a 1-D mesh and four on ``get_mesh_2d(2, 2)`` (batch and columns split at
once); JAX runs its `sharded_value_and_exact_divergence` on its 8-device
CPU mesh and on ``get_mesh_2d(2, 4)``.  The field is the EGNN CNF at the
parity widths of `torch_parity.make_pair` (2 blocks of [32, 32], N=5, D=3),
with the identity basis (15 columns, which neither 2 nor 4 divides, so
zero columns pad it) and with the zero-CoM basis and its offset (12
columns).  Bands as `tests/test_ode.py`: value and divergence rtol 1e-5;
the log-density solve on `build_mlp_cnf` rtol 1e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as worker
import torch_parity as tp
from ecnf_tpu.cnf.build import build_mlp_cnf as build_jax_mlp_cnf
from ecnf_tpu.cnf.sampling import SolveConfig as JaxSolveConfig
from ecnf_tpu.cnf.sampling import get_log_prob as jax_get_log_prob
from ecnf_tpu.ops.divergence import sharded_value_and_exact_divergence as jax_sharded
from ecnf_tpu.parallel import DATA_AXIS, TRACE_AXIS, get_mesh, get_mesh_2d
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.ops.divergence import (
    sharded_value_and_exact_divergence,
    value_and_exact_divergence,
)

RTOL = 1e-5
B, T = 4, 0.37
BASES = ("identity", "zero_com")


@pytest.fixture(scope="module")
def pair():
    jax_cnf, jax_params, cnf = tp.make_pair(seed=7)
    x, _, feats = tp.inputs(batch=B, seed=7)
    return jax_cnf, jax_params, cnf, x, feats[:1]


@pytest.fixture(scope="module")
def mlp():
    cnf = build_jax_mlp_cnf(dim=2, sigma_min=0.01, base_scale=1.0, features=(16,))
    params = cnf.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)), jnp.zeros((1,)), None)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    return cnf, params, np.asarray(x)


def _spec(pair, mlp):
    _, _, cnf, x, feats_row = pair
    _, params, mlp_x = mlp
    return dict(
        cnf_kwargs=tp.cnf_kwargs(2, (32, 32)), state_dict=cnf.field.state_dict(),
        x=torch.from_numpy(x), feats_row=torch.from_numpy(feats_row).long(), t=T,
        mlp_state_dict=from_flax(jax.tree_util.tree_map(np.asarray, params)),
        mlp_x=torch.from_numpy(np.array(mlp_x)),
    )


@pytest.fixture(scope="module")
def ranks_1d(pair, mlp, tmp_path_factory):
    return worker.launch("divergence", 2, tmp_path_factory.mktemp("div1d"), _spec(pair, mlp))


@pytest.fixture(scope="module")
def ranks_2d(pair, mlp, tmp_path_factory):
    return worker.launch("divergence", 4, tmp_path_factory.mktemp("div2d"), _spec(pair, mlp))


def _jax_reference(pair, basis_name, two_d):
    jax_cnf, params, _, x, feats_row = pair
    feats = jnp.asarray(feats_row)

    def f(xb):
        b = xb.shape[0]
        return jax_cnf.apply(params, xb, jnp.full((b,), T), jnp.tile(feats, (b, 1)))

    basis = offset = None
    if basis_name == "zero_com":
        basis, offset = jax_cnf.exact_trace_plan(params)
    if two_d:
        mesh = get_mesh_2d(n_data=2, n_trace=4)
        kwargs = dict(axis_name=TRACE_AXIS, batch_axis=DATA_AXIS)
    else:
        mesh, kwargs = get_mesh(), {}
    v, div = jax.jit(lambda xb: jax_sharded(f, xb, mesh, basis=basis, trace_offset=offset,
                                            **kwargs))(jnp.asarray(x))
    return np.asarray(v), np.asarray(div)


@pytest.mark.parametrize("basis_name", BASES)
def test_1d_mesh_matches_jax(pair, ranks_1d, basis_name):
    v_ref, div_ref = _jax_reference(pair, basis_name, two_d=False)
    v, div = ranks_1d[basis_name]
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(div.numpy(), div_ref, rtol=RTOL)


@pytest.mark.parametrize("basis_name", BASES)
def test_2d_mesh_matches_jax(pair, ranks_2d, basis_name):
    v_ref, div_ref = _jax_reference(pair, basis_name, two_d=True)
    v, div = ranks_2d[basis_name]
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(div.numpy(), div_ref, rtol=RTOL)


def test_log_prob_with_trace_mesh_matches_jax(mlp, ranks_1d):
    cnf, params, x = mlp
    cfg = JaxSolveConfig(use_fixed_step_size=True, step_size=0.1)
    ref = jax_get_log_prob(cnf, params, jnp.asarray(x), jax.random.PRNGKey(2), cfg=cfg,
                           trace_mesh=get_mesh())
    for port, jax_value in zip(ranks_1d["log_prob"], ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(jax_value), rtol=1e-4, atol=1e-5)


def test_single_process_is_the_unsharded_trace(pair):
    _, _, cnf, x, feats_row = pair
    x, feats = torch.from_numpy(x), torch.from_numpy(feats_row).long()

    def f(xb):
        return cnf.apply(xb, torch.full((xb.shape[0],), T), feats.expand(xb.shape[0], -1))

    basis, offset = cnf.exact_trace_plan()
    with torch.no_grad():
        v, div = sharded_value_and_exact_divergence(f, x, None, basis=basis, trace_offset=offset)
        v_ref, div_ref = value_and_exact_divergence(f, x, basis=basis, trace_offset=offset)
    assert torch.equal(v, v_ref) and torch.equal(div, div_ref)
