"""Leaf math of the PyTorch port vs the JAX package, on the same inputs (atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from ecnf_tpu.cnf.base import ZeroCoMGaussian as JaxBase
from ecnf_tpu.cnf.core import optimal_transport_conditional_vf as jax_ot
from ecnf_tpu.ops.divergence import zero_com_trace_basis as jax_basis
from ecnf_tpu.ops.graph import dense_edge_mask as jax_mask
from ecnf_tpu.ops.numerics import safe_norm as jax_safe_norm
from ecnf_tpu.ops.numerics import timestep_embedding as jax_temb
from ecnf_tpu_torch.cnf.base import ZeroCoMGaussian
from ecnf_tpu_torch.cnf.core import optimal_transport_conditional_vf
from ecnf_tpu_torch.ops.divergence import zero_com_trace_basis
from ecnf_tpu_torch.ops.graph import dense_edge_mask
from ecnf_tpu_torch.ops.numerics import safe_norm, timestep_embedding

ATOL = 1e-6


@pytest.mark.parametrize(
    "t_max,atol",
    [(1e-3, ATOL), (1.0, 1e-4)],
    ids=["small_angles", "full_range"],
)
@pytest.mark.parametrize("dim", [8, 32])
def test_timestep_embedding(dim, t_max, atol):
    # At t <= 1e-3 the angles t*1000*freq are <= 1 rad and the two packages
    # agree to ATOL.  Over t in [0, 1] the angles reach 1000 rad, where the
    # one-ulp difference between XLA's and torch's f32 exp of the
    # frequencies moves sin/cos by up to ~2e-5.
    t = (np.random.default_rng(0).uniform(size=7) * t_max).astype(np.float32)
    ref = np.asarray(jax_temb(jnp.asarray(t), dim))
    out = timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(out, ref, atol=atol)
    np.testing.assert_allclose(out[:, dim // 2 - 1], ref[:, dim // 2 - 1], atol=ATOL)


def test_safe_norm_and_edge_mask():
    x = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(
        safe_norm(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jax_safe_norm(jnp.asarray(x), axis=-1)), atol=ATOL,
    )
    np.testing.assert_array_equal(dense_edge_mask(5).numpy(), np.asarray(jax_mask(5)))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_zero_com_base_log_prob(scale):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 5 * 3)).astype(np.float32)  # not zero-CoM: mean removed first
    ref = np.asarray(JaxBase(5, 3, scale).log_prob(jnp.asarray(x)))
    out = ZeroCoMGaussian(5, 3, scale).log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL * np.abs(ref).max())

    noise = rng.normal(size=(6, 5, 3)).astype(np.float32)
    base = ZeroCoMGaussian(5, 3, scale)
    xs, lp = base.sample_and_log_prob((6,), noise=torch.from_numpy(noise))
    want = scale * (noise - noise.mean(axis=1, keepdims=True))
    np.testing.assert_allclose(xs.numpy(), want.reshape(6, 15), atol=ATOL)
    np.testing.assert_allclose(xs.numpy().reshape(6, 5, 3).mean(axis=1), 0.0, atol=ATOL)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(JaxBase(5, 3, scale).log_prob(jnp.asarray(xs.numpy()))),
        atol=ATOL * np.abs(lp.numpy()).max(),
    )


def test_ot_path():
    rng = np.random.default_rng(3)
    x0, x1 = rng.normal(size=(2, 4, 15)).astype(np.float32)
    t = rng.uniform(size=4).astype(np.float32)
    ref = jax_ot(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t), sigma_min=0.01)
    out = optimal_transport_conditional_vf(*map(torch.from_numpy, (x0, x1, t)), sigma_min=0.01)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_zero_com_trace_basis():
    np.testing.assert_allclose(
        zero_com_trace_basis(5, 3).numpy(), np.asarray(jax_basis(5, 3)), atol=ATOL
    )
