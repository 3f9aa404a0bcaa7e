"""The port's equivariance harness (`ecnf_tpu_torch/utils/test_utils.py`)
against the JAX module: the same angles give the same matrices (within a
few f32 ulps: torch's and XLA's sin and cos may round differently), every
draw is a rotation, and the assertion accepts an equivariant function and
refuses one that is not."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecnf_tpu.utils import test_utils as jax_tu
from ecnf_tpu_torch.utils import test_utils as tu

ANGLES = np.linspace(-np.pi, np.pi, 13, dtype=np.float32)
ATOL = 4e-7  # ~3 f32 ulps of 1


def test_2d_matrices_match_jax():
    for a in ANGLES:
        ref = np.asarray(jax_tu.get_rotation_matrix_from_angle_2d(jnp.float32(a)))
        out = tu.get_rotation_matrix_from_angle_2d(torch.tensor(a)).numpy()
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_3d_matrices_match_jax():
    rng = np.random.default_rng(0)
    zs = np.concatenate([[-1.0, 0.0, 1.0], rng.uniform(-1, 1, 9)]).astype(np.float32)
    for z in zs:
        a1, a2 = rng.uniform(-np.pi, np.pi, 2).astype(np.float32)
        ref = np.asarray(jax_tu.get_rotation_matrix_from_z_a1_a2(*map(jnp.float32, (z, a1, a2))))
        out = tu.get_rotation_matrix_from_z_a1_a2(*map(torch.tensor, (z, a1, a2))).numpy()
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_every_draw_is_a_rotation(dim):
    gen = torch.Generator().manual_seed(dim)
    draws = torch.stack([tu.random_rotation_matrix(gen, dim) for _ in range(200)]).double()
    eye = torch.eye(dim, dtype=torch.float64).expand_as(draws)
    torch.testing.assert_close(draws @ draws.transpose(1, 2), eye, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.linalg.det(draws), torch.ones(200, dtype=torch.float64),
                               rtol=0, atol=1e-6)
    # Spread over the group, not one fixed matrix.
    assert draws.std(dim=0).min() > 0.3
    with pytest.raises(ValueError, match="dim"):
        tu.random_rotation_matrix(gen, 4)


@pytest.mark.parametrize("dim", [2, 3])
def test_assertion_accepts_equivariant_and_refuses_other_functions(dim):
    def equivariant(x):
        centred = x - x.mean(dim=0)
        return centred * (centred**2).sum(dim=-1, keepdim=True)

    tu.assert_function_is_equivariant(equivariant, 5, dim, atol=1e-5)
    with pytest.raises(AssertionError):
        tu.assert_function_is_equivariant(lambda x: x + 1.0, 5, dim, atol=1e-5)
