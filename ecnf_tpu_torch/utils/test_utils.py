"""Equivariance test harness: random rotations and an assertion helper
(port of `ecnf_tpu/utils/test_utils.py`).

Draws come from an explicit ``torch.Generator``; the matrices are built in
float32 from the same angles as JAX's.
"""
import math
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def get_rotation_matrix_from_angle_2d(angle: Tensor) -> Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def get_rotation_matrix_from_z_a1_a2(z: Tensor, a1: Tensor, a2: Tensor) -> Tensor:
    """Uniform 3-D rotation from the (z, a1, a2) parameterisation: rotate
    about x by a2, about y so the x-axis lands at height z, then about z
    by a1."""
    a0 = torch.atan2(-z, torch.sqrt(1 - z**2))
    one, zero = torch.ones_like(z), torch.zeros_like(z)

    def matrix(rows):
        return torch.stack([torch.stack(r) for r in rows])

    r1 = matrix([[one, zero, zero],
                 [zero, torch.cos(a2), -torch.sin(a2)],
                 [zero, torch.sin(a2), torch.cos(a2)]])
    r2 = matrix([[torch.cos(a0), zero, torch.sin(a0)],
                 [zero, one, zero],
                 [-torch.sin(a0), zero, torch.cos(a0)]])
    r3 = matrix([[torch.cos(a1), -torch.sin(a1), zero],
                 [torch.sin(a1), torch.cos(a1), zero],
                 [zero, zero, one]])
    return r3 @ r2 @ r1


def random_rotation_matrix(generator: torch.Generator, dim: int) -> Tensor:
    """Uniformly random rotation in 2-D or 3-D, float32, from ``generator``."""

    def uniform(lo, hi):
        return torch.rand((), generator=generator) * (hi - lo) + lo

    if dim == 3:
        z = uniform(-1.0, 1.0)
        a1 = uniform(-math.pi, math.pi)
        a2 = uniform(-math.pi, math.pi)
        return get_rotation_matrix_from_z_a1_a2(z, a1, a2)
    if dim != 2:
        raise ValueError(f"random_rotation_matrix: dim must be 2 or 3, got {dim}")
    return get_rotation_matrix_from_angle_2d(uniform(-math.pi, math.pi))


def assert_function_is_equivariant(
    equivariant_fn: Callable[[Tensor], Tensor],
    n_nodes: int,
    dim: int = 3,
    generator: Optional[torch.Generator] = None,
    atol: float = 1e-6,
) -> None:
    """Assert ``f(R x) == R f(x)`` for a random rotation R and random
    ``x [n_nodes, dim]``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.randn((n_nodes, dim), generator=generator)
    R = random_rotation_matrix(generator, dim)
    out_then_g = (R @ equivariant_fn(x).T).T
    g_then_out = equivariant_fn((R @ x.T).T)
    torch.testing.assert_close(out_then_g, g_then_out, atol=atol, rtol=atol)
