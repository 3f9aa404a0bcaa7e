"""Base distributions (port of `ecnf_tpu/cnf/base.py`): the zero-centre-of-mass
Gaussian of the molecular CNFs and the diagonal Gaussian of the MoG CNF.

The zero-CoM density lives on the ``(N-1)*D``-dimensional hyperplane:
``log p(x) = -0.5 ||x/s||^2 - 0.5 (N-1) D log(2 pi) - (N-1) D log(s)``.
Sampling removes the per-sample mean of an iid Gaussian.
"""
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def remove_mean(x: Tensor) -> Tensor:
    """Subtract the node-axis mean: ``[..., N, D] -> [..., N, D]``."""
    return x - x.mean(dim=-2, keepdim=True)


def centre_gravity_zero_gaussian_log_likelihood(x: Tensor) -> Tensor:
    """Log density of the unit zero-CoM Gaussian at zero-CoM ``x [..., N, D]``."""
    N, D = x.shape[-2:]
    r2 = (x**2).sum(dim=(-1, -2))
    dof = (N - 1) * D
    return -0.5 * r2 - 0.5 * dof * math.log(2 * math.pi)


@dataclass(frozen=True)
class ZeroCoMGaussian:
    """Scaled Gaussian on the zero-CoM hyperplane, flat ``[..., N*D]`` coordinates."""

    n_nodes: int
    dim: int
    scale: float = 1.0

    @property
    def event_dim(self) -> int:
        return self.n_nodes * self.dim

    @property
    def degrees_of_freedom(self) -> int:
        return (self.n_nodes - 1) * self.dim

    def _unflatten(self, x_flat: Tensor) -> Tensor:
        return x_flat.reshape(*x_flat.shape[:-1], self.n_nodes, self.dim)

    def sample(
        self,
        batch_shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        device=None,
    ) -> Tensor:
        """Draw ``[*batch_shape, N*D]`` flat samples.

        ``noise`` (``[*batch_shape, N, D]`` or flat, standard normal) is used
        instead of a draw from ``generator`` when given.  The draw is made
        on the generator's device and moved to ``device``, so one seed gives
        the same points on every device.
        """
        shape = (*batch_shape, self.n_nodes, self.dim)
        if noise is None:
            gen_device = generator.device if generator is not None else device
            z = torch.randn(shape, generator=generator, device=gen_device)
            z = z.to(device) if device is not None else z
        else:
            z = noise.reshape(shape)
        return (self.scale * remove_mean(z)).reshape(*batch_shape, self.event_dim)

    def log_prob(self, x_flat: Tensor) -> Tensor:
        """Log density at flat ``[..., N*D]`` points (mean removed first)."""
        x = remove_mean(self._unflatten(x_flat) / self.scale)
        base = centre_gravity_zero_gaussian_log_likelihood(x)
        return base - self.degrees_of_freedom * math.log(self.scale)

    def sample_and_log_prob(
        self,
        batch_shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        device=None,
    ) -> Tuple[Tensor, Tensor]:
        x = self.sample(batch_shape, generator=generator, noise=noise, device=device)
        return x, self.log_prob(x)


@dataclass(frozen=True)
class DiagGaussian:
    """Isotropic Gaussian base on flat ``[..., dim]`` coordinates, for
    targets without nodes (the 2-D MoG)."""

    dim: int
    scale: float = 1.0

    @property
    def event_dim(self) -> int:
        return self.dim

    def sample(
        self,
        batch_shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        device=None,
    ) -> Tensor:
        """Draw ``[*batch_shape, dim]`` samples; ``noise`` (standard normal)
        and ``device`` as in `ZeroCoMGaussian.sample`."""
        shape = (*batch_shape, self.dim)
        if noise is None:
            gen_device = generator.device if generator is not None else device
            z = torch.randn(shape, generator=generator, device=gen_device)
            z = z.to(device) if device is not None else z
        else:
            z = noise.reshape(shape)
        return self.scale * z

    def log_prob(self, x: Tensor) -> Tensor:
        d = self.dim
        r2 = ((x / self.scale) ** 2).sum(dim=-1)
        return -0.5 * r2 - 0.5 * d * math.log(2 * math.pi) - d * math.log(self.scale)

    def sample_and_log_prob(
        self,
        batch_shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        device=None,
    ) -> Tuple[Tensor, Tensor]:
        x = self.sample(batch_shape, generator=generator, noise=noise, device=device)
        return x, self.log_prob(x)
