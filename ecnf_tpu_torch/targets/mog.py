"""2-D mixture-of-Gaussians target (port of `ecnf_tpu/targets/mog.py`).

Eight equally weighted components with per-dimension scale ``softplus(0.1)``
and means ``jax.random.uniform(PRNGKey(seed), (8, 2), -1, 1) * 10``.  The
means are defined by JAX's threefry stream, so `jax_uniform` computes that
draw in numpy, bit for bit, without JAX: ``PRNGKey(seed)`` is the key
``(0, seed)``; each element's 64-bit flat index, split into its high and
low 32-bit words, is hashed by threefry-2x32 (20 rounds) under the key,
and the two output words are XORed (the ``jax_threefry_partitionable``
layout, JAX's default); the top 23 bits become an f32 mantissa in [1, 2),
less 1, scaled to [minval, maxval) and clamped at minval.  Checked against
JAX 0.9 on the CPU (`tests/test_torch_mog.py`).
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counters ``(x0, x1)`` (uint32)."""
    ks = [np.uint32(key[0]), np.uint32(key[1])]
    ks.append(ks[0] ^ ks[1] ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def jax_uniform(seed: int, shape: Tuple[int, ...], minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape, float32, minval,
    maxval)`` for a seed in [0, 2**32)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    index = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32((0, seed), hi, lo)
    bits = b1 ^ b2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo_f, hi_f = np.float32(minval), np.float32(maxval)
    # XLA fuses the scale and the shift into one fused multiply-add (one
    # rounding); in float64 both are exact, and the cast rounds once.
    scaled = floats.astype(np.float64) * np.float64(hi_f - lo_f) + np.float64(lo_f)
    return np.maximum(lo_f, scaled.astype(np.float32)).reshape(shape)


@dataclass(frozen=True)
class MoGTarget:
    n_mixes: int = 8
    dim: int = 2
    loc_scaling: float = 10.0
    log_var_scaling: float = 0.1
    seed: int = 0

    @property
    def means(self) -> Tensor:
        u = jax_uniform(self.seed, (self.n_mixes, self.dim), -1.0, 1.0)
        return torch.from_numpy(u * np.float32(self.loc_scaling))

    @property
    def scales(self) -> Tensor:
        """``softplus(log_var_scaling)`` in every entry (the reference passes
        the softplus of its "log variance" as the scale), rounded to f32
        from float64."""
        v = np.float32(self.log_var_scaling).astype(np.float64)
        value = np.float32(np.logaddexp(v, 0.0))
        return torch.full((self.n_mixes, self.dim), float(value), dtype=torch.float32)

    def log_prob(self, x: Tensor) -> Tensor:
        """``[..., dim]`` -> ``[...]`` mixture log-density."""
        means, scales = self.means.to(x.device), self.scales.to(x.device)
        z = (x[..., None, :] - means) / scales
        comp = (-0.5 * (z**2).sum(dim=-1) - torch.log(scales).sum(dim=-1)
                - 0.5 * self.dim * np.log(2 * np.pi))
        return torch.logsumexp(comp, dim=-1) - np.log(self.n_mixes)

    def sample(self, shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
               device=None) -> Tensor:
        """``[*shape, dim]`` samples: components then noise from ``generator``
        (on its device), moved to ``device``."""
        gen_device = generator.device if generator is not None else device
        comps = torch.randint(0, self.n_mixes, shape, generator=generator, device=gen_device)
        eps = torch.randn((*shape, self.dim), generator=generator, device=gen_device)
        means, scales = self.means.to(gen_device), self.scales.to(gen_device)
        out = means[comps] + eps * scales[comps]
        return out.to(device) if device is not None else out
