"""ConcatDense and MLP (port of `ecnf_tpu/models/mlp.py`).

Weights are stored in float32 in torch's ``[out, in]`` layout; activations
and matmuls run in an optional compute dtype (bf16), as flax does with
``dtype``.  A first layer over ``concat([a, b, ...])`` is computed as a sum
of split matmuls over one kernel sliced per input.
"""
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

# Standard deviation of a unit normal truncated to (-2, 2).
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(w: Tensor, std: float, generator: Optional[torch.Generator]) -> Tensor:
    """Fill ``w`` from N(0, std^2) truncated to ``(-2 std, 2 std)``."""
    lo = math.erf(-2.0 / math.sqrt(2.0))
    hi = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(lo, hi, generator=generator).erfinv_().mul_(std * math.sqrt(2.0))
    return w


class ConcatDense(nn.Module):
    """``Dense(features)(concat(inputs, -1))`` as split matmuls.

    ``output_scale=None`` initialises the kernel like flax's default
    (truncated lecun-normal); a float ``s`` initialises it like
    ``variance_scaling(s, "fan_avg", "uniform")`` (``0.0`` gives
    ``zeros_init()``'s zeros).  Biases start at zero.
    """

    def __init__(
        self,
        in_widths: Sequence[int],
        features: int,
        compute_dtype: Optional[torch.dtype] = None,
        output_scale: Optional[float] = None,
    ):
        super().__init__()
        self.in_widths = tuple(int(w) for w in in_widths)
        self.compute_dtype = compute_dtype
        self.output_scale = output_scale
        self.weight = nn.Parameter(torch.empty(features, sum(self.in_widths)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_out, fan_in = self.weight.shape
        with torch.no_grad():
            if self.output_scale is None:
                truncated_normal_(self.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)
            else:
                limit = math.sqrt(3.0 * self.output_scale / ((fan_in + fan_out) / 2.0))
                self.weight.uniform_(-limit, limit, generator=generator)
            self.bias.zero_()

    def forward(self, *inputs: Tensor) -> Tensor:
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            w, b = w.to(self.compute_dtype), b.to(self.compute_dtype)
            inputs = tuple(x.to(self.compute_dtype) for x in inputs)
        out = None
        for x, k in zip(inputs, w.split(self.in_widths, dim=1)):
            part = x @ k.T
            out = part if out is None else out + part
        return out + b


class MLP(nn.Module):
    """Plain MLP; variadic inputs are fused into the first layer.

    ``layers[0]`` is flax's ``ConcatDense_0`` and ``layers[n + 1]`` its
    ``Dense_n``.
    """

    def __init__(
        self,
        in_widths: Sequence[int],
        features: Sequence[int],
        activate_final: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        feats = tuple(features)
        widths = [tuple(in_widths)] + [(f,) for f in feats[:-1]]
        self.layers = nn.ModuleList(
            ConcatDense(w, f, compute_dtype) for w, f in zip(widths, feats)
        )
        self.activate_final = activate_final

    def forward(self, *inputs: Tensor) -> Tensor:
        x = self.layers[0](*inputs)
        for layer in self.layers[1:]:
            x = layer(F.silu(x))
        if self.activate_final:
            x = F.silu(x)
        return x


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis: ``epsilon=1e-6``, the
    statistics in f32 as ``E[x^2] - E[x]^2`` (clamped at 0), scale and
    bias f32.  A bf16 input is promoted, so the output is f32 (flax's
    promotion when the layer is given no ``dtype``)."""

    def __init__(self, width: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class NonLinearLayerWithResidualAndLayerNorm(nn.Module):
    """``silu(Dense(LayerNorm(x))) + x`` (flax's submodules ``LayerNorm_0``
    and ``Dense_0``).  As in the JAX package neither layer gets the compute
    dtype, so with bf16 activations both run in f32 and so does the sum."""

    def __init__(self, width: int):
        super().__init__()
        self.norm = LayerNorm(width)
        self.dense = ConcatDense((width,), width)

    def forward(self, x: Tensor) -> Tensor:
        return F.silu(self.dense(self.norm(x))) + x


class StableMLP(nn.Module):
    """MLP of LayerNorm + residual blocks (port of `ecnf_tpu/models/mlp.py:
    StableMLP`, reference `ecnf/nets/mlp.py:32-72`).

    ``first`` is flax's ``ConcatDense_0`` (variadic inputs fused as in
    `MLP`, compute dtype), ``residual[k]`` its
    ``NonLinearLayerWithResidualAndLayerNorm_k`` (f32, see there) and
    ``out`` its output ``Dense_0`` (compute dtype; absent with
    ``activate_final``).  The output kernel starts as flax's default,
    at zero (``zero_init_output``) or from ``variance_scaling(s,
    "fan_avg", "uniform")`` (``output_variance_scaling=s``).
    """

    def __init__(
        self,
        in_widths: Sequence[int],
        mlp_units: Sequence[int],
        activate_final: bool = False,
        zero_init_output: bool = False,
        output_variance_scaling: Optional[float] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        units = tuple(mlp_units)
        if not activate_final and len(units) < 2:
            raise ValueError("MLP is single linear layer with no non-linearity")
        activated = units if activate_final else units[:-1]
        if len(set(activated)) != 1:
            raise ValueError(f"StableMLP needs constant width, got {units}")
        if activate_final and (zero_init_output or output_variance_scaling):
            raise ValueError("an output-layer init needs activate_final=False")
        self.first = ConcatDense(in_widths, activated[0], compute_dtype)
        self.residual = nn.ModuleList(
            NonLinearLayerWithResidualAndLayerNorm(w) for w in activated[1:]
        )
        self.out = None
        if not activate_final:
            scale = 0.0 if zero_init_output else (output_variance_scaling or None)
            self.out = ConcatDense((activated[-1],), units[-1], compute_dtype, output_scale=scale)

    def forward(self, *inputs: Tensor) -> Tensor:
        x = F.silu(self.first(*inputs))
        for layer in self.residual:
            x = layer(x)
        return x if self.out is None else self.out(x)
