"""Numerics of the f32 kernels' tensor-core products ("3xTF32"), on the CPU.

The EGCL-forward and fused-trace kernels (`ecnf_tpu_torch/csrc/
egnn_device.cuh: dense_staged`) take every dense product on the tensor
cores in TF32: each f32 operand x is split as hi = rna(x) (round to the
nearest TF32, ties away from zero) and lo = x - hi, of which the tensor
cores read the top 19 bits (modelled as truncation to TF32), and a product
is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32.  This file models
the products in torch, the TF32 roundings done on the int32 view, and
pushes the kernels' edge-layer chain through them: a primal row block and
its tangent slots through silu layers, the tangent scaled by silu'(z) of
the primal pre-activation.  Widths: LJ13 (9 slots x 13 rows, 15 layers of
[128, 128]), QM9 (6 x 19 rows, 20 layers of [256, 256]) and a small one.

The split must keep f32 accuracy (within 1e-5 of the f32 chain, relative
to the largest output); one TF32 product must not (it misses the port's
f32 limit of 1e-4), which is why the kernels pay three products.
"""
import numpy as np
import pytest
import torch

F32_LIMIT = 1e-4  # the port's kernel-vs-plain limit in f32
SPLIT_LIMIT = 1e-5
# name: (slots, rows per slot, width, layers)
WIDTHS = {"lj13": (9, 13, 128, 15), "qm9": (6, 19, 256, 20), "small": (3, 5, 32, 4)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest TF32 (10 mantissa bits), ties away from
    zero: add half of the dropped 13 bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value a tensor core reads from an f32: the top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, truncate(x - hi)


def matmul(a: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ w`` in f32 as the given product takes it."""
    if mode == "f32":
        return a @ w
    if mode == "tf32":
        return tf32(a) @ tf32(w)
    a_hi, a_lo = split(a)
    w_hi, w_lo = split(w)
    return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi


def chain(x, weights, biases, slots, mode):
    """Primal rows x[:n] and tangent rows x[n:] through silu layers."""
    n = x.shape[0] // slots
    for w, b in zip(weights, biases):
        z = matmul(x, w, mode)
        pre = z[:n] + b
        sg = torch.sigmoid(pre)
        ds = sg * (1 + pre * (1 - sg))
        x = torch.cat([pre * sg, (z[n:].reshape(slots - 1, n, -1) * ds).reshape(-1, z.shape[1])])
    return x


def run(name: str, mode: str, dtype=torch.float32):
    slots, n, width, layers = WIDTHS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((slots * n, width))
    ws = [rng.standard_normal((width, width)) / np.sqrt(width) for _ in range(layers)]
    bs = [0.1 * rng.standard_normal(width) for _ in range(layers)]
    t = lambda a: torch.from_numpy(a).to(dtype)
    return chain(t(x), [t(w) for w in ws], [t(b) for b in bs], slots, mode if dtype == torch.float32 else "f32")


def rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def test_tf32_rounding_model():
    x = torch.tensor([1 + 2**-11, 1 + 2**-12, -(1 + 2**-11), 1 + 3 * 2**-11, 3.0], dtype=torch.float32)
    # Ties go away from zero; below a tie goes down; TF32 values stay.
    expected = torch.tensor([1 + 2**-10, 1.0, -(1 + 2**-10), 1 + 2 * 2**-10, 3.0])
    torch.testing.assert_close(tf32(x), expected, rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(r)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - hi).abs() <= hi.abs() * 2**-11).all()
    # hi + lo carries 20 or more of the 24 mantissa bits.
    assert ((r.double() - (hi.double() + lo.double())).abs() <= r.double().abs() * 2**-20).all()



@pytest.mark.parametrize("name", list(WIDTHS))
def test_split_product_keeps_f32_accuracy(name):
    ref = run(name, "f32", torch.float64)
    f32, split3 = run(name, "f32"), run(name, "3xtf32")
    assert torch.isfinite(split3).all()
    assert rel(split3, f32) <= SPLIT_LIMIT
    # As accurate as the f32 chain itself, measured against f64.
    assert rel(split3, ref) <= 2 * max(rel(f32, ref), 1e-7)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_single_tf32_misses_the_f32_limit(name):
    f32, single = run(name, "f32"), run(name, "tf32")
    assert rel(single, f32) > F32_LIMIT
