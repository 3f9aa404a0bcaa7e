"""Primal edge chain of one EGCL block with its residuals: CUDA kernel and
plain version.

`edge_primal` computes, from the sender and receiver rows of phi_e's
first layer (``a = h @ e_s``, ``b = h @ e_r``, ``[B, N, U]``) and the
squared distances ``l2 [B, N, N]``, everything the residual-capturing
primal (`ops.tangent.block_forward`) builds at edge level: phi_e's and
phi_x's silu' factors ``d_e``, ``d_x`` (L x ``[B, N, N, U]``), the messages
``m``, phi_x's output ``phi`` (f32 ``[B, N, N]``), the gate ``g`` and its
derivative ``gd``, and the masked, scaled sender sum ``m_i`` (f32
``[B, N, U]``).  It replaces no Pallas kernel: on the TPU XLA fused these
epilogues into the products.

- On CUDA tensors it launches the hand-written kernel in
  ``csrc/edge_primal.cu`` (built by `ops.cuda_build` at first use).  The
  kernel runs bf16 weights only; a width U that it does not take (it takes
  32, 64, 128 and 256) is zero-padded to the next one (as
  `ops.edge_tangent.pad_units` pads) and the outputs cut back to U.  It
  raises on anything else; there is no fallback.
- On CPU tensors it runs `edge_primal_reference`, the same math in plain
  torch ops, which is also the kernel's oracle.

`block_forward` routes to the kernel only where `kernel_takes` holds (a
card, bf16 weights, shapes the kernel takes), when residuals are asked for
and its caller passed ``use_kernel=True``; everything else takes the plain
version.  ``edge_primal.launch_count`` counts kernel launches; while
`ops.flops.count_fn_flops` runs, each launch adds `edge_primal_flops` of
its unpadded shapes to the count.
"""
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ecnf_tpu_torch.ops import flops
from ecnf_tpu_torch.ops.cuda_build import check_tensor, load_library
from ecnf_tpu_torch.ops.edge_tangent import kernel_units
from ecnf_tpu_torch.ops.graph import dense_edge_mask

Tensor = torch.Tensor

_MAX_LAYERS = 8
_MAX_NODES = 64  # the kernel's kMaxEdgeNodes
_MAX_UNITS = 256


class EdgePrimal(NamedTuple):
    """The edge chain's outputs; ``d_e``, ``d_x`` are empty and ``gd`` None
    when residuals were not asked for."""

    d_e: Tuple[Tensor, ...]  # phi_e silu' factors    L x [B, N, N, U] cd
    d_x: Tuple[Tensor, ...]  # phi_x silu' factors    L x [B, N, N, U] cd
    m: Tensor  # edge messages m_ij                   [B, N, N, U] cd
    phi: Tensor  # phi_x output                       [B, N, N] f32
    g: Tensor  # gate                                 [B, N, N] cd
    gd: Optional[Tensor]  # g * (1 - g)               [B, N, N] cd
    m_i: Tensor  # masked, scaled sender sum          [B, N, U] f32


def dsilu(x: Tensor) -> Tensor:
    """d/dx silu(x) = sigmoid(x) * (1 + x * (1 - sigmoid(x)))."""
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def edge_primal_reference(a: Tensor, b: Tensor, l2: Tensor, wt, with_residuals: bool = True) -> EdgePrimal:
    """Plain-torch edge chain of `block_forward`, in the dtype of ``a``.

    Args:
        a, b: ``[B, N, U]`` cd, ``h @ wt.e_s`` and ``h @ wt.e_r``.
        l2: ``[B, N, N]`` f32 squared distances (clamped).
        wt: the block's `ops.tangent.BlockWeights`.
        with_residuals: also return the silu' factors and ``gd``.
    """
    N = a.shape[1]
    cd = a.dtype
    mask = dense_edge_mask(N, l2.dtype, l2.device)

    def layer(z, ds):
        if with_residuals:
            ds.append(dsilu(z))
        return F.silu(z)

    z = (
        a[:, None, :, :]
        + b[:, :, None, :]
        + l2[..., None].to(cd) * wt.e_l
        + wt.e_b[0]
    )
    d_e = []
    h = layer(z, d_e)
    for k, bias in zip(wt.e_tail, wt.e_b[1:]):
        h = layer(h @ k + bias, d_e)
    m = h

    d_x = []
    for k, bias in zip(wt.x_tail, wt.x_b):
        h = layer(h @ k + bias, d_x)
    phi = (h @ wt.x_out + wt.x_out_b).to(l2.dtype)

    g = torch.sigmoid(m @ wt.g_out + wt.g_out_b)
    m_i = ((m * g[..., None]).to(l2.dtype) * mask[None, :, :, None]).sum(
        dim=2
    ) / math.sqrt(N - 1)
    gd = g * (1.0 - g) if with_residuals else None
    return EdgePrimal(tuple(d_e), tuple(d_x), m, phi, g, gd, m_i)


def edge_primal_flops(B: int, N: int, U: int, L: int, dtype: torch.dtype) -> flops.FlopCount:
    """Matmul FLOPs of `edge_primal_reference` at these shapes, as
    `ops.flops.count_fn_flops` counts them: over the B N^2 edge rows, the
    2L - 1 ``[U, U]`` layers and the two Dense(1) columns (phi_x's output
    and the gate), all in ``dtype``."""
    rows = B * N * N
    return flops.bucket(2.0 * rows * U * (U * (2 * L - 1) + 2), dtype)


def _shapes_taken(N: int, U: int, L: int) -> bool:
    """2 <= N <= 64, U <= 256 (zero-padded to a width the kernel takes),
    1 <= L <= 8."""
    return 2 <= N <= _MAX_NODES and 1 <= U <= _MAX_UNITS and 1 <= L <= _MAX_LAYERS


def kernel_takes(device: torch.device, dtype: torch.dtype, N: int, U: int, L: int) -> bool:
    """Whether the kernel takes these: a card, bf16 and `_shapes_taken`."""
    return device.type == "cuda" and dtype == torch.bfloat16 and _shapes_taken(N, U, L)


def _padded(a: Tensor, b: Tensor, wt, width: int) -> tuple:
    """``a``, ``b`` and the weights the kernel reads, with the units
    zero-padded from U to ``width``.  A padded unit's pre-activation is 0 at
    every layer (its inputs, weight rows and columns and biases are zero),
    so it adds nothing to the real units, to ``phi`` or to ``g`` (its
    ``x_out`` and ``g_out`` entries are zero either way)."""
    U = a.shape[-1]
    vec = lambda x: F.pad(x, (0, width - U))
    mat = lambda x: F.pad(x, (0, width - U, 0, width - U))
    return (vec(a), vec(b), vec(wt.e_l), [vec(x) for x in wt.e_b], [mat(k) for k in wt.e_tail],
            [mat(k) for k in wt.x_tail], [vec(x) for x in wt.x_b], vec(wt.x_out), vec(wt.g_out))


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("edge_primal")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ecnf_edge_primal.argtypes = [i32] * 4 + [ptr] * 20
    lib.ecnf_edge_primal.restype = i32
    return lib


def _pointers(xs):
    return (ctypes.c_void_p * _MAX_LAYERS)(*[x.data_ptr() for x in xs])


def edge_primal(a: Tensor, b: Tensor, l2: Tensor, wt) -> EdgePrimal:
    """Edge chain with residuals (see `edge_primal_reference` for the
    contract).

    The kernel takes bf16 only: ``a``, ``b`` and the weights bf16, ``l2``
    f32, every tensor contiguous, 2 <= N <= 64, U <= 256, 1 <= L <= 8; it
    raises on anything else, on any device.  CPU tensors then take the
    plain version; CUDA tensors launch the kernel on the current stream,
    without synchronising.
    """
    B, N, U = a.shape
    L = len(wt.e_b)
    cd, dev = a.dtype, a.device
    if cd != torch.bfloat16:
        raise TypeError(f"edge_primal: the kernel takes bfloat16, got {cd}")
    if not _shapes_taken(N, U, L):
        raise ValueError(f"edge_primal: unsupported N={N}, U={U}, L={L}")
    if len(wt.e_tail) != L - 1 or len(wt.x_tail) != L or len(wt.x_b) != L:
        raise ValueError("edge_primal: inconsistent layer counts")
    if dev.type == "cpu":
        return edge_primal_reference(a, b, l2, wt)
    if dev.type != "cuda":
        raise ValueError(f"edge_primal: unsupported device {dev}")
    check_tensor("a", a, (B, N, U), cd, dev)
    check_tensor("b", b, (B, N, U), cd, dev)
    check_tensor("l2", l2, (B, N, N), torch.float32, dev)
    for name, x in (("e_l", wt.e_l), ("x_out", wt.x_out), ("g_out", wt.g_out)):
        check_tensor(name, x, (U,), cd, dev)
    for name, x in (("x_out_b", wt.x_out_b), ("g_out_b", wt.g_out_b)):
        check_tensor(name, x, (), cd, dev)
    for name, xs, shape in (("e_b", wt.e_b, (U,)), ("x_b", wt.x_b, (U,)),
                            ("e_tail", wt.e_tail, (U, U)), ("x_tail", wt.x_tail, (U, U))):
        for l, x in enumerate(xs):
            check_tensor(f"{name}[{l}]", x, shape, cd, dev)

    width = kernel_units(U)
    e_l, e_b, e_tail, x_tail, x_b, x_out, g_out = (
        wt.e_l, wt.e_b, wt.e_tail, wt.x_tail, wt.x_b, wt.x_out, wt.g_out)
    if width != U:
        a, b, e_l, e_b, e_tail, x_tail, x_b, x_out, g_out = _padded(a, b, wt, width)
    edge = lambda: torch.empty((B, N, N, width), dtype=cd, device=dev)
    d_e = [edge() for _ in range(L)]
    d_x = [edge() for _ in range(L)]
    m = edge()
    phi = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    g = torch.empty((B, N, N), dtype=cd, device=dev)
    gd = torch.empty((B, N, N), dtype=cd, device=dev)
    m_i = torch.empty((B, N, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().ecnf_edge_primal(
            B, N, width, L, a.data_ptr(), b.data_ptr(), l2.data_ptr(), e_l.data_ptr(),
            _pointers(e_b), _pointers(e_tail), _pointers(x_tail), _pointers(x_b),
            x_out.data_ptr(), wt.x_out_b.data_ptr(), g_out.data_ptr(), wt.g_out_b.data_ptr(),
            _pointers(d_e), _pointers(d_x), m.data_ptr(), phi.data_ptr(), g.data_ptr(),
            gd.data_ptr(), m_i.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"edge_primal: kernel launch failed (cudaError {err}) for B={B} N={N} U={U} L={L}"
        )
    edge_primal.launch_count += 1
    if flops.counting():
        flops.add(edge_primal_flops(B, N, U, L, cd))
    if width != U:
        cut = lambda x: x[..., :U].contiguous()
        d_e, d_x, m, m_i = [cut(x) for x in d_e], [cut(x) for x in d_x], cut(m), cut(m_i)
    return EdgePrimal(tuple(d_e), tuple(d_x), m, phi, g, gd, m_i)


edge_primal.launch_count = 0
