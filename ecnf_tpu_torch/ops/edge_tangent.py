"""Edge-level tangent chain of one EGCL block: CUDA kernel and plain version.

`edge_tangent` is the port of the Pallas kernel `_edge_tangent_kernel`
(`ecnf_tpu/ops/pallas/tangent_kernel.py`, math `_edge_tangent_math`).  For
K tangent columns it pushes the first-layer edge tangent through the phi_e
tail, the phi_x chain and the gate, returning ``phi_t [K, B, N, N]`` and
``mi_t [K, B, N, U]`` in f32.

- On CUDA tensors it launches the hand-written kernel in
  ``csrc/edge_tangent.cu`` (built by `ops.cuda_build` at first use).  A
  width U that the kernel does not take (it takes 32, 64, 128 and 256) is
  zero-padded to the next one it takes (`pad_units`) and ``mi_t`` cut back
  to U.  It raises on anything else the kernel does not take; there is no
  fallback.
- On CPU tensors it runs `edge_tangent_reference`, the same math in plain
  torch ops, which is also the kernel's oracle.

A thread block of the kernel takes C tangent columns of one (receiver,
sample), the N sender rows of each, for 2 <= N <= 64; C comes from the
kernel's cost model (`default_columns`) unless the caller passes
``columns_per_block``.  Shapes with no C that fits the card's shared
memory and registers raise (in float32: U = 256 past 48 nodes).
``edge_tangent.launch_count`` counts kernel launches; while
`ops.flops.count_fn_flops` runs, each launch adds `edge_tangent_flops` of
its unpadded shapes to the count.
"""
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ecnf_tpu_torch.ops import flops
from ecnf_tpu_torch.ops.cuda_build import check_tensor, load_library
from ecnf_tpu_torch.ops.graph import dense_edge_mask

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LAYERS = 8
_MAX_NODES = 64  # the kernel's kMaxEdgeNodes
_UNITS = (32, 64, 128, 256)


def edge_tangent_reference(
    a_t: Tensor, b_t: Tensor, l2_t: Tensor,
    d_e: Sequence[Tensor], d_x: Sequence[Tensor], m: Tensor, g: Tensor,
    gd: Tensor, e_l: Tensor, e_tail: Sequence[Tensor],
    x_tail: Sequence[Tensor], x_out: Tensor, g_out: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Plain-torch edge tangent chain, vectorised over the K columns.

    Args:
        a_t, b_t: ``[K, B, N, U]`` cd, first-layer sender / receiver tangents.
        l2_t: ``[K, B, N, N]`` f32 squared-distance tangent.
        d_e, d_x: L x ``[B, N, N, U]`` cd silu' factors of phi_e / phi_x.
        m: ``[B, N, N, U]`` cd edge messages; g, gd: ``[B, N, N]`` cd gate
        and its derivative.
        e_l: ``[U]`` cd length row of phi_e's first layer;
        e_tail: (L-1) x ``[U, U]``; x_tail: L x ``[U, U]`` (``[in, out]``);
        x_out, g_out: ``[U]`` output columns of phi_x and the gate.

    Returns:
        ``(phi_t [K, B, N, N] f32, mi_t [K, B, N, U] f32)``.  A cd matmul
        accumulates in f32 and rounds its output to cd, which is the JAX
        math's ``cast(f32 product)``.
    """
    K, B, N, U = a_t.shape
    cd = a_t.dtype
    z_t = (
        a_t[:, :, None, :, :]
        + b_t[:, :, :, None, :]
        + l2_t[..., None].to(cd) * e_l.reshape(U)
    )
    t = d_e[0] * z_t
    for d, k in zip(d_e[1:], e_tail):
        t = d * (t @ k)
    m_t = t  # [K, B, N, N, U] cd

    p = m_t
    for d, k in zip(d_x, x_tail):
        p = d * (p @ k)
    phi_t = (p.float() @ x_out.float().reshape(U, 1))[..., 0]

    g_t = gd[..., None] * (m_t @ g_out.reshape(U, 1))
    mask = dense_edge_mask(N, torch.float32, a_t.device)
    mi_t = ((m_t * g[..., None] + m * g_t).float() * mask[:, :, None]).sum(
        dim=3
    ) / math.sqrt(N - 1)
    return phi_t, mi_t


def edge_tangent_flops(K: int, B: int, N: int, U: int, L: int, dtype: torch.dtype) -> flops.FlopCount:
    """Matmul FLOPs of `edge_tangent_reference` at these shapes, as
    `ops.flops.count_fn_flops` counts them: over the K B N^2 edge rows, the
    2L - 1 ``[U, U]`` layers and the gate's ``m_t @ g_out`` in ``dtype``, and
    phi_x's ``p @ x_out`` in f32 (the plain version casts both to f32)."""
    rows = K * B * N * N
    return flops.bucket(2.0 * rows * U * (U * (2 * L - 1) + 1), dtype) + flops.FlopCount(
        f32=2.0 * rows * U
    )


def kernel_units(U: int) -> int:
    """The smallest width the kernel takes that is at least ``U``."""
    for width in _UNITS:
        if U <= width:
            return width
    raise ValueError(f"edge_tangent: U={U} is wider than the kernel's {_UNITS[-1]}")


def pad_units(
    a_t: Tensor, b_t: Tensor, l2_t: Tensor,
    d_e: Sequence[Tensor], d_x: Sequence[Tensor], m: Tensor, g: Tensor,
    gd: Tensor, e_l: Tensor, e_tail: Sequence[Tensor],
    x_tail: Sequence[Tensor], x_out: Tensor, g_out: Tensor, width: int,
) -> tuple:
    """The edge chain's arguments with the units zero-padded from U to
    ``width``: the ``[.., U]`` tangents and residuals, and the weights'
    rows and columns.  The chain's outputs are unchanged by it: a padded
    unit's tangent is zero at the first layer (its inputs and ``e_l`` entry
    are zero), each layer keeps it zero (its rows and columns of the
    ``[U, U]`` weights are zero, and its silu' factor multiplies a zero),
    and its ``x_out`` and ``g_out`` entries are zero, so ``phi_t`` is the
    same and the padded units of ``mi_t`` are zero."""
    U = a_t.shape[-1]
    vec = lambda x: F.pad(x, (0, width - U))
    mat = lambda x: F.pad(x, (0, width - U, 0, width - U))
    return (vec(a_t), vec(b_t), l2_t, [vec(d) for d in d_e], [vec(d) for d in d_x], vec(m), g, gd,
            vec(e_l), [mat(k) for k in e_tail], [mat(k) for k in x_tail], vec(x_out), vec(g_out))


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("edge_tangent")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ecnf_edge_tangent.argtypes = [i32] * 7 + [ptr] * 16
    lib.ecnf_edge_tangent.restype = i32
    lib.ecnf_edge_tangent_columns.argtypes = [i32] * 6
    lib.ecnf_edge_tangent_columns.restype = i32
    lib.ecnf_edge_tangent_plan.argtypes = [i32] * 7 + [ctypes.POINTER(i32)] * 4
    lib.ecnf_edge_tangent_plan.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def default_columns(device_index: int, dtype: torch.dtype, K: int, B: int, N: int, U: int,
                    L: int) -> int:
    """Tangent columns per thread block that the kernel's cost model picks
    for a card."""
    with torch.cuda.device(device_index):
        cols = _library().ecnf_edge_tangent_columns(_DTYPE_CODES[dtype], K, B, N, U, L)
    if cols < 1:
        raise ValueError(f"edge_tangent: unsupported shapes K={K} B={B} N={N} U={U} L={L}")
    return cols


def launch_plan(device_index: int, dtype: torch.dtype, K: int, B: int, N: int, U: int,
                L: int, columns: int) -> dict:
    """How a launch with ``columns`` per thread block sits on the card: its
    dynamic shared memory per block, thread blocks per SM, row tiles per
    warp, and whether the residual rows are staged in shared memory."""
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device_index):
        err = _library().ecnf_edge_tangent_plan(
            _DTYPE_CODES[dtype], K, B, N, U, L, columns, *[ctypes.byref(o) for o in out]
        )
    if err != 0:
        raise ValueError(f"edge_tangent: {columns} columns per block do not launch (cudaError {err})")
    keys = ("smem_bytes", "blocks_per_sm", "row_tiles", "staged")
    return dict(zip(keys, (o.value for o in out)))


def _pointers(xs: Sequence[Tensor]):
    return (ctypes.c_void_p * _MAX_LAYERS)(*[x.data_ptr() for x in xs])


def edge_tangent(
    a_t: Tensor, b_t: Tensor, l2_t: Tensor,
    d_e: Sequence[Tensor], d_x: Sequence[Tensor], m: Tensor, g: Tensor,
    gd: Tensor, e_l: Tensor, e_tail: Sequence[Tensor],
    x_tail: Sequence[Tensor], x_out: Tensor, g_out: Tensor,
    columns_per_block: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Edge tangent chain (see `edge_tangent_reference` for the contract).

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream, without synchronising; the arguments must match
    the documented shapes exactly, be contiguous and share one dtype
    (float32 or bfloat16; ``l2_t`` is always float32), with 2 <= N <= 64.
    A U of at most 256 that the kernel does not take is zero-padded
    (`pad_units`), which leaves the outputs as they are.
    ``columns_per_block`` overrides the kernel's choice of tangent columns
    per thread block; it must be at least 1, and a value that does not
    launch raises.  The outputs do not depend on it beyond the order of
    f32 sums inside the tensor-core products.
    """
    if columns_per_block is not None and columns_per_block < 1:
        raise ValueError(f"edge_tangent: columns_per_block must be >= 1, got {columns_per_block}")
    args = (a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l, e_tail, x_tail, x_out, g_out)
    if a_t.device.type == "cpu":
        return edge_tangent_reference(*args)
    if a_t.device.type != "cuda":
        raise ValueError(f"edge_tangent: unsupported device {a_t.device}")
    K, B, N, U = a_t.shape
    L = len(d_e)
    cd, dev = a_t.dtype, a_t.device
    if cd not in _DTYPE_CODES:
        raise TypeError(f"edge_tangent: unsupported dtype {cd}")
    if not (2 <= N <= _MAX_NODES and 1 <= U <= _UNITS[-1] and 1 <= L <= _MAX_LAYERS):
        raise ValueError(f"edge_tangent: unsupported N={N}, U={U}, L={L}")
    if len(d_x) != L or len(e_tail) != L - 1 or len(x_tail) != L:
        raise ValueError("edge_tangent: inconsistent layer counts")
    check_tensor("a_t", a_t, (K, B, N, U), cd, dev)
    check_tensor("b_t", b_t, (K, B, N, U), cd, dev)
    check_tensor("l2_t", l2_t, (K, B, N, N), torch.float32, dev)
    for name, x in [("m", m)] + [(f"d_e[{l}]", x) for l, x in enumerate(d_e)] + [
        (f"d_x[{l}]", x) for l, x in enumerate(d_x)
    ]:
        check_tensor(name, x, (B, N, N, U), cd, dev)
    check_tensor("g", g, (B, N, N), cd, dev)
    check_tensor("gd", gd, (B, N, N), cd, dev)
    for name, x in (("e_l", e_l), ("x_out", x_out), ("g_out", g_out)):
        check_tensor(name, x, (U,), cd, dev)
    for name, ks in (("e_tail", e_tail), ("x_tail", x_tail)):
        for l, k in enumerate(ks):
            check_tensor(f"{name}[{l}]", k, (U, U), cd, dev)

    width = kernel_units(U)
    if width != U:
        (a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l, e_tail, x_tail, x_out,
         g_out) = pad_units(*args, width=width)
    phi_t = torch.empty((K, B, N, N), dtype=torch.float32, device=dev)
    mi_t = torch.empty((K, B, N, width), dtype=torch.float32, device=dev)
    cols = columns_per_block or default_columns(dev.index or 0, cd, K, B, N, width, L)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().ecnf_edge_tangent(
            _DTYPE_CODES[cd], K, B, N, width, L, cols,
            a_t.data_ptr(), b_t.data_ptr(), l2_t.data_ptr(),
            _pointers(d_e), _pointers(d_x),
            m.data_ptr(), g.data_ptr(), gd.data_ptr(), e_l.data_ptr(),
            _pointers(e_tail), _pointers(x_tail),
            x_out.data_ptr(), g_out.data_ptr(),
            phi_t.data_ptr(), mi_t.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"edge_tangent: kernel launch failed (cudaError {err}) for K={K} B={B} N={N} "
            f"U={U} L={L} {cd} columns={cols}"
        )
    edge_tangent.launch_count += 1
    if flops.counting():
        flops.add(edge_tangent_flops(K, B, N, U, L, cd))
    return phi_t, mi_t[..., :U]


edge_tangent.launch_count = 0
