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

The kernel has two designs, and `resident_route` picks one from the
shapes it sees:

- ``edge_tangent_bf16_kernel`` / ``edge_tangent_f32_kernel``: a thread
  block takes C tangent columns of one (receiver, sample), the N sender
  rows of each, for 2 <= N <= 64; C comes from the kernel's cost model
  (`default_columns`) unless the caller passes ``columns_per_block``.
  Shapes with no C that fits the card's shared memory and registers raise
  (in float32: U = 256 past 48 nodes).  It takes every shape, and is the
  route for float32, few columns (K=1 Hutchinson probes) and U = 256.
- ``edge_tangent_bf16_kernel_resident`` (`edge_tangent_resident`): bf16
  at U <= 128, a persistent kernel that holds the chain's weights in
  shared memory and runs each edge's 64 columns through wgmma products
  chained in registers.  The route for bf16 with at least
  `RESIDENT_MIN_COLUMNS` columns where its shared memory fits.

``edge_tangent.launch_count`` counts the launches of both designs,
``edge_tangent_resident.launch_count`` those of the resident one; while
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
from ecnf_tpu_torch.ops.cuda_build import I32, MAX_LAYERS, PTR, bind, check_tensor, launch, pointers
from ecnf_tpu_torch.ops.graph import dense_edge_mask

Tensor = torch.Tensor
# The contract of both edge kernels, this one and `ops.edge_primal`'s:
# 2 <= N <= EDGE_MAX_NODES (csrc/egnn_device.cuh: kMaxEdgeNodes), at most
# MAX_LAYERS layers, and U zero-padded to one of EDGE_UNITS (`kernel_units`,
# `pad_to`).
EDGE_MAX_NODES = 64
EDGE_UNITS = (32, 64, 128, 256)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_RESIDENT_UNITS = (32, 64, 128)
# Tangent columns from which bf16 takes the resident kernel.  On an H100
# SXM at B=48, N=13, U=128, L=3 the resident kernel takes ~230 us for any
# K <= 64 (one 64-row tile an edge), the other design 211 us at K=18 and
# 302 us at K=24 (PERF.md, kernel 1).
RESIDENT_MIN_COLUMNS = 24
SMEM_PER_BLOCK = 232_448  # an H100's opt-in shared memory per thread block


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


def resident_smem_bytes(U: int, L: int) -> int:
    """Dynamic shared memory of the resident kernel at width U and L layers
    a chain (the kernel's `resident_plan`): the 2L - 1 ``[U, U]`` weights,
    g_out and x_out in f32 and e_l, then per warpgroup the a_t tile
    ``[64, U + 8]``, two buffers of the 2L + 1 broadcast vectors and two of
    64 l2_t values, each part 128-byte aligned."""
    align = lambda n: (n + 127) // 128 * 128
    stage = align(64 * (U + 8) * 2) + align(2 * (2 * L + 1) * U * 2) + align(2 * 64 * 4)
    return align((2 * L - 1) * U * U * 2) + align(U * 10) + 2 * stage


def resident_route(dtype: torch.dtype, K: int, B: int, N: int, U: int, L: int) -> bool:
    """Whether `edge_tangent` takes the resident kernel at these shapes: bf16,
    at least `RESIDENT_MIN_COLUMNS` tangent columns, a width U (zero-padded
    to the kernel's) of at most 128, 2 <= N <= 64, and the chain's weights
    with the two warpgroups' stages within a block's shared memory.  Below
    that many columns a 64-row tile is mostly padding; at U = 256 neither
    the weights nor the accumulators fit.  ``B`` does not enter."""
    if dtype != torch.bfloat16 or K < RESIDENT_MIN_COLUMNS or not 2 <= N <= EDGE_MAX_NODES:
        return False
    if not (1 <= U <= _RESIDENT_UNITS[-1] and 1 <= L <= MAX_LAYERS):
        return False
    return resident_smem_bytes(kernel_units(U), L) <= SMEM_PER_BLOCK


def kernel_units(U: int) -> int:
    """The smallest width the edge kernels take that is at least ``U``."""
    for width in EDGE_UNITS:
        if U <= width:
            return width
    raise ValueError(f"U={U} is wider than the edge kernels' {EDGE_UNITS[-1]}")


def pad_to(x: Tensor, width: int, axes: int = 1) -> Tensor:
    """``x`` with each of its last ``axes`` axes (units, or the rows and
    columns of a ``[U, U]`` weight) zero-padded to ``width``."""
    return F.pad(x, (0, width - x.shape[-1]) * axes)


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
    vec = lambda x: pad_to(x, width)
    mat = lambda x: pad_to(x, width, 2)
    return (vec(a_t), vec(b_t), l2_t, [vec(d) for d in d_e], [vec(d) for d in d_x], vec(m), g, gd,
            vec(e_l), [mat(k) for k in e_tail], [mat(k) for k in x_tail], vec(x_out), vec(g_out))


_library = bind("edge_tangent", {
    "ecnf_edge_tangent": [I32] * 7 + [PTR] * 16,
    "ecnf_edge_tangent_columns": [I32] * 6,
    "ecnf_edge_tangent_plan": [I32] * 7 + [ctypes.POINTER(I32)] * 4,
    "ecnf_edge_tangent_resident": [I32] * 5 + [PTR] * 16,
    "ecnf_edge_tangent_resident_smem": [I32] * 2,
})


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
        raise ValueError(f"edge_tangent: {columns} columns per block do not launch")
    keys = ("smem_bytes", "blocks_per_sm", "row_tiles", "staged")
    return dict(zip(keys, (o.value for o in out)))


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
    K, B, N, U, L = _check_args(*args)
    cd, dev = a_t.dtype, a_t.device
    if columns_per_block is None and resident_route(cd, K, B, N, U, L):
        return edge_tangent_resident(*args)

    width = kernel_units(U)
    cols = columns_per_block or default_columns(dev.index or 0, cd, K, B, N, width, L)
    return _launch(_library().ecnf_edge_tangent, edge_tangent, None,
                   (_DTYPE_CODES[cd], K, B, N, width, L, cols), args, (K, B, N, U, L, cd))


edge_tangent.launch_count = 0


def edge_tangent_resident(
    a_t: Tensor, b_t: Tensor, l2_t: Tensor,
    d_e: Sequence[Tensor], d_x: Sequence[Tensor], m: Tensor, g: Tensor,
    gd: Tensor, e_l: Tensor, e_tail: Sequence[Tensor],
    x_tail: Sequence[Tensor], x_out: Tensor, g_out: Tensor,
) -> Tuple[Tensor, Tensor]:
    """The edge tangent chain through the resident kernel, at any K >= 1
    (`edge_tangent` takes it where `resident_route` holds).  CUDA bf16
    tensors as `edge_tangent` takes them, with U <= 128 (zero-padded to 32,
    64 or 128); raises on anything else.  Launches on the current stream
    without synchronising, and counts the launch in both
    ``edge_tangent_resident.launch_count`` and ``edge_tangent.launch_count``.
    """
    args = (a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l, e_tail, x_tail, x_out, g_out)
    K, B, N, U, L = _check_args(*args)
    if a_t.dtype != torch.bfloat16 or U > _RESIDENT_UNITS[-1]:
        raise ValueError(f"edge_tangent_resident: takes bfloat16 at U <= {_RESIDENT_UNITS[-1]}, "
                         f"got {a_t.dtype} at U={U}")
    return _launch(_library().ecnf_edge_tangent_resident, edge_tangent_resident, edge_tangent,
                   (K, B, N, kernel_units(U), L), args, (K, B, N, U, L, torch.bfloat16))


edge_tangent_resident.launch_count = 0


def _launch(entry, counter, also, lead: tuple, args: tuple, shape: tuple) -> Tuple[Tensor, Tensor]:
    """``entry(*lead, <the chain's pointers>, phi_t, mi_t, stream)`` through
    `cuda_build.launch`, counted on ``counter`` (and ``also``), with U
    zero-padded to the kernel's width (`pad_units`); returns ``(phi_t,
    mi_t)`` with mi_t cut back to U."""
    K, B, N, U = args[0].shape
    width = kernel_units(U)
    if width != U:
        args = pad_units(*args, width=width)
    a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l, e_tail, x_tail, x_out, g_out = args
    dev = a_t.device
    phi_t = torch.empty((K, B, N, N), dtype=torch.float32, device=dev)
    mi_t = torch.empty((K, B, N, width), dtype=torch.float32, device=dev)
    launch(counter, entry, dev, (
        *lead, a_t.data_ptr(), b_t.data_ptr(), l2_t.data_ptr(), pointers(d_e), pointers(d_x),
        m.data_ptr(), g.data_ptr(), gd.data_ptr(), e_l.data_ptr(), pointers(e_tail),
        pointers(x_tail), x_out.data_ptr(), g_out.data_ptr(), phi_t.data_ptr(), mi_t.data_ptr(),
    ), edge_tangent_flops, shape, also)
    return phi_t, mi_t[..., :U]


def _check_args(
    a_t: Tensor, b_t: Tensor, l2_t: Tensor,
    d_e: Sequence[Tensor], d_x: Sequence[Tensor], m: Tensor, g: Tensor,
    gd: Tensor, e_l: Tensor, e_tail: Sequence[Tensor],
    x_tail: Sequence[Tensor], x_out: Tensor, g_out: Tensor,
) -> Tuple[int, int, int, int, int]:
    """Raise unless the arguments are what both kernels take; returns
    ``(K, B, N, U, L)``."""
    if a_t.device.type != "cuda":
        raise ValueError(f"edge_tangent: unsupported device {a_t.device}")
    K, B, N, U = a_t.shape
    L = len(d_e)
    cd, dev = a_t.dtype, a_t.device
    if cd not in _DTYPE_CODES:
        raise TypeError(f"edge_tangent: unsupported dtype {cd}")
    if not (2 <= N <= EDGE_MAX_NODES and 1 <= U <= EDGE_UNITS[-1] and 1 <= L <= MAX_LAYERS):
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
    return K, B, N, U, L
