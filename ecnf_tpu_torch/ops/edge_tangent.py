"""Edge-level tangent chain of one EGCL block: CUDA kernel and plain version.

`edge_tangent` is the port of the Pallas kernel `_edge_tangent_kernel`
(`ecnf_tpu/ops/pallas/tangent_kernel.py`, math `_edge_tangent_math`).  For
K tangent columns it pushes the first-layer edge tangent through the phi_e
tail, the phi_x chain and the gate, returning ``phi_t [K, B, N, N]`` and
``mi_t [K, B, N, U]`` in f32.

- On CUDA tensors it launches the hand-written kernel in
  ``csrc/edge_tangent.cu`` (built by `ops.cuda_build` at first use).  It
  raises on anything the kernel does not take; there is no fallback.
- On CPU tensors it runs `edge_tangent_reference`, the same math in plain
  torch ops, which is also the kernel's oracle.

``edge_tangent.launch_count`` counts kernel launches.
"""
import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from ecnf_tpu_torch.ops.cuda_build import check_tensor, load_library
from ecnf_tpu_torch.ops.graph import dense_edge_mask

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LAYERS = 8
_MAX_NODES = 32
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


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("edge_tangent").ecnf_edge_tangent
    ptr = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int] * 6 + [ptr] * 16
    fn.restype = ctypes.c_int
    return fn


def _pointers(xs: Sequence[Tensor]):
    return (ctypes.c_void_p * _MAX_LAYERS)(*[x.data_ptr() for x in xs])


def edge_tangent(
    a_t: Tensor, b_t: Tensor, l2_t: Tensor,
    d_e: Sequence[Tensor], d_x: Sequence[Tensor], m: Tensor, g: Tensor,
    gd: Tensor, e_l: Tensor, e_tail: Sequence[Tensor],
    x_tail: Sequence[Tensor], x_out: Tensor, g_out: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Edge tangent chain (see `edge_tangent_reference` for the contract).

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream, without synchronising; the arguments must match
    the documented shapes exactly, be contiguous and share one dtype
    (float32 or bfloat16; ``l2_t`` is always float32).
    """
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
    if not (2 <= N <= _MAX_NODES and U in _UNITS and 1 <= L <= _MAX_LAYERS):
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

    phi_t = torch.empty((K, B, N, N), dtype=torch.float32, device=dev)
    mi_t = torch.empty((K, B, N, U), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODES[cd], K, B, N, U, L,
            a_t.data_ptr(), b_t.data_ptr(), l2_t.data_ptr(),
            _pointers(d_e), _pointers(d_x),
            m.data_ptr(), g.data_ptr(), gd.data_ptr(), e_l.data_ptr(),
            _pointers(e_tail), _pointers(x_tail),
            x_out.data_ptr(), g_out.data_ptr(),
            phi_t.data_ptr(), mi_t.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_tangent: kernel launch failed, cudaError {err}")
    edge_tangent.launch_count += 1
    return phi_t, mi_t


edge_tangent.launch_count = 0
