"""Fused EGNN field + full exact divergence: CUDA kernel and plain version.

Port of `ecnf_tpu/ops/pallas/attic/trace_kernel.py` (Pallas `_trace_kernel`):
``egnn_value_and_div_fused(field, x, t, features) -> (v [B, N*D], div [B])``
with ``div[b] = sum_c (J e_c)_c`` over all N*D identity columns.  It is the
exact-trace route of ``SolveConfig(fused_trace=True)``.  Everything is f32
whatever the field's compute dtype, as in JAX (the Pallas kernel casts
every input to f32).

- On CUDA tensors it launches the hand-written kernel in
  ``csrc/fused_trace.cu`` (built by `ops.cuda_build` at first use): one
  launch per field evaluation for the whole field, its tangents and the
  sum.  It raises on anything the kernel does not take; there is no
  fallback.
- On CPU tensors (or with ``use_kernel=False``) it runs
  `egnn_value_and_div_reference`: the f32 hand-linearised trace of
  `ops.tangent` (`egnn_value_and_trace` with the plain edge chain) over the
  N*D identity basis, with no trace offset.

``egnn_value_and_div_fused.launch_count`` counts kernel launches; while
`ops.flops.count_fn_flops` runs, each launch adds `fused_trace_flops` to the
count.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch

from ecnf_tpu_torch.ops import flops
from ecnf_tpu_torch.ops.cuda_build import I32, PTR, bind, check_tensor, launch
from ecnf_tpu_torch.ops.edge_tangent import edge_tangent_flops
from ecnf_tpu_torch.ops.egcl import EGNNWeights, egcl_flops, egnn_weights
from ecnf_tpu_torch.ops.numerics import timestep_embedding
from ecnf_tpu_torch.ops.tangent import egnn_value_and_trace

Tensor = torch.Tensor


def egnn_value_and_div_reference(
    field, x: Tensor, t: Tensor, features: Tensor,
    weights: Optional[EGNNWeights] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain version: the f32 hand-linearised trace over all N*D columns."""
    if weights is None:
        weights = egnn_weights(field.egnn)
    basis = torch.eye(x.shape[-1], dtype=torch.float32, device=x.device)
    return egnn_value_and_trace(
        field, x.float(), t, features, basis, use_kernel=False, weights=weights.blocks
    )


def fused_trace_flops(B: int, N: int, D: int, H: int, T: int, U: int, L: int,
                      n_blocks: int) -> flops.FlopCount:
    """Matmul FLOPs of `egnn_value_and_div_reference` (all f32), as
    `ops.flops.count_fn_flops` counts them: per block the forward
    (`ops.egcl.egcl_flops`) and the tangent of its K = N D identity columns
    (`ops.tangent._block_tangent`), then the trace's sum."""
    K = N * D
    nodes, edges = K * B * N, K * B * N * N
    tangent = 2.0 * (
        nodes * H * H  # time ConcatDense
        + 2 * nodes * H * U  # phi_e's sender and receiver rows
        + 3 * edges * D  # the Gram tangent and the two aggregations
        + nodes * (U + H) * U + nodes * U * U * (L - 1) + nodes * U * H  # phi_h
    )
    block = (egcl_flops(B, N, D, H, T, U, L) + edge_tangent_flops(K, B, N, U, L, torch.float32)
             + flops.FlopCount(f32=tangent))
    return block.scaled(n_blocks) + flops.FlopCount(f32=2.0 * B * K * N * D)


_library = bind("fused_trace", {
    "ecnf_fused_trace": [I32] * 8 + [ctypes.c_float, I32] + [PTR] * 9,
    "ecnf_fused_trace_columns": [I32] * 6,
    "ecnf_weight_floats": [I32] * 4,
})


@functools.lru_cache(maxsize=None)
def default_columns(device_index: int, B: int, N: int, D: int, H: int, T: int, U: int) -> int:
    """Tangent columns per thread block that the kernel picks for a card."""
    with torch.cuda.device(device_index):
        cols = _library().ecnf_fused_trace_columns(B, N, D, H, T, U)
    if cols < 1:
        raise ValueError(
            f"egnn_value_and_div_fused: unsupported shapes N={N} D={D} H={H} T={T} U={U}"
        )
    return cols


@torch.no_grad()
def egnn_value_and_div_fused(
    field, x: Tensor, t: Tensor, features: Tensor,
    weights: Optional[EGNNWeights] = None, use_kernel: bool = True,
    columns_per_block: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Fused (field value, exact divergence) of a `cnf.build.FlatEGNNField`.

    ``weights`` is `ops.egcl.egnn_weights(field.egnn)`, taken once per
    solve by the caller and rebuilt here when not given.  CPU tensors and
    ``use_kernel=False`` take `egnn_value_and_div_reference`.  On a card,
    ``columns_per_block`` overrides the kernel's choice of tangent columns
    per thread block (the result does not depend on it beyond the order
    of div's f32 sum).
    """
    if weights is None:
        weights = egnn_weights(field.egnn)
    if x.device.type == "cpu" or not use_kernel:
        return egnn_value_and_div_reference(field, x, t, features, weights)
    if x.device.type != "cuda":
        raise ValueError(f"egnn_value_and_div_fused: unsupported device {x.device}")
    B = x.shape[0]
    N, D = field.n_nodes, field.dim
    H, T, units = weights.hidden, weights.time_embedding_dim, weights.mlp_units
    U, L, n_blocks = units[0], len(units), weights.flat.shape[0]
    dev, f32 = x.device, torch.float32
    lib = _library()
    cols = columns_per_block or default_columns(dev.index or 0, B, N, D, H, T, U)
    x = x.float().contiguous()
    h0 = field.embed(features.reshape(B, N).long()).float().contiguous()
    temb = timestep_embedding(t, field.time_embedding_dim).float().contiguous()
    fs = field.egnn.final_scaling.detach().float().reshape(1)
    check_tensor("x", x, (B, N * D), f32, dev)
    check_tensor("h0", h0, (B, N, H), f32, dev)
    check_tensor("temb", temb, (B, T), f32, dev)
    check_tensor("weights", weights.flat, (n_blocks, lib.ecnf_weight_floats(H, T, U, L)), f32, dev)
    check_tensor("final_scaling", fs, (1,), f32, dev)
    v = torch.empty((B, N * D), dtype=f32, device=dev)
    div = torch.empty((B,), dtype=f32, device=dev)
    partial = torch.empty((B, -(-N * D // cols)), dtype=f32, device=dev)
    launch(egnn_value_and_div_fused, lib.ecnf_fused_trace, dev, (
        B, N, D, H, T, U, L, n_blocks, float(field.egnn.normalization_constant), cols,
        x.data_ptr(), h0.data_ptr(), temb.data_ptr(), weights.flat.data_ptr(), fs.data_ptr(),
        v.data_ptr(), div.data_ptr(), partial.data_ptr(),
    ), fused_trace_flops, (B, N, D, H, T, U, L, n_blocks))
    return v, div


egnn_value_and_div_fused.launch_count = 0
