"""Fused EGCL forward: CUDA kernel and plain version.

Port of `ecnf_tpu/ops/pallas/attic/egcl_kernel.py` (Pallas `_egcl_kernel`).
`egcl_fused` runs one whole EGCL block, its time ConcatDense included:
Gram squared distances, phi_e, phi_x and its Dense(1), the coordinate
update, the gate and the gated message sum, phi_h and both residuals.
Forward only and f32 whatever the field's compute dtype, as in JAX.

- On CUDA tensors it launches the hand-written kernel in ``csrc/egcl.cu``
  (built by `ops.cuda_build` at first use).  It raises on anything the
  kernel does not take; there is no fallback.
- On CPU tensors it runs `egcl_reference`, the same math in plain torch
  ops (`ops.tangent.block_forward`), which is also the kernel's oracle.

The JAX functions take a flax parameter tree and static shape arguments;
the port takes the `models.egnn.EGNN` (or the `cnf.build.FlatEGNNField`)
and reads the shapes from it.  The TPU-only ``batch_tile`` and
``interpret`` are not ported.  The weights of every block are packed once
per solve (`egnn_weights`) into one f32 buffer in the order of the JAX
`_flatten_egcl_weights` (`weight_list`); the higher-level functions take
``use_kernel=False`` to run the plain version on any device.

``egcl_fused.launch_count`` counts kernel launches; while
`ops.flops.count_fn_flops` runs, each launch adds `egcl_flops` to the count.
"""
import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ecnf_tpu_torch.ops import flops
from ecnf_tpu_torch.ops.cuda_build import I32, PTR, bind, check_tensor, launch
from ecnf_tpu_torch.ops.numerics import timestep_embedding
from ecnf_tpu_torch.ops.tangent import BlockWeights, block_forward, block_weights

Tensor = torch.Tensor


def weight_list(wt: BlockWeights) -> List[Tensor]:
    """One block's weights in the order of the JAX `_flatten_egcl_weights`."""
    ws = [wt.cd_h, wt.cd_t, wt.cd_b, wt.e_s, wt.e_r, wt.e_l, wt.e_b[0]]
    for k, b in zip(wt.e_tail, wt.e_b[1:]):
        ws += [k, b]
    for k, b in zip(wt.x_tail, wt.x_b):
        ws += [k, b]
    ws += [wt.x_out, wt.x_out_b, wt.g_out, wt.g_out_b, wt.h_m, wt.h_h, wt.h_b[0]]
    for k, b in zip(wt.h_tail, wt.h_b[1:-1]):
        ws += [k, b]
    ws += [wt.h_out, wt.h_b[-1]]
    return ws


def _shapes(H: int, T: int, U: int, L: int) -> List[Tuple[int, ...]]:
    """Shapes of `weight_list` for hidden H, time embedding T, L layers of U."""
    shapes = [(H, H), (T, H), (H,), (H, U), (H, U), (U,), (U,)]
    shapes += [(U, U), (U,)] * (L - 1) + [(U, U), (U,)] * L
    shapes += [(U,), (), (U,), (), (U, U), (H, U), (U,)]
    shapes += [(U, U), (U,)] * (L - 1) + [(U, H), (H,)]
    return shapes


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _from_list(ws: Sequence[Tensor], L: int) -> BlockWeights:
    """Inverse of `weight_list`."""
    cd_h, cd_t, cd_b, e_s, e_r, e_l, e_b0 = ws[:7]
    rest = list(ws[7:])
    e_pairs = [rest.pop(0) for _ in range(2 * (L - 1))]
    x_pairs = [rest.pop(0) for _ in range(2 * L)]
    x_out, x_out_b, g_out, g_out_b, h_m, h_h, h_b0 = [rest.pop(0) for _ in range(7)]
    h_pairs = [rest.pop(0) for _ in range(2 * (L - 1))]
    h_out, h_last = rest
    return BlockWeights(
        cd_h=cd_h, cd_t=cd_t, e_s=e_s, e_r=e_r, e_l=e_l,
        e_tail=tuple(e_pairs[0::2]), x_tail=tuple(x_pairs[0::2]),
        x_out=x_out, g_out=g_out, h_m=h_m, h_h=h_h,
        h_tail=tuple(h_pairs[0::2]), h_out=h_out, cd_b=cd_b,
        e_b=(e_b0, *e_pairs[1::2]), x_b=tuple(x_pairs[1::2]),
        x_out_b=x_out_b, g_out_b=g_out_b, h_b=(h_b0, *h_pairs[1::2], h_last),
    )


def pack_block(wt: BlockWeights) -> Tensor:
    """One block's weights as the kernel's flat f32 buffer: `weight_list`
    order, each tensor flattened and zero-padded to a multiple of 4."""
    parts = []
    for w in weight_list(wt):
        flat = w.detach().reshape(-1).float()
        parts.append(torch.nn.functional.pad(flat, (0, _pad4(flat.numel()) - flat.numel())))
    return torch.cat(parts)


def unpack_block(flat: Tensor, H: int, T: int, U: int, L: int) -> BlockWeights:
    """`BlockWeights` as views of a `pack_block` buffer."""
    ws, offset = [], 0
    for shape in _shapes(H, T, U, L):
        n = 1
        for s in shape:
            n *= s
        ws.append(flat[offset : offset + n].reshape(shape))
        offset += _pad4(n)
    if offset != flat.numel():
        raise ValueError(f"packed weights have {flat.numel()} floats, expected {offset}")
    return _from_list(ws, L)


class EGNNWeights(NamedTuple):
    """Every block's f32 weights: ``flat [n_blocks, P]`` for the kernels,
    ``blocks`` (views of it) for the plain versions."""

    flat: Tensor
    blocks: Tuple[BlockWeights, ...]
    hidden: int
    time_embedding_dim: int
    mlp_units: Tuple[int, ...]


def egnn_weights(egnn) -> EGNNWeights:
    """Pack an `models.egnn.EGNN`'s weights in f32; taken once per solve."""
    units = tuple(egnn.mlp_units)
    if len(set(units)) != 1:
        raise ValueError(f"the fused EGCL needs constant-width mlp_units, got {units}")
    H, T = egnn.time_dense[0].in_widths
    n = len(egnn.blocks)
    flat = torch.stack([pack_block(block_weights(egnn, i, torch.float32)) for i in range(n)])
    blocks = tuple(unpack_block(flat[i], H, T, units[0], len(units)) for i in range(n))
    return EGNNWeights(flat, blocks, H, T, units)


def egcl_reference(
    vec: Tensor, h: Tensor, temb: Tensor, weights: BlockWeights,
    normalization_constant: float = 1.0,
) -> Tuple[Tensor, Tensor]:
    """Plain-torch EGCL block: ``(vec_out [B, N, D], h_out [B, N, H])``."""
    vec_out, h_out, _ = block_forward(
        vec, h, temb, weights, normalization_constant, with_residuals=False
    )
    return vec_out, h_out


def egcl_flops(B: int, N: int, D: int, H: int, T: int, U: int, L: int) -> flops.FlopCount:
    """Matmul FLOPs of `egcl_reference` (one f32 EGNN block forward) with L
    layers of U units, as `ops.flops.count_fn_flops` counts them."""
    nodes, edges = B * N, B * N * N
    mlp = (
        nodes * H * H + B * T * H  # time ConcatDense
        + 2 * nodes * H * U  # phi_e's sender and receiver rows
        + edges * U * U * (2 * L - 1)  # phi_e's tail and phi_x's layers
        + 2 * edges * U  # phi_x's Dense(1) and the gate
        + nodes * (U + H) * U + nodes * U * U * (L - 1) + nodes * U * H  # phi_h
    )
    return flops.FlopCount(f32=2.0 * (mlp + 2 * edges * D))  # + the Gram matrix and w @ vec


_library = bind("egcl", {
    "ecnf_egcl_forward": [I32] * 7 + [ctypes.c_float] + [PTR] * 7,
    "ecnf_weight_floats": [I32] * 4,
})


def egcl_fused(
    vec: Tensor, h: Tensor, temb: Tensor, weights: Tensor,
    mlp_units: Sequence[int], normalization_constant: float = 1.0,
) -> Tuple[Tensor, Tensor]:
    """Run one fused EGCL block.

    Args:
        vec: ``[B, N, D]`` centred coordinates, f32.
        h: ``[B, N, H]`` node features before the time ConcatDense, f32.
        temb: ``[B, T]`` time embedding, f32.
        weights: ``[P]`` f32, one block of `egnn_weights(...).flat`.
        mlp_units: the block's constant-width MLP units.

    Returns:
        ``(vec_out, h_out)``, f32.  CPU tensors take `egcl_reference`;
        CUDA tensors launch the kernel on the current stream.
    """
    B, N, D = vec.shape
    H, T, U, L = h.shape[-1], temb.shape[-1], mlp_units[0], len(mlp_units)
    if len(set(mlp_units)) != 1:
        raise ValueError(f"egcl_fused: mlp_units must be constant-width, got {tuple(mlp_units)}")
    if vec.device.type == "cpu":
        return egcl_reference(
            vec, h, temb, unpack_block(weights, H, T, U, L), normalization_constant
        )
    if vec.device.type != "cuda":
        raise ValueError(f"egcl_fused: unsupported device {vec.device}")
    lib = _library()
    f32, dev = torch.float32, vec.device
    check_tensor("vec", vec, (B, N, D), f32, dev)
    check_tensor("h", h, (B, N, H), f32, dev)
    check_tensor("temb", temb, (B, T), f32, dev)
    check_tensor("weights", weights, (lib.ecnf_weight_floats(H, T, U, L),), f32, dev)
    vec_out = torch.empty_like(vec)
    h_out = torch.empty_like(h)
    launch(egcl_fused, lib.ecnf_egcl_forward, dev, (
        B, N, D, H, T, U, L, float(normalization_constant), vec.data_ptr(), h.data_ptr(),
        temb.data_ptr(), weights.data_ptr(), vec_out.data_ptr(), h_out.data_ptr(),
    ), egcl_flops, (B, N, D, H, T, U, L))
    return vec_out, h_out


egcl_fused.launch_count = 0


def egnn_forward_fused(
    egnn, positions: Tensor, node_features: Tensor, time_embedding: Tensor,
    weights: Optional[EGNNWeights] = None, use_kernel: bool = True,
) -> Tensor:
    """EGNN torso forward through one `egcl_fused` per block.

    Mirrors `models.egnn.EGNN.forward` (recentring, residuals, final
    scaling) in f32.  ``weights`` is `egnn_weights(egnn)`, rebuilt when not
    given; ``use_kernel=False`` runs `egcl_reference` on any device.
    """
    if weights is None:
        weights = egnn_weights(egnn)
    C = egnn.normalization_constant
    pos = positions.float()
    pos_mean = pos.mean(dim=-2, keepdim=True)
    vec = pos - pos_mean
    initial_vec = vec
    h = node_features.float().contiguous()
    temb = time_embedding.float().contiguous()
    vec = vec.contiguous()
    for flat, wt in zip(weights.flat, weights.blocks):
        if use_kernel:
            vec, h = egcl_fused(vec, h, temb, flat, weights.mlp_units, C)
        else:
            vec, h = egcl_reference(vec, h, temb, wt, C)
    vec = vec - initial_vec
    vec = vec - pos_mean
    return vec * egnn.final_scaling.detach()


def flat_egnn_apply_fused(
    field, x: Tensor, t: Tensor, features: Tensor,
    weights: Optional[EGNNWeights] = None, use_kernel: bool = True,
) -> Tensor:
    """``FlatEGNNField`` forward through the fused blocks: ``[B, N*D]``.

    The embedding lookup and the timestep embedding run in plain torch
    (tiny); the torso runs through `egnn_forward_fused`.  Forward only.
    """
    B = x.shape[0]
    n, dim = field.n_nodes, field.dim
    pos = x.reshape(B, n, dim)
    h = field.embed(features.reshape(B, n).long())
    temb = timestep_embedding(t, field.time_embedding_dim)
    with torch.no_grad():
        vec = egnn_forward_fused(field.egnn, pos, h, temb, weights, use_kernel)
    return vec.reshape(B, n * dim)
