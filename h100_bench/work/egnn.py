"""The work of each cell, from its shapes: matrix-product FLOPs (split into a
bf16 and an f32 bucket: bf16 when both operands are bf16) and, for a
kernel's launch, the bytes it has to move.

These formulas are frozen here so that a later change to the program cannot
change the yardstick: they count what the routes of the program compute at
the commit that defined the benchmark, product by product, as its matmul
counter (`ops/flops.py: count_fn_flops`) counts them, and the benchmark's
tests hold them to that counter.  Elementwise work is not counted.

Shapes: ``B`` samples, ``N`` nodes in ``D`` dimensions, node features
``H``, time embedding ``T``, ``L`` MLP layers of ``U`` units, ``K``
tangent columns.
"""
from typing import Tuple

Flops = Tuple[float, float]  # (bf16, f32)


def _shapes(cfg: dict):
    units = cfg["mlp_units"]
    return (cfg["n_nodes"], cfg["dim"], cfg["n_invariant_feat_hidden"],
            cfg["time_embedding_dim"], units[-1], len(units), cfg["n_blocks_egnn"])


def _add(a: Flops, b: Flops) -> Flops:
    return a[0] + b[0], a[1] + b[1]


def _in(low_precision: bool, flops: float) -> Flops:
    return (flops, 0.0) if low_precision else (0.0, flops)


def edge_chain_flops(K: int, B: int, N: int, U: int, L: int, bf16: bool) -> Flops:
    """One edge-tangent chain (`ops/edge_tangent.py`): over K B N^2 edge
    rows, the 2L-1 ``[U, U]`` layers and the gate's column in the compute
    dtype, and phi_x's output column in f32."""
    rows = K * B * N * N
    return _add(_in(bf16, 2.0 * rows * U * (U * (2 * L - 1) + 1)), (0.0, 2.0 * rows * U))


def edge_chain_bytes(K: int, B: int, N: int, U: int, L: int, bf16: bool) -> float:
    """Bytes one edge-tangent launch reads and writes, each once: the
    tangents and residuals in, ``phi_t`` and ``mi_t`` (f32) out."""
    e = 2 if bf16 else 4
    edges = B * N * N
    inputs = (2 * K * B * N * U * e  # a_t, b_t
              + K * edges * 4  # l2_t
              + (2 * L + 1) * edges * U * e  # d_e, d_x, m
              + 2 * edges * e  # g, gd
              + ((2 * L - 1) * U * U + 3 * U) * e)  # the weights
    outputs = K * edges * 4 + K * B * N * U * 4
    return float(inputs + outputs)


def _block_forward(cfg: dict, B: int, bf16: bool) -> Flops:
    """One block of the residual-capturing primal (`ops/tangent.py:
    block_forward`): the MLPs in the compute dtype, the Gram matrix and the
    coordinate aggregation in f32."""
    N, D, H, T, U, L, _ = _shapes(cfg)
    nodes, edges = B * N, B * N * N
    mlp = (nodes * H * H + B * T * H  # time ConcatDense
           + 2 * nodes * H * U  # phi_e's sender and receiver rows
           + edges * U * U * (2 * L - 1)  # phi_e's tail, phi_x
           + 2 * edges * U  # phi_x's output column, the gate
           + nodes * (U + H) * U + nodes * U * U * (L - 1) + nodes * U * H)  # phi_h
    return _add(_in(bf16, 2.0 * mlp), (0.0, 2.0 * 2 * edges * D))


def _block_tangent(cfg: dict, B: int, K: int, bf16: bool) -> Flops:
    """One block's tangent of K columns (`ops/tangent.py: _block_tangent`)."""
    N, D, H, T, U, L, _ = _shapes(cfg)
    nodes, edges = K * B * N, K * B * N * N
    mlp = (nodes * H * H + 2 * nodes * H * U
           + nodes * (U + H) * U + nodes * U * U * (L - 1) + nodes * U * H)
    return _add(_add(_in(bf16, 2.0 * mlp), (0.0, 2.0 * 3 * edges * D)),
                edge_chain_flops(K, B, N, U, L, bf16))


def field_eval_flops(cfg: dict, B: int, K: int, bf16: bool) -> Flops:
    """One field evaluation with a K-column trace through the hand-linearised
    tangent: the primal, each block's tangent, the trace's sum.  The fused
    kernel (`ops/fused_trace.py`) computes the same products in f32 with
    K = N D."""
    N, D, _, _, _, _, n_blocks = _shapes(cfg)
    total = (0.0, 2.0 * B * K * N * D)
    for _ in range(n_blocks):
        total = _add(total, _add(_block_forward(cfg, B, bf16), _block_tangent(cfg, B, K, bf16)))
    return total


def train_step_flops(cfg: dict, B: int) -> Flops:
    """One flow-matching step at microbatch 1 (`training/state.py:
    make_update_fn` through `models/egnn.py` under autograd): each product's
    forward, the gradient of its weight, and the gradient of its input where
    that input depends on a parameter.  Block 0's coordinates do not; the
    last block's gate, message sum and phi_h feed nothing, so their backward
    does not run."""
    N, D, H, T, U, L, n_blocks = _shapes(cfg)
    bf16 = cfg["compute_dtype"] == "bfloat16"
    nodes, edges = B * N, B * N * N
    mlp = geo = 0.0
    for i in range(n_blocks):
        moves, last = i > 0, i == n_blocks - 1
        # Forward.
        mlp += (nodes * H * H + B * T * H + 2 * nodes * H * U + edges * U
                + edges * U * U * (2 * L - 1) + 2 * edges * U
                + nodes * (U + H) * U + nodes * U * U * (L - 1) + nodes * U * H)
        geo += 2 * edges * D
        # Backward: time ConcatDense (h: weight and input; temb: weight).
        mlp += 2 * nodes * H * H + B * T * H
        # phi_e's first layer: h rows (weight and input), the distance row.
        mlp += 4 * nodes * H * U + edges * U * (2 if moves else 1)
        mlp += 2 * edges * U * U * (2 * L - 1) + 2 * edges * U  # phi_e tail, phi_x, output
        geo += edges * D * (2 if moves else 0)  # Gram matrix
        geo += edges * D * (2 if moves else 1)  # w @ vec
        if not last:
            mlp += 2 * edges * U  # gate
            mlp += 2 * (nodes * (U + H) * U + nodes * U * U * (L - 1) + nodes * U * H)
    return _add(_in(bf16, 2.0 * mlp), (0.0, 2.0 * geo))


def sample_route(cfg: dict, traffic: dict) -> Tuple[int, bool]:
    """Tangent columns K of a sampling mix's field evaluation and whether
    its products run in bf16: the structured exact trace over the (N-1) D
    zero-CoM columns and Hutchinson's one probe in the compute dtype, the
    fused trace over all N D columns in f32."""
    N, D = cfg["n_nodes"], cfg["dim"]
    bf16 = cfg["compute_dtype"] == "bfloat16"
    return {"exact": ((N - 1) * D, bf16), "hutchinson": (1, bf16), "fused": (N * D, False)}[
        traffic["trace"]]


def fused_launch_bytes(cfg: dict, B: int) -> float:
    """Bytes one fused-trace launch reads and writes, each once: the f32
    weights of every block, x, the node features and the time embedding
    in, the field and the divergence out."""
    N, D, H, T, U, L, n_blocks = _shapes(cfg)
    block = (H * (H + T) + H + U * (2 * H + 1) + U + (2 * L - 1) * (U * U + U) + 2 * (U + 1)
             + U * (U + H) + U + (L - 1) * (U * U + U) + H * U + H)
    return 4.0 * (n_blocks * block + 2 * B * N * D + B * N * H + B * T + B)


def seconds_at_peak(flops: Flops, peaks: dict, matmul_precision: str) -> float:
    """Least time for the products at the card's peaks: bf16 on the bf16
    tensor cores, f32 at the fastest f32-accurate rate (three TF32 products
    each under the precision ``highest``, one otherwise)."""
    f32_rate = peaks["tf32_flops_per_s"] / (3 if matmul_precision == "highest" else 1)
    return flops[0] / peaks["bf16_flops_per_s"] + flops[1] / f32_rate
