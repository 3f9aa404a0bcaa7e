"""Share of its roofline that the primal edge-chain kernel reaches in the
traced window: launches times the least time of one launch (the larger of
its products at the bf16 peak and its bytes at the memory's rate) over the
kernel's device time, in percent.  Launches and time come from the trace,
by the kernel's name, and the launches are held to the program's own count;
a program without the kernel reports nothing.

The formulas count what any implementation of the kernel's interface must
do: its products, the 2L - 1 ``[U, U]`` layers and the two Dense(1)
columns over the B N^2 edge rows; its inputs read once (the sender and
receiver rows, the squared distances, the weights) and its outputs written
once (the 2L silu' factors and the messages in bf16, phi in f32, the gate
and its derivative in bf16, the sender sum in f32)."""

KERNELS = ("edge_primal_bf16_kernel",)
COUNTERS = {"launches": "ecnf_tpu_torch.ops.edge_primal:edge_primal"}


def flops(B: int, N: int, U: int, L: int) -> float:
    return 2.0 * B * N * N * U * (U * (2 * L - 1) + 2)


def nbytes(B: int, N: int, U: int, L: int) -> float:
    edges = B * N * N
    inputs = (2 * B * N * U * 2  # h @ e_s, h @ e_r
              + edges * 4  # squared distances
              + ((2 * L - 1) * U * U + (2 * L + 3) * U + 2) * 2)  # weights, biases, columns
    outputs = (2 * L + 1) * edges * U * 2 + edges * 4 + 2 * edges * 2 + B * N * U * 4
    return float(inputs + outputs)


def read(ctx):
    times = [t for name, t in ctx.kernels if any(k in name for k in KERNELS)]
    if not times or ctx.peaks is None:
        return None
    if len(times) != ctx.counters["launches"]:
        raise RuntimeError(f"edge_primal: {len(times)} kernels in the trace, "
                           f"{ctx.counters['launches']} launches counted")
    c = ctx.config
    B, N, U, L = ctx.traffic["batch"], c["n_nodes"], c["mlp_units"][-1], len(c["mlp_units"])
    least = max(flops(B, N, U, L) / ctx.peaks["bf16_flops_per_s"],
                nbytes(B, N, U, L) / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * len(times) * least / sum(times)
