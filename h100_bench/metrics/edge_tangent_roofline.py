"""Share of its roofline that the edge-tangent kernel reaches in the traced
window: launches times the least time of one launch (the larger of its
products at the card's peaks and its bytes at the memory's rate, from the
frozen formulas) over the kernel's device time, in percent.  Launches and
time come from the trace, by the kernel names below, and the launches are
held to the program's own count."""

KERNELS = ("edge_tangent_bf16_kernel", "edge_tangent_f32_kernel")
COUNTERS = {"launches": "ecnf_tpu_torch.ops.edge_tangent:edge_tangent"}


def read(ctx):
    times = [t for name, t in ctx.kernels if any(k in name for k in KERNELS)]
    if not times or ctx.peaks is None or ctx.traffic["trace"] == "fused":
        return None
    if len(times) != ctx.counters["launches"]:
        raise RuntimeError(f"edge_tangent: {len(times)} kernels in the trace, "
                           f"{ctx.counters['launches']} launches counted")
    c = ctx.config
    K, bf16 = ctx.work.sample_route(c, ctx.traffic)
    B, N, U, L = ctx.traffic["batch"], c["n_nodes"], c["mlp_units"][-1], len(c["mlp_units"])
    ops = ctx.work.seconds_at_peak(ctx.work.edge_chain_flops(K, B, N, U, L, bf16), ctx.peaks,
                                   c["matmul_precision"])
    data = ctx.work.edge_chain_bytes(K, B, N, U, L, bf16) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * len(times) * max(ops, data) / sum(times)
