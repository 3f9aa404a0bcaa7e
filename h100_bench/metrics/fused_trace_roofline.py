"""Share of its roofline that the fused field-and-trace kernel (with its
partial-sum kernel) reaches in the traced window: launches times the least
time of one launch (its products, all f32, at the card's f32-accurate
peak, or its bytes at the memory's rate, from the frozen formulas) over
the two kernels' device time, in percent.  Launches come from the trace by
the kernel names below and are held to the program's own count."""

KERNELS = ("fused_trace_kernel", "sum_partials")
COUNTERS = {"launches": "ecnf_tpu_torch.ops.fused_trace:egnn_value_and_div_fused"}


def read(ctx):
    times = [t for name, t in ctx.kernels if any(k in name for k in KERNELS)]
    launches = sum(1 for name, _ in ctx.kernels if KERNELS[0] in name)
    if not launches or ctx.peaks is None:
        return None
    if launches != ctx.counters["launches"]:
        raise RuntimeError(f"fused_trace: {launches} kernels in the trace, "
                           f"{ctx.counters['launches']} launches counted")
    c, B = ctx.config, ctx.traffic["batch"]
    flops = ctx.work.field_eval_flops(c, B, c["n_nodes"] * c["dim"], False)
    ops = ctx.work.seconds_at_peak(flops, ctx.peaks, c["matmul_precision"])
    data = ctx.work.fused_launch_bytes(c, B) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * launches * max(ops, data) / sum(times)
