"""Share of the edge-tangent kernel's launches in the traced window that
ran its resident bf16 design (`edge_tangent_bf16_kernel_resident`), in
percent.  Launches come from the trace, by the kernel names below, held to
the program's own count of edge-tangent launches; which design ran, from
the name.  A program without the resident design reads 0 where it
launches the edge-tangent kernel, and every program reads nothing where
it does not."""

KERNELS = ("edge_tangent_bf16_kernel", "edge_tangent_f32_kernel")
RESIDENT = "edge_tangent_bf16_kernel_resident"
COUNTERS = {"launches": "ecnf_tpu_torch.ops.edge_tangent:edge_tangent"}


def read(ctx):
    names = [name for name, _ in ctx.kernels if any(k in name for k in KERNELS)]
    if not names:
        return None
    if len(names) != ctx.counters["launches"]:
        raise RuntimeError(f"edge_tangent: {len(names)} kernels in the trace, "
                           f"{ctx.counters['launches']} launches counted")
    return 100.0 * sum(RESIDENT in name for name in names) / len(names)
