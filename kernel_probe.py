#!/usr/bin/env python3
"""Where the kernels' thread blocks spend their clocks, on one CUDA card.

Builds the fused-trace, EGCL-forward and edge-tangent kernels with
``-DECNF_PROBE``
(``ECNF_CUDA_DEFINES``; see `ecnf_tpu_torch/ops/cuda_build.py`), whose
thread 0 of every thread block adds the SM clocks it spends in each part
(`ProbePart` in ``ecnf_tpu_torch/csrc/egnn_device.cuh``) to a device
counter, and prints, per kernel and shape: the share of the blocks' clocks
in the tensor-core dense passes (barrier and weight waits among them
apart), in the silu passes, in the receiver's first-layer term (CUDA
cores), in the row dots of the gate and phi_x outputs and elsewhere, and
the mean clocks per thread block.  Shapes are those of `chip_smoke.py`:
the fused trace at LJ13 (B=48, 39 columns) and QM9 (B=64, 57 columns),
the EGCL forward at LJ13 (B=48) and QM9 (B=64), and the edge-tangent
kernel at `chip_smoke.py`'s LJ13 and QM9 points in float32 and bfloat16
(there the epilogues of the dense passes, which apply the silu' factors,
are reported inside the dense share, and the row dots include the mi_t
sum; the blocks design at its cost model's C, since the resident bf16
design has no probes).  The probe build's time per launch is printed
beside, and differs from the plain build's by the probes' own cost.
First it prints the card's rates for the tensor-core instructions the
dense passes use
(``csrc/mma_peak.cu``): mma.sync TF32, the ceiling of the 3xTF32 route,
and mma.sync bf16, that of the edge kernel's bf16 route.

Usage: python3 kernel_probe.py
"""
import ctypes
import os
import sys

import torch

PARTS = ("total", "dense", "dense_wait", "silu", "first", "row_dots")
PUBLISHED_TF32_TFLOPS = 495.0  # H100 SXM, dense, reached only through wgmma
PUBLISHED_BF16_TFLOPS = 989.0


def mma_peak() -> None:
    from ecnf_tpu_torch.ops.cuda_build import load_library

    lib = load_library("mma_peak")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    for name, fn, published, products in (
        ("m16n8k8 TF32", lib.ecnf_mma_tf32_tflops, PUBLISHED_TF32_TFLOPS, 3),
        ("m16n8k16 bf16", lib.ecnf_mma_bf16_tflops, PUBLISHED_BF16_TFLOPS, 1),
    ):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        tflops = ctypes.c_double()
        err = fn(out.data_ptr(), 4096, ctypes.byref(tflops))
        if err != 0:
            raise RuntimeError(f"kernel_probe: mma_peak {name} failed (cudaError {err})")
        tail = (f"; a 3xTF32 product at that rate: {tflops.value / 3:.1f} f32 TFLOP/s"
                if products == 3 else "")
        print(
            f"[probe] mma.sync {name} on this card: {tflops.value:.1f} TFLOP/s "
            f"({tflops.value / published:.3f} of the published {published:.0f}){tail}",
            flush=True,
        )


def read_clocks(lib) -> dict:
    out = (ctypes.c_ulonglong * len(PARTS))()
    err = lib.ecnf_probe_clocks_read(out)
    if err != 0:
        raise RuntimeError(f"kernel_probe: reading the probes failed (cudaError {err})")
    return dict(zip(PARTS, out))


def report(label: str, lib, run, blocks: int, reps: int, edge: bool = False) -> None:
    """One line of shares of the thread blocks' clocks.  ``edge``: the
    edge-tangent kernel, whose epilogue clocks (the "silu" part) lie
    inside its dense passes and whose first part is its first layer."""
    from chip_smoke import cuda_ms

    run()
    torch.cuda.synchronize()
    read_clocks(lib)  # clears
    run()
    torch.cuda.synchronize()
    c = read_clocks(lib)
    ms = cuda_ms(run, reps)
    total = c["total"]
    if edge:
        other = total - c["dense"] - c["first"] - c["row_dots"]
        parts = (f"dense {c['dense'] / total:.3f} (of which waits at its barriers "
                 f"{c['dense_wait'] / total:.3f}, register epilogues {c['silu'] / total:.3f}), "
                 f"first layer {c['first'] / total:.3f}, row dots and mi_t sum "
                 f"{c['row_dots'] / total:.3f}")
    else:
        other = total - c["dense"] - c["silu"] - c["first"] - c["row_dots"]
        parts = (f"dense {c['dense'] / total:.3f} (of which waits at its barriers "
                 f"{c['dense_wait'] / total:.3f}), silu {c['silu'] / total:.3f}, receiver's "
                 f"first-layer term {c['first'] / total:.3f}, row dots {c['row_dots'] / total:.3f}")
    print(
        f"[probe] {label}: {total / blocks:.0f} clocks per thread block ({blocks} blocks), "
        f"{parts}, other {other / total:.3f}; probe build {ms:.3f} ms per call",
        flush=True,
    )


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device; this script runs only on a card")
    os.environ["ECNF_CUDA_DEFINES"] = " ".join(
        os.environ.get("ECNF_CUDA_DEFINES", "").split() + ["ECNF_PROBE"]
    )
    from chip_smoke import EGCL_SHAPES, LJ13_EDGE, QM9_EDGE, card_line, edge_inputs, f32_cnf, field_inputs
    from ecnf_tpu_torch.ops import edge_tangent as et
    from ecnf_tpu_torch.ops import egcl, fused_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[probe] {card_line()}", flush=True)
    mma_peak()
    for mod in (egcl, fused_trace, et):
        mod._library().ecnf_probe_clocks_read.argtypes = [ctypes.c_void_p]

    for name, shape in (("lj13", LJ13_EDGE), ("qm9", QM9_EDGE)):
        for dtype in (torch.bfloat16, torch.float32):
            args = edge_inputs(**shape, dtype=dtype, seed=1)
            K, B, N, U, L = (shape[k] for k in ("K", "B", "N", "U", "L"))
            cols = et.default_columns(0, dtype, K, B, N, U, L)
            report(f"edge {name} {str(dtype)[6:]} ({cols} columns per thread block)", et._library(),
                   lambda: et.edge_tangent(**args, columns_per_block=cols), -(-K // cols) * N * B,
                   20 if name == "lj13" else 5, edge=True)
            del args
            torch.cuda.empty_cache()

    for name, n, units, hidden, blocks, B in EGCL_SHAPES:
        cnf = f32_cnf(n, units, hidden, blocks, seed=5)
        x, t, f = field_inputs(n, B, seed=6)
        w = egcl.egnn_weights(cnf.field.egnn)
        report(f"egcl {name} B={B} ({blocks} launches)", egcl._library(),
               lambda: egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w), blocks * B * n, 10)

    for name, n, units, hidden, blocks, B, reps in (
        ("lj13", 13, (128,) * 3, 64, 3, 48, 10),
        ("qm9", 19, (256,) * 4, 32, 5, 64, 2),
    ):
        cnf = f32_cnf(n, units, hidden, blocks, seed=9)
        x, t, f = field_inputs(n, B, seed=10)
        w = cnf.fused_weights()
        cols = fused_trace.default_columns(0, B, n, 3, hidden, 8, units[0])
        chunks = -(-n * 3 // cols)
        report(f"fused {name} B={B} ({cols} columns per thread block)", fused_trace._library(),
               lambda: fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w), B * chunks, reps)


if __name__ == "__main__":
    main()
    sys.exit(0)
