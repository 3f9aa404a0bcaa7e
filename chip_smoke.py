#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ecnf_tpu_torch`) on one CUDA card.

Phases, one or more lines each:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: compile the three CUDA kernels from ``ecnf_tpu_torch/csrc``, one
   nvcc each, all at once, with their register and spill lines and the
   count of tensor-core (HMMA) instructions in each library
   (``cuobjdump -sass``); each must have some, since every kernel's dense
   passes run on the tensor cores (bf16, or f32 in 3xTF32);
3. kernel vs plain: the edge-tangent kernel against
   `edge_tangent_reference` at the LJ13 and QM9 shapes, in float32 and
   bfloat16, with times, the default columns per thread block and its
   shared memory and blocks per SM; then the kernel at every column count
   per thread block that launches, each checked against the plain version
   at the same limit and timed;
4. serving: ``python -m ecnf_tpu_torch.sample``'s code path at the full
   LJ13 width (3 blocks of [128]*3, hidden 64, bf16, batch 48, rk4 step
   0.05, exact trace), with its kernel launches counted; then the same
   solve in float32 through the kernel, through the plain version and
   through the ``torch.func.jvp`` trace;
5. the same serving run with the fixed-step Dopri5 solver;
6. EGCL forward: `flat_egnn_apply_fused`'s kernel against its plain
   version at LJ13 width (B=48 and the B=256 of `scripts/bench_pallas.py`)
   and at QM9 width (5 blocks of [256]*4, hidden 32, B=64), f32, with
   times, bound, achieved TFLOP/s and share of the bound; then an rk4
   sample-only solve whose field is
   `flat_egnn_apply_fused`, its launches counted, against the solve
   through the field module;
7. fused trace: `egnn_value_and_div_fused`'s kernel against its plain
   version at LJ13 (B=48) and for one QM9 evaluation (B=64, 57 columns),
   with times, bound, achieved TFLOP/s and share of the bound, and the
   kernel's time at every column count per thread block that launches;
8. fused serving: ``python -m ecnf_tpu_torch.sample --fused-trace`` at the
   full LJ13 width with its launches counted, then the float32 solve with
   ``fused_trace=True`` against the phase-4 references;
9. timing of the serving solve with CUDA events, in turns (a, b, b, a,
   twice; median): the structured path's kernel against its plain
   version (bf16), and the fused path's kernel against its plain version,
   with the edge kernel's share of the structured solve and the fused
   kernel's share of the fused solve;
10. train step (`ecnf_tpu_torch.training`, the plain torch EGNN under
   autograd, as in JAX; no custom kernel runs, and the counts must stay
   0): (a) f32 parity of the card against the CPU on the same weights,
   data, x0 and t, three updates at microbatch 1 and 4 with EMA; (b) the
   QM9 flagship step of the JAX `bench.py` (B=256, bf16, EMA, Adam 1e-4) at
   microbatch 4 and 1: first step apart, then ms per step by CUDA events,
   steps/s, peak device memory, TFLOP/s against the dense bf16 peak, and
   the device's busy share in a `torch.profiler` trace of a few steps; (c)
   the loss falls on a fixed LJ13 batch through `epoch`.

Bounds: the larger of the bytes a kernel must move (inputs read once,
outputs written once) at 3.35 TB/s and its operations at the card's peak
for their type.  Operations count only the [U, U] edge layers (B N^2 rows
per stream), so each bound is a lower bound: bf16 products at 989 TFLOP/s;
f32-accurate ones as three TF32 products at 495 TFLOP/s (3xTF32, the
tensor-core route the f32 kernels take, which beats f32 FMAs at 67).

It then prints one JSON line listing every kernel, the card line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase raises, so the
script exits non-zero without a result line; so does a machine without a
CUDA device.

Usage: python3 chip_smoke.py
"""
import concurrent.futures
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

LJ13_EDGE = dict(K=36, B=48, N=13, U=128, L=3)
QM9_EDGE = dict(K=54, B=64, N=19, U=256, L=4)
# Kernel vs plain version: max |kernel - plain| / max |plain| over both
# outputs.  float32 differs only by the order of f32 sums; bfloat16 also
# by the rare bf16 rounding that a different f32 sum order flips.
EDGE_LIMITS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Serving solve in float32, kernel path vs plain path: relative log q.
LOGQ_LIMIT = 1e-3
LJ13_ARGS = [
    "--n-nodes", "13", "--n-samples", "48", "--batch-size", "48",
    "--with-log-prob", "--dtype", "bfloat16", "--seed", "0", "--device", "cuda",
]
RK4_LAUNCHES = 20 * 4 * 3  # steps x stages x blocks
DOPRI5_LAUNCHES = (1 + 20 * 6) * 3  # (FSAL first stage + steps x 6) x blocks
FUSED_LAUNCHES = 20 * 4  # steps x stages: one launch per field evaluation
# The f32 kernels (EGCL forward, fused trace) against their plain versions:
# max |kernel - plain| / max |plain| of the field value and of the
# network's share of the trace; both differ only by the order of f32 sums.
F32_LIMIT = 1e-4
# (name, nodes, mlp_units, hidden, blocks, batch) of the EGCL-forward phase.
EGCL_SHAPES = (
    ("lj13", 13, (128,) * 3, 64, 3, 48),
    ("lj13", 13, (128,) * 3, 64, 3, 256),
    ("qm9", 19, (256,) * 4, 32, 5, 64),
)
KERNELS = ("edge_tangent", "egcl", "fused_trace")
# Train phase.  (a) the sizes of `tests/test_torch_train.py`; (b) the QM9
# flagship step of the JAX `bench.py:363-373,412-437`; (c) LJ13 width
# (`bench.py:352-360`).
TRAIN_SMALL = dict(n=5, blocks=2, units=(32, 32), hidden=16, batch=8)
QM9_TRAIN = dict(n=19, blocks=5, units=(256,) * 4, hidden=32, batch=256)
LJ13_TRAIN = dict(n=13, blocks=3, units=(128,) * 3, hidden=64, batch=48)
TRAIN_STEPS = 30  # timed steps per microbatch setting, after the first
PROFILE_STEPS = 3
# (a) bands: loss, grad_norm, update_norm rtol, params and EMA absolute, as
# in the CPU tests (Adam's g / (|g| + 1e-8) amplifies gradient differences
# of components with |g| near 1e-8, up to 2 lr).  Gradient leaves within
# GRAD_RTOL of the leaf's largest |g|: the CPU tests hold 1e-5 against JAX,
# but cuBLAS sums in another order than the CPU, and the first block's gate
# weight, whose gradient is a cancelling sum over the B N^2 edge rows,
# lands at 1.5e-5 of its own largest entry (every other leaf at <= 3.8e-6);
# the CUDA embedding backward also sums with atomics.
TRAIN_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 5e-6
EMA_ATOL = 1e-6
# (c) the loss must fall: mean of the last 5 below this share of the first 5
# (0.81-0.84 over five seeds on the CPU, `tests/test_torch_train.py`).
LOSS_FALL = 0.9
LJ13_UPDATES = 50
# Published H100 SXM peaks (dense): HBM bytes/s, bf16 and TF32 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {message}")


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launch_count`` counts its launches."""
    from ecnf_tpu_torch.ops import edge_tangent, egcl, fused_trace

    return dict(zip(KERNELS, (
        edge_tangent.edge_tangent, egcl.egcl_fused, fused_trace.egnn_value_and_div_fused,
    )))


def zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a path is driven."""
    for fn in _wrappers().values():
        fn.launch_count = 0


def counts() -> dict:
    return {name: fn.launch_count for name, fn in _wrappers().items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def edge_flop(rows: int, streams: int, L: int, U: int, blocks: int = 1) -> float:
    """FLOP of the [U, U] edge layers (L - 1 of phi_e, L of phi_x) over
    ``rows`` edge rows for ``streams`` streams (primal and tangents)."""
    return 2.0 * rows * streams * (2 * L - 1) * blocks * U * U


def bound(flop: float, nbytes: float, flops_per_s: float, products: int = 1) -> dict:
    """Least time for the work: ms and what bounds it."""
    ops_ms = products * flop / flops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flop=flop)


def train_step_flops(batch: int, n: int, dim: int, hidden: int, temb: int, units, blocks: int) -> dict:
    """Matmul FLOP of one flow-matching train step of the EGNN field, as
    `ecnf_tpu/ops/flops.py: count_fn_flops` counts the JAX update: each
    forward product, then in the backward one product for the weight and
    one more for any input that depends on the parameters.  The positions
    of the first block depend on none; the last block's gate and phi_h feed
    nothing, so they have no backward.  ``f32`` is the geometry's share
    (the Gram matrix and the aggregation), the rest runs in the compute
    dtype.  Microbatching leaves the count unchanged."""
    P, Q = batch * n * n, batch * n  # edge rows, node rows
    U = list(units)
    pairs = list(zip(U[:-1], U[1:]))
    total = f32 = 0.0
    for i in range(blocks):
        first, last = i == 0, i == blocks - 1
        geo = 2 * P * dim * ((1 if first else 3) + (2 if first else 3))  # gram, w @ x
        f = 2 * Q * hidden * hidden * 3 + 2 * batch * temb * hidden * 2  # time Dense
        f += 2 * Q * hidden * U[0] * 3 * 2 + 2 * P * U[0] * (2 if first else 3)  # phi_e first
        f += sum(2 * P * a * b * 3 for a, b in pairs)  # phi_e tail
        f += (2 * P * U[-1] * U[0] + sum(2 * P * a * b for a, b in pairs)) * 3  # phi_x
        f += 2 * P * U[-1] * 3  # phi_x_out
        gate = 2 * P * U[-1]
        phi_h = (2 * Q * (U[-1] + hidden) * U[0] + sum(2 * Q * a * b for a, b in pairs)
                 + 2 * Q * U[-1] * hidden)
        f += (gate + phi_h) * (1 if last else 3)
        total += f + geo
        f32 += geo
    return dict(total=total, f32=f32)


def rate_line(b: dict, ms: float) -> str:
    return (f"bound={b['bound_ms'] * 1e3:.1f}us ({b['bound_by']}) "
            f"achieved={b['flop'] / ms / 1e9:.1f} TFLOP/s share={b['bound_ms'] / ms:.3f}")


def _cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, or Triton's copy of it."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidates = [Path(cuda_home) / "bin" / "cuobjdump"]
    try:
        import triton

        candidates.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("cuobjdump")
    check(found is not None, "cuobjdump not found")
    return found


def hmma_count(library: Path) -> int:
    """Tensor-core (HMMA) instructions in a built library's SASS."""
    out = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                         timeout=300, check=True)
    return sum(line.count("HMMA") for line in out.stdout.splitlines())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_inputs(K, B, N, U, L, dtype, seed):
    """Random kernel arguments with the value ranges of the real residuals."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    cd = lambda x: x.to(dtype).contiguous()
    g = rand(B, N, N)
    return dict(
        a_t=cd(randn(K, B, N, U)), b_t=cd(randn(K, B, N, U)),
        l2_t=randn(K, B, N, N),
        d_e=[cd(rand(B, N, N, U, lo=-0.1, hi=1.1)) for _ in range(L)],
        d_x=[cd(rand(B, N, N, U, lo=-0.1, hi=1.1)) for _ in range(L)],
        m=cd(rand(B, N, N, U, lo=-0.3, hi=2.0)), g=cd(g), gd=cd(g * (1 - g)),
        e_l=cd(randn(U)),
        e_tail=[cd(randn(U, U, scale=U**-0.5)) for _ in range(L - 1)],
        x_tail=[cd(randn(U, U, scale=U**-0.5)) for _ in range(L)],
        x_out=cd(randn(U, scale=U**-0.5)), g_out=cd(randn(U, scale=U**-0.5)),
    )


def nbytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (lists, tuples and dict values
    searched)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            total += nbytes(*o)
    return total


def edge_errors(kernel, plain):
    """(max |kernel - plain|, that over max |plain|) of both outputs."""
    abs_err = max((k - p).abs().max().item() for k, p in zip(kernel, plain))
    return abs_err, abs_err / max(p.abs().max().item() for p in plain)


def phase_kernel_vs_plain(et) -> dict:
    results = {}
    for shape_name, shape in (("lj13", LJ13_EDGE), ("qm9", QM9_EDGE)):
        for dtype in (torch.float32, torch.bfloat16):
            args = edge_inputs(**shape, dtype=dtype, seed=1)
            kernel = et.edge_tangent(**args)
            plain = et.edge_tangent_reference(**args)
            torch.cuda.synchronize()
            abs_err, rel = edge_errors(kernel, plain)
            reps = 20 if shape_name == "lj13" else 5
            ms = cuda_ms(lambda: et.edge_tangent(**args), reps)
            plain_ms = cuda_ms(lambda: et.edge_tangent_reference(**args), reps)
            name = str(dtype).replace("torch.", "")
            K, B, N, U, L = (shape[k] for k in ("K", "B", "N", "U", "L"))
            b = bound(edge_flop(B * N * N, K, L, U), nbytes(args, kernel),
                      *((BF16_FLOPS, 1) if dtype == torch.bfloat16 else (TF32_FLOPS, 3)))
            cols = et.default_columns(0, dtype, K, B, N, U, L)
            plan = et.launch_plan(0, dtype, K, B, N, U, L, cols)
            if dtype == torch.bfloat16:
                residuals = "silu' rows streamed into shared memory with the weights"
            elif plan["staged"]:
                residuals = "residuals staged in shared memory"
            else:
                residuals = "residuals read from global memory"
            print(
                f"[kernel] {shape_name} {shape} {name}: max_abs_err={abs_err:.3e} "
                f"rel={rel:.3e} (limit {EDGE_LIMITS[dtype]:.0e}) "
                f"kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us {rate_line(b, ms)}; "
                f"{cols} columns per thread block: {plan['smem_bytes']} B of shared memory, "
                f"{plan['blocks_per_sm']} blocks per SM, {plan['row_tiles']} row tiles per warp, "
                f"{residuals}",
                flush=True,
            )
            check(math.isfinite(rel) and rel <= EDGE_LIMITS[dtype],
                  f"edge_tangent {shape_name} {name} rel error {rel:.3e}")
            results[(shape_name, name)] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **b)
            # Every column count per thread block that launches (the default
            # is the kernel's cost model's pick; this shows what each costs).
            sweep = []
            for c in range(1, K + 1):
                try:
                    et.launch_plan(0, dtype, K, B, N, U, L, c)
                except ValueError:
                    break
                run = lambda: et.edge_tangent(**args, columns_per_block=c)
                _, rel_c = edge_errors(run(), plain)
                check(math.isfinite(rel_c) and rel_c <= EDGE_LIMITS[dtype],
                      f"edge_tangent {shape_name} {name} columns {c}: rel error {rel_c:.3e}")
                sweep.append(f"{c}:{cuda_ms(run, max(reps // 4, 2)):.3f}")
            print(f"[kernel] {shape_name} {name} ms per launch by columns per thread block "
                  f"(each within the limit): {' '.join(sweep)}", flush=True)
            del args, kernel, plain
            torch.cuda.empty_cache()
    return results


def redraw_dense_(field, seed: int) -> None:
    """Dense kernels -> N(0, 1/fan_in), so the network's trace is O(1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                w = torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1])
                p.copy_(w)


def phase_serving(sample, sampling):
    """Returns the rk4 launch count and the float32 comparison's set-up
    and references, which phase 8 reuses: ``(launches, f32)``."""
    zero_counts()
    out = sample.main(LJ13_ARGS + ["--method", "rk4"])
    launches = counts()["edge_tangent"]
    print(f"[serve] rk4 bf16: kernel launches {launches} (expected {RK4_LAUNCHES})", flush=True)
    check(out["samples"].shape == (48, 39), f"samples shape {out['samples'].shape}")
    check(bool(torch.isfinite(torch.from_numpy(out["samples"])).all()), "non-finite samples")
    check(bool(torch.isfinite(torch.from_numpy(out["log_q"])).all()), "non-finite log q")
    check(launches == RK4_LAUNCHES, f"rk4 launches {launches} != {RK4_LAUNCHES}")

    # float32, kernel path vs plain path, same x0, weights with an O(1) trace.
    args = sample.build_parser().parse_args(LJ13_ARGS + ["--dtype", "float32"])
    cnf = sample.build_from_args(args, torch.device("cuda"))
    redraw_dense_(cnf.field, seed=2)
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(3))
    cfg = sampling.SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    x1_k, lq_k = sampling.sample_and_log_prob_cnf(cnf, 48, feats, cfg=cfg, x0=x0)
    check(bool(torch.isfinite(lq_k).all()), "non-finite f32 log q")
    _, offset = cnf.exact_trace_plan()
    # References: the plain edge chain, and the torch.func.jvp trace, which
    # shares no code with the hand-linearised tangent.
    refs = {}
    for ref_name, ref_cfg in (
        ("plain", dataclasses.replace(cfg, structured_tangent_kernel=False)),
        ("jvp", dataclasses.replace(cfg, structured_tangent=False)),
    ):
        refs[ref_name] = sampling.sample_and_log_prob_cnf(cnf, 48, feats, cfg=ref_cfg, x0=x0)
        compare_solves("rk4 f32 kernel", (x1_k, lq_k), ref_name, refs[ref_name], cnf, x0, offset)

    zero_counts()
    out = sample.main(LJ13_ARGS + ["--method", "dopri5"])
    launches_d = counts()["edge_tangent"]
    print(f"[serve] dopri5 bf16: kernel launches {launches_d} (expected {DOPRI5_LAUNCHES})", flush=True)
    check(bool(torch.isfinite(torch.from_numpy(out["log_q"])).all()), "non-finite dopri5 log q")
    check(launches_d == DOPRI5_LAUNCHES, f"dopri5 launches {launches_d} != {DOPRI5_LAUNCHES}")
    return launches, dict(cnf=cnf, feats=feats, x0=x0, cfg=cfg, refs=refs)


def compare_solves(name, out, ref_name, ref, cnf, x0, offset) -> None:
    """log q and the network's share of delta log-lik (the constant trace
    offset, integrated over unit time, taken out) of two solves from x0.
    Both comparisons resolve one f32 ulp of log q (~4e-6 at |log q| ~ 49),
    so a 0 means "within it"."""
    (x1, lq), (x1_r, lq_r) = out, ref
    net = cnf.log_prob_base(x0) - lq - offset
    net_r = cnf.log_prob_base(x0) - lq_r - offset
    rel = ((lq - lq_r).abs().max() / lq_r.abs().max()).item()
    net_rel = ((net - net_r).abs().max() / net_r.abs().max()).item()
    x_err = (x1 - x1_r).abs().max().item()
    print(
        f"[serve] {name} vs {ref_name}: log_q rel {rel:.3e}, network delta "
        f"log-lik rel {net_rel:.3e} (limit {LOGQ_LIMIT:.0e} each), x1 max abs "
        f"{x_err:.3e}, mean network delta {net_r.mean().item():.4f}",
        flush=True,
    )
    check(rel <= LOGQ_LIMIT and net_rel <= LOGQ_LIMIT,
          f"{name} vs {ref_name}: log_q rel {rel:.3e}, network delta rel {net_rel:.3e}")


def f32_cnf(n, units, hidden, blocks, seed):
    """An f32 CNF on the card with Dense kernels at N(0, 1/fan_in)."""
    from ecnf_tpu_torch.cnf.build import build_cnf

    cnf = build_cnf(
        n_frames=n, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
        n_features=1, device="cuda", generator=torch.Generator().manual_seed(seed),
    )
    redraw_dense_(cnf.field, seed=seed + 1)
    return cnf


def field_inputs(n, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, n * 3), generator=gen).cuda()
    t = torch.rand((batch,), generator=gen).cuda()
    return x, t, torch.zeros((batch, n), dtype=torch.int64, device="cuda")


def rel_err(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def phase_egcl(egcl, ode) -> dict:
    results = {}
    for name, n, units, hidden, blocks, B in EGCL_SHAPES:
        cnf = f32_cnf(n, units, hidden, blocks, seed=5)
        x, t, f = field_inputs(n, B, seed=6)
        w = egcl.egnn_weights(cnf.field.egnn)
        kernel = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w)
        plain = egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w, use_kernel=False)
        torch.cuda.synchronize()
        abs_err = (kernel - plain).abs().max().item()
        rel = rel_err(kernel, plain)
        ms = cuda_ms(lambda: egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w), 10)
        plain_ms = cuda_ms(
            lambda: egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w, use_kernel=False), 10
        )
        U, L, P = units[0], len(units), w.flat.shape[1]
        moved = 4 * blocks * (2 * B * n * 3 + 2 * B * n * hidden + B * 8 + P)
        b = bound(edge_flop(B * n * n, 1, L, U, blocks), moved, TF32_FLOPS, products=3)
        print(
            f"[egcl] {name} B={B} N={n} U={U} L={L} blocks={blocks} f32 "
            f"forward: max_abs_err={abs_err:.3e} rel={rel:.3e} (limit {F32_LIMIT:.0e}) "
            f"kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us ({blocks} launches) "
            f"{rate_line(b, ms)}",
            flush=True,
        )
        check(math.isfinite(rel) and rel <= F32_LIMIT, f"egcl {name} B={B} rel error {rel:.3e}")
        results[(name, B)] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **b)
        del cnf, w, kernel, plain
        torch.cuda.empty_cache()

    # The pure-sampling use: an rk4 solve whose field is the fused forward.
    cnf = f32_cnf(13, (128,) * 3, 64, 3, seed=7)
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(8))
    w = egcl.egnn_weights(cnf.field.egnn)
    kw = dict(use_fixed_step_size=True, step_size=0.05, method="rk4")
    zero_counts()
    x1, _ = ode.odeint(
        lambda t, y: egcl.flat_egnn_apply_fused(cnf.field, y, t, feats, w), x0, 0.0, 1.0, **kw
    )
    torch.cuda.synchronize()
    launches = counts()["egcl"]
    with torch.no_grad():
        x1_r, _ = ode.odeint(lambda t, y: cnf.apply(y, t, feats), x0, 0.0, 1.0, **kw)
    rel = rel_err(x1, x1_r)
    print(
        f"[egcl] lj13 rk4 sample-only solve B=48 through the fused forward: launches "
        f"{launches} (expected {RK4_LAUNCHES}), x1 rel to the module's solve {rel:.3e} "
        f"(limit {F32_LIMIT:.0e})",
        flush=True,
    )
    check(bool(torch.isfinite(x1).all()), "non-finite fused-forward samples")
    check(launches == RK4_LAUNCHES, f"egcl launches {launches} != {RK4_LAUNCHES}")
    check(rel <= F32_LIMIT, f"fused-forward solve rel {rel:.3e}")
    results["launches"] = launches
    return results


def phase_fused_kernel(fused_trace) -> dict:
    results = {}
    for name, n, units, hidden, blocks, B, reps in (
        ("lj13", 13, (128,) * 3, 64, 3, 48, 10),
        ("qm9", 19, (256,) * 4, 32, 5, 64, 2),
    ):
        cnf = f32_cnf(n, units, hidden, blocks, seed=9)
        x, t, f = field_inputs(n, B, seed=10)
        w = cnf.fused_weights()
        v, d = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w)
        v_p, d_p = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w, use_kernel=False)
        torch.cuda.synchronize()
        offset = 3 * cnf.field.egnn.final_scaling.detach()
        v_rel, net_rel = rel_err(v, v_p), rel_err(d + offset, d_p + offset)
        abs_err = max((v - v_p).abs().max().item(), (d - d_p).abs().max().item())
        cols = fused_trace.default_columns(0, B, n, 3, hidden, 8, units[0])
        ms = cuda_ms(lambda: fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w), reps)
        plain_ms = cuda_ms(
            lambda: fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w, use_kernel=False), reps
        )
        U, L, ND, P = units[0], len(units), n * 3, w.flat.shape[1]
        moved = 4 * (2 * B * ND + B * n * hidden + B * 8 + blocks * P + 1 + B)
        b = bound(edge_flop(B * n * n, 1 + ND, L, U, blocks), moved, TF32_FLOPS, products=3)
        print(
            f"[fused] {name} B={B} N={n} U={U} L={L} blocks={blocks} "
            f"{ND} columns ({cols} per thread block): v rel {v_rel:.3e}, network trace "
            f"rel {net_rel:.3e} (limit {F32_LIMIT:.0e} each; max |network trace| "
            f"{(d_p + offset).abs().max().item():.3f}), max_abs_err={abs_err:.3e} "
            f"kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us {rate_line(b, ms)}",
            flush=True,
        )
        check(math.isfinite(v_rel) and v_rel <= F32_LIMIT, f"fused {name} v rel {v_rel:.3e}")
        check(math.isfinite(net_rel) and net_rel <= F32_LIMIT, f"fused {name} trace rel {net_rel:.3e}")
        results[name] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **b)
        # Every column count per thread block that launches (the choice above
        # is the kernel's own, from a cost model; this shows what it costs).
        sweep = []
        for c in range(1, ND + 1):
            run = lambda: fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w, columns_per_block=c)
            try:
                run()
            except RuntimeError:
                break
            sweep.append(f"{c}:{cuda_ms(run, reps):.3f}")
        print(f"[fused] {name} ms per launch by columns per thread block: {' '.join(sweep)}", flush=True)
        del cnf, w, v, d, v_p, d_p
        torch.cuda.empty_cache()
    return results


def phase_fused_serving(sample, sampling, f32) -> int:
    zero_counts()
    out = sample.main(LJ13_ARGS + ["--fused-trace", "--method", "rk4"])
    launches = counts()["fused_trace"]
    print(f"[serve] rk4 --fused-trace: kernel launches {launches} (expected {FUSED_LAUNCHES})", flush=True)
    check(out["samples"].shape == (48, 39), f"samples shape {out['samples'].shape}")
    check(bool(torch.isfinite(torch.from_numpy(out["samples"])).all()), "non-finite fused samples")
    check(bool(torch.isfinite(torch.from_numpy(out["log_q"])).all()), "non-finite fused log q")
    check(launches == FUSED_LAUNCHES, f"fused launches {launches} != {FUSED_LAUNCHES}")

    cnf, x0 = f32["cnf"], f32["x0"]
    cfg = dataclasses.replace(f32["cfg"], fused_trace=True)
    out = sampling.sample_and_log_prob_cnf(cnf, 48, f32["feats"], cfg=cfg, x0=x0)
    check(bool(torch.isfinite(out[1]).all()), "non-finite f32 fused log q")
    _, offset = cnf.exact_trace_plan()
    for ref_name, ref in f32["refs"].items():
        compare_solves("rk4 f32 fused", out, ref_name, ref, cnf, x0, offset)
    return launches


def phase_timing(sample, sampling, fused_trace, card: str, edge_ms: float,
                 fused_ms: float) -> dict:
    """Serving solve per path, ms (median of turns a, b, b, a, twice).
    ``edge_ms`` and ``fused_ms`` are the edge kernel's (LJ13 bf16) and the
    fused kernel's times per launch from phases 3 and 7."""
    args = sample.build_parser().parse_args(LJ13_ARGS)
    cnf = sample.build_from_args(args, torch.device("cuda"))
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(4))
    cfg = sampling.SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    fused_cfg = dataclasses.replace(cfg, fused_trace=True)

    def fused_plain(x, t, f, weights=None):
        return fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, use_kernel=False)

    paths = {
        "kernel": (cnf, cfg, "bf16"),
        "plain": (cnf, dataclasses.replace(cfg, structured_tangent_kernel=False), "bf16"),
        "fused kernel": (cnf, fused_cfg, "f32"),
        "fused plain": (cnf._replace(fused_value_and_div=fused_plain), fused_cfg, "f32"),
    }
    times = {name: [] for name in paths}
    for a, b in (("plain", "kernel"), ("fused plain", "fused kernel")):
        for name in (a, b, b, a) * 2:
            c, c_cfg, _ = paths[name]
            times[name].append(cuda_ms(
                lambda: sampling.sample_and_log_prob_cnf(c, 48, feats, cfg=c_cfg, x0=x0), 2
            ))
    medians = {}
    for name, ts in times.items():
        ms = medians[name] = statistics.median(ts)
        trace = "exact trace over 36 zero-CoM columns" if "fused" not in name else "exact trace over all 39 columns"
        print(
            f"[timing] lj13 rk4 B=48 sample+exact log q, {name} path ({paths[name][2]} MLPs, "
            f"{trace}): median {ms:.1f} ms/solve, {48e3 / ms:.1f} samples/s "
            f"(turns {[round(t, 1) for t in ts]}) on {card}",
            flush=True,
        )
    share = RK4_LAUNCHES * edge_ms / medians["kernel"]
    print(
        f"[timing] structured kernel path: {RK4_LAUNCHES} edge launches x {edge_ms:.3f} ms "
        f"(phase 3) = {RK4_LAUNCHES * edge_ms:.1f} ms, {100 * share:.1f}% of the solve",
        flush=True,
    )
    share = FUSED_LAUNCHES * fused_ms / medians["fused kernel"]
    print(
        f"[timing] fused kernel path: {FUSED_LAUNCHES} launches x {fused_ms:.3f} ms (phase 7) = "
        f"{FUSED_LAUNCHES * fused_ms:.1f} ms, {100 * share:.1f}% of the solve",
        flush=True,
    )
    return medians


def _train_cnf(q: dict, device, cdt=None, seed=0, n_features=1, sigma_min=0.01, base_scale=1.0):
    from ecnf_tpu_torch.cnf.build import build_cnf

    return build_cnf(
        n_frames=q["n"], dim=3, sigma_min=sigma_min, base_scale=base_scale,
        n_blocks_egnn=q["blocks"], mlp_units=q["units"], n_invariant_feat_hidden=q["hidden"],
        time_embedding_dim=8, n_features=n_features, compute_dtype=cdt, device=device,
        generator=torch.Generator().manual_seed(seed),
    )


def _train_parity(training) -> None:
    """(a) three f32 updates on the card against the same on the CPU."""
    import numpy as np

    optim, state_mod = training
    q = TRAIN_SMALL
    B, D = q["batch"], q["n"] * 3
    cpu = _train_cnf(q, "cpu", n_features=2, seed=11)
    # Dense kernels at N(0, 1/fan_in), biases at N(0, 0.1^2), from numpy.
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for name, p in cpu.field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                p.copy_(torch.from_numpy(rng.normal(0, p.shape[1] ** -0.5, p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    card = _train_cnf(q, "cuda", n_features=2, seed=11)
    card.field.load_state_dict(cpu.field.state_dict())
    steps = [
        dict(x=rng.normal(size=(B, D)), noise=rng.normal(size=(B, D)), t=rng.uniform(size=(B,)))
        for _ in range(3)
    ]
    feats = np.tile(np.arange(q["n"]) % 2, (B, 1))
    for microbatch in (1, 4):
        opt = optim.build_optimizer(1e-3)
        runs = {}
        for device, cnf in (("cpu", cpu), ("cuda", card)):
            gen = torch.Generator(device=device).manual_seed(0)
            runs[device] = [cnf, state_mod.init_training_state(cnf, opt, gen, use_ema=True),
                            state_mod.make_update_fn(cnf, opt, use_ema=True, microbatch=microbatch)]
        worst = dict(info=0.0, grad=0.0, grad_global=0.0, param=0.0, ema=0.0)
        failures = []
        leaf_errs = []
        for i, step in enumerate(steps):
            out = {}
            for device, (cnf, st, update) in runs.items():
                as_t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(device, dt)
                x0 = cnf.sample_base((B,), noise=as_t(step["noise"]))
                args = (as_t(step["x"]), as_t(feats, torch.int64))
                grads, _ = state_mod.loss_and_grads(cnf, st.params, *args, microbatch, x0=x0,
                                                    t=as_t(step["t"]))
                st, info = update(st, *args, x0=x0, t=as_t(step["t"]))
                runs[device][1] = st
                out[device] = (grads, info, st)
            (g_c, i_c, s_c), (g_g, i_g, s_g) = out["cpu"], out["cuda"]
            where = f"train parity mb{microbatch} step {i}"
            for name in i_c:
                rel = abs(i_g[name].item() - i_c[name].item()) / abs(i_c[name].item())
                worst["info"] = max(worst["info"], rel)
                if rel > TRAIN_RTOL:
                    failures.append(f"{where}: {name} rel {rel:.3e}")
            global_scale = max(b.abs().max().item() for b in g_c)
            for name, a, b in zip(s_c.params, g_g, g_c):
                scale = b.abs().max().item()
                err = (a.cpu() - b).abs().max().item()
                leaf_errs.append((err / scale if scale else err, err, scale, f"step {i} {name}"))
                worst["grad"] = max(worst["grad"], err / scale if scale else err)
                worst["grad_global"] = max(worst["grad_global"], err / global_scale)
                if err > GRAD_RTOL * scale:
                    failures.append(f"{where}: grad {name} err {err:.3e} of scale {scale:.3e}")
            for key, tree_c, tree_g, atol in (("param", s_c.params, s_g.params, PARAM_ATOL),
                                               ("ema", s_c.ema_params, s_g.ema_params, EMA_ATOL)):
                err = max((tree_g[n].cpu() - tree_c[n]).abs().max().item() for n in tree_c)
                worst[key] = max(worst[key], err)
                if err > atol:
                    failures.append(f"{where}: {key} max abs {err:.3e}")
        leaf_errs.sort(reverse=True)
        print(f"[train] (a) microbatch {microbatch}: largest gradient-leaf errors (of the leaf's "
              f"own largest |g|): " + "; ".join(f"{r:.2e} ({e:.2e} of {sc:.2e}) {n}"
                                                 for r, e, sc, n in leaf_errs[:4]), flush=True)
        print(
            f"[train] (a) f32 card vs CPU, 3 updates, microbatch {microbatch}, EMA, Adam 1e-3: "
            f"loss/grad_norm/update_norm rel {worst['info']:.3e} (limit {TRAIN_RTOL:.0e}), "
            f"gradient leaves {worst['grad']:.3e} of the leaf's scale (limit {GRAD_RTOL:.0e}), "
            f"{worst['grad_global']:.3e} of the gradient's, "
            f"params {worst['param']:.3e} (limit {PARAM_ATOL:.0e}), EMA {worst['ema']:.3e} "
            f"(limit {EMA_ATOL:.0e})",
            flush=True,
        )
        check(not failures, "; ".join(failures[:6]))


def _profile_step(step) -> tuple:
    """Device kernel ms and kernels per step of ``step``, from a
    `torch.profiler` trace of PROFILE_STEPS runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return kernel_ms / PROFILE_STEPS, len(kernels) / PROFILE_STEPS


def _train_flagship(training, card: str) -> dict:
    """(b) the QM9 flagship step at microbatch 4, then 1."""
    import numpy as np

    optim, state_mod = training
    q = QM9_TRAIN
    B, D = q["batch"], q["n"] * 3
    cnf = _train_cnf(q, "cuda", cdt="bfloat16", sigma_min=1e-6, base_scale=2.0)
    data = torch.from_numpy(
        np.random.default_rng(0).normal(size=(TRAIN_STEPS + 1, B, D)).astype(np.float32)
    ).cuda()
    feats = torch.zeros((B, q["n"]), dtype=torch.int64, device="cuda")
    flops = train_step_flops(B, q["n"], 3, q["hidden"], 8, q["units"], q["blocks"])
    opt = optim.build_optimizer(1e-4)
    results = {}
    for microbatch in (4, 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = state_mod.init_training_state(cnf, opt, torch.Generator(device="cuda").manual_seed(0),
                                           use_ema=True)
        update = state_mod.make_update_fn(cnf, opt, use_ema=True, microbatch=microbatch)
        start = time.perf_counter()
        st, info = update(st, data[0], feats)
        first_loss = info["loss"].item()
        first_s = time.perf_counter() - start
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(TRAIN_STEPS)]
        losses = []
        for i, (ev_start, ev_end) in enumerate(events):
            ev_start.record()
            st, info = update(st, data[i + 1], feats)
            ev_end.record()
            losses.append(info["loss"])
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in events)
        losses = torch.stack(losses).cpu()
        check(math.isfinite(first_loss) and bool(torch.isfinite(losses).all()),
              f"QM9 train microbatch {microbatch}: non-finite loss")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(ms)
        box = {"st": st}

        def one_step():
            box["st"], _ = update(box["st"], data[0], feats)

        kernel_ms, n_kernels = _profile_step(one_step)
        tflops = flops["total"] / med / 1e9
        results[microbatch] = dict(ms=med, first_s=first_s, peak_gb=peak_gb, tflops=tflops,
                                   busy=kernel_ms / med)
        print(
            f"[train] (b) QM9 flagship step (B={B}, N={q['n']}, {q['blocks']} blocks of "
            f"{list(q['units'])}, hidden {q['hidden']}, bf16, EMA, Adam 1e-4), microbatch "
            f"{microbatch}: first step {first_s:.3f} s (loss {first_loss:.4f}); {TRAIN_STEPS} steps "
            f"by CUDA events: median {med:.3f} ms/step, min {ms[0]:.3f}, max {ms[-1]:.3f}, "
            f"p10-p90 {ms[len(ms) // 10]:.3f}-{ms[(9 * len(ms)) // 10]:.3f}; "
            f"{1e3 / med:.2f} steps/s; peak device memory {peak_gb:.2f} GB; "
            f"{flops['total'] / 1e12:.4f} TFLOP a step ({flops['f32'] / 1e9:.3f} GFLOP of it f32) "
            f"-> {tflops:.1f} TFLOP/s, {tflops / (BF16_FLOPS / 1e12):.4f} of the dense bf16 peak "
            f"(989); profiler over {PROFILE_STEPS} steps: {n_kernels:.0f} device kernels and "
            f"{kernel_ms:.3f} ms of device kernel time a step, busy share {kernel_ms / med:.3f} "
            f"of the median step; last loss {losses[-1].item():.4f}; on {card}",
            flush=True,
        )
        del st, box
        torch.cuda.empty_cache()
    return results


def _train_progress(training, setup) -> None:
    """(c) the loss falls on one fixed LJ13 batch, through `epoch`."""
    import numpy as np

    optim, state_mod = training
    q = LJ13_TRAIN
    cnf = _train_cnf(q, "cuda", cdt="bfloat16")
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(q["batch"], q["n"] * 3)).astype(np.float32)
    ).cuda()
    feats = torch.zeros((q["batch"], q["n"]), dtype=torch.int64, device="cuda")
    opt = optim.build_optimizer(1e-3)
    st = state_mod.init_training_state(cnf, opt, torch.Generator(device="cuda").manual_seed(0))
    update = state_mod.make_update_fn(cnf, opt, microbatch=2)
    losses = []
    for _ in range(LJ13_UPDATES):
        st, infos = setup.epoch(st, update, x, feats, q["batch"])
        losses.append(infos["loss"])
    losses = torch.cat(losses).cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    print(
        f"[train] (c) LJ13 width (3 blocks of [128]*3, hidden 64, bf16, B={q['batch']}), one fixed "
        f"batch, {LJ13_UPDATES} updates through epoch, Adam 1e-3, microbatch 2: mean loss of the "
        f"first 5 {first:.4f}, of the last 5 {last:.4f}, ratio {last / first:.3f} (limit "
        f"{LOSS_FALL})",
        flush=True,
    )
    check(bool(torch.isfinite(losses).all()), "LJ13 train: non-finite loss")
    check(last < LOSS_FALL * first, f"LJ13 train: loss ratio {last / first:.3f} >= {LOSS_FALL}")


def phase_train(card: str) -> dict:
    """The train step: (a) parity, (b) the QM9 flagship step, (c) progress.
    The path runs no custom kernel, as in JAX: every count stays 0."""
    from ecnf_tpu_torch.training import optim, setup
    from ecnf_tpu_torch.training import state as state_mod

    training = (optim, state_mod)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "train parity needs allow_tf32 False")
    zero_counts()
    _train_parity(training)
    torch.set_float32_matmul_precision(precision)
    results = _train_flagship(training, card)
    _train_progress(training, setup)
    launched = counts()
    check(not any(launched.values()), f"the train path launched custom kernels: {launched}")
    return results


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a card")
    from ecnf_tpu_torch import sample
    from ecnf_tpu_torch.cnf import sampling
    from ecnf_tpu_torch.ops import cuda_build, egcl, fused_trace, ode
    from ecnf_tpu_torch.ops import edge_tangent as et

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(cuda_build.build_library, KERNELS))
    for name, (path, seconds, log) in zip(KERNELS, builds):
        hmma = hmma_count(path)
        print(f"[build] {path.name} in {seconds:.1f}s, {hmma} HMMA instructions", flush=True)
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        check(hmma > 0, f"{name}: no tensor-core instructions")

    edge = phase_kernel_vs_plain(et)
    launches, f32 = phase_serving(sample, sampling)
    egcl_results = phase_egcl(egcl, ode)
    fused = phase_fused_kernel(fused_trace)
    fused_launches = phase_fused_serving(sample, sampling, f32)
    phase_timing(sample, sampling, fused_trace, card, edge[("lj13", "bfloat16")]["ms"],
                 fused["lj13"]["ms"])
    phase_train(card)

    # Per kernel, its main-path shapes: the LJ13 structured solve's bf16
    # edge chain (one launch), the LJ13 B=48 EGNN forward (three launches)
    # and one LJ13 fused evaluation.  No single PyTorch call computes any
    # of these functions, so library_ms is null.
    rows = (
        ("edge_tangent", "edge_tangent.cu", "tangent_kernel.py:374", launches, edge[("lj13", "bfloat16")]),
        ("egcl_forward", "egcl.cu", "attic/egcl_kernel.py:200", egcl_results["launches"],
         egcl_results[("lj13", 48)]),
        ("fused_trace", "fused_trace.cu", "attic/trace_kernel.py:171", fused_launches, fused["lj13"]),
    )
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"ecnf_tpu_torch/csrc/{source}",
            "replaces": f"ecnf_tpu/ops/pallas/{replaces}",
            "launches": n,
            "max_abs_err": r["abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for name, source, replaces, n, r in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.exit(0)
