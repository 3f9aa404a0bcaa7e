#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ecnf_tpu_torch`) on one CUDA card.

Phases, one or more lines each:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: compile the edge-tangent CUDA kernel from ``ecnf_tpu_torch/csrc``;
3. kernel vs plain: the kernel against `edge_tangent_reference` at the
   LJ13 and QM9 shapes, in float32 and bfloat16, with times;
4. serving: ``python -m ecnf_tpu_torch.sample``'s code path at the full
   LJ13 width (3 blocks of [128]*3, hidden 64, bf16, batch 48, rk4 step
   0.05, exact trace), with its kernel launches counted; then the same
   solve in float32 through the kernel, through the plain version and
   through the ``torch.func.jvp`` trace;
5. the same serving run with the fixed-step Dopri5 solver;
6. timing of the serving solve with CUDA events, kernel path against
   plain path in turns (plain, kernel, kernel, plain, twice), median.

It then prints one JSON line per kernel, the card line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed phase raises, so the
script exits non-zero without a result line; so does a machine without a
CUDA device.

Usage: python3 chip_smoke.py
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys

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


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def phase_kernel_vs_plain(et) -> dict:
    results = {}
    for shape_name, shape in (("lj13", LJ13_EDGE), ("qm9", QM9_EDGE)):
        for dtype in (torch.float32, torch.bfloat16):
            args = edge_inputs(**shape, dtype=dtype, seed=1)
            kernel = et.edge_tangent(**args)
            plain = et.edge_tangent_reference(**args)
            torch.cuda.synchronize()
            abs_err = max((k - p).abs().max().item() for k, p in zip(kernel, plain))
            scale = max(p.abs().max().item() for p in plain)
            rel = abs_err / scale
            reps = 20 if shape_name == "lj13" else 5
            ms = cuda_ms(lambda: et.edge_tangent(**args), reps)
            plain_ms = cuda_ms(lambda: et.edge_tangent_reference(**args), reps)
            name = str(dtype).replace("torch.", "")
            print(
                f"[kernel] {shape_name} {shape} {name}: max_abs_err={abs_err:.3e} "
                f"rel={rel:.3e} (limit {EDGE_LIMITS[dtype]:.0e}) "
                f"kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us",
                flush=True,
            )
            check(math.isfinite(rel) and rel <= EDGE_LIMITS[dtype],
                  f"edge_tangent {shape_name} {name} rel error {rel:.3e}")
            results[(shape_name, name)] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms)
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


def phase_serving(et, sample, sampling) -> int:
    et.edge_tangent.launch_count = 0
    out = sample.main(LJ13_ARGS + ["--method", "rk4"])
    launches = et.edge_tangent.launch_count
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
    # The network's share of delta log-lik: the constant trace offset,
    # integrated over unit time, taken out.  Both comparisons resolve one
    # f32 ulp of log q (~4e-6 at |log q| ~ 49), so a 0 means "within it".
    _, offset = cnf.exact_trace_plan()
    net_k = cnf.log_prob_base(x0) - lq_k - offset
    # References: the plain edge chain, and the torch.func.jvp trace, which
    # shares no code with the hand-linearised tangent.
    for ref_name, ref_cfg in (
        ("plain", dataclasses.replace(cfg, structured_tangent_kernel=False)),
        ("jvp", dataclasses.replace(cfg, structured_tangent=False)),
    ):
        x1_r, lq_r = sampling.sample_and_log_prob_cnf(cnf, 48, feats, cfg=ref_cfg, x0=x0)
        net_r = cnf.log_prob_base(x0) - lq_r - offset
        rel = ((lq_k - lq_r).abs().max() / lq_r.abs().max()).item()
        net_rel = ((net_k - net_r).abs().max() / net_r.abs().max()).item()
        x_err = (x1_k - x1_r).abs().max().item()
        print(
            f"[serve] rk4 f32 kernel vs {ref_name}: log_q rel {rel:.3e}, network delta "
            f"log-lik rel {net_rel:.3e} (limit {LOGQ_LIMIT:.0e} each), x1 max abs "
            f"{x_err:.3e}, mean network delta {net_r.mean().item():.4f}",
            flush=True,
        )
        check(rel <= LOGQ_LIMIT and net_rel <= LOGQ_LIMIT,
              f"f32 vs {ref_name}: log_q rel {rel:.3e}, network delta rel {net_rel:.3e}")

    et.edge_tangent.launch_count = 0
    out = sample.main(LJ13_ARGS + ["--method", "dopri5"])
    launches_d = et.edge_tangent.launch_count
    print(f"[serve] dopri5 bf16: kernel launches {launches_d} (expected {DOPRI5_LAUNCHES})", flush=True)
    check(bool(torch.isfinite(torch.from_numpy(out["log_q"])).all()), "non-finite dopri5 log q")
    check(launches_d == DOPRI5_LAUNCHES, f"dopri5 launches {launches_d} != {DOPRI5_LAUNCHES}")
    return launches


def phase_timing(sample, sampling, card: str) -> None:
    args = sample.build_parser().parse_args(LJ13_ARGS)
    cnf = sample.build_from_args(args, torch.device("cuda"))
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(4))
    cfg = sampling.SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    paths = {
        "kernel": cfg,
        "plain": dataclasses.replace(cfg, structured_tangent_kernel=False),
    }
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain") * 2:
        c = paths[name]
        times[name].append(cuda_ms(lambda: sampling.sample_and_log_prob_cnf(cnf, 48, feats, cfg=c, x0=x0), 2))
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(
            f"[timing] lj13 rk4 bf16 B=48 sample+exact log q, {name} path: median "
            f"{ms:.1f} ms/solve, {48e3 / ms:.1f} samples/s (turns {[round(t, 1) for t in ts]}) on {card}",
            flush=True,
        )


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a card")
    from ecnf_tpu_torch import sample
    from ecnf_tpu_torch.cnf import sampling
    from ecnf_tpu_torch.ops import edge_tangent as et

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    path, seconds, log = et.build_library()
    print(f"[build] {path.name} in {seconds:.1f}s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    edge = phase_kernel_vs_plain(et)
    launches = phase_serving(et, sample, sampling)
    phase_timing(sample, sampling, card)

    main_path = edge[("lj13", "bfloat16")]
    print(json.dumps({"kernels": [{
        "name": "edge_tangent",
        "route": "cuda",
        "source": "ecnf_tpu_torch/csrc/edge_tangent.cu",
        "replaces": "ecnf_tpu/ops/pallas/tangent_kernel.py:344",
        "launches": launches,
        "max_abs_err": main_path["abs_err"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.exit(0)
