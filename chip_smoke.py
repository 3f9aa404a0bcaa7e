#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ecnf_tpu_torch`) on one CUDA card.

Phases, one or more lines each:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: compile the three CUDA kernels from ``ecnf_tpu_torch/csrc``, one
   nvcc each, all at once, with their register and spill lines;
3. kernel vs plain: the edge-tangent kernel against
   `edge_tangent_reference` at the LJ13 and QM9 shapes, in float32 and
   bfloat16, with times;
4. serving: ``python -m ecnf_tpu_torch.sample``'s code path at the full
   LJ13 width (3 blocks of [128]*3, hidden 64, bf16, batch 48, rk4 step
   0.05, exact trace), with its kernel launches counted; then the same
   solve in float32 through the kernel, through the plain version and
   through the ``torch.func.jvp`` trace;
5. the same serving run with the fixed-step Dopri5 solver;
6. EGCL forward: `flat_egnn_apply_fused`'s kernel against its plain
   version at LJ13 width (B=48 and the B=256 of `scripts/bench_pallas.py`)
   and at QM9 width (5 blocks of [256]*4, hidden 32, B=64), f32, with
   times; then an rk4 sample-only solve whose field is
   `flat_egnn_apply_fused`, its launches counted, against the solve
   through the field module;
7. fused trace: `egnn_value_and_div_fused`'s kernel against its plain
   version at LJ13 (B=48) and for one QM9 evaluation (B=64, 57 columns);
8. fused serving: ``python -m ecnf_tpu_torch.sample --fused-trace`` at the
   full LJ13 width with its launches counted, then the float32 solve with
   ``fused_trace=True`` against the phase-4 references;
9. timing of the serving solve with CUDA events, in turns (a, b, b, a,
   twice; median): the structured path's kernel against its plain
   version (bf16), and the fused path's kernel against its plain version.

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
        print(
            f"[egcl] {name} B={B} N={n} U={units[0]} L={len(units)} blocks={blocks} f32 "
            f"forward: max_abs_err={abs_err:.3e} rel={rel:.3e} (limit {F32_LIMIT:.0e}) "
            f"kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us ({blocks} launches)",
            flush=True,
        )
        check(math.isfinite(rel) and rel <= F32_LIMIT, f"egcl {name} B={B} rel error {rel:.3e}")
        results[(name, B)] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms)
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
        print(
            f"[fused] {name} B={B} N={n} U={units[0]} L={len(units)} blocks={blocks} "
            f"{n * 3} columns ({cols} per thread block): v rel {v_rel:.3e}, network trace "
            f"rel {net_rel:.3e} (limit {F32_LIMIT:.0e} each; max |network trace| "
            f"{(d_p + offset).abs().max().item():.3f}), max_abs_err={abs_err:.3e} "
            f"kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us",
            flush=True,
        )
        check(math.isfinite(v_rel) and v_rel <= F32_LIMIT, f"fused {name} v rel {v_rel:.3e}")
        check(math.isfinite(net_rel) and net_rel <= F32_LIMIT, f"fused {name} trace rel {net_rel:.3e}")
        results[name] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms)
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


def phase_timing(sample, sampling, fused_trace, card: str) -> dict:
    """Serving solve per path, ms (median of turns a, b, b, a, twice)."""
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
    return medians


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
    for path, seconds, log in builds:
        print(f"[build] {path.name} in {seconds:.1f}s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    edge = phase_kernel_vs_plain(et)
    launches, f32 = phase_serving(sample, sampling)
    egcl_results = phase_egcl(egcl, ode)
    fused = phase_fused_kernel(fused_trace)
    fused_launches = phase_fused_serving(sample, sampling, f32)
    phase_timing(sample, sampling, fused_trace, card)

    main_path = edge[("lj13", "bfloat16")]
    egcl_main = egcl_results[("lj13", 48)]
    print(json.dumps({"kernels": [
        {
            "name": "edge_tangent",
            "route": "cuda",
            "source": "ecnf_tpu_torch/csrc/edge_tangent.cu",
            "replaces": "ecnf_tpu/ops/pallas/tangent_kernel.py:344",
            "launches": launches,
            "max_abs_err": main_path["abs_err"],
            "ms": main_path["ms"],
            "plain_ms": main_path["plain_ms"],
        },
        {
            "name": "egcl_forward",
            "route": "cuda",
            "source": "ecnf_tpu_torch/csrc/egcl.cu",
            "replaces": "ecnf_tpu/ops/pallas/attic/egcl_kernel.py:55",
            "launches": egcl_results["launches"],
            "max_abs_err": egcl_main["abs_err"],
            "ms": egcl_main["ms"],
            "plain_ms": egcl_main["plain_ms"],
        },
        {
            "name": "fused_trace",
            "route": "cuda",
            "source": "ecnf_tpu_torch/csrc/fused_trace.cu",
            "replaces": "ecnf_tpu/ops/pallas/attic/trace_kernel.py:130",
            "launches": fused_launches,
            "max_abs_err": fused["lj13"]["abs_err"],
            "ms": fused["lj13"]["ms"],
            "plain_ms": fused["lj13"]["plain_ms"],
        },
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
