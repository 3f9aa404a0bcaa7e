"""Readings that the limits of a cell's check are set from, on the card at the
cell's own size, in one process (set-up, the kernels' builds and the CUDA
context are paid once).

    python3 h100_bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... [--dump <dir>]

For each of ``--seeds``: the cell's set-up from that seed, a window of
``--seconds``, and the check's numbers for the program (the lower reading
is their largest).  For each of ``--control-seeds`` (a seed in both lists
is set up once): the same numbers with the control in the program's place,
the reference one precision below the configuration's (fp8 products for
bf16, TF32 products for f32); for a bf16 sampling mix also the reference
in bf16 with only its tangent's products in fp8 (a trace route that drops
below the configuration's precision while x1 stays as it is); for a
training mix also the reference on half of each batch in its place.
``--dump`` writes each sampling seed's compared rows, program and
references, to ``<dir>/<cell>.<seed>.pt``.  Prints one JSON line per seed and a summary
line last.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def control_precision(cell: dict) -> str:
    """One precision below the one the configuration states for the
    products: the fused route runs in f32 whatever the compute dtype."""
    if cell["traffic"].get("trace") == "fused":
        return CONTROL["float32"]
    return CONTROL[cell["config"]["compute_dtype"]]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--dump", default="")
    args = p.parse_args()

    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    harness.host_settings(cell)
    device = torch.device("cuda", 0)
    control = control_precision(cell)
    program, controls = [], []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        start = time.perf_counter()
        run = harness.driver(cell).Run(cell, harness.reference(cell), seed, device)
        timed = run.window(args.seconds)
        run.release()
        readings = {}
        kinds = []
        if cell["traffic"]["driver"] == "sample":
            if seed in args.control_seeds:
                kinds = [control] + (["bf16_fp8_tangent"] if run.precision() == "bf16"
                                     and cell["traffic"]["trace"] != "fused" else [])
            rows = run.compared_rows()
            checking = time.perf_counter()
            refs = run.references(list(dict.fromkeys(run.yardsticks() + kinds)))
            readings["check_seconds"] = time.perf_counter() - checking
            if seed in args.seeds:
                readings["program"] = run.gaps((rows["x1"], rows["log_q"]), refs)
            for kind in kinds:
                readings[kind] = run.gaps(refs[kind], refs)
            if args.dump:
                cpu = lambda ts: tuple(t.cpu() for t in ts)
                torch.save(dict(seed=seed, rows={k: v.cpu() for k, v in rows.items() if v is not None},
                                refs={k: cpu(v) for k, v in refs.items()}),
                           Path(args.dump) / f"{args.workload}.{seed}.pt")
        else:
            if seed in args.seeds:
                readings["program"] = {k: c["value"] for k, c in run.check().items()}
            if seed in args.control_seeds:
                kinds = [control, "half_batch"]
                readings[control] = {k: c["value"] for k, c in run.check(control=control).items()}
                readings["half_batch"] = {k: c["value"] for k, c in run.check(half_batch=True).items()}
        if "program" in readings:
            program.append(readings["program"])
        if kinds:
            controls.append(readings)
        print(json.dumps(dict(seed=seed, failed=run.failed, seconds=time.perf_counter() - start,
                              end_to_end=timed["end_to_end"], **readings)), flush=True)
        del run
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "card": harness.card_lines()[0], "control": control,
               "lower": {k: max(r[k] for r in program) for k in program[0]}}
    for kind in (control, "half_batch", "bf16_fp8_tangent"):
        rows = [c[kind] for c in controls if kind in c]
        if rows:
            summary[f"least_{kind}"] = {k: min(r[k] for r in rows) for k in rows[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
