"""Run one cell of the benchmark of `ecnf_tpu_torch` once, on this machine's card.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (builds the program, makes its weights and inputs from the
seed, warms up every shape), measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` (each compared number
beside its limit).  It exits non-zero and prints no result when there is
no CUDA card, when the program cannot be imported, when a module of JAX or
of the JAX package was loaded, or when anything fails.
"""
import time

PROCESS_START = time.perf_counter()

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    import harness

    cell = harness.load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: this cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    harness.host_settings(cell)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                              PROCESS_START)
    for line in harness.card_lines():
        print(line, flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"no result: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
