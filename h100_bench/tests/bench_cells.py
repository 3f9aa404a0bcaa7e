"""Cells of the benchmark cut to a size that the CPU tests can hold."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import harness  # noqa: E402

WORKLOADS = [w["name"] for w in harness.manifest()["workloads"]]
# Cells whose files are in place but which BENCHMARK.json does not list yet.
LATER = [{"name": "lj13.sample_exact_rk4", "config": "lj13", "traffic": "sample_exact_rk4",
          "chips": 1, "why": "closed loop, B=64, rk4, exact log q through the structured tangent"},
         {"name": "qm9.train_mb1", "config": "qm9", "traffic": "train_mb1", "chips": 1,
          "why": "closed loop of train steps, B=256, one-shot gradient, Adam and EMA"}]
ALL = WORKLOADS + [c["name"] for c in LATER]


def load_cell(workload: str) -> dict:
    bench = harness.manifest()
    bench["workloads"] += LATER
    return harness.load_cell(workload, bench)


def tiny_cell(workload: str, n_nodes: int = 6) -> dict:
    """The cell cut to one EGNN block, and for sampling to ``n_nodes`` nodes
    and a batch of 8; its widths, precision, solver, trace route, optimizer
    and limits as they are.  The widths stay because the rounding that the
    limits are set against grows with them; a training cell keeps its batch
    and nodes because its loss is a mean over them."""
    cell = load_cell(workload)
    cell["config"]["n_blocks_egnn"] = 1
    if cell["traffic"]["driver"] == "sample":
        cell["config"]["n_nodes"] = n_nodes
        cell["traffic"]["batch"] = 8
    return cell
