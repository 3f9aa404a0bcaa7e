"""The reader of the primal edge-chain kernel's roofline share
(`metrics/edge_primal_roofline.py`) on made-up traced windows of the QM9
Hutchinson cell: its value by hand, nothing from a program without the
kernel (the fused cell, an older program), and a fault when the trace and
the program's count of launches disagree."""
import json
from types import SimpleNamespace

import pytest

from bench_cells import harness, load_cell

PEAKS = json.loads((harness.HERE / "work" / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
KERNEL = "void (anonymous namespace)::edge_primal_bf16_kernel<4>(Args, PrimalPlan)"


def _read(kernels, launches, workload="qm9.sample_hutch1_rk4", peaks=PEAKS):
    cell = load_cell(workload)
    ctx = SimpleNamespace(config=cell["config"], traffic=cell["traffic"], traced={}, timed={},
                          kernels=kernels, counters={"launches": launches}, peaks=peaks,
                          work=None)
    return harness.reader("edge_primal_roofline").read(ctx)


def test_the_share_by_hand():
    # QM9 Hutchinson: B=256, N=19, U=256, L=4.  Bytes bound it:
    # 2 x 256 x 19 x 256 x 2 in, 92,416 x 4 in, (7 x 65,536 + 11 x 256 + 2) x 2 in;
    # 9 x 92,416 x 256 x 2, 92,416 x 4, 2 x 92,416 x 2 and 256 x 19 x 256 x 4 out.
    edges = 256 * 19 * 19
    nbytes = (2 * 256 * 19 * 256 * 2 + edges * 4 + (7 * 65536 + 11 * 256 + 2) * 2
              + 9 * edges * 256 * 2 + edges * 4 + 2 * edges * 2 + 256 * 19 * 256 * 4)
    least = nbytes / PEAKS["hbm_bytes_per_s"]
    assert least > 2.0 * edges * 256 * (256 * 7 + 2) / PEAKS["bf16_flops_per_s"]
    kernels = [(KERNEL, 500e-6), ("other_kernel", 1.0), (KERNEL, 700e-6)]
    assert _read(kernels, 2) == pytest.approx(100.0 * 2 * least / 1.2e-3, rel=1e-12)


@pytest.mark.parametrize("workload", ["qm9.sample_hutch1_rk4", "lj13.sample_fused_rk4"])
def test_nothing_without_the_kernel(workload):
    assert _read([("edge_tangent_bf16_kernel", 1e-3)], 0, workload) is None
    assert _read([(KERNEL, 1e-3)], 1, peaks=None) is None


def test_trace_and_count_must_agree():
    with pytest.raises(RuntimeError, match="launches counted"):
        _read([(KERNEL, 1e-3)] * 3, 2)
