"""The reader of the resident edge-tangent design's share of launches
(`metrics/edge_tangent_resident_share.py`) on made-up traced windows: 100
where every launch is resident (the LJ55 cell), 0 where none is (the QM9
Hutchinson cell, or a program without the design), the share of a mix,
nothing without edge-tangent launches, and a fault when the trace and the
program's count of launches disagree."""
from types import SimpleNamespace

import pytest

from bench_cells import harness, load_cell

RESIDENT = ("void (anonymous namespace)::edge_tangent_bf16_kernel_resident<128>"
            "((anonymous namespace)::ResArgs, (anonymous namespace)::ResPlan)")
BLOCKS = "void (anonymous namespace)::edge_tangent_bf16_kernel<3>(Args<__nv_bfloat16>, Plan)"
F32 = "void (anonymous namespace)::edge_tangent_f32_kernel<2>(Args<float>, Plan)"
PRIMAL = "void (anonymous namespace)::edge_primal_bf16_kernel<64>(Args, PrimalPlan)"


def _read(kernels, launches, workload="lj55.sample_exact_b16_rk4"):
    cell = load_cell(workload)
    ctx = SimpleNamespace(config=cell["config"], traffic=cell["traffic"], traced={}, timed={},
                          kernels=kernels, counters={"launches": launches}, peaks=None, work=None)
    return harness.reader("edge_tangent_resident_share").read(ctx)


def test_every_launch_resident():
    kernels = [(RESIDENT, 3e-3), (PRIMAL, 1e-4), ("elementwise", 1e-5)] * 3
    assert _read(kernels, 3) == 100.0


@pytest.mark.parametrize("name", [BLOCKS, F32])
def test_no_launch_resident(name):
    kernels = [(name, 1e-3), (PRIMAL, 1e-4)] * 4
    assert _read(kernels, 4, "qm9.sample_hutch1_rk4") == 0.0


def test_a_mix():
    assert _read([(RESIDENT, 1e-3), (BLOCKS, 1e-3), (BLOCKS, 1e-3), (F32, 1e-3)], 4) == 25.0


def test_nothing_without_edge_tangent_launches():
    assert _read([(PRIMAL, 1e-4), ("fused_trace_kernel", 1e-2)], 0) is None
    assert _read([], 0) is None


def test_trace_and_count_must_agree():
    with pytest.raises(RuntimeError, match="launches counted"):
        _read([(RESIDENT, 1e-3)] * 3, 2)
