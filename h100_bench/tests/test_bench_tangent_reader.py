"""The reader of the tangent pass's device time
(`metrics/tangent_device_ms.py`) on a made-up traced window, as
`test_bench_spans.py` holds the readers of the other spans.

The window (seconds): two ``ecnf.field`` spans, [1, 3] and [5, 7], each
holding an ``ecnf.field.primal`` span then an ``ecnf.field.tangent`` span
([1, 1.8] and [1.8, 3]; [5, 5.4] and [5.4, 7]).  Launches:

    launch at 0.5 -> k0 [0.7, 1.2]      (outside the fields)
    launch at 1.5 -> k1 [1.7, 2.2]      (field 1, its primal)
    launch at 2.0 -> k2 [2.5, 3.5]      (field 1, its tangent; runs past its end)
    launch at 5.5 -> k4 [6.0, 8.0]      (field 2, its tangent)

The tangent passes' device time: k2 and k4, 3 s over 2 evaluations.
"""
from types import SimpleNamespace

import pytest

from bench_cells import harness, load_cell

FIELDS = [("ecnf.field", 1.0, 3.0), ("ecnf.field", 5.0, 7.0)]
PARTS = [("ecnf.field.primal", 1.0, 1.8), ("ecnf.field.tangent", 1.8, 3.0),
         ("ecnf.field.primal", 5.0, 5.4), ("ecnf.field.tangent", 5.4, 7.0)]
LAUNCHES = [("cudaLaunchKernel", 0.5, 0.6), ("cudaLaunchKernel", 1.5, 1.6),
            ("cudaLaunchKernelExC", 2.0, 2.1), ("cuLaunchKernelEx", 5.5, 5.6)]
DEVICE = [("k0", 0.7, 1.2), ("k1", 1.7, 2.2), ("k2", 2.5, 3.5), ("k4", 6.0, 8.0)]


def _read(host_ops, workload="lj55.sample_exact_b16_rk4"):
    cell = load_cell(workload)
    traced = dict(window_s=10.0, device_ops=list(DEVICE), host_ops=list(host_ops), field_evals=2)
    ctx = SimpleNamespace(config=cell["config"], traffic=cell["traffic"], traced=traced,
                          timed={}, kernels=[], counters={}, peaks=None, work=None)
    return harness.reader("tangent_device_ms").read(ctx)


@pytest.mark.parametrize("workload", ["lj55.sample_exact_b16_rk4", "qm9.sample_hutch1_rk4"])
def test_the_value_by_hand(workload):
    host = LAUNCHES[::-1] + PARTS + FIELDS  # in no particular order
    assert _read(host, workload) == pytest.approx(1e3 * (1.0 + 2.0) / 2, rel=1e-12)


def test_nothing_from_a_program_without_the_tangent_spans():
    assert _read(LAUNCHES + FIELDS) is None
    assert _read(LAUNCHES + PARTS) is None
    assert _read(LAUNCHES) is None


def test_the_tangent_part_is_at_most_the_evaluation():
    feval = harness.reader("feval_device_ms")
    cell = load_cell("lj55.sample_exact_b16_rk4")
    traced = dict(window_s=10.0, device_ops=list(DEVICE), host_ops=LAUNCHES + PARTS + FIELDS)
    ctx = SimpleNamespace(config=cell["config"], traffic=cell["traffic"], traced=traced)
    assert _read(LAUNCHES + PARTS + FIELDS) < feval.read(ctx)
