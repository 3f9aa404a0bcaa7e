"""The readers of the program's spans (`spans.py`, `metrics/feval_host_ms.py`,
`feval_device_ms.py`, `field_idle_share.py`, `solve_self_ms.py`), on a
made-up traced window.

The window (seconds): one ``ecnf.solve`` span over [0, 10] holding two
``ecnf.field`` spans, [1, 3] and [5, 7].  Five launch calls, two outside
the field spans, put five operations on the device in launch order:

    launch at 0.5 -> k0 [0.7, 1.2]      (the solve's own)
    launch at 1.5 -> k1 [1.7, 2.2]      (field 1)
    launch at 2.0 -> k2 [2.5, 3.5]      (field 1; runs past the span's end)
    launch at 4.0 -> m3 [4.2, 4.4]      (a copy, the solve's own)
    launch at 5.5 -> k4 [6.0, 8.0]      (field 2)

Device idle inside the field spans: [1.2, 1.7], [2.2, 2.5] and [5, 6],
1.8 s; outside them [3.5, 4.2], [4.4, 5] and more, which no reader counts.
"""
from types import SimpleNamespace

import pytest

from bench_cells import harness, load_cell

SPANS = [("ecnf.solve", 0.0, 10.0), ("ecnf.field", 1.0, 3.0), ("ecnf.field", 5.0, 7.0)]
LAUNCHES = [("cudaLaunchKernel", 0.5, 0.6), ("cudaLaunchKernel", 1.5, 1.6),
            ("cudaLaunchKernelExC", 2.0, 2.1), ("cudaMemcpyAsync", 4.0, 4.1),
            ("cuLaunchKernelEx", 5.5, 5.6)]
OTHER_HOST = [("aten::mm", 1.4, 1.7), ("cudaStreamSynchronize", 8.0, 9.0)]
DEVICE = [("k0", 0.7, 1.2), ("k1", 1.7, 2.2), ("k2", 2.5, 3.5), ("Memcpy DtoH", 4.2, 4.4),
          ("k4", 6.0, 8.0)]
EXPECTED = {
    "feval_host_ms": 1e3 * (2.0 + 2.0) / 2,
    "feval_device_ms": 1e3 * (0.5 + 1.0 + 2.0) / 2,
    "field_idle_share": 100.0 * 1.8 / 10.0,
    "solve_self_ms": 1e3 * (10.0 - 4.0),
}


def _read(metric, host_ops, device_ops=DEVICE, workload="qm9.sample_hutch1_rk4"):
    cell = load_cell(workload)
    traced = dict(window_s=10.0, device_ops=list(device_ops), host_ops=list(host_ops),
                  field_evals=2)
    ctx = SimpleNamespace(config=cell["config"], traffic=cell["traffic"], traced=traced,
                          timed={}, kernels=[], counters={}, peaks=None, work=None)
    return harness.reader(metric).read(ctx)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_each_reader_gives_its_hand_computed_value(metric):
    host = OTHER_HOST + LAUNCHES[::-1] + SPANS  # in no particular order
    assert _read(metric, host) == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_the_fused_cell_reads_with_the_same_reader(metric):
    assert harness.reader(f"{metric}.fused") is harness.reader(metric)
    host = OTHER_HOST + LAUNCHES + SPANS
    assert _read(f"{metric}.fused", host, workload="lj13.sample_fused_rk4") == pytest.approx(
        EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_each_reader_reports_nothing_without_spans(metric):
    assert _read(metric, OTHER_HOST + LAUNCHES) is None


def test_launches_pair_with_operations_from_the_window_end():
    # The profiler lost the device record of the window's first launch: k0's.
    assert _read("feval_device_ms", OTHER_HOST + LAUNCHES + SPANS, DEVICE[1:]) == pytest.approx(
        EXPECTED["feval_device_ms"], rel=1e-12)
    # More operations than launch calls: nothing is linked.
    host = OTHER_HOST + LAUNCHES[1:] + SPANS
    assert _read("feval_device_ms", host) is None
    assert _read("feval_host_ms", host) == EXPECTED["feval_host_ms"]


def test_spans_split_the_device_time_without_remainder():
    spans = harness.load_module(harness.HERE / "spans.py")
    traced = dict(host_ops=OTHER_HOST + LAUNCHES + SPANS, device_ops=DEVICE)
    fields = spans.named(traced, "ecnf.field")
    inside = spans.launched_in(traced, fields)
    outside = [(s, e) for _, s, e in DEVICE if (s, e) not in inside]
    assert spans.length(inside) + spans.length(outside) == pytest.approx(
        harness.load_module(harness.HERE / "trace.py").busy_seconds(DEVICE))
