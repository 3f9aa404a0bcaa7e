"""The trace reduction and the per-layer readers, on made-up events."""
from types import SimpleNamespace

import pytest

from bench_cells import harness, load_cell

trace = harness.load_module(harness.HERE / "trace.py")
work = harness.load_module(harness.HERE / "work" / "egnn.py")
PEAKS = {"bf16_flops_per_s": 989e12, "tf32_flops_per_s": 495e12, "hbm_bytes_per_s": 3.35e12}


def test_busy_time_is_the_union_and_gaps_are_named_by_the_innermost_host_op():
    device = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("Memcpy HtoD", 4.0, 5.0)]
    host = [("outer", -1.0, 10.0), ("inner", 2.5, 3.5)]
    assert trace.busy_seconds(device) == 3.0
    assert trace.idle_gaps(device, host) == [["inner", 2.0]]
    assert trace.top_device_ops(device)[0] == ["k2", 1.5]
    assert not trace.is_kernel("Memcpy HtoD") and trace.is_kernel("k1")


def _ctx(workload, kernels, counters, **traced):
    cell = load_cell(workload)
    return SimpleNamespace(config=cell["config"], traffic=cell["traffic"], work=work, peaks=PEAKS,
                           timed={"seconds": 30.0, "field_evals": 800, "steps": 600},
                           traced=dict(traced), kernels=kernels, counters=counters)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_edge_roofline_reads_the_named_kernel_and_holds_it_to_the_count():
    read = _reader("edge_tangent_roofline").read
    kernels = [("void edge_tangent_bf16_kernel<1>(Args)", 1e-3)] * 240 + [("other", 5.0)]
    share = read(_ctx("lj13.sample_exact_rk4", kernels, {"launches": 240}))
    bound = work.seconds_at_peak(work.edge_chain_flops(36, 64, 13, 128, 3, True), PEAKS, "highest")
    assert bound > work.edge_chain_bytes(36, 64, 13, 128, 3, True) / 3.35e12  # bound by products
    assert share == pytest.approx(100 * bound / 1e-3)
    assert read(_ctx("lj13.sample_exact_rk4", [("other", 1.0)], {"launches": 0})) is None
    with pytest.raises(RuntimeError):
        read(_ctx("lj13.sample_exact_rk4", kernels, {"launches": 239}))


def test_shares_and_counts():
    ctx = _ctx("lj13.sample_fused_rk4",
               [("fused_trace_kernel<1>", 0.012), ("sum_partials", 1e-5)] * 80, {"launches": 80},
               field_evals=80, busy_s=0.9, window_s=1.0, device_ops=[("x", 0, 1)])
    assert 0 < _reader("fused_trace_roofline").read(ctx) < 100
    assert _reader("kernels_per_feval").read(ctx) == 2.0
    assert _reader("idle_share.sample").read(ctx) == pytest.approx(10.0)
    mfu = _reader("mfu.sample").read(ctx)
    flops = work.field_eval_flops(ctx.config, 64, 39, False)[1]
    assert mfu == pytest.approx(100 * 800 * flops / (495e12 / 3) / 30.0)
    train = _ctx("qm9.train_mb1", [("k", 1e-4)] * 100, {}, steps=10, busy_s=0.5, window_s=1.0,
                 device_ops=[("k", 0, 1)])
    assert _reader("kernels_per_step").read(train) == 10.0
    assert 0 < _reader("mfu.train").read(train) < 100
