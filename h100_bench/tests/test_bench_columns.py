"""The reference for many nodes (`reference/egnn_columns.py`) against the
reference it loads (`reference/egnn.py`), on the CPU at N = 5: the field
value and the exact trace over the identity columns, taken in blocks of
columns with the primal shared, equal `egnn.py`'s up to the order of
float32 sums; with probes, and in the fp8 precisions, whose scales are
per tensor, it is `egnn.py`'s own pass."""
import pytest
import torch

from bench_cells import harness, load_cell

CPU = torch.device("cpu")
TINY = dict(n_nodes=5, mlp_units=[32, 32], n_blocks_egnn=2, n_invariant_feat_hidden=16)


def _setup(seed=3, B=4):
    cell = load_cell("lj55.sample_exact_b16_rk4")
    cfg = dict(cell["config"], **TINY)
    columns = harness.reference(cell)
    gen = torch.Generator().manual_seed(seed)
    W = harness.make_weights(columns.param_shapes(cfg), gen, CPU)
    x = torch.randn(B, cfg["n_nodes"] * cfg["dim"], generator=gen)
    t = torch.rand(B, generator=gen)
    features = torch.zeros(B, cfg["n_nodes"], dtype=torch.int64)
    return cfg, columns, W, x, t, features


def test_it_loads_egnn_and_takes_its_parameters():
    cfg, columns, *_ = _setup()
    egnn = harness.load_module(harness.HERE / "reference" / "egnn.py")
    assert columns.param_shapes(cfg) == egnn.param_shapes(cfg)


@pytest.mark.parametrize("precision", ["f32", "bf16", "tf32"])
@pytest.mark.parametrize("block", [1, 4, 15])
def test_field_and_trace_equal_egnn(precision, block):
    cfg, columns, W, x, t, features = _setup()
    value, div = columns.egnn.field_and_divergence(W, cfg, x, t, features, precision=precision)
    v, d = columns.field_and_divergence(W, cfg, x, t, features, precision=precision,
                                        columns=block)
    assert torch.equal(v, value)
    torch.testing.assert_close(d, div, rtol=1e-6, atol=1e-6)
    assert div.abs().max() > 0.1


def test_samples_and_log_q_equal_egnn():
    cfg, columns, W, x, _, features = _setup(seed=4, B=3)
    x0 = harness.remove_mean(x, cfg["n_nodes"], cfg["dim"])
    x1, log_q = columns.egnn.sample_and_log_q(W, cfg, x0, features, 4)
    y1, log_p = columns.sample_and_log_q(W, cfg, x0, features, 4, columns=6)
    torch.testing.assert_close(y1, x1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(log_p, log_q, rtol=1e-6, atol=1e-5)


def test_probes_take_egnn_hutchinson_estimate():
    cfg, columns, W, x, t, features = _setup(seed=5)
    probes = torch.randn(x.shape, generator=torch.Generator().manual_seed(6))
    out = columns.field_and_divergence(W, cfg, x, t, features, probes)
    ref = columns.egnn.field_and_divergence(W, cfg, x, t, features, probes)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("precision", ["fp8", "bf16_fp8_tangent"])
def test_fp8_precisions_take_egnn_whole(precision):
    # One fp8 scale per tensor over all columns and rows, as in `egnn.py`;
    # the fp8 rounding moves the trace far more than the float32 sum order.
    cfg, columns, W, x, t, features = _setup(seed=7)
    out = columns.field_and_divergence(W, cfg, x, t, features, precision=precision, columns=4)
    ref = columns.egnn.field_and_divergence(W, cfg, x, t, features, precision=precision)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    exact = columns.field_and_divergence(W, cfg, x, t, features, precision="bf16")[1]
    assert 1e-4 < (out[1] - exact).abs().max() / exact.abs().max() < 0.1
