"""The port's FLOP counter (`ecnf_tpu_torch/ops/flops.py`) against the JAX
package's `count_fn_flops`, on the CPU.

- Unit cases mirror `tests/test_flops.py`: the product formula, the bf16
  bucket, mixed dtypes counted as f32, a fixed loop multiplying its body, an
  adaptive solve flagged ``has_while``, and `mfu` against the H100's peaks.
  The ``torch.func`` routes are counted as they run (their forward-mode
  products reach the counting mode, batched under vmap), which is more
  than JAX's ``jax.linearize`` route.
- Parity: the same functions at the same small shapes counted by both
  packages, bucket by bucket, with no tolerance.  One term differs between
  the packages and is named with its formula: the edge chain's phi_x output
  product ``p @ x_out`` (2 K B N^2 U FLOP per block and field evaluation),
  which JAX takes on compute-dtype operands with f32 accumulation and the
  port on operands cast to f32, so under bf16 JAX counts it bf16 and the
  port f32.  No ``cond`` is on any of these JAX paths (each case checks),
  so no place runs one branch where JAX counts the larger.
- Kernel formulas: each CUDA kernel's count (`edge_tangent_flops`,
  `egcl_flops`, `fused_trace_flops`, which its wrapper adds where it
  launches) equals the dispatch count of its plain version, the full-size
  shapes on ``meta`` tensors, where no arithmetic runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax._src import core as jax_core

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.cnf.build import build_cnf as build_jax_cnf
from ecnf_tpu.ops.flops import count_fn_flops as jax_count
from ecnf_tpu.ops.pallas.tangent_kernel import egnn_value_and_trace as jax_trace
from ecnf_tpu.training.optim import build_optimizer as jax_build_optimizer
from ecnf_tpu.training.state import TrainingState as JaxState
from ecnf_tpu.training.state import make_update_fn as jax_make_update_fn
from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf
from ecnf_tpu_torch.ops import egcl, flops, fused_trace, ode
from ecnf_tpu_torch.ops.divergence import value_and_exact_divergence
from ecnf_tpu_torch.ops.edge_tangent import edge_tangent_flops, edge_tangent_reference
from ecnf_tpu_torch.ops.flops import FlopCount, count_fn_flops, mfu
from ecnf_tpu_torch.ops.tangent import block_weights, egnn_value_and_trace
from ecnf_tpu_torch.training import optim
from ecnf_tpu_torch.training.state import init_training_state, make_update_fn

H100 = "NVIDIA H100 80GB HBM3"
BLOCKS, UNITS = 2, (32, 32)
STEP = 0.25  # 4 fixed steps


# ---------------------------------------------------------------------------
# Unit cases
# ---------------------------------------------------------------------------


def test_plain_matmul_f32():
    c = count_fn_flops(lambda a, b: a @ b, torch.zeros(8, 16), torch.zeros(16, 32))
    assert c.f32 == 2 * 8 * 16 * 32
    assert c.bf16 == 0
    assert not c.has_while


def test_bf16_bucket():
    a = torch.zeros(8, 16, dtype=torch.bfloat16)
    c = count_fn_flops(lambda a, b: a @ b, a, torch.zeros(16, 32, dtype=torch.bfloat16))
    assert c.bf16 == 2 * 8 * 16 * 32
    assert c.f32 == 0


def test_mixed_dtypes_count_as_f32():
    # Eager torch refuses a product of mixed dtypes, so the rule the mode
    # applies is checked on its own: a bf16 operand with an f32 one is f32.
    a = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    b = torch.empty(8, 4, dtype=torch.float32, device="meta")
    out = torch.empty(4, 4, device="meta")
    assert flops._RULES[torch.ops.aten.mm](out, a, b) == FlopCount(f32=2 * 4 * 8 * 4)
    assert flops.bucket(10.0, torch.bfloat16, torch.float32) == FlopCount(f32=10.0)
    assert flops.bucket(10.0, torch.bfloat16, torch.bfloat16) == FlopCount(bf16=10.0)


def test_batched_einsum():
    c = count_fn_flops(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       torch.zeros(5, 8, 16), torch.zeros(5, 16, 32))
    assert c.total == 2 * 5 * 8 * 16 * 32


@pytest.mark.parametrize("args", [((6, 4, 5, 7), (7,)), ((3, 7), (7, 2)), ((7,), (7,)),
                                  ((2, 3, 7), (2, 7, 5)), ((7,), (7, 3))],
                         ids=["mv", "mm", "dot", "bmm", "vecmat"])
def test_matmul_decompositions(args):
    # Whatever matmul decomposes into: 2 * output elements * contraction.
    a, b = torch.zeros(args[0]), torch.zeros(args[1])
    out = a @ b
    assert count_fn_flops(torch.matmul, a, b).f32 == 2 * max(out.numel(), 1) * a.shape[-1]


def test_linear_addmm_and_backward():
    x = torch.randn(6, 5)
    layer = torch.nn.Linear(5, 3)
    # Forward addmm; backward: the weight's product only (x needs no grad).
    c = count_fn_flops(lambda: layer(x).sum().backward())
    assert c.f32 == 2 * (2 * 6 * 5 * 3)
    x.requires_grad_(True)
    c = count_fn_flops(lambda: layer(x).sum().backward())
    assert c.f32 == 3 * (2 * 6 * 5 * 3)


def test_convolution_and_its_backward():
    x = torch.randn(2, 4, 9, 9)
    w = torch.randn(6, 2, 3, 3, requires_grad=True)  # groups=2
    out_elements = 2 * 6 * 7 * 7
    forward = 2 * out_elements * 2 * 9
    assert count_fn_flops(F.conv2d, x, w, groups=2).f32 == forward
    # The backward computes the weight's gradient only.
    c = count_fn_flops(lambda: F.conv2d(x, w, groups=2).sum().backward())
    assert c.f32 == 2 * forward


def test_host_loop_multiplies_its_body():
    w = torch.zeros(16, 16)

    def f(x):
        for _ in range(7):
            x = x @ w
        return x

    assert count_fn_flops(f, torch.zeros(4, 16)).total == 7 * 2 * 4 * 16 * 16


@pytest.mark.parametrize("method,evals", [("rk4", 4 * 4), ("dopri5", 1 + 6 * 4)])
def test_fixed_step_solve_is_steps_times_a_stage(method, evals):
    w = torch.randn(16, 16) * 0.1
    c = count_fn_flops(ode.odeint_fixed, lambda t, y: y @ w, torch.randn(4, 16), 0.0, 1.0,
                       step_size=STEP, method=method)
    assert c == FlopCount(f32=evals * 2 * 4 * 16 * 16)
    assert mfu(c, 1.0, H100) is not None


def test_adaptive_solve_is_flagged_and_counts_every_trip():
    w = torch.randn(16, 16) * 0.3
    stats = []

    def solve(y0):
        y, st = ode.odeint_adaptive(lambda t, y: y @ w, y0, 0.0, 1.0)
        stats.append(st)

    c = count_fn_flops(solve, torch.randn(4, 16))
    assert c.has_while
    assert stats[0].num_attempts > 1
    assert c.total == (2 + 6 * stats[0].num_attempts) * 2 * 4 * 16 * 16
    assert mfu(c, 1.0, H100) is None


def test_flags_and_kernel_counts_reach_every_running_count():
    assert not flops.counting()
    flops.add(FlopCount(bf16=5.0))  # no count running: nothing happens
    flops.note_while()

    def inner():
        assert flops.counting()
        flops.add(FlopCount(bf16=5.0))
        return count_fn_flops(lambda: flops.add(FlopCount(f32=3.0)))

    seen = []
    outer = count_fn_flops(lambda: seen.append(inner()))
    assert seen == [FlopCount(f32=3.0)]
    assert outer == FlopCount(bf16=5.0, f32=3.0)
    assert not flops.counting()


def test_count_arithmetic():
    a = FlopCount(bf16=2.0, f32=3.0)
    b = FlopCount(f32=1.0, has_while=True)
    assert (a + b) == FlopCount(2.0, 4.0, True)
    assert a.scaled(3).total == 15.0
    assert b.scaled(2).has_while


class TestMfu:
    def test_unknown_device_none(self):
        assert mfu(FlopCount(f32=1e12), 1.0, "cpu") is None
        assert mfu(FlopCount(bf16=1e12), 1.0, "NVIDIA A100-SXM4-80GB") is None

    def test_while_none(self):
        assert mfu(FlopCount(bf16=1e12, has_while=True), 1.0, H100) is None

    def test_h100_value(self):
        # 989e12 bf16 FLOPs in 2 s on one H100 -> 50% MFU; two cards -> 25%.
        assert mfu(FlopCount(bf16=989e12), 2.0, H100) == pytest.approx(0.5)
        assert mfu(FlopCount(bf16=989e12), 2.0, H100, n_devices=2) == pytest.approx(0.25)

    def test_mixed_roofline(self):
        # Under "highest" an f32 FLOP is worth three TF32 ones.
        before = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision("highest")
            got = mfu(FlopCount(bf16=989e12 / 2, f32=495e12 / 3 / 2), 1.0, H100)
        finally:
            torch.set_float32_matmul_precision(before)
        assert got == pytest.approx(0.5 + 0.5)

    @pytest.mark.parametrize("precision,peak", [("highest", 495e12 / 3), ("high", 495e12),
                                                ("medium", 495e12)])
    def test_f32_peak_follows_the_matmul_precision(self, precision, peak):
        before = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision(precision)
            assert flops.f32_peak(flops.PEAKS[H100]) == peak
            assert mfu(FlopCount(f32=peak), 1.0, H100) == pytest.approx(1.0)
        finally:
            torch.set_float32_matmul_precision(before)


def test_forward_mode_ad_is_counted_as_it_runs():
    # The jvp of x @ k with a constant k runs three products: the primal,
    # x_t @ k, and x @ 0 for k's zero tangent, which torch materialises and
    # multiplies densely (JAX's symbolic zeros skip it).  Under vmap over K
    # directions the primal and the zero product run once, the tangent
    # batched.
    x, k = torch.randn(7, 5), torch.randn(5, 4)
    one = 2 * 7 * 5 * 4
    assert count_fn_flops(torch.func.jvp, lambda a: a @ k, (x,), (x,)) == FlopCount(f32=3 * one)
    K = 6
    tangents = torch.func.vmap(lambda e: torch.func.jvp(lambda a: a @ k, (x,), (e,))[1])
    assert count_fn_flops(tangents, torch.randn(K, 7, 5)) == FlopCount(f32=(2 + K) * one)


@pytest.mark.parametrize("chunk,calls", [(None, 1), (2, 3)])
def test_torch_func_exact_trace_is_counted_as_it_runs(chunk, calls):
    # A linear field x @ W over K basis rows: the value, then per vmapped
    # call (a chunk of columns) the jvp's primal and W's zero-tangent
    # product, and one tangent product per column.
    B, D, K = 4, 6, 5
    W = torch.randn(D, D)
    c = count_fn_flops(value_and_exact_divergence, lambda x: x @ W, torch.randn(B, D),
                       column_chunk=chunk, basis=torch.randn(K, D))
    assert c == FlopCount(f32=(1 + 2 * calls + K) * 2 * B * D * D)


def test_torch_func_routes_count_more_than_jax():
    # The CNF's torch.func routes run under a count; they do more than
    # JAX's jax.linearize route (a primal of their own and the weights'
    # zero-tangent products), so their count is larger.
    jax_cnf, params, cnf = tp.make_pair(BLOCKS, UNITS, seed=4)
    _, _, feats = tp.inputs(seed=4)
    for approx in (False, True):
        kw = dict(use_fixed_step_size=True, step_size=STEP, method="rk4", structured_tangent=False)
        ref = _jax_count(
            lambda key: jax_sampling.sample_and_log_prob_cnf(
                jax_cnf, params, key, tp.B, features=jnp.asarray(feats), approx=approx,
                cfg=jax_sampling.SolveConfig(**kw)),
            jax.random.PRNGKey(0),
        )
        port = count_fn_flops(sample_and_log_prob_cnf, cnf, tp.B, torch.from_numpy(feats),
                              approx=approx, cfg=SolveConfig(**kw),
                              generator=torch.Generator().manual_seed(0))
        assert port.f32 > ref.f32 > 0 and port.bf16 == ref.bf16 == 0


# ---------------------------------------------------------------------------
# Parity with the JAX package's count
# ---------------------------------------------------------------------------


def _conds(jaxpr, where="") -> list:
    """Every ``cond`` of a jaxpr, nested ones included, by its path of primitives."""
    j = jaxpr.jaxpr if isinstance(jaxpr, jax_core.ClosedJaxpr) else jaxpr
    found = []
    for eqn in j.eqns:
        here = f"{where}/{eqn.primitive.name}"
        if eqn.primitive.name == "cond":
            found.append(here)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, (jax_core.ClosedJaxpr, jax_core.Jaxpr)):
                    found += _conds(sub, here)
    return found


def _jax_count(fn, *args):
    """JAX's count of ``fn`` and the ``cond``s on its path (none expected)."""
    assert _conds(jax.make_jaxpr(fn)(*args)) == []
    return jax_count(fn, *args)


def phi_out_term(evals, K, B, N=tp.N, U=UNITS[0], blocks=BLOCKS) -> float:
    """FLOPs of the edge chain's ``p @ x_out`` over a solve: 2 K B N^2 U per
    block and field evaluation (bf16 in JAX's count, f32 in the port's
    when the compute dtype is bf16)."""
    return evals * blocks * 2.0 * K * B * N * N * U


def assert_counts_match(port, ref, moved=0.0):
    """Bucket by bucket, with ``moved`` FLOPs in JAX's bf16 bucket that the
    port counts f32 (`phi_out_term`)."""
    assert ref.total > 0
    assert port.has_while == ref.has_while
    assert port.bf16 == ref.bf16 - moved
    assert port.f32 == ref.f32 + moved


@pytest.mark.parametrize(
    "cdt,method,approx,evals",
    [
        (None, "rk4", False, 16),
        ("bfloat16", "rk4", False, 16),
        (None, "dopri5", False, 1 + 6 * 4),
        (None, "rk4", True, 16),
        ("bfloat16", "rk4", True, 16),
    ],
    ids=["rk4_exact_f32", "rk4_exact_bf16", "dopri5_exact_f32", "rk4_hutch4_f32", "rk4_hutch4_bf16"],
)
def test_solve_counts_match_jax(cdt, method, approx, evals):
    jax_cnf, params, cnf = tp.make_pair(BLOCKS, UNITS, cdt, seed=5)
    _, _, feats = tp.inputs(seed=5)
    probes = 4 if approx else 1
    jax_cfg = jax_sampling.SolveConfig(use_fixed_step_size=True, step_size=STEP, method=method,
                                       hutchinson_probes=probes)
    ref = _jax_count(
        lambda key: jax_sampling.sample_and_log_prob_cnf(
            jax_cnf, params, key, tp.B, features=jnp.asarray(feats), approx=approx, cfg=jax_cfg
        ),
        jax.random.PRNGKey(0),
    )
    cfg = SolveConfig(use_fixed_step_size=True, step_size=STEP, method=method,
                      hutchinson_probes=probes)
    port = count_fn_flops(sample_and_log_prob_cnf, cnf, tp.B, torch.from_numpy(feats),
                          approx=approx, cfg=cfg, generator=torch.Generator().manual_seed(0))
    K = probes if approx else (tp.N - 1) * tp.DIM
    assert_counts_match(port, ref, phi_out_term(evals, K, tp.B) if cdt else 0.0)


@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16"])
def test_exact_field_evaluation_matches_jax(cdt):
    jax_cnf, params, cnf = tp.make_pair(3, UNITS, cdt, seed=6)
    x, t, feats = tp.inputs(seed=6)
    basis, offset = jax_cnf.exact_trace_plan(params)
    ref = _jax_count(
        lambda x_: jax_trace(params, x_, t, feats, basis, n_nodes=tp.N, dim=tp.DIM, n_blocks=3,
                             mlp_units=UNITS, time_embedding_dim=tp.T, compute_dtype=cdt,
                             trace_offset=offset, use_kernel=False),
        jnp.asarray(x),
    )
    basis_t, offset_t = cnf.exact_trace_plan()
    port = count_fn_flops(egnn_value_and_trace, cnf.field, *tp.to_torch(x, t, feats), basis_t,
                          trace_offset=offset_t)
    moved = phi_out_term(1, basis_t.shape[0], tp.B, blocks=3) if cdt else 0.0
    assert_counts_match(port, ref, moved)


@pytest.mark.parametrize("microbatch,cdt", [(1, "bfloat16"), (4, "bfloat16"), (4, None)],
                         ids=["mb1_bf16", "mb4_bf16", "mb4_f32"])
def test_train_step_count_matches_jax(microbatch, cdt):
    # The flow-matching update with EMA, Adam; JAX's traced abstractly,
    # the port's run once.  The QM9 flagship step is counted the same way
    # on the card (`chip_smoke.py` phase 10).
    n, B, D = 5, 8, 15
    kw = dict(n_frames=n, dim=3, sigma_min=1e-6, base_scale=2.0, n_blocks_egnn=2,
              mlp_units=(32, 32), n_invariant_feat_hidden=16, time_embedding_dim=8,
              n_features=1, compute_dtype=cdt)
    jax_cnf = build_jax_cnf(**kw)
    opt = jax_build_optimizer(1e-4)
    params = jax.eval_shape(
        jax_cnf.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((2, D), jnp.float32),
        jax.ShapeDtypeStruct((2,), jnp.float32), jax.ShapeDtypeStruct((2, n), jnp.int32),
    )
    state = JaxState(params, jax.eval_shape(opt.init, params), jax.random.PRNGKey(0), params)
    ref = _jax_count(
        jax_make_update_fn(jax_cnf, opt, use_ema=True, microbatch=microbatch), state,
        jax.ShapeDtypeStruct((B, D), jnp.float32), jax.ShapeDtypeStruct((B, n), jnp.int32),
    )
    cnf = build_cnf(**kw, device="cpu")
    port_opt = optim.build_optimizer(1e-4)
    st = init_training_state(cnf, port_opt, torch.Generator().manual_seed(0), use_ema=True)
    update = make_update_fn(cnf, port_opt, use_ema=True, microbatch=microbatch)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(B, D)).astype(np.float32))
    port = count_fn_flops(update, st, x, torch.zeros((B, n), dtype=torch.int64))
    assert_counts_match(port, ref)
    assert (port.bf16 > 0) == (cdt is not None)


# ---------------------------------------------------------------------------
# Each kernel's count against its plain version's
# ---------------------------------------------------------------------------


def _edge_args(K, B, N, U, L, dtype, device):
    gen = torch.Generator().manual_seed(K + N + U)

    def t(*shape, dt=dtype):
        if device == "meta":
            return torch.empty(shape, dtype=dt, device="meta")
        return torch.randn(shape, generator=gen).to(dt)

    return (t(K, B, N, U), t(K, B, N, U), t(K, B, N, N, dt=torch.float32),
            [t(B, N, N, U) for _ in range(L)], [t(B, N, N, U) for _ in range(L)],
            t(B, N, N, U), t(B, N, N), t(B, N, N), t(U),
            [t(U, U) for _ in range(L - 1)], [t(U, U) for _ in range(L)], t(U), t(U))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "K,B,N,U,L,device",
    [
        (1, 256, 19, 256, 4, "meta"),  # the QM9 Hutchinson shape
        (36, 48, 13, 128, 3, "meta"),  # the LJ13 serving shape
        (63, 16, 22, 64, 2, "cpu"),  # serving the ALDP checkpoint
        (6, 4, 4, 16, 3, "cpu"),  # --local DW4, launched zero-padded to 32
        (3, 2, 5, 4, 2, "cpu"),  # --local ALDP, launched zero-padded to 32
    ],
    ids=["qm9_k1", "lj13", "aldp_k63", "pad16", "pad4"],
)
def test_edge_tangent_flops_equal_the_plain_count(K, B, N, U, L, device, dtype):
    counted = count_fn_flops(edge_tangent_reference, *_edge_args(K, B, N, U, L, dtype, device))
    assert counted == edge_tangent_flops(K, B, N, U, L, dtype)
    assert (counted.bf16 > 0) == (dtype == torch.bfloat16)


def _field(n, units, hidden, blocks, device):
    return build_cnf(n_frames=n, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
                     mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
                     n_features=1, device=device).field


FIELD_SHAPES = [
    (5, (32, 32), 16, 2, 3, "cpu"),
    (4, (16,) * 3, 8, 3, 4, "cpu"),  # DW4 --local's width
    (13, (128,) * 3, 64, 3, 48, "meta"),  # LJ13 serving
    (19, (256,) * 4, 32, 5, 64, "meta"),  # QM9 flagship
]
FIELD_IDS = ["small", "dw4_local", "lj13", "qm9"]


@pytest.mark.parametrize("n,units,hidden,blocks,B,device", FIELD_SHAPES, ids=FIELD_IDS)
def test_egcl_flops_equal_the_plain_count(n, units, hidden, blocks, B, device):
    field = _field(n, units, hidden, blocks, device)
    vec, h, temb = (torch.randn(shape).to(device) for shape in ((B, n, 3), (B, n, hidden), (B, 8)))
    wt = block_weights(field.egnn, 0, torch.float32)
    counted = count_fn_flops(egcl.egcl_reference, vec, h, temb, wt)
    assert counted == egcl.egcl_flops(B, n, 3, hidden, 8, units[0], len(units))


@pytest.mark.parametrize("n,units,hidden,blocks,B,device", FIELD_SHAPES, ids=FIELD_IDS)
def test_fused_trace_flops_equal_the_plain_count(n, units, hidden, blocks, B, device):
    field = _field(n, units, hidden, blocks, device)
    x = torch.randn(B, n * 3).to(device)
    t = torch.rand(B).to(device)
    feats = torch.zeros((B, n), dtype=torch.int64, device=device)
    counted = count_fn_flops(fused_trace.egnn_value_and_div_reference, field, x, t, feats)
    assert counted == fused_trace.fused_trace_flops(B, n, 3, hidden, 8, units[0], len(units), blocks)
    # The whole forward through `flat_egnn_apply_fused`'s plain blocks too.
    w = egcl.egnn_weights(field.egnn)
    counted = count_fn_flops(egcl.flat_egnn_apply_fused, field, x, t, feats, w, use_kernel=False)
    assert counted == egcl.egcl_flops(B, n, 3, hidden, 8, units[0], len(units)).scaled(blocks)
