"""The chunked exact trace and Hutch++ (`ops/divergence.py`, ``SolveConfig(
trace_column_chunk=..., hutchpp_sketch=...)``) against the JAX package, on
the CPU.

The field is the EGNN of `torch_parity.make_pair` (2 blocks of [16, 16],
hidden 8, N=5: D=15, K=12 zero-CoM columns) at fixed t.  Bands: the
divergence and log p rel 1e-4 of the largest entry (f32; only the order of
the f32 sums differs); Hutch++ on injected sketch and probes the same,
since its terms do not depend on the QR's choice of basis.  The
statistical cases are `tests/test_ode.py`'s, restated with the port's own
draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.ops import divergence as jax_div
from ecnf_tpu_torch.cnf.build import build_mlp_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, _draw_probes, get_log_prob
from ecnf_tpu_torch.ops import divergence as div

N, HIDDEN, UNITS = 5, 8, (16, 16)
D, K = N * 3, (N - 1) * 3
REL = 1e-4


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    return tp.make_pair(2, UNITS, n=N, seed=2, hidden=HIDDEN, slow=True)


def _fields(pair, t=0.4):
    jax_cnf, jax_params, cnf = pair
    x, _, feats = tp.inputs(N, 3, batch=6, seed=3)
    tb = np.full((6,), t, np.float32)

    def f_jax(xb):
        return jax_cnf.apply(jax_params, xb, jnp.asarray(tb), jnp.asarray(feats))

    def f_port(xb):
        return cnf.apply(xb, torch.from_numpy(tb), torch.from_numpy(feats))

    return f_jax, f_port, x


@pytest.mark.parametrize("chunk", [1, 2, 5, K - 1, K, K + 3, None])
def test_chunked_exact_divergence_matches_jax(pair, chunk):
    f_jax, f_port, x = _fields(pair)
    basis, offset = pair[2].exact_trace_plan()
    ref_v, ref_d = jax_div.value_and_exact_divergence(
        f_jax, jnp.asarray(x), column_chunk=chunk, basis=jnp.asarray(basis.numpy()),
        trace_offset=jnp.asarray(offset.numpy()),
    )
    with torch.no_grad():
        v, d = div.value_and_exact_divergence(f_port, torch.from_numpy(x), chunk, basis, offset)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-6)
    _close(d, ref_d)
    # The identity basis (full trace) through exact_divergence, chunked.
    with torch.no_grad():
        full = div.exact_divergence(f_port, torch.from_numpy(x), chunk)
    _close(full, jax_div.exact_divergence(f_jax, jnp.asarray(x), chunk))


def test_chunk_below_one_is_refused(pair):
    _, f_port, x = _fields(pair)
    with pytest.raises(ValueError, match="column_chunk"):
        div.value_and_exact_divergence(f_port, torch.from_numpy(x), 0)


@pytest.mark.parametrize("m2", [0, 3])
def test_hutchpp_matches_jax_on_injected_draws(pair, m2):
    f_jax, f_port, x = _fields(pair)
    rng = np.random.default_rng(5)
    sketch = rng.normal(size=(2, 6, D)).astype(np.float32)
    probes = rng.normal(size=(m2, 6, D)).astype(np.float32)
    ref_v, ref_d = jax_div.value_and_hutchpp_divergence(
        f_jax, jnp.asarray(x), jnp.asarray(sketch), jnp.asarray(probes))
    with torch.no_grad():
        v, d = div.value_and_hutchpp_divergence(f_port, *tp.to_torch(x, sketch, probes))
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-6)
    _close(d, ref_d)
    with torch.no_grad():
        hutch = div.hutchinson_divergence(f_port, *tp.to_torch(x, sketch[0]))
    _close(hutch, jax_div.hutchinson_divergence(f_jax, jnp.asarray(x), jnp.asarray(sketch[0])))


def test_hutchpp_exact_for_low_rank_jacobian():
    # The sketch covers the Jacobian's range: (I-P) J (I-P) = 0 and the
    # estimate is tr(J) for any probes, and with none.
    gen = torch.Generator().manual_seed(0)
    Dl, r = 12, 3
    W = torch.randn((Dl, r), generator=gen) @ torch.randn((r, Dl), generator=gen)
    x = torch.randn((4, Dl), generator=gen)
    exact = torch.full((4,), float(torch.trace(W)))
    for _ in range(3):
        sketch = torch.randn((4, 4, Dl), generator=gen)  # m1 = 4 >= rank
        probes = torch.randn((2, 4, Dl), generator=gen)
        _, d = div.value_and_hutchpp_divergence(lambda xb: xb @ W.T, x, sketch, probes)
        np.testing.assert_allclose(d.numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)
        _, d0 = div.value_and_hutchpp_divergence(lambda xb: xb @ W.T, x, sketch,
                                                 torch.zeros((0, 4, Dl)))
        np.testing.assert_allclose(d0.numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)


def test_hutchpp_unbiased_and_lower_variance():
    # A fast-decaying spectrum: at a matched budget of 12 JVPs Hutch++
    # (2*4 + 4) beats plain Hutchinson (12 probes) on RMSE.
    gen = torch.Generator().manual_seed(0)
    Dl = 16
    q, _ = torch.linalg.qr(torch.randn((Dl, Dl), generator=gen))
    W = (q * 2.0 ** -torch.arange(Dl, dtype=torch.float32)) @ q.T
    exact = float(torch.trace(W))
    x = torch.zeros((1, Dl))
    f = lambda xb: xb @ W.T  # noqa: E731
    e_pp, e_pl = [], []
    for _ in range(400):
        sketch, probes = torch.randn((4, 1, Dl), generator=gen), torch.randn((4, 1, Dl), generator=gen)
        e_pp.append(float(div.value_and_hutchpp_divergence(f, x, sketch, probes)[1][0]))
        e_pl.append(float(div.value_and_multi_probe_hutchinson(
            f, x, torch.randn((12, 1, Dl), generator=gen))[1][0]))
    e_pp, e_pl = np.array(e_pp), np.array(e_pl)
    np.testing.assert_allclose(e_pp.mean(), exact, rtol=0.05)
    rmse_pp = np.sqrt(np.mean((e_pp - exact) ** 2))
    rmse_pl = np.sqrt(np.mean((e_pl - exact) ** 2))
    assert rmse_pp < 0.5 * rmse_pl, (rmse_pp, rmse_pl)


def _jax_log_prob(pair, x, feats, approx, eps, cfg):
    """JAX's `get_log_prob` with the probes injected (its own draws come
    from a key): the augmented field and the solve of `get_log_prob`."""
    jax_cnf, jax_params, _ = pair
    x = jnp.asarray(x)
    func = jax_sampling._augmented_field(jax_cnf, jax_params, jnp.asarray(feats), approx, eps, cfg)
    y1, _ = jax_sampling._solve(func, jnp.concatenate([x, jnp.zeros((x.shape[0], 1))], -1), 1.0, 0.0,
                                cfg)
    return np.asarray(jax_cnf.log_prob_base(y1[:, :-1]) + y1[:, -1])


FIXED = dict(use_fixed_step_size=True, method="rk4", step_size=0.25)


@pytest.mark.parametrize("case", ["chunk2", "hutchpp", "hutchpp_chunk"])
def test_log_prob_options_match_jax(pair, case):
    x, _, feats = tp.inputs(N, 3, batch=4, seed=8)
    kw = {"chunk2": dict(trace_column_chunk=2),
          "hutchpp": dict(hutchpp_sketch=2, hutchinson_probes=2),
          "hutchpp_chunk": dict(hutchpp_sketch=2, hutchinson_probes=2, trace_column_chunk=3)}[case]
    approx = case != "chunk2"
    eps = None
    if approx:
        rng = np.random.default_rng(9)
        eps = tuple(rng.normal(size=(2, 4, D)).astype(np.float32) for _ in range(2))
    ref = _jax_log_prob(pair, x, feats, approx, None if eps is None else tuple(map(jnp.asarray, eps)),
                        jax_sampling.SolveConfig(**FIXED, **kw))
    out = get_log_prob(pair[2], *tp.to_torch(x, feats), approx=approx, cfg=SolveConfig(**FIXED, **kw),
                       eps=None if eps is None else tp.to_torch(*eps))[0]
    _close(out, ref)


def test_draw_probes_order_and_shapes():
    cfg = SolveConfig(hutchpp_sketch=3, hutchinson_probes=2)
    sketch, probes = _draw_probes(torch.Generator().manual_seed(4), 5, D, cfg, "cpu")
    assert sketch.shape == (3, 5, D) and probes.shape == (2, 5, D)
    gen = torch.Generator().manual_seed(4)
    first = torch.randn((3, 5, D), generator=gen)
    assert torch.equal(sketch, first) and torch.equal(probes, torch.randn((2, 5, D), generator=gen))
    zero = _draw_probes(None, 5, D, SolveConfig(hutchpp_sketch=2, hutchinson_probes=0), "cpu")[1]
    assert zero.shape == (0, 5, D)


def test_hutchpp_log_prob_is_unbiased_across_draws():
    # `tests/test_ode.py`'s end-to-end case: the MLP CNF, 24 draws of
    # (sketch, probes) from the generator against the exact log p.
    cnf = build_mlp_cnf(dim=4, sigma_min=0.01, base_scale=1.0, features=(16,), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    x = torch.randn((6, 4), generator=torch.Generator().manual_seed(0)) * 0.5
    fixed = dict(use_fixed_step_size=True, step_size=0.2)
    exact = get_log_prob(cnf, x, cfg=SolveConfig(**fixed))[0]
    cfg = SolveConfig(hutchpp_sketch=2, hutchinson_probes=2, **fixed)
    lps = torch.stack([
        get_log_prob(cnf, x, approx=True, cfg=cfg, generator=torch.Generator().manual_seed(k))[0]
        for k in range(24)
    ])
    assert torch.isfinite(lps).all()
    np.testing.assert_allclose(lps.mean(0).numpy(), exact.numpy(), rtol=0.05, atol=0.05)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("approx,kw,structured", [
    (False, {}, True),
    (True, {}, True),
    (False, dict(trace_column_chunk=2), False),
    (True, dict(trace_column_chunk=2), False),
    (True, dict(hutchpp_sketch=2, hutchinson_probes=2), False),
], ids=["exact", "hutchinson", "chunk_exact", "chunk_hutchinson", "hutchpp"])
def test_routing_leaves_the_structured_tangent(pair, approx, kw, structured):
    cnf = pair[2]
    spy = _Spy(cnf.tangent_value_and_div)
    x, _, feats = tp.inputs(N, 3, batch=2, seed=1)
    get_log_prob(cnf._replace(tangent_value_and_div=spy), *tp.to_torch(x, feats), approx=approx,
                 cfg=SolveConfig(use_fixed_step_size=True, method="rk4", step_size=0.5, **kw),
                 generator=torch.Generator().manual_seed(0))
    assert (spy.calls > 0) == structured, spy.calls
