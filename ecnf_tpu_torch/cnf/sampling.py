"""CNF sampling and exact / Hutchinson log-density (port of `ecnf_tpu/cnf/sampling.py`).

One batched ODE solve per call, adaptive Dopri5 by default or fixed-step
rk4 / Dopri5; the divergence rides in the state as an extra column
(``[B, D+1]``), so the adaptive error norm covers it too.  Noise comes
from an explicit ``torch.Generator`` or is injected (``x0``, ``eps``), so
that a run can be compared with the JAX package on the same inputs.

With a data ``mesh`` (`ecnf_tpu_torch.parallel`) the batch is the global
one on every rank: the noise is drawn for all of it as a single process
draws it, each rank solves its rows, and the results are gathered, so
every rank returns what the single process would.

Each public entry is an ``ecnf.solve`` span while a torch profiler runs
(`ecnf_tpu_torch.utils.spans`): the draws, the weights' packing, the
solve with its ``ecnf.field`` spans, the base density and the gather.
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ecnf_tpu_torch.cnf.core import FlowMatchingCNF
from ecnf_tpu_torch.ops.divergence import (
    sharded_value_and_exact_divergence,
    value_and_exact_divergence,
    value_and_hutchinson_divergence,
    value_and_hutchpp_divergence,
    value_and_multi_probe_hutchinson,
)
from ecnf_tpu_torch.ops.ode import ODEStats, odeint
from ecnf_tpu_torch.parallel.mesh import gather_rows, rows, shard_batch
from ecnf_tpu_torch.utils.spans import span

Tensor = torch.Tensor


@dataclass(frozen=True)
class SolveConfig:
    """ODE-solve settings.

    The default is the JAX package's: adaptive Dopri5 at rtol = atol =
    dtmin = 1e-5 with at most ``max_steps`` attempts.  With
    ``use_fixed_step_size=True`` the solve takes equal steps of
    ``step_size`` with ``method`` ``"dopri5"`` or ``"rk4"``; adaptive solves
    ignore ``method``.  ``structured_tangent`` selects
    the hand-linearised trace (`ops/tangent.py`) over ``torch.func.jvp``;
    ``structured_tangent_kernel`` runs its edge chains through the CUDA
    kernel when the tensors are on a card (False forces the plain version).
    ``fused_trace`` takes the exact trace from the CNF's fused forward +
    full-divergence kernel (`ops/fused_trace.py`) before any other route;
    Hutchinson solves ignore it.  ``trace_column_chunk`` takes the exact
    trace's columns that many at a time through ``torch.func``, and
    ``hutchpp_sketch > 0`` makes the approximate trace Hutch++ with that
    many sketch directions and ``hutchinson_probes`` residual probes
    (`ops/divergence.py`); either leaves the structured tangent, as in JAX.
    The JAX ``fused_batch_tile`` and ``fused_interpret`` are TPU settings
    and are not ported.
    """

    use_fixed_step_size: bool = False
    rtol: float = 1e-5
    atol: float = 1e-5
    dtmin: float = 1e-5
    step_size: float = 0.05
    max_steps: int = 4096
    method: str = "dopri5"
    trace_column_chunk: Optional[int] = None
    hutchinson_probes: int = 1
    hutchpp_sketch: int = 0
    use_exact_trace_plan: bool = True
    structured_tangent: bool = True
    structured_tangent_kernel: bool = True
    fused_trace: bool = False


def _solve(func, y0: Tensor, t0: float, t1: float, cfg: SolveConfig) -> Tuple[Tensor, ODEStats]:
    return odeint(
        func, y0, t0, t1,
        use_fixed_step_size=cfg.use_fixed_step_size,
        rtol=cfg.rtol,
        atol=cfg.atol,
        dtmin=cfg.dtmin,
        step_size=cfg.step_size,
        max_steps=cfg.max_steps,
        method=cfg.method,
    )


def _draw_probes(generator, B: int, D: int, cfg: SolveConfig, device):
    """One fixed Gaussian probe per sample ``[B, D]``, ``[K, B, D]`` probes
    when ``cfg.hutchinson_probes > 1``, or for Hutch++ the pair ``(sketch
    [hutchpp_sketch, B, D], probes [hutchinson_probes, B, D])``, drawn in
    that order."""
    gen_device = generator.device if generator is not None else device

    def draw(shape):
        return torch.randn(shape, generator=generator, device=gen_device).to(device)

    if cfg.hutchpp_sketch > 0:
        sketch = draw((cfg.hutchpp_sketch, B, D))
        return sketch, draw((cfg.hutchinson_probes, B, D))
    return draw((B, D) if cfg.hutchinson_probes == 1 else (cfg.hutchinson_probes, B, D))


def _shard_probes(eps, mesh):
    """This rank's rows (`parallel.mesh.rows`) of probes ``[B, D]`` or
    ``[K, B, D]``, or of Hutch++'s pair of them (the batch is their axis
    -2); None for None."""
    if eps is None:
        return None
    if isinstance(eps, tuple):
        return tuple(_shard_probes(e, mesh) for e in eps)
    return rows(eps.movedim(-2, 0), mesh).movedim(0, -2)


def _gather(mesh, stats: ODEStats, *per_sample: Tensor):
    """The ranks' per-sample results joined in rank order, and ``stats``
    with the most accepted steps of any rank; as they are without a mesh."""
    if mesh is None:
        return per_sample, stats
    steps = gather_rows(torch.tensor([stats.num_steps], device=per_sample[0].device), mesh)
    gathered = tuple(gather_rows(x, mesh) for x in per_sample)
    return gathered, stats._replace(num_steps=int(steps.max()))


def _augmented_field(
    cnf: FlowMatchingCNF, features, approx: bool, eps, cfg: SolveConfig, trace_mesh=None
):
    """Vector field on the ``[B, D+1]`` (x, log-det) augmented state.

    ``trace_mesh``: a mesh (`ecnf_tpu_torch.parallel`) over whose ``data``
    ranks the exact trace's columns are split, through ``torch.func``
    (`sharded_value_and_exact_divergence`), for small-batch scoring; it
    leaves the structured tangent and the column chunks, as in JAX.  The
    fused trace comes first and Hutchinson estimates ignore it.
    """
    if cfg.fused_trace and not approx:
        if cnf.fused_value_and_div is None:
            raise ValueError("fused_trace=True but this CNF has no fused kernel")
        weights = cnf.fused_weights()

        def func(t, y):
            v, div = cnf.fused_value_and_div(y[:, :-1], t, features, weights=weights)
            return torch.cat([v, div[:, None]], dim=-1)

        return func

    basis = offset = None
    if not approx and cfg.use_exact_trace_plan and cnf.exact_trace_plan is not None:
        basis, offset = cnf.exact_trace_plan()

    if (
        cfg.structured_tangent
        and cnf.tangent_value_and_div is not None
        and trace_mesh is None
        and cfg.trace_column_chunk is None
        and not (approx and cfg.hutchpp_sketch > 0)  # Hutch++ needs J v vectors
    ):
        weights = cnf.trace_weights() if cnf.trace_weights is not None else None

        def func(t, y):
            x = y[:, :-1]
            if approx:
                b = eps if eps.dim() == 3 else eps[None]  # [K, B, D]
            else:
                b = basis
                if b is None:
                    b = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
            v, div = cnf.tangent_value_and_div(
                x, t, features, b,
                trace_offset=None if approx else offset,
                use_kernel=cfg.structured_tangent_kernel, weights=weights,
            )
            if approx and eps.dim() == 3:
                div = div / eps.shape[0]  # mean over the K probes
            return torch.cat([v, div[:, None]], dim=-1)

        return func

    def func(t, y):
        x = y[:, :-1]

        def f_x(xb):
            return cnf.apply(xb, t, features)

        if approx and isinstance(eps, tuple):
            v, div = value_and_hutchpp_divergence(f_x, x, *eps)
        elif approx and eps.dim() == 3:
            v, div = value_and_multi_probe_hutchinson(f_x, x, eps)
        elif approx:
            v, div = value_and_hutchinson_divergence(f_x, x, eps)
        elif trace_mesh is not None:
            v, div = sharded_value_and_exact_divergence(
                f_x, x, trace_mesh, basis=basis, trace_offset=offset
            )
        else:
            v, div = value_and_exact_divergence(
                f_x, x, column_chunk=cfg.trace_column_chunk, basis=basis, trace_offset=offset
            )
        return torch.cat([v.detach(), div.detach()[:, None]], dim=-1)

    return func


@torch.no_grad()
def sample_cnf(
    cnf: FlowMatchingCNF,
    batch_size: int,
    features: Optional[Tensor] = None,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    mesh=None,
) -> Tensor:
    """Draw ``[batch_size, D]`` flow samples by integrating t: 0 -> 1
    (``mesh``: see the module's docstring)."""
    with span("ecnf.solve"):
        if x0 is None:
            x0 = cnf.sample_base((batch_size,), generator=generator)
        x0, features = shard_batch((x0, features), mesh)

        def func(t, y):
            return cnf.apply(y, t, features)

        x1, stats = _solve(func, x0, 0.0, 1.0, cfg)
        return _gather(mesh, stats, x1)[0][0]


@torch.no_grad()
def get_log_prob(
    cnf: FlowMatchingCNF,
    x: Tensor,
    features: Optional[Tensor] = None,
    approx: bool = False,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    eps: Optional[Tensor] = None,
    return_stats: bool = False,
    trace_mesh=None,
    mesh=None,
):
    """Log-density of ``[B, D]`` points by integrating t: 1 -> 0.

    Returns ``(log_p, log_prob_base, delta_log_lik)`` (plus `ODEStats`
    when ``return_stats``), with ``log_p = log_prob_base(x0) + delta``.
    ``eps`` injects the Hutchinson probes (``approx=True``): a tensor, or
    the ``(sketch, probes)`` pair of Hutch++.  ``trace_mesh`` splits the
    exact trace's columns over its ranks (`_augmented_field`); every rank
    of it solves the whole batch.  ``mesh`` splits the batch over its data
    ranks (see the module's docstring); the stats' ``num_steps`` is then
    the most of any rank.
    """
    with span("ecnf.solve"):
        B, D = x.shape
        if approx and eps is None:
            eps = _draw_probes(generator, B, D, cfg, x.device)
        x, features = shard_batch((x, features), mesh)
        func = _augmented_field(cnf, features, approx, _shard_probes(eps, mesh), cfg, trace_mesh)
        y0 = torch.cat([x, torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=-1)
        y1, stats = _solve(func, y0, 1.0, 0.0, cfg)
        x0, delta_log_lik = y1[:, :-1], y1[:, -1]
        (log_prob_base, delta_log_lik), stats = _gather(
            mesh, stats, cnf.log_prob_base(x0), delta_log_lik
        )
        log_p = log_prob_base + delta_log_lik
        if return_stats:
            return log_p, log_prob_base, delta_log_lik, stats
        return log_p, log_prob_base, delta_log_lik


@torch.no_grad()
def sample_and_log_prob_cnf(
    cnf: FlowMatchingCNF,
    batch_size: int,
    features: Optional[Tensor] = None,
    approx: bool = False,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    eps: Optional[Tensor] = None,
    return_stats: bool = False,
    trace_mesh=None,
    mesh=None,
):
    """Sample and score ``[batch_size, D]`` points in one forward solve.

    Returns ``(x1, log_q)`` (plus `ODEStats` when ``return_stats``) with
    ``log_q = log_prob_base(x0) - delta``.  ``x0`` (base samples) and
    ``eps`` (probes, or Hutch++'s pair) may be injected; otherwise they are
    drawn from ``generator``, x0 first.  ``trace_mesh`` and ``mesh`` as in
    `get_log_prob`.
    """
    with span("ecnf.solve"):
        if x0 is None:
            x0 = cnf.sample_base((batch_size,), generator=generator)
        B, D = x0.shape
        if approx and eps is None:
            eps = _draw_probes(generator, B, D, cfg, x0.device)
        x0, features = shard_batch((x0, features), mesh)
        log_prob_base = cnf.log_prob_base(x0)
        func = _augmented_field(cnf, features, approx, _shard_probes(eps, mesh), cfg, trace_mesh)
        zeros = torch.zeros((x0.shape[0], 1), dtype=x0.dtype, device=x0.device)
        y1, stats = _solve(func, torch.cat([x0, zeros], dim=-1), 0.0, 1.0, cfg)
        (x1, log_prob_base, delta_log_lik), stats = _gather(
            mesh, stats, y1[:, :-1], log_prob_base, y1[:, -1]
        )
        if return_stats:
            return x1, log_prob_base - delta_log_lik, stats
        return x1, log_prob_base - delta_log_lik
