"""CNF sampling and exact / Hutchinson log-density (port of `ecnf_tpu/cnf/sampling.py`).

One batched ODE solve per call, adaptive Dopri5 by default or fixed-step
rk4 / Dopri5; the divergence rides in the state as an extra column
(``[B, D+1]``), so the adaptive error norm covers it too.  Noise comes
from an explicit ``torch.Generator`` or is injected (``x0``, ``eps``), so
that a run can be compared with the JAX package on the same inputs.
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ecnf_tpu_torch.cnf.core import FlowMatchingCNF
from ecnf_tpu_torch.ops.divergence import (
    value_and_exact_divergence,
    value_and_hutchinson_divergence,
    value_and_multi_probe_hutchinson,
)
from ecnf_tpu_torch.ops.ode import ODEStats, odeint

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
    Hutchinson solves ignore it.  The JAX ``fused_batch_tile`` and
    ``fused_interpret`` are TPU settings and are not ported.
    """

    use_fixed_step_size: bool = False
    rtol: float = 1e-5
    atol: float = 1e-5
    dtmin: float = 1e-5
    step_size: float = 0.05
    max_steps: int = 4096
    method: str = "dopri5"
    hutchinson_probes: int = 1
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


def _draw_probes(generator, B: int, D: int, cfg: SolveConfig, device) -> Tensor:
    """One fixed Gaussian probe per sample ``[B, D]``, or ``[K, B, D]``
    probes when ``cfg.hutchinson_probes > 1``."""
    shape = (B, D) if cfg.hutchinson_probes == 1 else (cfg.hutchinson_probes, B, D)
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def _augmented_field(cnf: FlowMatchingCNF, features, approx: bool, eps, cfg: SolveConfig):
    """Vector field on the ``[B, D+1]`` (x, log-det) augmented state."""
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

    if cfg.structured_tangent and cnf.tangent_value_and_div is not None:
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

        if approx and eps.dim() == 3:
            v, div = value_and_multi_probe_hutchinson(f_x, x, eps)
        elif approx:
            v, div = value_and_hutchinson_divergence(f_x, x, eps)
        else:
            v, div = value_and_exact_divergence(f_x, x, basis=basis, trace_offset=offset)
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
) -> Tensor:
    """Draw ``[batch_size, D]`` flow samples by integrating t: 0 -> 1."""

    def func(t, y):
        return cnf.apply(y, t, features)

    if x0 is None:
        x0 = cnf.sample_base((batch_size,), generator=generator)
    x1, _ = _solve(func, x0, 0.0, 1.0, cfg)
    return x1


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
):
    """Log-density of ``[B, D]`` points by integrating t: 1 -> 0.

    Returns ``(log_p, log_prob_base, delta_log_lik)`` (plus `ODEStats`
    when ``return_stats``), with ``log_p = log_prob_base(x0) + delta``.
    ``eps`` injects the Hutchinson probes (``approx=True``).
    """
    B, D = x.shape
    if approx and eps is None:
        eps = _draw_probes(generator, B, D, cfg, x.device)
    func = _augmented_field(cnf, features, approx, eps, cfg)
    y0 = torch.cat([x, torch.zeros((B, 1), dtype=x.dtype, device=x.device)], dim=-1)
    y1, stats = _solve(func, y0, 1.0, 0.0, cfg)
    x0, delta_log_lik = y1[:, :-1], y1[:, -1]
    log_prob_base = cnf.log_prob_base(x0)
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
):
    """Sample and score ``[batch_size, D]`` points in one forward solve.

    Returns ``(x1, log_q)`` (plus `ODEStats` when ``return_stats``) with
    ``log_q = log_prob_base(x0) - delta``.  ``x0`` (base samples) and
    ``eps`` (probes) may be injected; otherwise they are drawn from
    ``generator``, x0 first.
    """
    if x0 is None:
        x0 = cnf.sample_base((batch_size,), generator=generator)
    log_prob_base = cnf.log_prob_base(x0)
    B, D = x0.shape
    if approx and eps is None:
        eps = _draw_probes(generator, B, D, cfg, x0.device)
    func = _augmented_field(cnf, features, approx, eps, cfg)
    y0 = torch.cat([x0, torch.zeros((B, 1), dtype=x0.dtype, device=x0.device)], dim=-1)
    y1, stats = _solve(func, y0, 0.0, 1.0, cfg)
    x1, delta_log_lik = y1[:, :-1], y1[:, -1]
    if return_stats:
        return x1, log_prob_base - delta_log_lik, stats
    return x1, log_prob_base - delta_log_lik
