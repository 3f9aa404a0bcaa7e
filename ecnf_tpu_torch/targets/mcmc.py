"""Batched HMC sampler for regenerating Boltzmann datasets (port of
`ecnf_tpu/targets/mcmc.py`).

All chains advance together as one ``[C, N, D]`` batch in a host loop of
``burn_in + n_samples_per_chain * thin`` steps; the gradient of the summed
log-prob comes from autograd.  The gradient at the end of one leapfrog
step is the gradient at the start of the next, so it is computed once and
carried (the JAX leapfrog computes it twice; the values are the same).

Momenta ``[n_steps, C, N, D]`` and uniforms ``[n_steps, C]`` are drawn up
front from a generator (on the generator's device, then moved to the
chains'), or injected.

A chain can start where every leapfrog trajectory diverges: a compressed
DW4 start turns hundreds of units of potential energy into momentum that
carries the particles into the quartic wall, where a step of 0.12 is
unstable, so nearly every proposal is rejected (one in ~2,000 accepted
from the worst start of the seed-2023 draw) and the chain may sit at its
start past the burn-in.  With ``restart_stuck_at=k`` (a step inside the
burn-in), each chain that has accepted nothing by step ``k`` takes over
the state of the next chain (in index order, cyclically) that has; the
burn-in's remaining steps decorrelate the two.

On a CUDA device one HMC step is captured as a CUDA graph and replayed:
every shape is static, and the step's ~15 x 50 small kernels are then
launched without the host's per-kernel overhead.
"""
from typing import Callable, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
LogProb = Callable[[Tensor], Tensor]  # [C, N, D] -> [C]


def value_and_grad(log_prob_fn: LogProb) -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
    """``x -> (log_prob_fn(x), d sum(log_prob_fn(x)) / dx)``."""

    def fn(x: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            leaf = x.detach().requires_grad_()
            lp = log_prob_fn(leaf)
            (grad,) = torch.autograd.grad(lp.sum(), leaf)
        return lp.detach(), grad

    return fn


def _leapfrog(vg, x, p, step_size, n_steps, grad=None):
    """``n_steps`` leapfrog steps of all chains; ``vg = value_and_grad(...)``
    and ``grad`` its gradient at ``x`` when known.  Returns ``(x, p,
    log_prob, grad)`` at the end point."""
    half = 0.5 * step_size
    if grad is None:
        lp, grad = vg(x)
    for _ in range(n_steps):
        p = p + half * grad
        x = x + step_size * p
        lp, grad = vg(x)
        p = p + half * grad
    return x, p, lp, grad


def hmc_step(vg, x, lp, grad, p, log_u, step_size, n_leapfrog):
    """One Metropolis-adjusted step: leapfrog from momenta ``p``, then
    accept where ``log_u < Δ`` and the new log-prob is finite (JAX
    `run_hmc`).  Returns ``(x, lp, grad, accept)``."""
    ke0 = 0.5 * torch.sum(p**2, dim=(-1, -2))
    x_new, p_new, lp_new, grad_new = _leapfrog(vg, x, p, step_size, n_leapfrog, grad)
    ke1 = 0.5 * torch.sum(p_new**2, dim=(-1, -2))
    log_accept = (lp_new - ke1) - (lp - ke0)
    accept = (log_u < log_accept) & torch.isfinite(lp_new)
    a3 = accept[:, None, None]
    return (torch.where(a3, x_new, x), torch.where(accept, lp_new, lp),
            torch.where(a3, grad_new, grad), accept)


def icosahedron_with_center(
    n_chains: int, generator: Optional[torch.Generator] = None, noise: float = 0.05,
    device=None, eps: Optional[Tensor] = None,
) -> Tensor:
    """Noisy 13-particle icosahedral configurations ``[n_chains, 13, 3]``
    (the LJ13 ground state: 12 vertices at unit circumradius and a central
    atom), a low-energy start for the steep LJ potential.  ``eps`` injects
    the unit normal noise."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    base = []
    for s1 in (1.0, -1.0):
        for s2 in (1.0, -1.0):
            base.append([0.0, s1 * 1.0, s2 * phi])
            base.append([s1 * 1.0, s2 * phi, 0.0])
            base.append([s2 * phi, 0.0, s1 * 1.0])
    verts = np.unique(np.round(np.array(base), 8), axis=0)
    assert verts.shape == (12, 3), verts.shape
    verts = verts / np.linalg.norm(verts[0])
    x0 = torch.from_numpy(np.concatenate([np.zeros((1, 3)), verts], axis=0)).float()
    x0 = x0[None].repeat(n_chains, 1, 1)
    if eps is None:
        gen_device = generator.device if generator is not None else "cpu"
        eps = torch.randn(x0.shape, generator=generator, device=gen_device)
    return (x0 + noise * eps.cpu()).to(device or "cpu")


class _GraphedStep:
    """One `hmc_step` captured as a CUDA graph over static buffers: copy a
    step's momenta and log-uniforms in, replay, read ``x``."""

    def __init__(self, vg, x, lp, grad, step_size, n_leapfrog):
        self.x, self.lp, self.grad = x.clone(), lp.clone(), grad.clone()
        self.p = torch.zeros_like(x)
        self.log_u = torch.zeros_like(lp)
        self.accepted = torch.zeros_like(lp)

        def step():
            x_, lp_, g_, acc = hmc_step(vg, self.x, self.lp, self.grad, self.p, self.log_u,
                                        step_size, n_leapfrog)
            self.x.copy_(x_)
            self.lp.copy_(lp_)
            self.grad.copy_(g_)
            self.accepted.add_(acc.to(self.accepted.dtype))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):  # warm-up, as graph capture requires
                step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            step()
        # The warm-up moved the chains: start again from the given state.
        self.x.copy_(x)
        self.lp.copy_(lp)
        self.grad.copy_(grad)
        self.accepted.zero_()

    def __call__(self, p: Tensor, log_u: Tensor) -> Tensor:
        self.p.copy_(p)
        self.log_u.copy_(log_u)
        self.graph.replay()
        return self.x


def run_hmc(
    log_prob_fn: LogProb,
    n_samples_per_chain: int,
    n_chains: int,
    n_nodes: int,
    dim: int,
    step_size: float = 0.05,
    n_leapfrog: int = 10,
    burn_in: int = 500,
    thin: int = 5,
    init_scale: float = 1.0,
    init_positions: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    momenta: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
    cuda_graph: Optional[bool] = None,
    restart_stuck_at: Optional[int] = None,
) -> Tuple[Tensor, float]:
    """Sample ``[n_chains * n_samples_per_chain, N, D]`` from exp(log_prob),
    chain-major: the kept states ``[S, C]`` of steps ``burn_in, burn_in +
    thin, ...`` ordered ``[C, S]``.  Returns ``(samples, acceptance rate
    over every step and chain)``.

    ``init_positions [C, N, D]`` replaces the start ``init_scale * N(0,
    1)``.  From ``generator`` come the start (unless given), then the
    momenta, then the uniforms; ``momenta`` and ``uniforms`` inject them
    instead.  ``cuda_graph`` (default: on a CUDA device) replays one
    captured step per iteration.  ``restart_stuck_at``: see the module's
    docstring.
    """
    device = torch.device(device or "cpu")
    n_total = burn_in + n_samples_per_chain * thin
    gen_device = generator.device if generator is not None else "cpu"

    def draw(fn, shape):
        return fn(shape, generator=generator, device=gen_device).to(device)

    if init_positions is not None:
        x = init_positions.to(device=device, dtype=torch.float32)
    else:
        x = init_scale * draw(torch.randn, (n_chains, n_nodes, dim))
    if momenta is None:
        momenta = draw(torch.randn, (n_total, n_chains, n_nodes, dim))
    if uniforms is None:
        uniforms = draw(torch.rand, (n_total, n_chains))
    momenta = momenta.to(device)
    log_us = torch.log(uniforms.to(device))
    if momenta.shape != (n_total, n_chains, n_nodes, dim) or log_us.shape != (n_total, n_chains):
        raise ValueError(f"momenta {tuple(momenta.shape)} and uniforms {tuple(log_us.shape)} "
                         f"do not cover {n_total} steps of {n_chains} chains")

    if restart_stuck_at is not None and not 0 < restart_stuck_at < burn_in:
        raise ValueError(f"restart_stuck_at={restart_stuck_at} is not inside the burn-in ({burn_in})")
    vg = value_and_grad(log_prob_fn)
    lp, grad = vg(x)
    kept = torch.empty((n_samples_per_chain, n_chains, n_nodes, dim), device=device)
    if cuda_graph is None:
        cuda_graph = device.type == "cuda"
    if cuda_graph:
        step = _GraphedStep(vg, x, lp, grad, step_size, n_leapfrog)
        state, accepted = (step.x, step.lp, step.grad), step.accepted
    else:
        state, accepted = [x, lp, grad], torch.zeros((n_chains,), device=device)
    for i in range(n_total):
        if i == restart_stuck_at:
            _restart_stuck(state, accepted)
        if cuda_graph:
            x = step(momenta[i], log_us[i])
        else:
            *state, acc = hmc_step(vg, *state, momenta[i], log_us[i], step_size, n_leapfrog)
            accepted += acc
            x = state[0]
        if i >= burn_in and (i - burn_in) % thin == 0:
            kept[(i - burn_in) // thin].copy_(x)
    samples = kept.transpose(0, 1).reshape(n_chains * n_samples_per_chain, n_nodes, dim)
    return samples, float(accepted.sum()) / (n_total * n_chains)


def _restart_stuck(state, accepted: Tensor) -> None:
    """Each chain with no accepted step takes, in place, the state (x, log
    p, gradient) of the next chain in index order, cyclically, that has
    one."""
    moving = (accepted > 0).tolist()
    if all(moving) or not any(moving):
        return
    n = len(moving)
    stuck = [c for c in range(n) if not moving[c]]
    donors = [next((c + k) % n for k in range(1, n) if moving[(c + k) % n]) for c in stuck]
    print(f"HMC: restarting {len(stuck)} chain(s) that accepted no step, {stuck}, from {donors}")
    for t in state:
        t[stuck] = t[donors]
