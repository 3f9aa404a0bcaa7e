"""Training state and the flow-matching update step (port of
`ecnf_tpu/training/state.py`).

The JAX step is a pure function of a pytree state; here the state holds
tensors and the step builds a new state from them (nothing in the old one
is written), so a state can be stepped twice from the same point.  The
JAX ``key`` becomes an explicit ``torch.Generator`` on the field's device,
which the step draws from; EMA off is ``ema_params=None``.  The step runs
on the device of the field's parameters, and nothing in it waits on the
host unless the caller reads ``info``.  With a mesh (`ecnf_tpu_torch.
parallel`) each rank steps on its rows of the batch and the gradient is
averaged over the ranks by hand, as GSPMD's all-reduce does in JAX.
"""
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ecnf_tpu_torch.cnf.core import FlowMatchingCNF
from ecnf_tpu_torch.cnf.loss import draw_t, flow_matching_loss_fn
from ecnf_tpu_torch.parallel.mesh import all_reduce_sum, axis_size, rows
from ecnf_tpu_torch.training.optim import AdamState, GradientTransformation
from ecnf_tpu_torch.utils.spans import span, traced

Tensor = torch.Tensor


class TrainingState(NamedTuple):
    """``params`` and ``ema_params`` map the field's parameter names to
    tensors (``cnf.field.load_state_dict(state.params)`` serves them);
    ``opt_state`` lists its tensors in the same order."""

    params: Dict[str, Tensor]
    opt_state: AdamState
    generator: torch.Generator
    ema_params: Optional[Dict[str, Tensor]] = None


def init_training_state(
    cnf: FlowMatchingCNF,
    optimizer: GradientTransformation,
    generator: torch.Generator,
    use_ema: bool = False,
) -> TrainingState:
    """State from the field's current parameters; the EMA starts as a copy
    of them, not an alias."""
    device = next(cnf.field.parameters()).device
    if generator.device.type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the field on {device}")
    params = {name: p.detach().clone() for name, p in cnf.field.named_parameters()}
    ema_params = {name: p.clone() for name, p in params.items()} if use_ema else None
    return TrainingState(params, optimizer.init(list(params.values())), generator, ema_params)


def global_norm(tensors: List[Tensor]) -> Tensor:
    """L2 norm over every entry of every tensor (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _split(x: Optional[Tensor], k: int) -> List[Optional[Tensor]]:
    return [None] * k if x is None else list(x.chunk(k))


def draw_noise(
    cnf: FlowMatchingCNF,
    n: int,
    microbatch: Optional[int],
    generator: Optional[torch.Generator],
    device,
    x0: Optional[Tensor] = None,
    t: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The x0 and t of a step on ``n`` rows: those injected, and the others
    drawn from ``generator`` chunk by chunk (``microbatch=k`` chunks), each
    chunk's x0 then its t, joined in row order."""
    k = 1 if microbatch is None or microbatch <= 1 else int(microbatch)
    x0s, ts = [], []
    for _ in range(k):
        if x0 is None:
            x0s.append(cnf.sample_base((n // k,), generator=generator))
        if t is None:
            ts.append(draw_t(n // k, generator, device))
    return (torch.cat(x0s) if x0 is None else x0), (torch.cat(ts) if t is None else t)


def loss_and_grads(
    cnf: FlowMatchingCNF,
    params: Dict[str, Tensor],
    x_data: Tensor,
    features: Optional[Tensor],
    microbatch: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    t: Optional[Tensor] = None,
) -> Tuple[List[Tensor], Tensor]:
    """Gradient of the flow-matching loss at ``params`` (in their order) and
    the loss.

    ``microbatch=k`` splits the batch, the features, x0 and t into k
    chunks; x0 and t not injected are drawn by `draw_noise`.  The gradient
    is the sum of the chunk gradients divided by k and the loss the mean of
    the chunk losses (JAX `make_update_fn`).
    """
    k = 1 if microbatch is None or microbatch <= 1 else int(microbatch)
    B = x_data.shape[0]
    if B % k:
        raise ValueError(f"batch {B} not divisible by microbatch {k}")
    x0, t = draw_noise(cnf, B, k, generator, x_data.device, x0, t)
    gsum: Optional[List[Tensor]] = None
    losses = []
    for xc, fc, x0c, tc in zip(x_data.chunk(k), _split(features, k), x0.chunk(k), t.chunk(k)):
        leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
        loss, _ = flow_matching_loss_fn(cnf, xc, fc, x0=x0c, t=tc, params=leaves)
        # The last block's phi_h feeds nothing: its gradient is zero, as in JAX.
        grads = list(torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True))
        if gsum is None:
            gsum = grads
        else:
            torch._foreach_add_(gsum, grads)
        losses.append(loss.detach())
    if k == 1:
        return gsum, losses[0]
    return torch._foreach_div(gsum, float(k)), torch.stack(losses).mean()


def mean_over_ranks(grads: List[Tensor], loss: Tensor, mesh) -> Tuple[List[Tensor], Tensor]:
    """The ranks' mean of ``grads`` and ``loss``: one f32 bucket holding
    every gradient and the loss, one ``all_reduce`` of it, then a division
    by the ranks (exact for one rank, where the all-reduce is a copy)."""
    bucket = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
    all_reduce_sum(bucket, mesh).div_(axis_size(mesh))
    parts = bucket.split([g.numel() for g in grads] + [1])
    return [p.view_as(g).to(g.dtype) for p, g in zip(parts, grads)], parts[-1][0].to(loss.dtype)


def make_update_fn(
    cnf: FlowMatchingCNF,
    optimizer: GradientTransformation,
    use_ema: bool = False,
    ema_beta: float = 0.999,
    mesh=None,
    microbatch: Optional[int] = None,
) -> Callable[..., Tuple[TrainingState, Dict[str, Tensor]]]:
    """``update(state, x_data, features, x0=None, t=None) -> (state, info)``
    with info keys ``loss``, ``grad_norm`` and ``update_norm`` (0-d tensors
    on the field's device).  ``microbatch`` of None or 1 is the unchunked
    step; see `loss_and_grads`.  The EMA is ``bar * beta + (1 - beta) *
    new``.

    With a ``mesh`` (its ``data`` axis of W ranks, each holding the same
    state: `parallel.replicate`), ``x_data`` and ``features`` are this
    rank's rows of a global batch of W times as many.  The x0 and t of the
    global batch, injected or drawn from the shared generator as a single
    process would (`draw_noise`), are the same on every rank, and each rank
    keeps its rows (`parallel.mesh.rows`; all of them without a mesh).  The
    rank's gradient and loss are then averaged over the ranks
    (`mean_over_ranks`, one collective a step), so the ranks' new states
    agree, and a step equals the single-process step on the global batch up
    to the order of f32 sums; ``loss`` is the global batch's and the norms
    are those of the averaged gradient and its update.
    """

    def update(
        state: TrainingState,
        x_data: Tensor,
        features: Optional[Tensor],
        x0: Optional[Tensor] = None,
        t: Optional[Tensor] = None,
    ) -> Tuple[TrainingState, Dict[str, Tensor]]:
        names = list(state.params)
        params = list(state.params.values())
        x0, t = draw_noise(cnf, x_data.shape[0] * axis_size(mesh), microbatch, state.generator,
                           x_data.device, x0, t)
        with span("ecnf.train.grad"):
            grads, loss = loss_and_grads(
                cnf, state.params, x_data, features, microbatch, x0=rows(x0, mesh), t=rows(t, mesh)
            )
        if mesh is not None:
            with span("ecnf.train.allreduce"):
                grads, loss = mean_over_ranks(grads, loss, mesh)
        with span("ecnf.train.optim"):
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
            new_params = torch._foreach_add(params, updates)
        info = {"loss": loss, "grad_norm": global_norm(grads), "update_norm": global_norm(updates)}
        ema_params = state.ema_params
        if use_ema:
            with span("ecnf.train.ema"):
                ema = torch._foreach_mul(list(ema_params.values()), ema_beta)
                torch._foreach_add_(ema, torch._foreach_mul(new_params, 1.0 - ema_beta))
                ema_params = dict(zip(names, ema))
        return (
            TrainingState(dict(zip(names, new_params)), opt_state, state.generator, ema_params),
            info,
        )

    return traced("ecnf.train.step", update)
