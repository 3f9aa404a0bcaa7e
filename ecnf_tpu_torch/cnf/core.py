"""Flow-matching CNF core (port of `ecnf_tpu/cnf/core.py`)."""
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def optimal_transport_conditional_vf(
    x0: Tensor, x1: Tensor, t: Tensor, sigma_min: float
) -> Tuple[Tensor, Tensor]:
    """Conditional OT path on ``[B, D]`` batches, ``t: [B]``.

    ``x_t = (1 - (1 - sigma_min) t) x0 + t x1``, ``u_t = x1 - (1 - sigma_min) x0``.
    """
    t_ = t[..., None]
    x_t = (1.0 - (1.0 - sigma_min) * t_) * x0 + t_ * x1
    u_t = x1 - (1.0 - sigma_min) * x0
    return x_t, u_t


class FlowMatchingCNF(NamedTuple):
    """The pieces of a flow-matching CNF.

    The JAX container's ``init`` / ``apply(params, ...)`` pair becomes one
    ``field`` module, ``field(x [B, D], t [B], features [B, N]) -> [B, D]``,
    which holds its own parameters.  The rest keeps the JAX signatures
    without the key or params argument:

    - ``sample_base(batch_shape, generator=None, noise=None)``
    - ``get_x_t_and_conditional_u_t(x0, x1, t)``
    - ``log_prob_base(x [..., D])``
    - ``sample_and_log_prob_base(batch_shape, generator=None, noise=None)``
    - ``exact_trace_plan() -> (basis [K, D], trace_offset [])``
    - ``tangent_value_and_div(x, t, features, basis, trace_offset=None,
      use_kernel=True, weights=None) -> (v [B, D], div [B])``
    - ``trace_weights() -> weights``: the tangent path's weights in the
      compute dtype, taken once per solve and passed to every
      ``tangent_value_and_div`` call of that solve.
    - ``fused_value_and_div(x, t, features, weights=None) -> (v [B, D],
      div [B])``: the field and its full exact divergence over all D
      identity columns in one fused kernel, f32 whatever the compute dtype
      (`ops/fused_trace.py`, the port of the JAX CNF's hook of the same
      name); selected by ``SolveConfig(fused_trace=True)``.  ``None`` when
      the architecture does not support it (non-constant ``mlp_units``).
    - ``fused_weights() -> weights``: its packed f32 weights, taken once
      per solve.
    """

    field: nn.Module
    sample_base: Callable[..., Tensor]
    get_x_t_and_conditional_u_t: Callable[[Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]
    log_prob_base: Callable[[Tensor], Tensor]
    sample_and_log_prob_base: Callable[..., Tuple[Tensor, Tensor]]
    exact_trace_plan: Optional[Callable[[], Tuple[Tensor, Tensor]]] = None
    tangent_value_and_div: Optional[Callable[..., Tuple[Tensor, Tensor]]] = None
    trace_weights: Optional[Callable[[], Any]] = None
    fused_value_and_div: Optional[Callable[..., Tuple[Tensor, Tensor]]] = None
    fused_weights: Optional[Callable[[], Any]] = None

    def apply(self, x: Tensor, t: Tensor, features: Any = None) -> Tensor:
        return self.field(x, t, features)
