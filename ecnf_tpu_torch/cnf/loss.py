"""Conditional flow-matching loss (port of `ecnf_tpu/cnf/loss.py`).

Sample ``x0`` from the base and ``t ~ U[0, 1]`` per sample (x0 first), build
the OT conditional path, and regress the field onto the conditional vector
field with an MSE over all ``[B, D]`` entries.  ``x0`` and ``t`` may be
injected instead of drawn, so that a run can be compared with the JAX
package on the same inputs.
"""
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from ecnf_tpu_torch.cnf.core import FlowMatchingCNF

Tensor = torch.Tensor


def draw_t(n: int, generator: Optional[torch.Generator], device) -> Tensor:
    """``t ~ U[0, 1]`` for ``n`` samples, drawn on the generator's device."""
    gen_device = generator.device if generator is not None else device
    return torch.rand((n,), generator=generator, device=gen_device).to(device)


def flow_matching_loss_fn(
    cnf: FlowMatchingCNF,
    x_data: Tensor,
    features: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    t: Optional[Tensor] = None,
    params: Optional[Mapping[str, Tensor]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """MSE flow-matching loss on a ``[B, D]`` batch of flat coordinates.

    ``params`` (names of ``cnf.field.named_parameters()``) evaluates the
    field at those tensors instead of its own parameters.
    """
    if x_data.dim() != 2:
        raise ValueError(f"x_data must be [B, D], got {tuple(x_data.shape)}")
    B = x_data.shape[0]
    if x0 is None:
        x0 = cnf.sample_base((B,), generator=generator)
    if t is None:
        t = draw_t(B, generator, x_data.device)
    x_t, u_t = cnf.get_x_t_and_conditional_u_t(x0, x_data, t)
    if params is None:
        v_t = cnf.apply(x_t, t, features)
    else:
        v_t = functional_call(cnf.field, dict(params), (x_t, t, features))
    loss = ((v_t - u_t) ** 2).mean()
    return loss, {"loss": loss}
