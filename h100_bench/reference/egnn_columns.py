"""Plain reference of the CNF of `egnn.py` for configurations with many nodes.

The math is `egnn.py`'s, loaded from that file and not copied: the field,
the parameters, the base density and the precisions (``"f32"``, ``"bf16"``,
the controls ``"fp8"`` and ``"tf32"``, and ``"bf16_fp8_tangent"``).  Only
the exact trace is taken otherwise.  `egnn.field_and_divergence` pushes all
S identity columns through one forward-mode pass over S B rows, the primal
repeated for every column; at N = 55 (S = 165) and 8 rows that is 1,320
rows of 3,025 edges, about 2 GB for each float32 edge activation.  Here
the primal runs once for the B rows and the columns' tangents go through
it ``columns`` (`COLUMNS`) at a time, batched (`torch.func.vmap` of
`torch.func.jvp`); the trace is the sum over the blocks.  A row's value
and each of its Jacobian columns are the numbers `egnn.py` computes for
it, up to the order of float32 sums.  The fp8 precisions (`SCALED`) scale
each operand by its tensor's largest entry, and a tensor there holds all S
B rows, so they take `egnn.py`'s whole pass: blocks would give each block
a scale of its own, and a scale per column made the yardstick
``bf16_fp8_tangent`` noisy (against it the program's log q read up to
0.57 over 12 seeds on an H100, at most 0.066 with one scale over 33
columns).

Plain PyTorch in float32 (TF32 off, as the harness sets it).  It imports
nothing of the program and nothing but the modules `egnn.py` imports.
"""
import math
from typing import Optional

import torch

Tensor = torch.Tensor

# Identity columns whose tangents a pass batches.
COLUMNS = 55
# Precisions whose products scale their operands per tensor.
SCALED = ("fp8", "bf16_fp8_tangent")


def _load_egnn():
    """`egnn.py` beside this file, run as a module of its own (loaded by
    its path, as the harness loads the benchmark's files).  Its rounded
    product is given the batching rule that `torch.func.vmap` derives
    from its forward, context and jvp, as they are (the TF32 control's
    rounding is per element)."""
    path = __file__[: __file__.rindex("/") + 1] + "egnn.py"
    module = type(math)("h100_bench_reference_egnn_for_columns")
    module.__file__ = path
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), module.__dict__)
    module._RoundedMatmul.generate_vmap_rule = True
    return module


egnn = _load_egnn()
param_shapes = egnn.param_shapes


def field_and_divergence(W, cfg: dict, x: Tensor, t: Tensor, features: Tensor,
                         probes: Optional[Tensor] = None, precision: str = "f32",
                         columns: int = COLUMNS):
    """``(f(x) [B, S], div [B])`` as `egnn.field_and_divergence` gives
    them, the exact trace taken over the S identity columns ``columns`` at
    a time; with ``probes`` or in a `SCALED` precision, `egnn.py`'s own."""
    if probes is not None or precision in SCALED:
        return egnn.field_and_divergence(W, cfg, x, t, features, probes, precision)
    B, S = x.shape

    def column(tangent):
        return torch.func.jvp(lambda xx: egnn.field(W, cfg, xx, t, features, precision), (x,),
                              (tangent,))

    value = None
    div = torch.zeros(B, dtype=torch.float32, device=x.device)
    identity = torch.eye(S, dtype=x.dtype, device=x.device)
    for c0 in range(0, S, columns):
        eye = identity[c0:c0 + columns]  # [n, S]
        tangents = eye[:, None, :].expand(eye.shape[0], B, S)
        v, jv = torch.func.vmap(column, out_dims=(None, 0))(tangents)
        div = div + (jv.float() * eye[:, None, :]).sum((0, 2))
        value = v
    return value, div


def sample_and_log_q(W, cfg: dict, x0: Tensor, features: Tensor, n_steps: int,
                     probes: Optional[Tensor] = None, precision: str = "f32",
                     columns: int = COLUMNS):
    """`egnn.sample_and_log_q` (classic RK4 in ``n_steps`` equal steps on
    ``(x, log-det)``) with the trace of `field_and_divergence`."""
    B = x0.shape[0]
    dt = 1.0 / n_steps

    def rhs(t: float, y: Tensor) -> Tensor:
        tt = torch.full((B,), t, dtype=torch.float32, device=y.device)
        v, div = field_and_divergence(W, cfg, y[:, :-1], tt, features, probes, precision,
                                      columns)
        return torch.cat([v, div[:, None]], dim=1)

    y = torch.cat([x0, torch.zeros((B, 1), dtype=x0.dtype, device=x0.device)], dim=1)
    for i in range(n_steps):
        t = i * dt
        k1 = rhs(t, y)
        k2 = rhs(t + 0.5 * dt, y + 0.5 * dt * k1)
        k3 = rhs(t + 0.5 * dt, y + 0.5 * dt * k2)
        k4 = rhs(t + dt, y + dt * k3)
        y = y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return y[:, :-1], egnn.base_log_prob(x0, cfg) - y[:, -1]
