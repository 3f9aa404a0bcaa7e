"""Plain reference of the E(n)-equivariant flow-matching CNF that the cells run.

Written from the model's equations (Satorras et al.'s EGNN as the
ecnf-baseline-neurips-2023 repository configures it: dense edges, a time
ConcatDense before each block, gated messages, output recentred and scaled),
in plain PyTorch, in float32 with every product at full float32 accuracy.
It imports nothing of the program and takes nothing the program made: it
reads the benchmark's own weight tensors (a dict keyed by the parameter names
that `param_shapes` lists), concatenates each layer's inputs itself, takes
pairwise distances from coordinate differences, and takes the exact trace
over every identity column of the Jacobian by forward-mode autodiff.

``precision`` selects how the MLPs compute: ``"f32"`` (the reference);
``"bf16"``, the MLPs in bfloat16 with float32 geometry, sums and trace, as
a bfloat16 configuration states: the yardstick of that configuration's
gaps (how far an honest computation in its precision lies from the float32
answer); the controls, one precision below the configuration's:
the MLPs' products in float8 e4m3 (``"fp8"``, each operand scaled per
tensor as fp8 products are fed) or in TF32 (``"tf32"``): every operand,
its tangent, and in the backward pass each incoming gradient, rounded
before a float32 product; the rest in float32.  That is the step a later
change would take, the products onto lower-precision tensor cores, without
crediting the control with the bf16 rounding of activations that the
``"bf16"`` yardstick already carries.  ``"bf16_fp8_tangent"`` is ``"bf16"``
with only the tangent's products in fp8: the primal, and so x1, as in
``"bf16"``, the trace below it (an edge-tangent kernel that drops to fp8).
"""
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor
Weights = Dict[str, Tensor]


def _round(x: Tensor, precision: str) -> Tensor:
    if precision == "tf32":  # nearest value with a 10-bit mantissa
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "fp8":  # e4m3 with one scale per tensor, its largest entry at 448
        x = x.float()
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` of 2-D operands with every operand rounded, in the forward
    product, its tangent and its backward products; with ``primal`` False
    the forward product is left as it is and only its tangent is rounded."""

    @staticmethod
    def forward(a, b, precision, primal):
        if not primal:
            return a @ b
        return _round(a, precision) @ _round(b, precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, precision, _ = inputs
        ctx.precision = precision
        ctx.save_for_backward(a, b)
        ctx.save_for_forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        g = _round(g, p)
        return (g @ _round(b, p).T).to(a.dtype), (_round(a, p).T @ g).to(b.dtype), None, None

    @staticmethod
    def jvp(ctx, a_t, b_t, _, __):
        a, b = ctx.saved_tensors
        p = ctx.precision
        out = 0
        if a_t is not None:
            out = out + _round(a_t, p) @ _round(b, p)
        if b_t is not None:
            out = out + _round(a, p) @ _round(b_t, p)
        return out.to(a.dtype)


def _matmul(a: Tensor, b: Tensor, precision: str) -> Tensor:
    if precision == "f32":
        return a @ b
    return _RoundedMatmul.apply(a, b, precision, True)


def dense(x: Tensor, w: Tensor, b: Tensor, precision: str) -> Tensor:
    """``x @ w.T + b`` over the last axis; ``w`` is ``[out, in]``.  Under
    ``"bf16"`` the layer runs in bfloat16 (its output, and the MLP's
    activations after it, are bf16 until a caller takes them to f32); under
    ``"bf16_fp8_tangent"`` it runs so too, with the tangent of its product
    taken from fp8 operands."""
    lead = x.shape[:-1]
    if precision in ("bf16", "bf16_fp8_tangent"):
        x, w, b = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        x2, wt = x.reshape(-1, x.shape[-1]), w.T
        y = x2 @ wt if precision == "bf16" else _RoundedMatmul.apply(x2, wt, "fp8", False)
    else:
        y = _matmul(x.reshape(-1, x.shape[-1]), w.T, precision)
    return y.to(x.dtype).reshape(*lead, w.shape[0]) + b


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the field and its shape (``[out, in]`` kernels)."""
    H, T = cfg["n_invariant_feat_hidden"], cfg["time_embedding_dim"]
    units = list(cfg["mlp_units"])
    U, L = units[-1], len(units)
    shapes = {"embed.weight": (cfg["n_features"], H)}
    for i in range(cfg["n_blocks_egnn"]):
        shapes[f"egnn.time_dense.{i}.weight"] = (H, H + T)
        shapes[f"egnn.time_dense.{i}.bias"] = (H,)
        p = f"egnn.blocks.{i}."
        for name, widths in (("phi_e", [2 * H + 1] + units[:-1]), ("phi_x", [U] + units[:-1])):
            for k, (n_in, n_out) in enumerate(zip(widths, units)):
                shapes[f"{p}{name}.layers.{k}.weight"] = (n_out, n_in)
                shapes[f"{p}{name}.layers.{k}.bias"] = (n_out,)
        for name in ("phi_x_out", "gate"):
            shapes[f"{p}{name}.weight"] = (1, U)
            shapes[f"{p}{name}.bias"] = (1,)
        widths = [U + H] + units
        for k, (n_in, n_out) in enumerate(zip(widths, units + [H])):
            shapes[f"{p}phi_h.layers.{k}.weight"] = (n_out, n_in)
            shapes[f"{p}phi_h.layers.{k}.bias"] = (n_out,)
    shapes["egnn.final_scaling"] = ()
    return shapes


def _mlp(x: Tensor, W: Weights, prefix: str, n_layers: int, activate_final: bool,
         precision: str) -> Tensor:
    silu = torch.nn.functional.silu
    for k in range(n_layers):
        x = dense(x, W[f"{prefix}.layers.{k}.weight"], W[f"{prefix}.layers.{k}.bias"], precision)
        if k < n_layers - 1 or activate_final:
            x = silu(x)
    return x


def time_embedding(t: Tensor, dim: int) -> Tensor:
    """Sinusoidal embedding of ``1000 t``: sines then cosines, frequencies
    ``10000^(-k / (dim/2 - 1))``."""
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    args = (1000.0 * t)[:, None] * torch.exp(-math.log(10_000.0) / (half - 1) * k)[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def egcl(vec: Tensor, h: Tensor, W: Weights, i: int, L: int, precision: str):
    """One block's graph convolution: ``vec [B, N, D]``, ``h [B, N, H]``."""
    B, N, D = vec.shape
    p = f"egnn.blocks.{i}."
    diff = vec[:, :, None, :] - vec[:, None, :, :]  # receiver i minus sender j
    l2 = (diff * diff).sum(-1)
    lengths = torch.where(l2 > 0, l2, torch.ones_like(l2)).sqrt()
    mask = 1.0 - torch.eye(N, dtype=vec.dtype, device=vec.device)
    H = h.shape[-1]
    edge_in = torch.cat([
        h[:, None, :, :].expand(B, N, N, H),  # sender j
        h[:, :, None, :].expand(B, N, N, H),  # receiver i
        l2[..., None],
    ], dim=-1)
    m = _mlp(edge_in, W, p + "phi_e", L, True, precision)
    phi = dense(_mlp(m, W, p + "phi_x", L, True, precision),
                W[p + "phi_x_out.weight"], W[p + "phi_x_out.bias"], precision)[..., 0].float()
    w = phi * mask / (1.0 + lengths)
    vec_out = vec + (w[..., None] * diff).sum(2) / (N - 1)
    gate = torch.sigmoid(dense(m, W[p + "gate.weight"], W[p + "gate.bias"], precision))
    m_i = ((m * gate).float() * mask[None, :, :, None]).sum(2) / math.sqrt(N - 1)
    h_out = _mlp(torch.cat([m_i, h], dim=-1), W, p + "phi_h", L + 1, False, precision).float() + h
    return vec_out, h_out


def field(W: Weights, cfg: dict, x: Tensor, t: Tensor, features: Tensor,
          precision: str = "f32") -> Tensor:
    """The vector field at flat ``x [B, N*D]``, times ``t [B]`` and integer
    node features ``[B, N]``."""
    B = x.shape[0]
    N, D = cfg["n_nodes"], cfg["dim"]
    L = len(cfg["mlp_units"])
    pos = x.reshape(B, N, D)
    h = W["embed.weight"][features.reshape(B, N).long()]
    temb = time_embedding(t, cfg["time_embedding_dim"])
    mean = pos.mean(1, keepdim=True)
    vec = pos - mean
    vec0 = vec
    for i in range(cfg["n_blocks_egnn"]):
        td_in = torch.cat([h, temb[:, None, :].expand(B, N, temb.shape[-1])], dim=-1)
        h = dense(td_in, W[f"egnn.time_dense.{i}.weight"], W[f"egnn.time_dense.{i}.bias"],
                  precision).float()
        vec, h = egcl(vec, h, W, i, L, precision)
    return ((vec - vec0 - mean) * W["egnn.final_scaling"]).reshape(B, N * D)


def field_and_divergence(W: Weights, cfg: dict, x: Tensor, t: Tensor, features: Tensor,
                         probes: Optional[Tensor] = None, precision: str = "f32"):
    """``(f(x) [B, S], div [B])``: the exact trace over all S identity
    columns, or with ``probes [B, S]`` the Hutchinson estimate
    ``probe^T J probe``.  Forward-mode autodiff on a batch that repeats
    each row once per column; rows are independent."""
    B, S = x.shape

    def f(xx, tt, ff):
        return field(W, cfg, xx, tt, ff, precision)

    if probes is not None:
        v, jv = torch.func.jvp(lambda xx: f(xx, t, features), (x,), (probes,))
        return v, (probes * jv.float()).sum(-1)
    eye = torch.eye(S, dtype=x.dtype, device=x.device)
    xs = x[None].expand(S, B, S).reshape(S * B, S)
    tangents = eye[:, None, :].expand(S, B, S).reshape(S * B, S)
    ts = t[None].expand(S, B).reshape(S * B)
    fs = features[None].expand(S, *features.shape).reshape(S * B, -1)
    v, jv = torch.func.jvp(lambda xx: f(xx, ts, fs), (xs,), (tangents,))
    div = (jv.float().reshape(S, B, S) * eye[:, None, :]).sum((0, 2))
    return v.reshape(S, B, S)[0], div


def base_log_prob(x: Tensor, cfg: dict) -> Tensor:
    """Log density of the zero-centre-of-mass Gaussian of scale s on its
    ``(N-1) D``-dimensional hyperplane, at flat ``x``."""
    N, D, s = cfg["n_nodes"], cfg["dim"], cfg["base_scale"]
    pos = x.reshape(x.shape[0], N, D)
    pos = (pos - pos.mean(1, keepdim=True)) / s
    dof = (N - 1) * D
    return -0.5 * (pos * pos).sum((1, 2)) - 0.5 * dof * math.log(2 * math.pi) - dof * math.log(s)


def sample_and_log_q(W: Weights, cfg: dict, x0: Tensor, features: Tensor, n_steps: int,
                     probes: Optional[Tensor] = None, precision: str = "f32"):
    """Classic RK4 from t=0 to 1 in ``n_steps`` equal steps on the state
    ``(x, log-det)``; returns ``(x1, log q = log p_base(x0) - log-det)``."""
    B = x0.shape[0]
    dt = 1.0 / n_steps

    def rhs(t: float, y: Tensor) -> Tensor:
        tt = torch.full((B,), t, dtype=torch.float32, device=y.device)
        v, div = field_and_divergence(W, cfg, y[:, :-1], tt, features, probes, precision)
        return torch.cat([v, div[:, None]], dim=1)

    y = torch.cat([x0, torch.zeros((B, 1), dtype=x0.dtype, device=x0.device)], dim=1)
    for i in range(n_steps):
        t = i * dt
        k1 = rhs(t, y)
        k2 = rhs(t + 0.5 * dt, y + 0.5 * dt * k1)
        k3 = rhs(t + 0.5 * dt, y + 0.5 * dt * k2)
        k4 = rhs(t + dt, y + dt * k3)
        y = y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return y[:, :-1], base_log_prob(x0, cfg) - y[:, -1]


def flow_matching_loss(W: Weights, cfg: dict, x1: Tensor, features: Tensor, x0: Tensor,
                       t: Tensor, precision: str = "f32") -> Tensor:
    """Mean squared error of the field against the conditional optimal
    transport field ``x1 - (1 - sigma_min) x0`` at
    ``x_t = (1 - (1 - sigma_min) t) x0 + t x1``."""
    s = cfg["sigma_min"]
    x_t = (1.0 - (1.0 - s) * t[:, None]) * x0 + t[:, None] * x1
    u_t = x1 - (1.0 - s) * x0
    v = field(W, cfg, x_t, t, features, precision)
    return ((v - u_t) ** 2).mean()


def learning_rate(cfg: dict, step: int) -> float:
    """Linear warm-up from ``init_lr`` to ``peak_lr`` over ``n_iter_warmup``
    steps, then a cosine to ``end_lr`` at ``n_training_iter``."""
    init, peak, end = cfg["init_lr"], cfg["peak_lr"], cfg["end_lr"]
    warm, total = cfg["n_iter_warmup"], cfg["n_training_iter"]
    if step < warm:
        return init + (peak - init) * step / warm
    frac = min(step - warm, total - warm) / (total - warm)
    return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))


def train(W: Weights, cfg: dict, feeds: Sequence[dict], precision: str = "f32") -> List[dict]:
    """Adam steps (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
    corrected) on ``feeds`` (dicts of ``x``, ``features``, ``x0``, ``t``),
    with the EMA ``ema <- 0.999 ema + 0.001 params`` when the configuration
    keeps one.  Returns, per step, the loss, the gradients and the
    parameters and EMA after it."""
    names = list(W)
    params = {n: W[n].detach().clone() for n in names}
    ema = {n: p.clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    out = []
    for step, feed in enumerate(feeds):
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        loss = flow_matching_loss(leaves, cfg, feed["x"], feed["features"], feed["x0"],
                                  feed["t"], precision)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
        lr = learning_rate(cfg, step)
        c = step + 1
        for n in names:
            g = grads[n]
            mu[n] = 0.9 * mu[n] + 0.1 * g
            nu[n] = 0.999 * nu[n] + 0.001 * g * g
            m_hat = mu[n] / (1.0 - 0.9 ** c)
            v_hat = nu[n] / (1.0 - 0.999 ** c)
            params[n] = params[n] - lr * m_hat / (v_hat.sqrt() + 1e-8)
            if cfg["use_ema"]:
                ema[n] = 0.999 * ema[n] + 0.001 * params[n]
        out.append({"loss": float(loss.detach()), "grads": grads,
                    "params": {n: p.clone() for n, p in params.items()},
                    "ema": {n: e.clone() for n, e in ema.items()} if cfg["use_ema"] else None})
    return out
