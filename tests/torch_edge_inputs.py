"""Random arguments of the port's edge-tangent kernel, for its tests.

Imports no JAX, so the card-only tests that use it run where JAX is not
installed (``python -m pytest --noconftest tests/test_torch_edge_tangent_gpu.py``).
"""
import numpy as np
import torch


def edge_inputs(K, B, N, U, L, seed):
    """numpy kernel arguments with the value ranges of real residuals."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, size=s).astype(np.float32)
    g = u(0.0, 1.0, B, N, N)
    return dict(
        a_t=f(K, B, N, U), b_t=f(K, B, N, U), l2_t=f(K, B, N, N),
        d_e=[u(-0.1, 1.1, B, N, N, U) for _ in range(L)],
        d_x=[u(-0.1, 1.1, B, N, N, U) for _ in range(L)],
        m=u(-0.3, 2.0, B, N, N, U), g=g, gd=g * (1 - g),
        e_l=f(U), e_tail=[f(U, U) / np.sqrt(U) for _ in range(L - 1)],
        x_tail=[f(U, U) / np.sqrt(U) for _ in range(L)],
        x_out=f(U) / np.sqrt(U), g_out=f(U) / np.sqrt(U),
    )


def torch_args(args, dtype=torch.float32, device="cpu"):
    """`edge_inputs` as contiguous tensors in ``dtype`` (``l2_t`` stays f32)."""

    def conv(v):
        if isinstance(v, list):
            return [conv(x) for x in v]
        return torch.from_numpy(v).to(device=device, dtype=dtype).contiguous()

    out = {k: conv(v) for k, v in args.items()}
    out["l2_t"] = out["l2_t"].float()
    return out
