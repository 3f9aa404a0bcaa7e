"""Generate configurations from the EGNN flow, optionally with log q(x).

The PyTorch counterpart of `examples/sample.py`: builds the CNF, draws
samples by integrating the flow with a fixed-step solver, optionally
carries the exact (or Hutchinson) log-density along the solve, and writes
an ``[n, n_nodes, dim]`` ``.npy`` (and the ``[n]`` log q with
``--log-prob-output``).  Weights come from ``--params-npz`` (a flax
parameter tree saved with ``numpy.savez`` under ``"/"``-joined paths, see
`ecnf_tpu_torch.convert`) or, without it, from the seeded init.  Node
features are all zero (DW4, LJ13, QM9) or each atom's index
(``--features arange``, ALDP).  The first batch, which carries CUDA's
start-up and the kernels' builds, is timed apart from the steady rate.

Usage:
    python -m ecnf_tpu_torch.sample --n-nodes 13 --n-samples 96 \
        --batch-size 48 --method rk4 --with-log-prob --dtype bfloat16 \
        [--fused-trace] [--params-npz params.npz] [--features {zeros,arange}] \
        [--output samples.npy] [--log-prob-output log_q.npy]
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf, sample_cnf
from ecnf_tpu_torch.convert import from_flax


def build_parser() -> argparse.ArgumentParser:
    def positive_int(text: str) -> int:
        v = int(text)
        if v < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return v

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-nodes", type=positive_int, required=True)
    p.add_argument("--dim", type=positive_int, default=3)
    p.add_argument("--n-samples", type=positive_int, default=1024)
    p.add_argument("--batch-size", type=positive_int, default=256)
    p.add_argument("--method", choices=["rk4", "dopri5"], default="rk4")
    p.add_argument("--step-size", type=float, default=0.05)
    p.add_argument("--with-log-prob", action="store_true",
                   help="also compute log q(x) along the forward solve")
    p.add_argument("--approx", action="store_true", help="Hutchinson estimate")
    p.add_argument("--fused-trace", action="store_true",
                   help="exact trace through the fused forward + divergence kernel "
                        "(f32; only with --with-log-prob)")
    p.add_argument("--hutchinson-probes", type=positive_int, default=1)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="compute dtype of the EGNN's MLPs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default=None, help="write samples here")
    p.add_argument("--log-prob-output", type=str, default=None,
                   help="write the [n] log q here (needs --with-log-prob)")
    p.add_argument("--features", choices=["zeros", "arange"], default="zeros",
                   help="node features: zeros (DW4/LJ13/QM9) or per-atom index (ALDP)")
    p.add_argument("--params-npz", type=str, default=None,
                   help="flax parameters exported from the JAX package")
    # Network shape; the defaults are the LJ13 configuration.
    p.add_argument("--n-blocks", type=positive_int, default=3)
    p.add_argument("--mlp-units", type=positive_int, nargs="+", default=[128, 128, 128])
    p.add_argument("--hidden", type=positive_int, default=64,
                   help="n_invariant_feat_hidden")
    p.add_argument("--time-embedding-dim", type=positive_int, default=8)
    p.add_argument("--base-scale", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked for (--device cpu)")
    return p


def build_from_args(args: argparse.Namespace, device):
    cnf = build_cnf(
        n_frames=args.n_nodes, dim=args.dim, sigma_min=0.01,
        base_scale=args.base_scale, n_blocks_egnn=args.n_blocks,
        mlp_units=tuple(args.mlp_units), n_invariant_feat_hidden=args.hidden,
        time_embedding_dim=args.time_embedding_dim,
        n_features=args.n_nodes if args.features == "arange" else 1,
        compute_dtype=args.dtype, device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    if args.params_npz:
        with np.load(args.params_npz) as npz:
            cnf.field.load_state_dict(from_flax(npz))
    return cnf


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the sampler; returns ``samples [n, N*D]``, ``log_q [n]`` (or
    None), ``seconds`` in all, ``first_batch_seconds``,
    ``steady_per_second`` (samples per second after the first batch, None
    for a single batch) and ``device`` besides printing a summary."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.log_prob_output and not args.with_log_prob:
        parser.error("--log-prob-output needs --with-log-prob")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ecnf_tpu_torch.sample: no CUDA device; pass --device cpu to run on the CPU")
    cnf = build_from_args(args, device)
    cfg = SolveConfig(
        use_fixed_step_size=True, step_size=args.step_size, method=args.method,
        hutchinson_probes=args.hutchinson_probes, fused_trace=args.fused_trace,
    )
    n, B = args.n_samples, min(args.batch_size, args.n_samples)
    if args.features == "arange":
        row = torch.arange(args.n_nodes, dtype=torch.int64, device=device)
    else:
        row = torch.zeros((args.n_nodes,), dtype=torch.int64, device=device)
    features = row.repeat(B, 1)
    # Noise is drawn on the CPU so one seed gives the same samples on every device.
    generator = torch.Generator().manual_seed(args.seed)

    samples = np.empty((n, args.n_nodes * args.dim), np.float32)
    log_q = np.empty((n,), np.float32) if args.with_log_prob else None
    start = time.perf_counter()
    first_seconds = 0.0
    for lo in range(0, n, B):
        take = min(B, n - lo)
        if args.with_log_prob:
            x1, lq = sample_and_log_prob_cnf(
                cnf, B, features, approx=args.approx, cfg=cfg, generator=generator
            )
            log_q[lo : lo + take] = lq[:take].cpu().numpy()
        else:
            x1 = sample_cnf(cnf, B, features, cfg=cfg, generator=generator)
        samples[lo : lo + take] = x1[:take].cpu().numpy()
        if lo == 0:
            _sync(device)
            first_seconds = time.perf_counter() - start
    _sync(device)
    seconds = time.perf_counter() - start
    n_first = min(B, n)
    steady = (n - n_first) / (seconds - first_seconds) if n > n_first else None

    bad = ~np.isfinite(samples).all(axis=1)
    if log_q is not None:
        bad |= ~np.isfinite(log_q)
    if bad.any():
        print(f"WARNING: {int(bad.sum())}/{n} samples are non-finite")
    extra = ""
    if log_q is not None:
        kind = "Hutchinson" if args.approx else ("exact, fused" if args.fused_trace else "exact")
        extra = f", mean log q {log_q.mean():.4f} ({kind} trace)"
    if steady is not None:
        rate = f"steady {steady:.1f}/s over the other {n - n_first}"
    else:
        rate = f"{n / first_seconds:.1f}/s (single batch, incl. start-up)"
    print(
        f"sampled {n} configurations on {device} in {seconds:.2f}s: first batch of "
        f"{n_first} {first_seconds:.2f}s, {rate} ({args.method}, {args.dtype}){extra}"
    )
    if args.output:
        np.save(args.output, samples.reshape(n, args.n_nodes, args.dim))
        print(f"wrote {args.output}")
    if args.log_prob_output:
        np.save(args.log_prob_output, log_q)
        print(f"wrote {args.log_prob_output}")
    return {
        "samples": samples, "log_q": log_q, "seconds": seconds,
        "first_batch_seconds": first_seconds, "steady_per_second": steady, "device": str(device),
    }


if __name__ == "__main__":
    main()
