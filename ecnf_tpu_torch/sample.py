"""Generate configurations from the EGNN flow, optionally with log q(x).

The PyTorch counterpart of `examples/sample.py`: builds the CNF, draws
samples by integrating the flow with a fixed-step solver (``--method rk4``
or ``dopri5`` at ``--step-size``) or with adaptive Dopri5 (``--method
adaptive`` at ``--rtol`` / ``--atol``), optionally carries the exact (or
Hutchinson) log-density along the solve, and writes an ``[n, n_nodes,
dim]`` ``.npy`` (and the ``[n]`` log q with ``--log-prob-output``).

Two ways to name the model:

- the reference's: ``--checkpoint-dir`` serves the latest ``state_%08i``
  under it, a checkpoint of either package (the JAX package's Orbax
  directories included), with ``--ema`` its EMA parameters; the network
  and the solve come from ``--config`` (default
  ``examples/configs/lj13.yaml``) and its ``key=value`` overrides, as in
  training (``training.use_fixed_step_size``, ``training.ode_method``,
  ``training.hutchinson_probes``);
- without a config: ``--params-npz`` (a flax parameter tree saved with
  ``numpy.savez`` under ``"/"``-joined paths, see
  `ecnf_tpu_torch.convert`) or the seeded init, with the network and the
  solve given as flags.

Node features are all zero (DW4, LJ13, QM9) or each atom's index
(``--features arange``, ALDP).  The first batch, which carries CUDA's
start-up and the kernels' builds, is timed apart from the steady rate.

Usage:
    python -m ecnf_tpu_torch.sample --config examples/configs/lj13.yaml \
        --checkpoint-dir runs/lj13/model_checkpoints [--ema] --n-nodes 13 \
        --n-samples 96 --with-log-prob [key=value ...]
    python -m ecnf_tpu_torch.sample --n-nodes 13 --n-samples 96 \
        --batch-size 48 --method {rk4,dopri5,adaptive} --with-log-prob \
        --dtype bfloat16 [--rtol 1e-5 --atol 1e-5] [--fused-trace] \
        [--params-npz params.npz] [--features {zeros,arange}] \
        [--output samples.npy] [--log-prob-output log_q.npy]
"""
import argparse
import copy
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf, sample_cnf
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.examples.common import CONFIG_DIR
from ecnf_tpu_torch.training.checkpoints import get_latest_checkpoint, restore_serving_params
from ecnf_tpu_torch.training.config import load_config
from ecnf_tpu_torch.training.setup import _refuse_unported

# Flags of the config-free route: with --checkpoint-dir the config names these.
_FLAG_ROUTE = ("params_npz", "dtype", "n_blocks", "mlp_units", "hidden", "time_embedding_dim",
              "base_scale", "method", "step_size", "rtol", "atol", "hutchinson_probes")


def positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def add_solve_args(p: argparse.ArgumentParser, default_method: str) -> None:
    """The ODE solve and the trace estimator."""
    p.add_argument("--method", choices=["rk4", "dopri5", "adaptive"], default=default_method,
                   help="fixed-step rk4 or Dopri5 at --step-size, or adaptive Dopri5 at "
                        "--rtol/--atol")
    p.add_argument("--step-size", type=float, default=0.05)
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-5)
    p.add_argument("--approx", action="store_true", help="Hutchinson estimate")
    p.add_argument("--hutchinson-probes", type=positive_int, default=1)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The network, its weights, its node features and the device."""
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="compute dtype of the EGNN's MLPs")
    p.add_argument("--seed", type=int, default=0)
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
    p.set_defaults(sigma_min=0.01, checkpoint=None)


def add_config_args(p: argparse.ArgumentParser) -> None:
    """The reference's surface: a checkpoint directory served with its config."""
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="serve the latest state_%%08i under this directory (either package's)")
    p.add_argument("--config", type=str, default=None,
                   help="experiment config naming the network and the solve (with "
                        f"--checkpoint-dir; default {CONFIG_DIR / 'lj13.yaml'})")
    p.add_argument("--ema", action="store_true",
                   help="serve the checkpoint's EMA parameters")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, e.g. "
                   "training.ode_method=rk4 (with --checkpoint-dir)")


def _explicit(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]]) -> List[str]:
    """The destinations the command line set itself (not by default)."""
    unset = object()
    probe = copy.deepcopy(parser)
    probe.set_defaults(**{dest: unset for dest in vars(parser.parse_args(argv))})
    return [dest for dest, value in vars(probe.parse_args(argv)).items() if value is not unset]


def apply_config(parser: argparse.ArgumentParser, args: argparse.Namespace,
                 argv: Optional[Sequence[str]]) -> None:
    """With ``--checkpoint-dir``: the network and the solve from ``--config``
    (the reference's `examples/sample.py` and `score.py`), and the latest
    checkpoint as ``args.checkpoint``; a network or solve flag beside it is
    refused, as is a config option the port does not run
    (`training.setup._refuse_unported`).  Without it the config's options
    are refused."""
    if args.checkpoint_dir is None:
        if args.config or args.ema or args.overrides:
            parser.error("--config, --ema and key=value overrides need --checkpoint-dir")
        return
    clash = [d for d in _explicit(parser, argv) if d in _FLAG_ROUTE]
    if clash:
        flags = " ".join("--" + d.replace("_", "-") for d in clash)
        parser.error(f"--checkpoint-dir takes the network and the solve from --config; drop {flags}")
    cfg = load_config(args.config or str(CONFIG_DIR / "lj13.yaml"), overrides=args.overrides)
    _refuse_unported(cfg)
    net, training = cfg.flow.network, cfg.training
    args.n_blocks, args.mlp_units = net.n_blocks_egnn, list(net.mlp_units)
    args.hidden, args.time_embedding_dim = net.n_invariant_feat_hidden, net.time_embedding_dim
    args.dtype = net.compute_dtype or "float32"
    args.sigma_min, args.base_scale = cfg.flow.sigma_min, cfg.flow.base_scale
    args.method = training.ode_method if training.use_fixed_step_size else "adaptive"
    args.hutchinson_probes = training.hutchinson_probes
    args.checkpoint = get_latest_checkpoint(args.checkpoint_dir)
    if args.checkpoint is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    print(f"restoring {args.checkpoint}")


def solve_config(args: argparse.Namespace, fused_trace: bool = False) -> SolveConfig:
    adaptive = args.method == "adaptive"
    return SolveConfig(
        use_fixed_step_size=not adaptive, rtol=args.rtol, atol=args.atol,
        step_size=args.step_size, method="dopri5" if adaptive else args.method,
        hutchinson_probes=args.hutchinson_probes, fused_trace=fused_trace,
    )


def device_from_args(args: argparse.Namespace, program: str) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{program}: no CUDA device; pass --device cpu to run on the CPU")
    return device


def node_features(args: argparse.Namespace, n_rows: int, device) -> torch.Tensor:
    """``[n_rows, n_nodes]`` integer node features of ``--features``."""
    if args.features == "arange":
        row = torch.arange(args.n_nodes, dtype=torch.int64, device=device)
    else:
        row = torch.zeros((args.n_nodes,), dtype=torch.int64, device=device)
    return row.repeat(n_rows, 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-nodes", type=positive_int, required=True)
    p.add_argument("--dim", type=positive_int, default=3)
    p.add_argument("--n-samples", type=positive_int, default=1024)
    p.add_argument("--batch-size", type=positive_int, default=256)
    add_solve_args(p, default_method="rk4")
    p.add_argument("--with-log-prob", action="store_true",
                   help="also compute log q(x) along the forward solve")
    p.add_argument("--fused-trace", action="store_true",
                   help="exact trace through the fused forward + divergence kernel "
                        "(f32; only with --with-log-prob)")
    p.add_argument("--output", type=str, default=None, help="write samples here")
    p.add_argument("--log-prob-output", type=str, default=None,
                   help="write the [n] log q here (needs --with-log-prob)")
    add_model_args(p)
    add_config_args(p)
    return p


def build_from_args(args: argparse.Namespace, device):
    cnf = build_cnf(
        n_frames=args.n_nodes, dim=args.dim, sigma_min=args.sigma_min,
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
    elif args.checkpoint:
        try:
            params = restore_serving_params(args.checkpoint, cnf.field.state_dict(), ema=args.ema)
        except ValueError as e:
            raise SystemExit(str(e))
        cnf.field.load_state_dict(params)
    return cnf


def sync(device) -> None:
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
    device = device_from_args(args, "ecnf_tpu_torch.sample")
    apply_config(parser, args, argv)
    cnf = build_from_args(args, device)
    cfg = solve_config(args, fused_trace=args.fused_trace)
    n, B = args.n_samples, min(args.batch_size, args.n_samples)
    features = node_features(args, B, device)
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
            sync(device)
            first_seconds = time.perf_counter() - start
    sync(device)
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
