"""Score configurations under the EGNN flow: batched log-densities.

The PyTorch counterpart of `examples/score.py`: reads an ``[n, N, D]``
``.npy`` of configurations, removes each one's centre of mass as training
does, and writes the ``[n]`` log p(x) from the reverse solve t: 1 -> 0,
exact trace or Hutchinson (``--approx``).  The model is named as in
`ecnf_tpu_torch.sample`: ``--checkpoint-dir`` (the latest ``state_%08i``
of either package, ``--ema`` for its EMA parameters) with ``--config`` and
``key=value`` overrides naming the network and the solve, as the
reference's `examples/score.py`; or, without a config, ``--params-npz``
(flax parameters exported from the JAX package, see
`ecnf_tpu_torch.convert`) or the seeded init, with `sample`'s network
flags and a solve that is adaptive Dopri5 at the JAX package's defaults
(rtol = atol = 1e-5) unless ``--method`` asks for fixed steps.  The last
batch is zero-padded and the padding dropped.  The first batch, which
carries CUDA's start-up and the kernels' builds, is timed apart from the
steady rate.  Under a launcher the batches are shared by the processes as
in `ecnf_tpu_torch.sample` (the batch rounded up to a multiple of them,
probes drawn for the whole batch, rank 0 printing and writing).

Usage:
    python -m ecnf_tpu_torch.score --config examples/configs/lj13.yaml \
        --checkpoint-dir runs/lj13/model_checkpoints --data configs.npy \
        [--ema] [--output log_p.npy] [--approx] [key=value ...]
    python -m ecnf_tpu_torch.score --data configs.npy --params-npz params.npz \
        [--output log_p.npy] [--batch-size 256] [--approx] \
        [--method {adaptive,rk4,dopri5}] [--features {zeros,arange}]
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ecnf_tpu_torch.cnf.sampling import get_log_prob
from ecnf_tpu_torch.parallel.distributed import (
    is_main_process,
    maybe_initialize_distributed,
    print_main,
)
from ecnf_tpu_torch.parallel.mesh import axis_size, get_mesh, pad_to_multiple
from ecnf_tpu_torch.sample import (
    add_config_args,
    add_model_args,
    add_solve_args,
    apply_config,
    build_from_args,
    device_from_args,
    node_features,
    positive_int,
    solve_config,
    sync,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=str, required=True, help=".npy of [n, n_nodes, dim] positions")
    p.add_argument("--output", type=str, default=None, help="write the [n] log-probs here")
    p.add_argument("--batch-size", type=positive_int, default=256)
    add_solve_args(p, default_method="adaptive")
    add_model_args(p)
    add_config_args(p)
    return p


def load_positions(path: str) -> np.ndarray:
    """``[n, N, D]`` float32 positions with each configuration's centre of
    mass removed; a flat ``[n, N*D]`` file is refused as ambiguous."""
    raw = np.load(path)
    if raw.ndim == 2:
        raise SystemExit("pass data as [n, n_nodes, dim]; flat layout is ambiguous")
    if raw.ndim != 3:
        raise SystemExit(f"expected rank-3 data, got shape {raw.shape}")
    pos = raw.astype(np.float32)
    return pos - pos.mean(axis=1, keepdims=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Score the file; returns ``log_p [n]``, ``seconds`` in all,
    ``first_batch_seconds``, ``steady_per_second`` (configurations per
    second after the first batch, None for a single batch) and ``device``
    besides printing a summary (rank 0 only, which alone writes the file)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    maybe_initialize_distributed()
    device = device_from_args(args, "ecnf_tpu_torch.score")
    apply_config(parser, args, argv)
    pos = load_positions(args.data)
    n, args.n_nodes, args.dim = pos.shape
    x = torch.from_numpy(pos.reshape(n, -1))
    cnf = build_from_args(args, device)
    cfg = solve_config(args)
    mesh = get_mesh()
    n_ranks = axis_size(mesh)
    B = pad_to_multiple(min(args.batch_size, n), n_ranks)
    features = node_features(args, B, device)
    # Probes are drawn on the CPU so one seed gives the same draws on every device.
    generator = torch.Generator().manual_seed(args.seed)

    out = np.empty((n,), np.float32)
    start = time.perf_counter()
    first_seconds = 0.0
    for lo in range(0, n, B):
        chunk = x[lo : lo + B]
        take = chunk.shape[0]
        if take < B:
            chunk = torch.cat([chunk, torch.zeros((B - take, chunk.shape[1]))])
        log_p = get_log_prob(
            cnf, chunk.to(device), features, approx=args.approx, cfg=cfg, generator=generator,
            mesh=mesh,
        )[0]
        out[lo : lo + take] = log_p[:take].cpu().numpy()
        if lo == 0:
            sync(device)
            first_seconds = time.perf_counter() - start
    sync(device)
    seconds = time.perf_counter() - start
    steady = (n - B) / (seconds - first_seconds) if n > B else None

    kind = "Hutchinson" if args.approx else "exact"
    print_main(
        f"scored {n} configurations in {seconds:.2f}s ({n / seconds:.1f}/s, "
        f"{n_ranks} device(s), {kind} trace): mean log-prob {out.mean():.4f}"
    )
    rate = f"steady {steady:.1f}/s over the other {n - B}" if steady is not None else "single batch"
    print_main(f"on {device}: first batch of {B} {first_seconds:.2f}s, {rate} ({args.method}, "
               f"{args.dtype})")
    bad = int((~np.isfinite(out)).sum())
    if bad:
        print_main(f"WARNING: {bad}/{n} log-probs are non-finite")
    if args.output and is_main_process():
        np.save(args.output, out)
        print(f"wrote {args.output}")
    return {
        "log_p": out, "seconds": seconds, "first_batch_seconds": first_seconds,
        "steady_per_second": steady, "device": str(device),
    }


if __name__ == "__main__":
    main()
