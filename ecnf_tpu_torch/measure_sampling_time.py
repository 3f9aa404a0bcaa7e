"""Time QM9 sampling from the QM9 program's checkpoints (port of
`examples/measure_sampling_time.py`).

Builds the CNF of the network of `examples/configs/qm9.yaml` (with dotted
``key=value`` overrides) in float32, as the JAX script does, restores the parameters (not the EMA) of
the newest ``state_%08i`` under ``--checkpoint-dir`` (or says that there is
none and times the initial model), and draws ``--batch-size`` samples with
`sample_cnf` at `SolveConfig()` (adaptive Dopri5), ``--reps`` + 1 times.
The first call, which carries CUDA's start-up, is reported apart from the
best of the ``--reps`` that follow.  On the card each call is timed with
CUDA events; with ``--device cpu`` with the host clock.

``--wandb-project P`` first downloads the checkpoints of the newest run of
``P`` tagged qm9 and flow_matching; it needs the ``wandb`` package.

Usage:
    python -m ecnf_tpu_torch.measure_sampling_time \
        [--checkpoint-dir runs/qm9/model_checkpoints] [--batch-size 128] \
        [--reps 10] [--device cuda|cpu] \
        [--wandb-project P] [key=value ...]
"""
import argparse
import time
from typing import Optional, Sequence

import torch

from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_cnf
from ecnf_tpu_torch.examples.common import CONFIG_DIR, device_from_arg, load_experiment_config
from ecnf_tpu_torch.sample import positive_int
from ecnf_tpu_torch.training.checkpoints import get_latest_checkpoint, restore_serving_params

N_NODES, DIM = 19, 3


def fetch_wandb_checkpoints(project: str) -> str:
    """Download the checkpoints of ``project``'s newest run tagged qm9 and
    flow_matching; returns their directory."""
    import wandb

    runs = [r for r in wandb.Api().runs(project) if {"qm9", "flow_matching"} <= set(r.tags)]
    if not runs:
        raise SystemExit("no matching wandb runs (tags qm9 + flow_matching)")
    run = sorted(runs, key=lambda r: r.created_at)[-1]
    dest = f"wandb_ckpt_{run.id}"
    for f in run.files():
        if "model_checkpoints" in f.name:
            f.download(root=dest, exist_ok=True)
    print(f"downloaded checkpoints from wandb run {run.id} -> {dest}/model_checkpoints")
    return f"{dest}/model_checkpoints"


def _timed_call(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events on a card, else the host
    clock."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the served ``params``, the ``checkpoint`` path (or None), the
    ``first_s`` and ``rep_s`` seconds, and the ``samples`` of the last call."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint-dir", type=str, default="runs/qm9/model_checkpoints")
    parser.add_argument("--batch-size", type=positive_int, default=128)
    parser.add_argument("--reps", type=positive_int, default=10)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU only when asked for (--device cpu)")
    parser.add_argument("--wandb-project", type=str, default=None,
                        help="fetch the newest qm9/flow_matching run's checkpoints from wandb "
                             "(needs the wandb package)")
    parser.add_argument("overrides", nargs="*", help="dotted config overrides of the network")
    args = parser.parse_args(argv)
    device = device_from_arg(args.device, "ecnf_tpu_torch.measure_sampling_time")
    if args.wandb_project is not None:
        args.checkpoint_dir = fetch_wandb_checkpoints(args.wandb_project)

    cfg = load_experiment_config(str(CONFIG_DIR / "qm9.yaml"), False, args.overrides)
    net = cfg.flow.network
    cnf = build_cnf(
        n_frames=N_NODES, dim=DIM, sigma_min=cfg.flow.sigma_min, base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net.n_blocks_egnn, mlp_units=net.mlp_units,
        n_invariant_feat_hidden=net.n_invariant_feat_hidden,
        time_embedding_dim=net.time_embedding_dim, n_features=1, device=device,
        generator=torch.Generator().manual_seed(0),
    )
    latest = get_latest_checkpoint(args.checkpoint_dir)
    if latest is not None:
        print(f"restoring {latest}")
        cnf.field.load_state_dict(restore_serving_params(latest, cnf.field.state_dict()))
    else:
        print(f"no checkpoint found under {args.checkpoint_dir}; timing the initial model")

    feats = torch.zeros((args.batch_size, N_NODES), dtype=torch.int64, device=device)
    generator = torch.Generator(device=device).manual_seed(1)
    cfg_solve = SolveConfig()
    out = {}

    def draw():
        out["samples"] = sample_cnf(cnf, args.batch_size, feats, cfg_solve, generator)

    clock = "CUDA events" if device.type == "cuda" else "host clock"
    first = _timed_call(draw, device)
    print(f"first call: {first:.3f} s ({clock})")
    reps = [_timed_call(draw, device) for _ in range(args.reps)]
    best = min(reps)
    print(f"best of {args.reps}: {best * 1e3:.1f} ms for {args.batch_size} samples -> "
          f"{args.batch_size / best:.1f} samples/s ({clock}, {device})")
    params = {k: v.detach() for k, v in cnf.field.state_dict().items()}
    return dict(params=params, checkpoint=latest, first_s=first, rep_s=reps,
                samples=out["samples"])


if __name__ == "__main__":
    main()
