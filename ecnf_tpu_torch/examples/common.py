"""Shared command-line plumbing of the experiment entry points (port of
`examples/common.py`).

``--config`` defaults to the repo's ``examples/configs/<name>.yaml`` (data
files shared with the JAX examples, read here and never changed);
``--local`` applies the debug-scale block below, and ``key=value``
arguments override any field.  ``--device`` picks the torch device: the
card unless the CPU is asked for, and without a card the card is refused,
never replaced.  Under a launcher (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID`` set, one process per card) the process
joins its group in `parse_args`, before any CUDA work
(`parallel.distributed.maybe_initialize_distributed`), and the program
trains data-parallel over it.
"""
import argparse
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from ecnf_tpu_torch.parallel.distributed import maybe_initialize_distributed
from ecnf_tpu_torch.training.config import ExperimentConfig, load_config

CONFIG_DIR = Path(__file__).resolve().parent.parent.parent / "examples" / "configs"

# Debug-scale settings of the reference examples' ``local`` blocks, applied
# before the command line's overrides so that explicit ``key=value``
# arguments win.
LOCAL_OVERRIDES = (
    "logger={list_logger: null}",
    "training.save=false",
    "training.batch_size=8",
    "training.eval_batch_size=9",
    "training.n_training_iter=10",
    "training.train_set_size=80",
    "training.test_set_size=80",
    "training.plot_batch_size=16",
    "flow.network.mlp_units=[16]",
    "flow.network.n_blocks_egnn=2",
    "flow.network.n_invariant_feat_hidden=8",
    "flow.network.time_embedding_dim=6",
)


def parse_args(
    default_config: str, argv: Optional[Sequence[str]] = None
) -> Tuple[str, bool, str, list]:
    """``(config path, --local, device, overrides)`` of the command line,
    after joining the launcher's process group, if any."""
    maybe_initialize_distributed()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=str(CONFIG_DIR / default_config))
    parser.add_argument("--local", action="store_true",
                        help="debug-scale override block (the reference examples' `local` flag)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU only when asked for (--device cpu)")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides, e.g. training.batch_size=8")
    args = parser.parse_args(argv)
    return args.config, args.local, args.device, args.overrides


def device_from_arg(device: str, program: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{program}: no CUDA device; pass --device cpu to run on the CPU")
    return device


def load_experiment_config(
    config_path: str,
    local: bool,
    overrides: Sequence[str],
    local_extra: Sequence[str] = (),
) -> ExperimentConfig:
    """A config with the debug-scale overrides (``--local``, plus the
    target's own ``local_extra``) below the command line's."""
    all_overrides = ((list(LOCAL_OVERRIDES) + list(local_extra)) if local else []) + list(overrides)
    return load_config(config_path, overrides=all_overrides)
