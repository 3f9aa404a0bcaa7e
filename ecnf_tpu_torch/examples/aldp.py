"""Alanine dipeptide (ALDP): 22 atoms, node features the atom index, no
tractable energy, so evaluations are the test NLL and the pairwise-distance
histogram (port of `examples/aldp.py`).

Usage:
    python -m ecnf_tpu_torch.examples.aldp [--config PATH] [--local] \
        [--device cuda|cpu] [key=value ...]

The trajectories are mdtraj HDF5 files (``target.*_path``, relative to the
working directory), read by the port's own reader (`targets/h5.py`).
``target.valid_skip`` / ``target.test_skip`` drop leading frames of the
validation / test file, so that one file gives disjoint splits
(`examples/configs/aldp_soak.yaml`).
"""
from functools import partial
from typing import Optional, Sequence, Tuple

from ecnf_tpu_torch.examples.common import device_from_arg, load_experiment_config, parse_args
from ecnf_tpu_torch.targets.data import FullGraphSample, load_aldp
from ecnf_tpu_torch.training.loop import run_training
from ecnf_tpu_torch.training.setup import setup_training

# The reference's ALDP `local` block shrinks further than the shared one.
LOCAL_EXTRA = (
    "training.batch_size=2",
    "training.eval_batch_size=2",
    "training.train_set_size=8",
    "training.test_set_size=8",
    "flow.network.mlp_units=[4]",
    "flow.network.n_blocks_egnn=1",
)


def load_dataset(
    train_set_size: Optional[int],
    valid_set_size: Optional[int],
    final_run: bool,
    train_path: str,
    test_path: str,
    valid_path: str,
    valid_skip: int = 0,
    test_skip: int = 0,
    device=None,
) -> Tuple[FullGraphSample, FullGraphSample]:
    """Train and test sets (the validation set unless ``final_run``)."""
    train_data, valid_data, test_data = load_aldp(
        train_path=train_path, test_path=test_path, val_path=valid_path,
        train_n_points=train_set_size, val_skip_n=valid_skip, test_skip_n=test_skip,
        device=device,
    )
    if not final_run:
        return train_data, valid_data[:valid_set_size]
    return train_data, test_data[:valid_set_size]


def run(cfg, device=None):
    """Train and evaluate on ALDP; returns ``(logger, state)``."""
    t = cfg.target
    train_config = setup_training(
        cfg,
        load_dataset=partial(
            load_dataset, final_run=cfg.training.final_run, train_path=t.train_path,
            test_path=t.test_path, valid_path=t.valid_path, valid_skip=t.valid_skip,
            test_skip=t.test_skip, device=device,
        ),
        target_log_prob_fn=None,
        device=device,
    )
    return run_training(train_config)


def main(argv: Optional[Sequence[str]] = None):
    config_path, local, device, overrides = parse_args("aldp.yaml", argv)
    device = device_from_arg(device, "ecnf_tpu_torch.examples.aldp")
    return run(load_experiment_config(config_path, local, overrides, local_extra=LOCAL_EXTRA),
               device=device)


if __name__ == "__main__":
    main()
