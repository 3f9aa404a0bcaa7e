"""LJ13 experiment: 13 Lennard-Jones particles (port of `examples/lj13.py`).

Usage:
    python -m ecnf_tpu_torch.examples.lj13 [--config PATH] [--local] \
        [--device cuda|cpu] [key=value ...]
"""
from functools import partial
from typing import Optional, Sequence, Tuple

from ecnf_tpu_torch.examples.common import device_from_arg, load_experiment_config, parse_args
from ecnf_tpu_torch.targets.data import FullGraphSample, load_lj13
from ecnf_tpu_torch.targets.energies import lennard_jones_log_prob
from ecnf_tpu_torch.training.loop import run_training
from ecnf_tpu_torch.training.setup import setup_training


def load_dataset(
    train_set_size: int, valid_set_size: Optional[int], final_run: bool, path=None, device=None
) -> Tuple[FullGraphSample, FullGraphSample]:
    """Train and test sets (the validation set unless ``final_run``)."""
    train, valid, test = load_lj13(train_set_size, path=path, device=device)
    if not final_run:
        return train, valid[:valid_set_size]
    return train, test[:valid_set_size]


def run(cfg, device=None, data_dir=None):
    """Train and evaluate on LJ13 from the data in ``data_dir`` (default:
    the repo's ``data/``); returns ``(logger, state)``."""
    train_config = setup_training(
        cfg,
        load_dataset=partial(load_dataset, final_run=cfg.training.final_run, path=data_dir,
                             device=device),
        target_log_prob_fn=lennard_jones_log_prob,
        device=device,
    )
    return run_training(train_config)


def main(argv: Optional[Sequence[str]] = None):
    config_path, local, device, overrides = parse_args("lj13.yaml", argv)
    device = device_from_arg(device, "ecnf_tpu_torch.examples.lj13")
    return run(load_experiment_config(config_path, local, overrides), device=device)


if __name__ == "__main__":
    main()
