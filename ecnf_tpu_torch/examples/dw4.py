"""DW4 experiment: 4 particles in a double well (port of `examples/dw4.py`).

Usage:
    python -m ecnf_tpu_torch.examples.dw4 [--config PATH] [--local] \
        [--device cuda|cpu] [key=value ...]
"""
from functools import partial
from typing import Optional, Sequence, Tuple

from ecnf_tpu_torch.examples.common import device_from_arg, load_experiment_config, parse_args
from ecnf_tpu_torch.targets.data import FullGraphSample, load_dw4
from ecnf_tpu_torch.targets.energies import double_well_log_prob
from ecnf_tpu_torch.training.loop import run_training
from ecnf_tpu_torch.training.setup import setup_training

# The reference's DW4 `local` block also widens the base.
LOCAL_EXTRA = ("flow.base_scale=2.0",)


def load_dataset(
    train_set_size: int, valid_set_size: Optional[int], final_run: bool, path=None, device=None
) -> Tuple[FullGraphSample, FullGraphSample]:
    """Train and test sets (the validation set unless ``final_run``)."""
    train, valid, test = load_dw4(train_set_size, path=path, device=device)
    if not final_run:
        return train, valid[:valid_set_size]
    return train, test[:valid_set_size]


def run(cfg, device=None, data_dir=None):
    """Train and evaluate on DW4 from the data in ``data_dir`` (default: the
    repo's ``data/``); returns ``(logger, state)``."""
    train_config = setup_training(
        cfg,
        load_dataset=partial(load_dataset, final_run=cfg.training.final_run, path=data_dir,
                             device=device),
        target_log_prob_fn=double_well_log_prob,
        device=device,
    )
    return run_training(train_config)


def main(argv: Optional[Sequence[str]] = None):
    config_path, local, device, overrides = parse_args("dw4.yaml", argv)
    device = device_from_arg(device, "ecnf_tpu_torch.examples.dw4")
    return run(load_experiment_config(config_path, local, overrides, local_extra=LOCAL_EXTRA),
               device=device)


if __name__ == "__main__":
    main()
