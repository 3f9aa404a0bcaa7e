"""QM9 positional experiment: 19-atom molecules, no energy (port of
`examples/qm9.py`).

Usage:
    python -m ecnf_tpu_torch.examples.qm9 [--config PATH] [--local] \
        [--device cuda|cpu] [key=value ...]

The data are ``data/qm9pos_*.npy`` (made from the GDB9 download by
`targets/qm9.py` when missing).  Seeded stand-ins
(``python -m ecnf_tpu_torch.targets.synthetic_qm9 DIR``) are served only
with ``ECNF_ALLOW_SYNTHETIC_QM9=1`` (or ``run(..., allow_synthetic=True)``).
"""
from functools import partial
from typing import Optional, Sequence, Tuple

from ecnf_tpu_torch.examples.common import device_from_arg, load_experiment_config, parse_args
from ecnf_tpu_torch.targets.data import FullGraphSample, load_qm9
from ecnf_tpu_torch.training.loop import run_training
from ecnf_tpu_torch.training.setup import setup_training


def load_dataset(
    train_set_size: Optional[int], valid_set_size: Optional[int], final_run: bool, path=None,
    device=None, allow_synthetic: bool = False,
) -> Tuple[FullGraphSample, FullGraphSample]:
    """Train and test sets (the validation set unless ``final_run``)."""
    train, valid, test = load_qm9(train_set_size, path=path, allow_synthetic=allow_synthetic,
                                  device=device)
    if not final_run:
        return train, valid[:valid_set_size]
    return train, test[:valid_set_size]


def run(cfg, device=None, data_dir=None, allow_synthetic: bool = False):
    """Train and evaluate on QM9 from the data in ``data_dir`` (default: the
    repo's ``data/``); returns ``(logger, state)``."""
    train_config = setup_training(
        cfg,
        load_dataset=partial(load_dataset, final_run=cfg.training.final_run, path=data_dir,
                             device=device, allow_synthetic=allow_synthetic),
        device=device,
    )
    return run_training(train_config)


def main(argv: Optional[Sequence[str]] = None):
    config_path, local, device, overrides = parse_args("qm9.yaml", argv)
    device = device_from_arg(device, "ecnf_tpu_torch.examples.qm9")
    return run(load_experiment_config(config_path, local, overrides), device=device)


if __name__ == "__main__":
    main()
