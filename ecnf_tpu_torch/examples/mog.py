"""2-D mixture-of-Gaussians CNF, the smallest end-to-end example (port of
`examples/mog.py`).

A plain-MLP CNF (`VectorNet`, 3 layers of 512) on a diagonal Gaussian
base of scale 5 learns the 8-component `MoGTarget` from 10,000 samples:
AdamW at 1e-4 without a schedule, batch 64, and evaluations of the exact
test log-likelihood, the KL to the target and the Hutchinson estimate of
the log-likelihood on 256 test points, at `SolveConfig()` (adaptive
Dopri5).  Plots are not ported yet.

Usage:
    python -m ecnf_tpu_torch.examples.mog [--device cuda|cpu]
"""
import argparse
from typing import Optional, Sequence

import torch

from ecnf_tpu_torch.cnf.build import build_mlp_cnf, resolve_device
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob
from ecnf_tpu_torch.examples.common import device_from_arg
from ecnf_tpu_torch.targets.mog import MoGTarget
from ecnf_tpu_torch.training.loggers import ListLogger
from ecnf_tpu_torch.training.loop import TrainConfig, run_training
from ecnf_tpu_torch.training.optim import build_optimizer
from ecnf_tpu_torch.training.setup import epoch, init_state_from
from ecnf_tpu_torch.training.state import TrainingState, make_update_fn


def setup_mog_training(
    n_train: int = int(1e4),
    n_test: int = 256,
    n_iteration: int = 100,
    batch_size: int = 64,
    lr: float = 1e-4,
    n_eval: int = 5,
    features: Sequence[int] = (512, 512, 512),
    device=None,
) -> TrainConfig:
    """The MoG `TrainConfig`: train and test data drawn from a generator
    seeded 0 (train first), on ``device`` (the card unless another is
    named); an in-memory logger, no checkpoints."""
    device = resolve_device(device)
    target = MoGTarget()
    data_generator = torch.Generator().manual_seed(0)
    train_data = target.sample((n_train,), data_generator, device=device)
    test_data = target.sample((n_test,), data_generator, device=device)

    cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=features, device=device)
    optimizer = build_optimizer(lr, use_schedule=False, optimizer_name="adamw")
    update_fn = make_update_fn(cnf, optimizer)
    solve_cfg = SolveConfig()
    print("mog: plots are not ported to ecnf_tpu_torch yet; evaluations run without them")

    def init_state(generator: torch.Generator) -> TrainingState:
        return init_state_from(cnf, optimizer, generator, device)

    def run_epoch(state: TrainingState):
        state, infos = epoch(state, update_fn, train_data, None, batch_size)
        return state, {k: v.cpu() for k, v in infos.items()}

    def eval_and_plot(state: TrainingState, generator: torch.Generator, iteration_n: int,
                      save: bool, plots_dir: Optional[str]) -> dict:
        """Exact and Hutchinson (probes from ``generator``) test
        log-likelihoods and the KL to the target, without plots."""
        cnf.field.load_state_dict(state.params)
        log_prob, _, _ = get_log_prob(cnf, test_data, cfg=solve_cfg)
        info = {
            "test_log_lik": float(log_prob.mean()),
            "test_kl": float((target.log_prob(test_data) - log_prob).mean()),
        }
        log_prob_approx, _, _ = get_log_prob(cnf, test_data, approx=True, cfg=solve_cfg,
                                             generator=generator)
        info["test_approx_log_lik"] = float(log_prob_approx.mean())
        return info

    return TrainConfig(
        n_iteration=n_iteration,
        logger=ListLogger(),
        seed=0,
        n_checkpoints=0,
        n_eval=n_eval,
        init_state=init_state,
        update_state=run_epoch,
        eval_and_plot_fn=eval_and_plot,
        save=False,
    )


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU only when asked for (--device cpu)")
    args = parser.parse_args(argv)
    device = device_from_arg(args.device, "ecnf_tpu_torch.examples.mog")
    return run_training(setup_mog_training(device=device))


if __name__ == "__main__":
    main()
