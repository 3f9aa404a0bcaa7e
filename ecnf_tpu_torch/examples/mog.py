"""2-D mixture-of-Gaussians CNF, the smallest end-to-end example (port of
`examples/mog.py`).

A plain-MLP CNF (`VectorNet`, 3 layers of 512) on a diagonal Gaussian
base of scale 5 learns the 8-component `MoGTarget` from 10,000 samples:
AdamW at 1e-4 without a schedule, batch 64, and evaluations of the exact
test log-likelihood, the KL to the target and the Hutchinson estimate of
the log-likelihood on 256 test points, at `SolveConfig()` (adaptive
Dopri5).  Each evaluation draws two figures (SVG, `utils.figure`): 512
flow samples against 512 training points, and the field at t = 0.5 and
0.01 on a 10 x 10 grid over [-8, 8]^2 as arrows over the training points;
they are written under ``save_dir/plots`` when a ``save_dir`` is given.

Usage:
    python -m ecnf_tpu_torch.examples.mog [--device cuda|cpu]
"""
import argparse
import itertools
from typing import List, Optional, Sequence, Tuple

import torch

from ecnf_tpu_torch.cnf.build import build_mlp_cnf, resolve_device
from ecnf_tpu_torch.cnf.core import FlowMatchingCNF
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob, sample_cnf
from ecnf_tpu_torch.examples.common import device_from_arg
from ecnf_tpu_torch.targets.mog import MoGTarget
from ecnf_tpu_torch.training.loggers import ListLogger
from ecnf_tpu_torch.training.loop import TrainConfig, run_training
from ecnf_tpu_torch.training.optim import build_optimizer
from ecnf_tpu_torch.training.setup import epoch, init_state_from, plot_path
from ecnf_tpu_torch.training.state import TrainingState, make_update_fn
from ecnf_tpu_torch.utils.figure import Figure
from ecnf_tpu_torch.utils.plotting import jax_linspace

Tensor = torch.Tensor

N_PLOT = 512
GRID_BOUND, GRID_POINTS = 8.0, 10
FIELD_TIMES = (0.5, 0.01)


def grid_points(device=None) -> Tensor:
    """The ``[100, 2]`` points of the 10 x 10 grid over [-8, 8]^2, the
    second coordinate fastest (`itertools.product`, as the JAX example)."""
    axis = jax_linspace(torch.tensor(-GRID_BOUND), torch.tensor(GRID_BOUND), GRID_POINTS).tolist()
    return torch.tensor(list(itertools.product(axis, axis)), dtype=torch.float32, device=device)


@torch.no_grad()
def field_on_grid(cnf: FlowMatchingCNF, t: float, device=None) -> Tuple[Tensor, Tensor]:
    """``(points [100, 2], cnf's field at (points, t) [100, 2])``."""
    pts = grid_points(device)
    return pts, cnf.apply(pts, torch.full((pts.shape[0],), t, device=device), None)


@torch.no_grad()
def mog_figures(cnf: FlowMatchingCNF, train_data: Tensor, generator: torch.Generator,
                solve_cfg: SolveConfig) -> List[Figure]:
    """Figure 0: `N_PLOT` flow samples (base samples from ``generator``)
    and the first `N_PLOT` training points; figure 1: the field at each of
    `FIELD_TIMES` on the grid, over the training points."""
    flow_samples = sample_cnf(cnf, N_PLOT, cfg=solve_cfg, generator=generator)
    train = train_data[:N_PLOT]
    fig1 = Figure()
    ax = fig1.axes[0]
    ax.scatter(flow_samples[:, 0], flow_samples[:, 1], label="flow samples", alpha=0.4)
    ax.scatter(train[:, 0], train[:, 1], label="target samples", alpha=0.4)
    ax.legend()

    fig2 = Figure(1, 2, figsize=(10, 5))
    for ax, t_val in zip(fig2.axes, FIELD_TIMES):
        pts, vec = field_on_grid(cnf, t_val, train_data.device)
        ax.quiver(pts[:, 0], pts[:, 1], vec[:, 0], vec[:, 1])
        ax.set_title(f"model score at t={t_val}")
        ax.scatter(train[:, 0], train[:, 1], alpha=0.2)
    return [fig1, fig2]


def setup_mog_training(
    n_train: int = int(1e4),
    n_test: int = 256,
    n_iteration: int = 100,
    batch_size: int = 64,
    lr: float = 1e-4,
    n_eval: int = 5,
    features: Sequence[int] = (512, 512, 512),
    device=None,
    save_dir: Optional[str] = None,
) -> TrainConfig:
    """The MoG `TrainConfig`: train and test data drawn from a generator
    seeded 0 (train first), on ``device`` (the card unless another is
    named); an in-memory logger, no checkpoints; each evaluation's figures
    written under ``save_dir/plots`` when ``save_dir`` is given."""
    device = resolve_device(device)
    target = MoGTarget()
    data_generator = torch.Generator().manual_seed(0)
    train_data = target.sample((n_train,), data_generator, device=device)
    test_data = target.sample((n_test,), data_generator, device=device)

    cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=features, device=device)
    optimizer = build_optimizer(lr, use_schedule=False, optimizer_name="adamw")
    update_fn = make_update_fn(cnf, optimizer)
    solve_cfg = SolveConfig()

    def init_state(generator: torch.Generator) -> TrainingState:
        return init_state_from(cnf, optimizer, generator, device)

    def run_epoch(state: TrainingState):
        state, infos = epoch(state, update_fn, train_data, None, batch_size)
        return state, {k: v.cpu() for k, v in infos.items()}

    def eval_and_plot(state: TrainingState, generator: torch.Generator, iteration_n: int,
                      save: bool, plots_dir: Optional[str]) -> dict:
        """Exact and Hutchinson (probes from ``generator``) test
        log-likelihoods and the KL to the target, then the figures."""
        cnf.field.load_state_dict(state.params)
        log_prob, _, _ = get_log_prob(cnf, test_data, cfg=solve_cfg)
        info = {
            "test_log_lik": float(log_prob.mean()),
            "test_kl": float((target.log_prob(test_data) - log_prob).mean()),
        }
        log_prob_approx, _, _ = get_log_prob(cnf, test_data, approx=True, cfg=solve_cfg,
                                             generator=generator)
        info["test_approx_log_lik"] = float(log_prob_approx.mean())
        for j, figure in enumerate(mog_figures(cnf, train_data, generator, solve_cfg)):
            if save and plots_dir is not None:
                figure.savefig(plot_path(plots_dir, j, iteration_n))
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
        save=save_dir is not None,
        save_dir=save_dir or ".",
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
