"""Generic training loop with evaluation and checkpoint schedules, resume
and a runtime limit (port of `ecnf_tpu/training/loop.py`).

As in the JAX package: linspace schedules ending at the last iteration,
an evaluation at iteration -1 before training (when starting at 0), each
epoch's per-batch info written to the logger one row per batch, resume
from the latest ``state_`` checkpoint at its iteration + 1, and a stop
when the time extrapolated to the next checkpoint passes the runtime
limit.  One generator, seeded from ``seed``, feeds ``init_state`` and then
each evaluation in turn (the JAX key is split in the same order).  At the
end it prints the seconds the epochs and the evaluations took (host clock;
each returns values on the host, which waits for the device).  The
JAX options that trace with a profiler or switch to 64-bit are not
ported; the one that groups epochs into one dispatch has nothing to group
in eager PyTorch (`setup_training` ignores it).
"""
import os
import pathlib
import time
from time import perf_counter
from typing import Any, Callable, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from ecnf_tpu_torch.training.checkpoints import (
    get_latest_checkpoint,
    parse_checkpoint_iteration,
    restore_checkpoint,
    save_checkpoint,
)
from ecnf_tpu_torch.training.loggers import Logger, WandbLogger

TrainingStateT = Any
InitStateFn = Callable[[torch.Generator], TrainingStateT]
UpdateStateFn = Callable[[TrainingStateT], Tuple[TrainingStateT, dict]]


class EvalAndPlotFn(Protocol):
    def __call__(
        self,
        state: TrainingStateT,
        generator: torch.Generator,
        iteration_n: int,
        save: bool,
        plots_dir: Optional[str],
    ) -> dict: ...


class TrainConfig(NamedTuple):
    """Everything `run_training` needs."""

    n_iteration: int
    logger: Logger
    seed: int
    n_checkpoints: int
    n_eval: int
    init_state: InitStateFn
    update_state: UpdateStateFn
    eval_and_plot_fn: Optional[EvalAndPlotFn]
    save: bool = True
    save_dir: str = "runs"
    resume: bool = False
    runtime_limit: Optional[float] = None  # hours


def _schedule(n_iteration: int, n_points: int) -> np.ndarray:
    """Evenly spaced iteration indices ending at the final iteration."""
    return np.flip(np.linspace(n_iteration - 1, 0, n_points, dtype="int", endpoint=False))


def _write_epoch_info(logger: Logger, info: dict, iteration_n: int) -> None:
    """One row per minibatch of an epoch's stacked info, its keys sorted as
    a JAX tree's (one row if the info holds scalars)."""
    keys = sorted(info)
    shape = tuple(np.shape(info[keys[0]]))[:1] if keys else ()
    if len(shape) == 0 or shape == (1,):
        logger.write(dict(info, iteration=iteration_n))
        return
    for b in range(shape[0]):
        logger.write(dict({k: info[k][b] for k in keys}, iteration=iteration_n))


def run_training(config: TrainConfig) -> Tuple[Logger, TrainingStateT]:
    """Train, evaluate and checkpoint on the schedules; returns the logger
    (closed) and the last state."""
    start_time = time.time()

    plots_dir = checkpoints_dir = None
    if config.save:
        pathlib.Path(config.save_dir).mkdir(exist_ok=True, parents=True)
        plots_dir = os.path.join(config.save_dir, "plots")
        pathlib.Path(plots_dir).mkdir(exist_ok=True)
        checkpoints_dir = os.path.join(config.save_dir, "model_checkpoints")
        pathlib.Path(checkpoints_dir).mkdir(exist_ok=True)

    checkpoint_iter_np = _schedule(config.n_iteration, config.n_checkpoints)
    checkpoint_iter = set(checkpoint_iter_np.tolist())
    eval_iter = set(_schedule(config.n_iteration, config.n_eval).tolist())

    generator = torch.Generator().manual_seed(config.seed)
    state = config.init_state(generator)

    start_iter = 0
    if config.resume and checkpoints_dir is not None:
        latest = get_latest_checkpoint(checkpoints_dir, key="state_")
        if latest:
            start_iter = parse_checkpoint_iteration(latest) + 1
            state = restore_checkpoint(latest, state)
            print(f"loaded checkpoint {latest}")
        else:
            print("no checkpoint found, starting training from scratch")

    epoch_s, eval_s = [], []
    if start_iter == 0 and config.eval_and_plot_fn is not None:
        t0 = perf_counter()
        eval_info = config.eval_and_plot_fn(state, generator, -1, config.save, plots_dir)
        eval_s.append(perf_counter() - t0)
        eval_info.update(iteration=-1)
        config.logger.write(eval_info)
        print(f"initial model eval complete, eval info: \n {eval_info}")

    for iteration in range(start_iter, config.n_iteration):
        t0 = perf_counter()
        state, info = config.update_state(state)
        epoch_s.append(perf_counter() - t0)
        _write_epoch_info(config.logger, info, iteration)

        if config.eval_and_plot_fn is not None and iteration in eval_iter:
            t0 = perf_counter()
            eval_info = config.eval_and_plot_fn(state, generator, iteration, config.save, plots_dir)
            eval_s.append(perf_counter() - t0)
            eval_info.update(iteration=iteration)
            print(str(eval_info))
            config.logger.write(eval_info)

        if iteration in checkpoint_iter and config.save:
            save_checkpoint(checkpoints_dir, iteration, state)
            # Stop when the time extrapolated to the next checkpoint passes
            # the limit.
            later = checkpoint_iter_np[checkpoint_iter_np > iteration]
            if config.runtime_limit and iteration > start_iter and later.size:
                hours = (time.time() - start_time) / 3600
                done = max(iteration - start_iter, 1)
                if hours * (np.min(later) - start_iter) / done > config.runtime_limit:
                    break

    if epoch_s:
        print(f"run_training: {len(epoch_s)} epochs in {sum(epoch_s):.1f} s "
              f"({1e3 * sum(epoch_s) / len(epoch_s):.1f} ms each, the first "
              f"{1e3 * epoch_s[0]:.1f}); {len(eval_s)} evaluations in "
              f"{sum(eval_s):.1f} s ({', '.join(f'{v:.2f}' for v in eval_s)}); "
              f"{time.time() - start_time:.1f} s since the start")

    # The JAX loop renders `plot_history` of a `ListLogger`'s history here
    # and discards the figure; nothing is written, so the port has the
    # function (`utils.plotting.plot_history`) and not the call.

    # Upload checkpoints and plots with a live wandb run.
    if isinstance(config.logger, WandbLogger) and config.save and config.logger._wandb:
        wandb = config.logger._wandb
        for directory in (checkpoints_dir, plots_dir):
            wandb.save(str(pathlib.Path(directory)) + "/*", base_path=config.save_dir, policy="now")

    config.logger.close()
    return config.logger, state
