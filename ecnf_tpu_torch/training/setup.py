"""Experiment set-up: config + data + CNF -> `TrainConfig` (port of
`ecnf_tpu/training/setup.py`): the epoch runner, the evaluation, the
default plotter, and `setup_training`, which joins them with the
optimizer, the logger and the data.

The JAX module builds its evaluation as closures over a config; here the
evaluation is plain functions of the CNF and the settings, and
`setup_training` closes over them.  The CNF is evaluated with the
parameters its field holds, so the caller chooses them (the EMA parameters
at the end of training).  Figures are SVG (`utils.figure`; the card has
no matplotlib).

With a mesh (`ecnf_tpu_torch.parallel`: one process per card, or per CPU
rank) every rank holds the same state and draws from the same generators;
an epoch splits each minibatch over the ranks, and an evaluation splits
each test batch and each batch of model samples, solves its rows and
gathers the results, so every rank sees the metrics of the whole batch.
Rank 0 alone logs, prints, draws the figures and writes files.  Without a
process group (a single process) there is no mesh and none of this runs.
"""
import copy
import os
import pathlib
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ecnf_tpu_torch.cnf.build import build_cnf, resolve_device
from ecnf_tpu_torch.cnf.core import FlowMatchingCNF
from ecnf_tpu_torch.cnf.sampling import (
    SolveConfig,
    get_log_prob,
    sample_and_log_prob_cnf,
    sample_cnf,
)
from ecnf_tpu_torch.ops.numerics import maybe_masked_mean
from ecnf_tpu_torch.parallel.distributed import is_main_process, print_main
from ecnf_tpu_torch.parallel.mesh import (
    axis_size,
    get_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from ecnf_tpu_torch.training.evaluation import (
    calculate_forward_ess,
    calculate_reverse_ess,
    eval_fn,
)
from ecnf_tpu_torch.training.config import ExperimentConfig, config_to_dict
from ecnf_tpu_torch.training.loggers import ListLogger, WandbLogger, setup_logger
from ecnf_tpu_torch.training.loop import TrainConfig
from ecnf_tpu_torch.training.optim import build_optimizer
from ecnf_tpu_torch.training.state import TrainingState, init_training_state, make_update_fn
from ecnf_tpu_torch.utils.figure import Figure
from ecnf_tpu_torch.utils.plotting import (
    bin_samples_by_dist,
    get_counts,
    get_pairwise_distances_for_plotting,
)

Tensor = torch.Tensor


def epoch(
    state: TrainingState,
    update: Callable[..., Tuple[TrainingState, Dict[str, Tensor]]],
    pos: Tensor,
    feats: Optional[Tensor],
    batch_size: int,
    perm: Optional[Tensor] = None,
    mesh=None,
) -> Tuple[TrainingState, Dict[str, Tensor]]:
    """One pass over ``pos [n, D]`` / ``feats [n, N]`` (or None, for a field
    without node features): permute, drop the remainder, and run ``update``
    on each minibatch in turn.

    The permutation is drawn from the state's generator unless ``perm``
    (a permutation of ``n``) is given.  With a ``mesh`` every rank draws
    the same permutation from its copy of the generator and passes
    ``update`` its rows of each minibatch (`parallel.shard_batch`).
    Returns the state and each info key's values stacked over the
    minibatches.
    """
    n = pos.shape[0]
    n_batches = n // batch_size
    if n_batches < 1:
        raise ValueError(f"{n} samples make no batch of {batch_size}")
    if perm is None:
        perm = torch.randperm(n, generator=state.generator, device=state.generator.device)
    perm = perm.to(pos.device)[: n_batches * batch_size]
    pos_b = pos[perm].reshape(n_batches, batch_size, -1)
    feat_b = [None] * n_batches if feats is None else feats[perm].reshape(n_batches, batch_size, -1)
    infos = []
    for xb, fb in zip(pos_b, feat_b):
        state, info = update(state, *shard_batch((xb, fb), mesh))
        infos.append(info)
    return state, {key: torch.stack([info[key] for info in infos]) for key in infos[0]}


def init_state_from(
    cnf: FlowMatchingCNF,
    optimizer,
    generator: torch.Generator,
    device,
    use_ema: bool = False,
    mesh=None,
) -> TrainingState:
    """A fresh training state: the field's parameters drawn on the CPU from
    ``generator`` (flax's initial distributions), then the seed of the
    state's own generator on ``device``, which the train steps draw from.
    With a ``mesh`` the state (parameters, optimizer moments, EMA and the
    generator's state) is rank 0's on every rank (`parallel.replicate`)."""
    fresh = copy.deepcopy(cnf.field).cpu()
    fresh.reset_parameters(generator)
    cnf.field.load_state_dict(fresh.state_dict())
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    state_generator = torch.Generator(device=device).manual_seed(seed)
    return replicate(init_training_state(cnf, optimizer, state_generator, use_ema=use_ema), mesh)


TargetLogProb = Callable[[Tensor], Tensor]  # [B, N, D] -> [B]


def _positions(x: Tensor, features: Tensor) -> Tensor:
    """Flat ``[B, N*D]`` points as ``[B, N, D]``, N from ``features [B, N]``."""
    return x.reshape(x.shape[0], features.shape[-1], -1)


def eval_data_batch(
    cnf: FlowMatchingCNF,
    data: Tuple[Tensor, Tensor],
    mask: Tensor,
    target_log_prob_fn: Optional[TargetLogProb] = None,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    eps: Optional[Tensor] = None,
    mesh=None,
) -> Tuple[Optional[Tensor], Dict[str, Tensor]]:
    """Score one test batch ``data = (pos [B, N*D], features [B, N])``.

    Returns the forward log weights ``log p - log q [B]`` (None without a
    target) and the masked means ``test_log_lik``, ``test_log_prob_base``,
    ``test_delta_log_lik`` over the entries of ``mask`` whose log q is
    finite (an ODE sample that diverged or ran out of steps scores NaN),
    with ``eval_ode_steps``, the solve's accepted steps.  The trace is
    exact, or Hutchinson with probes ``eps`` or drawn from ``generator``
    when ``exact_log_prob`` is False.  With a ``mesh`` the ranks share
    the batch (`get_log_prob`) and every rank returns the whole batch's
    results.
    """
    pos_b, feat_b = data
    log_q, log_prob_base, delta_log_lik, stats = get_log_prob(
        cnf, pos_b, feat_b, approx=not exact_log_prob, cfg=cfg,
        generator=generator, eps=eps, return_stats=True, mesh=mesh,
    )
    mask = mask * torch.isfinite(log_q).to(mask.dtype)
    info = {
        "test_log_lik": maybe_masked_mean(log_q, mask),
        "test_log_prob_base": maybe_masked_mean(log_prob_base, mask),
        "test_delta_log_lik": maybe_masked_mean(delta_log_lik, mask),
        "eval_ode_steps": torch.tensor(float(stats.num_steps), device=pos_b.device),
    }
    log_w = None
    if target_log_prob_fn is not None:
        log_w = target_log_prob_fn(_positions(pos_b, feat_b)) - log_q
    return log_w, info


def model_log_weights(
    cnf: FlowMatchingCNF,
    target_log_prob_fn: TargetLogProb,
    features: Tensor,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    eps: Optional[Tensor] = None,
    mesh=None,
) -> Tensor:
    """Reverse log weights ``log p - log q [B]`` of one batch of model
    samples, one per row of ``features [B, N]``.  With a ``mesh`` the
    batch is padded (repeating the last row of the features, and of an
    injected ``x0``) to a multiple of the ranks, the ranks share it
    (`sample_and_log_prob_cnf`) and the padding is dropped."""
    B = features.shape[0]
    padded = pad_to_multiple(B, axis_size(mesh))

    def pad(x):
        return x if x is None else torch.cat([x, x[-1:].expand(padded - B, -1)])

    features = pad(features)
    samples, log_q = sample_and_log_prob_cnf(
        cnf, padded, features, approx=not exact_log_prob, cfg=cfg,
        generator=generator, x0=pad(x0), eps=eps, mesh=mesh,
    )
    return (target_log_prob_fn(_positions(samples, features)) - log_q)[:B]


def reverse_ess(
    cnf: FlowMatchingCNF,
    target_log_prob_fn: TargetLogProb,
    features_row: Tensor,
    n_model_samples: int,
    batch_size: int,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None,
    mesh=None,
) -> Dict[str, Tensor]:
    """``rv_ess`` over ``max(n_model_samples // b, 1)`` batches of ``b =
    min(batch_size, n_model_samples)`` model samples, each with the node
    features ``features_row [N]`` (the first training row).  ``x0 [n_batches,
    b, D]`` injects the base samples.  With a ``mesh`` the ranks share each
    batch (`model_log_weights`) and every rank holds all the log weights."""
    b = min(batch_size, n_model_samples)
    n_batches = max(n_model_samples // b, 1)
    feats = features_row.reshape(1, -1).repeat(b, 1)
    log_w = torch.cat([
        model_log_weights(
            cnf, target_log_prob_fn, feats, exact_log_prob, cfg, generator,
            x0=None if x0 is None else x0[i], mesh=mesh,
        )
        for i in range(n_batches)
    ])
    return {"rv_ess": calculate_reverse_ess(log_w)}


def evaluate(
    cnf: FlowMatchingCNF,
    test_pos: Tensor,
    test_features: Tensor,
    features_row: Tensor,
    batch_size: int,
    target_log_prob_fn: Optional[TargetLogProb] = None,
    n_model_samples: Optional[int] = None,
    exact_log_prob: bool = True,
    cfg: SolveConfig = SolveConfig(),
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> Dict[str, float]:
    """One evaluation, without the plots: test NLL terms over ``test_pos
    [n, N*D]`` / ``test_features [n, N]`` in padded batches of
    ``batch_size``; with a target, the forward ESS of the test points and,
    given ``n_model_samples``, the reverse ESS of model samples drawn with
    ``features_row``.  Probes and base samples come from ``generator``,
    test batches first.  With a ``mesh`` the ranks share every batch
    (``batch_size`` a multiple of its ranks) and each returns the same
    metrics."""

    def batch_free(generator):
        return reverse_ess(
            cnf, target_log_prob_fn, features_row, n_model_samples, batch_size,
            exact_log_prob, cfg, generator, mesh=mesh,
        )

    def on_batch(data, mask, generator):
        return eval_data_batch(
            cnf, data, mask, target_log_prob_fn, exact_log_prob, cfg, generator, mesh=mesh
        )

    with_rv = target_log_prob_fn is not None and n_model_samples is not None
    info, log_w_fwd, flat_mask = eval_fn(
        (test_pos, test_features),
        eval_on_test_batch_fn=on_batch,
        eval_batch_free_fn=batch_free if with_rv else None,
        batch_size=batch_size,
        generator=generator,
    )
    if target_log_prob_fn is not None and log_w_fwd is not None:
        info.update(calculate_forward_ess(log_w_fwd, mask=flat_mask))
    return {k: float(v) for k, v in info.items()}


# Fields of the schema that the port does not implement: their default,
# and why any other value is refused.
_UNPORTED = {
    ("training", "use_64_bit"): (
        False,
        "the JAX package does not run it: under x64 the EGNN's final_scaling "
        "(ecnf_tpu/models/egnn.py:226, ones_init() with no dtype) is created "
        "float64, so the field returns float64 for float32 data and the "
        "solve's while_loop raises a TypeError (ecnf_tpu/ops/ode.py:237, "
        "carry float32 in, float64 out); a port that ran it would add a "
        "feature the reference lacks",
    ),
}


def _refuse_unported(cfg: ExperimentConfig) -> None:
    sections = {"training": cfg.training, "network": cfg.flow.network}
    for (section, name), (default, reason) in _UNPORTED.items():
        value = getattr(sections[section], name)
        if value != default:
            raise NotImplementedError(
                f"{section}.{name}={value!r} is not ported to ecnf_tpu_torch (only "
                f"{default!r}): {reason}"
            )


# `training.precision` -> `torch.set_float32_matmul_precision`, as the JAX
# package sets `jax_default_matmul_precision`.
MATMUL_PRECISION = {"float32": "highest", "tensorfloat32": "high", "bfloat16": "medium"}


def set_matmul_precision(precision: str) -> None:
    """Set the process-wide precision of f32 matrix products from
    ``training.precision`` (one of `MATMUL_PRECISION`'s names; any other
    raises).  As in the JAX package it stays set after the run, and it
    reaches only the products that PyTorch dispatches: the hand kernels
    keep their own (the edge kernel's bf16 mma.sync and the f32 kernels'
    3xTF32), as the Pallas kernels keep theirs.  Unlike JAX, ``"float32"``
    sets ``"highest"`` too, so it undoes an earlier run's setting.

    On a CUDA card ``"bfloat16"`` computes as ``"tensorfloat32"``: cuBLAS
    has no f32 product with bf16 internals, so PyTorch runs ``"medium"``
    as TF32 (an H100 gave the same log q for both: `chip_smoke.py` phase
    16 (e)).
    It warns so when a card is present."""
    if precision not in MATMUL_PRECISION:
        raise ValueError(
            f"training.precision={precision!r}: expected one of {sorted(MATMUL_PRECISION)}"
        )
    if precision == "bfloat16" and torch.cuda.is_available():
        warnings.warn("training.precision=bfloat16: CUDA f32 matrix products run as "
                      "tensorfloat32 under torch's 'medium' precision", stacklevel=2)
    torch.set_float32_matmul_precision(MATMUL_PRECISION[precision])


LoadDatasetFn = Callable[[Optional[int], Optional[int]], tuple]
# (state, train data, generator) -> figures.
Plotter = Callable[[TrainingState, object, torch.Generator], List[Figure]]


def setup_default_plotter(
    cnf: FlowMatchingCNF, n_nodes: int, dim: int, n_samples_plotting: int, solve_cfg: SolveConfig
) -> Plotter:
    """The distance histogram of flow samples against training data (port
    of `ecnf_tpu/training/setup.py: setup_default_plotter`): one batched
    `sample_cnf` of ``n_samples_plotting`` samples, with the first training
    row's node features and base samples drawn from the generator, the
    state's parameters loaded into ``cnf``'s field; the first
    ``n_samples_plotting`` training points' distances set the shared bins
    (at ``max_distance=10.0``) and both are counted in them."""

    def default_plotter(state: TrainingState, train_data_, generator: torch.Generator) -> List[Figure]:
        cnf.field.load_state_dict(state.params)
        feats = train_data_.features[0].reshape(1, -1).repeat(n_samples_plotting, 1)
        flow_samples = sample_cnf(cnf, n_samples_plotting, feats, solve_cfg, generator)
        flow_samples = flow_samples.reshape(n_samples_plotting, n_nodes, dim)

        bins_x, count_list = bin_samples_by_dist(
            [train_data_.positions[:n_samples_plotting]], max_distance=10.0
        )
        distances_flow = get_pairwise_distances_for_plotting(
            flow_samples, train_data_.positions.shape[1], max_distance=10.0
        )
        counts_flow = get_counts(distances_flow, bins_x)

        fig = Figure(figsize=(5, 5))
        ax = fig.axes[0]
        ax.stairs(count_list[0], bins_x, label="train samples", alpha=0.4, fill=True)
        ax.stairs(counts_flow, bins_x, label="flow samples", alpha=0.4, fill=True)
        ax.legend()
        return [fig]

    return default_plotter


def plot_path(plots_dir: str, j: int, iteration_n: int) -> str:
    """Where figure ``j`` of the evaluation at ``iteration_n`` is written."""
    return os.path.join(plots_dir, "plot_%03i_iter_%08i.svg" % (j, iteration_n))


def setup_training(
    cfg: ExperimentConfig,
    load_dataset: LoadDatasetFn,
    target_log_prob_fn: Optional[TargetLogProb] = None,
    plotter: Optional[Plotter] = None,
    device=None,
    mesh=None,
) -> TrainConfig:
    """The `TrainConfig` of an experiment: ``load_dataset(train_set_size,
    test_set_size) -> (train, test)`` `FullGraphSample`s on ``device``; the
    data's centre of mass removed; Adam or AdamW over ``n_training_iter x
    max(n // batch_size, 1)`` steps; the CNF with ``n_features = max + 1``;
    the evaluation on the test set (with the reverse ESS when
    ``eval_n_model_samples`` is set and there is a target), on the EMA
    parameters at the final iteration, and with ``eval_plots`` (the
    default) the figures of ``plotter`` (`setup_default_plotter` when None)
    after it, drawn with the evaluation's generator and written as
    ``plot_%03i_iter_%08i.svg`` when saving.

    ``training.precision`` sets the process's f32 matmul precision
    (`set_matmul_precision`); ``trace_column_chunk`` and
    ``network.stable_mlp`` go to the solve and the CNF as in JAX;
    ``network.type`` is read by neither package (the field is the EGNN
    whatever it says); ``profile_dir`` is the loop's.
    ``compile_cache``, ``epochs_per_dispatch`` and ``eval_dispatch_chunk``
    tune XLA compilation and dispatch and are ignored (an eager epoch has
    no dispatch to group); the fields of `_UNPORTED` are refused unless
    at their defaults.

    ``mesh`` (default `parallel.get_mesh`: None in a single process) is
    the data-parallel mesh of the train steps and the evaluation; the
    evaluation batch is rounded up to a multiple of its ranks, the padding
    masked, as in JAX.  Ranks other than 0 log to a `ListLogger` and draw
    no figures; every rank then takes rank 0's evaluation generator, which
    the figures drew from.
    """
    _refuse_unported(cfg)
    device = resolve_device(device)
    tcfg = cfg.training
    batch_size = tcfg.batch_size
    set_matmul_precision(tcfg.precision)
    if mesh is None:
        mesh = get_mesh()
    main = is_main_process()
    n_ranks = axis_size(mesh)
    eval_batch_size = pad_to_multiple(tcfg.eval_batch_size, n_ranks)
    if eval_batch_size != tcfg.eval_batch_size:
        print_main(f"eval_batch_size {tcfg.eval_batch_size} -> {eval_batch_size} "
              f"(rounded up to the {n_ranks}-device mesh)")

    logger = setup_logger(
        cfg.logger, save_dir=tcfg.save_dir or ".", save=tcfg.save,
        experiment_config=config_to_dict(cfg),
    ) if main else ListLogger()
    save_path = tcfg.save_dir or "."
    if tcfg.save_in_wandb_dir:
        run = getattr(logger, "run", None)
        if isinstance(logger, WandbLogger) and logger._wandb is not None and run is not None:
            save_path = os.path.join(str(run.dir), save_path.lstrip(os.sep))
        else:
            raise ValueError(
                "training.save_in_wandb_dir=true requires the wandb logger with a live run "
                f"(logger: {{wandb: {{...}}}} and the wandb package installed); got "
                f"{type(logger).__name__}."
            )
    pathlib.Path(save_path).mkdir(exist_ok=True, parents=True)

    train_data, test_data = load_dataset(tcfg.train_set_size, tcfg.test_set_size)
    center = lambda p: (p - p.mean(dim=1, keepdim=True)).to(device)
    train_pos, test_pos = center(train_data.positions), center(test_data.positions)
    n_train, n_nodes, dim = train_pos.shape

    ocfg = tcfg.optimizer
    optimizer = build_optimizer(
        init_lr=ocfg.init_lr,
        use_schedule=ocfg.use_schedule,
        peak_lr=ocfg.peak_lr,
        end_lr=ocfg.end_lr,
        n_iter_warmup=ocfg.n_iter_warmup,
        n_iter_total=tcfg.n_training_iter * max(n_train // batch_size, 1),
        optimizer_name=ocfg.optimizer,
    )

    flat = lambda a: a.reshape(a.shape[0], -1).to(device)
    train_pos_flat, test_pos_flat = flat(train_pos), flat(test_pos)
    train_features_flat = flat(train_data.features).long()
    test_features_flat = flat(test_data.features).long()

    net_cfg = cfg.flow.network
    cnf = build_cnf(
        n_frames=n_nodes, dim=dim, sigma_min=cfg.flow.sigma_min, base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net_cfg.n_blocks_egnn, mlp_units=net_cfg.mlp_units,
        n_invariant_feat_hidden=net_cfg.n_invariant_feat_hidden,
        time_embedding_dim=net_cfg.time_embedding_dim,
        n_features=int(train_features_flat.max()) + 1, stable_mlp=net_cfg.stable_mlp,
        compute_dtype=net_cfg.compute_dtype, device=device,
    )
    solve_cfg = SolveConfig(
        use_fixed_step_size=tcfg.use_fixed_step_size,
        trace_column_chunk=tcfg.trace_column_chunk,
        hutchinson_probes=tcfg.hutchinson_probes,
        method=tcfg.ode_method,
    )
    update_fn = make_update_fn(
        cnf, optimizer, use_ema=tcfg.use_ema, ema_beta=tcfg.ema_beta, mesh=mesh,
        microbatch=tcfg.microbatch,
    )

    def init_state(generator: torch.Generator) -> TrainingState:
        return init_state_from(cnf, optimizer, generator, device, tcfg.use_ema, mesh)

    def run_epoch(state: TrainingState):
        state, infos = epoch(state, update_fn, train_pos_flat, train_features_flat, batch_size,
                             mesh=mesh)
        return state, {k: v.cpu() for k, v in infos.items()}

    # `eval_plots: false` skips the plotting solve.
    if not tcfg.eval_plots:
        plotter = None
    elif plotter is None:
        plotter = setup_default_plotter(cnf, n_nodes, dim, tcfg.plot_batch_size, solve_cfg)
    train_data_ = train_data._replace(positions=train_pos)

    with_rv = target_log_prob_fn is not None and tcfg.eval_n_model_samples is not None

    def eval_and_plot(
        state: TrainingState, generator: torch.Generator, iteration_n: int, save: bool,
        plots_dir: Optional[str],
    ) -> dict:
        """`evaluate` on the test set, then the plotter's figures; the EMA
        parameters on the final evaluation.  Draws (probes, base samples)
        come from ``generator``."""
        if tcfg.use_ema and tcfg.n_training_iter - 1 == iteration_n:
            state = state._replace(params=state.ema_params)
        cnf.field.load_state_dict(state.params)
        info = evaluate(
            cnf, test_pos_flat, test_features_flat, train_features_flat[0], eval_batch_size,
            target_log_prob_fn, tcfg.eval_n_model_samples if with_rv else None,
            tcfg.eval_exact_log_prob, solve_cfg, generator, mesh=mesh,
        )
        figures = plotter(state, train_data_, generator) if plotter is not None and main else []
        if plotter is not None:
            replicate(generator, mesh)
        for j, figure in enumerate(figures):
            if save and plots_dir is not None:
                figure.savefig(plot_path(plots_dir, j, iteration_n))
        return {k: np.asarray(v) for k, v in info.items()}

    return TrainConfig(
        n_iteration=tcfg.n_training_iter,
        logger=logger,
        seed=tcfg.seed,
        n_checkpoints=tcfg.n_checkpoints,
        n_eval=tcfg.n_eval,
        init_state=init_state,
        update_state=run_epoch,
        eval_and_plot_fn=eval_and_plot,
        save=tcfg.save,
        save_dir=save_path,
        resume=tcfg.resume,
        runtime_limit=tcfg.runtime_limit,
        profile_dir=tcfg.profile_dir,
    )
