"""One rank of the port's multi-process CPU tests (gloo), and their launcher.

The tests (`tests/test_torch_sharded_divergence.py`, `test_torch_ddp_train.py`,
`test_torch_parallel_programs.py`) compute JAX's numbers themselves and
hand this module a task: `launch` starts one process per rank running
``python tests/torch_ddp_worker.py TASK RANK WORLD WORKDIR``, which joins
the group through a file store in ``WORKDIR``, reads ``WORKDIR/spec.pt``
(the inputs, saved by the test), runs the task and has rank 0 save
``WORKDIR/out.pt``.  This module imports no JAX, so a rank starts in
seconds; the helpers the tests share with it (`program_config`,
`program_dataset`, `sample_argv`, `score_argv`) live here too.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ecnf_tpu_torch.cnf.build import build_cnf, build_mlp_cnf  # noqa: E402
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob  # noqa: E402
from ecnf_tpu_torch.ops.divergence import sharded_value_and_exact_divergence  # noqa: E402
from ecnf_tpu_torch.parallel import distributed, mesh as pmesh  # noqa: E402
from ecnf_tpu_torch.training import optim  # noqa: E402
from ecnf_tpu_torch.training import state as state_mod  # noqa: E402

LAUNCH_TIMEOUT = 240


def launch(task: str, world: int, workdir: Path, spec: dict) -> dict:
    """Run ``task`` on ``world`` gloo ranks and return rank 0's output."""
    workdir = Path(workdir)
    torch.save(spec, workdir / "spec.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, task, str(rank), str(world), str(workdir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(rank, p.returncode) for rank, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    out = torch.load(workdir / "out.pt", weights_only=True)
    out["log"] = logs[0]
    return out


# --- helpers shared with the tests -------------------------------------------

def program_config(save_dir, n_train_iter=1, fixed_step=True, eval_batch_size=None):
    """The DW4 ``--local`` config in f32 (2 blocks of [16], hidden 8, time
    embedding 6, batch 8, eval batch 9 unless ``eval_batch_size``), one
    epoch, evaluations at -1 and 0 on fixed rk4 steps (the config's own
    adaptive Dopri5 unless ``fixed_step``), one checkpoint, no figures, 80
    training and 20 test points."""
    from ecnf_tpu_torch.examples import common, dw4

    overrides = [
        "flow.network.compute_dtype=null", "training.eval_plots=false",
        f"training.n_training_iter={n_train_iter}", "training.n_eval=1",
        "training.n_checkpoints=1", "training.save=true", "training.test_set_size=20",
        f"training.save_dir={save_dir}",
    ]
    if fixed_step:
        overrides += ["training.use_fixed_step_size=true", "training.ode_method=rk4"]
    if eval_batch_size is not None:
        overrides.append(f"training.eval_batch_size={eval_batch_size}")
    return common.load_experiment_config(
        str(common.CONFIG_DIR / "dw4.yaml"), True, overrides, local_extra=dw4.LOCAL_EXTRA
    )


def initial_evaluation(cfg):
    """`setup_training`'s evaluation at iteration -1 of ``cfg`` on
    `program_dataset`, as `run_training` makes it, without writing."""
    from ecnf_tpu_torch.targets.energies import double_well_log_prob
    from ecnf_tpu_torch.training.setup import setup_training

    tc = setup_training(cfg, program_dataset, double_well_log_prob, device="cpu")
    generator = torch.Generator().manual_seed(tc.seed)
    state = tc.init_state(generator)
    return tc.eval_and_plot_fn(state, generator, -1, False, None)


def program_dataset(n_train, n_test):
    """DW4-shaped points (4 nodes in 2-D) from numpy seed 0, centred."""
    from ecnf_tpu_torch.targets.data import positional_dataset_only_to_full_graph

    pos = np.random.default_rng(0).normal(scale=1.5, size=(200, 4, 2)).astype(np.float32)
    pos = torch.from_numpy(pos - pos.mean(axis=1, keepdims=True))
    return (positional_dataset_only_to_full_graph(pos[:n_train]),
            positional_dataset_only_to_full_graph(pos[100:100 + n_test]))


NET_FLAGS = ["--dtype", "float32", "--n-blocks", "2", "--mlp-units", "16", "16", "--hidden", "8",
             "--device", "cpu", "--seed", "3"]


def sample_argv(workdir, tag, *extra):
    return ["--n-nodes", "5", "--n-samples", "8", "--batch-size", "4", "--with-log-prob",
            "--method", "rk4", "--step-size", "0.25", "--output", str(Path(workdir) / f"x_{tag}.npy"),
            "--log-prob-output", str(Path(workdir) / f"q_{tag}.npy"), *NET_FLAGS, *extra]


def score_argv(workdir, data, tag, *extra):
    return ["--data", str(data), "--batch-size", "4", "--method", "rk4", "--step-size", "0.25",
            "--output", str(Path(workdir) / f"p_{tag}.npy"), *NET_FLAGS, *extra]


def checksum(tensors) -> torch.Tensor:
    """A bit-level checksum of float32 tensors: their int32 words summed in int64."""
    return torch.stack([t.detach().float().contiguous().view(torch.int32).long().sum()
                        for t in tensors]).sum()


# --- tasks -------------------------------------------------------------------

def task_divergence(spec, workdir):
    """The exact trace with its columns split over the ranks: a 1-D mesh
    (two ranks) or ``get_mesh_2d(2, 2)`` (four), identity and zero-CoM
    bases; on two ranks also ``get_log_prob(trace_mesh=...)`` on an MLP CNF."""
    cnf = build_cnf(**spec["cnf_kwargs"], device="cpu")
    cnf.field.load_state_dict(spec["state_dict"])
    x, feats_row, t = spec["x"], spec["feats_row"], spec["t"]
    basis, offset = cnf.exact_trace_plan()

    def field(xb):
        b = xb.shape[0]
        return cnf.apply(xb, torch.full((b,), t), feats_row.expand(b, -1))

    two_d = spec["world"] == 4
    mesh = pmesh.get_mesh_2d(2, 2) if two_d else pmesh.get_mesh()
    kwargs = dict(axis_name=pmesh.TRACE_AXIS, batch_axis=pmesh.DATA_AXIS) if two_d else {}
    out = {}
    with torch.no_grad():
        for name, b, off in (("identity", None, None), ("zero_com", basis, offset)):
            v, div = sharded_value_and_exact_divergence(field, x, mesh, basis=b, trace_offset=off,
                                                        **kwargs)
            if two_d:
                v, div = (pmesh.gather_rows(a, mesh, pmesh.DATA_AXIS) for a in (v, div))
            out[name] = (v, div)
    if not two_d:
        mlp = build_mlp_cnf(dim=2, sigma_min=0.01, base_scale=1.0, features=(16,), device="cpu")
        mlp.field.load_state_dict(spec["mlp_state_dict"])
        cfg = SolveConfig(use_fixed_step_size=True, step_size=0.1)
        out["log_prob"] = get_log_prob(mlp, spec["mlp_x"], cfg=cfg, trace_mesh=mesh)
    return out


def task_train(spec, workdir):
    """Three steps of the port's data-parallel update at microbatch 1 and 2
    with EMA: on injected x0 and t (each rank fed its rows of x and the
    features, and the whole batch's x0 and t, of which the update keeps
    its rows), and on noise drawn from the state's generator (each rank's
    x0 recorded)."""
    cnf = build_cnf(**spec["cnf_kwargs"], device="cpu")
    mesh = pmesh.get_mesh()
    seen = []
    loss_and_grads = state_mod.loss_and_grads

    def recording(cnf_, params, x_data, features, microbatch=None, generator=None, x0=None, t=None):
        seen.append(x0.clone())
        return loss_and_grads(cnf_, params, x_data, features, microbatch, generator, x0, t)

    state_mod.loss_and_grads = recording
    out = {}
    for mb in (1, 2):
        for injected in (True, False):
            cnf.field.load_state_dict(spec["state_dict"])
            opt = optim.build_optimizer(spec["lr"])
            st = pmesh.replicate(state_mod.init_training_state(
                cnf, opt, torch.Generator().manual_seed(spec["seed"]), use_ema=True), mesh)
            update = state_mod.make_update_fn(cnf, opt, use_ema=True, mesh=mesh, microbatch=mb)
            infos = []
            seen.clear()
            for step in spec["steps"][mb]:
                x, feats = pmesh.shard_batch((step["x"], step["feats"]), mesh)
                noise = (step["x0"], step["t"]) if injected else (None, None)
                st, info = update(st, x, feats, *noise)
                infos.append(torch.stack([info[k] for k in ("loss", "grad_norm", "update_norm")]))
            key = f"mb{mb}_{'injected' if injected else 'drawn'}"
            out[key] = dict(
                info=torch.stack(infos), params=st.params, ema=st.ema_params,
                checksums=pmesh.gather_rows(checksum(list(st.params.values()) +
                                                     list(st.ema_params.values()))[None], mesh),
                x0=torch.stack([pmesh.gather_rows(x0, mesh) for x0 in seen]),
            )
    return out


def task_programs(spec, workdir):
    """`setup_training` (one epoch, two evaluations, one checkpoint, then an
    evaluation on the adaptive solve), ``sample`` and ``score``, and
    `dryrun_multichip(2)`."""
    from ecnf_tpu_torch import sample, score
    from ecnf_tpu_torch.parallel.dryrun import dryrun_multichip
    from ecnf_tpu_torch.targets.energies import double_well_log_prob
    from ecnf_tpu_torch.training import loop
    from ecnf_tpu_torch.training.setup import setup_training

    saves = []
    save_checkpoint = loop.save_checkpoint
    loop.save_checkpoint = lambda *a: saves.append(a[1]) or save_checkpoint(*a)
    cfg = program_config(Path(workdir) / "run_w2")
    logger, state = loop.run_training(setup_training(
        cfg, program_dataset, double_well_log_prob, device="cpu"))
    counts = pmesh.gather_rows(torch.tensor([len(saves)]), pmesh.get_mesh())
    out = dict(history={k: torch.tensor(np.asarray(v, dtype=np.float64))
                        for k, v in logger.history.items()},
               saves=counts, params=state.params)
    # The config's adaptive solve: rows 0-4 and 5-9 of each batch of 10 on
    # the two ranks, as one process's batches of 5.
    adaptive = initial_evaluation(program_config(Path(workdir) / "adaptive_w2", fixed_step=False,
                                                 eval_batch_size=10))
    out["adaptive"] = {k: torch.tensor(float(v), dtype=torch.float64) for k, v in adaptive.items()}
    sample.main(sample_argv(workdir, "w2"))
    sample.main(sample_argv(workdir, "w2_approx", "--approx"))
    score.main(score_argv(workdir, spec["score_data"], "w2"))
    score.main(score_argv(workdir, spec["score_data"], "w2_approx", "--approx"))
    out["dryrun"] = dryrun_multichip(2, device="cpu")
    return out


TASKS = {"divergence": task_divergence, "train": task_train, "programs": task_programs}


def main(task, rank, world, workdir):
    torch.set_num_threads(1)
    distributed.maybe_initialize_distributed(
        coordinator_address=f"file://{Path(workdir) / 'rendezvous'}",
        num_processes=world, process_id=rank,
    )
    spec = torch.load(Path(workdir) / "spec.pt", weights_only=True)
    spec["world"] = world
    out = TASKS[task](spec, workdir)
    if rank == 0:
        torch.save(out, Path(workdir) / "out.pt")
    distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
