"""A dry run of every data-parallel path on tiny shapes (port of
`__graft_entry__.py: dryrun_multichip`).

Each rank of the process group calls `dryrun_multichip` with the group's
size; it runs, on a 2-block EGNN at QM9's node count (N=19): the sharded
train step, the microbatched one, fixed-step and adaptive exact
evaluation, reverse-ESS sampling, the exact trace on a 2-D ``(data,
trace)`` mesh against the unsharded trace, and two epochs.  In a single
process (``n_devices=1``, no group) every path runs without a collective.
"""
import math

import torch

from ecnf_tpu_torch.cnf.build import build_cnf, resolve_device
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_tpu_torch.ops.divergence import (
    sharded_value_and_exact_divergence,
    value_and_exact_divergence,
)
from ecnf_tpu_torch.parallel.distributed import print_main, world
from ecnf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TRACE_AXIS,
    get_mesh,
    get_mesh_2d,
    replicate,
    rows,
    shard_batch,
)
from ecnf_tpu_torch.training.evaluation import calculate_reverse_ess
from ecnf_tpu_torch.training.optim import build_optimizer
from ecnf_tpu_torch.training.setup import epoch
from ecnf_tpu_torch.training.state import init_training_state, make_update_fn

# The 2-D mesh trace against the unsharded one (`__graft_entry__.py`).
TRACE_RTOL, TRACE_ATOL = 2e-3, 1e-4


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {message}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run every data-parallel path once over a group of ``n_devices``
    ranks (this process's card, or the CPU with ``device="cpu"``); raises
    on a non-finite result or a trace outside its band.  Returns the
    losses, the log-prob means, the reverse ESS and the 2-D trace's error;
    rank 0 prints a line for each path."""
    _, n = world()
    _check(n == n_devices, f"need {n_devices} ranks, the group has {n}")
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = get_mesh()

    n_nodes, dim = 19, 3
    cnf = build_cnf(
        n_frames=n_nodes, dim=dim, sigma_min=1e-6, base_scale=2.0, n_blocks_egnn=2,
        mlp_units=(32,), n_invariant_feat_hidden=16, time_embedding_dim=8, n_features=1,
        device=device, generator=torch.Generator().manual_seed(1),
    )
    optimizer = build_optimizer(1e-4, use_schedule=False)
    batch = 2 * n_devices
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, n_nodes * dim), generator=gen).to(device)
    feats = torch.zeros((batch, n_nodes), dtype=torch.int64, device=device)
    out = {}

    state = replicate(init_training_state(
        cnf, optimizer, torch.Generator(device=device).manual_seed(1)), mesh)
    xs, fs = shard_batch((x, feats), mesh)
    state, info = make_update_fn(cnf, optimizer, mesh=mesh)(state, xs, fs)
    out["loss"] = float(info["loss"])
    _check(math.isfinite(out["loss"]), f"non-finite loss {out['loss']}")
    print_main(f"  sharded step ok: loss={out['loss']:.4f}")

    state, info = make_update_fn(cnf, optimizer, mesh=mesh, microbatch=2)(state, xs, fs)
    out["loss_mb2"] = float(info["loss"])
    _check(math.isfinite(out["loss_mb2"]), "non-finite microbatched loss")
    print_main(f"  microbatched sharded step ok: loss={out['loss_mb2']:.4f}")

    cnf.field.load_state_dict(state.params)
    for name, cfg in (("fixed-step", SolveConfig(use_fixed_step_size=True, step_size=0.25)),
                      ("adaptive", SolveConfig(rtol=1e-3, atol=1e-3))):
        log_p = get_log_prob(cnf, x, feats, cfg=cfg, mesh=mesh)[0]
        _check(bool(torch.isfinite(log_p).all()), f"non-finite {name} log-probs")
        out[f"{name}_log_p"] = float(log_p.mean())
        print_main(f"  {name} exact eval ok: log-prob mean={out[f'{name}_log_p']:.2f}")

    # Reverse ESS: the ranks share the batch of model samples.
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.25)
    samples, log_q = sample_and_log_prob_cnf(
        cnf, batch, feats, approx=True, cfg=cfg, generator=gen, mesh=mesh
    )
    log_w = cnf.log_prob_base(samples) - log_q
    out["rv_ess"] = float(calculate_reverse_ess(log_w))
    _check(math.isfinite(out["rv_ess"]), f"non-finite reverse ESS {out['rv_ess']}")
    print_main(f"  reverse-ESS sampling ok: rv_ess={out['rv_ess']:.4f}")

    # 2-D (data, trace) mesh: the batch and the Jacobian's columns split at once.
    n_data = 2 if n_devices % 2 == 0 else 1
    mesh2d = get_mesh_2d(n_data)

    def field(xb):
        b = xb.shape[0]
        return cnf.apply(xb, torch.full((b,), 0.5, device=device),
                         torch.zeros((b, n_nodes), dtype=torch.int64, device=device))

    with torch.no_grad():
        _, div = sharded_value_and_exact_divergence(
            field, x, mesh2d, axis_name=TRACE_AXIS, batch_axis=DATA_AXIS
        )
        div_ref = rows(value_and_exact_divergence(field, x)[1], mesh2d, DATA_AXIS)
    err = (div - div_ref).abs()
    out["trace_err"] = float(err.max())
    _check(bool((err <= TRACE_ATOL + TRACE_RTOL * div_ref.abs()).all()),
           f"2-D mesh trace off by {out['trace_err']:.3e}")
    print_main(f"  2-D (data={n_data}, trace={n_devices // n_data}) mesh trace ok")

    # Two epochs of two minibatches over a dataset of twice the batch.
    pos = torch.randn((2 * batch, n_nodes * dim), generator=gen).to(device)
    feat_ds = torch.zeros((2 * batch, n_nodes), dtype=torch.int64, device=device)
    update = make_update_fn(cnf, optimizer, mesh=mesh)
    losses = []
    for _ in range(2):
        state, infos = epoch(state, update, pos, feat_ds, batch, mesh=mesh)
        losses.append(infos["loss"])
    losses = torch.stack(losses).cpu()
    _check(tuple(losses.shape) == (2, 2) and bool(torch.isfinite(losses).all()), f"{losses}")
    out["epoch_losses"] = losses.tolist()
    print_main(f"  two epochs ok: losses={[round(v, 3) for v in losses.flatten().tolist()]}")
    print_main(f"dryrun_multichip({n_devices}) OK: loss={out['loss']:.4f}")
    return out
