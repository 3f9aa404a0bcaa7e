"""Train the JAX package from the PyTorch port's seed-0 ALDP start.

The port's `examples/configs/aldp_soak.yaml` run at seed 0 ends below the
JAX soak's anchor, its training loss flat at ~0.0245 from iteration 2,000.
This script asks whether JAX, started from the same point, lands in the
same place: it hands the port's seed-0 initial weights (`convert.to_flax`
of `setup_training(...).init_state`) and the port's minibatch order to
JAX's `make_update_fn`, and writes JAX's loss per epoch.  JAX's own x0 and
t draws stay JAX's (threefry and Philox streams never match).

The port's minibatch order comes from its training generator, which lives
on the card, so it is drawn there first (no network is run; the draws of
x0 and t between the permutations are made at their shapes, so the
generator's offsets are the training run's):

    python scripts/aldp_seed0_study.py --draw-order order.npy --epochs 3000   # on the card

Then, on the CPU (JAX; loss only, no evaluations):

    JAX_PLATFORMS=cpu python scripts/aldp_seed0_study.py --order order.npy \
        --out jax_losses.csv [--epochs 3000]

The CSV gets one line per epoch (``epoch,mean_loss,seconds``) as it goes,
so a run cut short keeps what it reached.  To set it beside the port's own
run (the CSV logger's ``logging_history.csv`` of ``examples.aldp``, one
row per minibatch), as mean losses over windows of 100 epochs:

    python scripts/aldp_seed0_study.py --compare logging_history.csv jax_losses.csv
"""
import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CONFIG = REPO / "examples" / "configs" / "aldp_soak.yaml"


def port_train_config(device):
    """The port's `TrainConfig` for aldp_soak.yaml (nothing saved)."""
    from functools import partial

    from ecnf_tpu_torch.examples import aldp
    from ecnf_tpu_torch.training.config import load_config
    from ecnf_tpu_torch.training.setup import setup_training

    cfg = load_config(str(CONFIG), overrides=["training.save=false"])
    t = cfg.target
    load = partial(
        aldp.load_dataset, final_run=cfg.training.final_run, train_path=str(REPO / t.train_path),
        test_path=str(REPO / t.test_path), valid_path=str(REPO / t.valid_path),
        valid_skip=t.valid_skip, test_skip=t.test_skip, device=device,
    )
    return cfg, setup_training(cfg, load, device=device)


def port_initial_state(device):
    """The state `run_training` starts from: init_state of the seeded CPU
    generator, as the loop makes it."""
    import torch

    cfg, tc = port_train_config(device)
    return cfg, tc.init_state(torch.Generator().manual_seed(cfg.training.seed))


def draw_order(path: str, epochs: int) -> None:
    """Each epoch's permutation from the port's training generator on the
    card, with the x0 and t draws of each step made between them."""
    import torch

    cfg, state = port_initial_state("cuda")
    gen = state.generator
    n, B = cfg.training.train_set_size, cfg.training.batch_size
    n_nodes = 22
    perms = np.empty((epochs, n), np.int16)
    for e in range(epochs):
        perm = torch.randperm(n, generator=gen, device=gen.device)
        perms[e] = perm.cpu().numpy()
        for _ in range(n // B):
            torch.randn((B, n_nodes, 3), generator=gen, device=gen.device)
            torch.rand((B,), generator=gen, device=gen.device)
    np.save(path, perms)
    print(f"wrote {path}: {epochs} permutations of {n}")


def train_jax(order_path: str, out: str, epochs: int) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from ecnf_tpu.cnf.build import build_cnf
    from ecnf_tpu.targets.data import load_aldp
    from ecnf_tpu.training.config import load_config
    from ecnf_tpu.training.optim import build_optimizer
    from ecnf_tpu.training.state import init_training_state, make_update_fn
    from ecnf_tpu_torch.convert import to_flax

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(str(CONFIG))
    tcfg, ocfg, net = cfg.training, cfg.training.optimizer, cfg.flow.network
    train, _, _ = load_aldp(train_path=str(REPO / cfg.target.train_path),
                            train_n_points=tcfg.train_set_size)
    pos = np.asarray(train.positions, np.float32)
    pos = pos - pos.mean(axis=1, keepdims=True)
    n, n_nodes, dim = pos.shape
    x_all = jnp.asarray(pos.reshape(n, -1))
    feats_all = jnp.asarray(np.asarray(train.features).reshape(n, -1).astype(np.int32))
    B = tcfg.batch_size
    steps = n // B

    cnf = build_cnf(
        n_frames=n_nodes, dim=dim, sigma_min=cfg.flow.sigma_min, base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net.n_blocks_egnn, mlp_units=tuple(net.mlp_units),
        n_invariant_feat_hidden=net.n_invariant_feat_hidden,
        time_embedding_dim=net.time_embedding_dim, n_features=int(feats_all.max()) + 1,
        compute_dtype=net.compute_dtype,
    )
    optimizer = build_optimizer(
        init_lr=ocfg.init_lr, use_schedule=ocfg.use_schedule, peak_lr=ocfg.peak_lr,
        end_lr=ocfg.end_lr, n_iter_warmup=ocfg.n_iter_warmup,
        n_iter_total=tcfg.n_training_iter * steps, optimizer_name=ocfg.optimizer,
    )
    state = init_training_state(cnf, optimizer, jax.random.PRNGKey(tcfg.seed), x_all[:2],
                                feats_all[:2], use_ema=False)
    _, port_state = port_initial_state("cpu")
    params = jax.tree_util.tree_map(jnp.asarray, to_flax(port_state.params))
    state = state._replace(params=params, opt_state=optimizer.init(params))
    update = make_update_fn(cnf, optimizer, use_ema=False)

    order = np.load(order_path).astype(np.int64)
    epochs = min(epochs, order.shape[0])
    with open(out, "w") as f:
        f.write("epoch,mean_loss,seconds\n")
        for e in range(epochs):
            t0 = time.perf_counter()
            losses = []
            for b in range(steps):
                idx = order[e, b * B:(b + 1) * B]
                state, info = update(state, x_all[idx], feats_all[idx])
                losses.append(info["loss"])
            mean = float(np.mean([float(v) for v in losses]))
            f.write(f"{e},{mean!r},{time.perf_counter() - t0:.3f}\n")
            f.flush()


def compare(port_csv: str, jax_csv: str, window: int = 100) -> None:
    """Mean loss per window of epochs: the port's run and this script's."""
    import csv

    port = {}
    with open(port_csv) as f:
        for row in csv.DictReader(f):
            if row.get("loss") and float(row["iteration"]) >= 0:
                port.setdefault(int(float(row["iteration"])), []).append(float(row["loss"]))
    port = {e: float(np.mean(v)) for e, v in port.items()}
    with open(jax_csv) as f:
        jax_loss = {int(r["epoch"]): float(r["mean_loss"]) for r in csv.DictReader(f)}
    last = max(jax_loss)
    print(f"epochs,port_mean_loss,jax_mean_loss (JAX reached epoch {last})")
    for lo in range(0, max(port) + 1, window):
        p = [port[e] for e in range(lo, lo + window) if e in port]
        j = [jax_loss[e] for e in range(lo, lo + window) if e in jax_loss]
        if len(j) < window:
            j = []
        print(f"{lo}-{lo + window - 1},{np.mean(p) if p else float('nan'):.5f},"
              f"{np.mean(j) if j else float('nan'):.5f}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draw-order", type=str, default=None,
                   help="on the card: write the port's permutations here and stop")
    p.add_argument("--order", type=str, default=None, help="permutations from --draw-order")
    p.add_argument("--out", type=str, default="jax_losses.csv")
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--compare", nargs=2, metavar=("PORT_CSV", "JAX_CSV"), default=None,
                   help="print both runs' mean loss per 100 epochs")
    a = p.parse_args()
    if a.compare:
        compare(*a.compare)
    elif a.draw_order:
        draw_order(a.draw_order, a.epochs)
    elif a.order:
        train_jax(a.order, a.out, a.epochs)
    else:
        p.error("pass --draw-order (card) or --order (CPU)")
