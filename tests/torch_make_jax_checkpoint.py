"""Write the JAX checkpoint that the port's Orbax reader and its serving
surface are held to, with the JAX package's own numbers beside it.

The checkpoint is a ``TrainingState`` at ``examples/configs/aldp_soak.yaml``'s
width (N=22, 3 blocks of [64, 64], hidden 32, 22 node features) made by
`ecnf_tpu.training.state.init_training_state` with EMA on and saved by
`ecnf_tpu.training.checkpoints.save_checkpoint` as
``model_checkpoints/state_00000100``.  Its ``params`` are redrawn with
`torch_parity.redraw` (seed 0) and its ``ema_params`` with seed 1, both
with the stiff ``sin/cos(1000 t)`` rows zeroed (`torch_parity.slow_time`),
so ``--ema`` visibly changes the answer; Adam's state is
``optimizer.init`` of the redrawn params.

Beside it:

- ``frames.npy``: the ALDP test frames 1600-1615 of
  ``data/aldp_500K_train_mini.h5`` (`ecnf_tpu.targets.data.load_aldp`),
  ``[16, 22, 3]`` float32;
- ``expected.json``: every leaf's dtype, shape and SHA-256 (of its C-order
  bytes) as JAX's ``restore_checkpoint`` gives it back, named by its
  Orbax key tuple joined with "/"; and JAX's log p of the frames under
  ``params`` and ``ema_params``, scored as ``examples/score.py`` scores
  (zero-CoM frames, ``restore_serving_params``, `get_log_prob`) with the
  f32 compute dtype, the exact trace and fixed-step rk4 at 0.05.

Usage (from the repo root, on the CPU; ~1 min):
    JAX_PLATFORMS=cpu python tests/torch_make_jax_checkpoint.py \
        [--out tests/torch_fixtures/jax_aldp]
"""
import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import torch_parity as tp  # noqa: E402
from ecnf_tpu.cnf.build import build_cnf  # noqa: E402
from ecnf_tpu.cnf.sampling import SolveConfig, get_log_prob  # noqa: E402
from ecnf_tpu.targets.data import load_aldp  # noqa: E402
from ecnf_tpu.training.checkpoints import (  # noqa: E402
    restore_checkpoint,
    restore_serving_params,
    save_checkpoint,
)
from ecnf_tpu.training.config import load_config  # noqa: E402
from ecnf_tpu.training.optim import build_optimizer  # noqa: E402
from ecnf_tpu.training.state import init_training_state  # noqa: E402

CONFIG = "examples/configs/aldp_soak.yaml"
ITERATION = 100
FRAMES = (1600, 1616)
SCORE_OVERRIDES = (
    "flow.network.compute_dtype=float32",
    "training.use_fixed_step_size=true",
    "training.ode_method=rk4",
)
DEFAULT_OUT = REPO / "tests" / "torch_fixtures" / "jax_aldp"
COMMAND = "JAX_PLATFORMS=cpu python tests/torch_make_jax_checkpoint.py"


def _cnf(cfg, n_nodes: int):
    net = cfg.flow.network
    return build_cnf(
        n_frames=n_nodes, dim=3, sigma_min=cfg.flow.sigma_min, base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net.n_blocks_egnn, mlp_units=tuple(net.mlp_units),
        n_invariant_feat_hidden=net.n_invariant_feat_hidden,
        time_embedding_dim=net.time_embedding_dim, n_features=n_nodes,
        stable_mlp=net.stable_mlp, compute_dtype=net.compute_dtype,
    )


def _state(cfg, n_nodes: int):
    tcfg, ocfg = cfg.training, cfg.training.optimizer
    optimizer = build_optimizer(
        init_lr=ocfg.init_lr, use_schedule=ocfg.use_schedule, peak_lr=ocfg.peak_lr,
        end_lr=ocfg.end_lr, n_iter_warmup=ocfg.n_iter_warmup,
        n_iter_total=tcfg.n_training_iter * max(tcfg.train_set_size // tcfg.batch_size, 1),
        optimizer_name=ocfg.optimizer,
    )
    feats = jnp.tile(jnp.arange(n_nodes, dtype=jnp.int32), (2, 1))
    state = init_training_state(
        _cnf(cfg, n_nodes), optimizer, jax.random.PRNGKey(tcfg.seed),
        jnp.zeros((2, n_nodes * 3)), feats, use_ema=True,
    )
    net = cfg.flow.network
    tree = jax.tree_util.tree_map(np.asarray, state.params)

    def redrawn(seed):
        t = tp.slow_time(tp.redraw(tree, seed), net.n_invariant_feat_hidden, net.time_embedding_dim)
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), t)

    params = redrawn(0)
    return state._replace(params=params, ema_params=redrawn(1), opt_state=optimizer.init(params))


def _key_name(entry) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def leaf_digests(tree) -> dict:
    """``{"/"-joined key path: {dtype, shape, sha256}}`` of a pytree's arrays."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out["/".join(_key_name(e) for e in path)] = {
            "dtype": a.dtype.str, "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
        }
    return out


def jax_log_p(checkpoint: str, frames: np.ndarray) -> dict:
    """JAX's log p of ``frames`` under the checkpoint's params and EMA params."""
    cfg = load_config(str(REPO / CONFIG), overrides=list(SCORE_OVERRIDES))
    n, n_nodes, dim = frames.shape
    cnf = _cnf(cfg, n_nodes)
    pos = jnp.asarray(frames, jnp.float32)
    x = (pos - jnp.mean(pos, axis=1, keepdims=True)).reshape(n, n_nodes * dim)
    feats = jnp.tile(jnp.arange(n_nodes, dtype=jnp.int32), (n, 1))
    template = cnf.init(jax.random.PRNGKey(0), x[:2], jnp.zeros(2), feats[:2])
    solve = SolveConfig(
        use_fixed_step_size=cfg.training.use_fixed_step_size, method=cfg.training.ode_method,
        hutchinson_probes=cfg.training.hutchinson_probes,
    )
    score = jax.jit(lambda p: get_log_prob(cnf, p, x, jax.random.PRNGKey(0), feats, cfg=solve)[0])
    return {
        name: [float(v) for v in np.asarray(score(restore_serving_params(checkpoint, template, ema)))]
        for name, ema in (("params", False), ("ema_params", True))
    }


def make(out: Path) -> dict:
    """Write the checkpoint, ``frames.npy`` and ``expected.json`` under
    ``out``; returns what ``expected.json`` holds."""
    cfg = load_config(str(REPO / CONFIG))
    _, _, test = load_aldp(
        test_path=str(REPO / cfg.target.test_path), test_n_points=FRAMES[1] - FRAMES[0],
        test_skip_n=FRAMES[0],
    )
    frames = np.asarray(test.positions, np.float32)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "frames.npy", frames)
    state = _state(cfg, frames.shape[1])
    checkpoint = save_checkpoint(str(out / "model_checkpoints"), ITERATION, state)
    restored = restore_checkpoint(checkpoint, state)
    expected = {
        "command": COMMAND,
        "config": CONFIG,
        "checkpoint": f"model_checkpoints/state_{ITERATION:08d}",
        "frames": list(FRAMES),
        "score_overrides": list(SCORE_OVERRIDES),
        "leaves": leaf_digests(restored),
        "log_p": jax_log_p(checkpoint, frames),
    }
    (out / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    return expected


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    jax.config.update("jax_platforms", "cpu")
    make(parser.parse_args().out)
