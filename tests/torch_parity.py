"""Shared set-up of the PyTorch port's parity tests (`tests/test_torch_*.py`).

Both packages get the same numpy weights and the same numpy inputs.  At
flax init the network's share of the exact trace is tiny (the phi_x output
kernel starts at ``variance_scaling(0.001)``), so ``div - offset`` would be
~0.5% of the analytic offset and a parity test on raw ``div`` could not see
a wrong phi path.  `make_pair` therefore redraws every Dense kernel at
``N(0, 1/fan_in)`` (and every bias at ``N(0, 0.1^2)``) from a numpy seed
before handing the tree to both packages, which makes the network trace
O(1).

On such weights the time ConcatDense reads the fastest pair of the time
embedding, ``sin/cos(1000 t)`` (period 0.006 in t), at full strength, and
an adaptive solve takes ~150 attempts.  ``make_pair(..., slow=True)``
zeroes the two rows of each time ConcatDense kernel that read that pair
(the slower frequencies stay), which brings the solve to ~15 attempts.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ecnf_tpu.cnf.build import build_cnf as build_jax_cnf
from ecnf_tpu_torch.cnf.build import build_cnf as build_torch_cnf
from ecnf_tpu_torch.convert import from_flax

# Tier-1 runs several pytest workers at once; one thread each keeps them
# from oversubscribing the host.
torch.set_num_threads(1)

N, DIM, H, T, B = 5, 3, 16, 8, 6
N_FEATURES = 2


def cnf_kwargs(blocks, units, cdt=None, n=N, dim=DIM):
    return dict(
        n_frames=n, dim=dim, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=blocks, mlp_units=tuple(units),
        n_invariant_feat_hidden=H, time_embedding_dim=T,
        n_features=N_FEATURES, compute_dtype=cdt,
    )


def redraw(tree, seed: int):
    """Every ``kernel`` -> N(0, 1/fan_in), every ``bias`` -> N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                out[key] = walk(value)
            elif key == "kernel":
                out[key] = rng.normal(0.0, 1.0 / np.sqrt(value.shape[0]), value.shape)
            elif key == "bias":
                out[key] = rng.normal(0.0, 0.1, value.shape)
            else:
                out[key] = np.asarray(value, dtype=np.float64)
        return out

    return walk(tree)


def inputs(n=N, dim=DIM, batch=B, seed=0):
    """``x [B, n*dim]``, ``t [B]``, integer ``feats [B, n]`` as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, n * dim)).astype(np.float32)
    t = np.linspace(0.1, 0.9, batch).astype(np.float32)
    feats = np.tile(np.arange(n) % N_FEATURES, (batch, 1)).astype(np.int32)
    return x, t, feats


@functools.lru_cache(maxsize=None)
def _flax_tree(blocks, units, n, dim):
    cnf = build_jax_cnf(**cnf_kwargs(blocks, units, n=n, dim=dim))
    x, t, feats = inputs(n, dim, batch=2)
    params = jax.jit(cnf.init)(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t), jnp.asarray(feats)
    )
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def slow_time(tree, h=H, t=T):
    """Zero the time-ConcatDense rows that read ``sin/cos(1000 t)``: rows
    ``h`` and ``h + t/2`` of each ``EGNN_0/ConcatDense_i`` kernel (``h``
    hidden invariant features, a time embedding of ``t``)."""
    egnn = tree["params"]["EGNN_0"]
    for name, layer in egnn.items():
        if name.startswith("ConcatDense_"):
            layer["kernel"][[h, h + t // 2]] = 0.0
    return tree


def make_pair(blocks=2, units=(32, 32), cdt=None, seed=0, n=N, dim=DIM, slow=False):
    """``(jax_cnf, jax_params, torch_cnf)`` sharing one redrawn weight set
    (`slow_time` applied when ``slow``)."""
    tree = redraw(_flax_tree(blocks, tuple(units), n, dim), seed)
    if slow:
        tree = slow_time(tree)
    jax_cnf = build_jax_cnf(**cnf_kwargs(blocks, units, cdt, n, dim))
    jax_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    torch_cnf = build_torch_cnf(**cnf_kwargs(blocks, units, cdt, n, dim), device="cpu")
    torch_cnf.field.load_state_dict(from_flax(tree))
    return jax_cnf, jax_params, torch_cnf


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def jax_training_state(use_ema=True, n_features=1, seed=0):
    """``(jax_cnf, optimizer, state)``: a JAX ``TrainingState`` of
    `init_training_state` at the small widths (2 blocks of [32, 32]), its
    params redrawn with ``seed`` and its EMA (``use_ema``) with ``seed + 1``,
    both with `slow_time`, and Adam's state ``optimizer.init`` of the params."""
    import optax

    from ecnf_tpu.training.state import init_training_state

    jax_cnf = build_jax_cnf(**dict(cnf_kwargs(2, (32, 32)), n_features=n_features))
    optimizer = optax.adam(1e-3)
    x = jnp.zeros((2, N * DIM))
    feats = jnp.zeros((2, N), jnp.int32)
    state = init_training_state(jax_cnf, optimizer, jax.random.PRNGKey(seed), x, feats, use_ema)
    tree = jax.tree_util.tree_map(np.asarray, state.params)

    def redrawn(s):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), slow_time(redraw(tree, s)))

    params = redrawn(seed)
    ema = redrawn(seed + 1) if use_ema else None
    return jax_cnf, optimizer, state._replace(params=params, ema_params=ema, opt_state=optimizer.init(params))
