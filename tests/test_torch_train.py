"""The ported flow-matching train step against the JAX package, on the CPU.

Small sizes (2 EGNN blocks of [32, 32], N=5, B=8), the weights of
`torch_parity.make_pair`, and x0 and t drawn by replaying the JAX update's
own key chain with ``jax.random`` and injected into the port: ``key,
subkey = split(key)``; unchunked, ``split(subkey)`` -> (x0 key, t key);
with ``microbatch=k``, ``split(subkey, k)`` and one such pair per chunk.

Bands, f32: loss, ``grad_norm`` and ``update_norm`` rtol 1e-5; each gradient
leaf within 1e-5 of that leaf's largest |g|; new params within
``PARAM_ATOL`` and the EMA within ``EMA_ATOL`` (absolute).  Adam's first
direction is ``g / (|g| + 1e-8)``, so a component whose |g| is near 1e-8
may move by up to 2 lr between two correct implementations whose
gradients agree to 1e-6 of scale.  These inputs' smallest nonzero |g| is
~1e-8 and moves its component by ~1e-3 lr (~1e-6 at lr 1e-3), so
``PARAM_ATOL`` is 5e-3 lr = 5e-6.  The EMA starts at the shared weights,
so it differs by f32 rounding of O(1) values plus 1e-3 of the params'
difference: ``EMA_ATOL`` 1e-6.  bf16: loss and ``grad_norm`` rtol 3e-2, and
each gradient leaf within 3e-2 of the gradient's largest entry, the port's
bf16 band (XLA keeps excess f32 precision inside fused chains; the port
rounds at each op).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf.loss import flow_matching_loss_fn as jax_loss_fn
from ecnf_tpu.training.optim import build_optimizer as jax_build_optimizer
from ecnf_tpu.training.state import TrainingState as JaxState
from ecnf_tpu.training.state import make_update_fn as jax_make_update_fn
from ecnf_tpu_torch.cnf.build import build_cnf as build_torch_cnf
from ecnf_tpu_torch.convert import from_flax, to_flax
from ecnf_tpu_torch.training import optim
from ecnf_tpu_torch.training.setup import epoch
from ecnf_tpu_torch.training.state import (
    global_norm,
    init_training_state,
    loss_and_grads,
    make_update_fn,
)

REPO = Path(__file__).resolve().parent.parent
B = 8
LR = 1e-3
PARAM_ATOL = 5e-3 * LR
EMA_ATOL = 1e-6
RTOL = 1e-5
BF16_BAND = 3e-2

OPTIMIZERS = {
    "adam": dict(init_lr=LR),
    # Warmup 1 then a cosine over 2 counts: three updates see lr(0..2).
    "adam_schedule": dict(init_lr=1e-4, use_schedule=True, peak_lr=LR, end_lr=1e-5,
                          n_iter_warmup=1, n_iter_total=3),
    "adamw": dict(init_lr=LR, optimizer_name="adamw"),
}


def _draws(jax_cnf, key, k, batch=B):
    """The JAX update's x0 and t for one step, and the key it leaves."""
    key, sub = jax.random.split(key)
    subs = [sub] if k in (None, 1) else list(jax.random.split(sub, k))
    x0s, ts = [], []
    for s in subs:
        k1, k2 = jax.random.split(s)
        x0s.append(jax_cnf.sample_base(k1, (batch // len(subs),)))
        ts.append(jax.random.uniform(k2, shape=(batch // len(subs),)))
    return key, np.array(jnp.concatenate(x0s)), np.array(jnp.concatenate(ts))


def _tree(tree):
    """A JAX parameter tree as the port's state dict."""
    return from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _data(seed, zero_features=False):
    x, _, feats = tp.inputs(batch=B, seed=seed)
    if zero_features:
        feats = np.zeros_like(feats)  # embedding row 1 unused: zero gradient
    return x, feats


def _max_abs(port, ref):
    return max((port[name] - ref[name]).abs().max().item() for name in ref)


@pytest.mark.parametrize("warmup,total", [(5, 20), (0, 10), (50, 10), (0, 1)],
                         ids=["warmup", "no_warmup", "clamped", "one_step"])
def test_schedule_matches_optax(warmup, total):
    init, peak, end = 1e-4, 2e-3, 1e-5
    port = optim.learning_rate(init, True, peak, end, warmup, total)
    ref = optax.warmup_cosine_decay_schedule(
        init, peak, warmup_steps=min(warmup, max(total - 1, 0)), decay_steps=total, end_value=end
    )
    for count in range(total + 3):
        expect = float(ref(jnp.asarray(count, jnp.int32)))
        assert abs(port(count) - expect) <= 1e-6 * peak, count
    assert optim.learning_rate(3e-4) == 3e-4


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    # Five updates on fixed random leaves: the transform alone, in f32.
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), ()]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    ref = jax_build_optimizer(**OPTIMIZERS[name])
    port = optim.build_optimizer(**OPTIMIZERS[name])
    ref_state = ref.init([jnp.asarray(p) for p in params])
    port_state = port.init([torch.from_numpy(p) for p in params])
    for g in grads:
        ref_u, ref_state = ref.update([jnp.asarray(x) for x in g], ref_state,
                                      [jnp.asarray(p) for p in params])
        port_u, port_state = port.update([torch.from_numpy(x) for x in g], port_state,
                                         [torch.from_numpy(p) for p in params])
        for a, b in zip(port_u, ref_u):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
    assert port_state.count == 5


@pytest.mark.parametrize("microbatch,zero_features", [(None, False), (4, True)],
                         ids=["unchunked", "mb4_unused_embedding_row"])
def test_gradients_match_jax(microbatch, zero_features):
    jax_cnf, jax_params, cnf = tp.make_pair(seed=3)
    x, feats = _data(3, zero_features)
    key = jax.random.PRNGKey(5)
    _, x0, t = _draws(jax_cnf, key, microbatch)
    # JAX: the mean of the chunk gradients, each chunk on its own key.
    _, sub = jax.random.split(key)
    k = microbatch or 1
    subs = [sub] if k == 1 else list(jax.random.split(sub, k))
    rows = B // k
    grads, losses = [], []
    for i, s in enumerate(subs):
        g, info = jax.grad(jax_loss_fn, argnums=1, has_aux=True)(
            jax_cnf, jax_params, jnp.asarray(x[i * rows:(i + 1) * rows]), s,
            jnp.asarray(feats[i * rows:(i + 1) * rows]),
        )
        grads.append(g)
        losses.append(float(info["loss"]))
    ref = _tree(jax.tree_util.tree_map(lambda *gs: sum(gs) / k, *grads))

    params = {n: p.detach().clone() for n, p in cnf.field.named_parameters()}
    port, loss = loss_and_grads(cnf, params, *tp.to_torch(x, feats), microbatch,
                                x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    np.testing.assert_allclose(loss.item(), np.mean(losses), rtol=RTOL)
    for name, g in zip(params, port):
        scale = ref[name].abs().max().item()
        assert (g - ref[name]).abs().max().item() <= RTOL * scale, name
    by_name = dict(zip(params, port))
    last = "egnn.blocks.1.phi_h.layers.0.weight"  # feeds nothing
    assert by_name[last].abs().max().item() == 0.0 == ref[last].abs().max().item()
    if zero_features:
        assert by_name["embed.weight"][1].abs().max().item() == 0.0
        assert ref["embed.weight"][1].abs().max().item() == 0.0


UPDATE_CASES = [
    ("adam", True, None, 3),
    ("adam", False, 4, 1),
    ("adam", True, 4, 3),
    ("adam_schedule", True, None, 3),
    ("adam_schedule", False, 4, 3),
    ("adamw", False, None, 3),
    ("adamw", True, 4, 1),
]


@pytest.mark.parametrize("opt_name,use_ema,microbatch,steps", UPDATE_CASES,
                         ids=[f"{o}-ema{int(e)}-mb{m or 1}-{s}step" for o, e, m, s in UPDATE_CASES])
def test_updates_match_jax(opt_name, use_ema, microbatch, steps):
    jax_cnf, jax_params, cnf = tp.make_pair(seed=3)
    jax_opt = jax_build_optimizer(**OPTIMIZERS[opt_name])
    jax_state = JaxState(
        params=jax_params, opt_state=jax_opt.init(jax_params), key=jax.random.PRNGKey(5),
        ema_params=jax.tree_util.tree_map(jnp.copy, jax_params) if use_ema else None,
    )
    jax_update = jax_make_update_fn(jax_cnf, jax_opt, use_ema=use_ema, microbatch=microbatch)
    opt = optim.build_optimizer(**OPTIMIZERS[opt_name])
    state = init_training_state(cnf, opt, torch.Generator(), use_ema=use_ema)
    update = make_update_fn(cnf, opt, use_ema=use_ema, microbatch=microbatch)
    key = jax_state.key
    for step in range(steps):
        x, feats = _data(10 + step)
        key, x0, t = _draws(jax_cnf, key, microbatch)
        jax_state, jax_info = jax_update(jax_state, jnp.asarray(x), jnp.asarray(feats))
        state, info = update(state, *tp.to_torch(x, feats), x0=torch.from_numpy(x0),
                             t=torch.from_numpy(t))
        assert set(info) == {"loss", "grad_norm", "update_norm"}
        for name in info:
            np.testing.assert_allclose(info[name].item(), float(jax_info[name]), rtol=RTOL,
                                       err_msg=f"{name} at step {step}")
        assert _max_abs(state.params, _tree(jax_state.params)) <= PARAM_ATOL, step
        if use_ema:
            assert _max_abs(state.ema_params, _tree(jax_state.ema_params)) <= EMA_ATOL, step
        else:
            assert state.ema_params is None
    assert state.opt_state.count == steps


def test_bf16_loss_and_gradients_match_jax():
    jax_cnf, jax_params, cnf = tp.make_pair(cdt="bfloat16", seed=4)
    x, feats = _data(4)
    key = jax.random.PRNGKey(6)
    _, x0, t = _draws(jax_cnf, key, None)
    _, sub = jax.random.split(key)
    g, info = jax.grad(jax_loss_fn, argnums=1, has_aux=True)(
        jax_cnf, jax_params, jnp.asarray(x), sub, jnp.asarray(feats)
    )
    ref = _tree(g)
    params = {n: p.detach().clone() for n, p in cnf.field.named_parameters()}
    port, loss = loss_and_grads(cnf, params, *tp.to_torch(x, feats),
                                x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    assert all(p.dtype == torch.float32 for p in port)
    assert abs(loss.item() - float(info["loss"])) <= BF16_BAND * abs(float(info["loss"]))
    ref_norm = float(optax.global_norm(g))
    assert abs(global_norm(port).item() - ref_norm) <= BF16_BAND * ref_norm
    # Scale: the gradient's largest entry over all leaves.  A leaf's own
    # largest entry is no scale here: a bias gradient sums B N^2 bf16 terms
    # that cancel, and small leaves (the gates') differ by up to ~11% of
    # their own largest entry while staying within 0.5% of the gradient's.
    scale = max(r.abs().max().item() for r in ref.values())
    for name, grad in zip(params, port):
        assert (grad - ref[name]).abs().max().item() <= BF16_BAND * scale, name


def test_microbatch_one_is_the_unchunked_step_bit_for_bit():
    _, _, cnf = tp.make_pair(seed=5)
    x, feats = tp.to_torch(*_data(5))
    opt = optim.build_optimizer(LR)
    outs = []
    for microbatch in (1, None):
        state = init_training_state(cnf, opt, torch.Generator().manual_seed(7), use_ema=True)
        update = make_update_fn(cnf, opt, use_ema=True, microbatch=microbatch)
        for _ in range(2):
            state, info = update(state, x, feats)
        outs.append((state, info))
    (s1, i1), (s2, i2) = outs
    for name in s1.params:
        assert torch.equal(s1.params[name], s2.params[name])
        assert torch.equal(s1.ema_params[name], s2.ema_params[name])
    for name in i1:
        assert torch.equal(i1[name], i2[name])


def test_update_leaves_the_old_state_alone():
    _, _, cnf = tp.make_pair(seed=5)
    x, feats = tp.to_torch(*_data(6))
    opt = optim.build_optimizer(LR)
    state = init_training_state(cnf, opt, torch.Generator().manual_seed(1), use_ema=True)
    before = {n: p.clone() for n, p in state.params.items()}
    for name, p in cnf.field.named_parameters():
        assert state.ema_params[name].data_ptr() != state.params[name].data_ptr()
        assert p.data_ptr() != state.params[name].data_ptr()
    new, _ = make_update_fn(cnf, opt, use_ema=True)(state, x, feats)
    for name in before:
        assert torch.equal(state.params[name], before[name])
        assert torch.equal(state.ema_params[name], before[name])
        # The last block's gate and phi_h feed nothing and keep their values.
        feeds_nothing = "blocks.1.phi_h" in name or "blocks.1.gate" in name
        assert torch.equal(new.params[name], before[name]) == feeds_nothing, name
    with pytest.raises(ValueError, match="divisible"):
        make_update_fn(cnf, opt, microbatch=3)(state, x, feats)


def test_epoch_matches_jax_minibatch_order():
    jax_cnf, jax_params, cnf = tp.make_pair(seed=6)
    n, batch = 20, 8  # two minibatches; the last 4 samples are dropped
    rng = np.random.default_rng(6)
    pos = rng.normal(size=(n, tp.N * tp.DIM)).astype(np.float32)
    feats = np.tile(np.arange(tp.N) % tp.N_FEATURES, (n, 1)).astype(np.int32)

    # JAX `_epoch` (training/setup.py): split the key, permute, drop the
    # remainder, scan the update over the minibatches.
    jax_opt = jax_build_optimizer(LR)
    jax_update = jax_make_update_fn(jax_cnf, jax_opt)
    jax_state = JaxState(jax_params, jax_opt.init(jax_params), jax.random.PRNGKey(8))
    key, sub = jax.random.split(jax_state.key)
    perm = np.asarray(jax.random.permutation(sub, n)[: 2 * batch])
    jax_state = jax_state._replace(key=key)
    jax_losses = []
    draws = []
    for i in range(2):
        idx = perm[i * batch:(i + 1) * batch]
        key, x0, t = _draws(jax_cnf, key, None, batch)
        draws.append((idx, x0, t))
        jax_state, info = jax_update(jax_state, jnp.asarray(pos[idx]), jnp.asarray(feats[idx]))
        jax_losses.append(float(info["loss"]))

    opt = optim.build_optimizer(LR)
    update = make_update_fn(cnf, opt)
    seen = []

    def replayed(state, xb, fb):
        idx, x0, t = draws[len(seen)]
        seen.append(xb.clone())
        np.testing.assert_array_equal(fb.numpy(), feats[idx])
        return update(state, xb, fb, x0=torch.from_numpy(x0), t=torch.from_numpy(t))

    state = init_training_state(cnf, opt, torch.Generator())
    state, infos = epoch(state, replayed, *tp.to_torch(pos, feats), batch,
                         perm=torch.from_numpy(np.array(jax.random.permutation(sub, n))))
    for xb, (idx, _, _) in zip(seen, draws):
        np.testing.assert_array_equal(xb.numpy(), pos[idx])
    assert {k: v.shape for k, v in infos.items()} == {k: (2,) for k in ("loss", "grad_norm", "update_norm")}
    np.testing.assert_allclose(infos["loss"].numpy(), jax_losses, rtol=RTOL)
    assert _max_abs(state.params, _tree(jax_state.params)) <= PARAM_ATOL


def test_epoch_draws_its_permutation_from_the_state_generator():
    _, _, cnf = tp.make_pair(seed=6)
    rng = np.random.default_rng(2)
    pos = torch.from_numpy(rng.normal(size=(11, tp.N * tp.DIM)).astype(np.float32))
    feats = torch.zeros((11, tp.N), dtype=torch.int64)
    opt = optim.build_optimizer(LR)
    update = make_update_fn(cnf, opt)
    runs = []
    for _ in range(2):
        state = init_training_state(cnf, opt, torch.Generator().manual_seed(4))
        runs.append(epoch(state, update, pos, feats, 4))
    (s1, i1), (s2, i2) = runs
    assert i1["loss"].shape == (2,) and torch.isfinite(i1["loss"]).all()
    torch.testing.assert_close(i1["loss"], i2["loss"], rtol=0, atol=0)
    for name in s1.params:
        torch.testing.assert_close(s1.params[name], s2.params[name], rtol=0, atol=0)


def test_loss_decreases_on_a_fixed_batch():
    # `chip_smoke.py`'s train phase (c) on the CPU: LJ13 width, bf16, the
    # seeded init, 50 updates of Adam 1e-3 through `epoch` over a dataset of
    # one batch of 48.  The mean of the last 5 losses falls below LOSS_FALL
    # of the first 5 (0.81-0.84 over five seeds).
    smoke = _chip_smoke()
    q = smoke.LJ13_TRAIN
    cnf = build_torch_cnf(
        n_frames=q["n"], dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=q["blocks"],
        mlp_units=q["units"], n_invariant_feat_hidden=q["hidden"], time_embedding_dim=8,
        n_features=1, compute_dtype="bfloat16", device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(q["batch"], q["n"] * 3)).astype(np.float32))
    feats = torch.zeros((q["batch"], q["n"]), dtype=torch.int64)
    opt = optim.build_optimizer(LR)
    state = init_training_state(cnf, opt, torch.Generator().manual_seed(0))
    update = make_update_fn(cnf, opt, microbatch=2)
    losses = []
    for _ in range(smoke.LJ13_UPDATES):
        state, infos = epoch(state, update, x, feats, q["batch"])
        losses.append(infos["loss"].item())
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < smoke.LOSS_FALL * np.mean(losses[:5])


def test_trained_weights_score_the_same_in_jax():
    # A few port updates, then params and EMA exported with `to_flax`; the
    # JAX field on those trees equals the port's field (f32, atol 1e-6).
    jax_cnf, _, cnf = tp.make_pair(seed=8)
    opt = optim.build_optimizer(LR)
    state = init_training_state(cnf, opt, torch.Generator().manual_seed(3), use_ema=True)
    update = make_update_fn(cnf, opt, use_ema=True, microbatch=2)
    for step in range(3):
        state, _ = update(state, *tp.to_torch(*_data(20 + step)))
    x, t, feats = tp.inputs(batch=B, seed=9)
    for tree in (state.params, state.ema_params):
        out_jax = jax_cnf.apply(
            jax.tree_util.tree_map(jnp.asarray, to_flax(tree)),
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(feats),
        )
        cnf.field.load_state_dict(tree)
        with torch.no_grad():
            out = cnf.apply(*tp.to_torch(x, t, feats))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_jax), rtol=0, atol=1e-6)


def test_build_optimizer_rejects_unknown_names_and_missing_totals():
    with pytest.raises(ValueError, match="optimizer"):
        optim.build_optimizer(LR, optimizer_name="sgd")
    with pytest.raises(ValueError, match="n_iter_total"):
        optim.build_optimizer(LR, use_schedule=True, peak_lr=LR, end_lr=0.0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
