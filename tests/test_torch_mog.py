"""The MoG slice of the port (`targets/mog.py`, `cnf/base.py: DiagGaussian`,
`models/vector_net.py`, `cnf/build.py: build_mlp_cnf`, `examples/mog.py`)
against the JAX package, on the CPU.

- `MoGTarget`'s means (JAX's threefry stream, computed in numpy) and
  scales equal JAX's bit for bit for seeds 0-3, and so does `jax_uniform`
  on other shapes and ranges; ``log_prob`` within 1e-6 relative.
- `DiagGaussian.log_prob` within 1e-6 relative.
- `VectorNet` on flax weights carried over by `convert.from_flax` (every
  kernel redrawn at N(0, 1/fan_in), biases at N(0, 0.1^2), as
  `torch_parity.redraw` does): the field within 1e-5 of its largest entry
  (f32 sums in another order, and XLA's and torch's tanh-GELU); the
  flow-matching loss with injected x0 and t within 1e-5 relative; one
  AdamW update equal to JAX `make_update_fn` within the bands of
  `tests/test_torch_train.py` (info rtol 1e-5, params 5e-3 lr).
- `get_log_prob` at `SolveConfig()`, exact and Hutchinson with injected
  probes, within the f32 bands of `tests/test_torch_adaptive.py` (log p
  3e-4 relative, step counts within 2 accepted steps and 4 attempts).  As
  there, the time layers' rows that read ``sin/cos(1000 t)`` are zeroed,
  which keeps the solves short.
- `examples/mog.py` trains 2 iterations at a small size and logs the three
  metrics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf.base import DiagGaussian as JaxDiagGaussian
from ecnf_tpu.cnf import sampling as jax_sampling
from ecnf_tpu.cnf.build import build_mlp_cnf as build_jax_mlp_cnf
from ecnf_tpu.cnf.loss import flow_matching_loss_fn as jax_loss_fn
from ecnf_tpu.ops import ode as jax_ode
from ecnf_tpu.targets.mog import MoGTarget as JaxMoGTarget
from ecnf_tpu.training.optim import build_optimizer as jax_build_optimizer
from ecnf_tpu.training.state import TrainingState as JaxState
from ecnf_tpu.training.state import make_update_fn as jax_make_update_fn
from ecnf_tpu_torch.cnf.base import DiagGaussian
from ecnf_tpu_torch.cnf.build import build_mlp_cnf
from ecnf_tpu_torch.cnf.loss import flow_matching_loss_fn
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob
from ecnf_tpu_torch.convert import from_flax, to_flax
from ecnf_tpu_torch.examples import mog
from ecnf_tpu_torch.targets.mog import MoGTarget, jax_uniform
from ecnf_tpu_torch.training import optim
from ecnf_tpu_torch.training.loop import run_training
from ecnf_tpu_torch.training.state import init_training_state, make_update_fn

B, DIM, EMB = 16, 2, 8
FEATURES = (32, 32)
FIELD_REL = 1e-5
RTOL = 1e-5
LR = 1e-3
PARAM_ATOL = 5e-3 * LR
STEP_SLACK, ATTEMPT_SLACK = 2, 4
LOG_P_REL = 3e-4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_target_matches_jax(seed):
    jax_target, target = JaxMoGTarget(seed=seed), MoGTarget(seed=seed)
    for name in ("means", "scales"):
        ref = np.asarray(getattr(jax_target, name))
        out = getattr(target, name).numpy()
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32), err_msg=name)
    x = np.random.default_rng(seed).normal(scale=6.0, size=(64, DIM)).astype(np.float32)
    np.testing.assert_allclose(target.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_target.log_prob(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (7, (5, 3, 4), -2.0, 3.0), (123456, (1000,), 0.0, 1.0), (3, (64, 7), -10.0, 0.5),
    (2**32 - 1, (3,), -1.0, 1.0),
])
def test_jax_uniform_matches_jax(seed, shape, lo, hi):
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
    np.testing.assert_array_equal(jax_uniform(seed, shape, lo, hi).view(np.uint32),
                                  ref.view(np.uint32))


def test_target_samples_lie_on_the_components():
    target = MoGTarget()
    x = target.sample((4000,), torch.Generator().manual_seed(0))
    assert x.shape == (4000, DIM)
    nearest = torch.cdist(x, target.means).min(dim=1).values
    assert nearest.max().item() < 8 * target.scales[0, 0].item()
    assert torch.equal(x, target.sample((4000,), torch.Generator().manual_seed(0)))


def test_diag_gaussian_matches_jax():
    x = np.random.default_rng(1).normal(scale=4.0, size=(32, 3)).astype(np.float32)
    for scale in (1.0, 5.0):
        ref = np.asarray(JaxDiagGaussian(dim=3, scale=scale).log_prob(jnp.asarray(x)))
        out = DiagGaussian(dim=3, scale=scale).log_prob(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6)
    noise = torch.from_numpy(x)
    torch.testing.assert_close(DiagGaussian(3, 5.0).sample((32,), noise=noise), 5.0 * noise)


def _slow_time(tree, in_widths):
    """Zero the rows of each hidden ConcatDense kernel that read
    ``sin/cos(1000 t)``: rows ``w`` and ``w + EMB/2`` after its ``w`` input
    rows."""
    for i, w in enumerate(in_widths):
        tree["params"][f"ConcatDense_{i}"]["kernel"][[w, w + EMB // 2]] = 0.0
    return tree


def _pair(seed=0, slow=False):
    """``(jax_cnf, jax_params, torch_cnf)`` of the MoG CNF sharing one
    redrawn weight set."""
    jax_cnf = build_jax_mlp_cnf(dim=DIM, sigma_min=1e-4, base_scale=5.0, features=FEATURES,
                                embedding_dim=EMB)
    init = jax.jit(jax_cnf.init)(jax.random.PRNGKey(1), jnp.zeros((2, DIM)), jnp.zeros(2))
    tree = tp.redraw(jax.tree_util.tree_map(np.asarray, init), seed)
    if slow:
        tree = _slow_time(tree, (DIM,) + FEATURES[:-1])
    cnf = build_mlp_cnf(dim=DIM, sigma_min=1e-4, base_scale=5.0, features=FEATURES,
                        embedding_dim=EMB, device="cpu")
    cnf.field.load_state_dict(from_flax(tree))
    jax_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return jax_cnf, jax_params, cnf


def _points(seed, batch=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=5.0, size=(batch, DIM)).astype(np.float32)
    t = np.linspace(0.05, 0.95, batch).astype(np.float32)
    return x, t


def test_converter_round_trip():
    _, jax_params, cnf = _pair(seed=2)
    back = to_flax(cnf.field)
    flat = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(flat) == 2 * (len(FEATURES) + 1)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert set(cnf.field.state_dict()) == set(from_flax(back))


@pytest.mark.parametrize("features,emb", [(FEATURES, EMB), ((512, 512, 512), 32)],
                         ids=["small", "mog_default"])
def test_field_matches_flax(features, emb):
    jax_cnf = build_jax_mlp_cnf(dim=DIM, sigma_min=1e-4, base_scale=5.0, features=features,
                                embedding_dim=emb)
    init = jax.jit(jax_cnf.init)(jax.random.PRNGKey(1), jnp.zeros((2, DIM)), jnp.zeros(2))
    tree = tp.redraw(jax.tree_util.tree_map(np.asarray, init), 3)
    cnf = build_mlp_cnf(dim=DIM, sigma_min=1e-4, base_scale=5.0, features=features,
                        embedding_dim=emb, device="cpu")
    cnf.field.load_state_dict(from_flax(tree))
    x, t = _points(4)
    ref = np.asarray(jax_cnf.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                   jnp.asarray(t)))
    with torch.no_grad():
        out = cnf.apply(*tp.to_torch(x, t)).numpy()
    assert np.abs(out - ref).max() <= FIELD_REL * np.abs(ref).max()


def test_loss_matches_jax():
    jax_cnf, jax_params, cnf = _pair(seed=5)
    x, _ = _points(6)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    x0 = np.array(jax_cnf.sample_base(k1, (B,)))
    t = np.array(jax.random.uniform(k2, shape=(B,)))
    ref, _ = jax_loss_fn(jax_cnf, jax_params, jnp.asarray(x), key)
    loss, _ = flow_matching_loss_fn(cnf, *tp.to_torch(x), x0=torch.from_numpy(x0),
                                    t=torch.from_numpy(t))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=RTOL)


def test_adamw_update_matches_jax():
    jax_cnf, jax_params, cnf = _pair(seed=8)
    jax_opt = jax_build_optimizer(LR, use_schedule=False, optimizer_name="adamw")
    jax_state = JaxState(params=jax_params, opt_state=jax_opt.init(jax_params),
                         key=jax.random.PRNGKey(9))
    x, _ = _points(10)
    key, sub = jax.random.split(jax_state.key)
    k1, k2 = jax.random.split(sub)
    x0 = np.array(jax_cnf.sample_base(k1, (B,)))
    t = np.array(jax.random.uniform(k2, shape=(B,)))
    jax_state, jax_info = jax_make_update_fn(jax_cnf, jax_opt)(jax_state, jnp.asarray(x), None)

    opt = optim.build_optimizer(LR, use_schedule=False, optimizer_name="adamw")
    state = init_training_state(cnf, opt, torch.Generator())
    state, info = make_update_fn(cnf, opt)(state, torch.from_numpy(x), None,
                                           x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    for name in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(info[name].item(), float(jax_info[name]), rtol=RTOL,
                                   err_msg=name)
    ref = from_flax(jax.tree_util.tree_map(np.asarray, jax_state.params))
    assert max((state.params[n] - ref[n]).abs().max().item() for n in ref) <= PARAM_ATOL


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "hutchinson"])
def test_get_log_prob_matches_jax(approx):
    jax_cnf, jax_params, cnf = _pair(seed=11, slow=True)
    x, _ = _points(12)
    eps = np.random.default_rng(13).normal(size=(B, DIM)).astype(np.float32)
    func = jax_sampling._augmented_field(jax_cnf, jax_params, None, approx,
                                         jnp.asarray(eps) if approx else None,
                                         jax_sampling.SolveConfig())
    y0 = np.concatenate([x, np.zeros((B, 1), np.float32)], axis=1)
    y1, jax_stats = jax_ode.odeint_adaptive(func, jnp.asarray(y0), 1.0, 0.0)
    y1 = np.asarray(y1)
    ref = np.asarray(jax_cnf.log_prob_base(jnp.asarray(y1[:, :-1]))) + y1[:, -1]

    log_p, base, delta, stats = get_log_prob(
        cnf, torch.from_numpy(x), approx=approx, cfg=SolveConfig(),
        eps=torch.from_numpy(eps) if approx else None, return_stats=True,
    )
    assert torch.isfinite(log_p).all()
    np.testing.assert_allclose(log_p.numpy(), ref, rtol=LOG_P_REL)
    torch.testing.assert_close(log_p, base + delta, rtol=0, atol=0)
    assert abs(stats.num_steps - int(jax_stats.num_steps)) <= STEP_SLACK
    assert abs(stats.num_attempts - int(jax_stats.num_attempts)) <= ATTEMPT_SLACK


def test_mog_example_trains_and_logs_its_metrics():
    tc = mog.setup_mog_training(n_train=256, n_test=16, n_iteration=2, n_eval=1,
                                features=FEATURES, device="cpu")
    assert tc.n_checkpoints == 0 and not tc.save
    logger, state = run_training(tc)
    h = logger.history
    assert len(h["loss"]) == 2 * (256 // 64) and np.isfinite(h["loss"]).all()
    for name in ("test_log_lik", "test_kl", "test_approx_log_lik"):
        assert len(h[name]) == 2 and np.isfinite(h[name]).all(), name
    assert h["iteration"][0] == -1.0 and h["iteration"][-1] == 1.0
    assert state.opt_state.count == 2 * (256 // 64)
