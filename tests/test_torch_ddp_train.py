"""The port's data-parallel train step on two gloo ranks against the JAX
package's sharded step and against itself on one process, on the CPU.

- Injected noise: three updates of JAX ``make_update_fn(mesh=get_mesh())``
  (its 8-device CPU mesh), with x0 and t replayed from its key chain as in
  `test_torch_train.py`, against the port's ``make_update_fn(mesh=...)`` on
  two ranks, each fed its rows of x and features and the whole batch's x0
  and t (of which the update keeps the rank's rows); microbatch 1 and
  2, EMA on; `test_torch_train.py`'s f32 bands (loss, ``grad_norm``,
  ``update_norm`` rtol 1e-5; params 5e-6 and EMA 1e-6 absolute).
- Drawn noise: the same steps with x0 and t drawn from the state's
  generator equal the single-process steps on the same seed (same bands;
  the x0 the ranks used, gathered, is the single process's bit for bit),
  and the two ranks' rows of x0 differ.
- After every run both ranks hold bit-equal parameters and EMA (their
  checksums, all-gathered).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as worker
import torch_parity as tp
from ecnf_tpu.parallel.mesh import get_mesh
from ecnf_tpu.training.optim import build_optimizer as jax_build_optimizer
from ecnf_tpu.training.state import TrainingState as JaxState
from ecnf_tpu.training.state import make_update_fn as jax_make_update_fn
from ecnf_tpu_torch.training import optim
from ecnf_tpu_torch.training import state as state_mod
from test_torch_train import EMA_ATOL, LR, PARAM_ATOL, RTOL, _data, _draws, _max_abs, _tree

B, STEPS, SEED = 8, 3, 11
MICROBATCHES = (1, 2)
INFO = ("loss", "grad_norm", "update_norm")


@pytest.fixture(scope="module")
def pair():
    return tp.make_pair(seed=3)


@pytest.fixture(scope="module")
def steps(pair):
    """Per microbatch, the JAX update's inputs and its x0 and t draws."""
    jax_cnf = pair[0]
    out = {}
    for mb in MICROBATCHES:
        key = jax.random.PRNGKey(5)
        out[mb] = []
        for step in range(STEPS):
            x, feats = _data(10 + step)
            key, x0, t = _draws(jax_cnf, key, mb)
            out[mb].append(dict(x=x, feats=feats, x0=x0, t=t))
    return out


@pytest.fixture(scope="module")
def ranks(pair, steps, tmp_path_factory):
    cnf = pair[2]
    spec = dict(
        cnf_kwargs=tp.cnf_kwargs(2, (32, 32)), state_dict=cnf.field.state_dict(), lr=LR,
        seed=SEED,
        steps={mb: [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()} for s in ss]
               for mb, ss in steps.items()},
    )
    for ss in spec["steps"].values():
        for s in ss:
            s["feats"] = s["feats"].long()
    return worker.launch("train", 2, tmp_path_factory.mktemp("ddp_train"), spec)


@pytest.mark.parametrize("mb", MICROBATCHES)
def test_injected_steps_match_jax_sharded_step(pair, steps, ranks, mb):
    jax_cnf, jax_params, _ = pair
    jax_opt = jax_build_optimizer(LR)
    params = jax.tree_util.tree_map(jnp.copy, jax_params)
    jax_state = JaxState(params=params, opt_state=jax_opt.init(params), key=jax.random.PRNGKey(5),
                         ema_params=jax.tree_util.tree_map(jnp.copy, jax_params))
    update = jax_make_update_fn(jax_cnf, jax_opt, use_ema=True, mesh=get_mesh(), microbatch=mb)
    port = ranks[f"mb{mb}_injected"]
    for i, step in enumerate(steps[mb]):
        jax_state, jax_info = update(jax_state, jnp.asarray(step["x"]), jnp.asarray(step["feats"]))
        for j, name in enumerate(INFO):
            np.testing.assert_allclose(port["info"][i, j].item(), float(jax_info[name]), rtol=RTOL,
                                       err_msg=f"{name} at step {i}")
    assert _max_abs(port["params"], _tree(jax_state.params)) <= PARAM_ATOL
    assert _max_abs(port["ema"], _tree(jax_state.ema_params)) <= EMA_ATOL


def _single_process(cnf, steps, mb):
    """The port's step in one process on drawn noise, and per step the x0
    it drew (its chunks joined in row order)."""
    drawn = []

    def sample_base(shape, generator=None, noise=None):
        return drawn.append(cnf.sample_base(shape, generator=generator, noise=noise)) or drawn[-1]

    recording = cnf._replace(sample_base=sample_base)
    opt = optim.build_optimizer(LR)
    state = state_mod.init_training_state(cnf, opt, torch.Generator().manual_seed(SEED),
                                          use_ema=True)
    update = state_mod.make_update_fn(recording, opt, use_ema=True, microbatch=mb)
    infos = []
    for step in steps:
        state, info = update(state, *tp.to_torch(step["x"], step["feats"]))
        infos.append([info[k].item() for k in INFO])
    return state, np.array(infos), torch.stack([torch.cat(drawn[i:i + mb])
                                                for i in range(0, len(drawn), mb)])


@pytest.mark.parametrize("mb", MICROBATCHES)
def test_drawn_noise_two_ranks_equal_one_process(pair, steps, ranks, mb):
    cnf = pair[2]
    state_dict = {k: v.clone() for k, v in cnf.field.state_dict().items()}
    try:
        state, infos, x0 = _single_process(cnf, steps[mb], mb)
    finally:
        cnf.field.load_state_dict(state_dict)
    port = ranks[f"mb{mb}_drawn"]
    np.testing.assert_allclose(port["info"].numpy(), infos, rtol=RTOL)
    assert _max_abs(port["params"], state.params) <= PARAM_ATOL
    assert _max_abs(port["ema"], state.ema_params) <= EMA_ATOL
    assert x0.shape == (STEPS, B, tp.N * tp.DIM)
    assert torch.equal(port["x0"], x0)


@pytest.mark.parametrize("mb", MICROBATCHES)
def test_ranks_draw_different_rows(ranks, mb):
    x0 = ranks[f"mb{mb}_drawn"]["x0"]
    half = B // 2
    for step in x0:
        assert not torch.equal(step[:half], step[half:])
        assert (step[:half] - step[half:]).abs().max() > 0.1


def test_ranks_hold_bit_equal_parameters(ranks):
    for key in ("mb1_injected", "mb1_drawn", "mb2_injected", "mb2_drawn"):
        sums = ranks[key]["checksums"]
        assert sums.shape == (2,) and sums[0] == sums[1], (key, sums)
