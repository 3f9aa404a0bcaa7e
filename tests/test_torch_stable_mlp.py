"""The port's `StableMLP` and the EGNN built on it (``network.stable_mlp``)
against the JAX package, on the CPU.

Small sizes: 2 blocks of [16, 16], hidden 8, N=4, the weights of
`torch_parity.make_pair(stable=True)` (LayerNorm scales redrawn too).
Bands: f32 forward atol 1e-6; bf16 rtol 3e-2 of the output's largest
entry (the port's bf16 band: XLA keeps excess f32 precision inside fused
chains); a StableMLP under bf16 runs its LayerNorm blocks in f32, as
flax promotes them, so its f32 blocks are held at 1e-6; the train step's
bands are `test_torch_train.py`'s; log p of the exact rk4 solve rel 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf.sampling import SolveConfig as JaxSolveConfig
from ecnf_tpu.cnf.sampling import get_log_prob as jax_get_log_prob
from ecnf_tpu.models.mlp import StableMLP as FlaxStableMLP
from ecnf_tpu.training.optim import build_optimizer as jax_build_optimizer
from ecnf_tpu.training.state import TrainingState as JaxState
from ecnf_tpu.training.state import make_update_fn as jax_make_update_fn
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob
from ecnf_tpu_torch.convert import flatten, from_flax, to_flax
from ecnf_tpu_torch.models.mlp import LayerNorm, StableMLP
from ecnf_tpu_torch.training import optim
from ecnf_tpu_torch.training.state import init_training_state, make_update_fn

N, HIDDEN, UNITS, BLOCKS = 4, 8, (16, 16), 2
F32_ATOL = 1e-6
BF16_BAND = 3e-2


def stable_pair(cdt=None, seed=0, slow=False):
    return tp.make_pair(BLOCKS, UNITS, cdt, seed=seed, n=N, slow=slow, stable=True, hidden=HIDDEN)


def _flax_mlp(units, activate_final, dtype, widths, seed):
    """A flax StableMLP over inputs of ``widths``, its redrawn parameters,
    and the port's StableMLP holding them."""
    mod = FlaxStableMLP(units, activate_final=activate_final, dtype=dtype)
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(3, 5, w)).astype(np.float32) for w in widths]
    params = mod.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs))
    tree = tp.redraw(jax.tree_util.tree_map(np.asarray, params["params"]), seed)
    port = StableMLP(widths, units, activate_final=activate_final,
                     compute_dtype=None if dtype is None else torch.bfloat16)
    state = {}
    for path, value in flatten(tree).items():
        value = torch.tensor(np.asarray(value, np.float32))
        parts = path.split("/")
        if parts[0] == "ConcatDense_0":
            name = f"first.{'weight' if parts[1] == 'kernel' else 'bias'}"
        elif parts[0] == "Dense_0":
            name = f"out.{'weight' if parts[1] == 'kernel' else 'bias'}"
        else:
            k = parts[0].rsplit("_", 1)[1]
            if parts[1] == "LayerNorm_0":
                name = f"residual.{k}.norm.{parts[2]}"
            else:
                name = f"residual.{k}.dense.{'weight' if parts[2] == 'kernel' else 'bias'}"
        state[name] = value.T.contiguous() if parts[-1] == "kernel" else value
    port.load_state_dict(state)
    jax_params = {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)}
    return mod, jax_params, port, xs


@pytest.mark.parametrize("activate_final", [True, False], ids=["activate_final", "output_dense"])
def test_stable_mlp_forward_matches_flax_f32(activate_final):
    mod, params, port, xs = _flax_mlp((16, 16, 16) if activate_final else (16, 16, 8),
                                      activate_final, None, (6, 6, 1), seed=1)
    ref = np.asarray(mod.apply(params, *map(jnp.asarray, xs)))
    out = port(*map(torch.from_numpy, xs)).detach().numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=F32_ATOL)


@pytest.mark.parametrize("activate_final", [True, False], ids=["activate_final", "output_dense"])
def test_stable_mlp_bf16_promotes_its_layernorm_blocks_to_f32(activate_final):
    units = (16, 16, 16) if activate_final else (16, 16, 8)
    mod, params, port, xs = _flax_mlp(units, activate_final, jnp.bfloat16, (6, 6, 1), seed=2)
    ref = mod.apply(params, *map(jnp.asarray, xs))
    out = port(*map(torch.from_numpy, xs))
    # flax: the residual blocks meet f32 parameters and promote; only the
    # first ConcatDense and the output Dense run in bf16.
    expect = jnp.float32 if activate_final else jnp.bfloat16
    assert ref.dtype == expect
    assert out.dtype == (torch.float32 if activate_final else torch.bfloat16)
    ref = np.asarray(ref, np.float32)
    out = out.float().detach().numpy()
    assert np.abs(out - ref).max() <= BF16_BAND * np.abs(ref).max()
    # The residual blocks alone, on the same bf16 input: f32 to 1e-6.
    x = port.first(*map(torch.from_numpy, xs))
    h = torch.nn.functional.silu(x)
    block = jax.tree_util.tree_map(np.asarray, params["params"]["NonLinearLayerWithResidualAndLayerNorm_0"])
    from ecnf_tpu.models.mlp import NonLinearLayerWithResidualAndLayerNorm as FlaxBlock

    hj = jnp.asarray(h.float().detach().numpy()).astype(jnp.bfloat16)
    ref_block = FlaxBlock(units[0]).apply({"params": block}, hj)
    out_block = port.residual[0](h)
    assert ref_block.dtype == jnp.float32 and out_block.dtype == torch.float32
    np.testing.assert_allclose(out_block.detach().numpy(), np.asarray(ref_block), atol=F32_ATOL)


def test_layernorm_matches_flax():
    from flax import linen as nn

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(7, 16)) * 3 + 5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    ref = nn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    norm = LayerNorm(16)
    norm.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    # Mean 5, sd 3: E[x^2] - E[x]^2 cancels ~4x, so the f32 sums' order
    # shows; 1e-6 of the output's largest entry.
    ref = np.asarray(ref)
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=F32_ATOL * np.abs(ref).max())
    assert norm.epsilon == 1e-6


@pytest.mark.parametrize("init", ["default", "zero", "variance_scaling"])
def test_output_inits_match_flax_distributions(init):
    kw = {"zero": dict(zero_init_output=True),
          "variance_scaling": dict(output_variance_scaling=0.5)}.get(init, {})
    width, out = 256, 128
    mod = FlaxStableMLP((width, width, out), **kw)
    flax_k = np.asarray(mod.init(jax.random.PRNGKey(0), jnp.zeros((1, width)))["params"]
                        ["Dense_0"]["kernel"])
    port = StableMLP((width,), (width, width, out), **kw)
    port.out.reset_parameters(torch.Generator().manual_seed(0))
    port_k = port.out.weight.detach().numpy().T
    assert port_k.shape == flax_k.shape
    if init == "zero":
        assert not port_k.any() and not flax_k.any()
        return
    # Same law: the same bound and a standard deviation within 3%.
    assert abs(port_k.std() / flax_k.std() - 1) < 0.03
    assert abs(np.abs(port_k).max() / np.abs(flax_k).max() - 1) < 0.03
    if init == "variance_scaling":
        limit = np.sqrt(3 * 0.5 / ((width + out) / 2))
        assert np.abs(port_k).max() <= limit and np.abs(flax_k).max() <= limit


def test_stable_mlp_checks_its_widths():
    with pytest.raises(ValueError, match="constant width"):
        StableMLP((4,), (16, 8, 8))
    with pytest.raises(ValueError, match="single linear layer"):
        StableMLP((4,), (16,))
    with pytest.raises(ValueError, match="activate_final"):
        StableMLP((4,), (16, 16), activate_final=True, zero_init_output=True)
    with pytest.raises(AssertionError):  # the JAX module's own check
        FlaxStableMLP((16, 8, 8)).init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_field_matches_jax(cdt):
    jax_cnf, jax_params, cnf = stable_pair(cdt)
    x, t, feats = tp.inputs(N, tp.DIM, batch=6)
    ref = np.asarray(jax_cnf.apply(jax_params, *map(jnp.asarray, (x, t, feats))))
    out = cnf.apply(*tp.to_torch(x, t, feats)).detach().numpy()
    if cdt is None:
        np.testing.assert_allclose(out, ref, atol=F32_ATOL)
    else:
        assert np.abs(out - ref).max() <= BF16_BAND * np.abs(ref).max()
    assert cnf.tangent_value_and_div is None and cnf.fused_value_and_div is None
    assert cnf.trace_weights is None and cnf.fused_weights is None


def test_egnn_block_matches_jax():
    """One EGCL block with StableMLPs, called directly in both packages."""
    from ecnf_tpu.models.egnn import EGCL as FlaxEGCL

    jax_cnf, jax_params, cnf = stable_pair(seed=4)
    rng = np.random.default_rng(4)
    vectors = rng.normal(size=(3, N, 3)).astype(np.float32)
    h = rng.normal(size=(3, N, HIDDEN)).astype(np.float32)
    block = jax_params["params"]["EGNN_0"]["EGCL_0"]
    ref_v, ref_h = FlaxEGCL(UNITS, HIDDEN, stable_mlp=True).apply({"params": block},
                                                                  jnp.asarray(vectors), jnp.asarray(h))
    out_v, out_h = cnf.field.egnn.blocks[0](torch.from_numpy(vectors), torch.from_numpy(h))
    np.testing.assert_allclose(out_v.detach().numpy(), np.asarray(ref_v), atol=F32_ATOL)
    np.testing.assert_allclose(out_h.detach().numpy(), np.asarray(ref_h), atol=F32_ATOL)


def test_converter_round_trips_stable_parameters():
    tree = tp.redraw(tp._flax_tree(BLOCKS, UNITS, N, tp.DIM, True, HIDDEN), 7)
    state = from_flax(tree)
    _, _, cnf = stable_pair()
    assert sorted(state) == sorted(cnf.field.state_dict())
    cnf.field.load_state_dict(state)
    back = flatten(to_flax(cnf.field))
    orig = flatten(tree)
    assert sorted(back) == sorted(orig)
    for path in orig:
        assert np.array_equal(back[path], np.asarray(orig[path], np.float32)), path
    names = {p.split("/")[-2] for p in orig if "StableMLP_" in p}
    assert names == {"ConcatDense_0", "Dense_0", "LayerNorm_0"}
    assert "egnn.blocks.1.phi_e.residual.0.norm.scale" in state
    assert "egnn.blocks.1.phi_h.out.weight" in state


def test_update_step_matches_jax():
    """One Adam step with EMA at microbatch 1: `test_torch_train.py`'s bands."""
    from test_torch_train import EMA_ATOL, PARAM_ATOL, RTOL, _draws, _max_abs, _tree

    jax_cnf, jax_params, cnf = stable_pair(seed=3)
    jax_opt = jax_build_optimizer(init_lr=1e-3)
    jax_state = JaxState(params=jax_params, opt_state=jax_opt.init(jax_params),
                         key=jax.random.PRNGKey(5),
                         ema_params=jax.tree_util.tree_map(jnp.copy, jax_params))
    x, _, feats = tp.inputs(N, tp.DIM, batch=8, seed=10)
    _, x0, t = _draws(jax_cnf, jax_state.key, None, batch=8)
    jax_state, jax_info = jax_make_update_fn(jax_cnf, jax_opt, use_ema=True)(
        jax_state, jnp.asarray(x), jnp.asarray(feats))
    opt = optim.build_optimizer(1e-3)
    state = init_training_state(cnf, opt, torch.Generator(), use_ema=True)
    state, info = make_update_fn(cnf, opt, use_ema=True)(
        state, *tp.to_torch(x, feats), x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    for name in info:
        np.testing.assert_allclose(info[name].item(), float(jax_info[name]), rtol=RTOL, err_msg=name)
    assert _max_abs(state.params, _tree(jax_state.params)) <= PARAM_ATOL
    assert _max_abs(state.ema_params, _tree(jax_state.ema_params)) <= EMA_ATOL


def test_exact_log_prob_matches_jax():
    jax_cnf, jax_params, cnf = stable_pair(seed=6, slow=True)
    x, _, feats = tp.inputs(N, tp.DIM, batch=4, seed=6)
    x = x - x.reshape(4, N, 3).mean(axis=1, keepdims=True).repeat(N, 1).reshape(4, -1)
    jcfg = JaxSolveConfig(use_fixed_step_size=True, method="rk4", step_size=0.25)
    ref = jax_get_log_prob(jax_cnf, jax_params, jnp.asarray(x), jax.random.PRNGKey(0),
                           jnp.asarray(feats), cfg=jcfg)
    cfg = SolveConfig(use_fixed_step_size=True, method="rk4", step_size=0.25)
    out = get_log_prob(cnf, *tp.to_torch(x, feats), cfg=cfg)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
