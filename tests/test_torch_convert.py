"""Weight bridge (`ecnf_tpu_torch/convert.py`) and the port's own init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf.build import build_cnf as build_jax_cnf
from ecnf_tpu_torch import sample
from ecnf_tpu_torch.cnf.build import build_cnf as build_torch_cnf
from ecnf_tpu_torch.convert import from_flax, to_flax


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_roundtrip_is_identity_on_flax_init():
    tree = tp._flax_tree(3, (32, 32), tp.N, tp.DIM)
    cnf = build_torch_cnf(**tp.cnf_kwargs(3, (32, 32)), device="cpu")
    cnf.field.load_state_dict(from_flax(tree))
    back = _flat(to_flax(cnf.field))
    ref = _flat(tree)
    assert sorted(back) == sorted(ref)
    for path, value in ref.items():
        assert back[path].shape == value.shape, path
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def test_flat_npz_keys_and_entry_point(tmp_path):
    # The entry point serves weights exported from the JAX package as a
    # flat "/"-keyed npz; they must land in the field unchanged.
    tree = tp.redraw(tp._flax_tree(2, (32, 32), tp.N, tp.DIM), seed=5)
    emb = tree["params"]["Embed_0"]
    emb["embedding"] = emb["embedding"][:1]  # the entry point has one node type
    flat = {k: np.asarray(v, np.float32) for k, v in _flat(tree).items()}
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    with np.load(path) as npz:
        state = from_flax(npz)
    assert state["egnn.final_scaling"].shape == ()
    for name, value in from_flax(tree).items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0)

    argv = [
        "--n-nodes", str(tp.N), "--n-samples", "3", "--batch-size", "3",
        "--with-log-prob", "--dtype", "float32", "--n-blocks", "2",
        "--mlp-units", "32", "32", "--hidden", str(tp.H), "--step-size", "0.5",
        "--device", "cpu", "--params-npz", str(path),
    ]
    args = sample.build_parser().parse_args(argv)
    cnf = sample.build_from_args(args, torch.device("cpu"))
    for name, value in cnf.field.state_dict().items():
        torch.testing.assert_close(value, state[name], rtol=0, atol=0)
    out = sample.main(argv + ["--output", str(tmp_path / "x.npy")])
    assert out["samples"].shape == (3, tp.N * tp.DIM)
    assert np.isfinite(out["log_q"]).all()
    assert np.load(tmp_path / "x.npy").shape == (3, tp.N, tp.DIM)


def test_unknown_parameter_raises():
    with pytest.raises(KeyError):
        from_flax({"params": {"EGNN_0": {"Conv_0": {"kernel": np.zeros((2, 2))}}}})


def test_seeded_init_matches_flax_std_at_lj13_width():
    kw = dict(
        n_frames=13, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=3,
        mlp_units=(128, 128, 128), n_invariant_feat_hidden=64,
        time_embedding_dim=8, n_features=1,
    )
    jcnf = build_jax_cnf(**kw)
    x = jnp.zeros((2, 39))
    params = jax.jit(jcnf.init)(jax.random.PRNGKey(0), x, jnp.zeros(2), jnp.zeros((2, 13), jnp.int32))
    ref = _flat(jax.device_get(params))
    port = _flat(to_flax(build_torch_cnf(**kw, device="cpu", generator=torch.Generator().manual_seed(0)).field))
    checked = 0
    for path, value in ref.items():
        assert port[path].shape == value.shape, path
        if path.endswith("kernel") and value.size >= 1000:
            np.testing.assert_allclose(port[path].std(), value.std(), rtol=0.1, err_msg=path)
            checked += 1
        elif path.endswith("bias"):
            np.testing.assert_array_equal(port[path], 0.0)
    # Per block: 3 phi_e + 3 phi_x + 4 phi_h kernels; plus the time ConcatDense.
    assert checked == 3 * (1 + 10)
    np.testing.assert_array_equal(port["params/EGNN_0/final_scaling"], 1.0)
