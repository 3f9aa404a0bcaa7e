"""The port's reader of the JAX package's Orbax checkpoints
(`ecnf_tpu_torch.training.ocdbt`, `training.orbax`) and its serving restore
(`training.checkpoints.restore_serving_params`), on checkpoints that JAX's
`save_checkpoint` writes into ``tmp_path``.

The OCDBT store's keys and raw values equal tensorstore's; every leaf of
`read_orbax_tree` equals JAX ``restore_checkpoint``'s bit for bit (dtype,
shape and bytes); the serving parameters equal JAX
``restore_serving_params``'s after `from_flax`.  The committed fixture
``tests/torch_fixtures/jax_aldp`` is regenerated and held to its
``expected.json``.
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

import chip_smoke
import torch_make_jax_checkpoint as fixture
import torch_parity as tp
from ecnf_tpu.parallel.mesh import data_sharded, get_mesh
from ecnf_tpu.training import checkpoints as jax_ckpt
from ecnf_tpu.training.state import make_update_fn
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.training import checkpoints
from ecnf_tpu_torch.training.ocdbt import OcdbtStore, crc32c
from ecnf_tpu_torch.training.orbax import read_orbax_tree

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "jax_aldp"


def port_leaves(tree, path=()):
    """``{"/"-joined path: numpy leaf}`` of a tree of `read_orbax_tree` (None
    leaves dropped, as `jax.tree_util` drops them)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {} if tree is None else {"/".join(path): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(port_leaves(v, path + (str(k),)))
    return out


def jax_leaves(tree):
    return {
        "/".join(fixture._key_name(e) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def assert_same_leaves(port_tree, jax_tree):
    ours, theirs = port_leaves(port_tree), jax_leaves(jax_tree)
    assert sorted(ours) == sorted(theirs)
    for name, ref in theirs.items():
        got = ours[name]
        if ref.dtype == jnp.bfloat16:
            ref = ref.view(np.uint16)  # the reader gives bfloat16 as its bits
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert got.tobytes() == ref.tobytes(), name


def assert_store_matches_tensorstore(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    keys = sorted(kv.list().result())
    store = OcdbtStore(str(path))
    assert store.keys() == keys and keys
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key


def _save(root, tree, step=7):
    return jax_ckpt.save_checkpoint(str(root), step, tree)


@pytest.mark.parametrize("case", ["ema", "no_ema", "after_update"])
def test_training_state_reads_bit_equal_to_jax_restore(tmp_path, case):
    cnf, optimizer, state = tp.jax_training_state(use_ema=case != "no_ema")
    if case == "after_update":
        update = make_update_fn(cnf, optimizer, use_ema=True)
        x = jnp.asarray(np.random.default_rng(0).normal(size=(8, tp.N * tp.DIM)), jnp.float32)
        state, _ = update(state, x, jnp.zeros((8, tp.N), jnp.int32))
        assert int(state.opt_state[0].count) == 1
    path = _save(tmp_path, state)
    assert checkpoints.is_orbax_checkpoint(path)
    assert checkpoints.get_latest_checkpoint(str(tmp_path)) == path
    assert_store_matches_tensorstore(path)
    tree = read_orbax_tree(path)
    assert_same_leaves(tree, jax_ckpt.restore_checkpoint(path, state))
    assert set(tree) == {"params", "opt_state", "key", "ema_params"}
    if case == "no_ema":
        assert tree["ema_params"] is None and read_orbax_tree(path, ("ema_params",)) is None
    # A prefix decodes only its subtree, and gives what the whole tree holds.
    sub = read_orbax_tree(path, ("opt_state", "0", "mu"))
    assert_same_leaves(sub, jax_ckpt.restore_checkpoint(path, state).opt_state[0].mu)


def test_data_sharded_array_reads_from_every_chunk(tmp_path):
    mesh = get_mesh()
    assert mesh.devices.size == 8
    x = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(16, 4) * 0.5 - 3.0,
                       data_sharded(mesh))
    tree = {"x": x, "y": jnp.ones((3,), jnp.int32)}
    path = _save(tmp_path, tree)
    keys = OcdbtStore(path).keys()
    assert [k for k in keys if k.startswith(b"x/") and not k.endswith(b".zarray")] == [
        f"x/{i}.0".encode() for i in range(8)
    ]
    assert json.loads(OcdbtStore(path).read("x/.zarray"))["chunks"] == [2, 4]
    assert_store_matches_tensorstore(path)
    assert_same_leaves(read_orbax_tree(path), jax_ckpt.restore_checkpoint(path, tree))


def test_dtypes_scalars_zeros_and_large_arrays(tmp_path):
    rng = np.random.default_rng(3)
    tree = {
        "bf16": jnp.asarray(rng.normal(size=(7, 5)), jnp.bfloat16),
        "i32": jnp.arange(-6, 6, dtype=jnp.int32).reshape(3, 4),
        "u32": jax.random.PRNGKey(11),
        "scalar_f32": jnp.float32(2.75),
        "scalar_i32": jnp.int32(-4),
        "zeros": jnp.zeros((33, 17), jnp.float32),
        # Far above the store's 1024-byte inline limit: an indirect value.
        "large": jnp.asarray(rng.normal(size=(300, 257)), jnp.float32),
        "f64": np.linspace(-1.0, 1.0, 11),
        "i64": np.arange(5, dtype=np.int64) * (1 << 40),
        "bool": np.array([True, False, True]),
        "nested": [{"a": jnp.ones((2,), jnp.float32)}, None],
    }
    path = _save(tmp_path, tree)
    assert_store_matches_tensorstore(path)
    restored = jax_ckpt.restore_checkpoint(path, tree)
    ours = read_orbax_tree(path)
    assert_same_leaves(ours, restored)
    assert ours["nested"][1] is None and ours["bf16"].dtype == np.uint16
    np.testing.assert_array_equal(
        torch.from_numpy(ours["bf16"].view(np.int16)).view(torch.bfloat16).float().numpy(),
        np.asarray(tree["bf16"], np.float32),
    )
    assert len(OcdbtStore(path).read("large/0.0")) > 100_000


def test_interior_nodes_and_inline_values(tmp_path):
    # Small nodes give a B-tree several levels deep; a 16-byte inline limit
    # puts some values inline and the rest in data files.
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 512, "max_inline_value_bytes": 16,
                       "version_tree_arity_log2": 2}}
    kv = ts.KvStore.open(spec).result()
    for commit in range(12):
        txn = ts.Transaction()
        for i in range(40):
            kv.with_transaction(txn)[f"k{commit:02d}/item_{i:04d}".encode()] = b"v%d_" % i * (i % 9)
        txn.commit_async().result()
    assert_store_matches_tensorstore(tmp_path)
    store = OcdbtStore(str(tmp_path))
    assert len(store.keys()) == 480 and store.height >= 2


@pytest.mark.parametrize("ema", [False, True])
def test_serving_params_equal_jax_restore_serving_params(tmp_path, ema):
    _, _, state = tp.jax_training_state(use_ema=True)
    path = _save(tmp_path, state)
    template = jax.tree_util.tree_map(jnp.zeros_like, state.params)
    ref = from_flax(jax.tree_util.tree_map(np.asarray, jax_ckpt.restore_serving_params(path, template, ema)))
    got = checkpoints.restore_serving_params(path, ema=ema)
    assert sorted(got) == sorted(ref)
    for name, t in ref.items():
        assert torch.equal(got[name], t), name
    # With a template: its dtypes and devices, the same values.
    fitted = checkpoints.restore_serving_params(path, {n: torch.zeros_like(t).double() for n, t in ref.items()}, ema)
    assert all(fitted[n].dtype == torch.float64 and torch.equal(fitted[n].float(), ref[n]) for n in ref)
    other = checkpoints.restore_serving_params(path, ema=not ema)
    assert any(not torch.equal(other[n], ref[n]) for n in ref)


def test_missing_ema_raises_the_jax_message(tmp_path):
    _, _, state = tp.jax_training_state(use_ema=False)
    path = _save(tmp_path, state)
    template = jax.tree_util.tree_map(jnp.zeros_like, state.params)
    with pytest.raises(ValueError) as jax_error:
        jax_ckpt.restore_serving_params(path, template, ema=True)
    with pytest.raises(ValueError) as port_error:
        checkpoints.restore_serving_params(path, ema=True)
    assert str(port_error.value) == str(jax_error.value)
    assert "use_ema=false" in str(port_error.value)


def _edit_metadata(path, **changes):
    meta_path = Path(path) / "_METADATA"
    meta = json.loads(meta_path.read_text())
    meta.update(changes)
    meta_path.write_text(json.dumps(meta))


@pytest.mark.parametrize("field,value,match", [("use_zarr3", True, "use_zarr3"),
                                               ("use_ocdbt", False, "use_ocdbt")])
def test_formats_the_jax_package_does_not_write_are_refused(tmp_path, field, value, match):
    _, _, state = tp.jax_training_state()
    path = _save(tmp_path, state)
    _edit_metadata(path, **{field: value})
    with pytest.raises(NotImplementedError, match=match):
        read_orbax_tree(path)
    with pytest.raises(NotImplementedError, match=match):
        checkpoints.restore_serving_params(path)


def test_corrupt_manifest_and_unread_dtype_are_refused(tmp_path):
    path = Path(_save(tmp_path / "a", {"h": jnp.ones((3,), jnp.float16)}))
    with pytest.raises(NotImplementedError, match="dtype '<f2'"):
        read_orbax_tree(str(path))
    manifest = path / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    assert crc32c(bytes(raw[:-4])) == int.from_bytes(raw[-4:], "little")
    raw[20] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(str(path))
    with pytest.raises(ValueError, match="no manifest.ocdbt"):
        OcdbtStore(str(tmp_path))


def test_crc32c_known_value():
    # The CRC-32C check value (RFC 3720 B.4).
    assert crc32c(b"123456789") == 0xE3069283


def test_committed_fixture_reads_as_expected():
    # chip_smoke.py phase 15 (a) makes the same comparison on the card.
    expected = json.loads((FIXTURE / "expected.json").read_text())
    tree = read_orbax_tree(str(FIXTURE / expected["checkpoint"]))
    assert chip_smoke.leaf_digests(tree) == expected["leaves"] and len(expected["leaves"]) == 251
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert size < 1_000_000


def test_regenerated_fixture_equals_the_committed_one(tmp_path):
    committed = json.loads((FIXTURE / "expected.json").read_text())
    fresh = fixture.make(tmp_path)
    assert fresh["leaves"] == committed["leaves"]
    for name in ("params", "ema_params"):
        np.testing.assert_allclose(fresh["log_p"][name], committed["log_p"][name], rtol=1e-6)
    np.testing.assert_array_equal(np.load(tmp_path / "frames.npy"), np.load(FIXTURE / "frames.npy"))
    assert {k: v for k, v in fresh.items() if k not in ("leaves", "log_p")} == {
        k: v for k, v in committed.items() if k not in ("leaves", "log_p")
    }
    shutil.rmtree(tmp_path / "model_checkpoints")


def test_bfloat16_parameters_serve_as_their_exact_float32_values(tmp_path):
    # A bfloat16 leaf comes back as its bits; serving widens it exactly.
    _, _, state = tp.jax_training_state(use_ema=False)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), state.params)
    path = _save(tmp_path, {"params": bf16})
    got = checkpoints.restore_serving_params(path)
    ref = from_flax(jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), bf16))
    assert sorted(got) == sorted(ref) and all(torch.equal(got[n], ref[n]) for n in ref)
