"""The port's DW4 and LJ13 loaders against the JAX package's on the same
files: the reference's original blobs and the regenerated layouts, split
for split, exactly.  The mixing gate refuses stuck chains, and the port
never reads the JAX package's regenerations (``*_generated.npy``)."""
import numpy as np
import pytest
import torch

from ecnf_tpu.targets import data as jax_data
from ecnf_tpu_torch.targets import data

torch.set_num_threads(1)


def _assert_same_splits(ours, ref):
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.positions.numpy(), np.asarray(r.positions))
        np.testing.assert_array_equal(o.features.numpy(), np.asarray(r.features))
        assert o.positions.dtype == torch.float32


def _write_dw4_blob(d, n):
    flat = np.random.default_rng(0).normal(size=(n, 8))
    np.save(d / "dw4-dataidx.npy", flat[None])


@pytest.mark.parametrize("layout", ["blob", "regenerated"])
@pytest.mark.parametrize("sizes", [(1000, 1000, 1000), (40, 30, 20), (7, 0, 5)])
def test_load_dw4_matches_jax(tmp_path, layout, sizes):
    train, val, test = sizes
    if layout == "blob":
        _write_dw4_blob(tmp_path, 2600)
    else:
        regen = np.random.default_rng(1).normal(size=(2600, 4, 2))
        np.save(tmp_path / "dw4_generated.npy", regen)
        np.save(tmp_path / data.DW4_CACHE, regen)
    ours = data.load_dw4(train, val, test, path=tmp_path, device="cpu")
    ref = jax_data.load_dw4(train, val, test, path=tmp_path)
    _assert_same_splits(ours, ref)


@pytest.mark.parametrize("layout", ["blob", "regenerated"])
@pytest.mark.parametrize("train", [1000, 37])
def test_load_lj13_matches_jax(tmp_path, layout, train):
    rng = np.random.default_rng(2)
    if layout == "blob":
        np.save(tmp_path / "holdout_data_LJ13.npy", rng.normal(size=(1200, 39)))
        np.save(tmp_path / "idx_LJ13.npy", rng.permutation(1200)[:1100])
        np.save(tmp_path / "all_data_LJ13.npy", rng.normal(size=(2100, 39)))
    else:
        regen = rng.normal(size=(3050, 13, 3))
        np.save(tmp_path / "lj13_generated.npy", regen)
        np.save(tmp_path / data.LJ13_CACHE, regen)
    ours = data.load_lj13(train, path=tmp_path, device="cpu")
    ref = jax_data.load_lj13(train, path=tmp_path)
    _assert_same_splits(ours, ref)


def test_full_graph_sample_indexing():
    pos = torch.arange(24.0).reshape(3, 4, 2)
    sample = data.positional_dataset_only_to_full_graph(pos)
    assert sample.features.shape == (3, 4, 1) and sample.features.dtype == torch.int32
    assert not sample.features.any()
    part = sample[:2]
    assert torch.equal(part.positions, pos[:2]) and part.features.shape == (2, 4, 1)


def test_gate_refuses_stuck_chains():
    rng = np.random.default_rng(3)
    stuck = rng.normal(size=(8 * 100, 4, 2))
    stuck[:100] += 7.0
    log_prob = lambda x: -(x**2).sum((-1, -2))
    with pytest.raises(AssertionError, match="did not converge"):
        data._gate_on_mixing("TEST", stuck, n_chains=8, log_prob_fn=log_prob)
    mixed = rng.normal(size=(8 * 100, 4, 2))
    report = data._gate_on_mixing("TEST", mixed, n_chains=8, log_prob_fn=log_prob)
    assert report["rhat_energy"] < 1.05 and report["ess_dist"] > 80


@pytest.mark.parametrize("name", ["dw4", "lj13"])
def test_never_reads_the_jax_regeneration(tmp_path, monkeypatch, name):
    """With only the JAX package's cache present, the port regenerates its
    own (stubbed here) instead of reading it."""
    shape = (2600, 4, 2) if name == "dw4" else (3050, 13, 3)
    np.save(tmp_path / f"{name}_generated.npy", np.zeros(shape))
    calls = []

    def regenerate(path, device):
        calls.append(path)
        raise RuntimeError("regenerate")

    monkeypatch.setattr(data, f"_generate_{name}_data", regenerate)
    with pytest.raises(RuntimeError, match="regenerate"):
        getattr(data, f"load_{name}")(path=tmp_path, device="cpu")
    assert calls == [tmp_path / f"{name}_generated_torch.npy"]


def test_loaders_refuse_the_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.load_dw4(path=tmp_path)
