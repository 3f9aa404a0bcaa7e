"""The port's HDF5 reader (`ecnf_tpu_torch/targets/h5.py`) against h5py.

- ``data/aldp_500K_train_mini.h5`` (an mdtraj trajectory written by
  PyTables: chunked, shuffle then deflate, an edge chunk, an object header
  continuation): ``coordinates`` and ``time`` bit for bit, and the exactly
  rounded float64 sum and sum of squares of ``coordinates`` that
  ``chip_smoke.py`` phase 14 (a) holds the reader to on the card (which
  has no h5py).
- Files that h5py writes here: each dataset is read bit for bit or refused
  with `NotImplementedError`, never read wrongly.
"""
import math

import h5py
import numpy as np
import pytest

import chip_smoke
from ecnf_tpu_torch.examples import common
from ecnf_tpu_torch.targets.h5 import read_dataset

H5 = common.CONFIG_DIR.parent.parent / "data" / "aldp_500K_train_mini.h5"


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["coordinates", "time"])
def test_aldp_file_bit_for_bit(name):
    with h5py.File(H5, "r") as f:
        ref = f[name][()]
    assert _same_bits(read_dataset(H5, name), ref)


def test_aldp_coordinate_sums_pinned():
    c = read_dataset(H5, "coordinates").astype(np.float64).ravel()
    assert c.shape == (2000 * 22 * 3,) and np.isfinite(c).all()
    # Squares of f32 values are exact in float64, and fsum rounds once.
    assert (math.fsum(c), math.fsum(c * c)) == chip_smoke.ALDP_H5_SUMS


def test_aldp_topology_string_refused():
    with pytest.raises(NotImplementedError, match="string"):
        read_dataset(H5, "topology")


def test_missing_member_raises_key_error():
    with pytest.raises(KeyError, match="nothing"):
        read_dataset(H5, "nothing")


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "contiguous_f4": dict(data=rng.normal(size=(7, 5, 3)).astype("f4")),
        "contiguous_f8_big_endian": dict(data=rng.normal(size=(11,)).astype(">f8")),
        "contiguous_f2": dict(data=rng.normal(size=(6, 6)).astype("f2")),
        "contiguous_i2": dict(data=rng.integers(-500, 500, size=(9, 4)).astype("i2")),
        "contiguous_u1": dict(data=rng.integers(0, 255, size=(13,)).astype("u1")),
        "scalar": dict(data=np.float32(3.5)),
        "chunked_edge": dict(data=rng.normal(size=(10, 7, 3)).astype("f4"), chunks=(4, 3, 3)),
        "chunked_deep_btree": dict(data=rng.normal(size=(1000,)).astype("f4"), chunks=(3,)),
        "shuffle_deflate": dict(data=rng.normal(size=(50, 22, 3)).astype("f4"), chunks=(16, 22, 3),
                                shuffle=True, compression="gzip", compression_opts=1,
                                maxshape=(None, 22, 3)),
        "gzip_9": dict(data=rng.normal(size=(33, 5)).astype("f8"), chunks=(8, 5),
                       compression="gzip", compression_opts=9),
        "shuffle_i8": dict(data=np.arange(1000, dtype="i8").reshape(100, 10), chunks=(7, 3),
                           shuffle=True),
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "written.h5"
    arrays = _arrays()
    with h5py.File(path, "w") as f:
        for name, kwargs in arrays.items():
            f.create_dataset(name, **kwargs)
        f.create_group("group/inner").create_dataset("x", data=np.arange(5.0))
        for i in range(40):  # more members than one symbol table node holds
            f.create_dataset(f"member_{i}", data=np.arange(i + 1, dtype="f4"))
    refs = {name: np.asarray(kwargs["data"]) for name, kwargs in arrays.items()}
    refs["group/inner/x"] = np.arange(5.0)
    refs.update({f"member_{i}": np.arange(i + 1, dtype="f4") for i in (0, 17, 39)})
    return path, refs


@pytest.mark.parametrize("name", list(_arrays()) + ["group/inner/x", "member_0", "member_17",
                                                    "member_39"])
def test_h5py_written_dataset_bit_for_bit(written, name):
    path, refs = written
    ref = refs[name]
    out = read_dataset(path, name)
    assert _same_bits(out, ref.astype(ref.dtype.newbyteorder("=")))


def _write(path, libver="earliest", **kwargs):
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", **kwargs)


@pytest.mark.parametrize("case,match", [
    (dict(data=np.arange(12.0, dtype="f4").reshape(4, 3), chunks=(2, 3), fletcher32=True),
     "fletcher32"),
    (dict(data=np.arange(10.0), chunks=(3,), compression="lzf"), "lzf"),
    (dict(data=np.arange(10.0), chunks=(3,), libver="latest"), "superblock version 3"),
    (dict(data=np.arange(10.0), libver="v108"), "superblock version 2"),
    (dict(shape=(10,), dtype="f4"), "not allocated"),
    (dict(data=np.array([b"ab", b"cd"])), "string"),
], ids=["fletcher32", "lzf", "libver-latest", "libver-v108", "unallocated", "string"])
def test_unsupported_files_refused(tmp_path, case, match):
    _write(tmp_path / "x.h5", **case)
    with pytest.raises(NotImplementedError, match=match):
        read_dataset(tmp_path / "x.h5", "x")


def test_partly_written_chunks_refused(tmp_path):
    with h5py.File(tmp_path / "x.h5", "w") as f:
        f.create_dataset("x", shape=(10,), dtype="f4", chunks=(3,))[:3] = 1.0
    with pytest.raises(NotImplementedError, match="3 of 4 chunks not allocated"):
        read_dataset(tmp_path / "x.h5", "x")


def test_compact_layout_refused(tmp_path):
    with h5py.File(tmp_path / "x.h5", "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((4,))
        h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F32LE, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype="f4"))
    with pytest.raises(NotImplementedError, match="compact"):
        read_dataset(tmp_path / "x.h5", "x")
