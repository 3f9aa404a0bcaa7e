"""The port's QM9 data pipeline (`targets/qm9.py`, `data.py: load_qm9`,
`synthetic_qm9.py`) against the JAX package's, on the CPU, with nothing
downloaded.

- `gen_splits_gdb9` equal on one exclusion file, at GDB9's sizes and at
  the miniature fixture's.
- The whole `qm9pos_download_and_save_data` on the GDB9-format fixture of
  `tests/test_qm9_end_to_end.py`, its download replaced by a copy of the
  fixture in both packages: the port's ``qm9pos_*.npy`` byte for byte
  JAX's, with ``remove_h`` false and true.
- The port's parser and JAX's (Python) parser agree on one GDB9 record,
  ``*^`` exponent included.  JAX's side always parses with its Python
  parser; its native library is the JAX package's build.
- `load_qm9`'s marker guard refuses and admits for the same inputs and
  ``ECNF_ALLOW_SYNTHETIC_QM9`` values as JAX's, and refuses before any
  download.
- The stand-ins of `targets/synthetic_qm9.py` are byte for byte those of
  `scripts/make_synthetic_qm9.py`.
"""
import io
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

import ecnf_tpu.targets.native as jax_native
import ecnf_tpu.targets.qm9 as jax_qm9
from ecnf_tpu.targets import data as jax_data
from ecnf_tpu_torch.targets import data, qm9, synthetic_qm9
from test_qm9_end_to_end import N_EXCL, N_MOLS, N_TRAIN, _xyz_bytes

REPO = Path(__file__).resolve().parent.parent
XYZ = _xyz_bytes(3)  # a 19-atom record with one '*^' coordinate


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    """The GDB9-format fixture: a tarball of N_MOLS xyz records and an
    exclusion list of molecules 1..N_EXCL."""
    src = tmp_path_factory.mktemp("gdb9_fixture")
    tar_path = src / "dsgdb9nsd.xyz.tar.bz2"
    with tarfile.open(tar_path, "w:bz2") as tar:
        for i in range(N_MOLS):
            record = _xyz_bytes(i)
            info = tarfile.TarInfo(name=f"dsgdb9nsd_{i + 1:06d}.xyz")
            info.size = len(record)
            tar.addfile(info, io.BytesIO(record))
    excl_path = src / "uncharacterized.txt"
    lines = ["header line\n", "\n"] + [f"{i}  6.2  other fields\n" for i in range(1, N_EXCL + 1)]
    excl_path.write_text("".join(lines + ["footer\n"]))
    return tar_path, excl_path


@pytest.fixture(autouse=True)
def jax_python_parser(monkeypatch):
    """JAX's side parses with its Python parser: its native library is the
    JAX package's own build, which its tests cover."""
    monkeypatch.setattr(jax_native, "get_parser", lambda: None)


@pytest.fixture()
def mini_constants(monkeypatch):
    for module in (jax_qm9, qm9):
        monkeypatch.setattr(module, "N_GDB9", N_MOLS)
        monkeypatch.setattr(module, "N_EXCLUDED", N_EXCL)
        monkeypatch.setattr(module, "N_TRAIN", N_TRAIN)


def _copy_download(monkeypatch, module, fixture_files):
    """Replace ``module._download`` by a copy of the fixture; returns the
    list of URLs it was asked for."""
    tar_src, excl_src = fixture_files
    asked = []

    def copy(url, dest):
        asked.append(url)
        src = tar_src if dest.endswith(".tar.bz2") else excl_src
        Path(dest).write_bytes(Path(src).read_bytes())

    monkeypatch.setattr(module, "_download", copy)
    return asked


def test_splits_match_jax_at_gdb9_sizes(tmp_path):
    rng = np.random.default_rng(0)
    excluded = np.sort(rng.choice(qm9.N_GDB9, qm9.N_EXCLUDED, replace=False)) + 1
    path = tmp_path / "uncharacterized.txt"
    path.write_text("header\n\n" + "".join(f"{i} x y\n" for i in excluded) + "footer\n")
    ours, ref = qm9.gen_splits_gdb9(str(path)), jax_qm9.gen_splits_gdb9(str(path))
    assert set(ours) == set(ref) == {"train", "valid", "test"}
    for split in ref:
        assert ours[split].dtype == ref[split].dtype
        np.testing.assert_array_equal(ours[split], ref[split])
    assert len(ours["train"]) == qm9.N_TRAIN


def test_splits_match_jax_on_the_fixture(fixture_files, mini_constants):
    _, excl = fixture_files
    ours, ref = qm9.gen_splits_gdb9(str(excl)), jax_qm9.gen_splits_gdb9(str(excl))
    for split in ref:
        np.testing.assert_array_equal(ours[split], ref[split])


def test_wrong_exclusion_count_refused(tmp_path):
    path = tmp_path / "uncharacterized.txt"
    path.write_text("1 x\n2 y\n")
    for module in (qm9, jax_qm9):
        with pytest.raises(AssertionError):
            module.gen_splits_gdb9(str(path))


@pytest.mark.parametrize("remove_h", [False, True], ids=["all_atoms", "remove_h"])
def test_pipeline_files_equal_jax(tmp_path, fixture_files, mini_constants, monkeypatch,
                                  remove_h):
    asked_ours = _copy_download(monkeypatch, qm9, fixture_files)
    asked_ref = _copy_download(monkeypatch, jax_qm9, fixture_files)
    ours, ref = tmp_path / "port", tmp_path / "jax"
    qm9.qm9pos_download_and_save_data(str(ours), remove_h=remove_h)
    jax_qm9.qm9pos_download_and_save_data(str(ref), remove_h=remove_h)
    assert asked_ours == asked_ref == [qm9.GDB9_URL_DATA, qm9.GDB9_URL_EXCLUDED]
    suffix = "_no_h" if remove_h else ""
    for split in ("train", "valid", "test"):
        name = f"qm9pos_{split}{suffix}.npy"
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
    arr = np.load(ours / f"qm9pos_train{suffix}.npy")
    assert arr.shape[1:] == ((9, 3) if remove_h else (19, 3)) and len(arr) > 0


def test_parsers_agree_with_jax():
    ours = qm9.process_xyz_gdb9(io.BytesIO(XYZ))
    ref = jax_qm9.process_xyz_gdb9(io.BytesIO(XYZ))
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(value), err_msg=key)
    assert ours["num_atoms"] == 19 and ours["charges"].dtype == np.int64
    assert ours["positions"].dtype == np.float64


def _write_standins(d: Path, marker: bool):
    rng = np.random.default_rng(0)
    for name, n in [("train", 8), ("valid", 4), ("test", 4)]:
        np.save(d / f"qm9pos_{name}.npy", rng.normal(size=(n, 19, 3)).astype(np.float32))
    if marker:
        (d / data.SYNTHETIC_QM9_MARKER).write_text("synthetic stand-in\n")


def _admits(load, monkeypatch, env, **kwargs):
    if env is None:
        monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
    else:
        monkeypatch.setenv("ECNF_ALLOW_SYNTHETIC_QM9", env)
    try:
        train, _, _ = load(**kwargs)
    except RuntimeError as e:
        assert "SYNTHETIC" in str(e)
        return False
    assert tuple(train.positions.shape) == (8, 19, 3)
    return True


ENVS = [None, "", "0", "false", "no", "off", "nope", "1", "true", "TRUE", "yes", "Yes"]


@pytest.mark.parametrize("marker", [True, False], ids=["marked", "unmarked"])
def test_marker_guard_matches_jax(tmp_path, monkeypatch, marker):
    _write_standins(tmp_path, marker)
    decisions = []
    for env in ENVS:
        for allow in (False, True):
            ours = _admits(data.load_qm9, monkeypatch, env, path=tmp_path, allow_synthetic=allow,
                           device="cpu")
            ref = _admits(jax_data.load_qm9, monkeypatch, env, path=tmp_path,
                          allow_synthetic=allow)
            assert ours == ref, (env, allow)
            decisions.append(ours)
    assert all(decisions) if not marker else (not all(decisions) and any(decisions))
    monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
    train, valid, test = data.load_qm9(4, path=tmp_path, allow_synthetic=True, device="cpu")
    ref = np.load(tmp_path / "qm9pos_train.npy")[:4]
    np.testing.assert_array_equal(train.positions.numpy(), ref)
    assert (train.features == 0).all() and tuple(test.positions.shape) == (4, 19, 3)


def test_stale_marker_refuses_before_download(tmp_path, monkeypatch):
    monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
    (tmp_path / data.SYNTHETIC_QM9_MARKER).write_text("stale marker\n")
    monkeypatch.setattr(qm9, "qm9pos_download_and_save_data",
                        lambda **kw: pytest.fail("download attempted behind a marker"))
    with pytest.raises(RuntimeError, match="marker"):
        data.load_qm9(path=tmp_path, device="cpu")


def test_missing_files_run_the_pipeline(tmp_path, monkeypatch):
    calls = []

    def fake_pipeline(base_path):
        calls.append(base_path)
        _write_standins(Path(base_path), marker=False)

    monkeypatch.setattr(qm9, "qm9pos_download_and_save_data", fake_pipeline)
    train, _, _ = data.load_qm9(path=tmp_path, device="cpu")
    assert calls == [str(tmp_path)] and tuple(train.positions.shape) == (8, 19, 3)


def test_synthetic_standins_equal_the_script(tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "script"
    shapes = synthetic_qm9.write_synthetic_qm9(ours)
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_synthetic_qm9.py"), str(ref)],
                   check=True, capture_output=True, timeout=120)
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in ours.iterdir())
    assert data.SYNTHETIC_QM9_MARKER in names and len(names) == 4
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
    assert shapes == {s: (n, 19, 3) for s, n in synthetic_qm9.SIZES.items()}
