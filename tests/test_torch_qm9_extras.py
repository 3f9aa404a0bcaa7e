"""`ecnf_tpu_torch.targets.qm9_extras` against `ecnf_tpu.targets.qm9_extras`
on the in-memory fixtures of `tests/test_qm9_pipeline.py` (three toy
molecules) and an ``atomref.txt`` written in ``tmp_path``: every function
and method gives the JAX package's arrays bit for bit.  Nothing is
downloaded (``urlretrieve`` raises if called)."""
import urllib.request

import numpy as np
import pytest

from ecnf_tpu.targets import qm9_extras as ref
from ecnf_tpu_torch.targets import qm9_extras as port
from test_qm9_pipeline import _toy_data

ATOMREF = """Table: atom reference energies
   Ele-    ZPVE         U (0 K)      U (298.15 K)    H (298.15 K)    G (298.15 K)     CV
   ment   Hartree       Hartree        Hartree         Hartree         Hartree        Cal/(Mol Kelvin)
   H     0.000000     -0.500273      -0.498857       -0.497912       -0.510927       2.981
   C     0.000000    -37.846772     -37.845355      -37.844411      -37.861317       2.981
   N     0.000000    -54.583861     -54.582445      -54.581501      -54.598897       2.981
   O     0.000000    -75.064579     -75.063162      -75.062219      -75.079532       2.981
   F     0.000000    -99.718730     -99.717314      -99.716370      -99.733544       2.981
"""


@pytest.fixture(autouse=True)
def _no_download(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("qm9_extras tried to download")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _equal(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _thermo(tmp_path):
    (tmp_path / "atomref.txt").write_text(ATOMREF)
    return ref.get_thermo_dict(str(tmp_path), download=False)


def test_get_thermo_dict(tmp_path):
    expected = _thermo(tmp_path)
    assert port.get_thermo_dict(str(tmp_path), download=False) == expected
    assert expected["U0"][6] == -37.846772 and set(expected) == {"zpve", "U0", "U", "H", "G", "Cv"}


def test_add_thermo_targets(tmp_path):
    therm = {k: v for k, v in _thermo(tmp_path).items() if k in ("U0", "zpve")}
    _equal(port.add_thermo_targets(_toy_data(), therm), ref.add_thermo_targets(_toy_data(), therm))


@pytest.mark.parametrize("subtract_thermo", [False, True])
def test_processed_dataset(tmp_path, subtract_thermo):
    therm = {k: v for k, v in _thermo(tmp_path).items() if k in ("U0", "zpve")}
    data = ref.add_thermo_targets(_toy_data(), therm)
    a = port.ProcessedDataset(dict(data), subtract_thermo=subtract_thermo)
    b = ref.ProcessedDataset(dict(data), subtract_thermo=subtract_thermo)
    np.testing.assert_array_equal(a.included_species, b.included_species)
    assert (a.num_species, a.max_charge, len(a)) == (b.num_species, b.max_charge, len(b))
    _equal(a.data, b.data)
    assert a.stats == b.stats
    _equal(a[1], b[1])
    units = {"U0": port.QM9_TO_EV["U0"], "zpve": ref.QM9_TO_EV["zpve"]}
    a.convert_units(units)
    b.convert_units(units)
    _equal(a.data, b.data)
    assert a.stats == b.stats
    species = np.array([1, 6, 7, 8])
    _equal(port.ProcessedDataset(_toy_data(), species).data,
           ref.ProcessedDataset(_toy_data(), species).data)


def test_batch_stack_and_collate():
    ds = ref.ProcessedDataset(_toy_data(), subtract_thermo=False)
    molecules = [ds[i] for i in (2, 0, 1)]
    for key in ("charges", "positions", "U0"):
        props = [m[key] for m in molecules]
        a, b = port.batch_stack(props), ref.batch_stack(props)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ragged = [np.ones((n, 3)) * n for n in (2, 5, 3)]
    np.testing.assert_array_equal(port.batch_stack(ragged), ref.batch_stack(ragged))
    a, b = port.collate_fn(molecules), ref.collate_fn(molecules)
    _equal(a, b)
    assert a["edge_mask"].shape == (3 * 5 * 5, 1)
