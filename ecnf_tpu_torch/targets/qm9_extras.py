"""QM9 pipeline extras: thermo correction, processed-dataset stats, collate
(a copy of `ecnf_tpu/targets/qm9_extras.py`, which is numpy only).

Re-implementations of the remaining reference `qm9_download_data`
components:

- thermochemical-energy targets (`data/prepare/qm9.py:137-207,210-243`):
  download `atomref.txt`, build per-charge reference energies, add
  ``<target>_thermo`` columns;
- `ProcessedDataset`-equivalent statistics (`data/dataset_class.py:10-93`):
  one-hot species encoding, included species, per-target mean/std,
  unit conversion;
- batch collation with atom/edge masks (`data/collate.py:58-103` — unused
  by the positional main path in the reference as well; provided for
  completeness of the data API).
"""
import logging
import urllib.request
from os.path import join
from typing import Dict, List, Mapping, Optional

import numpy as np

GDB9_URL_THERMO = "https://springernature.figshare.com/ndownloader/files/3195395"

QM9_TO_EV = {
    "U0": 27.2114, "U": 27.2114, "G": 27.2114, "H": 27.2114,
    "zpve": 27211.4, "gap": 27.2114, "homo": 27.2114, "lumo": 27.2114,
}

_THERM_TARGETS = ("zpve", "U0", "U", "H", "G", "Cv")
_ID2CHARGE = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}


def get_thermo_dict(gdb9dir: str, download: bool = True) -> Dict[str, Dict[int, float]]:
    """Per-charge thermochemical reference energies (reference
    `prepare/qm9.py:137-178`)."""
    path = join(gdb9dir, "atomref.txt")
    if download:
        logging.info("downloading thermochemical energies")
        urllib.request.urlretrieve(GDB9_URL_THERMO, filename=path)
    therm_energy: Dict[str, Dict[int, float]] = {t: {} for t in _THERM_TARGETS}
    with open(path) as f:
        for line in f:
            split = line.split()
            if len(split) == 0 or split[0] not in _ID2CHARGE:
                continue
            for target, val in zip(_THERM_TARGETS, split[1:]):
                therm_energy[target][_ID2CHARGE[split[0]]] = float(val)
    return therm_energy


def add_thermo_targets(
    data: Dict[str, np.ndarray], therm_energy_dict: Mapping[str, Mapping[int, float]]
) -> Dict[str, np.ndarray]:
    """Add ``<target>_thermo`` columns (reference `prepare/qm9.py:181-243`)."""
    charges = data["charges"]
    unique_charges = np.unique(charges)
    counts = {
        int(z): (charges == z).sum(axis=1) for z in unique_charges if z != 0
    }
    for target, target_therm in therm_energy_dict.items():
        thermo = np.zeros(len(data[target]))
        for z, num_z in counts.items():
            thermo += target_therm[z] * num_z
        data[target + "_thermo"] = thermo
    return data


class ProcessedDataset:
    """Species one-hot, included-species bookkeeping, target statistics.

    Numpy equivalent of the reference's torch `ProcessedDataset`
    (`data/dataset_class.py:10-93`): computes ``one_hot`` from charges x
    included species, per-target mean/MAD stats, and supports unit
    conversion and subtracting thermo targets.
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        included_species: Optional[np.ndarray] = None,
        subtract_thermo: bool = True,
    ):
        self.data = dict(data)
        if included_species is None:
            included_species = np.unique(self.data["charges"])
            if included_species[0] == 0:
                included_species = included_species[1:]
        self.included_species = included_species
        self.data["one_hot"] = (
            self.data["charges"][..., None] == included_species[None, None, :]
        )
        self.num_species = len(included_species)
        self.max_charge = int(included_species.max())

        if subtract_thermo:
            for key in list(self.data):
                if key.endswith("_thermo"):
                    base = key[: -len("_thermo")]
                    if base in self.data:
                        self.data[base] = self.data[base] - self.data[key]

        self.stats = {
            key: (float(val.mean()), float(val.std()))
            for key, val in self.data.items()
            if val.ndim == 1 and np.issubdtype(val.dtype, np.floating)
        }
        self.num_pts = len(self.data["charges"])

    def convert_units(self, units_dict: Mapping[str, float]) -> None:
        """Multiply targets by unit factors (reference `dataset.py:17-24`)."""
        for key, factor in units_dict.items():
            if key in self.data:
                self.data[key] = self.data[key] * factor
        self.stats = {
            key: (float(val.mean()), float(val.std()))
            for key, val in self.data.items()
            if val.ndim == 1 and np.issubdtype(val.dtype, np.floating)
        }

    def __len__(self) -> int:
        return self.num_pts

    def __getitem__(self, idx):
        return {key: val[idx] for key, val in self.data.items()}


def batch_stack(props: List[np.ndarray]) -> np.ndarray:
    """Stack variable-size molecule tensors with zero padding (reference
    `data/collate.py:12-38`)."""
    if props[0].ndim == 0:
        return np.stack(props)
    max_atoms = max(p.shape[0] for p in props)
    out = np.zeros((len(props), max_atoms, *props[0].shape[1:]), dtype=props[0].dtype)
    for i, p in enumerate(props):
        out[i, : p.shape[0]] = p
    return out


def collate_fn(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Collate molecules into a padded batch with atom/edge masks.

    Parity with reference `data/collate.py:58-103`: drop all-zero padding
    columns, ``atom_mask = charges > 0``, ``edge_mask`` = outer product of
    atom masks with the diagonal removed.  (Unused by the positional main
    path — same as in the reference — but part of the data API.)
    """
    out = {k: batch_stack([mol[k] for mol in batch]) for k in batch[0].keys()}

    to_keep = out["charges"].sum(axis=0) > 0
    for key, val in out.items():
        if val.ndim > 1 and val.shape[1] == to_keep.shape[0]:
            out[key] = val[:, to_keep]

    atom_mask = out["charges"] > 0
    out["atom_mask"] = atom_mask

    bs, n_nodes = atom_mask.shape
    edge_mask = atom_mask[:, None, :] & atom_mask[:, :, None]
    diag = np.eye(n_nodes, dtype=bool)[None]
    out["edge_mask"] = (edge_mask & ~diag).reshape(bs * n_nodes * n_nodes, 1)
    return out
