"""DW4, LJ13, QM9 and ALDP datasets (port of the loaders of
`ecnf_tpu/targets/data.py`).

The original blobs of the reference (``dw4-dataidx.npy``; ``holdout_data_LJ13.npy``,
``idx_LJ13.npy``, ``all_data_LJ13.npy``) are read, with the reference's
splits, when they are in the data directory.  Otherwise a dataset is
regenerated by HMC on the same target energy, gated on its chains' mixing,
and cached as ``dw4_generated_torch.npy`` / ``lj13_generated_torch.npy``.
The JAX package's own regenerations (``*_generated.npy``) come from
another random stream and are never read here, nor written.  QM9 reads
the ``qm9pos_*.npy`` files that `targets/qm9.py` writes (and downloads
GDB9 for, when they are missing) or seeded stand-ins behind a marker.
ALDP reads an mdtraj HDF5 trajectory with the port's own reader
(`targets/h5.py`; the card has no h5py).
"""
import os
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ecnf_tpu_torch.cnf.build import resolve_device
from ecnf_tpu_torch.targets.diagnostics import mcmc_diagnostics
from ecnf_tpu_torch.targets.energies import double_well_log_prob, lennard_jones_log_prob
from ecnf_tpu_torch.targets.mcmc import icosahedron_with_center, run_hmc

Tensor = torch.Tensor
PathLike = Union[Path, str]

DEFAULT_DATA_DIR = Path(__file__).resolve().parent.parent.parent / "data"
DW4_CACHE = "dw4_generated_torch.npy"
LJ13_CACHE = "lj13_generated_torch.npy"

# The JAX package's HMC settings (`ecnf_tpu/targets/data.py:56-68,144-159`).
DW4_HMC = dict(n_samples_per_chain=200, n_chains=64, n_nodes=4, dim=2, step_size=0.12,
               n_leapfrog=15, burn_in=2000, thin=20, init_scale=1.0)
DW4_SEED = 2023
LJ13_HMC = dict(n_samples_per_chain=120, n_chains=64, n_nodes=13, dim=3, step_size=0.012,
                n_leapfrog=40, burn_in=6000, thin=20)
LJ13_SEED = 13
LJ13_INIT_NOISE = 0.03
# Chains that have accepted no step by half the burn-in restart from a
# moving chain (`ecnf_tpu_torch.targets.mcmc`); the JAX package has no
# such rule, and a chain stuck at a compressed DW4 start fails the gate.
RESTART_STUCK_AT = {"DW4": DW4_HMC["burn_in"] // 2, "LJ13": LJ13_HMC["burn_in"] // 2}


class FullGraphSample(NamedTuple):
    """Positions ``[n, N, D]`` and integer node features ``[n, N, 1]``."""

    positions: Tensor
    features: Tensor

    def __getitem__(self, i):
        return FullGraphSample(self.positions[i], self.features[i])


def positional_dataset_only_to_full_graph(positions: Tensor) -> FullGraphSample:
    """Zero integer features for a purely positional dataset."""
    assert positions.dim() == 3  # [n_data_points, n_nodes, dim]
    features = torch.zeros((*positions.shape[:-1], 1), dtype=torch.int32, device=positions.device)
    return FullGraphSample(positions=positions, features=features)


def _data_dir(path: Optional[PathLike]) -> Path:
    return DEFAULT_DATA_DIR if path is None else Path(path)


def _numpy_log_prob(log_prob_fn):
    """A torch log-prob as a function of float64 numpy positions."""
    return lambda x: log_prob_fn(torch.from_numpy(np.asarray(x, dtype=np.float64))).numpy()


def _gate_on_mixing(name: str, data: np.ndarray, n_chains: int, log_prob_fn) -> dict:
    """Refuse a regenerated dataset whose chains have not mixed: split-R̂ of
    the energy and of the mean pairwise distance below 1.05, and each one's
    bulk ESS above 10 per chain.  Returns the diagnostics."""
    report = mcmc_diagnostics(data, n_chains=n_chains, log_prob_fn=_numpy_log_prob(log_prob_fn))
    print(f"{name} HMC diagnostics: " + ", ".join(f"{k}={v:.4g}" for k, v in sorted(report.items())))
    for stat in ("energy", "dist"):
        rhat = report[f"rhat_{stat}"]
        ess = report[f"ess_{stat}"]
        assert rhat < 1.05, f"{name} HMC did not converge: split-Rhat({stat})={rhat:.3f}"
        assert ess > 10 * n_chains, f"{name} HMC ESS too low: ess({stat})={ess:.0f}"
    return report


class Regeneration(NamedTuple):
    """A regenerated dataset ``[C * S, N, D]`` (float64, chain-major), its
    HMC acceptance rate, the seconds HMC took and the gate's diagnostics."""

    data: np.ndarray
    acceptance: float
    seconds: float
    report: dict


def _regenerate(name, log_prob_fn, settings, generator, device, **kwargs) -> Regeneration:
    print(f"{name} source data missing; regenerating by HMC on {device} (deterministic seed)")
    start = time.perf_counter()
    samples, acc = run_hmc(log_prob_fn, **settings, generator=generator, device=device,
                           restart_stuck_at=RESTART_STUCK_AT[name], **kwargs)
    data = samples.double().cpu().numpy()
    seconds = time.perf_counter() - start
    print(f"{name} HMC acceptance rate: {acc:.2f}; {seconds:.1f} s on {device}")
    if name == "LJ13":
        assert acc > 0.3, f"LJ13 HMC failed to mix (acceptance {acc:.2f})"
    report = _gate_on_mixing(name, data, settings["n_chains"], log_prob_fn)
    return Regeneration(data, acc, seconds, report)


def _save(path: Path, regen: Regeneration) -> Regeneration:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, regen.data)
    return regen


def _generate_dw4_data(path: Path, device) -> Regeneration:
    """Regenerate DW4 by HMC on the double-well energy, gate it and cache it."""
    generator = torch.Generator().manual_seed(DW4_SEED)
    return _save(path, _regenerate("DW4", double_well_log_prob, DW4_HMC, generator, device))


def _generate_lj13_data(path: Path, device) -> Regeneration:
    """Regenerate LJ13 by HMC on the Lennard-Jones energy from noisy
    icosahedra (random starts overlap particles), gate it and cache it."""
    generator = torch.Generator().manual_seed(LJ13_SEED)
    x0 = icosahedron_with_center(LJ13_HMC["n_chains"], generator, noise=LJ13_INIT_NOISE)
    return _save(path, _regenerate("LJ13", lennard_jones_log_prob, LJ13_HMC, generator, device,
                                   init_positions=x0))


def _to_graphs(device, *arrays) -> Tuple[FullGraphSample, ...]:
    return tuple(
        positional_dataset_only_to_full_graph(torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device))
        for a in arrays
    )


def load_dw4(
    train_set_size: int = 1000,
    val_set_size: int = 1000,
    test_set_size: int = 1000,
    path: Optional[PathLike] = None,
    device=None,
) -> Tuple[FullGraphSample, FullGraphSample, FullGraphSample]:
    """DW4, 4 particles in 2-D: train = the head, val and test = the tail
    (the reference's splits), from ``dw4-dataidx.npy`` when present, else
    from the port's HMC regeneration (made on ``device`` when not cached).
    The splits are put on ``device``: the card unless another is named."""
    device = resolve_device(device)
    d = _data_dir(path)
    blob, cache = d / "dw4-dataidx.npy", d / DW4_CACHE
    if blob.exists():
        dataset = np.asarray(np.load(blob, allow_pickle=True)[0], dtype=np.float64)
    elif cache.exists():
        dataset = np.load(cache)
    else:
        dataset = _generate_dw4_data(cache, device).data
    dataset = np.asarray(dataset, dtype=np.float32).reshape(-1, 4, 2)
    train = dataset[:train_set_size]
    val = dataset[-test_set_size - val_set_size : -test_set_size]
    test = dataset[-test_set_size:]
    return _to_graphs(device, train, val, test)


def load_lj13(
    train_set_size: int = 1000, path: Optional[PathLike] = None, device=None
) -> Tuple[FullGraphSample, FullGraphSample, FullGraphSample]:
    """LJ13, 13 particles in 3-D.  With the reference's blobs: train =
    ``holdout_data_LJ13.npy`` at ``idx_LJ13.npy``, val = rows 1000:2000 and
    test = rows :1000 of ``all_data_LJ13.npy``.  Otherwise from the port's
    HMC regeneration: test, val and train as consecutive disjoint blocks,
    on ``device`` (the card unless another is named)."""
    device = resolve_device(device)
    d = _data_dir(path)
    fpath_train, fpath_idx, fpath_val_test = (
        d / "holdout_data_LJ13.npy", d / "idx_LJ13.npy", d / "all_data_LJ13.npy")
    if fpath_train.exists() and fpath_val_test.exists():
        train_data = np.asarray(np.load(fpath_train, allow_pickle=True), dtype=np.float64)
        idxs = np.asarray(np.load(fpath_idx, allow_pickle=True), dtype=np.int64)
        val_test = np.asarray(np.load(fpath_val_test, allow_pickle=True), dtype=np.float64)
        val_data = val_test[1000:2000]
        test_data = val_test[:1000]
        assert train_set_size <= len(idxs)
        train_data = train_data[idxs[:train_set_size]]
    else:
        cache = d / LJ13_CACHE
        data = np.load(cache) if cache.exists() else _generate_lj13_data(cache, device).data
        data = data.reshape(-1, 13, 3)
        assert len(data) >= train_set_size + 2000, "regenerated LJ13 dataset too small"
        test_data = data[:1000]
        val_data = data[1000:2000]
        train_data = data[2000 : 2000 + train_set_size]
    to3 = lambda a: np.asarray(a, dtype=np.float32).reshape(-1, 13, 3)
    return _to_graphs(device, to3(train_data), to3(val_data), to3(test_data))


SYNTHETIC_QM9_MARKER = "QM9_SYNTHETIC_NOTE.txt"
_TRUTHY = ("1", "true", "yes")


def load_qm9(
    train_set_size: Optional[int] = None,
    path: Optional[PathLike] = None,
    allow_synthetic: bool = False,
    device=None,
) -> Tuple[FullGraphSample, FullGraphSample, FullGraphSample]:
    """QM9 positions of the 19-atom molecules: ``qm9pos_{train,valid,test}.npy``
    of the data directory (train cut to ``train_set_size``), on ``device``
    (the card unless another is named).  Missing files are made by
    `targets/qm9.py: qm9pos_download_and_save_data`, which downloads GDB9.

    A directory holding `SYNTHETIC_QM9_MARKER` holds seeded stand-ins
    (`targets/synthetic_qm9.py`), not QM9: it is refused, before any
    download, unless ``allow_synthetic`` or ``ECNF_ALLOW_SYNTHETIC_QM9`` is
    one of 1 / true / yes (any case).
    """
    device = resolve_device(device)
    d = _data_dir(path)
    fpath_train, fpath_val, fpath_test = (d / f"qm9pos_{s}.npy" for s in ("train", "valid", "test"))
    opted_in = allow_synthetic or os.environ.get("ECNF_ALLOW_SYNTHETIC_QM9", "").lower() in _TRUTHY
    if (d / SYNTHETIC_QM9_MARKER).exists() and not opted_in:
        raise RuntimeError(
            f"{d} is marked as holding SYNTHETIC QM9 stand-in data (marker: "
            f"{d / SYNTHETIC_QM9_MARKER}), not real QM9: training on it yields meaningless "
            "quality numbers. For hardware-validation runs opt in explicitly with "
            "load_qm9(..., allow_synthetic=True) or ECNF_ALLOW_SYNTHETIC_QM9=1. For real QM9, "
            "delete BOTH the marker file and the qm9pos_*.npy stand-ins, then re-run with "
            "network access so qm9pos_download_and_save_data can fetch GDB9."
        )
    if not fpath_train.exists():
        from ecnf_tpu_torch.targets.qm9 import qm9pos_download_and_save_data

        qm9pos_download_and_save_data(base_path=str(d))
    train_data = np.load(fpath_train)
    if train_set_size is not None:
        assert train_set_size <= len(train_data)
    train_data = train_data[:train_set_size]
    return _to_graphs(device, train_data, np.load(fpath_val), np.load(fpath_test))


def load_aldp(
    train_path: Optional[PathLike] = None,
    val_path: Optional[PathLike] = None,
    test_path: Optional[PathLike] = None,
    train_n_points: Optional[int] = None,
    val_n_points: Optional[int] = None,
    test_n_points: Optional[int] = None,
    val_skip_n: int = 0,
    test_skip_n: int = 0,
    device=None,
) -> Tuple[Optional[FullGraphSample], Optional[FullGraphSample], Optional[FullGraphSample]]:
    """Alanine dipeptide: the ``coordinates`` of mdtraj HDF5 trajectories,
    one per split (None where its path is None), on ``device`` (the card
    unless another is named).  Node features are the atom index,
    ``arange(n_atoms)``.  ``val_skip_n`` / ``test_skip_n`` leading frames
    are dropped before ``*_n_points`` are kept, so that one file can give
    disjoint splits."""
    from ecnf_tpu_torch.targets.h5 import read_dataset

    device = resolve_device(device)
    out = []
    for path, n_points, skip in ((train_path, train_n_points, 0), (val_path, val_n_points, val_skip_n),
                                 (test_path, test_n_points, test_skip_n)):
        if path is None:
            out.append(None)
            continue
        positions = read_dataset(path, "coordinates")[skip:]
        if n_points is not None:
            positions = positions[:n_points]
        positions = torch.as_tensor(np.asarray(positions, dtype=np.float32)).to(device)
        n, n_atoms = positions.shape[:2]
        features = torch.arange(n_atoms, dtype=torch.int32, device=device)[None, :, None]
        out.append(FullGraphSample(positions, features.expand(n, n_atoms, 1).contiguous()))
    return tuple(out)
