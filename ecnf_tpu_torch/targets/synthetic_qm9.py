"""Seeded SYNTHETIC stand-ins of the QM9 positional dataset (the port's
counterpart of `scripts/make_synthetic_qm9.py`, byte for byte the same
files).

Real QM9 needs the GDB9 tarball (`targets/qm9.py` downloads it).  These
are Gaussian positions of the real pipeline's shapes (19 atoms in 3-D,
scaled by 1.5, centre of mass removed) for exercising the QM9 program on a
card; their quality numbers are not QM9's.  The directory gets the
`targets.data.SYNTHETIC_QM9_MARKER` note, so `load_qm9` refuses them
without an explicit opt-in.

Usage:
    python -m ecnf_tpu_torch.targets.synthetic_qm9 OUT_DIR
"""
import argparse
from pathlib import Path
from typing import Dict, Union

import numpy as np

from ecnf_tpu_torch.targets.data import SYNTHETIC_QM9_MARKER

N_ATOMS, DIM = 19, 3
SIZES = {"train": 6400, "valid": 1000, "test": 1000}
SEED = 20260819
NOTE = (
    "SYNTHETIC stand-in data (rng gaussians, not real QM9) used for hardware\n"
    "validation of the full 16k-iteration QM9 config; see BASELINE.md.\n"
    "Regenerate with scripts/make_synthetic_qm9.py (seed %d).\n"
    "Replace with qm9pos_download_and_save_data output where egress exists.\n"
    % SEED
)


def write_synthetic_qm9(out_dir: Union[str, Path]) -> Dict[str, tuple]:
    """Write ``qm9pos_{train,valid,test}.npy`` and the marker into
    ``out_dir``; returns each split's shape."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    shapes = {}
    for split, n in SIZES.items():
        pos = rng.normal(size=(n, N_ATOMS, DIM)).astype(np.float32) * 1.5
        pos -= pos.mean(axis=1, keepdims=True)
        np.save(out / f"qm9pos_{split}.npy", pos)
        shapes[split] = pos.shape
    (out / SYNTHETIC_QM9_MARKER).write_text(NOTE)
    return shapes


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", help="directory for qm9pos_*.npy and the marker")
    out_dir = parser.parse_args().out_dir
    for split, shape in write_synthetic_qm9(out_dir).items():
        print(f"wrote {Path(out_dir) / f'qm9pos_{split}.npy'} {shape}")
