"""The port imports no JAX: every `ecnf_tpu_torch` module, and the
``--help`` of the sampling, scoring, timing, experiment and
synthetic-QM9 entry points, load in a process where ``import jax`` fails, and so do ``yaml``, ``pandas``,
``h5py``, ``matplotlib`` and ``tqdm``, which the card's machine lacks,
and ``orbax``, ``tensorstore``, ``zstandard`` and ``zstd``, which the
port's checkpoint reader must not need.  In that process the ALDP loader
reads its HDF5 file, the figures are written and the committed JAX
checkpoint reads as its ``expected.json`` says; no source file of the
port, nor ``chip_smoke.py``, imports ``h5py``, ``matplotlib``, JAX,
orbax, tensorstore or zstandard."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import ecnf_tpu_torch

REPO = Path(__file__).resolve().parent.parent

_PROGRAM = """
import importlib, pkgutil, runpy, sys
BLOCKED = ("jax", "yaml", "pandas", "h5py", "matplotlib", "tqdm", "orbax", "tensorstore",
           "zstandard", "zstd")
for blocked in BLOCKED:
    sys.modules[blocked] = None
import ecnf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecnf_tpu_torch.__path__, "ecnf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [n for n in sys.modules if sys.modules[n] is not None]
assert not any(n.split(".")[0] in BLOCKED or n.startswith("ecnf_tpu.") for n in loaded)
print(len(names))
from ecnf_tpu_torch.targets import load_aldp
from ecnf_tpu_torch.utils.plotting import plot_history
train, _, _ = load_aldp(train_path="data/aldp_500K_train_mini.h5", train_n_points=3, device="cpu")
assert tuple(train.positions.shape) == (3, 22, 3)
assert "<svg" in plot_history({"loss": [1.0, 0.5]}).to_svg()
import json
from chip_smoke import leaf_digests
from ecnf_tpu_torch.training.checkpoints import restore_serving_params
from ecnf_tpu_torch.training.orbax import read_orbax_tree
fixture = "tests/torch_fixtures/jax_aldp/"
expected = json.load(open(fixture + "expected.json"))
assert leaf_digests(read_orbax_tree(fixture + expected["checkpoint"])) == expected["leaves"]
assert len(restore_serving_params(fixture + expected["checkpoint"], ema=True)) > 0
for program in ("sample", "score", "examples.dw4", "examples.lj13", "examples.qm9",
                "examples.aldp", "examples.mog", "measure_sampling_time",
                "targets.synthetic_qm9"):
    sys.argv = [program, "--help"]
    try:
        runpy.run_module(f"ecnf_tpu_torch.{program}", run_name="__main__")
    except SystemExit as exit:
        assert exit.code == 0, exit.code
"""


def test_port_imports_without_jax():
    names = {m.name for m in pkgutil.walk_packages(ecnf_tpu_torch.__path__, "ecnf_tpu_torch.")}
    kernel_modules = {f"ecnf_tpu_torch.ops.{m}" for m in ("cuda_build", "edge_tangent", "egcl", "fused_trace")}
    assert kernel_modules <= names
    program_modules = {f"ecnf_tpu_torch.{m}" for m in (
        "targets.diagnostics", "targets.mcmc", "targets.data", "training.yaml_subset",
        "training.config", "training.loggers", "training.checkpoints", "training.loop",
        "examples.common", "examples.dw4", "examples.lj13", "examples.qm9", "examples.mog",
        "measure_sampling_time", "targets.qm9", "targets.synthetic_qm9", "targets.mog",
        "models.vector_net", "targets.h5", "utils.plotting", "utils.figure", "examples.aldp",
        "utils.zstd", "training.ocdbt", "training.orbax",
    )}
    assert program_modules <= names
    expected = len(names)
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert int(lines[0]) == expected >= 38
    assert proc.stdout.count("--params-npz") >= 2
    assert "--hutchinson-probes" in proc.stdout and "--data" in proc.stdout
    assert proc.stdout.count("--local") >= 4 and proc.stdout.count("overrides") >= 5
    assert "--checkpoint-dir" in proc.stdout and "--wandb-project" in proc.stdout


def test_port_sources_import_no_h5py_or_matplotlib():
    sources = sorted(Path(ecnf_tpu_torch.__file__).parent.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) >= 42
    pattern = re.compile(
        r"^\s*(import|from)\s+(h5py|matplotlib|jax|ecnf_tpu|orbax|tensorstore|zstandard)\b",
        re.MULTILINE,
    )
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
