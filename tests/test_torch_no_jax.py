"""The port imports no JAX: every `ecnf_tpu_torch` module, and the
``--help`` of the sampling and scoring entry points, load in a process
where ``import jax`` fails."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import ecnf_tpu_torch

REPO = Path(__file__).resolve().parent.parent

_PROGRAM = """
import importlib, pkgutil, runpy, sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
import ecnf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecnf_tpu_torch.__path__, "ecnf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(n == "jax" or n.startswith(("jax.", "ecnf_tpu.")) for n in sys.modules if sys.modules[n] is not None)
print(len(names))
for program in ("sample", "score"):
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
    expected = len(names)
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert int(lines[0]) == expected >= 15
    assert proc.stdout.count("--params-npz") >= 2
    assert "--hutchinson-probes" in proc.stdout and "--data" in proc.stdout
