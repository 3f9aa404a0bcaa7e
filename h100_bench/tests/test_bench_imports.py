"""What the benchmark loads: nothing of JAX or of the JAX package anywhere,
and nothing of the program in the reference.  Top-level module names (the
part before the first dot) are compared whole: the program's name starts
with the JAX package's."""
import ast
import json
import subprocess
import sys

from bench_cells import ALL, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "ecnf_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.REPO, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    loads = ["import harness", "import calibrate", "from bench_cells import load_cell"]
    for w in ALL:
        loads.append(f"c = load_cell({w!r}); d = harness.driver(c); harness.reference(c)")
        loads.append("[harness.reader(m['name']) for m in c['per_layer']]")
    loads.append("[harness.load_module(p) for p in sorted((harness.HERE / 'metrics').glob('*.py'))]")
    loads += ["import ecnf_tpu_torch.cnf.build, ecnf_tpu_torch.cnf.sampling",
              "import ecnf_tpu_torch.training.state, ecnf_tpu_torch.training.optim",
              "import ecnf_tpu_torch.ops.edge_tangent, ecnf_tpu_torch.ops.fused_trace"]
    code = "import sys; sys.path[:0] = ['.', 'h100_bench', 'h100_bench/tests']\n" + "\n".join(loads)
    loaded = _loaded(code)
    assert "ecnf_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['h100_bench']\n"
            "from reference import egnn")
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"ecnf_tpu_torch"})
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"math", "typing", "torch"}, (path.name, names)
