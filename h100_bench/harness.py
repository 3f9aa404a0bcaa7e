"""The benchmark's general part: finds a cell's files by name, makes the
weights from the seed, drives the cell's driver through set-up, the timed
window, the traced window and the check, reads the per-layer metrics, and
builds the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Its files:

- ``configs/<config>.json``: the configuration as it is run; its
  ``reference`` names the plain reference module under ``reference/``;
- ``traffic/<traffic>.json``: the mix; its ``driver`` names the module
  under ``drivers/`` that runs it;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A metric named ``<quantity>.<group>`` reports the same quantity for its own
group of cells, under a bound or an end-to-end metric of that group's own:
the driver's value of ``<quantity>``, and the reader of the longest dotted
prefix of the name that has a file (``mfu.sample.hutch`` reads with
``metrics/mfu.sample.py``).
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, Optional

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
MANIFEST = REPO / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "ecnf_tpu")


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "h100_bench_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def load_cell(workload: str, bench: Optional[dict] = None) -> dict:
    """The workload's entry with its configuration, traffic and limits."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return dict(
        workload=entry,
        config=json.loads((REPO / config["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])],
        per_layer=[m for m in bench["per_layer"] if workload in m["workloads"]],
    )


def reader(metric: str) -> ModuleType:
    """The per-layer metric's reader (see the module's docstring)."""
    name = metric
    while not (HERE / "metrics" / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return load_module(HERE / "metrics" / f"{name}.py")


def reference(cell: dict) -> ModuleType:
    return load_module(HERE / "reference" / f"{cell['config']['reference']}.py")


def driver(cell: dict) -> ModuleType:
    return load_module(HERE / "drivers" / f"{cell['traffic']['driver']}.py")


def make_weights(shapes: Dict[str, tuple], generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter from the seed, in f32 on the device, in one draw:
    each matrix ``[out, in]`` at N(0, 1/in) (the embedding's rows at
    N(0, 1/width)), each bias at N(0, 0.1^2), scalars at 1."""
    sizes = [math.prod(s) for s in shapes.values()]
    scales = torch.tensor(
        [1.0 / math.sqrt(s[1]) if len(s) == 2 else 0.1 for s in shapes.values()], device=device
    )
    z = torch.randn(sum(sizes), generator=generator, device=device)
    z.mul_(torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
    weights = {}
    for (name, shape), part in zip(shapes.items(), z.split(sizes)):
        weights[name] = part.view(shape) if shape else torch.ones((), device=device)
    return weights


def host_settings(cell: dict) -> None:
    """The host threads and the float32 matmul precision the configuration
    states, so that every commit runs under the same settings."""
    torch.set_num_threads(cell["config"]["host_threads"])
    torch.set_float32_matmul_precision(cell["config"]["matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = cell["config"]["matmul_precision"] != "highest"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32


def build_cnf(cfg: dict, device: torch.device, **kwargs):
    """The program's CNF for a configuration (`ecnf_tpu_torch.cnf.build`)."""
    from ecnf_tpu_torch.cnf import build

    return build.build_cnf(
        n_frames=cfg["n_nodes"], dim=cfg["dim"], sigma_min=cfg["sigma_min"],
        base_scale=cfg["base_scale"], n_blocks_egnn=cfg["n_blocks_egnn"],
        mlp_units=cfg["mlp_units"], n_invariant_feat_hidden=cfg["n_invariant_feat_hidden"],
        time_embedding_dim=cfg["time_embedding_dim"], n_features=cfg["n_features"],
        device=device, **{"compute_dtype": cfg["compute_dtype"], **kwargs},
    )


def remove_mean(x: torch.Tensor, n_nodes: int, dim: int) -> torch.Tensor:
    """Flat ``[B, N*D]`` points with each sample's centre of mass removed."""
    p = x.reshape(x.shape[0], n_nodes, dim)
    return (p - p.mean(1, keepdim=True)).reshape(x.shape)


def card_lines() -> list:
    """The card's name, power limit and SM clocks, and the host's CPU."""
    lines = []
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        lines.append(f"card: {out.stdout.strip().splitlines()[0]} ({query})")
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        lines.append(f"card: nvidia-smi gave nothing ({exc!r})")
    try:
        info = dict(l.split(":", 1) for l in Path("/proc/cpuinfo").read_text().splitlines()
                    if ":" in l)
        info = {k.strip(): v.strip() for k, v in info.items()}
        cpu = (f"{info.get('model name', 'unknown')} ({info.get('vendor_id')} family "
               f"{info.get('cpu family')} model {info.get('model')}, {info.get('cpu MHz')} MHz)")
    except OSError:
        cpu = "unknown"
    lines.append(f"host: {cpu}, {os.cpu_count()} cpus; torch {torch.__version__}, "
                 f"cuda {torch.version.cuda}, {torch.get_num_threads()} torch threads")
    return lines


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _peaks(kind: str) -> Optional[dict]:
    return json.loads((HERE / "work" / "peaks.json").read_text()).get(kind)


def _counter(path: str) -> int:
    module, attr = path.split(":")
    return sys.modules[module].__dict__[attr].launch_count if module in sys.modules else 0


def per_layer(cell: dict, timed: dict, traced: dict, device_kind: str) -> dict:
    """Each per-layer metric the cell reports, from its reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    work = load_module(HERE / "work" / "egnn.py")
    is_kernel = load_module(HERE / "trace.py").is_kernel
    kernels = [(n, e - s) for n, s, e in traced["device_ops"] if is_kernel(n)]
    out = {}
    for metric in cell["per_layer"]:
        module = reader(metric["name"])
        ctx = SimpleNamespace(
            config=cell["config"], traffic=cell["traffic"], work=work,
            peaks=_peaks(device_kind), timed=timed, traced=traced, kernels=kernels,
            counters={k: traced["counters"].get(v, 0) for k, v in getattr(module, "COUNTERS", {}).items()},
        )
        value = module.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def counter_paths(cell: dict) -> list:
    paths = set()
    for metric in cell["per_layer"]:
        paths.update(getattr(reader(metric["name"]), "COUNTERS", {}).values())
    return sorted(paths)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
             process_start: float) -> dict:
    """Set up, warm up, measure for ``seconds``, optionally trace, check.
    Returns the result line's fields, ``checks`` last."""
    tracing = load_module(HERE / "trace.py")
    run = driver(cell).Run(cell, reference(cell), seed, device)
    setup_s = time.perf_counter() - process_start
    timed = run.window(seconds)
    traced = None
    if trace:
        paths = counter_paths(cell)
        before = {p: _counter(p) for p in paths}
        traced = tracing.profile(run.traced_window, device)
        traced["counters"] = {p: _counter(p) - before[p] for p in paths}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        memory_peak, kind = 0, "cpu"
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package were loaded: {found}")
    run.release()
    checks = run.check()
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        traced["busy_s"] = tracing.busy_seconds(traced["device_ops"])
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        metrics = per_layer(cell, timed, traced, kind)
        breakdown = {"device_ops": tracing.top_device_ops(traced["device_ops"]),
                     "idle_gaps": tracing.idle_gaps(traced["device_ops"], traced["host_ops"])}
    else:
        values = dict(timed["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
