"""`chip_smoke.py` refuses to run without a CUDA device: it exits non-zero
and prints no result line, so a machine without a card never reports ok.
Its phase-16 helpers that need no card run here: the estimator statistics,
the Chrome trace's kernel count, the gradient gap and the CNF that serves
the StableMLP JAX checkpoint."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_distributed_phase_fails_without_cuda():
    """Phase 17's child refuses the CPU before it starts a process group:
    no gloo stands in for NCCL."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the child would run on it")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--distributed-phase", "240"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, COORDINATOR_ADDRESS="127.0.0.1:1", NUM_PROCESSES="1", PROCESS_ID="0"),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "[dist]" not in proc.stdout
    assert "phase 17 needs a CUDA device" in proc.stderr


def test_estimator_stats_of_known_draws():
    import chip_smoke

    exact = torch.tensor([1.0, -2.0])
    # 16 draws at +-1 and +-2 around exact + (0, 0.5): biases 0 and 0.5.
    base = torch.tensor([[-1.0, -2.0], [1.0, 2.0]]).repeat(8, 1)
    est = base + exact + torch.tensor([0.0, 0.5])
    stats = chip_smoke.estimator_stats(est, exact)
    sd = base.double().std(dim=0)
    assert abs(stats["sd"] - sd.mean().item()) < 1e-12
    assert abs(stats["bias"] - 0.25) < 1e-12
    assert abs(stats["max_z"] - 0.5 / (sd[1].item() / 4.0)) < 1e-9


def test_trace_kernel_events_counts_device_kernels(tmp_path):
    import json

    import chip_smoke

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm"},
        {"ph": "X", "cat": "Kernel", "name": "elementwise"},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm"},
        {"ph": "i", "name": "marker"},
    ]}))
    assert chip_smoke.trace_kernel_events(path) == 2
    # A CPU-only trace, as `training.profile_dir` writes on the CPU: none.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    assert chip_smoke.trace_kernel_events(tmp_path / "cpu.json") == 0
    (tmp_path / "bad.json").write_text("{")
    with pytest.raises(ValueError):
        chip_smoke.trace_kernel_events(tmp_path / "bad.json")


def test_max_gap_and_phase16_constants():
    import chip_smoke

    a = [torch.zeros(3), torch.ones(2, dtype=torch.bfloat16)]
    b = [torch.tensor([0.0, 2e-6, 0.0]), torch.ones(2)]
    assert chip_smoke.max_gap(a, b) == pytest.approx(2e-6)
    assert chip_smoke.QM9_CHUNKS == (None, 27, 9, 1) and 54 % 27 == 0 and 54 % 9 == 0
    assert 2 * chip_smoke.HUTCH_SKETCH + chip_smoke.HUTCH_RESID == chip_smoke.HUTCH_PLAIN
    assert "training.precision=tensorfloat32" in chip_smoke.DW4_OPTION_CUTS


def test_serving_cnf_builds_the_stable_checkpoint_on_the_cpu(tmp_path):
    import json

    import chip_smoke

    fixture = REPO / chip_smoke.JAX_STABLE_FIXTURE
    expected = json.loads((fixture / "expected.json").read_text())
    argv = chip_smoke.serving_argv(fixture, expected, slice(0, 2), "cpu", tmp_path)
    cnf, x, feats = chip_smoke.serving_cnf(argv, "cpu")
    assert x.shape == (2, 66) and feats.shape == (2, 22)
    assert torch.equal(feats[0], torch.arange(22))
    assert x.reshape(2, 22, 3).mean(dim=1).abs().max() < 1e-6
    assert cnf.tangent_value_and_div is None and cnf.fused_value_and_div is None
    assert any(".residual." in n for n in cnf.field.state_dict())
    assert "--checkpoint-dir" in argv and "flow.network.stable_mlp=true" in argv
