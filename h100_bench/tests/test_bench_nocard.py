"""Without a card the run fails and prints no result: it never falls back
to the CPU."""
import os
import subprocess
import sys

from bench_cells import WORKLOADS, harness


def test_a_run_without_a_card_fails_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", WORKLOADS[0],
                          "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr
