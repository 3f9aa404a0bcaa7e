"""Serving the committed StableMLP checkpoint of the JAX package
(``tests/torch_fixtures/jax_aldp_stable``, `torch_make_jax_checkpoint.py
--stable-mlp`) from the port, on the CPU.

The checkpoint is read by the port's Orbax reader and scored by ``python
-m ecnf_tpu_torch.score --config aldp_soak.yaml --checkpoint-dir ...`` with
the fixture's overrides (``network.stable_mlp=true``, f32, exact trace,
rk4 0.05), raw and ``--ema``; Hutch++ on the fixture's injected sketch and
probes and the exact trace in chunks of 25 go through `get_log_prob`, as
JAX's ``score`` exposes neither.  Band: log p within 1e-4 relative of the
JAX package's numbers in ``expected.json``.  The exact trace at K=63
through ``torch.func`` takes ~30 s a frame here, so the CPU scores one or
two frames; ``chip_smoke.py`` phase 16 (a) scores all 16 on the card.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ecnf_tpu_torch import score
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob
from ecnf_tpu_torch.training.orbax import read_orbax_tree

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "jax_aldp_stable"
REL = 1e-4

# Tier-1 runs several pytest workers at once; one thread each keeps them
# from oversubscribing the host.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def expected():
    return json.loads((FIXTURE / "expected.json").read_text())


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_committed_stable_fixture_reads_as_expected(expected):
    tree = read_orbax_tree(str(FIXTURE / expected["checkpoint"]))
    assert chip_smoke.leaf_digests(tree) == expected["leaves"] and len(expected["leaves"]) == 323
    assert any("LayerNorm_0/scale" in k for k in expected["leaves"])
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert size < 1_000_000
    assert "flow.network.stable_mlp=true" in expected["score_overrides"]
    hpp = expected["hutchpp"]
    assert np.load(FIXTURE / hpp["sketch"]).shape == (hpp["hutchpp_sketch"], 16, 66)
    assert np.load(FIXTURE / hpp["probes"]).shape == (hpp["hutchinson_probes"], 16, 66)


def _argv(expected, frames, tmp_path, *extra):
    return chip_smoke.serving_argv(FIXTURE, expected, frames, "cpu", tmp_path) + list(extra)


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema_params"])
def test_score_serves_the_stable_checkpoint(expected, tmp_path, capsys, ema):
    frame = 1 if ema else 0
    out = score.main(_argv(expected, [frame], tmp_path, *(["--ema"] if ema else [])))
    assert "restoring" in capsys.readouterr().out
    ref = expected["log_p"]["ema_params" if ema else "params"][frame:frame + 1]
    assert _rel(out["log_p"], ref) <= REL


def test_hutchpp_on_injected_draws_matches_jax(expected, tmp_path):
    hpp = expected["hutchpp"]
    rows = [0, 1]
    cnf, x, feats = chip_smoke.serving_cnf(_argv(expected, rows, tmp_path), "cpu")
    eps = tuple(torch.from_numpy(np.load(FIXTURE / hpp[k])[:, rows]) for k in ("sketch", "probes"))
    cfg = SolveConfig(use_fixed_step_size=True, method="rk4", hutchpp_sketch=hpp["hutchpp_sketch"],
                      hutchinson_probes=hpp["hutchinson_probes"])
    out = get_log_prob(cnf, x, feats, approx=True, cfg=cfg, eps=eps)[0]
    assert _rel(out, np.asarray(hpp["log_p"])[rows]) <= REL


def test_chunked_exact_trace_matches_jax(expected, tmp_path):
    chunk = expected["trace_column_chunk"]
    cnf, x, feats = chip_smoke.serving_cnf(_argv(expected, [2], tmp_path), "cpu")
    cfg = SolveConfig(use_fixed_step_size=True, method="rk4", trace_column_chunk=chunk["chunk"])
    out = get_log_prob(cnf, x, feats, cfg=cfg)[0]
    assert _rel(out, chunk["log_p"][2:3]) <= REL
