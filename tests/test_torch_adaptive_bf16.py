"""The CNF solves at `SolveConfig()` in bf16 against the JAX package: the
cases of `tests/test_torch_adaptive.py` with the EGNN's MLPs in bf16, held
to the port's bf16 band (log p / log q within 3e-2 relative, x1 within
3e-2 absolute) and the same step-count slack.  A file of their own, so
that the test workers run them beside the f32 cases.
"""
import pytest

import test_torch_adaptive as adaptive


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "hutchinson4"])
def test_get_log_prob_matches_jax_bf16(approx):
    adaptive.check_get_log_prob("bfloat16", approx)


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "hutchinson4"])
def test_sample_and_log_prob_matches_jax_bf16(approx):
    adaptive.check_sample_and_log_prob("bfloat16", approx)
