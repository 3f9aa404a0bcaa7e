"""EGNN field forward: the port's `FlatEGNNField` vs the JAX `cnf.apply`.

Both run on the same redrawn weights (`torch_parity.make_pair`) and inputs.
Tolerances: f32 atol 1e-5; bf16 atol 2e-2, because the two frameworks round
bf16 intermediates at different places.
"""
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu_torch.utils.test_utils import random_rotation_matrix


@pytest.mark.parametrize(
    "blocks,units,cdt,atol",
    [
        (2, (32, 32), None, 1e-5),
        (3, (32, 32, 32), None, 1e-5),
        (2, (32, 32), "bfloat16", 2e-2),
        (3, (32, 32, 32), "bfloat16", 2e-2),
    ],
)
def test_forward_matches_jax(blocks, units, cdt, atol):
    jax_cnf, params, cnf = tp.make_pair(blocks, units, cdt, seed=blocks)
    x, t, feats = tp.inputs(seed=blocks)
    ref = np.asarray(jax_cnf.apply(params, x, t, feats))
    with torch.no_grad():
        out = cnf.apply(*tp.to_torch(x, t, feats)).numpy()
    assert np.abs(ref).max() > 0.1  # redrawn weights: an O(1) field
    np.testing.assert_allclose(out, ref, atol=atol)


def test_forward_is_translation_and_rotation_equivariant():
    _, _, cnf = tp.make_pair()
    x, t, feats = tp.to_torch(*tp.inputs())
    q = random_rotation_matrix(torch.Generator().manual_seed(0), 3)
    with torch.no_grad():
        f = cnf.apply(x, t, feats).reshape(-1, tp.N, 3)
        x_rot = (x.reshape(-1, tp.N, 3) @ q.T).reshape(x.shape)
        f_rot = cnf.apply(x_rot, t, feats).reshape(-1, tp.N, 3)
        f_shift = cnf.apply(x + 0.7, t, feats).reshape(-1, tp.N, 3)
    torch.testing.assert_close(f_rot, f @ q.T, atol=1e-5, rtol=1e-5)
    # f(x + 1 (x) delta) = f(x) - final_scaling * delta: translations are
    # eigenvectors with eigenvalue -final_scaling (the exact-trace offset).
    torch.testing.assert_close(f_shift, f - 0.7, atol=1e-5, rtol=1e-5)
