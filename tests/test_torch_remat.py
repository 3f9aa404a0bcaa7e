"""``remat_blocks`` (`models/egnn.py`): the EGCL blocks recomputed in the
backward pass, fully (``True``) or all but their matrix products
(``"dots"``), on the CPU.

The JAX package's contract (`tests/test_models.py:169-190`): parameter
names do not change, and the gradient does not either.  Bands: gradients
within 1e-6 absolute of ``remat_blocks=False`` (f32 parameters; the same
operations run again, so they agree to rounding); solves under
``no_grad`` do not pass through the checkpoint, so they are equal bit for
bit.  Against JAX's ``build_cnf(remat_blocks=...)`` on the same weights
and draws, the loss and gradients are held at `test_torch_train.py`'s
bands: f32 rtol 1e-5 (each leaf within 1e-5 of its own largest |g|), bf16
3e-2 of the gradient's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ecnf_tpu.cnf.loss import flow_matching_loss_fn as jax_loss_fn
from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob
from ecnf_tpu_torch.models.egnn import EGCL
from ecnf_tpu_torch.training.state import loss_and_grads

ATOL = 1e-6
MODES = [False, True, "dots"]


def _cnf(remat, stable=False, cdt=None):
    kw = tp.cnf_kwargs(2, (16, 16), cdt, n=4, stable=stable, hidden=8)
    return build_cnf(**kw, remat_blocks=remat, device="cpu",
                     generator=torch.Generator().manual_seed(0))


def test_parameter_names_do_not_change():
    keys = [sorted(_cnf(m).field.state_dict()) for m in MODES]
    assert keys[0] == keys[1] == keys[2]
    with pytest.raises(ValueError, match="remat_blocks"):
        _cnf("all")


@pytest.mark.parametrize("stable", [False, True], ids=["mlp", "stable_mlp"])
def test_gradients_equal_without_remat(stable):
    x, _, feats = tp.inputs(4, 3, batch=6, seed=1)
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn((6, 12), generator=gen)
    t = torch.rand((6,), generator=gen)
    # Parameters other than the field's own: the recomputation must read
    # the tensors the forward pass was given.
    base = _cnf(False, stable)
    params = {n: p.detach() + 0.05 * torch.randn(p.shape, generator=gen)
              for n, p in base.field.named_parameters()}
    grads = {}
    for mode in MODES:
        cnf = _cnf(mode, stable)
        grads[mode], loss = loss_and_grads(cnf, params, *tp.to_torch(x, feats), x0=x0, t=t)
        grads[mode].append(loss)
    for mode in (True, "dots"):
        for g, ref in zip(grads[mode], grads[False]):
            assert (g - ref).abs().max().item() <= ATOL, mode


def test_remat_recomputes_each_block_in_backward(monkeypatch):
    calls = []
    forward = EGCL.forward

    def counted(self, *args):
        calls.append(torch.is_grad_enabled())
        return forward(self, *args)

    monkeypatch.setattr(EGCL, "forward", counted)
    x, _, feats = tp.inputs(4, 3, batch=2, seed=2)
    for mode, expect in ((False, 2), (True, 4), ("dots", 4)):
        cnf = _cnf(mode)
        calls.clear()
        params = {n: p.detach() for n, p in cnf.field.named_parameters()}
        loss_and_grads(cnf, params, *tp.to_torch(x, feats), generator=torch.Generator())
        assert len(calls) == expect, (mode, calls)


JAX_CASES = [(mode, cdt, stable) for mode in (True, "dots") for cdt in (None, "bfloat16")
             for stable in (False, True)]


@pytest.mark.parametrize("mode,cdt,stable", JAX_CASES,
                         ids=[f"{m}-{c or 'f32'}-{'stable' if s else 'mlp'}" for m, c, s in JAX_CASES])
def test_gradients_match_jax_remat(mode, cdt, stable):
    from test_torch_train import BF16_BAND, RTOL, _draws, _tree

    jax_cnf, jax_params, cnf = tp.make_pair(2, (16, 16), cdt, seed=7, n=4, stable=stable,
                                            hidden=8, remat_blocks=mode)
    assert jax_cnf.apply.__self__.remat_blocks == mode == cnf.field.egnn.remat_blocks
    x, _, feats = tp.inputs(4, 3, batch=8, seed=8)
    key = jax.random.PRNGKey(9)
    _, x0, t = _draws(jax_cnf, key, None, batch=8)
    _, sub = jax.random.split(key)
    g, info = jax.grad(jax_loss_fn, argnums=1, has_aux=True)(
        jax_cnf, jax_params, jnp.asarray(x), sub, jnp.asarray(feats))
    ref = _tree(g)
    params = {n: p.detach().clone() for n, p in cnf.field.named_parameters()}
    # The shared weights reach the port only through ``params``: the
    # module's own are scaled away, so a recomputation that read them
    # would not match JAX.
    with torch.no_grad():
        for p in cnf.field.parameters():
            p.mul_(0.5)
    port, loss = loss_and_grads(cnf, params, *tp.to_torch(x, feats),
                                x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    band = RTOL if cdt is None else BF16_BAND
    jax_loss = float(info["loss"])
    assert abs(loss.item() - jax_loss) <= band * abs(jax_loss)
    scale = max(r.abs().max().item() for r in ref.values())
    for name, grad in zip(params, port):
        leaf = ref[name].abs().max().item() if cdt is None else scale
        assert (grad - ref[name]).abs().max().item() <= band * leaf, name


@pytest.mark.parametrize("mode", [True, "dots"])
def test_solves_unchanged_under_no_grad(mode):
    x, _, feats = tp.inputs(4, 3, batch=3, seed=4)
    cfg = SolveConfig(use_fixed_step_size=True, method="rk4", step_size=0.25)
    ref = get_log_prob(_cnf(False), *tp.to_torch(x, feats), cfg=cfg)
    out = get_log_prob(_cnf(mode), *tp.to_torch(x, feats), cfg=cfg)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    generic = SolveConfig(use_fixed_step_size=True, method="rk4", step_size=0.25,
                          trace_column_chunk=4)
    ref = get_log_prob(_cnf(False, stable=True), *tp.to_torch(x, feats), cfg=generic)[0]
    out = get_log_prob(_cnf(mode, stable=True), *tp.to_torch(x, feats), cfg=generic)[0]
    assert torch.equal(out, ref)
    assert np.isfinite(out.numpy()).all()
