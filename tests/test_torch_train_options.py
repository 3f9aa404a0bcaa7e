"""The experiment options that `setup_training` once refused, against the
JAX package, on the CPU: ``training.precision``, ``training.profile_dir``,
``training.trace_column_chunk``, ``network.stable_mlp`` and
``network.type``; and ``training.use_64_bit``, which stays refused because
the JAX package does not run it.

The program is DW4 at the examples' ``--local`` widths on the fixture
chains of `test_torch_train_program.py`.  The first evaluation with the
StableMLP field and the chunked trace runs fixed-step rk4 on one test
batch (the ``torch.func`` route is slow on the CPU under adaptive steps):
test_log_lik rel 1e-4 (f32 exact trace, the same steps), forward_ess
within 1e-3.
"""
import json

import jax
import numpy as np
import pytest
import torch

from ecnf_tpu.parallel.mesh import get_mesh
from ecnf_tpu.targets import data as jax_data
from ecnf_tpu.targets import energies as jax_energies
from ecnf_tpu.training import loop as jax_loop
from ecnf_tpu.training import setup as jax_setup
from ecnf_tpu_torch.convert import from_flax
from ecnf_tpu_torch.training import setup as torch_setup
from test_torch_train_program import _configs, _run, _setups, data_dir  # noqa: F401


@pytest.fixture(autouse=True)
def restore_precision():
    """Both packages' process-wide matmul precision, as a test found them."""
    torch_before = torch.get_float32_matmul_precision()
    jax_before = jax.config.jax_default_matmul_precision
    yield
    torch.set_float32_matmul_precision(torch_before)
    jax.config.update("jax_default_matmul_precision", jax_before)


@pytest.mark.parametrize("name,torch_name", sorted(torch_setup.MATMUL_PRECISION.items()))
def test_precision_maps_to_torch(name, torch_name, data_dir, tmp_path):  # noqa: F811
    torch.set_float32_matmul_precision("medium" if torch_name == "highest" else "highest")
    cfg, jax_cfg = _configs(tmp_path, f"training.precision={name}")
    jax_tc, _ = _setups(cfg, jax_cfg, data_dir)
    assert torch.get_float32_matmul_precision() == torch_name
    # JAX sets its default matmul precision to the same name, except for
    # float32, which it leaves as it was.
    if name != "float32":
        assert jax.config.jax_default_matmul_precision == name
    assert torch_setup.MATMUL_PRECISION == {
        "float32": "highest", "tensorfloat32": "high", "bfloat16": "medium"}


def test_precision_refuses_other_names(tmp_path):
    with pytest.raises(ValueError, match=r"\['bfloat16', 'float32', 'tensorfloat32'\]"):
        torch_setup.set_matmul_precision("highest")
    cfg, _ = _configs(tmp_path, "training.precision=fp16")
    with pytest.raises(ValueError, match="training.precision='fp16'"):
        torch_setup.setup_training(cfg, lambda a, b: None, device="cpu")


@pytest.mark.parametrize("cuda", [False, True], ids=["cpu", "card"])
def test_bfloat16_precision_warns_on_a_card(cuda, monkeypatch, recwarn):
    """CUDA's f32 products run "medium" as TF32: the port says so there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    for name in ("float32", "tensorfloat32", "bfloat16"):
        torch_setup.set_matmul_precision(name)
    said = [str(w.message) for w in recwarn if "tensorfloat32" in str(w.message)]
    assert len(said) == int(cuda)
    assert torch.get_float32_matmul_precision() == "medium"


def test_stable_mlp_and_chunked_trace_first_evaluation_match_jax(data_dir, tmp_path):  # noqa: F811
    cfg, jax_cfg = _configs(tmp_path, "flow.network.stable_mlp=true",
                            "flow.network.mlp_units=[16,16]", "training.trace_column_chunk=2",
                            "training.use_fixed_step_size=true", "training.ode_method=rk4",
                            "training.test_set_size=9")
    jax_tc, tc = _setups(cfg, jax_cfg, data_dir)
    jax_state = jax_tc.init_state(jax.random.PRNGKey(0))
    ref = jax_tc.eval_and_plot_fn(jax_state, jax.random.PRNGKey(1), -1, False, None)
    state = tc.init_state(torch.Generator().manual_seed(0))
    weights = from_flax(jax.device_get(jax_state.params))
    assert sorted(weights) == sorted(state.params)
    assert any(".residual." in name for name in weights)
    state = state._replace(params=weights)
    ours = tc.eval_and_plot_fn(state, torch.Generator().manual_seed(1), -1, False, None)
    np.testing.assert_allclose(ours["test_log_lik"], ref["test_log_lik"], rtol=1e-4)
    np.testing.assert_allclose(ours["forward_ess"], ref["forward_ess"], atol=1e-3)
    assert float(ours["eval_ode_steps"]) == float(ref["eval_ode_steps"]) == 20


def test_network_type_is_read_by_neither_package(data_dir, tmp_path):  # noqa: F811
    cfg, jax_cfg = _configs(tmp_path, "flow.network.type=foo")
    assert cfg.flow.network.type == jax_cfg.flow.network.type == "foo"
    jax_tc, tc = _setups(cfg, jax_cfg, data_dir)
    jax_params = jax.device_get(jax_tc.init_state(jax.random.PRNGKey(0)).params)
    state = tc.init_state(torch.Generator().manual_seed(0))
    assert "EGNN_0" in jax_params["params"]
    assert sorted(from_flax(jax_params)) == sorted(state.params)


def _trace_events(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def test_profile_dir_writes_a_trace_and_not_on_resume(data_dir, tmp_path):  # noqa: F811
    save_dir, profile = tmp_path / "run", tmp_path / "profile"
    argv = ["--local", "--device", "cpu", "training.save=true", f"training.save_dir={save_dir}",
            "training.n_eval=1", "training.n_checkpoints=1", "training.test_set_size=9",
            f"training.profile_dir={profile}"]
    _run(argv + ["training.n_training_iter=3"], data_dir)
    trace = profile / "trace.json"
    assert trace.exists()
    names = {e["name"] for e in _trace_events(trace)}
    assert any("addmm" in n or "aten::mm" in n for n in names), sorted(names)[:20]
    trace.unlink()
    logger, _ = _run(argv + ["training.n_training_iter=4", "training.resume=true"], data_dir)
    assert logger.history["iteration"][0] == 3.0
    assert not trace.exists()


def test_use_64_bit_is_refused_as_jax_fails_it(data_dir, tmp_path):  # noqa: F811
    cfg, jax_cfg = _configs(tmp_path, "training.use_64_bit=true", "training.n_training_iter=1")
    with pytest.raises(NotImplementedError, match=r"use_64_bit=True.*ode\.py:237"):
        torch_setup.setup_training(cfg, lambda a, b: None, device="cpu")

    def jax_load(train_set_size, test_set_size):
        train, _, test = jax_data.load_dw4(train_set_size, path=data_dir)
        return train, test[:test_set_size]

    jax_tc = jax_setup.setup_training(jax_cfg, jax_load, jax_energies.double_well_log_prob,
                                      mesh=get_mesh(jax.devices()[:1]))
    # The first evaluation's while_loop: carry float32 in, float64 out.
    try:
        with pytest.raises(TypeError, match=r"float32\[9,9\] but .* float64\[9,9\]"):
            jax_loop.run_training(jax_tc)
    finally:
        jax.config.update("jax_enable_x64", False)
