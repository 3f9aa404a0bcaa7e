"""`python -m ecnf_tpu_torch.sample` and `build_cnf`'s device, on the CPU.

The CLI saves log q (``--log-prob-output``), serves per-atom node features
(``--features arange``, so an ALDP parameter file with ``Embed_0`` of shape
``[n_nodes, H]`` loads), and reports its first batch apart from the steady
rate; ``--method adaptive`` solves at `SolveConfig()`.  `build_cnf` builds
on the card unless the caller asks for the CPU.

With ``--checkpoint-dir`` (and ``--config``, ``--ema``, ``key=value``
overrides) the CLI serves a checkpoint the JAX package wrote, held to
what `examples/sample.py` computes from the same base samples (rtol 1e-4
fixed step, 3e-4 adaptive), and refuses the config-free route's flags.
"""
import numpy as np
import pytest
import torch

from ecnf_tpu_torch import sample
from ecnf_tpu_torch.cnf.build import build_cnf
from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf
from ecnf_tpu_torch.convert import to_flax

SMALL = [
    "--n-nodes", "5", "--batch-size", "4", "--dtype", "float32", "--n-blocks", "2",
    "--mlp-units", "32", "32", "--hidden", "16", "--step-size", "0.5", "--device", "cpu",
]


def test_log_prob_output_saves_the_log_densities(tmp_path):
    path = tmp_path / "log_q.npy"
    out = sample.main(SMALL + ["--n-samples", "6", "--with-log-prob",
                               "--log-prob-output", str(path)])
    saved = np.load(path)
    assert saved.shape == (6,) and saved.dtype == np.float32
    np.testing.assert_array_equal(saved, out["log_q"])
    assert np.isfinite(saved).all()


def test_log_prob_output_needs_with_log_prob(tmp_path):
    with pytest.raises(SystemExit) as exc:
        sample.main(SMALL + ["--n-samples", "4", "--log-prob-output", str(tmp_path / "q.npy")])
    assert exc.value.code != 0


def _npz(tmp_path, n_features):
    """A flax parameter file of the SMALL network with ``n_features`` rows
    in ``Embed_0``, saved under "/"-joined paths."""
    cnf = build_cnf(
        n_frames=5, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=2, mlp_units=(32, 32),
        n_invariant_feat_hidden=16, time_embedding_dim=8, n_features=n_features, device="cpu",
        generator=torch.Generator().manual_seed(1),
    )
    with torch.no_grad():
        cnf.field.embed.weight.copy_(torch.arange(n_features * 16.0).reshape(n_features, 16) / 40)
    flat = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = value

    walk(to_flax(cnf.field)["params"], "")
    path = tmp_path / f"params_{n_features}.npz"
    np.savez(path, **flat)
    return path


def test_features_arange_serves_a_per_atom_embedding(tmp_path):
    path = _npz(tmp_path, n_features=5)
    assert np.load(path)["Embed_0/embedding"].shape == (5, 16)
    argv = SMALL + ["--n-samples", "4", "--with-log-prob", "--params-npz", str(path)]
    out = sample.main(argv + ["--features", "arange"])
    assert np.isfinite(out["samples"]).all() and np.isfinite(out["log_q"]).all()
    # The zero features build a one-row embedding, which the file does not fit.
    with pytest.raises(RuntimeError, match="size mismatch"):
        sample.main(argv + ["--features", "zeros"])


def test_features_arange_changes_what_the_field_sees(tmp_path):
    # With per-atom features each atom gets its own embedding row, so the
    # samples differ from those of all-zero features on the same weights.
    path = _npz(tmp_path, n_features=5)
    argv = SMALL + ["--n-samples", "4", "--params-npz", str(path), "--seed", "2"]
    arange = sample.main(argv + ["--features", "arange"])["samples"]
    with np.load(path) as npz:
        one_row = {k: npz[k] for k in npz.files}
    one_row["Embed_0/embedding"] = one_row["Embed_0/embedding"][:1]
    np.savez(tmp_path / "one_row.npz", **one_row)
    zeros = sample.main(SMALL + ["--n-samples", "4", "--params-npz", str(tmp_path / "one_row.npz"),
                                 "--seed", "2", "--features", "zeros"])["samples"]
    assert np.abs(arange - zeros).max() > 1e-3


def test_first_batch_is_reported_apart(capsys):
    out = sample.main(SMALL + ["--n-samples", "12"])
    printed = capsys.readouterr().out
    assert "first batch of 4" in printed and "steady" in printed and "other 8" in printed
    assert 0 < out["first_batch_seconds"] < out["seconds"]
    assert out["steady_per_second"] > 0
    single = sample.main(SMALL + ["--n-samples", "3"])
    assert single["steady_per_second"] is None
    assert "single batch" in capsys.readouterr().out


def test_build_cnf_defaults_to_the_card():
    kw = dict(n_frames=5, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=1,
              mlp_units=(32,), n_invariant_feat_hidden=16, time_embedding_dim=8, n_features=1)
    on_cpu = build_cnf(**kw, device="cpu")
    assert on_cpu.field.egnn.final_scaling.device.type == "cpu"
    if torch.cuda.is_available():
        assert build_cnf(**kw).field.egnn.final_scaling.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_cnf(**kw)


def test_adaptive_method_matches_sample_and_log_prob_at_solve_config():
    # `--method adaptive` is `SolveConfig()` with the given rtol/atol: the
    # CLI's samples and log q equal a direct call on the same weights and
    # the same seeded draws.
    argv = SMALL + ["--n-samples", "4", "--with-log-prob", "--method", "adaptive", "--seed", "3"]
    out = sample.main(argv)
    args = sample.build_parser().parse_args(argv)
    cnf = sample.build_from_args(args, torch.device("cpu"))
    features = torch.zeros((4, 5), dtype=torch.int64)
    x1, log_q = sample_and_log_prob_cnf(
        cnf, 4, features, cfg=SolveConfig(), generator=torch.Generator().manual_seed(3)
    )
    np.testing.assert_array_equal(out["samples"], x1.numpy())
    np.testing.assert_array_equal(out["log_q"], log_q.numpy())
    cfg = sample.solve_config(sample.build_parser().parse_args(argv + ["--rtol", "1e-3"]))
    assert cfg == SolveConfig(rtol=1e-3, step_size=0.5)  # SMALL sets --step-size 0.5


# --- The reference surface: --config / --checkpoint-dir / --ema / overrides on
# a checkpoint the JAX package's `save_checkpoint` writes.

from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from ecnf_tpu.cnf import sampling as jax_sampling  # noqa: E402
from ecnf_tpu.cnf.build import build_cnf as build_jax_cnf  # noqa: E402
from ecnf_tpu.training import checkpoints as jax_ckpt  # noqa: E402
from ecnf_tpu.training.config import load_config as jax_load_config  # noqa: E402

LJ13 = str(Path(__file__).resolve().parent.parent / "examples" / "configs" / "lj13.yaml")
SMALL_CONFIG = [
    "flow.network.n_blocks_egnn=2", "flow.network.mlp_units=[32,32]",
    f"flow.network.n_invariant_feat_hidden={tp.H}", f"flow.network.time_embedding_dim={tp.T}",
    "flow.network.compute_dtype=float32",
]
RK4 = ["training.use_fixed_step_size=true", "training.ode_method=rk4"]


@pytest.fixture(scope="module")
def jax_checkpoint_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_checkpoints")
    _, _, state = tp.jax_training_state(use_ema=True, seed=11)
    jax_ckpt.save_checkpoint(str(root), 9, state)
    return root


def _reference_sample(checkpoint_dir, overrides, ema, x0):
    """What `examples/sample.py` computes from the base samples ``x0``: the
    network and the solve from the config, the checkpoint's (EMA) params,
    the forward solve with the exact trace."""
    cfg = jax_load_config(LJ13, overrides=overrides)
    net = cfg.flow.network
    cnf = build_jax_cnf(
        n_frames=tp.N, dim=tp.DIM, sigma_min=cfg.flow.sigma_min, base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net.n_blocks_egnn, mlp_units=tuple(net.mlp_units),
        n_invariant_feat_hidden=net.n_invariant_feat_hidden,
        time_embedding_dim=net.time_embedding_dim, n_features=1, stable_mlp=net.stable_mlp,
        compute_dtype=net.compute_dtype,
    )
    B = x0.shape[0]
    feats = jnp.zeros((B, tp.N), jnp.int32)
    template = cnf.init(jax.random.PRNGKey(0), jnp.zeros((2, tp.N * tp.DIM)), jnp.zeros(2), feats[:2])
    latest = jax_ckpt.get_latest_checkpoint(str(checkpoint_dir))
    params = jax_ckpt.restore_serving_params(latest, template, ema=ema)
    solve = jax_sampling.SolveConfig(
        use_fixed_step_size=cfg.training.use_fixed_step_size, method=cfg.training.ode_method,
        hutchinson_probes=cfg.training.hutchinson_probes,
    )
    func = jax_sampling._augmented_field(cnf, params, feats, False, None, solve)
    x0 = jnp.asarray(x0)
    y1, _ = jax_sampling._solve(func, jnp.concatenate([x0, jnp.zeros((B, 1))], axis=-1), 0.0, 1.0, solve)
    return np.asarray(y1[:, :-1]), np.asarray(cnf.log_prob_base(x0) - y1[:, -1])


@pytest.mark.parametrize("solve,ema,rtol", [("adaptive", True, 3e-4), ("rk4", False, 1e-4),
                                            ("rk4", True, 1e-4)])
def test_checkpoint_dir_samples_match_jax(jax_checkpoint_dir, capsys, solve, ema, rtol):
    overrides = SMALL_CONFIG + (RK4 if solve == "rk4" else [])
    argv = ["--checkpoint-dir", str(jax_checkpoint_dir), "--n-nodes", str(tp.N), "--n-samples", "4",
            "--batch-size", "4", "--with-log-prob", "--seed", "5", "--device", "cpu",
            *(["--ema"] if ema else []), *overrides]
    out = sample.main(argv)
    assert "restoring" in capsys.readouterr().out
    # The port's base samples: the first draw of the seeded CPU generator.
    base = build_cnf(n_frames=tp.N, dim=tp.DIM, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=1,
                     mlp_units=(8,), n_invariant_feat_hidden=8, time_embedding_dim=4, n_features=1,
                     device="cpu")
    x0 = base.sample_base((4,), generator=torch.Generator().manual_seed(5)).numpy()
    x1, log_q = _reference_sample(jax_checkpoint_dir, overrides, ema, x0)
    np.testing.assert_allclose(out["samples"], x1, atol=1e-4 if solve == "rk4" else 1e-3)
    np.testing.assert_allclose(out["log_q"], log_q, rtol=rtol)


def test_checkpoint_dir_refuses_the_flag_route(jax_checkpoint_dir, tmp_path):
    path = _npz(tmp_path, n_features=1)
    base = ["--checkpoint-dir", str(jax_checkpoint_dir), "--n-nodes", str(tp.N), "--n-samples", "2",
            "--device", "cpu", *SMALL_CONFIG]
    for extra in (["--params-npz", str(path)], ["--mlp-units", "32", "32"], ["--dtype", "float32"]):
        with pytest.raises(SystemExit) as exc:
            sample.main(base + extra)
        assert exc.value.code == 2
    with pytest.raises(NotImplementedError, match="network.stable_mlp"):
        sample.main(base + ["flow.network.stable_mlp=true"])
