"""`python -m ecnf_tpu_torch.sample` and `build_cnf`'s device, on the CPU.

The CLI saves log q (``--log-prob-output``), serves per-atom node features
(``--features arange``, so an ALDP parameter file with ``Embed_0`` of shape
``[n_nodes, H]`` loads), and reports its first batch apart from the steady
rate.  `build_cnf` builds on the card unless the caller asks for the CPU.
"""
import numpy as np
import pytest
import torch

from ecnf_tpu_torch import sample
from ecnf_tpu_torch.cnf.build import build_cnf
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
