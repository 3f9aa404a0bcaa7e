"""The evaluation figures of the port (`utils/plotting.py`, `utils/figure.py`,
`training/setup.py: setup_default_plotter`, the MoG figures of
`examples/mog.py`) against the JAX package's (`ecnf_tpu/utils/plotting.py`,
matplotlib), on the CPU.

- Pairwise distances equal JAX's bit for bit on seeded samples with NaN and
  infinite rows; counts equal JAX's on those distances, in the default and
  in given bins, including values on bin edges, below the first, at and
  past the last, and NaN; `bin_samples_by_dist`'s shared edges within 1e-6
  of JAX's and its counts equal.
- The default plotter's two histograms equal JAX's plotter's (the same
  flow samples injected into both packages' ``sample_cnf``): counts equal,
  edges within 1e-6, the same labels; its SVG parses and each stairs
  element's heights are the counts (exactly in its ``data-values``, and to
  a hundredth of a pixel in its path).
- The MoG field on the 10 x 10 grid at t = 0.5 and 0.01 against JAX's
  ``cnf.apply`` on the same weights (within 1e-5 of the largest entry, as
  `tests/test_torch_mog.py`), and the quivers of the MoG figure hold
  exactly those vectors; both figures parse.
- `plot_history`: the same titles and points as JAX's, non-finite entries
  dropped and counted.
"""
import re
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_parity as tp  # noqa: E402
from ecnf_tpu.cnf.build import build_mlp_cnf as build_jax_mlp_cnf  # noqa: E402
from ecnf_tpu.targets.data import FullGraphSample as JaxSample  # noqa: E402
from ecnf_tpu.training import setup as jax_setup  # noqa: E402
from ecnf_tpu.utils import plotting as jax_plotting  # noqa: E402
from ecnf_tpu_torch.cnf.build import build_cnf, build_mlp_cnf  # noqa: E402
from ecnf_tpu_torch.cnf.sampling import SolveConfig  # noqa: E402
from ecnf_tpu_torch.convert import from_flax  # noqa: E402
from ecnf_tpu_torch.examples import mog  # noqa: E402
from ecnf_tpu_torch.targets.data import FullGraphSample  # noqa: E402
from ecnf_tpu_torch.training import setup as torch_setup  # noqa: E402
from ecnf_tpu_torch.utils import plotting  # noqa: E402
from ecnf_tpu_torch.utils.figure import Figure  # noqa: E402

SVG = "{http://www.w3.org/2000/svg}"
EDGE_ATOL = 1e-6


def _samples(seed, batch=16, n=7, scale=2.0):
    """Seeded positions with a NaN row, an infinite coordinate and a few
    distances past the clip."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, n, 3)) * scale).astype(np.float32)
    x[3] = np.nan
    x[5, 2, 1] = np.inf
    x[7, 0] = 50.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_vertices,max_distance", [(None, 7.99), (5, 6.0), (9, 10.0)])
def test_distances_equal_jax(seed, n_vertices, max_distance):
    x = _samples(seed)
    ref = np.asarray(jax_plotting.get_pairwise_distances_for_plotting(
        jnp.asarray(x), n_vertices, max_distance))
    out = plotting.get_pairwise_distances_for_plotting(torch.from_numpy(x), n_vertices, max_distance)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_equal_jax_default_bins(seed):
    d = np.array(jax_plotting.get_pairwise_distances_for_plotting(jnp.asarray(_samples(seed))))
    np.testing.assert_array_equal(plotting.default_bins().numpy(), np.asarray(jnp.linspace(0.0, 8.0, 50)))
    for normalize in (True, False):
        ref = np.asarray(jax_plotting.get_counts(jnp.asarray(d), normalize=normalize))
        out = plotting.get_counts(torch.from_numpy(d), normalize=normalize).numpy()
        np.testing.assert_array_equal(out, ref)


def test_counts_on_bin_edges_equal_jax():
    bins = np.arange(0.0, 9.0, dtype=np.float32)  # edges 0, 1, ..., 8
    d = np.array([0.0, 1.0, 1.0, 2.5, 3.0, 7.0, 7.999, 8.0, 8.5, -1.0, -0.0, np.nan, np.inf,
                  np.nextafter(np.float32(3.0), np.float32(0.0))], dtype=np.float32)
    for normalize in (True, False):
        ref = np.asarray(jax_plotting.get_counts(jnp.asarray(d), jnp.asarray(bins), normalize))
        out = plotting.get_counts(torch.from_numpy(d), torch.from_numpy(bins), normalize).numpy()
        np.testing.assert_array_equal(out, ref)
    raw = plotting.get_counts(torch.from_numpy(d), torch.from_numpy(bins), normalize=False)
    assert raw.tolist() == [2, 2, 2, 1, 0, 0, 0, 2]


@pytest.mark.parametrize("seed", range(6))
def test_shared_bins_equal_jax(seed):
    rng = np.random.default_rng(100 + seed)
    sets = [_samples(seed, scale=float(rng.uniform(0.3, 3.0))), _samples(seed + 50, batch=8)]
    ref_bins, ref_counts = jax_plotting.bin_samples_by_dist([jnp.asarray(s) for s in sets], 10.0)
    bins, counts = plotting.bin_samples_by_dist([torch.from_numpy(s) for s in sets], 10.0)
    np.testing.assert_allclose(bins.numpy(), np.asarray(ref_bins), rtol=0, atol=EDGE_ATOL)
    for out, ref in zip(counts, ref_counts):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_shared_bins_fallback_when_nothing_finite():
    x = np.full((2, 3, 3), np.nan, dtype=np.float32)
    ref_bins, ref_counts = jax_plotting.bin_samples_by_dist([jnp.asarray(x)], 10.0)
    bins, counts = plotting.bin_samples_by_dist([torch.from_numpy(x)], 10.0)
    np.testing.assert_allclose(bins.numpy(), np.asarray(ref_bins), rtol=0, atol=EDGE_ATOL)
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(ref_counts[0]))
    assert counts[0].sum() == 0


def _stairs(svg_path):
    """(label, values, edges, path y levels) of each stairs element."""
    root = ET.parse(svg_path).getroot()
    assert root.tag == f"{SVG}svg"
    out = []
    for p in root.iter(f"{SVG}path"):
        if p.get("class") != "stairs":
            continue
        values = np.array(p.get("data-values").split(), dtype=np.float64)
        edges = np.array(p.get("data-edges").split(), dtype=np.float64)
        ys = [float(y) for y in re.findall(r"[ML][-\d.]+,([-\d.]+)", p.get("d"))]
        out.append((p.get("data-label"), values, edges, ys))
    return out


def _pixel_heights(fig: Figure, ax_index: int, values):
    """Where the axes draws each value: the figure's own data-to-pixel map."""
    left, top, width, height = fig.axes[ax_index].box
    _, _, y0, y1 = fig.axes[ax_index].limits()
    return top + height - (np.asarray(values) - y0) / (y1 - y0) * height


@pytest.mark.parametrize("n_nodes,dim", [(5, 3), (22, 3)])
def test_default_plotter_equals_jax(tmp_path, monkeypatch, n_nodes, dim):
    rng = np.random.default_rng(n_nodes)
    n_plot, n_train = 16, 24
    train_pos = (rng.normal(size=(n_train, n_nodes, dim)) * 0.6).astype(np.float32)
    train_pos -= train_pos.mean(axis=1, keepdims=True)
    feats = np.tile(np.arange(n_nodes, dtype=np.int32)[None, :, None], (n_train, 1, 1))
    flow = (rng.normal(size=(n_plot, n_nodes * dim)) * 0.7).astype(np.float32)
    flow[2] = np.nan
    monkeypatch.setattr(jax_setup, "sample_cnf", lambda *a, **k: jnp.asarray(flow))
    monkeypatch.setattr(torch_setup, "sample_cnf", lambda *a, **k: torch.from_numpy(flow))

    jax_plotter = jax_setup.setup_default_plotter(None, n_nodes, dim, n_plot, None)
    [jax_fig] = jax_plotter(SimpleNamespace(params=None),
                            JaxSample(jnp.asarray(train_pos), jnp.asarray(feats)),
                            jax.random.PRNGKey(0))
    ref = [(p.get_label(), p.get_data()) for p in jax_fig.axes[0].patches]
    plt.close(jax_fig)

    cnf = build_cnf(n_frames=n_nodes, dim=dim, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=1,
                    mlp_units=[8], n_invariant_feat_hidden=4, time_embedding_dim=4,
                    n_features=n_nodes, device="cpu")
    plotter = torch_setup.setup_default_plotter(cnf, n_nodes, dim, n_plot, SolveConfig())
    [fig] = plotter(SimpleNamespace(params=cnf.field.state_dict()),
                    FullGraphSample(torch.from_numpy(train_pos), torch.from_numpy(feats)),
                    torch.Generator().manual_seed(0))
    fig.savefig(tmp_path / "plot.svg")
    stairs = _stairs(tmp_path / "plot.svg")

    assert [s[0] for s in stairs] == [r[0] for r in ref] == ["train samples", "flow samples"]
    for (label, values, edges, ys), (_, data) in zip(stairs, ref):
        np.testing.assert_array_equal(values, np.asarray(data.values, dtype=np.float64),
                                      err_msg=label)
        np.testing.assert_allclose(edges, np.asarray(data.edges), rtol=0, atol=EDGE_ATOL)
        # The path steps at each count's height, between the two baseline points.
        levels = np.asarray(ys[1:-1]).reshape(-1, 2)
        np.testing.assert_allclose(levels[:, 0], levels[:, 1])
        np.testing.assert_allclose(levels[:, 0], _pixel_heights(fig, 0, values), atol=0.01)
    assert stairs[0][1].sum() > 0.99 and stairs[1][1].sum() < 1.0  # the NaN sample counts as missed


def _mog_pair(seed=0, features=(32, 32)):
    jax_cnf = build_jax_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=features,
                                embedding_dim=8)
    init = jax.jit(jax_cnf.init)(jax.random.PRNGKey(1), jnp.zeros((2, 2)), jnp.zeros(2))
    tree = tp.redraw(jax.tree_util.tree_map(np.asarray, init), seed)
    cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=features,
                        embedding_dim=8, device="cpu")
    cnf.field.load_state_dict(from_flax(tree))
    return jax_cnf, jax.tree_util.tree_map(jnp.asarray, tree), cnf


@pytest.mark.parametrize("t_val", mog.FIELD_TIMES)
def test_mog_field_on_grid_equals_jax(t_val):
    jax_cnf, params, cnf = _mog_pair()
    pts, vec = mog.field_on_grid(cnf, t_val, device="cpu")
    ref_pts = np.array([(a, b) for a in np.asarray(jnp.linspace(-8, 8, 10))
                        for b in np.asarray(jnp.linspace(-8, 8, 10))], dtype=np.float32)
    np.testing.assert_array_equal(pts.numpy(), ref_pts)
    ref = np.asarray(jax_cnf.apply(params, jnp.asarray(ref_pts), jnp.full(100, t_val), None))
    np.testing.assert_allclose(vec.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_mog_figures_hold_the_field(tmp_path):
    _, _, cnf = _mog_pair(seed=4)
    train = torch.from_numpy(np.random.default_rng(0).normal(scale=4.0, size=(600, 2)).astype(np.float32))
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.25, method="rk4")
    figs = mog.mog_figures(cnf, train, torch.Generator().manual_seed(0), cfg)
    assert len(figs) == 2
    for j, fig in enumerate(figs):
        fig.savefig(tmp_path / f"plot_{j}.svg")
    root = ET.parse(tmp_path / "plot_0.svg").getroot()
    groups = [g for g in root.iter(f"{SVG}g") if g.get("class") == "scatter"]
    assert [g.get("data-label") for g in groups] == ["flow samples", "target samples"]
    assert [len(list(g)) for g in groups] == [mog.N_PLOT, mog.N_PLOT]
    root = ET.parse(tmp_path / "plot_1.svg").getroot()
    quivers = [g for g in root.iter(f"{SVG}g") if g.get("class") == "quiver"]
    titles = [t.text for t in root.iter(f"{SVG}text") if t.text and t.text.startswith("model")]
    assert titles == [f"model score at t={t}" for t in mog.FIELD_TIMES]
    for q, t_val in zip(quivers, mog.FIELD_TIMES):
        _, vec = mog.field_on_grid(cnf, t_val, device="cpu")
        for k, col in (("u", 0), ("v", 1)):
            held = np.array(q.get(f"data-{k}").split(), dtype=np.float64)
            np.testing.assert_array_equal(held, vec[:, col].double().numpy())
        assert len(q.findall(f"{SVG}line")) == 100


def test_plot_history_equals_jax(tmp_path):
    history = {"loss": [1.0, 0.5, float("nan"), 0.25, float("inf"), 0.2],
               "test_log_lik": [np.float32(-3.0), np.array(-2.5), "n/a", -2.0]}
    ref_fig = jax_plotting.plot_history(history)
    ref = [(ax.get_title(), ax.lines[0].get_xydata()) for ax in ref_fig.axes]
    plt.close(ref_fig)
    fig = plotting.plot_history(history)
    assert [ax.title for ax in fig.axes] == [r[0] for r in ref] == [
        "loss (2 non-finite dropped)", "test_log_lik (1 non-finite dropped)"]
    for ax, (_, xy) in zip(fig.axes, ref):
        s = ax.series[0]
        np.testing.assert_array_equal(np.stack([s["x"], s["y"]], axis=1), xy)
    fig.savefig(tmp_path / "history.svg")
    ET.parse(tmp_path / "history.svg")
    assert plotting.plot_history({}) is None
