"""The port's config loading against the JAX package's: every shipped
YAML, bare, under the examples' ``--local`` block and under overrides,
gives the same ``config_to_dict``, exactly (``init_lr: 1e-4`` is the
string ``'1e-4'`` in both, as PyYAML's YAML 1.1 resolver reads it).
Unknown sections and fields are refused as JAX refuses them; YAML outside
the reader's subset is refused with its line number."""
import ast
import math
from pathlib import Path

import pytest
import yaml

from ecnf_tpu.training import config as jax_config
from ecnf_tpu_torch.examples import common, dw4
from ecnf_tpu_torch.training import config
from ecnf_tpu_torch.training.yaml_subset import YAMLSubsetError, safe_load

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ["dw4", "lj13", "qm9", "aldp", "aldp_soak"]
OVERRIDES = (
    "training.eval_n_model_samples=10_000",
    "flow.network.mlp_units=[16]",
    "logger={csv_logger: {save_period: 5}}",
    "training.optimizer.init_lr=3e-4",
    "training.optimizer.peak_lr=2.5e-4",
    "training.save_dir='runs/x y'",
    "training.runtime_limit=0.5",
    "training.resume=true",
    "flow.network.compute_dtype=null",
    "flow.base_scale=2.",
    "training.seed=0x10",
    "target.test_skip=1_600",
)


def _jax_local_overrides():
    """``LOCAL_OVERRIDES`` of `examples/common.py`, read from its source."""
    tree = ast.parse((REPO / "examples" / "common.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "LOCAL_OVERRIDES":
            return ast.literal_eval(node.value)
    raise AssertionError("LOCAL_OVERRIDES not found")


def test_local_block_is_the_jax_examples():
    assert common.LOCAL_OVERRIDES == _jax_local_overrides()
    assert '"flow.base_scale=2.0"' in (REPO / "examples" / "dw4.py").read_text()
    assert dw4.LOCAL_EXTRA == ("flow.base_scale=2.0",)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("case", ["bare", "local", "overrides", "local+overrides"])
def test_config_to_dict_equals_jax(name, case):
    path = str(REPO / "examples" / "configs" / f"{name}.yaml")
    overrides = []
    if "local" in case:
        overrides += list(common.LOCAL_OVERRIDES)
    if "overrides" in case:
        overrides += list(OVERRIDES)
    ours = config.config_to_dict(config.load_config(path, overrides))
    ref = jax_config.config_to_dict(jax_config.load_config(path, overrides))
    assert ours == ref
    assert repr(ours) == repr(ref)  # types too: '1e-4' stays a string, 10_000 an int
    assert ours["training"]["optimizer"]["init_lr"] == ("3e-4" if "overrides" in case else "1e-4")


@pytest.mark.parametrize("override", [
    "nope.x=1", "training.nope=1", "flow.network.nope=1", "training.optimizer.nope=2",
    "target.nope=3",
])
def test_unknown_override_refused_as_jax(override):
    with pytest.raises(ValueError) as ours:
        config.load_config(None, [override])
    with pytest.raises(ValueError) as ref:
        jax_config.load_config(None, [override])
    assert str(ours.value) == str(ref.value)


def test_override_without_equals_refused():
    with pytest.raises(ValueError, match="key=value"):
        config.apply_overrides({}, ["training.seed"])


SCALARS = [
    "1e-4", "1.", "0.", "10_000", "0.000001", "2e-4", "null", "~", "", "true", "on", "Off",
    "yes", "NO", "0b101", "017", "0x1F", "1:30", "1:30.5", ".inf", "-.inf", ".nan", "+12", "-0",
    "1_0.5", "abc", "runs/dw4", "'runs/dw4'", '"a\\tb"', "'it''s'", "[128, 128, 128]", "[16]",
    "{list_logger: null}", "{csv_logger: {save_period: 5}}", "[]", "{}", "[1, 2, ]", "{a: }",
    "1.0e+3", "1.0e3", "1e3", "-1", "09", "08", "3.14_15", "[a, 'b c', \"d\"]",
    "{a: [1, {b: 2}]}", "it's", "a:b", "http://x.y", "  5  ", "5 # c", "'a # b'", "NaN", ".5",
    "-.5e+1", "_1", "key: value", "a: {b: [1, 2]}",
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return repr(a) == repr(b)


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_as_pyyaml(text):
    assert _same(safe_load(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_reads_shipped_configs_as_pyyaml(name):
    text = (REPO / "examples" / "configs" / f"{name}.yaml").read_text()
    assert repr(safe_load(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  - x\n", 3),
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: !!str 3\n", 1),
    ("a:\n  b: [1,\n    2]\n", 2),
    ("a: 1\n  b: 2\n", 2),
    ("a: b: c\n", 1),
    ("a: 'open\n", 1),
    ("---\na: 1\n", 1),
    ("a: 2001-12-14\n", 1),
    ("a: |\n  text\n", 1),
    ("a: \"\\q\"\n", 1),
    ("a: 1\n\tb: 2\n", 2),
    ("plain\nscalar\n", 2),
])
def test_reader_refuses_outside_the_subset_with_line(text, line):
    with pytest.raises(YAMLSubsetError, match=rf"line {line}\b"):
        safe_load(text)


def test_load_config_refuses_bad_yaml_with_line(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("flow:\n  sigma_min: 0.01\n  network:\n    mlp_units:\n      - 16\n")
    with pytest.raises(YAMLSubsetError, match="line 5"):
        config.load_config(str(path))
