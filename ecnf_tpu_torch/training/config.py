"""Typed experiment configuration: dataclasses + YAML + CLI overrides
(port of `ecnf_tpu/training/config.py`).

The same schema as the JAX package (flow / training / target / logger
sections, ``${training.batch_size}``-style interpolation, dotted
``key=value`` overrides), read with the port's own YAML reader
(`ecnf_tpu_torch.training.yaml_subset`), which resolves scalars as
PyYAML's ``safe_load`` does: ``config_to_dict`` of a config equals the JAX
package's exactly, ``init_lr: 1e-4`` a string in both.  Every field is
kept for that parity, also those the port does not act on; see
`ecnf_tpu_torch.training.setup.setup_training` for which ones it refuses.
"""
import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from ecnf_tpu_torch.training.yaml_subset import safe_load

@dataclass
class NetworkConfig:
    # Declared by the JAX package and read by neither package: the field is
    # the EGNN whatever this says.
    type: str = "egnn"
    mlp_units: Tuple[int, ...] = (128, 128, 128)
    n_blocks_egnn: int = 3
    n_invariant_feat_hidden: int = 64
    time_embedding_dim: int = 8
    stable_mlp: bool = False
    compute_dtype: Optional[str] = None  # "bfloat16" for bf16 MLP compute


@dataclass
class FlowConfig:
    sigma_min: float = 0.01
    base_scale: float = 1.0
    network: NetworkConfig = field(default_factory=NetworkConfig)


@dataclass
class OptimizerConfig:
    use_schedule: bool = True
    init_lr: float = 1e-4
    peak_lr: float = 1e-4
    end_lr: float = 0.0
    n_iter_warmup: int = 10
    optimizer: str = "adam"


@dataclass
class TrainingConfig:
    use_ema: bool = False
    ema_beta: float = 0.999
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    batch_size: int = 64
    seed: int = 0
    n_training_iter: int = 200
    plot_batch_size: int = 64
    eval_batch_size: int = 64
    train_set_size: Optional[int] = 1000
    test_set_size: Optional[int] = 1000
    eval_n_model_samples: Optional[int] = None
    eval_exact_log_prob: bool = True
    use_fixed_step_size: bool = False
    final_run: bool = True
    n_checkpoints: int = 5
    n_eval: int = 5
    save: bool = True
    save_dir: str = ""
    save_in_wandb_dir: bool = False
    resume: bool = False
    runtime_limit: Optional[float] = None
    use_64_bit: bool = False
    # Fields of the JAX package's schema beyond the reference's.  The port
    # acts on precision (float32 | tensorfloat32 | bfloat16, the process's
    # f32 matmul precision; bfloat16 runs as tensorfloat32 on a CUDA
    # card), trace_column_chunk, hutchinson_probes,
    # ode_method, microbatch and profile_dir (a torch.profiler Chrome
    # trace), and ignores compile_cache, epochs_per_dispatch and
    # eval_dispatch_chunk, which tune XLA compilation and dispatch only
    # (`setup_training`).  use_64_bit above is refused.
    precision: str = "float32"
    # Exact-trace columns per chunk (None: all at once); leaves the
    # structured tangent for the torch.func route.
    trace_column_chunk: Optional[int] = None
    # Hutchinson probes per sample when eval_exact_log_prob=false.
    hutchinson_probes: int = 1
    compile_cache: bool = True
    # Fixed-step method when use_fixed_step_size=true: "dopri5" or "rk4".
    ode_method: str = "dopri5"
    epochs_per_dispatch: int = 1
    # Each step's gradient as the mean of this many chunk gradients, the
    # random draws made per chunk; None or 1 is the one-shot gradient.
    microbatch: Optional[int] = None
    eval_dispatch_chunk: int = 8
    profile_dir: Optional[str] = None
    # Figures after each evaluation (SVG; the default plotter's sampling
    # solve runs only when true).
    eval_plots: bool = True


@dataclass
class TargetConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    valid_path: Optional[str] = None
    # Frames to drop from the head of the valid/test files (ALDP: disjoint
    # splits of one trajectory).
    valid_skip: int = 0
    test_skip: int = 0


@dataclass
class ExperimentConfig:
    flow: FlowConfig = field(default_factory=FlowConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    target: TargetConfig = field(default_factory=TargetConfig)
    logger: Dict[str, Any] = field(default_factory=lambda: {"list_logger": None})


_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def _resolve_interpolations(node: Any, root: Mapping[str, Any]) -> Any:
    """Resolve ``${a.b.c}`` references against the raw config tree."""
    if isinstance(node, dict):
        return {k: _resolve_interpolations(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interpolations(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP_RE.match(node)
        if m:
            cur: Any = root
            for part in m.group(1).split("."):
                cur = cur[part]
            return cur
    return node


def _build_dataclass(cls, data: Mapping[str, Any]):
    """Recursively construct a dataclass from a (possibly partial) mapping,
    ignoring unknown keys (e.g. hydra's own section)."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name, f in fields.items():
        if data is None or name not in data:
            continue
        value = data[name]
        # Nested dataclasses:
        nested = {
            "network": NetworkConfig,
            "optimizer": OptimizerConfig if cls is TrainingConfig else None,
            "flow": FlowConfig,
            "training": TrainingConfig,
            "target": TargetConfig,
        }
        if name in nested and nested[name] is not None and isinstance(value, Mapping):
            kwargs[name] = _build_dataclass(nested[name], value)
        elif isinstance(value, list):
            kwargs[name] = tuple(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _parse_scalar(text: str) -> Any:
    return safe_load(text)


def apply_overrides(raw: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` dotted overrides to the raw config tree."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not of the form key=value")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        cur = raw
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_scalar(value)
    return raw


_SECTION_SCHEMAS = {
    "flow": FlowConfig,
    "training": TrainingConfig,
    "target": TargetConfig,
    "logger": None,  # free-form section
}
_NESTED_SCHEMAS = {
    (FlowConfig, "network"): NetworkConfig,
    (TrainingConfig, "optimizer"): OptimizerConfig,
}


def _validate_override_path(key: str) -> None:
    """Reject typo'd override keys (unknown fields fail loudly, unlike the
    silent drop a plain dict-merge would give)."""
    parts = key.split(".")
    if parts[0] not in _SECTION_SCHEMAS:
        raise ValueError(
            f"unknown config section {parts[0]!r} in override {key!r}; "
            f"sections: {sorted(_SECTION_SCHEMAS)}"
        )
    cls = _SECTION_SCHEMAS[parts[0]]
    if cls is None:
        return  # logger section is free-form
    for part in parts[1:]:
        nested = _NESTED_SCHEMAS.get((cls, part))
        if nested is not None:
            cls = nested
            continue
        names = {f.name for f in dataclasses.fields(cls)}
        if part not in names:
            raise ValueError(
                f"unknown config field {part!r} in override {key!r}; "
                f"valid fields of {cls.__name__}: {sorted(names)}"
            )
        return  # scalar leaf reached; deeper parts would be caught above


def load_config(
    path: Optional[str] = None,
    overrides: Sequence[str] = (),
    defaults: Optional[Dict[str, Any]] = None,
) -> ExperimentConfig:
    """Load an ExperimentConfig from YAML + dotted CLI overrides."""
    raw: Dict[str, Any] = dict(defaults or {})
    if path is not None:
        with open(path) as f:
            raw.update(safe_load(f.read()) or {})
    for ov in overrides:
        if "=" in ov:
            _validate_override_path(ov.split("=", 1)[0])
    raw = apply_overrides(raw, overrides)
    raw = _resolve_interpolations(raw, raw)

    cfg = ExperimentConfig(
        flow=_build_dataclass(FlowConfig, raw.get("flow", {})),
        training=_build_dataclass(TrainingConfig, raw.get("training", {})),
        target=_build_dataclass(TargetConfig, raw.get("target", {})),
        logger=raw.get("logger", {"list_logger": None}),
    )
    return cfg


def config_to_dict(cfg: ExperimentConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
