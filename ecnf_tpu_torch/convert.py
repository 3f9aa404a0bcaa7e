"""Weight bridge between the JAX package's flax parameters and the port.

`from_flax` turns a flax parameter tree of `ecnf_tpu.cnf.build.build_cnf`'s
field (a nested dict of arrays, with or without the top ``"params"`` key,
or a flat mapping of ``"/"``-joined paths as saved with ``numpy.savez``)
into a ``state_dict`` of `ecnf_tpu_torch.cnf.build.FlatEGNNField`, and
one of `ecnf_tpu.models.vector_net.VectorNet` (the MoG field) into one of
`ecnf_tpu_torch.models.vector_net.VectorNet`; `to_flax` is the inverse.
Both know the plain and the `StableMLP` EGNN (``network.stable_mlp``).
This is the only place where layouts change: flax Dense kernels are ``[in,
out]``, torch weights ``[out, in]``.
"""
import re
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

_MLPS = {"MLP_0": "phi_e", "MLP_1": "phi_x", "MLP_2": "phi_h"}
_STABLE_MLPS = {"StableMLP_0": "phi_e", "StableMLP_1": "phi_x", "StableMLP_2": "phi_h"}
_DENSES = {"Dense_0": "phi_x_out", "Dense_1": "gate"}
_LEAVES = {"kernel": "weight", "bias": "bias"}


def _torch_name(path: str) -> str:
    """``EGNN_0/EGCL_1/MLP_0/Dense_0/kernel`` -> ``egnn.blocks.1.phi_e.layers.1.weight``."""
    if path == "Embed_0/embedding":
        return "embed.weight"
    if path == "EGNN_0/final_scaling":
        return "egnn.final_scaling"
    m = re.fullmatch(r"EGNN_0/ConcatDense_(\d+)/(kernel|bias)", path)
    if m:
        return f"egnn.time_dense.{m[1]}.{_LEAVES[m[2]]}"
    m = re.fullmatch(r"EGNN_0/EGCL_(\d+)/(MLP_[012])/(ConcatDense_0|Dense_(\d+))/(kernel|bias)", path)
    if m:
        layer = 0 if m[4] is None else int(m[4]) + 1
        return f"egnn.blocks.{m[1]}.{_MLPS[m[2]]}.layers.{layer}.{_LEAVES[m[5]]}"
    m = re.fullmatch(r"EGNN_0/EGCL_(\d+)/(Dense_[01])/(kernel|bias)", path)
    if m:
        return f"egnn.blocks.{m[1]}.{_DENSES[m[2]]}.{_LEAVES[m[3]]}"
    m = re.fullmatch(r"EGNN_0/EGCL_(\d+)/(StableMLP_[012])/(.+)", path)
    if m:
        prefix = f"egnn.blocks.{m[1]}.{_STABLE_MLPS[m[2]]}"
        inner = m[3]
        m = re.fullmatch(r"(ConcatDense_0|Dense_0)/(kernel|bias)", inner)
        if m:
            return f"{prefix}.{'first' if m[1] == 'ConcatDense_0' else 'out'}.{_LEAVES[m[2]]}"
        m = re.fullmatch(r"NonLinearLayerWithResidualAndLayerNorm_(\d+)/"
                         r"(?:Dense_0/(kernel|bias)|LayerNorm_0/(scale|bias))", inner)
        if m and m[2]:
            return f"{prefix}.residual.{m[1]}.dense.{_LEAVES[m[2]]}"
        if m:
            return f"{prefix}.residual.{m[1]}.norm.{m[3]}"
    m = re.fullmatch(r"ConcatDense_(\d+)/(kernel|bias)", path)  # VectorNet
    if m:
        return f"layers.{m[1]}.{_LEAVES[m[2]]}"
    m = re.fullmatch(r"Dense_0/(kernel|bias)", path)
    if m:
        return f"out.{_LEAVES[m[1]]}"
    raise KeyError(f"unknown flax parameter {path!r}")


def _flax_path(name: str) -> str:
    """Inverse of `_torch_name`."""
    if name == "embed.weight":
        return "Embed_0/embedding"
    if name == "egnn.final_scaling":
        return "EGNN_0/final_scaling"
    leaves = {v: k for k, v in _LEAVES.items()}
    m = re.fullmatch(r"egnn\.time_dense\.(\d+)\.(weight|bias)", name)
    if m:
        return f"EGNN_0/ConcatDense_{m[1]}/{leaves[m[2]]}"
    m = re.fullmatch(r"egnn\.blocks\.(\d+)\.(phi_[exh])\.layers\.(\d+)\.(weight|bias)", name)
    if m:
        mlp = {v: k for k, v in _MLPS.items()}[m[2]]
        layer = int(m[3])
        dense = "ConcatDense_0" if layer == 0 else f"Dense_{layer - 1}"
        return f"EGNN_0/EGCL_{m[1]}/{mlp}/{dense}/{leaves[m[4]]}"
    m = re.fullmatch(r"egnn\.blocks\.(\d+)\.(phi_x_out|gate)\.(weight|bias)", name)
    if m:
        dense = {v: k for k, v in _DENSES.items()}[m[2]]
        return f"EGNN_0/EGCL_{m[1]}/{dense}/{leaves[m[3]]}"
    m = re.fullmatch(r"egnn\.blocks\.(\d+)\.(phi_[exh])\.(first|out)\.(weight|bias)", name)
    if m:
        mlp = {v: k for k, v in _STABLE_MLPS.items()}[m[2]]
        dense = "ConcatDense_0" if m[3] == "first" else "Dense_0"
        return f"EGNN_0/EGCL_{m[1]}/{mlp}/{dense}/{leaves[m[4]]}"
    m = re.fullmatch(r"egnn\.blocks\.(\d+)\.(phi_[exh])\.residual\.(\d+)\."
                     r"(?:dense\.(weight|bias)|norm\.(scale|bias))", name)
    if m:
        mlp = {v: k for k, v in _STABLE_MLPS.items()}[m[2]]
        layer = f"EGNN_0/EGCL_{m[1]}/{mlp}/NonLinearLayerWithResidualAndLayerNorm_{m[3]}"
        return f"{layer}/Dense_0/{leaves[m[4]]}" if m[4] else f"{layer}/LayerNorm_0/{m[5]}"
    m = re.fullmatch(r"layers\.(\d+)\.(weight|bias)", name)  # VectorNet
    if m:
        return f"ConcatDense_{m[1]}/{leaves[m[2]]}"
    m = re.fullmatch(r"out\.(weight|bias)", name)
    if m:
        return f"Dense_0/{leaves[m[1]]}"
    raise KeyError(f"unknown port parameter {name!r}")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested tree -> ``{"/"-joined path: numpy leaf}`` (the npz layout
    that ``--params-npz`` and `from_flax` read)."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameters of the EGNN field or of VectorNet -> the port's
    ``state_dict``."""
    state = {}
    for path, value in flatten(params).items():
        path = path[len("params/"):] if path.startswith("params/") else path
        name = _torch_name(path)
        value = np.array(value, dtype=np.float32)  # a writable copy
        if path.endswith("/kernel"):
            value = np.ascontiguousarray(value.T)
        state[name] = torch.from_numpy(value)
    return state


def to_flax(field: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, dict]:
    """The port's field, or a ``state_dict`` of it (such as a training
    state's ``params`` or ``ema_params``) -> ``{"params": nested dict of
    numpy arrays}``."""
    tree: dict = {}
    state = field.state_dict() if isinstance(field, nn.Module) else field
    for name, value in state.items():
        path = _flax_path(name)
        array = value.detach().cpu().float().numpy()
        if path.endswith("/kernel"):
            array = np.ascontiguousarray(array.T)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = array
    return {"params": tree}
