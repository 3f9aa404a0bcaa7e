"""Training checkpoints (the port's counterpart of
`ecnf_tpu/training/checkpoints.py`).

A checkpoint is a directory ``state_%08i`` (the JAX package's names, so
the latest one is found and its iteration parsed the same way) holding:

- ``params.npz`` and, when EMA is on, ``ema_params.npz``: the field's
  parameters under their flax paths (`ecnf_tpu_torch.convert`), which
  numpy alone reads and ``python -m ecnf_tpu_torch.score --params-npz``
  scores;
- ``train_state.pt`` (``torch.save``): the optimizer's moments and step
  count and the state's generator state.

A restore gives back a state from which training continues exactly as an
uninterrupted run would.

`restore_serving_params` also serves a checkpoint the JAX package wrote
(`ecnf_tpu/training/checkpoints.py: save_checkpoint`, an Orbax
``PyTreeCheckpointer`` directory), read by `training.orbax`;
`get_latest_checkpoint` finds either kind.
"""
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ecnf_tpu_torch.convert import flatten, from_flax, to_flax
from ecnf_tpu_torch.training.optim import AdamState
from ecnf_tpu_torch.training.orbax import METADATA, read_orbax_tree
from ecnf_tpu_torch.training.state import TrainingState

Tensor = torch.Tensor
PARAMS, EMA_PARAMS, TRAIN_STATE = "params.npz", "ema_params.npz", "train_state.pt"
NO_EMA = "checkpoint has no EMA parameters (trained with use_ema=false)"


def get_latest_checkpoint(dir_path: str, key: str = "state_") -> Optional[str]:
    """Path of the lexicographically latest entry of ``dir_path`` whose name
    contains ``key``; None when there is none."""
    if not os.path.exists(dir_path):
        return None
    entries = [os.path.join(dir_path, f) for f in os.listdir(dir_path) if key in f]
    if not entries:
        return None
    entries.sort()
    return entries[-1]


def parse_checkpoint_iteration(path: str) -> int:
    """Recover the training iteration from a ``state_%08i`` name."""
    m = re.search(r"state_(\d{8})", os.path.basename(path.rstrip("/")))
    if m is None:
        raise ValueError(f"cannot parse iteration from checkpoint path {path!r}")
    return int(m.group(1))


def checkpoint_path(checkpoints_dir: str, iteration: int) -> str:
    return os.path.join(checkpoints_dir, "state_%08i" % iteration)


def _save_params(path: str, params: Dict[str, Tensor]) -> None:
    np.savez(path, **flatten(to_flax(params)))


def save_checkpoint(checkpoints_dir: str, iteration: int, state: TrainingState) -> str:
    """Write ``state`` as ``state_%08i`` (replacing one of that name); the
    directory appears only once complete."""
    path = os.path.abspath(checkpoint_path(checkpoints_dir, iteration))
    partial = os.path.join(os.path.dirname(path), ".partial_%08i" % iteration)
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)
    _save_params(os.path.join(partial, PARAMS), state.params)
    if state.ema_params is not None:
        _save_params(os.path.join(partial, EMA_PARAMS), state.ema_params)
    names = list(state.params)
    opt = state.opt_state
    torch.save(
        {
            "count": opt.count,
            "mu": {n: t.detach().cpu() for n, t in zip(names, opt.mu)},
            "nu": {n: t.detach().cpu() for n, t in zip(names, opt.nu)},
            "generator": state.generator.get_state(),
        },
        os.path.join(partial, TRAIN_STATE),
    )
    shutil.rmtree(path, ignore_errors=True)
    os.rename(partial, path)
    return path


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a checkpoint the JAX package wrote (an Orbax
    directory with ``_METADATA`` and an OCDBT ``manifest.ocdbt``)."""
    return os.path.isfile(os.path.join(path, METADATA)) and os.path.isfile(
        os.path.join(path, "manifest.ocdbt")
    )


def _fit(loaded: Dict[str, Tensor], template: Dict[str, Tensor], path: str) -> Dict[str, Tensor]:
    if set(loaded) != set(template):
        raise ValueError(f"{path} holds other parameters than the model's")
    return {n: loaded[n].to(device=t.device, dtype=t.dtype) for n, t in template.items()}


def _load_params(path: str, template: Dict[str, Tensor]) -> Dict[str, Tensor]:
    with np.load(path) as npz:
        loaded = from_flax(dict(npz))
    return _fit(loaded, template, path)


def _float_leaves(tree):
    """bfloat16 leaves (read as their uint16 bits) widened exactly to float32."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.uint16:
        return (tree.astype(np.uint32) << 16).view(np.float32)
    return tree


def _orbax_params(path: str, ema: bool) -> Dict[str, Tensor]:
    """The flax ``params`` (or ``ema_params``) of a JAX checkpoint as the
    field's ``state_dict``."""
    try:
        tree = read_orbax_tree(path, ("ema_params" if ema else "params",))
    except KeyError:
        tree = None
    if tree is None:
        if ema:
            raise ValueError(NO_EMA)
        raise ValueError(f"{path} holds no parameters")
    return from_flax(_float_leaves(tree))


def restore_checkpoint(path: str, target: TrainingState) -> TrainingState:
    """The state saved at ``path``, on the devices and in the parameter
    order of ``target``, whose generator is set to the saved state."""
    params = _load_params(os.path.join(path, PARAMS), target.params)
    ema_params = None
    if target.ema_params is not None:
        ema_path = os.path.join(path, EMA_PARAMS)
        if not os.path.exists(ema_path):
            raise ValueError(f"{path} has no EMA parameters (trained with use_ema=false)")
        ema_params = _load_params(ema_path, target.ema_params)
    saved = torch.load(os.path.join(path, TRAIN_STATE), weights_only=True)
    names = list(target.params)
    devices = [t.device for t in target.opt_state.mu]
    opt_state = AdamState(
        int(saved["count"]),
        [saved["mu"][n].to(d) for n, d in zip(names, devices)],
        [saved["nu"][n].to(d) for n, d in zip(names, devices)],
    )
    target.generator.set_state(saved["generator"])
    return TrainingState(params, opt_state, target.generator, ema_params)


def restore_serving_params(
    path: str, params_template: Optional[Dict[str, Tensor]] = None, ema: bool = False
) -> Dict[str, Tensor]:
    """The parameters (``ema=True``: the EMA parameters) of a checkpoint of
    either package as a ``state_dict`` of the field, on the CPU or on the
    template's devices and dtypes.  Raises ``ValueError`` for ``ema=True`` on
    a checkpoint trained without EMA."""
    if is_orbax_checkpoint(path):
        loaded = _orbax_params(path, ema)
        return loaded if params_template is None else _fit(loaded, params_template, path)
    file = os.path.join(path, EMA_PARAMS if ema else PARAMS)
    if not os.path.exists(file):
        if ema:
            raise ValueError(NO_EMA)
        raise FileNotFoundError(file)
    if params_template is not None:
        return _load_params(file, params_template)
    with np.load(file) as npz:
        return from_flax(dict(npz))
