"""The tree of a JAX Orbax checkpoint as numpy arrays, read without JAX,
orbax or tensorstore.

`ecnf_tpu/training/checkpoints.py: save_checkpoint` writes a
``TrainingState`` with ``ocp.PyTreeCheckpointer``: ``_METADATA`` (JSON)
names every leaf by its key tuple, and each array is a zarr-v2 array
inside the checkpoint's OCDBT store (`ecnf_tpu_torch.training.ocdbt`):
``<name>/.zarray`` and chunks ``<name>/i.j...``, each chunk a zstd frame,
where ``<name>`` is the key tuple joined by dots.

What it reads: ``use_ocdbt: true`` with ``use_zarr3: false`` (what the JAX
package writes); array leaves (``jax.Array``, ``np.ndarray``) and None;
dtypes ``<f4``, ``<f8``, ``<i4``, ``<i8``, ``<u4``, ``|b1`` and
``bfloat16`` (returned as its ``uint16`` bits, for the caller to view as
``torch.bfloat16``); C order; the zstd compressor or none; any chunk grid,
an absent chunk taking the array's numeric or null (0) ``fill_value``.
Anything else is refused by name.
"""
import json
import math
import os
from itertools import product
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ecnf_tpu_torch.training.ocdbt import OcdbtStore
from ecnf_tpu_torch.utils import zstd

__all__ = ["read_orbax_tree"]

METADATA = "_METADATA"
_DTYPES = {
    "<f4": np.dtype("<f4"), "<f8": np.dtype("<f8"), "<i4": np.dtype("<i4"),
    "<i8": np.dtype("<i8"), "<u4": np.dtype("<u4"), "|b1": np.dtype("bool"),
    "bfloat16": np.dtype(np.uint16),  # its bits
}
_SEQUENCE = 1  # orbax's key type of a list or tuple index (2: a mapping key)
_ARRAY_TYPES = ("jax.Array", "np.ndarray")


def _read_array(store: OcdbtStore, name: str) -> np.ndarray:
    meta = json.loads(store.read(f"{name}/.zarray"))
    where = f"array {name!r}"
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{where}: zarr_format {meta.get('zarr_format')}")
    if meta.get("dtype") not in _DTYPES:
        raise NotImplementedError(f"{where}: dtype {meta.get('dtype')!r}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{where}: order {meta['order']!r} (only C)")
    if meta.get("filters"):
        raise NotImplementedError(f"{where}: filters {meta['filters']!r}")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise NotImplementedError(f"{where}: dimension_separator {sep!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise NotImplementedError(f"{where}: compressor {compressor.get('id')!r}")
    fill = meta.get("fill_value") or 0
    if not isinstance(fill, (int, float)) or (fill and meta["dtype"] == "bfloat16"):
        raise NotImplementedError(f"{where}: fill_value {fill!r}")
    dtype = _DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ValueError(f"{where}: chunks {chunks} do not fit shape {shape}")
    out = np.full(shape, fill, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in product(*grid):
        key = f"{name}/{'.'.join(map(str, index)) if index else '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        if compressor is not None:
            raw = zstd.decompress(raw)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{where}: chunk {key} holds {len(raw)} bytes, not {chunk_bytes}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _rebuild(node: Dict[Any, Any], kinds: Dict[Tuple[str, ...], int], path: Tuple[str, ...]):
    """Nested dicts with the containers of sequence keys turned into lists."""
    if not isinstance(node, dict):
        return node
    items = {k: _rebuild(v, kinds, path + (str(k),)) for k, v in node.items()}
    if kinds.get(path) == _SEQUENCE:
        if sorted(items) != list(range(len(items))):
            raise ValueError(f"checkpoint sequence {path} has indices {sorted(items)}")
        return [items[i] for i in range(len(items))]
    return items


def read_orbax_tree(path: str, prefix: Optional[Sequence[str]] = None):
    """The pytree saved at ``path`` (dicts and lists of numpy arrays, None
    where the saved leaf was None), or its subtree at the key tuple
    ``prefix`` (e.g. ``("ema_params",)``): only that subtree's arrays are
    decoded.  Raises ``KeyError`` when no leaf lies under ``prefix``."""
    prefix = tuple(str(k) for k in (prefix or ()))
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} is not an Orbax checkpoint (no {METADATA})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3", False):
        raise NotImplementedError(f"{path}: use_zarr3: true (only zarr v2 arrays are read)")
    if not meta.get("use_ocdbt", False):
        raise NotImplementedError(f"{path}: use_ocdbt: false (only OCDBT checkpoints are read)")
    store = OcdbtStore(path)
    root: Dict[Any, Any] = {}
    kinds: Dict[Tuple[str, ...], int] = {}
    found = False
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if tuple(keys[: len(prefix)]) != prefix:
            continue
        found = True
        value_meta = entry["value_metadata"]
        value_type = value_meta["value_type"]
        if value_type == "None":
            leaf = None
        elif value_type in _ARRAY_TYPES:
            leaf = _read_array(store, ".".join(keys))
        else:
            raise NotImplementedError(f"{path}: leaf {tuple(keys)} of type {value_type!r}")
        rel = entry["key_metadata"][len(prefix) :]
        if not rel:
            return leaf
        rel_keys = tuple(keys[len(prefix) :])
        node = root
        for depth, k in enumerate(rel):
            key = int(k["key"]) if k["key_type"] == _SEQUENCE else k["key"]
            kinds[rel_keys[:depth]] = k["key_type"]
            if depth == len(rel) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})
    if not found:
        raise KeyError(f"{path}: no leaf under {prefix}")
    return _rebuild(root, kinds, ())
