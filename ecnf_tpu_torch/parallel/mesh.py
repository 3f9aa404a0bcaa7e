"""Process meshes and the batch helpers (port of `ecnf_tpu/parallel/mesh.py`).

The JAX module builds a ``Mesh`` over devices and lets GSPMD move data by
its shardings.  Here a mesh is a `torch.distributed` ``DeviceMesh`` over
the processes of the group, one card (or one CPU rank) each, and the data
moves by hand: `shard_batch` keeps this rank's rows, `replicate` copies
rank 0's tensors to every rank, and `gather_rows` / `all_reduce_sum`
are the collectives the callers need.  A collective takes tensors on any
device: under NCCL a CPU tensor goes through this process's card and
back.  The JAX shardings ``replicated`` / ``data_sharded`` are kept as
names only, for a reader porting code that uses them: they return the
DTensor placements ``Replicate()`` and ``Shard(0)``, which nothing here
reads.

A single process (no process group up) has no mesh: `get_mesh` and
`get_mesh_2d` return None, and every helper takes None as a world of one
whose ranks hold the whole batch, without a collective.
"""
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
TRACE_AXIS = "trace"

Tensor = torch.Tensor


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world_ranks(devices: Optional[Sequence[int]]) -> int:
    """The world size, checking that ``devices`` (ranks) is the whole world."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None and list(devices) != list(range(n)):
        raise ValueError(f"a mesh spans every rank in order, range({n}); got {list(devices)}")
    return n


def get_mesh(
    devices: Optional[Sequence[int]] = None, axis_name: str = DATA_AXIS
) -> Optional[DeviceMesh]:
    """1-D data-parallel mesh over every rank (``devices``, when given, must
    list them all in order); None in a single process."""
    n = _world_ranks(devices)
    if not dist.is_initialized():
        return None
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis_name,))


def get_mesh_2d(
    n_data: int,
    n_trace: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    axis_names: "tuple[str, str]" = (DATA_AXIS, TRACE_AXIS),
) -> Optional[DeviceMesh]:
    """2-D ``(data, trace)`` mesh for batch x Jacobian-column sharding
    (`ops.divergence.sharded_value_and_exact_divergence`); ``n_trace``
    defaults to the ranks left over.  None in a single process."""
    n = _world_ranks(devices)
    if n_trace is None:
        n_trace = n // n_data
    if n_data * n_trace != n:
        raise ValueError(f"n_data * n_trace must equal the world: {(n_data, n_trace, n)}")
    if not dist.is_initialized():
        return None
    return init_device_mesh(_device_type(), (n_data, n_trace), mesh_dim_names=tuple(axis_names))


def replicated(mesh: Optional[DeviceMesh] = None) -> Replicate:
    """The placement of a value every rank holds whole (JAX ``P()``); a
    name kept for porting, as the module's docstring says."""
    return Replicate()


def data_sharded(mesh: Optional[DeviceMesh] = None, axis_name: str = DATA_AXIS) -> Shard:
    """The placement of a batch split along axis 0 (JAX ``P(axis_name)``);
    a name kept for porting."""
    return Shard(0)


def axis_size(mesh: Optional[DeviceMesh], axis_name: str = DATA_AXIS) -> int:
    """Ranks along ``axis_name`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def axis_rank(mesh: Optional[DeviceMesh], axis_name: str = DATA_AXIS) -> int:
    """This rank's index along ``axis_name`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis_name)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def rows(x: Tensor, mesh: Optional[DeviceMesh], axis_name: str = DATA_AXIS) -> Tensor:
    """This rank's block of axis 0 of ``x``, whose length the axis's ranks
    must divide."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks of {axis_name!r}")
    per_rank = x.shape[0] // n
    start = axis_rank(mesh, axis_name) * per_rank
    return x[start : start + per_rank]


def shard_batch(tree, mesh: Optional[DeviceMesh], axis_name: str = DATA_AXIS):
    """This rank's rows of axis 0 of every tensor in ``tree`` (None leaves
    kept)."""
    return _map(lambda x: x if x is None else rows(x, mesh, axis_name), tree)


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _collective_(op, x: Tensor) -> Tensor:
    """``op(y)`` on ``x`` itself, or on a copy of it on the backend's
    device (the card under NCCL) whose result is copied back; returns
    ``x``."""
    device = _comm_device()
    if x.device.type == device.type:
        op(x)
        return x
    staged = x.to(device)
    op(staged)
    return x.copy_(staged)


def replicate(tree, mesh: Optional[DeviceMesh]):
    """Rank 0's values in every tensor (in place) and every generator's
    state of ``tree``, on every rank; returns ``tree``.  Other leaves are
    left as they are."""
    if mesh is None:
        return tree

    def one(x):
        if isinstance(x, Tensor):
            _collective_(lambda y: dist.broadcast(y, src=0), x.data)
        elif isinstance(x, torch.Generator):
            state = x.get_state()
            _collective_(lambda y: dist.broadcast(y, src=0), state)
            x.set_state(state)
        return x

    return _map(one, tree)


def all_reduce_sum(x: Tensor, mesh: Optional[DeviceMesh], axis_name: str = DATA_AXIS) -> Tensor:
    """The sum of ``x`` over the ranks of ``axis_name``, in place."""
    if mesh is None:
        return x
    group = mesh.get_group(axis_name)
    return _collective_(lambda y: dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group), x)


def gather_rows(x: Tensor, mesh: Optional[DeviceMesh], axis_name: str = DATA_AXIS) -> Tensor:
    """Every rank's ``x`` along ``axis_name`` joined along axis 0 in rank
    order (`rows` undone); the ranks' shapes must agree."""
    if mesh is None:
        return x
    staged = x.contiguous().to(_comm_device())
    parts = [torch.empty_like(staged) for _ in range(axis_size(mesh, axis_name))]
    dist.all_gather(parts, staged, group=mesh.get_group(axis_name))
    return torch.cat(parts).to(x.device)


def pad_to_multiple(batch_size: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``batch_size``."""
    return ((batch_size + n_shards - 1) // n_shards) * n_shards
