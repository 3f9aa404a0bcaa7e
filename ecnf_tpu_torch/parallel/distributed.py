"""Multi-process start-up and host-local batch slices (port of
`ecnf_tpu/parallel/distributed.py`).

The JAX module starts `jax.distributed` and lets GSPMD place collectives;
here one process drives one card (or one CPU rank), and the processes
join one `torch.distributed` process group: NCCL between cards, gloo on
the CPU.  Without a coordinator nothing starts and the process runs alone.
"""
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _card_index(local_device_ids: Optional[Sequence[int]], process_id: int) -> int:
    """The card this process drives: the one id of ``local_device_ids``, else
    ``process_id`` modulo the cards of this host (processes started in
    order, one per card)."""
    if local_device_ids is None:
        return process_id % torch.cuda.device_count()
    ids = list(local_device_ids)
    if len(ids) != 1:
        raise ValueError(f"one process drives one card; got local_device_ids={ids}")
    return int(ids[0])


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Join the process group when started by a launcher.

    Call this first in an entry point that may run as several processes,
    before any CUDA work: the card is chosen (``torch.cuda.set_device``)
    and handed to ``init_process_group(device_id=...)`` before NCCL starts,
    so the communicator binds to this process's card and no other process
    opens a context on card 0 (the torch form of JAX's "too late" after a
    backend is up).  Explicit arguments win; otherwise the
    ``COORDINATOR_ADDRESS`` (``host:port`` of rank 0's TCP store, or a
    ``file://`` path every process can reach), ``NUM_PROCESSES`` and
    ``PROCESS_ID`` variables are read.  With no coordinator this is a
    no-op (a single-process run); with one, the process count and id are
    required.  Re-entrant: a call in a process whose group is up does
    nothing.  The backend is NCCL when the host has a CUDA card and gloo
    when it has none; a failure to start either raises.  A process that
    runs on the CPU under NCCL (``--device cpu`` on a card's host) still
    works: the collectives of `parallel.mesh` take its CPU tensors through
    its card and back.

    Returns True when this call started the process group.
    """
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without the process count and id "
            "(NUM_PROCESSES, PROCESS_ID)"
        )
    init_method = coordinator_address
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    if torch.cuda.is_available():
        card = torch.device("cuda", _card_index(local_device_ids, process_id))
        torch.cuda.set_device(card)
        kwargs = dict(backend="nccl", device_id=card)
    else:
        kwargs = dict(backend="gloo")
    dist.init_process_group(
        init_method=init_method, world_size=int(num_processes), rank=int(process_id), **kwargs
    )
    return True


def world() -> "tuple[int, int]":
    """``(rank, world size)`` of the process group, ``(0, 1)`` when none is up."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main_process() -> bool:
    """Whether this process logs, prints and writes files: rank 0, or the
    only process."""
    return world()[0] == 0


def print_main(*args, **kwargs) -> None:
    """``print`` on rank 0 only (in a single process, always)."""
    if is_main_process():
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()


def process_batch_slice(global_batch_size: int) -> slice:
    """The rows of a global batch this process loads: an equal share per
    rank, in rank order."""
    rank, n = world()
    per_process = global_batch_size // n
    return slice(rank * per_process, (rank + 1) * per_process)
