"""Data and trace-column parallelism over `torch.distributed` (port of
`ecnf_tpu/parallel`): process meshes and batch helpers in `mesh`, the
process group's start-up in `distributed`, and the multi-rank dry run in
`dryrun`."""
from ecnf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TRACE_AXIS,
    get_mesh,
    get_mesh_2d,
    replicated,
    data_sharded,
    shard_batch,
    replicate,
    pad_to_multiple,
)
from ecnf_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    process_batch_slice,
)
