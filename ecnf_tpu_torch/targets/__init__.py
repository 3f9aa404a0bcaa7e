"""Targets and their data (port of `ecnf_tpu/targets`): the double-well
and Lennard-Jones energies in `energies`, HMC in `mcmc`, its convergence
diagnostics in `diagnostics`, the DW4 / LJ13 / QM9 / ALDP loaders in
`data` (exported here), the QM9 pipeline in `qm9` (with seeded stand-ins
in `synthetic_qm9`) and its thermochemical targets, dataset statistics and
collation in `qm9_extras` (exported here), the reader of ALDP's HDF5
trajectories in `h5`, and the 2-D mixture of Gaussians in `mog`."""
from ecnf_tpu_torch.targets.data import (
    FullGraphSample,
    load_aldp,
    load_dw4,
    load_lj13,
    load_qm9,
    positional_dataset_only_to_full_graph,
)
from ecnf_tpu_torch.targets.qm9_extras import (
    ProcessedDataset,
    add_thermo_targets,
    get_thermo_dict,
    collate_fn,
)
