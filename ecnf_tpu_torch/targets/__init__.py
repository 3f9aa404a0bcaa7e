"""Targets and their data (port of `ecnf_tpu/targets`): the double-well
and Lennard-Jones energies in `energies`, HMC in `mcmc`, its convergence
diagnostics in `diagnostics`, the DW4 / LJ13 / QM9 loaders in `data`, the
QM9 pipeline in `qm9` (with seeded stand-ins in `synthetic_qm9`), and the
2-D mixture of Gaussians in `mog`.  Nothing is imported eagerly."""
