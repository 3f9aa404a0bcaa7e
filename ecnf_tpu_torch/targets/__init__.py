"""Boltzmann targets and their data (port of `ecnf_tpu/targets`): the
double-well and Lennard-Jones energies in `energies`, HMC in `mcmc`, its
convergence diagnostics in `diagnostics`, and the DW4 / LJ13 loaders in
`data`.  Nothing is imported eagerly."""
