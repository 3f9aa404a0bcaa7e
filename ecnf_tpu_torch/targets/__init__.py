"""Boltzmann targets (port of `ecnf_tpu/targets`): the double-well and
Lennard-Jones energies in `energies`.  Nothing is imported eagerly."""
