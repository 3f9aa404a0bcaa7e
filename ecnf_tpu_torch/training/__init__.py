"""Flow-matching training (port of `ecnf_tpu/training`): `optim`, `state`
and the epoch runner in `setup`.  Nothing is imported eagerly."""
