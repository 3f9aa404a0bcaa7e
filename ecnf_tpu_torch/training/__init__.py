"""Flow-matching training and evaluation (port of `ecnf_tpu/training`):
`optim`, `state`, `evaluation`, and in `setup` the epoch runner and the
evaluation functions.  Nothing is imported eagerly."""
