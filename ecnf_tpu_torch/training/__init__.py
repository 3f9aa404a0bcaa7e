"""Flow-matching training and evaluation (port of `ecnf_tpu/training`):
`optim`, `state`, `evaluation`, `config` (with its YAML reader
`yaml_subset`), `loggers`, `checkpoints`, `loop` (`run_training`), and in
`setup` the epoch runner, the evaluation functions and `setup_training`.
Nothing is imported eagerly."""
