"""The experiment entry points (port of `examples/`): ``python -m
ecnf_tpu_torch.examples.dw4``, ``.lj13``, ``.qm9``, ``.aldp`` and ``.mog``."""
