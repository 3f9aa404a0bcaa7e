"""PyTorch port of ecnf_tpu: exact-log-density sampling of the EGNN flow on CUDA."""
