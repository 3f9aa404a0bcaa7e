"""PyTorch port of ecnf_tpu: sampling, scoring, training and evaluation of the EGNN flow on CUDA."""
