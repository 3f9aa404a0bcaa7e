"""Evaluation figures (port of `ecnf_tpu/utils`): the histograms and the
metric-history panel in `plotting`, drawn as SVG by `figure`."""
