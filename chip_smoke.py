#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ecnf_tpu_torch`) on one CUDA card.

Phases, one or more lines each:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: compile the four CUDA kernels from ``ecnf_tpu_torch/csrc``, one
   nvcc each, all at once, with their register and spill lines and the
   count of tensor-core (HMMA, and HGMMA for wgmma) instructions in each
   library (``cuobjdump -sass``); each must have some, since every
   kernel's dense passes run on the tensor cores (bf16, or f32 in 3xTF32);
3. the kernel table (`KERNEL_ROWS`, `kernel_row`): each kernel at the
   shapes PERF.md section 6 reports, one ``[kernel]`` line a row: the
   edge-tangent kernel at LJ13 and QM9 in float32 and bfloat16, at the
   LJ55 cell's launch on both designs in bfloat16 and in float32 (B=2),
   and at the QM9 cell's Hutchinson launch (K=1); the EGCL forward at
   LJ13 (B=48 and 256) and QM9 (B=64), the fused trace at LJ13 (B=48) and
   QM9 (B=64); the primal edge-chain kernel at the QM9 Hutchinson, LJ13,
   ALDP and LJ55 shapes.  Each row checks the kernel against its plain
   version at the row's limit (``EDGE_LIMITS``, ``F32_LIMIT``), times both
   by CUDA events and reads its bound (below);
4. the serving table (`SERVE_ROWS`, `serve_row`): ``python -m
   ecnf_tpu_torch.sample``'s code path in bf16 with each kernel's launches
   counted, one ``[serve]`` line a row: LJ13's full width (3 blocks of
   [128]*3, hidden 64, batch 48, exact trace) on rk4 (step 0.05), whose
   ``edge_tangent`` and ``edge_primal`` launches must each be 3 per field
   evaluation, on fixed-step Dopri5 and with ``--fused-trace`` (one
   launch per evaluation); the LJ55 cell's rk4 exact solve (B=16), whose
   240 edge-tangent launches must all take the resident design, and the
   QM9 cell's rk4 Hutchinson solve (5 blocks of [256]*4, hidden 32,
   B=256), whose 400 must all take the other one, the primal kernel's
   launches as many in both;
5. the LJ13 solve in float32 through the edge kernels, against the plain
   version and the ``torch.func.jvp`` trace;
6. the same with ``fused_trace=True`` against the same references;
7. an rk4 sample-only solve whose field is `flat_egnn_apply_fused`, its
   EGCL launches counted, against the solve through the field module;
8-9. not used (10-18 keep the numbers the tests and the docs cite);
10. train step (`ecnf_tpu_torch.training`, the plain torch EGNN under
   autograd, as in JAX; no custom kernel runs, and the counts must stay
   0): (a) f32 parity of the card against the CPU on the same weights,
   data, x0 and t, three updates at microbatch 1 and 4 with EMA; (b) the
   QM9 flagship step of the JAX `bench.py` (B=256, bf16, EMA, Adam 1e-4) at
   microbatch 4 and 1: first step apart, then ms per step by CUDA events,
   steps/s, peak device memory, TFLOP/s and MFU from
   `ops.flops.count_fn_flops` of one more step, and the device's busy
   share in a `torch.profiler` trace of a few steps; (c)
   the loss falls on a fixed LJ13 batch through `epoch`;
11. evaluation (adaptive Dopri5 at the `SolveConfig()` defaults, LJ13
   config width: 3 blocks of [128]*3, hidden 64, batch 64; every solve's
   steps, attempts, field evaluations, host syncs, CUDA-event ms and
   non-finite rows recorded, and the edge kernel's launches held to 3 per
   evaluation): (a) f32 `sample_and_log_prob_cnf` through the edge kernel
   against the plain version on one x0 (x1, log q, step counts), and the
   same solve with two rows of x0 set to NaN, whose other rows must come
   out identical; (b) the `score` entry point on (a)'s samples and
   weights, whose log p must match (a)'s log q; (c) bf16, the config's
   dtype: `training.setup.evaluate` with the LJ target on a stand-in test
   set ((a)'s samples; the LJ13 data are not in the repo), printing
   test_log_lik, forward_ess, rv_ess (2 batches of 64), eval_ode_steps,
   attempts, evaluations, launches, syncs, the NaN share, one batch's time,
   the reverse-ESS rate, the edge kernel's share and peak memory; (d) the
   f32 solve of (a) with ``fused_trace=True`` against (a);
12. the training program, DW4 at `examples/configs/dw4.yaml`'s width: (a)
   the DW4 data regenerated by HMC on the card at the JAX package's
   settings, with its acceptance, split-R-hat, ESS, mean energy and mean
   distance beside the JAX run's and the mixing gate applied, and a few
   steps of the captured (CUDA graph) HMC step against the eager one, a
   stuck chain restarted in both; (b)
   ``ecnf_tpu_torch.examples.dw4.run`` on that data, cut to 2 iterations,
   1 evaluation, 2 checkpoints and 128 test points: 30 finite losses,
   evaluations at -1 and 1 with finite test_log_lik, forward_ess in [0, 1]
   and eval_ode_steps > 0, 3 edge launches per field evaluation, the
   checkpoints, ms per train step by CUDA events, seconds per evaluation,
   peak memory; (c) a resumed run to 3 iterations: no evaluation at -1,
   one epoch, an evaluation at 2, ``state_00000002``, the checkpoint's
   parameters bit for bit those of (b); (d) the edge kernel at DW4's shape
   (B=64, N=4, K=6, U=128) against its plain version in bf16 and f32, on
   random inputs and on the inputs captured from one field evaluation
   inside (c)'s evaluation, and its share of (b)'s and (c)'s evaluations;
13. the QM9 and MoG programs: (a) ``ecnf_tpu_torch.examples.qm9.run`` at
   `examples/configs/qm9.yaml`'s width (5 blocks of [256]*4, bf16, B=256,
   EMA, microbatch 4, epochs_per_dispatch 64, which the port ignores,
   Hutchinson evaluation at batch 256) on the port's synthetic stand-ins,
   cut to a train set of 1024, a test set of 256 and 6 iterations with
   evaluations and checkpoints at 2 and 5: finite losses and
   test_log_lik, the checkpoints, 5 edge launches per field evaluation,
   ms per train step by CUDA events per epoch, seconds per evaluation,
   each solve's steps and attempts, peak memory, and after (c) the
   device's kernel time a train step in a `torch.profiler` trace of
   further epochs, against the step's time; (b) the edge kernel at
   the QM9 Hutchinson shape (K=1, B=256, N=19, U=256, L=4, bf16) on one
   field evaluation's inputs captured in (a), against its plain version,
   timed against its bound, with the cost model's columns per block and
   its share of (a)'s evaluations; (c) ``python -m
   ecnf_tpu_torch.measure_sampling_time --batch-size 128 --reps 3`` on (a)'s
   checkpoints, whose restored parameters must be (a)'s last; (d) the MoG
   example at its default width, cut to 5 iterations, with finite metrics
   and its two figures of each evaluation written as SVG and parsed;
14. the ALDP program: (a) ``targets.h5.read_dataset`` on
   ``data/aldp_500K_train_mini.h5`` (the card has no h5py): shape (2000,
   22, 3), finite, and its float64 sum and sum of squares equal to the
   constants the CPU test pins against h5py; (b)
   ``ecnf_tpu_torch.examples.aldp.run`` at `examples/configs/aldp_soak.yaml`'s
   width (3 blocks of [64, 64], hidden 32, bf16, B=256, EMA,
   warmup-cosine; 1,600 training and 400 disjoint test frames), cut to 2
   iterations with evaluations at -1 and 1: finite losses and
   test_log_lik, the checkpoint, 3 edge launches per field evaluation, ms
   per train step by CUDA events, seconds per evaluation and per plotting
   solve, each solve's steps and attempts, the distance-histogram figures
   written as SVG and parsed; (c) the edge kernel at the ALDP Hutchinson
   shape (K=1, B=256, N=22, U=64, L=2, bf16) on one field evaluation's
   inputs captured in (b), against its plain version at the kernel table's limit,
   timed against its bound, with its share of (b)'s evaluations; (d) the
   ``--local`` ALDP and DW4 programs on the card (evaluations at -1 and
   9), whose edge widths of 4 and 16 the kernel takes zero-padded, each
   padded launch of one field evaluation held to the plain version.
15. serving a JAX checkpoint: (a) the committed Orbax checkpoint that
   the JAX package wrote (``tests/torch_fixtures/jax_aldp``, ALDP width)
   read by `training.orbax.read_orbax_tree` in this process, which has
   no JAX: every leaf's dtype, shape and SHA-256 against its
   ``expected.json``, with the read time and the zstd decoder's rate;
   (b) ``python -m ecnf_tpu_torch.score --config aldp_soak.yaml
   --checkpoint-dir ... --features arange`` with the f32, exact-trace,
   fixed-step rk4 overrides on the 16 frames beside it, raw and
   ``--ema``: log p within ``LOGQ_LIMIT`` of JAX's numbers, the EMA's
   apart from the raw, edge launches counted, the first call timed apart
   from a second; the edge kernel at that shape (K=63, B=16, N=22, U=64,
   L=2, f32) on one field evaluation's inputs against its plain version,
   timed against its bound; (c) ``python -m ecnf_tpu_torch.sample`` from
   that checkpoint with ``--ema`` and the config's own solve (adaptive
   Dopri5, bf16), Hutchinson, 256 samples in batches of 128: every sample
   and log q finite, the first batch timed apart.
16. the options `setup_training` once refused, and Hutch++ (``phase_options``).
17. data parallelism at world size 1 on NCCL, in a child process that a
   launcher's variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES=1``,
   ``PROCESS_ID=0``) start: (a) `parallel.maybe_initialize_distributed`
   brings NCCL up on ``cuda:0`` (backend, world size and NCCL version
   printed; a failure is an error, never a switch to gloo); (b) the QM9
   flagship step (B=256, bf16, EMA, microbatch 4), three updates on one
   mesh against three without it, on the same weights and injected x0
   and t under deterministic algorithms: parameters and EMA bit-equal (a
   one-rank all-reduce is a copy and the division by 1 exact), ms per
   step of each by CUDA events, and the gradient all-reduce's own ms and
   bytes; (c) ``score`` of phase 15's JAX checkpoint through the
   world-1 mesh: log p within ``LOGQ_LIMIT`` of JAX's, with phase 15's
   edge launch count; (d) `sharded_value_and_exact_divergence` on the
   ALDP fixture's field against `value_and_exact_divergence`; (e)
   `parallel.dryrun.dryrun_multichip(1)` on the card.
18. FLOP counts (`ecnf_tpu_torch.ops.flops`), each in a call of its own:
   (a) the structured rk4 serving solve (bf16, B=48) through the edge
   kernel's resident design, through its other design and through its
   plain version, whose counts must be equal; (b) the same for the fused
   rk4 solve; the edge kernel at a width it takes zero-padded (U=16),
   counted as its plain version; (c) phase 10's counts of the QM9 flagship
   step (taken there) with their TFLOP/s and MFU; (d) phase 11's adaptive
   f32 evaluation solve, whose count is flagged ``has_while`` and whose
   MFU is None.  MFU is read against the H100 SXM's published dense peaks
   (bf16 989 TFLOP/s; f32 as 3xTF32, 495 / 3, under the matmul precision
   "highest" that this script sets).

Bounds: the benchmark's frozen formulas, read as its ``*_roofline``
metrics read them: the larger of a launch's bytes (inputs read once,
outputs written once) at the HBM rate and its products at the card's
peaks (``h100_bench/work/peaks.json``; f32-accurate products as three
TF32 ones), from `edge_chain_flops` / `edge_chain_bytes`,
`field_eval_flops` / `fused_launch_bytes` (``h100_bench/work/egnn.py``)
and the primal roofline's `flops` / `nbytes`.  The EGCL rows count the
forward's products and the field's inputs, outputs and weights once.

Phases 1-7 drive the kernels and the serving paths; 10-18 the programs
(their numbers are those that the tests and the docs cite).  To run one
row of the kernel table alone: ``python3 -c "import chip_smoke as c;
c.kernel_row(c.KERNEL_ROWS[4], c.card_line())"`` (the kernels build at
their first call).

It then prints one JSON line listing every kernel, the card line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase raises, so the
script exits non-zero without a result line; so does a machine without a
CUDA device.

Usage: python3 chip_smoke.py
"""
import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

LJ13_EDGE = dict(K=36, B=48, N=13, U=128, L=3)
QM9_EDGE = dict(K=54, B=64, N=19, U=256, L=4)
# Kernel vs plain version: max |kernel - plain| / max |plain| over both
# outputs.  float32 differs only by the order of f32 sums; bfloat16 also
# by the rare bf16 rounding that a different f32 sum order flips.
EDGE_LIMITS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Serving solve in float32, kernel path vs plain path: relative log q.
LOGQ_LIMIT = 1e-3
LJ13_ARGS = [
    "--n-nodes", "13", "--n-samples", "48", "--batch-size", "48",
    "--with-log-prob", "--dtype", "bfloat16", "--seed", "0", "--device", "cuda",
]
RK4_LAUNCHES = 20 * 4 * 3  # steps x stages x blocks
DOPRI5_LAUNCHES = (1 + 20 * 6) * 3  # (FSAL first stage + steps x 6) x blocks
FUSED_LAUNCHES = 20 * 4  # steps x stages: one launch per field evaluation
# The f32 kernels (EGCL forward, fused trace) against their plain versions:
# max |kernel - plain| / max |plain| of the field value and of the
# network's share of the trace; both differ only by the order of f32 sums.
F32_LIMIT = 1e-4
# (name, nodes, mlp_units, hidden, blocks, batch) of the EGCL-forward and
# fused-trace rows of the kernel table: LJ13 (B=48) and one QM9 evaluation.
EGCL_SHAPES = (
    ("lj13", 13, (128,) * 3, 64, 3, 48),
    ("qm9", 19, (256,) * 4, 32, 5, 64),
)
KERNELS = ("edge_tangent", "egcl", "fused_trace", "edge_primal")
# The LJ55 cell's edge-tangent launch, and the f32 batch that keeps the
# plain version's [K, B, N, N, U] f32 tensors to a few GB.
LJ55_EDGE = dict(K=162, B=16, N=55, U=128, L=3)
LJ55_F32_BATCH = 2
# Train phase.  (a) the sizes of `tests/test_torch_train.py`; (b) the QM9
# flagship step of the JAX `bench.py:363-373,412-437`; (c) LJ13 width
# (`bench.py:352-360`).
TRAIN_SMALL = dict(n=5, blocks=2, units=(32, 32), hidden=16, batch=8)
QM9_TRAIN = dict(n=19, blocks=5, units=(256,) * 4, hidden=32, batch=256)
LJ13_TRAIN = dict(n=13, blocks=3, units=(128,) * 3, hidden=64, batch=48)
TRAIN_STEPS = 30  # timed steps per microbatch setting, after the first
PROFILE_STEPS = 3
# (a) bands: loss, grad_norm, update_norm rtol, params and EMA absolute, as
# in the CPU tests (Adam's g / (|g| + 1e-8) amplifies gradient differences
# of components with |g| near 1e-8, up to 2 lr).  Gradient leaves within
# GRAD_RTOL of the leaf's largest |g|: the CPU tests hold 1e-5 against JAX,
# but cuBLAS sums in another order than the CPU, and the first block's gate
# weight, whose gradient is a cancelling sum over the B N^2 edge rows,
# lands at 1.5e-5 of its own largest entry (every other leaf at <= 3.8e-6);
# the CUDA embedding backward also sums with atomics.
TRAIN_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 5e-6
EMA_ATOL = 1e-6
# (c) the loss must fall: mean of the last 5 below this share of the first 5
# (0.81-0.84 over five seeds on the CPU, `tests/test_torch_train.py`).
LOSS_FALL = 0.9
LJ13_UPDATES = 50
# Evaluation phase: the LJ13 config width (`examples/configs/lj13.yaml`: 3
# blocks of [128]*3, hidden 64, time embedding 8, eval_batch_size 64),
# adaptive Dopri5 at the SolveConfig defaults.  rv_ess from 2 batches of
# 64 model samples, not the config's 10,000.
EVAL_B = 64
EVAL_RV_SAMPLES = 2 * EVAL_B
# (a), (d): two adaptive f32 solves from one x0 part by more than their
# field's rounding: at rtol = 1e-5 the error estimate is partly f32
# rounding, so last-bit differences move error ratios past the accept
# threshold, and the step sequences (and the batch's counts, the most of
# any sample's) part by each solve's own global error.  The solver's own
# spread is measured in the same run: the plain path against itself from
# x0 moved one f32 ulp up and one down (the control).  x1 and delta
# log-lik (log q less log_prob_base(x0), which both sides share) are held
# within EVAL_CONTROL_TIMES times the larger control gap; step counts and
# attempts within EVAL_STEP_SHARE of the larger.
EVAL_CONTROL_TIMES = 3.0
EVAL_STEP_SHARE = 0.25
# (b): log p of the scored samples (the reverse solve) against their log q
# (the forward solve), per sample within the band of the JAX round trip on
# the CPU (`tests/test_cnf_roundtrip.py:75`, 1e-3 + 1e-3 |log q|), and the
# largest gap within EVAL_CONTROL_TIMES times the control's delta gap.
ROUND_TRIP_TOL = 1e-3
# Training-program phase: `examples/configs/dw4.yaml` at its full width (3
# blocks of [128]*3, hidden 64, time embedding 8, bf16, batch 64, train set
# 1000: 15 steps an epoch) through `ecnf_tpu_torch.examples.dw4.run`, cut to
# these overrides; its edge chain at DW4's shape (K = (N - 1) D = 6).
DW4_CUTS = ("training.n_training_iter=2", "training.n_eval=1", "training.n_checkpoints=2",
            "training.test_set_size=128")
DW4_EDGE = dict(K=6, B=64, N=4, U=128, L=3)
DW4_STEPS_PER_EPOCH = 1000 // 64
# The edge launch (c)'s run keeps for (d): field evaluation 150 of its
# evaluation's first solve, blocks 0-2.
DW4_CAPTURE_AT = 3 * 150
# The JAX package's DW4 regeneration (`BASELINE.md:215`), printed beside the port's.
DW4_JAX_HMC = "R-hat 1.001 / 1.018, ESS 11,460 / 3,008, mean energy -22.54, mean distance 4.042"
# The captured HMC step against the eager one, relative to max |x|.
HMC_GRAPH_LIMIT = 1e-5
HMC_GRAPH_STEPS = 20
# QM9 program phase: `examples/configs/qm9.yaml` at its full width (5 EGNN
# blocks of [256]*4, hidden 32, time embedding 8, bf16, batch 256, EMA,
# microbatch 4, epochs_per_dispatch 64; evaluations on adaptive Dopri5 at
# rtol = atol = 1e-5 with one Hutchinson probe per sample, batch 256)
# through `ecnf_tpu_torch.examples.qm9.run` on the port's synthetic
# stand-ins, cut to these overrides: 4 steps an epoch, one evaluation batch,
# evaluations and checkpoints at iterations 2 and 5.
QM9_CUTS = ("training.train_set_size=1024", "training.test_set_size=256",
            "training.n_training_iter=6", "training.n_eval=2", "training.n_checkpoints=2")
QM9_STEPS_PER_EPOCH = 1024 // 256
QM9_BLOCKS = 5
# Its edge chain on the Hutchinson route: one probe column per sample.
QM9_HUTCH_EDGE = dict(K=1, B=256, N=19, U=256, L=4)
# The edge launches (a)'s run keeps for (b): field evaluation 20 of the
# evaluation at -1, its 5 blocks.
QM9_CAPTURE_AT = QM9_BLOCKS * 20
QM9_SAMPLING_BATCH = 128
QM9_SAMPLING_ARGS = ["--batch-size", str(QM9_SAMPLING_BATCH), "--reps", "3", "--device", "cuda"]
# MoG at its default width, cut to 5 iterations (780 steps) and one
# evaluation (with the one at -1).
MOG_ITERATIONS = 5
# ALDP phase.  (a) the exactly rounded float64 sum and sum of squares of
# `data/aldp_500K_train_mini.h5`'s coordinates, which the CPU test
# (`tests/test_torch_h5.py`) pins against h5py.
ALDP_H5 = "data/aldp_500K_train_mini.h5"
ALDP_H5_SUMS = (39807.7559506665, 22215.903674675665)
# (b) `examples/configs/aldp_soak.yaml` at its full width (3 EGNN blocks of
# [64, 64], hidden 32, time embedding 8, bf16, batch 256, EMA, warmup-cosine;
# 1,600 training frames and the disjoint last 400 for the test; Hutchinson
# evaluation with one probe, batch 256) through
# `ecnf_tpu_torch.examples.aldp.run`, cut to these overrides: 6 steps an
# epoch, evaluations at -1 and 1, each with its figure, the history kept in
# memory (the config's CSV logger writes files).
ALDP_CUTS = ("training.n_training_iter=2", "training.n_eval=1", "training.n_checkpoints=1",
             "logger={list_logger: null}")
ALDP_STEPS_PER_EPOCH = 1600 // 256
ALDP_BLOCKS = 3
# (c) its edge chain on the Hutchinson route, one probe column per sample;
# the launches (b)'s run keeps: field evaluation 20 of the evaluation at -1.
ALDP_HUTCH_EDGE = dict(K=1, B=256, N=22, U=64, L=2)
ALDP_CAPTURE_AT = ALDP_BLOCKS * 20
# (d) the `--local` programs (ALDP mlp_units [4], DW4 [16]: widths the
# edge kernel takes zero-padded), cut to evaluations at -1 and 9.
ALDP_LOCAL_CUTS = ("training.n_eval=1",)
# Phase 15: the JAX checkpoint that `tests/torch_make_jax_checkpoint.py` writes.
JAX_FIXTURE = Path("tests") / "torch_fixtures" / "jax_aldp"
SERVE_EDGE = dict(K=63, B=16, N=22, U=64, L=2)  # f32 exact trace: (N - 1) * 3 columns
SERVE_SAMPLES, SERVE_BATCH = 256, 128
# Phase 16: the options `setup_training` once refused, and Hutch++.  (a) the
# StableMLP JAX checkpoint (`tests/torch_make_jax_checkpoint.py
# --stable-mlp`), its log p, Hutch++ and chunked log p within OPTION_REL of
# JAX's; (b) exact-trace column chunks at the QM9 flagship width (K = 54);
# (c) Hutch++ against plain Hutchinson at the LJ13 width, 8 JVPs each;
# (d) remat on the QM9 flagship train step, gradients within REMAT_ATOL of
# no remat; (e) the matmul precisions on the LJ13 f32 structured solve;
# (f) the DW4 program with the options set, cut to 2 iterations and one
# test batch.
JAX_STABLE_FIXTURE = Path("tests") / "torch_fixtures" / "jax_aldp_stable"
OPTION_REL = 1e-4
QM9_CHUNKS = (None, 27, 9, 1)
HUTCH_DRAWS = 64
HUTCH_PLAIN, HUTCH_SKETCH, HUTCH_RESID = 8, 2, 4  # 8 = 2 * 2 + 4 JVPs each
REMAT_MODES = (False, True, "dots")
REMAT_ATOL = 1e-6
PRECISIONS = ("float32", "tensorfloat32", "bfloat16")
# n_eval=0: the one evaluation is at -1, before the profiler starts, so the
# trace holds the two epochs only.  The evaluation takes fixed rk4 steps
# and no figure: each field evaluation is four host-bound `torch.func`
# passes (the value and three chunks of 2), ~65 ms, and adaptive Dopri5
# takes ~270 of them where rk4 takes 80.
DW4_OPTION_CUTS = ("training.n_training_iter=2", "training.n_eval=0", "training.n_checkpoints=1",
                   "training.test_set_size=64", "training.use_fixed_step_size=true",
                   "training.ode_method=rk4", "training.eval_plots=false",
                   "flow.network.stable_mlp=true", "training.trace_column_chunk=2",
                   "training.precision=tensorfloat32")

# Phase 17: the world-size-1 NCCL path, in a child process (its own limit
# in seconds); (b) its QM9 steps, (d) the field's time and sharded-trace
# limit (max |sharded - unsharded| over max |unsharded|).
DIST_TIMEOUT = 300
DIST_STEPS = 3
DIST_ALLREDUCE_REPS = 20
DIST_TRACE_LIMIT = 1e-6
DIST_FIELD_T = 0.5

# The kernel table (phase 3): each kernel at the shapes PERF.md section 6
# reports, as (kernel, shape name, dtype, shape, reps of the kernel, reps
# of its plain version).  The edge-tangent rows take the design
# `resident_route` picks, but for ``blocks`` (the other one at its cost
# model's C); "qm9_hutch" is the QM9 cell's launch (one probe a sample).
_EGCL_LJ13, _EGCL_QM9 = (dict(n=n, units=u, hidden=h, blocks=nb, B=B) for _, n, u, h, nb, B in EGCL_SHAPES)
KERNEL_ROWS = (
    ("edge_tangent", "lj13", torch.float32, LJ13_EDGE, 20, 20),
    ("edge_tangent", "lj13", torch.bfloat16, LJ13_EDGE, 20, 20),
    ("edge_tangent", "qm9", torch.float32, QM9_EDGE, 5, 5),
    ("edge_tangent", "qm9", torch.bfloat16, QM9_EDGE, 5, 5),
    ("edge_tangent", "lj55", torch.bfloat16, LJ55_EDGE, 10, 2),
    ("edge_tangent", "lj55", torch.float32, dict(LJ55_EDGE, B=LJ55_F32_BATCH), 5, 2),
    ("edge_tangent", "lj55_blocks", torch.bfloat16, dict(LJ55_EDGE, blocks=True), 5, 2),
    ("edge_tangent", "qm9_hutch", torch.bfloat16, QM9_HUTCH_EDGE, 20, 20),
    ("egcl", "lj13", torch.float32, _EGCL_LJ13, 10, 10),
    ("egcl", "lj13_b256", torch.float32, dict(_EGCL_LJ13, B=256), 10, 10),
    ("egcl", "qm9", torch.float32, _EGCL_QM9, 10, 10),
    ("fused_trace", "lj13", torch.float32, _EGCL_LJ13, 10, 10),
    ("fused_trace", "qm9", torch.float32, _EGCL_QM9, 2, 2),
    ("edge_primal", "qm9_hutch", torch.bfloat16, dict(B=256, N=19, U=256, L=4, hidden=32), 20, 5),
    ("edge_primal", "lj13", torch.bfloat16, dict(B=48, N=13, U=128, L=3, hidden=64), 20, 5),
    ("edge_primal", "aldp_hutch", torch.bfloat16, dict(B=256, N=22, U=64, L=2, hidden=32), 20, 5),
    ("edge_primal", "lj55", torch.bfloat16, dict(B=16, N=55, U=128, L=3, hidden=64), 20, 5),
)
# The serving table (phase 4): `python -m ecnf_tpu_torch.sample`'s path
# (bf16) as (name, arguments after LJ13_ARGS, the launches each kernel must
# make, the edge-tangent launches of them that take the resident design or
# None): LJ13 on rk4, Dopri5 and the fused trace, and the LJ55 and QM9
# cells' rk4 solves.  Every edge-tangent launch of the LJ55 exact solve
# takes the resident design and none of the QM9 Hutchinson solve's (K=1).
SERVE_ROWS = (
    ("lj13 rk4", ["--method", "rk4"], dict(edge_tangent=RK4_LAUNCHES, edge_primal=RK4_LAUNCHES),
     None),
    ("lj13 dopri5", ["--method", "dopri5"], dict(edge_tangent=DOPRI5_LAUNCHES), None),
    ("lj13 rk4 fused", ["--fused-trace", "--method", "rk4"], dict(fused_trace=FUSED_LAUNCHES), None),
    ("lj55 rk4 exact", ["--n-nodes", "55", "--n-samples", "16", "--batch-size", "16", "--method",
                        "rk4"], dict(edge_tangent=RK4_LAUNCHES, edge_primal=RK4_LAUNCHES),
     RK4_LAUNCHES),
    ("qm9 rk4 hutchinson", ["--n-nodes", "19", "--n-samples", "256", "--batch-size", "256",
                            "--n-blocks", "5", "--mlp-units", "256", "256", "256", "256",
                            "--hidden", "32", "--base-scale", "2.0", "--approx", "--method", "rk4"],
     dict(edge_tangent=20 * 4 * 5, edge_primal=20 * 4 * 5), 0),
)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {message}")


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launch_count`` counts its launches."""
    from ecnf_tpu_torch.ops import edge_primal, edge_tangent, egcl, fused_trace

    return dict(zip(KERNELS, (
        edge_tangent.edge_tangent, egcl.egcl_fused, fused_trace.egnn_value_and_div_fused,
        edge_primal.edge_primal,
    )))


def zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a path is driven."""
    for fn in _wrappers().values():
        fn.launch_count = 0


def counts() -> dict:
    return {name: fn.launch_count for name, fn in _wrappers().items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def card_peaks() -> dict:
    """This card's published peaks, from the benchmark's
    ``h100_bench/work/peaks.json``."""
    kind = torch.cuda.get_device_name(0)
    table = json.loads((Path(__file__).resolve().parent / "h100_bench" / "work" / "peaks.json").read_text())
    check(kind in table, f"no published peaks for {kind} in h100_bench/work/peaks.json")
    return table[kind]


def roofline(flops, nbytes: float) -> dict:
    """Least time of a launch that computes ``flops`` (bf16, f32) and moves
    ``nbytes``: its products at the card's peaks by the benchmark's
    `seconds_at_peak` (f32 as three TF32 products under the matmul
    precision "highest" that `main` sets) or its bytes at the HBM rate,
    whichever is longer; in ms, with what bounds it and the FLOP."""
    from h100_bench.work import egnn as work

    ops_ms = 1e3 * work.seconds_at_peak(flops, card_peaks(), torch.get_float32_matmul_precision())
    bytes_ms = 1e3 * nbytes / card_peaks()["hbm_bytes_per_s"]
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flop=sum(flops), ops_ms=ops_ms, bytes_ms=bytes_ms, nbytes=nbytes)


def edge_bound(K, B, N, U, L, dtype) -> dict:
    """`roofline` of one edge-tangent launch, by the benchmark's
    `edge_chain_flops` and `edge_chain_bytes`, as `edge_tangent_roofline`
    reads it."""
    from h100_bench.work import egnn as work

    bf16 = dtype == torch.bfloat16
    return roofline(work.edge_chain_flops(K, B, N, U, L, bf16), work.edge_chain_bytes(K, B, N, U, L, bf16))


def rate_line(b: dict, ms: float) -> str:
    return (f"bound={b['bound_ms'] * 1e3:.1f}us ({b['bound_by']}) "
            f"achieved={b['flop'] / ms / 1e9:.1f} TFLOP/s share={b['bound_ms'] / ms:.3f}")


def _cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit."""
    found = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    found = str(found) if found.exists() else shutil.which("cuobjdump")
    check(found is not None, "cuobjdump not found")
    return found


def hmma_count(library: Path) -> int:
    """Tensor-core instructions in a built library's SASS: HMMA (mma.sync)
    and HGMMA (wgmma)."""
    out = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                         timeout=300, check=True)
    return sum(line.count("HMMA") + line.count("HGMMA") for line in out.stdout.splitlines())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_inputs(K, B, N, U, L, dtype, seed):
    """Random kernel arguments with the value ranges of the real residuals."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    cd = lambda x: x.to(dtype).contiguous()
    g = rand(B, N, N)
    return dict(
        a_t=cd(randn(K, B, N, U)), b_t=cd(randn(K, B, N, U)),
        l2_t=randn(K, B, N, N),
        d_e=[cd(rand(B, N, N, U, lo=-0.1, hi=1.1)) for _ in range(L)],
        d_x=[cd(rand(B, N, N, U, lo=-0.1, hi=1.1)) for _ in range(L)],
        m=cd(rand(B, N, N, U, lo=-0.3, hi=2.0)), g=cd(g), gd=cd(g * (1 - g)),
        e_l=cd(randn(U)),
        e_tail=[cd(randn(U, U, scale=U**-0.5)) for _ in range(L - 1)],
        x_tail=[cd(randn(U, U, scale=U**-0.5)) for _ in range(L)],
        x_out=cd(randn(U, scale=U**-0.5)), g_out=cd(randn(U, scale=U**-0.5)),
    )


def edge_errors(kernel, plain):
    """(max |kernel - plain|, that over max |plain|) of both outputs."""
    abs_err = max((k - p).abs().max().item() for k, p in zip(kernel, plain))
    return abs_err, abs_err / max(p.abs().max().item() for p in plain)


def primal_inputs(B, N, U, L, hidden, seed):
    """Block 0's bf16 weights of a CNF of these widths (Dense kernels at
    N(0, 1/fan_in)) and the primal kernel's inputs from random node
    features and positions."""
    from ecnf_tpu_torch.cnf.build import build_cnf
    from ecnf_tpu_torch.ops import tangent

    cnf = build_cnf(
        n_frames=N, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=1, mlp_units=(U,) * L,
        n_invariant_feat_hidden=hidden, time_embedding_dim=8, n_features=1,
        compute_dtype="bfloat16", device="cuda", generator=torch.Generator().manual_seed(seed),
    )
    redraw_dense_(cnf.field, seed + 1)
    wt = tangent.block_weights(cnf.field.egnn, 0, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    hb = torch.randn((B, N, hidden), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.randn((B, N, 3), generator=gen, device="cuda")
    return hb @ wt.e_s, hb @ wt.e_r, (torch.cdist(pos, pos) ** 2).contiguous(), wt


def redraw_dense_(field, seed: int) -> None:
    """Dense kernels -> N(0, 1/fan_in), so the network's trace is O(1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                w = torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1])
                p.copy_(w)


def f32_cnf(n, units, hidden, blocks, seed):
    """An f32 CNF on the card with Dense kernels at N(0, 1/fan_in)."""
    from ecnf_tpu_torch.cnf.build import build_cnf

    cnf = build_cnf(
        n_frames=n, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=blocks,
        mlp_units=units, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
        n_features=1, device="cuda", generator=torch.Generator().manual_seed(seed),
    )
    redraw_dense_(cnf.field, seed=seed + 1)
    return cnf


def field_inputs(n, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, n * 3), generator=gen).cuda()
    t = torch.rand((batch,), generator=gen).cuda()
    return x, t, torch.zeros((batch, n), dtype=torch.int64, device="cuda")


def rel_err(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _edge_row(dtype, K, B, N, U, L, blocks=False):
    """The edge-tangent kernel on random inputs: the design `resident_route`
    picks, or with ``blocks`` the other one at its cost model's C."""
    from ecnf_tpu_torch.ops import edge_tangent as et

    args = edge_inputs(K, B, N, U, L, dtype=dtype, seed=1)
    cols = et.default_columns(0, dtype, K, B, N, U, L)
    if blocks:
        run = lambda: et.edge_tangent(**args, columns_per_block=cols)
    else:
        run = lambda: et.edge_tangent(**args)
    resident = not blocks and et.resident_route(dtype, K, B, N, U, L)
    note = "resident design" if resident else f"blocks design, {cols} columns per thread block"
    return (run, lambda: et.edge_tangent_reference(**args), edge_errors, EDGE_LIMITS[dtype],
            edge_bound(K, B, N, U, L, dtype), note)


def _work_config(n, units, hidden, blocks) -> dict:
    """The network's widths as the benchmark's formulas read a config."""
    return dict(n_nodes=n, dim=3, n_invariant_feat_hidden=hidden, time_embedding_dim=8,
                mlp_units=units, n_blocks_egnn=blocks)


def _egcl_row(dtype, n, units, hidden, blocks, B):
    """`flat_egnn_apply_fused`'s forward, one launch a block.  Its bound: the
    blocks' products (`field_eval_flops` with no tangent column) and the
    field's inputs, outputs and weights read once (`fused_launch_bytes`)."""
    from h100_bench.work import egnn as work
    from ecnf_tpu_torch.ops import egcl

    cnf = f32_cnf(n, units, hidden, blocks, seed=5)
    x, t, f = field_inputs(n, B, seed=6)
    w = egcl.egnn_weights(cnf.field.egnn)
    cfg = _work_config(n, units, hidden, blocks)
    return (lambda: egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w),
            lambda: egcl.flat_egnn_apply_fused(cnf.field, x, t, f, w, use_kernel=False),
            lambda out, ref: ((out - ref).abs().max().item(), rel_err(out, ref)), F32_LIMIT,
            roofline(work.field_eval_flops(cfg, B, 0, False), work.fused_launch_bytes(cfg, B)),
            f"{blocks} launches")


def _fused_row(dtype, n, units, hidden, blocks, B):
    """`egnn_value_and_div_fused` over all N D columns; rel is the larger of
    the field value's and of the network's share of the trace
    (``div + 3 final_scaling``)."""
    from h100_bench.work import egnn as work
    from ecnf_tpu_torch.ops import fused_trace

    cnf = f32_cnf(n, units, hidden, blocks, seed=9)
    x, t, f = field_inputs(n, B, seed=10)
    w = cnf.fused_weights()
    offset = 3 * cnf.field.egnn.final_scaling.detach()
    cols = fused_trace.default_columns(0, B, n, 3, hidden, 8, units[0])

    def errors(out, ref):
        (v, d), (v_p, d_p) = out, ref
        abs_err = max((v - v_p).abs().max().item(), (d - d_p).abs().max().item())
        return abs_err, max(rel_err(v, v_p), rel_err(d + offset, d_p + offset))

    cfg = _work_config(n, units, hidden, blocks)
    return (lambda: fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w),
            lambda: fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, w, use_kernel=False),
            errors, F32_LIMIT,
            roofline(work.field_eval_flops(cfg, B, n * 3, False), work.fused_launch_bytes(cfg, B)),
            f"{n * 3} columns, {cols} per thread block")


def _primal_row(dtype, B, N, U, L, hidden):
    """`edge_primal` on block 0's weights; rel is the largest over its
    outputs (the silu' factors, m, phi, g, gd, m_i) of each one's error
    over its own largest plain value."""
    from h100_bench.metrics import edge_primal_roofline as primal
    from ecnf_tpu_torch.ops import edge_primal as ep

    a, b, l2, wt = primal_inputs(B, N, U, L, hidden, seed=11)

    def errors(out, ref):
        pairs = [(k.float(), p.float()) for k, p in zip([*out.d_e, *out.d_x, *out[2:]],
                                                        [*ref.d_e, *ref.d_x, *ref[2:]])]
        abs_err = max((k - p).abs().max().item() for k, p in pairs)
        return abs_err, max(((k - p).abs().max() / p.abs().max()).item() for k, p in pairs)

    return (lambda: ep.edge_primal(a, b, l2, wt), lambda: ep.edge_primal_reference(a, b, l2, wt),
            errors, EDGE_LIMITS[torch.bfloat16],
            roofline((primal.flops(B, N, U, L), 0.0), primal.nbytes(B, N, U, L)), f"hidden {hidden}")


_ROW_SETUP = dict(edge_tangent=_edge_row, egcl=_egcl_row, fused_trace=_fused_row,
                  edge_primal=_primal_row)


def kernel_row(row: tuple, card: str) -> dict:
    """One row of `KERNEL_ROWS`: the kernel against its plain version at the
    row's limit, both timed by `cuda_ms`, and the bound.  Prints one
    ``[kernel]`` line; returns ``abs_err``, ``ms``, ``plain_ms`` and the
    bound (`roofline`)."""
    kernel, name, dtype, shape, reps, plain_reps = row
    run, plain, errors, limit, b, note = _ROW_SETUP[kernel](dtype, **shape)
    abs_err, rel = errors(run(), plain())
    ms = cuda_ms(run, reps)
    plain_ms = cuda_ms(plain, plain_reps)
    print(f"[kernel] {kernel} {name} {str(dtype)[6:]} {shape}: max_abs_err={abs_err:.3e} "
          f"rel={rel:.3e} (limit {limit:.0e}) kernel={ms * 1e3:.1f}us plain={plain_ms * 1e3:.1f}us "
          f"{rate_line(b, ms)}; {note}; on {card}", flush=True)
    check(math.isfinite(rel) and rel <= limit, f"{kernel} {name} {dtype}: rel error {rel:.3e}")
    return dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **b)


def phase_kernels(card: str) -> dict:
    """Phase 3: every row of `KERNEL_ROWS`, by (kernel, name, dtype)."""
    results = {}
    for row in KERNEL_ROWS:
        results[row[:3]] = kernel_row(row, card)
        torch.cuda.empty_cache()
    return results


def serve_row(row: tuple, card: str) -> dict:
    """One row of `SERVE_ROWS`: ``sample.main`` with its launches of each
    kernel counted from zero.  Prints one ``[serve]`` line; returns the
    counts, with the resident design's as ``resident``."""
    from ecnf_tpu_torch import sample
    from ecnf_tpu_torch.ops import edge_tangent as et

    name, argv, expected, resident = row
    args = sample.build_parser().parse_args(LJ13_ARGS + argv)
    zero_counts()
    et.edge_tangent_resident.launch_count = 0
    t0 = time.perf_counter()
    out = sample.main(LJ13_ARGS + argv)
    seconds = time.perf_counter() - t0
    launched = dict(counts(), resident=et.edge_tangent_resident.launch_count)
    print(f"[serve] {name}, N={args.n_nodes} B={args.batch_size}: launches {launched} (expected "
          f"{expected}, resident {resident}); {seconds:.3f} s with its set-up; on {card}", flush=True)
    check(out["samples"].shape == (args.n_samples, args.n_nodes * 3),
          f"{name}: samples shape {out['samples'].shape}")
    check(bool(torch.isfinite(torch.from_numpy(out["samples"])).all()), f"{name}: non-finite samples")
    check(bool(torch.isfinite(torch.from_numpy(out["log_q"])).all()), f"{name}: non-finite log q")
    check(all(launched[k] == n for k, n in expected.items())
          and resident in (None, launched["resident"]), f"{name}: launches {launched}")
    return launched


def phase_f32_solves(sample, sampling) -> None:
    """Phases 5 and 6: the LJ13 float32 rk4 solve through the edge kernels
    (5) and through the fused trace (6), each against the plain edge chain
    and the ``torch.func.jvp`` trace from the same x0, on weights with an
    O(1) trace."""
    args = sample.build_parser().parse_args(LJ13_ARGS + ["--dtype", "float32"])
    cnf = sample.build_from_args(args, torch.device("cuda"))
    redraw_dense_(cnf.field, seed=2)
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(3))
    cfg = sampling.SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    _, offset = cnf.exact_trace_plan()
    # The jvp trace shares no code with the hand-linearised tangent.
    refs = {name: sampling.sample_and_log_prob_cnf(cnf, 48, feats, cfg=ref_cfg, x0=x0)
            for name, ref_cfg in (("plain", dataclasses.replace(cfg, structured_tangent_kernel=False)),
                                  ("jvp", dataclasses.replace(cfg, structured_tangent=False)))}
    for name, route_cfg in (("rk4 f32 kernel", cfg),
                            ("rk4 f32 fused", dataclasses.replace(cfg, fused_trace=True))):
        out = sampling.sample_and_log_prob_cnf(cnf, 48, feats, cfg=route_cfg, x0=x0)
        check(bool(torch.isfinite(out[1]).all()), f"{name}: non-finite log q")
        for ref_name, ref in refs.items():
            compare_solves(name, out, ref_name, ref, cnf, x0, offset)


def compare_solves(name, out, ref_name, ref, cnf, x0, offset) -> None:
    """log q and the network's share of delta log-lik (the constant trace
    offset, integrated over unit time, taken out) of two solves from x0.
    Both comparisons resolve one f32 ulp of log q (~4e-6 at |log q| ~ 49),
    so a 0 means "within it"."""
    (x1, lq), (x1_r, lq_r) = out, ref
    net = cnf.log_prob_base(x0) - lq - offset
    net_r = cnf.log_prob_base(x0) - lq_r - offset
    rel = ((lq - lq_r).abs().max() / lq_r.abs().max()).item()
    net_rel = ((net - net_r).abs().max() / net_r.abs().max()).item()
    x_err = (x1 - x1_r).abs().max().item()
    print(
        f"[serve] {name} vs {ref_name}: log_q rel {rel:.3e}, network delta "
        f"log-lik rel {net_rel:.3e} (limit {LOGQ_LIMIT:.0e} each), x1 max abs "
        f"{x_err:.3e}, mean network delta {net_r.mean().item():.4f}",
        flush=True,
    )
    check(rel <= LOGQ_LIMIT and net_rel <= LOGQ_LIMIT,
          f"{name} vs {ref_name}: log_q rel {rel:.3e}, network delta rel {net_rel:.3e}")


def phase_egcl_solve(egcl, ode) -> int:
    """Phase 7: an rk4 sample-only solve whose field is the fused forward,
    its EGCL launches counted, against the solve through the field module."""
    cnf = f32_cnf(13, (128,) * 3, 64, 3, seed=7)
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(8))
    w = egcl.egnn_weights(cnf.field.egnn)
    kw = dict(use_fixed_step_size=True, step_size=0.05, method="rk4")
    zero_counts()
    x1, _ = ode.odeint(
        lambda t, y: egcl.flat_egnn_apply_fused(cnf.field, y, t, feats, w), x0, 0.0, 1.0, **kw
    )
    torch.cuda.synchronize()
    launches = counts()["egcl"]
    with torch.no_grad():
        x1_r, _ = ode.odeint(lambda t, y: cnf.apply(y, t, feats), x0, 0.0, 1.0, **kw)
    rel = rel_err(x1, x1_r)
    print(
        f"[egcl] lj13 rk4 sample-only solve B=48 through the fused forward: launches "
        f"{launches} (expected {RK4_LAUNCHES}), x1 rel to the module's solve {rel:.3e} "
        f"(limit {F32_LIMIT:.0e})",
        flush=True,
    )
    check(bool(torch.isfinite(x1).all()), "non-finite fused-forward samples")
    check(launches == RK4_LAUNCHES, f"egcl launches {launches} != {RK4_LAUNCHES}")
    check(rel <= F32_LIMIT, f"fused-forward solve rel {rel:.3e}")
    return launches


def _train_cnf(q: dict, device, cdt=None, seed=0, n_features=1, sigma_min=0.01, base_scale=1.0):
    from ecnf_tpu_torch.cnf.build import build_cnf

    return build_cnf(
        n_frames=q["n"], dim=3, sigma_min=sigma_min, base_scale=base_scale,
        n_blocks_egnn=q["blocks"], mlp_units=q["units"], n_invariant_feat_hidden=q["hidden"],
        time_embedding_dim=8, n_features=n_features, compute_dtype=cdt, device=device,
        generator=torch.Generator().manual_seed(seed),
    )


def _train_parity(training) -> None:
    """(a) three f32 updates on the card against the same on the CPU."""
    import numpy as np

    optim, state_mod = training
    q = TRAIN_SMALL
    B, D = q["batch"], q["n"] * 3
    cpu = _train_cnf(q, "cpu", n_features=2, seed=11)
    # Dense kernels at N(0, 1/fan_in), biases at N(0, 0.1^2), from numpy.
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for name, p in cpu.field.named_parameters():
            if name.endswith("weight") and not name.startswith("embed"):
                p.copy_(torch.from_numpy(rng.normal(0, p.shape[1] ** -0.5, p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    card = _train_cnf(q, "cuda", n_features=2, seed=11)
    card.field.load_state_dict(cpu.field.state_dict())
    steps = [
        dict(x=rng.normal(size=(B, D)), noise=rng.normal(size=(B, D)), t=rng.uniform(size=(B,)))
        for _ in range(3)
    ]
    feats = np.tile(np.arange(q["n"]) % 2, (B, 1))
    for microbatch in (1, 4):
        opt = optim.build_optimizer(1e-3)
        runs = {}
        for device, cnf in (("cpu", cpu), ("cuda", card)):
            gen = torch.Generator(device=device).manual_seed(0)
            runs[device] = [cnf, state_mod.init_training_state(cnf, opt, gen, use_ema=True),
                            state_mod.make_update_fn(cnf, opt, use_ema=True, microbatch=microbatch)]
        worst = dict(info=0.0, grad=0.0, grad_global=0.0, param=0.0, ema=0.0)
        failures = []
        leaf_errs = []
        for i, step in enumerate(steps):
            out = {}
            for device, (cnf, st, update) in runs.items():
                as_t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(device, dt)
                x0 = cnf.sample_base((B,), noise=as_t(step["noise"]))
                args = (as_t(step["x"]), as_t(feats, torch.int64))
                grads, _ = state_mod.loss_and_grads(cnf, st.params, *args, microbatch, x0=x0,
                                                    t=as_t(step["t"]))
                st, info = update(st, *args, x0=x0, t=as_t(step["t"]))
                runs[device][1] = st
                out[device] = (grads, info, st)
            (g_c, i_c, s_c), (g_g, i_g, s_g) = out["cpu"], out["cuda"]
            where = f"train parity mb{microbatch} step {i}"
            for name in i_c:
                rel = abs(i_g[name].item() - i_c[name].item()) / abs(i_c[name].item())
                worst["info"] = max(worst["info"], rel)
                if rel > TRAIN_RTOL:
                    failures.append(f"{where}: {name} rel {rel:.3e}")
            global_scale = max(b.abs().max().item() for b in g_c)
            for name, a, b in zip(s_c.params, g_g, g_c):
                scale = b.abs().max().item()
                err = (a.cpu() - b).abs().max().item()
                leaf_errs.append((err / scale if scale else err, err, scale, f"step {i} {name}"))
                worst["grad"] = max(worst["grad"], err / scale if scale else err)
                worst["grad_global"] = max(worst["grad_global"], err / global_scale)
                if err > GRAD_RTOL * scale:
                    failures.append(f"{where}: grad {name} err {err:.3e} of scale {scale:.3e}")
            for key, tree_c, tree_g, atol in (("param", s_c.params, s_g.params, PARAM_ATOL),
                                               ("ema", s_c.ema_params, s_g.ema_params, EMA_ATOL)):
                err = max((tree_g[n].cpu() - tree_c[n]).abs().max().item() for n in tree_c)
                worst[key] = max(worst[key], err)
                if err > atol:
                    failures.append(f"{where}: {key} max abs {err:.3e}")
        leaf_errs.sort(reverse=True)
        print(f"[train] (a) microbatch {microbatch}: largest gradient-leaf errors (of the leaf's "
              f"own largest |g|): " + "; ".join(f"{r:.2e} ({e:.2e} of {sc:.2e}) {n}"
                                                 for r, e, sc, n in leaf_errs[:4]), flush=True)
        print(
            f"[train] (a) f32 card vs CPU, 3 updates, microbatch {microbatch}, EMA, Adam 1e-3: "
            f"loss/grad_norm/update_norm rel {worst['info']:.3e} (limit {TRAIN_RTOL:.0e}), "
            f"gradient leaves {worst['grad']:.3e} of the leaf's scale (limit {GRAD_RTOL:.0e}), "
            f"{worst['grad_global']:.3e} of the gradient's, "
            f"params {worst['param']:.3e} (limit {PARAM_ATOL:.0e}), EMA {worst['ema']:.3e} "
            f"(limit {EMA_ATOL:.0e})",
            flush=True,
        )
        check(not failures, "; ".join(failures[:6]))


def _profile_step(step) -> tuple:
    """Device kernel ms and kernels per step of ``step``, from a
    `torch.profiler` trace of PROFILE_STEPS runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return kernel_ms / PROFILE_STEPS, len(kernels) / PROFILE_STEPS


def _train_flagship(training, card: str) -> dict:
    """(b) the QM9 flagship step at microbatch 4, then 1."""
    import numpy as np

    from ecnf_tpu_torch.ops import flops

    optim, state_mod = training
    q = QM9_TRAIN
    B, D = q["batch"], q["n"] * 3
    cnf = _train_cnf(q, "cuda", cdt="bfloat16", sigma_min=1e-6, base_scale=2.0)
    data = torch.from_numpy(
        np.random.default_rng(0).normal(size=(TRAIN_STEPS + 1, B, D)).astype(np.float32)
    ).cuda()
    feats = torch.zeros((B, q["n"]), dtype=torch.int64, device="cuda")
    opt = optim.build_optimizer(1e-4)
    results = {}
    for microbatch in (4, 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = state_mod.init_training_state(cnf, opt, torch.Generator(device="cuda").manual_seed(0),
                                           use_ema=True)
        update = state_mod.make_update_fn(cnf, opt, use_ema=True, microbatch=microbatch)
        start = time.perf_counter()
        st, info = update(st, data[0], feats)
        first_loss = info["loss"].item()
        first_s = time.perf_counter() - start
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(TRAIN_STEPS)]
        losses = []
        for i, (ev_start, ev_end) in enumerate(events):
            ev_start.record()
            st, info = update(st, data[i + 1], feats)
            ev_end.record()
            losses.append(info["loss"])
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in events)
        losses = torch.stack(losses).cpu()
        check(math.isfinite(first_loss) and bool(torch.isfinite(losses).all()),
              f"QM9 train microbatch {microbatch}: non-finite loss")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(ms)
        box = {"st": st}

        def one_step():
            box["st"], _ = update(box["st"], data[0], feats)

        kernel_ms, n_kernels = _profile_step(one_step)
        # One more step, counted in a call of its own (never a timed one).
        count = flops.count_fn_flops(one_step)
        tflops = count.total / med / 1e9
        mfu = flops.mfu(count, med / 1e3, torch.cuda.get_device_name(0))
        check(mfu is not None and 0 < mfu <= 1, f"QM9 train microbatch {microbatch}: MFU {mfu}")
        results[microbatch] = dict(ms=med, first_s=first_s, peak_gb=peak_gb, tflops=tflops,
                                   busy=kernel_ms / med, count=count, mfu=mfu)
        print(
            f"[train] (b) QM9 flagship step (B={B}, N={q['n']}, {q['blocks']} blocks of "
            f"{list(q['units'])}, hidden {q['hidden']}, bf16, EMA, Adam 1e-4), microbatch "
            f"{microbatch}: first step {first_s:.3f} s (loss {first_loss:.4f}); {TRAIN_STEPS} steps "
            f"by CUDA events: median {med:.3f} ms/step, min {ms[0]:.3f}, max {ms[-1]:.3f}, "
            f"p10-p90 {ms[len(ms) // 10]:.3f}-{ms[(9 * len(ms)) // 10]:.3f}; "
            f"{1e3 / med:.2f} steps/s; peak device memory {peak_gb:.2f} GB; "
            f"{count.total / 1e12:.4f} TFLOP a step by count_fn_flops ({count.f32 / 1e9:.3f} GFLOP "
            f"of it f32) -> {tflops:.1f} TFLOP/s, MFU {mfu:.4f}; profiler over {PROFILE_STEPS} "
            f"steps: {n_kernels:.0f} device kernels and "
            f"{kernel_ms:.3f} ms of device kernel time a step, busy share {kernel_ms / med:.3f} "
            f"of the median step; last loss {losses[-1].item():.4f}; on {card}",
            flush=True,
        )
        del st, box
        torch.cuda.empty_cache()
    return results


def _train_progress(training, setup) -> None:
    """(c) the loss falls on one fixed LJ13 batch, through `epoch`."""
    import numpy as np

    optim, state_mod = training
    q = LJ13_TRAIN
    cnf = _train_cnf(q, "cuda", cdt="bfloat16")
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(q["batch"], q["n"] * 3)).astype(np.float32)
    ).cuda()
    feats = torch.zeros((q["batch"], q["n"]), dtype=torch.int64, device="cuda")
    opt = optim.build_optimizer(1e-3)
    st = state_mod.init_training_state(cnf, opt, torch.Generator(device="cuda").manual_seed(0))
    update = state_mod.make_update_fn(cnf, opt, microbatch=2)
    losses = []
    for _ in range(LJ13_UPDATES):
        st, infos = setup.epoch(st, update, x, feats, q["batch"])
        losses.append(infos["loss"])
    losses = torch.cat(losses).cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    print(
        f"[train] (c) LJ13 width (3 blocks of [128]*3, hidden 64, bf16, B={q['batch']}), one fixed "
        f"batch, {LJ13_UPDATES} updates through epoch, Adam 1e-3, microbatch 2: mean loss of the "
        f"first 5 {first:.4f}, of the last 5 {last:.4f}, ratio {last / first:.3f} (limit "
        f"{LOSS_FALL})",
        flush=True,
    )
    check(bool(torch.isfinite(losses).all()), "LJ13 train: non-finite loss")
    check(last < LOSS_FALL * first, f"LJ13 train: loss ratio {last / first:.3f} >= {LOSS_FALL}")


def phase_train(card: str) -> dict:
    """The train step: (a) parity, (b) the QM9 flagship step, (c) progress.
    The path runs no custom kernel, as in JAX: every count stays 0."""
    from ecnf_tpu_torch.training import optim, setup
    from ecnf_tpu_torch.training import state as state_mod

    training = (optim, state_mod)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "train parity needs allow_tf32 False")
    zero_counts()
    _train_parity(training)
    torch.set_float32_matmul_precision(precision)
    results = _train_flagship(training, card)
    _train_progress(training, setup)
    launched = counts()
    check(not any(launched.values()), f"the train path launched custom kernels: {launched}")
    return results


class SolveRecorder:
    """While active, records every ODE solve that `cnf.sampling` runs: its
    `ODEStats`, its time by CUDA events, its output, whose non-finite
    rows are the samples that diverged or ran out of steps, and whether it
    carried the trace (a log-density solve) or only the samples."""

    def __init__(self, sampling):
        self.sampling = sampling
        self.solves = []

    def __enter__(self):
        self._solve = solve = self.sampling._solve

        def recorded(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            y, stats = solve(*args, **kwargs)
            end.record()
            traced = "_augmented_field" in getattr(args[0], "__qualname__", "")
            self.solves.append((stats, start, end, y, traced))
            return y, stats

        self.sampling._solve = recorded
        return self

    def __exit__(self, *exc):
        self.sampling._solve = self._solve

    def rows(self) -> list:
        """Per solve: steps, attempts, field evaluations, host syncs, device
        ms, rows that came back non-finite, whether it carried the trace."""
        torch.cuda.synchronize()
        return [
            dict(steps=st.num_steps, attempts=st.num_attempts, evals=2 + 6 * st.num_attempts,
                 syncs=st.num_syncs, ms=a.elapsed_time(b),
                 nan_rows=int((~torch.isfinite(y).all(dim=-1)).sum()), rows=y.shape[0],
                 traced=traced)
            for st, a, b, y, traced in self.solves
        ]


def solve_line(r: dict) -> str:
    return (f"{r['steps']} accepted steps, {r['attempts']} attempts, {r['evals']} field "
            f"evaluations, {r['syncs']} host syncs, {r['ms']:.1f} ms, "
            f"{r['nan_rows']}/{r['rows']} rows non-finite")


def solve_gaps(out: dict, ref: dict) -> dict:
    """Largest |difference| of x1 and of delta log-lik between two solves
    (``solve``'s dicts in `phase_evaluation`), and both step counts."""
    return dict(
        x1=(out["x1"] - ref["x1"]).abs().max().item(),
        delta=(out["delta"] - ref["delta"]).abs().max().item(),
        steps=(out["row"]["steps"], ref["row"]["steps"]),
        attempts=(out["row"]["attempts"], ref["row"]["attempts"]),
    )


def steps_within(g: dict) -> bool:
    return all(abs(a - b) <= EVAL_STEP_SHARE * max(a, b) for a, b in (g["steps"], g["attempts"]))


def gap_line(name: str, g: dict) -> str:
    return (f"[eval] {name}: x1 max abs {g['x1']:.3e}, delta log-lik max abs {g['delta']:.3e}, "
            f"steps {g['steps'][0]} vs {g['steps'][1]}, attempts {g['attempts'][0]} vs "
            f"{g['attempts'][1]} (within {EVAL_STEP_SHARE:.0%} of the larger: {steps_within(g)})")


def finite_solve(out: dict) -> bool:
    return bool(torch.isfinite(out["x1"]).all()) and bool(torch.isfinite(out["delta"]).all())


def compare_to_control(name: str, out: dict, ref: dict, control: dict) -> None:
    """Two solves from one x0, held to the control's gaps (see
    EVAL_CONTROL_TIMES)."""
    g = solve_gaps(out, ref)
    print(f"{gap_line(name, g)}; {g['x1'] / control['x1']:.2f} and "
          f"{g['delta'] / control['delta']:.2f} of the control's gaps (limit "
          f"{EVAL_CONTROL_TIMES:g})", flush=True)
    check(finite_solve(out), f"{name}: non-finite output")
    check(g["x1"] <= EVAL_CONTROL_TIMES * control["x1"]
          and g["delta"] <= EVAL_CONTROL_TIMES * control["delta"], f"{name}: beyond the control")
    check(steps_within(g), f"{name}: step counts beyond the slack")


def captured_edge_args(et, cnf, x, t, feats) -> list:
    """The edge chain's ``(args, kwargs)``, one per block, of one
    structured exact-trace evaluation of ``cnf`` at ``(x, t [B])``, as the
    solve makes it (run through the plain version)."""
    calls, plain = [], et.edge_tangent_reference

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        return plain(*args, **kwargs)

    basis, offset = cnf.exact_trace_plan()
    et.edge_tangent_reference = capture
    try:
        cnf.tangent_value_and_div(x, t, feats, basis, trace_offset=offset, use_kernel=False,
                                  weights=cnf.trace_weights())
    finally:
        et.edge_tangent_reference = plain
    return calls


def eval_kernel_checks(et, fused_trace, cnfs: dict, x, feats) -> dict:
    """Both kernels of the evaluation at its shapes (B=64) against their
    plain versions, at the kernel table's limits: the edge kernel on
    random inputs and on the inputs of one structured evaluation (per-sample
    times, every block), in f32 and bf16; the fused kernel on that
    evaluation's points.  Returns the bf16 random case's ms and bound."""
    B, n = x.shape[0], x.shape[1] // 3
    t = torch.rand((B,), generator=torch.Generator().manual_seed(16)).cuda()
    timed = {}
    for dtype, cnf in cnfs.items():
        name = str(dtype).replace("torch.", "")
        args = edge_inputs(**dict(LJ13_EDGE, B=B), dtype=dtype, seed=15)
        cases = [("random inputs", (), args)] + [
            (f"block {i} of one evaluation at per-sample t", a, k)
            for i, (a, k) in enumerate(captured_edge_args(et, cnf, x, t, feats))
        ]
        for case, a, k in cases:
            abs_err, rel = edge_errors(et.edge_tangent(*a, **k), et.edge_tangent_reference(*a, **k))
            print(f"[eval] edge_tangent K=36 B={B} {name}, {case}: max_abs_err={abs_err:.3e} "
                  f"rel={rel:.3e} (limit {EDGE_LIMITS[dtype]:.0e})", flush=True)
            check(math.isfinite(rel) and rel <= EDGE_LIMITS[dtype],
                  f"edge_tangent B={B} {name} {case}: rel error {rel:.3e}")
        if dtype == torch.bfloat16:
            ms = cuda_ms(lambda: et.edge_tangent(**args), 20)
            timed = dict(ms=ms, **edge_bound(LJ13_EDGE["K"], B, n, 128, 3, dtype))
        del args, cases

    cnf = cnfs[torch.float32]
    w = cnf.fused_weights()
    v, d = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, feats, w)
    v_p, d_p = fused_trace.egnn_value_and_div_fused(cnf.field, x, t, feats, w, use_kernel=False)
    offset = 3 * cnf.field.egnn.final_scaling.detach()
    v_rel, net_rel = rel_err(v, v_p), rel_err(d + offset, d_p + offset)
    print(f"[eval] fused_trace B={B} f32 at per-sample t: v rel {v_rel:.3e}, network trace rel "
          f"{net_rel:.3e} (limit {F32_LIMIT:.0e} each)", flush=True)
    check(math.isfinite(v_rel) and v_rel <= F32_LIMIT, f"fused B={B} v rel {v_rel:.3e}")
    check(math.isfinite(net_rel) and net_rel <= F32_LIMIT, f"fused B={B} trace rel {net_rel:.3e}")
    return timed


def phase_evaluation(sampling, score, setup, energies, et, fused_trace, card: str) -> dict:
    """The evaluation path at the LJ13 config width, adaptive Dopri5 at the
    `SolveConfig()` defaults: (a) f32 through the edge kernel against the
    plain version and the control, and with two rows frozen as NaN; both
    kernels against their plain versions at this path's shapes; (b) the
    `score` entry point's round trip; (c) bf16 evaluation with the LJ
    target; (d) the fused trace."""
    import numpy as np

    from ecnf_tpu_torch.cnf.build import build_cnf
    from ecnf_tpu_torch.convert import flatten, to_flax

    start = time.perf_counter()
    n, B = 13, EVAL_B
    cnf = f32_cnf(n, (128,) * 3, 64, 3, seed=12)
    cnf_bf = build_cnf(
        n_frames=n, dim=3, sigma_min=0.01, base_scale=1.0, n_blocks_egnn=3, mlp_units=(128,) * 3,
        n_invariant_feat_hidden=64, time_embedding_dim=8, n_features=1, compute_dtype="bfloat16",
        device="cuda",
    )
    cnf_bf.field.load_state_dict(cnf.field.state_dict())
    feats = torch.zeros((B, n), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((B,), generator=torch.Generator().manual_seed(13))
    cfg = sampling.SolveConfig()
    plain_cfg = dataclasses.replace(cfg, structured_tangent_kernel=False)
    launches = {}

    def solve(x0_, name, cfg_=cfg):
        zero_counts()
        with SolveRecorder(sampling) as rec:
            x1, lq = sampling.sample_and_log_prob_cnf(cnf, B, feats, cfg=cfg_, x0=x0_)
        launches[name] = counts()
        row = rec.rows()[0]
        print(f"[eval] {name}: {solve_line(row)}", flush=True)
        return dict(x1=x1, lq=lq, delta=rec.solves[0][3][:, -1], row=row)

    # (a) f32, kernel against plain, same x0.
    kernel = solve(x0, "(a) f32 kernel")
    check(launches["(a) f32 kernel"]["edge_tangent"] == 3 * kernel["row"]["evals"],
          f"(a) edge launches {launches['(a) f32 kernel']} for {kernel['row']['evals']} evaluations")
    plain = solve(x0, "(a) f32 plain", plain_cfg)
    check(launches["(a) f32 plain"]["edge_tangent"] == 0, "the plain solve launched the kernel")
    check(finite_solve(plain), "(a) plain: non-finite output")
    # The control: the plain path against itself from x0 one ulp up and down.
    gaps = []
    for way, towards in (("up", math.inf), ("down", -math.inf)):
        name = f"(a) control: plain, x0 one ulp {way}"
        nudged = solve(torch.nextafter(x0, torch.full_like(x0, towards)), name, plain_cfg)
        gaps.append(solve_gaps(nudged, plain))
        print(gap_line(f"{name} vs plain", gaps[-1]), flush=True)
        check(finite_solve(nudged) and steps_within(gaps[-1]), f"{name}: non-finite or beyond the slack")
    control = {k: max(g[k] for g in gaps) for k in ("x1", "delta")}
    check(control["x1"] > 0 and control["delta"] > 0, f"the control did not part: {control}")
    compare_to_control("(a) f32 kernel vs plain", kernel, plain, control)
    # Two rows frozen as NaN (a diverged sample) leave every other row as it was.
    frozen = [5, 40]
    x0_nan = x0.clone()
    x0_nan[frozen] = float("nan")
    nan = solve(x0_nan, "(a) f32 kernel, rows 5 and 40 NaN")
    keep = torch.ones(B, dtype=torch.bool, device="cuda")
    keep[frozen] = False
    same = torch.equal(nan["x1"][keep], kernel["x1"][keep]) and torch.equal(nan["lq"][keep], kernel["lq"][keep])
    print(f"[eval] (a) NaN rows: other rows identical to the solve without them: {same}; "
          f"NaN rows non-finite: {not bool(torch.isfinite(nan['lq'][~keep]).any())}", flush=True)
    check(same and not bool(torch.isfinite(nan["lq"][~keep]).any()), "(a) NaN rows leaked or faulted")

    # Both kernels at this path's shapes, on (a)'s samples.
    edge = eval_kernel_checks(et, fused_trace, {torch.float32: cnf, torch.bfloat16: cnf_bf},
                              kernel["x1"], feats)

    # (b) the score entry point on (a)'s samples and weights, adaptive.
    out_dir = Path(__file__).resolve().parent / "build" / "eval"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "params.npz", **flatten(to_flax(cnf.field)))
    np.save(out_dir / "samples.npy", kernel["x1"].reshape(B, n, 3).cpu().numpy())
    zero_counts()
    with SolveRecorder(sampling) as rec:
        scored = score.main(["--data", str(out_dir / "samples.npy"), "--params-npz",
                             str(out_dir / "params.npz"), "--batch-size", str(B), "--dtype",
                             "float32", "--device", "cuda"])
    launches["(b) score"] = counts()
    row_b = rec.rows()[0]
    log_p, log_q = torch.from_numpy(scored["log_p"]), kernel["lq"].cpu()
    gap = (log_p - log_q).abs().max().item()
    jax_share = ((log_p - log_q).abs() / (ROUND_TRIP_TOL + ROUND_TRIP_TOL * log_q.abs())).max().item()
    print(f"[eval] (b) score round trip: {solve_line(row_b)}; |log p - log q| max {gap:.3e}, "
          f"{gap / control['delta']:.2f} of the control's delta gap (limit {EVAL_CONTROL_TIMES:g}); "
          f"{jax_share:.3f} of the JAX CPU round trip's 1e-3 + 1e-3 |log q| (limit 1)", flush=True)
    check(launches["(b) score"]["edge_tangent"] == 3 * row_b["evals"], f"(b) launches {launches['(b) score']}")
    check(bool(np.isfinite(scored["log_p"]).all()), "(b) non-finite log p")
    check(jax_share <= 1 and gap <= EVAL_CONTROL_TIMES * control["delta"], f"(b) round trip gap {gap:.3e}")

    # (c) bf16, the config's dtype: the evaluation with the LJ target on a
    # stand-in test set, (a)'s zero-CoM samples.
    test_pos = kernel["x1"].reshape(B, n, 3)
    test_pos = (test_pos - test_pos.mean(dim=1, keepdim=True)).reshape(B, -1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with SolveRecorder(sampling) as rec:
        t0 = time.perf_counter()
        info = setup.evaluate(
            cnf_bf, test_pos, feats, feats[0], B, energies.lennard_jones_log_prob,
            n_model_samples=EVAL_RV_SAMPLES, cfg=cfg, generator=torch.Generator().manual_seed(14),
        )
        wall = time.perf_counter() - t0
    launches["(c) bf16 evaluate"] = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = rec.rows()
    for name, r in zip(["test batch"] + [f"rv batch {i}" for i in range(1, len(rows))], rows):
        print(f"[eval] (c) bf16 {name}: {solve_line(r)}", flush=True)
    evals = sum(r["evals"] for r in rows)
    solve_ms = sum(r["ms"] for r in rows)
    rv_ms = sum(r["ms"] for r in rows[1:])
    edge_launches = launches["(c) bf16 evaluate"]["edge_tangent"]
    syncs = sum(r["syncs"] for r in rows)
    nan_rows, all_rows = sum(r["nan_rows"] for r in rows), sum(r["rows"] for r in rows)
    print(
        f"[eval] (c) bf16 evaluation (LJ13 width, eval batch {B}, rv_ess from "
        f"{EVAL_RV_SAMPLES} model samples in {len(rows) - 1} batches): "
        + ", ".join(f"{k} {v:.6g}" for k, v in info.items())
        + f"; {len(rows)} solves, {sum(r['attempts'] for r in rows)} attempts, {evals} field "
        f"evaluations, {edge_launches} edge-kernel launches, {syncs} host syncs, "
        f"NaN share {nan_rows}/{all_rows}; one batch (the test batch) {rows[0]['ms']:.1f} ms by "
        f"CUDA events; reverse-ESS loop {EVAL_RV_SAMPLES / (rv_ms / 1e3):.1f} samples/s; "
        f"evaluate {wall:.2f} s wall; edge kernel {edge['ms']:.3f} ms a launch at K=36 B={B} bf16 "
        f"({rate_line(edge, edge['ms'])}), {edge_launches} x that = "
        f"{100 * edge_launches * edge['ms'] / solve_ms:.1f}% of the solves; "
        f"peak device memory {peak_gb:.2f} GB; on {card}",
        flush=True,
    )
    check(set(info) == {"test_log_lik", "test_log_prob_base", "test_delta_log_lik",
                        "eval_ode_steps", "forward_ess", "rv_ess"}, f"(c) keys {sorted(info)}")
    check(edge_launches == 3 * evals, f"(c) edge launches {edge_launches} for {evals} evaluations")
    exhausted = [r for r in rows if r["attempts"] >= cfg.max_steps]
    if exhausted:
        print(f"[eval] (c) FINDING: {len(exhausted)} bf16 solve(s) exhausted max_steps="
              f"{cfg.max_steps} at rtol=atol={cfg.rtol:g}; their unfinished rows are NaN", flush=True)

    # (d) f32 with fused_trace=True, the same solve as (a), against the plain path.
    fused = solve(x0, "(d) f32 fused trace", dataclasses.replace(cfg, fused_trace=True))
    check(launches["(d) f32 fused trace"]["fused_trace"] == fused["row"]["evals"],
          f"(d) fused launches {launches['(d) f32 fused trace']} for {fused['row']['evals']} evaluations")
    compare_to_control("(d) f32 fused vs (a) plain", fused, plain, control)

    adaptive_edge = sum(v["edge_tangent"] for v in launches.values())
    print(f"[eval] edge_tangent launches on the adaptive evaluation path: "
          + ", ".join(f"{k} {v['edge_tangent']}" for k, v in launches.items())
          + f"; {adaptive_edge} in all; fused_trace {launches['(d) f32 fused trace']['fused_trace']}; "
          f"phase {time.perf_counter() - start:.1f} s", flush=True)
    return dict(edge_launches=adaptive_edge, info=info)


def _timed(module, name: str, out: list, cuda_events: bool):
    """Wrap ``module.name`` to record each call's ms (CUDA events) or
    seconds (host clock after a synchronise); returns the original."""
    orig = getattr(module, name)

    def timed(*args, **kwargs):
        if cuda_events:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            result = orig(*args, **kwargs)
            end.record()
            out.append((start, end))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = orig(*args, **kwargs)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return result

    setattr(module, name, timed)
    return orig


def _clone_args(args) -> tuple:
    return tuple([t.clone() for t in a] if isinstance(a, (list, tuple)) else a.clone() for a in args)


class EdgeCapture:
    """While active, keeps copies of the arguments of edge launches
    ``capture_at`` .. ``capture_at + blocks - 1`` (the EGNN blocks of one
    field evaluation; none when ``capture_at`` is None) in ``captured``.
    The kernel's wrapper counts its launches on whatever its module name
    holds, here the capturing function; the count goes back to the wrapper
    after."""

    def __init__(self, et, capture_at=None, blocks: int = 1):
        self.et, self.capture_at, self.blocks = et, capture_at, blocks
        self.captured = []

    def __enter__(self):
        self.orig = orig = self.et.edge_tangent
        at, blocks, captured = self.capture_at, self.blocks, self.captured

        def capturing(*args, **kwargs):
            if at is not None and at <= capturing.launch_count < at + blocks:
                captured.append(_clone_args(args))
            return orig(*args, **kwargs)

        capturing.launch_count = 0
        self.capturing = self.et.edge_tangent = capturing
        return self

    def __exit__(self, *exc):
        self.et.edge_tangent = self.orig
        self.orig.launch_count += self.capturing.launch_count


def _run_program(example, config_name, common, setup, sampling, et, overrides, blocks,
                 capture_at=None, local_extra=None, **run_kwargs) -> dict:
    """One run of an experiment entry point's ``run`` (``example.run(cfg,
    device="cuda", **run_kwargs)`` on ``config_name`` with ``overrides``,
    and with the ``--local`` block and ``local_extra`` when that is given)
    with its epochs timed by CUDA events, its evaluations and the default
    plotter's sampling solves by the host clock, every solve recorded (the
    log-density solves in ``rows``, the sample-only ones in
    ``sample_rows``), the kernels' launches counted and the
    last epoch's arguments kept (``epoch_args``).  ``capture_at`` (a multiple of
    ``blocks``) keeps the arguments of that edge launch of the run and of
    the ``blocks - 1`` after it: the EGNN blocks of one field evaluation."""
    cfg = common.load_experiment_config(str(common.CONFIG_DIR / config_name),
                                        local_extra is not None, overrides, local_extra or ())
    epochs, evals, plots, epoch_args = [], [], [], []
    orig_epoch = _timed(setup, "epoch", epochs, cuda_events=True)
    timed_epoch = setup.epoch

    def keeping(*args, **kwargs):
        epoch_args[:] = [args]
        return timed_epoch(*args, **kwargs)

    setup.epoch = keeping
    orig_eval = _timed(setup, "evaluate", evals, cuda_events=False)
    orig_sample = _timed(setup, "sample_cnf", plots, cuda_events=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with EdgeCapture(et, capture_at, blocks) as capture, SolveRecorder(sampling) as rec:
            logger, state = example.run(cfg, device="cuda", **run_kwargs)
    finally:
        setup.epoch, setup.evaluate, setup.sample_cnf = orig_epoch, orig_eval, orig_sample
    captured = capture.captured
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = rec.rows()
    return dict(cfg=cfg, history=logger.history, state=state, launches=counts(),
                rows=[r for r in rows if r["traced"]], sample_rows=[r for r in rows if not r["traced"]],
                epoch_ms=[a.elapsed_time(b) for a, b in epochs], eval_s=evals, plot_s=plots, wall=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, captured=captured,
                epoch_args=epoch_args[0] if epoch_args else None)


def _check_program(name: str, run: dict, iterations: list, n_evals: int) -> None:
    h = run["history"]
    losses = h.get("loss", [])
    n_steps = DW4_STEPS_PER_EPOCH * sum(1 for i in set(iterations) if i >= 0)
    check(h["iteration"] == [float(i) for i in iterations], f"{name}: iterations {h['iteration']}")
    check(len(losses) == n_steps and all(math.isfinite(v) for v in losses),
          f"{name}: {len(losses)} losses, expected {n_steps} finite")
    check(len(h.get("test_log_lik", [])) == n_evals and all(math.isfinite(v) for v in h["test_log_lik"]),
          f"{name}: test_log_lik {h.get('test_log_lik')}")
    check(all(0.0 <= v <= 1.0 for v in h["forward_ess"]), f"{name}: forward_ess {h['forward_ess']}")
    check(all(v > 0 for v in h["eval_ode_steps"]), f"{name}: eval_ode_steps {h['eval_ode_steps']}")
    evals = sum(r["evals"] for r in run["rows"])
    launched = run["launches"]
    check(launched["edge_tangent"] == 3 * evals and launched["egcl"] == launched["fused_trace"] == 0,
          f"{name}: launches {launched} for {evals} field evaluations")
    steps = ", ".join(f"{ms:.1f} ms ({ms / DW4_STEPS_PER_EPOCH:.2f} ms/step)" for ms in run["epoch_ms"])
    print(f"[dw4] {name}: iterations logged {sorted(set(h['iteration']))}; {len(losses)} losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; evaluations: "
          + "; ".join(f"test_log_lik {a:.4f} forward_ess {b:.4g} eval_ode_steps {c:.2f}"
                      for a, b, c in zip(h["test_log_lik"], h["forward_ess"], h["eval_ode_steps"]))
          + f"; epochs by CUDA events {steps}; seconds per evaluation "
          + ", ".join(f"{s:.2f}" for s in run["eval_s"])
          + f"; {len(run['rows'])} solves, {sum(r['attempts'] for r in run['rows'])} attempts, "
          f"{evals} field evaluations, {launched['edge_tangent']} edge launches (3 per evaluation); "
          f"peak device memory {run['peak_gb']:.2f} GB; {run['wall']:.1f} s wall", flush=True)


def phase_training_program(et, card: str) -> dict:
    """The training program at DW4's config width: (a) data by HMC on the
    card, (b) the entry point's run, (c) resume, (d) the edge kernel at
    this path's shape."""
    import numpy as np

    from ecnf_tpu_torch.cnf import sampling
    from ecnf_tpu_torch.examples import common, dw4
    from ecnf_tpu_torch.targets import data, energies, mcmc
    from ecnf_tpu_torch.training import checkpoints, setup

    start = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "dw4"
    shutil.rmtree(root, ignore_errors=True)
    data_dir, save_dir = root / "data", root / "run"

    # (a) the captured HMC step against the eager one, with chain 5 started
    # at NaN (it accepts nothing) and restarted half-way through a burn-in.
    gen = torch.Generator().manual_seed(21)
    total = HMC_GRAPH_STEPS
    x0 = torch.randn(64, 4, 2, generator=gen)
    x0[5] = float("nan")
    draws = dict(momenta=torch.randn(total, 64, 4, 2, generator=gen), uniforms=torch.rand(total, 64, generator=gen))
    hmc = dict(n_samples_per_chain=total - total // 2, n_chains=64, n_nodes=4, dim=2, step_size=0.12,
               n_leapfrog=15, burn_in=total // 2, thin=1, init_positions=x0, device="cuda",
               restart_stuck_at=total // 4, **draws)
    graphed, acc_g = mcmc.run_hmc(energies.double_well_log_prob, cuda_graph=True, **hmc)
    eager, acc_e = mcmc.run_hmc(energies.double_well_log_prob, cuda_graph=False, **hmc)
    gap = ((graphed - eager).abs().max() / eager.abs().max()).item()
    print(f"[dw4] (a) HMC step as a CUDA graph vs eager, {total} steps of 64 chains (chain 5 NaN; "
          f"chains without an accepted step restarted at step {total // 4}): rel {gap:.3e} (limit "
          f"{HMC_GRAPH_LIMIT:.0e}), acceptance {acc_g:.4f} vs {acc_e:.4f}", flush=True)
    check(bool(torch.isfinite(graphed).all()) and gap <= HMC_GRAPH_LIMIT and acc_g == acc_e,
          f"graphed HMC step rel {gap:.3e}")
    regen = data._generate_dw4_data(data_dir / data.DW4_CACHE, "cuda")
    r = regen.report
    hmc = data.DW4_HMC
    print(f"[dw4] (a) DW4 data by HMC on the card ({regen.data.shape[0]} configurations, "
          f"{hmc['n_chains']} chains x {hmc['n_samples_per_chain']}, "
          f"{hmc['burn_in'] + hmc['n_samples_per_chain'] * hmc['thin']} steps x "
          f"{hmc['n_leapfrog']} leapfrog): acceptance {regen.acceptance:.4f}, R-hat "
          f"{r['rhat_energy']:.4f} / {r['rhat_dist']:.4f} (energy / distance), ESS "
          f"{r['ess_energy']:.0f} / {r['ess_dist']:.0f}, mean energy {r['mean_energy']:.4f}, mean "
          f"distance {r['mean_dist']:.4f}, {regen.seconds:.1f} s; gate passed (R-hat < 1.05, ESS > "
          f"{10 * hmc['n_chains']}); the JAX run: {DW4_JAX_HMC}", flush=True)
    check(regen.data.shape == (12800, 4, 2) and bool(np.isfinite(regen.data).all()), "DW4 data")

    # (b) the program, cut.
    cuts = list(DW4_CUTS) + [f"training.save_dir={save_dir}"]
    print(f"[dw4] (b) dw4.yaml cut by {' '.join(cuts)}", flush=True)
    run_b = _run_program(dw4, "dw4.yaml", common, setup, sampling, et, cuts, blocks=3,
                         data_dir=data_dir)
    _check_program("(b) run", run_b, [-1] + [0] * 15 + [1] * 15 + [1], n_evals=2)
    ckpts = save_dir / "model_checkpoints"
    names = sorted(p.name for p in ckpts.iterdir())
    check(names == ["state_00000000", "state_00000001"], f"(b) checkpoints {names}")

    # (c) resume to 3 iterations from state_00000001.
    saved = checkpoints.restore_serving_params(str(ckpts / "state_00000001"))
    same = all(torch.equal(saved[k], v.cpu()) for k, v in run_b["state"].params.items())
    check(same and saved.keys() == run_b["state"].params.keys(), "(c) saved parameters differ")
    cuts_c = [c for c in cuts if "n_training_iter" not in c] + [
        "training.n_training_iter=3", "training.resume=true"]
    run_c = _run_program(dw4, "dw4.yaml", common, setup, sampling, et, cuts_c, blocks=3,
                         capture_at=DW4_CAPTURE_AT, data_dir=data_dir)
    _check_program("(c) resumed run", run_c, [2] * 15 + [2], n_evals=1)
    names = sorted(p.name for p in ckpts.iterdir())
    check(names == ["state_00000000", "state_00000001", "state_00000002"], f"(c) checkpoints {names}")
    check(run_c["state"].opt_state.count == 3 * DW4_STEPS_PER_EPOCH,
          f"(c) optimizer count {run_c['state'].opt_state.count}")
    print(f"[dw4] (c) restored parameters equal (b)'s bit for bit: {same}; optimizer step count "
          f"{run_c['state'].opt_state.count}", flush=True)

    # (d) the edge kernel at DW4's shape, on random inputs and on the
    # inputs captured from one field evaluation of (c)'s evaluation (bf16,
    # the config's dtype; the f32 kernel takes the same values in f32).
    check(len(run_c["captured"]) == 3, f"(d) captured {len(run_c['captured'])} launches, not 3")
    to_f32 = lambda a: [t.float() for t in a] if isinstance(a, list) else a.float()
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        args = edge_inputs(**DW4_EDGE, dtype=dtype, seed=23)
        cases = [("random inputs", (), args)] + [
            (f"block {i} of field evaluation {DW4_CAPTURE_AT // 3} of (c)'s evaluation",
             a if dtype == torch.bfloat16 else tuple(to_f32(x) for x in a), {})
            for i, a in enumerate(run_c["captured"])
        ]
        for case, a, k in cases:
            abs_err, rel = edge_errors(et.edge_tangent(*a, **k), et.edge_tangent_reference(*a, **k))
            print(f"[dw4] (d) edge_tangent {DW4_EDGE} {name}, {case}: max_abs_err={abs_err:.3e} "
                  f"rel={rel:.3e} (limit {EDGE_LIMITS[dtype]:.0e})", flush=True)
            check(math.isfinite(rel) and rel <= EDGE_LIMITS[dtype],
                  f"DW4 edge_tangent {name} {case}: rel error {rel:.3e}")
        ms = cuda_ms(lambda: et.edge_tangent(**args), 50)
        plain_ms = cuda_ms(lambda: et.edge_tangent_reference(**args), 50)
        K, B, N, U, L = (DW4_EDGE[k] for k in ("K", "B", "N", "U", "L"))
        b = edge_bound(K, B, N, U, L, dtype)
        print(f"[dw4] (d) edge_tangent {name} at DW4's shape: kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, {rate_line(b, ms)}", flush=True)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, **b)
        del args, cases
    solve_ms = sum(r["ms"] for r in run_b["rows"] + run_c["rows"])
    launches = run_b["launches"]["edge_tangent"] + run_c["launches"]["edge_tangent"]
    share = launches * timed["bfloat16"]["ms"] / solve_ms
    eval_s = run_b["eval_s"] + run_c["eval_s"]
    step_ms = [ms / DW4_STEPS_PER_EPOCH for ms in run_b["epoch_ms"] + run_c["epoch_ms"]]
    print(f"[dw4] (d) the edge kernel in (b) and (c)'s evaluations: {launches} launches x "
          f"{timed['bfloat16']['ms']:.4f} ms = {100 * share:.1f}% of {solve_ms:.1f} ms of solves "
          f"(CUDA events); ms per train step {', '.join(f'{v:.2f}' for v in step_ms)} (first epoch "
          f"first); seconds per evaluation {', '.join(f'{v:.2f}' for v in eval_s)}; phase "
          f"{time.perf_counter() - start:.1f} s; on {card}", flush=True)
    return dict(edge=timed, share=share)


def phase_qm9_program(et, card: str) -> dict:
    """The QM9 and MoG programs: (a) ``examples.qm9.run`` at qm9.yaml's
    width, with its Hutchinson evaluations; (b) the
    edge kernel on one field evaluation's inputs captured there; (c)
    ``measure_sampling_time`` on (a)'s checkpoints; (d) MoG."""
    from ecnf_tpu_torch import measure_sampling_time
    from ecnf_tpu_torch.cnf import sampling
    from ecnf_tpu_torch.examples import common, mog, qm9
    from ecnf_tpu_torch.targets import synthetic_qm9
    from ecnf_tpu_torch.training import setup
    from ecnf_tpu_torch.training.loop import run_training

    start = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "qm9"
    shutil.rmtree(root, ignore_errors=True)
    data_dir, save_dir = root / "data", root / "run"
    synthetic_qm9.write_synthetic_qm9(data_dir)

    # (a) the program, cut.
    cuts = list(QM9_CUTS) + [f"training.save_dir={save_dir}"]
    print(f"[qm9] (a) qm9.yaml cut by {' '.join(cuts)}; data: the port's synthetic stand-ins "
          f"(seed {synthetic_qm9.SEED}, marker present, allow_synthetic=True)", flush=True)
    run = _run_program(qm9, "qm9.yaml", common, setup, sampling, et, cuts, blocks=QM9_BLOCKS,
                       capture_at=QM9_CAPTURE_AT, data_dir=data_dir, allow_synthetic=True)
    t, net = run["cfg"].training, run["cfg"].flow.network
    check(t.epochs_per_dispatch == 64 and t.microbatch == 4 and t.use_ema and t.batch_size == 256
          and t.eval_batch_size == 256 and not t.eval_exact_log_prob and t.hutchinson_probes == 1
          and net.compute_dtype == "bfloat16" and list(net.mlp_units) == [256] * 4
          and net.n_blocks_egnn == QM9_BLOCKS, f"qm9.yaml read as {t} {net}")
    h = run["history"]
    losses = h.get("loss", [])
    steps = QM9_STEPS_PER_EPOCH
    iterations = [-1] + [i for i in range(3) for _ in range(steps)] + [2] + [
        i for i in range(3, 6) for _ in range(steps)] + [5]
    check(h["iteration"] == [float(i) for i in iterations], f"(a) iterations {h['iteration']}")
    check(len(losses) == 6 * steps and all(math.isfinite(v) for v in losses), f"(a) losses {losses}")
    check(len(run["epoch_ms"]) == 6, f"(a) {len(run['epoch_ms'])} epochs")
    lls = h.get("test_log_lik", [])
    check(len(lls) == 3 and all(math.isfinite(v) for v in lls), f"(a) test_log_lik {lls}")
    check(all(v > 0 for v in h["eval_ode_steps"]), f"(a) eval_ode_steps {h['eval_ode_steps']}")
    names = sorted(p.name for p in (save_dir / "model_checkpoints").iterdir())
    check(names == ["state_00000002", "state_00000005"], f"(a) checkpoints {names}")
    rows, launched = run["rows"], run["launches"]
    evals = sum(r["evals"] for r in rows)
    check(launched["edge_tangent"] == QM9_BLOCKS * sum(2 + 6 * r["attempts"] for r in rows)
          and launched["egcl"] == launched["fused_trace"] == 0,
          f"(a) launches {launched} for {evals} field evaluations")
    check(not any(r["nan_rows"] for r in rows), "(a) non-finite rows in an evaluation")
    step_ms = [ms / steps for ms in run["epoch_ms"]]
    print(f"[qm9] (a) iterations logged {sorted(set(h['iteration']))}; {len(losses)} losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; epochs of {steps} steps by CUDA events "
          + ", ".join(f"{ms:.1f} ms ({v:.2f} ms/step)" for ms, v in zip(run["epoch_ms"], step_ms))
          + "; evaluations (Hutchinson, 1 probe, batch 256): "
          + "; ".join(f"test_log_lik {a:.4f} eval_ode_steps {b:.2f}"
                      for a, b in zip(lls, h["eval_ode_steps"]))
          + f"; seconds per evaluation {', '.join(f'{s:.2f}' for s in run['eval_s'])}; solves: "
          + ", ".join(f"{r['steps']} steps / {r['attempts']} attempts ({r['ms']:.1f} ms)"
                      for r in rows)
          + f"; {evals} field evaluations, {launched['edge_tangent']} edge launches "
          f"({launched['edge_tangent'] / evals:g} per evaluation); peak device memory "
          f"{run['peak_gb']:.2f} GB; {run['wall']:.1f} s wall", flush=True)

    # (b) the edge kernel at the QM9 Hutchinson shape on the captured inputs.
    check(len(run["captured"]) == QM9_BLOCKS, f"(b) captured {len(run['captured'])} launches")
    K, B, N, U, L = (QM9_HUTCH_EDGE[k] for k in ("K", "B", "N", "U", "L"))
    for i, a in enumerate(run["captured"]):
        check(tuple(a[0].shape) == (K, B, N, U) and a[0].dtype == torch.bfloat16,
              f"(b) block {i} a_t {tuple(a[0].shape)} {a[0].dtype}")
        abs_err, rel = edge_errors(et.edge_tangent(*a), et.edge_tangent_reference(*a))
        print(f"[qm9] (b) edge_tangent {QM9_HUTCH_EDGE} bfloat16, block {i} of field evaluation "
              f"{QM9_CAPTURE_AT // QM9_BLOCKS} of the evaluation at -1: max_abs_err={abs_err:.3e} "
              f"rel={rel:.3e} (limit {EDGE_LIMITS[torch.bfloat16]:.0e})", flush=True)
        check(math.isfinite(rel) and rel <= EDGE_LIMITS[torch.bfloat16],
              f"QM9 Hutchinson edge_tangent block {i}: rel error {rel:.3e}")
    a = run["captured"][0]
    out = et.edge_tangent(*a)
    abs_err, _ = edge_errors(out, et.edge_tangent_reference(*a))
    ms = cuda_ms(lambda: et.edge_tangent(*a), 20)
    plain_ms = cuda_ms(lambda: et.edge_tangent_reference(*a), 20)
    b = edge_bound(K, B, N, U, L, torch.bfloat16)
    cols = et.default_columns(0, torch.bfloat16, K, B, N, U, L)
    plan = et.launch_plan(0, torch.bfloat16, K, B, N, U, L, cols)
    solve_ms = sum(r["ms"] for r in rows)
    share = launched["edge_tangent"] * ms / solve_ms
    print(f"[qm9] (b) edge_tangent at the QM9 Hutchinson shape (bf16, block 0): kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, {rate_line(b, ms)} (its "
          f"operations alone {b['ops_ms'] * 1e3:.1f} us); cost model: "
          f"{cols} columns per thread block, {plan['smem_bytes']} B of shared memory, "
          f"{plan['blocks_per_sm']} blocks per SM, {plan['row_tiles']} row tiles per warp; "
          f"{launched['edge_tangent']} launches x {ms:.4f} ms = {100 * share:.1f}% of "
          f"{solve_ms:.1f} ms of (a)'s evaluation solves (CUDA events)", flush=True)

    # (c) measure_sampling_time on (a)'s checkpoints.
    zero_counts()
    sampled = measure_sampling_time.main(
        ["--checkpoint-dir", str(save_dir / "model_checkpoints"), *QM9_SAMPLING_ARGS])
    same = sampled["params"].keys() == run["state"].params.keys() and all(
        torch.equal(sampled["params"][k].cpu(), v.cpu()) for k, v in run["state"].params.items())
    check(str(sampled["checkpoint"]).endswith("state_00000005") and same,
          f"(c) restored {sampled['checkpoint']}: parameters equal the run's last: {same}")
    check(bool(torch.isfinite(sampled["samples"]).all())
          and tuple(sampled["samples"].shape) == (QM9_SAMPLING_BATCH, 57), "(c) samples")
    check(not any(counts().values()), f"(c) the sample-only solve launched {counts()}")
    print(f"[qm9] (c) measure_sampling_time {' '.join(QM9_SAMPLING_ARGS)}: restored "
          f"{Path(sampled['checkpoint']).name}, parameters equal the run's last bit for bit: "
          f"{same}; first call {sampled['first_s']:.3f} s, best of 3 "
          f"{1e3 * min(sampled['rep_s']):.1f} ms ({', '.join(f'{1e3 * v:.1f}' for v in sampled['rep_s'])} "
          f"ms; CUDA events) for {QM9_SAMPLING_BATCH} samples (f32, adaptive Dopri5)", flush=True)

    # (a) continued, after (c) read the checkpoints: where a train step's
    # time goes, from further epochs of the run's own update on its state.
    _, update, pos, feats, batch_size = run["epoch_args"]
    box = {"st": run["state"]}

    def one_epoch():
        box["st"], _ = setup.epoch(box["st"], update, pos, feats, batch_size)

    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(PROFILE_STEPS)]
    for ev_start, ev_end in events:
        ev_start.record()
        one_epoch()
        ev_end.record()
    torch.cuda.synchronize()
    again_ms = statistics.median(a.elapsed_time(b) for a, b in events) / steps
    kernel_ms, n_kernels = _profile_step(one_epoch)
    print(f"[qm9] (a) {PROFILE_STEPS} more epochs of the run's update: median {again_ms:.2f} ms a "
          f"train step (CUDA events); profiler over {PROFILE_STEPS} more: {n_kernels / steps:.0f} "
          f"device kernels and {kernel_ms / steps:.3f} ms of device kernel time a step, busy "
          f"share {kernel_ms / steps / again_ms:.3f}", flush=True)
    del box

    # (d) MoG at its default width.
    zero_counts()
    t0 = time.perf_counter()
    mog_dir = root / "mog"
    logger, state = run_training(mog.setup_mog_training(n_iteration=MOG_ITERATIONS, n_eval=1,
                                                        device="cuda", save_dir=str(mog_dir)))
    torch.cuda.synchronize()
    mog_s = time.perf_counter() - t0
    h = logger.history
    figures = check_svgs(mog_dir / "plots", [
        f"plot_{j:03d}_iter_{i:08d}.svg" for i in (-1, MOG_ITERATIONS - 1) for j in (0, 1)])
    metrics = ("test_log_lik", "test_kl", "test_approx_log_lik")
    check(all(len(h.get(m, [])) == 2 and all(math.isfinite(v) for v in h[m]) for m in metrics),
          f"(d) MoG metrics { {m: h.get(m) for m in metrics} }")
    check(len(h["loss"]) == MOG_ITERATIONS * (10000 // 64) and all(map(math.isfinite, h["loss"])),
          "(d) MoG losses")
    check(not any(counts().values()), f"(d) MoG launched {counts()}")
    print(f"[mog] (d) MoG, VectorNet (512, 512, 512), {MOG_ITERATIONS} iterations of 156 steps "
          f"and evaluations at -1 and {MOG_ITERATIONS - 1} on 256 test points: "
          + "; ".join(f"{m} {h[m][0]:.4f} -> {h[m][1]:.4f}" for m in metrics)
          + f"; loss {h['loss'][0]:.4f} .. {h['loss'][-1]:.4f}; figures (SVG, each parsed) {figures}; "
          f"{mog_s:.1f} s wall; phase "
          f"{time.perf_counter() - start:.1f} s; on {card}", flush=True)
    return dict(edge=dict(ms=ms, plain_ms=plain_ms, abs_err=abs_err, **b), share=share)


def check_svgs(directory: Path, names: list) -> str:
    """Each of ``names`` is the only figure in ``directory``, parses as
    SVG, and has a series in it; returns their sizes."""
    import xml.etree.ElementTree as ET

    found = sorted(p.name for p in directory.iterdir()) if directory.exists() else []
    check(found == sorted(names), f"figures in {directory}: {found}, expected {sorted(names)}")
    sizes = []
    for name in names:
        root = ET.parse(directory / name).getroot()
        series = [e for e in root.iter() if e.get("class") in ("stairs", "scatter", "quiver", "line")]
        check(root.tag == "{http://www.w3.org/2000/svg}svg" and series, f"{name}: no SVG series")
        sizes.append(f"{name} {(directory / name).stat().st_size} B")
    return ", ".join(sizes)


def phase_aldp_program(et, card: str) -> dict:
    """The ALDP program: (a) the HDF5 reader on the card; (b)
    ``examples.aldp.run`` at aldp_soak.yaml's width, cut, with its
    figures; (c) the edge kernel at the ALDP Hutchinson shape on one field
    evaluation's inputs captured in (b); (d) the ``--local`` ALDP and DW4
    programs on the card through the zero-padded edge kernel."""
    import numpy as np

    from ecnf_tpu_torch.cnf import sampling
    from ecnf_tpu_torch.examples import aldp, common, dw4
    from ecnf_tpu_torch.targets import load_aldp
    from ecnf_tpu_torch.targets.h5 import read_dataset
    from ecnf_tpu_torch.training import setup

    start = time.perf_counter()
    repo = Path(__file__).resolve().parent
    root = repo / "build" / "aldp"
    shutil.rmtree(root, ignore_errors=True)
    h5 = str(repo / ALDP_H5)
    paths = [f"target.{k}_path={h5}" for k in ("train", "valid", "test")]

    # (a) the reader.
    t0 = time.perf_counter()
    coords = read_dataset(h5, "coordinates")
    read_s = time.perf_counter() - t0
    c = coords.astype(np.float64).ravel()
    sums = (math.fsum(c), math.fsum(c * c))
    print(f"[aldp] (a) targets.h5.read_dataset({ALDP_H5}, coordinates): {coords.shape} "
          f"{coords.dtype}, finite {bool(np.isfinite(coords).all())}, float64 sum {sums[0]!r}, "
          f"sum of squares {sums[1]!r} (pinned on the CPU against h5py: {ALDP_H5_SUMS}); "
          f"{read_s * 1e3:.1f} ms", flush=True)
    check(coords.shape == (2000, 22, 3) and coords.dtype == np.float32
          and bool(np.isfinite(coords).all()) and sums == ALDP_H5_SUMS, "(a) the ALDP coordinates")

    # (b) the program at aldp_soak.yaml's width, cut.
    save_dir = root / "run"
    cuts = list(ALDP_CUTS) + paths + [f"training.save_dir={save_dir}"]
    print(f"[aldp] (b) aldp_soak.yaml cut by {' '.join(ALDP_CUTS)} (and the data's absolute path)",
          flush=True)
    run = _run_program(aldp, "aldp_soak.yaml", common, setup, sampling, et, cuts, blocks=ALDP_BLOCKS,
                       capture_at=ALDP_CAPTURE_AT)
    cfg = run["cfg"]
    t, net = cfg.training, cfg.flow.network
    check(list(net.mlp_units) == [64, 64] and net.n_blocks_egnn == ALDP_BLOCKS
          and net.n_invariant_feat_hidden == 32 and net.time_embedding_dim == 8
          and net.compute_dtype == "bfloat16" and t.batch_size == 256 and t.use_ema
          and t.optimizer.use_schedule and t.train_set_size == 1600 and t.test_set_size == 400
          and cfg.target.test_skip == 1600 and t.final_run and not t.eval_exact_log_prob
          and t.epochs_per_dispatch == 50, f"aldp_soak.yaml read as {t} {net} {cfg.target}")
    train, _, test = load_aldp(train_path=h5, test_path=h5, train_n_points=1600, test_skip_n=1600,
                               device="cpu")
    check(torch.equal(train.positions, torch.from_numpy(coords[:1600]))
          and torch.equal(test.positions[:400], torch.from_numpy(coords[1600:2000])),
          "(b) splits: 1,600 training frames, then 400 disjoint test frames")
    h = run["history"]
    steps = ALDP_STEPS_PER_EPOCH
    iterations = [-1] + [0] * steps + [1] * steps + [1]
    losses, lls = h.get("loss", []), h.get("test_log_lik", [])
    check(h["iteration"] == [float(i) for i in iterations], f"(b) iterations {h['iteration']}")
    check(len(losses) == 2 * steps and all(map(math.isfinite, losses)), f"(b) losses {losses}")
    check(len(lls) == 2 and all(map(math.isfinite, lls)), f"(b) test_log_lik {lls}")
    check(all(v > 0 for v in h["eval_ode_steps"]), f"(b) eval_ode_steps {h['eval_ode_steps']}")
    names = sorted(p.name for p in (save_dir / "model_checkpoints").iterdir())
    check(names == ["state_00000001"], f"(b) checkpoints {names}")
    figures = check_svgs(save_dir / "plots", ["plot_000_iter_-0000001.svg",
                                              "plot_000_iter_00000001.svg"])
    rows, launched = run["rows"], run["launches"]
    evals = sum(r["evals"] for r in rows)
    check(launched["edge_tangent"] == ALDP_BLOCKS * evals and launched["egcl"] == launched["fused_trace"] == 0,
          f"(b) launches {launched} for {evals} field evaluations")
    check(not any(r["nan_rows"] for r in rows), "(b) non-finite rows in an evaluation")
    check(len(run["sample_rows"]) == 2 and len(run["plot_s"]) == 2,
          f"(b) {len(run['sample_rows'])} plotting solves")
    step_ms = [ms / steps for ms in run["epoch_ms"]]
    print(f"[aldp] (b) iterations logged {sorted(set(h['iteration']))}; {len(losses)} losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; ms per train step by CUDA events "
          + ", ".join(f"{v:.2f}" for v in step_ms) + " (an epoch of 6 steps each, the first with "
          "the set-up); evaluations (Hutchinson, 1 probe, 2 batches of 256): "
          + "; ".join(f"test_log_lik {a:.4f} eval_ode_steps {b:.2f}"
                      for a, b in zip(lls, h["eval_ode_steps"]))
          + f"; seconds per evaluation {', '.join(f'{v:.2f}' for v in run['eval_s'])} and per "
          f"plotting solve ({t.plot_batch_size} samples) {', '.join(f'{v:.2f}' for v in run['plot_s'])}; "
          "log-density solves: " + ", ".join(f"{r['steps']} steps / {r['attempts']} attempts "
                                             f"({r['ms']:.1f} ms)" for r in rows)
          + "; plotting solves: " + ", ".join(f"{r['steps']} steps / {r['attempts']} attempts "
                                              f"({r['ms']:.1f} ms)" for r in run["sample_rows"])
          + f"; {evals} field evaluations, {launched['edge_tangent']} edge launches "
          f"({launched['edge_tangent'] / evals:g} per evaluation); figures {figures}; peak device "
          f"memory {run['peak_gb']:.2f} GB; {run['wall']:.1f} s wall", flush=True)

    # (c) the edge kernel at the ALDP Hutchinson shape on the captured inputs.
    check(len(run["captured"]) == ALDP_BLOCKS, f"(c) captured {len(run['captured'])} launches")
    K, B, N, U, L = (ALDP_HUTCH_EDGE[k] for k in ("K", "B", "N", "U", "L"))
    for i, a in enumerate(run["captured"]):
        check(tuple(a[0].shape) == (K, B, N, U) and a[0].dtype == torch.bfloat16 and len(a[3]) == L,
              f"(c) block {i} a_t {tuple(a[0].shape)} {a[0].dtype}")
        abs_err, rel = edge_errors(et.edge_tangent(*a), et.edge_tangent_reference(*a))
        print(f"[aldp] (c) edge_tangent {ALDP_HUTCH_EDGE} bfloat16, block {i} of field evaluation "
              f"{ALDP_CAPTURE_AT // ALDP_BLOCKS} of the evaluation at -1: max_abs_err={abs_err:.3e} "
              f"rel={rel:.3e} (limit {EDGE_LIMITS[torch.bfloat16]:.0e})", flush=True)
        check(math.isfinite(rel) and rel <= EDGE_LIMITS[torch.bfloat16],
              f"ALDP Hutchinson edge_tangent block {i}: rel error {rel:.3e}")
    a = run["captured"][0]
    out = et.edge_tangent(*a)
    abs_err, _ = edge_errors(out, et.edge_tangent_reference(*a))
    ms = cuda_ms(lambda: et.edge_tangent(*a), 50)
    plain_ms = cuda_ms(lambda: et.edge_tangent_reference(*a), 50)
    b = edge_bound(K, B, N, U, L, torch.bfloat16)
    cols = et.default_columns(0, torch.bfloat16, K, B, N, U, L)
    plan = et.launch_plan(0, torch.bfloat16, K, B, N, U, L, cols)
    solve_ms = sum(r["ms"] for r in rows)
    share = launched["edge_tangent"] * ms / solve_ms
    print(f"[aldp] (c) edge_tangent at the ALDP Hutchinson shape (bf16, block 0): kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, {rate_line(b, ms)} (its operations "
          f"alone {b['ops_ms'] * 1e3:.1f} us, its {b['nbytes'] / 1e6:.1f} MB at "
          f"{card_peaks()['hbm_bytes_per_s'] / 1e12:.2f} TB/s {b['bytes_ms'] * 1e3:.1f} us); "
          f"cost model: {cols} columns per thread block, {plan['smem_bytes']} B of shared memory, "
          f"{plan['blocks_per_sm']} blocks per SM, {plan['row_tiles']} row tiles per warp; "
          f"{launched['edge_tangent']} launches x {ms:.4f} ms = {100 * share:.1f}% of "
          f"{solve_ms:.1f} ms of (b)'s evaluation solves (CUDA events); on {card}", flush=True)

    # (d) --local on the card: ALDP (U=4) and DW4 (U=16) through the padded kernel.
    local_runs = (
        ("aldp", aldp, "aldp.yaml", list(ALDP_LOCAL_CUTS) + paths, 1, {}),
        ("dw4", dw4, "dw4.yaml", list(ALDP_LOCAL_CUTS), 2,
         dict(data_dir=repo / "build" / "dw4" / "data")),
    )
    for name, example, config_name, overrides, blocks, kwargs in local_runs:
        r = _run_program(example, config_name, common, setup, sampling, et, overrides, blocks,
                         capture_at=blocks * 20, local_extra=example.LOCAL_EXTRA, **kwargs)
        h, width = r["history"], r["cfg"].flow.network.mlp_units[0]
        evals = sum(x["evals"] for x in r["rows"])
        check(all(map(math.isfinite, h["loss"])) and len(h["test_log_lik"]) == 2
              and all(map(math.isfinite, h["test_log_lik"])), f"(d) {name} --local: {h}")
        check(r["launches"]["edge_tangent"] == blocks * evals,
              f"(d) {name} --local: launches {r['launches']} for {evals} field evaluations")
        check(len(r["captured"]) == blocks, f"(d) {name}: captured {len(r['captured'])} launches")
        errors = []
        for a in r["captured"]:
            check(a[0].shape[-1] == width, f"(d) {name}: captured U={a[0].shape[-1]}")
            abs_err, rel = edge_errors(et.edge_tangent(*a), et.edge_tangent_reference(*a))
            check(math.isfinite(rel) and rel <= EDGE_LIMITS[a[0].dtype],
                  f"(d) {name} padded edge_tangent U={width}: rel error {rel:.3e}")
            errors.append(f"{rel:.3e}")
        print(f"[aldp] (d) {name} --local on the card ({' '.join(ALDP_LOCAL_CUTS)}): mlp_units "
              f"[{width}] padded to {et.kernel_units(width)} in the edge kernel; {len(h['loss'])} "
              f"losses, test_log_lik {', '.join(f'{v:.4f}' for v in h['test_log_lik'])}; "
              f"{r['launches']['edge_tangent']} edge launches for {evals} field evaluations; the "
              f"padded kernel on one field evaluation's {blocks} block(s), "
              f"{str(a[0].dtype).replace('torch.', '')}, rel to the plain version at U={width}: "
              f"{', '.join(errors)} (limit {EDGE_LIMITS[a[0].dtype]:.0e}); {r['wall']:.1f} s wall",
              flush=True)
    print(f"[aldp] phase {time.perf_counter() - start:.1f} s; on {card}", flush=True)
    return dict(edge=dict(ms=ms, plain_ms=plain_ms, abs_err=abs_err, **b), share=share)


def leaf_digests(tree, path=()) -> dict:
    """``{"/"-joined key path: {dtype, shape, sha256}}`` of a tree that
    `read_orbax_tree` gives back (its None leaves left out)."""
    import hashlib

    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(leaf_digests(v, path + (str(k),)))
        return out
    if tree is None:
        return {}
    return {"/".join(path): {"dtype": tree.dtype.str, "shape": list(tree.shape),
                             "sha256": hashlib.sha256(tree.tobytes()).hexdigest()}}


def phase_jax_checkpoint(et, card: str) -> dict:
    """Serving a checkpoint the JAX package wrote: (a) the Orbax reader;
    (b) ``score`` raw and ``--ema`` against JAX's log p, and the edge kernel
    at that shape; (c) ``sample --ema`` with the config's adaptive bf16
    solve."""
    import numpy as np

    from ecnf_tpu_torch import sample, score
    from ecnf_tpu_torch.training.ocdbt import OcdbtStore
    from ecnf_tpu_torch.training.orbax import read_orbax_tree
    from ecnf_tpu_torch.utils import zstd

    start = time.perf_counter()
    fixture = Path(__file__).resolve().parent / JAX_FIXTURE
    expected = json.loads((fixture / "expected.json").read_text())
    checkpoint = fixture / expected["checkpoint"]

    # (a) the reader, in a process without JAX.
    check("jax" not in sys.modules, "(a) JAX is loaded in this process")
    t0 = time.perf_counter()
    tree = read_orbax_tree(str(checkpoint))
    read_s = time.perf_counter() - t0
    digests = leaf_digests(tree)
    check(digests == expected["leaves"], "(a) the leaves differ from expected.json")
    store = OcdbtStore(str(checkpoint))
    chunks = [store.read(k) for k in store.keys() if not k.endswith(b".zarray")]
    t0 = time.perf_counter()
    decoded = sum(len(zstd.decompress(c)) for c in chunks)
    decode_s = time.perf_counter() - t0
    rate = decoded / decode_s / 1e6
    print(f"[jax-ckpt] (a) read_orbax_tree({JAX_FIXTURE / expected['checkpoint']}): "
          f"{len(digests)} leaves, each dtype, shape and SHA-256 as in expected.json; "
          f"{read_s * 1e3:.1f} ms (host clock); zstd: {len(chunks)} chunk frames, "
          f"{sum(map(len, chunks))} bytes -> {decoded} bytes in {decode_s * 1e3:.1f} ms, "
          f"{rate:.2f} MB/s decoded; on {card}", flush=True)

    # (b) score, raw and --ema, against JAX's numbers.
    config = str(Path(__file__).resolve().parent / expected["config"])
    argv = ["--config", config, "--checkpoint-dir", str(fixture / "model_checkpoints"),
            "--features", "arange", "--data", str(fixture / "frames.npy"),
            "--batch-size", str(SERVE_EDGE["B"]), "--device", "cuda", *expected["score_overrides"]]
    blocks = 3
    results, launched = {}, {}
    for name, extra in (("params", []), ("params, again", []), ("ema_params", ["--ema"])):
        zero_counts()
        with EdgeCapture(et, 0 if name == "params" else None, blocks) as capture:
            out = score.main(argv + extra)
        launched[name] = counts()
        results[name] = out
        if name == "params":
            captured = capture.captured
        key = name.split(",")[0]
        ref = np.asarray(expected["log_p"][key])
        rel = float(np.abs(out["log_p"] - ref).max() / np.abs(ref).max())
        print(f"[jax-ckpt] (b) score {' '.join(expected['score_overrides'])} {' '.join(extra)}: "
              f"log p {', '.join(f'{v:.4f}' for v in out['log_p'][:4])} ..; JAX "
              f"{', '.join(f'{v:.4f}' for v in ref[:4])} ..; max rel {rel:.3e} (limit "
              f"{LOGQ_LIMIT:g}); {launched[name]['edge_tangent']} edge launches; "
              f"{out['first_batch_seconds']:.3f} s for the batch of {len(ref)}", flush=True)
        check(rel <= LOGQ_LIMIT and np.isfinite(out["log_p"]).all(), f"(b) {name}: rel {rel:.3e}")
        check(launched[name]["edge_tangent"] > 0 and launched[name]["egcl"] == 0
              and launched[name]["fused_trace"] == 0, f"(b) {name}: launches {launched[name]}")
    gap = float(np.abs(results["ema_params"]["log_p"] - results["params"]["log_p"]).max())
    check(gap > 2 * LOGQ_LIMIT * float(np.abs(results["params"]["log_p"]).max()),
          f"(b) --ema changes log p by only {gap:.3e}")
    first_s, steady_s = (results[n]["first_batch_seconds"] for n in ("params", "params, again"))
    print(f"[jax-ckpt] (b) --ema moves log p by up to {gap:.4f}; score's batch of 16: first call "
          f"{first_s:.3f} s (CUDA start-up in it), the same call again {steady_s:.3f} s "
          f"({16 / steady_s:.1f} configurations/s); on {card}", flush=True)

    # The edge kernel at the serving shape, on one field evaluation's inputs.
    check(len(captured) == blocks, f"(b) captured {len(captured)} launches")
    K, B, N, U, L = (SERVE_EDGE[k] for k in ("K", "B", "N", "U", "L"))
    for i, a in enumerate(captured):
        check(tuple(a[0].shape) == (K, B, N, U) and a[0].dtype == torch.float32 and len(a[3]) == L,
              f"(b) block {i} a_t {tuple(a[0].shape)} {a[0].dtype}")
        abs_err, rel = edge_errors(et.edge_tangent(*a), et.edge_tangent_reference(*a))
        check(math.isfinite(rel) and rel <= EDGE_LIMITS[torch.float32],
              f"(b) serving edge_tangent block {i}: rel error {rel:.3e}")
    a = captured[0]
    out = et.edge_tangent(*a)
    abs_err, rel = edge_errors(out, et.edge_tangent_reference(*a))
    ms = cuda_ms(lambda: et.edge_tangent(*a), 50)
    plain_ms = cuda_ms(lambda: et.edge_tangent_reference(*a), 50)
    b = edge_bound(K, B, N, U, L, torch.float32)
    print(f"[jax-ckpt] (b) edge_tangent {SERVE_EDGE} float32, block 0 of the first field "
          f"evaluation: max_abs_err={abs_err:.3e} rel={rel:.3e} (limit "
          f"{EDGE_LIMITS[torch.float32]:.0e}); kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us, {rate_line(b, ms)}; on {card}", flush=True)

    # (c) sample from the checkpoint's EMA with the config's own solve.
    zero_counts()
    out = sample.main(["--config", config, "--checkpoint-dir", str(fixture / "model_checkpoints"),
                       "--ema", "--features", "arange", "--n-nodes", str(N), "--with-log-prob",
                       "--approx", "--n-samples", str(SERVE_SAMPLES), "--batch-size",
                       str(SERVE_BATCH), "--device", "cuda"])
    sample_launches = counts()
    check(np.isfinite(out["samples"]).all() and np.isfinite(out["log_q"]).all(),
          "(c) non-finite samples or log q")
    check(sample_launches["edge_tangent"] > 0, f"(c) launches {sample_launches}")
    print(f"[jax-ckpt] (c) sample --ema (adaptive Dopri5, bfloat16, Hutchinson): "
          f"{SERVE_SAMPLES} samples, all finite, mean log q {float(out['log_q'].mean()):.4f}; "
          f"first batch of {SERVE_BATCH} {out['first_batch_seconds']:.2f} s, steady "
          f"{out['steady_per_second']:.1f} samples/s; {sample_launches['edge_tangent']} edge "
          f"launches; phase {time.perf_counter() - start:.1f} s; on {card}", flush=True)
    return dict(edge=dict(ms=ms, plain_ms=plain_ms, abs_err=abs_err, **b),
                launches=launched["params"]["edge_tangent"], read_s=read_s, rate=rate)


def estimator_stats(estimates: torch.Tensor, exact: torch.Tensor) -> dict:
    """``estimates [draws, B]`` of a trace against ``exact [B]``: the mean
    over samples of each sample's sd over the draws, the mean |bias|, and
    the largest |bias| in standard errors of the mean of the draws."""
    est, exact = estimates.double(), exact.double()
    sd = est.std(dim=0)
    bias = est.mean(dim=0) - exact
    z = bias.abs() / (sd / math.sqrt(est.shape[0])).clamp_min(1e-300)
    return dict(sd=sd.mean().item(), bias=bias.abs().mean().item(), max_z=z.max().item())


def trace_kernel_events(path) -> int:
    """Device kernel events (``"cat": "kernel"``) in a Chrome trace that
    ``torch.profiler`` exported; raises if the file is not JSON."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")


def max_gap(a, b) -> float:
    """Largest |a - b| over two equal-length lists of tensors."""
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def serving_argv(fixture: Path, expected: dict, frames, device, work: Path) -> list:
    """``score``'s command line serving the JAX fixture with its config and
    overrides on its ``frames`` (an index of ``frames.npy``, saved under
    ``work``)."""
    import numpy as np

    work.mkdir(parents=True, exist_ok=True)
    np.save(work / "frames.npy", np.load(fixture / "frames.npy")[frames])
    return ["--config", str(Path(__file__).resolve().parent / expected["config"]),
            "--checkpoint-dir", str(fixture / "model_checkpoints"), "--features", "arange",
            "--data", str(work / "frames.npy"), "--device", str(device),
            *expected["score_overrides"]]


def serving_cnf(argv: list, device):
    """The CNF ``score`` builds from ``argv``, the zero-CoM flat frames of
    its ``--data`` and their node features."""
    from ecnf_tpu_torch import sample, score

    parser = score.build_parser()
    args = parser.parse_args(argv)
    sample.apply_config(parser, args, argv)
    pos = score.load_positions(args.data)
    n, args.n_nodes, args.dim = pos.shape
    cnf = sample.build_from_args(args, torch.device(device))
    x = torch.from_numpy(pos.reshape(n, -1)).to(device)
    return cnf, x, sample.node_features(args, n, device)


def _options_serving(card: str) -> None:
    """(a) the StableMLP checkpoint of the JAX package: score raw and
    --ema, then Hutch++ on the fixture's draws and chunks of 25."""
    import numpy as np

    from ecnf_tpu_torch import score
    from ecnf_tpu_torch.cnf.sampling import SolveConfig, get_log_prob

    fixture = Path(__file__).resolve().parent / JAX_STABLE_FIXTURE
    expected = json.loads((fixture / "expected.json").read_text())
    n = len(expected["log_p"]["params"])
    argv = serving_argv(fixture, expected, slice(None), "cuda",
                        Path(__file__).resolve().parent / "build" / "options")
    argv += ["--batch-size", str(n)]
    for key, extra in (("params", []), ("ema_params", ["--ema"])):
        zero_counts()
        out = score.main(argv + extra)
        launched = counts()
        rel = rel_err(torch.from_numpy(out["log_p"]).double(),
                      torch.tensor(expected["log_p"][key], dtype=torch.float64))
        print(f"[options] (a) score --config {expected['config']} {' '.join(expected['score_overrides'])} "
              f"{' '.join(extra)} on the StableMLP JAX checkpoint ({n} frames): max rel to JAX's "
              f"log p {rel:.3e} (limit {OPTION_REL:g}); launches {launched}; "
              f"{out['seconds']:.2f} s", flush=True)
        check(rel <= OPTION_REL and np.isfinite(out["log_p"]).all(), f"(a) {key}: rel {rel:.3e}")
        check(not any(launched.values()), f"(a) the StableMLP route launched {launched}")
    cnf, x, feats = serving_cnf(argv, "cuda")
    hpp, chunk = expected["hutchpp"], expected["trace_column_chunk"]
    fixed = dict(use_fixed_step_size=True, method="rk4")
    eps = tuple(torch.from_numpy(np.load(fixture / hpp[k])).cuda() for k in ("sketch", "probes"))
    cases = (
        ("Hutch++ (sketch 2, probes 4, the fixture's draws)", hpp["log_p"], True, eps,
         SolveConfig(**fixed, hutchpp_sketch=hpp["hutchpp_sketch"],
                     hutchinson_probes=hpp["hutchinson_probes"])),
        (f"exact trace in chunks of {chunk['chunk']}", chunk["log_p"], False, None,
         SolveConfig(**fixed, trace_column_chunk=chunk["chunk"])),
    )
    for name, ref, approx, e, cfg in cases:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = get_log_prob(cnf, x, feats, approx=approx, cfg=cfg, eps=e)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rel = rel_err(out.double().cpu(), torch.tensor(ref, dtype=torch.float64))
        print(f"[options] (a) {name}: max rel to JAX's log p {rel:.3e} (limit {OPTION_REL:g}); "
              f"launches {counts()}; {seconds:.2f} s for the {n} frames; on {card}", flush=True)
        check(rel <= OPTION_REL and bool(torch.isfinite(out).all()), f"(a) {name}: rel {rel:.3e}")


def _options_chunks(card: str) -> None:
    """(b) the f32 exact field evaluation at the QM9 flagship width by
    column chunks: peak memory and time, each against chunk None."""
    from ecnf_tpu_torch.ops.divergence import value_and_exact_divergence

    n, units, hidden, blocks, B = 19, (256,) * 4, 32, 5, 64
    cnf = f32_cnf(n, units, hidden, blocks, seed=31)
    x, t, feats = field_inputs(n, B, seed=32)
    basis, offset = cnf.exact_trace_plan()
    field = lambda xb: cnf.apply(xb, t, feats)  # noqa: E731
    ref = None
    with torch.no_grad():
        value_and_exact_divergence(field, x, None, basis, offset)  # warm-up
    for chunk in QM9_CHUNKS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            v, div = value_and_exact_divergence(field, x, chunk, basis, offset)
            end.record()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = start.elapsed_time(end)
        if ref is None:
            ref = div
        rel = rel_err(div, ref)
        print(f"[options] (b) QM9 width (N={n}, {blocks} blocks of {list(units)}, hidden {hidden}), "
              f"f32 exact field evaluation, B={B}, K={basis.shape[0]}, trace_column_chunk={chunk}: "
              f"{ms:.2f} ms (CUDA events), peak device memory {peak:.2f} GB, divergence rel "
              f"{rel:.3e} to chunk None (limit {OPTION_REL:g}); on {card}", flush=True)
        check(rel <= OPTION_REL and bool(torch.isfinite(div).all()), f"(b) chunk {chunk}: rel {rel:.3e}")
        del v, div


def _options_hutchpp(card: str) -> None:
    """(c) Hutch++ (sketch 2, probes 4) against plain Hutchinson (8 probes)
    at one (x, t) at the LJ13 width: sd and bias over the draws against the
    exact trace, and ms per field evaluation."""
    from ecnf_tpu_torch.ops import divergence as div

    n, B = 13, 48
    D = n * 3
    cnf = f32_cnf(n, (128,) * 3, 64, 3, seed=41)
    x, t, feats = field_inputs(n, B, seed=42)
    field = lambda xb: cnf.apply(xb, t, feats)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(43)
    with torch.no_grad():
        exact = div.value_and_exact_divergence(field, x)[1]
        draws = {
            "plain Hutchinson, 8 probes": lambda: torch.randn((HUTCH_PLAIN, B, D), generator=gen,
                                                              device="cuda"),
            "Hutch++, sketch 2 + probes 4": lambda: (
                torch.randn((HUTCH_SKETCH, B, D), generator=gen, device="cuda"),
                torch.randn((HUTCH_RESID, B, D), generator=gen, device="cuda")),
        }
        estimators = {
            "plain Hutchinson, 8 probes": lambda e: div.value_and_multi_probe_hutchinson(field, x, e),
            "Hutch++, sketch 2 + probes 4": lambda e: div.value_and_hutchpp_divergence(field, x, *e),
        }
        for name, draw in draws.items():
            est = torch.stack([estimators[name](draw())[1] for _ in range(HUTCH_DRAWS)])
            stats = estimator_stats(est, exact)
            e = draw()
            ms = cuda_ms(lambda: estimators[name](e), 5)
            print(f"[options] (c) LJ13 width (3 blocks of [128]*3, hidden 64, f32, random weights), "
                  f"B={B}, one (x, t): {name}: over {HUTCH_DRAWS} draws the per-sample sd "
                  f"{stats['sd']:.4f}, mean |bias| {stats['bias']:.4f} (largest {stats['max_z']:.2f} "
                  f"standard errors), exact trace mean {exact.mean().item():.4f}; {ms:.2f} ms a field "
                  f"evaluation (CUDA events); on {card}", flush=True)
            check(bool(torch.isfinite(est).all()) and stats["max_z"] < 6.0,
                  f"(c) {name}: bias {stats['max_z']:.2f} standard errors")
        exact_ms = cuda_ms(lambda: div.value_and_exact_divergence(field, x), 5)
    print(f"[options] (c) the exact trace (D={D} columns) {exact_ms:.2f} ms a field evaluation",
          flush=True)


def _options_remat(card: str) -> None:
    """(d) remat_blocks on the QM9 flagship train step (B=256, bf16,
    microbatch 1): gradients against no remat, peak memory, ms a step."""
    import numpy as np

    from ecnf_tpu_torch.cnf.build import build_cnf
    from ecnf_tpu_torch.training import optim
    from ecnf_tpu_torch.training import state as state_mod

    q = QM9_TRAIN
    B, D = q["batch"], q["n"] * 3
    rng = np.random.default_rng(51)
    data = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).cuda()
    feats = torch.zeros((B, q["n"]), dtype=torch.int64, device="cuda")
    gen = torch.Generator().manual_seed(52)
    x0 = torch.randn((B, q["n"], 3), generator=gen)
    x0 = (x0 - x0.mean(dim=1, keepdim=True)).reshape(B, D).cuda()
    t = torch.rand((B,), generator=gen).cuda()
    grads, params = {}, None
    for mode in REMAT_MODES:
        cnf = build_cnf(n_frames=q["n"], dim=3, sigma_min=1e-6, base_scale=2.0,
                        n_blocks_egnn=q["blocks"], mlp_units=q["units"],
                        n_invariant_feat_hidden=q["hidden"], time_embedding_dim=8, n_features=1,
                        compute_dtype="bfloat16", remat_blocks=mode, device="cuda",
                        generator=torch.Generator().manual_seed(0))
        if params is None:
            params = {k: v.detach().clone() for k, v in cnf.field.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g, loss = state_mod.loss_and_grads(cnf, params, data, feats, x0=x0, t=t)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        grads[mode] = g + [loss]
        opt = optim.build_optimizer(1e-4)
        st = state_mod.init_training_state(cnf, opt, torch.Generator(device="cuda").manual_seed(0),
                                           use_ema=True)
        update = state_mod.make_update_fn(cnf, opt, use_ema=True)
        box = {"st": st}

        def step():
            box["st"], _ = update(box["st"], data, feats)

        ms = cuda_ms(step, 5)
        gap = max_gap(grads[mode], grads[False])
        print(f"[options] (d) QM9 flagship train step (B={B}, {q['blocks']} blocks of "
              f"{list(q['units'])}, bf16, microbatch 1, EMA), remat_blocks={mode!r}: {ms:.2f} ms a "
              f"step (CUDA events), peak device memory of the gradient {peak:.2f} GB, gradient and "
              f"loss max |diff| to no remat {gap:.3e} (limit {REMAT_ATOL:.0e}); on {card}", flush=True)
        check(gap <= REMAT_ATOL, f"(d) remat_blocks={mode!r}: gradient gap {gap:.3e}")
        del cnf, st, box, update
        torch.cuda.empty_cache()


def _options_precision(card: str) -> None:
    """(e) training.precision on the LJ13 f32 structured solve (rk4 0.05,
    B=48, the edge kernel's launches counted): log q against float32."""
    from ecnf_tpu_torch.cnf.sampling import SolveConfig, sample_and_log_prob_cnf
    from ecnf_tpu_torch.training.setup import set_matmul_precision

    cnf = f32_cnf(13, (128,) * 3, 64, 3, seed=61)
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(62))
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    ref = None
    try:
        for name in PRECISIONS:
            set_matmul_precision(name)
            out = {}

            def solve():
                out["log_q"] = sample_and_log_prob_cnf(cnf, 48, feats, cfg=cfg, x0=x0)[1]

            zero_counts()
            solve()
            launched = counts()["edge_tangent"]
            ms = cuda_ms(solve, 1)
            log_q = out["log_q"]
            if ref is None:
                ref = log_q
            gap = (log_q - ref).abs().max().item()
            print(f"[options] (e) training.precision={name} (torch "
                  f"{torch.get_float32_matmul_precision()}, allow_tf32="
                  f"{torch.backends.cuda.matmul.allow_tf32}): LJ13 f32 structured rk4 solve, B=48, "
                  f"{launched} edge launches, {ms:.1f} ms a solve (CUDA events), log q max |diff| to "
                  f"float32 {gap:.3e} (mean |log q| {log_q.abs().mean().item():.3f}); on {card}",
                  flush=True)
            check(bool(torch.isfinite(log_q).all()) and launched == RK4_LAUNCHES,
                  f"(e) {name}: launches {launched}")
    finally:
        set_matmul_precision("float32")
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "(e) precision not restored")


def _options_program(card: str) -> None:
    """(f) the DW4 program at dw4.yaml's width, 2 iterations, with
    stable_mlp, trace_column_chunk=2, profile_dir and precision
    tensorfloat32; then use_64_bit refused."""
    from ecnf_tpu_torch.examples import common, dw4
    from ecnf_tpu_torch.targets import data
    from ecnf_tpu_torch.training import setup

    root = Path(__file__).resolve().parent / "build"
    data_dir, run_dir = root / "dw4" / "data", root / "dw4_options"
    shutil.rmtree(run_dir, ignore_errors=True)
    if not (data_dir / data.DW4_CACHE).exists():
        data._generate_dw4_data(data_dir / data.DW4_CACHE, "cuda")
    profile = run_dir / "profile"
    cuts = list(DW4_OPTION_CUTS) + [f"training.save_dir={run_dir}", f"training.profile_dir={profile}"]
    cfg = common.load_experiment_config(str(common.CONFIG_DIR / "dw4.yaml"), False, cuts, ())
    calls = []
    orig = _timed(setup, "evaluate", calls, cuda_events=False)
    zero_counts()
    t0 = time.perf_counter()
    try:
        logger, _ = dw4.run(cfg, device="cuda", data_dir=data_dir)
    finally:
        setup.evaluate = orig
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
    wall = time.perf_counter() - t0
    launched = counts()
    h = logger.history
    trace = profile / "trace.json"
    kernels = trace_kernel_events(trace) if trace.exists() else 0
    print(f"[options] (f) dw4.yaml with {' '.join(cuts)}: iterations {sorted(set(h['iteration']))}, "
          f"{len(h['loss'])} losses {h['loss'][0]:.4f} .. {h['loss'][-1]:.4f}, test_log_lik "
          f"{', '.join(f'{v:.4f}' for v in h['test_log_lik'])}, eval_ode_steps "
          f"{', '.join(f'{v:.1f}' for v in h['eval_ode_steps'])}; seconds per evaluation "
          f"{', '.join(f'{v:.2f}' for v in calls)}; precision during the run {precision}; "
          f"launches {launched}; {trace.name}: {trace.stat().st_size if trace.exists() else 0} "
          f"bytes, {kernels} CUDA kernel events; {wall:.1f} s wall; on {card}", flush=True)
    check(precision == "high", f"(f) training.precision=tensorfloat32 gave {precision}")
    check(len(h["loss"]) == 2 * DW4_STEPS_PER_EPOCH and all(math.isfinite(v) for v in h["loss"]),
          f"(f) losses {h['loss']}")
    check(len(h["test_log_lik"]) == 1 and all(math.isfinite(v) for v in h["test_log_lik"]),
          f"(f) test_log_lik {h['test_log_lik']}")
    check(kernels > 0, f"(f) the trace {trace} holds no CUDA kernel events")
    check(not any(launched.values()), f"(f) the StableMLP program launched {launched}")
    refused = common.load_experiment_config(str(common.CONFIG_DIR / "dw4.yaml"), False,
                                            cuts + ["training.use_64_bit=true"], ())
    try:
        dw4.run(refused, device="cuda", data_dir=data_dir)
    except NotImplementedError as e:
        print(f"[options] (f) training.use_64_bit=true refused: {str(e)[:160]}..", flush=True)
        check("ode.py:237" in str(e), f"(f) the refusal gives no reason: {e}")
    else:
        check(False, "(f) training.use_64_bit=true ran")


def phase_options(card: str) -> None:
    """Phase 16: the options `setup_training` once refused, and Hutch++."""
    start = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest", "phase 16 needs precision highest")
    for part in (_options_serving, _options_chunks, _options_hutchpp, _options_remat,
                 _options_precision, _options_program):
        t0 = time.perf_counter()
        part(card)
        print(f"[options] {part.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[options] phase {time.perf_counter() - start:.1f} s; on {card}", flush=True)


def _dist_flagship(card: str, mesh) -> None:
    """(b) three QM9 flagship updates with the mesh against three without,
    from the same weights and injected x0 and t."""
    import numpy as np
    import torch.distributed as dist

    from ecnf_tpu_torch.parallel.mesh import replicate
    from ecnf_tpu_torch.training import optim
    from ecnf_tpu_torch.training import state as state_mod

    q = QM9_TRAIN
    B, D = q["batch"], q["n"] * 3
    cnf = _train_cnf(q, "cuda", cdt="bfloat16", sigma_min=1e-6, base_scale=2.0)
    weights = {k: v.clone() for k, v in cnf.field.state_dict().items()}
    rng = np.random.default_rng(17)
    as_card = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    steps = [(as_card(rng.normal(size=(B, D))),
              cnf.sample_base((B,), noise=as_card(rng.normal(size=(B, D)))),
              as_card(rng.uniform(size=(B,)))) for _ in range(DIST_STEPS)]
    feats = torch.zeros((B, q["n"]), dtype=torch.int64, device="cuda")
    opt = optim.build_optimizer(1e-4)
    runs = {}
    for name, m in (("no mesh", None), ("mesh", mesh), ("no mesh, again", None)):
        cnf.field.load_state_dict(weights)
        st = replicate(state_mod.init_training_state(
            cnf, opt, torch.Generator(device="cuda").manual_seed(0), use_ema=True), m)
        update = state_mod.make_update_fn(cnf, opt, use_ema=True, mesh=m, microbatch=4)
        events = []
        for x, x0, t in steps:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            st, info = update(st, x, feats, x0=x0, t=t)
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        runs[name] = (st, info, [a.elapsed_time(b) for a, b in events])
    (ref, ref_info, ref_ms), (st, info, ms) = runs["no mesh"], runs["mesh"]
    control, _, control_ms = runs["no mesh, again"]

    def equal(a, b):
        return all(torch.equal(a.params[k], b.params[k]) and
                   torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.params)

    n_params = sum(p.numel() for p in ref.params.values())
    bucket = torch.randn(n_params + 1, device="cuda")
    dist.all_reduce(bucket)
    torch.cuda.synchronize()
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    for _ in range(DIST_ALLREDUCE_REPS):
        dist.all_reduce(bucket)
    ev[1].record()
    torch.cuda.synchronize()
    ar_ms = ev[0].elapsed_time(ev[1]) / DIST_ALLREDUCE_REPS
    fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)
    print(f"[dist] (b) QM9 flagship step (B={B}, N={q['n']}, {q['blocks']} blocks of "
          f"{list(q['units'])}, bf16, EMA, Adam 1e-4, microbatch 4), {DIST_STEPS} updates on "
          f"injected x0 and t, deterministic algorithms: ms per step by CUDA events without the "
          f"mesh {fmt(ref_ms)}, with the world-1 mesh {fmt(ms)}, without it again "
          f"{fmt(control_ms)}; losses {ref_info['loss'].item():.6f} "
          f"/ {info['loss'].item():.6f}; parameters and EMA bit-equal: {equal(st, ref)} (control, "
          f"the run without the mesh repeated: {equal(control, ref)}); the gradient all-reduce: "
          f"one f32 bucket of {n_params + 1} values, {4 * (n_params + 1)} bytes, "
          f"{ar_ms * 1e3:.1f} us by CUDA events over {DIST_ALLREDUCE_REPS}; on {card}", flush=True)
    check(equal(control, ref), "(b) the step without the mesh is not repeatable")
    check(equal(st, ref), "(b) the world-1 mesh step differs from the step without it")


def _dist_score(card: str, edge_launches: int) -> None:
    """(c) ``score`` of the JAX fixture through the world-1 mesh."""
    import numpy as np

    from ecnf_tpu_torch import score

    fixture = Path(__file__).resolve().parent / JAX_FIXTURE
    expected = json.loads((fixture / "expected.json").read_text())
    argv = ["--config", str(Path(__file__).resolve().parent / expected["config"]),
            "--checkpoint-dir", str(fixture / "model_checkpoints"), "--features", "arange",
            "--data", str(fixture / "frames.npy"), "--batch-size", str(SERVE_EDGE["B"]),
            "--device", "cuda", *expected["score_overrides"]]
    zero_counts()
    out = score.main(argv)
    launched = counts()
    ref = np.asarray(expected["log_p"]["params"])
    rel = float(np.abs(out["log_p"] - ref).max() / np.abs(ref).max())
    print(f"[dist] (c) score of {JAX_FIXTURE} through the world-1 mesh: max rel {rel:.3e} of "
          f"JAX's log p (limit {LOGQ_LIMIT:g}); {launched['edge_tangent']} edge launches (phase "
          f"15: {edge_launches}); {out['first_batch_seconds']:.3f} s; on {card}", flush=True)
    check(rel <= LOGQ_LIMIT and np.isfinite(out["log_p"]).all(), f"(c) rel {rel:.3e}")
    check(launched["edge_tangent"] == edge_launches and launched["egcl"] == 0
          and launched["fused_trace"] == 0, f"(c) launches {launched}")


def _dist_trace(card: str, mesh) -> None:
    """(d) the sharded exact trace on the ALDP fixture's field at world 1."""
    from ecnf_tpu_torch.ops.divergence import (
        sharded_value_and_exact_divergence,
        value_and_exact_divergence,
    )

    fixture = Path(__file__).resolve().parent / JAX_FIXTURE
    expected = json.loads((fixture / "expected.json").read_text())
    work = Path(__file__).resolve().parent / "build" / "dist"
    cnf, x, feats = serving_cnf(serving_argv(fixture, expected, slice(None), "cuda", work), "cuda")
    basis, offset = cnf.exact_trace_plan()

    def f(xb):
        return cnf.apply(xb, torch.full((xb.shape[0],), DIST_FIELD_T, device="cuda"), feats)

    with torch.no_grad():
        out = {}
        for name, fn in (("sharded", lambda: sharded_value_and_exact_divergence(
                             f, x, mesh, basis=basis, trace_offset=offset)),
                         ("unsharded", lambda: value_and_exact_divergence(
                             f, x, basis=basis, trace_offset=offset))):
            fn()
            out[name] = (fn(), cuda_ms(fn, 3))
    (v, div), ms = out["sharded"]
    (v_ref, div_ref), ref_ms = out["unsharded"]
    rel = max(rel_err(v, v_ref), rel_err(div, div_ref))
    print(f"[dist] (d) sharded_value_and_exact_divergence at world 1 on the ALDP fixture's field "
          f"(B={x.shape[0]}, {basis.shape[0]} zero-CoM columns, f32, t={DIST_FIELD_T}): max rel "
          f"{rel:.3e} of value_and_exact_divergence (limit {DIST_TRACE_LIMIT:g}); {ms:.2f} ms "
          f"against {ref_ms:.2f} ms; on {card}", flush=True)
    check(rel <= DIST_TRACE_LIMIT, f"(d) rel {rel:.3e}")


def distributed_child(edge_launches: int) -> None:
    """Phase 17's child: the port's world-size-1 NCCL path."""
    import torch.distributed as dist

    from ecnf_tpu_torch.parallel import distributed, mesh as pmesh
    from ecnf_tpu_torch.parallel.dryrun import dryrun_multichip

    start = time.perf_counter()
    check(torch.cuda.is_available(), "phase 17 needs a CUDA device")
    card = card_line()
    check(distributed.maybe_initialize_distributed(), "(a) no process group was started")
    backend, world = dist.get_backend(), dist.get_world_size()
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    print(f"[dist] (a) maybe_initialize_distributed: backend {backend}, world size {world}, "
          f"rank {dist.get_rank()} on cuda:{torch.cuda.current_device()}, NCCL {nccl}; "
          f"{time.perf_counter() - start:.1f} s; on {card}", flush=True)
    check(backend == "nccl" and world == 1, f"(a) backend {backend}, world {world}")
    mesh = pmesh.get_mesh()
    check(mesh is not None and pmesh.axis_size(mesh) == 1, f"(a) mesh {mesh}")
    torch.use_deterministic_algorithms(True)
    _dist_flagship(card, mesh)
    torch.use_deterministic_algorithms(False)
    _dist_score(card, edge_launches)
    _dist_trace(card, mesh)
    t0 = time.perf_counter()
    zero_counts()
    dryrun_multichip(1)
    print(f"[dist] (e) dryrun_multichip(1) on the card: {time.perf_counter() - t0:.1f} s, "
          f"launches {counts()}; phase 17's child {time.perf_counter() - start:.1f} s; on {card}",
          flush=True)
    dist.destroy_process_group()


def phase_distributed(card: str, edge_launches: int) -> None:
    """Phase 17: `distributed_child` in a process started as a launcher
    starts one, on a free local port."""
    import socket

    start = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="1",
               PROCESS_ID="0", CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--distributed-phase", str(edge_launches)],
        env=env, capture_output=True, text=True, timeout=DIST_TIMEOUT,
        cwd=Path(__file__).resolve().parent,
    )
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, f"phase 17's child exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    print(f"[dist] phase {time.perf_counter() - start:.1f} s; on {card}", flush=True)


def _counted_solve(sampling, cnf, batch, feats, cfg, x0) -> tuple:
    """The count of one `sample_and_log_prob_cnf` solve, in a call of its
    own, and the kernel launches it made."""
    from ecnf_tpu_torch.ops import flops

    zero_counts()
    count = flops.count_fn_flops(sampling.sample_and_log_prob_cnf, cnf, batch, feats, cfg=cfg, x0=x0)
    return count, counts()


def _flop_line(count) -> str:
    return (f"{count.total / 1e12:.4f} TFLOP ({count.bf16 / 1e9:.3f} GFLOP bf16, "
            f"{count.f32 / 1e9:.3f} GFLOP f32)")


def phase_flops(sample, sampling, fused_trace, et, card: str, train: dict) -> None:
    """Phase 18: `ops.flops.count_fn_flops` on the main paths, each count in
    a call of its own: each kernel route against its plain route, and the
    MFU of the train step phase 10 timed."""
    from ecnf_tpu_torch.ops import flops

    start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    check(kind in flops.PEAKS, f"no published peak for {kind}: MFU is not defined")
    peaks = flops.PEAKS[kind]
    print(f"[flops] peaks of {kind}: bf16 {peaks['bf16'] / 1e12:g} TFLOP/s, f32 "
          f"{flops.f32_peak(peaks) / 1e12:.1f} TFLOP/s (matmul precision "
          f"{torch.get_float32_matmul_precision()}); on {card}", flush=True)

    def report(name, kernel, plain):
        print(f"[flops] {name}: kernel route {_flop_line(kernel)}, plain route "
              f"{_flop_line(plain)}, equal: {kernel == plain}; on {card}", flush=True)
        check(kernel == plain, f"{name}: kernel route {kernel} != plain route {plain}")

    # (a) the structured rk4 serving solve through each edge-tangent design
    # (the route rule takes the resident one at K=36; a threshold past K
    # forces the other), (b) its fused solve.
    args = sample.build_parser().parse_args(LJ13_ARGS)
    cnf = sample.build_from_args(args, torch.device("cuda"))
    feats = torch.zeros((48, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((48,), generator=torch.Generator().manual_seed(4))
    cfg = sampling.SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    resident = et.edge_tangent_resident.launch_count
    kernel, launched = _counted_solve(sampling, cnf, 48, feats, cfg, x0)
    resident = et.edge_tangent_resident.launch_count - resident
    threshold = et.RESIDENT_MIN_COLUMNS
    et.RESIDENT_MIN_COLUMNS = LJ13_EDGE["K"] + 1
    try:
        blocks, launched_b = _counted_solve(sampling, cnf, 48, feats, cfg, x0)
    finally:
        et.RESIDENT_MIN_COLUMNS = threshold
    plain, launched_p = _counted_solve(
        sampling, cnf, 48, feats, dataclasses.replace(cfg, structured_tangent_kernel=False), x0)
    check(launched["edge_tangent"] == launched_b["edge_tangent"] == RK4_LAUNCHES
          and launched_p["edge_tangent"] == 0, f"(a) launches {launched} / {launched_b} / {launched_p}")
    report(f"(a) lj13 rk4 B=48 structured, bf16, {resident} of {RK4_LAUNCHES} edge launches resident",
           kernel, plain)
    report("(a) the same through the blocks design", blocks, plain)

    def fused_plain(x, t, f, weights=None):
        return fused_trace.egnn_value_and_div_fused(cnf.field, x, t, f, weights, use_kernel=False)

    fused_cfg = dataclasses.replace(cfg, fused_trace=True)
    kernel, launched = _counted_solve(sampling, cnf, 48, feats, fused_cfg, x0)
    plain, launched_p = _counted_solve(
        sampling, cnf._replace(fused_value_and_div=fused_plain), 48, feats, fused_cfg, x0)
    check(launched["fused_trace"] == FUSED_LAUNCHES and launched_p["fused_trace"] == 0,
          f"(b) launches {launched} / {launched_p}")
    report("(b) lj13 rk4 B=48 fused, f32", kernel, plain)

    # The edge kernel at a width it takes zero-padded (`--local` DW4's 16):
    # the padding adds no FLOP.
    pad = edge_inputs(K=6, B=4, N=4, U=16, L=3, dtype=torch.bfloat16, seed=19)
    kernel = flops.count_fn_flops(et.edge_tangent, **pad)
    plain = flops.count_fn_flops(et.edge_tangent_reference, **pad)
    print(f"[flops] edge kernel at U=16 (launched at 32, zero-padded): kernel "
          f"{_flop_line(kernel)}, plain {_flop_line(plain)}, equal: {kernel == plain}", flush=True)
    check(kernel == plain and kernel.total > 0, f"padded edge count {kernel} != {plain}")

    # (c) phase 10's QM9 flagship step, counted there on one extra step.
    for microbatch, r in train.items():
        print(f"[flops] (c) QM9 flagship train step, microbatch {microbatch}: {_flop_line(r['count'])} "
              f"a step; over phase 10's median {r['ms']:.3f} ms: {r['tflops']:.2f} TFLOP/s, MFU "
              f"{r['mfu']:.5f}; on {card}", flush=True)

    # (d) phase 11's (a) solve: adaptive, so the count is flagged and has no MFU.
    cnf = f32_cnf(13, (128,) * 3, 64, 3, seed=12)
    feats = torch.zeros((EVAL_B, 13), dtype=torch.int64, device="cuda")
    x0 = cnf.sample_base((EVAL_B,), generator=torch.Generator().manual_seed(13))
    with SolveRecorder(sampling) as rec:
        count, launched = _counted_solve(sampling, cnf, EVAL_B, feats, sampling.SolveConfig(), x0)
    row = rec.rows()[0]
    mfu = flops.mfu(count, row["ms"] / 1e3, kind)
    print(f"[flops] (d) lj13 adaptive evaluation solve B={EVAL_B}, f32: {_flop_line(count)} over "
          f"{row['attempts']} attempts ({row['evals']} field evaluations, {launched['edge_tangent']} "
          f"edge launches), has_while {count.has_while}, MFU {mfu}; on {card}", flush=True)
    check(count.has_while and mfu is None and count.total > 0, f"(d) adaptive count {count}, MFU {mfu}")
    print(f"[flops] phase {time.perf_counter() - start:.1f} s; on {card}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a card")
    from ecnf_tpu_torch import sample, score
    from ecnf_tpu_torch.cnf import sampling
    from ecnf_tpu_torch.targets import energies
    from ecnf_tpu_torch.training import setup
    from ecnf_tpu_torch.ops import cuda_build, egcl, fused_trace, ode
    from ecnf_tpu_torch.ops import edge_tangent as et

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(cuda_build.build_library, KERNELS))
    for name, (path, seconds, log) in zip(KERNELS, builds):
        hmma = hmma_count(path)
        print(f"[build] {path.name} in {seconds:.1f}s, {hmma} HMMA/HGMMA instructions", flush=True)
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        check(hmma > 0, f"{name}: no tensor-core instructions")

    table = phase_kernels(card)
    serving = {row[0]: serve_row(row, card) for row in SERVE_ROWS}
    phase_f32_solves(sample, sampling)
    egcl_launches = phase_egcl_solve(egcl, ode)
    train = phase_train(card)
    phase_evaluation(sampling, score, setup, energies, et, fused_trace, card)
    phase_training_program(et, card)
    phase_qm9_program(et, card)
    phase_aldp_program(et, card)
    served = phase_jax_checkpoint(et, card)
    phase_options(card)
    phase_distributed(card, served["launches"])
    phase_flops(sample, sampling, fused_trace, et, card, train)

    # Per kernel, its main-path shapes: the LJ13 structured solve's bf16
    # edge chain (one launch), the LJ13 B=48 EGNN forward (three launches),
    # one LJ13 fused evaluation and the QM9 Hutchinson primal edge chain
    # (one launch; it replaces no Pallas kernel), with the launches of the
    # serving table's LJ13 rk4, fused and QM9 rows and of phase 7.  No
    # single PyTorch call computes any of these functions, so library_ms is
    # null.
    bf16, f32 = torch.bfloat16, torch.float32
    rows = (
        ("edge_tangent", "edge_tangent.cu", "tangent_kernel.py:374",
         serving["lj13 rk4"]["edge_tangent"], table[("edge_tangent", "lj13", bf16)]),
        ("egcl_forward", "egcl.cu", "attic/egcl_kernel.py:200", egcl_launches, table[("egcl", "lj13", f32)]),
        ("fused_trace", "fused_trace.cu", "attic/trace_kernel.py:171",
         serving["lj13 rk4 fused"]["fused_trace"], table[("fused_trace", "lj13", f32)]),
        ("edge_primal", "edge_primal.cu", None, serving["qm9 rk4 hutchinson"]["edge_primal"],
         table[("edge_primal", "qm9_hutch", bf16)]),
    )
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"ecnf_tpu_torch/csrc/{source}",
            "replaces": f"ecnf_tpu/ops/pallas/{replaces}" if replaces else None,
            "launches": n,
            "max_abs_err": r["abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for name, source, replaces, n, r in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-phase"]:
        distributed_child(int(sys.argv[2]))
    else:
        main()
    sys.exit(0)
