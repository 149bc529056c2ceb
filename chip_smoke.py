#!/usr/bin/env python3
"""Drive linna_tpu_torch on one CUDA card (an H100) and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):

1. Device: name, capability (must be 9.0), ``nvidia-smi`` name and power
   limit, and which chain store the run uses (HDF5, or npz without h5py).
2. Build: compile ``linna_tpu_torch/ops/csrc/fused_mlp.cu`` with nvcc for
   sm_90a and print the seconds and the compiler's register/shared-memory
   report; then ``ops/csrc/adamw.cu``, the trainer's AdamW kernel.
3. Kernels against their plain PyTorch versions at the DES-Y1-3x2pt width
   (27 -> 457, hidden 1000) for B in {1, 37, 128, 200, 256, 4096} (200
   leaves a ragged last cluster of ``fused_log_prob`` and a ragged row tile
   of ``fused_apply``): ``fused_apply`` against the plain trunk,
   ``fused_log_prob`` against the plain ``make_log_prob`` composition (mixed
   gauss/flat priors; log10 lanes with non-positive rows that must be -inf
   in both; ypositive), both gradients, and the device time per launch with
   each kernel's launch shape and its bounds: ``fused_apply`` at 128, 256
   and 4096 rows (one cooperative launch of 64 x 64 output tiles),
   ``fused_log_prob`` at the sampler's 128 and 256 (its cluster design at
   this width: clusters of 8 blocks, and how many the card holds at once).
   Both kernels also against their plain versions at the LSST-Y10 width
   (40 -> 1560): ``fused_apply`` at 128, 256 and 4096 rows,
   ``fused_log_prob`` at 1, 37, 128 and 256 (every row count 13b launches
   it at) in its tiled design (one cooperative launch of tensor-core tiles;
   a cluster block there holds 8 walkers, not the 16 the cluster design
   asks for: ops/fused.py, log_prob_design); both timed there too
   (``fused_log_prob`` at 128 and 256), with their bounds at that width.
   Each kernel's time counts its own device events in torch.profiler and
   fails unless it saw one per launch (shown once on a deliberate
   mismatch).  The same 16 rows inside 16-, 128- and 256-row batches must
   give the same ``fused_log_prob`` values bit for bit at both widths (the
   plain composition's shown beside them).
4. The sampling stage of one ``ml_sampler_core`` iteration on a DES-width
   iteration directory written with the port's own writers:
   ``retrieve_model`` -> ``make_log_prob(use_fused=True, temperature=16)``
   -> ``run_ensemble(method="zeus", nwalkers=256)`` for 300 steps ->
   ``read_chain_and_cut`` (and once more with ``walkercut=True``, the
   numpy k-means walker cut) -> the posterior-mean prediction through
   ``retrieve_model_wrapper``.  The kernels' launch counters are zeroed just
   before and read just after: ``fused_log_prob`` must have launched and the
   plain versions must not have run.  ``fused_apply`` is not on this path
   (as in the JAX package); phase 3 alone launches it.
5. Training at the DES width: iteration 0 of a
   pipeline with 10000 training and 500 validation points on a flat Latin
   hypercube over phase 4's priors, the theory a smooth synthetic function
   from a seed, trained by ``train_emulator`` as the README's K=4
   ``EnsembleTrainer`` for ``TRAIN_EPOCHS`` epochs (the paper's 4500 cut to
   fit the time limit).  Every member's best val loss must be finite and
   below 1/10 of its initial weights', and every artifact must exist.  The
   trained ensemble is then sampled (zeus, 256 walkers, T^2 = 16), trained
   member 0's ``make_log_prob(use_fused=True)`` is held against the plain
   composition at the chain's last positions (one launch, no plain call),
   and the canonical ``ml_sampler_core`` drive (ndim 3, 2 iterations, zeus,
   ``use_fused``) runs on the card.  A 10-epoch chunk is timed and another
   traced: ms per epoch, rows per second, launches per epoch, the device's
   busy share and the host's time by op.  The kernels' counts are zeroed
   before the phase and read after it: ``fused_log_prob`` must have
   launched.
6. The gradient samplers and emcee at the DES width on phase 4's single
   emulator with ``use_fused=True`` at T = 1: the per-walker gradient
   through ``fused_log_prob`` (one launch; the backward recomputes the plain
   composition) against the plain gradient at 256 positions, log10 lanes'
   -inf rows included (zero, not NaN); then ``run_ensemble`` with the MAP
   search and 100 NUTS samples, 20 HMC samples, and 300 emcee steps at 256
   walkers: s/100 samples, launches per sample (31 per NUTS sample at depth
   5), mean acceptance, and the device busy share of a traced NUTS chunk.
   6b: ``composition_grad`` (the K-member composition's value and input
   gradient in one kernel) at K = 1 and 2 and 1, 128 and 256 rows against
   the composition's float64 autograd at the card tests' tolerances, its
   device ms and 3xTF32 bound; then NUTS at K = 2 through
   ``run_ensemble`` with the counters zeroed before it and read after
   (the kernel launches, no plain version runs), and a traced chunk at 31
   launches a sample.  Every path's counts include ``composition_grad``,
   which launches where a path asks the float32 Gaussian composition for
   a gradient on the card (phase 7's NUTS iteration, 13a, 13c, 15b) and
   nowhere else.
7. ``python -m linna_tpu_torch.driver zeus None <yaml> examples`` as a
   subprocess on the card, the yaml being ``examples/des_synthetic.yaml``
   cut to depth (two iterations, zeus then nuts at T = 4 then 1,
   ``DRIVER_EPOCHS`` epochs, the convergence keys loosened so that each
   iteration's sampler stops at its second convergence check, 200 steps;
   each cut printed), on inputs written with
   ``examples/des_theory.py``: every artifact, the chain stores,
   ``precond.npz``, ``time.npy``, bfloat16 training, and the posterior mean's
   offsets from ``EXACT_POSTERIOR.json`` (reported, not gated).
8. The pre-model and bf16 inference at the DES width.  8a: one
   ``ml_sampler_core`` iteration on phase 5's seeded theory with
   ``linearmodel: {norder: 2}``, K=2 trained in bfloat16 for
   ``PREMODEL_EPOCHS`` epochs with ``use_fused``, zeus at T = 1 stopped at
   its second tau check (200 steps): ``linear_model.npz`` against a fit of
   the same rows (its seconds and traced host memory), each member's
   learning, ``retrieve_model_wrapper`` against the network plus the
   pre-model at 256 rows, and 0 launches of both kernels (an ensemble with
   a pre-model takes the composition, as in JAX).  8b: member 0 with its
   pre-model: per-walker gradients, the MAP search and 20 NUTS samples at
   256 walkers, and a finite, symmetric Hessian at the MAP point.  8c:
   phase 5's trained K=4 ensemble and its member 0 in bfloat16 against
   float32 at 256 and 4096 positions of phase 5's chain (float32 out, the
   same -inf rows, relative error within ``BF16_RTOL``), each call's
   device and call ms, zeus for 100 steps in each type for K=1 and K=4,
   and ``use_fused`` refusing ``compute_dtype``.
9. The multi-process layer on the one card.  9a: a one-rank nccl group:
   ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` of CUDA
   tensors, and emcee for ``MP_EMCEE_STEPS`` steps through
   ``fused_log_prob`` bit for bit the run without a group.  9b: ``python -m
   linna_tpu_torch.launch`` as two ranks sharing the card through gloo (nccl
   refuses two ranks on one device) on ``des_synthetic.yaml`` cut to one
   iteration at K = ``MP_ENSEMBLE`` (ens 2 x data 1), ``MP_EPOCHS``
   epochs, zeus to its second tau check: rank 1 writes nothing under the
   run directory (Python audit hooks), and the stored log-probs equal the
   one-process likelihood's.  9c: two ranks (``chip_smoke.py
   --data-parallel-rank``) against one rank in this process: K=1 training
   on phase 5's rows over two data ranks (one step's gradient, the best
   checkpoint after one epoch, and the best val loss after the deepest of
   ``DP_DEPTHS``), emcee and ``DP_NUTS`` NUTS samples sharded over the
   walkers through ``fused_log_prob`` (one rank's chain bit for bit where a
   row's result does not depend on the rows beside it, which emcee's must
   not on a card; else emcee within ``RTOL``/``ATOL`` at every sample, and
   NUTS's first sample and moments), launches per rank, and the census.
10. The rest of the port at the DES width, on phase 5's 10,000 / 500
   seeded rows.  10a: one tensor-parallel epoch (``parallel/dtrain``, batch
   500) as two gloo ranks on the card (data 1 x model 2, the 125-wide trunk
   split 63 + 62) against one rank's whole step: the first step's loss and
   gradient from the same weights (``TP_STEP_RTOL``, ``TP_GRAD_RTOL``), an
   epoch with the same permutation (losses and validation metric within
   ``TP_EPOCH_DRIFT``, the parameters by ``params_apart``), ms a step on
   each side, the census of one step; and a one-rank nccl group's model-1
   step bit for bit the step without a group.  10b: the K=4 ``EnsembleTrainer`` for ``SPEC_EPOCHS``
   epochs with ``speculative_dispatch`` on and off: chunks speculated and
   dropped, equal bit for bit when nothing was dropped, ms an epoch, the
   trainer's phase seconds, and a traced run's busy share in each mode.
   10c: ``make_grad_log_prob`` through ``fused_log_prob`` at 256 walkers
   against the plain gradient (one launch), ``make_hessian_log_prob`` at
   phase 6's MAP point against its preconditioner's Hessian, and the fused
   likelihood's Hessian refused as JAX refuses its kernel's.  10d: one
   ``use_fused`` ``ml_sampler_core`` iteration in a fresh process with a
   cold kernel build directory, warming on and off (the foreground's wait
   for the library, nvcc's seconds, the warm thread's launches), and with a
   broken compiler, which must fail the run.  10e: ``python -m
   linna_tpu_torch.pod_accept --structural`` on the card.
11. The sampler programs at the DES width, 256 walkers, through
   ``fused_log_prob``: for emcee, zeus, HMC and NUTS one chunk replayed
   from CUDA graphs (``samplers/graphs.py``) and one eager from the same
   state and generator state, equal bit for bit (else the largest
   difference within ``PROGRAM_ATOL``) with the same generator state after
   and the same launches counted (the graphs' from the replays), and a
   second chunk of each from its end state the same way; s / 100
   steps, the busy share of a traced chunk of each, graph replays and
   launches a step; zeus's loop iterations a step, which the card ends
   (CUDA while nodes), and its host condition reads (none); the K=4
   ensemble's batched likelihood against a copy of the per-member loop it
   replaced (``K4_RTOL``), and zeus through the loop eager, batched eager
   and batched graphed.  Phases 4-10 sample through the graphs too:
   ``run_ensemble`` replays every unsharded chunk on a card.
12. The training programs (``train_graphs``) at the DES width: one chunk
   replayed from CUDA graphs and one eager from the same parameters, AdamW
   state and member generators, equal bit for bit (losses, metric rows,
   correlations, best value and params, parameters, AdamW state,
   generators): 12a phase 5's rows at K=4 f32, 12b 40,000 rows at
   ``des_synthetic.yaml``'s K=2 bfloat16, 12c K=1 with a norder-2
   pre-model, 12d the range test's 100 steps, 12e ``train`` with a hyper, a
   reinit and a reload planted in speculated chunks; ms an epoch both ways,
   a traced chunk's busy share, replays and kernels an epoch, capture
   seconds, no launch of either likelihood kernel, and one launch of the
   AdamW kernel (``ops/adamw.py``) a minibatch step both ways.  12f: the
   AdamW kernel against its plain version bit for bit over
   ``ADAMW_STEPS`` steps at both widths, K = 2, both first-moment types,
   a member reset on the way; its device time a launch, the plain
   version's (the PyTorch ops it replaced), and its share of the HBM
   roofline.  Phases 5, 7, 8 and 10 train through the graphs too:
   ``_train`` replays every chunk on a card.
13. The user scripts on the card.  13a: ``examples/walkthrough_torch.py``
   (the artifact tree; a finite prediction, Jacobian and gradient).  13b:
   ``bench_full_torch.py`` on the LSST-Y10 class (``examples.lsst_theory``,
   40 -> 1560) cut to depth, each cut printed: two iterations (zeus, then
   NUTS), phase 7's epochs and convergence keys, ``nensemble=1`` and
   ``use_fused=true``, one polish round (``SCRIPT_POLISH``); the counters
   zeroed before the run and read after it, each iteration's from its
   ``mcmc`` record in ``trace.json``: ``fused_log_prob`` must launch on
   both iterations, only at (rows, 40, 1560) shapes phase 3 checked, and
   the plain versions never run; the gate's value printed, not gated at
   this depth.  13c:
   ``examples/nuts_flagship_demo_torch.py`` on 13b's last iteration (ndim
   40, NUTS) at ``DEMO_STEPS``.  13d: ``bench_exact_posterior_torch.py`` on
   the DES class for ``EXACT_STEPS`` steps, its moments against the stored
   ``EXACT_POSTERIOR.json``.
14. The measurement scripts on the card, each ``main`` cut to depth (each
   cut printed, ``bench_cuts``): ``bench_torch.py`` (2 repetitions),
   ``bench_fused_torch.py`` at 128 and 16,384 walkers (1 repetition; every
   count and its half held against the composition first, and its fused
   rows must launch ``fused_log_prob`` with no plain call),
   ``bench_bf16_torch.py`` (1024 walkers and one LSST row),
   ``bench_train_torch.py`` and ``bench_train_profile_torch.py`` (3
   epochs), ``bench_dispatch_torch.py`` (100 epochs) and
   ``bench_allopts_torch.py`` (2 iterations of 500 rows, 100 epochs,
   ``nimp=200``, phase 7's convergence keys: its option artifacts and a
   finite chain; the importance ESS printed, not gated at this depth).  The
   other six launch neither kernel.
15. The JAX package's slow acceptance tier on the card (15a,
   ``tests/_torch_acceptance.py``): the 2-D Gaussian (three annealed
   iterations, each mean within 0.25 and each std within 0.35 sigma of the
   truncated normal's) and the 33-dimensional Gaussian (median mean error
   below 0.7 sigma, the largest below 6.0, median std ratio 0.5-4.0), each
   at its JAX test's budget and seed, every pin enforced (a miss fails the
   phase once 15b and 15c have run).  The flagship configuration's pin
   (median bias below 0.35 sigma at ``seed=11``) is not run here: at its
   budget it flips with the sampler and training seeds in both packages
   (PERF.md §6, ROADMAP Queue 3 item 3); 15b the code cells
   of ``examples/walkthrough_torch.ipynb`` in order in one namespace (the
   marker lines and the artifact tree); 15c ``bench_scaling_torch.py`` cut
   to depth (``SCALING_CUTS``, printed: 5 epochs, ranks 1 and 2 over
   gloo).  Each run's wall, figures and graph replays are printed; neither
   kernel nor its plain version runs (K=2 takes the composition, the rest
   the unfused single emulator).
16. One ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Phase 4's, 6's and 11's weights are random (from a seed); phases 5, 7 and
8 train their own.  Exits nonzero with no result line when no CUDA device is
present.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from linna_tpu_torch.launch import free_port, run_ranks

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, ".chip_smoke")

NDIM, NDATA = 27, 457  # DES-Y1-3x2pt (examples/des_synthetic.yaml)
WIDE = (40, 1560)  # LSST-Y10-6x2pt+N (examples/lsst_synthetic.yaml)
NWALKERS = 256
TEMPERATURE = 16.0  # T^2 of iteration 0 (T = 4)
STEPS = 300
BATCHES = (1, 37, 128, 200, 256, 4096)
# fused_apply at the sampler's batches and at bench.py's 4096 walkers, the
# batch it exists for; fused_log_prob where the sampler calls it
TIMED_ROWS = {"fused_apply": (128, 256, 4096), "fused_log_prob": (128, 256)}
WIDE_ROWS = {"fused_apply": (128, 256, 4096), "fused_log_prob": (128, 256)}
# checked against the plain versions at the LSST width: fused_log_prob at
# every row count 13b's pipeline launches it at (the MAP search's one row,
# zeus's half-ensemble, NUTS's whole one; 13b fails on any other) and at 37
WIDE_CHECK_ROWS = {"fused_apply": (128, 256, 4096), "fused_log_prob": (1, 37, 128, 256)}
REPS = 30
# phase 5: ml_sampler's training set (orchestrator.py:582-583) and ensemble
# (:614), depth cut from 4500 epochs to TRAIN_EPOCHS
NTRAIN, NVAL = 10000, 500
NENSEMBLE = 4
TRAIN_EPOCHS = 300
ENS_STEPS = 100
# phase 6: the gradient samplers and emcee on one emulator
NUTS_STEPS, HMC_STEPS, EMCEE_STEPS = 100, 20, 300
# phase 7: des_synthetic.yaml through the driver, its 1000 epochs cut
DRIVER_EPOCHS = 100
DRIVER_TIMEOUT = 900
# phase 8: the pre-model pipeline (K=2, bf16 training, ml_sampler's 4500
# epochs cut), NUTS through the pre-model, and bf16 inference on phase 5's
# trained ensemble (kept in TRAINED_DIR until then)
PREMODEL_EPOCHS = 300
PREMODEL_ENSEMBLE = 2
PREMODEL_NUTS = 20
BF16_WALKERS = (256, 4096)
BF16_ZEUS_STEPS = 100
# tests/test_compute_dtype.py's tolerance: |lp_bf16 - lp_f32| / max(1, |lp_f32|)
BF16_RTOL = 0.05
# phase 9: the multi-process layer on one card (9a emcee at world size 1,
# 9b the launcher on des_synthetic.yaml at K=4, 9c the data-parallel path)
MP_EMCEE_STEPS = 100
MP_EPOCHS = 50
MP_ENSEMBLE = 4
# 9c trains K=1 to each of these depths (epochs), on one rank and on two
DP_DEPTHS = (1, 5, 20)
DP_NUTS = 20
MP_TIMEOUT = 600
# 9c: two data ranks against one rank: one step's gradient (its largest
# difference over its largest element: float32 sums of other lengths); the
# best checkpoint after one epoch (its predictions' largest and median
# difference over their std: AdamW's normalized steps grow the rounding,
# to 0.017 and 0.0018 on an H100, where rank 1 drawing other permutations
# reads 0.56 and 0.11 at the CPU rehearsal's size); the best val loss after
# the last depth (relative)
DP_GRAD_RTOL = 1e-5
DP_EPOCH1_MAX, DP_EPOCH1_MEDIAN = 0.05, 0.01
DP_TRAIN_RTOL = 1e-2
# 9c: sharded NUTS, whose trajectories part where a row's log-prob and
# gradient depend on the rows beside it: the share of the first sample's
# walkers not within RTOL/ATOL of one rank's (a block taken wrong puts
# every walker apart), and the second half's means over the one-rank
# chain's std (two independent 256-walker chains differ by ~0.1 at 3 sigma)
DP_NUTS_FIRST_APART = 0.1
DP_MEAN_SIGMA = 0.25
TRAINED_DIR = os.path.join(ROOT, ".chip_smoke_trained")
# phase 10: the rest of the port.  10a: tensor-parallel training on phase
# 5's rows (batch 500, AdamW lr 1e-3 from init_sharded(TP_SEED)), two model
# ranks against one.  The first step from the same weights: its loss within
# TP_STEP_RTOL, its gradient within TP_GRAD_RTOL of its largest element
# (float32 sums split over the ranks).  The epoch: the row-parallel sums
# round otherwise, a ReLU whose input is within that rounding of 0 switches,
# and AdamW's normalized steps carry the switch on (this phase on an NVIDIA
# H100 80GB HBM3 at 700 W: the losses equal for 4 steps, 7e-8 apart at the
# 5th, 3.1e-3 at the 11th, 7.3e-3 at most): the losses and the validation
# metric within TP_EPOCH_DRIFT, each parameter within twice the learning
# rate a step (params_apart)
TP_BATCH, TP_LR, TP_SEED = 500, 1e-3, 3
TP_STEP_RTOL, TP_GRAD_RTOL = 1e-6, 1e-5
TP_EPOCH_DRIFT = 5e-2
# 10b: speculative dispatch on and off at phase 5's shape (K=4)
SPEC_EPOCHS = 200
# the traced runs: 20 epochs in 5-epoch chunks (2 speculated), the card's
# events only (a profile of every host op of 40 epochs took minutes to read)
SPEC_TRACED_EPOCHS, SPEC_TRACED_CHUNK = 20, 5
# 10c: make_hessian_log_prob against the preconditioner's Hessian: the same
# float32 composition, vmapped against not, over the largest entry
HESS_RTOL = 1e-4
# 10d: one use_fused iteration in a fresh process (DES width, K=1)
PRECOMPILE_NTRAIN, PRECOMPILE_NVAL, PRECOMPILE_EPOCHS = 2000, 200, 20

# tests/test_ops.py's kernel tolerance; both sides accumulate in f32 and
# differ only in summation order
RTOL = ATOL = 2e-4

# phase 11: the sampler programs at the DES width through fused_log_prob
# (T^2 = 16): one chunk of each method replayed from CUDA graphs and one
# eager, from the same state and generator state (steps a chunk), a traced
# chunk of each (steps), zeus's loop iterations, and the K=4 ensemble's
# batched likelihood against the per-member loop it replaced
PROGRAM_STEPS = {"emcee": 100, "zeus": 100, "hmc": 10, "nuts": 10}
PROGRAM_TRACED = {"emcee": 50, "zeus": 20, "hmc": 2, "nuts": 2}
# graphed against eager where they are not equal bit for bit (the same
# kernels on the same inputs: any difference is a fault of the graphs)
PROGRAM_ATOL = 1e-6
# each sampler's step options, the same for the graphed and the eager chunks
# (run_ensemble's defaults)
PROGRAM_OPTIONS = {"a": 2.0, "n_leapfrog": 10, "max_depth": 5, "max_steps": 100}
K4_STEPS, K4_TRACED = 20, 5
# the batched K=4 likelihood against the per-member loop: the same products,
# batched (cuBLAS may pick other kernels for the batched shapes)
K4_RTOL = 1e-5

# phase 12: the training programs (train_graphs) at the DES width.  Each
# case: one chunk replayed from CUDA graphs and one eager from the same
# state, bit for bit (epochs a chunk), and a traced chunk of each (epochs).
# 12a: phase 5's rows at K=4 f32; 12b: 40,000 / 2,000 rows of the same
# theory at des_synthetic.yaml's K=2 bfloat16 (its fourth iteration's rows,
# batch 500); 12c: K=1 with a norder-2 pre-model on phase 5's rows; 12d:
# the range test (100 steps) on 12a's trainer; 12e: train() at K=4 with the
# range test, and a hyper, a reinit and a reload planted in speculated
# chunks, graphed
# against eager (5-epoch chunks: PLANTED_EPOCHS epochs, each planted epoch
# in a chunk that speculates its successor)
TRAIN_PROGRAM_EPOCHS = {"12a": 10, "12b": 5, "12c": 10}
# 12f: the AdamW kernel's steps against its plain version, and its members
ADAMW_STEPS = 5
ADAMW_MEMBERS = 2
WIDTHS_ADAMW = {"des": (NDIM, NDATA), "lsst": WIDE}
TRAIN_PROGRAM_TRACED = {"12a": 3, "12b": 2, "12c": 3}
FLAGSHIP_ROWS, FLAGSHIP_VAL = 40000, 2000
PLANTED = {12: "hyper", 27: "reinit", 42: "reload"}
PLANTED_EPOCHS, PLANTED_CHUNK = 50, 5
# phase 13: the user scripts.  13b: bench_full_torch.py on the LSST class
# (40 -> 1560) cut to phase 7's depth, its R-hat polish to one round; 13c:
# the NUTS demo's step counts (adaptation, warm-up and timed NUTS samples;
# slice tuning rounds, their steps and the timed slice steps), cut from
# 100 / 100 / 200 and 10 / 50 / 500; 13d: the exact posterior's length
SCRIPT_LSST = ("examples.lsst_theory", "examples/lsst_synthetic.yaml")
SCRIPT_POLISH = {"polish_rounds": 1, "polish_steps": 200}
DEMO_STEPS = {"m_adapt": 10, "nuts_warmup": 10, "nuts_steps": 20, "tune_rounds": 2,
              "tune_steps": 20, "slice_steps": 100}
EXACT_STEPS = 250
# phase 14: the measurement scripts cut to depth (bench_cuts); the walker
# counts bench_fused_torch.py launches fused_log_prob at, its smallest and
# largest (16,384 walkers: chunks at 8,192 rows, raw calls at 16,384)
BENCH_FUSED_WALKERS = (128, 16384)
# phase 15: the JAX package's slow acceptance tier at its tests' budgets
# (tests/_torch_acceptance.py), the walkthrough notebook's code cells, and
# bench_scaling_torch.py cut to depth (two gloo ranks share the card)
NOTEBOOK = os.path.join("examples", "walkthrough_torch.ipynb")
NOTEBOOK_MARKERS = ("posterior mean", "grad log p at whitened 0")
SCALING_CUTS = {"epochs": 5, "max_ranks": 2, "backend": "gloo"}

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 494.7e12  # tensor cores, TF32
PEAK_BYTES = 3.35e12
SOURCE = "linna_tpu_torch/ops/csrc/fused_mlp.cu"
REPLACES = {
    "fused_apply": "linna_tpu/ops/fused.py:138",
    "fused_log_prob": "linna_tpu/ops/fused.py:250",
}
# each kernel's name in the compiler's report and the profiler's events:
# fused_log_prob's tiled design, and its cluster design for narrow models
# (ops/fused.py, log_prob_design; launch_shape names the one a width runs)
KERNEL_NAMES = {"fused_apply": "fused_apply_kernel", "fused_log_prob": "fused_log_prob_kernel",
                "fused_log_prob_cluster": "fused_log_prob_cluster_kernel",
                "composition_grad": "composition_grad_kernel"}
# the kernels a likelihood path can reach: the two of the fused route
# (use_fused), and the composition's value and gradient on the card
PATH_KERNELS = ("fused_apply", "fused_log_prob", "composition_grad")
# 6b: composition_grad at the DES width against the composition's float64
# autograd, at NUTS's 256 walkers, the MAP search's one row and 128; the
# NUTS samples of its main-path run through run_ensemble
COMPOSITION_ROWS = (1, 128, 256)
COMPOSITION_MEMBERS = (1, 2)
COMPOSITION_NUTS_STEPS = 20


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------ inputs


def make_problem(device, ndim=NDIM, ndata=NDATA, seed=0, log10=(), ypositive=False):
    """Random DES-width weights, transforms, mixed priors, data and a dense
    SPD inverse covariance, from one seed."""
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T

    rng = np.random.default_rng(seed)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = N.init_model(spec, seed=seed, device=device)
    mask = np.zeros(ndim, bool)
    mask[list(log10)] = True
    priors = mixed_priors(ndim)
    if ypositive:
        y_mean, y_std = np.zeros(ndata), np.full(ndata, 0.05)
    else:
        y_mean, y_std = rng.normal(size=ndata) * 0.1, 1.0 + 0.3 * rng.uniform(size=ndata)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    ts = T.TransformSet(
        T.XTransform(f32(rng.normal(size=ndim) * 0.1), f32(1.0 + 0.1 * rng.uniform(size=ndim)),
                     torch.as_tensor(mask, device=device)),
        T.YTransform(f32(y_mean), f32(y_std), ypositive),
        T.YTransformData(f32(0.5 + rng.uniform(size=ndata))),
    )
    data = rng.normal(size=ndata) * 0.3
    if ypositive:
        data = np.abs(data) + 1.0
    a = rng.normal(size=(ndata, ndata)) / np.sqrt(ndata)
    inv_cov = np.eye(ndata) + 0.1 * a @ a.T
    return spec, params, ts, P.priors_from_list(priors, device), data, inv_cov


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    ninf_g, ninf_w = torch.isneginf(got), torch.isneginf(want)
    if not torch.equal(ninf_g, ninf_w):
        raise AssertionError(f"{what}: -inf rows differ")
    fin = ~ninf_w
    if not torch.isfinite(got[fin]).all():
        raise AssertionError(f"{what}: non-finite values where the plain version is finite")
    diff = (got[fin] - want[fin]).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / want[fin].abs().clamp(min=1e-30)).max()) if diff.numel() else 0.0
    ok = bool(torch.all(diff <= ATOL + RTOL * want[fin].abs()))
    log(f"  {what}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
        f"-inf rows={int(ninf_w.sum())} within rtol=atol={RTOL:g}: {ok}")
    if not ok:
        raise AssertionError(f"{what}: kernel and plain version disagree")
    return {"abs": abs_err, "rel": rel_err}


def plain_composition(log_prob):
    """``make_log_prob``'s composition as written, for a reference: its
    ``_pure`` over a copy of its env, which composition_grad's route never
    takes (it takes the log-prob's own env alone)."""
    env = dict(log_prob._env)
    return lambda x: log_prob._pure(x, env)


def _warm(fn) -> None:
    """Enough calls for the clocks to ramp; the weights then stay in L2
    between calls, as they do between the sampler's calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()


def kernel_events(prof) -> dict:
    """Device events by kernel name in a torch.profiler run, as (count,
    microseconds): the device-side events only, as the profiler's own table
    totals them (a CPU op's device time is the same kernels counted again)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n, us = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, us + e.self_device_time_total)
    return out


def kernel_us(prof) -> dict:
    """Device microseconds by kernel name in a torch.profiler run."""
    return {k: us for k, (_, us) in kernel_events(prof).items() if us > 0}


def _profiled_events(fn, reps: int) -> dict:
    """{kernel name: (device events, device microseconds)} of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_events(prof)


def device_ms(fn, kernel=None, per_call=1, reps=REPS, attempts=3) -> tuple:
    """Device time per call from torch.profiler's device events over
    ``reps`` calls; returns (ms, method).

    ``kernel``: the name of the call's own CUDA kernel, which it launches
    ``per_call`` times.  Only that kernel's events are timed, and there must
    be reps x per_call of them: a profile that missed some would read short
    without a sign.  A count that differs is logged and the reading taken
    again; after ``attempts`` readings it raises.

    ``kernel=None``: a call with no kernel of its own (a plain version, a
    chain of library kernels whose count per call the profiler does not
    reproduce: 37 to 40 at 4096 rows of the plain trunk on the H100).  Every
    device event is timed and their count reported, not checked.  Where the
    profiler records no device event at all, the time comes from CUDA events
    around ``reps`` back-to-back calls, host launch gaps included, and the
    method says so."""
    _warm(fn)
    if kernel is None:
        events = _profiled_events(fn, reps).values()
        n, us = sum(c for c, _ in events), sum(u for _, u in events)
        if n:
            return us / reps / 1e3, f"torch.profiler, {n} device events of the call's kernels"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return (start.elapsed_time(end) / reps,
                "cuda events around back-to-back calls (the profiler saw no device event)")
    want = reps * per_call
    for attempt in range(1, attempts + 1):
        mine = [v for k, v in _profiled_events(fn, reps).items() if kernel in k]
        n, us = sum(c for c, _ in mine), sum(u for _, u in mine)
        if n == want:
            return us / reps / 1e3, f"torch.profiler, {n} device events of {kernel}"
        log(f"  device_ms: {n} device events of {kernel} where {want} were launched "
            f"(reading {attempt} of {attempts})")
    raise AssertionError(f"device_ms: the profiler saw {n} device events of {kernel}, "
                         f"not the {want} launched")


def kernel_ms(fn, kernel: str, reps=REPS) -> tuple:
    """:func:`device_ms` of ``kernel``, launched once a call; where
    torch.profiler records fewer of its launches than were made in every
    reading (25-27 of 30 for composition_grad_kernel and adamw_kernel on
    an H100 with torch 2.11), the mean device time of the events it did
    record, the count in the method.  A reading with none still raises."""
    try:
        return device_ms(fn, kernel, reps=reps)
    except AssertionError:
        seen = [v for k, v in _profiled_events(fn, reps).items() if kernel in k]
        n, us = sum(c for c, _ in seen), sum(u for _, u in seen)
        if not n:
            raise
        return us / n / 1e3, (f"torch.profiler, the mean of the {n} device events of {kernel} "
                              f"it recorded of {reps} launched")


def call_ms(fn, reps=REPS) -> float:
    """Median time of one call from CUDA events around it, the host's
    launch work included: what one likelihood call of the sampler costs."""
    _warm(fn)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(kernel: str, spec, params, rows: int) -> dict:
    """Least time for the work: the operations at the peak of the kernel's
    own arithmetic (fused_apply: 3 TF32 tensor-core products per f32
    product; fused_log_prob: f32 FMAs on the CUDA cores) or the bytes at the
    memory rate, whichever is longer; each input read once and each output
    written once.  Both operation bounds are returned for both kernels."""
    from linna_tpu_torch import nn as N

    n_params = N.count_params(params)
    flops = 2.0 * n_params * rows
    nbytes = 4.0 * (n_params + rows * spec.in_size)
    if kernel == "fused_log_prob":
        n = spec.out_size
        flops += 2.0 * n * n * rows
        # inverse covariance, 6 length-D and 4 length-N vectors, one f32 out
        nbytes += 4.0 * (n * n + 6 * spec.in_size + 4 * n + rows)
    else:
        nbytes += 4.0 * rows * spec.out_size
    f32 = flops / PEAK_F32_FLOPS * 1e3
    tf32x3 = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = tf32x3 if kernel == "fused_apply" else f32
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "f32_cuda_core_ms": f32, "tf32x3_tensor_core_ms": tf32x3, "bytes_ms": t_bytes}


def kernel_resources(report: str) -> dict:
    """Registers and spilled bytes of each kernel, from nvcc's -Xptxas -v
    report."""
    out: dict = {}
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k, v in KERNEL_NAMES.items() if v in line), None)
        elif name is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(name, {})["spill_bytes"] = int(spill[1]) + int(spill[2])
            if regs:
                out.setdefault(name, {})["registers"] = int(regs[1])
    return out


# ---------------------------------------------------------------- phases


def phase_kernels(device, batches=BATCHES, timed=TIMED_ROWS, ndim=NDIM, ndata=NDATA, wide=WIDE,
                  wide_rows=WIDE_ROWS, wide_check=WIDE_CHECK_ROWS):
    """Each kernel against its plain version; returns per-kernel records
    (``wide["checked"]``: the (rows, in, out) shapes checked at the LSST
    width)."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.ops import fused as F

    gen = torch.Generator(device="cpu").manual_seed(7)
    rec = {k: {"abs": 0.0, "rel": 0.0, "ms": {}, "plain_ms": {}, "call_ms": {},
               "plain_call_ms": {}, "bound": {}, "shape": {},
               "wide": {"ms": {}, "plain_ms": {}, "bound": {}, "shape": {}, "checked": set()}}
           for k in REPLACES}

    def note(kernel, err):
        rec[kernel]["abs"] = max(rec[kernel]["abs"], err["abs"])
        rec[kernel]["rel"] = max(rec[kernel]["rel"], err["rel"])

    # fused_apply against the plain trunk
    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    for b in batches:
        x = torch.randn((b, ndim), generator=gen).to(device)
        note("fused_apply", compare(F.fused_apply(spec, params, x),
                                    F.fused_apply_plain(spec, params, x), f"fused_apply B={b}"))

    # fused_log_prob against make_log_prob's plain composition, three cases
    cases = {
        "mixed priors": dict(),
        "log10 lanes": dict(log10=(0, 3)),  # gauss priors around 0.3: some x <= 0
        "ypositive": dict(ypositive=True),
    }
    for case, kw in cases.items():
        spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata, **kw)
        lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                temperature=TEMPERATURE, use_fused=True, device=device)
        lp_p = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                temperature=TEMPERATURE, device=device)
        for b in batches:
            x = torch.randn((b, ndim), generator=gen).to(device)
            if case == "log10 lanes":
                x[: (b + 1) // 2, 0] = -3.0  # physical 0.3 - 3 < 0 on a log10 lane
            note("fused_log_prob", compare(lp_k(x), lp_p(x), f"fused_log_prob {case} B={b}"))

    # the widest model the repo configures: its launch shape and both kernels
    wspec, wparams, ts, pack, data, inv_cov = make_problem(device, *wide)
    lp_k = LK.make_log_prob(wspec, wparams, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, use_fused=True, device=device)
    lp_p = LK.make_log_prob(wspec, wparams, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, device=device)
    wide_fns = {"fused_apply": (lambda x: F.fused_apply(wspec, wparams, x),
                                lambda x: F.fused_apply_plain(wspec, wparams, x)),
                "fused_log_prob": (lp_k, lp_p)}
    for k, rows in wide_check.items():
        kern, plain = wide_fns[k]
        for b in rows:
            x = torch.randn((b, wide[0]), generator=gen).to(device)
            note(k, compare(kern(x), plain(x), f"{k} {wide[0]} -> {wide[1]} B={b}"))
            rec[k]["wide"]["checked"].add((b, *wide))
            rec[k]["wide"]["shape"][b] = F.launch_shape(wspec, b, k)
            log(f"  {k} {wide[0]} -> {wide[1]} B={b}: launch shape {rec[k]['wide']['shape'][b]}")

    # gradients: the kernels' autograd.Functions against plain autograd
    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    x = torch.randn((128, ndim), generator=gen).to(device)
    weights = F.flatten_params(params)
    wk = [w.detach().clone().requires_grad_(True) for w in weights]
    wp = [w.detach().clone().requires_grad_(True) for w in weights]
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    probe = torch.randn((128, ndata), generator=gen).to(device)
    (F._FusedApply.apply(spec, xk, *wk) * probe).sum().backward()
    (F._trunk_plain(xp, wp) * probe).sum().backward()
    compare(xk.grad, xp.grad, "fused_apply grad x")
    for i, (a, b) in enumerate(zip(wk, wp)):
        if i in (0, 21):
            compare(a.grad, b.grad, f"fused_apply grad weight {i}")
    lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, use_fused=True, device=device)
    lp_p = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, device=device)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    lp_k(xk).sum().backward()
    lp_p(xp).sum().backward()
    compare(xk.grad, xp.grad, "fused_log_prob grad x")

    # device time per launch
    fns = {"fused_apply": (lambda x: F.fused_apply(spec, params, x),
                           lambda x: F.fused_apply_plain(spec, params, x)),
           "fused_log_prob": (lp_k, lp_p)}
    with torch.no_grad():
        x = torch.randn((timed["fused_apply"][0], ndim), generator=gen).to(device)
        try:
            device_ms(lambda: F.fused_apply(spec, params, x), KERNEL_NAMES["fused_apply"],
                      per_call=2, reps=3, attempts=1)
        except AssertionError as e:
            log(f"  device_ms refuses a count that does not match the launches: {e}")
        else:
            raise AssertionError("device_ms took a reading with half the launched events")
        for k, rows in timed.items():
            kern, plain = fns[k]
            r = rec[k]
            for b in rows:
                x = torch.randn((b, ndim), generator=gen).to(device)
                name = F.launch_shape(spec, b, k).get("kernel", KERNEL_NAMES[k])
                r["ms"][b], r["method"] = device_ms(lambda: kern(x), name)
                r["plain_ms"][b], r["plain_method"] = device_ms(lambda: plain(x))
                r["call_ms"][b] = call_ms(lambda: kern(x))
                r["plain_call_ms"][b] = call_ms(lambda: plain(x))
                r["bound"][b] = bound_ms(k, spec, params, b)
                r["shape"][b] = F.launch_shape(spec, b, k)
                bd = r["bound"][b]
                log(f"  {k} B={b}: kernel {r['ms'][b]:.4f} ms ({r['method']}), plain "
                    f"{r['plain_ms'][b]:.4f} ms device ({r['plain_method']}); per call with "
                    f"host {r['call_ms'][b]:.4f} / {r['plain_call_ms'][b]:.4f} ms; bound "
                    f"{bd['ms']:.4f} ms ({bd['by']}; f32 CUDA cores "
                    f"{bd['f32_cuda_core_ms']:.4f}, 3xTF32 tensor cores "
                    f"{bd['tf32x3_tensor_core_ms']:.4f}, bytes {bd['bytes_ms']:.4f}); "
                    f"launch shape {r['shape'][b]}")
        # the same at the LSST width, where 13b's pipeline launches fused_log_prob
        for k, rows in wide_rows.items():
            kern, plain = wide_fns[k]
            r = rec[k]["wide"]
            for b in rows:
                x = torch.randn((b, wide[0]), generator=gen).to(device)
                name = F.launch_shape(wspec, b, k).get("kernel", KERNEL_NAMES[k])
                r["ms"][b], _ = device_ms(lambda: kern(x), name)
                r["plain_ms"][b], _ = device_ms(lambda: plain(x))
                r["bound"][b] = bound_ms(k, wspec, wparams, b)
                bd = r["bound"][b]
                log(f"  {k} {wide[0]} -> {wide[1]} B={b}: kernel {r['ms'][b]:.4f} ms, plain "
                    f"{r['plain_ms'][b]:.4f} ms device; bound {bd['ms']:.4f} ms ({bd['by']}; "
                    f"f32 CUDA cores {bd['f32_cuda_core_ms']:.4f}, 3xTF32 tensor cores "
                    f"{bd['tf32x3_tensor_core_ms']:.4f}, bytes {bd['bytes_ms']:.4f})")
    wide_shapes = rec["fused_log_prob"]["wide"]["shape"]
    for b, shape in [*rec["fused_log_prob"]["shape"].items(), *wide_shapes.items()]:
        if shape["design"] == "cluster":
            fits = shape["cluster_size"] == 8 and shape["max_active_clusters"] >= 1
        else:  # one cooperative launch: every block resident at once
            fits = 1 <= shape["blocks"] <= shape["capacity"] == shape["sms"] * shape["blocks_per_sm"]
        if not fits:
            raise AssertionError(f"fused_log_prob B={b}: launch shape {shape}")
    return rec


def row_dependence(device, rows=16, batches=(16, 128, 256), ndim=NDIM, ndata=NDATA) -> dict:
    """The same ``rows`` walkers evaluated first in a batch of their own and
    then as the first rows of larger ``batches`` (the rest random), through
    ``fused_log_prob`` and through the plain composition: for each batch,
    the kernel's design and blocks and each route's largest difference
    from the ``rows``-row batch (0 where a row's value does not depend on
    the rows launched beside it).  On a card the kernel's differences must
    be 0: its sums follow the model's width, not the launch's rows."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.ops import fused as F

    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    lps = {route: LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                   temperature=TEMPERATURE, use_fused=route == "kernel",
                                   device=device) for route in ("kernel", "plain")}
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn((max(batches), ndim), generator=gen).to(device) * 0.3
    res = {"rows": rows, "batches": {}}
    with torch.no_grad():
        first = {r: lp(x[:rows]) for r, lp in lps.items()}
        for b in batches:
            shape = F.launch_shape(spec, b, "fused_log_prob") if device.type == "cuda" else {}
            rec = {"design": shape.get("design"), "blocks": shape.get("blocks")}
            for r, lp in lps.items():
                rec[f"{r}_max_abs_diff"] = _apart(lp(x[:b])[:rows], first[r])
            res["batches"][b] = rec
    log(f"  the same {rows} rows inside larger batches: {json.dumps(res)}")
    apart = {b: r["kernel_max_abs_diff"] for b, r in res["batches"].items()}
    if device.type == "cuda" and any(apart.values()):
        raise AssertionError(f"fused_log_prob: a row's value depends on the rows launched "
                             f"beside it: {apart}")
    return res


def traced_call(fn, device) -> dict:
    """Where the time goes in one profiled call of ``fn``: its wall time, the
    device's busy share and the device time by kernel (the profiler's own
    host cost is inside the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = kernel_events(prof)
    total = sum(us for _, us in events.values()) / 1e3
    by_kernel = sorted(((k, us / 1e3) for k, (_, us) in events.items()), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms, "device_ms": total, "device_busy_share": total / wall_ms,
            "launches": sum(n for n, _ in events.values()),
            "device_ms_by_kernel": dict(by_kernel[:6])}


def traced_chunk(log_prob, coords, device, steps=20) -> dict:
    """Where the time goes: one profiled ``steps``-step slice chunk from the
    chain's last positions (run after the main path's counts were read)."""
    from linna_tpu_torch.samplers import slicemove as S

    state = S.init_slice_state(torch.Generator(device=device).manual_seed(1),
                               torch.as_tensor(coords, dtype=torch.float32, device=device), log_prob)
    return {"steps": steps, **traced_call(lambda: S.slice_chunk(log_prob, state, steps), device)}


def write_iteration_dir(outdir, device, seed=3, ndim=NDIM, ndata=NDATA, ntrain=2000):
    """An iteration directory as training leaves it, written with the port's
    own writers: random weights, transforms fitted to synthetic training
    samples, and a data vector equal to the emulator's prediction at a
    truth point plus noise, with a diagonal covariance."""
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.utils import checkpoint as ckpt

    rng = np.random.default_rng(seed)
    priors = mixed_priors(ndim)
    pack = P.priors_from_list(priors, device)
    os.makedirs(outdir, exist_ok=True)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = N.init_model(spec, seed=seed, device=device)
    train_x = P.transform_np(pack, rng.normal(size=(ntrain, ndim)))
    proj = rng.normal(size=(ndim, ndata)) / np.sqrt(ndim)
    train_y = 10.0 + train_x @ proj  # a smooth synthetic theory
    sigma = 0.05 * np.abs(train_y.mean(axis=0)) + 0.01
    ts = T.TransformSet(
        T.fit_x_transform(train_x, device=device),
        T.fit_y_transform(train_y / sigma, device=device),
        T.YTransformData(torch.as_tensor(sigma, dtype=torch.float32, device=device)),
    )
    np.savetxt(os.path.join(outdir, "train_samples_x.txt"), train_x)
    np.save(os.path.join(outdir, "train_samples_y.npy"), train_y)
    T.save_transforms(os.path.join(outdir, O.TRANSFORMS_FILE), ts)
    ckpt.save_checkpoint(os.path.join(outdir, O.BEST_CKPT), params, meta={"seed": seed})
    with open(os.path.join(outdir, O.FINISH_MARKER), "w") as f:
        json.dump({"status": "done"}, f)

    truth_white = rng.normal(size=ndim) * 0.3
    truth = P.transform_np(pack, truth_white[None])[0]
    with torch.no_grad():
        x_in = ts.x_transform(torch.as_tensor(truth[None], dtype=torch.float32, device=device))
        pred = ts.y_data.inverse(ts.y_transform(N.apply_model(spec, params, x_in)))[0]
    data = pred.double().cpu().numpy() + sigma * rng.normal(size=ndata)
    cov = np.diag(sigma**2)
    return priors, data, cov, truth


def phase_slice(device, outdir, nwalkers=NWALKERS, steps=STEPS, ndim=NDIM, ndata=NDATA):
    """The sampling stage of one ml_sampler_core iteration through the
    port's public functions; returns the launch counts and rates."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import run as R

    priors, data, cov, truth = write_iteration_dir(outdir, device, ndim=ndim, ndata=ndata)
    inv_cov = np.linalg.inv(cov)
    pack = P.priors_from_list(priors, device)
    init_white = P.inv_transform(pack, torch.as_tensor(truth, dtype=torch.float32, device=device))
    x0 = init_white.cpu().numpy() + 0.001 * np.random.default_rng(0).standard_normal((nwalkers, ndim))
    rows = {"n": 0}

    F.reset_counts()
    t0 = time.perf_counter()
    in_saved, out_saved = O._saved_shapes(outdir)
    model = O.retrieve_model(outdir, in_saved, out_saved, device=device)
    params_lp = O.retrieve_ensemble_params(outdir, model)
    log_prob = LK.make_log_prob(
        model.spec, params_lp if len(params_lp) > 1 else model.params, model.transforms,
        pack, data, inv_cov, temperature=TEMPERATURE, use_fused=True, device=device,
    )

    def counted(x):
        rows["n"] += x.shape[0]
        return log_prob(x)

    trace = {}
    t1 = time.perf_counter()
    R.run_ensemble(
        counted, x0, outdir, method="zeus",
        transform=lambda x: P.transform_np(pack, x),
        check_every=100, max_iterations=steps, seed=0, device=device, trace_rec=trace,
    )
    t2 = time.perf_counter()
    if "graphs" in trace:  # the wrapper ran only while the graphs were captured
        rows["n"] = nwalkers + trace["graphs"]["rows"]
    chain_path = os.path.join(outdir, O._chain_filename("zeus"))
    chain, logp, reader = O.read_chain_and_cut(chain_path, nk=2, ntimes=10, method="zeus", flat=True)
    cut_chain, cut_lp, _ = O.read_chain_and_cut(chain_path, nk=2, ntimes=10, walkercut=True,
                                                method="zeus")
    emulator = O.retrieve_model_wrapper(outdir, device=device)
    with torch.no_grad():
        pred = emulator(chain.mean(axis=0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    launches, plain = _likelihood_counts(F.launches), _likelihood_counts(F.plain_calls)

    samples, lps = reader.get_chain(), reader.get_log_prob()
    if samples.shape != (steps, nwalkers, ndim) or lps.shape != (steps, nwalkers):
        raise AssertionError(f"chain shapes {samples.shape}, {lps.shape}")
    if not (np.isfinite(samples).all() and np.isfinite(lps).all() and np.isfinite(chain).all()):
        raise AssertionError("the chain or its log-probs are not finite")
    if (cut_lp.shape[1] < 1 or cut_chain.shape != (cut_lp.size, ndim)
            or not np.isfinite(cut_chain).all()):
        raise AssertionError(f"walker cut: chain {cut_chain.shape}, log-probs {cut_lp.shape}")
    pred = pred.cpu().numpy()
    if pred.shape != (ndata,) or not np.isfinite(pred).all():
        raise AssertionError(f"posterior-mean prediction {pred.shape} is not finite")
    # the stored log-probs against the plain composition at the stored points
    plain_lp = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data,
                                inv_cov, temperature=TEMPERATURE, device=device)
    with torch.no_grad():
        last = torch.as_tensor(samples[-1], dtype=torch.float32, device=device)
        compare(torch.as_tensor(lps[-1]), plain_lp(last), "stored log-probs vs plain make_log_prob")
    chi2 = float(np.sum((pred - data) ** 2 / np.diag(cov)))
    busy = traced_chunk(log_prob, samples[-1], device) if device.type == "cuda" else None
    if launches["fused_log_prob"] == 0:
        raise AssertionError(f"fused_log_prob did not launch on the main path: {launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    res = {
        "store": reader.path,
        "setup_s": t1 - t0,
        "sample_s": t2 - t1,
        "cut_and_predict_s": t3 - t2,
        "s_per_100_steps": (t2 - t1) / (steps / 100),
        "loop_s_per_100_steps": trace["sampler"]["loop"] / steps * 100,
        "rows_per_s": rows["n"] / (t2 - t1),
        "rows": rows["n"],
        "launches": launches,
        "launches_per_step": launches["fused_log_prob"] / steps,
        "plain_calls": plain,
        "kept_samples": int(chain.shape[0]),
        "walkercut_kept_walkers": int(cut_lp.shape[1]),
        "posterior_mean_chi2_per_point": chi2 / ndata,
        "trace": trace,
        "traced_chunk": busy,
    }
    log(f"  slice: {json.dumps(res, default=float)}")
    return res


# ---------------------------------------------------------------- training


class SmoothTheory:
    """A smooth synthetic theory made from a seed: ``y = 10 + tanh(x A) B``
    with A (ndim, width) and B (width, ndata) Gaussian.  Called as the
    pipeline calls a theory, ``theory([index, x], scratch_dir)``."""

    def __init__(self, ndim: int, ndata: int, seed: int = 5, width: int = 64):
        rng = np.random.default_rng(seed)
        self.a = rng.normal(size=(ndim, width)) / np.sqrt(ndim)
        self.b = rng.normal(size=(width, ndata)) / np.sqrt(width)

    def batch(self, x: np.ndarray) -> np.ndarray:
        return 10.0 + np.tanh(np.asarray(x, np.float64) @ self.a) @ self.b

    def __call__(self, task, outdir) -> np.ndarray:
        return self.batch(np.asarray(task[1])[None])[0]


def mixed_priors(ndim: int) -> list:
    """Phase 4's priors: Gaussian on every third parameter, flat elsewhere."""
    return [
        {"dist": "gauss", "arg1": 0.3, "arg2": 1.0} if i % 3 == 0
        else {"dist": "flat", "arg1": -2.0, "arg2": 2.0}
        for i in range(ndim)
    ]


def seeded_problem(device, ndim: int, ndata: int):
    """Phase 5's problem, from seeds: the smooth theory, the mixed priors, a
    truth point, a data vector (the theory at the truth plus noise, sigma
    0.1), its covariance, and the generator, which phase 5 draws on."""
    from types import SimpleNamespace

    from linna_tpu_torch import priors as P

    theory = SmoothTheory(ndim, ndata)
    priors = mixed_priors(ndim)
    pack = P.priors_from_list(priors, device)
    rng = np.random.default_rng(11)
    truth = P.transform_np(pack, rng.normal(size=(1, ndim)) * 0.3)[0]
    sigma = np.full(ndata, 0.1)
    data = theory.batch(truth[None])[0] + sigma * rng.normal(size=ndata)
    cov = np.diag(sigma**2)
    return SimpleNamespace(theory=theory, priors=priors, pack=pack, rng=rng, truth=truth,
                           sigma=sigma, data=data, cov=cov, inv_cov=np.linalg.inv(cov))


def iteration_missing(outdir: str, nensemble: int, chain: bool = False) -> list:
    """The artifacts of a trained (and, with ``chain``, sampled) iteration
    directory that are not there: the sample files, transforms, marker, and
    each member's checkpoints and learning rate."""
    from linna_tpu_torch import orchestrator as O

    need = ["train_samples_x.txt", "train_samples_y.npy", "val_samples_x.txt",
            "val_samples_y.npy", O.TRANSFORMS_FILE, O.FINISH_MARKER]
    for k in range(nensemble):
        sub = "" if k == 0 else f"ens_{k}"
        need += [os.path.join(sub, f) for f in (O.BEST_CKPT, "last.ckpt.npz", "lr.npy")]
    missing = [f for f in need if not os.path.isfile(os.path.join(outdir, f))]
    if chain and not O._open_backend(os.path.join(outdir, O._chain_filename("zeus")), "zeus").exists():
        missing.append(O._chain_filename("zeus"))
    return missing


def member_dirs(outdir: str, nensemble: int) -> list:
    return [outdir] + [os.path.join(outdir, f"ens_{k}") for k in range(1, nensemble)]


def initial_val_losses(outdir, spec, data, cov, seeds, device, linearmodel=None) -> list:
    """Each member's validation loss (the median chi^2 ratio) at its initial
    weights, which its seed fixes, under the iteration's transforms, with
    the iteration's pre-model added where it has one."""
    from linna_tpu_torch import data as D
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import transforms as T

    ts = T.load_transforms(os.path.join(outdir, O.TRANSFORMS_FILE), device=device)
    ls = L.build_loss_state(data, cov, ts)
    stack = D.load_curated_stack([outdir])
    vx = torch.as_tensor(stack.val_x, dtype=torch.float32, device=device)
    vy = torch.as_tensor(stack.val_y, dtype=torch.float32, device=device)
    out = []
    with torch.no_grad():
        for s in seeds:
            pred = N.apply_model(spec, N.init_model(spec, seed=s, device=device), ts.x_transform(vx),
                                 linearmodel=linearmodel)
            out.append(float(L.val_metric_fn(ls, ts, pred, vy)[0]))
    return out


def best_val_losses(outdir: str, nensemble: int) -> list:
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.utils import checkpoint as ckpt

    return [float(ckpt.read_checkpoint_raw(os.path.join(d, O.BEST_CKPT))[1]["best_val_loss"])
            for d in member_dirs(outdir, nensemble)]


def not_learned(best: list, initial: list, factor: float = 10.0) -> list:
    """Members whose best val loss is not finite or not below 1/factor of
    their initial weights' val loss: [(member, best, initial)]."""
    return [(m, b, i) for m, (b, i) in enumerate(zip(best, initial))
            if not (np.isfinite(b) and b < i / factor)]


def trained_ensemble_trainer(outdir, data, cov, nensemble, batch_size, device,
                             compute_dtype=None, linearmodel=None):
    """An EnsembleTrainer holding the trained members' best weights, over
    the iteration's rows, for a timed and a traced chunk."""
    from linna_tpu_torch import data as D
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer
    from linna_tpu_torch.utils import checkpoint as ckpt

    stack = D.load_curated_stack([outdir])
    ts = T.load_transforms(os.path.join(outdir, O.TRANSFORMS_FILE), device=device)
    spec = N.make_model_spec("chto_v2", stack.train_x.shape[1], stack.train_y.shape[1])
    params = [ckpt.load_checkpoint(os.path.join(d, O.BEST_CKPT), device="cpu")[0]
              for d in member_dirs(outdir, nensemble)]
    tr = EnsembleTrainer(spec, ts, L.build_loss_state(data, cov, ts), [None] * nensemble,
                         list(range(nensemble)), params=params, compute_dtype=compute_dtype,
                         linearmodel=linearmodel, device=device)
    tr._batch_size = batch_size
    rows = tr._prepare(stack.train_x, stack.train_y, stack.val_x, stack.val_y)
    return tr, rows, len(stack.train_x)


def epoch_ms(tr, rows, n, device, epochs=10) -> float:
    """ms an epoch of a chunk of ``epochs`` epochs after a warm epoch, timed
    with a synchronize on each side."""
    tr._epochs_tracked(tr._draw_perms(1, n), rows)
    perms = tr._draw_perms(epochs, n)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tr._epochs_tracked(perms, rows)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / epochs * 1e3


def timed_train_chunk(tr, rows, n, device, epochs=10) -> dict:
    """Where a training epoch's time goes: a chunk of ``epochs`` epochs timed
    with a synchronize on each side, then one traced by torch.profiler
    (its wall includes the profiler's own cost): device busy share, kernel
    launches per epoch, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    wall = epoch_ms(tr, rows, n, device, epochs) * epochs / 1e3
    perms = tr._draw_perms(epochs, n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._epochs_tracked(perms, rows)
        torch.cuda.synchronize(device)
        traced_wall = time.perf_counter() - t0
    events = kernel_events(prof)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    n_kernels = sum(c for c, _ in events.values())
    dev_ms = sum(us for _, us in events.values()) / 1e3
    by_kernel = sorted(((k, us / 1e3) for k, (_, us) in events.items()), key=lambda kv: -kv[1])
    rows_per_epoch = (n // tr._batch_size) * tr._batch_size * tr.n_members
    return {
        "program": tr._program.record(),
        "epochs": epochs,
        "ms_per_epoch": wall / epochs * 1e3,
        "rows_per_s": rows_per_epoch * epochs / wall,
        "traced_wall_ms": traced_wall * 1e3,
        "device_ms": dev_ms,
        "device_busy_share": dev_ms / (traced_wall * 1e3),
        "launches_per_epoch": n_kernels / epochs,
        "device_ms_by_kernel": dict(by_kernel[:8]),
        "host_ms_and_calls_by_op": {k: [ms, n] for k, ms, n in host[:10]},
    }


def drive_pipeline(outdir, device, use_fused=False) -> dict:
    """The canonical ml_sampler_core drive (ndim 3, 2 iterations, zeus) of
    the verify recipe; ``use_fused`` routes its single emulator through
    ``fused_log_prob``."""
    import linna_tpu_torch as LT

    ndim = 3
    cov, means = np.diag([0.3, 0.5, 0.2]), np.array([0.3, -0.2, 0.5])
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(ndim)]
    t0 = time.perf_counter()
    chain, logp = LT.ml_sampler_core(
        ntrainArr=[400, 400], nvalArr=[80, 80], nkeepArr=[2, 4], ntimesArr=[8, 15],
        ntautolArr=[0.2, 0.1], meanshiftArr=[0.5, 0.5], stdshiftArr=[0.5, 0.5],
        outdir=outdir, theory=_identity_theory, priors=priors, data=means, cov=cov,
        init=np.zeros(ndim), pool=None, nwalkers=24, temperatureArr=[2.0, 1.0],
        params={"trainingoption": 1, "num_epochs": 300, "batch_size": 100,
                "use_fused": use_fused},
        method="zeus", seed=3, device=device,
    )
    seconds = time.perf_counter() - t0
    missing = [f"iter_{i}/{f}" for i in range(2)
               for f in iteration_missing(os.path.join(outdir, f"iter_{i}"), 1, chain=True)]
    if missing:
        raise AssertionError(f"ml_sampler_core left artifacts out: {missing}")
    if chain.ndim != 2 or chain.shape[1] != ndim or not np.isfinite(chain).all() \
            or not np.isfinite(logp).all():
        raise AssertionError(f"ml_sampler_core chain {chain.shape} is not finite")
    sd = np.sqrt(np.diag(cov))
    return {"seconds": seconds, "samples": int(chain.shape[0]),
            "mean_offset_sigma": ((chain.mean(axis=0) - means) / sd).tolist(),
            "std_ratio": (chain.std(axis=0) / sd).tolist()}


def _identity_theory(task, outdir):
    return np.asarray(task[1], dtype=np.float64).copy()


def phase_train(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                epochs=TRAIN_EPOCHS, nensemble=NENSEMBLE, nwalkers=NWALKERS, steps=ENS_STEPS,
                chunk_epochs=10):
    """Training at the DES width: iteration 0 of a pipeline (flat LHS points,
    a smooth synthetic theory) trained as the README's K=4 ensemble through
    ``train_emulator``, then sampled, then the fused likelihood held against
    the plain composition on trained member 0, then the canonical drive of
    ``ml_sampler_core``.  Returns the records the result line reports."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import sample_gen as SG
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import run as R
    from linna_tpu_torch.train import _walk

    on_card = device.type == "cuda"
    it0 = os.path.join(outdir, "train", "iter_0")
    pb = seeded_problem(device, ndim, ndata)
    theory, priors, pack, rng, truth = pb.theory, pb.priors, pb.pack, pb.rng, pb.truth
    sigma, data, cov, inv_cov = pb.sigma, pb.data, pb.cov, pb.inv_cov

    t0 = time.perf_counter()
    SG.generate_training_point(theory, SG.NNSampler(it0, P.prior_range(pack)), None, it0,
                               ntrain, nval, data, inv_cov)
    t1 = time.perf_counter()
    params = {"trainingoption": 1, "nensemble": nensemble, "batch_size": 500, "num_epochs": epochs}
    rec: dict = {}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    O.train_emulator(it0, [it0], data, cov, sigma, None, False, "chto_v2", params,
                     trace_rec=rec, device=device)
    if on_card:
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    missing = iteration_missing(it0, nensemble)
    if missing:
        raise AssertionError(f"train_emulator left artifacts out: {missing}")
    plots = {f: [os.path.isfile(os.path.join(d, f)) for d in member_dirs(it0, nensemble)]
             for f in ("lr_tunning.png", "training_progress.png", "trainniing.png")}

    spec = N.make_model_spec("chto_v2", ndim, ndata)
    seeds = [1234 + 1000 * k for k in range(nensemble)]  # train_emulator's member seeds
    initial = initial_val_losses(it0, spec, data, cov, seeds, device)
    best = best_val_losses(it0, nensemble)
    log(f"  val loss per member: initial {initial}, best {best}")
    bad = not_learned(best, initial)
    if bad:
        raise AssertionError(f"members that did not learn (member, best, initial): {bad}")

    # sample the trained ensemble, then hold the fused likelihood of trained
    # member 0 against the plain composition at the chain's last positions
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    members = O.retrieve_ensemble_params(it0, model)
    off = ["/".join(k) for m in members for k, v in _walk(m) if v.device != device]
    if len(members) != nensemble or off:
        raise AssertionError(f"{len(members)} members retrieved, tensors off {device}: {off}")
    log_prob = LK.make_log_prob(model.spec, members, model.transforms, pack, data, inv_cov,
                                temperature=TEMPERATURE, device=device)
    init_white = P.inv_transform(pack, torch.as_tensor(truth, dtype=torch.float32, device=device))
    x0 = init_white.cpu().numpy() + 0.001 * rng.standard_normal((nwalkers, ndim))
    ens_trace: dict = {}
    t3 = time.perf_counter()
    R.run_ensemble(log_prob, x0, it0, method="zeus", transform=lambda x: P.transform_np(pack, x),
                   check_every=min(100, steps), max_iterations=steps, convergence_check=False,
                   seed=0, device=device, trace_rec=ens_trace)
    t4 = time.perf_counter()
    chain_path = os.path.join(it0, O._chain_filename("zeus"))
    chain, lp, reader = O.read_chain_and_cut(chain_path, nk=2, ntimes=10, method="zeus", flat=True)
    last = reader.get_chain()[-1]
    if not (np.isfinite(chain).all() and np.isfinite(lp).all()) or last.shape != (nwalkers, ndim):
        raise AssertionError(f"trained-ensemble chain {chain.shape} is not finite")
    fused = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data, inv_cov,
                             temperature=TEMPERATURE, use_fused=True, device=device)
    plain = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data, inv_cov,
                             temperature=TEMPERATURE, device=device)
    x_last = torch.as_tensor(last, dtype=torch.float32, device=device)
    before = dict(F.launches), dict(F.plain_calls)
    with torch.no_grad():
        got = fused(x_last)
        moved = F.launches["fused_log_prob"] - before[0]["fused_log_prob"]
        plain_in_fused = F.plain_calls["fused_log_prob"] - before[1]["fused_log_prob"]
        err = compare(got, plain(x_last), "fused_log_prob on trained member 0")
    if on_card and (moved != 1 or plain_in_fused):
        raise AssertionError(f"the fused call launched {moved} kernels and ran the plain "
                             f"version {plain_in_fused} times")

    t5 = time.perf_counter()
    drive = drive_pipeline(os.path.join(outdir, "drive"), device, use_fused=True)
    log(f"  ml_sampler_core drive: {json.dumps(drive)}")

    res = {
        "epochs": epochs,
        "epochs_run": rec.get("epochs_run"),
        "train_emulator_s": t2 - t1,
        "points_s": t1 - t0,
        "ms_per_epoch_in_train_emulator": (rec["trainer"]["dispatch"] + rec["trainer"]["wait_fetch"])
        / max(rec["epochs_run"], 1) * 1e3,
        "trainer_phase_s": rec["trainer"],
        "stack_fit_s": rec.get("stack_fit_s"),
        "trainer_init_s": rec.get("trainer_init_s"),
        "peak_device_bytes": peak,
        "initial_val_loss": initial,
        "best_val_loss": best,
        "plots_written": plots,
        "ensemble_sample_s": t4 - t3,
        "ensemble_steps": steps,
        "ensemble_trace": ens_trace,
        "ensemble_loop_s_per_100": ens_trace["sampler"]["loop"] / steps * 100,
        "fused_check": err,
        "drive": drive,
        "drive_s": time.perf_counter() - t5,
    }
    if on_card:
        tr, rows, n = trained_ensemble_trainer(it0, data, cov, nensemble, 500, device)
        if any(t.device != device for t in (tr.flat, *tr.opt, *rows[:4])):
            raise AssertionError("the trainer's tensors are not all on the card")
        res["chunk"] = timed_train_chunk(tr, rows, n, device, chunk_epochs)
    log(f"  training: {json.dumps(res, default=float)}")
    return res


# ---------------------------------------------------------------- gradient


def check_gradient(device, rows=NWALKERS, ndim=NDIM, ndata=NDATA) -> dict:
    """The per-walker gradient through ``fused_log_prob`` (its autograd
    Function: a kernel launch, then the plain composition's backward)
    against the plain composition's, at ``rows`` positions; with log10
    lanes where some rows are -inf, whose gradient must be zero, not NaN."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import hmc

    gen = torch.Generator(device="cpu").manual_seed(11)
    out = {}
    for case, kw in {"mixed priors": {}, "log10 lanes": {"log10": (0, 3)}}.items():
        spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata, **kw)
        lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov, use_fused=True,
                                device=device)
        lp_p = plain_composition(LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                                  device=device))
        x = torch.randn((rows, ndim), generator=gen).to(device)
        if kw:
            x[: rows // 2, 0] = -3.0  # physical 0.3 - 3 < 0 on a log10 lane
        before = F.launches["fused_log_prob"]
        v_k, g_k = hmc.value_and_grad(lp_k, x)
        if device.type == "cuda" and F.launches["fused_log_prob"] - before != 1:
            raise AssertionError("the gradient call did not launch fused_log_prob once")
        v_p, g_p = hmc.value_and_grad(lp_p, x)
        compare(v_k, v_p, f"value through the gradient path, {case}")
        if not torch.isfinite(g_k).all():
            raise AssertionError(f"{case}: a gradient through the kernel is not finite")
        dead = ~torch.isfinite(v_k)
        if dead.any() and g_k[dead].abs().max() != 0:
            raise AssertionError(f"{case}: a -inf walker has a nonzero gradient")
        out[case] = compare(g_k, g_p, f"per-walker gradient through the kernel, {case}")
        out[case]["-inf rows"] = int(dead.sum())
    return out


def phase_gradient(device, outdir, nwalkers=NWALKERS, nuts_steps=NUTS_STEPS,
                   hmc_steps=HMC_STEPS, emcee_steps=EMCEE_STEPS, ndim=NDIM, ndata=NDATA):
    """The gradient samplers and emcee at the DES width on one emulator with
    ``use_fused=True`` (phase 4's iteration directory, T = 1): the kernel's
    gradient against the plain one, then ``run_ensemble`` with the MAP
    search and ``nuts_steps`` NUTS samples, ``hmc_steps`` HMC samples, and
    ``emcee_steps`` stretch steps after emcee's 100-step burn-in.  Returns
    the records and each kernel's launches on the gradient path (the NUTS
    and HMC runs) and on the emcee run."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import run as R

    grad = check_gradient(device, ndim=ndim, ndata=ndata)
    it0 = os.path.join(outdir, "iter_0")
    priors, data, cov, truth = write_iteration_dir(it0, device, ndim=ndim, ndata=ndata)
    inv_cov = np.linalg.inv(cov)
    pack = P.priors_from_list(priors, device)
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    log_prob = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data,
                                inv_cov, temperature=1.0, use_fused=True, device=device)
    init_white = P.inv_transform(pack, torch.as_tensor(truth, dtype=torch.float32, device=device))
    x0 = init_white.cpu().numpy() + 0.001 * np.random.default_rng(0).standard_normal((nwalkers, ndim))
    tfn = lambda x: P.transform_np(pack, x)

    def run(method, steps):
        d = os.path.join(outdir, method)
        trace: dict = {}
        F.reset_counts()
        t0 = time.perf_counter()
        backend = R.run_ensemble(log_prob, x0, d, method=method, transform=tfn,
                                 check_every=steps, max_iterations=steps,
                                 convergence_check=False, seed=0, device=device,
                                 trace_rec=trace)
        wall = time.perf_counter() - t0
        launches, plain = _likelihood_counts(F.launches), _likelihood_counts(F.plain_calls)
        chain, lps = backend.get_chain(), backend.get_log_prob()
        if chain.shape != (steps, nwalkers, ndim) or not (np.isfinite(chain).all()
                                                          and np.isfinite(lps).all()):
            raise AssertionError(f"{method}: chain {chain.shape} is not finite")
        if device.type == "cuda" and any(plain.values()):
            raise AssertionError(f"{method}: a plain version ran on the gradient path")
        s = trace["sampler"]
        loop = s["loop"]
        with backend._open("r") as f:
            accepted = np.asarray(f["mcmc"]["accepted"][:])
        half = tfn(chain[steps // 2:].reshape(-1, ndim))
        rec = {"wall_s": wall, "sampler_s": s, "steps": steps,
               "s_per_100_steps": loop / steps * 100, "launches": launches,
               "fused_log_prob_launches": launches["fused_log_prob"],
               "launches_per_step": launches["fused_log_prob"] / steps,
               "mean_acceptance": float(accepted.mean() / steps),
               "max_truth_offset_in_chain_std": float(np.max(
                   np.abs(half.mean(axis=0) - truth) / half.std(axis=0)))}
        log(f"  {method}: {json.dumps(rec, default=float)}")
        return rec, backend

    res = {"gradient_check": grad}
    res["nuts"], nuts_backend = run("nuts", nuts_steps)
    res["hmc"], _ = run("hmc", hmc_steps)
    res["emcee"], _ = run("emcee", emcee_steps)
    launches = {
        "gradient": {k: res["nuts"]["launches"][k] + res["hmc"]["launches"][k]
                     for k in PATH_KERNELS},
        "emcee": res["emcee"]["launches"],
    }

    # launches per NUTS sample, and where a sample's time goes, from a
    # traced chunk of 5 samples at the chain's end in the saved space
    pre = R._load_precond(os.path.join(outdir, "nuts", R.PRECOND_FILENAME))
    wrapped = pre.wrap_log_prob(log_prob)
    y = torch.as_tensor(pre.to_sampling(nuts_backend.get_chain()[-1]), dtype=torch.float32,
                        device=device)
    state = hmc.init_nuts_state(torch.Generator(device=device).manual_seed(1), y, wrapped,
                                m_adapt=0)
    before = F.launches["fused_log_prob"]
    chunk = lambda: hmc.nuts_chunk(wrapped, state, 5)
    if device.type == "cuda":
        res["nuts_traced_chunk"] = traced_call(chunk, device)
    else:
        chunk()
    per_sample = (F.launches["fused_log_prob"] - before) / 5
    res["nuts_fused_log_prob_launches_per_sample"] = per_sample
    if device.type == "cuda" and per_sample != 2**5 - 1:
        raise AssertionError(f"{per_sample} fused_log_prob launches per NUTS sample, not 31")
    log(f"  gradient: {json.dumps(res, default=float)}")
    # phase 10c's Hessian check: this likelihood, its plain composition and
    # the NUTS run's preconditioner (its MAP point and Hessian eigenbasis)
    res["map"] = {"fused": log_prob, "precond": pre, "plain": plain_composition(LK.make_log_prob(
        model.spec, model.params, model.transforms, pack, data, inv_cov, temperature=1.0,
        device=device))}
    return res, launches


def composition_bound_ms(spec, members: int, rows: int) -> dict:
    """Least time for composition_grad's work over ``rows`` rows: its
    operations (:func:`linna_tpu_torch.ops.composition.operations`) at the
    3xTF32 tensor-core rate it runs at (three TF32 products per f32
    product), or its bytes at the memory rate (the weights and their
    transposes, C^-1 twice, the rows' inputs, values and gradients, each
    once), whichever is longer."""
    from linna_tpu_torch.ops import composition as CG
    from linna_tpu_torch.ops import fused as F

    dims = F.kernel_dims(spec)
    flops = CG.operations(dims, members, rows)
    weights = members * sum(math.prod(s) for s in F.weight_shapes(dims))
    n = spec.out_size
    nbytes = 4.0 * (2 * weights + 2 * n * n + rows * (2 * spec.in_size + 1))
    tf32x3 = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"ms": max(tf32x3, t_bytes), "by": "operations" if tf32x3 >= t_bytes else "bytes",
            "tf32x3_tensor_core_ms": tf32x3, "f32_cuda_core_ms": flops / PEAK_F32_FLOPS * 1e3,
            "bytes_ms": t_bytes, "flops": flops}


def phase_composition_grad(device, outdir, rows=COMPOSITION_ROWS, members=COMPOSITION_MEMBERS,
                           nuts_steps=COMPOSITION_NUTS_STEPS, nwalkers=NWALKERS, ndim=NDIM,
                           ndata=NDATA) -> dict:
    """6b: composition_grad, the K-member composition's value and input
    gradient in one kernel, at the DES width.  For each of ``members``:
    ``GradRoute.value_and_grad`` at each of ``rows`` rows against the
    composition's float64 autograd, at the card test's tolerances
    (``tests/_torch_composition.py``; ypositive and k_std 1, a dense
    non-symmetric C^-1); one launch a call, no plain call; the device time
    of each row count (:func:`kernel_ms`) and its bound.  Then the main
    path at the largest member count: ``run_ensemble`` with NUTS (the MAP
    search, then ``nuts_steps`` samples at ``nwalkers`` walkers) with the
    counters zeroed just before and read just after (the kernel launches, no fused kernel
    and no plain version runs), and a traced chunk of 5 samples in the
    saved space at 31 launches a sample.  On the CPU (a rehearsal at a
    small size) the plain version stands in for the kernel's calls, NUTS
    keeps the composition, and nothing is timed."""
    from linna_tpu_torch.ops import library as OL
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import run as R

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_composition as TC

    card = device.type == "cuda"
    res: dict = {"rows": list(rows), "members": {}}
    for k in members:
        lp, spec = TC.problem(device, ndim, ndata, k, ypositive=True, symmetric=False)
        x_in = TC.standardized(lp, TC.walkers(max(rows), ndim, device, seed=5))
        want_lp, want_g = TC.likelihood(spec, lp, x_in)
        smooth = TC.smooth_rows(spec, lp, x_in)
        rec: dict = {"smooth_rows": int(smooth.sum()), "by_rows": {}}
        for n in rows:
            OL.reset_counts()
            got_lp, got_g = lp._route.value_and_grad(x_in[:n])
            counts = _launch_counts()
            value_gap = float(((got_lp.double() - want_lp[:n]).abs()
                               / (TC.VALUE_ATOL + TC.VALUE_RTOL * want_lp[:n].abs())).max())
            gaps = TC.row_gaps(got_g, want_g[:n])
            held = gaps[smooth[:n]]
            r = {"value_gap_over_tolerance": value_gap,
                 "median_row_gradient_gap": float(gaps.median()),
                 "max_smooth_row_gradient_gap": float(held.max()) if held.numel() else None,
                 "counts": counts}
            if card:
                r["ms"], r["timing"] = kernel_ms(lambda: lp._route.value_and_grad(x_in[:n]),
                                                 KERNEL_NAMES["composition_grad"])
                r["bound"] = composition_bound_ms(spec, k, n)
                r["bound_ms"] = r["bound"]["ms"]
            rec["by_rows"][n] = r
            log(f"  6b K={k} rows={n}: {json.dumps(r, default=float)}")
            if not (value_gap <= 1.0 and r["median_row_gradient_gap"] < TC.MEDIAN_GRAD_RTOL
                    and (not held.numel() or r["max_smooth_row_gradient_gap"] < TC.GRAD_RTOL)):
                raise AssertionError(f"6b K={k} rows={n}: composition_grad is not the "
                                     f"composition: {r}")
            ran, idle = ("launches", "plain_calls") if card else ("plain_calls", "launches")
            if counts[ran]["composition_grad"] != 1 or any(counts[idle].values()):
                raise AssertionError(f"6b K={k} rows={n}: not one {ran[:-1]} of "
                                     f"composition_grad: {counts}")
        res["members"][k] = rec

    k = max(members)
    lp, _ = TC.problem(device, ndim, ndata, k, temperature=1.0)
    x0 = TC.walkers(nwalkers, ndim, device, seed=8, scale=0.05).cpu().numpy()
    d = os.path.join(outdir, "composition_nuts")
    trace: dict = {}
    OL.reset_counts()
    backend = R.run_ensemble(lp, x0, d, method="nuts", check_every=nuts_steps,
                             max_iterations=nuts_steps, convergence_check=False, seed=0,
                             device=device, trace_rec=trace)
    counts = _launch_counts()
    chain = backend.get_chain()
    if chain.shape != (nuts_steps, nwalkers, ndim) or not np.isfinite(chain).all():
        raise AssertionError(f"6b: NUTS through composition_grad: chain {chain.shape} is "
                             "not finite")
    _no_kernel(counts, f"6b: NUTS at K={k} through the composition", gradient_on_card=card)
    pre = R._load_precond(os.path.join(d, R.PRECOND_FILENAME))
    wrapped = pre.wrap_log_prob(lp)
    y = torch.as_tensor(pre.to_sampling(chain[-1]), dtype=torch.float32, device=device)
    state = hmc.init_nuts_state(torch.Generator(device=device).manual_seed(1), y, wrapped,
                                m_adapt=0)
    OL.reset_counts()
    chunk = lambda: hmc.nuts_chunk(wrapped, state, 5)
    if card:
        res["nuts_traced_chunk"] = traced_call(chunk, device)
    else:
        chunk()
    per_sample = OL.launches["composition_grad"] / 5
    res["nuts"] = {"members": k, "steps": nuts_steps, "counts": counts,
                   **_sampler_rate(trace, nuts_steps), "launches_per_traced_sample": per_sample}
    log(f"  6b: NUTS {json.dumps(res['nuts'], default=float)}")
    if card:
        log(f"  6b: traced chunk {json.dumps(res['nuts_traced_chunk'], default=float)}")
    if card and (per_sample != 2**5 - 1 or OL.plain_calls["composition_grad"]):
        raise AssertionError(f"6b: {per_sample} composition_grad launches per NUTS sample "
                             f"(not 31), {OL.plain_calls['composition_grad']} plain calls")
    return res


# ------------------------------------------------------------------ driver


def des_config(outdir, theory_mod, methods, temperatures, epochs, overrides=None):
    """``examples/des_synthetic.yaml`` cut to depth under ``outdir``: its
    first ``len(methods)`` iterations with these methods and temperatures,
    ``epochs`` epochs, convergence keys that pass at each sampler's second
    check (200 steps: the first compares with no earlier tau), outdir
    ``outdir/run``, and inputs written with ``theory_mod``'s functions, as
    ``examples/make_des_inputs.py`` writes them; ``overrides`` applied
    last.  Returns (params, the cut YAML's path, the cuts)."""
    import importlib

    import yaml

    from linna_tpu_torch.config import yaml_load

    T = importlib.import_module(theory_mod)
    inputs = os.path.join(outdir, "des_inputs")
    os.makedirs(inputs, exist_ok=True)
    truth = T.data_vector(T.fiducial() + 0.05)
    np.savetxt(os.path.join(inputs, "data.txt"), np.stack([np.arange(T.NDATA), truth], 1))
    np.savetxt(os.path.join(inputs, "cov_triplet.txt"), T.cov_triplet_rows(T.noise_sigma(truth)))

    params = yaml_load(os.path.join(ROOT, "examples", "des_synthetic.yaml"),
                       parent_dir=os.path.join(ROOT, "examples"))
    n_iter = len(methods)
    inf = [float("inf")] * n_iter
    cut = dict(methodArr=list(methods), temperatureArr=list(temperatures), num_epochs=epochs,
               ntimesArr=[0] * n_iter, ntautolArr=inf, meanshiftArr=inf, stdshiftArr=inf,
               outdir=os.path.join(outdir, "run"), base_dir=inputs)
    cuts = {"iterations": f"{len(params['ntrainArr'])} -> {n_iter} (the first {n_iter} of "
                          "every per-iteration list)"}
    cuts.update({k: f"{params[k]} -> {v}" for k, v in cut.items()})
    for k in ("ntrainArr", "nvalArr", "nkeepArr"):
        params[k] = params[k][:n_iter]
    params.update(cut)
    params.update(overrides or {})
    cuts.update({k: f"-> {v}" for k, v in (overrides or {}).items() if k not in cuts})
    log(f"  des_synthetic.yaml cut to depth: {json.dumps(cuts)}")
    cfg = os.path.join(outdir, "des_synthetic_cut.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(params, f)
    return params, cfg, cuts


def phase_driver(device, outdir, epochs=DRIVER_EPOCHS, timeout=DRIVER_TIMEOUT,
                 theory_mod="examples.des_theory", overrides=None,
                 exact=os.path.join(ROOT, "EXACT_POSTERIOR.json")) -> dict:
    """``python -m linna_tpu_torch.driver`` on ``examples/des_synthetic.yaml``
    with its depth cut: the first two iterations (methods zeus then nuts at
    T = 4 then 1), ``epochs`` epochs, convergence keys that pass at the
    sampler's second check (200 steps: the first compares with no earlier
    tau), outdir under the run directory.  The
    inputs are written with ``examples/des_theory.py``'s functions, as
    ``examples/make_des_inputs.py`` writes them.  Checks every iteration's
    artifacts, the chain stores, ``precond.npz``, ``time.npy`` and that
    training ran in bfloat16, and reports the posterior mean's offsets from
    the exact posterior (``EXACT_POSTERIOR.json``), not gated at this
    depth.  ``theory_mod``, ``overrides`` (applied after the cuts) and
    ``exact`` let a CPU rehearsal run the same phase at a small size."""
    import des_report
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.samplers import run as R

    params, cfg, cuts = des_config(outdir, theory_mod, ["zeus", "nuts"], [4.0, 1.0], epochs,
                                   overrides)
    n_iter = 2
    cmd = [sys.executable, "-m", "linna_tpu_torch.driver", "zeus", "None", cfg, "examples"]
    if device.type != "cuda":
        cmd += ["--device", str(device)]
    log(f"  running: {' '.join(cmd)}")
    t0 = time.perf_counter()
    # the driver imports the theory plugin from where this process does
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]))
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-6000:])
        raise AssertionError(f"the driver exited with {proc.returncode}")
    run_dir = params["outdir"]
    missing = [f"iter_{i}/{f}" for i in range(n_iter)
               for f in iteration_missing(os.path.join(run_dir, f"iter_{i}"), params["nensemble"])]
    for i, m in enumerate(params["methodArr"]):
        path = os.path.join(run_dir, f"iter_{i}", O._chain_filename(m))
        if not O._open_backend(path, m).exists():
            missing.append(f"iter_{i}/{O._chain_filename(m)}")
    missing += [f for f in (os.path.join(f"iter_{n_iter - 1}", R.PRECOND_FILENAME), "time.npy",
                            "trace.json") if not os.path.isfile(os.path.join(run_dir, f))]
    if missing:
        raise AssertionError(f"the driver left artifacts out: {missing}")
    # each iteration's kernels: none of the fused route's, no plain version,
    # and composition_grad (K=2 float32 sampling) where NUTS ran on the card
    with open(os.path.join(run_dir, "trace.json")) as f:
        mcmc = [r for r in json.load(f) if r["phase"] == "mcmc"]
    for r in mcmc:
        counts = {kind: {k: r["kernels"][kind][k] for k in PATH_KERNELS}
                  for kind in ("launches", "plain_calls")}
        _no_kernel(counts, f"7 (des_synthetic.yaml's iteration {r['iteration']}, {r['method']})",
                   gradient_on_card=device.type == "cuda" and r["method"] == "nuts")
    rep = des_report.report(run_dir, exact)
    dtypes = {r.get("compute_dtype") for r in rep["iterations"]}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"training ran in {dtypes}, not bfloat16")
    bias = rep["bias"]
    if not np.isfinite(bias["bias_sigma"]).all():
        raise AssertionError("the posterior mean is not finite")
    res = {"seconds": seconds, "cuts": cuts, "report": rep,
           "composition_grad_by_iteration": [[r["iteration"], r["method"],
                                              r["kernels"]["launches"]["composition_grad"]]
                                             for r in mcmc],
           "store": O._open_backend(des_report.final_chain_path(run_dir, n_iter, "nuts"),
                                    "nuts").path}
    log(f"  posterior-mean offsets from the exact posterior (sigma, reported, not gated at "
        f"this depth): max {bias['max_emulator_bias_sigma']:.3f}, median "
        f"{bias['median_emulator_bias_sigma']:.3f}")
    log(f"  driver: {json.dumps(res, default=float)}")
    return res


# ------------------------------------------- pre-model and bf16 inference


def _likelihood_counts(counter: dict) -> dict:
    """A kernel counter of ``ops.library`` cut to the kernels a likelihood
    path can reach (``PATH_KERNELS``): the trainer's AdamW kernel counts
    beside them on every path that trains."""
    return {k: counter[k] for k in PATH_KERNELS}


def _adamw_counts() -> dict:
    from linna_tpu_torch.ops import fused as F

    return {"launches": F.launches["adamw"], "plain_calls": F.plain_calls["adamw"]}


def _launch_counts():
    from linna_tpu_torch.ops import fused as F

    return {"launches": _likelihood_counts(F.launches),
            "plain_calls": _likelihood_counts(F.plain_calls)}


def _no_kernel(counts: dict, what: str, gradient_on_card: bool = False) -> None:
    """The path must reach neither fused kernel nor any plain version: the
    routing rule sends it to the composition, as in the JAX package.  The
    composition's own kernel, composition_grad, launches where the path
    asks the float32 Gaussian composition for a gradient on the card
    (``gradient_on_card``), and nowhere else."""
    from linna_tpu_torch.ops import fused as F

    launched = counts["launches"]
    if (any(launched[k] for k in F.LIKELIHOOD_KERNELS) or any(counts["plain_calls"].values())
            or bool(launched["composition_grad"]) != gradient_on_card):
        raise AssertionError(f"{what} reached a kernel (composition_grad expected to launch: "
                             f"{gradient_on_card}): {counts}")


def _sampler_rate(trace: dict, steps: int) -> dict:
    s = trace["sampler"]
    return {"s_per_100_steps": s["loop"] / steps * 100,
            "precond_s": s["precond"], "steps": steps}


def phase_premodel(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                   epochs=PREMODEL_EPOCHS, nensemble=PREMODEL_ENSEMBLE, nwalkers=NWALKERS,
                   nuts_steps=PREMODEL_NUTS, wrapper_rows=256) -> dict:
    """8a: one ``ml_sampler_core`` iteration on phase 5's seeded theory with
    ``linearmodel: {norder: 2}``, K members trained in bfloat16 and
    ``use_fused`` (which an ensemble with a pre-model does not reach), zeus
    at T = 1 stopped at its second tau check through the convergence keys;
    then ``linear_model.npz`` against a fit of the same rows, each member's
    learning, and ``retrieve_model_wrapper`` against the network plus the
    pre-model.  8b: member 0 with its pre-model: per-walker gradients, the
    MAP search and ``nuts_steps`` NUTS samples, and the Hessian at the MAP
    point through ``torch.func``.  Neither reaches a kernel."""
    import resource
    import tracemalloc

    import des_report
    import linna_tpu_torch as LT
    from linna_tpu_torch import data as D
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import linear_model as LM
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import run as R

    pb = seeded_problem(device, ndim, ndata)
    inf = float("inf")
    lm_cfg = {"norder": 2}
    params = {"trainingoption": 1, "nensemble": nensemble, "batch_size": 500,
              "num_epochs": epochs, "train_compute_dtype": "bfloat16", "linearmodel": lm_cfg,
              "use_fused": True}
    cuts = {"iterations": "4 -> 1 (iteration 0 at T = 1)", "nensemble": f"4 -> {nensemble}",
            "num_epochs": f"4500 -> {epochs}",
            "ntimesArr, ntautolArr, meanshiftArr, stdshiftArr":
                "-> [0], [inf], [inf], [inf]: zeus stops at its second tau check, 200 steps"}
    log(f"  8a: ml_sampler's schedule cut: {json.dumps(cuts)}")
    run_dir = os.path.join(outdir, "run")
    F.reset_counts()
    t0 = time.perf_counter()
    chain, logp = LT.ml_sampler_core(
        ntrainArr=[ntrain], nvalArr=[nval], nkeepArr=[2], ntimesArr=[0], ntautolArr=[inf],
        meanshiftArr=[inf], stdshiftArr=[inf], outdir=run_dir, theory=pb.theory,
        priors=pb.priors, data=pb.data, cov=pb.cov, init=pb.truth, pool=None,
        nwalkers=nwalkers, temperatureArr=[1.0], params=params, method="zeus", seed=3,
        device=device)
    pipeline_s = time.perf_counter() - t0
    counts = _launch_counts()
    _no_kernel(counts, "the pre-model pipeline")
    it0 = os.path.join(run_dir, "iter_0")
    lm_path = os.path.join(it0, O.LINEAR_MODEL_FILE)
    missing = iteration_missing(it0, nensemble, chain=True)
    if not os.path.isfile(lm_path):
        missing.append(O.LINEAR_MODEL_FILE)
    if missing:
        raise AssertionError(f"ml_sampler_core left artifacts out: {missing}")
    if chain.ndim != 2 or chain.shape[1] != ndim or not (np.isfinite(chain).all()
                                                         and np.isfinite(logp).all()):
        raise AssertionError(f"the pre-model chain {chain.shape} is not finite")

    # the saved pre-model: retrieval reloads it as saved, and a fit of the
    # same rows (timed, its numpy allocations traced) gives the same fields
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    saved = LM.load_linear_model(lm_path, device=device).arrays()
    if any(not np.array_equal(v, saved[k]) for k, v in model.linearmodel.arrays().items()):
        raise AssertionError("retrieve_model's pre-model differs from linear_model.npz")
    stack = D.load_curated_stack([it0])
    ts = T.load_transforms(os.path.join(it0, O.TRANSFORMS_FILE), device=device)
    refit_dir = os.path.join(outdir, "refit")
    os.makedirs(refit_dir, exist_ok=True)
    tracemalloc.start()
    t0 = time.perf_counter()
    refit = O._fit_or_load_linear_model(refit_dir, stack, ts, lm_cfg, device).arrays()
    fit_s = time.perf_counter() - t0
    fit_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    off = [k for k, v in refit.items() if not np.allclose(v, saved[k], rtol=1e-6, atol=0)]
    if off:
        raise AssertionError(f"linear_model.npz differs from a fit of the same rows: {off}")
    exact = all(np.array_equal(v, saved[k]) for k, v in refit.items())

    spec = N.make_model_spec("chto_v2", ndim, ndata)
    seeds = [1234 + 1000 * k for k in range(nensemble)]  # train_emulator's member seeds
    # learned: phase 5's rule against the untrained network, and below the
    # loss training starts from, the untrained network plus the pre-model
    initial = initial_val_losses(it0, spec, pb.data, pb.cov, seeds, device)
    start = initial_val_losses(it0, spec, pb.data, pb.cov, seeds, device,
                               linearmodel=model.linearmodel)
    best = best_val_losses(it0, nensemble)
    log(f"  8a: val loss per member: untrained network {initial}, with the pre-model "
        f"{start}, best {best}")
    bad = not_learned(best, initial) + [(m, b, s0) for m, (b, s0) in enumerate(zip(best, start))
                                        if not b < s0]
    if bad:
        raise AssertionError(f"members that did not learn (member, best, initial): {bad}")

    x = torch.as_tensor(P.transform_np(pb.pack, pb.rng.normal(size=(wrapper_rows, ndim)) * 0.5),
                        dtype=torch.float32, device=device)
    with torch.no_grad():
        got = O.retrieve_model_wrapper(it0, device=device)(x)
        mt = model.transforms
        x_in = mt.x_transform(x)
        net = N.apply_model(spec, model.params, x_in)
        manual = mt.y_data.inverse(mt.y_transform(net + model.linearmodel(x_in)))
        bare = mt.y_data.inverse(mt.y_transform(net))
    wrapper = compare(got, manual, f"retrieve_model_wrapper against network + pre-model, "
                                   f"{wrapper_rows} rows")
    if torch.allclose(got, bare):
        raise AssertionError("the wrapper's output does not change with the pre-model")

    with open(os.path.join(run_dir, "trace.json")) as f:
        trace = json.load(f)
    row = des_report.iterations(trace)[0]
    lm_s = next(r["linear_model_s"] for r in trace if r["phase"] == "train_emulator")
    rec = {
        "cuts": cuts, "pipeline_s": pipeline_s, "train_emulator_s": row["train_emulator_s"],
        "linear_model_s_in_train_emulator": lm_s, "fit_s": fit_s,
        "fit_traced_peak_bytes": fit_peak, "refit_bit_identical": exact,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "ms_per_epoch": row.get("ms_per_epoch"), "epochs_run": row.get("epochs_run"),
        "compute_dtype": row.get("compute_dtype"), "zeus_steps": row["steps"],
        "zeus_s_per_100_steps": row["s_per_100_steps"], "npc": int(saved["vec"].shape[0]),
        "monomials": int(saved["powers"].shape[0]), "initial_val_loss": initial,
        "start_val_loss_with_pre_model": start, "best_val_loss": best, "wrapper_check": wrapper, "counts": counts,
    }
    if device.type == "cuda":
        # what the pre-model costs a training epoch: chunks of the trained
        # members in bf16 with and without it, in turns, in this process
        rec["chunk_ms_per_epoch"] = {"with": [], "without": []}
        for tag in ("with", "without", "without", "with"):
            tr, rows, n = trained_ensemble_trainer(
                it0, pb.data, pb.cov, nensemble, 500, device, compute_dtype="bfloat16",
                linearmodel=model.linearmodel if tag == "with" else None)
            rec["chunk_ms_per_epoch"][tag].append(epoch_ms(tr, rows, n, device))
    log(f"  8a: {json.dumps(rec, default=float)}")

    # 8b: member 0 with its pre-model through the gradient path
    lp = LK.make_log_prob(model.spec, model.params, model.transforms, pb.pack, pb.data,
                          pb.inv_cov, temperature=1.0, linearmodel=model.linearmodel,
                          use_fused=True, device=device)
    last = O._open_backend(os.path.join(it0, O._chain_filename("zeus")), "zeus").get_chain()[-1]
    F.reset_counts()
    v, g = hmc.value_and_grad(lp, torch.as_tensor(last, dtype=torch.float32, device=device))
    if not (torch.isfinite(v).all() and torch.isfinite(g).all()):
        raise AssertionError("a per-walker gradient through the pre-model is not finite")
    trace_rec: dict = {}
    d = os.path.join(outdir, "nuts")
    backend = R.run_ensemble(lp, last, d, method="nuts", check_every=nuts_steps,
                             max_iterations=nuts_steps, convergence_check=False, seed=0,
                             device=device, trace_rec=trace_rec)
    chain = backend.get_chain()
    if chain.shape != (nuts_steps, nwalkers, ndim) or not np.isfinite(chain).all():
        raise AssertionError(f"NUTS through the pre-model: chain {chain.shape} is not finite")
    pre = R._load_precond(os.path.join(d, R.PRECOND_FILENAME))
    center = torch.as_tensor(pre.center, dtype=torch.float32, device=device)
    hess = torch.func.hessian(lambda z: lp._pure(z[None, :], lp._env)[0])(center)
    hess = hess.double().cpu().numpy()
    asym = float(np.abs(hess - hess.T).max() / np.abs(hess).max())
    if not np.isfinite(hess).all() or asym > 1e-3:
        raise AssertionError(f"the Hessian through the pre-model: finite "
                             f"{np.isfinite(hess).all()}, asymmetry {asym:.2e}")
    grad_counts = _launch_counts()
    _no_kernel(grad_counts, "NUTS through the pre-model")
    rec["gradient"] = {**_sampler_rate(trace_rec, nuts_steps), "hessian_asymmetry": asym,
                       "hessian_eig_min_max": [float(np.linalg.eigvalsh(-hess).min()),
                                               float(np.linalg.eigvalsh(-hess).max())],
                       "max_abs_grad": float(g.abs().max()), "counts": grad_counts}
    log(f"  8b: {json.dumps(rec['gradient'], default=float)}")
    return rec


def phase_bf16(device, trained_dir, nensemble=NENSEMBLE, ndim=NDIM, ndata=NDATA,
               walker_counts=BF16_WALKERS, zeus_steps=BF16_ZEUS_STEPS, nwalkers=NWALKERS) -> dict:
    """8c: bfloat16 inference on phase 5's trained ensemble and on its
    member 0: log-probs at T = 1 in bf16 against f32 at ``walker_counts``
    positions from phase 5's chain (float32 out, the same -inf rows,
    ``|dlp| / max(1, |lp_f32|) <= BF16_RTOL``), each call's device and call
    ms on the card, zeus for ``zeus_steps`` steps at T^2 = 16 in each type
    for K = 1 and K, and ``use_fused`` refusing ``compute_dtype``."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import run as R

    on_card = device.type == "cuda"
    pb = seeded_problem(device, ndim, ndata)
    model = O.retrieve_model(trained_dir, ndim, ndata, device=device)
    members = O.retrieve_ensemble_params(trained_dir, model)
    if len(members) != nensemble:
        raise AssertionError(f"{len(members)} trained members, not {nensemble}")
    chain = O._open_backend(os.path.join(trained_dir, O._chain_filename("zeus")),
                            "zeus").get_chain()
    pos = chain.reshape(-1, ndim)[-max(walker_counts):]
    if len(pos) < max(walker_counts):
        raise AssertionError(f"phase 5's chain holds {len(pos)} positions")
    configs = {f"K={nensemble}": members, "member 0": model.params}

    def make(params, cd, temperature=1.0, **kw):
        return LK.make_log_prob(model.spec, params, model.transforms, pb.pack, pb.data,
                                pb.inv_cov, temperature=temperature, compute_dtype=cd,
                                device=device, **kw)

    try:
        make(model.params, "bfloat16", use_fused=True)
    except ValueError as e:
        log(f"  8c: use_fused with compute_dtype raises ValueError: {e}")
    else:
        raise AssertionError("use_fused with compute_dtype did not raise")

    def errors(a, b, what):
        if b.dtype != torch.float32:
            raise AssertionError(f"{what}: bf16 output is {b.dtype}")
        a, b = a.double().cpu(), b.double().cpu()
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            raise AssertionError(f"{what}: the -inf rows differ")
        fin = torch.isfinite(a)
        if not torch.isfinite(b[fin]).all():
            raise AssertionError(f"{what}: bf16 is not finite where f32 is")
        rel = ((b - a).abs() / a.abs().clamp(min=1.0))[fin]
        out = {"max": float(rel.max()), "median": float(rel.median()),
               "-inf rows": int((~fin).sum())}
        log(f"  8c {what}: |dlp| / max(1, |lp_f32|) max {out['max']:.3e}, median "
            f"{out['median']:.3e} (bound {BF16_RTOL})")
        if out["max"] > BF16_RTOL:
            raise AssertionError(f"{what}: bf16 log-probs off by {out['max']:.3e}")
        return out

    F.reset_counts()
    rec: dict = {"log_prob": {}, "zeus": {}}
    with torch.no_grad():
        for name, params in configs.items():
            lp32, lp16 = make(params, None), make(params, "bfloat16")
            for n in walker_counts:
                x = torch.as_tensor(pos[-n:], dtype=torch.float32, device=device)
                r = {"rel_err": errors(lp32(x), lp16(x), f"{name} at {n} walkers")}
                if on_card:
                    for tag, fn in (("f32", lp32), ("bf16", lp16)):
                        r[f"{tag}_device_ms"], r[f"{tag}_device_timing"] = device_ms(lambda: fn(x))
                        r[f"{tag}_call_ms"] = call_ms(lambda: fn(x))
                    log(f"  8c {name} at {n} walkers: device ms f32 {r['f32_device_ms']:.4f} / "
                        f"bf16 {r['bf16_device_ms']:.4f}; call ms f32 {r['f32_call_ms']:.4f} / "
                        f"bf16 {r['bf16_call_ms']:.4f}")
                rec["log_prob"][f"{name} @{n}"] = r
        if on_card:
            # what the cuBLAS bf16 reductions (PyTorch's default) cost
            flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            try:
                x = torch.as_tensor(pos, dtype=torch.float32, device=device)
                rec["rel_err_f32_reductions"] = errors(
                    make(members, None)(x), make(members, "bfloat16")(x),
                    f"K={nensemble} at {len(pos)} walkers, bf16 products reduced in f32")
            finally:
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            a = torch.randn((64, 32), device=device, dtype=torch.bfloat16)
            try:
                out = torch.mm(a, a.T, out_dtype=torch.float32)
                rec["mm_out_dtype_float32"] = str(out.dtype)
            except (RuntimeError, TypeError, NotImplementedError) as e:
                rec["mm_out_dtype_float32"] = f"{type(e).__name__}: {str(e)[:120]}"
            log(f"  8c: torch.mm(bf16, bf16, out_dtype=torch.float32) on the card: "
                f"{rec['mm_out_dtype_float32']}")

    x0 = chain[-1]
    order = [("member 0", None), ("member 0", "bfloat16"), (f"K={nensemble}", "bfloat16"),
             (f"K={nensemble}", None)]
    for name, cd in order:
        trace: dict = {}
        calls = {"n": 0}
        lp = make(configs[name], cd, temperature=TEMPERATURE)

        def counted(x, lp=lp):
            calls["n"] += 1
            return lp(x)

        d = os.path.join(trained_dir, "bf16_zeus", f"{name}_{cd}".replace(" ", "_"))
        R.run_ensemble(counted, x0, d, method="zeus", check_every=zeus_steps,
                       max_iterations=zeus_steps, convergence_check=False, seed=0,
                       device=device, trace_rec=trace)
        rate = _sampler_rate(trace, zeus_steps)["s_per_100_steps"]
        if "graphs" in trace:  # the wrapper ran only while the graphs were captured
            calls["n"] = 1 + trace["graphs"]["calls"]
        per_step = calls["n"] / zeus_steps
        rec["zeus"][f"{name} {cd or 'float32'}"] = {
            "s_per_100_steps": rate, "calls_per_step": per_step,
            "ms_per_call": rate * 10 / per_step}
        log(f"  8c zeus {name} in {cd or 'float32'}: {rate:.3f} s / 100 steps at "
            f"{len(x0)} walkers, {per_step:.1f} likelihood calls a step")
    rec["counts"] = _launch_counts()
    _no_kernel(rec["counts"], "bf16 inference")
    log(f"  8c: {json.dumps(rec, default=float)}")
    return rec


# ------------------------------------------------ the multi-process layer


class WriteAudit:
    """Every write-mode open, mkdir, rename and removal under ``root`` in
    this process, from Python's audit events (``sys.addaudithook``)."""

    def __init__(self, root: str):
        self.root = os.path.realpath(root)
        self.seen: list = []
        sys.addaudithook(self)

    def __call__(self, event, args):
        if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)):
            mode, flags = args[1], args[2] if len(args) > 2 else 0
            if (mode is not None and any(c in str(mode) for c in "wax+")) or (
                    isinstance(flags, int) and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
                self._note(event, args[0])
        elif event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir", "shutil.rmtree"):
            self._note(event, args[0])

    def _note(self, event, path) -> None:
        path = os.fsdecode(path) if isinstance(path, (str, bytes)) else os.fspath(path)
        if os.path.realpath(path).startswith(self.root):
            self.seen.append(f"{event} {path}")


# one rank of ``python -m linna_tpu_torch.launch``, with its writes under the
# run directory and its counters dumped at exit (argv: report, run dir, the
# launch module's arguments)
AUDITED_LAUNCH = """
import atexit, json, runpy, sys
sys.path.insert(0, {root!r})
from chip_smoke import WriteAudit
report, audit = sys.argv[1], WriteAudit(sys.argv[2])

def dump():
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel import multihost as MH
    with open(report, "w") as f:
        json.dump({{"writes": audit.seen, "launches": dict(F.launches),
                   "collectives": MH.collective_counts()}}, f)

atexit.register(dump)
sys.argv = ["linna_tpu_torch.launch"] + sys.argv[3:]
runpy.run_module("linna_tpu_torch.launch", run_name="__main__", alter_sys=True)
"""


def fused_problem(device, ndim=NDIM, ndata=NDATA, nwalkers=NWALKERS, temperature=TEMPERATURE):
    """Phase 3's random-weight DES-width problem through ``fused_log_prob``
    (``use_fused=True``) and seeded walkers around the origin."""
    from linna_tpu_torch import likelihood as LK

    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    lp = LK.make_log_prob(spec, params, ts, pack, data, inv_cov, temperature=temperature,
                          use_fused=True, device=device)
    x0 = 0.1 * np.random.default_rng(4).standard_normal((nwalkers, ndim))
    return lp, x0


def sample(log_prob, x0, outdir, method, steps, device) -> dict:
    """``run_ensemble`` for ``steps`` steps with no convergence test; the
    stored chain and log-probs, this process's launches and collectives,
    and s / 100 steps."""
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel import multihost as MH
    from linna_tpu_torch.samplers import run as R

    F.reset_counts()
    MH.reset_collective_counts()
    trace: dict = {}
    backend = R.run_ensemble(log_prob, x0, outdir, method=method, check_every=steps,
                             max_iterations=steps, convergence_check=False, seed=0,
                             device=device, trace_rec=trace)
    MH.barrier("sampled")
    rec = {"launches": _likelihood_counts(F.launches),
           "plain_calls": _likelihood_counts(F.plain_calls),
           "collectives": MH.collective_counts(), "steps": steps,
           "s_per_100_steps": _sampler_rate(trace, steps)["s_per_100_steps"],
           "sampler_s": trace["sampler"]}
    return rec, backend


def phase_nccl(device, outdir, steps=MP_EMCEE_STEPS, ndim=NDIM, ndata=NDATA,
               nwalkers=NWALKERS) -> dict:
    """9a: a process group of one rank (nccl on a card, gloo on the CPU):
    ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` of device
    tensors and float64 through the byte broadcast, then emcee through
    ``fused_log_prob`` for ``steps`` steps, bit for bit the chain of the same
    run without a process group."""
    from linna_tpu_torch.parallel import mesh as ME
    from linna_tpu_torch.parallel import multihost as MH

    backend = "nccl" if device.type == "cuda" else "gloo"
    lp, x0 = fused_problem(device, ndim, ndata, nwalkers)
    alone, b0 = sample(lp, x0, os.path.join(outdir, "alone"), "emcee", steps, device)
    if MH.initialize(f"localhost:{free_port()}", 1, 0, backend=backend, device=device):
        raise AssertionError("one rank expected")
    try:
        if MH.backend() != backend or MH.process_count() != 1:
            raise AssertionError(f"backend {MH.backend()}, world {MH.process_count()}")
        MH.reset_collective_counts()
        t = torch.arange(6.0, device=device)
        checks = {
            "all_reduce": torch.equal(MH.all_reduce(t.clone()), t),
            "all_gather": torch.equal(MH.all_gather(t)[0], t),
            "broadcast": bool(np.array_equal(MH.broadcast(np.array([1.0 + 2.0**-52])),
                                             [1.0 + 2.0**-52])),
            "broadcast_from_primary": MH.broadcast_from_primary(
                lambda: {"v": np.array([1.0 + 2.0**-52])})["v"][0] == 1.0 + 2.0**-52,
            "fetch": bool(np.array_equal(MH.fetch(t.reshape(6, 1), ME.walker_shard(6), 0),
                                         t.reshape(6, 1).cpu().numpy())),
        }
        MH.barrier("9a")
        checks["barrier"] = True
        tensors_on = str(t.device)
        counts = MH.collective_counts()
        if not all(checks.values()) or not all(counts.get(f"{k}@world") for k in (
                "all_reduce", "all_gather", "broadcast", "barrier")):
            raise AssertionError(f"collectives on one rank: {checks}, {counts}")
        grouped, b1 = sample(lp, x0, os.path.join(outdir, "grouped"), "emcee", steps, device)
    finally:
        MH.shutdown()
    equal = all(np.array_equal(a, b) for a, b in (
        (b0.get_chain(), b1.get_chain()), (b0.get_log_prob(), b1.get_log_prob())))
    if not equal:
        raise AssertionError("emcee under a one-rank process group differs from the run without")
    if device.type == "cuda" and grouped["launches"]["fused_log_prob"] == 0:
        raise AssertionError("fused_log_prob did not launch under the process group")
    res = {"backend": backend, "tensors_on": tensors_on, "checks": checks,
           "collectives": counts, "emcee_equal_bit_for_bit": equal, "alone": alone,
           "grouped": grouped}
    log(f"  9a: {json.dumps(res, default=float)}")
    return res


def phase_launch(device, outdir, epochs=MP_EPOCHS, nensemble=MP_ENSEMBLE,
                 theory_mod="examples.des_theory", overrides=None, timeout=MP_TIMEOUT) -> dict:
    """9b: ``python -m linna_tpu_torch.launch`` as two ranks sharing the
    device through gloo, on ``des_synthetic.yaml`` cut to one iteration
    (zeus at T = 4 to its second tau check, K = ``nensemble`` trained for
    ``epochs`` epochs: ens 2 x data 1).  Rank 1 must write nothing under the
    run directory; the directory then loads in this process and its stored
    log-probs are the one-process likelihood's."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.driver import _load_data_cov, priors_and_init_from_config

    params, cfg, cuts = des_config(outdir, theory_mod, ["zeus"], [4.0], epochs,
                                   {"nensemble": nensemble, **(overrides or {})})
    run_dir = params["outdir"]
    os.makedirs(run_dir, exist_ok=True)
    script = AUDITED_LAUNCH.format(root=ROOT)
    reports = [os.path.join(outdir, f"audit_{k}.json") for k in range(2)]
    cmds = [[sys.executable, "-c", script, reports[k], run_dir, "zeus", cfg, "examples",
             "--device", str(device), "--backend", "gloo"] for k in range(2)]
    t0 = time.perf_counter()
    outs = run_ranks(cmds, os.path.join(outdir, "logs"), timeout)
    seconds = time.perf_counter() - t0
    for k, out in enumerate(outs):
        for want in (f"process {k}/2: device {device}, backend gloo",
                     f"process {k} driver finished rc=0"):
            if want not in out:
                raise AssertionError(f"rank {k} did not print {want!r}")
    audits = []
    for path in reports:
        with open(path) as f:
            audits.append(json.load(f))
    if audits[1]["writes"]:
        raise AssertionError(f"rank 1 wrote under the run directory: {audits[1]['writes'][:10]}")
    if not audits[0]["writes"]:
        raise AssertionError("rank 0 wrote nothing")
    it0 = os.path.join(run_dir, "iter_0")
    missing = iteration_missing(it0, nensemble, chain=True)
    missing += [f for f in ("time.npy", "trace.json")
                if not os.path.isfile(os.path.join(run_dir, f))]
    if missing:
        raise AssertionError(f"the two-rank run left artifacts out: {missing}")

    # the directory in one process: the stored log-probs at the stored
    # points against the retrieved ensemble's likelihood
    data, cov, _, _ = _load_data_cov(params)
    priors, _ = priors_and_init_from_config(params)
    pack = P.priors_from_list(priors, device)
    ndim, ndata = len(priors), len(data)
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    members = O.retrieve_ensemble_params(it0, model)
    if len(members) != nensemble:
        raise AssertionError(f"{len(members)} members retrieved, not {nensemble}")
    lp = LK.make_log_prob(model.spec, members, model.transforms, pack, data, np.linalg.inv(cov),
                          temperature=16.0, device=device)
    store = O._open_backend(os.path.join(it0, O._chain_filename("zeus")), "zeus")
    samples, lps = store.get_chain(), store.get_log_prob()
    if samples.shape[1:] != (params["nwalkers"], ndim) or not np.isfinite(samples).all():
        raise AssertionError(f"chain {samples.shape} is not finite")
    with torch.no_grad():
        check = compare(torch.as_tensor(lps[-1]),
                        lp(torch.as_tensor(samples[-1], dtype=torch.float32, device=device)),
                        "9b stored log-probs vs one-process make_log_prob")
    with open(os.path.join(run_dir, "trace.json")) as f:
        trace = json.load(f)
    res = {"seconds": seconds, "cuts": cuts, "steps": int(samples.shape[0]),
           "writes_rank0": len(audits[0]["writes"]), "writes_rank1": 0,
           "launches": [a["launches"] for a in audits],
           "collectives": [a["collectives"] for a in audits], "log_prob_check": check,
           "phases": {r["phase"]: r["seconds"] for r in trace}}
    log(f"  9b: {json.dumps(res, default=float)}")
    return res


def first_step_moment(device, one: str, pb, mesh=None) -> np.ndarray:
    """The first moment after one AdamW step at lr 0 from zero moments:
    0.1 x the gradient of the iteration's first 500 rows (a minibatch),
    member seed 1234
    (one rank without ``mesh``; the ranks of a K=1 mesh sum their halves)."""
    from linna_tpu_torch import data as D
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

    stack = D.load_curated_stack([one])
    ts = T.load_transforms(os.path.join(one, O.TRANSFORMS_FILE), device=device)
    spec = N.make_model_spec("chto_v2", stack.train_x.shape[1], stack.train_y.shape[1])
    tr = EnsembleTrainer(spec, ts, L.build_loss_state(pb.data, pb.cov, ts), [None], [1234],
                         mesh=mesh, device=device)
    data = tr._prepare(stack.train_x, stack.train_y)
    zero = torch.zeros((1, 1), device=device)
    rows = min(500, len(stack.train_x))
    tr._step(data, torch.arange(rows, device=device)[None], tr.opt, zero, zero)
    return tr._gather([tr.opt.mu], [0])[0]


def dp_rank(outdir: str, device_name: str) -> int:
    """One rank of 9c (``chip_smoke.py --data-parallel-rank OUTDIR DEVICE``):
    K=1 training over the two data ranks to each depth, sharded emcee and
    NUTS through ``fused_log_prob``, and the census; its record to
    ``OUTDIR/rank_<k>.json``."""
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel import census as CE
    from linna_tpu_torch.parallel import multihost as MH

    device = torch.device(device_name)
    MH.initialize(backend="gloo", device=device)
    rank = MH.process_index()
    with open(os.path.join(outdir, "config.json")) as f:
        cfg = json.load(f)
    pb = seeded_problem(device, cfg["ndim"], cfg["ndata"])
    rec: dict = {"rank": rank, "world": MH.process_count(), "backend": MH.backend()}
    # gloo's collectives of device tensors (the sharded samplers' and the
    # trainer's), checked for their values
    t = torch.full((4,), float(rank + 1), device=device)
    rec["gloo_device_collectives"] = {
        "all_gather": [float(x[0]) for x in MH.all_gather(t)],
        "all_reduce": float(MH.all_reduce(t.clone())[0]),
        "on": str(t.device),
    }
    if rec["gloo_device_collectives"]["all_gather"] != [1.0, 2.0] or \
            rec["gloo_device_collectives"]["all_reduce"] != 3.0:
        raise AssertionError(f"gloo collectives: {rec['gloo_device_collectives']}")
    from linna_tpu_torch.parallel.mesh import make_ensemble_mesh

    mu = first_step_moment(device, dp_dir(outdir, "one", cfg["depths"][-1]), pb,
                           make_ensemble_mesh(1))
    if rank == 0:
        np.save(os.path.join(outdir, "first_moment_two.npy"), mu)
    for epochs in cfg["depths"]:
        F.reset_counts()
        MH.reset_collective_counts()
        t0 = time.perf_counter()
        it0 = dp_dir(outdir, "two", epochs)
        O.train_emulator(it0, [it0], pb.data, pb.cov, pb.sigma, None, False, "chto_v2",
                         {"nensemble": 1, "num_epochs": epochs, "batch_size": 500},
                         device=device)
        rec["train"] = {"epochs": epochs, "seconds": time.perf_counter() - t0,
                        "collectives": MH.collective_counts(), "launches": dict(F.launches)}
    lp, x0 = fused_problem(device, cfg["ndim"], cfg["ndata"], cfg["nwalkers"])
    for method, steps in (("emcee", cfg["steps"]), ("nuts", cfg["nuts_steps"])):
        rec[method], _ = sample(lp, x0, os.path.join(outdir, "two", method), method, steps,
                                device)
    rec["census"] = {
        "sampler": CE.sampler_collective_census(log_prob_fn=lp, ndim=cfg["ndim"],
                                                walkers=cfg["nwalkers"], device=device),
        "trainer_k1": CE.trainer_collective_census(k=1, device=device),
        "trainer_k2": CE.trainer_collective_census(k=2, device=device),
    }
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f, default=float)
    MH.barrier("9c")
    MH.shutdown()
    return 0


def _predict(it0: str, x: np.ndarray, device) -> np.ndarray:
    from linna_tpu_torch import orchestrator as O

    with torch.no_grad():
        return O.retrieve_model_wrapper(it0, device=device)(x).cpu().numpy().astype(np.float64)


def dp_dir(outdir: str, who: str, epochs: int) -> str:
    """9c's iteration directory of ``who`` (one, again, two) trained for
    ``epochs`` epochs."""
    return os.path.join(outdir, f"{who}_{epochs}", "iter_0")


def phase_data_parallel(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                        depths=DP_DEPTHS, nwalkers=NWALKERS, steps=EMCEE_STEPS,
                        nuts_steps=DP_NUTS, timeout=MP_TIMEOUT) -> dict:
    """9c: two ranks sharing the device through gloo, against one rank in
    this process: K=1 training on phase 5's rows to each of ``depths``
    epochs (ens 1 x data 2, the learning rate of the deepest one-rank run's
    range test; one rank trains the deepest run twice, to show how far one
    rank repeats itself), emcee and NUTS sharded over the walkers through
    ``fused_log_prob``, and the census."""
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import sample_gen as SG

    pb = seeded_problem(device, ndim, ndata)
    rows = os.path.join(outdir, "rows")
    SG.generate_training_point(pb.theory, SG.NNSampler(rows, P.prior_range(pb.pack)), None,
                               rows, ntrain, nval, pb.data, pb.inv_cov)
    last = depths[-1]
    runs = [("one", last), ("again", last)] + [("one", e) for e in depths[:-1]] \
        + [("two", e) for e in depths]
    for who, e in runs:
        shutil.copytree(rows, dp_dir(outdir, who, e))
    train_one_s = {}
    for who, e in runs:
        if who == "two":
            continue
        if (who, e) != ("one", last):
            shutil.copy(os.path.join(dp_dir(outdir, "one", last), "lr.npy"),
                        dp_dir(outdir, who, e))
        t0 = time.perf_counter()
        it0 = dp_dir(outdir, who, e)
        O.train_emulator(it0, [it0], pb.data, pb.cov, pb.sigma, None, False, "chto_v2",
                         {"nensemble": 1, "num_epochs": e, "batch_size": 500}, device=device)
        train_one_s[f"{who}_{e}"] = time.perf_counter() - t0
    for e in depths:
        shutil.copy(os.path.join(dp_dir(outdir, "one", last), "lr.npy"),
                    dp_dir(outdir, "two", e))
    lp, x0 = fused_problem(device, ndim, ndata, nwalkers)
    ref = {m: sample(lp, x0, os.path.join(outdir, "one", m), m, n, device)
           for m, n in (("emcee", steps), ("nuts", nuts_steps))}
    # does a row's result depend on the rows launched beside it, in blocks
    # of the sharded half-updates' size?  emcee reads the log-prob, NUTS the
    # log-prob and its gradient in the preconditioned space
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import run as R

    pre = R._load_precond(os.path.join(outdir, "one", "nuts", R.PRECOND_FILENAME))
    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    block = nwalkers // 4
    whole = [hmc.value_and_grad(lp, x)[0], *hmc.value_and_grad(pre.wrap_log_prob(lp), x)]
    parts = [hmc.value_and_grad(lp, x[i:i + block])[0] for i in range(0, nwalkers, block)]
    wparts = [hmc.value_and_grad(pre.wrap_log_prob(lp), x[i:i + block])
              for i in range(0, nwalkers, block)]
    row_independent = {
        "emcee": bool(torch.equal(whole[0], torch.cat(parts))),
        "nuts": bool(torch.equal(whole[1], torch.cat([v for v, _ in wparts]))
                     and torch.equal(whole[2], torch.cat([g for _, g in wparts]))),
    }
    with open(os.path.join(outdir, "config.json"), "w") as f:
        json.dump({"ndim": ndim, "ndata": ndata, "nwalkers": nwalkers, "steps": steps,
                   "nuts_steps": nuts_steps, "depths": list(depths)}, f)
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--data-parallel-rank", outdir,
           str(device)]
    t0 = time.perf_counter()
    run_ranks([cmd, cmd], os.path.join(outdir, "logs"), timeout)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for k in range(2):
        with open(os.path.join(outdir, f"rank_{k}.json")) as f:
            ranks.append(json.load(f))

    # training: one step's gradient (f32), then the best checkpoints at
    # each depth, whose trajectories part as the steps' rounding grows; one
    # rank against itself at the last depth
    mu1 = first_step_moment(device, dp_dir(outdir, "one", last), pb)
    mu2 = np.load(os.path.join(outdir, "first_moment_two.npy"))
    vx = np.loadtxt(os.path.join(rows, "val_samples_x.txt"))

    def apart(a, b) -> dict:
        ia, ib = dp_dir(outdir, *a), dp_dir(outdir, *b)
        pa, pb_ = _predict(ia, vx, device), _predict(ib, vx, device)
        la, lb = best_val_losses(ia, 1)[0], best_val_losses(ib, 1)[0]
        d = np.abs(pb_ - pa) / pa.std(axis=0)
        return {"pred_diff_over_pred_std": {"max": float(d.max()), "median": float(np.median(d))},
                "best_val_loss": [la, lb], "best_val_rel_diff": abs(lb / la - 1)}

    train = {"first_step_grad_max_diff_over_max": float(np.max(np.abs(mu2 - mu1))
                                                        / np.max(np.abs(mu1))),
             "two_vs_one": {e: apart(("one", e), ("two", e)) for e in depths},
             "one_vs_one_again": apart(("one", last), ("again", last)),
             "one_rank_s": train_one_s,
             "tolerance": {"first_step": DP_GRAD_RTOL,
                           "epoch_1_pred": [DP_EPOCH1_MAX, DP_EPOCH1_MEDIAN],
                           "best_val": DP_TRAIN_RTOL}}
    failures = []
    first = train["two_vs_one"][depths[0]]["pred_diff_over_pred_std"]
    if depths[0] != 1 or first["max"] > DP_EPOCH1_MAX or first["median"] > DP_EPOCH1_MEDIAN:
        failures.append("two data ranks' best checkpoint after one epoch is apart from one "
                        "rank's")
    if not (train["first_step_grad_max_diff_over_max"] <= DP_GRAD_RTOL
            and train["two_vs_one"][last]["best_val_rel_diff"] <= DP_TRAIN_RTOL):
        failures.append("two data ranks trained apart from one rank")

    # the samplers against one rank: bit for bit where a row's result does
    # not depend on the rows beside it.  Else emcee, whose accept tests
    # part only where a log-prob's last bits cross the uniform, stays
    # within RTOL/ATOL at every sample; NUTS parts, so its first sample
    # holds most walkers and its second half the same moments
    chains = {}
    for m, (one_rec, one_store) in ref.items():
        two_store = O._open_backend(os.path.join(outdir, "two", m, O._chain_filename(m)), m)
        c1, c2 = one_store.get_chain(), two_store.get_chain()
        l1, l2 = one_store.get_log_prob(), two_store.get_log_prob()
        same = bool(np.array_equal(c1, c2) and np.array_equal(l1, l2))
        t1, t2 = (c[len(c) // 2:].reshape(-1, ndim) for c in (c1, c2))
        moved = np.abs(t2.mean(axis=0) - t1.mean(axis=0)) / t1.std(axis=0)
        close = np.isclose(c2, c1, rtol=RTOL, atol=ATOL).all(axis=2) & \
            np.isclose(l2, l1, rtol=RTOL, atol=ATOL)
        by_sample = (~close).sum(axis=1)
        chains[m] = {"bit_for_bit": same, "max_abs_chain_diff": float(np.max(np.abs(c1 - c2))),
                     "max_abs_log_prob_diff": float(np.max(np.abs(l1 - l2))),
                     "walkers_apart_by_sample": [int(n) for n in by_sample],
                     "max_mean_diff_over_std": float(moved.max()),
                     "one_rank_s_per_100_steps": one_rec["s_per_100_steps"],
                     "two_rank_s_per_100_steps": [r[m]["s_per_100_steps"] for r in ranks],
                     "launches": {"one": one_rec["launches"],
                                  "ranks": [r[m]["launches"] for r in ranks]},
                     "collectives_rank0": ranks[0][m]["collectives"]}
        if not np.isfinite(c2).all() or c2.shape != c1.shape:
            failures.append(f"{m}: the two-rank chain {c2.shape} is not finite")
        if row_independent[m] and not same:
            failures.append(f"{m}: rows are independent, but two ranks' chain differs")
        if m == "emcee" and device.type == "cuda" and not row_independent[m]:
            failures.append("emcee: fused_log_prob's value for a row depends on the rows "
                            "launched beside it")
        if m == "emcee" and by_sample.max():
            failures.append(f"emcee: walkers apart from one rank's by sample {by_sample}")
        if m == "nuts" and (by_sample[0] > DP_NUTS_FIRST_APART * nwalkers
                            or chains[m]["max_mean_diff_over_std"] > DP_MEAN_SIGMA):
            failures.append(f"nuts: {by_sample[0]} walkers apart at the first sample, the "
                            f"means {chains[m]['max_mean_diff_over_std']} std apart")
        if device.type == "cuda" and not all(r[m]["launches"]["fused_log_prob"] for r in ranks):
            failures.append(f"{m}: fused_log_prob did not launch on every rank")

    census = {k: ranks[0]["census"][k] for k in ranks[0]["census"]}
    s = census["sampler"]
    for m, want in (("emcee", 2), ("zeus", 2), ("hmc", 0), ("nuts", 0)):
        if sum(s[m]["per_step"].values()) > want:
            failures.append(f"census: {m} makes {s[m]['per_step']} collectives a step")
    k1, k2 = census["trainer_k1"], census["trainer_k2"]
    if (k1["per_step"] != {"all_reduce@data[0,1]": 1.0} or k2["per_step"]
            or k1["cross_member_collectives"] or k2["cross_member_collectives"]):
        failures.append("census of the trainer")
    res = {"gloo_device_collectives": ranks[0]["gloo_device_collectives"],
           "row_independent": row_independent, "train": train, "chains": chains,
           "census": census, "ranks_s": ranks_s,
           "train_collectives_rank0": ranks[0]["train"]["collectives"],
           "train_s": [r["train"]["seconds"] for r in ranks]}
    log(f"  9c: {json.dumps(res, default=float)}")
    if failures:
        raise AssertionError(f"9c: {failures}")
    return res


def phase_multiprocess(device, outdir) -> dict:
    """Phase 9: 9a, 9b and 9c."""
    res = {}
    for key, fn in (("9a", phase_nccl), ("9b", phase_launch), ("9c", phase_data_parallel)):
        t0 = time.perf_counter()
        res[key] = fn(device, os.path.join(outdir, key))
        res[key + "_s"] = time.perf_counter() - t0
        log(f"  {key}: {res[key + '_s']:.1f} s")
    return res

# ------------------------------------------------- phase 10: the rest of the port


def phase10_rows(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                 batch=TP_BATCH) -> dict:
    """Phase 5's seeded rows (the same theory, priors and Latin hypercube),
    their fitted transforms, a fixed epoch permutation and the minibatch
    size, written once to ``outdir/inputs.npz`` for 10a's ranks and read by
    10a and 10b."""
    from linna_tpu_torch import data as D
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import sample_gen as SG
    from linna_tpu_torch import transforms as T

    pb = seeded_problem(device, ndim, ndata)
    it0 = os.path.join(outdir, "rows")
    SG.generate_training_point(pb.theory, SG.NNSampler(it0, P.prior_range(pb.pack)), None, it0,
                               ntrain, nval, pb.data, pb.inv_cov)
    s = D.load_curated_stack([it0])
    xt = T.fit_x_transform(s.train_x, device="cpu")
    yt = T.fit_y_transform(s.train_y / pb.sigma, device="cpu")
    inputs = {"tx": s.train_x, "ty": s.train_y, "vx": s.val_x, "vy": s.val_y,
              "x_mean": xt.mean.numpy(), "x_std": xt.std.numpy(), "y_mean": yt.mean.numpy(),
              "y_std": yt.std.numpy(), "sigma": pb.sigma, "data": pb.data, "cov": pb.cov,
              "perm": np.random.default_rng(7).permutation(len(s.train_x)),
              "batch": np.int64(batch)}
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    return inputs


def _tp_problem(inputs, device):
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import transforms as T

    f32 = lambda k: torch.as_tensor(np.asarray(inputs[k]), dtype=torch.float32, device=device)
    ndim, ndata = inputs["tx"].shape[1], inputs["ty"].shape[1]
    ts = T.TransformSet(
        T.XTransform(f32("x_mean"), f32("x_std"), torch.zeros(ndim, dtype=torch.bool,
                                                              device=device)),
        T.YTransform(f32("y_mean"), f32("y_std"), False), T.YTransformData(f32("sigma")))
    return (N.make_model_spec("chto_v2", ndim, ndata), ts,
            L.build_loss_state(inputs["data"], inputs["cov"], ts))


def tp_epoch_run(inputs, device, n_model=None) -> dict:
    """One tensor-parallel epoch (``parallel/dtrain``) from
    ``init_sharded(TP_SEED)`` with the inputs' permutation, over the current
    process group's grid (no group: one rank's whole step): its batch
    losses, validation metric, whole parameters after it (flattened), and
    ms a step (the epoch's wall over its steps, between synchronizes)."""
    from linna_tpu_torch.parallel import dtrain as DT
    from linna_tpu_torch.parallel import mesh as ME
    from linna_tpu_torch.train import _walk

    spec, ts, ls = _tp_problem(inputs, device)
    mesh = ME.make_mesh(n_model)
    opt = DT.adamw(TP_LR)
    params, state = DT.init_sharded(TP_SEED, spec, opt, mesh, device=device)
    epoch = DT.make_sharded_epoch(spec, ts, ls, opt, mesh, int(inputs["batch"]))
    rows = [torch.as_tensor(np.asarray(inputs[k]), dtype=torch.float32, device=device)
            for k in ("tx", "ty", "vx", "vy")]
    _sync(device)
    t0 = time.perf_counter()
    params, state, losses, vm = epoch(params, state, inputs["perm"], *rows)
    _sync(device)
    seconds = time.perf_counter() - t0
    full = DT.gather_params(spec, params, mesh)
    return {"losses": losses.cpu().numpy(), "val_metric": vm.cpu().numpy(),
            "params": np.concatenate([a.reshape(-1) for _, a in _walk(full)]),
            "ms_per_step": seconds / len(losses) * 1e3, "mesh": mesh.shape}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tp_rank(outdir: str, device_name: str) -> int:
    """One rank of 10a (``chip_smoke.py --tensor-parallel-rank OUTDIR
    DEVICE``): the tensor-parallel epoch on data 1 x model 2 and the census
    of one step; rank 0 writes ``OUTDIR/ranks.npz`` and each rank
    ``OUTDIR/rank_<k>.json``."""
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel import census as CE
    from linna_tpu_torch.parallel import multihost as MH

    device = torch.device(device_name)
    MH.initialize(backend="gloo", device=device)
    rank = MH.process_index()
    with np.load(os.path.join(outdir, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    F.reset_counts()
    MH.reset_collective_counts()
    res = tp_epoch_run(inputs, device, n_model=2)
    rec = {"rank": rank, "ms_per_step": res["ms_per_step"], "mesh": res["mesh"],
           "epoch_collectives": MH.collective_counts(), "launches": dict(F.launches)}
    loss1, grad1 = tp_first_step(inputs, device, n_model=2)
    ndim, ndata = inputs["tx"].shape[1], inputs["ty"].shape[1]
    rec["census"] = CE.tensor_parallel_census(2, ndim=ndim, ndata=ndata,
                                              batch=int(inputs["batch"]), device=device)
    if rank == 0:
        np.savez(os.path.join(outdir, "ranks.npz"), first_loss=loss1, first_grad=grad1,
                 **{k: res[k] for k in ("losses", "val_metric", "params")})
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f, default=float)
    MH.barrier("10a")
    MH.shutdown()
    return 0


def tp_first_step(inputs, device, n_model=None) -> tuple:
    """One tensor-parallel step from ``init_sharded(TP_SEED)`` on the
    epoch's first minibatch at learning rate 0: its loss and the whole
    gradient (10 x the first moment, gathered from every rank's blocks)."""
    from linna_tpu_torch.parallel import dtrain as DT
    from linna_tpu_torch.parallel import mesh as ME
    from linna_tpu_torch.train import _walk

    spec, ts, ls = _tp_problem(inputs, device)
    mesh = ME.make_mesh(n_model)
    opt = DT.adamw(0.0, 0.0)
    params, state = DT.init_sharded(TP_SEED, spec, opt, mesh, device=device)
    rows = inputs["perm"][: int(inputs["batch"])]
    step = DT.make_sharded_train_step(spec, ts, ls, opt, mesh)
    _, state, loss = step(params, state, inputs["tx"][rows], inputs["ty"][rows])
    leaves = [v for _, v in _walk(params)]
    mu = torch.split(state.mu[0], [v.numel() for v in leaves])
    tree = DT._rebuild(params, (m.view_as(v) for m, v in zip(mu, leaves)))
    full = DT.gather_params(spec, tree, mesh)
    return float(loss), 10.0 * np.concatenate([a.reshape(-1) for _, a in _walk(full)])


def params_apart(got: np.ndarray, want: np.ndarray, steps: int) -> dict:
    """How far two runs' parameters after ``steps`` AdamW steps are apart:
    the largest and median difference, and the share of elements further
    than 1e-5; ``limit_max``, twice the learning rate a step, bounds the
    largest."""
    d = np.abs(got.astype(np.float64) - want)
    return {"max": float(d.max()), "median": float(np.median(d)),
            "share_over_1e-5": float(np.mean(d > 1e-5)), "limit_max": 2 * TP_LR * steps}


def phase_tensor_parallel(device, outdir, inputs, timeout=MP_TIMEOUT) -> dict:
    """10a: tensor-parallel training as two gloo ranks sharing the card
    (data 1 x model 2) against one rank's whole step in this process: the
    first step's loss and gradient from the same weights, then an epoch
    with the same permutation on both sides (losses and validation metric,
    the parameters by :func:`params_apart`; see ``TP_EPOCH_DRIFT``); ms a
    step on each side; the census of one step; and a one-rank process group
    (nccl on the card) whose model-1 step equals the step without a group
    bit for bit."""
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel import dtrain as DT
    from linna_tpu_torch.parallel import mesh as ME
    from linna_tpu_torch.parallel import multihost as MH

    t0 = time.perf_counter()
    run_ranks([[sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--tensor-parallel-rank",
                outdir, str(device)]] * 2, os.path.join(outdir, "logs"), timeout)
    ranks_s = time.perf_counter() - t0
    with np.load(os.path.join(outdir, "ranks.npz")) as z:
        two = {k: z[k] for k in z.files}
    reps = []
    for k in range(2):
        with open(os.path.join(outdir, f"rank_{k}.json")) as f:
            reps.append(json.load(f))
    F.reset_counts()
    one = tp_epoch_run(inputs, device)
    launches = {"one_rank": dict(F.launches), "ranks": [r["launches"] for r in reps]}
    steps = len(one["losses"])
    apart = params_apart(two["params"], one["params"], steps)
    loss_by_step = np.abs(two["losses"] - one["losses"]) / np.abs(one["losses"])
    loss_rel = float(loss_by_step.max())
    vm_rel = float(np.max(np.abs(two["val_metric"] - one["val_metric"])
                          / np.abs(one["val_metric"])))
    loss1, grad1 = tp_first_step(inputs, device)
    first = {"loss_rel": abs(float(two["first_loss"]) - loss1) / abs(loss1),
             "grad_max_diff_over_max": float(np.abs(two["first_grad"] - grad1).max()
                                             / np.abs(grad1).max())}

    # a process group of one rank: its model-1 step against the step without
    spec, ts, ls = _tp_problem(inputs, device)
    batch = int(inputs["batch"])
    bx = torch.as_tensor(inputs["tx"][:batch], dtype=torch.float32, device=device)
    by = torch.as_tensor(inputs["ty"][:batch], dtype=torch.float32, device=device)

    def one_step():
        mesh = ME.make_mesh(1)
        opt = DT.adamw(TP_LR)
        params, state = DT.init_sharded(TP_SEED, spec, opt, mesh, device=device)
        _, _, loss = DT.make_sharded_train_step(spec, ts, ls, opt, mesh)(params, state, bx, by)
        return float(loss), DT.gather_params(spec, params, mesh), mesh.groups()

    alone = one_step()
    backend = "nccl" if device.type == "cuda" else "gloo"
    MH.initialize(f"localhost:{free_port()}", 1, 0, backend=backend, device=device)
    try:
        MH.reset_collective_counts()
        grouped = one_step()
        group_counts = MH.collective_counts()
    finally:
        MH.shutdown()
    from linna_tpu_torch.train import _walk

    same = grouped[0] == alone[0] and all(
        np.array_equal(a, b) for (_, a), (_, b) in zip(_walk(grouped[1]), _walk(alone[1])))
    res = {
        "mesh": reps[0]["mesh"], "steps": steps, "batch": batch,
        "first_step": first, "step_rtol": TP_STEP_RTOL, "grad_rtol": TP_GRAD_RTOL,
        "losses_rel_by_step": loss_by_step.tolist(), "losses_max_rel": loss_rel,
        "val_metric_max_rel": vm_rel, "epoch_drift_limit": TP_EPOCH_DRIFT,
        "params_apart": apart,
        "ms_per_step": {"two_ranks": [r["ms_per_step"] for r in reps],
                        "one_rank": one["ms_per_step"]},
        "ranks_s": ranks_s, "census": reps[0]["census"],
        "epoch_collectives_rank0": reps[0]["epoch_collectives"],
        "launches": launches,
        "one_rank_group": {"backend": backend, "groups_made": grouped[2] != (None, None),
                           "collectives": group_counts, "equal_bit_for_bit": same},
    }
    log(f"  10a: {json.dumps(res, default=float)}")
    failures = []
    if first["loss_rel"] > TP_STEP_RTOL or first["grad_max_diff_over_max"] > TP_GRAD_RTOL:
        failures.append(f"first step: {first}")
    if loss_rel > TP_EPOCH_DRIFT or vm_rel > TP_EPOCH_DRIFT:
        failures.append(f"losses {loss_rel:.2e} / metric {vm_rel:.2e} over {TP_EPOCH_DRIFT}")
    if apart["max"] > apart["limit_max"]:
        failures.append(f"parameters apart: {apart}")
    if not same or not group_counts:
        failures.append(f"the one-rank {backend} step: equal {same}, collectives {group_counts}")
    per_step = reps[0]["census"]["per_step"]
    if per_step.get("all_reduce@model[0,1]") != 10 or per_step.get("all_gather@model[0,1]") != 3:
        failures.append(f"census {per_step}")
    if failures:
        raise AssertionError(f"10a: {failures}")
    return res


def phase_speculative(device, outdir, inputs, epochs=SPEC_EPOCHS, nensemble=NENSEMBLE,
                      traced_epochs=SPEC_TRACED_EPOCHS, epochs_per_dispatch=None,
                      traced_chunk=SPEC_TRACED_CHUNK) -> dict:
    """10b: the K-member EnsembleTrainer on phase 5's rows from train_emulator's
    member seeds for ``epochs`` epochs (lr 1e-3 for every member, no range
    test), with ``speculative_dispatch`` on and off: chunks speculated and
    dropped, whether the best val losses and parameters are equal bit for
    bit (required when nothing was dropped), ms an epoch, the trainer's
    phase seconds, and the device busy share of a traced run of
    ``traced_epochs`` epochs in ``traced_chunk``-epoch chunks in each
    mode."""
    from torch.profiler import ProfilerActivity, profile

    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

    spec, ts, ls = _tp_problem(inputs, device)
    seeds = [1234 + 1000 * k for k in range(nensemble)]
    rows = [inputs[k] for k in ("tx", "ty", "vx", "vy")]
    batch = int(inputs["batch"])

    def train(speculative, n_epochs, traced=False):
        tr = EnsembleTrainer(spec, ts, ls, [None] * nensemble, seeds, device=device)
        tr.speculative_dispatch = speculative
        _sync(device)
        if traced:
            acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                tr.train(*rows, num_epochs=n_epochs, batch_size=batch, auto_lr=False,
                         lr_scale=10.0, epochs_per_dispatch=traced_chunk)
                _sync(device)
                wall = time.perf_counter() - t0
            dev_ms = sum(us for _, us in kernel_events(prof).values()) / 1e3
            return {"epochs": n_epochs, "chunk": traced_chunk, "traced_wall_ms": wall * 1e3,
                    "device_ms": dev_ms,
                    "device_busy_share": dev_ms / (wall * 1e3), **tr.speculation}
        t0 = time.perf_counter()
        tr.train(*rows, num_epochs=n_epochs, batch_size=batch, auto_lr=False, lr_scale=10.0,
                 epochs_per_dispatch=epochs_per_dispatch)
        _sync(device)
        wall = time.perf_counter() - t0
        return tr, {"wall_s": wall, "ms_per_epoch": wall / n_epochs * 1e3,
                    "phase_s": dict(tr.phase_seconds), **tr.speculation}

    F.reset_counts()
    on_tr, on = train(True, epochs)
    launches = dict(F.launches)
    off_tr, off = train(False, epochs)
    equal = bool(np.array_equal(on_tr.best_val_losses, off_tr.best_val_losses)
                 and torch.equal(on_tr.flat, off_tr.flat))
    res = {"epochs": epochs, "nensemble": nensemble, "lr": 1e-3, "on": on, "off": off,
           "equal_bit_for_bit": equal,
           "best_val_loss": {"on": on_tr.best_val_losses.tolist(),
                             "off": off_tr.best_val_losses.tolist()},
           "traced": {"on": train(True, traced_epochs, traced=True),
                      "off": train(False, traced_epochs, traced=True)},
           "launches": launches}
    log(f"  10b: {json.dumps(res, default=float)}")
    if on["speculated"] == 0 or off["speculated"] != 0:
        raise AssertionError(f"10b: speculated {on['speculated']} on, {off['speculated']} off")
    if on["dropped"] == 0 and not equal:
        raise AssertionError("10b: nothing was dropped and the runs differ")
    return res


def phase_helpers(device, gradient_inputs, rows=NWALKERS, ndim=NDIM, ndata=NDATA) -> dict:
    """10c: ``make_grad_log_prob`` through ``fused_log_prob`` (one launch
    forward, the plain backward) against the plain gradient at ``rows``
    positions with log10 lanes' -inf rows; ``make_hessian_log_prob`` of
    phase 6's plain likelihood at its MAP point against the preconditioner's
    Hessian there (U diag(scales^2) U^T of the negative log-prob); and the
    fused likelihood's Hessian refused with a TypeError, as JAX refuses its
    kernel's."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.ops import fused as F

    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata, log10=(0, 3))
    lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov, use_fused=True, device=device)
    lp_p = plain_composition(LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                              device=device))
    x = torch.randn((rows, ndim), generator=torch.Generator().manual_seed(13)).to(device)
    x[: rows // 2, 0] = -3.0  # physical 0.3 - 3 < 0 on a log10 lane: -inf
    F.reset_counts()
    g_k = LK.make_grad_log_prob(lp_k)(x)
    launches = dict(F.launches)
    g_p = LK.make_grad_log_prob(lp_p)(x)
    err = compare(g_k, g_p, "make_grad_log_prob through fused_log_prob")
    dead = int((g_k == 0).all(dim=1).sum())

    plain, pre = gradient_inputs["plain"], gradient_inputs["precond"]
    center = torch.as_tensor(pre.center, dtype=torch.float32, device=device)[None]
    t0 = time.perf_counter()
    h = LK.make_hessian_log_prob(plain)(center)[0].double().cpu().numpy()
    hess_s = time.perf_counter() - t0
    want = pre.basis @ np.diag(pre.scales**2) @ pre.basis.T
    hess_rel = float(np.abs(-h - want).max() / np.abs(want).max())
    try:
        LK.make_hessian_log_prob(gradient_inputs["fused"])
        refused = None
    except TypeError as e:
        refused = str(e)
    res = {"gradient": err, "gradient_rows": rows, "neg_inf_rows_zero_gradient": dead,
           "launches": launches, "hessian_max_rel_to_precond": hess_rel,
           "hessian_rtol": HESS_RTOL, "hessian_s": hess_s, "ndim": ndim,
           "fused_hessian_refused": refused}
    log(f"  10c: {json.dumps(res, default=float)}")
    if device.type == "cuda" and launches["fused_log_prob"] != 1:
        raise AssertionError(f"10c: the gradient launched fused_log_prob "
                             f"{launches['fused_log_prob']} times, not once")
    if hess_rel > HESS_RTOL or not np.isfinite(h).all():
        raise AssertionError(f"10c: the Hessian is {hess_rel:.2e} from the preconditioner's")
    if refused is None:
        raise AssertionError("10c: the fused likelihood's Hessian was not refused")
    return res


def precompile_run(outdir: str, device_name: str) -> int:
    """One ``ml_sampler_core`` iteration for 10d (``chip_smoke.py
    --precompile-run OUTDIR DEVICE``) at the DES width with ``use_fused``,
    K=1, in a fresh process whose kernel build directory is cold
    (``LINNA_COMPILE_CACHE``); prints one JSON line: the run's seconds, the
    seconds the foreground waited for the library, nvcc's seconds, the warm
    thread's report and its launches, and the kernels' launches."""
    import linna_tpu_torch as LT
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.parallel import precompile as PC

    device = torch.device(device_name)
    with open(os.path.join(outdir, "config.json")) as f:
        cfg = json.load(f)
    pb = seeded_problem(device, cfg["ndim"], cfg["ndata"])
    inf = float("inf")
    t0 = time.perf_counter()
    LT.ml_sampler_core(
        ntrainArr=[cfg["ntrain"]], nvalArr=[cfg["nval"]], nkeepArr=[2], ntimesArr=[0],
        ntautolArr=[inf], meanshiftArr=[inf], stdshiftArr=[inf],
        outdir=os.path.join(outdir, "run"), theory=pb.theory, priors=pb.priors, data=pb.data,
        cov=pb.cov, init=pb.truth, pool=None, nwalkers=cfg["nwalkers"], temperatureArr=[1.0],
        params={"trainingoption": 1, "nensemble": 1, "batch_size": 500,
                "num_epochs": cfg["epochs"], "use_fused": True},
        method="zeus", seed=3, device=device)
    _sync(device)
    print(json.dumps({"run_s": time.perf_counter() - t0, **F.LIBRARY.stats,
                      "warm": PC.last_report, "warm_error": repr(PC.last_error),
                      "launches": dict(F.launches),
                      "cache_dir": PC.compile_cache_dir()}, default=float), flush=True)
    return 0


def phase_precompile(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=PRECOMPILE_NTRAIN,
                     nval=PRECOMPILE_NVAL, epochs=PRECOMPILE_EPOCHS, nwalkers=NWALKERS,
                     timeout=MP_TIMEOUT) -> dict:
    """10d: one use_fused iteration (:func:`precompile_run`) in a fresh
    process with a cold kernel build directory, warming on and off, and once
    more with a compiler that fails (``CUDA_HOME`` naming a stand-in
    ``nvcc``), which must fail the run: the warm thread keeps the error and
    the foreground's first launch raises it again (on the card: nothing
    builds off it)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.json"), "w") as f:
        json.dump({"ndim": ndim, "ndata": ndata, "ntrain": ntrain, "nval": nval,
                   "epochs": epochs, "nwalkers": nwalkers}, f)
    broken = os.path.join(outdir, "broken_cuda", "bin")
    os.makedirs(broken, exist_ok=True)
    with open(os.path.join(broken, "nvcc"), "w") as f:
        f.write("#!/bin/sh\necho 'stand-in compiler: broken toolchain' >&2\nexit 7\n")
    os.chmod(os.path.join(broken, "nvcc"), 0o755)
    res = {}
    cases = [("warm", {"LINNA_PRECOMPILE": "1"}), ("cold", {"LINNA_PRECOMPILE": "0"})]
    if device.type == "cuda":
        cases.append(("broken_compiler", {"LINNA_PRECOMPILE": "1",
                                          "CUDA_HOME": os.path.dirname(broken)}))
    for case, env in cases:
        d = os.path.join(outdir, case)
        os.makedirs(d)
        shutil.copy(os.path.join(outdir, "config.json"), d)
        env = dict(os.environ, PYTHONPATH=ROOT, LINNA_COMPILE_CACHE=os.path.join(d, "build"),
                   **env)
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                            "--precompile-run", d, str(device)], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        if case == "broken_compiler":
            res[case] = {"rc": p.returncode, "process_s": wall,
                         "error": [ln for ln in p.stderr.splitlines() if "nvcc failed" in ln][-1:]}
            if p.returncode == 0 or not res[case]["error"]:
                log(p.stdout[-3000:] + p.stderr[-3000:])
                raise AssertionError("10d: the run with a broken compiler did not fail on it")
            continue
        if p.returncode != 0:
            log(p.stdout[-3000:] + p.stderr[-3000:])
            raise AssertionError(f"10d: the {case} run exited with {p.returncode}")
        res[case] = {**json.loads(p.stdout.strip().splitlines()[-1]), "process_s": wall}
    log(f"  10d: {json.dumps(res, default=float)}")
    warm, cold = res["warm"], res["cold"]
    if device.type == "cuda" and (not warm["warm"].get("launches", {}).get("fused_log_prob")
                                  or cold["warm"]):
        raise AssertionError(f"10d: warm thread report {warm['warm']} on, {cold['warm']} off")
    return res


def phase_pod_accept(device, timeout=MP_TIMEOUT, device_arg=None) -> dict:
    """10e: ``python -m linna_tpu_torch.pod_accept --structural`` (the card
    by default) as a user runs it: its JSON verdict and exit code."""
    cmd = [sys.executable, "-m", "linna_tpu_torch.pod_accept", "--structural"]
    if device_arg:
        cmd += ["--device", device_arg]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=timeout)
    verdict = json.loads(p.stdout.strip().splitlines()[-1]) if p.stdout.strip() else None
    res = {"rc": p.returncode, "seconds": time.perf_counter() - t0, "verdict": verdict}
    log(f"  10e: {json.dumps(res, default=float)}")
    if p.returncode != 0 or not (verdict and verdict["pass"]):
        log(p.stderr[-3000:])
        raise AssertionError(f"10e: pod_accept --structural exited {p.returncode}")
    return res


def phase_rest(device, outdir, gradient_inputs, rows=None, speculative=None, helpers=None,
               precompile=None, pod_accept=None) -> dict:
    """Phase 10: 10a-10e; each dict gives its phase function's keyword
    arguments (sizes, for a rehearsal on the CPU)."""
    res = {}
    inputs = phase10_rows(device, outdir, **(rows or {}))
    os.makedirs(os.path.join(outdir, "10a"), exist_ok=True)
    shutil.copy(os.path.join(outdir, "inputs.npz"), os.path.join(outdir, "10a"))
    steps = (("10a", lambda: phase_tensor_parallel(device, os.path.join(outdir, "10a"), inputs)),
             ("10b", lambda: phase_speculative(device, os.path.join(outdir, "10b"), inputs,
                                               **(speculative or {}))),
             ("10c", lambda: phase_helpers(device, gradient_inputs, **(helpers or {}))),
             ("10d", lambda: phase_precompile(device, os.path.join(outdir, "10d"),
                                              **(precompile or {}))),
             ("10e", lambda: phase_pod_accept(device, **(pod_accept or {}))))
    for key, fn in steps:
        t0 = time.perf_counter()
        res[key] = fn()
        res[key + "_s"] = time.perf_counter() - t0
        log(f"  {key}: {res[key + '_s']:.1f} s")
    return res



# ------------------------------------------------ phase 11: sampler programs


def member_loop_log_prob(spec, members, ts, pack, data, inv_cov, temperature, device):
    """The K-member likelihood as the port computed it before the batched
    pass: one eager chain per member, a test-only copy for phase 11."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import priors as P

    data_t = torch.as_tensor(data, dtype=torch.float32, device=device)
    ic = torch.as_tensor(inv_cov, dtype=torch.float32, device=device)

    def log_prob(x):
        x_in = ts.x_transform(P.transform(pack, x))
        chi2 = []
        for p in members:
            m = ts.y_data.inverse(ts.y_transform(N.apply_model(spec, p, x_in).float()))
            chi2.append(LK._chi2(m - data_t, ic))
        chi2 = torch.stack(chi2)
        eff = chi2.mean(dim=0) + chi2.std(dim=0, correction=0)
        lp = -0.5 * eff / temperature + P.lnprior(x)
        return torch.where(torch.isnan(lp), torch.full_like(lp, -torch.inf), lp)

    return log_prob


def _programs_init(method, log_prob, x0, device, seed=7):
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import slicemove as S
    from linna_tpu_torch.samplers import stretch

    g = torch.Generator(device=device).manual_seed(seed)
    return {"emcee": stretch.init_state, "zeus": S.init_slice_state,
            "hmc": hmc.init_hmc_state, "nuts": hmc.init_nuts_state}[method](g, x0, log_prob)


def _eager_chunk(method, log_prob):
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import slicemove as S
    from linna_tpu_torch.samplers import stretch

    fn, opt = {"emcee": (stretch.stretch_chunk, "a"), "zeus": (S.slice_chunk, "max_steps"),
               "hmc": (hmc.hmc_chunk, "n_leapfrog"), "nuts": (hmc.nuts_chunk, "max_depth")}[method]
    return lambda st, n: fn(log_prob, st, n, PROGRAM_OPTIONS[opt])


def _chunk_run(chunk, state, n, rng_state, device) -> dict:
    """One chunk from ``state`` with its generator set to ``rng_state``:
    the result, seconds, the kernel's launches and the generator after."""
    from linna_tpu_torch.ops import fused as F

    state.rng.set_state(rng_state)
    F.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    out = chunk(state, n)
    _sync(device)
    s = time.perf_counter() - t0
    if hasattr(chunk, "settle"):  # a graphed runner: the loops the card ran
        chunk.settle()
    return {"out": out, "s": s, "launches": F.launches["fused_log_prob"],
            "rng_after": state.rng.get_state()}


def _held(graphed: dict, eager: dict, what: str, calls=None) -> dict:
    """The graphed chunk against the eager one: equal bit for bit, else the
    largest difference within PROGRAM_ATOL; the same generator state after.
    The launches counted from the replays: one a likelihood call where
    ``calls`` gives the calls replayed (zeus's graphed loops may run other
    iterations than the eager ones), else the eager chunk's."""
    (gs, gc, gl), (es, ec, el) = graphed["out"], eager["out"]
    pairs = [(gc, ec), (gl, el), (gs.coords, es.coords), (gs.log_prob, es.log_prob)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a.double() - b.double()).abs().nan_to_num(0.0).max()) for a, b in pairs)
    same_rng = torch.equal(graphed["rng_after"], eager["rng_after"])
    log(f"  {what}: graphed and eager chains equal bit for bit: {equal} (largest difference "
        f"{diff:.3e}); generator after the chunk the same: {same_rng}; fused_log_prob launches "
        f"{graphed['launches']} graphed (counted from the replays), {eager['launches']} eager")
    if not same_rng or (not equal and not diff <= PROGRAM_ATOL):
        raise AssertionError(f"{what}: the graphed chunk is not the eager one")
    want = eager["launches"] if calls is None else calls
    if graphed["launches"] != want:
        raise AssertionError(f"{what}: the replays counted {graphed['launches']} launches, "
                             f"not {want}")
    return {"bit_for_bit": equal, "max_abs_diff": diff}


def _loop_record(before: dict, after: dict, n: int, what: str) -> dict:
    """A graphed zeus chunk's loop iterations a step, each loop, which the
    card ended, and the host's condition reads in it, which must be 0."""
    rec = {"loop_iters_per_step": {k: (after["loop_iters"][k] - before["loop_iters"][k]) / n
                                   for k in ("out", "in")},
           "cond_reads": after["cond_reads"] - before["cond_reads"]}
    if rec["cond_reads"]:
        raise AssertionError(f"{what}: the host read {rec['cond_reads']} loop conditions")
    return rec


def _busy(fn, device) -> dict:
    """A traced call's wall ms and the device's busy share (None where the
    profiler saw no device event)."""
    if device.type != "cuda":
        fn()
        return {"wall_ms": None, "device_busy_share": None}
    rec = traced_call(fn, device)
    if rec["launches"] == 0:
        rec["device_busy_share"] = None
    return rec


def phase_programs(device, ndim=NDIM, ndata=NDATA, nwalkers=NWALKERS, steps=None, traced=None,
                   k4_steps=K4_STEPS, k4_traced=K4_TRACED,
                   nensemble=NENSEMBLE) -> dict:
    """Phase 11: for each sampler one chunk replayed from CUDA graphs and
    one eager from the same state and generator state (equal bit for bit,
    the same launches counted), then a second chunk of each from its end
    state (bit for bit too), s / 100 steps and the busy share of a
    traced chunk of each, replays and launches a step; zeus's loop
    iterations a step and its host condition reads (none); and the K=4
    ensemble's batched likelihood against the per-member loop (values, and
    zeus through the loop eager, batched eager and batched graphed); on a
    card, captures while a dead runner waits for the collector (11f) and
    chunks shorter than the warm-up (11g)."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch.samplers import graphs as G

    steps, traced = steps or PROGRAM_STEPS, traced or PROGRAM_TRACED
    lp, x0 = fused_problem(device, ndim, ndata, nwalkers)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    on_card = device.type == "cuda"
    res: dict = {"methods": {}}
    for method in ("emcee", "zeus", "hmc", "nuts"):
        n = steps[method]
        state = _programs_init(method, lp, x0, device)
        g0 = state.rng.get_state()
        eager = _eager_chunk(method, lp)
        rec: dict = {"steps": n}
        if on_card:
            t0 = time.perf_counter()
            runner = G.graphed_chunks(method, lp, state, n, **PROGRAM_OPTIONS)
            rec["capture_s"] = time.perf_counter() - t0
            before = runner.record()
            graphed = _chunk_run(runner, state, n, g0, device)
            after = runner.record()
            rec["replays_per_step"] = (after["replays"] - before["replays"]) / n
            rec["likelihood_calls_per_step"] = (after["calls"] - before["calls"]) / n
            rec["graphed_s_per_100"] = graphed["s"] / n * 100
            rec["launches_per_step"] = graphed["launches"] / n
            if method == "zeus":
                rec.update(_loop_record(before, after, n, method))
        one = _chunk_run(eager, state, n, g0, device)
        rec["eager_s_per_100"] = one["s"] / n * 100
        rec["eager_launches_per_step"] = one["launches"] / n
        if on_card:
            rec.update(_held(graphed, one, method, after["calls"] - before["calls"]))
            # a second chunk from each run's end state, after the host has
            # allocated: a replay must not read memory freed since its capture
            spare = [torch.zeros(ndim, device=device) for _ in range(64)]
            before = runner.record()
            graphed2 = _chunk_run(runner, graphed["out"][0], n, graphed["rng_after"], device)
            calls2 = runner.record()["calls"] - before["calls"]
            one2 = _chunk_run(eager, one["out"][0], n, one["rng_after"], device)
            rec["second_chunk"] = _held(graphed2, one2, f"{method} second chunk", calls2)
            del spare
            nt = traced[method]
            rec["graphed_traced"] = {"steps": nt, **_busy(lambda: runner(state, nt), device)}
            rec["eager_traced"] = {"steps": nt, **_busy(lambda: eager(state, nt), device)}
        log(f"  11 {method}: {json.dumps(rec, default=float)}")
        res["methods"][method] = rec

    # the K=4 ensemble: one batched pass against the per-member loop
    spec, _, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    members = [N.init_model(spec, seed=10 + k, device=device) for k in range(nensemble)]
    batched = LK.make_log_prob(spec, members, ts, pack, data, inv_cov, temperature=TEMPERATURE,
                               device=device)
    loop = member_loop_log_prob(spec, members, ts, pack, data, inv_cov, TEMPERATURE, device)
    with torch.no_grad():
        a, b = batched(x0), loop(x0)
    rel = float(((a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)).max())
    k4: dict = {"members": nensemble, "max_rel_diff": rel, "rtol": K4_RTOL, "steps": k4_steps}
    log(f"  11 K={nensemble}: batched against the per-member loop at {nwalkers} walkers: "
        f"largest relative difference {rel:.3e} (rtol {K4_RTOL:g})")
    if not rel <= K4_RTOL:
        raise AssertionError(f"K={nensemble}: the batched likelihood is not the member loop's")
    state = _programs_init("zeus", batched, x0, device)
    g0 = state.rng.get_state()
    runs = {"loop_eager": _eager_chunk("zeus", loop), "batched_eager": _eager_chunk("zeus", batched)}
    if on_card:
        runs["batched_graphed"] = G.graphed_chunks("zeus", batched, state, k4_steps,
                                                   **PROGRAM_OPTIONS)
    done = {}
    for name, chunk in runs.items():
        before = chunk.record() if name == "batched_graphed" else None
        done[name] = _chunk_run(chunk, state, k4_steps, g0, device)
        k4[f"{name}_s_per_100"] = done[name]["s"] / k4_steps * 100
        if before is not None:
            k4.update(_loop_record(before, chunk.record(), k4_steps, f"K={nensemble} zeus"))
        if on_card:
            k4[f"{name}_traced"] = {"steps": k4_traced,
                                    **_busy(lambda: chunk(state, k4_traced), device)}
    if on_card:
        k4.update(_held(done["batched_graphed"], done["batched_eager"], f"K={nensemble} zeus"))
    log(f"  11 K={nensemble}: {json.dumps(k4, default=float)}")
    res["k4"] = k4
    if on_card:
        res["collector"] = _collector_check(lp, x0, device)
        res["small_chunks"] = _small_chunks(lp, x0, device)
    return res


def _small_chunks(lp, x0, device, capacities=(1, 2)) -> dict:
    """11g: each method's graphs for chunks of fewer steps than the
    warm-up's runs of a step before its capture (``ops.graphs.WARMUP``), a
    chunk of each against the eager one, bit for bit."""
    from linna_tpu_torch.samplers import graphs as G

    res = {}
    for method in ("emcee", "zeus", "hmc", "nuts"):
        for cap in capacities:
            state = _programs_init(method, lp, x0, device)
            g0 = state.rng.get_state()
            runner = G.graphed_chunks(method, lp, state, cap, **PROGRAM_OPTIONS)
            before = runner.record()
            graphed = _chunk_run(runner, state, cap, g0, device)
            calls = runner.record()["calls"] - before["calls"]
            one = _chunk_run(_eager_chunk(method, lp), state, cap, g0, device)
            res[f"{method}_{cap}"] = _held(graphed, one, f"11g {method}, {cap}-step chunks",
                                           calls)["bit_for_bit"]
    return res


def _collector_check(lp, x0, device, trials=3) -> dict:
    """11f: zeus's graphs captured while a runner nobody holds waits for the
    collector, whose thresholds are (1, 1, 1) so that it would run inside
    the captures: freeing that runner inside a capture destroys its graphs
    there and invalidates the capture.  No collection may start while a
    stream captures, and every capture must succeed.  The runners hold
    chunks of 2 steps, fewer than the warm-up's runs of a step before its
    capture (``ops.graphs.WARMUP``)."""
    import gc

    from linna_tpu_torch.samplers import graphs as G

    seen = {"collections": 0, "in_capture": 0}

    def count(phase, info):
        if phase == "start":
            seen["collections"] += 1
            seen["in_capture"] += torch.cuda.is_current_stream_capturing()

    thresholds = gc.get_threshold()
    gc.callbacks.append(count)
    try:
        for trial in range(trials):
            dead = G.graphed_chunks("zeus", lp, _programs_init("zeus", lp, x0, device), 2,
                                    **PROGRAM_OPTIONS)
            del dead
            gc.set_threshold(1, 1, 1)
            G.graphed_chunks("zeus", lp, _programs_init("zeus", lp, x0, device), 2,
                             **PROGRAM_OPTIONS)
            gc.set_threshold(*thresholds)
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(count)
    res = {"trials": trials, **seen}
    log(f"  11f: captures with a dead runner pending, collector at (1, 1, 1): "
        f"{json.dumps(res)}")
    if seen["in_capture"]:
        raise AssertionError(f"11f: {seen['in_capture']} collections started inside a capture")
    return res


# ------------------------------------------------ phase 12: training programs


def _train_state(tr) -> tuple:
    """Copies of the trainer's parameters, AdamW state and member generator
    states."""
    return [t.clone() for t in (tr.flat, *tr.opt)], [g.get_state() for g in tr.gens]


def _set_train_state(tr, state) -> None:
    with torch.no_grad():
        for dst, src in zip((tr.flat, *tr.opt), state[0]):
            dst.copy_(src)
    for g, st in zip(tr.gens, state[1]):
        g.set_state(st)


def _apart(a, b) -> float:
    """The largest difference of two tensors (or arrays); inf where their
    shapes differ."""
    a, b = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a), \
        torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b)
    if a.shape != b.shape:
        return float("inf")
    return float((a.double() - b.double()).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


def _held_training(pairs, what: str) -> dict:
    """Graphed against eager, pair by pair: equal bit for bit, or fail with
    each pair's largest difference."""
    apart = {name: (torch.equal(a, b) if torch.is_tensor(a) else np.array_equal(a, b),
                    _apart(a, b)) for name, (a, b) in pairs.items()}
    bad = {name: diff for name, (equal, diff) in apart.items() if not equal}
    log(f"  {what}: graphed and eager equal bit for bit: {not bad}"
        + (f" (apart: {bad})" if bad else ""))
    if bad:
        raise AssertionError(f"{what}: the graphed run is not the eager one: {bad}")
    return {"bit_for_bit": True, "compared": sorted(pairs)}


def _chunk_pairs(graphed: dict, eager: dict) -> dict:
    names = ("losses", "val_metrics", "correlations", "best_val", "best_params")
    pairs = {n: (g, e) for n, g, e in zip(names, graphed["out"], eager["out"]) if g is not None}
    for i, n in enumerate(("params", "adam_count", "adam_mu", "adam_nu")):
        pairs[n] = (graphed["state"][0][i], eager["state"][0][i])
    for m, (g, e) in enumerate(zip(graphed["state"][1], eager["state"][1])):
        pairs[f"generator_{m}"] = (g, e)
    return pairs


def _program_chunk(tr, prog, n_epochs: int, n: int, device) -> dict:
    """One chunk of ``prog`` on fresh draws: its outputs, the state after,
    seconds between synchronizes and the program's replays."""
    replays, adamw = prog.replays, _adamw_counts()
    perms = tr._draw_perms(n_epochs, n)
    _sync(device)
    t0 = time.perf_counter()
    out = prog(perms)
    _sync(device)
    return {"out": out, "s": time.perf_counter() - t0, "state": _train_state(tr),
            "replays": prog.replays - replays,
            "adamw": {k: v - adamw[k] for k, v in _adamw_counts().items()}}


def _traced_chunk(tr, prog, n_epochs: int, n: int, device) -> dict:
    """A traced chunk: wall, device busy share, and kernels and graph
    replays an epoch."""
    from linna_tpu_torch.ops import fused as F

    perms = tr._draw_perms(n_epochs, n)
    replays = prog.replays
    rec = _busy(lambda: prog(perms), device)
    launches = rec.pop("launches", None)
    rec.pop("device_ms_by_kernel", None)
    return {"epochs": n_epochs, **rec,
            "kernels_per_epoch": None if launches is None else launches / n_epochs,
            "replays_per_epoch": (prog.replays - replays) / n_epochs,
            "kernel_launches": dict(F.launches)}


def program_case(tr, data, n: int, epochs: int, traced: int, device, what: str) -> dict:
    """A graphed chunk against an eager one from the same state: the
    trainer's own program (graphs on a card) runs a warm chunk, then a
    chunk from a saved state; an eager program runs the same chunk from the
    same state.  Then a traced chunk of each."""
    from linna_tpu_torch import train_graphs as TG

    nb = n // tr._batch_size
    t0 = time.perf_counter()
    graphed = tr._epoch_program(data, nb, epochs)
    capture_s = time.perf_counter() - t0
    _program_chunk(tr, graphed, epochs, n, device)  # a warm chunk
    start = _train_state(tr)
    g = _program_chunk(tr, graphed, epochs, n, device)
    _set_train_state(tr, start)
    eager = TG.EpochProgram(tr, data, nb, epochs, graphed=False)
    e = _program_chunk(tr, eager, epochs, n, device)
    rec = {"members": tr.flat.shape[0], "rows": n, "minibatches_per_epoch": nb,
           "compute_dtype": str(tr.compute_dtype or torch.float32),
           "pre_model": tr.linearmodel is not None, "graphed": graphed.graphed,
           "capture_s": capture_s, "graphs": len(graphed.graphs), "epochs": epochs,
           "graphed_ms_per_epoch": g["s"] / epochs * 1e3,
           "eager_ms_per_epoch": e["s"] / epochs * 1e3,
           "replays_per_epoch": g["replays"] / epochs,
           "adamw_per_epoch": {"graphed": {k: v / epochs for k, v in g["adamw"].items()},
                               "eager": {k: v / epochs for k, v in e["adamw"].items()}},
           **_held_training(_chunk_pairs(g, e), what)}
    # one AdamW step a minibatch: the kernel on a card, its plain version here
    ran, idle = ("launches", "plain_calls") if device.type == "cuda" else ("plain_calls",
                                                                           "launches")
    for way, r in (("graphed", g), ("eager", e)):
        if r["adamw"][ran] != nb * epochs or r["adamw"][idle]:
            raise AssertionError(f"{what}: the {way} chunk's AdamW steps {r['adamw']} for "
                                 f"{nb * epochs} minibatch steps")
    rec["graphed_traced"] = _traced_chunk(tr, graphed, traced, n, device)
    rec["eager_traced"] = _traced_chunk(tr, eager, traced, n, device)
    log(f"  {what}: {json.dumps(rec, default=float)}")
    return rec


def _program_trainer(inputs, device, nensemble, compute_dtype=None, linearmodel=None):
    """An EnsembleTrainer (K=1: a Trainer) on the inputs' rows from
    train_emulator's member seeds at learning rate 1e-3, and its rows."""
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer
    from linna_tpu_torch.train import Trainer

    spec, ts, ls = _tp_problem(inputs, device)
    seeds = [1234 + 1000 * k for k in range(nensemble)]
    if nensemble == 1:
        tr = Trainer(spec, ts, ls, seed=seeds[0], compute_dtype=compute_dtype,
                     linearmodel=linearmodel, device=device)
    else:
        tr = EnsembleTrainer(spec, ts, ls, [None] * nensemble, seeds,
                             compute_dtype=compute_dtype, linearmodel=linearmodel, device=device)
    tr._batch_size = int(inputs["batch"])
    tr.lrs[:] = 1e-3
    tr._set_hypers()
    rows = tr._prepare(*(inputs[k] for k in ("tx", "ty", "vx", "vy")))
    return tr, rows


def _pre_model(inputs, device):
    """A norder-2 pre-model fitted as train_emulator fits one: on the
    x-transformed inputs and the standardized targets."""
    from linna_tpu_torch import linear_model as LM
    from linna_tpu_torch import losses as L

    _, ts, ls = _tp_problem(inputs, device)
    f32 = lambda k: torch.as_tensor(np.asarray(inputs[k]), dtype=torch.float32, device=device)
    with torch.no_grad():
        x = ts.x_transform(f32("tx"))
        y = L.target_terms(ls, ts, f32("ty"))[0]
    return LM.fit_linear_model(x.cpu().numpy(), y.cpu().numpy(), norder=2, device=device)


def sweep_case(tr, data, n: int, device) -> dict:
    """12d: the range test's 100 steps from one step graph against the
    eager steps, from the same params: the raw traces bit for bit, the
    params put back."""
    from linna_tpu_torch import train as TTR
    from linna_tpu_torch import train_graphs as TG

    order = np.random.default_rng(1234).permutation(n)
    lrs = np.geomspace(1e-4, 5e-3, 100)
    before = tr.flat.clone()
    runs = []
    for graphed in (tr._graphed(), False):  # the trainer's route, then eager
        rec: dict = {}
        opt = TTR.adamw_init(tr.flat, tr.compute_dtype)
        _sync(device)
        t0 = time.perf_counter()
        raw = TG.lr_sweep(tr, data, order, lrs, opt, graphed, rec)
        _sync(device)
        runs.append((raw, time.perf_counter() - t0 - rec["capture_s"], rec,
                     torch.equal(tr.flat, before)))
    (g, g_s, g_rec, g_back), (e, e_s, _, e_back) = runs
    res = {"steps": len(lrs), "graphed": g_rec["graphed"], "capture_s": g_rec["capture_s"],
           "replays": g_rec["replays"], "graphed_ms_per_step": g_s / len(lrs) * 1e3,
           "eager_ms_per_step": e_s / len(lrs) * 1e3, "params_put_back": g_back and e_back,
           **_held_training({"raw_losses": (g, e)}, "12d range test")}
    if not res["params_put_back"]:
        raise AssertionError("12d: the range test did not put the params back")
    log(f"  12d: {json.dumps(res, default=float)}")
    return res


def planted_case(inputs, device, epochs=PLANTED_EPOCHS, chunk=PLANTED_CHUNK, planted=None,
                 nensemble=NENSEMBLE) -> dict:
    """12e: ``train`` at K members with the range test, speculation on and
    member 0's supervisor answering ``planted`` ({epoch: action}) once
    each, graphed against eager (a trainer whose chunks and range test run
    the eager bodies on the card): the range test's learning rates,
    per-batch losses, metric rows, parameters, AdamW state, best params and
    losses, generators, and the chunks speculated and dropped, bit for
    bit."""
    from linna_tpu_torch import train as TTR

    planted = PLANTED if planted is None else planted
    real = TTR.Supervisor

    class Planted(real):
        def step(self, ep, vm, loss, min_eig, suppressed=False):
            out = real.step(self, ep, vm, loss, min_eig, suppressed)
            if self.tag in ("member0", "") and ep in planted and not suppressed:
                if planted[ep] == "hyper":
                    self.lr, self.wd = self.lr / 2.0, self.wd * 2.0
                return planted[ep]
            return out

    runs = {}
    TTR.Supervisor = Planted
    try:
        for graphed in (True, False):
            tr, _ = _program_trainer(inputs, device, nensemble)
            if not graphed:
                tr._graphed = lambda: False
            _sync(device)
            t0 = time.perf_counter()
            losses, vms = tr._train(*(inputs[k] for k in ("tx", "ty", "vx", "vy")),
                                    num_epochs=epochs, batch_size=int(inputs["batch"]),
                                    auto_lr=True, epochs_per_dispatch=chunk)
            _sync(device)
            runs[graphed] = {"tr": tr, "losses": losses, "vms": vms,
                             "s": time.perf_counter() - t0}
    finally:
        TTR.Supervisor = real
    g, e = runs[True], runs[False]
    pairs = {"range_test_lrs": (g["tr"].lrs, e["tr"].lrs),
             "train_losses": (np.array(g["losses"]), np.array(e["losses"])),
             "val_metrics": (np.array(g["vms"]), np.array(e["vms"])),
             "best_val_losses": (g["tr"].best_val_losses, e["tr"].best_val_losses),
             "best_params": (g["tr"]._best_flat, e["tr"]._best_flat)}
    for i, n in enumerate(("params", "adam_count", "adam_mu", "adam_nu")):
        pairs[n] = ((g["tr"].flat, *g["tr"].opt)[i], (e["tr"].flat, *e["tr"].opt)[i])
    for m, (a, b) in enumerate(zip(g["tr"].gens, e["tr"].gens)):
        pairs[f"generator_{m}"] = (a.get_state(), b.get_state())
    res = {"epochs": epochs, "chunk": chunk, "planted": {str(k): v for k, v in planted.items()},
           "speculation": {"graphed": g["tr"].speculation, "eager": e["tr"].speculation},
           "graphs": g["tr"].graphs["epochs"],
           "graphed_ms_per_epoch": g["s"] / epochs * 1e3,
           "eager_ms_per_epoch": e["s"] / epochs * 1e3,
           "phase_s": {"graphed": g["tr"].phase_seconds, "eager": e["tr"].phase_seconds},
           **_held_training(pairs, "12e planted interventions")}
    log(f"  12e: {json.dumps(res, default=float)}")
    if g["tr"].speculation != e["tr"].speculation or g["tr"].speculation["dropped"] < len(planted):
        raise AssertionError(f"12e: speculation {res['speculation']}; each planted action must "
                             f"drop a speculated chunk")
    if device.type == "cuda" and not res["graphs"]["graphed"]:
        raise AssertionError("12e: train() did not run its chunks from CUDA graphs on the card")
    return res


def phase_train_programs(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                         batch=TP_BATCH, flagship_rows=(FLAGSHIP_ROWS, FLAGSHIP_VAL), epochs=None,
                         traced=None) -> dict:
    """Phase 12: training chunks and the range test replayed from CUDA
    graphs against the eager bodies, bit for bit, with their times, busy
    shares, replays and kernels an epoch and capture seconds, and no launch
    of either CUDA kernel (training reaches neither)."""
    from linna_tpu_torch.ops import fused as F

    epochs, traced = epochs or TRAIN_PROGRAM_EPOCHS, traced or TRAIN_PROGRAM_TRACED
    F.reset_counts()
    res: dict = {}
    rows = phase10_rows(device, os.path.join(outdir, "rows"), ndim, ndata, ntrain, nval, batch)
    n = len(rows["tx"])
    tr, data = _program_trainer(rows, device, NENSEMBLE)
    res["12a"] = program_case(tr, data, n, epochs["12a"], traced["12a"], device,
                              f"12a K={NENSEMBLE} f32")
    res["12d"] = sweep_case(tr, data, n, device)
    del tr, data
    lm = _pre_model(rows, device)
    tr, data = _program_trainer(rows, device, 1, linearmodel=lm)
    res["12c"] = program_case(tr, data, n, epochs["12c"], traced["12c"], device,
                              "12c K=1 with a norder-2 pre-model")
    del tr, data
    res["12e"] = planted_case(rows, device)
    big = phase10_rows(device, os.path.join(outdir, "flagship_rows"), ndim, ndata,
                       *flagship_rows, batch)
    tr, data = _program_trainer(big, device, PREMODEL_ENSEMBLE, compute_dtype="bfloat16")
    res["12b"] = program_case(tr, data, len(big["tx"]), epochs["12b"], traced["12b"], device,
                              f"12b K={PREMODEL_ENSEMBLE} bf16 at {len(big['tx'])} rows")
    del tr, data
    res["launches"] = _likelihood_counts(F.launches)
    res["plain_calls"] = _likelihood_counts(F.plain_calls)
    res["adamw"] = _adamw_counts()
    log(f"  12: likelihood kernel launches {res['launches']}, plain calls "
        f"{res['plain_calls']}; AdamW {res['adamw']}")
    if any(res["launches"].values()) or any(res["plain_calls"].values()):
        raise AssertionError("training reached a likelihood kernel or its plain version")
    return res


def adamw_inputs(device, ndim: int, ndata: int, k: int, mu_dtype, steps: int, seed: int = 0):
    """chto_v2's (K, P) parameters at the widths, an AdamW state with its
    first moment in ``mu_dtype``, each step's leaf gradients in the Layout's
    order and in that type (the trainer's: bf16 leaves beside a bf16
    moment), the even leaves contiguous as autograd leaves them and the odd
    ones views of a (K, P) tensor, and lr and wd per member."""
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import train as TR

    layout = TR.Layout(N.make_model_spec("chto_v2", ndim, ndata))
    gen = torch.Generator().manual_seed(seed)
    flat = (0.05 * torch.randn(k, layout.size, generator=gen)).to(device)
    grads = []
    for s in range(steps):
        full = (torch.randn(k, layout.size, generator=gen) * (0.5 + s)).to(device, mu_dtype)
        grads.append([v.contiguous() if i % 2 == 0 else v
                      for i, v in enumerate(layout.stacked_views(full))])
    lr = torch.tensor([[1e-3 * (1 + m)] for m in range(k)], device=device)
    wd = torch.tensor([[1e-4 * (1 + 3 * m)] for m in range(k)], device=device)
    return flat, TR.adamw_init(flat, mu_dtype), grads, lr, wd


def adamw_bytes(flat, state, grads) -> int:
    """The bytes one step must move: the parameters, first and second moment
    read and written, the gradient read."""
    k, p = flat.shape
    per = 2 * (4 + state.mu.element_size() + 4) + grads[0].element_size()
    return k * p * per


def phase_adamw(device, widths=WIDTHS_ADAMW, k=ADAMW_MEMBERS, steps=ADAMW_STEPS) -> dict:
    """12f: the AdamW kernel (``ops.adamw.adamw_``) against its plain
    version (``adamw_plain_``, the PyTorch ops) on the same device, bit for
    bit over ``steps`` steps (member 1's state reset after step 2) at each
    width, with a bfloat16 and a float32 first moment; on a card, the
    kernel's device time a launch beside the bytes it moves, its share of
    the HBM roofline, the whole call's device time (the count and the two
    bias corrections too) and the plain version's."""
    from linna_tpu_torch import train as TR
    from linna_tpu_torch.ops import adamw as AW

    card = device.type == "cuda"
    res = {}
    for name, (ndim, ndata) in widths.items():
        for mu_dtype in (torch.bfloat16, torch.float32):
            key = f"{name}_{str(mu_dtype).split('.')[-1]}"
            flat, st, grads, lr, wd = adamw_inputs(device, ndim, ndata, k, mu_dtype, steps)
            flat_p, st_p = flat.clone(), TR.AdamWState(*(t.clone() for t in st))
            for s, g in enumerate(grads):
                AW.adamw_(flat, g, st, lr, wd)
                AW.adamw_plain_(flat_p, g, st_p, lr, wd)
                pairs = {"params": (flat, flat_p), **{n: (a, b) for n, a, b in zip(
                    ("count", "mu", "nu"), st, st_p)}}
                bad = {n: _apart(a, b) for n, (a, b) in pairs.items() if not torch.equal(a, b)}
                if bad:
                    raise AssertionError(f"12f {key} step {s}: kernel and plain apart: {bad}")
                if s == 2:
                    TR.adamw_reset_(st, 1)
                    TR.adamw_reset_(st_p, 1)
            rec = {"members": k, "params_per_member": flat.shape[1], "steps": steps,
                   "bit_for_bit": True, "bytes": adamw_bytes(flat, st, grads[0])}
            if card:
                call = lambda: AW.adamw_(flat, grads[0], st, lr, wd)
                rec["kernel_ms"], rec["timing"] = kernel_ms(call, "adamw_kernel")
                rec["call_ms"], _ = device_ms(call)
                rec["plain_ms"], rec["plain_timing"] = device_ms(
                    lambda: AW.adamw_plain_(flat_p, grads[0], st_p, lr, wd))
                rec["kernel_us"] = rec["kernel_ms"] * 1e3
                rec["bound_ms"] = rec["bytes"] / PEAK_BYTES * 1e3
                rec["hbm_roofline_pct"] = 100.0 * rec["bound_ms"] / rec["kernel_ms"]
            res[key] = rec
            log(f"  12f AdamW {key}: {json.dumps(rec, default=float)}")
    return res


# ------------------------------------------------ phase 13: the user scripts


def unchecked_shapes(shapes, checked) -> list:
    """The shapes in ``shapes`` missing from ``checked`` (none when
    ``checked`` is None)."""
    return [] if checked is None else [sh for sh in shapes if sh not in checked]


def script_cuts(config_yaml, n_iter, epochs, overrides=None):
    """``config_yaml`` cut to depth for ``bench_full_torch.main``: its first
    ``n_iter`` iterations (zeus, then NUTS at T = 4, then 1), ``epochs``
    epochs and phase 7's convergence keys, one emulator through
    ``fused_log_prob``; ``overrides`` applied last.  Returns (overrides,
    the cuts as printed)."""
    from linna_tpu_torch.config import yaml_load

    params = yaml_load(os.path.join(ROOT, config_yaml), os.path.join(ROOT, "examples"))
    inf = [float("inf")] * n_iter
    cut = {k: params[k][:n_iter] for k in ("ntrainArr", "nvalArr", "nkeepArr")}
    cut.update(methodArr=["zeus", "nuts"][:n_iter], temperatureArr=[4.0, 1.0][:n_iter],
               num_epochs=epochs, ntimesArr=[0] * n_iter, ntautolArr=inf, meanshiftArr=inf,
               stdshiftArr=inf, nensemble=1, use_fused=True)
    cuts = {k: f"{params.get(k)} -> {v}" for k, v in cut.items()}
    cut.update(overrides or {})
    cuts.update({k: f"-> {v}" for k, v in (overrides or {}).items() if k not in cuts})
    return cut, cuts


def phase_scripts(device, outdir, lsst=SCRIPT_LSST, epochs=DRIVER_EPOCHS, lsst_overrides=None,
                  exact_path=None, polish=SCRIPT_POLISH, demo_steps=DEMO_STEPS,
                  exact_mod="examples.des_theory", exact_steps=EXACT_STEPS, exact_yaml=None,
                  stored_path=None, checked=None) -> dict:
    """Phase 13: the user scripts through the port.  13a the walkthrough;
    13b ``bench_full_torch.main`` on the LSST class cut to depth with one
    emulator through ``fused_log_prob`` (launched on every iteration, the
    plain versions never, and only at shapes in ``checked``, the (rows, in,
    out) shapes phase 3 held against the plain version); 13c the NUTS demo
    on 13b's last iteration; 13d ``bench_exact_posterior_torch.main`` at a
    short length against the stored exact posterior.  Each script's
    launches are counted from 0; 13b's iterations' from their ``mcmc``
    records in ``trace.json``.  The keywords let a CPU rehearsal run it at
    a small size (there the plain version stands in for the kernel)."""
    import bench_exact_posterior_torch as E
    import bench_full_torch as B
    from examples import nuts_flagship_demo_torch as D
    from examples import walkthrough_torch as W
    from linna_tpu_torch.ops import fused as F

    res: dict = {}
    card = device.type == "cuda"

    log("  13a: examples/walkthrough_torch.py")
    t0 = time.perf_counter()
    F.reset_counts()
    walk_dir = os.path.join(outdir, "walkthrough")
    w = W.main(walk_dir, device=device)
    res["13a"] = {"seconds": time.perf_counter() - t0, "counts": _launch_counts(),
                  "chain": list(w["chain"].shape)}
    missing = [f"iter_{i}/{f}" for i in range(2)
               for f in iteration_missing(os.path.join(walk_dir, f"iter_{i}"), 1, chain=True)]
    bad = [k for k in ("pred", "jac", "grad") if not np.isfinite(w[k]).all()]
    if missing or bad or w["jac"].shape != (2, 2):
        raise AssertionError(f"13a: missing {missing}, not finite {bad}, jacobian "
                             f"{w['jac'].shape}")
    log(f"  13a: {json.dumps(res['13a'])}")
    # its gradient at whitened 0: composition_grad on the card
    _no_kernel(res["13a"]["counts"], "13a (the walkthrough)", gradient_on_card=card)

    log("  13b: bench_full_torch.py on the LSST class, cut to depth")
    theory_mod, config_yaml = lsst
    overrides, cuts = script_cuts(config_yaml, 2, epochs, lsst_overrides)
    cuts.update({k: f"{getattr(B, k.upper())} -> {v}" for k, v in polish.items()})
    log(f"  13b: {config_yaml} cut to depth: {json.dumps(cuts)}")
    run_dir = os.path.join(outdir, "lsst")
    F.reset_counts()
    t0 = time.perf_counter()
    result = B.main(overrides=overrides, theory_mod=theory_mod, config_yaml=config_yaml,
                    device=device, exact_path=exact_path, outdir=os.path.join(run_dir, "run"),
                    indir=os.path.join(run_dir, "inputs"), **polish)
    counts = _launch_counts()
    # the card launches the kernel; the CPU runs its plain version in its place
    ran, idle = ("launches", "plain_calls") if card else ("plain_calls", "launches")
    shapes = sorted((F.launch_shapes if card else F.plain_shapes)["fused_log_prob"])
    with open(os.path.join(run_dir, "run", "trace.json")) as f:
        by_iteration = [{"iteration": r["iteration"], "method": r["method"], **r["kernels"]}
                        for r in json.load(f) if r["phase"] == "mcmc"]
    res["13b"] = {"seconds": time.perf_counter() - t0, "cuts": cuts, "result": result,
                  "counts": counts, "by_iteration": by_iteration,
                  # the precompile warm-up's launches and the polish's
                  "outside_iterations": {kind: {k: v - sum(r[kind][k] for r in by_iteration)
                                    for k, v in counts[kind].items()} for kind in counts},
                  "shapes": shapes}
    log(f"  13b: {json.dumps(res['13b'])}")
    if [r["iteration"] for r in by_iteration] != [0, 1] or any(
            r[ran]["fused_log_prob"] == 0 for r in by_iteration):
        raise AssertionError(f"13b: fused_log_prob's {ran} by iteration {by_iteration}: "
                             "each iteration must reach it")
    if any(counts[idle].values()):
        raise AssertionError(f"13b: {idle} {counts[idle]} on the LSST pipeline")
    unchecked = unchecked_shapes(shapes, checked)
    if unchecked:
        raise AssertionError(f"13b: fused_log_prob ran at (rows, in, out) {unchecked}, "
                             f"which phase 3 never held against its plain version")
    if "max_emulator_bias_sigma" not in result:
        raise AssertionError("13b: no exact posterior to hold the chain against")
    log(f"  13b: the gate's value at this depth (printed, not gated): max emulator bias "
        f"{result['max_emulator_bias_sigma']} sigma, median "
        f"{result['median_emulator_bias_sigma']}; split R-hat {result['max_split_rhat']} "
        f"after {result['polish_rounds']} polish rounds")

    log("  13c: examples/nuts_flagship_demo_torch.py on 13b's last iteration")
    F.reset_counts()
    t0 = time.perf_counter()
    ndim = result["ndim"]
    demo = D.main(os.path.join(run_dir, "run", "iter_1"), os.path.join(run_dir, "inputs"),
                  ndim=ndim, method="nuts", device=device, **demo_steps)
    res["13c"] = {"seconds": time.perf_counter() - t0, "steps": demo_steps, "demo": demo,
                  "counts": _launch_counts()}
    log(f"  13c: {json.dumps(res['13c'], default=float)}")
    _no_kernel(res["13c"]["counts"], "13c (the NUTS demo)", gradient_on_card=card)
    if not all(np.isfinite(demo[k]) for k in ("tau_nuts_max", "tau_slice_max",
                                               "ess_per_s_nuts", "ess_per_s_slice",
                                               "agree_sigma")):
        raise AssertionError(f"13c: {demo}")

    log("  13d: bench_exact_posterior_torch.py at a short length")
    F.reset_counts()
    t0 = time.perf_counter()
    exact = E.main(n_steps=exact_steps, theory_mod=exact_mod, device=device,
                   outdir=os.path.join(outdir, "exact"), config_yaml=exact_yaml,
                   stored_path=stored_path)
    res["13d"] = {"seconds": time.perf_counter() - t0, "n_steps": exact["n_steps"],
                  "against_stored": exact["against_stored"], "counts": _launch_counts()}
    log(f"  13d: {json.dumps(res['13d'])}")
    if not (np.isfinite(exact["exact_mean"]).all() and np.all(np.array(exact["exact_std"]) > 0)):
        raise AssertionError(f"13d: exact moments {exact}")
    _no_kernel(res["13d"]["counts"], "13d (the exact theory)")
    return res


def bench_cuts(overrides=None) -> dict:
    """Each measurement script's keyword arguments for phase 14 (``main``
    of the script), ``overrides`` (by script; a dict entry updates the
    cut's dict) applied last."""
    inf = float("inf")
    cuts = {
        "bench_torch": {"reps": 2},
        "bench_fused_torch": {"walker_counts": BENCH_FUSED_WALKERS, "reps": 1},
        "bench_bf16_torch": {"walker_counts": (1024,), "ensembles": (), "lsst_walkers": (1024,)},
        "bench_train_torch": {"epochs": 3},
        "bench_train_profile_torch": {"epochs": 3},
        "bench_dispatch_torch": {"epochs": 100},
        "bench_allopts_torch": {"schedule": {
            "n_iter": 2, "ntrain": 500, "nval": 100, "epochs": 100, "nimp": 200,
            # phase 7's convergence keys: each sampler stops at its second
            # tau check (200 steps)
            "ntimes": [0, 0], "ntautol": inf, "meanshift": inf, "stdshift": inf},
            "min_ess": None},
    }
    for name, kw in (overrides or {}).items():
        for k, v in kw.items():
            old = cuts[name].get(k)
            cuts[name][k] = {**old, **v} if isinstance(old, dict) else v
    return cuts


def phase_bench_scripts(device, outdir, overrides=None) -> dict:
    """Phase 14: the seven measurement scripts through the port, each
    ``main`` cut to depth (:func:`bench_cuts`, printed) with its result
    under ``outdir``.  ``bench_fused_torch`` must launch ``fused_log_prob``
    at every walker count with no plain call (the script holds every count
    and its half against the composition first, relative error below
    5e-4); ``bench_allopts_torch`` must leave its option artifacts and a
    finite chain.  Each script's kernel counts run from 0.  ``overrides``
    lets a CPU rehearsal run it small (there the plain version stands in
    for the kernel)."""
    import importlib

    from linna_tpu_torch.ops import fused as F

    card = device.type == "cuda"
    cuts = bench_cuts(overrides)
    mods = {name: importlib.import_module(name) for name in cuts}
    res: dict = {}
    for name, kw in cuts.items():
        kw = dict(kw)
        if name == "bench_torch":
            kw["history"] = os.path.join(outdir, "history.json")
        if name == "bench_allopts_torch":
            kw["outdir"] = os.path.join(outdir, "allopts")
        else:
            kw["out"] = os.path.join(outdir, f"{name}.json")
        log(f"  14: {name}.py cut to depth: {json.dumps(kw, default=str)}")
        F.reset_counts()
        t0 = time.perf_counter()
        result = mods[name].main(device=device, **kw)
        res[name] = {"seconds": time.perf_counter() - t0, "counts": _launch_counts(),
                     "result": result}
        log(f"  14: {name}: {res[name]['seconds']:.1f} s, counts {res[name]['counts']}")

    b = res["bench_torch"]["result"]
    if not (b["value"] > 0 and b["chain_finite"]) or b["path"] != (
            "cuda_graphs" if card else "eager"):
        raise AssertionError(f"14 bench_torch: {b}")
    fused = res["bench_fused_torch"]["result"]
    ran, idle = ("launches", "plain_calls") if card else ("plain_calls", "launches")
    for row in fused["rows"]:
        if (row["fused_counts"][ran] == 0 or row["fused_counts"][idle]
                or not row["max_rel_err"] < mods["bench_fused_torch"].RTOL):
            raise AssertionError(f"14 bench_fused_torch at {row['walkers']} walkers: {row}")
    for name in ("bench_torch", "bench_bf16_torch", "bench_train_torch",
                 "bench_train_profile_torch", "bench_dispatch_torch", "bench_allopts_torch"):
        _no_kernel(res[name]["counts"], f"14 {name}")
    train = res["bench_train_torch"]["result"]
    bad = {c: r for c, r in train["cases"].items() if not (
        r["sec_per_epoch"] > 0 and r["replays_per_epoch"]
        == ((r["minibatches_per_epoch"] + 1) if card else 0))}
    if bad:
        raise AssertionError(f"14 bench_train_torch: {bad}")
    prof = res["bench_train_profile_torch"]["result"]
    if sorted(prof["replays_per_epoch"]) != sorted(mods["bench_train_profile_torch"].VARIANTS) \
            or not all(prof[v] > 0 for v in prof["replays_per_epoch"]):
        raise AssertionError(f"14 bench_train_profile_torch: {prof}")
    disp = res["bench_dispatch_torch"]["result"]
    epochs = disp["shape"]["epochs"]
    if any(disp[m]["epochs_run"] != epochs for m in ("speculative", "serial")):
        raise AssertionError(f"14 bench_dispatch_torch: {disp}")
    allopts = res["bench_allopts_torch"]["result"]
    if not (all(allopts["artifacts"].values()) and allopts["chain_finite"]):
        raise AssertionError(f"14 bench_allopts_torch: {allopts}")
    log(f"  14: allopts at this depth (printed, not gated): importance ESS "
        f"{allopts['importance_ess']}, max posterior error {allopts['max_posterior_err_sigma']} "
        f"sigma, split R-hat {allopts['max_split_rhat']}")
    return res


# ------------------------------------- phase 15: the slow acceptance tier


def run_notebook(path: str, outdir: str, device) -> tuple:
    """The notebook's code cells in order in one namespace, as a kernel
    would run them (the card has no Jupyter), with ``LINNA_WALKTHROUGH_OUTDIR``
    and ``LINNA_WALKTHROUGH_DEVICE`` set for the run: (what the cells
    printed, the namespace)."""
    import contextlib
    import io

    with open(path) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    saved = {k: os.environ.get(k) for k in ("LINNA_WALKTHROUGH_OUTDIR",
                                            "LINNA_WALKTHROUGH_DEVICE")}
    os.environ.update(LINNA_WALKTHROUGH_OUTDIR=outdir, LINNA_WALKTHROUGH_DEVICE=str(device))
    ns: dict = {"__name__": "__main__"}
    out = io.StringIO()
    try:
        for i, cell in enumerate(cells):
            code = compile("".join(cell["source"]), f"{path} code cell {i}", "exec")
            with contextlib.redirect_stdout(out):
                exec(code, ns)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out.getvalue(), ns


def _scaling_checks(result: dict, card: bool) -> list:
    """What ``bench_scaling_torch.main``'s result must show: both trainer
    rows timed, each side's graph replays an epoch (nb + 1 a member on a
    card, none on the CPU), a finite chain and a rate at each rank count,
    the graph at one rank on a card, and the censuses' contract."""
    import bench_scaling_torch as S

    nb1 = S.N_TRAIN // S.BATCH + 1 if card else 0
    bad = [f"trainer K={r['k']}: {r}" for r in result["trainer"] if not (
        r["mesh_s"] > 0 and r["serial_s"] > 0 and r["mesh_replays_per_epoch"] == nb1
        and r["serial_replays_per_epoch"] == r["k"] * nb1 and r["graphed"] == card)]
    bad += [f"sampler at {r['devices']} ranks: {r}" for r in result["sampler"] if not (
        r["evals_per_s"] > 0 and r["finite"] and r["graphed"] == (card and r["devices"] == 1))]
    census = result["sampler_hlo"]
    if census["world"] > 1 and (census["emcee"]["per_step"] != {"all_gather@world": 2.0}
                                or census["hmc"]["per_step"] or census["nuts"]["per_step"]):
        bad.append(f"sampler census {census}")
    if result["hlo"]["cross_member_collectives"]:
        bad.append(f"trainer census {result['hlo']}")
    return bad


# the acceptance runs of phase 15; the flagship configuration
# (``flagship_config_posterior_parity``) stays out until its pin is decided:
# at its budget and seed it misses in about half the seeds of either package
ACCEPTANCE_ON_CARD = ("posterior_accuracy_2d_gaussian", "gaussian33_posterior_parity")


def phase_acceptance(device, outdir, budgets=None, pins=True, notebook=NOTEBOOK,
                     scaling=SCALING_CUTS) -> dict:
    """Phase 15.  15a: the JAX package's slow acceptance tier
    (``tests/_torch_acceptance.py``) that ``ACCEPTANCE_ON_CARD`` names (the
    2-D and the 33-dimensional Gaussian) at its tests' budgets and seeds,
    each pin enforced when ``pins`` (a miss
    fails the phase once 15b and 15c have run); 15b the
    walkthrough notebook's code cells (:func:`run_notebook`): the marker lines
    and the artifact tree; 15c ``bench_scaling_torch.main`` cut to depth
    (``scaling``, printed).  Each run's kernel counts run from 0 and must
    stay 0: K=2 takes the composition and the rest the unfused single
    emulator, as in the JAX package.  ``budgets`` ({name: ml_sampler_core
    overrides}, only the functions it names run) and ``pins=False`` let a
    CPU rehearsal run it small."""
    import bench_scaling_torch as S
    from linna_tpu_torch.ops import fused as F

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_acceptance as A

    card = device.type == "cuda"
    res: dict = {}
    missed: dict = {}
    log("  15a: flagship_config_posterior_parity not run: its pin at the JAX budget and "
        "seed flips with the seeds in both packages (PERF.md §6)")
    for name in ACCEPTANCE_ON_CARD:
        fn = A.ACCEPTANCE[name]
        if budgets is not None and name not in budgets:
            continue
        over = (budgets or {}).get(name, {})
        log(f"  15a: {name}" + (f", cut: {json.dumps(over)}" if over else
                                ", the JAX test's budget and seed"))
        F.reset_counts()
        r = fn(os.path.join(outdir, name), device, **over)
        res[name] = {**{k: v for k, v in r.items() if k != "chain"},
                     "chain": list(r["chain"].shape), "counts": _launch_counts()}
        log(f"  15a: {name}: {json.dumps(res[name])}")
        _no_kernel(res[name]["counts"], f"15a {name}")
        if not np.isfinite(r["chain"]).all():
            raise AssertionError(f"15a {name}: the chain is not finite")
        if pins and A.missed(r):
            missed[name] = A.missed(r)
            log(f"  15a: {name} MISSED its JAX pins {missed[name]}")

    log(f"  15b: {notebook}, its code cells in order")
    nb_out = os.path.join(outdir, "notebook")
    F.reset_counts()
    t0 = time.perf_counter()
    text, ns = run_notebook(os.path.join(ROOT, notebook), nb_out, device)
    res["notebook"] = {"seconds": time.perf_counter() - t0, "counts": _launch_counts(),
                       "chain": list(ns["chain"].shape),
                       "lines": [ln for ln in text.splitlines()
                                 if ln.startswith(NOTEBOOK_MARKERS)]}
    log(f"  15b: {json.dumps(res['notebook'])}")
    missing = [f"iter_{i}/{f}" for i in range(2)
               for f in iteration_missing(os.path.join(nb_out, f"iter_{i}"), 1, chain=True)]
    absent = [m for m in NOTEBOOK_MARKERS if m not in text]
    if missing or absent:
        raise AssertionError(f"15b: missing artifacts {missing}, marker lines {absent}")
    # its gradient at whitened 0: composition_grad on the card
    _no_kernel(res["notebook"]["counts"], "15b (the notebook)", gradient_on_card=card)

    log(f"  15c: bench_scaling_torch.py cut to depth: {json.dumps(scaling)} (epochs "
        f"{S.EPOCHS}, rank counts {list(S.RANKS)} uncut)")
    F.reset_counts()
    t0 = time.perf_counter()
    result = S.main(device=device, out=os.path.join(outdir, "scaling.json"), **scaling)
    res["bench_scaling"] = {"seconds": time.perf_counter() - t0, "counts": _launch_counts(),
                            "trainer": result["trainer"], "sampler": result["sampler"],
                            "census": {"hlo": result["hlo"],
                                       "sampler_hlo": result["sampler_hlo"]}}
    log(f"  15c: {json.dumps(res['bench_scaling'])}")
    bad = _scaling_checks(result, card)
    if bad:
        raise AssertionError(f"15c: {bad}")
    _no_kernel(res["bench_scaling"]["counts"], "15c (bench_scaling_torch, this process)")
    if missed:
        raise AssertionError(f"15a: pins missed {missed}")
    return res


def main() -> int:
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        return dp_rank(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--tensor-parallel-rank"]:
        return tp_rank(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--precompile-run"]:
        return precompile_run(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import backends

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    log("== 1. device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"  {name}, capability {cap}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")
    log(f"  chain store: {backends.store_kind()} (h5py importable: {backends.store_kind() == 'hdf5'})")
    log("  bf16 products may reduce in bf16 (PyTorch's default, left as it is): "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, the kernels are built for sm_90a")

    log("== 2. build")
    t0 = time.perf_counter()
    report = F.build()
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())
    resources = kernel_resources(report)
    log(f"  registers and spills: {resources}")
    from linna_tpu_torch.ops import adamw as AW

    t0 = time.perf_counter()
    adamw_report = AW.LIBRARY.build()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", adamw_report)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", adamw_report))
    log(f"  the AdamW kernel's library built in {time.perf_counter() - t0:.1f} s: "
        f"{len(regs)} instantiations, at most {max(regs, default=0)} registers, "
        f"{spills} bytes spilled")

    seconds = {}
    log("== 3. kernels against their plain versions")
    t0 = time.perf_counter()
    rec = phase_kernels(device)
    rec["fused_log_prob"]["row_dependence"] = row_dependence(device)
    rec["fused_log_prob"]["row_dependence_lsst"] = row_dependence(device, ndim=WIDE[0],
                                                                  ndata=WIDE[1])
    seconds[3] = time.perf_counter() - t0

    log("== 4. sampling slice")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        res = phase_slice(device, os.path.join(RUN_DIR, "iter_0"))
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[4] = time.perf_counter() - t0

    log("== 5. training at the DES width")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    shutil.rmtree(TRAINED_DIR, ignore_errors=True)
    F.reset_counts()
    try:
        phase_train(device, RUN_DIR)
        # phase 8 runs bf16 inference on the trained ensemble
        shutil.move(os.path.join(RUN_DIR, "train", "iter_0"), TRAINED_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    train_launches, train_plain = dict(F.launches), dict(F.plain_calls)
    log(f"  training path launches {train_launches}, plain calls {train_plain}")
    if train_launches["fused_log_prob"] == 0:
        raise AssertionError("fused_log_prob did not launch on the training path")
    seconds[5] = time.perf_counter() - t0

    log("== 6. gradient samplers and emcee through the likelihood kernel")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        gradient, path_launches = phase_gradient(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    log(f"  launches by path: {path_launches}")
    if any(path_launches[p]["fused_log_prob"] == 0 for p in ("gradient", "emcee")):
        raise AssertionError("fused_log_prob did not launch on the gradient or emcee path")
    seconds[6] = time.perf_counter() - t0
    log(f"  phase 6: {seconds[6]:.1f} s")

    log("== 6b. composition_grad: the K-member composition's value and gradient in one kernel")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        composition = phase_composition_grad(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds["6b"] = time.perf_counter() - t0
    log(f"  phase 6b: {seconds['6b']:.1f} s")

    log("== 7. the driver on des_synthetic.yaml, depth cut")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        phase_driver(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[7] = time.perf_counter() - t0
    log(f"  phase 7: {seconds[7]:.1f} s")

    log("== 8. the pre-model and bf16 inference at the DES width")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        premodel = phase_premodel(device, RUN_DIR)
        bf16 = phase_bf16(device, TRAINED_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        shutil.rmtree(TRAINED_DIR, ignore_errors=True)
    seconds[8] = time.perf_counter() - t0
    log(f"  phase 8: {seconds[8]:.1f} s")

    log("== 9. the multi-process layer: nccl at one rank, two gloo ranks on the card")
    log("  two ranks on one card use gloo (nccl refuses two ranks on one device); gloo "
        "takes the CUDA tensors of all_reduce and all_gather and copies them through the host")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        mp = phase_multiprocess(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[9] = time.perf_counter() - t0
    log(f"  phase 9: {seconds[9]:.1f} s")
    sharded = {m: mp["9c"]["chains"][m]["launches"]["ranks"] for m in ("emcee", "nuts")}

    log("== 10. the rest of the port: tensor parallelism, speculative dispatch, the "
        "helpers, the warm-up, pod acceptance")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        rest = phase_rest(device, RUN_DIR, gradient.pop("map"))
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[10] = time.perf_counter() - t0
    log(f"  phase 10: {seconds[10]:.1f} s")
    tp_launches = rest["10a"]["launches"]

    log("== 11. sampler programs: CUDA graphs against the eager steps, the K=4 ensemble")
    t0 = time.perf_counter()
    F.reset_counts()
    programs = phase_programs(device)
    seconds[11] = time.perf_counter() - t0
    log(f"  phase 11: {seconds[11]:.1f} s")

    log("== 12. training programs: CUDA graphs against the eager bodies")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        train_programs = phase_train_programs(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    adamw_rec = phase_adamw(device)
    seconds[12] = time.perf_counter() - t0
    log(f"  phase 12: {seconds[12]:.1f} s")

    log("== 13. the user scripts: the walkthrough, the LSST gate through fused_log_prob, "
        "the NUTS demo, the exact posterior")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        scripts = phase_scripts(device, RUN_DIR,
                                checked=rec["fused_log_prob"]["wide"]["checked"])
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[13] = time.perf_counter() - t0
    log(f"  phase 13: {seconds[13]:.1f} s")

    log("== 14. the measurement scripts: bench, fused, bf16, train, train profile, dispatch, "
        "all options")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        bench = phase_bench_scripts(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[14] = time.perf_counter() - t0
    log(f"  phase 14: {seconds[14]:.1f} s")

    log("== 15. the JAX package's slow acceptance tier, the walkthrough notebook, "
        "bench_scaling_torch.py")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        acceptance = phase_acceptance(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[15] = time.perf_counter() - t0
    log(f"  phase 15: {seconds[15]:.1f} s")

    log(f"== 16. result (phase seconds {json.dumps(seconds)})")
    kernels = []
    for k in REPLACES:
        r = rec[k]
        b = NWALKERS
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[k],
            "launches": res["launches"][k],
            "launches_by_path": {
                "sampling": res["launches"][k],
                "training": train_launches[k],
                "gradient": path_launches["gradient"][k],
                "emcee": path_launches["emcee"][k],
                "premodel": premodel["counts"]["launches"][k]
                + premodel["gradient"]["counts"]["launches"][k],
                "bf16": bf16["counts"]["launches"][k],
                "nccl_one_rank_emcee": mp["9a"]["grouped"]["launches"][k],
                "launcher_two_ranks_K4": [a[k] for a in mp["9b"]["launches"]],
                "sharded_emcee_per_rank": [r[k] for r in sharded["emcee"]],
                "sharded_nuts_per_rank": [r[k] for r in sharded["nuts"]],
                "tensor_parallel": {"one_rank": tp_launches["one_rank"][k],
                                    "two_ranks": [r[k] for r in tp_launches["ranks"]]},
                "speculative_training": rest["10b"]["launches"][k],
                "grad_log_prob": rest["10c"]["launches"][k],
                "precompile_warm": rest["10d"]["warm"]["warm"]["launches"][k],
                "programs_graphed_per_step": {
                    m: r["launches_per_step"] if k == "fused_log_prob" else 0
                    for m, r in programs["methods"].items()},
                "training_programs": train_programs["launches"][k],
                # iteration 0 (zeus), 1 (NUTS), then the warm-up and the polish
                "lsst_pipeline": [[f"iter_{r['iteration']}", r["method"], r["launches"][k]]
                                  for r in scripts["13b"]["by_iteration"]]
                + [["warm-up and polish", None,
                    scripts["13b"]["outside_iterations"]["launches"][k]]],
                "walkthrough": scripts["13a"]["counts"]["launches"][k],
                "nuts_demo": scripts["13c"]["counts"]["launches"][k],
                # walkers, launches of its fused rows (chunks and raw calls)
                "bench_fused": [[r["walkers"], r["fused_counts"]["launches"] if k ==
                                 "fused_log_prob" else 0]
                                for r in bench["bench_fused_torch"]["result"]["rows"]],
                "bench_scripts": {n: r["counts"]["launches"][k] for n, r in bench.items()},
                # the acceptance tier (K=2), the notebook, bench_scaling_torch
                "acceptance": {n: r["counts"]["launches"][k] for n, r in acceptance.items()},
            },
            "max_abs_err": r["abs"],
            "max_rel_err": r["rel"],
            "tolerance": {"rtol": RTOL, "atol": ATOL},
            "ms": r["ms"][b],
            "plain_ms": r["plain_ms"][b],
            "bound_ms": r["bound"][b]["ms"],
            "bound_by": r["bound"][b]["by"],
            "library_ms": None,
            "rows": b,
            "timing": r["method"],
            "plain_timing": r["plain_method"],
            "ms_by_rows": r["ms"],
            "bound_by_rows": r["bound"],
            "plain_ms_by_rows": r["plain_ms"],
            "call_ms_by_rows": r["call_ms"],
            "plain_call_ms_by_rows": r["plain_call_ms"],
            "launch_shape_by_rows": r["shape"],
            "lsst_ms_by_rows": r["wide"]["ms"],
            "lsst_plain_ms_by_rows": r["wide"]["plain_ms"],
            "lsst_bound_by_rows": r["wide"]["bound"],
            "lsst_launch_shape_by_rows": r["wide"]["shape"],
            **{key: r[key] for key in ("row_dependence", "row_dependence_lsst") if key in r},
            **resources.get(k, {}),
            **({"cluster_design": resources.get("fused_log_prob_cluster", {})}
               if k == "fused_log_prob" else {}),
            "check": "pass",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    k = "composition_grad"
    print(json.dumps({k: {
        "source": SOURCE,
        "replaces": "none: the JAX package's composition and its vmapped gradient are XLA's",
        "by_members": composition["members"], "nuts": composition["nuts"],
        "nuts_traced_chunk": composition.get("nuts_traced_chunk"),
        "launches_by_path": {
            "fused_gradient": path_launches["gradient"][k], "emcee": path_launches["emcee"][k],
            "premodel": premodel["counts"]["launches"][k]
            + premodel["gradient"]["counts"]["launches"][k],
            "bf16": bf16["counts"]["launches"][k],
            "walkthrough": scripts["13a"]["counts"]["launches"][k],
            "lsst_pipeline": scripts["13b"]["counts"]["launches"][k],
            "nuts_demo": scripts["13c"]["counts"]["launches"][k],
            "acceptance": {n: r["counts"]["launches"][k] for n, r in acceptance.items()}},
        **resources.get(k, {})}}, default=float), flush=True)
    print(json.dumps({"adamw": {"source": "linna_tpu_torch/ops/csrc/adamw.cu",
                                "launches": train_programs["adamw"]["launches"],
                                "by_case": adamw_rec}}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
