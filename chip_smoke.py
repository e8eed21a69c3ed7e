#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, train, time.

    python3 chip_smoke.py

1. Print the card's name and power limit (nvidia-smi).
2. Build the three kernel libraries from ``vae_connexe_torch/csrc/``
   (rollout, gru, step), one nvcc each, all started together; print
   ptxas's register and spill lines.
3. Hold each kernel against its plain PyTorch version on the card:
   - K1/K2 (rollout) on the resident route (``cuda_rollout.rollout_route``:
     every weight in shared memory, K1's heads over a thread-block
     cluster) at the serving width (p=20, H=64, T=21; B = 1, 8, 37, 3072),
     at p=4, H=8 with a random parents mask and at lorenz96_crvae's p=10;
     on the streamed route at lorenz96_scaled's p=40, H=128 (B = 1, 37, 512)
     and lorenz96_xl's p=128, H=128 (B = 1, 37; also in bf16), with the
     ErrorVAE at the same width; at henon_author's p=2, H=64 (B =
     1, 256: K1 on a 2-block cluster, one head a block); 1e-4 absolute (float32
     recurrences of 21 steps, products summed in another order); two
     calls on the same inputs give bitwise-equal outputs; each case's plan
     (cluster, heads a block, tile, k split, clusters launched, shared
     memory) and the card's cudaOccupancyMaxActiveClusters are printed.
   - B1/B2 (GRU recurrence) at the phase-1 decoder shape (P=20, T=10,
     B=256, D=20, H=64, shared input, h0 broadcast from z), the encoder
     shape (P=1) and a ragged B=37 with per-head input and a random
     parents mask: outputs 1e-5 absolute, every gradient from a random
     douts rtol 1e-3, atol 1e-4 (the order of the JAX package's own
     kernel tests: each gradient sums B*T products in another order); two
     B1 calls on the same inputs must give bitwise-equal outputs.
     B2's two kernels against their plain phases at the same three cases
     and tolerance: the chain's gate gradients gh and dh0, the
     weight-gradient kernel's dx, dW and db from the plain gh; and two B2
     calls on the same inputs must give bitwise-equal gradients.  The same
     checks of the wide variants (B1 as the input projection and the walk
     on clusters, its plan printed; B2's chain as the input projection,
     held against x W_ih^T + b_ih at ``XPROJ_TOL``, and the walk on
     clusters, its plan printed) at ``lorenz96_scaled``'s decoder (P=40,
     B=512, T=30, D=40, H=128, a random parents mask) and encoder (P=1,
     T=10) shapes, ``lorenz96_xl``'s decoder (P=128, B=64, T=30, D=128)
     and hidden 130 (P=6, B=100, T=12, D=40, a per-head input); and on the
     kernel route at the W_in family's shapes: henon6d_win's decoder (6
     heads, B=256, T=10, a per-head x of width 64, dx on), the 8-seed fold
     of it (48 heads), its ErrorVAE (1 head, D=6, H=32) and var_crvae's
     decoder (5 heads, B=16); there the
     chain's outputs keep GRAD_TOL and each summed gradient is held to
     1e-5 of its largest magnitude (``LONG_SUM_TOL``: at B*T = 15,360 the
     float32 plain version itself is off a float64 one by more than
     GRAD_TOL).
   - B3 (whole phase-1 step) at p=20, H=64, ctx=20, B=256, lam=0.1,
     lr=5e-2, beta=0.1, random parents: one step and a 5-step trajectory,
     params and metrics rtol 1e-4, atol 1e-6 (the JAX package's one-step
     order; an SGD step of lr=5e-2 scales the gradients' rounding down).
     Each of B3's launches against its plain phase on the same inputs (the
     kernel's own buffers from the launches before it): the encoder and
     decoder states 1e-5 absolute, as B1's outputs; the readout, both
     chains, both weight-gradient kernels and the latent phase rtol 1e-3,
     atol 1e-4, as B2's gradients.  Two B3 calls on the same inputs must
     give bitwise-equal params and metrics.
   - B1/B2 at phase 2's call sites: five ``make_phase2_step`` steps at
     p=20, H=64, ctx=20, B=256 with a random binary mask on the card
     (four one-head or p-head recurrences a step, the ErrorVAE's decoder
     from a differentiable h0) against the same steps on the CPU's plain
     recurrences on the same draws: params, ErrorVAE params, Adam's state
     and metrics rtol 1e-4, atol 1e-6; two card runs bitwise equal.
   - B1/B2 at the W_in trainer's call sites: five stage-I and five
     stage-II steps of henon6d_win's model (d=6, H=64, Z=32, tau=10,
     B=256) on the card against the same steps on the CPU's plain
     recurrences on the same batches and epsilons, for both prox groups
     and both stage-II rules: params, Adam's moments and metrics rtol
     1e-4, atol 1e-6; two card runs bitwise equal; 2 + 2 launches a
     stage-I step and 4 + 4 a stage-II step at S = 1, 3, 8; a 3-seed
     ``fit_many`` against the three single ``fit``s on the card (same
     tolerance), bitwise repeatable.
   - vrae_demo's training step (the GRU encoder through B1/B2): five
     steps at its schedule on the card against the same steps on the
     CPU's plain recurrences, from the same parameters and data with the
     same epsilon and coins passed in: params, Adam's moments and metrics
     rtol 1e-4, atol 1e-6; one B1 and one B2 launch a step.
   - K1/K2 in bf16 (bf16 weights and carries, float32 sums; on the
     resident route the tensor-core body, mma.sync on bf16 with float32
     accumulators) at the serving width (p=20, H=64) and lorenz96_scaled's
     (p=40, H=128), B = 3072 and 1, against their plain bf16 versions
     (``bf16_agreement``): every output element a bf16 value, at least
     BF16_SAME of them equal to the plain version's bit for bit, each
     within BF16_TOL * (|plain| + 1); the float32 kernels on the same
     inputs fail that check (the control); two calls bitwise
     equal, on the route the plan names (printed for both storage types:
     in bf16 K2 at H=128 is resident, K1 there stays streamed); the bf16
     generation against the float32 kernels' on the same draws within the
     JAX package's bounds (tests/test_serve_dtype.py); timed by CUDA
     events beside the float32 kernels and the bf16 bound, with each
     plan's cluster, tile and shared memory and the bit-equal share.
     ``python3 chip_smoke.py --phase bf16`` runs the build, this check and
     the vrae_demo step check alone.
   - B1/B2 at the sweep's call sites: five steps of a 3-seed sweep at
     lorenz96_crvae's width (the encoder one 3-head launch, the decoder
     one 30-head launch a step) against each seed's single-seed step loop
     on the card, on the same generators: params, best params and best
     loss rtol 1e-4, atol 1e-6; two sweeps bitwise equal.
4. The main paths, each with the launch counts set to 0 just before it and
   read just after:
   - serving: a port-initialised CRVAE(p=20, H=64) + ErrorVAE(d=20, H=64),
     exported at batch 3072, loaded and served by ``GeneratorServer``; the
     served samples are held against the plain versions on the same draws;
     every launch on the resident route;
   - serving at lorenz96_scaled's width (p=40, H=128, batch 512): three
     generations through the loaded artifact, every launch on the streamed
     route, held against the plain versions; three through its bf16
     artifact (K1 bf16 streamed, K2 bf16 resident), held against the
     plain bf16 versions;
   - training: ``fit_phase1`` on a Lorenz-96 series made on the card (p=20,
     T=2048, windows of 20) at H=64, B=256 for 300 steps: 2 B1 and 2 B2
     launches a step, every recurrence on the kernel route, a finite loss
     that falls;
   - training at ``lorenz96_scaled``'s shape (p=40, H=128, B=512, windows
     of 40 from a series of 4096 steps made on the card) for 30 steps:
     2 launches a step of each of B1's and B2's wide variants
     (``cuda_gru.recurrence_route``: the two weights do not fit a block
     together at hidden 128) and none of the others, a finite loss that
     falls;
   - the whole-step kernel: 200 ``fused_phase1_step`` steps on the same
     windows: one B3 launch a step, a loss that falls;
   - the run: ``cli.main(["run", "lorenz96_crvae", ...])`` in this process
     at the full width (p=10, T=2048, H=64, B=256), steps cut from
     5000/10000 to 1000/1000: exactly 2 B1 + 2 B2 launches a phase-1 step
     and 4 + 4 a phase-2 step (read at every chunk's log line), every
     recurrence a launch; graph recovery, the phase-1 GC AUROC against the
     circulant truth at least the JAX package's at the same configuration
     and step count (``tools/jax_phase1_auroc.py``) minus a margin; every
     head input column off the phase-1 mask exactly zero in the phase-2
     best params; phase-2 ``recon`` and ``loss_e`` finite and lower at the
     last chunk than at the first; the generation metrics printed;
   - kill and resume: a 100-step phase 2 at p=20 with snapshots every 50
     steps, stopped after the first chunk and resumed, bitwise equal to the
     uninterrupted fit;
   - the port's own weights served: ``cli export`` of the run's
     ``ckpt_phase2``, ``GeneratorServer`` answering three ``/generate``
     requests on the resident route, held against the plain versions on
     the same draws; the same for ``--serve-dtype bfloat16`` (bf16
     launches only, /meta's serve_dtype, held against the plain bf16
     version by ``trained_ok`` beside a plain version with exact sums,
     equal to in-process bf16 generation); both artifacts (``torch.export`` programs over the
     kernels' custom ops) loaded in a fresh process that must import no
     model, trainer or config module, the float32 samples within 1e-4 of
     in-process generation;
   - the sweep: ``cli sweep`` at its defaults (lorenz96_crvae's width, 8
     seeds of 1000 steps): exactly 2 B1 + 2 B2 launches a sweep step,
     every seed's AUROC against the circulant truth at least the JAX
     package's minus the margin, the stability selection printed;
   - discovery: ``cli discover`` on a Lorenz-96 series (p=10, T=2048,
     made on the card) saved as a CSV with a header, 8 seeds of 1000
     steps, phase 2 for 200 steps, 64 samples: 2 + 2 launches a sweep
     step, 4 + 4 a phase-2 step, one B5 and one B4 launch; the seed-median
     scores' AUROC as above; finite (64, 21, 10) samples; the header's
     names in the edges.
   - the W_in family through ``cli.main``, each with --out-dir and
     --save-checkpoints: ``run henon6d_win`` (epochs cut from 2000 + 1000
     to 200 + 100, its 8 stability seeds kept) and ``run var_crvae`` (its
     own 100 + 30 epochs and 8 seeds): 2 + 2 launches a stage-I step and
     4 + 4 a stage-II step, the folded seeds' and the rest's launches
     exact, ``gc_offdiag_auto.auroc`` at least the JAX package's at the
     same counts (``tools/jax_win_auroc.py``, a CPU run) minus the margin,
     a finite stability row, the JAX package's files (PNGs aside: the
     card's machine has no matplotlib, and the run names the figures it
     skipped on stderr); ``run henon_author`` (p=2, phase 1 at its own
     1000 steps, phase 2 cut from 10000 to 1000): 2 + 2 / 4 + 4 launches,
     K1 and K2 twice on the resident route; its graph is seed-dependent,
     so phase 1 also trains at 64 seeds in one seed sweep and the share
     of seeds whose ``gc_dynamics.auroc`` reads 1.0 is held against the
     JAX package's share at as many seeds less two standard errors;
   - win serving: ``cli export henon6d_win`` of that run's ``ckpt_win``,
     ``cli generate --context`` on windows of the series, and
     ``GeneratorServer`` answering three context requests (equal to
     ``WInCRVAE.generate`` on the same seed within 1e-5) and refusing a
     malformed context with a 400; its float32 and bf16 artifacts loaded
     in a fresh process (no model or trainer module), each within 1e-5 of
     ``WInCRVAE.generate`` at its dtype;
   - win discovery: ``cli discover --family win --prox row --seeds 8`` on
     a coupled-Henon CSV made on the card, 200 stage-I epochs: 2 + 2
     launches a step of the one folded fit; the seed-median scores'
     off-diagonal AUROC at least the JAX package's at the same counts
     minus the margin.
   - out of core: ``cli run lorenz96_crvae`` at OOC_STEPS steps a phase in
     memory and with ``--out-of-core`` (the series in a file behind the
     native window loader): results, both checkpoints and launches bit
     for bit equal; a streamed phase 1 from that file killed at half and
     resumed, bitwise the uninterrupted streamed fit and ``fit_phase1``.
   - meshes (``check_meshes``; the card is one H100, so NCCL runs only a
     world of one, and two ranks share the card over gloo with CUDA
     tensors, the all-gathers and sends staged through the host): a world
     of one rank over NCCL in this process, ``fit_phase1(mesh=make_mesh())``
     at p=20, H=64, B=256 for 100 steps bit for bit the unmeshed fit with
     2 + 2 launches a step; then two ranks of this script
     (``--mesh-rank``), each run beside the single-process run on the
     card (params rtol 2e-5 / atol 1e-6, the loss rtol 1e-4, the
     tolerances of tests/test_meshed_fit.py): a dp=2 fit at p=20 (2 + 2
     launches a step on each rank), an sp=2 fit at lorenz96_longhorizon's
     shapes (ctx 128, T_dec 118, 59 steps a chunk, B=128, 50 steps: the
     encoder and two chunk rounds a step, 3 + 3 launches), lorenz96_xl's
     width at ep=2 (64 wide heads a rank, B=64, 30 steps, 2 + 2 wide
     launches), make_sharded_generator at B=3072 in float32 and bf16 (one
     K1 and one K2 a rank; 1e-5 of the single-process generation on the
     same draws, bf16 within BF16_TOL); and ``cli run lorenz96_crvae
     --processes 2 --ep 2`` at 300 + 300 steps against ``cli run`` in
     this process: the same binary graph, both phases' params within
     2e-5 / 1e-6, the losses within 1e-4, 6 + 6 launches a phase-1 plus
     phase-2 step pair on each rank.  Steps/s and generation times are
     printed meshed beside single, labelled as two ranks sharing one
     card (not scaling); ``python3 chip_smoke.py --phase meshes`` runs
     this phase alone.
5. Time each kernel (CUDA events) beside its plain version, its bound and,
   where one PyTorch call computes the same function, that call (cuDNN
   ``nn.GRU`` at the one-head encoder shape for B1/B2), B1's and B2's
   device time alone from ``torch.profiler``, B2's chain and
   weight-gradient kernels apart (CUDA events through their wrappers, and
   by the profiler) and B3's eleven kernels by
   device time (profiler); time K1, K2 and compensated generation at
   B=1 and B=3072 on both routes (resident at p=20, H=64; streamed at
   p=40 and p=128, H=128), and phase-1
   steps/s through ``make_phase1_step`` (B1/B2) and ``fused_phase1_step``
   (B3); the wide variants the same way at ``lorenz96_scaled``'s shapes
   and B2 at ``lorenz96_xl``'s heads, with the wide chain's plan, its
   time beside its share of the bound and the projection's;
   the sweep's steps/s and seed-steps/s at p=10 and p=20 for 1, 8 and 32
   seeds beside ``fit_phase1``'s, its device busy share, kernels and draw
   kernels a step, and B1/B2 at S * p heads beside their bound; the W_in
   trainer's stage-I and stage-II steps/s at henon6d_win's shapes and
   their busy share, ``fit_many``'s seed-steps/s at S=8, B1/B2 at the W_in
   decoder's shapes (6 and 48 heads) beside their bound, and the win
   generation's latency at B=8 and 256 with its kernels a step; the
   exported program's ``fn(seed)`` host time beside in-process
   generation's; a streamed phase-1 fit at p=20 from an 800 MB series
   file (windows of 16 GB in memory) beside the in-memory fit, steps/s
   and ``gather_wait_s``.
6. Print one JSON line of per-kernel results, the nvidia-smi line, and the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when any phase fails or when no CUDA
device is present.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TOL = 1e-4
P, H, T, SERVE_B = 20, 64, 21, 3072
CHECK_BATCHES = (1, 8, 37, SERVE_B)
# Phase 1 at bench.py's train width: context 20 = encoder 10 + decoder 10.
CTX, ENC, TRAIN_B, SERIES_T = 20, 10, 256, 2048
OUT_TOL = 1e-5                              # B1 outputs, absolute
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)       # B2 gradients
# The wide chain's input projection against x W_ih^T + b_ih: sums of D <=
# 128 float32 products in another order.
XPROJ_TOL = dict(rtol=1e-5, atol=1e-5)
# The wide chain's gh and dh0 against the plain chain, besides GRAD_TOL:
# its products run as three TF32 passes each, which keep a float32
# product's accuracy, and this limit holds them to it.  A build whose
# products take one TF32 pass (tools/torch_gru_wide_probe.py --control)
# must fail it: on an H100 at the three wide cases the chain read 0.09-0.14
# of this limit (max abs 4.1-4.5e-6), the one-pass build 55-74x it (max
# abs 2.2-2.6e-3).
WIDE_CHAIN_TOL = dict(rtol=1e-5, atol=2e-5)
# B2's weight gradients at lorenz96_scaled's shapes sum B*T = 15,360 rows
# of values up to ~470: there the float32 plain version itself departs from
# a float64 one by more than GRAD_TOL (5.3e-4 on dW_ih), so each gradient
# is held to this fraction of its largest magnitude instead (float32 sums
# in another order; the plain version's own departure is ~2e-6 of it).
LONG_SUM_TOL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-6)       # B3: one step and five
FIT_STEPS, STEP_STEPS = 300, 200
# lorenz96_crvae through the command line: both phases cut from 5000/10000
# steps to RUN_STEPS; the phase-2 kill-and-resume and timing fits.
RUN_STEPS, RESUME_STEPS, RATE_STEPS = 1000, 100, 200
CRVAE_P = 10
# lorenz96_scaled (vae_connexe_tpu/configs/experiments.py): p=40, T=4096,
# context 40, H=128, B=512; cut to 30 steps.
SCALED_P, SCALED_H, SCALED_B, SCALED_CTX, SCALED_T = 40, 128, 512, 40, 4096
XL_P, XL_H = 128, 128                                   # lorenz96_xl
SCALED_STEPS = 30
# lorenz96_crvae's phase-1 AUROC from the JAX package on a CPU at the same
# configuration and 1000 steps (tools/jax_phase1_auroc.py), and the margin
# the port's may fall below it (another series and other draws).
JAX_AUROC, AUROC_MARGIN = 1.0, 0.05
# The sweep: ``cli sweep``'s defaults (lorenz96_crvae's width, 1000 steps, 8
# seeds); ``cli discover`` with as many seeds and steps (cut from its 2000)
# and a phase 2 of DISCOVER_P2 steps; the check's seeds; the rate cells.
SWEEP_STEPS, SWEEP_SEEDS, SWEEP_CHECK_SEEDS = 1000, 8, 3
DISCOVER_P2, DISCOVER_GEN = 200, 64
SWEEP_RATE_SEEDS, SWEEP_RATE_STEPS = (1, 8, 32), 50
# The W_in family: henon6d_win's model (d=6, H=64, Z=32, tau=10, batch
# 256); the runs through ``cli run`` with their (stage-I, stage-II) epochs
# (henon6d_win cut from 2000 + 1000, var_crvae at its own 100 + 30) and
# henon_author's (phase-1, phase-2) steps (phase 2 cut from 10000); the JAX
# package's reference AUROC at those counts on a CPU (tools/jax_win_auroc.py:
# gc_offdiag_auto.auroc of the win runs at seed 0, and the scores'
# off-diagonal AUROC of ``cli discover --family win`` at its counts,
# ``discover_win``; its printed lines in tools/jax_win_auroc.jsonl); cli
# discover's stage-I epochs; the rate epochs.
WIN_D, WIN_TAU, WIN_B, WIN_Z = 6, 10, 256, 32
WIN_RUNS = {"henon6d_win": (200, 100), "var_crvae": (100, 30)}
AUTHOR_RUN = (1000, 1000)
JAX_WIN_AUROC = {"henon6d_win": 1.0, "var_crvae": 1.0, "discover_win": 1.0}
# henon_author's graph ranking depends on the seed in both packages (x's
# own lags carry y, so the x <- y and y <- y scores trade places between
# inits; a seed's gc_dynamics AUROC reads 1.0 or 0.333-0.833), so no one
# seed is gated: phase 1 trains at AUTHOR_SEEDS seeds at once (the seed
# sweep, the run's 1000 steps), and the share of seeds that read 1.0 must
# be at least the JAX package's share at as many seeds and the same steps
# (tools/jax_win_auroc.py ``author_sweep``, a CPU run) less two standard
# errors of the difference of two such shares.
AUTHOR_SEEDS, JAX_AUTHOR_SHARE = 64, 0.53125
WIN_DISCOVER_EPOCHS, WIN_RATE_EPOCHS = 200, 5
# lorenz96_crcsrae (p=10, ctx 20, H=64, latent_reg='cs' against a GMM prior
# of 10 components): phase 1 at batch 2048 for its full 2000 steps, so that
# the JAX package's committed phase-1 AUROC applies
# (results/lorenz96_crcsrae/metrics_lorenz96_crcsrae.json: 0.9875), phase 2
# at batch 1024 cut from 10000 steps to RUN_STEPS; csrae_binarized at its
# own 30 epochs against the JAX package's committed recon_accuracy
# (results/csrae_binarized/: 0.881); vrae_demo at its own 100 epochs (no
# committed JAX result); the rate steps and epochs.
CS_NAME, CS_B1, CS_B2 = "lorenz96_crcsrae", 2048, 1024
JAX_CS_AUROC, JAX_CSRAE_ACC, A4_MARGIN = 0.9875, 0.881, 0.05
CSRAE_RATE_EPOCHS, VRAE_RATE_EPOCHS = 5, 50
# vrae_demo's step on the card against the CPU's: epochs of its schedule
# from the same parameters, data, epsilon and coins.
VRAE_CHECK_STEPS = 5
VRAE_LINE = r"^\[(vrae) epoch=(\d+)\] total=([-\d.e+]+)"
# bf16 serving (K1/K2's bf16 instantiations, bf16 weights and carries):
# a kernel's output against its plain bf16 version on the same inputs
# (bf16_agreement).  Every output element is a bf16 value (the emitted x
# is a bf16 carry); at least BF16_SAME of the elements equal the plain
# version's bit for bit; each is within BF16_TOL * (|plain| + 1).  The two
# sum the products in other orders, so a sum that lands on the other side
# of a bf16 rounding moves that carry by one bf16 step.  On an H100 with
# random weights (chip_smoke.py runs, PERF.md): 0.962-1.0 of the elements
# bit-equal and at most 2.58e-3 of (|plain| + 1) apart over BF16_SHAPES,
# while bf16 generation lies up to 6.1e-3 from the float32 kernels on the
# same draws.  The float32 kernel on the same inputs is the control and
# must fail the check: as it is (no bf16 values) and rounded to bf16 once
# at the output (0.44-0.59 bit-equal).  The bf16 samples are
# also held against the float32 kernels' within the JAX package's bounds
# (tests/test_serve_dtype.py: elementwise 0.15 * (max |f32| + 1), each
# series' mean within 0.02, its standard deviation rtol 0.05 / atol 0.02).
# A trained generator (lorenz96_crvae's weights) carries a flipped
# rounding on through its later steps (2.08e-2 after 21 steps), so there
# each row is held to BF16_TOL at the step where it first departs from
# the plain version, and the rows beyond BF16_TOL to at most twice those
# of a second plain version that sums exactly (float64) before each bf16
# rounding: summing in another order departs that far by itself.
# At lorenz96_xl's width (128 heads) random weights flip a rounding within
# a row's first steps too, and a plain version with exact sums shares
# fewer than BF16_SAME of its elements with the plain version (K1 on an
# H100: 0.77 at B=1, 0.85 at B=37, this script's check lines); there
# ``departs_ok`` holds the kernel's share to WITNESS_SHARE of the
# witness's and each row's first departure to the witness's.  On an H100
# the kernel's share was 0.90 of the witness's at B=1 (0.69 against 0.77)
# and 1.03 at B=37 (0.88 against 0.85), the float32 control's rounded to
# bf16 at the output 0.54 and 0.53 (0.42, 0.45).
BF16_TOL, BF16_SAME, WITNESS_SHARE = 2.0 ** -8, 0.9, 0.8
BF16_SHAPES = ((P, H, SERVE_B), (P, H, 1), (SCALED_P, SCALED_H, SERVE_B),
               (SCALED_P, SCALED_H, 1), (XL_P, XL_H, 1), (XL_P, XL_H, 37))
# Out of core: cli run lorenz96_crvae in memory and --out-of-core at
# OOC_STEPS a phase; the throughput fit at p=20 from a file of OOC_ROWS
# steps (a Lorenz-96 simulation of OOC_SIM steps tiled: 800 MB, whose
# windows of 20 would take 16 GB), OOC_RATE_STEPS steps a fit.
OOC_STEPS, OOC_ROWS, OOC_SIM, OOC_RATE_STEPS = 300, 10_000_000, 20_000, 400
# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, bf16 and TF32 in them, and HBM3 bandwidth.
F32_FLOPS, BF16_FLOPS, TF32_FLOPS = 67e12, 989e12, 495e12
HBM_BYTES_S = 3.35e12
# A float32 product as three TF32 passes (the wide chain's products).
TF32X3_FLOPS = TF32_FLOPS / 3


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def rollout_cost(b, t, heads, hidden, d, outs, noise: bool, x0: bool,
                 weight_bytes: int = 4):
    """(flops, bytes) the card must at least spend on one rollout launch:
    the multiply-adds of the input, hidden and readout products (the gate
    math, ~2% more, is not counted), and every input read once and the
    output written once; the weights at ``weight_bytes`` each (2 for the
    bf16 instantiations), the rest float32."""
    g = 3 * hidden
    flops = 2 * b * t * heads * (g * d + g * hidden + outs * hidden)
    weights = heads * (g * d + g * hidden + 2 * g + outs * hidden + outs)
    elems = (b * hidden + (b * d if x0 else 0)
             + (b * t * d if noise else 0) + b * t * d)
    return flops, 4 * elems + weight_bytes * weights


def gru_cost(p, b, t, d, hidden, backward: bool, per_head: bool = False):
    """(flops, bytes) of one B1 (forward) or B2 (backward, no dx) launch.

    Forward: the input and hidden products of every step.  Backward: those
    again (the gates are rematerialised from the saved states, which is
    the work these inputs need), d h_prev and the dW_hh and dW_ih outer
    products.  Bytes: x (one per head when ``per_head``), the weights and
    h0 read once and the outputs written once (backward: plus outs and
    douts read, the weight gradients and dh0 written)."""
    g = 3 * hidden
    fwd = 2 * p * b * t * g * (d + hidden)
    weights = p * (g * d + g * hidden + 2 * g)
    states = p * b * t * hidden
    x = (p if per_head else 1) * b * t * d
    if not backward:
        return fwd, 4 * (x + weights + b * hidden + states)
    flops = fwd + 2 * p * b * t * g * (2 * hidden + d)
    return flops, 4 * (x + 2 * weights + p * b * hidden + b * hidden
                       + 2 * states)


def chain_cost(p, b, t, d, hidden):
    """(flops, bytes) of B2's chain alone (the wide route's projection and
    walk): the rematerialised gates (the forward's products) and d h_prev;
    x, the weights, h0, outs and douts read once, gh and dh0 written
    once."""
    g = 3 * hidden
    flops = 2 * p * b * t * g * (d + hidden) + 2 * p * b * t * g * hidden
    states = p * b * t * hidden
    return flops, 4 * (b * t * d + p * (g * d + g * hidden + 2 * g)
                       + b * hidden + 2 * states + 4 * states + p * b * hidden)


def b2_wide_bound(p, b, t, d, hidden):
    """(ms, by) bound of one wide B2 launch: the chain's products at
    ``TF32X3_FLOPS`` (they run as three TF32 passes on the tensor cores),
    then the weight gradients' at ``F32_FLOPS`` (another kernel, after
    it), against gru_cost's bytes."""
    flops, nbytes = gru_cost(p, b, t, d, hidden, backward=True)
    chain = chain_cost(p, b, t, d, hidden)[0]
    t_ops = (chain / TF32X3_FLOPS + (flops - chain) / F32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b1_wide_bound(p, b, t, d, hidden):
    """(ms, by) bound of one wide B1 launch with its products at
    ``TF32X3_FLOPS`` (the projection and the walk run as three TF32 passes
    on the tensor cores), against gru_cost's bytes; ``bound(*gru_cost(...,
    backward=False))`` is the f32 one."""
    return bound(*gru_cost(p, b, t, d, hidden, backward=False), TF32X3_FLOPS)


def wgrad_cost(p, b, t, d, hidden):
    """(flops, bytes) of B2's weight-gradient kernel (no dx): the dW_hh and
    dW_ih outer products over B*T rows; gh, x, h0 and outs read once, the
    weight gradients and bias sums written once."""
    g, k = 3 * hidden, b * t
    return (2 * p * k * g * (hidden + d),
            4 * (p * k * 4 * hidden + b * t * d + p * b * hidden
                 + p * k * hidden + p * g * (hidden + d + 2)))


def xproj_cost(p, b, t, d, hidden):
    """(flops, bytes) of the wide chain's input projection: x W_ih^T for
    every head, x and the weights read once, (P, B, T, 3H) written."""
    g = 3 * hidden
    return (2 * p * b * t * g * d,
            4 * (b * t * d + p * (g * d + g) + p * b * t * g))


def step_cost(p, b, t, e, hidden):
    """(flops, bytes) of one phase-1 step (B3): the encoder, fc and decoder
    products forward, their backward (no rematerialisation: one function of
    the parameters and the batch), the readouts; the batch, eps, mask and
    parameters read once, the new parameters and metrics written once."""
    g, td = 3 * hidden, t - e
    enc = 2 * b * e * g * (p + hidden)
    dec = 2 * p * b * td * g * (p + hidden)
    fc = 2 * 2 * b * hidden * hidden
    ro = 2 * p * b * td * hidden
    flops = (enc + dec + fc + ro                    # forward
             + 2 * b * e * g * (2 * hidden + p)     # encoder backward
             + 2 * p * b * td * g * (2 * hidden + p)  # decoder backward
             + 2 * fc + 2 * ro)
    params = (g * p + g * hidden + 2 * g + 2 * (hidden * hidden + hidden)
              + p * (g * p + g * hidden + 2 * g + hidden + 1))
    return flops, 4 * (b * t * p + b * hidden + p * p + 2 * params + 5)


def bound(flops, nbytes, peak=F32_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_ms(fn, iters: int,
               counts: dict | None = None) -> tuple[float, dict[str, float]]:
    """``fn`` over ``iters`` calls under ``torch.profiler``: (wall ms a
    call under the profiler, {kernel name: device ms a call}), the host's
    operators left out; ``counts`` receives {kernel name: launches a
    call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0:
            out[e.key] = us / iters / 1e3
            if counts is not None:
                counts[e.key] = e.count / iters
    return wall, out


def device_ms(fn, iters: int) -> dict[str, float]:
    """Device time of ``fn`` by kernel: {kernel name: ms a call}."""
    return profile_ms(fn, iters)[1]


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace and arguments:
    "void (anonymous namespace)::step_readout(vcx::StepArgs)" ->
    "step_readout"."""
    m = re.search(r"(\w+(?:<[^>]*>)?)\(", key)
    return m.group(1) if m else key


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel from ptxas's -v report: its name (demangled by
    c++filt where there is one), registers and spill bytes."""
    rows, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            rows[cur] = ["", ""]
        elif cur and "spill stores" in line:
            rows[cur][1] = line.strip()
        elif cur and "Used" in line and "registers" in line:
            rows[cur][0] = re.search(r"Used (\d+) registers", line).group(0)
    names = list(rows)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        shown = out.stdout.splitlines() if out.returncode == 0 else names
    except OSError:
        shown = names
    if len(shown) != len(names):
        shown = names
    return [f"{kernel_name(d)}: {rows[n][0]}; {rows[n][1]}"
            for n, d in zip(names, shown)]


def route_counts(counts=None, **nonzero) -> dict:
    """The whole rollout count dict ``counts`` (default
    ``cuda_rollout.ROUTE_LAUNCHES``: both kernels, both storage types and
    both routes) a phase should leave: ``nonzero``'s counts, 0 elsewhere."""
    from vae_connexe_torch.ops import cuda_rollout as cr

    return {k: nonzero.get(k, 0)
            for k in (cr.ROUTE_LAUNCHES if counts is None else counts)}


def make_models(p, hidden, seed, dev):
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE

    g = torch.Generator().manual_seed(seed)
    model, err = CRVAE(p=p, hidden=hidden), ErrorVAE(d=p, hidden=hidden)
    return model, err, model.init(g, dev), err.init(g, dev), g


def rollout_plan_line(kind, p, b, d, hidden, dev, elem=4) -> str:
    """The plan a rollout of these shapes takes on ``dev`` with weights of
    ``elem`` bytes (2: bf16), with the card's
    cudaOccupancyMaxActiveClusters for a resident K1."""
    from vae_connexe_torch.ops import cuda_rollout as cr

    plan, launch = cr._plan(kind, p, b, d, hidden, dev, elem)
    line = (f"plan {kind}{'' if elem == 4 else ' bf16'} p={p} H={hidden} "
            f"B={b}: route={plan.route} "
            f"cluster={plan.cluster} heads_per_block={plan.heads_per_block} "
            f"bt={plan.bt} split={plan.split} threads={plan.threads} "
            f"smem={plan.smem}")
    if plan.route == "streamed":
        line += (f" M={plan.bt} blocks_a_step={plan.blocks} "
                 f"kernels_a_call={T} scratch_bytes={plan.scratch}")
    if kind == "crvae" and plan.route == "resident":
        line += (f" n_clusters={launch} cudaOccupancyMaxActiveClusters="
                 f"{cr.max_active_clusters(dev, plan, p, hidden, elem)}")
    return line


# (p, H, batches, random parents mask, route) of the rollout checks.
ROLLOUT_CASES = [
    (P, H, CHECK_BATCHES, False, "resident"),
    (4, 8, (1, 37), True, "resident"),
    (10, H, (37, SERVE_B), False, "resident"),          # lorenz96_crvae
    (SCALED_P, SCALED_H, (1, 37, SCALED_B), False, "streamed"),
    (XL_P, XL_H, (1, 37), False, "streamed"),           # lorenz96_xl
    (2, H, (1, TRAIN_B), False, "resident"),            # henon_author
]


def check_kernels(dev, errors):
    """Phase 3: each rollout kernel against its plain version on the card,
    on the route its shapes take; two calls bitwise equal."""
    import torch

    from vae_connexe_torch.models import masked_heads
    from vae_connexe_torch.ops import cuda_rollout as cr

    for p, hidden, batches, with_parents, route in ROLLOUT_CASES:
        for b in batches:
            model, err, params, eparams, g = make_models(p, hidden, b, dev)
            heads = params.heads
            if with_parents:
                heads = masked_heads(heads, (torch.rand((p, p), generator=g)
                                             > 0.3).float())
            h0 = torch.randn((b, hidden), generator=g).to(dev)
            noise = torch.randn((b, T, p), generator=g).to(dev)
            x0 = torch.zeros((b, p), device=dev)
            log(rollout_plan_line("crvae", p, b, p, hidden, dev))
            log(rollout_plan_line("errvae", 1, b, p, hidden, dev))
            cr.reset_launches()
            k1, k1b = (cr.crvae_free_run_fused(heads, params.readout, x0, h0,
                                               noise, 0.1) for _ in range(2))
            k2, k2b = (cr.errvae_sample_fused(eparams.dec, eparams.out, h0,
                                              p, T) for _ in range(2))
            taken = dict(cr.ROUTE_LAUNCHES)
            r1 = cr.crvae_free_run_plain(heads, params.readout, x0, h0, noise,
                                         0.1)
            r2 = cr.errvae_sample_plain(eparams.dec, eparams.out, h0, p, T)
            torch.cuda.synchronize()
            for name, k, again, r in (("crvae_free_run", k1, k1b, r1),
                                      ("errvae_sample", k2, k2b, r2)):
                e = (k - r).abs().max().item()
                same = torch.equal(k, again)
                on_route = taken[f"{name}_{route}"] == 2
                ok = (bool(torch.isfinite(k).all()) and e <= TOL and same
                      and on_route)
                key = name if route == "resident" else f"{name}_streamed"
                errors[key] = max(errors.get(key, 0.0), e)
                log(f"check {name} {route} p={p} H={hidden} B={b} T={T} "
                    f"parents={with_parents}: max_abs_err={e:.3e} "
                    f"tol={TOL:g}, two calls bitwise equal: {same}, route "
                    f"launches {taken} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} ({route}) disagrees with "
                                         "its plain version, is not "
                                         "deterministic or took another route")


def post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        data = r.read()
    if body.get("format") == "json":
        return json.loads(data)
    import numpy as np

    return np.load(io.BytesIO(data))


def serve_main_path(dev):
    """Phase 4: export, load and serve at the serving width; returns the
    launch counts of this phase."""
    import numpy as np

    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.server import GeneratorServer
    from vae_connexe_torch.serving import export_generator, load_generator

    cr.reset_launches()
    model, err, params, eparams, _ = make_models(P, H, 0, dev)
    blob = export_generator(model, err, params, eparams, batch=SERVE_B)
    srv = GeneratorServer(blob, device=dev)
    srv.start()
    try:
        a, b = post(srv, {"seed": 7}), post(srv, {"seed": 7})
        c = post(srv, {"seed": 8})
        j = post(srv, {"seed": 9, "format": "json", "n_samples": 4})
        art = srv._artifacts[srv._default]
        outs = [None, None]

        def client(i):
            outs[i] = post(srv, {"seed": None, "n_samples": 16})

        threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
        srv._lock.acquire()           # hold dispatch so both requests queue
        try:
            for t in threads:
                t.start()
            deadline = time.time() + 60
            while len(art.coal_queue) < 2 and time.time() < deadline:
                time.sleep(0.01)
        finally:
            srv._lock.release()
        for t in threads:
            t.join(timeout=120)
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/meta", timeout=60) as r:
            meta = json.loads(r.read())
    finally:
        srv.shutdown()
    launches = dict(cr.LAUNCHES)
    routes = dict(cr.ROUTE_LAUNCHES)

    assert a.shape == (SERVE_B, T, P) and np.isfinite(a).all(), a.shape
    assert np.array_equal(a, b), "same seed gave different samples"
    assert c.shape == a.shape and not np.allclose(a, c), "seed ignored"
    assert j["shape"] == [4, T, P] and np.isfinite(j["samples"]).all()
    assert all(o is not None and o.shape == (16, T, P) for o in outs)
    assert meta["requests"] == 6 and meta["coalesced_requests"] == 2, meta
    assert meta["device_calls"] == 5 and meta["errors"] == 0, meta
    # 1 warm-up call + 5 dispatches, one launch of each kernel apiece.
    assert launches == route_counts(cr.LAUNCHES, crvae_free_run=6,
                                    errvae_sample=6), launches
    # ... all of them on the resident route at the serving width.
    assert routes == route_counts(
        crvae_free_run_resident=6, errvae_sample_resident=6), routes

    # The served samples against the plain versions on the seed's draws.
    ref = plain_generation(model, err, params, eparams, 7, SERVE_B, dev)
    e2e = float(np.abs(a - ref).max())
    log(f"main path: {meta['requests']} requests, {meta['device_calls']} "
        f"dispatches, {meta['coalesced_requests']} coalesced, launches "
        f"{launches}, by route {routes}, served vs plain "
        f"max_abs_err={e2e:.3e} tol={TOL:g}, "
        f"generate_ms {meta['generate_ms']}")
    assert e2e <= TOL, "served samples disagree with the plain path"
    fn, _ = load_generator(blob, dev)
    return launches, fn


def plain_generation(model, err, params, eparams, seed, batch, dev,
                     dtype=None):
    """The plain versions of K2 then K1 on the draws ``fn(seed)`` of a
    loaded artifact makes (the ErrorVAE's h0 first, the rollout's second),
    with the weights in ``dtype`` (default float32; bfloat16: the plain
    bf16 versions)."""
    import torch

    from vae_connexe_torch.ops.cuda_rollout import (
        cast_weights,
        crvae_free_run_plain,
        errvae_sample_plain,
    )

    heads, readout, dec, out = (params.heads, params.readout, eparams.dec,
                                eparams.out)
    if dtype is not None:
        heads, readout, dec, out = (cast_weights(w, dtype)
                                    for w in (heads, readout, dec, out))
    gen = torch.Generator(device=dev).manual_seed(seed)
    h0_err = torch.randn((batch, err.hidden), generator=gen, device=dev)
    h0 = torch.randn((batch, model.hidden), generator=gen, device=dev)
    errs = errvae_sample_plain(dec, out, h0_err, model.p, T)
    noise = torch.cat([torch.zeros((batch, 1, model.p), device=dev), errs],
                      dim=1)[:, :T]
    return crvae_free_run_plain(heads, readout,
                                torch.zeros((batch, model.p), device=dev), h0,
                                noise, model.noise_scale).cpu().numpy()


def plain_generation_exact(model, err, params, eparams, seed, batch, dev):
    """``plain_generation`` in bf16 with exact sums: the same bf16 weights,
    draws and carries, every product summed and every gate computed in
    float64 before the bf16 rounding.  A second plain bf16 version that
    differs from the first only in how its sums round."""
    import torch

    from vae_connexe_torch.ops.cuda_rollout import cast_weights
    from vae_connexe_torch.ops.gru import gru_cell, gru_step_heads
    from vae_connexe_torch.utils.layers import dense

    f64 = torch.float64
    heads, readout, dec, out = (
        cast_weights(cast_weights(w, torch.bfloat16), f64)
        for w in (params.heads, params.readout, eparams.dec, eparams.out))

    def rnd(t):
        return t.to(torch.bfloat16).to(f64)

    gen = torch.Generator(device=dev).manual_seed(seed)
    h0_err = torch.randn((batch, err.hidden), generator=gen, device=dev)
    h0 = torch.randn((batch, model.hidden), generator=gen, device=dev)
    h, x, errs = rnd(h0_err), torch.zeros((batch, model.p), device=dev,
                                          dtype=f64), []
    for _ in range(T):
        h = rnd(gru_cell(dec, x, h))
        x = rnd(dense(out, h))
        errs.append(x)
    noise = torch.cat([torch.zeros((batch, 1, model.p), device=dev,
                                   dtype=f64), torch.stack(errs, 1)],
                      dim=1)[:, :T]
    h = rnd(h0).expand(model.p, *h0.shape)
    x, outs = torch.zeros((batch, model.p), device=dev, dtype=f64), []
    for t in range(T):
        h = rnd(gru_step_heads(heads, x, h))
        o = torch.einsum("pbh,poh->pbo", h, readout.w) + readout.b[:, None]
        x = rnd(o[..., 0].T + model.noise_scale * noise[:, t])
        outs.append(x)
    return torch.stack(outs, 1).float().cpu().numpy()


def serve_scaled_path(dev, card):
    """Phase 4a': three generations through a loaded artifact at
    lorenz96_scaled's width (p=40, H=128, batch 512), whose weights do not
    fit a block: every launch on the streamed route; then three through a
    bf16 artifact of the same weights: K1's bf16 launches streamed (its 40
    heads need more blocks than a cluster holds), K2's resident (one head
    of bf16 weights fits a block), held against the plain bf16 versions by
    ``bf16_ok``.  Returns its launches by route."""
    import numpy as np

    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.serving import export_generator, load_generator

    model, err, params, eparams, _ = make_models(SCALED_P, SCALED_H, 3, dev)
    fn, _ = load_generator(export_generator(model, err, params, eparams,
                                            batch=SCALED_B), dev)
    cr.reset_launches()
    outs = [fn(s) for s in (21, 22, 23)]
    routes = dict(cr.ROUTE_LAUNCHES)
    ref = plain_generation(model, err, params, eparams, 21, SCALED_B, dev)
    e2e = float(np.abs(outs[0] - ref).max())
    log(f"main path lorenz96_scaled serving p={SCALED_P} H={SCALED_H} "
        f"B={SCALED_B}: 3 generations, launches by route {routes}, vs plain "
        f"max_abs_err={e2e:.3e} tol={TOL:g} [{card}]")
    assert all(o.shape == (SCALED_B, T, SCALED_P) and np.isfinite(o).all()
               for o in outs)
    assert routes == route_counts(
        crvae_free_run_streamed=3, errvae_sample_streamed=3), routes
    assert e2e <= TOL, "scaled generation disagrees with the plain path"

    import torch

    fn16, _ = load_generator(export_generator(
        model, err, params, eparams, batch=SCALED_B,
        serve_dtype="bfloat16"), dev)
    cr.reset_launches()
    outs16 = [fn16(s) for s in (21, 22, 23)]
    routes16 = dict(cr.ROUTE_LAUNCHES)
    ref16 = plain_generation(model, err, params, eparams, 21, SCALED_B, dev,
                             torch.bfloat16)
    agree = bf16_agreement(outs16[0], ref16)
    log(f"main path lorenz96_scaled bf16 serving p={SCALED_P} "
        f"H={SCALED_H} B={SCALED_B}: 3 generations, launches by route "
        f"{routes16}, vs plain bf16: {agreement_text(agree)} [{card}]")
    assert all(o.shape == (SCALED_B, T, SCALED_P) and np.isfinite(o).all()
               for o in outs16)
    assert routes16 == route_counts(crvae_free_run_bf16_streamed=3,
                                    errvae_sample_bf16_resident=3), routes16
    assert bf16_ok(agree), "scaled bf16 generation disagrees"
    return {**{k: routes[k] for k in ("crvae_free_run_streamed",
                                      "errvae_sample_streamed")},
            **{k: routes16[k] for k in ("crvae_free_run_bf16_streamed",
                                        "errvae_sample_bf16_resident")}}


def time_all(dev, card, served_fn):
    """Phase 5: device times of both rollout kernels and their plain
    versions, and of the whole generation, at B=1 and B=3072 on both
    routes (the streamed one at lorenz96_scaled's and lorenz96_xl's
    widths); returns the per-kernel rows (B=3072, B=1 in ``extra``)."""
    import torch

    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.train import generate_from_draws

    res = {}
    for suffix, p, hidden in (("", P, H), ("_streamed", SCALED_P, SCALED_H),
                              ("_xl", XL_P, XL_H)):
        model, err, params, eparams, g = make_models(p, hidden, 1, dev)
        for b in (1, SERVE_B):
            iters = 200 if b == 1 else 20
            h0 = torch.randn((b, hidden), generator=g).to(dev)
            h0_err = torch.randn((b, hidden), generator=g).to(dev)
            noise = torch.randn((b, T, p), generator=g).to(dev)
            x0 = torch.zeros((b, p), device=dev)
            k1 = (params.heads, params.readout, x0, h0, noise, 0.1)
            k2 = (eparams.dec, eparams.out, h0, p, T)
            row = {
                "crvae_free_run": (
                    time_ms(lambda: cr.crvae_free_run_fused(*k1), iters),
                    time_ms(lambda: cr.crvae_free_run_plain(*k1), iters)),
                "errvae_sample": (
                    time_ms(lambda: cr.errvae_sample_fused(*k2), iters),
                    time_ms(lambda: cr.errvae_sample_plain(*k2), iters)),
            }
            gen_ms = time_ms(lambda: generate_from_draws(
                model, err, params.heads, params.readout, eparams.dec,
                eparams.out, h0_err, h0), iters)
            route = cr._plan("crvae", p, b, p, hidden, dev)[0].route
            for name, (ms, plain) in row.items():
                log(f"time {name} {route} p={p} H={hidden} B={b}: kernel "
                    f"{ms:.4f} ms, plain {plain:.4f} ms [{card}]")
            log(f"time compensated generation {route} p={p} H={hidden} "
                f"B={b}: {gen_ms:.4f} ms, {b / gen_ms * 1e3:.1f} samples/s "
                f"[{card}]")
            for name, (ms, plain) in row.items():
                key = name + suffix
                if b == SERVE_B:
                    res.setdefault(key, {"extra": {}}).update(
                        ms=ms, plain_ms=plain)
                    res[key]["extra"]["generation_ms"] = gen_ms
                else:
                    res.setdefault(key, {"extra": {}})["extra"].update(
                        b1_ms=ms, b1_plain_ms=plain, b1_generation_ms=gen_ms)
    from vae_connexe_torch.train import generate_with_compensation

    model, err, params, eparams, _ = make_models(P, H, 0, dev)
    n, host = 5, {}
    for what, fn in (
            ("artifact", served_fn),
            ("in_process", lambda s: generate_with_compensation(
                model, err, params, eparams,
                torch.Generator(device=dev).manual_seed(s),
                SERVE_B).cpu().numpy())):
        fn(0)
        t0 = time.perf_counter()
        for s in range(n):
            fn(s)
        host[what] = (time.perf_counter() - t0) / n * 1e3
    log(f"time served fn(seed) B={SERVE_B} incl. copy to host: "
        f"{host['artifact']:.3f} ms, {SERVE_B / host['artifact'] * 1e3:.1f} "
        f"samples/s (the exported program through the ops); in-process "
        f"generate_with_compensation incl. copy to host "
        f"{host['in_process']:.3f} ms [{card}]")
    res["crvae_free_run"]["extra"]["host_ms"] = host
    return res


def _assert_close(name, got, ref, errors, rtol, atol, what):
    """Hold ``got`` to ``ref`` with the stated tolerance; record the
    largest absolute error of kernel ``name``."""
    import torch

    e = (got - ref).abs().max().item()
    errors[name] = max(errors.get(name, 0.0), e)
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - ref).abs() <= atol + rtol * ref.abs()).all())
    log(f"check {name} {what}: max_abs_err={e:.3e} rtol={rtol:g} "
        f"atol={atol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({what})")


def _assert_grads(name, got, ref, errors, long_sums, what):
    """Hold gradients to GRAD_TOL, or each to LONG_SUM_TOL of its largest
    magnitude (``long_sums``: lorenz96_scaled's shapes)."""
    if not long_sums:
        _assert_close(name, _flat(got), _flat(ref), errors, **GRAD_TOL,
                      what=what)
        return
    for i, (g, r) in enumerate(zip(got, ref)):
        top = r.abs().max().item()
        _assert_close(name, g, r, errors, 0.0, LONG_SUM_TOL * top,
                      f"{what} [{i}] (|ref| <= {top:.3e})")


def _flat(tensors):
    import torch

    return torch.cat([t.reshape(-1) for t in tensors])


def wide_training_cases():
    """The wide route's cases of ``check_training_kernels`` (name, heads,
    batch, steps, D, H, per-head input, h0 shape, mask)."""
    sd, sh, sb = SCALED_P, SCALED_H, SCALED_B
    return [
        # lorenz96_scaled's decoder heads and encoder.
        ("scaled decoder", sd, sb, SCALED_CTX - ENC, sd, sh, False,
         (1, sb, sh), True),
        ("scaled encoder", 1, sb, ENC, sd, sh, False, (1, sb, sh), False),
        # lorenz96_xl's decoder heads (p=128, batch 64, context 40).
        ("xl decoder", XL_P, XL_B, XL_CTX - ENC, XL_P, XL_H, False,
         (1, XL_B, XL_H), True),
        # Hidden 130: 160 units on the wide route, a ragged batch, a
        # per-head input and h0.
        ("wide h130", 6, 100, 12, SCALED_P, 130, True, (6, 100, 130), True),
    ]


def training_inputs(dev, heads, b, td, d, hid, per_head, h0_shape, masked):
    """(params, x, h0, douts) of a ``check_training_kernels`` case, drawn
    from a generator seeded by batch + heads; a random parents mask on
    W_ih when ``masked``."""
    import torch

    from vae_connexe_torch.ops.gru import GRUParams, init_stacked_gru

    g = torch.Generator().manual_seed(b + heads)
    params = init_stacked_gru(g, heads, d, hid, device=dev)
    if masked:
        mask = (torch.rand((heads, d), generator=g) > 0.3).float().to(dev)
        params = GRUParams(params.w_ih * mask[:, None, :], params.w_hh,
                           params.b_ih, params.b_hh)
    x = torch.randn((heads, b, td, d) if per_head else (b, td, d),
                    generator=g).to(dev)
    h0 = torch.randn(h0_shape, generator=g).to(dev)
    douts = torch.randn((heads, b, td, hid), generator=g).to(dev)
    return params, x, h0, douts


def check_training_kernels(dev, errors):
    """Phase 3b: B1/B2 and B3 against their plain versions, on the card."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_gru, cuda_step
    from vae_connexe_torch.ops.gru import GRUParams
    from vae_connexe_torch.train import Phase1Config
    from vae_connexe_torch.utils.tree import tree_leaves

    td = CTX - ENC
    cases = [  # (name, heads, batch, steps, D, H, per-head input, h0, mask)
        ("decoder", P, TRAIN_B, td, P, H, False, (1, TRAIN_B, H), False),
        ("encoder", 1, TRAIN_B, td, P, H, False, (1, TRAIN_B, H), False),
        ("ragged per-head", P, 37, td, P, H, True, (P, 37, H), True),
        *wide_training_cases(),
        # The W_in family: henon6d_win's decoder (its per-head x_sel of
        # width H, dx on), the 8-seed fold of it, its ErrorVAE (H // 2),
        # and var_crvae's decoder (d=5, batch 16).
        ("win decoder", WIN_D, WIN_B, WIN_TAU, H, H, True, (WIN_D, WIN_B, H),
         False),
        ("win 8-seed decoder", 8 * WIN_D, WIN_B, WIN_TAU, H, H, True,
         (8 * WIN_D, WIN_B, H), False),
        ("win error vae", 1, WIN_B, WIN_TAU, WIN_D, H // 2, True,
         (1, WIN_B, H // 2), False),
        ("var decoder", 5, 16, WIN_TAU, H, H, True, (5, 16, H), False),
        # lorenz96_crcsrae's phase 1 at batch 2048 (decoder under a mask,
        # as phase 2 runs it) and the VRAE's one-head encoder (vrae_demo:
        # B=32, T=20, D=10).
        ("crcsrae decoder", CRVAE_P, CS_B1, CTX - ENC, CRVAE_P, H, False,
         (1, CS_B1, H), True),
        ("crcsrae encoder", 1, CS_B1, ENC, CRVAE_P, H, False, (1, CS_B1, H),
         False),
        ("vrae encoder", 1, 32, 20, CRVAE_P, H, False, (1, 32, H), False),
    ]
    limits = cuda_gru.device_limits(dev)
    for case in cases:
        what, heads, b, td, d, hid = case[:6]
        wide = cuda_gru.recurrence_route(heads, b, d, hid, limits) == "wide"
        if wide != what.startswith(("scaled", "xl", "wide")):
            raise AssertionError(f"{what}: route {'wide' if wide else 'kernel'}")
        fwd, bwd = (("gru_forward_wide", "gru_backward_wide") if wide else
                    ("gru_forward", "gru_backward"))
        params, x, h0, douts = training_inputs(dev, *case[1:])
        res = []
        for fn in (cuda_gru.gru_scan_heads_fused,
                   cuda_gru.gru_scan_heads_fused_plain):
            ins = [v.clone().requires_grad_(True) for v in
                   (params.w_ih, params.w_hh, params.b_ih, params.b_hh, x, h0)]
            outs, _ = fn(GRUParams(*ins[:4]), ins[4], ins[5])
            res.append([outs.detach(), *torch.autograd.grad(
                (outs * douts).sum(), ins)])
        again, _ = cuda_gru.fused_gru_scan_heads(params, x, h0)
        torch.cuda.synchronize()
        (k_outs, *k_grads), (r_outs, *r_grads) = res
        shape = f"P={heads} B={b} T={td} D={d} H={hid}"
        _assert_close(fwd, k_outs, r_outs, errors, 0.0, OUT_TOL,
                      f"{what} {shape} outs")
        if wide:
            log(f"plan {fwd} {what} {shape}: "
                f"{wide_fwd_line(k_outs.shape, d, dev)}")
        same = torch.equal(k_outs, again)
        log(f"check {fwd} {what} {shape}: two calls bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{fwd} is not deterministic")
        _assert_grads(bwd, k_grads, r_grads, errors, wide,
                      f"{what} {shape} dW_ih dW_hh db_ih db_hh dx dh0")
        # At lorenz96_crcsrae's B*T = 20,480 the float32 plain phase
        # itself falls outside GRAD_TOL of the exact sums, where the
        # kernel does not (tools/torch_gru_long_sums.py): there the
        # weight-gradient kernel is held to GRAD_TOL against the plain
        # phase in float64.
        check_backward_phases(params, x, h0.expand(heads, b, hid), k_outs,
                              douts, errors, f"{what} {shape}", bwd, wide,
                              f64_ref=what.startswith("crcsrae"))

    g = torch.Generator().manual_seed(5)
    model = CRVAE(P, H, ENC)
    params = model.init(g, dev)
    cfg = Phase1Config(lam=0.1, lr=5e-2, beta=0.1)
    parents = (torch.rand((P, P), generator=g) > 0.3).float().to(dev)
    k_params = r_params = params
    for step in range(5):
        batch = torch.randn((TRAIN_B, CTX, P), generator=g).to(dev)
        eps = torch.randn((TRAIN_B, H), generator=g).to(dev)
        k_params, k_met = cuda_step.fused_phase1_step(
            model, cfg, k_params, parents, batch, eps)
        r_params, r_met = cuda_step.fused_phase1_step_plain(
            model, cfg, r_params, parents, batch, eps)
        torch.cuda.synchronize()
        if step in (0, 4):
            what = f"p={P} H={H} ctx={CTX} B={TRAIN_B} step {step + 1}"
            _assert_close("phase1_step", _flat(tree_leaves(k_params)),
                          _flat(tree_leaves(r_params)), errors, **STEP_TOL,
                          what=what + " params")
            _assert_close("phase1_step", torch.stack(list(k_met.values())),
                          torch.stack(list(r_met.values())), errors,
                          **STEP_TOL, what=what + " metrics")


def check_step_phases(dev, errors):
    """Phase 3c: each of B3's launches against its plain phase on the
    same inputs, the kernel's own buffers from the launches before it, at
    p=20, H=64, ctx=20, B=256 with a random parents mask; and two B3 calls
    on the same inputs give bitwise-equal params and metrics.  The update,
    prox and metrics launches are held by the whole-step check."""
    import torch

    from vae_connexe_torch.models import CRVAE, masked_heads
    from vae_connexe_torch.models.crvae import decoder_input
    from vae_connexe_torch.ops import cuda_gru, cuda_step
    from vae_connexe_torch.ops.gru import gru_scan, gru_scan_heads
    from vae_connexe_torch.train import Phase1Config
    from vae_connexe_torch.utils.layers import dense

    g = torch.Generator().manual_seed(11)
    model = CRVAE(P, H, ENC)
    params = model.init(g, dev)
    cfg = Phase1Config(lam=0.1, lr=5e-2, beta=0.1)
    parents = (torch.rand((P, P), generator=g) > 0.3).float().to(dev)
    batch = torch.randn((TRAIN_B, CTX, P), generator=g).to(dev)
    eps = torch.randn((TRAIN_B, H), generator=g).to(dev)
    args = (model, cfg, params, parents, batch, eps)
    outs, flat, shapes = cuda_step._step_launch(*args)
    s = cuda_step._flat_views(flat, shapes)
    again, _, _ = cuda_step._step_launch(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(outs[k], again[k]) for k in outs)
    log(f"check phase1_step p={P} H={H} ctx={CTX} B={TRAIN_B}: two calls "
        f"bitwise equal (params and metrics): {same}")
    if not same:
        raise AssertionError("B3 is not deterministic")

    e, b = ENC, TRAIN_B
    heads = masked_heads(params.heads, parents)
    w = (heads.w_ih, heads.b_ih, heads.w_hh, heads.b_hh)
    x_dec = decoder_input(batch, e)
    z_p = s["z"].expand(P, b, H)
    enc = params.enc
    ew = (enc.w_ih[None], enc.b_ih[None], enc.w_hh[None], enc.b_hh[None])
    h0 = torch.zeros((1, b, H), device=dev)
    h_e = s["henc"][:, -1]
    henc, _ = gru_scan(enc, batch[:, :e], h0[0])
    mu, lv = dense(params.fc_mu, h_e), dense(params.fc_std, h_e)
    kl = (-0.5 * (1 + lv - mu * mu - lv.exp())).sum()
    hdec, _ = gru_scan_heads(heads, x_dec, s["z"][None])
    ro = cuda_step.readout_plain(params.readout, batch, s["hdec"], e)
    gh, dz = cuda_gru.bwd_chain_plain(*w, x_dec, z_p, s["hdec"], s["douts"])
    dwgt = cuda_gru.bwd_wgrad_plain(*w, x_dec, z_p, s["hdec"], s["gh"],
                                    False)[1:]
    *fc, dhe = cuda_step.latent_plain(params, s["mu"], s["lv"], s["z"], h_e,
                                      s["dz_part"].sum(0), cfg.beta)
    egh, _ = cuda_gru.bwd_chain_plain(*ew, batch[:, :e], h0, s["henc"][None],
                                      s["douts_enc"][None])
    ewgt = cuda_gru.bwd_wgrad_plain(*ew, batch[:, :e], h0, s["henc"][None],
                                    s["gh_enc"][None], False)[1:]
    torch.cuda.synchronize()
    sums = lambda *names: [s[n].sum(0) for n in names]   # noqa: E731
    checks = [  # (launch, what, kernel, plain, (rtol, atol))
        ("step_encoder_fwd", "henc", [s["henc"]], [henc], (0.0, OUT_TOL)),
        ("step_encoder_fwd", "mu lv KL sum",
         [s["mu"], s["lv"], s["kl_part"].sum()], [mu, lv, kl],
         tuple(GRAD_TOL.values())),
        ("step_decoder_fwd", "hdec", [s["hdec"]], [hdec], (0.0, OUT_TOL)),
        ("step_readout", "douts, squared error, g_ro_w, g_ro_b",
         [s["douts"], s["sq_part"].sum(), s["g_ro_w"].sum(1),
          s["g_ro_b"].sum(1)], [ro[0], ro[1], ro[2][:, 0], ro[3][:, 0]],
         tuple(GRAD_TOL.values())),
        ("step_decoder_chain", "gh dz", [s["gh"], s["dz_part"]], [gh, dz],
         tuple(GRAD_TOL.values())),
        ("step_decoder_wgrad", "dW_ih db_ih dW_hh db_hh",
         list(cuda_gru.wgrad_totals(s["g_hd"], P, H)), list(dwgt),
         tuple(GRAD_TOL.values())),
        ("step_latent", "g_mu g_lv douts_enc",
         [*sums("g_mu_w", "g_mu_b", "g_lv_w", "g_lv_b"), s["douts_enc"]],
         [*fc, cuda_step.encoder_douts(dhe, e)], tuple(GRAD_TOL.values())),
        ("step_encoder_chain", "gh", [s["gh_enc"]], [egh[0]],
         tuple(GRAD_TOL.values())),
        ("step_encoder_wgrad", "dW_ih db_ih dW_hh db_hh",
         list(cuda_gru.wgrad_totals(s["g_enc"][None], P, H)), list(ewgt),
         tuple(GRAD_TOL.values())),
    ]
    shape = f"p={P} H={H} ctx={CTX} B={TRAIN_B} parents masked"
    for launch, what, got, ref, (rtol, atol) in checks:
        _assert_close(f"phase1_step:{launch}", _flat(got), _flat(ref), errors,
                      rtol, atol, f"{shape}: {what}")


def check_backward_phases(params, x, h0, outs, douts, errors, what, name,
                          long_sums=False, f64_ref=False):
    """B2's two kernels, each against its plain phase on the same inputs:
    the chain's gate gradients gh and dh0, then the weight-gradient
    kernel's dx, dW and db from the plain gh (with ``f64_ref``, against
    the plain phase in float64 on the same float32 inputs); and two whole
    B2 calls on the same inputs give bitwise-equal gradients."""
    import torch

    from vae_connexe_torch.ops import cuda_gru

    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    k_gh, k_dh0 = cuda_gru.bwd_chain(*w, x, h0, outs, douts)
    r_gh, r_dh0 = cuda_gru.bwd_chain_plain(*w, x, h0, outs, douts)
    k_w = cuda_gru.bwd_wgrad(*w, x, h0, outs, r_gh, True)
    r_w = cuda_gru.bwd_wgrad_plain(
        *((t.double() for t in (*w, x, h0, outs, r_gh)) if f64_ref
          else (*w, x, h0, outs, r_gh)), True)
    first = cuda_gru._backward_launch(*w, x, h0, outs, douts, need_dx=True)
    second = cuda_gru._backward_launch(*w, x, h0, outs, douts, need_dx=True)
    torch.cuda.synchronize()
    _assert_close(name, _flat([k_gh, k_dh0]), _flat([r_gh, r_dh0]),
                  errors, **GRAD_TOL, what=f"{what} chain kernel: gh dh0")
    if long_sums:
        _assert_close(name, _flat([k_gh, k_dh0]), _flat([r_gh, r_dh0]),
                      errors, **WIDE_CHAIN_TOL,
                      what=f"{what} wide chain, float32 accuracy: gh dh0")
    _assert_grads(name, k_w, r_w, errors, long_sums,
                  f"{what} weight-gradient kernel: dx dW_ih db_ih dW_hh "
                  f"db_hh{' (float64 plain)' if f64_ref else ''}")
    same = all(torch.equal(u, v) for u, v in zip(first, second))
    log(f"check {name} {what}: two calls bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{name} is not deterministic")
    if long_sums:
        # The wide chain: its plan, and its input projection (the first
        # kernel of the chain's call) against x W_ih^T + b_ih.
        plan = wide_chain_line(outs.shape, x.shape[-1], outs.device)
        log(f"plan {name} {what}: {plan}")
        _assert_close(name, cuda_gru.bwd_xproj(params.w_ih, params.b_ih, x),
                      cuda_gru.xproj_plain(params.w_ih, params.b_ih, x),
                      errors, **XPROJ_TOL,
                      what=f"{what} input projection (gru_xproj_kernel)")


def wide_fwd_line(outs_shape, d, dev) -> str:
    """The wide forward's plan at outs (P, B, T, H) and input width d:
    cluster, tile, threads, shared memory and grid, the block's shared
    memory, threads and cluster also read from the library (they must
    agree with ``cuda_gru``'s)."""
    import ctypes

    from vae_connexe_torch.ops import _build, cuda_gru

    p, b, _, hidden = outs_shape
    bt = cuda_gru.wide_fwd_plan(b, p, hidden, cuda_gru.device_limits(dev))
    cluster = cuda_gru.WIDE_CLUSTER
    smem = cuda_gru.wide_fwd_smem_bytes(bt, hidden)
    threads = cuda_gru.wide_chain_threads(bt, hidden)
    got = (ctypes.c_longlong * 3)()
    _build.gru_library().vcx_wide_fwd_block(bt, hidden, got)
    if tuple(got) != (smem, threads, cluster):
        raise AssertionError(f"wide forward block: library {tuple(got)}, "
                             f"cuda_gru {(smem, threads, cluster)}")
    return (f"cluster {cluster}, tile {bt} rows, {threads} threads, "
            f"{smem} B shared, grid "
            f"({-(-b // bt) * cluster}, {p}), d={d}")


def wide_chain_line(outs_shape, d, dev) -> str:
    """The wide chain's plan at outs (P, B, T, H) and input width d:
    cluster, tile, threads, shared memory and grid, the block's shared
    memory, threads and cluster also read from the library (they must
    agree with ``cuda_gru``'s)."""
    import ctypes

    from vae_connexe_torch.ops import _build, cuda_gru

    p, b, _, hidden = outs_shape
    bt = cuda_gru.wide_chain_plan(b, p, hidden, cuda_gru.device_limits(dev))
    cluster = cuda_gru.WIDE_CLUSTER
    smem = cuda_gru.wide_chain_smem_bytes(bt, hidden)
    threads = cuda_gru.wide_chain_threads(bt, hidden)
    got = (ctypes.c_longlong * 3)()
    _build.gru_library().vcx_wide_chain_block(bt, hidden, got)
    if tuple(got) != (smem, threads, cluster):
        raise AssertionError(f"wide chain block: library {tuple(got)}, "
                             f"cuda_gru {(smem, threads, cluster)}")
    return (f"cluster {cluster}, tile {bt} rows, {threads} threads, "
            f"{smem} B shared, grid "
            f"({-(-b // bt) * cluster}, {p}), d={d}")


def lorenz_windows(dev, p, seed, ctx=CTX, t=SERIES_T):
    """A Lorenz-96 series of ``t`` steps made on the card, windowed by
    ``arrange_input`` into (t - ctx, ctx, p)."""
    import torch

    from vae_connexe_torch.data import arrange_input, lorenz96

    gen = torch.Generator(device=dev).manual_seed(seed)
    windows, _ = arrange_input(lorenz96(gen, p=p, t=t, device=dev), ctx)
    return windows


def train_main_path(dev, card, windows):
    """Phase 4b: fit_phase1 at p=20, H=64, B=256; returns its launches."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.train import Phase1Config, fit_phase1

    model = CRVAE(P, H, ENC)
    params = model.init(torch.Generator().manual_seed(1), dev)
    cfg = Phase1Config(max_iter=FIT_STEPS, check_every=25,
                       batch_size=TRAIN_B)
    losses = []
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    t0 = time.perf_counter()
    fit_phase1(model, params, windows, torch.ones((P, P), device=dev), cfg,
               gen, callback=lambda step, st, met: losses.append(met["loss"]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_gru.LAUNCHES)
    log(f"main path fit_phase1 p={P} H={H} B={TRAIN_B} ctx={CTX}: "
        f"{FIT_STEPS} steps in {secs:.3f} s ({FIT_STEPS / secs:.1f} steps/s "
        f"incl. host), loss {losses[0]:.5f} at step 25 -> {losses[-1]:.5f}, "
        f"launches {launches} [{card}]")
    want = {"gru_forward": 2 * FIT_STEPS, "gru_backward": 2 * FIT_STEPS,
            "gru_forward_wide": 0, "gru_backward_wide": 0}
    assert launches == want, (launches, want)
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    return launches


def scaled_main_path(dev, card):
    """Phase 4b': fit_phase1 at lorenz96_scaled's shape (p=40, H=128,
    B=512, context 40): every recurrence runs B1's and B2's wide variants,
    and the loss is finite and falls; returns the wide launches."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.train import Phase1Config, fit_phase1

    p, hidden = SCALED_P, SCALED_H
    windows = lorenz_windows(dev, p, seed=12, ctx=SCALED_CTX, t=SCALED_T)
    model = CRVAE(p, hidden)
    params = model.init(torch.Generator().manual_seed(13), dev)
    cfg = Phase1Config(lam=0.1, lr=5e-2, max_iter=SCALED_STEPS,
                       check_every=5, batch_size=SCALED_B)
    losses = []
    gen = torch.Generator(device=dev).manual_seed(14)
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    t0 = time.perf_counter()
    fit_phase1(model, params, windows, torch.ones((p, p), device=dev), cfg,
               gen, callback=lambda step, st, met: losses.append(met["loss"]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_gru.LAUNCHES)
    log(f"main path fit_phase1 lorenz96_scaled p={p} H={hidden} "
        f"B={SCALED_B} ctx={SCALED_CTX}: {SCALED_STEPS} steps in {secs:.3f} s "
        f"({SCALED_STEPS / secs:.1f} steps/s incl. host), loss "
        f"{losses[0]:.5f} at step 5 -> {losses[-1]:.5f}, launches {launches} "
        f"[{card}]")
    want = {"gru_forward": 0, "gru_backward": 0,
            "gru_forward_wide": 2 * SCALED_STEPS,
            "gru_backward_wide": 2 * SCALED_STEPS}
    assert launches == want, (launches, want)
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    return {k: launches[k] for k in ("gru_forward_wide", "gru_backward_wide")}


def _b3_step(model, cfg, params, windows, parents, gen):
    """One fused_phase1_step on a batch and eps drawn as a fit draws them
    (indices first, eps second)."""
    import torch

    from vae_connexe_torch.ops.cuda_step import fused_phase1_step

    idx = torch.randint(0, windows.shape[0], (TRAIN_B,), generator=gen,
                        device=gen.device)
    eps = torch.randn((TRAIN_B, H), generator=gen, device=gen.device)
    return fused_phase1_step(model, cfg, params, parents, windows[idx], eps)


def step_main_path(dev, card, windows):
    """Phase 4c: STEP_STEPS whole-step launches at p=20, H=64, B=256 on the
    Lorenz windows; returns its launches."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_step
    from vae_connexe_torch.train import Phase1Config

    model = CRVAE(P, H, ENC)
    params = model.init(torch.Generator().manual_seed(1), dev)
    cfg = Phase1Config(batch_size=TRAIN_B)
    parents = torch.ones((P, P), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    losses = []
    torch.cuda.synchronize()
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    for _ in range(STEP_STEPS):
        params, met = _b3_step(model, cfg, params, windows, parents, gen)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    first, last = float(losses[0]), float(torch.stack(losses[-25:]).mean())
    log(f"main path fused_phase1_step p={P} H={H} B={TRAIN_B}: {STEP_STEPS} "
        f"steps in {secs:.3f} s, loss {first:.5f} -> {last:.5f} (mean of "
        f"the last 25), launches {launches} [{card}]")
    assert launches == {"phase1_step": STEP_STEPS}, launches
    assert math.isfinite(last) and last < first, (first, last)
    return launches


def phase2_state(model, err, params, eparams, gen, dev):
    import torch

    from vae_connexe_torch.optim import adam_init
    from vae_connexe_torch.train import Phase2State

    return Phase2State(params=params, err_params=eparams,
                       err_opt=adam_init(eparams), prior=None,
                       best_params=params,
                       best_loss=torch.tensor(float("inf"), device=dev),
                       generator=gen, step=0)


def check_phase2_step(dev, errors):
    """Phase 3d: five phase-2 steps on the card (B1/B2 at the CRVAE's and
    the ErrorVAE's call sites) against the same steps on the CPU's plain
    recurrences, on the same draws, with a random binary mask; two card
    runs bitwise equal."""
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.train import Phase2Config, make_phase2_step
    from vae_connexe_torch.utils.tree import tree_leaves, tree_map

    g = torch.Generator().manual_seed(21)
    model, err = CRVAE(P, H, ENC), ErrorVAE(P, H)
    params, eparams = model.init(g, "cpu"), err.init(g, "cpu")
    parents = (torch.rand((P, P), generator=g) > 0.3).float()
    windows = torch.randn((1024, CTX, P), generator=g)
    draws = [(torch.randint(0, 1024, (TRAIN_B,), generator=g),
              torch.randn((TRAIN_B, H), generator=g),
              torch.randn((TRAIN_B, H), generator=g)) for _ in range(5)]
    cfg = Phase2Config(batch_size=TRAIN_B)

    def run(on):
        to = lambda t: t.to(on)    # noqa: E731
        ps, es = tree_map(to, params), tree_map(to, eparams)
        step = make_phase2_step(model, err, cfg, to(windows), to(parents))
        state = phase2_state(model, err, ps, es, torch.Generator(), on)
        for idx, eps, eps_err in draws:
            state, met = step(state, batch=to(windows[idx]), eps=to(eps),
                              eps_err=to(eps_err))
        return (tree_leaves(state.params) + tree_leaves(state.err_params)
                + tree_leaves(state.err_opt.mu)
                + tree_leaves(state.err_opt.nu) + tree_leaves(state.best_params),
                torch.stack(list(met.values())))

    cuda_gru.reset_launches()
    k_leaves, k_met = run(dev)
    launches = dict(cuda_gru.LAUNCHES)
    a_leaves, a_met = run(dev)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in
               zip(k_leaves + [k_met], a_leaves + [a_met]))
    r_leaves, r_met = run(torch.device("cpu"))
    what = f"p={P} H={H} ctx={CTX} B={TRAIN_B} parents masked, 5 steps"
    log(f"check phase2_step {what}: launches {launches} (4 + 4 a step), two "
        f"card runs bitwise equal: {same}")
    if launches != {"gru_forward": 20, "gru_backward": 20,
                    "gru_forward_wide": 0, "gru_backward_wide": 0} or not same:
        raise AssertionError("the phase-2 step took other launches or is not "
                             "deterministic")
    _assert_close("phase2_step", _flat(k_leaves).cpu(), _flat(r_leaves),
                  errors, **STEP_TOL, what=what + ": params, ErrorVAE params, "
                  "Adam's moments, best params")
    _assert_close("phase2_step", k_met.cpu(), r_met, errors, **STEP_TOL,
                  what=what + ": metrics")


# The per-chunk log lines of the crvae trainer ("[phase1 it=50] ...") and
# the per-block ones of the W_in trainer ("[stage1 epoch=25] ...").
PHASE_LINE = r"^\[(phase[12]) it=(\d+)\]"
STAGE_LINE = r"^\[(stage[12]) epoch=(\d+)\]"


class _ChunkTap(io.TextIOBase):
    """Captures what a command prints and snapshots the recurrence launch
    counts at every log line that ``pattern`` matches (its groups: the
    phase and the step)."""

    def __init__(self, pattern=PHASE_LINE):
        self.text = io.StringIO()
        self.snaps = []
        self.pattern = pattern

    def write(self, s):
        from vae_connexe_torch.ops import cuda_gru

        self.text.write(s)
        for m in re.finditer(self.pattern, s, re.M):
            self.snaps.append((m.group(1), int(m.group(2)),
                               dict(cuda_gru.LAUNCHES)))
        return len(s)


def run_main_path(dev, card, out_dir):
    """Phase 4d: ``cli run lorenz96_crvae`` at the full width, phases cut
    to RUN_STEPS steps each, with checkpoints; returns its launches."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.utils import restore_checkpoint

    name, n = "lorenz96_crvae", RUN_STEPS
    tap = _ChunkTap()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tap):
        cli.main(["run", name, "--iters", str(n), "--out-dir", out_dir,
                  "--save-checkpoints", "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total, rollouts = dict(cuda_gru.LAUNCHES), dict(cr.ROUTE_LAUNCHES)
    res = json.load(open(os.path.join(out_dir, f"metrics_{name}.json")))
    per1 = [c for ph, _, c in tap.snaps if ph == "phase1"][-1]
    end2 = [c for ph, _, c in tap.snaps if ph == "phase2"][-1]
    per2 = {k: end2[k] - per1[k] for k in total}
    log(f"main path cli run {name} p={CRVAE_P} H={H} B={TRAIN_B} "
        f"{n} + {n} steps in {secs:.3f} s: launches phase 1 {per1}, phase 2 "
        f"{per2}, whole run {total}, rollouts by route {rollouts} [{card}]")
    want1 = {"gru_forward": 2 * n, "gru_backward": 2 * n,
             "gru_forward_wide": 0, "gru_backward_wide": 0}
    want2 = {"gru_forward": 4 * n, "gru_backward": 4 * n,
             "gru_forward_wide": 0, "gru_backward_wide": 0}
    assert per1 == want1, (per1, want1)
    assert per2 == want2, (per2, want2)
    # After phase 2: one encoder forward of the conditioned rollout, and
    # two generations (compensated, conditioned) of one K2 and one K1.
    assert total == {**want1, "gru_forward": 6 * n + 1,
                     "gru_backward": 6 * n}, total
    assert rollouts == route_counts(
        crvae_free_run_resident=2, errvae_sample_resident=2), rollouts

    gc = res["gc"]
    log(f"graph recovery {name} p={CRVAE_P} H={H} B={TRAIN_B} {n} steps: "
        f"auroc={gc['auroc']:.4f} auroc_offdiag={gc['auroc_offdiag']:.4f} "
        f"recall={gc['recall']:.4f} mean_loss={res['phase1']['mean_loss']:.5f}"
        f"; threshold {JAX_AUROC - AUROC_MARGIN:.4f} (JAX {JAX_AUROC} - "
        f"{AUROC_MARGIN}) [{card}]")
    assert gc["auroc"] >= JAX_AUROC - AUROC_MARGIN, gc

    mask = np.load(os.path.join(out_dir, f"GC_{name}.npy"))
    g = torch.Generator().manual_seed(0)
    model, err = CRVAE(CRVAE_P, H), ErrorVAE(CRVAE_P, H)
    ck = restore_checkpoint(os.path.join(out_dir, "ckpt_phase2"),
                            {"crvae": model.init(g, dev),
                             "error_vae": err.init(g, dev)})
    w_ih = ck["crvae"].heads.w_ih.permute(0, 2, 1)
    off = torch.tensor(mask == 0, device=dev)
    frozen = bool((w_ih[off] == 0).all())
    log(f"phase 2 under the phase-1 mask ({int(mask.sum())} of "
        f"{mask.size} edges): head input columns off the mask all zero: "
        f"{frozen}")
    assert frozen

    log_path = os.path.join(out_dir, f"train_log_{name}.jsonl")
    rows = [json.loads(line) for line in open(log_path)]
    p2 = [r for r in rows if r["phase"] == "phase2"]
    first, last = p2[0], p2[-1]
    log(f"phase 2 losses, chunk at step {first['step']} -> {last['step']}: "
        f"recon {first['recon']:.5f} -> {last['recon']:.5f}, loss_e "
        f"{first['loss_e']:.5f} -> {last['loss_e']:.5f}, kl_e "
        f"{first['kl_e']:.5f} -> {last['kl_e']:.5f}")
    for k in ("recon", "loss_e"):
        assert all(math.isfinite(r[k]) for r in p2), k
        assert last[k] < first[k], (k, first[k], last[k])
    log("generation " + json.dumps({
        k: res[k] for k in ("generated_shape", "generation_moment_gap",
                            "generation_moment_gap_conditioned")}))
    return {"run_phase1": per1, "run_phase2": per2,
            "run_rollouts": rollouts}, (model, err, ck)


def kill_resume_main_path(dev, card, windows, out_dir):
    """Phase 4e: a RESUME_STEPS-step phase 2 at p=20 with snapshots every
    half, killed after the first chunk and resumed: bitwise equal to the
    uninterrupted fit."""
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.train import Phase2Config, fit_phase2
    from vae_connexe_torch.utils.tree import tree_leaves

    class Kill(Exception):
        pass

    def kill(step, state, metrics):
        raise Kill

    g = torch.Generator().manual_seed(31)
    model, err = CRVAE(P, H, ENC), ErrorVAE(P, H)
    params, eparams = model.init(g, dev), err.init(g, dev)
    mask = (torch.rand((P, P), generator=g) > 0.3).float().to(dev)
    half = RESUME_STEPS // 2
    cfg = Phase2Config(max_iter=RESUME_STEPS, check_every=half,
                       batch_size=TRAIN_B)
    args = (model, err, params, eparams, windows, mask, cfg)

    def gen():
        return torch.Generator(device=dev).manual_seed(32)

    ck = os.path.join(out_dir, "resume")
    whole = fit_phase2(*args, gen())
    try:
        fit_phase2(*args, gen(), checkpoint_dir=ck, checkpoint_every=half,
                   callback=kill)
        raise AssertionError("the kill did not fire")
    except Kill:
        pass
    resumed = fit_phase2(*args, gen(), checkpoint_dir=ck,
                         checkpoint_every=half, resume=True)
    torch.cuda.synchronize()

    def leaves(r):
        best, errp, state, _ = r
        return (tree_leaves(best) + tree_leaves(errp)
                + tree_leaves(state.err_opt) + [state.best_loss])

    same = (all(torch.equal(u, v) for u, v in zip(leaves(whole),
                                                  leaves(resumed)))
            and whole[3] == resumed[3] and resumed[2].step == RESUME_STEPS)
    log(f"kill and resume fit_phase2 p={P} H={H} B={TRAIN_B}: "
        f"{RESUME_STEPS} steps, killed at {half}, resumed: bitwise equal to "
        f"the uninterrupted fit (params, ErrorVAE, Adam, best, metrics): "
        f"{same} [{card}]")
    assert same, "resumed phase 2 differs from the uninterrupted fit"


def serve_own_weights(dev, card, out_dir, trained):
    """Phase 4f: ``cli export`` of the run's ``ckpt_phase2``, served by
    ``GeneratorServer`` for three requests; the samples held against the
    plain versions on the same draws; the same with ``--serve-dtype
    bfloat16`` (every launch a bf16 one on the resident route, held
    against the plain bf16 version by ``trained_ok``, the float32 kernel
    as the control; the JAX package's bf16 bounds; bit for bit to
    in-process bf16 generation); both artifacts loaded
    and sampled in a fresh process
    that imports no model or trainer code, the float32 samples within TOL
    of in-process generation.  Returns the launches."""
    import contextlib

    import numpy as np

    from vae_connexe_torch import cli
    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.server import GeneratorServer
    from vae_connexe_torch.serving import load_generator

    import torch

    from vae_connexe_torch.train import generate_with_compensation

    model, err, ck = trained
    art, batch = os.path.join(out_dir, "g.vcxt"), TRAIN_B
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export", "lorenz96_crvae",
                  os.path.join(out_dir, "ckpt_phase2"), "--out", art,
                  "--batch", str(batch), "--device", str(dev)])
    cr.reset_launches()
    srv = GeneratorServer(art, device=dev)
    srv.start()
    try:
        outs = [post(srv, {"seed": s}) for s in (1, 2, 3)]
    finally:
        srv.shutdown()
    launches, routes = dict(cr.LAUNCHES), dict(cr.ROUTE_LAUNCHES)
    fn, _ = load_generator(art, dev)
    ref = plain_generation(model, err, ck["crvae"], ck["error_vae"], 1, batch,
                           dev)
    e2e = float(np.abs(outs[0] - ref).max())
    same = np.array_equal(outs[0], fn(1))
    log(f"main path serving the port's own lorenz96_crvae weights "
        f"(p={CRVAE_P}, H={H}, batch {batch}): 3 requests, launches "
        f"{launches}, by route {routes}, served vs plain max_abs_err="
        f"{e2e:.3e} tol={TOL:g}, equal to load_generator's fn(1): {same} "
        f"[{card}]")
    assert all(o.shape == (batch, T, CRVAE_P) and np.isfinite(o).all()
               for o in outs)
    assert routes == route_counts(
        crvae_free_run_resident=4, errvae_sample_resident=4), routes
    assert e2e <= TOL and same, "served own weights disagree"

    art16 = os.path.join(out_dir, "g16.vcxt")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export", "lorenz96_crvae",
                  os.path.join(out_dir, "ckpt_phase2"), "--out", art16,
                  "--batch", str(batch), "--serve-dtype", "bfloat16",
                  "--device", str(dev)])
    cr.reset_launches()
    srv = GeneratorServer(art16, device=dev)
    srv.start()
    try:
        outs16 = [post(srv, {"seed": s}) for s in (1, 2, 3)]
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/meta", timeout=60) as r:
            meta16 = json.loads(r.read())
    finally:
        srv.shutdown()
    launches16, routes16 = dict(cr.LAUNCHES), dict(cr.ROUTE_LAUNCHES)
    ref16 = plain_generation(model, err, ck["crvae"], ck["error_vae"], 1,
                             batch, dev, torch.bfloat16)
    exact16 = plain_generation_exact(model, err, ck["crvae"],
                                     ck["error_vae"], 1, batch, dev)
    dist_ok, gaps = bf16_in_distribution(outs16[0], ref16)
    in_proc = {sd: generate_with_compensation(
        model, err, ck["crvae"], ck["error_vae"],
        torch.Generator(device=dev).manual_seed(1), batch,
        dtype=sd).cpu().numpy() for sd in ("float32", "bfloat16")}
    same16 = np.array_equal(outs16[0], in_proc["bfloat16"])
    agree = bf16_agreement(outs16[0], ref16)
    witness = bf16_agreement(exact16, ref16)
    vs_exact = bf16_agreement(outs16[0], exact16)
    control = bf16_agreement(in_proc["float32"], ref16)
    rounded = bf16_agreement(torch.from_numpy(in_proc["float32"]).to(
        torch.bfloat16).float(), ref16)
    agree_ok = (trained_ok(agree, witness) and not trained_ok(control, witness)
                and not trained_ok(rounded, witness))
    fresh = load_in_fresh_process([(art, 1, None), (art16, 1, None)])
    e_fresh = float(np.abs(np.load(art + ".npy") - in_proc["float32"]).max())
    same_fresh16 = np.array_equal(np.load(art16 + ".npy"),
                                  in_proc["bfloat16"])
    log(f"main path serving the port's own weights as bf16 (batch {batch}): "
        f"3 requests, launches {launches16}, by route {routes16}, /meta "
        f"serve_dtype {meta16['serve_dtype']}; served vs plain bf16: "
        f"{agreement_text(agree)} (need bf16 values, share >= "
        f"{BF16_SAME}, first departure <= {BF16_TOL:g}, rows beyond at most "
        f"twice the exact sums', the controls failing: "
        f"{'ok' if agree_ok else 'FAIL'}); plain with exact sums vs plain "
        f"bf16: {agreement_text(witness)}; served vs plain with exact sums: "
        f"{agreement_text(vs_exact)}; control float32 kernel: bf16 values "
        f"{control['bf16']}, rounded to bf16 at the output: share "
        f"{rounded['same']:.5f}, max {rounded['worst']:.3e}; JAX package's "
        f"bf16 bounds: max |d| {gaps[0]:.4e} limit {gaps[3]:.4f}, mean gap "
        f"{gaps[1]:.3e}, std gap {gaps[2]:.3e}: "
        f"{'ok' if dist_ok else 'FAIL'}; equal to in-process bf16 "
        f"generation: {same16} [{card}]")
    log(f"artifacts in a fresh process (loader only): model/trainer modules "
        f"imported {fresh['modules']}; float32 samples vs in-process "
        f"generation max_abs_err={e_fresh:.3e} tol={TOL:g}; bf16 samples "
        f"equal to in-process bf16: {same_fresh16}; fn(seed) host ms "
        f"{ {fresh[a]['serve_dtype']: round(fresh[a]['fn_ms'], 3) for a in (art, art16)} } "
        f"[{card}]")
    assert routes16 == route_counts(
        crvae_free_run_bf16_resident=4, errvae_sample_bf16_resident=4), \
        routes16
    assert meta16["serve_dtype"] == "bfloat16", meta16
    assert agree_ok and dist_ok and same16, "served bf16 weights disagree"
    assert fresh["modules"] == [], fresh["modules"]
    assert e_fresh <= TOL and same_fresh16, "fresh-process samples disagree"
    return {"served_own": launches, "served_own_bf16": launches16,
            "fresh_process": {"f32_max_abs_err": e_fresh,
                              "fn_ms": {fresh[a]["serve_dtype"]:
                                        fresh[a]["fn_ms"]
                                        for a in (art, art16)}}}


def time_phase2(dev, card, windows20, windows10):
    """Phase 5c: steps/s through fit_phase2 beside fit_phase1 at p=20 and
    at lorenz96_crvae's p=10 (two runs each, in turns, host clock), the
    launches a step, and the device's busy share of a phase-2 step."""
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.train import (
        Phase1Config,
        Phase2Config,
        fit_phase1,
        fit_phase2,
        make_phase2_step,
    )

    out = {}
    for p, windows in ((P, windows20), (CRVAE_P, windows10)):
        g = torch.Generator().manual_seed(41)
        model, err = CRVAE(p, H, ENC), ErrorVAE(p, H)
        params, eparams = model.init(g, dev), err.init(g, dev)
        ones = torch.ones((p, p), device=dev)
        c1 = Phase1Config(max_iter=RATE_STEPS, batch_size=TRAIN_B)
        c2 = Phase2Config(max_iter=RATE_STEPS, batch_size=TRAIN_B)
        rates, launches = {}, {}
        for phase in ("phase1", "phase2", "phase1", "phase2"):
            gen = torch.Generator(device=dev).manual_seed(42)
            torch.cuda.synchronize()
            cuda_gru.reset_launches()
            t0 = time.perf_counter()
            if phase == "phase1":
                fit_phase1(model, params, windows, ones, c1, gen)
            else:
                fit_phase2(model, err, params, eparams, windows, ones, c2, gen)
            torch.cuda.synchronize()
            rates.setdefault(phase, []).append(
                RATE_STEPS / (time.perf_counter() - t0))
            launches[phase] = {k: v / RATE_STEPS for k, v in
                               cuda_gru.LAUNCHES.items() if v}
        step = make_phase2_step(model, err, c2, windows, ones)
        state = [phase2_state(model, err, params, eparams,
                              torch.Generator(device=dev).manual_seed(43),
                              dev)]

        def run():
            state[0] = step(state[0])[0]

        for _ in range(4):
            run()
        wall, by_kernel = profile_ms(run, 20)
        busy = sum(by_kernel.values())
        row = {"phase1_steps_s": rates["phase1"],
               "phase2_steps_s": rates["phase2"],
               "phase2_wall_ms": wall, "phase2_device_ms": busy,
               "phase2_busy_share": busy / wall}
        out[f"p{p}"] = row
        log(f"time phase-2 steps/s p={p} H={H} B={TRAIN_B} via fit_phase2: "
            f"{rates['phase2'][0]:.1f}, {rates['phase2'][1]:.1f}; phase 1 via "
            f"fit_phase1: {rates['phase1'][0]:.1f}, {rates['phase1'][1]:.1f} "
            f"(two runs each, in turns); launches a step {launches}; a "
            f"phase-2 step under the profiler: wall {wall:.4f} ms, device "
            f"{busy:.4f} ms, busy share {busy / wall:.3f} [{card}]")
    return out


def time_recurrence(dev, card, g, heads, b, td, d, hid):
    """Device times of B1 and B2 (whichever variant the shapes take) at one
    shape beside their plain versions: by CUDA events and by the profiler,
    B2's chain and weight-gradient kernels apart, and at one head cuDNN's
    nn.GRU, the one torch call that computes the same function."""
    import torch

    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops.gru import GRUParams, init_stacked_gru

    params = init_stacked_gru(g, heads, d, hid, device=dev)
    x = torch.randn((b, td, d), generator=g).to(dev)
    h0 = torch.randn((1, b, hid), generator=g).to(dev)
    douts = torch.randn((heads, b, td, hid), generator=g).to(dev)
    h0b = h0.expand(heads, b, hid)
    leaves = [v.clone().requires_grad_(True) for v in
              (params.w_ih, params.w_hh, params.b_ih, params.b_hh)]
    p_req = GRUParams(*leaves)
    outs = cuda_gru._forward_launch(params.w_ih, params.b_ih, params.w_hh,
                                    params.b_hh, x, h0b)
    plain_outs, _ = cuda_gru.gru_scan_heads_fused_plain(p_req, x, h0)
    row = {
        "ms": time_ms(lambda: cuda_gru.fused_gru_scan_heads(params, x, h0),
                      100),
        "fwd_device_ms": sum(device_ms(
            lambda: cuda_gru.fused_gru_scan_heads(params, x, h0),
            50).values()),
        "plain_ms": time_ms(lambda: cuda_gru.fused_gru_scan_heads_plain(
            params, x, h0), 100),    # params carry no grad: no graph
        "bwd_ms": time_ms(lambda: cuda_gru._backward_launch(
            params.w_ih, params.b_ih, params.w_hh, params.b_hh, x, h0b,
            outs, douts, need_dx=False), 100),
        "bwd_plain_ms": time_ms(lambda: torch.autograd.grad(
            plain_outs, leaves, douts, retain_graph=True), 100),
    }
    # B2's two kernels apart, through their wrappers (CUDA events) and on
    # the device alone (profiler; the host's work left out).
    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    gh, _ = cuda_gru.bwd_chain(*w, x, h0b, outs, douts)
    row["chain_ms"] = time_ms(
        lambda: cuda_gru.bwd_chain(*w, x, h0b, outs, douts), 100)
    row["wgrad_ms"] = time_ms(
        lambda: cuda_gru.bwd_wgrad(*w, x, h0b, outs, gh, False), 100)
    dev_ms = device_ms(lambda: cuda_gru._backward_launch(
        *w, x, h0b, outs, douts, need_dx=False), 50)
    row["bwd_device_ms"] = sum(dev_ms.values())
    for key, name in (("chain_device_ms", "gru_chain"),
                      ("wgrad_device_ms", "gru_wgrad_kernel"),
                      ("xproj_device_ms", "gru_xproj_kernel")):
        row[key] = sum(v for k, v in dev_ms.items() if name in k)
    # The one torch call that computes the weight-gradient kernel's
    # products: gh^T [x | h_prev] per head by torch.bmm (TF32 off; all 4H
    # gate-gradient columns against both, of which the kernel's dW_ih and
    # dW_hh are blocks), its operands made before the timing; beside the
    # kernel's own bound.
    a_t = gh.reshape(heads, b * td, 4 * hid).transpose(1, 2)
    xh = torch.cat([x.expand(heads, b, td, d),
                    cuda_gru._h_prev(h0b, outs)], dim=-1).reshape(
                        heads, b * td, d + hid)
    row["wgrad_library_ms"] = time_ms(lambda: torch.bmm(a_t, xh), 100)
    row["wgrad_bound_ms"] = bound(*wgrad_cost(heads, b, td, d, hid))[0]
    del a_t, xh
    if cuda_gru.recurrence_route(heads, b, d, hid,
                                 cuda_gru.device_limits(dev)) == "wide":
        # The wide forward: its plan, its time beside its bound at the f32
        # rate and at the 3xTF32 rate its products run at, its device time
        # by kernel (the projection, the walk).
        row["fwd_plan"] = wide_fwd_line(outs.shape, d, dev)
        row["fwd_bound_ms"] = bound(*gru_cost(heads, b, td, d, hid,
                                              backward=False))[0]
        row["fwd_bound_tf32x3_ms"] = b1_wide_bound(heads, b, td, d, hid)[0]
        f_ms = device_ms(lambda: cuda_gru.fused_gru_scan_heads(
            params, x, h0), 20)
        row["fwd_xproj_device_ms"] = sum(
            v for k, v in f_ms.items() if "gru_xproj_kernel" in k)
        row["fwd_walk_device_ms"] = sum(
            v for k, v in f_ms.items() if "gru_forward_wide_kernel" in k)
        log(f"time wide forward P={heads} B={b} T={td} D={d} H={hid}: "
            f"{row['fwd_plan']}; {row['ms']:.4f} ms (device "
            f"{row['fwd_walk_device_ms']:.4f} walk + "
            f"{row['fwd_xproj_device_ms']:.4f} projection) against its bound "
            f"{row['fwd_bound_ms']:.4f} ms at f32 "
            f"({row['fwd_bound_ms'] / row['ms']:.1%}), "
            f"{row['fwd_bound_tf32x3_ms']:.4f} ms at 3xTF32 "
            f"({row['fwd_bound_tf32x3_ms'] / row['ms']:.1%}) [{card}]")
        # The wide chain: its plan, its time beside its share of the bound
        # (the chain's own work, chain_cost: at the f32 rate, and at the
        # rate of three TF32 passes a product, which its products run at),
        # the projection's, and B2's.
        row["chain_plan"] = wide_chain_line(outs.shape, d, dev)
        row["chain_bound_ms"] = bound(*chain_cost(heads, b, td, d, hid))[0]
        row["chain_bound_tf32x3_ms"] = bound(
            *chain_cost(heads, b, td, d, hid), TF32X3_FLOPS)[0]
        row["xproj_ms"] = time_ms(lambda: cuda_gru.bwd_xproj(
            params.w_ih, params.b_ih, x), 100)
        row["xproj_bound_ms"] = bound(*xproj_cost(heads, b, td, d, hid))[0]
        log(f"time wide chain P={heads} B={b} T={td} D={d} H={hid}: "
            f"{row['chain_plan']}; chain {row['chain_ms']:.4f} ms (device "
            f"{row['chain_device_ms']:.4f} walk + {row['xproj_device_ms']:.4f}"
            f" projection) against its bound {row['chain_bound_ms']:.4f} ms "
            f"at f32 ({row['chain_bound_ms'] / row['chain_ms']:.1%}), "
            f"{row['chain_bound_tf32x3_ms']:.4f} ms at 3xTF32 "
            f"({row['chain_bound_tf32x3_ms'] / row['chain_ms']:.1%}); "
            f"projection "
            f"alone {row['xproj_ms']:.4f} ms (bound "
            f"{row['xproj_bound_ms']:.4f}); whole B2 {row['bwd_ms']:.4f} ms "
            f"[{card}]")
    if heads == 1:
        gru = torch.nn.GRU(d, hid, batch_first=True).to(dev)
        with torch.no_grad():
            for name, v in (("weight_ih_l0", params.w_ih[0]),
                            ("weight_hh_l0", params.w_hh[0]),
                            ("bias_ih_l0", params.b_ih[0]),
                            ("bias_hh_l0", params.b_hh[0])):
                getattr(gru, name).copy_(v)
        with torch.no_grad():
            ref, _ = gru(x, h0)
        e = (ref - outs[0]).abs().max().item()
        lib_out, _ = gru(x, h0)
        row["library_ms"] = time_ms(lambda: gru(x, h0), 100)
        row["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, list(gru.parameters()), douts[0], retain_graph=True),
            100)
        log(f"cuDNN nn.GRU vs B1 at B={b} T={td} D={d} H={hid}: "
            f"max_abs_err {e:.3e}")
    log(f"time recurrence P={heads} B={b} T={td} D={d} H={hid}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                    if isinstance(v, float)) + f" [{card}]")
    return row


def recurrence_rows(fwd, bwd, enc, heads, heads_shape):
    """The JSON rows of B1 and B2 (one variant): times at the one-head
    encoder shape, the heads' in ``extra``."""
    fwd_bound, _ = bound(*gru_cost(*heads_shape, backward=False))
    bwd_bound, _ = bound(*gru_cost(*heads_shape, backward=True))
    return {
        fwd: {"ms": enc["ms"], "plain_ms": enc["plain_ms"],
              "library_ms": enc["library_ms"], "extra": {
                  "device_ms": enc["fwd_device_ms"],
                  "heads_device_ms": heads["fwd_device_ms"],
                  "heads_ms": heads["ms"],
                  "heads_plain_ms": heads["plain_ms"],
                  "heads_bound_ms": fwd_bound,
                  **{f"{pre}{k}": r[k] for pre, r in
                     (("", enc), ("heads_", heads))
                     for k in ("fwd_plan", "fwd_bound_ms",
                               "fwd_bound_tf32x3_ms", "fwd_xproj_device_ms",
                               "fwd_walk_device_ms") if k in r}}},
        bwd: {"ms": enc["bwd_ms"], "plain_ms": enc["bwd_plain_ms"],
              "library_ms": enc["bwd_library_ms"], "extra": {
                  "heads_ms": heads["bwd_ms"],
                  "heads_plain_ms": heads["bwd_plain_ms"],
                  "heads_bound_ms": bwd_bound,
                  **{f"{pre}{k}": r[k] for pre, r in
                     (("", enc), ("heads_", heads))
                     for k in ("chain_ms", "wgrad_ms", "bwd_device_ms",
                               "chain_device_ms", "wgrad_device_ms",
                               "xproj_device_ms", "chain_plan",
                               "chain_bound_ms", "chain_bound_tf32x3_ms",
                               "xproj_ms", "xproj_bound_ms",
                               "wgrad_library_ms", "wgrad_bound_ms")
                     if k in r}}},
    }


def time_training(dev, card, windows):
    """Phase 5b: device times of B1, B2 (both variants), B3 beside their
    plain versions, cuDNN at the encoder shapes, and phase-1 steps/s of
    both step paths."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_step
    from vae_connexe_torch.train import Phase1Config, Phase1State, make_phase1_step

    td = CTX - ENC
    g = torch.Generator().manual_seed(7)
    res = recurrence_rows(
        "gru_forward", "gru_backward",
        time_recurrence(dev, card, g, 1, TRAIN_B, td, P, H),
        time_recurrence(dev, card, g, P, TRAIN_B, td, P, H),
        (P, TRAIN_B, td, P, H))
    std = SCALED_CTX - ENC
    res.update(recurrence_rows(
        "gru_forward_wide", "gru_backward_wide",
        time_recurrence(dev, card, g, 1, SCALED_B, ENC, SCALED_P, SCALED_H),
        time_recurrence(dev, card, g, SCALED_P, SCALED_B, std, SCALED_P,
                        SCALED_H),
        (SCALED_P, SCALED_B, std, SCALED_P, SCALED_H)))
    # Wide B1's and B2's bounds with their products at the 3xTF32 rate.
    res["gru_forward_wide"]["extra"]["heads_bound_tf32x3_ms"] = (
        b1_wide_bound(SCALED_P, SCALED_B, std, SCALED_P, SCALED_H)[0])
    res["gru_backward_wide"]["extra"]["heads_bound_tf32x3_ms"] = (
        b2_wide_bound(SCALED_P, SCALED_B, std, SCALED_P, SCALED_H)[0])
    # lorenz96_xl's decoder heads on the wide route.
    xd = XL_CTX - ENC
    xl = time_recurrence(dev, card, g, XL_P, XL_B, xd, XL_P, XL_H)
    res["gru_forward_wide"]["extra"]["xl_heads"] = {
        **{k: xl[k] for k in ("ms", "fwd_device_ms", "plain_ms", "fwd_plan",
                              "fwd_xproj_device_ms", "fwd_walk_device_ms",
                              "fwd_bound_ms", "fwd_bound_tf32x3_ms")}}
    res["gru_backward_wide"]["extra"]["xl_heads"] = {
        **{k: xl[k] for k in ("bwd_ms", "bwd_plain_ms", "chain_ms",
                              "wgrad_ms", "chain_device_ms",
                              "xproj_device_ms", "wgrad_device_ms",
                              "chain_plan", "chain_bound_ms",
                              "chain_bound_tf32x3_ms", "xproj_ms",
                              "xproj_bound_ms", "wgrad_library_ms",
                              "wgrad_bound_ms")},
        "bound_ms": bound(*gru_cost(XL_P, XL_B, xd, XL_P, XL_H,
                                    backward=True))[0],
        "bound_tf32x3_ms": b2_wide_bound(XL_P, XL_B, xd, XL_P, XL_H)[0]}

    model = CRVAE(P, H, ENC)
    params = model.init(torch.Generator().manual_seed(8), dev)
    cfg = Phase1Config(batch_size=TRAIN_B)
    parents = torch.ones((P, P), device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    batch = windows[:TRAIN_B].contiguous()
    eps = torch.randn((TRAIN_B, H), generator=gen, device=dev)
    b3 = {"ms": time_ms(lambda: cuda_step.fused_phase1_step(
              model, cfg, params, parents, batch, eps), 50),
          "plain_ms": time_ms(lambda: cuda_step.fused_phase1_step_plain(
              model, cfg, params, parents, batch, eps), 50)}
    by_kernel = {}
    for key, ms in device_ms(lambda: cuda_step.fused_phase1_step(
            model, cfg, params, parents, batch, eps), 50).items():
        name = kernel_name(key)
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
    b3["extra"] = {"device_ms": sum(by_kernel.values()),
                   "device_ms_by_kernel": by_kernel}
    log(f"time phase1_step p={P} H={H} ctx={CTX} B={TRAIN_B}: kernel "
        f"{b3['ms']:.4f} ms, plain {b3['plain_ms']:.4f} ms, device "
        f"{b3['extra']['device_ms']:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
        + f" [{card}]")

    # Steps/s of the two step paths, host clock, draws included.
    state = Phase1State(params=params, prior=None, best_params=params,
                        best_loss=torch.tensor(float("inf"), device=dev),
                        generator=gen, step=0)
    step = make_phase1_step(model, cfg, windows, parents)
    rates = {}
    for name in ("make_phase1_step", "fused_phase1_step", "make_phase1_step",
                 "fused_phase1_step"):
        n, p_fused = 100, params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if name == "make_phase1_step":
                state, _ = step(state)
            else:
                p_fused, _ = _b3_step(model, cfg, p_fused, windows, parents,
                                      gen)
        torch.cuda.synchronize()
        rates.setdefault(name, []).append(n / (time.perf_counter() - t0))
    for name, r in rates.items():
        log(f"time phase-1 steps/s p={P} H={H} B={TRAIN_B} via {name}: "
            f"{r[0]:.1f}, {r[1]:.1f} (two runs, in turns) [{card}]")

    res["phase1_step"] = b3
    return res


def check_sweep(dev, card, errors, windows):
    """Phase 3e, the sweep's kernels at ``cli sweep``'s shapes.  First,
    five sweep steps of SWEEP_SEEDS seeds at lorenz96_crvae's width (the
    encoder one S-head and the decoder one S * p-head B1/B2 launch a step),
    each seed on its own resampled batch, against the same steps on the
    CPU's plain recurrences on the same indices and epsilons; two card
    sweeps bitwise equal.  Then SWEEP_CHECK_SEEDS seeds drawing from their
    own generators against each seed's single-seed step loop on the
    card."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.parallel import (
        SweepState,
        make_sweep_step,
        seed_generators,
    )
    from vae_connexe_torch.parallel.seed_sweep import init_sweep_state
    from vae_connexe_torch.train import (
        Phase1Config,
        Phase1State,
        make_phase1_step,
    )
    from vae_connexe_torch.utils.tree import tree_leaves, tree_map

    n = 5
    model = CRVAE(CRVAE_P, H, ENC)
    cfg = Phase1Config(batch_size=TRAIN_B)
    parents = torch.ones((CRVAE_P, CRVAE_P), device=dev)
    want = {"gru_forward": 2 * n, "gru_backward": 2 * n,
            "gru_forward_wide": 0, "gru_backward_wide": 0}

    s = SWEEP_SEEDS
    init = init_sweep_state(model, range(s), "cpu").params
    g = torch.Generator().manual_seed(23)
    draws = [(torch.randint(0, windows.shape[0], (s, TRAIN_B), generator=g),
              torch.randn((s, TRAIN_B, H), generator=g)) for _ in range(n)]
    windows_cpu = windows.cpu()

    def drawn(on):
        to = lambda t: t.to(on)    # noqa: E731
        params = tree_map(to, init)
        step = make_sweep_step(model, cfg, to(windows_cpu), to(parents))
        state = SweepState(params=params, best_params=params,
                           best_loss=torch.full((s,), float("inf"),
                                                device=on),
                           generators=[], step=0)
        for idx, eps in draws:
            state, met = step(state, batch=to(idx), eps=to(eps))
        return (tree_leaves(state.params) + tree_leaves(state.best_params)
                + [state.best_loss], torch.stack(list(met.values())))

    cuda_gru.reset_launches()
    k_leaves, k_met = drawn(dev)
    launches = dict(cuda_gru.LAUNCHES)
    a_leaves, a_met = drawn(dev)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in
               zip(k_leaves + [k_met], a_leaves + [a_met]))
    r_leaves, r_met = drawn(torch.device("cpu"))
    what = (f"S={s} p={CRVAE_P} H={H} ctx={CTX} B={TRAIN_B}, a batch a "
            f"seed, {n} steps, against the CPU's plain recurrences")
    log(f"check sweep {what}: launches {launches} (2 + 2 a step), two "
        f"sweeps bitwise equal: {same} [{card}]")
    if launches != want or not same:
        raise AssertionError("the sweep took other launches or is not "
                             "deterministic")
    _assert_close("sweep", _flat(k_leaves).cpu(), _flat(r_leaves), errors,
                  **STEP_TOL, what=what + ": params, best params, best loss")
    _assert_close("sweep", k_met.cpu(), r_met, errors, **STEP_TOL,
                  what=what + ": metrics")

    s = SWEEP_CHECK_SEEDS
    step = make_sweep_step(model, cfg, windows, parents)
    cuda_gru.reset_launches()
    state = init_sweep_state(model, range(s), dev)
    for _ in range(n):
        state, _ = step(state)
    launches = dict(cuda_gru.LAUNCHES)
    got = (tree_leaves(state.params) + tree_leaves(state.best_params)
           + [state.best_loss])
    single = make_phase1_step(model, cfg, windows, parents)
    refs = []
    for seed in range(s):
        gens = seed_generators(seed, dev)
        params = model.init(gens["init"], dev)
        state = Phase1State(params=params, prior=None, best_params=params,
                            best_loss=torch.tensor(float("inf"), device=dev),
                            generator=gens["run"], step=0)
        for _ in range(n):
            state, _ = single(state)
        refs.append(tree_leaves(state.params) + tree_leaves(state.best_params)
                    + [state.best_loss[None]])
    ref = [torch.stack([r[i] for r in refs]) for i in range(len(got) - 1)]
    ref.append(torch.cat([r[-1] for r in refs]))
    what = (f"S={s} p={CRVAE_P} H={H} ctx={CTX} B={TRAIN_B}, {n} steps, "
            "against each seed's single-seed loop")
    log(f"check sweep {what}: launches {launches} [{card}]")
    if launches != want:
        raise AssertionError("the sweep took other launches")
    _assert_close("sweep", _flat(got), _flat(ref), errors, **STEP_TOL,
                  what=what + ": params, best params, best loss")


def sweep_main_path(dev, card):
    """Phase 4g: ``cli sweep`` at its defaults (lorenz96_crvae's width,
    SWEEP_STEPS steps, SWEEP_SEEDS seeds): 2 B1 + 2 B2 launches a sweep
    step, every seed's AUROC against the circulant truth, the stability
    selection's JSON; returns its launches and rate."""
    import contextlib

    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr

    n, s = SWEEP_STEPS, SWEEP_SEEDS
    out = io.StringIO()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["sweep", "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, rollouts = dict(cuda_gru.LAUNCHES), dict(cr.LAUNCHES)
    res = json.loads(out.getvalue())
    rate = {"wall_s": secs, "steps_s": n / secs, "seed_steps_s": s * n / secs}
    log(f"main path cli sweep p={CRVAE_P} H={H} B={TRAIN_B} ctx={CTX} "
        f"S={s}: {n} steps in {secs:.3f} s ({n / secs:.1f} steps/s, "
        f"{s * n / secs:.1f} seed-steps/s incl. host), launches {launches}, "
        f"aurocs {[round(a, 4) for a in res['aurocs']]}; threshold "
        f"{JAX_AUROC - AUROC_MARGIN:.4f} [{card}]")
    log("stability selection " + json.dumps(
        {k: res[k] for k in ("stability_min_frac", "stability_selection")}))
    want = {"gru_forward": 2 * n, "gru_backward": 2 * n,
            "gru_forward_wide": 0, "gru_backward_wide": 0}
    assert launches == want, (launches, want)
    assert not any(rollouts.values()), rollouts
    assert res["seeds"] == s and len(res["aurocs"]) == s, res
    assert min(res["aurocs"]) >= JAX_AUROC - AUROC_MARGIN, res["aurocs"]
    assert set(res["stability_selection"]) >= {"auroc", "precision",
                                               "recall", "f1"}, res
    return launches, rate


class _Taps:
    """Wraps functions of a module (or methods of a class) for one call:
    records what each returned with the recurrence launch counts when it
    returned (``seen``: what ``discover`` returned, the counts when the
    sweep and phase 2 returned) and the launches made inside it
    (``during``: a W_in ``fit_many``'s)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.saved, self.seen, self.during = {}, {}, {}

    def __enter__(self):
        from vae_connexe_torch.ops import cuda_gru

        for name in self.names:
            fn = self.saved[name] = getattr(self.module, name)

            def tap(*a, _fn=fn, _name=name, **k):
                before = dict(cuda_gru.LAUNCHES)
                out = _fn(*a, **k)
                after = dict(cuda_gru.LAUNCHES)
                self.seen[_name] = (out, after)
                self.during[_name] = {c: after[c] - before[c] for c in after}
                return out

            setattr(self.module, name, tap)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def discover_main_path(dev, card, out_dir):
    """Phase 4h: ``cli discover`` on a Lorenz-96 series (p=10, T=2048, made
    on the card) saved as a CSV with a header: SWEEP_SEEDS seeds of
    SWEEP_STEPS steps (cut from 2000), phase 2 for DISCOVER_P2 steps and
    DISCOVER_GEN compensated samples.  Gates: the reported scores' AUROC,
    finite samples of the right shape, the header's names in the edges, the
    launches of each part; returns the launches."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.data import lorenz96, lorenz96_truth
    from vae_connexe_torch.evals import auroc
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr

    n, s, n2 = SWEEP_STEPS, SWEEP_SEEDS, DISCOVER_P2
    series = lorenz96(torch.Generator(device=dev).manual_seed(5), p=CRVAE_P,
                      t=SERIES_T, device=dev).cpu().numpy()
    names = [f"x{i}" for i in range(CRVAE_P)]
    path = os.path.join(out_dir, "lorenz96.csv")
    np.savetxt(path, series, delimiter=",", header=",".join(names),
               comments="")
    module = importlib.import_module("vae_connexe_torch.discover")
    out = io.StringIO()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with _Taps(module, ("discover", "sweep_phase1", "fit_phase2")) as taps, \
            contextlib.redirect_stdout(out):
        cli.main(["discover", path, "--seeds", str(s), "--iters", str(n),
                  "--generate", str(DISCOVER_GEN), "--phase2-iters", str(n2),
                  "--device", str(dev), "--quiet"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total, rollouts = dict(cuda_gru.LAUNCHES), dict(cr.ROUTE_LAUNCHES)
    summary = json.loads(out.getvalue())
    res = taps.seen["discover"][0]
    swept = taps.seen["sweep_phase1"][1]
    p2 = {k: v - swept[k] for k, v in taps.seen["fit_phase2"][1].items()}
    gen = {k: v - taps.seen["fit_phase2"][1][k] for k, v in total.items()}
    truth = lorenz96_truth(CRVAE_P, "cpu")
    score_auroc = float(auroc(truth, torch.tensor(res.scores)))
    log(f"main path cli discover p={CRVAE_P} T={SERIES_T} H={H} B={TRAIN_B} "
        f"S={s}: {n} sweep steps + {n2} phase-2 steps + {DISCOVER_GEN} "
        f"samples in {secs:.3f} s; launches sweep {swept}, phase 2 {p2}, "
        f"after phase 2 {gen}, rollouts by route {rollouts}; scores auroc "
        f"{score_auroc:.4f}, confidence {summary['confidence']}, "
        f"{summary['n_edges']} edges, vote threshold "
        f"{summary['threshold']} [{card}]")
    zero = {"gru_forward_wide": 0, "gru_backward_wide": 0}
    assert swept == {"gru_forward": 2 * n, "gru_backward": 2 * n, **zero}
    assert p2 == {"gru_forward": 4 * n2, "gru_backward": 4 * n2, **zero}, p2
    assert not any(gen.values()), gen
    assert rollouts == route_counts(
        crvae_free_run_resident=1, errvae_sample_resident=1), rollouts
    assert score_auroc >= JAX_AUROC - AUROC_MARGIN, score_auroc
    assert res.samples.shape == (DISCOVER_GEN, T, CRVAE_P)
    assert np.isfinite(res.samples).all()
    assert summary["variables"] == names
    assert summary["edges"] and all(
        e["cause"] in names and e["effect"] in names
        for e in summary["edges"]), summary["edges"]
    return {"discover_sweep": swept, "discover_phase2": p2,
            "discover_rollouts": rollouts,
            "discover": {"wall_s": secs, "auroc": score_auroc,
                         "confidence": summary["confidence"]}}


def time_sweep(dev, card, windows10, windows20):
    """Phase 5d: sweep steps/s and seed-steps/s at p=10 and p=20 for S in
    SWEEP_RATE_SEEDS (host clock, draws included) beside fit_phase1's
    steps/s in the same run; a sweep step under the profiler (device busy
    share, device time by kernel, launches a step, the draw kernels); B1
    and B2 at S * p heads beside their bound; the scratch of the decoder's
    B2 and its repeated input."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.parallel import make_sweep_step
    from vae_connexe_torch.parallel.seed_sweep import init_sweep_state
    from vae_connexe_torch.train import Phase1Config, fit_phase1

    td, out = CTX - ENC, {}
    for p, windows in ((CRVAE_P, windows10), (P, windows20)):
        model = CRVAE(p, H, ENC)
        cfg = Phase1Config(max_iter=RATE_STEPS, batch_size=TRAIN_B)
        ones = torch.ones((p, p), device=dev)
        params = model.init(torch.Generator().manual_seed(51), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_phase1(model, params, windows, ones, cfg,
                   torch.Generator(device=dev).manual_seed(52))
        torch.cuda.synchronize()
        fit_rate = RATE_STEPS / (time.perf_counter() - t0)
        step = make_sweep_step(model, cfg, windows, ones)
        for s in SWEEP_RATE_SEEDS:
            state = [init_sweep_state(model, range(s), dev)]

            def run():
                state[0] = step(state[0])[0]

            for _ in range(3):
                run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            n = SWEEP_RATE_STEPS
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            rate = n / (time.perf_counter() - t0)
            counts = {}
            wall, by_kernel = profile_ms(run, 10, counts)
            busy = sum(by_kernel.values())
            b1 = sum(v for k, v in by_kernel.items() if "gru_forward" in k)
            b2 = sum(v for k, v in by_kernel.items()
                     if any(n_ in k for n_ in ("gru_chain", "gru_wgrad",
                                               "gru_dx")))
            heads = s * p
            b1_bound = (bound(*gru_cost(heads, TRAIN_B, td, p, H, False,
                                        True))[0]
                        + bound(*gru_cost(s, TRAIN_B, ENC, p, H, False,
                                          True))[0])
            b2_bound = (bound(*gru_cost(heads, TRAIN_B, td, p, H, True,
                                        True))[0]
                        + bound(*gru_cost(s, TRAIN_B, ENC, p, H, True,
                                          True))[0])
            draws = sum(v for k, v in counts.items()
                        if "distribution" in k or "random" in k.lower())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            row = {"steps_s": rate, "seed_steps_s": s * rate,
                   "fit_phase1_steps_s": fit_rate, "wall_ms": wall,
                   "device_ms": busy, "busy_share": busy / wall,
                   "kernels_a_step": sum(counts.values()),
                   "draw_kernels_a_step": draws,
                   "b1_device_ms": b1, "b1_bound_ms": b1_bound,
                   "b2_device_ms": b2, "b2_bound_ms": b2_bound,
                   "b2_gate_scratch_mb": heads * TRAIN_B * td * 4 * H * 4 / 1e6,
                   "decoder_input_mb": heads * TRAIN_B * td * p * 4 / 1e6,
                   "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 1e6,
                   "top_kernels_ms": {kernel_name(k): v for k, v in top}}
            out[f"p{p}_s{s}"] = row
            log(f"time sweep p={p} S={s} (decoder P={heads}) H={H} "
                f"B={TRAIN_B}: {rate:.1f} steps/s, {s * rate:.1f} seed-steps/s "
                f"(fit_phase1 {fit_rate:.1f} steps/s); under the profiler "
                f"wall {wall:.4f} ms, device {busy:.4f} ms, busy "
                f"{busy / wall:.3f}, {row['kernels_a_step']:.0f} kernels a "
                f"step ({draws:.0f} draws); B1 {b1:.4f} ms (bound "
                f"{b1_bound:.4f}), B2 {b2:.4f} ms (bound {b2_bound:.4f}); B2 "
                f"gate scratch {row['b2_gate_scratch_mb']:.1f} MB, repeated "
                f"decoder input {row['decoder_input_mb']:.1f} MB, peak "
                f"{row['peak_mem_mb']:.0f} MB; top "
                + ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in top)
                + f" [{card}]")
            del state
    return out


# ---------------- the W_in family and the Henon / VAR experiments ----------


def henon_windows(dev, seed=9, t=3000, d=WIN_D, tau=WIN_TAU):
    """``henon6d_win``'s (N, 2 tau, d) windows of a coupled-Henon series
    made from a generator on ``dev``."""
    import torch

    from vae_connexe_torch.data import coupled_henon, sliding_windows

    series = coupled_henon(torch.Generator(device=dev).manual_seed(seed),
                           t=t, d=d, device=dev)
    return sliding_windows(series, 2 * tau)


def win_model_trainer(prox="row", update=False, **kw):
    """``henon6d_win``'s model and trainer (d=6, H=64, Z=32, tau=10,
    lr=2e-3, lam=0.03, batch 256), the prox groups and stage-II rule
    given."""
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.models import WInCRVAE
    from vae_connexe_torch.train import WInTrainer

    exp = get_experiment("henon6d_win")
    model = WInCRVAE(d=exp.p, hidden=exp.hidden, latent=exp.latent,
                     tau=exp.tau)
    cfg = dataclasses.replace(exp.win, prox_groups=prox,
                              update_w_in_stage2=update, **kw)
    return model, WInTrainer(model, cfg)


def check_win_steps(dev, errors, windows):
    """Phase 3e: five stage-I and five stage-II steps of ``henon6d_win``'s
    model on the card against the same steps on the CPU's plain
    recurrences, on the same batches and epsilons, for both prox groups
    and both stage-II rules (params, Adam's state, metrics; rtol 1e-4,
    atol 1e-6); two card runs bitwise equal; 2 + 2 launches a stage-I step
    and 4 + 4 a stage-II step at S = 1, 3 and 8; a 3-seed ``fit_many``
    against the three single ``fit``s on the card, and bitwise repeatable.
    Returns the launches a step."""
    import torch

    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.optim import adam_init
    from vae_connexe_torch.train.win_trainer import adam_leaves
    from vae_connexe_torch.utils.tree import (
        stack_trees,
        tree_leaves,
        tree_map,
        unstack_tree,
    )

    g = torch.Generator().manual_seed(61)
    cpu_windows = windows.cpu()
    n, b = windows.shape[0], WIN_B
    draws = [(torch.randint(0, n, (b,), generator=g),
              torch.randn((b, WIN_Z), generator=g),
              torch.randn((b, WIN_Z // 2), generator=g)) for _ in range(10)]
    for prox in ("row", "element"):
        for update in (False, True):
            model, trainer = win_model_trainer(prox, update)
            params = model.init(torch.Generator().manual_seed(62), "cpu")

            def run(on):
                to = lambda t: t.to(on)    # noqa: E731
                state = trainer.init_state(tree_map(to, params),
                                           torch.Generator())
                for k, (idx, ez, ee) in enumerate(draws):
                    batch = to(cpu_windows[idx])
                    if k == 5:
                        state = dataclasses.replace(
                            state, params=trainer.prune(state.params))
                    if k < 5:
                        state, met = trainer.step_stage1(state, batch, to(ez))
                    else:
                        state, met = trainer.step_stage2(state, batch, to(ez),
                                                         to(ee))
                return (tree_leaves(state.params)
                        + tree_leaves(state.opt_state.mu)
                        + tree_leaves(state.opt_state.nu),
                        torch.stack(list(met.values())))

            k_leaves, k_met = run(dev)
            a_leaves, a_met = run(dev)
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in
                       zip(k_leaves + [k_met], a_leaves + [a_met]))
            r_leaves, r_met = run(torch.device("cpu"))
            what = (f"henon6d_win d={WIN_D} H={H} tau={WIN_TAU} B={b} "
                    f"prox={prox} update_w_in_stage2={update}, 5 + 5 steps")
            log(f"check win_step {what}: two card runs bitwise equal: {same}")
            if not same:
                raise AssertionError("the win steps are not deterministic")
            _assert_close("win_step", _flat(k_leaves).cpu(), _flat(r_leaves),
                          errors, **STEP_TOL,
                          what=what + ": params, Adam's moments")
            _assert_close("win_step", k_met.cpu(), r_met, errors, **STEP_TOL,
                          what=what + ": metrics")

    model, trainer = win_model_trainer()
    launches = {}
    for s in (1, 3, 8):
        params = stack_trees([model.init(torch.Generator().manual_seed(70 + i),
                                         dev) for i in range(s)])
        opt = adam_init(adam_leaves(params))
        batch = windows[torch.randint(0, n, (s, b), generator=g).to(dev)]
        ez = torch.randn((s, b, WIN_Z), generator=g).to(dev)
        ee = torch.randn((s, b, WIN_Z // 2), generator=g).to(dev)
        for stage in (1, 2):
            torch.cuda.synchronize()
            cuda_gru.reset_launches()
            trainer._update(stage, params, opt, batch, ez, ee)
            torch.cuda.synchronize()
            got = {k: v for k, v in cuda_gru.LAUNCHES.items()}
            launches[f"stage{stage}_S{s}"] = got
            want = 2 * stage
            if got != {"gru_forward": want, "gru_backward": want,
                       "gru_forward_wide": 0, "gru_backward_wide": 0}:
                raise AssertionError(f"stage {stage} at S={s}: {got}")
    log(f"check win launches a step (2 + 2 stage I, 4 + 4 stage II): "
        f"{launches}")

    sub = windows[:1024]
    model, trainer = win_model_trainer(
        "element", True, stage1_epochs=2, stage2_epochs=1)
    inits = [model.init(torch.Generator().manual_seed(80 + i), dev)
             for i in range(3)]
    gens = lambda: [torch.Generator(device=dev).manual_seed(90 + i)  # noqa
                    for i in range(3)]
    many, _ = trainer.fit_many(stack_trees(inits), sub, gens())
    again, _ = trainer.fit_many(stack_trees(inits), sub, gens())
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in
               zip(tree_leaves(many), tree_leaves(again)))
    singles = [trainer.fit(inits[i], sub, gens()[i])[0] for i in range(3)]
    what = (f"3-seed fit_many d={WIN_D} H={H} B={b} on 1024 windows, 2 + 1 "
            f"epochs, element prox, W_in updated in stage II")
    log(f"check win_fit_many {what}: two runs bitwise equal: {same}")
    if not same:
        raise AssertionError("fit_many is not deterministic")
    for i in range(3):
        _assert_close("win_step", _flat(tree_leaves(unstack_tree(many, i))),
                      _flat(tree_leaves(singles[i])), errors, **STEP_TOL,
                      what=f"{what}: seed {i} against its single fit")
    return launches


def _png_free(names):
    return {f for f in names if not f.endswith(".png")}


def win_run_main_path(dev, card, out_dir, name, argv_extra):
    """Phase 4i: ``cli run <name>`` of the win family with --out-dir and
    --save-checkpoints.  Gates: 2 + 2 launches a stage-I step and 4 + 4 a
    stage-II step of the main fit (read at the per-block log lines), the
    stability seeds' fit_many and the rest exactly counted;
    ``gc_offdiag_auto.auroc`` at least the JAX package's at the same
    counts minus the margin; a finite stability row; the JAX package's
    files, PNGs aside.  Returns the launches and the metrics."""
    import contextlib

    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.train import WInTrainer

    exp = get_experiment(name)
    run_dir = os.path.join(out_dir, name)
    tap, err = _ChunkTap(STAGE_LINE), io.StringIO()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with _Taps(WInTrainer, ("fit_many",)) as taps, \
            contextlib.redirect_stdout(tap), contextlib.redirect_stderr(err):
        cli.main(["run", name, *argv_extra, "--out-dir", run_dir,
                  "--save-checkpoints", "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total = dict(cuda_gru.LAUNCHES)
    res = json.load(open(os.path.join(run_dir, f"metrics_{name}.json")))
    e1, e2 = WIN_RUNS[name]
    n_win = (exp.t - 2 * exp.tau + 1) if exp.dataset != "var" else 500
    nb = n_win // exp.win.batch_size
    end1 = [c for st, _, c in tap.snaps if st == "stage1"][-1]
    end2 = [c for st, _, c in tap.snaps if st == "stage2"][-1]
    stage2 = {k: end2[k] - end1[k] for k in total}
    many_e2 = e2 if exp.win.update_w_in_stage2 else 0
    # After the main fit: the prediction MSE's three forwards (2 + 4 + 2
    # B1), the stability seeds' fit_many, and generate's encoder (1 B1).
    rest = {k: total[k] - end2[k] for k in total}
    many = taps.during["fit_many"]
    zero = {"gru_forward_wide": 0, "gru_backward_wide": 0}
    want_many = {"gru_forward": 2 * nb * e1 + 4 * nb * many_e2,
                 "gru_backward": 2 * nb * e1 + 4 * nb * many_e2, **zero}
    want_rest = {**want_many, "gru_forward": want_many["gru_forward"] + 9}
    log(f"main path cli run {name} d={exp.p} H={exp.hidden} B="
        f"{exp.win.batch_size} {e1} + {e2} epochs ({nb} steps an epoch), "
        f"{exp.stability_seeds - 1} stability seeds folded, in {secs:.3f} s: "
        f"launches stage I {end1}, stage II {stage2}, after the fit {rest} "
        f"of which the stability seeds' fit_many {many}; rollout launches "
        f"{dict(cr.LAUNCHES)} [{card}]")
    assert end1 == {"gru_forward": 2 * nb * e1, "gru_backward": 2 * nb * e1,
                    **zero}, end1
    assert stage2 == {"gru_forward": 4 * nb * e2, "gru_backward": 4 * nb * e2,
                      **zero}, stage2
    assert many == want_many, (many, want_many)
    assert rest == want_rest, (rest, want_rest)
    assert not any(cr.LAUNCHES.values())
    off, stab = res["gc_offdiag_auto"], res["gc_stability"]
    log(f"graph recovery {name}: gc_offdiag_auto auroc={off['auroc']:.4f} "
        f"f1={off['f1']:.4f}; gc_stability f1={stab['f1']:.4f} auroc="
        f"{stab['auroc']:.4f} min_frac={stab['min_frac']}; threshold "
        f"{JAX_WIN_AUROC[name] - AUROC_MARGIN:.4f} (JAX {JAX_WIN_AUROC[name]} "
        f"- {AUROC_MARGIN}, tools/jax_win_auroc.py); prediction_mse "
        f"{res['prediction_mse']} [{card}]")
    assert off["auroc"] >= JAX_WIN_AUROC[name] - AUROC_MARGIN, off
    assert all(math.isfinite(v) for k, v in stab.items()
               if k in ("accuracy", "precision", "recall", "f1", "auroc"))
    files = set(os.listdir(run_dir))
    want = {f"{s}{name}{x}" for s, x in (
        ("GC_scores_", ".npy"), ("syn_", ".npy"), ("metrics_", ".json"))}
    want |= {"ckpt_win", "ckpt_win.gc.npy"}
    assert _png_free(files) == want, sorted(files)
    log(f"files of {name}: {sorted(files)}; stderr: "
        f"{err.getvalue().strip() or '(none)'}")
    return {"stage1": end1, "stage2": stage2, "after_fit": rest,
            "fit_many": many, "wall_s": secs, "auroc": off["auroc"], "stability_f1": stab["f1"]}


def henon_author_main_path(dev, card, out_dir):
    """Phase 4j: ``cli run henon_author`` (p=2, crvae family), phase 1 at
    its own 1000 steps and phase 2 cut from 10000 to 1000: 2 + 2 launches
    a phase-1 step and 4 + 4 a phase-2 step, K1 and K2 on a 2-block
    cluster (one head a block) for the two generations, the JAX package's
    files, PNGs aside; then phase 1 at AUTHOR_SEEDS seeds in one seed
    sweep: the share of seeds whose ``gc_dynamics.auroc`` reads 1.0 at
    least the JAX package's share (``JAX_AUTHOR_SHARE``) less two standard
    errors.  Returns the launches and the readings."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.data import (
        arrange_input,
        henon_chain,
        henon_dynamics_truth,
    )
    from vae_connexe_torch.evals import gc_metrics
    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.parallel.seed_sweep import sweep_phase1

    # --iters sets both phases: phase 1 keeps its own 1000 steps.
    name, (n1, n2) = "henon_author", AUTHOR_RUN
    run_dir = os.path.join(out_dir, name)
    tap, err = _ChunkTap(), io.StringIO()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tap), contextlib.redirect_stderr(err):
        cli.main(["run", name, "--iters", str(n2), "--out-dir", run_dir,
                  "--save-checkpoints", "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total, routes = dict(cuda_gru.LAUNCHES), dict(cr.ROUTE_LAUNCHES)
    res = json.load(open(os.path.join(run_dir, f"metrics_{name}.json")))
    per1 = [c for ph, _, c in tap.snaps if ph == "phase1"][-1]
    end2 = [c for ph, _, c in tap.snaps if ph == "phase2"][-1]
    per2 = {k: end2[k] - per1[k] for k in total}
    dyn = res["gc_dynamics"]
    log(f"main path cli run {name} p=2 H={H} B={TRAIN_B} {n1} + {n2} steps "
        f"in {secs:.3f} s: launches phase 1 {per1}, phase 2 {per2}, rollouts "
        f"by route {routes}; gc_dynamics auroc={dyn['auroc']:.4f} accuracy="
        f"{dyn['accuracy']:.4f}, parity-row gc auroc={res['gc']['auroc']:.4f} [{card}]")
    log(rollout_plan_line("crvae", 2, 256, 2, H, dev))
    zero = {"gru_forward_wide": 0, "gru_backward_wide": 0}
    assert per1 == {"gru_forward": 2 * n1, "gru_backward": 2 * n1, **zero}
    assert per2 == {"gru_forward": 4 * n2, "gru_backward": 4 * n2, **zero}
    assert routes == route_counts(
        crvae_free_run_resident=2, errvae_sample_resident=2), routes
    exp = get_experiment(name)
    windows, _ = arrange_input(henon_chain(t=exp.t, device=dev), exp.context)
    t1 = time.perf_counter()
    swept = sweep_phase1(CRVAE(p=exp.p, hidden=exp.hidden), windows,
                         torch.ones((exp.p, exp.p), device=dev),
                         dataclasses.replace(exp.phase1, max_iter=n1),
                         range(AUTHOR_SEEDS))
    truth = henon_dynamics_truth(dev)
    aurocs = [float(gc_metrics(truth, sc)["auroc"])
              for sc in swept["gc_scores"]]
    share = float(np.mean(np.isclose(aurocs, 1.0)))
    pooled = (share + JAX_AUTHOR_SHARE) / 2
    margin = 2 * math.sqrt(pooled * (1 - pooled) * 2 / AUTHOR_SEEDS)
    log(f"henon_author phase 1 at seeds 0-{AUTHOR_SEEDS - 1} in one seed "
        f"sweep of {n1} steps ({time.perf_counter() - t1:.3f} s): "
        f"gc_dynamics auroc {[round(a, 4) for a in aurocs]}; share at 1.0 "
        f"{share:.4f}, mean {np.mean(aurocs):.4f}; threshold "
        f"{JAX_AUTHOR_SHARE - margin:.4f} (JAX's share {JAX_AUTHOR_SHARE} at "
        f"as many seeds - two standard errors {margin:.4f}, "
        f"tools/jax_win_auroc.py author_sweep) [{card}]")
    assert share >= JAX_AUTHOR_SHARE - margin, aurocs
    files = set(os.listdir(run_dir))
    want = {f"{s}{name}{x}" for s, x in (
        ("GC_", ".npy"), ("GC_scores_", ".npy"), ("syn_", ".npy"),
        ("syn_cond_", ".npy"), ("train_log_", ".jsonl"),
        ("metrics_", ".json"))}
    want |= {"ckpt_phase1", "ckpt_phase1.gc.npy", "ckpt_phase2"}
    assert _png_free(files) == want, sorted(files)
    log(f"files of {name}: {sorted(files)}; stderr: "
        f"{err.getvalue().strip() or '(none)'}")
    return {"phase1": per1, "phase2": per2, "rollouts": routes,
            "auroc": dyn["auroc"], "seed_aurocs": aurocs,
            "share_1": share, "wall_s": secs}


def serve_win_main_path(dev, card, out_dir, windows):
    """Phase 4k: ``cli export henon6d_win`` of the run's ``ckpt_win``,
    ``cli generate --context`` on windows of the series, and
    ``GeneratorServer`` answering three context requests and refusing a
    malformed context with the JAX package's message; the served samples
    equal ``WInCRVAE.generate`` on the same seed within 1e-5."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.models import WInCRVAE
    from vae_connexe_torch.server import GeneratorServer
    from vae_connexe_torch.utils import restore_checkpoint

    name = "henon6d_win"
    exp = get_experiment(name)
    ckpt = os.path.join(out_dir, name, "ckpt_win")
    art, ctx_path = (os.path.join(out_dir, "w.vcxt"),
                     os.path.join(out_dir, "ctx.npy"))
    batch = 8
    ctx = windows[:batch].cpu().numpy()
    np.save(ctx_path, ctx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["export", name, ckpt, "--out", art, "--batch", str(batch),
                  "--length", "20", "--device", str(dev)])
        cli.main(["generate", art, "--seed", "5", "--context", ctx_path,
                  "--device", str(dev)])
    dec = json.JSONDecoder()
    text = out.getvalue().strip()
    _, end = dec.raw_decode(text)
    gen_shape = dec.raw_decode(text[end:].lstrip())[0]["shape"]
    model = WInCRVAE(d=exp.p, hidden=exp.hidden, latent=exp.latent,
                     tau=exp.tau)
    params = restore_checkpoint(ckpt, model.init(torch.Generator(), dev))
    srv = GeneratorServer(art, device=dev)
    srv.start()
    try:
        last = ctx[:, -exp.tau:]
        outs = [post(srv, {"seed": s, "context": last.tolist()})
                for s in (1, 2, 3)]
        try:
            post(srv, {"seed": 1, "context": ctx[:2].tolist()})
            refused = None
        except urllib.error.HTTPError as e:
            refused = (e.code, json.loads(e.read())["error"])
    finally:
        srv.shutdown()
    with torch.no_grad():
        ref = model.generate(params, torch.tensor(last, device=dev),
                             torch.Generator(device=dev).manual_seed(1),
                             20).cpu().numpy()
    e = float(np.abs(outs[0] - ref).max())
    log(f"main path win serving {name} (d={exp.p}, H={exp.hidden}, batch "
        f"{batch}, 20 steps): cli generate --context shape {gen_shape}; 3 "
        f"context requests, served vs WInCRVAE.generate max_abs_err={e:.3e} "
        f"tol=1e-05; malformed context -> {refused} [{card}]")
    assert gen_shape == [batch, 20, exp.p]
    assert all(o.shape == (batch, 20, exp.p) and np.isfinite(o).all()
               for o in outs)
    assert e <= 1e-5, e
    assert refused is not None and refused[0] == 400 and \
        refused[1].startswith("context shape"), refused

    art16 = os.path.join(out_dir, "w16.vcxt")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export", name, ckpt, "--out", art16, "--batch",
                  str(batch), "--length", "20", "--serve-dtype", "bfloat16",
                  "--device", str(dev)])
    last_path = os.path.join(out_dir, "ctx_last.npy")
    np.save(last_path, last)
    fresh = load_in_fresh_process([(art, 1, last_path),
                                   (art16, 1, last_path)])
    with torch.no_grad():
        ref16 = model.generate(params, torch.tensor(last, device=dev),
                               torch.Generator(device=dev).manual_seed(1), 20,
                               dtype=torch.bfloat16).cpu().numpy()
    e32 = float(np.abs(np.load(art + ".npy") - ref).max())
    e16 = float(np.abs(np.load(art16 + ".npy") - ref16).max())
    log(f"win artifacts in a fresh process (loader only): modules "
        f"{fresh['modules']}; float32 vs WInCRVAE.generate max_abs_err="
        f"{e32:.3e}, bf16 vs generate(dtype=bfloat16) max_abs_err={e16:.3e} "
        f"tol=1e-05 [{card}]")
    assert fresh["modules"] == [], fresh["modules"]
    assert e32 <= 1e-5 and e16 <= 1e-5, (e32, e16)


def win_discover_main_path(dev, card, out_dir):
    """Phase 4l: ``cli discover --family win --prox row --seeds 8`` on a
    coupled-Henon CSV made on the card (d=6, T=3000), WIN_DISCOVER_EPOCHS
    stage-I epochs at henon6d_win's lam: one fit_many of every seed (2 + 2
    launches a step); the seed-median scores' AUROC against
    ``coupled_henon_truth`` off the diagonal printed.  Returns the
    launches and the result."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.data import coupled_henon, coupled_henon_truth
    from vae_connexe_torch.evals import auroc
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.train import WInTrainer

    e1, s = WIN_DISCOVER_EPOCHS, SWEEP_SEEDS
    series = coupled_henon(torch.Generator(device=dev).manual_seed(13),
                           t=3000, d=WIN_D, device=dev).cpu().numpy()
    path = os.path.join(out_dir, "henon.csv")
    names = [f"h{i}" for i in range(WIN_D)]
    np.savetxt(path, series, delimiter=",", header=",".join(names),
               comments="")
    module = importlib.import_module("vae_connexe_torch.discover")
    out = io.StringIO()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    t0 = time.perf_counter()
    with _Taps(module, ("discover",)) as taps, \
            _Taps(WInTrainer, ("fit_many",)) as many_taps, \
            contextlib.redirect_stdout(out):
        cli.main(["discover", path, "--family", "win", "--prox", "row",
                  "--seeds", str(s), "--iters", str(e1), "--lam", "0.03",
                  "--device", str(dev), "--quiet"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, many = dict(cuda_gru.LAUNCHES), many_taps.during["fit_many"]
    res = taps.seen["discover"][0]
    summary = json.loads(out.getvalue())
    truth = coupled_henon_truth(WIN_D, device="cpu")
    off = ~torch.eye(WIN_D, dtype=torch.bool)
    score_auroc = float(auroc(truth[off], torch.tensor(res.scores)[off]))
    nb = (3000 - 2 * WIN_TAU + 1) // WIN_B
    log(f"main path cli discover --family win --prox row d={WIN_D} T=3000 "
        f"H={H} B={WIN_B} S={s}: {e1} stage-I epochs ({nb} steps an epoch, "
        f"stage II skipped) in {secs:.3f} s; launches {launches}, of which "
        f"its fit_many {many}; scores off-diagonal auroc {score_auroc:.4f}, "
        f"confidence {summary['confidence']}, {summary['n_edges']} edges; "
        f"threshold {JAX_WIN_AUROC['discover_win'] - AUROC_MARGIN:.4f} (JAX "
        f"{JAX_WIN_AUROC['discover_win']} - {AUROC_MARGIN}, "
        f"tools/jax_win_auroc.py discover_win) [{card}]")
    zero = {"gru_forward_wide": 0, "gru_backward_wide": 0}
    want = {"gru_forward": 2 * nb * e1, "gru_backward": 2 * nb * e1, **zero}
    assert launches == want, launches
    assert many == want, many
    assert score_auroc >= JAX_WIN_AUROC["discover_win"] - AUROC_MARGIN, \
        score_auroc
    assert res.seed_scores.shape == (s, WIN_D, WIN_D)
    assert np.isfinite(res.scores).all() and math.isfinite(score_auroc)
    assert summary["variables"] == names
    return {"launches": launches, "fit_many": many, "wall_s": secs,
            "auroc_offdiag": score_auroc,
            "confidence": summary["confidence"]}


def time_win(dev, card, windows):
    """Phase 5e: stage-I and stage-II steps/s of ``henon6d_win``'s fit at
    its shapes (host clock over WIN_RATE_EPOCHS epochs, draws included),
    each step's device busy share under the profiler, ``fit_many``'s
    seed-steps/s at S=8, and the win generation's latency at B=8 and
    B=256 (20 steps) with its kernels a step."""
    import torch

    from vae_connexe_torch.utils.tree import stack_trees

    out = {}
    nb = windows.shape[0] // WIN_B
    for s in (1, 8):
        model, trainer = win_model_trainer()
        params = stack_trees([model.init(torch.Generator().manual_seed(100 + i),
                                         dev) for i in range(s)])
        state = trainer.init_state(params, [
            torch.Generator(device=dev).manual_seed(110 + i)
            for i in range(s)])
        for stage in (1, 2):
            trainer._run_stage(stage, state, windows, 1, 1)    # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = trainer._run_stage(stage, state, windows,
                                          WIN_RATE_EPOCHS, WIN_RATE_EPOCHS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            steps = nb * WIN_RATE_EPOCHS
            batch = windows[:WIN_B][None].expand(s, -1, -1, -1).contiguous()
            ez = torch.randn((s, WIN_B, WIN_Z), device=dev)
            ee = torch.randn((s, WIN_B, WIN_Z // 2), device=dev)
            counts = {}
            wall, by_kernel = profile_ms(
                lambda: trainer._update(stage, state.params, state.opt_state,
                                        batch, ez, ee), 20, counts)
            busy = sum(by_kernel.values())
            row = {"steps_s": steps / secs, "seed_steps_s": s * steps / secs,
                   "step_wall_ms": wall, "step_device_ms": busy,
                   "busy_share": busy / wall,
                   "kernels_a_step": sum(counts.values())}
            out[f"stage{stage}_S{s}"] = row
            log(f"time win stage {stage} S={s} d={WIN_D} H={H} B={WIN_B}: "
                f"{row['steps_s']:.1f} steps/s, {row['seed_steps_s']:.1f} "
                f"seed-steps/s over {steps} steps (host clock, draws "
                f"included); one update under the profiler: wall "
                f"{wall:.4f} ms, device {busy:.4f} ms, busy share "
                f"{busy / wall:.3f}, {row['kernels_a_step']:.0f} kernels "
                f"[{card}]")
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops.gru import init_stacked_gru

    g = torch.Generator().manual_seed(130)
    for heads in (WIN_D, 8 * WIN_D):
        prm = init_stacked_gru(g, heads, H, H, device=dev)
        w = (prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh)
        x = torch.randn((heads, WIN_B, WIN_TAU, H), generator=g).to(dev)
        h0 = torch.randn((heads, WIN_B, H), generator=g).to(dev)
        douts = torch.randn((heads, WIN_B, WIN_TAU, H), generator=g).to(dev)
        outs = cuda_gru._forward_launch(*w, x, h0)
        row = {
            "b1_ms": time_ms(lambda: cuda_gru._forward_launch(*w, x, h0), 100),
            "b2_ms": time_ms(lambda: cuda_gru._backward_launch(
                *w, x, h0, outs, douts, need_dx=True), 100),
            "b1_bound_ms": bound(*gru_cost(heads, WIN_B, WIN_TAU, H, H,
                                           False, per_head=True))[0],
            "b2_bound_ms": bound(*gru_cost(heads, WIN_B, WIN_TAU, H, H,
                                           True, per_head=True))[0]}
        out[f"recurrence_P{heads}"] = row
        log(f"time win decoder recurrence P={heads} B={WIN_B} T={WIN_TAU} "
            f"D={H} H={H} per-head x, dx on: "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + f" [{card}]")
    model, _ = win_model_trainer()
    params = model.init(torch.Generator().manual_seed(120), dev)
    for b in (8, 256):
        ctx = windows[:b]
        gen = torch.Generator(device=dev).manual_seed(121)

        def call():
            with torch.no_grad():
                return model.generate(params, ctx, gen, 20)

        counts = {}
        wall, by_kernel = profile_ms(call, 10, counts)
        ms = time_ms(call, 20)
        row = {"ms": ms, "profiled_wall_ms": wall,
               "device_ms": sum(by_kernel.values()),
               "kernels_a_step": sum(counts.values()) / 20}
        out[f"generate_B{b}"] = row
        log(f"time win generate d={WIN_D} H={H} B={b} 20 steps: {ms:.4f} ms "
            f"(CUDA events), device {row['device_ms']:.4f} ms, "
            f"{row['kernels_a_step']:.1f} kernels a step [{card}]")
    return out


def check_cs_steps(dev, errors):
    """Phase 3g: ``latent_reg='cs'`` at lorenz96_crcsrae's shapes on the
    card: one ``make_phase1_step`` with its GMM prior at B=2048 (full
    parents) and one ``make_phase2_step`` with one at B=1024 (a random
    binary mask), each against the same step on the CPU's plain
    recurrences on the same batch and draws: params, prior, best params
    (phase 2: the ErrorVAE's params and Adam's moments too) and metrics
    STEP_TOL; exactly 2 + 2 and 4 + 4 launches on the kernel route."""
    import torch

    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.models import CRVAE, ErrorVAE, init_gmm_prior
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.optim import adam_init
    from vae_connexe_torch.train import (
        Phase1State,
        Phase2State,
        make_phase1_step,
        make_phase2_step,
    )
    from vae_connexe_torch.utils.tree import tree_leaves, tree_map

    exp = get_experiment(CS_NAME)
    p, hid = exp.p, exp.hidden
    g = torch.Generator().manual_seed(61)
    model, err = CRVAE(p, hid), ErrorVAE(p, hid)
    params, eparams = model.init(g, "cpu"), err.init(g, "cpu")
    prior = init_gmm_prior(g, exp.phase1.gmm_components, hid, device="cpu")
    windows = torch.randn((4096, exp.context, p), generator=g)
    mask = (torch.rand((p, p), generator=g) > 0.3).float()
    out = {}
    for phase, cfg, b in (("phase1", exp.phase1, CS_B1),
                          ("phase2", exp.phase2, CS_B2)):
        idx = torch.randint(0, windows.shape[0], (b,), generator=g)
        eps = torch.randn((b, hid), generator=g)
        eps_err = torch.randn((b, hid), generator=g)

        def run(on):
            to = lambda t: t.to(on)    # noqa: E731
            ps, pr = tree_map(to, params), tree_map(to, prior)
            inf = torch.tensor(float("inf"), device=on)
            if phase == "phase1":
                step = make_phase1_step(model, cfg, to(windows),
                                        torch.ones((p, p), device=on))
                state, met = step(
                    Phase1State(params=ps, prior=pr, best_params=ps,
                                best_loss=inf, generator=torch.Generator(),
                                step=0),
                    batch=to(windows[idx]), eps=to(eps))
                trees = (state.params, state.prior, state.best_params)
            else:
                es = tree_map(to, eparams)
                step = make_phase2_step(model, err, cfg, to(windows),
                                        to(mask))
                state, met = step(
                    Phase2State(params=ps, err_params=es,
                                err_opt=adam_init(es), prior=pr,
                                best_params=ps, best_loss=inf,
                                generator=torch.Generator(), step=0),
                    batch=to(windows[idx]), eps=to(eps),
                    eps_err=to(eps_err))
                trees = (state.params, state.prior, state.err_params,
                         state.err_opt.mu, state.err_opt.nu,
                         state.best_params)
            return ([t for tr in trees for t in tree_leaves(tr)],
                    torch.stack(list(met.values())))

        cuda_gru.reset_launches()
        k_leaves, k_met = run(dev)
        torch.cuda.synchronize()
        launches = dict(cuda_gru.LAUNCHES)
        r_leaves, r_met = run(torch.device("cpu"))
        n = 2 if phase == "phase1" else 4
        what = (f"{CS_NAME} {phase} step p={p} H={hid} B={b} "
                f"K={cfg.gmm_components} lambda_cs={cfg.lambda_cs}")
        log(f"check cs_step {what}: launches {launches} ({n} + {n} a step)")
        if launches != {"gru_forward": n, "gru_backward": n,
                        "gru_forward_wide": 0, "gru_backward_wide": 0}:
            raise AssertionError(f"the cs {phase} step took other launches")
        _assert_close("cs_step", _flat(k_leaves).cpu(), _flat(r_leaves),
                      errors, **STEP_TOL, what=what + ": params, prior, "
                      + ("best params" if n == 2 else "ErrorVAE, Adam's "
                         "moments, best params"))
        _assert_close("cs_step", k_met.cpu(), r_met, errors, **STEP_TOL,
                      what=what + ": metrics")
        out[phase] = launches
    return out


def check_vrae_steps(dev, errors):
    """Phase 3h: ``vrae_demo``'s training step (``make_vrae_step``: the GRU
    encoder through B1/B2, the decoder a PyTorch loop of the cell that
    takes the teacher-forcing coins) on the card against the same steps on
    the CPU's plain recurrences: VRAE_CHECK_STEPS epochs at the run's
    schedule, lr and beta from the same parameters and data, with the same
    epsilon and coins (drawn on the CPU, passed in); one B1 and one B2
    launch a step.  After every step, STEP_TOL: the metrics; Adam's
    moments (the gradients so far); the card's parameters against Adam's
    step from its own previous parameters and moments, recomputed on the
    CPU (the update is the same function); and the card's parameters
    against the CPU's, at every element where that comparison is well
    conditioned.  It is not where Adam divides a gradient of the order of
    its eps (1e-8) by itself: there a few per cent of rounding in the
    gradient moves the step by more than STEP_TOL, and the CPU's float32
    step departs that far from the same step in float64 (the witness,
    whose departing elements are excluded and printed)."""
    import torch

    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.configs.experiments import vrae_model
    from vae_connexe_torch.models.vrae import (
        exponential_teacher_forcing_schedule,
    )
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.optim import adam_init
    from vae_connexe_torch.optim.adam import adam_apply
    from vae_connexe_torch.train.vrae_trainer import make_vrae_step
    from vae_connexe_torch.utils.tree import tree_leaves, tree_map

    exp = get_experiment("vrae_demo")
    model = vrae_model(exp)
    lr = 1e-3
    g = torch.Generator().manual_seed(71)
    params = model.init(g, "cpu")
    data = torch.randn((32, exp.t, exp.p), generator=g)
    draws = [(exponential_teacher_forcing_schedule(e, decay_rate=0.02),
              torch.randn((data.shape[0], exp.latent), generator=g),
              torch.rand((exp.t,), generator=g))
             for e in range(VRAE_CHECK_STEPS)]

    def run(on, dtype=torch.float32):
        """(previous params, params, Adam's state, metrics) of each step,
        on the CPU."""
        to = lambda t: t.to(on, dtype)    # noqa: E731
        cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)   # noqa: E731
        step = make_vrae_step(model, to(data), lr, 0.5)
        ps = tree_map(to, params)
        state, trail = adam_init(ps), []
        for tf, eps, coins in draws:
            new, state, met = step(ps, state, tf, to(eps), to(coins))
            trail.append((cpu(ps), cpu(new), cpu(state), torch.stack(
                [met[k] for k in ("total", "rec", "kld")]).cpu()))
            ps = new
        return trail

    cuda_gru.reset_launches()
    card = run(dev)
    torch.cuda.synchronize()
    launches = dict(cuda_gru.LAUNCHES)
    ref, exact = run(torch.device("cpu")), run(torch.device("cpu"),
                                               torch.float64)
    n = VRAE_CHECK_STEPS
    log(f"check vrae_step vrae_demo (B=32, T={exp.t}, D={exp.p}, "
        f"H={exp.hidden}, Z={exp.latent}), {n} steps: launches {launches} "
        f"(1 + 1 a step); losses card "
        f"{[round(float(k[3][0]), 4) for k in card]} cpu "
        f"{[round(float(r[3][0]), 4) for r in ref]}")
    if launches != {"gru_forward": n, "gru_backward": n,
                    "gru_forward_wide": 0, "gru_backward_wide": 0}:
        raise AssertionError("the vrae step took other launches")

    def moments(state):
        return _flat([*tree_leaves(state.mu), *tree_leaves(state.nu)])

    for i, (k, r, x) in enumerate(zip(card, ref, exact)):
        what = f"vrae_demo step {i + 1} of {n} (tf_ratio {draws[i][0]:.4f})"
        _assert_close("vrae_step", k[3], r[3], errors, **STEP_TOL,
                      what=what + ": metrics")
        _assert_close("vrae_step", moments(k[2]), moments(r[2]), errors,
                      **STEP_TOL, what=what + ": Adam's moments")
        _assert_close("vrae_step", _flat(tree_leaves(k[1])),
                      _flat(tree_leaves(adam_apply(k[0], k[2], lr))), errors,
                      **STEP_TOL, what=what + ": params against Adam's step "
                      "from the card's own moments")
        got, want = _flat(tree_leaves(k[1])), _flat(tree_leaves(r[1]))
        wit = _flat(tree_leaves(x[1])).float()
        bound = STEP_TOL["atol"] + STEP_TOL["rtol"] * want.abs()
        ill = (want - wit).abs() > bound
        grad = _flat(tree_leaves(r[2].mu)).abs() / 0.1 if i == 0 else None
        log(f"check vrae_step {what}: {int(ill.sum())} of {ill.numel()} "
            f"params ill-conditioned (the CPU's float32 step departs from "
            f"float64 beyond STEP_TOL: at most "
            f"{float(((want - wit).abs() / bound).max()):.3f} x)"
            + (f", their first-step |gradient| "
               f"{[f'{v:.2e}' for v in grad[ill].tolist()]}"
               if grad is not None else "")
            + f"; card vs cpu there {(got - want).abs()[ill].tolist()}")
        _assert_close("vrae_step", got[~ill], want[~ill], errors, **STEP_TOL,
                      what=what + ": params where well conditioned")
    return launches


def crcsrae_main_path(dev, card, out_dir):
    """Phase 4n: lorenz96_crcsrae through ``run_experiment`` (the function
    ``cli run`` calls) with checkpoints, phase 1 at its full 2000 steps,
    phase 2 cut to RUN_STEPS: exactly 2 + 2 launches a phase-1 step and
    4 + 4 a phase-2 step (read at each chunk's log line), K1 and K2 twice
    on the resident route; the phase-1 AUROC against the JAX package's
    committed one less A4_MARGIN; the mask frozen; phase-2 losses falling;
    then ``cli eval`` of its ``ckpt_phase1``."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.configs import get_experiment, run_experiment
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.utils import restore_checkpoint

    exp = get_experiment(CS_NAME)
    n1, n2 = exp.phase1.max_iter, RUN_STEPS
    out = os.path.join(out_dir, CS_NAME)
    tap = _ChunkTap()
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tap):
        res = run_experiment(
            CS_NAME, out_dir=out, save_checkpoints=True, device=dev,
            overrides={"phase2": dataclasses.replace(exp.phase2,
                                                     max_iter=n2)})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total, rollouts = dict(cuda_gru.LAUNCHES), dict(cr.ROUTE_LAUNCHES)
    per1 = [c for ph, _, c in tap.snaps if ph == "phase1"][-1]
    end2 = [c for ph, _, c in tap.snaps if ph == "phase2"][-1]
    per2 = {k: end2[k] - per1[k] for k in total}
    log(f"main path run_experiment {CS_NAME} p={exp.p} H={exp.hidden} "
        f"B={CS_B1}/{CS_B2} {n1} + {n2} steps in {secs:.3f} s: launches "
        f"phase 1 {per1}, phase 2 {per2}, whole run {total}, rollouts by "
        f"route {rollouts} [{card}]")
    want1 = {"gru_forward": 2 * n1, "gru_backward": 2 * n1,
             "gru_forward_wide": 0, "gru_backward_wide": 0}
    want2 = {**want1, "gru_forward": 4 * n2, "gru_backward": 4 * n2}
    assert per1 == want1, (per1, want1)
    assert per2 == want2, (per2, want2)
    assert total == {**want1, "gru_forward": 2 * n1 + 4 * n2 + 1,
                     "gru_backward": 2 * n1 + 4 * n2}, total
    assert rollouts == route_counts(
        crvae_free_run_resident=2, errvae_sample_resident=2), rollouts

    ref = json.load(open(os.path.join(
        ROOT, "results", CS_NAME, f"metrics_{CS_NAME}.json")))
    gc, gate = res["gc"], JAX_CS_AUROC - A4_MARGIN
    log(f"graph recovery {CS_NAME} {n1} steps: auroc={gc['auroc']:.4f} "
        f"f1={gc['f1']:.4f} auroc_offdiag={gc['auroc_offdiag']:.4f}; phase 1 "
        f"recon {res['phase1']['recon']:.4f} latent_reg "
        f"{res['phase1']['latent_reg']:.4f}; gate auroc >= {gate:.4f}; the "
        f"JAX package's committed full run: auroc {ref['gc']['auroc']:.4f} "
        f"f1 {ref['gc']['f1']:.4f}, phase 1 recon "
        f"{ref['phase1']['recon']:.4f} latent_reg "
        f"{ref['phase1']['latent_reg']:.4f} [{card}]")
    assert gc["auroc"] >= gate, gc

    mask = np.load(os.path.join(out, f"GC_{CS_NAME}.npy"))
    g = torch.Generator().manual_seed(0)
    model, err = CRVAE(exp.p, exp.hidden), ErrorVAE(exp.p, exp.hidden)
    ck = restore_checkpoint(os.path.join(out, "ckpt_phase2"),
                            {"crvae": model.init(g, dev),
                             "error_vae": err.init(g, dev)})
    w_ih = ck["crvae"].heads.w_ih.permute(0, 2, 1)
    frozen = bool((w_ih[torch.tensor(mask == 0, device=dev)] == 0).all())
    rows = [json.loads(line) for line in
            open(os.path.join(out, f"train_log_{CS_NAME}.jsonl"))]
    p2 = [r for r in rows if r["phase"] == "phase2"]
    first, last = p2[0], p2[-1]
    log(f"{CS_NAME} phase 2 under the phase-1 mask ({int(mask.sum())} of "
        f"{mask.size} edges): columns off the mask all zero: {frozen}; "
        f"chunk at step {first['step']} -> {last['step']}: recon "
        f"{first['recon']:.5f} -> {last['recon']:.5f}, latent_reg (CS) "
        f"{first['latent_reg']:.5f} -> {last['latent_reg']:.5f}, loss_e "
        f"{first['loss_e']:.5f} -> {last['loss_e']:.5f}; generation "
        + json.dumps({k: res[k] for k in (
            "generated_shape", "generation_moment_gap",
            "generation_moment_gap_conditioned")})
        + "; JAX's committed full run: phase 2 recon "
        f"{ref['phase2']['recon']:.4f} latent_reg "
        f"{ref['phase2']['latent_reg']:.4f}, moment gap "
        + json.dumps(ref["generation_moment_gap"]))
    assert frozen
    for k in ("recon", "loss_e"):
        assert all(math.isfinite(r[k]) for r in p2), k
        assert last[k] < first[k], (k, first[k], last[k])
    assert res["generated_shape"] == [256, 21, exp.p], res["generated_shape"]

    cap = io.StringIO()
    with contextlib.redirect_stdout(cap):
        cli.main(["eval", CS_NAME, os.path.join(out, "ckpt_phase1"),
                  "--generate", "8", "--device", str(dev)])
    ev = json.loads(cap.getvalue())
    log(f"cli eval {CS_NAME} ckpt_phase1: auroc {ev['gc']['auroc']:.4f}, "
        f"generated {ev['generated_shape']}")
    assert abs(ev["gc"]["auroc"] - gc["auroc"]) < 1e-6, (ev["gc"], gc)
    assert ev["generated_shape"] == [8, 21, exp.p]
    return {"phase1": per1, "phase2": per2, "rollouts": rollouts,
            "wall_s": secs, "auroc": gc["auroc"], "f1": gc["f1"],
            "phase1_metrics": res["phase1"], "phase2_metrics": res["phase2"],
            "generation_moment_gap": res["generation_moment_gap"]}


def csrae_main_path(dev, card, out_dir):
    """Phase 4o: ``cli run csrae_binarized`` at its own 30 epochs with
    checkpoints (no recurrence, no kernel launch: the MixtureCSRAE is MLP
    products); recon_accuracy against the JAX package's committed one less
    A4_MARGIN, the loss below its initial value, 64 samples of 200; then
    ``cli eval`` of its ``ckpt_csrae``."""
    import contextlib

    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.ops import cuda_gru

    name = "csrae_binarized"
    out = os.path.join(out_dir, name)
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["run", name, "--out-dir", out, "--save-checkpoints",
                  "--device", str(dev), "--quiet"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = json.load(open(os.path.join(out, f"metrics_{name}.json")))
    gate = JAX_CSRAE_ACC - A4_MARGIN
    log(f"main path cli run {name} ({get_experiment(name).csrae.epochs} "
        f"epochs) in {secs:.3f} s: "
        f"recon_accuracy {res['recon_accuracy']:.4f} (gate {gate:.4f}; JAX "
        f"committed {JAX_CSRAE_ACC}), loss {json.dumps(res['loss'])} from "
        f"initial {json.dumps(res['initial'])}, generated "
        f"{res['generated_shape']}, recurrence launches "
        f"{dict(cuda_gru.LAUNCHES)} [{card}]")
    assert res["recon_accuracy"] >= gate, res["recon_accuracy"]
    assert res["loss"]["total"] < res["initial"]["total"], res
    assert res["generated_shape"] == [64, 200], res["generated_shape"]
    assert not any(cuda_gru.LAUNCHES.values())
    cap = io.StringIO()
    with contextlib.redirect_stdout(cap):
        cli.main(["eval", name, os.path.join(out, "ckpt_csrae"),
                  "--generate", "8", "--device", str(dev)])
    ev = json.loads(cap.getvalue())
    log(f"cli eval {name} ckpt_csrae: recon_accuracy "
        f"{ev['recon_accuracy']:.4f}, generated {ev['generated_shape']}")
    assert ev["generated_shape"] == [8, 200] and ev["recon_accuracy"] > 0.5
    return {"wall_s": secs, "recon_accuracy": res["recon_accuracy"],
            "loss": res["loss"], "initial": res["initial"]}


def vrae_main_path(dev, card, out_dir):
    """Phase 4p: ``cli run vrae_demo`` at its own 100 epochs with
    checkpoints: the GRU encoder one B1 and one B2 launch an epoch (read
    at every tenth epoch's log line), the decoder no launch; the loss at
    the last epoch below the first's; 5 samples of (20, 10); then ``cli
    eval`` of its ``ckpt_vrae``."""
    import contextlib

    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr

    name = "vrae_demo"
    out = os.path.join(out_dir, name)
    tap = _ChunkTap(VRAE_LINE)
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    cr.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tap):
        cli.main(["run", name, "--out-dir", out, "--save-checkpoints",
                  "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, rollouts = dict(cuda_gru.LAUNCHES), dict(cr.LAUNCHES)
    res = json.load(open(os.path.join(out, f"metrics_{name}.json")))
    first = float(re.search(VRAE_LINE, tap.text.getvalue(), re.M).group(3))
    last = res["train"]["total"]
    per_epoch = {e: c for _, e, c in tap.snaps}
    log(f"main path cli run {name} (100 epochs) in {secs:.3f} s: loss "
        f"{first:.4f} at epoch 0 -> {last:.4f} at the last, tf_ratio "
        f"{res['train']['tf_ratio']:.4f}, generated {res['generated_shape']}"
        f", launches {launches}, at the logged epochs "
        f"{ {e: (c['gru_forward'], c['gru_backward']) for e, c in per_epoch.items()} }, "
        f"rollouts {rollouts} [{card}]")
    for e, c in per_epoch.items():
        assert c["gru_forward"] == c["gru_backward"] == e + 1, (e, c)
    assert launches == {"gru_forward": 100, "gru_backward": 100,
                        "gru_forward_wide": 0, "gru_backward_wide": 0}
    assert math.isfinite(last) and last < first, (first, last)
    assert res["generated_shape"] == [5, 20, 10], res["generated_shape"]
    cap = io.StringIO()
    cuda_gru.reset_launches()
    with contextlib.redirect_stdout(cap):
        cli.main(["eval", name, os.path.join(out, "ckpt_vrae"), "--generate",
                  "5", "--device", str(dev)])
    ev = json.loads(cap.getvalue())
    log(f"cli eval {name} ckpt_vrae: generated {ev['generated_shape']}, "
        f"launches {dict(cuda_gru.LAUNCHES)} (sampling decodes only)")
    assert ev["generated_shape"] == [5, 20, 10]
    return {"launches": launches, "rollouts": rollouts, "wall_s": secs,
            "loss_first": first, "loss_last": last}


def debug_nans_main_path(dev, card):
    """Phase 4q: ``cli run lorenz96_crvae --iters 20 --no-phase2
    --debug-nans`` on the card completes; then, still under nan debugging,
    a phase-1 fit on windows holding a NaN raises ``FloatingPointError``
    naming its first step."""
    import contextlib

    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.train import Phase1Config, fit_phase1
    from vae_connexe_torch.utils import enable_nan_debugging, nan_debugging

    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["run", "lorenz96_crvae", "--iters", "20", "--no-phase2",
                      "--device", str(dev), "--quiet", "--debug-nans"])
        on = torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    secs = time.perf_counter() - t0
    windows = lorenz_windows(dev, CRVAE_P, seed=5)[:512].clone()
    windows[:, CTX - 2, 3] = float("nan")
    model = CRVAE(CRVAE_P, H, ENC)
    params = model.init(torch.Generator().manual_seed(3), dev)
    raised = None
    with nan_debugging():
        try:
            fit_phase1(model, params, windows,
                       torch.ones((CRVAE_P, CRVAE_P), device=dev),
                       Phase1Config(max_iter=3, batch_size=TRAIN_B),
                       torch.Generator(device=dev).manual_seed(4))
        except FloatingPointError as e:
            raised = str(e)
    log(f"debug-nans: cli run lorenz96_crvae --iters 20 --no-phase2 "
        f"--debug-nans completed in {secs:.3f} s (anomaly mode on: {on}); a "
        f"fit on windows holding a NaN raised FloatingPointError: "
        f"{raised!r} [{card}]")
    assert on and raised is not None and raised.startswith("phase1 step 1")
    assert not torch.is_anomaly_enabled()


def time_a4(dev, card, windows10):
    """Phase 5g: lorenz96_crcsrae's phase-1 (B=2048) and phase-2 (B=1024)
    steps/s through its fits with the GMM prior beside the same fits on KL
    (two runs each, in turns, host clock), a step of each under the
    profiler (busy share); ``fit_csrae``'s epochs/s at csrae_binarized's
    shapes; ``fit_vrae``'s steps (epochs)/s at vrae_demo's."""
    import torch

    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.configs.experiments import (
        make_csrae_inputs,
        vrae_model,
    )
    from vae_connexe_torch.data import lorenz96
    from vae_connexe_torch.models import CRVAE, ErrorVAE, init_gmm_prior
    from vae_connexe_torch.optim import adam_init
    from vae_connexe_torch.train import (
        Phase1State,
        Phase2State,
        fit_csrae,
        fit_phase1,
        fit_phase2,
        fit_vrae,
        make_phase1_step,
        make_phase2_step,
    )

    exp = get_experiment(CS_NAME)
    g = torch.Generator().manual_seed(71)
    model, err = CRVAE(exp.p, exp.hidden), ErrorVAE(exp.p, exp.hidden)
    params, eparams = model.init(g, dev), err.init(g, dev)
    ones = torch.ones((exp.p, exp.p), device=dev)
    out = {}
    for phase, cfg0 in (("phase1", exp.phase1), ("phase2", exp.phase2)):
        rates, shares = {}, {}
        for reg in ("cs", "kl", "cs", "kl"):
            cfg = dataclasses.replace(cfg0, max_iter=RATE_STEPS,
                                      latent_reg=reg)
            gen = torch.Generator(device=dev).manual_seed(72)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if phase == "phase1":
                fit_phase1(model, params, windows10, ones, cfg, gen)
            else:
                fit_phase2(model, err, params, eparams, windows10, ones, cfg,
                           gen)
            torch.cuda.synchronize()
            rates.setdefault(reg, []).append(
                RATE_STEPS / (time.perf_counter() - t0))
        for reg in ("cs", "kl"):
            cfg = dataclasses.replace(cfg0, latent_reg=reg)
            gen = torch.Generator(device=dev).manual_seed(73)
            prior = (init_gmm_prior(gen, cfg.gmm_components, exp.hidden,
                                    device=dev) if reg == "cs" else None)
            inf = torch.tensor(float("inf"), device=dev)
            if phase == "phase1":
                step = make_phase1_step(model, cfg, windows10, ones)
                state = [Phase1State(params=params, prior=prior,
                                     best_params=params, best_loss=inf,
                                     generator=gen, step=0)]
            else:
                step = make_phase2_step(model, err, cfg, windows10, ones)
                state = [Phase2State(params=params, err_params=eparams,
                                     err_opt=adam_init(eparams), prior=prior,
                                     best_params=params, best_loss=inf,
                                     generator=gen, step=0)]

            def run():
                state[0] = step(state[0])[0]

            for _ in range(4):
                run()
            wall, by_kernel = profile_ms(run, 20)
            busy = sum(by_kernel.values())
            shares[reg] = {"wall_ms": wall, "device_ms": busy,
                           "busy_share": busy / wall}
        out[phase] = {"steps_s": rates, "profile": shares,
                      "batch": cfg0.batch_size}
        log(f"time {CS_NAME} {phase} steps/s B={cfg0.batch_size} p={exp.p} "
            f"H={exp.hidden}: cs {rates['cs'][0]:.1f}, {rates['cs'][1]:.1f}; "
            f"kl {rates['kl'][0]:.1f}, {rates['kl'][1]:.1f} (two runs each, in "
            f"turns); a step under the profiler: cs wall "
            f"{shares['cs']['wall_ms']:.4f} ms, device "
            f"{shares['cs']['device_ms']:.4f} ms, busy "
            f"{shares['cs']['busy_share']:.3f}; kl wall "
            f"{shares['kl']['wall_ms']:.4f}, device "
            f"{shares['kl']['device_ms']:.4f}, busy "
            f"{shares['kl']['busy_share']:.3f} [{card}]")

    cexp = get_experiment("csrae_binarized")
    series = lorenz96(torch.Generator(device=dev).manual_seed(74), p=cexp.p,
                      t=cexp.t, device=dev)
    x, cmodel = make_csrae_inputs(cexp, series)
    cparams = cmodel.init(torch.Generator().manual_seed(75), dev)
    cfgc = cexp.csrae
    gen = torch.Generator(device=dev).manual_seed(76)
    cparams, _ = fit_csrae(cmodel, cparams, x, gen, epochs=1,
                           batch_size=cfgc.batch_size, lr=cfgc.lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_csrae(cmodel, cparams, x, gen, epochs=CSRAE_RATE_EPOCHS,
              batch_size=cfgc.batch_size, lr=cfgc.lr)
    torch.cuda.synchronize()
    csrae_eps = CSRAE_RATE_EPOCHS / (time.perf_counter() - t0)
    n_batches = x.shape[0] // cfgc.batch_size

    vexp = get_experiment("vrae_demo")
    data = torch.randn((32, vexp.t, vexp.p),
                       generator=torch.Generator(device=dev).manual_seed(77),
                       device=dev)
    vmodel = vrae_model(vexp)
    vparams = vmodel.init(torch.Generator().manual_seed(78), dev)
    gen = torch.Generator(device=dev).manual_seed(79)
    vparams, _ = fit_vrae(vmodel, vparams, data, gen, epochs=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_vrae(vmodel, vparams, data, gen, epochs=VRAE_RATE_EPOCHS)
    torch.cuda.synchronize()
    vrae_sps = VRAE_RATE_EPOCHS / (time.perf_counter() - t0)
    out["fit_csrae"] = {"epochs_s": csrae_eps,
                        "steps_s": csrae_eps * n_batches,
                        "batches_an_epoch": n_batches}
    out["fit_vrae"] = {"steps_s": vrae_sps}
    log(f"time fit_csrae csrae_binarized ({x.shape[0]} rows of "
        f"{x.shape[1]}, batch {cfgc.batch_size}, {n_batches} steps an "
        f"epoch): {csrae_eps:.2f} epochs/s ({csrae_eps * n_batches:.1f} "
        f"steps/s); fit_vrae vrae_demo (32 x {vexp.t} x {vexp.p}, full "
        f"batch): {vrae_sps:.1f} steps/s [{card}]")
    return out


def bf16_in_distribution(got, ref):
    """(ok, (max |got - ref|, largest mean gap, largest std gap, elementwise
    limit)) of a bf16 sample against another under the JAX package's
    bounds (tests/test_serve_dtype.py): elementwise 0.15 * (max |ref| +
    1), each series' mean within 0.02, its std within rtol 0.05 / atol
    0.02."""
    import numpy as np

    lim = 0.15 * (float(np.abs(ref).max()) + 1.0)
    gaps = (float(np.abs(got - ref).max()),
            float(np.abs(got.mean((0, 1)) - ref.mean((0, 1))).max()),
            float(np.abs(got.std((0, 1)) - ref.std((0, 1))).max()), lim)
    ok = (gaps[0] < lim
          and np.allclose(got.mean((0, 1)), ref.mean((0, 1)), atol=0.02)
          and np.allclose(got.std((0, 1)), ref.std((0, 1)), rtol=0.05,
                          atol=0.02))
    return ok, gaps


def bf16_steps(a, b):
    """Per element, the bf16 steps (ulps) between two float32 tensors of
    bf16 values: their bit patterns in the order of the values."""
    import torch

    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def bf16_agreement(got, ref):
    """How a bf16 rollout ``got`` (B, T, D), float32, agrees with its plain
    bf16 version ``ref`` on the same inputs: ``bf16`` every element of
    ``got`` a bf16 value; ``same`` the share of elements equal bit for bit;
    ``worst`` max |got - ref| / (|ref| + 1); ``rows`` the rows (samples)
    that differ anywhere, ``over`` / ``rows_over`` the elements and rows
    beyond BF16_TOL; over the rows that differ, the first step where each
    does (``first_step`` earliest, ``first_median``) and the largest
    |d| / (|ref| + 1) and bf16 steps at that step (``first_worst``,
    ``first_ulps``)."""
    import torch

    got, ref = (torch.as_tensor(t).float().cpu() for t in (got, ref))
    rel = (got - ref).abs() / (ref.abs() + 1.0)
    differ = (got != ref).any(2)                                  # (B, T)
    rows = differ.any(1)
    out = {"bf16": bool(torch.equal(got, got.to(torch.bfloat16).float())),
           "same": float((got == ref).float().mean()),
           "worst": float(rel.max()), "rows": int(rows.sum()),
           "n_rows": got.shape[0],
           "over": int((rel > BF16_TOL).sum()),
           "rows_over": int((rel > BF16_TOL).flatten(1).any(1).sum()),
           "first_step": None, "first_median": None, "first_worst": 0.0,
           "first_ulps": 0}
    if rows.any():
        idx = rows.nonzero()[:, 0]
        first = differ[idx].float().argmax(1)
        at_rel = rel[idx, first].max(1).values
        out.update(first_step=int(first.min()),
                   first_median=float(first.float().median()),
                   first_worst=float(at_rel.max()))
        if out["bf16"] and bool(torch.equal(ref, ref.to(torch.bfloat16)
                                            .float())):
            out["first_ulps"] = int(bf16_steps(got[idx, first],
                                               ref[idx, first]).max())
    return out


def bf16_ok(a) -> bool:
    """Random weights: bf16 values only, BF16_SAME bit for bit, every
    element within BF16_TOL."""
    return a["bf16"] and a["same"] >= BF16_SAME and a["worst"] <= BF16_TOL


def departs_ok(a, witness) -> bool:
    """Random weights at 128 heads, where a flipped bf16 rounding carries
    on through a row's later steps (the share bit for bit then measures
    when each row first departs, and a plain version with exact sums,
    ``witness``, falls below BF16_SAME too): bf16 values only, every
    element within BF16_TOL, a bit-equal share of at least WITNESS_SHARE
    of the witness's, and each row's first departure from the plain
    version by no more bf16 steps than the witness's (at least one)."""
    return (a["bf16"] and a["worst"] <= BF16_TOL
            and a["same"] >= WITNESS_SHARE * witness["same"]
            and a["first_ulps"] <= max(1, witness["first_ulps"]))


def plain_rollouts_exact(g16, x0, h0, h0e, p, noise, scale):
    """K2's and K1's plain bf16 versions with exact sums: the same bf16
    weights, inputs and carries, every product summed and every gate
    computed in float64 before the bf16 rounding; (K2, K1) as float32.  A
    second plain bf16 version that differs from the first only in how its
    sums round."""
    import torch

    from vae_connexe_torch.ops.cuda_rollout import cast_weights
    from vae_connexe_torch.ops.gru import gru_cell, gru_step_heads
    from vae_connexe_torch.utils.layers import dense

    f64 = torch.float64
    heads, readout, dec, out = (cast_weights(w, f64) for w in g16)

    def rnd(t):
        return t.to(torch.bfloat16).to(f64)

    h, x, k2 = rnd(h0e), torch.zeros((h0e.shape[0], p), device=h0e.device,
                                      dtype=f64), []
    for _ in range(T):
        h = rnd(gru_cell(dec, x, h))
        x = rnd(dense(out, h))
        k2.append(x)
    h = rnd(h0).expand(p, *h0.shape)
    x, noise, k1 = rnd(x0), rnd(noise), []
    for t in range(T):
        h = rnd(gru_step_heads(heads, x, h))
        o = torch.einsum("pbh,poh->pbo", h, readout.w) + readout.b[:, None]
        x = rnd(o[..., 0].T + scale * noise[:, t])
        k1.append(x)
    return (torch.stack(k2, 1).float(), torch.stack(k1, 1).float())


def trained_ok(a, witness) -> bool:
    """Trained weights: bf16 values only, BF16_SAME bit for bit, each row
    within BF16_TOL where it first departs from the plain version, and the
    rows beyond BF16_TOL at most twice the ``witness``'s (a plain version
    with exact sums against the same plain version)."""
    return (a["bf16"] and a["same"] >= BF16_SAME
            and a["first_worst"] <= BF16_TOL
            and a["rows_over"] <= 2 * witness["rows_over"])


def agreement_text(a) -> str:
    return (f"bf16 values {a['bf16']}, bit-equal share {a['same']:.5f}, "
            f"max |d| / (|plain| + 1) {a['worst']:.3e}, rows differing "
            f"{a['rows']}/{a['n_rows']}, beyond {BF16_TOL:g}: {a['over']} "
            f"elements in {a['rows_over']} rows, first departure step "
            f"{a['first_step']} (median {a['first_median']}) at "
            f"{a['first_worst']:.3e} / {a['first_ulps']} bf16 steps")


def check_bf16_rollouts(dev, card, errors):
    """Phase 3': K1/K2's bf16 instantiations at BF16_SHAPES against their
    plain bf16 versions (``bf16_ok``, with the float32 kernels on the same
    inputs as the control that must fail it; two calls bitwise equal, the
    route the plan names) and, as compensated generation on the same
    draws, against the float32 kernels within the JAX package's bounds;
    each plan printed for both storage types; times by CUDA events beside
    the float32 kernels' and the bounds.  Returns the rows by shape.

    At lorenz96_xl's width (128 heads) a flipped bf16 rounding carries on
    through a row's later steps as it does for trained weights: where the
    plain version and a plain version with exact sums
    (``plain_rollouts_exact``) share fewer than BF16_SAME of their
    elements bit for bit there, the kernel is held by ``departs_ok``
    against that witness (the controls must fail it too)."""
    import numpy as np
    import torch

    from vae_connexe_torch.ops import cuda_rollout as cr

    bf = torch.bfloat16
    rows = {}
    for p, hidden, b in BF16_SHAPES:
        model, err, params, eparams, g = make_models(p, hidden, 60 + p + b,
                                                     dev)
        f32 = (params.heads, params.readout, eparams.dec, eparams.out)
        g16 = [cr.cast_weights(w, bf) for w in f32]
        h0e = torch.randn((b, hidden), generator=g).to(dev)
        h0 = torch.randn((b, hidden), generator=g).to(dev)
        x0 = torch.zeros((b, p), device=dev)
        for kind, heads in (("crvae", p), ("errvae", 1)):
            for elem in (4, 2):
                log(rollout_plan_line(kind, heads, b, p, hidden, dev, elem))
        routes = {k: cr._plan(k, n, b, p, hidden, dev, 2)[0].route
                  for k, n in (("crvae", p), ("errvae", 1))}

        def noise_of(errs):
            return torch.cat([torch.zeros((b, 1, p), device=dev), errs],
                             dim=1)[:, :T]

        cr.reset_launches()
        k2, k2b = (cr.errvae_sample_fused(g16[2], g16[3], h0e, p, T)
                   for _ in range(2))
        noise = noise_of(k2)
        k1, k1b = (cr.crvae_free_run_fused(g16[0], g16[1], x0, h0, noise,
                                           model.noise_scale)
                   for _ in range(2))
        taken = dict(cr.ROUTE_LAUNCHES)
        r2 = cr.errvae_sample_plain(g16[2], g16[3], h0e, p, T)
        r1 = cr.crvae_free_run_plain(g16[0], g16[1], x0, h0, noise,
                                     model.noise_scale)
        exact = dict(zip(("errvae_sample", "crvae_free_run"),
                         plain_rollouts_exact(g16, x0, h0, h0e, p, noise,
                                              model.noise_scale)))
        # The control: the float32 kernels on the same inputs.
        c2 = cr.errvae_sample_fused(f32[2], f32[3], h0e, p, T)
        c1 = cr.crvae_free_run_fused(f32[0], f32[1], x0, h0, noise,
                                     model.noise_scale)
        ref = cr.crvae_free_run_fused(
            f32[0], f32[1], x0, h0,
            noise_of(cr.errvae_sample_fused(f32[2], f32[3], h0e, p, T)),
            model.noise_scale)
        torch.cuda.synchronize()
        shares = {}
        for name, k, again, r, c, kind in (
                ("errvae_sample", k2, k2b, r2, c2, "errvae"),
                ("crvae_free_run", k1, k1b, r1, c1, "crvae")):
            e = (k - r).abs().max().item()
            agree = bf16_agreement(k, r)
            shares[kind] = agree["same"]
            control = bf16_agreement(c, r)
            rounded = bf16_agreement(c.to(torch.bfloat16).float(), r)
            witness = bf16_agreement(exact[name], r)
            chaotic = p == XL_P and witness["same"] < BF16_SAME
            holds = ((lambda x: departs_ok(x, witness)) if chaotic
                     else bf16_ok)
            same = torch.equal(k, again)
            on_route = taken[f"{name}_bf16_{routes[kind]}"] == 2
            # The control fails, as it is and rounded once at the output.
            told_apart = not holds(control) and not holds(rounded)
            ok = (bool(torch.isfinite(k).all()) and holds(agree)
                  and told_apart and same and on_route)
            key = f"{name}_bf16" + ("_streamed" if routes[kind] == "streamed"
                                    else "")
            errors[key] = max(errors.get(key, 0.0), e)
            need = (f"bf16 values, max <= {BF16_TOL:g}, share >= "
                    f"{WITNESS_SHARE * witness['same']:.5f}, first departure "
                    f"<= {max(1, witness['first_ulps'])} bf16 steps"
                    if chaotic else f"bf16 values, share >= {BF16_SAME}, "
                    f"max <= {BF16_TOL:g}")
            log(f"check {name} bf16 {routes[kind]} p={p} H={hidden} B={b} "
                f"T={T}: max_abs_err={e:.3e}, {agreement_text(agree)} "
                f"(need {need}; "
                f"a plain version with exact sums: share "
                f"{witness['same']:.5f}, first departure "
                f"{witness['first_ulps']} bf16 steps); control float32 "
                f"kernel: bf16 values "
                f"{control['bf16']}, share {control['same']:.5f}, max "
                f"{control['worst']:.3e}; rounded to bf16 at the output: "
                f"share {rounded['same']:.5f}, max {rounded['worst']:.3e}, "
                f"told apart: {told_apart}; two calls bitwise equal: {same}, "
                f"route launches ok: {on_route} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} bf16 disagrees with its plain "
                                     "bf16 version, the check does not tell "
                                     "it from float32, it is not "
                                     "deterministic or took another route")
        dist_ok, gaps = bf16_in_distribution(k1.cpu().numpy(),
                                             ref.cpu().numpy())
        log(f"check bf16 against float32 generation p={p} H={hidden} B={b}: "
            f"max |bf16 - f32| {gaps[0]:.4e} (limit {gaps[3]:.4f}), largest "
            f"mean gap {gaps[1]:.4e} (atol 0.02), std gap {gaps[2]:.4e} "
            f"(rtol 0.05, atol 0.02) {'ok' if dist_ok else 'FAIL'}")
        if not dist_ok:
            raise AssertionError("bf16 generation is off the float32 one")
        iters = 200 if b == 1 else 20
        k1a = (x0, h0, noise, model.noise_scale)
        row = {"route_k1": routes["crvae"], "route_k2": routes["errvae"],
               "k1_share": shares["crvae"], "k2_share": shares["errvae"],
               "plan_k1": cr._plan("crvae", p, b, p, hidden, dev,
                                   2)[0]._asdict(),
               "plan_k2": cr._plan("errvae", 1, b, p, hidden, dev,
                                   2)[0]._asdict()}
        for name, fn in (
                ("k1", lambda: cr.crvae_free_run_fused(*g16[:2], *k1a)),
                ("k1_plain", lambda: cr.crvae_free_run_plain(*g16[:2], *k1a)),
                ("k1_f32", lambda: cr.crvae_free_run_fused(*f32[:2], *k1a)),
                ("k2", lambda: cr.errvae_sample_fused(*g16[2:], h0e, p, T)),
                ("k2_plain",
                 lambda: cr.errvae_sample_plain(*g16[2:], h0e, p, T)),
                ("k2_f32", lambda: cr.errvae_sample_fused(*f32[2:], h0e, p,
                                                          T))):
            row[f"{name}_ms"] = time_ms(fn, iters)
        row["k1_bound_ms"], row["k1_bound_by"] = bound(
            *rollout_cost(b, T, p, hidden, p, 1, True, True, 2), BF16_FLOPS)
        row["k2_bound_ms"], row["k2_bound_by"] = bound(
            *rollout_cost(b, T, 1, hidden, p, p, False, False, 2), BF16_FLOPS)
        plan = {k: row[f"plan_{k}"] for k in ("k1", "k2")}
        log(f"time bf16 p={p} H={hidden} B={b}: K1 ({routes['crvae']}, "
            f"cluster {plan['k1']['cluster']}, tile {plan['k1']['bt']}, "
            f"smem {plan['k1']['smem']}) {row['k1_ms']:.4f} ms (float32 "
            f"{row['k1_f32_ms']:.4f}, plain bf16 {row['k1_plain_ms']:.4f}, "
            f"bound {row['k1_bound_ms']:.4f} by {row['k1_bound_by']}, "
            f"bit-equal share {row['k1_share']:.5f}); K2 "
            f"({routes['errvae']}, tile {plan['k2']['bt']}, smem "
            f"{plan['k2']['smem']}) {row['k2_ms']:.4f} ms (float32 "
            f"{row['k2_f32_ms']:.4f}, plain bf16 {row['k2_plain_ms']:.4f}, "
            f"bound {row['k2_bound_ms']:.4f} by {row['k2_bound_by']}, "
            f"bit-equal share {row['k2_share']:.5f}) [{card}]")
        rows[(p, b)] = row
    return rows


_FRESH_LOAD = r"""
import json, sys, time
import numpy as np
import torch
from vae_connexe_torch.serving import load_generator
res = {}
for path, seed, ctx in json.loads(sys.argv[1]):
    fn, meta = load_generator(path)
    out = fn(seed) if ctx is None else fn(seed, np.load(ctx))
    np.save(path + ".npy", out)
    t0 = time.perf_counter()
    for _ in range(5):
        fn(seed) if ctx is None else fn(seed, np.load(ctx))
    res[path] = {"serve_dtype": meta["serve_dtype"],
                 "fn_ms": (time.perf_counter() - t0) / 5 * 1e3}
res["modules"] = sorted(m for m in sys.modules if m.startswith((
    "vae_connexe_torch.models", "vae_connexe_torch.train",
    "vae_connexe_torch.configs", "jax", "vae_connexe_tpu")))
print(json.dumps(res))
"""


def load_in_fresh_process(calls) -> dict:
    """Load each artifact of ``calls`` [(path, seed, context .npy path or
    None)] in a new Python process that imports only the loader, sample
    fn(seed) into ``path + ".npy"``; returns the process's report: each
    artifact's serve_dtype and fn(seed) host ms, and the model, trainer,
    config or JAX modules it imported (none expected)."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", _FRESH_LOAD,
                          json.dumps(calls)], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(f"loading in a fresh process failed:\n"
                             f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def out_of_core_main_path(dev, card, out_dir):
    """Phase 4m: ``cli run lorenz96_crvae`` (p=10, H=64, B=256) at
    OOC_STEPS steps a phase in memory and with ``--out-of-core`` (its series
    written to a file and memory-mapped by the native loader): results,
    both checkpoints and launch counts equal bit for bit; then a streamed
    phase 1 from that file killed at half and resumed, bitwise the
    uninterrupted streamed fit and the in-memory ``fit_phase1``.  Returns
    the streamed run's launches and the readings."""
    import contextlib

    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.data import arrange_input
    from vae_connexe_torch.data.native_loader import NativeWindowLoader
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.train import (
        Phase1Config,
        fit_phase1,
        fit_phase1_streaming,
    )
    from vae_connexe_torch.utils import restore_checkpoint
    from vae_connexe_torch.utils.tree import tree_leaves

    name, n = "lorenz96_crvae", OOC_STEPS
    runs = {}
    for mode in ("memory", "out_of_core"):
        d = os.path.join(out_dir, f"ooc_{mode}")
        buf = io.StringIO()
        torch.cuda.synchronize()
        cuda_gru.reset_launches()
        cr.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["run", name, "--iters", str(n), "--out-dir", d,
                      "--save-checkpoints", "--quiet", "--device", str(dev)]
                     + (["--out-of-core"] if mode == "out_of_core" else []))
        torch.cuda.synchronize()
        g = torch.Generator().manual_seed(0)
        model, err = CRVAE(CRVAE_P, H), ErrorVAE(CRVAE_P, H)
        ck2 = restore_checkpoint(os.path.join(d, "ckpt_phase2"),
                                 {"crvae": model.init(g, dev),
                                  "error_vae": err.init(g, dev)})
        ck1 = restore_checkpoint(os.path.join(d, "ckpt_phase1"),
                                 model.init(g, dev))
        runs[mode] = {"dir": d, "wall_s": time.perf_counter() - t0,
                      "results": json.loads(buf.getvalue()),
                      "leaves": (tree_leaves(ck1)
                                 + tree_leaves(ck2["crvae"])
                                 + tree_leaves(ck2["error_vae"])),
                      "launches": dict(cuda_gru.LAUNCHES),
                      "rollouts": dict(cr.LAUNCHES)}
    mem, ooc = runs["memory"], runs["out_of_core"]
    same = (mem["results"] == ooc["results"]
            and all(torch.equal(u, v) for u, v in zip(mem["leaves"],
                                                      ooc["leaves"]))
            and mem["launches"] == ooc["launches"]
            and mem["rollouts"] == ooc["rollouts"])
    want = {"gru_forward": 6 * n + 1, "gru_backward": 6 * n,
            "gru_forward_wide": 0, "gru_backward_wide": 0}
    log(f"main path cli run {name} --out-of-core p={CRVAE_P} H={H} "
        f"B={TRAIN_B} {n} + {n} steps: {ooc['wall_s']:.2f} s (in memory "
        f"{mem['wall_s']:.2f} s); launches {ooc['launches']}, rollouts "
        f"{ooc['rollouts']}; results, both checkpoints and launches bitwise "
        f"equal to the in-memory run: {same}; auroc "
        f"{ooc['results']['gc']['auroc']:.4f} [{card}]")
    assert same, "the out-of-core run differs from the in-memory run"
    assert ooc["launches"] == want, ooc["launches"]

    class Kill(Exception):
        pass

    def kill(step, state, metrics):
        if step >= n // 2:
            raise Kill

    series = np.fromfile(os.path.join(ooc["dir"], f"series_{name}.f32"),
                         np.float32).reshape(-1, CRVAE_P)
    cfg = Phase1Config(max_iter=n, check_every=n // 6, batch_size=TRAIN_B,
                       lam=0.1, lr=5e-2, beta=0.1)
    g = torch.Generator().manual_seed(40)
    model = CRVAE(CRVAE_P, H)
    params = model.init(g, dev)
    full = torch.ones((CRVAE_P, CRVAE_P), device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(41)

    ck = os.path.join(out_dir, "ooc_resume")
    with NativeWindowLoader.from_file(
            os.path.join(ooc["dir"], f"series_{name}.f32"),
            *series.shape) as loader:
        cuda_gru.reset_launches()
        stats = {}
        whole = fit_phase1_streaming(model, params, loader, CTX, full, cfg,
                                     gen(), io_stats=stats)
        streamed_launches = dict(cuda_gru.LAUNCHES)
        try:
            fit_phase1_streaming(model, params, loader, CTX, full, cfg, gen(),
                                 checkpoint_dir=ck, checkpoint_every=n // 2,
                                 callback=kill)
            raise AssertionError("the kill did not fire")
        except Kill:
            pass
        resumed = fit_phase1_streaming(model, params, loader, CTX, full, cfg,
                                       gen(), checkpoint_dir=ck,
                                       checkpoint_every=n // 2, resume=True)
    windows, _ = arrange_input(torch.from_numpy(series).to(dev), CTX)
    memory = fit_phase1(model, params, windows, full, cfg, gen())
    torch.cuda.synchronize()

    def equal(a, b):
        return (all(torch.equal(u, v) for u, v in
                    zip(tree_leaves(a[0]) + tree_leaves(a[1].params),
                        tree_leaves(b[0]) + tree_leaves(b[1].params)))
                and a[2] == b[2])

    ok = equal(whole, resumed) and equal(whole, memory)
    log(f"streamed fit_phase1 p={CRVAE_P} H={H} B={TRAIN_B} {n} steps from "
        f"the series file: launches {streamed_launches}, io_stats {stats}; "
        f"killed at {n // 2} and resumed: bitwise equal to the uninterrupted "
        f"streamed fit and to the in-memory fit_phase1: {ok} [{card}]")
    assert ok, "the resumed streamed phase 1 differs"
    assert streamed_launches == {"gru_forward": 2 * n, "gru_backward": 2 * n,
                                 "gru_forward_wide": 0,
                                 "gru_backward_wide": 0}, streamed_launches
    return {"launches": ooc["launches"], "streamed_launches":
            streamed_launches, "wall_s": ooc["wall_s"],
            "memory_wall_s": mem["wall_s"], "io_stats": stats}


def time_out_of_core(dev, card, out_dir, windows20):
    """Phase 5g: a streamed phase-1 fit at p=20 (H=64, B=256, ctx 20) from
    a series file of OOC_ROWS steps (a Lorenz-96 simulation of OOC_SIM
    steps made on the card, tiled; 800 MB, read warm: the file was just
    written) against ``fit_phase1`` on in-memory windows at the same
    shapes, OOC_RATE_STEPS steps each, in turns (memory, file, file,
    memory): steps/s on the host clock and the streamed fit's
    ``gather_wait_s``.  Returns the readings."""
    import numpy as np
    import torch

    from vae_connexe_torch.data import lorenz96
    from vae_connexe_torch.data.native_loader import NativeWindowLoader
    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.train import (
        Phase1Config,
        fit_phase1,
        fit_phase1_streaming,
    )

    sim = lorenz96(torch.Generator(device=dev).manual_seed(50), p=P,
                   t=OOC_SIM, device=dev).cpu().numpy().astype(np.float32)
    path = os.path.join(out_dir, "ooc_series.f32")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(OOC_ROWS // OOC_SIM):
            sim.tofile(f)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    windows_bytes = (OOC_ROWS - CTX) * CTX * P * 4
    model = CRVAE(P, H)
    params = model.init(torch.Generator().manual_seed(51), dev)
    full = torch.ones((P, P), device=dev)
    cfg = Phase1Config(max_iter=OOC_RATE_STEPS, check_every=100,
                       batch_size=TRAIN_B, lam=0.1, lr=5e-2, beta=0.1)
    rates = {"memory": [], "file": []}
    waits = []
    with NativeWindowLoader.from_file(path, OOC_ROWS, P) as loader:
        for mode in ("memory", "file", "file", "memory"):
            gen = torch.Generator(device=dev).manual_seed(52)
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "memory":
                fit_phase1(model, params, windows20, full, cfg, gen)
            else:
                fit_phase1_streaming(model, params, loader, CTX, full, cfg,
                                     gen, io_stats=stats)
                waits.append(stats["gather_wait_s"])
            torch.cuda.synchronize()
            rates[mode].append(OOC_RATE_STEPS / (time.perf_counter() - t0))
    os.unlink(path)
    log(f"time out of core p={P} H={H} B={TRAIN_B} ctx={CTX}: series file "
        f"{size} bytes ({OOC_ROWS} steps, written in {write_s:.2f} s, read "
        f"warm; its windows would take {windows_bytes} bytes), streamed "
        f"fit_phase1 {', '.join(f'{r:.1f}' for r in rates['file'])} steps/s "
        f"(gather_wait_s {', '.join(f'{w:.4f}' for w in waits)}) against "
        f"the in-memory fit_phase1 "
        f"{', '.join(f'{r:.1f}' for r in rates['memory'])} steps/s "
        f"({OOC_RATE_STEPS} steps each, in turns) [{card}]")
    return {"file_bytes": size, "windows_bytes": windows_bytes,
            "streamed_steps_s": rates["file"],
            "memory_steps_s": rates["memory"], "gather_wait_s": waits}


def cr_plan(kind, p, hidden, dev) -> dict:
    """The plan (at B=3072) of a rollout as a dict for the JSON line."""
    from vae_connexe_torch.ops import cuda_rollout as cr

    heads = p if kind == "crvae" else 1
    plan, launch = cr._plan(kind, heads, SERVE_B, p, hidden, dev)
    if plan.route == "streamed":
        return {**plan._asdict(), "kernels_a_call": T}
    return {**plan._asdict(), "n_clusters": launch}


# Meshes on the card (check_meshes): one H100, so a world of one over NCCL
# and two ranks sharing the card over gloo with CUDA tensors.
MESH_STEPS, MESH_SP_STEPS, MESH_XL_STEPS, MESH_RUN_STEPS = 100, 50, 30, 300
LH_P, LH_CTX, LH_B, LH_T = 10, 128, 128, 4096     # lorenz96_longhorizon
XL_B, XL_CTX, XL_T = 64, 40, 8192          # lorenz96_xl (XL_P, XL_H above)
MESH_TOL = dict(rtol=2e-5, atol=1e-6)   # tests/test_meshed_fit.py:36-55
MESH_LOSS_RTOL = 1e-4
MESH_RANK_TIMEOUT = 420
MESH_WARM_STEPS = 5       # untimed steps before each timed fit


def _close(got, want, tol=MESH_TOL) -> float:
    """Max |got - want| over two lists of tensors; raises beyond ``tol``."""
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        torch.testing.assert_close(a, b, **tol)
        worst = max(worst, float((a - b).abs().max()))
    return worst


def _mesh_fit(model, params, windows, cfg, seed, mesh, dev,
              warm: bool = False):
    """fit_phase1 from ``params`` on ``windows`` with a card generator
    seeded ``seed``: (best params, metrics, seconds, B1/B2 launches).
    ``warm``: first an untimed MESH_WARM_STEPS-step fit (the kernels'
    plans, the group's first collectives)."""
    import torch

    from vae_connexe_torch.ops import cuda_gru
    from vae_connexe_torch.train import fit_phase1

    ones = torch.ones((model.p, model.p), device=dev)
    if warm:
        fit_phase1(model, params, windows, ones,
                   dataclasses.replace(cfg, max_iter=MESH_WARM_STEPS,
                                       check_every=MESH_WARM_STEPS),
                   torch.Generator(device=dev).manual_seed(seed), mesh=mesh)
    torch.cuda.synchronize()
    cuda_gru.reset_launches()
    t0 = time.perf_counter()
    best, _, met = fit_phase1(model, params, windows, ones, cfg,
                              torch.Generator(device=dev).manual_seed(seed),
                              mesh=mesh)
    torch.cuda.synchronize()
    return best, met, time.perf_counter() - t0, dict(cuda_gru.LAUNCHES)


def _mesh_rank_main(payload) -> None:
    """One of two ranks sharing the card (``chip_smoke.py --mesh-rank``):
    the dp, sp and ep fits and sharded serving, each meshed run beside
    the single-process run on rank 0; rank 0 writes the results."""
    import torch
    import torch.distributed as dist

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_rollout
    from vae_connexe_torch.parallel import collectives as coll
    from vae_connexe_torch.parallel.mesh import (
        init_world,
        make_mesh,
        shutdown,
        world_info,
    )
    from vae_connexe_torch.parallel.serve import make_sharded_generator
    from vae_connexe_torch.train import Phase1Config
    from vae_connexe_torch.train import generate_with_compensation as gwc
    from vae_connexe_torch.utils.tree import tree_leaves

    rank = payload["rank"]
    dev = init_world(None, init_method=payload["init"], world_size=2,
                     rank=rank, local_rank=rank, local_world=2,
                     timeout=MESH_RANK_TIMEOUT)
    torch.backends.cuda.matmul.allow_tf32 = False
    coll.reset_staged()
    res = {"world": world_info()}

    def both(name, fn):
        got = [None, None]
        dist.all_gather_object(got, fn())
        res[name] = got

    def staged():
        return {"calls": dict(coll.STAGED),
                "mb": {k: v / 1e6 for k, v in coll.STAGED_BYTES.items()},
                "s": dict(coll.STAGED_S)}

    def fit_case(name, model, windows, cfg, mesh, seed):
        params = model.init(torch.Generator().manual_seed(seed), dev)
        if rank == 0:
            _mesh_fit(model, params, windows, cfg, seed + 1, None, dev,
                      warm=True)
        coll.reset_staged()
        best, met, secs, launches = _mesh_fit(model, params, windows, cfg,
                                              seed + 1, mesh, dev, warm=True)
        row = {"launches": launches, "mesh_s": secs,
               "mesh_steps_s": cfg.max_iter / secs, "loss": met["loss"],
               "staged": staged()}
        if rank == 0:
            one, met1, secs1, _ = _mesh_fit(model, params, windows, cfg,
                                            seed + 1, None, dev)
            row.update(max_abs_err=_close(tree_leaves(best),
                                          tree_leaves(one)),
                       single_s=secs1, single_steps_s=cfg.max_iter / secs1,
                       single_loss=met1["loss"])
            assert math.isclose(met["loss"], met1["loss"],
                                rel_tol=MESH_LOSS_RTOL), (met, met1)
        both(name, lambda: row)

    fit_case("dp2", CRVAE(P, H, ENC), lorenz_windows(dev, P, seed=31),
             Phase1Config(max_iter=MESH_STEPS, check_every=25,
                          batch_size=TRAIN_B), make_mesh(n_dp=2), 32)
    fit_case("sp2", CRVAE(LH_P, H),
             lorenz_windows(dev, LH_P, seed=33, ctx=LH_CTX, t=LH_T),
             Phase1Config(max_iter=MESH_SP_STEPS, check_every=25,
                          batch_size=LH_B),
             make_mesh(n_dp=1, n_ep=1, n_sp=2), 34)
    fit_case("xl_ep2", CRVAE(XL_P, XL_H),
             lorenz_windows(dev, XL_P, seed=35, ctx=XL_CTX, t=XL_T),
             Phase1Config(max_iter=MESH_XL_STEPS, check_every=10,
                          batch_size=XL_B), make_mesh(n_dp=1, n_ep=2), 36)
    # Sharded serving at B=3072, float32 and bf16.
    model, err = CRVAE(P, H, ENC), ErrorVAE(P, H)
    params = model.init(torch.Generator().manual_seed(37), dev)
    eparams = err.init(torch.Generator().manual_seed(38), dev)
    mesh = make_mesh(n_dp=2)
    for dtype in (None, "bfloat16"):
        gen = make_sharded_generator(model, err, mesh, SERVE_B, dtype=dtype)
        gen(params, eparams, torch.Generator(device=dev).manual_seed(0))
        if rank == 0:
            gwc(model, err, params, eparams,
                torch.Generator(device=dev).manual_seed(0), SERVE_B,
                dtype=dtype)
        coll.reset_staged()
        torch.cuda.synchronize()
        cuda_rollout.reset_launches()
        t0 = time.perf_counter()
        out = gen(params, eparams, torch.Generator(device=dev).manual_seed(39))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        row = {"launches": dict(cuda_rollout.LAUNCHES), "mesh_ms": 1e3 * secs,
               "shape": list(out.shape), "staged": staged()}
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = gwc(model, err, params, eparams,
                       torch.Generator(device=dev).manual_seed(39), SERVE_B,
                       dtype=dtype)
            torch.cuda.synchronize()
            err_abs = (out - want).abs()
            row.update(single_ms=1e3 * (time.perf_counter() - t0),
                       max_abs_err=float(err_abs.max()),
                       worst_rel=float((err_abs / (want.abs() + 1)).max()))
            tol = 1e-5 if dtype is None else BF16_TOL
            assert row["worst_rel"] <= tol, (dtype, row)
        both(f"serve_{dtype or 'float32'}", lambda: row)
    if rank == 0:
        with open(payload["out"], "w") as f:
            json.dump(res, f)
    shutdown()


def _spawn_mesh_ranks(out_path) -> list[str]:
    """Two ``--mesh-rank`` processes of this script sharing the card;
    their logs.  A rank that fails stops the other at once."""
    from vae_connexe_torch.parallel.mesh import _free_port

    init = f"tcp://localhost:{_free_port()}"
    procs, logs = [], []
    for rank in range(2):
        f = tempfile.TemporaryFile("w+")
        logs.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             json.dumps({"rank": rank, "init": init, "out": out_path})],
            stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes) or all(
                c == 0 for c in codes) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("mesh ranks failed:\n" + "\n".join(
            f"--- rank {r} ---\n{t[-6000:]}" for r, t in enumerate(texts)))
    return texts


def check_meshes(dev, card):
    """Meshes on the card.  (1) A world of one rank over NCCL in this
    process: ``fit_phase1(mesh=make_mesh())`` at p=20, H=64, B=256, ctx=20
    for MESH_STEPS steps bit for bit the unmeshed fit, 2 + 2 B1/B2
    launches a step.  (2) Two ranks sharing the card (gloo with CUDA
    tensors; NCCL refuses two ranks on one device), each meshed run held
    against the single-process run on the card: a dp=2 fit at p=20, an
    sp=2 fit at lorenz96_longhorizon's shapes, lorenz96_xl's width at
    ep=2, make_sharded_generator at B=3072 in float32 and bf16, and ``cli
    run lorenz96_crvae --processes 2 --ep 2`` cut to MESH_RUN_STEPS +
    MESH_RUN_STEPS steps against ``cli run`` in this process (the same
    recovered graph, params within MESH_TOL, the loss within
    MESH_LOSS_RTOL).  Launch counts are read on every rank, and the rates
    printed with the card, labelled as two ranks sharing one card."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.parallel.mesh import make_mesh, shutdown, world_info
    from vae_connexe_torch.train import Phase1Config
    from vae_connexe_torch.utils.tree import tree_leaves

    t_start = time.perf_counter()
    out = {}
    # (1) A world of one over NCCL.
    windows = lorenz_windows(dev, P, seed=30)
    model = CRVAE(P, H, ENC)
    params = model.init(torch.Generator().manual_seed(40), dev)
    cfg = Phase1Config(max_iter=MESH_STEPS, check_every=25,
                       batch_size=TRAIN_B)
    one, met1, secs1, _ = _mesh_fit(model, params, windows, cfg, 41, None,
                                    dev, warm=True)
    mesh = make_mesh()
    info = world_info()
    meshed, met, secs, launches = _mesh_fit(model, params, windows, cfg, 41,
                                            mesh, dev, warm=True)
    shutdown()
    assert info["backend"] == "nccl", info
    assert met == met1, (met, met1)
    for a, b in zip(tree_leaves(meshed), tree_leaves(one)):
        assert torch.equal(a, b), "a mesh of one rank is not bit for bit"
    want = {"gru_forward": 2 * MESH_STEPS, "gru_backward": 2 * MESH_STEPS,
            "gru_forward_wide": 0, "gru_backward_wide": 0}
    assert launches == want, (launches, want)
    out["world1"] = {"backend": info["backend"], "launches": launches,
                     "steps_s": MESH_STEPS / secs,
                     "single_steps_s": MESH_STEPS / secs1, "bitwise": True}
    log(f"meshes: world of one over NCCL, fit_phase1 p={P} B={TRAIN_B} "
        f"{MESH_STEPS} steps bit for bit the unmeshed fit, "
        f"{MESH_STEPS / secs:.1f} vs {MESH_STEPS / secs1:.1f} steps/s, "
        f"launches {launches} [{card}]")
    # (2) Two ranks sharing the card.
    with tempfile.TemporaryDirectory() as tmp:
        res_path = os.path.join(tmp, "mesh_ranks.json")
        rank_logs = _spawn_mesh_ranks(res_path)
        ranks = json.load(open(res_path))
        for line in rank_logs[0].splitlines():
            if "backend" in line:
                log(f"meshes: {line.strip()}")
        per_step = {"dp2": (MESH_STEPS, 2, 0), "sp2": (MESH_SP_STEPS, 3, 0),
                    "xl_ep2": (MESH_XL_STEPS, 0, 2)}
        for name, (steps, plain, wide) in per_step.items():
            rows = ranks[name]
            for r, row in enumerate(rows):
                want = {"gru_forward": plain * steps,
                        "gru_backward": plain * steps,
                        "gru_forward_wide": wide * steps,
                        "gru_backward_wide": wide * steps}
                assert row["launches"] == want, (name, r, row, want)
            r0 = rows[0]
            log(f"meshes: {name} two ranks sharing one card: "
                f"{r0['mesh_steps_s']:.1f} steps/s meshed beside "
                f"{r0['single_steps_s']:.1f} single-process, max abs err "
                f"{r0['max_abs_err']:.3g}, loss {r0['loss']:.6f} vs "
                f"{r0['single_loss']:.6f}, launches by rank "
                f"{[row['launches'] for row in rows]}, staged through the "
                f"host on rank 0 {r0['staged']} [{card}]")
        for dtype in ("float32", "bfloat16"):
            rows = ranks[f"serve_{dtype}"]
            k1, k2 = (("crvae_free_run", "errvae_sample") if dtype ==
                      "float32" else ("crvae_free_run_bf16",
                                      "errvae_sample_bf16"))
            for row in rows:
                assert row["launches"][k1] == row["launches"][k2] == 1, row
                assert row["shape"] == [SERVE_B, T, P], row
            r0 = rows[0]
            log(f"meshes: make_sharded_generator B={SERVE_B} {dtype}, two "
                f"ranks sharing one card: {r0['mesh_ms']:.2f} ms meshed "
                f"(incl. the gather) beside {r0['single_ms']:.2f} ms "
                f"single-process, max abs err {r0['max_abs_err']:.3g}, "
                f"launches by rank {[row['launches'] for row in rows]}, "
                f"staged on rank 0 {r0['staged']} [{card}]")
        out.update({k: v for k, v in ranks.items()})
        out["run"] = _mesh_cli_run(card, tmp)
    out["wall_s"] = time.perf_counter() - t_start
    log(f"meshes: phase wall time {out['wall_s']:.1f} s [{card}]")
    return out


def _mesh_cli_run(card, tmp):
    """``cli run lorenz96_crvae --processes 2 --ep 2`` (two ranks sharing
    the card, 5 heads each) against ``cli run`` in this process, both at
    MESH_RUN_STEPS steps a phase."""
    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.utils import load_gc, restore_checkpoint
    from vae_connexe_torch.utils.tree import tree_leaves

    name = "lorenz96_crvae"
    mp_dir, sp_dir = os.path.join(tmp, "mp"), os.path.join(tmp, "sp")
    steps = str(MESH_RUN_STEPS)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vae_connexe_torch.cli", "run", name,
         "--processes", "2", "--ep", "2", "--iters", steps, "--out-dir",
         mp_dir], capture_output=True, text=True, cwd=ROOT,
        timeout=MESH_RANK_TIMEOUT)
    mp_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    got = json.load(open(os.path.join(mp_dir, "mp_results.json")))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["run", name, "--iters", steps, "--out-dir", sp_dir,
                  "--quiet", "--save-checkpoints"])
    sp_s = time.perf_counter() - t0
    want = json.load(open(os.path.join(sp_dir, f"metrics_{name}.json")))
    gc_mp = np.load(os.path.join(mp_dir, f"GC_{name}.npy"))
    gc_sp = load_gc(os.path.join(sp_dir, "ckpt_phase1"))
    assert np.array_equal(gc_mp, gc_sp), (gc_mp, gc_sp)
    arrays = np.load(os.path.join(mp_dir, "mp_params.npz"))
    model, err = CRVAE(CRVAE_P, H), ErrorVAE(CRVAE_P, H)
    tmpl = model.init(torch.Generator(), "cpu")
    p1 = restore_checkpoint(os.path.join(sp_dir, "ckpt_phase1"), tmpl)
    p2 = restore_checkpoint(os.path.join(sp_dir, "ckpt_phase2"), {
        "crvae": tmpl, "error_vae": err.init(torch.Generator(), "cpu")})
    worst = 0.0
    for key, tree in (("p1", p1), ("p2", p2["crvae"]),
                      ("err", p2["error_vae"])):
        leaves = tree_leaves(tree)
        worst = max(worst, _close(
            [torch.from_numpy(arrays[f"{key}_{i}"])
             for i in range(len(leaves))], leaves))
    for phase, key in (("phase1", "loss"), ("phase2", "mean_loss")):
        assert math.isclose(got[phase][key], want[phase][key],
                            rel_tol=MESH_LOSS_RTOL), (phase, got, want)
    n = MESH_RUN_STEPS
    for r, launches in enumerate(got["launches"]):
        expect = {"gru_forward": 6 * n, "gru_backward": 6 * n,
                  "gru_forward_wide": 0, "gru_backward_wide": 0}
        assert launches == expect, (r, launches, expect)
    row = {"mesh": got["mesh"], "launches": got["launches"],
           "max_abs_err": worst, "mp_wall_s": mp_s, "single_wall_s": sp_s,
           "auroc": got["gc"]["auroc"], "single_auroc": want["gc"]["auroc"]}
    log(f"meshes: cli run {name} --processes 2 --ep 2 --iters {steps} (two "
        f"ranks sharing one card): the graph of the single-process run, "
        f"params max abs err {worst:.3g}, phase-1 loss "
        f"{got['phase1']['loss']:.6f} vs {want['phase1']['loss']:.6f}, "
        f"AUROC {row['auroc']:.4f}, {mp_s:.1f} s (incl. starting the ranks) "
        f"vs {sp_s:.1f} s in process, launches by rank {got['launches']} "
        f"[{card}]")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vae_connexe_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    built = _build.build_all(list(_build.SOURCES))
    _build.rollout_library(), _build.gru_library(), _build.step_library()
    log(f"build: {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (_, report) in built.items():
        for line in ptxas_summary(report):
            log(f"  ptxas {name}: {line}")

    errors = {}
    check_kernels(dev, errors)
    check_training_kernels(dev, errors)
    check_step_phases(dev, errors)
    check_phase2_step(dev, errors)
    win_windows = henon_windows(dev)
    win_steps = check_win_steps(dev, errors, win_windows)
    series10 = lorenz_windows(dev, CRVAE_P, seed=4)
    check_sweep(dev, card, errors, series10)
    check_cs_steps(dev, errors)
    check_vrae_steps(dev, errors)
    bf16_rows = check_bf16_rollouts(dev, card, errors)
    launches, served_fn = serve_main_path(dev)
    launches.update(serve_scaled_path(dev, card))
    series = lorenz_windows(dev, P, seed=0)
    launches.update(train_main_path(dev, card, series))
    launches.update(scaled_main_path(dev, card))
    launches.update(step_main_path(dev, card, series))
    with tempfile.TemporaryDirectory() as out_dir:
        run_launches, trained = run_main_path(dev, card, out_dir)
        kill_resume_main_path(dev, card, series, out_dir)
        run_launches.update(serve_own_weights(dev, card, out_dir, trained))
        sweep_launches, sweep_rate = sweep_main_path(dev, card)
        found = discover_main_path(dev, card, out_dir)
        win_runs = {name: win_run_main_path(dev, card, out_dir, name, extra)
                    for name, extra in (("henon6d_win", ["--iters", "2000"]),
                                        ("var_crvae", []))}
        author = henon_author_main_path(dev, card, out_dir)
        serve_win_main_path(dev, card, out_dir, win_windows)
        win_found = win_discover_main_path(dev, card, out_dir)
        crcsrae = crcsrae_main_path(dev, card, out_dir)
        csrae = csrae_main_path(dev, card, out_dir)
        vrae = vrae_main_path(dev, card, out_dir)
        debug_nans_main_path(dev, card)
        ooc = out_of_core_main_path(dev, card, out_dir)
        ooc["rates"] = time_out_of_core(dev, card, out_dir, series)
    meshes = check_meshes(dev, card)
    times = time_all(dev, card, served_fn)
    times.update(time_training(dev, card, series))
    phase2_rates = time_phase2(dev, card, series, series10)
    sweep_rates = time_sweep(dev, card, series10, series)
    win_rates = time_win(dev, card, win_windows)
    a4_rates = time_a4(dev, card, series10)
    # B1/B2 at this slice's new shapes: lorenz96_crcsrae's encoder and
    # decoder heads at B=2048, the VRAE's one-head encoder.
    g = torch.Generator().manual_seed(80)
    a4_shapes = {}
    for key, shape in (("crcsrae_encoder", (1, CS_B1, ENC, CRVAE_P, H)),
                       ("crcsrae_decoder",
                        (CRVAE_P, CS_B1, CTX - ENC, CRVAE_P, H)),
                       ("vrae_encoder", (1, 32, 20, CRVAE_P, H))):
        row = time_recurrence(dev, card, g, *shape)
        row["fwd_bound_ms"] = bound(*gru_cost(*shape, backward=False))[0]
        row["bwd_bound_ms"] = bound(*gru_cost(*shape, backward=True))[0]
        a4_shapes[key] = row

    rollout_src, gru_src = ("vae_connexe_torch/csrc/rollout.cu",
                            "vae_connexe_torch/csrc/gru.cu")
    enc = (1, TRAIN_B, CTX - ENC, P, H)       # B1/B2 timed at the encoder
    wide_enc = (1, SCALED_B, ENC, SCALED_P, SCALED_H)
    k1_src = "vae_connexe_tpu/ops/pallas_rollout.py:117"
    k2_src = "vae_connexe_tpu/ops/pallas_rollout.py:204"
    sp, sh = SCALED_P, SCALED_H
    costs = {
        "crvae_free_run": (rollout_cost(SERVE_B, T, P, H, P, 1, True, True),
                           rollout_src, k1_src),
        "errvae_sample": (rollout_cost(SERVE_B, T, 1, H, P, P, False, False),
                          rollout_src, k2_src),
        "crvae_free_run_streamed": (
            rollout_cost(SERVE_B, T, sp, sh, sp, 1, True, True), rollout_src,
            k1_src),
        "errvae_sample_streamed": (
            rollout_cost(SERVE_B, T, 1, sh, sp, sp, False, False),
            rollout_src, k2_src),
        "gru_forward": (gru_cost(*enc, backward=False), gru_src,
                        "vae_connexe_tpu/ops/pallas_gru.py:243"),
        "gru_backward": (gru_cost(*enc, backward=True), gru_src,
                         "vae_connexe_tpu/ops/pallas_gru.py:426"),
        "gru_forward_wide": (gru_cost(*wide_enc, backward=False), gru_src,
                             "vae_connexe_tpu/ops/pallas_gru.py:243"),
        "gru_backward_wide": (gru_cost(*wide_enc, backward=True), gru_src,
                              "vae_connexe_tpu/ops/pallas_gru.py:426"),
        "phase1_step": (step_cost(P, TRAIN_B, CTX, ENC, H),
                        "vae_connexe_torch/csrc/step.cu",
                        "vae_connexe_tpu/ops/pallas_step.py:353"),
    }
    # lorenz96_xl's width on the streamed route: its times, bounds and plan
    # in the streamed rows (the same kernels).
    for name in ("crvae_free_run", "errvae_sample"):
        k1 = name.startswith("crvae")
        outs, heads = (1, XL_P) if k1 else (XL_P, 1)
        row = times.pop(f"{name}_xl")
        times[f"{name}_streamed"]["extra"]["xl"] = {
            "p": XL_P, "hidden": XL_H, "ms": row["ms"],
            "plain_ms": row["plain_ms"], **row["extra"],
            "bound_ms": bound(*rollout_cost(SERVE_B, T, heads, XL_H, XL_P,
                                            outs, k1, k1))[0],
            "b1_bound_ms": bound(*rollout_cost(1, T, heads, XL_H, XL_P, outs,
                                               k1, k1))[0],
            "plan": cr_plan("crvae" if k1 else "errvae", XL_P, XL_H, dev)}
    # B=1 bounds of the rollouts, beside their B=1 times, and their plans.
    for name, (b1_cost, p, hidden) in {
            "crvae_free_run": (rollout_cost(1, T, P, H, P, 1, True, True), P, H),
            "errvae_sample": (rollout_cost(1, T, 1, H, P, P, False, False), P,
                              H),
            "crvae_free_run_streamed": (
                rollout_cost(1, T, sp, sh, sp, 1, True, True), sp, sh),
            "errvae_sample_streamed": (
                rollout_cost(1, T, 1, sh, sp, sp, False, False), sp, sh),
    }.items():
        times[name]["extra"]["b1_bound_ms"] = bound(*b1_cost)[0]
        kind = "crvae" if name.startswith("crvae") else "errvae"
        times[name]["extra"]["plan"] = cr_plan(kind, p, hidden, dev)
    kernels = []
    for name, ((flops, nbytes), source, replaces) in costs.items():
        bound_ms, bound_by = bound(flops, nbytes)
        row = times[name]
        if name in ("gru_forward_wide", "gru_backward_wide"):
            # Their walks' (and the forward's projection's) products run as
            # three TF32 passes: bound at that rate, the f32 bound beside it.
            row["extra"]["bound_f32_ms"] = bound_ms
            bound_ms, bound_by = (b1_wide_bound if name == "gru_forward_wide"
                                  else b2_wide_bound)(*wide_enc)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": row.get("library_ms"),
            **row.get("extra", {}),
        })
    by_name = {k["name"]: k for k in kernels}
    for name in ("gru_forward", "gru_backward"):
        by_name[name].update(
            launches_run_phase1=run_launches["run_phase1"][name],
            launches_run_phase2=run_launches["run_phase2"][name],
            phase2_step_max_abs_err=errors["phase2_step"])
    by_name["gru_backward"]["phase2_rates"] = phase2_rates
    for name in ("gru_forward", "gru_backward"):
        by_name[name].update(
            launches_sweep=sweep_launches[name],
            launches_discover_sweep=found["discover_sweep"][name],
            launches_discover_phase2=found["discover_phase2"][name],
            sweep_max_abs_err=errors["sweep"])
    by_name["gru_backward"].update(sweep_main=sweep_rate,
                                   sweep_rates=sweep_rates,
                                   discover=found["discover"])
    for name in ("gru_forward", "gru_backward"):
        by_name[name].update(
            launches_win_run={
                run: {part: r[part][name] for part in
                      ("stage1", "stage2", "after_fit")}
                for run, r in win_runs.items()},
            launches_win_many={
                **{f"run_{run}": r["fit_many"][name]
                   for run, r in win_runs.items()},
                "discover": win_found["fit_many"][name]},
            win_step_check_launches={k: v[name]
                                     for k, v in win_steps.items()},
            launches_win_discover=win_found["launches"][name],
            launches_henon_author={k: author[k][name]
                                   for k in ("phase1", "phase2")},
            win_step_max_abs_err=errors["win_step"])
    by_name["gru_backward"].update(
        win_rates=win_rates,
        win_runs={run: {k: r[k] for k in ("wall_s", "auroc", "stability_f1")}
                  for run, r in win_runs.items()},
        henon_author={k: author[k] for k in
                      ("wall_s", "auroc", "seed_aurocs", "share_1")},
        win_discover={k: win_found[k] for k in
                      ("wall_s", "auroc_offdiag", "confidence")})
    fwd_keys = ("ms", "fwd_device_ms", "plain_ms", "library_ms",
                "fwd_bound_ms")
    for name in ("gru_forward", "gru_backward"):
        by_name[name].update(
            launches_crcsrae={k: crcsrae[k][name]
                              for k in ("phase1", "phase2")},
            launches_vrae=vrae["launches"][name],
            cs_step_max_abs_err=errors["cs_step"],
            vrae_step_max_abs_err=errors["vrae_step"],
            a4_shapes={k: {f: r.get(f) for f in r if (f in fwd_keys) ==
                           (name == "gru_forward")}
                       for k, r in a4_shapes.items()})
    by_name["gru_backward"].update(
        a4_rates=a4_rates,
        crcsrae={k: crcsrae[k] for k in (
            "wall_s", "auroc", "f1", "phase1_metrics", "phase2_metrics",
            "generation_moment_gap")},
        csrae=csrae,
        vrae={k: vrae[k] for k in ("wall_s", "loss_first", "loss_last")})
    for name in ("crvae_free_run", "errvae_sample"):
        by_name[name].update(
            launches_crcsrae=crcsrae["rollouts"][f"{name}_resident"],
            launches_vrae=vrae["rollouts"][name])
    for name in ("crvae_free_run", "errvae_sample"):
        by_name[name].update(
            launches_run=run_launches["run_rollouts"][f"{name}_resident"],
            launches_served_own=run_launches["served_own"][name],
            launches_discover=found["discover_rollouts"][f"{name}_resident"],
            launches_henon_author=author["rollouts"][f"{name}_resident"])
    # The bf16 instantiations: K1 at the serving width (resident)
    # and at lorenz96_scaled's (streamed), K2 (resident at both; its row
    # carries the H=128 readings), bounds in bf16 weight bytes and at the
    # bf16 tensor-core rate; launches from the bf16 serving main paths.
    own16 = run_launches["served_own_bf16"]
    for name, key, (p, hidden), launched in (
            ("crvae_free_run_bf16", "k1", (P, H),
             own16["crvae_free_run_bf16"]),
            ("errvae_sample_bf16", "k2", (P, H),
             own16["errvae_sample_bf16"]
             + launches["errvae_sample_bf16_resident"]),
            ("crvae_free_run_bf16_streamed", "k1", (sp, sh),
             launches["crvae_free_run_bf16_streamed"])):
        big, one = bf16_rows[(p, SERVE_B)], bf16_rows[(p, 1)]
        row = {"name": name, "route": "cuda", "source": rollout_src,
               "replaces": k1_src if key == "k1" else k2_src,
               "launches": launched, "max_abs_err": errors[name],
               "ms": big[f"{key}_ms"], "plain_ms": big[f"{key}_plain_ms"],
               "bound_ms": big[f"{key}_bound_ms"],
               "bound_by": big[f"{key}_bound_by"], "library_ms": None,
               "f32_ms": big[f"{key}_f32_ms"],
               "plan": big[f"plan_{key}"],
               "b1_ms": one[f"{key}_ms"], "b1_plain_ms": one[f"{key}_plain_ms"],
               "b1_f32_ms": one[f"{key}_f32_ms"],
               "b1_bound_ms": one[f"{key}_bound_ms"]}
        if name == "errvae_sample_bf16":
            big, one = bf16_rows[(sp, SERVE_B)], bf16_rows[(sp, 1)]
            row["h128"] = {
                "route": big["route_k2"], "plan": big["plan_k2"],
                "ms": big["k2_ms"], "plain_ms": big["k2_plain_ms"],
                "f32_streamed_ms": big["k2_f32_ms"],
                "bound_ms": big["k2_bound_ms"], "b1_ms": one["k2_ms"],
                "b1_f32_streamed_ms": one["k2_f32_ms"],
                "launches_scaled": launches["errvae_sample_bf16_resident"]}
        kernels.append(row)
    by_name["gru_backward"]["out_of_core"] = ooc
    for name in ("gru_forward", "gru_backward"):
        by_name[name]["launches_meshes"] = {
            "world1_per_step": meshes["world1"]["launches"][name]
            // MESH_STEPS,
            **{case: [row["launches"][name] + row["launches"][f"{name}_wide"]
                      for row in meshes[case]]
               for case in ("dp2", "sp2", "xl_ep2")},
            "run_processes_2_ep_2": [
                row[name] for row in meshes["run"]["launches"]]}
    by_name["gru_backward"]["meshes"] = {
        case: ({k: v for k, v in meshes[case][0].items() if k != "launches"}
               if isinstance(meshes[case], list) else meshes[case])
        for case in meshes if case != "world"}
    rows = {k["name"]: k for k in kernels}
    for name, key in (("crvae_free_run", "float32"),
                      ("errvae_sample", "float32"),
                      ("crvae_free_run_bf16", "bfloat16"),
                      ("errvae_sample_bf16", "bfloat16")):
        rows[name]["launches_sharded_serving"] = [
            row["launches"][name] for row in meshes[f"serve_{key}"]]
    by_name["crvae_free_run"]["fresh_process"] = run_launches[
        "fresh_process"]
    for name in kernels:
        if not name["launches"]:
            raise AssertionError(f"{name['name']} was not launched on its "
                                 f"main path")
    kernels[len(costs) - 1]["phase_max_abs_err"] = {
        k.split(":", 1)[1]: v for k, v in errors.items()
        if k.startswith("phase1_step:")}
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
        f"[{card}]")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _main_meshes() -> int:
    """``--phase meshes``: build the kernels and run check_meshes alone."""
    import torch

    from vae_connexe_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = smi_line()
    log(f"card: {card}")
    _build.build_all(list(_build.SOURCES))
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = check_meshes(torch.device("cuda"), card)
    log(json.dumps({"meshes": meshes}, default=str))
    return 0


def _main_bf16() -> int:
    """``--phase bf16``: build the kernels and run check_bf16_rollouts and
    check_vrae_steps alone."""
    import torch

    from vae_connexe_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = smi_line()
    log(f"card: {card}")
    built = _build.build_all(list(_build.SOURCES))
    for name, (_, report) in built.items():
        for line in ptxas_summary(report):
            log(f"  ptxas {name}: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, errors = torch.device("cuda"), {}
    check_vrae_steps(dev, errors)
    rows = check_bf16_rollouts(dev, card, errors)
    log(json.dumps({"bf16": {f"{p}x{b}": row for (p, b), row in rows.items()},
                    "max_abs_err": errors}, default=str))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        try:
            _mesh_rank_main(json.loads(sys.argv[2]))
        except BaseException:
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
        sys.exit(0)
    if sys.argv[1:] == ["--phase", "meshes"]:
        sys.exit(_main_meshes())
    if sys.argv[1:] == ["--phase", "bf16"]:
        sys.exit(_main_bf16())
    sys.exit(main())
