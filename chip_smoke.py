#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device and build: the card's name and power limit (nvidia-smi), the
     fifteen kernels compiled from csrc/ into build/torch_kernels/ (one nvcc
     each, all started together), with each kernel's registers, shared
     memory and spills as ptxas reports them;
  2. selective-scan forward kernel (its three passes: chunks from zero,
     carry, final) vs plain: MedMamba's four stage shapes (G 32, N 16),
     forward and reverse, fp32 and bf16: y, and the saved chunk states
     (xsave, the carry pass's output) the backward reads, with times from
     CUDA events, each case's bound and the resident warps per SM each
     pass is granted, each pass's registers and local (spill) bytes, and
     at each bf16 case the device time of each pass (torch.profiler);
     Then FusionMamba's stages 0 and 3 at 256x256 with its four strided
     sub-sequences as parameter groups (G 8, K 4; L 1024, Dm 192 and L 16,
     Dm 1536; A, D and the dt bias drawn per group), forward, fp32 and
     bf16: y and xsave, times and bounds;
  2b. selective-scan backward kernel (four passes: local adjoint, carry,
     final, partial sums) vs plain, the same 20 cases, all seven
     gradients (at K 4 dA, dD and dbias summed per group over the batch),
     a second launch bit-identical, bounds, occupancy and the passes'
     device times as in 2; at one shape ScanFolded's gradients against
     torch.autograd through the plain forward;
  2c. four-direction fused SSD forward kernel vs its plain twin at MedSSD's
     stages 0 and 1 (B 32; L 3136, l 224, H4 8 and L 784, l 196, H4 16;
     P 64, N 512), its stage 0 at 240x240 (L 3600, l 240, nc 15, H4 8) and
     the same two stages at N 64 (gn 16: cnn_mamba and the other SSD
     models at d_state 16), fp32 and bf16: y and Ssave, a second launch
     bit-identical, times from CUDA events with and without Ssave beside
     the bound of each call, at
     each bf16 case the device time of each of the walk's passes
     (torch.profiler; so too in 2d, 2k and 2l), and what the card grants
     each pass and the HMMA instructions in each bf16 pass's SASS (so too
     in 2d, 2k and 2l);
  2d. its backward kernel vs the plain backward at the same 10 cases, all
     six cotangents, a second launch bit-identical; SSDFusedDirs against
     torch.autograd through the plain forward at MedSSD's stage 1 in fp32
     and at both N 64 stages in fp32 and bf16;
  2e. SSD Y_diag forward kernel vs plain at ST-SSD's stage 0 (BC 448 =
     32 x 14 chunks of l 224, H 8, N 64, P 64) and at N 512: MedSSD's
     stage 2 at 240x240 (BC 32, l 232 for L 225, H 32, P 64) and the shape
     of MedSSD's stage 3 at 512x512 (BC 32, l 256, H 64, P 64), fp32 and
     bf16, and at each bf16 case the device time of its one pass (rows),
     with what the card grants it and the HMMA instructions in its bf16
     SASS (so too in 2h for the backward's three passes: intra, cols,
     flush);
  2f. STL token-mixer kernel vs plain at ST-SSD's stages 0 and 1 (BB 128;
     L = P 3136, C 128 and L = P 784, C 256), fp32 and bf16: U and the
     rows' lse, and at each bf16 case the device time of its two passes
     (rows, cols), with what the card grants each pass and the HMMA
     instructions in each bf16 pass's SASS (so too in 2i, whose backward
     reads the forward kernel's lse);
  2g. STF gate kernel vs plain at stages 0 and 1 (BB 32; P 3136, C 128 and
     P 784, C 256), fp32 and bf16; 2e-2g each with a second launch
     bit-identical and times from CUDA events; 2g and 2j also print each
     gate pass's device time at the bf16 cases, what the card grants each
     pass, its HMMA count and the sigmoids' time at the MUFU rate beside
     the bound;
  2h-2j. the backward kernels of Y_diag, the STL mixer and the STF gate
     against their plain backwards at the cases of 2e-2g, every cotangent,
     a second launch bit-identical, times from CUDA events; at one shape
     each (each Y_diag shape), YDiagFused, STLMixer and STFZGate against
     torch.autograd through the plain forward;
  2k. single-layout fused SSD forward kernel vs plain at MedSSD's stage 1
     at 240x240 (B 32, L 900 padded to 4 chunks of l 256, H 16, N 512,
     P 64) and at B 8, L 784 (4 chunks of l 196), H 8, N 128, P 64, fp32
     and bf16: y and Ssave, a second launch bit-identical, as 2c;
  2l. its backward kernel vs the plain backward at the same 4 cases, all
     seven cotangents, a second launch bit-identical; SSDFused against
     torch.autograd through the plain forward in fp32 at both shapes;
  2m. selective-scan forward kernel with its state flags (init in, last
     out) vs plain at the Mamba LM's layer call (K 1, G 8, L 2048, Dm 1536)
     and MedMamba's stage 0 with its directions as groups (K 4, G 32),
     forward and reverse, fp32 and bf16: y, xsave and last, the first
     chunk's xsave equal to init, a second launch bit-identical, a zero
     init bit-identical to no init (the carry pass's seed);
  2n. its backward with dlast and dinit at the same 8 cases, all eight
     gradients (dinit the carry pass's end), a second launch
     bit-identical, a zero dlast bit-identical to none; 2m and 2n print
     occupancy and bounds as 2 does; ScanFolded with the flags against
     torch.autograd through the plain forward;
  2o. the v1 selective-scan forward kernel (one walk in time per state,
     xsave at the chunks of T) vs its plain twin (the doubling scan) at the
     kernel bench's four stages (G 128 = 32 x 4 directions, N 16) at T 50,
     stage 0 at T 100, and at G 8 chunks of T 1, 7, 33 and 240 over L 300
     and N 64 over 36 channels at L 257, fp32 and bf16: y and xsave, a
     second launch bit-identical; at stage 0 bf16 the device time of its
     one pass (torch.profiler), and what the card grants it (registers,
     local bytes, shared bytes, warps per SM; so too in 2p);
  2p. its backward at the same cases, all seven gradients, a second launch
     bit-identical, and in fp32 and bf16 one case with an xsave that is not
     the forward's (the forward's plus seeded noise: each chunk's states
     come from the xsave given); ScanFolded on the v1 pair (the cap at 50)
     against torch.autograd through the plain forward; ValueError under v1
     for reverse and each flag;
  2q. the bench's calibration kernel vs its plain twins at the bench's
     four stages and inputs (bf16) and at two ragged cases (G 8, odd Dm,
     pad rows; N 24 and N 5; bf16 and fp32), fp32 and bf16 compute: within
     CALIB_TOL of kern's order, in fp32 compute also within CALIB_TWIN_TOL
     of the kernel's own order, a second launch bit-identical, times
     beside the bound (bytes, operations or the exps at the MUFU rate), at
     each stage what the card grants the pass, at stage 0 its device time;
  2r. the d_state-16 models' SSD core (ss2d_core_ssd) at their stages 0-1
     at 224x224 (B 32, bf16, N 64) through the dirs path the gate picks
     and through the einsum path (forced; Y_diag at stage 0): forward and
     forward + backward times from CUDA events, each path's launches, the
     two paths' outputs against each other;
  3. medmamba eval and 4. medmamba training, 5. medssd eval and
     6. medssd training, 7. st_ssd eval and 8. st_ssd training, each model
     at full width (224x224), then 9. medssd eval and 10. medssd training
     at 240x240, where its stages take the dirs SSD, the single-layout
     fused SSD and Y_diag at N 512 (2 + 2 + 4 launches per forward); each
     at batch 32, 8 classes, seeded random weights with the scan
     parameters drawn away from init, bf16 compute, fp32 params.  Eval
     runs through cli.test.run_eval: every kernel's launches (each counter
     set to 0 just before the run and read just after: the path's kernels
     exactly their calls per forward, the others none), the logits
     against the same model with the plain versions (bf16, and fp32 on one
     batch), img/s and a profile of one forward.  Training runs through
     cli.train.run_train with Adam (lr 1e-4), one warm-up step then 4 timed
     steps: every kernel's launches (the path's forward and backward
     kernels exactly their calls per step, the others none), a finite loss,
     every parameter moved, every parameter's gradient at batch 4 against
     the plain versions (fp32 and bf16; on the same training's weights made
     again, and the gradients taken, under cuDNN's deterministic
     algorithms: everything else runs with cuDNN's defaults, as the CLIs
     do), img/s and a profile of one step;
  11. the Mamba-1 LM at mamba-130m width and depth (d_model 768, 24
     layers, vocab 50280, fp32, seeded random weights with the scan
     parameters drawn away from init) scoring 8 x 2048 tokens: 24 scan
     forward launches per forward and every other kernel none, the logits
     against the plain scan, tokens/s, device ms and the scan's share of
     one forward; then at 4 layers (b2 x 1024) every parameter's gradient
     of the cross-entropy plus a term on each layer's last state (dlast on
     the path), kernels against the plain scan;
  12. greedy generate with the full LM on the card (4 prompts x 64 tokens,
     32 new): each new token the full forward's argmax, decode_step's
     logits against the full forward's, ms per decode step and tokens/s;
  13. the kernel bench (scripts/kernel_bench.py) through its main():
     --stage all at the default cap (the two-level scan kernels only) and
     --stage all --t-cap 50 (the v1 pair only: one forward launch per
     forward and per fwd+bwd call, one backward launch per fwd+bwd call,
     at each stage), each at --iters 3, and --calibrate at --iters 20 (the
     calibration kernel only), its reading beside --t-cap 50's forward; then
     row 1 against row 3 and row 2 against row 4 at the bench's stage 0 in
     bf16, timed in turns.
  14.-17. cnn_mamba_mifa and kanin_ssd eval and training at 224x224 as
     in 5 and 6 (the dirs kernels at N 64 at stages 0-1: 4 + 4 launches a
     step); 18.-24. cnn_mamba, kanout_ssd and medssd with each KAN head
     (ekan, okan, kan_stack, kan_module, 3kan) at full width: one eval
     forward through run_eval and one Adam step through run_train each,
     launches exactly the path's, logits against the plain versions, every
     parameter moved; 25.-26. kan_grid_update of medssd_ekan and
     medssd_okan on one batch on the card: the head's grid and spline
     weights re-fit in place, the logits on the batch kept within
     REGRID_TOL x max|logit|, the knots and the refit head's output
     against the same re-grid in fp64 on the host (REFIT_GRID_TOL,
     REFIT_TOL);
  27.-31. the CrossMamba family at full width (blocks and fusions at
     N 512): 27. cross_cls_stage3 (224x224, batch 8, bf16) through the
     two-input eval and train steps on host pairs: 4 eval batches, one
     warm-up and 4 Adam steps (8 dirs launches a forward, 8 + 8 a step);
     28.-29. cross_cls_4ef (12 a forward) and cross_cls_3e1fadd1e (8) one
     forward and one step each; 30. vfefm_2b2 (256x256, batch 2) through
     cli/fusion_train.py's main() on 8 generated CT/MRI PNG pairs for an
     epoch in fp32 (the CLI's default) and with --dtype bf16 (44 dirs +
     16 Y_diag launches a forward, as many backward), then
     cli/fusion_test.py's main() on the pairs with the fp32 run's weights
     (one PNG a pair); 31. vfefm_2c1 one step through
     cli/fusion_train.py --single-decoder (25 + 12).  Each: launches
     exactly the path's (the counters at 0 just before each run), every
     parameter moved, and against the same model with the plain twins and
     the same weights the output (logits, fused image) within LOGIT_TOL in
     bf16 and fp32 and every fp32 parameter gradient within
     PARAM_GRAD_TOL (cuDNN's deterministic algorithms; for the U-Nets,
     of the fusion loss and of mean(out), both fp32 paths against the
     same step in float64, on every leaf the kernels within
     PARAM_GRAD_TOL + COND_RATIO x the plain twins' own error, the U-Nets'
     gates at one block a stage, GATE_DEPTHS); pairs/s, resident wall and
     device ms of a forward and a step;
  32. fusionmamba (the EfficientScan U-Net, 256x256, batch 2, one-channel
     pairs) through cli/fusion_train.py --model fusionmamba on the
     generated pairs for an epoch in fp32 and with --dtype bf16: the
     Mamba-1 scan pair at K 4, 48 forward launches a forward and as many
     backward a step (the encoder's 15 blocks on both inputs, the cross
     blocks of stages 1-3, the decoder's 15 blocks), every other kernel
     none, every parameter moved but stage 0's unread cross block, the
     gates as 30's (float64 through the plain scan in float64) on dark
     pairs with the fusion loss and sum(out w) (FM_GRAD_LOSSES), every
     leaf whose error is not zero checked (FM_GRAD_FLOOR), pairs/s,
     resident wall and device ms of a step (the scan forward and backward
     apart, the rest's largest kernels) and of a forward.
  33.-35. the evaluation tools: 33. cli/test.py --all-index --csv-out
     (full-width medmamba, fp32, b32) on a generated 8-class ImageFolder of
     40 PNGs: the scan's launches for two batches, the CSV's columns the
     JAX CLI's, param_count the model's, the accuracy equal to and the AUC
     within 1e-3 of the metrics of the same images through the plain
     twins; 34. Grad-CAM, fp32: cli/cam.py on one PNG with medmamba, all
     four stages (40 forward + 32 backward scan launches), then grad_cam
     at b8 for medmamba, medssd and st_ssd: launches exactly CAM_PATHS'
     (the forward kernels of every stage, the backward kernels of stages
     1-3), each stage's map spanning over 1e-3, heatmaps within 2e-3 of
     the plain twins', ms a call; 35. cli/export.py (torch.export, b8,
     bf16) of medmamba and st_ssd at 224x224 and medssd at 240x240, which
     together hold the six forward kernels as mic_torch ops: each program
     loaded and run by cli/export.py's load_and_check in a fresh python3
     that imports kernels/ops.py and nothing of the models, its launches
     those of the eager forward, its logits within 1e-3 x max|logit| of
     the eager module's (bit-identity printed), trace and save seconds and
     the .pt2 sizes.
  36.-37. data and sequence parallelism, as 2 ranks (spawned processes)
     that share the card over gloo (NCCL takes one rank a GPU), which
     holds them to one process's numbers: correctness, not scaling.
     36. DP: cli/ddp_train.py --auto-resume under torchrun on phase 33's
     40 images (global batch 32, SGD, an epoch of one step, evaluated on
     the same images; TF32 off) over 2 gloo ranks and over one rank on
     the CLI's default NCCL backend, their epoch-0 checkpoints against
     each other (PAR_STATS_TOL, PAR_ULP_FLOOR), rank 0's log lines once;
     beside them, the ranks of the step functions: the seeded medmamba
     (224x224, fp32) one step through make_train_step on each rank's rows
     of 8 images: rows 1-2 40 + 40 launches on each rank, the ranks'
     averaged gradients identical and within PARAM_GRAD_TOL of one
     process's on the 8, the loss within 1e-5.  37. SP (the same ranks'
     steps): medmamba and medssd at 256x256 (every stage's L divides by
     2), fp32, batch 4, sp 2: each rank's launches (medmamba rows 1-2
     20 + 20, pass 1 with want_state and pass 2 with init, their
     backwards with dlast and dinit; medssd Y_diag 2 + 2 on the stage-0
     shards, nothing else), the loss, logits and every parameter's
     gradient against the unsharded model in this process; then, with
     the card to itself, each pass's device ms at medmamba's stage-0
     shard beside its bound.  Each prints its seconds.
  38. tensor parallelism, tp 2 as 2 ranks sharing the card over gloo:
     the seeded full-width medmamba, medssd, cnn_mamba_mifa and st_ssd
     (224x224, fp32, batch 8) one train step each through make_train_step
     with each SS2D / SS2DSSD layer's channels or heads split over the
     ranks, against the unsharded step in this process: each rank's
     launches exactly TP_PATHS' (medmamba rows 1-2 40 + 40 at d_inner / 2;
     medssd dirs 2 + 2 at stage 1 and the single-layout fused SSD 2 + 2
     at stage 0, whose per-rank d_ssm the dirs kernels do not take;
     cnn_mamba_mifa dirs 4 + 4; st_ssd Y_diag 2 + 2, the mixer and the
     gate 4 + 4 each on the channels gathered over the ranks), the loss
     within 1e-5, the logits within LOGIT_TOL, every gradient leaf joined
     over the ranks within PARAM_GRAD_TOL; beside them cli/ddp_train.py
     --tp 2 (gloo, phase 36's arguments), its full checkpoint against
     phase 36's NCCL rank; then, the card to itself, rows 1-2, 5/5b and
     6/6b at a rank's shapes against their plain versions, each beside
     its bound.
  39. the profiled train steps (``utils/profiling.py``): medmamba, medssd
     and st_ssd at 224x224, b32, bf16, and st_ssd in fp32, three steps
     each after a warm-up through ``profiling.trace`` (which opens with
     its own warm-up launches: a capture's first kernel records can be
     lost), read by ``profiling.attribute`` in a fresh process: the device
     time by category and by source line printed, the trace's total
     against the capture's own event list (and key_averages() for
     medmamba) within 0.5%, at least 99% of the kernel time on a port
     line, every kernel in a named category, the path's launches by
     source on ops/ and models/ lines; the forward's and the step's FLOPs
     on the card (FlopCounterMode) against a fresh CPU process's count on
     fake tensors, and TFLOP/s.
The model phases (3-39) also hold the v1 and calibration counters at 0.
Then one JSON line describing the fifteen kernels (launches in the training
runs, in the bench's runs for v1 and the calibration; errors, times, the
bound of each from this run's shapes; times and bounds at stage 0 in bf16,
the fused SSD's at MedSSD's stage 1 at 240x240; rows 1-2 also at the LM's
layer call under "lm"; rows 5/5b also at N 64 under "n64", with their
launches per cnn_mamba_mifa training step; rows 5/5b and 7/7b also the
launches per train step of each CrossMamba model under "crossmamba";
rows 1-2 also FusionMamba's launches per train step and their stage-0 K 4
case under "fusionmamba"; the rows the evaluation tools reach also their
launches per grad_cam call and per loaded export's forward under
"eval_tools"; rows 1-2 their launches a rank makes in a DP step and
in an SP step, by state flag, with the passes' ms under "dp" / "sp",
rows 7/7b medssd's SP launches under "sp"; every row a TP rank reaches
its launches a rank makes in each model's tp-2 step, and rows 1-2, 5/5b
and 6/6b their times at a rank's shapes, under "tp"), the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.  Without
a CUDA device it exits non-zero before printing any result.  ``--out``
writes the per-case numbers and the profiles as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STAGES = ((3136, 96), (784, 192), (196, 384), (49, 768))  # (L, Dm) at 224²
G, N = 32, 16
BATCH, SIZE, CLASSES, STEPS = 32, 224, 8, 4
SCAN_CALLS_PER_FORWARD = 4 * (2 + 2 + 4 + 2)       # 4 directions x blocks
KERNELS = ("selective_scan_fwd", "selective_scan_bwd", "ssd_fused_dirs_fwd",
           "ssd_fused_dirs_bwd", "ssd_ydiag_fwd", "ssd_ydiag_bwd",
           "stl_mixer_fwd", "stl_mixer_bwd", "stf_zgate_fwd", "stf_zgate_bwd",
           "ssd_fused_fwd", "ssd_fused_bwd", "selective_scan_v1_fwd",
           "selective_scan_v1_bwd", "scan_calib")
# the kernel bench (scripts/kernel_bench.py): G 128 = batch 32 x K 4 at the
# MedMamba-T stages (STAGES).  The v1 scan's cases (name, G, L, Dm, N, T):
# the four stages at T 50 (the bench's --t-cap 50), stage 0 at T 100
# (--t-cap 100), chunks of 1, 7, 33 and 240 steps over L 300 (each leaves a
# ragged last chunk), and N 64 over 36 channels (a block's second group of
# 32 channels cut short) with a ragged chunk
BENCH_G = 128
V1_CASES = tuple((f"stage{i}", BENCH_G, L, Dm, 16, 50)
                 for i, (L, Dm) in enumerate(STAGES)) + (
    ("stage0", BENCH_G, 3136, 96, 16, 100),) + tuple(
    ("edge", 8, 300, 96, 16, T) for T in (1, 7, 33, 240)) + (
    ("ragged", 8, 257, 36, 64, 50),)
# the case 2p also runs with an xsave that is not the forward's
V1_PERTURBED = V1_CASES[0]
# calibration kernel vs plain: |k - p| <= atol x max|p| + rtol |p|; y is
# bf16 in both modes, and a sum that straddles a rounding point (or, with
# bf16 compute, an exp or softplus one ulp apart) lands one bf16 step away
CALIB_TOL = (3e-2, 2e-2)
# its fp32 compute vs the plain twin of its own order (dt u out of the sum,
# B C once, exp2 of dt A log2 e): the fp32 sums agree to ~1e-6 of their
# terms (ex2.approx against exp2), so y lands within one step of its type
# of the twin's: rtol 2^-7 in bf16 (a bf16 step), 1e-5 in fp32; atol 1e-5
# x max|twin|
CALIB_TWIN_TOL = {"bf16": (2.0 ** -7, 1e-5), "fp32": (1e-5, 1e-5)}
# the ragged calibration cases, G 8 over K 4, each with an odd Dm (a half
# pair at the channel tail) and L not a multiple of the chooser's T (pad
# rows, the last row tile cut short): N 24 (states past the 16 the kernel
# keeps in registers) at L 300 over T 152, and N 5 (zero-padded states)
# at L 49 over T 56
CALIB_RAGGED = (dict(G=8, L=300, Dm=95, N=24), dict(G=8, L=49, Dm=33, N=5))
# the calibration's one pass, by the name torch.profiler gives it
CALIB_SPLIT = {"kernel": "calib_kernel"}
# phase 13 runs the bench's --calibrate at its default --iters
CALIB_BENCH_ITERS = 20
# exps per second at the MUFU rate: 16 per clock per SM, 132 SMs, 1.98 GHz
# (the H100 SXM's boost clock)
MUFU_PER_S = 16 * 132 * 1.98e9
# MedSSD's stages on the fused dirs path at 224x224: (L, chunk l, H4,
# d_ssm, gn); P 64, gn 128 (N 512).  Stages 2-3 take the einsum path
SSD_P, SSD_GN = 64, 128
SSD_STAGES = ((3136, 224, 8, 128, SSD_GN), (784, 196, 16, 256, SSD_GN))
# the same stages at gn 16 (N 64: d_state 16 coupled over the four
# directions), where cnn_mamba, cnn_mamba_mifa, kanin_ssd, kanout_ssd and
# the medssd KAN heads take the dirs kernels at 224x224
SSD16_GN = 16
SSD16_STAGES = tuple(c[:4] + (SSD16_GN,) for c in SSD_STAGES)
# the dirs kernel's cases: those stages, and MedSSD's stage 0 at 240x240
# (L 3600, chunk 240, nc 15)
SSD_CASES = SSD_STAGES + ((3600, 240, 8, 128, SSD_GN),) + SSD16_STAGES
# and the CrossMamba family's new dirs shapes, each at its batch (the
# sixth term; BATCH where there is none): cross_cls_4ef's fusions at
# stages 0-1 (H4 16 at l 224, H4 32 at l 196, B 8), vfefm's 64x64 blocks
# and fusions (l 256, nc 16, H4 8 and 16) and 32x32 fusions (nc 4, H4 32)
# at B 2
SSD_CASES += ((3136, 224, 16, 256, SSD_GN, 8), (784, 196, 32, 512, SSD_GN, 8),
              (4096, 256, 8, 128, SSD_GN, 2), (4096, 256, 16, 256, SSD_GN, 2),
              (1024, 256, 32, 512, SSD_GN, 2))
# SSD kernels vs plain twin: |k - p| <= atol x max|p| + rtol |p|.  fp32
# differs in summation order (sums of up to l + N products); bf16 also
# where a rounded operand (M, dtx, S) or output lands one bf16 step from
# the plain twin's, the same rounding points on both sides
SSD_TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 2e-2)}
SSD_GRAD_TOL = {"fp32": (3e-3, 3e-3), "bf16": (6e-2, 3e-2)}
SSD_GRAD_NAMES = ("dstack", "dacum", "ddte", "dcdec", "ddtp", "dD")
MEDSSD_240 = 240                                    # PATHS says what runs
# the SSD models at d_state 16 (N 64): the two driven through the full
# eval and training phases, the seven given one eval forward and one train
# step, the two KAN heads re-gridded on the card
SSD16_FULL = ("cnn_mamba_mifa", "kanin_ssd")
SSD16_STEP = ("cnn_mamba", "kanout_ssd", "medssd_ekan", "medssd_okan",
              "medssd_kan", "medssd_kanmodule", "medssd_3kan")
SSD16_REGRID = ("medssd_ekan", "medssd_okan")
# a re-grid refits the head's splines to the batch by ridge least squares,
# which keeps its function up to the fit's residual: the logits on that
# batch move by at most this share of max|logit| (phases 25-26 read
# 1.4e-05 for the ekan head and 8.3e-05 for the okan head on an H100)
REGRID_TOL = 1e-3
# the card's re-grid (fp32) against the same re-grid in fp64 on the host,
# from the same head inputs and weights: the knots within this share of
# each input's knot span, the refit head's output on those inputs within
# this share of its max|y|
REFIT_GRID_TOL, REFIT_TOL = 1e-5, 1e-4
# their SSD core at stages 0-1 at 224x224 (side, d_ssm; H4 = 4 d_ssm / 64):
# phase 2r times the dirs path against the einsum path (Y_diag at stage 0)
SSD16_CORE = ((56, 128), (28, 256))
# The CrossMamba family (blocks and fusions at d_state 128: N 512).  The
# cross classifiers at 224x224, batch 8 (the JAX bench's batch for
# cross_cls_stage3); the fusion U-Nets at 256x256, batch 2 (the fusion
# trainer's), through its CLIs on FUSION_PAIRS generated pairs for
# FUSION_EPOCHS epochs, written under FUSION_DIR.  {forward kernel:
# launches per forward}: the dirs kernels at the 56/28 sides (64/32 for
# the U-Nets) in every block (one call a branch) and every CrossMamba
# fusion there (two calls), Y_diag at N 512 at the U-Nets' 16x16, the
# einsums below (tests/test_torch_kernel_reach.py pins each call site)
CROSS_BATCH, FUSION_SIZE, FUSION_BATCH = 8, 256, 2
FUSION_PAIRS, FUSION_EPOCHS = 8, 1
# the U-Nets' gates against the float64 step (phases 30-32) build their
# models one block a stage, encoder and decoder, at full width: every kind
# of block at every stage's width, a fraction of the float64 plain scans
GATE_DEPTHS = dict(depths=(1, 1, 1, 1), depths_decoder=(1, 1, 1, 1))
FUSION_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_fusion")
CROSS_PATHS = {
    # the blocks of stages 0-1 in both branches; the fusion after stage 3
    # (L 196) on the einsums
    "cross_cls_stage3": {"ssd_fused_dirs_fwd": 2 * (2 + 2)},
    "cross_cls_3e1fadd1e": {"ssd_fused_dirs_fwd": 2 * (2 + 2)},
    # and the fusions of stages 0-1
    "cross_cls_4ef": {"ssd_fused_dirs_fwd": 2 * (2 + 2) + 2 * 2},
    # encoder 2-2-4-2 and decoder 2-9-2-2, both branches and a fusion at
    # every stage: dirs at encoder stages 0-1 and decoder stages 1-3, Y_diag
    # at encoder stage 2 and decoder stage 0
    "vfefm_2b2": {"ssd_fused_dirs_fwd": 2 * (2 + 2 + 9 + 2 + 2) + 2 * 5,
                  "ssd_ydiag_fwd": 2 * (4 + 2) + 2 * 2},
    # one decoder stream, no decoder fusions
    "vfefm_2c1": {"ssd_fused_dirs_fwd": 2 * (2 + 2) + 2 * 2 + (9 + 2 + 2),
                  "ssd_ydiag_fwd": 2 * 4 + 2 + 2},
    # FusionMamba: the Mamba-1 scan (K 4) in every block of the encoder
    # (2-2-9-2, run on both inputs) and the decoder (2-9-2-2) and in the
    # cross blocks of stages 1-3 (stage 0's output is never read)
    "fusionmamba": {"selective_scan_fwd": 2 * 15 + 3 + 15},
}
CROSS_FULL, CROSS_STEP = "cross_cls_stage3", ("cross_cls_4ef",
                                              "cross_cls_3e1fadd1e")
# The evaluation tools (phases 33-35), under EVAL_DIR.  --all-index: its
# CSV header, the JAX CLI's; ALL_INDEX_PER_CLASS generated images a class
# (40 at 224x224: a batch of 32 and a padded one).  Grad-CAM over all four
# stages at CAM_BATCH, 224x224, fp32 (the JAX CLI's dtype): ({forward
# kernel: launches}, {backward kernel: launches}) of one grad_cam call, the
# forward kernels of every stage and the backward kernel of each call in
# stages 1-3 (the gradient stops at stage 0's output;
# tests/test_torch_gradcam.py pins them from a meta forward); its heatmaps
# on the kernels against the plain twins within CAM_TOL on the [0, 1] map,
# each stage's map spanning more than CAM_MIN_SPAN.  Export at EXPORT_BATCH,
# bf16 (the JAX CLI's defaults) of each (model, size) in EXPORT_CASES, which
# together carry the six forward ops; the loaded program's logits against
# the eager model's within EXPORT_TOL x max|logit|
EVAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_eval")
ALL_INDEX_COLUMNS = ("accuracy", "precision_macro", "recall_macro",
                     "specificity_macro", "f1_macro", "auc_ovr_macro",
                     "param_count", "model")
ALL_INDEX_PER_CLASS, ALL_INDEX_AUC_TOL = 5, 1e-3
CAM_BATCH, CAM_TOL, CAM_MIN_SPAN = 8, 2e-3, 1e-3
# the seeded models' head weight is scaled by this for grad_cam: the init's
# (trunc-normal 0.02) gives medmamba stage maps that span ~5e-5 at stage 0
# (on an NVIDIA H100 80GB HBM3 at 700 W), where the min-max scaling
# magnifies rounding
CAM_HEAD_SCALE = 100.0
CAM_PATHS = {
    "medmamba": ({"selective_scan_fwd": SCAN_CALLS_PER_FORWARD},
                 {"selective_scan_bwd": 4 * (2 + 4 + 2)}),
    # the dirs SSD in the blocks of stages 0-1, backward at stage 1
    "medssd": ({"ssd_fused_dirs_fwd": 2 + 2}, {"ssd_fused_dirs_bwd": 2}),
    # Y_diag at stage 0 only; the mixer and the gate at stages 0-1
    "st_ssd": ({"ssd_ydiag_fwd": 2, "stl_mixer_fwd": 4, "stf_zgate_fwd": 4},
               {"stl_mixer_bwd": 2, "stf_zgate_bwd": 2}),
}
EXPORT_BATCH, EXPORT_TOL = 8, 1e-3
EXPORT_CASES = (("medmamba", SIZE), ("medssd", MEDSSD_240), ("st_ssd", SIZE))
# the single-layout fused SSD's cases (B, L, chunk l, H, N), P 64: MedSSD
# 240x240 stage 1, padded as ssd_chunked pads it, and an in-window shape
# at the bottom of the chunk window with N 128
FUSED_CASES = ((BATCH, 900, 256, 16, 512), (8, 784, 196, 8, 128))
FUSED_GRAD_NAMES = ("dC", "dB", "dacum", "ddte", "dcdec", "ddtp", "dx")
# ST-SSD at 224x224 (d_state 16, N = 4 x 16 = 64, headdim 64): the Y_diag
# kernel's stage-0 shape (BC = B x 14 chunks, l 224, H 8 heads over the
# four directions); the (L = P, C) of the STL mixer (BB = 4 B, the
# directions folded in) and the STF gate (BB = B) at stages 0-1
ST_YDIAG = (BATCH * 14, 224, 8, 64, 64)             # BC, l, H, N, P
# Y_diag's cases (BC, l, H, N, P, L): ST-SSD's stage 0; at N 512 MedSSD's
# stage 2 at 240x240 (one chunk of 232 for L 225) and the shape MedSSD's
# stage 3 at 512x512 (and the fusion U-Nets) reach
YDIAG_CASES = (ST_YDIAG + (3136,), (BATCH, 232, 32, 512, 64, 225),
               (BATCH, 256, 64, 512, 64, 256),
               # vfefm's 16x16 stages at B 2: the blocks (H 32), the
               # fusions (H 64)
               (2, 256, 32, 512, 64, 256), (2, 256, 64, 512, 64, 256))
ST_STAGES = ((3136, 128), (784, 256))
# ST kernels vs plain: |k - p| <= atol x max|p| + rtol |p|.  fp32 differs
# in summation order (sums of up to 3136 products; the mixer's softmax
# sum also rescales online); bf16 also where a rounded operand (M, E, Z)
# or output lands one bf16 step from the plain version's, the same
# rounding points on both sides
ST_TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 2e-2)}
# their backward kernels vs the plain backwards, every cotangent, within
# the dirs SSD backward's tolerances: fp32 differs in summation order
# (dacum is a difference of row and column sums of G, du1 and dlz sum over
# the batch too); bf16 also where a rounded operand (M, E, dS, Z) or output
# lands one bf16 step away
ST_GRAD_TOL = SSD_GRAD_TOL
ST_GRAD_NAMES = {"ssd_ydiag": ("dCc", "dBc", "dacum", "ddtx"),
                 "stl_mixer": ("dw", "du1", "dV"),
                 "stf_zgate": ("dpooledT", "dlz", "dU")}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes
# per second, and operations per second by operand type (bf16 products on
# the tensor cores; fp32 on the CUDA cores, as the kernels and the plain
# versions compute fp32 without TF32)
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
# forward kernel vs plain, per element: |k - p| <= atol + rtol * |p|
TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 5e-2)}
# backward kernel vs plain, all seven gradients (rtol, atol): the ladder of
# tests/test_pallas_scan.py::test_pallas_production_grads.  fp32 differs
# only in summation order; bf16 is looser because du, dΔ, dB and dC are
# rounded to bf16 on both sides, and where the two fp32 sums straddle a
# rounding midpoint they land one bf16 step (2^-8 relative) apart
GRAD_TOL = {"fp32": (3e-3, 3e-3), "bf16": (6e-2, 1e-1)}
GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
# full-model logits, kernel scan vs plain scan (same weights and inputs):
# fp32 differs only in summation order and exp; bf16 also where a scan
# output rounds to the other neighbouring bf16 value, carried through 10
# blocks
LOGIT_TOL = {"fp32": 2e-3, "bf16": 5e-2}
# full-model parameter gradients in fp32, kernel scan vs plain scan,
# leaf-wise (rel-norm, cosine, abs floor) as
# tests/test_reference_grad_parity.py:70
PARAM_GRAD_TOL = (2e-2, 0.998, 2e-4)
# In bf16 the two paths round activations to bf16 at the same places but
# land one bf16 step apart where their fp32 sums straddle a midpoint; that
# noise compounds through 10 blocks and the backward (a first run measured
# leaf rel-norm 0.30 between the two bf16 paths at the patch embed).  So
# each bf16 path is held against the fp32 plain gradients, and the kernels'
# median per-leaf rel-norm distance may be at most this many times the
# plain scan's (plus 1e-3): a faulty bf16 kernel lands O(1) away.  The
# median, because leaves whose true gradient is ~0 (the conv biases that
# feed a BatchNorm) have relative distances of 1e2-1e4 on both paths
BF16_GRAD_RATIO = 1.5
# The fusion U-Nets' fp32 parameter gradients at full width are
# ill-conditioned: against the same step in float64, both fp32 paths (the
# kernels and their plain twins) miss PARAM_GRAD_TOL on hundreds of
# vfefm_2c1's leaves (the D skips, the fusions' B/C/dt weights, most
# leaves upstream of the 16x16 stages), with the Y_diag kernel or its twin
# alike and with the BatchNorm variance in one pass or two (an H100).  So
# both fp32 paths are held against the float64 gradient
# (``_check_grad_tree_exact``): on every leaf the kernels' rel-norm error
# may be at most PARAM_GRAD_TOL's plus COND_RATIO x the plain twins' own
# on that leaf, which is the plain gate where the plain twins are exact; a
# faulty kernel lands O(1) away.  The gradients are taken of two losses,
# the fusion step's and the smooth mean of the fused image (no clamp).
# A gate whose leaves all lie under its abs floor checks nothing: it raises
COND_RATIO = 2.0
GRAD_BATCH = 4
# A model's gradient check at fewer blocks where its plain path is slow:
# medmamba's plain scan walks each sequence step by step, and at depths
# 2-2-4-2 the check took most of phase 4; one block a stage keeps the
# widths, the data and every kind of block, as the fusion models' float64
# gates do (GATE_DEPTHS)
GRAD_DEPTHS = {"medmamba": dict(depths=(1, 1, 1, 1))}
# The Mamba-1 LM at mamba-130m width (models/mamba_lm.py MambaConfig's
# defaults: d_model 768, 24 layers, vocab 50277 padded to 50280, d_state
# 16, expand 2), fp32: scoring LM_BATCH x LM_LEN tokens; the gradient check
# at LM_GRAD_LAYERS layers on LM_GRAD_BATCH x LM_GRAD_LEN tokens; greedy
# generation of GEN_NEW tokens after GEN_PROMPTS prompts of GEN_PROMPT_LEN
LM_BATCH, LM_LEN, LM_LAYERS, LM_DINNER = 8, 2048, 24, 1536
LM_GRAD_BATCH, LM_GRAD_LEN, LM_GRAD_LAYERS = 2, 1024, 4
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 4, 64, 32
# the scan's flag cases (name, K, G, L, Dm): the LM's layer call (one
# group, G = batch) and MedMamba's stage 0 with its four directions as
# groups (G = 8 images x K 4)
FLAG_CASES = (("lm", 1, LM_BATCH, LM_LEN, LM_DINNER),
              ("medmamba0", 4, 32, 3136, 96))
# FusionMamba (fusion registry "fusionmamba") at 256x256, batch 2: its
# four strided sub-sequences folded into the sequence axis, G = 2 x 4 with
# the parameter group k = g % 4 (A, D and the dt bias per k); phases 2 and
# 2b check the scan pair at its stage-0 and stage-3 shapes (L / 4, Dm)
FM_G = 4 * FUSION_BATCH
FM_STAGES = ((1024, 192), (16, 1536))
# the parameters stage 0's cross block holds but nothing reads (the decoder
# adds the fused skips of stages 3-1): they get no gradient and stay put
FM_UNUSED = ("Cross_block.0.",)
# LM logits with the kernels vs the plain scan: |k - p| <= tol x max|p|
LM_LOGIT_TOL = 2e-3


def _events_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device_and_build():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    from medical_image_classification_tpu_torch.kernels import _build
    with ThreadPoolExecutor(len(KERNELS)) as pool:       # one nvcc each
        results = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    parts = []
    for name, res in results.items():
        _build.library(name)
        ptxas = [" ".join(ln.split()) for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        parts.append(f"{name} built in {res.seconds:.2f} s -> "
                     f"{res.path.name}; ptxas: "
                     f"{' / '.join(ptxas) or 'cached build'}")
    print(f"phase 1 device+build: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | " + " | ".join(parts), flush=True)
    return card


def _scan_cases(stages=None):
    """The 16 stage cases, then FusionMamba's 4: (L, Dm, dtype name,
    reverse, args, G), args the folded scan's (u, delta, A, B, C, D, bias)
    on the card.  MedMamba's stages at G 32 with one parameter group (K 1)
    and A its S4D-real init, forward and reverse; FusionMamba's stages 0
    and 3 (FM_STAGES) at G 8 with K 4, forward (its only order), A = -U(1,
    16), D and the bias drawn per group and channel.  ``stages``: other
    (L, Dm, G, K) cases in their place."""
    import torch
    dev = torch.device("cuda")
    stages = stages or [(L, Dm, G, 1) for L, Dm in STAGES] + [
        (L, Dm, FM_G, 4) for L, Dm in FM_STAGES]
    for i, (L, Dm, g, K) in enumerate(stages):
        gen = torch.Generator(device=dev).manual_seed(i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        base = dict(u=rnd(g, L, Dm), delta=0.5 * rnd(g, L, Dm),
                    B=rnd(g, L, N), C=rnd(g, L, N))
        if K == 1:
            # MedMamba's S4D-real init: A = -(1..N) for every channel
            A = -torch.arange(1, N + 1, device=dev,
                              dtype=torch.float32).expand(1, Dm,
                                                          N).contiguous()
        else:
            A = -1.0 - 15.0 * torch.rand(K, Dm, N, device=dev, generator=gen)
        D = rnd(K, Dm)
        bias = 0.1 * rnd(K, Dm)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            act = {k: v.to(dtype) for k, v in base.items()}
            for reverse in (False, True)[:2 if K == 1 else 1]:
                yield L, Dm, dt_name, reverse, (
                    act["u"], act["delta"], A, act["B"], act["C"], D,
                    bias), g


def _check_close(what, got, want, rtol, atol):
    """|got - want| <= atol + rtol |want| everywhere, and finite; returns
    the max abs error."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(got).all()) or \
            bool((diff > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{what}: max err {err:.3e} outside rtol={rtol} "
                             f"atol={atol}")
    return err


def phase_kernel_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as fwd)
    cases = []
    for L, Dm, dt_name, reverse, args, g in _scan_cases():
        run_k = lambda: fwd.scan_folded_fwd(*args, reverse=reverse,
                                            impl="cuda")
        run_p = lambda: fwd.scan_folded_fwd_ref(*args, reverse=reverse)
        yk = run_k()
        yk2, xk = fwd._launch_cuda(*args, reverse, True, want_xsave=True)
        yp, xp = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                         want_xsave=True)
        torch.cuda.synchronize()
        K = args[2].shape[0]
        what = f"forward kernel vs plain G={g} K={K} L={L} Dm={Dm} " \
               f"{dt_name} reverse={reverse}"
        if not torch.equal(yk, yk2):
            raise AssertionError(f"{what}: y changes when xsave is written")
        rtol, atol = TOL[dt_name]
        err = _check_close(what + " y", yk, yp, rtol, atol)
        xerr = _check_close(what + " xsave", xk, xp, rtol, atol)
        k_ms = _events_ms(run_k, 20)
        xs_ms = _events_ms(lambda: fwd._launch_cuda(
            *args, reverse, True, want_xsave=True), 20)
        p_ms = _events_ms(run_p, 2)
        cases.append(dict(L=L, Dm=Dm, G=g, K=K, dtype=dt_name,
                          reverse=reverse, max_abs_err=err, xsave_err=xerr,
                          ms=k_ms, xsave_ms=xs_ms, plain_ms=p_ms,
                          bound=_scan_bound(L, Dm, dt_name, False, g),
                          warps_per_sm=_occupancy_text(dt_name, False)))
        if K == 1:
            _walk_split(cases[-1], run_k, SCAN_FWD_SPLIT)
    worst = {d: max(c["max_abs_err"] for c in cases if c["dtype"] == d)
             for d in TOL}
    xworst = {d: max(c["xsave_err"] for c in cases if c["dtype"] == d)
              for d in TOL}
    summary = "; ".join(
        f"G{c['G']} K{c['K']} {c['L']}x{c['Dm']} {c['dtype']} "
        f"{'rev' if c['reverse'] else 'fwd'}"
        f" err={c['max_abs_err']:.2e} xsave_err={c['xsave_err']:.2e} "
        f"kernel={c['ms']:.4f}ms with_xsave={c['xsave_ms']:.4f}ms "
        f"plain={c['plain_ms']:.2f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}) {c['warps_per_sm']}{_split_text(c)}"
        for c in cases)
    print(f"phase 2 forward kernel vs plain: {len(cases)}/20 cases within "
          f"tolerance, y and xsave (worst y fp32 {worst['fp32']:.2e}, bf16 "
          f"{worst['bf16']:.2e}; xsave fp32 {xworst['fp32']:.2e}, bf16 "
          f"{xworst['bf16']:.2e}; MedMamba's stages at G={G} K=1, "
          f"FusionMamba's stages 0 and 3 at G={FM_G} K=4; N={N}) | passes "
          f"(chunk from zero, "
          f"carry, final): {_passes_text(False)} | {summary}", flush=True)
    return cases


def phase_bwd_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as bwd, selective_scan_fwd as fwd)
    cases = []
    for L, Dm, dt_name, reverse, args, g in _scan_cases():
        _, xsave = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                           want_xsave=True)
        gen = torch.Generator(device="cuda").manual_seed(L + reverse)
        dy = torch.randn(args[0].shape, device="cuda",
                         generator=gen).to(args[0].dtype)
        run_k = lambda: bwd.scan_folded_bwd(*args, xsave, dy,
                                            reverse=reverse, impl="cuda")
        run_p = lambda: bwd.scan_folded_bwd_ref(*args, xsave, dy,
                                                reverse=reverse)
        gk, gk2, gp = run_k(), run_k(), run_p()
        torch.cuda.synchronize()
        K = args[2].shape[0]
        what = f"backward kernel vs plain G={g} K={K} L={L} Dm={Dm} " \
               f"{dt_name} reverse={reverse}"
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        rtol, atol = GRAD_TOL[dt_name]
        errs = {nm: _check_close(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(GRAD_NAMES, gk, gp)}
        k_ms = _events_ms(run_k, 10)
        p_ms = _events_ms(run_p, 1)
        cases.append(dict(L=L, Dm=Dm, G=g, K=K, dtype=dt_name,
                          reverse=reverse, errs=errs,
                          max_abs_err=max(errs.values()), ms=k_ms,
                          plain_ms=p_ms,
                          bound=_scan_bound(L, Dm, dt_name, True, g),
                          warps_per_sm=_occupancy_text(dt_name, True)))
        if K == 1:
            _walk_split(cases[-1], run_k, SCAN_BWD_SPLIT)

    # ScanFolded (kernels) against torch.autograd through the plain forward
    L, Dm, dt_name, reverse, args, _ = next(
        c for c in _scan_cases() if c[0] == STAGES[2][0]
        and c[2] == "fp32" and c[3])
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dy = torch.randn(args[0].shape, device="cuda", generator=gen)
    fwd.scan_folded_fwd(*leaves, reverse=reverse, impl="cuda").backward(dy)
    got = [a.grad for a in leaves]
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(
        fwd.scan_folded_fwd_ref(*leaves, reverse=reverse), leaves, dy)
    rtol, atol = GRAD_TOL[dt_name]
    auto_err = max(_check_close(f"ScanFolded vs autograd {nm}", a, b, rtol,
                                atol)
                   for nm, a, b in zip(GRAD_NAMES, got, want))

    summary = "; ".join(
        f"G{c['G']} K{c['K']} {c['L']}x{c['Dm']} {c['dtype']} "
        f"{'rev' if c['reverse'] else 'fwd'}"
        f" err={c['max_abs_err']:.2e} kernel={c['ms']:.4f}ms "
        f"plain={c['plain_ms']:.1f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}) {c['warps_per_sm']}{_split_text(c)}"
        for c in cases)
    print(f"phase 2b backward kernel vs plain: {len(cases)}/20 cases within "
          f"fp32 {GRAD_TOL['fp32']} bf16 {GRAD_TOL['bf16']} (rtol, atol) on "
          f"all 7 gradients (dA, dD, dbias summed per group), second launch "
          f"bit-identical | ScanFolded vs "
          f"torch.autograd through the plain forward at {L}x{Dm} fp32 rev: "
          f"max err {auto_err:.2e} | passes (local adjoint from zero, carry, "
          f"final, partial sums): {_passes_text(True)} | {summary}",
          flush=True)
    return dict(cases=cases, autograd_err=auto_err)


def _ssd_cases(cases=SSD_CASES):
    """The dirs SSD's cases, SSD_CASES (or ``cases``) in fp32 and bf16: (L,
    l, dtype name, args, d_ssm, dy, gn), args the kernel's (stackr, acum,
    dte, cdec, dtp, Dsk) on the card, built as ssd_chunked_dirs builds them
    (dtp a softplus, acum its cumsum against A = -U(1, 4))."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    for i, (L, l, H4, d_ssm, gn, *batch) in enumerate(cases):
        B = batch[0] if batch else BATCH
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        nc = L // l
        C2 = 2 * (d_ssm + 2 * gn + H4 // 4)
        stack = 0.5 * rnd(B, nc, l, C2)
        dtp = F.softplus(0.5 * rnd(B, nc, H4, l) - 3.0)
        A = -(1.0 + 3.0 * torch.rand(H4, device=dev, generator=gen))
        acum = torch.cumsum(dtp * A[:, None], dim=-1)
        dte = torch.exp(acum[..., -1:] - acum)
        cdec = torch.exp(acum[..., -1])
        D = 2.0 * torch.rand(H4, device=dev, generator=gen) - 1.0
        dy = rnd(B, nc, l, H4 * SSD_P)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield L, l, dt_name, (stack.to(dtype).contiguous(), acum, dte,
                                  cdec, dtp, D), d_ssm, dy.to(dtype), gn


def _check_scaled(what, got, want, rtol, atol_rel):
    """|got - want| <= atol_rel max|want| + rtol |want|; returns the max
    abs error."""
    scale = max(float(want.float().abs().max()), 1e-30)
    return _check_close(what, got, want, rtol, atol_rel * scale)


# the passes of the SSD chunk walk in launch order (the gram pass is both
# directions'; the forward's split, and the backward's, SSD_WALK_SPLIT),
# and the passes of the scan kernels at bf16 and N 16, by the names
# torch.profiler gives them: {label: pattern}
SSD_GRAM = "tiles::gram_kernel"
SSD_FWD_KERNELS = ("fwd::prep_kernel", SSD_GRAM, "fwd::state_kernel",
                   "fwd::out_kernel")
SSD_BWD_KERNELS = ("bwd::prep_kernel", SSD_GRAM) + tuple(
    f"bwd::{p}_kernel" for p in ("intra", "state", "chunk", "flush"))
SSD_FWD_SPLIT = {k.split("::")[-1][:-len("_kernel")]: k
                 for k in SSD_FWD_KERNELS}
SSD_WALK_SPLIT = {k.split("::")[-1][:-len("_kernel")]: k
                  for k in SSD_BWD_KERNELS}
SCAN_FWD_SPLIT = {
    "chunk": "scan_fwd_chunk_kernel<__nv_bfloat16, 16, false>",
    "carry": "chunk_carry_kernel<false>",
    "final": "scan_fwd_chunk_kernel<__nv_bfloat16, 16, true>"}
SCAN_BWD_SPLIT = {"local": "bwd_local_kernel",
                  "carry": "chunk_carry_kernel<true>",
                  "final": "bwd_final_kernel", "sum": "bwd_sum_kernel"}
# all of the scan's passes, at any type and N (the model profiles)
SCAN_FWD_KERNELS = ("scan_fwd_chunk_kernel", "chunk_carry_kernel<false>")
SCAN_BWD_KERNELS = tuple(SCAN_BWD_SPLIT.values())
# the Mamba-1 models' profiles (medmamba, fusionmamba): the scan pair
SCAN_SPLIT = {"scan forward": SCAN_FWD_KERNELS,
              "scan backward": SCAN_BWD_KERNELS}
# the STL mixer's two passes, forward and backward
STL_FWD_SPLIT = {"rows": "mixer_fwd_rows_kernel",
                 "cols": "mixer_fwd_cols_kernel"}
STL_BWD_SPLIT = {"rows": "mixer_bwd_rows_kernel",
                 "cols": "mixer_bwd_cols_kernel"}
# the STF gate's passes: the forward's one, the backward's two
STF_FWD_SPLIT = {"rows": "zgate_fwd_rows_kernel"}
STF_BWD_SPLIT = {"rows": "zgate_bwd_rows_kernel",
                 "cols": "zgate_bwd_cols_kernel"}
# Y_diag's passes: the forward's rows strip; the backward's SSD walk intra
# pass, columns strip and walk flush pass (the walk's two over YDiagLayout,
# which no other path instantiates)
YDIAG_FWD_SPLIT = {"rows": "ssd_ydiag::rows_kernel"}
YDIAG_BWD_SPLIT = {"intra": "bwd::intra_kernel",
                   "cols": "ssd_ydiag::cols_kernel",
                   "flush": "bwd::flush_kernel"}
# the same in a model's profile, beside the walks of the other layouts
YDIAG_SHARES = {"ssd ydiag": tuple(YDIAG_FWD_SPLIT.values()),
                "ssd ydiag backward": ("ssd_ydiag::cols_kernel",
                                       "YDiagLayout")}
# the CrossMamba models' profiles: the dirs walks by their layout, and
# Y_diag's passes (in fp32 its backward is the first port's two passes)
CROSS_SPLIT = {"ssd dirs": ("DirsLayout",)}
FUSION_SPLIT = {**CROSS_SPLIT,
                "ssd ydiag": tuple(YDIAG_FWD_SPLIT.values()),
                "ssd ydiag backward": ("ssd_ydiag::cols_kernel",
                                       "YDiagLayout", "f32::grad_kernel",
                                       "f32::dcb_kernel")}


def _walk_split(c, fn, names=SSD_WALK_SPLIT):
    """At a bf16 case, c["split"]: device ms of each kernel ``names`` lists
    (by default the SSD chunk walk backward's passes) in one call of
    ``fn``, each kernel launched once a call: the mean over the launches a
    profile of two calls recorded.  In full smoke runs such a window has
    missed the kernels launched right after it opened (a call's first
    kernel; both launches of a one-kernel call), so each window opens
    with 2 ms of host sleep, a kernel still missing is profiled again over
    twice the calls, up to 8, and one missing then is listed in
    c["unrecorded"]."""
    if c["dtype"] != "bf16":
        return
    calls = 2
    while True:
        rows = [r for r in _profile(lambda: (time.sleep(0.002), [
            fn() for _ in range(calls)])) if r["device_us"] > 0.0]
        c["split"] = {k: sum(r["device_us"] / r["count"] for r in rows
                             if p in r["name"]) / 1e3
                      for k, p in names.items()
                      if any(p in r["name"] for r in rows)}
        if len(c["split"]) == len(names) or calls >= 8:
            break
        calls *= 2
    missing = [k for k in names if k not in c["split"]]
    if missing:
        c["unrecorded"] = missing


@functools.lru_cache(maxsize=None)
def _ssd_passes(kernel):
    """What the card grants each pass of the SSD walk or of Y_diag as
    ``kernel`` (a forward, *_fwd, or a backward) builds it: {dtype: {pass:
    {registers, local_bytes, shared_bytes, warps_per_sm}}}."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused, ssd_ydiag)
    fwd = kernel.endswith("fwd")
    if kernel.startswith("ssd_ydiag"):
        fn = ssd_ydiag.fwd_pass_info if fwd else ssd_ydiag.bwd_pass_info
        info = fn
    else:
        fn = ssd_fused.fwd_pass_info if fwd else ssd_fused.bwd_pass_info
        info = functools.partial(fn, kernel)
    keys = ("registers", "local_bytes", "shared_bytes", "warps_per_sm")
    return {dt: {p: dict(zip(keys, v)) for p, v in info(dtype).items()}
            for dt, dtype in (("fp32", torch.float32),
                              ("bf16", torch.bfloat16))}


def _sass_mma(kernel, pattern, exempt=()):
    """{dtype: {pass: HMMA/HGMMA instructions}} in the SASS of the built
    library ``kernel`` (``cuobjdump -sass``), or None without cuobjdump; a
    function's pass is ``pattern``'s groups in its mangled name, joined by
    " C".  Raises if a bf16 pass outside ``exempt`` has none: its products
    belong on the tensor cores."""
    import re
    import shutil
    from medical_image_classification_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build.build(kernel).path)],
                          capture_output=True, text=True, check=True).stdout
    out = {"fp32": {}, "bf16": {}}
    fn = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            mp = re.search(pattern, fn)
            dt = "bf16" if "bfloat16" in fn else "fp32"
            key = (dt, " C".join(mp.groups())) if mp else None
            if key:
                out[dt][key[1]] = 0
        elif fn and key and ("HMMA" in ln or "HGMMA" in ln):
            out[key[0]][key[1]] += 1
    bare = [p for p, n in out["bf16"].items() if p not in exempt and n == 0]
    if bare:
        raise AssertionError(f"{kernel}: bf16 passes {bare} run no HMMA")
    return out


@functools.lru_cache(maxsize=None)
def _ssd_mma(kernel):
    """The SSD walk's passes, forward or backward (all but prep compute
    products; the gram pass is in namespace tiles), and Y_diag's: the
    strip passes (namespace ssd_ydiag), the walk's intra and flush, and in
    fp32 the backward's grad and dcb (namespace f32)."""
    return _sass_mma(kernel, r"(?:8ssd_walk(?:3fwd|3bwd|5tiles)|9ssd_ydiag|3f32)"
                     r"\d+(\w+?)_kernel", ("prep",))


@functools.lru_cache(maxsize=None)
def _stl_mma(kernel):
    """The STL mixer's or the STF gate's passes, by pass and C (every one
    computes products)."""
    return _sass_mma(kernel,
                     r"(?:mixer|zgate)_\w+?_(rows|cols)_kernelI\w*?Li(\d+)E")


def _mma_text(mma):
    if mma is None:
        return "HMMA per pass: cuobjdump not found"
    return "HMMA per pass (cuobjdump -sass): " + "; ".join(
        f"{dt} " + ", ".join(f"{p} {n}" for p, n in mma[dt].items())
        for dt in ("bf16", "fp32"))


@functools.lru_cache(maxsize=None)
def _stl_passes(kernel):
    """What the card grants each pass of the STL mixer or STF gate kernel
    ``kernel`` ("stl_mixer_fwd", "stl_mixer_bwd", "stf_zgate_fwd" or
    "stf_zgate_bwd") at both ST stages' C: {dtype: {"C128" | "C256":
    {pass: {registers, local_bytes, shared_bytes, warps_per_sm}}}}."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        stf_zgate as stf, stl_mixer as stl)
    mod = stf if kernel.startswith("stf") else stl
    info = mod.fwd_pass_info if kernel.endswith("fwd") else mod.bwd_pass_info
    keys = ("registers", "local_bytes", "shared_bytes", "warps_per_sm")
    return {dt: {f"C{C}": {p: dict(zip(keys, v))
                           for p, v in info(C, dtype).items()}
                 for _, C in ST_STAGES}
            for dt, dtype in (("fp32", torch.float32),
                              ("bf16", torch.bfloat16))}


def _stl_passes_text(kernel):
    return "passes (registers/local B/shared B/warps per SM): " + "; ".join(
        f"{dt} {cn} " + ", ".join(f"{p} " + "/".join(map(str, v.values()))
                                 for p, v in passes.items())
        for dt, by_c in _stl_passes(kernel).items()
        for cn, passes in by_c.items())


def _ssd_mma_text(kernel):
    return _mma_text(_ssd_mma(kernel))


def _ssd_passes_text(kernel):
    return "passes (registers/local B/shared B/warps per SM): " + "; ".join(
        f"{dt} " + ", ".join(f"{p} " + "/".join(map(str, v.values()))
                             for p, v in passes.items())
        for dt, passes in _ssd_passes(kernel).items())


def _split_text(c):
    return "" if "split" not in c else " split " + " ".join(
        [f"{k}={v:.3f}ms" for k, v in c["split"].items()]
        + [f"{k}=not recorded" for k in c.get("unrecorded", ())])


def _fwd_case(what, run_k, run_save, run_p, dt_name):
    """One forward case of 2c or 2k: y and Ssave against the plain twin
    within SSD_TOL, y the same bits with and without Ssave, a second
    launch bit-identical (y and Ssave), times from CUDA events."""
    import torch
    yk, yk2 = run_k(), run_k()
    yk3, Sk = run_save()
    yk4, Sk2 = run_save()
    yp, Sp = run_p(want_save=True)
    torch.cuda.synchronize()
    if not (torch.equal(yk, yk2) and torch.equal(yk, yk3)
            and torch.equal(yk3, yk4) and torch.equal(Sk, Sk2)):
        raise AssertionError(f"{what}: y or Ssave differs between launches "
                             "or y when Ssave is written")
    rtol, atol = SSD_TOL[dt_name]
    err = _check_scaled(what + " y", yk, yp, rtol, atol)
    serr = _check_scaled(what + " Ssave", Sk, Sp, rtol, atol)
    y_max = float(yp.float().abs().max())
    del yk, yk2, yk3, yk4, Sk, Sk2, yp, Sp
    return dict(dtype=dt_name, max_abs_err=max(err, serr), y_err=err,
                ssave_err=serr, y_max=y_max, ms=_events_ms(run_k, 5),
                save_ms=_events_ms(run_save, 5),
                plain_ms=_events_ms(run_p, 2))


def _fwd_summary(c):
    return (f"{c['dtype']} err={c['y_err']:.2e} (max|y| {c['y_max']:.1f}) "
            f"Ssave_err={c['ssave_err']:.2e} kernel={c['ms']:.3f}ms "
            f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]}) "
            f"with_save={c['save_ms']:.3f}ms "
            f"bound={c['save_bound'][0]:.4f}ms ({c['save_bound'][1]}) "
            f"plain={c['plain_ms']:.2f}ms{_split_text(c)}")


def phase_ssd_fwd_vs_plain():
    """2c: the dirs SSD forward kernel vs its plain version, with and
    without Ssave (``_fwd_case``), each pass's split, grant and HMMA."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused_dirs as sfd)
    cases = []
    for L, l, dt_name, args, d_ssm, _, gn in _ssd_cases():
        run_k = lambda: sfd.ssd_fused_dirs_fwd(*args, d_ssm, gn,
                                               impl="cuda")
        c = _fwd_case(
            f"SSD forward kernel vs plain L={L} l={l} N={4 * gn} {dt_name}",
            run_k,
            lambda: sfd.ssd_fused_dirs_fwd(*args, d_ssm, gn,
                                           want_save=True, impl="cuda"),
            lambda **kw: sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, gn,
                                                    **kw), dt_name)
        N = 4 * gn
        c.update(L=L, l=l, N=N, B=args[0].shape[0], H4=args[1].shape[2],
                 bound=_ssd_bound(args, d_ssm, N, dt_name, False),
                 save_bound=_ssd_bound(args, d_ssm, N, dt_name, False, True))
        _walk_split(c, run_k, SSD_FWD_SPLIT)
        cases.append(c)
    summary = "; ".join(f"B{c['B']} {c['L']}/{c['l']} H4 {c['H4']} "
                        f"N{c['N']} " + _fwd_summary(c) for c in cases)
    print(f"phase 2c SSD dirs forward kernel vs plain: {len(cases)} cases "
          f"within {SSD_TOL} (rtol, atol x max|plain|), y and Ssave "
          f"(P={SSD_P} N={4 * SSD_GN} and {4 * SSD16_GN}), second "
          f"launch "
          f"bit-identical | {_ssd_passes_text('ssd_fused_dirs_fwd')} | "
          f"{_ssd_mma_text('ssd_fused_dirs_fwd')} | {summary}", flush=True)
    return cases


def phase_ssd_bwd_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused_dirs as sfd)
    cases = []
    for L, l, dt_name, args, d_ssm, dy, gn in _ssd_cases():
        _, Ssave = sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, gn,
                                              want_save=True)
        run_k = lambda: sfd.ssd_fused_dirs_bwd(*args, d_ssm, gn, Ssave,
                                               dy, impl="cuda")
        run_p = lambda: sfd.ssd_fused_dirs_bwd_ref(*args, d_ssm, gn,
                                                   Ssave, dy)
        gk, gk2, gp = run_k(), run_k(), run_p()
        torch.cuda.synchronize()
        what = (f"SSD backward kernel vs plain L={L} l={l} N={4 * gn} "
                f"{dt_name}")
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        rtol, atol = SSD_GRAD_TOL[dt_name]
        errs = {nm: _check_scaled(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(SSD_GRAD_NAMES, gk, gp)}
        k_ms = _events_ms(run_k, 3)
        p_ms = _events_ms(run_p, 1)
        cases.append(dict(L=L, l=l, N=4 * gn, B=args[0].shape[0],
                          H4=args[1].shape[2], dtype=dt_name, errs=errs,
                          max_abs_err=max(errs.values()), ms=k_ms,
                          plain_ms=p_ms,
                          bound=_ssd_bound(args, d_ssm, 4 * gn, dt_name,
                                           True)))
        _walk_split(cases[-1], run_k)

    # SSDFusedDirs (kernels) against torch.autograd through the plain
    # forward: at MedSSD's stage 1 in fp32, and at gn 16 at both stages in
    # fp32 and bf16
    auto = {}
    for L, l, dt_name, args, d_ssm, dy, gn in _ssd_cases():
        if not ((L, gn, dt_name) == (SSD_STAGES[1][0], SSD_GN, "fp32")
                or gn == SSD16_GN):
            continue
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        sfd.ssd_fused_dirs(*leaves, d_ssm, gn, impl="cuda").backward(dy)
        got = [a.grad for a in leaves]
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        want = torch.autograd.grad(
            sfd.ssd_fused_dirs_fwd_ref(*leaves, d_ssm, gn), leaves, dy)
        rtol, atol = SSD_GRAD_TOL[dt_name]
        auto[f"L{L} N{4 * gn} {dt_name}"] = max(
            _check_scaled(f"SSDFusedDirs vs autograd L={L} N={4 * gn} "
                          f"{dt_name} {nm}", a, b, rtol, atol)
            for nm, a, b in zip(SSD_GRAD_NAMES, got, want))
        del leaves, got, want
    auto_err = max(auto.values())
    summary = "; ".join(
        f"B{c['B']} {c['L']}/{c['l']} H4 {c['H4']} N{c['N']} {c['dtype']} "
        + " ".join(
            f"{k}={v:.2e}" for k, v in c["errs"].items())
        + f" kernel={c['ms']:.3f}ms plain={c['plain_ms']:.1f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]}){_split_text(c)}"
        for c in cases)
    print(f"phase 2d SSD dirs backward kernel vs plain: {len(cases)} cases "
          f"within {SSD_GRAD_TOL} (rtol, atol x max|plain|) on all 6 "
          f"cotangents, second launch bit-identical | SSDFusedDirs vs "
          f"torch.autograd through the plain forward: " + ", ".join(
              f"{k} {v:.2e}" for k, v in auto.items())
          + f" | {_ssd_passes_text('ssd_fused_dirs_bwd')} | "
          f"{_ssd_mma_text('ssd_fused_dirs_bwd')} | {summary}",
          flush=True)
    return dict(cases=cases, autograd_err=auto_err, autograd=auto,
                passes=_ssd_passes("ssd_fused_dirs_bwd"),
                hmma=_ssd_mma("ssd_fused_dirs_bwd"))


def _st_case(what, run_k, run_p, dt_name, reps):
    """One ST-SSD kernel case: two launches bit-identical, the kernel
    against its plain version within ST_TOL, times from CUDA events
    (``reps`` = kernel, plain repetitions)."""
    import torch
    yk, yk2, yp = run_k(), run_k(), run_p()
    torch.cuda.synchronize()
    if not torch.equal(yk, yk2):
        raise AssertionError(f"{what}: two launches differ in the bits")
    err = _check_scaled(what, yk, yp, *ST_TOL[dt_name])
    out_max = float(yp.float().abs().max())
    del yk, yk2, yp
    return dict(dtype=dt_name, max_abs_err=err, out_max=out_max,
                ms=_events_ms(run_k, reps[0]),
                plain_ms=_events_ms(run_p, reps[1]))


def _st_summary(cases):
    return "; ".join(
        f"{c['shape']} {c['dtype']} err={c['max_abs_err']:.2e} (max|out| "
        f"{c['out_max']:.2f}) kernel={c['ms']:.3f}ms "
        f"plain={c['plain_ms']:.2f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}){_split_text(c)}" for c in cases)


def _ydiag_cases():
    """Y_diag's cases (YDIAG_CASES), fp32 and bf16: (shape, dtype name,
    (Cc, Bc, acum, dtx), dy), built as ssd_chunked builds them (acum the
    cumsum of softplus steps against A = -U(1, 4); at L < l the padded
    steps carry dt = 0 and zero operands)."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    for i, (BC, l, H, N, P, L) in enumerate(YDIAG_CASES):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        live = (torch.arange(l, device=dev) < L).float()
        Cc = 0.5 * rnd(BC, l, N) * live[:, None]
        Bc = 0.5 * rnd(BC, l, N) * live[:, None]
        dtp = F.softplus(0.5 * rnd(BC, H, l) - 3.0) * live
        A = -(1.0 + 3.0 * torch.rand(H, 1, device=dev, generator=gen))
        acum = torch.cumsum(dtp * A, dim=-1)
        dtx, dy = rnd(BC, H, l, P), rnd(BC, H, l, P)
        shape = dict(L=L, shape=f"BC{BC} l{l} H{H} N{N} P{P}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield shape, dt_name, (Cc.to(dtype), Bc.to(dtype), acum,
                                   dtx.to(dtype)), dy.to(dtype)


def _ydiag_bound(args, dt_name, backward):
    """Bytes of the operands in and the outputs out; the products over the
    causal (i, j <= i) pairs: forward the scores 2 pairs N and per head
    2 pairs P; backward the scores, dC and dB 6 pairs N and per head ddtx
    and dM 4 pairs P."""
    Cc, _, acum, dtx = args
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    isz = Cc.element_size()
    pairs = l * (l + 1) // 2
    cb, rows, heads = 2 * BC * l * N * isz, BC * H * l * 4, BC * H * l * P * isz
    if not backward:
        return _bound(cb + rows + 2 * heads,
                      BC * (2 * pairs * N + H * 2 * pairs * P), dt_name)
    return _bound(2 * cb + 2 * rows + 3 * heads,
                  BC * (6 * pairs * N + H * 4 * pairs * P), dt_name)


def phase_ydiag_vs_plain():
    """2e: the Y_diag kernel at ST-SSD's stage 0 and at N 512."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_ydiag as yd)
    cases = []
    for shape, dt_name, args, _ in _ydiag_cases():
        run_k = lambda: yd.ydiag_fused_fwd(*args, impl="cuda")
        c = _st_case(f"Y_diag kernel vs plain {shape['shape']} {dt_name}",
                     run_k, lambda: yd.ydiag_fused_ref(*args), dt_name,
                     (5, 2))
        c.update(shape, bound=_ydiag_bound(args, dt_name, False))
        _walk_split(c, run_k, YDIAG_FWD_SPLIT)
        cases.append(c)
    print(f"phase 2e Y_diag forward kernel vs plain: {len(cases)}/"
          f"{2 * len(YDIAG_CASES)} cases within {ST_TOL} (rtol, atol x "
          f"max|plain|), second launch bit-identical | "
          f"{_ssd_passes_text('ssd_ydiag_fwd')} | "
          f"{_ssd_mma_text('ssd_ydiag_fwd')} | {_st_summary(cases)}",
          flush=True)
    return cases


def _stl_cases():
    """The STL mixer's cases at ST-SSD's stages 0-1 (BB = 4 B, the
    directions folded in; u1 and u2 U[0, 1) as at init, V = w u2), fp32
    and bf16: (stage, L, C, dtype name, (w, u1, V), dU)."""
    import torch
    dev = torch.device("cuda")
    BB = 4 * BATCH
    for i, (L, C) in enumerate(ST_STAGES):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        w = 0.5 * torch.randn(BB, L, C, device=dev, generator=gen)
        u1 = torch.rand(C, L, device=dev, generator=gen)
        u2 = torch.rand(C, C, device=dev, generator=gen)
        dU = torch.randn(BB, L, C, device=dev, generator=gen)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            wd = w.to(dtype)
            yield i, L, C, dt_name, (wd, u1.to(dtype), wd @ u2.to(dtype)), \
                dU.to(dtype)


def _stl_bound(args, dt_name, backward):
    """Bytes of w, u1, V in and U out (backward: w, u1, V, dU in and dw,
    du1, dV out); products 4 BB L P C (backward: the TPU body's five,
    10 BB L P C)."""
    w, u1, _ = args
    BB, L, C = w.shape
    P = u1.shape[1]
    isz = w.element_size()
    if not backward:
        return _bound((2 * BB * L * C + BB * P * C + C * P) * isz,
                      4 * BB * L * P * C, dt_name)
    return _bound((4 * BB * L * C + BB * P * C + 2 * C * P) * isz,
                  10 * BB * L * P * C, dt_name)


def phase_stl_vs_plain():
    """2f: the STL mixer kernel at ST-SSD's stages 0-1: U and lse."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        stl_mixer as stl)
    cases = []
    for i, L, C, dt_name, args, _ in _stl_cases():
        reps = (2, 1) if dt_name == "fp32" and i == 0 else (5, 2)
        what = f"STL mixer kernel vs plain L=P={L} C={C} {dt_name}"
        run_k = lambda: stl.stl_mixer_fwd(*args, impl="cuda")
        c = _st_case(what, run_k, lambda: stl.stl_mixer_fwd_ref(*args),
                     dt_name, reps)
        lk = stl.stl_mixer_fwd(*args, impl="cuda", want_stats=True)[1]
        lk2 = stl.stl_mixer_fwd(*args, impl="cuda", want_stats=True)[1]
        lp = stl.stl_mixer_fwd_ref(*args, True)[1]
        torch.cuda.synchronize()
        if not torch.equal(lk, lk2):
            raise AssertionError(f"{what}: two launches' lse differ")
        c.update(L=L, shape=f"BB{4 * BATCH} L=P{L} C{C}",
                 bound=_stl_bound(args, dt_name, False),
                 lse_err=_check_scaled(f"{what} lse", lk, lp,
                                       *ST_TOL[dt_name]))
        _walk_split(c, run_k, STL_FWD_SPLIT)
        cases.append(c)
        del args, lk, lk2, lp
    print(f"phase 2f STL mixer forward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_TOL} (rtol, atol x max|plain|) on U and lse, second "
          f"launch bit-identical | lse err "
          + " ".join(f"{c['lse_err']:.2e}" for c in cases)
          + f" | {_stl_passes_text('stl_mixer_fwd')} | "
          f"{_mma_text(_stl_mma('stl_mixer_fwd'))} | {_st_summary(cases)}",
          flush=True)
    return cases


def _stf_cases():
    """The STF gate's cases at stages 0-1 (BB = B; lz U[0, 1) as at init),
    fp32 and bf16: (stage, P, C, dtype name, (pooledT, lz, U), dY)."""
    import torch
    dev = torch.device("cuda")
    for i, (P, C) in enumerate(ST_STAGES):
        gen = torch.Generator(device=dev).manual_seed(400 + i)
        pT = 0.5 * torch.randn(BATCH, P, C, device=dev, generator=gen)
        lz = torch.rand(C, P, device=dev, generator=gen)
        U = torch.randn(BATCH, P, C, device=dev, generator=gen)
        dY = torch.randn(BATCH, P, C, device=dev, generator=gen)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield i, P, C, dt_name, (pT.to(dtype), lz.to(dtype),
                                     U.to(dtype)), dY.to(dtype)


# MUFU operations of one bf16 sigmoid (ex2 and rcp, csrc/stf_zgate_tiles.cuh)
STF_MUFU_OPS = 2


def _stf_mufu_ms(args):
    """The MUFU time of the gate's BB P^2 sigmoids (the function's own,
    forward and backward alike) at STF_MUFU_OPS each."""
    BB, P, _ = args[0].shape
    return BB * P * P * STF_MUFU_OPS / MUFU_PER_S * 1e3


def _stf_bound(args, dt_name, backward):
    """Bytes of pooledT, lz, U in and Y out (backward: pooledT, lz, U, dY
    in and dpooledT, dlz, dU out); products 4 BB P^2 C (backward: the TPU
    body's five, 10 BB P^2 C); in bf16 the sigmoids' MUFU time where it is
    larger (operations too)."""
    pT, _, _ = args
    BB, P, C = pT.shape
    isz = pT.element_size()
    if not backward:
        t = _bound((3 * BB * P * C + C * P) * isz, 4 * BB * P * P * C,
                   dt_name)
    else:
        t = _bound((5 * BB * P * C + 2 * C * P) * isz, 10 * BB * P * P * C,
                   dt_name)
    t_mufu = _stf_mufu_ms(args) if dt_name == "bf16" else 0.0
    return (t_mufu, "operations") if t_mufu > t[0] else t


def _stf_text(kernel, cases):
    """The gate's passes (what the card grants each, HMMA per bf16 pass),
    the sigmoids' MUFU time beside each bf16 bound, and each case."""
    mufu = "; ".join(f"{c['shape']} {c['mufu_ms']:.4f}ms" for c in cases
                     if "mufu_ms" in c)
    return (f"{_stl_passes_text(kernel)} | {_mma_text(_stl_mma(kernel))} | "
            f"bf16 sigmoids at the MUFU rate ({STF_MUFU_OPS} ops each): "
            f"{mufu}")


def phase_stf_vs_plain():
    """2g: the STF gate kernel at ST-SSD's stages 0-1."""
    from medical_image_classification_tpu_torch.kernels import (
        stf_zgate as stf)
    cases = []
    for i, P, C, dt_name, args, _ in _stf_cases():
        run_k = lambda: stf.stf_zgate_fwd(*args, impl="cuda")
        c = _st_case(f"STF gate kernel vs plain P={P} C={C} {dt_name}",
                     run_k, lambda: stf.stf_zgate_fwd_ref(*args), dt_name,
                     (5, 2))
        c.update(L=P, shape=f"BB{BATCH} P{P} C{C}",
                 bound=_stf_bound(args, dt_name, False))
        if dt_name == "bf16":
            c["mufu_ms"] = _stf_mufu_ms(args)
        _walk_split(c, run_k, STF_FWD_SPLIT)
        cases.append(c)
    print(f"phase 2g STF gate forward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_TOL} (rtol, atol x max|plain|), second launch "
          f"bit-identical | {_stf_text('stf_zgate_fwd', cases)} | "
          f"{_st_summary(cases)}", flush=True)
    return cases


def _st_bwd_case(what, names, run_k, run_p, dt_name, reps,
                 tol=ST_GRAD_TOL):
    """One backward case: two launches bit-identical, every cotangent
    against the plain backward within ``tol``, times from CUDA events
    (``reps`` = kernel, plain repetitions)."""
    import torch
    gk, gk2, gp = run_k(), run_k(), run_p()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
        raise AssertionError(f"{what}: two launches differ in the bits")
    errs = {nm: _check_scaled(f"{what} {nm}", a, b, *tol[dt_name])
            for nm, a, b in zip(names, gk, gp)}
    scales = {nm: float(b.float().abs().max()) for nm, b in zip(names, gp)}
    del gk, gk2, gp
    return dict(dtype=dt_name, errs=errs, plain_max=scales,
                max_abs_err=max(errs.values()),
                ms=_events_ms(run_k, reps[0]),
                plain_ms=_events_ms(run_p, reps[1]))


def _vs_autograd(what, names, run_fn, run_ref, args, grad_out,
                 tol=ST_GRAD_TOL):
    """A Function on the card against torch.autograd through the plain
    forward (fp32, ``tol``): the max abs error over the cotangents."""
    import torch
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    run_fn(*leaves).backward(grad_out)
    got = [a.grad for a in leaves]
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(run_ref(*leaves), leaves, grad_out)
    return max(_check_scaled(f"{what} vs autograd {nm}", a, b,
                             *tol["fp32"])
               for nm, a, b in zip(names, got, want))


def _st_bwd_summary(cases):
    return "; ".join(
        f"{c['shape']} {c['dtype']} " + " ".join(
            f"{k}={v:.2e} (max|plain| {c['plain_max'][k]:.3g})"
            for k, v in c["errs"].items())
        + f" kernel={c['ms']:.3f}ms plain={c['plain_ms']:.2f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]})" for c in cases)


def phase_ydiag_bwd_vs_plain():
    """2h: the Y_diag backward kernel at 2e's cases; YDiagFused against
    torch.autograd in fp32 at each shape."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_ydiag as yd)
    names = ST_GRAD_NAMES["ssd_ydiag"]
    cases, auto = [], 0.0
    for shape, dt_name, args, dy in _ydiag_cases():
        run_k = lambda: yd.ydiag_fused_bwd(*args, dy, impl="cuda")
        c = _st_bwd_case(
            f"Y_diag backward kernel vs plain {shape['shape']} {dt_name}",
            names, run_k, lambda: yd.ydiag_fused_bwd_ref(*args, dy), dt_name,
            (5, 2))
        c.update(shape, bound=_ydiag_bound(args, dt_name, True))
        _walk_split(c, run_k, YDIAG_BWD_SPLIT)
        cases.append(c)
        if dt_name == "fp32":
            auto = max(auto, _vs_autograd(
                "YDiagFused", names,
                lambda *a: yd.ydiag_fused(*a, impl="cuda"),
                yd.ydiag_fused_ref, args, dy))
    print(f"phase 2h Y_diag backward kernel vs plain: {len(cases)}/"
          f"{2 * len(YDIAG_CASES)} cases within {ST_GRAD_TOL} (rtol, atol x "
          f"max|plain|) on all 4 cotangents, second launch bit-identical | "
          f"YDiagFused vs torch.autograd through the plain forward, fp32, "
          f"worst of {len(YDIAG_CASES)} shapes: max err {auto:.2e} | "
          f"{_ssd_passes_text('ssd_ydiag_bwd')} | "
          f"{_ssd_mma_text('ssd_ydiag_bwd')} | "
          + "; ".join(_st_bwd_summary([c]) + _split_text(c) for c in cases),
          flush=True)
    return dict(cases=cases, autograd_err=auto)


def phase_stl_bwd_vs_plain():
    """2i: the STL mixer backward kernel at 2f's cases, E from the forward
    kernel's lse (the plain backward given the same lse); STLMixer against
    torch.autograd at stage 1 in fp32."""
    from medical_image_classification_tpu_torch.kernels import (
        stl_mixer as stl)
    names = ST_GRAD_NAMES["stl_mixer"]
    cases = []
    for i, L, C, dt_name, args, dU in _stl_cases():
        reps = (2, 1) if dt_name == "fp32" and i == 0 else (3, 1)
        lse = stl.stl_mixer_fwd(*args, impl="cuda", want_stats=True)[1]
        run_k = lambda: stl.stl_mixer_bwd(*args, dU, impl="cuda", lse=lse)
        c = _st_bwd_case(
            f"STL mixer backward kernel vs plain L=P={L} C={C} {dt_name}",
            names, run_k, lambda: stl.stl_mixer_bwd_ref(*args, dU, lse),
            dt_name, reps)
        c.update(L=L, shape=f"BB{4 * BATCH} L=P{L} C{C}",
                 bound=_stl_bound(args, dt_name, True))
        _walk_split(c, run_k, STL_BWD_SPLIT)
        cases.append(c)
        if i == 1 and dt_name == "fp32":
            auto = _vs_autograd(
                "STLMixer", names,
                lambda *a: stl.STLMixer.apply(*a, "cuda"),
                stl.stl_mixer_fwd_ref, args, dU)
        del args, dU, lse
    print(f"phase 2i STL mixer backward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_GRAD_TOL} (rtol, atol x max|plain|) on all 3 "
          f"cotangents, second launch bit-identical | STLMixer vs "
          f"torch.autograd through the plain forward at stage 1 fp32: max "
          f"err {auto:.2e} | {_stl_passes_text('stl_mixer_bwd')} | "
          f"{_mma_text(_stl_mma('stl_mixer_bwd'))} | "
          + "; ".join(_st_bwd_summary([c]) + _split_text(c) for c in cases),
          flush=True)
    return dict(cases=cases, autograd_err=auto)


def phase_stf_bwd_vs_plain():
    """2j: the STF gate backward kernel at 2g's cases; STFZGate against
    torch.autograd at stage 1 in fp32."""
    from medical_image_classification_tpu_torch.kernels import (
        stf_zgate as stf)
    names = ST_GRAD_NAMES["stf_zgate"]
    cases = []
    for i, P, C, dt_name, args, dY in _stf_cases():
        run_k = lambda: stf.stf_zgate_bwd(*args, dY, impl="cuda")
        c = _st_bwd_case(
            f"STF gate backward kernel vs plain P={P} C={C} {dt_name}",
            names, run_k, lambda: stf.stf_zgate_bwd_ref(*args, dY), dt_name,
            (5, 2))
        c.update(L=P, shape=f"BB{BATCH} P{P} C{C}",
                 bound=_stf_bound(args, dt_name, True))
        if dt_name == "bf16":
            c["mufu_ms"] = _stf_mufu_ms(args)
        _walk_split(c, run_k, STF_BWD_SPLIT)
        cases.append(c)
        if i == 1 and dt_name == "fp32":
            auto = _vs_autograd(
                "STFZGate", names,
                lambda *a: stf.stf_zgate(*a, impl="cuda"),
                stf.stf_zgate_fwd_ref, args, dY)
    print(f"phase 2j STF gate backward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_GRAD_TOL} (rtol, atol x max|plain|) on all 3 "
          f"cotangents, second launch bit-identical | STFZGate vs "
          f"torch.autograd through the plain forward at stage 1 fp32: max "
          f"err {auto:.2e} | {_stf_text('stf_zgate_bwd', cases)} | "
          + "; ".join(_st_bwd_summary([c]) + _split_text(c) for c in cases),
          flush=True)
    return dict(cases=cases, autograd_err=auto)


def _fused_cases(cases=FUSED_CASES):
    """The single-layout fused SSD's cases (FUSED_CASES, or ``cases``),
    fp32 and bf16:
    (case dict, dtype name, (Cc, Bc, acum, dte, cdec, dtp, x), dy), built
    as ssd_chunked builds them: the steps a softplus, padded with dt = 0
    and zero operands up to whole chunks (after the softplus), acum their
    cumsum against A = -U(1, 4), dte and cdec from it; dy is zero on the
    padded steps, which ssd_chunked slices off."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    for i, (B, L, l, H, N) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        nc = -(-L // l)
        live = (torch.arange(nc * l, device=dev) < L).float()[:, None]
        steps = lambda *s: (rnd(B, nc * l, *s) * live).reshape(
            B, nc, l, *s)
        dtp = F.softplus(steps(H) * 0.5 - 3.0) * live.reshape(nc, l, 1)
        dtp = dtp.transpose(2, 3).contiguous()               # [B, nc, H, l]
        A = -(1.0 + 3.0 * torch.rand(H, 1, device=dev, generator=gen))
        acum = torch.cumsum(dtp * A, dim=-1)
        dte = torch.exp(acum[..., -1:] - acum)
        cdec = torch.exp(acum[..., -1])
        C, Bm = 0.5 * steps(N), 0.5 * steps(N)
        x, dy = steps(H * SSD_P), steps(H * SSD_P)
        case = dict(L=L, l=l, shape=f"B{B} L{L} nc{nc} l{l} H{H} "
                    f"N{N} P{SSD_P}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield case, dt_name, (C.to(dtype), Bm.to(dtype), acum, dte, cdec,
                                  dtp, x.to(dtype)), dy.to(dtype)


def phase_fused_fwd_vs_plain():
    """2k: the single-layout fused SSD forward kernel vs its plain version,
    as 2c."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused as sf)
    cases = []
    for case, dt_name, args, _ in _fused_cases():
        run_k = lambda: sf.ssd_fused_fwd(*args, impl="cuda")
        c = _fwd_case(
            f"fused SSD forward kernel vs plain {case['shape']} {dt_name}",
            run_k, lambda: sf.ssd_fused_fwd(*args, want_save=True,
                                            impl="cuda"),
            lambda **kw: sf.ssd_fused_fwd_ref(*args, **kw), dt_name)
        c.update(case, bound=_fused_bound(args, dt_name, False),
                 save_bound=_fused_bound(args, dt_name, False, True))
        _walk_split(c, run_k, SSD_FWD_SPLIT)
        cases.append(c)
    summary = "; ".join(f"{c['shape']} " + _fwd_summary(c) for c in cases)
    print(f"phase 2k fused SSD forward kernel vs plain: {len(cases)}/"
          f"{2 * len(FUSED_CASES)} cases within {SSD_TOL} (rtol, atol x "
          f"max|plain|), y and Ssave, second launch bit-identical | "
          f"{_ssd_passes_text('ssd_fused_fwd')} | "
          f"{_ssd_mma_text('ssd_fused_fwd')} | {summary}", flush=True)
    return cases


def phase_fused_bwd_vs_plain():
    """2l: the single-layout fused SSD backward kernel vs the plain
    backward at 2k's cases, all seven cotangents, a second launch
    bit-identical; SSDFused against torch.autograd through the plain
    forward in fp32 at each shape."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused as sf)
    cases, auto = [], 0.0
    for case, dt_name, args, dy in _fused_cases():
        _, Ssave = sf.ssd_fused_fwd_ref(*args, want_save=True)
        run_k = lambda: sf.ssd_fused_bwd(*args, Ssave, dy, impl="cuda")
        c = _st_bwd_case(
            f"fused SSD backward kernel vs plain {case['shape']} {dt_name}",
            FUSED_GRAD_NAMES, run_k,
            lambda: sf.ssd_fused_bwd_ref(*args, Ssave, dy), dt_name, (3, 1),
            SSD_GRAD_TOL)
        c.update(case, bound=_fused_bound(args, dt_name, True))
        _walk_split(c, run_k)
        cases.append(c)
        del Ssave
        if dt_name == "fp32":
            auto = max(auto, _vs_autograd(
                "SSDFused", FUSED_GRAD_NAMES,
                lambda *a: sf.ssd_fused(*a, impl="cuda"),
                sf.ssd_fused_fwd_ref, args, dy, SSD_GRAD_TOL))
    print(f"phase 2l fused SSD backward kernel vs plain: {len(cases)}/"
          f"{2 * len(FUSED_CASES)} cases within {SSD_GRAD_TOL} (rtol, atol x "
          f"max|plain|) on all 7 cotangents, second launch bit-identical | "
          f"SSDFused vs torch.autograd through the plain forward, fp32, "
          f"worst of {len(FUSED_CASES)} shapes: max err {auto:.2e} | "
          f"{_ssd_passes_text('ssd_fused_bwd')} | "
          f"{_ssd_mma_text('ssd_fused_bwd')} | "
          + "; ".join(_st_bwd_summary([c]) + _split_text(c) for c in cases),
          flush=True)
    return dict(cases=cases, autograd_err=auto,
                passes=_ssd_passes("ssd_fused_bwd"),
                hmma=_ssd_mma("ssd_fused_bwd"))


def _flag_cases():
    """The scan's flag cases, FLAG_CASES in fp32 and bf16, forward and
    reverse: (case dict, dtype name, reverse, args, init), args the folded
    scan's (u, delta, A, B, C, D, bias) on the card with S4D-real A =
    -(1..N), init [G, N, Dm] fp32."""
    import torch
    dev = torch.device("cuda")
    for i, (name, K, g, L, Dm) in enumerate(FLAG_CASES):
        gen = torch.Generator(device=dev).manual_seed(700 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        base = dict(u=rnd(g, L, Dm), delta=0.5 * rnd(g, L, Dm),
                    B=rnd(g, L, N), C=rnd(g, L, N))
        A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
            K, Dm, N).contiguous()
        D, bias, init = rnd(K, Dm), 0.1 * rnd(K, Dm), rnd(g, N, Dm)
        case = dict(name=name, K=K, G=g, L=L, Dm=Dm,
                    shape=f"{name} K{K} G{g} L{L} Dm{Dm} N{N}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            act = {k: v.to(dtype) for k, v in base.items()}
            for reverse in (False, True):
                yield case, dt_name, reverse, (
                    act["u"], act["delta"], A, act["B"], act["C"], D,
                    bias), init


def phase_scan_fwd_flags():
    """2m: the scan forward kernel with its state flags (init in, last
    out) vs the plain version: y, xsave and last within the row-1 ladder
    (TOL), the first scanned chunk's xsave equal to init, a second launch
    bit-identical, and with a zero init y equal to the flag-free launch's
    bits; times of the kernel with the flags and without, from CUDA
    events."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as fwd)
    cases = []
    for case, dt_name, reverse, args, init in _flag_cases():
        what = f"forward flags {case['shape']} {dt_name} reverse={reverse}"
        run_k = lambda: fwd._launch_cuda(*args, reverse, True,
                                         want_state=True, init=init)
        run_0 = lambda: fwd._launch_cuda(*args, reverse, True)
        run_p = lambda: fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                                want_state=True, init=init)
        yk, xk, lk = fwd._launch_cuda(*args, reverse, True, want_xsave=True,
                                      want_state=True, init=init)
        yk2, lk2 = run_k()
        y0 = run_0()
        yz, _ = fwd._launch_cuda(*args, reverse, True, want_state=True,
                                 init=torch.zeros_like(init))
        yp, xp, lp = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                             want_xsave=True,
                                             want_state=True, init=init)
        torch.cuda.synchronize()
        if not (torch.equal(yk, yk2) and torch.equal(lk, lk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        if not torch.equal(yz, y0):
            raise AssertionError(f"{what}: a zero init changes y")
        if not torch.equal(xk[:, -1 if reverse else 0], init):
            raise AssertionError(f"{what}: the first chunk's xsave is not "
                                 "init")
        rtol, atol = TOL[dt_name]
        errs = dict(y=_check_close(what + " y", yk, yp, rtol, atol),
                    xsave=_check_close(what + " xsave", xk, xp, rtol, atol),
                    last=_check_close(what + " last", lk, lp, rtol, atol))
        del yk, xk, lk, yk2, lk2, y0, yz, yp, xp, lp
        cases.append(dict(case, dtype=dt_name, reverse=reverse, errs=errs,
                          max_abs_err=max(errs.values()),
                          ms=_events_ms(run_k, 10),
                          eval_ms=_events_ms(run_0, 10),
                          plain_ms=_events_ms(run_p, 1),
                          bound=_scan_bound(case["L"], case["Dm"], dt_name,
                                            False, case["G"], True),
                          warps_per_sm=_occupancy_text(dt_name, False)))
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'} "
        + " ".join(f"{k}={v:.2e}" for k, v in c["errs"].items())
        + f" kernel={c['ms']:.4f}ms without_flags={c['eval_ms']:.4f}ms "
        f"plain={c['plain_ms']:.1f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}) {c['warps_per_sm']}" for c in cases)
    print(f"phase 2m forward kernel with init and last vs plain: "
          f"{len(cases)}/{4 * len(FLAG_CASES)} cases within "
          f"fp32 {TOL['fp32']} bf16 {TOL['bf16']} (rtol, atol) on y, "
          f"xsave and last, the first chunk's xsave = init, second launch "
          f"bit-identical, a zero init bit-identical to no init | passes: "
          f"{_passes_text(False)} | {summary}", flush=True)
    return cases


def phase_scan_bwd_flags():
    """2n: the scan backward kernel with its state flags (dlast seeding
    the adjoint, dinit out) vs the plain backward at 2m's cases, all eight
    gradients within the row-2 ladder (GRAD_TOL), a second launch
    bit-identical, a zero dlast bit-identical to no dlast; ScanFolded with
    want_state and init against torch.autograd through the plain forward
    at MedMamba's stage-2 shape (K 4), fp32, both directions."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as bwd, selective_scan_fwd as fwd)
    names = GRAD_NAMES + ("dinit",)
    cases = []
    for case, dt_name, reverse, args, init in _flag_cases():
        what = f"backward flags {case['shape']} {dt_name} reverse={reverse}"
        _, xsave = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                           want_xsave=True, init=init)
        gen = torch.Generator(device="cuda").manual_seed(case["L"] + reverse)
        dy = torch.randn(args[0].shape, device="cuda",
                         generator=gen).to(args[0].dtype)
        dlast = torch.randn(init.shape, device="cuda", generator=gen)
        run_k = lambda: bwd.scan_folded_bwd(*args, xsave, dy,
                                            reverse=reverse, impl="cuda",
                                            dlast=dlast, want_dinit=True)
        run_p = lambda: bwd.scan_folded_bwd_ref(*args, xsave, dy,
                                                reverse=reverse, dlast=dlast,
                                                want_dinit=True)
        gk, gk2, gp = run_k(), run_k(), run_p()
        g0 = bwd.scan_folded_bwd(*args, xsave, dy, reverse=reverse,
                                 impl="cuda")
        gz = bwd.scan_folded_bwd(*args, xsave, dy, reverse=reverse,
                                 impl="cuda", dlast=torch.zeros_like(dlast))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        if not all(torch.equal(a, b) for a, b in zip(g0, gz)):
            raise AssertionError(f"{what}: a zero dlast changes a gradient")
        rtol, atol = GRAD_TOL[dt_name]
        errs = {nm: _check_close(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(names, gk, gp)}
        del gk, gk2, gp, g0, gz
        cases.append(dict(case, dtype=dt_name, reverse=reverse, errs=errs,
                          max_abs_err=max(errs.values()),
                          ms=_events_ms(run_k, 5),
                          plain_ms=_events_ms(run_p, 1),
                          bound=_scan_bound(case["L"], case["Dm"], dt_name,
                                            True, case["G"], True),
                          warps_per_sm=_occupancy_text(dt_name, True)))

    # ScanFolded with the flags (kernels) against torch.autograd through
    # the plain forward, the loss reading y and the last state
    L, Dm, K, g = STAGES[2][0], STAGES[2][1], 4, G
    gen = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    A = -torch.arange(1, N + 1, device="cuda",
                      dtype=torch.float32).expand(K, Dm, N).contiguous()
    args = (rnd(g, L, Dm), 0.5 * rnd(g, L, Dm), A, rnd(g, L, N),
            rnd(g, L, N), rnd(K, Dm), 0.1 * rnd(K, Dm), rnd(g, N, Dm))
    wy, wl = rnd(g, L, Dm), rnd(g, N, Dm)
    auto = 0.0
    for reverse in (False, True):
        def grads(fn):
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            y, last = fn(*leaves[:7], reverse=reverse, want_state=True,
                         init=leaves[7])
            return torch.autograd.grad((y * wy).sum() + (last * wl).sum(),
                                       leaves)
        got = grads(lambda *a, **kw: fwd.scan_folded_fwd(*a, impl="cuda",
                                                         **kw))
        want = grads(fwd.scan_folded_fwd_ref)
        auto = max([auto] + [
            _check_close(f"ScanFolded with flags vs autograd {nm} "
                         f"reverse={reverse}", a, b, *GRAD_TOL["fp32"])
            for nm, a, b in zip(names, got, want)])
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'} "
        f"err={c['max_abs_err']:.2e} (dinit {c['errs']['dinit']:.2e}) "
        f"kernel={c['ms']:.4f}ms plain={c['plain_ms']:.1f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]}) "
        f"{c['warps_per_sm']}" for c in cases)
    print(f"phase 2n backward kernel with dlast and dinit vs plain: "
          f"{len(cases)}/{4 * len(FLAG_CASES)} cases within fp32 "
          f"{GRAD_TOL['fp32']} bf16 {GRAD_TOL['bf16']} (rtol, atol) on all "
          f"8 gradients, second launch bit-identical, a zero dlast "
          f"bit-identical to none | ScanFolded with want_state and init vs "
          f"torch.autograd through the plain forward at {L}x{Dm} K{K} fp32, "
          f"both directions: max err {auto:.2e} | passes: "
          f"{_passes_text(True)} | {summary}", flush=True)
    return dict(cases=cases, autograd_err=auto)


def _v1_cases():
    """2o/2p's cases, V1_CASES in fp32 and bf16: (case dict, dtype name,
    args), args the folded scan's (u, delta, A, B, C, D, bias) on the card
    with K 4 and A = -|N(0, 1)| - 0.5, as the kernel bench draws it."""
    import torch
    dev = torch.device("cuda")
    for i, (name, g, L, Dm, n, T) in enumerate(V1_CASES):
        gen = torch.Generator(device=dev).manual_seed(800 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        base = dict(u=rnd(g, L, Dm), delta=0.5 * rnd(g, L, Dm),
                    B=rnd(g, L, n), C=rnd(g, L, n))
        A = -rnd(4, Dm, n).abs() - 0.5
        D, bias = rnd(4, Dm), 0.1 * rnd(4, Dm)
        case = dict(name=name, G=g, L=L, Dm=Dm, N=n, T=T,
                    shape=f"{name} G{g} L{L} Dm{Dm} N{n} T{T}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            act = {k: v.to(dtype) for k, v in base.items()}
            yield case, dt_name, (act["u"], act["delta"], A, act["B"],
                                  act["C"], D, bias)


def _v1_bound(L, Dm, T, dtype, backward, g=BENCH_G, n=N):
    """The v1 scan at ``g`` sequences and chunk T: the largest of three
    times, as ``_scan_bound`` takes them.  Bytes: u, Δ, B, C in, y out and
    the fp32 xsave [g, ceil(L / T), n, Dm] out (backward: u, Δ, B, C, dy
    and xsave in, du, dΔ, dB, dC out in fp32).  CUDA-core operations: ~7
    fp32 operations per state per step forward (~20 backward).  Exps at the
    MUFU rate: the function's own, one exp(dt A) per (step, channel,
    state).  Returns (ms, "bytes" or "operations"); the exps are
    operations."""
    isz = 4 if dtype == "fp32" else 2
    seq = g * L * (3 * Dm + 2 * n) * isz
    xsave = g * -(-L // T) * n * Dm * 4
    ops = (20 if backward else 7) * g * L * Dm * n
    out = g * L * (2 * Dm + 2 * n) * 4 if backward else 0
    t, by = _bound(seq + xsave + out, ops, "fp32")
    t_mufu = g * L * Dm * n / MUFU_PER_S * 1e3
    return (t_mufu, "operations") if t_mufu > t else (t, by)


# the v1 kernels' one pass each, by the name torch.profiler gives it
V1_FWD_SPLIT = {"walk": "scan_v1_fwd_kernel"}
V1_BWD_SPLIT = {"walk": "scan_v1_bwd_kernel"}
V1_SPLIT_T = 50          # the chunk of the reported case (--t-cap 50)


def _v1_head(c):
    """The case whose times the kernels line reports: the bench's stage 0
    at T 50 in bf16."""
    return c["name"] == "stage0" and c["T"] == V1_SPLIT_T and \
        c["dtype"] == "bf16"


@functools.lru_cache(maxsize=None)
def _v1_passes(kernel):
    """What the card grants the v1 forward's or backward's one pass at N 16
    (the backward at chunk ``V1_SPLIT_T``): {dtype: {pass: {registers,
    local_bytes, shared_bytes, warps_per_sm}}}."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_v1 as v1)
    keys = ("registers", "local_bytes", "shared_bytes", "warps_per_sm")
    info = (v1.fwd_pass_info if kernel.endswith("fwd") else
            functools.partial(v1.bwd_pass_info, T=V1_SPLIT_T))
    return {dt: {p: dict(zip(keys, v)) for p, v in info(N, dtype).items()}
            for dt, dtype in (("fp32", torch.float32),
                              ("bf16", torch.bfloat16))}


def _v1_passes_text(kernel):
    return "passes (registers/local B/shared B/warps per SM): " + "; ".join(
        f"{dt} " + ", ".join(f"{p} " + "/".join(str(x) for x in v.values())
                             for p, v in passes.items())
        for dt, passes in _v1_passes(kernel).items())


def phase_v1_fwd_vs_plain():
    """2o: the v1 forward kernel (csrc/selective_scan_v1_fwd.cu) against
    its plain twin at V1_CASES, fp32 and bf16: y and xsave within the row-1
    ladder (TOL), a second launch bit-identical, the eval launch (no xsave)
    equal to it; kernel and plain times from CUDA events."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_v1 as v1)
    cases = []
    for case, dt_name, args in _v1_cases():
        T = case["T"]
        what = f"v1 forward {case['shape']} {dt_name}"
        run_k = lambda: v1.scan_v1_fwd(*args, T, want_xsave=True,
                                       impl="cuda")
        run_p = lambda: v1.scan_v1_fwd_ref(*args, T)
        yk, xk = run_k()
        yk2, xk2 = run_k()
        y0 = v1.scan_v1_fwd(*args, T, impl="cuda")
        yp, xp = run_p()
        torch.cuda.synchronize()
        if not (torch.equal(yk, yk2) and torch.equal(xk, xk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        if not torch.equal(y0, yk):
            raise AssertionError(f"{what}: y changes when xsave is written")
        rtol, atol = TOL[dt_name]
        errs = dict(y=_check_close(what + " y", yk, yp, rtol, atol),
                    xsave=_check_close(what + " xsave", xk, xp, rtol, atol))
        del yk, xk, yk2, xk2, y0, yp, xp
        cases.append(dict(case, dtype=dt_name, errs=errs,
                          max_abs_err=max(errs.values()),
                          ms=_events_ms(run_k, 10),
                          plain_ms=_events_ms(run_p, 1),
                          bound=_v1_bound(case["L"], case["Dm"], T, dt_name,
                                          False, case["G"], case["N"])))
        if _v1_head(cases[-1]):
            _walk_split(cases[-1], run_k, V1_FWD_SPLIT)
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} y={c['errs']['y']:.2e} "
        f"xsave={c['errs']['xsave']:.2e} kernel={c['ms']:.4f}ms "
        f"plain={c['plain_ms']:.2f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}){_split_text(c)}" for c in cases)
    print(f"phase 2o v1 forward kernel vs plain: {len(cases)}/"
          f"{2 * len(V1_CASES)} cases within fp32 {TOL['fp32']} bf16 "
          f"{TOL['bf16']} (rtol, atol) on y and xsave, second launch "
          f"bit-identical | {_v1_passes_text('selective_scan_v1_fwd')} | "
          f"{summary}", flush=True)
    return cases


def phase_v1_bwd_vs_plain():
    """2p: the v1 backward kernel (csrc/selective_scan_v1_bwd.cu) against
    its plain twin at V1_CASES, all seven gradients (dA, dD, dbias after
    the sum over the batch) within the row-2 ladder (GRAD_TOL), a second
    launch bit-identical; ScanFolded on the v1 pair (the cap at 50, as the
    bench's --t-cap 50 sets it) against torch.autograd through the plain
    forward at the bench's stage 2, fp32; ValueError for reverse and for
    each flag under v1."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as fwd, selective_scan_v1 as v1)
    cases, perturbed = [], {}
    for case, dt_name, args in _v1_cases():
        T = case["T"]
        what = f"v1 backward {case['shape']} {dt_name}"
        _, xsave = v1.scan_v1_fwd_ref(*args, T)
        gen = torch.Generator(device="cuda").manual_seed(case["L"] + T)
        dy = torch.randn(args[0].shape, device="cuda",
                         generator=gen).to(args[0].dtype)
        run_k = lambda: v1.scan_v1_bwd(*args, xsave, dy, T, impl="cuda")
        run_p = lambda: v1.scan_v1_bwd_ref(*args, xsave, dy, T)
        gk, gk2, gp = run_k(), run_k(), run_p()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        rtol, atol = GRAD_TOL[dt_name]
        errs = {nm: _check_close(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(GRAD_NAMES, gk, gp)}
        del gk, gk2, gp
        cases.append(dict(case, dtype=dt_name, errs=errs,
                          max_abs_err=max(errs.values()),
                          ms=_events_ms(run_k, 5),
                          plain_ms=_events_ms(run_p, 1),
                          bound=_v1_bound(case["L"], case["Dm"], T, dt_name,
                                          True, case["G"], case["N"])))
        if _v1_head(cases[-1]):
            _walk_split(cases[-1], run_k, V1_BWD_SPLIT)
        if tuple(case[k] for k in ("name", "G", "L", "Dm", "N", "T")) \
                == V1_PERTURBED:
            # an xsave that is not the forward's: the kernel must seed each
            # chunk from the xsave it is given, as the plain version does
            gen = torch.Generator(device="cuda").manual_seed(case["L"] - T)
            xs_p = xsave + 0.5 * torch.randn(xsave.shape, device="cuda",
                                             generator=gen)
            gk = v1.scan_v1_bwd(*args, xs_p, dy, T, impl="cuda")
            gp = v1.scan_v1_bwd_ref(*args, xs_p, dy, T)
            torch.cuda.synchronize()
            perturbed[dt_name] = max(
                _check_close(f"{what} perturbed xsave {nm}", a, b, rtol, atol)
                for nm, a, b in zip(GRAD_NAMES, gk, gp))
            # and the gradients moved with it
            moved = max(float((a - b).abs().max()) for a, b in zip(
                gk, v1.scan_v1_bwd(*args, xsave, dy, T, impl="cuda")))
            if moved <= 10 * atol:
                raise AssertionError(f"{what}: the gradients did not follow "
                                     f"the perturbed xsave ({moved:.2e})")
            del gk, gp, xs_p

    # ScanFolded on the v1 pair against torch.autograd through the plain
    # (sequential) forward, and the refusals, with the bench's cap
    L, Dm, K, g = STAGES[2][0], STAGES[2][1], 4, G
    gen = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    args = (rnd(g, L, Dm), 0.5 * rnd(g, L, Dm), -rnd(K, Dm, N).abs() - 0.5,
            rnd(g, L, N), rnd(g, L, N), rnd(K, Dm), 0.1 * rnd(K, Dm))
    wy = rnd(g, L, Dm)
    saved_cap = v1._T_CAP
    v1._T_CAP = 50
    try:
        T = v1.v1_chunk(L, Dm, N)
        if T != 50:
            raise AssertionError(f"the cap 50 gives chunk {T} at {L}x{Dm}")

        def grads(fn):
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            return torch.autograd.grad((fn(*leaves) * wy).sum(), leaves)
        f0, b0 = v1.scan_v1_fwd.launches, v1.scan_v1_bwd.launches
        got = grads(lambda *a: fwd.scan_folded_fwd(*a, impl="cuda"))
        if (v1.scan_v1_fwd.launches - f0, v1.scan_v1_bwd.launches - b0) \
                != (1, 1):
            raise AssertionError("ScanFolded did not launch the v1 pair once")
        want = grads(fwd.scan_folded_fwd_ref)
        auto = max(_check_close(f"ScanFolded on v1 vs autograd {nm}", a, b,
                                *GRAD_TOL["fp32"])
                   for nm, a, b in zip(GRAD_NAMES, got, want))
        refused = []
        for kw in (dict(reverse=True), dict(want_state=True),
                   dict(init=torch.zeros(g, N, Dm, device="cuda")),
                   dict(softplus=False)):
            try:
                fwd.scan_folded_fwd(*args, impl="cuda", **kw)
            except ValueError:
                refused.append(next(iter(kw)))
            else:
                raise AssertionError(f"v1 took {kw}")
    finally:
        v1._T_CAP = saved_cap
    if len(perturbed) != 2:
        raise AssertionError(f"perturbed-xsave cases ran for {perturbed}")
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} err={c['max_abs_err']:.2e} "
        f"kernel={c['ms']:.4f}ms plain={c['plain_ms']:.1f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]}){_split_text(c)}"
        for c in cases)
    print(f"phase 2p v1 backward kernel vs plain: {len(cases)}/"
          f"{2 * len(V1_CASES)} cases within fp32 {GRAD_TOL['fp32']} bf16 "
          f"{GRAD_TOL['bf16']} (rtol, atol) on all 7 gradients, second "
          f"launch bit-identical | an xsave not the forward's at "
          f"{V1_PERTURBED[0]} T{V1_PERTURBED[5]}: max err fp32 "
          f"{perturbed['fp32']:.2e}, bf16 {perturbed['bf16']:.2e} | "
          f"ScanFolded on the v1 pair (T 50) vs "
          f"torch.autograd through the plain forward at {L}x{Dm} K{K} fp32: "
          f"max err {auto:.2e}; ValueError under v1 for {', '.join(refused)}"
          f" | {_v1_passes_text('selective_scan_v1_bwd')} | {summary}",
          flush=True)
    return dict(cases=cases, autograd_err=auto, perturbed_err=perturbed)


def _calib_bound(cfg, T, dtype="bf16"):
    """The calibration at a bench stage ``cfg`` (G, L, Dm, N; K 4 unless
    given) and chunk T, operands in ``dtype``: the largest of three times,
    as ``_v1_bound`` takes them.  Bytes: u, Δ, B, C in and y [G, Lp, Dm]
    out, At [K, N, Dm] fp32 in.  CUDA-core operations: an exp, four
    products and a sum a (g, t, d, n), at the fp32 rate in either compute
    (bf16 compute's products run on the CUDA cores too).  Exps at the MUFU
    rate: one a (g, t, d, n), the same in either compute.  Returns (ms,
    "bytes" or "operations"); the exps are operations."""
    G, L, Dm, n = cfg["G"], cfg["L"], cfg["Dm"], cfg["N"]
    isz = 4 if dtype == "fp32" else 2
    Lp = -(-L // T) * T
    exps = G * L * Dm * n
    nbytes = (G * L * (2 * Dm + 2 * n) + G * Lp * Dm) * isz \
        + cfg.get("K", 4) * n * Dm * 4
    t, by = _bound(nbytes, 5 * exps, "fp32")
    t_mufu = exps / MUFU_PER_S * 1e3
    return (t_mufu, "operations") if t_mufu > t else (t, by)


def phase_calib_vs_plain():
    """2q: the calibration kernel (csrc/scan_calib.cu) against its plain
    twins at the bench's four stages (its inputs, bf16, T from the tile
    chooser at the default cap) and at the CALIB_RAGGED cases in bf16 and
    fp32, in fp32 and bf16 compute: within CALIB_TOL x max|plain| of
    scan_calib_ref (``kern``'s order, and its roundings in bf16 compute),
    and in fp32 compute within CALIB_TWIN_TOL of scan_calib_factored_ref
    (the kernel's order); a second launch bit-identical; kernel and plain
    times from CUDA events beside ``_calib_bound``; at each stage what the
    card grants the pass, and at stage 0 its device time
    (torch.profiler)."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        scan_calib as calib, selective_scan_v1 as v1)
    from medical_image_classification_tpu_torch.scripts.kernel_bench import (
        STAGES as BENCH_STAGES, make_inputs)
    shapes = [(st, cfg, torch.bfloat16) for st, cfg in BENCH_STAGES.items()]
    shapes += [("ragged", cfg, dt) for cfg in CALIB_RAGGED
               for dt in (torch.bfloat16, torch.float32)]
    cases = []
    for st, cfg, dtype in shapes:
        T, _ = v1._choose_tiles(cfg["L"], cfg["Dm"], cfg["N"])
        u, delta, A, B, C, _, _ = make_inputs(**cfg, dtype=dtype,
                                              device="cuda")
        At = A.transpose(1, 2).contiguous()
        dt_name = "fp32" if dtype == torch.float32 else "bf16"
        G_, L, Dm, n = cfg["G"], cfg["L"], cfg["Dm"], cfg["N"]
        for mode, bf in (("fp32", False), ("bf16", True)):
            what = (f"calibration {st} G{G_} L{L} Dm{Dm} N{n} T{T} {dt_name} "
                    f"{mode} compute")
            run_k = lambda: calib.scan_calib(u, delta, At, B, C, T,
                                             bf16_compute=bf, impl="cuda")
            run_p = lambda: calib.scan_calib_ref(u, delta, At, B, C, T, bf)
            yk, yk2, yp = run_k(), run_k(), run_p()
            torch.cuda.synchronize()
            if not torch.equal(yk, yk2):
                raise AssertionError(f"{what}: two launches differ in the "
                                     "bits")
            err = _check_scaled(what, yk, yp, *CALIB_TOL)
            twin_err = None
            if not bf:
                twin = calib.scan_calib_factored_ref(u, delta, At, B, C, T)
                twin_err = _check_scaled(what + " vs its factored twin", yk,
                                         twin, *CALIB_TWIN_TOL[dt_name])
                del twin
            Lp = yk.shape[1]
            del yk, yk2, yp
            exps = G_ * L * Dm * n
            c = dict(stage=st, G=G_, L=L, Dm=Dm, N=n, T=T, Lp=Lp,
                     dtype=dt_name, compute=mode, max_abs_err=err,
                     twin_err=twin_err, ms=_events_ms(run_k, 10),
                     plain_ms=_events_ms(run_p, 1),
                     bound=_calib_bound(cfg, T, dt_name), exps=exps,
                     mufu_ms=exps / MUFU_PER_S * 1e3)
            if st != "ragged":
                c["pass"] = calib.pass_info(G_, Lp, Dm, dtype, bf)
            if st == "0":
                _walk_split(c, run_k, CALIB_SPLIT)
            cases.append(c)
    summary = "; ".join(
        f"{c['stage']} G{c['G']} L{c['L']}->{c['Lp']} Dm{c['Dm']} N{c['N']} "
        f"T{c['T']} {c['dtype']} {c['compute']} compute "
        f"err={c['max_abs_err']:.2e}"
        + (f" twin={c['twin_err']:.2e}" if c["twin_err"] is not None else "")
        + f" kernel={c['ms']:.4f}ms plain={c['plain_ms']:.2f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]}) exps={c['exps']} "
        f"({c['mufu_ms']:.4f}ms at the MUFU rate)"
        + (" pass (registers/local B/shared B/warps per SM/threads/rows/"
           "blocks) " + "/".join(str(v) for v in c["pass"].values())
           if "pass" in c else "") + _split_text(c) for c in cases)
    print(f"phase 2q calibration kernel vs plain: {len(cases)}/"
          f"{2 * len(shapes)} cases within {CALIB_TOL} of kern's order "
          f"(rtol, atol x max|plain|), fp32 compute within "
          f"{CALIB_TWIN_TOL} of the kernel's order, second launch "
          f"bit-identical | {summary}", flush=True)
    return cases


def _bound(nbytes, ops, dtype):
    """The least time of the work on this card: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _walk_bound(operand_bytes, B, nc, l, H, P, N, isz, dtype, backward,
                save=False):
    """The chunk walk's least time (the dirs and the single-layout fused
    SSD): bytes each input read once and each output written once (the
    operands x, B, C of ``operand_bytes``; the fp32 rows acum, dte, dtp and
    cdec; y; with ``save``, the forward of training, Ssave out; backward:
    the operands, rows, Ssave and dy in, their cotangents out), and the
    products the function needs over the causal pairs j <= i of a chunk,
    l (l + 1) / 2 of them (per chunk: scores 2 pairs N; per head 2 pairs
    P + 4 l N P forward; the backward recomputes the scores and adds
    dscores' two products, 4 pairs P + 10 l N P per head)."""
    pairs = l * (l + 1) // 2
    rows = 3 * B * nc * H * l * 4 + B * nc * H * 4
    y = B * nc * l * H * P * isz
    ssave = B * nc * H * P * N * isz
    if not backward:
        nbytes = operand_bytes + rows + y + (ssave if save else 0)
        ops = B * nc * (2 * pairs * N + H * (2 * pairs * P + 4 * l * N * P))
    else:
        nbytes = 2 * operand_bytes + 2 * rows + ssave + y
        ops = B * nc * (3 * 2 * pairs * N
                        + H * (4 * pairs * P + 10 * l * N * P))
    return _bound(nbytes, ops, dtype)


def _ssd_bound(args, d_ssm, N, dtype, backward, save=False):
    """The dirs SSD's bound (``_walk_bound``; the operands are the stack;
    ``N`` the coupled state width, 4 gn)."""
    stack, acum = args[0], args[1]
    B, nc, l, _ = stack.shape
    H4 = acum.shape[2]
    return _walk_bound(stack.numel() * stack.element_size(), B, nc, l, H4,
                       d_ssm // (H4 // 4), N, stack.element_size(),
                       dtype, backward, save)


def _fused_bound(args, dtype, backward, save=False):
    """The single-layout fused SSD's bound (``_walk_bound``; the operands
    are C, B and x)."""
    Cc, Bc, acum, x = args[0], args[1], args[2], args[6]
    B, nc, l, N = Cc.shape
    H = acum.shape[2]
    isz = Cc.element_size()
    return _walk_bound((Cc.numel() + Bc.numel() + x.numel()) * isz, B, nc, l,
                       H, x.shape[3] // H, N, isz, dtype, backward, save)


def _scan_bound(L, Dm, dtype, backward, g=G, flags=False):
    """The selective scan at ``g`` sequences: the largest of three times.
    Bytes: u, Δ, B, C in and y out (backward: also dy and xsave, at the
    kernels' chunk ``CHUNK``, in; du, dΔ, dB, dC out; with the ``flags``,
    init in and last out, or dlast in and dinit out, fp32).  CUDA-core
    operations: ~7 fp32 operations per state per step forward (~20
    backward: the state recompute and the adjoint).  Exps at the MUFU rate:
    the function's own, one exp(dt A) per (step, channel, state) in each
    direction, as row 10's reading counts them.  Returns (ms, "bytes" or
    "operations"); the exps are operations."""
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd \
        import CHUNK
    isz = 4 if dtype == "fp32" else 2
    seq = g * L * (3 * Dm + 2 * N) * isz       # u, Δ, B, C and y (or dy)
    ops = (20 if backward else 7) * g * L * Dm * N
    states = 2 * g * N * Dm * 4 if flags else 0
    nbytes = seq + states
    if backward:
        xsave = g * -(-L // CHUNK) * N * Dm * 4
        out = g * L * (2 * Dm + 2 * N) * isz     # du, dΔ, dB, dC
        nbytes += xsave + out
    t, by = _bound(nbytes, ops, "fp32")
    t_mufu = g * L * Dm * N / MUFU_PER_S * 1e3
    return (t_mufu, "operations") if t_mufu > t else (t, by)


@functools.lru_cache(maxsize=None)
def _scan_passes(dt_name, backward):
    """What the card grants each pass of the scan kernel at N 16:
    {pass: (registers, local bytes, resident warps per SM)}."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as fwd)
    return fwd.pass_info(
        N, torch.bfloat16 if dt_name == "bf16" else torch.float32, backward)


def _occupancy_text(dt_name, backward):
    """'warps/SM local 16, carry 32, ...' for one case's line."""
    return "warps/SM " + ", ".join(
        f"{p} {w}" for p, (_, _, w) in _scan_passes(dt_name,
                                                   backward).items())


def _passes_text(backward):
    """Each pass's registers and local (spill) bytes, fp32 and bf16."""
    return "; ".join(
        f"{dt} " + ", ".join(f"{p} {r} regs {loc} B local"
                             for p, (r, loc, _) in
                             _scan_passes(dt, backward).items())
        for dt in ("fp32", "bf16"))


def _perturb_scan_params(model, gen):
    """Draw the scan parameters away from their init, so that the logit
    checks see the state term: at init D = 1 and Δ is small, so each scan
    output rounds back to its input in bf16."""
    import torch
    from medical_image_classification_tpu_torch.models.crossmamba import (
        CrossMamba)
    from medical_image_classification_tpu_torch.models.fusionmamba import (
        _ScanParams)
    from medical_image_classification_tpu_torch.models.ss2d_modules import (
        SS2D, SS2DSSD)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _ScanParams):
                # FusionMamba's scan layers: A, D and the dt bias also
                # different for each of the four sub-sequences (K 4)
                m.Ds.uniform_(-1.0, 1.0, generator=gen)
                dt = torch.empty(m.dt_projs_bias.shape).uniform_(
                    0.05, 0.5, generator=gen)
                m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.A_logs.copy_(torch.empty(m.A_logs.shape).uniform_(
                    1.0, 16.0, generator=gen).log())
                m.x_proj_weight.mul_(4.0)
            elif isinstance(m, SS2D):
                m.Ds.uniform_(-1.0, 1.0, generator=gen)
                dt = torch.empty(m.dt_projs_bias.shape).uniform_(
                    0.05, 0.5, generator=gen)
                m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.x_proj_weight.mul_(4.0)
            elif isinstance(m, (SS2DSSD, CrossMamba)):
                m.Ds.uniform_(-1.0, 1.0, generator=gen)
                dt = torch.empty(m.dt_bias.shape).uniform_(
                    0.05, 0.5, generator=gen)
                m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.A_logs.copy_(torch.empty(m.A_logs.shape).uniform_(
                    1.0, 16.0, generator=gen).log())


def _model(name, dtype, scan_impl, state_dict=None, **kw):
    """Seeded ``name`` on the card, in eval mode; without ``state_dict``
    its scan parameters are drawn away from init.  ``kw`` goes to
    create_model (``seq_axis``: the same weights, L-sharded scans)."""
    import torch
    from medical_image_classification_tpu_torch.models import create_model
    gen = torch.Generator().manual_seed(0)
    model = create_model(name, CLASSES, dtype=dtype, scan_impl=scan_impl,
                         generator=gen, **kw)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        _perturb_scan_params(model, gen)
    return model.cuda().eval()


def _counters():
    """Every kernel's wrapper by kernel name; each carries the count of its
    launches (``.launches``)."""
    from medical_image_classification_tpu_torch.kernels import (
        scan_calib as calib, selective_scan_bwd as ssb,
        selective_scan_fwd as ssf, selective_scan_v1 as v1, ssd_fused as sf,
        ssd_fused_dirs as sfd, ssd_ydiag as yd, stf_zgate as stf,
        stl_mixer as stl)
    return {"selective_scan_fwd": ssf.scan_folded_fwd,
            "selective_scan_bwd": ssb.scan_folded_bwd,
            "ssd_fused_dirs_fwd": sfd.ssd_fused_dirs_fwd,
            "ssd_fused_dirs_bwd": sfd.ssd_fused_dirs_bwd,
            "ssd_ydiag_fwd": yd.ydiag_fused_fwd,
            "ssd_ydiag_bwd": yd.ydiag_fused_bwd,
            "stl_mixer_fwd": stl.stl_mixer_fwd,
            "stl_mixer_bwd": stl.stl_mixer_bwd,
            "stf_zgate_fwd": stf.stf_zgate_fwd,
            "stf_zgate_bwd": stf.stf_zgate_bwd,
            "ssd_fused_fwd": sf.ssd_fused_fwd,
            "ssd_fused_bwd": sf.ssd_fused_bwd,
            "selective_scan_v1_fwd": v1.scan_v1_fwd,
            "selective_scan_v1_bwd": v1.scan_v1_bwd,
            "scan_calib": calib.scan_calib}


# What the model phases count and split, by (model, image size): {forward
# kernel: launches per model forward} (in training each forward kernel's
# backward, named *_bwd, launches as often) and {profile share: kernel name
# patterns}.  At 240x240 medssd runs the walk kernels of both layouts, which
# share their names; the layout type in the kernel's name tells them apart
PATHS = {
    ("medmamba", SIZE): (
        {"selective_scan_fwd": SCAN_CALLS_PER_FORWARD}, SCAN_SPLIT),
    ("medssd", SIZE): (
        {"ssd_fused_dirs_fwd": 2 + 2},               # blocks of stages 0-1
        {"ssd scores": (SSD_GRAM,),                  # both directions'
         "ssd forward": tuple(k for k in SSD_FWD_KERNELS if k != SSD_GRAM),
         "ssd backward": tuple(k for k in SSD_BWD_KERNELS
                               if k != SSD_GRAM)}),
    # Y_diag in stage 0's two blocks, the mixer and the gate in the blocks
    # of stages 0-1
    ("st_ssd", SIZE): (
        {"ssd_ydiag_fwd": 2, "stl_mixer_fwd": 4, "stf_zgate_fwd": 4},
        {**YDIAG_SHARES,
         "stl mixer": tuple(STL_FWD_SPLIT.values()),
         "stl mixer backward": tuple(STL_BWD_SPLIT.values()),
         "stf gate": tuple(STF_FWD_SPLIT.values()),
         "stf gate backward": tuple(STF_BWD_SPLIT.values())}),
    # stage 0 (L 3600) takes the dirs SSD at chunk 240, stage 1 (L 900, no
    # pad-free chunk in the dirs window) the single-layout fused SSD at
    # chunk 256 over 4 chunks, the last padded (900 -> 1024), stage 2 (L 225,
    # one chunk of 232) Y_diag at N 512, stage 3 the einsums: launches per
    # forward = the stages' depths
    ("medssd", MEDSSD_240): (
        {"ssd_fused_dirs_fwd": 2, "ssd_fused_fwd": 2, "ssd_ydiag_fwd": 4},
        {"ssd dirs": ("DirsLayout",),
         "ssd fused": ("FlatLayout",),
         **YDIAG_SHARES}),
}


# the SSD models at d_state 16 take medssd's kernels at 224x224: the dirs
# kernels at N 64 in the blocks of stages 0-1 (phase 2r holds that path
# against the einsum path)
for _name in ("cnn_mamba",) + SSD16_FULL + SSD16_STEP:
    PATHS[(_name, SIZE)] = PATHS[("medssd", SIZE)]


def _path(name, size=SIZE):
    """PATHS' entry for model ``name`` at ``size`` pixels a side."""
    if (name, size) not in PATHS:
        raise ValueError(f"chip_smoke has no path for {name} at {size}")
    return PATHS[(name, size)]


def _launches(counters):
    return {k: c.launches for k, c in counters.items()}


def _check_logits(name, got, want, tol):
    import numpy as np
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite logits")
    scale = float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    if err > tol * scale:
        raise AssertionError(f"{name}: kernel vs plain-scan logits max err "
                             f"{err:.3e} > {tol} x {scale:.3f}")
    return err


def phase_full_model(card, name, num, size=SIZE):
    import torch
    from medical_image_classification_tpu_torch.cli.test import run_eval
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    calls, split = _path(name, size)
    counters = _counters()
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    model = _model(name, bf16, "auto")
    run_eval(model, SyntheticLoader(BATCH, size, CLASSES, steps=1, seed=1),
             dev)                                      # warm-up
    loader = SyntheticLoader(BATCH, size, CLASSES, steps=STEPS, seed=0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    n_correct, labels, logits = run_eval(model, loader, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(counters)
    want = {k: calls.get(k, 0) * STEPS for k in counters}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches in {STEPS} forwards "
                             f"{launches}, expected {want}")
    if logits.shape != (BATCH * STEPS, CLASSES):
        raise AssertionError(f"logits shape {logits.shape}")
    img_s = BATCH * STEPS / seconds

    # the same weights with the plain versions, on the first batch
    sd = model.state_dict()
    one = SyntheticLoader(BATCH, size, CLASSES, steps=1, seed=0)
    _, _, ref16 = run_eval(_model(name, bf16, "torch", sd), one, dev)
    err16 = _check_logits("bf16", logits[:BATCH], ref16, LOGIT_TOL["bf16"])
    _, _, k32 = run_eval(_model(name, None, "cuda", sd), one, dev)
    _, _, ref32 = run_eval(_model(name, None, "torch", sd), one, dev)
    err32 = _check_logits("fp32", k32, ref32, LOGIT_TOL["fp32"])
    after = {k: want[k] + calls.get(k, 0) for k in counters}
    if _launches(counters) != after:
        raise AssertionError(f"the plain models launched a kernel, or the "
                             f"fp32 kernel model did not launch its own: "
                             f"{_launches(counters)}, expected {after}")

    from medical_image_classification_tpu_torch.train.eval_step import (
        make_eval_step)
    step = make_eval_step(model)
    x = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                      device=dev)
    y = torch.zeros(BATCH, dtype=torch.long, device=dev)
    # forwards on a batch already on the card: no host data, no copy
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(x, y)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) / STEPS * 1e3
    prof_rows = _profile(lambda: step(x, y))
    kernel_us = [r for r in prof_rows if r["cpu_us"] == 0.0]
    total_ms = sum(r["device_us"] for r in kernel_us) / 1e3
    hit = lambda r, pats: any(p in r["name"] for p in pats)
    times = {k: sum(r["device_us"] for r in kernel_us if hit(r, pats)) / 1e3
             for k, pats in split.items()}
    times["rest"] = total_ms - sum(times.values())
    top = ", ".join(f"{r['name'][:48]} {r['device_us'] / 1e3:.2f} ms"
                    for r in kernel_us[:4])
    per_fwd = ", ".join(f"{k} {v} ({v // STEPS} per forward)"
                        for k, v in launches.items() if v)
    print(f"phase {num} {name} {size}x{size} b{BATCH} bf16 via run_eval: "
          f"{STEPS} batches, kernel launches {per_fwd}, the other kernels "
          f"none; logits {logits.shape} finite "
          f"| kernel vs plain logits max err bf16 {err16:.3e} "
          f"(tol {LOGIT_TOL['bf16']} x max|logit|), fp32 {err32:.3e} "
          f"(tol {LOGIT_TOL['fp32']} x max|logit|) | eval {img_s:.2f} img/s "
          f"({seconds:.3f} s for {BATCH * STEPS} images, host data and "
          f"copies included) on {card} | forward wall time on a batch "
          f"already on the card {resident_ms:.2f} ms | one forward: "
          f"{total_ms:.2f} ms device time in kernels ("
          f"{100 * total_ms / resident_ms:.1f}% of the resident forward): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f"; top: {top}", flush=True)
    return dict(launches=launches, img_s=img_s, seconds=seconds,
                logit_err_bf16=err16, logit_err_fp32=err32,
                top1=n_correct / len(labels), device_forward_ms=total_ms,
                resident_forward_ms=resident_ms, forward_ms=times,
                profile=prof_rows)


# the captures ``_profile`` takes of a call before it gives up on one
# whose device records are short
PROFILE_TAKES = 3


def _profile(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler, no
    stacks), after one warm-up call: the capture's Chrome trace read by
    ``utils/profiling.py`` (``_rows_of_trace``); a row a kernel name, with
    no CPU time.  The capture opens with ``profiling.warm_up``; one in
    which a launch outside it has no device record is taken again, up to
    PROFILE_TAKES captures, then raises (``profiling.LostRecords``)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from medical_image_classification_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    for left in range(PROFILE_TAKES - 1, -1, -1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiling.warm_up()
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            prof.export_chrome_trace(os.path.join(
                d, "p" + profiling.TRACE_SUFFIX))
            try:
                return _rows_of_trace(profiling.load_trace(d))
            except profiling.LostRecords:
                if not left:
                    raise


def _rows_of_trace(tr):
    """The device events of a loaded trace (``profiling.attribute``; never
    a gpu_user_annotation span) as rows {name, count, device_us, cpu_us
    0}, by kernel name, longest first."""
    from medical_image_classification_tpu_torch.utils import profiling
    rows = {}
    for r in profiling.attribute(tr):
        row = rows.setdefault(r["name"], dict(name=r["name"], count=0,
                                              device_us=0.0, cpu_us=0.0))
        row["count"] += 1
        row["device_us"] += r["us"]
    return sorted(rows.values(), key=lambda r: -r["device_us"])


def _rows_of_key_averages(events):
    """The rows of a capture's ``key_averages()`` (``_profile``'s reader
    before the trace's, kept as phase 39's cross-check): rows with no CPU
    time are device kernels; a record_function region (the optimizer's
    step) also shows on the device as a span over its kernels, a row of
    its name with no CPU time, which is dropped, or the sums would count
    those kernels twice."""
    cpu_names = {ev.key for ev in events if ev.cpu_time_total > 0}
    rows = []
    for ev in events:
        if ev.cpu_time_total == 0 and (
                ev.key in cpu_names or getattr(ev, "is_user_annotation",
                                               False)):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        rows.append(dict(name=ev.key, count=ev.count,
                         device_us=float(dev_us),
                         cpu_us=float(ev.cpu_time_total)))
    rows.sort(key=lambda r: -r["device_us"])
    return rows


def _param_grads(model, imgs, labels, seed):
    """The train loss and every parameter's gradient on one batch (train
    mode: batch statistics, DropPath masks from ``seed``)."""
    from medical_image_classification_tpu_torch.data.image_folder import (
        normalize_batch)
    from medical_image_classification_tpu_torch.train.train_step import (
        cross_entropy_loss)
    model.train()
    model.seed_drop_path(seed)
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(normalize_batch(imgs)), labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().flatten()
                         for n, p in model.named_parameters()}


def _check_grad_tree(what, got, want, rtol, min_cos, abs_floor):
    """Leaf-wise: a leaf passes if its error norm is under ``abs_floor`` or
    its rel-norm error is <= rtol with cosine >= min_cos.  Returns the
    worst (rel-norm error, cosine) over the leaves above the floor."""
    errs = _leaf_errs(what, got, want, abs_floor)
    for name, (rel, cos) in errs.items():
        if rel > rtol or cos < min_cos:
            raise AssertionError(f"{what} {name}: rel-norm err {rel:.3e} "
                                 f"(tol {rtol}), cosine {cos:.6f} (min "
                                 f"{min_cos}), |plain| "
                                 f"{float(want[name].norm()):.3e}")
    return (max((r for r, _ in errs.values()), default=0.0),
            min((c for _, c in errs.values()), default=1.0))


def _check_grad_tree_exact(what, got, plain, exact, rtol, min_cos,
                          abs_floor):
    """The fp32 gradient trees ``got`` (the kernels) and ``plain`` (the
    plain twins) of one step, leaf-wise against ``exact`` (the same step in
    float64 through the plain einsums: the same weights, inputs and
    DropPath masks).  A leaf of ``got`` passes if its error norm is under
    ``abs_floor``, or if its rel-norm error is at most cap = rtol +
    COND_RATIO x the plain twins' rel-norm error on that leaf and its
    cosine at least min(min_cos, sqrt(1 - cap^2)) (where the plain twins
    are exact: the plain gate).  Raises if no leaf's error is over
    ``abs_floor`` (the gate would check none).  Returns the worst
    (rel-norm, cosine) of ``got`` and, for both paths, the leaves beyond
    (rtol, min_cos) of ``exact``, the worst leaf and the median leaf."""
    import math
    k = _leaf_errs(what, got, exact, abs_floor)
    if not k:
        raise AssertionError(f"{what}: no leaf's error is over the abs "
                             f"floor {abs_floor}, the gate checks none")
    p = _leaf_errs(what + " (plain twins)", plain, exact, -1.0)
    bad = {}
    for n, (r, c) in k.items():
        cap = rtol + COND_RATIO * p[n][0]
        if r > cap or c < min(min_cos, math.sqrt(max(0.0, 1.0 - cap * cap))):
            bad[n] = (r, c, p[n])
    if bad:
        raise AssertionError(
            f"{what}: {len(bad)} leaves beyond rel-norm {rtol} + "
            f"{COND_RATIO} x the plain twins' own error from the float64 "
            f"gradient, (kernels' rel, cos, (plain's rel, cos)): "
            f"{sorted(bad.items(), key=lambda kv: -kv[1][0])[:4]}")
    stats = {}
    for path, errs in (("kernels", k), ("plain", {
            n: v for n, v in p.items()
            if float((plain[n] - exact[n]).norm()) > abs_floor})):
        rels = sorted(r for r, _ in errs.values())
        stats[path] = dict(
            leaves_over_floor=len(errs),
            leaves_over_tol=sum(1 for r, c in errs.values()
                                if r > rtol or c < min_cos),
            worst_rel=rels[-1] if rels else 0.0,
            median_rel=rels[len(rels) // 2] if rels else 0.0,
            worst_cos=min((c for _, c in errs.values()), default=1.0))
    return stats["kernels"]["worst_rel"], stats["kernels"]["worst_cos"], stats


def _leaf_errs(what, got, want, abs_floor):
    """{leaf: (rel-norm error, cosine)} of the gradient tree ``got``
    against ``want``, over the leaves whose error norm is above
    ``abs_floor``; raises on a non-finite leaf."""
    import torch
    out = {}
    for name, w in want.items():
        g = got[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: non-finite gradient")
        diff = float((g - w).norm())
        if diff > abs_floor:
            out[name] = (diff / (float(w.norm()) + 1e-30),
                         float(g @ w) / (float(g.norm() * w.norm()) + 1e-30))
    return out


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block, its defaults (the
    CLIs') outside it."""
    import torch
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _trained_state(name, size, **kw):
    """The weights of phase_train's training (the seeded model, one warm-up
    step and STEPS Adam steps on the same batches; ``kw`` to create_model,
    GRAD_DEPTHS) made again under cuDNN's deterministic algorithms, so that the gradient check sees the same
    weights in every run: with cuDNN's defaults cnn_mamba_mifa's stem and
    MIFA convs sum their weight gradients in another order from run to
    run."""
    import torch
    from medical_image_classification_tpu_torch.cli.train import run_train
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState)
    with _cudnn_deterministic():
        model = _model(name, torch.bfloat16, "auto", **kw)
        model.seed_drop_path(1)
        opt = make_optimizer("adam", model.named_parameters())
        sched = make_lr_scheduler(opt, make_schedule("constant", 1e-4))
        state = TrainState()
        for steps, seed in ((1, 1), (STEPS, 2)):
            run_train(model, opt, sched,
                      SyntheticLoader(BATCH, size, CLASSES, steps=steps,
                                      seed=seed), torch.device("cuda"),
                      state=state)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _grad_check(name, sd, imgs, labels, **kw):
    """Every parameter's gradient of ``name`` (``kw`` to create_model) at
    the weights ``sd`` on one batch (the same DropPath masks), kernels against the plain versions,
    under cuDNN's deterministic algorithms: in fp32 leaf-wise within
    PARAM_GRAD_TOL of the plain gradients, in bf16 each path's median leaf
    distance from the fp32 plain gradients, the kernels' at most
    BF16_GRAD_RATIO times the plain versions'.  Returns the numbers and a
    line that states them."""
    import torch
    loss, grads = {}, {}
    for dt_name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        for impl in ("cuda", "torch"):
            with _cudnn_deterministic():
                loss[dt_name, impl], grads[dt_name, impl] = _param_grads(
                    _model(name, dtype, impl, sd, **kw), imgs, labels, 7)
    ref = grads["fp32", "torch"]
    rel32, cos32 = _check_grad_tree("fp32 param grad", grads["fp32", "cuda"],
                                    ref, *PARAM_GRAD_TOL)
    dist = {impl: [float((grads["bf16", impl][n] - w).norm() / w.norm())
                   for n, w in ref.items()] for impl in ("cuda", "torch")}
    med16 = {impl: sorted(d)[len(d) // 2] for impl, d in dist.items()}
    if not med16["cuda"] <= BF16_GRAD_RATIO * med16["torch"] + 1e-3:
        raise AssertionError(
            f"bf16 param grads: the kernels' median leaf distance from the "
            f"fp32 plain gradients {med16['cuda']:.3e} exceeds "
            f"{BF16_GRAD_RATIO} x the plain versions' {med16['torch']:.3e}")
    ratio = med16["cuda"] / max(med16["torch"], 1e-30)
    text = (f"fp32 loss {loss['fp32', 'cuda']:.6f} vs "
            f"{loss['fp32', 'torch']:.6f}, worst leaf rel-norm {rel32:.2e} "
            f"cos {cos32:.6f} over {len(ref)} leaves (tol {PARAM_GRAD_TOL}); "
            f"bf16 median (max) leaf distance from the fp32 plain "
            f"gradients: kernels {med16['cuda']:.3e} "
            f"({max(dist['cuda']):.3e}), plain {med16['torch']:.3e} "
            f"({max(dist['torch']):.3e}), ratio {ratio:.3f} (max "
            f"{BF16_GRAD_RATIO})")
    return dict(loss={f"{d} {i}": v for (d, i), v in loss.items()},
                fp32_worst_rel=rel32, fp32_worst_cos=cos32, leaves=len(ref),
                bf16_median_dist=med16, bf16_ratio=ratio,
                bf16_max_dist={i: max(d) for i, d in dist.items()}), text


def phase_train(card, name, num, size=SIZE):
    import math

    import torch
    from medical_image_classification_tpu_torch.cli.train import run_train
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState, make_train_step)
    calls, split = _path(name, size)
    pairs = {f: f[:-len("fwd")] + "bwd" for f in calls}
    counters = _counters()
    want = {k: 0 for k in counters}
    for f, b in pairs.items():
        want[f] = want[b] = calls[f] * STEPS
    dev = torch.device("cuda")
    model = _model(name, torch.bfloat16, "auto")
    model.seed_drop_path(1)
    opt = make_optimizer("adam", model.named_parameters())
    sched = make_lr_scheduler(opt, make_schedule("constant", 1e-4))
    state = TrainState()
    run_train(model, opt, sched, SyntheticLoader(BATCH, size, CLASSES,
                                                 steps=1, seed=1), dev,
              state=state)                              # warm-up
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loader = SyntheticLoader(BATCH, size, CLASSES, steps=STEPS, seed=2)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    m = run_train(model, opt, sched, loader, dev, state=state)
    launches = _launches(counters)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches in {STEPS} train "
                             f"steps {launches}, expected {want}")
    if not math.isfinite(m["loss"]) or state.step != 1 + STEPS:
        raise AssertionError(f"train loss {m['loss']}, step {state.step}")
    still = sorted(n for n, p in model.named_parameters()
                   if torch.equal(p, before[n]))
    if still:
        raise AssertionError(f"{len(still)} parameters did not move in "
                             f"{STEPS} Adam steps: {still[:5]}")

    # every parameter's gradient: kernels against the plain versions, same
    # weights (this training's, made again deterministically, at
    # GRAD_DEPTHS), same batch of GRAD_BATCH, same DropPath masks
    imgs, labels = next(SyntheticLoader(GRAD_BATCH, size, CLASSES, steps=1,
                                        seed=3).epoch(0))
    imgs = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(labels).long().to(dev)
    kw = GRAD_DEPTHS.get(name, {})
    grad_check, gc = _grad_check(name, _trained_state(name, size, **kw),
                                 imgs, labels, **kw)

    step = make_train_step(model, opt, sched, state=state)
    x = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                      device=dev)
    y = torch.zeros(BATCH, dtype=torch.long, device=dev)
    # steps on a batch already on the card: no host data, no copy
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(x, y)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) / STEPS * 1e3
    rows = [r for r in _profile(lambda: step(x, y)) if r["cpu_us"] == 0.0]
    hit = lambda r, pats: any(p in r["name"] for p in pats)
    times = {k: sum(r["device_us"] for r in rows if hit(r, pats)) / 1e3
             for k, pats in split.items()}
    total_ms = sum(r["device_us"] for r in rows) / 1e3
    times["rest"] = total_ms - sum(times.values())
    rest = [r for r in rows if not any(hit(r, p) for p in split.values())]
    top = ", ".join(f"{r['name'][:40]} {r['device_us'] / 1e3:.2f} ms"
                    for r in rest[:4])
    per_step = ", ".join(f"{f} + {b} {launches[f]} + {launches[b]} "
                         f"({launches[f] // STEPS} + {launches[b] // STEPS} "
                         f"per step)" for f, b in pairs.items())
    print(f"phase {num} {name} {size}x{size} b{BATCH} bf16 training via "
          f"run_train, Adam 1e-4: {STEPS} steps after 1 warm-up, kernel "
          f"launches {per_step}, the other kernels none, loss "
          f"{m['loss']:.4f} finite, "
          f"all {len(before)} parameters moved | train {m['img_s']:.2f} img/s "
          f"({m['seconds']:.3f} s for {BATCH * STEPS} images, host data and "
          f"copies included) on {card} | param grads kernels vs plain, "
          f"batch {GRAD_BATCH}"
          + (f", depths {kw['depths']}" if kw else "") + f": {gc} | step "
          f"wall time: "
          f"{m['seconds'] / STEPS * 1e3:.2f} ms through run_train, "
          f"{resident_ms:.2f} ms on a batch already on the card | one step: "
          f"{total_ms:.2f} ms device time in kernels ("
          f"{100 * total_ms / resident_ms:.1f}% of the resident step): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f"; top of the rest: {top}", flush=True)
    return dict(launches=launches, loss=m["loss"], img_s=m["img_s"], seconds=m["seconds"],
                resident_step_ms=resident_ms, device_step_ms=total_ms,
                grad_check=grad_check, step_ms=times, profile=rows)


def _ssd16_core_inputs(side, d_ssm, seed):
    """The d_state-16 core's inputs at one stage, bf16 on the card: xBCdt
    [B, side, side, d_ssm + 2 x 16 + nheads], A_log, dt_bias and Ds drawn
    as _perturb_scan_params draws them, and a cotangent."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    nheads = d_ssm // SSD_P
    x = (0.5 * torch.randn(BATCH, side, side, d_ssm + 2 * 16 + nheads,
                           device=dev, generator=gen)).bfloat16()
    A_log = (1.0 + 15.0 * torch.rand(4, nheads, device=dev,
                                     generator=gen)).log()
    dt = 0.05 + 0.45 * torch.rand(4, nheads, device=dev, generator=gen)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    Ds = 2.0 * torch.rand(4, nheads, device=dev, generator=gen) - 1.0
    dy = torch.randn(BATCH, side, side, d_ssm, device=dev,
                     generator=gen).bfloat16()
    return (x, A_log, dt_bias, Ds), dy, nheads


def phase_ssd16_paths():
    """2r: the d_state-16 models' SSD core at their stages 0-1 (224x224,
    B 32, bf16) through the port's two paths: the dirs kernels (the gate's
    choice) and the einsum path (forced), which takes Y_diag at stage 0
    where ``ydiag_supported(card=True)`` says so.  Forward (no_grad) and
    forward + backward, CUDA events, the two paths' outputs against each
    other, each path's kernel launches."""
    import torch
    from medical_image_classification_tpu_torch.ops import ss2d as oss
    counters = _counters()
    gate = oss.ssd_dirs_chunk
    rows = []
    for side, d_ssm in SSD16_CORE:
        args, dy, nheads = _ssd16_core_inputs(side, d_ssm, side)
        kw = dict(d_ssm=d_ssm, d_state=16, nheads=nheads, headdim=SSD_P,
                  chunk_size=256)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]

        def fwd():
            with torch.no_grad():
                return oss.ss2d_core_ssd(*args, **kw)

        def fwd_bwd():
            y = oss.ss2d_core_ssd(*leaves, **kw)
            torch.autograd.backward(y, dy)
            return y

        row = dict(side=side, L=side * side, d_ssm=d_ssm)
        outs = {}
        for path in ("dirs", "einsum"):
            oss.ssd_dirs_chunk = gate if path == "dirs" else \
                (lambda *a, **k: None)
            try:
                fwd(), fwd_bwd()                          # warm-up
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                outs[path] = fwd()
                fwd_bwd()
                torch.cuda.synchronize()
                launches = {k: v for k, v in _launches(counters).items()
                            if v}
                row[path] = dict(fwd_ms=_events_ms(fwd, 10),
                                 fwd_bwd_ms=_events_ms(fwd_bwd, 10),
                                 launches=launches)
            finally:
                oss.ssd_dirs_chunk = gate
        want = {"dirs": {"ssd_fused_dirs_fwd": 2, "ssd_fused_dirs_bwd": 1},
                "einsum": ({"ssd_ydiag_fwd": 2, "ssd_ydiag_bwd": 1}
                           if side == SSD16_CORE[0][0] else {})}
        for path, w in want.items():
            if row[path]["launches"] != w:
                raise AssertionError(f"2r L={side * side} {path}: launches "
                                     f"{row[path]['launches']}, expected {w}")
        rtol, atol = SSD_TOL["bf16"]
        row["paths_err"] = _check_scaled(
            f"2r L={side * side} dirs vs einsum y", outs["dirs"],
            outs["einsum"], rtol, atol)
        row["faster"] = {m: min(("dirs", "einsum"),
                                key=lambda p: row[p][m + "_ms"])
                         for m in ("fwd", "fwd_bwd")}
        rows.append(row)
        del leaves, outs
    print("phase 2r d_state-16 SSD core, dirs path vs einsum path (Y_diag at "
          "stage 0), B 32 bf16, N 64: " + "; ".join(
              f"L {r['L']} d_ssm {r['d_ssm']}: forward dirs "
              f"{r['dirs']['fwd_ms']:.3f} ms vs einsum "
              f"{r['einsum']['fwd_ms']:.3f} ms, forward+backward dirs "
              f"{r['dirs']['fwd_bwd_ms']:.3f} ms vs einsum "
              f"{r['einsum']['fwd_bwd_ms']:.3f} ms (faster: {r['faster']}), "
              f"launches dirs {r['dirs']['launches']} einsum "
              f"{r['einsum']['launches']}, y of the two paths within "
              f"{SSD_TOL['bf16']} (max err {r['paths_err']:.2e})"
              for r in rows), flush=True)
    return rows


def phase_model_step(card, name, num, size=SIZE):
    """One eval forward through run_eval and one Adam step through
    run_train at full width (b32, bf16): each kernel's launches exactly
    the path's, the logits against the same weights with the plain
    versions, a finite loss, every parameter moved."""
    import math

    import torch
    from medical_image_classification_tpu_torch.cli.test import run_eval
    from medical_image_classification_tpu_torch.cli.train import run_train
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState)
    calls, _ = _path(name, size)
    counters = _counters()
    dev = torch.device("cuda")
    model = _model(name, torch.bfloat16, "auto")
    one = SyntheticLoader(BATCH, size, CLASSES, steps=1, seed=0)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, _, logits = run_eval(model, one, dev)
    eval_s = time.perf_counter() - t0
    want = {k: calls.get(k, 0) for k in counters}
    if _launches(counters) != want:
        raise AssertionError(f"{name}: launches in one forward "
                             f"{_launches(counters)}, expected {want}")
    _, _, ref = run_eval(_model(name, torch.bfloat16, "torch",
                                model.state_dict()), one, dev)
    err = _check_logits(f"{name} bf16", logits, ref, LOGIT_TOL["bf16"])
    model.seed_drop_path(1)
    opt = make_optimizer("adam", model.named_parameters())
    sched = make_lr_scheduler(opt, make_schedule("constant", 1e-4))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for c in counters.values():
        c.launches = 0
    m = run_train(model, opt, sched, SyntheticLoader(BATCH, size, CLASSES,
                                                     steps=1, seed=2), dev,
                  state=TrainState())
    want = {k: 0 for k in counters}
    for f, n in calls.items():
        want[f] = want[f[:-len("fwd")] + "bwd"] = n
    if _launches(counters) != want:
        raise AssertionError(f"{name}: launches in one train step "
                             f"{_launches(counters)}, expected {want}")
    still = sorted(n for n, p in model.named_parameters()
                   if torch.equal(p, before[n]))
    if not math.isfinite(m["loss"]) or still:
        raise AssertionError(f"{name}: loss {m['loss']}, {len(still)} "
                             f"parameters did not move: {still[:5]}")
    per = ", ".join(f"{k} {v}" for k, v in want.items() if v)
    print(f"phase {num} {name} {size}x{size} b{BATCH} bf16: one forward "
          f"via run_eval and one Adam step via run_train, kernel launches "
          f"{per} (forward + step), the other kernels none; logits "
          f"{tuple(logits.shape)} finite, vs plain max err {err:.3e} (tol "
          f"{LOGIT_TOL['bf16']} x max|logit|); loss {m['loss']:.4f}, all "
          f"{len(before)} parameters moved | first-call wall time on {card}: "
          f"eval {eval_s:.3f} s, train step {m['seconds']:.3f} s",
          flush=True)
    return dict(logit_err_bf16=err, loss=m["loss"], launches=want,
                params=len(before), eval_s=eval_s, step_s=m["seconds"])


def _refit_err(head, before, w_name, feats):
    """The card's re-grid of the ekan or okan ``head`` against the same
    re-grid in fp64 on the host (``ops/kan.py`` from the head's inputs
    ``feats`` and its weights ``before`` the re-grid): the knots' largest
    distance over each input's knot span, and the two refit heads' outputs
    on ``feats`` (fp32 on the host), the largest difference over max|y|."""
    from medical_image_classification_tpu_torch.ops import kan as kan_ops
    host = {k[len("kan."):]: v.cpu() for k, v in before.items()
            if k.startswith("kan.")}
    x = feats.cpu().double()
    w0 = host[w_name].double()
    if w_name == "spline_weight":
        grid, w = kan_ops.kan_update_grid(
            x, host["grid"].double(), w0, host["spline_scaler"].double(),
            grid_size=head.grid_size, spline_order=head.spline_order)

        def out(g, w):
            return kan_ops.kan_linear(x.float(), g, host["base_weight"],
                                      w, host["spline_scaler"],
                                      head.spline_order)
    else:
        grid, w = kan_ops.okan_update_grid(x, host["grid"].double(), w0,
                                           head.k, head.num)

        def out(g, c):
            return kan_ops.okan_forward(x.float(), g, c,
                                        host["scale_base"],
                                        host["scale_sp"], host["mask"],
                                        head.k)
    card_grid = head.grid.cpu()
    span = grid[:, -1:] - grid[:, :1]
    grid_err = float(((card_grid.double() - grid).abs() / span).max())
    y_card = out(card_grid, getattr(head, w_name).detach().cpu())
    y_host = out(grid.float(), w.float())
    y_err = float((y_card - y_host).abs().max() / y_host.abs().max())
    return grid_err, y_err


def phase_kan_regrid(card, name, num, size=SIZE):
    """``kan_grid_update`` of the full model on one batch on the card: the
    head's grid and spline weights re-fit in place (the same Parameter),
    no other state moved, one forward's kernel launches, the logits on
    that batch kept within REGRID_TOL x max|logit|, and the re-grid within
    REFIT_GRID_TOL / REFIT_TOL of the same re-grid in fp64 on the host."""
    import torch
    from medical_image_classification_tpu_torch.data.image_folder import (
        normalize_batch)
    from medical_image_classification_tpu_torch.train.train_step import (
        kan_grid_update)
    calls, _ = _path(name, size)
    counters = _counters()
    model = _model(name, torch.bfloat16, "auto")
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                      generator=gen).cuda()
    head = model.kan
    w_name = "spline_weight" if hasattr(head, "spline_weight") else "coef"
    param = getattr(head, w_name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        y0 = model(normalize_batch(x))
    feats = []
    hook = head.register_forward_pre_hook(
        lambda m, args: feats.append(args[0].detach().clone()))
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    kan_grid_update(model, x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hook.remove()
    want = {k: calls.get(k, 0) for k in counters}
    if _launches(counters) != want:
        raise AssertionError(f"{name} re-grid: launches "
                             f"{_launches(counters)}, expected {want}")
    moved = sorted(k for k, v in model.state_dict().items()
                   if not torch.equal(v, before[k]))
    if moved != sorted(["kan.grid", f"kan.{w_name}"]) or \
            getattr(head, w_name) is not param:
        raise AssertionError(f"{name} re-grid moved {moved}")
    with torch.no_grad():
        y1 = model(normalize_batch(x))
    scale = float(y0.abs().max())
    err = float((y1 - y0).abs().max())
    if not bool(torch.isfinite(y1).all()) or err > REGRID_TOL * scale:
        raise AssertionError(f"{name} re-grid: logits moved by {err:.3e} > "
                             f"{REGRID_TOL} x {scale:.3f}")
    grid_err, refit_err = _refit_err(head, before, w_name, feats[0])
    if not (grid_err <= REFIT_GRID_TOL and refit_err <= REFIT_TOL):
        raise AssertionError(
            f"{name} re-grid against fp64 on the host: knots {grid_err:.3e}"
            f" x span (tol {REFIT_GRID_TOL}), refit output {refit_err:.3e}"
            f" x max|y| (tol {REFIT_TOL})")
    print(f"phase {num} {name} kan_grid_update on the card ({size}x{size} "
          f"b{BATCH} bf16 backbone, fp32 head): head grid and {w_name} "
          f"re-fit in place, nothing else moved, one forward's launches; "
          f"logits on the batch moved by {err:.3e} = {err / scale:.2e} x "
          f"max|logit| (tol {REGRID_TOL}); against the same re-grid in fp64"
          f" on the host: knots within {grid_err:.2e} x span (tol "
          f"{REFIT_GRID_TOL}), refit output within {refit_err:.2e} x "
          f"max|y| (tol {REFIT_TOL}); {seconds * 1e3:.1f} ms wall on "
          f"{card}", flush=True)
    return dict(logit_shift=err, logit_scale=scale, grid_err=grid_err,
                refit_err=refit_err, ms=seconds * 1e3)


def _lm_model(n_layer, scan_impl="auto"):
    """Seeded mamba-130m (``n_layer`` of its 24 layers) on the card in
    eval mode, its scan parameters drawn away from init so that the logit
    checks see the state term: D ~ U(-1, 1), Δ's bias the softplus-inverse
    of U(0.05, 0.5), A_log = log U(1, 16), x_proj's weight (B, C and Δ's
    rank) times 4."""
    import torch
    from medical_image_classification_tpu_torch.models.mamba_lm import (
        Mamba, MambaConfig, MambaLMHeadModel)
    gen = torch.Generator().manual_seed(0)
    model = MambaLMHeadModel(MambaConfig(n_layer=n_layer),
                             scan_impl=scan_impl, generator=gen)
    draw = lambda t, lo, hi: torch.empty(t.shape).uniform_(lo, hi,
                                                           generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Mamba):
                m.D.copy_(draw(m.D, -1.0, 1.0))
                dt = draw(m.dt_proj.bias, 0.05, 0.5)
                m.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.A_log.copy_(draw(m.A_log, 1.0, 16.0).log())
                m.x_proj.weight.mul_(4.0)
    return model.eval()


def _set_scan_impl(model, impl):
    from medical_image_classification_tpu_torch.models.mamba_lm import Mamba
    for m in model.modules():
        if isinstance(m, Mamba):
            m.scan_impl = impl


def _lm_tokens(batch, length, seed, vocab=50277):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (batch, length), device="cuda",
                         generator=gen)


def _lm_state_loss(model, ids):
    """The LM's forward with every mixer returning its last state: the
    next-token cross-entropy, and the sum over the layers of each last
    state's mean square over its own (constant) value: a term worth 1 per
    layer whatever the states' scale, so that the scan's dlast carries
    weight on the gradient's path."""
    import torch.nn.functional as F
    bb = model.backbone
    h, states = bb.embedding(ids), 0.0
    for blk in bb.layers:
        y, last = blk.mixer(blk.norm(h), return_state=True)
        h = h + y
        sq = last.square().mean()
        states = states + sq / sq.detach()
    logits = model.lm_head(bb.norm_f(h))
    ce = F.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())
    return ce, states


def phase_lm_scoring(card):
    """11: the Mamba-1 LM at mamba-130m width and depth, fp32, scoring
    LM_BATCH x LM_LEN tokens: the kernel launches of one forward (the scan
    forward once per layer, every other kernel none), the logits against
    the same model with the plain scan, tokens/s (host clock over
    forwards ending in a synchronize), the device time of one forward and
    the scan's share of it (torch.profiler); then the gradient check at
    LM_GRAD_LAYERS layers: every parameter's gradient of the cross-entropy
    plus the last states' term (``_lm_state_loss``), kernels against the
    plain scan, and the launches of that step."""
    import torch
    import torch.nn.functional as F
    counters = _counters()
    model = _lm_model(LM_LAYERS)
    ids = _lm_tokens(LM_BATCH, LM_LEN, 1)
    with torch.no_grad():
        model(ids[:, :64])                                  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        logits = model(ids)
        torch.cuda.synchronize()
        launches = _launches(counters)
        want = {k: LM_LAYERS if k == "selective_scan_fwd" else 0
                for k in counters}
        if launches != want:
            raise AssertionError(f"LM forward: kernel launches {launches}, "
                                 f"expected {want}")
        V = logits.shape[-1]
        if logits.shape != (LM_BATCH, LM_LEN, V) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"LM logits {tuple(logits.shape)} not "
                                 "finite or of the wrong shape")
        nll = float(F.cross_entropy(logits[:, :-1].flatten(0, 1),
                                    ids[:, 1:].flatten()))
        t0 = time.perf_counter()
        for _ in range(STEPS):
            model(ids)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) / STEPS * 1e3
        rows = [r for r in _profile(lambda: model(ids))
                if r["cpu_us"] == 0.0]
        device_ms = sum(r["device_us"] for r in rows) / 1e3
        scan_ms = sum(r["device_us"] for r in rows
                      if any(p in r["name"] for p in SCAN_FWD_KERNELS)) / 1e3
        _set_scan_impl(model, "torch")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        plain = model(ids)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        scale = float(plain.abs().max())
        err = float((logits - plain).abs().max())
        if err > LM_LOGIT_TOL * scale:
            raise AssertionError(f"LM logits kernel vs plain scan max err "
                                 f"{err:.3e} > {LM_LOGIT_TOL} x {scale:.3f}")
        plain_nll = float(F.cross_entropy(plain[:, :-1].flatten(0, 1),
                                          ids[:, 1:].flatten()))
        if any(_launches(counters).values()):
            raise AssertionError("the plain-scan LM launched a kernel")
        del logits, plain
    top = ", ".join(f"{r['name'][:40]} {r['device_us'] / 1e3:.2f} ms"
                    for r in rows[:4])
    tokens_s = LM_BATCH * LM_LEN / fwd_ms * 1e3
    print(f"phase 11 LM scoring (mamba-130m: d_model 768, {LM_LAYERS} "
          f"layers, vocab {V}, fp32) b{LM_BATCH} x {LM_LEN} tokens: kernel "
          f"launches selective_scan_fwd {launches['selective_scan_fwd']} "
          f"per forward, the other kernels none; logits finite, mean NLL "
          f"{nll:.4f} (plain scan {plain_nll:.4f}) | kernel vs plain-scan "
          f"logits max err {err:.3e} (tol {LM_LOGIT_TOL} x max|logit| "
          f"{scale:.3f}) | {tokens_s:.1f} tokens/s, {fwd_ms:.2f} ms per "
          f"forward (host clock, {STEPS} forwards) on {card}; the plain-scan "
          f"forward {plain_s:.2f} s | one forward: {device_ms:.2f} ms device "
          f"time in kernels ({100 * device_ms / fwd_ms:.1f}% of the "
          f"forward), the scan {scan_ms:.2f} ms "
          f"({100 * scan_ms / device_ms:.1f}%); top: {top}", flush=True)
    del model
    torch.cuda.empty_cache()

    # the gradient check, at LM_GRAD_LAYERS layers
    model = _lm_model(LM_GRAD_LAYERS)
    ids = _lm_tokens(LM_GRAD_BATCH, LM_GRAD_LEN, 2)
    model.train()
    grads, losses = {}, {}
    for impl in ("cuda", "torch"):
        _set_scan_impl(model, impl)
        model.zero_grad(set_to_none=True)
        for c in counters.values():
            c.launches = 0
        ce, states = _lm_state_loss(model, ids)
        (ce + states).backward()
        torch.cuda.synchronize()
        got = _launches(counters)
        n = LM_GRAD_LAYERS if impl == "cuda" else 0
        want = {k: n if k in ("selective_scan_fwd", "selective_scan_bwd")
                else 0 for k in counters}
        if got != want:
            raise AssertionError(f"LM gradient step ({impl}): kernel "
                                 f"launches {got}, expected {want}")
        losses[impl] = (float(ce.detach()), float(states.detach()))
        grads[impl] = {nm: p.grad.detach().double().flatten()
                       for nm, p in model.named_parameters()}
    rel, cos = _check_grad_tree("LM param grad", grads["cuda"],
                                grads["torch"], *PARAM_GRAD_TOL)
    # every leaf, the abs floor aside (fp32: the leaves may all fall under it)
    diffs = {nm: float((grads["cuda"][nm] - w).norm())
             for nm, w in grads["torch"].items()}
    rel_all = max(d / (float(grads["torch"][nm].norm()) + 1e-30)
                  for nm, d in diffs.items())
    print(f"phase 11 LM gradient check ({LM_GRAD_LAYERS} layers, full "
          f"width, b{LM_GRAD_BATCH} x {LM_GRAD_LEN}, fp32, every mixer "
          f"returning its last state): launches selective_scan_fwd + bwd "
          f"{LM_GRAD_LAYERS} + {LM_GRAD_LAYERS}, the other kernels none; "
          f"loss (cross-entropy, last-state term) kernels "
          f"{losses['cuda'][0]:.6f}, {losses['cuda'][1]:.6f} vs plain "
          f"{losses['torch'][0]:.6f}, {losses['torch'][1]:.6f}; worst leaf "
          f"rel-norm {rel:.2e} cos {cos:.6f} over {len(grads['torch'])} "
          f"leaves (tol {PARAM_GRAD_TOL}); without the floor: worst leaf "
          f"rel-norm {rel_all:.2e}, largest error norm "
          f"{max(diffs.values()):.2e}", flush=True)
    del model, grads
    torch.cuda.empty_cache()
    return dict(launches_per_forward=launches["selective_scan_fwd"],
                tokens_s=tokens_s, forward_ms=fwd_ms,
                device_forward_ms=device_ms, scan_ms=scan_ms,
                scan_share=scan_ms / device_ms, logit_err=err,
                logit_scale=scale, nll=nll, plain_nll=plain_nll,
                plain_forward_s=plain_s, grad_worst_rel=rel,
                grad_worst_cos=cos, grad_worst_rel_no_floor=rel_all,
                grad_losses=losses, profile=rows)


def phase_lm_generate(card):
    """12: greedy generation on the card with the full-depth LM:
    GEN_PROMPTS prompts of GEN_PROMPT_LEN tokens and GEN_NEW new tokens
    through ``generate`` (prefill and decoding through decode_step, plain
    torch ops: no kernel launches); each new token equal to the argmax of
    the full forward (the scan kernel) over the generated sequence, and
    decode_step's logits over that sequence against the full forward's;
    decode ms per token and new tokens/s (host clock)."""
    import torch
    from medical_image_classification_tpu_torch.models.mamba_lm import (
        generate)
    counters = _counters()
    model = _lm_model(LM_LAYERS)
    prompts = _lm_tokens(GEN_PROMPTS, GEN_PROMPT_LEN, 3)
    generate(model, prompts[:, :2], 2)                      # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = generate(model, prompts, GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = sum(_launches(counters).values())
    if gen_launches or out.shape != (GEN_PROMPTS, GEN_PROMPT_LEN + GEN_NEW):
        raise AssertionError(f"generate: {gen_launches} kernel launches, "
                             f"tokens {tuple(out.shape)}")
    with torch.no_grad():
        full = model(out)
        fwd_launches = _launches(counters)["selective_scan_fwd"]
        if fwd_launches != LM_LAYERS:
            raise AssertionError(f"full forward: {fwd_launches} scan "
                                 f"launches, expected {LM_LAYERS}")
        pred = full[:, GEN_PROMPT_LEN - 1:-1].argmax(-1)
        same = int((pred == out[:, GEN_PROMPT_LEN:]).sum())
        if same != GEN_PROMPTS * GEN_NEW:
            raise AssertionError(f"generate: {same} of {GEN_PROMPTS * GEN_NEW}"
                                 " new tokens equal the full forward's "
                                 "argmax")
        top2 = full[:, GEN_PROMPT_LEN - 1:-1].topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        cache = model.init_cache(GEN_PROMPTS)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(out.shape[1]):
            logits, cache = model.decode_step(out[:, t], cache)
            steps.append(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / out.shape[1] * 1e3
        dec = torch.stack(steps, dim=1)
        scale = float(full.abs().max())
        err = float((dec - full).abs().max())
        if err > LM_LOGIT_TOL * scale:
            raise AssertionError(f"decode_step vs full forward logits max err "
                                 f"{err:.3e} > {LM_LOGIT_TOL} x {scale:.3f}")
    steps_run = GEN_PROMPT_LEN + GEN_NEW - 1
    tokens_s = GEN_PROMPTS * GEN_NEW / gen_s
    print(f"phase 12 LM generate (mamba-130m, fp32, greedy): {GEN_PROMPTS} "
          f"prompts x {GEN_PROMPT_LEN} tokens + {GEN_NEW} new in "
          f"{gen_s:.3f} s ({steps_run} decode steps, "
          f"{gen_s / steps_run * 1e3:.2f} ms per step, {tokens_s:.1f} new "
          f"tokens/s) on {card}, no kernel launches; all {same} new tokens "
          f"equal the full forward's argmax (smallest top-2 margin "
          f"{margin:.3e}; the forward {fwd_launches} scan launches) | "
          f"decode_step over the {out.shape[1]} tokens vs the full forward: "
          f"logits max err {err:.3e} (tol {LM_LOGIT_TOL} x max|logit| "
          f"{scale:.3f}), {step_ms:.2f} ms per step", flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(seconds=gen_s, tokens_s=tokens_s,
                ms_per_step=gen_s / steps_run * 1e3,
                decode_loop_ms_per_step=step_ms, tokens_equal=same,
                top2_margin=margin, decode_logit_err=err)


def phase_kernel_bench(card):
    """13: the port's kernel bench (``scripts/kernel_bench.py``) through its
    ``main`` three times: --stage all at the default cap (each stage on the
    two-level kernels: one forward launch per forward call and per fwd+bwd
    call, one backward launch per fwd+bwd call) and --stage all --t-cap 50
    (the same counts on the v1 pair, and no two-level launch), each at
    --iters 3, and --stage all --calibrate at the script's default --iters
    20 (the calibration kernel once per call, nothing else: at ~0.2 ms a
    call, 3 calls would time the host); every counter set to 0 just before
    each run, and read around each stage; the calibration's reading beside
    the --t-cap 50 forward's at each stage (both calls end in the same
    ``y.float().sum()``).  Then rows 1 and 3 (and 2 and 4) at the bench's
    stage 0 in bf16, each writing the xsave its backward reads (chunks of
    fwd.CHUNK and of T 50), timed in turns (1, 3, 3, 1) with CUDA events."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as bwd, selective_scan_fwd as fwd,
        selective_scan_v1 as v1)
    from medical_image_classification_tpu_torch.scripts import (
        kernel_bench as kb)
    counters = _counters()
    per_stage = []

    def counted(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            before = _launches(counters)
            out = fn(*a, **k)
            torch.cuda.synchronize()
            per_stage.append({n: c - before[n]
                              for n, c in _launches(counters).items()})
            return out
        return run

    def want_two_level(rec, fwd_name, bwd_name, kernel):
        if rec["kernel"] != kernel:
            raise AssertionError(f"bench stage {rec['stage']} ran {rec}, "
                                 f"expected the {kernel} kernels")
        return {fwd_name: rec["fwd_calls"] + rec["fwd_bwd_calls"],
                bwd_name: rec["fwd_bwd_calls"]}

    runs = (
        ("default cap", ["--iters", "3"],
         lambda r: want_two_level(r, "selective_scan_fwd",
                                  "selective_scan_bwd", "v2")),
        ("t-cap 50", ["--iters", "3", "--t-cap", "50"],
         lambda r: want_two_level(r, "selective_scan_v1_fwd",
                                  "selective_scan_v1_bwd", "v1")),
        ("calibrate", ["--iters", str(CALIB_BENCH_ITERS), "--calibrate"],
         lambda r: {"scan_calib": r["calls"]}))
    saved = kb._bench_stage, kb.calib_kernel_bench
    kb._bench_stage, kb.calib_kernel_bench = (counted(f) for f in saved)
    result = {}
    try:
        for label, extra, expect in runs:
            per_stage.clear()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            records = kb.main(["--stage", "all"] + extra)
            seconds = time.perf_counter() - t0
            if len(records) != 4 or len(per_stage) != 4:
                raise AssertionError(f"bench {label}: {len(records)} "
                                     f"records, {len(per_stage)} stages")
            for rec, got in zip(records, per_stage):
                want = {k: 0 for k in counters}
                want.update(expect(rec))
                if got != want:
                    raise AssertionError(f"bench {label} stage "
                                         f"{rec['stage']}: launches {got}, "
                                         f"expected {want}")
            result[label] = dict(records=records, seconds=seconds,
                                 launches=_launches(counters))
    finally:
        kb._bench_stage, kb.calib_kernel_bench = saved

    # rows 1 and 3 (2 and 4) at one shape: the bench's stage 0, bf16
    u, delta, A, B, C, D, bias = kb.make_inputs(**kb.STAGES["0"],
                                                device="cuda")
    args = (u, delta, A, B, C, D, bias)
    T = 50
    gen = torch.Generator(device="cuda").manual_seed(13)
    dy = torch.randn(u.shape, device="cuda", generator=gen).to(u.dtype)
    _, xs1 = fwd._launch_cuda(*args, False, True, want_xsave=True)
    _, xs3 = v1._launch_fwd_cuda(*args, T, True)
    runs_k = {
        "row1": lambda: fwd._launch_cuda(*args, False, True,
                                         want_xsave=True),
        "row3": lambda: v1._launch_fwd_cuda(*args, T, True),
        "row2": lambda: bwd._launch_cuda(*args, xs1, dy, False, True),
        "row4": lambda: v1._launch_bwd_cuda(*args, xs3, dy, T)}
    times = {k: [] for k in runs_k}
    for a, b in (("row1", "row3"), ("row2", "row4")):
        for k in (a, b, b, a):
            times[k].append(_events_ms(runs_k[k], 10))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    st0 = kb.STAGES["0"]
    compare = dict(ms=ms, turns=times, shape=f"G{st0['G']} L{st0['L']} "
                   f"Dm{st0['Dm']} N{st0['N']} bf16",
                   bound_row1=_scan_bound(st0["L"], st0["Dm"], "bf16", False,
                                          st0["G"]),
                   bound_row3=_v1_bound(st0["L"], st0["Dm"], T, "bf16",
                                        False),
                   bound_row2=_scan_bound(st0["L"], st0["Dm"], "bf16", True,
                                          st0["G"]),
                   bound_row4=_v1_bound(st0["L"], st0["Dm"], T, "bf16", True))
    del xs1, xs3
    floor = {x["stage"]: (x["calib_ms"], y["fwd_ms"]) for x, y in zip(
        result["calibrate"]["records"], result["t-cap 50"]["records"])}
    lines = " | ".join(
        f"{label}: {r['seconds']:.1f} s, launches "
        + ", ".join(f"{k} {v}" for k, v in r["launches"].items() if v)
        + "; " + ", ".join(
            f"stage{x['stage']} " + (
                f"calib T{x['T']} {x['calib_ms']:.3f} ms" if "calib_ms" in x
                else f"{x['kernel']} T{x['T']} fwd {x['fwd_ms']:.3f} ms "
                f"fwd+bwd {x['fwd_bwd_ms']:.3f} ms") for x in r["records"])
        for label, r in result.items())
    print(f"phase 13 kernel bench via scripts/kernel_bench.py main() on "
          f"{card}: {lines} | calibrate (--iters {CALIB_BENCH_ITERS}) vs "
          f"--t-cap 50 fwd (--iters 3): " + ", ".join(
              f"stage{st} {c:.3f} vs {f:.3f} ms" for st, (c, f) in
              floor.items()) + " | launches per stage as "
          f"expected (each bench call: the forward once per fwd and fwd+bwd "
          f"call, the backward once per fwd+bwd call, the calibration once "
          f"per call, nothing else) | at {compare['shape']} with xsave: "
          f"row 1 (two-level, chunks of {fwd.CHUNK}) {ms['row1']:.4f} ms vs "
          f"row 3 "
          f"(one walk a state, T {T}) {ms['row3']:.4f} ms; row 2 "
          f"{ms['row2']:.4f} ms vs row 4 {ms['row4']:.4f} ms (turns 1, 3, "
          f"3, 1)", flush=True)
    return dict(runs=result, compare=compare, floor=floor)


# --- the CrossMamba family: the cross classifiers and the fusion U-Nets ---

def _fusion_model(name, dtype, scan_impl, state_dict=None, **kw):
    """Seeded fusion-registry ``name`` on the card, in eval mode; without
    ``state_dict`` its scan parameters (the blocks' and the CrossMamba
    fusions') are drawn away from init.  ``kw`` goes to
    create_fusion_model (``GATE_DEPTHS``)."""
    import torch
    from medical_image_classification_tpu_torch.models import (
        create_fusion_model)
    gen = torch.Generator().manual_seed(0)
    if name.startswith("cross"):
        kw = dict(kw, num_classes=CLASSES)
    model = create_fusion_model(name, dtype=dtype, scan_impl=scan_impl,
                                generator=gen, **kw)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        _perturb_scan_params(model, gen)
    return model.cuda().eval()


def _cross_pairs(batches, seed, batch=CROSS_BATCH):
    """Seeded host batches of the cross classifiers: image pairs in [0, 1]
    (float32 [B, SIZE, SIZE, 3], as the JAX package trains them) and
    labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        yield (rng.random((batch, SIZE, SIZE, 3), dtype=np.float32),
               rng.random((batch, SIZE, SIZE, 3), dtype=np.float32),
               rng.integers(0, CLASSES, batch))


def _on_card(*arrays):
    import torch
    return [torch.from_numpy(a).cuda() for a in arrays]


def _cross_loss(model, batch):
    """A cross classifier's train loss on ``batch`` (xa, xb, labels)."""
    from medical_image_classification_tpu_torch.train.train_step import (
        cross_entropy_loss)
    xa, xb, labels = batch
    return cross_entropy_loss(model(xa, xb), labels.long())


def _fusion_loss(model, batch):
    """A fusion U-Net's train loss on ``batch`` (xa, xb): the fusion step's,
    the fused image clamped to [0, 1]."""
    from medical_image_classification_tpu_torch.train.fusion_losses import (
        fusion_loss)
    xa, xb = batch
    return fusion_loss(xa, xb, model(xa, xb).clamp(0.0, 1.0))[0]


def _mean_out(model, batch):
    """The mean of a fusion U-Net's fused image: a smooth loss (no clamp)
    for the gradient gate."""
    return model(*batch).mean()


FUSION_GRAD_LOSSES = {"fusion loss": _fusion_loss, "mean(out)": _mean_out}


def _weighted_out(model, batch):
    """sum(out w) of a fusion U-Net's fused image, w a seeded N(0, 1) field
    drawn in fp32 (the same in every dtype)."""
    import torch
    out = model(*batch)
    gen = torch.Generator(device=out.device).manual_seed(11)
    return (out * torch.randn(out.shape, generator=gen, device=out.device)
            .to(out.dtype)).sum()


# FusionMamba's gradient gate: its fused image carries the 2 (x1 + x2)
# residual, so on pairs in [0, 1] the clamp at 1 cuts the fusion loss's
# gradient off most pixels; so the gate takes dark pairs (FM_DARK x the
# images), and sum(out w) beside the fusion loss (mean(out)'s gradient
# is smaller still).  Its abs floor is 0: every leaf whose error is not
# zero is checked.  With no BatchNorm no leaf's float64 gradient is ~0
# but those of stage 0's unread cross block (0 on every path), and every
# other leaf's fp32 gradient lies within 2.1e-4 of float64 on both paths
# (scripts/grad_conditioning.py on an H100), while no leaf's error reaches
# PARAM_GRAD_TOL's 2e-4 under the fusion loss.  The vfefm U-Nets keep
# 2e-4: their conv biases that feed a BatchNorm have float64 gradients of
# ~1e-17, so a floor under ~1e-6 holds fp32 noise there
FM_GRAD_LOSSES = {"fusion loss": _fusion_loss, "sum(out w)": _weighted_out}
FM_DARK = 0.25
FM_GRAD_FLOOR = 0.0


def _path_grads(name, sd, batch, losses, path, **kw):
    """{loss: (value, every parameter's gradient as float64)} of ``name``
    at the weights ``sd`` on ``batch`` in train mode (DropPath masks of
    seed 7, cuDNN's deterministic algorithms), by ``path``: "cuda" (the
    kernels, fp32), "torch" (their plain twins, fp32) or "float64" (the
    model, inputs and step in float64, every SSD through the plain
    einsums)."""
    import torch
    model = _fusion_model(name, None, "cuda" if path == "cuda" else "torch",
                          sd, **kw).train()
    if path == "float64":
        model = model.double()
        batch = [t.double() if t.is_floating_point() else t for t in batch]
    out = {}
    for what, loss_of in losses.items():
        model.zero_grad(set_to_none=True)
        model.seed_drop_path(7)
        with _cudnn_deterministic():
            loss = loss_of(model, batch)
            loss.backward()
        out[what] = float(loss.detach()), {
            n: _grad_of(name, n, p).detach().double().flatten()
            for n, p in model.named_parameters()}
    return out


def _grad_of(name, n, p):
    """The gradient of parameter ``n``: zeros for FusionMamba's FM_UNUSED,
    which no loss reaches; raises for any other parameter without one."""
    import torch
    if p.grad is not None:
        return p.grad
    if name == "fusionmamba" and n.startswith(FM_UNUSED):
        return torch.zeros_like(p)
    raise AssertionError(f"{name} {n}: the loss does not reach it")


def _two_input_gates(name, batch, losses, sd=None, exact_floor=None):
    """The gates of a two-input model against itself with every kernel
    swapped for its plain twin, the same weights (``sd``, or the seeded
    weights with the scan parameters off init) and inputs: the eval output
    (logits or the fused image) within LOGIT_TOL x max|out| in bf16 and
    fp32; in fp32 every parameter's gradient of each of ``losses`` (a dict
    of loss functions) on ``batch`` (train mode, the same DropPath masks,
    cuDNN's deterministic algorithms) leaf-wise within PARAM_GRAD_TOL.
    With ``exact_floor`` (the fusion U-Nets): both fp32 paths against the
    same step in float64, on every leaf whose error is over that abs
    floor the kernels within PARAM_GRAD_TOL plus COND_RATIO x the plain
    twins' own error (``_check_grad_tree_exact``), every model of the gates
    at ``GATE_DEPTHS``.  Returns the numbers and a line that states
    them."""
    import torch
    exact = exact_floor is not None
    kw = GATE_DEPTHS if exact else {}
    if sd is None:
        sd = _fusion_model(name, None, "torch", **kw).state_dict()
    errs, scale = {}, {}
    for dt_name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        outs = {}
        for impl in ("cuda", "torch"):
            with torch.inference_mode():
                outs[impl] = _fusion_model(name, dtype, impl, sd, **kw)(
                    *batch[:2]).float().cpu().numpy()
        errs[dt_name] = _check_logits(f"{name} {dt_name} output",
                                      outs["cuda"], outs["torch"],
                                      LOGIT_TOL[dt_name])
        scale[dt_name] = float(abs(outs["torch"]).max())
    paths = ("cuda", "torch") + (("float64",) if exact else ())
    res = {path: _path_grads(name, sd, batch, losses, path, **kw)
           for path in paths}
    text = (f"kernels vs plain twins, same weights: output max err bf16 "
            f"{errs['bf16']:.3e} ({errs['bf16'] / scale['bf16']:.2e} of "
            f"max|out|), fp32 {errs['fp32']:.3e} "
            f"({errs['fp32'] / scale['fp32']:.2e}) (tol {LOGIT_TOL} x "
            f"max|out|)")
    grads = {}
    for what in losses:
        loss = {path: res[path][what][0] for path in paths}
        g = {path: res[path][what][1] for path in paths}
        if exact:
            rel, cos, st = _check_grad_tree_exact(
                f"{name} fp32 param grad of the {what}", g["cuda"],
                g["torch"], g["float64"], *PARAM_GRAD_TOL[:2], exact_floor)
            vs_plain = _leaf_errs("kernels vs plain twins", g["cuda"],
                                  g["torch"], exact_floor)
            st["kernels_vs_plain_over_tol"] = sum(
                1 for r, c in vs_plain.values()
                if r > PARAM_GRAD_TOL[0] or c < PARAM_GRAD_TOL[1])
            text += (
                f"; {what}: float64 {loss['float64']:.6f}, fp32 kernels "
                f"{loss['cuda']:.6f}, plain {loss['torch']:.6f}; leaves "
                f"beyond {PARAM_GRAD_TOL[:2]} of the float64 gradient (of "
                f"{len(g['torch'])}): kernels "
                f"{st['kernels']['leaves_over_tol']} (worst rel-norm "
                f"{st['kernels']['worst_rel']:.2e} cos "
                f"{st['kernels']['worst_cos']:.6f}), plain twins "
                f"{st['plain']['leaves_over_tol']} (worst "
                f"{st['plain']['worst_rel']:.2e} cos "
                f"{st['plain']['worst_cos']:.6f}); leaves whose error is over "
                f"the abs floor {exact_floor}, checked: kernels "
                f"{st['kernels']['leaves_over_floor']}, plain twins "
                f"{st['plain']['leaves_over_floor']}; median leaf rel-norm "
                f"kernels {st['kernels']['median_rel']:.2e}, plain "
                f"{st['plain']['median_rel']:.2e}; kernels vs plain twins "
                f"{st['kernels_vs_plain_over_tol']}; every leaf of the "
                f"kernels within {PARAM_GRAD_TOL[0]} + {COND_RATIO} x the "
                f"plain twins' own error")
        else:
            rel, cos = _check_grad_tree(
                f"{name} fp32 param grad of the {what}", g["cuda"],
                g["torch"], *PARAM_GRAD_TOL)
            st = {}
            text += (f"; {what}: fp32 {loss['cuda']:.6f} vs "
                     f"{loss['torch']:.6f}, worst leaf rel-norm {rel:.2e} "
                     f"cos {cos:.6f} over {len(g['torch'])} leaves (tol "
                     f"{PARAM_GRAD_TOL})")
        grads[what] = dict(loss=loss, fp32_worst_rel=rel, fp32_worst_cos=cos,
                           leaves=len(g["torch"]), **st)
    return dict(out_err=errs, grads=grads), text


def _want(calls, steps, backward):
    """Every kernel's expected launches: ``calls`` forward launches (and as
    many backward ones with ``backward``) ``steps`` times."""
    want = {k: 0 for k in _counters()}
    for f, n in calls.items():
        want[f] = n * steps
        if backward:
            want[f[:-len("fwd")] + "bwd"] = n * steps
    return want


def _per_step(calls):
    """The kernels a train step of the path ``calls`` launches, and how
    often."""
    return {k: v for k, v in _want(calls, 1, True).items() if v}


def _zero(counters):
    import torch
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0


def _check_launches(what, counters, want):
    got = _launches(counters)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    return ", ".join(f"{k} {v}" for k, v in want.items() if v)


def _moved(model, before, unused=()):
    """The parameters of ``model`` still equal to ``before``, but for those
    whose names start with one of ``unused`` (which no loss reaches);
    raises if any."""
    import torch
    still = sorted(n for n, p in model.named_parameters()
                   if not n.startswith(tuple(unused))
                   and torch.equal(p.detach().cpu(), before[n].cpu()))
    if still:
        raise AssertionError(f"{len(still)} parameters did not move: "
                             f"{still[:5]}")
    return len(before)


def _step_profile(fn, split, top=0):
    """Device ms of one call of ``fn`` (torch.profiler), by ``split``
    share and the rest; with ``top``, also the ``top`` kernels of the rest
    by device ms, as a third item."""
    rows = [r for r in _profile(fn) if r["cpu_us"] == 0.0]
    hit = lambda r, pats: any(p in r["name"] for p in pats)
    times = {k: sum(r["device_us"] for r in rows if hit(r, pats)) / 1e3
             for k, pats in split.items()}
    total = sum(r["device_us"] for r in rows) / 1e3
    times["rest"] = total - sum(times.values())
    if not top:
        return total, times
    rest = [r for r in rows if not any(hit(r, p) for p in split.values())]
    return total, times, [(r["name"][:70], r["count"], r["device_us"] / 1e3)
                          for r in rest[:top]]


def _resident_ms(fn):
    """Host-clock ms of one call of ``fn`` on data already on the card,
    over STEPS calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def _ms_text(total, times):
    return f"{total:.2f} ms device time in kernels (" + ", ".join(
        f"{k} {v:.2f} ms" for k, v in times.items()) + ")"


def phase_cross_full(card, name, num):
    """A cross classifier at full width (224x224, batch CROSS_BATCH, bf16):
    STEPS eval batches through the two-input eval step, then one warm-up
    and STEPS Adam steps (1e-4) through the two-input train step, each on
    host batches copied to the card; the launches exactly the path's
    (counters at 0 just before each run), every parameter moved, the
    gates of ``_two_input_gates`` on the trained weights; pairs/s, the
    resident wall ms and the device ms of a forward and of a step."""
    import math

    import torch
    from medical_image_classification_tpu_torch.train.eval_step import (
        make_cross_eval_step)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState, make_cross_train_step)
    calls = CROSS_PATHS[name]
    counters = _counters()
    model = _fusion_model(name, torch.bfloat16, "auto")
    eval_step = make_cross_eval_step(model)
    for xa, xb, y in _cross_pairs(1, 1):                # warm-up
        eval_step(*_on_card(xa, xb, y))
    _zero(counters)
    t0 = time.perf_counter()
    logits = []
    for xa, xb, y in _cross_pairs(STEPS, 0):
        logits.append(eval_step(*_on_card(xa, xb, y))[1])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_calls = _check_launches(f"{name} {STEPS} eval batches", counters,
                                 _want(calls, STEPS, False))
    logits = torch.cat(logits)
    if logits.shape != (CROSS_BATCH * STEPS, CLASSES) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)}")
    xa, xb, y = _on_card(*next(_cross_pairs(1, 5)))
    eval_ms = _resident_ms(lambda: eval_step(xa, xb, y))
    eval_dev = _step_profile(lambda: eval_step(xa, xb, y), CROSS_SPLIT)

    opt = make_optimizer("adam", model.named_parameters())
    step = make_cross_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)), state=TrainState())
    model.seed_drop_path(1)
    for xa, xb, y in _cross_pairs(1, 1):                # warm-up
        step(*_on_card(xa, xb, y))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _zero(counters)
    t0 = time.perf_counter()
    losses = [step(*_on_card(xa, xb, y))["loss"]
              for xa, xb, y in _cross_pairs(STEPS, 2)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_calls = _check_launches(f"{name} {STEPS} train steps", counters,
                                  _want(calls, STEPS, True))
    loss = float(torch.stack(losses).mean())
    if not math.isfinite(loss):
        raise AssertionError(f"{name}: train loss {loss}")
    n_params = _moved(model, before)
    xa, xb, y = _on_card(*next(_cross_pairs(1, 6)))
    train_ms = _resident_ms(lambda: step(xa, xb, y))
    train_dev = _step_profile(lambda: step(xa, xb, y), CROSS_SPLIT)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, opt, step, eval_step
    gates, gates_text = _two_input_gates(
        name, _on_card(*next(_cross_pairs(1, 3, GRAD_BATCH))),
        {"cross-entropy": _cross_loss}, sd)
    n_img = CROSS_BATCH * STEPS
    print(f"phase {num} {name} {SIZE}x{SIZE} b{CROSS_BATCH} bf16, two-input "
          f"steps on host pairs: eval {STEPS} batches, kernel launches "
          f"{eval_calls}; training {STEPS} Adam steps after 1 warm-up, "
          f"launches {train_calls} (forward + backward), the other kernels "
          f"none, loss {loss:.4f}, all {n_params} parameters moved | eval "
          f"{n_img / eval_s:.2f} pairs/s, train {n_img / train_s:.2f} "
          f"pairs/s (host data and copies included) on {card} | resident "
          f"wall: forward {eval_ms:.2f} ms, step {train_ms:.2f} ms | one "
          f"forward: {_ms_text(*eval_dev)} | one step: "
          f"{_ms_text(*train_dev)} | {gates_text} (batch {GRAD_BATCH}, "
          f"the trained weights)", flush=True)
    return dict(eval_pairs_s=n_img / eval_s, train_pairs_s=n_img / train_s,
                loss=loss, launches_per_step=_per_step(calls),
                resident_forward_ms=eval_ms, resident_step_ms=train_ms,
                device_forward_ms=eval_dev[0], forward_ms=eval_dev[1],
                device_step_ms=train_dev[0], step_ms=train_dev[1],
                gates=gates)


def phase_cross_step(card, name, num):
    """A cross classifier at full width: one eval forward and one Adam step
    through the two-input steps (bf16, batch CROSS_BATCH), launches exactly
    the path's, a finite loss, every parameter moved; the gates of
    ``_two_input_gates`` on the seeded weights."""
    import math

    import torch
    from medical_image_classification_tpu_torch.train.eval_step import (
        make_cross_eval_step)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState, make_cross_train_step)
    calls = CROSS_PATHS[name]
    counters = _counters()
    model = _fusion_model(name, torch.bfloat16, "auto")
    batch = _on_card(*next(_cross_pairs(1, 0)))
    _zero(counters)
    t0 = time.perf_counter()
    _, logits = make_cross_eval_step(model)(*batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_calls = _check_launches(f"{name} one forward", counters,
                                 _want(calls, 1, False))
    opt = make_optimizer("adam", model.named_parameters())
    step = make_cross_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)), state=TrainState())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.seed_drop_path(1)
    _zero(counters)
    t0 = time.perf_counter()
    loss = float(step(*batch)["loss"])
    step_s = time.perf_counter() - t0
    step_calls = _check_launches(f"{name} one train step", counters,
                                 _want(calls, 1, True))
    if not math.isfinite(loss) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: loss {loss}, logits not finite")
    n_params = _moved(model, before)
    del model, opt, step
    gates, gates_text = _two_input_gates(
        name, _on_card(*next(_cross_pairs(1, 3, GRAD_BATCH))),
        {"cross-entropy": _cross_loss})
    print(f"phase {num} {name} {SIZE}x{SIZE} b{CROSS_BATCH} bf16: one "
          f"forward (launches {eval_calls}) and one Adam step (launches "
          f"{step_calls}, forward + backward) through the two-input steps, "
          f"the other kernels none; logits {tuple(logits.shape)} finite, "
          f"loss {loss:.4f}, all {n_params} parameters moved | first-call "
          f"wall time on {card}: eval {eval_s:.3f} s, step {step_s:.3f} s | "
          f"{gates_text} (batch {GRAD_BATCH}, seeded weights)", flush=True)
    return dict(loss=loss, launches_per_step=_per_step(calls),
                eval_s=eval_s, step_s=step_s, gates=gates)


def _write_pairs(root, n, seed):
    """``n`` CT/MRI pairs of seeded PNGs, FUSION_SIZE a side: a smooth
    field (a CT-like disc, an MRI-like ring) plus noise."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:FUSION_SIZE, :FUSION_SIZE] / FUSION_SIZE - 0.5
    r = np.sqrt(xx ** 2 + yy ** 2)
    for d, base in (("CT", 200.0 * (r < 0.35)),
                    ("MRI", 180.0 * np.exp(-((r - 0.3) / 0.08) ** 2))):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            img = base + 40.0 * rng.random((FUSION_SIZE, FUSION_SIZE))
            cv2.imwrite(os.path.join(root, d, f"{i}.png"),
                        np.clip(img, 0, 255).astype(np.uint8))


def _fusion_batch(batch, seed, channels=3):
    """A seeded pair batch on the card as the fusion trainer feeds it:
    float32 [B, FUSION_SIZE, FUSION_SIZE, channels] in [0, 1] (a grayscale
    image repeated over the channels)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (batch, FUSION_SIZE, FUSION_SIZE, 1)
    return _on_card(*(np.repeat(rng.random(shape, dtype=np.float32),
                                channels, -1) for _ in range(2)))


def _fusion_cli_train(root, save, argv, counters, calls, steps, unused=()):
    """cli/fusion_train.py's main() on ``root`` (counters at 0 just before
    it, read just after): launches exactly ``calls`` per step, forward
    and backward, over ``steps`` steps; finite losses; every parameter
    (but the ``unused`` ones, see ``_moved``) moved from the CLI's own
    seeded init.  Returns (the model, the last epoch's result, the
    launches' text)."""
    import math

    import torch
    from medical_image_classification_tpu_torch.cli import fusion_train
    args = fusion_train.parse_args(
        ["--data-path", root, "--save-path", save, "--log-every", "0",
         "--image-size", str(FUSION_SIZE), "--batch-size",
         str(FUSION_BATCH)] + argv)
    init = {n: p.detach().clone() for n, p in fusion_train.build_model(
        args, torch.Generator().manual_seed(args.seed)).named_parameters()}
    _zero(counters)
    model, epochs = fusion_train.main(args)
    text = _check_launches(f"fusion_train {' '.join(argv)}", counters,
                           _want(calls, steps, True))
    losses = [v for e in epochs for v in e["loss"]]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fusion_train {argv}: losses {losses}")
    _moved(model, init, unused)
    return model, epochs[-1], text


def phase_vfefm(card, num):
    """vfefm_2b2 at full width through its CLIs on a generated folder of
    FUSION_PAIRS CT/MRI PNG pairs (256x256, batch 2): cli/fusion_train.py
    for FUSION_EPOCHS epochs in fp32 (the CLI's default) and with --dtype
    bf16, then cli/fusion_test.py on the folder with the fp32 run's
    weights, one PNG a pair; each run's launches exactly the path's (the
    counters at 0 just before each main() and read just after), finite
    losses, every parameter moved; pairs/s of the last epoch (host data
    included) and of the test loop; the resident wall ms and device ms of
    a step in each dtype and of a forward; the gates of
    ``_two_input_gates`` on the seeded weights (batch 2)."""
    import shutil

    import cv2
    import torch
    from medical_image_classification_tpu_torch.cli import fusion_test
    from medical_image_classification_tpu_torch.train.eval_step import (
        make_fusion_eval_step)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        make_fusion_train_step)
    name, calls = "vfefm_2b2", CROSS_PATHS["vfefm_2b2"]
    counters = _counters()
    root = os.path.join(FUSION_DIR, "ctmri")
    shutil.rmtree(FUSION_DIR, ignore_errors=True)
    _write_pairs(root, FUSION_PAIRS, 0)
    steps = FUSION_EPOCHS * FUSION_PAIRS // FUSION_BATCH
    runs = {}
    for dt_name in ("fp32", "bf16"):
        save = os.path.join(FUSION_DIR, f"{dt_name}.pt")
        model, last, text = _fusion_cli_train(
            root, save, ["--epochs", str(FUSION_EPOCHS), "--dtype", dt_name],
            counters, calls, steps)
        # a step and a forward on a batch already on the card
        opt = make_optimizer("adam", model.named_parameters())
        step = make_fusion_train_step(model, opt, make_lr_scheduler(
            opt, make_schedule("constant", 2e-4)))
        batch = _fusion_batch(FUSION_BATCH, 4)
        runs[dt_name] = dict(
            launches=text, loss=last["loss"][-1], pairs_s=last["pairs_s"],
            resident_step_ms=_resident_ms(lambda: step(*batch)),
            step=_step_profile(lambda: step(*batch), FUSION_SPLIT))
        if dt_name == "fp32":
            infer = make_fusion_eval_step(model)
            runs["eval"] = dict(
                resident_forward_ms=_resident_ms(lambda: infer(*batch)),
                forward=_step_profile(lambda: infer(*batch), FUSION_SPLIT))
        del model, opt, step
    out_dir = os.path.join(FUSION_DIR, "fused")
    args = fusion_test.parse_args(["--data-path", root, "--weights",
                                   os.path.join(FUSION_DIR, "fp32.pt"),
                                   "--out-dir", out_dir, "--image-size",
                                   str(FUSION_SIZE)])
    _zero(counters)
    done = fusion_test.main(args)
    test_calls = _check_launches("fusion_test", counters,
                                 _want(calls, FUSION_PAIRS, False))
    shapes = {cv2.imread(p, cv2.IMREAD_UNCHANGED).shape
              for p in done["paths"]}
    if len(os.listdir(out_dir)) != FUSION_PAIRS or \
            shapes != {(FUSION_SIZE, FUSION_SIZE)}:
        raise AssertionError(f"fusion_test wrote {os.listdir(out_dir)}, "
                             f"shapes {shapes}")
    gates, gates_text = _two_input_gates(
        name, _fusion_batch(FUSION_BATCH, 3), FUSION_GRAD_LOSSES,
        exact_floor=PARAM_GRAD_TOL[2])
    fwd = runs["eval"]
    print(f"phase {num} {name} {FUSION_SIZE}x{FUSION_SIZE} b{FUSION_BATCH} "
          f"through cli/fusion_train.py ({FUSION_PAIRS} generated pairs, "
          f"{FUSION_EPOCHS} epochs, {steps} steps) and cli/fusion_test.py: "
          + " | ".join(
              f"{d}: launches {r['launches']} (forward + backward), the "
              f"other kernels none, last loss {r['loss']:.4f}, every "
              f"parameter moved, last epoch {r['pairs_s']:.2f} pairs/s "
              f"(host data included), resident step "
              f"{r['resident_step_ms']:.2f} ms, one step: "
              f"{_ms_text(*r['step'])}"
              for d, r in runs.items() if d != "eval")
          + f" | fusion_test: {FUSION_PAIRS} PNGs of {FUSION_SIZE}x"
          f"{FUSION_SIZE}, launches {test_calls}, "
          f"{FUSION_PAIRS / done['seconds']:.2f} pairs/s (one pair a "
          f"forward, reads and writes included); fp32 forward at b"
          f"{FUSION_BATCH} resident {fwd['resident_forward_ms']:.2f} ms, "
          f"{_ms_text(*fwd['forward'])} | {gates_text} (batch "
          f"{FUSION_BATCH}, seeded weights) | on {card}", flush=True)
    return dict(runs=runs, test_pairs_s=FUSION_PAIRS / done["seconds"],
                launches_per_step=_per_step(calls), gates=gates)


def phase_vfefm_2c1(card, num):
    """vfefm_2c1 at full width: one fp32 step through cli/fusion_train.py
    --single-decoder (one batch of the generated pairs), launches exactly
    the path's, a finite loss, every parameter moved; the gates of
    ``_two_input_gates`` on the seeded weights."""
    name, calls = "vfefm_2c1", CROSS_PATHS["vfefm_2c1"]
    counters = _counters()
    root = os.path.join(FUSION_DIR, "ctmri")
    t0 = time.perf_counter()
    model, last, text = _fusion_cli_train(
        root, os.path.join(FUSION_DIR, "2c1.pt"),
        ["--single-decoder", "--epochs", "1", "--max-pairs",
         str(FUSION_BATCH)], counters, calls, 1)
    seconds = time.perf_counter() - t0
    del model
    gates, gates_text = _two_input_gates(
        name, _fusion_batch(FUSION_BATCH, 3), FUSION_GRAD_LOSSES,
        exact_floor=PARAM_GRAD_TOL[2])
    print(f"phase {num} {name} {FUSION_SIZE}x{FUSION_SIZE} b{FUSION_BATCH} "
          f"fp32: one step through cli/fusion_train.py --single-decoder, "
          f"launches {text} (forward + backward), the other kernels none, "
          f"loss {last['loss'][0]:.4f}, every parameter moved, "
          f"{seconds:.2f} s wall on {card} (build included) | {gates_text} "
          f"(batch {FUSION_BATCH}, seeded weights)", flush=True)
    return dict(loss=last["loss"][0], launches_per_step=_per_step(calls),
                gates=gates)


def phase_fusionmamba(card, num):
    """FusionMamba at full width through cli/fusion_train.py --model
    fusionmamba on the generated pairs (one channel, 256x256, batch 2) for
    FUSION_EPOCHS epochs in fp32 (the CLI's default) and with --dtype bf16:
    each run's launches exactly the path's (the scan pair only, K 4; the
    counters at 0 just before each main() and read just after), finite
    losses, every parameter moved but FM_UNUSED; pairs/s of the last epoch
    (host data included); the resident wall ms and the device ms of a step
    in each dtype (the scan forward, the scan backward, the rest) and of an
    fp32 forward; the gates of ``_two_input_gates`` on the seeded weights
    with the scan parameters off init (batch 2, the fp32 gradients against
    the float64 step, on FM_GRAD_LOSSES, at the abs floor FM_GRAD_FLOOR)."""
    import torch
    from medical_image_classification_tpu_torch.train.eval_step import (
        make_fusion_eval_step)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        make_fusion_train_step)
    name, calls = "fusionmamba", CROSS_PATHS["fusionmamba"]
    counters = _counters()
    root = os.path.join(FUSION_DIR, "ctmri")
    if not os.path.isdir(root):
        _write_pairs(root, FUSION_PAIRS, 0)
    steps = FUSION_EPOCHS * FUSION_PAIRS // FUSION_BATCH
    runs = {}
    for dt_name in ("fp32", "bf16"):
        model, last, text = _fusion_cli_train(
            root, os.path.join(FUSION_DIR, f"fusionmamba_{dt_name}.pt"),
            ["--model", "fusionmamba", "--epochs", str(FUSION_EPOCHS),
             "--dtype", dt_name], counters, calls, steps, FM_UNUSED)
        opt = make_optimizer("adam", model.named_parameters())
        step = make_fusion_train_step(model, opt, make_lr_scheduler(
            opt, make_schedule("constant", 2e-4)))
        batch = _fusion_batch(FUSION_BATCH, 4, channels=1)
        total, times, top = _step_profile(lambda: step(*batch),
                                          SCAN_SPLIT, 6)
        runs[dt_name] = dict(
            launches=text, loss=last["loss"][-1], pairs_s=last["pairs_s"],
            resident_step_ms=_resident_ms(lambda: step(*batch)),
            step=(total, times), rest_top=top)
        if dt_name == "fp32":
            infer = make_fusion_eval_step(model)
            runs["eval"] = dict(
                resident_forward_ms=_resident_ms(lambda: infer(*batch)),
                forward=_step_profile(lambda: infer(*batch), SCAN_SPLIT))
        del model, opt, step
    t0 = time.perf_counter()
    gates, gates_text = _two_input_gates(
        name, [FM_DARK * t for t in _fusion_batch(FUSION_BATCH, 3, 1)],
        FM_GRAD_LOSSES, exact_floor=FM_GRAD_FLOOR)
    gates_s = time.perf_counter() - t0
    fwd = runs["eval"]
    print(f"phase {num} {name} {FUSION_SIZE}x{FUSION_SIZE} b{FUSION_BATCH} "
          f"(one channel) through cli/fusion_train.py --model fusionmamba "
          f"({FUSION_PAIRS} generated pairs, {FUSION_EPOCHS} epochs, {steps} "
          f"steps): " + " | ".join(
              f"{d}: launches {r['launches']} (forward + backward, K 4), the "
              f"other kernels none, last loss {r['loss']:.4f}, every "
              f"parameter moved but {FM_UNUSED[0]}* (nothing reads it), "
              f"last epoch {r['pairs_s']:.2f} pairs/s (host data included), "
              f"resident step {r['resident_step_ms']:.2f} ms, one step: "
              f"{_ms_text(*r['step'])}, the rest's largest: " + ", ".join(
                  f"{n} x{c} {ms:.2f} ms" for n, c, ms in r["rest_top"])
              for d, r in runs.items() if d != "eval")
          + f" | fp32 forward at b{FUSION_BATCH} resident "
          f"{fwd['resident_forward_ms']:.2f} ms, {_ms_text(*fwd['forward'])}"
          f" | {gates_text} (batch {FUSION_BATCH}, pairs x {FM_DARK}, "
          f"seeded weights, scan parameters off init; {gates_s:.1f} s) | on "
          f"{card}", flush=True)
    return dict(runs=runs, launches_per_step=_per_step(calls), gates=gates,
                gates_s=gates_s)


def _eval_folder(root, per_class, seed):
    """CLASSES class folders of ``per_class`` seeded RGB PNGs, SIZE a side."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    for c in range(CLASSES):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            cv2.imwrite(os.path.join(d, f"{i}.png"), rng.integers(
                0, 256, (SIZE, SIZE, 3), dtype=np.uint8))


def _cam_want(name):
    """Every kernel's expected launches in one grad_cam call of ``name``."""
    want = {k: 0 for k in _counters()}
    for calls in CAM_PATHS[name]:
        want.update(calls)
    return want


def phase_all_index(card, num):
    """cli/test.py's main() with --all-index --csv-out: full-width medmamba
    (fp32, the CLI's dtype; seeded weights, scan parameters off init, a
    torch.save'd state_dict) on a generated 8-class ImageFolder of
    ALL_INDEX_PER_CLASS seeded PNGs a class (224x224, batch 32: a full batch
    and a padded one): the scan's launches exactly the path's for two
    batches, the CSV's columns JAX's (ALL_INDEX_COLUMNS), param_count
    count_parameters of the model, and the metrics against
    classification_metrics of the same images through the plain twins:
    the accuracy equal, the AUC within ALL_INDEX_AUC_TOL."""
    import csv
    import shutil

    import torch
    from medical_image_classification_tpu_torch.cli import test as test_cli
    from medical_image_classification_tpu_torch.data.image_folder import (
        scan_image_folder)
    from medical_image_classification_tpu_torch.data.loader import (
        BatchLoader)
    from medical_image_classification_tpu_torch.evaluate.metrics import (
        classification_metrics, count_parameters)
    name, calls = "medmamba", _path("medmamba")[0]
    counters = _counters()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    root = os.path.join(EVAL_DIR, "oct")
    _eval_folder(root, ALL_INDEX_PER_CLASS, 0)
    n_img = CLASSES * ALL_INDEX_PER_CLASS
    batches = -(-n_img // BATCH)
    model = _model(name, None, "auto")
    weights = os.path.join(EVAL_DIR, f"{name}_fp32.pt")
    torch.save(model.state_dict(), weights)
    csv_out = os.path.join(EVAL_DIR, "metrics.csv")
    _zero(counters)
    t0 = time.perf_counter()
    m = test_cli.main(test_cli.parse_args(
        ["--data-path", root, "--model", name, "--num-classes",
         str(CLASSES), "--weights", weights, "--batch-size", str(BATCH),
         "--image-size", str(SIZE), "--all-index", "--csv-out", csv_out]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = _want(calls, batches, False)
    launched = _check_launches("--all-index", counters, want)
    with open(csv_out, newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) != 2 or tuple(rows[0]) != ALL_INDEX_COLUMNS:
        raise AssertionError(f"--csv-out wrote {rows[:1]}, expected one row "
                             f"under {ALL_INDEX_COLUMNS}")
    row = dict(zip(rows[0], rows[1]))
    params = count_parameters(model)
    if (row["model"], int(row["param_count"]), m["param_count"]) != (
            name, params, params):
        raise AssertionError(f"CSV model / param_count {row['model']} / "
                             f"{row['param_count']}, expected {name} / "
                             f"{params}")
    loader = BatchLoader(scan_image_folder(root), BATCH, SIZE, train=False)
    _, y, logits = test_cli.run_eval(_model(name, None, "torch",
                                            model.state_dict()),
                                     loader, torch.device("cuda"))
    _check_launches("the plain twins", counters, want)
    scores = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    ref = classification_metrics(y, logits.argmax(-1), scores,
                                 num_classes=CLASSES)
    auc_err = abs(float(row["auc_ovr_macro"]) - ref["auc_ovr_macro"])
    if float(row["accuracy"]) != ref["accuracy"] or \
            auc_err > ALL_INDEX_AUC_TOL:
        raise AssertionError(f"--all-index {row} against the plain twins' "
                             f"{ref} (AUC tol {ALL_INDEX_AUC_TOL})")
    print(f"phase {num} {name} {SIZE}x{SIZE} fp32 through cli/test.py "
          f"--all-index --csv-out on {n_img} generated images "
          f"({CLASSES} classes, batch {BATCH}, {batches} batches): launches "
          f"{launched}, the other kernels none; CSV columns JAX's, "
          f"param_count {params}; accuracy {float(row['accuracy']):.4f} "
          f"equal to the plain twins', AUC {float(row['auc_ovr_macro']):.6f}"
          f" (plain {ref['auc_ovr_macro']:.6f}, diff {auc_err:.2e}); "
          f"{seconds:.2f} s with the PNG reads, on {card}", flush=True)
    return dict(launches=_launches(counters), seconds=seconds, metrics=m,
                plain=ref, auc_err=auc_err)


def phase_grad_cam(card, num):
    """Grad-CAM on the card, fp32 (the JAX CLI's dtype).  cli/cam.py's
    main() on one generated PNG (224x224) with phase 33's medmamba weights,
    all four stages: launches exactly CAM_PATHS' (the forward kernels of
    every stage, the backward kernels of stages 1-3), a PNG of the image's
    size.  Then grad_cam at CAM_BATCH (the target each image's argmax, the
    JAX default) for medmamba, medssd and st_ssd (seeded weights, scan
    parameters off init, the head's weight x CAM_HEAD_SCALE):
    launches exactly CAM_PATHS', each stage's map spanning more than
    CAM_MIN_SPAN, the heatmaps against the same call on the plain twins
    within CAM_TOL (both under cuDNN's deterministic algorithms), ms of one
    call on the kernels (cuDNN's defaults, as the CLI) and on the twins."""
    import cv2
    import numpy as np
    import torch
    from medical_image_classification_tpu_torch.cli import cam as cam_cli
    from medical_image_classification_tpu_torch.evaluate.gradcam import (
        grad_cam, resize_bilinear, stage_cam, stage_grads)
    counters = _counters()
    src = os.path.join(EVAL_DIR, "cam_in.png")
    out = os.path.join(EVAL_DIR, "cam_out.png")
    cv2.imwrite(src, np.random.default_rng(4).integers(
        0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
    _zero(counters)
    t0 = time.perf_counter()
    heat = cam_cli.main(cam_cli.parse_args(
        ["--image", src, "--model", "medmamba", "--num-classes",
         str(CLASSES), "--weights", os.path.join(EVAL_DIR,
                                                 "medmamba_fp32.pt"),
         "--image-size", str(SIZE), "--out", out]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launched = _check_launches("cli/cam.py", counters,
                                   _cam_want("medmamba"))
    written = cv2.imread(out)
    if written is None or written.shape != (SIZE, SIZE, 3) or not (
            np.isfinite(heat).all() and 0 <= heat.min() <= heat.max() <= 1):
        raise AssertionError(f"cli/cam.py wrote {getattr(written, 'shape', None)}"
                             f", heatmap [{heat.min()}, {heat.max()}]")
    imgs = np.random.default_rng(5).integers(
        0, 256, (CAM_BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    runs, texts = {}, []
    for name in CAM_PATHS:
        model = _model(name, None, "auto")
        with torch.no_grad():
            model.head.weight.mul_(CAM_HEAD_SCALE)
        twin = _model(name, None, "torch", model.state_dict())
        _zero(counters)
        with _cudnn_deterministic():
            cams = grad_cam(model, imgs)
        torch.cuda.synchronize()
        launched = _check_launches(f"grad_cam {name}", counters,
                                   _cam_want(name))
        per_call = _launches(counters)
        t0 = time.perf_counter()
        grad_cam(model, imgs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # the twins take the kernels' argmax: a near tie cannot swap a class
        acts, grads, targets = stage_grads(model, imgs)
        targets = targets.tolist()
        spans = {n: float((m.amax((1, 2)) - m.amin((1, 2))).min())
                 for n, m in ((n, resize_bilinear(stage_cam(acts[n], grads[n]),
                                                   (SIZE, SIZE)))
                              for n in acts)}
        if min(spans.values()) <= CAM_MIN_SPAN:
            raise AssertionError(f"grad_cam {name}: a stage map spans "
                                 f"{spans}, not over {CAM_MIN_SPAN}")
        del acts, grads
        before = _launches(counters)
        t0 = time.perf_counter()
        with _cudnn_deterministic():
            ref = grad_cam(twin, imgs, targets)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if _launches(counters) != before:
            raise AssertionError(f"grad_cam {name} on the plain twins "
                                 "launched a kernel")
        err = float(np.abs(cams - ref).max())
        if not np.isfinite(cams).all() or err > CAM_TOL:
            raise AssertionError(f"grad_cam {name}: kernels vs plain twins "
                                 f"max err {err:.3e} > {CAM_TOL}")
        runs[name] = dict(launches={k: v for k, v in per_call.items() if v},
                          ms=ms, plain_ms=plain_ms, max_abs_err=err,
                          min_span=spans)
        texts.append(f"{name}: launches {launched}, heatmap max err "
                     f"{err:.2e} (tol {CAM_TOL}), smallest stage span "
                     f"{min(spans.values()):.3e}, {ms:.2f} ms a call "
                     f"(plain twins {plain_ms:.2f})")
        del model, twin
    print(f"phase {num} Grad-CAM fp32 {SIZE}x{SIZE}: cli/cam.py medmamba on "
          f"one PNG, all four stages: launches {cli_launched}, a {SIZE}x"
          f"{SIZE} PNG, {cli_s:.2f} s | grad_cam b{CAM_BATCH} all stages, "
          + " | ".join(texts) + f" | on {card}", flush=True)
    return dict(cli_launches=cli_launched, cli_s=cli_s, runs=runs)


# what a fresh interpreter runs on an exported program: cli/export.py's
# load_and_check (which imports kernels/ops.py and nothing of the models),
# the logits saved, the kernels' launches in that one forward and the
# port's modules it imported printed as JSON
_LOAD_CODE = (
    "import json, sys\n"
    "import numpy as np\n"
    "from medical_image_classification_tpu_torch.cli.export import "
    "load_and_check\n"
    "out = load_and_check(sys.argv[1])\n"
    "np.save(sys.argv[2], out.float().cpu().numpy())\n"
    "import chip_smoke\n"
    "pkg = 'medical_image_classification_tpu_torch.'\n"
    "print(json.dumps(dict(launches={k: c.launches for k, c in\n"
    "    chip_smoke._counters().items() if c.launches},\n"
    "    modules=sorted(m[len(pkg):] for m in sys.modules\n"
    "                   if m.startswith(pkg)))))\n")


def phase_export(card, num):
    """cli/export.py's main() on each of EXPORT_CASES at EXPORT_BATCH, bf16
    (seeded weights, scan parameters off init): the program's mic_torch
    calls exactly the path's forward launches; then ``--load``'s
    load_and_check in a fresh python3 that imports kernels/ops.py and
    nothing of the models (a module outside cli.export and kernels fails):
    its one forward launches what the eager forward launches, and its
    logits lie within EXPORT_TOL x max|logit| of the eager module's on the
    same seeded batch (whether the bits are identical is printed); each
    load runs while the next program is exported.  The three programs hold
    all six forward ops; trace and save seconds and the .pt2 sizes."""
    from medical_image_classification_tpu_torch.kernels import ops
    counters = _counters()
    runs, texts, seen, pending = {}, [], set(), []
    try:
        _export_cases(counters, runs, texts, seen, pending)
    finally:
        for *_, proc in pending:       # a failed phase stops its loaders
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    every = {f"{ops.NAMESPACE}::{op._name}" for op in ops.OPS}
    if seen != every:
        raise AssertionError(f"the programs hold {sorted(seen)}, not every "
                             f"op of {sorted(every)}")
    print(f"phase {num} cli/export.py b{EXPORT_BATCH} bf16, all six ops in "
          "the programs: " + " | ".join(texts) + f" | on {card}",
          flush=True)
    return runs


def _export_cases(counters, runs, texts, seen, pending):
    """phase_export's cases: export, check and load each program, filling
    ``runs``, ``texts``, ``seen`` and ``pending`` (the loaders started)."""
    import numpy as np
    import torch
    from medical_image_classification_tpu_torch.cli import export
    from medical_image_classification_tpu_torch.kernels import ops
    for name, size in EXPORT_CASES:
        calls = _path(name, size)[0]
        weights = os.path.join(EVAL_DIR, f"{name}_{size}_bf16.pt")
        torch.save(_model(name, torch.bfloat16, "auto").state_dict(),
                   weights)
        pt2 = os.path.join(EVAL_DIR, f"{name}_{size}.pt2")
        program, stats = export.main(export.parse_args(
            ["--model", name, "--num-classes", str(CLASSES), "--weights",
             weights, "--batch-size", str(EXPORT_BATCH), "--image-size",
             str(size), "--dtype", "bf16", "--out", pt2]))
        in_graph = export.op_calls(program)
        if in_graph != {f"{ops.NAMESPACE}::{k}": v for k, v in calls.items()}:
            raise AssertionError(f"{name} {size}: the program calls "
                                 f"{in_graph}, the path launches {calls}")
        seen |= set(in_graph)
        del program
        serve, _ = export.build_serve_module(
            name, CLASSES, weights, EXPORT_BATCH, size, torch.bfloat16,
            torch.device("cuda"))
        x = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (EXPORT_BATCH, size, size, 3), dtype=np.uint8)).cuda()
        with torch.no_grad():
            serve(x)
            _zero(counters)
            eager = serve(x).float().cpu().numpy()
        want = _want(calls, 1, False)
        launched = _check_launches(f"{name} {size} eager", counters, want)
        del serve
        npy = pt2 + ".logits.npy"
        # the fresh interpreter loads and runs the program while this one
        # exports the next (its output to files: a pipe could fill)
        with open(pt2 + ".out", "w") as out, open(pt2 + ".err", "w") as err:
            pending.append((name, size, pt2, npy, eager, want, launched,
                            stats, time.perf_counter(), subprocess.Popen(
                                [sys.executable, "-c", _LOAD_CODE, pt2, npy],
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)), stdout=out, stderr=err)))
    for (name, size, pt2, npy, eager, want, launched, stats, t0,
         proc) in pending:
        proc.wait(timeout=600)
        load_s = time.perf_counter() - t0
        with open(pt2 + ".out") as f:
            stdout = f.read()
        if proc.returncode != 0:
            with open(pt2 + ".err") as f:
                raise AssertionError(f"loading {pt2} in a fresh interpreter "
                                     f"failed: {f.read()[-3000:]}")
        r = json.loads(stdout.strip().splitlines()[-1])
        outside = [m for m in r["modules"] if m.split(".")[0] not in
                   ("cli", "kernels") or m.startswith("cli.")
                   and m != "cli.export"]
        if outside:
            raise AssertionError(f"loading {pt2} imported {outside}")
        if r["launches"] != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{name} {size}: the loaded forward "
                                 f"launched {r['launches']}, the eager "
                                 f"forward {launched}")
        loaded = np.load(npy)
        scale = float(np.abs(eager).max())
        err = float(np.abs(loaded - eager).max())
        if loaded.shape != eager.shape or not np.isfinite(loaded).all() or \
                err > EXPORT_TOL * scale:
            raise AssertionError(f"{name} {size}: loaded logits "
                                 f"{loaded.shape} max err {err:.3e} > "
                                 f"{EXPORT_TOL} x {scale:.3f}")
        same = bool(np.array_equal(loaded, eager))
        runs[f"{name} {size}"] = dict(stats, load_run_s=load_s,
                                      launches=r["launches"],
                                      max_abs_err=err, identical=same)
        texts.append(
            f"{name} {size}x{size}: trace {stats['trace_s']:.2f} s, save "
            f"{stats['save_s']:.2f} s, {stats['bytes'] / 2 ** 20:.1f} MiB; "
            f"loaded in a fresh python3 ({load_s:.2f} s with the start, "
            f"beside the next export), launches {launched} as eager, logits "
            f"max err {err:.3e} (tol {EXPORT_TOL} x {scale:.3f}), "
            f"bit-identical {same}")


# Data and sequence parallelism (phases 36-37).  The card machine has one
# H100 and NCCL takes one rank a GPU, so the parallel phases run 2 ranks
# that share the card over gloo: they hold the parallel paths to one
# process's numbers (correctness, not scaling).  DP: the seeded medmamba at
# SIZE in fp32, DP_BATCH images a step split over DP_RANKS ranks through the
# step functions, beside cli/ddp_train.py on EVAL_DIR's images at BATCH,
# an epoch, against one rank of the CLI's default NCCL backend.  SP (the
# same ranks): medmamba and medssd at SP_SIZE (every stage's L divides by
# 2), GRAD_BATCH images, fp32, sp SP_RANKS.  Files under PAR_DIR
PAR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_parallel")
DP_RANKS, DP_BATCH = 2, 8
SP_RANKS, SP_SIZE = 2, 256
# the forward kernels a rank launches in one SP train step at SP_SIZE, as
# often as their backward: each SS2D scans its L-shard twice (pass 1 from
# zero with want_state, pass 2 with init; 10 blocks), medssd's stage-0
# shards take Y_diag (tests/test_torch_kernel_reach.py SP_SITES)
SP_PATHS = {"medmamba": {"selective_scan_fwd": 2 * 10},
            "medssd": {"ssd_ydiag_fwd": 2}}
# the CLI runs: SGD (whose update is the gradient's; Adam's would turn the
# fp32 noise on a zero gradient into a step of lr), an epoch of one step
PAR_CLI_ARGS = ("--model", "medmamba", "--optimizer", "sgd", "--lr", "0.05",
                "--num-workers", "4", "--log-every", "1")
PAR_CLI_TIMEOUT = 600
# a checkpoint's BatchNorm running stats against one process's: rel-norm
# within PAR_STATS_TOL (the ranks' own batch statistics would land O(1e-2)
# away on images whose halves differ)
PAR_STATS_TOL = 1e-4
# fp32's rounding of a weight after a step, as a share of the weight's
# norm, that a checkpoint comparison allows beyond the update's tolerance
PAR_ULP_FLOOR = 1e-6


def _rank_main(rank, world, task, rdv, out):
    """One rank of a parallel phase, on the card, in a spawned process:
    joins the gloo group through ``rdv``, runs the task, saves its result
    to ``out``_<rank>.pt."""
    import torch
    import torch.distributed as dist
    from medical_image_classification_tpu_torch.parallel.mesh import (
        init_process_group)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("gloo", "cuda:0", rank=rank, world_size=world,
                       init_method="file://" + rdv)
    try:
        result = ({"dp": _dp_rank(world), "sp": _sp_rank(world)}
                  if task == "par" else _tp_rank(world) if task == "tp"
                  else _sp_rank(world))
        torch.save(result, f"{out}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(task, world):
    """``world`` ranks of ``task`` (spawned processes that share the card);
    their results, rank by rank.  A rank that raises fails the phase."""
    import torch
    os.makedirs(PAR_DIR, exist_ok=True)
    rdv, out = (os.path.join(PAR_DIR, f"{task}_{s}") for s in ("rdv", "out"))
    if os.path.exists(rdv):
        os.remove(rdv)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()       # the ranks share the card's memory
    torch.multiprocessing.start_processes(
        _rank_main, args=(world, task, rdv, out), nprocs=world,
        start_method="spawn")
    return [torch.load(f"{out}_{r}.pt", weights_only=False)
            for r in range(world)]


def _dp_step(rank, dp):
    """One step of the seeded medmamba (fp32) through make_train_step on
    the rows rank::dp of the DP batch (SGD at lr 0: the gradients stay and
    the weights do not move; cuDNN's deterministic algorithms): the loss,
    every parameter's gradient (after the data axis's mean) and the
    kernels' launches."""
    import torch
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        make_train_step)
    imgs, labels = next(SyntheticLoader(DP_BATCH, SIZE, CLASSES, steps=1,
                                        seed=3).epoch(0))
    dev = torch.device("cuda")
    with _cudnn_deterministic():
        model = _model("medmamba", None, "auto")
        model.seed_drop_path(7)
        opt = make_optimizer("sgd", model.named_parameters())
        step = make_train_step(model, opt, make_lr_scheduler(
            opt, make_schedule("constant", 0.0)))
        counters = _counters()
        _zero(counters)
        m = step(torch.from_numpy(imgs[rank::dp]).to(dev),
                 torch.from_numpy(labels[rank::dp]).long().to(dev))
        torch.cuda.synchronize()
        launches = _launches(counters)
    return dict(loss=float(m["loss"]), launches=launches,
                grads={n: p.grad.detach().double().flatten().cpu()
                       for n, p in model.named_parameters()})


def _dp_rank(world):
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    mesh = make_mesh(batch_size=DP_BATCH)
    try:
        return _dp_step(mesh.data_index, mesh.dp)
    finally:
        set_current_mesh(None)


@contextlib.contextmanager
def _scan_flag_spy():
    """Counts of the scan kernels' launches by state flag inside the
    block: forward with want_state and with init, backward with dlast and
    with dinit."""
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as ssb, selective_scan_fwd as ssf)
    flags = dict(fwd_want_state=0, fwd_init=0, bwd_dlast=0, bwd_dinit=0)
    fwd, bwd = ssf._launch_cuda, ssb._launch_cuda

    def spy_fwd(*a, want_state=False, init=None, **k):
        flags["fwd_want_state"] += bool(want_state)
        flags["fwd_init"] += init is not None
        return fwd(*a, want_state=want_state, init=init, **k)

    def spy_bwd(*a, dlast=None, want_dinit=False, **k):
        flags["bwd_dlast"] += dlast is not None
        flags["bwd_dinit"] += bool(want_dinit)
        return bwd(*a, dlast=dlast, want_dinit=want_dinit, **k)

    ssf._launch_cuda, ssb._launch_cuda = spy_fwd, spy_bwd
    try:
        yield flags
    finally:
        ssf._launch_cuda, ssb._launch_cuda = fwd, bwd


def _sp_step(name, seq):
    """One fp32 train-mode forward and backward of the seeded ``name`` at
    SP_SIZE on GRAD_BATCH images (cuDNN's deterministic algorithms), its
    scans L-sharded over the current mesh's seq axis with ``seq``: the
    loss, the logits, every parameter's gradient, the kernels' launches
    and the scan's by flag, and the step's wall seconds."""
    import torch
    from medical_image_classification_tpu_torch.data.image_folder import (
        normalize_batch)
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.train.train_step import (
        cross_entropy_loss)
    imgs, labels = next(SyntheticLoader(GRAD_BATCH, SP_SIZE, CLASSES,
                                        steps=1, seed=4).epoch(0))
    dev = torch.device("cuda")
    imgs = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(labels).long().to(dev)
    with _cudnn_deterministic():
        model = _model(name, None, "auto",
                       **({"seq_axis": "seq"} if seq else {})).train()
        model.seed_drop_path(7)
        counters = _counters()
        _zero(counters)
        with _scan_flag_spy() as flags:
            t0 = time.perf_counter()
            logits = model(normalize_batch(imgs))
            loss = cross_entropy_loss(logits, labels)
            loss.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = _launches(counters)
    return dict(loss=float(loss.detach()), logits=logits.detach().cpu(),
                launches=launches, flags=flags, seconds=seconds,
                grads={n: p.grad.detach().double().flatten().cpu()
                       for n, p in model.named_parameters()})


def _sp_pass_ms():
    """Device ms of the two passes at medmamba's stage-0 shard (G
    GRAD_BATCH x 4, L / SP_RANKS, Dm 96, N 16, fp32) from CUDA events over
    20 calls after a warm-up:
    pass 1's forward (want_state) and backward (dlast), pass 2's forward
    (init) and backward (dinit); and the unsharded scan's at the whole L;
    each beside its bound (``_scan_bound``)."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as ssb, selective_scan_fwd as ssf)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    L0, Dm = (SP_SIZE // 4) ** 2, 96
    out = {}
    for what, L in (("shard", L0 // SP_RANKS), ("unsharded", L0)):
        G = 4 * GRAD_BATCH
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        u, delta, B, C, dy = (rnd(G, L, Dm), 0.5 * rnd(G, L, Dm),
                              rnd(G, L, N), rnd(G, L, N), rnd(G, L, Dm))
        A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32
                          ).expand(4, Dm, N).contiguous()
        D, bias = rnd(4, Dm), 0.1 * rnd(4, Dm)
        init = rnd(G, N, Dm)
        args = (u, delta, A, B, C, D, bias)
        _, xsave, _ = ssf._launch_cuda(*args, False, True, want_xsave=True,
                                       want_state=True)
        fwd = lambda **k: ssf._launch_cuda(*args, False, True, **k)
        bwd = lambda **k: ssb._launch_cuda(*args, xsave, dy, False, True,
                                           **k)
        calls = ({"pass1_fwd": lambda: fwd(want_state=True),
                  "pass2_fwd": lambda: fwd(init=init),
                  "pass1_bwd": lambda: bwd(dlast=init),
                  "pass2_bwd": lambda: bwd(want_dinit=True)}
                 if what == "shard" else
                 {"unsharded_fwd": fwd, "unsharded_bwd": bwd})
        for key, fn in calls.items():
            fn()                                        # warm-up
            out[key + "_ms"] = _events_ms(fn, 20)
    # each call's bound (the passes' with the state flags' bytes)
    for key, L, backward, flags in (
            ("pass_fwd", L0 // SP_RANKS, False, True),
            ("pass_bwd", L0 // SP_RANKS, True, True),
            ("unsharded_fwd", L0, False, False),
            ("unsharded_bwd", L0, True, False)):
        out[key + "_bound_ms"] = _scan_bound(L, Dm, "fp32", backward,
                                             g=4 * GRAD_BATCH,
                                             flags=flags)[0]
    return out


def _sp_rank(world):
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    make_mesh(sp=world)
    try:
        return {name: _sp_step(name, True) for name in SP_PATHS}
    finally:
        set_current_mesh(None)


def _torchrun(nproc, args, log):
    """Start cli/ddp_train.py under torchrun (``nproc`` ranks on this
    host), its output to ``log``; ``_torchrun_wait`` ends it."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m",
           "medical_image_classification_tpu_torch.cli.ddp_train", *args]
    # fp32 without TF32 (the CLIs leave cuDNN's default, TF32 convolutions,
    # whose rounding differs between batch sizes by more than the
    # comparison's tolerance)
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True,
                                cwd=os.path.dirname(
                                    os.path.abspath(__file__)))
    return proc, log, time.perf_counter()


def _torchrun_kill(run):
    """Stop a ``_torchrun``, its ranks too (its own session: a failed
    phase stops what it started)."""
    import signal
    proc = run[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _torchrun_wait(run):
    """Wait for a ``_torchrun``; raises with the log's tail unless every
    rank exited 0 within PAR_CLI_TIMEOUT (the job is killed then).
    Returns its wall seconds."""
    proc, log, t0 = run
    try:
        code = proc.wait(timeout=PAR_CLI_TIMEOUT)
    finally:
        _torchrun_kill(run)
    if code:
        with open(log) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"{' '.join(proc.args)} exited {code}:\n"
                             f"{tail}")
    return time.perf_counter() - t0


def _same_checkpoint(got, want, init, what):
    """Two composite checkpoints of SGD runs from the weights ``init``: the
    step equal; each parameter leaf within PARAM_GRAD_TOL's rel-norm of
    one process's update (weight - init), plus PAR_ULP_FLOOR of the weight
    (fp32 rounds each weight after each step: the update cannot be read
    back to better than that) and lr x steps x PARAM_GRAD_TOL's abs floor
    (the gradient's floor through SGD: a conv bias that feeds a BatchNorm
    has a true gradient of 0 and moves by its fp32 noise); the BatchNorm
    running stats within PAR_STATS_TOL rel-norm.  Returns the worst (error
    / update over the leaves beyond the floors, running-stat rel-norm)."""
    import torch
    if got["step"] != want["step"]:
        raise AssertionError(f"{what}: step {got['step']}, one process "
                             f"{want['step']}")
    lr = float(PAR_CLI_ARGS[PAR_CLI_ARGS.index("--lr") + 1])
    abs_floor = lr * want["step"] * PARAM_GRAD_TOL[2]
    worst, worst_stats = 0.0, 0.0
    for k, w in want["model"].items():
        g = got["model"][k]
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"{what} {k}: {g} vs {w}")
            continue
        err = float((g - w).double().norm())
        if k in init:
            upd = float((w - init[k]).double().norm())
            floor = PAR_ULP_FLOOR * float(w.double().norm()) + abs_floor
            if err > floor:
                worst = max(worst, err / (upd + 1e-30))
            if err > PARAM_GRAD_TOL[0] * upd + floor:
                raise AssertionError(
                    f"{what} {k}: |DP - one process| {err:.3e}, one "
                    f"process's update {upd:.3e} (tol {PARAM_GRAD_TOL[0]} "
                    f"x update + {floor:.3e})")
            continue
        r = err / float(w.double().norm())
        worst_stats = max(worst_stats, r)
        if r > PAR_STATS_TOL:
            raise AssertionError(f"{what} {k}: rel-norm {r:.3e} from one "
                                 f"process (tol {PAR_STATS_TOL})")
    return worst, worst_stats


def phase_dp(card, num):
    """Data parallelism on the card: DP_RANKS ranks that share it over
    gloo.  cli/ddp_train.py under torchrun starts first, on EVAL_DIR's 40
    images, global batch BATCH (a step an epoch), --auto-resume, evaluated
    on the same images, over the gloo ranks and over one rank on the CLI's
    default NCCL backend (one process on the global batch).  Beside them,
    the ranks of the step functions (``_spawn("par")``, which also take
    phase_sp's steps): one step of the seeded full-width medmamba (fp32,
    224x224) through make_train_step on each rank's rows of DP_BATCH
    images: rows 1-2 launched 40 + 40 times on each rank, every other
    kernel none; the ranks' averaged gradients identical, and against one
    process's on the whole batch every parameter's within PARAM_GRAD_TOL,
    the loss (the data axis's mean) within 1e-5.  Then the CLIs' epoch-0
    checkpoints against each other: the weights within PARAM_GRAD_TOL's
    rel-norm of one process's update (and fp32's rounding), the running
    stats within PAR_STATS_TOL; rank 0 alone logs."""
    import torch
    import shutil
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()       # the CLIs' ranks share the card's memory
    root = os.path.join(EVAL_DIR, "oct")
    if not os.path.isdir(root):
        _eval_folder(root, ALL_INDEX_PER_CLASS, 0)
    common = ["--data-path", root, "--num-classes", str(CLASSES),
              "--batch-size", str(BATCH), "--image-size", str(SIZE),
              "--epochs", "1", *PAR_CLI_ARGS]
    for sub in ("dp", "one"):
        shutil.rmtree(os.path.join(PAR_DIR, sub), ignore_errors=True)
        os.makedirs(os.path.join(PAR_DIR, sub))
    save = {s: os.path.join(PAR_DIR, s, "m.ckpt") for s in ("dp", "one")}
    # the CLIs run beside the step functions' ranks (all on the card at
    # once: their seconds are wall seconds under that load)
    started = {
        "dp": _torchrun(DP_RANKS, common + [
            "--val-path", root, "--save-path", save["dp"], "--auto-resume",
            "--dist-backend", "gloo"], os.path.join(PAR_DIR, "dp.log")),
        "nccl 1 rank": _torchrun(1, common + ["--save-path", save["one"]],
                                 os.path.join(PAR_DIR, "one.log"))}
    try:
        ranks = _spawn("par", DP_RANKS)
        one = _dp_step(0, 1)
    except BaseException:
        for r in started.values():
            _torchrun_kill(r)
        raise
    _PAR_RANKS[:] = [r["sp"] for r in ranks]      # phase_sp's
    ranks = [r["dp"] for r in ranks]
    want = _want(_path("medmamba")[0], 1, True)
    for r, out in enumerate(ranks):
        if out["launches"] != want:
            raise AssertionError(f"DP rank {r}: kernel launches "
                                 f"{out['launches']}, expected {want}")
        if abs(out["loss"] - one["loss"]) > 1e-5 * abs(one["loss"]):
            raise AssertionError(f"DP rank {r} loss {out['loss']} vs one "
                                 f"process {one['loss']}")
        if any(not torch.equal(g, ranks[0]["grads"][n])
               for n, g in out["grads"].items()):
            raise AssertionError(f"DP rank {r}'s gradients are not rank "
                                 f"0's")
    rel, cos = _check_grad_tree("DP param grad", ranks[0]["grads"],
                                one["grads"], *PARAM_GRAD_TOL)
    runs = {k: _torchrun_wait(r) for k, r in started.items()}
    with open(os.path.join(PAR_DIR, "dp", "train.log")) as f:
        log = f.read()
    for line in ("mesh {'data': 2, 'model': 1, 'seq': 1}", "epoch 0 done",
                 "epoch 0 val top-1"):
        if log.count(line) != 1:
            raise AssertionError(f"the DP run's train.log holds {line!r} "
                                 f"{log.count(line)} times, expected once")
    ckpt = lambda s: torch.load(os.path.join(save[s], "epoch_0.pt"),
                                map_location="cpu", weights_only=True)
    from medical_image_classification_tpu_torch.models import create_model
    init = dict(create_model("medmamba", CLASSES, generator=torch.Generator()
                             .manual_seed(0)).named_parameters())
    init = {n: p.detach() for n, p in init.items()}
    worst = _same_checkpoint(ckpt("dp"), ckpt("one"), init, "DP CLI")
    seconds = time.perf_counter() - t0
    print(f"phase {num} data parallelism, {DP_RANKS} ranks sharing the card "
          f"over gloo (correctness, not scaling) | medmamba {SIZE}x{SIZE} "
          f"fp32, {DP_BATCH} images over {DP_RANKS} ranks through "
          f"make_train_step: launches on each rank "
          + ", ".join(f"{k} {v}" for k, v in want.items() if v)
          + f", the other kernels none; loss {ranks[0]['loss']:.6f} vs one "
          f"process {one['loss']:.6f}; averaged gradients identical on the "
          f"ranks, against one process worst leaf rel-norm {rel:.2e} cos "
          f"{cos:.6f} (tol {PARAM_GRAD_TOL}) | cli/ddp_train.py --auto-resume "
          f"on {CLASSES * ALL_INDEX_PER_CLASS} images, global batch {BATCH}, "
          f"SGD, an epoch (wall s from each start to its wait, beside the "
          f"step functions): {DP_RANKS} gloo ranks {runs['dp']:.1f} s, one "
          f"NCCL rank {runs['nccl 1 rank']:.1f} s; weights within "
          f"{worst[0]:.2e} of one process's update at worst (tol "
          f"{PARAM_GRAD_TOL[0]} + {PAR_ULP_FLOOR} of the weight), running "
          f"stats worst rel-norm {worst[1]:.2e} (tol {PAR_STATS_TOL}); rank 0 "
          f"alone logged | {seconds:.1f} s on {card}", flush=True)
    return dict(launches_per_rank=ranks[0]["launches"], loss=ranks[0]["loss"],
                one_loss=one["loss"], grad_rel=rel, grad_cos=cos,
                cli_seconds=runs, ckpt_update_rel=worst[0],
                ckpt_stats_rel=worst[1], seconds=seconds)


# the SP ranks' results of phase_dp's spawn, which phase_sp takes
_PAR_RANKS = []


def phase_sp(card, num):
    """Sequence parallelism on the card: SP_RANKS ranks that share it over
    gloo, each L-shard's scan on the kernels (the ranks of phase_dp's
    spawn, or its own).  medmamba and medssd at SP_SIZE, fp32, one
    train-mode forward and backward on GRAD_BATCH images, against the
    unsharded model in this process on the same weights and images: the
    loss within 1e-5, the logits within LOGIT_TOL, every parameter's
    gradient within PARAM_GRAD_TOL; on each rank the launches SP_PATHS says
    (medmamba: rows 1-2 20 + 20, half of the forwards with want_state and
    half with init, half of the backwards with dlast and half with dinit;
    medssd: Y_diag 2 + 2 on the stage-0 shards), every other kernel none.
    The passes' device ms are ``phase_sp_passes``'."""
    t0 = time.perf_counter()
    ranks = list(_PAR_RANKS) or _spawn("sp", SP_RANKS)
    _PAR_RANKS.clear()
    parts, out = [], {}
    for name, calls in SP_PATHS.items():
        ref = _sp_step(name, False)
        want = _want(calls, 1, True)
        n = calls.get("selective_scan_fwd", 0) // 2
        want_flags = dict(fwd_want_state=n, fwd_init=n, bwd_dlast=n,
                          bwd_dinit=n)
        for r, res in enumerate(ranks):
            got = res[name]
            if got["launches"] != want or got["flags"] != want_flags:
                raise AssertionError(
                    f"SP {name} rank {r}: launches {got['launches']}, by "
                    f"flag {got['flags']}; expected {want}, {want_flags}")
            if abs(got["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
                raise AssertionError(f"SP {name} rank {r} loss "
                                     f"{got['loss']} vs {ref['loss']}")
            _check_logits(f"SP {name} rank {r}", got["logits"].numpy(),
                          ref["logits"].numpy(), LOGIT_TOL["fp32"])
            rel, cos = _check_grad_tree(f"SP {name} rank {r} param grad",
                                        got["grads"], ref["grads"],
                                        *PARAM_GRAD_TOL)
        out[name] = dict(launches_per_rank=got["launches"],
                         flags=got["flags"], loss=got["loss"],
                         ref_loss=ref["loss"], grad_rel=rel, grad_cos=cos,
                         seconds=got["seconds"], ref_seconds=ref["seconds"])
        parts.append(
            f"{name}: launches on each rank "
            + ", ".join(f"{k} {v}" for k, v in want.items() if v)
            + (f" (forward {n} with want_state + {n} with init, backward "
               f"{n} with dlast + {n} with dinit)" if n else "")
            + f", the other kernels none; loss {got['loss']:.6f} vs "
            f"unsharded {ref['loss']:.6f}, logits within "
            f"{LOGIT_TOL['fp32']}, worst gradient leaf rel-norm {rel:.2e} "
            f"cos {cos:.6f} (tol {PARAM_GRAD_TOL}); step {got['seconds']:.3f}"
            f" s on a rank, {ref['seconds']:.3f} s unsharded")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase {num} sequence parallelism, sp {SP_RANKS} as ranks "
          f"sharing the card over gloo (correctness, not scaling), "
          f"{SP_SIZE}x{SP_SIZE} fp32, batch {GRAD_BATCH} | "
          + " | ".join(parts) + f" | {out['seconds']:.1f} s here (the "
          f"ranks' steps ran in phase 36's spawn) on {card}", flush=True)
    return out


def phase_sp_passes(card, num):
    """The SP scan's passes on the card alone (after the parallel phases:
    nothing else runs on it), ``_sp_pass_ms``; printed and returned."""
    passes = _sp_pass_ms()
    print(f"phase {num} SP scan passes at medmamba's stage-0 shard (G "
          f"{4 * GRAD_BATCH}, L {(SP_SIZE // 4) ** 2 // SP_RANKS}, Dm 96, "
          f"fp32, CUDA events), ms: "
          + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in passes.items())
          + f" on {card}", flush=True)
    return passes


# Tensor parallelism (phase 38): TP_RANKS ranks that share the card over
# gloo, each SS2D / SS2DSSD layer's d_inner channels (or heads) split over
# them (parallel/sharding.py), correctness, not scaling.  The seeded
# full-width models at SIZE in fp32, TP_BATCH images, one train step each
# through make_train_step (SGD at lr 0), against the unsharded step in this
# process on the same weights; then cli/ddp_train.py --tp over the ranks on
# EVAL_DIR's images against phase 36's one NCCL rank
TP_RANKS, TP_BATCH = 2, 8
# a rank's forward launches in one train step (its backward kernels as
# often): medmamba's 40 scans at d_inner / 2; medssd's stage 1 on the dirs
# kernels at half the heads (H4 8) and its stage 0 (d_ssm 64 a rank, which
# gn 128 does not divide: no dirs) on the single-layout fused SSD at l 224;
# cnn_mamba_mifa's stages 0-1 on the dirs kernels at N 64 (H4 4 and 8);
# st_ssd's stage-0 Y_diag at H 4, the mixer and the gate on the channels
# gathered over the ranks (tests/test_torch_kernel_reach.py TP_SITES)
TP_PATHS = {"medmamba": {"selective_scan_fwd": SCAN_CALLS_PER_FORWARD},
            "medssd": {"ssd_fused_dirs_fwd": 2, "ssd_fused_fwd": 2},
            "cnn_mamba_mifa": {"ssd_fused_dirs_fwd": 2 + 2},
            "st_ssd": {"ssd_ydiag_fwd": 2, "stl_mixer_fwd": 4,
                       "stf_zgate_fwd": 4}}
# the kernels at a rank's shapes at TP_BATCH: rows 1-2 at medmamba's
# stage 0 (G 8, L 3136, Dm 48; the unsharded Dm 96 beside it), rows 5/5b
# at medssd's stage 1 (L 784, l 196, H4 8, d_ssm 128, gn 128) and
# cnn_mamba_mifa's stage 0 (L 3136, l 224, H4 4, d_ssm 64, gn 16), rows
# 6/6b at medssd's stage 0 (L 3136, l 224, H 4, N 512)
TP_SCAN_CASES = ((3136, 96 // TP_RANKS, TP_BATCH, 1), (3136, 96, TP_BATCH, 1))
TP_SSD_CASES = ((784, 196, 8, 128, SSD_GN, TP_BATCH),
                (3136, 224, 4, 64, SSD16_GN, TP_BATCH))
TP_FUSED_CASES = ((TP_BATCH, 3136, 224, 4, 4 * SSD_GN),)


def _tp_step(name, mesh=None):
    """One train step of the seeded full-width ``name`` (fp32, SIZE) on
    TP_BATCH images through make_train_step with SGD at lr 0 (the
    gradients stay, the weights do not move; cuDNN's deterministic
    algorithms); with ``mesh`` (tp > 1) the model built with
    ``model_axis`` and loaded with this rank's pieces of the same seeded
    weights.  The loss, the logits, every parameter's gradient (joined over
    the model axis: the full tree), the kernels' launches, the step's wall
    seconds."""
    import torch
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.parallel.sharding import (
        gather_state_dict, shard_state_dict)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        make_train_step)
    imgs, labels = next(SyntheticLoader(TP_BATCH, SIZE, CLASSES, steps=1,
                                        seed=6).epoch(0))
    dev = torch.device("cuda")
    with _cudnn_deterministic():
        model = _model(name, None, "auto")
        if mesh is not None:
            model = _model(name, None, "auto", model_axis="model",
                           state_dict=shard_state_dict(model.state_dict(),
                                                       mesh))
        model.seed_drop_path(7)
        opt = make_optimizer("sgd", model.named_parameters())
        step = make_train_step(model, opt, make_lr_scheduler(
            opt, make_schedule("constant", 0.0)))
        logits = []
        hook = model.register_forward_hook(
            lambda m, args, out: logits.append(out.detach().cpu()))
        counters = _counters()
        _zero(counters)
        t0 = time.perf_counter()
        m = step(torch.from_numpy(imgs).to(dev),
                 torch.from_numpy(labels).long().to(dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches(counters)
        hook.remove()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    if mesh is not None:
        grads = gather_state_dict(grads, mesh)
    return dict(loss=float(m["loss"]), logits=logits[0], launches=launches,
                seconds=seconds, grads={n: g.double().flatten().cpu()
                                        for n, g in grads.items()})


def _tp_rank(world):
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    mesh = make_mesh(tp=world)
    try:
        return {name: _tp_step(name, mesh) for name in TP_PATHS}
    finally:
        set_current_mesh(None)


def phase_tp(card, num):
    """Tensor parallelism on the card: TP_RANKS ranks that share it over
    gloo (``_spawn("tp")``).  Each model of TP_PATHS, one train step of the
    seeded full-width model at SIZE, fp32, TP_BATCH images, against the
    unsharded step in this process: the loss within 1e-5, the logits
    within LOGIT_TOL, every parameter's gradient joined over the ranks
    within PARAM_GRAD_TOL, and on each rank exactly TP_PATHS' launches,
    every other kernel none.  Beside them cli/ddp_train.py --tp over the
    ranks (gloo, phase 36's arguments: EVAL_DIR's images, global batch
    BATCH, SGD, an epoch), its epoch-0 checkpoint (the full state_dict)
    against phase 36's one NCCL rank (or its own where phase 36 did not
    run) as phase 36 holds its DP run."""
    import shutil
    import torch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.join(EVAL_DIR, "oct")
    if not os.path.isdir(root):
        _eval_folder(root, ALL_INDEX_PER_CLASS, 0)
    common = ["--data-path", root, "--num-classes", str(CLASSES),
              "--batch-size", str(BATCH), "--image-size", str(SIZE),
              "--epochs", "1", *PAR_CLI_ARGS]
    save = {s: os.path.join(PAR_DIR, s, "m.ckpt") for s in ("tp", "one")}
    shutil.rmtree(os.path.join(PAR_DIR, "tp"), ignore_errors=True)
    os.makedirs(os.path.join(PAR_DIR, "tp"))
    started = {"tp": _torchrun(TP_RANKS, common + [
        "--val-path", root, "--save-path", save["tp"], "--tp",
        str(TP_RANKS), "--dist-backend", "gloo"],
        os.path.join(PAR_DIR, "tp.log"))}
    if not os.path.exists(os.path.join(save["one"], "epoch_0.pt")):
        os.makedirs(os.path.join(PAR_DIR, "one"), exist_ok=True)
        started["nccl 1 rank"] = _torchrun(
            1, common + ["--save-path", save["one"]],
            os.path.join(PAR_DIR, "one.log"))
    try:
        ranks = _spawn("tp", TP_RANKS)
        parts, out = [], {"models": {}}
        for name, calls in TP_PATHS.items():
            ref = _tp_step(name)
            want = _want(calls, 1, True)
            for r, res in enumerate(ranks):
                got = res[name]
                if got["launches"] != want:
                    raise AssertionError(
                        f"TP {name} rank {r}: launches {got['launches']}, "
                        f"expected {want}")
                if abs(got["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
                    raise AssertionError(f"TP {name} rank {r} loss "
                                         f"{got['loss']} vs {ref['loss']}")
                err = _check_logits(f"TP {name} rank {r}",
                                    got["logits"].numpy(),
                                    ref["logits"].numpy(), LOGIT_TOL["fp32"])
                rel, cos = _check_grad_tree(f"TP {name} rank {r} param grad",
                                            got["grads"], ref["grads"],
                                            *PARAM_GRAD_TOL)
            out["models"][name] = dict(
                launches_per_rank=got["launches"], loss=got["loss"],
                ref_loss=ref["loss"], logit_err=err, grad_rel=rel,
                grad_cos=cos, seconds=got["seconds"],
                ref_seconds=ref["seconds"])
            parts.append(
                f"{name}: launches on each rank "
                + ", ".join(f"{k} {v}" for k, v in want.items() if v)
                + f", the other kernels none; loss {got['loss']:.6f} vs "
                f"unsharded {ref['loss']:.6f}, logits max err {err:.2e} "
                f"(tol {LOGIT_TOL['fp32']} x max), joined gradients worst "
                f"leaf rel-norm {rel:.2e} cos {cos:.6f} (tol "
                f"{PARAM_GRAD_TOL}); step {got['seconds']:.3f} s on a rank, "
                f"{ref['seconds']:.3f} s unsharded")
    except BaseException:
        for r in started.values():
            _torchrun_kill(r)
        raise
    runs = {k: _torchrun_wait(r) for k, r in started.items()}
    with open(os.path.join(PAR_DIR, "tp", "train.log")) as f:
        log = f.read()
    mesh_line = f"mesh {{'data': 1, 'model': {TP_RANKS}, 'seq': 1}}"
    for line in (mesh_line, "epoch 0 done", "epoch 0 val top-1"):
        if log.count(line) != 1:
            raise AssertionError(f"the TP run's train.log holds {line!r} "
                                 f"{log.count(line)} times, expected once")
    ckpt = lambda s: torch.load(os.path.join(save[s], "epoch_0.pt"),
                                map_location="cpu", weights_only=True)
    from medical_image_classification_tpu_torch.models import create_model
    init = dict(create_model("medmamba", CLASSES, generator=torch.Generator()
                             .manual_seed(0)).named_parameters())
    init = {n: p.detach() for n, p in init.items()}
    got, one = ckpt("tp"), ckpt("one")
    shapes = lambda c: {k: tuple(v.shape) for k, v in c["model"].items()}
    if shapes(got) != shapes(one):
        raise AssertionError("the TP checkpoint is not the full state_dict")
    worst = _same_checkpoint(got, one, init, "TP CLI")
    out.update(cli_seconds=runs, ckpt_update_rel=worst[0],
               ckpt_stats_rel=worst[1], seconds=time.perf_counter() - t0)
    print(f"phase {num} tensor parallelism, tp {TP_RANKS} as ranks sharing "
          f"the card over gloo (correctness, not scaling), {SIZE}x{SIZE} "
          f"fp32, batch {TP_BATCH}, one train step a model | "
          + " | ".join(parts)
          + f" | cli/ddp_train.py --tp {TP_RANKS} on "
          f"{CLASSES * ALL_INDEX_PER_CLASS} images, global batch {BATCH}, "
          f"SGD, an epoch (wall s from its start to its wait): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in runs.items())
          + f"; its checkpoint the full state_dict, weights within "
          f"{worst[0]:.2e} of one NCCL process's update at worst (tol "
          f"{PARAM_GRAD_TOL[0]} + {PAR_ULP_FLOOR} of the weight), running "
          f"stats worst rel-norm {worst[1]:.2e} (tol {PAR_STATS_TOL}) | "
          f"{out['seconds']:.1f} s on {card}", flush=True)
    return out


def _tp_case(what, run_k, run_p, names, check, bound, reps):
    """A kernel at a TP rank's shape: its outputs against the plain
    version's (``check(what, got, want)``), device ms by CUDA events over
    ``reps`` calls after a warm-up, the plain version's over the one call
    the check reads."""
    import torch
    as_tuple = lambda x: tuple(x) if isinstance(x, (tuple, list)) else (x,)
    gk = as_tuple(run_k())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    gp = as_tuple(run_p())
    end.record()
    torch.cuda.synchronize()
    err = max(check(f"{what} {nm}", a, b) for nm, a, b in zip(names, gk, gp))
    del gk, gp
    return dict(max_abs_err=err, ms=_events_ms(run_k, reps),
                plain_ms=start.elapsed_time(end), bound=bound)


def phase_tp_kernels(card, num):
    """The kernels at a TP rank's shapes, the card to themselves (after
    the parallel phases): rows 1-2 at TP_SCAN_CASES (forward order, K 1),
    rows 5/5b at TP_SSD_CASES and rows 6/6b at TP_FUSED_CASES, fp32 and
    bf16, each against its plain version and beside its bound."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as ssb, selective_scan_fwd as ssf,
        ssd_fused as sf, ssd_fused_dirs as sfd)
    cases = []
    for L, Dm, dt_name, reverse, args, g in _scan_cases(TP_SCAN_CASES):
        if reverse:
            continue
        _, xsave = ssf.scan_folded_fwd_ref(*args, want_xsave=True)
        dy = torch.randn(args[0].shape, device="cuda", generator=torch
                         .Generator(device="cuda").manual_seed(L + Dm)
                         ).to(args[0].dtype)
        shape = dict(G=g, L=L, Dm=Dm, N=N)
        for kernel, run_k, run_p, names, tol, reps in (
                ("selective_scan_fwd",
                 lambda: ssf.scan_folded_fwd(*args, impl="cuda"),
                 lambda: ssf.scan_folded_fwd_ref(*args), ("y",),
                 lambda w, a, b: _check_close(w, a, b, *TOL[dt_name]), 20),
                ("selective_scan_bwd",
                 lambda: ssb.scan_folded_bwd(*args, xsave, dy, impl="cuda"),
                 lambda: ssb.scan_folded_bwd_ref(*args, xsave, dy),
                 GRAD_NAMES,
                 lambda w, a, b: _check_close(w, a, b, *GRAD_TOL[dt_name]),
                 10)):
            c = _tp_case(f"TP {kernel} {shape} {dt_name}", run_k, run_p,
                         names, tol, _scan_bound(
                             L, Dm, dt_name, kernel.endswith("bwd"), g),
                         reps)
            cases.append(dict(c, kernel=kernel, shape=shape, dtype=dt_name,
                              per_rank=Dm != 96))
    for L, l, dt_name, args, d_ssm, dy, gn in _ssd_cases(TP_SSD_CASES):
        _, Ssave = sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, gn,
                                              want_save=True)
        shape = dict(B=args[0].shape[0], L=L, l=l, H4=args[1].shape[2],
                     d_ssm=d_ssm, N=4 * gn)
        for kernel, run_k, run_p, names, tol, reps in (
                ("ssd_fused_dirs_fwd",
                 lambda: sfd.ssd_fused_dirs_fwd(*args, d_ssm, gn,
                                                impl="cuda"),
                 lambda: sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, gn),
                 ("y",), lambda w, a, b: _check_scaled(
                     w, a, b, *SSD_TOL[dt_name]), 10),
                ("ssd_fused_dirs_bwd",
                 lambda: sfd.ssd_fused_dirs_bwd(*args, d_ssm, gn, Ssave, dy,
                                                impl="cuda"),
                 lambda: sfd.ssd_fused_dirs_bwd_ref(*args, d_ssm, gn, Ssave,
                                                    dy),
                 SSD_GRAD_NAMES, lambda w, a, b: _check_scaled(
                     w, a, b, *SSD_GRAD_TOL[dt_name]), 5)):
            c = _tp_case(f"TP {kernel} {shape} {dt_name}", run_k, run_p,
                         names, tol, _ssd_bound(
                             args, d_ssm, 4 * gn, dt_name,
                             kernel.endswith("bwd")), reps)
            cases.append(dict(c, kernel=kernel, shape=shape, dtype=dt_name,
                              per_rank=True))
        del Ssave
    for case, dt_name, args, dy in _fused_cases(TP_FUSED_CASES):
        _, Ssave = sf.ssd_fused_fwd_ref(*args, want_save=True)
        for kernel, run_k, run_p, names, tol, reps in (
                ("ssd_fused_fwd", lambda: sf.ssd_fused_fwd(*args,
                                                           impl="cuda"),
                 lambda: sf.ssd_fused_fwd_ref(*args), ("y",),
                 lambda w, a, b: _check_scaled(w, a, b, *SSD_TOL[dt_name]),
                 10),
                ("ssd_fused_bwd",
                 lambda: sf.ssd_fused_bwd(*args, Ssave, dy, impl="cuda"),
                 lambda: sf.ssd_fused_bwd_ref(*args, Ssave, dy),
                 FUSED_GRAD_NAMES, lambda w, a, b: _check_scaled(
                     w, a, b, *SSD_GRAD_TOL[dt_name]), 5)):
            c = _tp_case(f"TP {kernel} {case['shape']} {dt_name}", run_k,
                         run_p, names, tol, _fused_bound(
                             args, dt_name, kernel.endswith("bwd")), reps)
            cases.append(dict(c, kernel=kernel, shape=case["shape"],
                              dtype=dt_name, per_rank=True))
        del Ssave
    print(f"phase {num} the kernels at a TP rank's shapes (CUDA events, the "
          f"card to themselves), each within its phase-2 tolerance of its "
          f"plain version: "
          + "; ".join(f"{c['kernel']} {c['shape']} {c['dtype']} "
                      f"{c['ms']:.4f} ms (plain {c['plain_ms']:.2f} ms, "
                      f"bound {c['bound'][0]:.4f} ms {c['bound'][1]}, err "
                      f"{c['max_abs_err']:.2e})" for c in cases)
          + f" on {card}", flush=True)
    return cases


# Phase 39: the profiled train steps (``utils/profiling.py``) and their
# FLOPs (``utils/flops.py``): each (model, compute dtype) at SIZE, BATCH.
PROFILE_CASES = (("medmamba", "bf16"), ("medssd", "bf16"),
                 ("st_ssd", "bf16"), ("st_ssd", "fp32"))
PROFILE_STEPS = 3
PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_profile")
# two readers of one capture: the trace's device events as
# ``profiling.attribute`` counts them against the capture's own event list
# (the records the trace was written from, so this checks the reader's
# filters: the warm-up, the annotation spans) and against key_averages()
# (torch's own aggregate); and the share of kernel time that must have a
# source line of the port
PROFILE_READERS_TOL = 5e-3
PROFILE_ATTRIBUTED = 0.99
# the captures also read by key_averages() (11-18 s each with stacks on)
PROFILE_KEY_AVERAGES = ("medmamba",)

# each kernel's category and the pass it launches once a call, by which a
# capture's launches are counted by source (the fp32 Y_diag backward runs
# other passes than the bf16 one)
PROFILE_MARKERS = {
    "selective_scan_fwd": ("port row 1: scan", "chunk_carry_kernel<false>"),
    "selective_scan_bwd": ("port row 2: scan backward", "bwd_local_kernel"),
    "ssd_fused_dirs_fwd": ("port row 5: SSD dirs", "fwd::prep_kernel"),
    "ssd_fused_dirs_bwd": ("port row 5b: SSD dirs backward",
                           "bwd::prep_kernel"),
    "ssd_ydiag_fwd": ("port row 7: Y_diag", "ssd_ydiag::rows_kernel"),
    "ssd_ydiag_bwd": ("port row 7b: Y_diag backward",
                      {"bf16": "ssd_ydiag::cols_kernel",
                       "fp32": "f32::grad_kernel"}),
    "stl_mixer_fwd": ("port row 8: STL mixer", "mixer_fwd_rows_kernel"),
    "stl_mixer_bwd": ("port row 8b: STL mixer backward",
                      "mixer_bwd_cols_kernel"),
    "stf_zgate_fwd": ("port row 9: STF gate", "zgate_fwd_rows_kernel"),
    "stf_zgate_bwd": ("port row 9b: STF gate backward",
                      "zgate_bwd_cols_kernel"),
}
# the CPU's count: a fresh process without the card counts each case's
# forward and train step on fake tensors while the card profiles
_FLOPS_CODE = (
    "import json, sys, torch\n"
    "import torch.nn.functional as F\n"
    "from medical_image_classification_tpu_torch.models import create_model\n"
    "from medical_image_classification_tpu_torch.utils import flops\n"
    "cases, batch, size, classes = json.loads(sys.argv[1])\n"
    "x = torch.zeros(batch, size, size, 3)\n"
    "onehot = F.one_hot(torch.arange(batch) % classes, classes).float()\n"
    "loss = lambda out, *a: -(onehot * F.log_softmax(out.float(), -1))"
    ".sum(-1).mean()\n"
    "out = {}\n"
    "for name, dt in cases:\n"
    "    kw = {'dtype': torch.bfloat16} if dt == 'bf16' else {}\n"
    "    m = create_model(name, classes, generator=torch.Generator()"
    ".manual_seed(0), **kw)\n"
    "    out[name + ' ' + dt] = [flops.model_flops(m, x), "
    "flops.train_flops(m, x, loss)]\n"
    "print(json.dumps(out))\n")


def _kineto_device_us(prof):
    """The device time of a capture from its own event list (what
    key_averages() is built from), gpu_user_annotation spans left out,
    and the kernels inside ``profiling.trace``'s warm-up span."""
    from torch.autograd import DeviceType
    from medical_image_classification_tpu_torch.utils import profiling
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    warm = [(e.start_ns(), e.end_ns()) for e in dev
            if e.is_user_annotation() and e.name() == profiling.WARMUP]
    return sum(e.duration_ns() for e in dev if not e.is_user_annotation()
               and not any(a <= e.start_ns() <= b for a, b in warm)) / 1e3


def _launches_by_source(records, calls, dt_name, steps):
    """{kernel: {source: launches a step}} of the path's kernels
    (``calls``: forward kernels and their launches a forward; each one's
    backward launches as often), counted by each kernel's marker pass in
    its category, from ``profiling.attribute``'s records."""
    out = {}
    for fwd in calls:
        for k in (fwd, fwd[:-len("fwd")] + "bwd"):
            cat, marker = PROFILE_MARKERS[k]
            marker = marker[dt_name] if isinstance(marker, dict) else marker
            by = {}
            for r in records:
                if r["category"] == cat and marker in r["name"]:
                    by[r["source"]] = by.get(r["source"], 0) + 1
            out[k] = {src: n / steps for src, n in by.items()}
    return out


# a capture read in a fresh process while the card profiles the next case
# (``utils/profiling.py`` reads a trace without torch): the kernel launches
# outside the warm-up without a device record, and where there are none
# the counted events
_READ_CODE = (
    "import json, sys\n"
    "from medical_image_classification_tpu_torch.utils import profiling\n"
    "tr = profiling.load_trace(sys.argv[1])\n"
    "lost = profiling.lost_launches([e for e in tr['traceEvents']\n"
    "                                if e.get('ph') == 'X'])\n"
    "recs = [] if lost else profiling.attribute(tr)\n"
    "print(json.dumps([lost, [[r['name'], r['category'], r['source'],\n"
    "                          r['us']] for r in recs]]))\n")


def _python(code, *args, env=None):
    """A fresh ``python -c code args`` from the repo's root, its output
    piped."""
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _output(proc, what, timeout=600):
    """The last line of a ``_python`` process's output; raises if it
    failed."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed: {err[-2000:]}")
    return out.strip().splitlines()[-1]


def phase_profile(card, num):
    """Phase 39: three train steps after warm-up of medmamba, medssd and
    st_ssd at 224x224, batch 32, in bf16 and st_ssd in fp32 (the CLIs'
    default), each traced by ``utils/profiling.trace`` and read by
    ``profiling.attribute`` (in a fresh process, beside the next case):
    the device time by category and by source line, printed (the "rest"
    split by line); gated: every kernel launch outside the warm-up with
    its device record (``profiling.lost_launches`` 0), the trace's total
    against the capture's own event list within PROFILE_READERS_TOL (and
    against key_averages() for PROFILE_KEY_AVERAGES), at least
    PROFILE_ATTRIBUTED of the kernel time with a port source line, every kernel in a named category, each
    kernel of the path launched as PATHS says, every launch on a line of
    ops/ or models/.  The forward's and the train step's FLOPs counted on
    the card (FlopCounterMode over a real forward and a real step) equal
    the CPU's count on fake tensors, from a fresh process; TFLOP/s = the
    step's FLOPs over its device ms.  Every case's numbers are printed
    before a failed gate raises."""
    import shutil

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from medical_image_classification_tpu_torch.data.image_folder import (
        normalize_batch)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        make_train_step)
    from medical_image_classification_tpu_torch.utils import flops, profiling
    procs = {"flops": _python(_FLOPS_CODE, json.dumps(
        [PROFILE_CASES, BATCH, SIZE, CLASSES]),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))}
    results, texts, failed = {}, [], []
    try:
        gen = torch.Generator().manual_seed(7)
        imgs = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                             dtype=torch.uint8, generator=gen).cuda()
        labels = (torch.arange(BATCH) % CLASSES).cuda()
        for name, dt_name in PROFILE_CASES:
            key = f"{name} {dt_name}"
            dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
            model = _model(name, dtype, "auto")
            model.seed_drop_path(1)
            opt = make_optimizer("adam", model.named_parameters())
            step = make_train_step(model, opt, make_lr_scheduler(
                opt, make_schedule("constant", 1e-4)))
            with FlopCounterMode(display=False) as fc:
                step(imgs, labels)                          # warm-up
            model.eval()
            with torch.no_grad():
                fwd_flops = flops.cost_analysis(
                    lambda: model(normalize_batch(imgs)))["flops"]
            model.train()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                step(imgs, labels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 2 * 1e3
            logdir = os.path.join(PROFILE_DIR, key.replace(" ", "_"))
            counters = _counters()
            want = _want(_path(name)[0], PROFILE_STEPS, True)
            shutil.rmtree(logdir, ignore_errors=True)
            _zero(counters)
            t0 = time.perf_counter()
            with profiling.trace(logdir) as prof:
                for _ in range(PROFILE_STEPS):
                    step(imgs, labels)
            if _launches(counters) != want:
                failed.append(f"{key}: the wrappers launched "
                              f"{_launches(counters)} in the capture, "
                              f"expected {want}")
            procs[key] = _python(_READ_CODE, logdir)
            r = results[key] = dict(
                trace_s=time.perf_counter() - t0, wall_ms=wall_ms,
                own_ms=_kineto_device_us(prof) / 1e3 / PROFILE_STEPS,
                key_averages_ms=None, fwd_flops=fwd_flops,
                step_flops=fc.get_total_flops())
            t0 = time.perf_counter()
            if name in PROFILE_KEY_AVERAGES and dt_name == "bf16":
                r["key_averages_ms"] = sum(
                    row["device_us"] for row in _rows_of_key_averages(
                        prof.key_averages()) if row["cpu_us"] == 0.0) \
                    / 1e3 / PROFILE_STEPS
            r["key_averages_s"] = time.perf_counter() - t0
            del model, opt, step, prof
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for (name, dt_name), (key, r) in zip(PROFILE_CASES, results.items()):
            lost, rows = json.loads(_output(procs.pop(key),
                                            f"reading {key}'s trace"))
            r["lost_launches"] = lost
            if lost:
                failed.append(f"{key}: {lost} kernel launches outside the "
                              "warm-up have no device record")
                texts.append(f"{key}: {lost} launches lost")
                continue
            records = [dict(name=n, category=c, source=src, us=us)
                       for n, c, src, us in rows]
            summary = profiling.summarize_records(records, PROFILE_STEPS)
            total, own_ms = summary["total_ms"], r["own_ms"]
            ka_ms = r["key_averages_ms"]
            for what, ms in (("the capture's own", own_ms),
                             ("key_averages()'", ka_ms)):
                if ms is not None and abs(total - ms) > \
                        PROFILE_READERS_TOL * ms:
                    failed.append(f"{key}: the trace's {total:.3f} ms a "
                                  f"step against {what} {ms:.3f}")
            attributed = 1.0 - summary["by_source"].get("?", 0.0) / total
            if attributed < PROFILE_ATTRIBUTED:
                failed.append(f"{key}: {attributed:.4f} of the kernel time "
                              "has a source line")
            other = sorted({x["name"][:80] for x in records
                            if x["category"] == profiling.OTHER})
            if other:
                failed.append(f"{key}: kernels in no named category: "
                              f"{other[:5]}")
            calls = _path(name)[0]
            by_src = _launches_by_source(records, calls, dt_name,
                                         PROFILE_STEPS)
            for k, srcs in by_src.items():
                want = calls[k[:-len("bwd")] + "fwd"]
                bad = [x for x in srcs
                       if not x.startswith(("ops/", "models/"))]
                if sum(srcs.values()) != want or bad:
                    failed.append(f"{key}: {k} launches by source {srcs}, "
                                  f"expected {want} a step on ops/ or "
                                  "models/ lines")
            port = sum(v for c, v in summary["by_category"].items()
                       if c.startswith("port"))
            r.update(device_ms=total, attributed=attributed,
                     rest_ms=total - port, by_category=summary["by_category"],
                     by_source=dict(list(summary["by_source"].items())[:25]),
                     by_op=dict(list(summary["by_op"].items())[:25]),
                     launches_by_source=by_src,
                     tflops=r["step_flops"] / (total * 1e-3) / 1e12)
            texts.append(
                f"{key}: {total:.2f} ms device a step (the capture's own "
                f"{own_ms:.2f}" + (f", key_averages {ka_ms:.2f}"
                                   if ka_ms is not None else "") +
                f"), every launch recorded, wall {r['wall_ms']:.2f} ms a "
                f"step, rest "
                f"{total - port:.2f} ms, {attributed * 100:.2f}% attributed, "
                f"{r['step_flops'] / BATCH / 1e9:.2f} GF/img a step "
                f"({r['fwd_flops'] / BATCH / 1e9:.2f} forward), "
                f"{r['tflops']:.2f} TFLOP/s; launches by source "
                + "; ".join(f"{k} " + ", ".join(f"{x} {n:g}"
                                                for x, n in v.items())
                            for k, v in by_src.items())
                + "; by category " + ", ".join(
                    f"{c} {v:.2f}" for c, v in
                    list(summary["by_category"].items())[:8])
                + "; by source " + ", ".join(
                    f"{x} {v:.2f}" for x, v in
                    list(summary["by_source"].items())[:10])
                + f" (trace {r['trace_s']:.1f} s, key_averages "
                f"{r['key_averages_s']:.1f} s)")
        counted = json.loads(_output(procs.pop("flops"),
                                     "the CPU's FLOP count"))
        wait_s = time.perf_counter() - t0
        for key, r in results.items():
            r["cpu_fwd_flops"], r["cpu_step_flops"] = counted[key]
            if [r["fwd_flops"], r["step_flops"]] != counted[key]:
                failed.append(f"{key}: FLOPs on the card forward "
                              f"{r['fwd_flops']}, step {r['step_flops']}; "
                              f"on the CPU {counted[key]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    text = " | ".join(texts) + f" | then {wait_s:.1f} s for the readers"
    if failed:
        print(f"phase {num}: {text}", flush=True)
        raise AssertionError(f"phase {num}: " + "; ".join(failed))
    print(f"phase {num} profiled train steps ({card}; {PROFILE_STEPS} steps "
          f"after warm-up, b{BATCH} {SIZE}x{SIZE}, FLOPs on the card equal "
          f"the CPU's fake count): {text}", flush=True)
    return results


def _entry(name, replaces, cases, launches, head, bound):
    """One kernel's record for the kernels line; ``head`` picks the case
    whose times it reports; ``replaces`` is file:line under the JAX
    package's kernels/, or a path from the repo's root."""
    c = next(c for c in cases if head(c))
    if "/" not in replaces:
        replaces = f"medical_image_classification_tpu/kernels/{replaces}"
    return {"name": name, "route": "cuda",
            "source": f"medical_image_classification_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", default=None,
                   help="write the per-case numbers here as JSON")
    args = p.parse_args(argv)

    seconds, clock = {}, [time.perf_counter()]

    def lap(key):
        # the wall seconds of phase ``key``: since the last lap
        now = time.perf_counter()
        seconds[key], clock[0] = round(now - clock[0], 1), now
        print(f"phase {key} took {seconds[key]} s", flush=True)

    card = phase_device_and_build()
    lap("1")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = phase_kernel_vs_plain()
    lap("2")
    bwd = phase_bwd_vs_plain()
    lap("2b")
    ssd_cases = phase_ssd_fwd_vs_plain()
    lap("2c")
    ssd_bwd = phase_ssd_bwd_vs_plain()
    lap("2d")
    yd_cases = phase_ydiag_vs_plain()
    lap("2e")
    stl_cases = phase_stl_vs_plain()
    lap("2f")
    stf_cases = phase_stf_vs_plain()
    lap("2g")
    yd_bwd = phase_ydiag_bwd_vs_plain()
    lap("2h")
    stl_bwd = phase_stl_bwd_vs_plain()
    lap("2i")
    stf_bwd = phase_stf_bwd_vs_plain()
    lap("2j")
    fused_cases = phase_fused_fwd_vs_plain()
    lap("2k")
    fused_bwd = phase_fused_bwd_vs_plain()
    lap("2l")
    flag_cases = phase_scan_fwd_flags()
    lap("2m")
    flag_bwd = phase_scan_bwd_flags()
    lap("2n")
    v1_cases = phase_v1_fwd_vs_plain()
    lap("2o")
    v1_bwd = phase_v1_bwd_vs_plain()
    lap("2p")
    calib_cases = phase_calib_vs_plain()
    lap("2q")
    ssd16_paths = phase_ssd16_paths()
    lap("2r")
    full = phase_full_model(card, "medmamba", 3)
    lap("3")
    train = phase_train(card, "medmamba", 4)
    lap("4")
    ssd_full = phase_full_model(card, "medssd", 5)
    lap("5")
    ssd_train = phase_train(card, "medssd", 6)
    lap("6")
    st_full = phase_full_model(card, "st_ssd", 7)
    lap("7")
    st_train = phase_train(card, "st_ssd", 8)
    lap("8")
    ssd240_full = phase_full_model(card, "medssd", 9, MEDSSD_240)
    lap("9")
    ssd240_train = phase_train(card, "medssd", 10, MEDSSD_240)
    lap("10")
    lm = phase_lm_scoring(card)
    lap("11")
    lm_gen = phase_lm_generate(card)
    lap("12")
    bench = phase_kernel_bench(card)
    lap("13")
    # the SSD models at d_state 16: two through the full eval and training
    # phases, the other seven one forward and one step each, the two
    # re-gridding heads once on the card
    ssd16, num = {}, 14
    for name in SSD16_FULL:
        ssd16[name] = dict(eval=phase_full_model(card, name, num),
                           train=phase_train(card, name, num + 1))
        lap(f"{num}-{num + 1}")
        num += 2
    for name in SSD16_STEP:
        ssd16[name] = phase_model_step(card, name, num)
        lap(str(num))
        num += 1
    for name in SSD16_REGRID:
        ssd16[name + " regrid"] = phase_kan_regrid(card, name, num)
        lap(str(num))
        num += 1
    # the CrossMamba family: cross_cls_stage3 through full eval and
    # training, the other two classifiers a forward and a step each, the
    # fusion U-Nets through their CLIs
    cross = {CROSS_FULL: phase_cross_full(card, CROSS_FULL, num)}
    lap(str(num))
    num += 1
    for name in CROSS_STEP:
        cross[name] = phase_cross_step(card, name, num)
        lap(str(num))
        num += 1
    cross["vfefm_2b2"] = phase_vfefm(card, num)
    lap(str(num))
    cross["vfefm_2c1"] = phase_vfefm_2c1(card, num + 1)
    lap(str(num + 1))
    # FusionMamba through its CLI: the scan pair at K 4
    fm = phase_fusionmamba(card, num + 2)
    lap(str(num + 2))
    # the evaluation tools: --all-index, Grad-CAM, export
    all_index = phase_all_index(card, num + 3)
    lap(str(num + 3))
    cam = phase_grad_cam(card, num + 4)
    lap(str(num + 4))
    exported = phase_export(card, num + 5)
    lap(str(num + 5))
    # data and sequence parallelism: ranks that share the card over gloo
    dp = phase_dp(card, num + 6)
    lap(str(num + 6))
    sp = phase_sp(card, num + 7)
    lap(str(num + 7))
    sp["passes"] = phase_sp_passes(card, num + 7)
    lap(str(num + 7) + " passes")
    # tensor parallelism: ranks that share the card over gloo, then the
    # kernels at a rank's shapes
    tp = phase_tp(card, num + 8)
    lap(str(num + 8))
    tp["kernels"] = phase_tp_kernels(card, num + 8)
    lap(str(num + 8) + " kernels")
    # the profiled train steps: device time by category and source line,
    # FLOPs on the card against the CPU's count
    profiled = phase_profile(card, num + 9)
    lap(str(num + 9))

    leaked = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "flax", "optax"))
                    or m.split(".")[0] == "medical_image_classification_tpu")
    if leaked:
        raise AssertionError(f"the port's path imported {leaked[:5]}")
    # launches in the training runs; times and bounds at stage 0 in bf16
    # (the forward scan's direction 0)
    scan_head = lambda c: (c["L"] == STAGES[0][0] and c["dtype"] == "bf16"
                           and not c["reverse"])
    ssd_head = lambda c: c["L"] == SSD_STAGES[0][0] and \
        c["dtype"] == "bf16" and c["N"] == 4 * SSD_GN and \
        c["H4"] == SSD_STAGES[0][2]
    st_head = lambda c: c["L"] == ST_STAGES[0][0] and c["dtype"] == "bf16"
    fused_head = lambda c: c["L"] == FUSED_CASES[0][1] and \
        c["dtype"] == "bf16"
    entries = [
        _entry("selective_scan_fwd", "selective_scan_pallas_v2.py:36",
               cases + flag_cases, train["launches"]["selective_scan_fwd"],
               scan_head, _scan_bound(*STAGES[0], "bf16", False)),
        _entry("selective_scan_bwd", "selective_scan_pallas_bwd_v2.py:57",
               bwd["cases"] + flag_bwd["cases"],
               train["launches"]["selective_scan_bwd"], scan_head,
               _scan_bound(*STAGES[0], "bf16", True))]
    # rows 1-2 also at the LM's layer call (fp32, forward scan, flags on),
    # with the LM's launches: per scoring forward, per gradient step
    lm_head = lambda c: c.get("name") == "lm" and c["dtype"] == "fp32" \
        and not c["reverse"]
    for e, fc, per in ((entries[0], flag_cases,
                        dict(per_forward=lm["launches_per_forward"])),
                       (entries[1], flag_bwd["cases"],
                        dict(per_grad_step=LM_GRAD_LAYERS))):
        c = next(c for c in fc if lm_head(c))
        e["lm"] = dict(per, shape=c["shape"], dtype="fp32", ms=c["ms"],
                       plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
                       bound_by=c["bound"][1])
    for name, replaces, st_cases, head, launches in (
            ("ssd_fused_dirs_fwd", "ssd_fused_dirs_pallas.py:178", ssd_cases,
             ssd_head, ssd_train),
            ("ssd_fused_dirs_bwd", "ssd_fused_dirs_pallas.py:240",
             ssd_bwd["cases"], ssd_head, ssd_train),
            ("ssd_ydiag_fwd", "ssd_ydiag_pallas.py:153", yd_cases, st_head,
             st_train),
            ("ssd_ydiag_bwd", "ssd_ydiag_pallas.py:174", yd_bwd["cases"],
             st_head, st_train),
            ("stl_mixer_fwd", "stl_mixer_pallas.py:85", stl_cases, st_head,
             st_train),
            ("stl_mixer_bwd", "stl_mixer_pallas.py:107", stl_bwd["cases"],
             st_head, st_train),
            ("stf_zgate_fwd", "stf_zgate_pallas.py:76", stf_cases, st_head,
             st_train),
            ("stf_zgate_bwd", "stf_zgate_pallas.py:85", stf_bwd["cases"],
             st_head, st_train),
            ("ssd_fused_fwd", "ssd_fused_pallas.py:139", fused_cases,
             fused_head, ssd240_train),
            ("ssd_fused_bwd", "ssd_fused_pallas.py:193", fused_bwd["cases"],
             fused_head, ssd240_train)):
        entries.append(_entry(name, replaces, st_cases,
                              launches["launches"][name], head,
                              next(c for c in st_cases if head(c))["bound"]))
    # the walks', Y_diag's and the mixer's passes: what the card grants
    # each, and the split of the reported case's time; the forwards' time
    # with Ssave (the call training runs) beside its bound
    for name, head, w_cases in (("ssd_fused_dirs_fwd", ssd_head, ssd_cases),
                                ("ssd_fused_fwd", fused_head, fused_cases),
                                ("ssd_fused_dirs_bwd", ssd_head,
                                 ssd_bwd["cases"]),
                                ("ssd_fused_bwd", fused_head,
                                 fused_bwd["cases"]),
                                ("ssd_ydiag_fwd", st_head, yd_cases),
                                ("ssd_ydiag_bwd", st_head, yd_bwd["cases"])):
        c = next(c for c in w_cases if head(c))
        e = next(e for e in entries if e["name"] == name)
        e.update(passes=_ssd_passes(name), hmma=_ssd_mma(name),
                 split_ms=c.get("split"))
        if "save_ms" in c:
            e.update(save_ms=c["save_ms"], save_bound_ms=c["save_bound"][0])
    for name, st_cases in (("stl_mixer_fwd", stl_cases),
                           ("stl_mixer_bwd", stl_bwd["cases"]),
                           ("stf_zgate_fwd", stf_cases),
                           ("stf_zgate_bwd", stf_bwd["cases"])):
        c = next(c for c in st_cases if st_head(c))
        next(e for e in entries if e["name"] == name).update(
            passes=_stl_passes(name), hmma=_stl_mma(name),
            split_ms=c.get("split"),
            **({"mufu_ms": c["mufu_ms"]} if "mufu_ms" in c else {}))
    # rows 5/5b at N 64 (gn 16): the d_state-16 models' stages 0-1 at
    # 224x224 in bf16, launches per training step of SSD16_FULL[0]
    steps16 = ssd16[SSD16_FULL[0]]["train"]["launches"]
    for name, k_cases in (("ssd_fused_dirs_fwd", ssd_cases),
                          ("ssd_fused_dirs_bwd", ssd_bwd["cases"])):
        e = next(e for e in entries if e["name"] == name)
        n64 = dict(model=SSD16_FULL[0],
                   launches_per_train_step=steps16[name] // STEPS)
        for i, (L, l, H4, d_ssm, gn) in enumerate(SSD16_STAGES):
            c = next(c for c in k_cases if c["L"] == L and c["N"] == 4 * gn
                     and c["dtype"] == "bf16")
            n64[f"stage{i}"] = dict(
                shape=dict(B=BATCH, L=L, l=l, H4=H4, P=SSD_P, N=4 * gn),
                ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
                bound_by=c["bound"][1], max_abs_err=max(
                    x["max_abs_err"] for x in k_cases if x["N"] == 4 * gn),
                **({"save_ms": c["save_ms"],
                    "save_bound_ms": c["save_bound"][0]}
                   if "save_ms" in c else {}))
        e["n64"] = n64
    # rows 1-2 at K 4: FusionMamba's launches per train step, and its
    # stage-0 shape (G 8, L / 4 1024, Dm 192) in fp32 (the CLI's default)
    # and bf16
    for e, k_cases in ((entries[0], cases), (entries[1], bwd["cases"])):
        e["fusionmamba"] = dict(
            launches_per_train_step=fm["launches_per_step"][e["name"]],
            K=4, size=FUSION_SIZE, batch=FUSION_BATCH)
        for c in k_cases:
            if c["K"] == 4 and (c["L"], c["Dm"]) == FM_STAGES[0]:
                e["fusionmamba"][c["dtype"]] = dict(
                    shape=dict(G=c["G"], L=c["L"], Dm=c["Dm"], N=N),
                    ms=c["ms"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound"][0], bound_by=c["bound"][1],
                    max_abs_err=c["max_abs_err"])
    # rows 5/5b and 7/7b: launches per train step of each CrossMamba model
    for name in ("ssd_fused_dirs_fwd", "ssd_fused_dirs_bwd", "ssd_ydiag_fwd",
                 "ssd_ydiag_bwd"):
        next(e for e in entries if e["name"] == name)["crossmamba"] = {
            m: dict(launches_per_train_step=r["launches_per_step"][name],
                    size=FUSION_SIZE if m.startswith("vfefm") else SIZE,
                    batch=FUSION_BATCH if m.startswith("vfefm")
                    else CROSS_BATCH)
            for m, r in cross.items() if r["launches_per_step"].get(name)}
    # the evaluation tools' launches: per grad_cam call (all four stages,
    # b8 fp32) and per forward of each loaded export (b8 bf16)
    for e in entries:
        tools = {f"grad_cam {m}": r["launches"][e["name"]]
                 for m, r in cam["runs"].items()
                 if e["name"] in r["launches"]}
        tools.update({f"export {m}": r["launches"][e["name"]]
                      for m, r in exported.items()
                      if e["name"] in r["launches"]})
        if tools:
            e["eval_tools"] = tools
    # rows 1-2 under DP (a rank's launches in one step) and SP (a rank's
    # launches in one medmamba step, by state flag, and the passes' ms);
    # rows 7/7b under SP (medssd's stage-0 shards)
    for e, key in ((entries[0], "selective_scan_fwd"),
                   (entries[1], "selective_scan_bwd")):
        flags = {k: v for k, v in sp["medmamba"]["flags"].items()
                 if k.startswith(key[-3:])}
        e["dp"] = dict(ranks=DP_RANKS, model="medmamba", size=SIZE,
                       batch=DP_BATCH,
                       launches_per_rank_step=dp["launches_per_rank"][key])
        e["sp"] = dict(ranks=SP_RANKS, model="medmamba", size=SP_SIZE,
                       batch=GRAD_BATCH, launches_per_rank_step=sp[
                           "medmamba"]["launches_per_rank"][key],
                       by_flag=flags, passes_ms={
                           k: v for k, v in sp["passes"].items()
                           if key[-3:] in k})
    for name in ("ssd_ydiag_fwd", "ssd_ydiag_bwd"):
        next(e for e in entries if e["name"] == name)["sp"] = dict(
            ranks=SP_RANKS, model="medssd", size=SP_SIZE, batch=GRAD_BATCH,
            launches_per_rank_step=sp["medssd"]["launches_per_rank"][name])
    # under TP: a rank's launches in one train step of each model, and the
    # times at a rank's shapes (rows 1-2, 5/5b, 6/6b)
    for e in entries:
        per = {m: r["launches_per_rank"][e["name"]]
               for m, r in tp["models"].items()
               if r["launches_per_rank"].get(e["name"])}
        shapes = [dict(shape=c["shape"], dtype=c["dtype"],
                       per_rank=c["per_rank"], ms=c["ms"],
                       plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
                       bound_by=c["bound"][1], max_abs_err=c["max_abs_err"])
                  for c in tp["kernels"] if c["kernel"] == e["name"]]
        if per or shapes:
            e["tp"] = dict(ranks=TP_RANKS, size=SIZE, batch=TP_BATCH,
                           launches_per_rank_step=per, shapes=shapes)
    # the bench's kernels: launches in its --t-cap 50 and --calibrate runs;
    # times and bounds at its stage 0 in bf16 (v1 at T 50; the calibration
    # in the bench's default fp32 compute, bf16 compute beside it)
    calib_head = lambda c: c["stage"] == "0" and c["compute"] == "fp32"
    bench_launches = {k: bench["runs"][run]["launches"][k] for run, k in (
        ("t-cap 50", "selective_scan_v1_fwd"),
        ("t-cap 50", "selective_scan_v1_bwd"), ("calibrate", "scan_calib"))}
    for name, replaces, k_cases, head in (
            ("selective_scan_v1_fwd", "selective_scan_pallas.py:100",
             v1_cases, _v1_head),
            ("selective_scan_v1_bwd", "selective_scan_pallas_bwd.py:52",
             v1_bwd["cases"], _v1_head),
            ("scan_calib", "scripts/kernel_bench.py:134", calib_cases,
             calib_head)):
        entries.append(_entry(name, replaces, k_cases, bench_launches[name],
                              head, next(c for c in k_cases
                                         if head(c))["bound"]))
    cmp = bench["compare"]
    for e, own, other, k_cases in ((entries[-3], "row3", "row1", v1_cases),
                                   (entries[-2], "row4", "row2",
                                    v1_bwd["cases"])):
        e.update(passes=_v1_passes(e["name"]), split_ms=next(
            c for c in k_cases if _v1_head(c)).get("split"))
        e["per"] = "bench call (--stage all --t-cap 50 --iters 3)"
        e["vs_" + other] = dict(shape=cmp["shape"], ms=cmp["ms"][own],
                                other_ms=cmp["ms"][other],
                                other_bound_ms=cmp["bound_" + other][0])
    c0 = next(c for c in calib_cases if calib_head(c))
    entries[-1].update(per="bench call (--stage all --calibrate --iters "
                       f"{CALIB_BENCH_ITERS})", twin_err=c0["twin_err"],
                       passes=c0["pass"], split_ms=c0.get("split"),
                       exps=c0["exps"], mufu_ms=c0["mufu_ms"],
                       bf16_compute_ms=next(
                           c["ms"] for c in calib_cases
                           if c["stage"] == "0" and c["compute"] == "bf16"))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, bwd=bwd,
                           ssd_cases=ssd_cases, ssd_bwd=ssd_bwd,
                           ydiag_cases=yd_cases, stl_cases=stl_cases,
                           stf_cases=stf_cases, ydiag_bwd=yd_bwd,
                           stl_bwd=stl_bwd, stf_bwd=stf_bwd,
                           fused_cases=fused_cases, fused_bwd=fused_bwd,
                           full_model=full, train=train,
                           medssd_eval=ssd_full, medssd_train=ssd_train,
                           st_ssd_eval=st_full, st_ssd_train=st_train,
                           medssd240_eval=ssd240_full,
                           medssd240_train=ssd240_train,
                           flag_cases=flag_cases, flag_bwd=flag_bwd,
                           lm_scoring=lm, lm_generate=lm_gen,
                           v1_cases=v1_cases, v1_bwd=v1_bwd,
                           calib_cases=calib_cases, kernel_bench=bench,
                           ssd16_paths=ssd16_paths, ssd16_models=ssd16,
                           crossmamba=cross, fusionmamba=fm,
                           all_index=all_index, grad_cam=cam,
                           export=exported, dp=dp, sp=sp, tp=tp,
                           profile=profiled, phase_seconds=seconds),
                      f, indent=1)
    print(f"phase seconds (wall, each phase with its checks): {seconds}",
          flush=True)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
