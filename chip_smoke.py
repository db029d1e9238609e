#!/usr/bin/env python3
"""Drive the PyTorch port (adaptpoint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object a line:

1. ``env``: the card (nvidia-smi name and power limit), torch and CUDA versions.
2. ``build``: the CUDA sources of ``adaptpoint_tpu_torch/ops/csrc``
   compiled in parallel (one nvcc each), with the time it took.
3. ``kernel``: each kernel against its plain PyTorch version on the card at the
   shapes the B=32 PointNeXt-S forward, train step and adversarial step give it
   (FPS 1024 -> 512, 2048 -> 1200 and 2048 -> 1024, each timed with ns a step,
   and at seven edges: B = 1, N = 1000 and 4097 with npoint = N, npoint = 1,
   half the points at the origin, N = 300, N = 16384; the four SA stages at
   N=1024 for ball-group forward, backward and fused SA, the ball group's
   forward and backward also at seven edges (M off the tile, N % 4 with
   K = 33 and C = 3, N too large to stage, K = 1 with C = 0, K = 128, C
   wider than a span buffer, misaligned features), the host's copies of
   their shared memory against the kernels' at the stages and edges, and
   ``ops.ball_group``'s launches each way; the max-pooled ball
   group forward and backward at the augmentor's four grouper shapes and on a
   cloud with ties and an empty ball, each with f32 and with bf16 features,
   the host's copies of their shared memory against the kernel's at those
   shapes and at their launch shapes' edges, and the op's launches on bf16
   features (one forward kernel, one backward kernel, no cast); the fused SA and the differentiable fused SA forward and
   backward at the N=2048 stages of a ``gan_step``, the backward also at six
   shapes off them (odd C, K = 8, K = 48, C = 512, and where GH does not fit
   whole, (256, 512, 512) at K = 48 and (512, 1024, 1024) at K = 64, 128
   centers, with and without the weight gradients), the forward at five edges
   of its tiling (K = 8, 24, 48, 128, C = 35, a ragged last tile, B = 1,
   empty balls, tied maxima), the host's copy of the forward's shared memory
   against the kernel's at every stage and edge; the row gather and its
   scatter-add at the resampling shape, a feature shape and every gather of a
   ``gan_step``; the kNN at the five shapes of a ``gan_step``, beside the
   stand-in ``torch.topk(torch.cdist(q, x))``, and at twelve edges (C = 35,
   k = 32, ragged query counts, B = 1, ties, k > N, both variants); the flash
   attention forward and backward, directly and through autograd, for bf16 and
   f32 inputs, at (128, 2048, 16) and at every head dim across the tiles' edges
   (N = 1, 40, 127, 128, 129, 2047), two backward runs bit for bit equal, timed
   at (128, 2048, 16) for both input types beside
   ``scaled_dot_product_attention`` (``--phases attention`` runs this part
   alone); the 3-NN weighted gather forward and backward at the four
   feature-propagation levels of a bf16 ``gan_step``, with repeated neighbours
   and on a cloud with half its points at the origin), with errors, tolerances,
   bounds and CUDA-event times; for FPS, the kNN, the differentiable fused SA
   backward (per stage) and the row gather and its scatter-add (per shape, beside
   ``torch.gather`` and ``index_add_``) also the card's time of the call alone
   from the profiler and the host's enqueue time a call.
4. ``serve``: full-width ``cfgs/scanobjectnn/pointnext-s.yaml`` with seeded
   weights, exported unfused and fused at buckets 1,8,32 and served by the
   port's HTTP server; /predict with n = 1, 8, 32, 40 must match the same
   model's forward on a CPU copy, and the launch counters must show 1 FPS +
   4 ball-group (unfused) or 1 FPS + 4 fused-SA (fused) launches a forward.
5. ``throughput``: clouds/s and ms per B=32 forward on both routes.
6. ``train``: full-width PointNeXt-S classifier training through
   ``build_train_tools`` / ``make_train_step`` / ``train_one_epoch`` /
   ``validate`` on seeded (32, 2048, 4) batches: the first step against the
   same step on a CPU copy, the launches a step makes, a fixed batch's loss
   over 30 steps, the gradient through ``ops.fps``, and ms per step with
   the profiler's device-busy time.
7. ``train_fused``: the same train step on the fused train-BN route
   (``make_train_step(..., fused_train_bn=True)``, what
   ``ADAPTPOINT_TPU_TRAIN_FUSED=1`` selects): its first step against the
   unfused step from the same weights, batch and draws, the launches a step
   makes (FPS 2, row gather 1, each of the four train-BN passes 4, no ball
   group), eight more steps, each pass against its plain version at the four
   stages the step handed it (its own FPS picks) and at TRAINBN_EDGES (every
   forced tile too), rows 16 and 17 launched twice for the same bits, the
   device ops of each pass's call (TRAINBN_OPS), the unfused stage's
   composite time, and ms per step on both routes in turns.
8. ``cli``: ``python -m adaptpoint_tpu_torch.main --cfg
   cfgs/scanobjectnn/pointnext-s.yaml`` in a child process on SyntheticCls
   (2048 points, 15 classes) for two epochs under
   ``ADAPTPOINT_TPU_TRAIN_FUSED=1``: the run directory's files, a finite
   test OA, the child's launch counts, then ``mode=test`` on its best
   checkpoint printing the same OA.
9. ``adapt``: phase A of the AdaptPoint protocol at full width
   (``cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml``, ``gan_precision:
   f32``) through ``build_gan`` / ``make_gan_step`` / ``train_gan_epoch``: the
   first ``gan_step`` against
   the same step through the plain versions on the card and on a float64 CPU
   copy routed the same way (draws free of near-ties; the copy
   differentiated at the card's fake clouds), the fake clouds' invariants,
   ten more steps, the launches a step makes (max-pooled ball group and
   differentiable fused SA 4 + 4 each, fused SA 4, no plain ball group), the
   epoch loop and three classifier train steps on the fake dataset it
   returns, and ms per step with the profiler's device-busy time.
10. ``adapt_bf16``: the same under ``gan_precision: bf16``, the card's
   default: the first step from the same weights and draws against the same
   step through the plain versions on the card under the same policy (with
   and without the feedback term), its clouds and metrics against the f32
   step's, ten more steps, the launches a step makes (the weighted gather
   4 + 4, and four row gathers and four scatter-adds fewer than in f32),
   the step run twice from the same state, draws and batches for ten steps
   (where the two runs first part, and the first kernel call whose outputs
   part on equal inputs; reported, not held), the epoch loop, and ms per
   step beside the f32 step's.
11. ``window``: the windowed max-pooled ball group (``ops.ball_group_max_
   windowed``, rows 20, 21), which no model calls, as
   ``scripts/check_window.py`` drives its JAX twin: B=32, K=24, the
   augmentor's four grouper shapes on clouds centred and normalised to the
   unit sphere. Per stage the width, ``ok`` and the width the data needs;
   both kernels against their plain versions (forward exact, backward
   within the reordering bound), and where ``ok`` the forward against row
   7's kernel (outputs, winning slots and slots equal), at the needed width
   too where ``ok`` is False; CUDA-event times of the kernels, of
   ``window_prep``, of the four un-permute gathers the JAX op makes, and of
   the op forward and forward+backward beside row 7/8's op.
12. ``adapt_cli``: ``python -m adaptpoint_tpu_torch.main --cfg
   cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml`` (``mode: adaptpoint``)
   in a child process on SyntheticCls at the ``cli`` phase's sizes for
   three epochs at the card's defaults: phase A and phase B each epoch
   (every full batch of the 960 fake clouds), fake clouds that moved from
   the real ones, ``model_gan.pth`` reloading into a fresh ``build_gan`` bit
   for bit, the skipped ScanObjectNN-C sweep logged, a best val OA of at
   least ADAPT_CLI_MIN_OA, and the child's launch counts (rows 1-15).

Then the card's name and power limit as nvidia-smi prints them, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}`` as the
last line. Any failed phase raises and the exit code is not 0. Without a
CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and op/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12  # dense; f32-grade work on it takes 3 products (3xTF32)

B, N0, K = 32, 1024, 32
# PointNeXt-S SA stages at N=1024: (N -> M, C in, mid, C out, radius)
STAGES = [(1024, 512, 32, 32, 64, 0.15), (512, 256, 64, 64, 128, 0.225),
          (256, 128, 128, 128, 256, 0.3375), (128, 64, 256, 256, 512, 0.50625)]
TOL_SA = 2e-2  # fused SA: |kernel - plain| <= TOL_SA * (1 + |plain|)
# differentiable fused SA backward, relative 2-norm of each gradient: on the
# kernel's own neighbours and winners (the recompute's sums in another order
# flip single bf16 roundings), and end to end, each side on its own winners
# (a near-tie of two distinct rows may pick another slot)
TOL_SA_BWD, TOL_SA_E2E = 1e-3, 5e-2
# row 6's grouped layout against GH whole on the same inputs (forced where GH
# fits), the largest relative 2-norm over the gradients: the same sums in the
# same order, only the atomic adds land in another order (the readings, in
# this script's output and PERF.md, sit orders of magnitude below); the ReLU
# masks are equal bit for bit
TOL_GROUPED = 1e-5
TOL_UNFUSED = (1e-3, 1e-4)  # (rtol, atol) serve logits, f32 route vs CPU
EPS32 = 2.0 ** -23  # f32 machine epsilon
# train phase: batches of (B, N_TRAIN, 4) resampled FPS N_TRAIN -> N_FPS, then
# a random N0 of those; labels in [0, CLASSES)
N_TRAIN, N_FPS, CLASSES, TRAIN_BATCHES, FIT_STEPS = 2048, 1200, 15, 8, 30
# first train step, card against the CPU copy: (rtol, atol)
# The first train step on the card (kernels) against two references; see
# compare() in phase_train. loss: relative; logits, buffers: (rtol, atol);
# grad_l2: each gradient tensor's relative 2-norm error; share: of each
# parameter tensor's entries within TOL_STEP_PARAMS + adam_slack.
# Against the plain versions on the card only the kernels differ: the
# scatter-adds' order. Against the float64 CPU copy the card's whole f32
# arithmetic differs: this network's backward loses digits in f32 (max-pool
# ties, batch statistics over 32 head rows), and the card's worst gradient
# tensor sits a relative 4.5e-3 from the float64 one.
TOL_STEP_PLAIN = {"loss": 1e-6, "logits": (1e-5, 1e-5), "grad_l2": 1e-4,
                  "buffers": (1e-5, 1e-6), "share": 0.98}
TOL_STEP_CPU = {"loss": 1e-5, "logits": (1e-4, 1e-4), "grad_l2": 2e-2,
                "buffers": (1e-4, 1e-6), "share": 0.9}
TOL_STEP_PARAMS = (1e-4, 1e-6)
# The first gan_step on the card against the same two references; see
# compare() and three_ways() in phase_adapt. The step's gumbel noise is first
# moved off every near-tie of the hard keep/drop choice (MASK_MARGIN), so all
# three steps make the same choices: mask_flips is the number of points that
# may still differ; gen: the clouds; metrics: relative; the rest as above.
# The references take the kernel run's other discrete choices (FPS picks,
# which way each grouper value's bf16 rounding fell, the max-pool winners;
# the float64 copy also its fake clouds), and OWN_CHOICES bounds the share of
# those the reference would have made otherwise. First without the feedback
# term (the generator's gradient through the augmentor alone), against the
# plain versions on the card only, held on every tensor:
MASK_MARGIN = 0.05
# grad_l2: each gradient tensor; grad_l2_whole: a network's whole gradient.
TOL_GAN_PLAIN = {"mask_flips": 0, "gen": 1e-4, "metrics": 2e-3,
                 "grad_l2": {"G": 5e-2, "D": 1e-2},
                 "grad_l2_whole": {"G": 5e-3, "D": 1e-3},
                 "buffers": (1e-3, 1e-4), "share": {"G": 0.95, "D": 0.95}}
# Then the step itself. The feedback term differentiates the frozen
# classifier through the fused SA backward, whose bf16 roundings (g_o, g_h,
# g_v, each rounded where the TPU kernel rounds it; the centers' dp sums
# unrounded against rounded neighbour terms) fall another way wherever two
# implementations' f32 sums differ in the last bits: on the CPU at B=8
# (scripts/torch_feedback_grad_sensitivity.py) the f32 and the float64
# step's generator gradients sit 9.6 % apart in 2-norm even with every
# discrete choice shared (3.5e-3 without the feedback term), and the
# classifier's input gradient alone 14-16 % (3.6e-3 on its unfused route).
# So there the generator's gradient is held as a whole (readings on the H100:
# 0.105 against the plain versions, 0.180 against float64, where the plain
# versions themselves sit 0.165), and against float64 no further from it
# than the plain versions are (FEEDBACK_NOISE times theirs); not tensor by
# tensor. The feedback term carries 0.99 of that gradient's norm here: a
# fused SA backward that dropped its gradient (a mutated copy) reads 0.992
# against the plain versions. The discriminator is held as above.
TOL_GAN_PLAIN_FEEDBACK = dict(TOL_GAN_PLAIN, grad_l2={"D": 1e-2},
                              grad_l2_whole={"G": 0.2, "D": 1e-3},
                              share={"D": 0.95})
TOL_GAN_CPU_FEEDBACK = {"mask_flips": 0, "gen": 1e-3, "metrics": 2e-2,
                        "grad_l2": {"D": 5e-2},
                        "grad_l2_whole": {"G": 0.3, "D": 1e-2},
                        "buffers": (1e-3, 1e-4), "share": {"D": 0.8}}
FEEDBACK_NOISE = 1.5
# the largest share of a reference's own discrete choices that may differ
# from the kernel run's (readings on the H100 in brackets, of 50.3M rounded
# grouper values, 33.6M grouper winners, 8.4M fused-SA winners, 65536 FPS
# picks): the plain versions on the card round and pick as the kernels do
# (0, 0) but for near-ties between distinct rows in the fused SA (3024);
# float64 rounds 4779 values and picks 15 grouper and 7306 fused-SA winners
# otherwise, and the same FPS points (0)
OWN_CHOICES = {"plain": {"grouper_values": 0.0, "grouper_winners": 0.0,
                         "fused_sa_winners": 1e-3},
               "float64": {"grouper_values": 3e-4, "grouper_winners": 2e-6,
                           "fused_sa_winners": 3e-3, "fps_picks": 0.0}}
# The first bf16 gan_step (gan_precision: bf16) against the same step through
# the plain versions on the card under the same policy, with the kernel
# run's discrete choices; no float64 copy. Both run the policy's bf16 convs
# and BatchNorms through the same PyTorch calls: they differ only where a
# kernel's sums run in another order than its plain version's (attention,
# the backward scatters, the fused SA backward), and a bf16 rounding after
# such a sum may fall the other way. The discriminator is held tensor by
# tensor, the generator as a whole (its near-zero tensors, a beta or bias
# that a BatchNorm removes, are bf16 noise: 0.32 of its own norm in the
# grouper's beta against 9.1e-3 for the whole). Readings on the H100 in
# brackets: without the feedback term G 9.1e-3, D 0, metrics 3.6e-4, clouds
# 0, BN statistics 3.1e-6.
TOL_GAN16_PLAIN = {"mask_flips": 0, "gen": 1e-4, "metrics": 1e-3,
                   "grad_l2": {"D": 1e-2},
                   "grad_l2_whole": {"G": 2e-2, "D": 1e-3},
                   "buffers": (1e-3, 1e-4), "share": {"D": 0.95}}
# with the feedback term, the fused SA backward's bf16 roundings reach the
# generator through the mask's straight-through gumbel, as in f32 (reading
# 0.218; f32 0.105)
TOL_GAN16_PLAIN_FEEDBACK = dict(TOL_GAN16_PLAIN,
                                grad_l2_whole={"G": 0.4, "D": 1e-3})
OWN_CHOICES_BF16 = {"plain": {"grouper_values": 0.0, "grouper_winners": 0.0,
                              "fused_sa_winners": 1e-3}}
# the bf16 step against the f32 step from the same weights and draws, in
# brackets the readings on the H100: the points whose keep/drop choice
# differs (the policies' mask logits fall on opposite sides of the noise for
# 1371 of 65536 points before the draws are moved, 621-629 after; held at
# 2 %), the clouds on the points both keep (1.6e-2-2.0e-2: the R/S/T logits
# are bf16-rounded, the rotations reach 10 degrees) and the six metrics,
# relative (4.0e-4-1.1e-2, loss_fake: the fake clouds differ)
TOL_BF16_VS_F32 = {"mask_flips": 1310, "gen": 4e-2, "metrics": 3e-2}
# ... and at least this far from it on the mask and the clouds: a step that
# stayed f32 under the bf16 label would read 0 on each. The metrics get no
# floor: six scalar losses over the batch, they came within 4.0e-4 of f32's
# in one run and 1.1e-2 in another.
FLOOR_BF16_VS_F32 = {"mask_flips": 100, "gen": 1e-3}
# the policy's sites in the first bf16 step's kernel run and the one type
# each must give (``policy_outputs``)
POLICY_OUTPUTS = {("G", "BatchNorm"): "bfloat16",
                  ("D", "SpectralNormLinear"): "bfloat16",
                  ("C", "ConvBlock"): "bfloat16",
                  ("C", "ConvBlock(policy=False)"): "float32"}
# serve requests keep pool clouds whose CPU logits' top-2 gap is >= MARGIN
POOL, MARGIN = 256, 0.05
DEV = "cuda"
# the kernels each path must launch at least once in its own run
PATH_KERNELS = {
    "serve": ("fps", "ball_group", "sa_eval"),
    "train": ("fps", "ball_group", "ball_group_bwd", "sa_eval", "gather_rows",
              "gather_rows_bwd"),
    "adapt": ("fps", "ball_group_max", "ball_group_max_bwd", "sa_eval",
              "sa_train", "sa_train_bwd", "gather_rows", "gather_rows_bwd",
              "mha", "mha_bwd", "knn"),
    "adapt_bf16": ("fps", "ball_group_max", "ball_group_max_bwd", "sa_eval",
                   "sa_train", "sa_train_bwd", "gather_rows",
                   "gather_rows_bwd", "mha", "mha_bwd", "knn", "fpinterp",
                   "fpinterp_bwd"),
    "train_fused": ("fps", "gather_rows", "sa_trainbn_stats",
                    "sa_trainbn_fwd", "sa_trainbn_bwd_w2", "sa_trainbn_bwd_x"),
    "cli": ("fps", "gather_rows", "ball_group", "sa_trainbn_stats",
            "sa_trainbn_fwd", "sa_trainbn_bwd_w2", "sa_trainbn_bwd_x"),
    "window": ("ball_group_max_windowed", "ball_group_max_windowed_bwd"),
    "adapt_cli": ("fps", "ball_group", "sa_eval", "ball_group_bwd",
                  "sa_train", "sa_train_bwd", "ball_group_max",
                  "ball_group_max_bwd", "mha", "mha_bwd", "knn", "fpinterp",
                  "fpinterp_bwd", "gather_rows", "gather_rows_bwd")}
# names of the hand-written kernels as the profiler prints them
OWN_KERNELS = ("fps_kernel", "ball_group_kernel", "ball_group_bwd_kernel",
               "ball_group_max_kernel", "ball_group_max_bwd_kernel",
               "sa_eval_kernel", "sa_train_bwd_kernel", "gather_rows_kernel",
               "gather_rows_bwd_kernel", "gather_rows_bwd_l2red_kernel",
               "mha_cast_bf16_kernel", "mha_fwd_kernel",
               "mha_bwd_prep_kernel", "mha_bwd_kernel",
               "mha_dq_reduce_kernel", "knn_thread_kernel", "knn_warp_kernel",
               "fpinterp_fwd_kernel", "fpinterp_bwd_scatter_kernel",
               "fpinterp_bwd_staged_kernel", "fpinterp_bwd_dw_kernel")
# adapt phase: the augmentor's four groupers at N=2048: (N -> M, C, radius),
# K_GAN neighbours (the max-pooled ball group); the mask head's attention
# (BH, N, d)
N_GAN, K_GAN = 2048, 24
GAN_STAGES = [(2048, 1024, 128, 0.1), (1024, 512, 256, 0.2),
              (512, 256, 512, 0.4), (256, 128, 1024, 0.8)]
MHA_SHAPE, MHA_SCALE = (128, 2048, 16), 4.0
TOL_MHA = 2e-3  # attention: |kernel - plain| <= TOL_MHA * (1 + |plain|)
# exp results a second: 16 a clock on each of 132 SMs (NVIDIA's table of
# arithmetic-instruction throughput for compute capability 9.0) at 1.98 GHz,
# the clock PEAK_F32 = 132 * 128 * 2 * 1.98e9 stands for
PEAK_EXP = 132 * 16 * 1.98e9
# the frozen classifier's SA stages in a gan_step, where clouds keep all
# N_GAN points: (N -> M, C in, mid, C out, radius). The real pass (fused SA)
# sees the batch's clouds, the fake pass (the differentiable fused SA,
# forward and backward) the augmentor's, FAKE_DROPPED of whose points sit
# exactly at the origin.
GAN_CLS_STAGES = [(2048, 1024, 32, 32, 64, 0.15),
                  (1024, 512, 64, 64, 128, 0.225),
                  (512, 256, 128, 128, 256, 0.3375),
                  (256, 128, 256, 256, 512, 0.50625)]
FAKE_DROPPED = 0.5
# the fused train-BN stage (rows 16-19): per pass, |kernel - plain| <=
# TOL_TRAINBN[pass] * max|plain| for each float output (both sum the same f32
# products in other orders: the kernel in row order from shared memory,
# the plain passes through cuBLAS; readings on the H100 were 1e-6-3e-6 of
# each tensor's scale); indices, new_xyz and fi exact; the winning slots
# exact but where the plain y2 of the two slots lie within the forward's
# tolerance of each other (a near-tie between distinct rows).
TOL_TRAINBN = {"stats": 2e-5, "fwd": 2e-5, "bwd_w2": 1e-4, "bwd_x": 1e-4}
# the fused train-BN stage at the shapes of its tiling's edges (rows 18 and
# 19 tile B*M*K rows, 128 / 64 / 32 a block, whatever K is): (B, N, M, C, mid,
# cout, K, radius, relative, normalize_dp, with g_fi and g_new)
TRAINBN_EDGES = [(2, 96, 24, 5, 33, 77, 24, 0.35, True, True, True),
                 (2, 64, 40, 0, 16, 24, 1, 0.3, True, False, False),
                 (1, 300, 3, 13, 40, 8, 255, 0.9, False, False, True),
                 (3, 128, 16, 64, 258, 72, 64, 0.5, True, True, True),
                 (2, 256, 64, 700, 8, 16, 8, 0.4, True, False, True)]
# the fused train step against the unfused one from the same weights, batch
# and draws is held to TOL_STEP_CPU, the band the unfused step on the card is
# held to against a float64 copy: both routes compute the same function in
# f32, and this network's gradient moves by ~1e-2 a tensor when the
# forward's roundings move max-pool winners and the head's 32-row batch
# statistics. Beside it, each tensor's distance is reported as a multiple
# of the unfused step's own spread when every train-mode BatchNorm takes
# flax's variance formula E[x^2] - E[x]^2 instead of two passes (the JAX
# package's test_trainbn_module_parity calibrates so, factor 8; on the
# H100 the fused statistics move the forward more than that formula does,
# and the worst gradient tensor read 12x), floored at TRAINBN_FLOOR of its
# kind's largest entry. Gradients are compared by relative 2-norm, each
# tensor's scale floored at a thousandth of the whole gradient's.
TRAINBN_FLOOR = 1e-5
# the CLI run: SyntheticCls at the scanobjectnn cfg's shapes, 30 steps an
# epoch. On the H100 the val OA read 8.4 / 91.0 / 100.0 after epochs 1-3 at
# this size (7.3 / 81.2 and 13.3 / 70.9 after epochs 1-2 in two other runs:
# the scatters' atomics make each run its own) and 6.9 / 6.6 / 6.6 / 17.8 /
# 71.3 after epochs 1-5 at 320 clouds, while the train OA (train-mode
# BatchNorm) rose from the first epoch: eval waits for the running
# statistics. The best checkpoint's test OA must reach CLI_MIN_OA, against
# 6.7 for a model that learned nothing.
CLI_SIZE, CLI_EPOCHS = 960, 3
CLI_MIN_OA = 50.0
# the adaptpoint CLI run: the same data, phase A + phase B each epoch; its
# best val OA must reach 3x chance on 15 classes
ADAPT_CLI_EPOCHS = 3
ADAPT_CLI_MIN_OA = 20.0


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_total_ms: float = 200.0) -> float:
    """Mean ms of ``fn()`` by CUDA events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(50, max(3, min_total_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_host(fn, reps: int = 10) -> dict:
    """The card's time for one call of ``fn`` alone (``torch.profiler``: all
    of the call's kernels and memsets, per call) and the host's enqueue time
    per call (a host clock around calls that do not wait for the card), each
    after a warm-up; beside ``cuda_ms``, whose eager loop can be host bound.
    A profile that recorded no device activity (it happens) is taken again,
    and the device time is None (not measured) if none of three did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    device = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            device = total / 1e3 / reps
            break
    t0 = time.perf_counter()
    for _ in range(5 * reps):
        fn()
    host = (time.perf_counter() - t0) / (5 * reps) * 1e6
    torch.cuda.synchronize()
    return {"device_ms": device, "host_us": host}


def stage_inputs(gen, stages=None, dropped: float = 0.0):
    """Per-stage (xyz, qidx, feats) as the B=32 forward gives them: the
    unit-sphere cloud (``dropped`` of its points moved to the origin, as the
    augmentor's learned dropout leaves them), FPS to half at stage 1, then
    FPS-ordered prefixes."""
    import torch
    from adaptpoint_tpu_torch import ops
    stages = STAGES if stages is None else stages
    xyz = torch.randn((B, stages[0][0], 3), generator=gen, device=DEV)
    xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    if dropped:
        xyz = xyz * (torch.rand(xyz.shape[:2], generator=gen, device=DEV)
                     >= dropped)[..., None]
    out = []
    for i, (n, m, c, _, _, _) in enumerate(stages):
        if i == 0:
            qidx = ops.fpsample.furthest_point_sample_cuda(xyz, m)
        else:
            qidx = ops.fps_prefix_idx(B, m, DEV).contiguous()
        feats = torch.randn((B, n, c), generator=gen, device=DEV)
        out.append((xyz.contiguous(), qidx, feats))
        xyz = ops.index_points(xyz, qidx)
    return out


def scanned_points(xyz, qidx, radius, K=K):
    """Support points the ball query must look at: up to the K-th in-ball
    point, or all N when the ball holds fewer."""
    import torch
    from adaptpoint_tpu_torch.ops.geometry import index_points, radius_sq
    q = index_points(xyz, qidx)
    d = q[:, :, None, :] - xyz[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    cum = torch.cumsum((d2 < radius_sq(radius)).int(), dim=-1)
    full = cum[..., -1] >= K
    kth = torch.argmax((cum >= K).int(), dim=-1) + 1
    return int(torch.where(full, kth, torch.full_like(kth, xyz.shape[1]))
               .sum())


def check_stages_forward(gen, stages, bg_inputs, sa_inputs):
    """The ball-group kernel on ``bg_inputs`` (``None``: not checked) and the
    fused SA kernel (folded weights at each stage's widths) on ``sa_inputs``,
    K neighbours, dp normalised as PointNeXt-S asks, each against its plain
    version. Returns their rows, summed over the stages."""
    import torch
    from adaptpoint_tpu_torch.ops import ballgroup, saeval

    bg = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0, t_b=0.0,
              t_o=0.0)
    sa = dict(bg)
    bg.update(stand_in_ms=0.0, device_ms=0.0, host_us=0.0)

    def add(acc, ms, plain_ms, t_b, t_o):
        """Sum one stage into a kernel's totals; returns the stage's row."""
        row = dict(ms=ms, plain_ms=plain_ms,
                   bound_ms=1e3 * max(t_b, t_o))
        for key in ("ms", "plain_ms", "bound_ms"):
            acc[key] += row[key]
        acc["t_b"] += t_b
        acc["t_o"] += t_o
        return row

    for i, (n, m, c, mid, cout, r) in enumerate(stages):
        bg_row = None
        if bg_inputs is not None:
            xyz, qidx, feats = bg_inputs[i]
            args = (r, K, xyz, qidx, feats, True, True)
            got = ballgroup.ball_group_cuda(*args)
            ref = ballgroup.ball_group_plain(*args)
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, ref)]
            emit("kernel", name="ball_group", stage=[B, n, m, c, K],
                 max_abs_err={"new_xyz": errs[0], "fi": errs[1],
                              "dpfj": errs[2], "idx": errs[3]},
                 tolerance="exact")
            if any(errs):
                raise AssertionError(f"ball-group kernel disagrees: {errs}")
            scanned = scanned_points(xyz, qidx, r)
            b_bytes = (B * n * 12 + B * n * c * 4 + B * m * 4 + B * m * 12
                       + B * m * c * 4 + B * K * m * (3 + c) * 4
                       + B * m * K * 4)
            b_ops = scanned * 9 + B * m * K * 6
            bg_row = add(bg, cuda_ms(lambda: ballgroup.ball_group_cuda(*args)),
                         cuda_ms(lambda: ballgroup.ball_group_plain(*args)),
                         b_bytes / PEAK_BYTES, b_ops / PEAK_F32)
            # a stand-in, not the same function: the neighbour rows of
            # [xyz || feats] by the kernel's idx, no ball query, no dp
            cat = torch.cat([xyz, feats], -1)
            rows_of = got[3].long().reshape(B, m * K, 1).expand(-1, -1, 3 + c)
            bg_row.update(stand_in_ms=cuda_ms(
                lambda: torch.gather(cat, 1, rows_of)),
                **device_host(lambda: ballgroup.ball_group_cuda(*args)),
                tiling=list(ballgroup.fwd_tiling(B, n, m, c, K)))
            for key in ("stand_in_ms", "device_ms", "host_us"):
                bg[key] = (None if bg[key] is None or bg_row[key] is None
                           else bg[key] + bg_row[key])
            del cat, rows_of

        xyz, qidx, feats = sa_inputs[i]
        scanned = scanned_points(xyz, qidx, r)
        w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) \
            / (3 + c) ** 0.5
        b1 = torch.randn((mid,), generator=gen, device=DEV) * 0.1
        w2 = torch.randn((mid, cout), generator=gen, device=DEV) \
            / mid ** 0.5
        b2 = torch.randn((cout,), generator=gen, device=DEV) * 0.1
        sargs = (r, K, xyz, qidx, feats, w1, b1, w2, b2, True, True)
        tiling = check_fwd_layout(K, saeval.pack_weights(w1, b1, w2, b2), n,
                                  B, m, f"stage {i + 1}")
        got = saeval.sa_eval_cuda(*sargs)
        ref = saeval.sa_eval_plain(*sargs)
        torch.cuda.synchronize()
        e_xyz = float((got[0] - ref[0]).abs().max())
        e_fi = float((got[1] - ref[1]).abs().max())
        diff = (got[2] - ref[2]).abs()
        e_out = float(diff.max())
        rel = float((diff / (1.0 + ref[2].abs())).max())
        emit("kernel", name="sa_eval", stage=[B, n, m, c, mid, cout, K],
             tiling=tiling,
             max_abs_err={"new_xyz": e_xyz, "fi": e_fi, "out": e_out},
             max_scaled_err=rel, out_absmax=float(ref[2].abs().max()),
             tolerance=f"new_xyz, fi exact; |out - plain| <= {TOL_SA} * "
                       f"(1 + |plain|)")
        if e_xyz or e_fi or rel > TOL_SA or not torch.isfinite(got[2]).all():
            raise AssertionError(f"fused SA kernel disagrees: xyz {e_xyz} "
                                 f"fi {e_fi} out {e_out} scaled {rel}")
        s_bytes = (B * n * 12 + B * n * c * 4 + B * m * 4
                   + ((3 + c) * mid + mid * cout) * 2 + (mid + cout) * 4
                   + B * m * 12 + B * m * c * 4 + B * m * cout * 4)
        s_flops = 2 * B * m * K * ((3 + c) * mid + mid * cout)
        sa_row = add(sa, cuda_ms(lambda: saeval.sa_eval_cuda(*sargs)),
                     cuda_ms(lambda: saeval.sa_eval_plain(*sargs)),
                     s_bytes / PEAK_BYTES,
                     s_flops / PEAK_BF16 + scanned * 9 / PEAK_F32)
        sa["max_abs_err"] = max(sa["max_abs_err"], e_out)
        emit("stage_times", stage=i + 1, shape=[B, n, m, c, mid, cout, K],
             ball_group=bg_row, sa_eval=sa_row)
    for acc in (bg, sa):
        acc["bound_by"] = "bytes" if acc.pop("t_b") > acc.pop("t_o") \
            else "operations"
    return bg, sa


def check_bg_backward(gen, tag, r, k, xyz, qidx, feats) -> dict:
    """The ball-group backward kernel at one shape (k neighbours, relative,
    dp normalised) against its plain version within
    ``ball_group_bwd_bound``: called directly with all three cotangents and
    with ``g_new`` and ``g_fi`` absent; through autograd with a strided
    ``g_dpfj``, with only ``feats`` and with only ``xyz`` asking for a
    gradient. Returns the direct call's arguments and the errors."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import ballgroup

    b, n, c = feats.shape
    m = qidx.shape[1]
    idx = ballgroup.ball_group_cuda(r, k, xyz, qidx, feats, True, True)[3]
    g_new = torch.randn((b, m, 3), generator=gen, device=DEV)
    g_fi = torch.randn((b, m, c), generator=gen, device=DEV)
    g_dpfj = torch.randn((b, k, m, 3 + c), generator=gen, device=DEV)
    args = (r, idx, qidx, g_new, g_fi, g_dpfj, n, True, True)
    got = ballgroup.ball_group_bwd_cuda(*args)
    ref = ballgroup.ball_group_bwd_plain(*args)
    bounds = ball_group_bwd_bound(r, idx, qidx, g_new, g_fi, g_dpfj, n)
    only = ballgroup.ball_group_bwd_cuda(r, idx, qidx, None, None, g_dpfj, n,
                                         True, True)
    only_ref = ballgroup.ball_group_bwd_plain(r, idx, qidx, None, None,
                                              g_dpfj, n, True, True)
    zero3, zero = torch.zeros_like(g_new), torch.zeros_like(g_fi)
    only_bounds = ball_group_bwd_bound(r, idx, qidx, zero3, zero, g_dpfj, n)
    # through autograd, with a strided g_dpfj and new_xyz left unused
    x_req = xyz.clone().requires_grad_()
    f_req = feats.clone().requires_grad_()
    out = ops.ball_group(r, k, x_req, qidx, f_req, True, True)
    strided = g_dpfj.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    auto = torch.autograd.grad(out[:3], (x_req, f_req),
                               (g_new, g_fi, strided))
    f_only = torch.autograd.grad(
        ops.ball_group(r, k, xyz, qidx, f_req, True, True)[1:3], f_req,
        (g_fi, g_dpfj))[0]
    out = ops.ball_group(r, k, x_req, qidx, feats, True, True)
    x_only = torch.autograd.grad((out[0], out[2]), x_req, (g_new, g_dpfj))[0]
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, a, b_, bound in (("g_xyz", got[0], ref[0], bounds[0]),
                               ("g_feats", got[1], ref[1], bounds[1]),
                               ("absent_g_new_g_fi_xyz", only[0],
                                only_ref[0], only_bounds[0]),
                               ("absent_g_new_g_fi_feats", only[1],
                                only_ref[1], only_bounds[1]),
                               ("autograd_g_xyz", auto[0], ref[0],
                                bounds[0]),
                               ("autograd_g_feats", auto[1], ref[1],
                                bounds[1]),
                               ("autograd_feats_only", f_only, ref[1],
                                bounds[1]),
                               ("autograd_xyz_only", x_only, ref[0],
                                bounds[0])):
        d = (a - b_).abs()
        errs[name] = float(d.max()) if d.numel() else 0.0
        ok = ok and bool((d <= bound).all()) and bool(
            torch.isfinite(a).all())
    emit("kernel", name="ball_group_bwd", case=tag, stage=[b, n, m, c, k],
         max_abs_err=errs, out_absmax=float(ref[1].abs().max())
         if ref[1].numel() else 0.0,
         bound_max=[float(b_.max()) if b_.numel() else 0.0
                    for b_ in bounds],
         tolerance="|kernel - plain| <= n * 2^-23 * sum|addend| per "
                   "element (n addends meet there; atomic adds land in "
                   "no fixed order)")
    if not ok:
        raise AssertionError(f"ball-group backward disagrees ({tag}): "
                             f"{errs}")
    return dict(args=args, errs=errs)


def check_stages_backward(gen, stages, inputs):
    """The ball-group backward kernel at ``stages`` (K neighbours, relative,
    dp normalised), directly and through autograd, against its plain version
    (``check_bg_backward``). Returns its row, summed over the stages."""
    import torch
    from adaptpoint_tpu_torch.ops import ballgroup

    bwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0,
               stand_in_ms=0.0, device_ms=0.0, host_us=0.0)
    for i, ((n, m, c, _, _, r), (xyz, qidx, feats)) in enumerate(
            zip(stages, inputs)):
        got = check_bg_backward(gen, f"stage {i + 1}", r, K, xyz, qidx, feats)
        args, errs = got["args"], got["errs"]
        idx, g_dpfj = args[1], args[5]
        b_bytes = (B * m * K * 4 + B * m * 4 + B * m * 12 + B * m * c * 4
                   + B * K * m * (3 + c) * 4 + B * n * (3 + c) * 4)
        b_ops = B * K * m * (3 + c) + B * K * m * 6 + B * m * (3 + c)
        # a stand-in, not the same function: index_add_ of g_dpfj's feature
        # columns onto zeros (no dp columns, no centers' terms)
        flat = (idx.long().permute(0, 2, 1).reshape(-1)
                + torch.arange(B, device=DEV).repeat_interleave(K * m) * n)
        g_f = g_dpfj[..., 3:].reshape(-1, c)
        row = dict(ms=cuda_ms(lambda: ballgroup.ball_group_bwd_cuda(*args)),
                   plain_ms=cuda_ms(
                       lambda: ballgroup.ball_group_bwd_plain(*args)),
                   bound_ms=1e3 * max(b_bytes / PEAK_BYTES, b_ops / PEAK_F32),
                   stand_in_ms=cuda_ms(
                       lambda: torch.zeros((B * n, c), device=DEV)
                       .index_add_(0, flat, g_f)),
                   **device_host(
                       lambda: ballgroup.ball_group_bwd_cuda(*args)))
        del flat, g_f
        for key in ("ms", "plain_ms", "stand_in_ms", "device_ms", "host_us"):
            bwd[key] = (None if bwd[key] is None or row[key] is None
                        else bwd[key] + row[key])
        bwd["t_b"] += b_bytes / PEAK_BYTES
        bwd["t_o"] += b_ops / PEAK_F32
        bwd["max_abs_err"] = max(bwd["max_abs_err"], errs["g_feats"],
                                 errs["g_xyz"])
        emit("stage_times", stage=i + 1, shape=[B, n, m, c, K],
             ball_group_bwd=row)
    bwd.update(bound_row(bwd.pop("t_b"), bwd.pop("t_o")))
    return bwd


# the ball group's edges, each forward exact and each backward within its
# bound: (B, N, M, C, K, radius, features 16-byte aligned)
BG_EDGES = [(3, 500, 77, 24, 32, 0.3, True),    # M off the tile
            (2, 1001, 37, 3, 33, 0.4, True),    # N % 4, C = 3, K = 33
            (2, 16384, 100, 16, 32, 0.1, True),  # N too large to stage
            (2, 300, 37, 0, 1, 0.3, True),      # K = 1, C = 0
            (4, 257, 100, 36, 128, 0.9, True),  # K = 128
            (2, 100, 30, 5000, 8, 0.5, True),   # C wider than a span buffer
            (4, 1024, 512, 32, 32, 0.15, False)]  # misaligned features


def check_ball_group_edges(gen) -> dict:
    """Rows 2 and 4 at BG_EDGES against their plain versions: the forward
    bit for bit with dp relative and normalised, relative only and absolute,
    on a cloud whose first center lies far out (a ball holding only it); the
    backward as at the stages (``check_bg_backward``). Returns each edge's
    forward tiling."""
    import torch
    from adaptpoint_tpu_torch.ops import ballgroup

    tilings = {}
    for b, n, m, c, k, r, aligned in BG_EDGES:
        xyz = torch.randn((b, n, 3), generator=gen, device=DEV)
        xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        qidx = torch.stack([torch.randperm(n, generator=gen, device=DEV)[:m]
                            for _ in range(b)]).int().contiguous()
        xyz[0, qidx[0, 0]] = 5.0
        xyz = xyz.contiguous()
        if aligned:
            feats = torch.randn((b, n, c), generator=gen, device=DEV)
        else:  # a view one float into its storage
            feats = torch.randn(b * n * c + 1, generator=gen,
                                device=DEV)[1:].view(b, n, c)
        tag = f"B={b} N={n} M={m} C={c} K={k}" + ("" if aligned else
                                                   " misaligned")
        tl = ballgroup.fwd_tiling(b, n, m, c, k, feats.data_ptr() % 16 == 0)
        tilings[tag] = list(tl)
        for rel, norm in ((True, True), (True, False), (False, False)):
            args = (r, k, xyz, qidx, feats, rel, norm)
            got = ballgroup.ball_group_cuda(*args)
            ref = ballgroup.ball_group_plain(*args)
            torch.cuda.synchronize()
            errs = [float((a.float() - b_.float()).abs().max())
                    if a.numel() else 0.0 for a, b_ in zip(got, ref)]
            emit("kernel", name="ball_group", case=tag, relative=rel,
                 normalize_dp=norm, tiling=list(tl),
                 max_abs_err={"new_xyz": errs[0], "fi": errs[1],
                              "dpfj": errs[2], "idx": errs[3]},
                 tolerance="exact")
            if any(errs) or not all(torch.equal(a, b_)
                                    for a, b_ in zip(got, ref)):
                raise AssertionError(f"ball-group kernel disagrees ({tag}, "
                                     f"{rel=}, {norm=}): {errs}")
        check_bg_backward(gen, tag, r, k, xyz, qidx, feats.contiguous())
        del xyz, feats
    return tilings


def check_bg_layout(b, n, m, c, k) -> dict:
    """Rows 2, 4's launch shapes at this shape: the host's copies of their
    shared memory (``ballgroup.fwd_smem_bytes``, ``bwd_smem_bytes``)
    against the kernels' own, each within the card's opt-in."""
    from adaptpoint_tpu_torch.ops import ballgroup
    tl = ballgroup.fwd_tiling(b, n, m, c, k)
    host = ballgroup.fwd_smem_bytes(tl.tm, k, n, tl.use_xs, tl.cap)
    dev = ballgroup._lib().ball_group_smem_bytes(tl.tm, k, n, int(tl.use_xs),
                                                 tl.cap)
    host_b = ballgroup.bwd_smem_bytes(k)
    dev_b = ballgroup._lib_bwd().ball_group_bwd_smem_bytes(k)
    if host != dev or dev > ballgroup._SMEM_LIMIT or host_b != dev_b \
            or dev_b > ballgroup._SMEM_LIMIT:
        raise AssertionError(f"ball group layouts at {[b, n, m, c, k]}: "
                             f"forward host {host} kernel {dev} ({tl}), "
                             f"backward host {host_b} kernel {dev_b}")
    return dict(forward=dict(tl._asdict(), smem_bytes=dev),
                backward=dict(smem_bytes=dev_b))


def bg_op_launches(gen, xyz, qidx, feats, radius) -> dict:
    """What one call of ``ops.ball_group`` puts on the card, from the
    profiler: the forward, then the backward through autograd, each by
    name. It must be the forward kernel alone, then the backward kernel
    and the memsets of its two outputs (ballgroup_bwd.cu's reductions need
    zeros to add to), nothing else."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptpoint_tpu_torch import ops
    x_req = xyz.clone().requires_grad_()
    f_req = feats.clone().requires_grad_()
    b, m, c = qidx.shape[0], qidx.shape[1], feats.shape[2]
    gs = (torch.randn((b, m, 3), generator=gen, device=DEV),
          torch.randn((b, m, c), generator=gen, device=DEV),
          torch.randn((b, K, m, 3 + c), generator=gen, device=DEV))
    for _ in range(2):  # the second call is the one counted
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p_fwd:
            out = ops.ball_group(radius, K, x_req, qidx, f_req, True, True)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p_bwd:
            torch.autograd.grad(out[:3], (x_req, f_req), gs)
            torch.cuda.synchronize()
    found = {phase: {e.key[:60]: e.count for e in device_kernels(prof)}
             for phase, prof in (("forward", p_fwd), ("backward", p_bwd))}
    fwd, bwd = found["forward"], found["backward"]
    memsets = sum(v for k, v in bwd.items() if "emset" in k)
    ok = (list(fwd.values()) == [1] and "ball_group_kernel<" in next(iter(fwd))
          and sum(v for k, v in bwd.items()
                  if "ball_group_bwd_kernel" in k) == 1
          and sum(bwd.values()) - memsets == 1 and memsets == 2)
    emit("ball_group_op_launches", shape=[b, xyz.shape[1], m, c, K],
         forward=fwd, backward=bwd,
         expected="forward: the kernel alone; backward: the kernel and the "
                  "memsets of its two outputs")
    if not ok:
        raise AssertionError(f"ops.ball_group launches {found}")
    return {"forward": sum(fwd.values()), "backward": sum(bwd.values())}


# FPS edge cases, each exact against the plain version: (B, N, npoint, share
# of points moved to the origin); every instance of the kernel
# (fpsample.FPS_INSTANCES) and the shared-memory planes (N > 4096)
FPS_EDGES = [(1, 1024, 512, 0.0), (2, 1000, 1000, 0.0), (2, 4097, 4097, 0.0),
             (4, 2048, 1, 0.0), (4, 2048, 1024, 0.5), (2, 300, 300, 0.0),
             (2, 4096, 2048, 0.0), (2, 16384, 4096, 0.0)]


def check_fps_edges(gen) -> None:
    """The FPS kernel at FPS_EDGES against its plain version, index for
    index: B = 1, N = 1000 and 4097 with npoint = N, npoint = 1, a cloud
    with half its points at the origin (ties), N = 300 (threads without
    points), N = 4096 (1024 threads of 4 points) and N = 16384 (the
    kernel's largest); together every instance of the kernel."""
    import torch
    from adaptpoint_tpu_torch.ops import fpsample as fps
    if fps._lib().fps_max_points() != fps.FPS_MAX_POINTS:
        raise AssertionError("the FPS kernel's largest N differs from the "
                             "wrapper's FPS_MAX_POINTS")
    if {tuple(fps.fps_tiling(n)) for _, n, _, _ in FPS_EDGES} \
            != set(fps.FPS_INSTANCES):
        raise AssertionError("FPS_EDGES miss an instance of the FPS kernel")
    for b, n, npoint, dropped in FPS_EDGES:
        xyz = torch.randn((b, n, 3), generator=gen, device=DEV)
        if dropped:
            xyz = xyz * (torch.rand((b, n), generator=gen, device=DEV)
                         >= dropped)[..., None]
        xyz = xyz.contiguous()
        got = fps.furthest_point_sample_cuda(xyz, npoint)
        ref = fps.furthest_point_sample_plain(xyz, npoint)
        mism = int((got != ref).sum())
        emit("kernel", name="fps", case="edge", shape=[b, n, npoint],
             dropped_share=dropped, tiling=list(fps.fps_tiling(n)),
             mismatches=mism, tolerance="exact")
        if mism:
            raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                                 f"({b}, {n} -> {npoint}, {dropped=})")


def check_knn_edges(gen) -> None:
    """The kNN kernel against its plain version, index for index, off the
    GAN step's shapes: C = 35 (the generic-channel warp variant), k = 32,
    query counts that are not multiples of a block's (128 or 8), B = 1,
    ties (every point twice, a quarter of them at the origin) and k > N,
    on both variants."""
    import torch
    from adaptpoint_tpu_torch.ops import knn
    for c in (1, 3, 35, 512):
        if knn._lib().knn_max_points(c) != knn.knn_max_points(c):
            raise AssertionError(f"the kNN kernel's largest N at C={c} "
                                 f"differs from the wrapper's")

    def case(tag, k, support, query):
        got = knn.knn_idx_cuda(k, support, query)
        ref = knn.knn_idx_plain(k, support, query)
        mism = int((got != ref).sum())
        b, n, c = support.shape
        emit("kernel", name="knn", case=tag,
             shape=[b, n, query.shape[1], c, k],
             variant=list(knn.knn_variant(k, n, c)), mismatches=mism,
             tolerance="exact")
        if mism:
            raise AssertionError(f"kNN kernel disagrees at {mism} indices "
                                 f"({tag}, N={n}, k={k}, C={c})")

    def pts(b, n, c=3):
        return torch.randn((b, n, c), generator=gen, device=DEV)

    case("C = 35", 8, pts(2, 300, 35), pts(2, 77, 35))
    case("C = 35, k = 32", 32, pts(2, 700, 35), pts(2, 20, 35))
    case("k = 32", 32, pts(4, 1024), pts(4, 100))
    case("M = 129, thread a query", 3, pts(3, 500), pts(3, 129))
    case("M = 13, warp a query", 24, pts(3, 500), pts(3, 13))
    case("B = 1", 3, pts(1, 2048), pts(1, 1000))
    twice = pts(2, 64).repeat(1, 2, 1)
    twice[:, ::4] = 0.0
    twice = twice.contiguous()
    case("ties, thread a query", 5, twice, pts(2, 50))
    case("ties, warp a query", 20, twice, pts(2, 50))
    case("ties, C = 35", 12, pts(2, 40, 35).repeat(1, 3, 1).contiguous(),
         pts(2, 9, 35))
    case("k > N, thread a query", 8, pts(2, 5), pts(2, 33))
    case("k > N, warp a query", 32, pts(2, 20), pts(2, 33))
    case("k > N, C = 35", 16, pts(2, 7, 35), pts(2, 10, 35))


def phase_kernels(gen):
    import torch
    from adaptpoint_tpu_torch.ops import fpsample as fps

    inputs = stage_inputs(gen)
    rows = {}

    # FPS at (32, 1024) -> 512
    xyz = inputs[0][0]
    got = fps.furthest_point_sample_cuda(xyz, 512)
    ref = fps.furthest_point_sample_plain(xyz, 512)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    err = float((got.long() - ref.long()).abs().max())
    emit("kernel", name="fps", shape=[B, N0, 512], mismatches=mism,
         max_abs_err=err, tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices")
    ops_f = 511 * B * N0 * 10
    bytes_f = B * N0 * 12 + B * 512 * 4
    rows["fps"] = dict(
        ms=cuda_ms(lambda: fps.furthest_point_sample_cuda(xyz, 512)),
        plain_ms=cuda_ms(lambda: fps.furthest_point_sample_plain(xyz, 512),
                         50.0),
        bound_ms=1e3 * max(bytes_f / PEAK_BYTES, ops_f / PEAK_F32),
        bound_by="bytes" if bytes_f / PEAK_BYTES > ops_f / PEAK_F32
        else "operations", max_abs_err=err)
    rows["fps"].update(
        ns_a_step=rows["fps"]["ms"] * 1e6 / 511,
        **device_host(lambda: fps.furthest_point_sample_cuda(xyz, 512)))
    check_fps_edges(gen)

    rows["ball_group"], rows["sa_eval"] = check_stages_forward(
        gen, STAGES, inputs, inputs)
    phase_train_kernels(gen, inputs, rows)
    del inputs
    phase_adapt_kernels(gen, rows)
    emit("kernel_times", note="ms per B=32 forward or backward; ball_group, "
         "ball_group_bwd and sa_eval summed over the four SA stages, "
         "ball_group_max and its backward over the four groupers, sa_train "
         "and its backward over the fake pass's four stages; gather_rows and "
         "gather_rows_bwd at the resampling shape", rows=rows)
    return rows


def bound_row(t_bytes: float, t_ops: float) -> dict:
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def scatter_bound(counts, abs_sum):
    """Most that two f32 sums of the same ``n`` addends, taken in different
    orders, can differ: each is within ``(n - 1) * 2^-24 * sum|addend|`` of
    the true sum, so ``n * 2^-23 * sum|addend|`` bounds their difference."""
    return counts * EPS32 * abs_sum + 1e-30


def ball_group_bwd_bound(radius, idx, qidx, g_new, g_fi, g_dpfj, n,
                         relative=True):
    """Per-element bound on |kernel - plain| for the ball-group backward:
    both add the same f32 addends in another order (``scatter_bound``). With
    ``relative`` (and dp normalised) the center's row also carries the inner
    sum over its K slots."""
    import torch
    from adaptpoint_tpu_torch.ops.ballgroup import ball_group_bwd_plain
    from adaptpoint_tpu_torch.ops.geometry import inv_radius
    Bq, K, M, _ = g_dpfj.shape
    one = torch.ones((Bq, K, M, 4), device=idx.device)
    counts = ball_group_bwd_plain(radius, idx, qidx, None, one[:, 0, :, :1],
                                  one, n, False, False)[1] + K
    s = inv_radius(radius) if relative else 1.0
    a_dp = g_dpfj[..., :3].abs() * s
    a_center = g_new.abs() + a_dp.sum(dim=1) if relative else g_new.abs()
    a_xyz, a_feats = ball_group_bwd_plain(
        radius, idx, qidx, a_center, g_fi.abs(),
        torch.cat([a_dp, g_dpfj[..., 3:].abs()], -1), n, False, False)
    return scatter_bound(counts, a_xyz), scatter_bound(counts, a_feats)


def check_gather(gen, tag, n, c, idx, distinct=False,
                 dtypes=("float32", "bfloat16"), min_total_ms=200.0):
    """The row gather and its scatter-add on seeded (B, n, c) points and
    ``idx`` (B, ...) of any rank >= 2, against their plain versions: the
    kernels called directly on the flattened index, and ``ops.index_points``
    with its autograd on ``idx`` as it is. Where the scatter takes a design
    with a fixed sum order (``scatter_rows``: not L2RED), it also equals the
    ordered plain function bit for bit and two launches agree bit for bit;
    rows no index names are zero in every design. Returns the f32 rows
    (forward, backward) with times."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import gather, scatter_rows
    from adaptpoint_tpu_torch.ops.geometry import index_points as plain_index

    flat_idx = idx.reshape(B, -1).int().contiguous()
    m = flat_idx.shape[1]
    pts = torch.randn((B, n, c), generator=gen, device=DEV)
    g = torch.randn((B, m, c), generator=gen, device=DEV)
    counts = gather.gather_rows_bwd_plain(torch.ones_like(g), flat_idx, n)
    out_rows = None
    for dtype in (getattr(torch, d) for d in dtypes):
        p_t, g_t = pts.to(dtype), g.to(dtype)
        fwd = gather.gather_rows_cuda(p_t, flat_idx)
        fwd_ref = gather.gather_rows_plain(p_t, flat_idx)
        back = gather.gather_rows_bwd_cuda(g_t, flat_idx, n)
        back_ref = gather.gather_rows_bwd_plain(g_t, flat_idx, n)
        p_req = p_t.clone().requires_grad_()
        via_ops = ops.index_points(p_req, idx)
        auto = torch.autograd.grad(via_ops, p_req,
                                   g_t.reshape(via_ops.shape))[0]
        torch.cuda.synchronize()
        e_fwd = max(float((fwd.float() - fwd_ref.float()).abs().max()),
                    float((via_ops.detach().float()
                           - plain_index(p_t, idx).float()).abs().max()))
        bound = scatter_bound(counts, gather.gather_rows_bwd_plain(
            g_t.float().abs(), flat_idx, n))
        if dtype == torch.bfloat16:  # one bf16 rounding may flip
            bound = bound + back_ref.float().abs() * 2.0 ** -8
        if distinct:
            bound = torch.zeros_like(bound)
        d_back = (back.float() - back_ref.float()).abs()
        d_auto = (auto.float() - back_ref.float()).abs()
        tl = scatter_rows.choose(B, m, n, c, False, g_t.element_size(),
                                 g_t.data_ptr() % 16 == 0)
        fixed = tl.design != scatter_rows.L2RED  # a fixed sum order
        again = gather.gather_rows_bwd_cuda(g_t, flat_idx, n)
        unnamed = counts[..., 0] == 0
        checks = {"design": tl.design,
                  "equals_ordered_plain": bool(torch.equal(
                      back, gather.gather_rows_bwd_ordered(g_t, flat_idx, n))),
                  "two_launches_equal": bool(torch.equal(back, again)),
                  "unnamed_rows": int(unnamed.sum()),
                  "unnamed_rows_zero": not bool(back[unnamed].any())}
        emit("kernel", name="gather_rows", case=tag,
             shape=[B, n, c, list(idx.shape[1:])],
             dtype=str(dtype), repeated_indices=not distinct,
             max_repeat=int(counts.max()),
             max_abs_err={"forward": e_fwd, "backward": float(d_back.max()),
                          "autograd": float(d_auto.max())}, **checks,
             tolerance="forward exact; backward exact for distinct "
                       "rows, else <= n * 2^-23 * sum|addend| per element "
                       "(+ one bf16 ulp for bf16); with a fixed sum order "
                       "the ordered plain function's bits, the same bits "
                       "each launch; unnamed rows exactly zero")
        if (e_fwd or not bool((d_back <= bound).all())
                or not bool((d_auto <= bound).all())
                or back.dtype != dtype or fwd.dtype != dtype
                or via_ops.shape != tuple(idx.shape) + (c,)
                or not checks["unnamed_rows_zero"]
                or (fixed and not (checks["equals_ordered_plain"]
                                   and checks["two_launches_equal"]))):
            raise AssertionError(
                f"row gather disagrees ({tag}, {dtype}): forward {e_fwd} "
                f"backward {float(d_back.max())}, {checks}")
        if dtype != torch.float32:
            continue
        flat = (flat_idx.long() + torch.arange(B, device=DEV)[:, None] * n
                ).reshape(-1)
        long_idx = flat_idx.long()[..., None].expand(-1, -1, c)

        def fwd_fn():
            return gather.gather_rows_cuda(pts, flat_idx)

        def lib_fn():
            return torch.gather(pts, 1, long_idx)

        def bwd_fn():
            return gather.gather_rows_bwd_cuda(g, flat_idx, n)

        def add_fn():
            return torch.zeros((B * n, c), device=DEV).index_add_(
                0, flat, g.reshape(-1, c))

        # the forward reads each row its indices name once (this run's
        # data) and writes its output once
        used = int((counts[..., 0] > 0).sum())
        f_row = dict(
            shape=[B, n, c, m], max_abs_err=e_fwd,
            ms=cuda_ms(fwd_fn, min_total_ms),
            plain_ms=cuda_ms(lambda: gather.gather_rows_plain(pts, flat_idx),
                             min_total_ms),
            library_ms=cuda_ms(lib_fn, min_total_ms),
            **device_host(fwd_fn),
            **{"library_" + k: v for k, v in device_host(lib_fn).items()},
            **bound_row(((used + B * m) * c * 4 + B * m * 4) / PEAK_BYTES,
                        0.0))
        b_row = dict(
            shape=[B, n, c, m], max_abs_err=float(d_back.max()),
            ms=cuda_ms(bwd_fn, min_total_ms),
            plain_ms=cuda_ms(
                lambda: gather.gather_rows_bwd_plain(g, flat_idx, n),
                min_total_ms),
            library_ms=cuda_ms(add_fn, min_total_ms),
            **device_host(bwd_fn),
            **{"library_" + k: v for k, v in device_host(add_fn).items()},
            **bound_row((B * m * c * 4 + B * m * 4 + B * n * c * 4)
                        / PEAK_BYTES, B * m * c / PEAK_F32))
        out_rows = (f_row, b_row)
    return out_rows


def phase_train_kernels(gen, inputs, rows) -> None:
    """The kernels the train step adds, each against its plain version: FPS
    at the resampling shape, the ball-group backward at the four stage
    shapes (directly and through autograd), the row gather and its
    scatter-add. Adds their rows to ``rows``."""
    import torch
    from adaptpoint_tpu_torch.ops import fpsample as fps

    # FPS at the resampling shape (32, 2048) -> 1200
    cloud = torch.randn((B, N_TRAIN, 3), generator=gen, device=DEV)
    cloud = cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    got = fps.furthest_point_sample_cuda(cloud, N_FPS)
    ref = fps.furthest_point_sample_plain(cloud, N_FPS)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    emit("kernel", name="fps", shape=[B, N_TRAIN, N_FPS], mismatches=mism,
         tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                             f"(2048 -> 1200)")
    ops_f = (N_FPS - 1) * B * N_TRAIN * 10
    bytes_f = B * N_TRAIN * 12 + B * N_FPS * 4
    ms = cuda_ms(lambda: fps.furthest_point_sample_cuda(cloud, N_FPS))
    rows["fps"]["resample_shape"] = dict(
        shape=[B, N_TRAIN, N_FPS], ms=ms, ns_a_step=ms * 1e6 / (N_FPS - 1),
        plain_ms=cuda_ms(
            lambda: fps.furthest_point_sample_plain(cloud, N_FPS), 50.0),
        **device_host(lambda: fps.furthest_point_sample_cuda(cloud, N_FPS)),
        **bound_row(bytes_f / PEAK_BYTES, ops_f / PEAK_F32))

    # ball-group backward at the four stage shapes; both ball-group kernels
    # at their edges, their shared memory against the host's copies, and
    # what ops.ball_group launches each way
    rows["ball_group_bwd"] = check_stages_backward(gen, STAGES, inputs)
    layouts = {f"stage {i + 1}": check_bg_layout(B, n, m, c, K)
               for i, (n, m, c, _, _, _) in enumerate(STAGES)}
    edge_tilings = check_ball_group_edges(gen)
    for b, n, m, c, k, _, _ in BG_EDGES:
        layouts[f"B={b} N={n} M={m} C={c} K={k}"] = check_bg_layout(
            b, n, m, c, k)
    emit("ball_group_layouts", layouts=layouts, edge_tilings=edge_tilings)
    xyz, qidx, feats = inputs[0]
    rows["ball_group"]["op_launches"] = rows["ball_group_bwd"][
        "op_launches"] = bg_op_launches(gen, xyz, qidx, feats, STAGES[0][5])

    # row gather and its scatter-add: the resampling shape (distinct rows)
    # and a feature shape whose indices repeat
    idx = torch.argsort(torch.rand((B, N_TRAIN), generator=gen, device=DEV),
                        dim=1)[:, :N0].int().contiguous()
    rows["gather_rows"], rows["gather_rows_bwd"] = check_gather(
        gen, "resample", N_TRAIN, 4, idx, distinct=True)
    idx = torch.randint(0, 512 // 4, (B, 256), generator=gen, device=DEV,
                        dtype=torch.int32)
    rows["gather_rows"]["feature_shape"], \
        rows["gather_rows_bwd"]["feature_shape"] = check_gather(
            gen, "feature", 512, 64, idx)


def check_ball_group_max(gen, tag, xyz, qidx, feats, radius, timed=True):
    """The max-pooled ball-group kernels (rows 7, 8) at one shape against
    their plain versions, on ``feats`` of either type the kernels take (f32,
    or the bf16 policy's as they are): forward outputs and winning slots
    equal, the backward (directly and through autograd) within the
    reordering bound, plus one bf16 ulp of the value for a bf16 gradient
    (both sum in f32 and round once). Returns the forward and backward rows
    (times, bounds' parts at the features' width) when ``timed``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm

    n, c = feats.shape[1], feats.shape[2]
    m = qidx.shape[1]
    dt = feats.dtype
    bf16 = dt == torch.bfloat16
    args = (radius, K_GAN, xyz, qidx, feats)
    got = bgm.ball_group_max_cuda(*args)
    ref = bgm.ball_group_max_plain(*args)
    torch.cuda.synchronize()
    names = ("new_xyz", "fi", "fmax", "fmin", "amax", "amin", "idx")
    errs = {k: float((a.float() - b.float()).abs().max())
            for k, a, b in zip(names, got, ref)}
    errs["types"] = float(any(a.dtype != b.dtype for a, b in zip(got, ref)))
    del ref
    idx, amax, amin = got[6], got[4], got[5]
    g_new = torch.randn((B, m, 3), generator=gen, device=DEV)
    g_fi, g_fmax, g_fmin = (torch.randn((B, m, c), generator=gen,
                                        device=DEV).to(dt)
                            for _ in range(3))
    bargs = (idx, qidx, amax, amin, g_new, g_fi, g_fmax, g_fmin, n)
    back = bgm.ball_group_max_bwd_cuda(*bargs, feat_dtype=dt)
    back_ref = bgm.ball_group_max_bwd_plain(*bargs)
    x_req, f_req = xyz.clone().requires_grad_(), feats.clone().requires_grad_()
    auto = torch.autograd.grad(ops.ball_group_max(radius, K_GAN, x_req, qidx,
                                                  f_req),
                               (x_req, f_req), (g_new, g_fi, g_fmax, g_fmin))
    # both sides add the same addends (the same bf16 roundings of the same
    # cotangents) in another order: count them per element and bound; a
    # bf16 gradient is that f32 sum rounded once, which can then fall one
    # bf16 ulp apart
    ones3, ones = torch.ones_like(g_new), torch.ones((B, m, c), device=DEV)
    counts_x = bgm.ball_group_max_bwd_plain(idx, qidx, amax, amin, ones3,
                                            None, None, None, n)[0]
    counts_f = bgm.ball_group_max_bwd_plain(idx, qidx, amax, amin, None, ones,
                                            ones, ones, n)[1]
    a_x, a_f = bgm.ball_group_max_bwd_plain(
        idx, qidx, amax, amin, g_new.abs(), *(g.float().abs() for g in (
            g_fi, g_fmax, g_fmin)), n)
    bounds = [scatter_bound(counts_x, a_x), scatter_bound(counts_f, a_f)]
    if bf16:
        bounds[1] = bounds[1] + 2.0 ** -7 * (back_ref[1].float().abs()
                                             + bounds[1])
    torch.cuda.synchronize()
    ok = not any(errs.values())
    for name, a, b_, bound in (("g_xyz", back[0], back_ref[0], bounds[0]),
                               ("g_feats", back[1], back_ref[1], bounds[1]),
                               ("autograd_g_xyz", auto[0], back_ref[0],
                                bounds[0]),
                               ("autograd_g_feats", auto[1], back_ref[1],
                                bounds[1])):
        d = (a.float() - b_.float()).abs()
        errs[name] = float(d.max())
        ok = (ok and bool((d <= bound).all()) and bool(torch.isfinite(a).all())
              and a.dtype == b_.dtype)
    full = float((idx[..., -1] != idx[..., 0]).float().mean())
    emit("kernel", name="ball_group_max", case=tag, shape=[B, n, m, c, K_GAN],
         dtype=str(dt), radius=radius, max_abs_err=errs, full_balls=full,
         distinct_winners=float((amax != amin).float().mean()),
         tiling={"forward": list(bgm.fwd_tiling(B, n, m, c, K_GAN, dt)),
                 "backward": list(bgm.bwd_tiling(n, c))},
         tolerance="forward outputs, their types and winning slots exact; "
                   "backward <= n * 2^-23 * sum|addend| per element (n "
                   "addends meet there; atomic adds land in no fixed order), "
                   "+ 2^-7 of the value for a bf16 gradient")
    if not ok:
        raise AssertionError(f"max-pooled ball-group kernels disagree "
                             f"({tag}, {dt}): {errs}")
    if not timed:
        return None
    w = feats.element_size()  # features, values and cotangents
    f_row = dict(
        max_abs_err=max(errs[k] for k in names),
        ms=cuda_ms(lambda: bgm.ball_group_max_cuda(*args)),
        plain_ms=cuda_ms(lambda: bgm.ball_group_max_plain(*args), 50.0),
        t_b=(B * n * 12 + B * n * c * w + B * m * 4 + B * m * 12
             + 3 * B * m * c * w + 2 * B * m * c + B * m * K_GAN * 4)
        / PEAK_BYTES,
        t_o=(scanned_points(xyz, qidx, radius, K_GAN) * 9
             + 2 * B * m * K_GAN * c) / PEAK_F32)
    b_row = dict(
        max_abs_err=max(errs["g_xyz"], errs["g_feats"]),
        ms=cuda_ms(lambda: bgm.ball_group_max_bwd_cuda(*bargs,
                                                       feat_dtype=dt)),
        plain_ms=cuda_ms(lambda: bgm.ball_group_max_bwd_plain(*bargs), 50.0),
        t_b=(B * m * K_GAN * 4 + B * m * 4 + B * m * 12 + 3 * B * m * c * w
             + 2 * B * m * c + B * n * 12 + B * n * c * w) / PEAK_BYTES,
        t_o=4 * B * m * c / PEAK_F32)
    emit("stage_times", case=tag, shape=[B, n, m, c, K_GAN], dtype=str(dt),
         ball_group_max=f_row, ball_group_max_bwd=b_row)
    return f_row, b_row


def check_bgmax_layout(n, m, c, k, where) -> dict:
    """Rows 7, 8's launch shapes at this shape (f32 and bf16 features): the
    host's copies of their shared memory (``ballgroup_max.fwd_smem_bytes``,
    ``bwd_smem_bytes``) against the kernel's own; each within the card's
    opt-in."""
    import torch
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
    lib = bgm._lib()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tl = bgm.fwd_tiling(B, n, m, c, k, dt)
        host = bgm.fwd_smem_bytes(tl.tm, k, n, tl.use_xs)
        dev = lib.ball_group_max_smem_bytes(tl.tm, k, n, int(tl.use_xs))
        out[str(dt)] = dict(tl._asdict(), smem_bytes=dev)
        if host != dev or dev > bgm._SMEM_LIMIT:
            raise AssertionError(f"max-pooled ball group forward layout: "
                                 f"host {host} bytes, kernel {dev} ({where}, "
                                 f"{dt}, {tl})")
    tl = bgm.bwd_tiling(n, c)
    host = bgm.bwd_smem_bytes(tl.s, tl.r)
    dev = lib.ball_group_max_bwd_smem_bytes(tl.s, tl.r)
    out["backward"] = dict(tl._asdict(), smem_bytes=dev)
    if host != dev or dev > bgm._SMEM_LIMIT:
        raise AssertionError(f"max-pooled ball group backward layout: host "
                             f"{host} bytes, kernel {dev} ({where}, {tl})")
    return out


def bgmax_op_launches(gen, xyz, qidx, n, c, radius) -> dict:
    """What one call of ``ops.ball_group_max`` on bf16 features puts on the
    card, from the profiler: the forward, then the backward through
    autograd, each by name. The bf16 route must be one forward kernel, one
    backward kernel and at most one memset: no cast around them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptpoint_tpu_torch import ops
    x_req = xyz.clone().requires_grad_()
    f_req = torch.randn((B, n, c), generator=gen, device=DEV).to(
        torch.bfloat16).requires_grad_()
    m = qidx.shape[1]
    gs = (torch.randn((B, m, 3), generator=gen, device=DEV),
          *(torch.randn((B, m, c), generator=gen, device=DEV).to(
              torch.bfloat16) for _ in range(3)))
    for _ in range(2):  # the second call is the one counted
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p_fwd:
            out = ops.ball_group_max(radius, K_GAN, x_req, qidx, f_req)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p_bwd:
            grads = torch.autograd.grad(out, (x_req, f_req), gs)
            torch.cuda.synchronize()
    found = {}
    for phase, prof in (("forward", p_fwd), ("backward", p_bwd)):
        found[phase] = {e.key[:60]: e.count for e in device_kernels(prof)}
    fwd, bwd = found["forward"], found["backward"]
    memsets = sum(v for k, v in bwd.items() if "emset" in k)
    ok = (list(fwd.values()) == [1]
          and "ball_group_max_kernel<" in next(iter(fwd))
          and sum(v for k, v in bwd.items()
                  if "ball_group_max_bwd_kernel<" in k) == 1
          and sum(bwd.values()) - memsets == 1 and memsets <= 1
          and out[1].dtype == grads[1].dtype == torch.bfloat16)
    emit("ball_group_max_op_launches", features="bfloat16",
         shape=[B, n, m, c, K_GAN], forward=fwd, backward=bwd,
         expected="forward: the kernel alone; backward: the kernel and at "
                  "most one memset; no cast")
    if not ok:
        raise AssertionError(f"ops.ball_group_max on bf16 features launches "
                             f"{found}")
    return {"forward": sum(fwd.values()), "backward": sum(bwd.values())}


def rel_l2(a, b) -> float:
    """``|a - b| / |b|`` in 2-norm, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def check_fwd_layout(k, packed, n, b, m, where) -> dict:
    """The forward's tiling at this shape: the host's copy of its shared
    memory (``saeval._fwd_smem_bytes``) against the kernel's own
    (``sa_eval_smem_bytes``); returns the tiling."""
    from adaptpoint_tpu_torch.ops import saeval
    wp, midp, coutp = packed.w1.shape + packed.w2.shape[1:]
    tl = saeval._fwd_tiling(k, wp, midp, coutp, n, b, m)
    host = saeval._fwd_smem_bytes(tl.tm, k, wp, midp, coutp, tl.np, tl.kc, n,
                                  tl.use_xs)
    dev = saeval._lib().sa_eval_smem_bytes(tl.tm, k, wp, midp, coutp, tl.np,
                                           tl.kc, n, int(tl.use_xs))
    if host != dev:
        raise AssertionError(f"forward layout: host {host} bytes, kernel "
                             f"{dev} ({where})")
    return dict(tl._asdict(), smem_bytes=dev)


def check_bwd_layout(k, wp, midp, coutp, c, pg, where) -> None:
    """The host's copy of row 6's shared-memory layout against the kernel's
    own, at the tiling the wrapper picks (GH whole or grouped)."""
    from adaptpoint_tpu_torch.ops import saeval
    tl = saeval._bwd_tiling(k, wp, midp, coutp, c, pg)
    host = saeval._bwd_smem_bytes(tl.tm, k, wp, midp, coutp, c, pg, tl.np)
    dev = saeval._lib_bwd().sa_train_bwd_smem_bytes(
        tl.tm, k, wp, midp, coutp, c, int(pg), tl.np)
    if host != dev:
        raise AssertionError(f"backward layout: host {host} bytes, kernel "
                             f"{dev} ({where}, {pg=}, {tl})")


def check_sa_train(gen, stages, inputs):
    """The differentiable fused SA stage (rows 5, 6) at ``stages`` (K
    neighbours, relative, dp normalised) on ``inputs``, against its plain
    versions. Forward: new_xyz, fi and the neighbours exact, out within
    TOL_SA * (1 + |plain|), the winning slots counted where they differ (a
    near-tie of two distinct rows may fall the other way with the sum
    order). Backward on the kernel's own neighbours and winners: each
    gradient within TOL_SA_BWD in relative 2-norm (single bf16 roundings of
    the recomputed sums), with the weight gradients once, at the last stage;
    end to end (``ops.sa_train`` and its autograd on each side's own
    winners) within TOL_SA_E2E. Returns the forward and backward rows,
    summed over the stages."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import saeval

    fwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0)
    bwd = dict(fwd)
    for i, ((n, m, c, mid, cout, r), (xyz, qidx, feats)) in enumerate(
            zip(stages, inputs)):
        w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) \
            / (3 + c) ** 0.5
        b1 = torch.randn((mid,), generator=gen, device=DEV) * 0.1
        w2 = torch.randn((mid, cout), generator=gen, device=DEV) / mid ** 0.5
        b2 = torch.randn((cout,), generator=gen, device=DEV) * 0.1
        packed = saeval.pack_weights(w1, b1, w2, b2)
        # the backward's tiling: the host's copy of the shared-memory layout
        # against the kernel's own
        wp, midp, coutp = packed.w1.shape + packed.w2.shape[1:]
        for pg in (False, True):
            check_bwd_layout(K, wp, midp, coutp, c, pg, f"stage {i + 1}")
        check_fwd_layout(K, packed, n, B, m, f"stage {i + 1}")
        fargs = (r, K, xyz, qidx, feats)
        got = saeval.sa_train_cuda(*fargs, packed, True, True)
        ref = saeval.sa_train_plain(*fargs, w1, b1, w2, b2, True, True)
        torch.cuda.synchronize()
        e_exact = max(float((got[j].float() - ref[j].float()).abs().max())
                      for j in (0, 1, 4))
        diff = (got[2] - ref[2]).abs()
        scaled = float((diff / (1.0 + ref[2].abs())).max())
        differ = int((got[3] != ref[3]).sum())
        g_new = torch.randn((B, m, 3), generator=gen, device=DEV)
        g_fi = torch.randn((B, m, c), generator=gen, device=DEV)
        g_out = torch.randn((B, m, cout), generator=gen, device=DEV)
        bargs = (r, xyz, qidx, feats)
        back_ref = saeval.sa_train_bwd_plain(*bargs, w1, b1, w2, b2, got[4],
                                             got[3], g_new, g_fi, g_out, True,
                                             True, True)
        # without the weight gradients (the GAN step's frozen classifier)
        # and with them
        errs = {}
        for weights in (False, True):
            back = saeval.sa_train_bwd_cuda(*bargs, packed, got[4], got[3],
                                            g_new, g_fi, g_out, True, True,
                                            weights)
            tag = "_with_weights" if weights else ""
            errs["g_xyz" + tag] = rel_l2(back[0], back_ref[0])
            errs["g_feats" + tag] = rel_l2(back[1], back_ref[1])
            if weights:
                for name, a, b_ in zip(("g_w1", "g_b1", "g_w2", "g_b2"),
                                       back[2], back_ref[2]):
                    errs[name] = rel_l2(a, b_)
        # end to end, as the model calls it, each side on its own winners,
        # with the folded weights constant and taking a gradient
        e2e = {}
        for weights in (False, True):
            ends = []
            for plain in (False, True):
                x_req = xyz.clone().requires_grad_()
                f_req = feats.clone().requires_grad_()
                ws = [t.clone().requires_grad_(weights)
                      for t in (w1, b1, w2, b2)]
                ctx = plain_ops() if plain else contextlib.nullcontext()
                with ctx:
                    out = ops.sa_train(r, K, x_req, qidx, f_req, *ws, True,
                                       True, None if plain or weights
                                       else packed)
                    wrt = [x_req, f_req] + (ws if weights else [])
                    ends.append(torch.autograd.grad(out, wrt,
                                                    (g_new, g_fi, g_out)))
            names = ["g_xyz", "g_feats"] + (
                ["g_w1", "g_b1", "g_w2", "g_b2"] if weights else [])
            for name, a, b_ in zip(names, *ends):
                e2e[name + ("_with_weights" if weights else "")] = \
                    rel_l2(a, b_)
        torch.cuda.synchronize()
        emit("kernel", name="sa_train", stage=[B, n, m, c, mid, cout, K],
             max_abs_err={"exact_outputs": e_exact,
                          "out": float(diff.max())},
             max_scaled_err=scaled, winners_differ=differ,
             winners=got[3].numel(), grad_rel_l2=errs, end_to_end_rel_l2=e2e,
             grad_absmax=float(back_ref[1].abs().max()),
             tolerance=f"new_xyz, fi, neighbours exact; |out - plain| <= "
                       f"{TOL_SA} * (1 + |plain|); backward on the kernel's "
                       f"winners <= {TOL_SA_BWD}, end to end <= {TOL_SA_E2E} "
                       f"in relative 2-norm a gradient, with and without "
                       f"the weight gradients")
        if (e_exact or scaled > TOL_SA or max(errs.values()) > TOL_SA_BWD
                or max(e2e.values()) > TOL_SA_E2E
                or not all(bool(torch.isfinite(t).all())
                           for t in (got[2], back[0], back[1]))):
            raise AssertionError(f"differentiable fused SA disagrees at stage "
                                 f"{i + 1}: exact {e_exact}, out {scaled}, "
                                 f"backward {errs}, end to end {e2e}")
        fwd_row = dict(
            ms=cuda_ms(lambda: saeval.sa_train_cuda(*fargs, packed, True,
                                                     True)),
            plain_ms=cuda_ms(lambda: saeval.sa_train_plain(
                *fargs, w1, b1, w2, b2, True, True), 50.0),
            t_b=(B * n * 12 + B * n * c * 4 + B * m * 4
                 + ((3 + c) * mid + mid * cout) * 2 + (mid + cout) * 4
                 + B * m * 12 + B * m * c * 4 + B * m * cout * 5
                 + B * m * K * 4) / PEAK_BYTES,
            t_o=2 * B * m * K * ((3 + c) * mid + mid * cout) / PEAK_BF16
            + scanned_points(xyz, qidx, r) * 9 / PEAK_F32)
        def bwd_fn():
            return saeval.sa_train_bwd_cuda(*bargs, packed, got[4], got[3],
                                            g_new, g_fi, g_out, True, True)

        bwd_row = dict(
            ms=cuda_ms(bwd_fn), **device_host(bwd_fn),
            plain_ms=cuda_ms(lambda: saeval.sa_train_bwd_plain(
                *bargs, w1, b1, w2, b2, got[4], got[3], g_new, g_fi, g_out,
                True, True), 50.0),
            t_b=(2 * (B * n * 12 + B * n * c * 4) + B * m * 4
                 + B * m * K * 4 + B * m * cout * 5 + B * m * 12
                 + B * m * c * 4 + ((3 + c) * mid + mid * cout) * 2
                 + mid * 4) / PEAK_BYTES,
            t_o=2 * B * m * K * (2 * (3 + c) * mid + cout * mid)
            / PEAK_BF16)
        for acc, row in ((fwd, fwd_row), (bwd, bwd_row)):
            for key in ("ms", "plain_ms", "t_b", "t_o"):
                acc[key] += row[key]
        bwd["device_ms"] = (None if bwd_row["device_ms"] is None
                            or bwd.get("device_ms", 0.0) is None
                            else bwd.get("device_ms", 0.0)
                            + bwd_row["device_ms"])
        for key in ("ms", "device_ms", "host_us"):
            bwd.setdefault("stages_" + key, []).append(bwd_row[key])
        bwd.setdefault("stages_bound_ms", []).append(
            1e3 * max(bwd_row["t_b"], bwd_row["t_o"]))
        fwd["max_abs_err"] = max(fwd["max_abs_err"], float(diff.max()))
        bwd["max_abs_err"] = max(bwd["max_abs_err"], float(
            (back[1] - back_ref[1]).abs().max()))
        emit("stage_times", stage=i + 1, shape=[B, n, m, c, mid, cout, K],
             sa_train=fwd_row, sa_train_bwd=bwd_row)
        del got, ref, back, back_ref, ends, out
        torch.cuda.empty_cache()
    for acc in (fwd, bwd):
        acc.update(bound_row(acc.pop("t_b"), acc.pop("t_o")))
    bwd["host_us"] = max(bwd["stages_host_us"])
    return fwd, bwd


# the fused SA backward off the GAN step's shapes: (N, M, C, mid, cout, K,
# radius) at B = 2 on clouds with half their points at the origin. C % 4 != 0
# (scalar adds, no 16-byte feature loads); K = 8 (16 centers a block); K = 48
# (rows padded to a multiple of 32); C = 512 (two passes over the hidden
# columns and the features, GH apart from A); the grouped layout, where GH
# does not fit whole: (256, 512, 512) at K = 48 (grouped with the weight
# gradients only) and (512, 1024, 1024) at K = 64 (grouped with and without
# them), 2 clouds of 64 centers
SA_BWD_SHAPES = [(256, 64, 35, 40, 72, 24, 0.3), (256, 64, 16, 16, 32, 8, 0.3),
                 (512, 64, 64, 64, 128, 48, 0.4),
                 (512, 64, 512, 512, 1024, 32, 0.4),
                 (1024, 64, 256, 512, 512, 48, 0.4),
                 (1024, 64, 512, 1024, 1024, 64, 0.4)]


def relu_flips(r, k, xyz, qidx, feats, w1, b1, idx, relu) -> dict:
    """Where row 6's ReLU mask (its forward's, bit for bit) differs from the
    plain version's own h_pre > 0: the count of entries, and the largest
    |h_pre| (float64) there over the f32 reordering bound of its 3 + C + 1
    addends, n 2^-23 sum|addend| (the products bf16(gg) bf16(w1) are exact):
    at most 1 where the two masks differ only because two orders of the same
    f32 sum fall on either side of zero."""
    import torch
    from adaptpoint_tpu_torch.ops import saeval
    _, _, _, gg = saeval._grouped_rows(r, k, xyz, qidx, feats, True, True,
                                       idx)
    w = saeval._bf16(w1)
    g64, w64 = gg.double(), w.double()
    h64 = torch.matmul(g64, w64) + b1.double()
    bound = (gg.shape[-1] + 1) * EPS32 * (torch.matmul(g64.abs(), w64.abs())
                                          + b1.double().abs())
    flips = (relu[..., :w1.shape[1]] != 0) != (torch.matmul(gg, w) + b1 > 0)
    n = int(flips.sum())
    return {"flips": n, "worst_over_bound": float(
        (h64.abs() / bound)[flips].max()) if n else 0.0}


def check_sa_train_bwd_shapes(gen) -> None:
    """Row 6 against its plain version (TOL_SA_BWD in relative 2-norm a
    gradient, with and without the weight gradients) at SA_BWD_SHAPES, on
    the forward kernel's own neighbours and winners: the host's tiling and
    the kernel's paths the GAN step's stages do not take. The kernel also
    reports its ReLU mask: where it differs from the plain version's, the
    entry must lie within the f32 reordering bound of zero
    (:func:`relu_flips`), and the gradients must be within TOL_SA_BWD of the
    plain version on the kernel's mask. They must also be within TOL_SA_BWD
    of the plain version on its own mask wherever GH is whole, and at the
    grouped shapes wherever the two masks are equal; where a flip was
    observed there, that distance is reported only: with few centers a
    single near-zero entry whose mask two sum orders decide differently
    moves a gradient by ~1e-3 in relative 2-norm (PERF.md, ROADMAP C.3).
    With GH whole the grouped layout, forced, must be within TOL_GROUPED of
    GH whole with the same ReLU mask bit for bit."""
    import torch
    from adaptpoint_tpu_torch.ops import saeval
    b = 2
    for n, m, c, mid, cout, k, r in SA_BWD_SHAPES:
        xyz = torch.randn((b, n, 3), generator=gen, device=DEV)
        xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        xyz = (xyz * (torch.rand((b, n), generator=gen, device=DEV)
                      >= FAKE_DROPPED)[..., None]).contiguous()
        qidx = torch.stack([torch.randperm(n, generator=gen, device=DEV)[:m]
                            for _ in range(b)]).int().contiguous()
        feats = torch.randn((b, n, c), generator=gen, device=DEV)
        w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) \
            / (3 + c) ** 0.5
        b1 = torch.randn((mid,), generator=gen, device=DEV) * 0.1
        w2 = torch.randn((mid, cout), generator=gen, device=DEV) / mid ** 0.5
        b2 = torch.randn((cout,), generator=gen, device=DEV) * 0.1
        packed = saeval.pack_weights(w1, b1, w2, b2)
        got = saeval.sa_train_cuda(r, k, xyz, qidx, feats, packed, True, True)
        cots = [torch.randn(shape, generator=gen, device=DEV)
                for shape in ((b, m, 3), (b, m, c), (b, m, cout))]
        bargs = (r, xyz, qidx, feats)
        wp, midp, coutp = packed.w1.shape + packed.w2.shape[1:]
        relu = torch.zeros((b, m, k, midp), dtype=torch.uint8, device=DEV)
        backs = [saeval.sa_train_bwd_cuda(*bargs, packed, got[4], got[3],
                                          *cots, True, True, weights,
                                          relu=relu)
                 for weights in (False, True)]
        errs = {}
        for mask, ref in (("", saeval.sa_train_bwd_plain(
                *bargs, w1, b1, w2, b2, got[4], got[3], *cots, True, True,
                True)), ("kernel_mask_", saeval.sa_train_bwd_plain(
                *bargs, w1, b1, w2, b2, got[4], got[3], *cots, True, True,
                True, relu=relu))):
            for back, tag in zip(backs, ("", "_with_weights")):
                errs[mask + "g_xyz" + tag] = rel_l2(back[0], ref[0])
                errs[mask + "g_feats" + tag] = rel_l2(back[1], ref[1])
            for name, x, y in zip(("g_w1", "g_b1", "g_w2", "g_b2"),
                                  backs[1][2], ref[2]):
                errs[mask + name] = rel_l2(x, y)
        tilings = []
        for pg in (False, True):
            check_bwd_layout(k, wp, midp, coutp, c, pg, f"{[n, m, c, k]}")
            tilings.append(list(saeval._bwd_tiling(k, wp, midp, coutp, c,
                                                   pg)))
        grouped = any(tl[1] for tl in tilings)
        flips = relu_flips(r, k, xyz, qidx, feats, w1, b1, got[4], relu)
        if not grouped:  # the grouped instance forced where GH fits whole
            for pg, back in zip((False, True), backs):
                tm = tilings[pg][0]
                ng = max(w for w in (32, 64, 128, 256)
                         if w <= saeval._pass_cols(saeval._bwd_rows(tm, k))
                         and saeval._bwd_smem_bytes(tm, k, wp, midp, coutp, c,
                                                    pg, w)
                         <= saeval._SMEM_LIMIT)
                relu_g = torch.zeros_like(relu)
                forced = saeval.sa_train_bwd_cuda(
                    *bargs, packed, got[4], got[3], *cots, True, True, pg,
                    tiling=saeval.BwdTiling(tm, ng, 1), relu=relu_g)
                tag = f"grouped_{ng}_vs_whole" + ("_with_weights" if pg
                                                  else "")
                errs[tag] = max(rel_l2(x, y) for x, y in zip(
                    forced[:2] + (forced[2] or ()),
                    back[:2] + (back[2] or ())))
                if errs[tag] > TOL_GROUPED or not torch.equal(relu_g, relu):
                    raise AssertionError(f"the grouped layout disagrees with "
                                         f"GH whole at {[n, m, c, k]}: "
                                         f"{errs[tag]}, masks equal "
                                         f"{torch.equal(relu_g, relu)}")
        own_mask_gated = not grouped or flips["flips"] == 0
        gated = [v for key, v in errs.items()
                 if key.startswith("kernel_mask_")
                 or (own_mask_gated and not key.startswith("grouped_"))]
        emit("kernel", name="sa_train_bwd", case="odd shape",
             shape=[b, n, m, c, mid, cout, k],
             tiling_without_and_with_weights=tilings, grad_rel_l2=errs,
             relu_mask_against_plain=flips, own_mask_gated=own_mask_gated,
             tolerance=f"<= {TOL_SA_BWD} in relative 2-norm a gradient, on "
                       f"the kernel's ReLU mask" + (" and on the plain's"
                                                    if own_mask_gated else "")
                       + "; masks differ only within the f32 reordering "
                         "bound of zero")
        if max(gated) > TOL_SA_BWD or flips["worst_over_bound"] > 1.0 \
                or not all(bool(torch.isfinite(t).all())
                           for back in backs for t in back[:2]):
            raise AssertionError(f"fused SA backward disagrees at "
                                 f"{[n, m, c, mid, cout, k]}: {errs} "
                                 f"{flips}")


# the fused SA forward (rows 3, 5) at its tiling's edges: (B, N, M, C, mid,
# cout, K, radius) on clouds with half their points at the origin (the pad
# slots of a ball with fewer than K points repeat its first row: exact ties
# in out). K = 24 with C = 35 and M = 37 (a ragged last tile of 8 centers);
# K = 8 at B = 1 (16 centers of 16 rows, 16-row strips); K = 48 (5 centers,
# 240 rows in 256-row tiles); K = 128 (2 centers); radius 0: every ball
# empty (dp not normalised)
SA_FWD_SHAPES = [(2, 256, 37, 35, 40, 72, 24, 0.3),
                 (1, 512, 64, 64, 64, 128, 8, 0.3),
                 (2, 512, 50, 64, 64, 128, 48, 0.4),
                 (2, 256, 20, 32, 32, 64, 128, 0.5),
                 (2, 256, 64, 32, 32, 64, 32, 0.0)]


def check_sa_forward_shapes(gen) -> None:
    """Rows 3 and 5 against their plain versions at SA_FWD_SHAPES: new_xyz,
    fi and the neighbours exact, out within TOL_SA * (1 + |plain|), the
    eval call's outputs equal to the train call's, and the winning slots
    equal to the plain version's wherever the plain maximum stands more than
    2 TOL_SA * (1 + |max|) above every value that differs from it (exact
    ties, the repeated pad rows, go to the first slot on both sides); where
    it does not, the kernel's slot holds a value within that margin of the
    maximum."""
    import torch
    from adaptpoint_tpu_torch.ops import saeval
    for b, n, m, c, mid, cout, k, r in SA_FWD_SHAPES:
        xyz = torch.randn((b, n, 3), generator=gen, device=DEV)
        xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        xyz = (xyz * (torch.rand((b, n), generator=gen, device=DEV)
                      >= FAKE_DROPPED)[..., None]).contiguous()
        qidx = torch.stack([torch.randperm(n, generator=gen, device=DEV)[:m]
                            for _ in range(b)]).int().contiguous()
        feats = torch.randn((b, n, c), generator=gen, device=DEV)
        w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) \
            / (3 + c) ** 0.5
        b1 = torch.randn((mid,), generator=gen, device=DEV) * 0.1
        w2 = torch.randn((mid, cout), generator=gen, device=DEV) / mid ** 0.5
        b2 = torch.randn((cout,), generator=gen, device=DEV) * 0.1
        packed = saeval.pack_weights(w1, b1, w2, b2)
        norm = r > 0
        tiling = check_fwd_layout(k, packed, n, b, m, f"K={k}, C={c}")
        args = (r, k, xyz, qidx, feats)
        got = saeval.sa_train_cuda(*args, packed, True, norm)
        ev = saeval.sa_eval_cuda(*args, packed=packed, relative=True,
                                 normalize_dp=norm)
        ref = saeval.sa_train_plain(*args, w1, b1, w2, b2, True, norm)
        o = saeval._slot_outputs(*args, w1, b1, w2, b2, True, norm)[2]
        torch.cuda.synchronize()
        e_exact = max(float((got[j].float() - ref[j].float()).abs().max())
                      for j in (0, 1, 4))
        scaled = float(((got[2] - ref[2]).abs()
                        / (1.0 + ref[2].abs())).max())
        same_eval = all(torch.equal(x, y) for x, y in zip(ev, got[:3]))
        top = o.max(dim=2).values
        margin = 2 * TOL_SA * (1.0 + top.abs())
        other = torch.where(o == top[:, :, None], float("-inf"),
                            o).max(dim=2).values
        decisive = (top - other) > margin
        arg_k, arg_p = got[3].long(), ref[3].long()
        mismatched = int(((arg_k != arg_p) & decisive).sum())
        picked = torch.gather(o, 2, arg_k[:, :, None]).squeeze(2)
        far = int((picked < top - margin).sum())
        ties = int(((o == top[:, :, None]).sum(dim=2) > 1).sum())
        emit("kernel", name="sa_train", case="edge shape",
             shape=[b, n, m, c, mid, cout, k], radius=r, tiling=tiling,
             max_abs_err={"exact_outputs": e_exact}, max_scaled_err=scaled,
             eval_equals_train=same_eval, tied_outputs=ties,
             decisive_outputs=int(decisive.sum()),
             winners_differ=int((arg_k != arg_p).sum()),
             tolerance=f"new_xyz, fi, neighbours exact; |out - plain| <= "
                       f"{TOL_SA} * (1 + |plain|); winners equal where the "
                       f"maximum is decisive")
        if (e_exact or scaled > TOL_SA or not same_eval or mismatched or far
                or not torch.isfinite(got[2]).all()):
            raise AssertionError(
                f"fused SA forward disagrees at {[b, n, m, c, k, r]}: exact "
                f"{e_exact}, out {scaled}, eval == train {same_eval}, "
                f"winners {mismatched} decisive mismatched, {far} far")


def check_attention(gen, rows) -> None:
    """The flash attention kernels (rows 9, 10) against their plain versions
    within TOL_MHA, directly and through autograd, at both input types:
    every head dim at N = 1, below a tile (40), at the tiles' edges (127,
    128, 129) and at 2047, the earlier ragged shapes, and the mask head's
    (128, 2048, 16); two backward runs bit for bit equal (dq is summed over
    the key blocks in a fixed order, no atomics). Times at the mask head's
    shape for bf16 inputs, what the bf16 policy's ``AnchorSelfAttention``
    passes and the row's ``ms``, and for f32 beside them, with
    ``scaled_dot_product_attention`` on the same bf16 inputs in the same run.
    Adds rows "mha" and "mha_bwd" to ``rows``."""
    import torch
    import torch.nn.functional as F
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import attention

    def mha_inputs(shape, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
                for _ in range(4)]

    def mha_check(shape, scale, dtype=torch.float32):
        q, k, v, do = mha_inputs(shape, dtype)
        do = do.float()
        out, saved = attention.mha_cuda(q, k, v, scale, for_backward=True)
        grads = attention.mha_bwd_cuda(q, k, v, scale, do, saved)
        again = attention.mha_bwd_cuda(q, k, v, scale, do, saved)
        # through autograd, as the model calls it
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(ops.fused_self_attention(*qkv, scale), qkv,
                                   do)
        ref = attention.mha_plain(q, k, v, scale)
        ref_grads = attention.mha_bwd_plain(q, k, v, scale, do)
        torch.cuda.synchronize()
        errs, worst, ok = {}, 0.0, True
        pairs = [("out", out, ref)]
        for name, a, b_, c in zip(("dq", "dk", "dv"), grads, ref_grads, auto):
            pairs += [(name, a, b_), ("autograd_" + name, c, b_)]
        for name, a, b_ in pairs:
            if a.dtype != b_.dtype or a.shape != b_.shape:
                ok = False
            a, b_ = a.float(), b_.float()
            d = (a - b_).abs()
            errs[name] = float(d.max())
            scaled = float((d / (1.0 + b_.abs())).max())
            worst = max(worst, scaled)
            tol = TOL_MHA if dtype == torch.float32 or name == "out" \
                else TOL_MHA + 2.0 ** -8  # a bf16 gradient: one more ulp
            ok = ok and scaled <= tol and bool(torch.isfinite(a).all())
        repeat = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
        emit("kernel", name="mha", shape=list(shape), scale=scale,
             dtype=str(dtype), max_abs_err=errs, max_scaled_err=worst,
             out_absmax=float(ref.abs().max()), backward_repeats=repeat,
             tolerance=f"|kernel - plain| <= {TOL_MHA} * (1 + |plain|) "
                       f"(+ 2^-8 for gradients stored as bf16); two "
                       f"backward runs bit for bit equal")
        if not ok or not repeat:
            raise AssertionError(f"attention kernels disagree at {shape} "
                                 f"{dtype}: {errs}, backward repeats: "
                                 f"{repeat}")
        return errs

    # a power-of-two scale folds the backward's division into the product;
    # sqrt(32) takes the division
    for dtype in (torch.float32, torch.bfloat16):
        for d, scale in ((16, 4.0), (32, 32 ** 0.5), (64, 8.0)):
            for n in (1, 40, 127, 128, 129, 2047):
                mha_check((2, n, d), scale, dtype)
        for shape, scale in (((3, 100, 32), 32 ** 0.5), ((2, 65, 64), 8.0),
                             ((2, 520, 16), 4.0), ((4, 1024, 16), 3.0)):
            mha_check(shape, scale, dtype)
    errs = {dt: mha_check(MHA_SHAPE, MHA_SCALE, dt)
            for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()  # the plain version's (BH, N, N) tensors

    bh, n, d = MHA_SHAPE
    q, k, v, do = mha_inputs(MHA_SHAPE)
    qb, kb, vb = [t.to(torch.bfloat16) for t in (q, k, v)]
    ql, kl, vl = [t.reshape(1, bh, n, d).requires_grad_()
                  for t in (qb, kb, vb)]
    lib_out = F.scaled_dot_product_attention(ql, kl, vl,
                                             scale=1.0 / MHA_SCALE)
    dob = do.to(torch.bfloat16).reshape(1, bh, n, d)
    _, saved = attention.mha_cuda(qb, kb, vb, MHA_SCALE, for_backward=True)
    _, saved32 = attention.mha_cuda(q, k, v, MHA_SCALE, for_backward=True)

    def fwd(a, b_, c, extras=True):
        return lambda: attention.mha_cuda(a, b_, c, MHA_SCALE,
                                          for_backward=extras)

    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    attention.mha_bwd_cuda(qb, kb, vb, MHA_SCALE, do, saved)
    bwd_peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    t_bytes = 4 * bh * n * d * 4 / PEAK_BYTES
    t_exp = bh * n * n / PEAK_EXP
    rows["mha"] = dict(
        shape=list(MHA_SHAPE), dtype="bfloat16",
        max_abs_err=errs[torch.bfloat16]["out"],
        max_abs_err_f32=errs[torch.float32]["out"],
        ms=cuda_ms(fwd(qb, kb, vb)),
        ms_forward_only=cuda_ms(fwd(qb, kb, vb, False)),
        ms_f32=cuda_ms(fwd(q, k, v)),
        ms_forward_only_f32=cuda_ms(fwd(q, k, v, False)),
        plain_ms=cuda_ms(lambda: attention.mha_plain(qb, kb, vb, MHA_SCALE),
                         50.0),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, scale=1.0 / MHA_SCALE)),
        **bound_row(t_bytes, max(4 * bh * n * n * d / PEAK_BF16, t_exp)),
        bound_parts_ms={"bytes": 1e3 * t_bytes, "exp": 1e3 * t_exp,
                        "tensor_core": 1e3 * 4 * bh * n * n * d / PEAK_BF16})
    t_bytes = 7 * bh * n * d * 4 / PEAK_BYTES
    rows["mha_bwd"] = dict(
        shape=list(MHA_SHAPE), dtype="bfloat16",
        max_abs_err=max(errs[torch.bfloat16][g] for g in ("dq", "dk", "dv")),
        max_abs_err_f32=max(errs[torch.float32][g]
                            for g in ("dq", "dk", "dv")),
        ms=cuda_ms(lambda: attention.mha_bwd_cuda(qb, kb, vb, MHA_SCALE, do,
                                                  saved)),
        ms_f32=cuda_ms(lambda: attention.mha_bwd_cuda(q, k, v, MHA_SCALE, do,
                                                      saved32)),
        peak_scratch_gb=bwd_peak_gb,
        plain_ms=cuda_ms(lambda: attention.mha_bwd_plain(qb, kb, vb,
                                                         MHA_SCALE, do),
                         50.0),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dob, retain_graph=True)),
        **bound_row(t_bytes, max(10 * bh * n * n * d / PEAK_BF16, t_exp)),
        bound_parts_ms={"bytes": 1e3 * t_bytes, "exp": 1e3 * t_exp,
                        "tensor_core": 1e3 * 10 * bh * n * n * d / PEAK_BF16})
    emit("attention_times", mha=rows["mha"], mha_bwd=rows["mha_bwd"])
    del q, k, v, do, qb, kb, vb, ql, kl, vl, dob, lib_out, saved, saved32
    torch.cuda.empty_cache()


def phase_adapt_kernels(gen, rows) -> None:
    """The kernels phase A adds, each against its plain version at the shapes
    the B=32, N=2048 ``gan_step`` gives it: the kNN (indices exact), the
    flash attention forward and backward (within TOL_MHA), the max-pooled
    ball-group kernels at the augmentor's grouper shapes (K=24, C up to
    1024) and on a cloud with ties and an empty ball, the fused SA (real
    pass) and the differentiable fused SA forward and backward (fake pass)
    at the frozen classifier's stages from N=2048, and the step's twelve row
    gathers and five scatter-adds at their own shapes and indices. Adds
    their rows to ``rows``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import knn
    from adaptpoint_tpu_torch.ops import fpsample as fps

    cloud = torch.randn((B, N_GAN, 3), generator=gen, device=DEV)
    cloud = cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    # the decode's levels: the cloud, its FPS half, then FPS-order prefixes
    order = fps.furthest_point_sample_cuda(cloud, N_GAN // 2)
    ref = fps.furthest_point_sample_plain(cloud, N_GAN // 2)
    mism = int((order != ref).sum())
    emit("kernel", name="fps", shape=[B, N_GAN, N_GAN // 2], mismatches=mism,
         tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                             f"(2048 -> 1024)")
    ms = cuda_ms(lambda: fps.furthest_point_sample_cuda(cloud, N_GAN // 2))
    rows["fps"]["gan_step_shape"] = dict(
        shape=[B, N_GAN, N_GAN // 2], ms=ms,
        ns_a_step=ms * 1e6 / (N_GAN // 2 - 1),
        **device_host(lambda: fps.furthest_point_sample_cuda(
            cloud, N_GAN // 2)),
        **bound_row((B * N_GAN * 12 + B * N_GAN // 2 * 4) / PEAK_BYTES,
                    (N_GAN // 2 - 1) * B * N_GAN * 10 / PEAK_F32))
    levels = [cloud, ops.index_points(cloud, order).contiguous()]
    for _, m, _, _ in GAN_STAGES[1:]:
        levels.append(levels[1][:, :m].contiguous())

    # ---- kNN: k=3 at the four FP-decode levels, k=24 for the 4 anchors;
    # then ties (repeated points) and k > N
    acc = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0,
               stand_in_ms=0.0, device_ms=0.0, host_us=0.0)
    cases = [(3, levels[i + 1], levels[i]) for i in range(4)]
    cases.append((24, levels[4], levels[0][:, :4].contiguous()))
    for k, support, query in cases:
        got = knn.knn_idx_cuda(k, support, query)
        ref = knn.knn_idx_plain(k, support, query)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        n, m = support.shape[1], query.shape[1]
        emit("kernel", name="knn", shape=[B, n, m, 3, k], mismatches=mism,
             tolerance="exact")
        if mism:
            raise AssertionError(f"kNN kernel disagrees at {mism} indices "
                                 f"(N={n}, M={m}, k={k})")
        t_b = (B * (n + m) * 12 + B * m * k * 4) / PEAK_BYTES
        t_o = B * m * n * 9 / PEAK_F32  # one expanded-form distance a pair
        row = dict(ms=cuda_ms(lambda: knn.knn_idx_cuda(k, support, query)),
                   plain_ms=cuda_ms(
                       lambda: knn.knn_idx_plain(k, support, query), 50.0),
                   variant=list(knn.knn_variant(k, n, 3)),
                   **device_host(lambda: knn.knn_idx_cuda(k, support, query)),
                   **bound_row(t_b, t_o))
        # a stand-in, not a library call for the same function: other
        # arithmetic (cdist) and its own tie rule
        row["stand_in_ms"] = cuda_ms(lambda: torch.topk(
            torch.cdist(query, support), k, dim=-1, largest=False))
        emit("stage_times", knn=row, shape=[B, n, m, 3, k])
        for key in ("ms", "plain_ms", "stand_in_ms"):
            acc[key] += row[key]
        acc["t_b"] += t_b
        acc["t_o"] += t_o
        for key in ("device_ms", "host_us"):  # None: not measured
            acc[key] = (None if acc[key] is None or row[key] is None
                        else acc[key] + row[key])
    tied = levels[3][:, :64].repeat(1, 2, 1).contiguous()  # every point twice
    for k, support, query in ((5, tied, levels[4]), (24, levels[4][:, :8]
                                                     .contiguous(), tied)):
        got = knn.knn_idx_cuda(k, support, query)
        ref = knn.knn_idx_plain(k, support, query)
        mism = int((got != ref).sum())
        emit("kernel", name="knn", case="ties" if k == 5 else "k > N",
             shape=[B, support.shape[1], query.shape[1], 3, k],
             mismatches=mism, tolerance="exact")
        if mism:
            raise AssertionError(f"kNN kernel disagrees ({k=}): {mism}")
    check_knn_edges(gen)
    acc.update(bound_row(acc.pop("t_b"), acc.pop("t_o")))
    rows["knn"] = acc

    check_attention(gen, rows)

    # ---- the max-pooled ball group, forward and backward, at the four
    # grouper shapes with f32 and with bf16 features (the bf16 policy's, as
    # the kernels take them), its launch shapes there and at their edges,
    # the op's launches on bf16 features, then a cloud with half its points
    # at the origin and an empty ball
    acc = {dt: (dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0,
                     t_o=0.0), dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0,
                                    t_b=0.0, t_o=0.0))
           for dt in (torch.float32, torch.bfloat16)}
    layouts = {}
    for i, (n, m, c, r) in enumerate(GAN_STAGES):
        qidx = (order if i == 0 else ops.fps_prefix_idx(B, m, DEV)) \
            .int().contiguous()
        layouts[f"grouper {i + 1}"] = check_bgmax_layout(n, m, c, K_GAN,
                                                         f"grouper {i + 1}")
        for dt in acc:
            feats = torch.randn((B, n, c), generator=gen, device=DEV).to(dt)
            rows_i = check_ball_group_max(gen, f"grouper {i + 1}", levels[i],
                                          qidx, feats, r)
            for a, row in zip(acc[dt], rows_i):
                for key in ("ms", "plain_ms", "t_b", "t_o"):
                    a[key] += row[key]
                a["max_abs_err"] = max(a["max_abs_err"], row["max_abs_err"])
            del feats
        if i == 0:
            op_launches = bgmax_op_launches(gen, levels[0], qidx, n, c, r)
        torch.cuda.empty_cache()
    # the launch shapes' edges: K = 1 and 255, C off the 16-byte vector, M
    # off the tile, N too large to stage
    for n, m, c, k in ((300, 37, 35, 1), (300, 37, 36, 255),
                       (16384, 100, 16, K_GAN), (2048, 1000, 130, K_GAN)):
        layouts[f"N={n} M={m} C={c} K={k}"] = check_bgmax_layout(
            n, m, c, k, "edge")
    emit("ball_group_max_layouts", layouts=layouts)
    n, m, c, r = GAN_STAGES[0]
    tied = stage_inputs(gen, [(n, m, c, 0, 0, r)], FAKE_DROPPED)[0]
    xyz, qidx, _ = tied
    xyz[1, 7] = 5.0  # far outside the unit sphere: its ball is empty
    qidx[1, 0] = 7
    for dt in acc:
        check_ball_group_max(gen, "ties and an empty ball", xyz, qidx,
                             torch.randn((B, n, c), generator=gen,
                                         device=DEV).to(dt), r, timed=False)
    del tied, xyz, qidx
    for name, j in (("ball_group_max", 0), ("ball_group_max_bwd", 1)):
        row16 = acc[torch.bfloat16][j]
        row16.update(bound_row(row16.pop("t_b"), row16.pop("t_o")))
        row = acc[torch.float32][j]
        row.update(bound_row(row.pop("t_b"), row.pop("t_o")))
        rows[name] = dict(shape=[B, N_GAN, K_GAN, "the four groupers, C "
                                 "128-1024, f32 features"], library_ms=None,
                          bf16=row16, op_launches_bf16=op_launches, **row)

    # ---- the frozen classifier's four stages at N_GAN points: the fused SA
    # kernel on whole clouds (the real pass), the differentiable fused SA
    # stage, forward and backward, on clouds with dropped points (the fake
    # pass), and FPS of such a cloud, whose dropped points all tie at the
    # origin
    real = stage_inputs(gen, GAN_CLS_STAGES)
    fake = stage_inputs(gen, GAN_CLS_STAGES, FAKE_DROPPED)
    ref = fps.furthest_point_sample_plain(fake[0][0], N_GAN // 2)
    mism = int((fake[0][1] != ref).sum())
    emit("kernel", name="fps", case="fake cloud", shape=[B, N_GAN, N_GAN // 2],
         dropped_share=float((fake[0][0].abs().sum(-1) == 0).float().mean()),
         mismatches=mism, tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices on a "
                             f"cloud with dropped points")
    shape = [B, N_GAN, K, "the classifier's four stages from N=2048"]
    _, sa_cls = check_stages_forward(gen, GAN_CLS_STAGES, None, real)
    rows["sa_eval"]["gan_classifier_shapes"] = dict(shape=shape, **sa_cls)
    rows["sa_train"], rows["sa_train_bwd"] = (
        dict(shape=shape, library_ms=None, **row)
        for row in check_sa_train(gen, GAN_CLS_STAGES, fake))
    del real, fake
    torch.cuda.empty_cache()
    check_sa_train_bwd_shapes(gen)
    check_sa_forward_shapes(gen)

    # ---- the row gathers of one gan_step, with the indices the step's own
    # searches give: (case, launches a step, N, C, idx, source has a gradient)
    idx24 = knn.knn_idx_cuda(24, levels[4], levels[0][:, :4].contiguous())
    gathers = [("anchors", 2, N_GAN, 3, order[:, :4], False),
               ("head kNN xyz", 1, 128, 3, idx24, False),
               ("head pooling", 1, 128, 1024, idx24, True)]
    for i, (_, m, c, _) in enumerate(GAN_STAGES):
        idx3 = knn.knn_idx_cuda(3, levels[i + 1], levels[i])  # (B, N_i, 3)
        gathers += [(f"decode {m} -> {2 * m} xyz", 1, m, 3, idx3, False),
                    (f"decode {m} -> {2 * m} features", 1, m, c, idx3, True)]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
            "library_device_ms")
    tot_f, tot_b = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    n_f = n_b = 0
    for tag, launches, n, c, idx, has_grad in gathers:
        f_row, b_row = check_gather(gen, tag, n, c, idx, dtypes=("float32",),
                                    distinct=tag == "anchors",
                                    min_total_ms=30.0)
        emit("stage_times", gather=tag, launches_a_step=launches,
             gather_rows=f_row, gather_rows_bwd=b_row if has_grad else None)
        n_f += launches
        n_b += int(has_grad)
        for key in keys:  # a time not measured leaves its sum None
            if tot_f[key] is not None:
                tot_f[key] = (None if f_row[key] is None
                              else tot_f[key] + launches * f_row[key])
            if has_grad and tot_b[key] is not None:
                tot_b[key] = (None if b_row[key] is None
                              else tot_b[key] + b_row[key])
        torch.cuda.empty_cache()
    rows["gather_rows"]["gan_step_shapes"] = dict(
        launches_a_step=n_f, bound_by="bytes", **tot_f)
    rows["gather_rows_bwd"]["gan_step_shapes"] = dict(
        launches_a_step=n_b, bound_by="bytes", **tot_b)

    # ---- the 3-NN weighted gather of the bf16 step's decode
    check_fpinterp(gen, levels, rows)
    rows["fpinterp_bwd"]["op_launches"], \
        rows["gather_rows_bwd"]["op_launches"] = scatter_op_launches(gen,
                                                                     levels)


def scatter_op_launches(gen, levels):
    """What one call of rows 13 and 15 puts on the card at the GAN step's
    shapes, from the profiler, by name: row 13 without d_w (as the step
    calls it) at the four decode levels, row 15 in f32 and bf16 at the head
    pooling and the four decode levels, on the step's own kNN indices. Each
    must be the one kernel (no memset, no rounding pass: ``scatter_rows``
    takes ORDERED or STAGED at these shapes). Row 15's result must equal
    its ordered plain function and a second launch bit for bit, with the
    rows no index names zero (``check_gather`` holds the f32 calls to the
    plain version too; row 13 is held in ``check_fpinterp``). Also each
    launch shape's shared memory, the host's copy
    (``scatter_rows.smem_bytes``) against the kernel's own, within the
    card's opt-in. Returns the device ops a call of each kernel, by
    shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptpoint_tpu_torch.ops import _build, knn
    from adaptpoint_tpu_torch.ops import fpinterp as fpi
    from adaptpoint_tpu_torch.ops import gather
    from adaptpoint_tpu_torch.ops import scatter_rows as sr

    def one_call(fn):
        for _ in range(2):  # the second call is the one counted
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        return {e.key[:60]: e.count for e in device_kernels(prof)}

    gather._bind()
    glib, flib = _build.load("gather"), fpi._lib()
    r13, r15, layouts = {}, {}, {}
    cases = [("head pooling", 128, 1024,
              knn.knn_idx_cuda(24, levels[4], levels[0][:, :4].contiguous()))]
    for i, (_, m, c, _) in enumerate(GAN_STAGES):
        idx3 = knn.knn_idx_cuda(3, levels[i + 1], levels[i]).int()
        n = idx3.shape[1]
        cases.append((f"decode {m} -> {n}", m, c, idx3))
        w = torch.rand((B, n, 3), generator=gen, device=DEV) + 0.1
        feat = torch.randn((B, m, c), generator=gen, device=DEV).to(
            torch.bfloat16)
        g = torch.randn((B, n, c), generator=gen, device=DEV)
        r13[f"decode {m} -> {n}"] = one_call(
            lambda: fpi.weighted_gather3_bwd_cuda(feat, idx3, w, g,
                                                  need_w=False))
        tl = sr.choose(B, 3 * n, m, c, True, 4, True)
        layouts[f"row 13 decode {m} -> {n}"] = [
            list(tl), sr.smem_bytes(tl, 3 * n, True, n),
            flib.weighted_gather3_bwd_smem_bytes(*tl, n)]
        del w, feat, g
    exact = {}
    for tag, rows_out, c, idx in cases:
        flat = idx.reshape(B, -1).int().contiguous()
        s = flat.shape[1]
        named = torch.zeros((B, rows_out), device=DEV).scatter_add_(
            1, flat.long(), torch.ones((B, s), device=DEV)) > 0
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn((B, s, c), generator=gen, device=DEV).to(dt)
            r15[f"{tag} {str(dt)[6:]}"] = one_call(
                lambda: gather.gather_rows_bwd_cuda(g, flat, rows_out))
            out = gather.gather_rows_bwd_cuda(g, flat, rows_out)
            exact[f"{tag} {str(dt)[6:]}"] = (
                torch.equal(out, gather.gather_rows_bwd_ordered(g, flat,
                                                                rows_out))
                and torch.equal(out, gather.gather_rows_bwd_cuda(g, flat,
                                                                 rows_out))
                and not bool(out[~named].any()))
            del out
            tl = sr.choose(B, s, rows_out, c, False, g.element_size(), True)
            layouts[f"row 15 {tag} {str(dt)[6:]}"] = [
                list(tl), sr.smem_bytes(tl, s, False),
                glib.gather_rows_bwd_smem_bytes(*tl, s)]
            del g
    emit("scatter_op_launches", row_13=r13, row_15=r15, layouts=layouts,
         row_15_equals_ordered_plain=exact,
         expected="one kernel a call, no memset; row 15 the ordered plain "
                  "function's bits and a second launch's, unnamed rows "
                  "zero; host and kernel shared memory equal, within the "
                  "opt-in")
    bad = [k for k, v in {**r13, **r15}.items() if sum(v.values()) != 1
           or "emset" in "".join(v)]
    bad += [k for k, ok in exact.items() if not ok]
    bad += [k for k, (_, host, dev) in layouts.items()
            if host != dev or dev > sr._SMEM_LIMIT]
    if bad:
        raise AssertionError(f"rows 13 and 15: {bad}")
    return ({k: sum(v.values()) for k, v in r13.items()},
            {k: sum(v.values()) for k, v in r15.items()})


def check_fpinterp(gen, levels, rows) -> None:
    """The 3-NN weighted gather (rows 12, 13) at the four feature-propagation
    levels of a B=32, N=2048 ``gan_step``, against its plain versions: on
    the real cloud's decode levels with some rows' neighbours made to repeat
    (slots 0 = 1 every 7th row, all three every 11th, 1 = 2 every 13th), and
    on a fake-like cloud with FAKE_DROPPED of its points at the origin
    (exact distance ties). Forward bit for bit; ``d_feat`` within the
    reordering bound of its f32 sums plus one bf16 ulp (entries beyond the
    bound counted), equal bit for bit to the ordered plain function (the
    kernel's sum order) and to a second launch, rows no slot names exactly
    zero; ``d_w`` within C * 2^-23 * sum|addend|; both directly and
    through autograd. Adds the rows ``fpinterp`` and ``fpinterp_bwd``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import fpinterp as fpi
    from adaptpoint_tpu_torch.ops import scatter_rows

    fake = stage_inputs(gen, [(N_GAN, N_GAN // 2, 3, 0, 0, 0.1)],
                        FAKE_DROPPED)[0]
    fake_levels = [fake[0], ops.index_points(fake[0], fake[1]).contiguous()]
    for _, m, _, _ in GAN_STAGES[1:]:
        fake_levels.append(fake_levels[1][:, :m].contiguous())
    keys = ("ms", "plain_ms", "composite_ms", "t_b")
    fwd, bwd = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    bwd.update(ms_with_d_w=0.0, t_b_with_d_w=0.0)
    worst = {"forward": 0.0, "d_feat": 0.0, "d_w": 0.0}
    for case, lv in (("repeated neighbours", levels), ("half at the origin",
                                                       fake_levels)):
        for i, (_, m, c, _) in enumerate(GAN_STAGES):
            n = 2 * m
            dist, idx = ops.three_nn(lv[i], lv[i + 1])
            recip = 1.0 / (dist + 1e-8)
            w = (recip / recip.sum(dim=2, keepdim=True)).contiguous()
            idx = idx.int().contiguous()
            if case == "repeated neighbours":
                rows_n = torch.arange(n, device=DEV)
                idx[:, rows_n % 7 == 0, 1] = idx[:, rows_n % 7 == 0, 0]
                idx[:, rows_n % 11 == 0, 1:] = idx[:, rows_n % 11 == 0, :1]
                idx[:, rows_n % 13 == 0, 2] = idx[:, rows_n % 13 == 0, 1]
            feat = torch.randn((B, m, c), generator=gen, device=DEV).to(
                torch.bfloat16)
            g = torch.randn((B, n, c), generator=gen, device=DEV)
            out = fpi.weighted_gather3_cuda(feat, idx, w)
            out_ref = fpi.weighted_gather3_plain(feat, idx, w)
            d_feat, d_w = fpi.weighted_gather3_bwd_cuda(feat, idx, w, g)
            d_feat_ref, d_w_ref = fpi.weighted_gather3_bwd_plain(feat, idx,
                                                                 w, g)
            # the kernel's own order (every design these shapes take):
            # the ordered plain function's bits, each launch the same
            again = fpi.weighted_gather3_bwd_cuda(feat, idx, w, g,
                                                  need_w=False)[0]
            named = torch.zeros((B, m), device=DEV).scatter_add_(
                1, idx.long().reshape(B, -1),
                torch.ones((B, n * 3), device=DEV))
            checks = {
                "design": scatter_rows.choose(B, 3 * n, m, c, True, 4,
                                              g.data_ptr() % 16 == 0).design,
                "equals_ordered_plain": bool(torch.equal(
                    d_feat, fpi.weighted_gather3_bwd_ordered(idx, w, g, m))),
                "two_launches_equal": bool(torch.equal(d_feat, again)),
                "unnamed_rows": int((named == 0).sum()),
                "unnamed_rows_zero": not bool(d_feat[named == 0].any())}
            del again, named
            # through autograd, as ops.three_interpolation calls it
            f_req, w_req = feat.clone().requires_grad_(), \
                w.clone().requires_grad_()
            auto = torch.autograd.grad(
                fpi.WeightedGather3.apply(f_req, idx, w_req, True),
                (f_req, w_req), g)
            # bounds: the f32 sums' reordering, each over its own addends
            hi, lo = fpi._split_weights(idx, w)
            gb = g.to(torch.bfloat16).float()
            terms = ((hi.abs() + lo.abs())[..., None]
                     * gb.abs()[:, :, None, :]).reshape(B, n * 3, c)
            rows3 = idx.long().reshape(B, n * 3, 1).expand(-1, -1, c)
            abs_sum = torch.zeros((B, m, c), device=DEV).scatter_add_(
                1, rows3, terms)
            count = torch.zeros((B, m, c), device=DEV).scatter_add_(
                1, rows3, (terms != 0).float())
            reorder = scatter_bound(count, abs_sum)
            big = torch.maximum(d_feat_ref.float().abs(),
                                d_feat.float().abs()).clamp(min=2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
            f_abs = ops.index_points(feat, idx).float().abs()
            dw_bound = c * EPS32 * (gb.abs()[:, :, None, :] * f_abs).sum(-1)
            del terms, rows3, f_abs
            torch.cuda.synchronize()
            mism = int((out != out_ref).sum())
            e_f = (d_feat.float() - d_feat_ref.float()).abs()
            e_fa = (auto[0].float() - d_feat_ref.float()).abs()
            e_w = (d_w - d_w_ref).abs()
            e_wa = (auto[1] - d_w_ref).abs()
            beyond = int((e_f > reorder).sum())
            ok = (mism == 0 and bool((e_f <= reorder + ulp).all())
                  and bool((e_fa <= reorder + ulp).all())
                  and bool((e_w <= dw_bound).all())
                  and bool((e_wa <= dw_bound).all())
                  and d_feat.dtype == torch.bfloat16
                  and bool(torch.isfinite(out).all())
                  and checks["equals_ordered_plain"]
                  and checks["two_launches_equal"]
                  and checks["unnamed_rows_zero"])
            errs = {"forward": float((out - out_ref).abs().max()),
                    "d_feat": float(e_f.max()),
                    "d_feat_autograd": float(e_fa.max()),
                    "d_w": float(e_w.max()), "d_w_autograd": float(e_wa.max())}
            for k in worst:
                worst[k] = max(worst[k], errs[k])
            emit("kernel", name="fpinterp", case=case, shape=[B, n, m, c],
                 forward_mismatches=mism, max_abs_err=errs, **checks,
                 d_feat_entries_beyond_reordering_bound=beyond,
                 of=d_feat.numel(),
                 repeated_rows=int((idx[..., 1] == idx[..., 0]).sum()
                                   + (idx[..., 2] == idx[..., 1]).sum()),
                 tolerance="forward bit for bit; d_feat <= n * 2^-23 * "
                           "sum|addend| + one bf16 ulp (the f32 sum may sit "
                           "on a rounding boundary) and the ordered plain "
                           "function's bits, the same bits each launch, "
                           "unnamed rows exactly zero; d_w <= C * 2^-23 * "
                           "sum|addend|")
            if not ok:
                raise AssertionError(f"weighted-gather kernels disagree "
                                     f"({case}, level {i}): {errs}, "
                                     f"{mism} forward mismatches, {checks}")
            if case != "repeated neighbours":
                continue
            # times on the path's inputs: the composite (gather, f32
            # multiply, sum: three calls) is the port's f32 route, timed as
            # context (no single PyTorch call computes this function)

            def composite(f=feat, ix=idx, ww=w):
                return (ops.index_points(f, ix) * ww[..., None]).sum(dim=2)

            f_c = feat.clone().requires_grad_()
            c_out = composite(f_c)
            fwd["ms"] += cuda_ms(lambda: fpi.weighted_gather3_cuda(feat, idx,
                                                                   w), 30.0)
            fwd["plain_ms"] += cuda_ms(
                lambda: fpi.weighted_gather3_plain(feat, idx, w), 30.0)
            fwd["composite_ms"] += cuda_ms(composite, 30.0)
            fwd["t_b"] += (B * m * c * 2 + B * n * 3 * 8 + B * n * c * 4) \
                / PEAK_BYTES
            bwd["ms"] += cuda_ms(lambda: fpi.weighted_gather3_bwd_cuda(
                feat, idx, w, g, need_w=False), 30.0)
            bwd["ms_with_d_w"] += cuda_ms(lambda: fpi.weighted_gather3_bwd_cuda(
                feat, idx, w, g), 30.0)
            bwd["plain_ms"] += cuda_ms(lambda: fpi.weighted_gather3_bwd_plain(
                feat, idx, w, g, need_w=False), 30.0)
            bwd["composite_ms"] += cuda_ms(lambda: torch.autograd.grad(
                c_out, f_c, g, retain_graph=True), 30.0)
            # without d_w the kernel reads no feat: g, idx+w in, d_feat out;
            # with it, feat in and d_w out as well
            bwd["t_b"] += (B * n * c * 4 + B * n * 3 * 8 + B * m * c * 2) \
                / PEAK_BYTES
            bwd["t_b_with_d_w"] += (B * m * c * 2 + B * n * 3 * 4) / PEAK_BYTES
            del c_out, f_c
        torch.cuda.empty_cache()
    shape = [B, N_GAN, "the decode's four levels: (N, M, C) = (256, 128, "
             "1024) .. (2048, 1024, 128)"]
    for name, acc, err in (("fpinterp", fwd, worst["forward"]),
                           ("fpinterp_bwd", bwd, max(worst["d_feat"],
                                                     worst["d_w"]))):
        if "t_b_with_d_w" in acc:
            acc["bound_ms_with_d_w"] = 1e3 * (acc["t_b"]
                                              + acc.pop("t_b_with_d_w"))
        acc.update(bound_row(acc.pop("t_b"), 0.0))
        rows[name] = dict(shape=shape, max_abs_err=err, library_ms=None,
                          **acc)
    emit("stage_times", fpinterp=rows["fpinterp"],
         fpinterp_bwd=rows["fpinterp_bwd"],
         note="ms summed over the four levels; the backward without d_w as "
              "the gan_step asks for it (ms_with_d_w with it); composite_ms: "
              "the port's f32 route (gather, multiply, sum), no library call")


def calibrate_bn(model, x):
    """Running statistics from one train-mode pass over ``x`` (momentum 1,
    dropout off so the pass is deterministic), so the random network's
    activations are unit scale and its BN folding is not the identity."""
    import torch
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    with torch.no_grad():
        model(x[..., :3].contiguous(), x.contiguous())
    for bn in bns:
        bn.momentum = 0.1
    return model.eval()


def post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def phase_serve(gen, out_dir):
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.serving import (ServingModel,
                                              export_serving_artifact,
                                              preprocess_clouds)
    from adaptpoint_tpu_torch.serving.server import make_server
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs/scanobjectnn/pointnext-s.yaml"),
             recursive=True)
    model = build_model_from_cfg(cfg.model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)

    def clouds(n):
        return preprocess_clouds(
            rng.standard_normal((n, N0, 3)).astype(np.float32)
            * np.array([1.0, 0.6, 0.3], np.float32))

    calibrate_bn(model, torch.from_numpy(clouds(B)).to(DEV))
    cpu = build_model_from_cfg(cfg.model, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    # The requests draw from a seeded pool and keep the clouds whose CPU
    # reference separates its top two classes by MARGIN on both routes: an
    # identical argmax is then a real check at the fused route's tolerance,
    # where a near-tie could flip on any reordering of the sums.
    requests = [1, 8, 32, 40]
    pool = clouds(POOL)
    refs = {}
    with torch.no_grad():
        for fused in (False, True):
            refs[fused] = np.concatenate([
                cpu(torch.from_numpy(c[..., :3]).contiguous(),
                    torch.from_numpy(c), fused_eval=fused).numpy()
                for c in np.split(pool, POOL // 32)])
    gap = np.minimum(*[np.diff(np.sort(r, -1)[:, -2:], axis=-1)[:, 0]
                       for r in refs.values()])
    keep = np.flatnonzero(gap >= MARGIN)
    emit("serve_pool", pool=POOL, margin=MARGIN, kept=int(keep.size),
         needed=sum(requests))
    if keep.size < sum(requests):
        raise AssertionError(f"only {keep.size} of {POOL} pool clouds have a "
                             f"top-2 gap >= {MARGIN}")

    expect = {False: {"fps": 1, "ball_group": 4, "sa_eval": 0},
              True: {"fps": 1, "ball_group": 0, "sa_eval": 4}}
    servers = {}
    ops.reset_launch_counts()  # the main path's run starts here
    for fused in (False, True):
        path = os.path.join(out_dir, "fused" if fused else "unfused")
        export_serving_artifact(model, path, num_points=N0, in_channels=4,
                                batch_sizes=(1, 8, 32), fused_eval=fused)
        sm = ServingModel(path)
        sm.warmup()
        srv = make_server(sm, port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        servers[fused] = (sm, srv, thread)
    try:
        for fused, (sm, srv, _) in servers.items():
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                health = json.load(r)
            if not health["ok"] or health["fused_eval"] != fused:
                raise AssertionError(f"bad /healthz: {health}")
            start = 0
            for n in requests:
                sel = keep[start:start + n]
                start += n
                x = pool[sel]
                buf = io.BytesIO()
                np.save(buf, x)
                before = ops.launch_counts()
                t0 = time.perf_counter()
                reply = post(f"{base}/predict?logits=1", buf.getvalue())
                req_ms = 1e3 * (time.perf_counter() - t0)
                after = ops.launch_counts()
                forwards = -(-n // 32)
                delta = {k: after[k] - before[k] for k in after}
                want = {k: expect[fused].get(k, 0) * forwards for k in after}
                logits = np.asarray(reply["logits"], np.float32)
                ref = refs[fused][sel]
                err = float(np.abs(logits - ref).max())
                top2 = np.sort(ref, axis=-1)[:, -2:]
                gap = float((top2[:, 1] - top2[:, 0]).min())
                same = bool((np.asarray(reply["labels"])
                             == ref.argmax(-1)).all())
                if fused:
                    ok_tol = bool((np.abs(logits - ref)
                                   <= TOL_SA * (1 + np.abs(ref))).all())
                else:
                    ok_tol = bool(np.allclose(logits, ref, rtol=TOL_UNFUSED[0],
                                              atol=TOL_UNFUSED[1]))
                emit("serve", route="fused" if fused else "unfused", n=n,
                     request_ms=req_ms, launches=delta, expected=want,
                     max_abs_err_vs_cpu=err, argmax_equal=same,
                     min_top2_gap=gap,
                     logits_absmax=float(np.abs(ref).max()),
                     tolerance=(f"|d| <= {TOL_SA} * (1 + |ref|)" if fused else
                                f"rtol {TOL_UNFUSED[0]} atol "
                                f"{TOL_UNFUSED[1]}"))
                if delta != want:
                    raise AssertionError(f"launches {delta} != {want}")
                if logits.shape != (n, 15) or not np.isfinite(logits).all():
                    raise AssertionError(f"bad logits {logits.shape}")
                if not (same and ok_tol):
                    raise AssertionError(
                        f"serve logits disagree with the CPU copy: max err "
                        f"{err}, argmax equal {same}")
    finally:
        for _, srv, thread in servers.values():
            srv.shutdown()
            srv.server_close()
            thread.join()
    launches = ops.launch_counts()  # the main path's run ends here
    emit("serve_done", params=n_params, launches=launches)
    if min(launches[k] for k in ("fps", "ball_group", "sa_eval")) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return {fused: sm for fused, (sm, _, _) in servers.items()}, launches


def device_kernels(prof):
    """The profile's device-side entries that are work on the card: kernels,
    copies and memsets, without the annotations (an optimizer's ``step``)
    that span them and would count their time twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def phase_throughput(models, gen):
    """ms per forward by CUDA events, the host's enqueue time, and from
    torch.profiler the device's busy time (kernels only) and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for b in (1, 8, 32):
        x = torch.randn((b, N0, 3), generator=gen, device=DEV)
        x = x / x.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        x = torch.cat([x, x[..., 1:2] - x[..., 1:2].amin(1, keepdim=True)], -1)
        for fused, sm in models.items():
            route = "fused" if fused else "unfused"
            ms = cuda_ms(lambda: sm.infer(x), 1000.0)
            reps = 10
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                sm.infer(x)
            enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    sm.infer(x)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / reps
            kernels = device_kernels(prof)
            busy_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            row = {"ms_per_forward": ms, "clouds_per_s": b * 1e3 / ms,
                   "host_enqueue_ms": enqueue_ms,
                   "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                   "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                   "kernels_per_forward": sum(e.count for e in kernels) / reps,
                   "top_kernels_ms": [[e.key[:48], e.self_device_time_total
                                       / 1e3 / reps] for e in top]}
            out[f"{route}_b{b}"] = row
            emit("throughput", route=route, batch=b, **row)
    return out


@contextlib.contextmanager
def plain_ops():
    """Inside, every dispatching op of ``adaptpoint_tpu_torch.ops`` takes its
    plain PyTorch version whatever the tensor's device: the comparison's
    reference on the card. Nothing of the port does this."""
    from adaptpoint_tpu_torch import ops
    on_cuda = ops._on_cuda
    ops._on_cuda = lambda t: False
    try:
        yield
    finally:
        ops._on_cuda = on_cuda


@contextlib.contextmanager
def fused_routes():
    """Inside, ``make_gan_step`` sends both classifier passes through the
    fused SA routes whatever the classifier's device and type: the float64
    CPU copy follows the card's route through the plain versions. Nothing of
    the port does this."""
    from adaptpoint_tpu_torch.engine import adapt_trainer
    gate = adapt_trainer._fused_ok
    adapt_trainer._fused_ok = lambda _model: True
    try:
        yield
    finally:
        adapt_trainer._fused_ok = gate


@contextlib.contextmanager
def policy_outputs(log: dict, generator, discriminator, classifier):
    """Inside, the output types of the modules the bf16 policy rounds at are
    counted in ``log`` under ``(net, site, dtype)``: the generator's
    BatchNorms, the discriminator's spectral-norm layers, and the
    classifier's pointwise convs (``policy`` ConvBlocks, which round, and the
    others, which compute in f32). Nothing of the port does this."""
    from adaptpoint_tpu_torch.adapt.discriminator import SpectralNormLinear
    from adaptpoint_tpu_torch.models.layers.blocks import BatchNorm, ConvBlock
    sites = [("G", "BatchNorm", m) for m in generator.modules()
             if isinstance(m, BatchNorm)]
    sites += [("D", "SpectralNormLinear", m) for m in discriminator.modules()
              if isinstance(m, SpectralNormLinear)]
    sites += [("C", "ConvBlock" if m.policy else "ConvBlock(policy=False)", m)
              for m in classifier.modules() if isinstance(m, ConvBlock)]

    def counter(net, site):
        def hook(_module, _inputs, out):
            key = (net, site, str(out.dtype).replace("torch.", ""))
            log[key] = log.get(key, 0) + 1
        return hook

    hooks = [m.register_forward_hook(counter(net, site))
             for net, site, m in sites]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def fps_choices(log: list, replay=None):
    """Inside, every ``ops.furthest_point_sample`` call appends its indices
    to ``log``; or, given a dict as ``replay``, returns the logged indices of
    the same call in their place and notes in the dict how many of its own
    picks differ. A reference step run this way differentiates the sampling
    the step under test made. Nothing of the port does this."""
    from adaptpoint_tpu_torch import ops
    own = ops.furthest_point_sample
    calls = iter(log) if replay is not None else None

    def wrapped(xyz, npoint):
        idx = own(xyz, npoint)
        if replay is None:
            log.append(idx)
            return idx
        logged = next(calls).to(idx.device)
        if logged.shape != idx.shape:
            raise AssertionError(f"FPS calls differ: {logged.shape} logged, "
                                 f"{idx.shape} asked")
        differ = logged != idx
        replay["calls"] = replay.get("calls", 0) + 1
        replay["picks"] = replay.get("picks", 0) + idx.numel()
        replay["picks_differ"] = replay.get("picks_differ", 0) \
            + int(differ.sum())
        replay["clouds_differ"] = replay.get("clouds_differ", 0) \
            + int(differ.any(dim=1).sum())
        return logged

    ops.furthest_point_sample = wrapped
    try:
        yield
    finally:
        ops.furthest_point_sample = own


@contextlib.contextmanager
def winner_choices(log: dict, replay=None):
    """Inside, every max-pooled ball group logs its bf16-rounded values and
    winning slots, and every differentiable fused SA stage its winning
    slots (``log["grouper"]``, ``log["fused_sa"]``, in call order), whichever
    version runs; or, given a dict as ``replay``, each plain version takes
    the logged choices of the same call in place of its own: the grouper its
    rounded values and winners, the fused SA its winners (its outputs read
    at those slots). It notes in the dict how many of its own differ. A
    reference step run this way takes the discrete decisions the step under
    test took (which way each bf16 rounding fell, which slot won each max)
    and differentiates the same branch of the function. Nothing of the port
    does this."""
    import torch
    from adaptpoint_tpu_torch.ops import ballgroup_max, saeval
    own = {(ballgroup_max, "ball_group_max_cuda"): "grouper",
           (ballgroup_max, "ball_group_max_plain"): "grouper",
           (saeval, "sa_train_cuda"): "fused_sa",
           (saeval, "sa_train_plain"): "fused_sa"}
    fns = {key: getattr(*key) for key in own}
    calls = {kind: iter(log.get(kind, [])) for kind in ("grouper",
                                                       "fused_sa")}

    def count(kind, key, mine, logged):
        row = replay.setdefault(kind, {"calls": 0})
        row["calls"] += key == "winners"
        row[key] = row.get(key, 0) + mine.numel()
        row[key + "_differ"] = row.get(key + "_differ", 0) + int(
            (mine != logged.to(mine)).sum())

    def at(values, slots):
        return torch.gather(values, 2, slots.long()[:, :, None]).squeeze(2)

    def grouper(fn):
        def wrapped(radius, nsample, xyz, query_idx, feats):
            out = fn(radius, nsample, xyz, query_idx, feats)
            if replay is None:
                log.setdefault("grouper", []).append(out[1:6])
                return out
            logged = [t.to(xyz.device) for t in next(calls["grouper"])]
            count("grouper", "winners", torch.stack(out[4:6]),
                  torch.stack(logged[3:]))
            count("grouper", "values", torch.stack(out[1:4]),
                  torch.stack(logged[:3]))
            return (out[0], *(t.to(feats.dtype) for t in logged[:3]),
                    *logged[3:], out[6])
        return wrapped

    def fused_sa(fn, plain):
        def wrapped(radius, nsample, xyz, query_idx, feats, *rest):
            out = fn(radius, nsample, xyz, query_idx, feats, *rest)
            if replay is None:
                log.setdefault("fused_sa", []).append(out[3])
                return out
            arg = next(calls["fused_sa"]).to(xyz.device)
            count("fused_sa", "winners", out[3], arg)
            o = saeval._slot_outputs(radius, nsample, xyz, query_idx, feats,
                                     *rest)[2]
            return out[:2] + (at(o, arg), arg, out[4])
        return wrapped if (plain or replay is None) else fn

    for (mod, name), kind in own.items():
        plain = name.endswith("_plain")
        if kind == "grouper":
            new = grouper(fns[(mod, name)]) if (plain or replay is None) \
                else fns[(mod, name)]
        else:
            new = fused_sa(fns[(mod, name)], plain)
        setattr(mod, name, new)
    try:
        yield
    finally:
        for (mod, name), fn in fns.items():
            setattr(mod, name, fn)


def blob_batches(rng, count: int, n: int = B, points: int = N_TRAIN,
                 axes=None):
    """``count`` seeded batches ``{"x" (n, points, 4), "y" (n,)}``. Each class
    is a gaussian blob with its own axis lengths (``axes`` (CLASSES, 3),
    drawn here when not given), each cloud a jittered copy: the labels can be
    learnt, and the clouds of a batch differ enough that a BatchNorm over the
    batch's rows does not divide by a near-zero spread."""
    import numpy as np
    from adaptpoint_tpu_torch.serving import preprocess_clouds
    if axes is None:
        axes = rng.uniform(0.15, 1.0, (CLASSES, 3)).astype(np.float32)
    out = []
    for _ in range(count):
        y = rng.integers(0, CLASSES, (n,)).astype(np.int64)
        scale = axes[y] * rng.uniform(0.8, 1.25, (n, 3)).astype(np.float32)
        x = preprocess_clouds(
            rng.standard_normal((n, points, 3)).astype(np.float32)
            * scale[:, None, :])
        out.append({"x": x, "y": y})
    return out


def adam_slack(grad, lr: float, rtol: float, atol, eps: float = 1e-8):
    """How far the first Adam update ``lr * g / (|g| + eps)`` can move when
    ``g`` is only known to ``atol + rtol * |g|``: first order in that error,
    capped at ``2 lr``. Adam divides a gradient by its own size, so an entry
    whose gradient is as small as its tolerance moves by up to lr either way;
    for ordinary gradients this allowance is nothing."""
    g = grad.abs().double()
    delta = atol + rtol * g
    return lr * (eps * delta / (g + eps) ** 2).clamp(max=2.0)


def phase_train(gen):
    """Classifier training at full width through the entry points a user
    calls. Returns the launch counts of this path's run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                             make_eval_step, make_train_step,
                                             train_one_epoch, validate)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.ops.gather import gather_rows_bwd_plain
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs/scanobjectnn/pointnext-s.yaml"),
             recursive=True)
    lr = float(cfg.lr)
    rng = np.random.default_rng(1)

    axes = rng.uniform(0.15, 1.0, (CLASSES, 3)).astype(np.float32)
    batches = blob_batches(rng, TRAIN_BATCHES, axes=axes)
    model = build_model_from_cfg(cfg.model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())

    def copy_of(device, dtype=torch.float32):
        twin = build_model_from_cfg(cfg.model, device=device).to(dtype)
        twin.load_state_dict({k: v.to(device) for k, v in
                              model.state_dict().items()})
        return twin

    # (a) the first step, taken three times from the same weights with the
    # same columns and dropout masks: on the card through the kernels (the
    # main path), on the card through the plain versions, and on a float64
    # CPU copy through the plain versions
    host_gen = torch.Generator().manual_seed(2)
    cols = torch.randperm(N_FPS, generator=host_gen)[:N0]
    masks = [torch.rand((B, w), generator=host_gen) >= 0.5
             for w in cfg.model.cls_args.mlps]
    first = {k: torch.from_numpy(v) for k, v in batches[0].items()}

    def first_step(net, device, dtype=torch.float32, step=None, st=None):
        if step is None:
            crit, opt, _ = build_train_tools(cfg, net)
            step, st = make_train_step(net, opt, crit, cfg), TrainState(net,
                                                                         opt)
        seen = {}
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        _, loss_, preds_ = step(
            st,
            {"x": first["x"].to(device, dtype), "y": first["y"].to(device)},
            cols.to(device), lr, dropout_mask=[m.to(device) for m in masks])
        hook.remove()
        return {"loss": float(loss_), "preds": preds_.cpu(),
                "logits": seen["logits"].double().cpu(),
                "grads": {n: p.grad.double().cpu()
                          for n, p in net.named_parameters()},
                "params": {n: p.detach().double().cpu()
                           for n, p in net.named_parameters()},
                "buffers": {n: b_.double().cpu()
                            for n, b_ in net.named_buffers()}}

    plain_twin, cpu_twin = copy_of(DEV), copy_of("cpu", torch.float64)
    ops.reset_launch_counts()  # this path's run starts here
    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    train_step = make_train_step(model, optimizer, criterion, cfg)
    state = TrainState(model, optimizer)
    got = first_step(model, DEV, step=train_step, st=state)
    torch.cuda.synchronize()
    per_step = ops.launch_counts()
    with plain_ops():
        ref_plain = first_step(plain_twin, DEV)
    ref_cpu = first_step(cpu_twin, "cpu", torch.float64)
    if ops.launch_counts() != per_step:
        raise AssertionError("a plain-version step launched a kernel")
    del plain_twin, cpu_twin
    want = {**dict.fromkeys(ops.KERNEL_MODULES, 0), "fps": 2,
            "gather_rows": 1, "ball_group": 4, "ball_group_bwd": 4}

    def compare(ref, tol):
        """Worst disagreements of ``got`` with ``ref`` and whether all are
        within ``tol``. A gradient tensor is held to a relative 2-norm: a
        max-pool hands its gradient to the row with the maximum, and where two
        rows tie to within f32 noise another row may win, so single entries
        can differ outright. After Adam every entry is within one step's
        reach (2 lr) of its counterpart, and ``share`` of each tensor's
        entries within the tight bound plus ``adam_slack``."""
        w = {"loss": abs(got["loss"] - ref["loss"]),
             "logits": float((got["logits"] - ref["logits"]).abs().max()),
             "grad_rel_l2": ("", 0.0), "param_share_outside": ("", 0.0),
             "param_abs": ("", 0.0), "buffer_abs": ("", 0.0)}
        good = (w["loss"] <= tol["loss"] * abs(ref["loss"])
                and bool(torch.allclose(got["logits"], ref["logits"],
                                        rtol=tol["logits"][0],
                                        atol=tol["logits"][1])))

        def note(key, name, value):
            if value > w[key][1]:
                w[key] = (name, value)

        # a gradient that cancels to nothing (a bias the next BatchNorm
        # removes) has no scale of its own: floor each tensor's scale at a
        # thousandth of the whole gradient's
        total = float(torch.cat([g_.flatten() for g_ in ref["grads"].values()]
                                ).norm())
        count = sum(g_.numel() for g_ in ref["grads"].values())
        for name, ref_g in ref["grads"].items():
            d = got["grads"][name] - ref_g
            l2 = float(d.norm() / max(float(ref_g.norm()), 1e-3 * total))
            note("grad_rel_l2", name, l2)
            ref_p = ref["params"][name]
            tight = TOL_STEP_PARAMS[1] + TOL_STEP_PARAMS[0] * ref_p.abs()
            dp = (got["params"][name] - ref_p).abs()
            slack = adam_slack(
                ref_g, lr, tol["grad_l2"], tol["grad_l2"] * max(
                    float(ref_g.abs().max()), total / count ** 0.5))
            outside = float((dp > tight + slack).double().mean())
            note("param_share_outside", name, outside)
            note("param_abs", name, float(dp.max()))
            good = (good and l2 <= tol["grad_l2"]
                    and outside <= 1 - tol["share"]
                    and bool((dp <= tight + 2.02 * lr).all()))
        for name, ref_b in ref["buffers"].items():
            if name.endswith("num_batches_tracked"):
                good = good and int(got["buffers"][name]) == int(ref_b) == 1
                continue
            note("buffer_abs", name,
                 float((got["buffers"][name] - ref_b).abs().max()))
            good = good and bool(torch.allclose(
                got["buffers"][name], ref_b, rtol=tol["buffers"][0],
                atol=tol["buffers"][1]))
        return w, good

    w_plain, ok_plain = compare(ref_plain, TOL_STEP_PLAIN)
    w_cpu, ok_cpu = compare(ref_cpu, TOL_STEP_CPU)
    emit("train_first_step", params=n_params, loss=got["loss"],
         plain_loss=ref_plain["loss"], cpu_f64_loss=ref_cpu["loss"],
         logits_absmax=float(ref_cpu["logits"].abs().max()),
         preds_equal=bool((got["preds"] == ref_cpu["preds"]).all()),
         against_plain_versions_on_the_card=w_plain,
         against_float64_cpu_copy=w_cpu,
         launches=per_step, expected=want,
         tolerance={"against_plain_versions_on_the_card": TOL_STEP_PLAIN,
                    "against_float64_cpu_copy": TOL_STEP_CPU,
                    "params": f"all within rtol {TOL_STEP_PARAMS[0]} atol "
                              f"{TOL_STEP_PARAMS[1]} + 2 lr; `share` of each "
                              f"tensor within rtol/atol + adam_slack"})
    if per_step != want:
        raise AssertionError(f"launches in one train step {per_step} != "
                             f"{want}")
    if not (ok_plain and ok_cpu and np.isfinite(got["loss"])):
        raise AssertionError(f"the first train step disagrees: with the "
                             f"plain versions {w_plain}, with the CPU copy "
                             f"{w_cpu}")

    # the epoch loop and both eval routes
    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    state, mean_loss, macc, oa, _, cm = train_one_epoch(
        train_step, state, batches, dev_gen, lr_fn(0), cfg)
    epoch_s = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in ops.launch_counts().items()}
    want_epoch = {k: v * TRAIN_BATCHES for k, v in want.items()}
    emit("train_epoch", steps=TRAIN_BATCHES, mean_loss=mean_loss, oa=oa,
         macc=macc, counted=int(cm.value.sum()), seconds=epoch_s,
         launches=got, expected=want_epoch)
    if got != want_epoch or int(cm.value.sum()) != TRAIN_BATCHES * B \
            or not np.isfinite(mean_loss):
        raise AssertionError(f"train_one_epoch: launches {got}, counted "
                             f"{int(cm.value.sum())}, loss {mean_loss}")
    val = blob_batches(rng, 2, 64, N0, axes)
    val[1]["n_valid"] = 40
    for fused in (False, True):
        before = ops.launch_counts()
        macc, oa, _, cm = validate(make_eval_step(model, cfg, fused), state,
                                   val, cfg)
        got = {k: v - before[k] for k, v in ops.launch_counts().items()
               if v - before[k]}
        want_val = {"fps": 2, "sa_eval" if fused else "ball_group": 8}
        emit("validate", route="fused" if fused else "unfused", oa=oa,
             macc=macc, counted=int(cm.value.sum()), launches=got,
             expected=want_val)
        if got != want_val or int(cm.value.sum()) != 64 + 40:
            raise AssertionError(f"validate: launches {got}, counted "
                                 f"{int(cm.value.sum())}")

    # (b) one fixed batch for FIT_STEPS steps. SmoothCrossEntropy cannot go
    # below the entropy of its smoothed target, so the loss that must halve is
    # the loss above that floor.
    eps_ls = float(cfg.criterion_args.label_smoothing)
    floor = -((1 - eps_ls) * np.log(1 - eps_ls)
              + eps_ls * np.log(eps_ls / (CLASSES - 1)))
    fixed = {k: torch.from_numpy(v).to(DEV) for k, v in batches[1].items()}
    losses = []
    for _ in range(FIT_STEPS):
        state, loss, _ = train_step(state, fixed, dev_gen, lr)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    emit("train_fit", steps=FIT_STEPS, first_loss=losses[0],
         last_loss=losses[-1], loss_floor=floor,
         excess_ratio=(losses[-1] - floor) / (losses[0] - floor),
         losses=[round(v, 4) for v in losses])
    if not (np.isfinite(losses).all()
            and losses[-1] - floor < 0.5 * (losses[0] - floor)):
        raise AssertionError(f"the loss on a fixed batch did not halve its "
                             f"excess over the floor {floor}: {losses}")

    # (d) the gather's backward kernel: the classifier step never asks for
    # it (a batch carries no gradient), ops.fps on a tensor that does
    pts = fixed["x"].clone().requires_grad_()
    g = torch.randn((B, N_FPS, 4), generator=gen, device=DEV)
    before = ops.launch_counts()
    out = ops.fps(pts, N_FPS)
    (g_pts,) = torch.autograd.grad(out, pts, g)
    got = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v - before[k]}
    with torch.no_grad():
        idx = ops.furthest_point_sample(pts[..., :3], N_FPS)
    ref = gather_rows_bwd_plain(g, idx, N_TRAIN)
    err = float((g_pts - ref).abs().max())
    emit("train_fps_grad", shape=[B, N_TRAIN, 4, N_FPS], launches=got,
         max_abs_err=err, tolerance="exact (FPS rows are distinct)")
    if got != {"fps": 1, "gather_rows": 1, "gather_rows_bwd": 1} or err:
        raise AssertionError(f"gradient through ops.fps: launches {got}, "
                             f"max err {err}")
    launches = ops.launch_counts()  # this path's run ends here
    emit("train_done", launches=launches)

    # ms per train step (CUDA events after a warm-up), then the profiler
    dev_batches = [{k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
                   for b in batches]
    it = [0]

    def one_step():
        train_step(state, dev_batches[it[0] % TRAIN_BATCHES], dev_gen, lr)
        it[0] += 1

    ms = cuda_ms(one_step, 1000.0)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_step()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit("train_throughput", batch=B, points=N_TRAIN, ms_per_step=ms,
         clouds_per_s=B * 1e3 / ms, host_enqueue_ms=enqueue_ms,
         profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         kernels_per_step=sum(e.count for e in kernels) / reps,
         top_kernels_ms=[[e.key[:48], e.self_device_time_total / 1e3 / reps]
                         for e in top])
    return launches


def adapt_setup(gen):
    """What both phase-A paths start from: the configuration, seeded
    (32, 2048, 4) batches, the initial weights of the augmentor, the
    discriminator and the frozen classifier (seeded, BN statistics from one
    pass), and the first step's draws, free of near-ties of the hard
    keep/drop choice under both compute policies."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.adapt import draw_wolf
    from adaptpoint_tpu_torch.engine import GanDraws, build_gan
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig
    from adaptpoint_tpu_torch.utils.precision import dtype_override

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT,
                          "cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml"),
             recursive=True)
    rng = np.random.default_rng(4)
    batches = blob_batches(rng, TRAIN_BATCHES, B, N_GAN)
    first = {k: torch.from_numpy(v) for k, v in batches[0].items()}

    # the frozen classifier: seeded weights, BN statistics from one pass
    cls_model = build_model_from_cfg(cfg.model, seed=1)
    calibrate_bn(cls_model, first["x"][:, :N0].to(DEV))
    _, _, _, _, state = build_gan(cfg, seed=5)
    n_params = {"generator": sum(p.numel() for p in
                                 state.generator.parameters()),
                "discriminator": sum(p.numel() for p in
                                     state.discriminator.parameters())}
    # the weights every copy starts from
    init = [copy.deepcopy(m.state_dict()) for m in
            (state.generator, state.discriminator, cls_model)]

    host_gen = torch.Generator().manual_seed(6)
    wolf = draw_wolf(host_gen, B, 4, "cpu")
    u = torch.rand((B, N_GAN, 2), generator=host_gen).clamp_(min=1e-20)
    draws = GanDraws(
        wolf, -torch.log(-torch.log(u)),
        [torch.rand((B, w), generator=host_gen) >= 0.4 for w in (512, 256)],
        [torch.rand((2 * B, w), generator=host_gen) >= 0.4
         for w in (512, 256)])

    # The hard keep/drop choice is argmax(logits + gumbel) at tau 0.1, on
    # logits that pass a bf16 attention: a point whose two noisy logits tie
    # to within the arithmetic's error can fall either way, and then that
    # cloud's FPS, balls and max-pool winners follow, which no tolerance on a
    # gradient survives. The draws are this check's input, so they are chosen
    # free of near-ties: a copy of the generator gives the logits under each
    # policy, and where either's noisy logits are closer than MASK_MARGIN the
    # noise moves both gaps apart by 2 MASK_MARGIN, towards the side of the
    # larger gap (then both gaps are at least MASK_MARGIN, on one side, and
    # the f32 and bf16 steps choose alike).
    scout = copy.deepcopy(state.generator).train()
    seen = []
    hook = scout.predict_prob_layer.fuse_masking.register_forward_hook(
        lambda _m, _i, out: seen.append(out.detach().float().cpu()))
    pc = first["x"][..., :3].to(DEV).contiguous()
    fps_idx = ops.furthest_point_sample(pc, N_GAN // 2)
    wolf_dev = type(wolf)(wolf.drop.to(DEV), wolf.axis_code.to(DEV),
                          wolf.proj_code.to(DEV))
    with torch.no_grad():
        for precision in ("f32", "bf16"):
            with dtype_override(precision):
                scout(pc, wolf_dev, draws.gumbel.to(DEV),
                      first_fps_idx=fps_idx)
    hook.remove()
    gaps = [(logits + draws.gumbel) for logits in seen]
    gaps = torch.stack([g[..., 0] - g[..., 1] for g in gaps])  # (2, B, N)
    near = (gaps.abs() < MASK_MARGIN).any(dim=0)
    larger = torch.gather(gaps, 0, gaps.abs().argmax(dim=0)[None])[0]
    draws.gumbel[..., 0] += 2 * MASK_MARGIN * near * torch.where(
        larger >= 0, 1.0, -1.0)
    emit("adapt_draws", margin=MASK_MARGIN, moved_points=int(near.sum()),
         of=near.numel(),
         sides_differ_between_policies=int(
             ((gaps[0] >= 0) != (gaps[1] >= 0)).sum()))
    del scout, seen, state, cls_model
    return {"cfg": cfg, "batches": batches, "first": first, "init": init,
            "n_params": n_params, "draws": draws,
            "hardratio": float(cfg.adaptpoint_params.hardratio)}


def tensor_fingerprints(obj) -> list:
    """Every tensor in ``obj`` (nested tuples, lists, dicts) as two sums over
    its bits on the card, plain and weighted by position (int64, wrapping),
    which any changed bit moves; with its shape."""
    import torch
    if torch.is_tensor(obj):
        x = obj.detach().contiguous().reshape(-1)
        if x.numel() == 0:
            return []
        v = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[x.element_size()]).to(torch.int64)
        pos = torch.arange(1, v.numel() + 1, device=v.device)
        return [(tuple(obj.shape), torch.stack([v.sum(), (v * pos).sum()]))]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [f for o in obj for f in tensor_fingerprints(o)]
    return []


@contextlib.contextmanager
def kernel_fingerprints(log: list):
    """Inside, every hand-written kernel's wrapper (each ``*_cuda`` function
    of the modules of ``ops.KERNEL_MODULES``) appends ``(name, fingerprints
    of its tensor inputs, of its tensor outputs)`` to ``log``
    (``tensor_fingerprints``). Nothing of the port does this."""
    from adaptpoint_tpu_torch import ops
    saved = []
    for mod in {m for m, _ in ops.KERNEL_MODULES.values()}:
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_cuda") and callable(fn)):
                continue

            def wrapped(*args, _fn=fn, _name=mod.__name__.split(".")[-1]
                        + "." + name, **kw):
                ins = tensor_fingerprints((args, kw))
                out = _fn(*args, **kw)
                log.append((_name, ins, tensor_fingerprints(out)))
                return out

            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# the wrappers of the scatters that add with atomics, kept on purpose
# (ROADMAP "Kept on purpose"): rows 4, 6, 8, 18 and 19
KEPT_ATOMIC_SCATTERS = {"ballgroup.ball_group_bwd_cuda",
                        "saeval.sa_train_bwd_cuda",
                        "ballgroup_max.ball_group_max_bwd_cuda",
                        "satrainbn.bwd_w2_cuda", "satrainbn.bwd_x_cuda"}


def gan_run_to_run(fresh, cfg, dev_batches, hardratio, steps: int = 10):
    """ROADMAP C.5: phase A's step run twice from the same weights, optimizer
    state, draws (a device generator of one seed) and batches for ``steps``
    steps. After each step the losses, then G's, then D's parameters are
    compared bit for bit; where the runs first part: the step, the tensor
    and how far (max |a - b|, and over max |b|), and how far apart every
    tensor is after the last step. The first step of both runs also logs
    each kernel wrapper's inputs and outputs (``kernel_fingerprints``): the
    first call whose outputs part while its inputs agree names that kernel;
    inputs that part first name the PyTorch code since the call before."""
    import torch
    from adaptpoint_tpu_torch.engine import make_gan_step

    runs = []
    for _ in range(2):
        st, cls_model = fresh(DEV)
        step = make_gan_step(st.generator, st.discriminator, st.g_opt,
                             st.d_opt, cls_model, cfg)
        dev_gen = torch.Generator(device=DEV).manual_seed(11)
        log, trace = [], []
        for i in range(steps):
            with (kernel_fingerprints(log) if i == 0
                  else contextlib.nullcontext()):
                st, _, metrics = step(st, dev_batches[i % len(dev_batches)],
                                      dev_gen, hardratio)
            snap = {"loss." + k: v.detach().clone()
                    for k, v in metrics.items()}
            for t, net in (("G", st.generator), ("D", st.discriminator)):
                snap.update({f"{t}.{n}": p.detach().clone()
                             for n, p in net.named_parameters()})
            trace.append(snap)
        log = [(name, [(sh, f.cpu()) for sh, f in ins],
                [(sh, f.cpu()) for sh, f in outs]) for name, ins, outs in log]
        runs.append((log, trace))
        del st, cls_model, step
        torch.cuda.empty_cache()
    (log_a, trace_a), (log_b, trace_b) = runs

    def apart(a, b):
        d = float((a.double() - b.double()).abs().max())
        return d, d / max(float(b.double().abs().max()), 1e-30)

    parted = None
    for i, (a, b) in enumerate(zip(trace_a, trace_b)):
        for k in a:  # the losses, then G's, then D's parameters
            if not torch.equal(a[k], b[k]):
                d, rel = apart(a[k], b[k])
                parted = {"step": i + 1, "tensor": k, "max_abs": d,
                          "relative": rel}
                break
        if parted:
            break
    final = {k: apart(a, trace_b[-1][k]) for k, a in trace_a[-1].items()}
    worst = max(final.items(), key=lambda kv: kv[1][1])

    def same(x, y):
        return len(x) == len(y) and all(
            sa == sb and torch.equal(fa, fb) for (sa, fa), (sb, fb)
            in zip(x, y))

    kernel = {"calls": [len(log_a), len(log_b)], "first": None}
    for i, ((na, ia, oa), (nb, ib, ob)) in enumerate(zip(log_a, log_b)):
        if na != nb:
            kernel["first"] = {"call": i, "name": na, "other": nb,
                               "finding": "the runs called other kernels"}
        elif not same(ia, ib):
            kernel["first"] = {
                "call": i, "name": na,
                "after": log_a[i - 1][0] if i else None,
                "inputs_apart": [j for j, (x, y) in enumerate(zip(ia, ib))
                                 if not torch.equal(x[1], y[1])],
                "finding": "inputs part on equal earlier outputs: PyTorch "
                           "code between the two calls"}
        elif not same(oa, ob):
            kernel["first"] = {
                "call": i, "name": na,
                "outputs_apart": [(j, list(x[0])) for j, (x, y) in
                                  enumerate(zip(oa, ob))
                                  if not torch.equal(x[1], y[1])],
                "finding": "outputs part on equal inputs: this kernel"}
        if kernel["first"]:
            break
    return {"steps": steps, "first_parting": parted,
            "worst_after_last_step": [worst[0], *worst[1]],
            "tensors_apart_after_last_step": sum(
                1 for d, _ in final.values() if d > 0),
            "of": len(final), "first_step_kernel_calls": kernel}


def phase_adapt(gen, ctx, precision: str, f32_run=None):
    """Phase A of the AdaptPoint protocol at full width under
    ``gan_precision: precision``: the adversarial ``gan_step`` (augmentor,
    discriminator, frozen PointNeXt-S feedback) on seeded (32, 2048, 4)
    batches, through the entry points a user calls, from ``ctx``'s weights
    and draws (``adapt_setup``); then, in f32, phase B on phase A's output.
    The bf16 step is also held against the f32 step of ``f32_run`` (the f32
    path's return). Returns ``(launches of this path's run, {"first": the
    first step, "throughput": the timing row})``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.engine import (GanDraws, TrainState, build_gan,
                                             build_train_tools, make_gan_step,
                                             make_train_step, train_gan_epoch)
    from adaptpoint_tpu_torch.models import build_model_from_cfg

    bf16 = precision == "bf16"
    tag = "adapt_bf16" if bf16 else "adapt"
    cfg = copy.deepcopy(ctx["cfg"])
    cfg.gan_precision = precision
    lr_g = float(cfg.adaptpoint_params.lr_generator)
    lr_d = float(cfg.adaptpoint_params.lr_discriminator)
    batches, first, init = ctx["batches"], ctx["first"], ctx["init"]
    draws, hardratio = ctx["draws"], ctx["hardratio"]

    def fresh(device, dtype=torch.float32, step_cfg=cfg):
        """A copy of the GAN and the classifier from the initial weights on
        ``device``: ``(state, classifier)``."""
        g, d, _, _, st = build_gan(step_cfg, device=device)
        c = build_model_from_cfg(cfg.model, device=device)
        for dst, src in zip((g, d, c), init):
            dst.to(dtype)  # in place: the optimizers keep their parameters
            dst.load_state_dict({k: v.to(device) for k, v in src.items()})
        return st, c.eval()

    def twin(device, dtype=torch.float32, step_cfg=cfg):
        """``fresh``'s copy and its step (under ``step_cfg``)."""
        st, c = fresh(device, dtype, step_cfg)
        # the classifier's passes take the fused routes as on the card, in
        # every copy: the float64 one runs their plain versions in float64,
        # with the same bf16 roundings
        with fused_routes():
            return st, make_gan_step(st.generator, st.discriminator,
                                     st.g_opt, st.d_opt, c, step_cfg)

    def to_dev(d, device):
        w = d.wolf
        return GanDraws(
            type(w)(w.drop.to(device), w.axis_code.to(device),
                    w.proj_code.to(device)), d.gumbel.to(device),
            [m.to(device) for m in d.d_masks_g],
            [m.to(device) for m in d.d_masks_d])

    def first_step(st, step, device, dtype=torch.float32, clouds=None):
        """One step from the first batch and the draws. With ``clouds``, the
        generator's fake clouds take those values on the way forward while
        the gradient still flows to the generator (a straight-through
        substitution); the step's own clouds are what comes back as
        ``gen``."""
        batch = {"x": first["x"].to(device, dtype),
                 "y": first["y"].to(device)}
        own = {}
        if clouds is not None:
            def substitute(_module, _inputs, out):
                own["gen"] = out[1].detach()
                return out[0], out[1] + (clouds.to(out[1]) - out[1]).detach()
            hook = st.generator.register_forward_hook(substitute)
        st, fake, metrics = step(st, batch, to_dev(draws, device), hardratio)
        if clouds is not None:
            hook.remove()
        fake = own.get("gen", fake)
        nets = {"G": st.generator, "D": st.discriminator}
        return {
            "gen": fake.double().cpu(),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {f"{t}.{n}": p.grad.double().cpu()
                      for t, net in nets.items()
                      for n, p in net.named_parameters()},
            "params": {f"{t}.{n}": p.detach().double().cpu()
                       for t, net in nets.items()
                       for n, p in net.named_parameters()},
            "buffers": {f"{t}.{n}": b_.double().cpu()
                        for t, net in nets.items()
                        for n, b_ in net.named_buffers()}}

    def three_ways(kernel_state, kernel_step, step_cfg=cfg, float64=True):
        """The first step on the card through the kernels, then through the
        plain versions on the card and (with ``float64``) on a float64 CPU
        copy, each taking the kernel run's discrete choices
        (``winner_choices``; the copy also its FPS picks and clouds). Returns
        the steps (the copy's ``None`` without ``float64``), the launches of
        the kernel run, what each reference would have chosen itself, and
        the copy's seconds."""
        fps_log, log = [], {}
        own = {"plain": {}, "float64": {}, "float64_fps": {}}
        before = ops.launch_counts()
        with fps_choices(fps_log), winner_choices(log):
            got = first_step(kernel_state, kernel_step, DEV)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launched = {k: v - before[k] for k, v in counts.items()}
        plain_state, plain_step = twin(DEV, step_cfg=step_cfg)
        with plain_ops(), winner_choices(log, replay=own["plain"]):
            ref_plain = first_step(plain_state, plain_step, DEV)
        del plain_state, plain_step
        torch.cuda.empty_cache()  # the plain attention's (BH, N, N) tensors
        ref_cpu, seconds = None, 0.0
        if float64:
            # The frozen classifier is no continuous function of its input
            # cloud (ball memberships and max-pool winners flip; in float64
            # alone a 1e-6 perturbation of the clouds moves its input
            # gradient by a tenth), and every bf16 rounding of the groupers
            # and the fused SA is a step: so the copy's clouds are held to
            # the card's on their own (gen), and its gradient is taken at the
            # card's clouds, FPS picks, rounded grouper values and max-pool
            # winners: the same branch of the piecewise-smooth loss,
            # differentiated in float64.
            cpu_state, cpu_step = twin("cpu", torch.float64, step_cfg)
            t0 = time.perf_counter()
            with fps_choices(fps_log, replay=own["float64_fps"]), \
                    winner_choices(log, replay=own["float64"]):
                ref_cpu = first_step(cpu_state, cpu_step, "cpu",
                                     torch.float64, clouds=got["gen"])
            seconds = time.perf_counter() - t0
        if ops.launch_counts() != counts:
            raise AssertionError("a plain-version step launched a kernel")
        return got, ref_plain, ref_cpu, launched, own, seconds

    own_caps = OWN_CHOICES_BF16 if bf16 else OWN_CHOICES

    def own_choices(own):
        """The share of each reference's own discrete choices that differ
        from the kernel run's, and whether all are within ``own_caps``."""
        shares, good = {}, True
        for ref, caps in own_caps.items():
            rows = {**{f"grouper_{k}": (own[ref].get("grouper", {}), k)
                       for k in ("values", "winners")},
                    "fused_sa_winners": (own[ref].get("fused_sa", {}),
                                         "winners"),
                    "fps_picks": (own.get(ref + "_fps", {}), "picks")}
            for key, cap in caps.items():
                row, name = rows[key]
                if not row:
                    continue  # this reference did not run
                share = row[name + "_differ"] / row[name]
                shares[f"{ref}_{key}"] = share
                good = good and share <= cap
        return shares, good

    # per step: FPS of the raw cloud (shared) and of the fake cloud; 4
    # max-pooled groupers and 4 differentiable fused SA stages of the fake
    # pass, forward and backward; 4 fused SA stages of the real pass; the
    # mask head's attention; kNN of the deformation head and of 4 decode
    # levels; row gathers: 2 anchor gathers, the deformation head's kNN
    # recompute and its pooling, and a decode level's 3-NN recompute; their
    # scatter-adds where the source carries a gradient (the pooling); in
    # f32 each decode level also gathers its features (4 gathers, 4
    # scatter-adds), in bf16 it takes the weighted gather instead (4
    # forward, 4 backward); no plain ball group
    want = {**dict.fromkeys(ops.KERNEL_MODULES, 0), "fps": 2,
            "ball_group_max": 4, "ball_group_max_bwd": 4, "sa_train": 4,
            "sa_train_bwd": 4, "sa_eval": 4, "gather_rows": 8,
            "gather_rows_bwd": 1, "mha": 1, "mha_bwd": 1, "knn": 5}
    if bf16:
        want.update(fpinterp=4, fpinterp_bwd=4)
    else:
        want.update(gather_rows=12, gather_rows_bwd=5)

    def compare(got, ref, tol):
        """Worst disagreements of ``got`` with ``ref`` and whether all are
        within ``tol``. With draws free of near-ties the masks agree
        (``mask_flips``), so the clouds are held on every point, the metrics
        to a relative bound, and the gradients as in the train phase: each
        tensor's relative 2-norm, parameters within one Adam step's reach,
        ``share`` of each tensor's entries within the tight bound plus
        ``adam_slack``."""
        kept_a = got["gen"].abs().sum(-1) != 0
        kept_b = ref["gen"].abs().sum(-1) != 0
        both = (kept_a & kept_b)[..., None]
        w = {"mask_flips": int((kept_a != kept_b).sum()),
             "gen_abs": float(((got["gen"] - ref["gen"]).abs() * both).max()),
             "metric_rel": max((abs(got["metrics"][k] - v) / abs(v), k)
                               for k, v in ref["metrics"].items()),
             "buffer_abs": (0.0, "")}
        for net in "GD":
            for key in ("grad_rel_l2", "param_share_outside", "param_abs"):
                w[f"{net}_{key}"] = (0.0, "")
        good = (w["mask_flips"] <= tol["mask_flips"]
                and w["gen_abs"] <= tol["gen"]
                and w["metric_rel"][0] <= tol["metrics"])
        if "grad_l2_whole" not in tol:  # the clouds and metrics only
            return w, good

        def note(key, name, value):
            if value > w[key][0]:
                w[key] = (value, name)

        for net, lr in (("G", lr_g), ("D", lr_d)):
            names = [n for n in ref["grads"] if n.startswith(net + ".")]
            total = float(torch.cat([ref["grads"][n].flatten()
                                     for n in names]).norm())
            count = sum(ref["grads"][n].numel() for n in names)
            # a network held as a whole only has no per-tensor entries
            tol_g = tol["grad_l2"].get(net)
            diff = float(torch.cat([(got["grads"][n] - ref["grads"][n])
                                    .flatten() for n in names]).norm())
            w[f"{net}_grad_rel_l2_whole"] = diff / total
            good = good and diff / total <= tol["grad_l2_whole"][net]
            per_tensor = []
            for name in names:
                ref_g = ref["grads"][name]
                d = got["grads"][name] - ref_g
                l2 = float(d.norm() / max(float(ref_g.norm()),
                                          1e-3 * total))
                note(f"{net}_grad_rel_l2", name, l2)
                per_tensor.append((l2, name, float(ref_g.norm()) / total))
                ref_p = ref["params"][name]
                tight = TOL_STEP_PARAMS[1] + TOL_STEP_PARAMS[0] * ref_p.abs()
                dp = (got["params"][name] - ref_p).abs()
                note(f"{net}_param_abs", name, float(dp.max()))
                good = good and bool((dp <= tight + 2.02 * lr).all())
                if tol_g is None:
                    continue
                slack = adam_slack(ref_g, lr, tol_g, tol_g * max(
                    float(ref_g.abs().max()), total / count ** 0.5))
                outside = float((dp > tight + slack).double().mean())
                note(f"{net}_param_share_outside", name, outside)
                good = (good and l2 <= tol_g
                        and outside <= 1 - tol["share"][net])
            # the worst tensors: [error, name, its share of the whole norm]
            w[f"{net}_grad_worst_tensors"] = sorted(per_tensor)[-6:][::-1]
        for name, ref_b in ref["buffers"].items():
            if name.endswith("num_batches_tracked"):
                good = good and int(got["buffers"][name]) == int(ref_b) == 1
                continue
            note("buffer_abs", name,
                 float((got["buffers"][name] - ref_b).abs().max()))
            good = good and bool(torch.allclose(
                got["buffers"][name], ref_b, rtol=tol["buffers"][0],
                atol=tol["buffers"][1]))
        return w, good

    tol_plain = TOL_GAN16_PLAIN if bf16 else TOL_GAN_PLAIN
    tol_plain_fb = TOL_GAN16_PLAIN_FEEDBACK if bf16 \
        else TOL_GAN_PLAIN_FEEDBACK

    # (a1) without the feedback term: the generator's gradient comes from
    # the discriminator alone and is held on every tensor against the plain
    # versions on the card
    cfg_nofb = copy.deepcopy(cfg)
    cfg_nofb.feedbackloss_ratio = 0.0
    got_nofb, plain_nofb, _, _, own_nofb, _ = three_ways(
        *twin(DEV, step_cfg=cfg_nofb), cfg_nofb, float64=False)
    w_plain, ok_plain = compare(got_nofb, plain_nofb, tol_plain)
    shares, ok_own = own_choices(own_nofb)
    emit(f"{tag}_first_step_without_feedback", metrics=got_nofb["metrics"],
         against_plain_versions_on_the_card=w_plain,
         own_choices_of_the_references=own_nofb, own_choice_shares=shares,
         tolerance={"against_plain_versions_on_the_card": tol_plain,
                    "own_choice_shares": own_caps})
    if not (ok_plain and ok_own):
        raise AssertionError(f"the first {precision} gan_step without "
                             f"feedback disagrees: with the plain versions "
                             f"{w_plain}, own choices {shares}")
    del got_nofb, plain_nofb
    torch.cuda.empty_cache()

    # (a2) the step itself: the main path's run starts here
    state, cls_model = fresh(DEV)
    cls_before = {k: v.clone() for k, v in cls_model.state_dict().items()}
    ops.reset_launch_counts()
    gan_step = make_gan_step(state.generator, state.discriminator, state.g_opt,
                             state.d_opt, cls_model, cfg)
    policy_log = {}
    with policy_outputs(policy_log, state.generator, state.discriminator,
                        cls_model) if bf16 else contextlib.nullcontext():
        got, ref_plain, ref_cpu, per_step, own, cpu_seconds = three_ways(
            state, gan_step, float64=not bf16)
    w_plain, ok_plain = compare(got, ref_plain, tol_plain_fb)
    shares, ok_own = own_choices(own)
    # (b) the fake clouds: inside the unit sphere, dropped rows exactly zero,
    # and the mask neither empty nor full
    norms = got["gen"].norm(dim=-1)
    dropped = float((norms == 0).double().mean())
    report = dict(params=ctx["n_params"], metrics=got["metrics"],
                  plain_metrics=ref_plain["metrics"],
                  own_choices_of_the_references=own,
                  own_choice_shares=shares,
                  against_plain_versions_on_the_card=w_plain,
                  launches=per_step, expected=want,
                  gen_max_norm=float(norms.max()), dropped_share=dropped)
    tols = {"against_plain_versions_on_the_card": tol_plain_fb,
            "own_choice_shares": own_caps}
    ok_ref = True
    if bf16 and f32_run is not None:
        # the same weights and draws under the f32 policy: the clouds and
        # the six metrics, at bf16 grade
        w_f32, ok_ref = compare(got, f32_run["first"], TOL_BF16_VS_F32)
        ok_ref = (ok_ref
                  and w_f32["mask_flips"] >= FLOOR_BF16_VS_F32["mask_flips"]
                  and w_f32["gen_abs"] >= FLOOR_BF16_VS_F32["gen"])
        report["against_the_f32_step"] = w_f32
        tols["against_the_f32_step"] = TOL_BF16_VS_F32
        tols["against_the_f32_step_at_least"] = FLOOR_BF16_VS_F32
    if bf16:
        # the policy is in force on the card: each site gave its one type,
        # and every site fired
        seen = {(net, site): {} for net, site in POLICY_OUTPUTS}
        for (net, site, dt), n in policy_log.items():
            seen[(net, site)][dt] = n
        report["policy_outputs"] = {f"{k[0]}.{k[1]}": v
                                    for k, v in seen.items()}
        tols["policy_outputs"] = {f"{k[0]}.{k[1]}": v
                                  for k, v in POLICY_OUTPUTS.items()}
        ok_ref = ok_ref and all(list(seen[k]) == [dt]
                                for k, dt in POLICY_OUTPUTS.items())
    elif not bf16:
        w_cpu, ok_cpu = compare(got, ref_cpu, TOL_GAN_CPU_FEEDBACK)
        # how far f32 arithmetic alone (the plain versions on the card) sits
        # from float64: the kernels may be no further from float64 than that
        w_f32, _ = compare(ref_plain, ref_cpu, TOL_GAN_CPU_FEEDBACK)
        no_further = (w_cpu["G_grad_rel_l2_whole"]
                      <= FEEDBACK_NOISE * w_f32["G_grad_rel_l2_whole"] + 1e-2)
        ok_ref = ok_cpu and no_further
        report.update(cpu_f64_metrics=ref_cpu["metrics"],
                      cpu_f64_step_seconds=cpu_seconds,
                      against_float64_cpu_copy=w_cpu,
                      plain_versions_on_the_card_against_float64_cpu_copy=w_f32)
        tols.update(against_float64_cpu_copy=TOL_GAN_CPU_FEEDBACK,
                    G_whole_against_float64=f"<= {FEEDBACK_NOISE} x the "
                    f"plain versions' own + 1e-2")
    emit(f"{tag}_first_step", tolerance=tols, **report)
    if per_step != want:
        raise AssertionError(f"launches in one {precision} gan_step "
                             f"{per_step} != {want}")
    if not (float(norms.max()) <= 1.0 and 0.0 < dropped < 1.0
            and all(np.isfinite(v) for v in got["metrics"].values())):
        raise AssertionError(f"bad fake clouds: max norm {float(norms.max())}"
                             f", dropped share {dropped}")
    if not (ok_plain and ok_ref and ok_own):
        raise AssertionError(f"the first {precision} gan_step disagrees: "
                             f"{report}")
    first_result = {"gen": got["gen"], "metrics": got["metrics"]}
    del got, ref_plain, ref_cpu

    # (c) ten more steps: finite metrics; G, D and D's u move; the frozen
    # classifier does not
    start = {f"{t}.{n}": v.clone() for t, net in
             (("G", state.generator), ("D", state.discriminator))
             for n, v in net.state_dict().items()}
    dev_gen = torch.Generator(device=DEV).manual_seed(7)
    dev_batches = [{k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
                   for b in batches]
    rows = []
    for i in range(10):
        state, fake, metrics = gan_step(state, dev_batches[i % TRAIN_BATCHES],
                                        dev_gen, hardratio)
        rows.append(torch.stack(list(metrics.values())))
    rows = torch.stack(rows).cpu()
    now = {f"{t}.{n}": v for t, net in
           (("G", state.generator), ("D", state.discriminator))
           for n, v in net.state_dict().items()}
    # (a unit vector of one entry, the probability head's u, cannot move)
    moved = {k: not torch.equal(v, start[k]) for k, v in now.items()
             if not k.endswith("num_batches_tracked") and v.numel() > 1}
    frozen = all(torch.equal(v, cls_before[k])
                 for k, v in cls_model.state_dict().items())
    emit(f"{tag}_steps", steps=10, metric_names=list(metrics),
         first=rows[0].tolist(), last=rows[-1].tolist(),
         unmoved=[k for k, m in moved.items() if not m],
         classifier_unchanged=frozen, step=state.step)
    if not (bool(torch.isfinite(rows).all()) and all(moved.values())
            and frozen and state.step == 11):
        raise AssertionError(f"ten gan_steps: finite "
                             f"{bool(torch.isfinite(rows).all())}, unmoved "
                             f"{[k for k, m in moved.items() if not m]}, "
                             f"classifier unchanged {frozen}")
    got_l = ops.launch_counts()
    if got_l != {k: 11 * v for k, v in want.items()}:
        raise AssertionError(f"launches over eleven steps {got_l}")
    if bf16:
        # (d) ROADMAP C.5: where two runs of the step part. The spread is
        # reported, not held; the source is: where the runs part, the first
        # kernel whose outputs part on equal inputs must be one of the atomic
        # scatters kept on purpose. Its launches are not this path's.
        reading = gan_run_to_run(fresh, cfg, dev_batches, hardratio)
        emit(f"{tag}_run_to_run", **reading)
        first = reading["first_step_kernel_calls"]["first"]
        if reading["first_parting"] and not (
                first and "outputs_apart" in first
                and first["name"] in KEPT_ATOMIC_SCATTERS):
            raise AssertionError(f"two runs of the bf16 gan_step part, and "
                                 f"not first at a kept atomic scatter "
                                 f"{sorted(KEPT_ATOMIC_SCATTERS)}: {first}")
        for k, (mod, attr) in ops.KERNEL_MODULES.items():
            setattr(mod, attr, got_l[k])

    # (f) the epoch loop; in f32 then phase B on phase A's output: three
    # classifier train steps on the returned fake dataset
    t0 = time.perf_counter()
    state, fake_set, avg = train_gan_epoch(gan_step, state, batches, dev_gen,
                                           hardratio, cfg)
    epoch_s = time.perf_counter() - t0
    ok_set = (len(fake_set) == TRAIN_BATCHES * B
              and fake_set.x.shape == (TRAIN_BATCHES * B, N_GAN, 4)
              and bool(np.isfinite(fake_set.pointcloud).all())
              and all(np.isfinite(v) for v in avg.values()))
    losses = []
    if not bf16:
        criterion, optimizer, lr_fn = build_train_tools(cfg, cls_model)
        train_step = make_train_step(cls_model, optimizer, criterion, cfg)
        cls_state = TrainState(cls_model, optimizer)
        for i in range(3):
            rows_ = slice(i * B, (i + 1) * B)
            cls_state, loss, _ = train_step(
                cls_state,
                {"x": torch.from_numpy(fake_set.x[rows_]).to(DEV),
                 "y": torch.from_numpy(fake_set.label[rows_]).to(DEV)},
                dev_gen, lr_fn(0))
            losses.append(loss)
        losses = torch.stack(losses).cpu().tolist()
    launches = ops.launch_counts()  # this path's run ends here
    emit(f"{tag}_epoch", steps=TRAIN_BATCHES, seconds=epoch_s, averages=avg,
         fake_clouds=len(fake_set), phase_b_losses=losses, launches=launches)
    if not (ok_set and np.isfinite(losses).all()
            and (bf16 or cls_state.step == 3)):
        raise AssertionError(f"train_gan_epoch / phase B: dataset ok "
                             f"{ok_set}, losses {losses}")

    # (e) ms per gan_step (CUDA events after a warm-up), then the profiler
    it = [0]

    def one_step():
        gan_step(state, dev_batches[it[0] % TRAIN_BATCHES], dev_gen, hardratio)
        it[0] += 1

    cls_model.eval()
    ms = cuda_ms(one_step, 1000.0)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_step()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    own = {}  # the hand-written kernels: [launches, ms] a step, by name
    for e in kernels:
        for name in OWN_KERNELS:
            if name + "<" in e.key or name + "(" in e.key:
                acc = own.setdefault(name, [0.0, 0.0])
                acc[0] += e.count / reps
                acc[1] += e.self_device_time_total / 1e3 / reps
    timing = dict(
        ms_per_step=ms, clouds_per_s=B * 1e3 / ms, host_enqueue_ms=enqueue_ms,
        profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        kernels_per_step=sum(e.count for e in kernels) / reps,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        own_kernels_launches_and_ms=own,
        own_kernels_ms=sum(v[1] for v in own.values()),
        top_kernels_ms=[[e.key[:48], e.self_device_time_total / 1e3 / reps]
                        for e in top])
    emit(f"{tag}_throughput", batch=B, points=N_GAN, precision=precision,
         **timing, f32_step=None if f32_run is None else {
             k: f32_run["throughput"][k] for k in (
                 "ms_per_step", "host_enqueue_ms", "device_busy_ms",
                 "device_idle_share", "kernels_per_step", "peak_memory_gb")})
    return launches, {"first": first_result, "throughput": timing}


def trainbn_mask_flips(S, radius, xyz, qidx, feats, idx, w1, a1, nb1, rel,
                       norm_dp, mask) -> dict:
    """Where the forward kernel's ReLU mask differs from the plain forward's
    own ``a1 y1 + nb1 > 0``: the count of entries, and the largest |y1p|
    (float64) there over the f32 reordering bound of its W + 2 addends,
    (W + 2) 2^-23 (|a1| sum |v w1| + |nb1|): at most 1 where the two masks
    differ only because two orders of the same f32 sum fall on either side
    of zero."""
    v = S._rows(radius, xyz, qidx, feats, idx, rel, norm_dp).double()
    w = w1.double()
    y1p = (v @ w) * a1.double() + nb1.double()
    bound = (w.shape[0] + 2) * EPS32 * ((v.abs() @ w.abs())
                                        * a1.double().abs()
                                        + nb1.double().abs()) + 1e-30
    mid = w1.shape[1]
    plain = S._through_y2(radius, xyz, qidx, feats, idx, w1, a1, nb1,
                          w1.new_zeros((mid, 1)), rel, norm_dp)[2] > 0
    flips = S.unpack_mask(mask, mid) != plain
    n = int(flips.sum())
    return {"flips": n, "worst_over_bound": float(
        (y1p.abs() / bound)[flips].max()) if n else 0.0}


def trainbn_passes(gen, S, xyz, qidx, feats, w1, g1, b1, w2, g2, b2, radius,
                   rel, norm_dp, k, with_centers=True):
    """The four passes, kernels and plain versions, on one stage's inputs
    with seeded cotangents (pass 4 of both on the kernel's pass 3 outputs):
    ``(errs, ok, inputs)``, errs each output's max |kernel - plain| by pass
    plus the ReLU mask checks."""
    import torch
    Bq = xyz.shape[0]
    M, C, mid, cout = qidx.shape[1], feats.shape[2], w1.shape[1], w2.shape[1]
    n = Bq * M * k

    def err(a, b, tol, name, errs):
        d = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        scale = float(b.float().abs().max()) if b.numel() else 0.0
        errs[name] = d
        return d <= tol * max(scale, 1e-30)

    def same_bits(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    got = S.stats_cuda(radius, k, xyz, qidx, feats, rel, norm_dp)
    ref = S.stats_plain(radius, k, xyz, qidx, feats, rel, norm_dp)
    torch.cuda.synchronize()
    # rows 16 and 17 sum in a fixed order: a second launch, the same bits
    e1 = {"idx": float((got[0] != ref[0]).sum()),
          "same_bits_again": same_bits(got, S.stats_cuda(
              radius, k, xyz, qidx, feats, rel, norm_dp))}
    ok = e1["idx"] == 0 and e1["same_bits_again"]
    for name, a, b_ in (("sv", got[1], ref[1]), ("svv", got[2], ref[2])):
        ok = err(a, b_, TOL_TRAINBN["stats"], name, e1) and ok
    idx = got[0]
    mu1, var1, r1, a1, nb1 = S._bn1(got[1], got[2], w1, g1, b1, n, 1e-5)
    fargs = (radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, rel, norm_dp)
    got2 = S.fwd_cuda(*fargs)
    ref2 = S.fwd_plain(*fargs)
    # the forward's weight copies, which pass 3 reads: W1^T and W2^T, their
    # rows padded with zeros to multiples of 8
    wt = got2[9]
    copies = torch.cat([S._padded(w.float().t(), (w.shape[0] + 7) // 8 * 8)
                        .reshape(-1) for w in (w1, w2)])
    y2 = S._through_y2(radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, rel,
                       norm_dp)[4]
    torch.cuda.synchronize()
    e2 = {"new_xyz": float((got2[0] - ref2[0]).abs().max()),
          "fi": float((got2[1] - ref2[1]).abs().max()) if C else 0.0,
          "same_bits_again": same_bits(got2, S.fwd_cuda(*fargs)),
          "weight_copies_exact": torch.equal(wt, copies)}
    ok2 = (e2["new_xyz"] == 0 and e2["fi"] == 0 and e2["same_bits_again"]
           and e2["weight_copies_exact"])
    for j, name in ((2, "ymax"), (3, "ymin"), (6, "s2"), (7, "q2")):
        ok2 = err(got2[j], ref2[j], TOL_TRAINBN["fwd"], name, e2) and ok2
    ties, flips = 0, 0
    for j, name in ((4, "amax"), (5, "amin")):
        diff = got2[j] != ref2[j]
        at_k = torch.gather(y2, 2, got2[j].long()[:, :, None, :])[:, :, 0]
        at_p = torch.gather(y2, 2, ref2[j].long()[:, :, None, :])[:, :, 0]
        near = (at_k - at_p).abs() <= TOL_TRAINBN["fwd"] * float(
            y2.abs().max())
        ties += int((diff & near).sum())
        flips += int((diff & ~near).sum())
    e2["slots_near_ties"], e2["slots_other"] = ties, flips
    # the forward kernel's ReLU mask (which rows 18 and 19 read) against the
    # plain forward's own: every difference inside the reordering bound
    relu = trainbn_mask_flips(S, radius, xyz, qidx, feats, idx, w1, a1, nb1,
                              rel, norm_dp, got2[8])
    e2["relu_flips"], e2["relu_worst_over_bound"] = (relu["flips"],
                                                    relu["worst_over_bound"])
    ok2 = ok2 and flips == 0 and relu["worst_over_bound"] <= 1.0
    mask = got2[8]
    mu2, var2, r2, a2, c2 = S._bn2(got2[6], got2[7], g2, b2, n, 1e-5)
    pos = a2 > 0
    ystar = torch.where(pos, got2[2], got2[3])
    slot = torch.where(pos, got2[4], got2[5])
    g_out = torch.randn((Bq, M, cout), generator=gen, device=DEV)
    g_fi = torch.randn((Bq, M, C), generator=gen, device=DEV) \
        if with_centers else None
    g_new = torch.randn((Bq, M, 3), generator=gen, device=DEV) \
        if with_centers else None
    xhat2 = (ystar - mu2) * r2
    p2, q2c = S._bwd_consts(g_out.sum((0, 1)) / n,
                            (g_out * xhat2).sum((0, 1)) / n, a2, mu2, r2)
    # pass 3, both on the forward kernel's mask, the kernel on its copies
    pre = (radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, mu1, r1, a2, p2,
           q2c, slot, g_out, mask)
    bargs, pargs = pre + (wt, rel, norm_dp), pre + (rel, norm_dp)
    got3 = S.bwd_w2_cuda(*bargs)
    ref3 = S.bwd_w2_plain(*pargs)
    torch.cuda.synchronize()
    e3 = {}
    ok3 = True
    for a, b_, name in zip(got3, ref3, ("dw2", "sg1", "sgx1", "g_y1p",
                                        "y1")):
        ok3 = err(a, b_, TOL_TRAINBN["bwd_w2"], name, e3) and ok3
    # the backward's ReLU is the forward's: g_y1' is zero wherever the
    # forward's bit is clear
    off = ~S.unpack_mask(mask, mid)
    e3["g_y1p_nonzero_where_mask_clear"] = int((got3[3][off] != 0).sum())
    ok3 = ok3 and e3["g_y1p_nonzero_where_mask_clear"] == 0
    p1, q1c = S._bwd_consts(got3[1] / n, got3[2] / n, a1, mu1, r1)
    # pass 4 of both on the kernel's hand-over
    xargs = (radius, xyz, qidx, feats, idx, w1, got3[4], got3[3], a1, p1,
             q1c, g_fi, g_new, rel, norm_dp)
    got4 = S.bwd_x_cuda(*xargs)
    ref4 = S.bwd_x_plain(*xargs)
    torch.cuda.synchronize()
    e4 = {}
    ok4 = True
    for a, b_, name in zip(got4, ref4, ("g_xyz", "g_feats", "dw1")):
        ok4 = err(a, b_, TOL_TRAINBN["bwd_x"], name, e4) and ok4
    inputs = {"fargs": fargs, "bargs": bargs, "pargs": pargs, "xargs": xargs,
              "stats": (radius, k, xyz, qidx, feats, rel, norm_dp)}
    return (e1, e2, e3, e4), (ok, ok2, ok3, ok4), inputs


def trainbn_work(Bq, n_pts, M, C, mid, cout, k, mask_words=None):
    """The flops and the bytes each pass must move at a stage (inputs read
    once, outputs written once; the hand-over y1 and g_y1', n x mid f32
    each, written by pass 3 and read by pass 4; g_y2 inside pass 3 not
    counted), and each pass's operation bound in seconds: for passes 2-4, 3
    flops at the dense TF32 rate, the least time for f32-grade products
    (3xTF32); for pass 1, whose sums must be f32 (tests/
    test_torch_satrainbn_fwd.py), its flops at the f32 rate."""
    W, n = C + 3, Bq * M * k
    nw = (mid + 31) // 32
    rows = Bq * n_pts * (3 + C) * 4 + Bq * M * 4 + n * 4  # points, qidx, idx
    flops = {"stats": n * W * (W + 1) + n * W,
             "fwd": 2 * n * (W * mid + mid * cout),
             "bwd_w2": 2 * n * (W * mid + 3 * mid * cout),
             "bwd_x": 2 * n * 2 * W * mid}
    nbytes = {"stats": rows + (W + W * W) * 4,
              "fwd": rows + (W * mid + 2 * mid + mid * cout) * 4
              + Bq * M * (3 + C + 2 * cout) * 4 + Bq * M * cout * 2
              + n * nw * 4 + 2 * cout * 4,
              "bwd_w2": rows + (W * mid + mid * cout + 4 * mid + 3 * cout) * 4
              + n * nw * 4 + Bq * M * cout * 5 + mid * cout * 4
              + 2 * n * mid * 4 + 2 * mid * 4,
              "bwd_x": rows + (W * mid + 3 * mid) * 4 + 2 * n * mid * 4
              + Bq * M * (3 + C) * 4 + Bq * n_pts * (3 + C) * 4
              + W * mid * 4}
    return flops, nbytes, {p: (f / PEAK_F32 if p == "stats"
                               else 3 * f / PEAK_TF32)
                           for p, f in flops.items()}


# what one call of each train-BN pass puts on the card, as SaTrainBN calls
# them (pass 3 on the forward's weight copies): device ops by name part
TRAINBN_OPS = {"stats": {"select_kernel": 1, "stats_kernel": 1,
                         "stats_reduce_kernel": 1},
               "fwd": {"weight_rows_kernel": 2, "fwd_kernel": 1,
                       "reduce_kernel": 1},
               "bwd_w2": {"weight_rows_kernel": 1, "emset": 1,
                          "bwd_y2_kernel": 1, "reduce_kernel": 2,
                          "bwd_gh_kernel": 1},
               "bwd_x": {"weight_rows_kernel": 1, "emset": 3,
                         "bwd_x_kernel": 1, "reduce_kernel": 1}}


# profiles of each pass's call that ``trainbn_op_launches`` may take: the
# profiler drops records now and then but never adds one (PERF.md, section 6)
TRAINBN_OP_ATTEMPTS = 4


def trainbn_op_launches(S, inp) -> dict:
    """The device ops of one call of each train-BN pass on ``inp`` (from
    ``trainbn_passes``), from the profiler, by name: each must be
    TRAINBN_OPS's, nothing else. The call counted is the step after a
    warm-up step of one profile. The profiler leaves some of a call's
    device ops unrecorded, always the first ones of a profile that starts at
    the call and now and then even after a warm-up step (PERF.md, section 6),
    but it records no op that did not run. So every profile of a pass must
    hold no op beyond TRAINBN_OPS's, and one of up to TRAINBN_OP_ATTEMPTS
    must hold them all: a launch too many fails every profile, a launch
    missing fails all of them. A profile of its own around the call alone
    is reported beside it, not held."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    calls = {"stats": lambda: S.stats_cuda(*inp["stats"]),
             "fwd": lambda: S.fwd_cuda(*inp["fargs"]),
             "bwd_w2": lambda: S.bwd_w2_cuda(*inp["bargs"]),
             "bwd_x": lambda: S.bwd_x_cuda(*inp["xargs"])}

    def ops_of(fn, warm):
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        if not warm:
            with profile(activities=activities) as prof:
                fn()
                torch.cuda.synchronize()
        else:
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
        return {e.key[:60]: e.count for e in device_kernels(prof)}

    def parts(want, ops):
        return {part: sum(v for k, v in ops.items() if part in k)
                for part in want}

    alone = {name: ops_of(fn, False) for name, fn in calls.items()}
    found, profiles, bad = {}, {}, {}
    for name, want in TRAINBN_OPS.items():
        profiles[name] = []
        for _ in range(TRAINBN_OP_ATTEMPTS):
            ops = ops_of(calls[name], True)
            profiles[name].append(ops)
            got = parts(want, ops)
            if any(got[p] > want[p] for p in want) \
                    or sum(ops.values()) > sum(got.values()):
                bad[name] = ops  # an op beyond TRAINBN_OPS's
                break
            if got == want:
                found[name] = ops
                break
        else:
            bad[name] = profiles[name]  # none held them all
    emit("sa_trainbn_op_launches", found=found, expected=TRAINBN_OPS,
         profiles_taken={n: len(v) for n, v in profiles.items()},
         profiles_short={n: v[:-1] for n, v in profiles.items() if len(v) > 1},
         profiled_alone=alone,
         alone_differs=[n for n in calls if alone[n] != found.get(n)])
    if bad:
        raise AssertionError(f"train-BN passes' device ops {bad}")
    return found


def check_sa_trainbn(gen, captured):
    """The four train-BN passes (rows 16-19), each against its plain pass on
    the same inputs, at the stages ``captured`` from the fused train step
    (its own FPS picks, features and weights), with seeded cotangents.
    Returns their rows, summed over the stages. The operation bound of
    passes 2-4 is 3 flops / PEAK_TF32 (the f32-grade 3xTF32 rate, the least
    time the card could take for f32-grade work), of pass 1 flops /
    PEAK_F32 (its f32 sums); the f32 CUDA cores' figure, flops / PEAK_F32,
    is reported beside every pass (``bound_ms_f32_cores``). At the first
    stage, the device ops of each pass's call are pinned
    (``trainbn_op_launches``)."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import satrainbn as S

    names = ("stats", "fwd", "bwd_w2", "bwd_x")
    rows = {f"sa_trainbn_{p}": dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0,
                                    t_o=0.0, t_b=0.0, bound_ms_f32_cores=0.0,
                                    library_ms=None)
            for p in names}
    composite = 0.0
    for i, (xyz, qidx, feats, w1, g1, b1, w2, g2, b2, radius, rel,
            norm_dp) in enumerate(captured):
        Bq, n_pts, _ = xyz.shape
        M, C, mid, cout = qidx.shape[1], feats.shape[2], w1.shape[1], \
            w2.shape[1]
        errs, oks, inp = trainbn_passes(gen, S, xyz, qidx, feats, w1, g1, b1,
                                        w2, g2, b2, radius, rel, norm_dp, K)
        for name, e in zip(names, errs):
            emit("kernel", name=f"sa_trainbn_{name}",
                 stage=[Bq, n_pts, M, C, mid, cout, K], max_abs_err=e,
                 tolerance=f"indices, new_xyz, fi exact; slots exact but at "
                           f"near-ties; ReLU mask differences inside the "
                           f"reordering bound; g_y1' zero where the mask is "
                           f"clear; each float output within "
                           f"{TOL_TRAINBN[name]} * max|plain|")
        if not all(oks):
            raise AssertionError(f"train-BN kernels disagree at stage "
                                 f"{i + 1}: {errs}")
        if i == 0:
            trainbn_op_launches(S, inp)
        flops, nbytes, t_ops = trainbn_work(Bq, n_pts, M, C, mid, cout, K)
        fargs, bargs, xargs = inp["fargs"], inp["bargs"], inp["xargs"]
        calls = {"stats": (lambda: S.stats_cuda(*inp["stats"]),
                           lambda: S.stats_plain(*inp["stats"])),
                 "fwd": (lambda: S.fwd_cuda(*fargs),
                         lambda: S.fwd_plain(*fargs)),
                 "bwd_w2": (lambda: S.bwd_w2_cuda(*bargs),
                            lambda: S.bwd_w2_plain(*inp["pargs"])),
                 "bwd_x": (lambda: S.bwd_x_cuda(*xargs),
                           lambda: S.bwd_x_plain(*xargs))}
        stage_row = {}
        for name, e in zip(names, errs):
            r = rows[f"sa_trainbn_{name}"]
            ms = cuda_ms(calls[name][0], 100.0)
            plain = cuda_ms(calls[name][1], 50.0)
            r["ms"] += ms
            r["plain_ms"] += plain
            r["t_o"] += t_ops[name]
            r["t_b"] += nbytes[name] / PEAK_BYTES
            r["bound_ms_f32_cores"] += 1e3 * max(flops[name] / PEAK_F32,
                                                 nbytes[name] / PEAK_BYTES)
            r["max_abs_err"] = max([r["max_abs_err"]] + [
                v for k_, v in e.items() if not k_.startswith((
                    "slots", "relu", "g_y1p_nonzero", "same_bits",
                    "weight_copies"))])
            stage_row[name] = {"ms": ms, "plain_ms": plain,
                               "gflop": flops[name] / 1e9,
                               "bound_ms": 1e3 * max(t_ops[name],
                                                     nbytes[name] / PEAK_BYTES)}

        # the unfused stage it replaces: ball group, conv, BatchNorm, relu,
        # conv, BatchNorm, max, forward and backward
        leaves = [t.clone().requires_grad_() for t in (xyz, feats, w1, g1, b1,
                                                        w2, g2, b2)]
        g_out = bargs[15]
        g_fi = xargs[11]

        def composite_step():
            x_, f_, w1_, g1_, b1_, w2_, g2_, b2_ = leaves
            _, fi_, dpfj, _ = ops.ball_group(radius, K, x_, qidx, f_, rel,
                                             norm_dp)
            y = torch.nn.functional.batch_norm(
                (dpfj @ w1_).reshape(-1, mid), None, None, g1_, b1_, True)
            y = torch.relu(y).reshape(Bq, K, M, mid) @ w2_
            y = torch.nn.functional.batch_norm(
                y.reshape(-1, cout), None, None, g2_, b2_, True)
            out = y.reshape(Bq, K, M, cout).amax(dim=1)
            torch.autograd.grad((out * g_out).sum() + (fi_ * g_fi).sum(),
                                leaves)

        stage_row["composite_ms"] = cuda_ms(composite_step, 100.0)
        composite += stage_row["composite_ms"]
        emit("stage_times", stage=i + 1, shape=[Bq, n_pts, M, C, mid, cout,
                                                 K], sa_trainbn=stage_row)
    for r in rows.values():
        r.update(bound_row(r.pop("t_b"), r.pop("t_o")))
        r["composite_ms"] = composite
    return rows


def check_sa_trainbn_edges(gen) -> None:
    """The four train-BN passes at TRAINBN_EDGES (ragged last tiles, tiles
    that split a ball, K = 1 and 255, C = 0 and C % 4 != 0, mid and cout
    off multiples of 8 and 32, a stage that takes rows of 64 and 32, both dp
    modes, missing center cotangents) against their plain versions, as at
    the captured stages; and every pass at every rows a block it offers
    (``satrainbn.DESIGN``: 128, 64, 32) at each edge against the plan's own
    launch: rows 18 and 19 within TOL_TRAINBN (the products' sums are the
    same, only the L2 reductions of dW1, dW2 and the scatter land in another
    order), row 16's Sv, Svv and row 17's BN2 sums within TOL_TRAINBN (the
    rows are cut into other tiles), row 16's indices and row 17's other
    outputs bit for bit (each row's products are the same sums)."""
    import torch
    from adaptpoint_tpu_torch.ops import satrainbn as S

    for (Bq, n_pts, M, C, mid, cout, k, radius, rel, norm_dp,
         centers) in TRAINBN_EDGES:
        g = torch.Generator(device=DEV).manual_seed(Bq * 1000 + C + k)

        def rnd(*shape, scale=1.0, shift=0.0):
            return (torch.randn(shape, generator=g, device=DEV) * scale
                    + shift).contiguous()

        xyz = rnd(Bq, n_pts, 3, scale=0.5)
        qidx = torch.stack([torch.randperm(n_pts, device=DEV)[:M]
                            for _ in range(Bq)]).int().contiguous()
        feats = rnd(Bq, n_pts, C)
        w1 = rnd(C + 3, mid, scale=(C + 3) ** -0.5)
        w2 = rnd(mid, cout, scale=mid ** -0.5)
        params = (w1, rnd(mid, scale=0.2, shift=1.0), rnd(mid, scale=0.2), w2,
                  rnd(cout), rnd(cout, scale=0.2))
        errs, oks, inp = trainbn_passes(gen, S, xyz, qidx, feats, *params,
                                        radius, rel, norm_dp, k, centers)
        plans = {kind: S._plan(kind, Bq, M, k, C, mid, cout)
                 for kind in (S.BWD_Y2, S.BWD_GH, S.BWD_X)}
        emit("sa_trainbn_edge", shape=[Bq, n_pts, M, C, mid, cout, k],
             radius=radius, relative=rel, normalize_dp=norm_dp,
             centers=centers, plans=plans, max_abs_err=errs)
        if not all(oks):
            raise AssertionError(f"train-BN kernels disagree at edge "
                                 f"{(Bq, n_pts, M, C, mid, cout, k)}: {errs}")
        base1 = S.stats_cuda(*inp["stats"])
        base2 = S.fwd_cuda(*inp["fargs"])
        base3 = S.bwd_w2_cuda(*inp["bargs"])
        base4 = S.bwd_x_cuda(*inp["xargs"])
        worst = 0.0
        for rows_ in (128, 64, 32):
            S.DESIGN["stats"] = S.DESIGN["fwd"] = rows_
            try:
                got = S.stats_cuda(*inp["stats"]) + S.fwd_cuda(*inp["fargs"])
            finally:
                S.DESIGN["stats"] = S.DESIGN["fwd"] = 0
            for j, (a, b_) in enumerate(zip(got, base1 + base2)):
                name = "stats" if j < 3 else "fwd"
                if j in (1, 2, 9, 10):  # Sv, Svv, sum y2, sum y2^2
                    d = float((a - b_).abs().max()) if a.numel() else 0.0
                    scale = max(float(b_.abs().max()) if b_.numel() else 0.0,
                                1e-30)
                    worst = max(worst, d / scale)
                    good = d <= TOL_TRAINBN[name] * scale
                else:
                    good = torch.equal(a, b_)
                if not good:
                    raise AssertionError(
                        f"train-BN {name} at rows={rows_} disagrees with the "
                        f"plan's launch at {(Bq, n_pts, M, C, mid, cout, k)}:"
                        f" output {j}")
            S.DESIGN["rows"] = rows_
            try:
                got = S.bwd_w2_cuda(*inp["bargs"]) + S.bwd_x_cuda(
                    *inp["xargs"])
            finally:
                S.DESIGN["rows"] = 0
            for a, b_, name in zip(got, base3 + base4,
                                   ("bwd_w2",) * 5 + ("bwd_x",) * 3):
                d = float((a - b_).abs().max()) if a.numel() else 0.0
                scale = max(float(b_.abs().max()) if b_.numel() else 0.0,
                            1e-30)
                worst = max(worst, d / scale)
                if d > TOL_TRAINBN[name] * scale:
                    raise AssertionError(
                        f"train-BN launch shape rows={rows_} disagrees with "
                        f"the plan's at "
                        f"{(Bq, n_pts, M, C, mid, cout, k)}: {name} {d}")
        emit("sa_trainbn_edge_designs", shape=[Bq, n_pts, M, C, mid, cout, k],
             worst_relative=worst)
    torch.cuda.synchronize()


@contextlib.contextmanager
def flax_formula_bn():
    """Inside, every train-mode ``BatchNorm`` of the port normalises with
    (and records) the variance ``max(0, E[x^2] - E[x]^2)``, differentiated
    through: the unfused step in other roundings. Nothing of the port does
    this."""
    import torch
    from adaptpoint_tpu_torch.models.layers import blocks
    orig = blocks.BatchNorm._forward

    def forward(self, x):
        if not self.training or not self.track_running_stats:
            return orig(self, x)
        mean = x.mean(dim=0)
        var = ((x * x).mean(dim=0) - mean * mean).clamp(min=0.0)
        self.record_stats(mean.detach(), var.detach())
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias

    blocks.BatchNorm._forward = forward
    try:
        yield
    finally:
        blocks.BatchNorm._forward = orig


@contextlib.contextmanager
def captured_trainbn(log: list):
    """Inside, every ``ops.sa_trainbn`` call appends its inputs to ``log``
    (detached): the stages a train step hands the fused op. Nothing of the
    port does this."""
    from adaptpoint_tpu_torch import ops
    orig = ops.sa_trainbn

    def recording(radius, nsample, xyz, query_idx, feats, *params,
                  relative=True, normalize_dp=False, eps=1e-5):
        log.append((xyz.detach().contiguous(),
                    query_idx.int().contiguous(),
                    feats.detach().float().contiguous())
                   + tuple(p.detach().float().contiguous() for p in params)
                   + (float(radius), bool(relative), bool(normalize_dp)))
        return orig(radius, nsample, xyz, query_idx, feats, *params,
                    relative=relative, normalize_dp=normalize_dp, eps=eps)

    ops.sa_trainbn = recording
    try:
        yield
    finally:
        ops.sa_trainbn = orig


def step_readings(one_step, reps: int = 10):
    """ms per step by CUDA events, the host's enqueue ms, and from the
    profiler the device-busy ms, idle share and kernels a step, plus the
    peak memory of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(one_step, 1000.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_step()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"ms_per_step": ms, "clouds_per_s": B * 1e3 / ms,
            "host_enqueue_ms": enqueue_ms, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_step": sum(e.count for e in kernels) / reps,
            "peak_memory_gb": peak / 1e9,
            "top_kernels_ms": [[e.key[:48], e.self_device_time_total / 1e3
                                / reps] for e in top]}


def phase_train_fused(gen, rows):
    """The classifier's train step at full width on the fused train-BN route
    (``make_train_step(..., fused_train_bn=True)``), the path
    ``ADAPTPOINT_TPU_TRAIN_FUSED=1`` selects: its first step against the
    unfused step from the same weights, batch and draws (self-calibrated),
    the four passes against their plain versions at the stages it captured
    (added to ``rows`` when given), and ms per step beside the unfused
    step's. Returns the launch counts of this path's run."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                             make_train_step)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs/scanobjectnn/pointnext-s.yaml"),
             recursive=True)
    lr = float(cfg.lr)
    rng = np.random.default_rng(1)
    axes = rng.uniform(0.15, 1.0, (CLASSES, 3)).astype(np.float32)
    batches = blob_batches(rng, TRAIN_BATCHES, axes=axes)
    base = build_model_from_cfg(cfg.model, seed=1)
    host_gen = torch.Generator().manual_seed(2)
    cols = torch.randperm(N_FPS, generator=host_gen)[:N0].to(DEV)
    masks = [(torch.rand((B, w), generator=host_gen) >= 0.5).to(DEV)
             for w in cfg.model.cls_args.mlps]
    first = {k: torch.from_numpy(v).to(DEV) for k, v in batches[0].items()}

    def one_step(fused, other_bn=False):
        net = build_model_from_cfg(cfg.model)
        net.load_state_dict(base.state_dict())
        crit, opt, _ = build_train_tools(cfg, net)
        step = make_train_step(net, opt, crit, cfg, fused_train_bn=fused)
        seen = {}
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        with flax_formula_bn() if other_bn else contextlib.nullcontext():
            _, loss, _ = step(TrainState(net, opt), first, cols, lr,
                              dropout_mask=masks)
        hook.remove()
        got = {"loss": loss.double().cpu().reshape(1),
               "logits": seen["logits"].double().cpu()}
        got.update({"grad." + k: p.grad.double().cpu()
                    for k, p in net.named_parameters()})
        got.update({"buffer." + k: b_.double().cpu()
                    for k, b_ in net.named_buffers()
                    if not k.endswith("num_batches_tracked")})
        return got, net, opt, step

    captured = []
    ops.reset_launch_counts()  # this path's run starts here
    with captured_trainbn(captured):
        fused, net, opt, fused_step = one_step(True)
    torch.cuda.synchronize()
    per_step = ops.launch_counts()
    # the references launch kernels of their own; this path's count is read
    unfused = one_step(False)[0]
    unfused_other = one_step(False, other_bn=True)[0]
    want = {**dict.fromkeys(ops.KERNEL_MODULES, 0), "fps": 2,
            "gather_rows": 1, "sa_trainbn_stats": 4, "sa_trainbn_fwd": 4,
            "sa_trainbn_bwd_w2": 4, "sa_trainbn_bwd_x": 4}
    total = float(torch.cat([v.flatten() for k, v in unfused.items()
                             if k.startswith("grad.")]).norm())

    def distance(a, ref, k):
        if k.startswith("grad."):
            return float((a - ref).norm()) / max(float(ref.norm()),
                                                 1e-3 * total)
        return float((a - ref).abs().max())

    scale = {kind: max(float(v.abs().max()) for k, v in unfused.items()
                       if k.split(".")[0] == kind)
             for kind in ("loss", "logits", "grad", "buffer")}
    tol = TOL_STEP_CPU
    worst, spread, bad = {}, {}, []
    for k, ref in unfused.items():
        kind = k.split(".")[0]
        d = distance(fused[k], ref, k)
        noise = max(distance(unfused_other[k], ref, k),
                    TRAINBN_FLOOR * (1.0 if kind == "grad" else scale[kind]))
        if d / noise > worst.get(kind, ("", 0.0))[1]:
            worst[kind] = (k, d / noise, d)
        spread[kind] = max(spread.get(kind, 0.0), noise)
        if kind == "loss":
            good = d <= tol["loss"] * abs(float(ref))
        elif kind == "grad":
            good = d <= tol["grad_l2"]
        else:
            rt, at = tol["logits" if kind == "logits" else "buffers"]
            good = bool(torch.allclose(fused[k], ref, rtol=rt, atol=at))
        if not good or not np.isfinite(d):
            bad.append((k, d))
    emit("train_fused_first_step", loss=float(fused["loss"]),
         unfused_loss=float(unfused["loss"]),
         worst_over_flax_formula_spread=worst, flax_formula_spread=spread,
         launches=per_step, expected=want,
         stages=[list(c[0].shape[:2]) + [c[1].shape[1], c[2].shape[2],
                                         c[3].shape[1], c[6].shape[1]]
                 for c in captured],
         tolerance={"held": tol, "note": "loss relative; logits, buffers "
                    "(rtol, atol); grad_l2 each gradient's relative 2-norm "
                    "(scale floored at 1e-3 of the whole gradient's)"})
    if per_step != want:
        raise AssertionError(f"launches in one fused train step {per_step} "
                             f"!= {want}")
    if bad:
        raise AssertionError(f"the fused train step disagrees with the "
                             f"unfused one: {bad[:8]}")
    if len(captured) != 4:
        raise AssertionError(f"{len(captured)} fused stages, expected 4")

    # more steps through the train loop's entry point on the fused route;
    # the references' launches above are not this path's
    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    before = ops.launch_counts()
    state = TrainState(net, opt)
    dev_batches = [{k: torch.from_numpy(v).to(DEV) for k, v in b_.items()}
                   for b_ in batches]
    losses = []
    for b_ in dev_batches:
        state, loss, _ = fused_step(state, b_, dev_gen, lr)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    launches = {k: per_step[k] + v - before[k]  # this path's run ends here
                for k, v in ops.launch_counts().items()}
    emit("train_fused_steps", steps=len(losses), losses=losses,
         launches=launches)
    if not np.isfinite(losses).all():
        raise AssertionError(f"fused train steps: loss {losses}")

    checked = check_sa_trainbn(gen, captured)
    check_sa_trainbn_edges(gen)
    if rows is not None:
        rows.update(checked)
    del captured

    # ms per step on both routes, in turns
    readings = {}
    for route in ("unfused", "fused", "fused", "unfused"):
        net_r = build_model_from_cfg(cfg.model)
        net_r.load_state_dict(base.state_dict())
        crit, opt_r, _ = build_train_tools(cfg, net_r)
        step = make_train_step(net_r, opt_r, crit, cfg,
                               fused_train_bn=route == "fused")
        st = TrainState(net_r, opt_r)
        it = [0]

        def go():
            step(st, dev_batches[it[0] % TRAIN_BATCHES], dev_gen, lr)
            it[0] += 1

        readings.setdefault(route, []).append(step_readings(go))
        del net_r, opt_r, st
        torch.cuda.empty_cache()
    for route, runs in readings.items():
        emit("train_fused_throughput", route=route, batch=B, points=N_TRAIN,
             runs=runs)
    return launches


def windowed_scanned(prep, idx, cnt, w, n):
    """Window points each center's scan must look at: in original index
    order up to its K-th in-ball point, or the whole window (below N) when
    the ball holds fewer. ``idx``/``cnt`` in query order."""
    import torch
    Bq, M, Kq = idx.shape
    tm = M // prep["win"].shape[1]
    tile = prep["cinv"].long() // tm                        # query -> tile
    ws = torch.gather(prep["win"].long(), 1, tile) * 128
    pos = ws[..., None] + torch.arange(w, device=idx.device)
    valid = pos < n
    orig = torch.gather(prep["order"].long(), 1,
                        pos.clamp(max=n - 1).reshape(Bq, -1)).reshape(pos.shape)
    kth = idx[..., -1:].long()
    upto = ((orig <= kth) & valid).sum(dim=-1)
    return int(torch.where(cnt >= Kq, upto, valid.sum(dim=-1)).sum())


def check_window_stage(gen, tag, xyz, qidx, feats, radius, tm, w):
    """The windowed kernels (rows 20, 21) at one stage and width against
    their plain versions (forward outputs and residuals exact, the backward
    and the op's autograd within the reordering bound) and, where ``ok``,
    against row 7's kernel (outputs, winning slots and slots equal).
    Returns ``(ok, need, prep, forward outputs, backward arguments, the
    forward's and the backward's largest error)``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
    from adaptpoint_tpu_torch.ops import window as wnd

    n, c = feats.shape[1], feats.shape[2]
    m = qidx.shape[1]
    prep = wnd.window_prep(xyz, qidx, radius, tm, w)
    ok, need = bool(prep["ok"]), int(prep["need"])
    args = (radius, K_GAN, xyz, qidx, feats, prep, w, tm)
    got = wnd.ball_group_max_windowed_cuda(*args)
    ref = wnd.ball_group_max_windowed_plain(*args)
    torch.cuda.synchronize()
    names = ("new_xyz", "fi", "fmax", "fmin", "amax", "amin", "cnt", "idx",
             "qrow")
    errs = {k: float((a.float() - b.float()).abs().max())
            for k, a, b in zip(names, got, ref)}
    del ref
    _, _, _, _, amax, amin, cnt, idx, qrow = got
    g_new = torch.randn((B, m, 3), generator=gen, device=DEV)
    g_fi, g_fmax, g_fmin = (torch.randn((B, m, c), generator=gen, device=DEV)
                            for _ in range(3))
    bargs = (idx, cnt, qrow, amax, amin, g_new, g_fi, g_fmax, g_fmin, n)
    back = wnd.ball_group_max_windowed_bwd_cuda(*bargs)
    back_ref = wnd.ball_group_max_windowed_bwd_plain(*bargs)
    x_req, f_req = xyz.clone().requires_grad_(), feats.clone().requires_grad_()
    auto = torch.autograd.grad(
        ops.ball_group_max_windowed(radius, K_GAN, x_req, qidx, f_req, 1, 1,
                                    tm, w),
        (x_req, f_req), (g_new, g_fi, g_fmax, g_fmin))
    auto_ref = (back_ref[0], back_ref[1].clone())
    auto_ref[1][:, 0] += wnd.empty_ball_grad(cnt, g_fmax, g_fmin)
    ones3, ones = torch.ones_like(g_new), torch.ones_like(g_fi)
    counts_x = wnd.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, ones3, None, None, None, n)[0]
    counts_f = wnd.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, None, ones, ones, ones, n)[1]
    counts_f[:, 0] += 2 * (cnt == 0).sum(dim=1)[:, None]  # the row-0 term
    a_x, a_f = wnd.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, g_new.abs(), g_fi.abs(), g_fmax.abs(),
        g_fmin.abs(), n)
    a_f[:, 0] += wnd.empty_ball_grad(cnt, g_fmax.abs(), g_fmin.abs())
    bounds = (scatter_bound(counts_x, a_x), scatter_bound(counts_f, a_f))
    bwd_errs = {}
    good = not any(errs.values())
    for name, a, b_, bound in (("g_xyz", back[0], back_ref[0], bounds[0]),
                               ("g_feats", back[1], back_ref[1], bounds[1]),
                               ("autograd_g_xyz", auto[0], auto_ref[0],
                                bounds[0]),
                               ("autograd_g_feats", auto[1], auto_ref[1],
                                bounds[1])):
        d = (a - b_).abs()
        bwd_errs[name] = float(d.max())
        good = good and bool((d <= bound).all()) \
            and bool(torch.isfinite(a).all())
    full_n = {}
    if ok:  # the full-N kernel (row 7) on the same inputs
        row7 = bgm.ball_group_max_cuda(radius, K_GAN, xyz, qidx, feats)
        torch.cuda.synchronize()
        for k, a, b_ in zip(("new_xyz", "fi", "fmax", "fmin", "amax", "amin",
                             "idx"), row7, (got[0], got[1], got[2], got[3],
                                            amax, amin, idx)):
            full_n[k] = float((a.float() - b_.float()).abs().max())
        good = good and not any(full_n.values())
    emit("kernel", name="ball_group_max_windowed", case=tag,
         shape=[B, n, m, c, K_GAN], radius=radius, tm=tm, w=w,
         w_over_n=w / n, ok=ok, need=need, max_abs_err=errs,
         max_abs_err_bwd=bwd_errs, against_row7=full_n or None,
         empty_balls=int((cnt == 0).sum()),
         full_balls=float((cnt == K_GAN).float().mean()),
         tolerance="forward outputs and residuals exact, against the plain "
                   "version and (where ok) row 7's kernel; backward <= n * "
                   "2^-23 * sum|addend| per element")
    if not good:
        raise AssertionError(f"windowed kernels disagree ({tag}, w={w}): "
                             f"{errs} {bwd_errs} {full_n}")
    return (ok, need, prep, got, bargs, max(errs.values()),
            max(bwd_errs["g_xyz"], bwd_errs["g_feats"]))


def phase_window(gen):
    """Path A: the windowed max-pooled ball group (rows 20, 21), the op
    itself at ``scripts/check_window.py``'s shapes: B=32, K=24, the
    augmentor's four groupers on clouds centred and normalised to the unit
    sphere, centers drawn without replacement. Per stage: the width, ``ok``
    and the needed width; the kernels against their plain versions and
    row 7 (also at the needed width where ``ok`` is False); then CUDA-event
    times of the kernels, ``window_prep``, the four un-permute gathers the
    JAX op makes (folded into this kernel's writes), the op forward and
    forward+backward, and row 7/8's op at the same inputs. Returns the
    launch counts of one forward+backward of the op at each stage (the
    path), and the kernel rows."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import gather as gth
    from adaptpoint_tpu_torch.ops import window as wnd

    cases = []
    for n, m, c, r in GAN_STAGES:
        pc = torch.randn((B, n, 3), generator=gen, device=DEV)
        pc = pc - pc.mean(dim=1, keepdim=True)
        pc = pc / pc.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        feats = torch.randn((B, n, c), generator=gen, device=DEV)
        qidx = torch.argsort(torch.rand((B, n), generator=gen, device=DEV),
                             dim=1)[:, :m].int().contiguous()
        tm = 256 if m % 256 == 0 else 128
        w = wnd.pick_window(wnd._round_up(n, 128), r, m, tm)
        cases.append((n, m, c, r, tm, w, pc.contiguous(), qidx, feats))

    # the path: the op forward and backward once at each stage
    ops.reset_launch_counts()
    for n, m, c, r, tm, w, xyz, qidx, feats in cases:
        x_req = xyz.clone().requires_grad_()
        f_req = feats.clone().requires_grad_()
        out = ops.ball_group_max_windowed(r, K_GAN, x_req, qidx, f_req, 1, 1,
                                          tm, w)
        torch.autograd.grad(sum(o.sum() for o in out), (x_req, f_req))
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    fwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0,
               full_n_op_ms=0.0)
    bwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0,
               full_n_op_ms=0.0)
    stages = []
    for i, (n, m, c, r, tm, w, xyz, qidx, feats) in enumerate(cases):
        tag = f"grouper {i + 1}"
        ok, need, prep, got, bargs, e_f, e_b = check_window_stage(
            gen, tag, xyz, qidx, feats, r, tm, w)
        emit("window", case=tag, n=n, w=w, w_over_n=w / n, ok=ok, need=need,
             need_over_n=need / n)
        w_run, picked_ms = w, None
        if not ok:  # the exact comparison at the width the data needs
            picked_ms = cuda_ms(lambda: wnd.ball_group_max_windowed_cuda(
                r, K_GAN, xyz, qidx, feats, prep, w, tm))
            w_run = need
            ok, need, prep, got, bargs, e_f2, e_b2 = check_window_stage(
                gen, tag + f" at w={need}", xyz, qidx, feats, r, tm, need)
            e_f, e_b = max(e_f, e_f2), max(e_b, e_b2)
        cnt, idx = got[6], got[7]
        fargs = (r, K_GAN, xyz, qidx, feats, prep, w_run, tm)
        scanned = windowed_scanned(prep, idx, cnt, w_run, n)
        t_b_f = (B * n * 12 + B * n * c * 4 + B * n * 4 + B * prep["win"]
                 .shape[1] * 4 + B * m * 8 + B * m * 12 + 3 * B * m * c * 4
                 + 2 * B * m * c + B * m * 8 + B * m * K_GAN * 4) / PEAK_BYTES
        t_o_f = (scanned * 9 + 2 * B * m * K_GAN * c) / PEAK_F32
        t_b_b = (B * m * K_GAN * 4 + B * m * 8 + 2 * B * m * c
                 + B * m * 12 + 3 * B * m * c * 4 + B * n * 12
                 + B * n * c * 4) / PEAK_BYTES
        t_o_b = 4 * B * m * c / PEAK_F32
        f_ms = cuda_ms(lambda: wnd.ball_group_max_windowed_cuda(*fargs))
        b_ms = cuda_ms(lambda: wnd.ball_group_max_windowed_bwd_cuda(*bargs))
        f_plain = cuda_ms(lambda: wnd.ball_group_max_windowed_plain(*fargs),
                          50.0)
        b_plain = cuda_ms(
            lambda: wnd.ball_group_max_windowed_bwd_plain(*bargs), 50.0)
        prep_ms = cuda_ms(lambda: wnd.window_prep(xyz, qidx, r, tm, w_run,
                                                  stats_only=True))
        cinv = prep["cinv"]
        outs4 = [got[0], got[1], got[2], got[3]]
        unperm_ms = cuda_ms(lambda: [gth.gather_rows_cuda(o, cinv)
                                     for o in outs4])
        x_req = xyz.clone().requires_grad_()
        f_req = feats.clone().requires_grad_()

        def win_fb():
            o = ops.ball_group_max_windowed(r, K_GAN, x_req, qidx, f_req, 1,
                                            1, tm, w_run)
            return torch.autograd.grad(o, (x_req, f_req), o)

        def full_fb():
            o = ops.ball_group_max(r, K_GAN, x_req, qidx, f_req)
            return torch.autograd.grad(o, (x_req, f_req), o)

        with torch.no_grad():
            op_f = cuda_ms(lambda: ops.ball_group_max_windowed(
                r, K_GAN, xyz, qidx, feats, 1, 1, tm, w_run))
            full_f = cuda_ms(lambda: ops.ball_group_max(r, K_GAN, xyz, qidx,
                                                        feats))
        op_fb, full_fb_ms = cuda_ms(win_fb), cuda_ms(full_fb)
        row = dict(case=tag, shape=[B, n, m, c, K_GAN], w=w_run, ok=ok,
                   kernel_ms=f_ms, kernel_ms_at_picked_w=picked_ms, bwd_kernel_ms=b_ms, plain_ms=f_plain,
                   bwd_plain_ms=b_plain, window_prep_ms=prep_ms,
                   jax_unpermutes_ms=unperm_ms, op_fwd_ms=op_f,
                   op_fwd_bwd_ms=op_fb, row7_op_fwd_ms=full_f,
                   row78_op_fwd_bwd_ms=full_fb_ms, scanned=scanned,
                   bound_fwd_ms=1e3 * max(t_b_f, t_o_f),
                   bound_bwd_ms=1e3 * max(t_b_b, t_o_b))
        emit("window_times", **row)
        stages.append(row)
        for acc, ms, pl, tb, to, full, e in (
                (fwd, f_ms, f_plain, t_b_f, t_o_f, full_f, e_f),
                (bwd, b_ms, b_plain, t_b_b, t_o_b, full_fb_ms - full_f,
                 e_b)):
            acc["max_abs_err"] = max(acc["max_abs_err"], e)
            acc["ms"] += ms
            acc["plain_ms"] += pl
            acc["t_b"] += tb
            acc["t_o"] += to
            acc["full_n_op_ms"] += full
    out = {}
    for name, acc in (("ball_group_max_windowed", fwd),
                      ("ball_group_max_windowed_bwd", bwd)):
        out[name] = dict(max_abs_err=acc["max_abs_err"], ms=acc["ms"],
                         plain_ms=acc["plain_ms"], library_ms=None,
                         full_n_op_ms=acc["full_n_op_ms"],
                         **bound_row(acc["t_b"], acc["t_o"]))
    emit("window_summary", note="ms summed over the four groupers at B=32; "
         "full_n_op_ms: row 7's op forward, and row 7/8's forward+backward "
         "less its forward, on the same inputs", **out)
    return launches, out, stages


def phase_cli():
    """The port's CLI in a child process, as a user starts it:
    ``python -m adaptpoint_tpu_torch.main --cfg
    cfgs/scanobjectnn/pointnext-s.yaml`` on SyntheticCls at the cfg's shapes
    (2048 training points, 15 classes) for CLI_EPOCHS epochs under
    ``ADAPTPOINT_TPU_TRAIN_FUSED=1``, then ``mode=test`` on its best
    checkpoint. The run must learn: the best checkpoint's test OA at least
    CLI_MIN_OA (chance is 6.7 %; 90 steps pass the first epochs, in which
    the BatchNorm running statistics still remember their start), and
    ``mode=test`` must evaluate exactly that checkpoint's tensors and print
    the same OA. Returns the child's launch counts."""
    import glob
    import re
    import numpy as np
    root = os.path.join(ROOT, "build", "chip_smoke", "cli")
    common = ["dataset.common.NAME=SyntheticCls",
              "dataset.common.num_points=2048",
              "dataset.common.num_classes=15",
              f"dataset.common.size={CLI_SIZE}", "seed=1",
              f"root_dir={root}"]
    env = dict(os.environ, ADAPTPOINT_TPU_TRAIN_FUSED="1")

    def run(extra):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "adaptpoint_tpu_torch.main", "--cfg",
             "cfgs/scanobjectnn/pointnext-s.yaml"] + common + extra,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"the CLI exited {out.returncode}:\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        counts = json.loads(out.stdout.strip().splitlines()[-1])
        oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)", out.stdout)]
        return counts["launch_counts"], oas, seconds, out.stdout

    counts, oas, seconds, log = run([f"epochs={CLI_EPOCHS}"])
    runs = sorted(glob.glob(os.path.join(root, "scanobjectnn", "*")),
                  key=os.path.getmtime)
    run_dir = runs[-1]
    name = os.path.basename(run_dir)
    files = {f: os.path.exists(os.path.join(run_dir, f)) for f in (
        "log.txt", "cfg.yaml", "scalars.jsonl",
        f"checkpoint/{name}_ckpt_latest.pth",
        f"checkpoint/{name}_ckpt_best.pth")}
    epochs_s = [float(v) for v in re.findall(r"epoch_seconds ([0-9.]+)",
                                             log)]
    train_oas = [float(v) for v in re.findall(r"train_oa ([0-9.]+)", log)]
    # mode=test in this process (a second child would pay the card's
    # start-up again): the same entry point, the same printed OA; the root
    # logger it sets up is put back after
    import logging
    import torch
    from adaptpoint_tpu_torch.engine import cls_main
    from adaptpoint_tpu_torch.main import main as cli_main
    root_log = logging.getLogger()
    saved = (root_log.level, list(root_log.handlers))
    best = os.path.join(run_dir, "checkpoint", f"{name}_ckpt_best.pth")
    out = io.StringIO()
    evaluated = []
    validate = cls_main.validate

    def spy(eval_step, state, *args, **kwargs):
        evaluated.append({k: v.detach().cpu().clone()
                          for k, v in state.model.state_dict().items()})
        return validate(eval_step, state, *args, **kwargs)

    cls_main.validate = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli_main(["--cfg", os.path.join(ROOT, "cfgs/scanobjectnn/"
                                             "pointnext-s.yaml")] + common
                     + ["mode=test", f"pretrained_path={best}"])
    finally:
        cls_main.validate = validate
    test_seconds = time.perf_counter() - t0
    best_state = torch.load(best, map_location="cpu",
                            weights_only=True)["model"]
    loaded = (len(evaluated) == 1 and set(evaluated[0]) == set(best_state)
              and all(torch.equal(evaluated[0][k], v)
                      for k, v in best_state.items()))
    for handler in list(root_log.handlers):
        root_log.removeHandler(handler)
        handler.close()
    root_log.setLevel(saved[0])
    for handler in saved[1]:
        root_log.addHandler(handler)
    test_oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)",
                                             out.getvalue())]
    emit("cli", seconds=seconds, epoch_seconds=epochs_s,
         test_seconds=test_seconds, files=files, train_oa=train_oas,
         oas=oas, test_oa=test_oas, min_oa=CLI_MIN_OA,
         mode_test_evaluated_the_checkpoint=loaded, launches=counts,
         run_dir=os.path.relpath(run_dir, ROOT))
    if not all(files.values()):
        raise AssertionError(f"the CLI's run directory lacks {files}")
    if not oas or not all(np.isfinite(v) for v in oas) or not test_oas \
            or test_oas[-1] != oas[-1] or oas[-1] < CLI_MIN_OA:
        raise AssertionError(f"the CLI's OA: training run {oas}, mode=test "
                             f"{test_oas}, at least {CLI_MIN_OA}")
    if not loaded:
        raise AssertionError("mode=test did not evaluate the best "
                             "checkpoint's tensors")
    return counts


def phase_adapt_cli():
    """Path B: ``python -m adaptpoint_tpu_torch.main --cfg
    cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml`` in a child process, as
    a user starts it, on SyntheticCls at the ``cli`` phase's sizes, B=32,
    ADAPT_CLI_EPOCHS epochs, the card's defaults (bf16 GAN step, unfused
    classifier routes). Each epoch must run phase A and phase B on every
    full batch of the fake buffer; the fake clouds must differ from the
    real ones (the mean |fake - real| the GAN epoch logs);
    ``model_gan.pth`` must reload into
    a fresh ``build_gan`` bit for bit; the missing ScanObjectNN-C tree must
    be logged and skipped; the best val OA must reach ADAPT_CLI_MIN_OA.
    Returns the child's launch counts."""
    import glob
    import re
    import torch
    from adaptpoint_tpu_torch.engine import build_gan
    from adaptpoint_tpu_torch.utils import EasyConfig
    cfg_path = "cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml"
    root = os.path.join(ROOT, "build", "chip_smoke", "adapt_cli")
    opts = ["dataset.common.NAME=SyntheticCls",
            "dataset.common.num_points=2048",
            "dataset.common.num_classes=15",
            f"dataset.common.size={CLI_SIZE}", "seed=1", "batch_size=32",
            f"epochs={ADAPT_CLI_EPOCHS}", f"root_dir={root}"]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "adaptpoint_tpu_torch.main", "--cfg",
         cfg_path] + opts, cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the CLI exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    counts = json.loads(out.stdout.strip().splitlines()[-1])["launch_counts"]
    runs = sorted(glob.glob(os.path.join(root, "scanobjectnn", "*")),
                  key=os.path.getmtime)
    run_dir = runs[-1]
    name = os.path.basename(run_dir)
    log = open(os.path.join(run_dir, "log.txt")).read()
    files = {f: os.path.exists(os.path.join(run_dir, f)) for f in (
        "cfg.yaml", "scalars.jsonl", "model_gan.pth",
        f"checkpoint/{name}_ckpt_latest.pth",
        f"checkpoint/{name}_ckpt_best.pth")}
    phases = [(float(a), float(b)) for a, b in re.findall(
        r"phase_a_seconds ([0-9.]+) phase_b_seconds ([0-9.]+)", log)]
    phase_b = [(int(nb), int(nf)) for nb, nf in re.findall(
        r"phase B: (\d+) batches of (\d+) fake clouds", log)]
    val_oas = [float(v) for v in re.findall(r"val_oa ([0-9.]+)", log)]
    best = max(val_oas) if val_oas else float("nan")
    skipped = log.count("skipping corruption eval")
    moved = [float(v) for v in re.findall(
        r"mean \|fake - real\| ([0-9.eE+-]+)", log)]
    # the GAN pair reloads into a fresh build_gan, bit for bit
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, cfg_path), recursive=True)
    cfg.update_opts(opts)
    saved = torch.load(os.path.join(run_dir, "model_gan.pth"),
                       map_location="cpu", weights_only=True)
    gen, dis, _, _, _ = build_gan(cfg, DEV, 1)
    gen.load_state_dict(saved["generator"], strict=True)
    dis.load_state_dict(saved["discriminator"], strict=True)
    reloaded = all(torch.equal(v.cpu(), saved[part][k])
                   for part, mod in (("generator", gen),
                                     ("discriminator", dis))
                   for k, v in mod.state_dict().items())
    emit("adapt_cli", seconds=seconds, phase_seconds=phases,
         phase_b_batches=phase_b, val_oa=val_oas, best_val_oa=best,
         min_oa=ADAPT_CLI_MIN_OA, sweep_skipped=skipped, files=files,
         fake_minus_real_mean_abs=moved, gan_pair_reloads=reloaded,
         launches=counts, run_dir=os.path.relpath(run_dir, ROOT))
    if not all(files.values()):
        raise AssertionError(f"the CLI's run directory lacks {files}")
    if len(phases) != ADAPT_CLI_EPOCHS or not all(a > 0 and b > 0
                                                  for a, b in phases):
        raise AssertionError(f"phase A and B each epoch: {phases}")
    if len(phase_b) != ADAPT_CLI_EPOCHS or any(
            nf != CLI_SIZE or nb != nf // B for nb, nf in phase_b):
        raise AssertionError(f"phase B batches: {phase_b}")
    if len(moved) != ADAPT_CLI_EPOCHS or min(moved) <= 0.0:
        raise AssertionError(f"fake clouds equal to the real ones: {moved}")
    if not reloaded:
        raise AssertionError("model_gan.pth does not reload bit for bit")
    if skipped < 2:
        raise AssertionError("the missing ScanObjectNN-C sweep was not "
                             "logged as skipped")
    if not best >= ADAPT_CLI_MIN_OA:
        raise AssertionError(f"best val OA {best} below {ADAPT_CLI_MIN_OA}")
    return counts


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,serve,train,train_fused,cli,adapt,"
                            "adapt_bf16,window,adapt_cli",
                    help="comma-separated subset of kernels,serve,train,"
                         "train_fused,cli,adapt,adapt_bf16,window,adapt_cli "
                         "for a partial run, which prints no final result "
                         "(default: all); attention alone runs the kernel "
                         "phase's attention checks and times")
    phases = set(ap.parse_args(argv).phases.split(","))
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adaptpoint_tpu_torch import resolve_device
    from adaptpoint_tpu_torch.ops import _build

    resolve_device()  # TF32 off
    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = phase_kernels(gen) if "kernels" in phases else None
    if "attention" in phases and rows is None:
        check_attention(gen, {})
    by_path = {}
    if "serve" in phases:
        out_dir = os.path.join(ROOT, "build", "chip_smoke")
        models, by_path["serve"] = phase_serve(gen, out_dir)
        phase_throughput(models, gen)
        del models
    if "train" in phases:
        by_path["train"] = phase_train(gen)
    if "train_fused" in phases:
        torch.cuda.empty_cache()
        by_path["train_fused"] = phase_train_fused(gen, rows)
    if "cli" in phases:
        torch.cuda.empty_cache()
        by_path["cli"] = phase_cli()
    f32_run = None
    if phases & {"adapt", "adapt_bf16"}:
        torch.cuda.empty_cache()
        ctx = adapt_setup(gen)
        if "adapt" in phases:
            by_path["adapt"], f32_run = phase_adapt(gen, ctx, "f32")
        if "adapt_bf16" in phases:
            torch.cuda.empty_cache()
            by_path["adapt_bf16"], _ = phase_adapt(gen, ctx, "bf16", f32_run)
        del ctx
    if "window" in phases:
        torch.cuda.empty_cache()
        by_path["window"], window_rows, _ = phase_window(gen)
        if rows is not None:
            rows.update(window_rows)
    if "adapt_cli" in phases:
        torch.cuda.empty_cache()
        by_path["adapt_cli"] = phase_adapt_cli()
    emit("done", seconds=time.perf_counter() - t_start)
    if rows is None or set(by_path) != set(PATH_KERNELS):
        print(f"partial run ({sorted(phases)}): no final result",
              file=sys.stderr)
        return 0

    pallas = "adaptpoint_tpu/ops/pallas/"
    sources = {"fps": ("fps.cu", pallas + "fps.py:85"),
               "ball_group": ("ballgroup.cu", pallas + "ballgroup.py:491"),
               "sa_eval": ("saeval.cu", pallas + "saeval.py:252"),
               "ball_group_bwd": ("ballgroup_bwd.cu",
                                  pallas + "ballgroup.py:547"),
               "ball_group_max": ("ballgroup_max.cu",
                                  pallas + "ballgroup.py:791"),
               "ball_group_max_bwd": ("ballgroup_max.cu",
                                      pallas + "ballgroup.py:851"),
               "sa_train": ("saeval.cu", pallas + "saeval.py:503"),
               "sa_train_bwd": ("sa_train_bwd.cu", pallas + "saeval.py:615"),
               "gather_rows": ("gather.cu", pallas + "gather.py:110"),
               "gather_rows_bwd": ("gather.cu", pallas + "gather.py:144"),
               "mha": ("attention.cu", pallas + "attention.py:128"),
               "mha_bwd": ("attention.cu", pallas + "attention.py:158"),
               "knn": ("knn.cu", pallas + "knn.py:107"),
               "fpinterp": ("fpinterp.cu", pallas + "fpinterp.py:149"),
               "fpinterp_bwd": ("fpinterp.cu", pallas + "fpinterp.py:178"),
               "sa_trainbn_stats": ("satrainbn.cu",
                                    pallas + "satrainbn.py:507"),
               "sa_trainbn_fwd": ("satrainbn.cu", pallas + "satrainbn.py:526"),
               "sa_trainbn_bwd_w2": ("satrainbn.cu",
                                     pallas + "satrainbn.py:637"),
               "sa_trainbn_bwd_x": ("satrainbn.cu",
                                    pallas + "satrainbn.py:657"),
               "ball_group_max_windowed": ("window.cu",
                                           pallas + "window.py:368"),
               "ball_group_max_windowed_bwd": ("window.cu",
                                               pallas + "window.py:450")}
    for path, names in PATH_KERNELS.items():
        never = [n for n in names if by_path[path][n] < 1]
        if never:
            raise AssertionError(f"never launched on the {path} path: "
                                 f"{never}")
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        launches = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptpoint_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
        for extra in ("resample_shape", "feature_shape",
                      "gan_classifier_shapes", "gan_step_shapes", "shape",
                      "ms_forward_only", "bound_parts_ms", "composite_ms",
                      "device_ms", "host_us", "library_device_ms",
                      "library_host_us", "stages_ms", "stages_device_ms",
                      "stages_host_us", "stages_bound_ms",
                      "ms_with_d_w", "bound_ms_with_d_w", "full_n_op_ms",
                      "bound_ms_f32_cores",
                      "ns_a_step", "gan_step_shape", "stand_in_ms", "bf16",
                      "op_launches_bf16", "op_launches"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
