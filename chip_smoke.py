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
   and at the edges of FPS_EDGES: B = 1, N = 1000 and 4097 with npoint = N,
   npoint = 1, half the points at the origin, N = 300, N = 16384, the
   pruned kernel up to 100003 points on surfaces and duplicated points and
   on a sphere padded by resampling (16384 points, 3000 distinct), with its
   plan against the host's copy; the four SA stages at
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
   k = 32, ragged query counts, B = 1, ties, k > N, both variants); its tiled
   instance (past ``knn_max_points(C)``) at DGCNN's three feature-space calls
   (B = 32, N = M = 1024, k = 20, C = 64, 64, 128; timed beside the plain
   version and the stand-in) and at KNN_TILED_EDGES and
   KNN_TILED_PLAN_EDGES (N = knn_max_points(C)
   and one more at C = 64, 128, 256, ties, B = 1, C = 3 past 14528 points,
   C = 1416, k = 1, N and M off the tiles, C = 67 and 132 off the
   stages, C = 2100, runs of equal points, NaN and +inf rows, k = 32 over
   N < 32 on the library's launcher directly), its plan against the
   wrapper's copy and its device ops
   a call (KNN_TILED_OPS, in the op-count child; ``--phases knn_tiled`` runs
   this part alone); the flash
   attention forward and backward, directly and through autograd, for bf16 and
   f32 inputs, at (128, 2048, 16) and at every head dim across the tiles' edges
   (N = 1, 40, 127, 128, 129, 2047), dq and dk within TOL_MHA of the dS
   formed from the forward's saved statistics plus what the bf16 roundings
   of dS may move them by (``mha_stats_reference``, the flips it allowed
   reported), the saved statistics held to the function, on the shared
   generator's draws, on a fresh draw of every shape from each of
   MHA_FRESH_SEEDS and on ROADMAP C.11's draw replayed, two backward runs
   bit for bit equal, timed
   at (128, 2048, 16) for both input types beside
   ``scaled_dot_product_attention`` (``--phases attention`` runs this part
   alone); the 3-NN weighted gather forward and backward at the four
   feature-propagation levels of a bf16 ``gan_step``, with repeated neighbours
   and on a cloud with half its points at the origin), with errors, tolerances,
   bounds and CUDA-event times; for FPS, the kNN, the differentiable fused SA
   backward (per stage) and the row gather and its scatter-add (per shape, beside
   ``torch.gather`` and ``index_add_``) also the card's time of the call alone
   from the profiler and the host's enqueue time a call. Then the same
   checks at the ModelNet-C path's shapes (``phase_modelnet_kernels``;
   ``--phases modelnet_kernels`` runs them alone): PointNeXt-S at width 64
   from N = 1024 (STAGES_64: C = 64 -> 128 up to 512 -> 1024) for the ball
   group, the fused SA, the differentiable fused SA forward and backward
   and the four train-BN passes (their plans and shared memory against the
   host's copy, ``satrainbn.plan_host``), and the AdaptPoint step at
   N = 1024 for the max-pooled ball group, the kNN and the mask head's
   attention.
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
   too where ``ok`` is False, and the same bits on a second forward launch;
   one device op a call each way (``window_op_launches``, in a child
   process of its own, which also counts the ``seg`` phase's FPS ops where
   that phase runs); CUDA-event
   times of the kernels, of ``window_prep``, of the four un-permute gathers
   the JAX op makes, and of the op forward and forward+backward beside row
   7/8's op; then the same checks at ``WINDOW_EDGES`` (K = 1 to 255, C = 3
   to 1024, N = 1000, splits 1-3, overflowing windows, misaligned
   features) and at every forced launch shape (``WINDOW_FORCED``).
12. ``adapt_cli``: ``python -m adaptpoint_tpu_torch.main --cfg
   cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml`` (``mode: adaptpoint``)
   in a child process on SyntheticCls at the ``cli`` phase's sizes for
   three epochs at the card's defaults: phase A and phase B each epoch
   (every full batch of the 960 fake clouds), fake clouds that moved from
   the real ones, ``model_gan.pth`` reloading into a fresh ``build_gan`` bit
   for bit, the skipped ScanObjectNN-C sweep logged, a best val OA of at
   least ADAPT_CLI_MIN_OA, and the child's launch counts (rows 1-15).
13. ``modelnet_cli``: the ModelNet-C protocol through the CLI in child
   processes on SyntheticCls (1024 points, 40 classes, PointNeXt-S at width
   64, B=32): ``cfgs/modelnetc/pointnext-s_adaptpoint.yaml`` (``mode:
   adaptpoint_modelnet``) with ``rsmix_params`` for MN_EPOCHS epochs, the
   same resumed (``resume=True``) for one epoch more (resumed at the next
   epoch with the GAN pair reloaded, exactly one epoch run), then
   ``cfgs/modelnetc/pointnext-s.yaml`` (``mode: modelnetc``) with
   ``pointwolf`` for one epoch on the fused train-BN and eval routes; each
   logs its skipped ModelNet-C sweep. In this process the ModelNet-C sweep
   (``eval_corrupt_wrapper_modelnetc``) on the first run's best weights: 1
   clean and 35 corrupt splits in ``outcorruption.txt``, mCE and RmCE equal
   to ``calculate_ce`` of its OAs; without ``h5py`` the h5 read alone is
   replaced by arrays the script made. The launch counts of the three
   children and the sweep (rows 1-19).
14. ``partseg``: part segmentation at full width
   (``cfgs/shapenetpart/pointnext-s.yaml``: PointNeXt-S, strides [1, 2, 2,
   2, 2], the curvenet part decoder, 50 part labels) with seeded weights on
   seeded (32, 2048) ``SyntheticPartSeg`` batches, no resampling: the first
   train step against the same step through the plain versions on the card
   and on a float64 CPU copy, the launches a step makes on the unfused route
   (FPS 1, ball group 4 + 4, kNN 4, row gather 8, scatter-add 4) and on the
   fused train-BN switch (its first step against the unfused one), three
   more steps, the B = 64 eval forward on both routes (unfused against the
   plain versions, fused against unfused) and ``validate_partseg`` over a
   padded last batch; then every kernel of the path against its plain
   version at the model's shapes (FPS at B = 32 and 64, rows 2 and 4 at the
   four N = 2048 stages, row 3 at the stages of a B = 64 fused eval forward,
   rows 16-19 at the fused step's stages with their plans, the kNN and the
   row gather and scatter-add at the decoder's four FP levels); ms per train
   step and per B = 64 eval forward on both routes, in turns, with the
   profiler's device-busy time.
15. ``partseg_cli``: ``python -m adaptpoint_tpu_torch.partseg --cfg
   cfgs/shapenetpart/pointnext-s_adaptpoint.yaml`` (``mode: adaptpoint``)
   in child processes on SyntheticPartSeg (PS_SIZE clouds of 2048 points a
   split) at the card's defaults: PS_EPOCHS epochs with phase A and phase B
   each, fake clouds that moved from the real ones, ``model_gan.pth``
   reloading into a fresh ``build_gan`` bit for bit, finite instance and
   class mIoUs; ``mode=test`` on the best checkpoint giving the best epoch's
   validation metrics; ``resume=True`` for one epoch more. In this process the
   ShapeNet-C sweep (``eval_corrupt_wrapper_shapenetc``) on the best
   weights, fused eval: 1 clean and 35 corrupt splits in
   ``outcorruption.txt``; without ``h5py`` the h5 read alone is replaced by
   arrays the script made. The launch counts of the three children and the
   sweep.
16. ``seg``: S3DIS scene segmentation at full width
   (``cfgs/s3dis/pointnext-b.yaml``: PointNeXt-B, width 32, blocks [1, 2,
   3, 2, 2], strides [1, 4, 4, 4, 4], 13 classes) with seeded weights on
   B = 8 ``SyntheticScene`` crops of N = 24000 points under the cfg's
   transforms: the first train step against the same step through the plain
   versions on the card, the launches a step makes (FPS 1, ball group 9 +
   9: four SA stages and five InvResMLP blocks, kNN 4, row gather 8,
   scatter-add 4), the eval forward against the plain versions and
   ``validate_seg`` over a padded last batch; ``cfgs/s3dis/pointnext-s.yaml``
   at the same size, its fused train-BN step against its unfused step (the
   gate admits only stage 1's 6000 centers) and its fused eval forward
   against its unfused one; then every kernel of the path against its plain
   version at the models' shapes (FPS 24000 -> 6000 on the pruned kernel,
   beside the earlier four-block instance on the same crops, and the FPS
   call's device ops, one at most three, in the op-count child process; the
   ball group at the step's nine calls, the FP levels' kNN and gathers, row
   3 at the S model's eval stages, rows 16-19 at its fused stage); ms per
   train step and per eval forward of both models (S on both routes) with
   the profiler's device-busy time and peak memory; then
   ``cfgs/s3dis/pointnext-l.yaml`` and ``pointnext-xl.yaml`` (SEG_BIG) on
   the same batches: one train step against the same step through the plain
   versions on the card, one eval forward against the plain versions, the
   launches (a ball group each SA stage and InvResMLP block), peak memory
   and ms of each. B's step and eval on rooms of surfaces, and with the
   earlier FPS instance, are timed by
   ``scripts/torch_fps_knn_timing.py --steps``.
17. ``sphere``: the S3DIS sphere protocol at full width
   (``cfgs/s3dis/pointnext-s_sphere.yaml``: PointNeXt-S, sa_layers 2,
   ``S3DISSphere``, ``MaskedCrossEntropy``, ``validate_sphere``) on a
   seeded tree of rooms of surfaces, B = 8 spheres of N = 16384 points
   (``phase_sphere``): the loaders from the cfg with the schedule cut, the
   first masked train step against the plain versions on the card and on
   the fused train-BN route (all four stages pass its gate) against the
   unfused one, the eval logits of both routes, ``validate_sphere`` over a
   padded last batch with its host time, the launches of each, every
   kernel of the path at its shapes (``sphere_shapes``), ms per step and
   eval forward on both routes.
18. ``seg_cli``: ``python -m adaptpoint_tpu_torch.seg --cfg
   cfgs/s3dis/pointnext-b.yaml`` in child processes on SyntheticScene crops
   of 24000 points (SEG_CLI_SIZE a split, B = 8): SEG_CLI_EPOCHS epochs,
   ``mode=test`` and ``mode=val`` on the best checkpoint giving exactly the
   best epoch's mIoU, mAcc and OA, ``mode=resume`` to one epoch more; the
   sphere cfg's ``train`` (two epochs), ``mode=test`` on its best checkpoint
   and ``mode=resume``; ``mode=test_6fold`` over six seeded areas; the
   launch counts of the children.
19. ``baselines``: the corruption protocols' baseline classifiers at full
   width (BASELINES: ``cfgs/scanobjectnn/{dgcnn,pointnet++,pointnet,
   pointmlp}.yaml``, ``cfgs/modelnetc/dgcnn.yaml``) with seeded weights on a
   seeded (32, 2048) batch: one train step and one eval forward each against
   the same through the plain versions on the card (DGCNN's kNN graphs
   shared, each graph's rows that the plain run would have chosen alike
   reported), the launches of each against BASELINES, ms, device-busy ms,
   idle share and peak memory of each; then rows 14 and 15 at DGCNN's edges
   (its xyz graph, C = 4, 64, 128).
20. ``baselines_cli``: ``python -m adaptpoint_tpu_torch.main --cfg
   cfgs/scanobjectnn/dgcnn.yaml`` in a child on SyntheticCls for one epoch,
   then ``cfgs/modelnetc/dgcnn.yaml`` (``mode: modelnetc``) in this process
   for one epoch and its ModelNet-C sweep (1 clean + 7 x 5 splits, mCE);
   the launch counts of both.
21. ``pointvit``: PointViT at the full width of
   ``cfgs/scanobjectnn/pointvit.yaml`` (embed 384, depth 12, 6 heads, 256
   groups of 32; 22.9 M parameters), seeded weights, on a seeded (32, 2048)
   blob batch: one train step (2048 -> 1200 -> 1024, SmoothCE, AdamW, clip
   at 10) and a B = 64 eval forward, each against the same through the
   plain versions on the card (loss, logits, equal predictions, gradients
   by relative 2-norm), the launches of each against VIT_LAUNCHES, ms, host
   enqueue, busy ms, idle share, launches, peak memory and top device ops;
   rows 1, 11 and 14 at its shapes (FPS 1024 -> 256 and the k = 32 graph at
   C = 3 at B = 32 and 64, exact; the centers' and the (B, 256, 32, 4)
   features' gathers); the decoders (both samplers, and under the bf16
   policy, rows 12 and 13), P3Embed, KMeansEmbed and ViTGraph, one forward
   and backward each at VIT_SMALL against their plain versions, their
   launches in ``pointvit_modules`` and not in the path's.
22. ``pointvit_cli``: ``python -m adaptpoint_tpu_torch.main --cfg
   cfgs/scanobjectnn/pointvit.yaml`` in a child on SyntheticCls at full
   width for two epochs, then in this process ``mode=test`` (the run's OA),
   ``mode=resume`` to a third epoch, ``mode: scanobjectnnc`` and
   ``resume=True``; the launch counts of each.

Each phase prints its seconds as it ends (``phase_seconds``). Then the
card's name and power limit as nvidia-smi prints them, the
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
                  "fpinterp_bwd", "gather_rows", "gather_rows_bwd"),
    "modelnet_cli": ("fps", "ball_group", "sa_eval", "ball_group_bwd",
                     "sa_train", "sa_train_bwd", "ball_group_max",
                     "ball_group_max_bwd", "mha", "mha_bwd", "knn",
                     "fpinterp", "fpinterp_bwd", "gather_rows",
                     "gather_rows_bwd", "sa_trainbn_stats", "sa_trainbn_fwd",
                     "sa_trainbn_bwd_w2", "sa_trainbn_bwd_x"),
    "partseg": ("fps", "ball_group", "ball_group_bwd", "sa_eval", "knn",
                "gather_rows", "gather_rows_bwd", "sa_trainbn_stats",
                "sa_trainbn_fwd", "sa_trainbn_bwd_w2", "sa_trainbn_bwd_x"),
    "partseg_cli": ("fps", "ball_group", "ball_group_bwd", "sa_eval",
                    "ball_group_max", "ball_group_max_bwd", "mha", "mha_bwd",
                    "knn", "gather_rows", "gather_rows_bwd"),
    "seg": ("fps", "ball_group", "ball_group_bwd", "knn", "gather_rows",
            "gather_rows_bwd", "sa_eval", "sa_trainbn_stats",
            "sa_trainbn_fwd", "sa_trainbn_bwd_w2", "sa_trainbn_bwd_x"),
    "seg_cli": ("fps", "ball_group", "ball_group_bwd", "knn", "gather_rows",
                "gather_rows_bwd"),
    "sphere": ("fps", "ball_group", "ball_group_bwd", "knn", "gather_rows",
               "gather_rows_bwd", "sa_eval", "sa_trainbn_stats",
               "sa_trainbn_fwd", "sa_trainbn_bwd_w2", "sa_trainbn_bwd_x"),
    "baselines": ("fps", "ball_group", "ball_group_bwd", "knn", "knn_tiled",
                  "gather_rows", "gather_rows_bwd"),
    "baselines_cli": ("fps", "knn", "knn_tiled", "gather_rows",
                      "gather_rows_bwd"),
    "pointvit": ("fps", "knn", "gather_rows"),
    "pointvit_cli": ("fps", "knn", "gather_rows")}
# names of the hand-written kernels as the profiler prints them
OWN_KERNELS = ("fps_kernel", "ball_group_kernel", "ball_group_bwd_kernel",
               "ball_group_max_kernel", "ball_group_max_bwd_kernel",
               "sa_eval_kernel", "sa_train_bwd_kernel", "gather_rows_kernel",
               "gather_rows_bwd_kernel", "gather_rows_bwd_l2red_kernel",
               "mha_cast_bf16_kernel", "mha_fwd_kernel",
               "mha_bwd_prep_kernel", "mha_bwd_kernel",
               "mha_dq_reduce_kernel", "knn_thread_kernel", "knn_warp_kernel",
               "knn_tiled_kernel",
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
# the ModelNet-C path (``cfgs/modelnetc/pointnext-s*.yaml``: PointNeXt-S at
# width 64, 40 classes, N = 1024, in_channels 3): the four strided SA stages
# (N -> M, C in, mid, C out, radius), the AdaptPoint step's groupers at
# N = 1024 (N -> M, C, radius) and its mask head's attention (BH, N, d)
STAGES_64 = [(1024, 512, 64, 64, 128, 0.15), (512, 256, 128, 128, 256, 0.225),
             (256, 128, 256, 256, 512, 0.3375),
             (128, 64, 512, 512, 1024, 0.50625)]
GAN_STAGES_1024 = [(1024, 512, 128, 0.1), (512, 256, 256, 0.2),
                   (256, 128, 512, 0.4), (128, 64, 1024, 0.8)]
MHA_SHAPE_1024 = (128, 1024, 16)
# the modelnet_cli phase: SyntheticCls clouds of 1024 points in 40 classes
# (MN_SIZE a split, B = 32), AdaptPoint + RSMix for MN_EPOCHS epochs, one
# more resumed, then mode: modelnetc with PointWOLF for one; the in-process
# ModelNet-C sweep on MN_C_SIZE clouds a split
MN_SIZE, MN_EPOCHS, MN_C_SIZE = 640, 2, 64
MN_RSMIX = "rsmix_params={'beta':1.0,'rsmix_prob':0.5,'nsample':32,'knn':True}"
# the part-segmentation path (``cfgs/shapenetpart/pointnext-s.yaml``:
# PointNeXt-S at width 32, strides [1, 2, 2, 2, 2], 50 part labels, 16
# shape categories, N_PARTSEG points with no resampling, B = 32 in training
# and PARTSEG_VAL_B in validation): its four SA stages (N -> M, C in, mid,
# C out, radius) and the decoder's four FP levels (queries, coarse points,
# channels of the coarse features), deepest first
N_PARTSEG, PARTSEG_VAL_B = 2048, 64
PARTSEG_STAGES = [(2048, 1024, 32, 32, 64, 0.1),
                  (1024, 512, 64, 64, 128, 0.2),
                  (512, 256, 128, 128, 256, 0.4),
                  (256, 128, 256, 256, 512, 0.8)]
PARTSEG_LEVELS = [(256, 128, 512), (512, 256, 256), (1024, 512, 128),
                  (2048, 1024, 64)]
# the first part-segmentation train step on the card against the float64
# CPU copy, and the fused train-BN step against the unfused one: the
# classifier's TOL_STEP_CPU, wider where the decoder carries f32 roundings
# to every point. Its logits pass the 3-NN weights of four FP levels and the
# BatchNorms of eight FP convs, and a beta in front of a max-pool gets its
# gradient from the few rows that win (the plain versions in f32 on the CPU,
# at B = 8, sit a relative 2.4e-2 from float64 there and 7e-4 on logits of
# 5.4). And where a point is one of the coarse points it interpolates from
# (every point of the next level is), its f32 distance to itself is 0 or the
# residue of the expanded form |q|^2 + |p|^2 - 2 q.p, so its weights, and
# its logits, may move by a few percent against float64, whose residue is
# far smaller, and the points that interpolate from it with them: hence
# logits_share of the logits within the tight bound, every one within
# logits_all of the largest. On the H100 2.1 % of the logits left the tight
# bound, on 5171 of 65536 points, 4276 of them coarse points (half of all
# points are), the worst at 0.99 % of the largest logit. The fused eval
# forward against the unfused one: |fused - unfused| <= TOL_SA * (1 +
# |unfused|), and at least PARTSEG_ARGMAX_SHARE of the points with the same
# argmax (logits of random weights lie close together)
TOL_PARTSEG_STEP = {"loss": 1e-5, "logits": (2e-3, 2e-3),
                    "logits_share": 0.95, "logits_all": 5e-2, "grad_l2": 5e-2,
                    "buffers": (1e-4, 1e-5), "share": 0.9}
PARTSEG_ARGMAX_SHARE = 0.99
# the partseg_cli phase: SyntheticPartSeg clouds of N_PARTSEG points
# (PS_SIZE a split, B = 32, val B = 64) for PS_EPOCHS epochs of AdaptPoint,
# one more resumed; the in-process ShapeNet-C sweep on PS_C_SIZE clouds a
# split
PS_SIZE, PS_EPOCHS, PS_C_SIZE = 128, 2, 64
# the S3DIS path (``cfgs/s3dis/pointnext-b.yaml``: PointNeXt-B at width 32,
# blocks [1, 2, 3, 2, 2], strides [1, 4, 4, 4, 4], 13 classes, features
# ``x,heights``) on SEG_B crops of N_SEG points, the cfg's batch and
# ``voxel_max``: its four strided SA stages (N -> M, C in, mid, C out,
# radius; mid unused at sa_layers 1), its InvResMLP blocks (N, C, radius;
# query = support) and the decoder's FP levels (queries, coarse points,
# coarse channels), deepest first
N_SEG, SEG_B = 24000, 8
# the earlier FPS instance at N_SEG, timed beside the pruned kernel: a cluster
# of four blocks of 1024 threads of 6 points
FPS_PARENT_INSTANCE = (4096, 6)
SEG_STAGES = [(24000, 6000, 32, 0, 64, 0.1), (6000, 1500, 64, 0, 128, 0.2),
              (1500, 375, 128, 0, 256, 0.4), (375, 93, 256, 0, 512, 0.8)]
SEG_BLOCKS = [(6000, 64, 0.2), (1500, 128, 0.4), (1500, 128, 0.4),
              (375, 256, 0.8), (93, 512, 1.6)]
SEG_LEVELS = [(375, 93, 512), (1500, 375, 256), (6000, 1500, 128),
              (24000, 6000, 64)]
# the first seg train step on the card against the same step through the
# plain versions on the card: the forward is the same bits (every kernel of
# it is exact), the backward's scatters add in another order, so the band
# is TOL_STEP_PLAIN's. PointNeXt-S's fused train-BN step against its
# unfused step (only stage 1, 6000 centers, passes the gate) and its fused
# eval forward against the unfused one: part segmentation's bands
# (TOL_PARTSEG_STEP; TOL_SA and SEG_ARGMAX_SHARE of the points' argmax)
SEG_ARGMAX_SHARE = 0.99
# the seg_cli phase: SyntheticScene crops of N_SEG points, SEG_CLI_SIZE a
# split, SEG_B a batch, SEG_CLI_EPOCHS epochs, then mode=test, mode=val and
# mode=resume to one epoch more
SEG_CLI_SIZE, SEG_CLI_EPOCHS = 16, 2
# the sphere path (``cfgs/s3dis/pointnext-s_sphere.yaml``: PointNeXt-S at
# width 32, blocks [1, 1, 1, 1, 1], sa_layers 2, residual, 13 classes,
# ``MaskedCrossEntropy``) on SEG_B spheres of N_SPHERE points from
# ``S3DISSphere``: its four SA stages (N -> M, C in, mid unused, C out,
# radius; every one passes the train-BN gate) and the decoder's FP levels
N_SPHERE = 16384
SPHERE_STAGES = [(16384, 4096, 32, 0, 64, 0.1), (4096, 1024, 64, 0, 128, 0.2),
                 (1024, 256, 128, 0, 256, 0.4), (256, 64, 256, 0, 512, 0.8)]
SPHERE_LEVELS = [(256, 64, 512), (1024, 256, 256), (4096, 1024, 128),
                 (16384, 4096, 64)]
# the seeded S3DIS tree the sphere paths read: SPHERE_ROOMS rooms of
# surfaces (scripts/surface_rooms.py) of SPHERE_ROOM_POINTS raw points an
# area, side by side, labels by height; Area_1 trains, Area_5 validates.
# The cfg's schedule (100 epochs of 500 spheres) is cut to
# SPHERE_TRAIN_STEPS spheres (three batches) and SPHERE_VAL_STEPS (a padded
# last batch of three)
SPHERE_ROOMS, SPHERE_ROOM_POINTS = 2, 40000
SPHERE_TRAIN_STEPS, SPHERE_VAL_STEPS = 3 * SEG_B, SEG_B + 3
# PointNeXt-L and -XL (cfgs/s3dis/pointnext-{l,xl}.yaml) in the seg phase:
# one train step and one eval forward each at SEG_B crops of N_SEG points
SEG_BIG = ("pointnext-l.yaml", "pointnext-xl.yaml")


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
    point, or all N when the ball holds fewer. Taken over slices of the
    queries, so that a scene-sized support (24000 points) stays small."""
    import torch
    from adaptpoint_tpu_torch.ops.geometry import index_points, radius_sq
    q_all = index_points(xyz, qidx)
    b, n = xyz.shape[:2]
    step = max(1, (1 << 25) // (b * n))
    total = 0
    for lo in range(0, q_all.shape[1], step):
        q = q_all[:, lo:lo + step]
        d = q[:, :, None, :] - xyz[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2])
        del d
        cum = torch.cumsum((d2 < radius_sq(radius)).int(), dim=-1)
        full = cum[..., -1] >= K
        kth = torch.argmax((cum >= K).int(), dim=-1) + 1
        total += int(torch.where(full, kth, torch.full_like(kth, n)).sum())
    return total


def check_stages_forward(gen, stages, bg_inputs, sa_inputs):
    """The ball-group kernel on ``bg_inputs`` and the fused SA kernel
    (folded weights at each stage's widths) on ``sa_inputs`` (either
    ``None``: not checked), K neighbours, dp normalised as PointNeXt-S asks,
    each against its plain version, at the batch the inputs hold. Returns
    their rows, summed over the stages."""
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
        bg_row = sa_row = None
        if bg_inputs is not None:
            xyz, qidx, feats = bg_inputs[i]
            B = xyz.shape[0]
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
        if sa_inputs is None:
            emit("stage_times", stage=i + 1, shape=[B, n, m, c, K],
                 ball_group=bg_row)
            continue

        xyz, qidx, feats = sa_inputs[i]
        B = xyz.shape[0]
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
    return bg, (sa if sa_inputs is not None else None)


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
        B = xyz.shape[0]
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
    zeros to add to), nothing else, held as ``held_op_launches`` holds
    them."""
    import torch
    from adaptpoint_tpu_torch import ops
    x_req = xyz.clone().requires_grad_()
    f_req = feats.clone().requires_grad_()
    b, m, c = qidx.shape[0], qidx.shape[1], feats.shape[2]
    gs = (torch.randn((b, m, 3), generator=gen, device=DEV),
          torch.randn((b, m, c), generator=gen, device=DEV),
          torch.randn((b, K, m, 3 + c), generator=gen, device=DEV))
    out = ops.ball_group(radius, K, x_req, qidx, f_req, True, True)
    calls = {"forward": lambda: ops.ball_group(radius, K, x_req, qidx, f_req,
                                               True, True),
             "backward": lambda: torch.autograd.grad(
                 out[:3], (x_req, f_req), gs, retain_graph=True)}
    want = {"forward": {"ball_group_kernel<": 1},
            "backward": {"ball_group_bwd_kernel": 1, "emset": 2}}
    found, profiles, bad = held_op_launches(calls, want)
    emit("ball_group_op_launches", shape=[b, xyz.shape[1], m, c, K],
         forward=found.get("forward"), backward=found.get("backward"),
         profiles_taken={k: len(v) for k, v in profiles.items()},
         profiles_short={k: v[:-1] for k, v in profiles.items()
                         if len(v) > 1},
         expected="forward: the kernel alone; backward: the kernel and the "
                  "memsets of its two outputs")
    if bad:
        raise AssertionError(f"ops.ball_group launches {bad}")
    return {k: sum(v.values()) for k, v in found.items()}


# FPS edge cases, each exact against the plain version: (B, N, npoint, share
# of points moved to the origin, or the kind of cloud: "surface" a seeded
# room of surfaces, as S3DIS crops are, "duplicated" every point twice and a
# seventh of them on the first); every instance of the kernels
# (fpsample.FPS_INSTANCES): the chain kernel up to 4096 points, the pruned
# kernel past it on each of its four launches: one bucket a thread (ties
# across buckets, a last bucket with padding, npoint = N, 16384 and 32768
# points), two with the minima in shared memory (40000), in the scratch
# (65536) and buckets of 64 (100003); a sphere of the sphere protocol
# padded by resampling (3000 distinct of 16384 points, npoint 4096: every
# step past the 3000th finds all minima 0 and picks index 0)
FPS_EDGES = [(1, 1024, 512, 0.0), (2, 1000, 1000, 0.0), (2, 4097, 4097, 0.0),
             (4, 2048, 1, 0.0), (4, 2048, 1024, 0.5), (2, 300, 300, 0.0),
             (2, 4096, 2048, 0.0), (2, 16384, 4096, 0.0),
             (3, 16385, 2000, 0.5), (2, 24577, 1500, 0.0),
             (1, 32768, 1000, 0.0), (8, 24000, 6000, "surface"),
             (2, 24000, 3000, "duplicated"), (1, 40000, 1000, 0.0),
             (1, 65536, 1000, 0.0), (2, 100003, 500, 0.0),
             (2, 16384, 4096, "padded")]


def fps_cloud(gen, b: int, n: int, kind):
    """A (b, n, 3) cloud of FPS_EDGES on the card: gaussian with ``kind``'s
    share at the origin, a seeded room of surfaces, duplicated points, or a
    sphere of 3000 distinct points padded by resampling."""
    import numpy as np
    import torch
    from scripts.surface_rooms import padded_sphere, surface_room
    if kind == "padded":
        seed = int(torch.randint(1 << 30, (1,), generator=gen,
                                 device=DEV).item())
        rng = np.random.default_rng(seed)
        return torch.from_numpy(np.stack([padded_sphere(n, 3000, rng)
                                          for _ in range(b)])).to(DEV)
    if kind == "surface":
        seed = int(torch.randint(1 << 30, (1,), generator=gen,
                                 device=DEV).item())
        rng = np.random.default_rng(seed)
        return torch.from_numpy(np.stack([surface_room(n, rng)[0]
                                          for _ in range(b)])).to(DEV)
    if kind == "duplicated":
        half = torch.randn((b, n - n // 2, 3), generator=gen, device=DEV)
        xyz = torch.cat([half, half.flip(1)[:, :n // 2]], dim=1)
        xyz[:, ::7] = xyz[:, :1]
        return xyz.contiguous()
    xyz = torch.randn((b, n, 3), generator=gen, device=DEV)
    if kind:
        xyz = xyz * (torch.rand((b, n), generator=gen, device=DEV)
                     >= kind)[..., None]
    return xyz.contiguous()


def check_fps_edges(gen) -> None:
    """The FPS kernels at FPS_EDGES against their plain version, index for
    index: B = 1, N = 1000 with npoint = N, npoint = 1, a cloud with half
    its points at the origin (ties), N = 300 (threads without points),
    N = 4096 (the chain kernel's largest: 1024 threads of 4 points), then
    the pruned kernel from 4097 points (npoint = N) to 100003: 16385 with
    half its points at the origin, a room of surfaces at the S3DIS crop's
    24000 -> 6000, duplicated points (ties across buckets), and its minima
    in the scratch past 51200 points; together every instance of the
    kernels and each launch of the pruned kernel.
    Before them the kernel's own plan (``fps_pruned_plan``) against the
    host's copy (``fpsample.pruned_plan``) at every pruned edge and past
    it, and its refusal of the host's refusals."""
    from adaptpoint_tpu_torch.ops import fpsample as fps
    plans = [n for _, n, _, _ in FPS_EDGES if n > 4096] + [
        51200, 51201, 65537, 2 ** 29 - 2 ** 18, 2 ** 29 - 1, 0, -1]
    for n in plans:
        try:
            host = fps.pruned_plan(n)
        except ValueError:
            host = None
        if fps.pruned_plan_kernel(n) != host:
            raise AssertionError(f"the pruned FPS plan at N={n}: the "
                                 f"kernel's {fps.pruned_plan_kernel(n)}, "
                                 f"the host's {host}")
    if {tuple(fps.fps_tiling(n)) for _, n, _, _ in FPS_EDGES} \
            != set(fps.FPS_INSTANCES):
        raise AssertionError("FPS_EDGES miss an instance of the FPS kernel")
    for b, n, npoint, kind in FPS_EDGES:
        t0 = time.perf_counter()
        xyz = fps_cloud(gen, b, n, kind)
        got = fps.furthest_point_sample_cuda(xyz, npoint)
        ref = fps.furthest_point_sample_plain(xyz, npoint)
        mism = int((got != ref).sum())
        emit("kernel", name="fps", case="edge", shape=[b, n, npoint],
             cloud=kind, tiling=list(fps.fps_tiling(n)),
             mismatches=mism, tolerance="exact",
             seconds=time.perf_counter() - t0)
        if mism:
            raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                                 f"({b}, {n} -> {npoint}, {kind=})")


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


# DGCNN's feature-space kNN calls on ScanObjectNN (cfgs/scanobjectnn/
# dgcnn.yaml, B = 32, N = M = 1024, k = 20): C of each call past the xyz one
DGCNN_KNN_C = (64, 64, 128)
# the tiled instance off those shapes: (tag, B, N, M, C, k, kind of support);
# "direct" calls the library's knn_tiled_launch below knn_max_points(C),
# where the chooser keeps the support staged (k > N)
KNN_TILED_EDGES = [
    ("N = knn_max_points(64)", 2, None, 77, 64, 20, "at"),
    ("N = knn_max_points(64) + 1", 2, None, 77, 64, 20, "past"),
    ("N = knn_max_points(128)", 2, None, 77, 128, 20, "at"),
    ("N = knn_max_points(128) + 1", 2, None, 77, 128, 20, "past"),
    ("N = knn_max_points(256)", 2, None, 77, 256, 20, "at"),
    ("N = knn_max_points(256) + 1", 2, None, 77, 256, 20, "past"),
    ("ties, every point twice", 2, 1000, 50, 64, 20, "twice"),
    ("M = 13, B = 1, k = 32", 1, 1500, 13, 128, 32, "random"),
    ("C = 3 past 14528 points", 2, 14600, 40, 3, 24, "random"),
    ("C = 1416, N = 42, k = 32", 2, 42, 9, 1416, 32, "random"),
    ("k = 1", 2, 1200, 33, 96, 1, "random")]
# the edges of the tiled plan (64-point tiles, 64-query blocks, 64-channel
# stages, 4 x 4 micro-tiles, the warp lists), drawn from a generator of their
# own so that every check after this one sees the inputs it saw before they
# were added (ROADMAP C.11)
KNN_TILED_PLAN_EDGES = [
    ("N = 1021, M = 77: ragged tiles and blocks", 2, 1021, 77, 64, 20,
     "random"),
    ("C = 67: 4-byte copies, a 3-channel last stage", 2, 1100, 77, 67, 20,
     "random"),
    ("C = 132: a 4-channel last stage", 2, 900, 70, 132, 20, "random"),
    ("C = 2100: 33 stages a tile", 2, 300, 20, 2100, 20, "random"),
    ("runs of 3 equal points across tiles and micro-tiles", 2, 1021, 77, 64,
     20, "runs"),
    ("NaN and +inf rows, a NaN query", 2, 1100, 77, 64, 20, "bad"),
    ("k = 32, N = 20 (direct)", 2, 20, 33, 64, 32, "direct"),
    ("k = 32, N = 31, C = 3 (direct)", 2, 31, 65, 3, 32, "direct")]


def knn_tiled_edge_inputs(g, b, n_, m_, c, kind):
    """(support, query) of one tiled-kNN edge, drawn from ``g``."""
    import torch
    from adaptpoint_tpu_torch.ops import knn
    if kind in ("at", "past"):
        n_ = knn.knn_max_points(c) + (kind == "past")
    if kind == "twice":
        half = torch.randn((b, n_ // 2, c), generator=g, device=DEV)
        support = half.repeat(1, 2, 1).contiguous()
        support[:, ::7] = 0.0
    elif kind == "runs":  # points 3i, 3i + 1, 3i + 2 equal (63-65 too)
        third = torch.randn((b, -(-n_ // 3), c), generator=g, device=DEV)
        support = third.repeat_interleave(3, 1)[:, :n_].contiguous()
    else:
        support = torch.randn((b, n_, c), generator=g, device=DEV)
    h = min(m_ // 2, n_)  # queries equal to support points
    query = torch.cat([support[:, :h], torch.randn(
        (b, m_ - h, c), generator=g, device=DEV)], 1).contiguous()
    if kind == "bad":  # never selected; the NaN query gets index 0
        support[:, [3, 64, 500]] = float("nan")
        support[:, [10, 700], 5] = float("inf")
        query[:, -1] = float("nan")
    return support, query


def check_knn_tiled(gen, rows) -> None:
    """The tiled kNN instance (row 11 past knn_max_points(C)) against the
    plain version, index for index: the host's copy of its plan against
    the library's, DGCNN's three feature-space calls at B = 32,
    N = M = 1024, k = 20 (timed beside the plain version, the stand-in
    topk(cdist) and the operation bound), KNN_TILED_EDGES and
    KNN_TILED_PLAN_EDGES, and its device
    ops a call (KNN_TILED_OPS, in the op-count child).
    Adds ``rows["knn_tiled"]``: ms summed over the three calls."""
    import torch
    from adaptpoint_tpu_torch.ops import _build, knn
    plan = knn.lib_tiled_plan()
    if plan != knn.knn_tiled_plan():
        raise AssertionError(f"the tiled kNN's plan {plan} differs from the "
                             f"wrapper's {knn.knn_tiled_plan()}")

    def direct(k, support, query):
        # the library's launcher itself, past the chooser and the counter
        b, n, c = support.shape
        m = query.shape[1]
        lib = knn._lib()
        idx = torch.empty((b, m, k), dtype=torch.int32, device=DEV)
        err = lib.knn_tiled_launch(
            support.data_ptr(), query.data_ptr(), b, n, m, c, k,
            idx.data_ptr(), torch.cuda.current_stream(DEV).cuda_stream)
        _build.check(lib, err, "knn (tiled, direct)")
        return idx

    def case(tag, k, support, query, is_direct=False):
        b, n, c = support.shape
        var = knn.knn_variant(k, n, c)
        before = knn.LAUNCHES_TILED
        got = (direct(k, support, query) if is_direct
               else knn.knn_idx_cuda(k, support, query))
        ref = knn.knn_idx_plain(k, support, query)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        emit("kernel", name="knn_tiled", case=tag,
             shape=[b, n, query.shape[1], c, k], variant=list(var),
             direct=is_direct, mismatches=mism, tolerance="exact")
        tiled = var.kind == "tiled" and not is_direct
        if mism or (knn.LAUNCHES_TILED - before) != tiled:
            raise AssertionError(f"tiled kNN disagrees at {mism} indices "
                                 f"({tag}, N={n}, C={c}, k={k}, {var})")

    acc = dict(ms=0.0, plain_ms=0.0, stand_in_ms=0.0, t_b=0.0, t_o=0.0,
               device_ms=0.0, host_us=0.0)
    shapes = []
    n = m = N0
    k = 20
    for c in DGCNN_KNN_C:
        feats = torch.randn((B, n, c), generator=gen, device=DEV)
        feats = torch.nn.functional.leaky_relu(feats, 0.2)  # as a block's
        case(f"DGCNN C = {c}", k, feats, feats)
        t_b = (2 * B * n * c * 4 + B * m * k * 4) / PEAK_BYTES
        # a pair: C products and C - 1 sums of q.x, |q|^2 + |x|^2, the
        # doubling and the difference; each point's norm once (2C - 1)
        t_o = B * (m * n * (2 * c + 2) + (n + m) * (2 * c - 1)) / PEAK_F32
        row = dict(shape=[B, n, m, c, k],
                   ms=cuda_ms(lambda: knn.knn_idx_cuda(k, feats, feats)),
                   plain_ms=cuda_ms(lambda: knn.knn_idx_plain(k, feats,
                                                              feats), 50.0),
                   **device_host(lambda: knn.knn_idx_cuda(k, feats, feats)),
                   **bound_row(t_b, t_o))
        # a stand-in, not a library call for the same function: other
        # arithmetic (cdist) and its own tie rule
        row["stand_in_ms"] = cuda_ms(lambda: torch.topk(
            torch.cdist(feats, feats), k, dim=-1, largest=False))
        emit("stage_times", knn_tiled=row)
        shapes.append(row)
        for key in ("ms", "plain_ms", "stand_in_ms"):
            acc[key] += row[key]
        acc["t_b"] += t_b
        acc["t_o"] += t_o
        for key in ("device_ms", "host_us"):  # None: not measured
            acc[key] = (None if acc[key] is None or row[key] is None
                        else acc[key] + row[key])
    own = torch.Generator(device=DEV).manual_seed(11)
    for (tag, b, n_, m_, c, k_, kind), g in (
            [(e, gen) for e in KNN_TILED_EDGES]
            + [(e, own) for e in KNN_TILED_PLAN_EDGES]):
        support, query = knn_tiled_edge_inputs(g, b, n_, m_, c, kind)
        case(tag, k_, support, query, is_direct=kind == "direct")
    acc.update(bound_row(acc.pop("t_b"), acc.pop("t_o")))
    acc.update(max_abs_err=0.0, library_ms=None, dgcnn_shapes=shapes,
               op_launches=child_op_launches("knn_tiled"))
    rows["knn_tiled"] = acc


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
    check_knn_tiled(gen, rows)

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

    B = idx.shape[0]
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
    autograd, each by name, held as ``held_op_launches`` holds them. The
    bf16 route must be one forward kernel, one backward kernel and at most
    one memset: no cast around them."""
    import torch
    from adaptpoint_tpu_torch import ops
    x_req = xyz.clone().requires_grad_()
    f_req = torch.randn((B, n, c), generator=gen, device=DEV).to(
        torch.bfloat16).requires_grad_()
    m = qidx.shape[1]
    gs = (torch.randn((B, m, 3), generator=gen, device=DEV),
          *(torch.randn((B, m, c), generator=gen, device=DEV).to(
              torch.bfloat16) for _ in range(3)))
    out = ops.ball_group_max(radius, K_GAN, x_req, qidx, f_req)
    grads = torch.autograd.grad(out, (x_req, f_req), gs, retain_graph=True)
    calls = {"forward": lambda: ops.ball_group_max(radius, K_GAN, x_req,
                                                   qidx, f_req),
             "backward": lambda: torch.autograd.grad(
                 out, (x_req, f_req), gs, retain_graph=True)}
    want = {"forward": {"ball_group_max_kernel<": 1},
            "backward": {"ball_group_max_bwd_kernel<": 1}}
    found, profiles, bad = held_op_launches(calls, want,
                                            {"backward": {"emset": 1}})
    emit("ball_group_max_op_launches", features="bfloat16",
         shape=[B, n, m, c, K_GAN], forward=found.get("forward"),
         backward=found.get("backward"),
         profiles_taken={k: len(v) for k, v in profiles.items()},
         profiles_short={k: v[:-1] for k, v in profiles.items()
                         if len(v) > 1},
         expected="forward: the kernel alone; backward: the kernel and at "
                  "most one memset; no cast")
    if bad or not out[1].dtype == grads[1].dtype == torch.bfloat16:
        raise AssertionError(f"ops.ball_group_max on bf16 features launches "
                             f"{bad or found}, dtypes {out[1].dtype} "
                             f"{grads[1].dtype}")
    return {k: sum(v.values()) for k, v in found.items()}


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


_U = 2.0 ** -24  # the f32 unit roundoff
LOG2E_F32 = 1.4426950408889634  # the kernels' kLog2e (an f32)


def _gamma(n: int) -> float:
    """Bound on the relative error of an f32 sum of ``n`` terms, any order."""
    return n * _U / (1.0 - n * _U)


def mha_kernel_scale(scale):
    """``(scale32, c, pow2)``: the scale as the attention kernels take it (an
    f32), their c = log2(e) / scale (an f32) and whether the scale is a
    power of two (the backward then folds the division into V and the row
    term)."""
    import numpy as np
    s32 = np.float32(scale)
    return (float(s32), float(np.float32(LOG2E_F32) / s32),
            abs(float(np.frexp(s32)[0])) == 0.5)


def _b64(x):
    """f64 rounded to f32 (monotone), then to bf16, held in f64."""
    import torch
    return x.float().to(torch.bfloat16).double()


def _mma_bound(x, y):
    """Bound on |f32 tensor-core chain - exact| for sum_d x_d y_d over the
    last dims of x (h, N, d) and y (h, M, d), bf16 values held in f64: the
    kernels' chain of m16n8k16 steps, 16 products each, added to the
    accumulator in d order. A step's 16 exact products and the accumulator
    are aligned to the largest of them and each kept to 24 bits (under
    2^-23 of that largest lost a term, 34 u max for 17 terms), and the sum
    is truncated to an f32 (2 u |sum|): the tensor cores' accumulation as
    Fasi et al. (2021) measured it. (h, N, M) f64."""
    import torch
    bound = torch.zeros((*x.shape[:-1], y.shape[-2]), dtype=torch.float64,
                        device=x.device)
    acc = torch.zeros_like(bound)  # bounds |accumulator| before the step
    xa, ya = x.abs(), y.abs()
    for t in range(0, x.shape[-1], 16):
        top = acc.clone()
        for i in range(t, min(t + 16, x.shape[-1])):
            top = torch.maximum(top, xa[..., i, None] * ya[..., None, :, i])
        acc = acc + torch.matmul(xa[..., t:t + 16],
                                 ya[..., t:t + 16].transpose(-1, -2))
        bound += 34 * _U * top + 2 * _U * acc
    return bound


def _mha_ref_chunks(q, k, v, scale, do, saved, heads=8):
    """dS as the attention backward forms it from the forward's saved
    statistics, in f64, ``heads`` heads at a time: yields ``(sl, ds, delta,
    row_sum, o32)``. ``saved`` is ``(o32, row_off, row_inv)`` of
    ``attention.mha_cuda(..., for_backward=True)``.

    The kernel (``csrc/attention.cu``) forms P = ex2(fma(s, c, row_off)) *
    row_inv and dS = P (dP - z) / scale with z = bf16(do) . o32, from the
    forward's row_off, row_inv and o32; the N-term sums of the softmax's
    row sum and of the row term live in those three, so the dS here, formed
    from them in f64, differs from the kernel's only by the kernel's
    roundings of d-term sums and of a few operations an entry. ``delta`` is
    that f32 gap's first-order worst case (u = 2^-24, gamma_n = n u / (1 -
    n u)): the scores s and dP as the tensor cores' chains (``_mma_bound``,
    e_s and e_dP); z's d products and sum, gamma_{d+1} sum_d |bdo o32|;
    P's relative gap rp = ln2 (c e_s + u |x|) + 2^-22 + u (the fma's
    rounding of x = s c + row_off, ex2.approx's 2^-22, the multiply by
    row_inv), and 2^-126 row_inv absolute (ex2.approx flushes subnormals);
    the subtraction, the multiply and the division, 3 u |dS|.

    The saved statistics are held to the function here, each against its
    own worst case (the kernels' N-term sums, gamma_N any order): ``row_sum``
    is max_i |sum_j P_ij - 1| over 2 (gamma_N + max_j rp_ij + ln2 u
    (|row_off| + 2^8) + 2^-21 + 2 u) (the sum of N exps, the rescaling
    exps and their arguments, the reciprocal); ``o32`` is max |o32 - P
    bf16(v)| over 2 ((2^-18 + 4 gamma_{2N}) (|P| |bf16(v)|) + (rp P)
    |bf16(v)| + u |o32|) (P carried to 16 bits as bf16(P) + bf16(P -
    bf16(P)), two chains of N products). Each must be <= 1."""
    import torch
    s32, c, pow2 = mha_kernel_scale(scale)
    o32, row_off, row_inv = (t.double() for t in saved)
    bh, n, d = q.shape
    gd1 = _gamma(d + 1)
    ln2 = 0.6931471805599453
    div = 1.0 if pow2 else s32
    vmul = 1.0 / s32 if pow2 else 1.0
    for h0 in range(0, bh, heads):
        sl = slice(h0, h0 + heads)
        bq, bk, bv, bdo = (_b64(t[sl].double()) for t in (q, k, v, do))
        bv = bv * vmul  # exact: a power of two
        off, inv = row_off[sl, :, None], row_inv[sl, :, None]
        o = o32[sl]
        s = torch.matmul(bq, bk.transpose(1, 2))
        x = s * c + off
        p = torch.exp2(x) * inv
        rp = ln2 * (c * _mma_bound(bq, bk) + _U * x.abs()) + 2.0 ** -22 + _U
        dp = torch.matmul(bdo, bv.transpose(1, 2))
        z = (bdo * o).sum(-1, keepdim=True) * vmul
        hz = (bdo.abs() * o.abs()).sum(-1, keepdim=True) * vmul
        e = dp - z
        ds = p * e / div
        delta = ((p * (_mma_bound(bdo, bv) + gd1 * hz)
                  + 2.0 ** -126 * inv * e.abs())
                 / div + (rp + 3 * _U) * ds.abs())
        eps_row = 2 * (_gamma(n) + rp.amax(-1, keepdim=True)
                       + ln2 * _U * (off.abs() + 2.0 ** 8) + 2.0 ** -21
                       + 2 * _U)
        row_sum = float(((p.sum(-1, keepdim=True) - 1).abs()
                         / eps_row).max())
        bvu = _b64(v[sl].double())  # o32 is P v, unscaled
        o_ref = torch.matmul(p, bvu)
        o_bound = 2 * ((2.0 ** -18 + 4 * _gamma(2 * n))
                       * torch.matmul(p, bvu.abs())
                       + torch.matmul(rp * p, bvu.abs()) + _U * o.abs())
        yield sl, ds, delta, row_sum, float(((o - o_ref).abs()
                                             / o_bound).max())


def mha_stats_reference(q, k, v, scale, do, saved) -> dict:
    """What row 10's dq and dk are held to: ``dq`` = bf16(dS) bf16(k) and
    ``dk`` = bf16(dS)^T bf16(q) (f64) from the dS of ``_mha_ref_chunks``,
    and ``allow_dq``, ``allow_dk``: what the bf16 roundings of dS can move
    the kernel's by, where its f32 dS, within ``delta`` of this one, may
    round the other way. An entry counts (``flips``) where bf16(dS - delta)
    != bf16(dS + delta); its weight is the larger distance from bf16(dS) to
    either, ``allow_dq[i, c] = sum_j w_ij |bf16(k_jc)|``, ``allow_dk[j, c]
    = sum_i w_ij |bf16(q_ic)|``; entries no flip reaches get 0. Also the
    saved statistics' two ratios (``row_sum``, ``o32``; each <= 1 when
    they are the function's)."""
    import torch
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dk, allow_dq, allow_dk = (torch.empty_like(dq) for _ in range(3))
    flips, row_sum, o32 = 0, 0.0, 0.0
    for sl, ds, delta, rs, oe in _mha_ref_chunks(q, k, v, scale, do,
                                                  saved):
        bq, bk = _b64(q[sl].double()), _b64(k[sl].double())
        r, lo, hi = _b64(ds), _b64(ds - delta), _b64(ds + delta)
        w = torch.maximum(hi - r, r - lo)
        flips += int((hi != lo).sum())
        dq[sl] = torch.matmul(r, bk)
        dk[sl] = torch.matmul(r.transpose(1, 2), bq)
        allow_dq[sl] = torch.matmul(w, bk.abs())
        allow_dk[sl] = torch.matmul(w.transpose(1, 2), bq.abs())
        row_sum, o32 = max(row_sum, rs), max(o32, oe)
    return dict(dq=dq, dk=dk, allow_dq=allow_dq, allow_dk=allow_dk,
                flips=flips, row_sum=row_sum, o32=o32)


def mha_scaled(a, b_, allow=None):
    """``(scaled, raw)``: the largest ``|a - b| / (1 + |b|)`` once each
    entry's flip allowance is taken off (what the check holds to its
    tolerance), and without it."""
    d = (a.float() - b_.float()).abs()
    den = 1.0 + b_.float().abs()
    raw = float((d / den).max())
    if allow is None:
        return raw, raw
    return float(((d - allow).clamp(min=0.0) / den).max()), raw


def check_mha_shape(gen, shape, scale, dtype=None, case=None,
                    quiet=False) -> dict:
    """The flash attention kernels (rows 9, 10) at one shape and input type
    (default f32), directly and through autograd, two backward runs bit for
    bit equal. out and dv against their plain versions within TOL_MHA * (1 +
    |plain|); dq and dk within that of bf16(dS) bf16(k) and bf16(dS)^T
    bf16(q) from the dS the kernel forms from its forward's saved
    statistics, plus what the bf16 roundings of dS may move them by
    (``mha_stats_reference``: each dS entry within the derived f32 gap of a
    rounding midpoint, one bf16 ulp of it times |bf16(k)| for dq,
    |bf16(q)| for dk), the saved statistics held to the function
    (``row_sum`` and ``o32`` <= 1). Gradients stored as bf16 add 2^-8 for
    their storage. dq and dk against the plain version are reported, not
    held. Returns the errors, the flips the bound allowed and the entries
    that needed them; raises where any is outside."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import attention
    dtype = torch.float32 if dtype is None else dtype
    q, k, v, do = [torch.randn(shape, generator=gen, device=DEV).to(dtype)
                   for _ in range(4)]
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
    held = mha_stats_reference(q, k, v, scale, do, saved)
    torch.cuda.synchronize()
    against = {"out": ref, "dv": ref_grads[2], "dq": held["dq"],
               "dk": held["dk"]}
    allow = {"dq": held["allow_dq"], "dk": held["allow_dk"]}
    errs, scaled_errs, raw_errs, used, over, ok = {}, {}, {}, {}, {}, True
    pairs = [("out", out)]
    for name, a, c in zip(("dq", "dk", "dv"), grads, auto):
        pairs += [(name, a), ("autograd_" + name, c)]
    for name, a in pairs:
        key = name.replace("autograd_", "")
        b_ = against[key]
        if a.dtype != (torch.float32 if name == "out" else dtype) \
                or a.shape != b_.shape:
            ok = False
        tol = TOL_MHA if dtype == torch.float32 or name == "out" \
            else TOL_MHA + 2.0 ** -8  # a bf16 gradient: one more ulp
        errs[name] = float((a.float() - b_.float()).abs().max())
        scaled_errs[name], raw_errs[name] = mha_scaled(a, b_, allow.get(key))
        if key in allow:  # entries only the flips' allowance holds
            den = 1.0 + b_.abs()
            d = (a.double() - b_).abs() / den
            used[name] = int((d > tol).sum())
            over[name] = float((allow[key] / (tol * den)).max())
        ok = (ok and scaled_errs[name] <= tol
              and bool(torch.isfinite(a).all()))
    stats = {"row_sum": held["row_sum"], "o32": held["o32"]}
    ok = ok and max(stats.values()) <= 1.0
    vs_plain = {name: mha_scaled(a, b_)[0] for name, a, b_ in
                zip(("dq", "dk"), grads, ref_grads)}
    repeat = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    rec = dict(name="mha", case=case, shape=list(shape), scale=scale,
               dtype=str(dtype), max_abs_err=errs,
               max_scaled_err=max(scaled_errs.values()),
               scaled_err=scaled_errs, scaled_err_without_flips=raw_errs,
               dq_dk_vs_plain_scaled=vs_plain, saved_statistics=stats,
               flips_allowed=held["flips"], entries_needing_flips=used,
               max_allowance={"dq": float(allow["dq"].max()),
                              "dk": float(allow["dk"].max())},
               allowance_over_tolerance=over,
               out_absmax=float(ref.abs().max()), backward_repeats=repeat)
    if not quiet or not ok or not repeat:
        emit("kernel", **rec,
             tolerance=f"out, dv: |kernel - plain| <= {TOL_MHA} * (1 + "
                       f"|plain|); dq, dk: |kernel - ref| <= that + the "
                       f"flips' allowance, ref from the saved statistics "
                       f"(mha_stats_reference), row_sum and o32 <= 1; + "
                       f"2^-8 for gradients stored as bf16; two backward "
                       f"runs bit for bit equal")
    if not ok or not repeat:
        raise AssertionError(f"attention kernels disagree at {shape} "
                             f"{dtype} ({case}): {scaled_errs}, saved "
                             f"statistics {stats}, backward repeats: "
                             f"{repeat}")
    return rec


# the shapes the attention check holds, in its order: every head dim at
# N = 1, below a tile (40), at the tiles' edges (127, 128, 129) and at 2047,
# then the earlier ragged shapes; a power-of-two scale folds the backward's
# division into the product, sqrt(32) takes the division
MHA_SHAPES = ([((2, n, d), scale) for d, scale in ((16, 4.0),
                                                    (32, 32 ** 0.5),
                                                    (64, 8.0))
               for n in (1, 40, 127, 128, 129, 2047)]
              + [((3, 100, 32), 32 ** 0.5), ((2, 65, 64), 8.0),
                 ((2, 520, 16), 4.0), ((4, 1024, 16), 3.0)])
# fresh draws of every shape and input type, a generator of its own each
# (ROADMAP C.11)
MHA_FRESH_SEEDS = (2101, 2102, 2103, 2104, 2105, 2106, 2107, 2108)
# the draw of ROADMAP C.11: a whole run whose tiled-kNN check drew seven more
# edges from the kernel phase's shared generator before this check (the
# C = 2100 edge came later, from the edges' own generator) failed this
# check's (3, 100, 32) f32 case before it counted the flips
C11_PLAN_EDGES = [e for e in KNN_TILED_PLAN_EDGES if e[4] != 2100]


def c11_generator(entry_state):
    """The kernel phase's shared generator as C.11's run handed it to
    the attention check's (3, 100, 32) f32 case: ``entry_state`` (this
    check's entry), advanced by the seven edges' draws and by the draws of
    the f32 cases before that one."""
    import torch
    g = torch.Generator(device=DEV)
    g.set_state(entry_state)
    for _, b, n_, m_, c, _, kind in C11_PLAN_EDGES:
        knn_tiled_edge_inputs(g, b, n_, m_, c, kind)
    for shape, _ in MHA_SHAPES[:MHA_SHAPES.index(((3, 100, 32),
                                                 32 ** 0.5))]:
        for _ in range(4):
            torch.randn(shape, generator=g, device=DEV)
    return g


def check_attention(gen, rows, replay_c11: bool = False) -> None:
    """The flash attention kernels (rows 9, 10) as ``check_mha_shape`` holds
    them, directly and through autograd, at both input
    types: MHA_SHAPES and the mask head's (128, 2048, 16), first on the
    shared generator's draws, then on a fresh draw of every shape and type
    from each of MHA_FRESH_SEEDS; with ``replay_c11`` (the whole kernel
    phase's generator) also C.11's draw, the case that failed
    before the bound counted the flips. Two backward runs bit for bit
    equal (dq is summed over the key blocks in a fixed order, no atomics).
    Times at the mask head's shape for bf16 inputs, what the bf16 policy's
    ``AnchorSelfAttention`` passes and the row's ``ms``, and for f32 beside
    them, with ``scaled_dot_product_attention`` on the same bf16 inputs in
    the same run. Adds rows "mha" and "mha_bwd" to ``rows``."""
    import torch
    import torch.nn.functional as F
    from adaptpoint_tpu_torch.ops import attention

    entry = gen.get_state()

    def mha_inputs(shape, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
                for _ in range(4)]

    def mha_check(shape, scale, dtype=torch.float32):
        return check_mha_shape(gen, shape, scale, dtype)["max_abs_err"]

    for dtype in (torch.float32, torch.bfloat16):
        for shape, scale in MHA_SHAPES:
            mha_check(shape, scale, dtype)
    errs = {dt: mha_check(MHA_SHAPE, MHA_SCALE, dt)
            for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()  # the plain version's (BH, N, N) tensors
    c11 = None
    if replay_c11:
        c11 = check_mha_shape(c11_generator(entry), (3, 100, 32),
                               32 ** 0.5, torch.float32,
                               case="ROADMAP C.11's draw")
    cases = {}
    for seed in MHA_FRESH_SEEDS:
        g = torch.Generator(device=DEV).manual_seed(seed)
        for dtype in (torch.float32, torch.bfloat16):
            for shape, scale in MHA_SHAPES + [(MHA_SHAPE, MHA_SCALE)]:
                r = check_mha_shape(g, shape, scale, dtype,
                                    case=f"fresh draw, seed {seed}",
                                    quiet=True)
                c = cases.setdefault((tuple(shape), str(dtype)), dict(
                    shape=list(shape), dtype=str(dtype), draws=0,
                    max_scaled_err=0.0, max_scaled_err_without_flips=0.0,
                    flips_allowed=0, entries_needing_flips=0,
                    max_allowance=0.0, allowance_over_tolerance=0.0,
                    dq_dk_vs_plain_scaled=0.0, saved_statistics=0.0))
                c["draws"] += 1
                for key, got in (
                        ("max_scaled_err", r["max_scaled_err"]),
                        ("max_scaled_err_without_flips",
                         max(r["scaled_err_without_flips"].values())),
                        ("max_allowance", max(r["max_allowance"].values())),
                        ("allowance_over_tolerance",
                         max(r["allowance_over_tolerance"].values())),
                        ("dq_dk_vs_plain_scaled",
                         max(r["dq_dk_vs_plain_scaled"].values())),
                        ("saved_statistics",
                         max(r["saved_statistics"].values()))):
                    c[key] = max(c[key], got)
                c["flips_allowed"] += r["flips_allowed"]
                c["entries_needing_flips"] += sum(
                    r["entries_needing_flips"].values())
        torch.cuda.empty_cache()
    fresh = dict(seeds=list(MHA_FRESH_SEEDS), cases=list(cases.values()))
    for dt in ("torch.float32", "torch.bfloat16"):
        sub = [c for c in cases.values() if c["dtype"] == dt]
        fresh[dt.split(".")[1]] = dict(
            {key: max(c[key] for c in sub) for key in (
                "max_scaled_err", "max_scaled_err_without_flips",
                "max_allowance", "allowance_over_tolerance",
                "dq_dk_vs_plain_scaled", "saved_statistics")},
            flips_allowed=sum(c["flips_allowed"] for c in sub),
            entries_needing_flips=sum(c["entries_needing_flips"]
                                      for c in sub))
    emit("attention_fresh_draws", **fresh,
         c11_replay=None if c11 is None else {
             k: c11[k] for k in ("scaled_err", "scaled_err_without_flips",
                                  "max_abs_err", "flips_allowed",
                                  "entries_needing_flips", "max_allowance",
                                  "allowance_over_tolerance",
                                  "dq_dk_vs_plain_scaled",
                                  "saved_statistics")})

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
                        "tensor_core": 1e3 * 10 * bh * n * n * d / PEAK_BF16},
        fresh_draws={k: fresh[k] for k in ("seeds", "float32", "bfloat16")},
        c11_replay=None if c11 is None else {
            k: c11[k] for k in ("scaled_err", "scaled_err_without_flips",
                                 "flips_allowed")})
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

    check_attention(gen, rows, replay_c11=True)

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
    from adaptpoint_tpu_torch.ops import _build, knn
    from adaptpoint_tpu_torch.ops import fpinterp as fpi
    from adaptpoint_tpu_torch.ops import gather
    from adaptpoint_tpu_torch.ops import scatter_rows as sr

    not_held = {}

    def one_call(tag, fn, part):  # held as held_op_launches holds them
        found, _, bad = held_op_launches({tag: fn}, {tag: {part: 1}})
        not_held.update(bad)
        return found.get(tag, {})

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
            f"row 13 decode {m} -> {n}",
            lambda: fpi.weighted_gather3_bwd_cuda(feat, idx3, w, g,
                                                  need_w=False),
            "fpinterp_bwd_")
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
                f"row 15 {tag} {str(dt)[6:]}",
                lambda: gather.gather_rows_bwd_cuda(g, flat, rows_out),
                "gather_rows_bwd_kernel")
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
         row_15_equals_ordered_plain=exact, not_held=not_held,
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


def step_disagreement(got, ref, tol, lr: float):
    """Worst disagreements of a first train step ``got`` with ``ref`` (each
    a dict of ``loss``, ``logits``, ``grads``, ``params``, ``buffers``) and
    whether all are within ``tol``. A gradient tensor is held to a relative
    2-norm: a max-pool hands its gradient to the row with the maximum, and
    where two rows tie to within f32 noise another row may win, so single
    entries can differ outright. After Adam every entry is within one
    step's reach (2 lr) of its counterpart, and ``share`` of each tensor's
    entries within the tight bound plus ``adam_slack``. Where ``tol`` has
    ``logits_share``, that share of the logits must be within
    ``tol["logits"]`` and every one within ``logits_all`` times the largest
    reference logit; otherwise every logit within ``tol["logits"]``."""
    import torch
    w = {"loss": abs(got["loss"] - ref["loss"]),
         "logits": float((got["logits"] - ref["logits"]).abs().max()),
         "grad_rel_l2": ("", 0.0), "param_share_outside": ("", 0.0),
         "param_abs": ("", 0.0), "buffer_abs": ("", 0.0)}
    close = torch.isclose(got["logits"], ref["logits"], rtol=tol["logits"][0],
                          atol=tol["logits"][1])
    if "logits_share" in tol:
        w["logits_share_close"] = float(close.double().mean())
        w["logits_over_largest"] = w["logits"] / float(
            ref["logits"].abs().max())
        logits_ok = (w["logits_share_close"] >= tol["logits_share"]
                     and w["logits_over_largest"] <= tol["logits_all"])
    else:
        logits_ok = bool(close.all())
    good = w["loss"] <= tol["loss"] * abs(ref["loss"]) and logits_ok

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

    w_plain, ok_plain = step_disagreement(got, ref_plain, TOL_STEP_PLAIN, lr)
    w_cpu, ok_cpu = step_disagreement(got, ref_cpu, TOL_STEP_CPU, lr)
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
    over_max = {}  # each output's max |kernel - plain| over max |plain|

    def err(a, b, tol, name, errs):
        d = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        scale = float(b.float().abs().max()) if b.numel() else 0.0
        errs[name] = d
        over_max[name] = d / max(scale, 1e-30)
        return d <= tol * max(scale, 1e-30)

    def same_bits(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def held(got_, ref_, tol, names, errs, plain_fn, args):
        """Each output within ``tol`` of the plain pass's largest entry;
        where one is not, within ``tol`` of the same pass in float64 on the
        same inputs. The plain pass's own f32 sums round too, and where a
        sum cancels (BatchNorm's backward sums over features with a large
        mean: S3DIS's raw colours) they sit further from the exact sum than
        the kernel's (PERF.md, the S3DIS slice)."""
        ok_, exact = True, None
        for j, (a, b_, name) in enumerate(zip(got_, ref_, names)):
            if err(a, b_, tol, name, errs):
                continue
            if exact is None:
                exact = plain_fn(*(t.double() if torch.is_tensor(t)
                                   and t.is_floating_point() else t
                                   for t in args))
            d = float((a.double() - exact[j]).abs().max())
            scale = float(exact[j].abs().max())
            over_max[f"{name}_vs_float64"] = d / max(scale, 1e-30)
            over_max[f"{name}_plain_vs_float64"] = float(
                (b_.double() - exact[j]).abs().max()) / max(scale, 1e-30)
            ok_ = ok_ and d <= tol * max(scale, 1e-30)
        return ok_

    got = S.stats_cuda(radius, k, xyz, qidx, feats, rel, norm_dp)
    ref = S.stats_plain(radius, k, xyz, qidx, feats, rel, norm_dp)
    torch.cuda.synchronize()
    # rows 16 and 17 sum in a fixed order: a second launch, the same bits
    e1 = {"idx": float((got[0] != ref[0]).sum()),
          "same_bits_again": same_bits(got, S.stats_cuda(
              radius, k, xyz, qidx, feats, rel, norm_dp))}
    ok = e1["idx"] == 0 and e1["same_bits_again"]
    ok = held(got[1:], ref[1:], TOL_TRAINBN["stats"], ("sv", "svv"), e1,
              lambda *a: S.stats_plain(*a)[1:],
              (radius, k, xyz, qidx, feats, rel, norm_dp)) and ok
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
    pick = (2, 3, 6, 7)
    ok2 = held([got2[j] for j in pick], [ref2[j] for j in pick],
               TOL_TRAINBN["fwd"], ("ymax", "ymin", "s2", "q2"), e2,
               lambda *a: [o[j] for o in (S.fwd_plain(*a),) for j in pick],
               fargs) and ok2
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
    ok3 = held(got3, ref3, TOL_TRAINBN["bwd_w2"],
               ("dw2", "sg1", "sgx1", "g_y1p", "y1"), e3, S.bwd_w2_plain,
               pargs)
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
    ok4 = held(got4, ref4, TOL_TRAINBN["bwd_x"], ("g_xyz", "g_feats", "dw1"),
               e4, S.bwd_x_plain, xargs)
    inputs = {"fargs": fargs, "bargs": bargs, "pargs": pargs, "xargs": xargs,
              "stats": (radius, k, xyz, qidx, feats, rel, norm_dp),
              "over_max": over_max}
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


# warmed profiles of a call that ``held_op_launches`` may take (the train-BN
# passes, the windowed kernels): the profiler drops records now and then
# (PERF.md, section 6)
TRAINBN_OP_ATTEMPTS = 4
# a warmed profile's marks: OP_MARK_RUN spin kernels on the stream just
# before and as many just after the profiled call, whose ops are those
# between the two runs in device time; the host waits PROFILE_MARGIN_S on
# either side of each profiler step
OP_MARK = "spin_kernel"
OP_MARK_CYCLES = 1000
OP_MARK_RUN = 3
PROFILE_MARGIN_S = 0.02


def ops_between_marks(events) -> dict | None:
    """The device ops (``name[:60]``: count) that ``events`` ((name, device
    start), in any order) hold between the run of ``OP_MARK`` spins before
    the call and the run after it, or None where either run is missing
    (the spins do not form exactly two runs of consecutive records). A run
    holds as long as one of its spins was recorded. A record that falls into
    the profiled step from the warm-up step lies before the first run; one
    dropped at the step's start takes the first run's spins first."""
    events = sorted(events, key=lambda e: e[1])
    at = [i for i, (name, _) in enumerate(events) if OP_MARK in name]
    runs = [i for j, i in enumerate(at) if j == 0 or at[j - 1] != i - 1]
    if len(runs) != 2:
        return None
    first_end = max(i for i in at if i < runs[1])
    out: dict = {}
    for name, _ in events[first_end + 1:runs[1]]:
        out[name[:60]] = out.get(name[:60], 0) + 1
    return out


def op_profile(fn, warm: bool) -> dict | None:
    """The device ops (``e.key[:60]``: count) one call of ``fn`` puts on
    the card, from the profiler: the call profiled alone, or (``warm``) the
    ops between runs of ``OP_MARK`` spins around the call in the profiler
    step after a warm-up step of one call (``ops_between_marks``: None where
    a run of marks was not recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if not warm:
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.count for e in device_kernels(prof)}
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(OP_MARK_RUN):
            torch.cuda._sleep(OP_MARK_CYCLES)
        fn()
        for _ in range(OP_MARK_RUN):
            torch.cuda._sleep(OP_MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    return ops_between_marks(
        (e.name, e.time_range.start) for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))


def held_op_launches(calls: dict, want: dict, may: dict | None = None):
    """Each call's device ops against ``want`` (name: {part of an op's name:
    count}), from warmed profiles (``op_profile``). The profiler leaves some
    records out now and then: the first ones of a profile that starts at the
    call, every one of a short call late in a long process, and the warm-up
    step's last op can fall into the profiled step (PERF.md, section 6). So
    the call's ops are those between two runs of marks on the stream, a
    profile without both runs holds nothing, every one with both must hold
    no op beyond ``want``'s, and one of up to TRAINBN_OP_ATTEMPTS must hold
    them all: a launch too many fails every profile, a launch missing fails
    all of them. ``may`` (name: {part: most}) names ops a call may add, each
    up to its count. Returns ``(found: the profile that held them, profiles:
    every profile taken, None where a run of marks is missing, bad: the
    calls that failed)``."""
    def parts(need, ops):
        return {part: sum(v for k, v in ops.items() if part in k)
                for part in need}

    found, profiles, bad = {}, {}, {}
    for name, need in want.items():
        extra = (may or {}).get(name, {})
        profiles[name] = []
        for _ in range(TRAINBN_OP_ATTEMPTS):
            ops = op_profile(calls[name], True)
            profiles[name].append(ops)
            if ops is None:
                continue
            got, opt = parts(need, ops), parts(extra, ops)
            if any(got[p] > need[p] for p in need) \
                    or any(opt[p] > extra[p] for p in extra) \
                    or sum(ops.values()) > sum(got.values()) \
                    + sum(opt.values()):
                bad[name] = ops  # an op beyond want's
                break
            if got == need:
                found[name] = ops
                break
        else:
            bad[name] = profiles[name]  # none held them all
    return found, profiles, bad


def trainbn_op_launches(S, inp) -> dict:
    """The device ops of one call of each train-BN pass on ``inp`` (from
    ``trainbn_passes``), from the profiler, by name: each must be
    TRAINBN_OPS's, nothing else, held by ``held_op_launches``. A profile of
    its own around the call alone is reported beside it, not held."""
    calls = {"stats": lambda: S.stats_cuda(*inp["stats"]),
             "fwd": lambda: S.fwd_cuda(*inp["fargs"]),
             "bwd_w2": lambda: S.bwd_w2_cuda(*inp["bargs"]),
             "bwd_x": lambda: S.bwd_x_cuda(*inp["xargs"])}
    alone = {name: op_profile(fn, False) for name, fn in calls.items()}
    found, profiles, bad = held_op_launches(calls, TRAINBN_OPS)
    emit("sa_trainbn_op_launches", found=found, expected=TRAINBN_OPS,
         profiles_taken={n: len(v) for n, v in profiles.items()},
         profiles_short={n: v[:-1] for n, v in profiles.items() if len(v) > 1},
         profiled_alone=alone,
         alone_differs=[n for n in calls if alone[n] != found.get(n)])
    if bad:
        raise AssertionError(f"train-BN passes' device ops {bad}")
    return found


def trainbn_op_launches_here() -> dict:
    """``--op-launches trainbn``: ``trainbn_op_launches`` at the fused
    classifier step's first stage (STAGES[0], B=32: 1024 points, 512
    centers), on seeded inputs made as ``stage_inputs`` makes them, with the
    step's relative, normalised offsets. Returns the ops a call by pass."""
    import torch
    from adaptpoint_tpu_torch.ops import satrainbn as S
    gen = torch.Generator(device=DEV).manual_seed(0)
    _, _, c, mid, cout, r = STAGES[0]
    (xyz, qidx, feats), = stage_inputs(gen, STAGES[:1])
    w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) / (3 + c) ** 0.5
    w2 = torch.randn((mid, cout), generator=gen, device=DEV) / mid ** 0.5
    g1, g2 = (1.0 + 0.1 * torch.randn((w,), generator=gen, device=DEV)
              for w in (mid, cout))
    b1, b2 = (0.1 * torch.randn((w,), generator=gen, device=DEV)
              for w in (mid, cout))
    errs, oks, inp = trainbn_passes(gen, S, xyz, qidx, feats, w1, g1, b1, w2,
                                    g2, b2, r, True, True, K)
    if not all(oks):
        raise AssertionError(f"train-BN kernels disagree at the op-count "
                             f"stage: {errs}")
    found = trainbn_op_launches(S, inp)
    return {k: sum(ops.values()) for k, ops in found.items()}


def check_sa_trainbn(gen, captured, op_launches=True):
    """The four train-BN passes (rows 16-19), each against its plain pass on
    the same inputs, at the stages ``captured`` from the fused train step
    (its own FPS picks, features and weights), with seeded cotangents.
    Returns their rows, summed over the stages. The operation bound of
    passes 2-4 is 3 flops / PEAK_TF32 (the f32-grade 3xTF32 rate, the least
    time the card could take for f32-grade work), of pass 1 flops /
    PEAK_F32 (its f32 sums); the f32 CUDA cores' figure, flops / PEAK_F32,
    is reported beside every pass (``bound_ms_f32_cores``). With
    ``op_launches``, the device ops of each pass's call are pinned at the
    classifier's first stage, in the op-count child
    (``trainbn_op_launches_here``)."""
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
                                 f"{i + 1}: {errs}, over max|plain| "
                                 f"{inp['over_max']}")
        if i == 0 and op_launches:
            child_op_launches("trainbn")
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

        stage_row["over_max"] = inp["over_max"]
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


def check_window_layout(b, n, m, c, k, tm, w, aligned, fwd_tl=None,
                        bwd_tl=None):
    """Rows 20, 21's launch shapes at this shape (the chooser's, or the
    forced ones): the host's copies of their shared memory
    (``window.fwd_smem_bytes``, ``ballgroup_max.bwd_smem_bytes``) against
    the kernel's own, each within the card's opt-in. Returns both tilings
    with their bytes."""
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
    from adaptpoint_tpu_torch.ops import window as wnd
    lib = wnd._lib()
    ftl = wnd.fwd_tiling(b, n, m, c, k, tm, w, aligned, *(fwd_tl or ()))
    host = wnd.fwd_smem_bytes(ftl.design, ftl.centers, n, k, w)
    dev = lib.window_max_smem_bytes(wnd.DESIGNS[ftl.design], ftl.centers, n,
                                    k, w)
    btl = bwd_tl or wnd.bwd_tiling(n, c)
    bhost = bgm.bwd_smem_bytes(btl.s, btl.r)
    bdev = lib.window_max_bwd_smem_bytes(btl.s, btl.r)
    if host != dev or bhost != bdev or max(dev, bdev) > bgm._SMEM_LIMIT:
        raise AssertionError(f"windowed ball group layout: forward host "
                             f"{host} kernel {dev} ({ftl}), backward host "
                             f"{bhost} kernel {bdev} ({btl}) at {[b, n, m, c, k]}"
                             f" tm={tm} w={w}")
    return {"forward": dict(ftl._asdict(), smem_bytes=dev),
            "backward": dict(btl._asdict(), smem_bytes=bdev)}


def check_window_stage(gen, tag, xyz, qidx, feats, radius, tm, w, k=K_GAN,
                       splits=1, grad_splits=1, fwd_tl=None, bwd_tl=None):
    """The windowed kernels (rows 20, 21) at one stage and width, on their
    chosen launch shapes or the forced ``fwd_tl`` / ``bwd_tl``, against
    their plain versions (forward outputs and residuals exact and the same
    bits on a second launch, the backward and the op's autograd within the
    reordering bound) and, where ``ok`` at ``splits`` 1, against row 7's
    kernel (outputs, winning slots and slots equal). Returns ``(ok, need,
    prep, forward outputs, backward arguments, the forward's and the
    backward's largest error)``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
    from adaptpoint_tpu_torch.ops import window as wnd

    b, n, c = feats.shape
    m = qidx.shape[1]
    layout = check_window_layout(b, n, m, c, k, tm, w,
                                 feats.data_ptr() % 16 == 0, fwd_tl, bwd_tl)
    prep = wnd.window_prep(xyz, qidx, radius, tm, w)
    ok, need = bool(prep["ok"]), int(prep["need"])
    args = (radius, k, xyz, qidx, feats, prep, w, tm, splits)
    got = wnd.ball_group_max_windowed_cuda(*args, tiling=fwd_tl)
    again = wnd.ball_group_max_windowed_cuda(*args, tiling=fwd_tl)
    ref = wnd.ball_group_max_windowed_plain(*args)
    torch.cuda.synchronize()
    names = ("new_xyz", "fi", "fmax", "fmin", "amax", "amin", "cnt", "idx",
             "qrow")
    errs = {k_: float((a.float() - b_.float()).abs().max())
            for k_, a, b_ in zip(names, got, ref)}
    same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    del ref, again
    _, _, _, _, amax, amin, cnt, idx, qrow = got
    g_new = torch.randn((b, m, 3), generator=gen, device=DEV)
    g_fi, g_fmax, g_fmin = (torch.randn((b, m, c), generator=gen, device=DEV)
                            for _ in range(3))
    bargs = (idx, cnt, qrow, amax, amin, g_new, g_fi, g_fmax, g_fmin, n,
             grad_splits)
    back = wnd.ball_group_max_windowed_bwd_cuda(*bargs, tiling=bwd_tl)
    back_ref = wnd.ball_group_max_windowed_bwd_plain(*bargs)
    x_req, f_req = xyz.clone().requires_grad_(), feats.clone().requires_grad_()
    auto = torch.autograd.grad(
        ops.ball_group_max_windowed(radius, k, x_req, qidx, f_req, splits,
                                    grad_splits, tm, w),
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
        g_fmin.abs(), n, grad_splits)
    a_f[:, 0] += wnd.empty_ball_grad(cnt, g_fmax.abs(), g_fmin.abs())
    bounds = (scatter_bound(counts_x, a_x), scatter_bound(counts_f, a_f))
    bwd_errs = {}
    good = not any(errs.values()) and same_bits
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
    if ok and splits == 1:  # the full-N kernel (row 7) on the same inputs
        row7 = bgm.ball_group_max_cuda(radius, k, xyz, qidx, feats)
        torch.cuda.synchronize()
        for k_, a, b_ in zip(("new_xyz", "fi", "fmax", "fmin", "amax",
                              "amin", "idx"), row7,
                             (got[0], got[1], got[2], got[3], amax, amin,
                              idx)):
            full_n[k_] = float((a.float() - b_.float()).abs().max())
        good = good and not any(full_n.values())
    emit("kernel", name="ball_group_max_windowed", case=tag,
         shape=[b, n, m, c, k], radius=radius, tm=tm, w=w, splits=splits,
         grad_splits=grad_splits, w_over_n=w / n, ok=ok, need=need,
         layout=layout, forced=fwd_tl is not None or bwd_tl is not None,
         max_abs_err=errs, same_bits_second_launch=same_bits,
         max_abs_err_bwd=bwd_errs, against_row7=full_n or None,
         empty_balls=int((cnt == 0).sum()),
         outside_window=int((qrow < 0).sum()),
         full_balls=float((cnt == k).float().mean()),
         tolerance="forward outputs and residuals exact, against the plain "
                   "version, a second launch and (where ok, splits 1) row "
                   "7's kernel; backward <= n * 2^-23 * sum|addend| per "
                   "element")
    if not good:
        raise AssertionError(f"windowed kernels disagree ({tag}, w={w}): "
                             f"{errs} same bits {same_bits} {bwd_errs} "
                             f"{full_n}")
    return (ok, need, prep, got, bargs, max(errs.values()),
            max(bwd_errs["g_xyz"], bwd_errs["g_feats"]))


def window_cloud(gen, b, n, kind="sphere"):
    """A (b, n, 3) cloud: "sphere", normal points centred and scaled into
    the unit ball (the ``window`` phase's); "overflow", a cloud narrower
    than a ball along its key axis, away from the origin (the windows
    overflow, and centers outside them see the points near the origin)."""
    import torch
    if kind == "overflow":
        pc = torch.zeros((b, n, 3), device=DEV)
        pc[..., 0] = 3.0 + 0.2 * torch.randn((b, n), generator=gen,
                                             device=DEV)
        pc[..., 1] = 1e-6 * torch.randn((b, n), generator=gen, device=DEV)
        return pc
    pc = torch.randn((b, n, 3), generator=gen, device=DEV)
    pc = pc - pc.mean(dim=1, keepdim=True)
    return (pc / pc.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
            ).contiguous()


# the windowed ball group at its edges: (B, N, M, C, K, radius, tm, w (None:
# pick_window's), splits, grad_splits, cloud, features 16-byte aligned,
# forced forward (design, centers, vec) and backward (s, r) or None)
WINDOW_EDGES = [
    (2, 1000, 256, 13, 24, 0.2, 128, None, 1, 1, "sphere", True, None, None),
    (2, 1000, 256, 3, 1, 0.3, 128, 1024, 2, 3, "sphere", True, None, None),
    (2, 512, 128, 1024, 64, 0.4, 64, 512, 3, 2, "sphere", True, None, None),
    (1, 1000, 128, 16, 255, 0.9, 128, 1024, 1, 1, "sphere", True, None,
     None),
    (2, 1000, 256, 13, 24, 0.3, 128, 256, 1, 1, "overflow", True, None,
     None),
    (2, 1000, 256, 16, 24, 0.2, 128, None, 2, 2, "overflow", False, None,
     None),
    (2, 1000, 256, 16, 24, 0.2, 128, 512, 1, 1, "sphere", False, None,
     None)]
# each forced layout of the forward and the backward, at a grouper-1 shape
# (four clouds) at the width its data needs, and on overflow clouds at 512
WINDOW_FORCED = [(("bitmap", 32, 4), None), (("bitmap", 16, 4), None),
                 (("bitmap", 8, 4), None), (("bitmap", 32, 1), None),
                 (("sorted", 8, 4), None), (("sorted", 32, 4), None),
                 (("sorted", 8, 1), None), (None, (4, 2048)),
                 (None, (16, 2048)), (None, (32, 700)), (None, (8, 1000))]


def check_window_edges(gen) -> None:
    """Rows 20, 21 at ``WINDOW_EDGES`` (K = 1, 24, 64, 255; C = 3, 13, 16,
    1024; N = 1000; splits and grad_splits 1-3; clouds whose windows
    overflow; misaligned features, which take the one-channel instance) and
    at every forced launch shape of ``WINDOW_FORCED``, each through
    ``check_window_stage``."""
    import torch
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
    from adaptpoint_tpu_torch.ops import window as wnd
    cases = [(bq, n, m, c, k, r, tm, w, sp, gs, kind, aligned, None, None)
             for bq, n, m, c, k, r, tm, w, sp, gs, kind, aligned, _, _
             in WINDOW_EDGES]
    for kind, w in (("sphere", 1408), ("overflow", 512)):
        for f, bt in WINDOW_FORCED:
            cases.append((4, 2048, 1024, 128, K_GAN, 0.1, 256, w, 1, 1,
                          kind, True, f, bt))
    for (bq, n, m, c, k, r, tm, w, sp, gs, kind, aligned, f,
         bt) in cases:
        xyz = window_cloud(gen, bq, n, kind)
        qidx = torch.argsort(torch.rand((bq, n), generator=gen, device=DEV),
                             dim=1)[:, :m].int().contiguous()
        feats = torch.empty(bq * n * c + 1, device=DEV)
        feats = (feats[:-1] if aligned else feats[1:]).view(bq, n, c)
        feats.copy_(torch.randn((bq, n, c), generator=gen, device=DEV))
        w = w or wnd.pick_window(wnd._round_up(n, 128), r, m, tm)
        fwd_tl = wnd.FwdTiling(*f) if f else None
        bwd_tl = bgm.BwdTiling(*bt) if bt else None
        check_window_stage(
            gen, f"edge {[bq, n, m, c, k]} {kind} w={w} splits {sp}/{gs}"
            f"{'' if aligned else ' misaligned'}", xyz, qidx, feats, r, tm,
            w, k, sp, gs, fwd_tl, bwd_tl)


# device ops one call of each windowed kernel wrapper makes, by name
WINDOW_OPS = {"forward": {"window_max_kernel": 1},
              "backward": {"window_max_bwd_kernel": 1}}


def window_cases(gen):
    """The ``window`` phase's inputs at the four grouper shapes: ``(n, m,
    c, r, tm, w, xyz, qidx, feats)``, w ``pick_window``'s."""
    import torch
    from adaptpoint_tpu_torch.ops import window as wnd
    cases = []
    for n, m, c, r in GAN_STAGES:
        pc = window_cloud(gen, B, n)
        feats = torch.randn((B, n, c), generator=gen, device=DEV)
        qidx = torch.argsort(torch.rand((B, n), generator=gen, device=DEV),
                             dim=1)[:, :m].int().contiguous()
        tm = 256 if m % 256 == 0 else 128
        w = wnd.pick_window(wnd._round_up(n, 128), r, m, tm)
        cases.append((n, m, c, r, tm, w, pc, qidx, feats))
    return cases


def window_op_launches_here() -> dict:
    """``--op-launches window``: the device ops of one call of each windowed
    kernel wrapper at the four grouper shapes (the width the data needs),
    from the profiler, by name: each must be WINDOW_OPS's, nothing else (no
    memset), held as ``held_op_launches`` holds them. Returns them a
    grouper; raises where they are not held."""
    import torch
    from adaptpoint_tpu_torch.ops import window as wnd
    gen = torch.Generator(device=DEV).manual_seed(0)
    out = {}
    for i, (n, m, c, r, tm, w, xyz, qidx, feats) in enumerate(
            window_cases(gen)):
        prep = wnd.window_prep(xyz, qidx, r, tm, w, stats_only=True)
        if not bool(prep["ok"]):
            w = int(prep["need"])
            prep = wnd.window_prep(xyz, qidx, r, tm, w, stats_only=True)
        fargs = (r, K_GAN, xyz, qidx, feats, prep, w, tm)
        _, _, _, _, amax, amin, cnt, idx, qrow = \
            wnd.ball_group_max_windowed_cuda(*fargs)
        gs = [torch.randn((B, m, k), generator=gen, device=DEV)
              for k in (3, c, c, c)]
        bargs = (idx, cnt, qrow, amax, amin, *gs, n)
        calls = {"forward": lambda: wnd.ball_group_max_windowed_cuda(*fargs),
                 "backward":
                     lambda: wnd.ball_group_max_windowed_bwd_cuda(*bargs)}
        found, profiles, bad = held_op_launches(calls, WINDOW_OPS)
        case = f"grouper {i + 1}"
        emit("window_op_launches", case=case, found=found,
             expected=WINDOW_OPS,
             profiles_taken={k: len(v) for k, v in profiles.items()},
             profiles_short={k: v[:-1] for k, v in profiles.items()
                             if len(v) > 1})
        if bad:
            raise AssertionError(f"windowed kernels' device ops ({case}) "
                                 f"{bad}")
        out[case] = {k: sum(ops.values()) for k, ops in found.items()}
    return out


# the op-count checks this run makes (``--op-launches``), set by ``main``
# from its phases: all of them run in the one child process that the first
# of them starts
OP_CHECKS = {"window": lambda: window_op_launches_here(),
             "fps": lambda: fps_op_launches_here(),
             "trainbn": lambda: trainbn_op_launches_here(),
             "knn_tiled": lambda: knn_tiled_op_launches_here()}
OP_CHECKS_WANTED = set()
_OP_CHECKS_DONE = {}


def child_op_launches(check: str) -> dict:
    """An op-count check of OP_CHECKS (``window``, ``fps``, ``trainbn``,
    ``knn_tiled``)
    from a child process of its own (this script with ``--op-launches``),
    which also makes this run's other checks of OP_CHECKS_WANTED not yet
    made: in three runs of the whole script every profile of the windowed
    kernels' short calls came back empty, in the ``window`` phase after the
    adapt phases and right after ``train_fused`` alike, while the same check
    held in every run of the ``window`` phase alone; and in one run all four
    profiles of the train-BN forward's call in ``train_fused`` lost a mark
    (PERF.md, section 6). Its lines are passed on; raises if it fails."""
    if check not in _OP_CHECKS_DONE:
        todo = sorted((OP_CHECKS_WANTED | {check}) - set(_OP_CHECKS_DONE))
        t0 = time.perf_counter()
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--op-launches", ",".join(todo)],
                             capture_output=True, text=True, timeout=900,
                             cwd=ROOT)
        lines = got.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if got.returncode != 0:
            raise AssertionError(f"--op-launches {todo} failed "
                                 f"({got.returncode}): {got.stdout[-2000:]}"
                                 f"{got.stderr[-3000:]}")
        _OP_CHECKS_DONE.update(json.loads(lines[-1]))
        emit("op_launches_child", checks=todo,
             seconds=time.perf_counter() - t0)
    return _OP_CHECKS_DONE[check]


def window_op_launches() -> dict:
    """``window_op_launches_here`` in a child process of its own."""
    return child_op_launches("window")


# row 1's device ops a call, at the S3DIS crop (minima in shared memory) and
# past 51200 points (minima in the scratch): the pruned kernel alone (the
# wrapper's outputs and scratch are torch.empty), at most FPS_MAX_OPS in any
# case
FPS_OPS = {"24000 -> 6000": {"fps_pruned_kernel": 1},
           "65536 -> 1000": {"fps_pruned_kernel": 1}}
FPS_MAX_OPS = 3


def fps_op_launches_here() -> dict:
    """The device ops of one FPS call at the S3DIS crop (8, 24000) -> 6000
    (minima in shared memory) and at (1, 65536) -> 1000 (minima in the
    scratch), held as ``held_op_launches`` holds them: each must be
    FPS_OPS's. Returns the ops a call by case."""
    import torch
    from adaptpoint_tpu_torch.ops import fpsample as fps
    gen = torch.Generator(device=DEV).manual_seed(0)
    clouds = {"24000 -> 6000": (fps_cloud(gen, SEG_B, N_SEG, 0.0),
                                N_SEG // 4, True),
              "65536 -> 1000": (fps_cloud(gen, 1, 65536, 0.0), 1000, False)}
    for case, (xyz, _, smem) in clouds.items():
        n = xyz.shape[1]
        if fps.fps_tiling(n).kind != "pruned" \
                or fps.pruned_plan(n).smem_minima != smem:
            raise AssertionError(f"{case}: not the pruned kernel with its "
                                 f"minima in {'shared memory' if smem else 'the scratch'}")
    calls = {case: (lambda x=x, m=m: fps.furthest_point_sample_cuda(x, m))
             for case, (x, m, _) in clouds.items()}
    found, profiles, bad = held_op_launches(calls, FPS_OPS)
    emit("fps_op_launches", found=found, expected=FPS_OPS,
         profiles_taken={k: len(v) for k, v in profiles.items()},
         profiles_short={k: v[:-1] for k, v in profiles.items()
                         if len(v) > 1})
    if bad:
        raise AssertionError(f"the FPS call's device ops {bad}")
    return {k: sum(ops.values()) for k, ops in found.items()}


# row 11's tiled instance: its device ops a call at DGCNN's widths, the
# kernel alone (the wrapper's output is torch.empty; no pre-pass, no memset)
KNN_TILED_OPS = {"DGCNN C = 64": {"knn_tiled_kernel": 1},
                 "DGCNN C = 128": {"knn_tiled_kernel": 1}}


def knn_tiled_op_launches_here() -> dict:
    """``--op-launches knn_tiled``: the device ops of one tiled kNN call at
    B = 32, N = M = 1024, k = 20, C = 64 and 128, held as
    ``held_op_launches`` holds them: each must be KNN_TILED_OPS's. Returns
    the ops a call by case."""
    import torch
    from adaptpoint_tpu_torch.ops import knn
    gen = torch.Generator(device=DEV).manual_seed(0)
    calls = {}
    for case in KNN_TILED_OPS:
        c = int(case.split("= ")[1])
        x = torch.randn((B, N0, c), generator=gen, device=DEV)
        calls[case] = lambda x=x: knn.knn_idx_cuda(20, x, x)
    found, profiles, bad = held_op_launches(calls, KNN_TILED_OPS)
    emit("knn_tiled_op_launches", found=found, expected=KNN_TILED_OPS,
         profiles_taken={k: len(v) for k, v in profiles.items()},
         profiles_short={k: v[:-1] for k, v in profiles.items()
                         if len(v) > 1})
    if bad:
        raise AssertionError(f"the tiled kNN call's device ops {bad}")
    return {k: sum(ops.values()) for k, ops in found.items()}


def phase_window(gen):
    """Path A: the windowed max-pooled ball group (rows 20, 21), the op
    itself at ``scripts/check_window.py``'s shapes: B=32, K=24, the
    augmentor's four groupers on clouds centred and normalised to the unit
    sphere, centers drawn without replacement. Per stage: the width, ``ok``
    and the needed width; the kernels against their plain versions and
    row 7 (also at the needed width where ``ok`` is False); each kernel's
    device ops a call (``window_op_launches``: one each way); then
    CUDA-event times of the kernels (and their profiled device time and
    host enqueue), ``window_prep``, the four un-permute gathers the JAX op
    makes (folded into this kernel's writes), the op forward and
    forward+backward, and row 7/8's op at the same inputs. Then the kernels
    at ``WINDOW_EDGES`` and every forced launch shape. Returns the launch
    counts of one forward+backward of the op at each stage (the path), and
    the kernel rows."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import gather as gth
    from adaptpoint_tpu_torch.ops import window as wnd

    cases = window_cases(gen)
    ops_a_call = window_op_launches()

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

    fwd, bwd = ({"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "t_b": 0.0,
                 "t_o": 0.0, "full_n_op_ms": 0.0, "device_ms": 0.0,
                 "host_us": [], "op_launches": []} for _ in range(2))
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
        f_dh = device_host(lambda: wnd.ball_group_max_windowed_cuda(*fargs))
        b_dh = device_host(
            lambda: wnd.ball_group_max_windowed_bwd_cuda(*bargs))
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
                   kernel_ms=f_ms, kernel_ms_at_picked_w=picked_ms,
                   bwd_kernel_ms=b_ms, kernel_device_host=f_dh,
                   bwd_kernel_device_host=b_dh, ops_a_call=ops_a_call[tag],
                   plain_ms=f_plain,
                   bwd_plain_ms=b_plain, window_prep_ms=prep_ms,
                   jax_unpermutes_ms=unperm_ms, op_fwd_ms=op_f,
                   op_fwd_bwd_ms=op_fb, row7_op_fwd_ms=full_f,
                   row78_op_fwd_bwd_ms=full_fb_ms, scanned=scanned,
                   bound_fwd_ms=1e3 * max(t_b_f, t_o_f),
                   bound_bwd_ms=1e3 * max(t_b_b, t_o_b))
        emit("window_times", **row)
        stages.append(row)
        for acc, ms, pl, tb, to, full, e, dh, n_ops in (
                (fwd, f_ms, f_plain, t_b_f, t_o_f, full_f, e_f, f_dh,
                 ops_a_call[tag]["forward"]),
                (bwd, b_ms, b_plain, t_b_b, t_o_b, full_fb_ms - full_f,
                 e_b, b_dh, ops_a_call[tag]["backward"])):
            acc["max_abs_err"] = max(acc["max_abs_err"], e)
            acc["device_ms"] = (None if acc["device_ms"] is None
                                or dh["device_ms"] is None
                                else acc["device_ms"] + dh["device_ms"])
            acc["host_us"].append(dh["host_us"])
            acc["op_launches"].append(n_ops)
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
                         device_ms=acc["device_ms"], host_us=acc["host_us"],
                         op_launches=acc["op_launches"],
                         **bound_row(acc["t_b"], acc["t_o"]))
    emit("window_summary", note="ms summed over the four groupers at B=32; "
         "full_n_op_ms: row 7's op forward, and row 7/8's forward+backward "
         "less its forward, on the same inputs; device_ms: the profiled "
         "kernels summed; host_us and op_launches (device ops a call) a "
         "grouper", **out)
    check_window_edges(gen)
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


def check_trainbn_layout(b, m, k, c, mid, cout, where) -> dict:
    """Rows 16-19's launch shapes at this stage: the host's copy of each
    pass's plan (``satrainbn.plan_host``: tile, ring and shared memory)
    against the kernels' own (``sa_trainbn_plan``, ``sa_trainbn_smem_bytes``),
    each within the card's opt-in."""
    from adaptpoint_tpu_torch.ops import satrainbn as S
    lib = S._lib()
    out = {}
    for name, kind in (("stats", S.STATS), ("fwd", S.FWD),
                       ("bwd_y2", S.BWD_Y2), ("bwd_gh", S.BWD_GH),
                       ("bwd_x", S.BWD_X)):
        mid_, cout_ = ((1, 1) if kind == S.STATS else
                       (mid, 1 if kind == S.BWD_X else cout))
        host = S.plan_host(kind, b, m, k, c, mid_, cout_)
        tile, grid, ring = S._plan(kind, b, m, k, c, mid_, cout_)
        dev = lib.sa_trainbn_smem_bytes(kind, tile, k, c, mid_, cout_,
                                        2 if kind == S.STATS else ring)
        out[name] = dict(tile=tile, grid=grid, ring=ring, smem_bytes=dev)
        if (host.tile != tile or host.smem != dev or dev > S._SMEM_LIMIT
                or (kind != S.STATS and host.ring != ring)):
            raise AssertionError(f"train-BN {name} plan: host {host}, kernel "
                                 f"tile {tile} ring {ring} {dev} bytes "
                                 f"({where})")
    return out


def phase_modelnet_kernels(gen) -> dict:
    """The kernels of the ModelNet-C path at its shapes, each against its
    plain version as the kernel phase holds it at width 32: at the four
    width-64 stages from N = 1024 (STAGES_64) the ball group (row 2) and
    the fused SA (row 3) on whole clouds, the four train-BN passes (rows
    16-19, random weights, their plans against the host's copy) and the
    differentiable fused SA forward and backward (rows 5, 6) on clouds with
    dropped points, each forward's and backward's shared memory against the
    host's copy; at the AdaptPoint step's N = 1024 shapes the max-pooled
    ball group at its four groupers (rows 7, 8, f32 and bf16 features, their
    layouts), the kNN at its five calls (row 11, exact) and the mask head's
    attention (rows 9, 10, both input types). Returns each kernel's summed
    row at these shapes."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import knn
    from adaptpoint_tpu_torch.ops import fpsample as fps

    out = {}
    inputs = stage_inputs(gen, STAGES_64)
    out["ball_group"], out["sa_eval"] = check_stages_forward(
        gen, STAGES_64, inputs, inputs)
    layouts, captured = {}, []
    for i, ((n, m, c, mid, cout, r), (xyz, qidx, feats)) in enumerate(
            zip(STAGES_64, inputs)):
        layouts[f"stage {i + 1}"] = check_trainbn_layout(
            B, m, K, c, mid, cout, f"width 64, stage {i + 1}")
        w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) \
            / (3 + c) ** 0.5
        w2 = torch.randn((mid, cout), generator=gen, device=DEV) / mid ** 0.5
        g1, g2 = (1.0 + 0.1 * torch.randn((w,), generator=gen, device=DEV)
                  for w in (mid, cout))
        b1, b2 = (0.1 * torch.randn((w,), generator=gen, device=DEV)
                  for w in (mid, cout))
        captured.append((xyz, qidx, feats, w1, g1, b1, w2, g2, b2, r, True,
                         True))
    emit("sa_trainbn_layouts", width=64, layouts=layouts)
    out.update(check_sa_trainbn(gen, captured, op_launches=False))
    del inputs, captured
    torch.cuda.empty_cache()
    fake = stage_inputs(gen, STAGES_64, FAKE_DROPPED)
    out["sa_train"], out["sa_train_bwd"] = check_sa_train(gen, STAGES_64,
                                                          fake)
    del fake
    torch.cuda.empty_cache()

    n0 = GAN_STAGES_1024[0][0]
    cloud = torch.randn((B, n0, 3), generator=gen, device=DEV)
    cloud = cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    order = fps.furthest_point_sample_cuda(cloud, n0 // 2)
    levels = [cloud, ops.index_points(cloud, order).contiguous()]
    for _, m, _, _ in GAN_STAGES_1024[1:]:
        levels.append(levels[1][:, :m].contiguous())
    acc = {dt: [dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0) for _ in "fb"]
           for dt in (torch.float32, torch.bfloat16)}
    bg_layouts = {}
    for i, (n, m, c, r) in enumerate(GAN_STAGES_1024):
        qidx = (order if i == 0 else ops.fps_prefix_idx(B, m, DEV)) \
            .int().contiguous()
        bg_layouts[f"grouper {i + 1}"] = check_bgmax_layout(
            n, m, c, K_GAN, f"N=1024 grouper {i + 1}")
        for dt in acc:
            feats = torch.randn((B, n, c), generator=gen, device=DEV).to(dt)
            for a, row in zip(acc[dt], check_ball_group_max(
                    gen, f"N=1024 grouper {i + 1}", levels[i], qidx, feats,
                    r)):
                a["ms"] += row["ms"]
                a["plain_ms"] += row["plain_ms"]
                a["max_abs_err"] = max(a["max_abs_err"], row["max_abs_err"])
    emit("ball_group_max_layouts", n=n0, layouts=bg_layouts)
    for name, j in (("ball_group_max", 0), ("ball_group_max_bwd", 1)):
        out[name] = dict(acc[torch.float32][j], bf16=acc[torch.bfloat16][j],
                         shape=[B, n0, K_GAN, "the four groupers"])

    row = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    cases = [(3, levels[i + 1], levels[i]) for i in range(4)]
    cases.append((24, levels[4], levels[0][:, :4].contiguous()))
    for k, support, query in cases:
        got = knn.knn_idx_cuda(k, support, query)
        ref = knn.knn_idx_plain(k, support, query)
        mism = int((got != ref).sum())
        emit("kernel", name="knn", shape=[B, support.shape[1],
                                          query.shape[1], 3, k],
             mismatches=mism, tolerance="exact")
        if mism:
            raise AssertionError(f"kNN kernel disagrees at {mism} indices "
                                 f"(N=1024 step, k={k})")
        row["ms"] += cuda_ms(lambda: knn.knn_idx_cuda(k, support, query))
        row["plain_ms"] += cuda_ms(lambda: knn.knn_idx_plain(k, support,
                                                              query), 50.0)
    out["knn"] = row
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        errs[str(dt)] = check_mha_shape(gen, MHA_SHAPE_1024, MHA_SCALE,
                                        dt)["max_abs_err"]
    # times for the bf16 inputs the policy passes
    from adaptpoint_tpu_torch.ops import attention
    q, k_, v, do = [torch.randn(MHA_SHAPE_1024, generator=gen, device=DEV)
                    for _ in range(4)]
    q, k_, v = (t.to(torch.bfloat16) for t in (q, k_, v))
    _, saved = attention.mha_cuda(q, k_, v, MHA_SCALE, for_backward=True)
    out["mha"] = dict(shape=list(MHA_SHAPE_1024),
                      max_abs_err=errs["torch.bfloat16"]["out"],
                      max_abs_err_f32=errs["torch.float32"]["out"],
                      ms=cuda_ms(lambda: attention.mha_cuda(
                          q, k_, v, MHA_SCALE, for_backward=True)))
    out["mha_bwd"] = dict(shape=list(MHA_SHAPE_1024), max_abs_err=max(
        errs["torch.bfloat16"][g] for g in ("dq", "dk", "dv")),
        ms=cuda_ms(lambda: attention.mha_bwd_cuda(q, k_, v, MHA_SCALE, do,
                                                  saved)))
    del q, k_, v, do, saved
    emit("modelnet_kernels", note="the ModelNet-C path's shapes: width-64 "
         "stages from N=1024 at B=32 (rows 2, 3, 5, 6, 16-19), the "
         "AdaptPoint step at N=1024 (rows 7-11); ms summed over the stages",
         rows=out)
    torch.cuda.empty_cache()
    return out


def corrupted_clouds(clean) -> dict:
    """Clouds ``clean`` (S, N, 3) with the seven ModelNet-C / ShapeNet-C
    corruptions at five levels each (scale, jitter, rotate, global and local
    dropout with the dropped points replaced by kept ones, global and local
    additions in place of points), seeded: split name -> points, ``clean``
    included."""
    import numpy as np
    from adaptpoint_tpu_torch.datasets.scanobjectnn import CORRUPTIONS
    rng = np.random.default_rng(3)
    size, n = clean.shape[:2]
    out = {"clean": clean}
    for corruption in CORRUPTIONS[1:]:
        for level in range(5):
            s = (level + 1) / 5.0
            p = clean.copy()
            if corruption == "scale":
                p *= rng.uniform(1 - 0.4 * s, 1 + 0.4 * s,
                                 (size, 1, 3)).astype(np.float32)
            elif corruption == "jitter":
                p += rng.normal(0, 0.05 * s, p.shape).astype(np.float32)
            elif corruption == "rotate":
                t = np.pi / 6 * s
                rot = np.array([[np.cos(t), -np.sin(t), 0],
                                [np.sin(t), np.cos(t), 0], [0, 0, 1]],
                               np.float32)
                p = p @ rot
            elif corruption.startswith("dropout"):
                for i in range(size):
                    if corruption == "dropout_global":
                        drop = rng.random(n) < 0.5 * s
                    else:
                        c = p[i, rng.integers(n)]
                        drop = ((p[i] - c) ** 2).sum(-1) < (0.5 * s) ** 2
                    keep = np.flatnonzero(~drop)
                    if len(keep) and len(keep) < n:
                        p[i, drop] = p[i, rng.choice(keep, int(drop.sum()))]
            else:
                k = int(n * 0.2 * s)
                for i in range(size):
                    at = rng.choice(n, k, replace=False)
                    if corruption == "add_global":
                        p[i, at] = rng.uniform(-1, 1, (k, 3))
                    else:
                        c = p[i, rng.integers(n)]
                        p[i, at] = c + rng.normal(0, 0.1, (k, 3))
            out[f"{corruption}_{level}"] = p.astype(np.float32)
    return out


def modelnet_c_arrays(num_points: int, size: int) -> dict:
    """A ModelNet-C split's ``(points, labels)`` by name, made from
    SyntheticCls's val clouds (40 classes) by ``corrupted_clouds``: the
    sweep's data where the real set is absent."""
    import numpy as np
    from adaptpoint_tpu_torch.datasets.synthetic import SyntheticCls
    ds = SyntheticCls(split="val", num_points=num_points, num_classes=40,
                      size=size)
    labels = ds.labels.astype(np.int64)
    return {split: (points, labels) for split, points in
            corrupted_clouds(ds.points.astype(np.float32)).items()}


def phase_modelnet_cli():
    """Path C, the paper's second benchmark: ModelNet40 training with the
    ModelNet-C sweep, through the port's CLI in child processes as a user
    starts it, on SyntheticCls at the ModelNet cfgs' shapes (1024 points, 40
    classes, MN_SIZE clouds a split, B = 32, PointNeXt-S at width 64):

    1. ``--cfg cfgs/modelnetc/pointnext-s_adaptpoint.yaml`` (``mode:
       adaptpoint_modelnet``) with ``rsmix_params`` (AdaptPoint + RSMix in
       phase B) for MN_EPOCHS epochs at the card's defaults;
    2. the same with ``resume=True pretrained_path=<latest>`` and one epoch
       more: the log must show the run resumed at epoch MN_EPOCHS + 1 with
       the GAN pair reloaded, and exactly that one epoch run;
    3. ``--cfg cfgs/modelnetc/pointnext-s.yaml`` (``mode: modelnetc``) with
       ``pointwolf`` for one epoch on the fused routes
       (``ADAPTPOINT_TPU_TRAIN_FUSED=1``, ``ADAPTPOINT_TPU_EVAL_FUSED=1``).

    Each run logs its skipped ModelNet-C sweep (no tree on the card). Then,
    in this process, ``eval_corrupt_wrapper_modelnetc`` over the port's
    ``ModelNetC`` and ``validate_modelnetc`` on the first run's best weights
    (fused eval): 1 clean and 7 x 5 corrupt splits in ``outcorruption.txt``,
    mCE and RmCE equal to ``calculate_ce`` of its OAs within the report's
    rounding. Without ``h5py`` only the h5 read is replaced, by arrays this
    script made (``modelnet_c_arrays``). Runs 2 and 3 run side by side.
    Returns the launch counts of the three children and the sweep."""
    import concurrent.futures
    import glob
    import importlib.util
    import logging
    import re
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.datasets import modelnet
    from adaptpoint_tpu_torch.engine.cls_trainer import (TrainState,
                                                         make_eval_step)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig
    from adaptpoint_tpu_torch.utils.ckpt import load_checkpoint

    adapt_cfg = "cfgs/modelnetc/pointnext-s_adaptpoint.yaml"
    root = os.path.join(ROOT, "build", "chip_smoke", "modelnet_cli")
    data = ["dataset.common.NAME=SyntheticCls", "dataset.common.num_classes=40",
            f"dataset.common.size={MN_SIZE}", "seed=1"]
    total, lock = {}, threading.Lock()

    def run(cfg_path, extra, env=None):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "adaptpoint_tpu_torch.main", "--cfg",
             cfg_path] + data + extra + [f"root_dir={root}"], cwd=ROOT,
            env=env or os.environ, capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"the CLI exited {out.returncode}:\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        counts = json.loads(out.stdout.strip().splitlines()[-1])[
            "launch_counts"]
        with lock:
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        log = out.stdout
        return dict(seconds=seconds, log=log, counts=counts,
                    epochs=[int(e) for e in re.findall(r"Epoch (\d+) LR",
                                                       log)],
                    val_oa=[float(v) for v in re.findall(
                        r"val_oa ([0-9.]+)", log)],
                    phases=[(float(a), float(b)) for a, b in re.findall(
                        r"phase_a_seconds ([0-9.]+) phase_b_seconds "
                        r"([0-9.]+)", log)],
                    epoch_seconds=[float(v) for v in re.findall(
                        r"epoch_seconds ([0-9.]+)", log)],
                    skipped=log.count("skipping corruption eval"))

    first = run(adapt_cfg, [f"epochs={MN_EPOCHS}", MN_RSMIX])
    runs = sorted(glob.glob(os.path.join(root, "modelnetc", "*")),
                  key=os.path.getmtime)
    run_dir = runs[-1]
    name = os.path.basename(run_dir)
    latest = os.path.join(run_dir, "checkpoint", f"{name}_ckpt_latest.pth")
    best = os.path.join(run_dir, "checkpoint", f"{name}_ckpt_best.pth")
    env = dict(os.environ, ADAPTPOINT_TPU_TRAIN_FUSED="1",
               ADAPTPOINT_TPU_EVAL_FUSED="1")
    # the pointwolf run reads and writes no file of the resumed one (a run
    # dir of its own), so the two children run side by side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        wolf_job = pool.submit(run, "cfgs/modelnetc/pointnext-s.yaml",
                               ["epochs=1", "pointwolf.w_num_anchor=4"], env)
        resumed = run(adapt_cfg, [f"epochs={MN_EPOCHS + 1}", MN_RSMIX,
                                  "resume=True", f"pretrained_path={latest}"])
        wolf = wolf_job.result()
    after = torch.load(latest, map_location="cpu", weights_only=True)

    # the ModelNet-C sweep in this process, on the first run's best weights
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, adapt_cfg), recursive=True)
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    tree = os.path.join(root, "modelnet_c")
    os.makedirs(tree, exist_ok=True)
    cfg.update({"modelnet_c_dir": tree, "run_dir": tree, "mode":
                "adaptpoint_modelnet", "val_batch_size": 64})
    arrays = modelnet_c_arrays(N0, MN_C_SIZE)
    has_h5py = importlib.util.find_spec("h5py") is not None
    for split, (pts, lab) in arrays.items():
        path = os.path.join(tree, f"{split}.h5")
        if has_h5py:
            import h5py
            with h5py.File(path, "w") as f:
                f["data"], f["label"] = pts, lab[:, None]
        else:
            open(path, "wb").close()  # ModelNetC asks for the file
    report = os.path.join(tree, "outcorruption.txt")
    if os.path.exists(report):
        os.remove(report)
    read = modelnet.load_h5_cached
    if not has_h5py:
        modelnet.load_h5_cached = lambda path: arrays[
            os.path.splitext(os.path.basename(path))[0]]
    model = build_model_from_cfg(cfg.model, device=DEV, seed=1)
    epoch_best, _ = load_checkpoint(model, best)
    eval_step = make_eval_step(model, cfg, fused_eval=True)
    root_log = logging.getLogger()
    level = root_log.level
    root_log.setLevel(logging.WARNING)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = modelnet.eval_corrupt_wrapper_modelnetc(
            {"eval_step": eval_step, "state": TrainState(model, None),
             "cfg": cfg}, tree, f"best E{epoch_best}")
    finally:
        modelnet.load_h5_cached = read
        root_log.setLevel(level)
    sweep_seconds = time.perf_counter() - t0
    for k, v in ops.launch_counts().items():
        total[k] = total.get(k, 0) + v
    lines = open(report).read().splitlines()
    split_lines = [ln for ln in lines if ln.startswith("{'acc'")]
    oas = {c: result[c]["OA"] for c in result if c != "aggregate"}
    ce = modelnet.calculate_ce(oas)
    agg = result["aggregate"]
    ce_ok = (abs(agg["mCE"] - ce["mCE"]) <= 1e-3 + 1e-9
             and abs(agg["RmCE"] - ce["RmCE"]) <= 1e-3 + 1e-9)

    emit("modelnet_cli",
         adaptpoint_rsmix=dict(seconds=first["seconds"],
                               epochs=first["epochs"],
                               phase_seconds=first["phases"],
                               val_oa=first["val_oa"],
                               sweep_skipped=first["skipped"],
                               launches=first["counts"]),
         resumed=dict(seconds=resumed["seconds"], epochs=resumed["epochs"],
                      phase_seconds=resumed["phases"],
                      val_oa=resumed["val_oa"],
                      latest_epoch=int(after["epoch"]),
                      gan_pair_reloaded="resumed GAN pair from"
                      in resumed["log"], launches=resumed["counts"]),
         modelnetc_pointwolf=dict(seconds=wolf["seconds"],
                                  epochs=wolf["epochs"],
                                  epoch_seconds=wolf["epoch_seconds"],
                                  val_oa=wolf["val_oa"],
                                  sweep_skipped=wolf["skipped"],
                                  launches=wolf["counts"]),
         sweep=dict(seconds=sweep_seconds, splits=len(split_lines),
                    oa=oas, aggregate=agg, calculate_ce=ce,
                    h5_read="h5py" if has_h5py else
                    "replaced: arrays made by chip_smoke.py (no h5py)"),
         run_dir=os.path.relpath(run_dir, ROOT))
    if first["epochs"] != list(range(1, MN_EPOCHS + 1)) or len(
            first["phases"]) != MN_EPOCHS or not all(
            a > 0 and b > 0 for a, b in first["phases"]):
        raise AssertionError(f"AdaptPoint + RSMix epochs {first['epochs']}, "
                             f"phases {first['phases']}")
    if resumed["epochs"] != [MN_EPOCHS + 1] or int(after["epoch"]) != \
            MN_EPOCHS + 1 or "resumed GAN pair from" not in resumed["log"] \
            or f"at epoch {MN_EPOCHS} " not in resumed["log"]:
        raise AssertionError(f"the resumed run: epochs {resumed['epochs']}, "
                             f"checkpoint epoch {after['epoch']}")
    if wolf["epochs"] != [1] or "epoch variant: pointwolf" not in wolf["log"]:
        raise AssertionError(f"mode: modelnetc with pointwolf: "
                             f"{wolf['epochs']}")
    if min(first["skipped"], resumed["skipped"], wolf["skipped"]) < 1:
        raise AssertionError("a skipped ModelNet-C sweep was not logged")
    oas_all = first["val_oa"] + resumed["val_oa"] + wolf["val_oa"]
    if not oas_all or not all(np.isfinite(v) and 0 <= v <= 100
                              for v in oas_all):
        raise AssertionError(f"validation OAs {oas_all}")
    if len(split_lines) != 1 + 7 * 5 or not ce_ok or not all(
            0.0 <= v <= 1.0 for v in oas.values()):
        raise AssertionError(f"the ModelNet-C report: {len(split_lines)} "
                             f"splits, aggregate {agg}, calculate_ce {ce}")
    return total


@contextlib.contextmanager
def captured_sa_eval(log: list):
    """Inside, every ``ops.sa_eval`` call appends its arguments to ``log``
    (detached): the stages an eval forward hands the fused eval op. Nothing
    of the port does this."""
    from adaptpoint_tpu_torch import ops
    orig = ops.sa_eval

    def recording(radius, nsample, xyz, query_idx, feats, *weights,
                  relative=True, normalize_dp=False, packed=None):
        log.append((float(radius), int(nsample), xyz.detach().contiguous(),
                    query_idx.int().contiguous(),
                    feats.detach().float().contiguous())
                   + tuple(w.detach() for w in weights)
                   + (bool(relative), bool(normalize_dp)))
        return orig(radius, nsample, xyz, query_idx, feats, *weights,
                    relative=relative, normalize_dp=normalize_dp,
                    packed=packed)

    ops.sa_eval = recording
    try:
        yield
    finally:
        ops.sa_eval = orig


def captured_sa_eval_rows(captured_eval, tag: str, layouts: dict) -> dict:
    """Row 3 against its plain version at the four stages an eval forward
    handed the fused eval op (``captured_sa_eval``), each stage's launch
    shape against the host's copy (into ``layouts``). Returns its row, the
    times summed over the stages."""
    import torch
    from adaptpoint_tpu_torch.ops import saeval

    row = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0)
    for i, (r, k, xyz, qidx, feats, w1, b1, w2, b2, rel, ndp) in enumerate(
            captured_eval):
        bq, n = xyz.shape[:2]
        m, c, mid, cout = qidx.shape[1], feats.shape[2], w1.shape[1], \
            w2.shape[1]
        args = (r, k, xyz, qidx, feats, w1, b1, w2, b2, rel, ndp)
        layouts[f"eval stage {i + 1}"] = check_fwd_layout(
            k, saeval.pack_weights(w1, b1, w2, b2), n, bq, m,
            f"{tag} eval stage {i + 1}")
        got = saeval.sa_eval_cuda(*args)
        ref = saeval.sa_eval_plain(*args)
        torch.cuda.synchronize()
        e_pos = max(float((got[0] - ref[0]).abs().max()),
                    float((got[1] - ref[1]).abs().max()))
        diff = (got[2] - ref[2]).abs()
        scaled = float((diff / (1.0 + ref[2].abs())).max())
        emit("kernel", name="sa_eval", case=f"{tag} eval",
             stage=[bq, n, m, c, mid, cout, k],
             max_abs_err={"new_xyz_fi": e_pos, "out": float(diff.max())},
             max_scaled_err=scaled,
             tolerance=f"new_xyz, fi exact; |out - plain| <= {TOL_SA} * "
                       f"(1 + |plain|)")
        if e_pos or scaled > TOL_SA or not torch.isfinite(got[2]).all():
            raise AssertionError(f"fused SA kernel disagrees at {tag} "
                                 f"eval stage {i + 1}: {e_pos}, {scaled}")
        row["ms"] += cuda_ms(lambda: saeval.sa_eval_cuda(*args))
        row["plain_ms"] += cuda_ms(lambda: saeval.sa_eval_plain(*args), 50.0)
        row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
        row["t_b"] += (bq * n * (12 + c * 4) + bq * m * 4
                       + ((3 + c) * mid + mid * cout) * 2 + (mid + cout) * 4
                       + bq * m * (12 + c * 4 + cout * 4)) / PEAK_BYTES
        row["t_o"] += (2 * bq * m * k * ((3 + c) * mid + mid * cout)
                       / PEAK_BF16
                       + scanned_points(xyz, qidx, r, k) * 9 / PEAK_F32)
    if len(captured_eval) != 4:
        raise AssertionError(f"{len(captured_eval)} fused eval stages")
    row.update(bound_row(row.pop("t_b"), row.pop("t_o")))
    return row


def partseg_kernels(gen, captured_eval, captured_train, rows) -> None:
    """Every kernel of the part-segmentation path against its plain version
    at the shapes the model hands it, each row's times summed over its calls
    under ``partseg_shapes`` in ``rows`` where given: FPS 2048 -> 1024 at
    B = 32 and 64 (row 1); the ball group forward and backward at the four
    N = 2048 stages (rows 2, 4, seeded unit-sphere clouds, their layouts);
    and row 3 on them at B = 32 (``b32``); the fused
    eval SA at the B = 64 stages a fused eval forward handed it (row 3,
    ``captured_eval``); the four train-BN passes at the stages the fused
    train step handed them (rows 16-19, ``captured_train``, their plans);
    the kNN, the row gather and its scatter-add at the decoder's four FP
    levels (rows 11, 14, 15: k = 3 at B = 32 and 64, the (B, N, 3) gathers
    of the coarse features and of the coarse points)."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import fpsample as fps
    from adaptpoint_tpu_torch.ops import knn, saeval

    out = {}
    # row 1
    row = dict(ms=0.0, plain_ms=0.0, max_abs_err=0, t_b=0.0, t_o=0.0)
    for b in (B, PARTSEG_VAL_B):
        cloud = torch.randn((b, N_PARTSEG, 3), generator=gen, device=DEV)
        m = N_PARTSEG // 2
        got = fps.furthest_point_sample_cuda(cloud, m)
        mism = int((got != fps.furthest_point_sample_plain(cloud, m)).sum())
        emit("kernel", name="fps", case="partseg", shape=[b, N_PARTSEG, m],
             mismatches=mism, tolerance="exact")
        if mism:
            raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                                 f"(B={b}, {N_PARTSEG} -> {m})")
        row["ms"] += cuda_ms(lambda: fps.furthest_point_sample_cuda(cloud, m))
        row["plain_ms"] += cuda_ms(
            lambda: fps.furthest_point_sample_plain(cloud, m), 50.0)
        row["t_b"] += (b * N_PARTSEG * 12 + b * m * 4) / PEAK_BYTES
        row["t_o"] += (m - 1) * b * N_PARTSEG * 10 / PEAK_F32
    row.update(bound_row(row.pop("t_b"), row.pop("t_o")))
    out["fps"] = row

    # rows 2, 4 (and row 3 at B = 32 on the same seeded stages)
    inputs = stage_inputs(gen, PARTSEG_STAGES)
    out["ball_group"], sa32 = check_stages_forward(gen, PARTSEG_STAGES, inputs,
                                                   inputs)
    out["ball_group_bwd"] = check_stages_backward(gen, PARTSEG_STAGES, inputs)
    layouts = {f"stage {i + 1}": check_bg_layout(B, n, m, c, K)
               for i, (n, m, c, _, _, _) in enumerate(PARTSEG_STAGES)}
    del inputs

    # row 3 at the stages of a B = 64 fused eval forward
    out["sa_eval"] = captured_sa_eval_rows(captured_eval, "part-seg", layouts)
    out["sa_eval"]["b32"] = sa32

    # rows 16-19 at the fused train step's stages
    for i, c_ in enumerate(captured_train):
        xyz, qidx, feats, w1 = c_[:4]
        layouts[f"train-BN stage {i + 1}"] = check_trainbn_layout(
            xyz.shape[0], qidx.shape[1], K, feats.shape[2], w1.shape[1],
            c_[6].shape[1], f"part-seg stage {i + 1}")
    out.update(check_sa_trainbn(gen, captured_train, op_launches=False))
    emit("partseg_layouts", layouts=layouts)

    # rows 11, 14, 15 at the decoder's levels
    knn_row = dict(ms=0.0, plain_ms=0.0, max_abs_err=0, t_b=0.0, t_o=0.0)
    g_rows = [dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                   bound_ms=0.0) for _ in range(2)]
    for b in (B, PARTSEG_VAL_B):
        cloud = torch.randn((b, N_PARTSEG, 3), generator=gen, device=DEV)
        cloud = cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        order = fps.furthest_point_sample_cuda(cloud, N_PARTSEG // 2)
        # the levels' points: the cloud, then FPS-ordered prefixes
        levels = {N_PARTSEG: cloud,
                  N_PARTSEG // 2: ops.index_points(cloud, order).contiguous()}
        for _, ns, _ in PARTSEG_LEVELS[:-1]:
            levels[ns] = levels[N_PARTSEG // 2][:, :ns].contiguous()
        for i, (nq, ns, c) in enumerate(PARTSEG_LEVELS):
            query, support = levels[nq], levels[ns]
            got = knn.knn_idx_cuda(3, support, query)
            mism = int((got != knn.knn_idx_plain(3, support, query)).sum())
            emit("kernel", name="knn", case="partseg",
                 shape=[b, ns, nq, 3, 3], mismatches=mism, tolerance="exact")
            if mism:
                raise AssertionError(f"kNN kernel disagrees at {mism} "
                                     f"indices (B={b}, {nq} over {ns})")
            knn_row["ms"] += cuda_ms(lambda: knn.knn_idx_cuda(3, support,
                                                              query))
            knn_row["plain_ms"] += cuda_ms(
                lambda: knn.knn_idx_plain(3, support, query), 50.0)
            knn_row["t_b"] += b * (ns + nq) * 12 / PEAK_BYTES
            knn_row["t_o"] += b * nq * ns * 9 / PEAK_F32
            if b != B:
                continue
            cases = [(c, f"FP level {4 - i}")]
            if i == 3:  # the coarse points' gather of the distances
                cases.append((3, "FP level 1 points"))
            for width, tag in cases:
                for acc, r_ in zip(g_rows, check_gather(
                        gen, f"partseg {tag}", ns, width, got,
                        dtypes=("float32",), min_total_ms=100.0)):
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        acc[key] += r_[key]
                    acc["max_abs_err"] = max(acc["max_abs_err"],
                                             r_["max_abs_err"])
    knn_row.update(bound_row(knn_row.pop("t_b"), knn_row.pop("t_o")))
    out["knn"] = knn_row
    out["gather_rows"], out["gather_rows_bwd"] = g_rows
    for name, r_ in out.items():
        if rows is not None:
            rows[name]["partseg_shapes"] = r_
    emit("partseg_kernels", note="the part-segmentation path's shapes: "
         "N = 2048 stages at B = 32 (rows 2, 4, 16-19), B = 64 eval stages "
         "(row 3), FPS and the FP levels' kNN at B = 32 and 64, the FP "
         "levels' gathers at B = 32 (rows 14, 15); ms summed over calls",
         rows=out)


def phase_partseg(gen, rows):
    """Part segmentation at full width through the entry points a user
    calls (``cfgs/shapenetpart/pointnext-s.yaml``, seeded weights, seeded
    (32, 2048) ``SyntheticPartSeg`` batches): the first train step on the
    card against the same step through the plain versions on the card and
    on a float64 CPU copy, the launches a step makes on the unfused route
    and on the fused train-BN switch (its first step against the unfused
    one), the B = 64 eval forward on both routes and ``validate_partseg``
    over a padded last batch, then every kernel of the path against its
    plain version at the model's shapes (``partseg_kernels``, their rows
    added to ``rows`` when given), and ms per train step and per B = 64 eval
    forward on both routes with the profiler's device-busy time. Returns the
    launch counts of this path's run."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.datasets import NumpyLoader
    from adaptpoint_tpu_torch.datasets.synthetic import SyntheticPartSeg
    from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
    from adaptpoint_tpu_torch.engine.partseg_main import (
        make_partseg_eval_step, make_partseg_train_step, partseg_batch,
        validate_partseg)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs/shapenetpart/pointnext-s.yaml"),
             recursive=True)
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    lr = float(cfg.lr)
    train = NumpyLoader(SyntheticPartSeg("train", N_PARTSEG, size=4 * B,
                                         seed=1), B, shuffle=True,
                        drop_last=True, seed=1)
    batches = [partseg_batch(b_, DEV) for b_ in train]
    val = list(NumpyLoader(SyntheticPartSeg("val", N_PARTSEG,
                                            size=PARTSEG_VAL_B + 40, seed=1),
                           PARTSEG_VAL_B))
    model = build_model_from_cfg(cfg.model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    host_gen = torch.Generator().manual_seed(2)
    mask = torch.rand((B, N_PARTSEG, cfg.model.cls_args.mlps[-1]),
                      generator=host_gen) >= 0.5
    first = {k: v.cpu() for k, v in batches[0].items()}

    def copy_of(device, dtype=torch.float32):
        twin = build_model_from_cfg(cfg.model, device=device).to(dtype)
        twin.load_state_dict({k: v.to(device) for k, v in
                              model.state_dict().items()})
        return twin

    def first_step(net, device, dtype=torch.float32, fused=False, step=None,
                   st=None):
        if step is None:
            crit, opt, _ = build_train_tools(cfg, net)
            step = make_partseg_train_step(net, opt, crit, cfg,
                                           fused_train_bn=fused)
            st = TrainState(net, opt)
        seen = {}
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        batch = {k: v.to(device, dtype) if v.is_floating_point()
                 else v.to(device) for k, v in first.items()}
        _, loss_, preds_ = step(st, batch, lr, dropout_mask=mask.to(device))
        hook.remove()
        return {"loss": float(loss_), "preds": preds_.cpu(),
                "logits": seen["logits"].double().cpu(),
                "grads": {n: p.grad.double().cpu()
                          for n, p in net.named_parameters()},
                "params": {n: p.detach().double().cpu()
                           for n, p in net.named_parameters()},
                "buffers": {n: b_.double().cpu()
                            for n, b_ in net.named_buffers()}}

    plain_twin, fused_twin = copy_of(DEV), copy_of(DEV)
    cpu_twin = copy_of("cpu", torch.float64)
    want = {**dict.fromkeys(ops.KERNEL_MODULES, 0), "fps": 1,
            "ball_group": 4, "ball_group_bwd": 4, "knn": 4,
            "gather_rows": 8, "gather_rows_bwd": 4}
    want_fused = {**want, "ball_group": 0, "ball_group_bwd": 0,
                  "sa_trainbn_stats": 4, "sa_trainbn_fwd": 4,
                  "sa_trainbn_bwd_w2": 4, "sa_trainbn_bwd_x": 4}
    ops.reset_launch_counts()  # this path's run starts here
    criterion, optimizer, _ = build_train_tools(cfg, model)
    train_step = make_partseg_train_step(model, optimizer, criterion, cfg)
    state = TrainState(model, optimizer)
    got = first_step(model, DEV, step=train_step, st=state)
    torch.cuda.synchronize()
    per_step = ops.launch_counts()
    captured_train = []
    with captured_trainbn(captured_train):
        fused = first_step(fused_twin, DEV, fused=True)
    torch.cuda.synchronize()
    fused_step = {k: v - per_step[k] for k, v in ops.launch_counts().items()}
    run_counts = ops.launch_counts()
    with plain_ops():
        ref_plain = first_step(plain_twin, DEV)
    t0 = time.perf_counter()
    ref_cpu = first_step(cpu_twin, "cpu", torch.float64)
    cpu_s = time.perf_counter() - t0
    if ops.launch_counts() != run_counts:
        raise AssertionError("a plain-version step launched a kernel")
    del plain_twin, cpu_twin
    tol_cpu = TOL_PARTSEG_STEP
    w_plain, ok_plain = step_disagreement(got, ref_plain, TOL_STEP_PLAIN, lr)
    w_cpu, ok_cpu = step_disagreement(got, ref_cpu, tol_cpu, lr)
    w_fused, ok_fused = step_disagreement(fused, got, tol_cpu, lr)
    # the points whose logits leave the tight bound against float64, and
    # how many of them are points of the next level (the first stage's FPS
    # picks), which their FP interpolates from
    far = ~torch.isclose(got["logits"], ref_cpu["logits"],
                         rtol=tol_cpu["logits"][0],
                         atol=tol_cpu["logits"][1]).all(dim=-1)
    coarse = torch.zeros_like(far)
    picks = ops.furthest_point_sample_plain(first["pos"], N_PARTSEG // 2)
    coarse.scatter_(1, picks.long(), True)
    w_cpu["far_points"] = int(far.sum())
    w_cpu["far_points_coarse"] = int((far & coarse).sum())
    emit("partseg_first_step", params=n_params, loss=got["loss"],
         plain_loss=ref_plain["loss"], cpu_f64_loss=ref_cpu["loss"],
         fused_loss=fused["loss"],
         logits_absmax=float(ref_cpu["logits"].abs().max()),
         preds_share_equal=float((got["preds"] == ref_cpu["preds"])
                                 .double().mean()),
         against_plain_versions_on_the_card=w_plain,
         against_float64_cpu_copy=w_cpu, fused_against_unfused=w_fused,
         cpu_copy_seconds=cpu_s, launches=per_step, expected=want,
         fused_launches=fused_step, fused_expected=want_fused,
         stages=[list(c[0].shape[:2]) + [c[1].shape[1], c[2].shape[2],
                                         c[3].shape[1], c[6].shape[1]]
                 for c in captured_train],
         tolerance={"against_plain_versions_on_the_card": TOL_STEP_PLAIN,
                    "against_float64_cpu_copy": tol_cpu,
                    "fused_against_unfused": tol_cpu})
    if per_step != want or fused_step != want_fused:
        raise AssertionError(f"launches in one part-seg train step "
                             f"{per_step} != {want}, fused {fused_step} != "
                             f"{want_fused}")
    if not (ok_plain and ok_cpu and ok_fused and np.isfinite(got["loss"])):
        raise AssertionError(f"the first part-seg train step disagrees: with "
                             f"the plain versions {w_plain}, with the CPU "
                             f"copy {w_cpu}, fused with unfused {w_fused}")
    if len(captured_train) != 4:
        raise AssertionError(f"{len(captured_train)} fused train stages")

    # three more steps through the epoch's step, then the eval forward at
    # B = 64 on both routes and validate over a padded last batch
    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    losses = []
    for b_ in batches[1:]:
        state, loss, _ = train_step(state, b_, lr, generator=dev_gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"part-seg train steps: loss {losses}")
    eval_batch = partseg_batch(val[0], DEV)
    model.eval()
    logits, eval_counts, captured_eval = {}, {}, []
    for fused_eval in (False, True):
        before = ops.launch_counts()
        with torch.no_grad(), (captured_sa_eval(captured_eval) if fused_eval
                               else contextlib.nullcontext()):
            logits[fused_eval] = model(eval_batch["pos"], eval_batch["x"],
                                       eval_batch["cls"],
                                       fused_eval=fused_eval).double()
        eval_counts[fused_eval] = {k: v - before[k] for k, v in
                                   ops.launch_counts().items()
                                   if v - before[k]}
    with plain_ops(), torch.no_grad():
        plain = model(eval_batch["pos"], eval_batch["x"],
                      eval_batch["cls"]).double()
    unf, fus = logits[False], logits[True]
    e_plain = float((unf - plain).abs().max())
    scaled = float(((fus - unf).abs() / (1.0 + unf.abs())).max())
    agree = float((fus.argmax(-1) == unf.argmax(-1)).double().mean())
    want_eval = {False: {"fps": 1, "ball_group": 4, "knn": 4,
                         "gather_rows": 8},
                 True: {"fps": 1, "sa_eval": 4, "knn": 4, "gather_rows": 8}}
    perf = {}
    for fused_eval in (False, True):
        before = ops.launch_counts()
        perf[fused_eval] = validate_partseg(
            make_partseg_eval_step(model, cfg, fused_eval), state, val)
        perf[fused_eval]["launches"] = {
            k: v - before[k] for k, v in ops.launch_counts().items()
            if v - before[k]}
    launches = ops.launch_counts()  # this path's run ends here
    emit("partseg_eval", batch=PARTSEG_VAL_B, points=N_PARTSEG,
         unfused_vs_plain_max_abs=e_plain,
         fused_vs_unfused_max_scaled=scaled, argmax_share_equal=agree,
         logits_absmax=float(unf.abs().max()),
         launches={str(k): v for k, v in eval_counts.items()},
         expected={str(k): v for k, v in want_eval.items()},
         validate={("fused" if k else "unfused"): v for k, v in perf.items()},
         train_losses=losses, launches_total=launches,
         tolerance={"unfused_vs_plain": list(TOL_UNFUSED),
                    "fused_vs_unfused": f"|fused - unfused| <= "
                    f"{TOL_SA} * (1 + |unfused|), argmax equal "
                    f"on >= {PARTSEG_ARGMAX_SHARE} of the points"})
    want_val = {k: {n: len(val) * v for n, v in w.items()}
                for k, w in want_eval.items()}
    if (eval_counts != want_eval
            or not torch.allclose(unf, plain, rtol=TOL_UNFUSED[0],
                                  atol=TOL_UNFUSED[1])
            or scaled > TOL_SA or agree < PARTSEG_ARGMAX_SHARE
            or any(perf[k]["launches"] != want_val[k] for k in perf)
            or not all(np.isfinite(perf[k][m]) for k in perf
                       for m in ("acc", "ins_miou", "cls_miou"))):
        raise AssertionError(f"part-seg eval: launches {eval_counts}, plain "
                             f"{e_plain}, fused {scaled} / {agree}, "
                             f"validate {perf}")

    partseg_kernels(gen, captured_eval, captured_train, rows)
    del captured_eval, captured_train, fused_twin
    torch.cuda.empty_cache()

    # ms per train step and per B = 64 eval forward, on both routes in turns
    readings = {}
    for route in ("unfused", "fused", "fused", "unfused"):
        net = copy_of(DEV)
        crit, opt, _ = build_train_tools(cfg, net)
        step = make_partseg_train_step(net, opt, crit, cfg,
                                       fused_train_bn=route == "fused")
        st = TrainState(net, opt)
        it = [0]

        def go():
            step(st, batches[it[0] % len(batches)], lr, generator=dev_gen)
            it[0] += 1

        readings.setdefault(("train", route), []).append(step_readings(go))
        net.eval()

        def fwd():
            with torch.no_grad():
                net(eval_batch["pos"], eval_batch["x"], eval_batch["cls"],
                    fused_eval=route == "fused")

        r_ = step_readings(fwd)
        r_["clouds_per_s"] = PARTSEG_VAL_B * 1e3 / r_["ms_per_step"]
        readings.setdefault(("eval", route), []).append(r_)
        del net, opt, st
        torch.cuda.empty_cache()
    for (what, route), runs in readings.items():
        emit("partseg_throughput", what=what, route=route,
             batch=B if what == "train" else PARTSEG_VAL_B, points=N_PARTSEG,
             runs=runs)
    return launches


def shapenet_c_arrays(num_points: int, size: int) -> dict:
    """A ShapeNet-C split's ``(points, categories, part labels)`` by name,
    made from SyntheticPartSeg's val clouds by ``corrupted_clouds``; every
    split keeps the clean clouds' part labels, point by point."""
    import numpy as np
    from adaptpoint_tpu_torch.datasets.synthetic import SyntheticPartSeg
    ds = SyntheticPartSeg(split="val", num_points=num_points, size=size)
    labels = ds.labels.astype(np.int64)
    pid = np.stack([ds.get(i, None)["y"] for i in range(size)])
    return {split: (points, labels, pid) for split, points in
            corrupted_clouds(ds.points.astype(np.float32)).items()}


def phase_partseg_cli():
    """Part segmentation with AdaptPoint through the port's CLI in child
    processes as a user starts it (``python -m adaptpoint_tpu_torch.partseg
    --cfg cfgs/shapenetpart/pointnext-s_adaptpoint.yaml``) at the card's
    defaults, on SyntheticPartSeg at the cfg's shapes (N_PARTSEG points,
    PS_SIZE clouds a split, B = 32, val B = 64): PS_EPOCHS epochs, each with
    phase A and phase B, fake clouds that moved from the real ones, the GAN
    pair reloading into a fresh ``build_gan`` bit for bit, finite instance
    and class mIoUs; ``mode=test`` on the best checkpoint giving the best
    epoch's validation metrics (accuracy, instance and class mIoU);
    ``resume=True`` for one epoch more (resumed at the
    next epoch with the GAN pair reloaded, exactly one epoch run). Then, in
    this process, the ShapeNet-C sweep (``eval_corrupt_wrapper_shapenetc``
    over the port's ``ShapeNetPartC`` and ``validate_partseg``, fused eval)
    on the best weights: 1 clean and 7 x 5 corrupt splits in
    ``outcorruption.txt``. Without ``h5py`` only the h5 read is replaced, by
    arrays this script made (``shapenet_c_arrays``). Returns the launch
    counts of the three children and the sweep."""
    import ast
    import importlib.util
    import logging
    import re
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.datasets import NumpyLoader, shapenetpart
    from adaptpoint_tpu_torch.engine import TrainState
    from adaptpoint_tpu_torch.engine.adapt_trainer import build_gan
    from adaptpoint_tpu_torch.engine.partseg_main import (
        make_partseg_eval_step, validate_partseg)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig
    from adaptpoint_tpu_torch.utils.ckpt import load_checkpoint

    adapt_cfg = "cfgs/shapenetpart/pointnext-s_adaptpoint.yaml"
    root = os.path.join(ROOT, "build", "chip_smoke", "partseg_cli")
    data = ["dataset.common.NAME=SyntheticPartSeg",
            f"dataset.common.num_points={N_PARTSEG}",
            f"dataset.common.size={PS_SIZE}", f"num_points={N_PARTSEG}",
            f"batch_size={B}", f"val_batch_size={PARTSEG_VAL_B}", "seed=1"]
    total = {}

    def run(extra):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "adaptpoint_tpu_torch.partseg", "--cfg",
             adapt_cfg] + data + extra + [f"root_dir={root}"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"the CLI exited {out.returncode}:\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        counts = json.loads(out.stdout.strip().splitlines()[-1])[
            "launch_counts"]
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log = out.stdout
        return dict(seconds=seconds, log=log, counts=counts,
                    epochs=[int(e) for e in re.findall(r"Epoch (\d+) LR",
                                                       log)],
                    ins=[float(v) for v in re.findall(
                        r"Epoch .*'ins_miou': ([0-9.e+-]+)", log)],
                    cls=[float(v) for v in re.findall(
                        r"Epoch .*'cls_miou': ([0-9.e+-]+)", log)],
                    phases=[(float(a), float(b)) for a, b in re.findall(
                        r"phase_a_seconds ([0-9.]+) phase_b_seconds "
                        r"([0-9.]+)", log)],
                    moved=[float(v) for v in re.findall(
                        r"mean \|fake - real\| ([0-9.eE+-]+)", log)])

    first = run([f"epochs={PS_EPOCHS}"])
    run_dir = re.findall(r"run dir: (.+)", first["log"])[0].strip()
    name = os.path.basename(run_dir)
    latest = os.path.join(run_dir, "checkpoint", f"{name}_ckpt_latest.pth")
    best = os.path.join(run_dir, "checkpoint", f"{name}_ckpt_best.pth")
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, adapt_cfg), recursive=True)
    saved = torch.load(os.path.join(run_dir, "model_gan.pth"),
                       map_location="cpu", weights_only=True)
    gen_, dis_, _, _, _ = build_gan(cfg, DEV, 1)
    gen_.load_state_dict(saved["generator"], strict=True)
    dis_.load_state_dict(saved["discriminator"], strict=True)
    reloaded = all(torch.equal(v.cpu(), saved[part][k])
                   for part, module in (("generator", gen_),
                                        ("discriminator", dis_))
                   for k, v in module.state_dict().items())
    del gen_, dis_
    tested = run(["mode=test", f"pretrained_path={best}"])
    # the best epoch's validation metrics (the first epoch that reached the
    # best instance mIoU) and the test run's, each dict as the log prints it
    vals = [ast.literal_eval(v) for v in re.findall(
        r"Epoch \d+ LR \S+ loss \S+ val (\{.*?\}) best_ins", first["log"])]
    best_val = (vals[[v["ins_miou"] for v in vals].index(max(first["ins"]))]
                if vals else None)
    test_perf = [ast.literal_eval(v) for v in re.findall(
        r"test: (\{.*?\})", tested["log"])]
    resumed = run([f"epochs={PS_EPOCHS + 1}", "resume=True",
                   f"pretrained_path={latest}"])
    after = torch.load(latest, map_location="cpu", weights_only=True)

    # the ShapeNet-C sweep in this process, on the best weights
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    tree = os.path.join(root, "shapenet_c")
    os.makedirs(tree, exist_ok=True)
    cfg.update({"shapenet_c_dir": tree, "val_batch_size": PARTSEG_VAL_B})
    arrays = shapenet_c_arrays(N_PARTSEG, PS_C_SIZE)
    has_h5py = importlib.util.find_spec("h5py") is not None
    for split, (pts, lab, pid) in arrays.items():
        path = os.path.join(tree, f"{split}.h5")
        if has_h5py:
            import h5py
            with h5py.File(path, "w") as f:
                f["data"], f["label"], f["pid"] = pts, lab[:, None], pid
        else:
            open(path, "wb").close()  # ShapeNetPartC asks for the file
    report = os.path.join(tree, "outcorruption.txt")
    if os.path.exists(report):
        os.remove(report)
    read = shapenetpart.load_h5_seg_cached
    if not has_h5py:
        shapenetpart.load_h5_seg_cached = lambda path: arrays[
            os.path.splitext(os.path.basename(path))[0]]
    model = build_model_from_cfg(cfg.model, device=DEV, seed=1)
    epoch_best, _ = load_checkpoint(model, best)
    eval_step = make_partseg_eval_step(model, cfg, fused_eval=True)
    state = TrainState(model, None)

    def eval_c(split):
        ds = shapenetpart.ShapeNetPartC(data_dir=tree, split=split,
                                        num_points=N_PARTSEG)
        return validate_partseg(eval_step, state,
                                NumpyLoader(ds, PARTSEG_VAL_B))

    root_log = logging.getLogger()
    level = root_log.level
    root_log.setLevel(logging.WARNING)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = shapenetpart.eval_corrupt_wrapper_shapenetc(
            eval_c, {}, tree, f"best E{epoch_best}")
    finally:
        shapenetpart.load_h5_seg_cached = read
        root_log.setLevel(level)
    sweep_seconds = time.perf_counter() - t0
    for k, v in ops.launch_counts().items():
        total[k] = total.get(k, 0) + v
    split_lines = [ln for ln in open(report).read().splitlines()
                   if ln.startswith("{'acc'") and "Overall" not in ln]

    emit("partseg_cli",
         adaptpoint=dict(seconds=first["seconds"], epochs=first["epochs"],
                         phase_seconds=first["phases"],
                         moved=first["moved"], ins_miou=first["ins"],
                         cls_miou=first["cls"], launches=first["counts"]),
         gan_pair_reloaded_bit_for_bit=reloaded,
         tested=dict(seconds=tested["seconds"], metrics=test_perf,
                     best_epoch_metrics=best_val, launches=tested["counts"]),
         resumed=dict(seconds=resumed["seconds"], epochs=resumed["epochs"],
                      phase_seconds=resumed["phases"],
                      ins_miou=resumed["ins"], latest_epoch=int(
                          after["epoch"]),
                      gan_pair_reloaded="resumed GAN pair from"
                      in resumed["log"], launches=resumed["counts"]),
         sweep=dict(seconds=sweep_seconds, splits=len(split_lines),
                    result=result, h5_read="h5py" if has_h5py else
                    "replaced: arrays made by chip_smoke.py (no h5py)"),
         run_dir=os.path.relpath(run_dir, ROOT))
    if first["epochs"] != list(range(1, PS_EPOCHS + 1)) or len(
            first["phases"]) != PS_EPOCHS or not all(
            a > 0 and b > 0 for a, b in first["phases"]) or len(
            first["moved"]) != PS_EPOCHS or min(first["moved"]) <= 0:
        raise AssertionError(f"AdaptPoint epochs {first['epochs']}, phases "
                             f"{first['phases']}, moved {first['moved']}")
    mious = first["ins"] + first["cls"] + resumed["ins"]
    if not reloaded or len(first["ins"]) != PS_EPOCHS or not all(
            np.isfinite(v) and 0 <= v <= 100 for v in mious):
        raise AssertionError(f"GAN pair reloaded {reloaded}, mIoUs {mious}")
    if test_perf != [best_val]:
        raise AssertionError(f"mode=test on the best checkpoint: {test_perf} "
                             f"against the best epoch's {best_val}")
    if resumed["epochs"] != [PS_EPOCHS + 1] or int(after["epoch"]) != \
            PS_EPOCHS + 1 or "resumed GAN pair from" not in resumed["log"] \
            or f"at epoch {PS_EPOCHS} " not in resumed["log"]:
        raise AssertionError(f"the resumed run: epochs {resumed['epochs']}, "
                             f"checkpoint epoch {after['epoch']}")
    if len(split_lines) != 1 + 7 * 5 or not all(
            np.isfinite(v) for agg in result.values()
            for k, v in agg.items() if k in ("acc", "ins_miou", "cls_miou")):
        raise AssertionError(f"the ShapeNet-C report: {len(split_lines)} "
                             f"splits, {result}")
    return total


@contextlib.contextmanager
def captured_ball_group(log: list):
    """Inside, every ``ops.ball_group`` call appends its arguments to
    ``log`` (detached): the calls a step hands the ball group, its SA
    stages' and its InvResMLP blocks'. Nothing of the port does this."""
    from adaptpoint_tpu_torch import ops
    orig = ops.ball_group

    def recording(radius, nsample, xyz, query_idx, feats, relative=True,
                  normalize_dp=False):
        log.append((float(radius), int(nsample), xyz.detach().contiguous(),
                    query_idx.int().contiguous(),
                    feats.detach().float().contiguous(), bool(relative),
                    bool(normalize_dp)))
        return orig(radius, nsample, xyz, query_idx, feats,
                    relative=relative, normalize_dp=normalize_dp)

    ops.ball_group = recording
    try:
        yield
    finally:
        ops.ball_group = orig


def fp_level_rows(gen, tag, pos, order, levels):
    """The kNN (k = 3) and the row gather and its scatter-add at a decoder's
    FP ``levels`` (queries, coarse points, coarse channels; deepest first)
    of the clouds ``pos`` (B, N, 3), each coarse level the prefix of the
    first level's FPS ``order``, each against its plain version: rows 11,
    14 and 15, the times summed over the levels."""
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import knn

    b, n = pos.shape[:2]
    m = levels[-1][1]
    knn_row = dict(ms=0.0, plain_ms=0.0, max_abs_err=0, t_b=0.0, t_o=0.0)
    g_rows = [dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                   bound_ms=0.0) for _ in range(2)]
    points = {n: pos, m: ops.index_points(pos, order).contiguous()}
    for _, ns, _ in levels[:-1]:
        points[ns] = points[m][:, :ns].contiguous()
    for i, (nq, ns, c) in enumerate(levels):
        query, support = points[nq], points[ns]
        idx = knn.knn_idx_cuda(3, support, query)
        mism = int((idx != knn.knn_idx_plain(3, support, query)).sum())
        emit("kernel", name="knn", case=tag, shape=[b, ns, nq, 3, 3],
             variant=list(knn.knn_variant(3, ns, 3)), mismatches=mism,
             tolerance="exact")
        if mism:
            raise AssertionError(f"kNN kernel disagrees at {mism} indices "
                                 f"({tag}, B={b}, {nq} over {ns})")
        knn_row["ms"] += cuda_ms(lambda: knn.knn_idx_cuda(3, support, query),
                                 50.0)
        knn_row["plain_ms"] += cuda_ms(
            lambda: knn.knn_idx_plain(3, support, query), 50.0)
        knn_row["t_b"] += b * (ns + nq) * 12 / PEAK_BYTES
        knn_row["t_o"] += b * nq * ns * 9 / PEAK_F32
        cases = [(c, f"FP level {len(levels) - i}")]
        if i == len(levels) - 1:  # the coarse points' gather of distances
            cases.append((3, "FP level 1 points"))
        for width, case in cases:
            for acc, r_ in zip(g_rows, check_gather(
                    gen, f"{tag} {case}", ns, width, idx,
                    dtypes=("float32",), min_total_ms=50.0)):
                for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    acc[key] += r_[key]
                acc["max_abs_err"] = max(acc["max_abs_err"],
                                         r_["max_abs_err"])
    knn_row.update(bound_row(knn_row.pop("t_b"), knn_row.pop("t_o")))
    return knn_row, g_rows[0], g_rows[1]


def seg_kernels(gen, first_pos, captured_bg, captured_eval, captured_train,
                rows) -> None:
    """Every kernel of the S3DIS path against its plain version at the
    shapes the models hand it, each row's times summed over its calls under
    ``seg_shapes`` in ``rows`` where given: FPS 24000 -> 6000 at B = 8 on
    the first batch's crops (row 1: the pruned kernel, the earlier four-block
    instance beside it, the call's device ops); the ball group
    forward and backward at the nine calls of PointNeXt-B's train step (rows
    2, 4: four SA stages from the 24000-point crop, five InvResMLP blocks
    with query = support, ``captured_bg``), with their layouts; the kNN and
    the row gather and its scatter-add at the decoder's four FP levels
    (rows 11, 14, 15: k = 3, the cloud's FPS order and its prefixes); for
    PointNeXt-S the fused eval SA at the four stages of its B = 8 fused eval
    forward (row 3, ``captured_eval``) and the four train-BN passes at the
    stage its fused train step handed them (rows 16-19,
    ``captured_train``)."""
    from adaptpoint_tpu_torch.ops import fpsample as fps

    out, layouts = {}, {}
    b, n = first_pos.shape[:2]
    m = n // 4
    # row 1: the pruned kernel, and the earlier four-block cluster instance
    # (FPS_PARENT_INSTANCE) on the same crops
    got = fps.furthest_point_sample_cuda(first_pos, m)
    ref = fps.furthest_point_sample_plain(first_pos, m)
    mism = int((got != ref).sum())
    t_parent = time.perf_counter()
    parent = fps.furthest_point_sample_cuda(first_pos, m,
                                            tiling=FPS_PARENT_INSTANCE)
    mism_parent = int((parent != ref).sum())
    p_ms = cuda_ms(lambda: fps.furthest_point_sample_cuda(
        first_pos, m, tiling=FPS_PARENT_INSTANCE), 100.0)
    t_parent = time.perf_counter() - t_parent
    emit("kernel", name="fps", case="seg", shape=[b, n, m],
         tiling=list(fps.fps_tiling(n)), mismatches=mism,
         parent_instance=list(FPS_PARENT_INSTANCE),
         parent_mismatches=mism_parent, tolerance="exact")
    if mism or mism_parent:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                             f"(B={b}, {n} -> {m}; the parent's instance at "
                             f"{mism_parent})")
    row = dict(ms=cuda_ms(lambda: fps.furthest_point_sample_cuda(
        first_pos, m), 100.0),
        plain_ms=cuda_ms(lambda: fps.furthest_point_sample_plain(
            first_pos, m), 50.0), max_abs_err=0,
        **device_host(lambda: fps.furthest_point_sample_cuda(first_pos, m),
                      reps=3),
        **bound_row((b * n * 12 + b * m * 4) / PEAK_BYTES,
                    (m - 1) * b * n * 10 / PEAK_F32))
    row["ns_a_step"] = row["ms"] * 1e6 / (m - 1)
    row["parent_instance"] = dict(tiling=list(FPS_PARENT_INSTANCE), ms=p_ms,
                                  ns_a_step=p_ms * 1e6 / (m - 1),
                                  seconds=t_parent)
    ops_a_call = child_op_launches("fps")
    if max(ops_a_call.values()) > FPS_MAX_OPS:
        raise AssertionError(f"an FPS call makes {ops_a_call} device ops")
    row["op_launches"] = ops_a_call
    out["fps"] = row
    order = got

    # rows 2, 4 at the train step's nine ball-group calls
    if len(captured_bg) != len(SEG_STAGES) + len(SEG_BLOCKS):
        raise AssertionError(f"{len(captured_bg)} ball-group calls a step")
    stages, inputs = [], []
    for r, k, xyz, qidx, feats, rel, ndp in captured_bg:
        if k != K or not (rel and ndp):
            raise AssertionError(f"a ball group at K={k} {rel} {ndp}")
        stages.append((xyz.shape[1], qidx.shape[1], feats.shape[2], 0, 0, r))
        inputs.append((xyz, qidx, feats))
        layouts[f"ball group {len(stages)}"] = check_bg_layout(
            xyz.shape[0], xyz.shape[1], qidx.shape[1], feats.shape[2], K)
    want = ([(n_, m_, c, r) for n_, m_, c, _, _, r in SEG_STAGES]
            + [(n_, n_, c, r) for n_, c, r in SEG_BLOCKS])
    got_shapes = sorted((s_[0], s_[1], s_[2], round(s_[5], 6))
                        for s_ in stages)
    if got_shapes != sorted((a, b_, c, round(r, 6)) for a, b_, c, r in want):
        raise AssertionError(f"the ball-group calls' shapes {got_shapes}")
    out["ball_group"], _ = check_stages_forward(gen, stages, inputs, None)
    out["ball_group_bwd"] = check_stages_backward(gen, stages, inputs)
    del inputs

    # rows 11, 14, 15 at the decoder's levels
    out["knn"], out["gather_rows"], out["gather_rows_bwd"] = fp_level_rows(
        gen, "seg", first_pos, order, SEG_LEVELS)

    # PointNeXt-S: row 3 at its eval stages, rows 16-19 at its fused stage
    out["sa_eval"] = captured_sa_eval_rows(captured_eval, "seg", layouts)
    for i, c_ in enumerate(captured_train):
        xyz, qidx, feats, w1 = c_[:4]
        layouts[f"train-BN stage {i + 1}"] = check_trainbn_layout(
            xyz.shape[0], qidx.shape[1], K, feats.shape[2], w1.shape[1],
            c_[6].shape[1], f"seg stage {i + 1}")
    out.update(check_sa_trainbn(gen, captured_train, op_launches=False))
    emit("seg_layouts", layouts=layouts)
    for name, r_ in out.items():
        if rows is not None:
            rows[name]["seg_shapes"] = r_
    emit("seg_kernels", note="the S3DIS path's shapes at B = 8, N = 24000: "
         "FPS 24000 -> 6000, the ball group at PointNeXt-B's nine calls "
         "a step, the FP levels' kNN and gathers, PointNeXt-S's fused eval "
         "stages and fused train-BN stage; ms summed over calls", rows=out)


def phase_seg(gen, rows):
    """S3DIS scene segmentation at full width through the entry points a
    user calls (``cfgs/s3dis/pointnext-b.yaml``, seeded weights, SEG_B
    ``SyntheticScene`` crops of N_SEG points under the cfg's transforms):
    the first train step on the card against the same step through the
    plain versions on the card, the launches a step makes (FPS 1, ball
    group 9 + 9: four SA stages and five InvResMLP blocks, kNN 4, row
    gather 8, scatter-add 4), two more steps, the eval forward against the
    plain versions and ``validate_seg`` over a padded last batch; then
    ``cfgs/s3dis/pointnext-s.yaml`` (sa_layers 2, residual) at the same
    size: its fused train-BN step against its unfused step from the same
    weights, batch and dropout mask (only stage 1's 6000 centers pass the
    train-BN gate), its fused eval forward against its unfused one, with
    the launches of each; then every kernel of the path against its plain
    version at the models' shapes (``seg_kernels``, their rows added to
    ``rows`` when given), and ms per train step and per eval forward with
    the profiler's device-busy time; then PointNeXt-L and -XL
    (``seg_big_model``). Returns the launch counts of this path's run."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.datasets import NumpyLoader, SyntheticScene
    from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
    from adaptpoint_tpu_torch.engine.seg_main import (
        make_seg_eval_step, make_seg_train_step, seg_batch, validate_seg)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.transforms import build_transforms_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig

    def load(name):
        c = EasyConfig()
        c.load(os.path.join(ROOT, "cfgs", "s3dis", name), recursive=True)
        c.model.in_channels = c.model.encoder_args.in_channels
        return c

    cfg, cfg_s = load("pointnext-b.yaml"), load("pointnext-s.yaml")
    lr = float(cfg.lr)
    t0 = time.perf_counter()
    train = NumpyLoader(SyntheticScene(
        "train", N_SEG, size=3 * SEG_B,
        transform=build_transforms_from_cfg("train", cfg.datatransforms)),
        SEG_B, shuffle=True, drop_last=True, seed=1, num_workers=4)
    batches = [seg_batch(b_, DEV, cfg) for b_ in train]
    val = list(NumpyLoader(SyntheticScene(
        "val", N_SEG, size=SEG_B + 3,
        transform=build_transforms_from_cfg("val", cfg.datatransforms)),
        SEG_B, num_workers=4))
    data_s = time.perf_counter() - t0
    model = build_model_from_cfg(cfg.model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    host_gen = torch.Generator().manual_seed(2)
    mask = torch.rand((SEG_B, N_SEG, model.head.head[0].conv.out_channels),
                      generator=host_gen) >= 0.5
    first = batches[0]

    def copy_of(net_cfg, net):
        twin = build_model_from_cfg(net_cfg.model)
        twin.load_state_dict(net.state_dict())
        return twin

    def first_step(net, net_cfg, fused=False, step=None, st=None):
        if step is None:
            crit, opt, _ = build_train_tools(net_cfg, net)
            step = make_seg_train_step(net, opt, crit, net_cfg,
                                       fused_train_bn=fused)
            st = TrainState(net, opt)
        seen = {}
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        _, loss_, preds_ = step(st, first, lr, dropout_mask=mask.to(DEV))
        hook.remove()
        return {"loss": float(loss_), "preds": preds_.cpu(),
                "logits": seen["logits"].double().cpu(),
                "grads": {k: p.grad.double().cpu()
                          for k, p in net.named_parameters()},
                "params": {k: p.detach().double().cpu()
                           for k, p in net.named_parameters()},
                "buffers": {k: b_.double().cpu()
                            for k, b_ in net.named_buffers()}}

    plain_twin = copy_of(cfg, model)
    model_s = build_model_from_cfg(cfg_s.model, seed=3)
    fused_s = copy_of(cfg_s, model_s)
    zero = dict.fromkeys(ops.KERNEL_MODULES, 0)
    want = {**zero, "fps": 1, "ball_group": 9, "ball_group_bwd": 9,
            "knn": 4, "gather_rows": 8, "gather_rows_bwd": 4}
    want_s = {**want, "ball_group": 4, "ball_group_bwd": 4}
    want_fused = {**want_s, "ball_group": 3, "ball_group_bwd": 3,
                  "sa_trainbn_stats": 1, "sa_trainbn_fwd": 1,
                  "sa_trainbn_bwd_w2": 1, "sa_trainbn_bwd_x": 1}
    ops.reset_launch_counts()  # this path's run starts here
    criterion, optimizer, _ = build_train_tools(cfg, model)
    train_step = make_seg_train_step(model, optimizer, criterion, cfg)
    state = TrainState(model, optimizer)
    captured_bg = []
    t0 = time.perf_counter()
    with captured_ball_group(captured_bg):
        got = first_step(model, cfg, step=train_step, st=state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    per_step = ops.launch_counts()
    before = ops.launch_counts()
    got_s = first_step(model_s, cfg_s)
    torch.cuda.synchronize()
    s_step = {k: v - before[k] for k, v in ops.launch_counts().items()}
    captured_train = []
    before = ops.launch_counts()
    with captured_trainbn(captured_train):
        fused = first_step(fused_s, cfg_s, fused=True)
    torch.cuda.synchronize()
    fused_step = {k: v - before[k] for k, v in ops.launch_counts().items()}
    run_counts = ops.launch_counts()
    t0 = time.perf_counter()
    with plain_ops():
        ref_plain = first_step(plain_twin, cfg)
    plain_s = time.perf_counter() - t0
    if ops.launch_counts() != run_counts:
        raise AssertionError("a plain-version step launched a kernel")
    del plain_twin, fused_s
    w_plain, ok_plain = step_disagreement(got, ref_plain, TOL_STEP_PLAIN, lr)
    w_fused, ok_fused = step_disagreement(fused, got_s, TOL_PARTSEG_STEP, lr)
    emit("seg_first_step", params=n_params, loss=got["loss"],
         plain_loss=ref_plain["loss"], s_loss=got_s["loss"],
         s_fused_loss=fused["loss"],
         logits_absmax=float(ref_plain["logits"].abs().max()),
         against_plain_versions_on_the_card=w_plain,
         s_fused_against_unfused=w_fused, launches=per_step, expected=want,
         s_launches=s_step, s_expected=want_s, s_fused_launches=fused_step,
         s_fused_expected=want_fused,
         fused_stages=[list(c[0].shape[:2]) + [c[1].shape[1],
                                               c[2].shape[2], c[3].shape[1],
                                               c[6].shape[1]]
                       for c in captured_train],
         seconds={"data": data_s, "first_step": first_s,
                  "plain_step": plain_s},
         tolerance={"against_plain_versions_on_the_card": TOL_STEP_PLAIN,
                    "s_fused_against_unfused": TOL_PARTSEG_STEP})
    if per_step != want or s_step != want_s or fused_step != want_fused:
        raise AssertionError(f"launches in one seg train step {per_step} != "
                             f"{want}, S {s_step} != {want_s}, fused "
                             f"{fused_step} != {want_fused}")
    if not (ok_plain and ok_fused and np.isfinite(got["loss"])):
        raise AssertionError(f"the first seg train step disagrees: with the "
                             f"plain versions {w_plain}, S fused with "
                             f"unfused {w_fused}")
    if len(captured_train) != 1:
        raise AssertionError(f"{len(captured_train)} fused train stages")
    del got, ref_plain, got_s, fused

    # two more steps, then the eval forwards and validate over a padded
    # last batch
    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    losses = []
    for b_ in batches[1:]:
        state, loss, _ = train_step(state, b_, lr, generator=dev_gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"seg train steps: loss {losses}")
    eval_batch = seg_batch(val[0], DEV, cfg)
    model.eval()
    model_s.eval()
    eval_counts, captured_eval = {}, []
    with torch.no_grad():
        before = ops.launch_counts()
        logits = model(eval_batch["pos"], eval_batch["x"]).double()
        eval_counts["b"] = {k: v - before[k] for k, v in
                            ops.launch_counts().items() if v - before[k]}
        with plain_ops():
            plain = model(eval_batch["pos"], eval_batch["x"]).double()
        s_logits = {}
        for fused_eval in (False, True):
            before = ops.launch_counts()
            with (captured_sa_eval(captured_eval) if fused_eval
                  else contextlib.nullcontext()):
                s_logits[fused_eval] = model_s(
                    eval_batch["pos"], eval_batch["x"],
                    fused_eval=fused_eval).double()
            eval_counts[f"s_{'fused' if fused_eval else 'unfused'}"] = {
                k: v - before[k] for k, v in ops.launch_counts().items()
                if v - before[k]}
    e_plain = float((logits - plain).abs().max())
    unf, fus = s_logits[False], s_logits[True]
    scaled = float(((fus - unf).abs() / (1.0 + unf.abs())).max())
    agree = float((fus.argmax(-1) == unf.argmax(-1)).double().mean())
    want_eval = {"b": {"fps": 1, "ball_group": 9, "knn": 4,
                       "gather_rows": 8},
                 "s_unfused": {"fps": 1, "ball_group": 4, "knn": 4,
                               "gather_rows": 8},
                 "s_fused": {"fps": 1, "sa_eval": 4, "knn": 4,
                             "gather_rows": 8}}
    before = ops.launch_counts()
    perf = validate_seg(make_seg_eval_step(model), state, val, cfg)
    perf["launches"] = {k: v - before[k] for k, v in
                        ops.launch_counts().items() if v - before[k]}
    launches = ops.launch_counts()  # this path's run ends here
    emit("seg_eval", batch=SEG_B, points=N_SEG,
         b_vs_plain_max_abs=e_plain,
         s_fused_vs_unfused_max_scaled=scaled, s_argmax_share_equal=agree,
         logits_absmax=float(logits.abs().max()), launches=eval_counts,
         expected=want_eval, validate=perf, train_losses=losses,
         launches_total=launches,
         tolerance={"b_vs_plain": list(TOL_UNFUSED),
                    "s_fused_vs_unfused": f"|fused - unfused| <= {TOL_SA} * "
                    f"(1 + |unfused|), argmax equal on >= "
                    f"{SEG_ARGMAX_SHARE} of the points"})
    want_val = {k: len(val) * v for k, v in want_eval["b"].items()}
    if (eval_counts != want_eval
            or not torch.allclose(logits, plain, rtol=TOL_UNFUSED[0],
                                  atol=TOL_UNFUSED[1])
            or scaled > TOL_SA or agree < SEG_ARGMAX_SHARE
            or perf["launches"] != want_val
            or not all(np.isfinite(perf[k]) and 0 <= perf[k] <= 100
                       for k in ("miou", "macc", "oa"))):
        raise AssertionError(f"seg eval: launches {eval_counts}, plain "
                             f"{e_plain}, S fused {scaled} / {agree}, "
                             f"validate {perf}")
    del logits, plain, s_logits, unf, fus

    seg_kernels(gen, first["pos"], captured_bg, captured_eval,
                captured_train, rows)
    del captured_bg, captured_eval, captured_train
    torch.cuda.empty_cache()

    # ms per train step and per eval forward: PointNeXt-B, then
    # PointNeXt-S on both routes
    readings = {}
    for name, net_cfg, net, fused_route in (
            ("b", cfg, model, False), ("s_unfused", cfg_s, model_s, False),
            ("s_fused", cfg_s, model_s, True)):
        crit, opt, _ = build_train_tools(net_cfg, net)
        step = make_seg_train_step(net, opt, crit, net_cfg,
                                   fused_train_bn=fused_route)
        st = TrainState(net, opt)
        it = [0]

        def go():
            step(st, batches[it[0] % len(batches)], lr, generator=dev_gen)
            it[0] += 1

        r_ = step_readings(go, reps=4)
        r_["clouds_per_s"] = SEG_B * 1e3 / r_["ms_per_step"]
        readings[("train", name)] = r_
        net.eval()

        def fwd():
            with torch.no_grad():
                net(eval_batch["pos"], eval_batch["x"],
                    fused_eval=fused_route)

        r_ = step_readings(fwd, reps=4)
        r_["clouds_per_s"] = SEG_B * 1e3 / r_["ms_per_step"]
        readings[("eval", name)] = r_
        del opt, st
        torch.cuda.empty_cache()
    for (what, name), r_ in readings.items():
        emit("seg_throughput", what=what, model=name, batch=SEG_B,
             points=N_SEG, reading=r_)
    del model, model_s, state, optimizer
    torch.cuda.empty_cache()
    for name in SEG_BIG:
        seg_big_model(name, first, eval_batch, lr)
    return launches


def step_record(net, loss, seen) -> dict:
    """A first train step's loss, logits (``seen``, a forward hook's), and
    the net's gradients, parameters and buffers after it, float64 on the
    host, for ``step_disagreement``."""
    return {"loss": float(loss),
            "logits": seen["logits"].double().cpu(),
            "grads": {k: p.grad.double().cpu()
                      for k, p in net.named_parameters()},
            "params": {k: p.detach().double().cpu()
                       for k, p in net.named_parameters()},
            "buffers": {k: b_.double().cpu()
                        for k, b_ in net.named_buffers()}}


def head_dropout_masks(model) -> list:
    """Seeded keep-masks (B rows) for the ClsHead's dropout layers."""
    import torch
    from adaptpoint_tpu_torch.models.layers.blocks import Dropout
    head = list(model.prediction.head)
    return [(torch.rand((B, head[i - 1].conv.out_features),
                        generator=torch.Generator().manual_seed(5 + i))
             >= head[i].p).to(DEV)
            for i in range(1, len(head)) if isinstance(head[i], Dropout)]


def cls_step_of(net, cfg, batch, cols, lr, masks):
    """``(one, seen)``: ``one()`` runs one classifier train step of ``net``
    (``make_train_step``) on ``batch`` with the resampling columns ``cols``
    and the head's dropout ``masks`` and returns its loss; ``seen["logits"]``
    holds the step's logits."""
    from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                             make_train_step)
    crit, opt, _ = build_train_tools(cfg, net)
    step = make_train_step(net, opt, crit, cfg)
    st = TrainState(net, opt)
    seen = {}

    def one():
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        _, loss_, _ = step(st, batch, cols, lr, dropout_mask=masks)
        hook.remove()
        return loss_

    return one, seen


def seg_big_model(name, batch, eval_batch, lr) -> None:
    """``cfgs/s3dis/<name>`` (PointNeXt-L or -XL) at full width with seeded
    weights on the seg phase's first train batch and eval batch: one train
    step on the card against the same step through the plain versions on
    the card (TOL_STEP_PLAIN, the same dropout mask), one eval forward
    against the plain versions (TOL_UNFUSED), each with the card's peak
    memory and its CUDA-event ms."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
    from adaptpoint_tpu_torch.engine.seg_main import make_seg_train_step
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs", "s3dis", name), recursive=True)
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    model = build_model_from_cfg(cfg.model, seed=4)
    twin = build_model_from_cfg(cfg.model)
    twin.load_state_dict(model.state_dict())
    mask = (torch.rand((SEG_B, N_SEG, model.head.head[0].conv.out_channels),
                       generator=torch.Generator().manual_seed(5))
            >= 0.5).to(DEV)

    def step_of(net):
        crit, opt, _ = build_train_tools(cfg, net)
        step = make_seg_train_step(net, opt, crit, cfg)
        st = TrainState(net, opt)
        seen = {}

        def one():
            hook = net.register_forward_hook(
                lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
            _, loss_, _ = step(st, batch, lr, dropout_mask=mask)
            hook.remove()
            return loss_

        return one, seen


    one, seen = step_of(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    loss = one()
    torch.cuda.synchronize()
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v - before[k]}
    got = step_record(model, loss, seen)
    plain_one, plain_seen = step_of(twin)
    with plain_ops():
        ref = step_record(twin, plain_one(), plain_seen)
    w, ok = step_disagreement(got, ref, TOL_STEP_PLAIN, lr)
    del ref, got
    model.eval()
    twin.load_state_dict(model.state_dict())
    twin.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = model(eval_batch["pos"], eval_batch["x"]).double()
        torch.cuda.synchronize()
        peak_eval = torch.cuda.max_memory_allocated() / 1e9
        with plain_ops():
            plain = twin(eval_batch["pos"], eval_batch["x"]).double()
        e_plain = float((logits - plain).abs().max())
        close = bool(torch.allclose(logits, plain, rtol=TOL_UNFUSED[0],
                                    atol=TOL_UNFUSED[1]))
        del twin, plain
        torch.cuda.empty_cache()
        eval_ms = cuda_ms(lambda: model(eval_batch["pos"], eval_batch["x"]),
                          300.0)
    train_ms = cuda_ms(one, 300.0)
    blocks = list(cfg.model.encoder_args.blocks)
    want = {"fps": 1, "ball_group": 4 + sum(blocks) - len(blocks),
            "ball_group_bwd": 4 + sum(blocks) - len(blocks), "knn": 4,
            "gather_rows": 8, "gather_rows_bwd": 4}
    emit("seg_big_model", cfg=name,
         params=sum(p.numel() for p in model.parameters()),
         width=cfg.model.encoder_args.width, blocks=blocks,
         loss=float(loss), against_plain_versions_on_the_card=w,
         launches=launches, expected=want, eval_vs_plain_max_abs=e_plain,
         peak_memory_gb={"train_step": peak_train, "eval_forward": peak_eval},
         ms={"train_step": train_ms, "eval_forward": eval_ms},
         batch=SEG_B, points=N_SEG,
         tolerance={"train_step": TOL_STEP_PLAIN,
                    "eval_vs_plain": list(TOL_UNFUSED)})
    if not (ok and close and launches == want and np.isfinite(float(loss))):
        raise AssertionError(f"{name}: step {w}, eval {e_plain}, launches "
                             f"{launches} != {want}")
    del model
    torch.cuda.empty_cache()


# the baselines phase's cfgs (cfgs/<path>) and the kernel launches of one
# B = 32 train step (the resampling's FPS and row gather included) and of
# one eval forward of each
BASELINES = {
    "scanobjectnn/dgcnn.yaml": (
        {"fps": 1, "gather_rows": 5, "gather_rows_bwd": 3, "knn": 1,
         "knn_tiled": 3},
        {"gather_rows": 4, "knn": 1, "knn_tiled": 3}),
    "scanobjectnn/pointnet++.yaml": (
        {"fps": 2, "gather_rows": 1, "ball_group": 2, "ball_group_bwd": 1},
        {"fps": 1, "ball_group": 2}),
    "scanobjectnn/pointnet.yaml": ({"fps": 1, "gather_rows": 1}, {}),
    "scanobjectnn/pointmlp.yaml": (
        {"fps": 5, "gather_rows": 13, "gather_rows_bwd": 8, "knn": 4},
        {"fps": 4, "gather_rows": 12, "knn": 4}),
    "modelnetc/dgcnn.yaml": (
        {"fps": 1, "gather_rows": 4, "gather_rows_bwd": 2, "knn": 1,
         "knn_tiled": 2},
        {"gather_rows": 3, "knn": 1, "knn_tiled": 2})}
# DGCNN's edges (rows 14, 15) at C of its EdgeConv inputs: the cloud's 4
# channels, then block outputs
DGCNN_EDGE_C = (4, 64, 128)
# baselines_cli: SyntheticCls clouds a split for the ScanObjectNN DGCNN run
# (8 steps at B = 32) and for the ModelNet-C one, MN_C_SIZE a sweep's split
BL_CLI_SIZE, BL_MN_SIZE = 256, 128


def phase_baselines(gen, rows):
    """The corruption protocols' baseline classifiers at full width
    (BASELINES: ``cfgs/scanobjectnn/{dgcnn,pointnet++,pointnet,pointmlp}
    .yaml`` and ``cfgs/modelnetc/dgcnn.yaml``), seeded weights, on one
    seeded (32, 2048) blob batch resampled to 1024 points: for each, one
    train step through ``make_train_step`` on the card against the same step
    through the plain versions on the card (the resampling columns and
    dropout masks shared, DGCNN's kNN graphs too: the card's run records them
    and the plain run takes them, and notes call by call the share of rows
    whose own neighbours agree), one eval forward the same way, the launches
    of each against BASELINES, and ms, busy ms, idle share and peak memory
    of each (``step_readings``). Then rows 14 and 15 at DGCNN's edge shapes
    (the step's xyz graph, C = DGCNN_EDGE_C). Returns the kernel launches of
    the path's steps and forwards."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.models.backbone.dgcnn import (DGCNN, GraphTape,
                                                            graph_tape)
    from adaptpoint_tpu_torch.utils import EasyConfig

    class Agreeing(GraphTape):
        """Replays ``graphs``; notes, call by call, the share of rows whose
        own neighbours (from this run's features) equal the replayed ones as
        sets."""

        def __init__(self, graphs):
            super().__init__(graphs)
            self.agree = []

        def take(self, compute):
            shared = super().take(compute)
            own = compute()
            self.agree.append(float((own.sort(-1).values
                                     == shared.sort(-1).values).all(-1)
                                    .double().mean()))
            return shared

    def tape_on(net, tape):
        for m in net.modules():
            if isinstance(m, DGCNN):
                m.tape = tape

    batch_np = blob_batches(np.random.default_rng(11), 1, B, N_TRAIN)[0]
    batch = {"x": torch.from_numpy(batch_np["x"]).to(DEV),
             "y": torch.from_numpy(batch_np["y"]).to(DEV)}
    cols = torch.randperm(N_FPS, generator=torch.Generator().manual_seed(
        12))[:N0].to(DEV)
    total = dict.fromkeys(ops.KERNEL_MODULES, 0)
    xyz_graph = None
    for name, (want_train, want_eval) in BASELINES.items():
        cfg = EasyConfig()
        cfg.load(os.path.join(ROOT, "cfgs", name), recursive=True)
        lr = float(cfg.lr)
        model = build_model_from_cfg(cfg.model, seed=4)
        twin = build_model_from_cfg(cfg.model)
        twin.load_state_dict(model.state_dict())
        masks = head_dropout_masks(model)

        def step_of(net):
            return cls_step_of(net, cfg, batch, cols, lr, masks)


        in_ch = int(cfg.model.encoder_args.in_channels)
        pts = batch["x"][:, :N0]
        pos, x = pts[..., :3].contiguous(), pts[..., :in_ch].contiguous()
        # ---- the main path: one train step, one eval forward
        one, seen = step_of(model)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with graph_tape(model) as tape:
            loss = one()
        torch.cuda.synchronize()
        launches_train = nonzero_counts(ops.launch_counts())
        model.eval()
        ops.reset_launch_counts()
        with torch.no_grad(), graph_tape(model) as etape:
            logits = model(pos, x).double()
        torch.cuda.synchronize()
        launches_eval = nonzero_counts(ops.launch_counts())
        for k, v in launches_train.items():
            total[k] += v
        for k, v in launches_eval.items():
            total[k] += v
        if name == "scanobjectnn/dgcnn.yaml":
            xyz_graph = tape.graphs[0]
        model.train()
        got = step_record(model, loss, seen)
        # ---- the same through the plain versions on the card
        plain_one, plain_seen = step_of(twin)
        shared = Agreeing(tape.graphs)
        tape_on(twin, shared)
        with plain_ops():
            ref = step_record(twin, plain_one(), plain_seen)
        w, ok = step_disagreement(got, ref, TOL_STEP_PLAIN, lr)
        del ref, got
        twin.load_state_dict(model.state_dict())
        twin.eval()
        model.eval()
        shared_eval = Agreeing(etape.graphs)
        tape_on(twin, shared_eval)
        with torch.no_grad(), plain_ops():
            plain = twin(pos, x).double()
        tape_on(twin, None)
        e_plain = float((logits - plain).abs().max())
        close = bool(torch.allclose(logits, plain, rtol=TOL_UNFUSED[0],
                                    atol=TOL_UNFUSED[1]))
        del twin, plain
        torch.cuda.empty_cache()
        # ---- times (launch counts are read above)
        model.train()
        train_r = step_readings(one, reps=5)

        def forward():
            with torch.no_grad():
                return model(pos, x)
        model.eval()
        eval_r = step_readings(forward, reps=5)
        emit("baselines", cfg=name,
             params=sum(p.numel() for p in model.parameters()),
             loss=float(loss), against_plain_versions_on_the_card=w,
             eval_vs_plain_max_abs=e_plain,
             graphs_shared=len(tape.graphs) + len(etape.graphs),
             own_graph_rows_agreeing={"train": shared.agree,
                                      "eval": shared_eval.agree},
             launches={"train_step": launches_train,
                       "eval_forward": launches_eval},
             expected={"train_step": want_train, "eval_forward": want_eval},
             train_step=train_r, eval_forward=eval_r, batch=B, points=N0,
             tolerance={"train_step": TOL_STEP_PLAIN,
                        "eval_vs_plain": list(TOL_UNFUSED)})
        if not (ok and close and np.isfinite(float(loss))
                and launches_train == want_train
                and launches_eval == want_eval):
            raise AssertionError(f"{name}: step {w}, eval {e_plain}, "
                                 f"launches {launches_train} / "
                                 f"{launches_eval}, expected {want_train} "
                                 f"/ {want_eval}")
        del model, one, seen, loss, logits
        torch.cuda.empty_cache()
    # rows 14 and 15 at DGCNN's edges: its xyz graph over C channels
    edge_rows = []
    for c in DGCNN_EDGE_C:
        f_row, b_row = check_gather(gen, f"DGCNN edges, C = {c}", N0, c,
                                    xyz_graph, dtypes=("float32",),
                                    min_total_ms=100.0)
        edge_rows.append({"forward": f_row, "backward": b_row})
    emit("baselines_edges", rows=edge_rows)
    if rows is not None:
        rows["gather_rows"]["dgcnn_shapes"] = [r["forward"]
                                               for r in edge_rows]
        rows["gather_rows_bwd"]["dgcnn_shapes"] = [r["backward"]
                                                   for r in edge_rows]
    return total


def in_process_cli(argv):
    """``adaptpoint_tpu_torch.main.main(argv)`` in this process, its stdout
    swallowed and the root logger's handlers put back after; returns its
    result and the kernel launches it made."""
    import logging
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.main import main as cli_main
    root_log = logging.getLogger()
    saved = (root_log.level, list(root_log.handlers))
    ops.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = cli_main(argv)
    finally:
        for handler in list(root_log.handlers):
            root_log.removeHandler(handler)
            handler.close()
        root_log.setLevel(saved[0])
        for handler in saved[1]:
            root_log.addHandler(handler)
    return result, nonzero_counts(ops.launch_counts())


def phase_baselines_cli():
    """The baselines through the CLI: ``python -m adaptpoint_tpu_torch.main
    --cfg cfgs/scanobjectnn/dgcnn.yaml`` in a child process on SyntheticCls
    (2048 points, 15 classes, BL_CLI_SIZE clouds a split) for one epoch,
    then, in this process, ``--cfg cfgs/modelnetc/dgcnn.yaml`` (``mode:
    modelnetc``) on SyntheticCls (40 classes) for one epoch with its
    ModelNet-C sweep over a tree of MN_C_SIZE clouds a split made here (the
    h5 read replaced where h5py is missing). Finite OAs, the sweep's 1 + 7 x
    5 splits and its mCE. Returns the launch counts of both runs."""
    import glob
    import importlib.util
    import re
    import numpy as np
    from adaptpoint_tpu_torch.datasets import modelnet
    root = os.path.join(ROOT, "build", "chip_smoke", "baselines_cli")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "adaptpoint_tpu_torch.main", "--cfg",
         "cfgs/scanobjectnn/dgcnn.yaml", "dataset.common.NAME=SyntheticCls",
         "dataset.common.num_points=2048", "dataset.common.num_classes=15",
         f"dataset.common.size={BL_CLI_SIZE}", "epochs=1", "seed=1",
         f"root_dir={root}"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    sonn_seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the CLI exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    sonn_counts = json.loads(out.stdout.strip().splitlines()[-1])[
        "launch_counts"]
    sonn_oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)", out.stdout)]

    tree = os.path.join(root, "modelnet_c")
    os.makedirs(tree, exist_ok=True)
    arrays = modelnet_c_arrays(N0, MN_C_SIZE)
    has_h5py = importlib.util.find_spec("h5py") is not None
    for split, (pts, lab) in arrays.items():
        path = os.path.join(tree, f"{split}.h5")
        if has_h5py:
            import h5py
            with h5py.File(path, "w") as f:
                f["data"], f["label"] = pts, lab[:, None]
        else:
            open(path, "wb").close()  # ModelNetC asks for the file
    read = modelnet.load_h5_cached
    if not has_h5py:
        modelnet.load_h5_cached = lambda path: arrays[
            os.path.splitext(os.path.basename(path))[0]]
    t0 = time.perf_counter()
    try:
        mn_best, mn_counts = in_process_cli([
            "--cfg", os.path.join(ROOT, "cfgs", "modelnetc", "dgcnn.yaml"),
            "dataset.common.NAME=SyntheticCls",
            f"dataset.common.num_points={N0}",
            "dataset.common.num_classes=40",
            f"dataset.common.size={BL_MN_SIZE}", "epochs=1", "seed=1",
            "val_batch_size=64", f"modelnet_c_dir={tree}",
            f"root_dir={root}"])
    finally:
        modelnet.load_h5_cached = read
    mn_seconds = time.perf_counter() - t0
    run_dir = sorted(glob.glob(os.path.join(root, "modelnetc", "*")),
                     key=os.path.getmtime)[-1]
    report = open(os.path.join(run_dir, "outcorruption.txt")).read()
    split_lines = [ln for ln in report.splitlines()
                   if ln.startswith("{'acc'")]
    agg = [ln for ln in report.splitlines() if ln.startswith("{'mCE'")]
    emit("baselines_cli", sonn_dgcnn=dict(seconds=sonn_seconds, oas=sonn_oas,
                                          launches=sonn_counts),
         modelnetc_dgcnn=dict(seconds=mn_seconds, best_val=mn_best,
                              sweep_splits=len(split_lines),
                              aggregate=agg, launches=mn_counts,
                              h5_read="h5py" if has_h5py else
                              "replaced: arrays made by chip_smoke.py"),
         run_dir=os.path.relpath(run_dir, ROOT))
    if not sonn_oas or not all(np.isfinite(v) and 0 <= v <= 100
                               for v in sonn_oas):
        raise AssertionError(f"the DGCNN CLI run's OAs: {sonn_oas}")
    # a sweep on the latest checkpoint and, where an epoch improved on OA 0,
    # one on the best, each 1 + 7 x 5 splits and an aggregate
    if not agg or len(split_lines) != (1 + 7 * 5) * len(agg) \
            or mn_best is None or not 0 <= mn_best <= 100:
        raise AssertionError(f"the ModelNet-C DGCNN run: {len(split_lines)} "
                             f"splits, aggregate {agg}, best {mn_best}")
    return {k: sonn_counts.get(k, 0) + mn_counts.get(k, 0)
            for k in set(sonn_counts) | set(mn_counts)}


# PointViT (cfgs/scanobjectnn/pointvit.yaml): the kernel launches of one
# train step (B = 32, 2048 -> 1200 -> 1024: FPS and the gather of the
# resampling, then the patch embed's FPS 1024 -> 256, the centers' and the
# neighbours' gathers and the k = 32 graph) and of one eval forward
VIT_CFG = "scanobjectnn/pointvit.yaml"
VIT_LAUNCHES = ({"fps": 2, "gather_rows": 3, "knn": 1},
                {"fps": 1, "gather_rows": 2, "knn": 1})
VIT_EVAL_B = 64
# the decoders, P3Embed, KMeansEmbed and ViTGraph at a small shape (B, N,
# width), against their plain versions: outputs (rtol, atol), gradients'
# relative 2-norm (f32; under the bf16 policy a bf16 rounding may flip)
VIT_SMALL = (4, 512, 64)
TOL_VIT_SMALL = {"out": (1e-5, 1e-5), "grad_l2": 1e-4, "grad_l2_bf16": 1e-2}
# pointvit_cli: SyntheticCls clouds a split (8 steps at B = 32)
VIT_CLI_SIZE = 256


def vit_kernel_rows(gen, pos32, pos64):
    """Rows 1, 11 and 14 at PointViT's shapes against their plain versions:
    FPS 1024 -> 256 and the k = 32 graph of the 1024 points around the 256
    centers (C = 3, the warp variant) on the step's resampled clouds (B =
    32) and the eval batch (B = 64), exact, timed beside their plain
    versions and bounds; the gathers of the centers (B, 256, 3) and of the
    neighbours' features (B, 256, 32, 4) on the step's indices
    (``check_gather``). Returns ``{kernel: [rows]}``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import fpsample as fps, knn
    out = {"fps": [], "knn": [], "gather_rows": []}
    g, k = 256, 32
    idx32 = nidx32 = None
    for pos in (pos32, pos64):
        b_, n = pos.shape[:2]
        idx = fps.furthest_point_sample_cuda(pos, g)
        ref = fps.furthest_point_sample_plain(pos, g)
        centers = ops.index_points(pos, idx).contiguous()
        nidx = knn.knn_idx_cuda(k, pos, centers)
        nref = knn.knn_idx_plain(k, pos, centers)
        torch.cuda.synchronize()
        mism = (int((idx != ref).sum()), int((nidx != nref).sum()))
        emit("kernel", name="pointvit_fps_knn", shape=[b_, n, g, 3, k],
             knn_variant=list(knn.knn_variant(k, n, 3)),
             mismatches={"fps": mism[0], "knn": mism[1]}, tolerance="exact")
        if any(mism):
            raise AssertionError(f"PointViT's FPS / kNN disagree at B={b_}:"
                                 f" {mism}")
        out["fps"].append(dict(
            shape=[b_, n, g], max_abs_err=0.0,
            ms=cuda_ms(lambda: fps.furthest_point_sample_cuda(pos, g)),
            plain_ms=cuda_ms(lambda: fps.furthest_point_sample_plain(pos, g),
                             50.0),
            **device_host(lambda: fps.furthest_point_sample_cuda(pos, g)),
            **bound_row((b_ * n * 12 + b_ * g * 4) / PEAK_BYTES,
                        (g - 1) * b_ * n * 10 / PEAK_F32)))
        row = dict(
            shape=[b_, n, g, 3, k], max_abs_err=0.0,
            variant=list(knn.knn_variant(k, n, 3)),
            ms=cuda_ms(lambda: knn.knn_idx_cuda(k, pos, centers)),
            plain_ms=cuda_ms(lambda: knn.knn_idx_plain(k, pos, centers),
                             50.0),
            **device_host(lambda: knn.knn_idx_cuda(k, pos, centers)),
            **bound_row((b_ * (n + g) * 12 + b_ * g * k * 4) / PEAK_BYTES,
                        b_ * g * n * 9 / PEAK_F32))
        # a stand-in, not a library call for the same function: other
        # arithmetic (cdist) and its own tie rule
        row["stand_in_ms"] = cuda_ms(lambda: torch.topk(
            torch.cdist(centers, pos), k, dim=-1, largest=False))
        out["knn"].append(row)
        if idx32 is None:
            idx32, nidx32 = idx, nidx
    for tag, c, ix in (("PointViT centers", 3, idx32),
                       ("PointViT neighbours' features", 4, nidx32)):
        f_row, _ = check_gather(gen, tag, pos32.shape[1], c, ix,
                                dtypes=("float32",), min_total_ms=100.0)
        out["gather_rows"].append(f_row)
    emit("pointvit_kernels", **out)
    return out


def vit_module_checks(gen) -> dict:
    """PointViTDecoder (both samplers; and under the bf16 policy, whose
    bf16 FP features take the 3-NN weighted gather, rows 12 and 13),
    PointViTPartDecoder, P3Embed, KMeansEmbed and ViTGraph (k-means
    embedding, 6 feature channels) at VIT_SMALL, seeded: one train-mode
    forward and backward on the card against the same through the plain
    versions on the card, within TOL_VIT_SMALL; the launches of each and
    their sum in the record ``pointvit_modules``, apart from the path's."""
    import copy
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.models.backbone import pointvit as pv
    from adaptpoint_tpu_torch.models.build import init_weights_
    from adaptpoint_tpu_torch.utils.precision import dtype_override
    b_, n, e = VIT_SMALL
    g = n // 16
    pos = (torch.randn((b_, n, 3), generator=gen, device=DEV) * 0.4)
    x = torch.cat([pos, pos[..., 1:2].abs()], -1).contiguous()
    x6 = torch.cat([pos, torch.randn((b_, n, 3), generator=gen, device=DEV)],
                   -1).contiguous()
    centers = pos[:, ::16].contiguous()
    tokens = torch.randn((b_, g + 1, e), generator=gen, device=DEV)
    label = torch.randint(0, 4, (b_,), generator=gen, device=DEV)
    kmeans_args = {"NAME": "kmeans", "num_groups": 32, "group_size": 16,
                   "embed_dim": 32}
    cases = [
        ("PointViTDecoder fps", None,
         lambda: pv.PointViTDecoder([4, e], global_feat="cls,max"),
         lambda m, t: [m([pos, centers], [x, t])], tokens),
        ("PointViTDecoder random", None,
         lambda: pv.PointViTDecoder([4, e], sampler="random"),
         lambda m, t: [m([pos, centers], [x, t])], tokens),
        ("PointViTDecoder fps, bf16 policy", "bf16",
         lambda: pv.PointViTDecoder([4, e]),
         lambda m, t: [m([pos, centers], [x, t])], tokens),
        ("PointViTPartDecoder", None,
         lambda: pv.PointViTPartDecoder([4, e], num_classes=4,
                                        global_feat="cls,max"),
         lambda m, t: [m([pos, centers], [x, t], label)], tokens),
        ("P3Embed", None,
         lambda: pv.P3Embed(group_size=16, embed_dim=e, radius=0.3,
                            in_channels=4),
         lambda m, t: [f for f in m(pos, t)[1][1:]], x),
        ("KMeansEmbed", None,
         lambda: pv.KMeansEmbed(32, 16, e, in_channels=4),
         lambda m, t: list(m(pos, t)), x),
        ("ViTGraph", None,
         lambda: pv.ViTGraph(in_channels=6, encoder_dim=e, depth=2,
                             num_heads=4, embed_args=kmeans_args),
         lambda m, t: list(m(pos, t)), x6)]
    total, readings = {}, []
    for i, (tag, policy, make, run, inp) in enumerate(cases):
        torch.manual_seed(100 + i)
        net = init_weights_(make(), torch.Generator().manual_seed(100 + i)
                            ).to(DEV).train()
        twin = copy.deepcopy(net)

        def once(m):
            t = inp.clone().requires_grad_()
            with dtype_override(policy):
                outs = run(m, t)
            loss = sum((o.float() * torch.cos(torch.arange(
                o.numel(), device=DEV, dtype=torch.float32).reshape(
                    o.shape))).sum() for o in outs)
            loss.backward()
            return ([o.detach().float() for o in outs],
                    {"input": t.grad.float(),
                     **{k: p.grad.float() for k, p in m.named_parameters()
                        if p.grad is not None}})

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        outs, grads = once(net)
        torch.cuda.synchronize()
        launches = nonzero_counts(ops.launch_counts())
        with plain_ops():
            ref_outs, ref_grads = once(twin)
        out_err = max(float((a - r).abs().max())
                      for a, r in zip(outs, ref_outs))
        close = all(torch.allclose(a, r, rtol=TOL_VIT_SMALL["out"][0],
                                   atol=TOL_VIT_SMALL["out"][1])
                    for a, r in zip(outs, ref_outs))
        grad_l2 = max(float((grads[k] - r).norm()
                            / max(float(r.norm()), 1e-12))
                      for k, r in ref_grads.items())
        tol_g = TOL_VIT_SMALL["grad_l2_bf16" if policy else "grad_l2"]
        # FPS but for the strided sampler; a ball query (plain) in P3Embed;
        # the bf16 FP features' weighted gather under the policy
        want = ({"gather_rows"} | ({"knn"} if tag != "P3Embed" else set())
                | ({"fps"} if "random" not in tag else set())
                | ({"fpinterp", "fpinterp_bwd"} if policy else set()))
        readings.append(dict(module=tag, launches=launches,
                             out_max_abs=out_err, grad_rel_l2=grad_l2))
        if not (close and grad_l2 <= tol_g and set(launches) >= want
                and all(bool(torch.isfinite(o).all()) for o in outs)):
            raise AssertionError(f"{tag}: outputs {out_err}, gradients "
                                 f"{grad_l2}, launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    emit("pointvit_modules", shape=list(VIT_SMALL), cases=readings,
         launches_total=total, tolerance=TOL_VIT_SMALL)


def phase_pointvit(gen, rows):
    """PointViT at the full width of ``cfgs/scanobjectnn/pointvit.yaml``
    (embed 384, depth 12, 6 heads, 256 groups of 32, ``in_channels`` 4, the
    ClsHead 512-256), seeded weights, on a seeded (32, 2048) blob batch: one
    train step through ``make_train_step`` (the 2048 -> 1200 -> 1024
    resampling, the forward, SmoothCE, AdamW, the clip at 10) on the card
    against the same step through the plain versions on the card (the
    resampling columns and the head's dropout masks shared; loss, logits,
    gradients by relative 2-norm, parameters, BatchNorm buffers, equal
    predictions), one eval forward at B = 64 the same way, the launches of
    each against VIT_LAUNCHES, ms, host enqueue, busy ms, idle share,
    launches, peak memory and top device ops of each (``step_readings``);
    rows 1, 11, 14 at its shapes (``vit_kernel_rows``); the decoders,
    P3Embed, KMeansEmbed and ViTGraph (``vit_module_checks``). Returns the
    kernel launches of the step and the forward."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.engine.cls_trainer import resample_points
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs", VIT_CFG), recursive=True)
    lr = float(cfg.lr)
    rng = np.random.default_rng(21)
    train_np = blob_batches(rng, 1, B, N_TRAIN)[0]
    eval_np = blob_batches(rng, 1, VIT_EVAL_B, N_TRAIN)[0]
    batch = {"x": torch.from_numpy(train_np["x"]).to(DEV),
             "y": torch.from_numpy(train_np["y"]).to(DEV)}
    cols = torch.randperm(N_FPS, generator=torch.Generator().manual_seed(
        22))[:N0].to(DEV)
    model = build_model_from_cfg(cfg.model, seed=4)
    twin = build_model_from_cfg(cfg.model)
    twin.load_state_dict(model.state_dict())
    masks = head_dropout_masks(model)

    def step_of(net):
        return cls_step_of(net, cfg, batch, cols, lr, masks)


    in_ch = int(cfg.model.encoder_args.in_channels)
    ev = torch.from_numpy(eval_np["x"][:, :N0]).to(DEV)
    pos_e, x_e = ev[..., :3].contiguous(), ev[..., :in_ch].contiguous()
    # ---- the main path: one train step, one eval forward
    one, seen = step_of(model)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    loss = one()
    torch.cuda.synchronize()
    launches_train = nonzero_counts(ops.launch_counts())
    model.eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model(pos_e, x_e).double()
    torch.cuda.synchronize()
    launches_eval = nonzero_counts(ops.launch_counts())
    model.train()
    got = step_record(model, loss, seen)
    # ---- the same through the plain versions on the card
    plain_one, plain_seen = step_of(twin)
    with plain_ops():
        ref = step_record(twin, plain_one(), plain_seen)
    w, ok = step_disagreement(got, ref, TOL_STEP_PLAIN, lr)
    preds_equal = bool(torch.equal(got["logits"].argmax(-1),
                                   ref["logits"].argmax(-1)))
    del ref, got
    twin.load_state_dict(model.state_dict())
    twin.eval()
    model.eval()
    with torch.no_grad(), plain_ops():
        plain = twin(pos_e, x_e).double()
    e_plain = float((logits - plain).abs().max())
    close = bool(torch.allclose(logits, plain, rtol=TOL_UNFUSED[0],
                                atol=TOL_UNFUSED[1]))
    eval_preds_equal = bool(torch.equal(logits.argmax(-1),
                                        plain.argmax(-1)))
    del twin, plain
    torch.cuda.empty_cache()
    # ---- times (launch counts are read above)
    model.train()
    train_r = step_readings(one, reps=5)

    def forward():
        with torch.no_grad():
            return model(pos_e, x_e)
    model.eval()
    eval_r = step_readings(forward, reps=5)
    emit("pointvit", cfg=VIT_CFG,
         params=sum(p.numel() for p in model.parameters()),
         loss=float(loss), against_plain_versions_on_the_card=w,
         preds_equal={"train_step": preds_equal, "eval": eval_preds_equal},
         eval_vs_plain_max_abs=e_plain,
         launches={"train_step": launches_train,
                   "eval_forward": launches_eval},
         expected={"train_step": VIT_LAUNCHES[0],
                   "eval_forward": VIT_LAUNCHES[1]},
         train_step=train_r, eval_forward=eval_r, batch=B,
         eval_batch=VIT_EVAL_B, points=N0,
         tolerance={"train_step": TOL_STEP_PLAIN,
                    "eval_vs_plain": list(TOL_UNFUSED)})
    if not (ok and close and preds_equal and eval_preds_equal
            and np.isfinite(float(loss))
            and launches_train == VIT_LAUNCHES[0]
            and launches_eval == VIT_LAUNCHES[1]):
        raise AssertionError(f"PointViT: step {w}, eval {e_plain}, preds "
                             f"{preds_equal} / {eval_preds_equal}, launches "
                             f"{launches_train} / {launches_eval}")
    del model, one, seen, loss, logits
    torch.cuda.empty_cache()
    # ---- rows 1, 11, 14 at its shapes; the other modules of pointvit.py
    pos32 = resample_points(cols, batch["x"], N0)[..., :3].contiguous()
    kernel_rows = vit_kernel_rows(gen, pos32, pos_e)
    if rows is not None:
        for name, r in kernel_rows.items():
            rows[name]["pointvit_shapes"] = r
    vit_module_checks(gen)
    total = dict(launches_train)
    for k, v in launches_eval.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_pointvit_cli():
    """PointViT through the CLI at the cfg's full width on SyntheticCls
    (2048 points, 15 classes, VIT_CLI_SIZE clouds a split): ``python -m
    adaptpoint_tpu_torch.main --cfg cfgs/scanobjectnn/pointvit.yaml`` in a
    child process for two epochs, then in this process ``mode=test`` on its
    best checkpoint (the OA its final test printed), ``mode=resume`` on its
    latest to a third epoch, ``mode: scanobjectnnc`` for one epoch (its
    sweep logged and skipped without a tree) and ``resume=True`` for one
    more. Finite OAs, the epochs each run took; returns the launch counts
    of all of them."""
    import glob
    import re
    import numpy as np
    import torch
    root = os.path.join(ROOT, "build", "chip_smoke", "pointvit_cli")
    data = ["dataset.common.NAME=SyntheticCls",
            "dataset.common.num_points=2048", "dataset.common.num_classes=15",
            f"dataset.common.size={VIT_CLI_SIZE}"]
    cfg = os.path.join("cfgs", VIT_CFG)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "adaptpoint_tpu_torch.main", "--cfg", cfg]
        + data + ["epochs=2", "seed=1", f"root_dir={root}"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    seconds = {"train": time.perf_counter() - t0}
    if out.returncode != 0:
        raise AssertionError(f"the CLI exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    counts = {"train": json.loads(out.stdout.strip().splitlines()[-1])[
        "launch_counts"]}
    run_dir = sorted(glob.glob(os.path.join(root, "scanobjectnn", "*")),
                     key=os.path.getmtime)[-1]
    ckpt = os.path.join(run_dir, "checkpoint", os.path.basename(run_dir))
    log = open(os.path.join(run_dir, "log.txt")).read()
    oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)", log)]
    common = ["--cfg", os.path.join(ROOT, cfg)] + data + ["seed=1",
                                                          f"root_dir={root}"]
    t0 = time.perf_counter()
    test_oa, counts["test"] = in_process_cli(
        common + ["mode=test", f"pretrained_path={ckpt}_ckpt_best.pth"])
    seconds["test"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed_best, counts["resume"] = in_process_cli(
        common + ["mode=resume", "epochs=3",
                  f"pretrained_path={ckpt}_ckpt_latest.pth"])
    seconds["resume"] = time.perf_counter() - t0
    resumed_epoch = torch.load(ckpt + "_ckpt_latest.pth",
                               weights_only=True)["epoch"]
    c_root = os.path.join(root, "c")
    c_common = common[:-1] + [f"root_dir={c_root}", "mode=scanobjectnnc",
                              f"scanobjectnn_c_dir={root}/no_tree"]
    t0 = time.perf_counter()
    c_best, counts["scanobjectnnc"] = in_process_cli(c_common + ["epochs=1"])
    c_dir = glob.glob(os.path.join(c_root, "scanobjectnn", "*"))[0]
    c_ckpt = os.path.join(c_dir, "checkpoint", os.path.basename(c_dir))
    c_best2, counts["scanobjectnnc_resume"] = in_process_cli(
        c_common + ["epochs=2", "resume=True",
                    f"pretrained_path={c_ckpt}_ckpt_latest.pth"])
    seconds["scanobjectnnc"] = time.perf_counter() - t0
    c_log = open(os.path.join(c_dir, "log.txt")).read()
    c_epochs = [int(e) for e in re.findall(r"Epoch (\d+) LR", c_log)]
    emit("pointvit_cli", seconds=seconds, train_oas=oas, test_oa=test_oa,
         resumed_best=resumed_best, resumed_epoch=resumed_epoch,
         scanobjectnnc_best=[c_best, c_best2], scanobjectnnc_epochs=c_epochs,
         sweep_skipped="skipping corruption eval" in c_log,
         launches={k: nonzero_counts(v) for k, v in counts.items()},
         run_dir=os.path.relpath(run_dir, ROOT))
    if not (oas and all(np.isfinite(v) and 0 <= v <= 100 for v in oas)
            and f"{test_oa:3.2f}" == f"{oas[-1]:3.2f}"
            and resumed_epoch == 3 and c_epochs == [1, 2]
            and "skipping corruption eval" in c_log):
        raise AssertionError(f"the PointViT CLI runs: OAs {oas}, test "
                             f"{test_oa}, resumed to {resumed_epoch}, "
                             f"scanobjectnnc epochs {c_epochs}")
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def nonzero_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def write_sphere_tree(root: str, areas, rooms: int = None,
                      points: int = None, seed: int = 0) -> str:
    """A seeded S3DIS tree at ``root`` (``raw/Area_<a>_room_<j>.npy``,
    rows x, y, z, r, g, b, label): ``rooms`` (default SPHERE_ROOMS) rooms of
    surfaces an area (``scripts/surface_rooms.py``, ``points`` raw points
    each, default SPHERE_ROOM_POINTS, 4.5 m apart along x), labelled by
    height as the JAX package's sphere tests label theirs (13 classes over
    the 3 m). Returns ``root``."""
    import numpy as np
    from scripts.surface_rooms import surface_room
    rooms = SPHERE_ROOMS if rooms is None else rooms
    points = SPHERE_ROOM_POINTS if points is None else points
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(seed)
    for a in areas:
        for j in range(rooms):
            pos, rgb = surface_room(points, rng)
            label = np.clip(pos[:, 2] / 3.0 * 13, 0, 12).astype(np.float32)
            pos[:, 0] += 4.5 * j
            np.save(os.path.join(raw, f"Area_{a}_room_{j + 1}.npy"),
                    np.concatenate([pos, rgb, label[:, None]], 1))
    return root


def sphere_kernels(gen, first_pos, captured_bg, captured_eval,
                   captured_train, rows) -> None:
    """Every kernel of the sphere path against its plain version at the
    shapes the model hands it, each row's times summed over its calls under
    ``sphere_shapes`` in ``rows`` where given: FPS 16384 -> 4096 on the
    first batch's spheres (row 1, the pruned kernel; their padding copies
    included); the ball group forward and backward at the four SA stages
    of the unfused train step (rows 2, 4, ``captured_bg``); the kNN and the
    row gather and its scatter-add at the decoder's four FP levels (rows
    11, 14, 15); the fused eval SA at the four stages of the fused eval
    forward (row 3, ``captured_eval``); the four train-BN passes at the four
    stages of the fused train step (rows 16-19, ``captured_train``)."""
    from adaptpoint_tpu_torch.ops import fpsample as fps

    out, layouts = {}, {}
    b, n = first_pos.shape[:2]
    m = n // 4
    got = fps.furthest_point_sample_cuda(first_pos, m)
    mism = int((got != fps.furthest_point_sample_plain(first_pos, m)).sum())
    emit("kernel", name="fps", case="sphere", shape=[b, n, m],
         tiling=list(fps.fps_tiling(n)), mismatches=mism, tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                             f"(spheres, B={b}, {n} -> {m})")
    row = dict(ms=cuda_ms(lambda: fps.furthest_point_sample_cuda(
        first_pos, m), 100.0),
        plain_ms=cuda_ms(lambda: fps.furthest_point_sample_plain(
            first_pos, m), 50.0), max_abs_err=0,
        **device_host(lambda: fps.furthest_point_sample_cuda(first_pos, m),
                      reps=3),
        **bound_row((b * n * 12 + b * m * 4) / PEAK_BYTES,
                    (m - 1) * b * n * 10 / PEAK_F32))
    row["ns_a_step"] = row["ms"] * 1e6 / (m - 1)
    out["fps"] = row

    if len(captured_bg) != len(SPHERE_STAGES):
        raise AssertionError(f"{len(captured_bg)} ball-group calls a step")
    stages, inputs = [], []
    for r, k, xyz, qidx, feats, rel, ndp in captured_bg:
        if k != K or not (rel and ndp):
            raise AssertionError(f"a ball group at K={k} {rel} {ndp}")
        stages.append((xyz.shape[1], qidx.shape[1], feats.shape[2], 0, 0, r))
        inputs.append((xyz, qidx, feats))
        layouts[f"ball group {len(stages)}"] = check_bg_layout(
            xyz.shape[0], xyz.shape[1], qidx.shape[1], feats.shape[2], K)
    if [s_[:3] for s_ in stages] != [s_[:3] for s_ in SPHERE_STAGES]:
        raise AssertionError(f"the ball-group calls' shapes {stages}")
    out["ball_group"], _ = check_stages_forward(gen, stages, inputs, None)
    out["ball_group_bwd"] = check_stages_backward(gen, stages, inputs)
    del inputs

    out["knn"], out["gather_rows"], out["gather_rows_bwd"] = fp_level_rows(
        gen, "sphere", first_pos, got, SPHERE_LEVELS)
    out["sa_eval"] = captured_sa_eval_rows(captured_eval, "sphere", layouts)
    if [(c_[0].shape[1], c_[1].shape[1], c_[2].shape[2])
            for c_ in captured_train] != [s_[:3] for s_ in SPHERE_STAGES]:
        raise AssertionError("the fused train step's stages")
    for i, c_ in enumerate(captured_train):
        xyz, qidx, feats, w1 = c_[:4]
        layouts[f"train-BN stage {i + 1}"] = check_trainbn_layout(
            xyz.shape[0], qidx.shape[1], K, feats.shape[2], w1.shape[1],
            c_[6].shape[1], f"sphere stage {i + 1}")
    out.update(check_sa_trainbn(gen, captured_train, op_launches=False))
    emit("sphere_layouts", layouts=layouts)
    for name, r_ in out.items():
        if rows is not None:
            rows[name]["sphere_shapes"] = r_
    emit("sphere_kernels", note="the sphere path's shapes at B = 8, "
         "N = 16384: FPS 16384 -> 4096, the ball group at the four SA "
         "stages, the FP levels' kNN and gathers, the fused eval stages and "
         "the four fused train-BN stages; ms summed over calls", rows=out)


def phase_sphere(gen, rows):
    """The S3DIS sphere protocol at full width through the entry points a
    user calls (``cfgs/s3dis/pointnext-s_sphere.yaml``: PointNeXt-S,
    ``S3DISSphere``, ``MaskedCrossEntropy``, ``validate_sphere``; seeded
    weights) on a seeded area tree of rooms of surfaces
    (``write_sphere_tree``; the cfg's schedule cut to SPHERE_TRAIN_STEPS and
    SPHERE_VAL_STEPS spheres): the loaders built from the cfg, with their
    build time and the schedule's time a sphere; the first masked train
    step at B = 8, N = 16384 on the card against the same step through the
    plain versions on the card; the same step on the fused train-BN route
    (every stage passes the gate) against the unfused one from the same
    weights, batch and dropout mask; two more steps; the eval logits of
    both routes against their plain versions on the card, and the fused
    ones against the unfused; ``validate_sphere`` over a padded last
    batch, with its host time; the launches of each; then every kernel of the path at its shapes
    (``sphere_kernels``) and ms per train step and eval forward on both
    routes with the profiler's device-busy time and peak memory. Returns
    the launch counts of this path's run."""
    import tempfile
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.datasets import build_dataloader_from_cfg
    from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
    from adaptpoint_tpu_torch.engine.seg_main import (
        make_seg_train_step, make_sphere_logits_step, seg_batch,
        validate_sphere)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs", "s3dis", "pointnext-s_sphere.yaml"),
             recursive=True)
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    lr = float(cfg.lr)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="sphere_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    write_sphere_tree(tmp.name, (1, 5))
    tree_s = time.perf_counter() - t0
    common = cfg.dataset.common
    common.data_root, common.num_points = tmp.name, N_SPHERE
    common.num_steps, common.num_epochs = SPHERE_TRAIN_STEPS, 1
    cfg.dataset.val.num_steps = SPHERE_VAL_STEPS
    t0 = time.perf_counter()
    train_loader = build_dataloader_from_cfg(
        SEG_B, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="train", seed=1)
    val_loader = build_dataloader_from_cfg(
        SEG_B, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="val", seed=1)
    build_s = time.perf_counter() - t0
    ds = train_loader.dataset
    t0 = time.perf_counter()
    ds._build_schedule(1, 0)  # the same draws again, timed alone
    sphere_ms = 1e3 * (time.perf_counter() - t0) / SPHERE_TRAIN_STEPS
    t0 = time.perf_counter()
    loader_batches = list(train_loader)
    batches = [seg_batch(b_, DEV, cfg) for b_ in loader_batches]
    batch_s = time.perf_counter() - t0
    real = [int(v) for b_ in loader_batches for v in b_["mask"].sum(1)]
    emit("sphere_data", tree_seconds=tree_s, loaders_seconds=build_s,
         schedule_ms_a_sphere=sphere_ms,
         cfg_schedule_seconds_estimate=sphere_ms * 100 * 500 / 1e3,
         batches_seconds=batch_s, train_batches=len(batches),
         val_batches=len(val_loader),
         areas={"train": ds._area_names,
                "val": val_loader.dataset._area_names},
         subsampled_points=[int(p.shape[0]) for p in ds.sub_points],
         real_points_a_sphere=real,
         note="schedule: 100 x 500 spheres in the cfg, cut to "
              f"{SPHERE_TRAIN_STEPS}; its seconds estimated from the "
              "timed spheres")
    if len(batches) != 3 or any(set(b_) != {"pos", "x", "y", "mask"}
                                for b_ in batches):
        raise AssertionError(f"sphere batches: {len(batches)}")

    model = build_model_from_cfg(cfg.model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    host_gen = torch.Generator().manual_seed(2)
    mask = torch.rand((SEG_B, N_SPHERE,
                       model.head.head[0].conv.out_channels),
                      generator=host_gen) >= 0.5
    first = batches[0]

    def copy_of(net):
        twin = build_model_from_cfg(cfg.model)
        twin.load_state_dict(net.state_dict())
        return twin

    def first_step(net, fused=False, step=None, st=None):
        if step is None:
            crit, opt, _ = build_train_tools(cfg, net)
            step = make_seg_train_step(net, opt, crit, cfg,
                                       fused_train_bn=fused)
            st = TrainState(net, opt)
        seen = {}
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        _, loss_, _ = step(st, first, lr, dropout_mask=mask.to(DEV))
        hook.remove()
        return {"loss": float(loss_),
                "logits": seen["logits"].double().cpu(),
                "grads": {k: p.grad.double().cpu()
                          for k, p in net.named_parameters()},
                "params": {k: p.detach().double().cpu()
                           for k, p in net.named_parameters()},
                "buffers": {k: b_.double().cpu()
                            for k, b_ in net.named_buffers()}}

    plain_twin, fused_twin = copy_of(model), copy_of(model)
    zero = dict.fromkeys(ops.KERNEL_MODULES, 0)
    want = {**zero, "fps": 1, "ball_group": 4, "ball_group_bwd": 4,
            "knn": 4, "gather_rows": 8, "gather_rows_bwd": 4}
    want_fused = {**want, "ball_group": 0, "ball_group_bwd": 0,
                  "sa_trainbn_stats": 4, "sa_trainbn_fwd": 4,
                  "sa_trainbn_bwd_w2": 4, "sa_trainbn_bwd_x": 4}
    ops.reset_launch_counts()  # this path's run starts here
    criterion, optimizer, _ = build_train_tools(cfg, model)
    train_step = make_seg_train_step(model, optimizer, criterion, cfg)
    state = TrainState(model, optimizer)
    captured_bg = []
    t0 = time.perf_counter()
    with captured_ball_group(captured_bg):
        got = first_step(model, step=train_step, st=state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    per_step = ops.launch_counts()
    captured_train = []
    with captured_trainbn(captured_train):
        fused = first_step(fused_twin, fused=True)
    torch.cuda.synchronize()
    fused_step = {k: v - per_step[k] for k, v in ops.launch_counts().items()}
    run_counts = ops.launch_counts()
    t0 = time.perf_counter()
    with plain_ops():
        ref_plain = first_step(plain_twin)
    plain_s = time.perf_counter() - t0
    if ops.launch_counts() != run_counts:
        raise AssertionError("a plain-version step launched a kernel")
    del plain_twin, fused_twin
    w_plain, ok_plain = step_disagreement(got, ref_plain, TOL_STEP_PLAIN, lr)
    w_fused, ok_fused = step_disagreement(fused, got, TOL_PARTSEG_STEP, lr)
    emit("sphere_first_step", params=n_params, loss=got["loss"],
         plain_loss=ref_plain["loss"], fused_loss=fused["loss"],
         logits_absmax=float(ref_plain["logits"].abs().max()),
         against_plain_versions_on_the_card=w_plain,
         fused_against_unfused=w_fused, launches=per_step, expected=want,
         fused_launches=fused_step, fused_expected=want_fused,
         fused_stages=[list(c[0].shape[:2]) + [c[1].shape[1], c[2].shape[2],
                                               c[3].shape[1], c[6].shape[1]]
                       for c in captured_train],
         seconds={"first_step": first_s, "plain_step": plain_s},
         tolerance={"against_plain_versions_on_the_card": TOL_STEP_PLAIN,
                    "fused_against_unfused": TOL_PARTSEG_STEP})
    if per_step != want or fused_step != want_fused:
        raise AssertionError(f"launches in one sphere train step {per_step} "
                             f"!= {want}, fused {fused_step} != "
                             f"{want_fused}")
    if not (ok_plain and ok_fused and np.isfinite(got["loss"])):
        raise AssertionError(f"the first sphere train step disagrees: with "
                             f"the plain versions {w_plain}, fused with "
                             f"unfused {w_fused}")
    del got, ref_plain, fused

    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    losses = []
    for b_ in batches[1:]:
        state, loss, _ = train_step(state, b_, lr, generator=dev_gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"sphere train steps: loss {losses}")

    # the eval logits on both routes, then validate_sphere
    val_batches = list(val_loader)
    eval_batch = seg_batch(val_batches[0], DEV, cfg)
    unfused_logits = make_sphere_logits_step(model)
    fused_logits = make_sphere_logits_step(model, fused_eval=True)
    eval_counts, captured_eval = {}, []
    before = ops.launch_counts()
    unf = unfused_logits(state, eval_batch).double()
    eval_counts["unfused"] = {k: v - before[k] for k, v in
                              ops.launch_counts().items() if v - before[k]}
    with plain_ops():
        plain = unfused_logits(state, eval_batch).double()
    before = ops.launch_counts()
    with captured_sa_eval(captured_eval):
        fus = fused_logits(state, eval_batch).double()
    eval_counts["fused"] = {k: v - before[k] for k, v in
                            ops.launch_counts().items() if v - before[k]}
    with plain_ops():
        fus_plain = fused_logits(state, eval_batch).double()
    e_plain = float((unf - plain).abs().max())
    scaled = float(((fus - unf).abs() / (1.0 + unf.abs())).max())
    scaled_plain = float(((fus - fus_plain).abs()
                          / (1.0 + fus_plain.abs())).max())
    agree = float((fus.argmax(-1) == unf.argmax(-1)).double().mean())
    want_eval = {"unfused": {"fps": 1, "ball_group": 4, "knn": 4,
                             "gather_rows": 8},
                 "fused": {"fps": 1, "sa_eval": 4, "knn": 4,
                           "gather_rows": 8}}
    before = ops.launch_counts()
    t0 = time.perf_counter()
    perf = validate_sphere(unfused_logits, state, val_loader, cfg)
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    perf["launches"] = {k: v - before[k] for k, v in
                        ops.launch_counts().items() if v - before[k]}
    # the vote's host part alone: np.add.at over one batch's logits
    logits_host = unf.float().cpu().numpy()
    sums = np.zeros((val_loader.dataset.sub_points[0].shape[0], 13))
    inds = np.asarray(val_batches[0]["input_inds"])
    t0 = time.perf_counter()
    for b_ in range(SEG_B):
        np.add.at(sums, inds[b_], logits_host[b_])
    add_at_ms = 1e3 * (time.perf_counter() - t0)
    launches = ops.launch_counts()  # this path's run ends here
    emit("sphere_eval", batch=SEG_B, points=N_SPHERE,
         unfused_vs_plain_max_abs=e_plain, fused_vs_unfused_max_scaled=scaled,
         fused_vs_its_plain_versions_max_scaled=scaled_plain,
         argmax_share_equal=agree, logits_absmax=float(unf.abs().max()),
         launches=eval_counts, expected=want_eval, validate=perf,
         validate_seconds=validate_s, add_at_ms_a_batch=add_at_ms,
         val_real_rows=[int(b_["n_valid"]) for b_ in val_batches],
         train_losses=losses, launches_total=launches,
         tolerance={"unfused_vs_plain": list(TOL_UNFUSED),
                    "fused_vs_unfused": f"|fused - unfused| <= {TOL_SA} * "
                    f"(1 + |unfused|), argmax equal on >= "
                    f"{SEG_ARGMAX_SHARE} of the points",
                    "fused_vs_its_plain_versions": f"<= {TOL_SA} * (1 + "
                    f"|plain|)"})
    want_val = {k: len(val_batches) * v
                for k, v in want_eval["unfused"].items()}
    if (eval_counts != want_eval
            or not torch.allclose(unf, plain, rtol=TOL_UNFUSED[0],
                                  atol=TOL_UNFUSED[1])
            or scaled > TOL_SA or agree < SEG_ARGMAX_SHARE
            or scaled_plain > TOL_SA or perf["launches"] != want_val
            or int(val_batches[-1]["n_valid"]) >= SEG_B
            or not all(np.isfinite(perf[k]) and 0 <= perf[k] <= 100
                       for k in ("miou", "macc", "oa"))):
        raise AssertionError(f"sphere eval: launches {eval_counts}, plain "
                             f"{e_plain}, fused {scaled} / {agree}, "
                             f"validate {perf}")
    del unf, plain, fus, fus_plain

    sphere_kernels(gen, first["pos"], captured_bg, captured_eval,
                   captured_train, rows)
    del captured_bg, captured_eval, captured_train
    torch.cuda.empty_cache()

    # ms per train step and per eval forward on both routes
    readings = {}
    for route, fused_route in (("unfused", False), ("fused", True)):
        crit, opt, _ = build_train_tools(cfg, model)
        step = make_seg_train_step(model, opt, crit, cfg,
                                   fused_train_bn=fused_route)
        st = TrainState(model, opt)
        it = [0]

        def go():
            step(st, batches[it[0] % len(batches)], lr, generator=dev_gen)
            it[0] += 1

        r_ = step_readings(go, reps=4)
        r_["clouds_per_s"] = SEG_B * 1e3 / r_["ms_per_step"]
        readings[("train", route)] = r_
        fwd = make_sphere_logits_step(model, fused_eval=fused_route)
        r_ = step_readings(lambda: fwd(st, eval_batch), reps=4)
        r_["clouds_per_s"] = SEG_B * 1e3 / r_["ms_per_step"]
        readings[("eval", route)] = r_
        del opt, st
        torch.cuda.empty_cache()
    for (what, route), r_ in readings.items():
        emit("sphere_throughput", what=what, route=route, batch=SEG_B,
             points=N_SPHERE, reading=r_)
    tmp.cleanup()
    return launches


def phase_seg_cli():
    """S3DIS scene segmentation through the port's CLI in child processes as
    a user starts it (``python -m adaptpoint_tpu_torch.seg --cfg
    cfgs/s3dis/pointnext-b.yaml``) at full width on ``SyntheticScene``
    crops of N_SEG points (SEG_CLI_SIZE a split, B = SEG_B): SEG_CLI_EPOCHS
    epochs with finite mIoU, mAcc and OA each; ``mode=test`` and
    ``mode=val`` on the best checkpoint, each giving exactly the best
    epoch's mIoU, mAcc and OA (``scalars.jsonl``); ``mode=resume`` on the
    latest checkpoint to one epoch more (exactly that epoch run, from the
    saved epoch and ``best_val``). Then the sphere protocol
    (``cfgs/s3dis/pointnext-s_sphere.yaml`` at full width, B = 8 spheres of
    N_SPHERE points, on a seeded tree of rooms of surfaces,
    ``write_sphere_tree``): two epochs of two steps, ``mode=test`` on the
    best checkpoint giving the best epoch's metrics, ``mode=resume`` to a
    third epoch; and ``mode=test_6fold`` on ``pointnext-b.yaml`` over six
    seeded areas, one checkpoint of seeded weights an area, each area's
    and the overall metrics logged. The three chains of children run side
    by side, each chain in order but the crops' ``mode=test`` and
    ``mode=val``, which run side by side. Returns the launch counts of the
    children."""
    import concurrent.futures
    import re
    import tempfile
    import numpy as np
    import torch
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.utils import EasyConfig

    root = os.path.join(ROOT, "build", "chip_smoke", "seg_cli")
    data = ["dataset.common.NAME=SyntheticScene",
            f"dataset.common.num_points={N_SEG}",
            f"dataset.common.size={SEG_CLI_SIZE}", f"batch_size={SEG_B}",
            f"val_batch_size={SEG_B}", "seed=1"]
    total, lock = {}, threading.Lock()

    def run(extra, cfg="cfgs/s3dis/pointnext-b.yaml", args=data, at=root):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "adaptpoint_tpu_torch.seg", "--cfg",
             cfg] + args + extra + [f"root_dir={at}"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"the CLI exited {out.returncode}:\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        counts = json.loads(out.stdout.strip().splitlines()[-1])[
            "launch_counts"]
        with lock:
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        log = out.stdout
        return dict(seconds=seconds, log=log, counts=counts,
                    epochs=[int(e) for e in re.findall(r"Epoch (\d+) LR",
                                                       log)],
                    train_seconds=[float(v) for v in re.findall(
                        r"train_seconds ([0-9.]+)", log)],
                    test=re.findall(r"test: miou ([0-9.]+) macc ([0-9.]+) "
                                    r"oa ([0-9.]+)", log))

    def b_chain():
        """PointNeXt-B on crops: train, test, val, resume."""
        first = run([f"epochs={SEG_CLI_EPOCHS}"])
        run_dir = re.findall(r"run dir: (.+)", first["log"])[0].strip()
        name = os.path.basename(run_dir)
        vals = {}
        for line in open(os.path.join(run_dir, "scalars.jsonl")):
            r_ = json.loads(line)
            vals.setdefault(r_["tag"], {})[r_["step"]] = r_["value"]
        best_epoch = max(vals["val_miou"], key=vals["val_miou"].get)
        # as the test run's log prints them
        best_metrics = tuple(f"{vals[f'val_{k}'][best_epoch]:.2f}"
                             for k in ("miou", "macc", "oa"))
        best = os.path.join(run_dir, "checkpoint", f"{name}_ckpt_best.pth")
        latest = os.path.join(run_dir, "checkpoint",
                              f"{name}_ckpt_latest.pth")
        # both only read the best checkpoint, each into a run dir of its own
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            val_job = pool.submit(run, ["mode=val",
                                        f"pretrained_path={best}"])
            tested = run(["mode=test", f"pretrained_path={best}"])
            validated = val_job.result()
        saved = torch.load(latest, map_location="cpu", weights_only=True)
        resumed = run([f"epochs={SEG_CLI_EPOCHS + 1}", "mode=resume",
                       f"pretrained_path={latest}"])
        after = torch.load(latest, map_location="cpu", weights_only=True)
        return {"first": first, "run_dir": run_dir, "vals": vals,
                "best_epoch": best_epoch, "best_metrics": best_metrics,
                "tested": tested, "validated": validated, "saved": saved,
                "resumed": resumed, "after": after}

    def sphere_chain():
        """The sphere cfg: train, test on its best checkpoint, resume."""
        sphere_root = os.path.join(root, "sphere")
        sphere = ["dataset.common.data_root=" + write_sphere_tree(
            os.path.join(tmp.name, "spheres"), (1, 5)),
            f"dataset.common.num_points={N_SPHERE}",
            f"dataset.common.num_steps={2 * SEG_B}",
            "dataset.common.num_epochs=3",
            f"dataset.val.num_steps={SEG_B}", f"batch_size={SEG_B}",
            f"val_batch_size={SEG_B}", "seed=1"]
        s_cfg = "cfgs/s3dis/pointnext-s_sphere.yaml"
        s_first = run([f"epochs={SEG_CLI_EPOCHS}"], s_cfg, sphere,
                      sphere_root)
        s_dir = re.findall(r"run dir: (.+)", s_first["log"])[0].strip()
        s_name = os.path.basename(s_dir)
        s_vals = {}
        for line in open(os.path.join(s_dir, "scalars.jsonl")):
            r_ = json.loads(line)
            s_vals.setdefault(r_["tag"], {})[r_["step"]] = r_["value"]
        s_best = max(s_vals["val_miou"], key=s_vals["val_miou"].get)
        s_metrics = tuple(f"{s_vals[f'val_{k}'][s_best]:.2f}"
                          for k in ("miou", "macc", "oa"))
        s_tested = run(["mode=test", "pretrained_path=" + os.path.join(
            s_dir, "checkpoint", f"{s_name}_ckpt_best.pth")], s_cfg, sphere,
            sphere_root)
        s_latest = os.path.join(s_dir, "checkpoint",
                                f"{s_name}_ckpt_latest.pth")
        s_resumed = run([f"epochs={SEG_CLI_EPOCHS + 1}", "mode=resume",
                         f"pretrained_path={s_latest}"], s_cfg, sphere,
                        sphere_root)
        s_after = torch.load(s_latest, map_location="cpu", weights_only=True)
        return {"s_first": s_first, "s_vals": s_vals, "s_best": s_best,
                "s_metrics": s_metrics, "s_tested": s_tested,
                "s_resumed": s_resumed, "s_after": s_after}

    def six_chain():
        """``mode=test_6fold`` over six areas, a checkpoint of seeded
        weights each."""
        six = write_sphere_tree(os.path.join(tmp.name, "six"), range(1, 7),
                                rooms=1)
        b_cfg = EasyConfig()
        b_cfg.load(os.path.join(ROOT, "cfgs", "s3dis", "pointnext-b.yaml"),
                   recursive=True)
        b_cfg.model.in_channels = b_cfg.model.encoder_args.in_channels
        for area in range(1, 7):
            torch.save({"model": build_model_from_cfg(
                b_cfg.model, device="cpu", seed=area).state_dict()},
                os.path.join(tmp.name, f"area{area}.pth"))
        folds = run(["mode=test_6fold", "pretrained_path=" + os.path.join(
            tmp.name, "area{area}.pth")], args=[
            f"dataset.common.data_root={six}", "seed=1"],
            at=os.path.join(root, "six"))
        per_area = re.findall(r"Area (\d): miou ([0-9.]+) macc ([0-9.]+) oa "
                              r"([0-9.]+)", folds["log"])
        overall = re.findall(r"6-fold overall: miou ([0-9.]+) macc "
                             r"([0-9.]+) oa ([0-9.]+)", folds["log"])
        return {"folds": folds, "per_area": per_area, "overall": overall}

    tmp = tempfile.TemporaryDirectory(prefix="sphere_cli_",
                                      dir=os.path.join(ROOT, "build"))
    # the three chains in turns would take most of this phase's time in
    # the children's start-up (~25 s each on the card's host), so they run
    # side by side, each chain's children in order
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(chain) for chain in (b_chain, sphere_chain,
                                                 six_chain)]
        results = {}
        for job in jobs:
            results.update(job.result())
    tmp.cleanup()
    (first, run_dir, vals, best_epoch, best_metrics, tested, validated, saved,
     resumed, after) = (results[k] for k in ("first", "run_dir", "vals",
                                              "best_epoch", "best_metrics",
                                              "tested", "validated", "saved",
                                              "resumed", "after"))
    (s_first, s_vals, s_best, s_metrics, s_tested, s_resumed, s_after, folds,
     per_area, overall) = (results[k] for k in (
        "s_first", "s_vals", "s_best", "s_metrics", "s_tested", "s_resumed",
        "s_after", "folds", "per_area", "overall"))
    emit("seg_cli",
         train=dict(seconds=first["seconds"], epochs=first["epochs"],
                    train_seconds=first["train_seconds"],
                    val={k: v for k, v in vals.items()},
                    launches=first["counts"]),
         best_epoch=best_epoch, best_epoch_metrics=best_metrics,
         tested=dict(seconds=tested["seconds"], metrics=tested["test"],
                     launches=tested["counts"]),
         validated=dict(seconds=validated["seconds"],
                        metrics=validated["test"],
                        launches=validated["counts"]),
         resumed=dict(seconds=resumed["seconds"], epochs=resumed["epochs"],
                      train_seconds=resumed["train_seconds"],
                      latest_epoch=int(after["epoch"]),
                      best_val=[float(saved["best_val"]),
                                float(after["best_val"])],
                      launches=resumed["counts"]),
         run_dir=os.path.relpath(run_dir, ROOT))
    mets = [vals[f"val_{k}"][e] for k in ("miou", "macc", "oa")
            for e in vals[f"val_{k}"]]
    if first["epochs"] != list(range(1, SEG_CLI_EPOCHS + 1)) or not all(
            np.isfinite(v) and 0 <= v <= 100 for v in mets):
        raise AssertionError(f"seg CLI epochs {first['epochs']}, val {vals}")
    if tested["test"] != [best_metrics] or validated["test"] != [
            best_metrics]:
        raise AssertionError(f"mode=test / val on the best checkpoint: "
                             f"{tested['test']}, {validated['test']} "
                             f"against the best epoch's {best_metrics}")
    if resumed["epochs"] != [SEG_CLI_EPOCHS + 1] or int(after["epoch"]) != \
            SEG_CLI_EPOCHS + 1 or f"at epoch {SEG_CLI_EPOCHS} " not in \
            resumed["log"] or float(after["best_val"]) < float(
            saved["best_val"]):
        raise AssertionError(f"the resumed run: epochs {resumed['epochs']}, "
                             f"checkpoint epoch {after['epoch']}")

    emit("seg_cli_sphere",
         train=dict(seconds=s_first["seconds"], epochs=s_first["epochs"],
                    train_seconds=s_first["train_seconds"], val=s_vals,
                    launches=s_first["counts"]),
         best_epoch=s_best, best_epoch_metrics=s_metrics,
         tested=dict(seconds=s_tested["seconds"], metrics=s_tested["test"],
                     launches=s_tested["counts"]),
         resumed=dict(seconds=s_resumed["seconds"],
                      epochs=s_resumed["epochs"],
                      latest_epoch=int(s_after["epoch"]),
                      launches=s_resumed["counts"]),
         test_6fold=dict(seconds=folds["seconds"], areas=per_area,
                         overall=overall, launches=folds["counts"]))
    if s_first["epochs"] != list(range(1, SEG_CLI_EPOCHS + 1)) or \
            s_tested["test"] != [s_metrics] or \
            s_resumed["epochs"] != [SEG_CLI_EPOCHS + 1] or \
            int(s_after["epoch"]) != SEG_CLI_EPOCHS + 1:
        raise AssertionError(f"the sphere CLI: epochs {s_first['epochs']}, "
                             f"test {s_tested['test']} against {s_metrics}, "
                             f"resumed {s_resumed['epochs']}")
    if [int(a[0]) for a in per_area] != list(range(1, 7)) or \
            len(overall) != 1 or not all(
            0 <= float(v) <= 100 for row in per_area + overall
            for v in row[-3:]):
        raise AssertionError(f"test_6fold: {per_area}, {overall}")
    return total


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,serve,train,train_fused,cli,adapt,"
                            "adapt_bf16,window,adapt_cli,modelnet_cli,"
                            "partseg,partseg_cli,seg,sphere,seg_cli,"
                            "baselines,baselines_cli,pointvit,pointvit_cli",
                    help="comma-separated subset of kernels,serve,train,"
                         "train_fused,cli,adapt,adapt_bf16,window,adapt_cli,"
                         "modelnet_cli,partseg,partseg_cli,seg,sphere,"
                         "seg_cli,baselines,baselines_cli,pointvit,"
                         "pointvit_cli for a "
                         "partial run, which prints no "
                         "final result (default: all); attention alone runs "
                         "the kernel phase's attention checks and times, "
                         "knn_tiled alone its tiled kNN checks and times, "
                         "modelnet_kernels alone its checks at the ModelNet "
                         "path's shapes")
    ap.add_argument("--op-launches", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.op_launches:  # the op-count child
        from adaptpoint_tpu_torch import resolve_device
        resolve_device()
        print(json.dumps({c: OP_CHECKS[c]()
                          for c in args.op_launches.split(",")}), flush=True)
        return 0
    OP_CHECKS_WANTED.update(c for c, phase in (("window", "window"),
                                               ("fps", "seg"),
                                               ("trainbn", "train_fused"),
                                               ("knn_tiled", "kernels"),
                                               ("knn_tiled", "knn_tiled"))
                            if phase in phases)
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

    phase_seconds, last = {}, [time.perf_counter()]

    def lap(phase):
        """The seconds since the previous lap: ``phase``'s time, printed as
        it ends."""
        now = time.perf_counter()
        phase_seconds[phase], last[0] = now - last[0], now
        emit("phase_seconds", of=phase, seconds=phase_seconds[phase])

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = phase_kernels(gen) if "kernels" in phases else None
    if "attention" in phases and rows is None:
        check_attention(gen, {})
    if "knn_tiled" in phases and rows is None:
        check_knn_tiled(gen, {})
    mn_rows = (phase_modelnet_kernels(gen)
               if phases & {"kernels", "modelnet_kernels"} else {})
    lap("kernels")
    by_path = {}
    if "serve" in phases:
        out_dir = os.path.join(ROOT, "build", "chip_smoke")
        models, by_path["serve"] = phase_serve(gen, out_dir)
        phase_throughput(models, gen)
        del models
        lap("serve")
    if "train" in phases:
        by_path["train"] = phase_train(gen)
        lap("train")
    if "train_fused" in phases:
        torch.cuda.empty_cache()
        by_path["train_fused"] = phase_train_fused(gen, rows)
        lap("train_fused")
    if "cli" in phases:
        torch.cuda.empty_cache()
        by_path["cli"] = phase_cli()
        lap("cli")
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
        lap("adapt")
    if "window" in phases:
        torch.cuda.empty_cache()
        by_path["window"], window_rows, _ = phase_window(gen)
        if rows is not None:
            rows.update(window_rows)
        lap("window")
    if "adapt_cli" in phases:
        torch.cuda.empty_cache()
        by_path["adapt_cli"] = phase_adapt_cli()
        lap("adapt_cli")
    if "modelnet_cli" in phases:
        torch.cuda.empty_cache()
        by_path["modelnet_cli"] = phase_modelnet_cli()
        lap("modelnet_cli")
    if "partseg" in phases:
        torch.cuda.empty_cache()
        by_path["partseg"] = phase_partseg(gen, rows)
        lap("partseg")
    if "partseg_cli" in phases:
        torch.cuda.empty_cache()
        by_path["partseg_cli"] = phase_partseg_cli()
        lap("partseg_cli")
    if "seg" in phases:
        torch.cuda.empty_cache()
        by_path["seg"] = phase_seg(gen, rows)
        lap("seg")
    if "sphere" in phases:
        torch.cuda.empty_cache()
        by_path["sphere"] = phase_sphere(gen, rows)
        lap("sphere")
    if "seg_cli" in phases:
        torch.cuda.empty_cache()
        by_path["seg_cli"] = phase_seg_cli()
        lap("seg_cli")
    if "baselines" in phases:
        torch.cuda.empty_cache()
        by_path["baselines"] = phase_baselines(gen, rows)
        lap("baselines")
    if "baselines_cli" in phases:
        torch.cuda.empty_cache()
        by_path["baselines_cli"] = phase_baselines_cli()
        lap("baselines_cli")
    if "pointvit" in phases:
        torch.cuda.empty_cache()
        by_path["pointvit"] = phase_pointvit(gen, rows)
        lap("pointvit")
    if "pointvit_cli" in phases:
        torch.cuda.empty_cache()
        by_path["pointvit_cli"] = phase_pointvit_cli()
        lap("pointvit_cli")
    emit("done", seconds=time.perf_counter() - t_start,
         phase_seconds=phase_seconds)
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
               "knn_tiled": ("knn.cu", pallas + "knn.py:107"),
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
        launches = {path: counts.get(name, 0)
                    for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptpoint_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
        if name in mn_rows:
            kernels[-1]["modelnet_shapes"] = mn_rows[name]
        for extra in ("partseg_shapes", "seg_shapes", "sphere_shapes",
                      "resample_shape", "feature_shape",
                      "gan_classifier_shapes", "gan_step_shapes", "shape",
                      "ms_forward_only", "bound_parts_ms", "composite_ms",
                      "device_ms", "host_us", "library_device_ms",
                      "library_host_us", "stages_ms", "stages_device_ms",
                      "stages_host_us", "stages_bound_ms",
                      "ms_with_d_w", "bound_ms_with_d_w", "full_n_op_ms",
                      "bound_ms_f32_cores",
                      "ns_a_step", "gan_step_shape", "stand_in_ms", "bf16",
                      "op_launches_bf16", "op_launches", "dgcnn_shapes",
                      "fresh_draws", "c11_replay", "pointvit_shapes"):
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
