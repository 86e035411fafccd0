#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build: compile ``pytorch_points_tpu_torch/csrc/*.cu`` with nvcc (into
   ``build/pytorch_points_tpu_torch/``) and print the build time, the
   card's name and power limit, and each kernel's registers and stack
   frame (where spills go) as cuobjdump reads them from the library;
2. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at every shape the main paths give it (the headline's FPS
   16384 -> 2048, ball query at P=2048, group gather and backward scatters
   included), with 75%-valid masked and tie-grid
   cases: FPS, ball query, gather, kNN, dense NN (K5, both directions in
   one pass, and K13, one direction) and the Morton-pruned
   band and NN scan (K6) with indices identical and values bitwise
   equal, K6 also against K5 on the same clouds; the scatter (K4) bitwise
   equal to its plain version run on the CPU (which sums in ascending k, as
   K4 does) and across two launches, and within the bound of two f32
   summation orders of the plain version on the card (which uses atomics),
   at the masked headline's two chamfer-backward scatters (real indices
   from its masked NN, a 4096-update row in each) too; the auction (K11)
   and its JV endgame (K12) with owners, prices and work counters (K11's
   bidder scans and sweeps a phase, K12's pops and capped stragglers a
   cloud) bitwise equal, on config 4's normal clouds, gaussian-mixture,
   tie-grid, padded (N=2000) and masked clouds, both budget ladders, B=140
   (more clouds than SMs), N' = 256, 1024 and 4096, pop caps 1 and 8, and
   q = p (K12 on built identity owners, so no straggler); at config 4 the
   counters' summary (pops a cloud, capped share, us a pop, bidder scans,
   ms per million pair evaluations), the least time of one pop on K12's
   own block (clock64 around a block argmin) and the latency bound it
   gives, and K11 on one block beside its cluster; the Morton-ring kNN (K9),
   its masked form (K10) and its stats twin at config 6's shapes, and the
   band with window centres (K7) at the masked headline's, K9 and K10 also
   against the streaming kNN (K8) at B=4 N=16384 with forced ties and
   ragged valid counts, K9 also at config 6 with k = 1, 64 and 65, and each
   ring case with its work counter (the pairs its warps scanned, equal to
   the plain version's) beside the bound's tile-level pairs; both band
   instances (K6's at the headline, K7 at the masked headline's 75% and
   ragged valid prefixes, both directions) also through the pipeline's own
   entry, which computes only the rows before each cloud's live count (-1
   past it) and, for K7, the window centres itself: bare, then with the
   kernel's (warp, sub-tile) fold counter equal to the plain version's
   emulated count, beside the reference's pairs and the issue floor at the
   reference's work, at the live rows' and at the kernel's own; every ball
   query case (K2 and the instance that emits centred coordinates, at the
   serve shapes B=16 N=2048 and B=32 N=16384, SA2's and the headline's,
   and on a 75%-valid mask with a zero-hit row whose point 0 is masked)
   with its work counter (the support points each centroid's scan tested,
   equal to the plain version's) beside the bound's pairs; the worklist NN
   on the pruned NN's own inputs (B=32 N=16384, q a shuffle of p), with
   the distances it evaluates (each candidate pair once) against the
   earlier two-launch form's twice, and on a tie grid with a random
   candidate mask; the older-layout gather at its test shape; FPS (K1)
   at each shape with the step floor on the block it runs on (clock64
   around empty steps) and the latency bound it gives (k x floor); K6's NN
   scan, which decides its own candidates, on the headline's clouds and
   the masked headline's, its candidate mask (``cand_out``) bitwise equal
   to ``_cand_mask`` and its counters (candidate tiles, tiles its warps
   visit) to the plain version's, with its bound (the (row, tile) pairs
   each row's own candidate test passes, and every row's box tests), the
   tile-level bounds the earlier scan was held to, and the time of the
   reference's candidate mask in torch ops on the card; the repairs:
   K8 at k = 16 and 17 (a register list and a heap) on the fp1 shape, at
   k = 65 and 128 (heaps, one pass), K9 and K10 at k = 100 (the wide
   list), the any-C streaming scan at config 7's feature widths C = 24 and
   96, K5 at B=4 N=5000 M=3001, and K11 with 9 phases (two chained
   launches); config 7's own shapes: K8 on its xyz graph (B=8 Nq=Ns=2048
   k=17), K3 and its K4 backward at its DenseEdgeConv groups (B=8
   K=32768, C = 24 and 96, at the xyz graph's indices), K9 at its
   repulsion (B=8 N=8192 k=5); the MSG part segmenter's grouping (the
   benchmark's part-seg cell, B=32 N=2048 on its clouds): K1 at both
   levels, K2 at its five (radius, nsample) scales to 128 neighbours, K3
   and its K4 backward at each scale (SA1 C = 3, SA2 C = 320). Kernel and
   plain times from CUDA events
   (a plain version that takes over a second: one call on the host
   clock); beside
   them each case's bound (the least time the card could take: bytes over
   3.35 TB/s or f32 operations over 67 TFLOP/s, whichever is larger) and,
   for the gather and the scatter, the time of one PyTorch call computing
   the same function (``torch.gather``, ``Tensor.index_add_``). The gather,
   scatter, kNN (K8) and dense NN (K5, K13) cases, and the library calls,
   also give their device-only time (torch.profiler, the device items of
   one call, summed; marked where the trace lost its opening spin); the
   K8 and K5 cases also their issue floor (one lane-instruction for each
   rounded operation of the distances at the card's peak issue rate, from
   its highest SM clock); K5 and K13 at B=32 N=M=16384 give their event
   time and their device-only time (reads taken until two agree, every
   read printed) beside the check that K6 equals K5; each scatter case also its
   device items per call, its longest run and the time of ``index_add_``
   under ``torch.use_deterministic_algorithms(True)``; the LayerNorm+ReLU
   pair (``csrc/layernorm.cu``, forward then backward) at the benchmark
   cells' largest shapes (C = 32, 96 and 196 among them), the forward bitwise and the backward within
   float32 rounding of its plain version (tests/test_torch_layernorm_cuda.py
   states the tolerances), with its
   forward, backward and total time beside its bound (20 bytes an element,
   8 a row), the plain version's time and torch's layer norm and ReLU with
   their autograd backward as the library call;
3. serve: a full-width PointCloudAutoencoder (random weights from a seeded
   torch.Generator) answers B=16 N=2048 requests, B=32 N=16384 requests and
   masked requests under inference_mode. Every output must be finite and
   match the same model on the plain versions (impl="torch") to 1e-5;
4. train: the same model takes steps at B=16 N=2048 with Adam at 1e-3,
   first on Chamfer alone (emd_weight=0), then on config 5 in full,
   Chamfer + 0.1 EMD at EMDLoss's pop cap 384. For each loss the first
   step's parameter grads must match the plain versions' within
   TRAIN_GRAD_TOL of each tensor's largest grad, and every loss must be
   finite;
5. headline: FPS 16384 -> 2048, ball query (r=0.2, ns=32), group and the
   Morton-pruned chamfer, forward and backward at B=32 (the JAX package's
   graded headline loss); value and grad must match the plain versions, for
   the loss and for its group term alone (which the loss weighs by 1e-6);
   then K1's, K6's and the band's shares of one traced call's device time;
6. EMD (config 4): earth_mover_distance on B=32 N=2048 standard-normal
   clouds, timed; then its excess over the Hungarian optimum (scipy) on 4
   normal and 4 gaussian-mixture pairs at pop caps 768 and 384. Every
   assignment must be a permutation with its matched distances, and every
   pop-768 element within 5% of the optimum;
7. EMD metrics: coverage_and_mmd(metric="emd") at G=R=16 N=2048, values
   finite and in range; at a small size, COV/MMD and 1-NNA equal to the
   plain versions';
8. config 6: ops.knn(x, x, 16) at B=16 N=16384 (the Morton-ring path),
   median of 10 synchronised calls, equal to the plain versions, and K9's
   share of a call's device time (torch.profiler); then the ring stats twin
   on the same clouds, its visit rate and steps per visit equal to the
   plain version's;
9. config 6m: the same kNN with 75% prefix-valid support masks (the masked
   ring path); no invalid point returned; K10's share of the device time;
10. masked headline: phase 5 on 75% prefix-valid clouds (p_mask = q_mask),
   the chamfer on the "sorted_masked" path (K7 band, then K6's scan, which
   tests its own candidates), with each direction's share of candidate
   tile pairs and of (warp, tile) pairs the scan visits (both from the
   pipeline's own band stage), and K1's, K6's and K7's shares of the device
   time;
11. fused SA front half: ``_bq_group_centered`` forward and backward at the
   serve shape (B=16 N=2048 P=512) and the headline's (B=32 N=16384
   P=2048, FPS centroids): idx and cnt equal to ``ball_query``'s, the
   coordinates bitwise equal to ``group_points`` minus the centroids, the
   grads within K4's summation-order bound of the plain versions, a
   grid-form call (P=8192, ``tp`` given) equal to the resident form; median
   of 5 calls beside the unfused ball query + group + subtract;
12. pruned NN: ``nn_both_directions_pruned`` at B=32 N=M=16384 with the
   reference's tiles, (a) q a per-cloud shuffle of p (the worklist kernel
   answers) and (b) independent clouds (too many candidate pairs: the
   dense kernel K5 answers), each equal to K5, median of 5 calls beside K5.

13. config 7: the full-width PointUpsampler(ratio=4) at B=8, 2048 -> 8192
   points (random weights from a seeded torch.Generator): served within
   1e-5 of the plain versions; trained on chamfer_distance (the sorted
   scan, K6) with Adam at 1e-3, the first step's loss and grads held to
   the plain versions', median of 10 steps; one step on ChamferLoss + 0.1
   RepulsionLoss (the ring kNN, K9) with the same gate; UniformLoss on its
   output equal to the plain versions'; DenseEdgeConv(24, 24) on a
   feature-space graph of the lifted input (K8 over 24 channels) within
   1e-5 of plain;
14. config 8: the full-width PointNet2SemSeg(13) trained at B=16 N=2048 on
   softmax cross-entropy averaged over every point, gated and timed as
   phase 13; its forward on 75%-valid masks (masked logits 0, within 1e-5
   of plain); PointNet2Classifier(40) served at B=16 N=2048 within 1e-5
   of plain.

15. config 10 (bench.py's config 10): 32 PLY clouds of 380-676 points
   written to a git-ignored directory of the checkout (the port example's
   ``make_dataset``, ``examples_torch/train_on_ply_dataset.py``), read by
   ``PlyFolderDataset`` through the native library (built with g++ here;
   the phase fails if it does not load),
   batched by ``BucketedBatcher(batch_size=4, multiple=128, max_buckets=2,
   shuffle=True, seed=0, drop_remainder=True)``, and the full-width
   ``PointCloudAutoencoder(npoint1=96, npoint2=24)`` trained on the masked
   chamfer with Adam at 1e-3 by ``utils.Trainer``. Gated: one step on a
   fixed batch, kernels against the plain versions (phase 4's gate: loss
   rtol 1e-6, grads TRAIN_GRAD_TOL); then one warm epoch (logged every step, checkpointed),
   4 epochs through ``Prefetcher(depth=2)`` timed on the host clock to one
   sync at the end (ms/step as bench.py takes it), the first and last loss
   finite and the last lower, the device's busy and idle share over two
   more traced epochs, the checkpoint restored bitwise into a fresh model,
   and ``utils.export_forward`` of the trained model saved, loaded and run
   on the card: equal to the eager forward bitwise, with the kernels'
   launch counts rising during the loaded program's call.

16. config 3s (bench.py:149-161): ``sample_and_group_sorted(x, None, 2048,
   32, 0.2)`` at B=16 N=16384 (FPS seeded on the Morton-sorted cloud, the
   ball query on the original order): all five outputs bitwise equal to
   the plain versions', the centroid sets equal to ``sample_and_group``'s
   per cloud and the neighbourhood sets equal in every ball of <= 32
   points; median of 10 beside config 3 (``sample_and_group``);
17. config 5b (bench.py:248-270): the autoencoder under the bf16 policy
   (``dtype=torch.bfloat16``) trained at B=16 N=2048 on Chamfer + 0.1 EMD
   (pop cap 384), Adam 1e-3; the first step's grads within BF16_GRAD_TOL
   of the plain versions' run with ascending sums (K4's order), the
   spread the atomic sums' order causes printed beside; the gather's bf16
   instance must launch; median of 10 steps beside phase 4's float32
   config 5;
18. remat and BatchNorm: the autoencoder with ``remat=True`` (each SA/FP
   stage checkpointed) and through ``Trainer(remat=True)`` (the whole loss),
   first-step grads within TRAIN_GRAD_TOL of ``remat=False``'s; the peak
   device memory and step time with and without remat at B=32 N=16384 on
   Chamfer alone; ``norm="batch"`` trained 10 steps, its first step's
   grads and running statistics held to the plain versions' run with
   ascending sums (a bias before a BatchNorm has a grad that cancels to
   rounding noise, which the atomic sums' order moves), its eval
   forward within 1e-5 of plain; one remat step under BatchNorm leaves the
   running statistics of one plain step, bitwise;
19. Neural Cages: ``CageDeformer(42)`` at its defaults (npoint 256/64) with
   the icosphere cage of radius 1.5, B=8 N=2048, trained on ChamferLoss +
   MeshLaplacianLoss + PointLaplacianLoss with Adam 1e-3: first step held
   to plain, losses finite, median of 10 steps;
20. DSS and geometry: ``batch_normals(x, 20)`` at B=4 N=2048 bitwise equal
   to plain; ``render_points`` at 128 x 128, EWA splats from those normals
   and isotropic splats, forward and backward to the points and normals,
   each output within RENDER_ULPS roundings of the depth (as the soft
   z-buffer magnifies them) of the same call on the CPU, and the render at
   a depth temperature 2^-10 off outside that bar; NormalLoss,
   PointEdgeLengthLoss and MeshEdgeLengthLoss equal to their plain
   versions; SmapeLoss, the two normalisations and
   ``voxel_downsample_mask`` equal to the CPU's within 1e-6.

Phase 2 also holds the gather's bf16 instance bitwise to its plain version
at the bf16 paths' shapes (SA2's group, the FP stages' gathers).

21. parallel (``parallel/``): world 1 over NCCL in this process, then 2
   ranks of this script (``--parallel-rank``) sharing cuda:0 over gloo,
   the only way one card runs the cross-rank combine. Each runs, on its
   shards: ``nndistance_sharded`` (K13) and ``nndistance_ring`` (K5) at
   B=32 N=M=16384, indices and distances bitwise equal to K5 on the whole
   clouds; ``chamfer_sharded`` forward and backward, loss and grads within
   HEAD_GRAD_TOL of the one-device chamfer's; ``sample_and_group_sharded``
   (FPS 16384 -> 2048, r=0.2, ns=32), every output bitwise equal to
   ``ops.sample_and_group``'s; ``earth_mover_distance_sharded`` forward and
   backward at config 4's shapes, a permutation with its matched
   distances, its iterations and greedy-completion steps, and (printed)
   its excess over the Hungarian optimum beside the one-device EMD's and
   the share of its assignment equal to world 1's; config 5's step with
   ``mesh`` (B=16, 8 a rank on 2 ranks), loss, averaged grads and the
   parameters after the step within TRAIN_GRAD_TOL of the one-device
   step's. Each op's ms beside its one-device counterpart's (CUDA events,
   the same number of calls on every rank), and the phase's seconds. The
   ranks' launch counts add to the main paths'.

22. the examples (``examples_torch/``): each script's ``main()`` in this
   process on the card, every file it writes under the git-ignored
   ``build/examples/`` (tempfile's directory points there for the phase):
   ``upsample_cloud`` on a seeded 2048-point PLY (config 7's full-width
   PointUpsampler(ratio=4)) and ``render_cloud`` at 256, each against the
   same script run with ``--device cpu`` (the cloud within 1e-5 of its
   scale, the uint8 pixels within 1); ``export_and_serve``,
   ``train_autoencoder`` (on a world-1 NCCL group this script starts) and
   ``deform_with_cage`` at their defaults, with their own checks (served
   against live below 1e-5, the cage fit below 1e-3) and finite losses;
   ``train_on_ply_dataset`` as the README runs it (400 steps, bf16 policy,
   per-stage remat, masked chamfer + 0.05 masked EMD, a quarter of the
   clouds held out), gated: every logged loss finite, the last below the
   first / 100, the held-out f-score@0.05 at least 0.9; its curve and
   metrics printed beside the TPU artifact's quality values
   (``examples/artifacts/convergence_v5e.json``), its ms/step with the
   card's name and power limit, its artifact at
   ``build/examples/convergence.json``; the device's busy and idle share
   of one step of the PLY run, of ``train_autoencoder`` and of
   ``export_and_serve`` (profile_path).

Phases 3-22 are the main paths. Each sets every kernel's launch count to 0
just before each of its runs and reads them just after, and fails if a
kernel of that run's path was never launched.

23. profile: one call of each main path, traced with torch.profiler after
   its untraced timing: wall ms, device busy ms and idle share per call,
   the largest device items and the port's kernels among the rest; for
   config 6 and 6m also the glue around the ring kernels (its device items
   and ms a call) and the host wall minus the device busy. It checks
   nothing; its launches are not counted.

TF32 is switched off for matmuls and cuDNN so the port computes in float32
as the JAX reference does, and bf16 matmuls reduce in float32. The script imports no JAX. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result. Its last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()
SEED = 0
SERVE_TOL = 1e-5
SLICE = dict(b=16, n=2048)  # the serving path's request shape
LARGE = dict(b=32, n=16384)
NPOINT1, NPOINT2, RADIUS1, RADIUS2, NSAMPLE = 512, 128, 0.2, 0.4, 32
HEAD = dict(b=32, n=16384, p=2048)  # the headline loss (bench.py)
TRAIN_STEPS, HEAD_CALLS = 10, 5
TRAIN_GRAD_TOL = 1e-4  # of each tensor's largest grad: scatter sum order
HEAD_GRAD_TOL = 1e-4
HEAD_GROUP_WEIGHT = 1e-6  # the group term's weight in the headline loss
SUM_ORDER_EPS = 2.0**-24  # unit roundoff of float32
PROFILE_TOP = 12
EMD4 = dict(b=32, n=2048)  # config 4 (bench.py)
EMD_CALLS, EMD_ORACLE = 10, 4  # timed calls; Hungarian elements per kind
EMD_EXCESS_BAR = 5.0  # % over the optimum, any element at pop cap 768
EMD_EPS, EMD_ITERS, EMD_PHASES = 0.005, 15, 3  # the op's defaults
EMD_HARD = (40, 25, 15)  # the ladder the hardness hint picks
CONFIG5_EMD = {"endgame_pop_cap": 384}  # EMDLoss's training point
METRIC = dict(g=16, r=16, n=2048)
PLAIN_SINGLE_MS = 1000.0  # a plain version this slow is timed in one call
CONFIG6 = dict(b=16, n=16384, k=16)  # bench.py config 6: knn(x, x, 16)
VALID_SHARE = 0.75  # config 6m's and the masked headline's prefix masks
KNN_CALLS = 10
KNN_TRACED = 3  # config 6/6m calls traced for the ring kernels' share
RING_CHECK = dict(b=4, n=16384, k=16)  # the reference's at-scale checks
RING_VALID = (16384, 12288, 12211, 9001)  # valid counts of its masked one
FUSED_CALLS = 5
GRID_FORM = dict(p=8192, tp=2048)  # a query count only the grid form takes
PRUNED = dict(b=32, n=16384)  # nn_both_directions_pruned, default tiles
PRUNED_CALLS = 5
# The bound: NVIDIA's H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
DIST_FLOPS = 8  # one squared distance: 3 subtract, 3 multiply, 2 add
# K6's candidate test of one (row, tile box): 6 subtract, 6 max, 3 + 1
# multiply, 2 add
CAND_TEST_FLOPS = 18
KNN_LIST_K = (16, 17)  # K8's last register list and first heap
KNN_WIDE_K = (65, 128)  # K8's heaps past 64 keys
RING_WIDE_K = 100  # K9/K10 past the register lists
RING_CONFIG6_K = (1, 64, 65)  # K9 at config 6: the lists' other forms
CONFIG7_C = (24, 96)  # config 7's feature-space graphs (edge1, edge2)
# config 7 (bench.py:338-361): its kNN graphs take k = 16 and self
CONFIG7 = dict(b=8, n=2048, k=17, ratio=4)
REPULSION_K = 5  # RepulsionLoss's kNN: k = 4 and self
SEMSEG = dict(b=16, n=2048, classes=13)  # config 8 (bench.py:363-384)
# the MSG part segmenter's grouping (pn2_partseg_msg, B=32, N=2048): SA1
# 512 centroids at three (radius, nsample), SA2 128 of them at two, on
# SA1's 320 channels
PARTSEG = dict(b=32, n=2048, npoint=(512, 128),
               sa1=((0.1, 32), (0.2, 64), (0.4, 128)),
               sa2=((0.4, 64), (0.8, 128)), sa2_c=320)
CLASSIFIER_CLASSES = 40
# config 10 (bench.py:412-466): dataset, batcher, model and timed epochs
CONFIG10 = dict(count=32, batch=4, multiple=128, max_buckets=2, npoint1=96,
                npoint2=24, epochs=4, depth=2, traced_epochs=2)
AUCTION_PHASES = 9  # past the 8 phases one K11 launch holds
SPLIT_KERNELS = ("gather", "gather_bf16", "scatter", "knn",
                 "nn_dense")  # device-only
SMS, LANES_PER_SM = 132, 4 * 32  # H100 SXM: 4 schedulers of 32 lanes an SM
DENSE_ODD = dict(b=4, n=5000, m=3001)  # K5 on ragged clouds
DEVICE_CALLS = 5  # calls traced for a device-only time
# config 3s (bench.py:149-161): sample_and_group_sorted(x, None, 2048, 32,
# 0.2) at B=16 N=16384, beside config 3's sample_and_group
CONFIG3S = dict(b=16, n=16384, p=2048)
SORTED_CALLS = 10
# config 5b (bench.py:248-270): config 5 under the bf16 policy. Its first
# step's grads are held to the plain versions' run with ascending sums
# (torch.use_deterministic_algorithms: index_add_ then sums each row in
# ascending k, K4's order) within one bf16 rounding of each tensor's scale,
# 2^-8; the spread that the summation order alone causes after the bf16
# rounding (the plain versions with atomic sums against ascending ones) is
# measured and printed beside it.
BF16_GRAD_TOL = 2.0**-8
REMAT = dict(b=32, n=16384)  # remat's memory point: Chamfer alone, K6
REMAT_CALLS = 3
STAT_TOL = 1e-6  # BatchNorm's running statistics, of their scale
# the Neural Cages step (examples/deform_with_cage.py; models/cage_deformer)
CAGES = dict(b=8, n=2048, subdivisions=1, radius=1.5)
DSS = dict(b=4, n=2048, k=20, image=128)
# render_points, the card against the CPU: each output within RENDER_ULPS
# roundings of the depth, as the soft z-buffer magnifies them. Its softmax
# over -depth / tau turns a relative rounding u = 2^-24 of a depth into a
# relative change u depth / tau of that splat's weight (about 2.2e-5 at
# tau = 1e-2 and depth 3.7), and the card's and the CPU's camera transforms
# round their depths apart. The bar is RENDER_ULPS u max depth / tau of
# each output's largest value; the same render at tau (1 + 2^-10) must miss
# it (RENDER_PROBE), so every run shows the gate can fail.
RENDER_ULPS = 4
RENDER_PROBE = 2.0**-10
MEASURED = {}  # numbers one phase prints beside another's

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fps": ("pytorch_points_tpu_torch/csrc/fps.cu",
            "pytorch_points_tpu/kernels/fps.py:40"),
    "ball_query": ("pytorch_points_tpu_torch/csrc/ballquery.cu",
                   "pytorch_points_tpu/kernels/ballquery.py:143"),
    "ball_query_coords": ("pytorch_points_tpu_torch/csrc/ballquery.cu",
                          "pytorch_points_tpu/kernels/ballquery.py:143 and "
                          ":41 with with_coords=True"),
    "gather": ("pytorch_points_tpu_torch/csrc/gather.cu",
               "pytorch_points_tpu/kernels/gather.py:84 and "
               "pytorch_points_tpu/kernels/gather.py:32"),
    "gather_bf16": ("pytorch_points_tpu_torch/csrc/gather.cu",
                    "pytorch_points_tpu/kernels/gather.py:84 and "
                    "pytorch_points_tpu/kernels/gather.py:32, bf16 rows"),
    "knn": ("pytorch_points_tpu_torch/csrc/knn.cu",
            "pytorch_points_tpu/kernels/topk_scan.py:71"),
    "scatter": ("pytorch_points_tpu_torch/csrc/scatter.cu",
                "pytorch_points_tpu/kernels/scatter.py:129"),
    "nn_dense": ("pytorch_points_tpu_torch/csrc/nn_dense.cu",
                 "pytorch_points_tpu/kernels/distance_tiles.py:78 and :47"),
    "nn_worklist": ("pytorch_points_tpu_torch/csrc/nn_worklist.cu",
                    "pytorch_points_tpu/kernels/distance_tiles.py:197"),
    "nn_band": ("pytorch_points_tpu_torch/csrc/nn_sorted.cu",
                "pytorch_points_tpu/kernels/nn_sorted.py:151"),
    "nn_band_dynamic": ("pytorch_points_tpu_torch/csrc/nn_sorted.cu",
                        "pytorch_points_tpu/kernels/nn_sorted.py:242"),
    "nn_resident": ("pytorch_points_tpu_torch/csrc/nn_sorted.cu",
                    "pytorch_points_tpu/kernels/nn_sorted.py:387 with "
                    "_cand_mask :316"),
    "knn_ring": ("pytorch_points_tpu_torch/csrc/knn_ring.cu",
                 "pytorch_points_tpu/kernels/topk_scan.py:268"),
    "knn_ring_masked": ("pytorch_points_tpu_torch/csrc/knn_ring.cu",
                        "pytorch_points_tpu/kernels/topk_scan.py:309"),
    "knn_ring_stats": ("pytorch_points_tpu_torch/csrc/knn_ring.cu",
                       "pytorch_points_tpu/kernels/topk_scan.py:287"),
    "auction": ("pytorch_points_tpu_torch/csrc/auction.cu",
                "pytorch_points_tpu/kernels/auction.py:45"),
    "augment": ("pytorch_points_tpu_torch/csrc/augment.cu",
                "pytorch_points_tpu/kernels/auction.py:167"),
    "layer_norm_relu": ("pytorch_points_tpu_torch/csrc/layernorm.cu",
                        "none: XLA fuses the shared MLPs' LayerNorm and "
                        "ReLU on the TPU"),
}
SERVE_KERNELS = ("fps", "ball_query", "gather", "knn")
TRAIN_KERNELS = (*SERVE_KERNELS, "scatter", "nn_dense")
EMD_KERNELS = ("auction", "augment")
HEAD_KERNELS = ("fps", "ball_query", "gather", "scatter", "nn_band",
                "nn_resident")
HEAD_MASKED_KERNELS = ("fps", "ball_query", "gather", "scatter",
                       "nn_band_dynamic", "nn_resident")
FUSED_KERNELS = ("ball_query_coords", "scatter")
CONFIG7_SERVE_KERNELS = ("knn", "gather")
CONFIG7_TRAIN_KERNELS = ("knn", "gather", "scatter", "nn_band",
                         "nn_resident")
UNIFORM_KERNELS = ("fps", "gather")
SEMSEG_KERNELS = (*SERVE_KERNELS, "scatter")
CLASSIFIER_KERNELS = ("fps", "ball_query", "gather")
CONFIG10_KERNELS = TRAIN_KERNELS
# the README's convergence run (README.md, the port's examples):
# the masked bf16 autoencoder with per-stage remat and the masked EMD
PLY_EXAMPLE_ARGS = ("--steps", "400", "--bf16", "--remat", "--emd-weight",
                    "0.05", "--val-frac", "0.25")
PLY_EXAMPLE_KERNELS = ("fps", "ball_query", "gather", "gather_bf16",
                       "scatter", "knn", "nn_dense", "auction", "augment")
PLY_FINAL_SHARE = 0.01  # gate: the last logged loss below first / 100
PLY_VAL_FSCORE = 0.9  # gate: held-out f-score@0.05 at the end
PLY_VAL_CL1_FINDING = 2.0  # held-out chamfer-L1 over the TPU artifact's
EXAMPLE_CLOUD = 2048  # upsample_cloud's input (config 7's N)
EXAMPLE_RENDER = 256  # render_cloud's image size


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn) -> float:
    """Mean device time of one call (CUDA events around a run of calls,
    after a warm-up call), with the run sized to take ~0.2 s."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, 0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cloud(rng, b, n):
    return rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module of its own name (the JAX
    examples in ``examples/`` share the file names)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(module, argv):
    """``module.main()`` with ``argv`` as its command line."""
    saved = sys.argv
    sys.argv = [module.__file__, *argv]
    try:
        return module.main()
    finally:
        sys.argv = saved


def head_pred(rng):
    """The headline's prediction cloud, [B,N,3] f32 inside (-0.97, 0.99)."""
    return (rng.uniform(-1, 1, (HEAD["b"], HEAD["n"], 3)) * 0.98
            + 0.01).astype(np.float32)


def normal(rng, b, n):
    return rng.standard_normal((b, n, 3)).astype(np.float32)


def gmm(rng, b, n, k=8, spread=0.15):
    """Gaussian-mixture (clustered) clouds, as bench.py draws them."""
    centers = rng.uniform(-1, 1, (b, k, 3))
    which = rng.integers(0, k, (b, n))
    return (centers[np.arange(b)[:, None], which]
            + spread * rng.standard_normal((b, n, 3))).astype(np.float32)


def grid64(rng, b, n):
    """The dyadic grid k/64: every distance exact in f32, many ties."""
    return (rng.integers(-64, 65, (b, n, 3)) / 64).astype(np.float32)


def equal_count_masks(rng, b, n):
    """Two [B,N] masks, 75-100% valid, with equal valid counts per cloud
    (EMD's contract) on different subsets."""
    counts = rng.integers(3 * n // 4, n + 1, b)
    return [np.stack([np.isin(np.arange(n), rng.permutation(n)[:c])
                      for c in counts]) for _ in range(2)]


def prefix_mask(torch, b, n, dev, valid=None):
    """[B,N] bool, the first ``valid[i]`` points of cloud i (default: the
    first VALID_SHARE of every cloud), as a bucketing batcher emits."""
    valid = [int(n * VALID_SHARE)] * b if valid is None else valid
    return (torch.arange(n, device=dev)[None]
            < torch.tensor(valid, device=dev)[:, None])


class Case:
    """One kernel-vs-plain check. ``fn(impl)`` runs the kernel ("cuda") or
    its plain version ("torch"); ``inputs`` are the kernel's input tensors,
    each read once in the byte bound (outputs written once); ``ops`` the
    f32 operations the work needs on these inputs, a number or a function
    of the kernel's outputs (data-dependent work); ``library`` one PyTorch
    call computing the same function, or None; ``bound`` the scatter's
    summation-order bound against the plain version on the card (None:
    bitwise equal); ``cpu`` the plain version on CPU copies of the inputs,
    which the kernel's output must equal bitwise, or None; ``work`` a
    function of the kernel's outputs giving the distance pairs the kernel
    itself computed (its work counter), printed beside the bound's, or
    None; ``note`` a function of the kernel's outputs and ms giving a line
    of the case's own figures (K1's step floor and latency bound, K6's
    counters and bounds), or None; ``issue`` the lane-instructions of the
    distance arithmetic the kernel itself issues (each distance once), whose
    floor at the card's peak issue rate is printed beside the bound, or
    None."""

    def __init__(self, name, label, fn, inputs, ops=0, library=None,
                 bound=None, cpu=None, work=None, note=None, issue=None):
        self.name, self.label, self.fn = name, label, fn
        self.inputs, self.ops, self.library, self.bound = (
            inputs, ops, library, bound)
        self.cpu, self.work, self.note = cpu, work, note
        self.issue = issue


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(byte_count, ops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the f32 operations over its peak."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.cache
def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def issue_floor_ms(ops):
    """The least time the card issues ``ops`` lane-instructions in: every
    SM's four schedulers issuing a warp-instruction each cycle at the
    highest SM clock (no FMA in these distances: each rounded operation is
    one lane-instruction)."""
    return ops / (SMS * LANES_PER_SM * max_sm_clock_hz()) * 1e3


def gather_call(torch, f, idx):
    """torch.gather computing gather_rows(f, idx)."""
    i64 = idx.long()[..., None].expand(-1, -1, f.shape[-1]).contiguous()
    return lambda: torch.gather(f, 1, i64)


def index_add_call(torch, idx, upd, n):
    """One Tensor.index_add_ computing scatter_add(idx, upd, n), batch
    rows flattened (the accumulator's values do not matter for a time)."""
    b, k, c = upd.shape
    flat = (idx.long() + torch.arange(b, device=idx.device)[:, None] * n
            ).reshape(-1)
    out = upd.new_zeros((b * n, c))
    src = upd.reshape(b * k, c).contiguous()
    return lambda: out.index_add_(0, flat, src)


WHOLE_TRACE = " [WHOLE TRACE: opening spin lost, opening call counted]"


def traced(torch, fn, calls, tries=3):
    """({device item name: (own microseconds summed, count)}, calls traced,
    marker) over ``calls`` calls of ``fn``, from a torch.profiler trace.
    The trace opens on one more call and a short spin kernel, and only the
    device items that start after the spin are counted: a trace can lose
    its first device items. When a trace loses the spin too it is taken
    again, and after ``tries`` such traces the last one is counted whole,
    its opening call included, and the marker is :data:`WHOLE_TRACE` (else
    empty), to be printed on every line that uses the trace. Nothing here
    fails a run: the profile only informs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        marks = [e.time_range.start for e in device
                 if "spin_kernel" in e.name]
        if marks:
            break
    start, counted = (max(marks), calls) if marks else (None, calls + 1)
    marker = "" if marks else WHOLE_TRACE
    items = {}
    # a record_function range (Adam's step) also shows on the device as a
    # user annotation over kernels counted on their own
    for e in device:
        if ((start is None or e.time_range.start > start)
                and not e.is_user_annotation and "spin_kernel" not in e.name):
            us, n = items.get(e.name, (0.0, 0))
            items[e.name] = (us + e.self_device_time_total, n + 1)
    return items, counted, marker


def device_ms(torch, fn, calls=DEVICE_CALLS):
    """(device ms, device items, marker) per call: the own times of the
    device items of the traced calls (:func:`traced`), summed, and their
    count, each over the calls traced, and the trace's marker."""
    items, counted, marker = traced(torch, fn, calls)
    return (sum(us for us, _ in items.values()) / 1e3 / counted,
            sum(n for _, n in items.values()) / counted, marker)


def agreed_device_ms(torch, fn, tries=4, rel=0.02):
    """(device ms, device items, marker, every read) of ``fn``: device-only
    reads (:func:`device_ms`) taken until two agree within ``rel``, the
    agreeing pair's mean. A trace can misread a call (it has lost device
    items, or read a long kernel at half its time), so one read alone does
    not decide; after ``tries`` reads with no two agreeing, the median is
    given and the marker says so."""
    reads, items, marks = [], [], []
    for _ in range(tries):
        ms, n, mark = device_ms(torch, fn)
        for j, other in enumerate(reads):
            if abs(ms - other) <= rel * max(ms, other):
                return ((ms + other) / 2, (n + items[j]) / 2,
                        mark or marks[j], reads + [ms])
        reads.append(ms)
        items.append(n)
        marks.append(mark)
    order = sorted(range(tries), key=reads.__getitem__)
    mid = order[tries // 2]
    return (reads[mid], items[mid], marks[mid] + " [NO TWO READS AGREE]",
            reads)


def longest_run(torch, idx, n):
    """The most updates any one output row of a scatter at idx [B,K]
    into n rows receives."""
    idx = idx.long()
    rows = idx + n * torch.arange(idx.shape[0], device=idx.device)[:, None]
    inside = (idx >= 0) & (idx < n)
    return int(torch.bincount(rows[inside]).max()) if inside.any() else 0


def deterministic_ms(torch, fn):
    """(event-timed ms, device-only ms, trace marker) of ``fn`` under
    ``torch.use_deterministic_algorithms(True)``, the setting restored."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        dev, _, marker = device_ms(torch, fn)
        return cuda_ms(torch, fn), dev, marker
    finally:
        torch.use_deterministic_algorithms(before)


def scatter_case(torch, label, i, u, m):
    """K4 at idx ``i`` [B,K], updates ``u`` [B,K,C] into ``m`` rows: held
    bitwise against the plain version on CPU copies, within the summation-
    order bound of the plain version on the card, timed beside one
    ``index_add_``."""
    from pytorch_points_tpu_torch.kernels import scatter

    return Case(
        "scatter", label,
        lambda impl: scatter.scatter_add(i, u, m, impl=impl),
        [i, u], u.numel(), library=index_add_call(torch, i, u, m),
        bound=scatter_bound(torch, i, u, m),
        cpu=lambda: scatter.scatter_add(i.cpu(), u.cpu(), m))


def bq_case(torch, name, label, xyz, cen, radius, mask=None,
            nsample=NSAMPLE):
    """K2 (``name`` "ball_query") or its coordinate-emitting instance
    ("ball_query_coords") at ``nsample``, with its work counter: the
    support points each centroid's scan tested, an output held equal to
    the plain version's like the others and printed beside the bound's
    pairs (each centroid to its own nsample-th hit)."""
    from pytorch_points_tpu_torch.kernels import ballquery

    fn = (ballquery.ball_query if name == "ball_query"
          else ballquery.ball_query_and_group_coords)
    # a counter each side, written in full by every call (so the timed
    # calls allocate nothing more than the main paths' calls do)
    counts = {impl: torch.full(cen.shape[:2], -1, dtype=torch.int32,
                               device=cen.device) for impl in ("cuda",
                                                               "torch")}

    def run(impl):
        return (*fn(xyz, cen, radius, nsample, mask, counts=counts[impl],
                    impl=impl), counts[impl])

    inputs = [xyz, cen] if mask is None else [xyz, cen, mask]
    return Case(name, label, run, inputs,
                bq_ops(torch, xyz, cen, radius, nsample, mask),
                work=lambda got: got[-1].sum().item())


def bq_ops(torch, xyz, cen, radius, nsample, mask=None):
    """Distance flops a ball query needs: each centre scans its support in
    index order up to its nsample-th hit (or to the end)."""
    from pytorch_points_tpu_torch.kernels import ballquery, distance_tiles

    r2 = ballquery.squared_radius(radius)
    n = xyz.shape[1]
    pairs = 0
    for bi in range(xyz.shape[0]):
        hits = distance_tiles.sqdist_rows(cen[bi], xyz[bi]) < r2
        if mask is not None:
            hits &= mask[bi][None]
        reached = (hits.cumsum(dim=1) < nsample).sum(dim=1) + 1
        pairs += reached.clamp_max(n).sum().item()
    return DIST_FLOPS * pairs


def fps_cases(torch, tag, xyz, k, mask=None):
    """K1 on ``xyz``, noting the step floor on the block the wrapper takes
    and the latency bound it gives (k steps at the floor)."""
    from pytorch_points_tpu_torch.kernels import fps

    b, n = xyz.shape[:2]
    ops = DIST_FLOPS * b * n * k
    inputs = [xyz] if mask is None else [xyz, mask]

    def note(got, ms):
        cycles, ns = fps.fps_step_floor(n)
        form = ("one block a cloud" if n <= fps.BLOCK_POINTS
                else "the streaming kernel")
        return (f"K1 on {form}; step floor {cycles!r} cycles = {ns!r} ns; "
                f"latency bound k x floor {k * ns * 1e-6!r} ms; kernel "
                f"{ms * 1e6 / k!r} ns a step")

    return [Case("fps", f"{tag} k={k}",
                 lambda impl: fps.furthest_point_sample(
                     xyz, k, mask, emit_coords=True, impl=impl),
                 inputs, ops, note=note)]


def kernel_cases(torch, rng, dev):
    """Cases at the serving path's shapes."""
    from pytorch_points_tpu_torch.kernels import (
        ballquery,
        fps,
        gather,
        topk_scan,
    )
    from pytorch_points_tpu_torch.ops import grouping

    def t(a):
        return torch.from_numpy(a).to(dev)

    cases = []
    for tag, shp in (("B16_N2048", SLICE), ("B32_N16384", LARGE)):
        b, n = shp["b"], shp["n"]
        xyz = t(cloud(rng, b, n))
        cen = fps.furthest_point_sample(xyz, NPOINT1, emit_coords=True,
                                        impl="torch")[1]
        idx, _ = ballquery.ball_query(xyz, cen, RADIUS1, NSAMPLE,
                                      impl="torch")
        flat = idx.reshape(b, -1)
        if tag == "B16_N2048":
            fp1_xyz, fp1_cen = xyz, cen
            cases.append(bq_case(torch, "ball_query_coords",
                                 f"sa1 {tag} P={NPOINT1} r={RADIUS1}", xyz,
                                 cen, RADIUS1))
        cases += fps_cases(torch, f"sa1 {tag}", xyz, NPOINT1)
        cases += [
            bq_case(torch, "ball_query", f"sa1 {tag} P={NPOINT1} r={RADIUS1}",
                    xyz, cen, RADIUS1),
            Case("gather", f"sa1 xyz {tag} K={flat.shape[1]} C=3",
                 lambda impl, x=xyz, i=flat: gather.gather_rows(
                     x, i, impl=impl),
                 [xyz, flat], library=gather_call(torch, xyz, flat)),
            Case("knn", f"fp1 {tag} Nq={n} Ns={NPOINT1} k=3",
                 lambda impl, x=xyz, c=cen: grouping.knn(x, c, 3, impl=impl),
                 [xyz, cen], DIST_FLOPS * b * n * NPOINT1,
                 issue=DIST_FLOPS * b * n * NPOINT1),
        ]
    b, n = SLICE["b"], SLICE["n"]
    xyz = t(cloud(rng, b, n))
    mask = t(rng.uniform(size=(b, n)) < 0.75)
    cen = fps.furthest_point_sample(xyz, NPOINT1, mask, emit_coords=True,
                                     impl="torch")[1]
    xyz2 = cen[:, :NPOINT1]
    cen2 = fps.furthest_point_sample(xyz2, NPOINT2, emit_coords=True,
                                      impl="torch")[1]
    idx2, _ = ballquery.ball_query(xyz2, cen2, RADIUS2, NSAMPLE, impl="torch")
    f1 = t(rng.standard_normal((b, NPOINT1, 128)).astype(np.float32))
    flat2 = idx2.reshape(b, -1)
    smask = t(rng.uniform(size=(b, NPOINT1)) < 0.75)
    # a zero-hit row (centroid 0 far away) in every cloud, whose point 0 is
    # masked out: its coordinates come from the unpoisoned point 0
    zmask, zcen = mask.clone(), cen.clone()
    zmask[:, 0], zcen[:, 0] = False, 5.0
    if (ballquery.ball_query(xyz, zcen, RADIUS1, NSAMPLE, zmask,
                             impl="torch")[1][:, 0] != 0).any():
        fail("the masked coords case has no zero-hit row")
    frng = np.random.default_rng(SEED + 15)  # tests/test_kernels.py:381
    f300 = t(frng.standard_normal((2, 300, 3)).astype(np.float32))
    i300 = t(frng.integers(0, 300, (2, 500)).astype(np.int32))
    cases += [
        bq_case(torch, "ball_query_coords", "sa1 B16_N2048 75%-valid mask, "
                "point 0 masked, zero-hit rows", xyz, zcen, RADIUS1, zmask),
        Case("gather", "older layout (gather.py:32) B2 N=300 K=500 C=3",
             lambda impl: gather.gather_rows_t(f300, i300, impl=impl),
             [f300, i300], library=gather_call(torch, f300, i300)),
        bq_case(torch, "ball_query", "sa1 B16_N2048 75%-valid mask", xyz,
                cen, RADIUS1, mask),
        bq_case(torch, "ball_query",
                f"sa2 B16 N={NPOINT1} P={NPOINT2} r={RADIUS2}", xyz2, cen2,
                RADIUS2),
        Case("gather", f"sa2 features B16 K={NPOINT2 * NSAMPLE} C=128",
             lambda impl: gather.gather_rows(f1, flat2, impl=impl),
             [f1, flat2], library=gather_call(torch, f1, flat2)),
        *fps_cases(torch, "sa1 B16_N2048 75%-valid mask", xyz, NPOINT1,
                   mask),
        *fps_cases(torch, f"sa2 B16 N={NPOINT1}", xyz2, NPOINT2),
        Case("knn", f"fp2 B16 Nq={NPOINT1} Ns={NPOINT2} k=3",
             lambda impl: grouping.knn(xyz2, cen2, 3, impl=impl),
             [xyz2, cen2], DIST_FLOPS * b * NPOINT1 * NPOINT2,
             issue=DIST_FLOPS * b * NPOINT1 * NPOINT2),
        Case("knn", "fp1 B16_N2048 75%-valid support mask",
             lambda impl: grouping.knn(xyz, cen, 3, support_mask=smask,
                                       impl=impl),
             [xyz, cen, smask], DIST_FLOPS * b * n * NPOINT1,
             issue=DIST_FLOPS * b * n * NPOINT1),
    ]
    b1, n1 = SLICE["b"], SLICE["n"]
    for k in KNN_LIST_K:  # on fp1's shape
        cases.append(Case(
            "knn", f"B16 Nq={n1} Ns={NPOINT1} k={k}",
            lambda impl, k=k, x=fp1_xyz, c=fp1_cen: topk_scan.knn(
                x, c, k, impl=impl),
            [fp1_xyz, fp1_cen], DIST_FLOPS * b1 * n1 * NPOINT1,
            issue=DIST_FLOPS * b1 * n1 * NPOINT1))
    for k in KNN_WIDE_K:  # heaps, one pass
        cases.append(Case(
            "knn", f"B16 Nq={n} Ns={NPOINT1} k={k}",
            lambda impl, k=k: topk_scan.knn(xyz, cen, k, impl=impl),
            [xyz, cen], DIST_FLOPS * b * n * NPOINT1,
            issue=DIST_FLOPS * b * n * NPOINT1))
    cb, cn, ck = CONFIG7["b"], CONFIG7["n"], CONFIG7["k"]
    crng = np.random.default_rng(SEED + 18)
    for c in CONFIG7_C:  # the any-C scan: 3 C - 1 flops a distance (the
        # kernel issues 3 C: its sum starts from 0)
        f = t(crng.standard_normal((cb, cn, c)).astype(np.float32))
        cases.append(Case(
            "knn", f"config 7 feature graph B{cb} N={cn} C={c} k={ck}",
            lambda impl, f=f: topk_scan.knn(f, f, ck, impl=impl),
            [f], (3 * c - 1) * cb * cn * cn, issue=3 * c * cb * cn * cn))
    ux = t(cloud(crng, cb, cn))  # config 7's graphs on its input's xyz
    cases.append(Case(
        "knn", f"config 7 xyz graph B{cb} Nq=Ns={cn} k={ck}",
        lambda impl: topk_scan.knn(ux, ux, ck, impl=impl), [ux],
        DIST_FLOPS * cb * cn * cn, issue=DIST_FLOPS * cb * cn * cn))
    return cases


def partseg_kernel_cases(torch, dev):
    """K1, K2, K3 and K4 at the MSG part segmenter's shapes (PARTSEG) on
    the benchmark cell's clouds: FPS at both levels, the ball query at each
    of the five scales, and each scale's group gather of its level's
    features (SA1 the normals, C = 3; SA2 SA1's 320 channels) with its
    backward scatter."""
    from portbench import gen
    from pytorch_points_tpu_torch.kernels import ballquery, fps, gather

    b, n = PARTSEG["b"], PARTSEG["n"]
    p1, p2 = PARTSEG["npoint"]
    xyz = gen.surface_clouds(b, n, dev, SEED + 50, 0)
    cen1 = fps.furthest_point_sample(xyz, p1, emit_coords=True,
                                     impl="torch")[1]
    cen2 = fps.furthest_point_sample(cen1, p2, emit_coords=True,
                                     impl="torch")[1]
    rng = np.random.default_rng(SEED + 50)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    cases = [*fps_cases(torch, f"partseg sa1 B{b} N={n}", xyz, p1),
             *fps_cases(torch, f"partseg sa2 B{b} N={p1}", cen1, p2)]
    for level, sup, cen, c in (("sa1", xyz, cen1, 3),
                               ("sa2", cen1, cen2, PARTSEG["sa2_c"])):
        m = sup.shape[1]
        f = t(rng.standard_normal((b, m, c)))
        for radius, ns in PARTSEG[level]:
            tag = (f"partseg {level} B{b} N={m} P={cen.shape[1]} "
                   f"r={radius} nsample={ns}")
            idx = ballquery.ball_query(sup, cen, radius, ns,
                                       impl="torch")[0].reshape(b, -1)
            k = idx.shape[1]
            cases += [
                bq_case(torch, "ball_query", tag, sup, cen, radius,
                        nsample=ns),
                Case("gather", f"{tag} group K={k} C={c}",
                     lambda impl, f=f, i=idx: gather.gather_rows(
                         f, i, impl=impl),
                     [f, idx], library=gather_call(torch, f, idx)),
                scatter_case(torch, f"{tag} group backward K={k} n={m} "
                             f"C={c}", idx, t(rng.standard_normal((b, k, c))),
                             m),
            ]
    return cases


def bf16_gather_cases(torch, dev):
    """K3's bf16 instance at the shapes the bf16 paths give it: SA2's group
    of SA1's bf16 features, and the FP stages' gathers of bf16 features
    (fp2 and fp1, three neighbours a point), on a serve cloud's own
    indices. Bitwise equal to the plain version; the bound counts 2 bytes
    an element."""
    from pytorch_points_tpu_torch.kernels import ballquery, fps, gather
    from pytorch_points_tpu_torch.ops import three_nn

    rng = np.random.default_rng(SEED + 30)

    def t(a):
        return torch.from_numpy(a).to(dev)

    b, n = SLICE["b"], SLICE["n"]
    xyz = t(cloud(rng, b, n))
    xyz1 = fps.furthest_point_sample(xyz, NPOINT1, emit_coords=True,
                                     impl="torch")[1]
    xyz2 = fps.furthest_point_sample(xyz1, NPOINT2, emit_coords=True,
                                     impl="torch")[1]
    idx2 = ballquery.ball_query(xyz1, xyz2, RADIUS2, NSAMPLE,
                                impl="torch")[0].reshape(b, -1)
    fp2_idx = three_nn(xyz1, xyz2, impl="torch")[1].reshape(b, -1)
    fp1_idx = three_nn(xyz, xyz1, impl="torch")[1].reshape(b, -1)
    cases = []
    for label, m, c, idx in (
            (f"sa2 bf16 features B{b} K={idx2.shape[1]} C=128", NPOINT1,
             128, idx2),
            (f"fp2 bf16 features B{b} K={fp2_idx.shape[1]} C=256", NPOINT2,
             256, fp2_idx),
            (f"fp1 bf16 features B{b} K={fp1_idx.shape[1]} C=128", NPOINT1,
             128, fp1_idx)):
        f = t(rng.standard_normal((b, m, c)).astype(np.float32)).to(
            torch.bfloat16)
        cases.append(Case(
            "gather_bf16", label,
            lambda impl, f=f, i=idx: gather.gather_rows(f, i, impl=impl),
            [f, idx], library=gather_call(torch, f, idx)))
    return cases


def scatter_bound(torch, idx, upd, n):
    """Per-element bound on two f32 summation orders of a row's k updates,
    2 k 2^-24 sum|u|: the kernel sums in ascending k, the plain version
    (index_add_) with atomics on the card. 0 for a permutation write."""
    from pytorch_points_tpu_torch.kernels import scatter

    count = scatter.scatter_add(idx, torch.ones_like(upd), n, impl="torch")
    abs_sum = scatter.scatter_add(idx, upd.abs(), n, impl="torch")
    return torch.where(count > 1, 2 * count * SUM_ORDER_EPS * abs_sum, 0.0)


def k6_cases(torch, tag, ps, qs, qid, d_ub, bare=True):
    """K6's NN scan on sorted, padded clouds with bounds ``d_ub``: the bare
    call (the main paths' form, timed first) unless ``bare`` is False, and
    the call with ``cand_out`` and ``counts``, whose mask and counters must
    equal the plain version's. The bound counts the work the output needs,
    whatever computes it: the (row, q-tile) pairs each row's own candidate
    test passes, TM distances each, and every row's test against every
    tile box. Each case notes it beside the tile-level bounds the earlier
    scan was held to (every row of a block against each of the block's
    candidate tiles: the scan alone, and with the box tests), the candidate
    tiles, the tiles the kernel's warps visit, and the time of the
    reference's candidate mask in torch ops on the card (the earlier
    scan's glue)."""
    from pytorch_points_tpu_torch.kernels import nn_sorted as ns

    b, n = ps.shape[:2]
    m = qs.shape[1]
    ni, nj = n // ns.TN, m // ns.TM
    cand = ns._cand_mask(ps, qs, d_ub, ns.FT, ns.TN, ns.TM)
    tiles = cand.sum().item()
    row_tiles = ns._cand_rows(ps, qs, d_ub, ns.TM, ns.TN, ns.TM,
                              1).sum().item()
    mask_ms = cuda_ms(torch, lambda: ns._cand_mask(ps, qs, d_ub, ns.FT,
                                                   ns.TN, ns.TM))
    tile_pairs = ns.TN * ns.TM * tiles
    row_pairs = ns.TM * row_tiles
    test_ops = CAND_TEST_FLOPS * b * n * nj
    ops = DIST_FLOPS * row_pairs + test_ops
    inputs = [ps, qs, qid, d_ub]
    io = nbytes(inputs) + 8 * b * n  # and d, id written

    def note(got, ms):
        counts = torch.zeros((b, ni, 2), dtype=torch.int32, device=ps.device)
        ns.nn_scan(ps, qs, qid, d_ub, counts=counts)
        visits = counts[..., 1].sum().item()
        pairs = visits * ns.SCAN_WARP_ROWS * ns.TM
        tile_ops = DIST_FLOPS * tile_pairs
        return (f"K6 candidate tiles {tiles} ({tiles / (b * ni * nj)!r} of "
                f"all); rows' own candidate pairs {row_pairs} "
                f"({row_pairs / tile_pairs!r} of the tile-level pairs); "
                f"warp tile visits {visits} ({pairs} pairs, "
                f"{pairs / tile_pairs!r} of the tile-level pairs, "
                f"{pairs / max(row_pairs, 1)!r} times the rows' own); bound "
                f"{bound_ms(io, ops)[0]!r} ms; tile-level bounds (the "
                f"earlier scan's): scan {bound_ms(io, tile_ops)[0]!r} ms, "
                f"with the box tests {bound_ms(io, tile_ops + test_ops)[0]!r}"
                f" ms; the candidate mask in torch ops on the card "
                f"{mask_ms!r} ms")

    def with_counters(impl):
        counts = torch.zeros((b, ni, 2), dtype=torch.int32, device=ps.device)
        cand_out = torch.zeros((b, ni, nj), dtype=torch.bool,
                               device=ps.device)
        d, i = ns.nn_scan(ps, qs, qid, d_ub, cand_out=cand_out,
                          counts=counts, impl=impl)
        if not torch.equal(cand_out, cand):
            fail(f"nn_resident [{tag}]: cand_out ({impl}) differs from "
                 "_cand_mask")
        return d, i, counts, cand_out

    cases = []
    if bare:
        cases.append(Case(
            "nn_resident", f"{tag} tn=512 tm=64",
            lambda impl: ns.nn_scan(ps, qs, qid, d_ub, impl=impl), inputs,
            ops, note=note))
    cases.append(Case(
        "nn_resident", f"{tag} with cand_out and counts", with_counters,
        inputs, ops, note=note))
    return cases


def band_cases(torch, name, tag, fn, inputs, b, n, nw, live_rows):
    """The pipeline's band entry (K6's ``_band_rows``, K7's
    ``_band_rows_masked``) at one shape: the bare call, as the pipeline
    launches it (timed first), then the call with the kernel's fold counter
    ([B, n / tb] int32), which must equal the plain version's emulated
    count. ``fn(impl, counts)``; ``nw`` window points a row; ``live_rows``
    the rows the output needs (the others are -1, uncomputed). The bound
    counts the reference's pairs on the live rows (every window point, 8
    flops each); the note gives the issue floor at the reference's work
    (every row, as the reference computes it), at the live rows' and at the
    kernel's own visited pairs (its counter x 32 rows x BAND_SUB points)."""
    from pytorch_points_tpu_torch.kernels import nn_sorted as ns

    ops = DIST_FLOPS * live_rows * nw
    everything = DIST_FLOPS * b * n * nw

    def counted(impl):
        counts = torch.zeros((b, n // ns.TB), dtype=torch.int32,
                             device=inputs[0].device)
        return fn(impl, counts), counts

    def visited(got):
        return got[1].sum().item() * ns.BAND_WARP_ROWS * ns.BAND_SUB

    def note(got, ms):
        pairs = visited(got)
        return (f"band folds {got[1].sum().item()} (warp, sub-tile): "
                f"{pairs} pairs, {pairs / (live_rows * nw)!r} of the "
                f"reference's pairs on the live rows ({live_rows} of "
                f"{b * n} rows); issue floor (8 lane-instructions a pair) "
                f"at the reference's work (every row) "
                f"{issue_floor_ms(everything)!r} ms, at the live rows' "
                f"{issue_floor_ms(ops)!r} ms, at the kernel's own pairs "
                f"{issue_floor_ms(DIST_FLOPS * pairs)!r} ms")

    return [Case(name, f"{tag} pipeline entry",
                 lambda impl: fn(impl, None), inputs, ops),
            Case(name, f"{tag} pipeline entry, fold counter", counted,
                 inputs, ops, work=visited, note=note)]


def sorted_nn_cases(torch, rng, dev):
    """K6 at the headline's shape: its band through the pipeline's entry
    and the public one, its scan; the scan also on the masked headline's
    p->q direction, from the masked pipeline's own band stage."""
    from pytorch_points_tpu_torch.kernels import nn_sorted

    hb, hn = HEAD["b"], HEAD["n"]
    hp, hq = (torch.from_numpy(cloud(rng, hb, hn)).to(dev) for _ in range(2))
    ps, _ = nn_sorted.sort_by_morton(hp)
    qs, perm_q = nn_sorted.sort_by_morton(hq)
    d_ub = nn_sorted.band_min(ps, qs, tb=nn_sorted.TB, tbq=nn_sorted.TBQ,
                              stride=nn_sorted.STRIDE, impl="torch")
    cases = band_cases(
        torch, "nn_band", f"headline B{hb} N=M={hn} tbq=128 stride=4",
        lambda impl, counts: nn_sorted._band_rows(ps, qs, hn, counts=counts,
                                                  impl=impl),
        [ps, qs[:, ::nn_sorted.STRIDE]], hb, hn, 3 * nn_sorted.TBQ, hb * hn)
    cases += [
        Case("nn_band", f"headline B{hb} N=M={hn} tbq=128 stride=4, public "
             "band_min",
             lambda impl: nn_sorted.band_min(
                 ps, qs, tb=nn_sorted.TB, tbq=nn_sorted.TBQ,
                 stride=nn_sorted.STRIDE, impl=impl),
             [ps, qs[:, ::nn_sorted.STRIDE]],
             DIST_FLOPS * hb * hn * 3 * nn_sorted.TBQ),
        *k6_cases(torch, f"headline B{hb} N=M={hn}", ps, qs, perm_q, d_ub),
    ]
    # the masked headline's p->q direction, as nndistance_indexed_masked
    # gives it to the scan (its own band stage: poisoned rows at -1)
    mps, mgs, _, m_perm, _, _, m_ub, _ = nn_sorted._masked_bounds(
        *masked_head_poisoned(torch, dev), "auto")
    cases += k6_cases(torch, f"masked headline B{hb} N=M={hn} p->q", mps,
                      mgs, nn_sorted._pad_ids(m_perm, mgs.shape[1]), m_ub,
                      bare=False)
    return cases


def training_kernel_cases(torch, rng, dev):
    """Cases of the training paths' kernels: K5 at config 5's shape; K6,
    and K1, K2 and K3 at the headline's; K4 at the backward scatters of
    both and of the masked headline's chamfer; K3 and K4 at config 7's
    DenseEdgeConv groups."""
    from pytorch_points_tpu_torch.core.masking import poison_points
    from pytorch_points_tpu_torch.kernels import (
        ballquery,
        distance_tiles,
        fps,
        gather,
        nn_sorted,
        topk_scan,
    )

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b, n = SLICE["b"], SLICE["n"]
    p, q = t(cloud(rng, b, n)), t(cloud(rng, b, n))
    pm, qm = (t(rng.uniform(size=(b, n)) < 0.75) for _ in range(2))
    pp, qp = poison_points(p, pm, 1.0), poison_points(q, qm, -1.0)
    gp, gq = (t(rng.integers(0, 8, (b, n, 3)) / 8).float() for _ in range(2))
    once = DIST_FLOPS * b * n * n  # each distance once, both directions
    cases = [
        Case("nn_dense", f"chamfer B16 N=M={n}",
             lambda impl: distance_tiles.nn_both_directions(p, q, impl=impl),
             [p, q], once, issue=once),
        Case("nn_dense", f"chamfer B16 N=M={n} 75%-valid poisoned",
             lambda impl: distance_tiles.nn_both_directions(pp, qp,
                                                            impl=impl),
             [pp, qp], once, issue=once),
        Case("nn_dense", f"chamfer B16 N=M={n} tie grid",
             lambda impl: distance_tiles.nn_both_directions(gp, gq,
                                                            impl=impl),
             [gp, gq], once, issue=once),
        Case("nn_dense", f"one direction (K13) B16 N=M={n}",
             lambda impl: distance_tiles.nn_one_direction(p, q, impl=impl),
             [p, q], once, issue=once),
    ]
    ob, on, om = DENSE_ODD["b"], DENSE_ODD["n"], DENSE_ODD["m"]
    op_, oq = t(cloud(rng, ob, on)), t(cloud(rng, ob, om))
    cases.append(Case(
        "nn_dense", f"both directions B{ob} N={on} M={om}",
        lambda impl: distance_tiles.nn_both_directions(op_, oq, impl=impl),
        [op_, oq], DIST_FLOPS * ob * on * om,
        issue=DIST_FLOPS * ob * on * om))

    hb, hn = HEAD["b"], HEAD["n"]
    cases += sorted_nn_cases(torch, rng, dev)

    xyz = t(cloud(rng, b, n))
    cen = fps.furthest_point_sample(xyz, NPOINT1, emit_coords=True,
                                    impl="torch")[1]
    idx1 = ballquery.ball_query(xyz, cen, RADIUS1, NSAMPLE,
                                impl="torch")[0].reshape(b, -1)
    xyz2 = cen[:, :NPOINT1]
    cen2 = fps.furthest_point_sample(xyz2, NPOINT2, emit_coords=True,
                                      impl="torch")[1]
    idx2 = ballquery.ball_query(xyz2, cen2, RADIUS2, NSAMPLE,
                                impl="torch")[0].reshape(b, -1)
    u1 = t(rng.standard_normal((b, idx1.shape[1], 3)).astype(np.float32))
    u2 = t(rng.standard_normal((b, idx2.shape[1], 128)).astype(np.float32))
    perm = t(np.stack([rng.permutation(hn) for _ in range(hb)]))
    idx3 = torch.cat([perm, t(rng.integers(0, hn, (hb, hn)))], 1)
    idx3, perm = idx3.to(torch.int32), perm.to(torch.int32)
    u3 = t(rng.standard_normal((hb, 2 * hn, 3)).astype(np.float32))
    u4 = t(rng.standard_normal((hb, hn, 2)).astype(np.float32))
    # the headline's own FPS, ball query, group gather and their backward
    # scatters, on a cloud drawn as phase 5 draws its prediction
    hp = t(head_pred(rng))
    hfps, hc = fps.furthest_point_sample(hp, HEAD["p"], emit_coords=True,
                                         impl="torch")
    hidx = ballquery.ball_query(hp, hc, RADIUS1, NSAMPLE,
                                impl="torch")[0].reshape(hb, -1)
    hk = hidx.shape[1]
    cases += fps_cases(torch, f"headline B{hb} N={hn}", hp, HEAD["p"])
    cases += [
        *(bq_case(torch, name,
                  f"headline B{hb} N={hn} P={HEAD['p']} r={RADIUS1}", hp, hc,
                  RADIUS1) for name in ("ball_query", "ball_query_coords")),
        Case("gather", f"headline group B{hb} K={hk} C=3",
             lambda impl: gather.gather_rows(hp, hidx, impl=impl),
             [hp, hidx], library=gather_call(torch, hp, hidx)),
    ]
    u5 = t(rng.standard_normal((hb, hk, 3)).astype(np.float32))
    u6 = t(rng.standard_normal((hb, HEAD["p"], 3)).astype(np.float32))
    for label, (i, u, m) in {
        f"group backward B16 K={idx1.shape[1]} n={n} C=3": (idx1, u1, n),
        f"sa2 features B16 K={idx2.shape[1]} n={NPOINT1} C=128":
            (idx2, u2, NPOINT1),
        f"chamfer backward B{hb} K={2 * hn} n={hn} C=3": (idx3, u3, hn),
        f"permutation write B{hb} n={hn} C=2": (perm, u4, hn),
        f"headline group backward B{hb} K={hk} n={hn} C=3": (hidx, u5, hn),
        f"headline FPS coords backward B{hb} K={HEAD['p']} n={hn} C=3":
            (hfps, u6, hn),
    }.items():
        cases.append(scatter_case(torch, label, i, u, m))
    # the masked headline's chamfer backward: its two scatters at the real
    # indices of its masked NN (every poisoned point takes one neighbour)
    _, i1, _, i2 = nn_sorted.nndistance_indexed_masked(
        *masked_head_poisoned(torch, dev), impl="cuda")
    mrng = np.random.default_rng(SEED + 17)
    for label, i in (("p->q indices, into q", i1),
                     ("q->p indices, into p", i2)):
        u = t(mrng.standard_normal((hb, hn, 3)).astype(np.float32))
        cases.append(scatter_case(
            torch, f"masked headline chamfer backward, {label}, B{hb} "
            f"K={hn} n={hn} C=3", i, u, hn))
    # config 7's DenseEdgeConv groups (C = 24 into edge1, 96 into edge2) and
    # their backward scatters, at its xyz graph's indices without self
    cb, cn, ck = CONFIG7["b"], CONFIG7["n"], CONFIG7["k"]
    crng = np.random.default_rng(SEED + 22)
    ux = t(cloud(crng, cb, cn))
    uidx = topk_scan.knn(ux, ux, ck, impl="torch")[1][..., 1:].reshape(cb, -1)
    uk = uidx.shape[1]
    for c in CONFIG7_C:
        f = t(crng.standard_normal((cb, cn, c)).astype(np.float32))
        u = t(crng.standard_normal((cb, uk, c)).astype(np.float32))
        cases += [
            Case("gather", f"config 7 group B{cb} K={uk} C={c}",
                 lambda impl, f=f: gather.gather_rows(f, uidx, impl=impl),
                 [f, uidx], library=gather_call(torch, f, uidx)),
            scatter_case(torch, f"config 7 group backward B{cb} K={uk} "
                         f"n={cn} C={c}", uidx, u, cn),
        ]
    return cases


def masked_head_inputs(torch, dev, valid=None):
    """The masked headline's inputs: (pred, gt, pm, gm), the prefix masks
    VALID_SHARE of each cloud or ``valid`` (two lists of counts)."""
    b, n = HEAD["b"], HEAD["n"]
    rng = np.random.default_rng(SEED + 10)
    pred = torch.from_numpy(head_pred(rng)).to(dev)
    gt = torch.from_numpy(cloud(rng, b, n)).to(dev)
    pm = prefix_mask(torch, b, n, dev, valid and valid[0])
    gm = prefix_mask(torch, b, n, dev, valid and valid[1])
    return pred, gt, pm, gm


def masked_head_poisoned(torch, dev):
    """The masked headline's chamfer inputs: pred and gt poisoned (+x and
    -x) past the prefix masks, as ``chamfer_distance`` hands them to
    ``nndistance_indexed_masked``."""
    from pytorch_points_tpu_torch.core.masking import poison_points

    pred, gt, pm, gm = masked_head_inputs(torch, dev)
    return poison_points(pred, pm, 1.0), poison_points(gt, gm, -1.0)


def masked_head_clouds(torch, dev, valid=None):
    """The masked headline's clouds as its chamfer sees them: pred and gt
    poisoned (+x and -x) past the prefix masks, then Morton-sorted over
    their valid AABBs. Returns (ps, gs, c1, c2, pm, gm)."""
    from pytorch_points_tpu_torch.core.masking import poison_points
    from pytorch_points_tpu_torch.kernels import nn_sorted as ns

    b, n = HEAD["b"], HEAD["n"]
    pred, gt, pm, gm = masked_head_inputs(torch, dev, valid)
    ps = ns.sort_by_morton_masked(poison_points(pred, pm, 1.0), pm)[0]
    gs = ns.sort_by_morton_masked(poison_points(gt, gm, -1.0), gm)[0]
    c1 = ns._band_centers(pm.sum(1), gm.sum(1), n // ns.TB, n // ns.TB, ns.TB)
    c2 = ns._band_centers(gm.sum(1), pm.sum(1), n // ns.TB, n // ns.TB, ns.TB)
    return ps, gs, c1, c2, pm, gm


def ring_kernel_cases(torch, dev):
    """K9, K10 and the stats twin at config 6's shapes (K9 also at k = 1,
    64 and 65: a list of 8 in registers, heaps of 64 and 72 in shared
    memory), through their wrappers on the sorted, padded clouds, each with
    its work counter, which must equal the plain version's."""
    from pytorch_points_tpu_torch.core.masking import poison_points
    from pytorch_points_tpu_torch.kernels import nn_sorted as ns
    from pytorch_points_tpu_torch.kernels import topk_scan as ts

    b, n, k = CONFIG6["b"], CONFIG6["n"], CONFIG6["k"]
    rng = np.random.default_rng(SEED + 8)
    x = torch.from_numpy(cloud(rng, b, n)).to(dev)
    xp = poison_points(x, prefix_mask(torch, b, n, dev), -1.0)
    qsp, sup4, _, _ = ts._ring_inputs(x, x, False)
    mqsp, msup4, cen, _ = ts._ring_inputs(x, xp, True)

    def visited(counters):  # distance flops of the chunks the scan visited
        return DIST_FLOPS * ts.TQ * ts.TM * counters[..., 0].sum().item()

    def ring(qs, sup, kk, centers=None, stats=False):
        """fn(impl) -> (d, idx[, counters], work counter) of one instance."""
        def fn(impl):
            counts = torch.empty((qs.shape[0], qs.shape[1] // ts.WARP),
                                 dtype=torch.int32, device=dev)
            if impl != "cuda":
                out = ts.knn_ring_torch(qs, sup, kk, centers, stats=stats,
                                        counts=counts)
            elif stats:
                out = ts.knn_ring_stats_cuda(qs, sup, kk, counts=counts)
            elif centers is not None:
                out = ts.knn_ring_masked_cuda(qs, sup, kk, centers, counts)
            else:
                out = ts.knn_ring_cuda(qs, sup, kk, counts)
            return (*out[:3 if stats else 2], counts)
        return fn

    def stats_of(qs, sup, kk, centers=None):
        """The tile-level work the bound counts: the stats instance's."""
        return lambda outs: visited(ts._launch_ring(qs, sup, kk, centers,
                                                    ts.UNROLL, True)[2])

    def work(outs):  # the pairs the kernel's warps scanned, from its counter
        return outs[-1].sum().item() * ts.WARP * ts.SUB

    tag = f"config 6 B{b} N={n} k={k}"
    cases = [
        Case("knn_ring", tag, ring(qsp, sup4, k), [qsp, sup4],
             stats_of(qsp, sup4, k), work=work),
        Case("knn_ring_masked", f"config 6m B{b} N={n} k={k} 75% valid",
             ring(mqsp, msup4, k, cen), [mqsp, msup4, cen],
             stats_of(mqsp, msup4, k, cen), work=work),
        Case("knn_ring_stats", tag, ring(qsp, sup4, k, stats=True),
             [qsp, sup4], lambda outs: visited(outs[2]), work=work),
    ]
    cases += [Case("knn_ring", f"config 6 B{b} N={n} k={kk}",
                   ring(qsp, sup4, kk), [qsp, sup4], stats_of(qsp, sup4, kk),
                   work=work) for kk in RING_CONFIG6_K]
    # config 7's RepulsionLoss on its 8192-point prediction
    ub, un = CONFIG7["b"], CONFIG7["n"] * CONFIG7["ratio"]
    xu = torch.from_numpy(cloud(np.random.default_rng(SEED + 23), ub,
                                un)).to(dev)
    uq, us, _, _ = ts._ring_inputs(xu, xu, False)
    cases.append(Case("knn_ring", f"config 7 repulsion B{ub} N={un} "
                      f"k={REPULSION_K}", ring(uq, us, REPULSION_K),
                      [uq, us], stats_of(uq, us, REPULSION_K), work=work))
    # k = 100, a heap of 104: at the reference's check shape, with forced
    # duplicate ties and ragged valid counts
    rb, rn, rk = RING_CHECK["b"], RING_CHECK["n"], RING_WIDE_K
    xr, xrp = ring_check_clouds(torch, dev)
    wq, ws, _, _ = ts._ring_inputs(xr, xr, False)
    mwq, mws, wcen, _ = ts._ring_inputs(xr, xrp, True)
    cases += [
        Case("knn_ring", f"B{rb} N={rn} k={rk} forced ties", ring(wq, ws, rk),
             [wq, ws], stats_of(wq, ws, rk), work=work),
        Case("knn_ring_masked", f"B{rb} N={rn} k={rk} valid {RING_VALID}",
             ring(mwq, mws, rk, wcen), [mwq, mws, wcen],
             stats_of(mwq, mws, rk, wcen), work=work),
    ]
    return cases


def band_dynamic_cases(torch, dev):
    """K7 at the masked headline's shapes (75% and ragged 50-100% valid
    prefixes, both directions): the pipeline's entry, which computes only
    the valid rows and the window centres itself, with its fold counter;
    then the public ``band_min_dynamic`` on the same clouds."""
    from pytorch_points_tpu_torch.kernels import nn_sorted as ns

    cases = []
    hb, hn = HEAD["b"], HEAD["n"]
    band_ops = DIST_FLOPS * hb * hn * 3 * ns.TB
    crng = np.random.default_rng(SEED + 11)
    ragged = [crng.integers(hn // 2, hn + 1, hb).tolist() for _ in range(2)]
    public = []
    for label, valid in (("75% valid", None), ("ragged 50-100% valid",
                                                ragged)):
        ps, gs, c1, c2, pm, gm = masked_head_clouds(torch, dev, valid)
        vp, vg = (x.sum(dim=1, dtype=torch.int32) for x in (pm, gm))
        for way, (a, o, c, va, vo) in (("p->q", (ps, gs, c1, vp, vg)),
                                       ("q->p", (gs, ps, c2, vg, vp))):
            tag = f"masked headline B{hb} N=M={hn} {label} {way}"
            cases += band_cases(
                torch, "nn_band_dynamic", tag,
                lambda impl, counts, a=a, o=o, va=va, vo=vo:
                ns._band_rows_masked(a, o, va, vo, counts=counts, impl=impl),
                [a, o, va, vo], hb, hn, 3 * ns.TB, va.sum().item())
            public.append(Case(
                "nn_band_dynamic", f"{tag}, public band_min_dynamic",
                lambda impl, a=a, o=o, c=c: ns.band_min_dynamic(a, o, c,
                                                                impl=impl),
                [a, o, c], band_ops))
    return cases + public


def shuffled(rng, x):
    """Each cloud of x [B,N,3] in its own random order."""
    return np.stack([c[rng.permutation(len(c))] for c in x])


def worklist_kernel_cases(torch, dev):
    """The worklist kernel on the inputs the pruned NN gives it at B=32
    N=M=16384 (q a shuffle of p, the reference's tiles), and directly on a
    dyadic tie grid with a seeded random candidate mask (every tile row
    and column paired) and k_max at the count. On the grid, equal
    distances resolve to the lowest sorted position."""
    from pytorch_points_tpu_torch.kernels import distance_tiles as dt

    rng = np.random.default_rng(SEED + 13)
    b, n = PRUNED["b"], PRUNED["n"]
    p = cloud(rng, b, n)
    p, q = (torch.from_numpy(a).to(dev) for a in (p, shuffled(rng, p)))
    plan = dt.pruned_plan(p, q)
    codes1, codes2, count = dt._worklist_codes(plan["cand"], plan["k_max"])
    args = (plan["pp"], plan["qp"], codes1, codes2, count, plan["tn"],
            plan["tm"])
    pairs = count.clamp(max=plan["k_max"]).sum().item()
    # the work: one distance tile per pair run, as the reference computes it
    # and as the kernel does (the two-launch form computed it twice)
    once = plan["tn"] * plan["tm"] * pairs
    cases = [Case(
        "nn_worklist", f"pruned NN B{b} N=M={n} q = shuffled p, {pairs} "
        "pairs",
        lambda impl: (dt.run_worklist_cuda if impl == "cuda" else
                      dt.run_worklist_torch)(*args),
        list(args[:5]), DIST_FLOPS * once,
        note=lambda got, ms: (
            f"distances evaluated once a pair: {once} ({once / ms / 1e6!r} "
            f"billion a second); the earlier two-launch form evaluated "
            f"{2 * once}"))]
    gb, gn, tn, tm = 8, 4096, 256, 128
    ni, nj = gn // tn, gn // tm
    pp, qp = (torch.from_numpy(grid64(rng, gb, gn)).to(dev) for _ in range(2))
    cand = rng.uniform(size=(gb, ni, nj)) < 0.3
    for bi in range(gb):
        cand[bi, np.arange(ni), rng.integers(0, nj, ni)] = True
        cand[bi, rng.integers(0, ni, nj), np.arange(nj)] = True
    cand = torch.from_numpy(cand).to(dev)
    k_max = int(cand.reshape(gb, -1).sum(1).max().item())
    pairs = cand.sum().item()
    cases.append(Case(
        "nn_worklist", f"_run_worklist, tie grid B{gb} N=M={gn} random "
        f"candidates k_max={k_max}",
        lambda impl: dt._run_worklist(cand, pp, qp, gb, ni, nj, tn, tm, gn,
                                      k_max, impl)[0],
        [pp, qp, cand], DIST_FLOPS * tn * tm * pairs))
    return cases


def ring_check_clouds(torch, dev):
    """The reference's at-scale check clouds, B=4 N=16384 with 128 forced
    duplicates: (x, x poisoned past the ragged valid counts RING_VALID)."""
    from pytorch_points_tpu_torch.core.masking import poison_points

    b, n = RING_CHECK["b"], RING_CHECK["n"]
    x = cloud(np.random.default_rng(SEED + 12), b, n)
    x[:, 1000:1128] = x[:, :128]  # forced duplicate ties
    x = torch.from_numpy(x).to(dev)
    valid = prefix_mask(torch, b, n, dev, list(RING_VALID))
    return x, poison_points(x, valid, -1.0)


def check_ring_equals_stream(torch, dev):
    """The reference's at-scale checks, which never ran on a TPU-less
    machine: K9 and K10 against the streaming kernel (K8) at B=4 N=16384
    with forced duplicate ties, K10 at ragged valid counts, at config 6's
    k and at k = 100 (heaps of 104 keys against K8's passes); indices
    identical, distances bitwise, no invalid point returned."""
    from pytorch_points_tpu_torch.kernels import topk_scan as ts

    b, n = RING_CHECK["b"], RING_CHECK["n"]
    x, xp = ring_check_clouds(torch, dev)
    ks = (RING_CHECK["k"], RING_WIDE_K)
    with torch.inference_mode():
        for k in ks:
            for label, sup, masked in (("K9", x, False), ("K10", xp, True)):
                ring = ts.knn(x, sup, k, impl="cuda", masked=masked)
                stream = ts.knn(x, sup, k, impl="cuda", sorted_ok=False)
                for g, r in zip(ring, stream, strict=True):
                    if g.dtype != r.dtype or not torch.equal(g, r):
                        fail(f"{label} differs from K8 at B={b} N={n} k={k}")
            if not (ring[1] < torch.tensor(RING_VALID, device=dev)[
                    :, None, None]).all():
                fail(f"K10 returned a poisoned support point at k={k}")
    print(f"K9 == K8 and K10 == K8 at B={b} N={n} k={ks} with 128 forced "
          f"duplicates, K10 at valid counts {RING_VALID} (bitwise)")


def check_k6_equals_k5(torch, dev):
    """The pruned indexed path against the dense kernel on the same clouds,
    at the headline shape: indices identical, distances bitwise."""
    from pytorch_points_tpu_torch.kernels import distance_tiles, nn_sorted

    rng = np.random.default_rng(SEED + 4)
    p, q = (torch.from_numpy(cloud(rng, HEAD["b"], HEAD["n"])).to(dev)
            for _ in range(2))
    with torch.inference_mode():
        got = nn_sorted.nndistance_indexed(p, q, impl="cuda")
        dense = distance_tiles.nn_both_directions(p, q, impl="cuda")
        for g, r in zip(got, dense):
            if g.dtype != r.dtype or not torch.equal(g, r):
                fail("K6 (nndistance_indexed) differs from K5 at the "
                     "headline shape")
        ms = cuda_ms(torch, lambda: nn_sorted.nndistance_indexed(
            p, q, impl="cuda"))
        sums_ms = cuda_ms(torch, lambda: nn_sorted.nndistance_sums(
            p, q, impl="cuda"))
        both = functools.partial(distance_tiles.nn_both_directions, p, q,
                                 impl="cuda")
        one = functools.partial(distance_tiles.nn_one_direction, p, q,
                                impl="cuda")
        dense_ms, one_ms = cuda_ms(torch, both), cuda_ms(torch, one)
        both_dev, both_items, both_mark, both_reads = agreed_device_ms(
            torch, both)
        one_dev, one_items, one_mark, one_reads = agreed_device_ms(
            torch, one)
    hb, hn = HEAD["b"], HEAD["n"]
    pairs = hb * hn * hn
    # p and q read once; each direction's d and idx written once
    both_bytes = 4 * 3 * 2 * hb * hn + 8 * 2 * hb * hn
    one_bytes = 4 * 3 * 2 * hb * hn + 8 * hb * hn
    floor = issue_floor_ms(DIST_FLOPS * pairs)
    print(f"K6 == K5 at B={hb} N=M={hn} (bitwise). Whole "
          f"paths: nndistance_indexed {ms!r} ms, nndistance_sums "
          f"{sums_ms!r} ms, dense K5 both directions {dense_ms!r} ms")
    print(f"K5 both directions B={hb} N=M={hn}: event {dense_ms!r} ms, "
          f"device-only {both_dev!r} ms in {both_items!r} device items a "
          f"call{both_mark} (reads {both_reads!r}); bound "
          f"{bound_ms(both_bytes, DIST_FLOPS * pairs)[0]!r} ms; issue floor "
          f"{floor!r} ms (each distance once)")
    print(f"K13 one direction B={hb} N=M={hn}: event {one_ms!r} ms, "
          f"device-only {one_dev!r} ms in {one_items!r} device items a "
          f"call{one_mark} (reads {one_reads!r}); bound "
          f"{bound_ms(one_bytes, DIST_FLOPS * pairs)[0]!r} ms; issue floor "
          f"{floor!r} ms")


def config4_clouds(torch, dev):
    """Config 4's input: B=32 N=2048 standard-normal pairs (bench.py)."""
    rng = np.random.default_rng(SEED + 5)
    return (torch.from_numpy(normal(rng, **EMD4)).to(dev),
            torch.from_numpy(normal(rng, **EMD4)).to(dev))


def timed_plain(torch, fn):
    """(outputs, host ms) of one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def hold_against_plain(torch, case, stats):
    """One kernel call against one plain call, dtype and shape equal: every
    output bitwise equal or, with a ``case.bound``, the first within it of
    the plain version's and bitwise equal across two launches. Then kernel
    ms from CUDA events, plain ms from CUDA events or, past
    PLAIN_SINGLE_MS, the one call on the host clock; the case's bound and
    its library call's ms. Returns the kernel's outputs."""
    name, label, fn, bound = case.name, case.label, case.fn, case.bound
    got = fn("cuda")
    ref, plain_ms = timed_plain(torch, lambda: fn("torch"))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for g, r in zip(got, ref, strict=True):
        if g.dtype != r.dtype or g.shape != r.shape:
            fail(f"{name} [{label}]: {g.dtype}{tuple(g.shape)} vs plain "
                 f"{r.dtype}{tuple(r.shape)}")
        if g.dtype.is_floating_point:
            err = max(err, (g - r).abs().max().item())
        if bound is None and not torch.equal(g, r):
            fail(f"{name} [{label}]: kernel differs from plain (max abs err "
                 f"{err})")
    if bound is not None:
        if not ((got[0] - ref[0]).abs() <= bound).all():
            fail(f"{name} [{label}]: kernel outside the summation-order "
                 f"bound of plain (max abs err {err})")
        if not torch.equal(got[0], fn("cuda")):
            fail(f"{name} [{label}]: two launches differ")
    verdict = "equal" if bound is None else "within bound, repeatable"
    if case.cpu is not None:
        if not torch.equal(got[0].cpu(), case.cpu()):
            fail(f"{name} [{label}]: kernel differs from the plain version "
                 "on the CPU")
        verdict += ", equal to plain on the CPU"
    ms = cuda_ms(torch, lambda: fn("cuda"))
    if plain_ms < PLAIN_SINGLE_MS:
        plain_ms = cuda_ms(torch, lambda: fn("torch"))
    ops = case.ops(got) if callable(case.ops) else case.ops
    b_ms, b_by = bound_ms(nbytes(case.inputs) + nbytes(got), ops)
    lib_ms = None if case.library is None else cuda_ms(torch, case.library)
    print(f"{name:15s} {label:52s} {verdict}  max_abs_err={err!r}  kernel "
          f"{ms!r} ms  plain {plain_ms!r} ms  bound {b_ms!r} ms ({b_by}, "
          f"{ops!r} flops)  library {lib_ms!r} ms")
    if case.work is not None:
        pairs = case.work(got)
        print(f"{'':15s} work counter (equal to the plain version's): the "
              f"kernel's visited pairs {pairs!r}, "
              f"{pairs / max(ops / DIST_FLOPS, 1)!r} of the bound's "
              f"{ops // DIST_FLOPS!r}")
    if case.note is not None:
        print(f"{'':15s} {case.note(got, ms)}")
    if name in SPLIT_KERNELS:
        dev_ms, items, mark = device_ms(torch, lambda: fn("cuda"))
        line = (f"{'':15s} device-only: kernel {dev_ms!r} ms in {items!r} "
                f"device items a call{mark}")
        if case.library is not None:
            lib_dev, _, lib_mark = device_ms(torch, case.library)
            line += f"; library {lib_dev!r} ms{lib_mark}"
        if case.issue is not None:
            line += (f"; issue floor {issue_floor_ms(case.issue)!r} ms (one "
                     f"lane-instruction a rounded operation)")
        if name == "scatter":
            det_ms, det_dev, det_mark = deterministic_ms(torch, case.library)
            line += (f"; deterministic index_add_ {det_ms!r} ms, device-only"
                     f" {det_dev!r} ms{det_mark}; longest run "
                     f"{longest_run(torch, case.inputs[0], got[0].shape[1])}"
                     " updates")
        print(line)
    s = stats[name]
    s["max_abs_err"] = max(s["max_abs_err"], err)
    s["last_ms"] = ms
    if "ms" not in s:  # the JSON line reports each kernel's 1st case
        s.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib_ms)
    return got


def k12_pop_floor(auction, n, longest):
    """The least time of one pop on K12's block for N' = ``n`` (one barrier
    and one block argmin, clock64 and %globaltimer on the card) and the
    latency bound it gives: the longest cloud's pops times that floor."""
    cycles, ns = auction.augment_pop_floor(n)
    print(f"            K12 pop floor on its block for N'={n}: {cycles!r} "
          f"cycles = {ns!r} ns (clock {cycles / ns!r} GHz), latency bound "
          f"{longest * ns * 1e-6!r} ms")


def emd_counts(torch, k11, k12, n_pad, k11_ms, k12_ms, stragglers):
    """Print K11's and K12's counters (owners and prices already held);
    return the most pops a cloud took."""
    scans = k11[:, 0].sum(1)
    pairs = scans.double() * n_pad  # pair evaluations a cloud
    print(f"            K11 counters: bidder scans a cloud: cloud 0 "
          f"{int(scans[0])}, mean {scans.double().mean().item()!r}, max "
          f"{int(scans.max())}; sweeps a phase, cloud 0: "
          f"{k11[0, 1].tolist()}; {k11_ms / (pairs.max().item() / 1e6)!r} ms "
          f"per million pair evaluations on the busiest cloud "
          f"({k11_ms / (pairs.sum().item() / 1e6)!r} over all clouds)")
    if k12 is None:
        return
    pops = k12[:, 0]
    longest = int(pops.max())
    per_pop = (f"{k12_ms * 1e3 / longest!r} us a pop on the longest cloud"
               if longest else "no pops")
    print(f"            K12 counters: pops a cloud: max {longest} (cloud "
          f"{int(pops.argmax())}), mean {pops.double().mean().item()!r}, "
          f"total {int(pops.sum())}; capped stragglers {int(k12[:, 1].sum())}"
          f" of {stragglers} ({k12[:, 1].sum().item() / max(1, stragglers)!r}"
          f"); {per_pop}")
    return longest


def check_emd_kernels(torch, dev, stats):
    """K11 and K12 against their plain versions, owners, prices and work
    counters bitwise: K11 as earth_mover_distance runs it (the hardness
    hint on the card, the hard ladder when it holds), K12 on K11's own
    output. Bounds from the work the counters report: K11 every benefit
    once (the warm start) plus a pair evaluation for each object a bidder
    scans, K12 a column relaxed for each pop."""
    from pytorch_points_tpu_torch.kernels import auction
    from pytorch_points_tpu_torch.ops.emd import _poison_rank_matched

    def t(a):
        return torch.from_numpy(a).to(dev)

    rng = np.random.default_rng(SEED + 6)
    b, n = SLICE["b"], SLICE["n"]
    pm, qm = (t(m) for m in equal_count_masks(rng, b, n))
    same = t(normal(rng, b, n))
    ladders = ([EMD_ITERS] * EMD_PHASES, list(EMD_HARD))
    cases = [  # (label, p, q, endgame pop caps to hold K12 at, ladders)
        (f"config 4 B{EMD4['b']} N={EMD4['n']} normal",
         *config4_clouds(torch, dev), (768,), ladders),
        (f"B{b} N={n} gaussian mixture", t(gmm(rng, b, n)),
         t(gmm(rng, b, n)), (384,), ladders),
        (f"B{b} N={n} tie grid", t(grid64(rng, b, n)), t(grid64(rng, b, n)),
         (768,), ladders),
        (f"B{b} N=2000 padded", t(normal(rng, b, 2000)),
         t(normal(rng, b, 2000)), (8,), ladders),
        (f"B{b} N={n} 75-100%-valid equal counts",
         _poison_rank_matched(t(normal(rng, b, n)), pm),
         _poison_rank_matched(t(normal(rng, b, n)), qm), (768,), ladders),
        # more clouds than SMs; N' = 256, 1024 and 4096 (K12's block
        # changes its columns a thread there); pop cap 1
        ("B140 N=256 normal", t(normal(rng, 140, 256)),
         t(normal(rng, 140, 256)), (768,), ladders),
        (f"B{b} N=1024 normal", t(normal(rng, b, 1024)),
         t(normal(rng, b, 1024)), (1,), ladders),
        ("B2 N=4096 normal", t(normal(rng, 2, 4096)),
         t(normal(rng, 2, 4096)), (64,), ladders),
        # q = p: K12 runs on identity owners built here (every person
        # holding its twin) with K11's prices, so it has no straggler; K11
        # itself may leave some within its sweeps
        (f"B{b} N={n} q = p", same, same.clone(), (768,), ladders),
    ]
    eps_k = auction.phase_schedule(EMD_EPS, EMD_PHASES, 6.0)
    hints = set()
    for label, p, q, pops, lad in cases:
        hint = auction._hardness_hint(p, q)
        hints.add(bool(hint))
        n_pad = auction._round_up(p.shape[1], 256)
        pp, qp = auction.pad_twins(p, q, n_pad)
        bb = pp.shape[0]

        def k11(impl, pp=pp, qp=qp, hint=hint, lad=lad, bb=bb):
            run = auction.auction_cuda if impl == "cuda" else (
                auction.auction_torch)
            counts = torch.zeros((bb, 2, EMD_PHASES), dtype=torch.int32,
                                 device=dev)
            return (*run(pp, qp, eps_k, lad, hint, 256, True, counts),
                    counts)

        def k11_ops(got, bb=bb, n_pad=n_pad):
            # every benefit once (warm start), then each bidder scan
            return DIST_FLOPS * n_pad * (bb * n_pad + got[2][:, 0].sum().item())

        tag = f"{label}, hint {bool(hint)}"
        owner, price, c11 = hold_against_plain(torch, Case(
            "auction", tag, k11, [pp, qp], k11_ops), stats)
        k11_ms = stats["auction"]["last_ms"]
        left = (owner < 0).sum(1).float()
        print(f"            stragglers after K11: mean {left.mean().item()!r}"
              f" max {left.max().item()!r} per cloud")
        if label.endswith("q = p"):
            owner = torch.arange(n_pad, dtype=torch.int32,
                                 device=dev).expand(bb, n_pad).contiguous()
        cap = auction.MAX_ROUNDS * min(auction.S_MAX, n_pad)
        c12 = None
        k12_ms = 0.0
        for pop in pops:
            def k12(impl, owner=owner, price=price, pp=pp, qp=qp, pop=pop,
                    bb=bb):
                run = auction.augment_cuda if impl == "cuda" else (
                    auction.augment_torch)
                counts = torch.zeros((bb, 2), dtype=torch.int32, device=dev)
                return (*run(owner, price, pp, qp, EMD_EPS, pop, cap, counts),
                        counts)

            def k12_ops(got, n_pad=n_pad):  # a column relaxed a pop
                return DIST_FLOPS * n_pad * got[2][:, 0].sum().item()

            owners = (", built identity owners" if label.endswith("q = p")
                      else "")
            done, _, c12 = hold_against_plain(torch, Case(
                "augment", f"{label}{owners}, pop {pop}", k12,
                [owner, price, pp, qp], k12_ops), stats)
            k12_ms = stats["augment"]["last_ms"]
            if not (torch.sort(done, 1).values == torch.arange(
                    n_pad, device=dev, dtype=torch.int32)).all():
                fail(f"augment [{label}]: owners are not a permutation")
        blocks = auction.auction_cluster_size(bb, n_pad, 256)
        print(f"            K11 takes {blocks} block(s) a cloud")
        if blocks > 1 and label.startswith(("config 4", f"B{b} N={n} gauss")):
            one = auction.auction_cuda(pp, qp, eps_k, lad, hint, 256, True,
                                       cluster=1)
            if not (torch.equal(one[0], owner) and torch.equal(one[1], price)):
                fail(f"auction [{label}]: one block a cloud differs")
            ms1 = cuda_ms(torch, lambda: auction.auction_cuda(
                pp, qp, eps_k, lad, hint, 256, True, cluster=1))
            print(f"            K11 on one block a cloud: equal, {ms1!r} ms "
                  f"(on {blocks}: {k11_ms!r} ms)")
        longest = emd_counts(torch, c11, c12, n_pad, k11_ms, k12_ms,
                             int((owner < 0).sum().item()))
        if label.endswith("q = p") and int(c12.sum()) != 0:
            fail(f"augment [{label}]: pops without a straggler")
        if label.startswith("config 4"):
            k12_pop_floor(auction, n_pad, longest)
    if hints != {False, True}:
        fail(f"the EMD cases took only hint {hints}: both ladders must run")
    # K11 past the 8 phases one launch holds: two chained launches
    p9, q9 = (x[:8] for x in config4_clouds(torch, dev))
    eps9 = auction.phase_schedule(EMD_EPS, AUCTION_PHASES, 2.0)
    ladders9 = ([4] * AUCTION_PHASES, [6] * AUCTION_PHASES)
    hint9 = auction._hardness_hint(p9, q9)

    def k11_phases(impl):
        run = auction.auction_cuda if impl == "cuda" else (
            auction.auction_torch)
        counts = torch.zeros((p9.shape[0], 2, AUCTION_PHASES),
                             dtype=torch.int32, device=dev)
        return (*run(p9, q9, eps9, ladders9, hint9, 256, True, counts),
                counts)

    b9, n9 = p9.shape[:2]
    hold_against_plain(torch, Case(
        "auction", f"{AUCTION_PHASES} phases, config 4 clouds B{b9} "
        f"N={n9}, hint {bool(hint9)}", k11_phases, [p9, q9],
        lambda got: DIST_FLOPS * n9 * (b9 * n9 + got[2][:, 0].sum().item())),
        stats)


# (rows, C) of the benchmark cells' largest LayerNorms: SA1's 524,288
# rows at 64 and 128 channels (and FP1 and the head at 16384 points), SA2's
# 131,072 at 256, SA3's 4096 at 512 and 1024, the upsampler's 262,144 at
# 128; the MSG part segmenter's widths no other cell has: SA1's first
# scale at 32, its third at 96, SA2's second at 196
LAYER_NORM_SHAPES = ((524288, 64), (524288, 128), (131072, 256),
                     (4096, 512), (4096, 1024), (262144, 128),
                     (524288, 32), (2097152, 96), (524288, 196))


def layer_norm_cases(torch, dev, stats):
    """The LayerNorm+ReLU pair, forward then backward, against its plain
    version at LAYER_NORM_SHAPES: the forward's outputs (a, mean, rstd)
    bitwise equal (the kernel takes a row's statistics in torch's order),
    the backward's within 1e-4 of each tensor's largest plain value, on da
    zeroed in the rows where the plain z lies within 1e-4 of 0 (the plain
    backward recomputes z in two roundings, where torch's forward and the
    kernel take one fma, so a rounding there may flip its ReLU mask); two
    runs bitwise equal.
    Then the kernels' times (CUDA events: forward, backward, both), the
    bound (20 bytes an element, 8 a row), the plain pair's time, and
    torch's layer norm and ReLU with their autograd backward (the port's
    route before the kernels) as the library call."""
    import torch.nn.functional as F

    from pytorch_points_tpu_torch.kernels import layernorm

    eps = 1e-6
    for rows, c in LAYER_NORM_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 40)
        x = torch.randn(rows, c, generator=gen, device=dev)
        w = 1 + 0.5 * torch.randn(c, generator=gen, device=dev)
        b = 0.5 * torch.randn(c, generator=gen, device=dev)
        da = torch.randn(rows, c, generator=gen, device=dev)
        z = torch.native_layer_norm(x, (c,), w, b, eps)[0]
        near = ((z.abs() < 1e-4) & (z != 0)).any(1)
        da[near] = 0.0

        def fwd(impl):
            return (layernorm.layer_norm_relu_cuda if impl == "cuda" else
                    layernorm.layer_norm_relu_torch)(x, w, b, eps)

        def both(impl):
            a, mean, rstd = fwd(impl)
            back = (layernorm.layer_norm_relu_backward_cuda if impl == "cuda"
                    else layernorm.layer_norm_relu_backward_torch)
            return (a, mean, rstd, *back(da, x, mean, rstd, w, b))

        got, ref = both("cuda"), both("torch")
        err = 0.0
        for i, (g, r) in enumerate(zip(got, ref, strict=True)):
            gap = (g - r).abs()
            err = max(err, gap.max().item())
            if i < 3 and not torch.equal(g, r):
                fail(f"layer_norm_relu [{rows}x{c}]: forward output {i} "
                     f"differs from plain (max abs err {err})")
            if not (gap <= 1e-4 * r.abs().max()).all():
                fail(f"layer_norm_relu [{rows}x{c}]: output {i} outside "
                     f"float32 rounding of plain (max abs err {err})")
        if not all(torch.equal(g, h) for g, h in zip(got, both("cuda"))):
            fail(f"layer_norm_relu [{rows}x{c}]: two runs differ")
        a, mean, rstd = fwd("cuda")
        fwd_ms = cuda_ms(torch, lambda: fwd("cuda"))
        bwd_ms = cuda_ms(torch, lambda: layernorm.layer_norm_relu_backward_cuda(
            da, x, mean, rstd, w, b))
        ms = cuda_ms(torch, lambda: both("cuda"))
        plain_ms = cuda_ms(torch, lambda: both("torch"))
        xg = x.clone().requires_grad_()
        wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()

        def library():
            out = torch.relu(F.layer_norm(xg, (c,), wg, bg, eps))
            return torch.autograd.grad(out, (xg, wg, bg), da)

        lib_ms = cuda_ms(torch, library)
        moved = 20 * rows * c + 16 * rows + 4 * 4 * c
        b_ms, b_by = bound_ms(moved, 0)
        print(f"{'layer_norm_relu':15s} {f'{rows}x{c}, forward + backward':52s}"
              f" forward equal, backward within rounding, repeatable "
              f"({near.sum().item()} rows with |z| < 1e-4 left out of the "
              f"backward)  max_abs_err={err!r}  "
              f"kernel {ms!r} ms (forward {fwd_ms!r}, backward {bwd_ms!r})  "
              f"plain {plain_ms!r} ms  bound {b_ms!r} ms ({b_by}, {moved} "
              f"bytes)  library {lib_ms!r} ms")
        s = stats["layer_norm_relu"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if "ms" not in s:
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms)


def phase_kernels(torch, dev):
    print("== phase 2: each kernel vs its plain PyTorch version "
          "(indices identical, values bitwise; the scatter bitwise against "
          "the plain version on the CPU, within its summation-order bound "
          "of the one on the card)")
    rng = np.random.default_rng(SEED)
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    with torch.inference_mode():
        cases = kernel_cases(torch, rng, dev)
        cases += training_kernel_cases(torch, rng, dev)
        cases += ring_kernel_cases(torch, dev)
        cases += band_dynamic_cases(torch, dev)
        cases += worklist_kernel_cases(torch, dev)
        cases += bf16_gather_cases(torch, dev)
        cases += partseg_kernel_cases(torch, dev)
        for case in cases:
            hold_against_plain(torch, case, stats)
        check_emd_kernels(torch, dev, stats)
    layer_norm_cases(torch, dev, stats)
    check_k6_equals_k5(torch, dev)
    check_ring_equals_stream(torch, dev)
    return stats


def drive(wrappers, required, path, run):
    """Run one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was never launched."""
    for w in wrappers.values():
        w.launches = 0
    run()
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"launches during {path}: {launches}")
    for name in required:
        if launches[name] <= 0:
            fail(f"{path} never launched the {name} kernel")
    return launches


def requests(rng):
    """(shape tag, xyz [B,N,3] f32, mask [B,N] bool or None)."""
    reqs = [("B16_N2048", cloud(rng, **SLICE), None) for _ in range(8)]
    reqs += [("B32_N16384", cloud(rng, **LARGE), None) for _ in range(3)]
    b, n = SLICE["b"], SLICE["n"]
    for _ in range(3):
        lengths = rng.integers(3 * n // 4, n + 1, size=b)
        mask = np.arange(n)[None, :] < lengths[:, None]
        xyz = np.where(mask[..., None], cloud(rng, b, n), 0.0)
        reqs.append(("B16_N2048_masked", xyz.astype(np.float32), mask))
    return reqs


def phase_serve(torch, dev, wrappers):
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder

    print("== phase 3: serve a full-width PointCloudAutoencoder")
    gen = torch.Generator().manual_seed(SEED)
    model = PointCloudAutoencoder(NPOINT1, NPOINT2, device=dev,
                                  generator=gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, npoint {NPOINT1}/{NPOINT2}, "
          f"radius {RADIUS1}/{RADIUS2}, nsample {NSAMPLE}, LayerNorm, f32")
    reqs = requests(np.random.default_rng(SEED + 1))

    def answer(xyz, mask, impl="auto"):
        x = torch.from_numpy(xyz).to(dev)
        m = None if mask is None else torch.from_numpy(mask).to(dev)
        return model(x, m, impl=impl).cpu()

    with torch.inference_mode():
        for tag in dict.fromkeys(r[0] for r in reqs):  # warm-up, uncounted
            _, xyz, mask = next(r for r in reqs if r[0] == tag)
            answer(xyz, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        outs, lat = [], {}

        def serve():
            for tag, xyz, mask in reqs:
                t0 = time.perf_counter()
                outs.append(answer(xyz, mask))  # .cpu() waits for the card
                lat.setdefault(tag, []).append(
                    (time.perf_counter() - t0) * 1e3)

        launches = drive(wrappers, SERVE_KERNELS, "serve", serve)
        peak = torch.cuda.max_memory_allocated(dev)

        worst = {}
        for (tag, xyz, mask), out in zip(reqs, outs):
            if out.shape != xyz.shape or not torch.isfinite(out).all():
                fail(f"{tag}: bad output {tuple(out.shape)} / non-finite")
            if mask is not None and (out.numpy()[~mask] != 0).any():
                fail(f"{tag}: masked rows are not zero")
            err = (out - answer(xyz, mask, impl="torch")).abs().max().item()
            worst[tag] = max(worst.get(tag, 0.0), err)
            if err > SERVE_TOL:
                fail(f"{tag}: kernels vs plain versions differ by {err}")
    for tag, ms in lat.items():
        print(f"serve {tag:18s} median {statistics.median(ms)!r} ms over "
              f"{len(ms)} requests (numpy in -> numpy out); "
              f"max |kernels - plain| = {worst[tag]!r}")
    print(f"peak device memory during serve: {peak} bytes")

    def request(tag):
        _, xyz, mask = next(r for r in reqs if r[0] == tag)
        with torch.inference_mode():
            return answer(xyz, mask)

    return [launches], {f"serve {tag}": functools.partial(request, tag)
                        for tag in lat}


def grad_gap(got, ref):
    """max |got - ref| / max |ref| over the pairs of tensors (0/0 -> 0)."""
    worst = 0.0
    for g, r in zip(got, ref, strict=True):
        scale = r.abs().max().item()
        diff = (g - r).abs().max().item()
        worst = max(worst, diff / scale if scale else diff)
    return worst


def first_step_gate(torch, model, loss_of, what, tol=TRAIN_GRAD_TOL,
                    ascending=False):
    """The first step's loss and parameter grads, kernels against plain
    versions (uncounted): ``loss_of(impl)`` computes the loss on one route.
    The model's buffers (BatchNorm's running statistics) are restored
    before each route's forward. The loss must agree within 1e-6 relative
    and every grad lie within ``tol`` of its tensor's largest plain grad.

    With ``ascending`` the plain versions run a second time with ascending
    sums (deterministic algorithms: ``index_add_`` sums each row in
    ascending k, K4's order), and the kernels are held to that route; the
    default route's distance from it, the spread that the summation order
    causes, is printed beside. Where the order alone moves a grad by more
    than ``tol`` (under bf16 rounding, or in a grad that cancels to
    rounding noise, as a bias before a BatchNorm), only the ascending route
    holds the kernels to the plain versions. Returns {route: (loss, grads,
    buffers after the forward)} over the routes "kernels", "plain" and,
    with ``ascending``, "ascending"."""
    import warnings

    routes = {}
    start = [t.clone() for t in model.buffers()]
    plans = [("kernels", "cuda", False), ("plain", "torch", False)]
    if ascending:
        plans.append(("ascending", "torch", True))
    for label, impl, ordered in plans:
        with torch.no_grad():
            for t, s0 in zip(model.buffers(), start):
                t.copy_(s0)
        model.zero_grad(set_to_none=True)
        before = torch.are_deterministic_algorithms_enabled()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(ordered, warn_only=True)
            try:
                loss = loss_of(impl)
                loss.backward()
            finally:
                torch.use_deterministic_algorithms(before)
        routes[label] = (loss.item(), [p.grad.detach().clone()
                                       for p in model.parameters()],
                         [t.clone() for t in model.buffers()])
    model.zero_grad(set_to_none=True)
    ref = "ascending" if ascending else "plain"
    gap = grad_gap(routes["kernels"][1], routes[ref][1])
    losses = {k: v[0] for k, v in routes.items()}
    print(f"{what} first step: losses {losses}; parameter grads max "
          f"|kernels - {ref}| / max |{ref}| = {gap!r} (bar {tol})" + (
              "; the summation order's spread, max |plain (atomic sums) - "
              f"plain (ascending)| / max = "
              f"{grad_gap(routes['plain'][1], routes[ref][1])!r}"
              if ascending else ""))
    if (not np.isfinite(losses["kernels"]) or gap > tol
            or abs(losses["kernels"] - losses[ref]) > 1e-6 * abs(
                losses[ref])):
        fail(f"{what}: first-step loss or grads differ from the plain "
             "versions")
    return routes


def train_run(torch, dev, wrappers, required, label, step, batches):
    """One main path: ``step`` over ``batches``, timed a step to its loss's
    ``.item()``; fails on a non-finite loss. Returns (launches, median ms
    a step)."""
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def train():
        for batch in batches:
            t0 = time.perf_counter()
            losses.append(step(batch).item())  # .item() waits for the card
            times.append((time.perf_counter() - t0) * 1e3)

    launches = drive(wrappers, required, f"train, {label}", train)
    if not np.isfinite(losses).all():
        fail(f"train ({label}): non-finite loss {losses}")
    median = statistics.median(times)
    print(f"train losses: {losses}")
    print(f"train median {median!r} ms/step over {len(times)} steps (first "
          f"step {times[0]!r} ms); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes")
    return launches, median


def phase_train(torch, dev, wrappers):
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.parallel import (
        make_train_step,
        reconstruction_loss,
    )

    b, n = SLICE["b"], SLICE["n"]
    print(f"== phase 4: train the full-width PointCloudAutoencoder, B={b} "
          f"N={n}, Adam lr 1e-3")
    rng = np.random.default_rng(SEED + 2)
    batches = [{"points": torch.from_numpy(cloud(rng, b, n)).to(dev)}
               for _ in range(TRAIN_STEPS)]
    runs = (("chamfer alone", dict(emd_weight=0),
             (*TRAIN_KERNELS, "layer_norm_relu")),
            ("config 5, chamfer + 0.1 EMD (pop cap 384)",
             dict(emd_kwargs=CONFIG5_EMD),
             (*TRAIN_KERNELS, *EMD_KERNELS, "layer_norm_relu")))
    launches, calls, medians = [], {}, {}
    for label, kw, required in runs:
        print(f"-- {label}")
        gen = torch.Generator().manual_seed(SEED)
        model = PointCloudAutoencoder(NPOINT1, NPOINT2, device=dev,
                                      generator=gen)
        first_step_gate(torch, model, lambda impl, kw=kw: reconstruction_loss(
            impl=impl, **kw)(model, batches[0]), f"train ({label})")
        step = make_train_step(model,
                               torch.optim.Adam(model.parameters(), 1e-3),
                               reconstruction_loss(**kw))
        counts, medians[label] = train_run(torch, dev, wrappers, required,
                                           label, step, batches)
        launches.append(counts)
        calls[f"train step, {label}, B={b} N={n}"] = (
            lambda step=step: step(batches[0]).item())
    print("train step medians: " + "; ".join(
        f"{label} {ms!r} ms" for label, ms in medians.items()))
    MEASURED["config 5 f32 step ms"] = medians[runs[1][0]]
    return launches, calls


def headline_terms(pred, gt, impl, pm=None, gm=None):
    """The JAX package's graded headline (bench.py) in two terms: the
    chamfer distance, and the FPS + ball query + group term (the mean
    squared offset of each group from its centroid). With masks, its
    masked form (p_mask ``pm``, q_mask ``gm``)."""
    from pytorch_points_tpu_torch.ops import (
        ball_query,
        chamfer_distance,
        furthest_point_sample_and_gather,
        group_points,
    )

    cen, _ = furthest_point_sample_and_gather(pred, HEAD["p"], mask=pm,
                                              impl=impl)
    nidx, _ = ball_query(pred, cen, RADIUS1, NSAMPLE, mask=pm, impl=impl)
    centered = group_points(pred, nidx, impl) - cen[:, :, None, :]
    return (chamfer_distance(pred, gt, pm, gm, impl=impl),
            (centered**2).mean())


def masked_candidate_shares(torch, dev):
    """Each direction's (share of candidate tile pairs, share of (warp,
    tile) pairs the scan's warps visit) on the masked headline's clouds, as
    nndistance_indexed_masked gives them to the scan (its own band stage),
    from the scan's counters."""
    from pytorch_points_tpu_torch.kernels import nn_sorted as ns

    shares = []
    with torch.inference_mode():
        pp, qp, perm_p, perm_q, _, _, d_ub1, d_ub2 = ns._masked_bounds(
            *masked_head_poisoned(torch, dev), "auto")
        for a, o, ids, d_ub in ((pp, qp, perm_q, d_ub1),
                                (qp, pp, perm_p, d_ub2)):
            b, n = a.shape[:2]
            m = o.shape[1]
            counts = torch.zeros((b, n // ns.TN, 2), dtype=torch.int32,
                                 device=dev)
            ns.nn_scan(a, o, ns._pad_ids(ids, m), d_ub, counts=counts)
            nj = m // ns.TM
            shares.append((counts[..., 0].sum().item() / (b * n // ns.TN * nj),
                           counts[..., 1].sum().item()
                           / (b * n // ns.SCAN_WARP_ROWS * nj)))
    return shares


def headline_shares(torch, what, call):
    """K1's, K6's (box table and scan) and the band's device ms in one
    traced call of the headline, and their shares of its device busy."""
    items, counted, marker = traced(torch, call, 2)
    busy = sum(us for us, _ in items.values()) / 1e3 / counted

    def ms(*keys):
        return sum(us for name, (us, _) in items.items()
                   if any(k in name for k in keys)) / 1e3 / counted

    k1 = ms("fps_block_kernel", "fps_stream_kernel")
    k6 = ms("nn_scan_kernel", "nn_boxes_kernel")
    band = ms("nn_band_kernel")
    print(f"{what}: device busy {busy!r} ms a call; K1 {k1!r} ms (share "
          f"{k1 / busy!r}), K6 scan with its box launch {k6!r} ms (share "
          f"{k6 / busy!r}), band ({'K7' if 'masked' in what else 'K6'}, "
          f"both directions) {band!r} ms (share {band / busy!r}){marker}")


def phase_headline(torch, dev, wrappers, masked=False):
    from pytorch_points_tpu_torch.ops import chamfer_path

    b, n, p = HEAD["b"], HEAD["n"], HEAD["p"]
    what = "masked headline" if masked else "headline"
    print(f"== phase {10 if masked else 5}: {what} FPS {n}->{p} + ball query "
          f"(r={RADIUS1}, ns={NSAMPLE}) + group + chamfer, forward and "
          f"backward, B={b}" + (f", {VALID_SHARE:.0%} prefix-valid "
                                "p_mask = q_mask" if masked else ""))
    if masked:
        pred, gt, pm, gm = masked_head_inputs(torch, dev)
        want = "sorted_masked"
    else:
        rng = np.random.default_rng(SEED + 3)
        gt = torch.from_numpy(cloud(rng, b, n)).to(dev)
        pred = torch.from_numpy(head_pred(rng)).to(dev)
        pm = gm = None
        want = "sorted_loss"
    path = chamfer_path(pred, gt, pm, gm, "auto", "mean")
    print(f"chamfer_path: {path}")
    if path != want:
        fail(f"{what}: chamfer took the {path} path, not {want}")
    if masked:
        (s1, w1), (s2, w2) = masked_candidate_shares(torch, dev)
        print(f"candidate tile pairs, share of all: p->q {s1!r}, q->p {s2!r};"
              f" (warp, tile) pairs the scan visits: p->q {w1!r}, q->p "
              f"{w2!r}")

    def values_and_grads(impl):
        """(loss, group term) and their grads in pred. The loss weighs the
        group term by 1e-6, so its grad is held on its own, at weight 1."""
        x = pred.clone().requires_grad_()
        cd, group = headline_terms(x, gt, impl, pm, gm)
        loss = cd + HEAD_GROUP_WEIGHT * group
        g_group, = torch.autograd.grad(group, x, retain_graph=True)
        g_loss, = torch.autograd.grad(loss, x)
        return (loss.item(), group.item()), (g_loss, g_group)

    v_k, g_k = values_and_grads("cuda")  # uncounted: held against plain
    v_p, g_p = values_and_grads("torch")
    for term, vk, vp, gk, gp in zip(("loss", "group term"), v_k, v_p, g_k,
                                    g_p, strict=True):
        gap = grad_gap([gk], [gp])
        print(f"{what} {term}: kernels {vk!r} plain {vp!r}; pred grad max "
              f"|kernels - plain| / max |plain| = {gap!r} "
              f"(bar {HEAD_GRAD_TOL})")
        if not (np.isfinite(vk) and torch.isfinite(gk).all()
                and gk.shape == pred.shape):
            fail(f"{what} {term}: non-finite value or grad")
        if gap > HEAD_GRAD_TOL or abs(vk - vp) > 1e-6 * abs(vp):
            fail(f"{what} {term}: value or grad differs from the plain "
                 "versions")
        if masked and (gk[~pm] != 0).any():
            fail(f"{what} {term}: a padded point has a grad")
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def call():
        x = pred.clone().requires_grad_()
        cd, group = headline_terms(x, gt, "auto", pm, gm)
        loss = cd + HEAD_GROUP_WEIGHT * group
        loss.backward()
        return loss.item()  # waits for the forward

    def headline():
        for _ in range(HEAD_CALLS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

    launches = drive(wrappers, HEAD_MASKED_KERNELS if masked else
                     HEAD_KERNELS, what, headline)
    print(f"{what} median {statistics.median(times)!r} ms per call "
          f"(value and grad) over {len(times)} calls: {times}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev)} bytes")
    headline_shares(torch, what, call)
    return [launches], {f"{what} B={b} N={n} P={p}": call}


def phase_knn(torch, dev, wrappers, masked=False):
    """Config 6 (or 6m, with 75% prefix-valid support masks): ops.knn(x,
    x, 16) at B=16 N=16384, the Morton-ring path; then, unmasked, the ring
    stats twin on the same clouds."""
    from pytorch_points_tpu_torch.kernels import topk_scan
    from pytorch_points_tpu_torch.ops import knn, knn_path

    b, n, k = CONFIG6["b"], CONFIG6["n"], CONFIG6["k"]
    cfg = "config 6m" if masked else "config 6"
    print(f"== phase {9 if masked else 8}: {cfg}, knn(x, x, {k}) at B={b} "
          f"N={n}" + (f", {VALID_SHARE:.0%} prefix-valid support masks"
                      if masked else ""))
    x = torch.from_numpy(cloud(np.random.default_rng(SEED + 9), b, n)).to(dev)
    mask = prefix_mask(torch, b, n, dev) if masked else None
    path = knn_path(x, x, k, mask)
    print(f"knn_path: {path}")
    if path != ("ring_masked" if masked else "ring"):
        fail(f"{cfg}: kNN took the {path} path")
    times, outs = [], []

    def run():
        for _ in range(KNN_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(knn(x, x, k, support_mask=mask))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

    with torch.inference_mode():
        knn(x, x, k, support_mask=mask)  # warm-up, uncounted
        counts = [drive(wrappers, ("knn_ring_masked",) if masked else
                        ("knn_ring",), cfg, run)]
        d, i = outs[0]
        ref = knn(x, x, k, support_mask=mask, impl="torch")
        if d.shape != (b, n, k) or not torch.isfinite(d).all():
            fail(f"{cfg}: bad output {tuple(d.shape)} / non-finite")
        if not (torch.equal(d, ref[0]) and torch.equal(i, ref[1])):
            fail(f"{cfg}: kernels differ from the plain versions")
        if not all(torch.equal(o[1], i) for o in outs):
            fail(f"{cfg}: two calls on the same clouds differ")
        if masked and not (i < int(n * VALID_SHARE)).all():
            fail(f"{cfg}: an invalid support point was returned")
        print(f"{cfg} median {statistics.median(times)!r} ms per call over "
              f"{len(times)} calls: {times}; equal to the plain versions; "
              f"mean k-th distance {d[..., -1].mean().item()!r}")
        items, counted, marker = traced(
            torch, lambda: knn(x, x, k, support_mask=mask), KNN_TRACED)
        ring_ms, glue_ms, glue_items = ring_split(items, counted)
        busy = ring_ms + glue_ms
        print(f"{cfg}: {'K10' if masked else 'K9'} (box table and scan) "
              f"{ring_ms!r} ms of {busy!r} ms device time a call, share "
              f"{ring_ms / busy if busy else float('nan')!r}; the rest "
              f"{glue_ms!r} ms in {glue_items!r} device items{marker}")
        if not masked:
            got = []
            counts.append(drive(
                wrappers, ("knn_ring_stats",), "config 6 ring stats",
                lambda: got.append(topk_scan.knn_ring_stats(x, x, k))))
            plain = topk_scan.knn_ring_stats(x, x, k, impl="torch")
            if got[0][2] != plain[2] or not torch.equal(got[0][1], i):
                fail(f"ring stats differ from the plain version: {got[0][2]}"
                     f" vs {plain[2]}")
            st = got[0][2]
            print(f"ring stats at {cfg} (equal to the plain version's): "
                  f"visit rate {st['visit_rate']!r}, steps per visit "
                  f"{st['steps_per_visit']!r}, trips per visit "
                  f"{st['trips_per_visit']!r}, {st['chunks']} chunks")

    def call():
        with torch.inference_mode():
            return knn(x, x, k, support_mask=mask)[0].sum().item()

    return counts, {f"{cfg} knn B={b} N={n} k={k}": call}


def ring_split(items, counted):
    """(ms of the ring scan's kernels, ms of the other device items, their
    count) a call, from :func:`traced`'s items: the box table and scan
    kernels (names holding "knn_ring") against the glue around them."""
    ring = [v for name, v in items.items() if "knn_ring" in name]
    rest = [v for name, v in items.items() if "knn_ring" not in name]
    return (sum(us for us, _ in ring) / 1e3 / counted,
            sum(us for us, _ in rest) / 1e3 / counted,
            sum(n for _, n in rest) / counted)


def median_ms(torch, fn, calls):
    """Median host ms of ``calls`` synchronised calls."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_fused(torch, dev, wrappers):
    """The fused SA front half (``_bq_group_centered``, the reference's
    ``ops/grouping.py:302-330``) forward and backward at the serve and the
    headline shapes, held against ``ball_query`` + ``group_points`` and the
    plain versions, timed beside the unfused form. The reference's own
    comment (``grouping.py:370-375``) says the fused form lost on its TPU;
    both are timed here and nothing is claimed."""
    from pytorch_points_tpu_torch.kernels import ballquery, fps
    from pytorch_points_tpu_torch.ops import ball_query, group_points
    from pytorch_points_tpu_torch.ops.grouping import _bq_group_centered

    print("== phase 11: fused SA front half, _bq_group_centered forward and "
          f"backward (r={RADIUS1}, ns={NSAMPLE})")
    rng = np.random.default_rng(SEED + 14)
    counts, calls = [], {}
    for tag, b, n, p in (("serve", SLICE["b"], SLICE["n"], NPOINT1),
                         ("headline", HEAD["b"], HEAD["n"], HEAD["p"])):
        label = f"{tag} B={b} N={n} P={p}"
        xyz = torch.from_numpy(cloud(rng, b, n)).to(dev)
        with torch.inference_mode():
            cen = fps.furthest_point_sample(xyz, p, emit_coords=True,
                                              impl="cuda")[1]
        w = torch.from_numpy(rng.standard_normal(
            (b, p, NSAMPLE, 3)).astype(np.float32)).to(dev)

        def fused(impl, xyz=xyz, cen=cen, w=w):
            x, c = xyz.clone().requires_grad_(), cen.clone().requires_grad_()
            idx, cnt, g = _bq_group_centered(x, c, RADIUS1, NSAMPLE,
                                             impl=impl)
            (g * w).sum().backward()
            return idx, cnt, g.detach(), x.grad, c.grad

        def unfused(xyz=xyz, cen=cen, w=w):
            x, c = xyz.clone().requires_grad_(), cen.clone().requires_grad_()
            idx, _ = ball_query(x, c, RADIUS1, NSAMPLE)
            g = group_points(x, idx) - c[:, :, None, :]
            (g * w).sum().backward()

        got, ref = fused("cuda"), fused("torch")  # uncounted
        idx, cnt, g, gx, gc = got
        with torch.inference_mode():
            bq = ball_query(xyz, cen, RADIUS1, NSAMPLE, impl="cuda")
            grouped = group_points(xyz, idx, "cuda") - cen[:, :, None, :]
        if not (torch.equal(idx, bq[0]) and torch.equal(cnt, bq[1])):
            fail(f"fused {label}: idx/cnt differ from ball_query's")
        if not torch.equal(g, grouped):
            fail(f"fused {label}: coordinates differ from group_points - "
                 "centroids")
        for name, a, r in zip(("idx", "cnt", "g", "centroid grad"),
                              (idx, cnt, g, gc), (*ref[:3], ref[4])):
            if a.dtype != r.dtype or not torch.equal(a, r):
                fail(f"fused {label}: {name} differs from the plain version")
        bound = scatter_bound(torch, idx.reshape(b, -1),
                              w.reshape(b, -1, 3), n)
        gap = (gx - ref[3]).abs()
        if not (gap <= bound).all():
            fail(f"fused {label}: xyz grad outside K4's summation-order "
                 f"bound of the plain version (max {gap.max().item()})")
        print(f"fused {label}: idx, cnt equal to ball_query; g bitwise equal "
              f"to group_points - centroids; g, centroid grad bitwise and "
              f"xyz grad within K4's bound of plain (max abs err "
              f"{gap.max().item()!r}); zero-hit rows "
              f"{(cnt == 0).sum().item()}")
        if tag == "headline":
            cen8 = xyz[:, :GRID_FORM["p"]].contiguous()
            with torch.inference_mode():
                resident = ballquery.ball_query_and_group_coords(
                    xyz, cen8, RADIUS1, NSAMPLE)
                grid = ballquery.ball_query_and_group_coords(
                    xyz, cen8, RADIUS1, NSAMPLE, tp=GRID_FORM["tp"])
            if not all(torch.equal(a, r) for a, r in zip(grid, resident)):
                fail("fused: the grid form differs from the resident form")
            print(f"grid form (P={GRID_FORM['p']}, tp={GRID_FORM['tp']}) "
                  "equal to the resident form")
        fused("cuda")  # warm-up, uncounted
        times = []

        def run(fused=fused, times=times):
            for _ in range(FUSED_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused("auto")
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)

        counts.append(drive(wrappers, FUSED_KERNELS, f"fused SA front half "
                            f"{label}", run))
        unfused()  # warm-up
        print(f"fused SA front half {label}: median "
              f"{statistics.median(times)!r} ms per call (forward and "
              f"backward) over {len(times)}: {times}; unfused ball_query + "
              f"group_points - centroids: median "
              f"{median_ms(torch, unfused, FUSED_CALLS)!r} ms")
        calls[f"fused SA front half {label}"] = (
            lambda fused=fused: fused("auto"))
    return counts, calls


def phase_pruned(torch, dev, wrappers):
    """nn_both_directions_pruned at B=32 N=M=16384 with the reference's
    tiles: (a) q a per-cloud shuffle of p, where the worklist answers; (b)
    independent clouds, where too many tile pairs are candidates and the
    dense kernel K5 answers. Each equal to K5 on the same (tie-free)
    clouds, timed beside it."""
    from pytorch_points_tpu_torch.kernels import distance_tiles as dt

    b, n = PRUNED["b"], PRUNED["n"]
    print(f"== phase 12: pruned NN, nn_both_directions_pruned at B={b} "
          f"N=M={n}, default tiles")
    rng = np.random.default_rng(SEED + 16)
    p = cloud(rng, b, n)
    counts, calls = [], {}
    for label, q, want in (("(a) q = shuffled p", shuffled(rng, p),
                            "nn_worklist"),
                           ("(b) independent clouds", cloud(rng, b, n),
                            "nn_dense")):
        pt, qt = (torch.from_numpy(a).to(dev) for a in (p, q))
        plan = dt.pruned_plan(pt, qt)
        cnt, k_max = plan["count"], plan["k_max"]
        share = (cnt.float() / (plan["ni"] * plan["nj"])).mean().item()
        print(f"pruned NN {label}: candidate pairs per cloud "
              f"{cnt.min().item()}-{cnt.max().item()} of "
              f"{plan['ni'] * plan['nj']} (share {share!r}), k_max {k_max}")
        outs, times = [], []
        with torch.inference_mode():
            dense = dt.nn_both_directions(pt, qt, impl="cuda")
            dt.nn_both_directions_pruned(pt, qt)  # warm-up, uncounted

            def run(pt=pt, qt=qt, outs=outs, times=times):
                for _ in range(PRUNED_CALLS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs.append(dt.nn_both_directions_pruned(pt, qt))
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)

            launched = drive(wrappers, (want,), f"pruned NN {label}", run)
            other = "nn_dense" if want == "nn_worklist" else "nn_worklist"
            if launched[other]:
                fail(f"pruned NN {label}: the {other} branch ran too")
            for out in outs:
                for g, r in zip(out, dense, strict=True):
                    if g.dtype != r.dtype or not torch.equal(g, r):
                        fail(f"pruned NN {label}: differs from K5")
            dense_ms = median_ms(
                torch, lambda pt=pt, qt=qt: dt.nn_both_directions(pt, qt),
                PRUNED_CALLS)
        counts.append(launched)
        print(f"pruned NN {label}: equal to K5 (distances bitwise, indices "
              f"equal); median {statistics.median(times)!r} ms per call "
              f"over {len(times)}: {times}; dense K5 both directions median "
              f"{dense_ms!r} ms")

        def call(pt=pt, qt=qt):
            with torch.inference_mode():
                return dt.nn_both_directions_pruned(pt, qt)[0].sum().item()

        calls[f"pruned NN {label} B={b} N={n}"] = call
    return counts, calls


def check_assignment(torch, label, p, q, dist, assign):
    """Every assignment a permutation, dist its matched squared distances
    (bitwise, in the op's own arithmetic), all finite."""
    b, n, _ = p.shape
    if dist.shape != (b, n) or assign.shape != (b, n):
        fail(f"{label}: shapes {tuple(dist.shape)} {tuple(assign.shape)}")
    iota = torch.arange(n, device=assign.device, dtype=assign.dtype)
    if not (torch.sort(assign, 1).values == iota).all():
        fail(f"{label}: an assignment is not a permutation")
    diff = p - q.gather(1, assign.long()[..., None].expand(-1, -1, 3))
    dx, dy, dz = diff.unbind(-1)
    if not torch.isfinite(dist).all() or not torch.equal(
            dist, (dx * dx + dy * dy) + dz * dz):
        fail(f"{label}: dist is not the matched squared distance")


def phase_emd(torch, dev, wrappers):
    from scipy.optimize import linear_sum_assignment

    from pytorch_points_tpu_torch.kernels import auction
    from pytorch_points_tpu_torch.ops import earth_mover_distance

    b, n = EMD4["b"], EMD4["n"]
    print(f"== phase 6: EMD (config 4), earth_mover_distance on B={b} N={n} "
          "standard-normal clouds")
    p, q = config4_clouds(torch, dev)
    print(f"hardness hint: {bool(auction._hardness_hint(p, q))}")
    earth_mover_distance(p, q)  # warm-up, uncounted
    times, outs = [], []

    def emd():
        for _ in range(EMD_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(earth_mover_distance(p, q))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

    launches = drive(wrappers, EMD_KERNELS, "config 4 EMD", emd)
    for dist, assign in outs:
        check_assignment(torch, "config 4", p, q, dist, assign)
        if not torch.equal(dist, outs[0][0]):
            fail("config 4: two calls on the same clouds differ")
    print(f"config 4 EMD median {statistics.median(times)!r} ms per call over "
          f"{len(times)} calls: {times}; mean matched d^2 "
          f"{outs[0][0].mean().item()!r}")

    # excess over the Hungarian optimum, as bench.py measures it
    qrng = np.random.default_rng(7)
    for kind, maker in (("normal", normal), ("gmm", gmm)):
        pa, qa = maker(qrng, EMD_ORACLE, n), maker(qrng, EMD_ORACLE, n)
        opt = []
        for bi in range(EMD_ORACLE):
            d2 = ((pa[bi, :, None, :].astype(np.float64)
                   - qa[bi, None, :, :]) ** 2).sum(-1)
            r, c = linear_sum_assignment(d2)
            opt.append(d2[r, c].mean())
        tp, tq = torch.from_numpy(pa).to(dev), torch.from_numpy(qa).to(dev)
        for pop in (768, 384):
            dist, assign = earth_mover_distance(tp, tq, endgame_pop_cap=pop)
            check_assignment(torch, f"{kind} pop {pop}", tp, tq, dist, assign)
            got = dist.double().mean(1).cpu().numpy()
            exc = [float(100.0 * (g - o) / o) for g, o in zip(got, opt)]
            print(f"EMD excess over the Hungarian optimum, {kind} clouds, "
                  f"pop cap {pop}, {EMD_ORACLE} elements at N={n}: mean "
                  f"{statistics.mean(exc)!r}% max {max(exc)!r}% min "
                  f"{min(exc)!r}%")
            if pop == 768 and max(exc) > EMD_EXCESS_BAR:
                fail(f"EMD {kind}: an element is {max(exc)}% over the "
                     f"optimum at pop cap 768 (bar {EMD_EXCESS_BAR}%)")
    return [launches], {f"config 4 EMD B={b} N={n}":
                        lambda: earth_mover_distance(p, q)[0].sum().item()}


def phase_metrics(torch, dev, wrappers):
    from pytorch_points_tpu_torch.losses import (
        coverage_and_mmd,
        one_nn_accuracy,
    )

    g, r, n = METRIC["g"], METRIC["r"], METRIC["n"]
    print(f"== phase 7: EMD metrics, coverage_and_mmd(metric='emd') at "
          f"G={g} R={r} N={n}")
    rng = np.random.default_rng(SEED + 7)
    gen = torch.from_numpy(normal(rng, g, n)).to(dev)
    ref = torch.from_numpy(np.concatenate(
        [normal(rng, r // 2, n), gmm(rng, r - r // 2, n)])).to(dev)
    small = [torch.from_numpy(normal(rng, 2, 256)).to(dev) for _ in range(2)]
    for name, fn in (("coverage_and_mmd", coverage_and_mmd),
                     ("one_nn_accuracy", one_nn_accuracy)):
        got = fn(*small, metric="emd", impl="cuda")
        want = fn(*small, metric="emd", impl="torch")
        got, want = (torch.stack(list(x)) if isinstance(x, tuple) else x
                     for x in (got, want))
        if not torch.equal(got, want):
            fail(f"{name} (G=R=2 N=256): kernels {got.tolist()} vs plain "
                 f"{want.tolist()}")
        print(f"{name} at G=R=2 N=256: kernels equal plain, {got.tolist()}")
    out = []

    def metric():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cov, mmd = coverage_and_mmd(gen, ref, metric="emd")
        out.append((cov.item(), mmd.item(), time.perf_counter() - t0))

    launches = drive(wrappers, EMD_KERNELS, "EMD metrics", metric)
    cov, mmd, secs = out[0]
    print(f"coverage {cov!r} MMD {mmd!r} in {secs * 1e3!r} ms ({g * r} "
          "pair solves in batches of 32)")
    if not (0.0 <= cov <= 1.0 and np.isfinite(mmd) and mmd > 0.0):
        fail(f"EMD metrics out of range: coverage {cov} MMD {mmd}")
    return [launches], {}


def served(torch, model, x):
    """One request: ``model(x)`` under inference_mode, to the host."""
    with torch.inference_mode():
        return model(x).cpu()


def phase_upsampler(torch, dev, wrappers):
    """Config 7: the full-width PointUpsampler from 2048 to 8192 points at
    B=8, served, then trained on the Chamfer distance (the sorted scan,
    K6), then a step on Chamfer + 0.1 repulsion (the ring kNN, K9);
    UniformLoss on its output, and a DenseEdgeConv graph in feature space
    (K8 over 24 channels)."""
    from pytorch_points_tpu_torch.layers import DenseEdgeConv
    from pytorch_points_tpu_torch.losses import (
        ChamferLoss,
        RepulsionLoss,
        UniformLoss,
    )
    from pytorch_points_tpu_torch.models import PointUpsampler
    from pytorch_points_tpu_torch.ops import (
        chamfer_distance,
        chamfer_path,
        knn_path,
    )
    from pytorch_points_tpu_torch.parallel import make_train_step

    b, n, r = CONFIG7["b"], CONFIG7["n"], CONFIG7["ratio"]
    print(f"== phase 13: config 7, PointUpsampler(ratio={r}) at B={b}, "
          f"{n} -> {n * r} points: serve, train on chamfer_distance with "
          f"Adam lr 1e-3, a step on ChamferLoss + 0.1 RepulsionLoss, "
          f"UniformLoss, DenseEdgeConv on a feature-space graph")
    rng = np.random.default_rng(SEED + 20)
    batches = [{"x": torch.from_numpy(cloud(rng, b, n)).to(dev),
                "y": torch.from_numpy(cloud(rng, b, n * r)).to(dev)}
               for _ in range(TRAIN_STEPS)]
    x, y = batches[0]["x"], batches[0]["y"]
    gen = torch.Generator().manual_seed(SEED)
    model = PointUpsampler(r, device=dev, generator=gen)
    launches, calls = [], {}

    with torch.inference_mode():
        pred = model(x)  # warm-up, uncounted
        print(f"model: {sum(p.numel() for p in model.parameters())} "
              f"parameters, channels 24, growth rate 24, dense_n 3, k 16, "
              f"LayerNorm, f32; chamfer path "
              f"{chamfer_path(pred, y, reduction='mean')}; repulsion kNN "
              f"path {knn_path(pred, pred, REPULSION_K)}")
        err = (pred - model(x, impl="torch")).abs().max().item()
        if pred.shape != (b, n * r, 3) or not torch.isfinite(pred).all():
            fail(f"config 7 serve: bad output {tuple(pred.shape)} or "
                 "non-finite")
        if err > SERVE_TOL:
            fail(f"config 7 serve: kernels vs plain versions differ by {err}")
        lat = []

        def serve():
            for batch in batches:
                t0 = time.perf_counter()
                model(batch["x"]).cpu()  # .cpu() waits for the card
                lat.append((time.perf_counter() - t0) * 1e3)

        launches.append(drive(wrappers, CONFIG7_SERVE_KERNELS,
                              "config 7 serve", serve))
    print(f"config 7 serve median {statistics.median(lat)!r} ms over "
          f"{len(lat)} requests (device in, numpy out); max |kernels - "
          f"plain| = {err!r}")
    calls[f"config 7 serve B={b} N={n}"] = functools.partial(
        served, torch, model, x)

    def chamfer_loss(m, batch, impl="auto"):
        return chamfer_distance(m(batch["x"], impl=impl), batch["y"],
                                impl=impl)

    def repulsion_loss(m, batch, impl="auto"):
        pred = m(batch["x"], impl=impl)
        return (ChamferLoss(impl=impl)(pred, batch["y"])
                + 0.1 * RepulsionLoss(impl=impl)(pred))

    medians = {}
    for label, loss_fn, required, steps in (
            ("config 7, chamfer", chamfer_loss, CONFIG7_TRAIN_KERNELS,
             batches),
            ("config 7, ChamferLoss + 0.1 RepulsionLoss", repulsion_loss,
             (*CONFIG7_TRAIN_KERNELS, "knn_ring"), batches[:1])):
        print(f"-- {label}")
        first_step_gate(torch, model, lambda impl, f=loss_fn: f(
            model, batches[0], impl), label)
        step = make_train_step(model,
                               torch.optim.Adam(model.parameters(), 1e-3),
                               loss_fn)
        counts, medians[label] = train_run(torch, dev, wrappers, required,
                                           label, step, steps)
        launches.append(counts)
        calls[f"train step, {label}, B={b} {n}->{n * r}"] = (
            lambda step=step: step(batches[0]).item())

    with torch.inference_mode():
        pred = model(x)
        got = {}

        def evaluate():
            got["cuda"] = UniformLoss()(pred).item()

        launches.append(drive(wrappers, UNIFORM_KERNELS,
                              "config 7 UniformLoss", evaluate))
        got["torch"] = UniformLoss(impl="torch")(pred).item()
        print(f"UniformLoss on the prediction: kernels {got['cuda']!r}, "
              f"plain {got['torch']!r}")
        if got["cuda"] != got["torch"] or not np.isfinite(got["cuda"]):
            fail("config 7 UniformLoss differs from the plain versions")

        f = model.lift(x)
        conv = DenseEdgeConv(24, 24, device=dev, generator=gen)
        out = {}

        def feature_graph():
            out["cuda"] = conv(f)
            torch.cuda.synchronize()

        launches.append(drive(wrappers, CONFIG7_SERVE_KERNELS,
                              "config 7 DenseEdgeConv, feature-space graph",
                              feature_graph))
        err = (out["cuda"] - conv(f, impl="torch")).abs().max().item()
        print(f"DenseEdgeConv(24, 24), xyz=None, on the lifted features "
              f"{tuple(f.shape)}: out {tuple(out['cuda'].shape)}, max "
              f"|kernels - plain| = {err!r}")
        if not torch.isfinite(out["cuda"]).all() or err > SERVE_TOL:
            fail("config 7 DenseEdgeConv: kernels vs plain versions differ "
                 f"by {err}")
    print("config 7 train step medians: " + "; ".join(
        f"{label} {ms!r} ms" for label, ms in medians.items()))
    return launches, calls


def phase_semseg(torch, dev, wrappers):
    """Config 8: the full-width PointNet2SemSeg trained at B=16 N=2048, 13
    classes, on softmax cross-entropy averaged over every point; its
    forward on 75%-valid masks; PointNet2Classifier(40) served."""
    import torch.nn.functional as F

    from pytorch_points_tpu_torch.models import (
        PointNet2Classifier,
        PointNet2SemSeg,
    )
    from pytorch_points_tpu_torch.parallel import make_train_step

    b, n, c = SEMSEG["b"], SEMSEG["n"], SEMSEG["classes"]
    print(f"== phase 14: config 8, PointNet2SemSeg({c}) trained at B={b} "
          f"N={n} with Adam lr 1e-3 on softmax cross-entropy, its masked "
          f"forward, and PointNet2Classifier({CLASSIFIER_CLASSES}) served")
    rng = np.random.default_rng(SEED + 21)
    batches = [{"x": torch.from_numpy(cloud(rng, b, n)).to(dev),
                "labels": torch.from_numpy(rng.integers(0, c, (b, n))).to(
                    dev)} for _ in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(SEED)
    model = PointNet2SemSeg(c, device=dev, generator=gen)
    print(f"model: {sum(p.numel() for p in model.parameters())} parameters,"
          f" npoint {NPOINT1}/{NPOINT2}, LayerNorm, f32")

    def loss_fn(m, batch, impl="auto"):
        logits = m(batch["x"], impl=impl)
        return F.cross_entropy(logits.reshape(-1, c),
                               batch["labels"].reshape(-1))

    label = "config 8, cross-entropy"
    first_step_gate(torch, model, lambda impl: loss_fn(model, batches[0],
                                                       impl), label)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3),
                           loss_fn)
    counts, median = train_run(torch, dev, wrappers, SEMSEG_KERNELS, label,
                               step, batches)
    launches = [counts]
    calls = {f"train step, {label}, B={b} N={n}":
             lambda: step(batches[0]).item()}

    x = batches[0]["x"]
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < VALID_SHARE).to(dev)
    cls = PointNet2Classifier(CLASSIFIER_CLASSES, device=dev, generator=gen)
    with torch.inference_mode():
        out = {}

        def masked_forward():
            out["logits"] = model(x, mask).cpu()

        launches.append(drive(wrappers, SERVE_KERNELS,
                              "config 8 masked forward", masked_forward))
        logits = out["logits"]
        err = (logits - model(x, mask, impl="torch").cpu()).abs().max()
        print(f"SemSeg on {VALID_SHARE:.0%}-valid masks: logits "
              f"{tuple(logits.shape)}, masked rows all 0: "
              f"{bool((logits[~mask.cpu()] == 0).all())}; max |kernels - "
              f"plain| = {err.item()!r}")
        if (not torch.isfinite(logits).all() or err > SERVE_TOL
                or (logits[~mask.cpu()] != 0).any()):
            fail("config 8 masked forward: non-finite, unmasked padding or "
                 "differs from the plain versions")

        cls(x)  # warm-up, uncounted
        lat = []

        def classify():
            for batch in batches:
                t0 = time.perf_counter()
                out["cls"] = cls(batch["x"]).cpu()
                lat.append((time.perf_counter() - t0) * 1e3)

        launches.append(drive(wrappers, CLASSIFIER_KERNELS,
                              "config 8 classifier serve", classify))
        err = (out["cls"] - cls(batches[-1]["x"], impl="torch").cpu()
               ).abs().max().item()
        print(f"classifier serve median {statistics.median(lat)!r} ms over "
              f"{len(lat)} requests, logits {tuple(out['cls'].shape)}; max "
              f"|kernels - plain| = {err!r}")
        if not torch.isfinite(out["cls"]).all() or err > SERVE_TOL:
            fail(f"config 8 classifier: kernels vs plain versions differ by "
                 f"{err}")
    calls[f"config 8 classifier serve B={b} N={n}"] = functools.partial(
        served, torch, cls, x)
    print(f"config 8 train step median {median!r} ms")
    return launches, calls


def config10_loss(m, batch, impl="auto"):
    """bench.py's config-10 loss: the masked chamfer of the reconstruction."""
    from pytorch_points_tpu_torch.ops import chamfer_distance

    pred = m(batch["points"], batch["mask"], impl=impl)
    return chamfer_distance(pred, batch["points"], p_mask=batch["mask"],
                            q_mask=batch["mask"], impl=impl)


def phase_config10(torch, dev, wrappers):
    """Config 10: PLY folder -> BucketedBatcher -> Prefetcher -> Trainer,
    with the native reader, a checkpoint and an export round trip, in a
    directory under the checkout's git-ignored build/."""
    import tempfile

    from pytorch_points_tpu_torch import _native

    cfg = CONFIG10
    print(f"== phase 15: config 10, {cfg['count']} PLY clouds -> "
          f"BucketedBatcher(B={cfg['batch']}, multiple={cfg['multiple']}, "
          f"max_buckets={cfg['max_buckets']}) -> Prefetcher -> Trainer, "
          f"PointCloudAutoencoder({cfg['npoint1']}, {cfg['npoint2']}), masked "
          "chamfer, Adam lr 1e-3")
    t0 = time.perf_counter()
    native = _native.available()
    print(f"native library: loaded {native} in {time.perf_counter() - t0!r} "
          f"s (g++ into {_native.BUILD_DIR.relative_to(ROOT)})")
    if not native:
        fail("config 10: the native host library did not build or load")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="config10_",
                                     dir=ROOT / "build") as work:
        return config10_run(torch, dev, wrappers, Path(work))


def config10_run(torch, dev, wrappers, work):
    from pytorch_points_tpu_torch.data import (
        BucketedBatcher,
        PlyFolderDataset,
        Prefetcher,
    )
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.utils import (
        Trainer,
        export_forward,
        load_exported,
    )

    cfg = CONFIG10
    load_example("train_on_ply_dataset").make_dataset(str(work / "ply"),
                                                      count=cfg["count"])
    ds = PlyFolderDataset(str(work / "ply"))
    sizes = [ds[i].shape[0] for i in range(len(ds))]

    def batcher():
        return BucketedBatcher(ds, batch_size=cfg["batch"],
                               multiple=cfg["multiple"],
                               max_buckets=cfg["max_buckets"], shuffle=True,
                               seed=0, drop_remainder=True)

    batches = batcher()
    per_epoch = sum(1 for _ in batcher())
    print(f"dataset: {len(ds)} clouds of {min(sizes)}-{max(sizes)} points; "
          f"buckets {batches.buckets}; {per_epoch} batches an epoch")

    def on_card(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def stream(epochs):
        for _ in range(epochs):
            for b in batches:
                yield on_card(b)

    gen = torch.Generator().manual_seed(SEED)
    model = PointCloudAutoencoder(cfg["npoint1"], cfg["npoint2"], device=dev,
                                  generator=gen)
    fixed = on_card(next(iter(batcher())))
    first_step_gate(torch, model, lambda impl: config10_loss(model, fixed,
                                                             impl),
                    "config 10")

    losses = []
    trainer = Trainer(model, torch.optim.Adam(model.parameters(), 1e-3),
                      config10_loss, ckpt_dir=str(work / "ckpt"),
                      log_every=1, ckpt_every=10**9)
    trainer.fit(stream(1), on_log=lambda step, loss: losses.append(loss))
    warm_steps = trainer.step
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    # timed as bench.py times it: no log point and no checkpoint inside
    trainer.log_every, trainer.ckpt_dir = 10**9, None
    out = {}

    def timed():
        t0 = time.perf_counter()
        out["last"] = trainer.fit(Prefetcher(stream(cfg["epochs"]),
                                             depth=cfg["depth"]))
        out["s"] = time.perf_counter() - t0  # fit ends on the loss's .item()

    launches = [drive(wrappers, CONFIG10_KERNELS, "config 10 training",
                      timed)]
    steps = trainer.step - warm_steps
    ms_step = out["s"] * 1e3 / steps
    print(f"config 10: {ms_step!r} ms/step over {steps} steps timed "
          f"({cfg['epochs']} epochs through Prefetcher(depth="
          f"{cfg['depth']}) after {warm_steps} warm steps); loss first "
          f"{losses[0]!r}, last {out['last']!r}")
    if not (np.isfinite(losses).all() and np.isfinite(out["last"])
            and out["last"] < losses[0]):
        fail(f"config 10: losses not finite or not lower: first "
             f"{losses[0]}, warm epoch {losses}, last {out['last']}")

    def epoch():
        trainer.fit(Prefetcher(stream(1), depth=cfg["depth"]))

    items, counted, marker = traced(torch, epoch, cfg["traced_epochs"])
    busy = sum(us for us, _ in items.values()) / 1e3 / (counted * per_epoch)
    print(f"config 10 device busy {busy!r} ms/step over {counted} traced "
          f"epochs; idle share {1 - busy / ms_step!r} of the untraced "
          f"{ms_step!r} ms/step{marker}")

    fresh = PointCloudAutoencoder(
        cfg["npoint1"], cfg["npoint2"], device=dev,
        generator=torch.Generator().manual_seed(SEED + 1))
    restorer = Trainer(fresh, torch.optim.Adam(fresh.parameters()),
                       config10_loss, ckpt_dir=str(work / "ckpt"))
    restorer.restore(step=warm_steps)
    if any(not torch.equal(v, snapshot[k])
           for k, v in fresh.state_dict().items()):
        fail("config 10: the restored checkpoint differs from the model")
    print(f"checkpoint of step {warm_steps} restored bitwise into a fresh "
          "model")

    x = fixed["points"]
    path = work / "autoencoder.pt2"
    with torch.no_grad():
        t0 = time.perf_counter()
        blob = export_forward(model, x, path=str(path))
        program = load_exported(str(path))
        print(f"export_forward: {len(blob)} bytes in "
              f"{time.perf_counter() - t0!r} s (export, save, load)")
        want = model(x)
        got = {}

        def loaded():
            got["y"] = program(x)
            torch.cuda.synchronize()

        launches.append(drive(wrappers, SERVE_KERNELS,
                              "config 10 exported forward", loaded))
        same = torch.equal(got["y"], want)
        print(f"exported forward equal to eager bitwise: {same}; max |diff| "
              f"{(got['y'] - want).abs().max().item()!r}")
        if not same:
            fail("config 10: the exported program differs from the eager "
                 "forward")
    return launches, {
        f"config 10 train step, bucket {tuple(x.shape)}":
            lambda: trainer.step_fn(fixed).item()}


def lexsort_rows(torch, x):
    """[B,P,3] -> [B,P] int64: each cloud's rows in (x, y, z) order."""
    order = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for d in (2, 1, 0):  # least significant key first, stable sorts
        key = x[..., d].gather(1, order)
        order = order.gather(1, torch.sort(key, dim=1, stable=True).indices)
    return order


def ball_counts(torch, centers, xyz, radius, chunk=256):
    """[B,P,3], [B,N,3] -> [B,P] uncapped counts of the points strictly
    within ``radius`` of each centre, in the ball query's diff^2 form,
    ``chunk`` centres at a time."""
    out = []
    r2 = np.float32(radius) * np.float32(radius)
    for s in range(0, centers.shape[1], chunk):
        d = centers[:, s:s + chunk, None, :] - xyz[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[
            ..., 2]
        out.append((d2 < float(r2)).sum(-1))
    return torch.cat(out, dim=1)


def phase_sorted(torch, dev, wrappers):
    """Config 3s: the Morton-consistent SA front half at B=16 N=16384,
    held bitwise to its plain versions and, as a set, to
    ``sample_and_group``'s; timed beside config 3."""
    from pytorch_points_tpu_torch.ops import (
        ball_query,
        sample_and_group,
        sample_and_group_sorted,
    )

    b, n, p = CONFIG3S["b"], CONFIG3S["n"], CONFIG3S["p"]
    print(f"== phase 16: config 3s, sample_and_group_sorted(x, None, {p}, "
          f"{NSAMPLE}, {RADIUS1}) at B={b} N={n}, beside config 3's "
          "sample_and_group")
    rng = np.random.default_rng(SEED + 31)
    x = torch.from_numpy(cloud(rng, b, n)).to(dev)

    def sorted_call(impl="auto"):
        return sample_and_group_sorted(x, None, p, NSAMPLE, RADIUS1,
                                       impl=impl)

    with torch.inference_mode():
        sorted_call()  # warm-up, uncounted
        out = {}

        def run():
            out["cuda"] = sorted_call()
            torch.cuda.synchronize()

        launches = drive(wrappers, ("fps", "ball_query", "gather"),
                         "config 3s", run)
        got, ref = out["cuda"], sorted_call("torch")
        names = ("new_xyz", "new_features", "idx", "grouped_xyz", "perm")
        for name, g, r in zip(names, got, ref, strict=True):
            if g.dtype != r.dtype or not torch.equal(g, r):
                fail(f"config 3s: {name} differs from the plain versions")
        cs, _, idx, _, perm = got
        new_xyz, _, idx0, _ = sample_and_group(x, None, p, NSAMPLE, RADIUS1)
        # centroid sets: both pipelines emit the same points' coordinates
        o_s, o_0 = lexsort_rows(torch, cs), lexsort_rows(torch, new_xyz)
        c_s = cs.gather(1, o_s[..., None].expand(-1, -1, 3))
        c_0 = new_xyz.gather(1, o_0[..., None].expand(-1, -1, 3))
        if not torch.equal(c_s, c_0):
            fail("config 3s: the centroid sets differ from "
                 "sample_and_group's")
        # neighbourhoods of balls of <= NSAMPLE points: idx (into the sorted
        # cloud) back to original indices, then row sets compared
        orig = perm.long().gather(1, idx.reshape(b, -1).long()).reshape(
            idx.shape)
        rows_s = torch.sort(orig.gather(1, o_s[..., None].expand(
            -1, -1, NSAMPLE)), dim=-1).values
        rows_0 = torch.sort(idx0.long().gather(1, o_0[..., None].expand(
            -1, -1, NSAMPLE)), dim=-1).values
        inside = ball_counts(torch, c_s, x, RADIUS1)
        small = inside <= NSAMPLE
        same = (rows_s == rows_0).all(-1)
        if not same[small].all():
            fail("config 3s: a ball of <= 32 points holds another "
                 "neighbourhood set than sample_and_group's")
        print(f"config 3s: all five outputs bitwise equal to the plain "
              f"versions; centroid sets equal to sample_and_group's in "
              f"every cloud; neighbourhood sets equal in all "
              f"{int(small.sum())} balls of <= {NSAMPLE} points, and in "
              f"{int(same[~small].sum())} of the {int((~small).sum())} "
              "saturated ones")
        ms_sorted = median_ms(torch, sorted_call, SORTED_CALLS)
        ms_plain = median_ms(torch, lambda: sample_and_group(
            x, None, p, NSAMPLE, RADIUS1), SORTED_CALLS)
        ms_bq = median_ms(torch, lambda: ball_query(x, cs, RADIUS1, NSAMPLE),
                          SORTED_CALLS)
    print(f"config 3s median {ms_sorted!r} ms, config 3 (sample_and_group) "
          f"{ms_plain!r} ms over {SORTED_CALLS} calls each; its ball query "
          f"alone {ms_bq!r} ms")
    return [launches], {
        f"config 3s sample_and_group_sorted B={b} N={n}": sorted_call,
        f"config 3 sample_and_group B={b} N={n}": lambda: sample_and_group(
            x, None, p, NSAMPLE, RADIUS1)}


def phase_config5b(torch, dev, wrappers):
    """Config 5b: config 5 (Chamfer + 0.1 EMD, pop cap 384, Adam 1e-3) on
    the autoencoder under the bf16 policy: bf16 features through the
    gather's bf16 instance."""
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.parallel import (
        make_train_step,
        reconstruction_loss,
    )

    b, n = SLICE["b"], SLICE["n"]
    print(f"== phase 17: config 5b, PointCloudAutoencoder(dtype=bfloat16) "
          f"trained at B={b} N={n} on Chamfer + 0.1 EMD (pop cap 384), Adam "
          "lr 1e-3")
    rng = np.random.default_rng(SEED + 2)  # phase 4's batches
    batches = [{"points": torch.from_numpy(cloud(rng, b, n)).to(dev)}
               for _ in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(SEED)
    model = PointCloudAutoencoder(NPOINT1, NPOINT2, dtype=torch.bfloat16,
                                  device=dev, generator=gen)
    with torch.inference_mode():
        pred = model(batches[0]["points"])
    print(f"prediction dtype {pred.dtype} (the residual promotes the bf16 "
          f"offsets); parameters {model.head.layers[0].weight.dtype}")
    loss_fn = reconstruction_loss(emd_kwargs=CONFIG5_EMD)
    first_step_gate(torch, model, lambda impl: reconstruction_loss(
        impl=impl, emd_kwargs=CONFIG5_EMD)(model, batches[0]), "config 5b",
        BF16_GRAD_TOL, ascending=True)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3),
                           loss_fn)
    counts, median = train_run(
        torch, dev, wrappers, (*TRAIN_KERNELS, *EMD_KERNELS, "gather_bf16"),
        "config 5b", step, batches)
    print(f"config 5b median {median!r} ms/step; config 5 in float32 "
          f"(phase 4) {MEASURED.get('config 5 f32 step ms')!r} ms/step")
    return [counts], {f"train step, config 5b (bf16), B={b} N={n}":
                      lambda: step(batches[0]).item()}


def peak_and_ms(torch, dev, step, batch):
    """(peak device bytes during one step after a warm-up step, median ms
    of REMAT_CALLS steps)."""
    step(batch).item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step(batch).item()
    peak = torch.cuda.max_memory_allocated(dev)
    return peak, median_ms(torch, lambda: step(batch).item(), REMAT_CALLS)


def phase_remat_bn(torch, dev, wrappers):
    """Remat and BatchNorm: (a) the autoencoder with remat=True and through
    Trainer(remat=True), grads held to remat=False; its peak memory and
    step time both ways at B=32 N=16384 on Chamfer alone; (b) norm="batch"
    trained 10 steps, its first step's grads and running statistics held to
    the plain versions', served in eval mode; (c) a remat step under
    BatchNorm leaves the running statistics of one plain step."""
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.parallel import (
        make_train_step,
        reconstruction_loss,
    )
    from pytorch_points_tpu_torch.utils import Trainer

    b, n = SLICE["b"], SLICE["n"]
    print(f"== phase 18: remat and BatchNorm on the autoencoder, B={b} "
          f"N={n}; remat's memory at B={REMAT['b']} N={REMAT['n']}")
    rng = np.random.default_rng(SEED + 32)
    batches = [{"points": torch.from_numpy(cloud(rng, b, n)).to(dev)}
               for _ in range(TRAIN_STEPS)]
    chamfer = reconstruction_loss(emd_weight=0)

    def model_of(**kw):
        return PointCloudAutoencoder(
            NPOINT1, NPOINT2, device=dev,
            generator=torch.Generator().manual_seed(SEED), **kw)

    def grads_of(model, step):
        step(batches[0])
        return [p.grad.detach().clone() for p in model.parameters()]

    print("-- (a) remat")
    plain = model_of()
    ref = grads_of(plain, make_train_step(
        plain, torch.optim.SGD(plain.parameters(), 0.0), chamfer))
    staged = model_of(remat=True)
    got = grads_of(staged, make_train_step(
        staged, torch.optim.SGD(staged.parameters(), 0.0), chamfer))
    whole = model_of()
    trainer = Trainer(whole, torch.optim.Adam(whole.parameters(), 1e-3),
                      chamfer, log_every=10**9, remat=True)
    got_whole = grads_of(whole, trainer.step_fn)
    gaps = (grad_gap(got, ref), grad_gap(got_whole, ref))
    print(f"remat first-step grads max |remat - plain| / max |plain|: each "
          f"SA/FP stage checkpointed {gaps[0]!r}, Trainer(remat=True) (the "
          f"whole loss) {gaps[1]!r} (bar {TRAIN_GRAD_TOL})")
    if max(gaps) > TRAIN_GRAD_TOL:
        fail("remat: first-step grads differ from remat=False")
    launches = []

    def remat_steps():
        trainer.fit(batches, prefetch=None)

    launches.append(drive(wrappers, TRAIN_KERNELS, "remat, Trainer(remat="
                          "True), chamfer", remat_steps))
    rb, rn = REMAT["b"], REMAT["n"]
    big = {"points": torch.from_numpy(cloud(rng, rb, rn)).to(dev)}
    memory = {}
    for remat in (False, True):
        model = model_of(remat=remat)
        step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                       1e-3), chamfer)
        if remat:
            def big_steps():
                memory[remat] = peak_and_ms(torch, dev, step, big)

            launches.append(drive(wrappers, (*HEAD_KERNELS, "knn"),
                                  f"remat, chamfer at B={rb} N={rn}",
                                  big_steps))
        else:
            memory[remat] = peak_and_ms(torch, dev, step, big)
        del model, step
    print(f"remat at B={rb} N={rn}, Chamfer alone: peak device memory "
          f"{memory[False][0]} bytes without, {memory[True][0]} bytes with "
          f"({memory[True][0] / memory[False][0]!r} of it); step "
          f"{memory[False][1]!r} ms without, {memory[True][1]!r} ms with")

    print("-- (b) norm=\"batch\"")
    model = model_of(norm="batch")
    first = first_step_gate(
        torch, model, lambda impl: reconstruction_loss(
            emd_weight=0, impl=impl)(model, batches[0]), "BatchNorm",
        ascending=True)
    stat_gap = max(((g - r).abs().max() / r.abs().max().clamp_min(1e-30)
                    ).item() for g, r in zip(first["kernels"][2],
                                             first["ascending"][2]))
    print(f"BatchNorm first step: running statistics max |kernels - plain| "
          f"/ max |plain| = {stat_gap!r} (bar {STAT_TOL}) over "
          f"{len(first['kernels'][2])} buffers")
    if stat_gap > STAT_TOL:
        fail("BatchNorm: running statistics differ from the plain versions")
    step = make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3),
                           chamfer)
    counts, bn_median = train_run(torch, dev, wrappers, TRAIN_KERNELS,
                                  "BatchNorm", step, batches)
    launches.append(counts)
    model.eval()
    with torch.inference_mode():
        x = batches[0]["points"]
        out = {}

        def serve():
            out["y"] = model(x).cpu()

        launches.append(drive(wrappers, SERVE_KERNELS, "BatchNorm serve "
                              "(eval)", serve))
        err = (out["y"] - model(x, impl="torch").cpu()).abs().max().item()
    print(f"BatchNorm eval serve: max |kernels - plain| = {err!r} (bar "
          f"{SERVE_TOL}); train median {bn_median!r} ms/step")
    if not torch.isfinite(out["y"]).all() or err > SERVE_TOL:
        fail("BatchNorm eval serve differs from the plain versions")

    print("-- (c) remat under BatchNorm")
    stats = []
    for remat in (False, True):
        m = model_of(norm="batch", remat=remat)
        make_train_step(m, torch.optim.SGD(m.parameters(), 0.0), chamfer)(
            batches[0]).item()
        stats.append([t.clone() for t in m.buffers()])
    same = all(torch.equal(a, r) for a, r in zip(*stats))
    print(f"one remat step's running statistics equal to one plain step's "
          f"(bitwise): {same}")
    if not same:
        fail("remat + BatchNorm: the recompute moved the running statistics")
    return launches, {
        f"train step, BatchNorm, B={b} N={n}": lambda: step(
            batches[0]).item()}


def cage_clouds(torch, dev, rng, b, n):
    """(source, target) [B,N,3]: points in the unit ball and their images
    squashed along y, inside the cage of radius 1.5."""
    src = rng.standard_normal((b, n, 3))
    src *= rng.uniform(0, 1, (b, n, 1)) ** (1 / 3) / np.linalg.norm(
        src, axis=-1, keepdims=True)
    tgt = src * np.array([1.0, 0.6, 1.0])
    return (torch.from_numpy(src.astype(np.float32)).to(dev),
            torch.from_numpy(tgt.astype(np.float32)).to(dev))


def phase_cages(torch, dev, wrappers):
    """The Neural Cages step: CageDeformer at its defaults deforms a
    source toward a target through the icosphere cage; Chamfer to the
    target + the cage's uniform Laplacian against the source cage's + the
    point Laplacian under the source's neighbourhoods, Adam 1e-3."""
    from pytorch_points_tpu_torch.losses import (
        ChamferLoss,
        MeshLaplacianLoss,
        PointLaplacianLoss,
    )
    from pytorch_points_tpu_torch.models import CageDeformer
    from pytorch_points_tpu_torch.parallel import make_train_step
    from pytorch_points_tpu_torch.utils import geometry_utils

    cfg = CAGES
    cv, cf = geometry_utils.generate_icosphere(cfg["subdivisions"],
                                               radius=cfg["radius"])
    edges = geometry_utils.mesh_edges(cf)
    b, n = cfg["b"], cfg["n"]
    print(f"== phase 19: Neural Cages, CageDeformer({len(cv)}) at its "
          f"defaults, cage generate_icosphere({cfg['subdivisions']}, radius="
          f"{cfg['radius']}), B={b} N={n}: ChamferLoss + MeshLaplacianLoss + "
          "PointLaplacianLoss, Adam lr 1e-3")
    rng = np.random.default_rng(SEED + 33)
    batches = [dict(zip(("source", "target"), cage_clouds(
        torch, dev, rng, b, n))) for _ in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(SEED)
    model = CageDeformer(len(cv), device=dev, generator=gen)
    cage = torch.from_numpy(cv).to(dev)
    terms = {}

    def loss_fn(m, batch, impl="auto"):
        deformed, new_cage, _ = m(batch["source"], batch["target"], cv, cf,
                                  impl=impl)
        terms["chamfer"] = ChamferLoss(impl=impl)(deformed, batch["target"])
        terms["cage"] = MeshLaplacianLoss(impl=impl)(
            new_cage, edges, cage.expand_as(new_cage))
        terms["points"] = PointLaplacianLoss(impl=impl)(batch["source"],
                                                        deformed)
        return terms["chamfer"] + terms["cage"] + terms["points"]

    print(f"model: {sum(p.numel() for p in model.parameters())} parameters")
    first_step_gate(torch, model, lambda impl: loss_fn(model, batches[0],
                                                       impl), "Neural Cages")
    values = {k: v.item() for k, v in terms.items()}
    print(f"first step terms (plain): {values}")
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"Neural Cages: non-finite loss terms {values}")
    step = make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3),
                           loss_fn)
    counts, median = train_run(
        torch, dev, wrappers, ("fps", "ball_query", "gather", "scatter",
                               "nn_dense", "knn"), "Neural Cages", step,
        batches)
    print(f"Neural Cages median {median!r} ms/step")
    return [counts], {f"train step, Neural Cages, B={b} N={n}":
                      lambda: step(batches[0]).item()}


RENDER_OUTPUTS = ("image", "alpha", "grad xyz", "grad normals")
RENDER_CAMERA = dict(eye=(1.5, 1.0, 2.5), focal=1.8)
RENDER_TAU = 1e-2  # render_points' default depth temperature


def dss_cloud(rng, b, n):
    """[B,N,3] float32 points near a sphere of radius 0.6."""
    x = rng.standard_normal((b, n, 3))
    return (0.6 * x / np.linalg.norm(x, axis=-1, keepdims=True)
            * (1 + 0.02 * rng.standard_normal((b, n, 1)))).astype(np.float32)


def dss_scene(torch, rng, x, nrm, size):
    """The render's inputs: the points and their normals, colours and the
    image's weighting drawn from ``rng``, and the camera."""
    from pytorch_points_tpu_torch import geo

    b, n = x.shape[:2]
    colors = torch.from_numpy(rng.uniform(0, 1, (b, n, 3)).astype(
        np.float32)).to(x.device)
    w = torch.from_numpy(rng.standard_normal((b, size, size, 3)).astype(
        np.float32)).to(x.device)
    return dict(xyz=x, normals=nrm, colors=colors, weights=w,
                camera=geo.Camera(**RENDER_CAMERA), size=size)


def render_scene(torch, scene, device, ewa, tau_scale=1.0):
    """render_points on ``device`` (EWA splats from the scene's normals, or
    isotropic), forward and backward of a fixed weighting of the image plus
    the coverage: [image, alpha, grad xyz (, grad normals)]."""
    from pytorch_points_tpu_torch import geo

    xs = scene["xyz"].detach().to(device).requires_grad_(True)
    ns = scene["normals"].detach().to(device).requires_grad_(True)
    img, alpha = geo.render_points(
        xs, scene["colors"].to(device), normals=ns if ewa else None,
        camera=scene["camera"], image_size=scene["size"], splat_radius=0.02,
        depth_temperature=RENDER_TAU * tau_scale,
        backface="soft" if ewa else "none")
    ((img * scene["weights"].to(device)).sum() + alpha.sum()).backward()
    return [img, alpha, xs.grad] + ([ns.grad] if ewa else [])


def render_gaps(got, ref):
    """{output: max |got - ref| / max |ref|}, each output on its own
    scale."""
    return {name: ((g.detach().cpu() - r.detach().cpu()).abs().max()
                   / r.detach().abs().max().clamp_min(1e-30)).item()
            for name, g, r in zip(RENDER_OUTPUTS, got, ref)}


def render_bar(scene):
    """RENDER_ULPS roundings of the scene's largest depth, as the soft
    z-buffer magnifies them (see RENDER_ULPS)."""
    depth = scene["camera"].project(scene["xyz"])[1].max().item()
    return RENDER_ULPS * 2.0**-24 * depth / RENDER_TAU


def phase_dss(torch, dev, wrappers):
    """DSS and the geometry: batch_normals (K8, K3) equal to its plain
    versions; render_points with EWA splats from those normals and with
    isotropic splats, forward and backward, each output within
    RENDER_ULPS roundings of the depth of the same call on the CPU (and a
    changed depth temperature outside them); the geometry losses and ops
    on the same clouds, held to the plain versions (the CPU where an op
    has no kernel)."""
    from pytorch_points_tpu_torch.losses import (
        MeshEdgeLengthLoss,
        NormalLoss,
        PointEdgeLengthLoss,
        SmapeLoss,
    )
    from pytorch_points_tpu_torch.ops import (
        batch_normals,
        normalize_point_batch,
        normalize_to_box,
        voxel_downsample_mask,
    )
    from pytorch_points_tpu_torch.utils import geometry_utils

    b, n, k, size = DSS["b"], DSS["n"], DSS["k"], DSS["image"]
    print(f"== phase 20: DSS and geometry, batch_normals(x, {k}) and "
          f"render_points at {size}x{size} on B={b} N={n} clouds; the "
          "geometry losses and ops")
    rng = np.random.default_rng(SEED + 34)
    x = torch.from_numpy(dss_cloud(rng, b, n)).to(dev)
    launches, out = [], {}
    with torch.inference_mode():
        def normals():
            out["n"] = batch_normals(x, k)
            torch.cuda.synchronize()

        launches.append(drive(wrappers, ("knn", "gather"),
                              "DSS batch_normals", normals))
        nrm = out["n"]
        if not torch.equal(nrm, batch_normals(x, k, impl="torch")):
            fail("batch_normals differs from the plain versions")
        print(f"batch_normals: {tuple(nrm.shape)}, equal to the plain "
              "versions bitwise")
    nrm = nrm.clone()  # a normal tensor: autograd may use it below
    scene = dss_scene(torch, rng, x, nrm, size)
    for ewa in (True, False):
        kind = "EWA (normals)" if ewa else "isotropic"
        ref = render_scene(torch, scene, "cpu", ewa)
        got = render_scene(torch, scene, dev, ewa)
        gaps = render_gaps(got, ref)
        bar = render_bar(scene)
        probe = render_gaps(render_scene(torch, scene, dev, ewa,
                                         1 + RENDER_PROBE), ref)
        ms = median_ms(torch, lambda ewa=ewa: render_scene(
            torch, scene, dev, ewa), 3)
        print(f"render_points {kind}: max |card - CPU| / max |CPU| {gaps} "
              f"(bar {bar!r}: {RENDER_ULPS} roundings of the depth through "
              f"the soft z-buffer); at depth temperature x (1 + "
              f"{RENDER_PROBE}) {probe} (must miss the bar); coverage "
              f"{got[1].mean().item()!r}; forward + backward {ms!r} ms "
              "(plain PyTorch)")
        if (max(gaps.values()) > bar
                or not all(torch.isfinite(g).all() for g in got)):
            fail(f"render_points ({kind}): the card differs from the CPU")
        if max(probe.values()) <= bar:
            fail(f"render_points ({kind}): the gate missed a change of "
                 "the depth temperature")

    cv, cf = geometry_utils.generate_icosphere(2)
    edges = geometry_utils.mesh_edges(cf)
    verts = torch.from_numpy((cv[None] * (1 + 0.05 * rng.standard_normal(
        (b, len(cv), 1)))).astype(np.float32)).to(dev)
    ref_v = torch.from_numpy(np.repeat(cv[None], b, 0).astype(
        np.float32)).to(dev)
    y = (x + 0.01 * torch.from_numpy(rng.standard_normal(
        (b, n, 3)).astype(np.float32)).to(dev))
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < VALID_SHARE).to(dev)
    with torch.inference_mode():
        kernel_ops = {  # name -> (loss of impl, its path's kernels)
            "NormalLoss": (lambda impl: NormalLoss(impl=impl)(y, nrm, x, nrm),
                           ("nn_dense", "gather")),
            "PointEdgeLengthLoss": (lambda impl: PointEdgeLengthLoss(
                impl=impl)(x, y), ("knn", "gather")),
            "MeshEdgeLengthLoss": (lambda impl: MeshEdgeLengthLoss(
                impl=impl)(verts, edges, ref_v), ("gather",)),
        }
        for name, (fn, required) in kernel_ops.items():
            def call(fn=fn, name=name):
                out[name] = fn("auto").item()

            launches.append(drive(wrappers, required, f"DSS {name}", call))
            plain = fn("torch").item()
            print(f"{name}: kernels {out[name]!r}, plain {plain!r}")
            if not np.isfinite(out[name]) or abs(out[name] - plain) > (
                    1e-6 * abs(plain)):
                fail(f"{name} differs from the plain versions")
        cpu_ops = {
            "SmapeLoss": lambda d: SmapeLoss()(y.to(d), x.to(d)),
            "normalize_point_batch": lambda d: normalize_point_batch(
                x.to(d), mask.to(d)),
            "normalize_to_box": lambda d: normalize_to_box(x.to(d),
                                                           mask.to(d)),
            "voxel_downsample_mask": lambda d: voxel_downsample_mask(
                x.to(d), 0.05, mask.to(d)),
        }
        for name, fn in cpu_ops.items():
            got = fn(dev)
            ref = fn("cpu")
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            gap = max((g.cpu().float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref, strict=True))
            print(f"{name}: max |card - CPU| = {gap!r}"
                  + (f"; kept {int(got[0].sum())} of {int(mask.sum())} valid"
                     if name == "voxel_downsample_mask" else ""))
            if gap > 1e-6:
                fail(f"{name}: the card differs from the CPU")
    return launches, {
        f"render_points EWA fwd+bwd B={b} N={n} {size}x{size}":
            lambda: render_scene(torch, scene, dev, True),
        f"batch_normals B={b} N={n} k={k}": lambda: batch_normals(x, k)}


PARALLEL = dict(b=32, n=16384, p=2048, ns=32, r=0.2)  # the headline's
PARALLEL_RANKS = 2  # ranks sharing cuda:0 over gloo
PARALLEL_TIMEOUT = 300  # s: the ranks' deadline
PARALLEL_PG_TIMEOUT = 120  # s: a collective's, so a failed rank ends the run
PARALLEL_CALLS = 3  # timed calls of an op with collectives (a fixed count:
# every rank must make the same calls)


def fixed_ms(torch, fn, calls=PARALLEL_CALLS):
    """Mean ms of ``calls`` calls after one warm-up call, on CUDA events:
    the same number of calls on every rank, unlike :func:`cuda_ms`."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def parallel_cases(torch, dev, wrappers, mesh, dmesh, tag):
    """The sharded ops and the data-parallel config-5 step on this rank's
    shards (the points axis of ``mesh``, the data axis of ``dmesh``), each
    held to its one-device counterpart on the same card: the NN (K13) and
    the ring (K5) bitwise equal to K5, the chamfer's value and grads within
    the smoke's grad bar of the one-device chamfer's, sample_and_group's
    outputs bitwise equal to ``ops.sample_and_group``'s, the sharded EMD a
    permutation with its matched distances, the step's loss, averaged
    grads and parameters within the grad bar of the one-device step's.
    Returns (launches of each driven run, figures for the printout)."""
    from pytorch_points_tpu_torch import parallel
    from pytorch_points_tpu_torch.kernels import distance_tiles
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.ops import (
        chamfer_distance,
        earth_mover_distance,
        sample_and_group,
    )

    group = mesh.get_group("points")
    w, r = group.size(), group.rank()
    b, n, npoint = PARALLEL["b"], PARALLEL["n"], PARALLEL["p"]
    m = n // w
    sl = slice(r * m, (r + 1) * m)
    rng = np.random.default_rng(SEED + 40)
    p = torch.from_numpy(cloud(rng, b, n)).to(dev)
    q = torch.from_numpy(cloud(rng, b, n)).to(dev)
    q_loc = q[:, sl].contiguous()
    launches, fig = [], {}
    k13 = distance_tiles.nn_one_direction_cuda

    def sync_run(key, fn, timed=None):
        """The driven run: its outputs in ``fig[key]``; with ``timed`` its
        host ms to a sync in ``fig[timed]`` (the slow ops' one call)."""
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fig[key] = fn()
            torch.cuda.synchronize()
            if timed:
                fig[timed] = (time.perf_counter() - t0) * 1e3
        return run

    # the NN with q sharded (K13) and the ring (K5) against K5 whole
    ref = distance_tiles.nn_both_directions(p, q)
    launches.append(drive(wrappers, ("nn_dense",), f"{tag} nndistance_sharded",
                          sync_run("nn", lambda: parallel.nndistance_sharded(
                              p, q_loc, mesh))))
    fig["K13 launches"] = k13.launches
    want = (ref[0], ref[1], ref[2][:, sl], ref[3][:, sl])
    if not all(torch.equal(g, x) for g, x in zip(fig.pop("nn"), want)):
        fail(f"{tag}: nndistance_sharded differs from the one-device K5")
    fig["nndistance_sharded ms"] = fixed_ms(
        torch, lambda: parallel.nndistance_sharded(p, q_loc, mesh))
    fig["K5 one-device ms"] = fixed_ms(
        torch, lambda: distance_tiles.nn_both_directions(p, q))
    p_loc = p[:, sl].contiguous()
    launches.append(drive(wrappers, ("nn_dense",), f"{tag} nndistance_ring",
                          sync_run("ring", lambda: parallel.nndistance_ring(
                              p_loc, q_loc, mesh))))
    want = (ref[0][:, sl], ref[1][:, sl], ref[2][:, sl], ref[3][:, sl])
    if not all(torch.equal(g, x) for g, x in zip(fig.pop("ring"), want)):
        fail(f"{tag}: nndistance_ring differs from the one-device K5")
    fig["nndistance_ring ms"] = fixed_ms(
        torch, lambda: parallel.nndistance_ring(p_loc, q_loc, mesh))

    # the chamfer, forward and backward, against the one-device chamfer
    def chamfer(sharded):
        pg = p.clone().requires_grad_()
        qg = (q_loc if sharded else q).clone().requires_grad_()
        loss = (parallel.chamfer_sharded(pg, qg, mesh) if sharded
                else chamfer_distance(pg, qg))
        loss.backward()
        return loss.detach(), pg.grad, qg.grad

    launches.append(drive(wrappers, ("nn_dense", "gather", "scatter"),
                          f"{tag} chamfer_sharded forward and backward",
                          sync_run("chamfer", lambda: chamfer(True))))
    got, one = fig.pop("chamfer"), chamfer(False)
    gap = grad_gap(got[1:], (one[1], one[2][:, sl]))
    loss_gap = abs(got[0].item() - one[0].item()) / abs(one[0].item())
    fig["chamfer loss rel gap"], fig["chamfer grad gap"] = loss_gap, gap
    if gap > HEAD_GRAD_TOL or loss_gap > HEAD_GRAD_TOL:
        fail(f"{tag}: chamfer_sharded's loss or grads differ from the "
             "one-device chamfer's")
    fig["chamfer_sharded fwd+bwd ms"] = fixed_ms(torch, lambda: chamfer(True))
    fig["chamfer one-device fwd+bwd ms"] = fixed_ms(
        torch, lambda: chamfer(False))

    # the SA front half: FPS sharded, then the query stages on the slice
    # of the centroids
    nsample, radius = PARALLEL["ns"], PARALLEL["r"]
    x_loc = p[:, sl].contiguous()
    launches.append(drive(
        wrappers, ("ball_query", "gather"),
        f"{tag} sample_and_group_sharded {n} -> {npoint}",
        sync_run("sag", lambda: parallel.sample_and_group_sharded(
            x_loc, None, npoint, nsample, radius, mesh),
            "sample_and_group_sharded ms (one call, host clock)")))
    one = sample_and_group(p, None, npoint, nsample, radius)
    ps = slice(r * npoint // w, (r + 1) * npoint // w)
    want = (one[0], one[1][:, ps], one[2][:, ps], one[3][:, ps])
    if not all(torch.equal(g, x) for g, x in zip(fig.pop("sag"), want)):
        fail(f"{tag}: sample_and_group_sharded differs from "
             "ops.sample_and_group")
    fig["sample_and_group one-device ms"] = fixed_ms(
        torch, lambda: sample_and_group(p, None, npoint, nsample, radius))

    # the sharded auction EMD at config 4's shapes, forward and backward
    ep, eq = config4_clouds(torch, dev)
    em = ep.shape[1] // w
    eq_loc = eq[:, r * em:(r + 1) * em].contiguous()

    def emd():
        pg = ep.clone().requires_grad_()
        dist, assign = parallel.earth_mover_distance_sharded(pg, eq_loc, mesh)
        dist.mean().backward()
        return dist.detach(), assign

    emd_ms = "EMD sharded fwd+bwd ms (one call, host clock)"
    launches.append(drive(wrappers, ("scatter",),
                          f"{tag} earth_mover_distance_sharded",
                          sync_run("emd", emd, emd_ms)))
    dist, assign = fig.pop("emd")
    check_assignment(torch, f"{tag} EMD sharded", ep, eq, dist, assign)
    fig["EMD sharded stats"] = dict(
        parallel.earth_mover_distance_sharded.stats)
    fig["EMD sharded mean d2"] = dist.double().mean(1)[:EMD_ORACLE].tolist()
    fig["EMD sharded assign"] = assign

    def emd_one():
        pg = ep.clone().requires_grad_()
        earth_mover_distance(pg, eq)[0].mean().backward()

    fig["EMD one-device fwd+bwd ms"] = fixed_ms(torch, emd_one)

    # config 5's step, data-parallel over dmesh against the one-device step
    dw, dr = dmesh.get_group("data").size(), dmesh.get_group("data").rank()
    sb, sn = SLICE["b"], SLICE["n"]
    batch = torch.from_numpy(cloud(np.random.default_rng(SEED + 41), sb,
                                   sn)).to(dev)
    shard = {"points": batch[dr * sb // dw:(dr + 1) * sb // dw]}
    models, steps = [], []
    for mesh_ in (None, dmesh):
        model = PointCloudAutoencoder(NPOINT1, NPOINT2, device=dev,
                                      generator=torch.Generator().manual_seed(
                                          SEED))
        models.append(model)
        steps.append(parallel.make_train_step(
            model, torch.optim.Adam(model.parameters(), 1e-3),
            parallel.reconstruction_loss(emd_kwargs=CONFIG5_EMD), mesh=mesh_))
    loss_one = steps[0]({"points": batch}).item()
    launches.append(drive(
        wrappers, (*TRAIN_KERNELS, *EMD_KERNELS),
        f"{tag} data-parallel config 5 step, B={sb // dw} a rank",
        sync_run("step", lambda: steps[1](shard).item())))
    loss_dp = fig.pop("step")
    grads = [[t.grad for t in mod.parameters()] for mod in models]
    params = [list(mod.parameters()) for mod in models]
    fig["step loss"] = (loss_dp, loss_one)
    fig["step grad gap"] = grad_gap(grads[1], grads[0])
    fig["step param gap"] = grad_gap(params[1], params[0])
    if (abs(loss_dp - loss_one) > TRAIN_GRAD_TOL * abs(loss_one)
            or fig["step grad gap"] > TRAIN_GRAD_TOL
            or fig["step param gap"] > TRAIN_GRAD_TOL):
        fail(f"{tag}: the data-parallel step differs from the one-device "
             "step")
    fig["step data-parallel ms"] = fixed_ms(torch, lambda: steps[1](shard))
    fig["step one-device ms"] = fixed_ms(
        torch, lambda: steps[0]({"points": batch}))
    return launches, fig


def print_figures(tag, fig):
    for key, value in fig.items():
        if key != "EMD sharded assign":
            print(f"{tag}: {key} {value!r}")


def parallel_rank(rank: int, world: int, store: str, out: str) -> int:
    """One of the phase's gloo ranks on cuda:0 (``chip_smoke.py
    --parallel-rank``): its cases, then its launch counts and figures as
    JSON in ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    _, wrappers = import_port()
    from pytorch_points_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=PARALLEL_PG_TIMEOUT))
    try:
        mesh = make_mesh({"points": world})
        dmesh = make_mesh({"data": world})
        launches, fig = parallel_cases(torch, dev, wrappers, mesh, dmesh,
                                       f"gloo rank {rank}/{world}")
        fig["EMD sharded assign"] = fig["EMD sharded assign"].cpu().tolist()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as fh:
        json.dump({"launches": launches, "fig": fig}, fh)
    return 0


def run_ranks(world: int, work: Path):
    """Start ``world`` ranks of this script on gloo; wait for them within
    PARALLEL_TIMEOUT, killing every one past it or when one fails; echo
    their output. Returns each rank's JSON."""
    store = work / "gloo_store"
    procs, logs = [], []
    for rank in range(world):
        logs.append(work / f"rank{rank}.log")
        with open(logs[-1], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--parallel-rank", str(rank), str(world), str(store),
                 str(work / f"rank{rank}.json")],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    end = time.perf_counter() + PARALLEL_TIMEOUT
    try:
        while time.perf_counter() < end and any(
                proc.poll() is None for proc in procs):
            if any(proc.poll() for proc in procs):  # one failed: stop all
                break
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, log in enumerate(logs):
        for line in log.read_text(errors="replace").splitlines():
            print(f"[rank {rank}] {line}")
    codes = [proc.returncode for proc in procs]
    if any(codes):
        fail(f"parallel: the gloo ranks exited with {codes}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)]


def phase_parallel(torch, dev, wrappers):
    """World 1 over NCCL in this process at full width, then
    PARALLEL_RANKS ranks sharing cuda:0 over gloo (the only way one card
    runs the cross-rank combine: shard offsets, ties across ranks, the
    ring's rotation), each rank's cases held to the one-device ops."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from scipy.optimize import linear_sum_assignment

    from pytorch_points_tpu_torch import parallel
    from pytorch_points_tpu_torch.ops import earth_mover_distance

    t0 = time.perf_counter()
    print(f"== phase 21: parallel, the sharded ops at B={PARALLEL['b']} "
          f"N=M={PARALLEL['n']} (sample_and_group {PARALLEL['n']} -> "
          f"{PARALLEL['p']}), config 4's EMD and config 5's data-parallel "
          f"step; world 1 over NCCL, then {PARALLEL_RANKS} ranks on cuda:0 "
          "over gloo; card: " + card_line())
    print("gloo on CUDA tensors: all_gather_into_tensor, all_reduce, "
          "broadcast and barrier take them; send/recv do not (gloo writes "
          "the device pointer to its socket), so collectives.ring_shift "
          "stages through host memory on a gloo group; NCCL takes every one")
    work = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(work / "nccl_store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PARALLEL_PG_TIMEOUT))
    try:
        mesh = parallel.make_mesh({"points": 1})
        dmesh = parallel.make_mesh({"data": 1})
        launches, fig = parallel_cases(torch, dev, wrappers, mesh, dmesh,
                                       "nccl world 1")
        rng = np.random.default_rng(SEED + 40)  # parallel_cases' clouds
        p, q = (torch.from_numpy(cloud(rng, PARALLEL["b"],
                                       PARALLEL["n"])).to(dev)
                for _ in range(2))
        # K13's device time on this path (uncounted, as phase 23's)
        profile_path(torch, "nndistance_sharded, nccl world 1", lambda: (
            parallel.nndistance_sharded(p, q, mesh)[0].sum().item()))
    finally:
        dist.destroy_process_group()
    print_figures("nccl world 1", fig)
    assign1 = fig["EMD sharded assign"]
    ep, eq = config4_clouds(torch, dev)
    one_dist, _ = earth_mover_distance(ep, eq)
    opt = []
    pa, qa = ep.cpu().double().numpy(), eq.cpu().double().numpy()
    for bi in range(EMD_ORACLE):
        d2 = ((pa[bi, :, None, :] - qa[bi, None, :, :]) ** 2).sum(-1)
        rows, cols = linear_sum_assignment(d2)
        opt.append(d2[rows, cols].mean())

    def excess(means):
        return [float(100.0 * (g - o) / o) for g, o in zip(means, opt)]

    print(f"EMD excess over the Hungarian optimum, config 4's first "
          f"{EMD_ORACLE} elements: sharded (flat eps 0.005, 45 iterations, "
          f"greedy completion) {excess(fig['EMD sharded mean d2'])}%; "
          "one-device (K11 + K12, pop cap 768) "
          f"{excess(one_dist.double().mean(1)[:EMD_ORACLE].tolist())}%")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # room for the ranks' own caches
    ranks = run_ranks(PARALLEL_RANKS, work)
    for rank, res in enumerate(ranks):
        launches += res["launches"]
        tag = f"gloo rank {rank}/{PARALLEL_RANKS}"
        print_figures(tag, res["fig"])
        print(f"{tag}: EMD excess over the Hungarian optimum "
              f"{excess(res['fig']['EMD sharded mean d2'])}%")
        same = (torch.tensor(res["fig"]["EMD sharded assign"], device=dev)
                == assign1).double().mean().item()
        print(f"{tag}: share of the EMD assignment equal to world 1's "
              f"{same!r}")
    print(f"phase 21 took {time.perf_counter() - t0!r} s")
    return launches, {}


def read_ppm(path: Path):
    """A raw PPM (render_cloud's output without matplotlib) as uint8."""
    raw = path.read_bytes()
    head, size = raw.split(b"\n", 1)[0], int(raw.split()[1])
    return np.frombuffer(raw[len(head) + 1:], np.uint8).reshape(size, size,
                                                                 3)


def example_upsample_render(torch, wrappers, work):
    """upsample_cloud and render_cloud on a seeded cloud, the card's output
    against the same script on the CPU."""
    from pytorch_points_tpu_torch.utils import pc_utils

    rng = np.random.default_rng(SEED + 50)
    src = work / "cloud.ply"
    pc_utils.save_ply(cloud(rng, 1, EXAMPLE_CLOUD)[0], str(src))
    up = load_example("upsample_cloud")
    launches = [drive(wrappers, CONFIG7_SERVE_KERNELS,
                      "example upsample_cloud", lambda: run_example(
                          up, [str(src), str(work / "up.ply")]))]
    run_example(up, [str(src), str(work / "up_cpu.ply"), "--device", "cpu"])
    got = pc_utils.read_ply(str(work / "up.ply"))
    want = pc_utils.read_ply(str(work / "up_cpu.ply"))
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"upsample_cloud: {got.shape} on the card, |card - cpu| / scale "
          f"{gap!r}")
    if got.shape != (4 * EXAMPLE_CLOUD, 3) or not np.isfinite(got).all() \
            or gap > SERVE_TOL:
        fail("example upsample_cloud: wrong shape, non-finite or apart "
             "from the CPU run")

    render = load_example("render_cloud")
    size = str(EXAMPLE_RENDER)
    launches.append(drive(wrappers, (), "example render_cloud",
                          lambda: run_example(render, [
                              str(src), str(work / "img.png"), size])))
    run_example(render, [str(src), str(work / "img_cpu.png"), size,
                         "--device", "cpu"])
    if not (work / "img.ppm").exists():
        print("render_cloud wrote a PNG (matplotlib present): pixels not "
              "compared")
        return launches
    img, ref = (read_ppm(work / f).astype(np.int16)
                for f in ("img.ppm", "img_cpu.ppm"))
    gap = int(np.abs(img - ref).max())
    print(f"render_cloud: {img.shape} PPM, covered pixels "
          f"{int((img.max(-1) > 0).sum())}, max |card - cpu| {gap} of 255")
    if gap > 1 or img.max() == 0:
        fail("example render_cloud: empty or apart from the CPU run")
    return launches


def example_serve_cage(torch, dev, wrappers, calls):
    """export_and_serve and deform_with_cage at their defaults, with their
    own checks; export_and_serve's train step rebuilt on its model for the
    profile."""
    from pytorch_points_tpu_torch.ops import chamfer_distance

    serve = load_example("export_and_serve")
    seen = {}
    ctor = serve.PointCloudAutoencoder
    serve.PointCloudAutoencoder = lambda *a, **k: seen.setdefault(
        "model", ctor(*a, **k))
    try:
        launches = [drive(wrappers, TRAIN_KERNELS, "example export_and_serve",
                          lambda: run_example(serve, []))]
    finally:
        serve.PointCloudAutoencoder = ctor
    model = seen["model"].train()
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    x = torch.from_numpy(cloud(np.random.default_rng(0), 4, 512)).to(dev)

    def serve_step():  # export_and_serve's step, on its model
        opt.zero_grad(set_to_none=True)
        loss = chamfer_distance(model(x), x)
        loss.backward()
        opt.step()
        return loss.item()

    calls["example export_and_serve train step, B=4 N=512"] = serve_step

    cage = load_example("deform_with_cage")
    launches.append(drive(wrappers, ("nn_dense", "scatter"),
                          "example deform_with_cage",
                          lambda: run_example(cage, [])))
    return launches


def example_autoencoder(torch, wrappers, work):
    """train_autoencoder at its defaults on a world-1 NCCL group started
    here (the script uses a group it finds), its step profiled while the
    group lives."""
    import datetime

    import torch.distributed as dist

    from pytorch_points_tpu_torch import parallel

    ex = load_example("train_autoencoder")
    seen, losses = {}, []
    make_step = parallel.make_train_step

    def recorded(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(batch):
            seen.setdefault("batch", batch)
            loss = step(batch)
            losses.append(loss)
            return loss

        seen["step"] = step
        return run

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(work / "nccl_store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PARALLEL_PG_TIMEOUT))
    parallel.make_train_step = recorded
    try:
        launches = [drive(wrappers, (*TRAIN_KERNELS, *EMD_KERNELS),
                          "example train_autoencoder",
                          lambda: run_example(ex, [
                              "--ckpt", str(work / "ae_ckpt")]))]
        values = [v.item() for v in losses]
        print(f"train_autoencoder: {len(values)} losses, first "
              f"{values[0]!r}, last {values[-1]!r}")
        if not np.isfinite(values).all():
            fail("example train_autoencoder: non-finite loss")
        step, batch = seen["step"], seen["batch"]
        profile_path(torch, "example train_autoencoder step (world-1 mesh), "
                     "B=8 N=1024, chamfer + 0.1 EMD",
                     lambda: step(batch).item())
    finally:
        parallel.make_train_step = make_step
        dist.destroy_process_group()
    return launches


def example_ply(torch, wrappers, work, calls):
    """train_on_ply_dataset as the README runs it, gated."""
    ex = load_example("train_on_ply_dataset")
    out = work / "convergence.json"
    seen = {}

    class Trainer(ex.Trainer):
        """The example's Trainer, keeping itself and its first batch for
        the profile."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["trainer"] = self
            step_fn = self.step_fn

            def step(batch):
                seen.setdefault("batch", batch)
                return step_fn(batch)

            self.step_fn = step

    ex.Trainer = Trainer
    launches = [drive(wrappers, PLY_EXAMPLE_KERNELS,
                      "example train_on_ply_dataset (README run)",
                      lambda: run_example(ex, [*PLY_EXAMPLE_ARGS,
                                               "--json-out", str(out)]))]
    art = json.loads(out.read_text())
    tpu = json.loads((ROOT / "examples" / "artifacts" /
                      "convergence_v5e.json").read_text())
    print("convergence curve (step, loss, held-out chamfer-L1, held-out "
          "f-score@0.05):")
    for e in art["loss_curve"]:
        print(f"  {e['step']:4d} {e['loss']!r} {e.get('val_chamfer_l1')!r} "
              f"{e.get('val_fscore_at_0.05')!r}")
    print(f"convergence: loss {art['first_loss']!r} -> {art['final_loss']!r}"
          f" (TPU artifact {tpu['first_loss']!r} -> {tpu['final_loss']!r}); "
          f"train chamfer-L1 {art['train_chamfer_l1']!r} f-score "
          f"{art['train_fscore_at_0.05']!r} (TPU "
          f"{tpu['train_chamfer_l1']!r}, {tpu['train_fscore_at_0.05']!r}); "
          f"held-out chamfer-L1 {art.get('val_chamfer_l1')!r} f-score "
          f"{art.get('val_fscore_at_0.05')!r} on {art['val_clouds']} clouds "
          f"(TPU {tpu['val_chamfer_l1']!r}, {tpu['val_fscore_at_0.05']!r} "
          f"on {tpu['val_clouds']})")
    print(f"convergence: {art['ms_per_step']!r} ms/step (the example's host "
          f"clock, evaluations excluded) on {art['device']}")
    print(f"convergence artifact {out.relative_to(ROOT)}: "
          + json.dumps(art, separators=(",", ":")))
    ratio = art["val_chamfer_l1"] / tpu["val_chamfer_l1"]
    if ratio > PLY_VAL_CL1_FINDING:
        print(f"FINDING: held-out chamfer-L1 {ratio!r} times the TPU "
              "artifact's")
    logged = [art["first_loss"], art["final_loss"],
              *(e["loss"] for e in art["loss_curve"])]
    if not np.isfinite(logged).all():
        fail(f"example train_on_ply_dataset: non-finite loss {logged}")
    if not art["final_loss"] < art["first_loss"] * PLY_FINAL_SHARE:
        fail(f"example train_on_ply_dataset: final loss "
             f"{art['final_loss']} not below first / 100")
    if not art["val_fscore_at_0.05"] >= PLY_VAL_FSCORE:
        fail(f"example train_on_ply_dataset: held-out f-score "
             f"{art['val_fscore_at_0.05']} below {PLY_VAL_FSCORE}")
    trainer, batch = seen["trainer"], seen["batch"]
    shape = tuple(batch["points"].shape)
    calls[f"example train_on_ply_dataset step, bf16 remat masked chamfer "
          f"+ 0.05 EMD, bucket {shape}"] = lambda: trainer.step_fn(
              batch).item()
    return launches


def phase_examples(torch, dev, wrappers):
    """The six examples_torch/ scripts' main() on the card, everything
    they write under build/examples/."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    print("== phase 22: the examples (examples_torch/), each main() in this "
          "process on the card; card: " + card_line())
    work = ROOT / "build" / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    saved, tempfile.tempdir = tempfile.tempdir, str(work)
    calls = {}
    try:
        launches = example_upsample_render(torch, wrappers, work)
        launches += example_serve_cage(torch, dev, wrappers, calls)
        launches += example_autoencoder(torch, wrappers, work)
        launches += example_ply(torch, wrappers, work, calls)
    finally:
        tempfile.tempdir = saved
    for label, fn in calls.items():  # the phase's own rows of section 5
        profile_path(torch, label, fn)
    print(f"phase 22 took {time.perf_counter() - t0!r} s")
    return launches, {}


# How the port's kernels show in a trace: every kernel of csrc/ lives in an
# anonymous namespace at the top level (PyTorch's own sit under at::).
PORT_ITEMS = ("(anonymous namespace)::", "void (anonymous namespace)::")


def profile_path(torch, label, fn, calls=5):
    """Untraced wall ms per call (after 3 warm-up calls), then ``calls``
    calls traced (:func:`traced`): device busy ms per call (the sum of the
    kernels' and copies' own times), the device's idle share of the
    untraced wall time, and the largest device items, then the port's
    kernels among the rest; for config 6 and 6m also the glue around the
    ring kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    items, counted, marker = traced(torch, fn, calls)
    items = sorted(items.items(), key=lambda i: -i[1][0])
    busy = sum(us for _, (us, _) in items) / 1e3 / counted
    print(f"profile {label}: wall {wall!r} ms/call untraced; device busy "
          f"{busy!r} ms/call; device idle share {1 - busy / wall!r}; "
          f"{sum(n for _, (_, n) in items) / counted!r} device items/call"
          f"{marker}")
    port = [i for i in items[PROFILE_TOP:] if i[0].startswith(PORT_ITEMS)]
    for name, (us, n) in items[:PROFILE_TOP] + port:
        print(f"  {us / 1e3 / counted:10.4f} ms/call {n / counted:7.1f}/call"
              f"  {name[:90]}")
    ring_ms, glue_ms, glue_items = ring_split(dict(items), counted)
    if ring_ms and label.startswith("config 6"):  # a kNN call alone
        print(f"  ring kernels {ring_ms!r} ms/call; the glue around them "
              f"{glue_items!r} device items/call, {glue_ms!r} ms/call; host "
              f"wall minus device busy {wall - busy!r} ms/call")


def resource_usage(build, so):
    """Print each kernel's registers, stack frame (where spills go), shared
    and local memory in the built library, as cuobjdump reads them from
    its cubins. It informs only: without the tools it says so."""
    tools = Path(build._nvcc()).parent
    try:
        out = subprocess.run(
            [str(tools / "cuobjdump"), "--dump-resource-usage", so],
            capture_output=True, text=True, timeout=120, check=True).stdout
        found = re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", out)
        names = subprocess.run(
            [str(tools / "cu++filt")], input="\n".join(f for f, _ in found),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError) as err:
        print(f"kernel resource usage: not measured ({err})")
        return
    if len(names) != len(found):  # unreadable demangling: the raw symbols
        names = [f for f, _ in found]
    print("kernel resource usage (cuobjdump; spills live in the STACK "
          "frame):")
    for name, (_, res) in zip(names, found):
        print(f"  {res.split(' CONSTANT')[0]}  {name[:100]}")


class Launches:
    """One entry of KERNELS served by several wrappers of one source (K5's
    and K13's): their launch counts read and reset together."""

    def __init__(self, *wrappers):
        self.wrappers = wrappers

    @property
    def launches(self):
        return sum(w.launches for w in self.wrappers)

    @launches.setter
    def launches(self, value):
        for w in self.wrappers:
            w.launches = value


def import_port():
    """Put the checkout first on the path and import the port's kernel
    modules (nothing of JAX). Returns (the build module, each kernel's
    launching wrapper by its name in KERNELS)."""
    sys.path.insert(0, str(ROOT))
    from pytorch_points_tpu_torch.kernels import (
        _build,
        auction,
        ballquery,
        distance_tiles,
        fps,
        gather,
        layernorm,
        nn_sorted,
        scatter,
        topk_scan,
    )

    wrappers = {"fps": fps.fps_cuda, "ball_query": ballquery.ball_query_cuda,
                "ball_query_coords": ballquery.ball_query_coords_cuda,
                "gather": gather.gather_rows_cuda,
                "gather_bf16": gather.gather_rows_bf16_cuda,
                "knn": topk_scan.knn_cuda,
                "scatter": scatter.scatter_add_cuda,
                "nn_dense": Launches(distance_tiles.nn_both_directions_cuda,
                                    distance_tiles.nn_one_direction_cuda),
                "nn_worklist": distance_tiles.run_worklist_cuda,
                "nn_band": nn_sorted.band_min_cuda,
                "nn_band_dynamic": nn_sorted.band_min_dynamic_cuda,
                "nn_resident": nn_sorted.nn_scan_cuda,
                "knn_ring": topk_scan.knn_ring_cuda,
                "knn_ring_masked": topk_scan.knn_ring_masked_cuda,
                "knn_ring_stats": topk_scan.knn_ring_stats_cuda,
                "auction": auction.auction_cuda,
                "augment": auction.augment_cuda,
                "layer_norm_relu": Launches(
                    layernorm.layer_norm_relu_cuda,
                    layernorm.layer_norm_relu_backward_cuda)}
    if wrappers.keys() != KERNELS.keys():
        raise RuntimeError("chip_smoke: KERNELS and the wrappers disagree")
    return _build, wrappers


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "pytorch_points_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    build, wrappers = import_port()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False; bf16 matmuls reduce in "
          "float32 (allow_bf16_reduced_precision_reduction = False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    print("== phase 1: build")
    t0 = time.perf_counter()
    lib = build.library()
    print(f"built kernels in {time.perf_counter() - t0!r} s into "
          f"{build.BUILD_DIR.relative_to(ROOT)}")
    resource_usage(build, lib._name)

    stats = phase_kernels(torch, dev)
    paths, calls = [], {}
    for phase in (phase_serve, phase_train, phase_headline, phase_emd,
                  phase_metrics, phase_knn,
                  functools.partial(phase_knn, masked=True),
                  functools.partial(phase_headline, masked=True),
                  phase_fused, phase_pruned, phase_upsampler, phase_semseg,
                  phase_config10, phase_sorted, phase_config5b,
                  phase_remat_bn, phase_cages, phase_dss, phase_parallel,
                  phase_examples):
        counts, fns = phase(torch, dev, wrappers)
        paths += counts
        calls.update(fns)
    print("== phase 23: profile one call of each main path")
    for label, fn in calls.items():
        profile_path(torch, label, fn)

    # launches: the sum over the main paths' runs (each printed above)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[name] for counts in paths),
         **{k: v for k, v in stats[name].items() if k != "last_ms"}}
        for name, (src, rep) in KERNELS.items()
    ]
    print(f"chip_smoke ran {time.perf_counter() - START!r} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
