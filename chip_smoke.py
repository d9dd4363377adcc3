#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sug_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``. It imports nothing of JAX or of ``sug_tpu``. Every phase that fails
ends the run with a non-zero exit; the phases, in order:

1. card: ``nvidia-smi`` name and power limit, and the torch device name;
2. build: every CUDA source of the main paths, compiled from the checkout
   (one ``nvcc`` each, started together), with its seconds and the
   ``-Xptxas -v`` register and shared-memory lines; then the HMMA
   (tensor-core) instructions that ``cuobjdump -sass`` finds in the three
   kernels whose D×D products run as 3xTF32 ``mma.sync`` (the
   vector-attention forward and the backward's edge and wgrad kernels),
   failing where there are none or where the toolkit has no ``cuobjdump``;
   each of those three kernels' f32 and bf16 instances, the bf16 ones (the
   vector attention's bf16 mode) holding bf16 HMMA and no TF32 one, the f32
   ones the reverse; and the two instances (f32 and bf16 ``u``) of the
   EdgeConv gather, rows and keys kernels, the bf16 ones for the
   ``values_bf16`` mode;
3. kernels against their plain PyTorch versions on the card: the EdgeConv
   forward and backward at the shapes the DGCNN twin-head forward and
   backward give them at B=64, at ragged sizes (N=1000, S=61), on exact-tie
   inputs, (forward) at N=16384 keys and on exact ties at k=64 on a
   zero-padded N=4096 lattice, and (backward) at N=2000 with F=40 and at
   N=32768 keys, where the csr kernel places every entry with one warp; the
   forward's gather kernel bit for bit against ``gather_reduce_plain`` on the
   select kernel's own idx, two forward launches agreeing bit for bit in all
   five outputs, and a k above the forward's cap raising before any launch;
   two backward launches
   agreeing bit for bit in every output and scratch array, and each of the
   backward's three kernels (csr, rows, keys) equal bit for bit to its
   plain version on the first two clouds of every backward case; the
   vector-attention forward at the five
   levels of the PTran forward at B=64 (N=1024 and the ragged N=1000), at
   D=128, and on integer lattices with duplicate points, where the
   neighbour indices must match index for index, two launches
   bit-identical; the vector-attention
   backward, fed the forward kernel's own idx, m, l and out, at the same
   levels of N=1024, at the ragged levels at D=128 and on a lattice with
   duplicate points: the edge kernel's staged per-edge tensors against the
   plain version's, the other kernels' sums against the plain sums of those
   staged tensors, every output against the plain backward, and two calls
   agreeing bit for bit; the large-N kernels at B=64: min-dists at (N, M) =
   (4096, 4096), (1024, 1024) and the ragged (3000, 2100) and (2100, 3000),
   on identical clouds and on zero-padded ones (2048 real points and 2048
   zeros), its (B, N) mins and the chamfer (B,) of two launches; FPS index for
   index from random starts at B=64 at the SA-node's (N, npoint) = (1024, 64)
   and (4096, 64), PTran's four levels (1024, 256), (256, 64), (64, 16),
   (16, 4), PointNet++'s two set abstractions (1024, 512) and (512, 128),
   the ragged (1000, 250) and (4100, 64), (16384, 512), and at
   small B on clusters of blocks (65536, 64) and (131072, 16), each on
   random clouds and on a lattice with duplicate points, and on zero-padded
   clouds, two launches bit-identical; N = 131073 refused; FPS under
   ``torch.cuda.set_sync_debug_mode("error")`` (no read back to the host);
   an out-of-range start in a child process, which must end in a CUDA
   error and print no indices; the EdgeConv forward and backward at the N=4096
   shapes (DGCNN blocks 1 and 4, the SA-node) and on a zero-padded cloud;
   then the EdgeConv kernels in ``values_bf16`` mode (the bf16 policy's) at
   the same cases (DGCNN's five shapes and the SA-node's at N=1024, ragged,
   N=4096, zero-padded): gather, rows and keys bit for bit against their
   plain versions in that mode, the select kernel's idx the f32 mode's, two
   launches bit-identical, the whole against the plain version as above;
   then the vector-attention forward and backward in their bf16 mode
   (PTran's under the bf16 policy: q, key and val in bf16) at the same
   cases as in f32, against their bf16 plain versions, with the limits of
   the comment at VA_BF16_MARKERS, two launches bit-identical;
4. the slices through their entry points, each with every launch count set
   to 0 just before it and read just after: ``sug_tpu_torch.infer``
   (``--model DGCNN --dg --batch_size 64``) on synthetic clouds and a
   synthetic dataset, with seeded weights, and its logits of 16 clouds
   against the CPU plain path; then ``sug_tpu_torch.train_dg_single_gpu``
   (``DG_unified_loss.yaml``, DGCNN, batch 64, 1024 points) for one epoch on
   a synthetic PointDA tree, and ``--resume`` from its checkpoint for a
   second; then one ``_loss(train=True)`` of the DG trainer at B=8 on the
   card against the CPU plain path; then ``infer --model PTran --dg
   --batch_size 64`` (transformer width 512) on synthetic clouds and a
   synthetic dataset, 5 vector-attention launches per batch, and its logits
   of 16 clouds against the CPU plain path; then ``train_dg_single_gpu
   --set Model PTran`` (batch 64, 1024 points) for one epoch and ``--resume``
   for a second, 10 vector-attention forward launches and 10 backward calls
   per step, 5 forward launches per eval batch and no EdgeConv launch; then
   one PTran ``_loss(train=True)`` at B=8 on the card against the CPU; then
   the shipped config as it stands (PointNet) at ``--num_points 4096``
   (batch 64; modelnet's raw clouds have 2048 points, so they are
   zero-padded), one epoch and ``--resume`` for a second, 2 FPS, 2 min-dists,
   2 EdgeConv forward and 2 backward launches per step, 1 FPS and 1 EdgeConv
   forward per eval batch; ``infer --model Pointnet --dg --num_points
   4096``, 1 FPS and 1 EdgeConv forward per batch of 64, its logits of 16
   clouds against the CPU; one PointNet ``_loss(train=True)`` at B=8 and
   N=4096 on the card against the CPU (losses, chamfer distances and
   gradients), and again on zero-padded clouds, leaving out the BN-bias
   channels whose padded rows sit at zero up to rounding, with the CPU's
   gradients of the batch in reverse order as a witness; then the DG
   trainer's other options through the same front door, one epoch each:
   DGCNN at 1024 points with ``SUG_STACKED_FORWARD=1`` and a config that
   inherits ``DG_unified_loss.yaml`` and turns on ``METHODS.GRL``, the
   contrastive geo (``CL``) and the max-hard sem alignment
   (``MAX_HARD_MMD``), 5 EdgeConv forward and 5 backward launches and 1 FPS
   a step (the kernels at B=128); PointNet at 1024 points with
   ``MODEL_CFG.BN_SEMANTICS per_replica`` and ``BN_GROUPS 2`` (launches as
   its sequential path); then the stacked DGCNN loss (GRL λ = 0.7, CL,
   max-hard) and the grouped one (2 BN groups) at B=8 on the card against
   the CPU, held as above; then the bf16 policy: ``train_dg_single_gpu --set
   PRECISION bf16`` for DGCNN and PTran at 1024 points and PointNet at 4096
   (one epoch and ``--resume``), ``infer --dg`` under ``SUG_PRECISION=bf16``
   for the three with logits of 16 clouds against the CPU, one bf16
   ``_loss`` per model (DGCNN and PTran at B=8, PointNet at 16) on the card
   against the CPU (on the card's neighbours, maxima over the points or over
   PTran's neighbours and T-Net matrices, every norm's bias raised: the
   comments at GATE_SHIFT and BF16_SATURATED), the launches as
   ``MAIN_PATHS`` says, in bf16 as in f32; then the source-only trainer,
   ``sug_tpu_torch.train_source`` (``direct_inference.yaml`` with ``--set
   Model``, batch 64, 1024 points) for the DGCNN, PTran and PointNet
   classifiers, one epoch and ``--resume`` for a second, and ``infer``
   without ``--dg`` from each second checkpoint (its logits of 16 clouds
   against the CPU plain path); ``train_dg_naive_mmd`` (``DG_baseline.yaml``,
   DGCNN) and ``train_uda`` (PointNet, modelnet against shapenet), one epoch
   each; one bf16 ``train_source`` epoch of DGCNN, every EdgeConv call in
   ``values_bf16`` mode; one source-only ``_loss`` of the DGCNN classifier
   and one naive alternating step of DGCNN at B=8 on the card against the
   CPU (the losses, the source loss's and phase A's gradients, phase B's
   loss) (the PointNet++ classifier is trained and served in the same runs);
   then PointNet++ (4n): ``train_dg_single_gpu --set Model Pointnet2``
   (batch 64, 1024 points) for one epoch and ``--resume`` for a second,
   ``infer --model Pointnet2 --dg``, one PointNet++ DG ``_loss`` (losses and
   gradients) and one MSG segmenter forward at B=8 on the card against the
   CPU, each device on its own ball queries unless the limits fail, then
   the CPU on the card's with each row chosen otherwise held to a boundary
   tie (``card_ball_groups``, ``ball_tie_verdict``); and a synthetic
   reference-repo ``.pth`` for each backbone of ``CONVERTED`` run through
   ``python -m sug_tpu_torch.convert_reference_checkpoint`` and served by
   ``infer --dg``, logits against the CPU. Every DG path runs the FPS
   kernel (DGCNN's and PointNet's SA-node once a forward, PTran's four
   TransitionDowns, PointNet++'s two set abstractions), PointNet++'s and
   PTran's classifiers too, the DGCNN and PointNet classifiers none; no
   path at 1024 points launches min-dists;
5. times, with CUDA events after warm-up: each kernel shape beside its bound,
   its plain version and, for min-dists, ``torch.cdist`` and ``amin``; FPS
   at every shape above, through its launcher, the wrapper and the
   profiler's device time per launch, in µs per dependent step; the
   EdgeConv forward also at the five N=4096 shapes and on a zero-padded
   cloud, with its split by kernel (select, gather) at every shape from a
   ``torch.profiler`` run; the EdgeConv backward also at the N=4096 shapes
   and on a zero-padded cloud, and its split by kernel (csr, rows, keys) at
   block 4 and at N=4096; for
   the vector attention at each PTran level its achieved TFLOP/s, its bound
   with the D×D products on the tensor cores as 3xTF32 beside the f32 bound
   outside them, the weight bytes the design asks of L2 (a count from the
   grid and the cluster size, not a reading of the card), and each backward
   kernel's share of the backward; the
   DGCNN, PTran, PointNet (N=1024 and 4096) and PointNet++ inference
   forwards per batch of 64, and the DGCNN, PTran, PointNet and PointNet++
   DG train steps at B=64+64 (DGCNN at N=1024 and 4096, PTran and
   PointNet++ at 1024, PointNet at 1024 and 4096) with their
   peak memory; each with a ``torch.profiler`` breakdown of device time by
   kernel (its busy share and kernels a step), and its launches counted as
   ``MAIN_PATHS`` says. The cells of ``AB_CELLS`` (DGCNN at 1024 and 4096
   points, PTran and PointNet++ at 1024, PointNet at 4096) run the step with the
   sequential and the stacked forward in turns on one trainer, sequential,
   stacked, stacked, sequential, and a summary lists each run; the cells of
   ``BF16_CELLS`` (DGCNN and PointNet at 1024 and 4096 points, PTran at
   1024) also run the step under the bf16 policy, f32 and bf16 in turns on
   one trainer; the DGCNN, PTran and PointNet forwards also under bf16; the
   EdgeConv kernels in ``values_bf16`` mode at the five N=1024 shapes, split
   by kernel, beside their bounds (u read at 2 bytes) and plain versions;
   and the vector-attention kernels in the bf16 mode at the five PTran
   levels, beside their bounds (the D×D products at the bf16 peak, q, key,
   val at 2 bytes) and bf16 plain versions, the backward split by kernel;
   last, the source-only step at B=64 and the eval forward per batch of 64
   of the four classifiers, and the alternating step at B=64+64 (naive
   DGCNN, uda PointNet), each with its busy share, kernels a step and peak
   memory, its launches counted as ``MAIN_PATHS`` says.

The line before the last is a JSON object with every kernel's numbers (the
two EdgeConv kernels' ``values_bf16`` mode and the two vector-attention
kernels' bf16 mode as entries of their own); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# sug_tpu_torch.ops.edgeconv, .vector_attention and .geometry_kernels, imported by main()
# once a card is found
edgeconv = None
vector_attention = None
geometry_kernels = None

B = 64  # the serving batch of infer.py
N_POINTS = 1024
# the forward's five edgeconv_reduce calls: (name, S or None for self-kNN, C, F, k)
SHAPES = [
    ("block1", None, 3, 64, 20),
    ("block2", None, 64, 64, 20),
    ("block3", None, 64, 128, 20),
    ("block4", None, 128, 256, 20),
    ("sa_node", 64, 3, 64, 64),
]
# ragged sizes (infer takes any --num_points): N not a multiple of the
# select kernel's 64-key tile and S not a multiple of its 64 queries per
# block, so the partial last tile and the idle rows of the last block run
RAGGED_N = 1000
RAGGED = [
    ("ragged self N=1000", None, 64, 64, 20),
    ("ragged cross S=61 N=1000", 61, 3, 64, 64),
]
# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12  # dense, on the tensor cores
BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores
# kernel against plain version: share of rows whose neighbour sets must agree
# (near-tied distances may order differently: the two sum C products in
# different orders), and the tolerance on agreeing rows: 1e-5 relative to
# max(|plain|, 1), since s1/s2 sum the same k terms in a different order
MIN_SET_AGREEMENT = 0.999
REL_TOL = 1e-5
# the slice on the card against the CPU plain path, over 16 clouds
MAX_LOGIT_DIFF = 1e-2
MAX_ARGMAX_DISAGREE = 1
# one DG _loss(train=True) at B=8 on the card against the CPU plain path:
# losses to 1e-3 relative; gradients (with the MMD losses off, whose sigma=
# 0.01 kernel amplifies the rounding of zero self-distances by 5000) to 1e-2
# relative L2 per parameter, a parameter whose gradient is zero up to
# rounding measured against 1e-2 of the largest one's norm. Near-tied
# neighbours may be ordered differently by cuBLAS and the kernel.
CARD_B = 8
MAX_LOSS_REL = 1e-3
MAX_GRAD_REL_L2 = 1e-2
# With BN groups the DGCNN's EdgeConv features hold many near-tied
# neighbours, and one neighbour chosen otherwise moves some gradient leaves
# by several percent on any device: on the CPU alone, float32 against
# float64 (tests/test_torch_port_near_ties.py). So the grouped case compares
# the losses and gradients on the card's neighbours (``card_neighbours``),
# after holding the card's choice to the CPU's own: a row whose neighbour
# set differs must hold k distinct keys and be a near tie, the k-th
# distances of the two sets, recomputed in float64 from the CPU's features,
# within NEAR_TIE_REL of the row's |q|² + max |key|² (the size of the
# float32 rounding of |q|² + |key|² − 2·q·key); at most 1 − MIN_SET_AGREEMENT
# of the rows may differ.
NEAR_TIE_REL = 1e-5
# Under bf16 the two devices' features differ by more than float32's
# rounding: where a sum lies near a bf16 rounding boundary the card and the
# CPU round it to neighbouring bf16 values, a step of 2^-8 of the value,
# which moves the next kNN's queries and keys (the SA-node's node
# positions too, through its offsets). The yardstick is then the policy's
# own: on the CPU's bf16 run's features, the rows on which its own bf16 and
# f32 runs choose differently and the gap between those two choices. A row
# the CPU chooses otherwise than the card is a near tie within the larger of
# NEAR_TIE_REL and that gap, and there may be as many such rows as the
# larger of the f32 share and that count.
# Zero-padded clouds. The padded rows are copies of the origin, the mean of
# a centred cloud, so a layer that maps the raw points linearly (PointNet's
# conv1, its first T-Net's first layer) puts them at the mean of its
# outputs, and BN sends them to its bias, 0 at the initial weights, up to
# rounding. The relu after it then switches for 2048 rows of a cloud at once
# on the sign of a rounding error, which each device (and each summation
# order) rounds its own way, and that BN bias's gradient follows. So a
# channel of a BN whose padded rows the CPU puts within PAD_ZERO_REL of its
# rms of zero is left out of its bias's comparison; every other gradient is
# held to MAX_GRAD_REL_L2. The CPU also takes the gradients of the batch in
# reverse order (the same loss, summed in another order) as a witness.
PAD_ZERO_REL = 1e-4
# the DG training run: 26 clouds per class of modelnet train split in two
# halves of 130, so 2 class-balanced steps of 64 per epoch; 100 test clouds
# per dataset, 2 eval batches each
TRAIN_PER_CLASS = 26
TEST_PER_CLASS = 10
YAML = os.path.join(HERE, "tools", "cfgs", "cfgs_local", "DG_unified_loss.yaml")
# PTran (transformer width 512, k=16): the forward's five vector-attention
# calls at N=1024, (name, N, k); --num_points 1000 gives the ragged levels
D_MODEL = 512
VA_SHAPES = [
    ("level0", 1024, 16),
    ("level1", 256, 16),
    ("level2", 64, 16),
    ("level3", 16, 16),
    ("level4", 4, 4),
]
VA_RAGGED = [
    ("ragged level0", 1000, 16),
    ("ragged level1", 250, 16),
    ("ragged level2", 62, 16),
    ("ragged level3", 15, 15),
    ("ragged level4", 3, 3),
]
# vector attention, kernel against plain version: neighbour sets as for
# EdgeConv, and out, m, l on agreeing rows to 1e-5 relative to
# max(|plain|, 1): each logit sums 512 products per layer through three
# layers, in another order than cuBLAS (up to 9.6e-7 measured on an H100)
VA_REL_TOL = 1e-5
# the PTran serving run: 2 batches of 64 clouds for --pts, 100 dataset clouds
PTRAN_CLOUDS = 2 * B
# vector-attention backward. The edge kernel's staged per-edge tensors against
# the plain version's, to 2e-5 relative to max(|plain|, the tensor's rms):
# six chained D-term products in another order than cuBLAS. A relu whose
# input is zero up to that rounding may switch differently on the two sides;
# such flips must be rarer than 1e-5 of the elements, each at a value below
# 1e-5, and the cotangents downstream of a flipped edge are not compared.
VA_EDGE_TOL = 2e-5
VA_FLIP_MARGIN = 1e-5
VA_MAX_FLIP_SHARE = 1e-5
# The other kernels' outputs against the plain sums of the edge kernel's own
# staged tensors (no flips between them), to 1e-5 of max(sum of the terms'
# magnitudes, its mean over the tensor): sums of up to 2^20 terms of both
# signs in another order. dbg2 is zero up to rounding and has only this scale.
VA_SUM_TOL = 1e-5
# Every output against the plain backward end to end, in relative L2 (dbg2:
# relative to its terms' magnitudes): a flipped relu moves a whole dq or dkey
# row by about 1e-2 of its size, so this is a looser check of the whole.
VA_BWD_REL_L2 = 5e-3
# the kernels of one backward call, in launch order
VA_BWD_KERNELS = ("edge", "wgrad", "thin", "scatter", "reduce")
# the blocks of a cluster that share each weight chunk (kCluster in
# csrc/vecattn_tile.cuh), for the count of weight bytes asked of L2
VA_CLUSTER = 2
# the kernels whose D×D products run on the tensor cores (3xTF32 mma.sync):
# (name in the SASS, source)
TENSOR_CORE_KERNELS = (("vecattn_fwd_kernel", "vecattn_fwd"),
                       ("vecattn_bwd_edge_kernel", "vecattn_bwd"),
                       ("vecattn_bwd_wgrad_kernel", "vecattn_bwd"))
# The vector attention's bf16 mode (PRECISION: bf16, PTran; the TPU kernels'
# precise=False): each of those kernels has an f32 and a bf16 instance,
# told apart in the SASS by a piece of the mangled name of the bf16 one
# (the template argument __nv_bfloat16, or wgrad's <true>). The bf16
# instances must hold bf16 HMMA and no TF32 one, the f32 ones the reverse.
VA_BF16_MARKERS = {"vecattn_fwd_kernel": "__nv_bfloat16",
                   "vecattn_bwd_edge_kernel": "__nv_bfloat16",
                   "vecattn_bwd_wgrad_kernel": "ILb1E"}
# bf16 kernels against their bf16 plain versions. Both round the same
# operands to bf16 at the same points (the TPU kernels'), but their f32 sums
# run in another order (the tensor cores' against the CPU's or cuBLAS's),
# and where a sum lies within that order's rounding (about 1e-7 of its terms)
# of a bf16 rounding boundary, the two round the next product's operand to
# neighbouring bf16 values, 2^-8 of it apart. The next product then moves by
# 2^-8 of that one term, and a relu gate near zero may switch. So the limits
# are those of such flips, each measured by this script on an H100 80GB HBM3
# at 700 W with the cause beside it:
# - forward, out/m/l on agreeing rows: VA_BF16_REL_TOL of max(|plain|, 1)
#   element by element, one bf16 step (a flipped operand moves one term by
#   2^-8 of itself; measured up to 9.8e-4), and VA_BF16_REL_L2 relative L2
#   over all of them (the flips are rare; measured up to 6.6e-5): a weight
#   rounded before s is folded into it, bf16(Wg2)·s in place of
#   bf16(Wg2·s), moves every logit and fails this
#   (tests/test_torch_port_vector_attention_bf16.py shows it on the CPU);
# - backward, the edge kernel's staged tensors: VA_BF16_EDGE_TOL of
#   max(|plain|, rms) element by element off relu flips (a few flipped
#   operands in each of three chained products, each moving one term by
#   2^-8 of itself; measured up to 1.7e-2) and VA_BF16_EDGE_L2 relative L2
#   over each tensor (the flips are rare); relu flips at most
#   VA_BF16_FLIP_SHARE of the elements, each at a value under
#   VA_BF16_FLIP_MARGIN of the tensor's rms (a few bf16 steps of a term;
#   measured up to 1.2e-7 of the elements at 5.8e-4 of the rms); the other
#   kernels' sums against the plain sums of the staged tensors as in f32
#   (VA_SUM_TOL: the same roundings of the same staged values; measured up
#   to 3.1e-7), dkey and dval within one bf16 step of the larger more (both
#   round an f32 sum to bf16); every output against the plain backward
#   within VA_BF16_BWD_REL_L2 relative L2 (dq, dkey, dWg1 and dbg1 sum
#   cotangents of both signs that cancel, so a flipped operand weighs more
#   there; measured up to 1.2e-3).
VA_BF16_REL_TOL = 2.0**-8
VA_BF16_REL_L2 = 5e-4
VA_BF16_EDGE_TOL = 5e-2
VA_BF16_EDGE_L2 = 1e-3
VA_BF16_FLIP_SHARE = 1e-5
VA_BF16_FLIP_MARGIN = 1e-2
VA_BF16_BWD_REL_L2 = 1e-2
# the large-N slice: the shipped config's PointNet at --num_points 4096
N_LARGE = 4096
# min-dists (B, N, M) cases at B=64: the main path's, one the routing would
# not send to the kernel, and ragged sizes no 512-point tile divides
MIN_DISTS_SHAPES = [(4096, 4096), (1024, 1024), (3000, 2100), (2100, 3000)]
# min-dists, kernel against plain version: each min to 1e-6 of max(|q|² +
# max_m |s|², 1). The expanded -2·q·s + |q|² + |s|² cancels, so rounding
# scales with the squared norms, not with the min; the kernel adds the terms
# with FMAs in another order than cuBLAS and the plain sums (up to 2.1e-07
# measured by this script on an H100 80GB HBM3 at 700 W, on identical
# clouds). A chamfer is a mean of such mins in each direction.
MIN_DIST_REL = 1e-6
# FPS cases (B, N, npoint), indices exact: the SA-node's at 1024 and 4096
# points, PTran's four TransitionDowns at 1024 points, PointNet++'s two set
# abstractions (512 of 1024 points, then 128 of 512), ragged clouds, a
# 2-block cluster over 512 steps, and clusters of up to 8 blocks at small B
# (the plain loop's steps over such clouds take the time there);
# FPS_REFUSED points are more than the launcher takes
FPS_SHAPES = [(B, 1024, 64), (B, 1024, 256), (B, 256, 64), (B, 64, 16), (B, 16, 4),
              (B, 1024, 512), (B, 512, 128), (B, 1000, 250), (B, 4096, 64), (B, 4100, 64),
              (B, 16384, 512), (4, 65536, 64), (2, 131072, 16)]
FPS_REFUSED = 131073
# the EdgeConv kernels at the N=4096 shapes of DGCNN blocks 1 and 4 and of
# the SA-node (every backbone's), at B=64; the backward's check at block 4
# runs at B=16, since the plain backward's (B, S, k, F) temporaries would take
# some 30 GB at B=64, by count of their shapes
LARGE_SHAPES = [SHAPES[0], SHAPES[3], SHAPES[4]]
LARGE_BWD_B = {"block4": 16}
# the EdgeConv forward's further cases: self-kNN (block 1's widths) at
# N_HUGE keys on HUGE_B clouds, and exact ties at k=64 on TIE_PAD_B
# zero-padded lattice clouds of N_LARGE points
N_HUGE = 16384
HUGE_B = 4
TIE_PAD_B = 16
# the forward's kernels, in launch order: (label, name in the profiler)
FWD_KERNELS = (("select", "edgeconv_fwd_select_kernel"), ("gather", "edgeconv_fwd_gather_kernel"))
BWD_KERNELS = tuple((k, f"edgeconv_bwd_{k}_kernel") for k in ("csr", "rows", "keys"))
# what edgeconv_reduce_bwd_stages returns, in order; and the clouds of each
# backward case on which each kernel is held bit for bit to its plain
# version (the plain keys walk takes one step per entry of the longest key
# list, some 2000 on a zero-padded cloud)
BWD_STAGES = ("du", "dv", "offsets", "edges", "jmax", "jmin")
STAGE_B = 2
# launch counters, in the order counts() returns them
COUNTERS = ("edgeconv_fwd", "edgeconv_bwd", "vecattn_fwd", "vecattn_bwd_calls", "fps",
            "min_dists")
# each main path's launches (by COUNTERS) per train step and per eval or
# serving batch of 64: per forward DGCNN runs the EdgeConv forward 5 times,
# PTran the vector attention 5 times, PointNet the EdgeConv forward once (its
# SA-node); the SA-node's FPS (DGCNN, PointNet) is one kernel launch at
# every size, PTran's four TransitionDowns four, and above 2048 points the
# step's chamfer two min-dists launches. A step runs the source and the
# target forward and their backward.
# The stacked forward (SUG_STACKED_FORWARD=1) runs the source and the target
# clouds as one batch of 2B: one forward's launches a step, and its backward;
# the chamfer of the geo SDA weights stays two min-dists launches. Grouped BN
# changes no launch.
MAIN_PATHS = {
    ("DGCNN", N_POINTS): ((10, 10, 0, 0, 2, 0), (5, 0, 0, 0, 1, 0)),
    ("PTran", N_POINTS): ((0, 0, 10, 10, 8, 0), (0, 0, 5, 0, 4, 0)),
    ("Pointnet", N_LARGE): ((2, 2, 0, 0, 2, 2), (1, 0, 0, 0, 1, 0)),
    ("Pointnet", N_POINTS): ((2, 2, 0, 0, 2, 0), (1, 0, 0, 0, 1, 0)),
    ("DGCNN", N_LARGE): ((10, 10, 0, 0, 2, 2), (5, 0, 0, 0, 1, 0)),
    ("DGCNN", N_POINTS, "stacked"): ((5, 5, 0, 0, 1, 0), (5, 0, 0, 0, 1, 0)),
    ("DGCNN", N_LARGE, "stacked"): ((5, 5, 0, 0, 1, 2), (5, 0, 0, 0, 1, 0)),
    ("PTran", N_POINTS, "stacked"): ((0, 0, 5, 5, 4, 0), (0, 0, 5, 0, 4, 0)),
    ("Pointnet", N_LARGE, "stacked"): ((1, 1, 0, 0, 1, 2), (1, 0, 0, 0, 1, 0)),
    # the standalone classifiers of train_source and infer without --dg: one
    # forward and its backward a step, no SA-node, so no FPS but PTran's
    # four TransitionDowns'; DGCNN's four EdgeConv blocks, PTran's five
    # attention blocks, PointNet no kernel at all
    ("DGCNN", N_POINTS, "source"): ((4, 4, 0, 0, 0, 0), (4, 0, 0, 0, 0, 0)),
    ("PTran", N_POINTS, "source"): ((0, 0, 5, 5, 4, 0), (0, 0, 5, 0, 4, 0)),
    ("Pointnet", N_POINTS, "source"): ((0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0)),
    # the alternating trainer: four NetMDA forwards a step (phase A's source
    # and target, phase B's), each DGCNN's 5 EdgeConv forwards (with the
    # SA-node's re-query) or PointNet's 1, and the SA-node's FPS. Phase A's
    # backward reaches every EdgeConv call of its two forwards (DGCNN 10,
    # PointNet 2). Phase B's loss reads only the attended node features, and
    # node_fea is the SA-node's re-query of residual(x2): its backward runs
    # the re-query's and, in DGCNN, block2's and block1's (3 a forward, not
    # block3 or block4, whose output node_fea does not read; PointNet 1). So
    # DGCNN 10 + 6 = 16 backward launches a step, PointNet 2 + 2 = 4. Eval is
    # the twin-head forward of the DG paths.
    ("DGCNN", N_POINTS, "alternating"): ((20, 16, 0, 0, 4, 0), (5, 0, 0, 0, 1, 0)),
    ("Pointnet", N_POINTS, "alternating"): ((4, 4, 0, 0, 4, 0), (1, 0, 0, 0, 1, 0)),
    # PointNet++ (DG and classifier alike): two FPS a forward, sa1's 512 of
    # 1024 points and sa2's 128 of 512 (sa3 groups all), and no other
    # kernel: its ball queries, gathers and maxima are plain PyTorch
    ("Pointnet2", N_POINTS): ((0, 0, 0, 0, 4, 0), (0, 0, 0, 0, 2, 0)),
    ("Pointnet2", N_POINTS, "stacked"): ((0, 0, 0, 0, 2, 0), (0, 0, 0, 0, 2, 0)),
    ("Pointnet2", N_POINTS, "source"): ((0, 0, 0, 0, 2, 0), (0, 0, 0, 0, 2, 0)),
}
# the new trainers' configs: the source-only one (PointNet, with --set Model
# for the others) and the naive-MMD DG baseline (DGCNN)
SOURCE_YAML = os.path.join(HERE, "tools", "cfgs", "cfgs_local", "direct_inference.yaml")
BASELINE_YAML = os.path.join(HERE, "tools", "cfgs", "cfgs_local", "DG_baseline.yaml")
# the DG trainer's other options, through the training entry point: the
# stacked forward with the GRL and the contrastive geo and max-hard sem
# alignments (DGCNN), and per-replica BN in 2 groups (PointNet, sequential)
OPTIONS_YAML = """_BASE_CONFIG_: {base}
METHODS:
    GRL: True
    GEO_MMD: [{{NAME: CL, GEO_SCALE: 1}}]
    SEM_MMD: [{{NAME: MAX_HARD_MMD, SEM_SCALE: 1}}]
"""
BN_GROUPS_SET = ("MODEL_CFG.BN_SEMANTICS", "per_replica", "MODEL_CFG.BN_GROUPS", "2")
GRL_LAMBDA = 0.7  # the card-vs-CPU loss's λ, well inside the loop's sine ramp
# phase 5's A/B cells, sequential against stacked in turns in one process
AB_CELLS = (("DGCNN", N_POINTS), ("PTran", N_POINTS), ("Pointnet", N_LARGE), ("DGCNN", N_LARGE),
            ("Pointnet2", N_POINTS))
# the backbones the reference-checkpoint converter's entry point takes
CONVERTED = ("Pointnet", "DGCNN", "Pointnet2")
# The bf16 policy (PRECISION: bf16): the EdgeConv kernels' values_bf16 mode
# (DGCNN and PointNet), instantiated in the same sources, as (label, kernel
# name, source); the --set that turns it on; phase 5's cells that run the
# f32 and the bf16 step in turns on one trainer.
BF16_KERNELS = (("gather", "edgeconv_fwd_gather_kernel", "edgeconv_fwd"),
                ("rows", "edgeconv_bwd_rows_kernel", "edgeconv_bwd"),
                ("keys", "edgeconv_bwd_keys_kernel", "edgeconv_bwd"))
BF16_SET = ("PRECISION", "bf16")
BF16_CELLS = (("DGCNN", N_POINTS), ("DGCNN", N_LARGE), ("Pointnet", N_POINTS),
              ("Pointnet", N_LARGE), ("PTran", N_POINTS))
# bf16 on the card against bf16 on the CPU. Both round at the same points,
# but their f32 sums (cuBLAS against the CPU's GEMMs, BN reductions) differ
# in order, and where a sum lies near a bf16 rounding boundary the two
# round it to neighbouring bf16 values. That moves a max over the points, a
# kNN or an activation's gate to another piece of a piecewise function on
# near ties, and the gradient jumps with it: with those choices free,
# PointNet's gradients at 4096 points differ by half their norm between
# bf16 and f32 on the CPU alone, so no limit set by that noise could fail a
# wrong gradient. So the bf16 loss compares the devices where the gradient
# is a smooth function of the rounding: the CPU takes the card's EdgeConv
# neighbours (``card_neighbours``, each row held to a near tie), the card's
# choice of each max over the points (``card_maxima``) and the card's T-Net
# matrices (``card_transforms``, each within the CPU's own bf16-vs-f32
# distance of the CPU's: an ulp that the devices round apart in the T-Net's
# bf16 products moves every point of the cloud, and the SA-node's kNN with
# it), every BN's and LayerNorm's bias is raised by GATE_SHIFT (each
# activation's input far from its kink), and the batch is the synthetic
# clouds of 8 classes (PointNet's of 16, whose first T-Net's gradient 8
# clouds leave to bf16's rounding). Each
# figure is then held to the CPU's own bf16-vs-f32 distance D on the same
# inputs and choices (the f32 run keeps its own neighbours), each gradient
# leaf to its own, or to the f32 limit where that is larger; every D must
# stay under MAX_BF16_NOISE, so that a zero or a halved result fails. A
# leaf whose f32 gradient is zero to rounding (under ZERO_LEAF of the
# largest leaf) must stay under 1e-2 of the largest on both devices. The
# logits of ``infer`` are held to D alone, each device choosing its own.
GATE_SHIFT = 3.0
MAX_BF16_NOISE = 0.5
ZERO_LEAF = 1e-4
# PTran under bf16 takes those figures through four TransitionDowns and five
# attention blocks, and there the two devices' bf16 runs drift apart until
# they differ as two independent sets of roundings do, about √2·D: two runs
# whose f32 sums differ in order round apart wherever a sum lies within that
# difference of a rounding boundary, and each later rounding widens the gap
# (a relative difference δ flips a share δ/2^-8 of the next roundings, each
# by 2^-8), fastest at a BN output near its raised bias, where a bf16 step is
# 1/64 of the signal (tests/test_torch_port_ptran_bf16.py measures it between
# the JAX package and the port on the CPU: 2e-5 of the features' norm after
# the first block, D after the fourth TransitionDown). So PTran's bf16
# figures are held to BF16_SATURATED times the CPU's own distance, its
# losses to one bf16 step (2^-8) where that is larger, and its logits'
# argmax disagreements to BF16_SATURATED times the CPU's own, rounded up.
BF16_SATURATED = {"PTran": math.sqrt(2.0)}
BF16_SATURATED_LOSS = 2.0**-8


def hmma_by_instance(cuobjdump, library, kernel):
    """{mangled name: the HMMA opcodes in its SASS} for every instance of
    ``kernel`` (a substring of the mangled name) in ``library``; an opcode
    names its shape and types (``HMMA.1688.F32.TF32``,
    ``HMMA.16816.F32.BF16``)."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = name if kernel in name else None
            if current is not None:
                found[current] = []
        elif current is not None and "HMMA" in line:
            found[current].append(next(w for w in line.replace(";", " ").split()
                                       if w.startswith("HMMA")))
    return found


def sass_functions(cuobjdump, library):
    """The (mangled) names of the kernels in ``library``'s SASS."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return [line.split("Function :", 1)[1].strip() for line in sass.splitlines()
            if "Function :" in line]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_clouds(b, n, gen, device, real=None):
    """b clouds of n points in the unit ball; with ``real``, only the first
    ``real`` points, the rest zeros, as ``fit_num_points`` pads a short cloud."""
    x = torch.randn((b, n, 3), generator=gen, device=device)
    x = x / x.norm(dim=-1).amax(dim=1)[:, None, None]
    if real is not None:
        x[:, real:] = 0.0
    return x


def shape_inputs(shape, gen, device, n=N_POINTS, b=B, real=None):
    """Seeded inputs of one edgeconv_reduce call of the main path; ``real``
    zero-pads the cloud (C=3) past its first ``real`` points."""
    _, S, C, F, k = shape
    if C == 3:  # coordinates: clouds in the unit ball
        kv = unit_clouds(b, n, gen, device, real)
    else:  # features
        kv = torch.randn((b, n, C), generator=gen, device=device)
    u = torch.randn((b, n, F), generator=gen, device=device)
    if S is None:
        return kv, kv, u, torch.randn((b, n, F), generator=gen, device=device), k
    # SA-node: offset nodes near the cloud, v = 0
    q = (kv[:, :S] + 0.05 * torch.randn((b, S, C), generator=gen, device=device)).contiguous()
    return q, kv, u, torch.zeros((b, S, F), device=device), k


def bound(q, kv, u, v, k):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth (each
    input read once at its own width, so a bf16 u at 2 bytes; each output
    written once) and the f32 distance operations 2*B*S*N*C over the f32
    peak. The k selection rounds are comparisons and are not counted."""
    Bq, S, C = q.shape
    N, F = kv.shape[1], u.shape[-1]
    inputs = [kv, u, v] + ([] if q is kv else [q])
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + 4 * Bq * S * F * 4 + Bq * S * k * 4
    flops = 2.0 * Bq * S * N * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def compare(name, got, want, require_exact_idx=False):
    """Kernel outputs against the plain version's; returns (max_abs_err on
    agreeing rows, share of rows whose neighbour sets agree)."""
    g_idx, w_idx = got[4].long(), want[4].long()
    same_set = (torch.sort(g_idx, -1).values == torch.sort(w_idx, -1).values).all(-1)
    share = same_set.float().mean().item()
    ordered = (g_idx == w_idx).all(-1).float().mean().item()
    max_err = 0.0
    parts = []
    for label, g, w in zip(("amax", "amin", "s1", "s2"), got[:4], want[:4]):
        if not torch.isfinite(g).all():
            fail(f"{name}: {label} has non-finite values")
        d = (g - w).abs()[same_set]
        rel = (d / torch.clamp(w.abs()[same_set], min=1.0)).max().item() if d.numel() else 0.0
        err = d.max().item() if d.numel() else 0.0
        max_err = max(max_err, err)
        parts.append(f"{label} {err:.3e}")
        if rel > REL_TOL:
            fail(f"{name}: {label} differs by {rel:.3e} relative on agreeing rows (> {REL_TOL})")
    print(f"  {name}: sets agree on {share:.6f} of rows, order on {ordered:.6f}; "
          f"max |diff| on agreeing rows: {', '.join(parts)}", flush=True)
    if require_exact_idx and not torch.equal(g_idx, w_idx):
        fail(f"{name}: neighbour indices differ on an exact-tie input")
    if share < MIN_SET_AGREEMENT:
        fail(f"{name}: neighbour sets agree on {share:.6f} of rows (< {MIN_SET_AGREEMENT})")
    return max_err, share


def bwd_bound(idx, u, v):
    """(bound_ms, bound_by, bytes, flops) of one backward call: idx, u (at
    its own width: a bf16 u at 2 bytes) and the seven (B,S,F) inputs read
    once, du (f32) and dv written once, against about 8 f32 operations per
    edge and channel."""
    Bq, S, k = idx.shape
    N, F = u.shape[1], u.shape[2]
    nbytes = idx.numel() * 4 + u.numel() * (u.element_size() + 4) + 8 * Bq * S * F * 4
    flops = 8.0 * Bq * S * k * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def bwd_inputs(q, kv, u, v, k, gen, integer=False, values_bf16=False):
    """The backward's inputs from one forward kernel launch on (q, kv, u, v)
    (in ``values_bf16`` mode, u as the forward saves it: bf16) and random
    cotangents; ``integer`` makes them half-integers, so every sum is exact
    and kernel and plain version must agree bit for bit."""
    if values_bf16:
        u = u.to(torch.bfloat16)
    amax, amin, _, _, idx = edgeconv.edgeconv_reduce(q, kv, u, v, k, values_bf16)
    if integer:
        cot = [torch.randint(-4, 5, amax.shape, generator=gen, device=amax.device).float() / 2
               for _ in range(4)]
    else:
        cot = [torch.randn(amax.shape, generator=gen, device=amax.device) for _ in range(4)]
    return (idx, u, v, amax, amin, *cot)


def compare_bwd(name, args, exact=False, values_bf16=False):
    """Backward kernels against the plain backward on the same inputs (both
    in ``values_bf16`` mode where asked); two
    launches must give bit-identical results, the csr kernel's offsets and
    edges and the rows kernel's jmax and jmin included. Returns the max
    |diff|.

    dU and dV are sums of edge cotangents of both signs (a key of many
    neighbour lists collects hundreds), summed in another order by the
    plain version's atomic scatter, so the error is measured relative to
    max(sum of the terms' magnitudes, 1), the scale of f32 summation error;
    the error relative to max(|plain|, 1) is printed beside it."""
    got = edgeconv.edgeconv_reduce_bwd_stages(*args, values_bf16)
    again = edgeconv.edgeconv_reduce_bwd_stages(*args, values_bf16)
    want = edgeconv.edgeconv_reduce_bwd_plain(*args, values_bf16)
    da_abs = edgeconv.edge_cotangents(*args, values_bf16).abs()
    scales = (edgeconv.scatter_keys(da_abs, args[0], args[1].shape[1]), da_abs.sum(2))
    del da_abs
    torch.cuda.synchronize()
    for label, g, a in zip(BWD_STAGES, got, again):
        if not torch.equal(g, a):
            fail(f"{name}: two backward launches on the same inputs differ in {label}")
    max_err, parts = 0.0, []
    for label, g, w, scale in zip(("du", "dv"), got, want, scales):
        if not torch.isfinite(g).all():
            fail(f"{name}: {label} has non-finite values")
        d = (g - w).abs()
        rel = (d / torch.clamp(scale, min=1.0)).max().item()
        rel_plain = (d / torch.clamp(w.abs(), min=1.0)).max().item()
        max_err = max(max_err, d.max().item())
        parts.append(f"{label} {d.max().item():.3e} (rel {rel:.3e} of the terms, "
                     f"{rel_plain:.3e} of |plain|)")
        if rel > REL_TOL:
            fail(f"{name}: {label} differs by {rel:.3e} of its terms' magnitude (> {REL_TOL})")
        if exact and not torch.equal(g, w):
            fail(f"{name}: {label} differs on an exact-tie input: first-hit routing disagrees")
    print(f"  {name}: {', '.join(parts)}; two launches bit-identical in "
          f"{', '.join(BWD_STAGES)}" + ("; exact ties routed identically" if exact else ""),
          flush=True)
    return max_err


def compare_bwd_stages(name, args, values_bf16=False):
    """Each backward kernel against its plain version, bit for bit, on the
    first ``STAGE_B`` clouds of ``args``: csr's offsets and edges against
    ``key_csr_plain``, rows' jmax, jmin and dv against ``first_hits_plain``,
    keys' du against ``du_by_key_plain`` (the same adds in the same order),
    in ``values_bf16`` mode where asked.
    Prints the longest key list, which sets the plain walk's length."""
    args = [a[:STAGE_B] for a in args]
    name = f"{name}, first {STAGE_B} clouds"
    got = edgeconv.edgeconv_reduce_bwd_stages(*args, values_bf16)
    want = edgeconv.edgeconv_reduce_bwd_stages_plain(*args, values_bf16)
    torch.cuda.synchronize()
    for kernel, labels in (("csr", ("offsets", "edges")), ("rows", ("jmax", "jmin", "dv")),
                           ("keys", ("du",))):
        for label in labels:
            i = BWD_STAGES.index(label)
            if not torch.equal(got[i], want[i]):
                bad = (got[i] != want[i]).sum().item()
                fail(f"{name}: the {kernel} kernel's {label} differs from its plain "
                     f"version in {bad} of {got[i].numel()} elements")
    offsets = got[BWD_STAGES.index("offsets")]
    longest = (offsets[:, 1:] - offsets[:, :-1]).max().item()
    print(f"  {name}: csr (offsets, edges), rows (jmax, jmin, dv) and keys (du) "
          f"equal to their plain versions bit for bit; longest key list {longest} entries",
          flush=True)


def va_inputs(n, gen, device, d=D_MODEL, xyz=None):
    """Seeded inputs of one vector-attention call: clouds in the unit ball
    (or ``xyz``), unit-normal q/key/val, weights scaled as flax's Dense
    init and small biases."""
    if xyz is None:
        xyz = torch.randn((B, n, 3), generator=gen, device=device)
        xyz = xyz / xyz.norm(dim=-1).amax(dim=1)[:, None, None]

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    return [xyz, rnd(B, n, d), rnd(B, n, d), rnd(B, n, d),
            rnd(3, d, scale=3**-0.5), rnd(d, scale=0.1), rnd(d, d, scale=d**-0.5),
            rnd(d, scale=0.1), rnd(d, d, scale=d**-0.5), rnd(d, scale=0.1),
            rnd(d, d, scale=d**-0.5), rnd(d, scale=0.1)]


def va_weight_l2_bytes(b, n, d, products):
    """The weight bytes one call of a vector-attention kernel asks of L2 by
    its design, a count and not a reading of the card: each cluster of the
    grid (B clouds × query tiles of 1024/D queries, rounded up to whole
    clusters of ``VA_CLUSTER``) reads each of its ``products`` (D, D)
    weights once, and shares every chunk among its blocks."""
    tiles = math.ceil(n * d / 1024)
    clusters = b * math.ceil(tiles / VA_CLUSTER)
    return clusters * products * d * d * 4


def ops_bounds(nbytes, dd_flops, other_flops, bf16=False):
    """(bound_ms, bound_by, f32_ms): the larger of the bytes over HBM
    bandwidth and the operations' time. The D×D products run on the tensor
    cores as 3×TF32 (three TF32 products each, at the TF32 peak), or with
    ``bf16`` (the bf16 mode) as one bf16 product each at the bf16 peak, and
    the rest in f32 outside them; ``f32_ms`` is the operations' time were
    all of them f32 outside the tensor cores, as the kernels ran before."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    dd_ms = dd_flops / BF16_FLOP_PER_S if bf16 else 3.0 * dd_flops / TF32_FLOP_PER_S
    t_ops = (dd_ms + other_flops / F32_FLOP_PER_S) * 1e3
    f32_ms = (dd_flops + other_flops) / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), f32_ms


def va_bound(args, k):
    """(bound_ms, bound_by, bytes, flops, f32_bound_ms) of one
    vector-attention call: the inputs (xyz, q, key, val, weights) read once
    at their size (bf16 q, key, val at 2 bytes) and out, m, l, idx written
    once, against B·N·(2·N·C + k·(2·C·D + 6·D²)) operations: the distances,
    the C->D layer and the three D×D products per edge, these on the tensor
    cores (``ops_bounds``; bf16 ones for bf16 key and val)."""
    xyz, q = args[0], args[1]
    Bq, n, c = xyz.shape
    d = q.shape[-1]
    nbytes = (sum(t.numel() * t.element_size() for t in args) + 3 * Bq * n * d * 4
              + Bq * n * k * 4)
    dd_flops = float(Bq) * n * k * 6.0 * d * d
    other = float(Bq) * n * (2.0 * n * c + k * 2.0 * c * d)
    b_ms, b_by, f32_ms = ops_bounds(nbytes, dd_flops, other, args[2].dtype == torch.bfloat16)
    return b_ms, b_by, nbytes, dd_flops + other, max(f32_ms, nbytes / HBM_BYTES_PER_S * 1e3)


def compare_va(name, got, want, require_exact_idx=False, bf16=False):
    """Vector-attention kernel outputs against the plain version's; returns
    the max |diff| of out, m and l on rows whose neighbour sets agree. With
    ``bf16`` (the bf16 mode) the limits are VA_BF16_REL_TOL element by
    element and VA_BF16_REL_L2 over the agreeing rows."""
    g_idx, w_idx = got[3].long(), want[3].long()
    same_set = (torch.sort(g_idx, -1).values == torch.sort(w_idx, -1).values).all(-1)
    share = same_set.float().mean().item()
    ordered = (g_idx == w_idx).all(-1).float().mean().item()
    tol = VA_BF16_REL_TOL if bf16 else VA_REL_TOL
    max_err, parts = 0.0, []
    for label, g, w in zip(("out", "m", "l"), got[:3], want[:3]):
        if not torch.isfinite(g).all():
            fail(f"{name}: {label} has non-finite values")
        d = (g - w).abs()[same_set]
        rel = (d / torch.clamp(w.abs()[same_set], min=1.0)).max().item() if d.numel() else 0.0
        err = d.max().item() if d.numel() else 0.0
        max_err = max(max_err, err)
        parts.append(f"{label} {err:.3e} (rel {rel:.3e})")
        if rel > tol:
            fail(f"{name}: {label} differs by {rel:.3e} relative on agreeing rows (> {tol})")
        if bf16 and d.numel():
            l2 = (d.double().norm() / w[same_set].double().norm().clamp(min=1e-30)).item()
            parts[-1] = parts[-1][:-1] + f", rel L2 {l2:.3e})"
            if l2 > VA_BF16_REL_L2:
                fail(f"{name}: {label} differs by {l2:.3e} relative L2 on agreeing rows "
                     f"(> {VA_BF16_REL_L2})")
    print(f"  {name}: sets agree on {share:.6f} of rows, order on {ordered:.6f}; "
          f"max |diff| on agreeing rows: {', '.join(parts)}", flush=True)
    if require_exact_idx and not torch.equal(g_idx, w_idx):
        fail(f"{name}: neighbour indices differ on an exact-tie input")
    if share < MIN_SET_AGREEMENT:
        fail(f"{name}: neighbour sets agree on {share:.6f} of rows (< {MIN_SET_AGREEMENT})")
    return max_err


def va_bwd_bound(args, k):
    """(bound_ms, bound_by, bytes, flops, f32_bound_ms) of one
    vector-attention backward: the forward's inputs, idx, m, l, out and dout
    read once and the eleven gradients written once (dq f32; dkey and dval
    at key's size), against B·N·k·(18·D² + 4·C·D) operations: per edge
    three D×D products to replay the forward, three back through the chain
    and three outer products for the weight gradients, on the tensor cores
    (bf16 ones for bf16 key and val), and the C->D layer and its gradient
    (``ops_bounds``)."""
    xyz, q = args[0], args[1]
    Bq, n, c = xyz.shape
    d = q.shape[-1]
    kv = args[2].element_size()
    weights = sum(t.numel() * 4 for t in args[4:])
    nbytes = (sum(t.numel() * t.element_size() for t in args[:4]) + weights + Bq * n * k * 4
              + 4 * Bq * n * d * 4 + Bq * n * d * (4 + 2 * kv) + weights)
    dd_flops = float(Bq) * n * k * 18.0 * d * d
    other = float(Bq) * n * k * 4.0 * c * d
    b_ms, b_by, f32_ms = ops_bounds(nbytes, dd_flops, other, args[2].dtype == torch.bfloat16)
    return b_ms, b_by, nbytes, dd_flops + other, max(f32_ms, nbytes / HBM_BYTES_PER_S * 1e3)


def va_bwd_saved(args, k, gen):
    """What the backward takes beside the forward's inputs: idx, m, l, out of
    one forward kernel launch, and a unit-normal cotangent."""
    out, m, l, idx = vector_attention.vector_attention_fwd(*args, k)
    return idx, m, l, out, torch.randn(out.shape, generator=gen, device=out.device)


def compare_va_bwd(name, args, k, gen):
    """The vector-attention backward kernels against the plain version on
    the same inputs, fed one forward launch's idx, m, l, out. Chunk by chunk
    of clouds, as the wrapper walks them: the edge kernel's staged tensors
    against ``edge_terms``; dq, dkey, dval and the weight gradients against
    ``reduce_edge_terms`` of those staged tensors; then every output against
    the plain backward. Two calls must agree bit for bit. Returns the
    largest |diff| against the plain sums of the staged tensors. bf16 key
    and val run the bf16 mode, held to the VA_BF16_* limits."""
    va = vector_attention
    bf16 = args[2].dtype == torch.bfloat16
    edge_tol, flip_share_tol, flip_margin, l2_tol = (
        (VA_BF16_EDGE_TOL, VA_BF16_FLIP_SHARE, VA_BF16_FLIP_MARGIN, VA_BF16_BWD_REL_L2) if bf16
        else (VA_EDGE_TOL, VA_MAX_FLIP_SHARE, VA_FLIP_MARGIN, VA_BWD_REL_L2))
    saved = va_bwd_saved(args, k, gen)
    got = va.vector_attention_bwd(*args, k, *saved)
    again = va.vector_attention_bwd(*args, k, *saved)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        fail(f"{name}: two backward calls on the same inputs differ")
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"{name}: the backward has non-finite values")
    del again
    nb, n, d = args[0].shape[0], args[0].shape[1], args[1].shape[-1]
    per_chunk = va.clouds_per_chunk(n, d)
    outputs = va.BWD_NAMES
    own_w = [torch.zeros_like(g, dtype=torch.float64) for g in got[3:]]
    scale_w = [torch.zeros_like(g, dtype=torch.float64) for g in got[3:]]
    plain_w = [torch.zeros_like(g, dtype=torch.float64) for g in got[3:]]
    plain_rows = [[], [], []]
    edge_err = dict.fromkeys(("delta", "relu_d", "att_in", "relu_g", "dvpos", "dzs", "dh_g",
                              "datt", "dpos", "dh_d"), 0.0)
    edge_sq = {t: [0.0, 0.0] for t in edge_err}  # squared norms of the differences and of plain
    sum_err = dict.fromkeys(outputs, 0.0)
    max_abs, flips, flip_value, elements = 0.0, 0, 0.0, 0

    def held(label, g, w, scale):
        nonlocal max_abs
        g, w, scale = g.double(), w.double(), scale.double()
        diff = (g - w).abs()
        max_abs = max(max_abs, diff.max().item())
        if bf16 and label in ("dkey", "dval"):  # both round an f32 sum to bf16: one step apart
            _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
            diff = torch.clamp(diff - torch.ldexp(torch.ones_like(diff), e - 8), min=0.0)
        sum_err[label] = max(sum_err[label],
                             (diff / torch.clamp(scale, min=scale.mean().item())).max().item())

    for b0 in range(0, nb, per_chunk):
        c = slice(b0, b0 + per_chunk)
        cargs = [a[c] for a in args[:4]] + list(args[4:])
        csaved = [t[c] for t in saved]
        dq_k, staged = va.staged_edge_terms(*cargs, k, *csaved)
        if not torch.equal(dq_k, got[0][c]):
            fail(f"{name}: the edge kernel alone and inside the backward give different dq")
        if k < vector_attention.MAX_K:
            past_k = max(staged[t][:, :, k:].abs().max().item()
                         for t in ("dvpos", "dzs", "dh_g", "datt", "dpos", "dh_d"))
            if past_k != 0.0:
                fail(f"{name}: a slot past k holds a cotangent of {past_k:.3e}, not zero")
        own = {t: v[:, :, :k] for t, v in staged.items()}
        plain = va.edge_terms(*cargs, *csaved)
        if bf16:  # the edge kernel stages delta as the bf16 mode's products take it
            plain["delta"] = va.round_bf16(plain["delta"])
        # relus that switch differently, and the edges they reach
        flip_g = (own["relu_g"] > 0) != (plain["relu_g"] > 0)
        flip_d = (own["relu_d"] > 0) != (plain["relu_d"] > 0)
        for flip, t in ((flip_g, "relu_g"), (flip_d, "relu_d")):
            flips += int(flip.sum())
            elements += flip.numel()
            if flip.any():
                value = torch.maximum(own[t], plain[t])[flip].max().item()
                if bf16:  # relative to the tensor's rms
                    value /= plain[t].square().mean().sqrt().item()
                flip_value = max(flip_value, value)
        clean = {"dh_g": ~flip_g.any(-1), "dh_d": ~(flip_g.any(-1) | flip_d.any(-1))}
        clean["datt"] = clean["dpos"] = clean["dh_g"]
        for t in edge_err:
            rel = (own[t] - plain[t]).abs() / torch.clamp(plain[t].abs(),
                                                          min=plain[t].square().mean().sqrt().item())
            keep = clean.get(t, slice(None))
            if t in clean:
                rel = rel[keep]
            if rel.numel():
                edge_err[t] = max(edge_err[t], rel.max().item())
                edge_sq[t][0] += (own[t] - plain[t])[keep].double().square().sum().item()
                edge_sq[t][1] += plain[t][keep].double().square().sum().item()
        del rel, flip_g, flip_d, clean
        idx_c = csaved[0]
        sums = va.reduce_edge_terms(own, idx_c, bf16)
        scales = [s_.abs() for s_ in va.reduce_edge_terms({t: v.abs() for t, v in own.items()},
                                                          idx_c, bf16)]
        for i in range(3):
            held(outputs[i], got[i][c], sums[i], scales[i])
        plain_sums = va.reduce_edge_terms(plain, idx_c, bf16)
        for i in range(3):
            plain_rows[i].append(plain_sums[i])
        for i in range(len(own_w)):
            own_w[i] += sums[3 + i].double()
            scale_w[i] += scales[3 + i].double()
            plain_w[i] += plain_sums[3 + i].double()
        del staged, own, plain, sums, scales, plain_sums
    for i, g in enumerate(got[3:]):
        held(outputs[3 + i], g.double(), own_w[i], scale_w[i])
    l2 = {}
    for i, label in enumerate(outputs):
        w = torch.cat(plain_rows[i]) if i < 3 else plain_w[i - 3]
        ref = scale_w[i - 3] if label == "dbg2" else w
        l2[label] = ((got[i].double() - w).norm() / ref.double().norm().clamp(min=1e-30)).item()
    flip_share = flips / max(elements, 1)
    edge_l2 = {t: math.sqrt(d / max(p, 1e-300)) for t, (d, p) in edge_sq.items()}
    print(f"  {name}: staged edge tensors within {max(edge_err.values()):.3e} "
          f"(worst {max(edge_err, key=edge_err.get)}; relative L2 {max(edge_l2.values()):.3e}, "
          f"worst {max(edge_l2, key=edge_l2.get)}), {flips} relu flips ({flip_share:.2e} of "
          f"the elements, values up to {flip_value:.2e}); sums of the staged tensors within "
          f"{max(sum_err.values()):.3e} of their terms (worst {max(sum_err, key=sum_err.get)}, "
          f"max |diff| {max_abs:.3e}); against the plain backward within {max(l2.values()):.3e} "
          f"relative L2 (worst {max(l2, key=l2.get)}); two calls bit-identical", flush=True)
    for t, err in edge_err.items():
        if err > edge_tol:
            fail(f"{name}: staged {t} differs by {err:.3e} of max(|plain|, rms) (> {edge_tol})")
        if bf16 and edge_l2[t] > VA_BF16_EDGE_L2:
            fail(f"{name}: staged {t} differs by {edge_l2[t]:.3e} relative L2 "
                 f"(> {VA_BF16_EDGE_L2})")
    if flip_share > flip_share_tol or flip_value > flip_margin:
        fail(f"{name}: {flips} relu flips ({flip_share:.2e} of the elements) at values up to "
             f"{flip_value:.2e}" + (" of the rms" if bf16 else ""))
    for label, err in sum_err.items():
        if err > VA_SUM_TOL:
            fail(f"{name}: {label} differs by {err:.3e} of its terms' magnitude (> {VA_SUM_TOL})")
    for label, err in l2.items():
        if err > l2_tol:
            fail(f"{name}: {label} differs from the plain backward by {err:.3e} relative L2 "
                 f"(> {l2_tol})")
    if bf16:
        for label, g in zip(outputs[1:3], got[1:3]):
            if g.dtype != torch.bfloat16:
                fail(f"{name}: {label} is {g.dtype}, not bf16 as key and val")
    return max_abs


def compare_min_dists(name, q, s):
    """The min-dists kernel against its plain version in both directions,
    each min to MIN_DIST_REL of max(|q|² + max_m |s|², 1), and the chamfer of
    the two launches (``chamfer_tiled``) against the plain chamfer, to twice
    that of the clouds' largest squared norms. Returns the max |diff|."""
    gk = geometry_kernels
    max_err, parts = 0.0, []
    for label, a, b in (("q->s", q, s), ("s->q", s, q)):
        got, want = gk.min_dists(a, b), gk.min_dists_plain(a, b)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"min-dists {name} {label}: non-finite values")
        scale = torch.clamp((a * a).sum(-1) + (b * b).sum(-1).amax(1)[:, None], min=1.0)
        d = (got - want).abs()
        rel = (d / scale).max().item()
        max_err = max(max_err, d.max().item())
        parts.append(f"{label} {d.max().item():.3e} (rel {rel:.3e})")
        if rel > MIN_DIST_REL:
            fail(f"min-dists {name} {label}: differs by {rel:.3e} of the squared norms "
                 f"(> {MIN_DIST_REL})")
    got = gk.chamfer_tiled(q, s)
    want = torch.mean(gk.min_dists_plain(q, s), 1) + torch.mean(gk.min_dists_plain(s, q), 1)
    err = (got - want).abs().max().item()
    tol = 2 * MIN_DIST_REL * max((q * q).sum(-1).max().item() + (s * s).sum(-1).max().item(), 1.0)
    print(f"  {name}: mins max |diff| {', '.join(parts)}; chamfer (B,) max |diff| {err:.3e} "
          f"(|chamfer| up to {want.abs().max().item():.3e})", flush=True)
    if err > tol:
        fail(f"min-dists {name}: the chamfer differs by {err:.3e} (> {tol:.3e})")
    return max(max_err, err)


def compare_fps(name, xyz, npoint, gen):
    """The FPS kernel against its plain version from random starts: the
    indices equal index for index, and two launches bit-identical."""
    gk = geometry_kernels
    starts = torch.randint(0, xyz.shape[1], (xyz.shape[0],), generator=gen, device=xyz.device)
    starts[0] = xyz.shape[1] - 1  # a start at the cloud's last point
    got, again = gk.fps(xyz, npoint, starts), gk.fps(xyz, npoint, starts)
    want = gk.fps_plain(xyz, npoint, starts)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"FPS {name}: two launches on the same inputs differ")
    if not torch.equal(got, want):
        rows = int((got != want).any(-1).sum())
        fail(f"FPS {name}: indices differ from the plain loop in {rows} of {len(got)} clouds")
    distinct = min(len(torch.unique(r)) for r in got)
    print(f"  {name} (team {gk.fps_plan(xyz.shape[1])}): indices equal in all "
          f"{tuple(got.shape)}; two launches bit-identical; at least {distinct} distinct "
          "indices per cloud", flush=True)


def check_fps(gen, dev):
    """FPS at every case of ``FPS_SHAPES`` on random clouds and on a lattice
    with duplicate points (13^3 sites: integer distances that tie), and on
    zero-padded clouds; a cloud above the launcher's limit refused; the
    wrapper without a read back to the host; an out-of-range start on the
    card ending in a CUDA error in a child process."""
    gk = geometry_kernels
    print("FPS kernel vs plain (indices exact, two launches bit-identical):", flush=True)
    for b, n, npoint in FPS_SHAPES:
        compare_fps(f"B={b} N={n} npoint={npoint}", unit_clouds(b, n, gen, dev), npoint, gen)
        lattice = torch.randint(-6, 7, (b, n, 3), generator=gen, device=dev).float()
        compare_fps(f"lattice B={b} N={n} npoint={npoint}", lattice, npoint, gen)
    for n, real in ((N_LARGE, 2048), (N_POINTS, 600)):
        compare_fps(f"zero-padded B={B} N={n} ({real} real) npoint=64",
                    unit_clouds(B, n, gen, dev, real), 64, gen)
    try:
        gk.fps(unit_clouds(1, FPS_REFUSED, gen, dev), 4)
    except RuntimeError as e:
        print(f"  N={FPS_REFUSED} refused: {e}", flush=True)
    else:
        fail(f"FPS took a cloud of {FPS_REFUSED} points, above its launcher's limit")
    # no device-to-host copy: the starts on the card, and None
    from sug_tpu_torch.ops.geometry import farthest_point_sample

    xyz = unit_clouds(B, N_POINTS, gen, dev)
    starts = torch.randint(0, N_POINTS, (B,), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [gk.fps(xyz, 64, starts), farthest_point_sample(xyz, 64, starts), gk.fps(xyz, 64)]
    except RuntimeError as e:
        fail(f"FPS synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(got[0], got[1]) and torch.equal(got[2][:, 0], torch.zeros_like(starts))):
        fail("FPS under the sync check gave other indices")
    print("  fps and farthest_point_sample under torch.cuda.set_sync_debug_mode('error'): no "
          "synchronising call", flush=True)
    # an out-of-range start: the kernel's device-side assert, in a child
    # process (the fault leaves the CUDA context unusable)
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]);"
            "from sug_tpu_torch.ops import geometry_kernels as gk;"
            "x = torch.rand((4, 100, 3), device='cuda');"
            "out = gk.fps(x, 8, torch.tensor([0, 1, 100, 2], device='cuda'));"
            "torch.cuda.synchronize(); print('INDICES', out.tolist())")
    child = subprocess.run([sys.executable, "-c", code, HERE], capture_output=True, text=True,
                           timeout=300)
    lines = [ln for ln in child.stderr.splitlines() if "CUDA error" in ln]
    print(f"  start 100 of a 100-point cloud, in a child process: exit {child.returncode}, "
          f"{lines[-1] if lines else 'no CUDA error'}", flush=True)
    if child.returncode == 0 or "INDICES" in child.stdout or not lines:
        fail(f"FPS with an out-of-range start: exit {child.returncode}, stdout "
             f"{child.stdout[-300:]!r}, stderr {child.stderr[-600:]!r}")


def randomize_bn(model, gen):
    """Random BN running stats, scales of random sign (about a third
    negative, so the EdgeConv epilogue takes its amin branch) and biases."""
    from sug_tpu_torch.models.bn import BatchNorm
    from sug_tpu_torch.models.dgcnn import EdgeConvBlock

    def fill(mean, var, scale, bias):
        n = mean.numel()
        mean.copy_(0.2 * torch.randn(n, generator=gen))
        var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
        sign = torch.where(torch.rand(n, generator=gen) < 0.35, -1.0, 1.0)
        scale.copy_(sign * (0.5 + torch.rand(n, generator=gen)))
        bias.copy_(0.1 * torch.randn(n, generator=gen))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                fill(m.running_mean, m.running_var, m.weight, m.bias)
            elif isinstance(m, EdgeConvBlock):
                fill(m.bn_mean, m.bn_var, m.bn_scale, m.bn_bias)


def synthetic_clouds(rng, m, n=N_POINTS):
    """m raw clouds of n points and their labels in 10 classes: boxes and
    ellipsoid shells whose aspect ratios depend on the class."""
    labels = np.arange(m) % 10
    pts = rng.normal(size=(m, n, 3))
    shell = labels % 2 == 0
    pts[shell] /= np.linalg.norm(pts[shell], axis=-1, keepdims=True)
    pts[~shell] = rng.uniform(-1, 1, size=pts[~shell].shape)
    aspect = 0.3 + 0.15 * labels[:, None] * np.array([1.0, 0.5, 0.25])[None, :]
    pts = pts * aspect[:, None, :] + rng.normal(0, 0.01, size=pts.shape)
    return (3.0 * pts + 1.0).astype(np.float32), labels.astype(np.int64)


def profile_device(fn, what: str, wall_ms: float, iters: int = 3):
    """Device time per call of ``fn`` by kernel (torch.profiler), and the
    share of the CUDA-event time ``wall_ms`` the device was busy. Returns
    (busy share, kernels per call), or None where the profiler recorded no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3 / iters, e.count / iters, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    if busy == 0.0:
        print(f"profile {what}: the profiler recorded no device time (not measured)", flush=True)
        return None
    print(f"profile {what}: device busy {busy:.3f} ms per call, {busy / wall_ms:.1%} of the "
          f"{wall_ms:.3f} ms call; {sum(r[1] for r in rows):.0f} kernels per call; "
          "top kernels (ms per call, launches per call):", flush=True)
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.4f} ms  x{n:<5g} {key[:110]}", flush=True)
    return busy / wall_ms, sum(r[1] for r in rows)


def kernel_split(fn, what: str, wall_ms: float, kernels, iters: int = 3):
    """Device time per launch of each of ``kernels`` ((label, name in the
    profiler) pairs: the EdgeConv forward's or backward's), from a
    torch.profiler run over ``iters`` calls of ``fn``, each kernel's time over
    the launches it recorded, beside the CUDA-event time of one call. Returns
    {label: ms per launch}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split, parts = {}, []
    for label, kernel in kernels:
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        n = sum(e.count for e in rows)
        split[label] = sum(e.self_device_time_total for e in rows) / 1e3 / n if n else float("nan")
        parts.append(f"{label} {split[label]:.4f} ms ({n} of {iters} launches recorded)")
    print(f"  split of {what} by kernel, device time per launch: {', '.join(parts)}; "
          f"the call {wall_ms:.4f} ms", flush=True)
    return split


def write_pointda_tree(root, rng, num_points=N_POINTS, every_train=False):
    """Synthetic train and test dumps of modelnet, shapenet and scannet, of
    ``num_points`` raw points each; at N_LARGE modelnet's clouds have 2048
    points (PointDA-10's size), so the training path zero-pads them, and
    scannet's 5000, so its ingest subsamples them. Modelnet's train split
    has TRAIN_PER_CLASS clouds a class, and with ``every_train`` so has
    every dataset's (two trained domains); the others have 2."""
    from sug_tpu_torch.data.datasets import DATASET_LIST, make_synthetic_pointda

    raw_points = dict.fromkeys(DATASET_LIST, num_points)
    if num_points == N_LARGE:
        raw_points.update(modelnet=2048, scannet=5000)
    for name in DATASET_LIST:
        os.makedirs(os.path.join(root, name))
        many = every_train or name == "modelnet"
        for split, per_class in (("train", TRAIN_PER_CLASS if many else 2),
                                 ("test", TEST_PER_CLASS)):
            pts, labels = make_synthetic_pointda(num_per_class=per_class,
                                                 num_points=raw_points[name],
                                                 seed=int(rng.integers(1 << 30)))
            np.save(os.path.join(root, name, f"{split}_pts.npy"), pts)
            np.save(os.path.join(root, name, f"{split}_label.npy"), labels)


def reset_counts():
    edgeconv.edgeconv_reduce.launches = 0
    edgeconv.edgeconv_reduce_bwd.launches = 0
    vector_attention.vector_attention_fwd.launches = 0
    vector_attention.vector_attention_bwd.calls = 0
    for kernel in VA_BWD_KERNELS:
        vector_attention.vector_attention_bwd.launches[kernel] = 0
    geometry_kernels.fps.launches = 0
    geometry_kernels.min_dists.launches = 0


def counts():
    """Since ``reset_counts``, by name (``COUNTERS``): EdgeConv forward and
    backward launches, vector-attention forward launches and backward calls
    (each backward kernel's own launches are in
    ``vector_attention_bwd.launches``), FPS and min-dists launches."""
    torch.cuda.synchronize()
    return dict(zip(COUNTERS, (
        edgeconv.edgeconv_reduce.launches, edgeconv.edgeconv_reduce_bwd.launches,
        vector_attention.vector_attention_fwd.launches,
        vector_attention.vector_attention_bwd.calls,
        geometry_kernels.fps.launches, geometry_kernels.min_dists.launches)))


def expected(model_name, num_points, steps, evals, variant=None):
    """The launch counts of ``steps`` train steps and ``evals`` eval (or
    serving) batches of a main path (``variant`` "stacked", "source" or
    "alternating", else the DG trainer's sequential path), by name, from
    ``MAIN_PATHS``."""
    per_step, per_eval = MAIN_PATHS[(model_name, num_points) + ((variant,) if variant else ())]
    return {k: steps * s + evals * e for k, s, e in zip(COUNTERS, per_step, per_eval)}


def check_launches(what, model_name, num_points, steps, evals, variant=None):
    """Fails unless the launches since ``reset_counts`` are ``MAIN_PATHS``'
    for ``steps`` train steps and ``evals`` eval batches of the path."""
    got, want = counts(), expected(model_name, num_points, steps, evals, variant)
    print(f"  {what}: launches {got}", flush=True)
    if got != want:
        fail(f"{what}: launches {got}, expected {want} for {steps} steps and {evals} eval "
             "batches")


def va_bwd_launches_per_call(batch):
    """Each backward kernel's launches in the five backward calls of one
    PTran forward of ``batch`` clouds: edge, wgrad, thin and scatter once per
    chunk of clouds of each level, reduce once per level."""
    chunks = sum(math.ceil(batch / vector_attention.clouds_per_chunk(n, D_MODEL))
                 for _, n, _ in VA_SHAPES)
    return {kernel: len(VA_SHAPES) if kernel == "reduce" else chunks for kernel in VA_BWD_KERNELS}


@contextlib.contextmanager
def env(name: str, value):
    """The environment variable ``name`` set to ``value`` inside (unset for
    None), restored after."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def stacked_forward(on: bool):
    """``SUG_STACKED_FORWARD`` set to 1 (``on``) or 0 inside, restored after."""
    return env("SUG_STACKED_FORWARD", "1" if on else "0")


def entry_run(what, main, argv, model_name, num_points, variant, loss_keys, backward_calls):
    """One run of a training front door, ``main(argv)``, on the card,
    counting launches; fails unless every loss of ``loss_keys`` is finite in
    each epoch and the counts are ``MAIN_PATHS``' for the path
    (``model_name`` at ``num_points``, ``variant``) per step and eval batch,
    PTran's backward kernels those of ``backward_calls`` backward calls a
    step (``va_bwd_launches_per_call``). Returns the result, the counts and
    the backward kernels' counts."""
    reset_counts()
    t0 = time.perf_counter()
    result = main(argv)
    got = counts()
    by_kernel = dict(vector_attention.vector_attention_bwd.launches)
    seconds = time.perf_counter() - t0
    steps = sum(h["steps"] for h in result["history"])
    evals = sum(h["eval_batches"] for h in result["history"])
    per_step = {k: (v - expected(model_name, num_points, 0, evals, variant)[k]) / max(steps, 1)
                for k, v in got.items() if v}
    print(f"{what} {model_name} --num_points {num_points} epochs "
          f"{[h['epoch'] for h in result['history']]}: {steps} steps, {evals} eval batches in "
          f"{seconds:.1f} s; launches {got}, per step {per_step}"
          + (f", backward kernels {by_kernel}" if model_name == "PTran" else ""), flush=True)
    for h in result["history"]:
        print(f"  epoch {h['epoch']}: " + " ".join(f"{k} {h[k]:.6f}" for k in loss_keys)
              + f", {h['ms_per_step']:.1f} ms per step incl. host", flush=True)
        if not all(math.isfinite(h[k]) for k in loss_keys):
            fail(f"{what} {model_name} epoch {h['epoch']}: non-finite loss {h}")
    want = expected(model_name, num_points, steps, evals, variant)
    want_by_kernel = {kernel: (backward_calls * steps * n if model_name == "PTran" else 0)
                      for kernel, n in va_bwd_launches_per_call(B).items()}
    if steps == 0 or got != want or by_kernel != want_by_kernel:
        fail(f"{what} {model_name}: launches {got} and backward kernels {by_kernel} for {steps} "
             f"steps and {evals} eval batches, expected {want} and {want_by_kernel}")
    return result, got, by_kernel


def train_run(train_main, root, epochs, model_name, num_points, extra=(), cfg_file=YAML,
              sets=(), stacked=False):
    """One run of the DG training front door on the card (``cfg_file``, by
    default ``DG_unified_loss.yaml``, with ``--set Model`` for DGCNN and
    PTran, PointNet being the config's own model, and ``sets``; the stacked
    forward when ``stacked``), held as ``entry_run`` says (two backward calls
    a step). Returns the result, the counts and the backward kernels'
    counts."""
    argv = ["--source", "modelnet", "--cfg", cfg_file, "--batch_size", str(B),
            "--num_points", str(num_points), "--device", "cuda", "--ckpt_save_interval", "1",
            "--fix_random_seed", *extra, "--set", "DATA_ROOT", root,
            "OPTIMIZATION.NUM_EPOCHES", str(epochs), *sets]
    if model_name != "Pointnet":
        argv += ["Model", model_name]
    settings = " ".join((["stacked"] if stacked else []) + list(sets) + [os.path.basename(cfg_file)])
    with stacked_forward(stacked):
        return entry_run(f"train_dg_single_gpu ({settings})", train_main, argv, model_name,
                         num_points, "stacked" if stacked else None,
                         ("loss_cls", "loss_geo", "loss_sem"), backward_calls=2)


def train_and_resume(train_main, rng, model_name, num_points=N_POINTS, sets=()):
    """The training front door (with ``--set`` pairs ``sets``) for one epoch
    on a synthetic PointDA tree, then ``--resume`` from its checkpoint for a
    second. Returns the first run's counts and its backward kernels' counts."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = os.path.join(tmp, "data", "PointDA_data")
        write_pointda_tree(root, rng, num_points)
        _, got, by_kernel = train_run(train_main, root, 1, model_name, num_points, sets=sets)
        ckpts = sorted(glob.glob(os.path.join(root, "output", "**", "*_checkpoint_epoch_1.pt"),
                                 recursive=True))
        if len(ckpts) != 1:
            fail(f"training wrote {ckpts} as its epoch-1 checkpoint")
        resumed, _, _ = train_run(train_main, root, 2, model_name, num_points,
                                  extra=("--resume", ckpts[0]), sets=sets)
        if [h["epoch"] for h in resumed["history"]] != [1]:
            fail(f"--resume ran epochs {[h['epoch'] for h in resumed['history']]}, expected [1]")
    print(f"--resume from {os.path.basename(ckpts[0])} continued at epoch 1", flush=True)
    return got, by_kernel


def options_runs(train_main, rng, options_yaml):
    """The DG trainer's other options through the training front door, one
    epoch each on a synthetic PointDA tree: DGCNN with the stacked forward,
    the GRL and the contrastive geo and max-hard sem alignments
    (``options_yaml``), and PointNet with per-replica BN in 2 groups on the
    sequential forward. Returns the summed counts of the two runs."""
    from sug_tpu_torch.engine import dg_trainer

    groups, set_bn_groups = [], dg_trainer.set_bn_groups

    def recording(module, n, *args):  # the group count each trainer sets
        groups.append(n)
        set_bn_groups(module, n, *args)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as tmp:
        root = os.path.join(tmp, "data", "PointDA_data")
        write_pointda_tree(root, rng, N_POINTS)
        _, stacked, _ = train_run(train_main, root, 1, "DGCNN", N_POINTS, cfg_file=options_yaml,
                                  stacked=True)
        dg_trainer.set_bn_groups = recording
        try:
            _, grouped, _ = train_run(train_main, root, 1, "Pointnet", N_POINTS, sets=BN_GROUPS_SET)
        finally:
            dg_trainer.set_bn_groups = set_bn_groups
    if groups != [2]:
        fail(f"the per-replica BN run set BN groups {groups}, expected [2]")
    return {k: stacked[k] + grouped[k] for k in COUNTERS}


def classifier_serving(infer, ckpt, model_name, rng, tmp, dev):
    """``infer`` without ``--dg`` from a classifier checkpoint on ``--pts``
    (two batches of 64 clouds), counting launches, and the logits of 16
    clouds on the card against the CPU plain path. Returns the counts."""
    from sug_tpu_torch.data.datasets import PointCloudDataset

    raw, _ = synthetic_clouds(rng, 2 * B)
    pts_file = os.path.join(tmp, f"{model_name}_clouds.npy")
    np.save(pts_file, raw)
    reset_counts()
    result = infer.main(["--ckpt", ckpt, "--model", model_name, "--batch_size", str(B),
                         "--num_points", str(N_POINTS), "--device", "cuda", "--pts", pts_file])
    got, want = counts(), expected(model_name, N_POINTS, 0, 2, "source")
    print(f"infer --model {model_name} (no --dg) --pts: 2 batches; launches {got}", flush=True)
    if got != want:
        fail(f"infer --model {model_name} without --dg: launches {got}, expected {want}")
    first = torch.from_numpy(
        PointCloudDataset("modelnet", raw[:16], np.zeros(16), num_points=N_POINTS).pts)
    with torch.no_grad():
        card = infer.model_logits(infer.load_model(model_name, ckpt, dev, dg=False),
                                  first.to(dev)).cpu()
        cpu = infer.model_logits(infer.load_model(model_name, ckpt, torch.device("cpu"), dg=False),
                                 first)
    check_logits(f"{model_name} classifier N={N_POINTS}", card, cpu, result["preds"])
    return got


def source_runs(train_source, infer, rng, dev, models, sets=(), resume=True):
    """``train_source`` (``direct_inference.yaml`` with ``--set Model`` and
    ``sets``) for one epoch on a synthetic PointDA tree for each of
    ``models`` (each model's outputs in a folder of its own); with
    ``resume``, ``--resume`` from its checkpoint for a second and ``infer``
    without ``--dg`` from the second checkpoint (``classifier_serving``).
    Returns the summed counts and PTran's backward
    kernels' counts."""
    total = dict.fromkeys(COUNTERS, 0)
    by_kernel = dict.fromkeys(VA_BWD_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_source_") as tmp:
        root = os.path.join(tmp, "data", "PointDA_data")
        write_pointda_tree(root, rng)
        for model_name in models:
            for epochs in (1, 2) if resume else (1,):
                extra = ("--resume", latest_checkpoint(root, 1)) if epochs == 2 else ()
                argv = ["--source", "modelnet", "--cfg", SOURCE_YAML, "--batch_size", str(B),
                        "--num_points", str(N_POINTS), "--device", "cuda",
                        "--ckpt_save_interval", "1", "--fix_random_seed", *extra, "--set",
                        "DATA_ROOT", root, "OPTIMIZATION.NUM_EPOCHES", str(epochs), "Model",
                        model_name, "EXTRA_TAG", f"source_{model_name}", *sets]
                result, got, kernels = entry_run(
                    f"train_source {' '.join(sets)}{' --resume' if extra else ''}",
                    train_source.main, argv, model_name, N_POINTS, "source", ("loss",), 1)
                if [h["epoch"] for h in result["history"]] != [epochs - 1]:
                    fail(f"train_source {model_name} ran epochs "
                         f"{[h['epoch'] for h in result['history']]}, expected [{epochs - 1}]")
                total = {k: total[k] + got[k] for k in COUNTERS}
                by_kernel = {k: by_kernel[k] + kernels[k] for k in VA_BWD_KERNELS}
            if resume:
                got = classifier_serving(infer, latest_checkpoint(root, 2), model_name, rng, tmp,
                                         dev)
                total = {k: total[k] + got[k] for k in COUNTERS}
    return total, by_kernel


def latest_checkpoint(root, epoch):
    """The newest ``*_checkpoint_epoch_<epoch>.pt`` under ``root``'s outputs."""
    ckpts = glob.glob(os.path.join(root, "output", "**", f"*_checkpoint_epoch_{epoch}.pt"),
                      recursive=True)
    if not ckpts:
        fail(f"no epoch-{epoch} checkpoint under {root}")
    return max(ckpts, key=os.path.getmtime)


def alternating_runs(train_dg_naive_mmd, train_uda, rng):
    """``train_dg_naive_mmd`` (``DG_baseline.yaml``, DGCNN) and ``train_uda``
    (PointNet, its default, modelnet against shapenet) for one epoch each on
    a synthetic PointDA tree whose every train split holds 260 clouds.
    Returns the summed counts."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_alternating_") as tmp:
        root = os.path.join(tmp, "data", "PointDA_data")
        write_pointda_tree(root, rng, every_train=True)
        losses = ("loss_s", "loss_adv", "loss_node")
        _, naive, _ = entry_run("train_dg_naive_mmd (DG_baseline.yaml)", train_dg_naive_mmd.main, [
            "--source", "modelnet", "--cfg", BASELINE_YAML, "--batch_size", str(B),
            "--num_points", str(N_POINTS), "--device", "cuda", "--ckpt_save_interval", "1",
            "--fix_random_seed", "--set", "DATA_ROOT", root, "OPTIMIZATION.NUM_EPOCHES", "1"],
            "DGCNN", N_POINTS, "alternating", losses, 0)
        latest_checkpoint(root, 1)
        _, uda, _ = entry_run("train_uda", train_uda.main, [
            "-source", "modelnet", "-target", "shapenet", "-b", str(B), "-e", "1",
            "-datadir", root, "-tb_log_dir", os.path.join(tmp, "logs"), "-device", "cuda"],
            "Pointnet", N_POINTS, "alternating", losses, 0)
    return {k: naive[k] + uda[k] for k in COUNTERS}


def loss_gaps(card, cpu):
    """Each loss (name -> float) of the card relative to the CPU's."""
    return {k: abs(card[k] - want) / max(abs(want), 1e-12) for k, want in cpu.items()}


def grad_gaps(card, cpu):
    """Each gradient leaf (name -> float64 CPU tensor) of the card in
    relative L2 from the CPU's, a leaf that is zero up to rounding measured
    against 1e-2 of the largest leaf's norm."""
    floor = 1e-2 * max(g.norm().item() for g in cpu.values())
    return {n: (card[n] - g).norm().item() / max(g.norm().item(), floor) for n, g in cpu.items()}


def no_dropout(model):
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0


def grads_by_name(tr, grads):
    return {n: (torch.zeros_like(p) if g is None else g).double().cpu()
            for (n, p), g in zip(tr.params, grads)}


def near_tie_verdict(tag, differ, allowed=None, near_tie=NEAR_TIE_REL, policy=""):
    """Fail unless every row on which the CPU's kNN chose another EdgeConv
    neighbour set than the card's (``differ`` as ``card_neighbours``
    gathers it) is a near tie: no row of the card's repeats a key, the two
    sets' k-th distances are within ``near_tie`` of |q|² + |key|², and there
    are at most ``allowed`` such rows (1 − MIN_SET_AGREEMENT of the rows
    where None); ``policy`` says why a limit was widened. Returns the
    agreement in words."""
    rows, chosen_otherwise, widest, repeats = differ
    if allowed is None:
        allowed = (1.0 - MIN_SET_AGREEMENT) * rows
    if repeats:
        fail(f"{tag} card vs CPU: the card's EdgeConv neighbour sets repeat a key on {repeats} rows")
    if widest > near_tie:
        fail(f"{tag} card vs CPU: where the CPU's kNN chose other EdgeConv neighbours, the k-th "
             f"distances differ by up to {widest:.3e} of |q|² + |key|² (> {near_tie:.3e}{policy})")
    if chosen_otherwise > allowed:
        fail(f"{tag} card vs CPU: the CPU's kNN chose other EdgeConv neighbour sets on "
             f"{chosen_otherwise} of {rows} rows (more than {1.0 - MIN_SET_AGREEMENT:.1%}{policy})")
    return (f"the CPU's kNN chose another set on {chosen_otherwise} of {rows} rows{policy}, "
            f"k-th distances within {widest:.3e} of |q|² + |key|²")


def held_card_against_cpu(tag, case, replay, replayer=None, verdict=None,
                          replayed="EdgeConv neighbours"):
    """``case(device)`` -> (losses, gradients or None) pairs, on the card and
    on the CPU plain path, every loss held to MAX_LOSS_REL and every
    gradient leaf to MAX_GRAD_REL_L2. With ``replay`` the CPU runs on the
    card's EdgeConv neighbours (``replayer``, by default ``card_neighbours``;
    ``card_ball_groups`` replays PointNet++'s ball queries), each row it
    would choose otherwise held to a near tie (``verdict``, by default
    ``near_tie_verdict``). Without it each device chooses its own neighbours
    first, and only where the limits fail does the CPU run again on the
    card's."""
    replayer, verdict = replayer or card_neighbours, verdict or near_tie_verdict
    calls, differ = [], [0, 0, 0.0, 0]
    with replayer("cuda", calls, None, differ):
        card = case("cuda")

    def worst(cpu):
        gaps = [(rel, k, MAX_LOSS_REL) for (lc, _), (lw, _) in zip(card, cpu)
                for k, rel in loss_gaps(lc, lw).items()]
        gaps += [(rel, n, MAX_GRAD_REL_L2) for (_, gc), (_, gw) in zip(card, cpu)
                 if gw is not None for n, rel in grad_gaps(gc, gw).items()]
        over = [g for g in gaps if g[0] > g[2]]
        losses = max(g[0] for g in gaps if g[2] == MAX_LOSS_REL)
        grads = max([g for g in gaps if g[2] == MAX_GRAD_REL_L2], default=(0.0, "none"))
        return over, f"losses within {losses:.3e} relative, gradients within {grads[0]:.3e} " \
                     f"relative L2 (worst {grads[1]})"

    over = True
    on = "each device choosing its own neighbours"
    if not replay:
        over, within = worst(case("cpu"))
        if over:
            print(f"{tag}, card vs CPU on each device's own neighbours: {len(over)} outside "
                  f"their limits (worst {max(over)[1]} at {max(over)[0]:.3e}); again on the "
                  f"card's {replayed}", flush=True)
    if over:
        with replayer("cpu", calls, torch.arange(CARD_B), differ):
            over, within = worst(case("cpu"))
        on = f"on the card's {replayed} ({verdict(tag, differ)})"
    if over:
        fail(f"{tag} card vs CPU {on}: {len(over)} outside their limits, the worst " + "; ".join(
            f"{name} {rel:.3e} (> {limit})" for rel, name, limit in sorted(over, reverse=True)[:5]))
    print(f"{tag}, card vs CPU {on}: {within}", flush=True)
    return card


def new_paths_card_against_cpu(baseline_cfg, rng):
    """At B=``CARD_B`` with the same weights, batch and FPS starts and no
    dropout, on the card and on the CPU plain path (``held_card_against_cpu``):
    one source-only ``_loss`` of the DGCNN classifier and its gradients, the
    CPU on the card's EdgeConv neighbours; one naive-mode alternating step
    of DGCNN (``DG_baseline.yaml``, its FocalLoss), each device on its own
    neighbours unless the limits fail: phase A's losses and gradients, then
    the ``g`` and ``c`` steps and phase B's loss. Phase B's gradients are not
    compared (the sigma=0.01 MMD kernel turns the rounding of the zero
    self-distance into noise)."""
    from sug_tpu_torch.data.datasets import PointCloudDataset, make_synthetic_pointda
    from sug_tpu_torch.engine.alternating_trainer import AlternatingTrainer
    from sug_tpu_torch.engine.dg_trainer import make_criterion
    from sug_tpu_torch.engine.source_trainer import SourceTrainer

    pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N_POINTS, seed=7)
    ds = PointCloudDataset("modelnet", pts, labels, num_points=N_POINTS, model="DGCNN")
    fps = torch.from_numpy(rng.integers(0, N_POINTS, CARD_B))

    def batch(dev):
        return [torch.from_numpy(a).to(dev) for a in
                (ds.pts[:CARD_B], ds.labels[:CARD_B].astype(np.int64),
                 ds.pts[-CARD_B:], ds.labels[-CARD_B:].astype(np.int64))]

    def source(dev):
        tr = SourceTrainer("DGCNN", augment=False, device=dev, seed=0)
        no_dropout(tr.model)
        loss, _ = tr._loss(*batch(dev)[:2])
        return [({"loss": loss.item()}, grads_by_name(tr, tr.grads(loss)))]

    def alternating(dev):
        tr = AlternatingTrainer("DGCNN", mode="naive", cfg=baseline_cfg, augment=False,
                                device=dev, seed=0,
                                criterion=make_criterion(baseline_cfg["OPTIMIZATION"], ds, 10, dev))
        no_dropout(tr.model)
        tr.model.train()
        data = batch(dev)
        loss_a, metrics = tr._loss_a(*data, 0.5)
        grads = tr.grads(loss_a)
        tr.optimizer.step(grads, {"g": 1e-4})
        tr.optimizer.step(grads, {"c": 1e-4})
        loss_b = tr._loss_b(*data, fps.to(dev))
        return [({"loss_a": loss_a.item(), **{k: v.item() for k, v in metrics.items()}},
                 grads_by_name(tr, grads)), ({"loss_node": loss_b.item()}, None)]

    # at this seed one row of the classifier's 32768 is a near tie that
    # each device breaks its own way (PERF.md, PR 15): replay from the start
    held_card_against_cpu(f"DGCNN classifier source-only _loss at B={CARD_B}, N={N_POINTS}",
                          source, replay=True)
    card = held_card_against_cpu(f"DGCNN alternating naive step at B={CARD_B}+{CARD_B}, "
                                 f"N={N_POINTS} (phase A's losses and gradients, phase B's loss)",
                                 alternating, replay=False)
    print(f"  the card's losses: {card[0][0]}, {card[1][0]}", flush=True)


def ball_tie_gaps(xyz, new_xyz, radius, a, b):
    """For the rows where the ball-query groups ``a`` and ``b`` (B, S,
    nsample) of centroids ``new_xyz`` (B, S, 3) among ``xyz`` (B, N, 3)
    differ: at the first position where they differ, one of the two points
    there lies in one device's ball and not in the other's, and its
    |d² − r²| / r² in float64 is the row's gap (the smaller of the two
    points'). Returns the (R,) gaps of the R differing rows."""
    bi, si = (a != b).any(-1).nonzero(as_tuple=True)
    first = (a[bi, si] != b[bi, si]).int().argmax(-1)
    centre = new_xyz[bi, si].double()
    r2 = float(radius) ** 2
    gaps = [((xyz[bi, idx[bi, si, first]].double() - centre).square().sum(-1) - r2).abs() / r2
            for idx in (a, b)]
    return torch.minimum(*gaps)


@contextlib.contextmanager
def card_ball_groups(device, calls, order, differ):
    """``card_neighbours`` for PointNet++'s ball queries: on the card,
    record the group indices of every ``query_ball_point`` into ``calls``;
    on the CPU, return them in the same order (the batch in ``order``),
    after measuring each row where the CPU's own query chose another group
    (``ball_tie_gaps``). ``differ`` gathers [rows, rows the CPU chose
    otherwise, the largest gap over r², 0]."""
    from sug_tpu_torch.models import pointnet2
    from sug_tpu_torch.ops import geometry

    ball, replay = geometry.query_ball_point, iter(calls)

    def recording(radius, nsample, xyz, new_xyz):
        out = ball(radius, nsample, xyz, new_xyz)
        calls.append(out.cpu())
        return out

    def replaying(radius, nsample, xyz, new_xyz):
        own = ball(radius, nsample, xyz, new_xyz)
        card = next(replay)
        rows = order if len(card) == len(order) else torch.cat([order, order + len(order)])
        card = card[rows].to(own.device)
        gaps = ball_tie_gaps(xyz, new_xyz, radius, card, own)
        differ[0] += own.shape[0] * own.shape[1]
        differ[1] += len(gaps)
        differ[2] = max([differ[2], *gaps.tolist()])
        return card

    patched = recording if device == "cuda" else replaying
    geometry.query_ball_point = pointnet2.query_ball_point = patched
    try:
        yield
    finally:
        geometry.query_ball_point = pointnet2.query_ball_point = ball


def ball_tie_verdict(tag, differ):
    """Fail unless every row on which the CPU's ball query chose another
    group than the card's is a boundary tie, its point within NEAR_TIE_REL
    of the radius in d² (|d² − r²| ≤ NEAR_TIE_REL · r²), and at most
    1 − MIN_SET_AGREEMENT of the rows differ. Returns the agreement in
    words."""
    rows, chosen_otherwise, widest, _ = differ
    if widest > NEAR_TIE_REL:
        fail(f"{tag} card vs CPU: where the CPU's ball query chose another group, the point at "
             f"the first difference lies {widest:.3e} of r² from the radius (> {NEAR_TIE_REL})")
    if chosen_otherwise > (1.0 - MIN_SET_AGREEMENT) * rows:
        fail(f"{tag} card vs CPU: the CPU's ball query chose other groups on {chosen_otherwise} "
             f"of {rows} rows (more than {1.0 - MIN_SET_AGREEMENT:.1%})")
    return (f"the CPU's ball query chose another group on {chosen_otherwise} of {rows} rows, "
            f"each point at the first difference within {widest:.3e} of r² of the radius")


def pointnet2_card_against_cpu(cfg, rng):
    """At B=``CARD_B`` with the same weights, batch and FPS starts and no
    dropout, on the card and on the CPU plain path
    (``held_card_against_cpu``, each device on its own ball queries unless
    the limits fail, then the CPU on the card's, ``card_ball_groups``): one
    PointNet++ DG ``_loss(train=True)``, its losses with the MMD losses on
    and off and its gradients with them off; and one eval forward of the
    MSG segmenter (seeded weights, random BN statistics), its features held
    as a gradient leaf and their mean as a loss."""
    from sug_tpu_torch.data.datasets import PointCloudDataset, make_synthetic_pointda
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.models.pointnet2 import PointNet2MSGSegmenter

    pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N_POINTS, seed=7)
    ds = PointCloudDataset("modelnet", pts, labels, num_points=N_POINTS, model="Pointnet2")
    fps = [torch.from_numpy(rng.integers(0, N_POINTS, CARD_B)) for _ in range(2)]

    def batch(dev):
        return [torch.from_numpy(a).to(dev) for a in
                (ds.pts[:CARD_B], ds.labels[:CARD_B].astype(np.int64),
                 ds.pts[-CARD_B:], ds.labels[-CARD_B:].astype(np.int64))]

    def dg(dev):
        tr = DGTrainer(cfg, model_name="Pointnet2", augment=False, device=dev, seed=0)
        tr.model.c1.dropout_rate = tr.model.c2.dropout_rate = 0.0
        out = []
        for mmd_on in (True, False):
            total, metrics = tr._loss(*batch(dev), *(f.to(dev) for f in fps), mmd_on=mmd_on,
                                      train=True)
            out.append(({f"{k} (mmd {mmd_on})": v.item() for k, v in metrics.items()},
                        None if mmd_on else grads_by_name(tr, tr.grads(total))))
        return out

    def segmenter(dev):
        model = PointNet2MSGSegmenter(generator=torch.Generator().manual_seed(3))
        randomize_bn(model, torch.Generator().manual_seed(4))
        with torch.no_grad():
            out = model.eval().to(dev)(batch(dev)[0]).double().cpu()
        if out.shape != (CARD_B, N_POINTS, 256) or not torch.isfinite(out).all():
            fail(f"MSG segmenter on {dev}: features {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
        return [({"mean feature": out.mean().item()}, {"features": out})]

    for tag, case in ((f"Pointnet2 DG _loss(train=True) at B={CARD_B}, N={N_POINTS}", dg),
                      (f"Pointnet2 MSG segmenter eval forward at B={CARD_B}, N={N_POINTS}",
                       segmenter)):
        held_card_against_cpu(tag, case, replay=False, replayer=card_ball_groups,
                              verdict=ball_tie_verdict, replayed="ball-query groups")


def converted_serving(infer, rng, dev):
    """For each backbone of ``CONVERTED``: a synthetic ``.pth`` under the
    reference repo's key names (``synthetic_reference_state_dict``), wrapped
    under ``state_dict``, converted by ``python -m
    sug_tpu_torch.convert_reference_checkpoint`` in a child process, and its
    ``.pt`` served by ``infer --dg`` on the card (``infer_runs``, launches
    as ``MAIN_PATHS`` says) with the logits of 16 clouds against the CPU
    plain path. Returns the summed counts."""
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.models.net_mda import ensemble_logits
    from sug_tpu_torch.utils.torch_convert import synthetic_reference_state_dict

    total = dict.fromkeys(COUNTERS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as tmp:
        for seed, model_name in enumerate(CONVERTED):
            pth, pt = (os.path.join(tmp, f"{model_name}.{ext}") for ext in ("pth", "pt"))
            sd = synthetic_reference_state_dict(model_name, seed=seed)
            torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
            child = subprocess.run(
                [sys.executable, "-m", "sug_tpu_torch.convert_reference_checkpoint", "--ckpt",
                 pth, "--model", model_name, "--out", pt],
                cwd=HERE, capture_output=True, text=True, timeout=300)
            print(f"convert_reference_checkpoint --model {model_name}: exit {child.returncode}, "
                  f"{child.stdout.strip()}", flush=True)
            if child.returncode != 0:
                fail(f"convert_reference_checkpoint {model_name}: {child.stderr[-600:]}")
            got, raw, preds = infer_runs(infer, pt, model_name, rng, tmp, B)
            total = {k: total[k] + got[k] for k in COUNTERS}
            first = torch.from_numpy(
                PointCloudDataset("modelnet", raw[:16], np.zeros(16), num_points=N_POINTS).pts)
            with torch.no_grad():
                card = ensemble_logits(infer.load_model(model_name, pt, dev), first.to(dev)).cpu()
                cpu = ensemble_logits(infer.load_model(model_name, pt, torch.device("cpu")), first)
            check_logits(f"{model_name} converted from a reference .pth", card, cpu, preds)
    return total


def time_cell(what, model_name, variant, fn, iters, clouds, smi):
    """One timed cell of a new path's step: ms, clouds/s, peak memory, busy
    share and kernels a step, its launches checked against ``MAIN_PATHS``
    (2 warm-up, ``iters`` timed and 2 profiled steps)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms = timed_ms(fn, iters=iters)
    peak = torch.cuda.max_memory_allocated()
    busy = profile_device(fn, what, ms, iters=2)
    check_launches(what, model_name, N_POINTS, iters + 4, 0, variant)
    print(f"{what}: {ms:.3f} ms per step, {clouds / ms * 1e3:.1f} clouds/s, busy "
          + ("not measured" if busy is None else f"{busy[0]:.1%}, {busy[1]:.0f} kernels a step")
          + f"; peak device memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above "
          f"what the script held before); card {smi}", flush=True)


def time_new_paths(step_args, baseline_cfg, smi):
    """Phase 5's cells of the source-only and alternating paths at N_POINTS:
    the source-only step at B and the eval forward per batch of B of each
    classifier, and the alternating step at B+B, naive DGCNN and uda
    PointNet."""
    from sug_tpu_torch.engine.alternating_trainer import AlternatingTrainer
    from sug_tpu_torch.engine.source_trainer import SourceTrainer
    from sug_tpu_torch.models import CLASSIFIERS

    data_s, label_s, data_t, label_t = step_args
    for model_name in CLASSIFIERS:
        trainer = SourceTrainer(model_name, device="cuda", seed=0)
        time_cell(f"source-only train step ({model_name} classifier, B={B}, N={N_POINTS}, "
                  "augmentation)", model_name, "source",
                  lambda: trainer.train_step(data_s, label_s, 1e-4), 5, B, smi)
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            ms = timed_ms(lambda: trainer.eval_logits(data_s), iters=10)
            busy = profile_device(lambda: trainer.eval_logits(data_s),
                                  f"{model_name} classifier forward", ms, iters=2)
        check_launches(f"{model_name} classifier forward", model_name, N_POINTS, 0, 14, "source")
        print(f"forward ({model_name} classifier eval), B={B}, N={N_POINTS}: {ms:.3f} ms per "
              f"batch, {B / ms * 1e3:.1f} clouds/s, busy "
              + ("not measured" if busy is None else f"{busy[0]:.1%}") + f"; card {smi}",
              flush=True)
        del trainer
    for mode, model_name, cfg in (("naive", "DGCNN", baseline_cfg), ("uda", "Pointnet", None)):
        trainer = AlternatingTrainer(model_name, mode=mode, cfg=cfg, device="cuda", seed=0)
        time_cell(f"alternating train step ({mode}, {model_name}, B={B}+{B}, N={N_POINTS}, "
                  "augmentation)", model_name, "alternating",
                  lambda: trainer.train_step(data_s, label_s, data_t, label_t, 1e-4, 1e-4, 1e-4,
                                             0.5), 5, 2 * B, smi)
        del trainer


def near_tie_gaps(q, kv, a, b):
    """For the rows where the neighbour index sets ``a`` and ``b`` (B, S, k)
    of queries ``q`` (B, S, C) among keys ``kv`` (B, N, C) differ: the gap
    between the two sets' k-th distances, in float64, over the row's
    |q|² + max |key|² (the scale of float32's rounding of the distance), and
    whether ``a`` repeats an index on the row. Returns (gaps (R,), repeats
    (R,) bool) for the R differing rows."""
    a_s, b_s = a.sort(-1).values, b.sort(-1).values
    bi, si = (a_s != b_s).any(-1).nonzero(as_tuple=True)
    qq = q[bi, si].double()[:, None, :]  # (R, 1, C)
    dist, norms = [], []
    for idx in (a, b):
        keys = kv[bi[:, None], idx[bi, si]].double()  # (R, k, C)
        dist.append((keys - qq).square().sum(-1).amax(-1))
        norms.append(keys.square().sum(-1).amax(-1))
    scale = qq[:, 0].square().sum(-1) + torch.maximum(*norms)
    gaps = (dist[0] - dist[1]).abs() / scale.clamp(min=torch.finfo(torch.float64).tiny)
    return gaps, (a_s[bi, si, 1:] == a_s[bi, si, :-1]).any(-1)


@contextlib.contextmanager
def card_neighbours(device, calls, order, differ, own_calls=None):
    """Around one ``_loss`` of ``card_against_cpu``: on the card, record the
    neighbour indices of every EdgeConv forward into ``calls``; on the CPU,
    have the plain path's kNN return them in the same order (the batch in
    ``order``), after holding each row where the CPU's own kNN chose another
    set to a near tie (``near_tie_gaps``). ``differ`` gathers [rows, rows
    the CPU chose otherwise, the largest gap over NEAR_TIE_REL's scale,
    rows with a repeated index]; ``own_calls``, where given, (q, kv, the
    CPU's own choice) of each call."""
    if device == "cuda":
        launch = edgeconv._launch

        def recording(*args):
            out = launch(*args)
            calls.append(out[4].cpu())
            return out

        edgeconv._launch = recording
        try:
            yield
        finally:
            edgeconv._launch = launch
        return
    knn, replay = edgeconv.cross_knn_indices, iter(calls)

    def replaying(q, kv, k):
        own, card = knn(q, kv, k), next(replay)
        # a stacked batch holds the source, then the target clouds
        rows = order if len(card) == len(order) else torch.cat([order, order + len(order)])
        card = card[rows].to(torch.int64)
        gaps, repeats = near_tie_gaps(q, kv, card, own)
        if own_calls is not None:
            own_calls.append((q, kv, own))
        differ[0] += own.shape[0] * own.shape[1]
        differ[1] += len(gaps)
        differ[2] = max([differ[2], *gaps.tolist()])
        differ[3] += int(repeats.sum())
        return card

    edgeconv.cross_knn_indices = replaying
    try:
        yield
    finally:
        edgeconv.cross_knn_indices = knn


@contextlib.contextmanager
def own_neighbours(calls):
    """Around one CPU ``_loss``: record the plain path's kNN choices."""
    knn = edgeconv.cross_knn_indices

    def recording(q, kv, k):
        calls.append(knn(q, kv, k))
        return calls[-1]

    edgeconv.cross_knn_indices = recording
    try:
        yield
    finally:
        edgeconv.cross_knn_indices = knn


class _With:
    """``module`` with some attributes replaced."""

    def __init__(self, module, **replaced):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        return self._replaced[name] if name in self._replaced else getattr(self._module, name)


@contextlib.contextmanager
def card_maxima(device, calls):
    """Around one ``_loss`` of ``card_against_cpu``: every max over the
    points (``torch.amax`` over dim 1 in the DGCNN, PointNet and T-Net
    modules) and over the neighbours (dim 2 in PTran's TransitionDowns)
    takes its values at one argmax, the first on the card, noted into
    ``calls``, and the card's on the CPU, call by call. One index, not
    ``amax``'s even split of the gradient over exact ties, which bf16
    makes common among 4096 points."""
    from sug_tpu_torch.models import dgcnn, layers, pointnet, ptran

    replay = iter(calls)

    def over(axis):
        def amax(x, dim):
            if dim != axis:
                return torch.amax(x, dim=dim)
            if device == "cuda":
                idx = torch.argmax(x.detach(), dim=axis, keepdim=True)
                calls.append(idx.cpu())
            else:
                idx = next(replay)
                if idx.shape != x.shape[:axis] + (1,) + x.shape[axis + 1:]:
                    fail(f"card_maxima: a max over dim {axis} of shape {tuple(x.shape)} against "
                         f"the card's {tuple(idx.shape)}")
            return torch.gather(x, axis, idx).squeeze(axis)
        return amax

    modules = {dgcnn: 1, layers: 1, pointnet: 1, ptran: 2}
    for m, axis in modules.items():
        m.torch = _With(torch, amax=over(axis))
    try:
        yield
    finally:
        for m in modules:
            m.torch = torch


@contextlib.contextmanager
def card_transforms(device, calls, own_calls=None):
    """Around one ``_loss`` of ``card_against_cpu``: on the card, note each
    T-Net's output (``TransformNet``, the (B, K, K) matrix) into ``calls``;
    on the CPU, carry the card's matrix forward in place of its own, call
    by call, the gradient flowing through the CPU's own T-Net
    (``own + (card − own).detach()``). ``own_calls``, where given, gathers
    the CPU's own matrices. A T-Net's matrix comes out of bf16 products that
    the two devices round apart by an ulp here and there, and it scales
    every point of the cloud at once."""
    from sug_tpu_torch.models.layers import TransformNet

    forward, replay = TransformNet.forward, iter(calls or [])

    def replaying(self, x):
        own = forward(self, x)
        if own_calls is not None:
            own_calls.append(own.detach().cpu())
        if device == "cuda":
            calls.append(own.detach().cpu())
            return own
        if calls is None:
            return own
        card = next(replay).to(own.device, own.dtype)
        return own + (card - own).detach()

    TransformNet.forward = replaying
    try:
        yield
    finally:
        TransformNet.forward = forward


def open_gates(model):
    """GATE_SHIFT added to every BN's and LayerNorm's bias of ``model``."""
    from sug_tpu_torch.models.bn import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, torch.nn.LayerNorm)):
                m.bias.add_(GATE_SHIFT)
            if hasattr(m, "bn_bias"):
                m.bn_bias.add_(GATE_SHIFT)


def card_against_cpu(cfg, rng, model_name, num_points=N_POINTS, raw_points=None,
                     grl_const=0.0, variant="", replay=False, bf16=False, batch_size=CARD_B):
    """One ``_loss(train=True)`` at B=``batch_size`` with the same weights, batch, FPS
    starts and no dropout, on the card and on the CPU plain path: the losses,
    the batch's chamfer distances (the geo SDA weights' input: ``mean2one``
    truncates 1/mean to an integer, so the weights alone can jump) and every
    parameter's gradient. Clouds of ``raw_points`` points (``num_points``
    when None) are zero-padded to ``num_points``, and then the gradients are
    compared as ``PAD_ZERO_REL`` says. ``grl_const`` is the GRL's λ where
    ``cfg`` turns it on; ``variant`` names the configuration in the output.
    With ``replay`` the CPU runs on the card's EdgeConv neighbours, each row
    it would choose otherwise held to a near tie (``NEAR_TIE_REL``; under
    bf16 the comment below it says more); without
    it each device chooses its own. With ``bf16`` (``cfg`` sets the policy)
    the gates are opened (``open_gates``), the CPU also takes the card's
    maxima over the points (``card_maxima``) and T-Net matrices
    (``card_transforms``) and runs in f32 too (on its own choices), and each
    loss, the gradients as one vector and each gradient leaf are held to the
    CPU's own bf16-vs-f32 distance, as the comment at GATE_SHIFT says."""
    from sug_tpu_torch.data.datasets import PointCloudDataset, make_synthetic_pointda
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.models.bn import BatchNorm
    from sug_tpu_torch.ops.geometry import chamfer_distance

    raw_points = raw_points or num_points
    padded = raw_points < num_points
    tag = f"{model_name} ({variant})" if variant else model_name
    saturated = BF16_SATURATED.get(model_name, 1.0) if bf16 else 1.0
    pts, labels = make_synthetic_pointda(num_per_class=max(2, -(-batch_size // 5)),
                                         num_points=raw_points, seed=7)
    ds = PointCloudDataset("modelnet", pts, labels, num_points=num_points, model=model_name)
    fps = [torch.from_numpy(rng.integers(0, num_points, batch_size)) for _ in range(2)]
    # (device, order of the batch's clouds)
    orders = {"cuda": ("cuda", torch.arange(batch_size)),
              "cpu": ("cpu", torch.arange(batch_size))}
    if padded:
        orders["cpu, batch reversed"] = ("cpu", torch.arange(batch_size).flip(0))
    if bf16:
        orders["cpu f32"] = ("cpu", torch.arange(batch_size))
    runs, chamfer, pad_abs, rms = {}, {}, {}, {}
    # the card's idx and argmax by pass; [rows, rows the CPU chose otherwise, largest gap, repeats]
    neighbours, maxima, differ = {}, {}, [0, 0, 0.0, 0]
    own = {"cpu": {}, "cpu f32": {}}  # under bf16, each CPU run's own kNN choices by pass
    transforms, own_transforms = {}, {"cpu": [], "cpu f32": []}  # the T-Nets' matrices

    def record(name):  # a BN's output on the padded rows, and its rms on the real ones
        def hook(module, args, out):
            if out.dim() == 3 and out.shape[1] == num_points:
                y = out.detach()
                pad_abs[name] = torch.maximum(pad_abs.get(name, torch.zeros(())),
                                              y[:, raw_points:].abs().amax((0, 1)))
                rms[name] = y[:, :raw_points].square().mean((0, 1)).sqrt()
        return hook

    for label, (dev, order) in orders.items():
        tr = DGTrainer(cfg, model_name=model_name, augment=False, device=dev, seed=0,
                       num_points=num_points)
        tr.model.c1.dropout_rate = tr.model.c2.dropout_rate = 0.0
        if label == "cpu f32":
            tr.model.set_compute_dtype(None)
        if bf16:
            open_gates(tr.model)
        if padded and label == "cpu":
            for name, module in tr.model.named_modules():
                if isinstance(module, BatchNorm):
                    module.register_forward_hook(record(name))
        batch = [torch.from_numpy(a)[order].to(dev) for a in
                 (ds.pts[:batch_size], ds.labels[:batch_size].astype(np.int64),
                  ds.pts[-batch_size:], ds.labels[-batch_size:].astype(np.int64))]
        starts = [f[order].to(dev) for f in fps]
        whole = label in ("cuda", "cpu", "cpu f32")  # losses and chamfer too, not only gradients
        if whole:
            chamfer[label] = chamfer_distance(batch[0], batch[2]).double().cpu()
        out = {}
        for mmd_on in ((True, False) if whole else (False,)):
            with contextlib.ExitStack() as stack:
                if replay and label != "cpu f32":
                    stack.enter_context(card_neighbours(
                        dev, neighbours.setdefault(mmd_on, []), order, differ,
                        own["cpu"].setdefault(mmd_on, []) if bf16 and label == "cpu" else None))
                elif replay and bf16:
                    stack.enter_context(own_neighbours(own["cpu f32"].setdefault(mmd_on, [])))
                if bf16:
                    stack.enter_context(card_maxima(dev, maxima.setdefault(mmd_on, [])))
                    stack.enter_context(card_transforms(
                        dev, None if label == "cpu f32" else transforms.setdefault(mmd_on, []),
                        own_transforms.get(label)))
                total, metrics = tr._loss(*batch, *starts, mmd_on=mmd_on, train=True,
                                          grl_const=grl_const)
            g_all = None if mmd_on else tr.grads(total)
            out[mmd_on] = ({k: v.detach().item() for k, v in metrics.items()},
                           None if g_all is None else
                           {n: (torch.zeros_like(p) if g is None else g).double().cpu()
                            for (n, p), g in zip(tr.params, g_all)})
        runs[label] = out
        del tr, batch, starts
    # unit-ball clouds: every min within MIN_DIST_REL of max(|q|² + |s|², 1) <= 2
    chamfer_err = (chamfer["cuda"] - chamfer["cpu"]).abs().max().item()
    if chamfer_err > 2 * 2 * MIN_DIST_REL:
        fail(f"{tag} card vs CPU at N={num_points}: chamfer distances differ by "
             f"{chamfer_err:.3e} (> {2 * 2 * MIN_DIST_REL})")
    allowed, near_tie, policy = None, NEAR_TIE_REL, ""
    if replay and bf16:  # the CPU's own bf16 and f32 choices, measured on its bf16 run's features
        moved, policy_gap = 0, 0.0
        for m in own["cpu"]:
            for (q, kv, mine), theirs in zip(own["cpu"][m], own["cpu f32"][m]):
                gaps, _ = near_tie_gaps(q, kv, theirs, mine)
                moved, policy_gap = moved + len(gaps), max([policy_gap, *gaps.tolist()])
        allowed = max((1.0 - MIN_SET_AGREEMENT) * differ[0], moved)
        near_tie = max(near_tie, policy_gap)
        policy = (f"; the CPU's own bf16 and f32 choices differ on {moved} rows, their k-th "
                  f"distances by up to {policy_gap:.3e}")
    agreed = near_tie_verdict(tag, differ, allowed, near_tie, policy)
    if own_transforms["cpu"]:  # bf16: the card's T-Net matrices against the CPU's own
        card_t = torch.cat([t.flatten() for m in (True, False) for t in transforms[m]])
        cpu_t, cpu_t32 = (torch.cat([t.flatten() for t in own_transforms[k]])
                          for k in ("cpu", "cpu f32"))
        t_gap, t_noise = ((t - cpu_t).double().norm().item() / cpu_t.double().norm().item()
                          for t in (card_t, cpu_t32))
        print(f"  bf16: the card's T-Net matrices carried forward on the CPU, {t_gap:.3e} "
              f"relative L2 from the CPU's own (its bf16 from its f32: {t_noise:.3e})", flush=True)
        if t_gap > t_noise:
            fail(f"{tag} card vs CPU: the T-Net matrices differ by {t_gap:.3e} relative L2 "
                 f"(> the CPU's bf16-vs-f32 {t_noise:.3e})")
    worst_loss = 0.0
    for mmd_on in (True, False):
        for k, want in runs["cpu"][mmd_on][0].items():
            got = runs["cuda"][mmd_on][0][k]
            rel = abs(got - want) / max(abs(want), 1e-12)
            worst_loss = max(worst_loss, rel)
            limit = MAX_LOSS_REL
            if bf16:  # the CPU's own bf16-vs-f32 distance
                noise = abs(runs["cpu f32"][mmd_on][0][k] - want) / max(abs(want), 1e-12)
                if noise >= MAX_BF16_NOISE:
                    fail(f"{tag}: {k} (mmd {mmd_on}) moves by {noise:.3e} between bf16 and f32 "
                         f"on the CPU (>= {MAX_BF16_NOISE}): no test")
                limit = max(limit, saturated * noise)
                if model_name in BF16_SATURATED:
                    limit = max(limit, BF16_SATURATED_LOSS)
            if rel > limit:
                fail(f"{tag} card vs CPU: {k} (mmd {mmd_on}) {got} vs {want}, {rel:.3e} relative "
                     f"(> {limit:.3e})")
    on = f" on the card's EdgeConv neighbours ({agreed})" if replay else ""
    what = (f"{tag} DG _loss(train=True) at B={batch_size}, N={num_points} ({raw_points} "
            f"real points), card vs CPU{on}: chamfer distances within {chamfer_err:.3e} (1/mean "
            f"{1.0 / chamfer['cpu'].mean().item():.4f}); losses within {worst_loss:.3e} relative "
            f"(total {runs['cuda'][True][0]['loss_total']:.6f})")
    g_cpu = runs["cpu"][False][1]
    floor = 1e-2 * max(g.norm().item() for g in g_cpu.values())
    # the channels a BN bias's comparison leaves out (PAD_ZERO_REL)
    zero = {f"{n}.bias": pad_abs[n] <= PAD_ZERO_REL * rms[n] for n in pad_abs}
    zero = {n: z for n, z in zero.items() if z.any()}

    def gap(grads, masked=True):  # relative L2 from the CPU's gradients, leaf by leaf
        rel = {}
        for n, g in g_cpu.items():
            keep = ~zero[n] if masked and n in zero else slice(None)
            rel[n] = (grads[n][keep] - g[keep]).norm().item() / max(g[keep].norm().item(), floor)
        return rel

    rel = gap(runs["cuda"][False][1])
    name = max(rel, key=rel.get)
    print(f"{what}; gradients within {rel[name]:.3e} relative L2 (worst {name})", flush=True)
    grad_limit = MAX_GRAD_REL_L2
    if bf16:
        check_bf16_grads(tag, runs["cuda"][False][1], g_cpu, runs["cpu f32"][False][1], saturated)
        rel = {}  # each leaf held to its own D above
    if padded:
        card_all = gap(runs["cuda"][False][1], masked=False)
        g_rev = runs["cpu, batch reversed"][False][1]
        own, own_all = gap(g_rev), gap(g_rev, masked=False)
        moved = max(own, key=own.get)
        left_out = [f"{int(z.sum())} of {z.numel()} channels of {n} (padded rows within "
                    f"{pad_abs[n[:-5]][z].max().item():.1e} of zero, rms at least "
                    f"{rms[n[:-5]][z].min().item():.3f}; the whole leaf: card {card_all[n]:.3e}, "
                    f"the CPU with the batch reversed {own_all[n]:.3e})" for n, z in zero.items()]
        print(f"  left out: {'; '.join(left_out) or 'nothing'}; elsewhere the CPU's own gradients "
              f"with the batch reversed within {own[moved]:.3e} (worst {moved})", flush=True)
    if rel and rel[name] > grad_limit:
        fail(f"{tag} card vs CPU: gradient of {name} differs by {rel[name]:.3e} relative L2 "
             f"(> {grad_limit:.3e})")


def check_bf16_grads(tag, card, cpu, cpu_f32, factor=1.0):
    """bf16 gradients (name -> float64 CPU tensor) of the card against the
    CPU's, held to the CPU's own bf16-vs-f32 distance D (times ``factor``,
    BF16_SATURATED's for PTran): all leaves as one vector, then each leaf
    against its own D, as the comment at GATE_SHIFT says."""
    def vector(grads):
        return torch.cat([grads[n].flatten() for n in sorted(cpu)])

    whole, whole_d = ((vector(g) - vector(cpu)).norm().item() / vector(cpu).norm().item()
                      for g in (card, cpu_f32))
    top = max(g.norm().item() for g in cpu_f32.values())
    worst, loudest, zero, over = (0.0, 0.0, "", 0.0), (0.0, ""), [], []
    for n in sorted(cpu):
        if cpu_f32[n].norm().item() <= ZERO_LEAF * top:
            zero.append(n)
            if max(card[n].norm().item(), cpu[n].norm().item()) > 1e-2 * top:
                over.append(f"{n}, zero to rounding in f32, at {card[n].norm().item():.3e} on the "
                            f"card and {cpu[n].norm().item():.3e} on the CPU (largest leaf "
                            f"{top:.3e})")
            continue
        scale = max(cpu_f32[n].norm().item(), 1e-2 * top)
        got, d = ((g[n] - cpu[n]).norm().item() / scale for g in (card, cpu_f32))
        if d >= MAX_BF16_NOISE:
            over.append(f"{n} moves by {d:.3e} between bf16 and f32 on the CPU (no test)")
        elif got > max(factor * d, MAX_GRAD_REL_L2):
            over.append(f"{n} differs by {got:.3e} (its bf16-vs-f32 distance {d:.3e})")
        worst = max(worst, (got / max(d, MAX_GRAD_REL_L2), got, n, d))
        loudest = max(loudest, (d, n))
    print(f"  bf16: all gradients as one vector card vs CPU {whole:.3e}, the CPU's bf16 vs its "
          f"f32 (D) {whole_d:.3e}; each leaf against its own D (closest {worst[2]}: "
          f"{worst[1]:.3e} against {worst[3]:.3e}; the largest D {loudest[0]:.3e}, "
          f"{loudest[1]}); zero to rounding on both devices: {len(zero)} leaves", flush=True)
    if whole_d >= MAX_BF16_NOISE:
        over.append(f"all leaves move by {whole_d:.3e} between bf16 and f32 on the CPU (no test)")
    elif whole > max(factor * whole_d, MAX_GRAD_REL_L2):
        over.append(f"all leaves as one vector differ by {whole:.3e} (D {whole_d:.3e})")
    if over:
        fail(f"{tag} bf16 card vs CPU, relative L2: {len(over)} outside their limits: "
             + "; ".join(over))


def check_logits(what, card, cpu, preds, cpu_f32=None, factor=1.0):
    """Logits of the same clouds on the card and on the CPU plain path, and
    ``infer``'s predictions for them. Under bf16, ``cpu_f32`` are the CPU's
    f32 logits: the limits are then the CPU's own bf16-vs-f32 gap (times
    ``factor``, BF16_SATURATED's for PTran) where that exceeds the f32
    ones."""
    diff = (card - cpu).abs()
    disagree = int((card.argmax(-1) != cpu.argmax(-1)).sum())
    disagree_infer = int((torch.from_numpy(preds[:len(cpu)]) != cpu.argmax(-1)).sum())
    max_diff, max_disagree, floor = MAX_LOGIT_DIFF, MAX_ARGMAX_DISAGREE, ""
    if cpu_f32 is not None:
        gap = (cpu - cpu_f32).abs().max().item()
        gap_disagree = int((cpu.argmax(-1) != cpu_f32.argmax(-1)).sum())
        max_diff = max(max_diff, factor * gap)
        max_disagree = math.ceil(factor * max(max_disagree, gap_disagree))
        floor = (f"; the CPU's bf16 against its f32: max |diff| {gap:.3e}, argmax disagrees on "
                 f"{gap_disagree}; limits {max_diff:.3e} and {max_disagree}")
    print(f"{what} logits card vs CPU ({len(cpu)} clouds, |logit| up to {cpu.abs().max():.3f}): "
          f"max |diff| {diff.max():.3e}, median {diff.median():.3e}; argmax disagrees on "
          f"{disagree} (infer's predictions on {disagree_infer}); classes predicted "
          f"{len(np.unique(preds))}{floor}", flush=True)
    if not torch.isfinite(card).all() or diff.max() > max_diff:
        fail(f"{what}: logits differ by {diff.max():.3e} (> {max_diff})")
    if max(disagree, disagree_infer) > max_disagree:
        fail(f"{what}: argmax disagrees on {max(disagree, disagree_infer)} of {len(cpu)} clouds")


def infer_runs(infer, ckpt, model_name, rng, tmp, n_clouds, num_points=N_POINTS):
    """``infer.main`` on ``--pts`` (``n_clouds`` clouds) and on a synthetic
    ``--dataset`` (100 clouds; at N_LARGE of 2048 points, zero-padded), each
    with the launch counts set to 0 just before and read just after; fails
    unless every batch of 64 took ``MAIN_PATHS``' launches per eval batch.
    Returns the summed counts, the raw clouds and their predictions."""
    raw, _ = synthetic_clouds(rng, n_clouds, num_points)
    pts_file = os.path.join(tmp, f"{model_name}_clouds.npy")
    np.save(pts_file, raw)
    root = os.path.join(tmp, f"{model_name}_PointDA")
    os.makedirs(os.path.join(root, "scannet"))
    ds_pts, ds_labels = synthetic_clouds(rng, 100, 2048 if num_points == N_LARGE else num_points)
    np.save(os.path.join(root, "scannet", "test_pts.npy"), ds_pts)
    np.save(os.path.join(root, "scannet", "test_label.npy"), ds_labels)
    common = ["--ckpt", ckpt, "--model", model_name, "--dg", "--batch_size", str(B),
              "--num_points", str(num_points), "--device", "cuda"]
    total = dict.fromkeys(COUNTERS, 0)
    for label, extra, m in (
        ("pts", ["--pts", pts_file], n_clouds),
        ("dataset", ["--dataset", "scannet", "--split", "test", "--data_root", root], 100),
    ):
        reset_counts()
        result = infer.main(common + extra)
        got = counts()
        batches = math.ceil(m / B)
        want = expected(model_name, num_points, 0, batches)
        print(f"infer --model {model_name} --num_points {num_points} --{label}: {batches} "
              f"batches; launches {got}", flush=True)
        if got != want:
            fail(f"infer --model {model_name} --{label}: launches {got}, expected {want}")
        total = {k: total[k] + got[k] for k in COUNTERS}
        if label == "pts":
            preds = result["preds"]
            if preds.shape != (n_clouds,) or preds.min() < 0 or preds.max() > 9:
                fail(f"infer --pts: bad predictions {preds.shape} {preds[:8]}")
        elif not 0.0 <= result["overall_acc"] <= 1.0 or not math.isfinite(result["avg_loss"]):
            fail(f"infer --dataset: bad result {result}")
    return total, raw, preds


def serving_run(infer, model_name, seed, rng, dev, n_clouds, num_points=N_POINTS, bf16=False):
    """A serving path through ``infer --model <model_name> --dg``: seeded
    weights (random BN statistics and signed scales), head biases shifted by
    minus their mean logits over 64 calibration clouds (random heads send
    every cloud to one class), a checkpoint, ``infer_runs``, and the logits
    of 16 clouds against the CPU plain path. With ``bf16``, all of it under
    ``SUG_PRECISION=bf16`` (the model calibrated in bf16 too), and the CPU's
    f32 logits beside its bf16 ones for ``check_logits``. Returns the summed
    launch counts, the model on the card and the calibration batch."""
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.engine.checkpoint import save_checkpoint
    from sug_tpu_torch.models.net_mda import NetMDA, ensemble_logits

    dtype = torch.bfloat16 if bf16 else None
    torch.manual_seed(seed)
    model = NetMDA(model_name, num_points=num_points).set_compute_dtype(dtype)
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    calib = PointCloudDataset("modelnet", synthetic_clouds(rng, B, num_points)[0], np.zeros(B),
                              num_points=num_points).pts
    batch = torch.from_numpy(calib).to(dev)
    model = model.eval().to(dev)
    with torch.no_grad():
        out = model(batch)
        model.c1.mlp3.bias -= out["logits1"].mean(0)
        model.c2.mlp3.bias -= out["logits2"].mean(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, f"{model_name}.pt"), model, epoch=0)
        with env("SUG_PRECISION", "bf16" if bf16 else None):
            launches, raw, preds = infer_runs(infer, ckpt, model_name, rng, tmp, n_clouds,
                                              num_points)
        first = torch.from_numpy(
            PointCloudDataset("modelnet", raw[:16], np.zeros(16), num_points=num_points).pts)
        cpu_dev = torch.device("cpu")
        with torch.no_grad():
            card = ensemble_logits(infer.load_model(model_name, ckpt, dev, num_points, dtype),
                                   first.to(dev)).cpu()
            cpu = ensemble_logits(infer.load_model(model_name, ckpt, cpu_dev, num_points, dtype),
                                  first)
            cpu_f32 = ensemble_logits(infer.load_model(model_name, ckpt, cpu_dev, num_points),
                                      first) if bf16 else None
    check_logits(f"{model_name} N={num_points}" + (" bf16" if bf16 else ""), card, cpu, preds,
                 cpu_f32, BF16_SATURATED.get(model_name, 1.0) if bf16 else 1.0)
    return launches, model, batch


def edgeconv_cases(gen, dev, bwd=False):
    """(name, inputs) of the EdgeConv checks: the N=1024 shapes, the ragged
    ones, the N=4096 ones (the backward's at ``LARGE_BWD_B``), and
    zero-padded clouds at N=4096."""
    for shape, n in [(s, N_POINTS) for s in SHAPES] + [(s, RAGGED_N) for s in RAGGED]:
        yield shape[0], shape_inputs(shape, gen, dev, n)
    for shape in LARGE_SHAPES:
        b = LARGE_BWD_B.get(shape[0], B) if bwd else B
        yield f"{shape[0]} N={N_LARGE}", shape_inputs(shape, gen, dev, N_LARGE, b=b)
    for shape in (SHAPES[0], SHAPES[4]):
        yield (f"{shape[0]} N={N_LARGE} zero-padded (2048 real)",
               shape_inputs(shape, gen, dev, N_LARGE, real=2048))


def compare_fwd(name, args, require_exact_idx=False, values_bf16=False):
    """The forward kernels against the plain version on ``args`` (see
    ``compare``); the gather kernel bit for bit against
    ``gather_reduce_plain`` on the select kernel's own idx; and two launches
    bit-identical in all five outputs. In ``values_bf16`` mode all of it in
    that mode, and the select kernel's idx the f32 mode's, bit for bit.
    Returns the max |diff| on agreeing rows."""
    q, kv, u, v, k = args
    got = edgeconv.edgeconv_reduce(*args, values_bf16)
    idx, *again = edgeconv.edgeconv_reduce_stages(*args, values_bf16)
    for label, g, a in zip(("amax", "amin", "s1", "s2", "idx"), got, (*again, idx)):
        if not torch.equal(g, a):
            fail(f"{name}: two forward launches on the same inputs differ in {label}")
    for label, g, w in zip(("amax", "amin", "s1", "s2"), got,
                           edgeconv.gather_reduce_plain(got[4], u, v, values_bf16)):
        if not torch.equal(g, w):
            fail(f"{name}: the gather kernel's {label} differs from gather_reduce_plain on its "
                 "own idx")
    if values_bf16 and not torch.equal(edgeconv.edgeconv_reduce(*args)[4], got[4]):
        fail(f"{name}: the select kernel's idx differs between the f32 and the bf16 mode")
    want = edgeconv.edgeconv_reduce_plain(*args, values_bf16)
    torch.cuda.synchronize()
    err, _ = compare(name, got, want, require_exact_idx)
    return err


def check_edgeconv_fwd(gen, dev):
    """The EdgeConv forward kernels (``compare_fwd``) at every case of
    ``edgeconv_cases`` and on the exact-tie lattices; then, from a generator
    of their own (so every later check draws the inputs it drew before), at
    N=16384 keys, on exact ties at k=64 on a zero-padded N=4096 lattice, and
    with a k above the kernels' cap, which must raise before any launch.
    Returns the max |diff|, and the lattices ``lat`` (N=1024) and ``lat_r``
    (N=1000) for the later checks."""
    print("forward kernels vs plain (tolerance: sets agree on >= "
          f"{MIN_SET_AGREEMENT}, agreeing rows to {REL_TOL} rel of max(|plain|,1); exact ties "
          "index for index; gather bit for bit against gather_reduce_plain on the kernel's idx; "
          "two launches bit-identical):", flush=True)
    max_abs_err = 0.0
    for name, args in edgeconv_cases(gen, dev):
        max_abs_err = max(max_abs_err, compare_fwd(name, args))
    del args
    # exact ties: integer lattice points, duplicates included, so every
    # distance is exact in f32 and both sides must pick the same indices in
    # the same order (the lowest index first among equal distances)
    lat = torch.randint(-6, 7, (B, N_POINTS, 3), generator=gen, device=dev).float()
    lat[:, 64] = lat[:, 0]
    lat[:, 65] = lat[:, 0]
    lat_r = lat[:, :RAGGED_N].contiguous()
    for name, q, kv, k in (
        ("tie self k=20", lat, lat, 20),
        ("tie cross k=64", lat[:, 128:192].contiguous(), lat, 64),
        ("tie ragged self N=1000 k=20", lat_r, lat_r, 20),
        ("tie ragged cross S=61 N=1000 k=64", lat_r[:, 128:189].contiguous(), lat_r, 64),
    ):
        u = torch.randn((B, kv.shape[1], 64), generator=gen, device=dev)
        v = torch.randn((B, q.shape[1], 64), generator=gen, device=dev)
        max_abs_err = max(max_abs_err, compare_fwd(name, (q, kv, u, v, k),
                                                   require_exact_idx=True))
    own = torch.Generator(device=dev).manual_seed(9)
    # N=16384 keys: the select kernel's shared memory does not grow with N;
    # the plain kNN goes blockwise above 4096
    args = shape_inputs(SHAPES[0], own, dev, N_HUGE, b=HUGE_B)
    max_abs_err = max(max_abs_err, compare_fwd(f"block1 N={N_HUGE} B={HUGE_B}", args))
    # exact ties at k=64: a lattice cloud zero-padded past 2048 points, so the
    # 2048 padded points tie at every query and the bar must turn them away
    pad = torch.randint(-6, 7, (TIE_PAD_B, N_LARGE, 3), generator=own, device=dev).float()
    pad[:, 2048:] = 0.0
    args = (pad, pad, torch.randn((TIE_PAD_B, N_LARGE, 64), generator=own, device=dev),
            torch.randn((TIE_PAD_B, N_LARGE, 64), generator=own, device=dev), 64)
    max_abs_err = max(max_abs_err, compare_fwd(
        f"tie self zero-padded N={N_LARGE} (2048 real) k=64 B={TIE_PAD_B}", args,
        require_exact_idx=True))
    before = edgeconv.edgeconv_reduce.launches
    try:
        edgeconv.edgeconv_reduce(*args[:4], edgeconv.MAX_FWD_K + 1)
    except ValueError as e:
        torch.cuda.synchronize()
        if edgeconv.edgeconv_reduce.launches != before:
            fail("edgeconv_reduce counted a launch for a k above the kernels' cap")
        print(f"  k={edgeconv.MAX_FWD_K + 1} above the cap raised before any launch: {e}",
              flush=True)
    else:
        fail(f"edgeconv_reduce took k={edgeconv.MAX_FWD_K + 1}, above the kernels' cap")
    return max_abs_err, lat, lat_r


def check_edgeconv_bwd(gen, dev, lat, lat_r):
    """The EdgeConv backward kernels against the plain backward at every
    case of ``edgeconv_cases``, on the exact-tie lattices ``lat`` (N=1024)
    and ``lat_r`` (N=1000), at N=2000 with F=40 and at N=32768 keys; each
    kernel also bit for bit against its plain version on the first clouds of
    each case. Returns the max |diff| against the plain backward."""
    print(f"backward kernels vs plain (tolerance: {REL_TOL} of max(sum of the terms' "
          "magnitudes, 1); exact ties bit for bit; two launches bit-identical; csr, rows and "
          f"keys bit for bit against their plain versions on {STAGE_B} clouds):", flush=True)
    bwd_max_abs_err = 0.0
    for name, args in edgeconv_cases(gen, dev, bwd=True):
        args = bwd_inputs(*args, gen)
        if args[0].shape[0] != B:
            name += f" B={args[0].shape[0]}"
        bwd_max_abs_err = max(bwd_max_abs_err, compare_bwd(name, args))
        compare_bwd_stages(name, args)
    del args
    # exact ties in a: lattice points with duplicates and integer values, so
    # tied neighbours give equal a and every sum is exact
    for name, q, kv, k in (
        ("tie self k=20", lat, lat, 20),
        ("tie cross k=64", lat[:, 128:192].contiguous(), lat, 64),
        ("tie ragged self N=1000 k=20", lat_r, lat_r, 20),
        ("tie ragged cross S=61 N=1000 k=64", lat_r[:, 128:189].contiguous(), lat_r, 64),
    ):
        u = torch.randint(-3, 4, (B, kv.shape[1], 64), generator=gen, device=dev).float()
        v = torch.randint(-3, 4, (B, q.shape[1], 64), generator=gen, device=dev).float()
        args = bwd_inputs(q, kv, u, v, k, gen, integer=True)
        bwd_max_abs_err = max(bwd_max_abs_err, compare_bwd(name, args, exact=True))
        compare_bwd_stages(name, args)
    # N=2000, F=40: a warp of the rows and keys kernels spans two rows (keys)
    # and the last block is ragged; the kernels have no key tile
    big = torch.randn((8, 2000, 3), generator=gen, device=dev)
    args = bwd_inputs(big, big, torch.randn((8, 2000, 40), generator=gen, device=dev),
                      torch.randn((8, 2000, 40), generator=gen, device=dev), 20, gen)
    name = "N=2000, F=40: idle lanes, no key tile"
    bwd_max_abs_err = max(bwd_max_abs_err, compare_bwd(name, args))
    compare_bwd_stages(name, args)
    # N=32768 keys: the csr kernel's per-warp counts no longer fit beside its
    # cursor, so one warp places every entry
    kv = unit_clouds(2, 32768, gen, dev)
    q = (kv[:, :64] + 0.05 * torch.randn((2, 64, 3), generator=gen, device=dev)).contiguous()
    args = bwd_inputs(q, kv, torch.randn((2, 32768, 64), generator=gen, device=dev),
                      torch.zeros((2, 64, 64), device=dev), 20, gen)
    name = "cross S=64 N=32768 k=20: one csr warp"
    bwd_max_abs_err = max(bwd_max_abs_err, compare_bwd(name, args))
    compare_bwd_stages(name, args)
    return bwd_max_abs_err


def check_edgeconv_bf16(dev):
    """The EdgeConv kernels in ``values_bf16`` mode (the bf16 policy's), from
    a generator of their own: the forward (``compare_fwd``) and the backward
    (``compare_bwd``, each kernel also bit for bit against its plain version
    by ``compare_bwd_stages``) at every case of ``edgeconv_cases``: DGCNN's
    five shapes and the SA-node's cross shape at N=1024, the ragged ones, the
    N=4096 ones and zero-padded clouds. Returns the max |diff| of the
    forward and of the backward against their plain versions."""
    own = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()
    print("values_bf16 mode (the bf16 policy's) vs plain, as above: gather, rows and keys bit "
          "for bit against their plain versions in that mode, the select kernel's idx the f32 "
          "mode's, two launches bit-identical:", flush=True)
    fwd_err = 0.0
    for name, args in edgeconv_cases(own, dev):
        fwd_err = max(fwd_err, compare_fwd(f"{name} bf16", args, values_bf16=True))
    bwd_err = 0.0
    for name, args in edgeconv_cases(own, dev, bwd=True):
        args = bwd_inputs(*args, own, values_bf16=True)
        name += " bf16" + (f" B={args[0].shape[0]}" if args[0].shape[0] != B else "")
        bwd_err = max(bwd_err, compare_bwd(name, args, values_bf16=True))
        compare_bwd_stages(name, args, values_bf16=True)
    del args
    print(f"values_bf16 mode checks: {time.perf_counter() - t0:.1f} s", flush=True)
    return fwd_err, bwd_err


def time_edgeconv_bf16(dev, fwd_entry, bwd_entry):
    """Times the kernels in ``values_bf16`` mode at the five N=1024 shapes at
    B=64, u in bf16 as the autograd Function hands it over, from a generator
    of their own: the forward (select, gather) and the backward (csr, rows,
    keys), each split by kernel, beside their bounds (u read at 2 bytes) and
    their plain versions in that mode; adds them to the two entries."""
    own = torch.Generator(device=dev).manual_seed(13)
    t_ops = 0.0
    for shape in SHAPES:
        q, kv, u, v, k = shape_inputs(shape, own, dev)
        args = (q, kv, u.to(torch.bfloat16), v, k)
        ms = timed_ms(lambda: edgeconv.edgeconv_reduce(*args, True), iters=20)
        plain_ms = timed_ms(lambda: edgeconv.edgeconv_reduce_plain(*args, True), iters=5)
        b_ms, b_by, nbytes, flops = bound(*args)
        t_ops += flops / F32_FLOP_PER_S * 1e3 if b_by == "operations" else 0.0
        split = kernel_split(lambda: edgeconv.edgeconv_reduce(*args, True),
                             f"bf16 forward {shape[0]}", ms, FWD_KERNELS)
        print(f"  bf16 forward {shape[0]}: kernels {ms:.4f} ms (gather {split['gather']:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB)",
              flush=True)
        fwd_entry["shapes"].append({"name": shape[0], "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": b_ms, "bound_by": b_by,
                                    **{f"{kk}_ms": t for kk, t in split.items()}})
        bargs = bwd_inputs(q, kv, u, v, k, own, values_bf16=True)
        bms = timed_ms(lambda: edgeconv.edgeconv_reduce_bwd(*bargs, True), iters=10)
        bplain_ms = timed_ms(lambda: edgeconv.edgeconv_reduce_bwd_plain(*bargs, True), iters=3)
        bb_ms, bb_by, bbytes, _ = bwd_bound(*bargs[:3])
        bsplit = kernel_split(lambda: edgeconv.edgeconv_reduce_bwd(*bargs, True),
                              f"bf16 backward {shape[0]}", bms, BWD_KERNELS)
        print(f"  bf16 backward {shape[0]}: kernels {bms:.4f} ms (rows {bsplit['rows']:.4f}, "
              f"keys {bsplit['keys']:.4f} ms), plain {bplain_ms:.4f} ms, bound {bb_ms:.4f} ms by "
              f"{bb_by} ({bbytes / 1e6:.1f} MB)", flush=True)
        bwd_entry["shapes"].append({"name": shape[0], "ms": bms, "plain_ms": bplain_ms,
                                    "bound_ms": bb_ms, "bound_by": bb_by,
                                    **{f"{kk}_ms": t for kk, t in bsplit.items()}})
        for entry, vals in ((fwd_entry, (ms, plain_ms, b_ms)),
                            (bwd_entry, (bms, bplain_ms, bb_ms))):
            for key, val in zip(("ms", "plain_ms", "bound_ms"), vals):
                entry[key] += val
    fwd_entry["bound_by"] = "operations" if t_ops >= fwd_entry["bound_ms"] / 2 else "bytes"
    del args, bargs


def va_bf16(args):
    """A vector-attention call's inputs as the bf16 mode takes them from
    PTran's bf16 projections: q, key and val rounded to bf16."""
    return [a.to(torch.bfloat16) if i in (1, 2, 3) else a for i, a in enumerate(args)]


def check_va(gen, dev, lat, lat_r, bf16=False):
    """The vector-attention kernels against their plain versions, in f32 or
    (``bf16``) in the bf16 mode of the bf16 policy (q, key and val in bf16):
    the forward at the five PTran levels at N=1024 and the ragged N=1000, at
    D=128 and on the lattice ``lat``'s exact ties (duplicates at 0, 64, 65:
    every distance exact, so the indices must match index for index), two
    launches bit-identical; the backward at the five N=1024 levels, at the
    ragged levels at D=128 and on the lattice ``lat_r``, whose duplicate
    points are each other's neighbours (``compare_va_bwd``). Returns the
    max |diff| of the forward and of the backward."""
    va = vector_attention
    t0 = time.perf_counter()
    if bf16:
        print(f"vector-attention kernels in the bf16 mode vs their bf16 plain versions "
              f"(tolerances: out/m/l on agreeing rows {VA_BF16_REL_TOL:.3e} of max(|plain|,1) and "
              f"{VA_BF16_REL_L2} relative L2; backward staged tensors {VA_BF16_EDGE_TOL} of "
              f"max(|plain|, rms) and {VA_BF16_EDGE_L2} relative L2 off relu flips, at most "
              f"{VA_BF16_FLIP_SHARE} of the elements flipped at under {VA_BF16_FLIP_MARGIN} of the "
              f"rms; sums {VA_SUM_TOL} of their terms, dkey and dval one bf16 step more; end to "
              f"end {VA_BF16_BWD_REL_L2} relative L2; two launches bit-identical):", flush=True)
    else:
        print(f"vector-attention kernel vs plain (tolerance: sets agree on >= "
              f"{MIN_SET_AGREEMENT}, out/m/l on agreeing rows to {VA_REL_TOL} rel of "
              "max(|plain|,1); two launches bit-identical):", flush=True)
    mode = va_bf16 if bf16 else list
    tag = " bf16" if bf16 else ""
    cases = [(f"{name} N={n} k={k} D={D_MODEL}", va_inputs(n, gen, dev), k, False)
             for name, n, k in VA_SHAPES + VA_RAGGED]
    cases.append((f"D=128 N={N_POINTS} k=16", va_inputs(N_POINTS, gen, dev, d=128), 16, False))
    for n, k in ((N_POINTS, 16), (RAGGED_N, 16), (15, 15)):
        cases.append((f"tie N={n} k={k}", va_inputs(n, gen, dev, xyz=lat[:, :n].contiguous()), k,
                      True))
    fwd_err = 0.0
    for name, args, k, exact in cases:
        args = mode(args)
        got = va.vector_attention_fwd(*args, k)
        again = va.vector_attention_fwd(*args, k)
        want = va.vector_attention_fwd_plain(*args, k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name}{tag}: two forward launches on the same inputs differ")
        fwd_err = max(fwd_err, compare_va(name + tag, got, want, exact, bf16=bf16))
    del cases, args, got, again, want
    if not bf16:
        print("vector-attention backward kernels vs plain (tolerances: staged edge tensors "
              f"{VA_EDGE_TOL} of max(|plain|, rms) off relu flips; sums {VA_SUM_TOL} of max(sum "
              f"of the terms' magnitudes, its mean); end to end {VA_BWD_REL_L2} relative L2; two "
              "calls bit-identical):", flush=True)
    bwd_err = 0.0
    cases = [(f"{name} N={n} k={k} D={D_MODEL}", n, k, D_MODEL, None) for name, n, k in VA_SHAPES]
    cases += [(f"{name} N={n} k={k} D=128", n, k, 128, None) for name, n, k in VA_RAGGED]
    cases.append((f"tie N={RAGGED_N} k=16 D=128", RAGGED_N, 16, 128, lat_r))
    for name, n, k, d, xyz in cases:
        args = mode(va_inputs(n, gen, dev, d=d, xyz=xyz))
        bwd_err = max(bwd_err, compare_va_bwd(name + tag, args, k, gen))
    del args
    print(f"vector-attention checks{tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    return fwd_err, bwd_err


def time_va_bf16(dev, fwd_entry, bwd_entry):
    """Times the vector-attention kernels' bf16 mode at the five PTran
    levels at B=64, from a generator of their own: the forward and the
    backward (fed one forward launch), each beside its bound (the D×D
    products at the bf16 peak, q, key and val at 2 bytes), its bf16 plain
    version, and the backward split by kernel; adds them to the entries."""
    va = vector_attention
    own = torch.Generator(device=dev).manual_seed(15)
    for name, n, k in VA_SHAPES:
        args = va_bf16(va_inputs(n, own, dev))
        ms = timed_ms(lambda: va.vector_attention_fwd(*args, k), iters=5)
        plain_ms = timed_ms(lambda: va.vector_attention_fwd_plain(*args, k), iters=3)
        b_ms, b_by, nbytes, flops, f32_ms = va_bound(args, k)
        print(f"  vector attention bf16 {name} (B={B}, N={n}, D={D_MODEL}, k={k}): kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the bf16 bound), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} with bf16 tensor cores "
              f"({f32_ms:.4f} ms in f32 outside them; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)
        saved = va_bwd_saved(args, k, own)
        bms = timed_ms(lambda: va.vector_attention_bwd(*args, k, *saved), iters=3, warmup=1)
        bplain_ms = timed_ms(lambda: va.vector_attention_bwd_plain(*args, k, *saved), iters=2,
                             warmup=1)
        bb_ms, bb_by, bbytes, bflops, bf32_ms = va_bwd_bound(args, k)
        print(f"  vector-attention backward bf16 {name}: kernels {bms:.4f} ms "
              f"({bflops / bms / 1e9:.2f} TFLOP/s, {bb_ms / bms:.1%} of the bf16 bound), plain "
              f"{bplain_ms:.4f} ms, bound {bb_ms:.4f} ms by {bb_by} with bf16 tensor cores "
              f"({bf32_ms:.4f} ms in f32 outside them; {bbytes / 1e6:.1f} MB, "
              f"{bflops / 1e9:.2f} GFLOP)", flush=True)
        profile_device(lambda: va.vector_attention_bwd(*args, k, *saved),
                       f"bf16 vector-attention backward, {name}", bms, iters=1)
        for entry, vals, by in ((fwd_entry, (ms, plain_ms, b_ms), b_by),
                                (bwd_entry, (bms, bplain_ms, bb_ms), bb_by)):
            entry["shapes"].append({"name": name, **dict(zip(("ms", "plain_ms", "bound_ms"), vals)),
                                    "bound_by": by})
            for key, val in zip(("ms", "plain_ms", "bound_ms"), vals):
                entry[key] += val
            if by != "operations":
                entry["bound_by"] = "bytes"
        del saved
    del args


def time_edgeconv_fwd(gen, dev, entry):
    """Times the forward (one call, its two kernels) at the five N=1024
    shapes at B=64 beside its bound and the plain version, and adds them to
    ``entry``; then, from a generator of its own, at the five N=4096 shapes
    and block 1 on a zero-padded cloud (``entry["large_shapes"]``). Each
    shape's call is split by kernel (select, gather) by ``kernel_split``."""
    t_ops = 0.0
    for shape in SHAPES:
        args = shape_inputs(shape, gen, dev)
        ms = timed_ms(lambda: edgeconv.edgeconv_reduce(*args), iters=20)
        plain_ms = timed_ms(lambda: edgeconv.edgeconv_reduce_plain(*args), iters=5)
        b_ms, b_by, nbytes, flops = bound(*args)
        t_ops += flops / F32_FLOP_PER_S * 1e3 if b_by == "operations" else 0.0
        print(f"  {shape[0]} (B={B}, S={args[0].shape[1]}, N={N_POINTS}, C={shape[2]}, "
              f"F={shape[3]}, k={shape[4]}): kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
              flush=True)
        split = kernel_split(lambda: edgeconv.edgeconv_reduce(*args), f"forward {shape[0]}", ms,
                             FWD_KERNELS)
        entry["shapes"].append({"name": shape[0], "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": b_ms, "bound_by": b_by,
                                **{f"{k}_ms": t for k, t in split.items()}})
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["bound_ms"] += b_ms
    # the entry is one forward's five calls; say what bounds most of them
    entry["bound_by"] = "operations" if t_ops >= entry["bound_ms"] / 2 else "bytes"
    del args
    own = torch.Generator(device=dev).manual_seed(10)
    entry["large_shapes"] = []
    for shape, real in [(s, None) for s in SHAPES] + [(SHAPES[0], 2048)]:
        args = shape_inputs(shape, own, dev, N_LARGE, real=real)
        ms = timed_ms(lambda: edgeconv.edgeconv_reduce(*args), iters=5)
        plain_ms = timed_ms(lambda: edgeconv.edgeconv_reduce_plain(*args), iters=1, warmup=1)
        b_ms, b_by, nbytes, flops = bound(*args)
        name = f"{shape[0]} N={N_LARGE}" + ("" if real is None else f" zero-padded ({real} real)")
        print(f"  forward {name} (B={B}, S={args[0].shape[1]}, C={shape[2]}, F={shape[3]}, "
              f"k={shape[4]}): kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        split = kernel_split(lambda: edgeconv.edgeconv_reduce(*args), f"forward {name}", ms,
                             FWD_KERNELS)
        entry["large_shapes"].append({"name": name, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": b_ms, "bound_by": b_by,
                                      **{f"{k}_ms": t for k, t in split.items()}})
    del args


def time_edgeconv_bwd(gen, dev, entry):
    """Times the backward (one call, its three kernels) at the forward's five
    shapes at B=64, fed by one forward launch, beside its bound and the plain
    backward, and adds them to ``entry``; then the kernels alone at the
    N=4096 shapes and on a zero-padded cloud, where the plain backward's
    (B, S, k, F) temporaries would not fit. At block 4 and at each N=4096
    shape a ``torch.profiler`` run splits the call's time by kernel (csr,
    rows, keys)."""
    for shape in SHAPES:
        args = bwd_inputs(*shape_inputs(shape, gen, dev), gen)
        ms = timed_ms(lambda: edgeconv.edgeconv_reduce_bwd(*args), iters=10)
        plain_ms = timed_ms(lambda: edgeconv.edgeconv_reduce_bwd_plain(*args), iters=3)
        b_ms, b_by, nbytes, flops = bwd_bound(*args[:3])
        print(f"  backward {shape[0]} (B={B}, S={args[0].shape[1]}, N={N_POINTS}, F={shape[3]}, "
              f"k={shape[4]}): kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        if b_by != "bytes":
            fail(f"backward {shape[0]}: expected a bytes bound, got {b_by}")
        entry["shapes"].append({"name": shape[0], "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": b_ms, "bound_by": b_by})
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["bound_ms"] += b_ms
        if shape[0] == "block4":
            kernel_split(lambda: edgeconv.edgeconv_reduce_bwd(*args), "backward block4", ms,
                         BWD_KERNELS)
    del args
    for shape, real in [(s, None) for s in LARGE_SHAPES] + [(SHAPES[0], 2048)]:
        args = bwd_inputs(*shape_inputs(shape, gen, dev, N_LARGE, real=real), gen)
        ms = timed_ms(lambda: edgeconv.edgeconv_reduce_bwd(*args), iters=5)
        b_ms, b_by, nbytes, _ = bwd_bound(*args[:3])
        name = f"{shape[0]} N={N_LARGE}" + ("" if real is None else f" zero-padded ({real} real)")
        print(f"  backward {name} (B={B}, S={args[0].shape[1]}, F={shape[3]}, k={shape[4]}): "
              f"kernels {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB)",
              flush=True)
        kernel_split(lambda: edgeconv.edgeconv_reduce_bwd(*args), f"backward {name}", ms,
                     BWD_KERNELS)
    del args


def main() -> None:
    global edgeconv, vector_attention, geometry_kernels
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    try:
        import sug_tpu_torch
    except ImportError as e:
        fail(f"the sug_tpu_torch package is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(os.path.abspath(sug_tpu_torch.__file__))) != HERE:
        fail(f"imported sug_tpu_torch from {sug_tpu_torch.__file__}, not from {HERE}")
    from sug_tpu_torch import infer, train_dg_naive_mmd, train_dg_single_gpu, train_source, train_uda
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.models import CLASSIFIERS
    from sug_tpu_torch.models.net_mda import ensemble_logits
    from sug_tpu_torch.ops import cuda_build, edgeconv, geometry_kernels, vector_attention
    from sug_tpu_torch.ops.geometry import farthest_point_sample
    from sug_tpu_torch.utils.config import parser_config

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    # 2. the build: one nvcc per source, all started together
    sources = ("edgeconv_fwd", "edgeconv_bwd", "vecattn_fwd", "vecattn_bwd", "chamfer_min", "fps")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build, sources))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(sources)} sources", flush=True)
    for name, built in zip(sources, builds):
        print(f"build {name}: {built.seconds:.2f} s -> {built.path}", flush=True)
        for line in built.log.splitlines():
            if any(w in line for w in ("registers", "bytes smem", "spill", "Function properties")):
                print(f"  ptxas: {line.strip()}", flush=True)
    # the tensor-core kernels: HMMA instructions in their machine code
    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        fail(f"{cuobjdump} not found: the tensor-core kernels' SASS cannot be checked")
    built = dict(zip(sources, builds))
    # every instance on the tensor cores: the bf16 ones (the vector attention's
    # bf16 mode) with bf16 HMMA and no TF32 one, the f32 ones the reverse
    for kernel, source in TENSOR_CORE_KERNELS:
        instances = hmma_by_instance(cuobjdump, built[source].path, kernel)
        print(f"  sass: {kernel} ({source}.cu): {sum(map(len, instances.values()))} HMMA "
              "instructions", flush=True)
        if {VA_BF16_MARKERS[kernel] in fn for fn in instances} != {True, False}:
            fail(f"{kernel}: expected f32 and bf16 instances in the SASS, found {list(instances)}")
        for fn, ops in instances.items():
            is_bf16 = VA_BF16_MARKERS[kernel] in fn
            n_bf16 = sum(".BF16" in op for op in ops)
            n_tf32 = sum(".TF32" in op for op in ops)
            print(f"  sass: {kernel} {'bf16' if is_bf16 else 'f32'} instance ({fn[:60]}...): "
                  f"{n_bf16} bf16 HMMA, {n_tf32} TF32 HMMA ({sorted(set(ops))})", flush=True)
            if (n_bf16 == 0 or n_tf32) if is_bf16 else (n_tf32 == 0 or n_bf16):
                fail(f"{kernel}: the {'bf16' if is_bf16 else 'f32'} instance {fn} holds {n_bf16} "
                     f"bf16 and {n_tf32} TF32 HMMA")
    # the values_bf16 instances of the EdgeConv gather, rows and keys kernels
    functions = {src: sass_functions(cuobjdump, built[src].path)
                 for src in {source for _, _, source in BF16_KERNELS}}
    for label, kernel, source in BF16_KERNELS:
        names = [f for f in functions[source] if kernel in f]
        bf16_names = [f for f in names if "bfloat16" in f]
        print(f"  sass: {kernel} ({source}.cu): {len(names)} instances, {len(bf16_names)} for a "
              "bf16 u", flush=True)
        if len(names) != 2 or len(bf16_names) != 1:
            fail(f"{kernel}: expected an f32 and a bf16 instance in the SASS, found {names}")

    # 3. kernels against plain versions
    gen = torch.Generator(device=dev).manual_seed(0)

    max_abs_err, lat, lat_r = check_edgeconv_fwd(gen, dev)
    # FPS: torch.argmax must return the first maximal index on the card too
    sym = torch.zeros((1, 8, 3))
    sym[0, :, 0] = torch.tensor([0.0, 1, -1, 1, -1, 2, -2, 2])
    if not torch.equal(farthest_point_sample(sym, 5),
                       farthest_point_sample(sym.to(dev), 5).cpu()):
        fail("farthest_point_sample breaks argmax ties differently on the card")
    print("  fps argmax ties: the card matches the CPU", flush=True)

    bwd_max_abs_err = check_edgeconv_bwd(gen, dev, lat, lat_r)
    bf16_max_abs_err, bf16_bwd_max_abs_err = check_edgeconv_bf16(dev)

    va_max_abs_err, va_bwd_max_abs_err = check_va(gen, dev, lat, lat_r)
    # the bf16 mode, from a generator of its own, so the later draws stay as they were
    va_bf16_max_abs_err, va_bwd_bf16_max_abs_err = check_va(
        torch.Generator(device=dev).manual_seed(14), dev, lat, lat_r, bf16=True)

    print(f"min-dists kernel vs plain at B={B} (tolerance: each min to {MIN_DIST_REL} of "
          "max(|q|² + max |s|², 1); the chamfer of two launches to twice that of the largest "
          "squared norms):", flush=True)
    md_max_abs_err = 0.0
    md_cases = [(f"N={n} M={m}", unit_clouds(B, n, gen, dev), unit_clouds(B, m, gen, dev))
                for n, m in MIN_DISTS_SHAPES]
    same = unit_clouds(B, N_LARGE, gen, dev)
    md_cases.append((f"identical clouds N=M={N_LARGE}", same, same))
    md_cases.append((f"zero-padded N=M={N_LARGE} (2048 real)",
                     unit_clouds(B, N_LARGE, gen, dev, 2048), unit_clouds(B, N_LARGE, gen, dev, 2048)))
    for name, q, s in md_cases:
        md_max_abs_err = max(md_max_abs_err, compare_min_dists(name, q, s))
    del md_cases, same

    check_fps(gen, dev)

    # 4a. the DGCNN serving slice through its entry point
    rng = np.random.default_rng(0)
    bf16_models = {}  # the bf16 serving models of 4l, timed in phase 5
    rng16 = np.random.default_rng(16)  # 4l's own, so the later draws stay as they were
    launches, model, batch = serving_run(infer, "DGCNN", 0, rng, dev, 256)
    fwd_launches = launches["edgeconv_fwd"]
    fps_launches = launches["fps"]

    # 4b. the DGCNN training slice through its entry point, then --resume
    got, _ = train_and_resume(train_dg_single_gpu.main, rng, "DGCNN")
    fwd_launches += got["edgeconv_fwd"]
    bwd_launches = got["edgeconv_bwd"]
    fps_launches += got["fps"]

    # 4c. one DGCNN DG loss on the card against the CPU plain path
    _, cfg = parser_config(["--cfg", YAML, "--set", "Model", "DGCNN"])
    card_against_cpu(cfg, rng, "DGCNN")

    # 4d. the PTran serving slice through its entry point
    launches, ptran_model, ptran_batch = serving_run(infer, "PTran", 2, rng, dev, PTRAN_CLOUDS)
    va_launches = launches["vecattn_fwd"]
    fps_launches += launches["fps"]

    # 4e. the PTran training slice through its entry point, then --resume;
    # 4f. one PTran DG loss on the card against the CPU plain path
    got, va_bwd_by_kernel = train_and_resume(train_dg_single_gpu.main, rng, "PTran")
    va_launches += got["vecattn_fwd"]
    va_bwd_calls = got["vecattn_bwd_calls"]
    fps_launches += got["fps"]
    _, ptran_cfg = parser_config(["--cfg", YAML, "--set", "Model", "PTran"])
    card_against_cpu(ptran_cfg, rng, "PTran")

    # 4g. the shipped config as it stands (PointNet) at --num_points 4096,
    # then --resume; 4h. its serving path; 4i. one PointNet DG loss at 4096
    # points on the card against the CPU plain path
    got, _ = train_and_resume(train_dg_single_gpu.main, rng, "Pointnet", N_LARGE)
    fwd_launches += got["edgeconv_fwd"]
    bwd_launches += got["edgeconv_bwd"]
    fps_launches += got["fps"]
    md_launches = got["min_dists"]
    launches, pn_model, pn_batch = serving_run(infer, "Pointnet", 4, rng, dev, 2 * B, N_LARGE)
    fwd_launches += launches["edgeconv_fwd"]
    fps_launches += launches["fps"]
    _, pn_cfg = parser_config(["--cfg", YAML])
    if pn_cfg["Model"] != "Pointnet":
        fail(f"{YAML} configures Model {pn_cfg['Model']!r}, not Pointnet")
    card_against_cpu(pn_cfg, rng, "Pointnet", N_LARGE)
    card_against_cpu(pn_cfg, rng, "Pointnet", N_LARGE, raw_points=2048)

    # 4j. the DG trainer's other options through the training front door: the
    # stacked forward with GRL, CL and max-hard MMD (DGCNN), and per-replica
    # BN in 2 groups (PointNet); 4k. the stacked and the grouped DGCNN DG
    # loss on the card against the CPU plain path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cfg_") as tmp:
        options_yaml = os.path.join(tmp, "DG_stacked_grl_cl.yaml")
        with open(options_yaml, "w") as f:
            f.write(OPTIONS_YAML.format(base=YAML))
        got = options_runs(train_dg_single_gpu.main, rng, options_yaml)
        _, options_cfg = parser_config(["--cfg", options_yaml, "--set", "Model", "DGCNN"])
    fwd_launches += got["edgeconv_fwd"]
    bwd_launches += got["edgeconv_bwd"]
    fps_launches += got["fps"]
    with stacked_forward(True):
        card_against_cpu(options_cfg, rng, "DGCNN", grl_const=GRL_LAMBDA,
                         variant=f"stacked, GRL {GRL_LAMBDA}, CL geo, max-hard sem")
    _, grouped_cfg = parser_config(["--cfg", YAML, "--set", "Model", "DGCNN", *BN_GROUPS_SET])
    card_against_cpu(grouped_cfg, rng, "DGCNN", variant="BN groups 2", replay=True)

    # 4l. the bf16 policy: training through the front door with --set
    # PRECISION bf16 (DGCNN and PTran at 1024 points, PointNet at 4096, the
    # shipped config), then --resume; serving under SUG_PRECISION=bf16; one
    # bf16 DG loss per model on the card against the CPU
    t_bf16 = time.perf_counter()
    bf16_launches = dict.fromkeys(COUNTERS, 0)
    for model_name, n in (("DGCNN", N_POINTS), ("Pointnet", N_LARGE), ("PTran", N_POINTS)):
        got, by_kernel = train_and_resume(train_dg_single_gpu.main, rng16, model_name, n,
                                          sets=BF16_SET)
        launches, bf16_model, bf16_batch = serving_run(infer, model_name, 6, rng16, dev, B, n,
                                                       bf16=True)
        bf16_models[model_name] = bf16_model
        bf16_launches = {k: bf16_launches[k] + got[k] + launches[k] for k in COUNTERS}
        if model_name == "PTran":
            va_bwd_bf16_by_kernel = by_kernel
        _, bf16_cfg = parser_config(["--cfg", YAML, "--set", "Model", model_name, *BF16_SET])
        # PointNet's first T-Net ends in a gradient that 8 clouds leave to bf16's rounding
        # (0.44 of its norm between bf16 and f32 on the CPU): 16 bring it under 0.3
        card_against_cpu(bf16_cfg, rng16, model_name, n, variant="bf16",
                         replay=model_name != "PTran", bf16=True,
                         batch_size=16 if model_name == "Pointnet" else CARD_B)
    del bf16_model, bf16_batch
    print(f"bf16 policy, phase 4: {time.perf_counter() - t_bf16:.1f} s", flush=True)

    # 4m. the source-only trainer for the three classifiers (one epoch, then
    # --resume) and infer without --dg from each checkpoint, card against CPU;
    # train_dg_naive_mmd (DG_baseline.yaml, DGCNN) and train_uda (PointNet);
    # one bf16 source epoch of DGCNN, its EdgeConv kernels in values_bf16
    # mode; one source-only loss and one naive alternating step at B=8 on the
    # card against the CPU
    t_new = time.perf_counter()
    rng15 = np.random.default_rng(15)  # 4m's own, so the later draws stay as they were
    got, source_by_kernel = source_runs(train_source, infer, rng15, dev, CLASSIFIERS)
    va_bwd_by_kernel = {k: va_bwd_by_kernel[k] + source_by_kernel[k] for k in VA_BWD_KERNELS}
    alternating = alternating_runs(train_dg_naive_mmd, train_uda, rng15)
    for counted in (got, alternating):
        fwd_launches += counted["edgeconv_fwd"]
        bwd_launches += counted["edgeconv_bwd"]
        va_launches += counted["vecattn_fwd"]
        va_bwd_calls += counted["vecattn_bwd_calls"]
        fps_launches += counted["fps"]
    from sug_tpu_torch.models import dgcnn as dgcnn_module

    modes, reduce = [], dgcnn_module.fused_edgeconv_reduce

    def recording(*args, values_bf16=False, **kwargs):  # the mode of each block's call
        modes.append(values_bf16)
        return reduce(*args, values_bf16=values_bf16, **kwargs)

    dgcnn_module.fused_edgeconv_reduce = recording
    try:
        got, _ = source_runs(train_source, infer, rng15, dev, ("DGCNN",), sets=BF16_SET,
                             resume=False)
    finally:
        dgcnn_module.fused_edgeconv_reduce = reduce
    if not modes or not all(modes):
        fail(f"the bf16 source run called the EdgeConv blocks in values_bf16 mode {sum(modes)} "
             f"of {len(modes)} times")
    bf16_launches = {k: bf16_launches[k] + got[k] for k in COUNTERS}
    _, baseline_cfg = parser_config(["--cfg", BASELINE_YAML])
    new_paths_card_against_cpu(baseline_cfg, rng15)
    print(f"source-only and alternating paths, phase 4: {time.perf_counter() - t_new:.1f} s",
          flush=True)

    # 4n. PointNet++ (its classifier ran in 4m): the DG trainer through its
    # front door, one epoch then --resume; infer --dg; one DG loss and one MSG
    # segmenter forward at B=8 on the card against the CPU; reference .pth
    # files converted by the entry point and served by infer --dg
    t_pn2 = time.perf_counter()
    rng16b = np.random.default_rng(161)  # 4n's own, so the later draws stay as they were
    got, _ = train_and_resume(train_dg_single_gpu.main, rng16b, "Pointnet2")
    fps_launches += got["fps"]
    launches, pn2_model, pn2_batch = serving_run(infer, "Pointnet2", 8, rng16b, dev, 2 * B)
    fps_launches += launches["fps"]
    _, pn2_cfg = parser_config(["--cfg", YAML, "--set", "Model", "Pointnet2"])
    pointnet2_card_against_cpu(pn2_cfg, rng16b)
    got = converted_serving(infer, rng16b, dev)
    fwd_launches += got["edgeconv_fwd"]
    fps_launches += got["fps"]
    print(f"PointNet++ and the converted checkpoints, phase 4: {time.perf_counter() - t_pn2:.1f} s",
          flush=True)

    # 5. times
    print(f"times (CUDA events), card: {smi}", flush=True)
    entry = {"name": "edgeconv_fwd", "route": "cuda",
             "source": "sug_tpu_torch/csrc/edgeconv_fwd.cu",
             "replaces": "sug_tpu/ops/edgeconv_pallas.py:498",
             "launches": fwd_launches, "max_abs_err": max_abs_err, "ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "library_ms": None, "shapes": []}
    time_edgeconv_fwd(gen, dev, entry)

    # the backward at the forward's five shapes, fed by one forward launch;
    # no single PyTorch call replays, routes first hits and scatters
    bwd_entry = {"name": "edgeconv_bwd", "route": "cuda",
                 "source": "sug_tpu_torch/csrc/edgeconv_bwd.cu",
                 "replaces": "sug_tpu/ops/edgeconv_pallas.py:589",
                 "launches": bwd_launches, "max_abs_err": bwd_max_abs_err, "ms": 0.0,
                 "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None,
                 "shapes": []}
    time_edgeconv_bwd(gen, dev, bwd_entry)

    # the two kernels in the bf16 policy's values_bf16 mode, at the same
    # five N=1024 shapes, u in bf16; launches from phase 4l's bf16 runs
    t_bf16 = time.perf_counter()
    bf16_entries = [
        {"name": f"{e['name']}_bf16", "route": "cuda", "source": e["source"],
         "replaces": e["replaces"], "mode": "values_bf16",
         "launches": bf16_launches[counter], "max_abs_err": err, "ms": 0.0, "plain_ms": 0.0,
         "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None, "shapes": []}
        for e, counter, err in ((entry, "edgeconv_fwd", bf16_max_abs_err),
                                (bwd_entry, "edgeconv_bwd", bf16_bwd_max_abs_err))]
    time_edgeconv_bf16(dev, *bf16_entries)

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: ensemble_logits(model, batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"forward (NetMDA DGCNN eval, ensemble logits), B={B}, N={N_POINTS}: {fwd_ms:.3f} ms "
          f"per batch, {B / fwd_ms * 1e3:.1f} clouds/s; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    with torch.no_grad():
        profile_device(lambda: ensemble_logits(model, batch), "inference forward", fwd_ms)
    del model
    model = bf16_models.pop("DGCNN")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: ensemble_logits(model, batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"forward (NetMDA DGCNN eval, bf16 policy), B={B}, N={N_POINTS}: {fwd_ms:.3f} ms per "
          f"batch, {B / fwd_ms * 1e3:.1f} clouds/s; peak device memory {peak / 2**20:.1f} MiB",
          flush=True)
    with torch.no_grad():
        profile_device(lambda: ensemble_logits(model, batch), "bf16 inference forward", fwd_ms)
    del model
    print(f"bf16 policy, phase 5 kernels and DGCNN forward: {time.perf_counter() - t_bf16:.1f} s",
          flush=True)

    # the vector-attention kernel at the PTran forward's five shapes; no
    # single PyTorch call does kNN + per-edge MLPs + per-channel softmax
    va_entry = {"name": "vecattn_fwd", "route": "cuda",
                "source": "sug_tpu_torch/csrc/vecattn_fwd.cu",
                "replaces": "sug_tpu/ops/vector_attention_pallas.py:523",
                "launches": va_launches, "max_abs_err": va_max_abs_err, "ms": 0.0,
                "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "operations",
                "library_ms": None, "shapes": []}
    for name, n, k in VA_SHAPES:
        args = va_inputs(n, gen, dev)
        ms = timed_ms(lambda: vector_attention.vector_attention_fwd(*args, k), iters=5)
        plain_ms = timed_ms(lambda: vector_attention.vector_attention_fwd_plain(*args, k), iters=3)
        b_ms, b_by, nbytes, flops, f32_ms = va_bound(args, k)
        l2 = va_weight_l2_bytes(B, n, D_MODEL, 3)
        print(f"  vector attention {name} (B={B}, N={n}, D={D_MODEL}, k={k}): kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the 3xTF32 bound), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} with 3xTF32 tensor cores "
              f"({f32_ms:.4f} ms in f32 outside them; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP); weight bytes asked of L2 by the design (a count, "
              f"not measured) {l2 / 1e9:.3f} GB", flush=True)
        if b_by != "operations":
            va_entry["bound_by"] = "bytes"
        va_entry["shapes"].append({"name": name, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": b_ms, "bound_by": b_by})
        va_entry["ms"] += ms
        va_entry["plain_ms"] += plain_ms
        va_entry["bound_ms"] += b_ms
    del args

    # the PTran inference forward (transformer width 512) per batch of 64, in
    # f32 and under the bf16 policy (the bf16 serving model of phase 4l)
    for net, policy in ((ptran_model, "f32"), (bf16_models.pop("PTran"), "bf16")):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with torch.no_grad():
            pt_ms = timed_ms(lambda: ensemble_logits(net, ptran_batch), iters=5)
        peak = torch.cuda.max_memory_allocated()
        print(f"forward (NetMDA PTran eval, ensemble logits, {policy}), B={B}, N={N_POINTS}: "
              f"{pt_ms:.3f} ms per batch, {B / pt_ms * 1e3:.1f} clouds/s; peak device memory "
              f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above what the script "
              "held before)", flush=True)
        with torch.no_grad():
            profile_device(lambda: ensemble_logits(net, ptran_batch),
                           f"PTran inference forward ({policy})", pt_ms, iters=2)
        # 2 warm-up, 5 timed and 2 profiled forwards
        check_launches(f"PTran inference forward ({policy})", "PTran", N_POINTS, 0, 9)
    del ptran_model, ptran_batch, net

    # the vector-attention backward at the same five shapes, fed by one
    # forward launch; no single PyTorch call replays the edges, takes the
    # per-channel softmax's gradient, scatters by key and forms the four
    # weight gradients. "launches" counts kernel launches, "calls" the
    # backward calls they belong to.
    va_bwd_entry = {"name": "vecattn_bwd", "route": "cuda",
                    "source": "sug_tpu_torch/csrc/vecattn_bwd.cu",
                    "replaces": "sug_tpu/ops/vector_attention_pallas.py:574",
                    "launches": sum(va_bwd_by_kernel.values()), "calls": va_bwd_calls,
                    "launches_by_kernel": va_bwd_by_kernel, "max_abs_err": va_bwd_max_abs_err,
                    "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "operations",
                    "library_ms": None, "shapes": []}
    for name, n, k in VA_SHAPES:
        args = va_inputs(n, gen, dev)
        saved = va_bwd_saved(args, k, gen)
        ms = timed_ms(lambda: vector_attention.vector_attention_bwd(*args, k, *saved), iters=3,
                      warmup=1)
        plain_ms = timed_ms(lambda: vector_attention.vector_attention_bwd_plain(*args, k, *saved),
                            iters=2, warmup=1)
        b_ms, b_by, nbytes, flops, f32_ms = va_bwd_bound(args, k)
        l2 = va_weight_l2_bytes(B, n, D_MODEL, 6)  # the edge kernel's six products
        print(f"  vector-attention backward {name} (B={B}, N={n}, D={D_MODEL}, k={k}): kernels "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the 3xTF32 bound), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} with 3xTF32 tensor cores "
              f"({f32_ms:.4f} ms in f32 outside them; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP); weight bytes asked of L2 by the edge kernel's design "
              f"(a count, not measured) {l2 / 1e9:.3f} GB", flush=True)
        if b_by != "operations":
            va_bwd_entry["bound_by"] = "bytes"
        va_bwd_entry["shapes"].append({"name": name, "ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": b_ms, "bound_by": b_by})
        va_bwd_entry["ms"] += ms
        va_bwd_entry["plain_ms"] += plain_ms
        va_bwd_entry["bound_ms"] += b_ms
        # where one backward call's time goes, by kernel
        profile_device(lambda: vector_attention.vector_attention_bwd(*args, k, *saved),
                       f"vector-attention backward, {name}", ms, iters=1)
    del args, saved

    # the two kernels' bf16 mode at the same five shapes; launches from phase
    # 4l's bf16 runs
    va_bf16_entry = {**va_entry, "name": "vecattn_fwd_bf16", "mode": "bf16 (precise=False)",
                     "launches": bf16_launches["vecattn_fwd"],
                     "max_abs_err": va_bf16_max_abs_err, "ms": 0.0, "plain_ms": 0.0,
                     "bound_ms": 0.0, "bound_by": "operations", "shapes": []}
    va_bwd_bf16_entry = {**va_bwd_entry, "name": "vecattn_bwd_bf16", "mode": "bf16 (precise=False)",
                         "launches": sum(va_bwd_bf16_by_kernel.values()),
                         "calls": bf16_launches["vecattn_bwd_calls"],
                         "launches_by_kernel": va_bwd_bf16_by_kernel,
                         "max_abs_err": va_bwd_bf16_max_abs_err, "ms": 0.0, "plain_ms": 0.0,
                         "bound_ms": 0.0, "bound_by": "operations", "shapes": []}
    time_va_bf16(dev, va_bf16_entry, va_bwd_bf16_entry)

    # the large-N kernels at the shapes of the PointNet step at 4096 points:
    # one chamfer of two B=64 clouds (two min-dists launches), one SA-node FPS
    gk = geometry_kernels
    q, s = unit_clouds(B, N_LARGE, gen, dev), unit_clouds(B, N_LARGE, gen, dev)
    ms = timed_ms(lambda: (gk.min_dists(q, s), gk.min_dists(s, q)), iters=20)
    plain_ms = timed_ms(lambda: (gk.min_dists_plain(q, s), gk.min_dists_plain(s, q)), iters=5)

    def library_chamfer():
        d = torch.cdist(q, s)  # (B, N, M) Euclidean distances
        return torch.amin(d, dim=2).square(), torch.amin(d, dim=1).square()

    library_ms = timed_ms(library_chamfer, iters=5)
    # per call: 7 operations per (query, source) pair, what the function needs
    # (|s|² - 2·q·s in 3 FMAs, an FMA counting two, and a min; |q|² added
    # once per query after the min); q and s read once, the (B, N) mins
    # written once
    flops = 2 * 7.0 * B * N_LARGE * N_LARGE
    nbytes = 2 * 4.0 * B * (3 * N_LARGE + 3 * N_LARGE + N_LARGE)
    t_ops, t_bytes = flops / F32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    md_entry = {"name": "min_dists", "route": "cuda", "source": "sug_tpu_torch/csrc/chamfer_min.cu",
                "replaces": "sug_tpu/ops/pallas_kernels.py:84", "launches": md_launches,
                "max_abs_err": md_max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": library_ms}
    print(f"  min-dists, one chamfer (two launches, B={B}, N=M={N_LARGE}): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, torch.cdist + amin over "
          f"each axis (three calls and two squares, the (B, N, M) matrix materialised) "
          f"{library_ms:.4f} ms, bound {md_entry['bound_ms']:.4f} ms by {md_entry['bound_by']} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    del q, s

    # FPS at every shape of FPS_SHAPES: the kernel through its launcher, its
    # device time per launch (the launcher's CUDA-event time at small clouds
    # is the host's launch rate), the wrapper, the plain loop. Per point and
    # step 3 subtractions, 3 multiplies, 2 adds, a min and a compare, over the
    # npoint - 1 steps whose arg-max the function needs; xyz and the starts
    # read once, the indices written once. Neither binds in practice: each
    # step ends in an arg-max over the cloud that the next step needs. The
    # JSON line's numbers are the SA-node's at 4096 points, as before.
    fps_entry = {"name": "fps", "route": "cuda", "source": "sug_tpu_torch/csrc/fps.cu",
                 "replaces": "sug_tpu/ops/pallas_kernels.py:161", "launches": fps_launches,
                 "max_abs_err": 0.0, "library_ms": None, "shapes": []}
    for b, n, npoint in FPS_SHAPES:
        xyz = unit_clouds(b, n, gen, dev)
        starts = torch.randint(0, n, (b,), generator=gen, device=dev)
        iters = 50 if n * npoint <= 1 << 20 else 10
        name = f"B={b} N={n} npoint={npoint}"
        ms = timed_ms(lambda: gk._launch_fps(xyz, npoint, starts), iters=iters)
        dev_ms = kernel_split(lambda: gk._launch_fps(xyz, npoint, starts), f"FPS {name}", ms,
                              (("fps", "fps_kernel"),))["fps"]
        wrapper_ms = timed_ms(lambda: gk.fps(xyz, npoint, starts), iters=iters)
        plain_ms = timed_ms(lambda: gk.fps_plain(xyz, npoint, starts), iters=3, warmup=1)
        flops = 10.0 * b * n * (npoint - 1)
        nbytes = 12.0 * b * n + 8.0 * b + 8.0 * b * npoint
        t_ops, t_bytes = flops / F32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        shape = {"name": name, "ms": ms, "device_ms": dev_ms, "wrapper_ms": wrapper_ms,
                 "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "team": list(gk.fps_plan(n))}
        fps_entry["shapes"].append(shape)
        if (b, n, npoint) == (B, N_LARGE, 64):
            fps_entry.update({k: shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        print(f"  FPS ({name}, team {shape['team']}): kernel {ms:.4f} ms through its launcher, "
              f"{dev_ms:.4f} ms on the device ({dev_ms / npoint * 1e3:.3f} us per dependent "
              f"step), {wrapper_ms:.4f} ms through the wrapper, plain {plain_ms:.4f} ms, bound "
              f"{shape['bound_ms']:.5f} ms by {shape['bound_by']} ({nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP)", flush=True)
        del xyz, starts

    # the PointNet inference forward per batch of 64 at 4096 and at 1024 points
    pn_batch_1024 = torch.from_numpy(PointCloudDataset(
        "modelnet", synthetic_clouds(rng, B)[0], np.zeros(B), num_points=N_POINTS).pts).to(dev)
    pn_bf16 = bf16_models.pop("Pointnet")
    for n, pc, net, policy in ((N_LARGE, pn_batch, pn_model, "f32"),
                               (N_POINTS, pn_batch_1024, pn_model, "f32"),
                               (N_LARGE, pn_batch, pn_bf16, "bf16"),
                               (N_POINTS, pn_batch_1024, pn_bf16, "bf16")):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with torch.no_grad():
            fwd_ms = timed_ms(lambda: ensemble_logits(net, pc), iters=10)
        peak = torch.cuda.max_memory_allocated()
        print(f"forward (NetMDA Pointnet eval, ensemble logits, {policy}), B={B}, N={n}: "
              f"{fwd_ms:.3f} ms per batch, {B / fwd_ms * 1e3:.1f} clouds/s; peak device memory "
              f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above what the script held "
              "before)", flush=True)
        with torch.no_grad():
            profile_device(lambda: ensemble_logits(net, pc),
                           f"Pointnet inference forward N={n} ({policy})", fwd_ms)
        # 2 warm-up, 10 timed and 3 profiled forwards
        check_launches(f"Pointnet inference forward N={n} ({policy})", "Pointnet", n, 0, 15)
    del pn_model, pn_bf16, pn_batch, pn_batch_1024

    # the PointNet++ inference forward per batch of 64 (the serving model of 4n)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: ensemble_logits(pn2_model, pn2_batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"forward (NetMDA Pointnet2 eval, ensemble logits), B={B}, N={N_POINTS}: {fwd_ms:.3f} ms "
          f"per batch, {B / fwd_ms * 1e3:.1f} clouds/s; peak device memory {peak / 2**20:.1f} MiB "
          f"({(peak - held) / 2**20:.1f} MiB above what the script held before); card {smi}",
          flush=True)
    with torch.no_grad():
        profile_device(lambda: ensemble_logits(pn2_model, pn2_batch), "Pointnet2 inference forward",
                       fwd_ms)
    # 2 warm-up, 10 timed and 3 profiled forwards
    check_launches("Pointnet2 inference forward", "Pointnet2", N_POINTS, 0, 15)
    del pn2_model, pn2_batch

    # the DG train steps: B=64 source + 64 target clouds, full MSA/SDA loss,
    # augmentation on; bench.py's flagship shape (N=1024) for each model, and
    # the large-N slice's N=4096 for PointNet (the shipped config) and DGCNN
    step_args = {}
    for n in (N_POINTS, N_LARGE):
        clouds, labels = synthetic_clouds(rng, 2 * B, n)
        clouds = PointCloudDataset("modelnet", clouds, labels, num_points=n).pts
        step_args[n] = [torch.from_numpy(a).to(dev) for a in
                        (clouds[:B], labels[:B], clouds[B:], labels[B:])]
    lrs = (1e-4, 1e-4, 1e-4)

    def time_step(trainer, model_name, n, iters, stacked, bf16=False):
        """One timed run of the step (the bf16 policy on the model where
        ``bf16``): ms, clouds/s, peak memory, busy share and kernels per step,
        and its launches checked against ``MAIN_PATHS`` (the same in bf16)."""
        forward = ("stacked" if stacked else "sequential") + (" bf16" if bf16 else "")
        trainer.model.set_compute_dtype(torch.bfloat16 if bf16 else None)
        with stacked_forward(stacked):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            step_ms = timed_ms(lambda: trainer.train_step(*step_args[n], *lrs), iters=iters)
            peak = torch.cuda.max_memory_allocated()
            print(f"DG train step ({model_name}, {forward} forward, B={B}+{B}, N={n}, geo+sem "
                  f"soft-MMD, augmentation): {step_ms:.3f} ms per step, "
                  f"{2 * B / step_ms * 1e3:.1f} clouds/s; peak device memory {peak / 2**20:.1f} "
                  f"MiB ({(peak - held) / 2**20:.1f} MiB above what the script held before)",
                  flush=True)
            busy = profile_device(lambda: trainer.train_step(*step_args[n], *lrs),
                                  f"{model_name} DG train step N={n} ({forward})", step_ms,
                                  iters=2)
            # 2 warm-up, the timed and 2 profiled steps
            check_launches(f"{model_name} DG train step N={n} ({forward})", model_name, n,
                           iters + 4, 0, "stacked" if stacked else None)
        return {"ms": step_ms, "clouds_per_s": 2 * B / step_ms * 1e3, "peak_mib": peak / 2**20,
                "busy": None if busy is None else busy[0],
                "kernels": None if busy is None else busy[1]}

    # the A/B cells run sequential, stacked, stacked, sequential on one trainer,
    # and the bf16 cells sequential f32, bf16, bf16, sequential f32; a cell of
    # both runs f32, stacked, bf16, bf16, stacked, f32
    ab = {}
    t_steps = time.perf_counter()
    for model_name, model_cfg, iters, n in (("DGCNN", cfg, 5, N_POINTS),
                                            ("PTran", ptran_cfg, 3, N_POINTS),
                                            ("Pointnet", pn_cfg, 5, N_LARGE),
                                            ("Pointnet", pn_cfg, 5, N_POINTS),
                                            ("DGCNN", cfg, 3, N_LARGE),
                                            ("Pointnet2", pn2_cfg, 5, N_POINTS)):
        trainer = DGTrainer(model_cfg, model_name=model_name, device=dev, seed=0, num_points=n)
        inner = ([(True, False)] if (model_name, n) in AB_CELLS else []) + (
            [(False, True)] if (model_name, n) in BF16_CELLS else [])
        order = [(False, False)] + inner + inner[::-1] + [(False, False)]
        runs = [(st, b16, time_step(trainer, model_name, n, iters, st, b16)) for st, b16 in order]
        if len(runs) > 1:
            cell = ab.setdefault(f"{model_name} N={n}", {})
            for st, b16, r in runs:
                label = ("stacked" if st else "sequential") + (" bf16" if b16 else "")
                cell.setdefault(label, []).append(r)
        del trainer
    print(f"the steps' A/B cells: {time.perf_counter() - t_steps:.1f} s", flush=True)
    t_new = time.perf_counter()
    time_new_paths(step_args[N_POINTS], baseline_cfg, smi)
    print(f"source-only and alternating paths, phase 5: {time.perf_counter() - t_new:.1f} s",
          flush=True)
    print(f"stacked against sequential forward and bf16 against f32, DG train step at "
          f"B={B}+{B} (card: {smi}; runs in turns, as above):", flush=True)
    for cell, by_forward in ab.items():
        for forward, runs in by_forward.items():
            print(f"  A/B {cell} {forward}: " + "; ".join(
                f"{r['ms']:.4f} ms, {r['clouds_per_s']:.1f} clouds/s, busy "
                + ("not measured" if r["busy"] is None else
                   f"{r['busy']:.1%}, {r['kernels']:.0f} kernels a step")
                + f", peak {r['peak_mib']:.1f} MiB" for r in runs), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [entry, bwd_entry, va_entry, va_bwd_entry, md_entry, fps_entry,
                                  *bf16_entries, va_bf16_entry, va_bwd_bf16_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
