#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hse_facerec_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a). It:

1. prints the card's name and power limit and sets parity numerics
   (fp32, no TF32);
2. builds the CUDA kernels from ``hse_facerec_torch/csrc`` with nvcc;
3. holds K1 (crop) against its plain PyTorch version at the analyze
   path's three call sites, at the same sites over a batch of 8 images
   and in ragged lane cases (each with its device time by
   ``torch.profiler``, its host µs a call and ``F.grid_sample``), and K4 (int8
   pointwise conv) at the 13 pointwise layers of a 16-face head batch and
   a ragged shape, and times both with CUDA events, K4 per layer beside
   its bound and ``torch._int_mm``; counts the IMMA, IGMMA, HMMA and HGMMA
   (tensor-core) and IDP.4A instructions in the SASS of K4 and of the
   int8 and bf16 1-NN sweeps; then, in a child process, K5 (attention)
   against its plain version in float64 at the ViT-L chunk (256 images x
   144 tokens x 8 heads x 96) and at ragged tokens and heads, one launch a
   call, timed beside its bound, its plain version and
   ``F.scaled_dot_product_attention``, one profiled call running exactly
   one device kernel; then, in another child, K6 (fused BN/PReLU/residual)
   at every pass and activation shape of IResNet-100's trunk at batch 256,
   one launch a call, bit-equal to torch's own passes, timed beside its
   bytes bound and those passes, and summed over one 256-face chunk; then,
   in a third child, K7 (bias + ReLU6, the next conv's zero edge) at the
   27 folded layers of MobileNet-V1 at 224² and batch 256, the same way,
   beside torch's add, clamp and ``F.pad``;
4. drives the analyze path: ``FacialAnalyzer.analyze_with_rotations``
   (K1, and K7's 27 launches in each head forward), timed, then checked
   against the same analyzer on the CPU; then
   the batch path at batch 8 (``analyze_batch``: one K1 launch per crop
   site for the whole batch, the head crops with a lane index), timed
   beside 8 single-image analyses and ``detect_batch``, checked against
   the card's single-image ``analyze`` and the CPU's ``analyze_batch``,
   and ``analyze_batch_retry_padded`` through the rotation pair; then the
   album organizer (``process_album`` on 108 seeded BMP photos in two
   shapes, 4 of them found only after the 90° retry, and 2 clips served
   through ``_open_video``: the scan on the batch path with K1, clustering,
   Dempster-Shafer, naming from an int8 gallery on K2c), timed beside
   ``analyze_batch``, with a cached re-run, a one-flush-thread scan, a CPU
   organizer on 8 of the photos, the CPU's distances, clusters and labels,
   one profiled flush, and clustering at 4096 x 1024-d faces (the distance
   matrix on the card, HAC and native rank-order on the host); then
   ``analyze_with_rotations`` again with ``Int8MultiheadHeads`` (analyze
   --int8-heads: K1 + K4, no K7),
   whose boxes must equal the f32 analyzer's, and whose int8 activations
   on the CPU's own crops must match the CPU's stage by stage; then the
   int8 embedder at
   224², batch 1024, beside the f32 one (27 K7 launches a forward, the
   int8 one none), with a profile of one int8
   forward, and K4 against its plain version again at the batch-1024
   layer shapes;
5. holds K2a/K2b/K2c (1-NN) against their plain twins on ragged shapes
   with ties, at serving shapes (1 and 16 probes against 1,048,576
   gallery rows), for the int8 kernels at the design point (8192 x
   1,048,576 x 512), for K2a at its routed shape (2048 x 1,048,576 x
   1024 f32) and on bf16 operands at the benchmark's shape (8192 x
   1,048,576 x 512: the bf16 tensor-core sweep, its wrapper's own passes
   timed apart), timed with CUDA events beside their bounds and a
   library call (``torch._int_mm``, ``torch.mm``); the SASS of the bf16
   sweep must hold HMMA (its 16-probe tile) and HGMMA (its 128-probe
   tile);
6. drives the identify paths at full width:
   - identify: the ``agegender_identity`` extractor (27 K7 launches a
     forward on its resized crops), then the ``agegender_identity_int8``
     one (K4, no K7), embeds a seeded gallery/probe tree through
     ``extract_files``, then ``KNNIdentifier(quantized=True)``
     (K2b) and an int8 ``EnrollmentGallery`` (K2c) rank the probes;
     answers equal the same objects on the CPU;
   - identify at scale: 2048 probes against 1,048,576 enrolled 1024-d
     embeddings through an exact ``KNNIdentifier`` (K2a on f32 operands:
     the f32 matrix would be 8 GiB), checked against the chunked f32
     twin, and ``gallery_probe_eval`` quantized (K2b), then 16-probe
     serving queries against the packed gallery (K2c), checked against
     the int8 twin;
   - analyze --gallery: ``analyze_with_rotations`` then
     ``EnrollmentGallery.identify_many`` per photo (K1 + K2c);
   - serve: the HTTP server wired as ``serve.build_server`` wires it
     (seeded weights, a BMP decoder): the embed worker on
     ``agegender_identity_int8`` (K4), the analyze worker at 8 lanes
     (K1), an int8 gallery of 65,536 seeded 1024-d identities (K2c);
     8 people enrolled through ``/enroll?mode=face``, then 16 client
     threads x 12 requests mixing ``/analyze?identify=1``,
     ``/identify?mode=face`` and ``/embed``, then ``/profile``,
     ``/stats``, ``/gallery`` and ``/healthz``: every response 200 and
     equal to the direct call, requests/s, p50/p95 per endpoint and the
     workers' queue_wait/assemble/process split;
   - zoo: ``vgg2_mobilenet``, ``vgg2_mobilenet_int8`` (K4 at 192²) and
     ``vgg2_resnet`` from seeded params exported to a pb and imported
     back (equal bit for bit), a batch of 64 embedded and timed; then
     ``graph_extractor`` on the exported MobileNet pb against
     ``mobilenet_embed``; then K4 against its plain version at the 13
     layers of that batch at 192²;
   - two-model analyze (``analyze --age-pb/--gender-pb``): seeded
     multi-head params exported as a MobileNet-V1 age pb at 192² and a
     gender pb at 224², run through the graph compiler: exactly 3 K1
     launches per ``analyze`` and per ``analyze_batch`` at batch 8, both
     timed in turns with the one-model analyzer, one profiled batch call
     of each; the halves exported at 224² equal the one-model analyzer's
     ages and P(male) on the card; the card against the CPU;
   - utkface: ``evaluate_age_gender`` over 128 seeded UTKFace-named .npy
     photos in two sizes at batch 64 through each of the nine backends at
     its published width (images/s), card against CPU on 16;
   - identify ``--quantized`` and the gallery (K2b, K2c) on
     ``insightface_arcface`` (IResNet-100, 512-d at 112²) and
     ``vggface_vgg16`` (4096-d at 224²), and their embed img/s at batch 64;
   - vit: ``build_extractor("insightface_vit_l")`` at full width (768
     wide, 24 blocks, 8 heads, 144 tokens, 512-d) on 1,024 crops a call at
     batch 256, as the ``vit-enroll`` cell runs it: exactly 96 K5 launches
     a call and no other kernel of the library, 4 rows against the CPU's
     extractor, the call timed;
   - swin, in a child process: first K8 (windowed attention) against its
     plain version in float64 at each shape of Swin-T's 12 launches a
     256-face chunk (56² x 3 heads to 7² x 24, shifted and not), one launch
     a call, timed beside its bound, its plain version and
     ``F.scaled_dot_product_attention`` with the bias and mask as a float
     ``attn_mask``; then ``build_extractor("swin_t_face")`` at full width
     from the ``swin-enroll`` cell's seeded weights on 1,024 crops a call at
     batch 256: exactly 48 K8 launches a call, no other kernel of the
     library and no ``torch.roll``, 4 rows against the CPU's extractor,
     the call timed;
   - K2b/K2c at D 4096 (16 and 8192 x 1,048,576 probes): the probe tile
     (16 resident; 128 streamed beside the gallery), bit-equality with
     the twin, ms, T int8 ops/s and the share of the bound beside the
     bound, the twin and ``torch._int_mm``;
   - align: the card's detector's landmarks through
     ``landmarks_from_detector`` and ``align_faces`` at 112² on the card
     and on the CPU, and faces/s at a batch of 256 faces;
   - cascade: ``CascadeFallbackDetector`` on a synthetic LBP cascade in
     OpenCV's format (``testing.write_lbp_cascade``: 24x24, 20 stages,
     thresholds set on the photos) on 640x480 photos, the card's boxes
     equal to the CPU's, ms a photo on each;
7. holds K3 (the augmentation warp) against its plain version at the
   training shape (256 x 224 x 224 x 3, two augmentation configs) and at
   edge shapes, timed beside ``F.grid_sample``, and profiles one call at
   the training shape, which must run exactly one device kernel;
8. drives face-ID training at full width: ``FaceIdTrainer`` (MobileNet-V1
   alpha 1.0, 224², batch 256, 9131 classes, augmentation on K3), bf16
   then float32, timed, with a ``torch.profiler`` split of one step; the
   loss falls over 10 steps on one batch; one step at width 1.0 on the card
   and on the CPU from the same params agrees (loss in float32, gradients
   in float64), and K3 agrees with the CPU's plain version;
9. drives the age/gender trainer at the JAX bench's configuration
   (``AgeGenderTrainer``, MobileNet-V1 alpha 1.0, 224², batch 256,
   augmentation on K3): pairs of one age and one gender step, unfrozen at
   lr 1e-4 and frozen, bf16 and float32, timed with exactly 2 K3 launches
   a pair, the upload timed apart, one profiled pair with K3's share; then
   an age and a gender step, frozen and unfrozen, on the card and on the
   CPU from the same params and dropout masks (losses in float32, params
   in float64, the frozen backbone and the idle head bit-identical);
10. drives the multi-device slice (``multichip``) over 4 virtual shards on
   the one card (``make_mesh(devices=["cuda"] * 4)``), each row beside the
   same work on one device: the gallery sharded at 1,048,576 x 1024-d int8
   (a 2048-probe ``KNNIdentifier(quantized=True, mesh=...)`` evaluation
   and 16-probe ``EnrollmentGallery(mesh=...)`` queries, K2b once a shard a
   query, the ranking state placed once), mesh ``analyze_batch`` at batch 8
   (exactly 3 K1 launches a shard), ``EmbeddingExtractor(mesh=...)`` at
   batch 1024, ``FaceIdTrainer(mesh=...)`` (K3 once a shard a step), the
   sharded age/gender pair (K3 once a shard a step) and the dp x tp face-ID
   trainer on a (2, 2) mesh in bf16 and float32 (replicas bit-identical),
   all at the JAX bench's sizes, with answers equal to one device's within
   the CPU tests' bounds; then ``dryrun_multichip(4)``. Virtual shards
   measure the mesh's bookkeeping and extra launches, not scaling over
   cards;
11. phase ``tiers``, in a child process started without
   ``set_parity_numerics`` (torch's own flags: TF32 in cuDNN convs): the
   ``fp32_precision`` flags govern cuDNN convs and cuBLAS matmuls on the
   card (a conv and a matmul at each tier against float64); the default
   ``FacialAnalyzer`` (``analyze`` and ``analyze_batch``) and
   ``build_extractor("vgg2_mobilenet")`` give answers bit-equal to the
   same runs after ``set_parity_numerics``; the drift of the "high" and
   "default" tiers and of bf16 ``compute_dtype`` against "highest", and the
   median of 7 times by CUDA events, for ``analyze``, ``analyze_batch`` at
   8 and the two-model ``analyze`` (each launching K1, counted from 0),
   each f32 zoo embed at batch 64 and a face-ID training forward at 256;
   two threads, one running ``analyze``
   at "highest" and one a zoo embed at "default", 20 rounds, the
   "highest" answers bit-equal to a solo run.
The K1 checks and the K4 checks at batch 1024 and at 192² run in child
processes too: profiler sessions late in one process lose kernel records.
The parent and the other children call ``set_parity_numerics`` first, as
they did before each forward held its own tier; no answer depends on it.
Each path runs with the launch counters set to 0 just before it and read
just after, and fails if it did not launch its kernels.
Weights are the shipped ones when present, seeded random ones otherwise.

Any failure raises (non-zero exit). The last two lines are a JSON summary
of the kernels (each with its card time, its plain version's, the least
time the card could take for the same work, ``bound_ms``, and a library
call's time where one PyTorch call computes a like function) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from hse_facerec_torch import set_parity_numerics
from hse_facerec_torch.config import AlbumConfig, TrainConfig
from hse_facerec_torch.models import zoo
from hse_facerec_torch.models.int8_infer import (block_int8, multihead_apply_int8,
                                                 quantize_multihead_int8, stem_int8)
from hse_facerec_torch.models.mobilenet import MOBILENET_V1_BLOCKS, init_mobilenet_params
from hse_facerec_torch.models.mtcnn import import_mtcnn_params
from hse_facerec_torch.models.multihead import import_multihead_params, multihead_apply
from hse_facerec_torch.models.swin import shift_of
from hse_facerec_torch.native import rankorder
from hse_facerec_torch.ops.kernels import build, kernel_launches, reset_launches
from hse_facerec_torch.ops.kernels import attention
from hse_facerec_torch.ops.kernels import bn_act
from hse_facerec_torch.ops.kernels import knn
from hse_facerec_torch.ops.kernels import pw_conv
from hse_facerec_torch.ops.kernels import warp
from hse_facerec_torch.ops.distance import l2_normalize, pairwise_sqeuclidean
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.ops.preprocess import IMAGENET_MEANS_BGR
from hse_facerec_torch.ops.resize import (_crop_weights, crop_resize_bilinear,
                                          crop_resize_bilinear_batch,
                                          crop_resize_bilinear_lanes)
from hse_facerec_torch.params import to_numpy, to_torch
from hse_facerec_torch.pipelines.album import fused_distance_matrix
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.clustering import get_facial_clusters
from hse_facerec_torch.pipelines.gallery import EnrollmentGallery
from hse_facerec_torch.pipelines.heads import Int8MultiheadHeads
from hse_facerec_torch.pipelines.identification import (KNNIdentifier,
                                                        gallery_probe_eval)
from hse_facerec_torch.ops.align import align_faces, landmarks_from_detector
from hse_facerec_torch.parallel import train_step
from hse_facerec_torch.parallel.dryrun import dryrun_multichip
from hse_facerec_torch.parallel.sharding import make_mesh
from hse_facerec_torch.parallel.train_step import (make_sharded_age_gender_trainer,
                                                   make_sharded_face_id_trainer)
from hse_facerec_torch.pipelines.cascade_fallback import CascadeFallbackDetector
from hse_facerec_torch.testing import (BmpAlbumOrganizer, bmp_bytes, decode_bmp,
                                       random_mtcnn_params, random_multihead_params,
                                       read_bmp, write_bmp, write_lbp_cascade)
from hse_facerec_torch.train import age_gender, face_id
from hse_facerec_torch.train.augment import AugmentConfig, sample_affine
from hse_facerec_torch.train.checkpoints import flatten
from perfbench import swin as perf_swin
from perfbench.flops import bound_s
from perfbench.spec import Benchmark
from perfbench.trace import card_name_and_power_limit

H, W = 480, 640
N_IMAGES = 3
# the path is host-bound: one pass over 3 photos spread 26-42 ms/image
# between runs of the same code on one card, so the median of several
ANALYZE_REPEATS = 7
SEED = 0
KERNEL_ATOL = 1e-3      # 0-255 pixel units; only the summation order differs
# (name, K boxes, out size, supersample, outside): the analyze path's calls
CROP_SHAPES = [("stage2", 128, 24, 2, "zero"),
               ("stage3", 64, 48, 2, "zero"),
               ("head", 16, 224, 1, "clamp")]
# the batch path: analyze_batch at batch 8 shares max(16, 2 x 8) head slots
# across the batch; K1's lane cases at the head site (every crop_boxes set
# has two boxes wholly outside the image): all boxes in one lane, lanes
# left empty, and the 80 crops of 16 oversampled faces (5 each)
BATCH = 8
BATCH_HEAD_SLOTS = max(16, 2 * BATCH)
ROOMY_SLOTS = 16 * BATCH        # analyze_batch's timed runs: no lane re-runs
CROP_LANE_CASES = [("head, all in one lane", [3] * 16),
                   ("head, lanes 1-6 empty", [0] * 8 + [7] * 8),
                   ("head, oversample 80", [i // 10 for i in range(80)])]
# 1-NN checks, (name, M probes, N gallery rows, D): ragged with ties, then
# serving (identify_many asks 1-16 probes of the whole gallery)
KNN_SHAPES = [("ragged", 37, 1000, 30), ("serve1", 1, 1 << 20, 512),
              ("serve16", 16, 1 << 20, 512)]
KNN_REPORT = "serve16"          # K2b/K2c's shape in the JSON line
KNN_DESIGN = (8192, 1 << 20, 512)
DESIGN_CHECK_STRIDE = 32        # the design point's twin checks every 32nd probe
# K2a's routed shape: what identify at scale launches (the f32 matrix would
# be 8 GiB, so nearest_neighbor_auto takes the kernel); K2a's JSON shape
KNN_ROUTED = (2048, 1 << 20, 1024)
# K2a on bf16 operands at the benchmark's shape (bench.py's design point)
KNN_BENCH_BF16 = (8192, 1 << 20, 512)
INT_MM_MIN_ROWS = 32            # torch._int_mm refuses 16 rows or fewer
# K2a sums in another order than its twin (rtol/atol of the reference test)
KNN_F32_RTOL, KNN_F32_ATOL = 1e-4, 1e-3
N_PEOPLE, N_GALLERY, N_PROBE = 6, 3, 2          # identify path photo tree
SCALE_N, SCALE_M, SCALE_D = 1 << 20, 2048, 1024  # identify at scale
SERVE_BATCH, SERVE_QUERIES = 16, 8
SCALE_CHECK_STRIDE = 16         # K2b's twin check at scale: every 16th probe
# K4 at the int8 path's pointwise layers: (layer, pixels per 224² face, K,
# N), at a head batch of 16 faces; pw13 stores f32
PW_LAYERS = [("pw1", 12544, 32, 64), ("pw2", 3136, 64, 128),
             ("pw3", 3136, 128, 128), ("pw4", 784, 128, 256),
             ("pw5", 784, 256, 256), ("pw6", 196, 256, 512)] + [
    (f"pw{i}", 196, 512, 512) for i in range(7, 12)] + [
    ("pw12", 49, 512, 1024), ("pw13", 49, 1024, 1024)]
PW_BATCH = 16
PW_RAGGED = ("ragged", 1000, 30, 50)     # M, K, N off the tile and word
# K4's numbers in the kernels line at each batch: the 13 layers' sums and
# each layer's route (wgmma, every layer), tile, ms, T ops/s and share
PW_KEYS = ("ms", "device_ms", "host_us", "plain_ms", "bound_ms", "bound_by",
           "library_ms", "layers")
# CUDA vs CPU bounds of the analyzer. f32: only sums in another order.
# int8 heads: the card's head crops come from K1 and the CPU's from its
# plain version (4.6e-5 px apart on the seeded photo 0); conv1 rounds its
# input to bf16 and every block requantizes, so such a difference flips
# whole quanta, and the flips cascade. On photo 0 an H100 gave ages 6.1e-3,
# P(male) 1.4e-3 and identity cosine 0.99994 off the CPU; the bounds leave
# 4-8x room. The device numerics themselves are held on the same crops
# (int8_stages_cuda_vs_cpu): int8 activations one quantum apart in at most
# FLIP_FRACTION of them, stage by stage; the whole heads as tightly as the
# CPU tests hold the port to the JAX package (an H100 read no flip, ages
# 7.6e-6, P(male) 6e-8, identity 8.6e-8 relative L2).
F32_TOL = {"box_px": 1.0, "age": 1e-2, "gender": 1e-3, "min_cos": 0.999}
INT8_TOL = {"box_px": 1.0, "age": 0.05, "gender": 5e-3, "min_cos": 0.9995}
FLIP_FRACTION = 1e-3
SAME_CROPS_TOL = {"last_block_rel_l2": 1e-5, "age": 1e-4, "gender": 1e-5,
                  "identity_rel_l2": 1e-5}
# int8 embedder throughput: the JAX bench's embed_int8 batch (bench.py:57)
EMBED_BATCH, EMBED_REPEATS = 1024, 3
# device-time groups of the int8 forward's profile, by kernel name: the
# first group whose marker is in the name takes the kernel
PROFILE_GROUPS = [("pw_conv_int8 (K4)", ("pw_conv_int8",)),
                  ("copies and dtype converts", ("copy",)),
                  ("pads (F.pad fills)", ("pad", "fill")),
                  ("convs (depthwise, conv1)", ("conv", "depthwise", "fprop",
                                                "implicit", "cudnn")),
                  ("heads and GAP (gemm, reduce)", ("gemm", "gemv", "reduce")),
                  ("bias, ReLU6 and requant passes", ("elementwise", "round", "clamp",
                                                      "add", "mul"))]
# K3 at the training shape (mats from two augmentation configs) and a
# ragged one. The bound: coordinates, taps and bf16 roundings are the plain
# version's; its FMAs round through float64, which can differ from the
# card's single rounding by one ulp of a blended value
# (name, N, H, W, C, config): beside them the kernel's edge cases, W·C off
# whole 16-byte words, C = 1 and 4, H = 1, one wide row of 4000 pixels
WARP_SHAPES = [("train", 256, 224, 224, 3, AugmentConfig()),
               ("train_shift0.2", 256, 224, 224, 3, AugmentConfig(shift=0.2)),
               ("ragged", 5, 50, 62, 3, AugmentConfig(shift=0.5, rotation_deg=30)),
               ("ragged_wc", 5, 50, 61, 3, AugmentConfig(shift=0.5, rotation_deg=30)),
               ("c1", 4, 40, 48, 1, AugmentConfig()),
               ("c4", 4, 40, 48, 4, AugmentConfig()),
               ("h1", 3, 1, 64, 3, AugmentConfig()),
               ("wide", 1, 8, 4000, 3, AugmentConfig())]
WARP_ATOL = 1e-6
# K5 (attention) against its plain version in float64: (name, images,
# tokens, heads) at D 96, the first the vit-enroll cell's chunk (ViT-L at
# batch 256), then T and H off the ViT's; the error relative to the output
# or 1 (the softmax runs online in float32, its sums in another order)
ATTN_SHAPES = [("vit_l", 256, 144, 8), ("ragged_t", 3, 33, 8), ("ragged_h", 5, 144, 3),
               ("t7_h1", 2, 7, 1)]
ATTN_RTOL = 1e-5
# K6 (fused BN/PReLU/residual) at the (C, H, W) of every activation
# IResNet-100's trunk hands it at 112², at the arcface-enroll cell's batch;
# per 256-face chunk the trunk launches each (pass, shape) this many times
# (one stem pass, per unit bn2 + PReLU and the tail: bn3 + the shortcut,
# its own BN in a stage's first unit, with the next bn1)
BN_ACT_BATCH = 256
BN_ACT_CHUNK = {
    ("stem", (64, 112, 112)): 1,
    ("bn_prelu", (64, 112, 112)): 1, ("bn_prelu", (64, 56, 56)): 2,
    ("bn_prelu", (128, 56, 56)): 1, ("bn_prelu", (128, 28, 28)): 12,
    ("bn_prelu", (256, 28, 28)): 1, ("bn_prelu", (256, 14, 14)): 29,
    ("bn_prelu", (512, 14, 14)): 1, ("bn_prelu", (512, 7, 7)): 2,
    ("tail_sc", (64, 56, 56)): 1, ("tail_sc", (128, 28, 28)): 1,
    ("tail_sc", (256, 14, 14)): 1, ("tail_sc", (512, 7, 7)): 1,
    ("tail", (64, 56, 56)): 2, ("tail", (128, 28, 28)): 12,
    ("tail", (256, 14, 14)): 29, ("tail", (512, 7, 7)): 2}
# K7 (bias + ReLU6) at the conv output of each of MobileNet-V1's 27 folded
# layers at 224², at the multihead-enroll cell's batch, once each a chunk;
# the layers before a stride-2 depthwise conv write its zero edge
BIAS_RELU6_BATCH, BIAS_RELU6_SIZE = 256, 224
# K7 launches of one folded float32 MobileNet-V1 forward on the card, one a
# layer, which the main paths that run it are held to
K7_PER_FORWARD = 27
# the ViT-L embedder as the vit-enroll cell runs it: batch 256, 1,024 crops
# a call; W_q and W_k scaled up from the source's 0.02 init, which leaves
# the attention near uniform, so that the card's rows against the CPU's
# show a fault in K5; relative L2 of VIT_CPU_ROWS rows against the CPU's
VIT_BATCH, VIT_CALL, VIT_REPEATS = 256, 1024, 3
VIT_QK_SCALE, VIT_CPU_ROWS, VIT_CPU_RTOL = 3.6, 4, 1e-4
# K8 (windowed attention) and the Swin-T embedder as the swin-enroll cell
# runs them: batch 256, 1,024 crops a call, the cell's seeded weights. K8
# against its plain version in float64 at each (R, heads, shift) of a
# chunk's 12 launches, the error relative to the output or 1 (the softmax
# runs online in float32, its sums in another order); relative L2 of
# SWIN_CPU_ROWS rows against the CPU's extractor
SWIN_CONFIG, SWIN_BATCH, SWIN_CALL, SWIN_REPEATS = "swin-t-face", 256, 1024, 3
WINATTN_RTOL, SWIN_CPU_ROWS, SWIN_CPU_RTOL = 1e-5, 4, 1e-4
# face-ID training at the JAX bench's configuration (bench.py:399)
TRAIN_CLASSES, TRAIN_BATCH, TRAIN_SIZE = 9131, 256, 224
TRAIN_WARMUP, TRAIN_STEPS, LEARN_STEPS = 2, 5, 10
# card vs CPU: one step at width 1.0, batch 8, 64², 10 classes; the CPU
# tests' bounds (tests/test_torch_train.py): loss 1e-5 relative in float32,
# gradients 1e-6 relative L2 per tensor in float64 (in float32, activations
# within about 1e-5 of ReLU6's bounds flip its gradient mask)
PARITY_BATCH, PARITY_SIZE, PARITY_CLASSES = 8, 64, 10
LOSS_REL, GRAD_REL = 1e-5, 1e-6
# device-time groups of one train step, by the aten op that launched each
# kernel (its self device time); K3 by kernel name
TRAIN_OP_GROUPS = [("conv forward", ("aten::cudnn_convolution", "aten::_conv_depthwise2d",
                                     "aten::convolution_overrideable")),
                   ("conv backward", ("aten::convolution_backward",
                                      "aten::cudnn_convolution_backward")),
                   ("classifier GEMMs", ("aten::addmm", "aten::mm", "aten::linear")),
                   ("optimizer (Adam, foreach)", ("aten::_foreach_",)),
                   ("copies and casts", ("aten::copy_", "aten::_to_copy", "aten::clone",
                                         "aten::contiguous"))]
# kernels whose SASS must hold tensor-core MMAs: (function name marker,
# kernel id, the MMA instructions: the int8 kernels IGMMA (wgmma; no IMMA,
# mma.sync, may remain in them); the bf16 sweep's 16-probe tile runs
# mma.sync, its 128-probe tile wgmma; whether __dp4a may appear: only in
# the int8 sweep, whose K2b form squares the gallery rows with it for the
# norms, never for a dot)
SASS_KERNELS = [("pw_conv_int8", "K4", ("IGMMA",), False),
                ("knn_int8", "K2b/K2c", ("IGMMA",), True),
                ("knn_bf16", "K2a bf16", ("HMMA", "HGMMA"), False)]
SASS_OPS = ("IMMA", "IGMMA", "HMMA", "HGMMA", "IDP.4A")


# the album phase: 24 landscape scenes x 4 variants (640x480), 2 portrait
# scenes x 4 (480x640), 4 photos found only after the 90° retry, 2 clips
ALBUM_SCENES, ALBUM_VARIANTS, ALBUM_PORTRAIT_SCENES = 24, 4, 2
ALBUM_ROTATED, ALBUM_CLIPS, CLIP_FRAMES, ALBUM_SUBSET = 4, 2, 60, 8
ALBUM_GALLERY = 4               # scenes with one face enrolled in the int8 gallery
ALBUM_MINSIZE = 112             # the reference album's (process_photos.py:385)
ALBUM_TOL = {"age": 1e-3, "gender": 1e-4, "min_cos": 0.9999}
FADES = (0.15, 0.25, 0.35, 0.5, 0.7)   # contrasts of the turned photos' search
CLUSTER_SCALE = (4096, 1024, 64)    # faces, dims, centres
CLUSTER_SPREAD = 0.3            # noise per dim around a centre (same-centre L2 ~0.56)

# the serve phase: an organisation-sized int8 gallery (65,536 x 1024-d, 64
# MiB), 8 people enrolled from 2 photos each through /enroll?mode=face,
# then 16 client threads x 12 requests mixing /analyze?identify=1 (640x480
# photos with 2-5 faces), /identify?mode=face (each person's third photo)
# and /embed (224² crops) on the int8 embedder (K4)
SERVE_GALLERY, SERVE_DIM = 1 << 16, 1024
SERVE_PEOPLE, SERVE_CLIENTS, SERVE_REQUESTS = 8, 16, 12
SERVE_ANALYZE_PHOTOS, SERVE_CROPS = 16, 16
SERVE_FACES = (2, 5)            # faces a served photo holds
SERVE_MAX_BATCH = 32            # the embed worker's (serve --max-batch)
SERVE_TIMEOUT_S = 120.0
# the zoo phase: each backbone's seeded params exported to a pb and
# imported back, then a batch of 64 embedded; graph_extractor on the
# exported MobileNet pb against mobilenet_embed
ZOO_MODELS = ("vgg2_mobilenet", "vgg2_mobilenet_int8", "vgg2_resnet")
ZOO_BATCH, ZOO_REPEATS = 64, 5
GRAPH_ATOL = 1e-4

PROFILE_TRIES = 3               # profiler sessions before a lost record counts
# the age/gender slice: the two-model halves' input sizes (age at 192², as
# tests/test_two_model_heads.py writes it, gender at the crops' 224²); the
# exported halves against the one-model analyzer on the same card
AGE_HW, GENDER_HW = 192, 224
TWO_MODEL_TOL = {"box_px": 0.0, "age": 1e-3, "gender": 1e-4}
TWO_MODEL_CPU_TOL = {"box_px": 1.0, "age": 1e-2, "gender": 1e-3}
# UTKFace-named .npy set: 88 aligned 200² faces (one batch of 64 and a
# tail) and 40 in-the-wild 240x180 (a tail); card against CPU on 16
UTK_N, UTK_BATCH, UTK_SUBSET = 128, 64, 16
UTK_SIZES = ((200, 200), (240, 180))
UTK_FIRST = 88
UTK_AGE_TOL, UTK_MALE_TOL = 1e-2, 1e-4   # years; P(male)
ADIENCE_EDGES = (3.0, 7.0, 13.5, 22.5, 35.0, 45.5, 56.5)
# At random init the SSR-Net merge sits on the tanh asymptote of its Δ
# (ages near 1e18) and the WRN-16-8 logits near 1e4, where float32 rounding
# decides the softmax; the seeded Δ and head kernels are scaled by TAME
TAME = 1e-3
NEW_ZOO = ("insightface_arcface", "vggface_vgg16")   # 512-d at 112², 4096-d at 224²
KNN_WIDE = [(16, 1 << 20, 4096), (8192, 1 << 20, 4096)]
WIDE_CHECK_STRIDE = 512         # 8192 probes: the twin checks 16 of them

# the age/gender trainer at the JAX bench's configuration (bench.py:464-526):
# MobileNet-V1 alpha 1.0, 224², batch 256, augmentation on, lr 1e-4 once
# unfrozen; a pair is one age step and one gender step on one batch
AG_BATCH, AG_SIZE, AG_WARMUP, AG_PAIRS, AG_LR = 256, 224, 2, 5, 1e-4
# card vs CPU: one age and one gender step at width 1.0, batch 8, 64²; in
# float64 the params within the CPU tests' step bound
# (tests/test_torch_train_age_gender.py)
AG_PARITY, AG_STEP_REL = (8, 64), 1e-4
# alignment at ArcFace's 112², card vs CPU within the CPU tests' bound (its
# elementwise float32 ops round alike on both, so they should agree bit for
# bit); faces/s at a batch of 256
ALIGN_SIZE, ALIGN_ATOL, ALIGN_BATCH = 112, 5e-2, 256
CASCADE_REPEATS = 3             # timed passes of the card's cascade
# the multi-device slice: MESH_SHARDS virtual shards on the one card
# (make_mesh(devices=["cuda"] * 4)), each sharded path beside its one-device
# run; the answers within the CPU tests' bounds (tests/test_torch_parallel*.py):
# gallery distances 1e-4, embeddings 1e-4 (the JAX mesh extractor's),
# analyzer boxes equal with ages and identity 1e-3, float32 losses 1e-4
# relative
MESH_SHARDS = 4
MESH_GALLERY_N, MESH_DIM = 1 << 20, 1024
MESH_QUERY, MESH_QUERIES, MESH_EVAL = 16, 8, 2048
MESH_EMBED = 1024
MESH_TRAIN_SHAPE = (2, 2)
MESH_STEPS, MESH_PAIRS = 3, 3
MESH_TOL = {"distance": 1e-4, "embed": 1e-4, "age": 1e-3, "identity": 1e-3, "loss": 1e-4}
# phase tiers: the precision tiers (numerics.py) against "highest", and bf16
# compute_dtype at "highest"; every f32 zoo entry at ZOO_BATCH; a face-ID
# training forward at TRAIN_BATCH x TRAIN_SIZE² (width 1.0, TRAIN_CLASSES)
TIERS = ("highest", "high", "default")
TIER_VARIANTS = (("highest", torch.float32), ("high", torch.float32),
                 ("default", torch.float32), ("bf16", torch.bfloat16))
TIER_REPEATS = 7
TIER_ZOO = ("agegender_identity", "vgg2_mobilenet", "vgg2_resnet", "insightface_arcface",
            "vggface_vgg16", "vggface_resnet50")
TIER_THREAD_ROUNDS = 20
# a TF32 conv or matmul of O(1) operands is off float64 by ~1e-4 relative,
# an IEEE one by ~1e-7: each TF32 tier must be this many times further off
TIER_TF32_FACTOR = 10.0

T_START = time.perf_counter()


def phase_done(name: str) -> None:
    """Print the run's elapsed host time at the end of a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {name} done")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def crop_boxes(rng, k: int):
    """Seeded [y1, x1, y2, x2] boxes, some partly and two fully off the image."""
    y1 = rng.uniform(-60, H - 10, k)
    x1 = rng.uniform(-60, W - 10, k)
    size = rng.uniform(6, 300, k)
    boxes = np.stack([y1, x1, y1 + size, x1 + size], 1).astype(np.float32)
    boxes[0] = [-80, -80, -20, -20]
    boxes[1] = [H + 10, W + 10, H + 60, W + 60]
    return boxes


def grid_sample_crop(images, boxes, out: int, padding: str = "border"):
    """One ``F.grid_sample`` call sampling K1's grid of ``out`` x ``out``
    points per box, bilinear: images (B, H, W, C), boxes (B, K, 4), box k
    of image b sampling image b. Each box's grid is an affine map of the
    output grid (output i samples y1 + (i + 0.5)·(y2 - y1)/out - 0.5, as
    K1), and the K grids of an image stack along the output rows, so the
    call reads each image once. At the head site (s = 1, clamp: border
    padding) it is K1's function; at the supersampled sites (zero: zeros
    padding) it samples the s·out grid and leaves out the s² average. The
    library yardstick for K1. Returns the call and its output as (B, K,
    out, out, C)."""
    b, h, w, c = images.shape
    k = boxes.shape[1]
    y1, x1, y2, x2 = boxes.reshape(b * k, 4).unbind(1)
    sy, sx = (y2 - y1) / out, (x2 - x1) / out
    theta = torch.zeros((b * k, 2, 3), device=images.device)
    theta[:, 0, 0] = sx * (out - 1) / (w - 1)
    theta[:, 0, 2] = 2 * (x1 - 0.5 + sx * out / 2) / (w - 1) - 1
    theta[:, 1, 1] = sy * (out - 1) / (h - 1)
    theta[:, 1, 2] = 2 * (y1 - 0.5 + sy * out / 2) / (h - 1) - 1
    grid = F.affine_grid(theta, (b * k, c, out, out), align_corners=True)
    grid = grid.reshape(b, k * out, out, 2)
    x = images.permute(0, 3, 1, 2).contiguous()

    def call():
        return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding,
                             align_corners=True)
    return call, call().reshape(b, c, k, out, out).permute(0, 2, 3, 4, 1)


def k1_device_ms(call, calls: int = 20) -> float:
    """K1's device time a call by ``torch.profiler``, which must see exactly
    one K1 kernel a call."""
    rows, _ = profile_calls(call, calls, "crop_resize")
    k1 = [(n, ms) for key, n, ms, on_device in rows if on_device and "crop_resize" in key]
    launched = sum(n for n, _ in k1)
    if launched != calls:
        raise AssertionError(f"K1: the profiler saw {launched} K1 kernels in "
                             f"{calls} calls ({k1})")
    return sum(ms for _, ms in k1) / calls


def touched_bytes(images, boxes, out: int, s: int, outside: str, lanes=None) -> int:
    """The bytes of image pixels the crops depend on: those K1's taps read
    with a nonzero weight. A box touches the grid of its touched rows and
    columns (where the plain version's weight matrices are nonzero); the
    boxes of one image share pixels, and an image no box reads costs
    nothing."""
    imgs = images if images.dim() == 4 else images[None]
    n_img, h, w, c = imgs.shape
    flat = boxes.reshape(-1, 4)
    lane = lanes.long() if lanes is not None else torch.arange(
        n_img, device=flat.device).repeat_interleave(flat.shape[0] // n_img)
    rows, cols = _crop_weights(flat, h, w, out, s, outside)
    rows, cols = (rows > 0).any(1).float(), (cols > 0).any(1).float()
    touched = sum(int(((rows[lane == i].T @ cols[lane == i]) > 0).sum())
                  for i in range(n_img))
    return touched * c * imgs.element_size()


def check_crop_site(name, images, boxes, out: int, s: int, outside: str,
                    lanes=None):
    """K1 at one site against its plain version: images (H, W, C) with
    boxes (K, 4), or (L, H, W, C) with boxes (L, K, 4), or with ``lanes``.
    Times a call (CUDA events over wrapper calls), its device time
    (``torch.profiler``), the host µs a call (the difference), the plain
    version, the bound (``touched_bytes`` read once, the output written
    once; beside it the bound with every image read whole) and
    ``grid_sample_crop``; at a lane site the library call samples the
    pre-gathered ``images[lanes]``, the gather outside the timed call."""
    call = lambda: crop_resize(images, boxes, out, s, outside, lanes=lanes)
    if lanes is not None:
        plain = lambda: crop_resize_bilinear_lanes(images, lanes, boxes, out, s, outside)
    elif images.dim() == 4:
        plain = lambda: crop_resize_bilinear_batch(images, boxes, out, s, outside)
    else:
        plain = lambda: crop_resize_bilinear(images, boxes, out, s, outside)
    got, want = call(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = cuda_ms(call, 200)
    device_ms = k1_device_ms(call)
    plain_ms = cuda_ms(plain, 10)
    small = (boxes,) + (() if lanes is None else (lanes,))
    # at most (2s)² taps per output value, a multiply-add each
    ops = 2.0 * got.numel() * (2 * s) ** 2
    b_ms, b_by = bound(touched_bytes(images, boxes, out, s, outside, lanes)
                       + nbytes(*small, got), ops, "f32")
    whole_ms, _ = bound(nbytes(images, *small, got), ops, "f32")
    padding = "border" if outside == "clamp" else "zeros"
    if lanes is not None:
        lib_images, lib_boxes, lib_note = images[lanes.long()], boxes[:, None], \
            "on the pre-gathered images[lanes]"
    elif images.dim() == 4:
        lib_images, lib_boxes, lib_note = images, boxes, "one call for the batch"
    else:
        lib_images, lib_boxes, lib_note = images[None], boxes[None], "one call"
    lib_call, lib_out = grid_sample_crop(lib_images, lib_boxes, s * out, padding)
    lib_ms = cuda_ms(lib_call, 200)
    # the s x s average grid_sample leaves out, for the printed difference
    lib_out = lib_out.reshape(-1, s * out, s * out, got.shape[-1]).permute(0, 3, 1, 2)
    lib_out = F.avg_pool2d(lib_out, s).permute(0, 2, 3, 1).reshape(got.shape)
    n_boxes = got.numel() // (out * out * got.shape[-1])
    print(f"crop_resize {name}: {n_boxes} boxes out={out} s={s} outside={outside} "
          f"max_abs_err={err:.3g} call_ms={ms:.4f} device_ms={device_ms:.4f} "
          f"host_us={(ms - device_ms) * 1e3:.1f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}; {whole_ms:.5f} with every image read "
          f"whole) grid_sample_ms={lib_ms:.4f} ({padding}, "
          f"{s * out}² grid, {lib_note}; mean |diff| after the s² average "
          f"{float((lib_out - got).abs().mean()):.3g})")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"crop_resize {name}: max abs err {err} > {KERNEL_ATOL}")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "host_us": (ms - device_ms) * 1e3, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_whole_images_ms": whole_ms,
            "library_ms": lib_ms}


def check_crop_kernel(rng):
    """K1 at the analyze path's three single-image sites, then at the three
    sites of a batch of ``BATCH`` images (stage 2/3 with (L, K, 4) boxes,
    the head crops with a lane index) and the ragged lane cases. Returns
    {site: ``check_crop_site``'s numbers}."""
    images = torch.from_numpy((rng.rand(BATCH, H, W, 3) * 255).astype(np.float32)).cuda()
    results = {}
    for name, k, out, s, outside in CROP_SHAPES:
        boxes = torch.from_numpy(crop_boxes(rng, k)).cuda()
        results[name] = check_crop_site(name, images[0], boxes, out, s, outside)
    for name, k, out, s, outside in CROP_SHAPES:
        if name == "head":
            boxes = torch.from_numpy(crop_boxes(rng, BATCH_HEAD_SLOTS)).cuda()
            lanes = torch.arange(BATCH, dtype=torch.int32, device="cuda").repeat_interleave(
                BATCH_HEAD_SLOTS // BATCH)
            results[f"{name} x{BATCH}"] = check_crop_site(
                f"{name} x{BATCH} (lanes)", images, boxes, out, s, outside, lanes)
        else:
            boxes = torch.from_numpy(np.stack([crop_boxes(rng, k) for _ in range(BATCH)])).cuda()
            results[f"{name} x{BATCH}"] = check_crop_site(
                f"{name} x{BATCH}", images, boxes, out, s, outside)
    for name, lanes in CROP_LANE_CASES:
        lanes = torch.tensor(lanes, dtype=torch.int32, device="cuda")
        boxes = torch.from_numpy(crop_boxes(rng, len(lanes))).cuda()
        results[name] = check_crop_site(name, images, boxes, 224, 1, "clamp", lanes)
    return results

def apart(call: str, what: str, parity: bool = True):
    """``call`` (a Python expression over ``cs``, this module) in a child
    process, the child's lines printed here, its last line's JSON
    returned. Profiler sessions late in one process lose kernel records
    (K3's one-call check after the K1 checks saw no kernel; K4's layers at
    batch 1024 after the album kept 4 or 5 of 10, and one layer none; H100
    runs), where the same sessions in a fresh process keep them. With
    ``parity`` the child calls ``set_parity_numerics`` first; without, it
    starts from torch's own flags."""
    code = ("import json, numpy as np, torch, chip_smoke as cs\n"
            + ("cs.set_parity_numerics()\n" if parity else "")
            + f"print(json.dumps({call}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)), timeout=900)
    lines = out.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    if out.returncode != 0:
        raise AssertionError(f"{what} failed ({out.returncode}): "
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(lines[-1])


def check_crop_kernel_apart():
    """``check_crop_kernel`` in a child process (``apart``): its nine
    profiler sessions, run in this process, made later sessions lose
    kernel records."""
    return apart("cs.check_crop_kernel(np.random.RandomState(cs.SEED))", "K1 checks")


def check_pw_kernel_apart(seed: int, batch: int, iters: int, plain_iters: int,
                          size: int = 224, tiles: bool = False):
    """``check_pw_kernel`` (no ragged shape) in a child process (``apart``),
    on operands from a generator seeded with ``seed``: its profiler
    sessions come after many others in this process."""
    return apart(f"cs.check_pw_kernel(torch.Generator(device='cuda').manual_seed({seed}), "
                 f"{batch}, False, {iters}, {plain_iters}, size={size}, tiles={tiles})",
                 f"K4 check at batch {batch}, {size}²")


def pw_operands(gen, m: int, k: int, n: int):
    """Seeded K4 operands made on the card: activations in [0, 127],
    weights in [-127, 127], per-channel scales that spread the outputs
    over [0, 6] (|acc| spreads about 2700·sqrt(k))."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    scale = (torch.rand(n, generator=gen, device="cuda") + 0.5) * (
        3.0 / (2700.0 * float(np.sqrt(k))))
    bias = torch.rand(n, generator=gen, device="cuda") * 4.0 - 1.0
    return ints(0, 128, (m, k)), ints(-127, 128, (n, k)), scale, bias


def int_mm_call(a, w):
    """``torch._int_mm(a, w.t())``: K4's GEMM alone (int8 x int8 -> int32,
    cuBLASLt, no epilogue), the library yardstick, which the port never
    calls. Returns (the call, None), or (None, the refusal's first line)."""
    b = w.t()
    try:
        torch._int_mm(a, b)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, (str(e).strip().splitlines() or ["?"])[0][:160]
    return (lambda: torch._int_mm(a, b)), None


def check_pw_kernel(gen, batch: int, ragged: bool, iters: int, plain_iters: int,
                    size: int = 224, tiles: bool = False):
    """K4 against its plain version at the 13 pointwise layers of ``batch``
    faces at ``size``² (224², or 192² for ``vgg2_mobilenet_int8``: feature
    maps 96²…6²) (and the ragged shape): int8 and f32 out both bit-equal
    (the count of differing elements is printed and must be 0). Per layer,
    at its own output type: the tile ``pw_conv.plan`` gives; by CUDA events
    the kernel's ms, its bound, the GB/s and T int8 ops/s it reaches and
    its share of the bound, the plain version's ms and ``torch._int_mm``'s
    (or "refused"); the kernel's device time by the profiler too (at batch
    16 the CUDA events time the wrapper's host work, so the host µs a call
    is printed beside them); with ``tiles``, the ms of every tile the
    layer may take too (``pw_conv.TILES``, each bit-equal). Returns the
    sums over the 13 layers, each layer's numbers and the f32 out's max abs
    err."""
    worst, ms_sum, dev_sum, plain_sum, lib_sum, refused = 0.0, 0.0, 0.0, 0.0, 0.0, []
    host_sum, layers = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for name, pixels, k, n in PW_LAYERS + ([PW_RAGGED] if ragged else []):
        if name != PW_RAGGED[0]:
            pixels = (int(np.sqrt(pixels)) * size // 224) ** 2
        m = pixels * (batch if name != PW_RAGGED[0] else 1)
        ops = pw_operands(gen, m, k, n)
        diffs = {}
        for requant in (True, False):
            got = pw_conv.pw_conv_int8(*ops, requant=requant)
            want = pw_conv.pw_conv_int8_plain(*ops, requant=requant)
            torch.cuda.synchronize()
            diffs["int8" if requant else "f32"] = int((got != want).sum())
            if not requant:
                worst = max(worst, float((got - want).abs().max()))
            del got, want
        requant = name != PW_LAYERS[-1][0]        # pw13 keeps f32 out
        ms = cuda_ms(lambda: pw_conv.pw_conv_int8(*ops, requant=requant), iters)
        plain_ms = cuda_ms(lambda: pw_conv.pw_conv_int8_plain(*ops, requant=requant),
                           plain_iters, warmup=1)
        rows, _ = profile_calls(lambda: pw_conv.pw_conv_int8(*ops, requant=requant), 10,
                                "pw_conv_int8")
        k4 = [(n, t) for key, n, t, on_device in rows if on_device and "pw_conv_int8" in key]
        records = sum(n for n, _ in k4)
        if not records:
            raise AssertionError(f"pw_conv_int8 {name}: no K4 kernel record in "
                                 f"{PROFILE_TRIES} profiler sessions")
        # the mean kernel record, one a call: a session may keep fewer than 10
        dev_ms = sum(t for _, t in k4) / records
        lib_call, why = int_mm_call(ops[0], ops[1])
        lib_ms = cuda_ms(lib_call, iters) if lib_call else None
        moved = nbytes(*ops) + m * n * (1 if requant else 4)
        b_ms, b_by = bound(moved, 2.0 * m * k * n, "int8")
        plan = pw_conv.plan(m, n, -(-k // pw_conv.ROW_WORD) * pw_conv.ROW_WORD, sms)
        tiles_ms = {}
        if tiles:
            want = pw_conv.pw_conv_int8_plain(*ops, requant=requant)
            for tile in pw_conv.TILES:
                if tile[1] > n * plan.pack and tile[1] != 64:
                    continue
                got = pw_conv.launch(*ops, requant=requant, tile=tile)
                diffs["tiles"] = diffs.get("tiles", 0) + int((got != want).sum())
                tiles_ms[f"{tile[0]}x{tile[1]}"] = cuda_ms(
                    lambda: pw_conv.launch(*ops, requant=requant, tile=tile), iters)
            del got, want
        # host µs a call: the wrapper's enqueue time over back-to-back calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            pw_conv.pw_conv_int8(*ops, requant=requant)
        host_us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        t_ops = 2.0 * m * k * n / dev_ms / 1e9
        print(f"pw_conv_int8 {name}: M={m} K={k} N={n} route wgmma tile "
              f"{plan.bm}x{plan.bn} grid {plan.grid}"
              + (f" ({plan.pack} pixels a row)" if plan.pack > 1 else "")
              + f" differing int8 {diffs['int8']} f32 "
              f"{diffs['f32']}"
              + (f" (tiles {diffs['tiles']})" if "tiles" in diffs else "")
              + f"; {'int8' if requant else 'f32'} out kernel_ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} ({records} of 10 records) host_us={host_us:.1f} "
              + f"bound_ms={b_ms:.4f} ({b_by}) {b_ms / dev_ms:.3f} of the bound "
              f"{moved / dev_ms / 1e6:.1f} GB/s {t_ops:.2f} T "
              f"int8 ops/s plain_ms={plain_ms:.4f} "
              + (f"int_mm_ms={lib_ms:.4f}" if lib_call else f"int_mm refused ({why})")
              + (" tiles_ms=" + json.dumps({k: round(v, 4) for k, v in tiles_ms.items()})
                 if tiles_ms else ""))
        layers[name] = {"route": "wgmma", "tile": [plan.bm, plan.bn], "grid": plan.grid,
                        "pack": plan.pack,
                        "ms": ms, "device_ms": dev_ms, "host_us": host_us, "t_ops": t_ops,
                        "share_of_bound": b_ms / dev_ms, "bound_ms": b_ms,
                        "library_ms": lib_ms, **({"tiles_ms": tiles_ms} if tiles_ms else {})}
        if any(diffs.values()):
            raise AssertionError(f"pw_conv_int8 {name}: not bit-equal to the "
                                 f"plain version ({diffs})")
        if name != PW_RAGGED[0]:
            ms_sum += ms
            dev_sum += dev_ms
            host_sum += host_us
            plain_sum += plain_ms
            bound_by[b_by] += b_ms
            if lib_call:
                lib_sum += lib_ms
            else:
                refused.append(name)
        del ops, lib_call
    bound_sum = sum(bound_by.values())
    print(f"pw_conv_int8 at batch {batch}, {size}²: 13 layers {ms_sum:.4f} ms "
          f"(device {dev_sum:.4f} ms by the profiler, {bound_sum / dev_sum:.3f} of the bound; "
          f"host {host_sum:.1f} µs), plain "
          f"{plain_sum:.4f} ms, bound {bound_sum:.4f} ms (layers bound by bytes "
          f"{bound_by['bytes']:.4f} ms, by operations {bound_by['operations']:.4f} ms), "
          f"torch._int_mm {lib_sum:.4f} ms over {13 - len(refused)} layers"
          + (f" (refused: {refused})" if refused else ""))
    return {"max_abs_err": worst, "ms": ms_sum, "device_ms": dev_sum, "host_us": host_sum,
            "plain_ms": plain_sum,
            "bound_ms": bound_sum, "bound_by": max(bound_by, key=bound_by.get),
            "library_ms": lib_sum if len(refused) < 13 else None, "layers": layers}


def tensor_map_encode_us(calls: int = 2000) -> dict:
    """Host µs of K4's TMA tensor maps: one ``cuTensorMapEncodeTiled`` through
    ``pw_conv_weight_map`` (the encode the launch makes for the activation
    every call; ctypes' call included) and one cached weight map
    (``pw_conv._weight_map``'s lookup), each over ``calls`` calls."""
    lib = pw_conv._kernels()[0]
    w = torch.zeros((1024, 1024), dtype=torch.int8, device="cuda")
    buf = ctypes.create_string_buffer(128)
    t0 = time.perf_counter()
    for _ in range(calls):
        lib.pw_conv_weight_map(w.data_ptr(), 1024, 1024, 128, buf)
    encode = (time.perf_counter() - t0) / calls * 1e6
    pw_conv._weight_map(w.data_ptr(), 1024, 1024, 128)
    t0 = time.perf_counter()
    for _ in range(calls):
        pw_conv._weight_map(w.data_ptr(), 1024, 1024, 128)
    cached = (time.perf_counter() - t0) / calls * 1e6
    print(f"K4 tensor maps: an encode {encode:.2f} µs (ctypes included), a cached "
          f"weight map {cached:.2f} µs, host clock over {calls} calls")
    return {"encode_us": encode, "cached_us": cached}


def sass_counts():
    """Per ``SASS_KERNELS`` entry: the number of functions whose name holds
    its marker in the built library's SASS (``cuobjdump -sass``), and their
    IMMA, IGMMA, HMMA and HGMMA (tensor-core) and IDP.4A (``__dp4a``)
    instructions."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    ops = SASS_OPS
    counts = {mark: dict.fromkeys(("functions",) + ops, 0) for mark, *_ in SASS_KERNELS}
    fn = ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1]
            for mark in counts:
                counts[mark]["functions"] += mark in fn
            continue
        for mark, c in counts.items():
            if mark in fn:
                for op in ops:
                    c[op] += bool(re.search(r"\b" + op.replace(".", r"\.?") + r"\b", line))
    return counts


def check_sass():
    """K4 and the 1-NN sweeps run on the tensor cores: fail unless each has
    functions, its MMAs (IGMMA for int8, HMMA and HGMMA for bf16) > 0, the
    int8 kernels no IMMA (mma.sync) and, but in the int8 sweep's norms,
    IDP.4A == 0 in its SASS."""
    counts = sass_counts()
    for mark, kid, mmas, dp4a_ok in SASS_KERNELS:
        c = counts[mark]
        print(f"{kid} SASS: {c['functions']} {mark} functions, "
              + ", ".join(f"{c[k]} {k}" for k in SASS_OPS))
        if (c["functions"] == 0 or not all(c[op] for op in mmas) or (c["IDP.4A"] and not dp4a_ok)
                or ("IGMMA" in mmas and c["IMMA"])):
            raise AssertionError(f"{kid} is not on the tensor cores: {json.dumps(c)}")


def unit_rows(gen, n: int, d: int):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def same(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def int8_twin_rows(p, qb, sb, sub, pack: bool):
    """The int8 twin's answers for the probes ``sub`` of ``p``, on the
    operands of a call over all of ``p`` (its probe scale comes from every
    probe), so they equal those rows of the kernels' answers bit for bit."""
    ops = knn._int8_operands(p, knn._sumsq(qb), sb, None, pack)
    part = ops._replace(qa=ops.qa[sub], a2raw=ops.a2raw[sub])
    emin, idx = knn._rank_int8_plain(part.qa, qb, part.b2v, pack)
    return knn._int8_distances(part, emin, pack), idx


def check_int8_bit_equal(label, p, qb, sb, packed, sub=None, results=None) -> None:
    """K2b (``nearest_neighbor_int8q``) and K2c (``nearest_neighbor_int8p``
    on ``packed``) in both epilogues (``pack_idx``) bit-equal to the int8
    twin: on every probe (``nearest_neighbor_int8_plain``) or, with ``sub``,
    on those probes of the call over all of ``p`` (``int8_twin_rows``).
    Raises naming the kernel, ``label`` and the epilogue. With ``results``,
    keeps each kernel's largest distance error in
    ``results[kname]["max_abs_err"]``."""
    for pack in (False, True):
        want = (knn.nearest_neighbor_int8_plain(p, qb, sb, pack_idx=pack) if sub is None
                else int8_twin_rows(p, qb, sb, sub, pack))
        for kname, got in (
                ("knn_int8q", knn.nearest_neighbor_int8q(p, qb, sb, pack_idx=pack)),
                ("knn_int8p", knn.nearest_neighbor_int8p(p, *packed, pack_idx=pack))):
            if sub is not None:
                got = (got[0][sub], got[1][sub])
            if not same(got, want):
                bad = int((got[1] != want[1]).sum())
                raise AssertionError(f"{kname} {label} pack_idx={pack}: {bad} indices "
                                     "differ or distances not bit-equal to the twin")
            if results is not None:
                results[kname]["max_abs_err"] = max(
                    results[kname]["max_abs_err"], float((got[0] - want[0]).abs().max()))


def int8q_norms(in_sweep: bool):
    """K2b a call with its gallery norms formed in the sweep or taken from
    one host pass (``_sumsq``): to time that choice."""
    def call(p, qb, sb):
        q = knn._pad_dim(qb)
        ops = knn._int8_operands(p, None if in_sweep else knn._sumsq(q), sb, None, False)
        emin, idx = knn._rank_int8_cuda(ops.qa, q, ops.b2v, False, c=ops.c,
                                        valid_n=q.shape[0])
        return knn._int8_distances(ops, emin, False), idx
    return call


def time_norms_choice(label, p, qb, sb, iters: int):
    """Print K2b's time a call with its norms in the sweep and from one host
    pass, in turns (each order, then reversed). The public call's choice:
    in the sweep."""
    t = {}
    for in_sweep in (True, False, False, True):
        fn = int8q_norms(in_sweep)
        key = "in the sweep" if in_sweep else "host pass"
        t.setdefault(key, []).append(round(cuda_ms(lambda: fn(p, qb, sb), iters, 1), 4))
    print(f"K2b norms at {label} ({p.shape[0]} probes), ms a call: " + json.dumps(t))


def check_knn_shape(gen, name, m, n, d, results):
    """K2b/K2c bit-equal to the int8 twin in both epilogues; K2a (f32 and
    bf16) within tolerance, and index-equal where the twin's top two
    candidates are further apart than the tolerance. Timed: K2b/K2c and
    exact-f32 K2a."""
    g = unit_rows(gen, n, d)
    g[n // 2:n // 2 + 3] = g[1:4]            # exact ties with lower rows
    p = unit_rows(gen, m, d)
    qb, sb = knn.quantize_embeddings(g)
    packed = knn.pack_quantized_gallery(qb, sb)
    check_int8_bit_equal(name, p, qb, sb, packed, results=results)
    times = {
        "knn_int8q": cuda_ms(lambda: knn.nearest_neighbor_int8q(p, qb, sb), 20),
        "knn_int8q_plain": cuda_ms(lambda: knn.nearest_neighbor_int8_plain(
            p, qb, sb), 5),
        "knn_int8p": cuda_ms(lambda: knn.nearest_neighbor_int8p(p, *packed), 20),
    }
    times["knn_int8p_plain"] = times["knn_int8q_plain"]
    for bf16 in (False, True):
        gd, gi = knn.nearest_neighbor_f32(p, g, bf16=bf16)
        wd, wi = knn.nearest_neighbor_plain(p, g, bf16=bf16)
        torch.cuda.synchronize()
        err = float((gd - wd).abs().max())
        if not torch.allclose(gd, wd, rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
            raise AssertionError(f"knn_f32 {name} bf16={bf16}: max abs err {err}")
        a = p.to(torch.bfloat16).float() if bf16 else p
        b = g.to(torch.bfloat16).float() if bf16 else g
        d2 = (p * p).sum(1)[:, None] + (g * g).sum(1)[None, :] - 2.0 * (a @ b.T)
        top2 = torch.topk(d2, 2, dim=1, largest=False).values
        clear = (top2[:, 1] - top2[:, 0]) > KNN_F32_ATOL + KNN_F32_RTOL * top2[:, 0].abs()
        if not torch.equal(gi[clear], wi[clear]):
            raise AssertionError(f"knn_f32 {name} bf16={bf16}: index differs "
                                 "where the top two are clearly apart")
        results["knn_f32"]["max_abs_err"] = max(results["knn_f32"]["max_abs_err"], err)
    times["knn_f32"] = cuda_ms(lambda: knn.nearest_neighbor_f32(p, g, bf16=False), 20)
    times["knn_f32_plain"] = cuda_ms(
        lambda: knn.nearest_neighbor_plain(p, g, bf16=False), 5)
    print(f"knn {name}: M={m} N={n} D={d}: int8 bit-equal (both epilogues), "
          f"f32 within tolerance; ms " + json.dumps(
              {k: round(v, 4) for k, v in times.items()}))
    if name == KNN_REPORT:
        out_bytes = m * 8                      # f32 distance and int32 index
        ops = 2.0 * m * n * d
        qa = knn.quantize_embeddings(p, reciprocal=True)[0]
        int_mm, why = int_mm_call(
            F.pad(qa, (0, 0, 0, max(0, INT_MM_MIN_ROWS - m))), qb)
        lib = {"knn_int8": cuda_ms(int_mm, 20) if int_mm else None,
               "mm_f32": cuda_ms(lambda: torch.mm(p, g.T), 20)}
        bounds = {"knn_f32": bound(nbytes(p, g) + out_bytes, ops, "f32"),
                  "knn_int8q": bound(nbytes(p, qb, sb) + out_bytes, ops, "int8"),
                  "knn_int8p": bound(nbytes(p, *[t for t in packed
                                                 if isinstance(t, torch.Tensor)])
                                     + out_bytes, ops, "int8")}
        print(f"knn {name} bounds (ms): " + json.dumps(
            {k: [round(v[0], 4), v[1]] for k, v in bounds.items()})
            + f"; library ms: torch._int_mm on the probes padded to "
            f"{max(m, INT_MM_MIN_ROWS)} rows "
            + (f"{lib['knn_int8']:.4f}" if int_mm else f"refused ({why})")
            + f", torch.mm f32 {lib['mm_f32']:.4f}")
        # a serving call's device time apart from its host work (CUDA events
        # time back-to-back calls, which the wrapper's host work can bound)
        dev_ms = {"knn_int8q": knn_device_ms(lambda: knn.nearest_neighbor_int8q(p, qb, sb)),
                  "knn_int8p": knn_device_ms(lambda: knn.nearest_neighbor_int8p(p, *packed))}
        print(f"knn {name} device ms (profiler, the 1-NN kernels alone): "
              + json.dumps({k: round(v, 4) for k, v in dev_ms.items()}))
        time_norms_choice(name, p, qb, sb, 20)
        # the serving query's sweep on the resident and the streamed probe tile
        sweeps = time_int8_sweeps(p, packed, sb, [0, 1], 20)
        for kname in ("knn_int8q", "knn_int8p"):
            results[kname].update(ms=times[kname], device_ms=dev_ms[kname],
                                  plain_ms=times[kname + "_plain"],
                                  bound_ms=bounds[kname][0], bound_by=bounds[kname][1],
                                  library_ms=lib["knn_int8"], sweeps_ms=sweeps,
                                  shape=f"M={m} N={n} D={d}")
        results["knn_f32"][name] = {
            "ms": times["knn_f32"], "plain_ms": times["knn_f32_plain"],
            "bound_ms": bounds["knn_f32"][0], "bound_by": bounds["knn_f32"][1],
            "library_ms": lib["mm_f32"]}


def knn_device_ms(fn, calls: int = 10) -> float:
    """Device ms a call of the 1-NN kernels (the sweep and the reduce) in
    ``fn``, by ``torch.profiler`` over ``calls`` calls."""
    rows, _ = profile_calls(fn, calls, "knn_")
    return sum(t for key, _, t, on_device in rows if on_device and "knn_" in key) / calls


def check_knn_routed(gen, results):
    """K2a at its routed shape (``KNN_ROUTED``, exact f32, as identify at
    scale runs it) against the chunked f32 twin: distances within
    tolerance, and where the two pick different rows, the kernel's row ties
    the twin's minimum within it; index agreement at least 0.99. Timed
    beside the twin and ``torch.mm`` (f32, TF32 off: the product alone, an
    8 GiB matrix)."""
    m, n, d = KNN_ROUTED
    g = unit_rows(gen, n, d)
    p = unit_rows(gen, m, d)
    gd, gi = knn.nearest_neighbor_f32(p, g, bf16=False)
    wd, wi = knn.nearest_neighbor_chunked(p, g, chunk=256, bf16=False)
    if not torch.allclose(gd, wd, rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("knn_f32 routed shape: distances off the twin")
    diff = gi != wi
    alt = ((p[diff] - g[gi[diff]]) ** 2).sum(1)
    if not torch.allclose(alt, wd[diff], rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("knn_f32 routed shape: a row that does not tie "
                             "the twin's minimum")
    agree = 1.0 - float(diff.float().mean())
    if agree < 0.99:
        raise AssertionError(f"knn_f32 routed shape: index agreement {agree}")
    err = float((gd - wd).abs().max())
    ms = cuda_ms(lambda: knn.nearest_neighbor_f32(p, g, bf16=False), 3, 1)
    plain_ms = cuda_ms(lambda: knn.nearest_neighbor_chunked(p, g, 256, False), 1, 0)
    lib_ms = cuda_ms(lambda: torch.mm(p, g.T), 3, 1)
    b_ms, b_by = bound(nbytes(p, g) + m * 8, 2.0 * m * n * d, "f32")
    print(f"knn_f32 routed shape M={m} N={n} D={d} f32: index agreement {agree}, "
          f"max abs err {err:.3g}; kernel {ms:.3f} ms "
          f"({2.0 * m * n * d / ms / 1e9:.1f} T f32 FLOP/s), bound {b_ms:.3f} ms "
          f"({b_by}), torch.mm {lib_ms:.3f} ms, chunked twin {plain_ms:.3f} ms")
    results["knn_f32"]["max_abs_err"] = max(results["knn_f32"]["max_abs_err"], err)
    results["knn_f32"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, shape=f"M={m} N={n} D={d} f32 (routed)")


def bf16_wrapper_passes(p, g) -> dict:
    """K2a's bf16 call apart: the wrapper's own device passes (as
    ``nearest_neighbor_f32`` runs them: the f32 copies, the ``a*a`` /
    ``b*b`` norms, the bf16 casts; its 8-value pad is none at D 512) and
    the sweep alone on their results, each timed by CUDA events."""
    m, d = p.shape
    n = g.shape[0]
    a2, b2 = torch.sum(p * p, dim=1), torch.sum(g * g, dim=1)
    a16, b16 = p.to(torch.bfloat16), g.to(torch.bfloat16)
    lib, _, _, fn = knn._kernels()
    cfg = knn.sweep_config(m, n, knn._sms(p.device), knn.bf16_tile(m), knn.BF16_PER_SM)
    args = (a16.data_ptr(), b16.data_ptr(), a2.data_ptr(), b2.data_ptr(), m, n, d)
    return {
        "f32 copies": cuda_ms(lambda: (p.to(torch.float32).contiguous(),
                                       g.to(torch.float32).contiguous()), 5, 1),
        "a*a norms": cuda_ms(lambda: torch.sum(p * p, dim=1), 5, 1),
        "b*b norms": cuda_ms(lambda: torch.sum(g * g, dim=1), 5, 1),
        "bf16 casts": cuda_ms(lambda: (p.to(torch.bfloat16), g.to(torch.bfloat16)), 5, 1),
        "sweep alone": cuda_ms(lambda: knn._launch("knn_bf16", fn, lib, m, cfg, p.device,
                                                   args), 5, 1)}


def check_knn_bench_bf16(gen, results):
    """K2a on bf16 operands at the benchmark's shape (``KNN_BENCH_BF16``)
    against the chunked twin on the same operands: distances within
    tolerance, and where the two pick different rows, the kernel's row
    ties the twin's minimum in the twin's own math; index agreement at
    least 0.99. Timed beside the twin and ``torch.mm`` on the bf16
    operands (the product alone, a 16 GiB bf16 matrix), with the wrapper's
    own passes apart (``bf16_wrapper_passes``)."""
    m, n, d = KNN_BENCH_BF16
    g = unit_rows(gen, n, d)
    p = unit_rows(gen, m, d)
    gd, gi = knn.nearest_neighbor_f32(p, g, bf16=True)
    wd, wi = knn.nearest_neighbor_chunked(p, g, chunk=512, bf16=True)
    if not torch.allclose(gd, wd, rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("knn_f32 bf16 at the bench's shape: distances off the twin")
    diff = gi != wi
    pb, gb = p[diff].bfloat16().float(), g[gi[diff]].bfloat16().float()
    alt = torch.clamp((p[diff] ** 2).sum(1) + (g[gi[diff]] ** 2).sum(1)
                      - 2.0 * (pb * gb).sum(1), min=0.0)
    if not torch.allclose(alt, wd[diff], rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("knn_f32 bf16 at the bench's shape: a row that does not "
                             "tie the twin's minimum")
    agree = 1.0 - float(diff.float().mean())
    if agree < 0.99:
        raise AssertionError(f"knn_f32 bf16 at the bench's shape: index agreement {agree}")
    err = float((gd - wd).abs().max())
    ms = cuda_ms(lambda: knn.nearest_neighbor_f32(p, g, bf16=True), 3, 1)
    plain_ms = cuda_ms(lambda: knn.nearest_neighbor_chunked(p, g, 512, True), 1, 0)
    passes = bf16_wrapper_passes(p, g)
    p16, g16 = p.bfloat16(), g.bfloat16()
    lib_ms = cuda_ms(lambda: torch.mm(p16, g16.T), 3, 1)
    ops = 2.0 * m * n * d
    b_ms, b_by = bound(nbytes(p, g) + m * 8, ops, "bf16")
    tile = knn.bf16_tile(m)
    print(f"knn_f32 at the bench's shape M={m} N={n} D={d} bf16: probe tile {tile} "
          f"(streamed); index agreement {agree}, max abs err {err:.3g}; kernel "
          f"{ms:.3f} ms a call ({ops / ms / 1e9:.1f} T FLOP/s, {b_ms / ms:.3f} of the bound), "
          f"bound {b_ms:.3f} ms ({b_by}), torch.mm bf16 {lib_ms:.3f} ms "
          f"({ms / lib_ms:.2f}x), chunked twin {plain_ms:.3f} ms; the call apart (ms): "
          + json.dumps({k: round(v, 4) for k, v in passes.items()}))
    results["knn_f32"]["max_abs_err"] = max(results["knn_f32"]["max_abs_err"], err)
    results["knn_f32"]["bench_bf16"] = {
        "tile": tile, "ms": ms, "t_ops": ops / ms / 1e9, "share_of_bound": b_ms / ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "passes_ms": passes, "shape": f"M={m} N={n} D={d} bf16"}


def time_int8_sweeps(p, packed, sb, tiles, iters: int) -> dict:
    """The int8 sweep alone (K2c's operands, the two-pass epilogue) on each
    probe tile of ``tiles`` (-1 the rule's, 0 resident, 1 streamed), in
    turns (each order, then reversed), every answer equal to the first; ms
    a call by CUDA events, keyed by tile."""
    ops = knn._int8_operands(p, packed.b2i, sb, None, False)
    m, dp = p.shape[0], packed.q.shape[1]
    t, first = {}, None
    for stream in tiles + tiles[::-1]:
        tile = knn.int8_tile(m, dp, p.device.index, stream)
        key = f"{tile.tm} {'streamed' if tile.streamed else 'resident'}"
        fn = lambda: knn._rank_int8_cuda(ops.qa, packed.q, ops.b2v, False, stream=stream)
        got = fn()
        first = first or got
        if not same(got, first):
            raise AssertionError(f"int8 sweep {key}: answers differ from {tiles[0]}")
        t.setdefault(key, []).append(cuda_ms(fn, iters, 1))
    print(f"int8 sweep alone at M={p.shape[0]} N={packed.q.shape[0]} D={p.shape[1]} by "
          f"probe tile (ms, in turns): "
          + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()}))
    return t


def check_knn_design_point(gen, results):
    """K2b/K2c at 8192 x 1,048,576 x 512: the kernels on every probe, the
    twin on every 32nd probe with the same operands (the probe scale comes
    from all probes), bit-equal; the twin timed once over all probes; then,
    with the f32 rows freed, ``torch._int_mm`` (32 GiB of int32 out)."""
    m, n, d = KNN_DESIGN
    g = unit_rows(gen, n, d)
    p = unit_rows(gen, m, d)
    qb, sb = knn.quantize_embeddings(g)
    packed = knn.pack_quantized_gallery(qb, sb)
    sub = torch.arange(0, m, DESIGN_CHECK_STRIDE, device="cuda")
    check_int8_bit_equal("design point", p, qb, sb, packed, sub=sub)
    q_ms = cuda_ms(lambda: knn.nearest_neighbor_int8q(p, qb, sb), 3, 1)
    p_ms = cuda_ms(lambda: knn.nearest_neighbor_int8p(p, *packed), 3, 1)
    plain_ms = cuda_ms(lambda: knn.nearest_neighbor_int8_plain(p, qb, sb), 1, 0)
    time_norms_choice("the design point", p, qb, sb, 3)
    time_norms_choice(f"M={m // 2} of the design point's probes", p[:m // 2], qb, sb, 3)
    sweeps = time_int8_sweeps(p, packed, sb, [0, 1], 3)
    tile = knn.int8_tile(m, d, torch.cuda.current_device())
    b_ms, b_by = bound(nbytes(p, qb) + m * 8, 2.0 * m * n * d, "int8")
    qa = knn.quantize_embeddings(p, reciprocal=True)[0]
    del g, p, packed
    torch.cuda.empty_cache()
    int_mm, why = int_mm_call(qa, qb)
    lib_ms = cuda_ms(int_mm, 3, 1) if int_mm else None
    del int_mm
    torch.cuda.empty_cache()
    print(f"knn design point M={m} N={n} D={d}: route wgmma, probe tile {tile.tm} "
          f"({'streamed' if tile.streamed else 'resident'}); int8 bit-equal on {len(sub)} "
          f"probes (1 in {DESIGN_CHECK_STRIDE}), both epilogues; "
          f"knn_int8q {q_ms:.3f} ms, knn_int8p {p_ms:.3f} ms "
          f"({2.0 * m * n * d / p_ms / 1e9:.1f} T int8 ops/s, {b_ms / p_ms:.3f} of the "
          f"bound), bound {b_ms:.3f} ms ({b_by}), torch._int_mm "
          + (f"{lib_ms:.3f} ms" if lib_ms is not None else f"refused ({why})")
          + f", plain twin (chunked, all probes) {plain_ms:.3f} ms")
    results["design_point"] = {"M": m, "N": n, "D": d, "route": "wgmma",
                               "streamed": tile.streamed, "knn_int8q_ms": q_ms,
                               "knn_int8p_ms": p_ms, "plain_ms": plain_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                               "sweeps_ms": sweeps}


def check_knn_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {k: {"max_abs_err": 0.0} for k in ("knn_f32", "knn_int8q", "knn_int8p")}
    for name, m, n, d in KNN_SHAPES:
        check_knn_shape(gen, name, m, n, d, results)
        torch.cuda.empty_cache()
    check_knn_design_point(gen, results)
    check_knn_routed(gen, results)
    torch.cuda.empty_cache()
    check_knn_bench_bf16(gen, results)
    torch.cuda.empty_cache()
    return results


def smooth_images(rng, n: int, shape=(H, W)):
    """Seeded synthetic photos: low-frequency colour fields plus noise."""
    low = torch.from_numpy(rng.rand(n, 3, 12, 16).astype(np.float32) * 255)
    img = F.interpolate(low, size=shape, mode="bilinear", align_corners=False)
    img = img + torch.from_numpy(rng.randn(n, 3, *shape).astype(np.float32) * 12)
    img = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return [np.ascontiguousarray(a) for a in img.numpy()]


def load_images(rng):
    """The reference fixture (downscaled to fit 640x480, as the reference
    demos do) when it and cv2 are present, then seeded synthetic photos."""
    fixture = os.path.join(os.path.dirname(zoo.MTCNN_PB), "test_image.jpg")
    images = []
    if os.path.exists(fixture) and importlib.util.find_spec("cv2") is not None:
        import cv2

        img = cv2.cvtColor(cv2.imread(fixture), cv2.COLOR_BGR2RGB)
        scale = min(W / img.shape[1], H / img.shape[0], 1.0)
        images.append(cv2.resize(img, (int(img.shape[1] * scale),
                                       int(img.shape[0] * scale))))
        print(f"image 0: fixture {fixture} at {images[0].shape[1]}x{images[0].shape[0]}")
    else:
        print("fixture photo or cv2 not available: synthetic images only")
    return images + smooth_images(rng, N_IMAGES - len(images))


def load_params():
    if os.path.exists(zoo.MTCNN_PB) and os.path.exists(zoo.AGEGENDER_PB):
        print(f"weights: shipped ({zoo.MTCNN_PB}, {zoo.AGEGENDER_PB})")
        return (import_mtcnn_params(zoo.MTCNN_PB),
                import_multihead_params(zoo.AGEGENDER_PB))
    print("!!! WEIGHTS: shipped pbs not found at "
          f"{os.path.dirname(zoo.MTCNN_PB)} — using SEEDED RANDOM weights "
          f"(seed {SEED}); faces and ages are meaningless, parity is not !!!")
    return (random_mtcnn_params(np.random.RandomState(SEED + 2)),
            random_multihead_params(np.random.RandomState(SEED + 100)))


def worst_face_diffs(got, want, label: str, tol=F32_TOL):
    """Per-image face lists ``got`` against ``want``: the same face counts,
    and the worst box (px), age, P(male) and least identity cosine within
    ``tol``. Returns the worst values."""
    counts = ([len(f) for f in got], [len(f) for f in want])
    if counts[0] != counts[1]:
        raise AssertionError(f"{label}: face counts {counts[0]} vs {counts[1]}")
    worst = {"box_px": 0.0, "age": 0.0, "gender": 0.0, "min_cos": 1.0}
    for a, b in ((a, b) for fa, fb in zip(got, want) for a, b in zip(fa, fb)):
        worst["box_px"] = max(worst["box_px"],
                              float(np.abs(np.subtract(a.raw_bbox, b.raw_bbox)).max()))
        worst["age"] = max(worst["age"], abs(a.age - b.age))
        worst["gender"] = max(worst["gender"], abs(a.gender_prob - b.gender_prob))
        worst["min_cos"] = min(worst["min_cos"], float(cosine(a.identity, b.identity)))
    if not (worst["box_px"] <= tol["box_px"] and worst["age"] <= tol["age"]
            and worst["gender"] <= tol["gender"] and worst["min_cos"] > tol["min_cos"]):
        raise AssertionError(f"{label} disagree: {worst}")
    return worst


def compare_analyzers(gpu, cpu, img, label: str = "f32 heads", tol=F32_TOL):
    """The card's results against the CPU's on one image, within ``tol``
    (boxes in px, ages, P(male), least identity cosine)."""
    g = gpu.analyze_core(gpu.detector.upload(img))
    c = cpu.analyze_core(cpu.detector.upload(img))
    g_valid, c_valid = g[4].cpu().numpy(), c[4].cpu().numpy()
    if not np.array_equal(g_valid, c_valid):
        raise AssertionError(f"valid masks differ: cuda {g_valid} cpu {c_valid}")
    faces_g, faces_c = gpu.analyze(img), cpu.analyze(img)
    worst = worst_face_diffs([faces_g], [faces_c], f"cuda vs cpu ({label})", tol)
    print(f"cuda vs cpu on image 0 ({label}): {len(faces_g)} faces, valid "
          f"masks equal, worst {json.dumps(worst)}")


def head_crops(analyzer, img):
    """The (K, 224, 224, 3) head crops ``analyze_core`` hands the heads."""
    seen = []
    apply = analyzer.heads.apply
    analyzer.heads.apply = lambda crops: seen.append(crops) or apply(crops)
    try:
        analyzer.analyze_core(analyzer.detector.upload(img))
    finally:
        del analyzer.heads.apply
    return seen[0]


def rel_l2(a, b) -> float:
    """Largest relative L2 distance of the rows of ``a`` from ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def int8_stages_cuda_vs_cpu(gpu, cpu, img):
    """The int8 heads on the card against the CPU on the same input: the
    CPU analyzer's head crops of ``img``, preprocessed as ``apply`` does.
    Stage by stage, each stage runs on both devices from the CPU chain's
    input (conv1 from the crops, block i from the int8 activation before
    it): int8 outputs differ only by one-quantum flips, in at most
    ``FLIP_FRACTION`` of them. The last block's f32 output and the whole
    heads forward on the same crops within ``SAME_CROPS_TOL``. The crops'
    own card-vs-CPU difference (K1 against its plain version) is printed
    beside them."""
    crops = head_crops(cpu, img)
    crop_err = float((head_crops(gpu, img).cpu() - crops).abs().max())
    dev_params = {"cuda": gpu.heads.params["backbone"],
                  "cpu": cpu.heads.params["backbone"]}
    x = torch.flip(crops, dims=(-1,)) - torch.tensor(IMAGENET_MEANS_BGR)
    rows, flips, total = [], 0, 0
    with torch.no_grad():
        want = stem_int8(dev_params["cpu"], x)
        got = stem_int8(dev_params["cuda"], x.cuda()).cpu()
        for i in range(len(MOBILENET_V1_BLOCKS) + 1):
            if i:
                got = block_int8(dev_params["cuda"], i, want.cuda()).cpu()
                want = block_int8(dev_params["cpu"], i, want)
            if want.dtype == torch.int8:
                diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
                n = int(torch.count_nonzero(diff))
                rows.append((f"pw{i}" if i else "conv1", n, want.numel()))
                if int(diff.max()) > 1:
                    raise AssertionError(f"int8 stage {rows[-1][0]}: cuda and cpu "
                                         f"differ by {int(diff.max())} quanta")
                flips, total = flips + n, total + want.numel()
            else:
                last = rel_l2(got.reshape(1, -1), want.reshape(1, -1))
        heads = [an.heads.apply(crops.to(an.device)) for an in (gpu, cpu)]
    ages, gender, ident = (tuple(t.cpu().numpy() for t in out)
                           for out in zip(*heads))
    same = {"last_block_rel_l2": last, "age": float(np.abs(ages[0] - ages[1]).max()),
            "gender": float(np.abs(gender[0] - gender[1]).max()),
            "identity_rel_l2": rel_l2(ident[0], ident[1])}
    print(f"int8 heads cuda vs cpu on the same {len(crops)} crops, stage by "
          f"stage: flips {flips} of {total} int8 activations "
          f"({json.dumps({name: n for name, n, _ in rows})}); last block and "
          f"whole heads {json.dumps(same)}; the crops themselves differ by "
          f"{crop_err:.3g} (K1 vs plain)")
    if flips > FLIP_FRACTION * total:
        raise AssertionError(f"int8 heads: {flips} of {total} activations "
                             f"flipped, above {FLIP_FRACTION}")
    if not all(same[k] <= tol for k, tol in SAME_CROPS_TOL.items()):
        raise AssertionError(f"int8 heads on the same crops: {same} beyond "
                             f"{SAME_CROPS_TOL}")


def cosine(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@contextlib.contextmanager
def forwards_counted(obj, name: str):
    """Inside the block, ``obj.<name>(params, x, ...)`` counts its calls on
    a non-empty batch ``x``. Yields the count, a one-element list that the
    caller zeroes where it resets the launch counters."""
    fn, own, count = getattr(obj, name), vars(obj).get(name), [0]

    def counted(params, x, *args, **kwargs):
        count[0] += int(x.shape[0] > 0)
        return fn(params, x, *args, **kwargs)

    setattr(obj, name, counted)
    try:
        yield count
    finally:
        if own is None:
            delattr(obj, name)
        else:
            setattr(obj, name, own)


def check_k7_launches(what: str, launches, forwards: int, per_forward: int):
    """A main path's K7 launches, counted from 0 around it, are
    ``per_forward`` for each of its ``forwards`` (``K7_PER_FORWARD`` where
    they are folded float32 MobileNet-V1 forwards on the card, 0 where
    they are not)."""
    if launches["bias_relu6"] != per_forward * forwards:
        raise AssertionError(f"{what}: {launches['bias_relu6']} K7 launches over "
                             f"{forwards} forwards, not {per_forward} a forward")


def timed_analyze(analyzer, images, k7_per_forward=None):
    """Median host ms/image of ``ANALYZE_REPEATS`` synced passes over the
    images (after one warm-up image), the last pass's outputs and the
    kernel launches of the timed passes. With ``k7_per_forward`` the K7
    launches are held to that many for each head forward of the timed
    passes."""
    analyzer.analyze_with_rotations(images[0])      # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    counting = (forwards_counted(analyzer.heads, "forward") if k7_per_forward is not None
                else contextlib.nullcontext([0]))
    with counting as forwards:
        reset_launches()
        forwards[0] = 0
        repeats = []
        for _ in range(ANALYZE_REPEATS):
            t0 = time.perf_counter()
            outputs = [analyzer.analyze_with_rotations(img) for img in images]
            torch.cuda.synchronize()
            repeats.append((time.perf_counter() - t0) * 1e3 / len(images))
        launches = kernel_launches()
    if k7_per_forward is not None:
        check_k7_launches("analyze_with_rotations", launches, forwards[0], k7_per_forward)
    for i, (faces, rot) in enumerate(outputs):
        print(f"image {i}: {len(faces)} faces, rotation {rot}: " + json.dumps(
            [{"bbox": list(f.bbox), "age": round(f.age, 2),
              "gender_prob": round(f.gender_prob, 4)} for f in faces[:8]]))
        for f in faces:
            if not (np.all(np.isfinite(f.identity))
                    and f.identity.shape == (analyzer.heads.identity_dim,)
                    and np.isfinite(f.age) and 0.0 <= f.gender_prob <= 1.0):
                raise AssertionError(f"image {i}: malformed face {f}")
    return float(np.median(repeats)), repeats, outputs, launches


def int8_analyze_path(mtcnn_params, mh_params, images, f32_outputs):
    """``analyze --int8-heads``: the analyzer with ``Int8MultiheadHeads``
    (K1 crops, K4 pointwise layers), timed as the f32 path; its boxes must
    equal the f32 analyzer's (detection is untouched) and its results the
    same analyzer's on the CPU."""
    gpu = FacialAnalyzer(mtcnn_params, device="cuda",
                         heads=Int8MultiheadHeads(mh_params, "cuda"))
    median, repeats, outputs, launches = timed_analyze(gpu, images, k7_per_forward=0)
    print(f"analyze_with_rotations --int8-heads: median {median:.3f} ms/image "
          f"over {ANALYZE_REPEATS} repeats of {len(images)} images (each "
          f"{[round(r, 3) for r in repeats]}); launches {json.dumps(launches)}")
    if launches["crop_resize"] <= 0 or launches["pw_conv_int8"] <= 0:
        raise AssertionError("the int8 analyze path did not launch K1 and K4")
    cos = []
    for i, ((faces, rot), (ref, ref_rot)) in enumerate(zip(outputs, f32_outputs)):
        if rot != ref_rot or [(f.bbox, f.raw_bbox) for f in faces] != [
                (f.bbox, f.raw_bbox) for f in ref]:
            raise AssertionError(f"image {i}: int8 heads changed the boxes")
        cos += [float(cosine(f.identity, r.identity)) for f, r in zip(faces, ref)]
    print(f"int8 vs f32 heads: boxes equal on {len(images)} images; identity "
          f"cosine min {min(cos, default=1.0):.6f} mean "
          f"{float(np.mean(cos)) if cos else 1.0:.6f} over {len(cos)} faces "
          "(random weights: printed, not held to the shipped weights' 0.98)")
    cpu = FacialAnalyzer(mtcnn_params, device="cpu",
                         heads=Int8MultiheadHeads(mh_params, "cpu"))
    compare_analyzers(gpu, cpu, images[0], "int8 heads", INT8_TOL)
    int8_stages_cuda_vs_cpu(gpu, cpu, images[0])
    return launches, median


def profile_calls(fn, calls: int = 1, expect: str = "", records: int = 0):
    """``fn()`` ``calls`` times under ``torch.profiler``: every event it saw
    as (name, count, self device ms, ran on the device) rows, and the
    calls' span on the card by CUDA events, per call, the profiler's own
    overhead included. After the calls a sentinel kernel runs inside the
    session and is left out of the rows: a session can lose its last
    kernel record (after the K4 check, one K3 call under the profiler
    showed no kernel and ten calls showed nine, an H100 run), and then it
    is the sentinel's. A session can also lose every kernel record (the
    first K4 layer's, an H100 run) or half of them (K4's layers at batch
    1024 often kept 5 of 10, another H100 run): a session that saw fewer than
    ``records`` (by default ``calls``) device kernels whose name holds
    ``expect`` runs again, up to ``PROFILE_TRIES`` sessions in all, and the
    last one's rows return."""
    records = records or calls
    for attempt in range(1, PROFILE_TRIES + 1):
        rows, span = _profile_once(fn, calls)
        seen = sum(n for key, n, _, on_device in rows if on_device and expect in key)
        if seen >= records:
            break
        print(f"profiler session {attempt} of {PROFILE_TRIES} saw {seen} device "
              f"kernel records{f' of {expect}' if expect else ''} of {records} in "
              f"{calls} calls")
    return rows, span


def _profile_once(fn, calls: int):
    """One ``profile_calls`` session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda._sleep(1000)               # the sentinel: spin_kernel
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if "spin_kernel" in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else e.self_cuda_time_total
        rows.append((e.key, e.count, us / 1e3, e.device_type == DeviceType.CUDA))
    return rows, start.elapsed_time(end) / calls


def profile_split(fn):
    """One ``fn()`` under ``torch.profiler``: device time by kernel group
    (``PROFILE_GROUPS``), launches per group, the layout copies and pads the
    forward asked for (aten op counts), and the device-busy share: kernel
    time over the profiled forward's span on the card (CUDA events)."""
    rows, window_ms = profile_calls(fn)
    groups = {name: [0.0, 0] for name, _ in PROFILE_GROUPS + [("other", ())]}
    ops, kernels = {}, []
    for key, count, ms, on_device in rows:
        if on_device:
            name = next((g for g, marks in PROFILE_GROUPS
                         if any(m in key.lower() for m in marks)), "other")
            groups[name][0] += ms
            groups[name][1] += count
            kernels.append((ms, count, name, key[:160]))
        elif key in ("aten::clone", "aten::contiguous", "aten::constant_pad_nd",
                     "aten::_to_copy", "aten::copy_"):
            ops[key] = count
    busy_ms = sum(ms for ms, _ in groups.values())
    if busy_ms == 0.0:
        print("profile: the profiler saw no device kernels; split not measured")
        return None
    split = {name: {"ms": round(ms, 4), "share": round(ms / busy_ms, 4),
                    "launches": n} for name, (ms, n) in groups.items() if n}
    print("profile of one int8 forward: " + json.dumps(split))
    for ms, n, name, key in sorted(kernels, reverse=True)[:12]:
        print(f"  {ms:9.4f} ms {n:3d}x [{name}] {key}")
    print(f"profile: kernels {busy_ms:.3f} ms of a {window_ms:.3f} ms forward "
          f"(device busy {busy_ms / window_ms:.4f}); aten op counts "
          f"{json.dumps(ops)}")
    return {"split": split, "busy_share": busy_ms / window_ms, "ops": ops}


def int8_embed_throughput(mh_params):
    """The int8 embedder at the JAX bench's design point:
    ``multihead_apply_int8(...).identity`` at 224², batch 1024, against the
    f32 ``multihead_apply`` on the same seeded inputs (CUDA events, mean of
    ``EMBED_REPEATS`` forwards after one), then one profiled int8 forward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    means = torch.tensor(IMAGENET_MEANS_BGR, dtype=torch.float32, device="cuda")
    x = torch.rand((EMBED_BATCH, 224, 224, 3), generator=gen, device="cuda") * 255 - means
    qp = to_torch(quantize_multihead_int8(mh_params), "cuda")
    fp = to_torch(mh_params, "cuda")
    fns = {"int8": lambda: multihead_apply_int8(qp, x).identity,
           "f32": lambda: multihead_apply(fp, x).identity}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        ident = {name: fn() for name, fn in fns.items()}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        reset_launches()
        ms = {"int8": cuda_ms(fns["int8"], EMBED_REPEATS, warmup=0)}
        launches = kernel_launches()
        check_k7_launches("int8 embed", launches, EMBED_REPEATS, 0)
        reset_launches()
        ms["f32"] = cuda_ms(fns["f32"], EMBED_REPEATS, warmup=0)
        check_k7_launches(f"f32 embed at batch {EMBED_BATCH}", kernel_launches(),
                          EMBED_REPEATS, K7_PER_FORWARD)
        split = profile_split(fns["int8"])
    cos = cosine(ident["int8"].cpu().numpy(), ident["f32"].cpu().numpy())
    ips = {k: EMBED_BATCH / (v / 1e3) for k, v in ms.items()}
    print(f"embed at 224², batch {EMBED_BATCH}: int8 {ms['int8']:.3f} ms "
          f"({ips['int8']:.1f} img/s), f32 {ms['f32']:.3f} ms "
          f"({ips['f32']:.1f} img/s); int8 vs f32 identity cosine min "
          f"{cos.min():.6f} mean {cos.mean():.6f}; peak memory {peak:.2f} GiB; "
          f"launches {json.dumps(launches)}")
    if launches["pw_conv_int8"] <= 0:
        raise AssertionError("the int8 embedder launched no pw_conv_int8 kernel")
    if not (np.all(np.isfinite(cos)) and ident["int8"].shape == (EMBED_BATCH, 1024)):
        raise AssertionError("malformed int8 embeddings")
    return launches, {"ms": ms, "ips": ips, "cos_min": float(cos.min()),
                      "profile": split}


def people_tree(rng, root: str):
    """Seeded per-person .npy "photos" (a base image plus noise) under
    root/{gallery,probe}/<person>/, as extract_files reads them."""
    paths = {"gallery": [], "probe": []}
    labels = {"gallery": [], "probe": []}
    for person in range(N_PEOPLE):
        base = rng.rand(112, 112, 3) * 255
        for i in range(N_GALLERY + N_PROBE):
            split = "gallery" if i < N_GALLERY else "probe"
            d = os.path.join(root, split, f"person{person}")
            os.makedirs(d, exist_ok=True)
            paths[split].append(os.path.join(d, f"{i}.npy"))
            labels[split].append(f"person{person}")
            np.save(paths[split][-1], np.clip(base + rng.randn(112, 112, 3) * 20,
                                              0, 255).astype(np.uint8))
    return paths, {k: np.asarray(v) for k, v in labels.items()}


def identify_path(rng, model: str, params, tmp: str, cpu_probes=None, k7_per_forward=None):
    """``identify --model <model>`` at full width (the entry's input size
    and width) on the card, then the same ranking objects on the CPU with
    the card's features, and the CPU's extractor on the first
    ``cpu_probes`` probes (all by default). ``params`` are the zoo entry's
    (quantized for ``*_int8``). With ``k7_per_forward`` the K7 launches
    of the extraction are held to that many a forward of the extractor."""
    spec = zoo.MODEL_ZOO[model]
    tmp = os.path.join(tmp, model)
    paths, labels = people_tree(rng, tmp)
    gpu_ex = zoo.build_extractor(model, batch_size=8, device="cuda", params=params)
    gpu_ex.extract_files(paths["gallery"][:2], loader=np.load)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    counting = (forwards_counted(gpu_ex, "model_fn") if k7_per_forward is not None
                else contextlib.nullcontext([0]))
    with counting as forwards:
        feats = {s: gpu_ex.extract_files(paths[s], loader=np.load) for s in paths}
    if k7_per_forward is not None:
        check_k7_launches(f"identify --model {model}", kernel_launches(), forwards[0],
                          k7_per_forward)
    preds, idents, accs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        knn_q = KNNIdentifier(quantized=True, device=dev).fit(
            feats["gallery"], labels["gallery"])
        preds[dev] = knn_q.predict(feats["probe"])
        accs[dev] = gallery_probe_eval(feats["gallery"], labels["gallery"],
                                       feats["probe"], labels["probe"],
                                       device=dev)
        gallery = EnrollmentGallery(os.path.join(tmp, f"gallery_{dev}.npz"),
                                    device=dev)
        gallery.enroll_many(list(labels["gallery"]), feats["gallery"])
        idents[dev] = gallery.identify_many(feats["probe"])
        if dev == "cuda":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
    n = sum(len(v) for v in paths.values())
    print(f"identify --model {model}: {n} photos of 112x112 at "
          f"{spec.input_size[0]}x{spec.input_size[1]} -> {feats['probe'].shape[1]}-d, "
          f"{wall * 1e3:.1f} ms on the card (extract + rank); launches "
          f"{json.dumps(launches)}; int8 accuracy "
          f"{float(np.mean(preds['cuda'] == labels['probe']))}, f32 {accs['cuda']}")
    kernels = ("knn_int8q", "knn_int8p") + (
        ("pw_conv_int8",) if model.endswith("_int8") else ())
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"identify --model {model} launched no {k} kernel")
    if not np.all(np.isfinite(feats["gallery"])) or feats["gallery"].shape != (
            N_PEOPLE * N_GALLERY, spec.embedding_dim):
        raise AssertionError(f"malformed features {feats['gallery'].shape}")
    # the same objects on the CPU, from the same features
    if not np.array_equal(preds["cuda"], preds["cpu"]) or accs["cuda"] != accs["cpu"]:
        raise AssertionError(f"identify cuda {preds['cuda']} vs cpu {preds['cpu']}")
    g_lab = [(a, c) for a, _, c in idents["cuda"]]
    if g_lab != [(a, c) for a, _, c in idents["cpu"]] or not np.allclose(
            [b for _, b, _ in idents["cuda"]], [b for _, b, _ in idents["cpu"]],
            rtol=1e-6):
        raise AssertionError(f"gallery cuda {idents['cuda']} vs cpu {idents['cpu']}")
    cpu_ex = zoo.build_extractor(model, batch_size=8, device="cpu", params=params)
    probes = paths["probe"][:cpu_probes]
    cpu_feats = cpu_ex.extract_files(probes, loader=np.load)
    card = feats["probe"][:len(probes)]
    cos = np.sum(cpu_feats * card, 1) / (
        np.linalg.norm(cpu_feats, axis=1) * np.linalg.norm(card, axis=1))
    print(f"identify --model {model} cuda vs cpu: predictions and gallery answers equal; "
          f"extractor on {len(probes)} probes min cosine {cos.min():.7f}, max abs "
          f"{np.abs(cpu_feats - card).max():.3g}")
    if not cos.min() > 0.999:
        raise AssertionError(f"extractor cuda vs cpu cosine {cos.min()}")
    return launches


def identify_at_scale():
    """Identification at a 1,048,576-row enrollment (1024-d, four
    embeddings per identity): an exact ``KNNIdentifier`` runs K2a on f32
    operands (the f32 matrix would be 8 GiB), ``gallery_probe_eval``
    quantized runs K2b; then 16-probe serving queries against the packed
    gallery (K2c). Checked against the plain twins on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    g = unit_rows(gen, SCALE_N, SCALE_D)
    labels = np.arange(SCALE_N) // 4
    pick = torch.randint(0, SCALE_N, (SCALE_M,), generator=gen, device="cuda")
    probes = g[pick] + 0.02 * torch.randn((SCALE_M, SCALE_D), generator=gen,
                                          device="cuda")
    truth = labels[pick.cpu().numpy()]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pred_exact = KNNIdentifier(device="cuda").fit(g, labels).predict(probes)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    acc_exact = float(np.mean(pred_exact == truth))
    acc_q = gallery_probe_eval(g, labels, probes, truth, quantized=True,
                               device="cuda")
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0 - t_exact
    gn = l2_normalize(g)                 # what the identifiers rank
    qb, sb = knn.quantize_embeddings(gn)
    packed = knn.pack_quantized_gallery(qb, sb)
    served = [knn.nearest_neighbor_int8p(probes[i:i + SERVE_BATCH], *packed)
              for i in range(0, SERVE_BATCH * SERVE_QUERIES, SERVE_BATCH)]
    torch.cuda.synchronize()
    launches = kernel_launches()
    print(f"identify at scale: M={SCALE_M} N={SCALE_N} D={SCALE_D}: accuracy "
          f"exact {acc_exact} ({t_exact * 1e3:.1f} ms), int8 {acc_q} "
          f"({t_q * 1e3:.1f} ms); {SERVE_QUERIES} serving queries of "
          f"{SERVE_BATCH}; launches {json.dumps(launches)}")
    for k in ("knn_f32", "knn_int8q", "knn_int8p"):
        if launches[k] <= 0:
            raise AssertionError(f"identify at scale launched no {k} kernel")
    if not (acc_exact > 0.99 and acc_q > 0.99):
        raise AssertionError(f"identify at scale: accuracy {acc_exact} / {acc_q}")
    # the K2c answers equal the int8 twin's on the same probes
    n_served = SERVE_BATCH * SERVE_QUERIES
    for i, got in enumerate(served):
        want = knn.nearest_neighbor_int8_plain(
            probes[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], qb, sb)
        if not same(got, want):
            raise AssertionError(f"serving query {i}: K2c differs from the twin")
    # K2b at the shape the int8 evaluation runs it, on its operands (the
    # normalized probes against the quantized normalized gallery): bit-equal
    # to the twin on every SCALE_CHECK_STRIDE-th probe, and its answers give
    # the evaluation's accuracy
    pn = l2_normalize(probes)
    sub = torch.arange(0, SCALE_M, SCALE_CHECK_STRIDE, device="cuda")
    got = knn.nearest_neighbor_int8q(pn, qb, sb)
    if not same((got[0][sub], got[1][sub]), int8_twin_rows(pn, qb, sb, sub, False)):
        raise AssertionError("identify at scale: K2b differs from the twin")
    acc_k2b = float(np.mean(labels[got[1].cpu().numpy()] == truth))
    if acc_k2b != acc_q:
        raise AssertionError(f"identify at scale: K2b's accuracy {acc_k2b}, "
                             f"the int8 evaluation's {acc_q}")
    del got
    time_norms_choice("identify at scale", pn, qb, sb, 3)
    # the exact identifier answered what K2a on f32 operands answers, and
    # K2a agrees with the chunked f32 twin: where the two pick different
    # rows, the kernel's row ties the twin's minimum within the tolerance
    gd, gi = knn.nearest_neighbor_f32(pn, gn, bf16=False)
    wd, wi = knn.nearest_neighbor_chunked(pn, gn, chunk=256, bf16=False)
    if not np.array_equal(pred_exact, labels[gi.cpu().numpy()]):
        raise AssertionError("identify at scale: the exact identifier's "
                             "answers are not K2a's")
    if not torch.allclose(gd, wd, rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("identify at scale: K2a distances off the twin")
    diff = gi != wi
    alt = ((pn[diff] - gn[gi[diff]]) ** 2).sum(1)
    if not torch.allclose(alt, wd[diff], rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("identify at scale: K2a picked a row that does "
                             "not tie the twin's minimum")
    agree = 1.0 - float(diff.float().mean())
    # where each evaluation's device time goes: the 1-NN kernels against
    # the plain passes around them (normalize, quantize, norms, labels)
    split = {}
    for label, fn in (("exact", lambda: KNNIdentifier(device="cuda").fit(
            g, labels).predict(probes)), ("int8", lambda: gallery_probe_eval(
                g, labels, probes, truth, quantized=True, device="cuda"))):
        rows, span = profile_calls(fn)
        busy = sum(t for _, _, t, on_device in rows if on_device)
        knn_ms = sum(t for key, _, t, on_device in rows if on_device and "knn_" in key)
        split[label] = {"span_ms": round(span, 3), "device_ms": round(busy, 3),
                        "knn_kernels_ms": round(knn_ms, 3)}
    print("identify at scale, one profiled evaluation each: " + json.dumps(split))
    print(f"identify at scale: K2c bit-equal to the twin on {n_served} served "
          f"probes; K2b bit-equal to the twin on {len(sub)} probes (1 in "
          f"{SCALE_CHECK_STRIDE}) of the int8 evaluation; exact identifier = "
          f"K2a (f32); K2a vs chunked f32 twin "
          f"index agreement {agree}, max abs err "
          f"{float((gd - wd).abs().max()):.3g}")
    if agree < 0.99:
        raise AssertionError(f"K2a index agreement {agree}")
    return launches


def median_ms(fn, repeats: int = ANALYZE_REPEATS) -> float:
    """Median host ms of ``repeats`` synced calls of ``fn`` after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def counting(obj, name: str, calls: list):
    """Wrap ``obj.name`` so that each call appends its first argument's
    shape to ``calls``; ``del obj.name`` undoes it."""
    fn = getattr(obj, name)
    setattr(obj, name, lambda x, *a: calls.append(tuple(x.shape)) or fn(x, *a))


def analyze_batch_path(mtcnn_params, mh_params, rng):
    """The batch path at full width, batch ``BATCH`` of seeded 640x480
    photos: ``analyze_batch`` with head slots for every face (exactly 3 K1
    launches a call, timed beside ``BATCH`` x the single-image ``analyze``
    and ``detect_batch``, launches per image from one profiled call); the
    reference's default slots, max(16, 2 x lanes), where lanes past them
    re-run through ``analyze``; with a blank and a noise lane added, equal
    to the card's own single-image ``analyze``; on 4 photos equal to the
    CPU's ``analyze_batch``; ``analyze_batch_retry_padded`` with two blank
    lanes runs the rotation pair and equals ``analyze_batch_padded`` over
    host-rotated copies. Returns the kernel launches of the path and its
    numbers."""
    photos = np.stack(smooth_images(rng, BATCH))
    blank = np.zeros((H, W, 3), np.uint8)
    noise = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    # head slots for every face (these weights find 2-8 faces a photo)
    roomy = FacialAnalyzer(mtcnn_params, mh_params, device="cuda",
                           batch_head_total=ROOMY_SLOTS)
    default = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    roomy.analyze_batch(photos)                     # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    reset_launches()
    fallbacks = []
    counting(roomy, "analyze", fallbacks)
    out = roomy.analyze_batch(photos)
    torch.cuda.synchronize()
    launches = kernel_launches()
    if fallbacks or launches["crop_resize"] != 3:
        raise AssertionError(f"analyze_batch: {len(fallbacks)} lanes re-ran, K1 "
                             f"launched {launches['crop_resize']} times (want 3)")
    counting(default, "analyze", fallbacks)
    out_default = default.analyze_batch(photos)
    n_default = len(fallbacks)
    del roomy.analyze, default.analyze

    single = [roomy.analyze(img) for img in photos]
    mixed = np.concatenate([photos, blank[None], noise[None]])
    got = roomy.analyze_batch(mixed)
    worst = worst_face_diffs(got, single + [roomy.analyze(blank), roomy.analyze(noise)],
                             "analyze_batch vs analyze on the card")
    worst_default = worst_face_diffs(out_default, single, "default slots vs analyze")
    worst_roomy = worst_face_diffs(out, single, "analyze_batch vs analyze")
    if got[BATCH]:
        raise AssertionError(f"the blank lane found {len(got[BATCH])} faces")
    print(f"analyze_batch x{BATCH + 2} (8 photos, a blank and a noise lane) vs "
          f"the card's analyze: faces {[len(f) for f in got]}, worst "
          f"{json.dumps(worst)}; at the default {BATCH_HEAD_SLOTS} head slots "
          f"{n_default} of {BATCH} lanes re-ran through analyze (worst "
          f"{json.dumps(worst_default)}); with {ROOMY_SLOTS} slots none "
          f"(worst {json.dumps(worst_roomy)})")

    cpu = FacialAnalyzer(mtcnn_params, mh_params, device="cpu",
                         batch_head_total=ROOMY_SLOTS)
    worst_cpu = worst_face_diffs(roomy.analyze_batch(photos[:4]), cpu.analyze_batch(photos[:4]),
                                 "analyze_batch cuda vs cpu")
    print(f"analyze_batch x4 cuda vs cpu: worst {json.dumps(worst_cpu)}")

    batch_ms = median_ms(lambda: roomy.analyze_batch(photos))
    default_ms = median_ms(lambda: default.analyze_batch(photos))
    single_ms = median_ms(lambda: [roomy.analyze(img) for img in photos]) / BATCH
    detect_ms = median_ms(lambda: roomy.detector.detect_batch(photos))
    rows, window_ms = profile_calls(lambda: roomy.analyze_batch(photos))
    kernels = sum(n for key, n, _, dev in rows if dev and not key.startswith("Mem"))
    copies = sum(n for key, n, _, dev in rows if dev and key.startswith("Memcpy"))
    busy = sum(ms for key, _, ms, dev in rows if dev)
    rows1, window1 = profile_calls(lambda: roomy.analyze(photos[0]))
    kernels1 = sum(n for key, n, _, dev in rows1 if dev and not key.startswith("Mem"))
    copies1 = sum(n for key, n, _, dev in rows1 if dev and key.startswith("Memcpy"))
    numbers = {"batch_ms": batch_ms, "images_per_s": BATCH * 1e3 / batch_ms,
               "default_slots_batch_ms": default_ms,
               "default_slots_fallback_lanes": n_default,
               "single_ms_per_image": single_ms, "single_x8_ms": BATCH * single_ms,
               "detect_batch_images_per_s": BATCH * 1e3 / detect_ms,
               "kernels_per_image": kernels / BATCH, "copies_per_image": copies / BATCH,
               "device_busy_ms": busy, "profiled_ms": window_ms,
               "single_kernels_per_image": kernels1, "single_copies_per_image": copies1,
               "single_device_busy_ms": sum(ms for _, _, ms, dev in rows1 if dev),
               "single_profiled_ms": window1}
    print(f"analyze_batch x{BATCH} 640x480: median {batch_ms:.3f} ms a batch, "
          f"{numbers['images_per_s']:.1f} images/s, against {BATCH} x analyze "
          f"{BATCH * single_ms:.3f} ms ({single_ms:.3f} ms/image); at the default "
          f"slots {default_ms:.3f} ms ({n_default} lanes re-run); detect_batch "
          f"{numbers['detect_batch_images_per_s']:.1f} images/s; one profiled call: "
          f"{kernels / BATCH:.1f} kernels and {copies / BATCH:.2f} copies per image, "
          f"device busy {busy:.3f} of {window_ms:.3f} ms (analyze: {kernels1} kernels, "
          f"{copies1} copies, busy {numbers['single_device_busy_ms']:.3f} of "
          f"{window1:.3f} ms)")

    # the rotation retry: two blank lanes find no face upright
    imgs = np.concatenate([photos[:4], blank[None], blank[None]])
    cores = []
    counting(roomy, "analyze_batch_core", cores)
    retry = roomy.analyze_batch_retry_padded(imgs, BATCH)
    del roomy.analyze_batch_core
    if cores != [(BATCH, H, W, 3), (BATCH, W, H, 3), (BATCH, W, H, 3)]:
        raise AssertionError(f"analyze_batch_retry_padded ran {cores}, not the "
                             "upright pass and the rotation pair")
    upright = roomy.analyze_batch_padded(imgs, BATCH)
    r90 = roomy.analyze_batch_padded(np.rot90(imgs, 3, axes=(1, 2)), BATCH)
    r270 = roomy.analyze_batch_padded(np.rot90(imgs, 1, axes=(1, 2)), BATCH)
    want = [(u, 0) if u else (a, 90) if a else (b, 270) for u, a, b in zip(upright, r90, r270)]
    if [r for _, r in retry] != [r for _, r in want]:
        raise AssertionError(f"retry rotations {[r for _, r in retry]} vs "
                             f"{[r for _, r in want]}")
    worst_retry = worst_face_diffs([f for f, _ in retry], [f for f, _ in want],
                                   "analyze_batch_retry_padded vs host-rotated copies")
    print(f"analyze_batch_retry_padded: passes {cores}, rotations "
          f"{[r for _, r in retry]}, equal to analyze_batch_padded over "
          f"host-rotated copies (worst {json.dumps(worst_retry)})")
    return launches, numbers


def analyze_gallery_path(gpu, images, tmp: str):
    """``analyze --gallery`` (cmd_analyze): each photo is analyzed and its
    faces named with one ``identify_many``, against a gallery holding the
    faces of the first photo that has any. The answers must equal those of
    the same gallery on the CPU."""
    enrolled = next(faces for faces, _ in map(gpu.analyze_with_rotations, images)
                    if faces)                 # also the warm-up
    names = [f"face{i}" for i in range(len(enrolled))]
    feats = np.stack([f.identity for f in enrolled])
    galleries = {dev: EnrollmentGallery(os.path.join(tmp, f"people_{dev}.npz"),
                                        device=dev) for dev in ("cuda", "cpu")}
    for gallery in galleries.values():
        gallery.enroll_many(names, feats)
    torch.cuda.synchronize()
    reset_launches()
    answers = []
    for img in images:
        faces, _ = gpu.analyze_with_rotations(img)
        if faces:
            probes = np.stack([np.asarray(f.identity, np.float32) for f in faces])
            answers.append((probes, galleries["cuda"].identify_many(probes)))
    torch.cuda.synchronize()
    launches = kernel_launches()
    print(f"analyze --gallery: {len(images)} photos, {len(enrolled)} faces "
          f"enrolled; first answers {answers[0][1] if answers else None}; "
          f"launches {json.dumps(launches)}")
    if launches["crop_resize"] <= 0 or launches["knn_int8p"] <= 0:
        raise AssertionError("analyze --gallery did not launch K1 and K2c")
    self_matches = 0
    for probes, got in answers:
        want = galleries["cpu"].identify_many(probes)
        if [(a, c) for a, _, c in got] != [(a, c) for a, _, c in want] or not \
                np.allclose([b for _, b, _ in got], [b for _, b, _ in want],
                            rtol=1e-6):
            raise AssertionError(f"analyze --gallery cuda {got} vs cpu {want}")
        self_matches += sum(b < 0.05 for _, b, _ in got)
    print(f"analyze --gallery: cuda answers equal the cpu gallery's; "
          f"{self_matches} faces within 0.05 of an enrollment")
    return launches


# ---------- the album phase ----------

def variant(img: np.ndarray, seed: int) -> np.ndarray:
    """``img`` with light seeded noise: the same faces, another photo."""
    noise = np.random.RandomState(seed).randint(-3, 4, img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def turned_photos(an, rng, need: int):
    """Photos the retry recovers: seeded scenes faded toward their mean
    (``FADES``: at full contrast the seeded weights find faces in every
    orientation, at none in no orientation, and between them the cascade,
    not rotation-invariant, finds faces in some orientations only), stored
    turned by 90° counter-clockwise (``np.rot90(scene, 1)``) where the
    turned photo shows no face upright and the retry's 90° turn, which
    gives the faded scene back, does. Returns the turned photos and the
    number of faded scenes tried."""
    found, tried = [], 0
    while len(found) < need and tried < 4 * len(FADES) * BATCH:
        scenes = np.stack(smooth_images(rng, BATCH)).astype(np.float32)
        mean = scenes.mean(axis=(1, 2, 3), keepdims=True)
        for fade in FADES:
            faded = np.clip(np.rint(mean + fade * (scenes - mean)), 0, 255).astype(np.uint8)
            turned = np.ascontiguousarray(np.rot90(faded, 1, axes=(1, 2)))
            found += [t for t, up, back in zip(turned, an.analyze_batch(turned),
                                               an.analyze_batch(faded)) if back and not up]
            tried += BATCH
            if len(found) >= need:
                break
    if len(found) < need:
        raise AssertionError(f"{tried} faded scenes gave {len(found)} photos found only "
                             f"after the 90° turn, want {need}")
    return found[:need], tried


def build_album(root: str, an, rng):
    """The album's files in ``root`` with modification times 0-60 days old;
    returns the rotated photos' file names, the clips and the base scenes
    (for the gallery)."""
    scenes = smooth_images(rng, ALBUM_SCENES)
    portraits = smooth_images(rng, ALBUM_PORTRAIT_SCENES, (W, H))
    turned, tried = turned_photos(an, rng, ALBUM_ROTATED)
    now, files = time.time() - 3600, []
    for kind, bases in (("scene", scenes), ("portrait", portraits)):
        for s, base in enumerate(bases):
            for v in range(ALBUM_VARIANTS):
                name = f"{kind}{s:02d}_v{v}.bmp"
                write_bmp(os.path.join(root, name), variant(base, 1000 * s + v) if v else base)
                files.append((name, 15 * v + s % 7))
    rotated = [f"turned{i}.bmp" for i in range(len(turned))]
    for name, img in zip(rotated, turned):
        write_bmp(os.path.join(root, name), img)
        files.append((name, 20))
    clips = {}
    for c in range(ALBUM_CLIPS):
        name = f"clip{c}.mp4"
        clips[name] = [np.ascontiguousarray(variant(scenes[c], 5000 + i)[:, :, ::-1])
                       for i in range(CLIP_FRAMES)]
        with open(os.path.join(root, name), "wb") as f:
            f.write(b"frames served by BmpAlbumOrganizer._open_video")
        files.append((name, 10 + c))
    for name, days in files:
        t = now - days * 86400.0
        os.utime(os.path.join(root, name), (t, t))
    print(f"album: {len(files) - len(clips)} photos ({ALBUM_SCENES} x {ALBUM_VARIANTS} at "
          f"{W}x{H}, {ALBUM_PORTRAIT_SCENES} x {ALBUM_VARIANTS} at {H}x{W}, "
          f"{len(rotated)} turned by 90° from {tried} scenes tried), {len(clips)} clips of "
          f"{CLIP_FRAMES} frames, as 24-bit BMP")
    return rotated, clips, scenes


def record_boxes(org):
    """The face boxes per analyzed image with faces, keyed by its bytes."""
    boxes = {}
    assemble = org._faces_to_outputs

    def record(img, faces, content_w=None):
        if faces:
            key = hash(np.ascontiguousarray(img).tobytes())
            boxes[(key, img.shape)] = [f.bbox for f in faces]
        return assemble(img, faces, content_w)

    org._faces_to_outputs = record
    return boxes


def album_faces_diffs(got, want, label: str):
    """Two scans' ``AlbumFaces``: the same faces photo for photo, born
    years, P(male) and identities within ``ALBUM_TOL``, crops equal (the
    host resizes each box's pixels in cv2's uint8 fixed point). Returns the
    worst values."""
    if got.files != want.files or got.indices != want.indices:
        raise AssertionError(f"{label}: faces per photo differ")
    worst = {"age": float(np.abs(got.born_years - want.born_years).max(initial=0.0)),
             "gender": float(np.abs(got.genders - want.genders).max(initial=0.0)),
             "min_cos": float(cosine(got.features, want.features).min(initial=1.0)),
             "crop_levels": max((int(np.abs(a.astype(np.int16) - b).max())
                                 for a, b in zip(got.facial_images, want.facial_images)),
                                default=0)}
    if not (worst["age"] <= ALBUM_TOL["age"] and worst["gender"] <= ALBUM_TOL["gender"]
            and worst["min_cos"] > ALBUM_TOL["min_cos"]
            and worst["crop_levels"] == 0
            and got.private_photo_indices == want.private_photo_indices):
        raise AssertionError(f"{label}: {worst} beyond {ALBUM_TOL}")
    return worst


def same_result(got: dict, want: dict, label: str) -> None:
    keys = ("n_photos", "n_videos", "n_faces", "clusters", "cluster_genders",
            "cluster_born_years", "cluster_labels")
    diff = [k for k in keys if got[k] != want[k]]
    if diff:
        raise AssertionError(f"{label}: {diff} differ: " + json.dumps(
            {k: (got[k], want[k]) for k in diff})[:2000])


def distance_diffs(fused, feature) -> dict:
    """Card and CPU distance matrices, each a (cuda, cpu) pair: ``fused``
    (what clustering reads) and ``feature`` (the same with age weight 0).
    The squared feature distances, float32 sums of 1024 products in
    cuBLAS's order and the CPU's, agree within 1e-5 off the diagonal, so a
    distance d agrees within 1e-5 / 2d; on the diagonal either side holds
    the square root of a rounding residual, under 2e-3, which HAC never
    reads. The age penalty is the same float64 host arithmetic on both."""
    off = ~np.eye(len(fused[0]), dtype=bool)
    sq = np.abs(feature[0][off] ** 2 - feature[1][off] ** 2)
    err = np.abs(fused[0][off] - fused[1][off])
    far = np.minimum(feature[0][off], feature[1][off]) >= 0.05
    worst = {"feature_sq_max_abs": float(sq.max(initial=0.0)),
             "fused_max_abs": float(err.max(initial=0.0)),
             "fused_max_abs_at_d_0.05_up": float(err[far].max(initial=0.0)),
             "diag_max": float(max(np.abs(np.diag(m)).max(initial=0.0)
                                   for m in fused + feature))}
    if not (worst["feature_sq_max_abs"] <= 1e-5 and worst["diag_max"] < 2e-3):
        raise AssertionError(f"distance matrices cuda vs cpu: {worst}")
    return worst


def linkage_heights(dist: np.ndarray) -> np.ndarray:
    """The single-linkage merge heights HAC cuts at the threshold."""
    import scipy.cluster.hierarchy as hac
    from scipy.spatial.distance import squareform

    return hac.linkage(squareform(dist, checks=False), method="single")[:, 2]


def clustering_at_scale(device: str):
    """``CLUSTER_SCALE`` synthetic L2-normalized faces around seeded centres,
    two a photo over 2048 days: ``fused_distance_matrix`` on the card
    (synced host clock, and the matmul alone by CUDA events), HAC with the
    same-photo constraint on the host, and native rank-order."""
    n, d, k = CLUSTER_SCALE
    rng = np.random.RandomState(SEED + 21)
    labels = rng.randint(0, k, n)
    feats = rng.randn(k, d)[labels] + CLUSTER_SPREAD * rng.randn(n, d)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    born = 1960 + rng.rand(n) * 50
    photos = list(np.arange(n) // 2)
    mdates = [time.gmtime(1.5e9 + i * 86400.0) for i in range(n // 2)]
    fused_distance_matrix(feats[:64], born[:64], photos[:64], mdates, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = fused_distance_matrix(feats, born, photos, mdates, device=device)
    fused_ms = (time.perf_counter() - t0) * 1e3
    f = torch.from_numpy(feats.astype(np.float32)).to(device)
    matmul_ms = cuda_ms(lambda: pairwise_sqeuclidean(f, f), 10)
    if not rankorder.available():
        raise AssertionError("the native rank-order core did not build (g++)")
    out = {"faces": n, "dims": d, "centres": k, "fused_ms": fused_ms,
           "pairwise_sqeuclidean_device_ms": matmul_ms}
    for method, thr, idx in (("scipy", AlbumConfig().distance_threshold, photos),
                             ("rankorder", AlbumConfig().distance_threshold, None)):
        t0 = time.perf_counter()
        clusters = get_facial_clusters(dist, thr, idx, 2, method=method)
        out[f"{method}_s"] = time.perf_counter() - t0
        out[f"{method}_clusters"] = len(clusters)
        out[f"{method}_pure"] = sum(len(set(labels[c])) == 1 for c in clusters)
    print("clustering at scale: " + json.dumps(out))
    return out


def album_path(gpu, cpu, rng, batch_ips: float):
    """The album organizer at full width on the card (``BmpAlbumOrganizer``:
    the batch path with K1, clustering, Dempster-Shafer, naming from an
    int8 gallery on K2c), timed, against a CPU organizer on a subset, the
    CPU's clustering and gallery, a cached re-run and a one-worker scan;
    then clustering at scale. Returns the launches of the timed run and
    the phase's numbers."""
    minsize = ALBUM_MINSIZE
    probe = np.stack(smooth_images(np.random.RandomState(SEED + 30), BATCH))
    if not any(gpu.with_minsize(minsize).analyze_batch(probe)):
        print(f"album: the seeded weights find no face at minsize {minsize} in "
              f"{BATCH} photos; the album runs at 40")
        minsize = 40
    cfg = AlbumConfig(minsize=minsize)
    with tempfile.TemporaryDirectory() as root:
        album = os.path.join(root, "album")
        os.makedirs(album)
        card = BmpAlbumOrganizer(gpu, cfg, analyze_batch=BATCH)
        rotated, card.clips, scenes = build_album(album, card.analyzer, rng)
        clips = card.clips
        # the gallery: one face of each of the first scenes (int8: K2c)
        enrolled = card.analyzer.analyze_batch(np.stack(scenes[:ALBUM_GALLERY]))
        names = [f"person{i}" for i, faces in enumerate(enrolled) if faces]
        feats = np.stack([faces[0].identity for faces in enrolled if faces])
        galleries = {dev: EnrollmentGallery(device=dev) for dev in ("cuda", "cpu")}
        for g in galleries.values():
            g.enroll_many(names, feats)
        card.gallery = galleries["cuda"]
        card.process_album(album, use_cache=False, write_outputs=False)   # warm-up
        card.timer.reset()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = card.process_album(album, use_cache=False, write_outputs=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        n_photos = result["n_photos"]
        scan_s = result["timings"]["phases"]["scan_photos_s"]
        print(f"album: {n_photos} photos, {result['n_videos']} clips, "
              f"{result['n_faces']} faces, {len(result['clusters'])} clusters "
              f"(sizes {[len(c) for c in result['clusters']][:12]}), genders "
              f"{result['cluster_genders'][:12]}, born years "
              f"{result['cluster_born_years'][:12]}, labels {result['cluster_labels'][:12]}; "
              f"launches {json.dumps(launches)}; K1 "
              f"{launches['crop_resize'] / n_photos:.3f} launches per photo (clips "
              "included in the count)")
        if launches["crop_resize"] <= 0 or launches["knn_int8p"] <= 0:
            raise AssertionError("the album did not launch K1 and K2c")
        if result["n_faces"] <= 0 or not result["clusters"]:
            raise AssertionError("the album found no face or no cluster passed "
                                 "the size and date filters")

        faces = card.scan_album(album, use_cache=True)              # writes the cache
        per_file = {f: faces.indices.count(i) for i, f in enumerate(faces.files)}
        if not all(per_file[f] for f in rotated):
            raise AssertionError(f"the retry recovered {[per_file[f] for f in rotated]} "
                                 "faces in the turned photos")
        cached = card.process_album(album, use_cache=True, write_outputs=False)
        same_result(cached, result, "the cached re-run")

        # two flush threads against one
        one = BmpAlbumOrganizer(gpu, cfg, analyze_batch=BATCH, clips=clips)
        one.flush_workers = 1
        t0 = time.perf_counter()
        faces_one = one.scan_album(album, use_cache=False)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        worst_workers = album_faces_diffs(faces, faces_one, "2 vs 1 flush workers")

        # the card against the CPU on a subset, both organizers
        subset_dir = os.path.join(root, "subset")
        os.makedirs(subset_dir)
        picks = ([f"scene{s:02d}_v{s % ALBUM_VARIANTS}.bmp"
                  for s in range(min(5, ALBUM_SCENES))]
                 + ["portrait00_v1.bmp"] + rotated[:2])
        for name in picks:
            shutil.copy2(os.path.join(album, name), subset_dir)
        on_cpu = BmpAlbumOrganizer(cpu, cfg, analyze_batch=BATCH, clips=clips)
        sub_card, sub_cpu = (BmpAlbumOrganizer(gpu, cfg, analyze_batch=BATCH, clips=clips), on_cpu)
        boxes = [record_boxes(o) for o in (sub_card, sub_cpu)]
        subset = [o.scan_album(subset_dir, use_cache=False) for o in (sub_card, sub_cpu)]
        if boxes[0] != boxes[1]:
            raise AssertionError("the card's and the CPU's boxes differ on the subset")
        worst_subset = album_faces_diffs(*subset, "the album subset cuda vs cpu")
        print(f"album subset of {len(picks)} photos cuda vs cpu: faces "
              f"{[subset[0].indices.count(i) for i in range(len(picks))]}, boxes equal, "
              f"worst {json.dumps(worst_subset)}")

        # clustering and naming: the card's faces on the card and on the CPU
        dists = [[fused_distance_matrix(faces.features, faces.born_years, faces.indices,
                                        faces.mdates, weight, dev)
                  for dev in ("cuda", "cpu")] for weight in (cfg.age_penalty_weight, 0.0)]
        worst_dist = distance_diffs(*dists)
        heights = linkage_heights(dists[0][0])
        worst_dist["threshold_margin"] = float(np.abs(heights - cfg.distance_threshold).min())
        clusters = [o.perform_clustering(faces, cfg.min_no_photos) for o in (card, on_cpu)]
        if clusters[0] != clusters[1]:
            raise AssertionError("perform_clustering differs between cuda and cpu")
        on_cpu.gallery = galleries["cpu"]
        labels = [o._label_clusters(faces, clusters[0]) for o in (card, on_cpu)]
        if labels[0] != labels[1]:
            raise AssertionError(f"cluster labels cuda {labels[0]} vs cpu {labels[1]}")
        print(f"album clustering cuda vs cpu: {len(clusters[0])} clusters equal, labels "
              f"equal, distances {json.dumps(worst_dist)}; cached re-run equal; "
              f"1 vs 2 flush workers {json.dumps(worst_workers)}")

        # kernels and copies per photo of one profiled flush
        imgs = np.stack([read_bmp(os.path.join(album, f"scene{s % ALBUM_SCENES:02d}_v0.bmp"))
                         for s in range(BATCH)])
        card.analyzer.analyze_batch_retry_padded(imgs, BATCH)
        rows, window_ms = profile_calls(
            lambda: card.analyzer.analyze_batch_retry_padded(imgs, BATCH), 1, "crop_resize")
    kernels = sum(n for key, n, _, dev in rows if dev and not key.startswith("Mem"))
    copies = sum(n for key, n, _, dev in rows if dev and key.startswith("Memcpy"))
    busy = sum(ms for _, _, ms, dev in rows if dev)
    numbers = {"minsize": minsize, "photos": n_photos, "faces": result["n_faces"],
               "clusters": len(result["clusters"]), "wall_s": wall,
               "scan_photos_per_s": n_photos / scan_s,
               "scan_one_worker_photos_per_s": n_photos / one_s,
               "analyze_batch_images_per_s": batch_ips,
               "timings": result["timings"],
               "flush_kernels_per_photo": kernels / BATCH,
               "flush_copies_per_photo": copies / BATCH,
               "flush_device_busy_ms": busy, "flush_profiled_ms": window_ms}
    print(f"album scan at batch {BATCH}: {numbers['scan_photos_per_s']:.1f} photos/s "
          f"({numbers['scan_one_worker_photos_per_s']:.1f} with one flush worker) beside "
          f"analyze_batch {batch_ips:.1f} images/s; one profiled flush: "
          f"{kernels / BATCH:.1f} kernels and {copies / BATCH:.2f} copies per photo, "
          f"device busy {busy:.3f} of {window_ms:.3f} ms; timings "
          + json.dumps(result["timings"]))
    numbers["clustering_at_scale"] = clustering_at_scale("cuda")
    return launches, numbers


def served_photos(an, rng, n: int, faces=SERVE_FACES):
    """``n`` seeded 640x480 photos in which ``an`` finds ``faces[0]`` to
    ``faces[1]`` faces (the seeded weights find 2-8 in most), with their
    direct ``analyze`` results."""
    out = []
    while len(out) < n:
        for img in smooth_images(rng, 8):
            found = an.analyze(img)
            if faces[0] <= len(found) <= faces[1] and len(out) < n:
                out.append((img, found))
    return out


def http_call(port: int, method: str, path: str, body: bytes = None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_TIMEOUT_S)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def serve_path(mtcnn_params, mh_params, rng):
    """The HTTP server at full width, wired as ``serve.build_server`` wires
    it, with seeded weights (the pbs are absent) and a BMP decoder (the
    card's machine has no cv2): the embed worker on
    ``agegender_identity_int8`` (K4), the analyze worker on the f32
    analyzer at 8 lanes with the default head slots (K1), an int8
    ``EnrollmentGallery`` pre-filled with ``SERVE_GALLERY`` seeded
    identities (K2c); ``_prewarm_buckets``, then ``127.0.0.1:0``. Traffic:
    (a) 8 people x 2 photos through ``/enroll?mode=face``; (b)
    ``SERVE_CLIENTS`` threads x ``SERVE_REQUESTS`` mixing
    ``/analyze?identify=1``, ``/identify?mode=face`` and ``/embed``; (c)
    ``/profile``, ``/stats``, ``/gallery``, ``/healthz``. Every response is
    200; /embed equals ``extract_batch`` on the same image (cosine);
    /analyze equals the analyzer's ``analyze`` (``worst_face_diffs``);
    labels and distances equal ``identify_many`` called directly. During
    (b) K1 and K2c launch, and K4 13 times per forward of the embed
    worker. Returns (launches during (b), numbers)."""
    import threading
    from http.server import ThreadingHTTPServer

    from hse_facerec_torch.serve import (_analyze_batch_pow2, _BatchingWorker,
                                         _largest_face, _prewarm_buckets,
                                         make_handler)
    from hse_facerec_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    analyzer = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    extractor = zoo.build_extractor("agegender_identity_int8", device="cuda",
                                    params=quantize_multihead_int8(mh_params))
    gallery = EnrollmentGallery(device="cuda")
    fill = np.random.default_rng(SEED + 41).standard_normal(
        (SERVE_GALLERY, SERVE_DIM), dtype=np.float32)
    gallery.enroll_many([f"member{i:05d}" for i in range(SERVE_GALLERY)], fill)
    del fill
    people = served_photos(analyzer, rng, SERVE_PEOPLE)
    # each person's other photos: the same faces under light noise
    enroll = [(f"person{i}", img if v == 0 else variant(img, 100 * i + v))
              for i, (img, _) in enumerate(people) for v in range(2)]
    probes = [variant(img, 100 * i + 7) for i, (img, _) in enumerate(people)]
    photos = [img for img, _ in served_photos(analyzer, rng, SERVE_ANALYZE_PHOTOS)]
    crops = [np.ascontiguousarray(img[100:324, 200:424]) for img in
             smooth_images(rng, SERVE_CROPS)]
    for h in _prewarm_buckets(SERVE_MAX_BATCH, extractor.batch_size):
        extractor.extract_batch(np.zeros((h, 224, 224, 3), np.uint8))
    timer = StageTimer()
    forwards, seen, lock = [], {}, threading.Lock()
    counting(extractor, "_forward", forwards)

    def analyze_recording(imgs):
        out = _analyze_batch_pow2(analyzer, imgs)
        with lock:
            for im, faces in zip(imgs, out):
                seen[im.tobytes()] = faces
        return out

    worker = _BatchingWorker(extractor.extract_batch, max_batch=SERVE_MAX_BATCH,
                             name="embed_worker", timer=timer)
    analyze_worker = _BatchingWorker(analyze_recording, max_batch=8,
                                     name="analyze_worker", timer=timer)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(
        worker, analyze_worker, profile_input_hw=extractor.input_size,
        request_timeout_s=SERVE_TIMEOUT_S, gallery=gallery, timer=timer,
        decode=decode_bmp, device="cuda"))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    setup_s = time.perf_counter() - t0
    try:
        # (a) enrollment, one person after another
        for label, img in enroll:
            status, body = http_call(port, "POST", f"/enroll?label={label}&mode=face",
                                     bmp_bytes(img))
            if status != 200:
                raise AssertionError(f"/enroll {label}: {status} {body}")
        if len(gallery) != SERVE_GALLERY + len(enroll):
            raise AssertionError(f"gallery holds {len(gallery)} rows after enrolling")
        gallery.identify_many(np.zeros((1, SERVE_DIM), np.float32) + 1.0)  # ranking state

        # (b) concurrent traffic
        plan = []           # (path, image, the person a probe shows)
        for c in range(SERVE_CLIENTS):
            for j in range(SERVE_REQUESTS):
                kind = (c + j) % 3
                if kind == 0:
                    img = photos[(c * SERVE_REQUESTS + j) % len(photos)]
                    plan.append(("/analyze?identify=1", img, None))
                elif kind == 1:
                    k = (c + j) % len(probes)
                    plan.append(("/identify?mode=face", probes[k], f"person{k}"))
                else:
                    plan.append(("/embed", crops[(c * 7 + j) % len(crops)], None))
        bodies = [bmp_bytes(img) for _, img, _ in plan]
        results = [None] * len(plan)

        def client(c):
            for j in range(SERVE_REQUESTS):
                i = c * SERVE_REQUESTS + j
                results[i] = http_call(port, "POST", plan[i][0], bodies[i])

        torch.cuda.synchronize()
        enroll_stats = timer.stats()["enroll"]
        timer.reset()
        del forwards[:]
        reset_launches()
        t1 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=10 * SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = kernel_launches()
        batches = [shape[0] for shape in forwards]
        n_forwards = len(batches)
        stats = dict(timer.stats(), enroll=enroll_stats)
        if any(t.is_alive() for t in clients) or any(r is None for r in results):
            raise AssertionError("serve: a client did not finish")
        bad = [(plan[i][0], r) for i, r in enumerate(results) if r[0] != 200]
        if bad:
            raise AssertionError(f"serve: {len(bad)} responses not 200, e.g. {bad[:3]}")

        # (c) the GET endpoints; a profiler session that lost every kernel
        # record answers 503, and runs again
        gets = {}
        for path in ("/profile", "/stats", "/gallery", "/healthz"):
            for attempt in range(1, PROFILE_TRIES + 1):
                gets[path] = http_call(port, "GET", path)
                if gets[path][0] != 503 or path != "/profile":
                    break
                print(f"/profile session {attempt} of {PROFILE_TRIES} saw no kernel")
            if gets[path][0] != 200:
                raise AssertionError(f"GET {path}: {gets[path]}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # the responses against the direct calls
    worst_cos, analyzed, ident_rows, named, matched = 1.0, [], [], 0, 0
    for (path, img, person), (_, body) in zip(plan, results):
        if path == "/embed":
            want = extractor.extract_batch(img[None])[0]
            worst_cos = min(worst_cos, float(cosine(body["embedding"], want)))
            continue
        faces = seen[img.tobytes()]
        if path.startswith("/analyze"):
            rows = body["faces"]
            analyzed.append((faces, img))
            for row, f in zip(rows, faces):
                if (row["bbox"] != list(f.bbox) or row["age"] != round(f.age, 1)
                        or row["gender_prob"] != round(f.gender_prob, 4)):
                    raise AssertionError(f"/analyze row {row} is not the worker's {f}")
            if faces:   # the request's probes, ranked together as the server did
                ident_rows.append((rows, np.stack([f.identity for f in faces])))
        else:
            ident_rows.append(([body], _largest_face(faces).identity[None]))
            named += body["label"] == person
    worst = worst_face_diffs([f for f, _ in analyzed],
                             [analyzer.analyze(img) for _, img in analyzed],
                             "serve /analyze vs analyze")
    n_ident = 0
    for rows, probes_of_request in ident_rows:
        direct = gallery.identify_many(probes_of_request)
        for row, (label, dist, nearest) in zip(rows, direct):
            if (row["label"], row["nearest"], row["distance"]) != (label, nearest,
                                                                   round(dist, 4)):
                raise AssertionError(f"served identification {row} vs direct "
                                     f"{(label, dist, nearest)}")
            n_ident += 1
            matched += label is not None
    if worst_cos < 0.999:
        raise AssertionError(f"/embed vs extract_batch: cosine {worst_cos}")
    print(f"serve: {len(plan)} requests from {SERVE_CLIENTS} clients in {wall:.3f} s "
          f"= {len(plan) / wall:.1f} requests/s ({card_name_and_power_limit()}); gallery "
          f"{len(gallery)} x {SERVE_DIM}-d int8; setup {setup_s:.1f} s")
    for name in ("analyze", "identify", "embed", "enroll"):
        if name in stats:
            st = stats[name]
            print(f"  {name}: {st['count']} requests, p50 {st['p50_ms']:.3f} ms, "
                  f"p95 {st['p95_ms']:.3f} ms, mean {st['mean_ms']:.3f} ms")
    for w in ("embed_worker", "analyze_worker"):
        print(f"  {w}: " + json.dumps({
            stage: {k: round(stats[f"{w}.{stage}"][k], 3) for k in ("count", "p50_ms", "p95_ms")}
            for stage in ("queue_wait", "assemble", "process") if f"{w}.{stage}" in stats}))
    print(f"  launches {json.dumps(launches)}; embed forwards {n_forwards} (batches "
          f"{batches}); K4 per forward "
          f"{launches['pw_conv_int8'] / max(n_forwards, 1):.1f}")
    print(f"  checks: /analyze vs analyze worst {json.dumps(worst)}; /embed vs "
          f"extract_batch min cosine {worst_cos:.6f}; {n_ident} identifications "
          f"equal identify_many ({matched} matched under the threshold; "
          f"{named} of {sum(p.startswith('/identify') for p, _, _ in plan)} probes "
          f"named their person)")
    print(f"  /profile busy {gets['/profile'][1]['busy_ms']} ms, top "
          + json.dumps(gets['/profile'][1]['top'][:3]) + f"; /healthz "
          + json.dumps(gets['/healthz'][1]) + "; /gallery " + json.dumps(gets['/gallery'][1]))
    if launches["crop_resize"] <= 0 or launches["knn_int8p"] <= 0:
        raise AssertionError(f"serve: K1 or K2c not launched ({launches})")
    if n_forwards == 0 or launches["pw_conv_int8"] != 13 * n_forwards:
        raise AssertionError(f"serve: K4 launched {launches['pw_conv_int8']} times in "
                             f"{n_forwards} embed forwards (want 13 each)")
    stage = lambda k: {q: stats[k][q] for q in ("count", "p50_ms", "p95_ms", "mean_ms")}
    return launches, {
        "requests_per_s": len(plan) / wall, "requests": len(plan), "wall_s": wall,
        "clients": SERVE_CLIENTS, "gallery_rows": len(gallery),
        "endpoints": {k: stage(k) for k in ("analyze", "identify", "embed", "enroll")},
        "workers": {k: stage(k) for k in stats if "_worker." in k},
        "embed_forwards": n_forwards, "profile_busy_ms": gets["/profile"][1]["busy_ms"]}


def zoo_path(rng, tmp: str):
    """The frozen-graph embedders at full width: for each of ``ZOO_MODELS``
    seeded folded params go out through ``graphdef_export`` and back in
    through ``pb_import`` (equal bit for bit), then a batch of
    ``ZOO_BATCH`` images is embedded through ``build_extractor(name,
    params=...)`` (timed, img/s; the int8 entry launches K4 13 times a
    forward at 192²); then ``graph_extractor`` on the exported MobileNet pb
    equals the native ``mobilenet_embed`` on the same batch within
    ``GRAPH_ATOL``. Returns (launches, numbers)."""
    from hse_facerec_torch.core import graphdef_export, pb_import
    from hse_facerec_torch.models.int8_infer import quantize_backbone_int8
    from hse_facerec_torch.testing import random_mobilenet_params, random_resnet50_params

    def same_tree(a, b):
        return sorted(a) == sorted(b) and all(
            same_tree(a[k], b[k]) if isinstance(a[k], dict)
            else (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])) for k in a)

    base = {"mobilenet": random_mobilenet_params(np.random.RandomState(SEED + 51)),
            "resnet": random_resnet50_params(np.random.RandomState(SEED + 53))}
    pbs = {"mobilenet": os.path.join(tmp, "vgg2_mobilenet.pb"),
           "resnet": os.path.join(tmp, "vgg2_resnet.pb")}
    t0 = time.perf_counter()
    graphdef_export.export_mobilenet_embedder_pb(base["mobilenet"], pbs["mobilenet"])
    graphdef_export.export_resnet_embedder_pb(base["resnet"], pbs["resnet"])
    imported = {"mobilenet": pb_import.mobilenet_params_from_pb(pbs["mobilenet"]),
                "resnet": pb_import.resnet50_params_from_pb(pbs["resnet"])}
    round_trip_s = time.perf_counter() - t0
    for kind in base:
        if not same_tree(imported[kind], base[kind]):
            raise AssertionError(f"zoo: the {kind} params changed through the pb")
    numbers = {}
    reset_launches()
    for name in ZOO_MODELS:
        kind = "resnet" if "resnet" in name else "mobilenet"
        params = imported[kind]
        if name.endswith("_int8"):
            params = quantize_backbone_int8(params)
        ex = zoo.build_extractor(name, batch_size=ZOO_BATCH, device="cuda", params=params)
        h, w = ex.input_size
        imgs = np.stack(smooth_images(rng, ZOO_BATCH, (h, w)))
        ex.extract_batch(imgs)                       # warm-up
        torch.cuda.synchronize()
        before = kernel_launches()
        times = []
        for _ in range(ZOO_REPEATS):
            t1 = time.perf_counter()
            feats = ex.extract_batch(imgs)           # ends in the copy back
            times.append(time.perf_counter() - t1)
        after = kernel_launches()
        ms = float(np.median(times)) * 1e3
        k4 = after["pw_conv_int8"] - before["pw_conv_int8"]
        numbers[name] = {"ms": ms, "images_per_s": ZOO_BATCH / (ms / 1e3),
                         "k4_launches_per_forward": k4 / ZOO_REPEATS,
                         "dim": int(feats.shape[1])}
        print(f"zoo {name}: {h}x{w}, batch {ZOO_BATCH}: median {ms:.3f} ms "
              f"= {ZOO_BATCH / (ms / 1e3):.1f} img/s over {ZOO_REPEATS} runs; "
              f"{feats.shape[1]}-d; K4 launches per forward {k4 / ZOO_REPEATS:.1f}")
        want_dim = zoo.MODEL_ZOO[name].embedding_dim
        if feats.shape != (ZOO_BATCH, want_dim) or not np.all(np.isfinite(feats)):
            raise AssertionError(f"zoo {name}: malformed embeddings {feats.shape}")
        if name.endswith("_int8") and k4 != 13 * ZOO_REPEATS:
            raise AssertionError(f"zoo {name}: K4 launched {k4} times in "
                                 f"{ZOO_REPEATS} forwards (want 13 each)")
    gex = zoo.graph_extractor(pbs["mobilenet"], "input_1:0", "reshape_1/Reshape:0",
                              (192, 192), batch_size=ZOO_BATCH, device="cuda")
    imgs = np.stack(smooth_images(np.random.RandomState(SEED + 57), ZOO_BATCH, (192, 192)))
    native = zoo.build_extractor("vgg2_mobilenet", batch_size=ZOO_BATCH, device="cuda",
                                 params=base["mobilenet"]).extract_batch(imgs)
    graph = gex.extract_batch(imgs)
    torch.cuda.synchronize()
    launches = kernel_launches()
    err = float(np.abs(graph - native).max())
    numbers["graph_extractor"] = {"max_abs_err": err, "max_abs": float(np.abs(native).max())}
    print(f"zoo: pb round trips of mobilenet and resnet50 bit-equal ({round_trip_s:.1f} s); "
          f"graph_extractor on the exported MobileNet pb vs mobilenet_embed at batch "
          f"{ZOO_BATCH}: max abs err {err:.3g} (values up to {np.abs(native).max():.3g}); "
          f"launches {json.dumps(launches)}")
    if not err <= GRAPH_ATOL:
        raise AssertionError(f"graph_extractor vs mobilenet_embed: {err} > {GRAPH_ATOL}")
    if launches["pw_conv_int8"] <= 0:
        raise AssertionError("the zoo path launched no pw_conv_int8 kernel")
    return launches, numbers


def two_model_diffs(got, want, label: str, tol=TWO_MODEL_TOL):
    """Per-image face lists of the two-model analyzer ``got`` against
    ``want``: the same face counts, the worst box (px), age and P(male)
    within ``tol``, and no identity features in ``got``. Returns the worst
    values."""
    counts = ([len(f) for f in got], [len(f) for f in want])
    if counts[0] != counts[1]:
        raise AssertionError(f"{label}: face counts {counts[0]} vs {counts[1]}")
    worst = {"box_px": 0.0, "age": 0.0, "gender": 0.0}
    for a, b in ((a, b) for fa, fb in zip(got, want) for a, b in zip(fa, fb)):
        if a.identity.shape != (0,):
            raise AssertionError(f"{label}: identity of shape {a.identity.shape}")
        worst["box_px"] = max(worst["box_px"],
                              float(np.abs(np.subtract(a.raw_bbox, b.raw_bbox)).max()))
        worst["age"] = max(worst["age"], abs(a.age - b.age))
        worst["gender"] = max(worst["gender"], abs(a.gender_prob - b.gender_prob))
    if not all(worst[k] <= tol[k] for k in worst):
        raise AssertionError(f"{label} disagree: {worst} beyond {tol}")
    return worst


def device_split(rows, window_ms: float) -> dict:
    """A profiled call's device ms by kernel group: K1, convolutions,
    GEMMs, copies, the rest; and the busy and the window ms."""
    groups = {"K1 crop_resize": ("crop_resize",), "convolution": ("conv", "cudnn"),
              "gemm": ("gemm", "cutlass", "sm90_xmma", "cublas"), "copies": ("Memcpy", "Memset")}
    split = {k: 0.0 for k in list(groups) + ["other"]}
    for key, _, ms, on_device in rows:
        if on_device:
            name = next((g for g, marks in groups.items()
                         if any(m in key for m in marks)), "other")
            split[name] += ms
    split["busy"] = sum(v for k, v in split.items())
    split["window"] = window_ms
    return split


def two_model_path(mtcnn_params, mh_params, images, rng, tmp: str):
    """``analyze --age-pb/--gender-pb`` at full width: the seeded multi-head
    params split into a MobileNet-V1 alpha 1.0 age pb at 192² and a gender
    pb at 224² (``export_age_pb``/``export_gender_pb``), compiled by the
    graph compiler. ``analyze_with_rotations`` on the photos (timed as the
    one-model path), exactly 3 K1 launches per ``analyze``; ``analyze_batch``
    at batch ``BATCH`` of 640x480 photos, exactly 3 K1 launches; ``analyze``
    and ``analyze_batch`` timed in turns with the one-model analyzer, one
    profiled batch call of each; the halves exported at 224² equal the
    one-model analyzer on the card (single and batch); the card against
    the CPU on one photo. Returns (launches, numbers)."""
    from hse_facerec_torch.core.graphdef_export import export_age_pb, export_gender_pb
    from hse_facerec_torch.pipelines.heads import TwoModelHeads

    pbs = {}
    for name, export, size in (("age", export_age_pb, AGE_HW),
                               ("age224", export_age_pb, GENDER_HW),
                               ("gender", export_gender_pb, GENDER_HW)):
        pbs[name] = os.path.join(tmp, f"{name}_{size}.pb")
        export(mh_params, pbs[name], input_size=size)
    two = FacialAnalyzer(mtcnn_params, device="cuda", batch_head_total=ROOMY_SLOTS,
                         heads=TwoModelHeads(pbs["age"], pbs["gender"], "cuda"))
    if (two.heads.age_hw, two.heads.gender_hw) != ((AGE_HW,) * 2, (GENDER_HW,) * 2):
        raise AssertionError(f"two-model input sizes {two.heads.age_hw}, "
                             f"{two.heads.gender_hw}")
    median, repeats, outputs, launches = timed_analyze(two, images)
    per_photo = []
    for img in images:
        reset_launches()
        two.analyze(img)
        torch.cuda.synchronize()
        per_photo.append(kernel_launches()["crop_resize"])
    photos = np.stack(smooth_images(rng, BATCH))
    two.analyze_batch(photos)                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    batch_out = two.analyze_batch(photos)
    torch.cuda.synchronize()
    batch_launches = kernel_launches()
    print(f"two-model analyze (age {AGE_HW}², gender {GENDER_HW}²): median "
          f"{median:.3f} ms/image over {ANALYZE_REPEATS} repeats of {len(images)} "
          f"images (each {[round(r, 3) for r in repeats]}); K1 launches per "
          f"analyze {per_photo}, per analyze_batch x{BATCH} "
          f"{batch_launches['crop_resize']}; faces per photo "
          f"{[len(f) for f, _ in outputs]} and {[len(f) for f in batch_out]}")
    if per_photo != [3] * len(images) or batch_launches["crop_resize"] != 3:
        raise AssertionError("two-model path: K1 did not launch exactly 3 times "
                             "per photo and per batch")
    # the one-model analyzer beside it in turns (one, two, two, one): the
    # host's load, which these host-bound paths follow, moves both alike
    one = FacialAnalyzer(mtcnn_params, mh_params, device="cuda",
                         batch_head_total=ROOMY_SLOTS)
    turns = {"one": {"analyze": [], "batch": []}, "two": {"analyze": [], "batch": []}}
    for name, an in (("one", one), ("two", two), ("two", two), ("one", one)):
        turns[name]["analyze"].append(median_ms(
            lambda: [an.analyze(img) for img in images]) / len(images))
        turns[name]["batch"].append(median_ms(lambda: an.analyze_batch(photos)))
    ms = {k: {m: float(np.mean(v)) for m, v in t.items()} for k, t in turns.items()}
    batch_ms = ms["two"]["batch"]
    rows, window_ms = profile_calls(lambda: two.analyze_batch(photos), 1, "crop_resize")
    split = device_split(rows, window_ms)
    rows1, window1 = profile_calls(lambda: one.analyze_batch(photos), 1, "crop_resize")
    split1 = device_split(rows1, window1)
    print(f"analyze in turns (one, two, two, one; medians of {ANALYZE_REPEATS}): "
          f"ms/image one-model {turns['one']['analyze']}, two-model "
          f"{turns['two']['analyze']} ({ms['two']['analyze'] / ms['one']['analyze']:.2f}x); "
          f"analyze_batch x{BATCH} 640x480 ms one-model {turns['one']['batch']}, "
          f"two-model {turns['two']['batch']} = {BATCH * 1e3 / batch_ms:.1f} against "
          f"{BATCH * 1e3 / ms['one']['batch']:.1f} images/s; one profiled call, device ms "
          "two-model " + json.dumps({k: round(v, 3) for k, v in split.items()})
          + ", one-model " + json.dumps({k: round(v, 3) for k, v in split1.items()}))

    eq = FacialAnalyzer(mtcnn_params, device="cuda", batch_head_total=ROOMY_SLOTS,
                        heads=TwoModelHeads(pbs["age224"], pbs["gender"], "cuda"))
    worst_single = two_model_diffs([eq.analyze(img) for img in images],
                                   [one.analyze(img) for img in images],
                                   "exported halves vs one-model analyze")
    worst_batch = two_model_diffs(eq.analyze_batch(photos), one.analyze_batch(photos),
                                  "exported halves vs one-model analyze_batch")
    cpu = FacialAnalyzer(mtcnn_params, device="cpu",
                         heads=TwoModelHeads(pbs["age"], pbs["gender"], "cpu"))
    worst_cpu = two_model_diffs([two.analyze(images[0])], [cpu.analyze(images[0])],
                                "two-model cuda vs cpu", TWO_MODEL_CPU_TOL)
    print(f"two-model halves at 224² vs the one-model analyzer on the card: analyze "
          f"worst {json.dumps(worst_single)}, analyze_batch x{BATCH} worst "
          f"{json.dumps(worst_batch)}; two-model cuda vs cpu on image 0: worst "
          f"{json.dumps(worst_cpu)}")
    total = {k: launches[k] + batch_launches[k] for k in launches}
    return total, {"analyze_ms_per_image": median, "turns_ms": turns,
                   "batch_ms": batch_ms, "batch_images_per_s": BATCH * 1e3 / batch_ms,
                   "one_model_batch_images_per_s": BATCH * 1e3 / ms["one"]["batch"],
                   "one_model_batch_device_ms": split1,
                   "k1_per_analyze": per_photo[0],
                   "k1_per_batch": batch_launches["crop_resize"],
                   "batch_device_ms": split, "worst_vs_one_model": worst_batch}


def utk_dataset(rng, root: str):
    """``UTK_N`` seeded UTKFace-named photos as .npy (``{age}_{gender}_
    {race}_{n}.npy``): ``UTK_FIRST`` at the first size, the rest at the
    second."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(UTK_N):
        shape = UTK_SIZES[0] if i < UTK_FIRST else UTK_SIZES[1]
        age, gender, race = rng.randint(1, 91), rng.randint(0, 2), rng.randint(0, 5)
        paths.append(os.path.join(root, f"{age}_{gender}_{race}_{i:05d}.npy"))
        np.save(paths[-1], smooth_images(rng, 1, shape)[0])
    return paths


def utk_backends(mh_params, tmp: str):
    """The nine backends at their published widths, seeded: backend ->
    (width, discrete decisions, device -> predict fn, images -> near ties
    in the CPU's decode or None)."""
    from hse_facerec_torch.core.graphdef_export import export_head_pb
    from hse_facerec_torch.eval import utkface as U
    from hse_facerec_torch.models import (arcface, bknet, inception_resnet, mobilenet_v2,
                                          ssrnet, wide_resnet)

    gen = torch.Generator().manual_seed(SEED + 61)
    ga = arcface.init_iresnet_params(gen, depth=50, emb_dim=202)
    ir = inception_resnet.init_inception_resnet_v1_params(gen, with_heads=True)
    wrn = wide_resnet.init_wide_resnet_params(gen)
    for head in ("gender", "age"):
        wrn[head]["kernel"] = wrn[head]["kernel"] * np.float32(TAME)
    mn2 = mobilenet_v2.init_mobilenet_v2_params(gen)
    ssr = [ssrnet.init_ssrnet_params(gen) for _ in range(2)]
    for p in ssr:
        for k in (1, 2, 3):
            p[f"stage{k}"]["delta"]["kernel"] = p[f"stage{k}"]["delta"]["kernel"] * np.float32(TAME)
    bk = bknet.init_bknet_params(gen)
    # the converted Adience checkpoints' graphs: MobileNet-V1 alpha 1.0 at
    # 227² with an 8-way age and a 2-way gender softmax, in both tap styles
    rs = np.random.RandomState(SEED + 63)
    adience = dict(mh_params, **{h: {"kernel": (rs.randn(256, n) * 0.05).astype(np.float32),
                                     "bias": np.zeros(n, np.float32)}
                                 for h, n in (("age", 8), ("gender", 2))})
    pbs = {}
    for backend, tap_in, tap_out in (("converted_pb", "input", "prob"),
                                     ("converted_logits_pb", "Placeholder", "logits")):
        pbs[backend] = [os.path.join(tmp, f"{backend}_{h}.pb") for h in ("age", "gender")]
        for path, head in zip(pbs[backend], ("age", "gender")):
            export_head_pb(adience, path, head, "Softmax", 227, tap_in, tap_out)
    return {
        "ours": ("multi-head MobileNet-V1 224²", False,
                 lambda d: U.multihead_predict_fn(mh_params, device=d)),
        "insightface": ("IResNet-50 emb 202 112²", True,
                        lambda d: U.insightface_predict_fn(ga, device=d),
                        lambda batch: insightface_near_ties(ga, batch)),
        "facenet": ("Inception-ResNet-v1 160²", False,
                    lambda d: U.facenet_predict_fn(ir, device=d)),
        "wide_resnet": ("WRN-16-8 64²", False,
                        lambda d: U.wide_resnet_predict_fn(wrn, device=d)),
        "agendernet": ("MobileNetV2 alpha 1.0 96²", False,
                       lambda d: U.agendernet_predict_fn(mn2, device=d)),
        "ssrnet": ("SSR-Net 64²", False, lambda d: U.ssrnet_predict_fn(*ssr, device=d)),
        "bknet": ("BKNet 48²", True, lambda d: U.bknet_predict_fn(bk, device=d)),
        "converted_pb": ("MobileNet-V1 227², input->prob", True,
                         lambda d: U.converted_pb_predict_fn(*pbs["converted_pb"], device=d)),
        "converted_logits_pb": ("MobileNet-V1 227², Placeholder->logits", True,
                                lambda d: U.converted_logits_predict_fn(
                                    *pbs["converted_logits_pb"], device=d)),
    }


def insightface_near_ties(ga, batch) -> np.ndarray:
    """Per image of ``batch``, whether any of the gender-age decode's 101
    two-way argmaxes is within ``UTK_AGE_TOL`` of a tie in the CPU's fc1
    output (where the card may rightly decide the other way)."""
    from hse_facerec_torch.models.arcface import iresnet_embed
    from hse_facerec_torch.ops.resize import resize
    from hse_facerec_torch.params import tree_to_torch

    x = torch.from_numpy(batch).to(torch.float32)
    h, w = x.shape[1:3]
    if w != h:
        pad = (0, 0, h - w, 0) if w < h else (0, 0, 0, 0, w - h, 0)
        x = F.pad(x, pad)
    with torch.no_grad():
        out = iresnet_embed(tree_to_torch(ga, "cpu"), resize(x, (112, 112), "cv2_cubic"))
    pairs = out.reshape(len(batch), 101, 2)
    return (torch.abs(pairs[..., 0] - pairs[..., 1]) < UTK_AGE_TOL).any(dim=1).numpy()


def utk_near_boundary(ages, male, true_ages) -> np.ndarray:
    """Per image, whether a prediction lies within the card-vs-CPU
    tolerance of a metric's decision boundary (a bucket edge, ±5 years,
    the 0.6 threshold)."""
    ages = np.asarray(ages, np.float64)
    return ((np.abs(ages[:, None] - np.asarray(ADIENCE_EDGES)).min(1) < UTK_AGE_TOL)
            | (np.abs(np.abs(ages - true_ages) - 5.0) < UTK_AGE_TOL)
            | (np.abs(np.asarray(male) - 0.6) < UTK_MALE_TOL))


def utkface_path(mh_params, rng, tmp: str):
    """``utkface --backend <b>`` for each of the nine backends at its
    published width: ``evaluate_age_gender`` over ``UTK_N`` seeded
    UTKFace-named .npy photos at batch ``UTK_BATCH`` on the card (the
    second of two passes timed: images/s, decode included), then card
    against CPU on the first ``UTK_SUBSET`` photos: per-image ages within
    ``UTK_AGE_TOL`` years, P(male) within ``UTK_MALE_TOL``, argmax ages and
    hard genders equal (insightface: but for images with a near tie in its
    decode), and the metric dicts of both devices' predictions equal over
    the photos that lie clear of every decision boundary. Returns numbers."""
    from hse_facerec_torch.eval.utkface import evaluate_age_gender, parse_utkface_filename

    paths = utk_dataset(rng, os.path.join(tmp, "utkface"))
    subset = paths[:UTK_SUBSET]
    batch = np.stack([np.load(p) for p in subset])
    row = {batch[i].tobytes(): i for i in range(UTK_SUBSET)}
    true_ages = np.array([parse_utkface_filename(p)[0] for p in subset])
    numbers = {}
    for backend, (width, discrete, make, *ties) in utk_backends(mh_params, tmp).items():
        gpu = make("cuda")
        evaluate_age_gender(gpu, paths, UTK_BATCH, loader=np.load)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = evaluate_age_gender(gpu, paths, UTK_BATCH, loader=np.load)
        seconds = time.perf_counter() - t0
        preds = {"cuda": gpu(batch), "cpu": make("cpu")(batch)}
        (g_age, g_male), (c_age, c_male) = preds["cuda"], preds["cpu"]
        if not (np.all(np.isfinite(g_age)) and g_age.shape == (UTK_SUBSET,)
                and metrics["n"] == UTK_N):
            raise AssertionError(f"utkface {backend}: malformed {g_age.shape} {metrics}")
        skip = ties[0](batch) if ties else np.zeros(UTK_SUBSET, bool)
        if discrete:
            bad = ((g_age != c_age) | (g_male != c_male)) & ~skip
        else:
            bad = (np.abs(g_age - c_age) > UTK_AGE_TOL) | (np.abs(g_male - c_male) > UTK_MALE_TOL)
        if bad.any():
            raise AssertionError(f"utkface {backend} cuda vs cpu: images {np.where(bad)[0]}: "
                                 f"ages {g_age[bad]} vs {c_age[bad]}, P(male) "
                                 f"{g_male[bad]} vs {c_male[bad]}")
        near = utk_near_boundary(c_age, c_male, true_ages) | skip
        clear = [p for p, n in zip(subset, near) if not n]

        def looked_up(dev):
            ages, male = preds[dev]
            return lambda b: tuple(a[[row[x.tobytes()] for x in b]] for a in (ages, male))

        m = {dev: evaluate_age_gender(looked_up(dev), clear, UTK_SUBSET, loader=np.load)
             for dev in preds}
        if m["cuda"] != m["cpu"] and not all(np.isclose(m["cuda"][k], m["cpu"][k], rtol=1e-6)
                                             for k in m["cuda"]):
            raise AssertionError(f"utkface {backend}: metrics cuda {m['cuda']} cpu {m['cpu']}")
        numbers[backend] = {
            "width": width, "images_per_s": UTK_N / seconds, "metrics": metrics,
            "age_err": float(np.abs(g_age - c_age).max()),
            "male_err": float(np.abs(g_male - c_male).max()),
            "clear_of_boundaries": len(clear), "near_ties": int(skip.sum())}
        print(f"utkface {backend} ({width}): {UTK_N} images at batch {UTK_BATCH} in "
              f"{seconds * 1e3:.1f} ms = {UTK_N / seconds:.1f} images/s on the card; "
              f"cuda vs cpu on {UTK_SUBSET}: max age err {numbers[backend]['age_err']:.3g}, "
              f"P(male) {numbers[backend]['male_err']:.3g}"
              + (f", {int(skip.sum())} near ties" if ties else "")
              + f"; metrics equal on the {len(clear)} clear of a boundary; "
              f"{json.dumps(metrics)}")
    return numbers


def new_zoo_path(rng, tmp: str):
    """The two new zoo entries at full width from seeded params (IResNet-100
    512-d at 112², VGG16 4096-d at 224², 553 MB, seeded once): ``identify
    --quantized`` and the gallery (K2b and K2c at D 512 and 4096, card
    equal to the CPU, the CPU's extractor on 4 probes), then a batch of
    ``ZOO_BATCH`` embedded and timed. Returns (launches, numbers)."""
    from hse_facerec_torch.models.arcface import init_iresnet_params
    from hse_facerec_torch.models.vgg16 import init_vgg16_params

    params = {"insightface_arcface": init_iresnet_params(
                  torch.Generator().manual_seed(SEED + 71), depth=100),
              "vggface_vgg16": init_vgg16_params(torch.Generator().manual_seed(SEED + 73))}
    launches, numbers = [], {}
    for name in NEW_ZOO:
        launches.append(identify_path(rng, name, params[name], tmp, cpu_probes=4))
        ex = zoo.build_extractor(name, batch_size=ZOO_BATCH, device="cuda",
                                 params=params[name])
        imgs = np.stack(smooth_images(rng, ZOO_BATCH, ex.input_size))
        ms = median_ms(lambda: ex.extract_batch(imgs), ZOO_REPEATS)
        feats = ex.extract_batch(imgs)
        dim = zoo.MODEL_ZOO[name].embedding_dim
        if feats.shape != (ZOO_BATCH, dim) or not np.all(np.isfinite(feats)):
            raise AssertionError(f"zoo {name}: malformed embeddings {feats.shape}")
        numbers[name] = {"ms": ms, "images_per_s": ZOO_BATCH * 1e3 / ms, "dim": dim}
        print(f"zoo {name}: {ex.input_size[0]}x{ex.input_size[1]}, batch {ZOO_BATCH}: "
              f"median {ms:.3f} ms = {ZOO_BATCH * 1e3 / ms:.1f} img/s over "
              f"{ZOO_REPEATS} runs; {dim}-d")
        del ex
        torch.cuda.empty_cache()
    return launches, numbers


def check_knn_wide(gen, knn_results):
    """K2b/K2c at the 4096-d embedding of ``vggface_vgg16``, against 1,048,576
    gallery rows at 16 and 8192 probes (``KNN_WIDE``): the probe tile
    ``int8_tile`` picks, the kernels bit-equal to the twin (every probe at
    16, every ``WIDE_CHECK_STRIDE``-th at 8192, on the operands of the
    whole call), ms by CUDA events beside the bound, the plain twin and
    ``torch._int_mm``; beside them the same numbers at D 512 from the K2
    checks. Returns {shape: numbers}."""
    dev = torch.cuda.current_device()
    rows = {}
    report = next((m, n, d) for name, m, n, d in KNN_SHAPES if name == KNN_REPORT)
    for (m, n, d), key in ((report, "D512_M16"), (KNN_DESIGN, "D512_M8192")):
        src = knn_results["knn_int8q"] if m == 16 else knn_results["design_point"]
        tile = knn.int8_tile(m, d, dev)
        rows[key] = {"route": "wgmma", "tile": tile.tm, "streamed": tile.streamed,
                     "knn_int8q_ms": src.get("ms", src.get("knn_int8q_ms")),
                     "knn_int8p_ms": (knn_results["knn_int8p"]["ms"] if m == 16
                                      else src["knn_int8p_ms"]),
                     "plain_ms": src["plain_ms"], "bound_ms": src["bound_ms"],
                     "bound_by": src["bound_by"], "library_ms": src["library_ms"],
                     "ops": 2.0 * m * n * d}
    for m, n, d in KNN_WIDE:
        g = unit_rows(gen, n, d)
        p = unit_rows(gen, m, d)
        qb, sb = knn.quantize_embeddings(g)
        del g
        torch.cuda.empty_cache()
        packed = knn.pack_quantized_gallery(qb, sb)
        sub = torch.arange(0, m, 1 if m <= 16 else WIDE_CHECK_STRIDE, device="cuda")
        check_int8_bit_equal(f"M={m} N={n} D={d}", p, qb, sb, packed, sub=sub,
                             results=knn_results)
        iters = 20 if m <= 16 else 2
        q_ms = cuda_ms(lambda: knn.nearest_neighbor_int8q(p, qb, sb), iters, 1)
        p_ms = cuda_ms(lambda: knn.nearest_neighbor_int8p(p, *packed), iters, 1)
        plain_ms = cuda_ms(lambda: knn.nearest_neighbor_int8_plain(p, qb, sb), 1, 0)
        sweeps = time_int8_sweeps(p, packed, sb, [-1], iters)
        b_ms, b_by = bound(nbytes(p, qb) + m * 8, 2.0 * m * n * d, "int8")
        qa = knn.quantize_embeddings(p, reciprocal=True)[0]
        del packed
        torch.cuda.empty_cache()
        int_mm, why = int_mm_call(F.pad(qa, (0, 0, 0, max(0, INT_MM_MIN_ROWS - m))), qb)
        lib_ms = cuda_ms(int_mm, iters, 1) if int_mm else None
        del int_mm, qa, qb, p
        torch.cuda.empty_cache()
        tile = knn.int8_tile(m, d, dev)
        key = f"D{d}_M{m}"
        rows[key] = {"route": "wgmma", "tile": tile.tm, "streamed": tile.streamed,
                     "knn_int8q_ms": q_ms, "knn_int8p_ms": p_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "ops": 2.0 * m * n * d, "sweeps_ms": sweeps}
        print(f"knn wide M={m} N={n} D={d}: route wgmma, probe tile {tile.tm}"
              f"{' (streamed)' if tile.streamed else ''}; int8 bit-equal on "
              f"{len(sub)} probes, both epilogues; knn_int8q {q_ms:.3f} ms, knn_int8p "
              f"{p_ms:.3f} ms ({2.0 * m * n * d / p_ms / 1e9:.1f} T int8 ops/s, "
              f"{b_ms / p_ms:.3f} of the bound), bound "
              f"{b_ms:.3f} ms ({b_by}), torch._int_mm "
              + (f"{lib_ms:.3f} ms" if lib_ms is not None else f"refused ({why})")
              + (f" (probes padded to {INT_MM_MIN_ROWS} rows)" if m < INT_MM_MIN_ROWS else "")
              + f", plain twin {plain_ms:.3f} ms")
    print("knn by width: " + json.dumps(rows))
    return rows


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: float, ops: float, kind: str):
    """``perfbench.flops.bound_s`` in ms: (ms, "bytes" or "operations")."""
    seconds, by = bound_s(moved, ops, kind)
    return seconds * 1e3, by


def grid_sample_warp(images, mats):
    """One ``F.grid_sample`` call doing the same inverse-affine warp in one
    bilinear pass (zeros outside): the library yardstick for K3. Returns
    the call and its output."""
    n, h, w, c = images.shape
    s = torch.tensor([[2.0 / (w - 1), 0.0, -1.0], [0.0, 2.0 / (h - 1), -1.0],
                      [0.0, 0.0, 1.0]], device=images.device)
    m3 = torch.cat([mats, torch.tensor([0.0, 0.0, 1.0], device=images.device)
                    .expand(n, 1, 3)], dim=1)
    theta = (s @ m3 @ torch.linalg.inv(s))[:, :2]       # normalized out -> in
    grid = F.affine_grid(theta, (n, c, h, w), align_corners=True)
    x = images.permute(0, 3, 1, 2)

    def call():
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    return call, call().permute(0, 2, 3, 1)


def check_warp_kernel():
    """K3 against its plain version on the card at every ``WARP_SHAPES``
    entry: max abs error within ``WARP_ATOL`` and the share of bit-equal
    outputs; kernel and plain version timed with CUDA events, and
    ``F.grid_sample`` beside them. At the training shape one call runs
    under ``torch.profiler``, which must see exactly one device kernel.
    Returns the training shape's numbers for the JSON line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    report = None
    for name, n, h, w, c, cfg in WARP_SHAPES:
        imgs = torch.rand((n, h, w, c), generator=gen, device="cuda") * 2 - 1
        mats = sample_affine(gen, cfg, n, h, w)
        got = warp.warp_batch(imgs, mats, cfg.fill_value)
        want = warp.warp_batch_plain(imgs, mats, cfg.fill_value)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = float((got == want).float().mean())
        filled = float((got == cfg.fill_value).all(-1).float().mean())
        ms = cuda_ms(lambda: warp.warp_batch(imgs, mats, cfg.fill_value), 20)
        plain_ms = cuda_ms(lambda: warp.warp_batch_plain(imgs, mats, cfg.fill_value), 3, 1)
        lib = "grid_sample not run (a one-pixel axis)"
        if h > 1 and w > 1:
            lib_call, lib_out = grid_sample_warp(imgs, mats)
            lib_ms = cuda_ms(lib_call, 20)
            lib = (f"grid_sample_ms={lib_ms:.4f} (mean |diff| "
                   f"{float((lib_out - got).abs().mean()):.4f}, one pass)")
            del lib_out
        b_ms, b_by = bound(nbytes(imgs, mats, got), 110.0 * n * h * w, "f32")
        print(f"warp_batch {name}: {n}x{h}x{w}x{c} max_abs_err={err:.3g} bit-equal "
              f"{equal:.6f} (fill {filled:.4f}) kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} {lib} bound_ms={b_ms:.4f} ({b_by})")
        if not err <= WARP_ATOL:
            raise AssertionError(f"warp_batch {name}: max abs err {err} > {WARP_ATOL}")
        if report is None:
            rows, call_ms = profile_calls(
                lambda: warp.warp_batch(imgs, mats, cfg.fill_value), 1, "warp_kernel")
            device = [(key[:80], count, round(dev_ms, 4))
                      for key, count, dev_ms, on_device in rows if on_device]
            kernels = sum(count for _, count, _ in device)
            print(f"warp_batch {name} profiled call: {kernels} device kernel(s) "
                  + json.dumps(device) + f"; the call {call_ms:.4f} ms by CUDA "
                  "events under the profiler")
            if kernels != 1:
                raise AssertionError(f"warp_batch ran {kernels} device kernels, not 1")
            report = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "device_ms": sum(dev_ms for _, _, dev_ms in device),
                      "shape": f"{n}x{h}x{w}x{c} f32"}
        else:
            report["max_abs_err"] = max(report["max_abs_err"], err)
        del imgs, got, want
    torch.cuda.empty_cache()
    return report


def sdpa_attention(qkv, heads: int):
    """One ``F.scaled_dot_product_attention`` call on f32 q, k and v viewed
    from the same qkv, (B, H, T, D) out: the library yardstick for K5.
    Returns the call and its output as (B, T, H·D)."""
    b, t, _ = qkv.shape
    q, k, v = qkv.view(b, t, 3, heads, attention.HEAD_DIM).permute(2, 0, 3, 1, 4).unbind(0)

    def call():
        return F.scaled_dot_product_attention(q, k, v)
    return call, call().transpose(1, 2).reshape(b, t, -1)


def check_attention_kernel():
    """K5 against ``attention_plain`` in float64 at every ``ATTN_SHAPES``
    entry, each call counted from 0 (exactly one launch) and within
    ``ATTN_RTOL`` of it relative to the output or 1. At the ViT-L shape the
    kernel, its plain version in f32 and ``F.scaled_dot_product_attention``
    are timed with CUDA events beside the bound (4·B·H·T²·D f32 operations;
    bytes: qkv read, o written), and one call runs under ``torch.profiler``,
    which must see exactly one device kernel. Returns that shape's numbers
    for the JSON line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 131)
    d, report = attention.HEAD_DIM, None
    for name, b, t, h in ATTN_SHAPES:
        qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda") * 1.5
        reset_launches()
        got = attention.attention(qkv, h)
        launches = kernel_launches()
        want = attention.attention_plain(qkv.double(), h)
        err = float(((got.double() - want).abs() / want.abs().clamp_min(1.0)).max())
        others = {k: n for k, n in launches.items() if n and k != "attention"}
        print(f"attention {name}: {b}x{t}x{h}x{d} max_rel_err={err:.3g} launches "
              f"{launches['attention']}")
        if launches["attention"] != 1 or others:
            raise AssertionError(f"attention {name}: launches {launches}, not one K5")
        if not err <= ATTN_RTOL:
            raise AssertionError(f"attention {name}: max rel err {err} > {ATTN_RTOL}")
        if report is None:
            ms = cuda_ms(lambda: attention.attention(qkv, h), 20)
            plain_ms = cuda_ms(lambda: attention.attention_plain(qkv, h), 5, 1)
            lib_call, lib_out = sdpa_attention(qkv, h)
            lib_ms = cuda_ms(lib_call, 20)
            lib_err = float(((lib_out.double() - want).abs() / want.abs().clamp_min(1.0)).max())
            b_ms, b_by = bound(nbytes(qkv, got), 4.0 * b * h * t * t * d, "f32")
            rows, call_ms = profile_calls(lambda: attention.attention(qkv, h), 1, "attention")
            device = [(key[:80], count, round(dev_ms, 4))
                      for key, count, dev_ms, on_device in rows if on_device]
            kernels = sum(count for _, count, _ in device)
            dev_ms = sum(dev_ms for _, _, dev_ms in device)
            print(f"attention {name}: kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
                  f"{plain_ms:.4f} sdpa_ms={lib_ms:.4f} (max_rel_err {lib_err:.3g}) "
                  f"bound_ms={b_ms:.4f} ({b_by}) {b_ms / ms:.3f} of the bound; profiled "
                  f"call: {kernels} device kernel(s) {json.dumps(device)}, {call_ms:.4f} ms")
            if kernels != 1:
                raise AssertionError(f"attention ran {kernels} device kernels, not 1")
            report = {"max_rel_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_max_rel_err": lib_err,
                      "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
                      "shape": f"{b}x{t}x{h}x{d} f32"}
            del lib_out
        else:
            report["max_rel_err"] = max(report["max_rel_err"], err)
        del qkv, got, want
    torch.cuda.empty_cache()
    return report


def bn_act_operands(kind: str, shape, gen):
    """x (channels-last, as the trunk's convs hand it over) and the keyword
    arguments of one of the trunk's four K6 passes, from ``gen``."""
    c = shape[1]

    def bn_dict():
        return {"gamma": torch.rand(c, generator=gen, device="cuda") + 0.5,
                "beta": torch.randn(c, generator=gen, device="cuda") * 0.1,
                "mean": torch.randn(c, generator=gen, device="cuda") * 0.3,
                "var": torch.rand(c, generator=gen, device="cuda") + 0.5}

    def act():
        return (torch.randn(shape, generator=gen, device="cuda") * 2.0).contiguous(
            memory_format=torch.channels_last)

    kw = {"bn": bn_dict()}
    if kind in ("bn_prelu", "stem"):
        kw["alpha"] = torch.rand(c, generator=gen, device="cuda")
    if kind in ("tail", "tail_sc"):
        kw["residual"] = act()
    if kind == "tail_sc":
        kw["residual_bn"] = bn_dict()
    if kind != "bn_prelu":
        kw["next_bn"] = bn_dict()
    return act(), kw


def device_ms_per_call(fn, calls: int, expect: str = ""):
    """Device time a call of ``fn`` under ``torch.profiler``: of the
    kernels whose name holds ``expect`` (of every kernel with ""), and
    those kernels' count a call."""
    rows, _ = profile_calls(fn, calls, expect)
    kept = [(n, ms) for key, n, ms, on_device in rows if on_device and expect in key]
    return sum(ms for _, ms in kept) / calls, sum(n for n, _ in kept) / calls


def check_bn_act_kernel():
    """K6 at every (pass, shape) of ``BN_ACT_CHUNK`` at batch
    ``BN_ACT_BATCH``: one launch a call, its outputs bit-equal to
    ``bn_act_plain`` (torch's own passes, as ``models/arcface.py``'s eager
    path runs them). Each is timed a call with CUDA events (the wrapper's
    host work and its ``gamma · rsqrt(var + eps)`` launches included, which
    the small shapes cannot hide here) and by its kernel's device time
    under ``torch.profiler``, beside its bound (x and the residual read,
    the outputs written, at 3.35 TB/s) and the eager passes' device time.
    Returns the per-chunk sums, weighted by the trunk's launches, and each
    (pass, shape)'s numbers for the JSON line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 141)
    rows = {}
    chunk = dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms"), 0.0)
    chunk["launches_per_chunk"] = 0
    for (kind, chw), per_chunk in BN_ACT_CHUNK.items():
        shape = (BN_ACT_BATCH,) + chw
        x, kw = bn_act_operands(kind, shape, gen)
        reset_launches()
        got = bn_act.bn_act(x, **kw)
        launches = kernel_launches()
        want = bn_act.bn_act_plain(x, **kw)
        got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
        torch.cuda.synchronize()
        if launches["bn_act"] != 1 or sum(launches.values()) != 1:
            raise AssertionError(f"bn_act {kind} {shape}: launches {launches}, not one K6")
        if not all(torch.equal(g, w) and g.stride() == x.stride() for g, w in zip(got, want)):
            raise AssertionError(f"bn_act {kind} {shape}: not the eager passes' bits")
        ms = cuda_ms(lambda: bn_act.bn_act(x, **kw), 20)
        dev_ms, kernels = device_ms_per_call(lambda: bn_act.bn_act(x, **kw), 10, "k6_bn_act")
        plain_ms, plain_kernels = device_ms_per_call(lambda: bn_act.bn_act_plain(x, **kw), 10)
        if kernels != 1:
            raise AssertionError(f"bn_act {kind} {shape}: {kernels} K6 kernels a call")
        moved = nbytes(x, *got) + (nbytes(kw["residual"]) if "residual" in kw else 0)
        b_ms, _ = bound(moved, 0.0, "f32")
        name = f"{kind} {'x'.join(map(str, shape))}"
        rows[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "plain_kernels": plain_kernels, "bound_ms": b_ms,
                      "share_of_bound": b_ms / dev_ms, "tb_per_s": moved / dev_ms / 1e9,
                      "per_chunk": per_chunk}
        print(f"bn_act {name}: a call {ms:.4f} ms, device_ms={dev_ms:.4f} bound_ms="
              f"{b_ms:.4f} {b_ms / dev_ms:.3f} of the bound ({moved / dev_ms / 1e9:.2f} "
              f"TB/s); eager passes device {plain_ms:.4f} ms in {plain_kernels:.0f} "
              f"kernels; {per_chunk} a chunk")
        for key, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                           ("bound_ms", b_ms)):
            chunk[key] += per_chunk * value
        chunk["launches_per_chunk"] += per_chunk
        del x, kw, got, want
    torch.cuda.empty_cache()
    share = chunk["bound_ms"] / chunk["device_ms"]
    print(f"bn_act per {BN_ACT_BATCH}-face chunk: {chunk['launches_per_chunk']} launches, device "
          f"{chunk['device_ms']:.3f} ms (calls {chunk['ms']:.3f}), eager passes device "
          f"{chunk['plain_ms']:.3f}, bound {chunk['bound_ms']:.3f} ({share:.3f})")
    return {**chunk, "bound_by": "bytes", "share_of_bound": share, "equal": True,
            "shape": f"IResNet-100's trunk passes of one {BN_ACT_BATCH}-face chunk, "
                     f"channels-last f32", "passes": rows}


def bias_relu6_layers(size: int):
    """(layer, conv output (C, H, W), pads the next conv's edge) of the 27
    folded layers of MobileNet-V1 at ``size``²."""
    h = -(-size // 2)
    rows, c = [("conv1", (32, h, h), False)], 32
    for i, (stride, cout) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        h = -(-h // stride)
        rows.append((f"dw{i}", (c, h, h), False))
        nxt = MOBILENET_V1_BLOCKS[i][0] if i < len(MOBILENET_V1_BLOCKS) else 1
        rows.append((f"pw{i}", (cout, h, h), nxt == 2 and h % 2 == 0))
        c = cout
    return rows


def check_bias_relu6_kernel():
    """K7 at the conv output of each of MobileNet-V1's 27 folded layers at
    ``BIAS_RELU6_SIZE``² and batch ``BIAS_RELU6_BATCH`` (channels-last, as
    cuDNN hands it over), with the next conv's zero edge where the layer
    writes it: one launch a call, the output bit-equal to
    ``bias_relu6_plain`` (torch's add, clamp and ``F.pad``, the eager
    layer's passes), with the same strides. Each is timed a call with CUDA
    events and by its kernel's device time under ``torch.profiler``,
    beside its bound (the conv output read, the activation written, at
    3.35 TB/s) and the plain passes' device time. Returns the sums over
    one chunk (each layer once) and each layer's numbers."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 143)
    rows = {}
    chunk = dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms"), 0.0)
    for name, chw, edge in bias_relu6_layers(BIAS_RELU6_SIZE):
        shape = (BIAS_RELU6_BATCH,) + chw
        y = (torch.randn(shape, generator=gen, device="cuda") * 3.0).contiguous(
            memory_format=torch.channels_last)
        b = torch.randn(chw[0], generator=gen, device="cuda")
        reset_launches()
        got = bn_act.bias_relu6(y, b, pad_next=edge)
        launches = kernel_launches()
        want = bn_act.bias_relu6_plain(y, b, pad_next=edge)
        torch.cuda.synchronize()
        if launches["bias_relu6"] != 1 or sum(launches.values()) != 1:
            raise AssertionError(f"bias_relu6 {name} {shape}: launches {launches}, not one K7")
        if not (torch.equal(got, want) and got.stride() == want.stride()):
            raise AssertionError(f"bias_relu6 {name} {shape}: not the eager passes' bits")
        ms = cuda_ms(lambda: bn_act.bias_relu6(y, b, pad_next=edge), 20)
        dev_ms, kernels = device_ms_per_call(lambda: bn_act.bias_relu6(y, b, pad_next=edge), 10,
                                             "k7_bias_relu6")
        plain_ms, plain_kernels = device_ms_per_call(
            lambda: bn_act.bias_relu6_plain(y, b, pad_next=edge), 10)
        if kernels != 1:
            raise AssertionError(f"bias_relu6 {name} {shape}: {kernels} K7 kernels a call")
        moved = nbytes(y, got)
        b_ms, _ = bound(moved, 0.0, "f32")
        key = f"{name} {'x'.join(map(str, shape))}{' pad_next' if edge else ''}"
        rows[key] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "plain_kernels": plain_kernels, "bound_ms": b_ms,
                     "share_of_bound": b_ms / dev_ms, "tb_per_s": moved / dev_ms / 1e9}
        print(f"bias_relu6 {key}: a call {ms:.4f} ms, device_ms={dev_ms:.4f} bound_ms="
              f"{b_ms:.4f} {b_ms / dev_ms:.3f} of the bound ({moved / dev_ms / 1e9:.2f} "
              f"TB/s); eager passes device {plain_ms:.4f} ms in {plain_kernels:.0f} kernels")
        for k, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                         ("bound_ms", b_ms)):
            chunk[k] += value
        del y, b, got, want
    torch.cuda.empty_cache()
    share = chunk["bound_ms"] / chunk["device_ms"]
    print(f"bias_relu6 per {BIAS_RELU6_BATCH}-face chunk at {BIAS_RELU6_SIZE}²: {len(rows)} "
          f"launches, device {chunk['device_ms']:.3f} ms (calls {chunk['ms']:.3f}), eager "
          f"passes device {chunk['plain_ms']:.3f}, bound {chunk['bound_ms']:.3f} ({share:.3f})")
    return {**chunk, "launches_per_chunk": len(rows), "bound_by": "bytes",
            "share_of_bound": share, "equal": True,
            "shape": f"MobileNet-V1's 27 folded layers of one {BIAS_RELU6_BATCH}-face chunk "
                     f"at {BIAS_RELU6_SIZE}², channels-last f32", "passes": rows}


def vit_path(rng):
    """The ViT-L embedder on the ``vit-enroll`` cell's path at full width:
    ``zoo.build_extractor("insightface_vit_l")`` (768 wide, 24 blocks, 8
    heads, 144 tokens, 512-d) from the zoo's seeded params with W_q and W_k
    scaled by ``VIT_QK_SCALE``, ``extract_batch`` of ``VIT_CALL`` crops at
    ``VIT_BATCH``. After a warm-up call the counters are set to 0 and one
    call must launch exactly 24 K5 a chunk and no other kernel of the
    library; ``VIT_CPU_ROWS`` of its rows against the CPU's extractor from
    the same params; then the call timed. Returns (launches, numbers)."""
    from hse_facerec_torch.models.vit import VIT_L, init_vit_params

    params = init_vit_params(torch.Generator().manual_seed(SEED + 137), **VIT_L)
    for i in range(VIT_L["depth"]):
        params[f"block{i}"]["qkv"]["kernel"][:, :2] *= VIT_QK_SCALE
    ex = zoo.build_extractor("insightface_vit_l", batch_size=VIT_BATCH, device="cuda",
                             params=params)
    imgs = np.stack(smooth_images(rng, VIT_CALL, ex.input_size))
    ex.extract_batch(imgs)
    torch.cuda.synchronize()
    reset_launches()
    feats = ex.extract_batch(imgs)
    launches = kernel_launches()
    chunks = -(-VIT_CALL // VIT_BATCH)
    others = {k: n for k, n in launches.items() if n and k != "attention"}
    if launches["attention"] != VIT_L["depth"] * chunks or others:
        raise AssertionError(f"vit: launches {launches}, not {VIT_L['depth']} K5 a chunk "
                             f"x {chunks} chunks")
    if feats.shape != (VIT_CALL, VIT_L["embedding_dim"]) or not np.all(np.isfinite(feats)):
        raise AssertionError(f"vit: malformed embeddings {feats.shape}")
    cpu = zoo.build_extractor("insightface_vit_l", batch_size=VIT_CPU_ROWS, device="cpu",
                              params=params).extract_batch(imgs[:VIT_CPU_ROWS])
    rel = np.linalg.norm(feats[:VIT_CPU_ROWS] - cpu, axis=1) / np.linalg.norm(cpu, axis=1)
    spread = float(np.abs(feats @ feats.T - np.eye(VIT_CALL)).max())
    print(f"vit: {VIT_CALL} crops at batch {VIT_BATCH}, launches "
          f"{json.dumps(launches)}; card against CPU on {VIT_CPU_ROWS} rows: relative "
          f"L2 {float(rel.max()):.3g}; largest |cosine| between two crops {spread:.4f}")
    if not rel.max() <= VIT_CPU_RTOL:
        raise AssertionError(f"vit: card against CPU {rel.max()} > {VIT_CPU_RTOL}")
    ms = median_ms(lambda: ex.extract_batch(imgs), VIT_REPEATS)
    numbers = {"ms": ms, "faces_per_s": VIT_CALL * 1e3 / ms, "cpu_rel_l2": float(rel.max()),
               "k5_per_call": launches["attention"]}
    print(f"vit: median {ms:.1f} ms a call = {numbers['faces_per_s']:.1f} faces/s over "
          f"{VIT_REPEATS} calls")
    del ex
    torch.cuda.empty_cache()
    return launches, numbers


def swin_config() -> dict:
    """The swin-enroll cell's configuration (``perfbench/configs``)."""
    return Benchmark(Path(__file__).resolve().parent).config(SWIN_CONFIG)


def window_launches(cfg: dict) -> list:
    """(map side R, heads, shift) of each K8 launch of one Swin forward, in
    launch order: one a block."""
    return [(r, heads, shift_of(i, r, cfg["window_size"]))
            for depth, r, _, heads, _ in perf_swin.stages(cfg) for i in range(depth)]


def window_sdpa(qkv, heads: int, shift: int, bias):
    """``F.scaled_dot_product_attention`` on the map's 7 x 7 windows, rolled
    and partitioned by torch, with the bias and the shifted windows' -100
    mask as one float ``attn_mask``: the library yardstick for K8. Returns
    the call (the roll and copies made once, outside it) and its output
    put back in the map's order, (B, R, R, H·D)."""
    b, r, _, width = qkv.shape
    w, d = attention.WINDOW, width // (3 * heads)
    n = r // w
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(b, n, w, n, w, 3, heads, d).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = x.reshape(3, b, n * n, heads, w * w, d).contiguous().unbind(0)
    mask = bias.expand(n * n, heads, w * w, w * w).clone()
    if shift:
        labels = attention.region_labels(r, w, shift).to(qkv.device)
        mask += torch.where(labels[:, :, None] != labels[:, None, :],
                            attention.MASK_VALUE, 0.0)[:, None]

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    o = call().reshape(b, n, n, heads, w, w, d).permute(0, 1, 4, 2, 5, 3, 6)
    o = o.reshape(b, r, r, heads * d)
    return call, torch.roll(o, (shift, shift), (1, 2)) if shift else o


def check_window_attention_kernel():
    """K8 against ``window_attention_plain`` in float64 at each distinct
    (R, heads, shift) of Swin-T's 12 launches a chunk, at the swin-enroll
    cell's batch ``SWIN_BATCH``: each call counted from 0 (exactly one
    launch, no other kernel of the library) and within ``WINATTN_RTOL`` of
    it relative to the output or 1. Each shape is timed a call with CUDA
    events and by its kernel's device time under ``torch.profiler`` (one
    kernel a call), beside its bound (``perfbench.swin.
    window_attention_work``: q, k and v read and the output written at
    3.35 TB/s, or 4 x 49 x C operations a token at the f32 peak), the plain
    version in f32 and ``window_sdpa``. Returns the sums over one chunk's
    12 launches and each shape's numbers."""
    cfg = swin_config()
    w, d = attention.WINDOW, attention.WINDOW_HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 149)
    rows, worst = {}, 0.0
    for (r, h, shift), (ops, moved) in zip(window_launches(cfg),
                                           perf_swin.window_attention_work(cfg, SWIN_BATCH)):
        name = f"{SWIN_BATCH}x{r}x{r}x{h} shift {shift}"
        if name in rows:
            rows[name]["per_chunk"] += 1
            continue
        qkv = torch.randn((SWIN_BATCH, r, r, 3 * h * d), generator=gen, device="cuda") * 1.5
        bias = torch.randn((h, w * w, w * w), generator=gen, device="cuda")

        def k8():
            return attention.window_attention(qkv, h, w, shift, bias)
        reset_launches()
        got = k8()
        launches = kernel_launches()
        want = attention.window_attention_plain(qkv.double(), h, w, shift, bias.double())
        err = float(((got.double() - want).abs() / want.abs().clamp_min(1.0)).max())
        worst = max(worst, err)
        if launches["window_attention"] != 1 or sum(launches.values()) != 1:
            raise AssertionError(f"window_attention {name}: launches {launches}, not one K8")
        if not err <= WINATTN_RTOL:
            raise AssertionError(f"window_attention {name}: max rel err {err} > {WINATTN_RTOL}")
        ms = cuda_ms(k8, 20)
        dev_ms, kernels = device_ms_per_call(k8, 10, "k8_window_attention")
        if kernels != 1:
            raise AssertionError(f"window_attention {name}: {kernels} K8 kernels a call")
        plain_ms = cuda_ms(lambda: attention.window_attention_plain(qkv, h, w, shift, bias), 5, 1)
        lib_call, lib_out = window_sdpa(qkv, h, shift, bias)
        lib_ms = cuda_ms(lib_call, 20)
        lib_err = float(((lib_out.double() - want).abs() / want.abs().clamp_min(1.0)).max())
        b_ms, b_by = bound(moved, ops, "f32")
        rows[name] = {"max_rel_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_max_rel_err": lib_err,
                      "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / dev_ms,
                      "per_chunk": 1}
        print(f"window_attention {name}: max_rel_err={err:.3g} a call {ms:.4f} ms, "
              f"device_ms={dev_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) {b_ms / dev_ms:.3f} of "
              f"the bound; plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (max_rel_err "
              f"{lib_err:.3g})")
        del qkv, bias, got, want, lib_call, lib_out
    torch.cuda.empty_cache()
    chunk = {key: sum(row["per_chunk"] * row[key] for row in rows.values())
             for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    chunk["launches_per_chunk"] = sum(row["per_chunk"] for row in rows.values())
    share = chunk["bound_ms"] / chunk["device_ms"]
    print(f"window_attention per {SWIN_BATCH}-face chunk: {chunk['launches_per_chunk']} "
          f"launches, device {chunk['device_ms']:.3f} ms (calls {chunk['ms']:.3f}), plain "
          f"{chunk['plain_ms']:.3f}, sdpa {chunk['library_ms']:.3f}, bound "
          f"{chunk['bound_ms']:.3f} ({share:.3f})")
    return {**chunk, "max_rel_err": worst, "bound_by": "bytes", "share_of_bound": share,
            "shape": f"Swin-T's 12 launches of one {SWIN_BATCH}-face chunk, f32",
            "shapes": rows}


def swin_path(rng):
    """The Swin-T embedder on the ``swin-enroll`` cell's path at full width:
    ``zoo.build_extractor("swin_t_face")`` from the cell's seeded weights
    (``perfbench.swin.weights``), ``extract_batch`` of ``SWIN_CALL`` crops
    at ``SWIN_BATCH``. After a warm-up call the counters are set to 0 and
    one call must launch exactly one K8 a block and chunk (48 a call) and no
    other kernel of the library, and call no ``torch.roll``;
    ``SWIN_CPU_ROWS`` of its rows against the CPU's extractor from the same
    weights; then the call timed. Returns (launches, numbers)."""
    cfg = swin_config()
    params = perf_swin.weights(cfg, SEED + 151, "cuda")
    ex = zoo.build_extractor("swin_t_face", batch_size=SWIN_BATCH, device="cuda",
                             params=params)
    imgs = np.stack(smooth_images(rng, SWIN_CALL, ex.input_size))
    ex.extract_batch(imgs)
    torch.cuda.synchronize()
    rolls, real_roll = [], torch.roll

    def counted_roll(*args, **kwargs):
        rolls.append(args[1:])
        return real_roll(*args, **kwargs)
    torch.roll = counted_roll
    try:
        reset_launches()
        feats = ex.extract_batch(imgs)
        launches = kernel_launches()
    finally:
        torch.roll = real_roll
    want = len(window_launches(cfg)) * -(-SWIN_CALL // SWIN_BATCH)
    others = {k: n for k, n in launches.items() if n and k != "window_attention"}
    if launches["window_attention"] != want or others or rolls:
        raise AssertionError(f"swin: launches {launches} and {len(rolls)} torch.roll calls, "
                             f"not {want} K8 and none")
    if feats.shape != (SWIN_CALL, cfg["embedding_dim"]) or not np.all(np.isfinite(feats)):
        raise AssertionError(f"swin: malformed embeddings {feats.shape}")
    cpu = zoo.build_extractor("swin_t_face", batch_size=SWIN_CPU_ROWS, device="cpu",
                              params=params).extract_batch(imgs[:SWIN_CPU_ROWS])
    rel = np.linalg.norm(feats[:SWIN_CPU_ROWS] - cpu, axis=1) / np.linalg.norm(cpu, axis=1)
    spread = float(np.abs(feats @ feats.T - np.eye(SWIN_CALL)).max())
    print(f"swin: {SWIN_CALL} crops at batch {SWIN_BATCH}, launches {json.dumps(launches)}, "
          f"no torch.roll; card against CPU on {SWIN_CPU_ROWS} rows: relative L2 "
          f"{float(rel.max()):.3g}; largest |cosine| between two crops {spread:.4f}")
    if not rel.max() <= SWIN_CPU_RTOL:
        raise AssertionError(f"swin: card against CPU {rel.max()} > {SWIN_CPU_RTOL}")
    ms = median_ms(lambda: ex.extract_batch(imgs), SWIN_REPEATS)
    numbers = {"ms": ms, "faces_per_s": SWIN_CALL * 1e3 / ms, "cpu_rel_l2": float(rel.max()),
               "k8_per_call": launches["window_attention"]}
    print(f"swin: median {ms:.1f} ms a call = {numbers['faces_per_s']:.1f} faces/s over "
          f"{SWIN_REPEATS} calls")
    del ex
    torch.cuda.empty_cache()
    return launches, numbers


def swin_phase() -> dict:
    """``check_window_attention_kernel`` then ``swin_path``, in one child
    process (``apart``): K8's profiled calls and the Swin-T embedder."""
    kernel = check_window_attention_kernel()
    launches, numbers = swin_path(np.random.RandomState(SEED + 153))
    return {"kernel": kernel, "launches": launches, "path": numbers}


def train_batch_np(rng, n: int, size: int, n_classes: int):
    """Seeded synthetic images in [-1, 1] and labels, on the host."""
    x = rng.rand(n, size, size, 3).astype(np.float32) * 2 - 1
    return x, rng.randint(0, n_classes, n)


def timed_train(trainer, x, y):
    """``TRAIN_WARMUP`` steps, then ``TRAIN_STEPS`` timed (host clock,
    synced); returns ms/step, the timed steps' losses, the peak memory and
    the launches of the timed steps."""
    for _ in range(TRAIN_WARMUP):
        trainer.train_batch(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.train_batch(x, y)["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = kernel_launches()
    return ms, losses, torch.cuda.max_memory_allocated() / 2 ** 30, launches


def train_profile_split(step, k3_launches: int,
                        label: str = "train step profile (bf16, batch 256)"):
    """One ``step()`` (a train step, or an age/gender pair, on a batch
    already on the card: the upload is timed apart) that launches K3
    ``k3_launches`` times, under ``torch.profiler``: device time grouped by
    the aten op that launched each kernel (``TRAIN_OP_GROUPS``; K3 by
    kernel name; the rest, mostly BN, ReLU6 and other elementwise and
    reduction passes, under "BN, ReLU6 and elementwise"), and the
    device-busy share: kernel time over the step's span on the card (CUDA
    events). A session that kept fewer K3 records than launches runs
    again (``profile_calls``); if the last one still did, the split is not
    measured."""
    rows, window_ms = profile_calls(step, 1, "warp_kernel", k3_launches)
    groups = {name: 0.0 for name, _ in TRAIN_OP_GROUPS}
    busy_ms, k3_ms, k3_records, kernels, rest = 0.0, 0.0, 0, [], {}
    for key, count, ms, on_device in rows:
        if on_device:
            busy_ms += ms
            kernels.append((ms, count, key[:140]))
            if "warp_kernel" in key:
                k3_ms += ms
                k3_records += count
        elif ms > 0:
            name = next((g for g, marks in TRAIN_OP_GROUPS
                         if any(key.startswith(m) for m in marks)), None)
            if name is not None:
                groups[name] += ms
            else:
                rest[key] = rest.get(key, 0.0) + ms
    if busy_ms == 0.0 or k3_records != k3_launches:
        print(f"{label}: the profiler kept {k3_records} K3 records of {k3_launches} "
              f"launches and {busy_ms:.3f} ms of kernels; split not measured")
        return None
    groups["K3 warp_kernel"] = k3_ms
    groups["BN, ReLU6 and elementwise"] = busy_ms - sum(groups.values())
    split = {k: {"ms": round(v, 3), "share": round(v / busy_ms, 4)}
             for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}
    print(f"{label}, on the card: " + json.dumps(split))
    for us, n, key in sorted(kernels, reverse=True)[:15]:
        print(f"  {us:9.3f} ms {n:4d}x {key}")
    print(f"{label}, the other ops by self device ms: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(rest.items(), key=lambda kv: -kv[1])[:12]}))
    print(f"{label}: kernels {busy_ms:.3f} ms of a {window_ms:.3f} ms span "
          f"(device busy {busy_ms / window_ms:.4f})")
    return {"split": split, "busy_share": busy_ms / window_ms, "span_ms": window_ms,
            "k3_records": k3_records}


def train_path():
    """``FaceIdTrainer`` at full width on the card: bf16 (the default) and
    float32 (parity numerics), timed, K3 launched every step; one profiled
    bf16 step; then the loss over ``LEARN_STEPS`` steps on one batch with
    augmentation off must fall."""
    rng = np.random.RandomState(SEED + 19)
    x, y = train_batch_np(rng, TRAIN_BATCH, TRAIN_SIZE, TRAIN_CLASSES)
    results, path_launches = {}, []
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        trainer = face_id.FaceIdTrainer(TRAIN_CLASSES, seed=SEED, device="cuda",
                                        compute_dtype=dtype)
        ms, losses, peak, launches = timed_train(trainer, x, y)
        path_launches.append(launches)
        per_step = launches["warp_batch"] / TRAIN_STEPS
        ips = TRAIN_BATCH / (ms / 1e3)
        print(f"train {label}: MobileNet-V1 1.0, {TRAIN_SIZE}², batch {TRAIN_BATCH}, "
              f"{TRAIN_CLASSES} classes: {ms:.3f} ms/step, {ips:.1f} img/s over "
              f"{TRAIN_STEPS} steps; losses {[round(v, 4) for v in losses]}; peak "
              f"memory {peak:.2f} GiB; K3 launches per step {per_step}")
        if per_step != 1:
            raise AssertionError(f"train {label}: K3 launched {per_step} times a step, "
                                 "not 1")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {label}: losses {losses}")
        results[label] = {"ms_per_step": ms, "img_per_s": ips, "peak_gib": peak}
        if label == "bf16":
            # the step's host-to-device upload of the f32 batch, then the
            # profile of a step on the batch already on the card
            upload_ms = cuda_ms(lambda: torch.as_tensor(x, device="cuda"), 3, 1)
            print(f"train: upload of the {x.nbytes / 1e6:.1f} MB f32 batch from "
                  f"pageable host memory {upload_ms:.3f} ms")
            results["upload_ms"] = upload_ms
            xd, yd = torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")
            results["profile"] = train_profile_split(lambda: trainer.train_batch(xd, yd), 1)
        del trainer
        torch.cuda.empty_cache()
    trainer = face_id.FaceIdTrainer(TRAIN_CLASSES, seed=SEED, augment=None,
                                    device="cuda")
    losses = [trainer.train_batch(x, y)["loss"] for _ in range(LEARN_STEPS)]
    print(f"train bf16, one batch, augmentation off: losses "
          f"{[round(v, 4) for v in losses]}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train: the loss did not fall on one batch: {losses}")
    del trainer
    torch.cuda.empty_cache()
    return path_launches, results


def rel_l2_t(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def train_cuda_vs_cpu():
    """One step at width 1.0 from the same numpy params on the card and on
    the CPU: the float32 loss (and the step's) within ``LOSS_REL``, every
    gradient within ``GRAD_REL`` in float64; then K3 against the CPU's
    plain version on the same images and mats."""
    params = to_numpy(init_mobilenet_params(torch.Generator().manual_seed(SEED + 23),
                                            n_classes=PARITY_CLASSES, device="cpu"))
    rng = np.random.RandomState(SEED + 29)
    x, y = train_batch_np(rng, PARITY_BATCH, PARITY_SIZE, PARITY_CLASSES)
    out = {}
    for dev in ("cuda", "cpu"):
        tp = to_torch(params, dev)
        leaves = face_id.trainable(tp)
        for _, t in leaves:
            t.requires_grad_(True)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        loss32, _ = face_id.loss_fn(tp, xt, yt, 4e-5, compute_dtype=torch.float32)
        loss64, _ = face_id.loss_fn(tp, xt, yt, 4e-5, compute_dtype=torch.float64)
        grads = torch.autograd.grad(loss64, [t for _, t in leaves])
        cfg = TrainConfig()
        opt = face_id.make_optimizer(cfg)
        step_params = to_torch(params, dev)
        state = opt.init(step_params)
        step = face_id.make_train_step(cfg, opt, augment=None, compute_dtype=torch.float32)
        step_loss = step(step_params, state, None, xt, yt)[2]["loss"]
        out[dev] = (float(loss32.detach()), float(step_loss), [g.cpu() for g in grads])
    worst = max(rel_l2_t(g, c) for g, c in zip(out["cuda"][2], out["cpu"][2]))
    loss_rel = max(abs(out["cuda"][i] - out["cpu"][i]) / abs(out["cpu"][i]) for i in (0, 1))
    mats = sample_affine(torch.Generator().manual_seed(SEED + 31), AugmentConfig(),
                         PARITY_BATCH, PARITY_SIZE, PARITY_SIZE)
    xw = torch.from_numpy(x)
    got = warp.warp_batch(xw.cuda(), mats.cuda()).cpu()
    want = warp.warp_batch_plain(xw, mats)
    warp_err = float((got - want).abs().max())
    print(f"train cuda vs cpu (width 1.0, batch {PARITY_BATCH}, {PARITY_SIZE}²): f32 loss "
          f"and step loss rel {loss_rel:.3g}; float64 gradients worst rel L2 "
          f"{worst:.3g} over {len(out['cpu'][2])} tensors; K3 vs the CPU plain "
          f"version max abs {warp_err:.3g}")
    if not (loss_rel <= LOSS_REL and worst <= GRAD_REL and warp_err <= WARP_ATOL):
        raise AssertionError(f"train cuda vs cpu: loss {loss_rel}, gradients {worst}, "
                             f"warp {warp_err}")



def timed_pairs(trainer, x, ages, genders):
    """``AG_WARMUP`` age/gender pairs, then ``AG_PAIRS`` timed (host clock,
    synced) on a batch already on the card; returns ms a pair, the last
    pair's losses, the peak memory and the launches of the timed pairs."""
    for _ in range(AG_WARMUP):
        trainer.age_step(x, ages)
        trainer.gender_step(x, genders)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(AG_PAIRS):
        m = {**trainer.age_step(x, ages), **trainer.gender_step(x, genders)}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / AG_PAIRS
    launches = kernel_launches()
    losses = [float(m["age_loss"]), float(m["gender_loss"])]
    return ms, losses, torch.cuda.max_memory_allocated() / 2 ** 30, launches


def age_gender_train_path():
    """``AgeGenderTrainer`` at the JAX bench's configuration: pairs of one
    age step and one gender step (augmentation on K3 in each), unfrozen at
    ``AG_LR`` and frozen, bf16 and float32, timed with exactly 2 K3
    launches a pair; the batch's upload timed apart; one profiled unfrozen
    bf16 pair split by launching op, with K3's share."""
    rng = np.random.RandomState(SEED + 89)
    x = rng.rand(AG_BATCH, AG_SIZE, AG_SIZE, 3).astype(np.float32)
    ages, genders = rng.randint(0, 100, AG_BATCH), rng.randint(0, 2, AG_BATCH)
    upload_ms = cuda_ms(lambda: torch.as_tensor(x, device="cuda"), 3, 1)
    print(f"age/gender: upload of the {x.nbytes / 1e6:.1f} MB f32 batch from pageable "
          f"host memory {upload_ms:.3f} ms")
    xd = torch.as_tensor(x, device="cuda")
    ad = torch.as_tensor(ages, device="cuda")
    gd = torch.as_tensor(genders, device="cuda")
    results, path_launches = {"upload_ms": upload_ms}, []
    for phase in ("unfrozen", "frozen"):
        for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            trainer = age_gender.AgeGenderTrainer(seed=SEED, device="cuda",
                                                  compute_dtype=dtype)
            if phase == "unfrozen":
                trainer.unfreeze(AG_LR)
            ms, losses, peak, launches = timed_pairs(trainer, xd, ad, gd)
            path_launches.append(launches)
            per_pair = launches["warp_batch"] / AG_PAIRS
            ips = AG_BATCH / (ms / 1e3)
            print(f"age/gender {phase} {label}: MobileNet-V1 1.0, {AG_SIZE}², batch "
                  f"{AG_BATCH}: {ms:.3f} ms a pair, {ips:.1f} img/s (each image once a "
                  f"pair) over {AG_PAIRS} pairs; last losses {[round(v, 4) for v in losses]}; "
                  f"peak memory {peak:.2f} GiB; K3 launches per pair {per_pair}")
            if per_pair != 2:
                raise AssertionError(f"age/gender {phase} {label}: K3 launched {per_pair} "
                                     "times a pair, not 2")
            if not all(np.isfinite(losses)):
                raise AssertionError(f"age/gender {phase} {label}: losses {losses}")
            results[f"{phase}_{label}"] = {"ms_per_pair": ms, "img_per_s": ips,
                                           "peak_gib": peak}
            if phase == "unfrozen" and label == "bf16":
                def pair():
                    trainer.age_step(xd, ad)
                    trainer.gender_step(xd, gd)
                results["profile"] = train_profile_split(
                    pair, 2, f"age/gender pair profile (unfrozen, bf16, batch {AG_BATCH})")
            del trainer
            torch.cuda.empty_cache()
    return path_launches, results


def _snapshot(params) -> dict:
    return {k: np.array(v) for k, v in flatten(to_numpy(params)).items()}


def age_gender_parity_run(params, dev, dtype, frozen: bool, task: str, x, labels, masks):
    """One ``task`` step on ``dev`` from the reference-layout ``params``,
    with the given dropout masks and augmentation off: the loss, the params
    before and after, and the task's first moments."""
    tp = to_torch(params, dev)
    opt = age_gender.make_optimizer(1e-3 if frozen else AG_LR, frozen, task=task)
    steps = dict(zip(age_gender.TASKS, age_gender.make_steps(
        opt, opt, freeze_backbone=frozen, compute_dtype=dtype)))
    state = opt.init(tp)
    before = _snapshot(tp)
    m = steps[task](tp, state, None, x.to(dev), labels.to(dev),
                    masks=tuple(mm.to(dev) for mm in masks))[2]
    return (float(m[f"{task}_loss"]), before, _snapshot(tp),
            flatten(to_numpy(state["mu"])))


def age_gender_chained_run(params, dev, dtype, frozen: bool, x, labels, masks) -> float:
    """An age step, then a gender step from the params it left, on
    ``dev``: the gender step's loss."""
    tp = to_torch(params, dev)
    opts = {t: age_gender.make_optimizer(1e-3 if frozen else AG_LR, frozen, task=t)
            for t in age_gender.TASKS}
    steps = dict(zip(age_gender.TASKS, age_gender.make_steps(
        opts["age"], opts["gender"], freeze_backbone=frozen, compute_dtype=dtype)))
    for task in ("age", "gender"):
        m = steps[task](tp, opts[task].init(tp), None, x.to(dev), labels[task].to(dev),
                        masks=tuple(mm.to(dev) for mm in masks))[2]
    return float(m["gender_loss"])


def age_gender_cuda_vs_cpu():
    """An age step and a gender step, each from the same params, inputs
    and dropout masks on the card and on the CPU, frozen and unfrozen, at
    width 1.0, batch 8, 64², augmentation off. float32: the losses within
    ``LOSS_REL``, the params' relative error printed (in float32 the two
    devices' 1e-7 differences flip ReLU6's gradient mask at ties, and
    Adam's first step moves a parameter by ±lr whatever its gradient's
    size). float64: the params within ``AG_STEP_REL`` where the step's
    first moments are above 1e-4 of their tensor's largest. On the card
    the frozen backbone and the idle head stay bit-identical. Then the
    gender loss after an age step, chained on each device, printed and not
    bounded: the age step's ±lr moves of noise-level elements differ
    between the devices, so the gender step starts from different params
    (unfrozen float32, 1.7e-5 apart on an H100 run)."""
    backbone = to_numpy(init_mobilenet_params(torch.Generator().manual_seed(SEED + 97),
                                              device="cpu"))
    heads = to_numpy(age_gender.init_head_params(torch.Generator().manual_seed(SEED + 98),
                                                 device="cpu"))
    params = {"backbone": backbone, **heads}
    rng = np.random.RandomState(SEED + 99)
    n, size = AG_PARITY
    x = torch.from_numpy(rng.rand(n, size, size, 3).astype(np.float32))
    labels = {"age": torch.from_numpy(rng.randint(0, 100, n)),
              "gender": torch.from_numpy(rng.randint(0, 2, n).astype(np.float32))}
    masks = tuple(torch.from_numpy(rng.rand(n, d) < 0.5) for d in (1024, 256))
    report = {}
    for frozen in (True, False):
        phase = "frozen" if frozen else "unfrozen"
        for label, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            for task, other in (("age", "gender"), ("gender", "age")):
                (g_loss, before, g_after, _), (c_loss, _, c_after, c_mu) = (
                    age_gender_parity_run(params, dev, dtype, frozen, task, x, labels[task],
                                          masks) for dev in ("cuda", "cpu"))
                moved = {k for k in before if not np.array_equal(before[k], g_after[k])}
                if any(k.startswith(other + "/") for k in moved):
                    raise AssertionError(f"age/gender {phase} {label}: the {task} step moved "
                                         f"the {other} head on the card")
                if frozen and any(k.startswith("backbone/") for k in moved):
                    raise AssertionError(f"age/gender {phase} {label}: a frozen {task} step "
                                         "moved the backbone on the card")
                loss_rel = abs(g_loss - c_loss) / abs(c_loss)
                rel = {k: rel_l2_t(torch.from_numpy(g_after[k]), torch.from_numpy(c_after[k]))
                       for k in c_after}
                worst = max(rel, key=rel.get)
                big_rel = 0.0
                for k, mu in c_mu.items():
                    big = np.abs(mu) > 1e-4 * np.abs(mu).max()
                    if big.any():
                        big_rel = max(big_rel, rel_l2_t(torch.from_numpy(g_after[k][big]),
                                                        torch.from_numpy(c_after[k][big])))
                report[f"{phase}_{label}_{task}"] = {
                    "loss_rel": loss_rel, "params_rel": rel[worst],
                    "params_rel_big_moments": big_rel, "moved": len(moved)}
                print(f"age_gender cuda vs cpu ({phase}, {label}, {task} step, width 1.0, "
                      f"batch {n}, {size}²): loss {g_loss:.7g} vs {c_loss:.7g}, rel "
                      f"{loss_rel:.3g}; params' worst rel L2 {rel[worst]:.3g} ({worst}), "
                      f"{big_rel:.3g} where the moments are above 1e-4 of the largest; "
                      f"{len(moved)} tensors moved on the card, the {other} head"
                      + (" and the backbone" if frozen else "") + " bit-identical")
                if not loss_rel <= LOSS_REL:
                    raise AssertionError(f"age_gender cuda vs cpu {phase} {label} {task}: "
                                         f"loss {loss_rel}")
                if label == "f64" and not big_rel <= AG_STEP_REL:
                    raise AssertionError(f"age_gender cuda vs cpu {phase} {label} {task}: "
                                         f"params {big_rel}")
            g_loss, c_loss = (age_gender_chained_run(params, dev, dtype, frozen, x, labels,
                                                     masks) for dev in ("cuda", "cpu"))
            chain_rel = abs(g_loss - c_loss) / abs(c_loss)
            report[f"{phase}_{label}_chained_gender_loss_rel"] = chain_rel
            print(f"age_gender cuda vs cpu ({phase}, {label}, chained, width 1.0, batch "
                  f"{n}, {size}²): the gender loss after an age step {g_loss:.7g} vs "
                  f"{c_loss:.7g}, rel {chain_rel:.3g} (printed, not bounded)")
    return report


def align_path(gpu, images):
    """The card's detector's landmarks through ``landmarks_from_detector``
    and ``align_faces`` at ``ALIGN_SIZE``², on the card and on the CPU
    (within ``ALIGN_ATOL``); then faces/s at a batch of ``ALIGN_BATCH``
    faces of one photo (its faces' landmarks, each with seeded sub-pixel
    jitter), CUDA events."""
    faces, worst, first, equal, values = 0, 0.0, None, 0, 0
    for img in images:
        boxes, points = gpu.detector.detect(img)
        if len(boxes) == 0:
            continue
        lmk = landmarks_from_detector(points.T)
        got = align_faces(img, lmk, ALIGN_SIZE, device="cuda").cpu()
        want = align_faces(img, lmk, ALIGN_SIZE, device="cpu")
        worst = max(worst, float((got - want).abs().max()))
        equal += int((got == want).sum())
        values += want.numel()
        faces += len(boxes)
        first = first or (img, lmk)
    if faces == 0:
        raise AssertionError("align: the detector found no face on the smoke's photos")
    img, lmk = first
    rng = np.random.RandomState(SEED + 101)
    batch = (np.resize(lmk, (ALIGN_BATCH, 5, 2))
             + rng.uniform(-0.5, 0.5, (ALIGN_BATCH, 5, 2))).astype(np.float32)
    img_d = torch.as_tensor(img, device="cuda")
    lmk_d = torch.as_tensor(batch, device="cuda")
    ms = cuda_ms(lambda: align_faces(img_d, lmk_d, ALIGN_SIZE, device="cuda"), 10)
    fps = ALIGN_BATCH / (ms / 1e3)
    print(f"align: {faces} faces on {len(images)} photos, {ALIGN_SIZE}², card vs CPU max "
          f"abs err {worst:.3g} (0-255), {equal / values:.6f} of values bit-equal; a "
          f"batch of {ALIGN_BATCH} faces {ms:.3f} ms = {fps:.1f} faces/s")
    if not worst <= ALIGN_ATOL:
        raise AssertionError(f"align: card vs CPU max abs err {worst} > {ALIGN_ATOL}")
    return {"faces": faces, "max_abs_err": worst, "bit_equal_share": equal / values,
            "batch_ms": ms, "faces_per_s": fps}


def cascade_path(images, rng, tmp: str):
    """A synthetic LBP cascade in the format of OpenCV's
    ``lbpcascade_frontalface.xml`` (``testing.write_lbp_cascade``: a 24x24
    window, 20 stages, thresholds set on the smoke's photos) through
    ``CascadeFallbackDetector`` on the card and on the CPU, on those photos
    and two fresh ones: the boxes equal, the detect contract held; ms a
    photo on each (host clock; the card's the median of
    ``CASCADE_REPEATS`` passes)."""
    t0 = time.perf_counter()
    xml = write_lbp_cascade(os.path.join(tmp, "lbpcascade_synthetic.xml"), images,
                            seed=SEED)
    write_s = time.perf_counter() - t0
    photos = list(images) + smooth_images(rng, 2)
    gpu_det = CascadeFallbackDetector(xml, device="cuda")
    cpu_det = CascadeFallbackDetector(xml, device="cpu")
    t0 = time.perf_counter()
    cpu_out = [cpu_det.detect(img) for img in photos]
    cpu_ms = (time.perf_counter() - t0) * 1e3 / len(photos)
    gpu_out = [gpu_det.detect(img) for img in photos]       # the first pass warms up
    passes = []
    for _ in range(CASCADE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for img in photos:
            gpu_det.detect(img)
        passes.append((time.perf_counter() - t0) * 1e3 / len(photos))
    gpu_ms = float(np.median(passes))
    groups = []
    for (gb, gp), (cb, cp) in zip(gpu_out, cpu_out):
        if gb.shape != (len(gb), 5) or gp.shape != (10, len(gb)) or gp.any():
            raise AssertionError(f"cascade: detect returned {gb.shape}, {gp.shape}")
        if not np.array_equal(gb, cb):
            raise AssertionError("cascade: the card's boxes differ from the CPU's")
        groups.append(len(gb))
    if sum(groups[:len(images)]) == 0:
        raise AssertionError("cascade: no group on the photos the cascade was set on")
    print(f"cascade: synthetic 20-stage LBP cascade (written and set in {write_s:.2f} s); "
          f"{len(photos)} photos at {photos[0].shape[1]}x{photos[0].shape[0]}: groups "
          f"{groups}, boxes equal card vs CPU; {gpu_ms:.3f} ms/photo on the card (median "
          f"of {CASCADE_REPEATS} passes {[round(v, 3) for v in passes]}), {cpu_ms:.3f} "
          "ms/photo on the CPU")
    return {"groups": groups, "ms_per_photo": gpu_ms, "cpu_ms_per_photo": cpu_ms}

# -- the multi-device slice -----------------------------------------------------


def mesh_of(shape=None, names=("data",)):
    """A mesh of ``MESH_SHARDS`` virtual shards on the one card."""
    return make_mesh(shape, names, ["cuda"] * MESH_SHARDS)


def synced_ms(fn, calls: int) -> float:
    """Mean host ms of ``calls`` synced calls of ``fn`` (no warm-up)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def launch_delta(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def mesh_gallery_path(mesh):
    """The gallery sharded over 4 virtual shards at 1,048,576 x 1024-d int8:
    a 2048-probe ``KNNIdentifier(quantized=True, mesh=...)`` evaluation
    (K2b once a shard) and ``MESH_QUERIES`` 16-probe ``EnrollmentGallery
    (mesh=...).identify_many`` queries (K2b once a shard, the ranking state
    placed once), each against the same object on one device (K2b; K2c for
    the gallery): predictions and labels equal, distances within
    ``MESH_TOL``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 107)
    g = unit_rows(gen, MESH_GALLERY_N, MESH_DIM)
    labels = np.arange(MESH_GALLERY_N) // 4
    pick = torch.randint(0, MESH_GALLERY_N, (MESH_EVAL,), generator=gen, device="cuda")
    probes = g[pick] + 0.02 * torch.randn((MESH_EVAL, MESH_DIM), generator=gen,
                                          device="cuda")
    truth = labels[pick.cpu().numpy()]
    shards = mesh.size
    sharded = KNNIdentifier(quantized=True, mesh=mesh).fit(g, labels)
    single = KNNIdentifier(quantized=True, device="cuda").fit(g, labels)
    want = single.predict(probes)                   # warm-up of both
    sharded.predict(probes)
    torch.cuda.synchronize()
    reset_launches()
    got = sharded.predict(probes)
    torch.cuda.synchronize()
    launches = kernel_launches()
    if launches["knn_int8q"] != shards:
        raise AssertionError(f"sharded evaluation: K2b launched {launches['knn_int8q']} "
                             f"times, want once a shard ({shards})")
    if not np.array_equal(got, want):
        raise AssertionError("sharded evaluation: predictions differ from one device's")
    acc = float(np.mean(got == truth))
    eval_ms = median_ms(lambda: sharded.predict(probes), 3)
    eval_single_ms = median_ms(lambda: single.predict(probes), 3)
    del sharded, single

    g_host, p_host = g.cpu().numpy(), probes.cpu().numpy()
    del g, probes
    torch.cuda.empty_cache()
    names = [f"id{i}" for i in labels]
    stores = {"mesh": EnrollmentGallery(mesh=mesh), "single": EnrollmentGallery(device="cuda")}
    answers, place_ms, query_ms = {}, {}, {}
    for key, store in stores.items():
        store.enroll_many(names, g_host)
        place_ms[key] = synced_ms(lambda: store.identify_many(p_host[:MESH_QUERY]), 1)
        before = kernel_launches()
        answers[key], query_ms[key] = [], []
        for i in range(MESH_QUERIES):
            t0 = time.perf_counter()
            answers[key] += store.identify_many(p_host[i * MESH_QUERY:(i + 1) * MESH_QUERY])
            query_ms[key].append((time.perf_counter() - t0) * 1e3)
        delta = launch_delta(before)
        if key == "mesh":
            for k, v in delta.items():
                launches[k] += v
            if delta["knn_int8q"] != shards * MESH_QUERIES:
                raise AssertionError(f"mesh gallery: K2b launched {delta['knn_int8q']} "
                                     f"times for {MESH_QUERIES} queries over {shards} shards")
    worst = 0.0
    for (l1, d1, n1), (l2, d2, n2) in zip(answers["mesh"], answers["single"]):
        if (l1, n1) != (l2, n2):
            raise AssertionError(f"mesh gallery: {n1} vs one device's {n2}")
        worst = max(worst, abs(d1 - d2))
    if worst > MESH_TOL["distance"] or stores["mesh"].placements != 1:
        raise AssertionError(f"mesh gallery: distances {worst} apart, "
                             f"{stores['mesh'].placements} placements")
    numbers = {"eval_ms": eval_ms, "eval_single_ms": eval_single_ms, "eval_accuracy": acc,
               "query_ms": float(np.median(query_ms["mesh"])),
               "query_single_ms": float(np.median(query_ms["single"])),
               "queries_ms": query_ms,
               "first_query_ms": place_ms["mesh"], "first_query_single_ms": place_ms["single"],
               "distance_max_abs_diff": worst}
    print(f"mesh gallery {MESH_GALLERY_N} x {MESH_DIM}-d int8 over {shards} virtual "
          f"shards: {MESH_EVAL}-probe evaluation {eval_ms:.3f} ms (one device "
          f"{eval_single_ms:.3f}), accuracy {acc}, predictions equal; {MESH_QUERY}-probe "
          f"query median {numbers['query_ms']:.3f} ms (one device, K2c, "
          f"{numbers['query_single_ms']:.3f}; each {json.dumps(query_ms)}), "
          f"first query with the placement {place_ms['mesh']:.1f} ms (one device "
          f"{place_ms['single']:.1f}); labels equal, distances {worst:.3g} apart, one "
          f"placement; launches {json.dumps(launches)}")
    del stores
    return launches, numbers


def mesh_face_diffs(got, want, label: str) -> dict:
    """Boxes equal, ages and identity within ``MESH_TOL`` (the JAX dry
    run's bounds); returns the worst differences."""
    if [len(f) for f in got] != [len(f) for f in want]:
        raise AssertionError(f"{label}: faces {[len(f) for f in got]} vs "
                             f"{[len(f) for f in want]}")
    worst = {"age": 0.0, "gender": 0.0, "identity": 0.0}
    for a, b in ((a, b) for fa, fb in zip(got, want) for a, b in zip(fa, fb)):
        if a.bbox != b.bbox:
            raise AssertionError(f"{label}: box {a.bbox} vs {b.bbox}")
        worst["age"] = max(worst["age"], abs(a.age - b.age))
        worst["gender"] = max(worst["gender"], abs(a.gender_prob - b.gender_prob))
        worst["identity"] = max(worst["identity"],
                                float(np.abs(a.identity - b.identity).max()))
    if worst["age"] > MESH_TOL["age"] or worst["identity"] > MESH_TOL["identity"]:
        raise AssertionError(f"{label}: {worst}")
    return worst


def mesh_analyze_path(mesh, mtcnn_params, mh_params, rng):
    """Mesh ``analyze_batch`` at batch 8 (2 lanes a shard), 640x480, the
    analyzer's defaults: exactly 3 K1 launches a shard, no lane re-run,
    equal to the one-device analyzer's answers; both timed."""
    photos = np.stack(smooth_images(rng, BATCH))
    sharded = FacialAnalyzer(mtcnn_params, mh_params, mesh=mesh)
    single = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    sharded.analyze_batch(photos)                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    fallbacks = []
    counting(sharded, "analyze", fallbacks)
    got = sharded.analyze_batch(photos)
    torch.cuda.synchronize()
    launches = kernel_launches()
    del sharded.analyze
    if fallbacks or launches["crop_resize"] != 3 * mesh.size:
        raise AssertionError(f"mesh analyze_batch: {len(fallbacks)} lanes re-ran, K1 "
                             f"launched {launches['crop_resize']} times (want 3 x "
                             f"{mesh.size})")
    worst = mesh_face_diffs(got, single.analyze_batch(photos), "mesh analyze_batch")
    ms = median_ms(lambda: sharded.analyze_batch(photos), 5)
    single_ms = median_ms(lambda: single.analyze_batch(photos), 5)
    print(f"mesh analyze_batch x{BATCH} 640x480 over {mesh.size} virtual shards: "
          f"{ms:.3f} ms a batch (one device {single_ms:.3f}); faces "
          f"{[len(f) for f in got]}, worst {json.dumps(worst)}; K1 launches "
          f"{launches['crop_resize']} ({launches['crop_resize'] // mesh.size} a shard)")
    return launches, {"ms": ms, "single_ms": single_ms, "worst": worst,
                      "k1_per_shard": launches["crop_resize"] / mesh.size}


def mesh_embed_path(mesh, mh_params, rng):
    """``EmbeddingExtractor(mesh=...)`` (the zoo's ``agegender_identity``,
    params replicated) at 224², batch 1024, against one device's."""
    images = rng.randint(0, 256, (MESH_EMBED, 224, 224, 3)).astype(np.uint8)
    ex = zoo.build_extractor("agegender_identity", batch_size=MESH_EMBED, params=mh_params,
                             mesh=mesh)
    one = zoo.build_extractor("agegender_identity", batch_size=MESH_EMBED,
                              params=mh_params, device="cuda")
    reset_launches()
    got = ex.extract_batch(images)
    launches = kernel_launches()
    want = one.extract_batch(images)
    err = float(np.abs(got - want).max())
    if got.shape != (MESH_EMBED, 1024) or not err <= MESH_TOL["embed"]:
        raise AssertionError(f"mesh embed: shape {got.shape}, max abs err {err}")
    ms = median_ms(lambda: ex.extract_batch(images), 3)
    single_ms = median_ms(lambda: one.extract_batch(images), 3)
    print(f"mesh embed 224², batch {MESH_EMBED} over {mesh.size} virtual shards: "
          f"{ms:.3f} ms ({MESH_EMBED / ms * 1e3:.1f} img/s; one device {single_ms:.3f} "
          f"ms), max abs err {err:.3g}")
    del ex, one
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "single_ms": single_ms, "max_abs_err": err}


def replicas_identical(placed) -> bool:
    return all(torch.equal(a, b) for path in placed.groups
               for c in placed.replicas(path)[1:]
               for a, b in zip(train_step._tensors(c),
                               train_step._tensors(placed.replicas(path)[0])))


def mesh_face_id_path():
    """``make_sharded_face_id_trainer`` on a (2, 2) mesh at the JAX bench's
    configuration (224², batch 256, 9131 classes, no augmentation), bf16
    and float32, beside the one-device step from the same params; the
    float32 losses of the first step within ``MESH_TOL``; replicas
    bit-identical after every step; the classifier split over ``model``."""
    mesh = mesh_of(MESH_TRAIN_SHAPE, ("data", "model"))
    x, y = train_batch_np(np.random.RandomState(SEED + 109), TRAIN_BATCH, TRAIN_SIZE,
                          TRAIN_CLASSES)
    xd, yd = torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")
    init = to_numpy(init_mobilenet_params(torch.Generator().manual_seed(SEED + 1),
                                          n_classes=TRAIN_CLASSES, device="cpu"))
    cfg = TrainConfig()
    results = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        placed, state, step = make_sharded_face_id_trainer(
            mesh, TRAIN_CLASSES, cfg, params=init, compute_dtype=dtype)
        first = float(step(placed, state, None, xd, yd)[2]["loss"])
        pieces = [p["kernel"].shape[0] for p in placed.tree["classifier"].values()]
        if not replicas_identical(placed) or sum(pieces) != TRAIN_CLASSES:
            raise AssertionError(f"sharded face-ID {label}: replicas differ or the "
                                 f"classifier pieces are {pieces}")
        ms = synced_ms(lambda: step(placed, state, None, xd, yd), MESH_STEPS)
        if not replicas_identical(placed):
            raise AssertionError(f"sharded face-ID {label}: replicas differ")
        del placed, state, step
        torch.cuda.empty_cache()
        tree = to_torch(init, "cuda")
        opt = face_id.make_optimizer(cfg)
        ostate = opt.init(tree)
        one = face_id.make_train_step(cfg, opt, augment=None, compute_dtype=dtype)
        want = float(one(tree, ostate, None, xd, yd)[2]["loss"])
        single_ms = synced_ms(lambda: one(tree, ostate, None, xd, yd), MESH_STEPS)
        del tree, ostate, one
        torch.cuda.empty_cache()
        rel = abs(first - want) / abs(want)
        if not np.isfinite(first) or (dtype == torch.float32 and rel > MESH_TOL["loss"]):
            raise AssertionError(f"sharded face-ID {label}: loss {first} vs {want}")
        print(f"sharded face-ID {label} on a {MESH_TRAIN_SHAPE} mesh of virtual shards, "
              f"{TRAIN_SIZE}², batch {TRAIN_BATCH}, {TRAIN_CLASSES} classes split "
              f"{pieces}: {ms:.3f} ms/step (one device {single_ms:.3f}); first loss "
              f"{first:.6f} vs {want:.6f} (rel {rel:.3g}); replicas bit-identical")
        results[label] = {"ms": ms, "single_ms": single_ms, "loss_rel": rel}
    return results


def mesh_face_id_trainer_path():
    """``FaceIdTrainer(mesh=...)`` over 4 data shards, augmentation on (K3
    once a shard a step), float32, against the one-device trainer of the
    same seed: the first step's loss within ``MESH_TOL``."""
    mesh = mesh_of()
    x, y = train_batch_np(np.random.RandomState(SEED + 113), TRAIN_BATCH, TRAIN_SIZE,
                          TRAIN_CLASSES)
    out = {}
    for key, where in (("mesh", {"mesh": mesh}), ("single", {"device": "cuda"})):
        trainer = face_id.FaceIdTrainer(TRAIN_CLASSES, seed=SEED,
                                        compute_dtype=torch.float32, **where)
        reset_launches()
        first = trainer.train_batch(x, y)["loss"]
        ms = synced_ms(lambda: trainer.train_batch(x, y), MESH_STEPS)
        launches = kernel_launches()
        out[key] = (first, ms, launches)
        del trainer
        torch.cuda.empty_cache()
    per_step = out["mesh"][2]["warp_batch"] / (MESH_STEPS + 1)
    rel = abs(out["mesh"][0] - out["single"][0]) / abs(out["single"][0])
    if per_step != mesh.size or rel > MESH_TOL["loss"]:
        raise AssertionError(f"FaceIdTrainer(mesh): K3 {per_step} a step, loss "
                             f"{out['mesh'][0]} vs {out['single'][0]}")
    print(f"FaceIdTrainer(mesh) f32 over {mesh.size} virtual shards, {TRAIN_SIZE}², batch "
          f"{TRAIN_BATCH}: {out['mesh'][1]:.3f} ms/step (one device {out['single'][1]:.3f}); "
          f"first loss {out['mesh'][0]:.6f} vs {out['single'][0]:.6f} (rel {rel:.3g}); "
          f"K3 launches per step {per_step}")
    return out["mesh"][2], {"ms": out["mesh"][1], "single_ms": out["single"][1],
                            "loss_rel": rel, "k3_per_step": per_step}


def mesh_age_gender_path():
    """The sharded age/gender pair over 4 shards (both axes flattened) at
    batch 256, 224², unfrozen, float32, augmentation on (K3 once a shard a
    step), against ``make_steps`` on one device from the same params and
    generator seed: each task's first loss from the initial params within
    ``MESH_TOL``; pairs timed."""
    mesh = mesh_of((2, 2), ("data", "model"))
    rng = np.random.RandomState(SEED + 127)
    x = torch.as_tensor(rng.rand(AG_BATCH, AG_SIZE, AG_SIZE, 3).astype(np.float32),
                        device="cuda")
    labels = {"age": torch.as_tensor(rng.randint(0, 100, AG_BATCH), device="cuda"),
              "gender": torch.as_tensor(rng.randint(0, 2, AG_BATCH), device="cuda")}
    init = to_numpy({"backbone": init_mobilenet_params(torch.Generator().manual_seed(SEED + 1),
                                                       device="cpu"),
                     **age_gender.init_head_params(torch.Generator().manual_seed(SEED + 2),
                                                   device="cpu")})
    aug = AugmentConfig()

    def sharded():
        placed, age_os, gender_os, age_step, gender_step, _ = make_sharded_age_gender_trainer(
            mesh, lr=AG_LR, compute_dtype=torch.float32, params=init, augment=aug)
        return placed, {"age": (age_step, age_os), "gender": (gender_step, gender_os)}

    def single():
        opts = {t: age_gender.make_optimizer(AG_LR, False, task=t) for t in ("age", "gender")}
        tree = to_torch(init, "cuda")
        steps = age_gender.make_steps(opts["age"], opts["gender"], compute_dtype=torch.float32,
                                      augment=aug)
        return tree, {t: (s, opts[t].init(tree)) for t, s in zip(("age", "gender"), steps)}

    out = {}
    for key, build_fn in (("mesh", sharded), ("single", single)):
        losses = {}
        for task in ("age", "gender"):         # each task's first step from init
            params, steps = build_fn()
            fn, state = steps[task]
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            y = labels[task] if task == "age" else labels[task].to(torch.float32)
            reset_launches()
            losses[task] = float(fn(params, state, gen, x, y)[2][f"{task}_loss"])
            k3 = kernel_launches()["warp_batch"]
            if k3 != (mesh.size if key == "mesh" else 1):
                raise AssertionError(f"{key} {task} step: K3 launched {k3} times")
            if task == "gender":
                def pair():
                    steps["age"][0](params, steps["age"][1], gen, x, labels["age"])
                    fn(params, state, gen, x, labels["gender"].to(torch.float32))
                reset_launches()
                ms = synced_ms(pair, MESH_PAIRS)
                launches = kernel_launches()
        out[key] = {"losses": losses, "ms": ms, "launches": launches}
        del params, steps, fn, state
        torch.cuda.empty_cache()
    rel = {t: abs(out["mesh"]["losses"][t] - out["single"]["losses"][t])
           / abs(out["single"]["losses"][t]) for t in ("age", "gender")}
    per_pair = out["mesh"]["launches"]["warp_batch"] / MESH_PAIRS
    if per_pair != 2 * mesh.size or max(rel.values()) > MESH_TOL["loss"]:
        raise AssertionError(f"sharded age/gender: K3 {per_pair} a pair, losses "
                             f"{out['mesh']['losses']} vs {out['single']['losses']}")
    print(f"sharded age/gender pair f32 unfrozen over {mesh.size} virtual shards, "
          f"{AG_SIZE}², batch {AG_BATCH}: {out['mesh']['ms']:.3f} ms a pair (one device "
          f"{out['single']['ms']:.3f}); first losses {out['mesh']['losses']} vs "
          f"{out['single']['losses']} (rel {json.dumps(rel)}); K3 launches per pair "
          f"{per_pair}")
    return out["mesh"]["launches"], {"ms": out["mesh"]["ms"], "single_ms": out["single"]["ms"],
                                     "loss_rel": rel, "k3_per_pair": per_pair}


def multichip_path(mtcnn_params, mh_params):
    """The multi-device slice on the one card: every sharded path over
    ``MESH_SHARDS`` virtual shards (``make_mesh(devices=["cuda"] * 4)``)
    beside its one-device run, then ``dryrun_multichip(4)``. Virtual shards
    on one card measure the mesh's bookkeeping and extra launches; they
    say nothing of scaling over cards."""
    mesh = mesh_of()
    path_launches, numbers = [], {}
    for name, fn in (
            ("gallery", lambda: mesh_gallery_path(mesh)),
            ("analyze_batch", lambda: mesh_analyze_path(
                mesh, mtcnn_params, mh_params, np.random.RandomState(SEED + 7))),
            ("embed", lambda: mesh_embed_path(mesh, mh_params,
                                              np.random.RandomState(SEED + 131))),
            ("face_id_trainer", mesh_face_id_trainer_path),
            ("age_gender", mesh_age_gender_path)):
        launches, numbers[name] = fn()
        path_launches.append(launches)
        torch.cuda.empty_cache()
    reset_launches()
    numbers["face_id_dp_tp"] = mesh_face_id_path()
    path_launches.append(kernel_launches())
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_SHARDS, device="cuda")
    launches = kernel_launches()
    path_launches.append(launches)
    numbers["dryrun_s"] = time.perf_counter() - t0
    if launches["crop_resize"] <= 0 or launches["knn_int8q"] <= 0:
        raise AssertionError(f"dryrun_multichip launched {json.dumps(launches)}")
    print(f"dryrun_multichip({MESH_SHARDS}) on the card: {numbers['dryrun_s']:.1f} s, "
          f"mesh {dry['mesh']}, launches {json.dumps(launches)}")
    return path_launches, numbers


def fp32_flags() -> dict:
    """torch's global flags, as the tiers set them."""
    return {"matmul": torch.backends.cuda.matmul.fp32_precision,
            "cudnn_conv": torch.backends.cudnn.conv.fp32_precision}


def event_median_ms(fn, repeats: int = TIER_REPEATS) -> float:
    """Median of ``repeats`` calls of ``fn`` timed by CUDA events (after one
    untimed call), host gaps inside a call included."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def tier_flag_check() -> dict:
    """The ``fp32_precision`` flags govern the card: a conv (cuDNN) and a
    matmul (cuBLAS) of O(1) operands at each tier against float64. Each
    TF32 tier must be ``TIER_TF32_FACTOR`` times further off than
    "highest". Returns the relative errors."""
    from hse_facerec_torch.numerics import precision_scope

    gen = torch.Generator(device="cuda").manual_seed(SEED + 131)
    x = torch.randn(16, 64, 56, 56, device="cuda", generator=gen)
    w = torch.randn(128, 64, 3, 3, device="cuda", generator=gen) / 24.0
    a = torch.randn(1024, 1024, device="cuda", generator=gen)
    b = torch.randn(1024, 1024, device="cuda", generator=gen) / 32.0
    refs = {"conv": F.conv2d(x.double(), w.double(), padding=1), "matmul": a.double() @ b.double()}
    errs = {}
    for tier in TIERS:
        with precision_scope(tier):
            got = {"conv": F.conv2d(x, w, padding=1), "matmul": a @ b}
        errs[tier] = {k: float((got[k].double() - refs[k]).norm() / refs[k].norm())
                      for k in refs}
    for tier in ("high", "default"):
        for k in refs:
            if not errs[tier][k] > TIER_TF32_FACTOR * errs["highest"][k]:
                raise AssertionError(f"tiers: {k} at {tier!r} is not TF32 on the card: {errs}")
    print("tiers: the fp32_precision flags govern the card (relative error against "
          "float64): " + json.dumps(errs))
    return errs


def faces_bits(faces_lists) -> list:
    """Every number of per-image FaceResult lists, for bit comparison."""
    return [[(f.bbox, f.raw_bbox, f.score, f.age, f.gender_prob,
              f.identity.tobytes(), np.asarray(f.landmarks).tobytes()) for f in faces]
            for faces in faces_lists]


def tier_fault_check(mtcnn_params, mh_params, images, batch, ex, embed_imgs) -> dict:
    """The default analyzer (``analyze`` on each photo, ``analyze_batch`` on
    a batch of 8) and ``build_extractor("vgg2_mobilenet")`` from torch's own
    flags, then after ``set_parity_numerics``: every answer bit-equal. The
    flags are put back after."""
    an = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")

    def run():
        return (faces_bits([an.analyze(img) for img in images]),
                faces_bits(an.analyze_batch(batch)), ex.extract_batch(embed_imgs))

    start = fp32_flags()
    own = run()
    set_parity_numerics()
    parity = run()
    torch.backends.cuda.matmul.fp32_precision = start["matmul"]
    torch.backends.cudnn.conv.fp32_precision = start["cudnn_conv"]
    same = {"analyze": own[0] == parity[0], "analyze_batch": own[1] == parity[1],
            "vgg2_mobilenet": bool(np.array_equal(own[2], parity[2]))}
    faces = sum(len(f) for f in own[0]) + sum(len(f) for f in own[1])
    print(f"tiers: torch's own flags {json.dumps(start)}; the default analyzer "
          f"({len(images)} photos and a batch of {len(batch)}, {faces} faces) and "
          f"build_extractor('vgg2_mobilenet') at batch {len(embed_imgs)} bit-equal "
          f"with and without set_parity_numerics: {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"tiers: an answer depends on the global flags: {same}")
    return {"flags": start, "faces": faces, **same}


def bf16_heads(params, device):
    """The multi-head heads with the backbone at bf16 ``compute_dtype``
    (the bench's bf16 inference tier), for the drift table."""
    from hse_facerec_torch.pipelines.heads import MultiheadHeads

    heads = MultiheadHeads(params, device)
    heads.forward = lambda p, x: multihead_apply(p, x, torch.bfloat16)
    return heads


def faces_drift(got, want) -> dict:
    """Per-image face lists against the "highest" ones: whether the counts
    are equal, and over the images whose counts are, the worst box (px),
    age and P(male) differences and the least identity cosine."""
    counts = [len(g) == len(w) for g, w in zip(got, want)]
    pairs = [(a, b) for g, w, ok in zip(got, want, counts) if ok for a, b in zip(g, w)]
    out = {"counts_equal": all(counts), "faces": sum(len(w) for w in want),
           "box_px": 0.0, "age": 0.0, "gender": 0.0, "min_cos": 1.0}
    for a, b in pairs:
        out["box_px"] = max(out["box_px"], float(np.abs(np.subtract(a.raw_bbox,
                                                                     b.raw_bbox)).max()))
        out["age"] = max(out["age"], abs(a.age - b.age))
        out["gender"] = max(out["gender"], abs(a.gender_prob - b.gender_prob))
        if a.identity.size:
            out["min_cos"] = min(out["min_cos"], float(cosine(a.identity, b.identity)))
    return out


def rows_drift(got, want) -> dict:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return {"max_abs": float(np.abs(got - want).max()),
            "min_cos": float(np.min(cosine(got.reshape(len(got), -1),
                                           want.reshape(len(want), -1))))}


def tier_row(path: str, label: str, ms: float, drift: dict, unit: str) -> dict:
    print(f"tiers {path} | {label} | {ms:.3f} {unit} | " + json.dumps(drift))
    return {"ms": ms, **drift}


def tier_analyze_rows(mtcnn_params, mh_params, images, batch, pbs) -> dict:
    """analyze (ms per photo), analyze_batch at 8 (ms per batch) and the
    two-model analyze at each variant against "highest"; the launch
    counts set to 0 just before each path's first call and read just
    after: K1 must have run."""
    from hse_facerec_torch.pipelines.heads import MultiheadHeads, TwoModelHeads

    rows = {"analyze": {}, f"analyze_batch_{len(batch)}": {}, "two_model_analyze": {}}
    base = {}
    for label, dtype in TIER_VARIANTS:
        tier = "highest" if label == "bf16" else label
        heads = (bf16_heads(mh_params, "cuda") if label == "bf16"
                 else MultiheadHeads(mh_params, "cuda", precision=tier))
        an = FacialAnalyzer(mtcnn_params, device="cuda", precision=tier, heads=heads,
                            batch_head_total=ROOMY_SLOTS)
        runs = {"analyze": (lambda: [an.analyze(img) for img in images], len(images),
                            "ms/photo"),
                f"analyze_batch_{len(batch)}": (lambda: an.analyze_batch(batch), 1,
                                                "ms/batch")}
        if label != "bf16":           # the graph compiler has no compute_dtype
            two = FacialAnalyzer(mtcnn_params, device="cuda", precision=tier,
                                 heads=TwoModelHeads(pbs["age"], pbs["gender"], "cuda",
                                                     precision=tier))
            runs["two_model_analyze"] = (lambda: [two.analyze(img) for img in images],
                                         len(images), "ms/photo")
        for path, (call, per, unit) in runs.items():
            reset_launches()
            out = call()
            k1 = kernel_launches()["crop_resize"]
            if k1 <= 0:
                raise AssertionError(f"tiers: {path} at {label} launched no crop_resize")
            base.setdefault(path, out)
            ms = event_median_ms(call) / per
            rows[path][label] = tier_row(path, label, ms, {
                "k1_launches": k1, **faces_drift(out, base[path])}, unit)
    return rows


def tier_zoo_params():
    """Seeded params of every f32 zoo entry (as the zoo and new zoo phases
    seed them), and the forward of each at bf16 ``compute_dtype`` (None
    where the model has none)."""
    from hse_facerec_torch.models.arcface import init_iresnet_params, iresnet_embed
    from hse_facerec_torch.models.mobilenet import mobilenet_embed
    from hse_facerec_torch.models.resnet import resnet50_embed
    from hse_facerec_torch.models.vgg16 import init_vgg16_params
    from hse_facerec_torch.testing import random_mobilenet_params, random_resnet50_params

    resnet = random_resnet50_params(np.random.RandomState(SEED + 53))
    params = {"agegender_identity": random_multihead_params(np.random.RandomState(SEED + 100)),
              "vgg2_mobilenet": random_mobilenet_params(np.random.RandomState(SEED + 51)),
              "vgg2_resnet": resnet, "vggface_resnet50": resnet,
              "insightface_arcface": init_iresnet_params(
                  torch.Generator().manual_seed(SEED + 71), depth=100),
              "vggface_vgg16": init_vgg16_params(torch.Generator().manual_seed(SEED + 73))}
    bf16 = torch.bfloat16
    forwards = {"agegender_identity": lambda p, x: multihead_apply(p, x, bf16).identity,
                "vgg2_mobilenet": lambda p, x: mobilenet_embed(p, x, compute_dtype=bf16),
                "vgg2_resnet": lambda p, x: resnet50_embed(p, x, compute_dtype=bf16),
                "vggface_resnet50": lambda p, x: resnet50_embed(p, x, compute_dtype=bf16),
                "insightface_arcface": lambda p, x: iresnet_embed(p, x, compute_dtype=bf16),
                "vggface_vgg16": None}
    return params, forwards


def tier_zoo_rows(rng, params, bf16_forwards) -> dict:
    """Each f32 zoo entry at ``ZOO_BATCH`` through ``build_extractor(name,
    precision=...)``, and at bf16 where the model has a ``compute_dtype``:
    ms per batch, the embeddings' drift against "highest"."""
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    rows = {}
    for name in TIER_ZOO:
        spec, rows[name], base = zoo.MODEL_ZOO[name], {}, None
        imgs = np.stack(smooth_images(rng, ZOO_BATCH, spec.input_size))
        for label, _ in TIER_VARIANTS:
            if label == "bf16":
                if bf16_forwards[name] is None:
                    continue
                ex = EmbeddingExtractor(bf16_forwards[name], params[name], spec.input_size,
                                        normalization=spec.normalization,
                                        resize_method=spec.resize_method,
                                        batch_size=ZOO_BATCH, device="cuda",
                                        **spec.extractor_kwargs)
            else:
                ex = zoo.build_extractor(name, batch_size=ZOO_BATCH, device="cuda",
                                         params=params[name], precision=label)
            out = ex.extract_batch(imgs)
            base = out if base is None else base
            ms = event_median_ms(lambda: ex.extract_batch(imgs))
            rows[name][label] = tier_row(f"zoo {name}", label, ms, rows_drift(out, base),
                                         f"ms/batch of {ZOO_BATCH}")
            del ex
        torch.cuda.empty_cache()
    return rows


def tier_face_id_rows(rng) -> dict:
    """The face-ID training forward (``forward_train``, batch-moment BN) at
    ``TRAIN_BATCH`` x ``TRAIN_SIZE``², width 1.0, ``TRAIN_CLASSES``:
    float32 at each tier and bf16 at "highest"; the logits' drift."""
    params = init_mobilenet_params(torch.Generator().manual_seed(SEED + 137),
                                   n_classes=TRAIN_CLASSES, device="cuda")
    x = torch.from_numpy(rng.randn(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3)
                         .astype(np.float32)).cuda()
    rows, base = {}, None
    for label, dtype in TIER_VARIANTS:
        tier = "highest" if label == "bf16" else label

        @torch.no_grad()
        def call():
            return face_id.forward_train(params, x, precision=tier, compute_dtype=dtype)[0]

        out = call().cpu().numpy()
        base = out if base is None else base
        rows[label] = tier_row(f"face_id forward_train {TRAIN_BATCH}", label,
                               event_median_ms(call), rows_drift(out, base), "ms/batch")
    return rows


def tier_threads(mtcnn_params, mh_params, images, ex, embed_imgs) -> dict:
    """One thread runs ``analyze`` on the photos at "highest" (the default
    analyzer), another ``ex`` (a zoo embed at "default"),
    ``TIER_THREAD_ROUNDS`` rounds each, started together each round: every
    "highest" answer bit-equal to a solo run's."""
    import threading

    an = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    solo = faces_bits([an.analyze(img) for img in images])
    barrier = threading.Barrier(2)
    answers, errors = [], []

    def run(call, out=None):
        try:
            for _ in range(TIER_THREAD_ROUNDS):
                barrier.wait(timeout=120)
                r = call()
                if out is not None:
                    out.append(r)
        except Exception as e:          # raised below, in the main thread
            errors.append(e)
            barrier.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(
                   lambda: faces_bits([an.analyze(img) for img in images]), answers)),
               threading.Thread(target=run, args=(lambda: ex.extract_batch(embed_imgs),))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"tiers: a thread failed: {errors!r}")
    equal = sum(a == solo for a in answers)
    print(f"tiers: two threads, analyze at 'highest' on {len(images)} photos and a "
          f"zoo embed at '{ex.model_fn.keywords['precision']}' on "
          f"{len(embed_imgs)} images, {TIER_THREAD_ROUNDS} rounds in "
          f"{time.perf_counter() - t0:.2f} s: {equal} of {len(answers)} 'highest' "
          "answers bit-equal to the solo run")
    if equal != TIER_THREAD_ROUNDS:
        raise AssertionError("tiers: a 'highest' answer changed beside a 'default' thread")
    return {"rounds": TIER_THREAD_ROUNDS, "bit_equal": equal}


def tiers_path() -> dict:
    """Phase ``tiers`` (run by ``apart(..., parity=False)``: torch's own
    flags at the start). See the module docstring, item 11."""
    from hse_facerec_torch.core.graphdef_export import export_age_pb, export_gender_pb
    from hse_facerec_torch.testing import random_mobilenet_params

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 127)
    mtcnn_params, mh_params = load_params()
    images = load_images(rng)
    batch = np.stack(smooth_images(rng, BATCH))
    api = tier_flag_check()
    embed_params = random_mobilenet_params(np.random.RandomState(SEED + 51))
    ex = zoo.build_extractor("vgg2_mobilenet", batch_size=ZOO_BATCH, device="cuda",
                             params=embed_params)
    embed_imgs = np.stack(smooth_images(rng, ZOO_BATCH, ex.input_size))
    fault = tier_fault_check(mtcnn_params, mh_params, images, batch, ex, embed_imgs)
    with tempfile.TemporaryDirectory() as tmp:
        pbs = {"age": os.path.join(tmp, "age.pb"), "gender": os.path.join(tmp, "gender.pb")}
        export_age_pb(mh_params, pbs["age"], input_size=AGE_HW)
        export_gender_pb(mh_params, pbs["gender"], input_size=GENDER_HW)
        rows = tier_analyze_rows(mtcnn_params, mh_params, images, batch, pbs)
    params, bf16_forwards = tier_zoo_params()
    rows["zoo"] = tier_zoo_rows(rng, params, bf16_forwards)
    del params
    torch.cuda.empty_cache()
    rows["face_id_forward_train"] = tier_face_id_rows(rng)
    torch.cuda.empty_cache()
    default_ex = zoo.build_extractor("vgg2_mobilenet", batch_size=ZOO_BATCH, device="cuda",
                                     params=embed_params, precision="default")
    threads = tier_threads(mtcnn_params, mh_params, images, default_ex, embed_imgs)
    print(f"tiers: {time.perf_counter() - t0:.1f} s in the child")
    return {"api": api, "fault": fault, "threads": threads, "rows": rows}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    print(card_name_and_power_limit())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    set_parity_numerics()

    # --- build ---
    print(f"nvcc: {build.find_nvcc()}; triton importable: "
          f"{importlib.util.find_spec('triton') is not None}")
    t0 = time.perf_counter()
    build.load_library()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path()})")
    log = build.library_path().parent / "build.log"
    if log.exists():
        print(log.read_text().strip())
    phase_done("build")

    # --- kernel vs plain ---
    rng = np.random.RandomState(SEED)
    crop_results = check_crop_kernel_apart()
    check_sass()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    pw = check_pw_kernel(gen, PW_BATCH, True, 20, 5)
    pw_maps = tensor_map_encode_us()
    warp_result = check_warp_kernel()
    attn_result = apart("cs.check_attention_kernel()", "K5 checks")
    bn_act_result = apart("cs.check_bn_act_kernel()", "K6 checks")
    bias_relu6_result = apart("cs.check_bias_relu6_kernel()", "K7 checks")
    phase_done("K1, K4, K3, K5, K6 and K7 checks")

    # --- main paths: counts set to 0 just before each, read just after ---
    mtcnn_params, mh_params = load_params()
    gpu = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    images = load_images(rng)
    median, repeats, outputs, analyze_launches = timed_analyze(gpu, images, K7_PER_FORWARD)
    path_launches = [analyze_launches]
    print(f"analyze_with_rotations: median {median:.3f} "
          f"ms/image over {ANALYZE_REPEATS} repeats of {len(images)} images "
          f"(each {[round(r, 3) for r in repeats]}); launches "
          f"{json.dumps(analyze_launches)}")
    if analyze_launches["crop_resize"] <= 0:
        raise AssertionError("the analyze path launched no crop_resize kernel")

    cpu = FacialAnalyzer(mtcnn_params, mh_params, device="cpu")
    compare_analyzers(gpu, cpu, images[0])
    phase_done("analyze")

    tiers = apart("cs.tiers_path()", "phase tiers", parity=False)
    torch.cuda.empty_cache()
    phase_done("tiers")

    batch_launches, batch_numbers = analyze_batch_path(
        mtcnn_params, mh_params, np.random.RandomState(SEED + 7))
    path_launches.append(batch_launches)
    phase_done("analyze_batch")

    album_launches, album_numbers = album_path(
        gpu, cpu, np.random.RandomState(SEED + 11), batch_numbers["images_per_s"])
    path_launches.append(album_launches)
    phase_done("album")

    int8_launches, int8_median = int8_analyze_path(mtcnn_params, mh_params,
                                                   images, outputs)
    path_launches.append(int8_launches)
    phase_done("analyze --int8-heads")
    embed_launches, embed = int8_embed_throughput(mh_params)
    path_launches.append(embed_launches)
    torch.cuda.empty_cache()
    phase_done("int8 embed")
    # K4 at the embedder's batch, where the layers are no longer launch-bound
    # (after the analyze timing: its plain version allocates tens of GB)
    pw_embed = check_pw_kernel_apart(SEED + 5, EMBED_BATCH, 10, 2, tiles=True)
    torch.cuda.empty_cache()
    phase_done(f"K4 check at batch {EMBED_BATCH}")

    # the 1-NN kernel checks allocate tens of GB: after the analyze timing
    knn_results = check_knn_kernels()
    torch.cuda.empty_cache()
    phase_done("K2 checks")

    with tempfile.TemporaryDirectory() as tmp:
        # the 112² photos pass the extractor's resize before the backbone
        path_launches.append(identify_path(rng, "agegender_identity", mh_params, tmp,
                                           k7_per_forward=K7_PER_FORWARD))
        path_launches.append(identify_path(rng, "agegender_identity_int8",
                                           quantize_multihead_int8(mh_params), tmp,
                                           k7_per_forward=0))
        phase_done("identify f32 and int8")
        path_launches.append(identify_at_scale())
        torch.cuda.empty_cache()
        phase_done("identify at scale")
        path_launches.append(analyze_gallery_path(gpu, images, tmp))
        phase_done("analyze --gallery")
        serve_launches, serve = serve_path(mtcnn_params, mh_params,
                                           np.random.RandomState(SEED + 43))
        path_launches.append(serve_launches)
        phase_done("serve")
        zoo_launches, zoo_numbers = zoo_path(np.random.RandomState(SEED + 47), tmp)
        path_launches.append(zoo_launches)
        torch.cuda.empty_cache()
        phase_done("zoo")
        two_launches, two_model = two_model_path(mtcnn_params, mh_params, images,
                                                 np.random.RandomState(SEED + 59), tmp)
        path_launches.append(two_launches)
        phase_done("two-model analyze")
        utk = utkface_path(mh_params, np.random.RandomState(SEED + 67), tmp)
        torch.cuda.empty_cache()
        phase_done("utkface, nine backends")
        new_zoo_launches, new_zoo = new_zoo_path(np.random.RandomState(SEED + 79), tmp)
        path_launches += new_zoo_launches
        torch.cuda.empty_cache()
        phase_done(f"identify and zoo on {' and '.join(NEW_ZOO)}")
    vit_launches, vit = vit_path(np.random.RandomState(SEED + 139))
    path_launches.append(vit_launches)
    phase_done("ViT-L embed")
    swin = apart("cs.swin_phase()", "K8 checks and Swin-T embed")
    path_launches.append(swin["launches"])
    phase_done("K8 checks and Swin-T embed")
    # K4 at the shapes vgg2_mobilenet_int8 gives it (192², the zoo's batch)
    pw_192 = check_pw_kernel_apart(SEED + 6, ZOO_BATCH, 10, 2, size=192)
    torch.cuda.empty_cache()
    phase_done(f"K4 check at batch {ZOO_BATCH}, 192²")
    knn_wide = check_knn_wide(torch.Generator(device="cuda").manual_seed(SEED + 83),
                              knn_results)
    torch.cuda.empty_cache()
    phase_done("K2b/K2c at D 4096")
    aligned = align_path(gpu, images)
    phase_done("align")
    with tempfile.TemporaryDirectory() as tmp:
        cascade = cascade_path(images, np.random.RandomState(SEED + 103), tmp)
    phase_done("cascade")
    del gpu, cpu
    torch.cuda.empty_cache()
    train_launches, train = train_path()
    path_launches += train_launches
    phase_done("train bf16 and f32")
    train_cuda_vs_cpu()
    phase_done("train cuda vs cpu")
    ag_launches, ag_train = age_gender_train_path()
    path_launches += ag_launches
    phase_done("age/gender train, unfrozen and frozen, bf16 and f32")
    ag_parity = age_gender_cuda_vs_cpu()
    phase_done("age_gender cuda vs cpu")
    mesh_launches, mesh_numbers = multichip_path(mtcnn_params, mh_params)
    path_launches += mesh_launches
    mesh_total = {k: sum(p[k] for p in mesh_launches) for k in mesh_launches[0]}
    phase_done("multichip")
    launches = {k: sum(p[k] for p in path_launches) for k in path_launches[0]}

    # crop: the sums over the three single-image call sites, i.e. one image's
    # crop passes at the default caps; beside them every site's numbers.
    # knn: the serve16 shape; pw_conv_int8: the sums over the 13 layers of
    # one 16-face head batch (library: torch._int_mm), and of the embedder's
    # batch
    singles = [crop_results[name] for name, *_ in CROP_SHAPES]
    kernels = [{
        "name": "crop_resize", "route": "cuda",
        "source": "hse_facerec_torch/csrc/crop_resize.cu",
        "replaces": "hse_facerec_tf_tpu/ops/pallas/crop.py:103",
        "launches": launches["crop_resize"],
        "mesh_launches": mesh_total["crop_resize"],
        "serve_launches": serve_launches["crop_resize"],
        "max_abs_err": max(r["max_abs_err"] for r in crop_results.values()),
        **{k: sum(r[k] for r in singles) for k in (
            "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
            "bound_whole_images_ms", "library_ms")},
        "bound_by": "bytes",
        "sites": {name: {k: v for k, v in r.items() if k != "max_abs_err"}
                  for name, r in crop_results.items()}}]
    design = knn_results["design_point"]
    for name, line in (("knn_f32", 159), ("knn_int8q", 313), ("knn_int8p", 439)):
        r = dict(knn_results[name])
        if name != "knn_f32":
            r["design_point"] = {"ms": design[name + "_ms"], **{
                k: design[k] for k in ("route", "streamed", "sweeps_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}
        kernels.append({
            "name": name, "route": "cuda", "source": "hse_facerec_torch/csrc/knn.cu",
            "replaces": f"hse_facerec_tf_tpu/ops/pallas/knn.py:{line}",
            "launches": launches[name], "serve_launches": serve_launches[name],
            "mesh_launches": mesh_total[name],
            "equal": name != "knn_f32", **r,
            **({"widths": {k: {"route": v["route"], "tile": v["tile"],
                               "streamed": v["streamed"], "ms": v[name + "_ms"],
                               "t_ops": v["ops"] / v[name + "_ms"] / 1e9,
                               "share_of_bound": v["bound_ms"] / v[name + "_ms"],
                               **{f: v.get(f) for f in ("plain_ms", "bound_ms", "bound_by",
                                                        "library_ms", "sweeps_ms")}}
                           for k, v in knn_wide.items()}} if name != "knn_f32" else {})})
    kernels.append({
        "name": "pw_conv_int8", "route": "cuda",
        "source": "hse_facerec_torch/csrc/pw_conv.cu",
        "replaces": "hse_facerec_tf_tpu/ops/pallas/pw_conv.py:150",
        "launches": launches["pw_conv_int8"],
        "mesh_launches": mesh_total["pw_conv_int8"],
        "serve_launches": serve_launches["pw_conv_int8"], "equal": True,
        **pw,
        "max_abs_err": max(pw["max_abs_err"], pw_embed["max_abs_err"],
                           pw_192["max_abs_err"]),
        "shape": f"13 pointwise layers at batch {PW_BATCH}, 224²",
        "tensor_map_us": pw_maps,
        f"batch_{EMBED_BATCH}": {k: pw_embed[k] for k in PW_KEYS},
        f"batch_{ZOO_BATCH}_192": {k: pw_192[k] for k in PW_KEYS}})
    kernels.append({
        "name": "warp_batch", "route": "cuda",
        "source": "hse_facerec_torch/csrc/warp.cu",
        "replaces": "hse_facerec_tf_tpu/ops/pallas/warp.py:166",
        "launches": launches["warp_batch"],
        "mesh_launches": mesh_total["warp_batch"],
        "launches_per_face_id_step": max(n["warp_batch"] for n in train_launches) / TRAIN_STEPS,
        "launches_per_age_gender_pair": max(n["warp_batch"] for n in ag_launches) / AG_PAIRS,
        **warp_result})
    kernels.append({
        "name": "attention", "route": "cuda",
        "source": "hse_facerec_torch/csrc/attention.cu", "replaces": None,
        "launches": launches["attention"], "mesh_launches": mesh_total["attention"],
        "launches_per_vit_call": vit_launches["attention"], **attn_result})
    kernels.append({
        "name": "window_attention", "route": "cuda",
        "source": "hse_facerec_torch/csrc/attention.cu", "replaces": None,
        "launches": launches["window_attention"],
        "mesh_launches": mesh_total["window_attention"],
        "launches_per_swin_call": swin["launches"]["window_attention"], **swin["kernel"]})
    kernels.append({
        "name": "bn_act", "route": "cuda",
        "source": "hse_facerec_torch/csrc/bn_act.cu", "replaces": None,
        "launches": launches["bn_act"], "mesh_launches": mesh_total["bn_act"],
        **bn_act_result})
    kernels.append({
        "name": "bias_relu6", "route": "cuda",
        "source": "hse_facerec_torch/csrc/bn_act.cu", "replaces": None,
        "launches": launches["bias_relu6"], "mesh_launches": mesh_total["bias_relu6"],
        **bias_relu6_result})
    print(f"int8 serving: analyze --int8-heads median {int8_median:.3f} ms/image "
          f"(f32 heads {median:.3f}); embed batch {EMBED_BATCH} "
          + json.dumps({k: round(v, 1) for k, v in embed["ips"].items()}) + " img/s")
    print("knn design point: " + json.dumps(knn_results["design_point"]))
    print("train: " + json.dumps(train))
    print(f"analyze_batch x{BATCH}: " + json.dumps(batch_numbers))
    print("album: " + json.dumps(album_numbers))
    print("serve: " + json.dumps(serve))
    print("zoo: " + json.dumps(zoo_numbers))
    print("two-model: " + json.dumps(two_model))
    print("utkface: " + json.dumps({b: {k: v for k, v in r.items() if k != "metrics"}
                                    for b, r in utk.items()}))
    print("zoo 512-d and 4096-d: " + json.dumps(new_zoo))
    print("vit: " + json.dumps(vit))
    print("swin: " + json.dumps(swin["path"]))
    print("age/gender train: " + json.dumps(ag_train))
    print("age_gender cuda vs cpu: " + json.dumps(ag_parity))
    print("align: " + json.dumps(aligned))
    print("cascade: " + json.dumps(cascade))
    print("multichip: " + json.dumps(mesh_numbers))
    print("tiers: " + json.dumps(tiers))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
