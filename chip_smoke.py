#!/usr/bin/env python3
"""Drive the PyTorch port of the seizure-scoring, training (emulated
and over torch.distributed), dense LM serving, LM training, the moe,
xLSTM, vlm and audio LM families, hybrid LM serving and the mesh
Model's paths on one CUDA card, and the dry run's tools beside them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Device: the card's name and power limit from nvidia-smi; the kernel
     library is built from ``src/repro_torch/csrc`` (nvcc, first use).
  2. Kernels: K1 forest, K2 wpd_level and K3 gram against their plain
     PyTorch versions at the scoring path's shapes, each with its error,
     its time, the plain version's time, one PyTorch library call's time
     where one computes the same function, and its bound on this card
     (K4 histogram likewise in phase 6, at the grower's shapes). K1 on the
     committed program (dead nodes included) at 1920 rows and at 1927, a
     multiple of no block size. K2 as the TPU kernel's single level, and
     as the one-launch packet tree (wpd_tree) and DWT (dwt_levels) the
     main path runs: the step's (5760, 2048) at levels 4 and 5, the DWT at
     overlap 2's 5952 rows, and rows of 32 that end shorter than the
     filter; each within 1e-5 * max|x| of its plain version and bit-equal
     to the single-level kernel chained level by level; a tree's library
     call is one conv1d with its composite filters.
  3. Engine: the committed full-width program serves 8 sessions of
     generated EEG (6 chunks each, pushed in chunk-unaligned pieces) at
     max_batch=8, replay_depth=4, at overlap 0 and at overlap 2; each step
     must launch K1 once, K2 twice (one packet tree, one DWT) and K3 six
     times.
  4. Kernel path vs plain path: the same traffic through the engine with
     the plain versions; events must agree exactly in type, patient,
     chunk index, chunk vote and alarm, and a window prediction may
     differ only where its routing margin is below 1e-3 (z-units).
  4b. Snapshot/restore, the reference_kernels leg and the streaming
     frontend, at full width. The same traffic on SNAP_BATCH = 4 slots,
     overlap 0 and 2: the engine snapshots after a push, before its poll
     (slots bound, sessions waiting) and runs on exactly as an engine never
     snapshotted; restored with megabatch=True its tail must equal the live
     tail bit for bit in every field, restored with megabatch=False the
     uninterrupted serial engine's tail (and the live tail within the event
     rule); a restored engine launches K1 1, K2 2 and K3 6 times a step
     (a backlog position, in the serial step)
     ("snapshot" and "restore" lines: snapshot ms and MB, restore ms, the
     first step after a restore against a steady step). The phase-3
     traffic through a reference_kernels=True program (the reference's
     pre-megabatch math: gather-form wavelet levels, sample-major PCA with
     the masked reconstruction, scatter-add synthesis) at overlap 0 and 2:
     events within phase 4's rule of the default leg's, K1 1, K2 9 (each
     wavelet level K2's single level) and K3 6 launches a step, windows/s
     of both legs; K2's single level and K3 held against their plain
     versions at every shape the leg gives them, and a reading of whether
     the leg's scatter-add synthesis (atomic adds) gives the same bits
     twice. One session's stream fed
     to a StreamingFrontend (overlap 2) in unaligned pieces and resumed
     from its state_dict between chunk boundaries: bit-equal to the
     uninterrupted feed and to pipeline.process_windows.
  5. Stage times of one engine step (the six eigh calls of one denoise
     among them), a profiler trace of one step (device busy and idle
     share, device time by kernel), and the host syncs of one warm engine
     step, counted by call site under ``torch.cuda.set_sync_debug_mode``
     ("warn") through ``repro_torch.analysis.sanitizers.guard_methods``
     ("syncs" lines; the event readout's host copies are exempt); the
     same for one fit after phase 6.
  6. Training: a MapReduce fit of the default ``PipelineConfig`` (10
     trees of depth 6, 32 bins, F = 288) over 2 shards of 16 + 16
     stratified generated chunks, timed by stage (feature extraction and
     its MSPCA eigh, K2 and K3 calls; rotation and its eigh; grower and
     its K4 calls). K2 must launch twice per chunk (64 times); K2 and K3
     are held against their plain versions on every input shape the fit
     gave them (K2's trees and DWTs also against the chained single
     level), and one shard's training
     features through the kernels may lie at most twice as far from the
     host CPU's features as the plain path's do (z-units, 99th and 99.9th
     percentile).
     K4 must launch once per level and shard (12 times); its level mode
     (the grower's level_histogram, on feature-major uint8 codes) must
     equal its plain version exactly on the fit's own 0/1 weights at every
     level (and within 1e-5 relative on float weights); its class mode
     (the TPU kernel's contract) likewise at levels 0 and 5 and on a
     65536-bucket histogram built in shared-memory slices; the level mode
     also off the fit's shapes (N off the pass and 16-byte grids, a short
     feature group, 66-float output rows, int32 codes). A profile of
     one grower call gives its device busy and idle share and its largest
     operations.
     The fit is checkpointed, reloaded and served on a held-out timeline
     (1 h interictal, the 48-minute run-up, the seizure) pushed 37
     windows at a time; the served alarms must equal
     ``pipeline.evaluate_timeline``, and the port-trained forest's window
     accuracy may trail the committed JAX-trained program's by at most
     0.05; the same evaluation through the plain versions must give the
     same chunk votes and alarms (K1 on a second forest), window votes
     differing only at routing margin < 1e-3. A retrain on fresh shards is swapped into the running engine
     mid-stream; version stamps and the composite old/new alarm oracle
     must be exact.
  6c. Distributed training, one process per map shard
     (``repro_torch.launch.mesh.spawn_world``), on phase 6's training set
     at full width (default ``PipelineConfig``, F = 288, windows of 3 x
     2048). a: a world of one nccl rank on cuda:0: ``fit_mapreduce(mesh=)``
     (the process's first fit, and again after ``n_shards=1``) must equal
     ``n_shards=1`` in every leaf, bit for bit. b: a world of two gloo
     ranks, both on cuda:0, each fitting twice from phase 6's generator
     state just before its fit (taken without a draw; the first fit of a
     fresh process, then a warm one): ``pipeline.fit(mesh=)`` must equal
     phase 6's ``n_shards=2`` fit in every leaf (forest, feat_mean,
     feat_std) on both ranks, both times (else the first stage that
     differs is named), and each rank must launch K2 twice per chunk of
     its shard, K4 once per level and K3 at least once a fit
     ("distributed b" lines: each rank's fit seconds, its stage seconds
     (features, moments gather, rotation prep, grower, union gather) and
     each gather's ms, then the slower rank's fit against phase 6's
     emulated fit, beside the card's name and power limit; two ranks on
     one card measure contention, not scaling). c: in the same world, ``process_recording_mapreduce`` at
     overlap 0 on 4 chunks must equal ``process_windows`` of each rank's
     shard, and ``shuffle_by_key`` on CUDA tensors with skewed keys (70%
     of each shard's rows to shard 0, past a bucket's room) the routing
     computed on the host. d: ``python -m repro_torch.launch.train_forest
     --devices 2 --backend gloo --trees 10 --depth 6 --bins 32`` as a
     subprocess must exit 0 (its ranks serve the union forest through K1
     and swap in a distributed retrain). The mesh fits' launches join the
     ``kernels`` line.
  6d. The seizure engine across processes: ``SeizureEngine(mesh=)`` on
     phase 3's traffic (8 sessions x 6 chunks, max_batch=8,
     replay_depth=4) at overlap 0, then 2, then 0 again, and at overlap 2
     on SNAP_BATCH = 4 slots (slots evicted and refilled), in a world of
     one nccl rank and in a world of two gloo ranks sharing the card.
     Every rank's events must equal the single-process engine's (phase
     3's, or a 4-slot run of it) by phase 4's rule, and each rank must launch
     K1 1, K2 2 and K3 6 times a step ("mesh engine" lines: windows/s per
     rank and each step's gather ms beside phase 3's windows/s; two ranks
     on one card measure contention, not scaling). Then, at overlap 0, the
     collectives the drives above leave out: ``poll(drain=False)`` under a
     latency budget that only the last rank's clock passes, with 2 of the 8
     slots left empty so that it flushes partial batches (the flush is a
     max over the mesh; held to a single-process engine of budget 0),
     a mesh snapshot taken mid-stream as phase 4b takes it (SNAP_BATCH
     slots) and restored without a mesh, and a single-process snapshot
     restored on the mesh; each resumed engine's events, head and tail,
     must equal the uninterrupted single-process engine's ("mesh engine
     ... budget/snapshot" lines).
  7. LM serving at the full width of qwen3-0.6b (28 layers, 751.6 M
     parameters drawn from a seeded generator, bf16 compute). K5
     flash_attention against its plain version in the model's layout with
     GQA, as the kernel reads it in place (q (B, S, 16, hd), k and v (B, S,
     8, hd); the plain version expands the KV groups as ops.py does for a
     CPU tensor): the static prefill's launch (8, 2048) causal in bf16 and
     f32, a batch-1 admission's, a ragged S, a non-causal and an hd-64
     case, each held element by element within FLASH_TOL of its query
     row's scale and printed with its error, time, plain time, SDPA's time
     on the expanded (1, B*H, S, hd) tensors and bound. A static batch
     (``ServeEngine``, 8 slots, max_seq 4096, prompts of ragged length up
     to 2048, 32 new tokens each): K5 must launch exactly 28 times (once
     per layer of the one prefill); prefill ms, decode ms per step and
     tokens/s. Continuous batching (``ContinuousEngine``): 12 requests over
     4 slots with ragged max_new, prompts of 512 and 1024 tokens (batch-1
     prefills through K5) and of other lengths (plain ``_sdpa``); every
     request completes, admissions happen mid-stream, K5 launches 28 times
     per 512-multiple prompt. Both runs again with K5's plain version:
     the logits of every step whose context is the same on both paths
     (the prefills among them) within LM_LOGIT_TOL, tokens equal up to
     each request's first step whose plain-path top-2 margin is below
     LM_MARGIN. Profiler traces of one prefill and one decode step, with
     K5's share and the copies' beside it. The model is freed before
     phase 8.
  7b. LM training at the full width and depth of qwen3-0.6b (751.6 M
     parameters drawn from a generator of their own, float32 masters,
     bf16 compute, remat per block as published): AdamW with
     ``cosine_warmup`` on a ``BatchStream`` of batch 8 x 2048 in 4
     microbatches, 4 steps (step ms, tokens/s, peak memory). (1) Step 0's
     cross-entropy against the same batch's through ``Model.forward``
     under no_grad, which reaches K5 (28 launches a microbatch), within
     TRAIN_CE_ULPS (1/16) of a bf16 ulp of the loss. (2) One microbatch's bf16
     gradients against a float32-compute step's on the same masters, each
     leaf within TRAIN_GRAD_REL of its own scale. (3) At batch 2, the step
     with microbatches=2 against microbatches=1 from copies of one state:
     the loss, the clipped gradient (read from m) and the update, each
     leaf within TRAIN_MICRO_REL. (4) Four steps on one fixed batch (lr
     TR_FIXED_LR): the loss falls. (5) K5 and K6 launch 0 times in every train step, and a
     CUDA input that requires grad makes K5's router raise. (6) The
     trained state saved as a train checkpoint and restored bit for bit,
     its masters loaded into the serving model, which serves one static
     batch through K5 (28 launches). Then zamba2-7b at its published
     widths, depth cut to one group (the shared attention site and its 6
     Mamba2 blocks; all 81 blocks' state would take ~108 GB): one bf16
     train step, its gradients against a float32-compute step's as in
     (2), and K6 (and K5) launching 0 times.
  7c. The remaining LM families at their published widths (random
     weights from seeded generators, bf16 compute). First K5 against its
     plain version at qwen3-moe-30b-a3b's prefill, q (8, 2048, 32, 128)
     over k, v (8, 2048, 4, 128) causal bf16 (GQA group 8), and at the
     batch-1 admission prefills of its continuous run (S = 512, 1024,
     1536), within FLASH_TOL; each family's reduced float32 config on the
     card against the CPU within FAMILY_REF_TOL. qwen3-moe-30b-a3b (128
     experts, top-8, capacity factor 1.25) cut to MOE_LAYERS = 8 of 48
     layers (5.60 B parameters): the top-k tie rule and the dispatch of
     the prefill's choices on the card equal the CPU's; a static batch as
     phase 7's (16 new tokens; K5 once per layer of the prefill), then
     continuous batching, 8 requests over 4 slots (K5 per 512-multiple
     prompt), each again through K5's plain version with the routes pinned
     to the kernel run's expert choices (MOE_* comment): the share of
     token-choices the plain path's own top-k would route elsewhere, per
     layer, and the logits and tokens held by phase 7's rules; profiles
     of one prefill and one decode step. One AdamW train step at MOE_TRAIN_LAYERS = 2
     layers on 2 x 2048 (no K5 launch, aux finite and > 0) and phase 7b's
     check (2) with the float32 model pinned to the bf16 model's routes.
     xlstm-1.3b as published (42 mLSTM + 6 sLSTM blocks): a static batch of
     8 prompts of 2048 (16 new tokens; the prefill's time in each kind of
     block) and continuous batching, 8 requests over 4 slots. paligemma-3b
     as published: ``Model.prefill`` of 8 x (256 patches + 256 tokens)
     and 16 decode steps. hubert-xlarge as published: ``Model.loss``'s
     forward on 8 x 2048 frames with the synthetic mask, and its
     decode_step raising. Each prints prefill (or loss) ms, decode ms a
     step, tokens (or frames)/s, peak memory and the card; no kernel
     launches on the xLSTM, vlm or audio paths.
  8. Hybrid LM serving at the full width and depth of zamba2-7b (81 Mamba2
     blocks behind 14 sites of one shared attention block, 6.75 B
     parameters drawn from a seeded generator, bf16 compute). K6 against
     its plain versions on every case of SSD_CASES: the full function
     ssd_chunks on its (BH, NC, L, 64) layout (the static prefill's (896,
     8, 256, 64) with a nonzero h_in, a batch-1 admission's, L = 77, L = 1,
     strong and weak decay, float32), and the states and outputs modes on
     the model's layout (B and C once per batch row, v and ld as (B, S, H,
     ...): the static prefill's 8 rows x 8 chunks x 112 heads, a batch-1
     admission, L = 77, strong and weak decay, float32), each element
     within SSD_TOL of its row's scale, each mode also against the plain
     version of float32 copies of its inputs (the states within
     SSD_TOL["float32"]) and the states mode handed a nonzero h_in
     bit-equal to it without; then ssd_scan_grouped end to end at (8, 2048,
     112, 64) within SSD_SCAN_TOL of the plain scan and of the float32
     scan; each row printed with its error, time, plain time and bound. A static
     batch (8 slots, max_seq 4096, prompts of ragged length up to 2048,
     left-padded to 2048): K6 must launch exactly 162 times (twice per
     Mamba2 block of the one prefill) and K5 never (head_dim 112).
     Continuous batching: 10 requests over 4 slots, prompts of 256, 512
     and 77 tokens (K6 at L = 256 and 77, 162 launches each) and of
     300-1000 (scan_core's plain path), ragged max_new; every request
     completes, admissions happen mid-stream. Both runs again with K6's
     plain version: logits of every same-context step within
     HY_LOGIT_ULPS bf16 ulps of the largest |logit|, tokens equal up to
     each request's first plain margin below half of that. Profiler
     traces of one prefill and one decode step, with K6's share; the
     prefill copies no tensor of B H S N elements with a head axis.
  9. The mesh and dry-run tools. (a) The dry run of qwen3-0.6b x
     train_4k, prefill_32k and decode_32k on the 16x16 fake world
     (``python -m repro_torch.launch.dryrun``, one CPU subprocess a
     shape with the card hidden, started when phase 9 begins, beside (b) and (c),
     so that no earlier phase's host-bound times share the host with it,
     and read at the phase's end): per record
     the per-device memory, ``fits_hbm`` at 80 GB, flops, HBM bytes,
     collectives by type, the roofline terms at H100 constants and
     ``useful_flops_ratio``; any record with an error fails the phase.
     (b) A world of one nccl rank, a (1, 1) mesh: qwen3-0.6b whole (bf16,
     parameters placed by ``param_pspecs``) and one zamba2-7b group
     prefill (8, 2048) through K5 (28 launches) and K6 (12) on the local
     shard, their logits bit-equal to the unsharded model's on the same
     rank. K5 against its plain version, element by element, at the (1,
     2) mesh's per-rank shape, q (8, 2048, 8, 128) over k, v (8, 2048, 4,
     128) bf16 causal. (c) Two gloo ranks sharing cuda:0 (MESH_GLOO_RULES: gloo
     carries only all-reduces of the DTensor collectives for CUDA
     tensors): qwen3-0.6b's prefill on a (1, 2) mesh (8 of 16 heads and 4
     of 8 KV heads a rank through K5, the vocabulary split) and a (2, 1)
     mesh (4 rows a rank), the ranks' logits within LM_LOGIT_TOL of (b)'s,
     K5 28 launches a rank; one AdamW step of a 2-layer qwen3 on (2, 1)
     against the one-process step (MESH_* comment).
  10. A ``kernels`` JSON line (K1-K6; launches summed over the counted
     runs of phases 3, 4b, 6, 6c (every rank's mesh fit), 6d (every
     rank's engine runs), 7, 7b (its serving forwards), 7c (the moe
     engine runs), 8 and 9 (every rank's mesh prefills)), the
     script's seconds, the card line,
     and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import gzip
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bandwidth and float32 outside the tensor cores (the kernels run true
# float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores

SEED = 0
N_SESSIONS = 8
CHUNKS_PER_SESSION = 6
MAX_BATCH = 8
REPLAY_DEPTH = 4
PUSH_CUTS = (0, 97, 150, 245, 270, 333, 360)  # chunk-unaligned push pieces
# Phase 4b: 8 sessions on 4 slots, snapshot after the push of round 2 (of
# 6), before its poll: 4 sessions hold the slots and 4 wait, 2 chunks each.
SNAP_BATCH = 4
SNAP_ROUND = 2
TRAIN_PATIENT = 3
TRAIN_CHUNKS_PER_CLASS = 16
TRAIN_SHARDS = 2
PUSH = 37  # windows per push when serving the held-out timeline
# Phase 7: LM serving at the full width of qwen3-0.6b (random weights).
LM_ARCH = "qwen3-0.6b"
LM_SLOTS = 8
LM_MAX_SEQ = 4096
LM_MAX_NEW = 32
LM_STATIC_LENS = (2048, 1999, 1536, 1234, 1024, 777, 512, 301)  # padded width 2048
LM_CONT_SLOTS = 4
LM_CONT_MAX_SEQ = 2048
LM_CONT_LENS = (512, 1024, 700, 1500, 512, 333, 1024, 900, 512, 1100, 1024, 257)
LM_CONT_MAX_NEW = (8, 20, 12, 5, 16, 9, 24, 6, 11, 14, 7, 10)
# Kernel path against plain path, bf16 throughout: the two round P (and
# so each attention output) at different places, about one bf16 ulp
# apart, and 28 layers carry that into the logits, which are themselves
# bf16 products: at this random init the largest |logit| lies in [4, 8),
# where a bf16 ulp is 2^-5, and LM_LOGIT_TOL is 8 such ulps. A token can
# flip only where the plain path's top two logits lie closer than their two
# differences; those are a few ulps each, so tokens are compared up to the
# first step whose plain-path margin is below 4 ulps.
LM_LOGIT_TOL = 0.25   # max |logit difference| on the same context
LM_MARGIN = 0.125
# K5 against its plain version, element by element: |kernel - plain| <=
# REL |plain| + ROW max|plain row|, so each query row is held at its own
# scale (a row that averages i keys has outputs ~1/sqrt(i) of |v|). bf16:
# both round the output once (2^-7 covers one ulp between them); the plain
# version also rounds q.k to bf16 (about 2^-9 of |q.k|, ~0.01 of a unit
# logit) where the kernel keeps it f32, and the two round P at different
# places: together under 2^-6 of a row's largest output on random inputs.
# f32: one softmax in two orders of summation. tools/flash_faults.py plants
# faults in the kernel and reads how far over this limit each one lands.
FLASH_TOL = {"bfloat16": (2.0**-7, 2.0**-5), "float32": (2.0**-17, 2.0**-17)}
# Phase 7b: LM training at the full width of qwen3-0.6b (random weights),
# then one group of zamba2-7b.
TR_BATCH, TR_SEQ, TR_MICRO, TR_STEPS = 8, 2048, 4, 4
TR_LR = 3e-4
TR_SMALL_BATCH = 2  # checks (3) and (4), and the hybrid step
# (4) AdamW on one fixed batch, from the trained state's moments, at a
# constant TR_LR / 100: at this state a step of 3e-5 overshoots (the loss
# rises by ~1.0 at the third step, in float32 compute as well, so it is the
# optimizer's step, not bf16), at 3e-6 it falls at every step
# (tools/train_fixed_batch.py, PR 22, run D).
TR_FIXED_LR = TR_LR / 100
TR_CKPT_DIR = ROOT / "build" / "train_ckpt"
# (1) The training forward (plain _sdpa, bf16) and the serving forward (K5)
# differ only in how attention rounds: about one bf16 ulp of each attention
# output, carried through 28 layers into bf16 logits (phase 7 holds them
# within 8 ulps of the largest, 2^-5 each at |logit| in [4, 8)). A token's
# cross-entropy moves by a few such ulps at most, with either sign, and the
# loss is a mean over 16384 tokens (sqrt: 128-fold): far below one bf16 ulp
# of the loss itself (2^-4 for a loss in [8, 16)). The tolerance is
# TRAIN_CE_ULPS = 1/16 of that ulp (2^-8 at this loss, twice 8 logit ulps
# over 128).
TRAIN_CE_ULPS = 2.0**-4
# (2) bf16 against float32 compute, per leaf: ||g16 - g32|| <= REL ||g32||
# and max|g16 - g32| <= 2 REL max|g32|. Each bf16 rounding is 2^-9
# relative; the backward of 28 blocks rounds every activation and its
# gradient several times, and the reduced configs on the CPU (8 blocks)
# read 0.5-2.1% (Frobenius) and up to 2.7% (max): 2^-4 (6.25%) leaves
# room for the depth; a wrong backward is O(1).
TRAIN_GRAD_REL = 2.0**-4
# (3) microbatches=2 against 1 on the same 2 rows, both bf16: the two
# differ in each microbatch's bf16 weight gradient (rounded once per
# microbatch instead of once over both rows) and in GEMM shapes (cuBLAS
# may pick other kernels for 2048 rows than for 4096, a bf16 ulp here and
# there), far less than bf16 against float32: the loss within one bf16
# ulp, each leaf's clipped gradient and update within 2^-5 of its scale
# (Frobenius).
TRAIN_MICRO_REL = 2.0**-5
# Phase 7c: the remaining LM families at their published widths (random
# weights). qwen3-moe-30b-a3b (128 experts, top-8) cut to 8 of its 48
# layers: 5.60 B parameters, 33.6 GB as float32 masters and the bf16 copy
# (the whole model would take 183 GB).
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 8
MOE_MAX_NEW = 16
MOE_CONT_MAX_SEQ = 2048
MOE_CONT_LENS = (512, 1024, 700, 1536, 512, 333, 1024, 900)  # 5 reach K5 (S % 512 == 0)
MOE_CONT_MAX_NEW = (8, 12, 6, 10, 5, 9, 7, 11)
MOE_TRAIN_LAYERS = 2
# Kernel path against plain path: phase 7's rules (LM_LOGIT_TOL, LM_MARGIN)
# on every step, with the routes pinned. The router sits between the paths:
# two bf16 attention roundings move a token's router logits by a few bf16
# ulps, and where two of its 128 probabilities lie within that of each other
# across the top-8 boundary (equal bf16 router logits are common), the two
# paths would route the token to different experts, and a different expert
# set (or, through the capacity, a different set of dropped choices) changes
# its MoE output by O(1), not by rounding. So each plain run takes the
# kernel run's expert choices (its weights renormalized from its own
# probabilities, ``moe_routes(replay=)``), and the two paths differ by K5's
# rounding alone. The share of token-choices that the plain path's own top-k
# would have sent to another expert is printed per layer. K5 itself is held
# element by element at every shape the moe runs give it (``flash_row``):
# (8, 2048) and the batch-1 admission widths of MOE_CONT_LENS that open its
# gate, all at 32:4 heads (a GQA group of 8).
# (2) of phase 7b on 2 layers, with the routes pinned the same way: the
# float32-compute model takes the bf16 model's expert choices, as otherwise
# the same route flips make the two gradients differ by which tokens each
# expert saw, not by rounding.
XL_ARCH = "xlstm-1.3b"
XL_SLOTS = 8
XL_MAX_SEQ = 4096
XL_MAX_NEW = 16
XL_STATIC_LEN = 2048
XL_CONT_SLOTS = 4
XL_CONT_MAX_SEQ = 1024
XL_CONT_LENS = (256, 128, 512, 96, 384, 200, 64, 300)
XL_CONT_MAX_NEW = (8, 12, 6, 10, 5, 9, 7, 11)
VLM_ARCH = "paligemma-3b"
VLM_BATCH, VLM_TEXT, VLM_STEPS = 8, 256, 16
AUDIO_ARCH = "hubert-xlarge"
AUDIO_BATCH, AUDIO_FRAMES = 8, 2048
# Each family's reduced float32 config on the card against the same on
# the CPU (TF32 is off): logits within 1e-4 absolute and relative, as the
# CPU tests hold the port to the reference.
FAMILY_REF_TOL = 1e-4
# Phase 8: hybrid serving at the full width of zamba2-7b (random weights).
HY_ARCH = "zamba2-7b"
HY_SLOTS = 8
HY_MAX_SEQ = 4096
HY_MAX_NEW = 24
HY_STATIC_LENS = (2048, 1999, 1536, 1234, 1024, 777, 512, 301)  # padded width 2048
HY_CONT_SLOTS = 4
HY_CONT_MAX_SEQ = 1024
# chunk = min(256, S): prompts of 256 and 512 reach K6 at L = 256, the one of
# 77 at L = 77; 300, 333, 700 and 1000 pass a chunk without being a multiple
# of it and take scan_core's plain path. Every prompt has at least
# ssm_conv - 1 = 3 tokens (models/ssm.py).
HY_CONT_LENS = (256, 512, 77, 300, 256, 700, 512, 333, 256, 1000)
HY_CONT_MAX_NEW = (8, 14, 6, 10, 12, 5, 9, 7, 11, 6)
# Kernel path against plain path, bf16 throughout. LM_LOGIT_TOL is 8 bf16
# ulps of the largest |logit| for 28 blocks whose attention outputs differ
# by about one ulp between the paths. zamba2-7b stacks 95 blocks (sqrt(95 /
# 28) ~ 1.8 times the spread), and the plain SSD rounds at more places than
# K6 does (the decay, q.k, the incoming state and its term, where K6 rounds
# P and y only), about twice K5's difference per block: 8 x 1.8 x 2 ~ 29,
# so the tolerance is HY_LOGIT_ULPS = 32 ulps of the largest |logit| this
# init gives (read from the static prefill), and tokens are compared up to
# each request's first plain-path top-2 margin below half of it, as LM_MARGIN
# is half of LM_LOGIT_TOL.
HY_LOGIT_ULPS = 32
# K6 against its plain version, element by element: |kernel - plain| <=
# REL |plain| + ROW max|plain row|, each row of y and of the state at its
# own scale. bf16: the kernel rounds P and y once each; the plain version
# also rounds the decay, q.k, their product, the intra-chunk sum, q exp(cum),
# h_in and the incoming-state term to bf16, each a 2^-9 relative error of
# terms whose sum is the row's scale: 2^-7 |plain| covers the outputs' last
# roundings, 2^-5 of the row's largest element the rest. float32: the same
# products, but cum is a float32 scan in another order than torch.cumsum;
# at |cum| up to ~2^8 its ulp is 2^-15, and a few ulps of cum move
# exp(cum_i - cum_j) by ~2^-14 relative: 2^-13 of each.
# tools/ssd_faults.py plants faults in K6 and reads how far over this limit
# each one lands.
SSD_TOL = {"bfloat16": (2.0**-7, 2.0**-5), "float32": (2.0**-13, 2.0**-13)}
# ssd_scan end to end: on top of the chunk step's roundings, the plain path
# rounds each chunk's pass-1 state to bf16 (its einsum's output type), where
# K6 keeps it float32, and pass 2 rounds that incoming state again: one more
# 2^-9 error in the term that is the scale of a chunk's first rows, so the
# row share doubles.
SSD_SCAN_TOL = (2.0**-7, 2.0**-4)
# K6 cases: (name, layout, G, NC, L, Hg, type, decay), q, k, v ~ N(0, 1), h_in
# ~ 16 N(0, 1) (a state summed over a chunk of unit k, v). "full": the TPU
# kernel's function on its (BH = G, NC, L, 64) layout, one head per group.
# "grouped": the states and outputs modes on the model's layout, q and k
# (G, NC, L, 64) once per group (strided views of one (.., 128) tensor), v
# (G, NC, L, Hg, 64) and ld (G, NC, L, Hg) as (B, S, H, P) and (B, S, H) cut
# into chunks, h_in (G, Hg, NC, 64, 64). Decays ld = -dt A, A per head:
# "model", dt = softplus(N(0, 1)) and A = exp(A_log), A_log ~ 0.02 N(0, 1), as
# the model's init draws them (cum near -200 at a chunk's end); "weak",
# Mamba2's published init (softplus(dt_bias) log-uniform in [1e-3, 0.1], A
# uniform in [1, 16]), so the incoming state still reaches the late rows;
# "strong", A = 8, cum below -1000 within the chunk. "short chunk" gives the
# bf16 body blocks of several heads (G NC Hg = 896 heads over about four
# waves of 132 SMs: two a block) whose warpgroups own one 64-row slab of y
# each, so each stores its slab once per head through the same two buffers.
SSD_CASES = (
    ("static prefill", "full", 8 * 112, 8, 256, 1, "bfloat16", "model"),
    ("batch-1 admission", "full", 112, 2, 256, 1, "bfloat16", "model"),
    ("ragged L", "full", 112, 1, 77, 1, "bfloat16", "model"),
    ("L = 1", "full", 112, 1, 1, 1, "bfloat16", "model"),
    ("strong decay", "full", 112, 2, 256, 1, "bfloat16", "strong"),
    ("weak decay", "full", 8 * 112, 8, 256, 1, "bfloat16", "weak"),
    ("float32", "full", 112, 2, 256, 1, "float32", "model"),
    ("static prefill", "grouped", 8, 8, 256, 112, "bfloat16", "model"),
    ("batch-1 admission", "grouped", 1, 2, 256, 112, "bfloat16", "model"),
    ("ragged L", "grouped", 1, 1, 77, 112, "bfloat16", "model"),
    ("short chunk", "grouped", 8, 1, 128, 112, "bfloat16", "model"),
    ("strong decay", "grouped", 1, 2, 256, 112, "bfloat16", "strong"),
    ("weak decay", "grouped", 8, 8, 256, 112, "bfloat16", "weak"),
    ("float32", "grouped", 1, 2, 256, 112, "float32", "model"),
)
# K1 and K2 cases of phase 2 (tools/scoring_faults.py reads the same). K1: an
# engine step's rows, and a row count that is a multiple of no block size.
# K2, one launch a tree: the step's WPD (level 4) and DWT (level 5) of 5760
# rows of 2048, each also at the other's level, the DWT at overlap 2's 5952
# rows (62 windows a chunk), and rows of 32, shorter than the filter at the
# last levels; the single level as the TPU kernel's contract at the first
# WPD level's 2048 and the second's 1024.
STEP_ROWS = MAX_BATCH * REPLAY_DEPTH * 60 * 3
K1_ROWS = (MAX_BATCH * REPLAY_DEPTH * 60, 1927)
K2_CASES = (
    ("wpd_tree", (STEP_ROWS, 2048), 4), ("wpd_tree", (STEP_ROWS, 2048), 5),
    ("dwt_levels", (STEP_ROWS, 2048), 5), ("dwt_levels", (STEP_ROWS, 2048), 4),
    ("dwt_levels", (MAX_BATCH * REPLAY_DEPTH * 62 * 3, 2048), 5),
    ("wpd_tree", (7, 32), 4), ("dwt_levels", (7, 32), 4),
)
K2_LEVEL_CASES = ((STEP_ROWS, 2048), (STEP_ROWS, 1024))
# The grouped cases hold each mode to its plain version (SSD_TOL) and, beside
# that, to the plain version on float32 copies of the same inputs, which
# rounds nothing: the kernel's states are float32 products of exact bf16
# operands (dte k split into three bf16 terms), so they stay within
# SSD_TOL["float32"] of it, the bf16 y within SSD_TOL[type]. And the states
# mode, handed a nonzero h_in, must return the same bits as without it.


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, launches: int = 20, reps: int = 7, warmup: int = 3) -> float:
    """Time of one ``fn()`` call: CUDA events around ``launches``
    back-to-back calls, divided by the count; the median over ``reps``
    such groups, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def device_ms(fn, kernel: str, calls: int = 20) -> float | None:
    """Device time of one ``fn()`` in the kernels whose names contain
    ``kernel``, from a profile of ``calls`` calls (None if the profiler saw
    none). Beside ``time_ms`` it shows how much of a small kernel's call is
    the host's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(us) / calls / 1e3 if us else None


def bound_ms(n_bytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors to the plain versions for the duration (the
    wrappers' kernel entries are swapped for the ref functions)."""
    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao
    from repro_torch.kernels.forest import kernel as fk, ref as fr
    from repro_torch.kernels.gram import kernel as gk, ref as gr
    from repro_torch.kernels.histogram import kernel as hk, ref as hr
    from repro_torch.kernels.ssd import kernel as sk, ref as sr
    from repro_torch.kernels.wpd import kernel as wk, ref as wr

    def forest_plain(x, proj_nodes, thr, next_node, leaf_probs):
        # The wrapper's operands are K1's tables; the plain version reads
        # proj (T, F, L), which transposing them back gives bit for bit.
        return fr.forest_traverse(x, proj_nodes.transpose(1, 2).contiguous(), thr, leaf_probs)

    saved = (fk.forest_traverse, gk.gram, wk.wpd_level, wk.wpd_tree, wk.dwt_levels,
             hk.class_histogram, hk.level_histogram, ak.flash_attention, sk.ssd_chunks,
             sk.ssd_chunk_states, sk.ssd_chunk_outputs)
    (fk.forest_traverse, gk.gram, wk.wpd_level, wk.wpd_tree, wk.dwt_levels, hk.class_histogram,
     hk.level_histogram, ak.flash_attention, sk.ssd_chunks, sk.ssd_chunk_states,
     sk.ssd_chunk_outputs) = (
        forest_plain, gr.gram, wr.wpd_level, wr.wpd_tree, wr.dwt_levels, hr.class_histogram,
        hr.level_histogram, ao.reference, sr.ssd_chunks, sr.ssd_chunk_states,
        sr.ssd_chunk_outputs)
    try:
        yield
    finally:
        (fk.forest_traverse, gk.gram, wk.wpd_level, wk.wpd_tree, wk.dwt_levels,
         hk.class_histogram, hk.level_histogram, ak.flash_attention, sk.ssd_chunks,
         sk.ssd_chunk_states, sk.ssd_chunk_outputs) = saved


def _kernel_modules() -> dict:
    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.wpd import kernel as wk

    return {"forest": fk, "wpd_level": wk, "gram": gk, "histogram": hk, "flash_attention": ak,
            "ssd_chunks": sk}


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def reset_counts() -> None:
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def path_walk(x, packed):
    """Walk every row down every tree. Returns the (rows,) routing margin,
    min over trees and live path nodes of |x . proj - thr| (how far each
    row is from flipping a route), and what the walk needs: {"visits": live
    (finite-thr) nodes the rows visit in all, the node values the forest
    computes; "nodes": distinct live nodes visited, whose columns, thr and
    next_node entries are read; "leaves": distinct leaves reached, whose
    class rows are read}."""
    import torch

    vals = torch.einsum("bf,tfl->tbl", x, packed.proj)
    rows = torch.arange(x.shape[0], device=x.device)
    out = torch.full((x.shape[0],), float("inf"), device=x.device)
    visits = nodes = leaves = 0
    n_leaves = packed.proj.shape[-1]
    depth = n_leaves.bit_length() - 1
    for t in range(packed.proj.shape[0]):
        node = torch.ones(x.shape[0], dtype=torch.long, device=x.device)
        seen = torch.zeros(n_leaves, dtype=torch.bool, device=x.device)
        for _ in range(depth):
            v, th = vals[t, rows, node], packed.thr[t, node]
            finite = torch.isfinite(th)
            visits += int(finite.sum())
            seen[node[finite]] = True
            out = torch.minimum(out, torch.where(finite, (v - th).abs(), torch.inf))
            node = 2 * node + (v > th).long()
        nodes += int(seen.sum())
        leaves += int(torch.unique(node).numel())
    return out, dict(visits=visits, nodes=nodes, leaves=leaves)


def wpd_check(xr) -> tuple[float, float]:
    """K2's single level on xr (rows, N): (max abs error against the plain
    version, its tolerance 1e-5 * max|x|)."""
    import torch

    from repro_torch.kernels.wpd import kernel as wk, ref as wr
    from repro_torch.signal import wavelet

    h, g = wavelet.filters("db4")
    (ka, kd), (pa, pd) = wk.wpd_level(xr, h, g), wr.wpd_level(xr, h, g)
    torch.cuda.synchronize()
    err = max(float((ka - pa).abs().max()), float((kd - pd).abs().max()))
    return err, 1e-5 * float(xr.abs().max())


def gram_check(xv) -> tuple[float, float]:
    """K3 on xv (..., n, P), as given: (max abs error against the plain
    version, its tolerance 1e-5 * max|G|)."""
    import torch

    from repro_torch.kernels.gram import kernel as gk, ref as gr

    got, want = gk.gram(xv), gr.gram(xv)
    torch.cuda.synchronize()
    return float((got - want).abs().max()), 1e-5 * float(want.abs().max())


def wpd_row(xr) -> dict:
    """K2 against its plain version on xr (rows, N) with the db4 filters
    (max abs error <= 1e-5 * max|x|), timed beside conv1d and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.wpd import kernel as wk, ref as wr
    from repro_torch.signal import wavelet

    h, g = wavelet.filters("db4")  # host taps, as the wavelet module passes them
    weight = torch.stack([h, g])[:, None, :].to(xr.device)  # (2, 1, taps)
    taps = h.shape[0]
    err, tol = wpd_check(xr)
    if not err <= tol:
        fail(f"wpd_level kernel {tuple(xr.shape)} disagrees with its plain version: "
             f"{err} > {tol}")

    def conv():
        return F.conv1d(F.pad(xr[:, None, :], (0, taps - 2), mode="circular"),
                        weight, stride=2)

    b_ms, b_by = bound_ms(4 * 2 * xr.numel(), 2.0 * taps * xr.numel())
    return dict(
        shape=f"x {tuple(xr.shape)}", max_abs_err=err, tol=tol,
        ms=time_ms(lambda: wk.wpd_level(xr, h, g)),
        plain_ms=time_ms(lambda: wr.wpd_level(xr, h, g)),
        library_ms=time_ms(conv), bound_ms=b_ms, bound_by=b_by,
    )


def wpd_chain(x, level: int, tree: bool) -> list:
    """The single-level kernel chained level by level, as the port ran K2
    before one launch took a whole tree: [nodes] for a packet tree (stacked
    into Paley order after each level), [D1, ..., D_level, A_level] for a
    DWT."""
    import torch

    from repro_torch.kernels.wpd import kernel as wk
    from repro_torch.signal import wavelet

    h, g = wavelet.filters("db4")
    if tree:
        nodes = x[:, None, :]
        for _ in range(level):
            a, d = wk.wpd_level(nodes.reshape(-1, nodes.shape[-1]), h, g)
            lead = nodes.shape[:-1] + (-1,)
            nodes = torch.stack([a.reshape(lead), d.reshape(lead)], dim=-2).reshape(
                x.shape[0], -1, a.shape[-1])
        return [nodes]
    coeffs, cur = [], x
    for _ in range(level):
        cur, d = wk.wpd_level(cur, h, g)
        coeffs.append(d)
    return coeffs + [cur]


def tree_filters(h, g, level: int):
    """The packet tree's 2**level composite filters, (2**level, 1, K) float32
    in Paley order, K = (2**level - 1)(taps - 1) + 1: periodization commutes
    with each analysis level (2 (y mod N/2) = 2y mod N), so node i of a
    level-L tree is x circularly convolved with the filters on i's path, the
    level-j one spread 2**(j-1) apart, and taken every 2**L samples."""
    import numpy as np
    import torch

    bank = [np.ones(1)]
    for j in range(level):
        spread = []
        for f in (h, g):
            u = np.zeros((f.shape[0] - 1) * 2**j + 1)
            u[:: 2**j] = f.double().numpy()
            spread.append(u)
        bank = [np.convolve(c, u) for c in bank for u in spread]  # node i -> 2i, 2i + 1
    return torch.tensor(np.stack(bank), dtype=torch.float32)[:, None, :]


def tree_conv(x, bank):
    """One PyTorch call for a packet tree of x (rows, N): circular padding,
    then ``F.conv1d`` with the composite filters ``bank`` at stride
    2**level -> (rows, 2**level, N / 2**level)."""
    import torch.nn.functional as F

    n, stride = x.shape[-1], bank.shape[0]
    pad = bank.shape[-1] - stride
    xp = (F.pad(x[:, None, :], (0, pad), mode="circular") if pad <= n
          else x[:, None, :].repeat(1, 1, -(-(n + pad) // n))[..., : n + pad])
    return F.conv1d(xp, bank, stride=stride)


def multilevel_check(kind: str, x, level: int) -> tuple[float, float, bool]:
    """K2's one-launch ``kind`` ("wpd_tree" or "dwt_levels") on x (rows,
    N): (max abs error against its plain version, its tolerance 1e-5 *
    max|x|, whether it equals the chained single-level kernel bit for
    bit)."""
    import torch

    from repro_torch.kernels.wpd import kernel as wk, ref as wr
    from repro_torch.signal import wavelet

    h, g = wavelet.filters("db4")
    tree = kind == "wpd_tree"

    def listed(v):
        return [v] if tree else v

    got = listed(getattr(wk, kind)(x, h, g, level))
    want = listed(getattr(wr, kind)(x, h, g, level))
    chained = wpd_chain(x, level, tree)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    bits = all(torch.equal(a, b) for a, b in zip(got, chained))
    return err, 1e-5 * float(x.abs().max()), bits


def multilevel_row(kind: str, x, level: int) -> dict:
    """K2's one-launch ``kind`` ("wpd_tree" or "dwt_levels") on x (rows, N)
    at ``level``: within 1e-5 * max|x| of its plain version (the chained
    plain levels) and bit-equal to the chained single-level kernel, timed
    beside both and, for a tree, beside one conv1d with its composite
    filters (``tree_conv``, checked to the same tolerance). No single call
    computes a DWT: each scale has its own stride."""
    from repro_torch.kernels.wpd import kernel as wk, ref as wr
    from repro_torch.signal import wavelet

    h, g = wavelet.filters("db4")
    tree = kind == "wpd_tree"
    fn, plain = getattr(wk, kind), getattr(wr, kind)
    err, tol, bits = multilevel_check(kind, x, level)
    if not err <= tol:
        fail(f"{kind} kernel {tuple(x.shape)} level {level} disagrees with its plain version: "
             f"{err} > {tol}")
    if not bits:
        fail(f"{kind} kernel {tuple(x.shape)} level {level} differs from the chained "
             "single-level kernel")
    # Read x once, write N floats a row once; 2 * taps flops per coefficient
    # pair and level (a tree splits every row-length at every level, a DWT
    # halves what it splits).
    taps = h.shape[0]
    passes = level if tree else 2 - 2.0 ** (1 - level)
    b_ms, b_by = bound_ms(4 * 2 * x.numel(), 2.0 * taps * x.numel() * passes)
    dev = device_ms(lambda: fn(x, h, g, level), "wpd_kernel")
    library_ms, library = None, ""
    if tree:
        bank = tree_filters(h, g, level).to(x.device)
        lib_err = float((tree_conv(x, bank) - plain(x, h, g, level)).abs().max())
        if not lib_err <= tol:
            fail(f"conv1d with the composite filters at {tuple(x.shape)} level {level} is not "
                 f"the packet tree: {lib_err} > {tol}")
        library_ms = time_ms(lambda: tree_conv(x, bank))
        library = f"; library conv1d of {bank.shape[-1]} taps, stride {bank.shape[0]}, error {lib_err:.3e}"
    return dict(
        shape=f"x {tuple(x.shape)}, level {level}", max_abs_err=err, tol=tol,
        note=(f"bit-equal to {level} chained single-level launches "
              f"({time_ms(lambda: wpd_chain(x, level, tree)):.4f} ms){library}; device "
              + ("not measured" if dev is None else f"{dev:.4f} ms (profiler)")),
        ms=time_ms(lambda: fn(x, h, g, level)),
        plain_ms=time_ms(lambda: plain(x, h, g, level)),
        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
    )


def forest_args(x, packed) -> tuple:
    """K1's operands: x and the packed forest's walk tables."""
    return x, packed.proj_nodes, packed.thr, packed.next_node, packed.leaf_probs


def forest_check(x, packed) -> tuple[float, float, int, dict]:
    """K1 on x (rows, F) through the packed forest's walk tables: (max abs
    error against the plain version over the rows whose routing margin is
    at least 1e-4, its tolerance 1e-6, the rows left out, what the walk
    needs as ``path_walk`` counts it)."""
    import torch

    from repro_torch.kernels.forest import kernel as fk, ref as fr

    got = fk.forest_traverse(*forest_args(x, packed))
    want = fr.forest_traverse(x, packed.proj, packed.thr, packed.leaf_probs)
    torch.cuda.synchronize()
    margin, need = path_walk(x, packed)
    safe = margin >= 1e-4
    err = float((got - want).abs()[safe].max())
    return err, 1e-6, int((~safe).sum()), need


def forest_row(x, packed) -> dict:
    """K1 against its plain version on x (rows, F): within 1e-6 on every
    row whose routing margin is at least 1e-4, timed beside its bound."""
    from repro_torch.kernels.forest import kernel as fk, ref as fr

    args = forest_args(x, packed)
    err, tol, flipped, need = forest_check(x, packed)
    if not err <= tol:
        fail(f"forest kernel {tuple(x.shape)} disagrees with its plain version: {err} > {tol}")
    # The function needs one dot product per live node on each row's path
    # (the kernel computes just those), and reads x, the column, thr and
    # next_node entry of each live node visited (and each tree's first
    # entry), the class row of each leaf reached, and writes the output.
    (b, f), n_trees = x.shape, packed.proj.shape[0]
    n_classes = packed.leaf_probs.shape[-1]
    b_ms, b_by = bound_ms(
        4 * (x.numel() + (f + 1 + 2) * need["nodes"] + 2 * n_trees
             + n_classes * need["leaves"] + b * n_classes),
        2.0 * f * need["visits"],
    )
    dev = device_ms(lambda: fk.forest_traverse(*args), "forest_kernel")
    return dict(
        shape=f"x {tuple(x.shape)}, proj {tuple(packed.proj.shape)}",
        max_abs_err=err, tol=tol,
        note=(f"{flipped} rows with margin < 1e-4 excluded; {need['visits']} live path node "
              f"visits, {need['nodes']} live nodes and {need['leaves']} leaves reached; device "
              + ("not measured" if dev is None else f"{dev:.4f} ms (profiler)")),
        ms=time_ms(lambda: fk.forest_traverse(*args)),
        plain_ms=time_ms(lambda: fr.forest_traverse(x, packed.proj, packed.thr,
                                                    packed.leaf_probs)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )


def gram_row(xv) -> dict:
    """K3 against its plain version on xv (..., n, P), as given (pca.fit_T
    hands over a transposed view): max abs error <= 1e-5 * max|G|, timed
    beside torch.matmul and its bound."""
    import torch

    from repro_torch.kernels.gram import kernel as gk, ref as gr

    err, tol = gram_check(xv)
    if not err <= tol:
        fail(f"gram kernel {tuple(xv.shape)} disagrees with its plain version: "
             f"{err} > {tol}")
    n, p = xv.shape[-2:]
    batch = xv.numel() // (n * p)
    # G is symmetric: p (p + 1) / 2 sums of n products per matrix.
    b_ms, b_by = bound_ms(4 * (xv.numel() + batch * p * p), 1.0 * batch * n * p * (p + 1))
    view = "" if xv.is_contiguous() else " (transposed view)"
    return dict(
        shape=f"x {tuple(xv.shape)}{view}", max_abs_err=err, tol=tol,
        ms=time_ms(lambda: gk.gram(xv)),
        plain_ms=time_ms(lambda: gr.gram(xv)),
        library_ms=time_ms(lambda: torch.matmul(xv.transpose(-1, -2), xv)),
        bound_ms=b_ms, bound_by=b_by,
    )


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(program, gen) -> dict[str, dict]:
    import torch

    dev = torch.device("cuda")
    rows = {}

    # The first K1 case, the single K2 levels and K3 draw their inputs from
    # gen in the order they always have; the one-launch K2 cases and K1's
    # second from a generator of their own, so the later phases' traffic,
    # training set and timeline stay the draws they were.
    extra = torch.Generator(device=dev).manual_seed(SEED + 1)

    # K1 (K1_ROWS) on the committed program, whose dead nodes the walk skips.
    packed = program.packed
    for b in K1_ROWS:
        x = torch.randn((b, packed.proj.shape[1]), generator=gen if b == K1_ROWS[0] else extra,
                        device=dev)
        rows["forest" if b == K1_ROWS[0] else f"forest/{b} rows"] = forest_row(x, packed)

    # K2 (K2_CASES): one level, then one launch a packet tree or a DWT.
    for shape in K2_LEVEL_CASES:
        rows[f"wpd_level/{shape[1]}"] = wpd_row(torch.randn(shape, generator=gen, device=dev))
    for kind, shape, level in K2_CASES:
        xr = torch.randn(shape, generator=extra, device=dev)
        rows[f"{kind}/{shape[0]}x{shape[1]} L{level}"] = multilevel_row(kind, xr, level)

    # K3: MSPCA's finest and coarsest per-scale covariances of one step,
    # passed as the transposed view pca.fit_T hands over.
    for n, p in ((1024, 180), (64, 186)):
        xt = torch.randn((MAX_BATCH * REPLAY_DEPTH, p, n), generator=gen, device=dev)
        rows[f"gram/{n}x{p}"] = gram_row(xt.transpose(1, 2))

    print_kernel_rows(rows)
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4: the engine, kernel path and plain path
# ---------------------------------------------------------------------------

def make_traffic(gen):
    """{patient_id: (360, 3, 2048) float32 numpy}: half the patients stay
    interictal, half turn preictal for their last 3 chunks."""
    import torch

    from repro_torch.signal import eeg_data

    per = eeg_data.WINDOWS_PER_MATRIX
    traffic = {}
    for i in range(N_SESSIONS):
        pid = 3 + 10 * i  # the training patient's regime family (odd, id % 5 == 3)
        if i % 2 == 0:
            w = eeg_data.generate_windows(gen, pid, eeg_data.INTERICTAL, CHUNKS_PER_SESSION * per)
        else:
            half = CHUNKS_PER_SESSION // 2 * per
            w = torch.cat([
                eeg_data.generate_windows(gen, pid, eeg_data.INTERICTAL, half),
                eeg_data.generate_windows(gen, pid, eeg_data.PREICTAL, half),
            ])
        traffic[pid] = w.cpu().numpy()
    return traffic


def drive(program, traffic, **engine_kw) -> tuple[list, dict]:
    import torch

    from repro_torch.serving import api

    engine = api.SeizureEngine(program, **(
        {"max_batch": MAX_BATCH, "replay_depth": REPLAY_DEPTH, "device": "cuda"} | engine_kw))
    sessions = {pid: engine.open_session(pid) for pid in traffic}
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi in zip(PUSH_CUTS[:-1], PUSH_CUTS[1:]):
        for pid, s in sessions.items():
            s.push(traffic[pid][lo:hi])
        events += engine.poll(drain=False)
    events += engine.poll()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    scored = [e for e in events if isinstance(e, api.ChunkScored)]
    stats = dict(
        steps=engine.steps, chunks=len(scored), seconds=seconds,
        windows_per_s=len(scored) * engine.chunk_windows / seconds,
        alarms={pid: engine.alarm_state(pid) for pid in traffic},
    )
    return events, stats


def chunk_margins(program, traffic, pid, k):
    import torch

    from repro_torch.signal import features, frontend

    per, ov = 60, program.cfg.overlap
    stream = torch.from_numpy(traffic[pid]).to("cuda")
    chunk = stream[k * per:(k + 1) * per]
    halo = None
    if ov:
        halo = stream[k * per - ov:k * per] if k else torch.zeros_like(chunk[:ov])
        halo = halo[None]
    feats = frontend.chunk_features(chunk[None], program.cfg, halo=halo)[0]
    x, _, _ = features.normalize(feats, program.feat_mean, program.feat_std)
    return path_walk(x, program.packed)[0].cpu().numpy()


def compare_events(got, want, program, traffic) -> int:
    """Events equal under the rule; returns the number of window
    predictions that differ (each checked against its margin)."""
    from repro_torch.serving import api

    if [type(e).__name__ for e in got] != [type(e).__name__ for e in want]:
        fail("kernel path and plain path emit different event sequences")
    differing = 0
    for g, w in zip(got, want):
        if not isinstance(w, api.ChunkScored):
            if tuple(g) != tuple(w):
                fail(f"alarm events differ: {g} vs {w}")
            continue
        if (g.patient_id, g.chunk_index, g.chunk_pred, g.alarm) != (
                w.patient_id, w.chunk_index, w.chunk_pred, w.alarm):
            fail(f"chunk events differ: {g[:5]} vs {w[:5]}")
        bad = (g.window_preds != w.window_preds).nonzero()[0]
        if bad.size:
            with plain_versions():
                margins = chunk_margins(program, traffic, w.patient_id, w.chunk_index)
            if not (margins[bad] < 1e-3).all():
                fail(f"window predictions differ at margins {margins[bad]}")
            differing += bad.size
    return differing


def step_inputs(program, traffic):
    """One full engine step's arguments at (B, D) = (8, 4): the traffic's
    first 4 chunks of each session."""
    import torch

    from repro_torch.serving import api

    chunks = torch.from_numpy(np.stack([
        traffic[pid][:REPLAY_DEPTH * 60].reshape(REPLAY_DEPTH, 60, 3, -1)
        for pid in list(traffic)[:MAX_BATCH]
    ])).to("cuda")  # (B, D, 60, 3, 2048)
    state = api.init_state(MAX_BATCH, program.cfg.alarm_m, device="cuda")
    active = torch.ones((MAX_BATCH, REPLAY_DEPTH), dtype=torch.int32, device="cuda")
    return (state, chunks, active, program.packed, program.feat_mean,
            program.feat_std)


def denoise_covariances(chunks):
    """The covariances one denoise of the (B, D, ...) chunks hands to
    eigh, one batch per wavelet scale."""
    from repro_torch.core import pca
    from repro_torch.signal import mspca

    covs, eig_sorted = [], pca._eig_sorted

    def capture(cov):
        covs.append(cov.clone())
        return eig_sorted(cov)

    pca._eig_sorted = capture
    try:
        mspca.denoise_windows(chunks.reshape(-1, *chunks.shape[2:]))
    finally:
        pca._eig_sorted = eig_sorted
    return covs


def eighs(covs) -> None:
    import torch

    for c in covs:
        torch.linalg.eigh(c)


def stage_times(program, traffic) -> dict[str, float]:
    """CUDA-event medians of one full engine step and of its stages."""
    from repro_torch.serving import api
    from repro_torch.signal import features, mspca

    args = step_inputs(program, traffic)
    chunks = args[1]
    flat = chunks.reshape(-1, *chunks.shape[2:])
    feats = features.wpd_features(flat)
    covs = denoise_covariances(chunks)
    shapes = sorted({tuple(c.shape) for c in covs})

    once = dict(launches=1, reps=5, warmup=1)
    return {
        f"engine step (_engine_step_megabatch, {flat.shape[0]} chunks)": time_ms(
            lambda: api._engine_step_megabatch(*args, cfg=program.cfg), **once),
        f"mspca.denoise_windows ({flat.shape[0]} chunks)": time_ms(
            lambda: mspca.denoise_windows(flat), **once),
        f"torch.linalg.eigh of one denoise ({len(covs)} calls on {shapes})": time_ms(
            lambda: eighs(covs), **once),
        f"features.wpd_features ({flat.shape[0]} chunks)": time_ms(
            lambda: features.wpd_features(flat), launches=5, reps=5),
        f"_vote_chunks (normalize + forest + vote, {feats.shape[0] * feats.shape[1]} rows)":
            time_ms(lambda: api._vote_chunks(
                feats, program.packed, program.feat_mean, program.feat_std)),
    }


def device_activity(fn, trace_name: str, copies: list | None = None):
    """Profile one ``fn()`` (after one warm-up call). Returns the host wall
    time in ms (profiler on), the device's busy time in ms (the union of
    its activity intervals) and {name: [device ms, count]} per kernel or
    copy; None for the last two if the profiler saw no device activity.
    The trace goes to ``chiprun_out/<trace_name>.json.gz``. With a list
    ``copies``, the input shapes of every ``aten::copy_`` are recorded and
    appended to it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=copies is not None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    raw = out / f"{trace_name}.json"
    prof.export_chrome_trace(str(raw))
    with open(raw, "rb") as src, gzip.open(f"{raw}.gz", "wb") as dst:
        dst.write(src.read())
    raw.unlink()

    if copies is not None:
        copies.extend(tuple(e.input_shapes[0]) for e in prof.events()
                      if e.name == "aten::copy_" and e.input_shapes)
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not device:
        return wall_ms, None, None
    busy_us, end_us = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for e in device:
        lo, hi = max(e.time_range.start, end_us), e.time_range.end
        busy_us += max(0.0, hi - lo)
        end_us = max(end_us, hi)
        r = by_name.setdefault(e.name, [0.0, 0])
        r[0] += e.time_range.elapsed_us() / 1e3
        r[1] += 1
    return wall_ms, busy_us / 1e3, by_name


def trace_step(program, traffic) -> None:
    """Device busy and idle share of one engine step and of the eigh calls
    of one denoise, and the step's device time by kernel."""
    from repro_torch.serving import api

    args = step_inputs(program, traffic)
    covs = denoise_covariances(args[1])
    for what, fn, name in (
        ("one engine step", lambda: api._engine_step_megabatch(*args, cfg=program.cfg),
         "engine_step_trace"),
        (f"the {len(covs)} eigh calls of one denoise", lambda: eighs(covs), "eigh_trace"),
    ):
        wall_ms, busy_ms, by_name = device_activity(fn, name)
        if busy_ms is None:
            print(f"trace {what}: {wall_ms:.3f} ms wall; the profiler recorded no "
                  "device activity: busy and idle share not measured")
            continue
        print(f"trace {what}: {wall_ms:.3f} ms wall (profiler on), device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
              f"{sum(n for _, n in by_name.values())} device activities")
        if name != "engine_step_trace":
            continue
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        ours = [kv for kv in ranked
                if any(k in kv[0] for k in ("forest_kernel", "gram_kernel", "wpd_kernel"))]
        for kname, (ms, n) in ranked[:10] + ours:
            print(f"trace kernel: {ms:.3f} ms in {n} launches: {kname[:110]}")


# ---------------------------------------------------------------------------
# Phase 4b: snapshot/restore, the streaming frontend, the reference_kernels leg
# ---------------------------------------------------------------------------

def snap_start(program, traffic, *, megabatch: bool, snapshot_dir=None, **engine_kw):
    """An engine of SNAP_BATCH slots serving the traffic's push rounds up
    to and including the push of round SNAP_ROUND, where it snapshots into
    ``snapshot_dir`` (if given) before that round's poll. Returns the
    engine, the events so far (the head) and the snapshot's ms."""
    import torch

    from repro_torch.serving import api

    engine = api.SeizureEngine(program, **(
        {"max_batch": SNAP_BATCH, "replay_depth": REPLAY_DEPTH, "megabatch": megabatch,
         "device": "cuda"} | engine_kw))
    sessions = {pid: engine.open_session(pid) for pid in traffic}
    head, snap_ms = [], None
    for r, (lo, hi) in enumerate(zip(PUSH_CUTS[:-1], PUSH_CUTS[1:])):
        for pid, s in sessions.items():
            s.push(traffic[pid][lo:hi])
        if r == SNAP_ROUND:
            if snapshot_dir is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.snapshot(str(snapshot_dir), step=SNAP_ROUND)
                snap_ms = (time.perf_counter() - t0) * 1e3
            return engine, head, snap_ms
        head += engine.poll(drain=False)


def snap_resume(engine, traffic) -> tuple[list, list[float]]:
    """The schedule's rest from the snapshot point (the tail), with the
    synchronized wall ms of each device step it ran."""
    import torch

    step, step_ms = engine._step, []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine._step = timed
    events = engine.poll(drain=False)
    for lo, hi in zip(PUSH_CUTS[SNAP_ROUND + 1:-1], PUSH_CUTS[SNAP_ROUND + 2:]):
        for pid in traffic:
            engine.session(pid).push(traffic[pid][lo:hi])
        events += engine.poll(drain=False)
    events += engine.poll()
    engine._step = step
    return events, step_ms


def first_difference(got, want) -> str | None:
    """None when the two event lists are equal in every field (window
    predictions and preictal_frac included), else the first difference."""
    from repro_torch.serving import api

    if len(got) != len(want):
        return f"{len(got)} events against {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if type(g) is not type(w):
            return f"event {i}: {type(g).__name__} against {type(w).__name__}"
        if isinstance(w, api.ChunkScored):
            same = (g[:5] + (g.program_version,) == w[:5] + (w.program_version,)
                    and np.array_equal(g.window_preds, w.window_preds))
            if not same:
                bad = np.flatnonzero(g.window_preds != w.window_preds)
                return (f"first differing chunk: patient {w.patient_id} chunk {w.chunk_index}: "
                        f"{g[:5]} against {w[:5]}, window predictions differ at {bad.tolist()}")
        elif tuple(g) != tuple(w):
            return f"event {i}: {g} against {w}"
    return None


def snapshot_phase(program, traffic) -> dict[str, int]:
    """Snapshot/restore at full width, overlap 0 and 2: SNAP_BATCH slots
    for the 8 sessions, so slots are bound and sessions wait when the
    snapshot is taken (after the push of round SNAP_ROUND, before its
    poll). The live engine must go on exactly as one never snapshotted;
    restored with megabatch=True its tail must equal the live tail bit for
    bit, and with megabatch=False the uninterrupted serial engine's tail
    (the snapshot holds votes and raw windows only), within the event rule
    of the live tail. A restored engine launches K1 1, K2 2 and K3 6 times a
    step (the serial step: a backlog position). Returns the restored
    engines' launches."""
    import shutil

    import torch

    from repro_torch.serving import api

    launches = {"forest": 0, "wpd_level": 0, "gram": 0}
    root = ROOT / "build" / "engine_snapshots"
    shutil.rmtree(root, ignore_errors=True)
    for overlap in (0, 2):
        prog = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                  program.cfg._replace(overlap=overlap))
        full = {}
        for mb in (True, False):
            engine, head, _ = snap_start(prog, traffic, megabatch=mb)
            full[mb] = head + snap_resume(engine, traffic)[0]
        directory = root / f"overlap{overlap}"
        engine, head, snap_ms = snap_start(prog, traffic, megabatch=True,
                                           snapshot_dir=directory)
        queued = sum(s.pending_chunks for s in engine._sessions.values())
        waiting = len(engine._waiting)
        live_tail, live_ms = snap_resume(engine, traffic)
        diff = first_difference(head + live_tail, full[True])
        if diff is not None:
            fail(f"snapshot overlap={overlap}: the live engine changed after its snapshot: {diff}")
        step_dir = directory / f"step_{SNAP_ROUND:08d}"
        mb_size = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e6
        print(f"snapshot overlap={overlap}: {snap_ms:.3f} ms, {mb_size:.3f} MB on disk, "
              f"{len(head)} events before it, {queued} chunks queued, {waiting} sessions "
              f"waiting; the live engine's tail is unchanged by it ({len(live_tail)} events)")
        if waiting == 0:
            fail(f"snapshot overlap={overlap}: no session waits at the snapshot")
        for mb in (True, False):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = api.SeizureEngine.restore(str(directory), megabatch=mb, device="cuda")
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            steps0 = restored.steps
            tail, step_ms = snap_resume(restored, traffic)
            counts = launch_counts()
            # The serial step runs the heavy stage once per backlog position.
            steps = restored.steps - steps0
            passes = steps * (1 if mb else REPLAY_DEPTH)
            want = {"forest": passes, "wpd_level": 2 * passes, "gram": 6 * passes}
            if {k: counts[k] for k in want} != want:
                fail(f"restored engine overlap={overlap} megabatch={mb}: launches {counts} over "
                     f"{steps} steps, expected {want}")
            for k in launches:
                launches[k] += counts[k]
            oracle = live_tail if mb else full[False][len(head):]
            diff = first_difference(tail, oracle)
            if diff is not None:
                fail(f"restored engine overlap={overlap} megabatch={mb} is not bit-identical "
                     f"to the uninterrupted engine: {diff}")
            if mb:
                note = (f"bit-identical to the live engine's; first step after the restore "
                        f"{step_ms[0]:.3f} ms against {live_ms[0]:.3f} ms for the live "
                        "engine's same step")
            else:
                differing = compare_events(tail, live_tail, prog, traffic)
                note = ("bit-identical to the uninterrupted serial engine's and within the "
                        f"event rule of the live megabatch tail ({differing} window predictions "
                        f"differ); first step after the restore {step_ms[0]:.3f} ms")
            print(f"restore overlap={overlap} megabatch={mb}: {restore_ms:.3f} ms; tail of "
                  f"{len(tail)} events {note}, a steady step (median of the restored "
                  f"engine's later steps) {statistics.median(step_ms[1:]):.3f} ms; "
                  f"{steps} steps, launches { {k: counts[k] for k in want} }")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def streaming_phase(program, traffic) -> dict[str, int]:
    """One session's stream fed to a StreamingFrontend (overlap 2) in the
    chunk-unaligned PUSH_CUTS pieces; after the piece of round SNAP_ROUND
    (between chunk boundaries) its state_dict resumes a new one. Both must
    give the same bits, and those of pipeline.process_windows of the
    chunk-aligned stream. Each chunk fed launches K2 twice and K3 six
    times. Returns the feeds' launches."""
    import torch

    from repro_torch.signal import frontend, pipeline

    cfg = program.cfg._replace(overlap=2)
    pid = next(iter(traffic))
    stream = traffic[pid]
    pieces = [stream[lo:hi] for lo, hi in zip(PUSH_CUTS[:-1], PUSH_CUTS[1:])]
    full = frontend.StreamingFrontend(cfg, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [full.feed(p) for p in pieces[:SNAP_ROUND + 1]]
    saved = full.state_dict()
    seen, pending = full.chunks_seen, full.pending_windows
    resumed = frontend.StreamingFrontend(cfg, device="cuda")
    resumed.load_state_dict(saved)
    outs += [full.feed(p) for p in pieces[SNAP_ROUND + 1:]]
    feed_s = time.perf_counter() - t0
    tail = np.concatenate([resumed.feed(p) for p in pieces[SNAP_ROUND + 1:]])
    counts = launch_counts()
    fed = full.chunks_seen + resumed.chunks_seen - seen
    want = {"forest": 0, "wpd_level": 2 * fed, "gram": 6 * fed}
    if {k: counts[k] for k in want} != want:
        fail(f"streaming frontend: launches {counts} over {fed} chunks, expected {want}")
    if not np.array_equal(tail, np.concatenate(outs[SNAP_ROUND + 1:])):
        fail("the resumed StreamingFrontend's features differ from the uninterrupted one's")
    got = np.concatenate(outs)
    batch = pipeline.process_windows(torch.from_numpy(stream).to("cuda"), cfg).cpu().numpy()
    if got.shape != batch.shape or not np.array_equal(got, batch):
        fail("the StreamingFrontend's features differ from pipeline.process_windows'")
    print(f"streaming frontend overlap=2: {len(pieces)} pieces of {[len(p) for p in pieces]} "
          f"windows -> {got.shape} features in {feed_s:.3f} s; state_dict after piece "
          f"{SNAP_ROUND} ({seen} chunks seen, {pending} windows pending) resumes bit-equal, "
          f"and both equal pipeline.process_windows bit for bit; launches {want}")
    return want


def reference_leg_phase(program, traffic, default_runs) -> dict[str, int]:
    """The traffic through an engine whose program has reference_kernels=
    True, at overlap 0 and 2: events within the rule of the default leg's
    (``default_runs[overlap]``: events and stats), K1 1, K2 9 (5 DWT and 4
    packet levels, each K2's single level) and K3 6 launches a step. K2's
    single level and K3 are held against their plain versions on every
    input shape the leg gave them. Returns the leg's launches."""
    import torch

    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.wpd import kernel as wk
    from repro_torch.serving import api

    launches = {"forest": 0, "wpd_level": 0, "gram": 0}
    for overlap in (0, 2):
        prog = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                  program.cfg._replace(overlap=overlap))
        leg = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                 prog.cfg._replace(reference_kernels=True))
        captured: dict[str, dict] = {"wpd_level": {}, "gram": {}}
        level, gram = wk.wpd_level, gk.gram

        def level_hook(x, h, g):
            captured["wpd_level"].setdefault(tuple(x.shape), x)
            return level(x, h, g)

        def gram_hook(x):
            captured["gram"].setdefault((tuple(x.shape), x.stride()), x)
            return gram(x)

        reset_counts()
        wk.wpd_level, gk.gram = level_hook, gram_hook
        try:
            events, stats = drive(leg, traffic)
        finally:
            wk.wpd_level, gk.gram = level, gram
        counts = launch_counts()
        want = {"forest": stats["steps"], "wpd_level": 9 * stats["steps"],
                "gram": 6 * stats["steps"]}
        if {k: counts[k] for k in want} != want:
            fail(f"reference_kernels leg overlap={overlap}: launches {counts} over "
                 f"{stats['steps']} steps, expected {want}")
        for k in launches:
            launches[k] += counts[k]
        default_events, default_stats = default_runs[overlap]
        differing = compare_events(events, default_events, prog, traffic)
        print(f"reference_kernels leg overlap={overlap}: steps {stats['steps']}, "
              f"{stats['windows_per_s']:.1f} windows/s ({stats['seconds']:.2f} s) against "
              f"the default leg's {default_stats['windows_per_s']:.1f}; events equal, "
              f"{differing} window predictions differ (all at routing margin < 1e-3); "
              f"launches {counts}")
        for shape, x in captured["wpd_level"].items():
            err, tol = wpd_check(x)
            if not err <= tol:
                fail(f"wpd_level kernel {shape} (reference_kernels leg) disagrees with its "
                     f"plain version: {err} > {tol}")
        for (shape, stride), x in captured["gram"].items():
            err, tol = gram_check(x)
            if not err <= tol:
                fail(f"gram kernel {shape} strides {stride} (reference_kernels leg) disagrees "
                     f"with its plain version: {err} > {tol}")
        print(f"reference_kernels leg overlap={overlap}: K2's single level within 1e-5 max|x| "
              f"of its plain version at all {len(captured['wpd_level'])} shapes the leg gave it "
              f"({sorted(captured['wpd_level'])}), K3 within 1e-5 max|G| at "
              f"{sorted(s for s, _ in captured['gram'])}")
        del captured
        torch.cuda.empty_cache()
    # The leg's scatter-add synthesis adds with atomics (index_add_): read
    # whether two calls on the same inputs give the same bits.
    from repro_torch.signal import wavelet

    extra = torch.Generator(device="cuda").manual_seed(SEED + 2)
    a, d = (torch.randn((MAX_BATCH * REPLAY_DEPTH, 180, 1024), generator=extra, device="cuda")
            for _ in range(2))
    first, second = (wavelet.synthesis_step_reference(a, d) for _ in range(2))
    print(f"reference_kernels leg: scatter-add synthesis of {tuple(a.shape)} twice on the same "
          f"inputs: {int((first != second).sum())} of {first.numel()} outputs differ")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: training on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def stage_clock(stages: dict, owner, name: str, label: str, hook=None):
    """Add the synchronized wall time of every call of ``owner.name`` to
    ``stages[label]`` for the duration (``hook(args, kwargs)`` sees each
    call's arguments)."""
    import torch

    fn = getattr(owner, name)
    stages.setdefault(label, 0.0)

    def timed(*args, **kwargs):
        if hook is not None:
            hook(args, kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages[label] += time.perf_counter() - t0
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def training_set(gen):
    from repro_torch.signal import eeg_data

    per = eeg_data.WINDOWS_PER_MATRIX
    return eeg_data.stratify_chunks(eeg_data.make_training_set(
        gen, TRAIN_PATIENT, n_interictal_windows=TRAIN_CHUNKS_PER_CLASS * per,
        n_preictal_windows=TRAIN_CHUNKS_PER_CLASS * per,
    ))


def timed_fit(gen, rec, cfg):
    """One MapReduce fit with its stage times (seconds) and the kernels'
    inputs as the fit handed them over: {"histogram": {level: (codes,
    local, y, w, kwargs)}, "wpd_tree" and "dwt_levels": {(shape, level):
    x}, "gram": {shape: x}, "grower": {"call": (args, kwargs)}}, the last
    call per level and grower call, the first per shape."""
    import torch

    from repro_torch.core import decision_tree as dt
    from repro_torch.core import pca
    from repro_torch.core import rotation_forest as rf
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.wpd import kernel as wk
    from repro_torch.signal import pipeline

    stages: dict[str, float] = {}
    captured: dict[str, dict] = {"histogram": {}, "wpd_tree": {}, "dwt_levels": {}, "gram": {},
                                 "grower": {}}

    def k2_hook(kind):
        def capture(a, _):
            rows = a[0].reshape(-1, a[0].shape[-1])
            captured[kind].setdefault((tuple(rows.shape), a[3]), rows)
        return capture

    with contextlib.ExitStack() as stack:
        for owner, name, label, hook in (
            (pipeline, "process_windows", "feature extraction (MSPCA + WPD)", None),
            (pca, "_eig_sorted", "of which MSPCA eigh (pca._eig_sorted)", None),
            (wk, "wpd_tree", "of which K2 (WPD trees and DWTs)", k2_hook("wpd_tree")),
            (wk, "dwt_levels", "of which K2 (WPD trees and DWTs)", k2_hook("dwt_levels")),
            (gk, "gram", "of which K3 gram (MSPCA covariances)",
             lambda a, _: captured["gram"].setdefault(tuple(a[0].shape), a[0])),
            (rf, "_prepare_trees", "tree prep (rotation, x @ R, binning)", None),
            (rf, "_build_rotation", "of which rotation", None),
            (rf, "_block_components", "of which rotation eigh", None),
            (dt, "fit_forest_binned", "grower",
             lambda a, kw: captured["grower"].__setitem__("call", (a, kw))),
            (hist_ops, "level_histogram", "of which K4 histogram (one launch a level)",
             lambda a, kw: captured["histogram"].__setitem__(
                 kw["nodes_at"].bit_length() - 1, (*a, kw))),
        ):
            stack.enter_context(stage_clock(stages, owner, name, label, hook))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted = pipeline.fit(gen, rec, cfg, n_shards=TRAIN_SHARDS)
        torch.cuda.synchronize()
        stages["fit"] = time.perf_counter() - t0
    return fitted, stages, captured


def _z_units(got, want) -> dict[str, float]:
    """|got - want| over want's per-feature std: max, 99.9th and 99th
    percentile, and median over all entries."""
    import torch

    z = ((got - want).abs() / (want.std(dim=0) + 1e-6)).flatten()
    q = torch.quantile(z, torch.tensor([0.5, 0.99, 0.999], device=z.device)).tolist()
    return dict(max=float(z.max()), p999=q[2], p99=q[1], median=q[0])


def check_fit_features(captured, rec, cfg) -> None:
    """K2 (one level, and each tree and DWT launch) and K3 against their
    plain versions on every input shape the fit handed them (the checks of
    phase 2); then one shard's training
    features three ways: through the kernels, through the plain versions
    on the card, and through the port on the host CPU (LAPACK's eigh,
    the path the CPU tests hold to the reference). MSPCA's eigh turns the
    float32 rounding differences of any two paths into feature
    differences, largest in the chunks whose kept subspace is nearly
    degenerate, so the kernel path is held to the card's own plain path:
    its distance from the CPU features, in z-units (difference over the
    CPU features' per-feature std), may be at most twice the plain
    path's at the 99th and the 99.9th percentile. A kernel that is wrong
    everywhere moves the first, one wrong in a feature or a chunk the
    second."""
    from repro_torch.signal import pipeline

    rows = {}
    for kind in ("wpd_tree", "dwt_levels"):
        for (shape, level), x in captured[kind].items():
            rows.setdefault(f"wpd_level/fit {shape}", wpd_row(x))
            rows[f"{kind}/fit {shape[0]}x{shape[1]} L{level}"] = multilevel_row(kind, x, level)
    rows.update({f"gram/fit {tuple(x.shape)}": gram_row(x)
                 for x in captured["gram"].values()})
    print_kernel_rows(rows)
    shard = rec.windows[: rec.windows.shape[0] // TRAIN_SHARDS]
    kernel = pipeline.process_windows(shard, cfg)
    with plain_versions():
        plain = pipeline.process_windows(shard, cfg)
    host = pipeline.process_windows(shard.cpu(), cfg)
    z = {
        "kernel vs plain": _z_units(kernel, plain),
        "kernel vs CPU": _z_units(kernel.cpu(), host),
        "plain vs CPU": _z_units(plain.cpu(), host),
    }
    for pair, r in z.items():
        print(f"train features, shard 0 ({shard.shape[0]} windows -> {tuple(kernel.shape)}), "
              f"{pair}: z-units max {r['max']:.3e}, p99.9 {r['p999']:.3e}, "
              f"p99 {r['p99']:.3e}, median {r['median']:.3e}")
    for q in ("p99", "p999"):
        if not z["kernel vs CPU"][q] <= 2 * z["plain vs CPU"][q]:
            fail(f"training features through the kernels are {z['kernel vs CPU'][q]} z-units "
                 f"({q}) from the CPU port's, more than twice the plain path's "
                 f"{z['plain vs CPU'][q]}")


def level_check(inputs, gen) -> tuple[float, float]:
    """K4's level mode on one grower level's inputs (codes, local, y, w,
    kwargs) against its plain version: (max abs error on the level's 0/1
    weights, which must be 0; relative error on random float weights drawn
    from ``gen``, which must be at most 1e-5)."""
    import torch

    from repro_torch.kernels.histogram import kernel as hk, ref as hr

    codes, local, y, w, kw = inputs
    wf = torch.rand(w.shape, generator=gen, device=w.device)
    got, got_f = (hk.level_histogram(codes, local, y, v, **kw) for v in (w, wf))
    want, want_f = (hr.level_histogram(codes, local, y, v, **kw) for v in (w, wf))
    torch.cuda.synchronize()
    return (float((got - want).abs().max()),
            float((got_f - want_f).abs().max() / want_f.abs().max()))


def class_check(codes, wy, n_buckets, gen) -> tuple[float, float]:
    """K4's class mode (the TPU kernel's contract) against its plain
    version: (max abs error on the masses wy, 0 required where they are
    0/1; relative error on random float masses from ``gen``, 1e-5)."""
    import torch

    from repro_torch.kernels.histogram import kernel as hk, ref as hr

    got, want = (m.class_histogram(codes, wy, n_buckets) for m in (hk, hr))
    wf = torch.rand(wy.shape, generator=gen, device=wy.device)
    got_f, want_f = (m.class_histogram(codes, wf, n_buckets) for m in (hk, hr))
    torch.cuda.synchronize()
    return (float((got - want).abs().max()),
            float((got_f - want_f).abs().max() / want_f.abs().max()))


def sliced_case(gen) -> tuple:
    """Beyond one block's shared memory: a depth-12 grower's deepest level
    at 32 bins (65536 buckets x 2 classes = 512 KB) is built in bucket
    slices. 16 features keep the output at 42 MB. (codes, wy, n_buckets)."""
    import torch

    t, n, f, nb = 5, 960, 16, 65536
    codes = torch.randint(-1, nb + 1, (t, n, f), generator=gen, device=gen.device,
                          dtype=torch.int32)
    boot = (torch.rand((t, n, 1), generator=gen, device=gen.device) < 0.632).float()
    label = torch.randint(0, 2, (n,), generator=gen, device=gen.device)
    return codes, boot * torch.nn.functional.one_hot(label, 2).float(), nb


def ragged_level_cases(gen) -> dict[str, tuple]:
    """K4's level mode off the fit's shapes, on random grower inputs (0/1
    weights): N neither a multiple of 16 nor of a pass (codes read without
    16-byte loads, in three passes), 37 features (a short last group), and
    33 buckets of 2 classes (an output row of 66 floats, written without
    16-byte stores); and int32 codes at 300 bins in two passes, one
    feature a block. {label: (codes, local, y, w, kwargs)}."""
    import torch

    cases = {}
    for t, n, f, nodes_at, n_bins, dtype in ((3, 2500, 37, 1, 33, torch.uint8),
                                             (3, 1040, 37, 8, 300, torch.int32)):
        dev = gen.device
        codes = torch.randint(0, n_bins, (t, f, n), generator=gen, device=dev).to(dtype)
        local = torch.randint(0, nodes_at, (t, n), generator=gen, device=dev, dtype=torch.int32)
        y = torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.int32)
        w = (torch.rand((t, n), generator=gen, device=dev) < 0.75).float()
        kw = dict(nodes_at=nodes_at, n_bins=n_bins, n_classes=2)
        label = f"{str(dtype).split('.')[1]} codes {(t, f, n)}, {nodes_at * n_bins} buckets"
        cases[label] = (codes, local, y, w, kw)
    return cases


def class_inputs(inputs) -> tuple:
    """The TPU kernel's inputs for one grower level: the (T, N, F) int32
    bucket ids local * n_bins + bin and the masses w * onehot(y)."""
    import torch

    codes, local, y, w, kw = inputs
    ids = local[:, :, None] * kw["n_bins"] + codes.transpose(1, 2).to(torch.int32)
    wy = w[..., None] * torch.nn.functional.one_hot(y.long(), kw["n_classes"]).float()
    return ids.contiguous(), wy.contiguous(), kw["nodes_at"] * kw["n_bins"]


def check_histogram(captured, gen) -> dict[str, dict]:
    """K4 against its plain versions. The level mode, as the grower calls
    it, on the fit's own inputs at every level: exact on its 0/1 weights,
    within 1e-5 relative on random float weights; each level timed beside
    its plain version, its bound and the library call (the bucket ids
    computed, then one ``index_put_`` accumulate: the scatter of the class
    mode's yardstick). The class mode (the TPU kernel's contract) on the
    same levels' bucket ids and masses at levels 0 and 5, likewise, and on
    a 65536-bucket histogram built in shared-memory slices. The level mode
    also on ``ragged_level_cases``."""
    import torch

    from repro_torch.kernels.histogram import kernel as hk, ref as hr

    rows = {}
    # The float weights of the level mode and its ragged cases come from a
    # generator of their own: the class mode's draws from gen below are the
    # ones this phase has always made, so the held-out timeline drawn after
    # it stays the draw it was.
    extra = torch.Generator(device=gen.device).manual_seed(SEED + 2)
    for label, inputs in ragged_level_cases(extra).items():
        err, rel_f = level_check(inputs, extra)
        print(f"kernel histogram/{label}: max_abs_err {err:.3e} (tol 0); float weights: "
              f"relative error {rel_f:.2e} (tol 1e-5)")
        if err != 0.0 or not rel_f <= 1e-5:
            fail(f"histogram kernel ({label}) differs from its plain version: {err} on 0/1 "
                 f"weights, relative {rel_f} on float weights")
    for level in sorted(captured):
        codes, local, y, w, kw = inputs = captured[level]
        err, rel_f = level_check(inputs, extra)
        if err != 0.0:
            fail(f"histogram kernel (level {level}) differs from its plain version on the "
                 f"fit's 0/1 weights by {err}")
        if not rel_f <= 1e-5:
            fail(f"histogram kernel (level {level}) on float weights: relative error "
                 f"{rel_f} > 1e-5")
        (t, f, n), c = codes.shape, kw["n_classes"]
        nb = kw["nodes_at"] * kw["n_bins"]
        dev = codes.device
        trees = torch.arange(t, device=dev)[:, None, None]
        feats = torch.arange(f, device=dev)[:, None]

        def library():
            ids = local.long()[:, None, :] * kw["n_bins"] + codes.long()
            return torch.zeros((t, f, nb, c), device=dev).index_put_(
                (trees, feats, ids, y.long()), w[:, None, :].expand(t, f, n), accumulate=True)

        if not torch.equal(library(), hr.level_histogram(codes, local, y, w, **kw)):
            fail(f"index_put_ yardstick disagrees with the plain level histogram (level {level})")
        # Bytes: codes, local, y and w read once, the histogram written once;
        # one add per live (sample, feature).
        live = int((w != 0).sum())
        b_ms, b_by = bound_ms(
            codes.numel() * codes.element_size() + 4 * (local.numel() + y.numel() + w.numel())
            + 4 * t * f * nb * c, 1.0 * live * f)
        rows[f"histogram/L{level} {nb}"] = dict(
            shape=f"codes {tuple(codes.shape)} {str(codes.dtype).split('.')[1]}, local "
                  f"{tuple(local.shape)}, {nb} buckets x {c} classes",
            max_abs_err=err, tol=0.0,
            note=f"float weights: relative error {rel_f:.2e} (tol 1e-5); {live} live samples",
            ms=time_ms(lambda: hk.level_histogram(codes, local, y, w, **kw)),
            plain_ms=time_ms(lambda: hr.level_histogram(codes, local, y, w, **kw)),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
        )
    for level in (max(captured), min(captured)):
        codes, wy, nb = class_inputs(captured[level])
        (t, n, f), c = codes.shape, wy.shape[-1]
        err, rel_f = class_check(codes, wy, nb, gen)
        if err != 0.0:
            fail(f"class_histogram kernel ({nb} buckets) differs from its plain version "
                 f"on 0/1 masses by {err}")
        if not rel_f <= 1e-5:
            fail(f"class_histogram kernel ({nb} buckets) on float weights: relative "
                 f"error {rel_f} > 1e-5")
        # The library yardstick: one index_put_ accumulate of the same
        # scatter (out-of-range codes to a spill bucket).
        safe = torch.where((codes >= 0) & (codes < nb), codes, nb).long()
        dev = codes.device
        index = (torch.arange(t, device=dev)[:, None, None, None],
                 torch.arange(f, device=dev)[None, None, :, None],
                 safe[..., None], torch.arange(c, device=dev))
        values = wy[:, :, None, :].expand(t, n, f, c)

        def library():
            return torch.zeros((t, f, nb + 1, c), device=dev).index_put_(
                index, values, accumulate=True)

        if not torch.equal(library()[:, :, :nb], hr.class_histogram(codes, wy, nb)):
            fail("index_put_ yardstick disagrees with the plain histogram")
        # Bytes: codes and wy read once, the histogram written once; one add
        # per sample, feature and class.
        b_ms, b_by = bound_ms(4 * (codes.numel() + wy.numel() + t * f * nb * c),
                              1.0 * codes.numel() * c)
        rows[f"class_histogram/L{level} {nb}"] = dict(
            shape=f"codes {tuple(codes.shape)}, wy {tuple(wy.shape)}, {nb} buckets",
            max_abs_err=err, tol=0.0,
            note=f"float weights: relative error {rel_f:.2e} (tol 1e-5)",
            ms=time_ms(lambda: hk.class_histogram(codes, wy, nb)),
            plain_ms=time_ms(lambda: hr.class_histogram(codes, wy, nb)),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
        )
    codes, wy, nb = sliced_case(gen)
    err = float((hk.class_histogram(codes, wy, nb) - hr.class_histogram(codes, wy, nb)).abs().max())
    print(f"kernel class_histogram/{nb}: codes {tuple(codes.shape)}, in bucket slices: "
          f"max_abs_err {err:.3e} (tol 0)")
    if err != 0.0:
        fail(f"class_histogram kernel ({nb} buckets, sliced) differs from its plain version "
             f"by {err}")
    print_kernel_rows(rows)
    return rows


def trace_grower(captured) -> None:
    """Device busy and idle share of one ``fit_forest_binned`` call (the
    fit's last, replayed on its own inputs), and its largest operations."""
    from repro_torch.core import decision_tree as dt

    args, kwargs = captured["call"]
    wall_ms, busy_ms, by_name = device_activity(lambda: dt.fit_forest_binned(*args, **kwargs),
                                                "grower_trace")
    if busy_ms is None:
        print(f"trace one grower call: {wall_ms:.3f} ms wall; the profiler recorded no device "
              "activity: busy and idle share not measured")
        return
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top = "; ".join(f"{ms:.3f} ms in {n}: {name[:60]}" for name, (ms, n) in ranked[:6])
    print(f"trace one grower call (fit_forest_binned, xb {tuple(args[0].shape)}): {wall_ms:.3f} "
          f"ms wall (profiler on), device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}, {sum(n for _, n in by_name.values())} device "
          f"activities; largest: {top}")


def serve_timeline(engine, patient, windows, lo, hi) -> list:
    """Push windows[lo:hi] PUSH at a time, polling after each; the scored
    chunk events."""
    from repro_torch.serving import api

    session = engine.session(patient) or engine.open_session(patient)
    events = []
    for i in range(lo, hi, PUSH):
        session.push(windows[i:min(i + PUSH, hi)])
        events += engine.poll()
    return [e for e in events if isinstance(e, api.ChunkScored)]


def training_phase(gen, committed) -> tuple[dict, dict, dict]:
    """Phase 6. Returns the K4 rows, every kernel's launches in the first
    fit, and what phase 6c compares with: the training set, the
    generator's state just before the first fit, that fit and its
    seconds."""
    import tempfile

    import torch

    from repro_torch.serving import api
    from repro_torch.signal import eeg_data, features, pipeline

    cfg = pipeline.PipelineConfig()
    rec = training_set(gen)
    n_train = rec.windows.shape[0]
    print(f"train data: {n_train} windows {tuple(rec.windows.shape[1:])} "
          f"({rec.windows.numel() * 4 / 1e6:.1f} MB), {int(rec.labels.sum())} preictal, "
          f"cfg {cfg}")
    fit_state = gen.get_state()  # phase 6c starts its ranks from here (no draw)
    reset_counts()
    fitted, stages, captured = timed_fit(gen, rec, cfg)
    counts = launch_counts()
    n_levels = cfg.forest.depth * TRAIN_SHARDS
    print(f"train fit: {TRAIN_SHARDS} shards -> {fitted.forest.rotation.shape[0]} trees, "
          f"{stages['fit']:.3f} s, {n_train / stages['fit']:.1f} training windows/s; "
          f"launches {counts}")
    for label, sec in stages.items():
        if label != "fit":
            print(f"train stage {label}: {sec:.3f} s ({sec / stages['fit']:.1%} of the fit)")
    if counts["histogram"] != n_levels:
        fail(f"K4 launched {counts['histogram']} times in the fit, expected {n_levels}")
    # Feature extraction runs one DWT and one packet tree per chunk (K2).
    n_chunks = n_train // eeg_data.WINDOWS_PER_MATRIX
    if counts["wpd_level"] != 2 * n_chunks:
        fail(f"K2 launched {counts['wpd_level']} times in the fit, expected 2 per chunk "
             f"({2 * n_chunks})")
    if counts["gram"] == 0:
        fail(f"K3 never launched in the fit: {counts}")
    if fitted.forest.rotation.shape[0] != cfg.forest.n_trees:
        fail(f"union forest has {fitted.forest.rotation.shape[0]} trees")
    check_fit_features(captured, rec, cfg)
    rows = check_histogram(captured["histogram"], gen)
    trace_grower(captured["grower"])

    # Checkpoint, reload, serve a held-out timeline.
    with tempfile.TemporaryDirectory(prefix="seizure_program_") as directory:
        api.ScoringProgram.from_fitted(fitted, cfg).save(directory)
        program = api.ScoringProgram.load(directory, device="cuda")
    timeline = eeg_data.make_test_timeline(gen, TRAIN_PATIENT, hours_interictal=1)
    wins = timeline.windows.cpu().numpy()
    per = eeg_data.WINDOWS_PER_MATRIX
    n_chunks = wins.shape[0] // per
    engine = api.SeizureEngine(program, max_batch=4, replay_depth=4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = serve_timeline(engine, TRAIN_PATIENT, wins, 0, wins.shape[0])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    res = pipeline.evaluate_timeline(fitted, timeline, cfg)
    if [e.alarm for e in scored] != res.alarms.tolist() or len(scored) != n_chunks:
        fail(f"served alarms {[e.alarm for e in scored]} != evaluate_timeline "
             f"{res.alarms.tolist()}")
    labels = timeline.labels.cpu()
    acc = float((res.window_preds == labels).float().mean())
    ref = pipeline.evaluate_program(committed, timeline)
    ref_acc = float((ref.window_preds == labels).float().mean())
    print(f"serve held-out: {wins.shape[0]} windows ({n_chunks} chunks) in {serve_s:.3f} s, "
          f"{engine.steps} steps; served alarms == evaluate_timeline "
          f"{res.alarms.tolist()}; window accuracy {acc:.4f}, lead time "
          f"{float(res.lead_time_minutes):.0f} min; committed JAX-trained program: "
          f"accuracy {ref_acc:.4f}, lead time {float(ref.lead_time_minutes):.0f} min, "
          f"alarms {ref.alarms.tolist()}")
    if acc < ref_acc - 0.05:
        fail(f"port-trained accuracy {acc:.4f} trails the committed program's "
             f"{ref_acc:.4f} by more than 0.05")
    # K1 on a forest other than the committed one: the same evaluation
    # through the plain versions.
    with plain_versions():
        res_plain = pipeline.evaluate_timeline(fitted, timeline, cfg)
    if not (torch.equal(res.chunk_preds, res_plain.chunk_preds)
            and torch.equal(res.alarms, res_plain.alarms)):
        fail("the port-trained forest's chunk votes or alarms differ between the kernel path "
             "and the plain path")
    bad = (res.window_preds != res_plain.window_preds).nonzero()[:, 0]
    if bad.numel():
        with plain_versions():
            x, _, _ = features.normalize(pipeline.process_windows(timeline.windows, cfg),
                                         fitted.feat_mean, fitted.feat_std)
        margins = path_walk(x[bad.to(x.device)], program.packed)[0]
        if not bool((margins < 1e-3).all()):
            fail(f"port-trained forest: window votes differ at routing margins {margins.tolist()}")
    print(f"serve held-out, plain path: window accuracy "
          f"{float((res_plain.window_preds == labels).float().mean()):.4f}; chunk votes and "
          f"alarms equal, {bad.numel()} window votes differ (all at routing margin < 1e-3)")

    # Retrain on fresh shards, swap into the running engine mid-stream.
    fitted2, stages2, _ = timed_fit(gen, training_set(gen), cfg)
    k_swap = n_chunks // 2
    scored2 = serve_timeline(engine, TRAIN_PATIENT + 1000, wins, 0, k_swap * per)
    version = engine.swap_program(api.ScoringProgram.from_fitted(fitted2, cfg))
    scored2 += serve_timeline(engine, TRAIN_PATIENT + 1000, wins, k_swap * per, n_chunks * per)
    versions = [e.program_version for e in scored2]
    if versions != [0] * k_swap + [version] * (n_chunks - k_swap):
        fail(f"program_version stamps wrong: {versions}")
    res2 = pipeline.evaluate_timeline(fitted2, timeline, cfg)
    combined = torch.cat([res.chunk_preds[:k_swap], res2.chunk_preds[k_swap:n_chunks]])
    want = pipeline.alarm_state(combined, cfg).tolist()
    if [e.alarm for e in scored2] != want:
        fail(f"post-swap alarms {[e.alarm for e in scored2]} != composite oracle {want}")
    changed = int((res.chunk_preds != res2.chunk_preds).sum())
    print(f"retrain + swap: refit in {stages2['fit']:.3f} s; v{version} live after chunk "
          f"{k_swap}/{n_chunks}; version stamps and composite alarms exact ({changed} chunk "
          "votes differ between the programs)")
    return rows, counts, {"rec": rec, "state": fit_state, "fitted": fitted,
                          "fit_s": stages["fit"]}


# ---------------------------------------------------------------------------
# Phase 6c: distributed training, one process per map shard
# ---------------------------------------------------------------------------

DIST_STAGES = ("features", "moments gather", "rotation prep", "grower", "union gather")
SHUFFLE_ROWS = 4096   # rows per shard of the shuffle check (16 floats each)
SHUFFLE_SKEW = 0.7    # share of every shard's rows keyed to shard 0


def fit_leaves(fitted) -> dict:
    """Every leaf of a fitted pipeline or a DistributedFitResult, by name."""
    return {"rotation": fitted.forest.rotation, **fitted.forest.trees._asdict(),
            "feat_mean": fitted.feat_mean, "feat_std": fitted.feat_std}


def rank_inputs(device, windows, labels, state):
    """Phase 6's training set on this rank's device, and a generator on it
    in the state phase 6's generator had just before its fit. The kernel
    library is loaded and cuSOLVER initialized first, as the parent's are
    before its timed runs."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.signal import eeg_data

    build.load()
    torch.linalg.eigh(torch.eye(8, device=device))

    rec = eeg_data.Recording(torch.from_numpy(windows).to(device),
                             torch.from_numpy(labels).to(device))
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(state))
    return rec, gen


def timed_mesh_fit(fit) -> tuple:
    """``fit()``, one rank's mesh fit, with the kernel counts set to 0 just
    before and read just after: (result, {"wall": s, "stages": {stage: s},
    "gathers": [(stage, ms)], "counts": launches}). Every stage clock and
    gather timer synchronizes the card."""
    import torch

    from repro_torch.core import decision_tree as dt
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import rotation_forest as rf
    from repro_torch.signal import pipeline

    stages = dict.fromkeys(DIST_STAGES, 0.0)
    gathers = []
    gather = mr.all_gather_tree

    def timed_gather(tree, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(tree, group)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        label = "union gather" if isinstance(tree, rf.RotationForestParams) else "moments gather"
        stages[label] += sec
        gathers.append((label, sec * 1e3))
        return out

    with contextlib.ExitStack() as stack:
        for owner, name, label in ((pipeline, "process_windows", "features"),
                                   (rf, "_prepare_trees", "rotation prep"),
                                   (dt, "fit_forest_binned", "grower")):
            stack.enter_context(stage_clock(stages, owner, name, label))
        mr.all_gather_tree = timed_gather
        stack.callback(setattr, mr, "all_gather_tree", gather)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    return out, {"wall": wall, "stages": stages, "gathers": gathers, "counts": counts}


def nccl_rank(rank, device, windows, labels, state) -> dict:
    """Phase 6c a, a world of one nccl rank: fit_mapreduce(mesh=) on phase
    6's training set in a fresh process, n_shards=1 from the same
    generator state, and the mesh fit again (warm)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import forest_trainer as ft
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.signal import pipeline

    cfg = pipeline.PipelineConfig()
    mesh = mesh_lib.make_host_mesh(data=1, device_type=device.type)

    def fit(rec, gen, **mode):
        return ft.fit_mapreduce(gen, rec.windows, rec.labels, cfg.forest,
                                feature_fn=lambda w: pipeline.process_windows(w, cfg), **mode)

    def mesh_fit():
        rec, gen = rank_inputs(device, windows, labels, state)
        return timed_mesh_fit(lambda: fit(rec, gen, mesh=mesh))

    cold = mesh_fit()
    rec, gen = rank_inputs(device, windows, labels, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fit_leaves(fit(rec, gen, n_shards=1))
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    warm = mesh_fit()
    differ = sorted({k for got, _ in (cold, warm) for k, v in fit_leaves(got).items()
                     if not torch.equal(v, want[k])})
    return dict(infos=[cold[1], warm[1]], device=str(device), backend=dist.get_backend(),
                differ=differ, trees=int(warm[0].forest.rotation.shape[0]), local_s=local_s)


def shuffle_inputs():
    """Two shards' (SHUFFLE_ROWS, 16) values and skewed keys on the host,
    from a generator of their own: each shard keys ~SHUFFLE_SKEW of its
    rows to shard 0 (even keys), past a bucket's room, and the rest to
    shard 1 (odd keys)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 60)
    values = torch.randn((2, SHUFFLE_ROWS, 16), generator=g)
    k = torch.randint(0, 1 << 20, (2, SHUFFLE_ROWS), generator=g)
    to_one = torch.rand((2, SHUFFLE_ROWS), generator=g) >= SHUFFLE_SKEW
    return values, (2 * k + to_one).to(torch.int32)


def routed_on_host(values, keys, dest: int) -> np.ndarray:
    """What shard ``dest`` must receive, row by row on the host: from each
    source shard in order, its first bucket of rows keyed to dest (local
    order), zero rows after them."""
    v, k = values.numpy(), keys.numpy().astype(np.int64)
    n_shards, rows = k.shape
    bucket = rows // n_shards
    out = np.zeros((n_shards * bucket, v.shape[-1]), np.float32)
    for s in range(n_shards):
        mine = [i for i in range(rows) if k[s, i] % n_shards == dest][:bucket]
        out[s * bucket : s * bucket + len(mine)] = v[s, mine]
    return out


def gloo_rank(rank, device, windows, labels, state) -> dict:
    """Phase 6c b and c, one of two gloo ranks sharing the card:
    pipeline.fit(mesh=) from phase 6's generator state, twice (the first
    in a fresh process, the second warm), this rank's shard features,
    process_recording_mapreduce on 4 chunks against process_windows of
    each shard, and shuffle_by_key on CUDA tensors."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import mapreduce as mr
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.signal import eeg_data, pipeline

    cfg = pipeline.PipelineConfig()
    mesh = mesh_lib.make_host_mesh(data=2, device_type=device.type)
    fits = []
    for _ in range(2):
        rec, gen = rank_inputs(device, windows, labels, state)
        fits.append(timed_mesh_fit(lambda: pipeline.fit(gen, rec, cfg, mesh=mesh)))
    n = rec.windows.shape[0] // 2
    shard_features = pipeline.process_windows(rec.windows[rank * n : (rank + 1) * n], cfg)

    per = eeg_data.WINDOWS_PER_MATRIX
    sub = eeg_data.Recording(rec.windows[: 4 * per], rec.labels[: 4 * per])
    feats = pipeline.process_recording_mapreduce(mesh, sub, cfg._replace(overlap=0))
    want = torch.cat([pipeline.process_windows(w, cfg) for w in sub.windows.chunk(2)])

    values, keys = shuffle_inputs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = mr.shuffle_by_key(values[rank].to(device), keys[rank].to(device), mesh, 2)
    torch.cuda.synchronize()
    shuffle_ms = (time.perf_counter() - t0) * 1e3
    routed = routed_on_host(values, keys, rank)
    to_me = int(sum(int((keys[s].long() % 2 == rank).sum()) for s in range(2)))
    return dict(
        infos=[info for _, info in fits], device=str(device), backend=dist.get_backend(),
        fitted=[fitted for fitted, _ in fits], shard_features=shard_features, features_equal=bool(torch.equal(feats, want)),
        features_shape=tuple(feats.shape), shuffle_equal=bool(np.array_equal(got.cpu().numpy(), routed)),
        shuffle_ms=shuffle_ms, shuffle_keyed=to_me, shuffle_rows=int(got.shape[0]),
        shuffle_on=str(got.device),
    )


def first_differing_stage(rank: int, res: dict, fitted, phase6: dict, cfg) -> str:
    """The first stage whose output differs between rank ``rank``'s fit
    ``fitted`` and its emulated shard in phase 6's fit."""
    import torch

    from repro_torch.signal import pipeline

    rec = phase6["rec"]
    n = rec.windows.shape[0] // 2
    emulated = pipeline.process_windows(rec.windows[rank * n : (rank + 1) * n], cfg).cpu()
    got, want = fit_leaves(fitted), fit_leaves(phase6["fitted"])
    if not torch.equal(res["shard_features"], emulated):
        return "features (process_windows of the shard)"
    if not (torch.equal(got["feat_mean"], want["feat_mean"].cpu())
            and torch.equal(got["feat_std"], want["feat_std"].cpu())):
        return "global moments"
    if not torch.equal(got["rotation"], want["rotation"].cpu()):
        return "rotation prep"
    return "grower"


def distributed_phase(phase6: dict, smi: str) -> dict[str, int]:
    """Phase 6c. Returns the kernels' launches in the ranks' mesh fits."""
    import os
    import tempfile

    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.signal import eeg_data, pipeline

    cfg = pipeline.PipelineConfig()
    rec = phase6["rec"]
    args = (rec.windows.cpu().numpy(), rec.labels.cpu().numpy(), phase6["state"].numpy())
    launches: dict[str, int] = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def stages(info) -> str:
        return (f"{info['wall']:.3f} s (" + ", ".join(
            f"{k} {v:.3f} s" for k, v in info["stages"].items()) + "; gathers " + ", ".join(
            f"{k} {ms:.2f} ms" for k, ms in info["gathers"]) + ")")

    # a. One nccl rank: the mesh fit equals n_shards=1 in every leaf.
    t0 = time.perf_counter()
    (one,) = mesh_lib.spawn_world(nccl_rank, 1, backend="nccl", device="cuda", args=args,
                                  timeout_s=600.0).check()
    print(f"distributed a: a world of 1 {one['backend']} rank on {one['device']}: "
          f"fit_mapreduce(mesh=) of {one['trees']} trees, first fit of the process "
          f"{stages(one['infos'][0])}; n_shards=1 next {one['local_s']:.3f} s; the mesh fit "
          f"again {stages(one['infos'][1])}; both mesh fits "
          f"{'equal to' if not one['differ'] else 'DIFFERENT from'} n_shards=1 in every leaf, "
          f"bit for bit; launches a fit {one['infos'][1]['counts']}; world "
          f"{time.perf_counter() - t0:.1f} s; card {smi}")
    if one["differ"]:
        fail(f"nccl mesh of 1: leaves {one['differ']} differ from n_shards=1")
    for info in one["infos"]:
        add(info["counts"])

    # b, c. Two gloo ranks on one card: pipeline.fit(mesh=) equals phase 6's
    # n_shards=2 fit bit for bit, in a fresh process and warm.
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn_world(gloo_rank, 2, backend="gloo", device="cuda", args=args,
                                 timeout_s=600.0).check()
    world_s = time.perf_counter() - t0
    want = {k: v.cpu() for k, v in fit_leaves(phase6["fitted"]).items()}
    n_chunks = rec.windows.shape[0] // eeg_data.WINDOWS_PER_MATRIX // 2
    for rank, res in enumerate(ranks):
        for i, (fitted, info) in enumerate(zip(res["fitted"], res["infos"])):
            got = fit_leaves(fitted)
            differ = [k for k in want if not torch.equal(got[k], want[k])]
            c = info["counts"]
            print(f"distributed b: rank {rank} ({res['backend']}, {res['device']}), "
                  f"{('first fit of the process', 'second fit')[i]}: {stages(info)}; "
                  f"launches {c}; card {smi}")
            if differ:
                fail(f"rank {rank}, fit {i + 1}: leaves {differ} differ from phase 6's "
                     f"n_shards=2 fit; first differing stage: "
                     f"{first_differing_stage(rank, res, fitted, phase6, cfg)}")
            if (c["wpd_level"] != 2 * n_chunks or c["histogram"] != cfg.forest.depth
                    or not c["gram"]):
                fail(f"rank {rank} launched {c}: expected K2 {2 * n_chunks} (2 a chunk of "
                     f"its shard), K4 {cfg.forest.depth} (1 a level), K3 at least once")
            add(c)
    walls = [max(res["infos"][i]["wall"] for res in ranks) for i in range(2)]
    print(f"distributed b: pipeline.fit(mesh=) over 2 gloo ranks sharing {smi}: "
          f"{walls[0]:.3f} s first, {walls[1]:.3f} s second (the slower rank's) against "
          f"phase 6's emulated n_shards=2 fit {phase6['fit_s']:.3f} s; every leaf (forest, "
          f"feat_mean, feat_std) of both fits equal to phase 6's bit for bit on both ranks; "
          f"world {world_s:.1f} s")
    for rank, res in enumerate(ranks):
        print(f"distributed c: rank {rank}: process_recording_mapreduce at overlap 0 on 4 "
              f"chunks {res['features_shape']} {'==' if res['features_equal'] else '!='} "
              f"process_windows of each shard; shuffle_by_key on {res['shuffle_on']} "
              f"({res['shuffle_keyed']} rows keyed here, {res['shuffle_rows']} received "
              f"slots) {'==' if res['shuffle_equal'] else '!='} the host routing, "
              f"{res['shuffle_ms']:.2f} ms")
        if not (res["features_equal"] and res["shuffle_equal"]):
            fail(f"rank {rank}: process_recording_mapreduce or shuffle_by_key disagrees")

    # d. The launcher's mesh job: train, serve through K1, retrain, swap.
    with tempfile.TemporaryDirectory(prefix="seizure_ckpt_") as save_dir:
        cmd = [sys.executable, "-m", "repro_torch.launch.train_forest", "--devices", "2",
               "--backend", "gloo", "--trees", "10", "--depth", "6", "--bins", "32",
               "--save-dir", save_dir]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith(("[train]", "[check]", "[retrain]", "[swap]")):
            print(f"distributed d: launcher: {line}")
    print(f"distributed d: {' '.join(cmd[1:-2])} exited {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"the launcher's --devices 2 run exited {proc.returncode}")
    return launches


# ---------------------------------------------------------------------------
# Phase 6d: the seizure engine across processes
# ---------------------------------------------------------------------------

# (overlap, slots, label): the last serves the 8 sessions on 4 slots, so
# slots are evicted and refilled (a slot's state is broadcast by its owner).
MESH_RUNS = ((0, MAX_BATCH, "first drive of the process"), (2, MAX_BATCH, "warm"),
             (0, MAX_BATCH, "warm"), (2, SNAP_BATCH, "warm, 8 sessions on 4 slots"))
MESH_SNAPSHOTS = ROOT / "build" / "mesh_engine_snapshots"
# (name, the single-process run it is held to): the drives at overlap 0
# that take the budget's and the snapshot's collectives.
MESH_EXTRAS = (("budget", "budget 0"), ("snapshot, live", "4 slots"),
               ("mesh snapshot restored without a mesh", "4 slots"),
               ("single-process snapshot restored on the mesh", "4 slots"))


def budget_traffic(traffic) -> dict:
    """The traffic less its last 2 sessions: on MAX_BATCH slots no batch is
    full, so ``poll(drain=False)`` steps only when the budget says so."""
    return dict(list(traffic.items())[:N_SESSIONS - 2])


def ticking(step: float):
    """A clock that moves ``step`` seconds at every read."""
    now = [0.0]

    def clock():
        now[0] += step
        return now[0]

    return clock


def mesh_engine_extras(program, traffic, mesh, device, rank, n_ranks) -> list[dict]:
    """Phase 6d's overlap-0 drives through the budget's and the snapshot's
    collectives, as MESH_EXTRAS names them: each one's events (head and
    tail), steps and launches. The budget drive serves ``budget_traffic``;
    the budget is 50 s and only the last rank's clock moves (100 s a
    read), so each partial batch is flushed because the max over the mesh
    says so."""
    import torch.distributed as dist

    from repro_torch.serving import api

    reset_counts()
    events, stats = drive(program, budget_traffic(traffic), mesh=mesh, device=device,
                          latency_budget_s=50.0,
                          clock=ticking(100.0 if rank == n_ranks - 1 else 0.0))
    out = [dict(name="budget", events=events, steps=stats["steps"], counts=launch_counts())]
    mesh_dir, plain_dir = MESH_SNAPSHOTS / f"{n_ranks}/mesh", MESH_SNAPSHOTS / f"{n_ranks}/plain"
    reset_counts()
    engine, head, _ = snap_start(program, traffic, megabatch=True, snapshot_dir=mesh_dir,
                                 mesh=mesh, device=device)
    tail = snap_resume(engine, traffic)[0]
    out.append(dict(name="snapshot, live", events=head + tail, steps=engine.steps,
                    counts=launch_counts()))
    if rank == 0:
        snap_start(program, traffic, megabatch=True, snapshot_dir=plain_dir, device=device)
    dist.barrier()  # rank 0's single-process snapshot is written
    for name, directory, on_mesh in (
            ("mesh snapshot restored without a mesh", mesh_dir, None),
            ("single-process snapshot restored on the mesh", plain_dir, mesh)):
        restored = api.SeizureEngine.restore(str(directory), mesh=on_mesh, device=device)
        steps0 = restored.steps
        reset_counts()
        tail = snap_resume(restored, traffic)[0]
        out.append(dict(name=name, events=head + tail, steps=restored.steps - steps0,
                        counts=launch_counts()))
    return out


def mesh_engine_rank(rank, device, traffic, n_ranks) -> dict:
    """Phase 6d, one rank: SeizureEngine(mesh=) over this world's data
    axis, on phase 3's traffic as MESH_RUNS lists it: each drive's events,
    stats, launches and each step's gather ms (synchronized)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving import api

    build.load()
    torch.linalg.eigh(torch.eye(8, device=device))
    mesh = mesh_lib.make_host_mesh(data=n_ranks, device_type=device.type)
    program = api.ScoringProgram.load(
        str(ROOT / "src/repro_torch/assets/seizure_program"), device=device)
    gather, gathers = api._gather_slot_rows, []

    def timed_gather(outs, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gather(outs, group)
        torch.cuda.synchronize()
        gathers.append((time.perf_counter() - t0) * 1e3)
        return got

    api._gather_slot_rows = timed_gather
    runs = []
    for overlap, slots, label in MESH_RUNS:
        prog = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                  program.cfg._replace(overlap=overlap))
        gathers.clear()
        reset_counts()
        events, stats = drive(prog, traffic, max_batch=slots, mesh=mesh, device=device)
        runs.append(dict(overlap=overlap, slots=slots, label=label, events=events,
                         stats=stats, counts=launch_counts(), gathers=list(gathers)))
    api._gather_slot_rows = gather
    extras = mesh_engine_extras(program, traffic, mesh, device, dist.get_rank(), n_ranks)
    return dict(runs=runs, extras=extras, device=str(device), backend=dist.get_backend())


def mesh_engine_phase(program, traffic, default_runs, smi) -> dict[str, int]:
    """Phase 6d. Returns the kernels' launches in every rank's drives."""
    import shutil

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving import api

    launches: dict[str, int] = {}
    per_step = {"forest": 1, "wpd_level": 2, "gram": 6}
    single = {(ov, MAX_BATCH): run for ov, run in default_runs.items()}
    for ov, slots, _ in MESH_RUNS:
        if (ov, slots) not in single:
            single[ov, slots] = drive(api.ScoringProgram(
                program.packed, program.feat_mean, program.feat_std,
                program.cfg._replace(overlap=ov)), traffic, max_batch=slots)
    prog0 = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                               program.cfg._replace(overlap=0))
    extra_ref = {"budget 0": drive(prog0, budget_traffic(traffic), latency_budget_s=0.0),
                 "4 slots": drive(prog0, traffic, max_batch=SNAP_BATCH)}
    unbudgeted = drive(prog0, budget_traffic(traffic))[1]["steps"]
    if unbudgeted >= extra_ref["budget 0"][1]["steps"]:
        fail(f"the budget drive's traffic fills every batch ({unbudgeted} steps without a "
             "budget): it would not exercise the budget's flush")
    shutil.rmtree(MESH_SNAPSHOTS, ignore_errors=True)
    for backend, n in (("nccl", 1), ("gloo", 2)):
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn_world(mesh_engine_rank, n, backend=backend, device="cuda",
                                     args=(traffic, n), timeout_s=600.0).check()
        world_s = time.perf_counter() - t0
        for rank, res in enumerate(ranks):
            for run in res["runs"]:
                ov, stats, c, g = run["overlap"], run["stats"], run["counts"], run["gathers"]
                want_events, want_stats = single[ov, run["slots"]]
                prog = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                          program.cfg._replace(overlap=ov))
                if stats["chunks"] != N_SESSIONS * CHUNKS_PER_SESSION:
                    fail(f"mesh engine {backend} rank {rank}: scored {stats['chunks']} chunks")
                differing = compare_events(run["events"], want_events, prog, traffic)
                if {k: c[k] for k in per_step} != {k: v * stats["steps"] for k, v in per_step.items()}:
                    fail(f"mesh engine {backend} rank {rank}: launches {c} over "
                         f"{stats['steps']} steps, expected {per_step} a step")
                for k in per_step:
                    launches[k] = launches.get(k, 0) + c[k]
                print(f"mesh engine {backend}: rank {rank} of {n} ({res['device']}, "
                      f"{run['slots'] // n} of {run['slots']} slots), overlap {ov}, "
                      f"{run['label']}: {stats['windows_per_s']:.1f} windows/s "
                      f"({stats['seconds']:.3f} s, {stats['steps']} steps) against the single "
                      f"process's {want_stats['windows_per_s']:.1f}; events equal the single-process "
                      f"engine's, {differing} window predictions differ (all at routing margin "
                      f"< 1e-3); gathers (ms, one a step) "
                      f"{', '.join(f'{ms:.2f}' for ms in g)}; launches {c}; card {smi}")
            for run, (name, ref) in zip(res["extras"], MESH_EXTRAS, strict=True):
                c, steps = run["counts"], run["steps"]
                want_events, want_stats = extra_ref[ref]
                differing = compare_events(run["events"], want_events, prog0, traffic)
                if {k: c[k] for k in per_step} != {k: v * steps for k, v in per_step.items()}:
                    fail(f"mesh engine {backend} rank {rank}, {name}: launches {c} over "
                         f"{steps} steps, expected {per_step} a step")
                for k in per_step:
                    launches[k] = launches.get(k, 0) + c[k]
                print(f"mesh engine {backend}: rank {rank} of {n}, overlap 0, {name}: events "
                      f"equal the single-process engine's ({ref}, {want_stats['steps']} steps; "
                      f"{unbudgeted} steps without a budget), "
                      f"{differing} window predictions differ (all at routing margin < 1e-3); "
                      f"{steps} steps; launches {c}")
        print(f"mesh engine {backend}: {n} rank(s) on one card ({smi}): contention, not "
              f"scaling; world {world_s:.1f} s")
    shutil.rmtree(MESH_SNAPSHOTS, ignore_errors=True)
    return launches


def print_syncs(label: str, count) -> None:
    """A ``SyncCount``'s total, then each call site on a line of its own."""
    print(f"syncs {label}: {count.total} at {len(count.by_site)} call sites "
          "(torch.cuda.set_sync_debug_mode('warn'), host copies exempt)")
    for site, n in count.by_site.most_common():
        print(f"syncs {label}: {n} at {site}")


def engine_step_syncs(program, traffic) -> None:
    """The host syncs of one warm engine step (8 slots x 4 chunks: both
    steps take each session's first 4 chunks), by call site."""
    from repro_torch.analysis import sanitizers
    from repro_torch.serving import api

    engine = api.SeizureEngine(program, max_batch=MAX_BATCH, replay_depth=REPLAY_DEPTH,
                               device="cuda")
    sessions = {pid: engine.open_session(pid) for pid in list(traffic)[:MAX_BATCH]}
    per = REPLAY_DEPTH * 60
    for rnd in range(2):  # the first step warms the engine up
        for pid, s in sessions.items():
            s.push(traffic[pid][:per])
        with sanitizers.guard_methods(engine, "poll") as count:
            engine.poll()
    if engine.steps != 2:
        fail(f"the sync count's engine ran {engine.steps} steps, expected 2")
    print_syncs("one warm engine step", count)


def fit_syncs(phase6) -> None:
    """The host syncs of one default fit on phase 6's set, by call site."""
    import torch

    from repro_torch.analysis import sanitizers
    from repro_torch.signal import pipeline

    gen = torch.Generator(device="cuda")
    gen.set_state(phase6["state"])
    with sanitizers.guard_methods(pipeline, "fit") as count:
        pipeline.fit(gen, phase6["rec"], pipeline.PipelineConfig(), n_shards=TRAIN_SHARDS)
    print_syncs("one fit", count)


# ---------------------------------------------------------------------------
# Phase 7: LM serving (dense qwen3-0.6b, K5)
# ---------------------------------------------------------------------------

def flash_share(got, want) -> float:
    """The largest share of its FLASH_TOL tolerance that any element of
    K5's output ``got`` uses against the plain version's ``want`` (over 1:
    they disagree)."""
    rel, row = FLASH_TOL[str(want.dtype).split(".")[-1]]
    got, want = got.float(), want.float()
    tol = rel * want.abs() + row * want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / tol).max())


def flash_row(gen, b: int, s: int, h: int, kv: int, hd: int, dtype, causal: bool) -> dict:
    """K5 against its plain version on random q (b, s, h, hd) and k, v (b,
    s, kv, hd) in the model's layout, element by element within FLASH_TOL;
    the plain version is ``ops.reference`` (the KV groups expanded and (B,
    H) flattened, as ops.py does for a CPU tensor). Timed beside
    F.scaled_dot_product_attention on the expanded (1, B*H, S, hd) tensors
    (a yardstick the port never calls) and its bound: q, k, v read and the
    output written once; causal work counts the S(S+1)/2 pairs a causal
    mask keeps, 4 hd flops each, at the type's peak rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao

    def randn(heads):
        return torch.randn((b, s, heads, hd), generator=gen, device=gen.device).to(dtype)

    q, k, v = randn(h), randn(kv), randn(kv)
    got, want = ak.flash_attention(q, k, v, causal=causal), ao.reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    bh = b * h
    qf, kf, vf = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
                  .reshape(1, bh, s, hd).contiguous() for t in (q, k, v))
    err = float((got.float() - want.float()).abs().max())
    share = flash_share(got, want)
    rel, row = FLASH_TOL[str(dtype).split(".")[-1]]
    name = (f"flash_attention/{b}x{s}x{h}:{kv}x{hd} {str(dtype).split('.')[-1]} "
            f"{'causal' if causal else 'full'}")
    if not share <= 1.0:
        fail(f"{name} kernel disagrees with its plain version: an element uses {share} "
             f"of its tolerance {rel:.3g} |plain| + {row:.3g} max|plain row|")
    pairs = s * (s + 1) / 2 if causal else float(s * s)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    b_ms, b_by = bound_ms((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                          4.0 * hd * bh * pairs, rate)
    reps = dict(launches=5, reps=5) if dtype == torch.float32 else {}
    return dict(
        shape=f"q {tuple(q.shape)}, k, v {tuple(k.shape)}", max_abs_err=err, tol=None,
        note=f"tol per element {rel:.3g} |plain| + {row:.3g} max|plain row|, the worst "
             f"element uses {share:.4f} of it",
        ms=time_ms(lambda: ak.flash_attention(q, k, v, causal=causal), **reps),
        plain_ms=time_ms(lambda: ao.reference(q, k, v, causal=causal), **reps),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, is_causal=causal), **reps),
        bound_ms=b_ms, bound_by=b_by, name=name,
    )


def check_flash(gen) -> dict[str, dict]:
    import torch

    rows = {}
    # (B, S, H, KV, hd): qwen3-0.6b's 16 q heads over 8 KV heads of 128.
    for args in ((8, 2048, 16, 8, 128, torch.bfloat16, True),   # the static prefill's launch
                 (8, 2048, 16, 8, 128, torch.float32, True),
                 (1, 1024, 16, 8, 128, torch.bfloat16, True),    # a batch-1 admission prefill
                 (1, 1000, 16, 8, 128, torch.bfloat16, True),    # ragged S, masked in the kernel
                 (4, 1024, 16, 8, 128, torch.bfloat16, False),
                 (4, 1024, 16, 8, 64, torch.bfloat16, True)):
        r = flash_row(gen, *args)
        rows[r.pop("name")] = r
    print_kernel_rows(rows)
    return rows


@contextlib.contextmanager
def lm_recorder(model):
    """Record, for every prefill and decode step the engines run, the
    synchronized host time, the last-position logits and each row's
    argmax and top-2 margin (the model's methods are wrapped on the
    instance for the duration)."""
    import torch

    calls = {"prefill": [], "decode": []}

    def wrap(kind, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            last = logits[:, -1].float()
            top = last.topk(2, dim=-1).values
            calls[kind].append(dict(seconds=seconds, logits=last,
                                    tokens=last.argmax(-1).tolist(),
                                    margins=(top[:, 0] - top[:, 1]).tolist()))
            return logits, cache
        return run

    model.prefill = wrap("prefill", model.prefill)
    model.decode_step = wrap("decode", model.decode_step)
    try:
        yield calls
    finally:
        del model.prefill, model.decode_step


def lm_static(model, prompts, slots=LM_SLOTS, max_seq=LM_MAX_SEQ, max_new=LM_MAX_NEW):
    """ServeEngine over one static batch: the generated tokens, the
    recorded calls and the wall time of generate()."""
    import torch

    from repro_torch.serving.engine import ServeEngine

    engine = ServeEngine(model, max_batch=slots, max_seq=max_seq, eos_id=-1, device="cuda")
    with lm_recorder(model) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return [o.tolist() for o in outs], calls, seconds


def continuous_schedule(max_new, slots):
    """With EOS never firing, the continuous engine's schedule depends on
    max_new alone: (per decode step, the request in each slot; the
    admissions as (decode step or -1 before the first, slot, request))."""
    queue = list(range(len(max_new)))
    occupant, count, admissions, steps = [None] * slots, {}, [], []
    for i in range(slots):
        if queue:
            r = queue.pop(0)
            occupant[i], count[r] = r, 1
            admissions.append((-1, i, r))
    while any(o is not None for o in occupant):
        steps.append(list(occupant))
        for i, r in enumerate(steps[-1]):
            if r is None:
                continue
            if count[r] >= max_new[r]:
                occupant[i] = None
                if queue:
                    r2 = queue.pop(0)
                    occupant[i], count[r2] = r2, 1
                    admissions.append((len(steps) - 1, i, r2))
            else:
                count[r] += 1
    return steps, admissions


def static_steps(calls, n, max_new=LM_MAX_NEW):
    """Each static request's steps as (token, top-2 margin, logits row):
    token t of request i is row i of call t (the prefill, then the decode
    steps; the last decode step's tokens are not kept)."""
    seq = calls["prefill"] + calls["decode"]
    return [[(c["tokens"][i], c["margins"][i], c["logits"][i]) for c in seq[:max_new]]
            for i in range(n)]


def continuous_steps(calls, steps, admissions, n, max_new=LM_CONT_MAX_NEW):
    """Each continuous request's steps as (token, top-2 margin, logits
    row), read along the schedule: its admission prefill, then each decode
    step that extended it."""
    out = [[] for _ in range(n)]
    for (_, _, r), call in zip(admissions, calls["prefill"]):
        out[r].append((call["tokens"][0], call["margins"][0], call["logits"][0]))
    for occupants, call in zip(steps, calls["decode"]):
        for i, r in enumerate(occupants):
            if r is not None and len(out[r]) < max_new[r]:
                out[r].append((call["tokens"][i], call["margins"][i], call["logits"][i]))
    return out


def lm_continuous(model, prompts, slots=LM_CONT_SLOTS, max_seq=LM_CONT_MAX_SEQ,
                  max_new=LM_CONT_MAX_NEW):
    import torch

    from repro_torch.serving.continuous import ContinuousEngine, Request

    engine = ContinuousEngine(model, max_batch=slots, max_seq=max_seq, eos_id=-1,
                              device="cuda")
    requests = [Request(p, m) for p, m in zip(prompts, max_new)]
    with lm_recorder(model) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.serve(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return requests, calls, seconds


def compare_paths(label, kernel, plain, tol=LM_LOGIT_TOL, margin=LM_MARGIN
                  ) -> tuple[float, int, int, int]:
    """kernel, plain: per request, per step (token, top-2 margin, logits
    row). (1) At every step whose context is the same on both paths (the
    request's earlier tokens equal), the logits agree within ``tol``.
    (2) Tokens are equal up to each request's first step whose plain-path
    margin is below ``margin``. Returns (max logit difference, steps whose
    logits were compared, steps whose tokens were compared, steps)."""
    diff, n_logits, n_tokens, total = 0.0, 0, 0, 0
    for r, (ks, ps) in enumerate(zip(kernel, plain)):
        total += len(ps)
        for t, ((kt, _, kl), (pt, _, pl)) in enumerate(zip(ks, ps)):
            d = float((kl - pl).abs().max())
            diff, n_logits = max(diff, d), n_logits + 1
            if not d <= tol:
                fail(f"{label}: request {r} step {t}: logits of the kernel and plain paths "
                     f"differ by {d} > {tol} on the same context")
            if kt != pt:
                break  # the contexts differ from the next step on
        stop = next((t for t, step in enumerate(ps) if step[1] < margin), len(ps))
        got, want = [step[0] for step in ks[:stop]], [step[0] for step in ps[:stop]]
        if got != want:
            fail(f"{label}: request {r} tokens differ before its first step with plain "
                 f"margin < {margin} (step {stop}): {got} vs {want}")
        n_tokens += stop
    return diff, n_logits, n_tokens, total


def trace_call(label: str, what: str, fn, name: str, ours: str | None = None,
               copies: list | None = None) -> None:
    """Device busy and idle share, and device time by kernel, of one
    ``fn()`` (``device_activity``, the trace in ``chiprun_out/<name>``);
    with ``ours`` (a substring of a kernel's name), that kernel's share of
    the device time too, beside the time of the copies (memcpy activities
    and copy kernels). ``copies`` goes to ``device_activity``."""
    wall_ms, busy_ms, by_name = device_activity(fn, name, copies)
    if busy_ms is None:
        print(f"{label} trace {what}: {wall_ms:.3f} ms wall; the profiler recorded no "
              "device activity: busy and idle share not measured")
        return
    print(f"{label} trace {what}: {wall_ms:.3f} ms wall (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
          f"{sum(n for _, n in by_name.values())} device activities")
    for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"{label} trace kernel: {ms:.3f} ms in {n} launches: {kname[:110]}")
    if ours is not None:
        mine = [(ms, n) for kname, (ms, n) in by_name.items() if ours in kname]
        ms, n = sum(m for m, _ in mine), sum(c for _, c in mine)
        copy = [(ms, n) for kname, (ms, n) in by_name.items()
                if "copy" in kname.lower() or "memcpy" in kname.lower()]
        c_ms, c_n = sum(m for m, _ in copy), sum(c for _, c in copy)
        print(f"{label} trace {what}: {ours} {ms:.3f} ms in {n} launches, "
              f"{ms / busy_ms:.4f} of the device's busy time; copies {c_ms:.3f} ms in "
              f"{c_n} activities, {c_ms / busy_ms:.4f}")


def lm_traces(model, tokens, max_seq=LM_MAX_SEQ, label="lm", ours=None,
              heads: tuple[int, int] | None = None) -> None:
    """``trace_call`` of one static prefill and of one decode step at the
    batch of ``tokens``. With ``heads`` = (H, N), the prefill's copies of
    tensors of B H S N elements that have an H or B H axis (B or C expanded
    per head, or v transposed per head) are counted: there must be none."""
    import torch

    _, cache = model.prefill({"tokens": tokens}, max_seq)
    step = {"tokens": torch.zeros((tokens.shape[0], 1), dtype=torch.int32, device="cuda")}
    for what, fn, name in (
        (f"one prefill {tuple(tokens.shape)}",
         lambda: model.prefill({"tokens": tokens}, max_seq), f"{label}_prefill_trace"),
        (f"one decode step ({tokens.shape[0]} slots, cache {max_seq})",
         lambda: model.decode_step(cache, step), f"{label}_decode_trace"),
    ):
        shapes = [] if heads is not None and "prefill" in name else None
        trace_call(label, what, fn, name, ours, shapes)
        if shapes is not None:
            b, s = tokens.shape
            h, n = heads
            per_head = [sh for sh in shapes if math.prod(sh) == b * s * h * n
                        and (h in sh or b * h in sh)]
            print(f"{label} trace {what}: {len(shapes)} aten::copy_ calls, {len(per_head)} of "
                  f"them of tensors of B H S N = {b * s * h * n} elements with a head axis "
                  f"{sorted(set(per_head))}")
            if per_head:
                fail(f"{label} prefill copies B, C or v per head: {sorted(set(per_head))}")


def lm_phase(gen) -> tuple[dict, int]:
    """Phase 7. Returns the K5 rows and K5's launches in the two engine
    runs through the kernels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build

    rows = check_flash(gen)
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    model.compute_params()
    torch.cuda.synchronize()
    print(f"lm model: {cfg.name}, {model.param_count() / 1e6:.1f} M parameters "
          f"(float32 master + bf16 compute copy), {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}; "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    static_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                      for n in LM_STATIC_LENS]
    cont_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in LM_CONT_LENS]

    # Static batch through the kernels (after one warm-up generate).
    lm_static(model, static_prompts[:2])
    reset_counts()
    toks, calls, seconds = lm_static(model, static_prompts)
    k5_static = launch_counts()["flash_attention"]
    pre_s = calls["prefill"][0]["seconds"]
    dec = [c["seconds"] for c in calls["decode"]]
    n_tok = sum(len(t) for t in toks)
    print(f"lm static: {LM_SLOTS} slots, prompts {LM_STATIC_LENS} (padded width "
          f"{max(LM_STATIC_LENS)}), max_seq {LM_MAX_SEQ}, {LM_MAX_NEW} new tokens each: "
          f"prefill {pre_s * 1e3:.3f} ms, decode {statistics.median(dec) * 1e3:.3f} ms per step "
          f"(median of {len(dec)}), {n_tok} tokens in {seconds:.3f} s = {n_tok / seconds:.1f} "
          f"generated tokens/s ({LM_SLOTS / statistics.median(dec):.1f} tokens/s in decode); "
          f"K5 launches {k5_static}; largest |logit| of the prefill "
          f"{float(calls['prefill'][0]['logits'].abs().max()):.3f}")
    if k5_static != cfg.n_layers:
        fail(f"K5 launched {k5_static} times in the static run, expected {cfg.n_layers}")
    for row in calls["prefill"][0]["logits"], *(c["logits"] for c in calls["decode"]):
        if not bool(torch.isfinite(row).all()):
            fail("non-finite logits in the static run")
    reset_counts()
    with plain_versions():
        p_toks, p_calls, p_seconds = lm_static(model, static_prompts)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain LM run")
    n = len(static_prompts)
    kernel, plain = static_steps(calls, n), static_steps(p_calls, n)
    if ([[st[0] for st in r] for r in kernel] != toks
            or [[st[0] for st in r] for r in plain] != p_toks):
        fail("static run: the recorded calls do not replay the generated tokens")
    diff, n_logits, n_tokens, total = compare_paths("lm static", kernel, plain)
    print(f"lm static plain path: prefill {p_calls['prefill'][0]['seconds'] * 1e3:.3f} ms, "
          f"{n_tok / p_seconds:.1f} generated tokens/s; logits on the same context differ by "
          f"at most {diff:.4e} (tol {LM_LOGIT_TOL}) over {n_logits} of {total} steps; tokens "
          f"equal on {n_tokens} of {total} steps (each request up to its first plain margin "
          f"< {LM_MARGIN})")
    del kernel, plain, calls, p_calls

    # Continuous batching: 12 requests over 4 slots.
    steps, admissions = continuous_schedule(LM_CONT_MAX_NEW, LM_CONT_SLOTS)
    reset_counts()
    reqs, calls, seconds = lm_continuous(model, cont_prompts)
    k5_cont = launch_counts()["flash_attention"]
    want_k5 = cfg.n_layers * sum(n % 512 == 0 for n in LM_CONT_LENS)
    mid = sum(step >= 0 for step, _, _ in admissions)
    if not all(r.done and len(r.out) == m for r, m in zip(reqs, LM_CONT_MAX_NEW)):
        fail(f"continuous run: not every request completed: {[len(r.out) for r in reqs]}")
    if k5_cont != want_k5 or len(calls["decode"]) != len(steps) or mid == 0:
        fail(f"continuous run: K5 {k5_cont} launches (expected {want_k5}), "
             f"{len(calls['decode'])} decode steps (schedule {len(steps)}), {mid} mid-stream "
             "admissions")
    kernel = continuous_steps(calls, steps, admissions, len(reqs))
    if [[st[0] for st in r] for r in kernel] != [r.out for r in reqs]:
        fail("continuous run: the recorded calls do not replay the requests' tokens")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"lm continuous: {len(reqs)} requests over {LM_CONT_SLOTS} slots, prompts "
          f"{LM_CONT_LENS}, max_new {LM_CONT_MAX_NEW}: all complete; {len(steps)} decode "
          f"steps, {mid} admissions mid-stream; {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} tokens/s; decode "
          f"{statistics.median(c['seconds'] for c in calls['decode']) * 1e3:.3f} ms per step "
          f"(median); K5 launches {k5_cont}")
    reset_counts()
    with plain_versions():
        p_reqs, p_calls, p_seconds = lm_continuous(model, cont_prompts)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain continuous run")
    plain = continuous_steps(p_calls, steps, admissions, len(p_reqs))
    if [[st[0] for st in r] for r in plain] != [r.out for r in p_reqs]:
        fail("plain continuous run: the recorded calls do not replay the requests' tokens")
    diff, n_logits, n_tokens, total = compare_paths("lm continuous", kernel, plain)
    print(f"lm continuous plain path: {n_tok / p_seconds:.1f} tokens/s; logits on the same "
          f"context differ by at most {diff:.4e} (tol {LM_LOGIT_TOL}) over {n_logits} of "
          f"{total} steps; tokens equal on {n_tokens} of {total} steps (each request up to "
          f"its first plain margin < {LM_MARGIN})")
    del kernel, plain, calls, p_calls
    lm_traces(model, torch.from_numpy(np.stack([
        np.pad(p, (max(LM_STATIC_LENS) - len(p), 0)) for p in static_prompts])).to("cuda"),
        ours="flash_fwd")
    del model  # phase 8 needs the card's memory
    torch.cuda.empty_cache()
    return rows, k5_static + k5_cont


# ---------------------------------------------------------------------------
# Phase 7b: LM training (qwen3-0.6b at full width and depth; one zamba2 group)
# ---------------------------------------------------------------------------

def train_cfgs():
    """(qwen3-0.6b as published, zamba2-7b cut to one group)."""
    import dataclasses

    from repro_torch.configs import get_config

    hy = get_config(HY_ARCH)
    return get_config(LM_ARCH), dataclasses.replace(hy, n_layers=hy.attn_every)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def grad_gaps(got, want) -> dict[str, tuple[float, float]]:
    """Per leaf (||got - want|| / ||want||, max|got - want| / max|want|)."""
    from repro_torch.models import params as pr

    out = {}
    for (path, a), (_, b) in zip(pr.flatten(got), pr.flatten(want)):
        d = (a.float() - b.float())
        out[".".join(path)] = (float(d.norm() / b.float().norm()),
                               float(d.abs().max() / b.float().abs().max()))
    return out


def check_gaps(label: str, gaps: dict, rel: float, max_rel: float | None) -> None:
    worst_f = max(gaps.items(), key=lambda kv: kv[1][0])
    worst_m = max(gaps.items(), key=lambda kv: kv[1][1])
    print(f"{label}: {len(gaps)} leaves; worst Frobenius gap {worst_f[1][0]:.4e} "
          f"({worst_f[0]}), worst max gap {worst_m[1][1]:.4e} ({worst_m[0]}); median "
          f"Frobenius {statistics.median(g[0] for g in gaps.values()):.4e} (tol {rel:.4g}"
          + ("" if max_rel is None else f", max {max_rel:.4g}") + ")")
    for key, (f, m) in gaps.items():
        if not f <= rel or (max_rel is not None and not m <= max_rel):
            fail(f"{label}: leaf {key} differs by {f} (Frobenius) / {m} (max) of its scale")


def serving_ce(model, batch, micro: int) -> float:
    """The batch's mean next-token cross-entropy through ``Model.forward``
    (the serving path, K5 at S % 512 == 0), one microbatch at a time:
    float32 log-softmax, as ``Model.loss``."""
    import torch

    from repro_torch.training.trainer import microbatch

    ces = []
    with torch.no_grad():
        for i in range(micro):
            mb = microbatch(batch, micro, i)
            logits, _ = model.forward(mb)
            logp = torch.log_softmax(logits, dim=-1)
            ces.append(-torch.gather(logp, -1, mb["targets"].long()[..., None]).mean())
            del logits, logp
    return float(sum(ces) / micro)


def bf16_and_f32_grads(model, cfg, params, batch):
    """(loss, grads) of ``batch`` in the model's bf16 compute and in a
    float32-compute model on the same masters."""
    import dataclasses

    from repro_torch.models import build
    from repro_torch.training.trainer import value_and_grad

    (l16, _), g16 = value_and_grad(model.loss, has_aux=True)(params, batch)
    f32 = build(dataclasses.replace(cfg, dtype="float32"))
    (l32, _), g32 = value_and_grad(f32.loss, has_aux=True)(params, batch)
    return (float(l16), g16), (float(l32), g32)


def trace_train_step(fn) -> None:
    """Device busy and idle share of one train step of one microbatch
    (after a warm-up step), and its largest kernels, summed by kind."""
    wall_ms, busy_ms, by_name = device_activity(fn, "lm_train_step_trace")
    if busy_ms is None:
        print(f"lm train trace one step ({TR_SMALL_BATCH} x {TR_SEQ}): {wall_ms:.3f} ms wall; "
              "the profiler recorded no device activity: busy and idle share not measured")
        return
    # cuBLAS's Hopper GEMMs are named nvjet_*.
    kinds = {"gemm": ("gemm", "nvjet", "xmma", "cutlass", "sm90"), "copy": ("copy", "memcpy"),
             "softmax": ("softmax",), "reduce": ("reduce",), "elementwise": ("elementwise",)}
    sums = {k: 0.0 for k in kinds}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in kinds.items() if any(s in low for s in keys)), None)
        if kind is not None:
            sums[kind] += ms
    print(f"lm train trace one step ({TR_SMALL_BATCH} x {TR_SEQ}, one microbatch, AdamW "
          f"included): {wall_ms:.3f} ms wall (profiler on), device busy {busy_ms:.3f} ms, idle "
          f"share {1 - busy_ms / wall_ms:.4f}, {sum(n for _, n in by_name.values())} device "
          f"activities; by kind (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in sums.items()))
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"lm train trace kernel: {ms:.3f} ms in {n} launches: {name[:110]}")


def lm_training_phase(smi: str) -> int:
    """Phase 7b. Returns K5's launches in the phase's serving forwards."""
    import shutil

    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import BatchStream
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import build
    from repro_torch.models import params as pr
    from repro_torch.optim import AdamWConfig, adamw, cosine_warmup
    from repro_torch.training.trainer import (TrainState, clone_tree, make_train_step,
                                              microbatch, restore_state, save_state,
                                              train_state_shapes)

    cfg, hy_cfg = train_cfgs()
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED + 7), device="cuda")
    params = model.master_params()
    opt = adamw(AdamWConfig(lr=TR_LR), cosine_warmup(TR_LR, 1, TR_STEPS))
    state = TrainState(params, opt.init(params))
    stream = BatchStream(cfg, InputShape("train", TR_SEQ, TR_BATCH, "train"), seed=SEED,
                         device="cuda")
    step = make_train_step(model, opt, microbatches=TR_MICRO)
    print(f"lm train model: {cfg.name}, {model.param_count() / 1e6:.1f} M parameters, "
          f"{cfg.n_layers} layers, remat {cfg.remat}, compute {cfg.dtype}, float32 masters and "
          f"AdamW m, v; batch {TR_BATCH} x {TR_SEQ} in {TR_MICRO} microbatches, lr {TR_LR} "
          f"cosine_warmup(1, {TR_STEPS})")

    # (1) The serving forward's cross-entropy of batch 0, through K5.
    reset_counts()
    batch0 = stream.batch_at(0)
    serve_ce = serving_ce(model, batch0, TR_MICRO)
    k5_serve = launch_counts()["flash_attention"]
    if k5_serve != cfg.n_layers * TR_MICRO:
        fail(f"the serving forward launched K5 {k5_serve} times, expected "
             f"{cfg.n_layers * TR_MICRO}")

    # The train steps.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, batch in zip(range(TR_STEPS), stream):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if i == 0:
            ce0 = float(metrics["ce"])
    train_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    print(f"lm train steps: losses {[round(x, 5) for x in losses]}; step ms "
          f"{[round(t * 1e3, 1) for t in times]} (the first holds the warm-up), median of "
          f"steps 1-{TR_STEPS - 1} {step_s * 1e3:.3f} ms = {TR_BATCH * TR_SEQ / step_s:.1f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB allocated; launches {train_counts}; "
          f"card {smi}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if any(train_counts.values()):
        fail(f"a kernel launched inside the train steps: {train_counts}")
    tol = TRAIN_CE_ULPS * bf16_ulp(ce0)
    print(f"lm train check 1: step 0 cross-entropy {ce0:.6f} (training forward, plain "
          f"attention) against {serve_ce:.6f} (serving forward, K5 {k5_serve} launches): gap "
          f"{abs(ce0 - serve_ce):.4e} (tol {tol}, {TRAIN_CE_ULPS} bf16 ulp of the loss)")
    if not abs(ce0 - serve_ce) <= tol:
        fail(f"check 1: training and serving cross-entropy differ by {abs(ce0 - serve_ce)}")

    # (2) bf16 against float32 compute, one microbatch, the trained masters.
    reset_counts()
    mb = microbatch(stream.batch_at(0), TR_MICRO, 0)
    (l16, g16), (l32, g32) = bf16_and_f32_grads(model, cfg, state.params, mb)
    print(f"lm train check 2: one microbatch's loss bf16 {l16:.6f}, float32 {l32:.6f}")
    check_gaps("lm train check 2 (bf16 against float32 gradients)", grad_gaps(g16, g32),
               TRAIN_GRAD_REL, 2 * TRAIN_GRAD_REL)
    del g16, g32

    # (5) K5 has no backward: its router refuses a CUDA input that requires grad.
    q = torch.zeros((1, 512, 2, 128), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    kv = torch.zeros((1, 512, 1, 128), device="cuda", dtype=torch.bfloat16)
    try:
        flash_ops.flash_attention(q, kv, kv)
        fail("flash_attention took a CUDA input that requires grad")
    except RuntimeError as exc:
        if "no backward" not in str(exc):
            raise
    if any(launch_counts().values()):
        fail(f"a kernel launched in check 2 or 5: {launch_counts()}")

    # (6) Train checkpoint -> restore -> serve.
    shutil.rmtree(TR_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    save_state(str(TR_CKPT_DIR), TR_STEPS, state)
    save_s = time.perf_counter() - t0
    n_bytes = sum(f.stat().st_size for f in TR_CKPT_DIR.rglob("*.npy"))
    t0 = time.perf_counter()
    restored = restore_state(str(TR_CKPT_DIR), TR_STEPS, like=train_state_shapes(model, opt),
                             device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(TR_CKPT_DIR, ignore_errors=True)
    def leaves(s):
        return pr.flatten({"p": s.params, "m": s.opt.m, "v": s.opt.v, "step": s.opt.step})

    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(restored), leaves(state))):
        fail("check 6: the restored train state differs from the saved one")
    model.load_params(restored.params, device="cuda")
    del restored
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in (2048, 1024)]
    reset_counts()
    toks, calls, seconds = lm_static(model, prompts, slots=2, max_seq=TR_SEQ + 8, max_new=4)
    k5_handoff = launch_counts()["flash_attention"]
    finite = all(bool(torch.isfinite(c["logits"]).all())
                 for c in calls["prefill"] + calls["decode"])
    print(f"lm train check 6: state saved in {save_s:.2f} s ({n_bytes / 1e9:.2f} GB), restored in "
          f"{restore_s:.2f} s, equal bit for bit; its masters served one static batch of "
          f"prompts (2048, 1024), 4 new tokens each, in {seconds:.3f} s: tokens {toks}, K5 "
          f"launches {k5_handoff}, logits finite {finite}")
    if k5_handoff != cfg.n_layers or not finite:
        fail(f"check 6: K5 launched {k5_handoff} times (expected {cfg.n_layers}), finite {finite}")
    del calls

    # (3) microbatches=2 against 1, from copies of the trained state, at batch 2.
    small = stream.batch_at(TR_STEPS)
    small = {k: v[:TR_SMALL_BATCH] for k, v in small.items()}
    before = clone_tree(state)
    a = clone_tree(state)
    reset_counts()
    a, ma = make_train_step(model, opt, microbatches=2)(a, small)
    b, mb1 = make_train_step(model, opt)(state, small)
    del state

    def clipped_grad(s):
        return {path: (m - AdamWConfig.b1 * m0) / (1 - AdamWConfig.b1)
                for (path, m), (_, m0) in zip(pr.flatten(s.opt.m), pr.flatten(before.opt.m))}

    def update(s):
        return {path: p - p0 for (path, p), (_, p0) in
                zip(pr.flatten(s.params), pr.flatten(before.params))}

    gap = abs(float(ma["loss"]) - float(mb1["loss"]))
    tol = bf16_ulp(float(mb1["loss"]))
    print(f"lm train check 3: batch {TR_SMALL_BATCH}, loss microbatches=2 "
          f"{float(ma['loss']):.6f}, microbatches=1 {float(mb1['loss']):.6f}, gap {gap:.4e} "
          f"(tol {tol})")
    if not gap <= tol:
        fail(f"check 3: the losses differ by {gap}")
    for label, fn in (("clipped gradient", clipped_grad), ("update", update)):
        got, want = fn(a), fn(b)
        check_gaps(f"lm train check 3 ({label}, microbatches=2 against 1)",
                   grad_gaps(pr.unflatten(got.items()), pr.unflatten(want.items())),
                   TRAIN_MICRO_REL, None)
    del a, before

    # (4) Four steps on one fixed batch.
    fixed = make_train_step(model, adamw(AdamWConfig(lr=TR_FIXED_LR)))
    fixed_losses = []
    for _ in range(4):
        b, m = fixed(b, small)
        fixed_losses.append(float(m["loss"]))
    print(f"lm train check 4: four steps on one fixed batch of {TR_SMALL_BATCH} at lr "
          f"{TR_FIXED_LR:g}: losses {[round(x, 5) for x in fixed_losses]}")
    if not fixed_losses[-1] < fixed_losses[0]:
        fail(f"check 4: the loss did not fall: {fixed_losses}")
    if any(launch_counts().values()):
        fail(f"a kernel launched in the train steps of checks 3-4: {launch_counts()}")
    trace_train_step(lambda: fixed(b, small))
    del b, model, params
    torch.cuda.empty_cache()

    # The hybrid: one group of zamba2-7b, one bf16 train step.
    torch.cuda.reset_peak_memory_stats()
    hmodel = build(hy_cfg)
    hparams = hmodel.init(torch.Generator(device="cuda").manual_seed(SEED + 8),
                          device="cuda").master_params()
    hb = BatchStream(hy_cfg, InputShape("train", TR_SEQ, TR_SMALL_BATCH, "train"), seed=SEED,
                     device="cuda").batch_at(0)
    reset_counts()
    hopt = adamw(AdamWConfig(lr=TR_LR))
    hstate = TrainState(hparams, hopt.init(hparams))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hstate, hm = make_train_step(hmodel, hopt)(hstate, hb)
    torch.cuda.synchronize()
    h_step = time.perf_counter() - t0
    (l16, g16), (l32, g32) = bf16_and_f32_grads(hmodel, hy_cfg, hstate.params, hb)
    counts = launch_counts()
    print(f"hybrid train: {hy_cfg.name} cut to {hy_cfg.n_layers} Mamba2 blocks behind one "
          f"shared attention site ({hmodel.param_count() / 1e6:.1f} M parameters), batch "
          f"{TR_SMALL_BATCH} x {TR_SEQ}: one step {h_step * 1e3:.1f} ms (the first, with its "
          f"warm-up), loss {float(hm['loss']):.6f}; then loss bf16 {l16:.6f}, float32 "
          f"{l32:.6f}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{counts}")
    if counts["ssd_chunks"] or counts["flash_attention"]:
        fail(f"a kernel launched in the hybrid train step: {counts}")
    check_gaps("hybrid train (bf16 against float32 gradients)", grad_gaps(g16, g32),
               TRAIN_GRAD_REL, 2 * TRAIN_GRAD_REL)
    del hmodel, hstate, g16, g32, hparams
    torch.cuda.empty_cache()
    print(f"phase 7b (LM training): {time.perf_counter() - t_phase:.1f} s")
    return k5_serve + k5_handoff


# ---------------------------------------------------------------------------
# Phase 7c: the remaining LM families (qwen3-moe through K5, xLSTM, vlm, audio)
# ---------------------------------------------------------------------------

def family_cfgs() -> dict:
    """qwen3-moe-30b-a3b cut to MOE_LAYERS (serving) and MOE_TRAIN_LAYERS
    (training), and xlstm-1.3b, paligemma-3b and hubert-xlarge as
    published."""
    import dataclasses

    from repro_torch.configs import get_config

    moe = get_config(MOE_ARCH)
    return {"moe": dataclasses.replace(moe, n_layers=MOE_LAYERS),
            "moe_train": dataclasses.replace(moe, n_layers=MOE_TRAIN_LAYERS),
            "xlstm": get_config(XL_ARCH), "vlm": get_config(VLM_ARCH),
            "audio": get_config(AUDIO_ARCH)}


def k5_gate_open(cfg, s: int, device) -> bool:
    """Whether the model's own gate sends an attention of width ``s`` on
    ``device`` to K5 (no prefix, no grad)."""
    import torch

    from repro_torch.models import layers as ly

    return ly._use_flash_kernel(cfg, s, 0, torch.empty(0, device=device))


@contextlib.contextmanager
def moe_routes(replay: list | None = None):
    """Record the expert choices (B, S, k) of every ``moe.route`` call's own
    top-k, in call order. With ``replay`` (an earlier recording of the same
    calls), each call goes on with the recorded choices instead of its own,
    their weights renormalized from this call's probabilities; the
    recording still holds the call's own choices."""
    import torch

    from repro_torch.models import moe

    route, rec = moe.route, []

    def recorded(cfg, p, x):
        probs, w, idx = route(cfg, p, x)
        rec.append(idx.detach())
        if replay is not None:
            if len(rec) > len(replay) or replay[len(rec) - 1].shape != idx.shape:
                fail(f"moe route call {len(rec)} of {tuple(idx.shape)} has no recorded "
                     f"choices of that shape to replay")
            idx = replay[len(rec) - 1]
            w = torch.gather(probs, -1, idx)
            w = w / torch.sum(w, dim=-1, keepdim=True)
        return probs, w, idx

    moe.route = recorded
    try:
        yield rec
    finally:
        moe.route = route
    if replay is not None and len(rec) != len(replay):
        fail(f"{len(rec)} moe route calls replayed a recording of {len(replay)}")


def route_shares(got: list, want: list) -> list:
    """Two recordings of the same calls: per call, each token's (B, S)
    share of choices whose expert is not among the other's choices of that
    token."""
    return [(~(a[..., :, None] == b[..., None, :]).any(-1)).float().mean(-1)
            for a, b in zip(got, want)]


def prefill_shares(moved: list, n_layers: int) -> list[float]:
    """``route_shares`` of an engine run (``n_layers`` route calls per
    model call) averaged per layer over every position of its prefill calls
    (S > 1), whose contexts are the same on both paths."""
    out = []
    for layer in range(n_layers):
        picked = [m for m in moved[layer::n_layers] if m.shape[1] > 1]
        out.append(round(float(sum(m.sum() for m in picked)) / sum(m.numel() for m in picked), 5))
    return out


def family_reference_checks() -> None:
    """Each family's reduced float32 config on the card against the same
    parameters and batch on the CPU: forward logits (and, but for the
    encoder, a prefill and two decode steps) within FAMILY_REF_TOL."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import build
    from repro_torch.serving.engine import greedy

    def worst(got, want) -> float:
        want = want.float()
        return float(((got.float().cpu() - want).abs() / (1 + want.abs())).max())

    for arch in (MOE_ARCH, XL_ARCH, VLM_ARCH, AUDIO_ARCH):
        cfg = get_config(arch).reduced()
        cpu = build(cfg).init(torch.Generator().manual_seed(SEED), device="cpu")
        card = build(cfg).load_params(cpu.master_params(), device="cuda")
        batch = make_batch(cfg, InputShape("ref", 64, 2, "prefill"),
                           torch.Generator().manual_seed(SEED))
        on_card = {k: v.to("cuda") for k, v in batch.items()}
        errs = [worst(card.forward(on_card)[0], cpu.forward(batch)[0])]
        if not cfg.is_encoder:
            want, wcache = cpu.prefill(batch, 80)
            got, gcache = card.prefill(on_card, 80)
            errs.append(worst(got, want))
            for _ in range(2):
                tok = greedy(want)
                want, wcache = cpu.decode_step(wcache, {"tokens": tok})
                got, gcache = card.decode_step(gcache, {"tokens": tok.to("cuda")})
                errs.append(worst(got, want))
        print(f"family reference {cfg.name}: card against CPU, float32, "
              f"{len(errs)} logits tensors: worst |card - cpu| / (1 + |cpu|) {max(errs):.3e} "
              f"(tol {FAMILY_REF_TOL})")
        if not max(errs) <= FAMILY_REF_TOL:
            fail(f"{cfg.name}: the card's logits differ from the CPU's by {max(errs)}")


def check_moe_dispatch(cfg, idx) -> None:
    """On the card: the top-k tie rule on constructed exact ties, and the
    dispatch of the static prefill's first-layer choices ``idx`` (B, S, k)
    against the same on the CPU, exactly."""
    import torch

    from repro_torch.models import moe

    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.05]])
    ties = torch.randint(0, 8, (8, 64, cfg.n_experts), generator=torch.Generator()
                         .manual_seed(SEED)).float() / 8
    got = [moe.top_k(probs.to("cuda"), 2)[1], moe.top_k(ties.to("cuda"), cfg.experts_per_token)[1]]
    if got[0].tolist() != [[1, 2]] or not torch.equal(
            got[1].cpu(), moe.top_k(ties, cfg.experts_per_token)[1]):
        fail(f"top-k on the card breaks ties otherwise than the reference: {got[0].tolist()}")
    cap = moe.capacity(cfg, idx.shape[1])
    on_card = moe._dispatch_indices(idx, cfg.n_experts, cap)
    on_cpu = moe._dispatch_indices(idx.cpu(), cfg.n_experts, cap)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        fail("the dispatch indices on the card differ from the CPU's")
    dropped = 1 - float(on_cpu[3].float().mean())
    print(f"moe dispatch: top-k ties to the lower expert on the card; the static prefill's "
          f"layer-0 choices {tuple(idx.shape)} dispatch identically on the card and the CPU "
          f"(capacity {cap}, {dropped:.4f} of the token-choices dropped)")


def moe_serving(cfg, smi: str) -> int:
    """qwen3-moe at MOE_LAYERS layers: a static batch, then continuous
    batching, each through K5 and then through its plain version with the
    routes pinned to the kernel run's (see MOE_*). Returns K5's launches in
    the two runs through the kernels."""
    import torch

    from repro_torch.models import build

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED + 9), device="cuda")
    model.compute_params()
    torch.cuda.synchronize()
    n_layers = cfg.n_layers
    print(f"moe model: {cfg.name} cut to {n_layers} of 48 layers, "
          f"{model.param_count() / 1e9:.3f} B parameters (float32 master + bf16 compute copy), "
          f"{cfg.n_experts} experts, top-{cfg.experts_per_token}, d_ff {cfg.d_ff}, capacity "
          f"factor {cfg.capacity_factor}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}; drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 9)
    static_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                      for n in LM_STATIC_LENS]
    cont_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in MOE_CONT_LENS]

    lm_static(model, static_prompts[:2], max_new=2)  # warm-up
    reset_counts()
    with moe_routes() as k_routes:
        toks, calls, seconds = lm_static(model, static_prompts, max_new=MOE_MAX_NEW)
    k5_static = launch_counts()["flash_attention"]
    want_k5 = n_layers * k5_gate_open(cfg, max(LM_STATIC_LENS), model.device)
    dec = [c["seconds"] for c in calls["decode"]]
    n_tok = sum(len(t) for t in toks)
    print(f"moe static: {LM_SLOTS} slots, prompts {LM_STATIC_LENS} (padded width "
          f"{max(LM_STATIC_LENS)}), max_seq {LM_MAX_SEQ}, {MOE_MAX_NEW} new tokens each: "
          f"prefill {calls['prefill'][0]['seconds'] * 1e3:.3f} ms, decode "
          f"{statistics.median(dec) * 1e3:.3f} ms per step (median of {len(dec)}), {n_tok} "
          f"tokens in {seconds:.3f} s = {n_tok / seconds:.1f} generated tokens/s "
          f"({LM_SLOTS / statistics.median(dec):.1f} tokens/s in decode); K5 launches "
          f"{k5_static}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; largest "
          f"|logit| of the prefill {float(calls['prefill'][0]['logits'].abs().max()):.3f}; "
          f"card {smi}")
    if k5_static != want_k5:
        fail(f"K5 launched {k5_static} times in the moe static run, expected {want_k5}")
    for row in calls["prefill"][0]["logits"], *(c["logits"] for c in calls["decode"]):
        if not bool(torch.isfinite(row).all()):
            fail("non-finite logits in the moe static run")
    check_moe_dispatch(cfg, k_routes[0])

    reset_counts()
    with plain_versions(), moe_routes(replay=k_routes) as p_routes:
        _, p_calls, p_seconds = lm_static(model, static_prompts, max_new=MOE_MAX_NEW)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain moe run")
    moved = route_shares(p_routes, k_routes)
    del k_routes, p_routes
    n = len(static_prompts)
    kernel = static_steps(calls, n, MOE_MAX_NEW)
    plain = static_steps(p_calls, n, MOE_MAX_NEW)
    # Decode call t - 1 serves step t, whose context is the same on both
    # paths iff tokens 0 .. t - 1 are.
    same_ctx = [(r, t) for r in range(n) for t in range(1, MOE_MAX_NEW)
                if all(kernel[r][u][0] == plain[r][u][0] for u in range(t))]
    dec = [statistics.mean(float(moved[t * n_layers + layer][r, -1]) for r, t in same_ctx)
           if same_ctx else float("nan") for layer in range(n_layers)]
    print(f"moe routes, the plain path's own top-k against the K5 path's choices (which it "
          f"runs with): share of token-choices it would route to another expert per layer, "
          f"prefill (all {n} x {max(LM_STATIC_LENS)} positions) "
          f"{prefill_shares(moved, n_layers)}, decode (the {len(same_ctx)} steps whose "
          f"context is the same) {[round(x, 5) for x in dec]}")
    diff, n_logits, n_tokens, total = compare_paths("moe static", kernel, plain)
    print(f"moe static plain path (routes pinned): prefill "
          f"{p_calls['prefill'][0]['seconds'] * 1e3:.3f} ms, {n_tok / p_seconds:.1f} generated "
          f"tokens/s; logits on the same context differ by at most {diff:.4e} (tol "
          f"{LM_LOGIT_TOL}) over {n_logits} of {total} steps; tokens equal on {n_tokens} of "
          f"{total} steps (each request up to its first plain margin < {LM_MARGIN})")
    del kernel, plain, calls, p_calls, moved

    sched, admissions = continuous_schedule(MOE_CONT_MAX_NEW, LM_CONT_SLOTS)
    reset_counts()
    with moe_routes() as k_routes:
        reqs, ccalls, cseconds = lm_continuous(model, cont_prompts, max_seq=MOE_CONT_MAX_SEQ,
                                               max_new=MOE_CONT_MAX_NEW)
    k5_cont = launch_counts()["flash_attention"]
    want_k5 = n_layers * sum(k5_gate_open(cfg, n, model.device) for n in MOE_CONT_LENS)
    mid = sum(step >= 0 for step, _, _ in admissions)
    if not all(r.done and len(r.out) == m for r, m in zip(reqs, MOE_CONT_MAX_NEW)):
        fail(f"moe continuous: not every request completed: {[len(r.out) for r in reqs]}")
    if k5_cont != want_k5 or len(ccalls["decode"]) != len(sched) or mid == 0:
        fail(f"moe continuous: K5 {k5_cont} launches (expected {want_k5}), "
             f"{len(ccalls['decode'])} decode steps (schedule {len(sched)}), {mid} mid-stream "
             "admissions")
    kernel = continuous_steps(ccalls, sched, admissions, len(reqs), MOE_CONT_MAX_NEW)
    if [[st[0] for st in r] for r in kernel] != [r.out for r in reqs]:
        fail("moe continuous: the recorded calls do not replay the requests' tokens")
    if not all(bool(torch.isfinite(c["logits"]).all()) for c in ccalls["decode"]):
        fail("non-finite logits in the moe continuous run")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"moe continuous: {len(reqs)} requests over {LM_CONT_SLOTS} slots, prompts "
          f"{MOE_CONT_LENS}, max_new {MOE_CONT_MAX_NEW}: all complete; {len(sched)} decode "
          f"steps, {mid} admissions mid-stream; {n_tok} tokens in {cseconds:.3f} s = "
          f"{n_tok / cseconds:.1f} tokens/s; decode "
          f"{statistics.median(c['seconds'] for c in ccalls['decode']) * 1e3:.3f} ms per step "
          f"(median); K5 launches {k5_cont}")

    reset_counts()
    with plain_versions(), moe_routes(replay=k_routes) as p_routes:
        _, pc_calls, pc_seconds = lm_continuous(model, cont_prompts, max_seq=MOE_CONT_MAX_SEQ,
                                                max_new=MOE_CONT_MAX_NEW)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain moe continuous run")
    moved = route_shares(p_routes, k_routes)
    plain = continuous_steps(pc_calls, sched, admissions, len(reqs), MOE_CONT_MAX_NEW)
    diff, n_logits, n_tokens, total = compare_paths("moe continuous", kernel, plain)
    print(f"moe continuous plain path (routes pinned): {n_tok / pc_seconds:.1f} tokens/s; share "
          f"of token-choices its own top-k would route elsewhere per layer in the admission "
          f"prefills {prefill_shares(moved, n_layers)}; "
          f"logits on the same context differ by at most {diff:.4e} (tol {LM_LOGIT_TOL}) over "
          f"{n_logits} of {total} steps; tokens equal on {n_tokens} of {total} steps (each "
          f"request up to its first plain margin < {LM_MARGIN})")
    del kernel, plain, ccalls, pc_calls, k_routes, p_routes, moved
    tokens = torch.from_numpy(np.stack([np.pad(p, (max(LM_STATIC_LENS) - len(p), 0))
                                        for p in static_prompts])).to(model.device)
    lm_traces(model, tokens, label="moe", ours="flash_fwd")
    del model
    torch.cuda.empty_cache()
    return k5_static + k5_cont


def moe_training(cfg, smi: str) -> None:
    """One AdamW train step of qwen3-moe at MOE_TRAIN_LAYERS layers (remat
    per block, as published) on 2 x 2048; then (2) of phase 7b with the
    routes pinned (remat off in both, so the calls replay in order)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import BatchStream
    from repro_torch.models import build
    from repro_torch.models import params as pr
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.training.trainer import TrainState, make_train_step, value_and_grad

    torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    params = pr.init_params(model.param_specs(),
                            torch.Generator(device="cuda").manual_seed(SEED + 10), "cuda")
    batch = BatchStream(cfg, InputShape("train", TR_SEQ, TR_SMALL_BATCH, "train"), seed=SEED,
                        device="cuda").batch_at(0)
    opt = adamw(AdamWConfig(lr=TR_LR))
    state = TrainState(params, opt.init(params))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = make_train_step(model, opt)(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = launch_counts()
    aux = float(metrics["aux"])
    print(f"moe train: {cfg.name} cut to {cfg.n_layers} layers ({model.param_count() / 1e9:.3f} "
          f"B parameters), remat {cfg.remat}, batch {TR_SMALL_BATCH} x {TR_SEQ}: one AdamW step "
          f"{step_s * 1e3:.1f} ms (the first, with its warm-up), loss "
          f"{float(metrics['loss']):.6f}, ce {float(metrics['ce']):.6f}, aux {aux:.6f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}; "
          f"card {smi}")
    if counts["flash_attention"] or counts["ssd_chunks"]:
        fail(f"a kernel launched in the moe train step: {counts}")
    if not (math.isfinite(aux) and aux > 0 and math.isfinite(float(metrics["loss"]))):
        fail(f"moe train: loss {float(metrics['loss'])}, aux {aux}")
    params = state.params
    del state, metrics
    torch.cuda.empty_cache()

    c16 = dataclasses.replace(cfg, remat=False)
    c32 = dataclasses.replace(c16, dtype="float32")
    with moe_routes() as r16:
        (l16, _), g16 = value_and_grad(build(c16).loss, has_aux=True)(params, batch)
    with torch.no_grad(), moe_routes() as r32:
        build(c32).apply(params, batch)
    free = route_shares(r32, r16)
    with moe_routes(replay=r16):
        (l32, _), g32 = value_and_grad(build(c32).loss, has_aux=True)(params, batch)
    print(f"moe train check 2: loss bf16 {float(l16):.6f}, float32 (routes pinned) "
          f"{float(l32):.6f}; unpinned, the float32 model routes "
          f"{[round(float(m.mean()), 5) for m in free]} of the token-choices (per "
          "layer) to another expert")
    check_gaps("moe train (bf16 against float32 gradients, routes pinned)", grad_gaps(g16, g32),
               TRAIN_GRAD_REL, 2 * TRAIN_GRAD_REL)
    del params, g16, g32, r16, r32
    torch.cuda.empty_cache()


def xlstm_serving(cfg, smi: str) -> None:
    """xlstm-1.3b as published: a static batch (prefill split by block
    kind) and continuous batching. No kernel is on its path."""
    import torch

    from repro_torch.models import build
    from repro_torch.models import xlstm as xl

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED + 11), device="cuda")
    model.compute_params()
    torch.cuda.synchronize()
    n_super, per = model._xlstm_shape()
    print(f"xlstm model: {cfg.name}, {model.param_count() / 1e9:.3f} B parameters, "
          f"{n_super * (per - 1)} mLSTM + {n_super} sLSTM blocks, d {cfg.d_model}, "
          f"{cfg.n_heads} heads; drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 11)
    static_prompts = [rng.integers(2, cfg.vocab_size, size=XL_STATIC_LEN).astype(np.int32)
                      for _ in range(XL_SLOTS)]
    cont_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in XL_CONT_LENS]

    # Time inside each kind of block during the static prefill.
    spent = {"mLSTM": 0.0, "sLSTM": 0.0}
    originals = {"mLSTM": xl.mlstm_apply, "sLSTM": xl.slstm_apply}

    def clocked(kind):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[kind](*args, **kwargs)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t
            return out
        return run

    reset_counts()
    xl.mlstm_apply, xl.slstm_apply = clocked("mLSTM"), clocked("sLSTM")
    try:
        toks, calls, seconds = lm_static(model, static_prompts, slots=XL_SLOTS,
                                         max_seq=XL_MAX_SEQ, max_new=XL_MAX_NEW)
    finally:
        xl.mlstm_apply, xl.slstm_apply = originals["mLSTM"], originals["sLSTM"]
    counts = launch_counts()
    pre_s = calls["prefill"][0]["seconds"]
    dec = [c["seconds"] for c in calls["decode"]]
    n_tok = sum(len(t) for t in toks)
    print(f"xlstm static: {XL_SLOTS} slots, prompts of {XL_STATIC_LEN}, max_seq {XL_MAX_SEQ}, "
          f"{XL_MAX_NEW} new tokens each: prefill {pre_s * 1e3:.3f} ms (mLSTM blocks "
          f"{spent['mLSTM'] * 1e3:.3f} ms, sLSTM blocks {spent['sLSTM'] * 1e3:.3f} ms, "
          f"synchronized around each block), decode {statistics.median(dec) * 1e3:.3f} ms per "
          f"step (median of {len(dec)}), {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} generated tokens/s ({XL_SLOTS / statistics.median(dec):.1f} "
          f"tokens/s in decode); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches {counts}; card {smi}")
    if any(counts.values()):
        fail(f"a kernel launched in the xlstm static run: {counts}")
    for row in calls["prefill"][0]["logits"], *(c["logits"] for c in calls["decode"]):
        if not bool(torch.isfinite(row).all()):
            fail("non-finite logits in the xlstm static run")
    del calls

    sched, admissions = continuous_schedule(XL_CONT_MAX_NEW, XL_CONT_SLOTS)
    reqs, ccalls, cseconds = lm_continuous(model, cont_prompts, slots=XL_CONT_SLOTS,
                                           max_seq=XL_CONT_MAX_SEQ, max_new=XL_CONT_MAX_NEW)
    mid = sum(step >= 0 for step, _, _ in admissions)
    if not all(r.done and len(r.out) == m for r, m in zip(reqs, XL_CONT_MAX_NEW)):
        fail(f"xlstm continuous: not every request completed: {[len(r.out) for r in reqs]}")
    kernel = continuous_steps(ccalls, sched, admissions, len(reqs), XL_CONT_MAX_NEW)
    if ([[st[0] for st in r] for r in kernel] != [r.out for r in reqs]
            or len(ccalls["decode"]) != len(sched) or mid == 0):
        fail("xlstm continuous: the recorded calls do not replay the schedule")
    if not all(bool(torch.isfinite(c["logits"]).all()) for c in ccalls["decode"]):
        fail("non-finite logits in the xlstm continuous run")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"xlstm continuous: {len(reqs)} requests over {XL_CONT_SLOTS} slots, prompts "
          f"{XL_CONT_LENS}, max_new {XL_CONT_MAX_NEW}: all complete; {len(sched)} decode steps, "
          f"{mid} admissions mid-stream; {n_tok} tokens in {cseconds:.3f} s = "
          f"{n_tok / cseconds:.1f} tokens/s; decode "
          f"{statistics.median(c['seconds'] for c in ccalls['decode']) * 1e3:.3f} ms per step "
          f"(median), admission prefills "
          f"{[round(c['seconds'] * 1e3, 1) for c in ccalls['prefill']]} ms")
    _, cache = model.prefill({"tokens": torch.from_numpy(static_prompts[0][None, :256])
                              .to(model.device)}, XL_MAX_SEQ)
    step = {"tokens": torch.zeros((1, 1), dtype=torch.int32, device=model.device)}
    trace_call("xlstm", "one decode step (1 slot)", lambda: model.decode_step(cache, step),
               "xlstm_decode_trace")
    del model, cache
    torch.cuda.empty_cache()


def vlm_run(cfg, smi: str) -> None:
    """paligemma-3b as published: ``Model.prefill`` of VLM_BATCH x
    (n_patches + VLM_TEXT), then VLM_STEPS greedy ``decode_step``s."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import build
    from repro_torch.serving.engine import greedy

    torch.cuda.reset_peak_memory_stats()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED + 12), device="cuda")
    model.compute_params()
    s = cfg.n_patches + VLM_TEXT
    batch = make_batch(cfg, InputShape("vlm", s, VLM_BATCH, "prefill"),
                       torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    max_seq = s + VLM_STEPS
    reset_counts()
    model.prefill(batch, max_seq)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_seq)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    dec, rows = [], [logits]
    cur = greedy(logits)
    t_all = time.perf_counter()
    for _ in range(VLM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"tokens": cur})
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
        rows.append(logits)
        cur = greedy(logits)
    seconds = pre_s + time.perf_counter() - t_all
    counts = launch_counts()
    print(f"vlm: {cfg.name}, {model.param_count() / 1e9:.3f} B parameters, prefix-LM over "
          f"{cfg.n_patches} patches: prefill {tuple(batch['patches'].shape)} patches + "
          f"{tuple(batch['tokens'].shape)} tokens {pre_s * 1e3:.3f} ms, decode "
          f"{statistics.median(dec) * 1e3:.3f} ms per step (median of {VLM_STEPS}), "
          f"{VLM_BATCH * (VLM_STEPS + 1) / seconds:.1f} generated tokens/s "
          f"({VLM_BATCH / statistics.median(dec):.1f} in decode); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}; card {smi}")
    if any(counts.values()):
        fail(f"a kernel launched in the vlm run (the prefix-LM mask keeps K5 shut): {counts}")
    if (not all(bool(torch.isfinite(r).all()) for r in rows)
            or cache["pos"].tolist() != [s + VLM_STEPS] * VLM_BATCH):
        fail("vlm: non-finite logits or a wrong cache position")
    trace_call("vlm", f"one prefill ({VLM_BATCH}, {s})", lambda: model.prefill(batch, max_seq),
               "vlm_prefill_trace")
    del model, cache, rows
    torch.cuda.empty_cache()


def audio_run(cfg, smi: str) -> None:
    """hubert-xlarge as published: ``Model.loss``'s forward (no grad) on
    AUDIO_BATCH x AUDIO_FRAMES frames with the synthetic mask."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import build

    torch.cuda.reset_peak_memory_stats()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED + 13), device="cuda")
    params = model.master_params()
    batch = make_batch(cfg, InputShape("audio", AUDIO_FRAMES, AUDIO_BATCH, "train"),
                       torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    reset_counts()
    with torch.no_grad():
        model.loss(params, batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        torch.cuda.synchronize()
    loss_s = time.perf_counter() - t0
    counts = launch_counts()
    masked = float(batch["mask"].mean())
    print(f"audio: {cfg.name}, {model.param_count() / 1e9:.3f} B parameters, encoder, head_dim "
          f"{cfg.head_dim}: Model.loss forward on {AUDIO_BATCH} x {AUDIO_FRAMES} frames of "
          f"{cfg.frontend_dim} ({masked:.4f} of them masked) {loss_s * 1e3:.3f} ms = "
          f"{AUDIO_BATCH * AUDIO_FRAMES / loss_s:.1f} frames/s, loss {float(loss):.6f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}; card {smi}")
    if any(counts.values()) or not math.isfinite(float(loss)) or not 0.04 < masked < 0.12:
        fail(f"audio: launches {counts}, loss {float(loss)}, masked share {masked}")
    try:
        model.decode_step({}, {"tokens": torch.zeros((1, 1), dtype=torch.int32, device="cuda")})
    except ValueError:
        pass
    else:
        fail("audio: the encoder's decode_step did not raise")
    with torch.no_grad():
        trace_call("audio", f"one loss forward ({AUDIO_BATCH}, {AUDIO_FRAMES})",
                   lambda: model.loss(params, batch), "audio_loss_trace")
    del model, params
    torch.cuda.empty_cache()


def families_phase(gen, smi: str) -> tuple[dict, int]:
    """Phase 7c. Returns K5's rows at qwen3-moe's shapes and K5's launches
    in the moe engine runs through the kernels."""
    import torch

    t_phase = time.perf_counter()
    cfgs = family_cfgs()
    rows = {}
    moe = cfgs["moe"]
    # (B, S): the static prefill's launch, then each batch-1 admission
    # prefill of the continuous run that opens K5's gate.
    shapes = [(LM_SLOTS, max(LM_STATIC_LENS))] + [
        (1, s) for s in sorted(set(MOE_CONT_LENS)) if k5_gate_open(moe, s, "cuda")]
    for b, s in shapes:
        r = flash_row(gen, b, s, moe.n_heads, moe.n_kv_heads, moe.head_dim, torch.bfloat16,
                      True)
        rows[r.pop("name")] = r
    print_kernel_rows(rows)
    family_reference_checks()
    k5 = moe_serving(moe, smi)
    moe_training(cfgs["moe_train"], smi)
    xlstm_serving(cfgs["xlstm"], smi)
    vlm_run(cfgs["vlm"], smi)
    audio_run(cfgs["audio"], smi)
    print(f"phase 7c (the remaining LM families): {time.perf_counter() - t_phase:.1f} s")
    return rows, k5


# ---------------------------------------------------------------------------
# Phase 8: hybrid serving (zamba2-7b, K6)
# ---------------------------------------------------------------------------

def ssd_log_decay(x, decay: str, gen):
    """ld = -dt A for x (heads, ...) ~ N(0, 1), with a per-row (head) A and
    dt bias drawn by the law ``decay`` names (see SSD_CASES)."""
    import torch
    import torch.nn.functional as F

    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    if decay == "weak":
        dt0 = torch.exp(torch.empty(shape, device=x.device).uniform_(
            math.log(1e-3), math.log(0.1), generator=gen))
        bias = dt0 + torch.log(-torch.expm1(-dt0))  # softplus(bias) = dt0
        a = torch.empty(shape, device=x.device).uniform_(1.0, 16.0, generator=gen)
        return -F.softplus(x + bias) * a
    if decay == "strong":
        return -F.softplus(x) * 8.0
    a_log = 0.02 * torch.randn(shape, generator=gen, device=x.device)
    return -F.softplus(x) * torch.exp(a_log)


def ssd_inputs(gen, case) -> tuple:
    """One case's inputs (see SSD_CASES): "full", q, k, v (G, NC, L, 64), ld
    (G, NC, L) of the case's type, h_in (G, NC, 64, 64) float32; "grouped",
    q, k (G, NC, L, 64), v (G, NC, L, Hg, 64), ld (G, NC, L, Hg), h_in (G, Hg,
    NC, 64, 64)."""
    import torch

    _, layout, g, nc, l, hg, dtype, decay = case
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    if layout == "full":
        q, k, v = (randn(g, nc, l, 64).to(dt) for _ in range(3))
        ld = ssd_log_decay(randn(g, nc, l), decay, gen).to(dt)
        return q, k, v, ld, 16.0 * randn(g, nc, 64, 64)
    qk = randn(g, nc, l, 128).to(dt)
    v = randn(g, nc, l, hg, 64).to(dt)
    ld = ssd_log_decay(randn(g * hg, nc, l), decay, gen).reshape(g, hg, nc, l)
    ld = ld.permute(0, 2, 3, 1).contiguous().to(dt)
    return qk[..., :64], qk[..., 64:], v, ld, 16.0 * randn(g, hg, nc, 64, 64)


def ssd_share(got, want, dtype: str, tol=None) -> float:
    """The largest share of its tolerance (SSD_TOL[dtype], or ``tol``) that
    any element of K6's output ``got`` (y or the state) uses against the
    plain version's ``want``, each row (last axis) at its own scale."""
    rel, row = SSD_TOL[dtype] if tol is None else tol
    got, want = got.float(), want.float()
    tol = rel * want.abs() + row * want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / tol).max())


def ssd_bound(mode: str, g: int, nc: int, l: int, hg: int, dtype: str) -> tuple[float, str]:
    """Least time for one K6 launch of ``mode`` ("full", "states" or
    "outputs") on G groups of Hg heads, NC chunks of L rows, head 64: q and k
    read once per group (states: k only), v and ld once per head, h_in read
    (full, outputs), y written (full, outputs) and the state written (full,
    states) once; against the products: the causal q k^T once per group and
    chunk (64 L (L + 1) MACs, half of them for L = 1 ... exactly the causal
    pairs) and P v per head (the same count), on the tensor cores in bf16,
    and q h_in and the state (L 64^2 MACs each per head). In bf16 the kernel
    runs each float32 product as three bf16 tensor-core products, and the
    bound counts them so; in float32 every product runs on the CUDA cores at
    the float32 rate."""
    es = 2 if dtype == "bfloat16" else 4
    chunks, heads = g * nc, g * nc * hg
    wants_y, wants_state = mode != "states", mode != "outputs"
    n_bytes = (chunks * l * 64 * es * (2 if wants_y else 1)    # q, k
               + heads * (l * 64 * es + l * es)                # v, ld
               + heads * l * 64 * es * wants_y                 # y
               + heads * 64 * 64 * 4 * (wants_y + wants_state))  # h_in, state
    causal = 2.0 * 64 * l * (l + 1) / 2                        # flop of one causal product
    f32_products = heads * 2.0 * l * 64 * 64 * (wants_y + wants_state)
    tc = (chunks + heads) * causal * wants_y
    if dtype == "bfloat16":
        t_ops = (tc + 3 * f32_products) / BF16_FLOP_PER_S * 1e3
    else:
        t_ops = (tc + f32_products) / FP32_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_case_inputs(gen) -> list:
    """[(case, inputs, the plain versions' outputs)] for SSD_CASES: "full",
    (y, state); "grouped", {"states", "outputs": the plain version's output;
    "states exact", "outputs exact": on float32 copies of the inputs}."""
    import torch

    from repro_torch.kernels.ssd import ref as sr

    out = []
    for case in SSD_CASES:
        inputs = ssd_inputs(gen, case)
        if case[1] == "full":
            out.append((case, inputs, sr.ssd_chunks(*inputs)))
            continue
        q, k, v, ld, h_in = inputs
        f32 = [t.to(torch.float32) for t in (q, k, v, ld)]
        out.append((case, inputs, {
            "states": sr.ssd_chunk_states(k, v, ld),
            "outputs": sr.ssd_chunk_outputs(q, k, v, ld, h_in),
            "states exact": sr.ssd_chunk_states(*f32[1:]),
            "outputs exact": sr.ssd_chunk_outputs(*f32, h_in),
        }))
    return out


def ssd_shares(case, inputs, want) -> tuple[dict[str, float], float]:
    """K6 on one case's inputs: ({check: the largest share of its tolerance
    an element uses}, the largest abs error against the plain version).
    "full": y and the state against the plain version (SSD_TOL). "grouped":
    each mode against its plain version (SSD_TOL[type]) and against the
    plain version on float32 copies (states SSD_TOL["float32"], outputs
    SSD_TOL[type]); "states ignore h_in" is 0 when the states mode handed a
    nonzero h_in returns the same bits, else inf."""
    import torch

    from repro_torch.kernels.ssd import kernel as sk

    dtype = case[6]
    if case[1] == "full":
        got = sk.ssd_chunks(*inputs)
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        return {"y": ssd_share(got[0], want[0], dtype),
                "state": ssd_share(got[1], want[1], dtype)}, err
    q, k, v, ld, h_in = inputs
    states = sk.ssd_chunk_states(k, v, ld)
    handed = sk._states_handed_h_in(k, v, ld, h_in)
    y = sk.ssd_chunk_outputs(q, k, v, ld, h_in)
    torch.cuda.synchronize()
    err = max(float((states - want["states"]).abs().max()),
              float((y.float() - want["outputs"].float()).abs().max()))
    return {"states": ssd_share(states, want["states"], dtype),
            "states exact": ssd_share(states, want["states exact"], "float32"),
            "states ignore h_in": 0.0 if torch.equal(states, handed) else float("inf"),
            "outputs": ssd_share(y, want["outputs"], dtype),
            "outputs exact": ssd_share(y, want["outputs exact"], dtype)}, err


def ssd_scan_inputs(gen, decay: str) -> tuple:
    """ssd_scan_grouped's inputs at the static prefill's (8, 2048, 112, 64):
    q = C and k = B (8, 2048, 64) as views of one (8, 2048, 128) tensor, v
    (8, 2048, 112, 64), ld (8, 2048, 112), bf16."""
    import torch

    b, s, h = 8, 2048, 112

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    qk = randn(b, s, 128).to(torch.bfloat16)
    ld = ssd_log_decay(randn(b * h, s), decay, gen).reshape(b, h, s).transpose(1, 2)
    return (qk[..., :64], qk[..., 64:], randn(b, s, h, 64).to(torch.bfloat16),
            ld.contiguous().to(torch.bfloat16))


def check_ssd(gen) -> dict[str, dict]:
    """K6 against its plain version on every case of SSD_CASES, element by
    element within SSD_TOL (the grouped cases also against the plain version
    on float32 copies, and the states mode handed a nonzero h_in), then
    ssd_scan_grouped end to end (y and the final state: the states launch,
    the inter-chunk loop, the outputs launch) at the static prefill's (8,
    2048, 112, 64) against ssd_scan_grouped through the plain versions, and
    against the plain scan of float32 copies of the inputs, each within
    SSD_SCAN_TOL."""
    import torch

    from repro_torch.kernels.ssd import kernel as sk, ops as so, ref as sr

    rows = {}
    for case, inputs, want in ssd_case_inputs(gen):
        name, layout, g, nc, l, hg, dtype, decay = case
        shares, err = ssd_shares(case, inputs, want)
        rel, row = SSD_TOL[dtype]
        text = ", ".join(f"{c} {s:.4f}" for c, s in shares.items())
        if not max(shares.values()) <= 1.0:
            fail(f"K6 {layout} {name} ({g}, {nc}, {l}, {hg}) {dtype}: an element exceeds its "
                 f"tolerance; worst shares by check: {text}")
        cum_min = float(torch.cumsum(inputs[3].float(), 2).min())
        if decay == "strong" and not cum_min < -1000:
            fail(f"K6 {layout} {name}: cum reaches only {cum_min}, not below -1000")
        reps = {} if g * nc * hg <= 1024 else dict(launches=5, reps=5)
        q, k, v, ld, h_in = inputs
        if layout == "full":
            calls = {"ssd_chunks": (lambda: sk.ssd_chunks(*inputs),
                                    lambda: sr.ssd_chunks(*inputs), "full")}
            dims = f"({g}, {nc}, {l}, 64)"
            shape = f"q, k, v {dims}, h_in nonzero"
        else:
            calls = {"ssd_chunk_states": (lambda: sk.ssd_chunk_states(k, v, ld),
                                          lambda: sr.ssd_chunk_states(k, v, ld), "states"),
                     "ssd_chunk_outputs": (lambda: sk.ssd_chunk_outputs(q, k, v, ld, h_in),
                                           lambda: sr.ssd_chunk_outputs(q, k, v, ld, h_in),
                                           "outputs")}
            dims = f"({g}, {nc}, {l}, {hg}, 64)"
            shape = f"q, k ({g}, {nc}, {l}, 64) strided, v {dims}, h_in nonzero"
        for fn_name, (kernel_fn, plain_fn, mode) in calls.items():
            b_ms, b_by = ssd_bound(mode, g, nc, l, hg, dtype)
            rows[f"{fn_name}/{name} {dims} {dtype} {decay} decay"] = dict(
                shape=f"{shape}, min cum {cum_min:.1f}", max_abs_err=err, tol=None,
                note=f"tol per element {rel:.3g} |plain| + {row:.3g} max|plain row|; the "
                     f"worst element uses, by check, {text}",
                ms=time_ms(kernel_fn), plain_ms=time_ms(plain_fn, **reps),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
            )
    del want, inputs
    for decay in ("model", "weak"):
        args = ssd_scan_inputs(gen, decay)
        got = so.ssd_scan_grouped(*args)
        with plain_versions():
            want = so.ssd_scan_grouped(*args)
            plain_ms = time_ms(lambda: so.ssd_scan_grouped(*args), launches=5, reps=5)
            exact = so.ssd_scan_grouped(*(t.float() for t in args))
        shares = {f"{path} {what}": ssd_share(r[i], ref[i], "bfloat16", SSD_SCAN_TOL)
                  for path, r, ref in (("against plain", got, want), ("kernel exact", got, exact),
                                       ("plain exact", want, exact))
                  for i, what in ((0, "y"), (1, "state"))}
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        label = f"ssd_scan/static prefill (8, 2048, 112, 64) bfloat16 {decay} decay"
        rel, row = SSD_SCAN_TOL
        text = ", ".join(f"{c} {s:.4f}" for c, s in shares.items())
        if not max(s for c, s in shares.items() if not c.startswith("plain")) <= 1.0:
            fail(f"{label}: the scan through K6 exceeds SSD_SCAN_TOL against the plain scan or "
                 f"the float32 scan: {text}")
        b_ms = sum(ssd_bound(m, 8, 8, 256, 112, "bfloat16")[0] for m in ("states", "outputs"))
        rows[label] = dict(
            shape="K6 states and outputs at (8, 8, 256, 112, 64) and the chunk loop",
            max_abs_err=err, tol=None,
            note=f"tol per element {rel:.3g} |plain| + {row:.3g} max|plain row|; the worst "
                 f"element uses, by path and output, {text}; bound: the two launches'",
            ms=time_ms(lambda: so.ssd_scan_grouped(*args), launches=5, reps=5),
            plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by="bytes",
        )
        del args, got, want, exact
    print_kernel_rows(rows)
    torch.cuda.empty_cache()
    return rows


def hybrid_phase(gen) -> tuple[dict, int]:
    """Phase 8. Returns the K6 rows and K6's launches in the two engine
    runs through the kernels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build

    rows = check_ssd(gen)
    cfg = get_config(HY_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    model.compute_params()
    torch.cuda.synchronize()
    n_full, rem, per = model._hybrid_shape()
    print(f"hybrid model: {cfg.name}, {model.param_count():,} parameters (float32 master + "
          f"bf16 compute copy, {torch.cuda.memory_allocated() / 1e9:.2f} GB), {cfg.n_layers} "
          f"Mamba2 blocks in {n_full} groups of {per} + {rem} behind {model.n_attn_sites} "
          f"sites of one shared attention block, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim} x state {cfg.ssm_state}, vocab {cfg.vocab_size}; drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    static_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                      for n in HY_STATIC_LENS]
    cont_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in HY_CONT_LENS]
    static = dict(slots=HY_SLOTS, max_seq=HY_MAX_SEQ)
    cont = dict(slots=HY_CONT_SLOTS, max_seq=HY_CONT_MAX_SEQ, max_new=HY_CONT_MAX_NEW)

    # Static batch through the kernels (after one short warm-up generate).
    lm_static(model, static_prompts[:2], max_new=2, **static)
    reset_counts()
    toks, calls, seconds = lm_static(model, static_prompts, max_new=HY_MAX_NEW, **static)
    counts = launch_counts()
    k6_static = counts["ssd_chunks"]
    pre_s = calls["prefill"][0]["seconds"]
    dec = [c["seconds"] for c in calls["decode"]]
    n_tok = sum(len(t) for t in toks)
    max_logit = float(calls["prefill"][0]["logits"].abs().max())
    tol = HY_LOGIT_ULPS * 2.0 ** (math.floor(math.log2(max_logit)) - 7)
    margin = tol / 2
    print(f"hybrid static: {HY_SLOTS} slots, prompts {HY_STATIC_LENS} (padded width "
          f"{max(HY_STATIC_LENS)}), max_seq {HY_MAX_SEQ}, {HY_MAX_NEW} new tokens each: "
          f"prefill {pre_s * 1e3:.3f} ms, decode {statistics.median(dec) * 1e3:.3f} ms per "
          f"step (median of {len(dec)}), {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} generated tokens/s ({HY_SLOTS / statistics.median(dec):.1f} "
          f"tokens/s in decode); K6 launches {k6_static}, K5 {counts['flash_attention']}; "
          f"largest |logit| of the prefill {max_logit:.3f}, so the logit tolerance is "
          f"{tol} ({HY_LOGIT_ULPS} bf16 ulps) and the token margin {margin}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if k6_static != 2 * cfg.n_layers:
        fail(f"K6 launched {k6_static} times in the static run, expected {2 * cfg.n_layers}")
    if counts["flash_attention"]:
        fail("K5 launched in the hybrid run (head_dim 112 keeps its gate shut)")
    for row in calls["prefill"][0]["logits"], *(c["logits"] for c in calls["decode"]):
        if not bool(torch.isfinite(row).all()):
            fail("non-finite logits in the hybrid static run")
    reset_counts()
    with plain_versions():
        p_toks, p_calls, p_seconds = lm_static(model, static_prompts, max_new=HY_MAX_NEW,
                                               **static)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain hybrid run")
    n = len(static_prompts)
    kernel = static_steps(calls, n, HY_MAX_NEW)
    plain = static_steps(p_calls, n, HY_MAX_NEW)
    if ([[st[0] for st in r] for r in kernel] != toks
            or [[st[0] for st in r] for r in plain] != p_toks):
        fail("hybrid static run: the recorded calls do not replay the generated tokens")
    diff, n_logits, n_tokens, total = compare_paths("hybrid static", kernel, plain, tol, margin)
    print(f"hybrid static plain path: prefill {p_calls['prefill'][0]['seconds'] * 1e3:.3f} ms, "
          f"{n_tok / p_seconds:.1f} generated tokens/s; logits on the same context differ by "
          f"at most {diff:.4e} (tol {tol}) over {n_logits} of {total} steps; tokens equal on "
          f"{n_tokens} of {total} steps (each request up to its first plain margin < {margin})")
    del kernel, plain, calls, p_calls

    # Continuous batching over 4 slots.
    steps, admissions = continuous_schedule(HY_CONT_MAX_NEW, HY_CONT_SLOTS)
    reset_counts()
    reqs, calls, seconds = lm_continuous(model, cont_prompts, **cont)
    k6_cont = launch_counts()["ssd_chunks"]
    gated = sum(n <= cfg.ssm_chunk or n % cfg.ssm_chunk == 0 for n in HY_CONT_LENS)
    want_k6 = 2 * cfg.n_layers * gated
    mid = sum(step >= 0 for step, _, _ in admissions)
    if not all(r.done and len(r.out) == m for r, m in zip(reqs, HY_CONT_MAX_NEW)):
        fail(f"hybrid continuous run: not every request completed: {[len(r.out) for r in reqs]}")
    if k6_cont != want_k6 or len(calls["decode"]) != len(steps) or mid == 0:
        fail(f"hybrid continuous run: K6 {k6_cont} launches (expected {want_k6}), "
             f"{len(calls['decode'])} decode steps (schedule {len(steps)}), {mid} mid-stream "
             "admissions")
    kernel = continuous_steps(calls, steps, admissions, len(reqs), HY_CONT_MAX_NEW)
    if [[st[0] for st in r] for r in kernel] != [r.out for r in reqs]:
        fail("hybrid continuous run: the recorded calls do not replay the requests' tokens")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"hybrid continuous: {len(reqs)} requests over {HY_CONT_SLOTS} slots, prompts "
          f"{HY_CONT_LENS}, max_new {HY_CONT_MAX_NEW}: all complete; {len(steps)} decode "
          f"steps, {mid} admissions mid-stream; {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} tokens/s; decode "
          f"{statistics.median(c['seconds'] for c in calls['decode']) * 1e3:.3f} ms per step "
          f"(median); K6 launches {k6_cont} ({gated} prompts through K6, {2 * cfg.n_layers} "
          "each)")
    reset_counts()
    with plain_versions():
        p_reqs, p_calls, p_seconds = lm_continuous(model, cont_prompts, **cont)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain hybrid continuous run")
    plain = continuous_steps(p_calls, steps, admissions, len(p_reqs), HY_CONT_MAX_NEW)
    if [[st[0] for st in r] for r in plain] != [r.out for r in p_reqs]:
        fail("plain hybrid continuous run: the recorded calls do not replay the tokens")
    diff, n_logits, n_tokens, total = compare_paths("hybrid continuous", kernel, plain, tol,
                                                    margin)
    print(f"hybrid continuous plain path: {n_tok / p_seconds:.1f} tokens/s; logits on the "
          f"same context differ by at most {diff:.4e} (tol {tol}) over {n_logits} of {total} "
          f"steps; tokens equal on {n_tokens} of {total} steps (each request up to its first "
          f"plain margin < {margin})")
    del kernel, plain, calls, p_calls
    lm_traces(model, torch.from_numpy(np.stack([
        np.pad(p, (max(HY_STATIC_LENS) - len(p), 0)) for p in static_prompts])).to("cuda"),
        HY_MAX_SEQ, "hybrid", "ssd_chunk", heads=(cfg.n_ssm_heads, cfg.ssm_state))
    print(f"hybrid peak memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
          f"at most in the phase")
    del model
    torch.cuda.empty_cache()
    return rows, k6_static + k6_cont


def print_kernel_rows(rows: dict) -> None:
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        tol = [] if r["tol"] is None else [f"tol {r['tol']:.3e}"]
        print(f"kernel {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({'; '.join(tol + ([r['note']] if 'note' in r else []))}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


# ---------------------------------------------------------------------------
# Phase 9: the mesh and dry-run tools
# ---------------------------------------------------------------------------

# (a) The dry run of qwen3-0.6b on the 16x16 fake world, one CPU
# subprocess a shape (fake tensors, the card hidden; one thread each, the
# three side by side), started when phase 9 begins and read at its end;
# its records go to chiprun_out/.
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRY_OUT = ROOT / "chiprun_out" / "dryrun_qwen3_16x16.jsonl"
DRY_TIMEOUT_S = 900.0
# (b), (c) qwen3-0.6b at full width (bf16, random weights from MESH_SEED),
# prefill at (8, 2048), K5 on each rank's local shard; one zamba2-7b group
# through K6. The train step of (c): MESH_TRAIN_LAYERS layers, batch
# TR_SMALL_BATCH x TR_SEQ, AdamW at TR_LR.
MESH_SEED = SEED + 40
MESH_BATCH, MESH_SEQ = 8, 2048
MESH_TRAIN_LAYERS = 2
# (c) against (b): the (1, 2) mesh splits the heads (8 of 16 and 4 of 8 KV
# heads a rank, the row-parallel output projection summed over the two
# ranks) and the (2, 1) mesh the rows (cuBLAS may pick other kernels for
# 4 rows than for 8): bf16 roundings in other places, carried through 28
# layers, as K5 against its plain version in phase 7 -- phase 7's rule,
# LM_LOGIT_TOL. The train step on (2, 1) against the one-process step:
# each rank's microbatch is one row, and the gradient is rounded to bf16
# per rank before the ranks' sum -- phase 7b's check (3) (microbatches 2
# against 1) differs the same way, so its rules hold: the loss within one
# bf16 ulp, each leaf's clipped gradient within TRAIN_MICRO_REL. The
# update of a first AdamW step (zero moments) is -lr (sign(g) + wd p) per
# element, so where |g| lies within the gradients' gap of 0 its sign may
# flip: each update element within MESH_FLIP (2 lr, one flip, and a
# rounding) of the one-process update, and each leaf's elements whose
# one-process |g| exceeds TRAIN_MICRO_REL of the leaf's largest (their
# sign settled) within TRAIN_MICRO_REL of the leaf's largest update.
# gloo carries all_reduce for CUDA tensors, and all_gather_into_tensor
# crashes its ranks (tools/gloo_cuda_collectives.py): the card's two-rank
# runs take the placements that need all-reduces only -- the 2d rules on
# (1, 2) (tensor parallel), the dp_vocab rules on (2, 1) (rows over 'data',
# the blocks' parameters whole) -- and each rank hands back its local
# shard of the logits; the fsdp rules' gathers and reduce-scatters run on
# the CPU gloo worlds (tests/test_torch_distributed.py).
MESH_GLOO_RULES = {(1, 2): "2d", (2, 1): "dp_vocab"}
MESH_FLIP = 2 * TR_LR * (1 + 2.0**-7)


def _dry_out(shape: str):
    return DRY_OUT.with_suffix(f".{shape}.jsonl")


def start_dryrun() -> dict:
    """The dry run's subprocesses, one a shape (the card hidden: they
    trace fake CPU tensors)."""
    import os

    DRY_OUT.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = {}
    for shape in DRY_SHAPES:
        _dry_out(shape).unlink(missing_ok=True)
        procs[shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH, "--shape",
             shape, "--out", str(_dry_out(shape))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def dryrun_records(procs: dict, smi: str) -> list[dict]:
    """Phase 9a: wait for the dry run, print its records (also written
    together to DRY_OUT), fail on any error."""
    deadline = time.monotonic() + DRY_TIMEOUT_S
    recs, logs = [], []
    for shape, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            fail(f"the dry run did not finish within {DRY_TIMEOUT_S:g} s")
        logs.append(out)
        got = [json.loads(line) for line in _dry_out(shape).read_text().splitlines()] \
            if _dry_out(shape).exists() else []
        if proc.returncode or len(got) != 1:
            print(out[-3000:])
            fail(f"the dry run of {shape} exited {proc.returncode} with {len(got)} records")
        recs += got
        _dry_out(shape).unlink()
    (ROOT / "chiprun_out" / "dryrun_qwen3_16x16.log").write_text("".join(logs))
    DRY_OUT.write_text("".join(json.dumps(r) + "\n" for r in recs))
    for r in recs:
        if "error" in r:
            fail(f"dry run {r['arch']} x {r['shape']} ({r['mesh']}): {r['error']}")
        print(f"dryrun {r['arch']} x {r['shape']} on {r['mesh']} ({r['n_devices']} fake ranks, "
              f"traced on the host CPU in {r['trace_s']} s, microbatches {r['microbatches']}): "
              f"per device args {r['arg_bytes'] / 1e9:.3f} GB, temp {r['temp_bytes'] / 1e9:.3f} "
              f"GB, out {r['output_bytes'] / 1e9:.3f} GB, fits_hbm {r['fits_hbm']} (80 GB); "
              f"flops {r['hlo_flops_per_dev']:.4e}, HBM bytes {r['hbm_bytes_per_dev']:.4e}, "
              f"collective bytes {r['coll_bytes_per_dev']:.4e} {r['coll_by_type']}; roofline at "
              f"H100 SXM constants: compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f} "
              f"s, collective {r['collective_s']:.4f} s -> {r['bottleneck']}-bound; "
              f"useful_flops_ratio {r['useful_flops_ratio']:.4f}")
    print(f"dryrun: {len(recs)} records in {DRY_OUT.relative_to(ROOT)}; card {smi}")
    return recs


def _mesh_inputs(cfg, seed: int, b: int, s: int):
    import torch

    from repro_torch.models import build

    gen = torch.Generator(device="cuda").manual_seed(seed)
    plain = build(cfg).init(gen, device="cuda")
    toks = torch.randint(2, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    return plain, toks


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_nccl_rank(rank: int, device, seed: int) -> dict:
    """Phase 9b in a world of one nccl rank: the (1, 1) mesh Model's
    prefill against the unsharded model's, qwen3-0.6b (K5) and one
    zamba2-7b group (K6)."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.sharding import activations as act

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    hy = get_config(HY_ARCH)
    out = {}
    for name, cfg in (("qwen3", get_config(LM_ARCH)),
                      ("zamba2", dataclasses.replace(hy, n_layers=hy.attn_every))):
        plain, toks = _mesh_inputs(cfg, seed, MESH_BATCH, MESH_SEQ)
        batch = {"tokens": toks[:, :-1]}
        plain.prefill(batch, MESH_SEQ)
        reset_counts()
        (want, _), plain_ms = _timed(lambda: plain.prefill(batch, MESH_SEQ))
        plain_counts = launch_counts()
        model = build(cfg, act_axes=("data",), mesh=mesh)
        model.load_params(plain.master_params(), device="cuda")
        model.prefill(batch, MESH_SEQ)  # the mesh path's first call (DTensor's caches)
        reset_counts()
        (got, _), mesh_ms = _timed(lambda: model.prefill(batch, MESH_SEQ))
        out[name] = {"logits": want.cpu(), "equal": torch.equal(act.full(got), want),
                     "plain_counts": plain_counts, "counts": launch_counts(),
                     "plain_ms": plain_ms, "mesh_ms": mesh_ms}
        del plain, model, want, got
    return out


def mesh_gloo_rank(rank: int, device, seed: int) -> dict:
    """Phase 9c on one of two gloo ranks sharing the card: qwen3-0.6b's
    prefill on a (1, 2) and a (2, 1) mesh (each rank's local shard of the
    logits comes back), then one AdamW step on (2, 1) against the
    one-process step in the same rank (MESH_GLOO_RULES)."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import params as pr
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.sharding import activations as act
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.trainer import clone_tree

    cfg = get_config(LM_ARCH)
    plain, toks = _mesh_inputs(cfg, seed, MESH_BATCH, MESH_SEQ)
    batch = {"tokens": toks[:, :-1]}
    out: dict = {"prefill": {}}
    for shape, rules_name in MESH_GLOO_RULES.items():
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
        model = build(cfg, act_axes=("data",), mesh=mesh).place_params(rules_name)
        model.load_params(plain.master_params(), device="cuda")
        model.prefill(batch, MESH_SEQ)
        reset_counts()
        (got, _), ms = _timed(lambda: model.prefill(batch, MESH_SEQ))
        out["prefill"][shape] = {"local": got.to_local().cpu(), "placements": str(got.placements),
                                 "ms": ms, "counts": launch_counts()}
        del model
    del plain

    # One AdamW step of a 2-layer qwen3 on (2, 1).
    cfg2 = dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS)
    plain, toks = _mesh_inputs(cfg2, seed + 1, TR_SMALL_BATCH, TR_SEQ)
    tb = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt = adamw(AdamWConfig(lr=TR_LR))
    p0 = plain.master_params()
    before = TrainState(p0, opt.init(p0))
    want_state, want_m = make_train_step(plain, opt)(clone_tree(before), tb)
    mesh = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
    model = build(cfg2, act_axes=("data",), mesh=mesh).place_params(MESH_GLOO_RULES[(2, 1)])
    pm = model.distribute_params(plain.master_params())
    reset_counts()
    (state, m), step_ms = _timed(lambda: make_train_step(model, opt)(
        TrainState(pm, opt.init(pm)), tb))

    def full_tree(tree):
        return pr.unflatten((path, act.full(t)) for path, t in pr.flatten(tree))

    def clipped(st):   # the first step's m = (1 - b1) g_clipped
        return {p: m / (1 - AdamWConfig.b1) for p, m in pr.flatten(st.opt.m)}

    def update(st):
        return {p: w - w0 for (p, w), (_, w0) in zip(pr.flatten(st.params),
                                                     pr.flatten(before.params))}

    got_state = TrainState(full_tree(state.params), type(state.opt)(
        act.full(state.opt.step), full_tree(state.opt.m), full_tree(state.opt.v)))
    g_got, g_want = clipped(got_state), clipped(want_state)
    u_got, u_want = update(got_state), update(want_state)
    flips = {}
    for path, gw in g_want.items():
        settled = gw.abs() > TRAIN_MICRO_REL * gw.abs().max()
        du = (u_got[path] - u_want[path]).abs()
        flips[".".join(path)] = (float(du.max()),
                                 float(du[settled].max() / u_want[path].abs().max())
                                 if settled.any() else 0.0,
                                 float((du > MESH_FLIP / 2).float().mean()))
    out["train"] = {
        "loss": (float(act.full(m["loss"])), float(want_m["loss"])), "ms": step_ms,
        "counts": launch_counts(),
        "grad_gaps": grad_gaps(pr.unflatten(g_got.items()), pr.unflatten(g_want.items())),
        "update": flips}
    return out


def mesh_phase(gen, smi: str) -> dict[str, int]:
    """Phase 9. Returns K5's and K6's launches in the mesh runs (per rank,
    summed over the ranks)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    dry_procs = start_dryrun()
    atexit.register(lambda: [p.kill() for p in dry_procs.values() if p.poll() is None])
    launches = {"flash_attention": 0, "ssd_chunks": 0}

    # K5 at the (1, 2) mesh's per-rank shape (8 of 16 q heads over 4 of 8
    # KV heads), which no other phase checks element by element.
    row = flash_row(gen, MESH_BATCH, MESH_SEQ, 8, 4, 128, torch.bfloat16, True)
    print_kernel_rows({f"{row.pop('name')} (the (1, 2) mesh's local shard)": row})

    # b. One nccl rank, a (1, 1) mesh.
    (one,) = mesh_lib.spawn_world(mesh_nccl_rank, 1, backend="nccl", device="cuda",
                                  args=(MESH_SEED,), timeout_s=900.0).check()
    for name, kernel in (("qwen3", "flash_attention"), ("zamba2", "ssd_chunks")):
        r = one[name]
        print(f"mesh b ({name}, one nccl rank, (1, 1) mesh): prefill {MESH_BATCH} x {MESH_SEQ} "
              f"{r['mesh_ms']:.1f} ms on the mesh against {r['plain_ms']:.1f} ms unsharded; "
              f"logits {'bit-equal' if r['equal'] else 'DIFFERENT'}; launches mesh "
              f"{r['counts']}, unsharded {r['plain_counts']}; card {smi}")
        if not r["equal"]:
            fail(f"mesh b: the (1, 1) mesh's {name} logits differ from the unsharded ones")
        if r["counts"][kernel] != r["plain_counts"][kernel] or r["counts"][kernel] == 0:
            fail(f"mesh b: {kernel} launched {r['counts'][kernel]} times on the mesh, "
                 f"{r['plain_counts'][kernel]} unsharded")
        launches[kernel] += r["counts"][kernel]

    # c. Two gloo ranks on cuda:0.
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn_world(mesh_gloo_rank, 2, backend="gloo", device="cuda",
                                 args=(MESH_SEED,), timeout_s=900.0).check()
    print(f"mesh c: a world of two gloo ranks on cuda:0 in {time.perf_counter() - t0:.1f} s")
    want = one["qwen3"]["logits"]
    for shape, rules_name in MESH_GLOO_RULES.items():
        # (1, 2): the vocabulary split over 'model'; (2, 1): the rows over 'data'.
        got = torch.cat([res["prefill"][shape]["local"] for res in ranks],
                        dim=2 if shape == (1, 2) else 0)
        gap = float((got - want).abs().max())
        for rank, res in enumerate(ranks):
            r = res["prefill"][shape]
            k5 = r["counts"]["flash_attention"]
            print(f"mesh c: rank {rank}, {shape} mesh ({rules_name} rules): prefill "
                  f"{r['ms']:.1f} ms, logits {r['placements']} local {tuple(r['local'].shape)}, "
                  f"K5 launches {k5}; card {smi}")
            if k5 != 28:
                fail(f"mesh c: K5 launched {k5} times on rank {rank}'s {shape} prefill")
            launches["flash_attention"] += k5
        print(f"mesh c: {shape} mesh: the ranks' logits within {gap:.4f} of the (1, 1) "
              f"mesh's (tol {LM_LOGIT_TOL})")
        if not gap <= LM_LOGIT_TOL:
            fail(f"mesh c: {shape} logits differ by {gap}")
    for rank, res in enumerate(ranks):
        tr = res["train"]
        got, want = tr["loss"]
        print(f"mesh c: rank {rank}, {MESH_GLOO_RULES[(2, 1)]} AdamW step on (2, 1) "
              f"({MESH_TRAIN_LAYERS} layers, batch "
              f"{TR_SMALL_BATCH} x {TR_SEQ}): {tr['ms']:.1f} ms, loss {got:.6f} against "
              f"{want:.6f} in one process (tol {bf16_ulp(want)}), launches {tr['counts']}")
        if not abs(got - want) <= bf16_ulp(want):
            fail(f"mesh c: the mesh step's loss {got} against {want}")
        if tr["counts"]["flash_attention"] or tr["counts"]["ssd_chunks"]:
            fail(f"mesh c: a kernel launched in the train step: {tr['counts']}")
        check_gaps(f"mesh c rank {rank} (clipped gradient, (2, 1) against one process)",
                   tr["grad_gaps"], TRAIN_MICRO_REL, None)
        upd = tr["update"]
        worst = max(upd.items(), key=lambda kv: kv[1][0])
        worst_settled = max(upd.items(), key=lambda kv: kv[1][1])
        print(f"mesh c rank {rank} (update): largest element gap {worst[1][0]:.4e} "
              f"({worst[0]}; tol {MESH_FLIP:.4e}, a flipped sign), largest gap where the sign "
              f"is settled {worst_settled[1][1]:.4e} of the leaf's update "
              f"({worst_settled[0]}; tol {TRAIN_MICRO_REL:.4g}); flipped share per leaf up to "
              f"{max(v[2] for v in upd.values()):.4e}")
        for key, (most, settled, _) in upd.items():
            if not most <= MESH_FLIP or not settled <= TRAIN_MICRO_REL:
                fail(f"mesh c: the update of {key} differs by {most} ({settled} where settled)")

    # a. The dry run.
    dryrun_records(dry_procs, smi)
    print(f"phase 9 (the mesh and dry-run tools): {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
        from repro_torch.serving import api
    except ImportError as exc:
        print(f"chip_smoke.py must run from a checkout of the repository: {exc}",
              file=sys.stderr)
        return 2

    # Phase 1: the card, and the kernel build.
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    build.load()
    print(f"built {build.library_path().name} from {len(build._sources())} sources "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in (build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    program = api.ScoringProgram.load(
        str(ROOT / "src/repro_torch/assets/seizure_program"), device="cuda"
    )
    print(f"program: proj {tuple(program.packed.proj.shape)}, cfg {program.cfg}")

    # Phase 2.
    rows = check_kernels(program, gen)

    # Phases 3-4 (cuSOLVER's first call initializes it: keep that out of
    # the timed engine runs).
    torch.linalg.eigh(torch.eye(8, device="cuda"))
    traffic = make_traffic(gen)
    launches = {"forest": 0, "wpd_level": 0, "gram": 0}
    default_runs = {}
    for overlap in (0, 2):
        prog = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                  program.cfg._replace(overlap=overlap))
        reset_counts()
        events, stats = drive(prog, traffic)
        counts = launch_counts()
        print(f"engine overlap={overlap}: steps {stats['steps']}, chunks scored "
              f"{stats['chunks']}, {stats['windows_per_s']:.1f} windows/s "
              f"({stats['seconds']:.2f} s), final alarms {stats['alarms']}, "
              f"launches {counts}")
        if stats["chunks"] != N_SESSIONS * CHUNKS_PER_SESSION:
            fail(f"scored {stats['chunks']} chunks, expected {N_SESSIONS * CHUNKS_PER_SESSION}")
        # Each step votes once (K1), runs one packet tree and one DWT (K2)
        # and one Gram per DWT scale (K3).
        per_step = {"forest": 1, "wpd_level": 2, "gram": 6}
        want = {k: n * stats["steps"] for k, n in per_step.items()}
        if {k: counts[k] for k in launches} != want:
            fail(f"kernel launches {counts} over {stats['steps']} steps, expected {want}")
        for k in launches:
            launches[k] += counts[k]
        reset_counts()
        with plain_versions():
            plain_events, plain_stats = drive(prog, traffic)
        if any(launch_counts().values()):
            fail("a kernel launched during the plain run")
        differing = compare_events(events, plain_events, prog, traffic)
        print(f"engine overlap={overlap} plain path: {plain_stats['windows_per_s']:.1f} "
              f"windows/s; events equal, {differing} window predictions differ "
              "(all at routing margin < 1e-3)")
        default_runs[overlap] = events, stats

    # Phase 4b.
    t0 = time.perf_counter()
    for phase_launches in (snapshot_phase(program, traffic),
                           reference_leg_phase(program, traffic, default_runs),
                           streaming_phase(program, traffic)):
        for k, n in phase_launches.items():
            launches[k] += n
    print(f"phase 4b (snapshot/restore, reference_kernels leg, streaming frontend): "
          f"{time.perf_counter() - t0:.1f} s")

    for stage, ms in stage_times(program, traffic).items():
        print(f"stage {stage}: {ms:.3f} ms")
    trace_step(program, traffic)
    engine_step_syncs(program, traffic)

    # Phase 6.
    hist_rows, fit_counts, phase6 = training_phase(gen, program)
    rows.update(hist_rows)
    launches = {k: launches.get(k, 0) + fit_counts[k] for k in fit_counts}

    # Phase 6c.
    t0 = time.perf_counter()
    for k, n in distributed_phase(phase6, smi).items():
        launches[k] += n
    print(f"phase 6c (distributed training): {time.perf_counter() - t0:.1f} s")
    fit_syncs(phase6)

    # Phase 6d.
    t0 = time.perf_counter()
    for k, n in mesh_engine_phase(program, traffic, default_runs, smi).items():
        launches[k] += n
    print(f"phase 6d (the engine across processes): {time.perf_counter() - t0:.1f} s")

    # Phase 7.
    flash_rows, launches["flash_attention"] = lm_phase(gen)
    rows.update(flash_rows)

    # Phase 7b.
    launches["flash_attention"] += lm_training_phase(smi)

    # Phase 7c.
    family_rows, k5_families = families_phase(gen, smi)
    rows.update(family_rows)
    launches["flash_attention"] += k5_families

    # Phase 8.
    ssd_rows, launches["ssd_chunks"] = hybrid_phase(gen)
    rows.update(ssd_rows)

    # Phase 9.
    for k, n in mesh_phase(gen, smi).items():
        launches[k] += n

    sources = {"forest": "forest.cu", "wpd_level": "wpd_level.cu", "gram": "gram.cu",
               "histogram": "histogram.cu", "flash_attention": "flash_attention.cu",
               "ssd_chunks": "ssd_chunks.cu"}
    replaces = {
        "forest": "src/repro/kernels/forest/kernel.py:73",
        "wpd_level": "src/repro/kernels/wpd/kernel.py:86",
        "gram": "src/repro/kernels/gram/kernel.py:66",
        "histogram": "src/repro/kernels/histogram/kernel.py:77",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:103",
        "ssd_chunks": "src/repro/kernels/ssd/kernel.py:74",
    }
    # K2's row: the step's packet tree, the larger of its two launches a step.
    main_rows = {"forest": "forest", "wpd_level": "wpd_tree/5760x2048 L4", "gram": "gram/1024x180",
                 "histogram": max((k for k in hist_rows if k.startswith("histogram/")),
                                  key=lambda k: int(k.split()[-1])),
                 "flash_attention": next(iter(flash_rows)), "ssd_chunks": next(iter(ssd_rows))}
    line = {"kernels": [
        {
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[k]}",
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": rows[r]["max_abs_err"], "ms": rows[r]["ms"],
            "plain_ms": rows[r]["plain_ms"], "bound_ms": rows[r]["bound_ms"],
            "bound_by": rows[r]["bound_by"], "library_ms": rows[r]["library_ms"],
        }
        for k, r in main_rows.items()
    ]}
    print(json.dumps(line))
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
