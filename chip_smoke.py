#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # S=1024 tenants, window 1024, dim 30

Phases, each printing its own lines; any failure raises and the script
exits non-zero without a result line:

1. device: name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels against their plain PyTorch versions at the serving shapes
   (wrapped ring heads, tie cases, strided views; ``pairwise_sq_dists``
   also at a k-NN fit's row block), with kernel, plain and library times
   (CUDA events) and each kernel's bound on this card, after a ``[sass]``
   line with the batch and read kernels' static instruction mix. The
   read kernels (``interval_sweep``, ``cp_knn_counts``) are held bitwise
   to their plain versions with ties at the serving shape and at the
   edges of their tiles (``SWEEP_EDGES``, ``COUNTS_EDGES``), and their
   branch-free square root to ``torch.sqrt`` over every float32. The
   fused ``stream_update`` kernels (eviction repair + insert, one launch
   a tick) are held bitwise to ``ref.stream_tick``, the plain
   composition (``drop_backfill`` then ``stream_update_fast``), on each
   main path's own wrapped state after its evicting ticks (phases 4 and 5:
   evicting with a gated lane, non-evicting, and a one-hot state full of
   ties), and timed there, the bound recounted from the tick's affected
   rows;
4. classification main path (k 15): ``ServingEngine.observe_many`` until
   every window is full plus more than one full window of evicting
   ticks, then ``predict``; every kernel of the path must have launched
   there; ``predict`` once more records the arguments it passes
   ``cp_knn_counts``, and the kernel == its plain version bitwise on
   them (timed there). A short grow-mode run follows; then exactness
   (eviction == refit, chunked == per-tick, bitwise; the chunk under
   ``set_sync_debug_mode("error")``, so a host synchronisation in a tick
   fails, and its peak-memory rise below S*w*w bytes) and validity (the
   non-drifted tenants' mean smoothed p-value is 1/2);
5. regression main path (k 7, the paper's Figure 4 settings): the same
   ticks through ``RegressionServingEngine.observe_many``, then two
   ``intervals`` calls at eps 0.1 (the first, then one in steady state);
   every kernel of the path must have launched there; ``interval_sweep``
   == its plain version bitwise on the arguments ``intervals`` passes it,
   as in phase 4. Then exactness
   (chunked == per-tick, with phase 4's synchronisation and memory
   checks; eviction == refit through ``state_view`` and the neighbour
   lists, bitwise) and validity (mean smoothed p-value 1/2, interval
   coverage >= 0.88 on fresh labelled points);
6. batch full CP (the paper's App. E settings at the top of its n-grid:
   n = 100,000 training points, dim 30, 2 labels, k 15, h 1, rho 1): the
   ``kde_rowsums`` kernel is checked and timed with phase 3's kernels;
   ``ConformalClassifier("kde").fit`` (one ``kde_rowsums`` launch) and
   two ``predict_pvalues`` over 100 points, the registry
   ``ConformalPredictor("kde")`` fit, observe (== refit, bitwise),
   pvalues and evict (== its own arithmetic, bitwise; of that point:
   within 4 ulp of a refit; of the oldest: the gap to a refit is a
   reading, held to 512 ulp), every other classifier (knn,
   simplified_knn, lssvm; ICP knn, kde, lssvm) with coverage >= 0.88 at
   eps 0.1 on 2,000 fresh points; then optimized == standard at n = 2048,
   m = 16;
7. LM conformal serving (qwen2-1.5b at full width, bf16, random weights
   from the seed): ``flash_attention`` against its plain version at the
   embedding pass's shape (B 256, S 512, H 12, Hkv 2, D 128, causal), at
   gemma3's local layer (D 256, window 512), in f32 with softcap 50
   non-causal, in f32 with Sq 16 < Skv 80, at small odd head dims, in
   bf16 with Sq 48 < Skv 300 (MHA, ragged tiles), in bf16 on the
   path without TMA (head dim 60; bases 2 bytes off 16), and at phase
   13's shapes: deepseek-v2's MLA prefill (B 8, S 512, H = Hkv = 128, D
   192, the scale passed), granite's MQA 48:1 and mixtral's window 4096
   at S 4608; at phase 14's: recurrentgemma's MQA 16:1 at D 256 where
   its 2048 window masks (S 4608), whisper's non-causal encoder (B 16, S
   1,500: a ragged last key tile) and its cross-attention at prefill (Sq
   64) and at a decode step (Sq 1) over 1,500 keys; the useful TFLOP/s at
   (a), at the MLA prefill and at whisper's encoder (with its bound and
   SDPA), the f32 body's time at (c), and the count of tensor-core
   instructions
   (``HGMMA``) in the bf16 kernel's SASS at D 128 and 192; then the
   launcher's functions: 256 calibration sequences of 512 tokens
   embedded and the OOD head fitted (k 7), 256 held-out sequences of the
   same stream scored (validity: share with p <= 0.1 at most 0.18, mean p
   in [0.40, 0.60]), 16 requests (8 of another seed's stream, 8 uniform
   tokens) prefilled by teacher-forced decode steps, 32 tokens generated
   and scored; every embedding pass launches the kernel once per layer;
   one more decode step at full width runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation).
   Then, in f32 at full width and 2 layers, the kernel route's embeddings
   == the plain route's (1e-5 of their RMS) and their OOD p-values equal
   outside flagged near-ties; decode == forward (1e-3); the bf16
   full-depth gap between the routes is printed;
8. the compact layout, the ring's bit-oracle: both engines with
   ``layout="ring"`` and ``layout="compact"`` at S tenants, window =
   capacity = 128 (k 15 / 7, 2 labels), 3 x 128 + 17 ticks past the
   seam, about 25 % of lanes gated off a tick, a fifth of the points
   duplicates of earlier ones (distance ties): p-values (NaN on the same
   lanes), every leaf after ``to_linear`` and ``predict`` / ``intervals``
   bitwise; the compact runs' ``stream_update`` launches (the kernel
   without eviction, one a tick) join the launch counts; then, on the
   compact path's own arguments at cap = n = 128, its kernels against
   their plain versions, bitwise: one more compact tick's
   ``stream_update`` launch (non-evicting, linear layout) ==
   ``ref.stream_tick``, and the reads' ``pairwise_sq_dists``,
   ``cp_knn_counts`` and ``interval_sweep`` == plain. Then 32 compact
   ticks at full width on a state filled by ring ticks and made linear,
   against 32 ring ticks on the same state: ms a tick and peak-memory
   rise of each, the two results bitwise;
9. the bootstrap measure (paper Section 6, Algorithm 3) at the paper's
   App. E settings (B 10, dim 30, 2 labels; depth 5, the package
   default): ``fit`` at n = 2,154 (a point of the paper's n-grid) and
   ``pvalues_optimized`` over 100 points, the state and p-values on the
   card == on the CPU bitwise, at least 64 trees fitted on the card ==
   the per-tree plain version on the CPU bitwise; coverage on 500 fresh
   points at eps 0.05 and 0.2 (>= 1 - eps - 0.07); 16 ticks of the
   registry predictor's ``observe`` + ``evict(0)``, each == ``rebuild``
   bitwise (state and 10 points' p-values); standard against optimized at
   n = 464 over 10 points (>= 5x); then ``launch.profile --measure
   bootstrap`` (forest calls and bytes to the card a point, busy share);
10. the registry's k-NN regression (paper Section 8.1) at n = 4,096
   (``make_regression``, 30 features, k 7): ``fit``, 16 ``observe``s,
   ``evict(i)`` at the head, a middle rank and the last rank, 100
   points' ``pvalues`` at a 64-label ``t_query`` and ``intervals`` at eps
   0.1 on 2,000 fresh points, each timed (host clock, synchronised);
   ``stream_update`` (reg), ``pairwise_sq_dists`` and ``interval_sweep``
   must have launched there. Then each evict's state == ``stream.
   from_fit`` on the remaining points (bitwise, arrival ids after the
   order-preserving relabelling), the intervals and p-values == ``core.
   regression``'s ``*_optimized`` on a refit of the window (bitwise, NaN
   as NaN), coverage >= 0.88, and ``icp_intervals``' coverage >= 0.88.
   Then the figures runner (``launch.figures``) at its smoke grid (n =
   100, 1,000, 10,000; 10 test points; every measure, Table 2 at n =
   1,000) with its optimized == standard checks; its kernel launches
   count under ``figures``;
11. the serving shell at the main path's width (S tenants, window =
   capacity W, dim 30, k 15 / 7, the launcher's drift traffic): (a) a
   plain and an instrumented engine (``MetricsRegistry``, ``Tracer`` on
   a temporary file) in turns over W + 128 ticks in 32-tick chunks, in
   both modes: p-values and every leaf bitwise, the drained tick counters
   == the numpy closed form, the trace valid, an instrumented chunk
   under sync debug mode "error" with its peak-memory rise below S*w*w
   bytes, chunk ms of both; (b) a ``TickGuard`` over 4 more chunks of
   chaos traffic (``FaultPlan.random`` over the lane-ticks, rate 1e-3,
   value faults, ``corrupt_traffic``) == an unguarded engine on the clean
   traffic with the hit lane-ticks gated off, bitwise, rejections by kind
   == the plan's, a chunk off the sweep under sync debug mode "error",
   chunk ms of both; (c) in each mode, the full state saved by an
   ``AsyncShardedSaver`` (4 blocks) while 32 ticks run, restored by
   ``SessionStore.restore_engine()`` on the card, 32 ticks and a read on
   both bitwise, with the state's bytes and the save and restore seconds
   and GB/s (free disk and host memory checked first); then, with that
   store, a poisoned lane quarantined by a guard and restored: the lane
   == the snapshot's, every other lane unchanged; (d) a ``Fleet`` of 64
   tenants (pools of 16, buckets 32 to 1024) admitted two ticks apart, 8
   retired and readmitted: 8 sampled tenants == dedicated one-lane
   engines bitwise, the migrations counted exactly, ticks/s; (e)
   ``launch.serve`` with ``--guard --snapshot-dir --faults 0
   --metrics-out --trace-out`` at 64 tenants over 1,100 ticks in both
   modes. The kernels of this path count under ``serving_shell``;
12. trace replay and load generation (``telemetry.{loadgen,replay}``) at
   the main path's width (S tenants, window = capacity W, dim 30, k 15 /
   7): (a) a steady trace of 2,176 ops (2,048 observes, 1,024 of them
   evicting; 128 reads of 4 points) in both modes at speedup inf: chunk
   None == chunk 32 == the engine driven directly with ``observe_many``
   on the same ticks, bitwise, with steps/s and the observe and read p50
   / p99, and the reads' kernels == plain on their own arguments (m 4);
   (b) the four workloads (steady, bursty, diurnal, zipf; 272 ops) on
   classification at speedup 1 and half (a)'s unchunked ops/s, SLO 25 ms:
   service and sojourn p50 / p99, queue depth, SLO-violation share
   (readings); bursty shed at depth 64, and at depth 8 (where it must shed
   or defer), == unshed at speedup inf, bitwise;
   (c) ``calibrate_engine`` at full width -> ``CostModel.fit`` ->
   ``suggest_chunk``, the trace at that chunk == (a), and its steps/s
   against chunk 32; (d) duplicate and delay stamps (rate 1e-3): dedup ==
   the never-duplicated trace, bitwise; with value faults under
   ``guard=True``: rejections by kind == the stamps, no NaN in the state;
   (e) 4 per-shard engines on the card: concatenated state == (a) bitwise,
   merged counters == the unsharded, a shard's tick kernel == plain;
   (f) ``launch.serve --replay loadgen:bursty --auto-tune --shed-depth 64``
   at 64 tenants over 1,100 ops in a subprocess, its trace valid; (g)
   ``python -m repro_torch.analysis.audit --device cuda`` in a
   subprocess started beside (d), which times nothing, exit 0. The kernels
   of (a)-(e) count under ``replay``;
13. the MoE and MLA families at full width in bf16, the depth cut so the
   weights fit: deepseek-v2-236b (4 of 60 layers: the dense first layer
   and 3 MoE layers; MLA), mixtral-8x22b (6 of 56; top-2 of 8 experts,
   window 4096), granite-34b (24 of 88; MQA 48:1), each freed before the
   next, through the launcher's functions: 128 calibration sequences of
   512 tokens embedded in one pass and the OOD head fitted (k 7), 128
   held-out sequences of the same stream embedded in one pass of the same
   size (MoE capacity makes a token's output depend on its batch) and
   scored (share with p <= 0.1 at most 0.18, mean p in [0.40, 0.60]), 8
   requests of 512 tokens embedded and scored, then ``generate`` over
   their first 64 tokens and 8 more; ``flash_attention`` launches once
   per layer per pass and no other kernel does; three calibration passes
   bitwise equal (the MoE combine adds in a fixed order, no atomics); one
   decode step under ``set_sync_debug_mode("error")``. Then, in f32 at
   full width and 2 layers (the MoE lossless, capacity E/K), the kernel
   route's embeddings == the plain route's (1e-5 of their RMS) and decode
   == forward (1e-3) over (2, 64), on the sequences both runs route
   alike, each routing difference required to sit at a router near-tie
   (K-th and (K+1)-th probabilities within 1e-5). The kernel's launches
   count under ``families``;
14. the recurrent and front-end families at full width and full depth in
   bf16: recurrentgemma-9b (26 RG-LRU + 12 local-attention layers),
   xlstm-125m (10 mLSTM + 2 sLSTM), whisper-base (6 + 6 layers, 1,500
   frames) and internvl2-26b (48 layers, 256 patch positions), each freed
   before the next, through the launcher's functions as in phase 13
   (whisper's requests carry their frames, whose encoder pass fills the
   cross cache before the decode steps); validity, three passes bitwise
   equal, one decode step under ``set_sync_debug_mode("error")``;
   ``flash_attention`` once per attention layer per pass (and for whisper
   once for each encoder layer and each decoder layer at each decode
   step) and no other kernel. Then, in f32 at full width (recurrentgemma
   3 layers, so that its ``attn_local`` runs; xlstm 6, so that its
   ``slstm`` runs; whisper whole; internvl 2), the kernel route == the
   plain route within 1e-5 of the RMS on the embeddings, on internvl's
   ``hidden_forward`` with 256 patches prepended and on whisper's
   ``forward_encdec`` over 1,500 frames, and teacher-forced decode ==
   forward (``forward_encdec`` with the cross cache) within 1e-3 over (2,
   300): past one 256-step chunk of the RG-LRU scan and the mLSTM. The
   kernel's launches count under ``recurrent_frontends``;
15. training: (a) gradients through ``ops.flash_attention`` (the kernel
   forward, ``flash_attention_bwd`` backward) == autograd through the
   plain version within 1e-5 of the largest gradient (bf16: past 4 ulps
   of each element) at the training shape (B 8, S 512, H 12, Hkv 2, D
   128, causal, bf16), phase 7's f32 (c) and (d), gemma3's D 256 window
   512, the MLA prefill's D 192 with its scale and whisper's encoder; the
   backward's ms beside the kernel forward's, the plain version's and
   SDPA's forward + backward; (b) qwen2-1.5b at full width in bf16, its
   first ``TRAIN_LAYERS`` (7) of 28 layers (the smoke's time; 28 layers
   until PR 30), random weights from the seed, through the ``Trainer``:
   batch 8 x 512, 100 steps, warm-up 5, peak lr 3e-4, remat ``full``,
   checkpoints at steps 50 and 100: every loss finite, the last 10
   losses' mean at least 1.0 below the first 10's, ``flash_attention``
   launched twice a layer a step (the forward and the recompute) and no
   other kernel; step ms p50 / p90, tokens/s, peak GiB; step 50's
   checkpoint restored leaf by leaf == what was saved, bitwise; (c) in a
   subprocess under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_
   CONFIG=:4096:8``): whisper-base whole at full width (bf16) and
   mixtral-8x22b reduced, 6 steps straight against 4 and a restart to 6:
   the last two losses and every final leaf bitwise equal; what
   xlstm-125m (its mLSTM's float ``cumsum``) raises there is printed;
   (d) each other architecture reduced (f32), 3 steps on the card against
   the CPU from the same weights, the first loss within 1e-5 and the
   others within 1e-3 (relative). The
   kernel's launches of (b) and (d) count under ``train``;
16. the multi-device code (``core/distributed.py``): (a) both engines at
   the sliding-full shapes served by N = 2, 4, 8 tenant shards, logical
   on the card (``devices=[cuda:0] * N``; also min(4, cards) real cards
   where there are two or more), each form from one prefilled state
   (windows at W - 32) through 64 one-tick ``observe`` calls (the last
   32 evicting), ``predict`` / ``pvalues`` / ``intervals``: state,
   p-values and reads bitwise the one-device engine's,
   ``stream_update`` launched N times a tick, every shard's kernels ==
   plain on the arguments it passed them (S/N lanes a launch); tick p50
   / p99 by N and peak GiB as readings; (b) a 48-tenant ``Fleet`` at 4
   shards bitwise one device; (c) the row-sharded k-NN CP at n
   100,000 over 1, 2, 4, 8 row x 1, 2 query shards, bitwise across
   them, its count gap to the single-device path a reading, and
   ``ConformalLmClassifier.fit(mesh=(4, 2))`` at d 1,536, n 8,192
   bitwise mesh (2, 1); (d) ``launch.serve --shards 2`` refused on one
   card with the reference's message (served on two); (e) in a
   subprocess under ``use_deterministic_algorithms``, 3 qwen2-1.5b steps
   (full width and depth, bf16, 8 x 512) with remat "dots" bitwise those
   of "full" (losses and every final parameter), step ms and peak GiB of
   each. The launches of (a) and (b) count under ``sharded``;
17. the dry run (``launch.dryrun``, ``sharding/``, ``analysis.flops``):
   (a) ``--all --both-meshes`` in this process (the FLOP counts in
   ``DRYRUN_JOBS`` worker processes), every architecture x its shapes x
   the 16x16 and 2x16x16 meshes built on ``meta``: every cell ``ok`` or
   ``skipped``, the ``ok`` cells exactly the reference's grid, the time;
   (b) one qwen2-1.5b train step on the card at phase 15's shape (bf16, 8
   x 512, remat ``full``, a 1 x 1 mesh) under ``FlopCounter``: its FLOPs,
   transcendentals and products == the same step's count on ``meta``,
   exactly, with ``flash_attention`` launched twice a layer (the forward
   and the recompute), counted by its formula; (c) that step's counted
   argument bytes (the rules' placements on the 1 x 1 mesh) == the
   storage bytes of the parameters, optimizer state and batch the card
   holds. The launches of (b) count under ``dryrun``;
18. sharded training and the census (``launch.train --data-axis
   --model-axis``, ``sharding/``, ``analysis.census``): (a)
   ``flash_attention`` on every block ``(2|4, 1)`` and ``(1, 2|4)`` give
   qwen2's attention and the five other families' (mixtral's GQA 48:8
   window 4096, MLA at D 192, whisper's encoder and cross-attention,
   recurrentgemma's MQA window 2048) at full width, == the plain version
   on the global inputs; qwen2-1.5b through the launcher on ``(1, 1)``
   (losses bitwise the unsharded trainer's) and, where N >= 2 cards
   show, ``(N, 1)`` and ``(1, N)`` (their NCCL census == the fake
   group's); (b) the one-card qwen2 step's census on the card == its
   count on ``meta``; (c) every 16 x 16 cell of phase 17 (a) carries its
   census keys and equals the committed record (``launch/census_16x16.
   json``, made on the CPU build): collective bytes by kind and temp
   bytes exactly, ops and traffic but for ``dryrun.BUILD_DECOMPOSED``;
   (d) mixtral's and deepseek's MoE layers at full width,
   8 x 512 tokens in 4 dispatch groups on one card == each group alone,
   bitwise, forward and gradients, each group's dropped pairs printed;
   (e) mixtral (1 of 56 layers), recurrentgemma (6 of 38), xlstm (6 of
   12) and whisper at full width through the launcher on ``(1, 1)`` for
   2 steps, bitwise the unsharded trainer's; mixtral's unsharded run
   also in G = N dispatch groups (4 on one card), both runs' dropped
   pairs printed; where cards show, ``(N, 1)`` / ``(1, N)`` within
   ``SHARD_LOSS_RTOL`` of the unsharded run that dispatches alike
   (mixtral's ``(N, 1)``: G = N). Launches count under
   ``sharded_train``, the comparisons' excepted.

The last lines are the card's ``nvidia-smi`` line, one JSON object with
the kernel table, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from contextlib import contextmanager, nullcontext
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DIM, K, QUERIES, N_LABELS = 30, 15, 100, 2  # paper App. E widths
K_REG, EPS = 7, 0.1  # paper Figure 4 (benchmarks/fig4_regression.py)
N_BATCH, N_VALID, H_KDE, RHO = 100_000, 2000, 1.0, 1.0  # paper App. E
N_CHECK = 8192  # kde_rowsums against its plain version at n = m = N_CHECK
# registry kde evict(0) against a refit at n = N_BATCH: 209 ulp measured on
# an H100 (the data are fixed by SEED); the limit leaves 2.4x room
EVICT0_ULP = 512
CHUNK = 32  # ticks per observe_many call
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# phase 7: qwen2-1.5b (the JAX launcher's default arch) at full width
LM_ARCH, LM_REDUCED = "qwen2-1.5b", False
LM_CALIB, LM_SEQ, LM_REQUESTS, LM_GEN, LM_K = 256, 512, 16, 32, 7
LM_CHECK_LAYERS, LM_DECODE_CHECK = 2, (2, 64)  # f32 checks: depth, (B, S)
# phase 8: ring == compact at window = capacity = COMPACT_W, past the seam
COMPACT_W = 128
COMPACT_T = 3 * COMPACT_W + 17
# phase 9: the paper's App. E bootstrap settings; n on its grid
# numpy.logspace(1, 5, 13) (2,154 and 464); depth the package default
BOOT_N, BOOT_B, BOOT_DEPTH, BOOT_M, BOOT_COVER = 2154, 10, 5, 100, 500
BOOT_TICKS, BOOT_N_STD, BOOT_M_STD = 16, 464, 10
# phase 10: the registry's knn_regression; then the figures' smoke grid
REG_N, REG_OBS, REG_FRESH, REG_TQ = 4096, 16, 2000, 64
FLASH_CASES = [  # name, dtype, B, Sq, Skv, H, Hkv, D, causal, window, softcap
    ("a", torch.bfloat16, 256, 512, 512, 12, 2, 128, True, None, None),
    ("b", torch.bfloat16, 4, 2048, 2048, 4, 1, 256, True, 512, None),
    ("c", torch.float32, 2, 1024, 1024, 8, 4, 64, False, None, 50.0),
    ("d", torch.float32, 2, 16, 80, 4, 2, 128, True, None, None),
    ("e", torch.float32, 3, 100, 100, 4, 2, 16, True, 5, None),  # --reduced
    ("f", torch.bfloat16, 2, 130, 130, 6, 3, 72, True, None, 30.0),
    ("g", torch.bfloat16, 2, 48, 300, 8, 8, 64, True, None, None),
    # bf16 without TMA (16-byte rows and bases): a head dim off a multiple
    # of 8, and (FLASH_OFF16) operands whose base is 2 bytes off 16
    ("h", torch.bfloat16, 2, 100, 100, 4, 2, 60, True, None, None),
    ("i", torch.bfloat16, 2, 130, 130, 6, 3, 64, True, None, 30.0),
    # the families of phase 13: deepseek-v2's MLA prefill (head dim 128 +
    # 64, v padded to it, MHA, the scale passed explicitly; NC = 3), then
    # granite-34b's MQA 48:1, then mixtral's 4096 window where it masks
    ("j", torch.bfloat16, 8, 512, 512, 128, 128, 192, True, None, None),
    ("k", torch.bfloat16, 4, 512, 512, 48, 1, 128, True, None, None),
    ("l", torch.bfloat16, 1, 4608, 4608, 48, 8, 128, True, 4096, None),
    # the families of phase 14: recurrentgemma's local layer, MQA 16:1 at
    # D 256 where its 2048 window masks; whisper's encoder (1,500 frames:
    # 23 key tiles of 64 and 28), and its cross-attention at prefill and at
    # a decode step (Sq 1), all bf16 and non-causal but the first
    ("m", torch.bfloat16, 1, 4608, 4608, 16, 1, 256, True, 2048, None),
    ("n", torch.bfloat16, 16, 1500, 1500, 8, 8, 64, False, None, None),
    ("o", torch.bfloat16, 16, 64, 1500, 8, 8, 64, False, None, None),
    ("p", torch.bfloat16, 16, 1, 1500, 8, 8, 64, False, None, None),
]
FLASH_OFF16 = ("i",)
FLASH_SCALE = {"j": 192 ** -0.5}  # passed as MLA passes it
FLASH_MLA = "j"  # timed beside (a)
FLASH_ENC = "n"  # whisper's encoder, timed beside (a)
FLASH_READ = ("m", "o", "p")  # phase 14's other shapes: the kernel's time
BIG = 1e30


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def ring_inputs(g, S, cap, p, k):
    dev = "cuda"
    X = torch.randn((S, cap, p), generator=g, device=dev)
    y = torch.randint(0, 2, (S, cap), generator=g, device=dev,
                      dtype=torch.int32)
    L = torch.sort(3.0 + 6.0 * torch.rand((S, cap, k), generator=g,
                                          device=dev), -1).values
    short = torch.rand((S, cap), generator=g, device=dev) < 0.1
    L[..., k // 2:] = torch.where(short[..., None], BIG, L[..., k // 2:])
    x_new = torch.randn((S, p), generator=g, device=dev)
    y_new = torch.randint(0, 2, (S,), generator=g, device=dev,
                          dtype=torch.int32)
    head = torch.randint(1, cap, (S,), generator=g, device=dev,
                         dtype=torch.int32)
    n = torch.randint(cap // 2, cap + 1, (S,), generator=g, device=dev,
                      dtype=torch.int32)
    wrap = torch.full((S,), cap, dtype=torch.int32, device=dev)
    return X, y, L, x_new, y_new, n, head, wrap


def check_stream_update(g, S, cap, p, k, iters):
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_update import stream_update

    X, y, L, x_new, y_new, n, head, wrap = ring_inputs(g, S, cap, p, k)
    check(bool((head + n > cap).any()), "ring heads wrapped")
    kern = lambda: stream_update(X, y, L, None, x_new, y_new, n,  # noqa
                                 mode="class", head=head, wrap=wrap)
    plain = lambda: ref.stream_update_fast(X, y, L, None, x_new,  # noqa
                                           y_new, n, mode="class",
                                           head=head, wrap=wrap)
    dk, Lk, _, _, bk = kern()
    dp, Lp, _ = plain()
    torch.cuda.synchronize()
    err = 0.0
    for a, b, name in ((dk, dp, "d_row"), (Lk, Lp, "lists")):
        check(torch.equal(a >= BIG, b >= BIG), f"stream_update {name} BIG")
        fin = b < BIG
        check(torch.allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5),
              f"stream_update {name} within 1e-5")
        err = max(err, float((a[fin] - b[fin]).abs().max()))
    # the label gate: exactly the same rows admitted the candidate
    check(torch.equal((Lk != L).any(-1), (Lp != L).any(-1)),
          "stream_update label gating")
    check(torch.equal(bk, ref.fsum(L[..., :-1])), "stream_update list sum")
    bitwise = torch.equal(dk, dp) and torch.equal(Lk, Lp)

    # the exact tie case (one-hot rows at distance 1.0, lists holding 1.0)
    cap_t, p_t, k_t = 16, 8, 3
    Xt = torch.eye(cap_t, p_t, device="cuda").expand(2, cap_t, p_t)
    Lt = torch.tensor([0.5, 1.0, 1.0], device="cuda").repeat(2, cap_t, 1)
    Lt[:, 5] = torch.tensor([1.0, 1.0, 2.0])
    Lt[:, 6] = torch.tensor([0.25, 0.5, BIG])
    yt = torch.zeros((2, cap_t), dtype=torch.int32, device="cuda")
    yt[1, ::2] = 1  # tenant 1: only odd rows share the new label
    tie = [torch.zeros((2, p_t), device="cuda"),
           torch.zeros(2, dtype=torch.int32, device="cuda"),
           torch.full((2,), 12, dtype=torch.int32, device="cuda"),
           torch.tensor([0, 9], dtype=torch.int32, device="cuda"),
           torch.full((2,), cap_t, dtype=torch.int32, device="cuda")]
    kt = stream_update(Xt.contiguous(), yt, Lt, None, *tie[:3],
                       mode="class", head=tie[3], wrap=tie[4])
    pt = ref.stream_update(Xt, yt, Lt, None, *tie[:3], mode="class",
                           head=tie[3], wrap=tie[4])
    check(torch.equal(kt[0], pt[0]) and torch.equal(kt[1], pt[1]),
          "stream_update tie case exact")

    # tenant-strided ring-block views of a larger padded state
    Xb, yb, Lb = (t.repeat_interleave(2, dim=1) for t in (X[:8], y[:8],
                                                           L[:8]))
    ks = stream_update(Xb[:, :cap], yb[:, :cap], Lb[:, :cap], None,
                       x_new[:8], y_new[:8], n[:8], mode="class",
                       head=head[:8], wrap=wrap[:8])
    ps = ref.stream_update_fast(Xb[:, :cap], yb[:, :cap], Lb[:, :cap], None,
                                x_new[:8], y_new[:8], n[:8], mode="class",
                                head=head[:8], wrap=wrap[:8])
    check(torch.equal(ks[0], ps[0]) and torch.equal(ks[1], ps[1]),
          "stream_update strided views")

    ms, plain_ms = cuda_ms(kern, iters), cuda_ms(plain, max(iters // 10, 3))
    # X, y, the lists read; d, the merged lists, their sum written
    nbytes = S * cap * (4 * p + 4 + 8 * k + 8) + S * (4 * p + 16)
    b_ms, b_by = bound(nbytes, S * cap * (3 * p + 3 * k))
    print(f"[kernel] stream_update_class S={S} w={cap} p={p} k={k}: "
          f"max_abs_err {err:.3g} (bitwise {bitwise}), tie case exact; "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return dict(name="stream_update_class", route="cuda",
                source="src/repro_torch/kernels/csrc/stream_update.cu",
                replaces="src/repro/kernels/stream_update.py:112",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_pairwise(g, S, m, cap, p, iters):
    """``pairwise_sq_dists`` == ``ref.sq_dists`` bitwise, rows alone
    included, at the serving read's shape (S tenants, m queries, window
    cap) and at a k-NN fit's row block (``knn.BLOCK_ELEMS // N_BATCH`` rows
    against N_BATCH); both timed against ``torch.cdist`` (the yardstick).
    The JSON row is the serving shape's."""
    from repro_torch.core.measures.knn import BLOCK_ELEMS
    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_dist import pairwise_sq_dists

    torch.backends.cuda.matmul.allow_tf32 = False
    rows_knn = BLOCK_ELEMS // N_BATCH
    res = []
    for S_, m_, n_ in ((S, m, cap), (1, rows_knn, N_BATCH)):
        A = torch.randn((S_, m_, p), generator=g, device="cuda")
        B = torch.randn((S_, n_, p), generator=g, device="cuda")
        out = pairwise_sq_dists(A, B)
        want = ref.sq_dists(A, B)
        check(torch.equal(out, want), f"pairwise_sq_dists == plain, "
              f"bitwise, S={S_} m={m_} n={n_}")
        err = float((out - want).abs().max())
        del want
        for i in (0, m_ // 3, m_ - 1):  # row-decomposable, bitwise
            check(torch.equal(pairwise_sq_dists(A[:, i:i + 1], B),
                              out[:, i:i + 1]), f"row {i} alone")
        del out
        ms = cuda_ms(lambda: pairwise_sq_dists(A, B), iters)
        plain_ms = cuda_ms(lambda: ref.sq_dists(A, B), max(iters // 10, 3))
        lib_ms = cuda_ms(lambda: torch.cdist(A, B), iters)
        # each row's norm once (2p), then 2p + 3 an output: a.b and d2
        nbytes = 4 * S_ * (m_ * p + n_ * p + m_ * n_)
        b_ms, b_by = bound(nbytes, S_ * m_ * n_ * (2 * p + 3)
                           + 2 * p * S_ * (m_ + n_))
        print(f"[kernel] pairwise_sq_dists S={S_} m={m_} n={n_} p={p}: "
              f"bitwise == plain, rows alone bitwise; {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.cdist {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        res.append((err, ms, plain_ms, lib_ms, b_ms, b_by))
        del A, B
        torch.cuda.empty_cache()
    err, ms, plain_ms, lib_ms, b_ms, b_by = res[0]
    return dict(name="pairwise_sq_dists", route="cuda",
                source="src/repro_torch/kernels/csrc/pairwise_dist.cu",
                replaces="src/repro/kernels/pairwise_dist.py:45",
                max_abs_err=max(r[0] for r in res), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


# edge shapes of the read kernels' tiles (64 rows, 128 columns, 32-feature
# chunks, 4 labels a block): S, m, n, p, k or L, a query batch shared by
# every tenant (tenant stride 0)
SWEEP_EDGES = [(3, 1, 130, 5, 1, False), (3, 65, 1023, 37, 7, False),
               (3, 100, 1024, 30, 1, True), (3, 129, 130, 30, 3, False),
               (2, 100, 1023, 5, 7, True), (2, 129, 1024, 37, 1, False),
               (2, 65, 130, 30, 7, True)]
COUNTS_EDGES = [(3, 1, 130, 5, 1, False), (3, 65, 1023, 37, 16, False),
                (3, 100, 1024, 30, 2, True), (3, 129, 130, 30, 16, False),
                (2, 129, 1024, 5, 2, False), (2, 100, 1023, 37, 1, True),
                (2, 65, 130, 30, 3, False), (2, 100, 1024, 30, 5, False)]


def unit_scale(X, Xt, p):
    """Rows rescaled to dim 30's distances, so phase 3's k-th distances
    and alphas keep both branches alive at any p."""
    c = (DIM / p) ** 0.5
    return X * c, Xt * c


def counts_ties(args):
    """``cp_knn_counts`` operands with ties: 16 columns' k-th distance set
    to their realised distance to row 0 (the strict ``d < kth`` gate), and
    rows 1 and 2's alphas set to realised scores ``alpha_i`` (the ``>=`` of
    the counts): row 1's of column 3, row 2's of each label's nearest
    column (an updated score where it enters)."""
    from repro_torch.kernels import ref

    X, y, sums, kth, Xt, alpha = (t.clone() for t in args)
    S, n, L, m = X.shape[0], X.shape[1], alpha.shape[-1], Xt.shape[1]
    d = torch.sqrt(torch.clamp(ref.sq_dists(Xt[:, :3], X), min=0.0))
    cols = torch.arange(0, n, max(n // 16, 1), device=X.device)[:16]
    live = y[:, cols] >= 0
    kth[:, cols] = torch.where(live, d[:, 0, cols], kth[:, cols])
    labels = torch.arange(L, dtype=y.dtype, device=y.device)
    same = y[:, None, :] == labels[:, None]  # (S, L, n)
    for t in (1, 2):
        if t >= m:
            break
        upd = same & (d[:, t, None, :] < kth[:, None, :])
        a_i = torch.where(upd, ((sums - kth) + d[:, t])[:, None, :],
                          sums[:, None, :])  # (S, L, n)
        if t == 1:
            c = torch.full((S, L, 1), 3, device=X.device)
        else:
            c = torch.where(same, d[:, t, None, :], float("inf")).argmin(
                -1, keepdim=True)
        alpha[:, t] = a_i.gather(-1, c)[..., 0]
    return X, y, sums, kth, Xt, alpha


def check_cp_counts(g, S, m, cap, p, k, L, iters):
    """``cp_knn_counts`` == ``ref.cp_knn_counts`` bitwise (the counts
    exact) at the serving read's shape with ties, and at the tiles' edge
    shapes (``COUNTS_EDGES``: m, n, p and L around 64 rows, 128 columns,
    32 features and 4 labels a block; dead columns; shared queries), on
    inputs with ties; timed at the serving shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cp_update import cp_knn_counts
    from repro_torch.launch.profile import counts_inputs

    args = counts_ties(counts_inputs(g, S, m, cap, p, k, L))
    got = cp_knn_counts(*args, n_labels=L)
    want = ref.cp_knn_counts(*args)
    check(torch.equal(got, want), f"cp_knn_counts == plain, bitwise, "
          f"S={S} m={m} n={cap} p={p} L={L} with ties")
    lo, hi = int(want.min()), int(want.max())
    check(0 < hi and lo < cap, "counts span a useful range")
    for S_, m_, n_, p_, L_, shared in COUNTS_EDGES:
        X, y, sums, kth, Xt, alpha = counts_inputs(g, S_, m_, n_, p_, k, L_)
        X, Xt = unit_scale(X, Xt, p_)
        if shared:
            Xt = Xt[:1].expand(S_, m_, p_)
        e = counts_ties((X, y, sums, kth, Xt, alpha))
        if shared:  # the ties keep the tenant stride 0
            e = e[:4] + (Xt,) + e[5:]
        check(torch.equal(cp_knn_counts(*e, n_labels=L_),
                          ref.cp_knn_counts(*e)),
              f"cp_knn_counts == plain, bitwise, S={S_} m={m_} n={n_} "
              f"p={p_} L={L_} shared={shared}")
    ms = cuda_ms(lambda: cp_knn_counts(*args, n_labels=L), iters)
    plain_ms = cuda_ms(lambda: ref.cp_knn_counts(*args), max(iters // 10, 3))
    nbytes = 4 * S * (cap * p + 3 * cap + m * p + 2 * m * L)
    # each row's norm once (2p), then 2p + 7 + 3L a pair
    b_ms, b_by = bound(nbytes, S * m * cap * (2 * p + 7 + 3 * L)
                       + 2 * p * S * (m + cap))
    print(f"[kernel] cp_knn_counts S={S} m={m} n={cap} p={p} L={L}: "
          f"bitwise == plain with ties (counts in [{lo}, {hi}]) and at "
          f"{len(COUNTS_EDGES)} edge shapes; {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="cp_knn_counts", route="cuda",
                source="src/repro_torch/kernels/csrc/cp_update.cu",
                replaces="src/repro/kernels/cp_update.py:62",
                max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_stream_update_reg(g, S, cap, p, k, iters):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stream_update import stream_update

    X, _, L, x_new, _, n, head, wrap = ring_inputs(g, S, cap, p, k)
    dev = "cuda"
    y = torch.randn((S, cap), generator=g, device=dev)
    Y = torch.randn((S, cap, k), generator=g, device=dev)
    y_new = torch.randn((S,), generator=g, device=dev)
    # arrival ids as the tick carries them (grow mode and
    # regression.stream.observe run this non-evicting form)
    A = torch.randint(0, 2**31 - 1, (S, cap, k), generator=g, device=dev,
                      dtype=torch.int32)
    new_aid = torch.randint(0, 2**31 - 1, (S,), generator=g, device=dev,
                            dtype=torch.int32)
    check(bool((head + n > cap).any()), "ring heads wrapped")
    ids = dict(mode="reg", head=head, wrap=wrap, nbr_a=A, new_aid=new_aid)
    kern = lambda: stream_update(X, y, L, Y, x_new, y_new, n,  # noqa: E731
                                 **ids)
    plain = lambda: ref.stream_tick(  # noqa: E731
        X, y, L, Y, x_new, y_new, n, **ids)
    dk, Lk, Yk, Ak, sk = kern()
    dp, Lp, Yp, Ap, sp = plain()
    torch.cuda.synchronize()
    err = 0.0
    for a, b, name in ((dk, dp, "d_row"), (Lk, Lp, "lists")):
        check(torch.equal(a >= BIG, b >= BIG), f"stream_update_reg {name} "
              "BIG pattern")
        fin = b < BIG
        check(torch.allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5),
              f"stream_update_reg {name} within 1e-5")
        err = max(err, float((a[fin] - b[fin]).abs().max()))
    check(torch.equal(Yk, Yp), "stream_update_reg labels exact")
    check(torch.equal(Ak, Ap), "stream_update_reg arrival ids exact")
    check(torch.equal(sk, sp), "stream_update_reg label sum")
    admitted = int((Lk != L).any(-1).sum())
    check(admitted > 0, "the d < kth gate admitted some rows")
    bitwise = torch.equal(dk, dp) and torch.equal(Lk, Lp)

    # the tie case: one-hot rows at distance exactly 1.0 from the zero
    # query, lists holding 1.0 (the strict gate keeps the incumbent)
    cap_t, p_t, k_t = 16, 8, 3
    Xt = torch.eye(cap_t, p_t, device=dev).expand(2, cap_t, p_t)
    Lt = torch.tensor([0.5, 1.0, 1.0], device=dev).repeat(2, cap_t, 1)
    Lt[:, 5] = torch.tensor([1.0, 1.0, 2.0])
    Lt[:, 6] = torch.tensor([0.25, 0.5, BIG])
    Yt = torch.arange(2 * cap_t * k_t, dtype=torch.float32,
                      device=dev).view(2, cap_t, k_t)
    yt = torch.linspace(-1.0, 1.0, cap_t, device=dev).repeat(2, 1)
    tie = [torch.zeros((2, p_t), device=dev),
           torch.tensor([9.0, -9.0], device=dev),
           torch.full((2,), 12, dtype=torch.int32, device=dev),
           torch.tensor([0, 9], dtype=torch.int32, device=dev),
           torch.full((2,), cap_t, dtype=torch.int32, device=dev)]
    kt = ops.stream_update(Xt.contiguous(), yt, Lt, Yt, *tie[:3],
                           mode="reg", head=tie[3], wrap=tie[4])
    pt = ref.stream_update(Xt, yt, Lt, Yt, *tie[:3], mode="reg",
                           head=tie[3], wrap=tie[4])
    check(all(torch.equal(a, b) for a, b in zip(kt, pt)),
          "stream_update_reg tie case exact")

    # tenant-strided ring-block views of a larger padded state
    Xb, yb, Lb, Yb = (t.repeat_interleave(2, dim=1)
                      for t in (X[:8], y[:8], L[:8], Y[:8]))
    Ab = A[:8].repeat_interleave(2, dim=1)
    sub = dict(mode="reg", head=head[:8], wrap=wrap[:8], nbr_a=Ab[:, :cap],
               new_aid=new_aid[:8])
    ks = stream_update(Xb[:, :cap], yb[:, :cap], Lb[:, :cap], Yb[:, :cap],
                       x_new[:8], y_new[:8], n[:8], **sub)
    ps = ref.stream_tick(Xb[:, :cap], yb[:, :cap], Lb[:, :cap],
                         Yb[:, :cap], x_new[:8], y_new[:8], n[:8], **sub)
    check(all(torch.equal(a, b) for a, b in zip(ks, ps)),
          "stream_update_reg strided views")

    ms, plain_ms = cuda_ms(kern, iters), cuda_ms(plain, max(iters // 10, 3))
    # X, y, the three lists read; d, the three merged lists, the label
    # sum written
    nbytes = S * cap * (4 * p + 4 + 24 * k + 8) + S * (4 * p + 20)
    b_ms, b_by = bound(nbytes, S * cap * (6 * p + 3 * k + 4))
    print(f"[kernel] stream_update_reg S={S} w={cap} p={p} k={k}: "
          f"max_abs_err {err:.3g} (bitwise {bitwise}), labels and ids exact, "
          f"{admitted} rows admitted, tie case exact; {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="stream_update_reg", route="cuda",
                source="src/repro_torch/kernels/csrc/stream_update.cu",
                replaces="src/repro/kernels/stream_update.py:112",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def sweep_ties(args):
    """``interval_sweep`` operands with ties: 16 columns' k-th distance set
    to their realised distance to row 0 (the strict ``d < kth`` gate), and
    ``a_test`` +0 in row 1 and -0 in row 2."""
    from repro_torch.kernels import ref

    X, a_prime, kth, kth_label, live, Xt, a_test = (t.clone() for t in args)
    n, m = X.shape[1], Xt.shape[1]
    cols = torch.arange(0, n, max(n // 16, 1), device=X.device)[:16]
    d0 = torch.sqrt(torch.clamp(ref.sq_dists(Xt[:, :1], X[:, cols]),
                                min=0.0))
    kth[:, cols] = d0[:, 0]
    for t, z in ((1, 0.0), (2, -0.0)):
        if t < m:
            a_test[:, t] = z
    return X, a_prime, kth, kth_label, live, Xt, a_test


def check_sqd_sqrt() -> int:
    """The read kernels' branch-free square root (``sqd_sqrt`` of
    ``csrc/sqdist.cuh``) == ``torch.sqrt`` over every float32 bit pattern,
    NaN for NaN. Returns the number of patterns checked."""
    from repro_torch.kernels.interval_sweep import sqd_sqrt

    bad, step = 0, 1 << 28
    for lo in range(0, 1 << 32, step):
        x = torch.arange(lo, lo + step, dtype=torch.int64,
                         device="cuda").to(torch.int32).view(torch.float32)
        got, want = sqd_sqrt(x), torch.sqrt(x)
        bad += int(((got.view(torch.int32) != want.view(torch.int32))
                    & ~(got.isnan() & want.isnan())).sum())
        del x, got, want
    check(bad == 0, f"sqd_sqrt == torch.sqrt over every float32 ({bad} "
          "differ)")
    return 1 << 32


def check_interval_sweep(g, S, m, n, p, k, iters):
    """``interval_sweep`` == ``ref.reg_interval_endpoints`` bitwise (``lo``
    and ``hi``) at the serving read's shape with ties, and at the tiles'
    edge shapes (``SWEEP_EDGES``: m, n and p around 64 rows, 128 columns
    and 32 features a block; k 1, the linear branch; dead columns; shared
    queries), on inputs with ties; timed at the serving shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.interval_sweep import interval_sweep
    from repro_torch.launch.profile import sweep_inputs

    args = sweep_ties(sweep_inputs(g, S, m, n, p))
    X, _, kth, _, live, Xt, _ = args
    kern = lambda: interval_sweep(*args, k=k)  # noqa: E731
    plain = lambda: ref.reg_interval_endpoints(*args, k)  # noqa: E731
    got, want = kern(), plain()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"interval_sweep == plain, bitwise, S={S} m={m} n={n} p={p} "
          f"k={k} with ties")
    err = max(float((a[torch.isfinite(b)] - b[torch.isfinite(b)]).abs()
                    .max()) for a, b in zip(got, want))
    d = torch.sqrt(torch.clamp(ref.sq_dists(Xt, X), min=0.0))
    enters = int((live[:, None, :] & (d < kth[:, None, :])).sum())
    check(0 < enters < int(live.sum()) * m,
          "both branches of the update ran")
    del d, got, want
    for S_, m_, n_, p_, k_, shared in SWEEP_EDGES:
        X, a_prime, kth, kth_label, live, Xt, a_test = sweep_inputs(
            g, S_, m_, n_, p_)
        X, Xt = unit_scale(X, Xt, p_)
        if shared:  # a query batch shared by every tenant (stride 0)
            Xt = Xt[:1].expand(S_, m_, p_)
        e = sweep_ties((X, a_prime, kth, kth_label, live, Xt, a_test))
        if shared:  # the ties keep the tenant stride 0
            e = e[:5] + (Xt,) + e[6:]
        kg, pg = interval_sweep(*e, k=k_), ref.reg_interval_endpoints(*e, k_)
        check(torch.equal(kg[0], pg[0]) and torch.equal(kg[1], pg[1]),
              f"interval_sweep == plain, bitwise, S={S_} m={m_} n={n_} "
              f"p={p_} k={k_} shared={shared}")
    n_sqrt = check_sqd_sqrt()
    ms, plain_ms = cuda_ms(kern, iters), cuda_ms(plain, max(iters // 10, 3))
    nbytes = S * (4 * n * p + 13 * n + 4 * m * p + 4 * m) + 8 * S * m * n
    # each row's norm once (2p), then 2p + ~25 an output
    b_ms, b_by = bound(nbytes, S * m * n * (2 * p + 25)
                       + 2 * p * S * (m + n))
    print(f"[kernel] interval_sweep S={S} m={m} n={n} p={p} k={k}: bitwise "
          f"== plain with ties ({enters} entering cells) and at "
          f"{len(SWEEP_EDGES)} edge shapes; sqd_sqrt == torch.sqrt over "
          f"all {n_sqrt} float32 patterns; {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="interval_sweep", route="cuda",
                source="src/repro_torch/kernels/csrc/interval_sweep.cu",
                replaces="src/repro/kernels/interval_sweep.py:78",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def cloned(args):
    """``args`` (a tuple or a dict) with every tensor copied."""
    copy = lambda a: a.clone() if torch.is_tensor(a) else a  # noqa: E731
    if isinstance(args, dict):
        return {n: copy(a) for n, a in args.items()}
    return tuple(copy(a) for a in args)


class recorded:
    """Inside the block, ``ops.<name>`` (which the sessions look up at call
    time) records a copy of the arguments of its last call (``args``,
    ``kw``) and calls through: the exact arguments a read or a tick passes
    its kernel."""

    def __init__(self, name: str, every: bool = False):
        self.name, self.args, self.kw = name, None, None
        self.every, self.calls = every, []  # every: each call's copies

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops, self._kept = ops, getattr(ops, self.name)

        def record(*args, **kw):
            self.args, self.kw = cloned(args), cloned(kw)
            if self.every:
                self.calls.append((self.args, self.kw))
            return self._kept(*args, **kw)

        setattr(ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self._ops, self.name, self._kept)


def read_equals_plain(name, a):
    """``ops.<name>`` (a read kernel: ``sq_dists``, ``cp_knn_counts``,
    ``interval_sweep``) against its plain version on the arguments ``a``:
    ``(bitwise equal, kernel's output, plain output)``."""
    from repro_torch.kernels import ops, ref

    kern = getattr(ops, name)
    if name == "sq_dists":  # the pairwise_sq_dists kernel
        got, want = kern(*a), ref.sq_dists(*a)
        return torch.equal(got, want), got, want
    if name == "cp_knn_counts":
        got, want = kern(*a), ref.cp_knn_counts(*a[:6])
        return torch.equal(got, want), got, want
    got, want = kern(*a), ref.reg_interval_endpoints(*a)
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            got, want)


def check_read_kernel(name, read, iters):
    """The read ``read()`` once more, recording the arguments it passes
    ``ops.<name>``; the kernel == its plain version bitwise on them, and
    the kernel's time there (a reading). Returns a note for the path's
    line."""
    from repro_torch.kernels import ops, ref

    with recorded(name) as rec:
        read()
    a = rec.args
    kern = getattr(ops, name)
    ok, got, want = read_equals_plain(name, a)
    if name == "sq_dists":  # the pairwise_sq_dists kernel
        what = "the queries' squared distances to the window"
    elif name == "cp_knn_counts":
        what = f"counts in [{int(want.min())}, {int(want.max())}]"
    else:
        X, _, kth, _, live, Xt = a[:6]
        d = torch.sqrt(torch.clamp(ref.sq_dists(Xt, X), min=0.0))
        enters = (live[:, None, :] & (d < kth[:, None, :])).sum()
        what = (f"{float(enters) / (float(live.sum()) * Xt.shape[1]):.4%} "
                "of the live cells entering")
        del d
    label = "pairwise_sq_dists" if name == "sq_dists" else name
    check(ok, f"{label} == plain, bitwise, on the read's own arguments")
    ms = cuda_ms(lambda: kern(*a), iters)
    if name == "sq_dists":
        S, m, n = want.shape
    else:
        S, n, m = a[0].shape[0], a[0].shape[1], want[0].shape[-2]
    del got, want
    return (f"{label} == plain bitwise on the read's own arguments (S={S} "
            f"m={m} n={n}; {what}), {ms:.4f} ms there")


def check_kde_rowsums(g, X, y, iters):
    """``kde_rowsums`` == its plain version, bitwise: at n = m = N_CHECK (p
    30, L 2, diagonal excluded) at h = 1 (the divisor a power of two: the
    kernel multiplies) and h = 0.7 (it divides), with labels -1 and L among
    the columns and rows (the extra group), at p = 784 (L 10, App. G's
    MNIST widths on synthetic data), with m != n and no diagonal, in both
    layouts and both output forms (one target label per row; every label's
    sum, the read's form) at p = 30 and p = 784, and on 256 sampled rows of
    the full fit over ``X (N_BATCH, 30)``; the kernel's ``exp`` ==
    ``torch.exp``. Times the full fit, its bound recounted from the
    same-label pairs it visits, and the read's per-label form at m = 100
    and 2,000; the plain version at n = N_CHECK."""
    from repro_torch.core.online import fsum
    from repro_torch.kernels import ref
    from repro_torch.kernels.kde_score import kde_exp, kde_rowsums

    dev = "cuda"
    # the kernel's exp against torch.exp, over the arguments it sees (the
    # denormal range and the underflow to 0 included)
    args = -110.0 * torch.rand(1 << 22, generator=g, device=dev)
    args[:1024] = -torch.arange(1024, device=dev, dtype=torch.float32) / 8
    n_exp_diff = int((kde_exp(args) != torch.exp(args)).sum())
    check(n_exp_diff == 0, f"kernel exp == torch.exp ({n_exp_diff} differ)")

    def same(A, B, yA, yB, h, diag, what, n_labels, layout=None):
        got = kde_rowsums(A, B, yA, yB, h, diag, n_labels, layout=layout)
        want = ref.kde_rowsums(A, B, yA, yB, h, diag, n_labels)
        check(torch.equal(got, want), f"kde_rowsums == plain, {what}")
        check(bool((want > 0).any()), f"kde_rowsums {what}: sums not all 0")
        return float((got - want).abs().max())

    n8, L = N_CHECK, N_LABELS
    A, yA = X[:n8].contiguous(), y[:n8].contiguous()
    err = same(A, A, yA, yA, 1.0, True, f"n = m = {n8}, p = 30, L = 2, "
               "diag", L)
    err = max(err, same(A, A, yA, yA, 0.7, True, f"n = m = {n8}, h = 0.7, "
                        "diag", L))
    yO = torch.where(torch.arange(n8, device=dev) % 7 == 3, -1, yA)
    yO = torch.where(torch.arange(n8, device=dev) % 11 == 5, L, yO)
    yO = yO.to(torch.int32).contiguous()
    for h in (1.0, 0.7):
        err = max(err, same(A, A, yO, yO, h, True, f"n = m = {n8}, labels "
                            f"-1 and {L} outside [0, {L}), h = {h}", L))
    err = max(err, same(A, A, None, yO, 1.0, False, f"every label's sum, "
                        f"labels -1 and {L} among the columns", L))
    W = 0.05 * torch.randn((n8, 784), generator=g, device=dev)
    yW = torch.randint(0, 10, (n8,), generator=g, device=dev,
                       dtype=torch.int32)
    err = max(err, same(W, W, yW, yW, 1.0, True, f"n = {n8}, p = 784, "
                        "L = 10", 10))
    m3 = 3 * n8 // 8
    Xm, ym = X[n8:n8 + m3].contiguous(), y[n8:n8 + m3].contiguous()
    nb = n8 // 4
    for lay in ("grouped", "wide"):
        err = max(err, same(Xm, A, ym, yA, 1.0, False, f"{lay} layout, m = "
                            f"{m3} != n = {n8}, no diagonal", L, lay))
        err = max(err, same(Xm, A, None, yA, 1.0, False, f"{lay} layout, "
                            f"every label's sum, m = {m3}, n = {n8}", L,
                            lay))
        err = max(err, same(W, W[:nb], None, yW[:nb].contiguous(), 1.0,
                            False, f"{lay} layout, every label's sum, m = "
                            f"{n8}, n = {nb}, p = 784, L = 10", 10, lay))
        err = max(err, same(W, W[:nb], yW, yW[:nb].contiguous(), 1.0, False,
                            f"{lay} layout, m = {n8}, n = {nb}, p = 784",
                            10, lay))
    full = kde_rowsums(X, X, y, y, 1.0, True, L)
    rows = torch.randperm(X.shape[0], generator=g, device=dev)[:256]
    K = ref.kde_kvals(ref.sq_dists(X[rows], X), 1.0)
    keep = (y[rows, None] == y[None, :]) & (
        rows[:, None] != torch.arange(X.shape[0], device=dev)[None, :])
    want = fsum(torch.where(keep, K, 0.0))
    check(torch.equal(full[rows], want),
          "kde_rowsums == plain on 256 rows of the full fit")
    err = max(err, float((full[rows] - want).abs().max()))
    m = n = X.shape[0]
    ms = cuda_ms(lambda: kde_rowsums(X, X, y, y, 1.0, True, L), iters)
    plain_ms = cuda_ms(lambda: ref.kde_rowsums(A, A, yA, yA, 1.0, True), 1)
    read_ms = {}
    for mq in (100, 2000):  # the read's per-label form (wide layout)
        Q = X[:mq].contiguous()
        read_ms[mq] = cuda_ms(lambda: kde_rowsums(Q, X, None, y, 1.0,
                                                  n_labels=L), iters)
    # the bound counts the pairs the function needs (same label, j != i),
    # 2p + 5 a pair, and each row's norm once (2p)
    counts = torch.bincount(y.long(), minlength=L).double()
    pairs = int((counts * counts).sum()) - m
    nbytes = 4 * (m * DIM + n * DIM + m + n) + 4 * m
    norms = 2 * DIM * (m + n)
    b_ms, b_by = bound(nbytes, pairs * (2 * DIM + 5) + norms)
    all_ms, _ = bound(nbytes, m * n * (2 * DIM + 5) + norms)
    print(f"[kernel] kde_rowsums m=n={n} p={DIM} L={L} diag excluded:"
          f" bitwise == plain at ({n8}, 30) h 1 and 0.7, with labels -1 and "
          f"{L}, ({n8}, 784); at ({m3} x {n8}) and ({n8} x {nb}, 784) in "
          f"both layouts and both forms; on 256 rows of the full fit; "
          f"exp == torch.exp on {args.numel()} "
          f"arguments; {ms:.4f} ms, plain {plain_ms:.4f} ms at n = {n8}, "
          f"bound {b_ms:.4f} ms ({b_by}; {pairs} same-label pairs; "
          f"{all_ms:.4f} ms over all {m * n} pairs), library none; the "
          f"read's per-label form m=100 {read_ms[100]:.4f} ms, m=2000 "
          f"{read_ms[2000]:.4f} ms")
    return dict(name="kde_rowsums", route="cuda",
                source="src/repro_torch/kernels/csrc/kde_score.cu",
                replaces="src/repro/kernels/kde_score.py:52",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), full


# ---------------------------------------------------------------------------
# phase 3 on the main paths' states: the fused tick (repair + insert)
# ---------------------------------------------------------------------------


def tick_inputs(state, mode, W, x, y, act, evict=True):
    """The fused kernel's arguments for the tick ``session._sliding_step``
    runs on ``state`` with the next traffic ``x, y`` and lanes ``act``: the
    state's ring-block views, the window after the eviction, and fresh
    copies of the lists (the kernel repairs them in place). ``evict=False``
    is the non-evicting form on the same window."""
    from repro_torch.core.online import next_aid, ring_mod

    if mode == "class":
        n, lists = state.knn.n, (state.knn.best,)
        X, yv = state.knn.X[:, :W], state.knn.y[:, :W]
    else:
        n, lists = state.n, (state.nbr_d, state.nbr_y, state.nbr_a)
        X, yv = state.X[:, :W], state.y[:, :W]
    lists = [t[:, :W].clone() for t in lists]
    ev = act & (n >= W)
    s = ev.to(torch.int32) if evict else torch.zeros_like(n)
    head1 = ring_mod(state.head + s, state.wrap)
    n1 = n - s
    kw = dict(mode=mode, head=head1, wrap=state.wrap, D=state.D[:, :W, :W],
              ev=ev if evict else None)
    if mode == "reg":
        aid = state.aid[:, :W]
        kw.update(aid=aid, nbr_a=lists[2],
                  new_aid=next_aid(aid, head1, n1, state.wrap))
    args = (X, yv, lists[0], lists[1] if mode == "reg" else None, x, y, n1)
    return args, kw, lists


def affected_rows(args, kw):
    """``(affected rows, evicting tenants, tenants with affected rows)`` of
    the tick: what the repair reads of ``D`` beyond the evicted rows."""
    from repro_torch.core.online import ring_live

    X, yv, L, Y, x, y, n1 = args
    S, W = yv.shape
    ar = torch.arange(S, device=yv.device)
    hd = torch.where(kw["head"] == 0, kw["wrap"] - 1, kw["head"] - 1).long()
    es = kw["D"][ar, hd]
    aff = (kw["ev"][:, None] & ring_live(W, kw["head"], n1, kw["wrap"])
           & (es <= L[..., -1]))
    if kw["mode"] == "class":
        aff &= yv == yv.gather(1, hd[:, None])
    return (int(aff.sum()), int(kw["ev"].sum()),
            int(aff.any(-1).sum()))


def same_tick(state, mode, W, x, y, act, evict, what):
    """The kernel == ``ref.stream_tick`` (the plain composition:
    ``drop_backfill`` over every row of every tenant, then
    ``stream_update_fast`` and the id merge), every output and every
    repaired list bitwise. Returns the kernel's inputs (fresh lists) for
    timing."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_update import stream_update

    runs = []
    for fn in (stream_update, ref.stream_tick):
        args, kw, lists = tick_inputs(state, mode, W, x, y, act, evict)
        runs.append([t for t in (*fn(*args, **kw), *lists) if t is not None])
    torch.cuda.synchronize()
    check(len(runs[0]) == len(runs[1]) and all(
        torch.equal(a, b) for a, b in zip(*runs)),
        f"fused {mode} kernel == the plain composition bitwise ({what})")
    return tick_inputs(state, mode, W, x, y, act, evict)[:2]


def tie_state(mode, k, dev):
    """A small wrapped, gated state of one-hot points (distances 0, 1 and
    sqrt 2: ties at tprime everywhere), served through the kernels."""
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.serving import ServingEngine

    S, W, P, T = 16, 64, 8, 2 * 64 + 10
    rng = np.random.default_rng(SEED + 7)
    xs = np.eye(P + 1, P, dtype=np.float32)[rng.integers(0, P + 1, (T, S))]
    ys = (rng.integers(0, 2, (T, S)).astype(np.int32) if mode == "class"
          else rng.integers(0, 3, (T, S)).astype(np.float32))
    taus = rng.random((T, S), dtype=np.float32)
    active = rng.random((T, S)) < 0.8
    Eng = ServingEngine if mode == "class" else RegressionServingEngine
    eng = Eng(n_sessions=S, capacity=W, dim=P, k=k, window=W, device=dev)
    state, _ = eng.observe_many(eng.init_state(), xs[:-1], ys[:-1],
                                taus[:-1], active[:-1])
    return (state, W, *(torch.from_numpy(v[-1]).to(dev)
                        for v in (xs, ys, active)))


def check_fused_tick(row, state, mode, W, x, y, k, iters):
    """Phase 3's check of the fused kernel on a main path's own wrapped
    state after its evicting ticks (on copies of the lists): evicting with
    lane 0 gated, non-evicting, and a state full of ties; then the times
    of the evicting tick (kernel on fresh lists each launch; the plain
    composition) and the bound recounted from this tick's affected rows.
    Updates the kernel table's ``row``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_update import stream_update

    S = x.shape[0]
    act = torch.ones(S, dtype=torch.bool, device=x.device)
    act[0] = False
    args, kw = same_tick(state, mode, W, x, y, act, True,
                         "evicting, lane 0 gated")
    same_tick(state, mode, W, x, y, act, False, "non-evicting")
    tstate, tW, tx, ty, tact = tie_state(mode, k, x.device)
    same_tick(tstate, mode, tW, tx, ty, tact, True, "ties, evicting")
    n_aff, n_ev, t_aff = affected_rows(args, kw)
    check(n_aff > 0 and n_ev == S - 1, "rows repaired, lane 0 idle")

    def fresh(count):  # one set of lists per launch (repaired in place)
        return [tick_inputs(state, mode, W, x, y, act)[:2]
                for _ in range(count)]

    pool = fresh(iters + 2)
    ms = cuda_ms(lambda: stream_update(*pool[-1][0], **pool.pop()[1]),
                 iters)
    pool = fresh(5)
    plain_ms = cuda_ms(lambda: ref.stream_tick(*pool[-1][0], **pool.pop()[1]),
                       3)
    del pool
    p_dim = x.shape[1]
    nl = 1 if mode == "class" else 3  # lists: distances (, labels, ids)
    # X, y, the lists read and the merged ones written; d and the list
    # sum written; the evicted and the affected rows of D (and in
    # regression the ids of each tenant with an affected row; the labels
    # a classification scan compares are y, counted once); the repaired
    # rows written
    ids = t_aff * W if mode == "reg" else 0
    nbytes = 4 * (S * W * p_dim + S * W + 2 * nl * S * W * k + 2 * S * W
                  + n_ev * W + n_aff * W + ids + nl * n_aff * k
                  + S * p_dim) + 24 * S
    flops = (S * W * ((3 if mode == "class" else 6) * p_dim + 3 * k)
             + 6 * n_aff * W)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[kernel] {row['name']} fused tick S={S} w={W} k={k}: bitwise == "
          f"ref.stream_tick, the plain composition (drop_backfill + "
          f"stream_update_fast) on the main path's wrapped state (evicting with "
          f"lane 0 gated; non-evicting) and on a one-hot tie state; "
          f"{n_aff / max(n_ev, 1):.2f} affected rows per evicting tenant "
          f"({n_aff} of {n_ev * W}); evicting tick {ms:.4f} ms, plain "
          f"composition {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes / 1e6:.1f} MB); non-evicting form (phase 3) "
          f"{row['ms']:.4f} ms")
    row.update(no_evict_ms=row["ms"], no_evict_bound_ms=row["bound_ms"],
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               affected_per_tenant=n_aff / max(n_ev, 1))


# ---------------------------------------------------------------------------
# phases 4-5: the serving engines
# ---------------------------------------------------------------------------


def equal_states(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


def drive(eng, state, xs, ys, taus, T):
    """``T`` ticks in ``CHUNK``-tick ``observe_many`` calls, each timed
    with CUDA events. Returns ``(state, p (T, S) on the card, per-call
    (start, end, ticks) events)``."""
    pv, calls = [], []
    for c0 in range(0, T, CHUNK):
        c1 = min(c0 + CHUNK, T)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, p = eng.observe_many(state, xs[c0:c1], ys[c0:c1],
                                    taus[c0:c1])
        e1.record()
        pv.append(p)
        calls.append((e0, e1, c1 - c0))
    return state, torch.cat(pv), calls


def chunk_tick_ms(calls) -> np.ndarray:
    return np.array([a.elapsed_time(b) / t for a, b, t in calls])


def check_chunk_equals_ticks(eng, state, xs, ys, taus, t0):
    """One ``CHUNK``-tick ``observe_many`` == as many ``observe`` calls,
    p-values and every leaf bitwise. The chunk (its inputs already on the
    card) runs under ``torch.cuda.set_sync_debug_mode("error")``: a tick
    that synchronises with the host raises. Returns the chunk's rise in
    peak device memory, which must stay below one ``(S, w, w)`` bool
    tensor (no such temporary in a tick)."""
    a, b = state.clone(), state.clone()
    sl = slice(t0, t0 + CHUNK)
    S, W = state.D.shape[:2]
    chunk = [torch.from_numpy(np.ascontiguousarray(v[sl])).to(state.D.device)
             for v in (xs, ys, taus)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, pa = eng.observe_many(a, *chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    check(rise < S * W * W, f"a chunk's peak memory rise {rise} B is below "
          f"S*w*w = {S * W * W} B (no (S, w, w) temporary)")
    pb = []
    for t in range(t0, t0 + CHUNK):
        b, p = eng.observe(b, xs[t], ys[t], taus[t])
        pb.append(p)
    check(torch.equal(pa, torch.stack(pb)) and equal_states(a, b),
          "observe_many chunk == per-tick observe")
    return rise


def classification_path(S, W, row, iters):
    """Phase 4, with phase 3's check of the fused kernel on its state
    (updates ``row``). Returns the main path's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import class_drift_traffic
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import session as sm

    P, M, L = DIM, QUERIES, N_LABELS
    T_main = 2 * W + 2 * CHUNK  # head ends off the block start
    xs, ys, taus, drifted = class_drift_traffic(SEED, S,
                                                T_main + CHUNK, P, 2.0)
    eng = ServingEngine(n_sessions=S, capacity=W, dim=P, k=K, n_labels=L,
                        window=W, device="cuda")
    state = eng.init_state()
    rng = np.random.default_rng(SEED + 1)
    Xq = rng.standard_normal((S, M, P), dtype=np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, pv, calls = drive(eng, state, xs, ys, taus, T_main)
    pred = eng.predict(state, Xq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tick_ms = chunk_tick_ms(calls)
    print(f"[main] sliding S={S} window={W}: {T_main} ticks in "
          f"{len(calls)} observe_many calls + predict m={M}: "
          f"{S * T_main / wall:.1f} session-steps/s, chunk-mean tick p50 "
          f"{np.percentile(tick_ms, 50):.3f} ms p99 "
          f"{np.percentile(tick_ms, 99):.3f} ms (per-call CUDA events / "
          f"ticks), peak {peak / 2**30:.2f} GiB, launches {counts}")
    for name in ("stream_update_class", "pairwise_sq_dists",
                 "cp_knn_counts"):
        check(counts[name] > 0, f"{name} launched on the main path")
    check(int(state.knn.n.min()) == W and int(state.head.max()) > 0,
          "windows full and ring heads advanced")
    check(pred.shape == (S, M, L) and bool(torch.isfinite(pred).all())
          and bool(((pred > 0) & (pred <= 1)).all()), "predict p-values")
    pvals = pv.cpu().numpy()  # (T_main, S)
    check(np.isfinite(pvals).all(), "finite tick p-values")
    print("[main-read] " + check_read_kernel(
        "cp_knn_counts", lambda: eng.predict(state, Xq), iters))
    check_fused_tick(row, state, "class", W, torch.from_numpy(xs[T_main])
                     .cuda(), torch.from_numpy(ys[T_main]).cuda(), K, iters)
    torch.cuda.empty_cache()

    # ---- grow mode: capacity doubles under load ----------------------------
    geng = ServingEngine(n_sessions=S, capacity=64, dim=P, k=K, n_labels=L,
                         device="cuda")
    gstate = geng.init_state()
    ops.reset_launch_counts()
    for c0 in range(0, 8 * CHUNK, CHUNK):
        gstate, gp = geng.observe_many(gstate, xs[c0:c0 + CHUNK],
                                       ys[c0:c0 + CHUNK],
                                       taus[c0:c0 + CHUNK])
    check(geng.capacity >= 256, "grow mode doubled at least twice")
    if 8 * CHUNK <= W:  # the sliding engine has not evicted yet
        check(torch.equal(gp.cpu(), torch.from_numpy(
            pvals[7 * CHUNK:8 * CHUNK])),
            "grow engine p-values equal the sliding engine's")
    print(f"[grow] capacity 64 -> {geng.capacity} over {8 * CHUNK} "
          f"ticks, launches {ops.launch_counts()}")
    del geng, gstate
    torch.cuda.empty_cache()

    # ---- exactness, bitwise ------------------------------------------------
    rise = check_chunk_equals_ticks(eng, state, xs, ys, taus, T_main)
    torch.cuda.empty_cache()
    fresh = ServingEngine(n_sessions=S, capacity=W, dim=P, k=K, n_labels=L,
                          window=W, device="cuda")
    ref_state = fresh.init_state()
    for c0 in range(T_main - W, T_main, CHUNK):
        c1 = min(c0 + CHUNK, T_main)
        ref_state, _ = fresh.observe_many(ref_state, xs[c0:c1], ys[c0:c1],
                                          taus[c0:c1])
    check(equal_states(sm.to_linear(state), sm.to_linear(ref_state)),
          "eviction == refit after to_linear")
    print(f"[exact] chunk of {CHUNK} == per-tick; eviction == refit "
          f"over {S} tenants (bitwise); the chunk made no host "
          f"synchronisation and raised peak memory by {rise / 2**20:.1f} MiB "
          f"(S*w*w = {S * W * W / 2**20:.0f} MiB)")

    # ---- validity ---------------------------------------------------------
    mean_p = float(pvals[:, ~drifted].mean())
    n_p = pvals[:, ~drifted].size
    check(0.47 <= mean_p <= 0.53, f"mean smoothed p-value {mean_p}")
    print(f"[valid] mean smoothed p-value of the non-drifted tenants "
          f"{mean_p:.5f} over {n_p} p-values")
    return counts


def regression_path(S, W, row, iters):
    """Phase 5, with phase 3's check of the fused kernel on its state
    (updates ``row``). Returns the main path's launch counts."""
    from repro_torch.core import regression as reg
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (interval_coverage, reg_drift_traffic,
                                          reg_queries)
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.regression import stream as rs

    P, M, k = DIM, QUERIES, K_REG
    T_main = 2 * W + 2 * CHUNK
    xs, ys, taus, drifted, w = reg_drift_traffic(SEED, S, T_main + CHUNK, P,
                                                 2.0)
    eng = RegressionServingEngine(n_sessions=S, capacity=W, dim=P, k=k,
                                  window=W, device="cuda")
    state = eng.init_state()
    # fresh labelled points from every tenant's function at the end of
    # the stream (drifted tenants have shifted by then)
    Xq, yq = reg_queries(SEED + 1, w, M, np.where(drifted, 2.0, 0.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, pv, calls = drive(eng, state, xs, ys, taus, T_main)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    iv_ms = []
    for _ in range(2):  # the first call, then one in steady state
        h0 = time.perf_counter()
        iv = eng.intervals(state, Xq, epsilon=EPS)
        torch.cuda.synchronize()
        iv_ms.append((time.perf_counter() - h0) * 1e3)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tick_ms = chunk_tick_ms(calls)
    print(f"[reg-main] sliding S={S} window={W} k={k}: {T_main} ticks in "
          f"{len(calls)} observe_many calls + 2 intervals m={M}: "
          f"{S * T_main / (t1 - t0):.1f} session-steps/s (ticks only), "
          f"chunk-mean tick p50 {np.percentile(tick_ms, 50):.3f} ms p99 "
          f"{np.percentile(tick_ms, 99):.3f} ms (per-call CUDA events / "
          f"ticks), intervals first {iv_ms[0]:.3f} ms steady "
          f"{iv_ms[1]:.3f} ms (host clock, synchronised), wall "
          f"{wall:.1f} s, peak {peak / 2**30:.2f} GiB, launches {counts}")
    for name in ("stream_update_reg", "pairwise_sq_dists",
                 "interval_sweep"):
        check(counts[name] > 0, f"{name} launched on the main path")
    check(int(state.n.min()) == W and int(state.head.max()) > 0,
          "windows full and ring heads advanced")
    check(iv.shape == (S, M, 2), "intervals shape")
    pvals = pv.cpu().numpy()  # (T_main, S)
    check(np.isfinite(pvals).all(), "finite tick p-values")
    print("[reg-read] " + check_read_kernel(
        "interval_sweep", lambda: eng.intervals(state, Xq, epsilon=EPS),
        iters))
    check_fused_tick(row, state, "reg", W, torch.from_numpy(xs[T_main])
                     .cuda(), torch.from_numpy(ys[T_main]).cuda(), k, iters)
    torch.cuda.empty_cache()

    # ---- exactness, bitwise ------------------------------------------------
    rise = check_chunk_equals_ticks(eng, state, xs, ys, taus, T_main)
    torch.cuda.empty_cache()
    view = rs.state_view(state, k=k)
    lists = rs.arrival_view(state)
    for s0 in range(0, S, 128):  # refit the surviving windows, by block
        sl = slice(s0, min(s0 + 128, S))
        Xw = torch.from_numpy(np.ascontiguousarray(
            xs[T_main - W:T_main, sl].swapaxes(0, 1))).cuda()
        yw = torch.from_numpy(np.ascontiguousarray(
            ys[T_main - W:T_main, sl].T)).cuda()
        fit = reg.fit(Xw, yw, k=k)
        for name in ("X", "y", "a_prime", "kth_dist", "kth_label"):
            check(torch.equal(getattr(view, name)[sl], getattr(fit, name)),
                  f"state_view {name} == fit on the window")
        knn_d, knn_y = reg.fit_lists(Xw, yw, k=k)
        check(torch.equal(lists.nbr_d[sl], knn_d)
              and torch.equal(lists.nbr_y[sl], knn_y),
              "neighbour lists == fit's lists")
    del view, lists
    print(f"[reg-exact] chunk of {CHUNK} == per-tick; eviction == refit "
          f"(state_view and lists) over {S} tenants (bitwise); the chunk "
          f"made no host synchronisation and raised peak memory by "
          f"{rise / 2**20:.1f} MiB (S*w*w = {S * W * W / 2**20:.0f} MiB)")

    # ---- validity ---------------------------------------------------------
    mean_p = float(pvals[:, ~drifted].mean())
    check(0.47 <= mean_p <= 0.53, f"mean smoothed p-value {mean_p}")
    cov, width = interval_coverage(iv, yq)
    cov_nd = float(cov[~drifted].mean())
    check(cov_nd >= 0.88, f"interval coverage {cov_nd}")
    print(f"[reg-valid] non-drifted tenants: mean smoothed p-value "
          f"{mean_p:.5f} over {pvals[:, ~drifted].size} p-values; eps "
          f"{EPS} interval coverage {cov_nd:.4f} over "
          f"{int((~drifted).sum()) * M} fresh points (all tenants "
          f"{float(cov.mean()):.4f}), median width "
          f"{float(np.nanmedian(width)):.4f}, empty share "
          f"{float(np.isnan(width).mean()):.4f}")
    return counts


def timed_ms(fn):
    """``(result, ms)`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - h0) * 1e3


def batch_path(X, y, Xq, Xv, yv, prelim):
    """Phase 6. The paper's batch full-CP classifiers at n = N_BATCH.
    Returns the phase's launch counts."""
    from repro_torch.core import pvalues as pv
    from repro_torch.core.measures import kde as kde_m
    from repro_torch.core.predictor import (ConformalClassifier,
                                            InductiveConformalClassifier)
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.registry import ConformalPredictor

    n, L = X.shape[0], N_LABELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    clf = ConformalClassifier("kde", h=H_KDE, n_labels=L, device="cuda")
    _, fit_ms = timed_ms(lambda: clf.fit(X, y))
    fit_counts = ops.launch_counts()
    check(fit_counts["kde_rowsums"] == 1 and
          sum(fit_counts.values()) == 1, f"KDE fit: one kde_rowsums launch, "
          f"nothing else ({fit_counts})")
    check(torch.equal(clf._state.prelim, prelim),
          "KDE fit prelim == the kernel check's full fit")
    p1, pred_ms = timed_ms(lambda: clf.predict_pvalues(Xq))
    p2, pred2_ms = timed_ms(lambda: clf.predict_pvalues(Xq))
    pred_counts = {k: v - fit_counts[k] for k, v in
                   ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(p1, p2), "predict_pvalues deterministic")
    check(pred_counts["pairwise_sq_dists"] == 2
          and pred_counts["kde_rowsums"] == 2, "each predict: one pairwise "
          f"and one kde_rowsums launch ({pred_counts})")
    print(f"[batch] kde n={n} p={DIM} L={L} h={H_KDE}: fit {fit_ms:.3f} ms "
          f"(launches {fit_counts}), predict m={Xq.shape[0]} first "
          f"{pred_ms:.3f} ms steady {pred2_ms:.3f} ms (host clock, "
          f"synchronised), peak {peak / 2**30:.2f} GiB")

    # the registry predictor at n = N_BATCH, each operation timed: observe
    # == refit, bitwise; each evict == its own arithmetic, bitwise (the
    # same-label rows shed the removed point's plain kernel value), class
    # counts exact; evicting the point just observed lands within 4 ulp of
    # a refit's sums; evicting the oldest cannot match a refit in float32
    # (the removed value takes with it the small terms it had absorbed): its
    # gap is a reading, held to EVICT0_ULP
    cp = ConformalPredictor("kde", device="cuda", h=H_KDE, n_labels=L)
    _, cfit_ms = timed_ms(lambda: cp.fit(X, y))
    x_new, y_new = Xv[0], int(yv[0])
    _, obs_ms = timed_ms(lambda: cp.observe(x_new, y_new))
    X1 = torch.cat([X, x_new[None]])
    y1 = torch.cat([y, yv[:1]])
    refit = kde_m.fit(X1, y1, h=H_KDE, n_labels=L)
    check(all(torch.equal(a, b) for a, b in
              zip(cp._state.leaves(), refit.leaves())),
          "registry kde observe == refit, bitwise")
    _, cpv_ms = timed_ms(lambda: cp.pvalues(Xq))
    _, cpv2_ms = timed_ms(lambda: cp.pvalues(Xq))

    def evicted(st, i):
        """``prelim`` after removing point ``i``, in plain arithmetic."""
        kv = ref.kde_kvals(ref.sq_dists(st.X[i:i + 1], st.X), H_KDE)[0]
        pre = torch.where(st.y == st.y[i], st.prelim - kv, st.prelim)
        return torch.cat([pre[:i], pre[i + 1:]])

    def ulp_gap(before, after, want):
        ulp = torch.nextafter(before, torch.full_like(before, float("inf")))
        return (after - want).abs() / (ulp - before)

    before, want = cp._state.prelim[:n], evicted(cp._state, n)
    _, ev_ms = timed_ms(lambda: cp.evict(n))
    check(torch.equal(cp._state.prelim, want)
          and torch.equal(cp._state.class_counts, clf._state.class_counts),
          "registry kde evict(last) == its arithmetic, bitwise; counts exact")
    last = ulp_gap(before, cp._state.prelim, clf._state.prelim)
    check(bool((last <= 4).all()), "registry kde evict(last): prelim within "
          "4 ulp of a refit's sums")
    cp = ConformalPredictor("kde", device="cuda", h=H_KDE, n_labels=L)
    cp.fit(X, y).observe(x_new, y_new)
    before, want = cp._state.prelim[1:], evicted(cp._state, 0)
    _, ev0_ms = timed_ms(lambda: cp.evict(0))
    refit0 = kde_m.fit(X1[1:].contiguous(), y1[1:].contiguous(), h=H_KDE,
                       n_labels=L)
    check(torch.equal(cp._state.prelim, want)
          and torch.equal(cp._state.class_counts, refit0.class_counts),
          "registry kde evict(0) == its arithmetic, bitwise; counts exact")
    first = ulp_gap(before, cp._state.prelim, refit0.prelim)
    check(bool((first <= EVICT0_ULP).all()), f"registry kde evict(0): gap to "
          f"a refit {float(first.max())} ulp above {EVICT0_ULP}")
    print(f"[batch] registry kde at n={n}: fit {cfit_ms:.3f} ms, observe "
          f"{obs_ms:.3f} ms, pvalues m={Xq.shape[0]} first {cpv_ms:.3f} ms "
          f"steady {cpv2_ms:.3f} ms, evict(last) {ev_ms:.3f} ms, evict(0) "
          f"{ev0_ms:.3f} ms (host clock, synchronised); observe == refit "
          f"and both evicts == their arithmetic (bitwise), class counts "
          f"exact; evict(last) within {float(last.max()):.1f} ulp of a "
          f"refit (<= 4); evict(0) within {float(first.max()):.1f} ulp of a "
          f"refit (<= {EVICT0_ULP}; {int((first > 4).sum())} rows above 4, "
          f"{int((first > 0).sum())} not bitwise)")
    del cp, refit, refit0, X1, y1
    torch.cuda.empty_cache()

    # every classifier: fit, predict and coverage on fresh points
    clfs = [("kde", clf)]
    for measure in ("knn", "simplified_knn", "lssvm"):
        c = ConformalClassifier(measure, k=K, n_labels=L, rho=RHO,
                                device="cuda")
        _, f_ms = timed_ms(lambda: c.fit(X, y))
        _, p_ms = timed_ms(lambda: c.predict_pvalues(Xq))
        print(f"[batch] {measure} n={n}: fit {f_ms:.3f} ms, predict "
              f"m={Xq.shape[0]} {p_ms:.3f} ms")
        clfs.append((measure, c))
    for measure in ("knn", "kde", "lssvm"):
        c = InductiveConformalClassifier(measure, k=K, h=H_KDE, rho=RHO,
                                         n_labels=L, train_frac=0.5,
                                         device="cuda")
        _, f_ms = timed_ms(lambda: c.fit(X, y))
        _, p_ms = timed_ms(lambda: c.predict_pvalues(Xq))
        print(f"[batch] icp-{measure} n={n} t={n // 2}: fit {f_ms:.3f} ms, "
              f"predict m={Xq.shape[0]} {p_ms:.3f} ms")
        clfs.append(("icp-" + measure, c))
    covs = []
    for name, c in clfs:
        p = c.predict_pvalues(Xv)
        check(p.shape == (Xv.shape[0], L) and bool(((p > 0) & (p <= 1))
                                                    .all()), f"{name} p")
        cov, size = pv.coverage(p, yv, EPS)
        check(float(cov) >= 0.88, f"{name} coverage {float(cov)}")
        covs.append(f"{name} {float(cov):.4f} (set {float(size):.3f})")
        torch.cuda.empty_cache()
    print(f"[batch-valid] coverage at eps {EPS} on {Xv.shape[0]} fresh "
          "points (>= 0.88): " + ", ".join(covs))
    counts = ops.launch_counts()
    del clfs, clf
    torch.cuda.empty_cache()
    return counts


def batch_exactness(X, y, Xq):
    """Optimized == standard on the card at n = 2048, m = 16: KDE bitwise
    (p-values and every score), k-NN and simplified k-NN p-values equal,
    LS-SVM p-values equal outside flagged near-ties."""
    from repro_torch.core import pvalues as pv
    from repro_torch.core.measures import kde as kde_m
    from repro_torch.core.measures import knn as knn_m
    from repro_torch.core.measures import lssvm as lssvm_m

    n, m, L = 2048, 16, N_LABELS
    X, y, Xq = X[:n].contiguous(), y[:n].contiguous(), Xq[:m]
    st = kde_m.fit(X, y, h=H_KDE, n_labels=L)
    kw = dict(h=H_KDE, p_dim=DIM, n_labels=L)
    check(torch.equal(kde_m.pvalues_optimized(st, Xq, **kw),
                      kde_m.pvalues_standard(X, y, Xq, **kw)),
          "KDE optimized == standard p-values, bitwise")
    for t in range(m):
        for lbl in range(L):
            a = kde_m.scores_optimized(st, Xq[t], lbl, h=H_KDE, p_dim=DIM)
            b = kde_m.scores_standard(X, y, Xq[t], lbl, h=H_KDE, p_dim=DIM)
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  "KDE optimized == standard scores, bitwise")
    for simplified in (False, True):
        kw = dict(k=K, simplified=simplified, n_labels=L)
        check(torch.equal(
            knn_m.pvalues_optimized(knn_m.fit(X, y, k=K), Xq, **kw),
            knn_m.pvalues_standard(X, y, Xq, **kw)),
            f"k-NN (simplified={simplified}) optimized == standard")
    Y = 2.0 * y.float() - 1.0
    sl = lssvm_m.fit(X, Y, RHO)
    p_opt = lssvm_m.pvalues_optimized(sl, Xq)
    flagged = 0
    for t in range(m):
        for c, y_hat in enumerate((-1.0, 1.0)):
            a_s, al_s = lssvm_m.scores_standard(X, Y, Xq[t], y_hat, rho=RHO)
            a_o, al_o = lssvm_m.scores_optimized(sl, Xq[t], y_hat)
            tie = bool(((a_o - al_o).abs() <= 1e-4 * torch.maximum(
                a_o.abs(), al_o.abs()) + 1e-6).any())
            flagged += tie
            if not tie:
                check(float(pv.pvalue(a_s, al_s)) == float(p_opt[t, c]),
                      "LS-SVM optimized == standard outside near-ties")
    print(f"[batch-exact] n={n} m={m}: KDE optimized == standard (p-values "
          f"and scores, bitwise); knn and simplified_knn p-values equal; "
          f"lssvm p-values equal, {flagged} of {m * L} candidates flagged "
          "as near-ties")


# ---------------------------------------------------------------------------
# phase 7: LM conformal serving
# ---------------------------------------------------------------------------


def bf16_close(got, want):
    """bf16 outputs against the plain version: two f32 results within the
    f32 tolerance (1e-5), each rounded to bf16 once, differ by at most one
    bf16 ulp of the plain output plus 1e-5. Returns (every element within
    that, the share of elements more than one ulp apart). The 1e-5 matters
    only at outputs below the f32 rounding noise of their own sums (on an
    H100 an output of 1.5e-11 in the plain version came out 2.1e-8)."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    d = (got.float() - w).abs()
    return bool((d <= ulp + 1e-5).all()), float((d > ulp).float().mean())


def live_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head)."""
    pos = np.arange(Sq)[:, None] + (Skv - Sq)
    kp = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kp <= pos
    if window:
        keep &= kp > pos - window
    return int(keep.sum())


def ptxas_summary(log: str) -> list:
    """``name: registers, spill stores / loads`` of every entry function in
    nvcc's ``-Xptxas -v`` output (empty where the library was not built in
    this process)."""
    out = []
    for blk in log.split("Compiling entry function")[1:]:
        name = blk.split("'")[1]
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        out.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                   f"spills {'/'.join(spill.groups()) if spill else '?'}")
    return out


def tile_constants() -> str:
    """The register-tile constants of the batch kernels' sources."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    found = []
    for src, names in (("kde_score.cu", ("KS_R", "KS_C", "KS_T", "KS_KT")),
                       ("pairwise_dist.cu", ("PD_RM", "PD_RN", "PD_BM",
                                             "PD_BN"))):
        text = (csrc / src).read_text()
        for nm in names:
            mt = re.search(rf"#define {nm} ([^/\n]+)", text)
            found.append(f"{nm} {mt.group(1).strip() if mt else '?'}")
    return ", ".join(found)


SASS_OPS = ("FADD", "FMUL", "FFMA", "MUFU", "LDS", "LDG", "STG")
SASS_KERNELS = ("kde_group_kernel", "kde_rowsums_wide_kernel",
                "pairwise_sq_dists_kernel", "interval_sweep_kernel",
                "cp_knn_counts_kernel")  # the [sass] line


def sass_functions() -> dict:
    """``{function: [(address, opcode, branch target or None)]}`` of the
    built library, by ``cuobjdump -sass``; ``{}`` where the tool is
    absent."""
    from repro_torch.kernels import _build

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", _build.load()._name],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    funcs, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
            continue
        s = line.strip()
        if fn is None or not s.startswith("/*") or "*/" not in s:
            continue
        try:
            addr = int(s[2:s.index("*/")], 16)
        except ValueError:
            continue
        words = s.split("*/", 1)[1].split(";")[0].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words:
            continue
        op = words[0].split(".")[0]
        tgt = None
        if op == "BRA" and len(words) > 1 and words[-1].startswith("0x"):
            tgt = int(words[-1], 16)
        funcs[fn].append((addr, op, tgt))
    return funcs


def op_mix(ins) -> dict:
    """Counts of ``SASS_OPS`` and every other opcode (``other``)."""
    mix = dict.fromkeys(SASS_OPS + ("other",), 0)
    for _, op, _ in ins:
        mix[op if op in mix else "other"] += 1
    return mix


def inner_loops(ins) -> list:
    """The innermost loops (a backward branch whose range holds no other
    backward branch's range): ``[(first address, instructions)]``."""
    spans = sorted((t, a) for a, _, t in ins if t is not None and t < a)
    inner = [s for s in spans if not any(o != s and s[0] <= o[0]
                                         and o[1] <= s[1] for o in spans)]
    return [(lo, [i for i in ins if lo <= i[0] <= hi]) for lo, hi in inner]


def sass_counts(funcs: dict, kernels: tuple) -> str:
    """Static instruction mix of each kernel whose name holds one of
    ``kernels``: the whole function, then its two largest innermost loops
    (the hot loop bodies, as unrolled)."""
    if not funcs:
        return "cuobjdump absent: not measured"
    parts = []
    for fn, ins in sorted(funcs.items()):
        if not any(k in fn for k in kernels):
            continue
        txt = " ".join(f"{k} {v}" for k, v in op_mix(ins).items())
        loops = sorted(inner_loops(ins), key=lambda lp: -len(lp[1]))[:2]
        for lo, body in loops:
            txt += (f" | loop @{lo:#x} ({len(body)}): " + " ".join(
                f"{k} {v}" for k, v in op_mix(body).items() if v))
        parts.append(f"{fn}: {txt}")
    return "; ".join(parts)


def sass_mix() -> str:
    """Instruction mix of the attention kernels in the built library, by
    ``cuobjdump -sass``: tensor-core products (``HGMMA`` for wgmma, ``HMMA``
    for mma.sync) and f32 FMAs per kernel. The bf16 kernel at D 128
    (``fa_bf16_kernel<2>``, shape (a)'s) and at D 192
    (``fa_bf16_kernel<3>``, the MLA prefill's) must hold ``HGMMA``."""
    funcs = sass_functions()
    if not funcs:
        return "cuobjdump absent: not measured"
    mix = {}
    for fn, ins in funcs.items():
        if "fa_bf16_kernel" in fn or "flash_attention_kernel" in fn:
            ops = [op for _, op, _ in ins]
            mix[fn] = {k: ops.count(k) for k in ("HGMMA", "HMMA", "FFMA")}
    for nc, d in ((2, 128), (3, 192)):
        key = next((f for f in mix if f"fa_bf16_kernelILi{nc}E" in f), None)
        check(key is not None and mix[key]["HGMMA"] > 0,
              f"HGMMA in the bf16 attention kernel at D {d}: "
              f"{mix.get(key)}")
    return "; ".join(f"{f}: {c}" for f, c in sorted(mix.items()))


def time_flash(q, k, v, kw, iters):
    """``(ms, plain_ms, SDPA ms, bound ms, bound by, line)`` of a bf16
    call without a window: the kernel, its plain version and SDPA (the
    yardstick only) on the same operands, the bound from this call's live
    pairs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters)
    plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, **kw), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=kw["causal"],
                                  scale=kw["scale"], enable_gqa=True), iters)
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D)
    pairs = live_pairs(Sq, Skv, kw["causal"], kw["window"])
    flops = 4 * B * H * D * pairs
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    mode = "causal" if kw["causal"] else "non-causal"
    line = (f"B={B} S={Sq} H={H} Hkv={Hkv} D={D} {mode} bf16: {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} useful TFLOP/s), plain {plain_ms:.4f} "
            f"ms, SDPA {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} "
            f"TFLOP/s), bound {b_ms:.4f} ms ({b_by}; {pairs} live pairs per "
            "head)")
    return ms, plain_ms, lib_ms, b_ms, b_by, line


def check_flash_attention(g, iters, dev="cuda"):
    """``flash_attention`` == its plain version: f32 within 1e-5 (atol and
    rtol), bf16 within one bf16 ulp plus 1e-5 (``bf16_close``). Times shape (a), the embedding
    pass's, against the plain version and SDPA (the yardstick only)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    err, notes, timed, f32_ms, read_ms = 0.0, [], {}, float("nan"), {}
    for name, dt, B, Sq, Skv, H, Hkv, D, causal, window, cap in FLASH_CASES:
        q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dt)
        k = torch.randn((B, Skv, Hkv, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, Skv, Hkv, D), generator=g, device=dev).to(dt)
        if name in FLASH_OFF16:  # contiguous views one element into a buffer
            q, k, v = (torch.empty(t.numel() + 1, dtype=dt, device=dev)[1:]
                       .view(t.shape).copy_(t) for t in (q, k, v))
            check(all(t.data_ptr() % 16 == 2 for t in (q, k, v)),
                  f"flash ({name}) bases 2 bytes off 16")
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=FLASH_SCALE.get(name))
        got = flash_attention(q, k, v, **kw)
        want = ref.flash_attention(q, k, v, **kw)
        check(got.shape == want.shape and got.dtype == dt
              and bool(torch.isfinite(got).all()), f"flash ({name}) finite")
        diff = float((got.float() - want.float()).abs().max())
        if dt == torch.float32:
            check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
                  f"flash ({name}) f32 within 1e-5: {diff}")
            notes.append(f"({name}) f32 max_abs_err {diff:.3g}")
        else:
            ok, beyond = bf16_close(got, want)
            check(ok, f"flash ({name}) bf16 within one ulp + 1e-5")
            w = want.float()
            excess = max(0.0, float((got.float() - w).abs().sub_(
                torch.ldexp(torch.ones_like(w),
                            torch.frexp(w).exponent - 8)).max()))
            notes.append(f"({name}) bf16 max_abs_err {diff:.3g}, "
                         f"{float((got != want).float().mean()):.2e} of "
                         f"elements differ, {beyond:.2e} by more than 1 "
                         f"ulp, the largest by {excess / 1e-5:.3f} of the "
                         "1e-5")
        err = max(err, diff)
        if name in ("a", FLASH_MLA, FLASH_ENC):
            timed[name] = time_flash(q, k, v, kw, iters)
        if name == "c":  # the f32 body, a reading
            f32_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters)
        if name in FLASH_READ:
            read_ms[name] = cuda_ms(lambda: flash_attention(q, k, v, **kw),
                                    iters)
        del q, k, v, got, want
    ms, plain_ms, lib_ms, b_ms, b_by, line = timed["a"]
    print(f"[kernel] flash_attention: " + "; ".join(notes) + f"; (a) {line}")
    print(f"[kernel] flash_attention at the MLA prefill ({FLASH_MLA}): "
          f"{timed[FLASH_MLA][-1]}")
    print(f"[kernel] flash_attention at whisper's encoder ({FLASH_ENC}): "
          f"{timed[FLASH_ENC][-1]}")
    print(f"[kernel] flash_attention f32 body at (c): {f32_ms:.4f} ms (a "
          "reading); " + ", ".join(f"({n}) {ms:.4f} ms" for n, ms in
                                   read_ms.items()) + " (readings)")
    print(f"[sass] flash_attention: {sass_mix()}")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:83",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


class plain_attention:
    """Inside the block, the LM's attention takes the plain version:
    ``ops.flash_attention`` (which ``models/attention.py`` looks up at
    call time) is swapped for ``ref.flash_attention``."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self._ops, self._kept = ops, ops.flash_attention
        ops.flash_attention = ref.flash_attention

    def __exit__(self, *exc):
        self._ops.flash_attention = self._kept


def rel_gap(a, b) -> float:
    """``max |a - b|`` over the RMS of ``b``."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.pow(2).mean().sqrt())


def lm_path(dev="cuda"):
    """Phase 7's main path through the launcher's functions. Returns the
    path's launch counts."""
    from repro_torch.core.lm_conformal import ConformalOodDetector
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg, params = serve.lm_model(LM_ARCH, LM_REDUCED, SEED, dev)
    n_par = sum(t.numel() for t in params.parameters())
    calib = serve.stream_tokens(cfg, LM_CALIB, LM_SEQ, SEED, 0, dev)
    held = serve.stream_tokens(cfg, LM_CALIB, LM_SEQ, SEED, 1, dev)
    req = serve.request_tokens(cfg, LM_REQUESTS, LM_SEQ, SEED, dev)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv) x "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{n_par / 1e9:.3f} B parameters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    emb, emb_ms = timed_ms(lambda: serve.embed(params, cfg, calib))
    ood, fit_ms = timed_ms(
        lambda: ConformalOodDetector(k=LM_K, device=dev).fit(emb))
    held_emb, held_ms = timed_ms(lambda: serve.embed(params, cfg, held))
    p_held, pv_ms = timed_ms(lambda: ood.pvalues(held_emb))
    gen, dec_ms = timed_ms(lambda: serve.generate(params, cfg, req, LM_GEN))
    req_emb, req_ms = timed_ms(lambda: serve.embed(params, cfg, req))
    p_req, preq_ms = timed_ms(lambda: ood.pvalues(req_emb))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tok = LM_REQUESTS * LM_GEN
    print(f"[lm-main] embedding pass {LM_CALIB} x {LM_SEQ}: calibration "
          f"{emb_ms:.1f} ms, held-out {held_ms:.1f} ms; OOD fit "
          f"{fit_ms:.3f} ms, p-values of {LM_CALIB} {pv_ms:.3f} ms; "
          f"{LM_REQUESTS} requests x ({LM_SEQ} prefill + {LM_GEN} generated)"
          f" by decode steps in {dec_ms:.1f} ms ({tok / dec_ms * 1e3:.1f} "
          f"tok/s, {(LM_SEQ + LM_GEN) / dec_ms * 1e3:.1f} steps/s), request "
          f"embedding {req_ms:.1f} ms, p-values {preq_ms:.3f} ms (host "
          f"clock, synchronised); peak {peak / 2**30:.2f} GiB; launches "
          f"{counts}")
    check(counts["flash_attention"] == 3 * cfg.n_layers,
          "flash_attention: one launch per layer per embedding pass")
    check(sum(counts.values()) == counts["flash_attention"],
          "no other kernel on the LM path")
    check(emb.shape == (LM_CALIB, cfg.d_model)
          and emb.dtype == lm.dtype_of(cfg.dtype)
          and bool(torch.isfinite(emb).all()), "finite calibration embeddings")
    check(gen.shape == (LM_REQUESTS, LM_GEN) and bool(
        ((gen >= 0) & (gen < cfg.vocab_size)).all()), "generated tokens")
    for p in (p_held, p_req):
        check(bool(((p > 0) & (p <= 1)).all()), "p-values in (0, 1]")

    # ---- validity (binding) and power (a reading) --------------------------
    ph = p_held.cpu().numpy()
    share, mean_p = float((ph <= EPS).mean()), float(ph.mean())
    pr = p_req.cpu().numpy()
    half = LM_REQUESTS // 2
    print(f"[lm-valid] held-out in-distribution ({LM_CALIB}): share p <= "
          f"{EPS} {share:.4f} (<= 0.18), mean p {mean_p:.4f} (in [0.40, "
          f"0.60]); requests of another seed's stream: mean p "
          f"{pr[:half].mean():.4f}; uniform-token requests: mean p "
          f"{pr[half:].mean():.4f}, share p <= {EPS} "
          f"{float((pr[half:] <= EPS).mean()):.4f} (power, a reading)")
    check(share <= 0.18, f"held-out share with p <= {EPS}: {share}")
    check(0.40 <= mean_p <= 0.60, f"held-out mean p {mean_p}")

    # ---- one full-width decode step without a host synchronisation --------
    cache = lm.init_cache(cfg, LM_REQUESTS, 2, dev)
    lm.decode_step(params, cfg, req[:, :1], cache, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_logits, _ = lm.decode_step(params, cfg, req[:, 1:2], cache, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(step_logits).all()), "finite decode logits")
    print(f"[lm-sync] one decode step of {cfg.name} at full width "
          f"({LM_REQUESTS} sequences) under set_sync_debug_mode(\"error\"): "
          "no host synchronisation")
    del cache, step_logits

    # ---- bf16 full depth: the plain route's gap (a reading) ----------------
    with plain_attention():
        emb_plain = serve.embed(params, cfg, calib)
    bf16_gap = rel_gap(emb, emb_plain)
    del params, emb_plain
    torch.cuda.empty_cache()

    # ---- f32, full width, LM_CHECK_LAYERS layers (binding) -----------------
    cfg32 = cfg.replace(n_layers=LM_CHECK_LAYERS, dtype="float32",
                        param_dtype="float32")
    p32 = serve.lm_model(LM_ARCH, LM_REDUCED, SEED, dev,
                         n_layers=LM_CHECK_LAYERS, dtype="float32",
                         param_dtype="float32")[1]
    routes = {}
    for route in ("kernel", "plain"):
        with plain_attention() if route == "plain" else nullcontext():
            routes[route] = [serve.embed(p32, cfg32, t) for t in (calib,
                                                                  held)]
    gap = max(rel_gap(a, b) for a, b in zip(routes["kernel"],
                                            routes["plain"]))
    check(gap <= 1e-5, f"f32 kernel route == plain route within 1e-5 of "
          f"the RMS: {gap}")
    dets = {r: ConformalOodDetector(k=LM_K, device=dev).fit(e[0])
            for r, e in routes.items()}
    pk = dets["kernel"].pvalues(routes["kernel"][1])
    pp = dets["plain"].pvalues(routes["plain"][1])
    alphas, alpha = dets["kernel"].scores(routes["kernel"][1])
    near = ((alphas - alpha[:, None]).abs() <= 1e-4 * torch.maximum(
        alphas.abs(), alpha.abs()[:, None]) + 1e-6).any(1)
    check(torch.equal(pk[~near], pp[~near]), "OOD p-values equal outside "
          "flagged near-ties")
    B, S = LM_DECODE_CHECK
    toks = calib[:B, :S]
    full = lm.forward(p32, cfg32, {"tokens": toks})
    cache = lm.init_cache(cfg32, B, S, dev)
    steps = [lm.decode_step(p32, cfg32, toks[:, i:i + 1], cache, i)[0][:, 0]
             for i in range(S)]
    dec = torch.stack(steps, 1)
    dec_err = float((dec - full).abs().max())
    check(torch.allclose(dec, full, atol=1e-3, rtol=1e-3),
          f"decode == forward within 1e-3: {dec_err}")
    print(f"[lm-exact] f32 {LM_CHECK_LAYERS} layers at full width: kernel "
          f"route == plain route, embeddings within {gap:.3g} of their RMS "
          f"(<= 1e-5); OOD p-values equal ({int(near.sum())} of "
          f"{near.numel()} held-out queries flagged as near-ties); "
          f"teacher-forced decode == forward over {B} x {S} tokens, max abs "
          f"err {dec_err:.3g} (1e-3); bf16 {cfg.n_layers} layers: the "
          f"routes' embeddings differ by {bf16_gap:.3g} of their RMS (a "
          "reading)")
    del p32, routes, dets
    torch.cuda.empty_cache()
    return counts



# ---------------------------------------------------------------------------
# phase 8: the compact layout, the ring's bit-oracle
# ---------------------------------------------------------------------------


def tie_traffic(rng, xs, ys, share=0.2, max_lag=64):
    """``xs, ys`` with ``share`` of each tenant's points replaced by one of
    its own earlier points (``1 .. max_lag`` ticks back): exact duplicates,
    so distances tie."""
    xs, ys = xs.copy(), ys.copy()
    T, S = ys.shape
    dup = rng.random((T, S)) < share
    lag = rng.integers(1, max_lag + 1, (T, S))
    for t in range(1, T):
        s = np.flatnonzero(dup[t])
        src = np.maximum(t - lag[t, s], 0)
        xs[t, s], ys[t, s] = xs[src, s], ys[src, s]
    return xs, ys, int(dup[1:].sum())


def gated_run(eng, xs, ys, taus, active):
    """``observe_many`` over ``CHUNK``-tick chunks with the gate ``active``:
    ``(state, p (T, S))``."""
    state, ps = eng.init_state(), []
    for c0 in range(0, xs.shape[0], CHUNK):
        sl = slice(c0, c0 + CHUNK)
        state, p = eng.observe_many(state, xs[sl], ys[sl], taus[sl],
                                    active[sl])
        ps.append(p)
    return state, torch.cat(ps)


def same_p(a, b) -> bool:
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(), b.nan_to_num())


def check_compact_kernels(eng, state, kind, Xq, x, y, tau, iters):
    """The compact path's kernels against their plain versions on the
    path's own arguments (its launch counts already read): one more
    compact tick on a copy of ``state``, whose ``stream_update`` launch
    (the non-evicting form, in the linear layout) == ``ref.stream_tick``
    with every output bitwise; then the read's ``pairwise_sq_dists`` and
    its ``cp_knn_counts`` (class) or ``interval_sweep`` (reg) == plain,
    bitwise. Returns a note for the path's line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_update import stream_update

    act = torch.ones(x.shape[0], dtype=torch.bool)
    act[0] = False
    with recorded("_stream_update") as rec:
        eng.observe(state.clone(), x, y, tau, act)
    a, kw = rec.args, rec.kw
    check(kw["ev"] is None and kw["D"] is None
          and int(kw["head"].abs().max()) == 0
          and int(kw["wrap"].min()) == a[0].shape[1],
          f"compact {kind}: the tick launches the non-evicting form in the "
          "linear layout")
    runs = []
    for fn in (stream_update, ref.stream_tick):
        args, kws = cloned(a), cloned(kw)
        runs.append([t for t in (*fn(*args, **kws), *args, *kws.values())
                     if torch.is_tensor(t)])
    torch.cuda.synchronize()
    check(len(runs[0]) == len(runs[1]) and all(
        torch.equal(u, v) for u, v in zip(*runs)),
        f"compact {kind}: stream_update == ref.stream_tick bitwise on the "
        "compact tick's own arguments")
    ms = cuda_ms(lambda: stream_update(*a, **kw), iters)
    notes = [f"stream_update_{kind} (non-evicting, linear) == "
             f"ref.stream_tick bitwise on a compact tick's own arguments "
             f"(S={a[0].shape[0]} cap={a[0].shape[1]}), {ms:.4f} ms there"]
    read = ((lambda: eng.predict(state, Xq)) if kind == "class" else
            (lambda: eng.intervals(state, Xq, epsilon=EPS)))
    for name in ("sq_dists",
                 "cp_knn_counts" if kind == "class" else "interval_sweep"):
        notes.append(check_read_kernel(name, read, iters))
    return "; ".join(notes)


def compact_exactness(S, iters):
    """Ring == compact in both engines at window = capacity =
    ``COMPACT_W``, across the wrap seam, gated, with duplicate points:
    p-values, every leaf after ``to_linear`` and the reads, bitwise; then
    the compact path's kernels against their plain versions on its own
    arguments. Returns the compact runs' launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (class_drift_traffic,
                                          reg_drift_traffic)
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.regression import stream as rs
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import session as sm

    W, T, P, M = COMPACT_W, COMPACT_T, DIM, QUERIES
    rng = np.random.default_rng(SEED + 8)
    counts = {}
    for kind in ("class", "reg"):
        if kind == "class":
            xs, ys, taus, _ = class_drift_traffic(SEED + 8, S, T, P, 0.0)
            make = lambda lay: ServingEngine(  # noqa: E731
                n_sessions=S, capacity=W, dim=P, k=K, n_labels=N_LABELS,
                window=W, layout=lay, device="cuda")
            linear, k = sm.to_linear, K
        else:
            xs, ys, taus, _, _ = reg_drift_traffic(SEED + 8, S, T, P, 0.0)
            make = lambda lay: RegressionServingEngine(  # noqa: E731
                n_sessions=S, capacity=W, dim=P, k=K_REG, window=W,
                layout=lay, device="cuda")
            linear, k = rs.to_linear, K_REG
        xs, ys, n_dup = tie_traffic(rng, xs, ys)
        active = rng.random((T, S)) >= 0.25
        # reads: half the queries repeat points of the last window
        Xq = rng.standard_normal((S, M, P), dtype=np.float32)
        Xq[:, :M // 2] = xs[T - M // 2:].swapaxes(0, 1)
        ring, comp = make("ring"), make("compact")
        a, pa = gated_run(ring, xs, ys, taus, active)
        ra = (ring.predict(a, Xq) if kind == "class"
              else ring.intervals(a, Xq, epsilon=EPS))
        ops.reset_launch_counts()
        b, pb = gated_run(comp, xs, ys, taus, active)
        rb = (comp.predict(b, Xq) if kind == "class"
              else comp.intervals(b, Xq, epsilon=EPS))
        torch.cuda.synchronize()
        c = ops.launch_counts()
        counts = {n: counts.get(n, 0) + v for n, v in c.items()}
        name = "stream_update_" + kind
        check(c[name] == T, f"compact {kind}: one {name} launch a tick "
              f"({c[name]} in {T} ticks)")
        check(int(a.head.max()) > 0 and int(b.head.max()) == 0
              and int(b.n.min()) == W, f"compact {kind}: rings wrapped, "
              "compact heads at 0, windows full")
        check(bool(pa.isnan().cpu().equal(torch.from_numpy(~active))),
              f"compact {kind}: NaN p-values exactly on the gated lanes")
        check(same_p(pa, pb), f"compact {kind}: ring == compact p-values, "
              "bitwise")
        check(equal_states(linear(a), linear(b)), f"compact {kind}: ring "
              "== compact, every leaf after to_linear, bitwise")
        check(same_p(ra, rb), f"compact {kind}: the reads on both states, "
              "bitwise")
        print(f"[compact] {kind} S={S} window=capacity={W} k={k}: {T} "
              f"ticks ({T // W} laps + {T % W}), {int((~active).sum())} of "
              f"{T * S} lanes gated off, {n_dup} duplicate points: ring == "
              f"compact bitwise (p-values with NaN on the gated lanes, "
              f"every leaf after to_linear, "
              f"{'predict' if kind == 'class' else 'intervals'} m={M}); "
              f"compact launches {c}")
        # one more tick repeats the last point: a zero distance, ties
        print(f"[compact-kernels] {kind}: " + check_compact_kernels(
            comp, b, kind, Xq, xs[T - 1], ys[T - 1], taus[T - 1], iters))
        del a, b, ring, comp
        torch.cuda.empty_cache()
    return counts


def compact_timing(S, W):
    """``CHUNK`` compact ticks at full width on a state filled by ring
    ticks and made linear, against as many ring ticks on the same state
    in the same call (CUDA events a chunk); the two results bitwise."""
    from repro_torch.launch.serve import class_drift_traffic, reg_drift_traffic
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.regression import stream as rs
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import session as sm

    T = W + 2 * CHUNK
    for kind in ("class", "reg"):
        if kind == "class":
            xs, ys, taus, _ = class_drift_traffic(SEED + 9, S, T, DIM, 0.0)
            make = lambda lay: ServingEngine(  # noqa: E731
                n_sessions=S, capacity=W, dim=DIM, k=K, n_labels=N_LABELS,
                window=W, layout=lay, device="cuda")
            linear = sm.to_linear
        else:
            xs, ys, taus, _, _ = reg_drift_traffic(SEED + 9, S, T, DIM, 0.0)
            make = lambda lay: RegressionServingEngine(  # noqa: E731
                n_sessions=S, capacity=W, dim=DIM, k=K_REG, window=W,
                layout=lay, device="cuda")
            linear = rs.to_linear
        ring, comp = make("ring"), make("compact")
        state, _, _ = drive(ring, ring.init_state(), xs, ys, taus, W + CHUNK)
        state = linear(state)
        torch.cuda.empty_cache()
        sl = slice(W + CHUNK, T)
        out, ms, rise = {}, {}, {}
        for lay, eng in (("ring", ring), ("compact", comp)):
            st = state.clone()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            st, p = eng.observe_many(st, xs[sl], ys[sl], taus[sl])
            e1.record()
            e1.synchronize()
            rise[lay] = torch.cuda.max_memory_allocated() - base
            ms[lay] = e0.elapsed_time(e1) / CHUNK
            out[lay] = (linear(st), p)
            del st
            torch.cuda.empty_cache()
        check(same_p(out["ring"][1], out["compact"][1])
              and equal_states(out["ring"][0], out["compact"][0]),
              f"compact timing ({kind}): the two layouts' ticks bitwise")
        print(f"[compact-time] {kind} S={S} window=capacity={W}: {CHUNK} "
              f"evicting ticks on one linear state filled by {W + CHUNK} ring "
              f"ticks: compact {ms['compact']:.3f} ms a tick, peak memory "
              f"rise {rise['compact'] / 2**30:.2f} GiB; ring "
              f"{ms['ring']:.3f} ms a tick, rise "
              f"{rise['ring'] / 2**20:.1f} MiB (chunk CUDA events / ticks); "
              "both layouts' states and p-values bitwise equal")
        del state, out, ring, comp
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the bootstrap measure (paper Section 6, Algorithm 3)
# ---------------------------------------------------------------------------


def boot_states_equal(a, b) -> bool:
    arrays = ("X", "y", "uids", "W", "star", "elig", "counts", "feat",
              "thresh", "leaf", "pre_pred", "pre_votes")
    bits = lambda v: np.ascontiguousarray(v).view(np.uint8)  # noqa: E731
    return (all(getattr(a, f).dtype == getattr(b, f).dtype
                and np.array_equal(bits(getattr(a, f)), bits(getattr(b, f)))
                for f in arrays)
            and (a.draw_ids, a.E, a.E_i, a.next_uid, a.next_draw)
            == (b.draw_ids, b.E, b.E_i, b.next_uid, b.next_draw))


def star_forest_inputs(st, x_t, t, lbl):
    """The arguments ``pvalues_optimized`` gives the forest for test point
    ``t`` (``x_t``) and label ``lbl``: the augmented rows and labels, the
    star samples' multiplicities and their keyed node draws."""
    from repro_torch.core.measures import bootstrap as boot

    row_of = {d: r for r, d in enumerate(st.draw_ids)}
    star_ref = sorted({d for lst in st.E_i for d in lst
                       if st.star[row_of[d]] > 0})
    srows = np.asarray([row_of[d] for d in star_ref], np.int64)
    W = np.concatenate([st.W[srows], st.star[srows][:, None]], axis=1)
    rng = np.random.default_rng((st.seed, boot._STAR_TAG, t, lbl))
    fc, u = boot._node_rand(rng, len(star_ref), st.feat.shape[1],
                            st.X.shape[1])
    Xa = np.concatenate([st.X, x_t[None]], axis=0)
    return Xa, np.append(st.y, np.int32(lbl)), W, fc, u


def trees_equal_plain(X, y, W, fc, u, feat, thresh, leaf, preds, Xp, L,
                      depth) -> int:
    """Each tree ``r`` of a forest fitted on the card (``feat, thresh,
    leaf (S, n_nodes)`` and its predictions ``preds (S, q)`` on ``Xp``) ==
    ``ref.boot_fit_tree`` / ``boot_predict_tree`` on the CPU, bitwise.
    Returns the number of trees held."""
    from repro_torch.kernels import ref

    Xc, Xpc, yc = (torch.from_numpy(np.ascontiguousarray(a))
                   for a in (X, Xp, y))
    for r in range(W.shape[0]):
        f, t, lf = ref.boot_fit_tree(Xc, yc, torch.from_numpy(W[r]),
                                     torch.from_numpy(fc[r]),
                                     torch.from_numpy(u[r]), L, depth)
        check(np.array_equal(f.numpy(), feat[r])
              and np.array_equal(t.numpy().view(np.int32),
                                 thresh[r].view(np.int32))
              and np.array_equal(lf.numpy(), leaf[r])
              and np.array_equal(ref.boot_predict_tree(f, t, lf, Xpc)
                                 .numpy(), preds[r]),
              "a tree fitted on the card == the per-tree plain version on "
              "the CPU, bitwise")
    return W.shape[0]


def bootstrap_path():
    """Phase 9 at the paper's App. E bootstrap settings. Returns the
    p-value run's forest counts."""
    from repro_torch.core.measures import bootstrap as boot
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import ops
    from repro_torch.launch import profile
    from repro_torch.serving.registry import ConformalPredictor

    n, m, mc, L = BOOT_N, BOOT_M, BOOT_COVER, N_LABELS
    X, y = make_classification(n + m + mc + BOOT_TICKS + 10, DIM, seed=SEED)
    X, y = X.astype(np.float32), y.astype(np.int32)
    Xtr, ytr, Xq = X[:n], y[:n], X[n:n + m]
    Xc, yc = X[n + m:n + m + mc], y[n + m:n + m + mc]
    Xs, ys = X[n + m + mc:-10], y[n + m + mc:-10]
    X10 = X[-10:]
    kw = dict(n_labels=L, B=BOOT_B, depth=BOOT_DEPTH, seed=SEED)

    # ---- fit and p-values: the card == the CPU, bitwise -------------------
    ops.reset_launch_counts()
    st, fit_ms = timed_ms(lambda: boot.fit(Xtr, ytr, **kw, device="cuda"))
    fit_c = ops.launch_counts()
    ops.reset_launch_counts()
    p_card, pv_ms = timed_ms(lambda: boot.pvalues_optimized(st, Xq))
    counts = ops.launch_counts()
    calls = ops.forest_calls()
    fits, preds = calls["boot_fit_forest"], calls["boot_forest_predict"]
    h2d = calls["h2d_bytes"]
    check(fits == m * L and preds == m * L + 1, f"bootstrap p-values: one "
          f"forest fit and prediction a (point, label), one candidate "
          f"prediction ({fits}, {preds})")
    st_cpu = boot.fit(Xtr, ytr, **kw, device="cpu")
    check(boot_states_equal(st, st_cpu), "bootstrap fit: the card's state "
          "== the CPU's, every array and list bitwise")
    p_cpu = boot.pvalues_optimized(st_cpu, Xq)
    check(p_card.tobytes() == p_cpu.tobytes(), "bootstrap p-values: the "
          "card == the CPU, bitwise")
    check(bool(((p_card > 0) & (p_card <= 1)).all()), "p-values in (0, 1]")
    pre = np.flatnonzero(st.star == 0)
    fc, u = boot._tree_rand(st.seed, [st.draw_ids[r] for r in pre],
                            st.feat.shape[1], DIM)
    held = trees_equal_plain(Xtr, ytr, st.W[pre], fc, u, st.feat[pre],
                             st.thresh[pre], st.leaf[pre], st.pre_pred[pre],
                             Xtr, L, BOOT_DEPTH)
    n_pre = held
    t = 0
    while held < 64:  # then the star forests of the first test points
        for lbl in range(L):
            Xa, ya, W, fc, u = star_forest_inputs(st, Xq[t], t, lbl)
            f_, t_, l_ = ops.boot_fit_forest(Xa, ya, W, fc, u, n_labels=L,
                                             depth=BOOT_DEPTH)
            pr = ops.boot_forest_predict(f_, t_, l_, Xtr)
            held += trees_equal_plain(Xa, ya, W, fc, u, f_, t_, l_, pr, Xtr,
                                      L, BOOT_DEPTH)
        t += 1
    print(f"[boot] n={n} p={DIM} L={L} B={BOOT_B} depth={BOOT_DEPTH}: fit "
          f"{fit_ms:.3f} ms (B' = {st.b_prime} shared samples, {n_pre} "
          f"pre-trained trees; {fit_c['boot_fit_forest']} forest fit and "
          f"{fit_c['boot_forest_predict']} prediction on the card), "
          f"pvalues_optimized m={m}: {pv_ms / m:.3f} ms a point (host "
          f"clock, synchronised), {fits / m:.1f} forest fits + "
          f"{preds / m:.2f} predictions and {h2d / m:.0f} B to the card a "
          f"point; state and p-values on the card == on the CPU (bitwise); "
          f"{held} trees ({n_pre} pre-trained, the rest the star forests of "
          f"{t} test points) == the per-tree plain version on the CPU "
          "(bitwise)")

    # ---- coverage ----------------------------------------------------------
    pc, cov_ms = timed_ms(lambda: boot.pvalues_optimized(st, Xc))
    own = pc[np.arange(mc), yc]
    covs = {eps: float(np.mean(own > eps)) for eps in (0.05, 0.2)}
    for eps, cov in covs.items():
        check(cov >= 1 - eps - 0.07, f"bootstrap coverage {cov} at eps {eps}")
    print(f"[boot-valid] coverage on {mc} fresh points: "
          + ", ".join(f"eps {e}: {c:.4f} (>= {1 - e - 0.07:.2f})"
                      for e, c in covs.items())
          + f"; {cov_ms / mc:.3f} ms a point")

    # ---- streaming: the registry's predictor == rebuild --------------------
    cp = ConformalPredictor("bootstrap", device="cuda", B=BOOT_B,
                            depth=BOOT_DEPTH, n_labels=L, seed=SEED)
    cp.fit(Xtr, ytr)
    obs_ms, ev_ms = [], []
    for i in range(BOOT_TICKS):
        _, o = timed_ms(lambda: cp.observe(Xs[i], int(ys[i])))
        _, e = timed_ms(lambda: cp.evict(0))
        obs_ms.append(o)
        ev_ms.append(e)
        rb = boot.rebuild(cp._state)
        check(boot_states_equal(cp._state, rb), "bootstrap streamed state "
              "== rebuild, every array and list bitwise")
        check(boot.pvalues_optimized(cp._state, X10).tobytes()
              == boot.pvalues_optimized(rb, X10).tobytes(),
              "bootstrap streamed p-values == rebuild's, bitwise")
    check(cp.n == n and np.array_equal(cp._state.X, np.concatenate(
        [Xtr[BOOT_TICKS:], Xs[:BOOT_TICKS]])), "sliding window kept")
    print(f"[boot-stream] registry ConformalPredictor(\"bootstrap\") at "
          f"n={n}: {BOOT_TICKS} ticks of observe + evict(0): observe p50 "
          f"{np.percentile(obs_ms, 50):.3f} ms, evict p50 "
          f"{np.percentile(ev_ms, 50):.3f} ms (host clock, synchronised); "
          f"after every tick the state == rebuild (bitwise) and the "
          f"p-values of 10 fixed points == the rebuild's; B' now "
          f"{cp._state.b_prime}")
    del cp

    # ---- standard against optimized ----------------------------------------
    ns, ms_ = BOOT_N_STD, BOOT_M_STD
    st2 = boot.fit(X[:ns], y[:ns], **kw, device="cuda")
    po, opt_ms = timed_ms(lambda: boot.pvalues_optimized(st2, Xq[:ms_]))
    ps, std_ms = timed_ms(lambda: boot.pvalues_standard(
        X[:ns], y[:ns], Xq[:ms_], **kw, device="cuda"))
    speed = std_ms / opt_ms
    check(po.shape == ps.shape == (ms_, L) and bool((ps > 0).all()),
          "bootstrap standard p-values")
    check(speed >= 5.0, f"bootstrap optimized is {speed:.2f}x the standard "
          "path (>= 5x)")
    print(f"[boot-speed] n={ns} m={ms_}: standard {std_ms / ms_:.3f} ms a "
          f"point, optimized {opt_ms / ms_:.3f} ms a point: {speed:.1f}x "
          "(>= 5x; host clock, synchronised)")

    # ---- launches and the card's busy share --------------------------------
    profile.profile_batch("bootstrap", None)
    return counts


# ---------------------------------------------------------------------------
# phase 10: the registry's k-NN regression, then the figures runner
# ---------------------------------------------------------------------------


def relabelled_ids(st):
    """``(aid, nbr_a)`` of a one-tenant regression state with arrival ids
    replaced by their rank among the live ids (``from_fit`` numbers its
    points from 0); fails unless the ids are in arrival order and every
    live neighbour's id is a live point's."""
    n = int(st.n[0])
    live = st.aid[0, :n]
    check(bool((live[1:] > live[:-1]).all()), "arrival ids in order")
    ok = st.nbr_d[0] < BIG
    rank = torch.searchsorted(live, st.nbr_a[0].contiguous())
    check(torch.equal(live[rank.clamp(max=n - 1)][ok], st.nbr_a[0][ok]),
          "every neighbour id is a live point's")
    return (torch.arange(n, device=live.device, dtype=torch.int32),
            torch.where(ok, rank.to(torch.int32), 0))


def same_window(got, want) -> bool:
    """Every leaf bitwise, the arrival ids after relabelling."""
    return (all(torch.equal(getattr(got, f), getattr(want, f)) for f in
                ("X", "y", "D", "nbr_d", "nbr_y", "n", "head", "wrap"))
            and all(torch.equal(a, b) for a, b in
                    zip(relabelled_ids(got), relabelled_ids(want))))


def one_tenant(st):
    """A registry regression state (no tenant axis) as a batch of one."""
    from repro_torch.regression.stream import RegStreamState

    return RegStreamState.from_leaves([t[None] for t in st.leaves()])


def check_registry_kernels(cp, x, y, Xf, Xq, iters):
    """The registry path's kernels against their plain versions on the
    path's own arguments (its launch counts already read): one more
    ``observe`` on a copy of the predictor's state, whose ``stream_update``
    launch (reg mode, non-evicting, on the padded one-tenant ring: head 0,
    wrap = cap) == ``ref.stream_tick`` with every output bitwise; then
    ``pairwise_sq_dists`` on the arguments of the ``pvalues`` read of
    ``Xq`` and of the ``intervals`` read of ``Xf``, and that read's
    ``interval_sweep``, each == plain, bitwise (the fit is ``observe``
    replayed, so its launches are the tick's). Returns a note."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_update import stream_update

    with recorded("_stream_update") as rec:
        cp.spec.observe(cp._state.clone(), cp._ctx, x, y, cp.hp)
    a, kw = rec.args, rec.kw
    check(kw["mode"] == "reg" and kw["ev"] is None and kw["D"] is None
          and int(kw["head"].abs().max()) == 0
          and int(kw["wrap"].min()) == a[0].shape[1],
          "registry: observe launches the non-evicting reg form on the "
          "padded ring")
    runs = []
    for fn in (stream_update, ref.stream_tick):
        args, kws = cloned(a), cloned(kw)
        runs.append([t for t in (*fn(*args, **kws), *args, *kws.values())
                     if torch.is_tensor(t)])
    torch.cuda.synchronize()
    check(len(runs[0]) == len(runs[1]) and all(
        torch.equal(u, v) for u, v in zip(*runs)),
        "registry: stream_update == ref.stream_tick bitwise on an observe's "
        "own arguments")
    ms = cuda_ms(lambda: stream_update(*a, **kw), iters)
    notes = [f"stream_update_reg (non-evicting, padded ring) == "
             f"ref.stream_tick bitwise on an observe's own arguments (S="
             f"{a[0].shape[0]} cap={a[0].shape[1]}), {ms:.4f} ms there"]
    for name, read in (("sq_dists", lambda: cp.pvalues(Xq)),
                       ("sq_dists", lambda: cp.intervals(Xf, EPS)),
                       ("interval_sweep", lambda: cp.intervals(Xf, EPS))):
        notes.append(check_read_kernel(name, read, iters))
    return "; ".join(notes)


def regression_registry_path(iters=20):
    """Phase 10, part 1. Returns the registry path's launch counts."""
    from repro_torch.core import regression as reg
    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import ops
    from repro_torch.regression import stream as rs
    from repro_torch.serving.registry import ConformalPredictor

    n, k, m = REG_N, K_REG, QUERIES
    X, y = make_regression(n + REG_OBS + REG_FRESH + m, DIM, seed=SEED)
    X, y = X.astype(np.float32), y.astype(np.float32)
    Xf, yf = X[n + REG_OBS:n + REG_OBS + REG_FRESH], y[n + REG_OBS:-m]
    Xq = X[-m:]
    tq = np.linspace(y.min(), y.max(), REG_TQ).astype(np.float32)
    window = list(range(n + REG_OBS))
    drops = [0, (n + REG_OBS) // 2, n + REG_OBS - 3]  # head, middle, last
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    cp = ConformalPredictor("knn_regression", device="cuda", k=k,
                            t_query=tq)
    _, fit_ms = timed_ms(lambda: cp.fit(X[:n], y[:n]))
    obs_ms = [timed_ms(lambda: cp.observe(X[t], float(y[t])))[1]
              for t in range(n, n + REG_OBS)]
    evicted, ev_ms = [], []
    for i in drops:
        _, ms = timed_ms(lambda: cp.evict(i))
        del window[i]
        evicted.append((one_tenant(cp._state), list(window)))
        ev_ms.append(ms)
    iv, iv_ms = timed_ms(lambda: cp.intervals(Xf, EPS))
    _, iv2_ms = timed_ms(lambda: cp.intervals(Xf, EPS))
    pv, pv_ms = timed_ms(lambda: cp.pvalues(Xq))
    counts = ops.launch_counts()
    for name in ("stream_update_reg", "pairwise_sq_dists",
                 "interval_sweep"):
        check(counts[name] > 0, f"{name} launched on the registry path")
    check(cp.n == n + REG_OBS - 3 and iv.shape == (REG_FRESH, 2)
          and pv.shape == (m, REG_TQ), "registry regression shapes")
    print(f"[reg-registry] ConformalPredictor('knn_regression') n={n} "
          f"p={DIM} k={k}: fit {fit_ms:.3f} ms, observe p50 "
          f"{np.percentile(obs_ms, 50):.3f} ms, evict(i) at ranks {drops} "
          + "/".join(f"{v:.3f}" for v in ev_ms) + f" ms, intervals "
          f"m={REG_FRESH} first {iv_ms:.3f} ms steady {iv2_ms:.3f} ms, "
          f"pvalues m={m} x {REG_TQ} labels {pv_ms:.3f} ms (host clock, "
          f"synchronised); launches {counts}")
    print("[reg-registry-kernels] " + check_registry_kernels(
        cp, torch.from_numpy(Xf[0]).cuda(), float(yf[0]),
        torch.from_numpy(Xf).cuda(), torch.from_numpy(Xq).cuda(), iters))

    # ---- exactness: each evict == from_fit on the survivors ---------------
    for (st, win), i in zip(evicted, drops):
        ref = rs.from_fit(X[None, win], y[None, win], k=k,
                          capacity=len(win), device="cuda")
        check(same_window(st, ref), f"evict({i}) == from_fit on the "
              "remaining points, every leaf bitwise (ids relabelled)")
    fit = reg.fit(torch.from_numpy(X[window]).cuda(),
                  torch.from_numpy(y[window]).cuda(), k=k)
    want = reg.intervals_optimized(fit, torch.from_numpy(Xf).cuda(), k=k,
                                   epsilon=EPS)
    check(same_p(iv, want), "served intervals == intervals_optimized on "
          "a refit of the window, bitwise")
    tq_t = torch.from_numpy(tq).cuda()
    check(torch.equal(pv, reg.pvalues_optimized(
        fit, torch.from_numpy(Xq).cuda(), tq_t, k=k)),
        "served p-values == pvalues_optimized on the refit, bitwise")
    yf_t = torch.from_numpy(yf).cuda()
    cov = float(((iv[:, 0] <= yf_t) & (yf_t <= iv[:, 1])).float().mean())
    check(cov >= 0.88, f"registry regression coverage {cov}")
    icp = reg.icp_intervals(torch.from_numpy(X[window]).cuda(),
                            torch.from_numpy(y[window]).cuda(),
                            torch.from_numpy(Xf).cuda(), k=k,
                            t=len(window) // 2, epsilon=EPS)
    icov = float(((icp[:, 0] <= yf_t) & (yf_t <= icp[:, 1])).float().mean())
    check(icov >= 0.88, f"ICP regression coverage {icov}")
    print(f"[reg-registry-exact] each evict(i) == from_fit on the remaining "
          f"points (every leaf bitwise, ids relabelled); intervals and "
          f"p-values == *_optimized on a refit (bitwise, NaN as NaN); "
          f"coverage at eps {EPS} on {REG_FRESH} fresh points {cov:.4f}, "
          f"ICP (t = n/2) {icov:.4f} (>= 0.88), empty share "
          f"{float(iv[:, 0].isnan().float().mean()):.4f}")
    del cp, evicted, fit
    torch.cuda.empty_cache()
    return counts


def figures_path():
    """Phase 10, part 2: the figures runner at its smoke grid. Returns
    its launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import figures

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows, checks, notes = figures.run_grid(
        figures.GRIDS["smoke"], m=figures.M_TEST["smoke"], device="cuda",
        seed=SEED, table2_n=figures.TABLE2_N["smoke"],
        emit=lambda line: print("[fig] " + line))
    counts = ops.launch_counts()
    for line in figures.report(rows, checks, notes):
        print("[fig] " + line)
    ran = sum(r["cut"] is None for r in rows)
    check(ran > 0 and checks[figures.GRIDS["smoke"][0]],
          "figures: rows measured and checks made")
    print(f"[figures] smoke grid {figures.GRIDS['smoke']}: {ran} rows "
          f"measured, {len(rows) - ran} cut, in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the serving shell (telemetry, the tick guard, snapshots, the
# fleet, the launcher's shell flags)
# ---------------------------------------------------------------------------


def expected_tick_stats(active, W):
    """The drained tick counters of ticks with the ``(T, S)`` bool mask
    ``active`` from empty window-``W`` rings, tick by tick in numpy."""
    from repro_torch.telemetry.device import STAT_KEYS

    S = active.shape[1]
    n, head = np.zeros(S, np.int64), np.zeros(S, np.int64)
    tot = dict.fromkeys(STAT_KEYS, 0)
    for act in active:
        ev = act & (n >= W)
        tot["ticks"] += int(act.sum())
        tot["evictions"] += int(ev.sum())
        tot["backfills"] += int(ev.sum())
        tot["ring_wraps"] += int((ev & (head == W - 1)).sum())
        head = np.where(ev, (head + 1) % W, head)
        n = np.where(act, np.minimum(n + 1, W), n)
        tot["occupancy_sum"] += int(n.sum())
        tot["occupancy_max"] = max(tot["occupancy_max"], int(n.max()))
    return tot


def device_chunks(xs, ys, taus, t0, t1):
    """Ticks ``[t0, t1)`` of the traffic on the card, in CHUNK pieces."""
    out = []
    for c0 in range(t0, t1, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, t1))
        out.append([torch.from_numpy(np.ascontiguousarray(v[sl])).cuda()
                    for v in (xs, ys, taus)])
    return out


def instrumented_run(mode, S, W, xs, ys, taus, T):
    """Phase 11 (a) in one mode: a plain and an instrumented engine (a
    ``MetricsRegistry`` and a ``Tracer`` on a temporary file) over the
    same ``T`` ticks in CHUNK-tick calls, in turns. Returns the
    instrumented engine, its state and the chunk ms of both."""
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.serving import ServingEngine
    from repro_torch.telemetry import (MetricsRegistry, Tracer,
                                       validate_trace_file)

    kw = dict(n_sessions=S, capacity=W, window=W, dim=DIM, device="cuda")
    if mode == "classification":
        cls, kw = ServingEngine, dict(kw, k=K, n_labels=N_LABELS)
    else:
        cls, kw = RegressionServingEngine, dict(kw, k=K_REG)
    fd, trace = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        tracer = Tracer(trace)
        metrics = MetricsRegistry()
        plain = cls(**kw)
        inst = cls(**kw, instrument=True, metrics=metrics, tracer=tracer)
        sp, si = plain.init_state(), inst.init_state()
        ms = {"plain": [], "instrumented": []}
        same = True
        for c, chunk in enumerate(device_chunks(xs, ys, taus, 0, T)):
            got = {}
            turns = (("plain", plain, sp), ("instrumented", inst, si))
            for name, eng, st in turns[::1 if c % 2 == 0 else -1]:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                st, p = eng.observe_many(st, *chunk)
                e1.record()
                got[name] = (st, p, e0, e1)
            sp, pp = got["plain"][:2]
            si, pi = got["instrumented"][:2]
            same &= bool(torch.equal(pp, pi))
            for name, (_, _, e0, e1) in got.items():
                ms[name].append((e0, e1))
        torch.cuda.synchronize()
        ms = {k: np.array([a.elapsed_time(b) for a, b in v])
              for k, v in ms.items()}
        check(same and equal_states(sp, si),
              f"{mode}: instrumented engine == plain (p-values and every "
              "leaf, bitwise)")
        got = inst.telemetry.drain()
        want = expected_tick_stats(np.ones((T, S), bool), W)
        check(got == want, f"{mode}: drained tick counters {got} == the "
              f"numpy closed form {want}")
        tick_ms = one_tick_ms(plain, sp, inst, si, xs, ys, taus, T)
        del plain, sp
        torch.cuda.empty_cache()
        names = {r["op"] for r in validate_trace_file(trace)}
        tracer.close()
        check(names == {"observe_many", "observe"},
              f"{mode}: the trace validates")
    finally:
        os.unlink(trace)
    rise = check_chunk_equals_ticks(inst, si, xs, ys, taus, T)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"[shell-a] {mode} S={S} w={W}: {T} ticks in {len(ms['plain'])} "
          f"chunks of {CHUNK}, instrumented == plain bitwise; counters "
          f"{got}; chunk ms median plain {med['plain']:.3f} instrumented "
          f"{med['instrumented']:.3f}; {overhead(ms['instrumented'], ms['plain'])}"
          f"; one-tick observe (the launcher's tick) median plain "
          f"{np.median(tick_ms['plain']):.3f} ms instrumented "
          f"{np.median(tick_ms['instrumented']):.3f} ms, "
          f"{overhead(tick_ms['instrumented'], tick_ms['plain'], 'tick')}"
          f"; the instrumented chunk made no host "
          f"synchronisation and raised peak memory by {rise / 2**20:.1f} "
          f"MiB")
    return inst, si


def overhead(a, b, unit="chunk") -> str:
    """The per-``unit`` ratio ``a / b`` of two engines run in turns (the
    order swapped every ``unit``) as its median and quartiles, in %."""
    q = 100 * (np.percentile(np.asarray(a) / np.asarray(b), [25, 50, 75])
               - 1)
    clock = "CUDA events" if unit == "chunk" else "host clock"
    return (f"overhead per {unit} pair {q[1]:+.2f} % (quartiles "
            f"{q[0]:+.2f} / {q[2]:+.2f} %; {clock}, order swapped every "
            f"{unit})")


def one_tick_ms(plain, sp, inst, si, xs, ys, taus, t0, n=128):
    """The launcher's tick: ``n`` one-tick ``observe`` calls on copies of
    both engines' states, in turns (the order swapped every tick), each
    timed on the host clock up to its p-values' copy to the host, as
    ``launch.serve`` does every tick. Checks the p-values equal; returns
    the ms of each engine's ticks."""
    states = {"plain": sp.clone(), "instrumented": si.clone()}
    engines = {"plain": plain, "instrumented": inst}
    ms = {"plain": [], "instrumented": []}
    same = True
    torch.cuda.synchronize()
    for i in range(n):
        t = t0 + i % CHUNK
        got = {}
        for name in ("plain", "instrumented")[::1 if i % 2 == 0 else -1]:
            h0 = time.perf_counter()
            states[name], p = engines[name].observe(states[name], xs[t],
                                                    ys[t], taus[t])
            got[name] = p.cpu()
            ms[name].append((time.perf_counter() - h0) * 1e3)
        same &= bool(torch.equal(got["plain"], got["instrumented"]))
    check(same, "one-tick observe: instrumented == plain p-values")
    return {k: np.array(v) for k, v in ms.items()}


def lane_plan(T, S):
    """Each lane-tick of ``T`` ticks faulted with probability
    ``SHELL_FAULT_RATE``: the
    keyed plan drawn over the ``T * S`` lane-ticks (as ticks of one
    tenant, so ``FaultPlan.random``'s one fault a step becomes one a
    lane-tick)."""
    from repro_torch.robustness import VALUE_FAULTS, FaultPlan

    return FaultPlan.random(SEED, steps=T * S, tenants=1,
                            rate=SHELL_FAULT_RATE, kinds=VALUE_FAULTS)


def guard_run(eng, state, xs, ys, taus, T, n_chunks):
    """Phase 11 (b): ``n_chunks`` chunks after tick ``T`` through a
    ``TickGuard`` on chaos traffic, against an unguarded engine on the
    clean traffic with the hit lane-ticks gated off; the third guarded
    chunk (not a sweep point; the first runs the engine's one-time
    occupancy check) under sync debug mode "error"."""
    from repro_torch.robustness import REJECT_KINDS, TickGuard, corrupt_traffic
    from repro_torch.serving import ServingEngine

    S = state.D.shape[0]
    t1 = T + n_chunks * CHUNK
    Xc, yc, tc = (np.ascontiguousarray(v[T:t1]) for v in (xs, ys, taus))
    Xf, yf, tf = Xc.copy(), yc.copy(), tc.copy()
    plan = lane_plan(t1 - T, S)
    hits = corrupt_traffic(plan, Xf.reshape(-1, 1, DIM), yf.reshape(-1, 1),
                           tf.reshape(-1, 1), mode="classification",
                           n_labels=N_LABELS)
    check(len(hits) > 0, "the chaos plan hit some lane-ticks")
    mask = np.ones(yc.shape, bool)
    kind_of = {"nan_feature": 0, "inf_feature": 0, "label_out_of_range": 1,
               "tau_out_of_range": 2}
    want = [0, 0, 0]
    for f in plan.faults():
        mask.reshape(-1)[f.step] = False
        want[kind_of[f.kind]] += 1
    ref = ServingEngine(n_sessions=S, capacity=eng.capacity,
                        window=eng.window, dim=DIM, k=K, n_labels=N_LABELS,
                        device="cuda")
    guard = TickGuard(ServingEngine(
        n_sessions=S, capacity=eng.capacity, window=eng.window, dim=DIM,
        k=K, n_labels=N_LABELS, device="cuda"), check_every=2)
    sg, sr = state.clone(), state.clone()
    gch = device_chunks(Xf, yf, tf, 0, t1 - T)
    rch = device_chunks(Xc, yc, tc, 0, t1 - T)
    masks = [torch.from_numpy(mask[c * CHUNK:(c + 1) * CHUNK]).cuda()
             for c in range(n_chunks)]
    ms = {"guarded": [], "unguarded": []}
    same = True
    torch.cuda.synchronize()
    for c in range(n_chunks):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if c % 2:  # the order swapped every chunk
            e[2].record()
            sr, pr = ref.observe_many(sr, *rch[c], masks[c])
            e[3].record()
        e[0].record()
        if c == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            sg, pg = guard.observe_many(sg, *gch[c])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        e[1].record()
        if c % 2 == 0:
            e[2].record()
            sr, pr = ref.observe_many(sr, *rch[c], masks[c])
            e[3].record()
        same &= same_p(pg, pr)
        ms["guarded"].append((e[0], e[1]))
        ms["unguarded"].append((e[2], e[3]))
    sg = guard.finalize(sg)
    rep = guard.drain()
    torch.cuda.synchronize()
    check(same and equal_states(sg, sr), "guarded == the unguarded engine "
          "with the hit lane-ticks gated off (p-values, every leaf)")
    check(rep["rejected"] == dict(zip(REJECT_KINDS, want)),
          f"guard rejections {rep['rejected']} == the plan's {want}")
    check(rep["quarantines"] == 0, "no lane quarantined on chaos traffic")
    del ref, sr
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in ms.items()}
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"[shell-b] guard: {len(hits)} lane-ticks hit in {t1 - T} ticks "
          f"x {S} tenants (rate {SHELL_FAULT_RATE}, seed {SEED}), rejected "
          f"{rep['rejected']} == the plan's; guarded == gated unguarded "
          f"bitwise; a guarded chunk off the sweep made no host "
          f"synchronisation; "
          f"chunk ms median guarded {med['guarded']:.3f} unguarded "
          f"{med['unguarded']:.3f}; {overhead(ms['guarded'], ms['unguarded'])}"
          ", two of the chunks sweep points")
    return guard, sg


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.leaves())


def room_for(nbytes: int, root: str) -> None:
    """Raise unless ``root``'s disk and the host's available memory hold
    a snapshot of ``nbytes`` (memory: the pinned copy and a restore)."""
    free = shutil.disk_usage(root).free
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    check(free >= nbytes * 1.05, f"the disk under {root} has {free} B free; "
          f"the snapshot needs {int(nbytes * 1.05)} B")
    check(avail is None or avail >= 2 * nbytes, f"the host has {avail} B "
          f"available; the snapshot round trip needs {2 * nbytes} B")


def saved_while_ticking(saver, eng, state, step, chunk):
    """``saver.save(step, state)``, then one chunk of ticks while the
    saver works, then ``close()``. Returns the state, the chunk's
    p-values, ``save()``'s seconds, the seconds to the commit and the
    chunk's ms a tick (CUDA events)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver.save(step, state, meta=eng.meta())
    t_enq = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    e0.record()
    state, p = eng.observe_many(state, *chunk)
    e1.record()
    saver.close()
    t_save = time.perf_counter() - t0
    return state, p, t_enq, t_save, e0.elapsed_time(e1) / CHUNK


def snapshot_roundtrip(mode, eng, state, xs, ys, taus, T, root, lane,
                       keep_restored=False):
    """Phase 11 (c): the state saved by an ``AsyncShardedSaver`` (4
    blocks) while the original engine ticks on, ``close()``, restored by
    ``SessionStore.restore_engine()`` on the card; 32 more ticks and one
    read on both, bitwise. Then a second save of the ticked state (the
    saver's pinned host blocks come from PyTorch's cache) while 32 more
    ticks run, and 32 ticks without a save, for the overlap reading.
    Returns the ticked state, the store, the second snapshot's copy of
    lane ``lane`` and, with ``keep_restored``, the restored engine and
    its state (else ``None``)."""
    from repro_torch.serving import AsyncShardedSaver, SessionStore

    nbytes = state_bytes(state)
    os.makedirs(root)
    room_for(2 * nbytes, root)
    Xq = torch.from_numpy(np.random.default_rng(SEED + 7).standard_normal(
        (state.D.shape[0], QUERIES, DIM), dtype=np.float32)).cuda()
    store = SessionStore(root)
    chunks = device_chunks(xs, ys, taus, T, T + 3 * CHUNK)
    state, p1, t_enq, t_save, ms_first = saved_while_ticking(
        AsyncShardedSaver(store, 4), eng, state, T, chunks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng2, state2, step = store.restore_engine()
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(step == T and type(eng2) is type(eng)
          and eng2.meta() == eng.meta()
          and state2.D.device == state.D.device,
          f"{mode}: restore_engine came back on the card with the meta")
    state2, p2 = eng2.observe_many(state2, *chunks[0])
    if mode == "classification":
        r1, r2 = eng.predict(state, Xq), eng2.predict(state2, Xq)
    else:
        r1 = eng.intervals(state, Xq, epsilon=EPS)
        r2 = eng2.intervals(state2, Xq, epsilon=EPS)
    check(torch.equal(p1, p2) and equal_states(state, state2)
          and same_p(r1, r2),
          f"{mode}: restored engine == original over {CHUNK} ticks and a "
          "read (bitwise)")
    restored = (eng2, state2) if keep_restored else None
    del eng2, state2
    torch.cuda.empty_cache()
    snap_lane = [t[lane].clone() for t in state.leaves()]
    state, _, t_enq2, t_save2, ms_second = saved_while_ticking(
        AsyncShardedSaver(store, 4), eng, state, T + CHUNK, chunks[1])
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    e0.record()
    state, _ = eng.observe_many(state, *chunks[2])
    e1.record()
    e1.synchronize()
    ms_alone = e0.elapsed_time(e1) / CHUNK
    gb = nbytes / 1e9
    print(f"[shell-c] {mode}: {gb:.3f} GB state "
          f"({', '.join(f'{t.numel() * t.element_size() / 1e6:.0f}' for t in state.leaves())} MB a leaf); "
          f"save() returned in {t_enq * 1e3:.1f} ms (device clones), "
          f"committed in {t_save:.2f} s ({gb / t_save:.3f} GB/s, 4 blocks, "
          f"pinned copies on the saver's stream); restore_engine "
          f"{t_restore:.2f} s ({gb / t_restore:.3f} GB/s, host clock); "
          f"{CHUNK} ticks and a read after restore == the original, "
          f"bitwise; a second save: save() {t_enq2 * 1e3:.1f} ms, committed "
          f"in {t_save2:.2f} s ({gb / t_save2:.3f} GB/s); ms a tick during "
          f"the first save {ms_first:.3f}, during the second "
          f"{ms_second:.3f}, without a save {ms_alone:.3f} (CUDA events, a "
          f"{CHUNK}-tick chunk each)")
    return state, store, snap_lane, restored


def quarantine_restore(eng, state, store, snap_lane, lane):
    """Phase 11 (b), last step: lane ``lane`` poisoned, a guard with the
    store of (c) quarantines it at its next sweep and restores it from
    the committed snapshot; that lane == the snapshot's, the others
    unchanged (bitwise)."""
    from repro_torch.robustness import TickGuard, poison_state

    ref = state.clone()
    for t, v in zip(ref.leaves(), snap_lane):
        t[lane].copy_(v)
    guard = TickGuard(eng, store=store, check_every=1)
    state = poison_state(state, lane)
    t0 = time.perf_counter()
    state = guard.finalize(state)
    t_q = time.perf_counter() - t0
    rep = guard.drain()
    check(rep["quarantines"] == 1 and rep["restores"] == 1
          and rep["quarantined_lanes"] == [], f"quarantine + restore {rep}")
    check(equal_states(state, ref), "the poisoned lane == the snapshot's "
          "lane and every other lane unchanged (bitwise)")
    print(f"[shell-b] poisoned lane {lane} quarantined at the next sweep and "
          f"restored from the committed snapshot in {t_q:.2f} s (host "
          "clock, the snapshot read included): lane == snapshot, others "
          "unchanged, bitwise")
    return state


# phase 11 (d): the fleet; (e): the launcher's sessions mode
FLEET_TENANTS, FLEET_POOL, FLEET_CAPS, FLEET_TICKS = 64, 16, (32, 1024), 832
FLEET_RETIRE_AT = 300
LAUNCH_SESSIONS, LAUNCH_STEPS = 64, 1100
SHELL_FAULT_RATE = 1e-3  # phase 11 (b): per lane-tick


def fleet_run():
    """Phase 11 (d): 64 classification tenants through a ``Fleet``
    (pools of 16 lanes, buckets 32 to 1024, so a tenant that passes 512
    points migrates 5 times), admitted two ticks apart; 8 retired and
    readmitted at tick 300 (a fresh lane). Every tick each admitted
    tenant observes a point of its own stream. 8 sampled tenants (4 of
    them readmitted) against dedicated one-lane engines: p-values
    bitwise, and one ``predict`` each. The migrations are counted
    exactly: one for each bucket bound a tenant's stint passes."""
    from repro_torch.serving import Fleet, ServingEngine
    from repro_torch.serving.fleet import pow2_buckets
    from repro_torch.telemetry import MetricsRegistry

    n, T = FLEET_TENANTS, FLEET_TICKS
    rng = np.random.default_rng(SEED + 11)
    X = rng.standard_normal((n, T, DIM), dtype=np.float32)
    Y = rng.integers(0, N_LABELS, (n, T), dtype=np.int32)
    X += Y[..., None]
    U = rng.random((n, T), dtype=np.float32)
    metrics = MetricsRegistry()
    fleet = Fleet(dim=DIM, k=K, n_labels=N_LABELS, cap_min=FLEET_CAPS[0],
                  cap_max=FLEET_CAPS[1], pool_sessions=FLEET_POOL,
                  metrics=metrics)
    sample = list(range(0, n, 4))[:8]
    retired = list(range(4, n, 8))
    refs = {i: ServingEngine(n_sessions=1, capacity=FLEET_CAPS[0], dim=DIM,
                             k=K, n_labels=N_LABELS, device="cuda")
            for i in sample}
    ref_st = {i: refs[i].init_state() for i in sample}
    got = {i: [] for i in sample}
    want = {i: [] for i in sample}
    pos = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(T):
        if t % 2 == 0 and t // 2 < n:
            fleet.admit(t // 2)
            pos[t // 2] = 0
        if t == FLEET_RETIRE_AT:
            for i in retired:
                fleet.retire(i)
                fleet.admit(i)
                pos[i] = 0
                if i in got:
                    got[i] = []
        items = {i: (X[i, j], Y[i, j], U[i, j]) for i, j in pos.items()}
        ps = fleet.observe(items)
        for i in sample:
            if i in pos:
                got[i].append(ps[i])
        for i in pos:
            pos[i] += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i in sample:  # each stream from its (re)admission
        for j in range(pos[i]):
            ref_st[i], p = refs[i].observe(ref_st[i], X[i, j][None],
                                           Y[i, j][None], U[i, j][None])
            want[i].append(p[0])
    same = all(torch.equal(torch.stack(got[i]), torch.stack(want[i]))
               for i in sample)
    Xq = torch.from_numpy(rng.standard_normal((QUERIES, DIM),
                                              dtype=np.float32)).cuda()
    reads = all(torch.equal(fleet.predict(i, Xq),
                            refs[i].predict(ref_st[i], Xq)[0])
                for i in sample)
    check(same and reads, "fleet tenants == dedicated one-lane engines "
          "(p-values and predict, bitwise)")
    mig = int(metrics.counter("fleet_migrations_total",
                              mode="classification").value)
    st = fleet.stats()
    bounds = pow2_buckets(*FLEET_CAPS)
    stints = [T - 2 * i for i in range(n) if i not in retired]
    stints += [T - FLEET_RETIRE_AT for _ in retired]
    stints += [FLEET_RETIRE_AT - 2 * i for i in retired]
    want_mig = sum(p > b for p in stints for b in bounds[:-1])
    check(st["buckets"] == bounds and mig == want_mig,
          f"migrations {mig} == {want_mig}, one a bound passed")
    served = sum(stints)
    print(f"[shell-d] fleet: {n} tenants ({len(retired)} retired and "
          f"readmitted at tick "
          f"{FLEET_RETIRE_AT}), pools of {FLEET_POOL}, buckets "
          f"{st['buckets']}, {len(st['pools'])} pools; {T} fleet ticks in "
          f"{wall:.2f} s ({T / wall:.1f} ticks/s, about {served / wall:.0f} "
          f"tenant-steps/s, host clock, synchronised at the ends), "
          f"{mig} migrations; {len(sample)} sampled tenants == dedicated "
          f"one-lane engines, bitwise")
    return fleet


def launcher_runs(root, W):
    """Phase 11 (e): the launcher's sessions mode with the shell's flags,
    both modes, at 64 tenants over 1,100 ticks, window = capacity W.
    Returns the launches of both runs, each read from the counters after
    its run (the launcher resets them after its warm-up tick)."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.telemetry import validate_trace_file

    counts = {}
    for mode, k in (("classification", K), ("regression", K_REG)):
        d = os.path.join(root, mode)
        m, tr = d + "-metrics.json", d + "-trace.jsonl"
        argv = ["--sessions", str(LAUNCH_SESSIONS), "--steps",
                str(LAUNCH_STEPS), "--window", str(W), "--capacity", str(W),
                "--dim", str(DIM), "--k", str(k),
                "--guard", "--snapshot-dir", d, "--faults", str(SEED),
                "--metrics-out", m, "--trace-out", tr]
        if mode == "regression":
            argv.append("--regression")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        for name, c in ops.launch_counts().items():
            counts[name] = counts.get(name, 0) + c
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        check(rc == 0 and "restore bit-exact" in text,
              f"launcher {mode} returned {rc}")
        metrics = {}
        for e in json.load(open(m))["metrics"]:
            metrics.setdefault(e["name"], []).append(e)
        rate = metrics["serve_session_steps_per_s"][0]["value"]
        ev = metrics["engine_evictions_total"][0]["value"]
        rej = sum(e["value"] for e in
                  metrics.get("guard_rejected_inputs_total", []))
        check(ev > 0 and rej > 0, f"launcher {mode}: evictions {ev}, "
              f"guard rejections {rej}")
        n_rec = len(validate_trace_file(tr))
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("[serve]") and "telemetry" not in ln
                 and "->" not in ln]
        print(f"[shell-e] launch.serve {mode}: rc 0 in {wall:.1f} s, "
              f"{rate:.0f} session-steps/s (its own gauge), evictions "
              f"{int(ev)}, guard rejections {int(rej)}, trace of {n_rec} "
              f"valid records; " + " | ".join(lines[-4:]))
    return counts


def same_bits(u, v) -> bool:
    """``torch.equal``, with NaN equal to NaN at the same places (a
    rejected lane's NaN features reach the tick kernel)."""
    if not u.is_floating_point():
        return torch.equal(u, v)
    nu, nv = u.isnan(), v.isnan()
    return torch.equal(nu, nv) and torch.equal(u.masked_fill(nu, 0),
                                               v.masked_fill(nv, 0))


def tick_equals_plain(rec, what, iters):
    """The ``stream_update`` launch recorded in ``rec`` against
    ``ref.stream_tick`` on copies of its own arguments: every output and
    every argument it updates in place, bitwise (NaN where NaN). Returns
    the kernel's ms there (CUDA events; ``iters=0``: not timed, None)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_update import stream_update

    a, kw = rec.args, rec.kw
    runs = []
    for fn in (stream_update, ref.stream_tick):
        args, kws = cloned(a), cloned(kw)
        runs.append([t for t in (*fn(*args, **kws), *args, *kws.values())
                     if torch.is_tensor(t)])
        del args, kws
    torch.cuda.synchronize()
    check(len(runs[0]) == len(runs[1]) and all(
        same_bits(u, v) for u, v in zip(*runs)),
        f"{what}: stream_update == ref.stream_tick bitwise on the tick's "
        "own arguments")
    del runs
    torch.cuda.empty_cache()
    if not iters:
        return None
    return cuda_ms(lambda: stream_update(*cloned(a), **cloned(kw)), iters)


def rejected_tick(xs, ys, taus, t, lanes):
    """Tick ``t`` of the classification traffic with four lanes made
    inadmissible, one of each fault: a NaN feature, an Inf feature, an
    out-of-range label, an out-of-range tau. Returns the one-tick chunk
    on the card."""
    x, y, tau = (np.array(v[t:t + 1]) for v in (xs, ys, taus))
    x[0, lanes[0], 3] = np.nan
    x[0, lanes[1], 0] = np.inf
    y[0, lanes[2]] = N_LABELS
    tau[0, lanes[3]] = 1.5
    return [torch.from_numpy(v).cuda() for v in (x, y, tau)]


def check_serving_shell_kernels(fleet, guard, gstate, bad, lanes, reg,
                                iters):
    """Phase 11's kernels against their plain versions on the path's own
    arguments (its launch counts already read): one more ``Fleet``
    observe of tenant 0, which migrated 5 times (its pool's tick: S 16,
    cap 1024, the non-evicting class form, wrap = cap); one more guarded
    one-tick chunk on the guard's S 1024 state with the four lanes of
    ``bad`` rejected (the evicting form; ``ev`` off on those lanes);
    each ``stream_update`` launch == ``ref.stream_tick`` bitwise. Then
    ``Fleet.predict``'s ``pairwise_sq_dists`` and ``cp_knn_counts``, and
    the restored regression engine's ``intervals``' ``pairwise_sq_dists``
    and ``interval_sweep``, each == plain, bitwise. Returns a note."""
    from repro_torch.robustness import REJECT_KINDS

    rng = np.random.default_rng(SEED + 13)
    x = rng.standard_normal(DIM, dtype=np.float32)
    with recorded("_stream_update") as rec:
        fleet.observe({0: (x, np.int32(1), np.float32(0.5))})
    a, kw = rec.args, rec.kw
    check(kw["mode"] == "class" and kw["ev"] is None
          and a[0].shape[:2] == (FLEET_POOL, FLEET_CAPS[1])
          and int(kw["wrap"].min()) == FLEET_CAPS[1],
          "fleet: a migrated tenant's pool launches the non-evicting class "
          f"form at S {FLEET_POOL}, cap {FLEET_CAPS[1]}, wrap = cap")
    ms = tick_equals_plain(rec, "fleet pool tick", iters)
    mig = sum(fleet.occupancy(0) > b for b in fleet.buckets[:-1])
    notes = [f"stream_update_class (fleet pool after {mig} migrations, "
             f"non-evicting, S={FLEET_POOL} cap={FLEET_CAPS[1]}) == "
             f"ref.stream_tick bitwise, {ms:.4f} ms there"]
    del rec, a, kw

    with recorded("_stream_update") as rec:
        gstate, _ = guard.observe_many(gstate, *bad)
    a, kw = rec.args, rec.kw
    rej = guard.drain()["rejected"]
    ev = kw["ev"]
    check(kw["mode"] == "class" and ev is not None
          and not bool(ev[lanes].any()) and int(ev.sum()) > 0
          and rej == dict(zip(REJECT_KINDS, [2, 1, 1])),
          f"guard: the one-tick chunk rejected {rej}, and its tick launched "
          "the evicting form with ev off on the rejected lanes")
    ms = tick_equals_plain(rec, "guarded tick", iters)
    notes.append(
        f"stream_update_class (guarded, evicting, lanes {lanes} rejected, "
        f"S={a[0].shape[0]} cap={a[0].shape[1]}) == ref.stream_tick "
        f"bitwise (NaN where NaN), {ms:.4f} ms there")
    del rec, a, kw, ev, gstate, guard
    torch.cuda.empty_cache()

    Xq = torch.from_numpy(rng.standard_normal((QUERIES, DIM),
                                              dtype=np.float32)).cuda()
    for name in ("sq_dists", "cp_knn_counts"):
        notes.append("Fleet.predict: " + check_read_kernel(
            name, lambda: fleet.predict(0, Xq), iters))
    eng, state = reg
    Xr = torch.from_numpy(rng.standard_normal(
        (state.D.shape[0], QUERIES, DIM), dtype=np.float32)).cuda()
    for name in ("sq_dists", "interval_sweep"):
        notes.append("restored regression intervals: " + check_read_kernel(
            name, lambda: eng.intervals(state, Xr, epsilon=EPS), iters))
    return "; ".join(notes)


def serving_shell_path(S, W, iters):
    """Phase 11: the serving shell at the main path's width (S tenants,
    window = capacity W, dim 30, k 15 / 7, the launcher's drift traffic).
    (a) instrumented == plain engines over W + 4 CHUNK ticks, the drained
    counters == the numpy closed form, an instrumented chunk without a
    host synchronisation; (b) the guard on chaos traffic (each lane-tick
    faulted with probability 1e-3) == the gated unguarded engine; (c) a
    snapshot round trip of each engine's full state through the
    ``AsyncShardedSaver`` and ``restore_engine`` on the card, and, with
    that store, a poisoned lane quarantined and restored; (d) the fleet;
    (e) the launcher with ``--guard --snapshot-dir --faults
    --metrics-out --trace-out``. The counts read, the path's kernels ==
    plain on its own arguments (``check_serving_shell_kernels``).
    Returns the phase's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import class_drift_traffic, reg_drift_traffic

    T = W + 4 * CHUNK
    t_phase = time.perf_counter()
    lane = S // 3
    bad_lanes = [1, S // 2, S - 2, S - 1]
    root = tempfile.mkdtemp()
    ops.reset_launch_counts()
    try:
        xs, ys, taus, _ = class_drift_traffic(SEED, S, T + 4 * CHUNK, DIM,
                                              2.0)
        eng, state = instrumented_run("classification", S, W, xs, ys, taus,
                                      T)
        guard, gstate = guard_run(eng, state, xs, ys, taus, T, 4)
        bad = rejected_tick(xs, ys, taus, T, bad_lanes)
        torch.cuda.empty_cache()
        state, store, snap_lane, _ = snapshot_roundtrip(
            "classification", eng, state, xs, ys, taus, T,
            os.path.join(root, "class"), lane)
        quarantine_restore(eng, state, store, snap_lane, lane)
        del eng, state, store
        shutil.rmtree(os.path.join(root, "class"))
        torch.cuda.empty_cache()

        xs, ys, taus, _, _ = reg_drift_traffic(SEED, S, T + 3 * CHUNK, DIM,
                                               2.0)
        eng, state = instrumented_run("regression", S, W, xs, ys, taus, T)
        _, _, _, restored = snapshot_roundtrip(
            "regression", eng, state, xs, ys, taus, T,
            os.path.join(root, "reg"), lane, keep_restored=True)
        del eng, state
        shutil.rmtree(os.path.join(root, "reg"))
        torch.cuda.empty_cache()

        fleet = fleet_run()
        counts = ops.launch_counts()
        for name, c in launcher_runs(root, W).items():
            counts[name] += c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("stream_update_class", "stream_update_reg",
                 "pairwise_sq_dists", "cp_knn_counts", "interval_sweep"):
        check(counts[name] > 0, f"{name} launched on the serving shell's "
              "path")
    print(f"[shell] phase 11 in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}")
    note = check_serving_shell_kernels(fleet, guard, gstate, bad, bad_lanes,
                                       restored, iters)
    print(f"[shell-k] {note}")
    return counts


# ---------------------------------------------------------------------------
# phase 12: trace replay and load generation; the invariant audit
# ---------------------------------------------------------------------------

REPLAY_OPS = 2176  # steady, predict_every 16: 2,048 observes, 128 reads
# each workload of step (b): 512 observes and 32 reads, so that each
# observe p99 rests on ~500 samples (1,024 and 64 until PR 30: the smoke's
# time). diurnal's ramp ends at ops / rate while its mean rate is half of
# rate, so about half its ops arrive at the 5 % floor after the ramp (~10
# ops / rate seconds): (b) replays its day
LOAD_OPS = 544
GATE_OPS = 272  # the bursty shed gates' prefix: 256 observes, 16 reads
# (e)'s prefix of the steady trace: 2 * CHUNK observes and 4 reads
PREFIX_OPS = 2 * CHUNK * 17 // 16
SLO_MS = 25.0  # benchmarks/replay_bench.py's default
SHED_DEPTH = 64
SHED_DEPTH_TIGHT = 8  # a depth bursts at 4x the service rate must exceed
REPLAY_FAULT_RATE = 1e-3
# at rate 1e-3 over REPLAY_OPS steps a plan stamps ~2 faults; seed 7 is
# the first that stamps duplicates, delays and value faults (seed 0
# stamps none), so every check of step (d) reads something
REPLAY_FAULT_SEED = 7
REPLAY_SHARDS = 4
# the launches of phase 12's replays (and its calibration), summed by
# ``counted``; the checks' own launches are not in it
REPLAY_LAUNCHES: dict = {}


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counts set to 0 just before and
    read just after, added to REPLAY_LAUNCHES."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn(*args, **kw)
    for name, c in ops.launch_counts().items():
        REPLAY_LAUNCHES[name] = REPLAY_LAUNCHES.get(name, 0) + c
    return out


def trace_ticks(records, S, kind):
    """The ticks of ``records``' observes as a replay synthesises them
    (``default_rng((SEED, seq, tick))``), made here anew: ``xs (T, S,
    DIM)``, ``ys``, ``taus``, ``active (T, S)`` numpy."""
    cols = []
    for r in records:
        if r["op"] != "observe":
            continue
        act = np.ones(S, bool)
        if "active" in r:
            act[:] = False
            act[r["active"]] = True
        for j in range(r.get("ticks", 1)):
            rng = np.random.default_rng((SEED, r["seq"], j))
            x = rng.standard_normal((S, DIM)).astype(np.float32)
            y = (rng.standard_normal(S).astype(np.float32)
                 if kind == "regression"
                 else (rng.random(S) < 0.5).astype(np.int32))
            cols.append((x, y, rng.random(S).astype(np.float32), act))
    return [np.stack(c) for c in zip(*cols)]


def direct_state(kind, S, W, records):
    """A plain engine driven with ``observe_many`` in CHUNK pieces on the
    records' ticks (reads leave the state as it is)."""
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.serving import ServingEngine

    kw = dict(n_sessions=S, capacity=W, window=W, dim=DIM, device="cuda")
    eng = (RegressionServingEngine(k=K_REG, **kw) if kind == "regression"
           else ServingEngine(k=K, n_labels=N_LABELS, **kw))
    state = eng.init_state()
    ticks = trace_ticks(records, S, kind)
    for c0 in range(0, ticks[0].shape[0], CHUNK):
        state, _ = eng.observe_many(state, *(
            torch.from_numpy(np.ascontiguousarray(v[c0:c0 + CHUNK])).cuda()
            for v in ticks))
    return state


def replay_at(records, kind, W, **kw):
    """``telemetry.replay`` of ``records`` on the card at the main path's
    width (window = capacity W), its launches counted."""
    from repro_torch.telemetry import replay

    return counted(replay, records, engine=kind, dim=DIM,
                   k=K_REG if kind == "regression" else K,
                   n_labels=N_LABELS, capacity=W, window=W, seed=SEED,
                   device="cuda", **kw)


def ms_pair(d, what="") -> str:
    return (f"{what}p50 {d['p50_s'] * 1e3:.3f} / p99 {d['p99_s'] * 1e3:.3f} "
            "ms")


def on_host(state):
    return [leaf.cpu() for leaf in state.leaves()]


def equal_host(state, host) -> bool:
    return all(torch.equal(a.cpu(), b) for a, b in zip(state.leaves(), host))


def replay_exactness(kind, S, W, iters):
    """Phase 12 (a) in one mode: the steady trace at speedup inf, chunk
    None == chunk CHUNK == the engine driven directly, bitwise. Returns
    the trace, the unchunked replay and the chunked one's report."""
    from repro_torch.telemetry import loadgen

    recs = loadgen.generate("steady", ops=REPLAY_OPS, tenants=S, capacity=W,
                            engine=kind, seed=SEED)
    n_obs = sum(r["op"] == "observe" for r in recs)
    read = "intervals" if kind == "regression" else "predict"
    a = replay_at(recs, kind, W)
    b = replay_at(recs, kind, W, chunk=CHUNK)
    check(equal_states(a.state, b.state), f"replay {kind}: chunk None == "
          f"chunk {CHUNK}, every leaf bitwise")
    rb = b.report
    del b
    torch.cuda.empty_cache()
    c = direct_state(kind, S, W, recs)
    check(equal_states(a.state, c), f"replay {kind} == the engine driven "
          "directly with observe_many on the same ticks, bitwise")
    del c
    torch.cuda.empty_cache()
    for rep in (a.report, rb):
        check(rep["ops_replayed"] == REPLAY_OPS and rep["ticks"] == n_obs
              and rep["session_steps"] == n_obs * S,
              f"replay {kind}: ops, ticks and session steps counted")
    xq = torch.from_numpy(np.random.default_rng((SEED, 1)).standard_normal(
        (4, DIM)).astype(np.float32)).cuda()
    if kind == "regression":
        notes = [check_read_kernel(n, lambda: a.engine.intervals(
            a.state, xq, EPS), iters) for n in ("sq_dists", "interval_sweep")]
    else:
        notes = [check_read_kernel(n, lambda: a.engine.predict(a.state, xq),
                                   iters)
                 for n in ("sq_dists", "cp_knn_counts")]
    ra = a.report
    print(f"[replay-a] {kind} S={S} w={W}: steady trace of {REPLAY_OPS} ops "
          f"({n_obs} observes, {REPLAY_OPS - n_obs} reads) at speedup inf: "
          f"chunk None == chunk {CHUNK} == direct observe_many, bitwise; "
          f"chunk None {ra['steps_per_s']:.0f} session-steps/s "
          f"({REPLAY_OPS / ra['wall_s']:.1f} ops/s), observe_many "
          f"{ms_pair(ra['per_op']['observe'])}, {read} "
          f"{ms_pair(ra['per_op'][read])}; chunk {CHUNK} "
          f"{rb['steps_per_s']:.0f} session-steps/s, observe_many "
          f"{ms_pair(rb['per_op']['observe'])}, {read} "
          f"{ms_pair(rb['per_op'][read])} (device-true: the engines "
          f"synchronise each timed operation); the read's kernels at its "
          f"shape: " + "; ".join(notes))
    return recs, a, rb


def workload_trace(w, S, W, rate):
    """Step (b)'s trace of workload ``w``: LOAD_OPS ops; diurnal's is its
    day, the records that arrive within its ramp's horizon, out of twice
    as many generated (the rest arrive at the 5 % floor after the ramp)."""
    from repro_torch.telemetry import loadgen

    ops = 2 * LOAD_OPS if w == "diurnal" else LOAD_OPS
    recs = loadgen.generate(w, ops=ops, tenants=S, capacity=W, rate=rate,
                            seed=SEED, slo_s=SLO_MS / 1e3)
    if w == "diurnal":
        recs = [r for r in recs if r["t"] <= ops / rate]
    return recs


def load_readings(S, W, rate):
    """Phase 12 (b): the four workloads on classification at speedup 1
    (readings), then the bursty gates: the first GATE_OPS ops shed at
    SHED_DEPTH and at SHED_DEPTH_TIGHT == unshed at speedup inf,
    bitwise."""
    from repro_torch.telemetry import loadgen

    bursty = None
    for w in loadgen.WORKLOADS:
        recs = workload_trace(w, S, W, rate)
        rep = replay_at(recs, "classification", W, speedup=1.0).report
        ob, rd = rep["per_op"]["observe"], rep["per_op"]["predict"]
        print(f"[replay-b] {w}{' (its day)' if w == 'diurnal' else ''}: "
              f"{len(recs)} ops ({ob['count']} observes, {rd['count']} "
              f"reads) at {rate:.1f} ops/s, "
              f"speedup 1: {rep['steps_per_s']:.0f} session-steps/s; "
              f"observe service p50 {ob['p50_s'] * 1e3:.3f} / p99 "
              f"{ob['p99_s'] * 1e3:.3f} ms, sojourn p50 "
              f"{ob['sojourn_p50_s'] * 1e3:.3f} / p99 "
              f"{ob['sojourn_p99_s'] * 1e3:.3f} ms; predict service p50 "
              f"{rd['p50_s'] * 1e3:.3f} / p99 {rd['p99_s'] * 1e3:.3f} ms, "
              f"sojourn p50 {rd['sojourn_p50_s'] * 1e3:.3f} / p99 "
              f"{rd['sojourn_p99_s'] * 1e3:.3f} ms; queue depth max "
              f"{rep['queue_depth_max']:.0f}; SLO {SLO_MS:g} ms violated by "
              f"{rep['slo_violation_frac']:.4f} of ops (readings)")
        if w == "bursty":
            bursty = recs[:GATE_OPS]
        torch.cuda.empty_cache()
    fast = replay_at(bursty, "classification", W).state
    for depth in (SHED_DEPTH, SHED_DEPTH_TIGHT):
        shed = replay_at(bursty, "classification", W, speedup=1.0,
                         shed_depth=depth)
        check(equal_states(fast, shed.state), f"bursty shed at depth "
              f"{depth} (speedup 1) == unshed at speedup inf, bitwise")
        rep = shed.report
        del shed
        torch.cuda.empty_cache()
        print(f"[replay-b] bursty's first {GATE_OPS} ops shed at depth "
              f"{depth}, speedup 1: "
              f"{rep['shed_ops']} read(s) shed, {rep['deferred_observes']} "
              f"observe(s) deferred, queue depth max "
              f"{rep['queue_depth_max']:.0f}, SLO violated by "
              f"{rep['slo_violation_frac']:.4f}; state == unshed at "
              f"speedup inf, bitwise")
    check(rep["shed_ops"] + rep["deferred_observes"] > 0,
          f"depth {SHED_DEPTH_TIGHT}: the bursts shed or defer")
    del fast
    torch.cuda.empty_cache()


def fault_schedule(S, W):
    """Phase 12 (d): duplicate and delay stamps on the steady trace:
    dedup == the never-duplicated trace, bitwise; then value faults under
    the guard: rejections by kind == the stamps, no NaN in the state."""
    from repro_torch.robustness import VALUE_FAULTS, FaultPlan
    from repro_torch.telemetry import loadgen

    kinds = ("duplicate_arrival", "delay")
    plan = FaultPlan.random(REPLAY_FAULT_SEED, steps=REPLAY_OPS, tenants=S,
                            rate=REPLAY_FAULT_RATE, kinds=kinds, param=1e-3)
    stamped = loadgen.generate("steady", ops=REPLAY_OPS, tenants=S,
                               capacity=W, seed=SEED, faults=plan)

    def is_dup(r):
        return r.get("fault", {}).get("kind") == "duplicate_arrival"

    n_dup = sum(map(is_dup, stamped))
    n_delay = sum("delay_s" in r for r in stamped)
    check(n_dup > 0 and n_delay > 0, "the plan stamps duplicates and delays")
    dd = replay_at(stamped, "classification", W, chunk=CHUNK)
    check(dd.report["duplicates_dropped"] == n_dup,
          f"duplicates dropped {dd.report['duplicates_dropped']} == the "
          f"{n_dup} stamped")
    never = replay_at([r for r in stamped if not is_dup(r)],
                      "classification", W, chunk=CHUNK).state
    check(equal_states(dd.state, never), "deduplicated replay == the "
          "never-duplicated trace's, bitwise")
    del dd, never
    torch.cuda.empty_cache()
    plan = FaultPlan.random(REPLAY_FAULT_SEED, steps=REPLAY_OPS, tenants=S,
                            rate=REPLAY_FAULT_RATE,
                            kinds=VALUE_FAULTS + kinds, param=1e-3)
    stamped = loadgen.generate("steady", ops=REPLAY_OPS, tenants=S,
                               capacity=W, seed=SEED, faults=plan)
    faults = [r["fault"]["kind"] for r in stamped
              if r.get("fault", {}).get("kind") in VALUE_FAULTS]
    check(faults, "the plan stamps value faults")
    gd = replay_at(stamped, "classification", W, chunk=CHUNK, guard=True)
    want = {"nonfinite_feature": sum(f in ("nan_feature", "inf_feature")
                                     for f in faults),
            "label_out_of_range": faults.count("label_out_of_range"),
            "tau_out_of_range": faults.count("tau_out_of_range")}
    g = gd.report["guard"]
    check(g["rejected"] == want, f"guard rejections {g['rejected']} == the "
          f"stamped value faults {want}")
    check(not any(bool(leaf.isnan().any()) for leaf in gd.state.leaves()
                  if leaf.is_floating_point()), "no state leaf holds a NaN")
    print(f"[replay-d] FaultPlan seed {REPLAY_FAULT_SEED} at rate "
          f"{REPLAY_FAULT_RATE:g}: {n_dup} duplicate(s) and {n_delay} "
          f"delay(s) stamped; dropped {n_dup}, state == the "
          f"never-duplicated trace's, bitwise; with value faults "
          f"{sorted(faults)} under the guard: rejected {g['rejected']}, "
          f"{g['quarantines']} quarantine(s), no NaN in the state")
    del gd
    torch.cuda.empty_cache()


def sharded(recs, S, W, iters):
    """Phase 12 (e): REPLAY_SHARDS per-shard engines on the one card over
    the first PREFIX_OPS ops of (a)'s trace (2 * CHUNK ticks): the
    concatenated state == the unsharded replay's of the same ops, bitwise,
    the merged counters == the unsharded, and a shard's tick kernel ==
    plain on its own arguments."""
    pre = recs[:PREFIX_OPS]
    one = replay_at(pre, "classification", W, chunk=CHUNK)
    sh = replay_at(pre, "classification", W, chunk=CHUNK,
                   shards=REPLAY_SHARDS)
    check(equal_states(sh.state, one.state), f"{REPLAY_SHARDS} shards: the "
          "concatenated state == the unsharded replay's, bitwise")
    for op in ("observe", "predict"):
        got = sh.metrics.counter("replay_ops_total", op=op).value
        want = one.metrics.counter("replay_ops_total", op=op).value
        check(got == want == sum(r["op"] == op for r in pre),
              f"merged replay_ops_total{{op={op}}} {got} == the unsharded "
              f"{want}")
    got, want = (r.metrics.counter("engine_ticks_total",
                                   engine="classification").value
                 for r in (sh, one))
    check(got == want, f"merged engine_ticks_total {got} == the unsharded "
          f"{want}")
    del one
    st0 = type(sh.state).from_leaves(
        [leaf[:S // REPLAY_SHARDS].clone() for leaf in sh.state.leaves()])
    x, y, tau, _ = trace_ticks(pre[-2:], S, "classification")
    with recorded("_stream_update") as rec:
        sh.engine[0].observe_many(st0, *(torch.from_numpy(
            v[:1, :S // REPLAY_SHARDS]).cuda() for v in (x, y, tau)))
    tick_ms = tick_equals_plain(rec, "a shard's tick", iters)
    print(f"[replay-e] {REPLAY_SHARDS} shards x {S // REPLAY_SHARDS} "
          f"tenants over the trace's first {PREFIX_OPS} ops: concatenated "
          f"state == the unsharded replay's, bitwise; merged "
          f"replay_ops_total and engine_ticks_total == the unsharded; a "
          f"shard's stream_update (S={S // REPLAY_SHARDS}) == "
          f"ref.stream_tick bitwise, {tick_ms:.4f} ms there (beside (f) "
          f"and (g))")
    del sh, st0, rec
    torch.cuda.empty_cache()


def launcher_argv(root, W, rate):
    """Phase 12 (f)'s ``launch.serve --replay loadgen:bursty --auto-tune
    --shed-depth`` at LAUNCH_SESSIONS tenants over LAUNCH_STEPS ops, and
    its trace's path."""
    tpath = os.path.join(root, "trace.jsonl")
    argv = ["--replay", "loadgen:bursty", "--sessions", str(LAUNCH_SESSIONS),
            "--steps", str(LAUNCH_STEPS), "--capacity", str(W), "--window",
            str(W), "--dim", str(DIM), "--k", str(K), "--speedup", "1",
            "--rate", f"{rate:.3f}", "--slo-ms", f"{SLO_MS:g}",
            "--auto-tune", "--shed-depth", str(SHED_DEPTH), "--metrics-out",
            os.path.join(root, "metrics.json"), "--trace-out", tpath]
    return argv, tpath


def launcher_checked(proc, argv, tpath):
    """Phase 12 (f): the launcher exited 0 and its trace is valid."""
    from repro_torch.telemetry import validate_trace_file

    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"launch.serve --replay exited "
          f"{proc.returncode}: {err[-2000:]}")
    n_rec = len(validate_trace_file(tpath))
    lines = [ln.strip() for ln in out.splitlines()
             if ln.startswith(("[serve]", "  observe", "  predict", "  SLO",
                               "  queue", "  shed"))
             and not ln.startswith(("[serve] metrics ->", "[serve] trace ->",
                                    "[serve] telemetry"))]
    print(f"[replay-f] launch.serve {' '.join(argv[:-4])}: rc 0, its trace "
          f"of {n_rec} records valid (beside (d), (e) and (g), so its times "
          "are no readings); " + " | ".join(lines))


def replay_path(S, W, iters):
    """Phase 12: trace replay and load generation at the main path's
    width (S tenants, window = capacity W, dim 30, k 15 / 7). (a) steady
    trace, both modes: chunk None == chunk CHUNK == direct, bitwise; (b)
    the four workloads at speedup 1 and half (a)'s classification rate,
    and the bursty shed gates; (c) ``calibrate_engine`` -> ``CostModel``
    -> ``suggest_chunk``, that chunk's replay == (a)'s; (d) duplicate and
    delay stamps: dedup == never-duplicated, and value faults under the
    guard: rejections == stamps, no NaN; (e) REPLAY_SHARDS per-shard
    engines: concatenated == unsharded, merged counters == unsharded;
    (f) the launcher's replay mode and (g) the audit on the card, each in
    a subprocess beside (d) and (e), which take no readings. Returns the
    launches of the replays and the calibration, no check's."""
    from repro_torch.telemetry import (CostModel, calibrate_engine,
                                       capacity_bucket)

    t_phase = time.perf_counter()
    laps, last = {}, [t_phase]

    def lap(step):
        now = time.perf_counter()
        laps[step], last[0] = round(now - last[0], 1), now

    REPLAY_LAUNCHES.clear()
    for kind in ("regression", "classification"):
        recs, a, rb = replay_exactness(kind, S, W, iters)
        if kind == "regression":
            del recs, a
            torch.cuda.empty_cache()
    ops_s = REPLAY_OPS / a.report["wall_s"]
    ref_host = on_host(a.state)
    del a
    torch.cuda.empty_cache()

    lap("a")
    rate = ops_s / 2
    load_readings(S, W, rate)
    lap("b")

    # (c) the cost model's chunk
    t0 = time.perf_counter()
    cal = counted(calibrate_engine, "classification", tenants=S,
                  capacity=W, window=W, dim=DIM, k=K, seed=SEED,
                  device="cuda")
    model = CostModel.fit(cal, source="calibrate")
    chunk = model.suggest_chunk(cap_bucket=capacity_bucket(W),
                                engine="classification")
    e = model.entries[("classification", "observe_many",
                       capacity_bucket(W))]
    cal_s = time.perf_counter() - t0
    auto = replay_at(recs, "classification", W, chunk=chunk)
    check(equal_host(auto.state, ref_host), f"replay at the suggested chunk "
          f"{chunk} == (a), bitwise")
    ra = auto.report
    print(f"[replay-c] calibrate_engine ({len(cal)} records, {cal_s:.1f} "
          f"s) -> CostModel a {e['a'] * 1e3:.4f} ms + b {e['b'] * 1e3:.4f} "
          f"ms a tick -> suggest_chunk {chunk}; the steady trace at that "
          f"chunk == (a) bitwise (runs are at most 16 observes between "
          f"reads); session-steps/s hand chunk {CHUNK}: "
          f"{rb['steps_per_s']:.0f}, auto chunk {chunk}: "
          f"{ra['steps_per_s']:.0f}, auto / hand "
          f"{ra['steps_per_s'] / rb['steps_per_s']:.4f}")
    del auto, ref_host
    torch.cuda.empty_cache()
    lap("c")

    # (d) and (e), while (f) the launcher and (g) the audit run in their
    # own processes
    root = tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    apath = os.path.join(root, "audit.json")
    argv, tpath = launcher_argv(root, W, rate)
    t_sub = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=env)
             for module, args in (
                 ("repro_torch.analysis.audit",
                  ["--device", "cuda", "--out", apath]),
                 ("repro_torch.launch.serve", argv))]
    audit, launcher = procs
    try:
        fault_schedule(S, W)
        lap("d")
        sharded(recs, S, W, iters)
        lap("e")
        launcher_checked(launcher, argv, tpath)
        a_out, a_err = audit.communicate(timeout=300)
        check(audit.returncode == 0, f"the audit on the card exited "
              f"{audit.returncode}: {a_out[-3000:]} {a_err[-2000:]}")
        report = json.load(open(apath))
        check(report["ok"] and report["summary"]["fail"] == 0,
              "the audit passes")
        print(f"[replay-g] python -m repro_torch.analysis.audit --device "
              f"cuda (beside (d), (e) and (f)): rc 0, done "
              f"{time.perf_counter() - t_sub:.1f} s after (d) began; "
              f"{a_out.splitlines()[0]}")
        lap("f, g")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    counts = dict(REPLAY_LAUNCHES)
    print(f"[replay] phase 12 in {time.perf_counter() - t_phase:.1f} s "
          f"(by step, s: {laps}); the replays' launches {counts}")
    for name in ("stream_update_class", "stream_update_reg",
                 "pairwise_sq_dists", "cp_knn_counts", "interval_sweep"):
        check(counts[name] > 0, f"{name} launched on the replay path")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the MoE and MLA families at full width, the depth cut
# ---------------------------------------------------------------------------

# (arch, layers kept): full width in bf16, the depth cut so that the
# weights and an embedding pass of FAM_CALIB x FAM_SEQ tokens fit the card
FAMILY_CUTS = (("deepseek-v2-236b", 4), ("mixtral-8x22b", 6),
               ("granite-34b", 24))
FAM_CALIB, FAM_SEQ, FAM_REQUESTS, FAM_PROMPT, FAM_GEN = 128, 512, 8, 64, 8
FAM_CHECK_LAYERS, FAM_DECODE_CHECK = 2, (2, 64)  # f32 checks: depth, (B, S)
# f32 sequences for the route check; deepseek's lossless expert inputs are
# (160, T, 5120), 6.7 GB at T = 4 x 512
FAM_CHECK_BATCH = {"deepseek-v2-236b": 4}
ROUTER_TIE = 1e-5  # K-th and (K+1)-th router probabilities this close
FAM_REDUCED = False  # a CPU rehearsal cuts the reduced configs instead


class routing:
    """Inside the block, each ``mlp.route`` call (``models/mlp.py``'s MoE
    looks it up at call time) records its top-K experts ``(T, K)`` and
    each token's gap between its K-th and (K+1)-th router probabilities
    ``(T,)``, in ``calls``."""

    def __enter__(self):
        from repro_torch.models import mlp

        self._mod, self._kept, self.calls = mlp, mlp.route, []

        def recorded(p, xt, K):
            probs, top_p, top_e = self._kept(p, xt, K)
            top = torch.topk(probs, K + 1, dim=-1).values
            self.calls.append((top_e, top[:, K - 1] - top[:, K]))
            return probs, top_p, top_e

        mlp.route = recorded
        return self

    def __exit__(self, *exc):
        self._mod.route = self._kept


def decode_routing(calls, n_moe: int, B: int, S: int) -> list:
    """A decode run's routing (S steps of ``n_moe`` calls on ``B`` tokens)
    as one ``(top_e (B * S, K), gap (B * S,))`` a MoE layer, tokens
    sequence-major as a full pass holds them."""
    out = []
    for j in range(n_moe):
        steps = calls[j::n_moe]
        check(len(steps) == S, f"decode routing: {len(steps)} steps of {S}")
        out.append((torch.stack([c[0] for c in steps], 1).reshape(B * S, -1),
                    torch.stack([c[1] for c in steps], 1).reshape(B * S)))
    return out


def routing_flips(a, b, B: int, dev):
    """Two runs' routing, one ``(top_e, gap)`` a MoE layer, tokens
    sequence-major. Returns ``(flipped (B,), near (B,), unexplained)``:
    the sequences holding a token the runs route to another set of
    experts (the order inside the top K does not matter at lossless
    capacity: the combine adds in expert order), those holding a near-tie
    token (``gap <= ROUTER_TIE`` in either run), and the count of tokens
    routed differently that are no near-tie."""
    check(len(a) == len(b), f"routing: {len(a)} MoE calls against {len(b)}")
    flipped = torch.zeros(B, dtype=torch.bool, device=dev)
    near = torch.zeros(B, dtype=torch.bool, device=dev)
    unexplained = 0
    for (ea, ga), (eb, gb) in zip(a, b):
        diff = (ea.sort(1).values != eb.sort(1).values).any(1)
        tie = (ga <= ROUTER_TIE) | (gb <= ROUTER_TIE)
        unexplained += int((diff & ~tie).sum())
        flipped |= diff.view(B, -1).any(1)
        near |= tie.view(B, -1).any(1)
    return flipped, near, unexplained


def family_kinds(cfg) -> str:
    """``deepseek-v2-236b``'s ``dense_ffn_attn + 3 attn (MLA, MoE 160
    top-6 + 2 shared)``-style summary of a cut."""
    runs = {}
    for kind in cfg.pattern:
        runs[kind] = runs.get(kind, 0) + 1
    parts = [" + ".join(f"{n} {k}" for k, n in runs.items())]
    if cfg.mla is not None:
        m = cfg.mla
        parts.append(f"MLA q {m.qk_nope_head_dim} + {m.qk_rope_head_dim}, "
                     f"v {m.v_head_dim}, kv_lora {m.kv_lora_rank}")
    else:
        parts.append(f"GQA {cfg.n_heads}/{cfg.n_kv_heads} x "
                     f"{cfg.resolved_head_dim}"
                     + (f", window {cfg.window}" if cfg.window else ""))
    mo = cfg.moe
    if mo.n_experts:
        parts.append(f"MoE {mo.n_experts} x {mo.d_ff} top-"
                     f"{mo.n_experts_per_token}"
                     + (f" + {mo.n_shared_experts} shared"
                        if mo.n_shared_experts else "")
                     + f", capacity {mo.capacity_factor}")
    else:
        parts.append(f"SwiGLU {cfg.d_ff}")
    return "; ".join(parts)


def family_run(arch: str, layers: int, dev="cuda"):
    """Phase 13 for one arch. Returns the main path's launch counts."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.lm_conformal import (ConformalOodDetector,
                                              hidden_states)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    t_arch = time.perf_counter()
    full = configs.get(arch)
    cut = dict(n_layers=layers, layer_pattern=full.pattern[:layers])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (cfg, params), init_ms = timed_ms(
        lambda: serve.lm_model(arch, FAM_REDUCED, SEED, dev, **cut))
    n_par = sum(t.numel() for t in params.parameters())
    calib = serve.stream_tokens(cfg, FAM_CALIB, FAM_SEQ, SEED, 0, dev)
    held = serve.stream_tokens(cfg, FAM_CALIB, FAM_SEQ, SEED, 1, dev)
    req = serve.request_tokens(cfg, FAM_REQUESTS, FAM_SEQ, SEED, dev)

    # ---- the main path (counted) ------------------------------------------
    ops.reset_launch_counts()
    emb, emb_ms = timed_ms(lambda: serve.embed(params, cfg, calib))
    ood, fit_ms = timed_ms(
        lambda: ConformalOodDetector(k=LM_K, device=dev).fit(emb))
    held_emb, held_ms = timed_ms(lambda: serve.embed(params, cfg, held))
    p_held, pv_ms = timed_ms(lambda: ood.pvalues(held_emb))
    req_emb, req_ms = timed_ms(lambda: serve.embed(params, cfg, req))
    p_req = ood.pvalues(req_emb)
    gen, dec_ms = timed_ms(lambda: serve.generate(
        params, cfg, req[:, :FAM_PROMPT], FAM_GEN))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] {cfg.name}: {layers} of {full.n_layers} layers ("
          f"{family_kinds(cfg)}), d {cfg.d_model}, {cfg.n_heads} heads ("
          f"{cfg.n_kv_heads} kv) x {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, {n_par / 1e9:.3f} B parameters "
          f"({n_par * 2 / 2**30:.1f} GiB; the whole model "
          f"{full.n_params() / 1e9:.1f} B), init {init_ms / 1e3:.2f} s, "
          f"peak {peak / 2**30:.2f} GiB")
    steps = FAM_PROMPT + FAM_GEN
    print(f"[fam-main] {cfg.name}: embedding pass {FAM_CALIB} x {FAM_SEQ}: "
          f"calibration {emb_ms:.1f} ms, held-out {held_ms:.1f} ms "
          f"({FAM_CALIB * FAM_SEQ / held_ms * 1e3:.0f} tok/s); OOD fit "
          f"{fit_ms:.3f} ms, p-values of {FAM_CALIB} {pv_ms:.3f} ms; "
          f"{FAM_REQUESTS} requests x {FAM_SEQ} embedded in {req_ms:.1f} ms; "
          f"{FAM_REQUESTS} x ({FAM_PROMPT} prompt + {FAM_GEN} generated) by "
          f"decode steps in {dec_ms:.1f} ms ({steps / dec_ms * 1e3:.1f} "
          f"steps/s) (host clock, synchronised); launches {counts}")
    check(counts["flash_attention"] == 3 * cfg.n_layers,
          f"{arch}: flash_attention once per attention layer per pass")
    check(sum(counts.values()) == counts["flash_attention"],
          f"{arch}: no other kernel on the LM path")
    check(emb.shape == (FAM_CALIB, cfg.d_model)
          and emb.dtype == lm.dtype_of(cfg.dtype)
          and bool(torch.isfinite(emb).all()), f"{arch}: finite embeddings")
    check(gen.shape == (FAM_REQUESTS, FAM_GEN) and bool(
        ((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{arch}: generated tokens")
    for p in (p_held, p_req):
        check(bool(((p > 0) & (p <= 1)).all()), f"{arch}: p-values in (0, 1]")

    # ---- validity (binding) and power (a reading) --------------------------
    ph, pr = p_held.cpu().numpy(), p_req.cpu().numpy()
    share, mean_p = float((ph <= EPS).mean()), float(ph.mean())
    half = FAM_REQUESTS // 2
    print(f"[fam-valid] {cfg.name}: held-out ({FAM_CALIB}, same batch size "
          f"as the calibration): share p <= {EPS} {share:.4f} (<= 0.18), "
          f"mean p {mean_p:.4f} (in [0.40, 0.60]); requests of another "
          f"seed's stream: mean p {pr[:half].mean():.4f}; uniform-token "
          f"requests: mean p {pr[half:].mean():.4f} (power, a reading)")
    check(share <= 0.18, f"{arch}: held-out share with p <= {EPS}: {share}")
    check(0.40 <= mean_p <= 0.60, f"{arch}: held-out mean p {mean_p}")

    # ---- determinism: two more calibration passes, bitwise ----------------
    h1 = hidden_states(params, cfg, {"tokens": calib})
    h2 = hidden_states(params, cfg, {"tokens": calib})
    same = torch.equal(h1, h2) and torch.equal(
        torch.mean(h1, dim=1, dtype=torch.float32).to(h1.dtype), emb)
    check(same, f"{arch}: calibration passes bitwise equal")
    del h1, h2

    # ---- one decode step without a host synchronisation --------------------
    cache = lm.init_cache(cfg, FAM_REQUESTS, 2, dev)
    lm.decode_step(params, cfg, req[:, :1], cache, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_logits, _ = lm.decode_step(params, cfg, req[:, 1:2], cache, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(step_logits).all()),
          f"{arch}: finite decode logits")
    print(f"[fam-det] {cfg.name}: three calibration passes bitwise equal "
          f"(hidden states {FAM_CALIB} x {FAM_SEQ} x {cfg.d_model}); one "
          f"decode step ({FAM_REQUESTS} sequences) under "
          "set_sync_debug_mode(\"error\"): no host synchronisation")
    del params, cache, step_logits, emb, held_emb, req_emb, ood
    torch.cuda.empty_cache()

    # ---- f32, full width, FAM_CHECK_LAYERS layers (binding) ----------------
    kw32 = dict(n_layers=FAM_CHECK_LAYERS,
                layer_pattern=full.pattern[:FAM_CHECK_LAYERS],
                dtype="float32", param_dtype="float32")
    mo = cfg.moe
    if mo.n_experts:  # lossless: cap = T, no token drops
        kw32["moe"] = dataclasses.replace(
            mo, capacity_factor=mo.n_experts / mo.n_experts_per_token)
    cfg32, p32 = serve.lm_model(arch, FAM_REDUCED, SEED, dev, **kw32)
    B = FAM_CHECK_BATCH.get(arch, 8)
    toks = calib[:B]
    runs = {}
    for route in ("kernel", "plain"):
        with (plain_attention() if route == "plain" else nullcontext()), \
                routing() as r:
            runs[route] = (serve.embed(p32, cfg32, toks), r.calls)
    flipped, near, unexplained = routing_flips(runs["kernel"][1],
                                               runs["plain"][1], B, dev)
    check(unexplained == 0, f"{arch}: {unexplained} tokens routed apart by "
          "the two attention routes without a router near-tie")
    keep = ~flipped
    check(bool(keep.any()), f"{arch}: every sequence routed apart")
    gap = rel_gap(runs["kernel"][0][keep], runs["plain"][0][keep])
    check(gap <= 1e-5, f"{arch}: f32 kernel route == plain route within "
          f"1e-5 of the RMS: {gap}")
    del runs
    Bd, Sd = FAM_DECODE_CHECK
    td = calib[:Bd, :Sd]
    with routing() as rf:
        fwd = lm.forward(p32, cfg32, {"tokens": td})
    cache = lm.init_cache(cfg32, Bd, Sd, dev)
    with routing() as rd:
        dec = torch.stack([lm.decode_step(p32, cfg32, td[:, i:i + 1], cache,
                                          i)[0][:, 0] for i in range(Sd)], 1)
    d_flip, d_near, d_unexpl = routing_flips(
        rf.calls, decode_routing(rd.calls, len(rf.calls), Bd, Sd), Bd, dev)
    check(d_unexpl == 0, f"{arch}: {d_unexpl} tokens routed apart by decode "
          "and forward without a router near-tie")
    kd = ~d_flip
    check(bool(kd.any()), f"{arch}: every decode sequence routed apart")
    dec_err = float((dec[kd] - fwd[kd]).abs().max())
    check(torch.allclose(dec[kd], fwd[kd], atol=1e-3, rtol=1e-3),
          f"{arch}: decode == forward within 1e-3: {dec_err}")
    print(f"[fam-exact] {cfg.name} f32, {FAM_CHECK_LAYERS} layers at full "
          f"width{' (MoE lossless, capacity E/K)' if mo.n_experts else ''}: "
          f"kernel route == plain route "
          f"over {B} x {FAM_SEQ} tokens, embeddings within {gap:.3g} of "
          f"their RMS (<= 1e-5) on {int(keep.sum())} of {B} sequences "
          f"({int(flipped.sum())} routed apart, each flip at a near-tie; "
          f"{int(near.sum())} hold a near-tie token, gap <= {ROUTER_TIE}); "
          f"teacher-forced decode == forward over {Bd} x {Sd} tokens, max "
          f"abs err {dec_err:.3g} (1e-3) on {int(kd.sum())} of {Bd} "
          f"sequences ({int(d_flip.sum())} routed apart, "
          f"{int(d_near.sum())} with a near-tie); "
          f"{time.perf_counter() - t_arch:.1f} s for {cfg.name}")
    del p32, cache, fwd, dec
    torch.cuda.empty_cache()
    return counts


def families_path(dev="cuda"):
    """Phase 13: each of ``FAMILY_CUTS`` in turn, each model freed before
    the next loads. Returns the main paths' launch counts, summed."""
    t_phase = time.perf_counter()
    total = {}
    for arch, layers in FAMILY_CUTS:
        for name, n in family_run(arch, layers, dev).items():
            total[name] = total.get(name, 0) + n
    print(f"[fam] phase 13 in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


# ---------------------------------------------------------------------------
# phase 14: the recurrent and front-end families at full width and depth
# ---------------------------------------------------------------------------

# (arch, layers of the f32 checks; None: all). recurrentgemma's first two
# layers are rglru and its third attn_local; xlstm's sixth is its first
# slstm; whisper is small enough to check whole (6 encoder + 6 decoder)
FRONT_CHECKS = (("recurrentgemma-9b", 3), ("xlstm-125m", 6),
                ("whisper-base", None), ("internvl2-26b", 2))
# teacher-forced decode == forward over (B, S): S past one 256-step chunk
# of the RG-LRU scan and the mLSTM, so the carry across chunks is held too
FRONT_DECODE_CHECK = (2, 300)
FRONT_REDUCED = False  # a CPU rehearsal runs the reduced configs instead


def front_batch(cfg, B: int, dev) -> dict:
    """Batch 0 of ``TokenStream(SEED)`` with its front-end stub inputs on
    ``dev``: internvl's text (``FAM_SEQ`` minus the patches) and
    ``patch_embeds``, whisper's tokens and 1,500 ``frames``."""
    from repro_torch.data.lm_pipeline import TokenStream

    out = TokenStream(cfg, B, FAM_SEQ, seed=SEED).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()
            if k != "labels"}


def front_route_gaps(fn) -> tuple:
    """``fn()`` (a ``(B, S, ...)`` output) by the kernel route against the
    plain route, in units of the plain output's RMS (``rel_gap``): of the
    means over the sequence, as the served embedding pools it (the gate),
    and element by element (a reading: the largest of millions of
    elements, each a few roundings apart). Both outputs must be
    finite."""
    got = fn()
    with plain_attention():
        want = fn()
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "finite outputs on both routes")
    return (rel_gap(got.mean(dim=1), want.mean(dim=1)),
            rel_gap(got, want))


def front_run(arch: str, check_layers, dev="cuda"):
    """Phase 14 for one arch. Returns the main path's launch counts."""
    from repro_torch import configs
    from repro_torch.core.lm_conformal import (ConformalOodDetector,
                                              hidden_states)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    t_arch = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (cfg, params), init_ms = timed_ms(
        lambda: serve.lm_model(arch, FRONT_REDUCED, SEED, dev))
    n_par = sum(t.numel() for t in params.parameters())
    calib = serve.stream_tokens(cfg, FAM_CALIB, FAM_SEQ, SEED, 0, dev)
    held = serve.stream_tokens(cfg, FAM_CALIB, FAM_SEQ, SEED, 1, dev)
    req = serve.request_tokens(cfg, FAM_REQUESTS, FAM_SEQ, SEED, dev)
    frames = serve.request_frames(cfg, FAM_REQUESTS, FAM_SEQ, SEED, dev)

    # ---- the main path (counted) ------------------------------------------
    ops.reset_launch_counts()
    emb, emb_ms = timed_ms(lambda: serve.embed(params, cfg, calib))
    ood, fit_ms = timed_ms(
        lambda: ConformalOodDetector(k=LM_K, device=dev).fit(emb))
    held_emb, held_ms = timed_ms(lambda: serve.embed(params, cfg, held))
    p_held, pv_ms = timed_ms(lambda: ood.pvalues(held_emb))
    req_emb, req_ms = timed_ms(lambda: serve.embed(params, cfg, req))
    p_req = ood.pvalues(req_emb)
    gen, dec_ms = timed_ms(lambda: serve.generate(
        params, cfg, req[:, :FAM_PROMPT], FAM_GEN, frames))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = FAM_PROMPT + FAM_GEN
    n_attn = sum(kind in ("attn", "attn_local") for kind in cfg.pattern)
    want = 3 * n_attn  # self-attention, one launch a layer a pass
    if cfg.is_encoder_decoder:  # the encoder once, cross-attention a step
        want += cfg.n_encoder_layers + steps * cfg.n_layers
    kinds = {k: cfg.pattern.count(k) for k in dict.fromkeys(cfg.pattern)}
    text = calib.shape[1]
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers ("
          + " + ".join(f"{n} {k}" for k, n in kinds.items())
          + (f"; encoder {cfg.n_encoder_layers} attn over "
             f"{cfg.n_frontend_tokens} frames" if cfg.is_encoder_decoder
             else "")
          + f"), d {cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv) "
          f"x {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{n_par / 1e9:.3f} B parameters ({n_par * 2 / 2**30:.1f} GiB), "
          f"init {init_ms / 1e3:.2f} s, peak {peak / 2**30:.2f} GiB")
    print(f"[front-main] {cfg.name}: embedding pass {FAM_CALIB} x {text} "
          f"tokens: calibration {emb_ms:.1f} ms, held-out {held_ms:.1f} ms "
          f"({FAM_CALIB * text / held_ms * 1e3:.0f} tok/s); OOD fit "
          f"{fit_ms:.3f} ms, p-values of {FAM_CALIB} {pv_ms:.3f} ms; "
          f"{FAM_REQUESTS} requests x {req.shape[1]} embedded in "
          f"{req_ms:.1f} ms; {FAM_REQUESTS} x ({FAM_PROMPT} prompt + "
          f"{FAM_GEN} generated) by decode steps"
          + (" after the encoder pass" if frames is not None else "")
          + f" in {dec_ms:.1f} ms ({steps / dec_ms * 1e3:.1f} steps/s) "
          f"(host clock, synchronised); launches {counts}")
    check(counts["flash_attention"] == want,
          f"{arch}: flash_attention {counts['flash_attention']} launches, "
          f"{want} expected")
    check(sum(counts.values()) == counts["flash_attention"],
          f"{arch}: no other kernel on the LM path")
    check(emb.shape == (FAM_CALIB, cfg.d_model)
          and emb.dtype == lm.dtype_of(cfg.dtype)
          and bool(torch.isfinite(emb).all()), f"{arch}: finite embeddings")
    check(gen.shape == (FAM_REQUESTS, FAM_GEN) and bool(
        ((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{arch}: generated tokens")
    for p in (p_held, p_req):
        check(bool(((p > 0) & (p <= 1)).all()), f"{arch}: p-values in (0, 1]")

    # ---- validity (binding) and power (a reading) --------------------------
    ph, pr = p_held.cpu().numpy(), p_req.cpu().numpy()
    share, mean_p = float((ph <= EPS).mean()), float(ph.mean())
    half = FAM_REQUESTS // 2
    print(f"[front-valid] {cfg.name}: held-out ({FAM_CALIB}): share p <= "
          f"{EPS} {share:.4f} (<= 0.18), mean p {mean_p:.4f} (in [0.40, "
          f"0.60]); requests of another seed's stream: mean p "
          f"{pr[:half].mean():.4f}; uniform-token requests: mean p "
          f"{pr[half:].mean():.4f} (power, a reading)")
    check(share <= 0.18, f"{arch}: held-out share with p <= {EPS}: {share}")
    check(0.40 <= mean_p <= 0.60, f"{arch}: held-out mean p {mean_p}")

    # ---- determinism: two more calibration passes, bitwise ----------------
    h1 = hidden_states(params, cfg, {"tokens": calib})
    h2 = hidden_states(params, cfg, {"tokens": calib})
    same = torch.equal(h1, h2) and torch.equal(
        torch.mean(h1, dim=1, dtype=torch.float32).to(h1.dtype), emb)
    check(same, f"{arch}: calibration passes bitwise equal")
    del h1, h2

    # ---- one decode step without a host synchronisation --------------------
    cache = lm.init_cache(cfg, FAM_REQUESTS, 2, dev)
    if frames is not None:
        cache["cross"] = lm.prefill_cross_cache(params, cfg, frames)
    lm.decode_step(params, cfg, req[:, :1], cache, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_logits, _ = lm.decode_step(params, cfg, req[:, 1:2], cache, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(step_logits).all()),
          f"{arch}: finite decode logits")
    print(f"[front-det] {cfg.name}: three calibration passes bitwise equal "
          f"(hidden states {FAM_CALIB} x {text} x {cfg.d_model}); one "
          f"decode step ({FAM_REQUESTS} sequences"
          + (", cross cache filled" if frames is not None else "")
          + ") under set_sync_debug_mode(\"error\"): no host synchronisation")
    del params, cache, step_logits, emb, held_emb, req_emb, ood
    torch.cuda.empty_cache()

    # ---- f32 at full width on check_layers layers (binding) ----------------
    kw32 = dict(dtype="float32", param_dtype="float32")
    if check_layers is not None:
        pat = configs.get(arch).pattern
        kw32.update(n_layers=check_layers, layer_pattern=pat[:check_layers])
    cfg32, p32 = serve.lm_model(arch, FRONT_REDUCED, SEED, dev, **kw32)
    B = FAM_CHECK_BATCH.get(arch, 8)
    gaps = {"embedding": front_route_gaps(
        lambda: hidden_states(p32, cfg32, {"tokens": calib[:B]}))}
    fb = front_batch(cfg32, B, dev)
    if cfg32.frontend == "vision_stub":
        gaps["hidden_forward with patches"] = front_route_gaps(
            lambda: lm.hidden_forward(p32, cfg32, fb)[0])
    if cfg32.is_encoder_decoder:  # the real vocabulary's logits
        gaps["forward_encdec logits"] = front_route_gaps(
            lambda: lm.forward_encdec(p32, cfg32, fb)[..., :cfg32.vocab_size])
    for what, (gap, _) in gaps.items():
        check(gap <= 1e-5, f"{arch}: f32 kernel route == plain route "
              f"({what}, pooled) within 1e-5 of the RMS: {gap}")
    Bd, Sd = FRONT_DECODE_CHECK
    patches = (cfg32.n_frontend_tokens if cfg32.frontend == "vision_stub"
               else 0)  # the stream cuts the text by them
    td = serve.stream_tokens(cfg32, Bd, Sd + patches, SEED, 2, dev)
    cache = lm.init_cache(cfg32, Bd, Sd, dev)
    if cfg32.is_encoder_decoder:
        fr = fb["frames"][:Bd]
        fwd = lm.forward_encdec(p32, cfg32, {"tokens": td, "frames": fr})
        cache["cross"] = lm.prefill_cross_cache(p32, cfg32, fr)
    else:
        fwd = lm.forward(p32, cfg32, {"tokens": td})
    dec = torch.stack([lm.decode_step(p32, cfg32, td[:, i:i + 1], cache,
                                      i)[0][:, 0] for i in range(Sd)], 1)
    dec_err = float((dec - fwd).abs().max())
    check(torch.allclose(dec, fwd, atol=1e-3, rtol=1e-3),
          f"{arch}: decode == forward within 1e-3: {dec_err}")
    print(f"[front-exact] {cfg.name} f32, {cfg32.n_layers} layers at full "
          f"width: kernel route == plain route over {B} sequences, "
          + ", ".join(f"{w} within {g:.3g} pooled ({e:.3g} by element, a "
                      "reading)" for w, (g, e) in gaps.items())
          + " of the RMS (pooled <= 1e-5)"
          + (f" ({fb['patch_embeds'].shape[1]} patches + "
             f"{fb['tokens'].shape[1]} tokens)" if cfg32.frontend ==
             "vision_stub" else "")
          + (f" ({fb['frames'].shape[1]} frames)"
             if cfg32.is_encoder_decoder else "")
          + f"; teacher-forced decode == "
          + ("forward_encdec with the cross cache" if
             cfg32.is_encoder_decoder else "forward")
          + f" over {Bd} x {Sd} tokens, max abs err {dec_err:.3g} (1e-3); "
          f"{time.perf_counter() - t_arch:.1f} s for {cfg.name}")
    del p32, cache, fwd, dec, fb
    torch.cuda.empty_cache()
    return counts


def fronts_path(dev="cuda"):
    """Phase 14: each of ``FRONT_CHECKS`` in turn, each model freed before
    the next loads. Returns the main paths' launch counts, summed."""
    t_phase = time.perf_counter()
    total = {}
    for arch, layers in FRONT_CHECKS:
        for name, n in front_run(arch, layers, dev).items():
            total[name] = total.get(name, 0) + n
    print(f"[front] phase 14 in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_REDUCED = "qwen2-1.5b", False  # a rehearsal: reduced
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 8, 512, 100, 5
# (b)'s depth: the first 7 of qwen2-1.5b's 28 layers, at full width (28
# until PR 30: the smoke's time, phase 18 grew by the five other families'
# sharded runs)
TRAIN_LAYERS = 7
TRAIN_LR, TRAIN_CKPT, TRAIN_DROP = 3e-4, 50, 1.0
# (c): deterministic resume, (arch, reduced); whisper-base whole at full
# width (52 M parameters: six 0.5 GB checkpoints; the smoke's writes must
# stay under its machine's 45 GiB)
RESUME_ARCHS = (("whisper-base", False), ("mixtral-8x22b", True))
RESUME_BATCH, RESUME_SEQ = 4, 256
RESUME_PROBE = "xlstm-125m"  # the mLSTM's float cumsum
# (d): every other family, reduced, card against CPU
FAMILY_STEPS, FAMILY_BATCH, FAMILY_SEQ = 3, 2, 64
# relative loss gaps, card against CPU: before the first update, and after
# (Adam's first steps move a weight by about the learning rate whatever
# its gradient's size, so weights whose gradient is rounding noise on one
# device move apart; 60-layer deepseek reached 1.9e-4 on an H100)
FAMILY_TOL0, FAMILY_TOL = 1e-5, 1e-3
BWD_CASES = [  # name, dtype, B, Sq, Skv, H, Hkv, D, causal, window, softcap
    ("train", torch.bfloat16, 8, 512, 512, 12, 2, 128, True, None, None),
    ("c", torch.float32, 2, 1024, 1024, 8, 4, 64, False, None, 50.0),
    ("d", torch.float32, 2, 16, 80, 4, 2, 128, True, None, None),
    ("b", torch.bfloat16, 4, 2048, 2048, 4, 1, 256, True, 512, None),
    ("j", torch.bfloat16, 8, 512, 512, 128, 128, 192, True, None, None),
    ("n", torch.bfloat16, 16, 1500, 1500, 8, 8, 64, False, None, None),
]
BWD_TOL = 1e-5  # of the largest gradient; bf16 past 4 ulps of each element


def grad_gap(got, want) -> float:
    """``max |got - want|`` over ``max |want|``; for bf16 what lies past
    4 bf16 ulps of each element of ``want`` (each rounded once from
    f32 sums taken in another order)."""
    w, d = want.float(), (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        d = d - 4 * torch.ldexp(torch.ones_like(w),
                                torch.frexp(w).exponent - 8)
    return float(d.max().clamp(min=0) / w.abs().max())


def check_flash_backward(g, iters, dev="cuda"):
    """Phase 15 (a): gradients through ``ops.flash_attention`` (the
    kernel forward, ``flash_attention_bwd`` backward) == autograd through
    ``ref.flash_attention`` (``grad_gap`` within ``BWD_TOL``) at the
    training shape and phase 7's (c), (d), (b), (j) and (n); at the
    training shape the backward's ms beside the kernel forward's, the
    plain version's forward and forward + backward, and SDPA's forward +
    backward (the yardstick only), CUDA events."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    torch.backends.cuda.matmul.allow_tf32 = False
    notes, line = [], ""
    for name, dt, B, Sq, Skv, H, Hkv, D, causal, window, cap in BWD_CASES:
        mk = lambda *sh: torch.randn(sh, generator=g, device=dev).to(dt)  # noqa: E731
        q, k, v = mk(B, Sq, H, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
        do = mk(B, Sq, H, D)
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=FLASH_SCALE.get(name))
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(ops.flash_attention(*ts, **kw), ts, do)
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention(*ts, **kw), ts, do)
        gaps = [grad_gap(a, w) for a, w in zip(got, want)]
        check(all(a.dtype == dt and bool(torch.isfinite(a).all())
                  for a in got), f"flash backward ({name}) finite, {dt}")
        check(max(gaps) <= BWD_TOL, f"flash backward ({name}) == autograd "
              f"through the plain version within {BWD_TOL}: {gaps}")
        notes.append(f"({name}) dq/dk/dv " + "/".join(f"{x:.2e}"
                                                      for x in gaps))
        if name == "train":
            bwd = cuda_ms(lambda: flash_attention_bwd(q, k, v, do, **kw),
                          iters)
            fwd = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters)
            pfwd = cuda_ms(lambda: ref.flash_attention(q, k, v, **kw), 3)

            def plain():
                ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
                torch.autograd.grad(ref.flash_attention(*ts, **kw), ts, do)

            def sdpa():
                ts = [t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v)]
                out = torch.nn.functional.scaled_dot_product_attention(
                    *ts, is_causal=causal, enable_gqa=True)
                torch.autograd.grad(out, ts, do.transpose(1, 2))

            pboth = cuda_ms(plain, 3)
            lib = cuda_ms(sdpa, iters)
            line = (f"B={B} S={Sq} H={H} Hkv={Hkv} D={D} causal bf16: "
                    f"backward {bwd:.4f} ms, kernel forward {fwd:.4f} ms; "
                    f"plain forward {pfwd:.4f} ms, forward + backward "
                    f"{pboth:.4f} ms (backward {pboth - pfwd:.4f}); SDPA "
                    f"forward + backward {lib:.4f} ms")
        del q, k, v, do, got, want, ts
    print("[train] flash_attention backward == autograd through the plain "
          f"version (gap / max |grad|): {'; '.join(notes)}; {line}")


def same_leaves(a, b) -> bool:
    """Leaf lists equal bit for bit (a float leaf compared as its
    integer view, so -0 and +0 differ)."""
    def bits(t):
        if not t.is_floating_point():
            return t
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def train_run(root: str, dev="cuda") -> dict:
    """Phase 15 (b): ``TRAIN_ARCH`` at full width in bf16 through the
    ``Trainer``. Returns the run's launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.blocks import ATTN_KINDS
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import trainer as tr

    cfg = configs.get(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    else:
        cfg = cfg.replace(n_layers=TRAIN_LAYERS,
                          layer_pattern=cfg.pattern[:TRAIN_LAYERS])
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, end_lr=TRAIN_LR / 10,
                           warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    tcfg = tr.TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
                            ckpt_dir=root, log_every=10, seed=SEED,
                            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    trainer = tr.Trainer(cfg, tcfg, opt_cfg=ocfg, device=dev)
    n = cfg.n_params()
    state = n * (lm.dtype_of(cfg.param_dtype).itemsize + 8)  # + mu, nu
    room_for(state, os.path.dirname(root))  # host: a copy and a write
    check(shutil.disk_usage(os.path.dirname(root)).free >= 2.1 * state,
          "train: room on disk for two checkpoints")
    saved, save_s, real = {}, [], trainer.save

    def save(step, params, opt_state, blocking=False):
        if step == TRAIN_CKPT:  # what this step's checkpoint must restore
            saved["leaves"] = [t.detach().to("cpu", copy=True) for t in
                               tr.state_leaves(params, opt_state)]
        h0 = time.perf_counter()
        real(step, params, opt_state, blocking)
        save_s.append(time.perf_counter() - h0)

    trainer.save = save
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    h0 = time.perf_counter()
    out = trainer.run()
    wall = time.perf_counter() - h0
    counts = dict(ops.kernel_launches())
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          "train: every loss finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(first - last >= TRAIN_DROP, f"train: the last 10 losses' mean "
          f"{last:.4f} at least {TRAIN_DROP} below the first 10's "
          f"{first:.4f}")
    n_attn = sum(kind in ATTN_KINDS for kind in cfg.pattern)
    per_step = n_attn * (2 if cfg.remat == "full" else 1)
    check(counts["flash_attention"] == per_step * TRAIN_STEPS
          and sum(counts.values()) == counts["flash_attention"],
          f"train: flash_attention launched {per_step} times a step (the "
          f"forward and the remat recompute) and no other kernel: {counts}")
    ms = np.asarray(trainer.step_seconds) * 1e3
    p50, p90 = np.percentile(ms[1:], [50, 90])
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {cfg.name} at d {cfg.d_model}, {cfg.n_layers} layers "
          f"({n / 1e9:.3f} B params) {cfg.dtype}, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, remat {cfg.remat}: {TRAIN_STEPS} steps in "
          f"{wall:.1f} s; step ms p50 {p50:.1f} p90 {p90:.1f} (first "
          f"{ms[0]:.1f}), {tok / p50 * 1e3:.0f} tokens/s at p50; peak "
          f"{peak:.2f} GiB allocated; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, first 10 mean {first:.4f}, "
          f"last 10 {last:.4f}; flash_attention {counts['flash_attention']}"
          f" launches ({per_step} a step); saves "
          + ", ".join(f"{x:.1f}" for x in save_s) + " s")
    h0 = time.perf_counter()
    back, step = trainer.store.restore(None, TRAIN_CKPT, device="cpu")
    check(step == TRAIN_CKPT and same_leaves(back, saved["leaves"]),
          f"train: step {TRAIN_CKPT} restored leaf by leaf == what was "
          "saved, bitwise")
    nbytes = sum(t.numel() * t.element_size() for t in back)
    print(f"[train] step {TRAIN_CKPT} restored ({len(back)} leaves, "
          f"{nbytes / 1e9:.2f} GB) in {time.perf_counter() - h0:.1f} s: "
          "bitwise what was saved")
    return counts


def resume_cfg(arch: str, reduced: bool):
    from repro_torch import configs

    cfg = configs.get(arch)
    return cfg.reduced() if reduced or TRAIN_REDUCED else cfg


def resume_child(root: str) -> int:
    """Phase 15 (c), in its own process (``--train-resume DIR``, with
    ``CUBLAS_WORKSPACE_CONFIG`` set): under
    ``torch.use_deterministic_algorithms(True)``, each of
    ``RESUME_ARCHS`` trained 6 steps straight, and 4 steps then a restart
    to 6; prints one JSON line: the last two losses and every final leaf
    bitwise equal or not, and what ``RESUME_PROBE`` raises there."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import trainer as tr

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False

    def run(cfg, d, steps):
        return tr.Trainer(cfg, tr.TrainerConfig(
            steps=steps, ckpt_every=2, ckpt_dir=os.path.join(root, d),
            log_every=100, seed=SEED, batch=RESUME_BATCH,
            seq_len=RESUME_SEQ), opt_cfg=OptimizerConfig(
                peak_lr=TRAIN_LR, warmup_steps=1, total_steps=6)).run()

    report = {}
    for arch, reduced in RESUME_ARCHS:
        cfg = resume_cfg(arch, reduced)
        one = run(cfg, f"{arch}-straight", 6)
        run(cfg, f"{arch}-resumed", 4)
        two = run(cfg, f"{arch}-resumed", 6)
        leaves = [tr.state_leaves(o["final_params"], o["opt_state"])
                  for o in (one, two)]
        report[arch] = {"layers": cfg.n_layers, "width": cfg.d_model,
                        "losses": two["losses"],
                        "same_losses": one["losses"][4:] == two["losses"],
                        "same_state": same_leaves(*leaves)}
    try:
        run(resume_cfg(RESUME_PROBE, True), "probe", 1)
        probe = "none"
    except RuntimeError as e:  # the finding: an op with no such form
        probe = str(e).splitlines()[0]
    print(json.dumps({"resume": report, "probe": probe}))
    return 0


def resume_check(root: str, dev="cuda"):
    """Phase 15 (c): ``resume_child`` in a subprocess; every arch's last
    two losses and final state bitwise those of the straight run."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": str(ROOT / "src")}
    h0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--train-resume", root], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    check(out.returncode == 0, f"train: the resume child failed: "
          f"{out.stderr[-2000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    for arch, r in rep["resume"].items():
        check(r["same_losses"] and r["same_state"], f"train: {arch} resumed "
              f"at step 4 == straight, bitwise, deterministic: {r}")
    print(f"[train] deterministic resume in {time.perf_counter() - h0:.1f} s"
          f" (a subprocess): " + "; ".join(
              f"{a} (d {r['width']}, {r['layers']} layers) steps 4-5 losses "
              f"{r['losses'][0]:.6f}, {r['losses'][1]:.6f} and every final "
              "leaf bitwise those of 6 straight steps" for a, r in
              rep["resume"].items())
          + f"; {RESUME_PROBE} under use_deterministic_algorithms raises: "
          f"{rep['probe']}")


def family_train(root: str, dev="cuda") -> dict:
    """Phase 15 (d): every other architecture reduced (f32, the kernel's
    f32 body) through ``FAMILY_STEPS`` trainer steps on the card and on
    the CPU from the same weights (drawn on the CPU): the first loss
    within ``FAMILY_TOL0``, the others ``FAMILY_TOL`` (relative). Returns
    the card runs' launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime import trainer as tr

    total, gaps = {}, []
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch).reduced()
        if cfg.name == configs.get(TRAIN_ARCH).name:
            continue
        losses, step_ms = [], 0.0
        for i, d in enumerate((dev, "cpu")):
            t = tr.Trainer(cfg, tr.TrainerConfig(
                steps=FAMILY_STEPS, ckpt_every=100, log_every=100, seed=SEED,
                ckpt_dir=os.path.join(root, f"{arch}-{i}"),
                batch=FAMILY_BATCH, seq_len=FAMILY_SEQ), device=d)
            t.init_params = lambda d=d: lm.init_lm(SEED, cfg, "cpu").to(d)
            ops.reset_launch_counts()
            losses.append(t.run()["losses"])
            if i == 0:
                for name, c in ops.kernel_launches().items():
                    total[name] = total.get(name, 0) + c
                step_ms = float(np.median(t.step_seconds[1:])) * 1e3
        a, b = np.asarray(losses[0]), np.asarray(losses[1])
        gap = np.abs(a - b) / np.abs(b)
        check(bool(np.isfinite(a).all()) and gap[0] <= FAMILY_TOL0
              and gap.max() <= FAMILY_TOL, f"train: {arch} reduced on the "
              f"card == on the CPU within {FAMILY_TOL0} / {FAMILY_TOL}: {a} "
              f"vs {b}")
        gaps.append(f"{arch} {gap[0]:.1e} / {gap.max():.1e} ({step_ms:.1f}"
                    " ms a step)")
    print(f"[train] every other family reduced, {FAMILY_STEPS} steps, card "
          "against CPU (relative loss gap at the first step / the largest): "
          + "; ".join(gaps))
    return total


def train_path(dev="cuda") -> dict:
    """Phase 15: (a) the attention's backward, (b) the full-width run and
    its restore, (c) the deterministic resume, (d) the other families.
    Returns the launch counts of (b) and (d)."""
    t_phase = time.perf_counter()
    check_flash_backward(torch.Generator(device=dev).manual_seed(SEED), 20,
                         dev)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        counts = train_run(os.path.join(root, "full"), dev)
        torch.cuda.empty_cache()
        resume_check(os.path.join(root, "resume"), dev)
        for name, c in family_train(os.path.join(root, "families"),
                                    dev).items():
            counts[name] = counts.get(name, 0) + c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[train] phase 15 in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 16: the multi-device code (core/distributed.py)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4, 8)  # logical shards on one card (devices=[cuda:0]*N)
SHARD_T = 2 * CHUNK  # timed ticks a form runs: windows fill, then evict
FLEET_SHARDS, FLEET_TENANTS_16, FLEET_STEPS_16 = 4, 48, 96
CP_ROWS, CP_QUERY = (1, 2, 4, 8), (1, 2)  # row x query shards, n N_BATCH
LM_MESH_N, LM_MESH_D, LM_MESH_Q, LM_MESH_L = 8192, 1536, 64, 3  # qwen2 d
DOTS_STEPS = 3  # (e): qwen2-1.5b steps under remat "full" and "dots"


def shard_forms(dev):
    """``(label, shards, devices)`` of (a): logical shards on the one card,
    and min(4, cards) real cards where there are two or more."""
    forms = [(f"{n} logical", n, [torch.device(dev)] * n)
             for n in SHARD_COUNTS]
    cards = torch.cuda.device_count() if torch.device(dev).type == "cuda" \
        else 1
    if cards >= 2:
        n = min(4, cards)
        forms.append((f"{n} cards", n, [torch.device("cuda", i)
                                        for i in range(n)]))
    return forms


def sync_all(devs) -> None:
    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def sharded_form(mode, eng, pre, traffic, reads, devs, iters):
    """One form of (a): ``SHARD_T`` one-tick ``observe`` calls from a copy
    of the prefilled state ``pre``, each timed on the host clock after a
    synchronisation of every card of the form, then ``reads``. Returns
    ``(state, p, read outputs, tick ms, peak GiB, launch counts)``; the
    counts cover the ticks and the reads only."""
    from repro_torch.kernels import ops

    xs, ys, taus = traffic
    state = eng.shard_state(pre.clone())
    sync_all(devs)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ms, ps = [], []
    for t in range(SHARD_T):
        h0 = time.perf_counter()
        state, p = eng.observe(state, xs[t], ys[t], taus[t])
        sync_all(devs)
        ms.append((time.perf_counter() - h0) * 1e3)
        ps.append(p)
    out = [fn(eng, state) for fn in reads]
    sync_all(devs)
    counts = dict(ops.kernel_launches())
    peak = torch.cuda.max_memory_allocated() / 2**30
    return state, torch.stack(ps), out, np.asarray(ms), peak, counts


def shard_kernels_equal_plain(mode, eng, state, traffic, reads, what):
    """Every shard's kernels against their plain versions on the exact
    arguments that shard passes them: one more (evicting) tick on a copy
    of the state, recording each ``stream_update`` launch, and the reads,
    recording each read kernel's. Returns the calls checked."""
    xs, ys, taus = traffic
    probe = state.clone()
    with recorded("_stream_update", every=True) as rec:
        eng.observe(probe, xs[SHARD_T], ys[SHARD_T], taus[SHARD_T])
    del probe
    check(len(rec.calls) == eng.shards, f"{what}: one stream_update launch "
          f"a shard on the checked tick: {len(rec.calls)}")
    for i, (a, kw) in enumerate(rec.calls):
        tick_equals_plain(types.SimpleNamespace(args=a, kw=kw),
                          f"{what} shard {i}", 0)
    n = len(rec.calls)
    del rec
    names = (("sq_dists", "cp_knn_counts") if mode == "class"
             else ("sq_dists", "interval_sweep"))
    for name in names:
        with recorded(name, every=True) as rec:
            for fn in reads:
                fn(eng, state)
        for i, (a, _) in enumerate(rec.calls):
            ok, got, want = read_equals_plain(name, a)
            check(ok, f"{what} shard {i % eng.shards}: {name} == plain, "
                  "bitwise, on the read's own arguments")
            del got, want
        n += len(rec.calls)
        del rec
    torch.cuda.empty_cache()
    return n


def sharded_engines(S, W, iters, dev="cuda"):
    """Phase 16 (a): both engines at the sliding-full shapes. One engine
    prefills every window to ``W - CHUNK``; each form then serves
    ``SHARD_T`` ticks from a copy of that state (the last ``CHUNK``
    evicting) and the reads: bitwise the one-device engine's (state
    gathered leaf by leaf, p-values, reads), ``stream_update`` launched
    ``shards`` times a tick, and every shard's kernels == plain on its
    own arguments (S/N lanes a launch). Returns the sharded forms'
    launch counts."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.serve import class_drift_traffic, reg_drift_traffic
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.serving import ServingEngine

    P, M, L = DIM, QUERIES, N_LABELS
    forms = shard_forms(dev)
    print("[sharded] (a) forms: one card, " + "; ".join(
        f"{lbl} ({', '.join(str(d) for d in devs)})"
        for lbl, _, devs in forms)
        + ("" if any("cards" in f[0] for f in forms) else
           "; real cards not run: one card visible"))
    total = {}
    rng = np.random.default_rng(SEED + 16)
    Xq = torch.from_numpy(rng.standard_normal((S, M, P), dtype=np.float32))
    for mode in ("class", "reg"):
        k = K if mode == "class" else K_REG
        T0 = W - CHUNK
        if mode == "class":
            xs, ys, taus, _ = class_drift_traffic(SEED + 16, S,
                                                  T0 + SHARD_T + 1, P, 2.0)
            Eng = ServingEngine
            kw = dict(n_labels=L)
            reads = [lambda e, st: e.predict(st, Xq.to(e.device))]
        else:
            xs, ys, taus, _, _ = reg_drift_traffic(SEED + 16, S,
                                                   T0 + SHARD_T + 1, P, 2.0)
            Eng = RegressionServingEngine
            kw = {}
            tq = torch.linspace(-3.0, 3.0, 9)
            reads = [lambda e, st: e.pvalues(st, Xq.to(e.device),
                                             tq.to(e.device)),
                     lambda e, st: e.intervals(st, Xq.to(e.device), EPS)]
        kw.update(n_sessions=S, capacity=W, dim=P, k=k, window=W)
        one = Eng(**kw, device=dev)
        pre = one.init_state()
        for c0 in range(0, T0, CHUNK):
            pre, _ = one.observe_many(pre, xs[c0:c0 + CHUNK],
                                      ys[c0:c0 + CHUNK],
                                      taus[c0:c0 + CHUNK])
        traffic = tuple(v[T0:] for v in (xs, ys, taus))
        ref_run = sharded_form(mode, one, pre, traffic, reads,
                               [torch.device(dev)], iters)
        rstate = ref_run[0]
        n_ev = int((rstate.head > 0).sum()) if mode == "class" else int(
            (rstate.head > 0).sum())
        check(n_ev == S, f"{mode}: every window evicted in the timed ticks")
        lines = [f"1 (one device): tick p50 "
                 f"{np.percentile(ref_run[3], 50):.3f} p99 "
                 f"{np.percentile(ref_run[3], 99):.3f} ms, peak "
                 f"{ref_run[4]:.2f} GiB"]
        name = "stream_update_" + mode
        for label, n, devs in forms:
            eng = Eng(**kw, shards=n, devices=devs)
            st, p, out, ms, peak, counts = sharded_form(
                mode, eng, pre, traffic, reads, devs, iters)
            check(counts[name] == n * SHARD_T, f"{mode} {label}: "
                  f"stream_update launched {n} times a tick: {counts}")
            whole = dist.gather_tenants(st, dev)
            check(all(same_bits(a, b) for a, b in zip(whole.leaves(),
                                                     rstate.leaves()))
                  and same_bits(p, ref_run[1]) and all(
                      same_bits(a.to(dev), b)
                      for a, b in zip(out, ref_run[2])),
                  f"{mode} {label}: state, p-values and reads bitwise "
                  "those of one device")
            del whole
            n_checked = shard_kernels_equal_plain(
                mode, eng, st, traffic, reads, f"{mode} {label}")
            for kname, c in counts.items():
                total[kname] = total.get(kname, 0) + c
            lines.append(f"{label}: tick p50 {np.percentile(ms, 50):.3f} "
                         f"p99 {np.percentile(ms, 99):.3f} ms, peak "
                         f"{peak:.2f} GiB, {counts[name]} stream_update "
                         f"launches ({n} a tick at S/N = {S // n}), "
                         f"{n_checked} kernel calls == plain")
            del st, p, out, eng
            torch.cuda.empty_cache()
        print(f"[sharded] (a) {mode} S={S} window={W} k={k}: {SHARD_T} "
              f"one-tick observes from windows at {T0} (the last {CHUNK} "
              f"evicting) + reads, every form bitwise the one-device "
              f"engine; tick = host clock around observe + synchronise "
              f"(shards: " + "; ".join(lines) + ")")
        del pre, rstate, ref_run, one
        torch.cuda.empty_cache()
    return total


def sharded_fleet(dev="cuda") -> dict:
    """Phase 16 (b): a classification ``Fleet`` at ``FLEET_SHARDS``
    logical shards against one device: every tenant's p-values and a
    predict bitwise, through migrations 16 -> 128. Returns the sharded
    fleet's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Fleet

    rng = np.random.default_rng(SEED + 17)
    T, n = FLEET_STEPS_16, FLEET_TENANTS_16
    x = rng.standard_normal((T, n, DIM), dtype=np.float32)
    y = rng.integers(0, N_LABELS, (T, n)).astype(np.int32)
    tau = rng.random((T, n), dtype=np.float32)
    out, counts = [], {}
    for shards in (1, FLEET_SHARDS):
        fleet = Fleet(dim=DIM, k=K, n_labels=N_LABELS, cap_min=16,
                      cap_max=128, pool_sessions=32, shards=shards,
                      devices=[torch.device(dev)] * shards)
        for t in range(n):
            fleet.admit(t)
        ops.reset_launch_counts()
        h0 = time.perf_counter()
        ps = []
        for s in range(T):
            got = fleet.observe({t: (x[s, t], y[s, t], tau[s, t])
                                 for t in range(n)})
            ps.append(torch.stack([got[t] for t in range(n)]))
        pv = torch.stack([fleet.predict(t, x[0]) for t in range(0, n, 7)])
        sync_all([torch.device(dev)])
        wall = time.perf_counter() - h0
        if shards > 1:
            counts = dict(ops.kernel_launches())
        out.append((torch.stack(ps), pv, wall, fleet.stats()))
    check(same_bits(out[0][0], out[1][0]) and same_bits(out[0][1], out[1][1]),
          "the sharded fleet's p-values and predicts bitwise one device's")
    caps = sorted({p["capacity"] for p in out[1][3]["pools"]})
    print(f"[sharded] (b) fleet of {n} tenants, {T} steps, pools of 32 "
          f"lanes, capacities {caps}: {FLEET_SHARDS} logical shards "
          f"bitwise one device ({out[1][2]:.2f} s against "
          f"{out[0][2]:.2f} s); launches {counts}")
    return counts


def sharded_cp(X, y, Xq, dev="cuda"):
    """Phase 16 (c): the row-sharded k-NN CP at the batch cell (n
    ``N_BATCH``, p 30, k 15, m 100) over row x query shards, bitwise
    across the shard counts; as a reading, its counts against the
    single-device ``pvalues_optimized`` (another distance rounding). Then
    ``ConformalLmClassifier.fit(mesh=(4, 2))`` at qwen2's width, bitwise
    mesh (2, 1)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import lm_conformal as lmc
    from repro_torch.core.measures import knn as knn_m

    n, L = X.shape[0], N_LABELS
    h0 = time.perf_counter()
    st = knn_m.fit(X, y, k=K)
    single = knn_m.pvalues_optimized(st, Xq, k=K, simplified=False,
                                     n_labels=L)
    sync_all([torch.device(dev)])
    fit_s = time.perf_counter() - h0
    ref_out, times = None, []
    for R in CP_ROWS:
        for Q in CP_QUERY:
            mesh = dist.make_mesh((R, Q), ("data", "model"),
                                  [torch.device(dev)] * (R * Q))
            sh = dist.shard_knn_state(st, mesh)
            fn = dist.make_knn_pvalues_fn(mesh, k=K, simplified=False,
                                          n_labels=L)
            fn(sh, Xq)  # warm-up
            sync_all([torch.device(dev)])
            h0 = time.perf_counter()
            out = fn(sh, Xq)
            sync_all([torch.device(dev)])
            times.append(f"{R}x{Q} {(time.perf_counter() - h0) * 1e3:.1f}")
            if ref_out is None:
                ref_out = out
            check(same_bits(out, ref_out), f"row-sharded k-NN CP at {R} x "
                  f"{Q} shards bitwise 1 x 1")
            del sh, fn
    check(ref_out.shape == (Xq.shape[0], L) and bool(
        ((ref_out > 0) & (ref_out <= 1)).all()), "row-sharded p-values")
    cnt = lambda p: torch.round(p.double() * (n + 1)).long() - 1  # noqa
    gap = (cnt(ref_out) - cnt(single)).abs()
    print(f"[sharded] (c) row-sharded k-NN CP n={n} p={X.shape[1]} k={K} "
          f"m={Xq.shape[0]} L={L}: bitwise across row shards {CP_ROWS} x "
          f"query shards {CP_QUERY} (ms, host clock: {', '.join(times)}); "
          f"against the single-device pvalues_optimized "
          f"({fit_s:.1f} s with the fit): {int((gap > 0).sum())} of "
          f"{gap.numel()} p-values differ, the largest by "
          f"{int(gap.max())} counts")
    del st, single
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    lab = torch.randint(0, LM_MESH_L, (LM_MESH_N,), generator=g,
                        device=dev, dtype=torch.int32)
    emb = torch.randn((LM_MESH_N, LM_MESH_D), generator=g, device=dev)
    emb += lab[:, None].float() * 0.05
    qe = torch.randn((LM_MESH_Q, LM_MESH_D), generator=g, device=dev)
    outs = []
    for shape in ((4, 2), (2, 1)):
        mesh = dist.make_mesh(shape, ("data", "model"),
                              [torch.device(dev)] * (shape[0] * shape[1]))
        h0 = time.perf_counter()
        clf = lmc.ConformalLmClassifier(n_labels=LM_MESH_L, k=K).fit(
            emb, lab, mesh=mesh)
        p = clf.pvalues(qe)
        sync_all([torch.device(dev)])
        outs.append((p, time.perf_counter() - h0))
        del clf
    check(same_bits(outs[0][0], outs[1][0]) and bool(
        torch.isfinite(outs[0][0]).all()), "ConformalLmClassifier.fit("
          "mesh=(4, 2)) p-values bitwise mesh (2, 1)")
    print(f"[sharded] (c) ConformalLmClassifier.fit(mesh=(4, 2)) at d "
          f"{LM_MESH_D}, n {LM_MESH_N}, {LM_MESH_Q} queries, "
          f"{LM_MESH_L} labels: bitwise mesh (2, 1) (fit + p-values "
          f"{outs[0][1]:.2f} s and {outs[1][1]:.2f} s)")
    torch.cuda.empty_cache()


def sharded_launcher(dev="cuda") -> None:
    """Phase 16 (d): ``launch.serve --shards 2`` in a subprocess: on one
    card it exits with the reference's "exceeds the ... visible
    device(s)" message; on two or more it serves and ends with a
    bit-exact snapshot round trip through the two-block saver."""
    cards = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--sessions",
           "64", "--steps", "40", "--window", "32", "--capacity", "32",
           "--dim", str(DIM), "--k", str(K), "--shards", "2"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    root = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    if cards >= 2:  # the sharded saver's round trip across the cards
        cmd += ["--snapshot-dir", root]
    h0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, env=env, cwd=ROOT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    text = out.stdout + out.stderr
    if cards >= 2:
        check(out.returncode == 0 and "shards=2" in text
              and "restore bit-exact" in text,
              f"launch.serve --shards 2 serves on {cards} cards: "
              f"{text[-2000:]}")
        what = ("served on cuda:0 and cuda:1, the snapshot round trip "
                "bit-exact")
    else:
        check(out.returncode != 0 and "exceeds the 1 visible device" in text,
              f"launch.serve --shards 2 refused on one card: {text[-2000:]}")
        what = "refused: " + [ln for ln in text.splitlines()
                              if "exceeds" in ln][-1].strip()
    print(f"[sharded] (d) launch.serve --shards 2 with {cards} card(s): "
          f"{what} ({time.perf_counter() - h0:.1f} s, a subprocess)")


def dots_child(root: str) -> int:
    """Phase 16 (e), in its own process (``--remat-dots DIR``, with
    ``CUBLAS_WORKSPACE_CONFIG`` set): under
    ``torch.use_deterministic_algorithms(True)``, ``DOTS_STEPS`` steps of
    ``TRAIN_ARCH`` at full width and depth (bf16, batch ``TRAIN_BATCH`` x
    ``TRAIN_SEQ``) from one seed with remat "full", then "dots"; prints
    one JSON line: the losses, whether they and the final parameters are
    bitwise equal, step ms and peak GiB of each."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import trainer as tr

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = configs.get(TRAIN_ARCH)
    if TRAIN_REDUCED:
        base = base.reduced()
    runs = {}
    for remat in ("full", "dots"):
        cfg = base.replace(remat=remat)
        t = tr.Trainer(cfg, tr.TrainerConfig(
            steps=DOTS_STEPS, ckpt_every=10**6, log_every=10**6, seed=SEED,
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            ckpt_dir=os.path.join(root, remat)), opt_cfg=OptimizerConfig(
                peak_lr=TRAIN_LR, warmup_steps=1, total_steps=DOTS_STEPS))
        t.save = lambda *a, **kw: None  # no checkpoint: a comparison run
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = t.run()
        torch.cuda.synchronize()
        runs[remat] = {
            "losses": out["losses"],
            "params": [p.detach().to("cpu", copy=True)
                       for p in out["final_params"].parameters()],
            "step_ms": [s * 1e3 for s in t.step_seconds],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "flash": ops.kernel_launches()["flash_attention"]}
        del t, out
    a, b = runs["full"], runs["dots"]
    print(json.dumps({
        "layers": base.n_layers, "width": base.d_model,
        "same_losses": a["losses"] == b["losses"],
        "same_params": same_leaves(a["params"], b["params"]),
        **{f"{r}_{key}": runs[r][key] for r in runs
           for key in ("losses", "step_ms", "peak_gib", "flash")}}))
    return 0


def sharded_dots(dev="cuda") -> None:
    """Phase 16 (e): ``dots_child`` in a subprocess; the losses and the
    parameters after the last step bitwise those of remat "full"."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": str(ROOT / "src")}
    root = tempfile.mkdtemp(prefix="chip_smoke_dots_")
    h0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--remat-dots", root], capture_output=True,
                             text=True, timeout=600, env=env, cwd=ROOT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(out.returncode == 0, f"the remat dots child failed: "
          f"{out.stderr[-2000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    check(r["same_losses"] and r["same_params"], f"remat dots == full, "
          f"bitwise: losses and final parameters: {r}")
    ms = {m: float(np.median(r[f"{m}_step_ms"][1:])) for m in ("full",
                                                               "dots")}
    print(f"[sharded] (e) {TRAIN_ARCH} d {r['width']}, {r['layers']} layers,"
          f" bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ}, {DOTS_STEPS} steps "
          f"under use_deterministic_algorithms (a subprocess, "
          f"{time.perf_counter() - h0:.1f} s): remat dots == full bitwise "
          f"(losses {r['dots_losses']}, every final parameter); step ms "
          f"(median of steps 2-{DOTS_STEPS}) full {ms['full']:.1f}, dots "
          f"{ms['dots']:.1f}; peak GiB full {r['full_peak_gib']:.2f}, dots "
          f"{r['dots_peak_gib']:.2f}; flash_attention launches full "
          f"{r['full_flash']}, dots {r['dots_flash']}")


def sharded_path(S, W, X, y, Xq, iters, dev="cuda") -> dict:
    """Phase 16: (a) the tenant-sharded engines, (b) the fleet, (c) the
    row-sharded CP and the LM classifier on a mesh, (d) the launcher's
    --shards, (e) remat "dots". Returns the launch counts of (a) and
    (b), the path's sharded ticks and reads."""
    t_phase = time.perf_counter()
    counts = sharded_engines(S, W, iters, dev)
    for name, c in sharded_fleet(dev).items():
        counts[name] = counts.get(name, 0) + c
    sharded_cp(X, y, Xq, dev)
    sharded_launcher(dev)
    sharded_dots(dev)
    print(f"[sharded] phase 16 in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}")
    return counts




# ---------------------------------------------------------------------------
# phase 17: the dry run (launch/dryrun.py, sharding/, analysis/flops.py)
# ---------------------------------------------------------------------------

DRYRUN_JOBS = 8  # worker processes of (a)'s FLOP counts: the host's cores
# the mesh whose cells (a) also counts by census, for phase 18 (c): the 2 x
# 16 x 16 mesh's take minutes a cell (DTensor's planner), so the smoke
# leaves them to ``python -m repro_torch.launch.dryrun``
CENSUS_MESH = "16x16"


def dryrun_grid() -> list:
    """Phase 17 (a): the whole grid on ``meta`` (the dense cells' censuses
    in the same workers, read by phase 18 (c)); every cell ``ok`` or
    ``skipped`` and the ``ok`` cells the reference's grid. Returns the
    cells."""
    from repro_torch import configs
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        out = os.path.join(d, "dryrun.json")
        rc = dryrun.main(["--all", "--both-meshes", "--jobs",
                          str(DRYRUN_JOBS), "--census", CENSUS_MESH,
                          "--out", out])
        with open(out) as f:
            cells = json.load(f)
    secs = time.perf_counter() - t0
    check(rc == 0, f"dryrun --all --both-meshes exit 0 (got {rc})")
    status = {}
    for c in cells:
        status[c["status"]] = status.get(c["status"], 0) + 1
    check(set(status) <= {"ok", "skipped"}, f"dryrun cells ok or skipped: "
          f"{status}")
    grid = {(a, s, m) for a in configs.names()
            for s in configs.get(a).shapes for m in ("16x16", "2x16x16")}
    ok = {(c["arch"], c["shape"], c["mesh"]) for c in cells
          if c["status"] == "ok"}
    check(ok == grid, f"dryrun ok cells == the reference's grid "
          f"({len(ok)} vs {len(grid)})")
    check(all(c["flops_global"] > 0 and c["memory"]["argument_bytes"] > 0
              for c in cells if c["status"] == "ok"),
          "dryrun: every ok cell counted FLOPs and bytes")
    print(f"[dryrun] (a) --all --both-meshes in {secs:.1f} s "
          f"({DRYRUN_JOBS} counting processes): {len(cells)} cells, "
          f"{status}")
    return cells


def dryrun_step(dev="cuda") -> dict:
    """Phase 17 (b), (c): a qwen2-1.5b train step on the card against its
    count on ``meta``. Returns the step's launch counts."""
    from repro_torch import configs
    from repro_torch.analysis.flops import FlopCounter
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import batch_struct, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.sharding import batch_pspecs, param_pspecs

    cfg = configs.get(TRAIN_ARCH)
    shape = ShapeSpec("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, ocfg)

    def cell(device):
        params = lm.init_lm(SEED, cfg, device=device).requires_grad_(True)
        batch = batch_struct(cfg, shape, device)
        if device != "meta":
            g = torch.Generator(device=device).manual_seed(SEED)
            for t in batch.values():
                t.copy_(torch.randint(0, cfg.vocab_size, t.shape,
                                      generator=g, device=device))
        return params, init_opt_state(params, ocfg), batch

    def counted(args):
        with FlopCounter() as c:
            step(*args)
        return c

    mesh = make_mesh((1, 1), ("data", "model"), [torch.device(dev)])
    args = cell(dev)
    specs = (param_pspecs(args[0], mesh), param_pspecs(args[1], mesh),
             batch_pspecs(args[2], mesh))
    counted_bytes = dryrun.cell_bytes(cfg, shape, "train", args, specs,
                                      mesh)["argument_bytes"]
    storages = {}
    for t in (*args[0].parameters(), *args[1]["mu"].values(),
              *(v for nu in args[1]["nu"].values() for v in nu.values()),
              args[1]["step"], *args[2].values()):
        storages[t.untyped_storage().data_ptr()] = \
            t.untyped_storage().nbytes()
    held = sum(storages.values())
    check(counted_bytes == held, f"dryrun (c): counted argument bytes "
          f"{counted_bytes} == the card's storages {held}")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = counted(args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = ops.kernel_launches()
    del args
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta = counted(cell("meta"))
    meta_s = time.perf_counter() - t0
    flash = counts["flash_attention"]
    check(flash == 2 * cfg.n_layers, f"dryrun (b): flash_attention launched "
          f"twice a layer ({flash})")
    check(all(n == 0 for k, n in counts.items() if k != "flash_attention"),
          "dryrun (b): no other kernel on the step")
    for what in ("flops", "transcendental", "matmul"):
        a, b = getattr(card, what), getattr(meta, what)
        check(a == b, f"dryrun (b): the card's {what} {a!r} == meta's {b!r}")
    attn = card.by_op["flash_attention"]
    print(f"[dryrun] (b) {TRAIN_ARCH} step {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"(remat {cfg.remat}): card {card.flops:.6e} FLOPs "
          f"({card.matmul:.6e} in products, {card.transcendental:.6e} "
          f"transcendental; flash_attention {attn:.6e} by its formula, "
          f"{flash} launches) == meta, exactly; step {card_s:.2f} s on the "
          f"card under the counter, the meta count {meta_s:.2f} s; (c) "
          f"argument bytes {counted_bytes} == the card's storages")
    return counts


def dryrun_path(dev="cuda") -> tuple:
    """Phase 17: (a) the grid, (b) and (c) the qwen2 step. Returns the
    launch counts of (b) and the grid's cells."""
    t_phase = time.perf_counter()
    cells = dryrun_grid()
    counts = dryrun_step(dev)
    print(f"[dryrun] phase 17 in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}")
    return counts, cells


# ---------------------------------------------------------------------------
# phase 18: sharded training over a process group, and the census
# (launch/train.py, sharding/, runtime/trainer.py, analysis/census.py)
# ---------------------------------------------------------------------------

SHARD_STEPS = 5  # (a)'s steps a mesh
SHARD_MAX = 4  # at most this many cards for (a)'s (N, 1) and (1, N)
SHARD_LOSS_RTOL = 1e-3
CENSUS_TEMP_RTOL = 0.1


def shard_train(shape, root, census: bool = False, arch=None,
                layers=None, steps=SHARD_STEPS) -> dict:
    """Phase 18 (a), (e): ``launch.train`` at phase 15's shape for
    ``steps`` steps of ``arch`` (``TRAIN_ARCH``; its first ``layers``
    layers where given) on a ``shape`` mesh, one process a card (no
    checkpoint). Returns ``{"losses", "launches", "census", "s"}``."""
    return finish_train(start_train(shape, root, census, arch, layers,
                                    steps))


def start_train(shape, root, census: bool = False, arch=None, layers=None,
                steps=SHARD_STEPS) -> dict:
    """``shard_train``'s launcher process, started: a handle for
    ``finish_train``."""
    d, m = shape
    arch = arch or TRAIN_ARCH
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            arch, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--lr",
            str(TRAIN_LR), "--seed", str(SEED), "--ckpt-every", "0",
            "--log-every", "1", "--data-axis", str(d), "--model-axis",
            str(m), "--ckpt-dir", os.path.join(root, f"ck-{arch}-{d}x{m}")]
    if TRAIN_REDUCED:
        argv.append("--reduced")
    if layers is not None:
        argv += ["--layers", str(layers)]
    out_json = os.path.join(root, f"census-{arch}-{d}x{m}.json")
    if census:
        argv += ["--census-out", out_json]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    h0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    return {"proc": proc, "shape": shape, "census": census,
            "out_json": out_json, "t0": h0}


def finish_train(run: dict) -> dict:
    """Wait for a ``start_train`` process and read its losses, launches
    and census."""
    out, err = run["proc"].communicate(timeout=600)
    secs = time.perf_counter() - run["t0"]
    d, m = run["shape"]
    check(run["proc"].returncode == 0, f"sharded train ({d}, {m}) exit 0: "
          f"{err[-3000:]}")
    lines = {ln.split(" ", 2)[1]: ln.split(" ", 2)[2]
             for ln in out.splitlines()
             if ln.startswith("[train] losses ")
             or ln.startswith("[train] launches ")}
    step_s = [float(x.group(1)) for x in re.finditer(r"'sec': ([0-9.]+)",
                                                     out)]
    res = {"losses": json.loads(lines["losses"]),
           "launches": json.loads(lines["launches"]), "s": secs,
           "step_ms": 1e3 * float(np.median(step_s[1:] or step_s))}
    if run["census"]:
        with open(run["out_json"]) as f:
            res["census"] = json.load(f)
    return res


def fake_census(shape) -> dict:
    """The census of (a)'s sharded step on ``meta`` over a fake group of
    ``prod(shape)`` ranks (the cards' collective forms)."""
    from repro_torch import configs
    from repro_torch.analysis.census import Census
    from repro_torch.launch.mesh import fake_device_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.boundary import compressed_boundaries
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.sharding import rules
    from repro_torch.sharding.activation import activation_mesh

    cfg = configs.get(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, end_lr=TRAIN_LR / 10,
                           warmup_steps=max(1, SHARD_STEPS // 20),
                           total_steps=SHARD_STEPS)
    mesh = fake_device_mesh(shape, ("data", "model"), "cuda")
    p = lm.init_lm(SEED, cfg, device="meta")
    p, o = rules.distribute_state(p, init_opt_state(p, ocfg), mesh)
    p.requires_grad_(True)
    b = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                        device="meta") for k in ("tokens", "labels")}
    b = rules.distribute(b, rules.batch_pspecs(b, mesh), mesh)
    with compressed_boundaries(), activation_mesh(mesh), Census() as c:
        out = make_train_step(cfg, ocfg, mesh=mesh)(p, o, b)
    res = c.result()
    del out
    return res


def attention_blocks(g, dev="cuda") -> None:
    """Phase 18 (a), before the runs: ``ops.flash_attention`` on the card
    at every block the sharded route gives it on ``(N, 1)`` and ``(1, N)``
    (N 2 and ``SHARD_MAX``), at (a)'s attention shape, bf16, causal: on
    ``(N, 1)`` a rank's batch rows with every head; on ``(1, N)`` a rank's
    q heads with the kv heads ``ops.local_kv_heads`` (the route's map)
    gives them, one kv head sliced out of two at N 4. Each block's output
    == the plain version on the *global* q, k, v, its heads' slice, within
    the kernel table's tolerance (``bf16_close``), so the map is held to
    the global GQA map. A control: the kv slice taken without the block's
    offset (the kernel's own map on the block) must miss by far more. The
    launches here are comparisons: the caller resets the counts after."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref

    cfg = configs.get(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev)
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    want = ref.flash_attention(q, k, v, causal=True)
    notes, worst, control = [], 0.0, {}
    for n in sorted({2, SHARD_MAX}):
        b = B // n
        for r in range(n):  # (n, 1): rank r's batch rows
            got = ops.flash_attention(q[r * b:(r + 1) * b].contiguous(),
                                      k[r * b:(r + 1) * b].contiguous(),
                                      v[r * b:(r + 1) * b].contiguous(),
                                      causal=True)
            ok, _ = bf16_close(got, want[r * b:(r + 1) * b])
            check(ok, f"sharded (a): flash_attention on rank {r}'s block "
                  f"of ({n}, 1) == plain on the global inputs")
            worst = max(worst, float((got.float() - want[r * b:(r + 1) * b]
                                      .float()).abs().max()))
        h = H // n
        for r in range(n):  # (1, n): rank r's q heads, their kv heads
            heads = ops.local_kv_heads(H, Hkv, n, r)
            check(heads is not None, f"sharded (a): (1, {n}) rank {r} has "
                  "a kv slice")
            qr = q[:, :, r * h:(r + 1) * h].contiguous()
            got = ops.flash_attention(
                qr, k[:, :, heads[0]:heads[1]].contiguous(),
                v[:, :, heads[0]:heads[1]].contiguous(), causal=True)
            w = want[:, :, r * h:(r + 1) * h]
            ok, _ = bf16_close(got, w)
            check(ok, f"sharded (a): flash_attention on rank {r}'s block "
                  f"of (1, {n}) (q heads {r * h}..{(r + 1) * h - 1}, kv "
                  f"heads {heads}) == plain on the global inputs")
            worst = max(worst, float((got.float() - w.float()).abs().max()))
            if heads[0]:
                m = heads[1] - heads[0]
                off = ref.flash_attention(qr, k[:, :, :m], v[:, :, :m],
                                          causal=True)
                check(not bf16_close(off, w)[0], f"sharded (a): (1, {n}) "
                      f"rank {r}: a kv map without the offset fails the "
                      "tolerance")
                control[(n, r)] = float((off.float() - w.float()).abs()
                                        .max())
        notes.append(f"({n}, 1) {n} blocks of q {(b, S, H, D)}, kv "
                     f"{(b, S, Hkv, D)}; (1, {n}) {n} blocks of q "
                     f"{(B, S, h, D)}, kv {(B, S, heads[1] - heads[0], D)}")
    missed = max(control.values())
    del q, k, v, want
    loss_gap = wrong_map_loss_gap(cfg, dev)
    print(f"[sharded-train] flash_attention on the sharded route's blocks "
          f"({TRAIN_ARCH}, bf16, causal): " + "; ".join(notes)
          + f"; every block == plain on the global inputs within one bf16 "
          f"ulp + 1e-5, max abs err {worst:.3g}; a kv map without the "
          f"block offset fails that on every block it changes, by up to "
          f"{missed:.3g} (max abs, plain); on the model, every q head "
          f"reading kv head 0 (that map's effect on (1, {SHARD_MAX})) moves "
          f"the first loss by {loss_gap:.3e} relative (the (N, 1) / (1, N) "
          f"loss check's tolerance is {SHARD_LOSS_RTOL})")


def wrong_map_loss_gap(cfg, dev="cuda") -> float:
    """The relative change of (a)'s first loss (the seed's weights, step
    0's batch) when every q head reads kv head 0: what a kv map without
    the block offset does to the whole model on ``(1, SHARD_MAX)``."""
    from repro_torch.data.lm_pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    params = lm.init_lm(SEED, cfg, device=dev)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in TokenStream(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED).batch_at(0).items()}
    kept = ops.flash_attention

    def head0(q, k, v, **kw):
        return kept(q, k[:, :, :1].contiguous(), v[:, :, :1].contiguous(),
                    **kw)

    with torch.no_grad():
        right = float(lm.train_step_loss(params, cfg, batch))
        ops.flash_attention = head0
        try:
            wrong = float(lm.train_step_loss(params, cfg, batch))
        finally:
            ops.flash_attention = kept
    del params, batch
    torch.cuda.empty_cache()
    return abs(wrong - right) / abs(right)


# the census keys a card's run and ``meta``'s share exactly (the plain
# traffic is ``meta``'s alone: there the plain attention runs inside the
# kernel's boundary)
_CENSUS_EXACT = ("collective_bytes", "device_hbm_bytes_flash_adjusted",
                 "hlo_ops", "temp_bytes", "peak_bytes")


def sharded_train_path(root: str, dev="cuda") -> dict:
    """Phase 18 (a): the sharded trainer on ``(1, 1)`` == the unsharded
    trainer's losses bitwise; on ``(N, 1)`` and ``(1, N)`` (N the visible
    cards, at most ``SHARD_MAX``) within ``SHARD_LOSS_RTOL`` of them,
    ``flash_attention`` launched on every rank's blocks, and the NCCL
    run's census == the fake group's on ``meta``. Returns the launches
    the phase counted (the unsharded run's and rank 0's)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import ATTN_KINDS
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import trainer as tr

    cfg = configs.get(TRAIN_ARCH)
    if TRAIN_REDUCED:
        cfg = cfg.reduced()
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, end_lr=TRAIN_LR / 10,
                           warmup_steps=max(1, SHARD_STEPS // 20),
                           total_steps=SHARD_STEPS)
    tcfg = tr.TrainerConfig(steps=SHARD_STEPS, ckpt_every=0,
                            ckpt_dir=os.path.join(root, "plain"),
                            log_every=100, seed=SEED, batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ)
    g = torch.Generator(device=dev).manual_seed(SEED)
    attention_blocks(g, dev)
    family_blocks(g, dev)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    h0 = time.perf_counter()
    want = tr.Trainer(cfg, tcfg, opt_cfg=ocfg, device=dev).run()["losses"]
    plain_s = time.perf_counter() - h0
    counts = dict(ops.kernel_launches())
    torch.cuda.empty_cache()
    per_step = sum(k in ATTN_KINDS for k in cfg.pattern) * (
        2 if cfg.remat == "full" else 1)
    one = shard_train((1, 1), root)
    first_diff = next((i for i, (a, b) in enumerate(zip(one["losses"], want))
                       if a != b), None)
    check(first_diff is None, f"sharded (a): (1, 1) losses == the unsharded "
          f"trainer's bitwise (first difference at step {first_diff}: "
          f"{one['losses']} vs {want})")
    check(one["launches"]["flash_attention"] == per_step * SHARD_STEPS,
          f"sharded (a): (1, 1) flash_attention launches "
          f"{one['launches']['flash_attention']} == {per_step} a step")
    counts["flash_attention"] += one["launches"]["flash_attention"]
    print(f"[sharded-train] {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ}, remat "
          f"{cfg.remat}, {SHARD_STEPS} steps: unsharded in-process "
          f"{plain_s:.1f} s, (1, 1) launcher {one['s']:.1f} s (step p50 "
          f"{one['step_ms']:.1f} ms, host clock); losses "
          f"{one['losses']} == unsharded, bitwise; flash_attention "
          f"{one['launches']['flash_attention']} launches")
    n = min(torch.cuda.device_count(), SHARD_MAX)
    for shape in ([(n, 1), (1, n)] if n >= 2 else []):
        run = shard_train(shape, root, census=True)
        gap = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], want))
        check(gap <= SHARD_LOSS_RTOL, f"sharded (a): {shape} losses within "
              f"{SHARD_LOSS_RTOL} of one card's (max relative gap {gap:.3e})")
        check(run["launches"]["flash_attention"] == per_step * SHARD_STEPS,
              f"sharded (a): {shape} rank 0 launched flash_attention on its "
              f"blocks {run['launches']['flash_attention']} times")
        fake = fake_census(shape)
        for k in _CENSUS_EXACT:
            a, b = run["census"][k], json.loads(json.dumps(fake[k]))
            check(a == b, f"sharded (a): {shape} the NCCL run's {k} == the "
                  f"fake group's on meta: " + str(census_diff(a, b)
                                                  if isinstance(a, dict)
                                                  else (a, b)))
        print(f"[sharded-train] {shape}: {run['s']:.1f} s for {SHARD_STEPS} "
              f"steps + one under the census (step p50 {run['step_ms']:.1f} "
              f"ms, host clock); losses {run['losses']}, max gap "
              f"{gap:.3e}; rank 0 "
              f"flash_attention {run['launches']['flash_attention']} "
              f"launches on its blocks; census == meta's: collectives "
              f"{run['census']['collective_bytes']}, adjusted traffic "
              f"{run['census']['device_hbm_bytes_flash_adjusted']:.6e} B, "
              f"temp {run['census']['temp_bytes']} B, peak "
              f"{run['census']['peak_bytes']} B")
    if n < 2:
        print(f"[sharded-train] (N, 1) and (1, N): {torch.cuda.device_count()}"
              " visible card(s), not run")
    return counts


def family_attention(cfg, kind: str) -> tuple:
    """``(B, Sq, Skv, H, Hkv, D, kw)`` of a family's attention call at full
    width: its heads, kv heads, head dim and window; long enough that a
    window binds."""
    B = SHARD_MAX
    if kind == "mla":  # the decompressed heads at qk_nope + qk_rope
        D = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        return (B, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads, cfg.n_heads, D,
                dict(causal=True, scale=D ** -0.5))
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if kind == "encoder":
        T = cfg.n_frontend_tokens
        return B, T, T, H, Hkv, D, dict(causal=False)
    if kind == "cross":
        return (B, TRAIN_SEQ, cfg.n_frontend_tokens, H, Hkv, D,
                dict(causal=False))
    S = cfg.window + 256
    return B, S, S, H, Hkv, D, dict(causal=True, window=cfg.window)


# (a): the families' attention calls, (arch, kind, what)
FAMILY_BLOCKS = (("mixtral-8x22b", "local", "GQA 48:8, window 4096"),
                 ("deepseek-v2-236b", "mla", "MLA, D 192"),
                 ("whisper-base", "encoder", "non-causal encoder"),
                 ("whisper-base", "cross", "cross-attention"),
                 ("recurrentgemma-9b", "local", "local MQA, window 2048"))


def family_blocks(g, dev="cuda") -> None:
    """Phase 18 (a), after qwen2's: ``ops.flash_attention`` on the card on
    every block ``(2|4, 1)`` and ``(1, 2|4)`` give the five families'
    attention calls at full width (``family_attention``), bf16, each
    against the plain version on the global inputs (computed a batch row
    at a time), its block's slice, within ``bf16_close``; the kv heads of
    a ``(1, N)`` block are ``ops.local_kv_heads``' (the sharded route's
    map; MQA's one head on every block). Comparison launches: the caller
    resets the counts after."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref

    notes = []
    for arch, kind, what in FAMILY_BLOCKS:
        cfg = configs.get(arch)
        if TRAIN_REDUCED:
            cfg = cfg.reduced()
        B, Sq, Skv, H, Hkv, D, kw = family_attention(cfg, kind)
        q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, Skv, Hkv, D), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        want = torch.cat([ref.flash_attention(q[b:b + 1], k[b:b + 1],
                                              v[b:b + 1], **kw)
                          for b in range(B)])
        worst, n_blocks = 0.0, 0
        for n in sorted({2, SHARD_MAX}):
            b, h = B // n, H // n
            for r in range(n):
                rows = slice(r * b, (r + 1) * b)
                heads = ops.local_kv_heads(H, Hkv, n, r)
                check(heads is not None, f"sharded (a): {arch} {kind} "
                      f"(1, {n}) rank {r} has a kv slice")
                kv = slice(*heads)
                for got, w in (
                        (ops.flash_attention(q[rows].contiguous(),
                                             k[rows].contiguous(),
                                             v[rows].contiguous(), **kw),
                         want[rows]),
                        (ops.flash_attention(
                            q[:, :, r * h:(r + 1) * h].contiguous(),
                            k[:, :, kv].contiguous(),
                            v[:, :, kv].contiguous(), **kw),
                         want[:, :, r * h:(r + 1) * h])):
                    ok, _ = bf16_close(got, w)
                    check(ok, f"sharded (a): {arch} {kind} block {r} of "
                          f"{n} == plain on the global inputs")
                    worst = max(worst, float((got.float() - w.float())
                                             .abs().max()))
                    n_blocks += 1
        notes.append(f"{arch} {what} (q {(B, Sq, H, D)}, kv "
                     f"{(B, Skv, Hkv, D)}): {n_blocks} blocks, max abs err "
                     f"{worst:.3g}")
        del q, k, v, want
        torch.cuda.empty_cache()
    print("[sharded-train] (a) flash_attention on the sharded route's "
          "blocks of the families, bf16, == plain on the global inputs "
          "within one bf16 ulp + 1e-5: " + "; ".join(notes))


MOE_TOKENS = (8, 512)  # (d): the grouped dispatch's batch x sequence
MOE_GROUPS = 4


def dropped_pairs(p, x, cfg, groups: int) -> list:
    """Each group's dropped ``(token, k)`` pairs when ``x (B, S, D)``'s
    tokens route in ``groups`` groups (the capacity a group's)."""
    from repro_torch.models import mlp

    mo = cfg.moe
    B, S, D = x.shape
    T = B * S // groups
    cap = max(1, int(T * mo.n_experts_per_token * mo.capacity_factor
                     / mo.n_experts))
    with torch.no_grad():
        pair_slot = mlp._dispatch_local(
            x.reshape(groups, T, D), p["router"], mo.n_experts_per_token,
            mo.n_experts, cap)[2]
    return (pair_slot == mo.n_experts * cap).sum((1, 2)).tolist()


def grouped_moe(dev="cuda") -> dict:
    """Phase 18 (d): mixtral's MoE layer (``"tp"``) and deepseek's (``"ep"``)
    at full width, bf16, random weights and activations from the seed,
    ``MOE_TOKENS`` tokens in ``MOE_GROUPS`` dispatch groups on one card (a
    4 x 1 mesh's groups: ``activation_mesh`` over the card four times):
    the grouped dispatch == each group dispatched alone (one group, no
    mesh), bitwise, in the output and, for a loss on each group's rows, in
    the gradients of x, the router and the experts (the shared experts
    left out: they are a dense MLP outside the dispatch). Prints each
    group's dropped pairs, and one group's of all the tokens."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models import mlp
    from repro_torch.sharding.activation import (activation_mesh,
                                                 dispatch_groups)

    G, (B, S) = MOE_GROUPS, MOE_TOKENS
    rows = B // G
    mesh = make_mesh((G, 1), ("data", "model"), [torch.device(dev)] * G)
    notes = []
    for arch in ("mixtral-8x22b", "deepseek-v2-236b"):
        full = configs.get(arch)
        if TRAIN_REDUCED:
            full = full.reduced()
        cfg = full.replace(moe=replace(full.moe, n_shared_experts=0))
        g = torch.Generator(device=dev).manual_seed(SEED)
        p = mlp.init_moe(g, cfg, torch.bfloat16)
        x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(
            torch.bfloat16)
        r = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
        t0 = time.perf_counter()
        with activation_mesh(mesh):
            check(dispatch_groups() == G, f"moe (d): {G} groups")
            with torch.no_grad():
                out = mlp.moe(p, x, cfg)[0]
        with torch.no_grad():
            alone = [mlp.moe(p, x[i * rows:(i + 1) * rows], cfg)[0]
                     for i in range(G)]
        check(all(torch.equal(out[i * rows:(i + 1) * rows], a)
                  for i, a in enumerate(alone)),
              f"moe (d): {arch} grouped output == each group alone")
        del out, alone
        p.requires_grad_(True)
        for i in range(G):
            grads = []
            for grouped in (True, False):
                xi = (x if grouped else x[i * rows:(i + 1) * rows]
                      ).detach().requires_grad_(True)
                with (activation_mesh(mesh) if grouped else nullcontext()):
                    y = mlp.moe(p, xi, cfg)[0]
                if grouped:
                    y = y[i * rows:(i + 1) * rows]
                (y.float() * r[i * rows:(i + 1) * rows]).sum().backward()
                gx = xi.grad[i * rows:(i + 1) * rows] if grouped \
                    else xi.grad
                grads.append([gx] + [t.grad for t in p.parameters()])
                for t in p.parameters():
                    t.grad = None
                del y, xi
            check(all(torch.equal(a, b) for a, b in zip(*grads)),
                  f"moe (d): {arch} group {i}: gradients of x, the router "
                  "and the experts == the group alone")
            del grads
        p.requires_grad_(False)
        mo = cfg.moe
        K = mo.n_experts_per_token
        notes.append(
            f"{arch} ({mo.partition}, E {mo.n_experts} top-{K}, d "
            f"{cfg.d_model}, f {mo.d_ff}, capacity "
            f"{mo.capacity_factor}): dropped pairs by group "
            f"{dropped_pairs(p, x, cfg, G)} of {B * S * K // G} "
            f"each (one group of all {B * S} tokens: "
            f"{dropped_pairs(p, x, cfg, 1)}); "
            f"{time.perf_counter() - t0:.1f} s")
        del p, x, r
        torch.cuda.empty_cache()
    print(f"[sharded-train] (d) grouped MoE dispatch, {B} x {S} tokens in "
          f"{G} groups on one card == each group alone, bitwise (output; "
          "gradients of x, router, experts): " + "; ".join(notes))


# (e): (arch, layers kept: None the whole model) at full width; the cut is
# what one 80 GB card holds at 20 bytes a parameter (bf16 weights and
# gradients, the f32 moments before and after the step) beside the step's
# activations and chunked logits: mixtral 1 of 56 layers (2.9 B
# parameters, ~58 GB), recurrentgemma two periods of its pattern (6 of 38
# layers, 2.2 B, ~45 GB, and 4.2 GB of f32 logits a 512-token chunk over
# its 256,000-token vocabulary); xlstm one period (6 of 12: 5 mLSTM, 1
# sLSTM), for the smoke's time (its token loop is host-bound)
SHARD_FAMILIES = (("mixtral-8x22b", 1), ("recurrentgemma-9b", 6),
                  ("xlstm-125m", 6), ("whisper-base", None))
SHARD_FAMILY_STEPS = 2


# (e)'s (1, 1) launcher runs that share the card at once (~57 GB of its 80
# together; mixtral's ~62 GB runs alone): the smoke's time
SHARD_TOGETHER = ("recurrentgemma-9b", "xlstm-125m", "whisper-base")


@contextmanager
def recorded_drops():
    """Inside: every MoE dispatch's dropped ``(token, k)`` pairs by group,
    one ``(G,)`` tensor a call of ``mlp._dispatch_local`` (the forward's
    and remat's recomputation's) appended to the list it yields."""
    from repro_torch.models import mlp

    inner, seen = mlp._dispatch_local, []

    def record(xg, router, K, E, cap):
        out = inner(xg, router, K, E, cap)
        seen.append((out[2] == E * cap).sum((1, 2)))
        return out

    mlp._dispatch_local = record
    try:
        yield seen
    finally:
        mlp._dispatch_local = inner


def unsharded_run(arch: str, cfg, root: str, groups: int = 1,
                  dev="cuda") -> dict:
    """(e)'s unsharded trainer: ``cfg`` for ``SHARD_FAMILY_STEPS`` steps
    at phase 15's shape on one card, its MoE dispatched in ``groups``
    groups (under ``activation_mesh`` over the card ``groups`` times, as
    (d); no mesh at 1). Returns ``{"losses", "s", "peak" (GiB),
    "launches", "drops"}``, the dispatches' dropped pairs by group."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import trainer as tr
    from repro_torch.sharding.activation import activation_mesh

    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, end_lr=TRAIN_LR / 10,
                           warmup_steps=1, total_steps=SHARD_FAMILY_STEPS)
    tcfg = tr.TrainerConfig(steps=SHARD_FAMILY_STEPS, ckpt_every=0,
                            ckpt_dir=os.path.join(root, f"{arch}-p{groups}"),
                            log_every=100, seed=SEED, batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ)
    placed = nullcontext() if groups == 1 else activation_mesh(make_mesh(
        (groups, 1), ("data", "model"), [torch.device(dev)] * groups))
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    h0 = time.perf_counter()
    with recorded_drops() as seen, placed:
        losses = tr.Trainer(cfg, tcfg, opt_cfg=ocfg, device=dev).run()[
            "losses"]
    res = {"losses": losses, "s": time.perf_counter() - h0,
           "peak": torch.cuda.max_memory_allocated() / 2**30,
           "launches": dict(ops.kernel_launches()),
           "drops": [t.tolist() for t in seen]}
    torch.cuda.empty_cache()
    return res


def loss_gap(got: list, want: list) -> float:
    """The largest relative gap between two runs' losses."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def family_shard_train(root: str, dev="cuda") -> dict:
    """Phase 18 (e): each of ``SHARD_FAMILIES`` through ``launch.train``
    on the ``(1, 1)`` mesh for ``SHARD_FAMILY_STEPS`` steps at phase 15's
    shape, its losses bitwise the unsharded trainer's on the same cut
    config (the unsharded runs first, one at a time; then the launcher
    runs, ``SHARD_TOGETHER``'s at once). The MoE's unsharded run also
    dispatches in G groups (G = N the cards, ``MOE_GROUPS`` on one card):
    both runs' dropped pairs are printed. With two or more cards each
    family also runs on ``(N, 1)`` and ``(1, N)``, within
    ``SHARD_LOSS_RTOL`` of the unsharded run that dispatches as it does:
    the MoE's ``(N, 1)`` (G = N) against the G = N run, everything else
    against G = 1's. Returns the launches counted: the unsharded runs'
    and rank 0's."""
    from repro_torch.launch.train import model_config
    from repro_torch.models.blocks import ATTN_KINDS

    counts, notes, plain, grouped, ones = {}, [], {}, {}, {}
    n = min(torch.cuda.device_count(), SHARD_MAX)
    G = n if n >= 2 else MOE_GROUPS

    def add(launches):
        for k, c in launches.items():
            counts[k] = counts.get(k, 0) + c

    # a rehearsal's reduced configs are whole
    cut = {arch: None if TRAIN_REDUCED else layers
           for arch, layers in SHARD_FAMILIES}
    for arch, _ in SHARD_FAMILIES:
        cfg = model_config(arch, TRAIN_REDUCED, cut[arch])
        plain[arch] = unsharded_run(arch, cfg, root, dev=dev)
        add(plain[arch]["launches"])
        if cfg.moe.n_experts:
            grouped[arch] = unsharded_run(arch, cfg, root, G, dev)
            add(grouped[arch]["launches"])
    for arch, _ in SHARD_FAMILIES:
        if arch not in SHARD_TOGETHER:
            ones[arch] = shard_train((1, 1), root, arch=arch,
                                     layers=cut[arch],
                                     steps=SHARD_FAMILY_STEPS)
    started = [(arch, start_train((1, 1), root, arch=arch,
                                  layers=cut[arch],
                                  steps=SHARD_FAMILY_STEPS))
               for arch in SHARD_TOGETHER]
    for arch, run in started:
        ones[arch] = finish_train(run)
    for arch, _ in SHARD_FAMILIES:
        cfg = model_config(arch, TRAIN_REDUCED, cut[arch])
        want, one = plain[arch]["losses"], ones[arch]
        check(one["losses"] == want, f"sharded (e): {arch} (1, 1) losses "
              f"== the unsharded trainer's bitwise: {one['losses']} vs "
              f"{want}")
        attn = sum(k in ATTN_KINDS for k in cfg.pattern)
        if cfg.is_encoder_decoder:  # the encoder's and the cross layers'
            attn += cfg.n_encoder_layers + cfg.n_layers
        per_step = attn * (2 if cfg.remat == "full" else 1)
        check(one["launches"]["flash_attention"]
              == per_step * SHARD_FAMILY_STEPS,
              f"sharded (e): {arch} (1, 1) flash_attention launches "
              f"{one['launches']['flash_attention']} == {per_step} a step")
        add(one["launches"])
        line = (f"{cfg.name} ({cfg.n_layers} of {model_config(arch).n_layers}"
                f" layers, {cfg.n_params() / 1e9:.3f} B params) "
                f"unsharded {plain[arch]['s']:.1f} s (peak "
                f"{plain[arch]['peak']:.1f} GiB), (1, 1) "
                f"launcher {one['s']:.1f} s"
                f"{' (beside the others)' if arch in SHARD_TOGETHER else ''}"
                f": losses {one['losses']} == unsharded, bitwise; "
                f"flash_attention {one['launches']['flash_attention']} "
                "launches")
        if arch in grouped:
            gr = grouped[arch]
            line += (f"; its dispatches' dropped pairs by group (forward "
                     f"and remat, step by step): G = 1 "
                     f"{plain[arch]['drops']}, G = {G} {gr['drops']}; "
                     f"unsharded at G = {G} {gr['s']:.1f} s, losses "
                     f"{gr['losses']}, gap to G = 1 "
                     f"{loss_gap(gr['losses'], want):.3e}")
        for shape in ([(n, 1), (1, n)] if n >= 2 else []):
            by_groups = shape[0] > 1 and arch in grouped
            ref = grouped[arch] if by_groups else plain[arch]
            run = shard_train(shape, root, arch=arch, layers=cut[arch],
                              steps=SHARD_FAMILY_STEPS)
            gap = loss_gap(run["losses"], ref["losses"])
            what = f"G = {G}" if by_groups else "unsharded"
            check(gap <= SHARD_LOSS_RTOL, f"sharded (e): {arch} {shape} "
                  f"losses within {SHARD_LOSS_RTOL} of one card's ({what}: "
                  f"{ref['losses']}; got {run['losses']}, gap {gap:.3e})")
            line += (f"; {shape} {run['s']:.1f} s, losses {run['losses']}, "
                     f"gap to one card's ({what}) {gap:.3e}")
        notes.append(line)
        torch.cuda.empty_cache()
    print(f"[sharded-train] (e) {SHARD_FAMILY_STEPS} steps at {TRAIN_BATCH} "
          f"x {TRAIN_SEQ}, full width: " + "; ".join(notes))
    if n < 2:
        print(f"[sharded-train] (e) (N, 1) and (1, N): "
              f"{torch.cuda.device_count()} visible card(s), not run")
    return counts


def census_step(dev="cuda") -> dict:
    """Phase 18 (b): phase 17 (b)'s one-card qwen2 step under the census
    on the card and on ``meta``: the two == on the counted keys; the
    step's peak bytes on ``meta`` within ``CENSUS_TEMP_RTOL`` of the
    card's ``max_memory_allocated`` less its arguments; ``t_compute`` and
    ``t_memory`` of ``roofline_terms`` each at most the step's device
    time. Returns the step's launch counts."""
    from repro_torch import configs
    from repro_torch.analysis.census import Census, roofline_terms
    from repro_torch.analysis.flops import FlopCounter
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import batch_struct, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import OptimizerConfig, init_opt_state

    cfg = configs.get(TRAIN_ARCH)
    shape = ShapeSpec("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ocfg = OptimizerConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, ocfg)

    def cell(device):
        params = lm.init_lm(SEED, cfg, device=device).requires_grad_(True)
        batch = batch_struct(cfg, shape, device)
        if device != "meta":
            g = torch.Generator(device=device).manual_seed(SEED)
            for t in batch.values():
                t.copy_(torch.randint(0, cfg.vocab_size, t.shape,
                                      generator=g, device=device))
        return params, init_opt_state(params, ocfg), batch

    args = cell(dev)
    out = step(*args)  # warm: cuBLAS handles and workspaces
    del out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with Census() as card:
        out = step(*args)
    torch.cuda.synchronize()
    peak_card = torch.cuda.max_memory_allocated() - base
    got = card.result()
    del out
    counts = dict(ops.kernel_launches())
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: step(*args), 3)
    del args
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_args = cell("meta")
    with Census() as meta:
        out = step(*meta_args)
    want = meta.result()
    del out
    meta_s = time.perf_counter() - t0
    for k in _CENSUS_EXACT:
        diff = {op: (card.bytes_by_op.get(op), meta.bytes_by_op.get(op))
                for op in set(card.bytes_by_op) | set(meta.bytes_by_op)
                if card.bytes_by_op.get(op) != meta.bytes_by_op.get(op)}
        check(got[k] == want[k], f"census (b): the card's {k} == meta's "
              f"(ops card/meta {census_diff(got['hlo_ops'], want['hlo_ops'])}"
              f"; bytes by op card/meta {diff})")
    gap = abs(want["peak_bytes"] - peak_card) / peak_card
    check(gap <= CENSUS_TEMP_RTOL, f"census (b): meta's peak "
          f"{want['peak_bytes']} B within {CENSUS_TEMP_RTOL:.0%} of the "
          f"card's max_memory_allocated less its arguments {peak_card} B "
          f"(gap {gap:.2%})")
    meta_args = cell("meta")
    with FlopCounter() as fc:
        out = step(*meta_args)
    del out, meta_args
    roof = roofline_terms(fc.flops, want["device_hbm_bytes_flash_adjusted"],
                          want["collective_bytes"], 1)
    step_s = ms / 1e3
    for k in ("t_compute_s", "t_memory_s"):
        check(roof[k] <= step_s, f"census (b): roofline {k} {roof[k]:.4f} s "
              f"<= the step's {step_s:.4f} s on the card")
    print(f"[census] (b) {TRAIN_ARCH} step {TRAIN_BATCH} x {TRAIN_SEQ} on the "
          f"card == meta on {', '.join(_CENSUS_EXACT)}; collectives "
          f"{want['collective_bytes']}; traffic "
          f"{want['device_hbm_bytes']:.6e} B plain, "
          f"{want['device_hbm_bytes_flash_adjusted']:.6e} B adjusted; peak: "
          f"meta {want['peak_bytes']} B, card {peak_card} B (gap {gap:.2%}); "
          f"temp_bytes {want['temp_bytes']} B; step {ms:.2f} ms on the card, "
          f"roofline compute {roof['t_compute_s'] * 1e3:.2f} ms, memory "
          f"{roof['t_memory_s'] * 1e3:.2f} ms ({roof['dominant']}); meta "
          f"census {meta_s:.1f} s")
    return counts


def census_diff(a: dict, b: dict) -> dict:
    """The keys on which two censuses' dicts differ, with both values."""
    return {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
            if a.get(k) != b.get(k)}


def census_grid(cells: list) -> None:
    """Phase 18 (c): every ``ok`` cell of phase 17 (a) on ``CENSUS_MESH``
    carries the census keys (all ten families run sharded), and their
    ``census_s`` is printed; the compiler's own keys stay ``null``. Every
    cell equals the committed record (``launch/census_16x16.json``, made
    on another PyTorch build), key by key: the collective bytes by kind
    and the temp bytes exactly, the op census and the traffic but for the
    ATen ops ``dryrun.BUILD_DECOMPOSED`` names."""
    from repro_torch.launch import dryrun

    counted = [c for c in cells if c["status"] == "ok"
               and c["mesh"] == CENSUS_MESH]
    archs = {c["arch"] for c in counted}
    check(len(counted) == 34 and len(archs) == 10, f"census (c): 34 cells "
          f"of ten families on {CENSUS_MESH}, got {len(counted)} "
          f"({sorted(archs)})")
    for c in counted:
        filled = all(c[k] is not None for k in dryrun.CENSUS_KEYS) and \
            c["memory"]["temp_bytes"] is not None and c["census"] == "ok"
        check(filled, f"census (c): {c['arch']} x {c['shape']} census keys "
              f"filled: {c['census']}")
        check(all(c[k] is None for k in dryrun.COMPILER_KEYS
                  if k not in dryrun.CENSUS_KEYS),
              f"census (c): {c['arch']} x {c['shape']} compiler keys null")
    with open(dryrun.RECORD) as f:
        record = json.load(f)
    diffs = dryrun.record_diff(cells, record)
    for cell, key, got, want in diffs:
        print(f"[census] (c) {cell}: {key} {got!r} here, {want!r} in the "
              f"record (torch {record['torch']})")
    check(not diffs, f"census (c): every cell == the record made on torch "
          f"{record['torch']} ({len(diffs)} differences)")
    print(f"[census] (c) {len(counted)} cells == the record made on torch "
          f"{record['torch']} (here {torch.__version__}): collective bytes "
          f"and temp bytes exactly, ops and traffic but for "
          f"{sorted(dryrun.BUILD_DECOMPOSED)}")
    secs = sum(c["census_s"] for c in counted)
    print(f"[census] (c) {len(counted)} cells on {CENSUS_MESH}: "
          f"{secs:.1f} s of census in phase 17 (a)'s workers; "
          + "; ".join(f"{c['arch']} {c['shape']}: coll "
                      f"{sum(c['collective_bytes'].values()):.4e} B, temp "
                      f"{c['memory']['temp_bytes']} B, {c['census_s']:.1f} s"
                      for c in counted))


def sharded_train_phase(cells: list, dev="cuda") -> dict:
    """Phase 18: (a) the sharded trainer and the route's blocks, (b) the
    census of a one-card step, (c) the census keys of the dry run's
    cells, (d) the grouped MoE dispatch, (e) the other families through
    the sharded trainer."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as root:
        counts = sharded_train_path(root, dev)
        torch.cuda.empty_cache()
        grouped_moe(dev)
        torch.cuda.empty_cache()
        for k, n in family_shard_train(root, dev).items():
            counts[k] = counts.get(k, 0) + n
    torch.cuda.empty_cache()
    for k, n in census_step(dev).items():
        counts[k] += n
    census_grid(cells)
    print(f"[sharded-train] phase 18 in {time.perf_counter() - t_phase:.1f}"
          f" s; launches {counts}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=1024,
                    help="tenants; the one size that may be cut")
    ap.add_argument("--window", type=int, default=1024,
                    help="sliding window, also the capacity (a smaller "
                    "one only for a quick rehearsal)")
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per kernel")
    ap.add_argument("--train-resume", metavar="DIR",
                    help="phase 15 (c)'s child process (started by the "
                    "phase itself)")
    ap.add_argument("--remat-dots", metavar="DIR",
                    help="phase 16 (e)'s child process (started by the "
                    "phase itself)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if args.train_resume:
        return resume_child(args.train_resume)
    if args.remat_dots:
        return dots_child(args.remat_dots)
    t_start = time.perf_counter()

    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import _build

    S, W, P, M, L = args.sessions, args.window, DIM, QUERIES, N_LABELS
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds or 0.0:.1f} s); "
          + " | ".join(ptxas_summary(_build.build_log)) + "; tiles "
          + tile_constants())
    print("[sass] static instruction mix of the batch and read kernels: "
          + sass_counts(sass_functions(), SASS_KERNELS))

    g = torch.Generator(device="cuda").manual_seed(SEED)
    table = [check_stream_update(g, S, W, P, K, args.iters),
             check_stream_update_reg(g, S, W, P, K_REG, args.iters),
             check_pairwise(g, S, M, W, P, args.iters),
             check_cp_counts(g, S, M, W, P, K, L, args.iters),
             check_interval_sweep(g, S, M, W, P, K_REG, args.iters)]
    X, y = make_classification(N_BATCH + M + N_VALID, P, seed=SEED)
    X = torch.as_tensor(X, dtype=torch.float32, device="cuda").contiguous()
    y = torch.as_tensor(y, dtype=torch.int32, device="cuda")
    Xb, yb = X[:N_BATCH].contiguous(), y[:N_BATCH].contiguous()
    Xq, Xv, yv = X[N_BATCH:N_BATCH + M], X[N_BATCH + M:], y[N_BATCH + M:]
    row, prelim = check_kde_rowsums(g, Xb, yb, max(args.iters // 2, 20))
    table.append(row)
    torch.cuda.empty_cache()

    by_path = {"classification": classification_path(S, W, table[0],
                                                     args.iters)}
    torch.cuda.empty_cache()
    by_path["regression"] = regression_path(S, W, table[1], args.iters)
    torch.cuda.empty_cache()
    by_path["batch"] = batch_path(Xb, yb, Xq, Xv, yv, prelim)
    batch_exactness(Xb, yb, Xq)
    table.append(check_flash_attention(g, args.iters))
    torch.cuda.empty_cache()
    by_path["lm"] = lm_path()
    torch.cuda.empty_cache()
    by_path["compact"] = compact_exactness(S, args.iters)
    compact_timing(S, W)
    by_path["bootstrap"] = bootstrap_path()
    torch.cuda.empty_cache()
    by_path["regression_registry"] = regression_registry_path(args.iters)
    by_path["figures"] = figures_path()
    torch.cuda.empty_cache()
    by_path["serving_shell"] = serving_shell_path(S, W, args.iters)
    torch.cuda.empty_cache()
    by_path["replay"] = replay_path(S, W, args.iters)
    torch.cuda.empty_cache()
    by_path["families"] = families_path()
    torch.cuda.empty_cache()
    by_path["recurrent_frontends"] = fronts_path()
    torch.cuda.empty_cache()
    by_path["train"] = train_path()
    torch.cuda.empty_cache()
    by_path["sharded"] = sharded_path(S, W, Xb, yb, Xq, args.iters)
    torch.cuda.empty_cache()
    by_path["dryrun"], cells = dryrun_path()
    torch.cuda.empty_cache()
    by_path["sharded_train"] = sharded_train_phase(cells)
    for row in table:
        row["launches_by_path"] = {path: c[row["name"]]
                                   for path, c in by_path.items()
                                   if c[row["name"]]}
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] > 0, f"{row['name']} launched on a main path")

    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}"
          " s, the build included")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
