#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100): builds the CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's two
paths at full width (ResNet-8's convolutions; TinyLlama-1.1B serving
through the CUDA graph of its decode step), times the kernels, runs the
port's host stack (timelines and drift report, fault-injected recovery,
the plan server, the lint), serves the rest of the transformer family at
its published width, serves the SSM, hybrid and encoder-decoder
families (Mamba2-2.7B, Zamba2-2.7B, Whisper-medium) whole, and trains:
every id at its reduced config against the CPU, TinyLlama-1.1B whole
through the training launcher, and the launcher's checkpoint and restart;
and runs the mesh path: TinyLlama-1.1B trained and served on a (1, 1)
``DeviceMesh`` through the ``dist_*`` steps, and the dry run of a
production-mesh cell.

    python3 chip_smoke.py [--json PATH]

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. card and set-up: ``nvidia-smi``'s name and power limit, versions, the
   build of ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc`` per source,
   started together), what ``ptxas`` says of each kernel (registers,
   spills), the shared-memory formulas, K1's cluster-shape rule, K2's
   reduction-group rule and the block GeMM's core rule (wgmma, mma.sync,
   fma) of the CUDA sources against the planner's, K2's
   groups at each ResNet-8 layer, K5's split plan at TinyLlama's shape,
   each ResNet-8 layer's K1 cluster
   (``cs_n x cs_t`` blocks), ring depth and shared memory per block, and
   how many of K1's and K4's
   clusters fit on the card at once (``cudaOccupancyMaxActiveClusters``,
   which must be > 0);
2. each kernel against its plain version on the card, at every ResNet-8
   layer's shape and plan and at the geometry cases of the CPU tests, both
   sweep orders, float32 and bfloat16; K1 also at the geometry cases with
   8, 16, 32 and 64 kernel channels (1, 2, 4 and 8 channel groups), and
   at the column cases launched as every cluster of 1 to 8 blocks they
   take (channel groups x column groups, against the plain version split
   the same way), where each launch's count of fetched elements must be
   the boxes the plain version slices plus Λ; K5 split over 2-32 ranges
   at TinyLlama's
   heads, lengths 0, 1, on a range boundary, one row past one and S,
   against the plain split-then-combine, and the combine alone on the
   plain partials against the plain combine;
3. the main path: ``NETWORKS["resnet8"]`` planned with
   ``plan_emitable_network`` under ``H100_SXM``'s shared-memory budget,
   every layer emitted, seeded inputs run through ``EmittedConv.run`` (the
   planned kernel) and ``ops.conv2d`` (the simple kernel), each output held
   against the oracle ``ref.conv2d``; the launch counters and K1's fetch
   counter are set to 0 just before and must show every call, and the
   plans' charged loads, just after;
4. times per layer: each kernel's wrapper, its plain version,
   ``F.conv2d`` in full f32 (cuDNN's TF32 switched off for the call; the
   TF32 time printed beside it) as the library call, the bound from the
   card's data-sheet rates, and K1 launched as one block (1 x 1) beside
   its cluster; K1's rows also give its cluster, ring depth, steps and
   microseconds a step, in float32 and bfloat16;
5. the block GeMM kernels (K3, K4) and the decode-attention kernels (K5:
   the split kernel and its combine) against their plain versions on the
   card, float32 and bfloat16: all six
   loop orders, which must agree bit for bit, at the CPU tests' shapes, at
   the smallest tiles, at shapes whose K4 clusters are ragged, at tiles of
   48 and 80 rows, and at the planner's tiles for TinyLlama's prefill
   projections (each launch's core, cluster size and grid printed; a
   launch on another core than ``core_of``'s fails the run, and so does
   a planned bfloat16 prefill tile that did not run on wgmma);
   ``ops.matmul`` with the planner's 48- and 80-row tiles and at m = 4
   against ``ref.matmul``; the decode kernels at the CPU tests'
   shapes and at TinyLlama's (B=4, H_q=32, H_kv=4, D=64) for S = 512 and
   4096 with the planner's splits and bkv, and S = 48 and 200, which pad;
   K5 at the other GQA ids' query groups, G = 5, 6, 7 and 8 at D = 128
   (B = 4, S = 512, bfloat16, the planner's splits); K5 at phase 11's
   serving shapes, float32 and bfloat16, the planner's splits: Zamba2's
   shared attention (B = 4, 32/32 heads, D = 80, S = 512), Whisper's
   self-attention (16/16 heads, D = 64, S = 448) and cross-attention (1500
   valid rows in the 1536 its prefill stores);
   the simple conv kernel K2 through ``ops.conv2d`` at every ResNet-8 layer
   and the geometry cases, both orders, against ``ref.conv2d`` and its
   plain version; then ``ops.matmul`` driven over those projections with
   counters reset before and read after;
6. the serving path: ``repro_torch.launch.serve``'s loop on
   ``tinyllama-1.1b`` at its full config (22 layers, ~1.1 B bfloat16
   parameters from a seeded generator), batch 4, 480-token prompts, 32
   generated tokens, once with eager steps and once through the CUDA
   graph of the step (``steps.graph_decode_step``), each loop's decode
   ms/step printed, and the capture's ms apart; at 3 teacher-forced
   positions the eager decode logits must agree with the prefill of the
   same tokens, and the graph's with the eager step's (bit-identity
   printed); the decode kernel pair must be launched 22 x 32 times,
   counted as the launches one replay makes (from the capture) times the
   replays, and the combine as often when the planner splits the cache;
   ``torch.profiler``'s device events of both kernels over 8 more
   replays (taken after phase 7's timings, printed as ``[6]``) must be
   the launches per replay times 8 in one of up to 3 profiler sessions
   (the profiler drops a few events at random, see PROFILE_SESSIONS) and
   more in none, and give the device's busy share of a replayed step;
7. times of K3, K4 and K5 at those shapes: the call, the kernel alone, the
   plain version, the library call (``torch.matmul``,
   ``F.scaled_dot_product_attention`` on the repeated cache) and the bound;
   K5 also at phase 11's three serving shapes in bfloat16;
   for K5 the planner's splits and bkv, the split and combine kernels'
   own device times, and the split kernel run as one range per
   (b, kv_head) beside it;
   for K3 and K4 also a model figure, printed only, from the plan's own
   bytes (``_gemm_bytes``, K4's f32 partials included);
8. the traffic contract, layer by layer: ``analysis.kerncheck.run_all()``
   (every registered network's K1 cluster traces, the GeMM and decode
   schedules; each GeMM on the core ``block_matmul.core_of`` picks, so
   the planner's TinyLlama prefill tiles as wgmma rings and, in a K4
   cluster, rank 0's pushes of the resident tile, each printed with its
   hazard count) and ``check_network("resnet8")`` on phase 3's plan, both
   clean; the port's simulator (``sim.simulate_network``) runs that plan,
   correct, with exact accounting and its peak within budget; then each
   of ResNet-8's 7 layers goes to the card in float32 through
   ``EmittedConv.run`` on the simulator's seeded arrays, with K1's fetch
   counter zeroed just before, and five counts must be equal: the card's
   fetched elements, the simulator's DRAM reads, kerncheck's
   ``kern/traffic`` total, the plan's ``pixels_loaded() * C_in`` + the
   kernel set, and the layer's ``dma_in`` elements in
   ``obs.adapters.kernel_timeline`` of the plan; K1's output must agree
   with the simulator's;
9. the framework-free stack on the card machine's host, each check
   failing the run: (a) ``obs.report.build_report("resnet8")`` with the
   kernel timeline, its Chrome trace written to
   ``chiprun_out/obs_trace_resnet8.json``, valid, every lane present, the
   simulation correct and exactly accounted, zero drift, the kernel rows
   reconciled; (b) ``resil.faultsim.run_checked`` on ResNet-8 over a
   ``torus2x2`` cluster under the ``mixed`` schedule of seed 0: outputs
   exactly once and equal to the reference convolution, the twin run's
   fingerprint equal, the trace in ``chiprun_out/``; (c) a
   ``launch.plan_server.PlanService`` sweep of ResNet-8 into a temporary
   cache directory, cold then warm after a restart of every cache layer:
   the warm pass served from the store alone (no miss, no write) with the
   cold pass's plan fingerprints; (d) ``analysis.lint.run_lint`` over
   ``src/repro_torch``: no finding.  Each check prints its seconds;
10. the rest of the transformer family at its published width, one id
   after another, each freed before the next: Qwen2-7B (all 28 layers),
   DBRX-132B (4 of 40), DeepSeek-V2-236B (2 of 60), Qwen2.5-14B (2 of
   48), Qwen2.5-32B (2 of 64), Chameleon-34B (2 of 48), depth alone cut
   (``dataclasses.replace``), random weights from the seed, batch 4,
   480-token prompts, 8 graph-replayed decode steps: parameters and peak
   memory, the teacher-forced checks of phase 6 (MLA within
   ``MLA_REL_TOL``), K5 pairs equal to layers x steps for every GQA id
   and none for DeepSeek's MLA (the profiler's events agreeing), tokens
   of shape (4, 8), decode ms/step, the busy share, the seconds;
11. the SSM, hybrid and encoder-decoder families at published width and
   depth, one after another, each freed before the next: Mamba2-2.7B,
   Zamba2-2.7B (480-token prompts) and Whisper-medium (1500 frames of
   stub embeddings, decoding from position 1), random weights from the
   seed, batch 4, 32 graph-replayed decode steps.  Checks, each failing
   the run: the graph's logits equal the eager step's bit for bit at
   three teacher-forced positions; Mamba2's and Zamba2's decode against
   the prefill of the same tokens within the larger of ``SSD_REL_TOL``
   (the JAX package's bound) and twice the bf16 prefill's own distance
   from the same prefill in float32, and within ``SSD_REL_TOL`` itself at
   the JAX test's depth (2 layers) and published width; Whisper's decode
   chain against ``encdec.decode_train`` of the same tokens within
   ``WHISPER_REL_TOL``; K5's pairs over the replays equal to 0 for
   Mamba2, 9 a step for Zamba2, 48 for Whisper, and so are the profiler's
   split and combine events over 8 more replays (as in phase 6), the host
   counters (zeroed before the loop) equal to the warm-up's and the
   capture's; the fused recurrent update's launches
   (``ssd_update_kernel`` in ``obs.counters``, zeroed before the loop)
   one a layer a replay for Mamba2 and Zamba2 and none for Whisper, and
   on the host the warm-up's and the capture's steps.  It prints
   parameters, prefill ms, capture ms, decode ms/step, tokens/s, the busy
   share of a replayed step, peak memory, and the top device operations
   of one eager step;
12. training (the JAX package's training path reaches no Pallas kernel,
   so none of K1-K5 runs here): (a) every id of the registry at its
   reduced config in float32, the same seeded parameters and batch on the
   card and on the CPU, the loss within 1e-5 and every gradient within
   1e-4 of its norm, then 4 AdamW steps at lr 5e-3 on the batch in
   bfloat16, which must lower the loss; (b) TinyLlama-1.1B whole through
   ``launch.train.train``, global batch 8 x 1024 tokens of the
   SyntheticLM pipeline in 2 microbatches, 8 steps: every loss, the step
   ms (median of steps 3-8), tokens/s, model FLOP/s from
   ``launch.model_flops`` and peak memory; the last loss must be below the
   first and none NaN; (c) the launcher at the reduced TinyLlama: 4 steps
   with a checkpoint every 2, a restart to step 6 (it must resume at 4,
   run two steps, with its state on the card) and another (no step), and
   an uninterrupted 6-step run whose losses at steps 5-6 the restart's
   must match within ``RESUME_REL_TOL`` (PyTorch's deterministic
   algorithms on; bit-identity printed); (b) is the CLI's ``--full``
   (``train(smoke=False)``: the (1, 1) mesh of one card, whose local
   program runs), the baseline of phase 13;
13. the mesh: (a) a one-rank NCCL group over an in-process store and
   ``launch.mesh.make_smoke_mesh()``, (1, 1), and its ``Axes``; (b)
   TinyLlama-1.1B whole trains 4 steps through the launcher's loop with
   the mesh's axes, every step ``steps.dist_train_step``, at phase 12 (b)'s
   batch: its losses within ``MESH_TRAIN_REL_TOL`` of phase 12 (b)'s first
   four (bit-identity printed), its step ms beside phase 12's; (c)
   TinyLlama-1.1B whole served teacher-forced through
   ``steps.dist_prefill_step`` and 8 ``steps.dist_decode_step`` steps (the
   decode layout; K5 through ``local_map`` on the DTensors' shards):
   the logits within ``SERVE_REL_TOL`` of the un-meshed steps at the same
   tokens, K5's launches counted by its wrapper (zeroed before) and by
   the profiler's split and combine events in one of up to
   ``PROFILE_SESSIONS`` sessions; and the serve driver's loop on the
   mesh (the decode graph over the local program) generates the
   un-meshed loop's tokens; (c') the decode of a cache whose sequence is
   split over 2, 4 and 16 devices (several cards; the (1, 1) mesh never
   splits it): each shard's K5 split kernel into the workspace, within
   ``SHARD_PARTIAL_TOL`` of the plain partials, and the shards' partials
   through the combine within ``SHARD_COMBINE_TOL`` of the pair on the
   whole cache; (d) ``python -m
   repro_torch.launch.dryrun`` of TinyLlama ``decode_32k`` in a process of
   its own (a fake group of 256 ranks; no card), its ``memory`` and
   ``analyzed`` printed; (e) TinyLlama-1.1B's prefill of one row through
   ``dist_prefill_step`` (the cache's rows padded on the shards,
   ``layers.pad_end``), its logits and cache against the un-meshed
   prefill's (``MESH_CACHE_TOL``); (f) Mamba2-2.7B at full width,
   ``MESH_MAMBA_LAYERS`` layers, through ``dist_prefill_step`` (4 x 480
   tokens), one ``dist_decode_step`` of the prompt's last token and one
   ``dist_train_step`` (``MESH_MAMBA_TRAIN``), the SSD layer split by
   heads, against the un-meshed steps from the same weights: logits, the
   cache's state, the decode's logits (the fused recurrent update
   launched once a layer on the shards), the loss and the gradients'
   norm.  The group is destroyed before (d);
14. the port's examples on the card, each in a process of its own that
   must exit 0, its seconds printed beside the card's name and power
   limit: ``examples/torch_serve_decode.py`` (K5 counted by its wrapper,
   the decode graph replayed, the ids of the shape asked for),
   ``examples/torch_train_lm.py`` at its defaults (the loss falls) and
   ``examples/torch_optimize_offload.py`` (its H100 bridge printed);
15. the fused Mamba-2 recurrent update (``kernels/ssd_update.py``) at
   Zamba2-7B's decode shape (B 64, H 112, P 64, N 64, G 2) and
   Mamba2-2.7B's (B 64, H 80, P 64, N 128, G 1), bfloat16 inputs and a
   float32 state, against its plain version: the state in place within
   ``SSD_UPDATE_STATE_RTOL``, ``y`` within one bfloat16 ulp beyond what
   the order of the float32 sum over N may move it, one launch counted;
   then over ``SSD_UPDATE_LAYERS`` layers' states side by side (as a
   stacked cache holds them, each past the 50 MB L2), in turns: the
   kernel alone (CUDA events over launches, one layer after the next),
   its device time from the profiler, the plain version as the decode
   step ran it before the kernel (``ssd_update_plain`` and the copy of
   its state into the cache) and the bound, the state read once and
   written once at ``HBM_BYTES_PER_S``;
16. K5 at the decode cells' shapes (``K5_CELL_SHAPES``: Qwen2-7B's long
   and short cells, Zamba2-7B's chat cell), bfloat16: against the plain
   version at ragged lengths, with its launches counted, then the pair
   alone beside its byte bound, with the plan (tile, stages, warps,
   splits) and the split kernel's blocks resident an SM, registers and
   spills on the card.

In phases 6, 10 and 11, every graph capture of a serving check also
watches K5's wrapper and ``ops._pad_to``: one replay's K5 launches must
read k and v from the cache's own layer views (data pointers), and no
padding copy may be made, since prefill sizes the caches to the rows the
kernel's plan walks.

The second-to-last line is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  There is no CPU mode: without a CUDA
device the script exits non-zero before anything else.  It imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260311
INPUTS_PER_LAYER = 8
KERNEL_NAMES = ("conv2d_offload", "conv2d_offload_planned")
SOURCES = KERNEL_NAMES + ("block_matmul", "flash_decode", "ssd_update")
GEMM_NAMES = ("block_matmul_osta", "block_matmul_rmw")
K5_NAMES = ("flash_decode", "flash_decode_combine")
ORDERS = ("mnk", "nmk", "mkn", "nkm", "kmn", "knm")

# Tolerances, |got - want| <= atol + rtol * |want|.  float32: both sides sum
# at most 576 products in f32, in another order.  bfloat16: products and sum
# are exact in f32 on both sides, so the results differ by the final
# rounding to bfloat16, one unit in the last place (2**-7 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1.6e-2, 1e-2)}

# GeMM and decode inputs are scaled so every sum is O(1) (B ~ N(0, 1/k)),
# so the same two tolerances hold: float32 sums differ by their order
# only, bfloat16 results by one final rounding.  The serving check holds
# teacher-forced decode logits against the prefill of the same tokens,
# relative to the largest logit: both paths compute in bfloat16 with f32
# sums, but cuBLAS picks other algorithms for a (4, d) and a (4*T, d)
# product, so the projections round differently, and that difference
# grows through 22 layers.
SERVE_REL_TOL = 5e-2
# MLA's absorbed decode takes its products in another order than
# prefill's decompressed attention: the JAX package's own bound for the
# two (tests/test_models_smoke.py:78-81), which also covers the card's
# rounding of the projections over phase 10's two layers.
MLA_REL_TOL = 0.02

# The block GeMM cases of the CPU tests (tests/test_kernels.py:57-62) and
# five more: the smallest tiles (idle warps), a 16-row tile beside a
# full-width one (K4 clusters of 8 over 9 m tiles, of 5 over 5 n tiles),
# 10 x 9 tiles of 32 (K4 clusters of 8, ragged both ways), and tiles of 48
# and 80 rows (an odd number of 16-row fragments); then products the
# planner gives 48- and 80-row tiles, and one with m = 4; the decode
# cases (tests/test_kernels.py:84-89) and TinyLlama-1.1B's shapes: its
# prefill projections (m = 4 prompts x 480 tokens, (k, n)) and its decode
# attention (B, H_q, H_kv, D) over caches of S rows.
MATMUL_CASES = [(64, 64, 64, 32, 32, 32), (200, 150, 300, 64, 64, 64),
                (128, 128, 128, 128, 128, 128), (96, 257, 130, 32, 64, 64),
                (48, 80, 48, 16, 16, 16), (144, 640, 160, 16, 128, 32),
                (320, 288, 96, 32, 32, 32), (96, 160, 96, 48, 32, 32),
                (160, 240, 64, 80, 80, 32)]
PLANNED_SMALL_M = [(40, 8192, 2048), (80, 8192, 2048), (4, 2048, 2048)]
# K3 on its wide tiles and over every cluster shape it takes (the gpu
# tests' cases): (m, n, k, bm, bn, bk, (cm, cn))
K3_CLUSTER_CASES = [
    (256, 512, 256, 128, 256, 64, (1, 1)),
    (256, 512, 256, 128, 256, 64, (2, 1)),
    (256, 512, 256, 128, 256, 64, (1, 2)),
    (256, 512, 256, 128, 256, 64, (2, 2)),
    (128, 512, 128, 64, 256, 128, (2, 2)),
    (256, 256, 64, 64, 128, 16, (2, 1)),
]
# the square products the planner prices: 2048^3 against the plain
# version, 8192^3 (its roofline case) against torch.matmul in f32
SQUARE_CHECKED = 2048
SQUARE_ROOFLINE = 8192
PREFILL_M = 4 * 480
PREFILL_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]
DECODE_CASES = [(1, 4, 4, 32, 128, 64), (2, 8, 2, 64, 256, 64),
                (2, 8, 1, 64, 256, 128), (1, 16, 4, 128, 512, 256)]
LLAMA_DECODE = (4, 32, 4, 64)
# K5 beyond TinyLlama's heads, (b, hq, hkv, d, s, bkv, splits): Zamba2-2.7B's
# attention (32 heads of D = 80, lanes rounded up past D), and G = 12 and 16
# query rows per KV head (two blocks of at most 8 per range)
WIDE_DECODE_CASES = [(3, 32, 32, 80, 512, 64, 4), (3, 24, 2, 48, 256, 32, 4),
                     (2, 16, 1, 128, 256, 32, 2)]
# K5 at the heads of the other GQA ids, (H_q, H_kv), D = 128: Qwen2.5's
# G = 5, DBRX's 6, Qwen2-7B's 7, Chameleon's 8
FAMILY_HEADS = [(40, 8), (48, 8), (28, 4), (64, 8)]
LLAMA_S = (512, 4096)
# K5 at the serving shapes of phase 11, (B, H_q, H_kv, D, cache rows, valid
# rows): Zamba2-2.7B's shared attention over its 512-row cache (480-token
# prompts padded to the chunk, 32 new tokens); Whisper-medium's decoder
# self-attention over dec_seq = 448 rows and its cross-attention over the
# 1500 encoder rows, stored padded to the planner's 1536
SERVING_DECODE = {"Zamba2 shared": (4, 32, 32, 80, 512, 512),
                  "Whisper self": (4, 16, 16, 64, 448, 448),
                  "Whisper cross": (4, 16, 16, 64, 1536, 1500)}
# cache lengths that pad to the split rule's grain
PADDED_S = (48, 200)
# K5's (splits, bkv) at TinyLlama's heads beside the planner's (8, 16) and
# (32, 16): fewer and more ranges, other grains
SPLIT_CASES = {512: [(2, 64), (4, 32), (8, 64), (16, 32)],
               4096: [(8, 512), (16, 256), (32, 128)]}
SERVE = dict(batch=4, prompt_len=480, gen_len=32)
# Phase 10: the other transformer ids at their published width, each with
# the depth it is cut to (None: all of it) where the whole model would not
# fit on one card or in the run's time; 8 graph-replayed decode steps.
FAMILY = [("qwen2-7b", None), ("dbrx-132b", 4), ("deepseek-v2-236b", 2),
          ("qwen2.5-14b", 2), ("qwen2.5-32b", 2), ("chameleon-34b", 2)]
FAMILY_SERVE = dict(batch=4, prompt_len=480, gen_len=8)
# Phase 11: the SSM, hybrid and encoder-decoder ids whole (all fit one
# card at published width and depth), 32 graph-replayed decode steps;
# Whisper encodes its published 30-second window of 1500 frames and
# decodes from position 1
SSD_FAMILIES = ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium")
SSD_SERVE = dict(batch=4, prompt_len=480, gen_len=32)
WHISPER_FRAMES = 1500
# Replays that phases 6 and 11 profile after their serving runs, as phase
# 10 profiles its 8.  The profiler misses a few device events of a
# replayed graph at random: Kineto drops an event whose timestamp, mapped
# from the card's clock to the host's, falls outside the profiler's window
# (``Out-of-range`` in its log), and the mapping is off by up to ~21 ms
# in a session; tools/profiler_event_probe.py counted 0-17 of ~14k-115k
# events lost a session on the H100 (325 and 378 in two sessions), more
# as the process ages, and 50 ms of idle at both ends of the window did
# not stop it.  A kernel the
# graph does not launch is missing from every session alike, so a run
# profiles up to PROFILE_SESSIONS sessions of the same replays and stops
# at the first whose K5 events equal the launches per replay times the
# replays; a session that sees more events than that fails the run.
PROFILED_REPLAYS = 8
PROFILE_SESSIONS = 3
# K5's kernels in the profiler's events, and their host counters
K5_EVENTS = {"flash_decode_split_kernel": "flash_decode",
             "flash_decode_combine_kernel": "flash_decode_combine"}
# Teacher-forced decode against the prefill of the same tokens for the
# SSD families: the JAX package's own bound (tests/test_models_smoke.py:
# 78-81); the recurrent step and the chunked scan sum in another order.
SSD_REL_TOL = 0.02
# Whisper's decode chain against its teacher-forced decoder
# (``encdec.decode_train``) on the same tokens and encoder states, relative
# to the largest logit: as SERVE_REL_TOL, both compute in bfloat16 with
# f32 sums, but cuBLAS picks other algorithms for the chain's (4, d)
# products than for the teacher-forced (4*T, d) ones, and the roundings
# apart grow through 24 decoder layers.
WHISPER_REL_TOL = SERVE_REL_TOL

# Phase 12: training.  (a) Every id at its reduced config in float32, the
# same parameters and batch on the card and on the CPU (a token count that
# is not a multiple of the reduced SSD chunk, so the SSD families pad);
# both sum in float32 in another order (cuBLAS against the CPU's), so the
# loss is held to 1e-5 of itself and each gradient to 1e-4 of its
# Frobenius norm, the tolerances of the JAX package's float32 parity
# tests.  Then 4 AdamW steps on one batch at lr 5e-3 in bfloat16, which
# must lower the loss (the JAX package's tests/test_models_smoke.py:39).
# (b) TinyLlama-1.1B whole through launch.train.train: global batch 8 of
# 1024 tokens from the SyntheticLM pipeline, 2 microbatches, 8 steps.
# (c) The training launcher at the reduced TinyLlama config: 4 steps with a
# checkpoint every 2, a restart to step 6, and an uninterrupted 6-step
# run; PyTorch's deterministic algorithms are on (warn only, for ops
# that have none), and the restarted run's losses at steps 5 and 6 must
# be within RESUME_REL_TOL of the uninterrupted run's (bit-identity is
# printed).
TRAIN_BATCH = dict(b=2, t=13)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_FULL = dict(steps=8, batch=8, seq_len=1024, num_microbatches=2)
TRAIN_LAUNCHER = dict(batch=2, seq_len=32, checkpoint_every=2)
# Phase 13 (b): the mesh's losses against phase 12 (b)'s.  On a (1, 1)
# mesh every placement holds the whole tensor and the DTensors run the
# un-meshed step's local operations, with one exception: on DTensors the
# loss's logsumexp is written out (max, exponentials, sum, log), which the
# card rounds otherwise than ATen's own logsumexp kernel, in the last
# place of a float32 logit's normaliser; AdamW carries that into the next
# steps' losses at about 2e-5 relative (an H100 80GB HBM3 at 700 W).  The
# card's atomics (the embedding's gradient is a scatter-add) add as
# little.
MESH_TRAIN_REL_TOL = 1e-4
# Phase 13 (c'): a sequence-split cache's decode.  The partials are f32 on
# both sides (acc sums O(1) terms in another order: 1e-3 absolute); the
# combined shards and the kernel pair on the whole cache are bf16 outputs
# of the same f32 softmax, one bf16 rounding (2**-8 of an O(1) value)
# apart.
SHARD_PARTIAL_TOL = 1e-3
SHARD_COMBINE_TOL = 2 ** -7
MESH_TRAIN_STEPS = 4
MESH_SERVE_STEPS = 8
# Phase 13 (e), (f): a meshed prefill's cache against the un-meshed one,
# relative to its largest entry: one bfloat16 step (float32 sums in
# another order may round an entry to its neighbour)
MESH_CACHE_TOL = 2 ** -7
# Phase 13 (f): Mamba2-2.7B at full width, depth cut so that the phase
# grows by seconds
MESH_MAMBA_LAYERS = 4
# Phase 15: the fused recurrent update.  Each state entry is the same
# products and sum as the plain version's, each rounded as PyTorch rounds
# it, but the plain einsum may group dt * x * B otherwise: two roundings
# of float32, relative, with as much again of the state's largest entry
# where the decayed state and the new term cancel.
SSD_UPDATE_STATE_RTOL = 1e-6
SSD_UPDATE_LAYERS = 4
SSD_UPDATE_TURNS = 3
SSD_UPDATE_ITERS = 200
# (name, B, H, P, N, G): the decode shapes of Zamba2-7B and Mamba2-2.7B
SSD_UPDATE_SHAPES = [("zamba2-7b", 64, 112, 64, 64, 2),
                     ("mamba2-2.7b", 64, 80, 64, 128, 1)]
# Phase 16: K5 at the decode cells' shapes, (B, H_q, H_kv, D, cache rows,
# the length every session holds while timed): Qwen2-7B's long and short
# cells (8192 and 512 tokens of context and 256 generated: the middle of a
# generation) and Zamba2-7B's chat cell.  The pair is timed as a CUDA
# graph of K5_CELL_CALLS calls, so no host work lies between them, in
# K5_CELL_TURNS turns.
K5_CELL_SHAPES = {"qwen2-7b.decode.long": (32, 28, 4, 128, 8448, 8320),
                  "qwen2-7b.decode.short": (32, 28, 4, 128, 768, 640),
                  "zamba2-7b.decode.chat": (64, 32, 32, 224, 768, 640)}
K5_CELL_CALLS = 20
K5_CELL_TURNS = 5
MESH_MAMBA_TRAIN = dict(batch=4, seq_len=512, num_microbatches=2)
RESUME_REL_TOL = 1e-3
# Phase 14: the longest an example may take in its own process (each takes
# seconds: reduced configs, and the kernels are built by phase 1 already).
EXAMPLE_TIMEOUT_S = 240

# Data-sheet rates of the H100 SXM used for the bound (NVIDIA's data sheet):
# device memory, dense bf16 on the tensor cores, float32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (c_in, h, w, n, kh, kw, sh, sw, t_run): the geometry cases of the CPU
# tests of the planned kernel, each run in both sweep orders.
# Kernel channels of K1's cluster cases: 1, 2, 4 and 8 channel groups.
CLUSTER_N = (8, 16, 32, 64)
# K1's column cases, launched as every cluster of 1 to 8 blocks they take:
# ResNet-8's first layer's run of 16 on 34-column rows, runs of 6 (column
# groups of 3: odd bfloat16 starts), stride 2, a 5 x 3 kernel.
COLUMN_CASES = [
    (3, 9, 34, 16, 3, 3, 1, 1, 16),
    (2, 9, 20, 24, 3, 3, 1, 1, 6),
    (2, 11, 25, 16, 3, 3, 2, 2, 4),
    (3, 12, 17, 8, 5, 3, 1, 2, 4),
]

GEOMETRY_CASES = [
    (2, 10, 12, 3, 3, 3, 1, 1, 5),     # col-delta within rows + row turns
    (1, 9, 9, 2, 3, 3, 1, 1, 7),       # one tile per row: row-delta only
    (2, 11, 13, 3, 3, 3, 2, 2, 3),     # strides 2
    (3, 12, 14, 4, 5, 3, 1, 2, 2),     # tall kernel, stride-2 columns
    (1, 8, 8, 2, 1, 1, 1, 1, 4),       # 1x1 kernel: full fetch per tile
    (2, 13, 11, 3, 3, 3, 3, 1, 9),     # s_h >= h_k: no row-to-row reuse
]


def txt_sum(values) -> str:
    """The sum of measured values, or "not measured" if one is missing."""
    return "not measured" if any(v is None for v in values) \
        else f"{sum(values):.4f}"


def load_tool(name: str):
    """``tools/<name>.py`` of this checkout as a module."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def counts_of(names) -> dict:
    """The host counters (``obs.counters.COUNTS``) of ``names``."""
    from repro_torch.obs.counters import COUNTS
    return {name: COUNTS[name] for name in names}


def zero_counts(names) -> None:
    from repro_torch.obs.counters import COUNTS
    COUNTS.update(dict.fromkeys(names, 0))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def training_phase(card: str) -> dict:
    """Phase 12: the training path on the card (see TRAIN_* above).
    Returns its numbers for the --json file."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.model_flops import model_flops
    from repro_torch.models import registry
    from repro_torch.models.common import ShapeCell, leaves, map_defs
    from repro_torch.optim import adamw

    t12 = time.perf_counter()
    out = {"reduced": [], "card": card}

    def batch_of(cfg, seed):
        rng = np.random.default_rng(seed)
        b, t = TRAIN_BATCH["b"], TRAIN_BATCH["t"]
        if cfg.family == "audio":
            t_dec = cfg.dec_seq
            toks = rng.integers(0, cfg.vocab, size=(b, t_dec + 1))
            return {"frames": torch.from_numpy(rng.standard_normal(
                        (b, t, cfg.d_model), dtype=np.float32)),
                    "tokens": torch.from_numpy(toks[:, :-1]),
                    "labels": torch.from_numpy(toks[:, 1:].copy())}
        toks = rng.integers(0, cfg.vocab, size=(b, t + 1))
        return {"tokens": torch.from_numpy(toks[:, :-1]),
                "labels": torch.from_numpy(toks[:, 1:].copy())}

    # (a) every id, reduced, float32: the card against the CPU
    for i, arch in enumerate(registry.ARCH_IDS):
        api = registry.get_reduced(arch)
        cpu_params = map_defs(lambda t: t.float(),
                              api.init_params(SEED, device="cpu"))
        batch = batch_of(api.cfg, SEED + i)
        loss_c, grads_c = steps_mod.value_and_grad(api, cpu_params, batch)
        params = map_defs(lambda t: t.cuda(), cpu_params)
        cuda_batch = {k: v.cuda() for k, v in batch.items()}
        loss_g, grads_g = steps_mod.value_and_grad(api, params, cuda_batch)
        torch.cuda.synchronize()
        rel_loss = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        rel_grad = max((g.cpu() - c).norm().item() / max(c.norm().item(),
                                                        1e-30)
                       for g, c in zip(grads_g, grads_c, strict=True))
        finite = all(bool(torch.isfinite(g).all()) for g in grads_g)
        # 4 AdamW steps on the batch, bfloat16 parameters on the card
        step = steps_mod.make_train_step(api, adamw.AdamWConfig(lr=5e-3),
                                         num_microbatches=1)
        p_bf16 = api.init_params(SEED, device="cuda")
        opt = adamw.init(p_bf16)
        cuda_batch = {k: v.to(torch.bfloat16) if k == "frames" else v
                      for k, v in cuda_batch.items()}
        losses = []
        for _ in range(4):
            loss, _, p_bf16, opt = step(p_bf16, opt, cuda_batch)
            losses.append(loss.item())
        print(f"[12] {arch} (reduced, float32): loss on the card "
              f"{loss_g.item():.6f}, on the CPU {loss_c.item():.6f} "
              f"(rel {rel_loss:.2e}, tolerance {TRAIN_LOSS_TOL}); worst "
              f"gradient rel Frobenius {rel_grad:.2e} over "
              f"{len(grads_g)} leaves (tolerance {TRAIN_GRAD_TOL}); 4 AdamW "
              f"steps at lr 5e-3 in bfloat16: "
              f"{', '.join(f'{x:.4f}' for x in losses)}")
        if not finite or rel_loss > TRAIN_LOSS_TOL or \
                rel_grad > TRAIN_GRAD_TOL:
            fail(f"{arch}: the card's loss or gradients differ from the "
                 f"CPU's (loss {rel_loss:.2e}, gradient {rel_grad:.2e}, "
                 f"finite {finite})")
        if any(np.isnan(losses)) or not losses[-1] < losses[0]:
            fail(f"{arch}: 4 AdamW steps did not lower the loss: {losses}")
        out["reduced"].append({"arch": arch, "loss_rel": rel_loss,
                               "grad_rel": rel_grad, "adamw_losses": losses})
        del params, p_bf16, opt, grads_g
    torch.cuda.empty_cache()

    # (b) TinyLlama-1.1B whole, through the training launcher
    api = registry.get("tinyllama-1.1b")
    cfg = api.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the CLI's --full: on one card the (1, 1) mesh, whose local program
    # runs (phase 13 (b) holds dist_train_step against this run)
    try:
        run = train_mod.train("tinyllama-1.1b", smoke=False, ckpt_dir=None,
                              checkpoint_every=50, lr=3e-4, log_every=1,
                              device="cuda", **TRAIN_FULL)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    step_ms = statistics.median(run.step_ms[2:])
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq_len"]
    cell = ShapeCell("train_8x1024", TRAIN_FULL["seq_len"],
                     TRAIN_FULL["batch"], "train")
    flops = model_flops(api, cell)
    n_params = api.count_params()
    print(f"[12] {cfg.name} whole ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} bfloat16 parameters from the seeded "
          f"generator, float32 AdamW moments and gradient sums), global "
          f"batch {TRAIN_FULL['batch']} x {TRAIN_FULL['seq_len']} tokens of "
          f"the SyntheticLM pipeline, {TRAIN_FULL['num_microbatches']} "
          f"microbatches: losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"step ms {', '.join(f'{x:.1f}' for x in run.step_ms)} (median of "
          f"steps 3-{TRAIN_FULL['steps']} {step_ms:.1f}); "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; model FLOPs a step "
          f"{flops:.4e} (launch.model_flops), {flops / step_ms * 1e3:.4e} "
          f"model FLOP/s ({flops / step_ms * 1e3 / PEAK_FLOPS['bfloat16']:.3f}"
          f" of the bf16 data-sheet rate); peak {peak / 1e9:.2f} GB "
          f"allocated; {seconds:.1f} s; card: {card}")
    if any(np.isnan(losses)) or not losses[-1] < losses[0]:
        fail(f"{cfg.name}: training did not lower the loss: {losses}")
    out["tinyllama"] = {"losses": losses, "step_ms": run.step_ms,
                        "median_step_ms": step_ms,
                        "tokens_per_s": tokens / step_ms * 1e3,
                        "model_flops": flops,
                        "model_flops_per_s": flops / step_ms * 1e3,
                        "peak_gb": peak / 1e9, "seconds": seconds}
    del run
    torch.cuda.empty_cache()

    # (c) the training launcher with a restart, reduced TinyLlama
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            kw = dict(log_every=100, device="cuda", **TRAIN_LAUNCHER)
            first = train_mod.train("tinyllama-1.1b", steps=4, ckpt_dir=d,
                                    **kw)
            resumed = train_mod.train("tinyllama-1.1b", steps=6,
                                      ckpt_dir=d, **kw)
            again = train_mod.train("tinyllama-1.1b", steps=6, ckpt_dir=d,
                                    **kw)
        whole = train_mod.train("tinyllama-1.1b", steps=6, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    devices = {str(t.device) for t in leaves(resumed.params)
               + leaves(resumed.opt_state)}
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(resumed.losses, whole.losses[4:], strict=True))
    same = resumed.losses == whole.losses[4:] and all(
        torch.equal(a, b) for a, b in zip(leaves(resumed.params),
                                          leaves(whole.params)))
    print(f"[12] training launcher, reduced {cfg.name}, checkpoint every "
          f"{TRAIN_LAUNCHER['checkpoint_every']}: 4 steps {first.losses}; "
          f"the restart resumed at step {resumed.start_step} and ran "
          f"{resumed.losses} on {sorted(devices)}; a second restart ran "
          f"{len(again.losses)} steps; uninterrupted steps 5-6 "
          f"{whole.losses[4:]}: max rel {rel:.2e} (tolerance "
          f"{RESUME_REL_TOL}), losses and parameters bit-identical {same}")
    if len(first.losses) != 4 or resumed.start_step != 4 or \
            len(resumed.losses) != 2 or again.losses or \
            again.start_step != 6:
        fail(f"the restart did not resume from the last committed step "
             f"exactly once: {first.losses}, {resumed.start_step} "
             f"{resumed.losses}, {again.start_step} {again.losses}")
    if devices != {"cuda:0"}:
        fail(f"the restored state is on {devices}, not the card")
    if rel > RESUME_REL_TOL:
        fail(f"the restarted run's steps 5-6 differ from the uninterrupted "
             f"run's by {rel:.2e}")
    out["launcher"] = {"resumed_losses": resumed.losses,
                     "whole_losses": whole.losses, "max_rel": rel,
                     "bit_identical": same}
    print(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")
    return out


def mamba_on_the_mesh(mesh, axes, rel_diff) -> dict:
    """Phase 13 (f): Mamba2-2.7B at full width, ``MESH_MAMBA_LAYERS``
    layers, through ``dist_prefill_step`` and ``dist_train_step`` on
    ``mesh`` against the un-meshed steps from the same weights."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import registry
    from repro_torch.models.common import leaves
    from repro_torch.obs.counters import COUNTS
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    full = registry.get("mamba2-2.7b")
    cfg = dataclasses.replace(full.cfg, n_layers=MESH_MAMBA_LAYERS)
    api = registry.ModelApi(cfg=cfg, module=full.module)
    rng = np.random.default_rng(SEED + 131)
    b, t_p = SSD_SERVE["batch"], SSD_SERVE["prompt_len"]
    prompt = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab, size=(b, t_p))).cuda()}
    params = api.init_params(SEED, device="cuda")
    ref_logits, ref_cache = api.prefill_fn(params, prompt)
    with mesh_mod.enter_mesh(mesh):
        logits, cache = steps_mod.dist_prefill_step(api, axes)(params,
                                                                prompt)
    worst = rel_diff(logits.full_tensor(), ref_logits)
    state = max(float((cache[k].full_tensor().float() - ref_cache[k].float())
                      .abs().max() / ref_cache[k].float().abs().max())
                for k in ref_cache)
    # one decode step of the prompt's last token from both caches: the
    # shards' recurrent update is the fused kernel, once a layer
    tok = prompt["tokens"][:, -1:]
    ref_step, ref_cache = api.decode_fn(params, ref_cache, tok, t_p)
    COUNTS["ssd_update_kernel"] = 0
    with mesh_mod.enter_mesh(mesh):
        step_logits, cache = steps_mod.dist_decode_step(api, axes)(
            params, cache, tok, t_p)
    torch.cuda.synchronize()
    decoded = COUNTS["ssd_update_kernel"]
    worst_decode = rel_diff(step_logits.full_tensor(), ref_step)
    del cache, ref_cache

    toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(
        MESH_MAMBA_TRAIN["batch"], MESH_MAMBA_TRAIN["seq_len"]))).cuda()
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    opt_cfg = adamw.AdamWConfig(lr=3e-4)
    micro = MESH_MAMBA_TRAIN["num_microbatches"]
    ref_loss, ref_norm, ref_p, _ = steps_mod.make_train_step(
        api, opt_cfg, micro)(params, adamw.init(params), batch)
    torch.cuda.synchronize()
    params = api.init_params(SEED, device="cuda")
    with mesh_mod.enter_mesh(mesh):
        t1 = time.perf_counter()
        loss, norm, mesh_p, _ = steps_mod.dist_train_step(
            api, axes, micro, opt_cfg)(params, adamw.init(params), batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
    loss, norm = float(loss.full_tensor()), float(norm.full_tensor())
    rel = max(abs(loss - float(ref_loss)) / abs(float(ref_loss)),
              abs(norm - float(ref_norm)) / abs(float(ref_norm)))
    same = all(torch.equal(a, b_.full_tensor())
               for a, b_ in zip(leaves(ref_p), leaves(mesh_p)))
    print(f"[13] {cfg.name} at full width, {cfg.n_layers} of "
          f"{full.cfg.n_layers} layers (d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} SSD heads), on the mesh: dist_prefill_step of "
          f"{b} x {t_p} tokens, max |diff| / max |logit| {worst:.3e} "
          f"(tolerance {SERVE_REL_TOL}), the cache's state and conv tail "
          f"within {state:.3e} of their largest entry; one "
          f"dist_decode_step, max |diff| / max |logit| {worst_decode:.3e}, "
          f"the fused recurrent update launched {decoded} times (want "
          f"{cfg.n_layers}); dist_train_step of "
          f"{MESH_MAMBA_TRAIN['batch']} x {MESH_MAMBA_TRAIN['seq_len']} "
          f"tokens in {micro} microbatches, loss {loss:.6f} (un-meshed "
          f"{float(ref_loss):.6f}), gnorm {norm:.6f} (un-meshed "
          f"{float(ref_norm):.6f}), max rel {rel:.2e} (tolerance "
          f"{MESH_TRAIN_REL_TOL}), parameters after the step bit-identical "
          f"{same}, {step_ms:.1f} ms; {time.perf_counter() - t0:.1f} s")
    if not (worst <= SERVE_REL_TOL and state <= MESH_CACHE_TOL
            and worst_decode <= SERVE_REL_TOL and decoded == cfg.n_layers
            and rel <= MESH_TRAIN_REL_TOL
            and np.isfinite([loss, norm]).all()):
        fail(f"{cfg.name} on the mesh differs from the un-meshed steps: "
             f"logits {worst:.3e}, cache {state:.3e}, decode "
             f"{worst_decode:.3e} ({decoded} fused updates), train "
             f"{rel:.2e}")
    return {"layers": cfg.n_layers, "prefill_worst_rel": worst,
            "decode_worst_rel": worst_decode, "decode_ssd_updates": decoded,
            "cache_rel": state, "loss": [float(ref_loss), loss],
            "gnorm": [float(ref_norm), norm], "train_rel": rel,
            "params_bit_identical": same, "train_step_ms": step_ms}


def mesh_phase(card: str, training: dict, rel_diff) -> dict:
    """Phase 13: training and serving on a (1, 1) DeviceMesh, and the dry
    run of a production-mesh cell (see the module's docstring).  Returns
    its numbers for the --json file."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.models.common import Axes

    t13 = time.perf_counter()
    out = {"card": card}
    # (a) the group and the mesh
    mesh_mod.init_process_group("cuda")
    try:
        mesh = mesh_mod.make_smoke_mesh()
        axes = Axes.for_mesh(mesh)
        print(f"[13] process group: backend {dist.get_backend()}, "
              f"{dist.get_world_size()} rank; make_smoke_mesh(): {mesh}; "
              f"Axes.for_mesh: {axes} (batch {axes.batch!r})")
        if tuple(mesh.shape) != (1, 1) or axes != Axes():
            fail(f"the smoke mesh on one card is {tuple(mesh.shape)}, "
                 f"{axes}")

        # (b) TinyLlama-1.1B whole, every step dist_train_step (the
        # launcher's loop with the mesh's axes; on one device train()
        # itself runs the local program, phase 12 (b))
        torch.cuda.reset_peak_memory_stats()
        kw = dict(TRAIN_FULL, steps=MESH_TRAIN_STEPS)
        with mesh_mod.enter_mesh(mesh):
            run = train_mod._train_loop(
                registry.get("tinyllama-1.1b"), torch.device("cuda"),
                ckpt_dir=None, checkpoint_every=50, lr=3e-4, log_every=1,
                axes=axes, **kw)
        base = training["tinyllama"]
        want = base["losses"][:MESH_TRAIN_STEPS]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(run.losses, want, strict=True))
        same = run.losses == want
        placed = {str(t.placements) for t in
                  (run.params["embed"], run.opt_state["m"]["lm_head"])}
        print(f"[13] {registry.get('tinyllama-1.1b').cfg.name} whole on the "
              f"mesh, {MESH_TRAIN_STEPS} steps of dist_train_step at "
              f"{TRAIN_FULL['batch']} x {TRAIN_FULL['seq_len']} tokens, "
              f"{TRAIN_FULL['num_microbatches']} microbatches: losses "
              f"{', '.join(f'{x:.4f}' for x in run.losses)}; phase 12 (b), "
              f"un-meshed: {', '.join(f'{x:.4f}' for x in want)}; max rel "
              f"{rel:.2e} (tolerance {MESH_TRAIN_REL_TOL}), bit-identical "
              f"{same}; step ms {', '.join(f'{x:.1f}' for x in run.step_ms)}"
              f" (phase 12: "
              f"{', '.join(f'{x:.1f}' for x in base['step_ms'][:4])}); "
              f"placements {sorted(placed)}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: "
              f"{card}")
        if rel > MESH_TRAIN_REL_TOL or any(np.isnan(run.losses)):
            fail(f"the mesh's losses {run.losses} differ from phase 12's "
                 f"{want} by {rel:.2e}")
        out["train"] = {"losses": run.losses, "phase12_losses": want,
                        "max_rel": rel, "bit_identical": same,
                        "step_ms": run.step_ms,
                        "phase12_step_ms": base["step_ms"][:4]}
        del run
        torch.cuda.empty_cache()

        # (c) TinyLlama-1.1B whole served on the mesh, teacher-forced
        api = registry.get("tinyllama-1.1b")
        cfg = api.cfg
        params = api.init_params(SEED, device="cuda")
        rng = np.random.default_rng(SEED + 13)
        t_p = SERVE["prompt_len"]
        max_len = t_p + MESH_SERVE_STEPS
        toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(
            SERVE["batch"], max_len))).cuda()
        ref_logits, ref_cache = api.prefill_fn(
            params, {"tokens": toks[:, :t_p]}, max_len=max_len)
        with mesh_mod.enter_mesh(mesh):
            logits, cache = steps_mod.dist_prefill_step(
                api, axes, max_len)(params, {"tokens": toks[:, :t_p]})
            decode = steps_mod.dist_decode_step(api, axes)
            worst = rel_diff(logits.full_tensor(), ref_logits)
            refs = []
            zero_counts(K5_NAMES)
            for pos in range(t_p, max_len):
                tok = toks[:, pos:pos + 1]
                lg, cache = decode(params, cache, tok, pos)
                ref, ref_cache = api.decode_fn(params, ref_cache, tok, pos)
                refs.append(ref)
                worst = max(worst, rel_diff(lg.full_tensor(), ref))
            torch.cuda.synchronize()
            # the un-meshed reference steps launch K5 too: count the
            # meshed steps' own launches again, alone
            zero_counts(K5_NAMES)
            for pos in range(t_p, max_len):
                decode(params, cache, toks[:, pos:pos + 1], pos)
            torch.cuda.synchronize()
            launches = counts_of(K5_NAMES)
            want_k5 = cfg.n_layers * MESH_SERVE_STEPS
            _, splits = ops._planned_split(
                cache["k"].shape[2], cfg.head_dim,
                cfg.n_heads // cfg.n_kv_heads,
                SERVE["batch"] * cfg.n_kv_heads, 2)
            want_events = {kernel: want_k5 if counter == "flash_decode"
                           or splits > 1 else 0
                           for kernel, counter in K5_EVENTS.items()}
            sessions = []
            while len(sessions) < PROFILE_SESSIONS and (
                    not sessions or sessions[-1] != want_events):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for pos in range(t_p, max_len):
                        decode(params, cache, toks[:, pos:pos + 1], pos)
                    torch.cuda.synchronize()
                events = dict.fromkeys(want_events, 0)
                for ev in prof.events():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        for name in events:
                            events[name] += name in ev.name
                sessions.append(events)
        print(f"[13] {cfg.name} served on the mesh (decode layout): "
              f"dist_prefill_step of {SERVE['batch']} x {t_p} tokens and "
              f"{MESH_SERVE_STEPS} teacher-forced dist_decode_step steps "
              f"against the un-meshed steps: worst max |diff| / max |logit|"
              f" {worst:.3e} (tolerance {SERVE_REL_TOL}); K5's wrapper "
              f"counted {launches} over the {MESH_SERVE_STEPS} steps (want "
              f"{want_k5} pairs, {splits} splits of a "
              f"{cache['k'].shape[2]}-row cache); the profiler's device "
              f"events, session by session: {sessions} (want "
              f"{want_events})")
        if worst > SERVE_REL_TOL:
            fail(f"the mesh's logits differ from the un-meshed steps' by "
                 f"{worst:.3e}")
        if launches["flash_decode"] != want_k5:
            fail(f"the mesh's decode steps launched K5 "
                 f"{launches['flash_decode']} times, want {want_k5}")
        if sessions[-1] != want_events:
            fail(f"in none of {len(sessions)} profiler sessions were K5's "
                 f"device events {want_events}: {sessions}")
        # the serve driver's loop on the mesh: the prefill through
        # dist_prefill_step, the decode graph over the local program
        short = dict(SERVE, gen_len=MESH_SERVE_STEPS)
        ref_run = serve_mod._serve_loop(api, params, **short)
        with mesh_mod.enter_mesh(mesh):
            mesh_run = serve_mod._serve_loop(api, params, axes=axes, **short)
        same_tokens = bool(np.array_equal(mesh_run.tokens, ref_run.tokens))
        print(f"[13] serve loop on the mesh (dist_prefill_step, then the "
              f"CUDA graph over the local program): {MESH_SERVE_STEPS} "
              f"tokens of {SERVE['batch']} rows equal to the un-meshed "
              f"loop's {same_tokens}; decode "
              f"{mesh_run.decode_ms_per_step:.3f} ms/step (un-meshed "
              f"{ref_run.decode_ms_per_step:.3f}), K5 "
              f"{mesh_run.launches_per_replay} per replay")
        if not same_tokens:
            fail("the serve loop on the mesh generated other tokens than "
                 "the un-meshed loop")
        out["serve"] = {"worst_rel": worst, "launches": launches,
                        "profiler_sessions": sessions,
                        "loop_tokens_equal": same_tokens,
                        "loop_decode_ms": mesh_run.decode_ms_per_step}
        out["k5_launches"] = launches["flash_decode"]
        del cache, ref_cache, refs

        # (e) a prefill of one row on the mesh: the cache's rows padded
        # on the shards (layers.pad_end; PyTorch 2.11's DTensor fails in
        # a pad), against the un-meshed prefill
        one = {"tokens": toks[:1, :t_p]}
        ref_logits, ref_cache = api.prefill_fn(params, one, max_len=max_len)
        with mesh_mod.enter_mesh(mesh):
            logits, cache = steps_mod.dist_prefill_step(api, axes, max_len)(
                params, one)
        worst1 = rel_diff(logits.full_tensor(), ref_logits)
        cache_diff = max(float((cache[k].full_tensor().float()
                                - ref_cache[k].float()).abs().max())
                         for k in ref_cache)
        cache_same = all(torch.equal(cache[k].full_tensor(), ref_cache[k])
                         for k in ref_cache)
        print(f"[13] {cfg.name} prefill of 1 x {t_p} tokens on the mesh "
              f"(cache padded to {cache['k'].shape[2]} rows on the "
              f"shards): max |diff| / max |logit| {worst1:.3e} (tolerance "
              f"{SERVE_REL_TOL}); cache max |diff| {cache_diff:.3e}, "
              f"bit-identical {cache_same}")
        if worst1 > SERVE_REL_TOL or tuple(cache["k"].shape) != \
                tuple(ref_cache["k"].shape) or cache_diff > \
                MESH_CACHE_TOL * max(float(c.float().abs().max())
                                     for c in ref_cache.values()):
            fail(f"the mesh's prefill of one row differs: logits "
                 f"{worst1:.3e}, cache {cache_diff:.3e}")
        out["prefill_batch1"] = {"worst_rel": worst1,
                                 "cache_max_diff": cache_diff,
                                 "bit_identical": cache_same}
        del params, cache, ref_cache
        torch.cuda.empty_cache()

        # (f) Mamba2-2.7B at full width, depth cut: the SSD layer split by
        # heads (z, x, dt from their own column groups of in_proj, the
        # scan on each device's heads), through dist_prefill_step and
        # dist_train_step against the un-meshed steps
        out["mamba2"] = mamba_on_the_mesh(mesh, axes, rel_diff)

        # (c') a cache whose sequence is split over devices (a mesh of
        # several cards; the (1, 1) mesh never splits it): each shard's
        # split kernel into the workspace, the shards' partials side by
        # side through the combine, at TinyLlama's serving shape, against
        # the kernel pair on the whole cache and the plain partials
        gen = torch.Generator(device="cuda").manual_seed(SEED + 130)
        b_, s_ = SERVE["batch"], 512
        q = torch.randn((b_, cfg.n_heads, cfg.head_dim), device="cuda",
                        generator=gen).to(torch.bfloat16)
        k, v = (torch.randn((b_, s_, cfg.n_kv_heads, cfg.head_dim),
                            device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        lens = torch.tensor([1, 130, 300, s_], dtype=torch.int32,
                            device="cuda")
        errs = {}
        for shards in (2, 4, 16):
            rows = s_ // shards
            parts = [ops.decode_partials(
                q, k[:, i:i + rows], v[:, i:i + rows],
                (lens - i).clamp(0, rows).to(torch.int32), rows=rows)
                for i in range(0, s_, rows)]
            bkv, splits = ops._planned_split(
                rows, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
                b_ * cfg.n_kv_heads, 2)
            k0, v0 = (ops._pad_to(t[:, :rows], 1, bkv * splits)
                      for t in (k, v))
            plain = fd.decode_partials_plain(
                q, k0, v0, lens.clamp(0, rows).to(torch.int32), bkv=bkv,
                splits=splits)
            got = ops.decode_combine(torch.cat(parts, dim=2), q.dtype)
            whole = ops.decode_attention(q, k, v, lens)
            errs[shards] = (
                float((parts[0] - plain).abs().max()),
                float((got.float() - whole.float()).abs().max()))
        torch.cuda.synchronize()
        print(f"[13] {cfg.name}'s decode attention over a cache of {s_} "
              f"rows split by sequence over 2, 4 and 16 shards (bf16, "
              f"lengths {lens.tolist()}): max |diff| of the first shard's "
              f"partials against the plain split, and of the combined "
              f"shards against the kernel pair on the whole cache: "
              f"{errs} (tolerance {SHARD_PARTIAL_TOL} and "
              f"{SHARD_COMBINE_TOL})")
        if any(a > SHARD_PARTIAL_TOL or c > SHARD_COMBINE_TOL
               for a, c in errs.values()):
            fail(f"the sharded decode's partials or combine disagree: "
                 f"{errs}")
        out["seq_split_decode"] = {str(n): e for n, e in errs.items()}
    finally:
        dist.destroy_process_group()

    # (d) the dry run of a production-mesh cell, in a process of its own
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--out", str(out_dir)],
        env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"the dry run exited {r.returncode}: {r.stdout[-1500:]} "
             f"{r.stderr[-1500:]}")
    cell = json.loads((out_dir / "tinyllama-1.1b_decode_32k_single.json")
                      .read_text())
    print(f"[13] dry run, tinyllama-1.1b decode_32k on a fake 16 x 16 mesh "
          f"(256 placeholder ranks, counts only), torch "
          f"{torch.__version__}: status {cell['status']}, "
          f"{time.perf_counter() - t0:.1f} s; memory "
          f"{json.dumps(cell['memory'])}; analyzed "
          f"{json.dumps(cell['analyzed'])}")
    if cell["status"] != "ok" or cell["analyzed"]["unknown_trip_loops"]:
        fail(f"the dry run's cell: {cell['status']}")
    out["dryrun"] = {k: cell[k] for k in ("memory", "analyzed", "lower_s")}
    print(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s")
    return out


def examples_phase(card: str) -> dict:
    """Phase 14: three of the port's examples on the card, each in a
    process of its own that must exit 0 (``EXAMPLE_TIMEOUT_S``): the
    serving demo, whose decode kernel K5 its wrapper must have counted
    and whose ids must have the shape it asked for; the training demo at
    its defaults, whose loss must fall; and the planner demo, whose H100
    bridge lines must be printed.  Returns their numbers for the --json
    file."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out: dict = {}

    def run(name: str) -> str:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"torch_{name}.py")],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"examples/torch_{name}.py exited {proc.returncode}:\n"
                 + proc.stderr[-3000:])
        out[name] = {"seconds": seconds}
        print(f"[14] examples/torch_{name}.py: exit 0 in {seconds:.1f} s; "
              f"card: {card}")
        return proc.stdout

    t14 = time.perf_counter()
    text = run("serve_decode")
    if "sampled continuation ids:" not in text \
            or "decode kernel launches " not in text:
        fail("torch_serve_decode.py printed no ids or launch counts")
    counts = json.loads(text.split("decode kernel launches ", 1)[1])
    out["serve_decode"].update(counts)
    if counts["shape"] != [4, 12]:
        fail(f"torch_serve_decode.py generated {counts['shape']}, asked "
             f"for [4, 12]")
    if counts["counted"]["flash_decode"] <= 0 or counts["replays"] <= 0 \
            or not (counts["per_replay"] or {}).get("flash_decode"):
        fail(f"torch_serve_decode.py did not go through K5: {counts}")
    print(f"[14] serve_decode: ids {counts['shape']}; K5 counted by its "
          f"wrapper {counts['counted']} (warm-up and capture), then "
          f"{counts['replays']} replays of {counts['per_replay']}")

    text = run("train_lm")
    found = [line for line in text.splitlines() if line.startswith("loss ")]
    if not found:
        fail("torch_train_lm.py printed no loss line")
    first, last = (float(found[-1].split()[i]) for i in (1, 5))
    out["train_lm"].update(first=first, last=last)
    if not last < first:
        fail(f"torch_train_lm.py: loss {first} -> {last} did not fall")
    print(f"[14] train_lm: {found[-1]}")

    text = run("optimize_offload")
    lines = text.splitlines()
    heading = "== H100 planner: same formalism choosing CUDA kernel " \
              "schedules =="
    if heading not in lines:
        fail("torch_optimize_offload.py printed no H100 bridge")
    bridge = lines[lines.index(heading):]
    if not any(line.startswith("matmul ") for line in bridge) \
            or not any(line.startswith("decode ") for line in bridge):
        fail("torch_optimize_offload.py's bridge printed no plans")
    for line in bridge:
        print(f"[14] optimize_offload: {line}")
    out["seconds"] = time.perf_counter() - t14
    print(f"[14] phase 14 took {out['seconds']:.1f} s")
    return out


def ssd_update_phase(card: str) -> list[dict]:
    """Phase 15: the fused Mamba-2 recurrent update against its plain
    version at ``SSD_UPDATE_SHAPES``, then its times beside the plain
    version's and the byte bound.  Returns one row a shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_update as su
    from repro_torch.obs.counters import COUNTS

    def inputs(b, heads, p, n, groups):
        """One step's inputs for every layer (bf16 x, B, C and dt_raw
        from a projection's row, per-head constants as a published
        Mamba-2 draws them, a few dt_raw past softplus's threshold) and
        the stacked states (layers, B, H, P, N) float32."""
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        layers = SSD_UPDATE_LAYERS
        width = heads * p + 2 * groups * n
        xbc = torch.randn((layers, b, width), generator=gen, device="cuda"
                          ).to(torch.bfloat16)
        proj = torch.randn((layers, b, heads + 8), generator=gen,
                           device="cuda").to(torch.bfloat16)
        proj[:, 0, 4:6] = 25.0
        dt = torch.exp(torch.empty((layers, heads), device="cuda").uniform_(
            -6.9, -2.3, generator=gen))
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        a_log = torch.log(torch.empty((layers, heads), device="cuda"
                                      ).uniform_(1, 16, generator=gen))
        d_skip = 1 + 0.02 * torch.randn((layers, heads), generator=gen,
                                        device="cuda")
        h = 0.05 * torch.randn((layers, b, heads, p, n), generator=gen,
                               device="cuda")
        return [(xbc[i], proj[i, :, 4:4 + heads], dt_bias[i], a_log[i],
                 d_skip[i], h[i]) for i in range(layers)]

    def sum_error_bound(args, h_new, groups):
        """How far two float32 sums of each read-out, in any two orders,
        may lie apart: 2 (N + 1) 2^-24 times the sum of the terms'
        magnitudes (a recursive sum of N + 1 terms errs by at most N + 1
        roundings of that, each side)."""
        xbc, _, _, _, d_skip, _ = args
        b, heads, p, n = h_new.shape
        hg = heads // groups
        x = xbc[:, :heads * p].float().view(b, groups, hg, p)
        c = xbc[:, heads * p + groups * n:].float().view(b, groups, n)
        mag = torch.einsum("bgn,bghpn->bghp", c.abs(),
                           h_new.view(b, groups, hg, p, n).abs())
        mag = mag + (x * d_skip.view(groups, hg, 1)).abs()
        return 2 * (n + 1) * 2.0 ** -24 * mag.reshape(b, heads * p)

    def timed_ms(fn, layers, iters):
        for args in layers:
            fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*layers[i % len(layers)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    t15 = time.perf_counter()
    rows = []
    for name, b, heads, p, n, groups in SSD_UPDATE_SHAPES:
        layers = inputs(b, heads, p, n, groups)
        args = layers[0]
        want_y, want_h = su.ssd_update_plain(*args, groups=groups)
        ptr = args[-1].data_ptr()
        before = COUNTS["ssd_update_kernel"]
        y = su.ssd_update(*args, groups=groups)
        torch.cuda.synchronize()
        launched = COUNTS["ssd_update_kernel"] - before
        h = args[-1]
        scale = want_h.abs().max()
        state_gap = ((h - want_h).abs() - SSD_UPDATE_STATE_RTOL
                     * (want_h.abs() + scale)).max().item()
        _, e = torch.frexp(want_y.float())
        ulp = torch.ldexp(torch.ones_like(want_y, dtype=torch.float32),
                          torch.where(want_y == 0, torch.full_like(e, -125),
                                      e) - 8)
        tol = sum_error_bound(args, want_h, groups) + ulp
        y_err = (y.float() - want_y.float()).abs()
        y_gap = (y_err - tol).max().item()
        max_abs_err = max(y_err.max().item(),
                          (h - want_h).abs().max().item())
        print(f"[15] ssd_update {name} (B {b} H {heads} P {p} N {n} G "
              f"{groups}, bfloat16 inputs): state in place (same data "
              f"pointer {h.data_ptr() == ptr}), worst over its tolerance "
              f"{state_gap:.3e} (<= 0 passes), y worst over one bf16 ulp "
              f"and the N-sum's order {y_gap:.3e}, largest |diff| "
              f"{max_abs_err:.3e}; {launched} launch counted")
        if state_gap > 0 or y_gap > 0 or h.data_ptr() != ptr \
                or launched != 1:
            fail(f"ssd_update at {name}: state {state_gap:.3e}, y "
                 f"{y_gap:.3e} over their tolerances, {launched} launches")
        del want_y, want_h, y, tol, y_err, ulp, e

        def kernel(xbc, dt_raw, dt_bias, a_log, d_skip, h):
            su.ssd_update(xbc, dt_raw, dt_bias, a_log, d_skip, h,
                          groups=groups)

        def plain(xbc, dt_raw, dt_bias, a_log, d_skip, h):
            _, new = su.ssd_update_plain(xbc, dt_raw, dt_bias, a_log,
                                         d_skip, h, groups=groups)
            h.copy_(new)

        k_ms, p_ms = [], []
        for _ in range(SSD_UPDATE_TURNS):
            k_ms.append(timed_ms(kernel, layers, SSD_UPDATE_ITERS))
            p_ms.append(timed_ms(plain, layers, SSD_UPDATE_ITERS // 10))
        calls = 8 * SSD_UPDATE_LAYERS
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                kernel(*layers[i % SSD_UPDATE_LAYERS])
            torch.cuda.synchronize()
        device_us = [ev.time_range.elapsed_us() for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and "ssd_update_kernel" in ev.name]
        # the mean over the launches the trace holds (the profiler drops a
        # few events at random, see PROFILE_SESSIONS)
        device_ms = (sum(device_us) / len(device_us) / 1e3
                     if device_us else None)
        bound_ms = 2 * b * heads * p * n * 4 / HBM_BYTES_PER_S * 1e3
        row = {"shape": name, "b": b, "h": heads, "p": p, "n": n,
               "g": groups, "max_abs_err": max_abs_err,
               "ms": statistics.median(k_ms), "ms_turns": k_ms,
               "plain_ms": statistics.median(p_ms), "plain_ms_turns": p_ms,
               "device_ms": device_ms, "device_events": len(device_us),
               "bound_ms": bound_ms,
               "roofline_pct": bound_ms / statistics.median(k_ms) * 100}
        rows.append(row)
        print(f"[15] ssd_update {name}: kernel alone {row['ms']:.5f} ms "
              f"(turns {', '.join(f'{v:.5f}' for v in k_ms)}), device "
              + (f"{device_ms:.5f} ms" if device_ms is not None else
                 "not traced") + f" ({len(device_us)} of {calls} launches "
              "in the trace)"
              + f", plain version {row['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({row['roofline_pct']:.1f} % of it); "
              f"card: {card}")
        del layers, args, h
        torch.cuda.empty_cache()
    print(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s")
    return rows


def k5_cells_phase(card: str) -> list[dict]:
    """Phase 16: K5 at the decode cells' shapes (``K5_CELL_SHAPES``),
    bfloat16: the pair through ``ops.decode_attention`` against the plain
    split-then-combine at ragged lengths (the split kernel, the
    tensor-core scores and the combine counted), then the pair alone at
    the cell's timed length (a CUDA graph of ``K5_CELL_CALLS`` calls,
    CUDA events, in turns) beside its byte bound (K and V rows below the
    lengths, q and the output, once each at ``HBM_BYTES_PER_S``), with
    the plan ``(tile, stages, warps, splits)`` and the card's occupancy of
    the split kernel's instance (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    registers, spills).  Can be called alone from ``import chip_smoke``.
    Returns one row a cell."""
    import torch

    from repro_torch.core import planner
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.obs.counters import COUNTS

    t16 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for cell, (b, hq, hkv, d, s, timed) in K5_CELL_SHAPES.items():
        g = hq // hkv
        q = torch.randn((b, hq, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda"
                            ).to(torch.bfloat16) for _ in range(2))
        ragged = torch.randint(s // 2, s + 1, (b,), generator=gen,
                               device="cuda", dtype=torch.int32)
        ragged[:4] = torch.tensor([1, s, s // 2 + 1, 0])
        p = planner.plan_decode_split(s, d, g, b * hkv, 2)
        t = p.tiles
        before = dict(COUNTS)
        got = ops.decode_attention(q, k, v, ragged)
        torch.cuda.synchronize()
        counted = {name: COUNTS[name] - before[name] for name in
                   ("flash_decode", "flash_decode_mma",
                    "flash_decode_combine")}
        want_counts = {"flash_decode": 1, "flash_decode_mma": int(g >= 2),
                       "flash_decode_combine": int(t["splits"] > 1)}
        want = fd.decode_attention_plain(q, k, v, ragged, bkv=t["bkv"],
                                         splits=t["splits"])
        rtol, atol = TOL["bfloat16"]
        err = (got.float() - want.float()).abs()
        gap = (err - atol - rtol * want.float().abs()).max().item()
        if gap > 0 or counted != want_counts:
            fail(f"K5 at {cell}: worst over the tolerance {gap:.3e}, "
                 f"launches {counted} (want {want_counts})")
        del got, want, err
        occ = fd.occupancy(torch.bfloat16, torch.bfloat16, g, d)
        lens = torch.full((b,), timed, dtype=torch.int32, device="cuda")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            ops.decode_attention(q, k, v, lens)       # warm the plan cache
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(K5_CELL_CALLS):
                ops.decode_attention(q, k, v, lens)
        graph.replay()
        torch.cuda.synchronize()
        turns = []
        for _ in range(K5_CELL_TURNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            turns.append(start.elapsed_time(end) / K5_CELL_CALLS)
        moved = (2 * b * hq * d + 2 * b * timed * hkv * d) * 2
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        ms = statistics.median(turns)
        row = {"cell": cell, "b": b, "h_q": hq, "h_kv": hkv, "d": d,
               "rows": s, "timed_length": timed, "plan": dict(t),
               "blocks_per_sm": occ["blocks"],
               "warps_per_sm": occ["blocks"] * t["warps"],
               "regs": occ["regs"], "local_bytes": occ["local_bytes"],
               "smem_bytes": p.smem_bytes,
               "in_flight_kb_per_sm": occ["blocks"] * t["warps"]
               * (t["stages"] - 1) * t["tile"] * 2 * d * 2 / 1024,
               "max_err_over_tol": gap, "launches": counted,
               "ms": ms, "ms_turns": turns, "bound_ms": bound_ms,
               "roofline_pct": bound_ms / ms * 100}
        rows.append(row)
        print(f"[16] K5 {cell} (B {b}, H_q {hq}, H_kv {hkv}, D {d}, "
              f"{s} rows, bf16): plan tile {t['tile']} stages "
              f"{t['stages']} warps {t['warps']} splits {t['splits']}; "
              f"{occ['blocks']} blocks = {row['warps_per_sm']} warps "
              f"resident an SM ({occ['regs']} registers, "
              f"{occ['local_bytes']} B spilled, {p.smem_bytes} B of shared "
              f"memory a block, {row['in_flight_kb_per_sm']:.0f} KB in "
              f"flight an SM); against the plain version {gap:.3e} over "
              f"the tolerance (<= 0 passes), launches {counted}; the pair "
              f"at length {timed}: {ms:.5f} ms a call (turns "
              + ", ".join(f"{x:.5f}" for x in turns)
              + f"), bound {bound_ms:.5f} ms (bytes), "
              f"{row['roofline_pct']:.1f} % of it; card: {card}")
        del graph, q, k, v
        torch.cuda.empty_cache()
    print(f"[16] phase 16 took {time.perf_counter() - t16:.1f} s")
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--json", type=pathlib.Path, default=None, metavar="PATH",
        help="also write every layer's times, per dtype, to this file")
    json_path = parser.parse_args().json

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False); this "
             "script runs on the card only")

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.networks import NETWORKS
    from repro_torch.core import planner
    from repro_torch.core.conv_spec import ConvSpec
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import block_matmul as bmm
    from repro_torch.kernels import conv2d_offload as conv
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import moe, registry
    from repro_torch.models.common import leaves
    from repro_torch.kernels.emit import (emit_layer_kernel,
                                          kernel_vmem_elements,
                                          plan_emitable_network)
    from repro_torch.obs.counters import COUNTS
    from repro_torch.reference_io import layer_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full f32
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED)

    def make_layer(c_in, h, w, n, kh, kw, dtype):
        x = rng.standard_normal((c_in, h, w)).astype(np.float32)
        k = rng.standard_normal((n, c_in, kh, kw)).astype(np.float32)
        return layer_from_numpy(x, k, dtype=dtype)

    def max_err_within(got, want, dtype_name, what):
        """Largest |got - want|; fails the run when outside tolerance."""
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{what}: got {tuple(got.shape)} {got.dtype}, want "
                 f"{tuple(want.shape)} {want.dtype}")
        g, w_ = got.float(), want.float()
        if not bool(torch.isfinite(g).all()):
            fail(f"{what}: output is not finite")
        rtol, atol = TOL[dtype_name]
        err = (g - w_).abs()
        if bool((err > atol + rtol * w_.abs()).any()):
            fail(f"{what}: max abs err {err.max().item():.3e} outside "
                 f"rtol={rtol} atol={atol}")
        return err.max().item()

    # ------------------------------------------------------------------ #
    # Phase 1: card and set-up
    # ------------------------------------------------------------------ #
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all(SOURCES, verbose=True)
    build_s = time.perf_counter() - t0
    print(f"[1] built {len(logs)} CUDA sources in {build_s:.1f} s "
          f"into {_build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "entry function")):
                print(f"[1]   {name}: {line.strip()}")

    # L2's ceiling for the GeMM's boxes (tools/l2_probe.py), the three
    # cases in the ring shape and barriers K3 uses, beside the model's
    probe = load_tool("l2_probe")
    l2 = probe.measure(iters=3000, reps=3, buffers=("l2",), rings=((3, 4),),
                       sems=(1,))
    print("[1] L2 probe (tools/l2_probe.py, 16 MB in L2, 3 boxes of 16 KB a "
          "slot, 4 slots, CTA-scoped barriers): "
          + probe.summary(l2).replace("\n  ", "; "))
    # the crossover's two rates at one clock (tools/l2_probe.py --rates):
    # (a) K3's chain alone, (b) landing alone, (c) both in one block, each
    # with the SM clock read in the kernel and nvidia-smi's samples
    rates = probe.measure_rates(seconds=1.0, turns=1, quick=True,
                                warmup_max_s=3.0)
    for line in probe.rates_lines(rates):
        print(f"[1] rate probe (tools/l2_probe.py --rates --quick): {line}")
    for r in rates["runs"]:
        if any(r.get(x) == 0 for x in ("tensor_flops", "landed_bytes_per_s")
               ) or not (0.8e9 <= r["clock_hz"] <= 2.0e9 or r["case"] != "c"):
            fail(f"rate probe ({r['case']}) {r['name']}: a rate of 0, or "
                 f"case (c)'s SM clock {r['clock_hz'] / 1e9:.3f} GHz outside "
                 f"0.8-2.0")
    print(f"[1] the planner's model: tensor_flops "
          f"{H100_SXM.tensor_flops / 1e12:.1f} TFLOP/s, l2_bw "
          f"{H100_SXM.l2_bw / 1e12:.3f} TB/s served, smem_fill_bw "
          f"{H100_SXM.smem_fill_bw / 1e12:.3f} TB/s landed (case (c), "
          f"K3's ring); a step's fixed work {H100_SXM.step_cycles:.0f} SM "
          f"cycles at {H100_SXM.step_clock_hz / 1e9:.3f} GHz; "
          f"crossovers {H100_SXM.tensor_flops / H100_SXM.smem_fill_bw:.1f} "
          f"FLOP a landed byte, "
          f"{H100_SXM.tensor_flops / H100_SXM.l2_bw:.1f} a served one; "
          f"peak_flops {H100_SXM.peak_flops / 1e12:.0f} TFLOP/s (data "
          f"sheet), clusters of 4 on {H100_SXM.sms_in_clusters_of_4} SMs, "
          f"push_bw {H100_SXM.push_bw / 1e9:.1f} GB/s an SM")

    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    specs = list(NETWORKS["resnet8"])
    plan = plan_emitable_network(specs, hw, name="resnet8")
    emitted = [emit_layer_kernel(lp) for lp in plan.layers]
    c_elems = _build.bind("conv2d_offload_planned",
                          "conv2d_offload_planned_smem_elements",
                          [ctypes.c_int] * 10, ctypes.c_longlong)
    c_shape = _build.bind("conv2d_offload_planned",
                          "conv2d_offload_planned_cluster_shape",
                          [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_int)])
    c_k1_clusters = _build.bind("conv2d_offload_planned",
                                "conv2d_offload_planned_max_active_clusters",
                                [ctypes.c_int] * 5, ctypes.c_int)
    c_simple = _build.bind("conv2d_offload", "conv2d_offload_smem_bytes",
                           [ctypes.c_int] * 7, ctypes.c_longlong)
    c_groups = _build.bind("conv2d_offload", "conv2d_offload_k_groups",
                           [ctypes.c_int] * 3, ctypes.c_int)
    cs_n_c, cs_t_c = ctypes.c_int(), ctypes.c_int()
    for n_, t_ in itertools.product(range(1, 257), range(1, 65)):
        c_shape(n_, t_, ctypes.byref(cs_n_c), ctypes.byref(cs_t_c))
        if (cs_n_c.value, cs_t_c.value) != \
                planner.conv_cluster_shape(n_, t_):
            fail(f"K1's cluster for N={n_}, t_run={t_}: the CUDA source "
                 f"says {cs_n_c.value} x {cs_t_c.value}, core.planner "
                 f"{planner.conv_cluster_shape(n_, t_)}")
    for em in emitted:
        s = em.spec
        for eb in (4, 2):
            t_ops = planner.plan_conv(s, dtype_bytes=eb).tiles["t"]
            k_total = s.c_in * s.h_k * s.w_k
            if c_simple(s.c_in, s.h_k, s.w_k, s.s_w, t_ops, s.c_out, eb) != \
                    planner.conv_simple_smem_bytes(s, t_ops, eb) or \
                    c_groups(t_ops, s.c_out, k_total) != \
                    planner.conv_simple_k_groups(t_ops, s.c_out, k_total):
                fail(f"layer {em.layer_index}: the simple kernel's shared "
                     f"memory or reduction groups in the CUDA source and in "
                     f"core.planner differ")
            print(f"[1] L{em.layer_index} K2 ({eb} B): t_run={t_ops}, "
                  f"reduction split over "
                  f"{planner.conv_simple_k_groups(t_ops, s.c_out, k_total)} "
                  f"groups, shared memory "
                  f"{planner.conv_simple_smem_bytes(s, t_ops, eb)} B")
        cs_n, cs_t = planner.conv_cluster_shape(s.c_out, em.t_run)
        cs = cs_n * cs_t
        in_c = c_elems(s.c_in, s.c_out, s.h_k, s.w_k, s.s_h, s.s_w, em.t_run,
                       int(s.h_k > s.s_h), cs_n, cs_t)
        if in_c != em.vmem_elements or \
                em.vmem_elements != kernel_vmem_elements(s, em.t_run):
            fail(f"layer {em.layer_index}: the CUDA source allocates "
                 f"{in_c} elements per block, the planner budgets "
                 f"{em.vmem_elements}")
        fit = {eb: c_k1_clusters(int(eb == 2), s.h_k, s.w_k, cs,
                                 em.vmem_elements * eb) for eb in (4, 2)}
        if min(fit.values()) <= 0:
            fail(f"layer {em.layer_index}: K1's clusters of {cs} blocks do "
                 f"not fit on the card (cudaOccupancyMaxActiveClusters: "
                 f"{fit})")
        print(f"[1] L{em.layer_index}: {s.c_in}x{s.h_in}x{s.w_in}->"
              f"{s.c_out}  t_run={em.t_run} order={em.order} "
              f"grid={em.grid_meta.grid}; K1 cluster of {cs_n} x {cs_t} "
              f"blocks, {s.c_out // cs_n} channels and {em.t_run // cs_t} "
              f"columns each, ring of {planner.CONV_RING_DEPTH} slots; "
              f"shared memory per block "
              f"{em.vmem_elements * 4} B (f32) / {em.vmem_elements * 2} B "
              f"(bf16) of {H100_SXM.smem_bytes_per_block}; clusters that "
              f"fit at once {fit[4]} (f32) / {fit[2]} (bf16)")
    c_mm = _build.bind("block_matmul", "block_matmul_smem_bytes",
                       [ctypes.c_int] * 5, ctypes.c_longlong)
    c_core = _build.bind("block_matmul", "block_matmul_core",
                         [ctypes.c_int] * 4, ctypes.c_int)
    core_names = {0: "fma", 1: "mma.sync", 2: "wgmma"}
    for bm_, bn_, bk_, eb in itertools.product(
            range(16, 129, 16), (16, 48, 128), (16, 512), (4, 2)):
        if core_names[c_core(bm_, bn_, bk_, int(eb == 2))] != \
                planner.matmul_core(bm_, bn_, bk_, eb):
            fail(f"block GeMM tiles ({bm_},{bn_},{bk_}) {eb} B: the CUDA "
                 f"source and core.planner pick different cores")
    print("[1] block GeMM cores: wgmma for bf16 tiles of 64 and 128 rows, "
          "mma.sync for the other bf16 tiles, fma for f32 (the CUDA "
          "source's rule equals core.planner.matmul_core)")
    c_fd = _build.bind("flash_decode", "flash_decode_smem_bytes",
                       [ctypes.c_int] * 6, ctypes.c_longlong)
    c_clusters = _build.bind("block_matmul",
                             "block_matmul_max_active_clusters",
                             [ctypes.c_int] * 5, ctypes.c_int)
    c_k3_clusters = _build.bind("block_matmul",
                                "block_matmul_k3_max_active_clusters",
                                [ctypes.c_int] * 5, ctypes.c_int)
    for eb in (4, 2):
        for (m_, k_, n_) in [(PREFILL_M, k, n) for k, n in PREFILL_KN] + [
                (SQUARE_CHECKED,) * 3, (SQUARE_ROOFLINE,) * 3]:
            p = planner.plan_matmul(m_, n_, k_, dtype_bytes=eb)
            t = p.tiles
            rmw = p.order[2] != "k"
            if c_mm(t["bm"], t["bn"], t["bk"], eb, int(rmw)) != \
                    p.smem_bytes or p.smem_bytes != \
                    planner.matmul_smem_bytes(t["bm"], t["bn"], t["bk"], eb,
                                              rmw=rmw):
                fail(f"block GeMM tiles {t}: the CUDA source and "
                     f"core.planner budget different shared memory")
            k4_smem = planner.matmul_smem_bytes(t["bm"], t["bn"], t["bk"],
                                                eb, rmw=True)
            trips = {"m": m_ // t["bm"], "n": n_ // t["bn"],
                     "k": k_ // t["bk"]}
            fits = {}
            for order in ("mkn", "nkm"):
                if k4_smem > H100_SXM.smem_bytes_per_block:
                    break         # K4 does not take these tiles
                cs = planner.gemm_cluster_size(order, trips)
                fits[order] = (cs, c_clusters(int(eb == 2), t["bm"],
                                              t["bn"], cs, k4_smem))
                if fits[order][1] <= 0:
                    fail(f"K4 clusters of {cs} blocks with {k4_smem} B "
                         f"of shared memory each do not fit on the card "
                         f"(cudaOccupancyMaxActiveClusters: "
                         f"{fits[order][1]})")
            k3_fit = {}
            if planner.matmul_core(t["bm"], t["bn"], t["bk"], eb) == "wgmma":
                k3_smem = planner.matmul_smem_bytes(t["bm"], t["bn"],
                                                    t["bk"], eb)
                for cl in planner.k3_clusters(t["bm"], t["bn"], t["bk"],
                                              trips["m"], trips["n"], eb):
                    k3_fit[cl] = c_k3_clusters(t["bm"], t["bn"], *cl, k3_smem)
                    if k3_fit[cl] <= 0:
                        fail(f"K3 clusters of {cl[0]}x{cl[1]} at tiles {t} "
                             f"do not fit on the card "
                             f"(cudaOccupancyMaxActiveClusters: "
                             f"{k3_fit[cl]})")
            terms = planner.gemm_terms(trips, t["bm"], t["bn"], t["bk"],
                                       p.order, p.cluster, eb)
            print(f"[1] plan_matmul {m_}x{k_}x{n_} ({eb} B): tiles "
                  f"{t} order {p.order} K3 cluster {p.cluster}, core "
                  f"{planner.matmul_core(t['bm'], t['bn'], t['bk'], eb)}, "
                  f"shared memory {p.smem_bytes} B (K4 at these tiles "
                  f"{k4_smem} B); terms ms "
                  + ", ".join(f"{x} {terms[x] * 1e3:.4f}" for x in
                              ("operations", "tensor", "step", "l2", "dram",
                               "push"))
                  + "; K4 clusters that fit at once: "
                  + (", ".join(f"{o} cs={cs}: {n}"
                               for o, (cs, n) in fits.items()) or "none")
                  + "; K3 clusters (cm x cn) that fit at once: "
                  + (", ".join(f"{cl[0]}x{cl[1]}: {n}"
                               for cl, n in k3_fit.items()) or "none"))
        b_, hq, hkv, d_ = LLAMA_DECODE
        for s_ in LLAMA_S:
            p = planner.plan_decode_split(s_, d_, hq // hkv, b_ * hkv, eb)
            t = p.tiles
            ring = (t["tile"], t["stages"], t["warps"])
            if c_fd(hq // hkv, d_, *ring, eb) != p.smem_bytes or \
                    p.smem_bytes != planner.decode_smem_bytes(
                        hq // hkv, d_, *ring, eb):
                fail(f"decode ring {ring}: the CUDA source and core.planner "
                     f"budget different shared memory")
            print(f"[1] plan_decode_split S={s_} G={hq // hkv} D={d_} "
                  f"B*H_kv={b_ * hkv} ({eb} B): splits={t['splits']}, "
                  f"bkv={t['bkv']}, ring (tile, stages, warps) {ring}, "
                  f"{b_ * hkv * t['splits']} blocks, shared memory "
                  f"{p.smem_bytes} B")
    for args in itertools.product((1, 8, 32), (32, 64, 128), (16, 48, 512),
                                  (2, 4)):
        if any(c_mm(args[1], args[2], args[0] * 16, args[3], rmw) !=
               planner.matmul_smem_bytes(args[1], args[2], args[0] * 16,
                                         args[3], rmw=bool(rmw))
               for rmw in (0, 1)):
            fail(f"shared-memory formulas differ at {args}")
    for args in itertools.product((1, 3, 8, 32), (32, 80, 128, 224),
                                  planner.DECODE_TILES,
                                  planner.DECODE_STAGES, (4, 8), (2, 4)):
        if c_fd(*args) != planner.decode_smem_bytes(*args):
            fail(f"decode shared-memory formulas differ at {args}")

    # ------------------------------------------------------------------ #
    # Phase 2: kernels against their plain versions, on the card
    # ------------------------------------------------------------------ #
    worst = {name: 0.0 for name in KERNEL_NAMES + GEMM_NAMES
             + ("flash_decode",)}
    def decode_inputs(b_, hq, hkv, d_, s_, dtype, lengths, gen=None):
        gen = gen or rng
        q = torch.tensor(gen.standard_normal((b_, hq, d_)), dtype=dtype,
                         device="cuda")
        k = torch.tensor(gen.standard_normal((b_, s_, hkv, d_)), dtype=dtype,
                         device="cuda")
        v = torch.tensor(gen.standard_normal((b_, s_, hkv, d_)), dtype=dtype,
                         device="cuda")
        return q, k, v, torch.tensor(lengths, dtype=torch.int32,
                                     device="cuda")

    def check_decode(phase, label, q, k, v, lengths, bkv, dtype_name,
                     splits=1):
        """The kernel pair against the plain split-then-combine on the same
        ranges; with splits > 1 also the combine alone on the plain
        partials against the plain combine."""
        got = fd.decode_attention(q, k, v, lengths, bkv=bkv, splits=splits)
        want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                         splits=splits)
        err = max_err_within(got, want, dtype_name, f"flash_decode {label}")
        worst["flash_decode"] = max(worst["flash_decode"], err)
        comb = ""
        if splits > 1:
            part = fd.decode_partials_plain(q, k, v, lengths, bkv=bkv,
                                            splits=splits)
            c_err = max_err_within(fd.decode_combine(part, q.dtype),
                                   fd.decode_combine_plain(part, q.dtype),
                                   dtype_name, f"flash_decode_combine {label}")
            worst["flash_decode"] = max(worst["flash_decode"], c_err)
            comb = f"; combine alone {c_err:.3e}"
        rtol, atol = TOL[dtype_name]
        print(f"[{phase}] flash_decode {label} bkv={bkv} splits={splits} "
              f"{dtype_name}: lengths {lengths.tolist()}, max abs err "
              f"{err:.3e}{comb} (rtol {rtol}, atol {atol})")


    def compare(label, x, k, t_run, s_h, s_w, order, dtype_name):
        kw = dict(t_run=t_run, s_h=s_h, s_w=s_w, order=order)
        pairs = (
            ("conv2d_offload_planned", conv.conv2d_offload_planned,
             conv.conv2d_offload_planned_plain),
            ("conv2d_offload", conv.conv2d_offload,
             conv.conv2d_offload_plain))
        errs = []
        for name, kernel, plain in pairs:
            err = max_err_within(kernel(x, k, **kw), plain(x, k, **kw),
                                 dtype_name, f"{name} {label}")
            worst[name] = max(worst[name], err)
            errs.append(err)
        rtol, atol = TOL[dtype_name]
        print(f"[2] {label} {order} {dtype_name}: max abs err planned "
              f"{errs[0]:.3e} simple {errs[1]:.3e} "
              f"(rtol {rtol}, atol {atol})")

    for dtype_name, dtype in dtypes.items():
        for em in emitted:
            s = em.spec
            x, k = make_layer(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k, s.w_k,
                              dtype)
            compare(f"resnet8 L{em.layer_index} t_run={em.t_run}", x, k,
                    em.t_run, s.s_h, s.s_w, em.order, dtype_name)
            # the simple kernel also at the run length ops.conv2d picks
            t_ops = planner.plan_conv(
                s, dtype_bytes=x.element_size()).tiles["t"]
            if s.w_out % t_ops == 0 and t_ops != em.t_run:
                compare(f"resnet8 L{em.layer_index} t_run={t_ops}", x, k,
                        t_ops, s.s_h, s.s_w, "zigzag", dtype_name)
        for (c_in, h, w, n, kh, kw_, sh, sw, t_run) in GEOMETRY_CASES:
            for order in ("zigzag", "row"):
                x, k = make_layer(c_in, h, w, n, kh, kw_, dtype)
                compare(f"case {c_in}x{h}x{w}->{n} k{kh}x{kw_} "
                        f"s{sh}x{sw} t_run={t_run}", x, k, t_run, sh, sw,
                        order, dtype_name)
        # K1 over clusters of 1, 2, 4 and 8 blocks: the geometry cases with
        # N = 8, 16, 32, 64; each launch's blocks must count the boxes the
        # plain version slices, plus Λ, as fetched
        counter = conv.fetched_counter(torch.device("cuda"))
        for n_ in CLUSTER_N:
            errs = []
            for (c_in, h, w, _, kh, kw_, sh, sw, t_run) in GEOMETRY_CASES:
                for order in ("zigzag", "row"):
                    x, k = make_layer(c_in, h, w, n_, kh, kw_, dtype)
                    geo = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
                    before = int(counter.item())
                    got = conv.conv2d_offload_planned(x, k, **geo)
                    want, fetches = conv.conv2d_offload_planned_plain(
                        x, k, return_fetches=True, **geo)
                    label = (f"conv2d_offload_planned N={n_} case "
                             f"{c_in}x{h}x{w} k{kh}x{kw_} s{sh}x{sw} "
                             f"t_run={t_run} {order} {dtype_name}")
                    errs.append(max_err_within(got, want, dtype_name, label))
                    boxes = sum((h1 - h0) * (w1 - w0)
                                for _, h0, h1, w0, w1 in fetches)
                    if int(counter.item()) - before != \
                            boxes * c_in + k.numel():
                        fail(f"{label}: the blocks fetched "
                             f"{int(counter.item()) - before} elements, the "
                             f"boxes and Λ hold {boxes * c_in + k.numel()}")
            worst["conv2d_offload_planned"] = max(
                worst["conv2d_offload_planned"], *errs)
            print(f"[2] conv2d_offload_planned N={n_} ({len(errs)} geometry "
                  f"cases x orders, the rule's clusters) {dtype_name}: max "
                  f"abs err {max(errs):.3e}, fetches counted on the card "
                  f"equal to the boxes plus Λ")
        # K1 launched as every cluster of 1 to 8 blocks the column cases
        # take, against the plain version split the same way
        spare = torch.zeros(1, dtype=torch.int64, device="cuda")
        for (c_in, h, w, n_, kh, kw_, sh, sw, t_run) in COLUMN_CASES:
            errs, shapes = [], []
            for order in ("zigzag", "row"):
                x, k = make_layer(c_in, h, w, n_, kh, kw_, dtype)
                geo = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
                for cluster in itertools.product((1, 2, 4, 8), repeat=2):
                    if cluster[0] * cluster[1] > 8 or n_ % cluster[0] \
                            or t_run % cluster[1]:
                        continue
                    spare.zero_()
                    got = conv.planned_launch(
                        x, k, cluster=cluster, counter=spare, **geo
                    ).run(x, k, conv._lambda_matrix)
                    want, fetches = conv.conv2d_offload_planned_plain(
                        x, k, return_fetches=True, cluster=cluster, **geo)
                    label = (f"conv2d_offload_planned {cluster[0]}x"
                             f"{cluster[1]} case {c_in}x{h}x{w}->{n_} "
                             f"k{kh}x{kw_} s{sh}x{sw} t_run={t_run} {order} "
                             f"{dtype_name}")
                    errs.append(max_err_within(got, want, dtype_name, label))
                    boxes = sum((h1 - h0) * (w1 - w0)
                                for _, h0, h1, w0, w1 in fetches)
                    if int(spare.item()) != boxes * c_in + k.numel():
                        fail(f"{label}: the blocks fetched "
                             f"{int(spare.item())} elements, the boxes and "
                             f"Λ hold {boxes * c_in + k.numel()}")
                    shapes.append(f"{cluster[0]}x{cluster[1]}")
            worst["conv2d_offload_planned"] = max(
                worst["conv2d_offload_planned"], *errs)
            print(f"[2] conv2d_offload_planned case {c_in}x{h}x{w}->{n_} "
                  f"k{kh}x{kw_} s{sh}x{sw} t_run={t_run} {dtype_name}, both "
                  f"orders, clusters {' '.join(sorted(set(shapes)))}: max "
                  f"abs err {max(errs):.3e}, fetches equal to the boxes "
                  f"plus Λ")
    # K5 split over blocks at TinyLlama's heads: lengths 0, 1, on a range
    # boundary, one row past one, past the middle range, and S
    for dtype_name, dtype in dtypes.items():
        _, hq, hkv, d_ = LLAMA_DECODE
        for s_, cases in SPLIT_CASES.items():
            for splits, bkv in cases:
                rng_len = s_ // splits
                lengths = [0, 1, rng_len, rng_len + 1,
                           (splits // 2) * rng_len + 3, s_]
                q, k, v, lens = decode_inputs(len(lengths), hq, hkv, d_, s_,
                                              dtype, lengths)
                check_decode(2, f"S{s_}", q, k, v, lens, bkv, dtype_name,
                             splits)
    print("[2] launches so far: "
          + json.dumps(counts_of(KERNEL_NAMES + K5_NAMES)))

    # ------------------------------------------------------------------ #
    # Phase 3: the main path at full width
    # ------------------------------------------------------------------ #
    zero_counts(KERNEL_NAMES)
    counter = conv.fetched_counter(torch.device("cuda"))
    counter.zero_()
    plan = plan_emitable_network(specs, hw, name="resnet8")
    emitted = [emit_layer_kernel(lp) for lp in plan.layers]
    if len(emitted) != 7:
        fail(f"ResNet-8 has 7 conv layers, the plan has {len(emitted)}")
    calls = charged = 0
    for dtype_name, dtype in dtypes.items():
        for lp, em in zip(plan.layers, emitted):
            s = em.spec
            charged += INPUTS_PER_LAYER * (
                lp.strategy.pixels_loaded() * s.c_in + s.kernel_elements)
            errs_k1, errs_k2 = [], []
            for _ in range(INPUTS_PER_LAYER):
                x, k = make_layer(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k,
                                  s.w_k, dtype)
                want = ref.conv2d(x, k, s.s_h, s.s_w)
                if tuple(want.shape) != (s.c_out, s.h_out, s.w_out):
                    fail(f"oracle shape {tuple(want.shape)}")
                errs_k1.append(max_err_within(
                    em.run(x, k), want, dtype_name,
                    f"EmittedConv.run L{em.layer_index} {dtype_name}"))
                errs_k2.append(max_err_within(
                    ops.conv2d(x, k, s_h=s.s_h, s_w=s.s_w), want,
                    dtype_name, f"ops.conv2d L{em.layer_index} {dtype_name}"))
                calls += 1
            print(f"[3] L{em.layer_index} {dtype_name}: "
                  f"{INPUTS_PER_LAYER} inputs, max abs err vs ref.conv2d: "
                  f"EmittedConv.run {max(errs_k1):.3e}, ops.conv2d "
                  f"{max(errs_k2):.3e}")
    main_launches = counts_of(KERNEL_NAMES)
    main_fetched = int(counter.item())
    print(f"[3] main path: {calls} calls of each entry point, launches "
          + json.dumps(main_launches) + f"; K1's blocks fetched "
          f"{main_fetched} elements from device memory, the plans charge "
          f"{charged} (pixels_loaded * C_in + the kernel set, per call)")
    if main_fetched != charged:
        fail(f"K1 fetched {main_fetched} elements over the main path, the "
             f"plans charge {charged}")
    for name in KERNEL_NAMES:
        if main_launches[name] != calls:
            fail(f"the main path made {calls} calls but kernel {name} was "
                 f"launched {main_launches[name]} times")

    # ------------------------------------------------------------------ #
    # Phase 4: times
    # ------------------------------------------------------------------ #
    def time_ms(fn, *, warmup=3, batches=5, per_batch=20):
        """Median over batches of (CUDA-event time of a batch of calls) /
        (calls in the batch)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_batch):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / per_batch)
        return statistics.median(times)

    def device_ms(fns, names, calls=10):
        """Device time per call of each CUDA kernel in ``names``, from
        ``torch.profiler`` over ``calls`` calls of every function in
        ``fns``.  None for a kernel the trace shows no device time for
        (the profiler cannot trace the card everywhere)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        found = {name: None for name in names}
        for ev in prof.key_averages():
            total_us = getattr(ev, "device_time_total", None)
            if total_us is None:                 # older name of the field
                total_us = getattr(ev, "cuda_time_total", 0.0)
            for name in names:   # the GeMMs' wgmma core: *_wgmma_kernel
                if total_us > 0 and (f"{name}_kernel" in ev.key
                                     or f"{name}_wgmma_kernel" in ev.key):
                    found[name] = (found[name] or 0.0) + total_us / 1e3 / calls
        return found

    def bound(s, dtype_name, elem_bytes):
        """(ms, which): the larger of bytes over the memory rate (input,
        kernels and output once each) and 2*MACs over the peak rate."""
        moved = (s.c_in * s.h_in * s.w_in + s.kernel_elements
                 + s.c_out * s.num_patches) * elem_bytes
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * s.macs_total / PEAK_FLOPS[dtype_name] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")

    print("[4] times in ms: 'call' is the wrapper per call (median of 5 "
          "batches of 20 calls, CUDA events), 'kernel alone' the CUDA "
          f"kernel's device time per call (torch.profiler); card: {card}")
    print("[4] at these sizes bytes and operations both take far less than "
          "one launch's latency: the bound is not what limits either kernel")
    # Pass A times every layer with CUDA events; pass B, after phase 7's
    # event timings, takes the kernels' device times with the profiler.
    layer_rows = {name: [] for name in KERNEL_NAMES}
    profiled, one_block = [], []
    spare_count = torch.zeros(1, dtype=torch.int64, device="cuda")

    def k1_one_block(em, x, k):
        """K1 launched through the wrapper's launch path as a cluster of
        ONE block (the whole Λ and every column in it), for the time
        without the cluster."""
        s = em.spec
        return conv.planned_launch(
            x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w, order=em.order,
            cluster=(1, 1), counter=spare_count
        ).run(x, k, conv._lambda_matrix)

    for dtype_name, dtype in dtypes.items():
        for em in emitted:
            s = em.spec
            x, k = make_layer(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k, s.w_k,
                              dtype)
            t_ops = planner.plan_conv(
                s, dtype_bytes=x.element_size()).tiles["t"]
            x_pad = F.pad(x, (0, ((-s.w_out) % t_ops) * s.s_w))
            b_ms, b_by = bound(s, dtype_name, x.element_size())

            def run_k1(em=em, x=x, k=k):
                return em.run(x, k)

            def run_k2(s=s, x=x, k=k):
                return ops.conv2d(x, k, s_h=s.s_h, s_w=s.s_w)

            def plain_k1(em=em, s=s, x=x, k=k):
                return conv.conv2d_offload_planned_plain(
                    x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w,
                    order=em.order)

            def plain_k2(s=s, x_pad=x_pad, k=k, t_ops=t_ops):
                return conv.conv2d_offload_plain(
                    x_pad, k, t_run=t_ops, s_h=s.s_h, s_w=s.s_w)

            def run_k1_one_block(em=em, x=x, k=k):
                return k1_one_block(em, x, k)

            # the library call in full f32 (cuDNN takes TF32 for a float32
            # convolution by default), and with TF32 beside it
            tf32 = torch.backends.cudnn.allow_tf32
            try:
                torch.backends.cudnn.allow_tf32 = False
                lib_ms = time_ms(lambda: F.conv2d(x[None], k,
                                                  stride=(s.s_h, s.s_w)))
                torch.backends.cudnn.allow_tf32 = True
                lib_tf32_ms = time_ms(lambda: F.conv2d(
                    x[None], k, stride=(s.s_h, s.s_w)))
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            max_err_within(run_k1_one_block(), run_k1(), dtype_name,
                           f"K1 as one block L{em.layer_index}")
            once = dict(warmup=1, batches=3, per_batch=1)
            timed = {
                "conv2d_offload_planned": (
                    em.t_run, time_ms(run_k1), time_ms(plain_k1, **once)),
                "conv2d_offload": (
                    t_ops, time_ms(run_k2), time_ms(plain_k2, **once)),
            }
            rows = {}
            for name, (t_run, ms, plain_ms) in timed.items():
                rows[name] = {
                    "layer": em.layer_index, "dtype": dtype_name,
                    "shape": f"{s.c_in}x{s.h_in}x{s.w_in}->{s.c_out}",
                    "t_run": t_run, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "library_tf32_ms": lib_tf32_ms,
                    "device_ms": None}
                layer_rows[name].append(rows[name])
            k1 = rows["conv2d_offload_planned"]
            cs_n, cs_t = planner.conv_cluster_shape(s.c_out, em.t_run)
            k1["cluster"] = f"{cs_n}x{cs_t}"
            k1["ring"] = planner.CONV_RING_DEPTH
            k1["steps"] = s.h_out * (s.w_out // em.t_run)
            k1["one_block_ms"] = time_ms(run_k1_one_block)
            profiled.append((rows, [run_k1, run_k2]))
            one_block.append((k1, run_k1_one_block))
    # ------------------------------------------------------------------ #
    # Phase 5: K3, K4 and K5 against their plain versions, on the card
    # ------------------------------------------------------------------ #
    def gemm_inputs(m, n, k, dtype):
        a = torch.tensor(rng.standard_normal((m, k)), dtype=dtype,
                         device="cuda")
        b = torch.tensor(rng.standard_normal((k, n)) / np.sqrt(k),
                         dtype=dtype, device="cuda")
        return a, b

    def k4_tiles(tiles, eb):
        """The tiles K4 runs where the planner's are K3's wide ones: bn
        halved until its partial stage and ring fit one block."""
        tiles = dict(tiles)
        while planner.matmul_smem_bytes(tiles["bm"], tiles["bn"],
                                        tiles["bk"], eb, rmw=True) > \
                H100_SXM.smem_bytes_per_block:
            tiles["bn"] //= 2
        return tiles

    def check_orders(label, a, b, tiles, dtype_name, clusters=()):
        """Every order whose kernel takes these tiles (all six, or K3's
        two at tiles too wide for K4's partial stage) and K3 on each of
        ``clusters`` against the plain version (the same bits in every
        order and cluster, so it runs once) and against each other, bit
        for bit; returns each run's error and how its launch was
        shaped."""
        want = bmm.block_matmul_plain(a, b, order="mnk", **tiles)
        trips = {"m": a.shape[0] // tiles["bm"],
                 "n": b.shape[1] // tiles["bn"],
                 "k": a.shape[1] // tiles["bk"]}
        errs, shapes, outs = {}, {}, {}
        eb = a.element_size()
        core = bmm.core_of(tiles["bm"], tiles["bn"], tiles["bk"], a.dtype)
        runs = [(o, (1, 1)) for o in ORDERS
                if planner.matmul_smem_bytes(
                    tiles["bm"], tiles["bn"], tiles["bk"], eb,
                    rmw=o[2] != "k") <= H100_SXM.smem_bytes_per_block]
        runs += [(o, cl) for cl in clusters if cl != (1, 1)
                 for o in ("mnk", "nmk")]
        for order, cl in runs:
            name = GEMM_NAMES[int(order[2] != "k")]
            key = order if cl == (1, 1) else f"{order} {cl[0]}x{cl[1]}"
            outs[key] = bmm.block_matmul(a, b, order=order, cluster=cl,
                                         **tiles)
            launch = bmm.LAST_LAUNCH
            shapes[key] = (f"{launch['core']} cs={launch['cluster']} "
                           f"grid={launch['grid']} cluster on the grid "
                           f"{launch['grid_cluster']}")
            if launch["name"] != name or launch["core"] != core or \
                    launch["cluster"] != planner.gemm_cluster_size(
                        order, trips, cl) or launch["k3_cluster"] != cl:
                fail(f"{name} {label} {key}: launched {launch}")
            errs[key] = max_err_within(outs[key], want, dtype_name,
                                       f"{name} {label} {key}")
            worst[name] = max(worst[name], errs[key])
        first = next(iter(outs))
        for key, got in outs.items():
            if not torch.equal(got, outs[first]):
                fail(f"block_matmul {label}: {key} differs from {first} "
                     f"(the orders and clusters must agree bit for bit)")
        return errs, shapes

    for dtype_name, dtype in dtypes.items():
        eb = torch.finfo(dtype).bits // 8
        rtol, atol = TOL[dtype_name]
        for (m_, n_, k_, bm_, bn_, bk_) in MATMUL_CASES:
            if planner.matmul_smem_bytes(bm_, bn_, bk_, eb) > \
                    conv.SMEM_LIMIT_BYTES:
                bk_ //= 2     # two f32 stages of 128x128x128 do not fit
            a, b = gemm_inputs(m_, n_, k_, dtype)
            a = ops._pad_to(ops._pad_to(a, 0, bm_), 1, bk_).contiguous()
            b = ops._pad_to(ops._pad_to(b, 0, bk_), 1, bn_).contiguous()
            tiles = dict(bm=bm_, bn=bn_, bk=bk_)
            errs, shapes = check_orders(f"{m_}x{k_}x{n_}", a, b, tiles,
                                        dtype_name)
            print(f"[5] block_matmul {m_}x{k_}x{n_} tiles {bm_},{bn_},{bk_} "
                  f"{dtype_name}: all orders bit-identical; max abs err by "
                  "order " + " ".join(f"{o} {e:.3e} ({shapes[o]})"
                                      for o, e in errs.items())
                  + f" (rtol {rtol}, atol {atol})")
        for (m_, n_, k_, bm_, bn_, bk_, cl) in K3_CLUSTER_CASES:
            if dtype != torch.bfloat16:
                continue                   # wide tiles and clusters: wgmma
            a, b = gemm_inputs(m_, n_, k_, dtype)
            tiles = dict(bm=bm_, bn=bn_, bk=bk_)
            errs, shapes = check_orders(f"{m_}x{k_}x{n_}", a, b, tiles,
                                        dtype_name, clusters=[cl])
            print(f"[5] block_matmul {m_}x{k_}x{n_} tiles {bm_},{bn_},{bk_} "
                  f"K3 cluster {cl[0]}x{cl[1]} {dtype_name}: all runs "
                  "bit-identical; max abs err " + " ".join(
                      f"{o} {e:.3e} ({shapes[o]})" for o, e in errs.items()))
        for (m_, k_, n_) in [(PREFILL_M, k, n) for k, n in PREFILL_KN] + [
                (SQUARE_CHECKED,) * 3]:
            a, b = gemm_inputs(m_, n_, k_, dtype)
            p = planner.plan_matmul(m_, n_, k_, dtype_bytes=eb)
            t = p.tiles
            clusters = planner.k3_clusters(t["bm"], t["bn"], t["bk"],
                                           m_ // t["bm"], n_ // t["bn"], eb)
            for tiles in [t] + ([k4_tiles(t, eb)] if k4_tiles(t, eb) != t
                                else []):
                errs, shapes = check_orders(
                    f"{m_}x{k_}x{n_}", a, b, tiles, dtype_name,
                    clusters=clusters if tiles == t else ())
                if dtype == torch.bfloat16 and bmm.LAST_LAUNCH["core"] != \
                        "wgmma":
                    fail(f"block_matmul {m_}x{k_}x{n_} tiles {tiles} "
                         f"bfloat16 ran on the {bmm.LAST_LAUNCH['core']} "
                         f"core, not wgmma")
                which = "planner tiles" if tiles == t else \
                    "K4 at the planner's tiles, bn halved to fit"
                print(f"[5] block_matmul {m_}x{k_}x{n_} {which} {tiles} "
                      f"(plan {p.order}, K3 cluster {p.cluster}) "
                      f"{dtype_name}: all runs bit-identical; max abs err "
                      + " ".join(f"{o} {e:.3e} ({shapes[o]})"
                                 for o, e in errs.items()))
        if dtype == torch.bfloat16:
            # the planner's roofline case: K3 on its plan against the f32
            # product of the same bf16 inputs (the plain version's Python
            # loop is too slow here); bf16 tolerance, one final rounding
            sq = SQUARE_ROOFLINE
            a, b = gemm_inputs(sq, sq, sq, dtype)
            p = planner.plan_matmul(sq, sq, sq, dtype_bytes=eb)
            got = bmm.block_matmul(a, b, order=p.order, cluster=p.cluster,
                                   **p.tiles)
            launch = dict(bmm.LAST_LAUNCH)
            err = max_err_within(got.float(), torch.matmul(a.float(),
                                                           b.float()),
                                 dtype_name, f"block_matmul {sq}^3")
            worst["block_matmul_osta"] = max(worst["block_matmul_osta"], err)
            print(f"[5] block_matmul {sq}^3 planner tiles {p.tiles} order "
                  f"{p.order} K3 cluster {p.cluster} (core "
                  f"{launch['core']}, {launch['cluster']} blocks a cluster, "
                  f"{launch['grid_cluster']} on the grid, grid "
                  f"{launch['grid']}) against torch.matmul in f32: max abs "
                  f"err {err:.3e} (rtol {rtol}, atol {atol})")
            del a, b, got
        for (b_, hq, hkv, d_, s_, bkv) in DECODE_CASES:
            lengths = [1] + [int(x) for x in rng.integers(0, s_ + 1, b_ - 1)]
            q, k, v, lens = decode_inputs(b_, hq, hkv, d_, s_, dtype, lengths)
            check_decode(5, f"B{b_} Hq{hq} Hkv{hkv} D{d_} S{s_}", q, k, v,
                         lens, bkv, dtype_name)
        for (b_, hq, hkv, d_, s_, bkv, splits) in WIDE_DECODE_CASES:
            lengths = [0, s_ // splits + 1, s_][-b_:]
            q, k, v, lens = decode_inputs(b_, hq, hkv, d_, s_, dtype, lengths)
            check_decode(5, f"B{b_} Hq{hq} Hkv{hkv} D{d_} S{s_}", q, k, v,
                         lens, bkv, dtype_name, splits)
            check_decode(5, f"B{b_} Hq{hq} Hkv{hkv} D{d_} S{s_}", q, k, v,
                         lens, bkv, dtype_name)
        b_, hq, hkv, d_ = LLAMA_DECODE
        for s_ in LLAMA_S + PADDED_S:
            lengths = [1, s_] + [int(x) for x in rng.integers(2, s_, b_ - 2)]
            q, k, v, lens = decode_inputs(b_, hq, hkv, d_, s_, dtype, lengths)
            bkv, splits = ops._planned_split(s_, d_, hq // hkv, b_ * hkv, eb)
            k_p, v_p = (ops._pad_to(t, 1, bkv * splits) for t in (k, v))
            check_decode(5, f"TinyLlama S{s_} (cache of {k_p.shape[1]})", q,
                         k_p, v_p, lens, bkv, dtype_name, splits)
            got = ops.decode_attention(q, k, v, lens)
            err = max_err_within(got, fd.decode_attention_plain(
                q, k_p, v_p, lens, bkv=bkv, splits=splits), dtype_name,
                f"ops.decode_attention S{s_}")
            print(f"[5] ops.decode_attention TinyLlama S{s_} {dtype_name}: "
                  f"planned bkv={bkv} splits={splits}, max abs err {err:.3e}")

    # K5 at the transformer family's query groups, G = 5-8 at D = 128,
    # with the planner's splits and bkv at the serving shape; inputs from
    # a generator of their own, so the phases after draw what they drew
    # before these cases came
    family_rng = np.random.default_rng(SEED + 1)
    for (hq, hkv) in FAMILY_HEADS:
        b_, s_, d_ = 4, 512, 128
        q, k, v, lens = decode_inputs(b_, hq, hkv, d_, s_, torch.bfloat16,
                                      [1, s_ // 2 + 1, 481, s_], family_rng)
        bkv, splits = ops._planned_split(s_, d_, hq // hkv, b_ * hkv, 2)
        check_decode(5, f"G{hq // hkv} (H_q {hq}, H_kv {hkv}) D{d_} S{s_}",
                     q, k, v, lens, bkv, "bfloat16", splits)

    # K5 at the serving shapes of phase 11, the planner's splits and bkv,
    # float32 and bfloat16: Zamba2's shared attention, Whisper's self- and
    # cross-attention (the cross cache as prefill stores it, 1500 valid
    # rows in the planner's 1536); a generator of their own
    serving_rng = np.random.default_rng(SEED + 2)
    for label, (b_, hq, hkv, d_, s_, valid) in SERVING_DECODE.items():
        for dtype_name, dtype in dtypes.items():
            eb = torch.finfo(dtype).bits // 8
            lengths = [1, valid // 2 + 1, valid - 1, valid]
            q, k, v, lens = decode_inputs(b_, hq, hkv, d_, s_, dtype,
                                          lengths, serving_rng)
            bkv, splits = ops._planned_split(s_, d_, hq // hkv, b_ * hkv, eb)
            check_decode(5, f"{label} (B {b_}, H_q {hq}, H_kv {hkv}, D{d_}, "
                         f"S{s_})", q, k, v, lens, bkv, dtype_name, splits)

    # K2 through ops.conv2d at the planner's run length: every ResNet-8
    # layer and the geometry cases, both orders, against the oracle and
    # (padded as ops.conv2d pads) the plain version
    for dtype_name, dtype in dtypes.items():
        errs = []
        layers = [(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k, s.w_k, s.s_h,
                   s.s_w, None) for s in specs]
        for (c_in, h, w, n_, kh, kw_, sh, sw, t_run) in layers + \
                GEOMETRY_CASES:
            x, k = make_layer(c_in, h, w, n_, kh, kw_, dtype)
            w_out = (w - kw_) // sw + 1
            t = t_run or ops._planned_t_run(
                ConvSpec(c_in, h, w, n_, kh, kw_, sh, sw), x.element_size())
            x_pad = F.pad(x, (0, ((-w_out) % t) * sw))
            for order in ("zigzag", "row"):
                got = ops.conv2d(x, k, t_run=t_run, s_h=sh, s_w=sw,
                                 order=order)
                label = (f"ops.conv2d {c_in}x{h}x{w}->{n_} k{kh}x{kw_} "
                         f"s{sh}x{sw} t_run={t} {order} {dtype_name}")
                errs.append(max_err_within(got, ref.conv2d(x, k, sh, sw),
                                           dtype_name, label))
                errs.append(max_err_within(
                    got, conv.conv2d_offload_plain(
                        x_pad, k, t_run=t, s_h=sh, s_w=sw,
                        order=order)[:, :, :w_out], dtype_name, label))
        worst["conv2d_offload"] = max(worst["conv2d_offload"], *errs)
        print(f"[5] conv2d_offload through ops.conv2d {dtype_name}: 7 "
              f"ResNet-8 layers and {len(GEOMETRY_CASES)} geometry cases x 2 "
              f"orders, max abs err vs ref.conv2d and the plain version "
              f"{max(errs):.3e}")

    for (m_, n_, k_) in PLANNED_SMALL_M:
        a, b = gemm_inputs(m_, n_, k_, torch.bfloat16)
        err = max_err_within(ops.matmul(a, b), ref.matmul(a, b), "bfloat16",
                             f"ops.matmul {m_}x{k_}x{n_}")
        print(f"[5] ops.matmul {m_}x{k_}x{n_} planned (bm, bn, bk, order) "
              f"{ops._planned_matmul(m_, n_, k_, 2)} bfloat16: max abs err "
              f"vs ref.matmul {err:.3e}")
    print("[5] worst max abs err against the plain versions: "
          + ", ".join(f"{n} {worst[n]:.3e}"
                      for n in GEMM_NAMES + ("flash_decode",))
          + f"; tolerances (rtol, atol) {TOL}")

    # the ops.matmul entry point over TinyLlama's prefill projections, with
    # the planner's tiles, order and K3 cluster, and with the order pinned
    # to mkn (K4, on the planner's tiles with bn halved where its partial
    # stage does not fit beside them; the planner picks K3 at all four)
    zero_counts(GEMM_NAMES)
    mm_calls = 0
    for dtype_name, dtype in dtypes.items():
        eb = torch.finfo(dtype).bits // 8
        for (k_, n_) in PREFILL_KN:
            a, b = gemm_inputs(PREFILL_M, n_, k_, dtype)
            want = ref.matmul(a, b)
            k4_bn = k4_tiles(planner.plan_matmul(PREFILL_M, n_, k_, eb).tiles,
                             eb)["bn"]
            for order, bn_ in ((None, None), ("mkn", k4_bn)):
                got = ops.matmul(a, b, order=order, bn=bn_)
                err = max_err_within(got, want, dtype_name,
                                     f"ops.matmul {PREFILL_M}x{k_}x{n_}")
                mm_calls += 1
                launch = bmm.LAST_LAUNCH
                if dtype == torch.bfloat16 and launch["core"] != "wgmma":
                    fail(f"ops.matmul {PREFILL_M}x{k_}x{n_} bfloat16 ran on "
                         f"the {launch['core']} core, not wgmma")
                print(f"[5] ops.matmul {PREFILL_M}x{k_}x{n_} order "
                      f"{order or 'planned'} {dtype_name}: {launch['name']} "
                      f"on {launch['core']}, {launch['cluster']} blocks a "
                      f"cluster (K3 {launch['k3_cluster']}), grid "
                      f"{launch['grid']}, max abs err vs ref.matmul "
                      f"{err:.3e}")
    gemm_launches = counts_of(GEMM_NAMES)
    print(f"[5] ops.matmul path: {mm_calls} calls, launches "
          + json.dumps(gemm_launches))
    for name in GEMM_NAMES:
        if gemm_launches[name] == 0:
            fail(f"the ops.matmul path never launched {name}")

    # ------------------------------------------------------------------ #
    # Phase 6: serving TinyLlama-1.1B at full width, through the graph
    # ------------------------------------------------------------------ #
    def rel_diff(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    class MoeRouting:
        """Inside the block, every ``moe.moe_ffn`` call also records the
        pairs its capacity drops and the experts of each row's last token
        (a read back to the host: never around a capture)."""

        def __init__(self):
            self.calls = []

        def __enter__(self):
            self.real = moe.moe_ffn

            def spy(x, p, cfg, axes=None):
                _, top_e = moe.route(x[:, -1], p["router"], cfg.top_k)
                self.calls.append((moe.dropped_pairs(x, p["router"], cfg),
                                   top_e.sort(dim=-1).values.cpu()))
                return self.real(x, p, cfg, axes)
            moe.moe_ffn = spy
            return self

        def __exit__(self, *exc):
            moe.moe_ffn = self.real

    def capture_in_place(phase, api, params, cache, b):
        """``steps.graph_decode_step`` over ``cache``, with K5's wrapper and
        ``ops._pad_to`` watched during its warm-up and capture: every
        cache that the captured launches (one replay's) hand K5 must be a
        layer view of the cache itself (its data pointer), and no padding
        copy may be made.  Returns the step."""
        views = {t[i].data_ptr() for t in leaves(cache) if t.dim() > 1
                 for i in range(t.shape[0])}
        seen, copies = [], []
        real_fd, real_pad = fd.decode_attention, ops._pad_to

        def spy(q, k, v, lengths, **kw):
            seen.append((k.data_ptr(), v.data_ptr()))
            return real_fd(q, k, v, lengths, **kw)

        def pad_spy(x, axis, mult):
            y = real_pad(x, axis, mult)
            if y is not x:
                copies.append(tuple(x.shape))
            return y

        fd.decode_attention, ops._pad_to = spy, pad_spy
        try:
            step = steps_mod.graph_decode_step(api, params, cache, b)
        finally:
            fd.decode_attention, ops._pad_to = real_fd, real_pad
        per_replay = step.launches_per_replay["flash_decode"]
        captured = seen[len(seen) - per_replay:]
        outside = [pair for pair in captured
                   if pair[0] not in views or pair[1] not in views]
        print(f"[{phase}] {api.cfg.name}: one replay's {per_replay} K5 "
              f"launches read {sum(p not in outside for p in captured)} "
              f"of their k, v pairs from the cache's own layer views "
              f"(data pointers); padding copies in the warm-up and capture "
              f"{len(copies)}")
        if outside or copies:
            fail(f"{api.cfg.name}: K5 does not read the cache in place: "
                 f"{len(outside)} launches read other storage, padding "
                 f"copies {copies}")
        return step

    def teacher_forced(phase, api, params, toks, t_p, max_len, tol,
                       floor_params=None):
        """Three teacher-forced decode steps after a prefill of ``t_p``
        tokens: the eager ``decode_fn`` against the prefill of the same
        tokens (within ``tol`` of the largest logit), and the graph's
        replay against the eager step on the same cache state (within
        SERVE_REL_TOL).  With ``floor_params`` (the same weights in
        float32) the prefill of the same tokens also runs in float32: its
        distance from the bfloat16 prefill is bf16's own error at that
        depth (its floor), and decode is held within the larger of
        ``tol`` and twice the floor, what two bf16 evaluations each as
        near to the float32 one as the prefill is can differ by (the
        triangle inequality).  For an MoE config top-k routing is a step
        function of the router's input, which the (B, d) decode products
        and the (B*T, d) prefill products round differently, so a token
        near a tie between its k-th and (k+1)-th expert can go to another
        expert: decode is held against prefill on the batch rows whose
        decoded token has the prefill's experts in every layer, and only
        where no prefill dropped a pair (a drop routes prefill under
        another capacity; the caller checks again at one that drops
        nothing).  The pairs dropped and the rows held are printed, and
        at least one row must be held over the three positions unless a
        prefill dropped pairs.  Returns the worst of each difference,
        whether every replay was bit-identical to its eager step, and the
        pairs dropped; the first is None where no row was held."""
        cfg = api.cfg
        b = toks.shape[0]
        moe_rec = MoeRouting() if cfg.n_experts else contextlib.nullcontext()
        with moe_rec:
            _, cache = api.prefill_fn(params, {"tokens": toks[:, :t_p]},
                                      max_len=max_len)
        drops = [c[0] for c in moe_rec.calls] if cfg.n_experts else []
        step = capture_in_place(phase, api, params, cache, b)
        worst_f, worst_g = None, 0.0
        identical = True
        held = 0
        for pos in range(t_p, t_p + 3):
            tok = toks[:, pos:pos + 1]
            rec_d = MoeRouting() if cfg.n_experts else \
                contextlib.nullcontext()
            rec_f = MoeRouting() if cfg.n_experts else \
                contextlib.nullcontext()
            # the eager step and the replay from one state: what the step
            # writes (a KV row; an SSM state whole) is put back between
            written = api.step_writes(cache, pos)
            before = [t.clone() for t in written]
            with rec_d:
                logits_e = api.decode_fn(params, cache, tok, pos)[0].clone()
            for t, b_ in zip(written, before):
                t.copy_(b_)
            logits_g = step(tok, pos).clone()
            with rec_f:
                logits_f, _ = api.prefill_fn(
                    params, {"tokens": toks[:, :pos + 1]}, max_len=max_len)
            tol_here, floor_txt = tol, ""
            if floor_params is not None:
                logits_32, _ = api.prefill_fn(
                    floor_params, {"tokens": toks[:, :pos + 1]},
                    max_len=max_len)
                floor = rel_diff(logits_f, logits_32)
                tol_here = max(tol, 2 * floor)
                floor_txt = (f" (the bf16 prefill vs the same prefill in "
                             f"float32: {floor:.3e}; decode vs the float32 "
                             f"prefill {rel_diff(logits_e, logits_32):.3e})")
                del logits_32
            torch.cuda.synchronize()
            for how, lg in (("eager", logits_e), ("graph", logits_g)):
                if lg.shape != (b, cfg.padded_vocab) or \
                        not bool(torch.isfinite(lg).all()):
                    fail(f"{cfg.name}: {how} decode logits at {pos}: "
                         f"{tuple(lg.shape)}, finite "
                         f"{bool(torch.isfinite(lg).all())}")
            rows = torch.ones(b, dtype=torch.bool)
            routing = ""
            if cfg.n_experts:
                drops += [c[0] for c in rec_f.calls]
                for d, f in zip(rec_d.calls, rec_f.calls):
                    rows &= (d[1] == f[1]).all(dim=-1)
                if any(drops):
                    rows[:] = False
                routing = (f"; capacity factor {cfg.capacity_factor}: the "
                           f"prefill drops {[c[0] for c in rec_f.calls]} "
                           f"pairs by layer; held on rows "
                           f"{rows.nonzero().flatten().tolist()} of {b}")
            held += int(rows.sum())
            rel_f = rel_diff(logits_e[rows.cuda()], logits_f[rows.cuda()]) \
                if rows.any() else float("nan")
            held_txt = (f" on the rows held (all rows "
                        f"{rel_diff(logits_e, logits_f):.3e})"
                        if cfg.n_experts else "")
            rel_g = rel_diff(logits_g, logits_e)
            same = bool(torch.equal(logits_g, logits_e))
            identical = identical and same
            print(f"[{phase}] {cfg.name} token {pos}: eager decode vs prefill "
                  f"of {pos + 1} tokens max |diff| / max |logit| = "
                  f"{rel_f:.3e}{held_txt}, tolerance {tol_here:.3g}"
                  f"{floor_txt}; graph vs eager "
                  f"max abs diff "
                  f"{(logits_g - logits_e).abs().max().item():.3e} "
                  f"({rel_g:.3e} of the largest logit, tolerance "
                  f"{SERVE_REL_TOL}), bit-identical {same}{routing}")
            if rows.any() and rel_f > tol_here:
                fail(f"{cfg.name}: decode logits at {pos} differ from "
                     f"prefill by {rel_f:.3e}")
            if rel_g > SERVE_REL_TOL:
                fail(f"{cfg.name}: the graph's logits at {pos} differ from "
                     f"the eager step's by {rel_g:.3e}")
            worst_g = max(worst_g, rel_g)
            if rows.any():
                worst_f = max(worst_f or 0.0, rel_f)
        if not held and not any(drops):
            fail(f"{cfg.name}: no batch row decoded to the prefill's experts "
                 f"in every layer at any of the three positions")
        return worst_f, worst_g, identical, sum(drops)

    def replay_profile(api, params, inputs, start, gen_len):
        """Prefill ``inputs`` (prompt tokens, or Whisper's frames), capture
        the step, then profile ``gen_len`` greedy replays from position
        ``start`` under torch.profiler, as the serving loop runs them, in
        up to PROFILE_SESSIONS sessions: the first whose K5 split and
        combine events equal the launches per replay (from the capture)
        times ``gen_len`` ends the search.  Returns (the step, each
        session's device events of K5's kernels, the device's busy ms per
        step in the last session); busy is None where the trace holds no
        device events."""
        logits, cache = api.prefill_fn(params, inputs,
                                       max_len=start + gen_len)
        b = logits.shape[0]
        step = steps_mod.graph_decode_step(api, params, cache, b)
        want = {kernel: step.launches_per_replay[counter] * gen_len
                for kernel, counter in K5_EVENTS.items()}
        sessions = []
        while len(sessions) < PROFILE_SESSIONS and (
                not sessions or sessions[-1] != want):
            tok = logits.argmax(dim=-1)[:, None]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(gen_len):
                    tok = step(tok, start + i).argmax(dim=-1)[:, None]
                torch.cuda.synchronize()
            events = dict.fromkeys(K5_EVENTS, 0)
            busy_us = 0.0
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    busy_us += ev.time_range.elapsed_us()
                    for name in events:
                        events[name] += name in ev.name
            sessions.append(events)
        return step, sessions, (busy_us / 1e3 / gen_len if busy_us else None)

    def check_replay_events(phase, name, step, sessions, replays):
        """The profiler's K5 device events over ``replays`` replays, session
        by session, against the launches per replay (from the capture)
        times the replays: no session may see more, and the last must see
        as many."""
        want = {kernel: step.launches_per_replay[counter] * replays
                for kernel, counter in K5_EVENTS.items()}
        for s, events in enumerate(sessions):
            for kernel in K5_EVENTS:
                print(f"[{phase}] {name}: {kernel} device events over "
                      f"{replays} replays (torch.profiler, session {s + 1} "
                      f"of at most {PROFILE_SESSIONS}) {events[kernel]}, "
                      f"launches per replay x replays {want[kernel]}")
                if events[kernel] > want[kernel]:
                    fail(f"{name}: the profiler saw {events[kernel]} "
                         f"{kernel} events over {replays} replays, more "
                         f"than the capture's {want[kernel]}")
        if sessions[-1] != want:
            fail(f"{name}: in none of {len(sessions)} profiler sessions of "
                 f"{replays} replays were K5's device events {want}: "
                 f"{sessions}")

    from torch.profiler import ProfilerActivity, profile

    api = registry.get("tinyllama-1.1b")
    cfg = api.cfg
    t0 = time.perf_counter()
    params = api.init_params(SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = api.count_params()
    print(f"[6] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} bfloat16 parameters "
          f"({n_params * 2 / 1e9:.2f} GB) made on the card from seed {SEED} "
          f"in {time.perf_counter() - t0:.1f} s")
    # teacher-forced decode against the prefill of the same tokens and the
    # graph against the eager step; it also warms cuBLAS and the kernels
    # up for the serving run's shapes
    t_p = SERVE["prompt_len"]
    max_len = t_p + SERVE["gen_len"]
    toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(
        SERVE["batch"], t_p + 3))).cuda()
    teacher_forced(6, api, params, toks, t_p, max_len, SERVE_REL_TOL)
    torch.cuda.empty_cache()
    eager_run = serve_mod._serve_loop(api, params, graph=False, **SERVE)
    zero_counts(K5_NAMES)
    run = serve_mod._serve_loop(api, params, **SERVE)
    host_launches = counts_of(K5_NAMES)
    per_replay = run.launches_per_replay
    serve_launches = per_replay["flash_decode"] * run.replays
    combine_launches = per_replay["flash_decode_combine"] * run.replays
    want_launches = cfg.n_layers * SERVE["gen_len"]
    _, serve_splits = ops._planned_split(
        max_len, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
        SERVE["batch"] * cfg.n_kv_heads, 2)
    want_combine = want_launches if serve_splits > 1 else 0
    print(f"[6] serve through the CUDA graph: generated token matrix "
          f"{run.tokens.shape}, prefill {run.prefill_ms:.2f} ms, capture "
          f"(warm-up and capture) {run.capture_ms:.1f} ms, decode "
          f"{run.decode_ms_per_step:.3f} ms/step, {run.tokens_per_s:.1f} "
          f"tokens/s; eager steps in the same run: decode "
          f"{eager_run.decode_ms_per_step:.3f} ms/step, "
          f"{eager_run.tokens_per_s:.1f} tokens/s; card: {card}")
    print(f"[6] K5 launches: {per_replay} per replay x {run.replays} "
          f"replays = {serve_launches} pairs (want {want_launches}) and "
          f"{combine_launches} combines (want {want_combine}, {serve_splits} "
          f"splits of a {max_len}-row cache); the host counters saw "
          f"{host_launches} (the warm-up's eager steps and the capture; "
          f"replays do not pass through the wrapper)")
    if serve_launches != want_launches:
        fail(f"the serving loop launched the decode kernel {serve_launches} "
             f"times, want {cfg.n_layers} layers x {SERVE['gen_len']} steps")
    if combine_launches != want_combine:
        fail(f"the serving loop launched the combine {combine_launches} "
             f"times, want {want_combine}")
    if host_launches["flash_decode"] != \
            (steps_mod.WARMUP_STEPS + 1) * per_replay["flash_decode"]:
        fail(f"the host counter saw {host_launches} during the warm-up and "
             f"the capture, want {steps_mod.WARMUP_STEPS + 1} x {per_replay}")
    for r in (run, eager_run):
        if r.tokens.shape != (SERVE["batch"], SERVE["gen_len"]) or \
                r.tokens.min() < 0 or r.tokens.max() >= cfg.padded_vocab:
            fail(f"generated tokens out of shape or range: {r.tokens.shape}")

    # ------------------------------------------------------------------ #
    # Phase 7: times of K3, K4 and K5 (CUDA events; profiled below)
    # ------------------------------------------------------------------ #
    def gemm_bound(m, n, k, dtype_name, eb, moved=None):
        """(ms, which) for bytes ``moved`` (default: A, B and C once
        each) and 2*m*n*k operations."""
        moved = (m * k + k * n + m * n) * eb if moved is None else moved
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / PEAK_FLOPS[dtype_name] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")

    def decode_bound(b_, hq, hkv, d_, lengths, dtype_name, eb):
        rows = sum(lengths)        # cache rows this run's lengths need
        moved = (2 * b_ * hq * d_ + 2 * rows * hkv * d_) * eb + 4 * b_
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * rows * hq * d_ / PEAK_FLOPS[dtype_name] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")

    new_rows = {name: [] for name in GEMM_NAMES + ("flash_decode",)}
    profiled_new, decode_profiled, serving_k5_rows = [], [], []
    big = dict(warmup=2, batches=3, per_batch=5)
    once = dict(warmup=0, batches=1, per_batch=1)
    for dtype_name, dtype in dtypes.items():
        eb = torch.finfo(dtype).bits // 8
        for (k_, n_) in PREFILL_KN:
            a, b = gemm_inputs(PREFILL_M, n_, k_, dtype)
            p = planner.plan_matmul(PREFILL_M, n_, k_, dtype_bytes=eb)
            runs = {"block_matmul_osta": "mnk",
                    "block_matmul_rmw": p.order if p.order[2] != "k"
                    else "mkn"}
            lib_ms = time_ms(lambda: a @ b, **big)
            b_ms, b_by = gemm_bound(PREFILL_M, n_, k_, dtype_name, eb)
            rows, fns = {}, []
            for name, order in runs.items():
                t = p.tiles if order == p.order else k4_tiles(p.tiles, eb)
                cl = p.cluster if order == p.order else (1, 1)
                trips = {"m": PREFILL_M // t["bm"], "n": n_ // t["bn"],
                         "k": k_ // t["bk"]}

                def call(a=a, b=b, order=order,
                         bn_=None if order == p.order else t["bn"]):
                    return ops.matmul(a, b, order=order, bn=bn_)

                def plain(a=a, b=b, order=order, t=t, cl=cl):
                    return bmm.block_matmul_plain(a, b, order=order,
                                                  cluster=cl, **t)
                terms = planner.gemm_terms(trips, t["bm"], t["bn"], t["bk"],
                                           order, cl, eb)
                plan_by = max(("operations", "l2", "dram", "push"),
                              key=lambda x: terms[x])
                call()
                rows[name] = {
                    "shape": f"{PREFILL_M}x{k_}x{n_}", "dtype": dtype_name,
                    "tiles": t, "order": order, "k3_cluster": cl,
                    "core": bmm.LAST_LAUNCH["core"],
                    "cluster": bmm.LAST_LAUNCH["cluster"],
                    "grid": bmm.LAST_LAUNCH["grid"],
                    "ms": time_ms(call, **big),
                    "plain_ms": time_ms(plain, **once),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "plan_bytes": terms["hbm_bytes"],
                    "plan_terms_ms": {x: terms[x] * 1e3 for x in (
                        "operations", "tensor", "step", "l2", "dram",
                        "push")},
                    "plan_bound_ms": terms[plan_by] * 1e3,
                    "plan_bound_by": plan_by,
                    "library_ms": lib_ms, "device_ms": None}
                new_rows[name].append(rows[name])
                fns.append(call)
            profiled_new.append((rows, fns))
        # K5 at TinyLlama's serving shapes in both dtypes; at phase 11's
        # (Zamba2's, Whisper's self and cross) in bfloat16, the serving
        # dtype, into rows of their own (the kernels line keeps
        # TinyLlama's)
        b_, hq, hkv, d_ = LLAMA_DECODE
        cases = [("TinyLlama", b_, hq, hkv, d_, s_, s_) for s_ in LLAMA_S]
        if dtype_name == "bfloat16":
            cases += [(label,) + shape
                      for label, shape in SERVING_DECODE.items()]
        for (label, b_, hq, hkv, d_, s_, valid) in cases:
            lengths = [valid] * b_
            q, k, v, lens = decode_inputs(b_, hq, hkv, d_, s_, dtype, lengths)
            bkv, splits = ops._planned_split(s_, d_, hq // hkv, b_ * hkv, eb)
            q4 = q[:, :, None, :]
            # the library call over the valid rows alone
            k_rep = k[:, :valid].repeat_interleave(hq // hkv, dim=2) \
                .transpose(1, 2).contiguous()
            v_rep = v[:, :valid].repeat_interleave(hq // hkv, dim=2) \
                .transpose(1, 2).contiguous()

            def call(q=q, k=k, v=v, lens=lens):
                return ops.decode_attention(q, k, v, lens)

            def plain(q=q, k=k, v=v, lens=lens, bkv=bkv, splits=splits):
                return fd.decode_attention_plain(q, k, v, lens, bkv=bkv,
                                                 splits=splits)

            def one_range(q=q, k=k, v=v, lens=lens, bkv=bkv):
                """The split kernel with one range per (b, kv_head): the
                walk in one block, for the time without the split."""
                return fd.decode_attention(q, k, v, lens, bkv=bkv)
            b_ms, b_by = decode_bound(b_, hq, hkv, d_, lengths, dtype_name,
                                      eb)
            row = {"model": label,
                   "shape": f"B{b_} Hq{hq} Hkv{hkv} D{d_} S{s_}",
                   "dtype": dtype_name, "bkv": bkv, "splits": splits,
                   "blocks": b_ * hkv * splits, "lengths": lengths,
                   "ms": time_ms(call),
                   "plain_ms": time_ms(plain, warmup=1, batches=3,
                                       per_batch=1),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": time_ms(
                       lambda: F.scaled_dot_product_attention(q4, k_rep,
                                                              v_rep)),
                   "one_range_ms": time_ms(one_range),
                   "device_ms": None}
            (new_rows["flash_decode"] if label == "TinyLlama"
             else serving_k5_rows).append(row)
            decode_profiled.append((row, call, one_range))

    # Kernel-alone times last: the profiler stays attached once it has run
    # and would slow the host side of every call timed after it.
    for rows, fns in profiled:
        dev = device_ms(fns, KERNEL_NAMES)
        for name, r in rows.items():
            r["device_ms"] = dev[name]
            dev_txt = "not measured" if dev[name] is None \
                else f"{dev[name]:.4f}"
            k1_txt = ""
            if "cluster" in r:
                per_step = "not measured" if dev[name] is None \
                    else f"{dev[name] * 1e3 / r['steps']:.3f}"
                k1_txt = (f" cluster {r['cluster']} ring {r['ring']} "
                          f"steps {r['steps']} us/step {per_step}")
            print(f"[4] {name} L{r['layer']} {r['dtype']} "
                  f"t_run={r['t_run']}{k1_txt}: call {r['ms']:.4f}  kernel "
                  f"alone {dev_txt}  plain {r['plain_ms']:.3f}  F.conv2d, "
                  f"full f32 {r['library_ms']:.4f} (TF32 "
                  f"{r['library_tf32_ms']:.4f})  bound {r['bound_ms']:.6f} "
                  f"({r['bound_by']})")
    # K1's pass of ResNet-8 in each type: the sums of the layers' rows
    for dtype_name in dtypes:
        rows = [r for r in layer_rows["conv2d_offload_planned"]
                if r["dtype"] == dtype_name]
        alone = None if any(r["device_ms"] is None for r in rows) \
            else sum(r["device_ms"] for r in rows)
        print(f"[4] conv2d_offload_planned ResNet-8 pass {dtype_name}: "
              f"{sum(r['steps'] for r in rows)} steps, call "
              f"{sum(r['ms'] for r in rows):.4f}  kernel alone "
              + ("not measured" if alone is None else f"{alone:.4f}")
              + f"  F.conv2d, full f32 "
              f"{sum(r['library_ms'] for r in rows):.4f} ms")
    for r, fn in one_block:
        dev = device_ms([fn], ("conv2d_offload_planned",))
        r["one_block_device_ms"] = dev["conv2d_offload_planned"]
        dev_txt = "not measured" if dev["conv2d_offload_planned"] is None \
            else f"{dev['conv2d_offload_planned']:.4f}"
        print(f"[4] conv2d_offload_planned L{r['layer']} {r['dtype']} as "
              f"one block (1x1) against its cluster of {r['cluster']}: "
              f"call {r['one_block_ms']:.4f} / {r['ms']:.4f}  kernel alone "
              f"{dev_txt} / "
              + ("not measured" if r["device_ms"] is None
                 else f"{r['device_ms']:.4f}"))
    print("[7] times in ms, as in [4]; library: torch.matmul for K3/K4, "
          "F.scaled_dot_product_attention on the GQA-repeated cache for K5; "
          f"card: {card}")
    for rows, fns in profiled_new:
        dev = device_ms(fns, tuple(rows), calls=5)
        for name, r in rows.items():
            r["device_ms"] = dev[name]
            dev_txt = "not measured" if dev[name] is None \
                else f"{dev[name]:.4f}"
            print(f"[7] {name} {r['shape']} {r['dtype']} tiles {r['tiles']} "
                  f"order {r['order']} K3 cluster {r['k3_cluster']} core "
                  f"{r['core']} cs={r['cluster']} grid={r['grid']}: "
                  f"call {r['ms']:.4f}  kernel alone {dev_txt}  plain "
                  f"{r['plain_ms']:.3f}  library {r['library_ms']:.4f}  "
                  f"bound {r['bound_ms']:.6f} ({r['bound_by']})  the "
                  f"planner's terms (core.planner.gemm_terms; trips "
                  f"{r['plan_bytes']} B) "
                  + ", ".join(f"{x} {v:.6f}"
                              for x, v in r["plan_terms_ms"].items())
                  + f": {r['plan_bound_ms']:.6f} ({r['plan_bound_by']})")

    # K3 where the planner prices it compute-bound or not: 8192^3 and the
    # sum over TinyLlama's prefill projections, beside torch.matmul and the
    # model's three bounds, in turns (K3, library, K3, library)
    sq = SQUARE_ROOFLINE
    a, b = gemm_inputs(sq, sq, sq, torch.bfloat16)
    p = planner.plan_matmul(sq, sq, sq, 2)
    trips = {d: sq // p.tiles["b" + d] for d in "mnk"}
    terms = planner.gemm_terms(trips, p.tiles["bm"], p.tiles["bn"],
                               p.tiles["bk"], p.order, p.cluster, 2)
    k3_ms, lib_ms = [], []
    for _ in range(2):
        k3_ms.append(time_ms(lambda: bmm.block_matmul(
            a, b, order=p.order, cluster=p.cluster, **p.tiles), **big))
        lib_ms.append(time_ms(lambda: torch.matmul(a, b), **big))
    del a, b
    k3_rows = [r for r in new_rows["block_matmul_osta"]
               if r["dtype"] == "bfloat16"]
    square = {"shape": [sq] * 3, "tiles": p.tiles, "order": p.order,
              "k3_cluster": p.cluster, "ms": k3_ms, "library_ms": lib_ms,
              "tflops": [2 * sq ** 3 / t * 1e-9 for t in k3_ms],
              "terms_ms": {x: terms[x] * 1e3 for x in (
                  "operations", "tensor", "step", "l2", "dram")}}
    new_rows["square"] = [square]
    print(f"[7] K3 {sq}^3 bfloat16 on {p.tiles} {p.order} cluster "
          f"{p.cluster}: " + ", ".join(f"{t:.4f}" for t in k3_ms)
          + " ms (" + ", ".join(f"{x:.1f}" for x in square["tflops"])
          + " TFLOP/s); torch.matmul " + ", ".join(f"{t:.4f}"
                                                    for t in lib_ms)
          + " ms; bounds ms: " + ", ".join(
              f"{x} {v:.4f}" for x, v in square["terms_ms"].items())
          + f"; card: {card}")
    print(f"[7] K3 over TinyLlama's prefill projections (m={PREFILL_M}, "
          f"bfloat16, the plans' tiles and clusters): call "
          f"{sum(r['ms'] for r in k3_rows):.4f} ms, kernel alone "
          + txt_sum([r["device_ms"] for r in k3_rows])
          + f" ms; torch.matmul {sum(r['library_ms'] for r in k3_rows):.4f}"
          f" ms; bounds ms: " + ", ".join(
              f"{x} {sum(r['plan_terms_ms'][x] for r in k3_rows):.4f}"
              for x in ("operations", "tensor", "step", "l2", "dram"))
          + f"; card: {card}")

    def txt(ms):
        return "not measured" if ms is None else f"{ms:.4f}"
    for r, call, one_range in decode_profiled:
        dev = device_ms([call], ("flash_decode_split", "flash_decode_combine"))
        split_ms, comb_ms = dev["flash_decode_split"], \
            dev["flash_decode_combine"]
        r["split_device_ms"], r["combine_device_ms"] = split_ms, comb_ms
        r["device_ms"] = None if split_ms is None or (
            r["splits"] > 1 and comb_ms is None) \
            else split_ms + (comb_ms or 0.0)
        r["one_range_device_ms"] = device_ms(
            [one_range], ("flash_decode_split",))["flash_decode_split"]
        print(f"[7] flash_decode {r['model']} {r['shape']} {r['dtype']} "
              f"lengths {r['lengths'][0]} splits={r['splits']} "
              f"bkv={r['bkv']} ({r['blocks']} blocks): "
              f"call {r['ms']:.4f}  kernel alone {txt(r['device_ms'])} (split "
              f"{txt(split_ms)} + combine {txt(comb_ms)})  plain "
              f"{r['plain_ms']:.3f}  library {r['library_ms']:.4f}  bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']}); one range per "
              f"(b, kv_head), splits=1: call {r['one_range_ms']:.4f}  kernel "
              f"alone {txt(r['one_range_device_ms'])}")

    # A decode step of the serving run under the profiler: the device's
    # busy time per step against the step's time measured without the
    # profiler in phase 6, eager and replayed, and the kernels that take
    # it; the replays' K5 device events are phase 6's witness.
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :t_p]},
                              max_len=max_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for pos in range(t_p, t_p + 3):
            _, cache = api.decode_fn(params, cache, toks[:, pos:pos + 1], pos)
        torch.cuda.synchronize()
    busy = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy[ev.name] = busy.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / 1e3 / 3
    if busy:
        busy_ms = sum(busy.values())
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        print(f"[7] eager decode step: device busy {busy_ms:.3f} ms of "
              f"{eager_run.decode_ms_per_step:.3f} ms per step (idle share "
              f"{1 - busy_ms / eager_run.decode_ms_per_step:.3f}); top "
              "kernels (ms/step): " + "; ".join(f"{name[:60]} {ms:.4f}"
                                                for name, ms in top))
    else:
        print("[7] eager decode step: device busy time not measured (the "
              "trace holds no device events)")
    step, sessions, busy_ms = replay_profile(api, params,
                                             {"tokens": toks[:, :t_p]}, t_p,
                                             PROFILED_REPLAYS)
    check_replay_events(6, cfg.name, step, sessions, PROFILED_REPLAYS)
    if busy_ms is None:
        fail("the trace of the graph's replays holds no device events")
    print(f"[6] replayed decode step: device busy {busy_ms:.3f} ms of "
          f"{run.decode_ms_per_step:.3f} ms per step (busy share "
          f"{busy_ms / run.decode_ms_per_step:.3f}, idle share "
          f"{1 - busy_ms / run.decode_ms_per_step:.3f}); card: {card}")
    serving_rows = {
        "arch": cfg.name, **SERVE, "prefill_ms": run.prefill_ms,
        "capture_ms": run.capture_ms,
        "decode_ms_per_step": run.decode_ms_per_step,
        "tokens_per_s": run.tokens_per_s, "busy_ms": busy_ms,
        "eager_decode_ms_per_step": eager_run.decode_ms_per_step,
        "eager_tokens_per_s": eager_run.tokens_per_s,
        "eager_busy_ms": sum(busy.values()) if busy else None,
        "k5_pairs": serve_launches, "k5_combines": combine_launches,
        "k5_split_events": sessions[-1]["flash_decode_split_kernel"],
        "k5_combine_events": sessions[-1]["flash_decode_combine_kernel"],
        "profile_sessions": len(sessions)}
    del params, cache, step
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # Phase 8: K1's traffic, layer by layer, against four witnesses
    # ------------------------------------------------------------------ #
    from repro_torch.analysis import kerncheck
    from repro_torch.obs import adapters
    from repro_torch.sim import ConvLayer, simulate_network

    t8 = t0 = time.perf_counter()
    checked = kerncheck.run_all()
    gemm_cases, decode_cases = kerncheck.standalone_cases()
    print(f"[8] kerncheck.run_all() ({time.perf_counter() - t0:.1f} s): "
          f"{checked.render().splitlines()[0]}; also {len(gemm_cases)} "
          f"GeMM and {len(decode_cases)} decode schedules")
    if not checked.ok:
        fail("kerncheck.run_all() found:\n" + checked.render())
    # the planner's TinyLlama prefill plans and 8192^3, on the core they
    # run on: the wgmma rings and, in a K4 cluster, rank 0's pushes of the
    # resident tile, in a K3 cluster every sharer's multicast shares
    for cfg in gemm_cases[len(kerncheck._STANDALONE_GEMM):]:
        gt = kerncheck.gemm_walk(**cfg)
        events = [e for ev in gt.clusters for e in ev]
        hazards = [h for ev in gt.clusters
                   for h in kerncheck.access.cluster_hazard_scan(ev)]
        pushes = sum(getattr(e, "tag", "").startswith("push to rank")
                     for e in events)
        multicasts = sum(getattr(e, "tag", "").startswith("multicast")
                         for e in events)
        ring = planner.matmul_wg_stages(cfg["bm"], cfg["bn"], cfg["bk"],
                                        cfg["order"][2] != "k")
        print(f"[8] kerncheck {cfg['m']}x{cfg['n']}x{cfg['k']} at "
              f"{cfg['bm']}x{cfg['bn']}x{cfg['bk']} {cfg['order']} K3 "
              f"cluster {gt.cluster}: core {gt.core}, cluster {gt.cs}, ring "
              f"{ring} slots, {len(events)} events, {pushes} pushes to "
              f"peers, {multicasts} multicast shares, {len(hazards)} "
              f"hazards")
        if gt.core != "wgmma" or not gt.clusters or hazards:
            fail(f"kerncheck's wgmma model of {cfg}: core {gt.core}, "
                 f"hazards {[h.describe() for h in hazards[:4]]}")
    checked = kerncheck.check_network("resnet8", hw=hw)
    print(f"[8] kerncheck.check_network('resnet8', H100 budget "
          f"{hw.size_mem} elements), float32 and bfloat16 traces: "
          f"{checked.render().splitlines()[0]}")
    if not checked.ok:
        fail("kerncheck on phase 3's plan found:\n" + checked.render())
    sim = simulate_network(plan, seed=SEED)
    print(f"[8] {sim.summary()} peak_within_budget="
          f"{sim.peak_within_budget}")
    if not (sim.correct and sim.accounting_exact
            and sim.peak_within_budget):
        fail("the simulator's run of phase 3's plan is not correct, "
             "exact and within budget")
    kern_tl = adapters.kernel_timeline(plan)
    zero_counts(KERNEL_NAMES)
    traffic_rows = []
    for lp, em, rep in zip(plan.layers, emitted, sim.layer_reports):
        s = em.spec
        layer = ConvLayer.random(s, seed=SEED + lp.index)
        x, k = layer_from_numpy(layer.input, layer.kernels,
                                dtype=torch.float32)
        counter.zero_()
        out = em.run(x, k)
        torch.cuda.synchronize()
        on_card = int(counter.item())
        err = max_err_within(
            out, torch.from_numpy(rep.output).to(out.device), "float32",
            f"EmittedConv.run L{lp.index} against the simulator")
        trace = kerncheck.build_conv_trace(em)
        diags = kerncheck.check_conv_trace(trace, lp.strategy, hw.size_mem,
                                           layer=lp.index)
        if diags:
            fail(f"kerncheck L{lp.index}: "
                 + "; ".join(d.render() for d in diags[:5]))
        counts = {"card": on_card, "simulator": rep.elements_read,
                  "kerncheck": trace.fetched_elements,
                  "plan": lp.strategy.pixels_loaded() * s.c_in
                  + s.kernel_elements,
                  "timeline": kern_tl.element_sum(layer=lp.index, chip=0,
                                                  lane="dma_in")}
        traffic_rows.append({"layer": lp.index, "t_run": em.t_run,
                             "cluster": "x".join(map(str, trace.cluster)),
                             "steps": len(trace.steps),
                             **counts, "max_abs_err": err})
        print(f"[8] L{lp.index} float32 t_run={em.t_run} cluster="
              f"{trace.cluster[0]}x{trace.cluster[1]} "
              f"steps={len(trace.steps)}: fetched elements card "
              f"{on_card}, simulator {rep.elements_read}, kerncheck "
              f"{trace.fetched_elements}, plan {counts['plan']}, kernel "
              f"timeline {counts['timeline']}; K1 max abs err vs the "
              f"simulator {err:.3e}")
        if len(set(counts.values())) != 1:
            fail(f"L{lp.index}: the five counts differ: {counts}")
    k1_launches = counts_of(KERNEL_NAMES)["conv2d_offload_planned"]
    if k1_launches != len(emitted):
        fail(f"phase 8 ran {len(emitted)} layers but K1 was launched "
             f"{k1_launches} times")
    print(f"[8] {len(emitted)} layers, {len(emitted)} launches of K1: "
          f"{sum(r['card'] for r in traffic_rows)} elements fetched, equal "
          f"to the simulator's reads, kerncheck's traffic, the plan's "
          f"charge and the kernel timeline's dma_in at every layer; phase "
          f"8 took {time.perf_counter() - t8:.1f} s")

    # ------------------------------------------------------------------ #
    # Phase 9: the framework-free stack on the card machine's host
    # ------------------------------------------------------------------ #
    import tempfile

    from repro_torch.analysis import lint
    from repro_torch.configs.tight import budget_points
    from repro_torch.core import solver
    from repro_torch.launch.plan_server import PlanService
    from repro_torch.obs import report as obs_report
    from repro_torch.obs.chrome import (to_chrome_trace,
                                        validate_chrome_trace,
                                        write_chrome_trace)
    from repro_torch.plancache import store as store_mod
    from repro_torch.resil import faultsim

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    t9 = t0 = time.perf_counter()
    obs_rep = obs_report.build_report("resnet8", include_kernel=True)
    write_chrome_trace(obs_rep.trace,
                       str(out_dir / "obs_trace_resnet8.json"))
    print(f"[9a] obs.report ({time.perf_counter() - t0:.1f} s): "
          + obs_rep.render().replace("\n", "\n[9a] "))
    if not (obs_rep.ok and obs_rep.trace_valid and obs_rep.lanes_ok
            and obs_rep.sim_correct and obs_rep.accounting_exact
            and obs_rep.kernel_rows
            and all(r.clean for r in obs_rep.kernel_rows)):
        fail("obs.report on resnet8 does not reconcile:\n"
             + obs_rep.render())

    t0 = time.perf_counter()
    schedule = faultsim.build_schedule(
        "mixed", 0, n_layers=len(specs), n_chips=4)
    faulted, findings = faultsim.run_checked(
        "resnet8", schedule, topology="torus2x2", seed=0)
    fault_trace = to_chrome_trace([
        adapters.multichip_predicted_timeline(
            faulted.plans[0], label="fault-free-predicted"),
        adapters.faulted_timeline(faulted)])
    findings += [f"trace: {e}" for e in validate_chrome_trace(fault_trace)]
    write_chrome_trace(fault_trace,
                       str(out_dir / "faultsim_resnet8_torus2x2.json"))
    print(f"[9b] faultsim ({time.perf_counter() - t0:.1f} s): "
          f"{faulted.summary()}; fingerprint {faulted.fingerprint[:16]}, "
          f"twin run equal: "
          f"{not any('nondeterministic' in f for f in findings)}; "
          f"{len(findings)} findings")
    if findings or not (faulted.ok and faulted.write_counts_ok
                        and faulted.recovery_exact):
        fail("faultsim on resnet8/torus2x2/mixed: " + "; ".join(findings))

    t0 = time.perf_counter()
    sweep = dict(budgets=budget_points(specs)[-2:],
                 topologies=("ring", "torus2x2"), chip_counts=(1, 4),
                 polish_iters=50)
    with tempfile.TemporaryDirectory() as cache_dir:
        passes = []
        for _ in ("cold", "warm"):
            solver.solve_cached.cache_clear()
            solver.best_s2_cached.cache_clear()
            store_mod.reset()
            passes.append(PlanService(cache_dir).sweep("resnet8", **sweep))
        store = store_mod.active_store()
        entries, warm_writes = len(store), store.writes
        store_mod.configure(None)
        store_mod.reset()
    cold, warm = passes
    prints = [[r.get("fingerprint") for r in rows] for rows in passes]
    print(f"[9c] plan server ({time.perf_counter() - t0:.1f} s): "
          f"{len(cold)} scenarios of resnet8, {entries} cache entries; "
          f"cold {sum(r['solver_calls'] for r in cold)} solver calls, "
          f"{sum(r['store_misses'] for r in cold)} store misses; warm "
          f"{sum(r['store_hits'] for r in warm)} store hits, "
          f"{sum(r['store_misses'] for r in warm)} misses, {warm_writes} "
          f"writes; fingerprints equal: {prints[0] == prints[1]}")
    if not (all(r["feasible"] and r["verified"] for r in cold + warm)
            and prints[0] == prints[1] and warm_writes == 0
            and sum(r["store_hits"] for r in warm) > 0
            and all(r["store_misses"] == 0 for r in warm)):
        fail("the warm plan-server pass was not all hits with the cold "
             "pass's fingerprints")

    t0 = time.perf_counter()
    found = lint.run_lint([ROOT / "src" / "repro_torch"],
                          usage_paths=lint.usage_paths(ROOT), base=ROOT)
    print(f"[9d] lint over src/repro_torch ({time.perf_counter() - t0:.1f} "
          f"s): {len(found)} findings")
    if found:
        fail("lint: " + "; ".join(f.render() for f in found[:5]))
    print(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s")

    # ------------------------------------------------------------------ #
    # Phase 10: the rest of the transformer family at full width
    # ------------------------------------------------------------------ #
    import dataclasses
    import gc
    t10 = time.perf_counter()
    family_rows = []
    for arch, depth in FAMILY:
        t0 = time.perf_counter()
        full = registry.get(arch)
        cfg = full.cfg if depth is None else \
            dataclasses.replace(full.cfg, n_layers=depth)
        api = registry.ModelApi(cfg=cfg, module=full.module)
        cut = "all" if depth is None else f"{depth} of {full.cfg.n_layers}"
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(SEED, device="cuda")
        torch.cuda.synchronize()
        n_params = api.count_params()
        heads = (f"MLA, {cfg.n_heads} heads, kv_lora {cfg.kv_lora_rank}"
                 if cfg.mla else f"{cfg.n_heads} heads / {cfg.n_kv_heads} "
                 f"KV heads of {cfg.head_dim}")
        experts = (f", {cfg.n_experts} experts top-{cfg.top_k}"
                   + (f" + {cfg.n_shared_experts} shared"
                      if cfg.n_shared_experts else "")
                   if cfg.n_experts else "")
        print(f"[10] {arch}: depth cut to {cut} layers (dataclasses.replace("
              f"n_layers={cfg.n_layers})); d_model {cfg.d_model}, {heads}, "
              f"d_ff {cfg.d_ff}{experts}, vocab {cfg.vocab}: {n_params} "
              f"bfloat16 parameters ({n_params * 2 / 1e9:.2f} GB) made on "
              f"the card from seed {SEED}")
        t_p = FAMILY_SERVE["prompt_len"]
        max_len = t_p + FAMILY_SERVE["gen_len"]
        toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(
            FAMILY_SERVE["batch"], t_p + 3))).cuda()
        tol = MLA_REL_TOL if cfg.mla else SERVE_REL_TOL
        worst_f, worst_g, identical, drops = teacher_forced(
            10, api, params, toks, t_p, max_len, tol)
        nodrop_f = None
        if drops:
            # Capacity drops make prefill and decode different functions:
            # the check of the decode path is made where no pair can drop
            # (capacity factor E / k: C >= the tokens).
            api_nd = registry.ModelApi(cfg=dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                module=full.module)
            nodrop_f, g_nd, same_nd, drops_nd = teacher_forced(
                10, api_nd, params, toks, t_p, max_len, tol)
            if drops_nd:
                fail(f"{arch}: {drops_nd} pairs dropped at capacity factor "
                     f"{api_nd.cfg.capacity_factor}")
            worst_g = max(worst_g, g_nd)
            identical = identical and same_nd
        torch.cuda.empty_cache()
        fam = serve_mod._serve_loop(api, params, **FAMILY_SERVE)
        pairs = fam.launches_per_replay["flash_decode"] * fam.replays
        combines = fam.launches_per_replay["flash_decode_combine"] \
            * fam.replays
        want = 0 if cfg.mla else cfg.n_layers * FAMILY_SERVE["gen_len"]
        if pairs != want:
            fail(f"{arch}: {pairs} K5 pairs over the replays, want {want}")
        if fam.tokens.shape != (FAMILY_SERVE["batch"],
                                FAMILY_SERVE["gen_len"]) or \
                fam.tokens.min() < 0 or fam.tokens.max() >= cfg.padded_vocab:
            fail(f"{arch}: generated tokens out of shape or range: "
                 f"{fam.tokens.shape}")
        step, sessions, busy_ms = replay_profile(api, params,
                                                 {"tokens": toks[:, :t_p]},
                                                 t_p, FAMILY_SERVE["gen_len"])
        check_replay_events(10, arch, step, sessions,
                            FAMILY_SERVE["gen_len"])
        if busy_ms is None:
            fail(f"{arch}: the trace of the graph's replays holds no device "
                 f"events")
        peak = torch.cuda.max_memory_allocated()
        row = {"arch": arch, "layers": cfg.n_layers,
               "published_layers": full.cfg.n_layers, "params": n_params,
               "gb": n_params * 2 / 1e9, "peak_gb": peak / 1e9,
               "decode_vs_prefill": worst_f, "graph_vs_eager": worst_g,
               "prefill_dropped_pairs": drops,
               "decode_vs_prefill_no_drop": nodrop_f,
               "bit_identical": identical, "k5_pairs": pairs,
               "k5_combines": combines, "prefill_ms": fam.prefill_ms,
               "capture_ms": fam.capture_ms,
               "decode_ms_per_step": fam.decode_ms_per_step,
               "tokens_per_s": fam.tokens_per_s, "busy_ms": busy_ms,
               "tokens_shape": list(fam.tokens.shape),
               "busy_share": busy_ms / fam.decode_ms_per_step}
        del params, step, fam
        gc.collect()
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        family_rows.append(row)
        held_txt = "not held" if worst_f is None else f"{worst_f:.3e}"
        print(f"[10] {arch}: {row['params']} parameters, peak "
              f"{row['peak_gb']:.2f} GB allocated; decode vs prefill "
              f"{held_txt} (tolerance {tol}"
              + (f"; the prefills dropped {drops} pairs; at a capacity that "
                 f"drops none {nodrop_f:.3e}" if drops else "")
              + f"), graph vs eager "
              f"{worst_g:.3e}, bit-identical {identical}; K5 pairs {pairs} "
              f"(want {want}), combines {combines}; generated tokens "
              f"{tuple(row['tokens_shape'])}; "
              f"prefill {row['prefill_ms']:.2f} ms, capture "
              f"{row['capture_ms']:.1f} ms, decode "
              f"{row['decode_ms_per_step']:.3f} ms/step, "
              f"{row['tokens_per_s']:.1f} tokens/s, device busy "
              f"{busy_ms:.3f} ms a step (busy share {row['busy_share']:.3f});"
              f" {row['seconds']:.1f} s; card: {card}")
    print(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s")

    # ------------------------------------------------------------------ #
    # Phase 11: the SSM, hybrid and encoder-decoder families, whole
    # ------------------------------------------------------------------ #
    from repro_torch.models import encdec, transformer
    from repro_torch.models.common import map_defs as map_tree

    def whisper_chain(api, params, frames, toks):
        """Prefill ``frames``, then teacher-forced decode of ``toks`` from
        position 1, eager and through the graph from one state, against
        ``encdec.decode_train`` of the BOS token and ``toks`` on the same
        encoder states, position by position (the BOS logits are the
        prefill's).  Returns (the worst decode vs decode_train and graph
        vs eager differences, relative to the largest logit, and whether
        every replay was bit-identical to its eager step)."""
        cfg = api.cfg
        b = frames.shape[0]
        logits, cache = api.prefill_fn(params, {"frames": frames})
        step = capture_in_place(11, api, params, cache, b)
        chain = [logits.clone()]
        worst_g, identical = 0.0, True
        for i in range(toks.shape[1]):
            pos, tok = 1 + i, toks[:, i:i + 1]
            written = api.step_writes(cache, pos)
            before = [t.clone() for t in written]
            logits_e = api.decode_fn(params, cache, tok, pos)[0].clone()
            for t, b_ in zip(written, before):
                t.copy_(b_)
            logits_g = step(tok, pos).clone()
            torch.cuda.synchronize()
            for how, lg in (("eager", logits_e), ("graph", logits_g)):
                if lg.shape != (b, cfg.padded_vocab) or \
                        not bool(torch.isfinite(lg).all()):
                    fail(f"{cfg.name}: {how} decode logits at {pos}: "
                         f"{tuple(lg.shape)}, finite "
                         f"{bool(torch.isfinite(lg).all())}")
            same = bool(torch.equal(logits_g, logits_e))
            identical = identical and same
            worst_g = max(worst_g, rel_diff(logits_g, logits_e))
            print(f"[11] {cfg.name} token {pos}: graph vs eager max abs diff "
                  f"{(logits_g - logits_e).abs().max().item():.3e}, "
                  f"bit-identical {same}")
            chain.append(logits_e)
        bos = torch.zeros((b, 1), dtype=toks.dtype, device=toks.device)
        hidden = encdec.decode_train(params,
                                     encdec.encode(params, frames, cfg),
                                     torch.cat([bos, toks], dim=1), cfg)
        worst_f = 0.0
        for pos, got in enumerate(chain):
            want = transformer._logits(hidden[:, pos], params["lm_head"])
            rel_f = rel_diff(got, want)
            worst_f = max(worst_f, rel_f)
            print(f"[11] {cfg.name} position {pos} ("
                  + ("prefill's BOS" if pos == 0 else "decode")
                  + f") vs decode_train of the same tokens: max |diff| / "
                  f"max |logit| = {rel_f:.3e}, tolerance {WHISPER_REL_TOL}")
            if rel_f > WHISPER_REL_TOL:
                fail(f"{cfg.name}: the decode chain at position {pos} "
                     f"differs from decode_train by {rel_f:.3e}")
        return worst_f, worst_g, identical

    def eager_step_profile(api, params, inputs, start):
        """One eager decode step (after one unprofiled) under the
        profiler: device ms per kernel name, or {} where the trace holds
        no device events."""
        _, cache = api.prefill_fn(params, inputs, max_len=start + 2)
        tok = torch.ones((next(iter(inputs.values())).shape[0], 1),
                         dtype=torch.long, device="cuda")
        api.decode_fn(params, cache, tok, start)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            api.decode_fn(params, cache, tok, start + 1)
            torch.cuda.synchronize()
        ops_ms = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                ops_ms[ev.name] = ops_ms.get(ev.name, 0.0) \
                    + ev.time_range.elapsed_us() / 1e3
        return ops_ms

    def at_the_jax_tests_depth(arch):
        """The JAX package's decode-vs-prefill test at its own depth (its
        reduced config's 2 layers, Zamba2's shared block after every 2)
        but at published width: one decode step after a prompt of
        ``SSD_SERVE["prompt_len"]`` tokens against the prefill of one
        more, bfloat16, within SSD_REL_TOL.  Returns the difference."""
        full = registry.get(arch)
        red = full.cfg.reduced()
        cfg = dataclasses.replace(full.cfg, n_layers=red.n_layers,
                                  attn_every=red.attn_every)
        api = registry.ModelApi(cfg=cfg, module=full.module)
        params = api.init_params(SEED, device="cuda")
        t_p = SSD_SERVE["prompt_len"]
        toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(
            SSD_SERVE["batch"], t_p + 1))).cuda()
        _, cache = api.prefill_fn(params, {"tokens": toks[:, :t_p]},
                                  max_len=t_p + 1)
        logits_d = api.decode_fn(params, cache, toks[:, t_p:], t_p)[0]
        logits_f, _ = api.prefill_fn(params, {"tokens": toks}, max_len=t_p + 1)
        rel_f = rel_diff(logits_d, logits_f)
        print(f"[11] {arch} at the JAX test's depth ({cfg.n_layers} layers"
              + (f", the shared block after every {cfg.attn_every}"
                 if cfg.attn_every else "")
              + f"), published width: decode of token {t_p} vs prefill of "
              f"{t_p + 1} tokens max |diff| / max |logit| = {rel_f:.3e}, "
              f"tolerance {SSD_REL_TOL}")
        if rel_f > SSD_REL_TOL:
            fail(f"{arch} at {cfg.n_layers} layers: decode differs from "
                 f"prefill by {rel_f:.3e}")
        return rel_f

    t11 = time.perf_counter()
    ssd_rows = []
    for arch in SSD_FAMILIES:
        t0 = time.perf_counter()
        api = registry.get(arch)
        cfg = api.cfg
        audio = cfg.family == "audio"
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(SEED, device="cuda")
        torch.cuda.synchronize()
        n_params = api.count_params()
        shape = (f"{cfg.n_layers} + {cfg.dec_layers} layers, {cfg.n_heads} "
                 f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}" if audio else
                 f"{cfg.n_layers} SSD layers, state {cfg.ssm_state}, "
                 f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, chunk "
                 f"{cfg.ssm_chunk}" + (
                     f", the shared attention block ({cfg.n_heads} heads of "
                     f"{cfg.head_dim}, d_ff {cfg.d_ff}) after every "
                     f"{cfg.attn_every}" if cfg.attn_every else ""))
        print(f"[11] {arch}: published width and depth, {shape}, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters "
              f"({n_params * 2 / 1e9:.2f} GB in bfloat16) made on the card "
              f"from seed {SEED}")
        b, gen = SSD_SERVE["batch"], SSD_SERVE["gen_len"]
        if audio:
            t_p, start = WHISPER_FRAMES, 1
            frames = torch.from_numpy(rng.standard_normal(
                (b, t_p, cfg.d_model))).to("cuda", torch.bfloat16)
            toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(b, 3))
                                    ).cuda()
            worst_f, worst_g, identical = whisper_chain(api, params, frames,
                                                        toks)
            inputs, tol, jax_depth = {"frames": frames}, WHISPER_REL_TOL, None
        else:
            t_p = start = SSD_SERVE["prompt_len"]
            toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(
                b, t_p + 3))).cuda()
            # at 54-64 random layers bfloat16's own rounding moves the
            # logits by more than the JAX bound (the bf16 prefill against
            # the same prefill in float32), so the whole model's decode is
            # held within the larger of the bound and twice that floor,
            # and within the bound itself at the JAX test's depth
            p32 = map_tree(lambda t: t.float(), params)
            worst_f, worst_g, identical, _ = teacher_forced(
                11, api, params, toks, t_p, t_p + gen, SSD_REL_TOL,
                floor_params=p32)
            del p32
            torch.cuda.empty_cache()
            jax_depth = at_the_jax_tests_depth(arch)
            inputs, tol = {"tokens": toks[:, :t_p]}, SSD_REL_TOL
        if not identical:
            fail(f"{arch}: the graph's logits are not bit-identical to the "
                 f"eager step's (worst {worst_g:.3e} of the largest logit)")
        torch.cuda.empty_cache()
        zero_counts(K5_NAMES + ("ssd_update_kernel",))
        run = serve_mod._serve_loop(api, params, batch=b, prompt_len=t_p,
                                    gen_len=gen)
        host = counts_of(K5_NAMES)
        host_ssd = COUNTS["ssd_update_kernel"]
        per_replay = run.launches_per_replay
        pairs = per_replay["flash_decode"] * run.replays
        combines = per_replay["flash_decode_combine"] * run.replays
        k5_per_step = (2 * cfg.dec_layers if audio else
                       cfg.n_layers // cfg.attn_every if cfg.attn_every
                       else 0)
        print(f"[11] {arch}: K5 launches {per_replay} per replay x "
              f"{run.replays} replays = {pairs} pairs (want "
              f"{k5_per_step} x {gen}) and {combines} combines; the host "
              f"counters, zeroed before the loop, saw {host} (the warm-up's "
              f"eager steps and the capture)")
        if pairs != k5_per_step * gen or run.replays != gen:
            fail(f"{arch}: {pairs} K5 pairs over {run.replays} replays, "
                 f"want {k5_per_step} x {gen}")
        if host["flash_decode"] != \
                (steps_mod.WARMUP_STEPS + 1) * per_replay["flash_decode"]:
            fail(f"{arch}: the host counter saw {host}, want "
                 f"{steps_mod.WARMUP_STEPS + 1} x {per_replay}")
        ssd_per_step = 0 if audio else cfg.n_layers
        print(f"[11] {arch}: the fused recurrent update launched "
              f"{per_replay['ssd_update_kernel']} times a replay (want "
              f"{ssd_per_step}), {host_ssd} on the host from the zeroed "
              f"counter (want {steps_mod.WARMUP_STEPS + 1} x "
              f"{ssd_per_step}: the warm-up and the capture)")
        if per_replay["ssd_update_kernel"] != ssd_per_step or host_ssd != \
                (steps_mod.WARMUP_STEPS + 1) * ssd_per_step:
            fail(f"{arch}: ssd_update launched "
                 f"{per_replay['ssd_update_kernel']} times a replay and "
                 f"{host_ssd} on the host, want {ssd_per_step} a step")
        if run.tokens.shape != (b, gen) or run.tokens.min() < 0 or \
                run.tokens.max() >= cfg.padded_vocab:
            fail(f"{arch}: generated tokens out of shape or range: "
                 f"{run.tokens.shape}")
        ops_ms = eager_step_profile(api, params, inputs, start)
        step, sessions, busy_ms = replay_profile(api, params, inputs, start,
                                                 PROFILED_REPLAYS)
        check_replay_events(11, arch, step, sessions, PROFILED_REPLAYS)
        if busy_ms is None:
            fail(f"{arch}: the trace of the graph's replays holds no device "
                 f"events")
        peak = torch.cuda.max_memory_allocated()
        top = sorted(ops_ms.items(), key=lambda kv: -kv[1])[:8]
        row = {"arch": arch, "layers": cfg.n_layers, "params": n_params,
               "ssd_update_launches": per_replay["ssd_update_kernel"]
               * run.replays,
               "gb": n_params * 2 / 1e9, "peak_gb": peak / 1e9,
               "prompt_len": t_p, "start": start,
               "decode_vs_reference": worst_f, "tolerance": tol,
               "decode_vs_prefill_at_jax_depth": jax_depth,
               "graph_vs_eager": worst_g, "bit_identical": identical,
               "k5_pairs": pairs, "k5_combines": combines,
               "k5_split_events": sessions[-1]["flash_decode_split_kernel"],
               "k5_combine_events":
                   sessions[-1]["flash_decode_combine_kernel"],
               "profile_sessions": len(sessions),
               "prefill_ms": run.prefill_ms, "capture_ms": run.capture_ms,
               "decode_ms_per_step": run.decode_ms_per_step,
               "tokens_per_s": run.tokens_per_s, "busy_ms": busy_ms,
               "busy_share": busy_ms / run.decode_ms_per_step,
               "eager_step_device_ms": sum(ops_ms.values()),
               "eager_step_top": top}
        del params, step, run
        gc.collect()
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        ssd_rows.append(row)
        versus = "decode_train" if audio else "prefill"
        print(f"[11] {arch}: decode vs {versus} {worst_f:.3e} (tolerance "
              + (f"{tol}" if audio else f"the larger of {tol} and twice "
                 f"bf16's floor; at the JAX test's depth {jax_depth:.3e}")
              + "), graph vs eager bit-identical; generated tokens "
              f"({b}, {gen}); prefill {row['prefill_ms']:.2f} ms, capture "
              f"{row['capture_ms']:.1f} ms, decode "
              f"{row['decode_ms_per_step']:.3f} ms/step, "
              f"{row['tokens_per_s']:.1f} tokens/s, device busy "
              f"{busy_ms:.3f} ms a step (busy share {row['busy_share']:.3f});"
              f" peak {row['peak_gb']:.2f} GB allocated; "
              f"{row['seconds']:.1f} s; card: {card}")
        print(f"[11] {arch}: one eager decode step, device "
              f"{row['eager_step_device_ms']:.3f} ms; top device operations "
              "(ms): " + "; ".join(f"{name[:70]} {ms:.4f}"
                                   for name, ms in top))
    print(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")

    # ------------------------------------------------------------------ #
    # Phase 12: training
    # ------------------------------------------------------------------ #
    training = training_phase(card)

    # ------------------------------------------------------------------ #
    # Phase 13: the mesh
    # ------------------------------------------------------------------ #
    mesh_out = mesh_phase(card, training, rel_diff)

    # ------------------------------------------------------------------ #
    # Phase 14: the port's examples on the card
    # ------------------------------------------------------------------ #
    examples_out = examples_phase(card)

    # ------------------------------------------------------------------ #
    # Phase 15: the fused Mamba-2 recurrent update
    # ------------------------------------------------------------------ #
    ssd_update_rows = ssd_update_phase(card)

    # ------------------------------------------------------------------ #
    # Phase 16: K5 at the decode cells' shapes
    # ------------------------------------------------------------------ #
    k5_cell_rows = k5_cells_phase(card)

    # One entry per kernel.  The conv kernels' times are sums over the
    # seven ResNet-8 layers in float32 (one pass of the network through
    # that kernel); the GeMM kernels' sums over the four distinct prefill
    # projections of a TinyLlama layer in bfloat16; the decode kernel's at
    # the serving shape (S = 512, bfloat16).  The file named by --json
    # holds every row.
    replaces = {
        "conv2d_offload_planned":
            "src/repro/kernels/conv2d_offload.py:321",
        "conv2d_offload": "src/repro/kernels/conv2d_offload.py:183",
        "block_matmul_osta": "src/repro/kernels/block_matmul.py:61",
        "block_matmul_rmw": "src/repro/kernels/block_matmul.py:79",
        "flash_decode": "src/repro/kernels/flash_decode.py:89",
    }
    sources = {"block_matmul_osta": "block_matmul",
               "block_matmul_rmw": "block_matmul"}
    launches = {**main_launches, **gemm_launches,
                "flash_decode": serve_launches}
    selected = {name: [r for r in layer_rows[name]
                       if r["dtype"] == "float32"] for name in KERNEL_NAMES}
    selected.update({name: [r for r in new_rows[name]
                            if r["dtype"] == "bfloat16"]
                     for name in GEMM_NAMES})
    selected["flash_decode"] = [r for r in new_rows["flash_decode"]
                                if r["dtype"] == "bfloat16"
                                and r["shape"].endswith(f"S{LLAMA_S[0]}")]
    times_are = dict.fromkeys(KERNEL_NAMES,
                              "sums over the 7 ResNet-8 layers, float32")
    times_are.update(dict.fromkeys(
        GEMM_NAMES, f"sums over TinyLlama's prefill projections m="
        f"{PREFILL_M}, (k, n) in {PREFILL_KN}, bfloat16, planner tiles"))
    times_are["block_matmul_rmw"] += (
        " with bn halved where K4's partial stage does not fit beside them")
    times_are["block_matmul_osta"] += " and K3 clusters"
    times_are["flash_decode"] = (
        f"one call at B={LLAMA_DECODE[0]} H_q={LLAMA_DECODE[1]} "
        f"H_kv={LLAMA_DECODE[2]} D={LLAMA_DECODE[3]} S={LLAMA_S[0]}, "
        f"bfloat16, full lengths; kernel alone is split plus combine")
    kernels = []
    for name in KERNEL_NAMES + GEMM_NAMES + ("flash_decode",):
        rows = selected[name]
        by = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{sources.get(name, name)}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": by,
            "library_ms": sum(r["library_ms"] for r in rows),
            "device_ms": None if any(r["device_ms"] is None for r in rows)
            else sum(r["device_ms"] for r in rows),
            "times_are": times_are[name]})
        if name == "flash_decode":
            kernels[-1].update(
                combine_launches=combine_launches, splits=rows[0]["splits"],
                bkv=rows[0]["bkv"],
                combine_device_ms=rows[0]["combine_device_ms"],
                # phase 11's serving runs, each counted on its own
                launches_phase11={r["arch"]: r["k5_pairs"]
                                  for r in ssd_rows},
                # phase 13 (c): the decode steps on the (1, 1) mesh
                launches_phase13=mesh_out["k5_launches"],
                # phase 16: the decode cells' shapes
                cells=k5_cell_rows)
    # no TPU kernel: the JAX package writes the step in jnp
    kernels.append({
        "name": "ssd_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_update.cu",
        "replaces": None,
        "launches": {r["arch"]: r["ssd_update_launches"] for r in ssd_rows},
        "max_abs_err": max(r["max_abs_err"] for r in ssd_update_rows),
        "ms": ssd_update_rows[0]["ms"],
        "plain_ms": ssd_update_rows[0]["plain_ms"],
        "bound_ms": ssd_update_rows[0]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": ssd_update_rows[0]["device_ms"],
        "times_are": "one layer's update at Zamba2-7B's decode shape (B 64, "
                     "H 112, P 64, N 64, G 2), bfloat16 inputs, a float32 "
                     "state; phase 11's replays counted as launches",
        "shapes": ssd_update_rows})
    layer_rows.update(new_rows)
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(
            {"card": card, "kernels": kernels, "layers": layer_rows,
             "traffic": traffic_rows, "serving": serving_rows,
             "family": family_rows, "ssd_families": ssd_rows,
             "serving_k5": serving_k5_rows, "training": training,
             "mesh": mesh_out, "examples": examples_out, "rates": rates},
            indent=1))

    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
