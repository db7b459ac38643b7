"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's paths, after building the hand-written CUDA kernels
from this checkout and holding each against its plain PyTorch
version at the shapes its path gives it:

- the distributed solve, ``AMGSolver(AMGConfig(backend="torch", n_pods=2,
  lanes=4)).setup(A).pcg(b)`` on the 27-point ``laplace_3d(64)`` (262,144
  rows, 8 stacked ranks of 32,768 rows), through ``ell_spmv``, ``ell_spmm``
  and ``bcsr_spmm``, each program call one replay of a captured CUDA graph;
  the block smoothers (``block_jacobi``, ``hybrid_gs``, ``hybrid_gs_sym``)
  on the same lowering through ``block_diag_apply`` and ``tri_solve``;
  ``AMGService`` on the same session, and a streaming refresh beneath its
  graphs; the paper's setup phase, ``AMGConfig(setup_backend="dist")``: the
  partitioned node-aware setup of the same matrix (host numpy, its Galerkin
  row exchanges under the selected NAP schedules) lowered straight onto the
  card and solved through the same kernels; the communication audit over
  the replayed graphs; AMGWire, the socket server, with two tenants on the
  card serving ``laplace_3d(48)``; the same solve with one process per rank,
  ``AMGConfig(ranks="process")``: 8 gloo processes on this card, their
  collectives ``torch.distributed`` calls staged through host memory;
- LM serving, ``Engine(cfg, init_lm(qwen3-1.7b)).run()`` at full width (28
  layers, d_model 2048, 16/8 heads of 128, vocab 151,936; random weights
  from a seeded generator): in float32, 8 requests of 512-2048 prompt
  tokens and 32 greedy new tokens in batches of 4; then in bfloat16
  (weights, caches and the engine), the first 4 of those requests again;
  prefill attention through ``flash_attention``;
- the MoE archs, ``mixtral-8x22b`` (8 experts top-2, 48/8 heads, a 4096-key
  window) and ``qwen3-moe-235b-a22b`` (128 experts top-8, 64/4 heads) at
  full width and 2 layers in bfloat16 through the same engine, their FFN
  ``models/moe.py``'s ``moe_ffn_tp``; one qwen3-moe layer expert-parallel
  (``moe_ffn_ep``) over the 2 x 4 stacked ranks through
  ``hier_all_to_all``;
- the recurrent archs at full width and depth through the same engine:
  ``xlstm-125m`` (12 layers of mLSTM and sLSTM, d_model 768, no attention)
  in f32 and bf16, and ``recurrentgemma-9b`` (38 layers: RG-LRU blocks and
  local attention, 16 query heads on one KV head of 256 dims, 10.4 B
  parameters) in bf16, its prefill attention through ``flash_attention``'s
  head-dim-256 instance;
- training in f32, ``make_step_fn`` (loss, autograd, AdamW) at full width:
  qwen3-1.7b whole through ``launch/train.py``, xlstm-125m, and the MoE and
  hybrid-recurrent archs cut in depth (mixtral-8x22b and
  qwen3-moe-235b-a22b at 1 layer, recurrentgemma-9b at 5), each against
  the same step in float64 on the card.

Phases (any failure exits non-zero):

1. device: card name and power limit (``nvidia-smi``), CUDA capability;
2. build: ``nvcc`` for every kernel source, all at once; ``ptxas -v``'s
   registers, stack and spills of every ``flash_attention`` and
   ``ell_spmm`` instance;
3. kernels: each kernel in float32 and float64 (BCSR at bs 8 and 16, cut
   to the true rows) on the lowered hierarchy's own operands, against its
   plain version (error normalized by the plain result's max magnitude:
   float32 1e-5, float64 1e-12), with device times (CUDA events around
   bursts of 10 calls queued behind a GPU spin, median of 25) of the
   kernel, the plain version and ``torch.sparse.mm`` on the same operator in
   CSR, the wrapper's host cost per call, and the bytes-over-bandwidth
   bound; ``ell_spmv`` and ``ell_spmm`` (k = 8) in float64 at every ELL
   operand the f64 single-RHS and k = 8 solves launch (levels, A/P/R,
   on/off parts), with launches per solve (tallied by operand at the
   capture of the solve's graphs, times each graph's replays; the tally
   must equal the launch counter there and in phase 4's / 5's counted run)
   and the sums of launches × (time − bound) and of launches × time over
   them; ``block_diag_apply`` (bs 4) and ``tri_solve`` (both triangles,
   on the route its rule takes and on every other that can take the case
   (``smoother.tri_routes``), bit-equal across routes, run to run and in
   another valid order: plain row order on the L2 route, each level set
   reversed on the block and staged routes), k = 1 and 8,
   f32 and f64, at
   every non-coarsest level on the lowered hierarchy's own factors, beside
   batched ``torch.matmul`` and ``torch.triangular_solve`` on a sparse CSR
   operand (cuSPARSE; "none" where the install has none), with each
   triangle's DAG depth and µs a dependent step; a chain of 8,192 rows on
   each route gives the one-step floor and each row's second bound, depth
   × floor;
4. f64 PCG to 1e-8 through the captured graphs, residual history against
   the numpy host backend (≤ 1e-7 of r0), true residual in numpy, setup /
   lowering / per-iteration times, the device time of a warm solve by
   kernel and the busy share (``torch.profiler``) beside the numbers of
   the same solve run eagerly, and the host's CUDA runtime calls by name; two warm solves of 5
   and 10 iterations: one ``cudaGraphLaunch`` per program call and the same
   ``cudaLaunchKernel`` count; the history through the graphs against the
   eager program bodies (bit-equal, else ≤ 1e-14 of r0); in the last of 5
   ``pcg_step`` replays, the share of the level-0 exchange's kernel time
   concurrent with the level-0 ``A_on`` (printed); the graphs' pool bytes;
   before it, 10 BCSR applies of each BCSR level profiled alone: 10 device
   kernels, all ``bcsr_spmm``'s;
5. multi-RHS PCG on ``[n, 8]``, each column against its single-RHS run;
6. f32 PCG to 1e-5; then the bfloat16 phase: the same host hierarchy
   lowered in bfloat16 (``AMGConfig(dtype="bfloat16")``), ``ell_spmv``
   and ``ell_spmm`` (k = 8) at level 0's ``A_on`` and ``bcsr_spmm`` at
   each BCSR level (k = 1 and 8) in bfloat16 against their plain versions
   (|kernel − plain| ≤ one bfloat16 ulp of plain + 2^-16 Σ|a·x| an entry:
   both sum in float32 and round once, in another order), with ``torch.sparse.mm`` on a
   bfloat16 CSR where the install has it ("none" and its error where it
   raises); PCG to 1e-5 through the captured graphs (one replay a program
   call), its launches per iteration those of the f64 solve, its x within
   2^-5 of the f64 x, ms an iteration, the float64 true residual and the
   busy share; and a k = 8 bfloat16 solve through ``AMGService`` (8
   requests coalesced into one chunk, each x within 2^-5 of the f64
   [n, 8] solve's column);
   then the block smoothers, each session sharing the
   f64 (f32) lowering: PCG to 1e-8 with ``block_jacobi`` and with
   ``hybrid_gs_sym``, the stationary solve with ``hybrid_gs`` to 1e-8,
   ``hybrid_gs_sym`` PCG on ``[n, 8]`` (each column against its single-RHS
   run) and in f32 to 1e-5; each with its launches, its history against
   the same session run eagerly through the plain versions (≤ 1e-7 of r0 in
   f64, 1e-4 in f32), its true residual, ms an iteration, device time by
   kernel and busy share, one ``cudaGraphLaunch`` a program call; the
   factors' bytes beside the reference's dense factors'; then the block
   smoothers in bfloat16 on the bfloat16 lowering: ``block_diag_apply`` at
   level 0 (bit-equal to its order's emulation, ``smoother/bf16_order.py``,
   a gate) and ``tri_solve`` on both triangles at every level that smooths
   (each route that can take the case, the staged route at k = 1 among
   them, k = 1 and 8, bit-equal across routes and orders) against their
   plain versions at the bfloat16 bar, each row saying whether it is
   bit-equal to the plain version and (k = 1) to its order's emulation,
   with its bytes bound, depth × its route's one-step floor on a bfloat16
   chain, the plain version's ms and batched bf16 ``torch.matmul`` /
   cuSPARSE on the float32-widened factor; PCG to 1e-5
   with ``block_jacobi`` and ``hybrid_gs_sym`` through the graphs (x
   within 2^-5 of the f64 block-smoother runs' x, ms an iteration as the
   median of 5 warm solves, device ms) and a k = 8 ``hybrid_gs_sym`` chunk
   through ``AMGService``;
7. launch counts of the solve runs (each counter set to 0 just before a
   run and read just after; a graph's launches count once per replay):
   every sparse kernel launched; then the partitioned setup
   (``setup_backend="dist"``, f64, 2×4, the ``tpu_v5e`` constants): setup
   and lowering seconds, ``bound.hierarchy is None``, each SpGEMM
   exchange's record (strategy, modeled times, inter / intra messages and
   bytes, halo rows, seconds), ``audit_setup`` with 0 violations over ≥ 10
   exchanges running all three strategies, every lowered operator against
   the host-setup f64 session (ELL column maps bit-equal, values, ``dinv``
   and ``coarse_inv`` within 1e-12, the same kernel table), PCG through its
   graphs (the same iterations, history ≤ 1e-7 of r0, launch tallies by
   operand and launch counts equal to the host-setup session's, ms an
   iteration warm) and ``[n, 8]``; then ``AMGService`` with its worker
   thread on the f64 session, two rounds of 16 requests (one RHS and
   ``[n, 2]``) in two bursts: coalesced chunks of at most 8 columns, each
   result's true residual under 1e-7, solves/s and graph captures by
   width; then ``update(delta=ΔA)`` (the reference suite's drift, scale
   0.03, seed 1): a refresh, no graph captured again, history against the
   host session refreshed the same way (≤ 1e-7 of r0), update seconds
   against a fresh setup's; ``hybrid_gs_sym`` PCG beneath the refreshed
   graphs (none captured again) against a fresh lowering of the refreshed
   hierarchy (≤ 1e-7 of r0); the dist-born session's ``update`` with the
   same drift (a refresh, no graph captured again, its history against the
   refreshed host-setup session ≤ 1e-7 of r0), its ``hybrid_gs_sym`` PCG
   against its eager plain run (≤ 1e-7 of r0), and an aggressive
   partitioned setup of ``laplace_3d(32)`` (its ``spgemm_S2`` exchange
   audited clean, PCG against the host aggressive setup's history ≤ 1e-7
   of r0); then the communication audit
   (``repro_torch.analysis``): every program the f64 session captured
   (widths 1, 8 and the service's) read from the log each replay adds,
   against the count model; a replayed PCG's log against the sum of its
   program calls; the poisoned-halo overlap check on level 0's ``A``; the
   whole V/W/F × five-smoother grid over all ten programs, captured, on
   ``laplace_3d(24)``: zero violations; then AMGWire: a ``ServerThread``
   with two f64 tenants, ``laplace_3d(48)`` registered over the socket
   (62 MB frame, limit 64 MiB), 16 solves in two bursts, an ``update``,
   8 more (and three lone solves), launch counters set to 0 just before
   and read just after; each answer's residual ≤ 100·tol and against the
   in-process service's answer for the same b; solves/s over the wire,
   p50/p99 latency, the session's bytes as the store counts them; then one
   process per rank (``repro_torch.launch.ranks.spawn``: 8 gloo processes on
   ``cuda:0``, each ``AMGSolver(AMGConfig(ranks="process", ...)).setup(A)``
   and f64 PCG of ``b`` and of ``[n, 8]``, launch counters set to 0 just
   before each and read just after): every rank's tensors on ``cuda:0``,
   its launches of ``ell_spmv``, ``bcsr_spmm`` and ``ell_spmm`` equal to
   the stacked session's, its iterations the stacked session's, its
   histories within 1e-7 of r0 of the stacked ones and identical on every
   rank, its audit of (V, Jacobi)'s ten programs clean; ms an iteration
   beside the stacked path's, setup / lowering / scatter seconds, and the
   elements one PCG iteration sends over the slow and the fast group (and
   the collectives' host ms) under ``auto`` and each forced strategy,
   beside the model's messages; one ``hier_all_to_all`` of each strategy
   (flat, nap3) between the ranks bit-equal to the stacked form, its log the
   strategy's signature; a bfloat16 PCG of ``b`` to 1e-5 on the ranks,
   identical on every rank and bit-equal to the stacked bfloat16 session
   (or else within the bfloat16 bars), ms an iteration;
8. flash attention at the serving runs' prefill shape, with a 256-key
   window, with fewer queries than keys, at head dim 64, and at
   recurrentgemma-9b's head dim 256 (16:1, S 1819, its 2048-key window,
   which binds nothing there, and a 256-key window that binds), each in f32
   and bf16, and at the MoE archs' prefill shapes (48:8 with the 4096-key
   window, 64:4) in bf16, against its plain version (each row's error over
   the row's max|plain|: float32 2e-5, bfloat16 1e-2), each through the
   kernel the route table names (float32: ``flash_attention.cu``, 3xTF32 on
   ``mma.sync``; bfloat16: ``flash_attention_wgmma.cu``, ``wgmma`` fed by
   TMA), its per-kernel count checked, with device times of the kernel, the
   plain version and ``scaled_dot_product_attention``, and the flop / byte
   bound (float32 as 3xTF32 at a third of the tensor cores' 495 TFLOP/s,
   with the FMA units' 67 TFLOP/s bound beside it; bfloat16 at the tensor
   cores' 989);
9. LM serving in f32: one warm-up request, then the 8 requests with the
   counters set to 0 just before and read just after (28
   ``flash_attention`` launches per prefill batch, each bf16 one through
   the ``wgmma`` kernel's counter too); prefill seconds, decode
   tokens/s, and the device busy share of one decode step
   (``torch.profiler``);
10. kernel vs plain on the served batches, teacher-forced with the served
   tokens: prefill logits and every decode step's logits through the
   kernel and through the plain attention agree to 1e-4 of max|logits|;
   greedy-token agreement is printed, not asserted;
9-10 again in bf16 on 4 requests (one prefill batch: 28 launches; logits
   to 3e-2 of max|logits|, the reason at ``LOGITS_RTOL``), then bf16's
   prefill s, decode tok/s and ms a step beside f32's;
11. the MoE phase: each MoE arch at full width, 2 layers, bf16, serving
   the first 4 requests (their tokens drawn in its vocab; one prefill
   batch: 2 ``flash_attention`` launches, counters set to 0 just before
   and read just after): parameters, init s, prefill s, decode tok/s, ms a
   step, peak GiB, the share of (token, slot) selections the capacity
   dropped at prefill and at decode; kernel vs plain, routing-aware: each
   layer's attention on the same input (per row, 1e-2), the share of tokens
   whose experts or kept slots differ in any layer between a kernel and a
   plain walk of the prefill and the logits of the rest (printed), the
   logits of every token with the plain walk's experts forced to the
   kernel walk's (3e-2 of max|logits|), the kernel walk against
   ``LM.forward``; each layer's routing readings (drops with and without
   the pads, the share of the router input's energy in its token mean,
   the router logits' spreads), also with the embedding scaled to unit
   size; then qwen3-moe's layer 0 expert-parallel over the 2 x 4
   stacked ranks (16 experts, 512 tokens a rank): ``nap`` on and off
   bit-equal, each logging 2 x its all-to-all signature, and at the least
   capacity where nothing drops, EP against ``moe_ffn_tp`` (float32
   rtol / atol 1e-4, bfloat16 3e-2 of max|y|), with wall ms;
12. the recurrent phase: xlstm-125m in f32 and bf16 and recurrentgemma-9b
   in bf16, at full width and depth, each serving the first 4 requests
   (one prefill batch; ``flash_attention`` launches counted as in 9: 12
   for recurrentgemma-9b's attention layers, 0 for xlstm-125m): parameters,
   init s, prefill s, decode tok/s, ms a step, peak GiB; kernel vs plain
   logits teacher-forced as in 10 (``LOGITS_RTOL``; recurrentgemma-9b's
   bf16 at 5e-2, the reason at ``ARCH_LOGITS_RTOL``), and for
   recurrentgemma-9b the hidden state's kernel-vs-plain drift after each
   layer of two prefill walks (printed); xlstm-125m's mLSTM pad decay at
   the served prompt (printed); one layer of each
   recurrent kind at the served shapes in the served type against the
   same code in float64 on the card (``LAYER_RTOL`` of max|y|, printed
   with the states' errors and the layer's ms); each model freed before
   the next;
13. the embedding-input phase: phi-3-vision-4.2b (32 heads of 96: the
   flash kernel's head-dim-96 instances, checked at its prefill shape in
   the flash cases of 8) and musicgen-medium, each at full width and depth
   in f32 and bf16, served on the stub frontend's embeddings at the first 4
   prompts' lengths (32 and 48 flash launches a batch, counted as in 9);
   kernel vs plain logits teacher-forced with zero embeddings at decode, as
   in 10;
14. the training phase (f32, TF32 off): ``repro_torch.launch.train`` at its
   defaults on qwen3-1.7b at full width and depth (batch 8, seq 256, 3
   steps, its checkpoint in the reference's format), the checkpoint
   restored bit-equal and stepping as the live model does, 2 microbatches
   against 1, timed steps (ms, tokens/s, device ms, busy share, peak GiB),
   the loss falling on a periodic token file, seq 2048 with remat through
   ``chunked_attention``, the step against float64 at 2 layers, and
   xlstm-125m trained 3 steps;
15. the training-families phase (``train_families_phase``; f32, TF32
   off, full width, moments donated): mixtral-8x22b and qwen3-moe-235b-a22b
   at 1 layer, recurrentgemma-9b at 5, each depth refused where its
   training state (16 B a parameter, counted under ``FakeTensorMode``)
   leaves too little of the card; timed steps at batch 8 x seq 256 (ms,
   tokens/s, device ms, busy share, peak GiB, the MoE capacity-dropped
   share), the loss falling on a periodic token file, and one step against
   float64 (1 layer, 1 layer, 3 layers) with the float64 run's experts
   forced to the float32 run's (the picks its own top-k would have moved
   counted), loss, grad norm, m and v at ``F64_RTOL``; recurrentgemma-9b
   also at batch 1 x seq 4096 with remat (its window of 2048 binds), and 3
   layers of it there against float64;
16. the grad-sync phase: ``hier_grad_sync`` (flat, nap3, nap3 + int8) over
   one qwen3-1.7b layer's gradient tree on the 2 x 4 stacked ranks and on 8
   gloo processes on this card, bit-equal, with the slow and fast groups'
   elements beside the model's figures;
17. the dry-run phase (``scripts/dryrun_phase.py`` alone): ``ert_stream``
   (16 FMAs an element) and ``ert_gather`` against their plain versions at
   2^26 elements in f32 and f64, then the roofline's measured ceilings
   (``launch/roofline.py:ert_sweep``, f32 and f64: the reference's working
   sets and two past the 50 MB L2, the kernels' launches counted over the
   sweeps), the AMG cell (the SpMV's halo exchange on 2 x 256 stacked
   ranks, standard / NAP-2 / NAP-3: halo bit-equal to ``x[need]``, log
   equal to the plan's signature, bytes a rank and pod-crossing bytes),
   and the full-width dry-run on the fake 2x16x16 mesh of qwen3-1.7b and
   qwen2-0.5b train_4k, mixtral-8x22b decode_32k, xlstm-125m long_500k and
   recurrentgemma-9b prefill_32k (probes at 1 and 2 pattern groups,
   extrapolated: peak GiB a device, an estimate; FLOPs a device at least
   the model's,
   collective and pod-crossing bytes, roofline terms at the documented and
   measured ceilings); under 150 s;
18. one JSON line with every kernel's numbers (both flash kernels' instances
   at each head dim with their ptxas lines and cases; the ``wgmma`` kernel's
   own entry, its main path the bf16 serving runs; the ERT kernels', their
   main path the sweeps) and every phase's seconds;
19. last line: ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and refuses to run without one.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SIZE = 64                     # laplace_3d(SIZE): 262,144 rows
DEVICE = "cuda"
N_PODS, LANES = 2, 4
K_RHS = 8
SEED = 0
SAMPLES, BURST = 25, 10      # kernel timings: median of 25 bursts of 10
SLEEP_CYCLES = 5_000_000     # ~3 ms of GPU spin: the host queues a burst
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# the card's highest dense rate for each type (H100 SXM data sheet): float32
# outside the tensor cores, float64 and bfloat16 on them
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12,
              torch.bfloat16: 989e12}
# flash attention in float32 runs as three TF32 passes on the tensor cores
# (3xTF32, 495 TFLOP/s dense TF32 on the data sheet), so its flop bound is
# taken at a third of that rate; the FMA units' bound (PEAK_FLOPS) stays
# beside it in each row as bound_fma_ms
TF32X3_FLOPS = 495e12 / 3
# the flash kernels (``flash_attention.route`` picks one by dtype and head
# dim) and the design each runs for a dtype
FLASH_KERNELS = ("flash_attention", "flash_attention_wgmma")
FLASH_DESIGN = {
    ("flash_attention", torch.float32): "3xTF32 on the tensor cores (mma.sync m16n8k8)",
    ("flash_attention_wgmma", torch.bfloat16):
        "bf16 on wgmma m64nNk16, TMA into a 2-stage ring, a producer warp and two "
        "consumer warpgroups"}
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# flash attention: each output row's error over the row's own max|plain|
# (``rel_err_rows``: late causal rows are far smaller than the first ones);
# bfloat16 rounds the output (8-bit mantissa, 4e-3 relative) and P
FLASH_RTOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# the plain flash version's timing bursts (it takes 7-26 ms a call at the
# prefill shapes, 40-300 times the kernel: fewer bursts keep the phase short)
FLASH_PLAIN_SAMPLES = 5
HIST_TOL = 1e-7
GRAPH_ITERS = (5, 10)         # two PCG lengths whose runtime calls compare
OVERLAP_REPLAYS = 5           # pcg_step replays profiled; the last is read
# the service phase: 16 requests a round in two bursts, 0.05 s apart,
# inside one 0.25 s coalescing window
SERVICE_REQUESTS, SERVICE_GAP, SERVICE_WINDOW = 16, 0.05, 0.25
# the same f64 PCG with its programs run eagerly, one Python call per
# operation (PERF.md, measured on an NVIDIA H100 80GB HBM3 at 700 W):
# ms an iteration, device ms an iteration, busy share
EAGER_MS_ITER, EAGER_DEVICE_MS_ITER, EAGER_BUSY = 12.197, 1.209, 0.099
APPLY_REPS = 10               # BCSR applies profiled alone, per BCSR level
# the partitioned setup phase's aggressive (distance-2) setup: its
# spgemm_S2 exchange, at a size whose aggressive hierarchy has 3 levels
AGGRESSIVE_SIZE = 32
# the audit's grid of V/W/F × the five smoothers over all ten programs, at
# a smaller depth than the main path so its 150 captures stay cheap
AUDIT_SIZE = 24
# the process phase: seconds its 8 spawned ranks may take in all
PROCESS_DEADLINE = 400.0
# the wire phase: the largest Laplacian whose register frame fits the wire's
# 64 MiB frame limit (laplace_3d(48): a 62,263,466-byte frame), and a small
# one for the second tenant; wire answers against the in-process service's
# for the same b: each within 1e3 · tol of max|x| (their coalesced chunks
# may differ, and a column in a wider chunk runs on past its convergence)
WIRE_SIZE, WIRE_SMALL = 48, 16
WIRE_X_RTOL = 1e-5
# kernel vs plain logits, teacher-forced, over max|logits|: float32 at 1e-4
# (two summation orders over 28 layers); bfloat16 at 3e-2: the kernel rounds
# the probabilities to bfloat16 before P.V where the plain version keeps
# them in float32, each layer's output is rounded to bfloat16 (8-bit
# mantissa, 4e-3 relative) on both sides, and 28 layers carry a difference
# of one rounding forward
LOGITS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# recurrentgemma-9b in bfloat16: 5e-2.  Each of its 12 attention layers adds
# the kernel's own rounding of P to bfloat16 (8.1e-3 of max|x| after the
# first, as flash's per-row error, 7.8e-3); the roundings of the 12 add up
# and 38 layers carry them (the kernel and plain walks' hidden states part
# by 8.1e-3 after layer 2, 2.2e-2 after layer 11, 3.8e-2 after layer 37: an
# NVIDIA H100 80GB HBM3 at 700 W), where qwen3-1.7b's 28 layers end at
# 2.0e-2; its logits part by 3.15e-2 (prefill) and 3.47e-2 (decode) of
# max|logits|, so 3e-2 would fail on the design's rounding alone
# phi-3-vision-4.2b in bfloat16: 5e-2.  bfloat16 alone moves its plain
# prefill logits 2.65e-2 of max|logits| from the same weights in float32,
# and the kernel-vs-plain prefill logits sit at that distance (2.68e-2): its
# 32 attention layers each add the kernel's rounding of P (the walks' hidden
# states part by 4.9e-3 after layer 1 and 2.6e-2 after layer 32, where
# qwen3-1.7b's 28 end at 2.0e-2).  The decode steps feed zero embeddings, so
# a step's first layer sees a zero input (its norm gives q = k = v = 0) and
# its logits come from the attention over the cache alone: 4.01e-2 of their
# own max, teacher-forced (an NVIDIA H100 80GB HBM3 at 700 W)
ARCH_LOGITS_RTOL = {("recurrentgemma-9b", torch.bfloat16): 5e-2,
                    ("phi-3-vision-4.2b", torch.bfloat16): 5e-2}
SPMV_KERNELS = ("ell_spmv", "ell_spmm", "bcsr_spmm")
# the block smoothers' kernels: port kernels with no Pallas counterpart
SMOOTHER_KERNELS = ("block_diag_apply", "tri_solve")
# the rows of the chain (each row needs the one before) whose µs a row is
# tri_solve's measured one-step floor on each route
TRI_CHAIN_ROWS = 8192
# the Pallas kernel each replaces (the sources: repro_torch.kernels.build);
# the smoothers' kernels replace the reference's dense minv @ r
REPLACES = {
    "ell_spmv": "src/repro/kernels/spmv/spmv.py:75",
    "ell_spmm": "src/repro/kernels/spmv/spmv.py:104",
    "bcsr_spmm": "src/repro/kernels/spmv/bcsr.py:65",
    "block_diag_apply": "src/repro/amg/dist_solve.py:557-569",
    "tri_solve": "src/repro/amg/dist_solve.py:557-569",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:86",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention/flash_attention.py:86",
}
# the block-smoother phase: the stationary hybrid_gs solve's cycle limit;
# a float32 run's history against its eager plain run (each operation
# rounds at 6e-8 of its size in another order on each side, and PCG
# carries that difference forward over its iterations)
STATIONARY_MAXITER = 100
F32_HIST_TOL = 1e-4
# the bfloat16 phase: PCG's tolerance, its x against the f64 x, and each
# kernel against its plain version (both sum in float32 and round once, in
# another order: an entry may differ by one bfloat16 ulp at a tie, and by
# the float32 round-off of its sum, BF16_ABS of Σ|a·x|)
BF16_TOL = 1e-5
BF16_X_BAR = 2.0**-5
BF16_WARM = 5
BF16_ABS = 2.0**-16
L2_FLUSH_BYTES = 256 << 20   # read between cold launches: 5x the 50 MB L2
COLD_SAMPLES = 25
BF16_SIDE_SAMPLES = 5         # bursts timing the plain and library calls off level-0 A_on
# the bfloat16 session tests' bar on |log(r_i / r_i^ref)| (twice the
# reference's own bf16-against-f32 gap): the process ranks' bf16 PCG against
# the stacked one, where they are not bit-equal
BF16_LOG_BAR = 0.6
# LM serving: qwen3-1.7b at full width, 8 requests, prompts of 512-2048
LM_ARCH, LM_REQUESTS, LM_BATCH, LM_NEW = "qwen3-1.7b", 8, 4, 32
LM_PROMPT = (512, 2048)
LM_BF16_REQUESTS = 4          # the bf16 run: the first prefill batch again
# the MoE phase: both MoE archs at full width, cut to 2 layers (a choice,
# enough for an MoE layer fed by another's output; memory does not force it:
# 2 layers peak near 16 GiB in bf16 and a layer's weights are 4.7 GiB, so
# one card would hold about 14), served in bf16 on the first 4 prompts; then one qwen3-moe layer's MoE expert
# parallel over the 2 x 4 stacked ranks (16 experts a rank) at 512 tokens a
# rank; EP against moe_ffn_tp where nothing drops: the tests' bars (float32
# rtol / atol, bfloat16 over max|y|)
MOE_ARCHS, MOE_LAYERS, MOE_REQUESTS = ("mixtral-8x22b",
                                       "qwen3-moe-235b-a22b"), 2, 4
EP_ARCH, EP_TOKENS = "qwen3-moe-235b-a22b", 512
EP_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the routing probe: the embedded tokens scaled from the random init's 0.02
# to unit scale, where the layers' input is no longer the attention's
EMBED_PROBE = 50.0
# the recurrent phase: both recurrent archs at full width and depth (no cut:
# recurrentgemma-9b's 10.4 B parameters are 20.8 GB in bf16), served on the
# first 4 prompts; xlstm-125m in f32 and bf16, recurrentgemma-9b in bf16
RECURRENT_RUNS = (("xlstm-125m", torch.float32), ("xlstm-125m", torch.bfloat16),
                  ("recurrentgemma-9b", torch.bfloat16))
RECURRENT_REQUESTS = 4
# one layer of each recurrent kind in the served type against the same code
# in float64, over max|y|: float32 at the port's 1e-5 bar; bfloat16 rounds
# every projection's output and the block's own (8-bit mantissa, 4e-3
# relative each), so 3e-2, as the LM tests' bfloat16 bar
LAYER_RTOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# the embedding-input phase: phi-3-vision-4.2b (32 heads of 96: the flash
# kernel's head-dim-96 instances) and musicgen-medium at full width and depth,
# in f32 and bf16, each fed the stub frontend's embeddings (standard normals
# from SEED) at the first 4 prompts' lengths; decode steps take zero
# embeddings, as the engine feeds them
EMBED_RUNS = tuple((arch, dt) for arch in ("phi-3-vision-4.2b", "musicgen-medium")
                   for dt in (torch.float32, torch.bfloat16))
EMBED_REQUESTS = 4
# the training phase: qwen3-1.7b in f32 at full width and depth: the
# launcher's defaults (batch 8, seq 256) for TRAIN_STEPS steps, then
# resume and microbatch checks from its checkpoint, TRAIN_TIMED steps
# (:func:`timed_steps`: one warm, the wall-clock median of the rest but the
# last, which is profiled), PERIODIC_STEPS on a token file of one
# PERIOD-token sequence repeated, and LONG_STEPS at seq LONG_SEQ with remat
# (chunked_attention past 1024); the step against float64 on the card at
# F64_LAYERS layers, at seq 256 and at LONG_SEQ with remat; xlstm-125m for
# XLSTM_STEPS steps (the recurrent blocks' backward)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_TIMED = "qwen3-1.7b", 3, 7
PERIOD, PERIODIC_STEPS = 64, 6
# the periodic file's loss must fall by this share of its first value over
# the steps, at seq 256 and at LONG_SEQ (on random tokens it stays near ln V:
# nothing to learn)
LOSS_FALL = 0.02
LONG_SEQ, LONG_BATCH, LONG_STEPS = 2048, 2, 3
F64_LAYERS = 2
XLSTM_ARCH, XLSTM_STEPS = "xlstm-125m", 4
# a resumed or re-split step against the live one: the same float32 step,
# apart from the order of the card's atomic adds (the embedding's backward
# scatters into its rows), so 1e-5 of the loss and the grad norm and 1e-4
# of each moment leaf's max
RESUME_RTOL, MOMENT_RTOL = 1e-5, 1e-4
# float32 against float64 at 2 layers, full width (TF32 off): the loss is a
# mean of log-sum-exps over 151,936 logits whose products sum 2048 terms in
# float32 (2^-24 each, growing as their square root), so 1e-5; the gradient
# norm and the moments go through the backward's longer chains, 1e-4 of the
# norm and of each leaf's max
F64_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "m": 1e-4, "v": 1e-4}
# the training-families phase: the MoE and hybrid-recurrent archs trained
# at full width in f32 (TF32 off) through make_step_fn at the launcher's
# batch 8 x seq 256, the moments donated (updated in place), each cut to
# the depth named here: the MoE archs' 1 layer is the most one card holds
# (2 layers' training state is 80.6 GiB for mixtral, 92.7 for qwen3-moe),
# recurrentgemma-9b's 5 are one (rglru, rglru, attn) group and two
# remainder layers.  :func:`train_fits` counts the state (16 B a
# parameter: f32 weights, gradients, m and v) and the phase refuses a
# depth whose state leaves less than TRAIN_HEADROOM_GIB of the card for
# activations and temporaries (CARD_GIB where no card is asked): on an
# H100 80GB the f32 steps peaked 4.2-7.9 GiB above their state, and the
# float64 checks, whose weights and gradients are the same 16 B a
# parameter, 13.2-15.7 GiB above it at 8 x 256.  FAMILY_TIMED steps on random tokens, timed as TRAIN_TIMED's;
# PERIODIC_STEPS on the periodic file, whose loss must fall by LOSS_FALL
FAMILY_RUNS = (("mixtral-8x22b", 1), ("qwen3-moe-235b-a22b", 1),
               ("recurrentgemma-9b", 5))
FAMILY_TIMED = 5
TRAIN_BYTES_PER_PARAM, TRAIN_HEADROOM_GIB, CARD_GIB = 16, 16.0, 79.6
# None of the reference's memory options (loss_chunk, remat, microbatches,
# to be taken in that order) is needed at 8 x 256: the steps peak at
# 47.5-60.3 GiB (the largest logits, recurrentgemma's 256,000-word
# vocabulary, are 1.95 GiB in f32).  The float64 checks stream the loss
# over FAMILY_F64_CHUNK positions a chunk on both sides (8 x 256 float64
# logits are 2.3 GiB for qwen3-moe, 3.9 for recurrentgemma)
FAMILY_F64_CHUNK = 64
# the step against float64 (F64_RTOL, the routes of the float64 run forced
# to the float32 run's): the MoE archs at their 1 layer, recurrentgemma-9b
# at 3, its smallest depth with both block kinds
FAMILY_F64_LAYERS = {"mixtral-8x22b": 1, "qwen3-moe-235b-a22b": 1,
                     "recurrentgemma-9b": 3}
# recurrentgemma-9b at batch 1 x seq 4096 with remat: its local window of
# 2048 binds (chunked_attention's windowed backward) and RG-LRU's scan takes
# 12 doubling passes; the loss streamed over 512-position chunks (4096 f32
# logits are 3.9 GiB); then 3 layers of it against float64 without remat
LONG_FAMILY_ARCH, LONG_FAMILY_SEQ, LONG_FAMILY_CHUNK = "recurrentgemma-9b", 4096, 512
# one seq-LONG_SEQ step carried on from the periodic run's state with
# chunked_attention and remat against the same step with the plain
# attention: the two sum each softmax in another order (online over two
# key chunks, or in one pass), so float32 roundings apart: 1e-5 of the loss,
# 1e-4 of the grad norm and of each moment leaf's max; the next batch's loss
# after the update at 1e-4 (each element moves by at most about lr along
# m / sqrt(v), so rounding-level gradients move only the elements whose
# moments are at rounding level)
CARRIED_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "m": 1e-4, "v": 1e-4,
                "next_loss": 1e-4}
# hier_grad_sync over one qwen3-1.7b layer's gradient tree on the 2 x 4 ranks
# (stacked, then 8 gloo processes on this card), per-rank gradients of small
# integers over 2^10 (every sum exact in any order: the two forms bit-equal);
# flat against nap3 at 1e-6 of max|mean|, int8 at 3e-2 (a code is one step
# of 1/127 of its piece's max, summed over the pods)
GRAD_SYNC_REPS = 5            # stacked: bursts timed; gloo: calls a run
GRAD_SYNC_GLOO_REPS = 2
GRAD_SYNC_DEADLINE = 300.0
GRAD_SYNC_TOL = {"nap3": 1e-6, "int8": 3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, samples: int = SAMPLES) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``, medians over ``samples``
    bursts of BURST calls (after a warm-up).  Each burst is queued behind a
    GPU spin, so the CUDA events around it time the calls back to back on
    the card rather than the host's enqueue rate; the host clock around the
    enqueue loop gives what one call costs the host."""
    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(BURST):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / BURST)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / BURST)
    return float(np.median(dev)), float(np.median(host))


def time_cold_ms(fn, samples: int = COLD_SAMPLES) -> float:
    """Device ms of one call of ``fn()`` that finds the L2 cold: the median
    over ``samples`` calls, each alone between CUDA events behind a read
    of L2_FLUSH_BYTES (a read, so that the L2 holds no dirty lines for the
    call to write back; it keeps the card busy while the call is
    queued)."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    del flush
    return float(np.median(ts))


def ell_to_csr(cols: torch.Tensor, vals: torch.Tensor, m: int) -> torch.Tensor:
    """The rank-stacked ELL operator as one block-diagonal CSR tensor
    ``[D·n, D·m]`` (stored entries only), for ``torch.sparse.mm``."""
    D, n, _ = cols.shape
    keep = cols >= 0
    rows = torch.arange(D * n, device=cols.device).reshape(D, n, 1).expand_as(cols)
    offs = (torch.arange(D, device=cols.device) * m).reshape(D, 1, 1)
    idx = torch.stack([rows[keep], (cols.long() + offs)[keep]])
    return torch.sparse_coo_tensor(idx, vals[keep], (D * n, D * m)).coalesce() \
        .to_sparse_csr()


def bcsr_to_csr(bcols: torch.Tensor, bvals: torch.Tensor, m: int,
                rows: int) -> torch.Tensor:
    """The first ``rows`` rows of each rank's block-ELL operator as one
    block-diagonal CSR tensor ``[D·rows, D·m]`` holding the blocks' nonzero
    entries."""
    D, mb, Kb, bs, _ = bvals.shape
    dev = bcols.device
    r = (torch.arange(mb, device=dev).reshape(1, mb, 1, 1, 1) * bs
         + torch.arange(bs, device=dev).reshape(1, 1, 1, bs, 1))
    c = (bcols.long().reshape(D, mb, Kb, 1, 1) * bs
         + torch.arange(bs, device=dev).reshape(1, 1, 1, 1, bs))
    d = torch.arange(D, device=dev).reshape(D, 1, 1, 1, 1)
    shape = (D, mb, Kb, bs, bs)
    keep = ((bcols >= 0).reshape(D, mb, Kb, 1, 1).expand(shape)
            & (bvals != 0) & (c < m) & (r < rows))
    ri = (d * rows + r).expand(shape)[keep]
    ci = (d * m + c).expand(shape)[keep]
    return torch.sparse_coo_tensor(torch.stack([ri, ci]), bvals[keep],
                                   (D * rows, D * m)).coalesce().to_sparse_csr()


def kernel_case(name, fn, plain, library, args, nbytes, flops, rtol=None,
                library_name="torch.sparse.mm", rel_err=None, peak=None,
                plain_samples=SAMPLES, timed=None, library_samples=SAMPLES):
    """Run one kernel against its plain version; time all three (the
    library call only where ``library`` is given; the plain version over
    ``plain_samples`` bursts, the library call over ``library_samples``;
    ``timed``: a row of the same inputs whose plain and library times to
    reuse).  The error is max|kernel - plain| over
    max|plain|, or ``rel_err(kernel, plain)`` where given; the flop bound is
    taken at ``peak`` FLOP/s, by default the card's highest dense rate for
    the type."""
    y = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err = float((y.double() - ref.double()).abs().max())
    rel = (rel_err(y, ref) if rel_err else
           err / (float(ref.double().abs().max()) or 1.0))
    dtype = ref.dtype
    rtol = RTOL[dtype] if rtol is None else rtol
    check(rel <= rtol, f"{name} {dtype}: kernel - plain is {rel:.3e} of "
          f"plain, above {rtol:g} (max |kernel - plain| = {err:.3e})")
    peak = PEAK_FLOPS[dtype] if peak is None else peak
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / peak)
    ms, host_ms = time_ms(lambda: fn(*args))
    row = {"dtype": str(dtype).replace("torch.", ""),
           "shape": [list(a.shape) for a in args],
           "max_abs_err": err, "rel_err": rel,
           "ms": ms, "host_ms": host_ms,
           "plain_ms": (timed["plain_ms"] if timed else
                        time_ms(lambda: plain(*args), plain_samples)[0]),
           "library_ms": (timed["library_ms"] if timed else None
                          if library is None else time_ms(library, library_samples)[0]),
           "bound_ms": bound_s * 1e3,
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / peak else "operations")}
    log(f"  {name:9s} {row['dtype']:7s} {row['shape']}: err {err:.2e} "
        f"(rel {rel:.1e}) kernel {row['ms']:.4f} ms (host "
        f"{host_ms:.4f} ms/call), plain "
        + ("not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.4f} ms")
        + f", {library_name} "
        + ("none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
        + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def ell_operands(dh) -> dict[str, tuple]:
    """Every ELL operand of the lowered hierarchy, by name ("L0 A_on"):
    (cols, vals, length of the x it reads)."""
    out = {}
    for l, (dl, a) in enumerate(zip(dh.levels, dh._arrs)):
        for op_name in ("A", "P", "R"):
            op = getattr(dl, op_name)
            if op is None:
                continue
            arrs = a[op_name]
            out[f"L{l} {op_name}_on"] = (arrs["on_cols"], arrs["on_vals"],
                                         op.plan.local_n)
            out[f"L{l} {op_name}_off"] = (arrs["off_cols"], arrs["off_vals"],
                                          op.plan.halo_len)
    return out


def operand_launches(bound, b, kernel: str = "ell_spmv") -> tuple[dict[str, int], int]:
    """``kernel`` (``ell_spmv``, or ``ell_spmm`` for ``b`` ``[n, k]``)
    launches of one solve of ``b`` by operand (the column-id tensor each
    launch reads), from a counted solve of its own, and its iteration count.

    The solve runs as captured CUDA graphs, which make no Python call when
    replayed: its programs of ``b``'s width are captured afresh in this
    solve, each launch a capture records is tallied by operand under that
    capture's tally, and each graph's tally counts once per replay.  The
    tally must add up to the launch counter, every launch on a named
    operand."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.spmv import ops

    dh = bound.dist_hierarchy
    wrapper = launch_counters()[kernel]
    names = {cols.data_ptr(): name for name, (cols, _, _)
             in ell_operands(dh).items()}
    # id(recording tally) -> (the tally, kept alive so no id is reused;
    # launches by operand)
    by_tally: dict[int, tuple] = {}
    real = getattr(ops, kernel)

    def recorded(cols, vals, x):
        tally = launches.recording_tally()
        before = None if tally is None else tally[wrapper]
        y = real(cols, vals, x)
        if tally is not None and tally[wrapper] > before:
            seen = by_tally.setdefault(id(tally),
                                       (tally, collections.Counter()))[1]
            seen[names.get(cols.data_ptr(), "other")] += 1
        return y

    width = None if b.ndim == 1 else b.shape[1]
    dh.programs.drop(lambda key: key.k == width)
    setattr(ops, kernel, recorded)
    try:
        res, counts = counted(lambda: bound.pcg(b))
    finally:
        setattr(ops, kernel, real)
    seen = collections.Counter()
    for prog in dh.programs.values():
        for name, n in by_tally.get(id(prog.launches), (None, {}))[1].items():
            seen[name] += n * prog.replays
    per_solve = {k: v for k, v in seen.items() if v}
    check("other" not in per_solve,
          f"{per_solve.get('other')} {kernel} launches on no named operand")
    check(sum(per_solve.values()) == counts[kernel],
          f"{kernel} launches by operand add up to {sum(per_solve.values())}, "
          f"the counter says {counts[kernel]}")
    return per_solve, res.iterations


def ell_case(label, cols, vals, m, rng, launches=None, k=None, cold=False):
    """``ell_spmv`` (``k`` None) or ``ell_spmm`` with ``k`` right-hand sides
    at one operand, with ``torch.sparse.mm`` on its CSR.  bfloat16: at the
    card bar (:func:`bf16_bar`), the design the launch's shape rule takes
    (``bf16_order.bulk``) recorded, the plain and library calls timed over
    BF16_SIDE_SAMPLES bursts off level 0's A_on; ``cold``: also the
    kernel's time with the L2 flushed before each call."""
    from repro_torch.kernels.spmv import bf16_order, ref
    from repro_torch.kernels.spmv import spmv as ks

    dev, dt = vals.device, vals.dtype
    s = torch.finfo(dt).bits // 8
    D, n, K = cols.shape
    nnz = int((cols >= 0).sum())
    x = torch.as_tensor(rng.standard_normal((D, m) + ((k,) if k else ())),
                        dtype=dt, device=dev)
    csr = ell_to_csr(cols, vals, m)
    xf = x.reshape(D * m, -1)
    kk = k or 1
    name = "ell_spmm" if k else "ell_spmv"
    fn, plain, args = getattr(ks, name), getattr(ref, f"{name}_ref"), (cols, vals, x)
    extra, library, err = {}, (lambda: torch.sparse.mm(csr, xf)), None
    if dt == torch.bfloat16:
        library, err = bf16_library(csr, xf)
        side = SAMPLES if label == "L0 A_on" else BF16_SIDE_SAMPLES
        # float32 products and sums: the FMA rate bounds the operations
        extra = dict(rtol=1.0, rel_err=bf16_rel(plain, args),
                     peak=PEAK_FLOPS[torch.float32], plain_samples=side,
                     library_samples=side)
    # bytes: every slot's column id, the values of stored entries only
    # (the float32 / float64 kernels never load a padded slot's value), x
    # and y once
    row = kernel_case(f"{name} {label}" + (f" k{k}" if k else ""), fn, plain,
                      library, args,
                      D * n * K * 4 + nnz * s + D * (m + n) * kk * s, 2 * nnz * kk,
                      **extra)
    row.update(k=kk, operand=label, main_path=label == "L0 A_on",
               fill=nnz / max(D * n * K, 1), launches_per_solve=launches)
    if dt == torch.bfloat16:
        row.update(library_error=err,
                   design="bulk" if bf16_order.bulk(name, D * n, K) else "flat",
                   col_id_share=D * n * K * 4 / (D * n * K * 4 + nnz * 2
                                                 + D * (m + n) * kk * 2))
    if cold:
        row["cold_ms"] = time_cold_ms(lambda: fn(*args))
        log(f"    L2 flushed before each call: {row['cold_ms']:.4f} ms")
    return row


def ell_sums(rows: list, solve: str, kname: str) -> dict:
    """Over one solve's operands (the rows with launches): the sums of
    launches x (ms - bound ms) and of launches x ms."""
    shapes = [r for r in rows if r["launches_per_solve"]]
    sums = {"excess_ms_per_solve": sum(r["launches_per_solve"] * (r["ms"] - r["bound_ms"])
                                       for r in shapes),
            "launch_ms_per_solve": sum(r["launches_per_solve"] * r["ms"] for r in shapes),
            "launches_per_solve": sum(r["launches_per_solve"] for r in shapes),
            "operands": len(shapes)}
    log(f"  {kname} over the {solve} solve's {sums['operands']} operands, "
        f"{sums['launches_per_solve']} launches per solve: sum of launches x "
        f"(ms - bound ms) = {sums['excess_ms_per_solve']:.4f} ms, of launches x ms "
        f"= {sums['launch_ms_per_solve']:.4f} ms per solve")
    return sums


def kernel_phase(dh64, dh32, per_solve: dict[str, dict[str, int]]) -> tuple[dict, dict]:
    """Every kernel at the main path's shapes, f32 and f64; ``ell_spmv`` and
    ``ell_spmm`` in f64 at every operand the f64 single-RHS and k = K_RHS
    solves launch (``per_solve``, by kernel).  Returns the rows by kernel
    and, for those two, the sums over one solve of launches × (ms − bound
    ms) and of launches × ms."""
    from repro_torch.kernels.spmv import bcsr as kb
    from repro_torch.kernels.spmv import ref

    rng = np.random.default_rng(SEED)
    out: dict[str, list] = {n: [] for n in SPMV_KERNELS}
    for dh in (dh64, dh32):
        dev, dt = dh.device, dh.dtype
        s = torch.finfo(dt).bits // 8
        # level 0's on-process ELL block: what every level-0 apply launches
        # (the first row, the kernels line's top-level number), then in f64
        # every other ELL operand the solve launches
        f64 = dt == torch.float64
        for name, (cols, vals, m) in ell_operands(dh).items():
            for kname, k in (("ell_spmv", None), ("ell_spmm", K_RHS)):
                launches = per_solve[kname].get(name) if f64 else None
                if name == "L0 A_on" or launches:
                    out[kname].append(ell_case(name, cols, vals, m, rng,
                                               launches, k))
        # the BCSR levels' on-process blocks, lowered at both block sizes;
        # x unpadded, the product cut to the true rows, as an apply asks
        for l, dl in enumerate(dh.levels):
            if dl.A.local_kernel != "bcsr":
                continue
            for bs in kb.BLOCK_SIZES:
                op = copy.copy(dl.A)
                op.lower_bcsr(bs)
                bcols = torch.as_tensor(op.bcsr_on_bcols, device=dev)
                bvals = torch.as_tensor(op.bcsr_on_bvals, dtype=dt, device=dev)
                D, mb, Kb = bcols.shape
                ml, rows = op.plan.local_n, op.rows_local
                nblk = int((bcols >= 0).sum())     # stored blocks
                bnnz = int((bvals != 0).sum())
                bcsr = bcsr_to_csr(bcols, bvals, ml, rows)
                for k in (1, K_RHS):
                    xb = torch.as_tensor(rng.standard_normal((D, ml, k)),
                                         dtype=dt, device=dev)
                    xbf = xb.reshape(-1, k)
                    row = kernel_case(
                        f"bcsr_spmm L{l} bs{bs} k{k}",
                        lambda a, v, x, r=rows: kb.bcsr_spmm(a, v, x, rows=r),
                        lambda a, v, x, r=rows: ref.bcsr_apply_ref(a, v, x, r),
                        lambda: torch.sparse.mm(bcsr, xbf), (bcols, bvals, xb),
                        # every block id; stored blocks only (the kernel
                        # skips padded slots); x and the true rows of y once
                        D * mb * Kb * 4 + nblk * bs * bs * s
                        + D * (ml + rows) * k * s,
                        2 * nblk * bs * bs * k)
                    row.update(level=l, bs=bs, k=k, rows=rows,
                               main_path=bs == dl.A.block_size, stored_nnz=bnnz)
                    out["bcsr_spmm"].append(row)
    check(out["bcsr_spmm"], "no level of the main path lowered to BCSR")
    sums = {kname: ell_sums(out[kname], solve, kname)            # f64 rows
            for kname, solve in (("ell_spmv", "f64"), ("ell_spmm", f"f64 k = {K_RHS}"))}
    return out, sums


def bcsr_apply_kernels(dh, reps: int) -> dict[int, dict[str, int]]:
    """``reps`` BCSR applies (the on-process product) of each BCSR level,
    profiled alone: the device kernels they ran, by name, by level."""
    found = {}
    for l, (dl, a) in enumerate(zip(dh.levels, dh._arrs)):
        if dl.A.local_kernel != "bcsr":
            continue
        x = torch.ones((dl.A.n_devices, dl.A.plan.local_n), dtype=dh.dtype,
                       device=dh.device)

        def applies(op=dl.A, arrs=a["A"], x=x):
            for _ in range(reps):
                op._on_product(arrs, x, True)

        found[l] = {name: count for name, (_, count) in device_profile(applies).items()}
    return found


def tri_to_csr(f, dtype=None) -> torch.Tensor:
    """A triangle factor (strict part in ELL, diagonal apart) as one
    block-diagonal CSR tensor ``[D·m, D·m]`` over the ranks, diagonal
    included, for ``torch.triangular_solve`` (values in ``dtype`` where
    given)."""
    D, m, K = f.cols.shape
    dev = f.cols.device
    keep = f.cols >= 0
    rows = torch.arange(D * m, device=dev).reshape(D, m, 1).expand(D, m, K)
    offs = (torch.arange(D, device=dev) * m).reshape(D, 1, 1)
    diag_idx = torch.arange(D * m, device=dev)
    ri = torch.cat([rows[keep], diag_idx])
    ci = torch.cat([(f.cols.long() + offs)[keep], diag_idx])
    vals = torch.cat([f.vals[keep], f.diag.reshape(-1)]).to(dtype or f.vals.dtype)
    return torch.sparse_coo_tensor(torch.stack([ri, ci]), vals,
                                   (D * m, D * m)).coalesce().to_sparse_csr()


def tri_library(f, r):
    """``torch.triangular_solve`` (cuSPARSE) on the factor as a sparse CSR
    operand, or ``(None, reason)`` where this install has none.  cuSPARSE
    has no bfloat16 solve: a bfloat16 factor and r go float32-widened (the
    same float32 z, up to the rounding of y)."""
    D, m = r.shape[:2]
    wide = torch.float32 if r.dtype == torch.bfloat16 else None
    try:
        csr = tri_to_csr(f, wide)
        rf = r.reshape(D * m, -1).to(wide or r.dtype).contiguous()
        call = lambda: torch.triangular_solve(rf, csr, upper=f.upper)  # noqa: E731
        call()
        torch.cuda.synchronize()
        return call, ("torch.triangular_solve (sparse CSR"
                      + (", float32-widened)" if wide else ")"))
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"none on this install ({type(e).__name__}: {str(e)[:80]})"


def tri_chain(D: int, m: int, dtype, dev):
    """A pure chain on every rank (row i needs row i - 1: depth m), as a
    lower-triangle factor: the measured one-step floor's operand."""
    from repro_torch.kernels.smoother.ops import TriFactor

    cols = np.arange(-1, m - 1, dtype=np.int32).reshape(1, m, 1).repeat(D, 0)
    rng = np.random.default_rng(SEED + 2)
    return TriFactor.place({"cols": cols, "upper": False,
                            "vals": rng.standard_normal((D, m, 1)) * 0.5,
                            "diag": 1.0 + rng.random((D, m))}, dev, dtype)


def another_order(f, route: str) -> tuple:
    """Another valid row order for the route: each rank's rows in plain row
    order (descending for the upper triangle) on the L2 route, which reads
    no level sets; on the block and staged routes each level set's rows
    reversed (the staged route's slab then built for it by the wrapper)."""
    D, m = f.diag.shape
    if route == "l2":
        rows = torch.arange(m, dtype=torch.int32, device=f.diag.device)
        return (rows.flip(0) if f.upper else rows).expand(D, m).contiguous(), f.starts
    order, starts = f.order.cpu().numpy().copy(), f.starts.cpu().numpy()
    for d in range(D):
        for lo, hi in zip(starts[d, :-1], starts[d, 1:]):
            order[d, lo:hi] = order[d, lo:hi][::-1]
    return torch.as_tensor(order, device=f.diag.device), f.starts


def tri_bytes(route: str, nnz: int, D: int, m: int, k: int, s: int) -> int:
    """The bytes a ``tri_solve`` launch must move on ``route``: the stored
    entries (an int32 column id and a value of ``s`` bytes each; on the
    staged route one 32-bit slab word, a 16-bit column and the bfloat16
    value), the diagonal, r and x read once, y written once."""
    entry = 4 if route == "staged" else 4 + s
    return nnz * entry + D * m * s + 3 * D * m * k * s


def tri_cases(label, f, k, dt, rng, sched, extra, timed=None,
              plain_samples: int = 3) -> list[dict]:
    """``tri_solve`` on factor ``f`` with ``k`` right-hand sides on the
    route the rule takes and on every other route that can take the case
    (``smoother.tri_routes``: the block route where the rank fits a block's
    shared memory; the staged route for bfloat16 at k = 1 where z, the
    starts and its smallest ring fit one, reading the factor's slab); each
    against the plain version at RTOL, repeated, in another valid order
    (``another_order``) and across routes bit for bit; µs a dependent step
    (kernel ms over the DAG's depth).  The plain version (over
    ``plain_samples`` bursts) and cuSPARSE are timed once (``timed``: their
    times given, none taken).  bfloat16 is
    held to the bfloat16 bar (``bf16_bar``, Σ|·| from ``tri_solve_absum``),
    each row saying whether it equals the plain version bit for bit and, at
    k = 1 off the chain, the emulation of its order of sums
    (``smoother/bf16_order.py``); a rank fits a block by its float32 z."""
    from repro_torch.kernels.smoother import ref as sref
    from repro_torch.kernels.smoother import smoother as ks
    from repro_torch.kernels.smoother.bf16_order import tri_solve_emulate

    dev = f.cols.device
    D, m, K = f.cols.shape
    s = dt.itemsize
    nnz = int((f.cols >= 0).sum())
    shape = (D, m) + ((k,) if k > 1 else ())
    r, x = (torch.as_tensor(rng.standard_normal(shape), dtype=dt, device=dev)
            for _ in range(2))
    library, lib_name = tri_library(f, r)
    smem = ks.tri_smem(dev)
    depth = len(sched)
    rule = ks.tri_plan(m, f.depth(), k, dt, smem, K=K)
    routes = [rule] + [o for o in ks.tri_routes(m, f.depth(), k, dt, smem, K=K)
                       if o != rule]
    # the factor's slab where the rule gave it one, else one for a forced
    # staged route, built once before the timing
    slab = f.slab or (ks.TriSlab(f.cols, f.vals, f.diag, f.order)
                      if "staged" in routes else None)
    bf16 = dt == torch.bfloat16
    bar = dict(rtol=1.0, peak=PEAK_FLOPS[torch.float32], rel_err=bf16_bar(
        sref.tri_solve_absum(f.cols, f.vals, f.diag, r, x, 1.0, sched))) \
        if bf16 else {}
    plain_y = sref.tri_solve_ref(f.cols, f.vals, f.diag, r, x, 1.0, sched) \
        if bf16 else None
    emulated = tri_solve_emulate(f.cols, f.vals, f.diag, r, x, 1.0, sched) \
        if bf16 and k == 1 and label != "chain" else None
    rows, outs = [], []
    for name in routes:
        route = None if name == rule else name

        def fn(c, v, d, r, x, route=route):
            return ks.tri_solve(c, v, d, r, x, 1.0, upper=f.upper,
                                order=(f.order, f.starts), route=route,
                                slab=slab)

        row = kernel_case(
            f"tri_solve {label} k{k} {name}", fn,
            lambda c, v, d, r, x: sref.tri_solve_ref(c, v, d, r, x, 1.0, sched),
            library, (f.cols, f.vals, f.diag, r, x),
            tri_bytes(name, nnz, D, m, k, s),
            2 * (nnz + D * m) * k, library_name=lib_name,
            plain_samples=plain_samples, timed=timed, **bar)
        timed = row
        args = (f.cols, f.vals, f.diag, r, x)
        y = fn(*args)
        if bf16:
            row["bit_equal_plain"] = bool(torch.equal(y, plain_y))
        if emulated is not None:
            row["bit_equal_emulation"] = bool(torch.equal(y, emulated))
        other = ks.tri_solve(*args, 1.0, upper=f.upper,
                             order=another_order(f, name), route=name)
        check(torch.equal(y, fn(*args)) and torch.equal(y, other),
              f"tri_solve {label} k{k} {name}: not bit-equal run to run or in "
              f"another order")
        outs.append(y)
        row.update(k=k, depth=depth, route=name,
                   us_per_step=row["ms"] * 1e3 / max(depth, 1),
                   library=lib_name, main_path_route=route is None, **extra)
        rows.append(row)
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          f"tri_solve {label} k{k}: the routes' results differ")
    log(f"    {label} k{k}: depth {depth}, " + ", ".join(
        f"{w['route']} {w['us_per_step']:.3f} us a step" for w in rows))
    return rows


def smoother_kernel_phase(dh64, dh32) -> tuple[dict, dict]:
    """``block_diag_apply`` (bs 4, the main path's) and ``tri_solve`` (both
    triangles, on both routes where a rank fits a block) at every
    non-coarsest level, k = 1 and K_RHS, in f64 and f32, on the lowered
    hierarchy's own factors, against their plain versions; each timed beside
    its plain version, the library call where this install has one (batched
    ``torch.matmul`` over the blocks; ``torch.triangular_solve`` on a sparse
    CSR operand, cuSPARSE) and the bytes bound; then a pure chain of
    TRI_CHAIN_ROWS rows on each route (f64, k = 1), whose µs a row is the
    measured one-step floor, and each ``tri_solve`` row's second bound,
    depth × its route's floor.  Returns the rows by kernel and a summary:
    each triangle's DAG depth by level ("L0 gs": levels), the floors and the
    route by level."""
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.kernels.smoother import ref as sref
    from repro_torch.kernels.smoother import smoother as ks
    from repro_torch.kernels.spmv.ref import block_x

    omega = SolveOptions().omega
    bs = SolveOptions().block_size
    rng = np.random.default_rng(SEED + 1)
    out: dict[str, list] = {n: [] for n in SMOOTHER_KERNELS}
    depth: dict[str, int] = {}
    for dh in (dh64, dh32):
        dev, dt = dh.device, dh.dtype
        s = torch.finfo(dt).bits // 8
        for l, dl in enumerate(dh.levels):
            if dl.coarse_inv is not None:
                continue
            m = dl.A.rows_local
            bj = dh._factor(l, "bj", bs)
            D, nb = bj.binv.shape[:2]
            for k in (1, K_RHS):
                shape = (D, m) + ((k,) if k > 1 else ())
                r, x = (torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                                        device=dev) for _ in range(2))
                rb = block_x(r, bs)
                row = kernel_case(
                    f"block_diag_apply L{l} bs{bs} k{k}",
                    lambda B, r, x: ks.block_diag_apply(B, r, x, omega),
                    lambda B, r, x: sref.block_diag_apply_ref(B, r, x, omega),
                    lambda B=bj.binv, rb=rb: torch.matmul(B, rb), (bj.binv, r, x),
                    # the blocks, r and x read once, y written once
                    (D * nb * bs * bs + 3 * D * m * k) * s, 2 * bs * D * m * k,
                    library_name="torch.matmul (batched)")
                row.update(level=l, bs=bs, k=k, main_path=l == 0)
                out["block_diag_apply"].append(row)
            for kind in ("gs", "gsu"):
                f = dh._factor(l, kind, 0)
                sched = f.schedule()
                depth[f"L{l} {kind}"] = len(sched)
                label = f"L{l} {'upper' if f.upper else 'lower'}"
                for k in (1, K_RHS):
                    for row in tri_cases(label, f, k, dt, rng, sched,
                                         {"level": l, "triangle": kind}):
                        row["main_path"] = (l == 0 and kind == "gs"
                                            and row["main_path_route"])
                        out["tri_solve"].append(row)
    log(f"  tri_solve DAG depth (level sets) by level and triangle: {depth}")
    # the one-step floor: a chain on each route
    m0 = TRI_CHAIN_ROWS
    chain = tri_chain(dh64.n_pods * dh64.lanes, m0, torch.float64, dh64.device)
    floors = {}
    # (the plain version takes a step a row: not timed)
    for row in tri_cases("chain", chain, 1, torch.float64, rng, chain.schedule(),
                         {"level": None, "triangle": "chain"},
                         {"plain_ms": None, "library_ms": None}):
        row["main_path"] = False
        floors[row["route"]] = row["us_per_step"]
        out["tri_solve"].append(row)
    for row in out["tri_solve"]:
        row["step_bound_ms"] = row["depth"] * floors[row["route"]] / 1e3
    routes = {f"L{r['level']} {r['dtype']} k{r['k']}": r["route"]
              for r in out["tri_solve"] if r["main_path_route"]
              and r["triangle"] == "gs"}
    log(f"  tri_solve one-step floor (a {m0}-row chain, f64): " + ", ".join(
        f"{k} {v:.3f} us" for k, v in floors.items()) + f"; routes taken: {routes}")
    return out, {"depth": depth, "step_floor_us": floors, "route_by_level": routes}


def eager_history(dh, rhs, opts, method: str, iters: int) -> list:
    """The history of ``iters`` iterations of ``method`` ("pcg" or "solve")
    through the eager program bodies with every local product on its plain
    version (``use_kernel`` off): a float per iteration, or a ``[k]`` array
    for ``rhs`` ``[n, k]``."""
    from repro_torch.amg.dist_solve import _host

    m = "" if rhs.ndim == 1 else "_m"
    saved, dh.use_kernel = dh.use_kernel, False
    try:
        with dh.lock:
            x = dh.scatter(np.zeros_like(rhs))
            b = dh.scatter(rhs)
            if method == "pcg":
                r, p, rz, rn = getattr(dh, "pcg_init" + m)(x, b, opts)
                hist = [_host(rn)]
                for _ in range(iters):
                    x, r, p, rz, rn = getattr(dh, "pcg_step" + m)(x, r, p, rz, opts)
                    hist.append(_host(rn))
            else:
                hist = [_host(getattr(dh, "resid_norm" + m)(x, b, opts))]
                for _ in range(iters):
                    x, rn = getattr(dh, "cycle" + m)(x, b, opts)
                    hist.append(_host(rn))
    finally:
        dh.use_kernel = saved
    return hist


def dense_factor_bytes(dh, keys) -> int:
    """Bytes the reference's dense ``[D, m, m]`` factors would take for the
    factor keys ``keys`` ((kind, block size)) on every non-coarsest level."""
    per = sum(dh.n_pods * dh.lanes * dl.A.rows_local ** 2
              for dl in dh.levels if dl.coarse_inv is None)
    return per * len(keys) * (torch.finfo(dh.dtype).bits // 8)


def block_smoother_phase(cfg64, A, b, B, dh64, dh32, xs: dict) -> dict:
    """The block smoothers on the main path's problem through the captured
    graphs, each session sharing the f64 (or f32) lowering: PCG to 1e-8
    with ``block_jacobi`` and with ``hybrid_gs_sym``, the stationary solve
    with ``hybrid_gs`` to 1e-8 (at most STATIONARY_MAXITER cycles), PCG on
    ``[n, K_RHS]`` with ``hybrid_gs_sym`` (each column against its
    single-RHS run), and PCG in f32 to 1e-5 with ``hybrid_gs_sym``.  Each
    run's launches (counters set to 0 just before, read just after), its
    history against the same session run eagerly through the plain
    versions, its true residual in numpy, ms an iteration warm, the warm
    solve's device time by kernel and busy share, one ``cudaGraphLaunch``
    a program call, and the factors' bytes beside the reference's dense
    factors'.  ``xs`` receives each f64 PCG's x by smoother (``[n, K_RHS]``
    under ``(smoother, K_RHS)``), the bfloat16 block phase's reference."""
    from repro_torch.amg import AMGSolver
    from repro_torch.amg.solve import SolveOptions

    cfg32 = dataclasses.replace(cfg64, dtype="float32", tol=1e-5)
    runs = [("block_jacobi", "pcg", b, cfg64, dh64),
            ("hybrid_gs_sym", "pcg", b, cfg64, dh64),
            ("hybrid_gs", "solve", b, cfg64, dh64),
            ("hybrid_gs_sym", "pcg", B, cfg64, dh64),
            ("hybrid_gs_sym", "pcg", b, cfg32, dh32)]
    out = {"runs": [], "launches": collections.Counter()}
    single = {}
    for smoother, method, rhs, cfg, dh in runs:
        opts = SolveOptions(smoother=smoother)
        bound = AMGSolver(dataclasses.replace(cfg, opts=opts)).setup(A)
        check(bound.dist_hierarchy is dh,
              f"the {smoother} session does not share the {cfg.dtype} lowering")
        kw = {"maxiter": STATIONARY_MAXITER} if method == "solve" else {}
        f64 = cfg.dtype == "float64"
        label = (f"{method} {cfg.dtype} {smoother}"
                 + (f" [n, {rhs.shape[1]}]" if rhs.ndim == 2 else ""))
        res, counts = counted(lambda: getattr(bound, method)(rhs, **kw))
        check(res.converged, f"{label} did not converge in {res.iterations}")
        out["launches"].update({k: v for k, v in counts.items()
                                if k in SMOOTHER_KERNELS})
        want = "block_diag_apply" if smoother == "block_jacobi" else "tri_solve"
        check(counts[want] > 0, f"{label} never launched {want}")
        steps = res.iterations
        hist = eager_history(dh, rhs, opts, method, steps)
        if rhs.ndim == 1:
            hd = history_diff(hist, res.residuals)
            X = res.x[:, None]
        else:
            hd = max(history_diff([h[j] for h in hist], c.residuals)
                     for j, c in enumerate(res.columns))
            X = res.x
        tol_h = HIST_TOL if f64 else F32_HIST_TOL
        check(hd <= tol_h, f"{label}: graphs vs eager plain history {hd:.2e} "
              f"of r0 (bar {tol_h:g})")
        R = rhs.reshape(len(rhs), -1)
        true_rel = max(float(np.linalg.norm(R[:, j] - A.matvec(X[:, j]))
                             / np.linalg.norm(R[:, j])) for j in range(R.shape[1]))
        check(true_rel < (1e-7 if f64 else 1e-4),
              f"{label}: true residual {true_rel:.2e}")
        cols = None
        if rhs.ndim == 2:
            ref = single.get((smoother, method))
            cols = 0.0
            for j, c in enumerate(res.columns):
                rj = ref if j == 0 and ref is not None else getattr(bound, method)(rhs[:, j])
                check(abs(rj.iterations - c.iterations) <= 1,
                      f"{label} column {j}: {c.iterations} vs {rj.iterations}")
                cols = max(cols, history_diff(rj.residuals, c.residuals),
                           float(np.abs(c.x - rj.x).max() / np.abs(rj.x).max()))
            check(cols <= HIST_TOL, f"{label}: columns vs single runs {cols:.2e}")
        elif f64:
            single[(smoother, method)] = res
        if f64 and method == "pcg":
            xs[smoother if rhs.ndim == 1 else (smoother, rhs.shape[1])] = res.x
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = getattr(bound, method)(rhs, **kw)
        wall = time.perf_counter() - t0
        ms_iter = wall * 1e3 / max(warm.iterations, 1)
        runtime: dict[str, int] = {}
        prof = device_profile(lambda: getattr(bound, method)(rhs, **kw), runtime)
        check(runtime.get("cudaGraphLaunch", 0) == warm.iterations + 1,
              f"{label}: {runtime.get('cudaGraphLaunch', 0)} cudaGraphLaunch "
              f"calls for {warm.iterations + 1} program calls")
        dev_ms = sum(v[0] for v in prof.values())
        busy = dev_ms / (wall * 1e3) if prof else None
        top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:6]
        row = {"run": label, "iterations": res.iterations,
               "history_vs_eager_plain": hd, "true_residual": true_rel,
               "columns_vs_single": cols, "ms_per_iteration": ms_iter,
               "device_ms": dev_ms if prof else None, "busy_share": busy,
               "graph_launches": runtime.get("cudaGraphLaunch", 0),
               "launches": {k: counts[k] for k in SMOOTHER_KERNELS + SPMV_KERNELS},
               "top_device": [[n[:80], ms, c] for n, (ms, c) in top]}
        out["runs"].append(row)
        log(f"{label}: {res.iterations} iterations, converged; vs eager plain "
            f"{hd:.2e} of r0, true residual {true_rel:.2e}"
            + ("" if cols is None else f", columns vs single runs {cols:.2e}")
            + f"; {ms_iter:.3f} ms/iteration warm, device "
            + (f"{dev_ms:.3f} ms, busy share {busy:.3f}" if prof else
               "time not measured (no device events)")
            + f"; {row['graph_launches']} cudaGraphLaunch; launches {row['launches']}")
        for n, ms, c in row["top_device"]:
            log(f"    {ms:9.3f} ms {c:6d}x  {n}")
    for name, dh in (("f64", dh64), ("f32", dh32)):
        keys = sorted({(kind, bs) for (_, kind, bs) in dh._factors})
        out[f"factor_bytes_{name}"] = dh.factor_bytes()
        out[f"dense_bytes_{name}"] = dense_factor_bytes(dh, keys)
        log(f"  {name} factors {keys}: {dh.factor_bytes()} bytes on the card; "
            f"the reference's dense [D, m, m] factors for them: "
            f"{out[f'dense_bytes_{name}']} bytes")
    out["launches"] = dict(out["launches"])
    return out


def bf16_smoother_rows(dh16, rng) -> tuple[dict[str, list], dict]:
    """The block smoothers' bfloat16 instances on the bfloat16 lowering's
    own factors, each against its plain version at the bfloat16 bar (and
    whether it equals it bit for bit): ``block_diag_apply`` at level 0 (bs
    4, the main path's) beside batched ``torch.matmul`` in bfloat16, bit
    for bit equal to its order's emulation (a gate), and
    ``tri_solve`` on both triangles at every non-coarsest level, on the
    route the rule takes and on the other where a rank's float32 z fits a
    block (:func:`tri_cases`; the plain version timed over one burst), k = 1
    and K_RHS, each with its bytes bound and depth × its route's one-step
    floor, measured on a bfloat16 chain of TRI_CHAIN_ROWS rows (a step
    waits on a float32 z, whose floor is not f64's).  Returns the rows and
    the floors."""
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.kernels.smoother import ref as sref
    from repro_torch.kernels.smoother import smoother as ks
    from repro_torch.kernels.smoother.bf16_order import block_diag_apply_emulate
    from repro_torch.kernels.spmv.ref import block_x

    omega = SolveOptions().omega
    bs = SolveOptions().block_size
    dev, dt = dh16.device, dh16.dtype
    out: dict[str, list] = {n: [] for n in SMOOTHER_KERNELS}
    bj = dh16._factor(0, "bj", bs)
    D, nb = bj.binv.shape[:2]
    m = dh16.levels[0].A.rows_local
    for k in (1, K_RHS):
        shape = (D, m) + ((k,) if k > 1 else ())
        r, x = (torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                                device=dev) for _ in range(2))
        rb = block_x(r, bs)

        def fn(B, r, x):
            return ks.block_diag_apply(B, r, x, omega)

        def plain(B, r, x):
            return sref.block_diag_apply_ref(B, r, x, omega)
        row = kernel_case(
            f"block_diag_apply L0 bs{bs} k{k}", fn, plain,
            lambda B=bj.binv, rb=rb: torch.matmul(B, rb), (bj.binv, r, x),
            (D * nb * bs * bs + 3 * D * m * k) * dt.itemsize,
            2 * bs * D * m * k, rtol=1.0, peak=PEAK_FLOPS[torch.float32],
            rel_err=bf16_bar(sref.block_diag_apply_absum(bj.binv, r, x, omega)),
            library_name="torch.matmul (batched, bf16)")
        y = fn(bj.binv, r, x)
        row.update(level=0, bs=bs, k=k, main_path=True,
                   bit_equal_plain=bool(torch.equal(y, plain(bj.binv, r, x))),
                   bit_equal_emulation=bool(torch.equal(
                       y, block_diag_apply_emulate(bj.binv, r, x, omega))))
        check(row["bit_equal_emulation"],
              f"bf16 block_diag_apply L0 bs{bs} k{k}: not bit-equal to its "
              f"order's emulation (smoother/bf16_order.py)")
        out["block_diag_apply"].append(row)
    for l, dl in enumerate(dh16.levels):
        if dl.coarse_inv is not None:
            continue
        for kind in ("gs", "gsu"):
            f = dh16._factor(l, kind, 0)
            sched = f.schedule()
            label = f"L{l} {'upper' if f.upper else 'lower'}"
            for k in (1, K_RHS):
                for row in tri_cases(label, f, k, dt, rng, sched,
                                     {"level": l, "triangle": kind},
                                     plain_samples=1):
                    row["main_path"] = (l == 0 and kind == "gs"
                                        and row["main_path_route"])
                    out["tri_solve"].append(row)
    chain = tri_chain(dh16.n_pods * dh16.lanes, TRI_CHAIN_ROWS, dt, dev)
    floors = {}
    for row in tri_cases("chain", chain, 1, dt, rng, chain.schedule(),
                         {"level": None, "triangle": "chain"},
                         {"plain_ms": None, "library_ms": None}):
        row["main_path"] = False
        floors[row["route"]] = row["us_per_step"]
        out["tri_solve"].append(row)
    for row in out["tri_solve"]:
        row["step_bound_ms"] = row["depth"] * floors[row["route"]] / 1e3
    equal = {n: sum(r["bit_equal_plain"] for r in rows) for n, rows in out.items()}
    emulated = [r["bit_equal_emulation"] for r in out["tri_solve"]
                if "bit_equal_emulation" in r]
    log(f"  bf16 smoother rows bit-equal to their plain versions: "
        f"{equal} of { {n: len(v) for n, v in out.items()} }; tri_solve k = 1 "
        f"rows bit-equal to their order's emulation: {sum(emulated)} of "
        f"{len(emulated)}; one-step floor "
        f"(a {TRI_CHAIN_ROWS}-row bf16 chain): " + ", ".join(
            f"{k} {v:.3f} us" for k, v in floors.items()))
    return out, floors


def bf16_block_phase(bound16, A, b, B, x64: dict) -> tuple[dict, dict]:
    """The block smoothers in bfloat16 on the bfloat16 session's lowering
    (the f64 sessions' host setup): their kernel rows
    (:func:`bf16_smoother_rows`), then PCG to BF16_TOL with
    ``block_jacobi`` and with ``hybrid_gs_sym`` through the captured graphs
    (launch counters set to 0 just before each, read just after; one
    replay a program call), each x within BF16_X_BAR of the f64
    block-smoother phase's x (``x64``), its float64 true residual, ms an
    iteration as the median of BF16_WARM warm solves and the device ms of
    one; then a k = K_RHS chunk through ``AMGService`` with
    ``hybrid_gs_sym``, each column against the f64 k = K_RHS run's.
    Returns the kernel rows and the numbers (launches by run)."""
    from repro_torch.amg import AMGService, AMGSolver
    from repro_torch.amg.api import SessionStore
    from repro_torch.amg.solve import SolveOptions

    dh16 = bound16.dist_hierarchy
    rows, floors = bf16_smoother_rows(dh16, np.random.default_rng(SEED + 6))
    out = {"runs": [], "launches": collections.Counter(),
           "step_floor_us": floors}
    store = SessionStore()
    for smoother in ("block_jacobi", "hybrid_gs_sym"):
        cfg = dataclasses.replace(bound16.config,
                                  opts=SolveOptions(smoother=smoother))
        bound = AMGSolver(cfg, store=store).setup(A)
        check(bound.dist_hierarchy is dh16,
              f"the bf16 {smoother} session does not share the bf16 lowering")
        res, counts = counted(lambda: bound.pcg(b))
        want = "block_diag_apply" if smoother == "block_jacobi" else "tri_solve"
        check(res.converged and counts[want] > 0,
              f"bf16 {smoother} PCG: converged {res.converged}, launches "
              f"{dict(counts)}")
        progs = [p for p in dh16.programs.values() if p.key.k is None
                 and p.key.smoother == smoother]
        calls = sum(p.replays for p in progs)
        check(all(p.graph is not None for p in progs)
              and calls == res.iterations + 1,
              f"bf16 {smoother}: {calls} graph replays for "
              f"{res.iterations + 1} program calls")
        x = res.x.astype(np.float64)
        xdiff = float(np.linalg.norm(x - x64[smoother]) / np.linalg.norm(x64[smoother]))
        check(xdiff <= BF16_X_BAR, f"bf16 {smoother} x is {xdiff:.3e} from "
              f"the f64 x")
        true_rel = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
        walls = []
        for _ in range(BF16_WARM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = bound.pcg(b)
            walls.append((time.perf_counter() - t0) * 1e3
                         / max(warm.iterations, 1))
        ms_iter = float(np.median(walls))
        prof = device_profile(lambda: bound.pcg(b))
        dev_ms = sum(v[0] for v in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:5]
        launches = {k: counts[k] for k in SMOOTHER_KERNELS + SPMV_KERNELS}
        out["launches"].update({k: counts[k] for k in SMOOTHER_KERNELS})
        row = {"run": f"pcg bfloat16 {smoother}", "iterations": res.iterations,
               "x_rel_diff_f64": xdiff, "true_residual": true_rel,
               "ms_per_iteration": ms_iter, "ms_per_iteration_runs": walls,
               "device_ms_per_iteration": dev_ms / max(warm.iterations, 1)
               if prof else None,
               "busy_share": dev_ms / (ms_iter * max(warm.iterations, 1))
               if prof else None, "launches": launches,
               "top_device": [[n[:80], ms, c] for n, (ms, c) in top]}
        out["runs"].append(row)
        log(f"pcg bf16 {smoother} (tol {BF16_TOL:g}): {res.iterations} "
            f"iterations, |x - x_f64| / |x_f64| {xdiff:.3e}, float64 true "
            f"residual {true_rel:.3e}, {ms_iter:.3f} ms/iteration (median of "
            f"{[round(w, 3) for w in walls]}), device "
            + ("not measured" if not prof else
               f"{row['device_ms_per_iteration']:.3f} ms/iteration, busy "
               f"{row['busy_share']:.3f}") + f"; launches {launches}")
        for n, ms, c in row["top_device"]:
            log(f"    {ms:9.3f} ms {c:6d}x  {n}")
    cfg = dataclasses.replace(bound16.config,
                              opts=SolveOptions(smoother="hybrid_gs_sym"))
    svc = AMGService(cfg, max_rhs=K_RHS, coalesce_window=SERVICE_WINDOW,
                     store=store)
    svc.register("m", A)
    check(svc.bound_for("m").dist_hierarchy is dh16,
          "the bf16 hybrid_gs_sym service did not share the bf16 lowering")
    tickets = [svc.submit("m", B[:, j], method="pcg") for j in range(K_RHS)]
    _, csvc = counted(svc.drain)
    X64 = x64[("hybrid_gs_sym", K_RHS)]
    worst, widths = 0.0, set()
    for j, t in enumerate(tickets):
        widths.add(t.diagnostics["batch_cols"])
        check(t.diagnostics["converged"],
              f"bf16 hybrid_gs_sym service request {j} did not converge")
        worst = max(worst, float(np.linalg.norm(t.result(timeout=0) - X64[:, j])
                                 / np.linalg.norm(X64[:, j])))
    check(widths == {K_RHS} and csvc["tri_solve"] > 0,
          f"bf16 hybrid_gs_sym service chunks {widths}, launches {dict(csvc)}")
    check(worst <= BF16_X_BAR, f"bf16 hybrid_gs_sym service x is {worst:.3e} "
          f"from f64's")
    out["launches"].update({k: csvc[k] for k in SMOOTHER_KERNELS})
    out["service"] = {"worst_x_rel_diff": worst,
                      "launches": {k: csvc[k] for k in SMOOTHER_KERNELS + SPMV_KERNELS}}
    log(f"bf16 hybrid_gs_sym service: {K_RHS} requests in one chunk of "
        f"{K_RHS}, worst |x - x_f64| / |x_f64| {worst:.3e}, launches "
        f"{out['service']['launches']}")
    out["launches"] = dict(out["launches"])
    del svc
    return rows, out


def block_refresh_phase(cfg64, bound64, b) -> dict:
    """After ``bound64.update`` (the refresh phase): ``hybrid_gs_sym`` PCG on
    the refreshed lowering through its graphs (captured before the update,
    not captured again) against a fresh lowering of the refreshed host
    hierarchy, whose factors are computed anew (≤ HIST_TOL of r0, the same
    iterations).  A fresh host setup of the drifted matrix re-derives P
    (the refresh phase prints its history beside the refreshed one), so
    the lowering is what is held here."""
    from repro_torch.amg.dist_solve import DistHierarchy, dist_pcg
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.core import MACHINES

    dh = bound64.dist_hierarchy
    opts = SolveOptions(smoother="hybrid_gs_sym")
    caps0 = collections.Counter(dh.programs.captures)
    res = dist_pcg(dh, b, tol=cfg64.tol, opts=opts)
    check(collections.Counter(dh.programs.captures) == caps0,
          "the block-smoother graphs were captured again after the refresh")
    t0 = time.perf_counter()
    fresh = DistHierarchy.build(bound64.hierarchy, N_PODS, LANES,
                                params=MACHINES[cfg64.machine],
                                strategy=cfg64.strategy, dtype=torch.float64,
                                device=DEVICE)
    t_fresh = time.perf_counter() - t0
    res_f = dist_pcg(fresh, b, tol=cfg64.tol, opts=opts)
    hd = history_diff(res_f.residuals, res.residuals)
    check(res.converged and res.iterations == res_f.iterations and hd <= HIST_TOL,
          f"refreshed hybrid_gs_sym PCG {res.iterations} iterations vs a fresh "
          f"lowering {res_f.iterations}, history diff {hd:.2e}")
    log(f"block refresh: hybrid_gs_sym PCG on the refreshed lowering "
        f"{res.iterations} iterations, no graph captured again; a fresh "
        f"lowering ({t_fresh:.2f} s) {res_f.iterations} iterations, history vs "
        f"it {hd:.2e}")
    del fresh
    torch.cuda.empty_cache()
    return {"iterations": res.iterations, "fresh_lowering_s": t_fresh,
            "history_vs_fresh_lowering": hd}


def born_block_phase(born, b, host_iters: int) -> dict:
    """``hybrid_gs_sym`` PCG on the (refreshed) dist-born lowering through
    its graphs: its history against its own eager plain run (≤ HIST_TOL of
    r0) and its iterations against the refreshed host-setup session's
    (±1; the coarse grids differ from level 1 on)."""
    from repro_torch.amg.dist_solve import dist_pcg
    from repro_torch.amg.solve import SolveOptions

    bound, _ = born
    dh = bound.dist_hierarchy
    opts = SolveOptions(smoother="hybrid_gs_sym")
    res, counts = counted(lambda: dist_pcg(dh, b, tol=bound.config.tol, opts=opts))
    check(res.converged and counts["tri_solve"] > 0,
          f"dist-born hybrid_gs_sym PCG: converged {res.converged}, "
          f"launches {counts}")
    hd = history_diff(eager_history(dh, b, opts, "pcg", res.iterations),
                      res.residuals)
    check(hd <= HIST_TOL and abs(res.iterations - host_iters) <= 1,
          f"dist-born hybrid_gs_sym PCG: {res.iterations} iterations (host "
          f"setup {host_iters}), vs eager plain {hd:.2e}")
    log(f"  dist-born hybrid_gs_sym PCG: {res.iterations} iterations (host-setup "
        f"session {host_iters}), history vs eager plain {hd:.2e}, tri_solve "
        f"launches {counts['tri_solve']}")
    return {"iterations": res.iterations, "history_vs_eager_plain": hd,
            "tri_solve_launches": counts["tri_solve"]}


def launch_counters() -> dict:
    """Every kernel wrapper, by kernel name (each carries ``.launches``);
    ``flash_attention`` counts both flash kernels, ``flash_attention_wgmma``
    the Hopper kernel's launches alone."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.smoother.smoother import block_diag_apply, tri_solve
    from repro_torch.kernels.spmv.bcsr import bcsr_spmm
    from repro_torch.kernels.spmv.spmv import ell_spmm, ell_spmv
    return {"ell_spmv": ell_spmv, "ell_spmm": ell_spmm,
            "bcsr_spmm": bcsr_spmm, "block_diag_apply": block_diag_apply,
            "tri_solve": tri_solve, "flash_attention": flash_attention,
            # the wrapper counts both flash kernels; this one the Hopper
            # kernel's own launches
            "flash_attention_wgmma": flash_attention.by_kernel["flash_attention_wgmma"]}


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before; return its
    result and the counts read just after."""
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {k: w.launches for k, w in wrappers.items()}


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (CUPTI), synchronised; returns the
    profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_profile(fn, runtime: dict | None = None) -> dict:
    """Device time of ``fn()`` by kernel name, from ``torch.profiler``
    (CUPTI).  Empty when the profiler saw no device activity.  ``runtime``,
    where given, receives the host's CUDA runtime calls by name (count)."""
    from torch.autograd import DeviceType

    prof = profiled(fn)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
        elif runtime is not None and e.name.startswith("cu"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    return by_name


def last_graph_kernels(fn) -> list[dict]:
    """The device kernels of the last CUDA graph ``fn()`` launches, from the
    profiler's trace (a graph's kernels carry its ``cudaGraphLaunch``'s
    correlation id): name, start and end (µs) and stream, in start order.
    The first replays under the profiler also carry its start-up."""
    prof = profiled(fn)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    launches = [e for e in events if e.get("name") == "cudaGraphLaunch"]
    if not launches:
        return []
    last = max(launches, key=lambda e: float(e["ts"]))
    corr = last.get("args", {}).get("correlation")
    spans = [{"name": e["name"], "start": float(e["ts"]),
              "end": float(e["ts"]) + float(e.get("dur", 0.0)),
              "stream": e.get("args", {}).get("stream")}
             for e in events if e.get("cat") == "kernel"
             and e.get("args", {}).get("correlation") == corr]
    return sorted(spans, key=lambda e: e["start"])


def overlap_share(spans: list[dict]) -> dict:
    """In one ``pcg_step`` replay (``spans`` its kernels): the share of the
    level-0 halo exchange's kernel time that runs concurrently with the
    level-0 ``A_on`` ``ell_spmv``.  ``A·p`` opens the step, so the first two
    ``ell_spmv`` kernels are level 0's ``A_on`` (concurrent with the
    exchange) and ``A_off`` (after the join), and the exchange's kernels are
    the others that start before ``A_off``."""
    spmv = [e for e in spans if "ell_spmv" in e["name"]]
    if len(spmv) < 2:
        return {"share": None, "kernels": len(spans)}
    on, off = spmv[0], spmv[1]
    exch = [e for e in spans if e["start"] < off["start"]
            and "ell_spmv" not in e["name"]]
    busy = sum(e["end"] - e["start"] for e in exch)
    both = sum(max(0.0, min(e["end"], on["end"]) - max(e["start"], on["start"]))
               for e in exch)
    return {"share": both / busy if busy else None, "kernels": len(spans),
            "exchange_kernels": len(exch), "exchange_us": busy,
            "a_on_us": on["end"] - on["start"],
            "streams": sorted({str(e["stream"]) for e in exch + [on]})}


def eager_pcg(dh, b, opts, iters: int) -> list[float]:
    """The f64 PCG history through the eager program bodies (called
    directly, one Python call per operation)."""
    x = dh.scatter(np.zeros_like(b))
    r, p, rz, rn = dh.pcg_init(x, dh.scatter(b), opts)
    hist = [float(rn[0])]
    for _ in range(iters):
        x, r, p, rz, rn = dh.pcg_step(x, r, p, rz, opts)
        hist.append(float(rn[0]))
    return hist


def drift(A, scale=0.03, seed=1):
    """A value-only drift on A's frozen pattern, symmetric (the reference
    suite's ``tests/test_streaming.py:_drift``)."""
    from repro_torch.amg.csr import CSR

    rng = np.random.default_rng(seed)
    data = A.data * (1.0 + scale * rng.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    return CSR(A.shape, A.indptr.copy(), A.indices.copy(),
               0.5 * (data + At.data))


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, queries right-aligned."""
    qpos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_shapes(S: int) -> list[tuple]:
    """The flash cases at prompt length S: label, B, Hq, Hkv, Sq, Skv, D,
    window (all causal)."""
    return [("prefill", LM_BATCH, 16, 8, S, S, 128, None),
            ("window 256", LM_BATCH, 16, 8, S, S, 128, 256),
            ("Sq < Skv", LM_BATCH, 16, 8, 128, 1024, 128, None),
            ("head dim 64", LM_BATCH, 14, 2, S, S, 64, None)]


def recurrent_flash_shapes(S: int) -> list[tuple]:
    """recurrentgemma-9b's prefill shape (MQA 16:1 at head dim 256, its
    2048-key window, which binds nothing at S 1819) and the same with a
    window of 256 that binds, in f32 and bf16."""
    return [("recurrentgemma-9b prefill", LM_BATCH, 16, 1, S, S, 256, 2048),
            ("recurrentgemma-9b window 256", LM_BATCH, 16, 1, S, S, 256, 256)]


def moe_flash_shapes(S: int) -> list[tuple]:
    """The MoE archs' prefill shapes (bf16 only, as served): mixtral's GQA
    48:8 with its 4096-key window, qwen3-moe's 64:4."""
    return [("mixtral-8x22b prefill", LM_BATCH, 48, 8, S, S, 128, 4096),
            ("qwen3-moe prefill", LM_BATCH, 64, 4, S, S, 128, None)]


def flash_peak(dtype) -> float:
    """The flash kernel's peak rate in ``dtype``: float32 as 3xTF32."""
    return TF32X3_FLOPS if dtype == torch.float32 else PEAK_FLOPS[dtype]


def flash_bounds(dtype, B, Hq, D, pairs, nbytes) -> dict:
    """The flop / byte bound of one flash case (4 flops per visible pair
    and head dim: q.k and p.v), in ms: at the design's rate
    (``flash_peak``) and, for float32, at the FMA units' as
    ``bound_fma_ms``."""
    flops = 4 * B * Hq * D * pairs
    out = {"flops": flops,
           "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / flash_peak(dtype)) * 1e3}
    if dtype == torch.float32:
        out["bound_fma_ms"] = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3
    return out


def sdpa_call(q, k, v, window):
    """``scaled_dot_product_attention`` on the same causal (windowed)
    problem, queries right-aligned: the yardstick, used nowhere in the
    port.  A window no shorter than the keys binds nothing, so that problem
    takes the plain causal call."""
    import torch.nn.functional as F

    Sq, Skv = q.shape[2], k.shape[2]
    if (window is None or window >= Skv) and Sq == Skv:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = (qpos >= kpos) & ((qpos - kpos) < (window or Skv + 1))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def flash_phase(S: int, head_dims=None) -> list[dict]:
    """flash_attention at the serving runs' prefill shape, with a window,
    with Sq < Skv, at head dim 64, at recurrentgemma-9b's head dim 256
    (its prefill, and with a window that binds) and at phi-3-vision-4.2b's
    head dim 96 (its prefill), each in f32 and bf16, and
    at the MoE archs' prefill shapes in bf16, against its plain version;
    ``scaled_dot_product_attention`` timed as the yardstick.  ``head_dims``:
    only the cases at those head dims."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention, route
    from repro_torch.kernels.flash_attention.ref import attention_ref, rel_err_rows

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [(label, dt, *shape)
             for label, *shape in (flash_shapes(S) + recurrent_flash_shapes(S)
                                   + embed_flash_shapes(S))
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(label, torch.bfloat16, *shape)
              for label, *shape in moe_flash_shapes(S)]
    cases = [c for c in cases if head_dims is None or c[7] in head_dims]
    rows = []
    for label, dt, B, Hq, Hkv, Sq, Skv, D, window in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dt)
                   for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                                 (B, Hkv, Skv, D)))
        pairs = visible_pairs(Sq, Skv, True, window)
        # q, k, v read once, o written once
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bounds = flash_bounds(dt, B, Hq, D, pairs, nbytes)
        name = route(dt, D)
        before = flash_attention.by_kernel[name].launches
        row = kernel_case(
            f"flash_attention {label}",
            lambda q, k, v, w=window: flash_attention(q, k, v, True, w),
            lambda q, k, v, w=window: attention_ref(q, k, v, True, w),
            sdpa_call(q, k, v, window), (q, k, v), nbytes, bounds["flops"],
            rtol=FLASH_RTOL[dt], library_name="sdpa", rel_err=rel_err_rows,
            peak=flash_peak(dt), plain_samples=FLASH_PLAIN_SAMPLES)
        check(flash_attention.by_kernel[name].launches > before,
              f"flash_attention {label} {dt}: {name} launched no time")
        row.update(case=label, head_dim=D, window=window, visible_pairs=pairs,
                   kernel=name, design=FLASH_DESIGN[name, dt],
                   main_path=label == "prefill",
                   tflops=bounds["flops"] / row["ms"] / 1e9)
        if dt == torch.bfloat16:
            log(f"    {row['tflops']:.1f} TFLOP/s")
        if "bound_fma_ms" in bounds:
            row["bound_fma_ms"] = bounds["bound_fma_ms"]
            log(f"    {row['tflops']:.1f} TFLOP/s; bound {row['bound_ms']:.4f} ms "
                f"(3xTF32), {row['bound_fma_ms']:.4f} ms (FMA units)")
        rows.append(row)
        del q, k, v
    return rows


def lm_workload(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, size=LM_REQUESTS)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lengths]


def lm_serve(cfg, prompts, dtype) -> dict:
    """The serving path in ``dtype`` (weights and caches): init, a warm-up
    request, then the counted run."""
    from repro_torch.kernels.flash_attention.flash_attention import route
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, Request

    t0 = time.perf_counter()
    model = init_lm(cfg, seed=SEED, dtype=dtype, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ctx_len = max(len(p) for p in prompts) + LM_NEW + 8     # as run_lm sizes it
    # warm-up (cuBLAS handles, the kernel library's load), not counted
    warm = Engine(cfg, model, max_batch=LM_BATCH, ctx_len=ctx_len, dtype=dtype,
                  device=DEVICE)
    warm.submit(Request(rid=0, prompt=prompts[0][:64], max_new_tokens=2))
    warm.run()
    eng = Engine(cfg, model, max_batch=LM_BATCH, ctx_len=ctx_len, dtype=dtype,
                 device=DEVICE)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if cfg.is_moe:
        model.moe_stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts = counted(eng.run)
    wall = time.perf_counter() - t0
    # the decode steps' (token, slot) selections and the ones the experts'
    # capacity dropped (prefill's: moe_check, from its walk's keep masks)
    moe_stats, model.moe_stats = model.moe_stats, None
    check(sorted(out) == list(range(len(reqs))), f"answered {sorted(out)}")
    for rid, toks in out.items():
        check(toks.shape == (LM_NEW,) and ((toks >= 0) & (toks < cfg.vocab)).all(),
              f"request {rid}: bad tokens {toks}")
    n_batches = -(-len(reqs) // LM_BATCH)
    n_attn = model.kinds.count("attn")
    check(counts["flash_attention"] == n_attn * n_batches,
          f"flash_attention launched {counts['flash_attention']} times, want "
          f"{n_attn} attention layers x {n_batches} prefill batches")
    flash_kernel = route(dtype, cfg.head_dim)
    want = counts["flash_attention"] if flash_kernel == "flash_attention_wgmma" else 0
    check(counts["flash_attention_wgmma"] == want,
          f"{cfg.name} {dtype}: flash_attention_wgmma launched "
          f"{counts['flash_attention_wgmma']} times, want {want} (route: {flash_kernel})")
    s = eng.stats
    name = str(dtype).replace("torch.", "")
    info = {"arch": cfg.name, "dtype": name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "attention_layers": n_attn,
            "flash_launches_per_batch": counts["flash_attention"] / n_batches,
            "flash_kernel": flash_kernel,
            "params": sum(p.numel() for p in model.parameters()),
            "requests": len(reqs), "batches": s["batches"],
            "prompt_lengths": [len(p) for p in prompts], "new_tokens": LM_NEW,
            "ctx_len": ctx_len, "init_s": t_init, "wall_s": wall,
            "prefill_s": s["prefill_s"],
            "prefill_s_per_batch": s["prefill_s"] / n_batches,
            "decode_s": s["decode_s"],
            "decode_tok_s": s["tokens"] / s["decode_s"],
            "decode_step_ms": s["decode_s"] * 1e3 / (n_batches * (LM_NEW - 1)),
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts}
    if moe_stats:
        info["decode_dropped_share"] = (int(moe_stats["dropped"])
                                        / moe_stats["selected"])
    log(f"serve {cfg.name} {name} ({info['params'] / 1e9:.3f}B params, init "
        f"{t_init:.2f} s): {len(out)} requests (prompts {info['prompt_lengths']},"
        f" {LM_NEW} new tokens, batches of {LM_BATCH}) in {wall:.2f} s; "
        f"prefill {s['prefill_s']:.3f} s, decode {info['decode_tok_s']:.1f} "
        f"tok/s ({info['decode_step_ms']:.2f} ms/step), peak "
        f"{info['peak_gb']:.1f} GiB, launches {counts}"
        + (f"; capacity dropped {info['decode_dropped_share']:.4f} of the "
           f"decode steps' (token, slot) selections" if moe_stats else ""))
    return {"model": model, "reqs": reqs, "out": out, "ctx_len": ctx_len,
            "info": info}


def clone_cache(cache):
    """A copy of a decode cache ``(groups, extra)``, every tensor cloned."""
    return tuple(tuple({k: t.clone() for k, t in c.items()} for c in part)
                 for part in cache)


def lm_check(cfg, run, dtype) -> dict:
    """Kernel vs plain on the served batches, teacher-forced with the served
    tokens (zero embeddings for an embedding-input arch, as its engine
    decodes) (logits to ``LOGITS_RTOL[dtype]`` of max|logits|, or the arch's
    own bar in ``ARCH_LOGITS_RTOL``), plus the device busy share of one
    decode step."""
    from repro_torch.serve.engine import pad_prompts, prefill_to_decode_cache

    model, reqs, out = run["model"], run["reqs"], run["out"]
    worst = {"prefill": 0.0, "decode": 0.0}
    agree = {"kernel": 0, "plain": 0, "total": 0}
    step = None
    with torch.inference_mode():
        for b0 in range(0, len(reqs), LM_BATCH):
            batch = reqs[b0:b0 + LM_BATCH]
            prompts = torch.as_tensor(pad_prompts(batch), device=DEVICE)
            S = prompts.shape[1]
            served = torch.as_tensor(np.stack([out[r.rid] for r in batch]),
                                     device=DEVICE)
            logits, caches = {}, {}
            for use_kernel in (True, False):
                lg, c = model(prompts, return_cache=True, use_kernel=use_kernel)
                caches[use_kernel] = prefill_to_decode_cache(
                    cfg, c, run["ctx_len"], S, dtype)
                del c
                logits[use_kernel] = lg
            lk, lp = logits[True], logits[False]
            err = float((lk - lp).abs().max()) / float(lk.abs().max())
            worst["prefill"] = max(worst["prefill"], err)
            last = {u: logits[u][:, -1].clone() for u in logits}
            del logits, lk, lp
            for t in range(LM_NEW):
                want = served[:, t]
                agree["kernel"] += int((last[True].argmax(-1) == want).sum())
                agree["plain"] += int((last[False].argmax(-1) == want).sum())
                agree["total"] += len(batch)
                if t == LM_NEW - 1:
                    break
                tok = served[:, t:t + 1]
                if not cfg.embed_input:    # the engine feeds zero embeddings
                    tok = torch.zeros((len(batch), 1, cfg.d_model), dtype=dtype,
                                      device=DEVICE)
                if step is None:     # one step alone: wall and device time
                    # on a copy: a step advances a recurrent layer's state
                    scratch = clone_cache(caches[True])
                    for _ in range(3):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        model.decode_step(tok, scratch, S + t)
                        torch.cuda.synchronize()
                        wall_ms = (time.perf_counter() - t0) * 1e3
                    prof = device_profile(
                        lambda: model.decode_step(tok, scratch, S + t))
                    del scratch
                    dev_ms = sum(v[0] for v in prof.values())
                    step = {"wall_ms": wall_ms,
                            "device_ms": dev_ms if prof else None,
                            "busy_share": dev_ms / wall_ms if prof else None,
                            "top_device": [[kn[:100], km, kc] for kn, (km, kc) in
                                           sorted(prof.items(),
                                                  key=lambda kv: -kv[1][0])[:6]]}
                for u in (True, False):
                    last[u], caches[u] = model.decode_step(tok, caches[u], S + t)
                err = float((last[True] - last[False]).abs().max()) \
                    / float(last[True].abs().max())
                worst["decode"] = max(worst["decode"], err)
            del caches, last
    tol = ARCH_LOGITS_RTOL.get((cfg.name, dtype), LOGITS_RTOL[dtype])
    res = {"logits_rel_err": worst, "logits_rtol": tol, "greedy_agreement": agree,
           "decode_step": step}
    log(f"kernel vs plain ({str(dtype).replace('torch.', '')}, teacher-forced): "
        f"prefill logits {worst['prefill']:.2e}, "
        f"decode logits {worst['decode']:.2e} of max|logits|; greedy tokens as "
        f"served: kernel {agree['kernel']}/{agree['total']}, plain "
        f"{agree['plain']}/{agree['total']}")
    check(worst["prefill"] <= tol and worst["decode"] <= tol,
          f"kernel vs plain logits ({dtype}): {worst} exceed {tol:g} x max|logits|")
    log(f"  one decode step: {step['wall_ms']:.3f} ms wall, device "
        + (f"{step['device_ms']:.3f} ms, busy share {step['busy_share']:.3f}"
           if step["device_ms"] is not None else "time not measured (no events)"))
    for kn, km, kc in step["top_device"]:
        log(f"    {km:9.3f} ms {kc:6d}x  {kn}")
    return res


def moe_forced(ffn, cfg, h, sel):
    """``moe_ffn_tp`` with the experts ``sel`` [T, k] chosen for it: the
    router's probabilities at ``sel``, renormalised, and the capacity
    applied to ``sel`` in token order (``moe_ffn_tp`` itself where ``sel``
    is its own top-k)."""
    from repro_torch.models.moe import (_capacity, _combine,
                                        _dispatch_indices, _expert_ffn,
                                        _scatter)

    x2 = h.reshape(-1, h.shape[-1])
    probs = torch.softmax(x2.float() @ ffn["router"], dim=-1).gather(1, sel)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = _capacity(x2.shape[0], cfg)
    e_id, pos = _dispatch_indices(sel, cfg.n_experts, cap)
    buf, safe_pos, keep = _scatter(x2, e_id, pos, cap, cfg.n_experts,
                                   cfg.top_k)
    out = _combine(_expert_ffn(ffn, buf, cfg.act), e_id, safe_pos, keep,
                   probs, cfg.top_k)
    return out.reshape(h.shape)


def routing_stats(h, router, sel, keep, real, n_experts: int) -> dict:
    """One MoE layer's routing of a prefill batch (``h`` [T, d], the
    router's input): the share of (token, slot) selections the capacity
    dropped, over all tokens and over the prompts' own (``real`` [T]: not
    padding); the share of h's energy in the real tokens' mean (about 1 / T
    for tokens unlike each other, 1 when all are alike); the router logits'
    spread over the real tokens (the experts' mean standard deviation)
    beside the spread of their means over the experts; the busiest expert's
    real selections over an even share."""
    hr = h[real].float()
    logits = hr @ router
    load = torch.bincount(sel[real].reshape(-1), minlength=n_experts)
    return {"dropped": float((~keep).float().mean()),
            "dropped_real": float((~keep[real]).float().mean()),
            "mean_energy_share": float(hr.mean(0).square().sum()
                                       / hr.square().sum(1).mean()),
            "logit_spread_tokens": float(logits.std(0).mean()),
            "logit_spread_experts": float(logits.mean(0).std()),
            "busiest_over_even": float(load.max() / load.float().mean())}


def moe_walk(model, cfg, tokens, use_kernel: bool, real, routes=None,
             embed_scale: float = 1.0):
    """``LM.forward``'s prefill walked layer by layer, the attention through
    the kernel (``use_kernel``) or its plain version: every layer's
    kernel-vs-plain attention error on this walk's own input (per row, over
    the row's max|plain|), every layer's routing (each token's experts
    ``sel`` [T, k], and which of them the capacity kept), its
    :func:`routing_stats` (``real`` [B, S]: not padding) and the logits.
    ``routes`` (another walk's) forces each layer's experts to that walk's
    (:func:`moe_forced`); ``embed_scale`` scales the embedded tokens (a
    probe of what the random embedding's scale does to the routing)."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import rel_err_rows
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import apply_rope, make_norm
    from repro_torch.models.moe import (_capacity, _dispatch_indices, _route,
                                        moe_ffn_tp)

    norm = make_norm(cfg.norm)
    x = model.embed_inputs(tokens) * embed_scale
    b, S, d = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cap = _capacity(b * S, cfg)
    errs, mine, stats = [], [], []
    for i, layer in enumerate(model.layers):
        q, k, v = _project_qkv(layer["core"], cfg, norm(layer["ln1"], x))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        outs = {u: attention(q, k, v, causal=True, window=cfg.window,
                             use_kernel=u) for u in (True, False)}
        errs.append(rel_err_rows(outs[True], outs[False]))
        x = x + outs[use_kernel].reshape(b, S, -1) @ layer["core"]["wo"]
        h = norm(layer["ln2"], x)
        _, sel = _route(h.reshape(-1, d), layer["ffn"]["router"], cfg.top_k)
        _, pos = _dispatch_indices(sel, cfg.n_experts, cap)
        mine.append((sel, pos < cap))
        stats.append(routing_stats(h.reshape(-1, d), layer["ffn"]["router"],
                                   sel, pos < cap, real.reshape(-1),
                                   cfg.n_experts))
        x = x + (moe_ffn_tp(layer["ffn"], cfg, h) if routes is None else
                 moe_forced(layer["ffn"], cfg, h, routes[i][0]))
        del q, k, v, outs, h
    return model.unembed(norm(model.final_norm, x)), errs, mine, stats


def moe_check(cfg, run) -> dict:
    """Kernel vs plain on the served MoE batch, routing-aware: each layer's
    attention kernel against its plain version on the same input (per row,
    ``FLASH_RTOL``); the share of tokens whose routing (experts and kept
    slots, in any layer) differs between the kernel walk and the plain walk
    (a rounding can flip a router decision, and a flipped token's logits
    differ by O(1)), and the logits of the tokens whose routing agrees
    (printed: a flip also moves later tokens of its row through the next
    layer's attention); the logits of every token with the plain walk's
    experts forced to the kernel walk's (``LOGITS_RTOL``); and the kernel
    walk against ``LM.forward``.  Also the share of the served prefill's
    selections the capacity dropped (the kernel walk's keep masks), each
    layer's :func:`routing_stats`, and the drop shares of a walk with the
    embedded tokens scaled by ``EMBED_PROBE``."""
    from repro_torch.serve.engine import pad_prompts

    model, reqs = run["model"], run["reqs"]
    dtype = model.embed.dtype
    check(len(reqs) <= LM_BATCH, f"{len(reqs)} requests: one batch expected")
    with torch.inference_mode():
        tokens = torch.as_tensor(pad_prompts(reqs), device=DEVICE)
        S = tokens.shape[1]
        real = (torch.arange(S, device=DEVICE)[None, :] >= torch.as_tensor(
            [S - len(r.prompt) for r in reqs], device=DEVICE)[:, None])
        lk, errs, rk, routing = moe_walk(model, cfg, tokens, True, real)
        lp, _, rp, _ = moe_walk(model, cfg, tokens, False, real)
        vocab = lk.shape[-1]
        same = torch.ones(lk.shape[:2], dtype=torch.bool,
                          device=DEVICE).reshape(-1)
        for (sk, kk), (sp, kp) in zip(rk, rp):
            sk, ok = sk.sort(dim=-1)
            sp, op = sp.sort(dim=-1)
            same &= ((sk == sp).all(-1)
                     & (kk.gather(1, ok) == kp.gather(1, op)).all(-1))
        scale = float(lk.abs().max())
        agreed_err = float((lk.reshape(-1, vocab)[same]
                            - lp.reshape(-1, vocab)[same]).abs().max()) / scale
        del lp
        lf = moe_walk(model, cfg, tokens, False, real, routes=rk)[0]
        forced_err = float((lk - lf).abs().max()) / scale
        del lf
        served = model(tokens)
        walk_err = float((lk - served).abs().max()) / float(served.abs().max())
        bit_equal = bool(torch.equal(lk, served))
        del lk, served
        probe = moe_walk(model, cfg, tokens, True, real,
                         embed_scale=EMBED_PROBE)[3]
        dropped = float(sum((~keep).sum() for _, keep in rk)
                        / sum(keep.numel() for _, keep in rk))
    flipped = 1.0 - float(same.float().mean())
    check(max(errs) <= FLASH_RTOL[dtype],
          f"{cfg.name}: kernel vs plain attention per layer {errs} above "
          f"{FLASH_RTOL[dtype]:g}")
    check(forced_err <= LOGITS_RTOL[dtype] and walk_err <= LOGITS_RTOL[dtype],
          f"{cfg.name}: logits with the experts forced alike {forced_err:.2e},"
          f" the kernel walk vs LM.forward {walk_err:.2e} of max|logits|")
    res = {"prefill_dropped_share": dropped, "routing_per_layer": routing,
           "routing_per_layer_embed_probe": probe,
           "attention_rel_err_per_layer": errs,
           "routing_differs_share": flipped,
           "logits_rel_err_routed_alike": agreed_err,
           "logits_rel_err_experts_forced": forced_err,
           "walk_vs_forward": walk_err, "walk_bit_equal": bit_equal}
    log(f"kernel vs plain ({cfg.name}, {str(dtype).replace('torch.', '')}, "
        f"prefill, routing-aware): attention per layer "
        f"{[f'{e:.2e}' for e in errs]} (per row, bar {FLASH_RTOL[dtype]:g}); "
        f"routing differs for {flipped:.4f} of {same.numel()} tokens; logits "
        f"of the rest {agreed_err:.2e}, of all with the plain walk's experts "
        f"forced to the kernel's {forced_err:.2e} of max|logits| (bar "
        f"{LOGITS_RTOL[dtype]:g}); the kernel walk vs LM.forward "
        f"{walk_err:.2e}" + (" (bit-equal)" if bit_equal else ""))
    log(f"  routing ({cfg.name}, prefill, {int(real.sum())} prompt tokens and "
        f"{int((~real).sum())} pads): capacity dropped {dropped:.4f} of the "
        f"(token, slot) selections")
    for i, (r, p) in enumerate(zip(routing, probe)):
        log(f"    layer {i}: dropped {r['dropped']:.4f} ({r['dropped_real']:.4f}"
            f" of the prompt tokens'); mean's energy share "
            f"{r['mean_energy_share']:.4f}; router logits' spread over tokens "
            f"{r['logit_spread_tokens']:.4f}, over the experts' means "
            f"{r['logit_spread_experts']:.4f}; busiest expert "
            f"{r['busiest_over_even']:.2f} x an even share | embedding x "
            f"{EMBED_PROBE:g}: dropped {p['dropped']:.4f} "
            f"({p['dropped_real']:.4f}), mean's energy share "
            f"{p['mean_energy_share']:.4f}, busiest {p['busiest_over_even']:.2f}")
    return res


def moe_ep_phase(ffn, cfg) -> dict:
    """One layer's MoE (``ffn``, the served model's layer 0) expert
    parallel over the stacked 2 x 4 ranks, ``EP_TOKENS`` tokens a rank:
    ``moe_ffn_ep`` with ``nap`` on and off bit-equal at the served capacity,
    each logging two shuffles' signatures; at the least capacity where
    nothing drops (from the routing counts), EP against ``moe_ffn_tp`` in
    float32 and bfloat16 (``EP_TOL``)."""
    from repro_torch.core.nap_collectives import all_to_all_signature
    from repro_torch.models.moe import _route, moe_ffn_ep, moe_ffn_tp

    D, E, k = N_PODS * LANES, cfg.n_experts, cfg.top_k
    mesh = (N_PODS, LANES)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x32 = torch.randn((D, EP_TOKENS, cfg.d_model), generator=gen,
                      device=DEVICE)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res = {"ranks": D, "experts_per_rank": E // D, "tokens_per_rank": EP_TOKENS}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            full = {key: (w if key == "router" else w.to(dtype))
                    for key, w in ffn.items()}
            slabs = {key: (w if key == "router" else
                           w.reshape((D, E // D) + tuple(w.shape[1:])))
                     for key, w in full.items()}
            x = x32.to(dtype)
            row = {}
            if dtype == torch.bfloat16:      # the served dtype and capacity
                out, logs = {}, {}
                # nap3 first as a warm-up, then the timed flat and nap3
                for nap in (True, False, True):
                    logs[nap] = []
                    out[nap], row[f"ms_{'nap3' if nap else 'flat'}"] = timed(
                        lambda: moe_ffn_ep(slabs, cfg, x, mesh, nap=nap,
                                           log=logs[nap]))
                check(torch.equal(out[True], out[False]),
                      "moe_ffn_ep: nap3 and flat differ")
                for nap in (True, False):
                    want = 2 * all_to_all_signature("nap3" if nap else "flat")
                    check(tuple(logs[nap]) == want,
                          f"moe_ffn_ep nap={nap} logged {logs[nap]}, want {want}")
                row["nap3_bit_equal_flat"] = True
                row["logs"] = {str(nap): logs[nap] for nap in logs}
                del out
            # the least capacity factor at which neither EP (a rank's
            # tokens) nor TP (all tokens) drops a selection
            _, sel = _route(x.reshape(-1, cfg.d_model), full["router"], k)
            rank = torch.arange(D, device=DEVICE).repeat_interleave(
                EP_TOKENS * k)
            ep_max = int(torch.bincount(rank * E + sel.reshape(-1)).max())
            tp_max = int(torch.bincount(sel.reshape(-1)).max())
            cf = max((ep_max + 0.5) / (EP_TOKENS * k / E),
                     (tp_max + 0.5) / (D * EP_TOKENS * k / E))
            nodrop = dataclasses.replace(cfg, capacity_factor=cf)
            ep, row["ms_ep_nodrop"] = timed(
                lambda: moe_ffn_ep(slabs, nodrop, x, mesh, nap=True))
            stats = {}
            tp, row["ms_tp_nodrop"] = timed(
                lambda: moe_ffn_tp(full, nodrop, x, stats))
            check(int(stats["dropped"]) == 0, "moe_ffn_tp dropped tokens")
            diff = (ep.float() - tp.float()).abs()
            scale = float(tp.float().abs().max())
            if dtype == torch.float32:
                ok = bool((diff <= EP_TOL[dtype]
                           * (1 + tp.float().abs())).all())
            else:
                ok = float(diff.max()) <= EP_TOL[dtype] * scale
            row.update(capacity_factor=cf, max_per_rank_expert=ep_max,
                       max_per_expert=tp_max,
                       max_abs_err=float(diff.max()), max_abs_y=scale)
            check(ok, f"moe_ffn_ep vs moe_ffn_tp ({name}, nothing dropped): "
                  f"max |diff| {row['max_abs_err']:.3e}, max|y| {scale:.3e}")
            res[name] = row
            del full, slabs, x, ep, tp, diff
            torch.cuda.empty_cache()
    b16, f32 = res["bfloat16"], res["float32"]
    log(f"EP {cfg.name} layer 0 on {N_PODS} x {LANES} stacked ranks "
        f"({E // D} experts, {EP_TOKENS} tokens a rank): bf16 at capacity "
        f"factor {cfg.capacity_factor}: nap3 == flat bit for bit, logs "
        f"2 x {all_to_all_signature('nap3')} / 2 x "
        f"{all_to_all_signature('flat')}; {b16['ms_nap3']:.2f} / "
        f"{b16['ms_flat']:.2f} ms (nap3 / flat, wall)")
    for name, row in (("bf16", b16), ("f32", f32)):
        log(f"  {name}, nothing dropped (capacity factor "
            f"{row['capacity_factor']:.3f}: at most {row['max_per_rank_expert']}"
            f" selections a (rank, expert), {row['max_per_expert']} an "
            f"expert): EP vs TP max |diff| {row['max_abs_err']:.3e} (max|y| "
            f"{row['max_abs_y']:.3e}); EP {row['ms_ep_nodrop']:.2f} ms, TP "
            f"{row['ms_tp_nodrop']:.2f} ms (wall)")
    return res


def moe_phase() -> tuple[dict, dict]:
    """Both MoE archs at full width and ``MOE_LAYERS`` layers served in bf16
    on the first ``MOE_REQUESTS`` prompts of :func:`lm_workload` (drawn in
    each arch's vocab; :func:`lm_serve`: flash launched layers x batches
    times), each checked routing-aware (:func:`moe_check`); then the EP
    phase on qwen3-moe's layer 0.  Returns the runs' numbers and their
    flash launches."""
    from repro_torch.configs import get_arch

    runs, flash = {}, {}
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=MOE_LAYERS)
        prompts = lm_workload(cfg.vocab)[:MOE_REQUESTS]
        run = lm_serve(cfg, prompts, torch.bfloat16)
        runs[arch] = {**run["info"], **moe_check(cfg, run)}
        flash[f"{arch} bfloat16"] = flash_counts(run)
        if arch == EP_ARCH:
            ffn = {key: run["model"].layers[0]["ffn"][key].detach()
                   for key in ("router", "gate", "up", "down")}
        del run
        torch.cuda.empty_cache()
    runs["ep"] = moe_ep_phase(ffn, dataclasses.replace(
        get_arch(EP_ARCH), n_layers=MOE_LAYERS))
    return runs, flash


def prompt_tokens(prompts) -> torch.Tensor:
    """The prompts as the engine prefills them in one batch (left-padded
    with token 0, or embedding prompts with zero rows), on the card."""
    from repro_torch.serve import Request
    from repro_torch.serve.engine import pad_prompts

    return torch.as_tensor(pad_prompts([Request(rid=i, prompt=p) for i, p in
                                        enumerate(prompts)]), device=DEVICE)


def mlstm_pad_decay(p, cfg, x, C) -> float:
    """The reference's pad decay, kept by the port: ||C|| of the prefill's
    returned state (after the zero pad to a multiple of the 256-step chunk)
    over ||C|| after the same S steps of ``mlstm_decode``."""
    from repro_torch.models.ssm import MLSTM_CHUNK, mlstm_decode

    B, S, d = x.shape
    H = cfg.n_heads
    state = (torch.zeros((B, H, d // H, d // H), device=x.device),
             torch.zeros((B, H, d // H), device=x.device))
    for t in range(S):
        _, state = mlstm_decode(p, cfg, x[:, t:t + 1], state)
    ratio = float(torch.linalg.vector_norm(C) / torch.linalg.vector_norm(state[0]))
    log(f"  mlstm pad decay: the prefill's C over {S} decode steps' C: {ratio:.3e} "
        f"({(-S) % min(MLSTM_CHUNK, S)} pad steps)")
    return ratio


def recurrent_layer_check(model, cfg, prompts, dtype) -> dict:
    """One layer of each recurrent kind of ``model`` (its first of that
    kind) at the served shapes, in ``dtype`` against the same code in
    float64 on the card (its weights and input widened exactly): the
    output's and the returned state's error over their max magnitude, and
    the layer's wall ms in each type.  The input is the served batch's
    embedded prompts through the layer's norm."""
    from repro_torch.models.layers import make_norm
    from repro_torch.models.ssm import recurrent_forward

    tokens = prompt_tokens(prompts)
    res = {}
    with torch.inference_mode():
        emb = model.embed_inputs(tokens)
        for kind in dict.fromkeys(k for k in model.kinds if k != "attn"):
            layer = model.layers[model.kinds.index(kind)]
            x = make_norm(cfg.norm)(layer["ln1"], emb)
            p = {name: t.detach() for name, t in layer["core"].named_parameters()}
            runs = {}
            for dt, pp, xx in ((dtype, p, x),
                               (torch.float64, {k: t.double() for k, t in p.items()},
                                x.double())):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[dt] = recurrent_forward(pp, cfg, kind, xx)
                torch.cuda.synchronize()
                runs[dt] += ((time.perf_counter() - t0) * 1e3,)
            (y, st, ms), (y64, st64, ms64) = runs[dtype], runs[torch.float64]
            check(y.dtype == dtype and tuple(y.shape) == tuple(x.shape)
                  and bool(torch.isfinite(y).all()),
                  f"{kind} layer: {y.dtype} {tuple(y.shape)}, finite "
                  f"{bool(torch.isfinite(y).all())}")
            err = float((y.double() - y64).abs().max() / y64.abs().max())
            st_err = {n: float((st[n].double() - st64[n]).abs().max()
                               / st64[n].abs().max().clamp_min(1e-300))
                      for n in st}
            tol = LAYER_RTOL[dtype]
            check(err <= tol, f"{kind} layer ({dtype}) against float64: "
                  f"{err:.3e} of max|y|, above {tol:g}")
            res[kind] = {"layer": model.kinds.index(kind), "rel_err": err,
                         "state_rel_err": st_err, "ms": ms, "ms_float64": ms64,
                         "max_abs_y": float(y64.abs().max())}
            if kind == "mlstm":
                res[kind]["pad_decay"] = mlstm_pad_decay(p, cfg, x, st["C"])
            log(f"  {kind} layer {res[kind]['layer']} ({str(dtype)[6:]}) against "
                f"float64 on the card: y {err:.2e} of max|y|, state "
                + ", ".join(f"{n} {e:.2e}" for n, e in st_err.items())
                + f"; {ms:.1f} ms ({ms64:.1f} ms in float64)")
            del runs, y, y64, st, st64, x
    return res


def hidden_drift(model, cfg, prompts) -> list[float]:
    """``LM.forward``'s prefill walked twice, layer by layer, the attention
    through the kernel in one walk and its plain version in the other, each
    walk fed its own previous output: after each layer, max|x_kernel -
    x_plain| over max|x_plain|.  Where a kernel-vs-plain difference enters
    (the attention layers) and how the layers after it carry it."""
    from repro_torch.models.model import block_forward

    tokens = prompt_tokens(prompts)
    drift = []
    with torch.inference_mode():
        xk = xp = model.embed_inputs(tokens)
        positions = torch.arange(xk.shape[1], dtype=torch.int32, device=xk.device)
        for kind, layer in zip(model.kinds, model.layers):
            xk, _ = block_forward(layer, cfg, kind, xk, positions, True)
            xp, _ = block_forward(layer, cfg, kind, xp, positions, False)
            drift.append(float((xk - xp).abs().max()) / float(xp.abs().max()))
    return drift


def recurrent_phase() -> tuple[dict, dict]:
    """The recurrent archs at full width and depth (:data:`RECURRENT_RUNS`),
    each served on the first ``RECURRENT_REQUESTS`` prompts of
    :func:`lm_workload` (drawn in its vocab; :func:`lm_serve`: flash
    launched once a prefill batch by each attention layer: 12 for
    recurrentgemma-9b, none for xlstm-125m), checked kernel vs plain
    (:func:`lm_check`) and one layer of each recurrent kind against float64
    (:func:`recurrent_layer_check`); each model freed before the next.
    Returns the runs' numbers and their flash launches."""
    from repro_torch.configs import get_arch

    runs, flash = {}, {}
    for arch, dtype in RECURRENT_RUNS:
        cfg = get_arch(arch)
        prompts = lm_workload(cfg.vocab)[:RECURRENT_REQUESTS]
        run = lm_serve(cfg, prompts, dtype)
        key = f"{arch} {str(dtype).replace('torch.', '')}"
        runs[key] = {**run["info"],
                     "layers_vs_float64": recurrent_layer_check(
                         run["model"], cfg, prompts, dtype)}
        if "attn" in run["model"].kinds:
            drift = hidden_drift(run["model"], cfg, prompts)
            runs[key]["hidden_drift"] = drift
            log(f"  kernel vs plain walks, hidden state after each layer over "
                f"max|x|: " + " ".join(f"{k[0]}{e:.1e}" for k, e in
                                       zip(run["model"].kinds, drift)))
        runs[key].update(lm_check(cfg, run, dtype))
        flash[key] = flash_counts(run)
        del run
        torch.cuda.empty_cache()
    return runs, flash


def flash_counts(run) -> dict:
    """A serving run's flash launches: all of them (``flash_attention``, the
    wrapper) and the Hopper kernel's (``flash_attention_wgmma``)."""
    return {k: run["info"]["launches"][k] for k in FLASH_KERNELS}


def embed_flash_shapes(S: int) -> list[tuple]:
    """phi-3-vision-4.2b's prefill shape: 32 query heads on 32 KV heads of
    96 (the head-dim-96 instances), in f32 and bf16."""
    return [("phi-3-vision prefill", LM_BATCH, 32, 32, S, S, 96, None)]


def embed_workload(cfg, n: int) -> list[np.ndarray]:
    """The stub frontend's prompts: standard normal embeddings ``[S, d]``
    drawn from SEED at the lengths of :func:`lm_workload`'s first ``n``."""
    lengths = [len(p) for p in lm_workload(cfg.vocab)[:n]]
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal((m, cfg.d_model)).astype(np.float32)
            for m in lengths]


def embed_phase() -> tuple[dict, dict]:
    """The embedding-input archs at full width and depth
    (:data:`EMBED_RUNS`), each served on :func:`embed_workload`'s prompts
    (:func:`lm_serve`: flash launched once a prefill batch by each of their
    attention layers: 32 for phi-3-vision-4.2b, 48 for musicgen-medium),
    checked kernel vs plain teacher-forced (:func:`lm_check`); each model
    freed before the next.  Returns the runs' numbers and their flash
    launches."""
    from repro_torch.configs import get_arch

    runs, flash = {}, {}
    for arch, dtype in EMBED_RUNS:
        cfg = get_arch(arch)
        prompts = embed_workload(cfg, EMBED_REQUESTS)
        run = lm_serve(cfg, prompts, dtype)
        key = f"{arch} {str(dtype).replace('torch.', '')}"
        runs[key] = dict(run["info"])
        if dtype == torch.bfloat16:
            drift = hidden_drift(run["model"], cfg, prompts)
            runs[key]["hidden_drift"] = drift
            runs[key]["bf16_vs_f32"] = bf16_yardstick(run["model"], prompts)
            log(f"  kernel vs plain walks, hidden state after each layer over "
                f"max|x|: " + " ".join(f"{e:.1e}" for e in drift)
                + f"; plain bf16 against the same weights in f32, prefill "
                f"logits: {runs[key]['bf16_vs_f32']:.2e} of max|logits|")
        runs[key].update(lm_check(cfg, run, dtype))
        flash[key] = flash_counts(run)
        del run
        torch.cuda.empty_cache()
    return runs, flash


def bf16_yardstick(model, prompts) -> float:
    """How far bfloat16 itself moves the plain prefill logits: ``model``
    (bf16) against a float32 copy of the same weights, both plain, over
    max|logits|."""
    x = prompt_tokens(prompts)
    with torch.inference_mode():
        lb = model(x, use_kernel=False).float()
        m32 = copy.deepcopy(model).float()
        lf = m32(x, use_kernel=False)
        del m32
        err = float((lb - lf).abs().max()) / float(lf.abs().max())
    torch.cuda.empty_cache()
    return err


def periodic_tokens(path: str, vocab: int) -> str:
    """A token file of one PERIOD-token sequence (drawn from SEED in
    ``vocab``) repeated: every training window is a shift of it."""
    from repro_torch.train.data import write_token_file

    base = np.random.default_rng(SEED).integers(0, vocab, PERIOD, dtype=np.int32)
    write_token_file(path, np.tile(base, 2048))
    return path


def timed_steps(step, model, opt, batches) -> tuple[dict, object, list]:
    """Run ``step`` over ``batches`` (tensors on the card, three or more),
    each synchronised: the first warm and untimed, then wall ms a step (the
    median over every step but the first and the last; ``timed_steps``
    says how many), tokens/s, peak GiB, and the device ms of the last step
    from ``torch.profiler`` (its busy share of the median wall time).
    Returns (numbers, opt state, losses)."""
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = walls[1:]
    res = {}

    def last():
        res["out"] = step(model, opt, batches[-1])

    prof = device_profile(last)
    _, opt, m = res["out"]
    losses.append(float(m["loss"]))
    dev_ms = sum(v[0] for v in prof.values())
    wall = float(np.median(walls))
    tokens = int(batches[0]["targets"].numel())
    info = {"ms_per_step": wall, "timed_steps": len(walls), "tokens_per_step": tokens,
            "tokens_per_s": tokens / wall * 1e3,
            "device_ms_per_step": dev_ms if prof else None,
            "busy_share": dev_ms / wall if prof else None,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "top_device": [[kn[:80], km, kc] for kn, (km, kc) in sorted(
                prof.items(), key=lambda kv: -kv[1][0])[:5]]}
    return info, opt, losses


def leaf_errs(got: dict, want: dict) -> float:
    """The largest over leaves of max|got - want| over max|want|."""
    worst = 0.0
    for n, w in want.items():
        scale = float(w.double().abs().max()) or 1.0
        worst = max(worst, float((got[n].double() - w.double()).abs().max()) / scale)
    return worst


@contextlib.contextmanager
def counting_chunked():
    """Count the calls of ``models.attention.chunked_attention`` (the train
    forward's attention past 1024 keys) while the block runs."""
    import repro_torch.models.attention as attention

    calls = collections.Counter()
    plain_chunked = attention.chunked_attention

    def counting(*a, **kw):
        calls["chunked_attention"] += 1
        return plain_chunked(*a, **kw)

    attention.chunked_attention = counting
    try:
        yield calls
    finally:
        attention.chunked_attention = plain_chunked


def f64_step_check(cfg, batch, remat: bool = False) -> dict:
    """One train step at full width, F64_LAYERS layers, in float32 and the
    same code in float64 on the card (the float32 model's weights widened
    exactly, float64 moments): loss, grad norm, m and v.  With ``remat``
    the float32 step runs with remat and the float64 one without, so a
    batch past 1024 positions holds ``chunked_attention``'s forward, its
    checkpointed steps' recompute and their backward under remat's
    recompute to float64."""
    from repro_torch.models import init_lm
    from repro_torch.train import AdamWConfig, TrainOptions, init_opt_state, make_step_fn

    cfg2 = dataclasses.replace(cfg, n_layers=F64_LAYERS)
    runs = {}
    m32 = init_lm(cfg2, seed=SEED, dtype=torch.float32, device=DEVICE, trainable=True)
    m64 = copy.deepcopy(m32).to(torch.float64)      # before the step moves m32
    seq = int(batch["targets"].shape[1])
    for dt, model, rm in ((torch.float32, m32, remat), (torch.float64, m64, False)):
        step = make_step_fn(cfg2, AdamWConfig(), TrainOptions(remat=rm))
        opt = init_opt_state(dict(model.named_parameters()), moment_dtype=dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_chunked() as calls:
            _, opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        runs[dt] = (float(m["loss"]), float(m["grad_norm"]), opt,
                    (time.perf_counter() - t0) * 1e3, calls["chunked_attention"])
    (l32, g32, o32, ms32, c32), (l64, g64, o64, ms64, c64) = \
        runs[torch.float32], runs[torch.float64]
    if seq > 1024:
        check(c32 >= F64_LAYERS and c64 >= F64_LAYERS,
              f"f32 vs f64 at seq {seq}: chunked_attention ran {c32} / {c64} times")
    errs = {"loss": abs(l32 - l64) / abs(l64), "grad_norm": abs(g32 - g64) / g64,
            "m": leaf_errs(o32["m"], o64["m"]), "v": leaf_errs(o32["v"], o64["v"])}
    for k, e in errs.items():
        check(e <= F64_RTOL[k], f"train step f32 vs f64 at {F64_LAYERS} layers, "
              f"seq {seq}: {k} {e:.3e} above {F64_RTOL[k]:g}")
    log(f"  step f32{' (remat)' if remat else ''} vs f64 ({F64_LAYERS} layers, full width, "
        f"seq {seq}): loss {errs['loss']:.2e}, grad norm {errs['grad_norm']:.2e}, "
        f"m {errs['m']:.2e}, v {errs['v']:.2e} (loss {l32:.6f} / {l64:.6f}; "
        f"{ms32:.1f} / {ms64:.1f} ms; chunked_attention {c32} / {c64} calls)")
    return {**errs, "seq": seq, "remat": remat, "loss_f32": l32, "loss_f64": l64,
            "ms_f32": ms32, "ms_f64": ms64, "chunked_attention_calls": [c32, c64]}


def plain_attention(q, k, v, causal=True, window=None, chunk=None,
                    q_offset=0):
    """``chunked_attention``'s signature over the plain softmax attention of
    all keys at once (q/k/v ``[B, S, H, D]``, the queries at the keys'
    positions: ``q_offset`` 0)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    check(q_offset == 0 and q.shape[1] == k.shape[1],
          f"plain_attention: queries at offset {q_offset}")
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)


def carried_long_check(cfg, model, opt, batches) -> dict:
    """One train step at LONG_SEQ with remat from the periodic run's state
    (``model``, its parameters kept on the host between the two runs, and
    its AdamW state ``opt``, which a step does not change), with
    ``chunked_attention`` and again with the plain attention over all keys: loss, grad norm, moments and the loss of ``batches[1]`` after the
    update (``CARRIED_RTOL``).  From this state the seq-2048 steps overshoot
    (``scripts/long_step_probe.py``), so a wrong long-sequence backward
    would part the two here."""
    import repro_torch.models.attention as attention
    from repro_torch.models.model import loss_fn
    from repro_torch.train import AdamWConfig, TrainOptions, make_step_fn

    t0 = time.perf_counter()
    params = dict(model.named_parameters())
    kept = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    step = make_step_fn(cfg, AdamWConfig(warmup_steps=1, total_steps=LONG_STEPS),
                        TrainOptions(remat=True))
    runs = {}
    for name in ("chunked", "plain"):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(kept[n])
        with counting_chunked() as calls:
            if name == "plain":      # the counting wrapper comes back on exit
                attention.chunked_attention = plain_attention
            _, o, m = step(model, opt, batches[0])
            with torch.no_grad():
                nxt = float(loss_fn(model, cfg, batches[1], use_kernel=False))
        # the first run's moments wait on the host, the second's stay here
        runs[name] = (float(m["loss"]), float(m["grad_norm"]), nxt,
                      {k: {n: t.cpu() if name == "chunked" else t for n, t in o[k].items()}
                       for k in ("m", "v")},
                      calls["chunked_attention"])
        del o
    (lc, gc, nc, oc, cc), (lp, gp, nxp, op, cp) = runs["chunked"], runs["plain"]
    errs = {"loss": abs(lc - lp) / abs(lp), "grad_norm": abs(gc - gp) / gp,
            **{k: leaf_errs({n: t.to(DEVICE) for n, t in oc[k].items()}, op[k])
               for k in ("m", "v")},
            "next_loss": abs(nc - nxp) / abs(nxp)}
    del runs, oc, op
    secs = time.perf_counter() - t0
    check(cc >= cfg.n_layers and cp == 0,
          f"carried seq {LONG_SEQ} step: chunked_attention ran {cc} / {cp} times")
    for k, e in errs.items():
        check(e <= CARRIED_RTOL[k], f"carried seq {LONG_SEQ} step, chunked vs plain "
              f"attention: {k} {e:.3e} above {CARRIED_RTOL[k]:g}")
    log(f"  seq {LONG_SEQ} step carried on from the periodic state, chunked (remat) vs "
        f"plain attention: loss {errs['loss']:.2e}, grad norm {errs['grad_norm']:.2e}, "
        f"m {errs['m']:.2e}, v {errs['v']:.2e}, next batch's loss {errs['next_loss']:.2e} "
        f"(loss {lc:.4f} / {lp:.4f}, next {nc:.4f} / {nxp:.4f}, grad norm {gc:.4g}; "
        f"{secs:.1f} s)")
    return {"errs": errs, "loss": [lc, lp], "next_loss": [nc, nxp],
            "grad_norm": [gc, gp], "chunked_attention_calls": [cc, cp], "s": secs}


def train_phase() -> dict:
    """Training on the card, f32 (TF32 off):

    1. ``repro_torch.launch.train`` at its defaults (batch 8, seq 256) on
       qwen3-1.7b at full width and depth, TRAIN_STEPS steps of random
       tokens; its final checkpoint (the reference's format);
    2. that checkpoint restored into a second model: parameters and moments
       bit-equal to the live ones, and one step of each on the pipeline's
       next batch agreeing (``RESUME_RTOL``); then the live model with one
       microbatch against the restored one with two (``RESUME_RTOL``, the
       moments at ``MOMENT_RTOL``);
    3. TRAIN_TIMED steps timed (ms, tokens/s, device ms, busy share, peak);
    4. a fresh model trained PERIODIC_STEPS steps on a periodic token file:
       the loss falls; from its state one step at LONG_SEQ with
       ``chunked_attention`` against the plain attention
       (:func:`carried_long_check`);
    5. a fresh model trained LONG_STEPS steps on the periodic file at seq
       LONG_SEQ with remat, ``chunked_attention`` counted: the loss falls
       (``scripts/long_step_probe.py`` takes such steps from the periodic
       run's state instead);
    6. the step in f32 against f64 at F64_LAYERS layers
       (:func:`f64_step_check`), at seq 256 and at LONG_SEQ with remat;
    7. xlstm-125m trained XLSTM_STEPS steps on its periodic token file.
    """
    from repro_torch.ckpt.checkpoint import latest_step, restore_train_state
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as ltrain
    from repro_torch.models import init_lm
    from repro_torch.train import (AdamWConfig, DataConfig, TokenPipeline,
                                   TrainOptions, init_opt_state, make_step_fn)
    from repro_torch.train.train_step import to_device

    cfg = get_arch(TRAIN_ARCH)
    res = {"arch": cfg.name, "dtype": "float32", "layers": cfg.n_layers,
           "d_model": cfg.d_model}
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        # 1. the launcher
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, opt, hist = ltrain.main(["--arch", TRAIN_ARCH, "--steps",
                                        str(TRAIN_STEPS), "--ckpt", tmp,
                                        "--device", DEVICE])
        res["launcher"] = {"wall_s": time.perf_counter() - t0, "losses": hist,
                           "batch": 8, "seq": 256,
                           "params": sum(p.numel() for p in model.parameters()),
                           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        check(len(hist) == TRAIN_STEPS and np.isfinite(hist).all(),
              f"launcher losses {hist}")
        check(latest_step(tmp) == TRAIN_STEPS, f"latest step {latest_step(tmp)}")
        npz = Path(tmp) / f"step_{TRAIN_STEPS:09d}.npz"
        res["launcher"]["checkpoint_gb"] = npz.stat().st_size / 2**30
        log(f"train {cfg.name} f32 via the launcher ({res['launcher']['params'] / 1e9:.3f}B "
            f"params, batch 8 x seq 256): {TRAIN_STEPS} steps in "
            f"{res['launcher']['wall_s']:.1f} s (init and the final checkpoint of "
            f"{res['launcher']['checkpoint_gb']:.1f} GiB included), losses "
            f"{[round(x, 4) for x in hist]}, peak {res['launcher']['peak_gb']:.1f} GiB")

        # 2. resume and microbatches from the checkpoint
        t0 = time.perf_counter()
        model2 = init_lm(cfg, seed=SEED + 1, dtype=torch.float32, device=DEVICE,
                         trainable=True)
        opt2 = restore_train_state(cfg, model2, init_opt_state(dict(
            model2.named_parameters())), tmp, TRAIN_STEPS)
        t_restore = time.perf_counter() - t0
        p1, p2 = dict(model.named_parameters()), dict(model2.named_parameters())
        same = (all(torch.equal(p1[n], p2[n]) for n in p1)
                and all(torch.equal(opt[k][n], opt2[k][n]) for k in ("m", "v")
                        for n in p1) and int(opt2["count"]) == TRAIN_STEPS)
        check(same, "the restored train state is not the live one")
        del p1, p2
        pipe = TokenPipeline(DataConfig(seq_len=256, global_batch=8, vocab=cfg.vocab))
        acfg = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)   # the launcher's
        step1 = make_step_fn(cfg, acfg, TrainOptions(remat=False))
        step2 = make_step_fn(cfg, acfg, TrainOptions(remat=False, microbatches=2))
        checks = {}
        for name, (sa, sb), at in (("resume", (step1, step1), TRAIN_STEPS),
                                   ("microbatches", (step1, step2), TRAIN_STEPS + 1)):
            batch = to_device(pipe.batch_at(at), DEVICE)
            model, opt, ma = sa(model, opt, batch)
            model2, opt2, mb = sb(model2, opt2, batch)
            e = {"loss": abs(float(ma["loss"]) - float(mb["loss"])) / abs(float(ma["loss"])),
                 "grad_norm": abs(float(ma["grad_norm"]) - float(mb["grad_norm"]))
                 / float(ma["grad_norm"]),
                 "m": leaf_errs(opt2["m"], opt["m"]), "v": leaf_errs(opt2["v"], opt["v"])}
            check(e["loss"] <= RESUME_RTOL and e["grad_norm"] <= RESUME_RTOL
                  and e["m"] <= MOMENT_RTOL and e["v"] <= MOMENT_RTOL,
                  f"{name}: {e}")
            checks[name] = e
            log(f"  {name}: step {at} of the live model against the restored one"
                + (" (2 microbatches)" if name == "microbatches" else "")
                + f": loss {e['loss']:.2e}, grad norm {e['grad_norm']:.2e}, "
                f"m {e['m']:.2e}, v {e['v']:.2e}")
        res["restore_s"] = t_restore
        res["checks"] = checks
        del model2, opt2
        torch.cuda.empty_cache()

        # 3. timed steps at the launcher's shape
        batches = [to_device(pipe.batch_at(TRAIN_STEPS + 2 + i), DEVICE)
                   for i in range(TRAIN_TIMED)]
        res["timed"], opt, _ = timed_steps(step1, model, opt, batches)
        t = res["timed"]
        log(f"  timed: {t['ms_per_step']:.1f} ms a step (median of {t['timed_steps']}; "
            f"batch 8 x seq 256), "
            f"{t['tokens_per_s']:.0f} tokens/s, device "
            + (f"{t['device_ms_per_step']:.1f} ms a step, busy share {t['busy_share']:.3f}"
               if t["device_ms_per_step"] is not None else "time not measured")
            + f", peak {t['peak_gb']:.1f} GiB")
        del model, opt, batches
        torch.cuda.empty_cache()

        # 4. loss falling on a periodic token file
        model = init_lm(cfg, seed=SEED, dtype=torch.float32, device=DEVICE,
                        trainable=True)
        opt = init_opt_state(dict(model.named_parameters()))
        ppipe = TokenPipeline(DataConfig(
            seq_len=256, global_batch=8, vocab=cfg.vocab,
            token_file=periodic_tokens(f"{tmp}/periodic.bin", cfg.vocab)))
        step = make_step_fn(cfg, AdamWConfig(warmup_steps=1,
                                             total_steps=PERIODIC_STEPS),
                            TrainOptions(remat=False))
        _, opt, losses = timed_steps(step, model, opt, [
            to_device(ppipe.batch_at(i), DEVICE) for i in range(PERIODIC_STEPS)])
        check(np.isfinite(losses).all() and losses[-1] < (1 - LOSS_FALL) * losses[0],
              f"periodic tokens: losses {losses} do not fall by {LOSS_FALL:g} "
              f"of the first")
        res["periodic_losses"] = losses
        log(f"  periodic token file (period {PERIOD}): losses "
            f"{[round(x, 4) for x in losses]}")
        lpipe = TokenPipeline(DataConfig(
            seq_len=LONG_SEQ, global_batch=LONG_BATCH, vocab=cfg.vocab,
            token_file=f"{tmp}/periodic.bin"))
        res["carried_long"] = carried_long_check(
            cfg, model, opt, [to_device(lpipe.batch_at(i), DEVICE) for i in range(2)])

        del model, opt
        torch.cuda.empty_cache()

        # 5. long sequences with remat: chunked_attention
        model = init_lm(cfg, seed=SEED, dtype=torch.float32, device=DEVICE,
                        trainable=True)
        opt = init_opt_state(dict(model.named_parameters()))
        with counting_chunked() as calls:
            lstep = make_step_fn(cfg, AdamWConfig(warmup_steps=1,
                                                  total_steps=LONG_STEPS),
                                 TrainOptions(remat=True))
            res["long"], opt, llosses = timed_steps(lstep, model, opt, [
                to_device(lpipe.batch_at(i), DEVICE) for i in range(LONG_STEPS)])
        n_attn = cfg.n_layers
        check(calls["chunked_attention"] >= n_attn * LONG_STEPS and np.isfinite(llosses).all()
              and llosses[-1] < (1 - LOSS_FALL) * llosses[0],
              f"seq {LONG_SEQ} with remat: chunked_attention ran "
              f"{calls['chunked_attention']} times, losses {llosses} (must fall by "
              f"{LOSS_FALL:g} of the first)")
        res["long"].update(seq=LONG_SEQ, batch=LONG_BATCH, losses=llosses,
                           chunked_attention_calls=calls["chunked_attention"])
        t = res["long"]
        log(f"  seq {LONG_SEQ} x batch {LONG_BATCH} with remat: {t['ms_per_step']:.1f} ms "
            f"a step (median of {t['timed_steps']}), {t['tokens_per_s']:.0f} tokens/s, busy share "
            + (f"{t['busy_share']:.3f}" if t["busy_share"] is not None else "not measured")
            + f", peak {t['peak_gb']:.1f} GiB, chunked_attention {calls['chunked_attention']} "
            f"calls (forward and the remat recompute), losses {[round(x, 4) for x in llosses]}")
        del model, opt
        torch.cuda.empty_cache()

        # 6. float32 against float64 at 2 layers, at seq 256 and at LONG_SEQ
        # with remat (chunked_attention's backward)
        res["f64"] = f64_step_check(cfg, to_device(pipe.batch_at(0), DEVICE))
        res["f64_long"] = f64_step_check(cfg, to_device(lpipe.batch_at(0), DEVICE),
                                         remat=True)
        torch.cuda.empty_cache()

        # 7. xlstm-125m
        xcfg = get_arch(XLSTM_ARCH)
        model = init_lm(xcfg, seed=SEED, dtype=torch.float32, device=DEVICE,
                        trainable=True)
        opt = init_opt_state(dict(model.named_parameters()))
        xpipe = TokenPipeline(DataConfig(
            seq_len=256, global_batch=8, vocab=xcfg.vocab,
            token_file=periodic_tokens(f"{tmp}/xlstm.bin", xcfg.vocab)))
        xstep = make_step_fn(xcfg, AdamWConfig(warmup_steps=1, total_steps=XLSTM_STEPS),
                             TrainOptions(remat=False))
        res["xlstm"], _, xl = timed_steps(xstep, model, opt, [
            to_device(xpipe.batch_at(i), DEVICE) for i in range(XLSTM_STEPS)])
        check(np.isfinite(xl).all(), f"xlstm losses {xl}")
        res["xlstm"].update(arch=xcfg.name, losses=xl,
                            params=sum(p.numel() for p in model.parameters()))
        t = res["xlstm"]
        log(f"  {xcfg.name} f32 (batch 8 x seq 256, periodic tokens): "
            f"{t['ms_per_step']:.1f} ms a step (median of {t['timed_steps']}), "
            f"{t['tokens_per_s']:.0f} tokens/s, "
            f"busy share " + (f"{t['busy_share']:.3f}" if t["busy_share"] is not None
                              else "not measured")
            + f", peak {t['peak_gb']:.1f} GiB, losses {[round(x, 4) for x in xl]}")
        del model, opt
        torch.cuda.empty_cache()
    return res


def train_fits(cfg, card_gib: float = CARD_GIB) -> tuple[bool, float]:
    """(whether ``cfg``'s training state leaves TRAIN_HEADROOM_GIB of a
    ``card_gib`` card, the state's GiB): f32 weights, gradients, m and v,
    TRAIN_BYTES_PER_PARAM a parameter, counted on an
    ``init_lm(trainable=True)`` made under ``FakeTensorMode`` (no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_lm

    with FakeTensorMode():
        model = init_lm(cfg, seed=SEED, dtype=torch.float32, device="cpu",
                        trainable=True)
        gib = sum(p.numel() for p in model.parameters()) * TRAIN_BYTES_PER_PARAM / 2**30
    return gib + TRAIN_HEADROOM_GIB <= card_gib, gib


@contextlib.contextmanager
def moe_drops():
    """Hand a stats dict to every ``moe_ffn_tp`` call the LM makes while the
    block runs (``repro_torch.models.model``'s name for it); yields the
    dict: (token, slot) selections (``"selected"``) and the ones the
    capacity dropped (``"dropped"``, on the device)."""
    import repro_torch.models.model as lm_model

    stats: dict = {}
    plain = lm_model.moe_ffn_tp

    def counting(p, cfg, x, moe_stats=None):
        return plain(p, cfg, x, stats)

    lm_model.moe_ffn_tp = counting
    try:
        yield stats
    finally:
        lm_model.moe_ffn_tp = plain


def dropped_share(stats: dict) -> float | None:
    return (float(stats["dropped"]) / stats["selected"] if stats.get("selected")
            else None)


@contextlib.contextmanager
def moe_routes(model, replay: dict | None = None):
    """Record the experts each MoE layer of ``model`` picks while the block
    runs (``repro_torch.models.moe._route`` wrapped: the selections ``sel``
    [T, k] by router name), or, given ``replay`` (such a record), make each
    layer take the recorded experts: its own router's probabilities at them,
    renormalised, as :func:`moe_forced` takes them, the capacity then
    applied in token order by ``moe_ffn_tp`` itself.  Yields the record
    ``{"sel", "flips", "picks"}``: in a replay, ``flips`` counts the
    (token, expert) picks the layer's own top-k would have made that the
    record does not hold, out of ``picks``.  A layer routed again (remat's
    recompute) keeps its first record and count."""
    import repro_torch.models.moe as moe

    names = {id(p): n for n, p in model.named_parameters()
             if n.endswith(".router")}
    plain = moe._route
    rec = {"sel": {}, "flips": 0, "picks": 0}

    def route(x2, router, top_k):
        name = names[id(router)]
        if replay is None:
            probs, sel = plain(x2, router, top_k)
        else:
            sel = replay["sel"][name].to(x2.device)
            full = torch.softmax(x2.float() @ router, dim=-1)
            probs = full.gather(1, sel)
            probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
            if name not in rec["sel"]:
                own = torch.topk(full.detach(), top_k, dim=-1).indices
                rec["flips"] += int((own[:, :, None] != sel[:, None, :]).all(-1).sum())
                rec["picks"] += own.numel()
        rec["sel"].setdefault(name, sel.detach().clone())
        return probs, sel

    moe._route = route
    try:
        yield rec
    finally:
        moe._route = plain


def free_memory() -> None:
    """Collect garbage (tensors held only by reference cycles) and return
    the card's cached blocks: a full-width training state leaves little
    of the card to an earlier phase's leftovers."""
    gc.collect()
    torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def widened_model(cfg, device=DEVICE):
    """``init_lm(cfg, seed=SEED)``'s float32 weights in a float64 model
    (``init_lm(dtype=float64)``: the routers stay float32, as the port keeps
    them in every type), widened exactly."""
    from repro_torch.models import init_lm

    m64 = init_lm(cfg, seed=SEED, dtype=torch.float64, device=device,
                  trainable=True)
    src = init_lm(cfg, seed=SEED, dtype=torch.float32, device=device)
    with torch.no_grad():
        for (n, p), (n2, q) in zip(m64.named_parameters(), src.named_parameters()):
            check(n == n2, f"widened_model: {n} against {n2}")
            p.copy_(q)
    return m64


def f64_family_check(cfg, batch, remat: bool = False, loss_chunk: int | None = None,
                     device=DEVICE) -> dict:
    """One train step of ``cfg`` from ``init_lm(seed=SEED)``'s weights in
    float32 against the same code in float64, one after the other (both
    models and both moment sets do not fit the card at once): the float32
    step (donated moments, ``remat`` and ``loss_chunk`` as given) records
    its MoE routes and leaves its loss, grad norm, m and v on the host; the
    float64 model (:func:`widened_model`) takes the float32 run's routes
    (:func:`moe_routes`) and its loss and gradients through ``loss_fn``
    without remat, ``global_norm`` and the clip; from zero moments one
    AdamW step makes m = (1-b1)·ĝ and v = (1-b2)·ĝ² of the clipped gradient
    ĝ, so each float64 leaf's m and v are made so, leaf by leaf, beside the
    float32 step's own.  Held at F64_RTOL: loss, grad norm, and every m and
    v leaf over its max; the routers' leaves (float32 in both models) are
    also reported alone.  Past 1024 positions ``chunked_attention`` must
    run in both."""
    from repro_torch.models import init_lm
    from repro_torch.models.model import layer_kind, loss_fn
    from repro_torch.train import AdamWConfig, TrainOptions, init_opt_state, make_step_fn
    from repro_torch.train.optimizer import global_norm

    acfg = AdamWConfig()
    seq = int(batch["targets"].shape[1])
    t_start = time.perf_counter()
    m32 = init_lm(cfg, seed=SEED, dtype=torch.float32, device=device, trainable=True)
    opt = init_opt_state(dict(m32.named_parameters()))
    step = make_step_fn(cfg, acfg, TrainOptions(remat=remat, loss_chunk=loss_chunk),
                        donate=True)
    _sync(device)
    t0 = time.perf_counter()
    with moe_routes(m32) as routes, counting_chunked() as calls:
        _, opt, met = step(m32, opt, batch)
    _sync(device)
    ms32 = (time.perf_counter() - t0) * 1e3
    l32, g32, c32 = float(met["loss"]), float(met["grad_norm"]), calls["chunked_attention"]
    host = {k: {n: t.to("cpu") for n, t in opt[k].items()} for k in ("m", "v")}
    del m32, opt, met, step
    free_memory()

    m64 = widened_model(cfg, device)
    names, leaves = zip(*m64.named_parameters())
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with moe_routes(m64, replay=routes) as forced, counting_chunked() as calls:
        loss = loss_fn(m64, cfg, batch, use_kernel=False, remat=False,
                       loss_chunk=loss_chunk)
        grads = dict(zip(names, torch.autograd.grad(loss, list(leaves))))
    l64 = float(loss.detach())
    del loss, m64, leaves       # the gradients stay, the weights (held by the graph too) go
    gnorm = global_norm(grads)
    scale = torch.clamp(acfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    _sync(device)
    ms64 = (time.perf_counter() - t0) * 1e3
    g64, c64 = float(gnorm), calls["chunked_attention"]
    errs = {"loss": abs(l32 - l64) / abs(l64), "grad_norm": abs(g32 - g64) / g64,
            "m": 0.0, "v": 0.0}
    router = {"m": 0.0, "v": 0.0}

    def absmax(t) -> float:
        lo, hi = torch.aminmax(t)
        return max(-float(lo), float(hi))

    with torch.no_grad():
        for n in names:         # three float64 temporaries the size of a leaf
            g = grads.pop(n).to(torch.float64).mul_(scale.to(torch.float64))
            for k, b in (("m", acfg.b1), ("v", acfg.b2)):
                want = (1 - b) * g
                if k == "v":
                    want.mul_(g)
                got = host[k].pop(n).to(device).double().sub_(want)
                e = absmax(got) / (absmax(want) or 1.0)
                errs[k] = max(errs[k], e)
                if n.endswith(".router"):
                    router[k] = max(router[k], e)
                del got, want
            del g
    del grads
    free_memory()
    n_attn = sum(layer_kind(cfg, i) == "attn" for i in range(cfg.n_layers))
    if seq > 1024 and n_attn:
        check(c32 >= n_attn and c64 >= n_attn,
              f"{cfg.name} f32 vs f64 at seq {seq}: chunked_attention ran {c32} / {c64} times")
    res = {**errs, "router": router, "seq": seq, "batch": int(batch["targets"].shape[0]),
           "layers": cfg.n_layers, "remat": remat, "loss_chunk": loss_chunk,
           "loss_f32": l32, "loss_f64": l64, "grad_norm_f32": g32, "ms_f32": ms32,
           "ms_f64": ms64, "chunked_attention_calls": [c32, c64],
           "route_flips": forced["flips"], "route_picks": forced["picks"],
           "peak_gb_f64": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
           "s": time.perf_counter() - t_start}
    for k, e in errs.items():
        check(e <= F64_RTOL[k], f"{cfg.name} train step f32 vs f64 at {cfg.n_layers} "
              f"layers, seq {seq}: {k} {e:.3e} above {F64_RTOL[k]:g} (router m "
              f"{router['m']:.3e}, v {router['v']:.3e})")
    return res


def family_long_step(cfg) -> dict:
    """One step of ``cfg`` (recurrentgemma-9b at its training depth) at
    batch 1 x LONG_FAMILY_SEQ with remat and the loss streamed over
    LONG_FAMILY_CHUNK positions, on random tokens from a fresh model:
    wall ms, peak GiB, the loss finite, ``chunked_attention`` run by every
    attention layer in the forward and again in remat's recompute."""
    from repro_torch.models import init_lm
    from repro_torch.models.model import layer_kind
    from repro_torch.train import (AdamWConfig, DataConfig, TokenPipeline,
                                   TrainOptions, init_opt_state, make_step_fn)
    from repro_torch.train.train_step import to_device

    model = init_lm(cfg, seed=SEED, dtype=torch.float32, device=DEVICE, trainable=True)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_step_fn(cfg, AdamWConfig(warmup_steps=1, total_steps=1),
                        TrainOptions(remat=True, loss_chunk=LONG_FAMILY_CHUNK),
                        donate=True)
    batch = to_device(TokenPipeline(DataConfig(
        seq_len=LONG_FAMILY_SEQ, global_batch=1, vocab=cfg.vocab)).batch_at(0), DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_chunked() as calls:
        _, opt, m = step(model, opt, batch)
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    n_attn = sum(layer_kind(cfg, i) == "attn" for i in range(cfg.n_layers))
    res = {"layers": cfg.n_layers, "batch": 1, "seq": LONG_FAMILY_SEQ, "ms": ms,
           "loss": loss, "grad_norm": float(m["grad_norm"]),
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
           "chunked_attention_calls": calls["chunked_attention"]}
    del model, opt, m
    torch.cuda.empty_cache()
    check(np.isfinite(loss) and calls["chunked_attention"] >= 2 * n_attn,
          f"{cfg.name} seq {LONG_FAMILY_SEQ} with remat: loss {loss}, "
          f"chunked_attention ran {calls['chunked_attention']} times "
          f"({n_attn} attention layers, forward and recompute)")
    return res


def train_family(arch: str, layers: int, tmp: str) -> dict:
    """``arch`` at full width cut to ``layers``, f32 on the card (see
    :func:`train_families_phase`)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.train import (AdamWConfig, DataConfig, TokenPipeline,
                                   TrainOptions, init_opt_state, make_step_fn)
    from repro_torch.train.train_step import to_device

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    fits, state_gib = train_fits(cfg, card_gib)
    check(fits, f"{arch} at {layers} layers: training state {state_gib:.1f} GiB "
          f"+ {TRAIN_HEADROOM_GIB:g} GiB headroom above the card's {card_gib:.1f}")
    opts = TrainOptions(remat=False)
    res = {"arch": arch, "layers": layers, "d_model": cfg.d_model,
           "state_gib": state_gib, "card_gib": card_gib}
    log(f"train {arch} f32 at {layers} layer{'s' * (layers > 1)}, full width "
        f"(training state {state_gib:.1f} GiB of the card's {card_gib:.1f}; no "
        f"remat, microbatches or loss chunks; moments donated)")

    def fresh():
        free_memory()
        model = init_lm(cfg, seed=SEED, dtype=torch.float32, device=DEVICE,
                        trainable=True)
        return model, init_opt_state(dict(model.named_parameters()))

    # 1. timed steps on random tokens at the launcher's shape
    pipe = TokenPipeline(DataConfig(seq_len=256, global_batch=8, vocab=cfg.vocab))
    model, opt = fresh()
    res["params"] = sum(p.numel() for p in model.parameters())
    step = make_step_fn(cfg, AdamWConfig(warmup_steps=1, total_steps=FAMILY_TIMED),
                        opts, donate=True)
    with moe_drops() as drops:
        res["timed"], opt, losses = timed_steps(step, model, opt, [
            to_device(pipe.batch_at(i), DEVICE) for i in range(FAMILY_TIMED)])
    check(np.isfinite(losses).all(), f"{arch} losses {losses}")
    t = res["timed"]
    t.update(losses=losses, dropped_share=dropped_share(drops))
    log(f"  timed: {t['ms_per_step']:.1f} ms a step (median of {t['timed_steps']}; "
        f"batch 8 x seq 256), {t['tokens_per_s']:.0f} tokens/s, device "
        + (f"{t['device_ms_per_step']:.1f} ms a step, busy share {t['busy_share']:.3f}"
           if t["device_ms_per_step"] is not None else "time not measured")
        + f", peak {t['peak_gb']:.1f} GiB"
        + (f", capacity dropped {t['dropped_share']:.4f} of the (token, slot) "
           f"selections" if t["dropped_share"] is not None else "")
        + f"; losses {[round(x, 4) for x in losses]}")
    for kn, km, kc in t["top_device"]:
        log(f"    {km:9.3f} ms {kc:6d}x  {kn}")
    del model, opt, step

    # 2. the loss falls on the periodic token file
    model, opt = fresh()
    ppipe = TokenPipeline(DataConfig(
        seq_len=256, global_batch=8, vocab=cfg.vocab,
        token_file=periodic_tokens(f"{tmp}/{arch}.bin", cfg.vocab)))
    pstep = make_step_fn(cfg, AdamWConfig(warmup_steps=1, total_steps=PERIODIC_STEPS),
                         opts, donate=True)
    with moe_drops() as pdrops:
        res["periodic"], opt, plosses = timed_steps(pstep, model, opt, [
            to_device(ppipe.batch_at(i), DEVICE) for i in range(PERIODIC_STEPS)])
    res["periodic"].update(losses=plosses, dropped_share=dropped_share(pdrops))
    check(np.isfinite(plosses).all() and plosses[-1] < (1 - LOSS_FALL) * plosses[0],
          f"{arch} periodic tokens: losses {plosses} do not fall by {LOSS_FALL:g} "
          f"of the first")
    log(f"  periodic token file (period {PERIOD}): losses "
        f"{[round(x, 4) for x in plosses]}, {res['periodic']['ms_per_step']:.1f} ms a step"
        + (f", capacity dropped {res['periodic']['dropped_share']:.4f}"
           if res["periodic"]["dropped_share"] is not None else ""))
    del model, opt, pstep
    torch.cuda.empty_cache()

    # 3. the step against float64 at FAMILY_F64_LAYERS, the routes forced alike
    free_memory()
    cfg64 = dataclasses.replace(cfg, n_layers=FAMILY_F64_LAYERS[arch])
    res["f64"] = f64_family_check(cfg64, to_device(pipe.batch_at(0), DEVICE),
                                  loss_chunk=FAMILY_F64_CHUNK)
    log_f64(res["f64"])

    # 4. recurrentgemma-9b at seq 4096 with remat, then against float64 there
    if arch == LONG_FAMILY_ARCH:
        res["long"] = family_long_step(cfg)
        t = res["long"]
        log(f"  batch 1 x seq {t['seq']} with remat: {t['ms']:.1f} ms (one step, cold), "
            f"loss {t['loss']:.4f}, peak {t['peak_gb']:.1f} GiB, chunked_attention "
            f"{t['chunked_attention_calls']} calls (forward and the remat recompute)")
        lbatch = to_device(TokenPipeline(DataConfig(
            seq_len=LONG_FAMILY_SEQ, global_batch=1, vocab=cfg.vocab)).batch_at(1), DEVICE)
        res["f64_long"] = f64_family_check(cfg64, lbatch, remat=True,
                                           loss_chunk=LONG_FAMILY_CHUNK)
        log_f64(res["f64_long"])
    res["s"] = time.perf_counter() - t_start
    log(f"  {arch}: {res['s']:.1f} s")
    return res


def log_f64(r: dict) -> None:
    log(f"  step f32{' (remat)' if r['remat'] else ''} vs f64 ({r['layers']} "
        f"layer{'s' * (r['layers'] > 1)}, full width, batch {r['batch']} x seq "
        f"{r['seq']}, loss chunk {r['loss_chunk']}): loss {r['loss']:.2e}, grad norm "
        f"{r['grad_norm']:.2e}, m {r['m']:.2e}, v {r['v']:.2e}"
        + (f" (router m {r['router']['m']:.2e}, v {r['router']['v']:.2e}; routes "
           f"forced, the float64 run's own top-k would have moved {r['route_flips']} "
           f"of {r['route_picks']} picks)" if r["route_picks"] else "")
        + f" (loss {r['loss_f32']:.6f} / {r['loss_f64']:.6f}; {r['ms_f32']:.1f} / "
        f"{r['ms_f64']:.1f} ms; chunked_attention {r['chunked_attention_calls'][0]} / "
        f"{r['chunked_attention_calls'][1]} calls; float64 peak {r['peak_gb_f64']:.1f} GiB; "
        f"{r['s']:.1f} s in all)")


def train_families_phase() -> dict:
    """The MoE and hybrid-recurrent archs trained on the card (f32, TF32
    off, full width), each at the depth FAMILY_RUNS names, refused where
    its training state (:func:`train_fits`) would not leave the headroom:

    1. FAMILY_TIMED steps of random tokens at batch 8 x seq 256
       (:func:`timed_steps`: ms, tokens/s, device ms, busy share, peak GiB),
       with the MoE archs' capacity-dropped share of (token, slot)
       selections (:func:`moe_drops`);
    2. PERIODIC_STEPS on a periodic token file from a fresh model: the loss
       falls by LOSS_FALL of its first;
    3. one step against float64 at FAMILY_F64_LAYERS
       (:func:`f64_family_check`, F64_RTOL; the float64 run takes the
       float32 run's experts, and the picks its own top-k would have moved
       are counted);
    4. recurrentgemma-9b: one step at batch 1 x seq 4096 with remat
       (:func:`family_long_step`), and 3 layers of it at that shape with
       remat against float64 without, ``chunked_attention`` counted.

    The AMG phases' cached sessions (``AMGSolver``'s module-level stores)
    are dropped first, and each model is freed before the next.  Returns
    the runs' numbers."""
    from repro_torch.amg.api.sessions import clear_sessions

    held = torch.cuda.memory_allocated() / 2**30
    clear_sessions()            # the AMG phases' cached sessions and setups
    free_memory()
    res = {"gib_held_before": [held, torch.cuda.memory_allocated() / 2**30]}
    log(f"training families: {held:.2f} GiB held by earlier phases, "
        f"{res['gib_held_before'][1]:.2f} after the AMG session stores are "
        f"cleared and garbage is collected")
    with tempfile.TemporaryDirectory(prefix="families-") as tmp:
        for arch, layers in FAMILY_RUNS:
            res[arch] = train_family(arch, layers, tmp)
    return res


def grad_tree(cfg, rank: int) -> dict:
    """Rank ``rank``'s gradients for one layer of ``cfg`` (its shapes,
    float32 on the card): small integers over 2^10 from a generator seeded
    by the rank, so every sum over the ranks is exact in any order."""
    from repro_torch.models.model import block_params

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 100 + rank)
    shapes = block_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                          "attn", torch.float32, DEVICE)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        g = torch.randn(t.shape, generator=gen, device=DEVICE)
        return torch.round(g * 64) / 1024

    return fill(shapes)


def _flat_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_trees(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def digest(tree) -> str:
    import hashlib

    h = hashlib.sha1()
    for t in _flat_leaves(tree):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


GRAD_SYNC_RUNS = (("flat", "flat", False), ("nap3", "nap3", False),
                  ("int8", "nap3", True))


def grad_sync_rank(ranks) -> dict:
    """One gloo rank of the grad-sync phase: its row of :func:`grad_tree`
    through each run, the result's digest, log, elements sent by (group,
    tag) and wall ms (median of GRAD_SYNC_GLOO_REPS calls)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.nap_collectives import rank_groups
    from repro_torch.train.grad_sync import hier_grad_sync

    mesh = rank_groups(N_PODS, LANES)
    cfg = get_arch(TRAIN_ARCH)
    g = tree_map(lambda t: t[None], grad_tree(cfg, ranks.rank))
    out = {"rank": ranks.rank}
    for name, strategy, compress in GRAD_SYNC_RUNS:
        walls = []
        for rep in range(GRAD_SYNC_GLOO_REPS):
            mesh.reset_tally()
            log_ = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, _ = hier_grad_sync(g, N_PODS, LANES, strategy, compress, log=log_,
                                  ranks=mesh)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"digest": digest(s), "log": log_, "sent": dict(mesh.sent),
                     "ms": float(np.median(walls)),
                     "device": str(_flat_leaves(s)[0].device)}
    return out


def grad_sync_phase() -> dict:
    """``hier_grad_sync`` over one qwen3-1.7b layer's gradient tree
    (:func:`grad_tree`) on the 2 x 4 ranks: stacked on this card (flat,
    nap3, nap3 + int8: each log its legs', nap3 against flat and int8
    against flat at ``GRAD_SYNC_TOL``, ms by CUDA events), then 8 gloo
    processes on ``cuda:0`` (:func:`grad_sync_rank`): every rank's result
    bit-equal to its stacked row, its log the stacked one's, the elements it
    sends over the slow and fast groups beside the model's figures (nap3's
    slow leg 1/|fast| of a slow-group all-reduce of the whole gradient;
    int8 one byte an element of it)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.ranks import spawn
    from repro_torch.train.grad_sync import INT8_TAG, hier_grad_sync

    cfg = get_arch(TRAIN_ARCH)
    rows = [grad_tree(cfg, d) for d in range(N_PODS * LANES)]

    g = _stack_trees(rows)
    del rows
    leaves = _flat_leaves(g)
    n = sum(t[0].numel() for t in leaves)
    piece = sum(-(-t[0].numel() // LANES) for t in leaves)
    res = {"elements_per_rank": n, "leaves": len(leaves), "stacked": {}}
    outs = {}
    for name, strategy, compress in GRAD_SYNC_RUNS:
        log_ = []
        s, _ = hier_grad_sync(g, N_PODS, LANES, strategy, compress, log=log_)
        ms, _ = time_ms(lambda: hier_grad_sync(g, N_PODS, LANES, strategy, compress),
                        samples=GRAD_SYNC_REPS)
        outs[name] = s
        res["stacked"][name] = {"ms": ms, "log": log_}
    mean = _flat_leaves(outs["flat"])
    scale = max(float(t.abs().max()) for t in mean)
    for name in ("nap3", "int8"):
        err = max(float((a - b).abs().max()) for a, b in
                  zip(_flat_leaves(outs[name]), mean)) / scale
        check(err <= GRAD_SYNC_TOL[name], f"hier_grad_sync {name} against flat: "
              f"{err:.3e} of max|mean|, above {GRAD_SYNC_TOL[name]:g}")
        res["stacked"][name]["rel_err_vs_flat"] = err
    digests = {name: [digest(tree_map(lambda t, d=d: t[d], out))
                      for d in range(N_PODS * LANES)] for name, out in outs.items()}
    del g, outs, mean
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(grad_sync_rank, N_PODS, LANES, deadline=GRAD_SYNC_DEADLINE)
    res["gloo_wall_s"] = time.perf_counter() - t0
    whole_slow = n * (N_PODS - 1)
    res["model"] = {"nap3_slow_share": 1 / LANES, "int8_slow_byte_share": 1 / 4}
    res["gloo"] = {}
    for name, _, _ in GRAD_SYNC_RUNS:
        for out in ranks:
            r = out["rank"]
            mine = out[name]
            check(mine["device"] == ("cuda:0" if DEVICE == "cuda" else DEVICE),
                  f"rank {r}: {mine['device']}")
            check(mine["digest"] == digests[name][r],
                  f"grad sync {name}: rank {r} differs from its stacked row")
            check(mine["log"] == res["stacked"][name]["log"],
                  f"grad sync {name}: rank {r} logged {mine['log']}")
        sent = ranks[0][name]["sent"]
        slow = sum(v for (grp, _), v in sent.items() if grp == "slow")
        slow_bytes = sum(v * (1 if tag == INT8_TAG else 4)
                         for (grp, tag), v in sent.items() if grp == "slow")
        fast = sum(v for (grp, _), v in sent.items() if grp == "fast")
        world = sum(v for (grp, _), v in sent.items() if grp == "world")
        res["gloo"][name] = {"ms": float(np.median([o[name]["ms"] for o in ranks])),
                             "slow_elements": slow, "slow_bytes": slow_bytes,
                             "fast_elements": fast, "world_elements": world,
                             "slow_share_of_whole": slow / whole_slow}
    nap3, int8 = res["gloo"]["nap3"], res["gloo"]["int8"]
    check(nap3["slow_elements"] == piece * (N_PODS - 1),
          f"nap3 slow elements {nap3['slow_elements']}, want {piece * (N_PODS - 1)}")
    check(int8["slow_bytes"] == piece * (N_PODS - 1) + 4 * len(leaves) * (N_PODS - 1),
          f"int8 slow bytes {int8['slow_bytes']}")
    int8["slow_byte_share_of_nap3"] = int8["slow_bytes"] / nap3["slow_bytes"]
    log(f"hier_grad_sync over one {cfg.name} layer ({n} elements a rank, "
        f"{len(leaves)} leaves) on {N_PODS} x {LANES} ranks:")
    for name, _, _ in GRAD_SYNC_RUNS:
        st, gl = res["stacked"][name], res["gloo"][name]
        log(f"  {name:5s} stacked {st['ms']:.3f} ms, log {st['log'][:4]}"
            + (f", vs flat {st['rel_err_vs_flat']:.1e}" if "rel_err_vs_flat" in st else "")
            + f"; gloo {gl['ms']:.1f} ms a call, per rank: slow {gl['slow_elements']} "
            f"elements ({gl['slow_bytes']} B, {gl['slow_share_of_whole']:.4f} of a slow "
            f"all-reduce of the whole gradient), fast {gl['fast_elements']}, world "
            f"{gl['world_elements']}")
    log(f"  model: nap3's slow leg 1/|fast| = {1 / LANES:.4f} of the whole "
        f"(measured {nap3['slow_share_of_whole']:.4f}); int8 1/4 of nap3's bytes "
        f"(measured {int8['slow_byte_share_of_nap3']:.4f}, the scales included); "
        f"gloo ranks {res['gloo_wall_s']:.1f} s, bit-equal to the stacked rows")
    return res


def graph_phase(bound, b, res) -> dict:
    """The f64 PCG as captured CUDA graphs: the host's CUDA runtime calls of
    two warm solves of different length (one ``cudaGraphLaunch`` per program
    call, a ``cudaLaunchKernel`` count that does not grow with the
    iterations), the history through the graphs against the eager program
    bodies, and the exchange's overlap with ``A_on`` in one ``pcg_step``
    replay."""
    dh = bound.dist_hierarchy
    opts = bound.opts
    runtime = {}
    for iters in GRAPH_ITERS:
        calls: dict[str, int] = {}
        device_profile(lambda: bound.pcg(b, tol=0.0, maxiter=iters), calls)
        runtime[iters] = calls
        check(calls.get("cudaGraphLaunch", 0) == iters + 1,
              f"a PCG of {iters} iterations made "
              f"{calls.get('cudaGraphLaunch', 0)} cudaGraphLaunch calls, "
              f"want {iters + 1} (one per program call)")
    kernels = [runtime[i].get("cudaLaunchKernel", 0) for i in GRAPH_ITERS]
    check(kernels[0] == kernels[1],
          f"cudaLaunchKernel grows with the iterations: {dict(zip(GRAPH_ITERS, kernels))}")
    for iters, calls in runtime.items():
        log(f"  host CUDA runtime calls of a warm {iters}-iteration PCG: "
            + ", ".join(f"{k} {v}" for k, v in sorted(calls.items(),
                                                       key=lambda kv: -kv[1])))
    eager = eager_pcg(dh, b, opts, res.iterations)
    graph = bound.pcg(b, tol=0.0, maxiter=res.iterations).residuals
    diff = max(abs(x - y) for x, y in zip(eager, graph)) / eager[0]
    bit_equal = eager == graph
    check(len(eager) == len(graph) and diff <= 1e-14,
          f"captured vs eager PCG histories differ by {diff:.2e} of r0")
    log(f"  captured vs eager PCG, {res.iterations} iterations: residual "
        f"histories {'bit-equal' if bit_equal else f'differ by {diff:.2e} of r0'}")
    step = dh.programs.get("pcg_step", opts)

    def replays():
        for _ in range(OVERLAP_REPLAYS):
            step.run()

    ov = overlap_share(last_graph_kernels(replays))
    log(f"  the last of {OVERLAP_REPLAYS} pcg_step replays ({ov['kernels']} "
        f"kernels): level-0 exchange kernels {ov.get('exchange_kernels')} "
        f"({ov.get('exchange_us', 0.0):.1f} us), A_on ell_spmv "
        f"{ov.get('a_on_us', 0.0):.1f} us, share of the exchange's kernel time "
        f"concurrent with A_on: "
        + (f"{ov['share']:.3f}" if ov["share"] is not None else "not measured")
        + f" (streams {ov.get('streams')})")
    pool = dh.programs.pool_bytes()
    captures = {f"{n}/k={k}": c for (n, k), c in dh.programs.captures.items()}
    log(f"  graphs captured: {captures}; shared pool {pool} bytes "
        f"({pool / 2**20:.1f} MiB)")
    return {"runtime_calls": {str(i): c for i, c in runtime.items()},
            "captured_vs_eager_bit_equal": bit_equal,
            "captured_vs_eager_diff": diff, "overlap": ov,
            "pool_bytes": pool, "captures": captures}


def service_phase(cfg, A, rng) -> dict:
    """``AMGService`` with its worker thread on the f64 session's matrix:
    two rounds of 16 requests in two bursts each, one RHS and ``[n, 2]``;
    chunks of at most K_RHS columns through the ``*_m`` graphs, each result's
    true residual under 1e-7.  The first round captures the graphs of the
    chunk widths that are new (on the worker thread), the second replays."""
    from repro_torch.amg import AMGService

    svc = AMGService(cfg, max_rhs=K_RHS, coalesce_window=SERVICE_WINDOW)
    svc.register("m", A)
    dh = svc.bound_for("m").dist_hierarchy     # the f64 session's lowering
    rounds = []
    for _ in range(2):
        caps0 = collections.Counter(dh.programs.captures)
        bursts = [[rng.standard_normal((A.nrows, 2) if i % 4 == 0 else A.nrows)
                   for i in range(SERVICE_REQUESTS // 2)] for _ in range(2)]
        t0 = time.perf_counter()
        with svc:
            tickets = []
            for burst in bursts:
                tickets += [(bb, svc.submit("m", bb, method="pcg"))
                            for bb in burst]
                time.sleep(SERVICE_GAP)
            xs = [(bb, t.result(timeout=600), t) for bb, t in tickets]
        wall = time.perf_counter() - t0
        chunks: dict[int, int] = {}
        worst = 0.0
        for bb, x, t in xs:
            d = t.diagnostics
            chunks[d["batch"]] = d["batch_cols"]
            check(d["converged"], f"service request {t.rid} did not converge")
            r = (bb - (A.matvec(x) if bb.ndim == 1 else
                       np.stack([A.matvec(x[:, j]) for j in range(x.shape[1])], 1)))
            worst = max(worst, float(np.linalg.norm(r) / np.linalg.norm(bb)))
        cols = sum(bb.shape[1] if bb.ndim == 2 else 1 for bb, _, _ in xs)
        check(all(w <= K_RHS for w in chunks.values())
              and sum(chunks.values()) == cols and len(chunks) < len(xs),
              f"service chunks {chunks} for {cols} columns, want coalesced "
              f"chunks of at most {K_RHS}")
        check(worst < 1e-7, f"service true residual {worst:.2e}")
        new = collections.Counter(dh.programs.captures) - caps0
        by_width = collections.Counter()
        for (_, k), c in new.items():
            by_width[str(k)] += c
        rounds.append({"requests": len(xs), "columns": cols,
                       "chunk_widths": sorted(chunks.values(), reverse=True),
                       "wall_s": wall, "solves_per_s": len(xs) / wall,
                       "worst_true_residual": worst,
                       "captures_by_width": dict(by_width)})
        log(f"service round {len(rounds)}: {len(xs)} requests ({cols} columns, "
            f"two bursts) in {wall:.3f} s = {len(xs) / wall:.2f} solves/s; "
            f"chunk widths {rounds[-1]['chunk_widths']}, worst true residual "
            f"{worst:.2e}, graphs captured by width {dict(by_width)}")
    total = collections.Counter()
    for (_, k), c in dh.programs.captures.items():
        total[str(k)] += c
    pool = dh.programs.pool_bytes()
    log(f"  graphs of the f64 lowering by width (None = single RHS): {dict(total)}, "
        f"shared pool {pool} bytes ({pool / 2**20:.1f} MiB); service stats {svc.stats}")
    return {"rounds": rounds, "captures_by_width": dict(total),
            "pool_bytes": pool, "stats": dict(svc.stats)}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each entry of the bfloat16 ``v``, from its
    exponent (float64; 0 where ``v`` is 0): 2^-7 on [1, 2)."""
    m, e = torch.frexp(v.double())
    return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


def bf16_bar(absum):
    """``kernel_case``'s ``rel_err`` for a bfloat16 case: the largest ratio
    of |kernel − plain| to one bfloat16 ulp of plain + BF16_ABS·``absum``
    over the entries (``absum``: Σ|a·x| of each entry, float64); it passes
    at ≤ 1.  Both round a float32 sum once, in another order: where the two
    sums straddle a rounding boundary the results differ by one ulp, which
    reads just under 1; more fails unless the float32 term covers it."""
    def rel(y, ref):
        bar = bf16_ulp(ref) + BF16_ABS * absum
        return float(((y.double() - ref.double()).abs()
                      / bar.clamp_min(1e-300)).max())
    return rel


def bf16_rel(plain, args):
    """:func:`bf16_bar` for a sparse kernel, Σ|a·x| from the plain version
    on |A| and |x| in float64."""
    idx, vals, x = args
    return bf16_bar(plain(idx, vals.double().abs(), x.double().abs()))


def bf16_library(csr, xf):
    """``torch.sparse.mm`` on the bfloat16 CSR operator, or None and the
    error where the install has no bfloat16 sparse product."""
    try:
        torch.sparse.mm(csr, xf)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return (lambda: torch.sparse.mm(csr, xf)), None


def bf16_kernel_rows(dh16, rng, per_solve: dict[str, dict[str, int]]) -> tuple[dict, dict]:
    """The three sparse kernels in bfloat16 at the bfloat16 lowering's own
    operands, each against its plain version at the card bar:
    ``ell_spmv`` at every operand the bfloat16 PCG launches and ``ell_spmm``
    (k = K_RHS) at every operand the k = K_RHS solve launches (``per_solve``,
    by kernel; level 0's A_on also with the L2 flushed), ``bcsr_spmm`` at
    each BCSR level's on-process block (k = 1 and K_RHS).  Returns the rows
    by kernel and, for the two ELL kernels, the sums over one solve of
    launches x (ms - bound ms) and of launches x ms."""
    from repro_torch.kernels.spmv import bcsr as kb
    from repro_torch.kernels.spmv import ref

    out: dict[str, list] = {n: [] for n in SPMV_KERNELS}
    dev, dt = dh16.device, dh16.dtype
    for name, (cols, vals, m) in ell_operands(dh16).items():
        for kname, k in (("ell_spmv", None), ("ell_spmm", K_RHS)):
            launches = per_solve[kname].get(name)
            if name == "L0 A_on" or launches:
                out[kname].append(ell_case(name, cols, vals, m, rng, launches, k,
                                           cold=name == "L0 A_on"))
    sums = {kname: ell_sums(out[kname], solve, kname)
            for kname, solve in (("ell_spmv", "bf16"), ("ell_spmm", f"bf16 k = {K_RHS}"))}
    for l, (dl, a) in enumerate(zip(dh16.levels, dh16._arrs)):
        if dl.A.local_kernel != "bcsr":
            continue
        bcols, bvals = a["A"]["on_bcols"], a["A"]["on_bvals"]
        D, mb, Kb, bs, _ = bvals.shape
        ml, rows = dl.A.plan.local_n, dl.A.rows_local
        nblk = int((bcols >= 0).sum())
        bcsr = bcsr_to_csr(bcols, bvals, ml, rows)
        for k in (1, K_RHS):
            xb = torch.as_tensor(rng.standard_normal((D, ml, k)), dtype=dt,
                                 device=dev)
            library, err = bf16_library(bcsr, xb.reshape(-1, k))

            def plain(a_, v, x, r=rows):
                return ref.bcsr_apply_ref(a_, v, x, r)
            args = (bcols, bvals, xb)
            row = kernel_case(
                f"bcsr_spmm L{l} bs{bs} k{k}",
                lambda a_, v, x, r=rows: kb.bcsr_spmm(a_, v, x, rows=r),
                plain, library, args,
                D * mb * Kb * 4 + nblk * bs * bs * 2 + D * (ml + rows) * k * 2,
                2 * nblk * bs * bs * k, rtol=1.0, rel_err=bf16_rel(plain, args),
                peak=PEAK_FLOPS[torch.float32])
            row.update(level=l, bs=bs, k=k, rows=rows, main_path=True,
                       library_error=err)
            out["bcsr_spmm"].append(row)
    check(out["bcsr_spmm"], "no level of the bfloat16 lowering is BCSR")
    return out, sums


def bf16_phase(cfg64, A, b, B, res64, resm64, c64) -> tuple:
    """The bfloat16 session on the host setup the f64 one shares: its
    lowering, PCG through its graphs, a k = K_RHS solve through
    ``AMGService``, then the ELL kernels' launches by operand in a bfloat16
    PCG and a k = K_RHS solve and the three kernels in bfloat16 at its
    operands (:func:`bf16_kernel_rows`).  Returns the kernel rows, the
    launches of its counted runs, its numbers, the session
    (a store of its own; :func:`bf16_block_phase` runs the block smoothers
    on its lowering and then releases it) and its PCG result."""
    from repro_torch.amg import AMGService, AMGSolver
    from repro_torch.amg.api import SessionStore

    cfg16 = dataclasses.replace(cfg64, dtype="bfloat16", tol=BF16_TOL)
    t0 = time.perf_counter()
    bound16 = AMGSolver(cfg16, store=SessionStore()).setup(A)
    dh16 = bound16.dist_hierarchy
    t_lower = time.perf_counter() - t0
    check(dh16.dtype == torch.bfloat16, f"bf16 lowering is {dh16.dtype}")
    log(f"bf16: lowering {t_lower:.2f} s (the f64 session's host setup), "
        f"layouts {[r['kernel'] + (str(r['block_size']) if r['block_size'] else '') for r in dh16.kernel_table()]}")
    res, c16 = counted(lambda: bound16.pcg(b))
    check(res.converged, f"bf16 PCG did not converge: {res.residuals[-3:]}")
    progs = [p for p in dh16.programs.values() if p.key.k is None]
    calls = sum(p.replays for p in progs)
    check(all(p.graph is not None for p in progs) and calls == res.iterations + 1,
          f"bf16 PCG: {calls} graph replays for {res.iterations + 1} program "
          f"calls")
    per_iter = {}
    for k in SPMV_KERNELS:
        check(c16[k] * (res64.iterations + 1) == c64[k] * (res.iterations + 1),
              f"bf16 PCG launched {k} {c16[k]} times in {res.iterations + 1} "
              f"calls, the f64 one {c64[k]} in {res64.iterations + 1}")
        per_iter[k] = c16[k] / (res.iterations + 1)
    check(c16["ell_spmv"] > 0 and (c16["bcsr_spmm"] > 0 or not any(
        dl.A.block_size for dl in dh16.levels)), f"bf16 launches {c16}")
    x64 = res64.x
    xdiff = float(np.linalg.norm(res.x.astype(np.float64) - x64)
                  / np.linalg.norm(x64))
    check(xdiff <= BF16_X_BAR, f"bf16 x is {xdiff:.3e} from the f64 x")
    true_rel = float(np.linalg.norm(b - A.matvec(res.x.astype(np.float64)))
                     / np.linalg.norm(b))
    # ms an iteration: the median of BF16_WARM warm solves (the whole call
    # over its iterations; one solve's host time moves by a third or more)
    walls = []
    for _ in range(BF16_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = bound16.pcg(b)
        walls.append((time.perf_counter() - t0) * 1e3 / max(warm.iterations, 1))
    ms_iter = float(np.median(walls))
    prof = device_profile(lambda: bound16.pcg(b))
    dev_ms = sum(v[0] for v in prof.values())
    busy = dev_ms / (ms_iter * max(warm.iterations, 1)) if prof else None
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"pcg bf16 (tol {BF16_TOL:g}): {res.iterations} iterations (f64 to "
        f"1e-8: {res64.iterations}), converged, {ms_iter:.3f} ms/iteration "
        f"warm (median of {BF16_WARM}: {[round(w, 3) for w in walls]}), device {dev_ms / max(warm.iterations, 1):.3f} ms/iteration, "
        f"busy share " + ("not measured" if busy is None else f"{busy:.3f}")
        + f", float64 true residual {true_rel:.3e}, |x - x_f64| / |x_f64| "
        f"{xdiff:.3e}; launches {c16} ({per_iter} a program call, as f64)")
    for kname, (kms, kcount) in top:
        log(f"    {kms:9.3f} ms {kcount:6d}x  {kname[:100]}")
    # k = K_RHS requests through the service: one coalesced chunk
    svc = AMGService(cfg16, max_rhs=K_RHS, coalesce_window=SERVICE_WINDOW)
    svc.register("m", A)
    check(svc.bound_for("m").dist_hierarchy is dh16,
          "the bf16 service did not share the bf16 lowering")
    tickets = [svc.submit("m", B[:, j], method="pcg") for j in range(K_RHS)]
    _, csvc = counted(svc.drain)
    worst = 0.0
    widths = set()
    for j, t in enumerate(tickets):
        d = t.diagnostics
        widths.add(d["batch_cols"])
        check(d["converged"], f"bf16 service request {j} did not converge")
        xj = resm64.columns[j].x
        worst = max(worst, float(np.linalg.norm(t.result(timeout=0) - xj)
                                 / np.linalg.norm(xj)))
    check(widths == {K_RHS} and csvc["ell_spmm"] > 0,
          f"bf16 service chunks {widths}, launches {csvc}")
    check(worst <= BF16_X_BAR, f"bf16 service x is {worst:.3e} from f64's")
    log(f"bf16 service: {K_RHS} requests in one chunk of {K_RHS}, worst "
        f"|x - x_f64| / |x_f64| {worst:.3e}, launches {csvc}")
    # the ELL kernels' launches by operand in a bfloat16 PCG and a k = K_RHS
    # solve (each captured afresh), then every kernel at those operands
    per16 = {}
    for kname, rhs in (("ell_spmv", b), ("ell_spmm", B)):
        per16[kname], iters16 = operand_launches(bound16, rhs, kname)
        check(iters16 == res.iterations, f"the counted bf16 {kname} solve took "
              f"{iters16} iterations, the PCG {res.iterations}")
        log(f"bf16 {kname} launches of one solve of {list(rhs.shape)} by operand: "
            + ", ".join(f"{k} {v}" for k, v in per16[kname].items()))
    check(sum(per16["ell_spmv"].values()) == c16["ell_spmv"],
          f"bf16 ell_spmv launches by operand {per16['ell_spmv']}, the PCG's {c16}")
    log(f"bf16 kernels (device time per call: CUDA events, median of {SAMPLES} "
        f"bursts of {BURST}; plain and library off level-0 A_on {BF16_SIDE_SAMPLES}):")
    rows, sums16 = bf16_kernel_rows(dh16, np.random.default_rng(SEED + 5), per16)
    info = {"lowering_s": t_lower, "iterations": res.iterations,
            "ms_per_iteration": ms_iter, "ms_per_iteration_runs": walls,
            "device_ms_per_iteration": dev_ms / max(warm.iterations, 1)
            if prof else None, "device_busy_share": busy,
            "true_residual": true_rel, "x_rel_diff_f64": xdiff,
            "launches": c16, "launches_per_call": per_iter,
            "service_worst_x_rel_diff": worst, "service_launches": csvc,
            "top_device": [[kn[:100], km, kc] for kn, (km, kc) in top],
            "ell_launches_per_solve": per16, "ell_sums": sums16}
    launches = {k: c16[k] + csvc[k] for k in SPMV_KERNELS}
    del svc
    return rows, launches, info, bound16, res


def release_lowering(bound) -> None:
    """Take ``bound``'s lowering out of its host hierarchy's ``dist_cache``
    (the later phases' refresh of that hierarchy then does not re-lower it)
    and free its memory."""
    cache = bound.hierarchy.dist_cache
    dh = bound.dist_hierarchy
    for key in [key for key, v in cache.items() if v is dh]:
        del cache[key]


def refresh_phase(bound, host, A, b, t_lower) -> dict:
    """``bound.update(delta=ΔA)`` beneath the captured graphs: a refresh (of
    every lowering of the hierarchy, with the block smoothers' factors placed
    by the earlier phases; ``scripts/time_update.py`` times a Jacobi-only
    one), no graph captured again, the device tensors the same ones, the solve's
    history against the host session refreshed the same way (≤ 1e-7 of r0)
    and its true residual against A + ΔA; a fresh host setup on A + ΔA for
    time and solution (its history differs: it re-derives P)."""
    from repro_torch.amg import AMGSolver
    from repro_torch.amg.api import SessionStore

    dh = bound.dist_hierarchy
    ptrs = [t.data_ptr() for a in dh._arrs for v in a.values()
            for t in (v.values() if isinstance(v, dict) else (v,))]
    caps0 = collections.Counter(dh.programs.captures)
    delta = drift(A).data - A.data
    lowerings = list(bound.hierarchy.dist_cache.values())
    factors = sum(len(d._factors) for d in lowerings)
    t0 = time.perf_counter()
    action = bound.update(delta=delta)
    t_update = time.perf_counter() - t0
    check(action == "refresh", f"update took {action!r}, want 'refresh'")
    A_new = bound._fine
    res = bound.pcg(b)
    check(res.converged, "PCG after the refresh did not converge")
    check(collections.Counter(dh.programs.captures) == caps0
          and bound.dist_hierarchy is dh,
          f"graphs captured again after the refresh: "
          f"{collections.Counter(dh.programs.captures) - caps0}")
    check(ptrs == [t.data_ptr() for a in dh._arrs for v in a.values()
                   for t in (v.values() if isinstance(v, dict) else (v,))],
          "the refresh rebound a device tensor")
    true_rel = float(np.linalg.norm(b - A_new.matvec(res.x)) / np.linalg.norm(b))
    check(true_rel < 1e-7, f"true residual after the refresh {true_rel:.2e}")
    # the host session was set up on A under the same setup knobs, so it
    # shares the (now refreshed) hierarchy: its PCG is the host backend's
    # solve after the same refresh
    check(host.hierarchy is bound.hierarchy,
          "the host session does not share the refreshed hierarchy")
    res_h = host.pcg(b)
    hd = history_diff(res_h.residuals, res.residuals)
    check(abs(res_h.iterations - res.iterations) <= 1 and hd <= HIST_TOL,
          f"refreshed PCG history vs the refreshed host session: {hd:.2e}")
    t0 = time.perf_counter()
    fresh = AMGSolver(host.config, store=SessionStore(),
                      setup_store=SessionStore()).setup(A_new)
    t_fresh = time.perf_counter() - t0
    res_f = fresh.pcg(b)
    hd_fresh = history_diff(res_f.residuals, res.residuals)
    xd = float(np.abs(res.x - res_f.x).max() / np.abs(res_f.x).max())
    info = {"update_s": t_update, "fresh_setup_s": t_fresh,
            "lowering_s": t_lower, "iterations": res.iterations,
            "history_vs_refreshed_host": hd, "true_residual": true_rel,
            "fresh_iterations": res_f.iterations,
            "history_vs_fresh_setup": hd_fresh, "x_vs_fresh_setup": xd,
            "lowerings_refreshed": len(lowerings),
            "factors_refreshed": factors}
    log(f"refresh: update(delta=) {t_update:.2f} s ({len(lowerings)} lowerings, "
        f"{factors} placed block-smoother factors recomputed) against fresh setup {t_fresh:.2f} s + lowering "
        f"{t_lower:.2f} s; PCG {res.iterations} iterations, history vs the "
        f"refreshed host session {hd:.2e}, true residual {true_rel:.2e}, no "
        f"graph captured again; fresh setup {res_f.iterations} iterations, "
        f"history vs it {hd_fresh:.2e}, x vs it {xd:.2e}")
    return info


def born_reference(plevels):
    """The born-partitioned levels assembled into one host ``Hierarchy``
    (each operator the sum of its rank blocks): the smoke's numpy reference
    for a dist-born session, built beside its path, never on it."""
    from repro_torch.amg.hierarchy import Hierarchy, Level

    def assembled(M):
        if M is None:
            return None
        acc = M.blocks[0]
        for blk in M.blocks[1:]:
            acc = acc.add(blk)
        return acc

    return Hierarchy(solver="rs", theta=0.25, levels=[
        Level(A=assembled(lv.A), P=assembled(lv.P), R=assembled(lv.R),
              AP=assembled(lv.AP)) for lv in plevels])


def same_operators(h, h_ref) -> list[tuple[int, str]]:
    """The (level, operator) pairs two host hierarchies share: the same
    shape and sparsity pattern."""
    out = []
    for l, (lv, lr) in enumerate(zip(h.levels, h_ref.levels)):
        for op in ("A", "P", "R"):
            M, R = getattr(lv, op), getattr(lr, op)
            if (M is not None and R is not None and M.shape == R.shape
                    and np.array_equal(M.indptr, R.indptr)
                    and np.array_equal(M.indices, R.indices)):
                out.append((l, op))
    return out


def same_lowering(levels, ref_levels, pairs=None) -> dict:
    """Lowered operators against a reference lowering at the (level, op)
    ``pairs`` (default: every operator, then also every level's ``dinv``
    and ``coarse_inv`` and the kernel layout): the same strategy, ELL column
    maps bit-equal, value planes within 1e-12."""
    def layout(lv):
        return [(dl.A.local_kernel, dl.A.block_size, dl.A.rows_local,
                 dl.A.halo_empty) for dl in lv]

    whole = pairs is None
    if whole:
        check(layout(levels) == layout(ref_levels),
              f"kernel layouts differ: {layout(levels)} vs {layout(ref_levels)}")
        pairs = [(l, op) for l, dl in enumerate(levels) for op in ("A", "P", "R")
                 if getattr(dl, op) is not None]
    worst = 0.0
    for l, op in pairs:
        x, y = getattr(levels[l], op), getattr(ref_levels[l], op)
        check(y is not None and x.strategy == y.strategy,
              f"L{l} {op}: strategy {x.strategy} vs "
              f"{None if y is None else y.strategy}")
        check(np.array_equal(x.ell_cols, y.ell_cols),
              f"L{l} {op}: ELL column maps differ")
        worst = max(worst, float(np.abs(x.ell_vals - y.ell_vals).max()))
    if whole:
        for a, c in zip(levels, ref_levels):
            worst = max(worst, float(np.abs(a.dinv - c.dinv).max()))
            if a.coarse_inv is not None or c.coarse_inv is not None:
                worst = max(worst, float(np.abs(a.coarse_inv
                                                - c.coarse_inv).max()))
    check(worst <= 1e-12, f"lowered values differ by {worst:.2e} (bar 1e-12)")
    return {"operators": len(pairs), "max_value_diff": worst}


def partitioned_phase(cfg, A, b, B, bound_ref, res_ref, per_solve, c_ref) -> tuple[dict, object]:
    """The paper's setup phase on the main path's problem:
    ``AMGSolver(AMGConfig(setup_backend="dist", ...)).setup(A)`` runs the
    partitioned node-aware setup (host numpy) and lowers its born-partitioned
    levels straight onto the card.  Its SpGEMM exchange records; the setup
    audit (0 violations over ≥ 10 exchanges, all three strategies); the
    lowering against the host path's lowering of the same levels
    (``born_reference``: every operand, ``dinv``, ``coarse_inv``, the kernel
    layout) and against the host-setup session ``bound_ref`` on every
    operator the two setups share (level 0's A, P and R at least); PCG
    through the captured graphs: the history within HIST_TOL of r0 of the
    numpy host PCG on the same levels, the iterations, launch tallies by
    operand and launch counts of ``bound_ref``'s solve, and each kernel's
    launch count in a counted run."""
    from repro_torch.amg import AMGSolver
    from repro_torch.amg.api import SessionStore
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.amg.solve import host_pcg
    from repro_torch.analysis import audit_setup
    from repro_torch.core import MACHINES

    setups = SessionStore()
    t0 = time.perf_counter()
    bound = AMGSolver(dataclasses.replace(cfg, setup_backend="dist"),
                      store=SessionStore(), setup_store=setups).setup(A)
    t_total = time.perf_counter() - t0
    # the two tiers of the setup store: the partitioned levels (the setup
    # loop's seconds) and the lowering built from them
    cost = {("dist_partitioned" if "dist_partitioned" in e["key"]
             else "dist_lowered"): e["setup_cost"]
            for e in setups.entry_table()}
    t_setup, t_lower = cost["dist_partitioned"], cost["dist_lowered"]
    check(bound.hierarchy is None, "the dist-born session holds a host hierarchy")
    dh = bound.dist_hierarchy
    check(dh.h is None and dh.device.type == "cuda",
          f"the dist-born lowering: h {type(dh.h).__name__}, device {dh.device}")
    recs = dh.setup_records
    sizes = [lv.A.nrows for lv in bound._plevels]
    ref_sizes = [lv.A.nrows for lv in bound_ref.hierarchy.levels]
    log(f"partitioned setup: laplace_3d({SIZE}) on {N_PODS}x{LANES}, "
        f"{len(dh.levels)} levels {sizes} (host setup {ref_sizes}), "
        f"{len(recs)} SpGEMM row exchanges; setup {t_setup:.2f} s, lowering "
        f"{t_lower:.2f} s ({t_total:.2f} s in all); no host hierarchy")
    for r in recs:
        modeled = " ".join(f"{k}={v * 1e6:.1f}us" for k, v in r.modeled.items())
        log(f"  L{r.level} {r.op:<11s} {r.strategy:<8s} {modeled}; inter "
            f"{r.inter_msgs} msgs {r.inter_bytes:.0f} B, intra {r.intra_msgs} "
            f"msgs {r.intra_bytes:.0f} B; halo rows {r.n_halo_rows}, exchange "
            f"{r.seconds:.4f} s, C_on {r.on_seconds:.4f} s, C_off "
            f"{r.off_seconds:.4f} s")
    rows, violations = audit_setup(bound._plevels, recs)
    for v in violations:
        log(f"  AUDIT {v}")
    strategies = sorted({r["strategy"] for r in rows})
    check(not violations, f"{len(violations)} setup-audit violations")
    check(len(rows) >= 10, f"the setup audit read {len(rows)} exchanges, want >= 10")
    check(strategies == ["nap2", "nap3", "standard"],
          f"setup exchanges ran {strategies}, want all three strategies")
    log(f"  setup audit: {len(rows)} exchanges, strategies {strategies}, "
        f"0 violations (measured counters = the cached schedules' counts)")
    # the host path's lowering of the same levels, and the operators the
    # partitioned setup shares with the host setup (its coarse grids part
    # from level 1's splitting on: A_1's values differ by round-off)
    h_born = born_reference(bound._plevels)
    t0 = time.perf_counter()
    ref_levels = DistHierarchy._lower_levels(
        h_born.levels, N_PODS, LANES, params=MACHINES[cfg.machine],
        strategy=cfg.strategy,
        strategies=("standard", "nap2", "nap3"), dtype=np.float64)
    t_ref_lower = time.perf_counter() - t0
    low = same_lowering(dh.levels, ref_levels)
    shared = same_operators(h_born, bound_ref.hierarchy)
    check({(0, "A"), (0, "P"), (0, "R")} <= set(shared),
          f"level 0 differs from the host setup's: shared {shared}")
    low_host = same_lowering(dh.levels, bound_ref.dist_hierarchy.levels, shared)
    log(f"  lowering vs the host path's lowering of the same levels "
        f"({t_ref_lower:.2f} s): {low['operators']} operators, column maps "
        f"bit-equal, values / dinv / coarse_inv within "
        f"{low['max_value_diff']:.2e}, kernel layout equal; vs the host-setup "
        f"session on the operators both setups share "
        f"{['L%d %s' % p for p in shared]}: column maps bit-equal, values within "
        f"{low_host['max_value_diff']:.2e}")
    tallies = {}
    for kname, rhs in (("ell_spmv", b), ("ell_spmm", B)):
        tallies[kname], iters = operand_launches(bound, rhs, kname)
        check(tallies[kname] == per_solve[kname],
              f"{kname} launches by operand differ from the host-setup "
              f"session's: {tallies[kname]} vs {per_solve[kname]}")
    res, counts = counted(lambda: bound.pcg(b))
    res_born = host_pcg(h_born, b, tol=cfg.tol, maxiter=cfg.pcg_maxiter,
                        opts=cfg.opts)
    hd = history_diff(res_born.residuals, res.residuals)
    hd_ref = history_diff(res_ref.residuals, res.residuals)
    check(res.converged and res.iterations == res_born.iterations
          and hd <= HIST_TOL,
          f"dist-born PCG: {res.iterations} iterations (converged "
          f"{res.converged}), numpy on the same levels {res_born.iterations}, "
          f"history diff {hd:.2e}")
    check(res.iterations == res_ref.iterations,
          f"dist-born PCG {res.iterations} iterations, the host-setup session "
          f"{res_ref.iterations}")
    check(counts == c_ref, f"dist-born launches {counts}, host-setup {c_ref}")
    resm, counts_m = counted(lambda: bound.pcg(B))
    check(resm.converged, "dist-born multi-RHS PCG did not converge")
    for k in SPMV_KERNELS:
        check(counts[k] + counts_m[k] > 0,
              f"{k} was never launched on the dist-born path")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = bound.pcg(b)
    ms_iter = (time.perf_counter() - t0) * 1e3 / max(warm.iterations, 1)
    log(f"  pcg f64 through the dist-born graphs: {res.iterations} iterations "
        f"(host-setup session {res_ref.iterations}), history vs numpy PCG on "
        f"the same levels {hd:.2e} (vs the host-setup session, other coarse "
        f"grids: {hd_ref:.2e}), {ms_iter:.3f} ms/iteration warm; launches "
        f"{counts}, [n, {K_RHS}] {counts_m}; tallies by operand equal to the "
        f"host-setup session's")
    info = {"setup_s": t_setup, "lowering_s": t_lower, "session_s": t_total,
            "levels": sizes, "host_setup_levels": ref_sizes,
            "exchanges": len(rows), "strategies": strategies,
            "audit_violations": len(violations),
            "records": [r.as_dict() for r in recs],
            "lowering_vs_same_levels": low,
            "lowering_vs_host_setup": {**low_host,
                                       "shared": ["L%d %s" % p for p in shared]},
            "iterations": res.iterations,
            "history_vs_same_levels": hd, "history_vs_host_setup": hd_ref,
            "ms_per_iteration": ms_iter, "launches": counts,
            "launches_multi": counts_m, "launches_by_operand": tallies}
    return info, (bound, h_born)


def partitioned_update_phase(born, bound_ref, A, b, info) -> dict:
    """``update(delta=ΔA)`` on the dist-born session (the smoke's drift): a
    refresh through the cached NAP schedules beneath its graphs, no graph
    captured again; its history against the numpy PCG on the same levels
    refreshed by the host Galerkin products (≤ HIST_TOL of r0), its
    iterations against the host-setup session ``bound_ref`` refreshed with
    the same drift (±1)."""
    from repro_torch.amg.hierarchy import refresh_values
    from repro_torch.amg.solve import host_pcg

    bound, h_born = born
    A_new = drift(A)
    dh = bound.dist_hierarchy
    caps0 = collections.Counter(dh.programs.captures)
    t0 = time.perf_counter()
    action = bound.update(delta=A_new.data - A.data)
    t_update = time.perf_counter() - t0
    check(action == "refresh", f"dist-born update took {action!r}, want 'refresh'")
    res = bound.pcg(b)
    refresh_values(h_born, A_new)
    cfg = bound.config
    res_born = host_pcg(h_born, b, tol=cfg.tol, maxiter=cfg.pcg_maxiter,
                        opts=cfg.opts)
    hd = history_diff(res_born.residuals, res.residuals)
    res_ref = bound_ref.pcg(b)
    check(res.converged and res.iterations == res_born.iterations
          and hd <= HIST_TOL,
          f"refreshed dist-born PCG: {res.iterations} iterations, numpy on the "
          f"same refreshed levels {res_born.iterations}, history diff {hd:.2e}")
    check(abs(res.iterations - res_ref.iterations) <= 1,
          f"refreshed dist-born PCG {res.iterations} iterations, the refreshed "
          f"host-setup session {res_ref.iterations}")
    recaptured = collections.Counter(dh.programs.captures) - caps0
    check(not recaptured, f"graphs captured again after the update: {recaptured}")
    log(f"  update(delta=) on the dist-born session: {action} in "
        f"{t_update:.2f} s (partitioned setup {info['setup_s']:.2f} s + "
        f"lowering {info['lowering_s']:.2f} s); PCG {res.iterations} "
        f"iterations (refreshed host-setup session {res_ref.iterations}), "
        f"history vs numpy on the same levels refreshed by the host Galerkin "
        f"products {hd:.2e}; no graph captured again")
    return {"update_s": t_update, "update_action": action,
            "update_iterations": res.iterations,
            "update_host_setup_iterations": res_ref.iterations,
            "update_history_vs_same_levels": hd}


def aggressive_phase(cfg) -> dict:
    """An aggressive (distance-2) partitioned setup of
    ``laplace_3d(AGGRESSIVE_SIZE)``: its audit covers the ``spgemm_S2``
    exchange with 0 violations, and its PCG on the card converges with the
    history of the host aggressive setup's (numpy host backend) within
    HIST_TOL of r0."""
    from repro_torch.amg import AMGSolver
    from repro_torch.amg.api import SessionStore
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.analysis import audit_setup

    A = laplace_3d(AGGRESSIVE_SIZE)
    b = np.random.default_rng(SEED).standard_normal(A.nrows)
    cfga = dataclasses.replace(cfg, setup_backend="dist", aggressive=True)
    t0 = time.perf_counter()
    bound = AMGSolver(cfga, store=SessionStore(),
                      setup_store=SessionStore()).setup(A)
    t_setup = time.perf_counter() - t0
    dh = bound.dist_hierarchy
    rows, violations = audit_setup(bound._plevels, dh.setup_records)
    s2 = [r for r in rows if r["op"] == "spgemm_S2"]
    check(s2 and not violations,
          f"aggressive setup audit: {len(s2)} spgemm_S2 rows, "
          f"{len(violations)} violations")
    res = bound.pcg(b)
    host = AMGSolver(dataclasses.replace(cfga, backend="host",
                                         setup_backend="host"),
                     store=SessionStore(), setup_store=SessionStore()).setup(A)
    res_h = host.pcg(b)
    hd = history_diff(res_h.residuals, res.residuals)
    check(res.converged and abs(res.iterations - res_h.iterations) <= 1
          and hd <= HIST_TOL,
          f"aggressive dist-born PCG: {res.iterations} iterations vs host "
          f"{res_h.iterations}, history diff {hd:.2e}")
    log(f"  aggressive partitioned setup, laplace_3d({AGGRESSIVE_SIZE}): "
        f"{len(dh.levels)} levels, setup + lowering {t_setup:.2f} s, "
        f"{len(rows)} exchanges audited ({len(s2)} spgemm_S2: "
        + ", ".join(f"L{r['level']} {r['strategy']}" for r in s2)
        + f"), 0 violations; PCG {res.iterations} iterations (host "
        f"{res_h.iterations}), history vs host {hd:.2e}")
    return {"size": AGGRESSIVE_SIZE, "levels": len(dh.levels),
            "session_s": t_setup, "exchanges": len(rows),
            "s2_exchanges": len(s2), "audit_violations": len(violations),
            "iterations": res.iterations, "history_vs_host": hd}


def audit_phase(bound, b) -> dict:
    """The communication audit over replayed graphs.  At full width, every
    program the f64 session captured (widths 1, 8 and the service's): the
    log its capture recorded, which each replay adds, against
    ``expected_collectives``; a replayed PCG's ``comm_log`` against the sum
    of its program calls; level 0's ``A`` apply with the poisoned-halo
    overlap check.  Then the whole V/W/F × five-smoother grid over all ten
    programs on ``laplace_3d(AUDIT_SIZE)``, each program captured and read
    from its replay.  Any violation fails the run."""
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.analysis import (audit_apply, audit_captured,
                                      audit_hierarchy, audit_solve)

    dh = bound.dist_hierarchy
    progs = dh.programs.values()
    check(bool(progs) and all(p.graph is not None for p in progs),
          "the f64 session's programs are not all captured graphs")
    full = audit_captured(dh)
    widths = sorted({1 if p.key.k is None else p.key.k for p in progs})
    opts = bound.opts
    init = dh.programs.get("pcg_init", opts)
    step = dh.programs.get("pcg_step", opts)
    before = (init.replays, step.replays)
    saved, dh.comm_log = dh.comm_log, []
    try:
        res = bound.pcg(b)
        solve_log = dh.comm_log
    finally:
        dh.comm_log = saved
    calls = {"pcg_init": init.replays - before[0],
             "pcg_step": step.replays - before[1]}
    check(calls == {"pcg_init": 1, "pcg_step": len(res.residuals) - 1},
          f"a PCG of {res.iterations} iterations replayed {calls}")
    check(solve_log == init.comm + step.comm * calls["pcg_step"],
          "the replayed PCG's comm_log is not its program calls' logs")
    solve = audit_solve(dh, solve_log, calls, opts, label="pcg[replayed]")
    apply0 = audit_apply(dh, 0, "A")
    t0 = time.perf_counter()
    h = setup(laplace_3d(AUDIT_SIZE), solver="rs")
    dh_grid = DistHierarchy.build(h, N_PODS, LANES, dtype=torch.float64,
                                  device=DEVICE)
    grid, grid_violations = audit_hierarchy(dh_grid)
    t_grid = time.perf_counter() - t0
    captured = sum(dh_grid.programs.captures.values())
    check(all(p.graph is not None for p in dh_grid.programs.values()),
          "the grid's programs are not all captured graphs")
    violations = ([v for a in full + [solve, apply0] for v in a.violations]
                  + grid_violations)
    for v in violations:
        log(f"  AUDIT {v}")
    log(f"audit: laplace_3d({SIZE}) f64: {len(full)} captured programs at "
        f"widths {widths}, {sum(a.n_collectives for a in full)} collective "
        f"steps a replay; replayed PCG ({calls['pcg_step']} steps) logs "
        f"{solve.n_collectives} = its calls'; level-0 A overlap check "
        f"{'clean' if apply0.ok else 'FAILED'}; grid laplace_3d({AUDIT_SIZE}) "
        f"({len(dh_grid.levels)} levels): {len(grid)} audits, {captured} graphs "
        f"captured, {t_grid:.1f} s; violations {len(violations)}")
    check(not violations, f"{len(violations)} communication audit violations")
    return {"programs_full_width": len(full), "widths": widths,
            "replayed_pcg_collectives": solve.n_collectives,
            "grid_size": AUDIT_SIZE, "grid_audits": len(grid),
            "grid_graphs_captured": captured, "grid_s": t_grid,
            "violations": len(violations)}


def wire_phase(cfg) -> dict:
    """AMGWire over a loopback socket on the card: a ``ServerThread`` with two
    f64 torch tenants; ``alpha`` registers ``laplace_3d(WIRE_SIZE)`` (its
    frame under the 64 MiB limit), takes one lone solve (setup, lowering,
    captures), 16 solves (one RHS and ``[n, 2]``) in two bursts and one
    lone solve, one ``update`` with the smoke's drift, then 8 more and one
    lone; ``beta`` serves ``laplace_3d(WIRE_SMALL)`` alongside.  Every
    answer's relative residual must be ≤ 100·tol, and match the in-process
    service's answer for the same b.  The launch counters are set to 0
    just before the server starts and read when the traffic ends."""
    from repro_torch.amg import AMGService, AMGSolver
    from repro_torch.amg.api import (SessionStore, array_from_wire,
                                     csr_to_wire, solve_request_to_wire,
                                     update_request_to_wire)
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.serve import (MAX_FRAME_BYTES, AMGWireClient,
                                   ServerThread, TenantSpec, encode_frame)
    from repro_torch.serve.workload import rel_residual, summarize_latencies

    A, A_small = laplace_3d(WIRE_SIZE), laplace_3d(WIRE_SMALL)
    rng = np.random.default_rng(SEED + 1)
    payload = csr_to_wire(A)
    frame_bytes = len(encode_frame({"schema": 2, "kind": "register",
                                    "tenant": "alpha", "seq": 0,
                                    "payload": payload}))
    check(frame_bytes <= MAX_FRAME_BYTES,
          f"register frame {frame_bytes} bytes over {MAX_FRAME_BYTES}")
    tol = cfg.tol
    tenants = {"alpha": TenantSpec(config=cfg, max_inflight=64,
                                   max_rhs=K_RHS,
                                   coalesce_window=SERVICE_WINDOW),
               "beta": TenantSpec(config=cfg, max_inflight=8, max_rhs=K_RHS)}
    delta = drift(A).data - A.data
    A_new = drift(A)
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    with ServerThread(tenants) as srv, \
            AMGWireClient.connect(srv.host, srv.port) as c:
        t0 = time.perf_counter()
        mid = c.register("alpha", payload, timeout=600)["matrix"]
        t_register = time.perf_counter() - t0
        mid_small = c.register("beta", csr_to_wire(A_small))["matrix"]

        def lone(M):
            bb = rng.standard_normal(M.nrows)
            t0 = time.perf_counter()
            x, d = c.solve("alpha", solve_request_to_wire(mid, bb,
                                                          method="pcg"),
                           timeout=600)
            return {"b": bb, "x": x, "s": time.perf_counter() - t0,
                    "diag": d}

        def burst_round(M, n):
            sent, small = [], []
            for _ in range(2):
                for i in range(n // 2):
                    bb = rng.standard_normal((M.nrows, 2) if i % 4 == 0
                                             else M.nrows)
                    t = time.perf_counter()
                    seq = c.send("solve", tenant="alpha",
                                 payload=solve_request_to_wire(
                                     mid, bb, method="pcg"))
                    sent.append((bb, seq, t))
                bs = rng.standard_normal(A_small.nrows)
                small.append((bs, c.send("solve", tenant="beta",
                                         payload=solve_request_to_wire(
                                             mid_small, bs, method="pcg"))))
                time.sleep(SERVICE_GAP)
            out, lat, t_end = [], [], 0.0
            for bb, seq, t in sent:
                frame, t_recv = c.recv_timed(seq, timeout=600)
                check(frame["kind"] == "solution",
                      f"wire solve answered {frame}")
                x = array_from_wire(frame["x"])
                check(frame["diagnostics"]["converged"],
                      f"wire solve {seq} did not converge")
                out.append({"b": bb, "x": x, "diag": frame["diagnostics"]})
                lat.append(t_recv - t)
                t_end = max(t_end, t_recv)
            for bs, seq in small:
                frame = c.recv(seq, timeout=600)
                check(frame["kind"] == "solution",
                      f"beta's wire solve answered {frame}")
                rr = rel_residual(A_small, array_from_wire(frame["x"]), bs)
                check(rr <= 100 * tol, f"beta's wire residual {rr:.2e}")
            return out, {"requests": n, "wall_s": t_end - sent[0][2],
                         "solves_per_s": n / (t_end - sent[0][2]),
                         **summarize_latencies(lat)}

        first = lone(A)
        round1, stats1 = burst_round(A, SERVICE_REQUESTS)
        lone1 = lone(A)
        upd = c.update("alpha", update_request_to_wire(mid, delta=delta),
                       timeout=600)
        check(upd["action"] == "refresh", f"wire update answered {upd}")
        round2, stats2 = burst_round(A_new, SERVICE_REQUESTS // 2)
        lone2 = lone(A_new)
        counts = {k: w.launches for k, w in wrappers.items()}
        server_stats = c.stats()
        svc = srv.server.tenants["alpha"].service
        dh = svc.bound_for(mid).dist_hierarchy
        store_bytes = svc.store.stats()["bytes"]
        pool, state = dh.programs.pool_bytes(), dh.programs.state_bytes()
        uses_bcsr = any(dl.A.block_size for dl in dh.levels)
    check(server_stats["dropped_connections"] == 0,
          "the wire server dropped a connection")
    for k in SPMV_KERNELS:
        if k != "bcsr_spmm" or uses_bcsr:
            check(counts[k] > 0, f"{k} was never launched on the wire path")
    check(store_bytes >= dh.nbytes >= pool + state > 0,
          f"store bytes {store_bytes} miss the lowering's {dh.nbytes} "
          f"(pool {pool}, state {state})")
    # every answer against the matrix it was solved on, and against the
    # in-process service's answer for the same b (its own setup store: the
    # wire tenant's hierarchy was refreshed in place)
    worst, worst_x, equal = 0.0, 0.0, 0
    for M, reqs in ((A, [first] + round1 + [lone1]),
                    (A_new, round2 + [lone2])):
        ref = AMGService(cfg, max_rhs=K_RHS)
        ref.solver = AMGSolver(cfg, store=ref.store,
                               setup_store=SessionStore())
        ref.register("m", M)
        for group in (reqs[:1], reqs[1:-1], reqs[-1:]):
            tickets = [ref.submit("m", r["b"], method="pcg") for r in group]
            ref.drain()
            for r, t in zip(group, tickets):
                xs = t.result(timeout=0)
                rr = rel_residual(M, r["x"], r["b"]) if r["b"].ndim == 1 \
                    else max(rel_residual(M, r["x"][:, j], r["b"][:, j])
                             for j in range(r["b"].shape[1]))
                worst = max(worst, rr)
                d = float(np.abs(r["x"] - xs).max() / np.abs(xs).max())
                worst_x = max(worst_x, d)
                equal += bool(np.array_equal(r["x"], xs))
    n_answers = len(round1) + len(round2) + 3
    check(worst <= 100 * tol, f"wire relative residual {worst:.2e}")
    check(worst_x <= WIRE_X_RTOL,
          f"wire answers vs the in-process service's: {worst_x:.2e} of max|x|")
    info = {"size": WIRE_SIZE, "rows": A.nrows, "nnz": A.nnz,
            "register_frame_bytes": frame_bytes,
            "max_frame_bytes": MAX_FRAME_BYTES, "register_s": t_register,
            "first_solve_s": first["s"], "lone_solve_s": lone1["s"],
            "round1": stats1, "round2": stats2, "update": upd,
            "answers": n_answers, "worst_rel_residual": worst,
            "worst_x_vs_in_process": worst_x, "bit_equal_answers": equal,
            "launches": counts, "session_store_bytes": store_bytes,
            "lowering_bytes": dh.nbytes, "pool_bytes": pool,
            "state_bytes": state}
    log(f"wire: laplace_3d({WIRE_SIZE}) ({A.nrows} rows, {A.nnz} nnz), "
        f"register frame {frame_bytes} bytes (limit {MAX_FRAME_BYTES}) in "
        f"{t_register:.2f} s; first solve {first['s']:.2f} s (setup, lowering, "
        f"captures), a lone solve {lone1['s'] * 1e3:.1f} ms")
    for name, st in (("round 1", stats1), ("after the update", stats2)):
        log(f"  {name}: {st['requests']} solves in {st['wall_s']:.3f} s = "
            f"{st['solves_per_s']:.2f} solves/s over the wire, latency p50 "
            f"{st['p50_ms']:.1f} ms, p99 {st['p99_ms']:.1f} ms")
    log(f"  update: {upd}; {n_answers} answers, worst relative residual "
        f"{worst:.2e}, vs the in-process service {worst_x:.2e} of max|x| "
        f"({equal} bit-equal); launches {counts}")
    log(f"  session bytes as the store counts them: {store_bytes} "
        f"({store_bytes / 2**20:.1f} MiB; lowering {dh.nbytes}, of which graph "
        f"pool {pool} and state buffers {state})")
    return info


def process_rhs(n: int):
    """The main path's ``b`` and ``[n, K_RHS]`` ``B``, drawn as ``main``
    draws them (each rank of the process phase draws its own copy)."""
    rng = np.random.default_rng(SEED)
    b = rng.standard_normal(n)
    return b, np.stack([b] + [rng.standard_normal(n)
                              for _ in range(K_RHS - 1)], axis=1)


def process_rank(ranks) -> dict:
    """One rank of the process phase, in a spawned process: the entry point
    with ``ranks="process"`` on ``laplace_3d(SIZE)``, f64 PCG to 1e-8 with
    one RHS (launch counters set to 0 just before, read just after) and
    with ``[n, K_RHS]``, a warm solve timed, the audit of (V, Jacobi)'s ten
    programs, the elements one PCG iteration sends over the slow and
    the fast group under ``auto`` and each forced strategy, and a bfloat16
    PCG to BF16_TOL (its own lowering of the same host setup; counted, a
    warm solve timed)."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.analysis.comm_audit import audit_hierarchy, rank_traffic

    A = laplace_3d(SIZE)
    b, B = process_rhs(A.nrows)
    cfg = AMGConfig(backend="torch", ranks="process", n_pods=N_PODS,
                    lanes=LANES, dtype="float64", tol=1e-8, device=DEVICE)
    t0 = time.perf_counter()
    bound = AMGSolver(cfg).setup(A)
    setup_wall = time.perf_counter() - t0
    dh = bound.dist_hierarchy
    res, c1 = counted(lambda: bound.pcg(b))
    resm, cm = counted(lambda: bound.pcg(B))
    tensors = [t for a in dh._arrs for v in a.values()
               for t in (v.values() if isinstance(v, dict) else (v,))]
    tensors += [t for k in (None, K_RHS)
                for t in dh.programs.state(k).values()]
    true_rel = float(np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = bound.pcg(b)
    ms_iter = (time.perf_counter() - t0) * 1e3 / max(warm.iterations, 1)
    t0 = time.perf_counter()
    audits, violations = audit_hierarchy(dh, pairs=[("V", "jacobi")])
    audit_s = time.perf_counter() - t0
    traffic = {"auto": rank_traffic(dh)}
    for strategy in ("standard", "nap2", "nap3"):
        other = AMGSolver(cfg.replace(strategy=strategy)).setup(A)
        traffic[strategy] = rank_traffic(other.dist_hierarchy)
    del other
    bound16 = AMGSolver(cfg.replace(dtype="bfloat16", tol=BF16_TOL)).setup(A)
    res16, c16 = counted(lambda: bound16.pcg(b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm16 = bound16.pcg(b)
    bf16 = {"iterations": res16.iterations, "converged": res16.converged,
            "hist": list(res16.residuals), "x": res16.x,
            "launches": c16, "dtype": str(bound16.dist_hierarchy.dtype),
            "ms_iter": (time.perf_counter() - t0) * 1e3
            / max(warm16.iterations, 1), **bound16.dist_hierarchy.timings}
    return {"rank": ranks.rank, "backend": ranks.backend, "bf16": bf16,
            "all_to_all": process_all_to_all(ranks),
            "devices": sorted({str(t.device) for t in tensors}),
            "iterations": res.iterations, "converged": res.converged,
            "hist": list(res.residuals), "true_rel": true_rel,
            "cols": [list(c.residuals) for c in resm.columns],
            "cols_iterations": [c.iterations for c in resm.columns],
            "launches": c1, "launches_multi": cm, "ms_iter": ms_iter,
            "setup_wall_s": setup_wall, **dh.timings,
            "audits": len(audits), "audit_s": audit_s,
            "violations": [str(v) for v in violations], "traffic": traffic}


def process_all_to_all(ranks) -> dict:
    """One ``hier_all_to_all`` of each strategy between the processes, on
    chunks on the card that every rank draws alike: bit-equal to this
    rank's row of the stacked form, with its log."""
    from repro_torch.core.nap_collectives import hier_all_to_all

    D, d = N_PODS * LANES, ranks.rank
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.randn((D, D, 1024), generator=gen, device=DEVICE)
    out = {}
    for strategy in ("flat", "nap3"):
        log = []
        mine = hier_all_to_all(x[d:d + 1], N_PODS, LANES, strategy, log=log,
                               ranks=ranks)
        stacked = hier_all_to_all(x, N_PODS, LANES, strategy)[d]
        out[strategy] = {"bit_equal": bool(torch.equal(mine[0], stacked)),
                         "log": log, "device": str(mine.device)}
    return out


def process_phase(A, b, B, res, resm, c_single, c_multi, ms_iter,
                  res16) -> dict:
    """``AMGConfig(ranks="process")``: 8 gloo processes on this card, each
    holding its rank of the 2×4 grid (:func:`process_rank`), against the
    stacked session's f64 runs of phases 4-5: every rank's tensors on
    ``cuda:0``; its launch counts equal to the stacked session's for the
    same iterations; the same iterations (a difference of one only where
    the stacked run's residual lies within 1e-12 of r0 of the tolerance);
    histories within ``HIST_TOL`` of r0 of the stacked ones and identical
    on every rank; 0 audit violations on every rank.  Each rank's bfloat16
    PCG is held to ``res16``, the stacked bfloat16 session's PCG of ``b``:
    bit for bit, or else within the bfloat16 bars (iterations ±1,
    |log(r_i / r_i^stacked)| ≤ BF16_LOG_BAR, x within BF16_X_BAR of the
    f64 x), identical on every rank either way.  The
    kernels were built by phase 2, so no rank runs ``nvcc``."""
    from repro_torch.core.nap_collectives import all_to_all_signature
    from repro_torch.launch.ranks import spawn

    pb, pB = process_rhs(A.nrows)
    check(np.array_equal(pb, b) and np.array_equal(pB, B),
          "the ranks' right-hand sides are not the main path's")
    t0 = time.perf_counter()
    outs = spawn(process_rank, N_PODS, LANES, deadline=PROCESS_DEADLINE)
    wall = time.perf_counter() - t0
    hist = res.residuals
    nb = float(np.linalg.norm(b))
    # how near the stacked run's last two residuals lie to the tolerance
    margin = min(abs(r - 1e-8 * nb) for r in hist[-2:]) / hist[0]
    tally = {k: c_single[k] for k in SPMV_KERNELS}
    tally_m = {k: c_multi[k] for k in SPMV_KERNELS}
    for out in outs:
        r = out["rank"]
        check(out["devices"] == ["cuda:0"],
              f"rank {r} holds tensors on {out['devices']}")
        check(out["converged"] and out["true_rel"] < 1e-7,
              f"rank {r}: PCG converged {out['converged']}, true residual "
              f"{out['true_rel']:.2e}")
        same_iters = out["iterations"] == res.iterations
        check(same_iters or (abs(out["iterations"] - res.iterations) == 1
                             and margin <= 1e-12),
              f"rank {r}: {out['iterations']} iterations, stacked "
              f"{res.iterations} (margin {margin:.2e} of r0)")
        hd = history_diff(hist, out["hist"])
        check(hd <= HIST_TOL, f"rank {r}: history vs stacked {hd:.2e}")
        check(out["hist"] == outs[0]["hist"]
              and out["cols"] == outs[0]["cols"],
              f"rank {r}'s histories differ from rank 0's")
        for j, col in enumerate(resm.columns):
            cd = history_diff(col.residuals, out["cols"][j])
            check(cd <= HIST_TOL and out["cols_iterations"][j]
                  == col.iterations,
                  f"rank {r}: [n, {K_RHS}] column {j} vs stacked {cd:.2e}, "
                  f"{out['cols_iterations'][j]} vs {col.iterations} iterations")
        got = {k: out["launches"][k] for k in SPMV_KERNELS}
        got_m = {k: out["launches_multi"][k] for k in SPMV_KERNELS}
        check(got["ell_spmv"] > 0 and got["bcsr_spmm"] > 0
              and got_m["ell_spmm"] > 0,
              f"rank {r} launched {got} (one RHS), {got_m} (k = {K_RHS})")
        if same_iters:
            check(got == tally and got_m == tally_m,
                  f"rank {r} launched {got} / {got_m}, the stacked session "
                  f"{tally} / {tally_m}")
        check(not out["violations"],
              f"rank {r}: {len(out['violations'])} audit violations: "
              f"{out['violations'][:3]}")
        for strategy, a2a in out["all_to_all"].items():
            check(a2a["bit_equal"] and a2a["device"] == "cuda:0"
                  and tuple(a2a["log"]) == all_to_all_signature(strategy),
                  f"rank {r}: hier_all_to_all {strategy} {a2a}")
    o0 = outs[0]
    bf16 = process_bf16(outs, res16, res.x)
    log(f"process ranks ({N_PODS} x {LANES} {o0['backend']} processes on "
        f"cuda:0, laplace_3d({SIZE}) f64): {o0['iterations']} iterations "
        f"(stacked {res.iterations}; last residuals {margin:.2e} of r0 from "
        f"the tolerance), history vs stacked "
        f"{max(history_diff(hist, o['hist']) for o in outs):.2e}, identical "
        f"on all ranks; launches {o0['launches']} / [n, {K_RHS}] "
        f"{o0['launches_multi']} on every rank (stacked {tally} / {tally_m})")
    log(f"  ms an iteration (warm): ranks "
        f"{[round(o['ms_iter'], 3) for o in outs]}, stacked graphs "
        f"{ms_iter:.3f}; rank 0: host setup {o0['setup_s']:.2f} s, lowering "
        f"{o0['lower_s']:.2f} s, scatter {o0['scatter_s']:.2f} s (ranks "
        f"{[round(o['scatter_s'], 2) for o in outs]}); phase {wall:.1f} s")
    log(f"  audit: {o0['audits']} audits a rank, 0 violations on every rank "
        f"({o0['audit_s']:.1f} s)")
    log(f"  hier_all_to_all of [8, 8, 1024] chunks on cuda:0, flat (log "
        f"{o0['all_to_all']['flat']['log']}) and nap3 (log "
        f"{o0['all_to_all']['nap3']['log']}): bit-equal to the stacked form "
        f"on every rank")
    log("  elements sent a PCG iteration per rank, slow (across pods) / fast "
        "(within a pod), beside the model's messages per cycle (all ranks):")
    for strategy, t0r in o0["traffic"].items():
        m = t0r["modeled_cycle"]
        log(f"    {strategy:8s} slow "
            f"{[o['traffic'][strategy]['elements'].get('slow', 0) for o in outs]}"
            f" fast "
            f"{[o['traffic'][strategy]['elements'].get('fast', 0) for o in outs]}"
            f"; modeled inter {m['inter_msgs']} msgs / {m['inter_bytes']:.0f} B,"
            f" intra {m['intra_msgs']} msgs / {m['intra_bytes']:.0f} B")
    log(f"    auto by strategy, rank 0: {o0['traffic']['auto']['by_strategy']}")
    log("  collectives' host ms in one PCG iteration, slow / fast, by rank: "
        + ", ".join(f"{strategy} " + str([
            (round(o["traffic"][strategy]["seconds"].get("slow", 0) * 1e3, 1),
             round(o["traffic"][strategy]["seconds"].get("fast", 0) * 1e3, 1))
            for o in outs]) for strategy in o0["traffic"]))
    return {"ranks": len(outs), "backend": o0["backend"], "phase_s": wall,
            "iterations": o0["iterations"], "margin_of_r0": margin,
            "history_vs_stacked": max(history_diff(hist, o["hist"])
                                      for o in outs),
            "ms_per_iteration": [o["ms_iter"] for o in outs],
            "stacked_ms_per_iteration": ms_iter,
            "setup_s": o0["setup_s"], "lowering_s": o0["lower_s"],
            "scatter_s": [o["scatter_s"] for o in outs],
            "launches": o0["launches"], "launches_multi": o0["launches_multi"],
            "audits_per_rank": o0["audits"],
            "all_to_all": o0["all_to_all"], "bf16": bf16,
            "traffic": [o["traffic"] for o in outs]}


def process_bf16(outs, res16, x64) -> dict:
    """The process ranks' bfloat16 PCG against the stacked bfloat16
    session's (``res16``) and the f64 x: see :func:`process_phase`."""
    o0 = outs[0]["bf16"]
    ref = list(res16.residuals)
    for out in outs:
        r, got = out["rank"], out["bf16"]
        check(got["converged"] and got["dtype"] == "torch.bfloat16"
              and got["launches"]["ell_spmv"] > 0,
              f"rank {r}: bf16 PCG converged {got['converged']}, "
              f"{got['dtype']}, launches {got['launches']}")
        check(got["hist"] == o0["hist"] and np.array_equal(got["x"], o0["x"]),
              f"rank {r}'s bf16 history or x differs from rank 0's")
    bit_equal = o0["hist"] == ref and np.array_equal(o0["x"], res16.x)
    n = min(len(ref), len(o0["hist"]))
    gap = float(np.abs(np.log(np.divide(o0["hist"][:n], ref[:n]))).max())
    xdiff = float(np.linalg.norm(o0["x"].astype(np.float64) - x64)
                  / np.linalg.norm(x64))
    check(bit_equal or (abs(o0["iterations"] - res16.iterations) <= 1
                        and gap <= BF16_LOG_BAR and xdiff <= BF16_X_BAR),
          f"process bf16 PCG: {o0['iterations']} iterations (stacked "
          f"{res16.iterations}), |log(r_i / r_i^stacked)| {gap:.3e}, x "
          f"{xdiff:.3e} from the f64 x")
    log(f"  bf16 PCG (tol {BF16_TOL:g}) on the ranks: {o0['iterations']} "
        f"iterations (stacked {res16.iterations}), "
        + ("bit-equal to the stacked bf16 session" if bit_equal else
           f"not bit-equal to the stacked session: |log(r_i / r_i^stacked)| "
           f"{gap:.3e}") + f", identical on every rank, x {xdiff:.3e} from "
        f"the f64 x; ms an iteration (warm) "
        f"{[round(o['bf16']['ms_iter'], 3) for o in outs]}; rank 0 lowering "
        f"{o0['lower_s']:.2f} s, scatter {o0['scatter_s']:.2f} s; launches "
        f"{o0['launches']}")
    return {"iterations": o0["iterations"],
            "stacked_iterations": res16.iterations, "bit_equal": bit_equal,
            "log_gap": gap, "x_rel_diff_f64": xdiff,
            "ms_per_iteration": [o["bf16"]["ms_iter"] for o in outs],
            "lowering_s": o0["lower_s"], "scatter_s": o0["scatter_s"],
            "launches": o0["launches"]}


def ell_bf16_top(rows: list, amg_bf16: dict, name: str) -> dict:
    """An ELL kernel's bfloat16 numbers for the kernels line: level 0's A_on
    (back to back and with the L2 flushed) and the sums over the bfloat16
    solve's operands."""
    top = next(r for r in rows if r["dtype"] == "bfloat16" and r["operand"] == "L0 A_on")
    return {"operand": "L0 A_on", "design": top["design"], "ms": top["ms"],
            "cold_ms": top["cold_ms"], "bound_ms": top["bound_ms"],
            "plain_ms": top["plain_ms"], "library_ms": top["library_ms"],
            "max_abs_err": top["max_abs_err"], "bar_ratio": top["rel_err"],
            "launches_per_solve": amg_bf16["ell_launches_per_solve"][name],
            **amg_bf16["ell_sums"][name]}


def smoother_bf16_top(rows: list, bf16: dict, name: str) -> dict:
    """A block-smoother kernel's bfloat16 main-path case for the kernels
    line (level 0, k = 1, the route the rule takes): its times, bounds,
    check and launches in the bfloat16 solves."""
    top = next(r for r in rows if r["dtype"] == "bfloat16" and r["k"] == 1
               and r["main_path"])
    return {"ms": top["ms"], "plain_ms": top["plain_ms"],
            "library_ms": top["library_ms"],
            "library": top.get("library", "torch.matmul (batched, bf16)"),
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "step_bound_ms": top.get("step_bound_ms"),
            "route": top.get("route"), "max_abs_err": top["max_abs_err"],
            "bar_ratio": top["rel_err"],
            "bit_equal_plain": top["bit_equal_plain"],
            "bit_equal_emulation": top.get("bit_equal_emulation"),
            **({"step_floor_us": bf16["step_floor_us"]} if name == "tri_solve" else {}),
            "launches": bf16["launches"].get(name, 0)}


def flash_instances(rows, ptxas, head_dim: int) -> dict:
    """The flash instances at ``head_dim``, by type: the kernel that serves
    it, ``ptxas -v``'s registers and spills of its instance, and each case's
    kernel, bound, plain and SDPA ms and error."""
    out = {}
    # demangled: "void <unnamed>::flash_attention_kernel<float, (int)256>",
    # "void <unnamed>::flash_wgmma_kernel<(int)256>"
    for dt, kname, tag in (("float32", "flash_attention", "<float, "),
                           ("bfloat16", "flash_attention_wgmma", "<")):
        cases = {r["case"]: {key: r.get(key) for key in (
            "kernel", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "tflops", "rel_err", "max_abs_err")}
            for r in rows if r["dtype"] == dt and r["head_dim"] == head_dim}
        out[dt] = {"kernel": sorted({c["kernel"] for c in cases.values()}),
                   "ptxas": [u for n, u in ptxas[kname]
                             if f"{tag}(int){head_dim}>" in n],
                   "cases": cases}
        check(len(out[dt]["ptxas"]) == 1 and out[dt]["kernel"] == [kname],
              f"flash_attention {dt} at head dim {head_dim}: {out[dt]}")
    return out


def history_diff(a, b) -> float:
    n = min(len(a), len(b))
    r0 = a[0] or 1.0
    return max(abs(x - y) / r0 for x, y in zip(a[:n], b[:n]))


# the dry-run phase: the five full-width cells on the fake 2x16x16 mesh,
# each traced at 1 and 2 pattern groups with its production microbatches
# and extrapolated to full depth (the reference's probes; the CPU tests
# hold the extrapolation to a full-depth trace), the peak memory too: a
# full-depth trace takes 40-50 s a train cell on the chip machine's CPU
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen2-0.5b", "train_4k"),
                ("mixtral-8x22b", "decode_32k"), ("xlstm-125m", "long_500k"),
                ("recurrentgemma-9b", "prefill_32k"))
ERT_REPLACES = ("none (the reference's ERT loops are jitted jnp, no Pallas "
                "kernel): src/repro/launch/roofline.py:223, :237")
ERT_T = 16                   # the kernel-vs-plain case's FMAs an element


def ert_rows() -> dict[str, list]:
    """``ert_stream`` (t = 16) and ``ert_gather`` against their plain
    versions past the L2, in f32 and f64; the gather beside ``torch.take``."""
    from repro_torch.kernels.ert.ert import ert_gather, ert_stream
    from repro_torch.kernels.ert.ref import ert_gather_ref, ert_stream_ref
    rows = {"ert_stream": [], "ert_gather": []}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = 1 << 26
    for dt in (torch.float32, torch.float64):
        x = torch.randn(n, generator=gen, device="cuda", dtype=dt)
        idx = torch.randint(0, n, (n,), generator=gen, device="cuda",
                            dtype=torch.int64).to(torch.int32)
        esz = x.element_size()
        rows["ert_stream"].append(kernel_case(
            "ert_stream", lambda x: ert_stream(x, ERT_T),
            lambda x: ert_stream_ref(x, ERT_T, 1.0000001, 0.5), None, (x,),
            2 * n * esz, 2 * ERT_T * n,
            peak=67e12 if dt == torch.float32 else 34e12, plain_samples=5))
        idx64 = idx.long()          # torch.take reads int64 indices
        rows["ert_gather"].append(kernel_case(
            "ert_gather", ert_gather, ert_gather_ref,
            lambda: torch.take(x, idx64), (x, idx), n * (2 * esz + 4), 0,
            library_name="torch.take", plain_samples=5))
        del x, idx, idx64
    return rows


def dryrun_phase(smi: str) -> tuple[dict, list]:
    """The roofline's measured ceilings (the ERT sweep in f32 and f64), the
    AMG cell on 2 x 256 stacked ranks and the five full-width dry-run
    cells.  Returns the numbers and the ERT kernels' entries of the kernels
    line."""
    import torch.distributed as dist

    from repro_torch.kernels.build import source_path
    from repro_torch.kernels.ert.ert import ert_gather, ert_stream
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_mesh

    out: dict = {}
    t0 = time.perf_counter()
    rows = ert_rows()
    # the main path of the ERT kernels: the sweeps, counted
    for w in (ert_stream, ert_gather):
        w.launches = 0
    sweeps = {str(dt).replace("torch.", ""): roofline.ert_sweep(dtype=dt)
              for dt in (torch.float32, torch.float64)}
    torch.cuda.synchronize()
    ert_launches = {"ert_stream": ert_stream.launches,
                    "ert_gather": ert_gather.launches}
    for k, n in ert_launches.items():
        check(n > 0, f"{k} launched no time in the ERT sweeps")
    for dt, sw in sweeps.items():
        log(f"ERT {dt} on {smi}: stream {sw['stream_bw'] / 1e9:.1f} GB/s, "
            f"gather {sw['gather_bw'] / 1e9:.1f} GB/s, "
            f"{sw['flops'] / 1e12:.2f} TFLOP/s of one FMA chain a thread "
            f"(the reference's sets, 2^16-2^23: not an L2 ceiling); "
            f"past L2 (2^26, 2^28): stream "
            f"{sw['past_l2_stream_bw'] / 1e9:.1f} GB/s, gather "
            f"{sw['past_l2_gather_bw'] / 1e9:.1f} GB/s, "
            f"{sw['past_l2_flops'] / 1e12:.2f} TFLOP/s")
    out["ert"] = sweeps
    out["ert_s"] = time.perf_counter() - t0

    # the AMG cell: one logged apply per strategy on 2 x 256 stacked ranks
    t1 = time.perf_counter()
    amg = dryrun.run_amg_cell(multi_pod=True, n=24, device="cuda")
    for r in amg:
        check(r["halo_bit_equal"] and r["spmv_max_err"] <= 1e-12,
              f"AMG cell {r['arch']}: halo / SpMV {r['spmv_max_err']:.2e}")
    out["amg"] = amg
    out["amg_s"] = time.perf_counter() - t1
    log(f"ERT {out['ert_s']:.1f} s, AMG cell {out['amg_s']:.1f} s")

    # the production dry-run at full width on the fake 2x16x16 mesh
    t1 = time.perf_counter()
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), device_type="cuda")
    hbm = sweeps["float32"]["past_l2_stream_bw"]
    cells = []
    for arch, shape in DRYRUN_CELLS:
        kw = {k: (dict(v) if isinstance(v, dict) else v) for k, v in
              dryrun.PROD_CELL_OPTS.get((arch, shape), {}).items()}
        meta = dryrun.run_cell(arch, shape, mesh=mesh, production=False,
                               verbose=False, **kw)
        n_dev = meta["n_devices"]
        check(meta["flops_per_dev"] * n_dev >= meta["model_flops"],
              f"{arch} {shape}: {meta['flops_per_dev']:.3e} FLOPs a device x "
              f"{n_dev} < model FLOPs {meta['model_flops']:.3e}")
        measured = roofline.roofline_terms(
            meta["flops_per_dev"], meta["bytes_per_dev"],
            {"total_bytes": meta["coll_bytes_per_dev"],
             "cross_slow_bytes": meta["cross_pod_bytes_per_dev"]},
            n_dev, meta["model_flops"], ceilings={"hbm_bw": hbm})
        meta["measured_memory_s"] = measured.memory_s
        log(f"dry-run {arch} x {shape} x 2x16x16: traces {meta['trace_s']:.1f} s, "
            f"peak {meta['peak_bytes_per_dev'] / 2**30:.2f} GiB a device of "
            f"80 (an estimate, extrapolated from the probes), "
            f"{meta['flops_per_dev']:.3e} FLOPs a "
            f"device (model {meta['model_flops'] / n_dev:.3e}), collective "
            f"{meta['coll_bytes_per_dev']:.3e} B, pod-crossing "
            f"{meta['cross_pod_bytes_per_dev']:.3e} B, n {meta['n_collectives']}; "
            f"terms (documented) compute {meta['compute_s']:.4f} s memory "
            f"{meta['memory_s']:.4f} s collective {meta['collective_s']:.4f} s "
            f"cross-pod {meta['cross_pod_s']:.4f} s, memory at the measured "
            f"{hbm / 1e9:.0f} GB/s {measured.memory_s:.4f} s, dominant "
            f"{meta['dominant']}")
        cells.append(meta)
    out["cells"] = cells
    out["cells_s"] = time.perf_counter() - t1
    log(f"dry-run cells {out['cells_s']:.1f} s")
    # the real sharded step (8 gloo ranks on cuda:0) is not run here: gloo
    # crashes (SIGSEGV on every rank) on the functional all-gather that
    # DTensor issues, _c10d_functional.all_gather_into_tensor, on CUDA
    # tensors (scripts/gloo_cuda_probe.py); the CPU tests run the same step
    # on 8 gloo CPU ranks against the one-device step and its fake trace
    dist.destroy_process_group()          # the fake production group
    out["phase_s"] = time.perf_counter() - t0
    check(out["phase_s"] < 150, f"dry-run phase took {out['phase_s']:.1f} s")
    entries = []
    for k in ("ert_stream", "ert_gather"):
        top = rows[k][0]
        entries.append({
            "name": k, "route": "cuda",
            "source": str(source_path(k).relative_to(ROOT)),
            "replaces": ERT_REPLACES, "launches": ert_launches[k],
            "max_abs_err": top["max_abs_err"], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "card": smi, "variants": rows[k]})
    return out, entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    clock = {"t": time.perf_counter()}
    phase_s: dict[str, float] = {}

    def lap(name: str) -> None:
        """The seconds since the last lap, as phase ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = now - clock["t"]
        clock["t"] = now

    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.configs import get_arch
    from repro_torch.kernels.build import build, build_report, source_path

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name}, capability {cap[0]}.{cap[1]}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    per = build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in per.items()) or 'cached'})")
    ptxas = {k: build_report(k) for k in (*FLASH_KERNELS, "ell_spmv", "ell_spmm",
                                          *SMOOTHER_KERNELS)}
    for k, insts in ptxas.items():
        for inst, used in insts:
            log(f"  ptxas {inst}: {used}")

    # the main path's problem and sessions (host setup + lowering)
    A = laplace_3d(SIZE)
    rng = np.random.default_rng(SEED)
    b = rng.standard_normal(A.nrows)
    cfg64 = AMGConfig(backend="torch", n_pods=N_PODS, lanes=LANES,
                      dtype="float64", tol=1e-8, device=DEVICE)
    t0 = time.perf_counter()
    bound64 = AMGSolver(cfg64).setup(A)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    dh64 = bound64.dist_hierarchy
    t_lower64 = time.perf_counter() - t0
    log(f"laplace_3d({SIZE}): {A.nrows} rows, {A.nnz} nnz, "
        f"{len(dh64.levels)} levels; host setup {t_setup:.2f} s, "
        f"lowering f64 {t_lower64:.2f} s")
    log(f"  layouts: {[r['kernel'] + (str(r['block_size']) if r['block_size'] else '') for r in dh64.kernel_table()]}")
    log(f"  strategies: {[(r['level'], r['op'], r['strategy']) for r in dh64.selection_table()]}")
    bound32 = AMGSolver(dataclasses.replace(cfg64, dtype="float32", tol=1e-5)) \
        .setup(A)
    t0 = time.perf_counter()
    dh32 = bound32.dist_hierarchy
    log(f"  lowering f32 {time.perf_counter() - t0:.2f} s")

    lap("device, build, setup and lowerings")
    # 3. kernels
    B = np.stack([b] + [rng.standard_normal(A.nrows)
                        for _ in range(K_RHS - 1)], axis=1)
    per_solve = {}
    for kname, rhs in (("ell_spmv", b), ("ell_spmm", B)):
        per_solve[kname], tally_iters = operand_launches(bound64, rhs, kname)
        log(f"{kname} launches of one f64 solve of {list(rhs.shape)} "
            f"({tally_iters} iterations) by operand, per solve / per iteration "
            f"({tally_iters + 1} cycles with their A.p): "
            + ", ".join(f"{k} {v} / {v / (tally_iters + 1):g}"
                        for k, v in per_solve[kname].items()))
    log(f"kernels (device time per call: CUDA events, median of {SAMPLES} "
        f"bursts of {BURST} queued behind a GPU spin):")
    rows, ell_sums = kernel_phase(dh64, dh32, per_solve)
    smoother_rows, tri_summary = smoother_kernel_phase(dh64, dh32)
    rows.update(smoother_rows)

    # a BCSR apply is one launch: no pad of x before it, no slice after
    # (profiled before the warm solve's large profile below)
    bcsr_apply = bcsr_apply_kernels(dh64, APPLY_REPS)
    for l, names in bcsr_apply.items():
        check(len(names) == 1 and "bcsr_spmm_kernel" in next(iter(names))
              and sum(names.values()) == APPLY_REPS,
              f"{APPLY_REPS} BCSR applies of level {l} ran {names}, want as "
              f"many bcsr_spmm launches and nothing else")
    log(f"{APPLY_REPS} BCSR applies per BCSR level, profiled alone: device kernels "
        f"{ {l: {n[:50]: c for n, c in v.items()} for l, v in bcsr_apply.items()} }")

    lap("kernels")
    # 4. main path, f64
    res, c_single = counted(lambda: bound64.pcg(b))
    check(res.converged, f"f64 PCG did not converge: {res.residuals[-3:]}")
    check(c_single["ell_spmv"] == sum(per_solve["ell_spmv"].values()),
          f"the f64 solve launched ell_spmv {c_single['ell_spmv']} times, its "
          f"tally by operand {sum(per_solve['ell_spmv'].values())}")
    host = AMGSolver(dataclasses.replace(cfg64, backend="host")).setup(A)
    res_h = host.pcg(b)
    hd = history_diff(res_h.residuals, res.residuals)
    check(abs(res_h.iterations - res.iterations) <= 1 and hd <= HIST_TOL,
          f"f64 PCG history vs host: diff {hd:.2e}, iterations "
          f"{res.iterations} vs {res_h.iterations}")
    true_rel = float(np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b))
    check(true_rel < 1e-7, f"true residual {true_rel:.2e}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = bound64.pcg(b)
    ms_iter = (time.perf_counter() - t0) * 1e3 / max(warm.iterations, 1)
    log(f"pcg f64: {res.iterations} iterations, converged, history vs host "
        f"{hd:.2e}, true residual {true_rel:.2e}, launches {c_single}")
    # where the time of that warm solve goes on the device
    runtime: dict[str, int] = {}
    prof = device_profile(lambda: bound64.pcg(b), runtime)
    dev_ms = sum(v[0] for v in prof.values())
    busy = dev_ms / (ms_iter * max(warm.iterations, 1)) if prof else None
    top_dev = sorted(prof.items(), key=lambda kv: -kv[1][0])[:8]
    dev_iter = dev_ms / max(warm.iterations, 1)
    log(f"  captured graphs: {ms_iter:.3f} ms/iteration (warm, whole call / "
        f"iterations; eager {EAGER_MS_ITER}), device "
        + (f"{dev_iter:.3f} ms/iteration (eager {EAGER_DEVICE_MS_ITER}), busy "
           f"share {busy:.3f} (eager {EAGER_BUSY}) of the unprofiled wall time"
           if prof else "time not measured (no device events)"))
    n_dev = sum(v[1] for v in prof.values())
    log(f"  {n_dev} device kernels in the warm solve; host CUDA runtime calls "
        f"{dict(sorted(runtime.items(), key=lambda kv: -kv[1]))}")
    for kname, (kms, kcount) in top_dev:
        log(f"    {kms:9.3f} ms {kcount:6d}x  {kname[:100]}")
    graphs = graph_phase(bound64, b, res)

    # 5. multi-RHS
    resm, c_multi = counted(lambda: bound64.pcg(B))
    check(resm.converged, "multi-RHS PCG did not converge")
    check(c_multi["ell_spmm"] == sum(per_solve["ell_spmm"].values()),
          f"the k = {K_RHS} solve launched ell_spmm {c_multi['ell_spmm']} "
          f"times, its tally by operand {sum(per_solve['ell_spmm'].values())}")
    worst = 0.0
    for j in range(K_RHS):
        rj = res if j == 0 else bound64.pcg(B[:, j])
        cj = resm.columns[j]
        xd = float(np.abs(cj.x - rj.x).max() / np.abs(rj.x).max())
        worst = max(worst, history_diff(rj.residuals, cj.residuals), xd)
        check(abs(rj.iterations - cj.iterations) <= 1,
              f"column {j}: {cj.iterations} vs {rj.iterations} iterations")
    check(worst <= HIST_TOL, f"multi-RHS columns vs single runs: {worst:.2e}")
    log(f"pcg f64 [n, {K_RHS}]: {resm.iterations} iterations, columns vs "
        f"single-RHS runs {worst:.2e}, launches {c_multi}")

    # 6. f32 session
    res32, c_f32 = counted(lambda: bound32.pcg(b))
    check(res32.converged, f"f32 PCG did not converge: {res32.residuals[-3:]}")
    log(f"pcg f32 (tol 1e-5): {res32.iterations} iterations, launches {c_f32}")
    lap("solves (f64, multi-RHS, f32, graphs)")

    # 6b. the bfloat16 session on the same host setup
    bf16_rows, c_bf16, amg_bf16, bound16, res16 = bf16_phase(
        cfg64, A, b, B, res, resm, c_single)
    for k in SPMV_KERNELS:
        rows[k].extend(bf16_rows[k])
    lap("bf16")

    # the block smoothers through the same sessions' lowerings
    t0 = time.perf_counter()
    x64: dict = {}
    block = block_smoother_phase(cfg64, A, b, B, dh64, dh32, xs=x64)
    block["phase_s"] = time.perf_counter() - t0
    log(f"block-smoother phase: {block['phase_s']:.1f} s in all")
    lap("block smoothers")

    # the block smoothers in bfloat16 on the bfloat16 session's lowering
    bf16_smoother, block["bf16"] = bf16_block_phase(bound16, A, b, B, x64)
    for k in SMOOTHER_KERNELS:
        rows[k].extend(bf16_smoother[k])
    release_lowering(bound16)
    del bound16, x64
    torch.cuda.empty_cache()
    lap("bf16 block smoothers")
    # 7. launch counts over the solve runs
    launches = {k: c_single[k] + c_multi[k] + c_f32[k] + c_bf16[k]
                for k in SPMV_KERNELS}
    launches.update({k: block["launches"].get(k, 0)
                     + block["bf16"]["launches"].get(k, 0)
                     for k in SMOOTHER_KERNELS})
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the main path")
    log(f"launches on the solve path: {launches}")

    # the partitioned setup (setup_backend="dist") on the same problem,
    # against the host-setup f64 session before its refresh
    t0 = time.perf_counter()
    partitioned, born = partitioned_phase(cfg64, A, b, B, bound64, res,
                                          per_solve, c_single)
    t_part = time.perf_counter() - t0

    # the service on the f64 session's lowering, then a streaming refresh
    # beneath its graphs (both after the counted runs); the dist-born
    # session takes the same drift and is held against the refreshed one
    service = service_phase(cfg64, A, rng)
    refresh = refresh_phase(bound64, host, A, b, t_lower64)
    block["refresh"] = block_refresh_phase(cfg64, bound64, b)
    t0 = time.perf_counter()
    partitioned.update(partitioned_update_phase(born, bound64, A, b,
                                                partitioned))
    block["dist_born"] = born_block_phase(born, b,
                                          block["refresh"]["iterations"])
    del born
    torch.cuda.empty_cache()
    partitioned["aggressive"] = aggressive_phase(cfg64)
    partitioned["phase_s"] = t_part + time.perf_counter() - t0
    log(f"partitioned setup phase: {partitioned['phase_s']:.1f} s in all")
    lap("partitioned setup, service, refresh")
    audit = audit_phase(bound64, b)
    lap("audit")
    del bound64, bound32, host, dh64, dh32
    torch.cuda.empty_cache()
    wire = wire_phase(cfg64)
    torch.cuda.empty_cache()
    lap("wire")
    process = process_phase(A, b, B, res, resm, c_single, c_multi, ms_iter,
                            res16)
    lap("process ranks")

    # 8. flash attention at the serving run's shapes
    cfg = get_arch(LM_ARCH)
    prompts = lm_workload(cfg.vocab)
    S = max(len(p) for p in prompts)
    log(f"flash_attention (S = {S}, the longest prompt; device time as above):")
    all_flash = flash_phase(S)
    for k in FLASH_KERNELS:
        rows[k] = [r for r in all_flash if r["kernel"] == k]
    torch.cuda.empty_cache()
    lap("flash")

    # 9-10. LM serving in f32, then the first batch again in bf16; each
    # held against the plain attention, teacher-forced
    lm = {}
    for dtype, batch in ((torch.float32, prompts),
                         (torch.bfloat16, prompts[:LM_BF16_REQUESTS])):
        run = lm_serve(cfg, batch, dtype)
        lm[dtype] = {**run["info"], **lm_check(cfg, run, dtype)}
        del run
        torch.cuda.empty_cache()
    f32, bf16 = lm[torch.float32], lm[torch.bfloat16]
    log(f"serve bf16 vs f32 (one prefill batch of {LM_BATCH}): prefill "
        f"{bf16['prefill_s_per_batch']:.3f} vs {f32['prefill_s_per_batch']:.3f} s "
        f"a batch, decode {bf16['decode_tok_s']:.1f} vs {f32['decode_tok_s']:.1f} "
        f"tok/s, {bf16['decode_step_ms']:.2f} vs {f32['decode_step_ms']:.2f} "
        f"ms a step")
    flash_runs = {str(d).replace("torch.", ""): {k: v["launches"][k] for k in FLASH_KERNELS}
                  for d, v in lm.items()}
    lap("LM serving")

    # 11. the MoE archs at full width, 2 layers, bf16; EP on stacked ranks
    t0 = time.perf_counter()
    moe, moe_flash = moe_phase()
    moe["phase_s"] = time.perf_counter() - t0
    log(f"MoE phase: {moe['phase_s']:.1f} s in all")
    flash_runs.update(moe_flash)
    lap("MoE")

    # 12. the recurrent archs at full width and depth
    t0 = time.perf_counter()
    recurrent, recurrent_flash = recurrent_phase()
    recurrent["phase_s"] = time.perf_counter() - t0
    log(f"recurrent phase: {recurrent['phase_s']:.1f} s in all")
    flash_runs.update(recurrent_flash)
    lap("recurrent")

    # 13. the embedding-input archs at full width and depth
    t0 = time.perf_counter()
    embed, embed_flash = embed_phase()
    embed["phase_s"] = time.perf_counter() - t0
    log(f"embedding-input phase: {embed['phase_s']:.1f} s in all")
    flash_runs.update(embed_flash)
    # the Hopper kernel's launches, and the mma.sync source's own (the
    # wrapper counts both)
    launches["flash_attention_wgmma"] = sum(v["flash_attention_wgmma"]
                                            for v in flash_runs.values())
    launches["flash_attention"] = sum(v["flash_attention"] for v in flash_runs.values()) \
        - launches["flash_attention_wgmma"]
    for k in FLASH_KERNELS:
        check(launches[k] > 0, f"{k} launched no time on the serving path")
    lap("embedding-input")

    # 14. training: qwen3-1.7b at full width and depth, xlstm-125m
    t0 = time.perf_counter()
    train = train_phase()
    train["phase_s"] = time.perf_counter() - t0
    log(f"training phase: {train['phase_s']:.1f} s in all")
    lap("training")

    # 15. the MoE and hybrid-recurrent archs trained at full width, cut in
    # depth, each against float64
    t0 = time.perf_counter()
    families = train_families_phase()
    families["phase_s"] = time.perf_counter() - t0
    log(f"training-families phase: {families['phase_s']:.1f} s in all")
    lap("training families")

    # 16. the node-aware gradient sync, stacked and over gloo ranks
    t0 = time.perf_counter()
    grad_sync = grad_sync_phase()
    grad_sync["phase_s"] = time.perf_counter() - t0
    log(f"grad-sync phase: {grad_sync['phase_s']:.1f} s in all")
    lap("grad sync")

    # 17. the dry-run: ERT ceilings, the AMG cell, the full-width cells and
    # a real sharded step
    dry, ert_entries = dryrun_phase(smi)
    log(f"dry-run phase: {dry['phase_s']:.1f} s in all")
    lap("dry-run")

    # 18. the kernels line: top-level numbers are the main path's case
    # (sparse kernels: the first float64 case on its operands, BCSR at its
    # block size with one RHS; flash: float32 at the prefill shape, the
    # wgmma kernel bf16 at recurrentgemma-9b's prefill shape); every dtype /
    # shape case is under "variants"; a flash kernel's launches are the
    # serving runs' through it; a sparse kernel's are the solve path's, with
    # the dist-born session's counted runs beside them
    kernels = []
    for k, replaces in REPLACES.items():
        if k == "flash_attention":
            top = next(r for r in rows[k] if r["main_path"]
                       and r["dtype"] == "float32")
        elif k == "flash_attention_wgmma":
            top = next(r for r in rows[k] if r["case"] == "recurrentgemma-9b prefill")
        else:
            top = next(r for r in rows[k] if r["dtype"] == "float64"
                       and r.get("main_path", True)
                       and r["k"] == (K_RHS if k == "ell_spmm" else 1))
        kernels.append({
            "name": k, "route": "cuda",
            "source": str(source_path(k).relative_to(ROOT)),
            "replaces": replaces,
            "launches": launches[k], "max_abs_err": top["max_abs_err"],
            "max_err": top["max_abs_err"], "ms": top["ms"],
            "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "card": smi,
            **({"launches_per_run": {run: v["flash_attention"] - v["flash_attention_wgmma"]
                                     for run, v in flash_runs.items()},
                "bound_fma_ms": top["bound_fma_ms"], "design": top["design"],
                **{f"instances_head_dim_{d}": flash_instances(all_flash, ptxas, d)
                   for d in (256, 96, 128, 64)}}
               if k == "flash_attention" else
               {"launches_per_run": {run: v[k] for run, v in flash_runs.items()},
                "design": top["design"], "tflops": top["tflops"]}
               if k == "flash_attention_wgmma" else
               {"pallas": False,
                "launches_per_run": {r["run"]: r["launches"][k]
                                     for r in block["runs"] + block["bf16"]["runs"]},
                "bf16": smoother_bf16_top(rows[k], block["bf16"], k),
                **({"tri_route": top["route"],
                    "us_per_step": top["us_per_step"],
                    "step_bound_ms": top["step_bound_ms"], **tri_summary}
                   if k == "tri_solve" else {})}
               if k in SMOOTHER_KERNELS else
               {"launches_per_path": {
                   "solve": launches[k], "solve_bf16": c_bf16[k],
                   "partitioned_setup": partitioned["launches"][k]
                   + partitioned["launches_multi"][k]},
                **({"bf16": ell_bf16_top(rows[k], amg_bf16, k)}
                   if k in amg_bf16["ell_sums"] else {})}),
            **({"ptxas": ptxas[k]} if k in ptxas else {}),
            "variants": rows[k]})
    kernels.extend(ert_entries)
    print(json.dumps({"kernels": kernels,
                      "path": {"setup_s": t_setup, "lowering_f64_s": t_lower64,
                               "pcg_f64_iterations": res.iterations,
                               "pcg_f64_ms_per_iteration": ms_iter,
                               "pcg_f64_device_ms": dev_ms if prof else None,
                               "pcg_f64_device_busy_share": busy,
                               "pcg_f64_device_kernels": n_dev,
                               "pcg_f64_runtime_calls": runtime,
                               "graphs": graphs, "service": service,
                               "refresh": refresh, "audit": audit,
                               "partitioned": partitioned,
                               "block_smoothers": block,
                               "wire": wire, "process_ranks": process,
                               "bcsr_apply_device_kernels": bcsr_apply,
                               "ell_spmv_launches_per_solve": per_solve["ell_spmv"],
                               "ell_spmv_excess_ms_per_solve":
                                   ell_sums["ell_spmv"]["excess_ms_per_solve"],
                               "ell_spmv_launch_ms_per_solve":
                                   ell_sums["ell_spmv"]["launch_ms_per_solve"],
                               "ell_spmm_launches_per_solve": per_solve["ell_spmm"],
                               "ell_spmm_excess_ms_per_solve":
                                   ell_sums["ell_spmm"]["excess_ms_per_solve"],
                               "ell_spmm_launch_ms_per_solve":
                                   ell_sums["ell_spmm"]["launch_ms_per_solve"],
                               "pcg_f64_top_device": [
                                   [kn[:100], km, kc]
                                   for kn, (km, kc) in top_dev],
                               "history_vs_host": hd,
                               "true_residual": true_rel,
                               "multi_rhs_worst": worst,
                               "pcg_f32_iterations": res32.iterations,
                               **{f"pcg_bf16_{key}": v
                                  for key, v in amg_bf16.items()},
                               "launches_per_run": {"f64": c_single,
                                                    "f64_multi": c_multi,
                                                    "f32": c_f32}},
                      "lm": f32, "lm_bf16": bf16, "moe": moe,
                      "recurrent": recurrent, "embed": embed, "train": train,
                      "train_families": families, "grad_sync": grad_sync, "dryrun": dry,
                      "phase_s": phase_s}),
          flush=True)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; {sum(phase_s.values()):.1f} s in all")
    log(smi)
    # 19. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
