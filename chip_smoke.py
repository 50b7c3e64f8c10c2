#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build    — compile the CUDA kernels from ``paddle_tpu_torch/csrc``
              (and, beside them, the native host library, g++).
1a. native_runtime — the port's native library on this machine
              (``core.native``): a TCPStore master and client on the
              native backend, a rendezvous of three processes on it, a
              ShmQueue carrying 64 MB from another process intact
              (sha256), no ``/dev/shm/ptq_*`` segment left.
2. checks   — every kernel against its plain PyTorch version on the card,
              with CUDA-event times of the kernel, the plain version and
              one PyTorch library call (``*_ms``, host launch cost
              included) and their device times from a profiler trace
              (``*_device_ms``).  ``checks``: the tensor-core flash
              forward in bf16 and fp16 at the serving prefill, the
              training shape, one non-causal case and head dims 128 and
              256, held against its plain version at the tiles it
              resolves; kernel A in f32 (3 x TF32 on the tensor cores);
              the LayerNorm forward B in bf16 and fp16.  ``checks_bwd``:
              the flash backward kernels C1
              (merged), C2 and C3 (split; bf16 and fp16 on the tensor
              cores, f32 as 3 x TF32 products) with each route pinned,
              head dim 64, 128 and 256, f32 and fp16 cases, one case with
              an lse cotangent, and the LayerNorm backward D in bf16 and
              fp16; C1 timed as a whole call beside the split route's and
              at each of its tiles; each f32 kernel beside its 3 x TF32
              and its FMA bound.
              ``checks_long``: at S=16384 the tensor-core forward (bf16
              and fp16) and C2/C3 against their plain versions (2 heads),
              then at 16 heads the forward again and split against merged
              (both timed), the split pair run twice for identical bits;
              kernel A and the f32 backward (the split pair, by the route)
              against their plain versions at 2 heads, timed at 16.
              ``checks_f32_fwd``: kernel A and the f32 A' at each of its
              tiles that fits a block, at (8, 1024, 16, 64), (1, 1024, 8,
              128), (1, 256, 4, 256), (1, 16384, 16 and 2, 64) and (1,
              128, 16, 64), each held against its plain version (at S =
              16384 and 16 heads A' against A), with
              its device ms beside SDPA's f32 one and its 3 x TF32 and FMA
              bounds (``check_f32_fwd_tiles``).
              ``checks_ce``: the cross-entropy kernels E1 (logsumexp), E2
              / E3 (fused softmax-CE forward / backward) at (8192, 50304)
              bf16 and at a small shape with out-of-range and ignored
              labels.  ``checks_softmax``: the row softmax F at (8192,
              1024), (16384, 1024), (8, 50304) and (8192, 50304) in bf16
              and at (8192, 1024) in f32 and fp16, three runs of each
              bit-identical (``check_softmax``).  ``checks_pipelined``:
              kernel A' (the TMA-fed tensor-core kernel in bf16 and fp16,
              3 x TF32 in f32) at each of its (block_q, block_k)
              instantiations against its plain version, lse included, at
              the serving prefill, the training shape, (1, 16384, 2, 64)
              and (1, 16384, 16, 64), one non-causal case, D 128 and 256,
              fp16 and f32 cases, beside the dtype's default forward's and
              SDPA's times; the
              tiles whose shared memory exceeds a block's are refused by
              the gate, never launched; then the 16-bit A' at
              (1, 16384, 16, 64), every tile, bf16 and fp16, three runs
              on one input that must be bit-identical
              (``check_pipelined_repeats``).
3. serve    — GPT-2 345M (seeded random weights, AMP O2 bf16) through the
              slotted DecodeEngine (``paged=False``, 8 slots, max_len
              1024) and the continuous-batching scheduler: 12 greedy
              requests of 128 prompt tokens (64 shared by all, 64 of
              each one's own) and 32 new tokens, once with the default
              flags and once with ``use_pallas_norm`` on; the tensor-core
              forward on every prefill.  Launch counters are reset just
              before each run and read after.
3a. serve_paged — the same traffic through the paged engine (the
              default pool: 128 pages of 64 rows, chunks of 64), each
              LayerNorm route: tokens/s, TTFT and TPOT p50, prefix hits
              (the second wave of 4 maps the shared page), copies on
              write, peak pages and decode steps; kernel B (2L + 1) times
              a forward (chunks and decode steps) under
              ``use_pallas_norm``, no flash kernel (paged attention is
              plain torch, as in the JAX package); then decode_profile
              of the paged decode step, each route.
3b. serve_paged_tight — the same with a pool of TIGHT_PAGES (17) pages:
              at least one request is preempted and recomputed, and
              every request ends by length.
3c. serve_spec — the paged engine with SPEC_K (4) drafts a verify step
              (prompt lookup over each request's own tokens), each
              LayerNorm route, on the serve traffic and on 12 prompts
              that each say a random 32-token span four times (the plain
              paged engine runs that traffic too): serve_paged's figures
              plus verify steps and drafts proposed and accepted; B
              (2L + 1) times a prefill chunk or verify step under
              ``use_pallas_norm``; greedy tokens against the plain paged
              engine's through serve_compare; the span traffic must accept
              a draft.  ``serve_spec_profile``: wall and device ms of one
              verify step beside a plain paged decode step, each route.
3d. serve_quant — the serve traffic under ``use_pallas_norm`` through
              the paged int8, paged fp8 (e4m3), slotted int8 (the
              tensor-core forward on every prefill: the slotted prefill
              attends the exact K/V) and paged int8 + 4-draft engines:
              pool bytes and bytes a token, TTFT and TPOT; a 1-byte row
              is (64 + 4) / (2 x 64) of the bf16 row; token ids in range.
3e. serve_scan — the serve traffic under ``use_pallas_norm`` through
              engines on the scan-layers 345M model (``GPTConfig(
              scan_layers=True)``, the serve model's weights stacked by
              ``per_layer_state_to_scan``, AMP O2 bf16): the paged engine
              in both loops, the slotted engine, the paged engine with
              SPEC_K drafts and the paged int8 engine; greedy tokens equal
              to the per-layer engines' on the same traffic, B's own
              count on the card equal to theirs in the default loop, and
              a captured paged decode step's wall and device ms beside
              the per-layer one's (``serve_scan_parity``).
3f. serve_http — GPT-2 345M under ``use_pallas_norm`` behind the HTTP
              front end (``serving.ServingFrontend`` on 127.0.0.1, the
              default overlapped loop on captured steps, a live tracer,
              metrics and liveness on), on a fresh paged engine (the
              default pool) and a fresh slotted one: the serve traffic
              POSTed at once and streamed, every ``done`` event's tokens
              against the in-process default-loop run of the same
              prompts on the same engine (serve_compare where they part),
              every status 200, ``serving.goodput_tokens`` up by 12 x
              32, B's count on the card its wrapper's plus 2L + 1 a
              replay, no engine-lane span after the first request with a
              capture, ``/healthz`` ok with the three beacons; then
              ``loadgen.run_load_sync`` (32 requests, seed 0, 4 a
              second, prompts of 64-512 and 16-64 new tokens: goodput,
              shed rate, client TTFT and TPOT p50 and p99, host gap a
              step and step wall beside the in-process run's); a burst
              of 8 over ``queue_limit=2`` (429s, each counted by
              ``serving.shed_total``, and only the admitted requests in
              the scheduler); a ``SocketReset`` at the 4th SSE event
              (one stream cut, its slot and pages back refcount-exact,
              the others' tokens unchanged); a preemption guard fired
              while requests stream (every request finishes, then 503,
              and ``wait_drained``).
4. decode_profile — host and device time of a batched decode step.
5. parity   — one 128-token prompt (the parity phases take 12 prompts
              with no tokens in common, not the serve traffic's): the
              card's last-position logits (kernel path, bf16) against
              the same weights on the CPU in f32 (plain path);
              ``parity_pinned``: the same prefill under
              ``FLAGS_autotune_pin=PIN_A_PRIME``, A' (64 x 64) on every
              layer.
6. decode_parity — 8 slots of ragged prompts, a few batched decode steps
              on the card and on the CPU, logits held at every step, for
              each LayerNorm route.
6a. paged_parity — the paged engine on the card against the port's
              CPU f32 paged engine: a prefix-hit admission whose chunk
              attends a page it did not compute, one copy-on-write of a
              live tail page, 4 decode steps; logits held at every
              point, for each LayerNorm route.
6b. quant_parity — paged_parity's script through the card's paged int8
              and fp8 engines, and decode_parity's through its slotted
              int8 engine, against the CPU f32 engine of the same layout
              and ``kv_dtype``, all fed the unquantized CPU engine's
              tokens: logits held within LOGIT_TOL at every point, each
              LayerNorm route; and the card's quantized logits at least
              QUANT_SHIFT_FLOOR of the CPU's quantization shift away from
              the card's unquantized ones (the control an engine that
              kept bf16 K/V fails).  serve_quant checks the pools on the
              card themselves: 1-byte codes, f32 scales, their bytes.
6c. spec_parity — the verify step's logits at each of its 5 positions
              against 5 sequential paged decode steps fed the same tokens,
              on the card, within LOGIT_TOL, each LayerNorm route; B once
              a LayerNorm of the verify step under ``use_pallas_norm``.
7. serve_compare — where two serve runs' greedy tokens part (the two
              LayerNorm routes; paged against slotted under each route;
              the tight pool against the roomy one), the CPU's logit gap
              between the two tokens, held small.
8. train    — bench.py's training step through ``jit.TrainStep``: GPT-2
              345M (the serve run's weights, dropout 0), AMP O2 bf16,
              AdamW, the label-shift criterion, one seeded (8, 1024)
              batch; 3 warm-up and 10 timed steps, the stream time of
              each part of a step and a profile of 2 steps.  The
              tensor-core forward, C2 and C3 launch 24 times a step;
              kernel A and C1 never.
9. train_norm — 3 steps with ``use_pallas_norm`` on from the same
              weights: kernels B and D launch 49 times a step; the first
              loss held against the default route's; a profile of 2
              steps.
10. train_ce — 3 steps with ``use_pallas_ce`` on (E2 and E3 once a
              step), then 3 with ``use_pallas_lse`` (E1 once a step), from
              the same weights and batch; first losses held against the
              default route's.
11. train_flat — 3 steps with ``TrainStep(flat_master=True)``; losses
              held against the default step's, the optimizer part timed.
11a. train_stack — 3 steps with ``TrainStep(stack_layers=True)``: 12
              stacked templates of 24 layers; every loss equal to the
              default step's bit for bit; the optimizer and write-back
              parts beside train's and train_flat's.
11b. train_scan — 3 steps of the scan-layers model holding the same
              weights, under each ``scan_mode``: every loss equal to
              train's bit for bit, the launches train's; the first
              mode's step parts and device profile.
11c. train_recompute — 3 steps with ``use_recompute=True``, per layer
              and scan-layers: the tensor-core forward 48 times a step
              (each block's forward again in the backward), C2 and C3 24;
              every loss equal to train's bit for bit; peak memory below train's
              and device ms a step beside it.
11d. dist_nccl — ``distributed.init_parallel_env()`` at a world of one
              on the card, meeting on a free port of 127.0.0.1: the
              backend is NCCL, the default device the rank's card, and
              every collective runs once on a CUDA tensor against its
              value (``collective_checks``); the count of issued ops.
              Then, on the mesh {"dp": world, "sep": 1} (a one-rank
              ``sep`` group on NCCL), ``scaled_dot_product_attention`` at
              (1, 2048, 16, 64) bf16 causal routes through
              ``ring_attention``: out and dq / dk / dv equal to
              ``flash_attention_bshd``'s value for value, and one permute
              (the ring's dK / dV, to itself).
11e. train_dp — 3 steps of the train step with
              ``in_shardings=PartitionSpec("dp", None)`` over that one-rank
              NCCL dp group: two all-reduces a step really issued (the
              f32 grads, the loss), every loss equal to train's bit for
              bit, device ms a step beside train's; then the same steps at
              ``zero_stage=2``, losses and launches train's bit for bit
              (at a world of one ZeRO cuts nothing, as in JAX).  Then the
              world is taken down.
11f. tp2_gloo — two processes on the one card in a gloo world over CUDA
              tensors (NCCL takes one rank a card), GPT-2 345M bf16 at 8
              heads a rank: ``DecodeEngine(tp=2)`` greedy on 8 prompts
              against the tp=1 engine (tokens equal, or parted only where
              tp=1's top-2 margin is below 2 * LOGIT_TOL; first-step
              logits within LOGIT_TOL; B 49 a forward), then 3 train steps
              at dp1 x mp2 within PARITY_LOSS_TOL of train's losses, the
              flash forward and split backward 24 a step.  Then
              ``DecodeEngine(tp=2, overlap_comm=True)`` (the mp_overlap
              islands: the row matmuls and LM head as permute rings), per
              layer and scan-layers, on the same requests: tokens equal
              to the monolithic tp=2 engine's, first-step logits against
              its, the ppermutes and ``mp.overlap_chunks`` a forward; and
              one dp1 x mp2 train step with the islands on against the
              monolithic step's loss.  Gloo stages each collective (each
              permute) through the host: no time of it is a
              tensor-parallel or an overlap speed.
11g. zero_gloo — two processes on the one card over gloo, mesh
              {"sdp": 2}: the train step (GPT-2 345M, AMP O2, AdamW) at
              ``zero_stage`` 1, 2 and 3, two steps each with the batch
              sharded over sdp: losses within PARITY_LOSS_TOL of train's,
              the AdamW slots a rank holds about half of train's, stage 2
              and 3 reduce-scattering, stage 3's masters half, and each
              rank's peak allocation.

11h. serve_http_tp2 — two processes on the one card over gloo, GPT-2 345M
              bf16, ``DecodeEngine(tp=2)`` paged under ``use_pallas_norm``:
              rank 0's ``ServingFrontend`` takes 8 greedy requests (64
              tokens, 32 new), a request whose client leaves mid-stream
              and a sampled one, then 8 more from ``serving.loadgen``;
              rank 1 runs ``serving.follow``.  The greedy tokens equal
              the tp=1 engine's over HTTP in rank 0's process (or part
              only where tp=1's top-2 margin is below 2 * LOGIT_TOL, as
              tp2_gloo holds); rank 1 finished every request rank 0 did
              with the same tokens (the sampled one too) and reasons;
              the cut request is cancelled on both; B (2L + 1) a forward
              on each rank; the follower's process exits 0 after
              ``stop()``.  Client TTFT / TPOT p50 and p99 are gloo's
              (every collective staged through the host), not a tp speed.
11i. pp_single — one rank, no pp axis: GPT-2 345M as a ``PipelineLayer``
              (a ``SharedLayerDesc`` embedding, the 24 port ``GPTBlock``s,
              the tied head with the final LayerNorm), AMP O2 bf16,
              AdamW, ``accumulate_steps`` 4 of 2 x 1024 tokens, 3 steps
              under ``use_pallas_norm`` through ``train_batch``: losses
              against a plain loop over the same layers with the same
              microbatching, the flash forward / C2 / C3 / B / D per step
              against their formula, device ms a step.
11j. pp2_gloo — two processes on the one card over gloo, pp=2 (12 blocks a
              stage), the same model, data and optimizer, 3 steps through
              ``fleet.init`` / ``fleet.distributed_model(...).train_batch``
              (the 1F1B schedule): losses within PARITY_LOSS_TOL of
              pp_single's, the tied embedding and a block of each stage
              after ``sync_to_layers()`` within PP_PARAM_TOL of
              pp_single's and equal on both ranks, 2 (m + 2 (n - 1))
              permutes a step, at most 2 (n - 1 - s) + 1 microbatches in
              flight on stage s, each rank's kernel launches and peak
              allocation; then an fp16 pipeline under a GradScaler at
              2^40 skips its overflowing step on both ranks.

11k. ring_gloo — two processes on the one card over gloo, mesh {"sep":
              2}: (1, 16384, 16, 64) bf16 causal q/k/v (GPT-2 345M's
              attention width), 8192 rows a rank, through
              ``scaled_dot_product_attention`` (the ring, the flash
              kernels as its inner) forward and backward, then through
              ``ulysses_attention``; every rank's out and dq / dk / dv
              within the flash rule of one ``flash_attention_bshd`` call
              over the whole sequence; the ring's launches a rank (rank r
              r + 1 flash forwards and C2 / C3 pairs: the causal ring
              skips future shards), Ulysses' one of each; the permutes and
              all-to-alls; device ms of a traced step and the flash
              kernels' share.  Gloo stages every transfer through the
              host: no time here is a sequence-parallel speed.
11l. moe_gloo — ``MoELayer(1024, [ExpertFFN(1024, 4096) x 8],
              gate="gshard", top_k=2, capacity_factor=1.25)`` in f32 on
              (8, 1024) tokens: all experts local on the card against the
              same weights on the CPU (out, aux_loss, gate and expert
              grads within 1e-4 relative; tokens at a routing near-tie
              left out and counted), then two processes over gloo on the
              mesh {"ep": 2}, 4 experts a rank, against the one-rank run
              within 1e-5; the all-to-alls and each rank's peak
              allocation.

11m. pp2_sdp2_gloo — four processes on the one card over gloo: pp2_gloo's
              model, data and optimizer (AMP O2 bf16, AdamW, 4
              microbatches, ``use_pallas_norm``) through the fleet, 2 steps
              on {"pp": 2, "dp": 2}, then on {"pp": 2, "sdp": 2} at ZeRO
              stages 1 and 2 (``sharding_configs.stage``): every rank's
              losses within PP_SDP_LOSS_REL (relative) of the dp run's,
              a rank's optimizer-slot bytes about half the dp run's
              (PP_SDP_SLOT_SHARE), stage 2 reduce-scattering its grads
              and stage 1 not, each stage's launches; peak a rank.

11n. launch_elastic — the port's launcher (``Launcher(nproc_per_node=1,
              elastic=True, max_restarts=2)``) runs
              ``tools/torch_launch_worker.py`` on the card: GPT-2 345M at
              full width and LAUNCH_LAYERS (4) blocks, ``train``'s
              configuration (B = 8, S = 1024, bf16 AMP O2, AdamW, dropout
              0) under ``use_pallas_norm``, weights from seed 0, ids
              through ``io.DataLoader(TensorDataset, num_workers=2)`` on
              the shm route, ``TrainEpochRange`` over a
              ``CheckpointManager`` (an epoch a step, async saves).  The
              uninterrupted job twice (at once), then a job whose worker
              dies (``HardExit``) at ``train.epoch`` of step 4 once its
              step-3 checkpoint is on disk: one respawn, a resume at step
              4 from that checkpoint and the data cursor, steps 4-7 equal
              to the uninterrupted job's bit for bit (or within the two
              uninterrupted jobs' largest difference); the checkpoint's
              bytes, save and restore seconds, death to first resumed
              step, host ms a batch through the loader and by hand, what
              an async save adds to a step (the saving loop's step and
              save-call ms; a probe after the second job's last step:
              LAUNCH_SAVE_PROBE steps without and with a write in
              flight); the flash forward, C2 and C3 4 a step, B and D 9.
11o. launch_dp2_gloo — ``Launcher(nproc_per_node=2, master=<free port>)``:
              two workers on the one card over gloo, each taking its rows
              through ``DistributedBatchSampler(num_replicas=2)`` and the
              shm DataLoader, 4 steps over dp = 2
              (``TrainStep(local_batch=True)``), a synchronous save of
              both ranks after the second (``host-0`` and ``host-1``
              written, rank 0 publishing), then a second launch resuming
              from it: losses within DP2_LOSS_TOL of this process's
              one-process run on the global batch, both ranks'
              parameters equal after the last step, the resumed steps
              equal to the first job's bit for bit, each worker's
              ``PADDLE_*`` environment as the launcher's contract says.
              11n and 11o run at once, before the autotune phase (whose
              cache the workers would read).

``python3 chip_smoke.py --distributed`` runs the train phase, 11d-11m,
train_long and sep_train_gloo alone (the distributed phases without the
kernel checks and serving phases), then prints the card and the device
line.
12. train_parity — one step at (1, 256) on the card (bf16, kernels, each
              LayerNorm route and each cross-entropy route; then f32,
              kernel A and C1) and on the CPU (f32, plain): the loss and
              every parameter's gradient held.
12a. train_f32 — 3 steps of the train step in f32 (no AMP, TF32 matmuls
              off): kernel A and the f32 C1 launch 24 times a step; host
              ms a step, the stream time of each part of one more step and
              a 2-step profile (device ms a step, and the f32 backward
              kernels' share of it).
13. train_fp16 — 3 eager steps of the same model under
              ``amp.decorate(level="O2", dtype="float16")`` and a
              ``GradScaler``, each LayerNorm route: the tensor-core
              forward, C2 and C3 (and B, D) on fp16, a finite first loss
              near the bf16 one, no step skipped.
14. autotune — ``autotune.warm()`` over the port's standard keys (the
              four flash families at the training shape; the slotted and
              paged decode attention at the serving shape, the paged one
              over the int8 pool and at the verify step's 5 positions too)
              and flash_fwd at head dim 256, into this run's own cache
              file: each key's timing table, winner and shared-memory
              refusals.
15. train_pipelined — 3 steps under PIN_A_PRIME: A' (64 x 64)
              launches 24 times a step, the tensor-core forward never;
              the first loss held against train's.
16. train_autotune — 3 steps with ``FLAGS_autotune=1`` reading the
              cache that the autotune phase wrote: the launches are the
              winners', nothing is timed again, the first loss held.
17. train_long — GPT-2 345M at (1, 16384), 3 steps (ms over steps 2-3)
              and the stream time of each part of one more step: the
              tensor-core forward, C2 and C3 launch 24 times a step; the
              first step's gradients of a named set (the tied embedding,
              the first and last block's qkv and fc2, ln_f) go to a file
              for 17a.
17a. sep_train_gloo — two processes on the one card over gloo, the mesh
              {"sep": 2}: train_long's model, weights and batch, every rank
              given the global (1, 16384) batch and running its 8192 rows,
              the ring over 'sep' inside every block's attention (the
              flash forward in its f32-out mode, C2 and C3 accumulating),
              2 steps: both losses within SEP_LOSS_TOL of train_long's,
              the first step's named gradients and their norm within
              SEP_GRAD_REL_TOL (relative L2) of train_long's, rank r's
              flash forward and C2 / C3 r + 1 times a layer and step.

``python3 chip_smoke.py --launch`` runs the build, native_runtime, 11n
and 11o alone, then prints the card and the device line.

Every phase but 14-16 runs with tuning off, no pin and an empty cache
of the run's own (a temporary file under ``paddle_tpu_torch/_build/``,
removed at the end), so each kernel is the hand-tuned candidate [0].
Launch counters are set to 0 just before each run of a path and read
just after.  The serve phases (3, 3a-3d) run their traffic through the
default loop (overlapped, every decode and verify step replayed from
its captured CUDA graph) and again through the eager synchronous one
(``*_loops`` lines side by side; identical greedy tokens required).  A
replay launches B without its wrapper, so B's launches in a run are the
kernel's own count on the card (``layer_norm_fwd_device_launches``),
which must exceed the wrapper's by 2L + 1 a replay under
``use_pallas_norm``; ``decode_profile`` counts B in a profiler trace of
the captured step as well.  ``overlap_parity``: both loops' greedy
tokens on the parity prompts, the eager step held to the CPU, the
captured step's logits against the eager step's; ``captured_steps``:
graph pool bytes beside the KV pools.  Then the seconds of each part,
the ``{"kernels": [...]}`` summary, the card's name and power limit, and, last, the device line.
Without a card (or without the repository beside this file) it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import faulthandler
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16, TF32 and
# f32 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# the f32 flash kernels' products are 3 x TF32: three tensor-core
# products for each one of the function
TF32X3_FLOPS = TF32_FLOPS / 3

# flash out and dq/dk/dv, by dtype: kernel and plain version both round
# an f32 result to the dtype, so an element may differ by one ulp of |ref|
# (bf16 2^-7, fp16 2^-10 relative); on top, 1/64 of the reference's RMS at
# that shape (about 8e-4 at S=1024 non-causal, where |out| ~ 0.05), far
# below what a misweighted V accumulation would leave, for sums in other
# orders (C1's dQ by atomics).  f32 results differ by summation order
# and, in the flash backward, whose products are 3 x TF32 (each operand
# split into two TF32 parts), by the small x small term it drops, about
# 2^-22 of each product: 1e-5 relative, and 1e-4 of the RMS
ULP_REL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}
RMS_FRAC = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -6, "float32": 1e-4}
FLASH_ULP_REL, FLASH_RMS_FRAC = ULP_REL["bfloat16"], RMS_FRAC["bfloat16"]
LSE_TOL = 1e-3          # f32 lse
# the plain versions' times are yardsticks of slow tile walks (thousands
# of small launches a call, each traced call parsed by the profiler), so
# they take fewer calls than the kernels': the median of 3 windows of 3
# calls, and 3 calls traced
PLAIN_REPS, PLAIN_INNER = 3, 3
LN_TOL = 1e-2           # bf16 out: abs, plus one bf16 half-ulp of |ref|
LOGIT_TOL = 0.1         # card bf16 vs CPU f32 last-position logits
# LayerNorm backward: bf16 dx as the flash grads; f32 dgamma / dbeta are
# sums over all rows in another order (1e-5 relative plus 1e-4 of RMS)
LN_BWD_F32_REL = 1e-5
LN_BWD_F32_RMS_FRAC = 1e-4
# train: the first loss of seeded 0.02-std weights is near ln(vocab)
FIRST_LOSS_TOL = 0.5
# train_norm vs train first loss, same weights: both bf16 forwards, the
# kernel's one-pass variance vs the default two-pass one
NORM_ROUTE_LOSS_TOL = 0.01
# train_parity: card (bf16, kernels) vs CPU (f32, plain) at (1, 256).
# Measured on an H100: loss within 2.4e-4, every parameter's gradient
# within 0.019 relative L2 (median 0.014), both LayerNorm routes; the
# limits leave 1.5x room over that bf16 rounding
PARITY_LOSS_TOL = 0.02
PARITY_GRAD_REL_TOL = 0.03
# train_parity's f32 card step (kernel A, C1) against the CPU's f32 one:
# the same f32 arithmetic in other summation orders (C1's dQ by atomics),
# ~1e-6 relative an operation over 24 layers; 1e-4 of the ~11 loss
PARITY_F32_LOSS_TOL = 1e-3
PARITY_F32_GRAD_REL_TOL = 1e-3
# lse and nll (f32, values ~11): the kernels and the plain versions sum
# 50304 terms in other orders
CE_STAT_TOL = 1e-4
# bf16 dlogits and softmax: both sides round an f32 result to bf16 (one
# ulp of |ref|), plus 1/64 of the reference's RMS, as the flash checks
CE_ULP_REL = 2.0 ** -7
CE_RMS_FRAC = 2.0 ** -6
# train_ce vs train first loss, same weights and bf16 logits: the CE
# kernels' f32 arithmetic against the plain route's
CE_ROUTE_LOSS_TOL = 0.01
# train_flat vs train losses: the same update over one flat buffer; C1's
# atomics make any two runs differ in the last bits
FLAT_LOSS_TOL = 0.01


# A' pinned at 64 x 64, the tile of its earlier measurements (a bare
# "flash_fwd=pipelined" takes the tiles of candidate [0], the tensor-core
# forward's 128 x 128)
PIN_A_PRIME = "flash_fwd=pipelined:block_q=64,block_k=64"


def emit(obj):
    print(json.dumps(obj), flush=True)


_CARD = []


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them
    (asked once; "not measured" where there is no nvidia-smi)."""
    if not _CARD:
        try:
            _CARD.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0])
        except (OSError, subprocess.SubprocessError):
            _CARD.append("not measured")
    return _CARD[0]


def within(got, ref, ulp, frac):
    """(max abs error, ref RMS, passes): every element within ``ulp`` x
    |ref| plus ``frac`` x the reference's RMS."""
    ref = ref.float()
    d = (got.float() - ref).abs()
    rms = float(ref.pow(2).mean().sqrt())
    return float(d.max()), rms, bool((d <= ulp * ref.abs() + frac * rms)
                                     .all())


def rule_excess(got, ref, ulp, frac):
    """(worst ratio of an element's error to its :func:`within` allowance,
    elements over it): how far outside the rule a result lies."""
    ref = ref.float()
    d = (got.float() - ref).abs()
    allow = ulp * ref.abs() + frac * float(ref.pow(2).mean().sqrt())
    ratio = d / allow.clamp_min(1e-30)
    return float(ratio.max()), int((ratio > 1).sum())


def bound(nbytes, flops, peak_flops):
    """(bound ms, what bounds it) from the bytes a function must move and
    the operations it must do."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Counters:
    """The kernel wrappers' launch counts, by kernel name."""

    def __init__(self, fac, norm_cuda, ce_cuda):
        self.spec = {
            "flash_fwd_tc": (fac, "flash_fwd_tc_launches"),
            "flash_fwd": (fac, "flash_fwd_launches"),
            "flash_fwd_pipelined": (fac, "flash_fwd_pipelined_launches"),
            "flash_bwd": (fac, "flash_bwd_launches"),
            "flash_bwd_dq": (fac, "flash_bwd_dq_launches"),
            "flash_bwd_dkv": (fac, "flash_bwd_dkv_launches"),
            "layer_norm_fwd": (norm_cuda, "layer_norm_fwd_launches"),
            "layer_norm_bwd": (norm_cuda, "layer_norm_bwd_launches"),
            "ce_lse": (ce_cuda, "ce_lse_launches"),
            "ce_fwd": (ce_cuda, "ce_fwd_launches"),
            "ce_bwd": (ce_cuda, "ce_bwd_launches"),
            "softmax_fwd": (norm_cuda, "softmax_fwd_launches")}

    def reset(self):
        for mod, attr in self.spec.values():
            setattr(mod, attr, 0)
        self.spec["layer_norm_fwd"][0].layer_norm_fwd_device_launches(
            reset=True)

    def b_on_device(self):
        """Kernel B's launches since the last reset as the kernel counted
        them on the card: a launch replayed from a CUDA graph never
        reaches the wrapper's count, but it reaches this one."""
        return self.spec["layer_norm_fwd"][0].layer_norm_fwd_device_launches()

    def read(self):
        return {k: getattr(mod, attr) for k, (mod, attr) in
                self.spec.items()}


def device_times(fn, torch, n=20, pattern=None):
    """{kernel name: (device ms summed over the trace, launches)} over
    ``n`` calls in a ``torch.profiler`` trace.  A trace that holds no
    kernel (none whose name holds ``pattern``, when given) is taken again,
    up to three times in all: the profiler now and then returns one
    without the device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            if t > 0:
                ms, count = out.get(e.key, (0.0, 0))
                out[e.key] = (ms + t / 1e3, count + int(e.count))
        if any(pattern is None or pattern in key for key in out):
            break
    return out


def kernel_ms(times, pattern):
    """Mean device ms per launch of the kernels whose name holds
    ``pattern`` (each launched once per call): a launch missing from the
    trace does not halve it.  None when no kernel's name holds it."""
    hit = [v for name, v in times.items() if pattern in name]
    if not hit:
        return None
    return sum(t for t, _ in hit) / sum(c for _, c in hit)


def call_ms(times, n):
    """Device ms per call of all the kernels of ``n`` traced calls."""
    return sum(t for t, _ in times.values()) / n or None


def time_ms(fn, torch, reps=7, inner=20):
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, torch, n=20):
    """Mean device time per call: the sum of the card's kernel durations
    over ``n`` calls in a ``torch.profiler`` trace, so host launch overhead
    is left out.  None when the trace holds no device time."""
    return call_ms(device_times(fn, torch, n), n)


def bf16_err(got, ref, atol):
    """(max abs error, passes) with an abs tolerance plus one bf16
    half-ulp of the reference magnitude (2^-8 relative)."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + ref.float().abs() * 2.0 ** -8).all())
    return float(d.max()), ok


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def ptxas_usage(log, pattern):
    """[{kernel, registers, spill_stores, spill_loads}] of every kernel
    whose name holds ``pattern``, from the ``-Xptxas -v`` lines of a
    build log (names demangled where ``c++filt`` is found)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)} if pattern in m.group(1) else None
            if cur:
                rows.append(cur)
            continue
        m = cur and re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = cur and re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    filt = shutil.which("c++filt")
    if rows and filt:
        names = subprocess.run(
            [filt], input="\n".join(r["kernel"] for r in rows),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        for r, name in zip(rows, names):
            m = re.search(r"(\w+<[^()]*>)\(", name)
            r["kernel"] = m.group(1) if m else name
    return rows


def fused_qkv(torch, b, s, h, d, dtype, gen):
    """q/k/v as slices of one fused projection, as the model has them."""
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device="cuda").to(dtype)
    return [qkv[:, :, i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
            for i in range(3)]


def fwd_bound(b, s, h, d, causal, dtype, peak=None):
    """Bound of a flash forward: q, k, v read and out written once, and
    the two products over the visible (query, key) pairs at ``peak``, by
    default the rate the dtype's kernels run on: the tensor cores' bf16
    rate for bf16 and fp16, three TF32 products a product for f32."""
    esz = 4 if dtype_name(dtype) == "float32" else 2
    pairs = s * (s + 1) / 2 if causal else s * s
    if peak is None:
        peak = TF32X3_FLOPS if esz == 4 else BF16_FLOPS
    return bound(4 * b * s * h * d * esz, 4 * b * h * d * pairs, peak)


def fwd_bounds(row, b, s, h, d, causal, dtype):
    """A forward row's bound (``bound_ms``, ``bound_by``) at the rate its
    kernel runs on; f32 rows also get the bound on the f32 FMAs
    (``bound_fma_ms``, 67 TFLOP/s) and, when the kernel was timed, the
    share of the 3 x TF32 bound that its device time reaches."""
    row["bound_ms"], row["bound_by"] = fwd_bound(b, s, h, d, causal, dtype)
    if dtype_name(dtype) == "float32":
        row["bound_fma_ms"], _ = fwd_bound(b, s, h, d, causal, dtype,
                                           F32_FLOPS)
        row["bound_basis"] = "3xTF32"
        if row.get("kernel_device_ms"):
            row["bound_share"] = row["bound_ms"] / row["kernel_device_ms"]


# the tensor-core forward's rows: the serving prefill, the training shape,
# one non-causal case, head dims 128 and 256 (S=16384: check_flash_long)
TC_FWD_CASES = [(1, 128, 16, 64, True), (1, 128, 16, 64, False),
                (1, 1024, 16, 64, False), (8, 1024, 16, 64, True),
                (1, 1024, 8, 128, True), (1, 1024, 4, 256, True)]
# kernel A, f32: the serving prefill and the training shape
A_FWD_CASES = [(1, 128, 16, 64, True), (8, 1024, 16, 64, True)]


def tc_tiles_device_ms(torch, fac, q, k, v, causal, scale, n):
    """Device ms of the tensor-core forward at each of its tiles that
    divides S: what the autotuner chooses among."""
    out = {}
    for bq, bk in fac._TC_FWD_BLOCKS[q.shape[-1]]:
        if q.shape[1] % bq == 0:
            out["%dx%d" % (bq, bk)] = kernel_ms(device_times(
                lambda: fac._launch_tc(q, k, v, causal, scale, False, bq, bk),
                torch, n=n, pattern="flash_fwd_tc_kernel"),
                "flash_fwd_tc_kernel")
    return out


def check_fwd_case(torch, fac, tF, b, s, h, d, causal, dtype, gen,
                   reps=7, inner=20, plain=True):
    """One forward row: the default route (the tensor-core forward for
    bf16 and fp16, kernel A for f32) launched once through
    ``flash_attention_bshd_with_lse`` and held against its plain version
    at the tiles it resolved, lse included; then the kernel's event and
    device ms (in bf16 at every tile too), the plain version's (when
    ``plain``), SDPA's, and the bound."""
    q, k, v = fused_qkv(torch, b, s, h, d, dtype, gen)
    scale = 1.0 / math.sqrt(d)
    tc = dtype in fac._TC_DTYPES
    spec = fac._resolve_fwd(q, k, v, causal)
    counter = "flash_fwd_tc_launches" if tc else "flash_fwd_launches"
    before = getattr(fac, counter)
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal)
    launched = getattr(fac, counter) - before
    if tc:
        ref, ref_lse = fac._flash_tc_reference(q, k, v, causal, scale,
                                               spec[1], spec[2])
    else:
        ref, ref_lse = fac._flash_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    err, rms, ok = within(out, ref, ULP_REL[name], RMS_FRAC[name])
    lse_err = float((lse - ref_lse).abs().max())
    del out, lse, ref, ref_lse
    if launched != 1 or not ok or lse_err > LSE_TOL:
        raise AssertionError("flash forward %s %s causal=%s tiles %s: "
                             "launches %d, out err %g (ref rms %g), lse err "
                             "%g" % (name, (b, s, h, d), causal, spec[1:],
                                     launched, err, rms, lse_err))
    row = {"shape": [b, s, h, d], "causal": causal, "dtype": name,
           "kernel": "flash_fwd_tc" if tc else "flash_fwd",
           "blocks": list(spec[1:]), "max_abs_err": err, "ref_rms": rms,
           "tol_abs_part": RMS_FRAC[name] * rms, "lse_max_abs_err": lse_err}
    time_kernel(torch, row, "kernel",
                lambda: fac.flash_attention_bshd(q, k, v, causal),
                "flash_fwd_tc_kernel" if tc else "flash_fwd_kernel", reps,
                inner)
    if dtype == torch.bfloat16:
        row["tiles_device_ms"] = tc_tiles_device_ms(torch, fac, q, k, v,
                                                    causal, scale, inner)
    if plain:
        time_kernel(torch, row, "plain",
                    (lambda: fac._flash_tc_reference(q, k, v, causal, scale,
                                                     spec[1], spec[2]))
                    if tc else
                    (lambda: fac._flash_reference(q, k, v, causal, scale)),
                    None, PLAIN_REPS, PLAIN_INNER)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    time_kernel(torch, row, "library",
                lambda: tF.scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=causal),
                None, reps, inner)
    fwd_bounds(row, b, s, h, d, causal, dtype)
    return row


def check_flash(torch, fac):
    """The tensor-core forward in bf16 and fp16 at TC_FWD_CASES, and
    kernel A in f32 at A_FWD_CASES, each against its plain version."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float16):
        for b, s, h, d, causal in TC_FWD_CASES:
            rows.append(check_fwd_case(torch, fac, tF, b, s, h, d, causal,
                                       dtype, gen,
                                       plain=dtype == torch.bfloat16))
    for b, s, h, d, causal in A_FWD_CASES:
        rows.append(check_fwd_case(torch, fac, tF, b, s, h, d, causal,
                                   torch.float32, gen))
    torch.cuda.empty_cache()
    return rows


def fwd_row(rows, kernel, shape, dtype="bfloat16", causal=True):
    return [r for r in rows if r["kernel"] == kernel and r["shape"] == shape
            and r["dtype"] == dtype and r["causal"] == causal][0]


def check_layer_norm(torch, norm_cuda, dtype=None,
                     sizes=(8, 128, 8192, 16384)):
    """Kernel B against its plain version, bf16 x (or ``dtype``) and f32
    gamma / beta, at the decode, prefill, training (8 x 1024) and
    train_long (16384) rows."""
    import torch.nn.functional as tF
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    for r in sizes:
        f = 1024
        x = torch.randn((r, f), generator=gen, device="cuda").to(dtype)
        g = 1 + 0.1 * torch.randn((f,), generator=gen, device="cuda")
        bta = 0.1 * torch.randn((f,), generator=gen, device="cuda")
        out, mean, rstd = norm_cuda.layer_norm_fwd(x, g, bta)
        r_out, r_mean, r_rstd = norm_cuda._layer_norm_reference(x, g, bta,
                                                                1e-5)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            err, ok = bf16_err(out, r_out, LN_TOL)
        else:
            err, _rms, ok = within(out, r_out, ULP_REL[dtype_name(dtype)],
                                   RMS_FRAC[dtype_name(dtype)])
        stat_err = max(float((mean - r_mean).abs().max()),
                       float(((rstd - r_rstd) / r_rstd).abs().max()))
        if not ok or stat_err > 1e-4:
            raise AssertionError("layer_norm_fwd (%d, %d) %s: out err %g, "
                                 "stat err %g" % (r, f, dtype, err, stat_err))
        worst = max(worst, err)
        nbytes = 2 * r * f * 2 + 2 * f * 4 + 2 * r * 4
        flops = 8 * r * f
        # F.layer_norm takes no f32 gamma/beta with 16-bit x: the
        # yardstick gets copies in x's dtype, made outside the timed calls
        g16, b16 = g.to(dtype), bta.to(dtype)
        rows.append({
            "shape": [r, f], "dtype": dtype_name(dtype), "max_abs_err": err,
            "stat_err": stat_err,
            "kernel_ms": time_ms(
                lambda: norm_cuda.layer_norm_fwd(x, g, bta), torch),
            "kernel_device_ms": device_ms(
                lambda: norm_cuda.layer_norm_fwd(x, g, bta), torch),
            "plain_device_ms": device_ms(
                lambda: norm_cuda._layer_norm_reference(x, g, bta, 1e-5),
                torch),
            "library_device_ms": device_ms(
                lambda: tF.layer_norm(x, (f,), g16, b16, 1e-5), torch),
            "plain_ms": time_ms(
                lambda: norm_cuda._layer_norm_reference(x, g, bta, 1e-5),
                torch),
            "library_ms": time_ms(
                lambda: tF.layer_norm(x, (f,), g16, b16, 1e-5), torch),
            "bound_ms": max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BPS >= flops / F32_FLOPS
                         else "operations")})
    return rows, worst


def flash_case(torch, fac, b, s, h, d, causal, gen, dtype=None):
    """bf16 (or ``dtype``) q/k/v (slices of one fused projection), a
    cotangent, and the default forward's (out, lse) on them."""
    dtype = dtype or torch.bfloat16
    q, k, v = fused_qkv(torch, b, s, h, d, dtype, gen)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    out, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal)
    return q, k, v, do, out, lse


def bwd_bound(b, s, h, d, causal, products, n_tensors, f32=False,
              peak=None):
    """Bound of a backward kernel: ``products`` (S x S x D) products and
    ``n_tensors`` bf16 (f32 when ``f32``) (B, S, H, D) tensors read or
    written (q, k, v, dO in; dq and/or dk, dv out), plus the f32 lse and
    delta rows; products at ``peak``, by default the tensor cores' bf16
    rate, or the FMAs' f32 one when ``f32``."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = products * 2 * b * h * d * pairs
    nbytes = n_tensors * b * s * h * d * (4 if f32 else 2) + 2 * b * s * h * 4
    if peak is None:
        peak = F32_FLOPS if f32 else BF16_FLOPS
    return bound(nbytes, flops, peak)


BWD_WORK = (("flash_bwd", 5, 7), ("flash_bwd_dq", 3, 5),
            ("flash_bwd_dkv", 4, 6))


def bwd_bounds(row, b, s, h, d, causal, f32):
    """Each backward kernel's bound into ``row``.  f32 rows get two: the
    3 x TF32 bound that the kernels' design is held to (``*_bound_ms``,
    three tensor-core products at 495 TFLOP/s for each product), with the
    share of it that the kernel's device time reaches when timed, and the
    bound on the f32 FMAs (``*_bound_fma_ms``, 67 TFLOP/s)."""
    for kern, products, tensors in BWD_WORK:
        if not f32:
            row[kern + "_bound_ms"], row[kern + "_bound_by"] = bwd_bound(
                b, s, h, d, causal, products, tensors)
            continue
        row[kern + "_bound_ms"], row[kern + "_bound_by"] = bwd_bound(
            b, s, h, d, causal, products, tensors, True, TF32X3_FLOPS)
        row[kern + "_bound_fma_ms"], _ = bwd_bound(
            b, s, h, d, causal, products, tensors, True)
        row[kern + "_bound_basis"] = "3xTF32"
        if row.get(kern + "_device_ms"):
            row[kern + "_bound_share"] = (row[kern + "_bound_ms"]
                                          / row[kern + "_device_ms"])


def time_bwd(torch, fac, tF, q, k, v, do, out, lse, causal, reps, inner,
             plain=True):
    """Times of C1 (through the wrapper), C2 and C3 (each launched alone),
    the split route through the wrapper, the plain backward and the
    library's (SDPA's backward through autograd), CUDA-event and device.
    The device times are those of the kernel each run should launch: C1,
    C2 and C3 on the tensor cores in bf16 and fp16, else the FMA kernels,
    whose C3 shares C1's template (each run launches one of them); beside
    them the device ms of C1's launch as a whole (``c1_call``: the
    workspace's zeroing, the kernel and the cast), of the whole merged and
    split routes (``_call``, delta included), and in 16-bit C1's kernel at
    each of its tiles."""
    scale = q.shape[-1] ** -0.5
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    runs = {
        "flash_bwd": lambda: fac.flash_attention_bwd(
            q, k, v, out, lse, do, causal, scale, route="merged"),
        "flash_bwd_dq": lambda: fac._launch_bwd_dq(*args),
        "flash_bwd_dkv": lambda: fac._launch_bwd_dkv(*args),
        "split": lambda: fac.flash_attention_bwd(
            q, k, v, out, lse, do, causal, scale, route="split"),
        "c1_call": lambda: fac._launch_bwd_merged(*args)}
    tc = q.dtype in fac._TC_DTYPES
    patterns = {"flash_bwd": ("flash_bwd_merged_tc_kernel" if tc
                              else "flash_bwd_kv_kernel"),
                "flash_bwd_dq": ("flash_bwd_dq_tc_kernel" if tc
                                 else "flash_bwd_dq_kernel"),
                "flash_bwd_dkv": ("flash_bwd_dkv_tc_kernel" if tc
                                  else "flash_bwd_kv_kernel")}
    if plain:
        runs["plain"] = lambda: fac._flash_bwd_reference(
            q, k, v, out, lse, do, causal, scale)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = tF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    runs["library"] = lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True)
    res = {}
    for name, fn in runs.items():
        res[name + "_ms"] = time_ms(fn, torch, reps=reps, inner=inner)
        times = device_times(fn, torch, n=inner, pattern=patterns.get(name))
        res[name + "_device_ms"] = (kernel_ms(times, patterns[name])
                                    if name in patterns
                                    else call_ms(times, inner))
        if name in ("flash_bwd", "split"):
            res[name + "_call_device_ms"] = call_ms(times, inner)
    if tc:
        res["flash_bwd_tiles_device_ms"] = {
            str(bm): kernel_ms(device_times(
                lambda: fac._launch_bwd_merged(*args, block=bm), torch,
                n=inner, pattern=patterns["flash_bwd"]), patterns["flash_bwd"])
            for bm in fac._TC_BLOCKS[q.shape[-1]] if q.shape[1] % bm == 0}
    return res


def check_flash_bwd(torch, fac):
    """C1, C2 and C3 against the plain backward, bf16, B=1 H=16 D=64 at
    S = 128, 1024, 2048, causal or not, each route pinned; then the
    training shape (8, 1024, 16, 64) causal, head dim 128 at (1, 1024, 8,
    128) causal and head dim 256 at (1, 1024, 4, 256) causal, all timed;
    then f32 (C1, C2 and C3 as 3 x TF32 products, each route) and fp16
    (C1, C2 and C3 on the tensor cores, each route) cases, untimed but
    for f32 at the training shape, at (1, 1024, 8, 128) and at (1, 256,
    4, 256) (against SDPA's f32 backward, each f32 kernel beside its 3 x
    TF32 and its FMA bound) and fp16 at the training shape and at head
    dim 256 (without the plain version's time); then one with-lse
    case."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    worst = {"flash_bwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [(1, s, 16, 64, c, bf16) for s in (128, 1024, 2048)
             for c in (True, False)] + [(8, 1024, 16, 64, True, bf16),
                                        (1, 1024, 8, 128, True, bf16),
                                        (1, 1024, 4, 256, True, bf16),
                                        (1, 1024, 16, 64, True, f32),
                                        (8, 1024, 16, 64, True, f32),
                                        (1, 1024, 8, 128, True, f32),
                                        (1, 256, 4, 256, False, f32),
                                        (8, 1024, 16, 64, True, f16),
                                        (1, 1024, 8, 128, False, f16),
                                        (1, 1024, 4, 256, True, f16)]
    for b, s, h, d, causal, dtype in cases:
        q, k, v, do, out, lse = flash_case(torch, fac, b, s, h, d, causal,
                                           gen, dtype)
        scale = d ** -0.5
        name16 = dtype_name(dtype)
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, causal, scale)
        row = {"shape": [b, s, h, d], "causal": causal, "dtype": name16}
        routes = (("merged", ("flash_bwd",) * 3),
                  ("split", ("flash_bwd_dq", "flash_bwd_dkv",
                             "flash_bwd_dkv")))
        for route, kernels in routes:
            got = fac.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                          scale, route=route)
            torch.cuda.synchronize()
            for name, g, r, kern in zip(("dq", "dk", "dv"), got, ref,
                                        kernels):
                err, rms, ok = within(g, r, ULP_REL[name16],
                                      RMS_FRAC[name16])
                row["%s_%s_err" % (route, name)] = err
                row["%s_rms" % name] = rms
                if not ok:
                    raise AssertionError(
                        "%s %s %s %s causal=%s: err %g (ref rms %g)"
                        % (kern, name, name16, (b, s, h, d), causal, err,
                           rms))
                worst[kern] = max(worst[kern], err)
        if dtype == f32 and (b, s, h) == (1, 1024, 16) \
                or dtype == f16 and not causal:
            rows.append(row)
            continue
        row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, causal,
                            reps=5, inner=10, plain=dtype != f16))
        bwd_bounds(row, b, s, h, d, causal, dtype == f32)
        rows.append(row)
    # with lse: a nonzero lse cotangent folds in as delta - dlse
    q, k, v, do, out, lse = flash_case(torch, fac, 1, 256, 16, 64, True,
                                       gen)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, 0.125,
                                   dlse=dlse)
    lse_row = {"shape": [1, 256, 16, 64], "causal": True, "with_lse": True}
    for route in ("merged", "split"):
        got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125,
                                      dlse=dlse, route=route)
        errs = [within(g, r, FLASH_ULP_REL, FLASH_RMS_FRAC)
                for g, r in zip(got, ref)]
        lse_row[route + "_err"] = max(e[0] for e in errs)
        if not all(e[2] for e in errs):
            raise AssertionError("flash backward with lse (%s): err %g"
                                 % (route, lse_row[route + "_err"]))
    rows.append(lse_row)
    return rows, worst


F32_TILE_CASES = ((8, 1024, 16, 64, True), (1, 1024, 8, 128, True),
                  (1, 256, 4, 256, False), (1, 16384, 16, 64, True))


def check_f32_bwd_tiles(torch, fac, cases=F32_TILE_CASES):
    """Device ms of the f32 C1 (its whole call), C2 and C3 at each of
    their tiles (``_bwd_blocks``, the family's default first) at each
    case (b, s, h, d, causal), or at the one case given: what each
    family's default rests on."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32 = torch.float32
    rows = []
    if isinstance(cases[0], int):
        cases = (cases,)
    for b, s, h, d, causal in cases:
        causal = bool(causal)
        q, k, v, do, out, lse = flash_case(torch, fac, b, s, h, d, causal,
                                           gen, f32)
        delta = (do * out).sum(-1)
        args = (q, k, v, do, lse, delta, causal, d ** -0.5)
        n = 2 if s > 4096 else 10
        row = {"shape": [b, s, h, d], "causal": causal}
        for family, launch, pattern in (
                ("flash_bwd", fac._launch_bwd_merged, None),
                ("flash_bwd_dq", fac._launch_bwd_dq, "flash_bwd_dq_kernel"),
                ("flash_bwd_dkv", fac._launch_bwd_dkv,
                 "flash_bwd_kv_kernel")):
            row[family] = {}
            for bm in fac._bwd_blocks(d, f32, family):
                times = device_times(
                    lambda: launch(*args, block=bm), torch, n=n,
                    pattern=pattern)
                row[family][str(bm)] = (call_ms(times, n) if pattern is None
                                        else kernel_ms(times, pattern))
        rows.append(row)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def hold_tc_long(torch, fac, tF, q, k, v, scale, row, plain):
    """At S = 16384, causal: the tensor-core forward in bf16 (q, k, v) and
    fp16 (their fp16 copies) against its plain version at the tiles it
    resolves, lse included, then its event and device ms in both dtypes,
    SDPA's in bf16 and (when ``plain``) the plain version's in bf16."""
    for dtype in (torch.bfloat16, torch.float16):
        name16 = dtype_name(dtype)
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        spec = fac._resolve_fwd(qq, kk, vv, True)
        out, lse = fac.flash_attention_bshd_with_lse(qq, kk, vv, True)
        ref, ref_lse = fac._flash_tc_reference(qq, kk, vv, True, scale,
                                               spec[1], spec[2])
        torch.cuda.synchronize()
        err, rms, ok = within(out, ref, ULP_REL[name16], RMS_FRAC[name16])
        lse_err = float((lse - ref_lse).abs().max())
        del out, lse, ref, ref_lse
        if not ok or lse_err > LSE_TOL:
            raise AssertionError("flash_fwd_tc %s at %s: out err %g (rms "
                                 "%g), lse err %g" % (name16, row["shape"],
                                                      err, rms, lse_err))
        tag = "" if dtype == torch.bfloat16 else "_f16"
        row.update({"flash_fwd_tc%s_err" % tag: err,
                    "flash_fwd_tc%s_lse_err" % tag: lse_err,
                    "flash_fwd_tc%s_blocks" % tag: list(spec[1:])})
        time_kernel(torch, row, "fwd_flash_fwd_tc" + tag,
                    lambda: fac.flash_attention_bshd(qq, kk, vv, True),
                    "flash_fwd_tc_kernel", reps=3, inner=2)
        if dtype == torch.bfloat16:
            row["fwd_tiles_device_ms"] = tc_tiles_device_ms(
                torch, fac, qq, kk, vv, True, scale, 2)
        if dtype == torch.bfloat16 and plain:
            time_kernel(torch, row, "fwd_plain",
                        lambda: fac._flash_tc_reference(
                            qq, kk, vv, True, scale, spec[1], spec[2]),
                        None, reps=3, inner=2)
        del qq, kk, vv
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    time_kernel(torch, row, "fwd_library",
                lambda: tF.scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True),
                None, reps=3, inner=2)
    b, s, h, d = q.shape
    row["fwd_bound_ms"], row["fwd_bound_by"] = fwd_bound(
        b, s, h, d, True, torch.bfloat16)


def check_flash_long(torch, fac):
    """S = 16384 (the TPU's streamed-forward regime): at H=2, where each
    (S, S) f32 array of the plain backward is 2.1 GB, the tensor-core
    forward (bf16 and fp16) and C2/C3 against their plain versions; then,
    at the train_long shape (1, 16384, 16, 64), the forward again, split
    (C2 + C3) against merged (C1) on the card, a second split run held
    bit-identical to the first, and the times of the forward, C1, C2, C3
    and the library calls."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(3)
    s, d, scale = 16384, 64, 0.125
    out_row = {"shape": [1, s, 2, d], "causal": True}
    q, k, v, do, out, lse = flash_case(torch, fac, 1, s, 2, d, True, gen)
    hold_tc_long(torch, fac, tF, q, k, v, scale, out_row, plain=True)
    ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, scale)
    got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                  route="split")
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        e, rms, ok = within(g, r, FLASH_ULP_REL, FLASH_RMS_FRAC)
        out_row["split_%s_err" % name] = e
        if not ok:
            raise AssertionError("split backward at S=16384 (%s): err %g "
                                 "(rms %g)" % (name, e, rms))
    del ref, got
    out_row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, True,
                            reps=3, inner=2))
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()

    h = 16
    long_row = {"shape": [1, s, h, d], "causal": True}
    q, k, v, do, out, lse = flash_case(torch, fac, 1, s, h, d, True, gen)
    hold_tc_long(torch, fac, tF, q, k, v, scale, long_row, plain=False)
    merged = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                     route="merged")
    split = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                    route="split")
    for name, a, r in zip(("dq", "dk", "dv"), split, merged):
        e, rms, ok = within(a, r, FLASH_ULP_REL, FLASH_RMS_FRAC)
        long_row["split_vs_merged_%s_err" % name] = e
        if not ok:
            raise AssertionError("split vs merged at (1, 16384, 16, 64) "
                                 "(%s): err %g (rms %g)" % (name, e, rms))
    del merged
    again = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale,
                                    route="split")
    long_row["split_bit_identical"] = all(
        bool(torch.equal(a, b)) for a, b in zip(split, again))
    if not long_row["split_bit_identical"]:
        raise AssertionError("split backward at (1, 16384, 16, 64): two "
                             "runs differ")
    del split, again
    long_row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, True,
                             reps=3, inner=2, plain=False))
    bwd_bounds(long_row, 1, s, h, d, True, False)
    # the split pair's bound counts the five products the backward needs;
    # C2 and C3 recompute QK^T and dP, so the pair does seven
    long_row["split_pair_bound_ms"], _ = bwd_bound(1, s, h, d, True, 5, 7)
    long_row["merged_over_split"] = (long_row["flash_bwd_call_device_ms"]
                                     / long_row["split_call_device_ms"])
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return out_row, long_row


def check_f32_bwd_long(torch, fac, tF, gen, h):
    """The f32 backward at (1, 16384, h, 64) causal, the route the JAX
    rule takes there (the split pair C2 + C3): its launches, and at 2
    heads its result against the plain version's; then the times of C1,
    C2, C3, the route's call and SDPA's f32 backward (and at 2 heads the
    plain version's), each beside its 3 x TF32 and FMA bounds."""
    s, d, scale = 16384, 64, 0.125
    q, k, v, do, out, lse = flash_case(torch, fac, 1, s, h, d, True, gen,
                                       torch.float32)
    row = {"shape": [1, s, h, d], "causal": True, "dtype": "float32",
           "route": fac._card_bwd_route(s, h, d, torch.float32)}
    counts = (fac.flash_bwd_launches, fac.flash_bwd_dq_launches,
              fac.flash_bwd_dkv_launches)
    got = fac.flash_attention_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    row["launches"] = [fac.flash_bwd_launches - counts[0],
                       fac.flash_bwd_dq_launches - counts[1],
                       fac.flash_bwd_dkv_launches - counts[2]]
    if row["launches"] != [0, 1, 1]:
        raise AssertionError("f32 backward at %s launched (C1, C2, C3) %r, "
                             "want the split pair" % (row["shape"],
                                                      row["launches"]))
    plain = h <= 2
    if plain:
        ref = fac._flash_bwd_reference(q, k, v, out, lse, do, True, scale)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            e, rms, ok = within(g, r, ULP_REL["float32"],
                                RMS_FRAC["float32"])
            row["split_%s_err" % name] = e
            if not ok:
                raise AssertionError("f32 split backward at %s (%s): err %g "
                                     "(rms %g)" % (row["shape"], name, e,
                                                   rms))
        del ref
    del got
    row.update(time_bwd(torch, fac, tF, q, k, v, do, out, lse, True,
                        reps=3, inner=2, plain=plain))
    bwd_bounds(row, 1, s, h, d, True, True)
    row["split_pair_bound_ms"], _ = bwd_bound(1, s, h, d, True, 5, 7, True,
                                              TF32X3_FLOPS)
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return row


def check_f32_long(torch, fac):
    """Kernel A in f32 at S = 16384: against its plain version at 2 heads,
    with its times, the plain version's and SDPA's; then the times of A
    and SDPA at train_long's 16 heads, where the plain version would not
    fit.  Then the f32 backward at S = 16384 (the split pair by the
    route), at 2 heads against its plain version, at 16 timed against
    SDPA's f32 backward (:func:`check_f32_bwd_long`).  Returns (forward
    rows, backward rows)."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(7)
    f32 = torch.float32
    rows = [check_fwd_case(torch, fac, tF, 1, 16384, 2, 64, True, f32, gen,
                           reps=3, inner=2)]
    torch.cuda.empty_cache()
    q, k, v = fused_qkv(torch, 1, 16384, 16, 64, f32, gen)
    row = {"shape": [1, 16384, 16, 64], "causal": True, "dtype": "float32",
           "kernel": "flash_fwd"}
    time_kernel(torch, row, "kernel",
                lambda: fac.flash_attention_bshd(q, k, v, True),
                "flash_fwd_kernel", reps=3, inner=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    time_kernel(torch, row, "library",
                lambda: tF.scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True),
                None, reps=3, inner=2)
    fwd_bounds(row, 1, 16384, 16, 64, True, f32)
    rows.append(row)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows, [check_f32_bwd_long(torch, fac, tF, gen, h)
                  for h in (2, 16)]


# kernel A and the f32 A' at each tile: the training shape, head dims 128
# and 256, train_long's S = 16384 at 16 heads and at 2, and the serving
# prefill (b, s, h, d, causal)
F32_FWD_TILE_CASES = ((8, 1024, 16, 64, True), (1, 1024, 8, 128, True),
                      (1, 256, 4, 256, True), (1, 16384, 16, 64, True),
                      (1, 16384, 2, 64, True), (1, 128, 16, 64, True))


def check_f32_fwd_tiles(torch, fac, at, cases=F32_FWD_TILE_CASES):
    """Kernel A (its tiles at the head dim) and the f32 A' at each of its
    tiles that fits a block, at each case (b, s, h, d, causal) or at the
    one case given: each held to the f32 bars against its plain version
    (A against the plain forward, A' against the tile walk; at S = 16384
    and 16 heads, where the plain version does not fit, A' against A),
    lse within LSE_TOL; then each kernel's device ms, SDPA's f32 device
    ms, the 3 x TF32 and FMA bounds and the share of the first that each
    kernel reaches."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(8)
    f32 = torch.float32
    limit = at.smem_limit(torch.device("cuda"))
    if isinstance(cases[0], int):
        cases = (cases,)
    rows = []
    for b, s, h, d, causal in cases:
        causal = bool(causal)
        q, k, v = fused_qkv(torch, b, s, h, d, f32, gen)
        scale = d ** -0.5
        n = 2 if s > 4096 else 10
        plain = s * h <= 16384 * 2
        row = {"shape": [b, s, h, d], "causal": causal, "dtype": "float32"}
        fwd_bounds(row, b, s, h, d, causal, f32)
        out_a, lse_a = fac._launch(q, k, v, causal, scale, True)
        runs = [("A", fac._fwd_specs(s, s, d, f32, causal)[0][1:], out_a,
                 lse_a,
                 lambda: fac._launch(q, k, v, causal, scale, False),
                 "flash_fwd_kernel")]
        for bq, bk in fac._PIPELINED_BLOCKS:
            if fac.pipelined_smem_bytes(d, bq, bk, f32) > limit:
                continue
            out, lse = fac._launch_pipelined(q, k, v, causal, scale, True,
                                             bq, bk)
            runs.append(("A'", (bq, bk), out, lse,
                         lambda bq=bq, bk=bk: fac._launch_pipelined(
                             q, k, v, causal, scale, False, bq, bk),
                         "flash_fwd_pipelined_kernel"))
        tiles = []
        for kern, blocks, out, lse, fn, pattern in runs:
            if not plain:
                ref, ref_lse = out_a, lse_a
            elif kern == "A":
                ref, ref_lse = fac._flash_reference(q, k, v, causal, scale)
            else:
                ref, ref_lse = fac._flash_tc_reference(q, k, v, causal,
                                                       scale, *blocks)
            torch.cuda.synchronize()
            err, rms, ok = within(out, ref, ULP_REL["float32"],
                                  RMS_FRAC["float32"])
            lse_err = float((lse - ref_lse).abs().max())
            del ref, ref_lse
            if not ok or lse_err > LSE_TOL:
                raise AssertionError(
                    "f32 %s %s at %s causal=%s: out err %g (ref rms %g), "
                    "lse err %g" % (kern, blocks, row["shape"], causal, err,
                                    rms, lse_err))
            ms = kernel_ms(device_times(fn, torch, n=n, pattern=pattern),
                           pattern)
            tiles.append({"kernel": kern, "blocks": list(blocks),
                          "against": "plain" if plain else "A",
                          "max_abs_err": err, "ref_rms": rms,
                          "lse_max_abs_err": lse_err, "device_ms": ms,
                          "bound_share": ms and row["bound_ms"] / ms})
        del runs, out_a, lse_a
        row["tiles"] = tiles
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_device_ms"] = call_ms(device_times(
            lambda: tF.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=causal),
            torch, n=n), n)
        rows.append(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


PIPELINED_CASES = [
    # (b, s, h, d, causal, dtype name): the serving prefill, the training
    # shape, S=16384 at 2 heads and at train_long's 16 heads (there the
    # plain version's time is not taken), one non-causal case, D 128 and
    # 256, fp16 at the prefill, training and S=16384 shapes (untimed
    # plain), f32 at S=1024 and the training shape
    (1, 128, 16, 64, True, "bfloat16"),
    (8, 1024, 16, 64, True, "bfloat16"),
    (1, 16384, 2, 64, True, "bfloat16"),
    (1, 16384, 16, 64, True, "bfloat16"),
    (1, 1024, 16, 64, False, "bfloat16"),
    (1, 1024, 8, 128, True, "bfloat16"),
    (1, 1024, 4, 256, True, "bfloat16"),
    (1, 128, 16, 64, True, "float16"),
    (8, 1024, 16, 64, True, "float16"),
    (1, 16384, 2, 64, True, "float16"),
    (1, 1024, 16, 64, True, "float32"),
    (8, 1024, 16, 64, True, "float32"),
]


def check_pipelined(torch, fac, at, lib, cases=None):
    """Kernel A' at each (block_q, block_k) instantiation on every
    PIPELINED_CASES shape, with the lse, held against its plain version
    (the tile walk at the same tiles): the event and device ms of A', of
    its plain version (bf16 and f32 up to 2 heads at S = 16384) and of
    SDPA (a yardstick), the device ms of the dtype's candidate [0] at the
    same shape, and the bound.  16-bit inputs take the tensor-core A'
    (csrc/flash_fwd_pipelined_tc.cu), f32 the 3 x TF32 one.
    Every dtype is held to its own bars (f32 to 1e-5 relative plus 1e-4
    of the RMS).  An instantiation whose shared memory exceeds a block's
    is refused by the gate (its size held against the C side's) and never
    launched.
    ``cases``: indices into PIPELINED_CASES to run (all by default); the
    inputs are drawn for every case all the same, so a case's input does
    not depend on which others run."""
    import torch.nn.functional as tF
    gen = torch.Generator(device="cuda").manual_seed(6)
    limit = at.smem_limit(torch.device("cuda"))
    rows, worst, refused = [], 0.0, []
    for i, (b, s, h, d, causal, dname) in enumerate(PIPELINED_CASES):
        dtype = getattr(torch, dname)
        tc = dtype in fac._TC_DTYPES
        q, k, v = fused_qkv(torch, b, s, h, d, dtype, gen)
        if cases is not None and i not in cases:
            del q, k, v
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        scale = d ** -0.5
        reps, inner = (3, 2) if s >= 16384 else (5, 10)
        time_plain = dtype != torch.float16 and s * h <= 16384 * 2
        ulp, frac = ULP_REL[dname], RMS_FRAC[dname]
        default = fac._fwd_specs(s, s, d, dtype, causal)[0]
        default_kernel = "flash_fwd_tc_kernel" if tc else "flash_fwd_kernel"
        shape_row = {
            "default_fwd_blocks": list(default[1:]),
            "default_fwd_device_ms": kernel_ms(device_times(
                lambda: fac._run_fwd(q, k, v, causal, scale, False, default),
                torch, n=inner, pattern=default_kernel), default_kernel)}
        time_kernel(torch, shape_row, "library",
                    lambda: tF.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), None, reps, inner)
        for bq, bk in fac._PIPELINED_BLOCKS:
            need = fac.pipelined_smem_bytes(d, bq, bk, dtype)
            c_need = (lib.paddle_flash_fwd_pipelined_tc_smem(d, bq, bk) if tc
                      else lib.paddle_flash_fwd_pipelined_smem(
                          d, bq, bk, fac._DTYPES[dtype]))
            if c_need != need:
                raise AssertionError("A' shared memory: the gate's %d bytes "
                                     "differ from the kernel's %d"
                                     % (need, c_need))
            row = {"shape": [b, s, h, d], "causal": causal, "dtype": dname,
                   "blocks": [bq, bk], "smem_bytes": need}
            if need > limit:
                refused.append(row)
                continue
            out, lse = fac._launch_pipelined(q, k, v, causal, scale, True,
                                             bq, bk)
            ref, ref_lse = fac._flash_tc_reference(q, k, v, causal,
                                                   scale, bq, bk)
            torch.cuda.synchronize()
            err, rms, ok = within(out, ref, ulp, frac)
            lse_err = float((lse - ref_lse).abs().max())
            del out, lse, ref, ref_lse
            if not ok or lse_err > LSE_TOL:
                raise AssertionError("flash_fwd_pipelined %r: out err %g "
                                     "(ref rms %g), lse err %g"
                                     % (row, err, rms, lse_err))
            worst = max(worst, err)
            row.update(max_abs_err=err, ref_rms=rms, lse_max_abs_err=lse_err)
            time_kernel(torch, row, "kernel",
                        lambda: fac._launch_pipelined(q, k, v, causal, scale,
                                                      False, bq, bk),
                        "flash_fwd_pipelined_tc_kernel" if tc
                        else "flash_fwd_pipelined_kernel", reps, inner)
            if time_plain:
                time_kernel(torch, row, "plain",
                            lambda: fac._flash_tc_reference(
                                q, k, v, causal, scale, bq, bk), None,
                            min(reps, PLAIN_REPS), min(inner, PLAIN_INNER))
            row.update(shape_row)
            fwd_bounds(row, b, s, h, d, causal, dtype)
            rows.append(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows, worst, refused


def check_pipelined_repeats(torch, fac, repeats=3, strict=True, seed=None,
                            contend=False):
    """The 16-bit kernel A' at train_long's attention shape (1, 16384, 16,
    64) causal, at every tile, bf16 and fp16, run ``repeats`` times on one
    input: check_pipelined's own input at that shape (its generator drawn
    as far), or with ``seed`` one drawn from that seed; in fp16 the same
    values.  Each run must equal the first bit
    for bit (a K/V ring that let a slot be read before its copies landed,
    or refilled before its last product retired, shows as a difference)
    and hold the plain version's bar; the plain version is computed twice
    and must repeat too.  A row holds the runs that differed and the first
    (s, h) rows where they did, the worst error over all runs, where it
    lies, and the first run's error against the tile walk that keeps p in
    f32 (``unrounded_*``, the plain version of PRs 4-7, which the bar
    tells apart).  ``contend`` keeps a second stream busy with 1 GB
    copies through the runs (the copies' blocks share the SMs and HBM, so
    the ring's copies land later and in other orders).  ``strict`` raises
    on any fault once every row is taken."""
    b, s, h, d = 1, 16384, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(
        6 if seed is None else seed)
    # check_pipelined draws an input for each case before this one
    mine = PIPELINED_CASES.index((b, s, h, d, True, "bfloat16"))
    for case in PIPELINED_CASES[:mine] if seed is None else ():
        fused_qkv(torch, *case[:4], torch.bfloat16, gen)
    qkv = fused_qkv(torch, b, s, h, d, torch.bfloat16, gen)
    scale = d ** -0.5
    rows, faults = [], []
    side = torch.cuda.Stream() if contend else None
    if side is not None:
        src = torch.empty(1 << 29, dtype=torch.float16, device="cuda")
        dst = torch.empty_like(src)
    for dname in ("bfloat16", "float16"):
        ulp, frac = ULP_REL[dname], RMS_FRAC[dname]
        q, k, v = (t.to(getattr(torch, dname)) for t in qkv)
        for bq, bk in fac._PIPELINED_BLOCKS:
            ref, ref_lse = fac._flash_tc_reference(q, k, v, True, scale, bq,
                                                   bk)
            again, again_lse = fac._flash_tc_reference(q, k, v, True, scale,
                                                       bq, bk)
            row = {"shape": [b, s, h, d], "dtype": dname, "blocks": [bq, bk],
                   "seed": seed, "runs": repeats,
                   "plain_repeats": bool(torch.equal(ref, again)
                                         and torch.equal(ref_lse, again_lse)),
                   "differing_runs": [], "differing_rows": [],
                   "max_abs_err": 0.0, "over_bar": 0, "lse_max_abs_err": 0.0}
            del again, again_lse
            first = None
            for i in range(repeats):
                if side is not None and i % 50 == 0:
                    with torch.cuda.stream(side):
                        for _ in range(100):
                            dst.copy_(src)
                out, lse = fac._launch_pipelined(q, k, v, True, scale, True,
                                                 bq, bk)
                if first is None:
                    first = (out, lse)
                elif not (torch.equal(out, first[0])
                          and torch.equal(lse, first[1])):
                    row["differing_runs"].append(i)
                    if not row["differing_rows"]:
                        where = ((out != first[0]).any(-1)
                                 | (lse != first[1])).nonzero()[:8]
                        row["differing_rows"] = where[:, 1:].tolist()
                diff = (out.float() - ref.float()).abs()
                err, rms, _ok = within(out, ref, ulp, frac)
                bar = ulp * ref.float().abs() + frac * rms
                row["over_bar"] = max(row["over_bar"],
                                      int((diff > bar).sum()))
                row["lse_max_abs_err"] = max(
                    row["lse_max_abs_err"],
                    float((lse - ref_lse).abs().max()))
                if err > row["max_abs_err"] or i == 0:
                    at = np.unravel_index(int(diff.argmax()), diff.shape)
                    row.update(max_abs_err=err, ref_rms=rms,
                               worst_at=[int(x) for x in at],
                               worst_ref=float(ref[at]),
                               worst_got=float(out[at]))
                del out, lse, diff, bar
            del ref, ref_lse
            # v in f32: the same walk with p unrounded
            flat, _lse = fac._flash_tc_reference(q, k, v.float(), True,
                                                 scale, bq, bk)
            err, rms, ok = within(first[0], flat, ulp, frac)
            row.update(unrounded_max_abs_err=err, unrounded_within_bar=ok)
            del first, flat, _lse
            if (row["differing_runs"] or row["over_bar"]
                    or row["lse_max_abs_err"] > LSE_TOL
                    or not row["plain_repeats"]):
                faults.append(row)
            rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    if side is not None:
        torch.cuda.synchronize()
    if strict and faults:
        raise AssertionError("flash_fwd_pipelined repeats: %r" % faults)
    return rows


def check_layer_norm_bwd(torch, norm_cuda, dtype=None,
                         sizes=(8192, 16384, 128)):
    """Kernel D against the plain backward at (8192, 1024), the training
    shape, (16384, 1024), train_long's rows, and (128, 1024): bf16 x / dO
    (or ``dtype``), f32 gamma.  D is two launches, the rows pass
    (``layer_norm_bwd_kernel``) and the reduction of its partial sums
    (``layer_norm_bwd_reduce_kernel``), each timed on its own too."""
    import torch.nn.functional as tF
    dtype = dtype or torch.bfloat16
    name16 = dtype_name(dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, worst = [], 0.0
    for r in sizes:
        f = 1024
        x, do = (torch.randn((r, f), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        g = 1 + 0.1 * torch.randn((f,), generator=gen, device="cuda")
        bta = 0.1 * torch.randn((f,), generator=gen, device="cuda")
        _o, mean, rstd = norm_cuda.layer_norm_fwd(x, g, bta)
        got = norm_cuda.layer_norm_bwd(x, g, mean, rstd, do)
        ref = norm_cuda._layer_norm_bwd_reference(x, g, mean, rstd, do)
        torch.cuda.synchronize()
        row = {"shape": [r, f], "dtype": name16}
        for name, a, w, tol in (
                ("dx", got[0], ref[0], (ULP_REL[name16], RMS_FRAC[name16])),
                ("dgamma", got[1], ref[1], (LN_BWD_F32_REL,
                                            LN_BWD_F32_RMS_FRAC)),
                ("dbeta", got[2], ref[2], (LN_BWD_F32_REL,
                                           LN_BWD_F32_RMS_FRAC))):
            err, rms, ok = within(a, w, *tol)
            row[name + "_err"] = err
            if not ok:
                raise AssertionError("layer_norm_bwd (%d, %d) %s %s: err %g "
                                     "(rms %g)" % (r, f, name16, name, err,
                                                   rms))
            worst = max(worst, err)
        # the library yardstick takes gamma / beta in x's dtype
        xr = x.detach().requires_grad_()
        g16, b16 = (t.to(dtype).requires_grad_() for t in (g, bta))
        lib_out = tF.layer_norm(xr, (f,), g16, b16, 1e-5)
        runs = {
            "kernel": lambda: norm_cuda.layer_norm_bwd(x, g, mean, rstd, do),
            "plain": lambda: norm_cuda._layer_norm_bwd_reference(
                x, g, mean, rstd, do),
            "library": lambda: torch.autograd.grad(
                lib_out, (xr, g16, b16), do, retain_graph=True)}
        for name, fn in runs.items():
            row[name + "_ms"] = time_ms(fn, torch)
            row[name + "_device_ms"] = device_ms(fn, torch)
        times = device_times(runs["kernel"], torch)
        row["rows_pass_device_ms"] = kernel_ms(times,
                                               "layer_norm_bwd_kernel")
        row["reduce_device_ms"] = kernel_ms(times,
                                            "layer_norm_bwd_reduce_kernel")
        nbytes = 3 * r * f * 2 + f * 4 + 2 * r * 4 + 2 * f * 4
        row["bound_ms"], row["bound_by"] = bound(nbytes, 12 * r * f,
                                                 F32_FLOPS)
        rows.append(row)
    return rows, worst


def ce_bound(nbytes, n_elems, ops_per_elem):
    """Bound of a cross-entropy or softmax pass: its bytes, and
    ``ops_per_elem`` f32 operations on each logit (scale, max, subtract,
    exp2, sum; the backward's one-hot and product)."""
    return bound(nbytes, ops_per_elem * n_elems, F32_FLOPS)


def time_kernel(torch, row, name, fn, pattern, reps=5, inner=10):
    """``<name>_ms`` (CUDA events around the call) and
    ``<name>_device_ms`` (profiler: the kernels whose name holds
    ``pattern``, or every kernel of the call when it is None)."""
    row[name + "_ms"] = time_ms(fn, torch, reps=reps, inner=inner)
    times = device_times(fn, torch, n=inner, pattern=pattern)
    row[name + "_device_ms"] = (kernel_ms(times, pattern) if pattern
                                else call_ms(times, inner))


def check_ce(torch, ce_cuda, norm_cuda, flags):
    """E1, E2 and E3 against their plain versions on the card, bf16.
    At the training shape (8192, 50304), with the times of each kernel,
    its plain version and its PyTorch yardstick.  At (64, 1024) with
    labels out of range: the kernels clamp them as the plain versions'
    clipped labels read; then ``cross_entropy`` under each flag against
    the plain route, ignored labels included, loss and gradient."""
    import torch.nn.functional as tF
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, v = 8192, 50304
    x = (2.0 * torch.randn((n, v), generator=gen, device="cuda")).to(
        torch.bfloat16)
    y = torch.randint(0, v, (n, 1), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.randn((n,), generator=gen, device="cuda") / n
    r_nll, r_lse = ce_cuda.softmax_ce_reference(x, y)
    lse = ce_cuda.lse_fwd(x)
    nll, lse2 = ce_cuda.ce_fwd(x, y)
    dx = ce_cuda.ce_bwd(x, y, r_lse, g)
    r_dx = ce_cuda.softmax_ce_bwd_reference(x, y, r_lse, g)
    torch.cuda.synchronize()
    errs = {"ce_lse": float((lse - r_lse).abs().max()),
            "ce_fwd": max(float((nll - r_nll).abs().max()),
                          float((lse2 - r_lse).abs().max()))}
    errs["ce_bwd"], dx_rms, dx_ok = within(dx, r_dx, CE_ULP_REL, CE_RMS_FRAC)
    if max(errs["ce_lse"], errs["ce_fwd"]) > CE_STAT_TOL or not dx_ok:
        raise AssertionError("CE kernels at (%d, %d): errors %r (dx ref "
                             "rms %g)" % (n, v, errs, dx_rms))
    del dx, r_dx, lse, nll, lse2
    nbytes_in = n * v * 2
    y64 = y.long()[:, 0]
    xr = x.detach().requires_grad_()
    lib_out = tF.cross_entropy(xr, y64, reduction="none")
    g16 = g.to(torch.bfloat16)
    rows = {
        "ce_lse": {"kernel": lambda: ce_cuda.lse_fwd(x),
                   "plain": lambda: ce_cuda.logsumexp_reference(x),
                   "library": lambda: torch.logsumexp(x, -1),
                   "pattern": "ce_lse_kernel",
                   "bound": ce_bound(nbytes_in + n * 4, n * v, 5)},
        "ce_fwd": {"kernel": lambda: ce_cuda.ce_fwd(x, y),
                   "plain": lambda: ce_cuda.softmax_ce_reference(x, y),
                   "library": lambda: tF.cross_entropy(x, y64,
                                                       reduction="none"),
                   "pattern": "ce_fwd_kernel",
                   "bound": ce_bound(nbytes_in + n * 12, n * v, 5)},
        "ce_bwd": {"kernel": lambda: ce_cuda.ce_bwd(x, y, r_lse, g),
                   "plain": lambda: ce_cuda.softmax_ce_bwd_reference(
                       x, y, r_lse, g),
                   "library": lambda: torch.autograd.grad(
                       lib_out, xr, g16, retain_graph=True),
                   "pattern": "ce_bwd_kernel",
                   "bound": ce_bound(2 * nbytes_in + n * 12, n * v, 5)}}
    out = {}
    for name, spec in rows.items():
        row = {"shape": [n, v], "max_abs_err": errs[name]}
        for part in ("kernel", "plain", "library"):
            time_kernel(torch, row, part, spec[part],
                        spec["pattern"] if part == "kernel" else None)
        row["bound_ms"], row["bound_by"] = spec["bound"]
        out[name] = row
    del xr, lib_out

    # small shape: labels out of range (the kernels clamp them) and, through
    # cross_entropy, ignored ones
    ns, vs = 64, 1024
    xs = (2.0 * torch.randn((ns, vs), generator=gen, device="cuda")).to(
        torch.bfloat16)
    ys = torch.randint(0, vs, (ns, 1), generator=gen, device="cuda",
                       dtype=torch.int32)
    ys[:4, 0] = torch.tensor([-100, -1, vs, vs + 7], device="cuda",
                             dtype=torch.int32)
    clipped = ys.clamp(0, vs - 1)
    gs = torch.randn((ns,), generator=gen, device="cuda")
    s_nll, s_lse = ce_cuda.softmax_ce_reference(xs, clipped)
    bwd_err, _rms, bwd_ok = within(
        ce_cuda.ce_bwd(xs, ys, s_lse, gs),
        ce_cuda.softmax_ce_bwd_reference(xs, clipped, s_lse, gs),
        CE_ULP_REL, CE_RMS_FRAC)
    small = {"shape": [ns, vs],
             "ce_lse_err": float((ce_cuda.lse_fwd(xs) - s_lse).abs().max()),
             "ce_fwd_err": float((ce_cuda.ce_fwd(xs, ys)[0] - s_nll)
                                 .abs().max()),
             "ce_bwd_err": bwd_err}
    if max(small["ce_lse_err"], small["ce_fwd_err"]) > CE_STAT_TOL or \
            not bwd_ok:
        raise AssertionError("CE kernels with out-of-range labels: %r"
                             % (small,))
    logits = xs.float().reshape(4, 16, vs).requires_grad_()
    labels = ys.long().reshape(4, 16).clamp(0, vs - 1)
    labels[0, :3] = -100
    want = F.cross_entropy(logits, labels)
    (want_grad,) = torch.autograd.grad(want, logits)
    for flag in ("use_pallas_ce", "use_pallas_lse"):
        flags.set_flags({flag: True})
        try:
            got = F.cross_entropy(logits, labels)
            (got_grad,) = torch.autograd.grad(got, logits)
        finally:
            flags.set_flags({flag: False})
        small[flag + "_loss_err"] = abs(float(got.detach())
                                        - float(want.detach()))
        small[flag + "_grad_err"] = float((got_grad - want_grad).abs().max())
        if small[flag + "_loss_err"] > 1e-5 or \
                small[flag + "_grad_err"] > 1e-6 or \
                float(got_grad[0, :3].abs().max()) != 0.0:
            raise AssertionError("cross_entropy under %s against the plain "
                                 "route: %r" % (flag, small))

    out["small"] = small
    del x, y, g, r_nll, r_lse
    torch.cuda.empty_cache()
    return out


# kernel F's shapes: the hidden width at 8192 and 16384 rows (the
# register plan, a warp a row), a few and many rows of the training
# logits (the staged kernel), and the hidden width in f32 and fp16
SOFTMAX_CASES = (((8192, 1024), "bfloat16"), ((16384, 1024), "bfloat16"),
                 ((8, 50304), "bfloat16"), ((8192, 50304), "bfloat16"),
                 ((8192, 1024), "float32"), ((8192, 1024), "float16"))


# one turn of a timing ring moves at least this many bytes, four times
# the H100's 50 MB L2
L2_COLD_BYTES = 200 * 10**6


def cold_ring(fn, x):
    """A callable that applies ``fn`` to copies of ``x`` in turn and holds
    the newest outputs, with enough copies that one turn of inputs and
    outputs moves L2_COLD_BYTES: every call then reads its input from HBM
    and writes its output to fresh lines, as the bound counts, and none
    finds them in L2 from an earlier call.  Returns (callable, copies)."""
    import collections
    copies = max(1, -(-L2_COLD_BYTES // (2 * x.numel() * x.element_size())))
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    outs = collections.deque(maxlen=copies)
    turn = [0]

    def call():
        outs.append(fn(xs[turn[0] % copies]))
        turn[0] += 1
    return call, copies


def check_softmax(torch, norm_cuda, cases=SOFTMAX_CASES, repeats=3):
    """Kernel F against its plain version on the card at each (shape,
    dtype) of ``cases`` (x = 2 N(0, 1) from a seeded generator): within
    one ulp of |ref| in the dtype plus 1/64 of its RMS, ``repeats`` runs
    on one input bit-identical, and the device and event ms of the
    kernel, the plain version and ``torch.softmax`` beside the bound
    (x read once, the output written once; 5 f32 operations an
    element), each timed over a ``cold_ring`` of copies of x so that no
    call finds its data in L2."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for (r, f), dt in cases:
        dtype = getattr(torch, dt)
        x = (2.0 * torch.randn((r, f), generator=gen, device="cuda")).to(
            dtype)
        runs = [norm_cuda.softmax_pallas(x) for _ in range(repeats)]
        ref = norm_cuda._softmax_reference(x)
        torch.cuda.synchronize()
        err, rms, ok = within(runs[0], ref, ULP_REL[dt], CE_RMS_FRAC)
        same = all(torch.equal(runs[0], o) for o in runs[1:])
        if not ok or not same:
            raise AssertionError("softmax_fwd %s %s: err %g (ref rms %g), "
                                 "%d runs bit-identical: %s"
                                 % ((r, f), dt, err, rms, repeats, same))
        del runs, ref
        row = {"shape": [r, f], "dtype": dt, "max_abs_err": err,
               "runs_bit_identical": repeats}
        for part, fn in (("kernel", norm_cuda.softmax_pallas),
                         ("plain", norm_cuda._softmax_reference),
                         ("library", lambda t: torch.softmax(t, -1))):
            call, row["timed_copies"] = cold_ring(fn, x)
            time_kernel(torch, row, part, call,
                        "softmax_fwd_kernel" if part == "kernel" else None)
            del call
        row["bound_ms"], row["bound_by"] = ce_bound(
            2 * r * f * x.element_size(), r * f, 5)
        row["bound_share"] = row["bound_ms"] / row["kernel_device_ms"]
        rows.append(row)
        del x
    torch.cuda.empty_cache()
    return rows


def train_model(torch, base, amp, device="cuda"):
    """A card copy of the f32 CPU model ``base``, AMP O2 bf16."""
    return amp.decorate(copy.deepcopy(base), level="O2",
                        dtype="bfloat16").to(device)


def train_ids(torch, vocab, device="cuda"):
    """The train step's seeded (8, 1024) batch."""
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (8, 1024)), device=device)


def make_step(model, lr=1e-4, device="cuda", flat_master=None,
              stack_layers=False, in_shardings=None, zero_stage=None):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                parameters=model.parameters())
    return TrainStep(model, GPTPretrainingCriterion(), opt,
                     device=device, flat_master=flat_master,
                     stack_layers=stack_layers, in_shardings=in_shardings,
                     zero_stage=zero_stage)


def step_breakdown(torch, step, ids):
    """One step with CUDA events at forward start and end, after the
    loss, around the optimizer update and at the end: the stream time of
    each part (host-side gaps included)."""
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()
    hooks = [step.model.register_forward_pre_hook(
                 lambda m, a: mark("forward")),
             step.model.register_forward_hook(
                 lambda m, a, o: mark("criterion"))]
    loss_fn, apply = step.loss_fn, step.optimizer.apply_gradients

    def timed_loss(*a):
        loss = loss_fn(*a)
        mark("backward")
        return loss

    def timed_apply(*a):
        mark("optimizer")
        out = apply(*a)
        mark("write_back")
        return out
    step.loss_fn, step.optimizer.apply_gradients = timed_loss, timed_apply
    try:
        torch.cuda.synchronize()
        mark("start")
        step(ids, ids)
        mark("end")
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        step.loss_fn = loss_fn
        del step.optimizer.apply_gradients
    order = ["start", "forward", "criterion", "backward", "optimizer",
             "write_back", "end"]
    out = {"%s_ms" % a: marks[a].elapsed_time(marks[b])
           for a, b in zip(order[1:-1], order[2:])}
    out["step_ms"] = marks["start"].elapsed_time(marks["end"])
    return out


def profile_steps(torch, step, ids, n=2, sums=()):
    """Device-busy share and top kernels over ``n`` steps
    (``torch.profiler`` trace; host clock around the traced steps); for
    each pattern of ``sums`` the device ms a step of the kernels whose
    name holds it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(ids, ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [(e.key, int(e.count),
               float(getattr(e, "self_device_time_total", 0.0) or 0.0))
              for e in prof.key_averages()]
    events = [e for e in events if e[2] > 0]
    dev_ms = sum(e[2] for e in events) / n / 1e3
    events.sort(key=lambda e: -e[2])
    return {"traced_step_wall_ms": wall_ms, "step_device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "device_kernels_per_step": sum(e[1] for e in events) / n,
            "device_ms_per_step_of": {
                pat: sum(t for k, _c, t in events if pat in k) / n / 1e3
                for pat in sums},
            "top_kernels": [{"name": k[:90], "per_step": c / n,
                             "ms_per_step": t / n / 1e3}
                            for k, c, t in events[:12]]}


def expect_launches(got, want, what):
    """Raise unless every named count in ``want`` matches ``got``."""
    bad = {k: (got[k], w) for k, w in want.items() if got[k] != w}
    if bad:
        raise AssertionError("%s: launches (got, want) %r" % (what, bad))


def train(torch, base, amp, counters, flags, steps=10, warmup=3):
    """bench.py's step: GPT-2 345M, AMP O2 bf16, AdamW(1e-4, wd 0.01), the
    label-shift criterion, one seeded (8, 1024) batch as input and
    labels; ``warmup`` steps, then ``steps`` timed ones with one sync at
    the end."""
    flags.set_flags({"use_pallas_norm": False})
    step = make_step(train_model(torch, base, amp))
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(warmup)]
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    per_step = {k: n / steps for k, n in launches.items()}
    losses = [float(x) for x in losses]
    line = {"phase": "train", "shape": [8, 1024], "warmup_steps": warmup,
            "timed_steps": steps, "step_ms": wall * 1e3 / steps,
            "tokens_per_s": 8 * 1024 * steps / wall, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    line["breakdown"] = step_breakdown(torch, step, ids)
    line["profile"] = profile_steps(torch, step, ids)
    emit(line)
    layers = base.config.num_hidden_layers
    expect_launches(launches, {"flash_fwd_tc": layers * steps,
                               "flash_fwd": 0, "flash_fwd_pipelined": 0,
                               "flash_bwd": 0,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps,
                               "layer_norm_fwd": 0, "layer_norm_bwd": 0,
                               "ce_lse": 0, "ce_fwd": 0, "ce_bwd": 0},
                    "train")
    first, last = losses[0], losses[-1]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train: non-finite loss %r" % (losses,))
    if abs(first - math.log(base.config.vocab_size)) > FIRST_LOSS_TOL:
        raise AssertionError("train: first loss %g, want ln(%d) = %g +- %g"
                             % (first, base.config.vocab_size,
                                math.log(base.config.vocab_size),
                                FIRST_LOSS_TOL))
    if not last < first:
        raise AssertionError("train: loss did not fall: %r" % (losses,))
    return line


def run_steps(torch, step, ids, counters, steps):
    """``steps`` train steps from launch counts set to 0: the losses, the
    counts, and the host-clock ms per step over all steps but the first
    (which allocates the step's buffers)."""
    torch.cuda.synchronize()
    counters.reset()
    losses = [step(ids, ids)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(ids, ids) for _ in range(steps - 1)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    return [float(x) for x in losses], counters.read(), ms


def train_norm(torch, base, amp, counters, flags, first_loss, steps=3):
    """The train step for ``steps`` steps with ``use_pallas_norm`` on, from
    the same weights: kernels B and D, 49 launches each per step; the
    attention kernels as in train."""
    flags.set_flags({"use_pallas_norm": True})
    try:
        step = make_step(train_model(torch, base, amp))
        ids = torch.as_tensor(np.random.default_rng(0).integers(
            0, base.config.vocab_size, (8, 1024)), device="cuda")
        losses, launches, ms = run_steps(torch, step, ids, counters, steps)
        # device time a step, which a host stall in the 2 timed steps
        # does not move
        profile = profile_steps(torch, step, ids)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    line = {"phase": "train_norm", "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "first_loss_default_route": first_loss,
            "first_loss_diff": abs(losses[0] - first_loss),
            "tolerance": NORM_ROUTE_LOSS_TOL, "launches": launches,
            "profile": profile}
    emit(line)
    n_ln = 2 * base.config.num_hidden_layers + 1
    layers = base.config.num_hidden_layers
    expect_launches(launches, {"layer_norm_fwd": n_ln * steps,
                               "layer_norm_bwd": n_ln * steps,
                               "flash_fwd_tc": layers * steps,
                               "flash_bwd": 0,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps},
                    "train_norm")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - first_loss) > NORM_ROUTE_LOSS_TOL:
        raise AssertionError("train_norm: losses %r against the default "
                             "route's first %g" % (losses, first_loss))
    return line


def train_ce(torch, base, amp, counters, flags, first_loss, steps=3):
    """The train step for ``steps`` steps under each cross-entropy kernel
    route, from the same weights and batch: ``use_pallas_ce`` launches E2
    and E3 once a step, ``use_pallas_lse`` E1 once a step; attention as in
    train, LayerNorm plain.  First losses held against the default
    route's."""
    layers = base.config.num_hidden_layers
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    lines = []
    for flag in ("use_pallas_ce", "use_pallas_lse"):
        flags.set_flags({flag: True})
        try:
            step = make_step(train_model(torch, base, amp))
            losses, launches, ms = run_steps(torch, step, ids, counters,
                                             steps)
            breakdown = step_breakdown(torch, step, ids)
        finally:
            flags.set_flags({flag: False})
        del step
        torch.cuda.empty_cache()
        line = {"phase": "train_ce", "flag": flag, "steps": steps,
                "step_ms": ms, "tokens_per_s": 8 * 1024 * 1e3 / ms,
                "losses": losses,
                "first_loss_default_route": first_loss,
                "first_loss_diff": abs(losses[0] - first_loss),
                "tolerance": CE_ROUTE_LOSS_TOL, "launches": launches,
                "breakdown": breakdown}
        emit(line)
        lines.append(line)
        ce = flag == "use_pallas_ce"
        expect_launches(launches, {
            "flash_fwd_tc": layers * steps, "flash_fwd": 0, "flash_bwd": 0,
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "layer_norm_fwd": 0, "layer_norm_bwd": 0,
            "ce_fwd": steps if ce else 0, "ce_bwd": steps if ce else 0,
            "ce_lse": 0 if ce else steps}, "train_ce " + flag)
        if not all(math.isfinite(x) for x in losses) or \
                abs(losses[0] - first_loss) > CE_ROUTE_LOSS_TOL:
            raise AssertionError("train_ce (%s): losses %r against the "
                                 "default route's first %g"
                                 % (flag, losses, first_loss))
    return lines


def train_flat(torch, base, amp, counters, default_losses, steps=3):
    """``steps`` steps of the train step with ``flat_master=True`` from the
    same weights and batch: every master but wte in one f32 buffer.
    Losses held against the default step's first ones; the step's parts
    and a 2-step profile beside them."""
    from paddle_tpu_torch.jit import _FLAT_KEY
    step = make_step(train_model(torch, base, amp), flat_master=True)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    losses, launches, ms = run_steps(torch, step, ids, counters, steps)
    line = {"phase": "train_flat", "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "default_losses": default_losses[:steps],
            "max_loss_diff": max(abs(a - b) for a, b in
                                 zip(losses, default_losses)),
            "tolerance": FLAT_LOSS_TOL,
            "flat_elements": step.params[_FLAT_KEY].numel(),
            "per_name_masters": sorted(n for n in step.params
                                       if n != _FLAT_KEY),
            "launches": launches,
            "breakdown": step_breakdown(torch, step, ids),
            "profile": profile_steps(torch, step, ids)}
    emit(line)
    del step
    torch.cuda.empty_cache()
    layers = base.config.num_hidden_layers
    expect_launches(launches, {"flash_fwd_tc": layers * steps,
                               "flash_fwd": 0, "flash_bwd": 0,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps},
                    "train_flat")
    if line["max_loss_diff"] > FLAT_LOSS_TOL or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError("train_flat: losses %r against the default "
                             "step's %r" % (losses, default_losses[:steps]))
    return line


def scan_copy(base, **cfg):
    """A scan-layers copy of the per-layer f32 CPU model ``base`` (its
    weights stacked by ``per_layer_state_to_scan``), with ``cfg``'s
    fields of its config replaced."""
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             per_layer_state_to_scan)
    model = GPTForCausalLM(dataclasses.replace(base.config, scan_layers=True,
                                               **cfg))
    model.load_state_dict(per_layer_state_to_scan(base.state_dict()))
    model.train(base.training)
    return model


def split_parts(breakdown):
    """The optimizer and write-back parts of a ``step_breakdown``."""
    return {k: breakdown[k] for k in ("optimizer_ms", "write_back_ms")}


def hold_train_variant(phase, line, want):
    """Emit ``line`` with its largest loss difference from the default
    step's (``default_losses``), then raise unless its launches match
    ``want`` and every loss equals the default step's bit for bit: a
    layer layout or recompute changes where values are kept, not what is
    computed (AdamW is elementwise, a stacked grad is a stack of the
    per-layer ones, a re-run block draws the forward's values again)."""
    losses, ref = line["losses"], line["default_losses"]
    line["max_loss_diff"] = max(abs(a - b) for a, b in zip(losses, ref))
    line["tolerance"] = 0.0
    emit(line)
    expect_launches(line["launches"], want, phase)
    if not all(math.isfinite(x) for x in losses) or losses != ref:
        raise AssertionError("%s: losses %r, not the default step's %r bit "
                             "for bit" % (phase, losses, ref))


def train_stack(torch, base, amp, counters, default_losses, train_line,
                flat_line, steps=3, device="cuda"):
    """``steps`` steps of the train step with ``stack_layers=True`` from
    the same weights and batch: the masters of each of the 12 per-layer
    parameter templates in one f32 (24, ...) tensor, the model's
    parameters views of one bf16 (or f32 LayerNorm) buffer a template.
    Every loss held to the default step's bit for bit; the optimizer and
    write-back parts beside train's and train_flat's."""
    step = make_step(train_model(torch, base, amp, device), device=device,
                     stack_layers=True)
    ids = train_ids(torch, base.config.vocab_size, device)
    losses, launches, ms = run_steps(torch, step, ids, counters, steps)
    layers = base.config.num_hidden_layers
    templates = {t: len(names) for t, names in step._stack.items()}
    breakdown = step_breakdown(torch, step, ids)
    line = {"phase": "train_stack", "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "default_losses": default_losses[:steps],
            "stacked_templates": templates,
            "stacked_elements": sum(step.params[t].numel()
                                    for t in templates),
            "per_name_masters": sorted(n for n in step.params
                                       if n not in templates),
            "launches": launches, "breakdown": breakdown,
            "profile": profile_steps(torch, step, ids),
            "optimizer_and_write_back_ms": {
                "train": split_parts(train_line["breakdown"]),
                "train_flat": split_parts(flat_line["breakdown"]),
                "train_stack": split_parts(breakdown)}}
    del step
    torch.cuda.empty_cache()
    hold_train_variant("train_stack", line,
                       {"flash_fwd_tc": layers * steps, "flash_fwd": 0,
                        "flash_bwd": 0, "flash_bwd_dq": layers * steps,
                        "flash_bwd_dkv": layers * steps})
    if len(templates) != 12 or set(templates.values()) != {layers}:
        raise AssertionError("train_stack: templates %r, want 12 of %d"
                             % (templates, layers))
    return line


def train_scan(torch, base, amp, counters, default_losses, steps=3,
               device="cuda"):
    """``steps`` steps of the train step on the scan-layers model holding
    the same weights (``per_layer_state_to_scan``), under each
    ``scan_mode``: every loss equal to the default step's bit for bit,
    the launches train's.  The first mode's line carries the step's
    parts and a 2-step profile (both modes run the same code in eager
    PyTorch, so the second is held, not timed)."""
    ids = train_ids(torch, base.config.vocab_size, device)
    layers = base.config.num_hidden_layers
    scan = scan_copy(base)
    lines = []
    for i, mode in enumerate(("scan", "stack_vjp")):
        scan.config.scan_mode = mode
        step = make_step(train_model(torch, scan, amp, device), device=device)
        losses, launches, ms = run_steps(torch, step, ids, counters, steps)
        line = {"phase": "train_scan", "scan_mode": mode, "steps": steps,
                "step_ms": ms, "tokens_per_s": 8 * 1024 * 1e3 / ms,
                "losses": losses, "default_losses": default_losses[:steps],
                "masters": len(step.params), "launches": launches}
        if i == 0:
            line["breakdown"] = step_breakdown(torch, step, ids)
            line["profile"] = profile_steps(torch, step, ids)
        del step
        torch.cuda.empty_cache()
        hold_train_variant(
            "train_scan " + mode, line,
            {"flash_fwd_tc": layers * steps, "flash_fwd": 0, "flash_bwd": 0,
             "flash_bwd_dq": layers * steps,
             "flash_bwd_dkv": layers * steps})
        lines.append(line)
    return lines


def train_recompute(torch, base, amp, counters, default_losses, train_line,
                    steps=3, device="cuda"):
    """``steps`` steps with ``use_recompute=True``, per layer and on the
    scan-layers model (``stack_vjp``), from the same weights and batch:
    the flash forward launches twice a layer a step (the second run in
    the backward is the proof that the block was recomputed), the
    backward once; every loss equal to the default step's bit for bit.  Peak
    memory over the steps (``max_memory_allocated`` after a reset) and
    device ms a step beside train's."""
    ids = train_ids(torch, base.config.vocab_size, device)
    layers = base.config.num_hidden_layers
    lines = []
    for layout in ("per_layer", "scan"):
        model = (copy.deepcopy(base) if layout == "per_layer"
                 else scan_copy(base, scan_mode="stack_vjp"))
        model.config.use_recompute = True
        step = make_step(train_model(torch, model, amp, device),
                         device=device)
        del model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, launches, ms = run_steps(torch, step, ids, counters, steps)
        peak = torch.cuda.max_memory_allocated() / 1e9
        line = {"phase": "train_recompute", "layout": layout,
                "steps": steps, "step_ms": ms,
                "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
                "default_losses": default_losses[:steps],
                "launches": launches,
                "peak_memory_gb": peak,
                "train_peak_memory_gb": train_line["peak_memory_gb"],
                "profile": profile_steps(torch, step, ids),
                "train_step_device_ms":
                    train_line["profile"]["step_device_ms"]}
        del step
        torch.cuda.empty_cache()
        hold_train_variant(
            "train_recompute " + layout, line,
            {"flash_fwd_tc": 2 * layers * steps, "flash_fwd": 0,
             "flash_bwd": 0, "flash_bwd_dq": layers * steps,
             "flash_bwd_dkv": layers * steps})
        if not peak < train_line["peak_memory_gb"]:
            raise AssertionError("train_recompute %s: peak %.3f GB, not "
                                 "below train's %.3f" % (
                                     layout, peak,
                                     train_line["peak_memory_gb"]))
        lines.append(line)
    return lines


def collective_checks(torch, device):
    """Every collective of ``paddle_tpu_torch.distributed`` once, on
    tensors of ``device``, over the dp group of the world's mesh (and the
    in-place checks, the environment's view, DataParallel and
    parallelize), each against the value that the world's size and this
    rank give; returns {check: max abs error} and the ops issued, and
    raises on the first that differs.  Point-to-point runs as a ring at a
    world of two or more (toward itself a rank's send is the identity)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.nn import Linear
    n, r = D.get_world_size("dp"), D.get_rank("dp")
    errs = {}

    def t(vals):
        return torch.tensor(vals, dtype=torch.float32, device=device)

    def hold(name, got, want):
        got = [g.float().cpu() for g in got] if isinstance(got, list) \
            else got.float().cpu()
        want = [torch.as_tensor(w, dtype=torch.float32) for w in want] \
            if isinstance(got, list) else torch.as_tensor(
                want, dtype=torch.float32)
        pairs = zip(got, want) if isinstance(got, list) else [(got, want)]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        errs[name] = err
        if err > 1e-6:
            raise AssertionError("dist %s: got %r, want %r" % (name, got,
                                                               want))

    mine = [r + 1.0, 2.0 * (r + 1), 0.5]
    ranks = [[k + 1.0, 2.0 * (k + 1), 0.5] for k in range(n)]
    C.reset_counts()
    for op, fn in (("SUM", sum), ("MAX", max), ("MIN", min),
                   ("PROD", math.prod),
                   ("AVG", lambda v: sum(v) / len(v))):
        x = t(mine)
        if D.all_reduce(x, op=getattr(D.ReduceOp, op)) is not x:
            raise AssertionError("dist all_reduce: not in place")
        hold("all_reduce_" + op, x, [fn(c) for c in zip(*ranks)])
    hold("all_gather", D.all_gather(t(mine)), sum(ranks, []))
    parts = []
    D.all_gather(parts, t(mine))
    hold("all_gather_list", parts, ranks)
    src = t([float(k + 10 * r) for k in range(2 * n)])
    hold("reduce_scatter", D.reduce_scatter(src),
         [sum(float(k + 10 * q) for q in range(n))
          for k in range(2 * r, 2 * r + 2)])
    x = t(mine)
    D.broadcast(x, src=0)
    hold("broadcast", x, ranks[0])
    x = t(mine)
    D.reduce(x, dst=0)
    hold("reduce", x, [sum(c) for c in zip(*ranks)] if r == 0 else mine)
    x = t([0.0, 0.0])
    D.scatter(x, [t([10.0 * k, 1.0]) for k in range(n)], src=0)
    hold("scatter", x, [10.0 * r, 1.0])
    got = []
    D.alltoall([t([10.0 * r + j]) for j in range(n)], got)
    hold("alltoall", got, [[10.0 * j + r] for j in range(n)])
    hold("all_to_all", D.all_to_all(t([[10.0 * r + j] for j in range(n)])),
         [[10.0 * j + r] for j in range(n)])
    hold("all_to_all_single",
         D.all_to_all_single(t([10.0 * r + j for j in range(n)])),
         [10.0 * j + r for j in range(n)])
    objs = []
    D.all_gather_object(objs, {"rank": r})
    if objs != [{"rank": k} for k in range(n)]:
        raise AssertionError("dist all_gather_object: %r" % (objs,))
    x = t(mine)
    nxt, prv = (r + 1) % n, (r - 1) % n
    if r % 2 == 0:
        D.send(t(mine), dst=nxt)
        D.recv(x, src=prv)
    else:
        D.recv(x, src=prv)
        D.send(t(mine), dst=nxt)
    hold("send_recv", x, ranks[prv])
    x = t(mine)
    tasks = [D.isend(t(mine), dst=nxt), D.irecv(x, src=prv)]
    for task in tasks:
        task.wait()
    hold("isend_irecv", x, ranks[prv])
    D.barrier()
    D.wait(x)
    g = D.new_group(axis="dp")
    x = t(mine)
    D.all_reduce(x, group=g)
    hold("new_group", x, [sum(c) for c in zip(*ranks)])
    if D.get_group(g.id) is not g:
        raise AssertionError("dist get_group: not the new group")
    env = D.ParallelEnv()
    if (env.rank, env.world_size) != (D.get_rank(), D.get_world_size()):
        raise AssertionError("dist ParallelEnv: %r" % ((env.rank,
                                                        env.world_size),))
    lin = Linear(4, 2 * n).to(device)
    with torch.no_grad():
        lin.weight.copy_(torch.arange(8.0 * n, device=device).view(4, 2 * n))
        lin.bias.fill_(float(r))
    dp = D.DataParallel(lin)
    hold("data_parallel_broadcast", lin.bias, [0.0] * (2 * n))
    lin(t([[1.0, 1.0, 1.0, 1.0]]) * (r + 1)).sum().backward()
    dp.apply_collective_grads()
    hold("data_parallel_grads", lin.weight.grad[:, 0],
         [sum(k + 1.0 for k in range(n)) / n] * 4)
    w = torch.nn.Parameter(t([[float(k)] * 2 for k in range(2 * n)]))
    D.shard_tensor(w, placement=PartitionSpec("dp", None))
    hold("shard_tensor", w.detach(), [[2.0 * r + k] * 2 for k in range(2)])
    return errs, C.issued()


def dist_nccl(torch, backend="nccl", device=None):
    """``init_parallel_env()`` at a world of one, meeting on a free port
    of 127.0.0.1: the NCCL backend, the rank's card as the default device,
    and every collective once on that card (``collective_checks``), with
    the count of the ops issued; then ``scaled_dot_product_attention``
    through the one-rank ring (``ring_sep1``).  The world stays up for
    ``train_dp``."""
    import socket

    import torch.distributed as dist

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core.device import resolve_device
    t0 = time.perf_counter()
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(PADDLE_MASTER="127.0.0.1:%d" % port,
                          PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1")
    D.init_parallel_env(backend=backend, device=device)
    got = dist.get_backend()
    dev = resolve_device(device)
    errs, issued = collective_checks(torch, dev)
    line = {"phase": "dist_nccl", "backend": got,
            "world_size": D.get_world_size(), "rank": D.get_rank(),
            "device": str(dev), "max_abs_err": max(errs.values()),
            "checks": errs, "collectives_issued": issued,
            "collectives_issued_total": sum(issued.values()),
            "ring_sep1": ring_sep1(torch, dev),
            "seconds": time.perf_counter() - t0}
    emit(line)
    if got != backend:
        raise AssertionError("dist_nccl: backend %r, want %r" % (got,
                                                                 backend))
    if backend == "nccl" and dev != torch.device("cuda", 0):
        raise AssertionError("dist_nccl: default device %s" % dev)
    return line


def train_dp(torch, base, amp, counters, default_losses, train_line,
             steps=3, device="cuda"):
    """``steps`` steps of the train step with
    ``in_shardings=PartitionSpec("dp", None)`` over the world's dp group
    (one rank on the card): the gradients all-reduced in f32 (one op a
    step) and the loss averaged (one more), really issued, every loss
    equal to the default step's bit for bit (a one-rank all-reduce leaves
    the bits as they are); device ms a step beside train's.  Then the
    same steps with ``zero_stage=2``: its losses and launches are the
    default step's (at a world of one ``_stage_spec_for`` cuts nothing, as
    in JAX, and the ZeRO step issues what train_dp issues; on a mesh with
    an ``sdp`` axis of ranks that hold the same batch, the reduce-scatter
    averages equal values, which leaves them as they are)."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    step = make_step(train_model(torch, base, amp, device), device=device,
                     in_shardings=PartitionSpec("dp", None))
    group = step._dp_group
    if group is None:
        raise AssertionError("train_dp: no dp group to average over")
    ids = train_ids(torch, base.config.vocab_size, device)
    layers = base.config.num_hidden_layers
    C.reset_counts()
    losses, launches, ms = run_steps(torch, step, ids, counters, steps)
    issued = C.issued()
    line = {"phase": "train_dp", "backend": dist.get_backend(group.pg),
            "dp_ranks": group.nranks, "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "default_losses": default_losses[:steps],
            "launches": launches, "collectives_issued": issued,
            "grad_all_reduce_dtype": "float32",
            "profile": profile_steps(torch, step, ids),
            "train_step_device_ms": train_line["profile"]["step_device_ms"]}
    del step
    if device != "cpu":
        torch.cuda.empty_cache()
    zstep = make_step(train_model(torch, base, amp, device), device=device,
                      in_shardings=PartitionSpec("dp", None), zero_stage=2)
    C.reset_counts()
    zlosses, zlaunches, zms = run_steps(torch, zstep, ids, counters, steps)
    line["zero2"] = {"losses": zlosses, "launches": zlaunches,
                     "step_ms": zms, "collectives_issued": C.issued(),
                     "sliced_masters": sum(
                         d is not None for d in zstep._zero.dims.values()),
                     "slots_bytes": slots_bytes(zstep.opt_state)}
    del zstep
    if device != "cpu":
        torch.cuda.empty_cache()
    if issued.get("all_reduce", 0) != 2 * steps or len(issued) != 1:
        raise AssertionError("train_dp: issued %r, want 2 all_reduce a "
                             "step" % (issued,))
    hold_train_variant("train_dp", line,
                       {"flash_fwd_tc": layers * steps, "flash_fwd": 0,
                        "flash_bwd": 0, "flash_bwd_dq": layers * steps,
                        "flash_bwd_dkv": layers * steps})
    expect_launches(zlaunches, line["launches"], "train_dp zero_stage=2")
    if zlosses != default_losses[:steps]:
        raise AssertionError("train_dp: zero_stage=2 losses %r, not the "
                             "default step's bit for bit" % (zlosses,))
    return line


# tp2_gloo's greedy requests (64 tokens, 16 new), one slot each: 8 slots,
# so a decode step's rows meet B's gate (rows % 8) as serve's do
TP2_PROMPTS = 8
TP2_NEW_TOKENS = 16


def greedy_logits(engine, prompts, steps):
    """Prefill each prompt into its own slot, then ``steps`` greedy decode
    steps over all: each request's tokens and the f32 logits of every
    step (on the host)."""
    n = len(prompts)
    toks, logits = [], []
    for i, p in enumerate(prompts):
        tok, lg = engine.prefill(i, p, temperature=0.0)
        toks.append([int(tok)])
        logits.append([lg.float().cpu()])
    for _ in range(steps):
        nt, lg = engine.decode([t[-1] for t in toks], [True] * n, [0.0] * n,
                               [0] * n, [1.0] * n)
        for b in range(n):
            toks[b].append(int(nt[b]))
            logits[b].append(lg[b].float().cpu())
    return toks, logits


def tp2_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``tp2_gloo`` in a world of two that is up:
    ``spec`` = {"cfg", "seed", "prompts", "new_tokens", "amp",
    "default_losses", "steps"}.  Serving: ``DecodeEngine(tp=2)`` paged,
    greedy, under ``use_pallas_norm`` (B counted), and on rank 0 the tp=1
    engine on the same model, its tokens and its top-2 logit margins.
    Then ``DecodeEngine(tp=2, overlap_comm=True)`` (the ``mp_overlap``
    islands) on the same requests, per layer and scan-layers: its tokens,
    its first-step logits, and the ppermutes and ``mp.overlap_chunks`` a
    forward.  Training: the train step at dp1 x mp2 (``parallelize``, then
    ``in_shardings``) for ``steps`` steps, then one step of a fresh copy
    with the islands on.  Returns a dict of host values."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mp_overlap as mpo
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.utils import flags
    D.init_mesh({"dp": 1, "mp": 2})
    rank = D.get_rank()
    base = GPTForCausalLM(spec["cfg"],
                          generator=torch.Generator().manual_seed(
                              spec["seed"]))
    model = copy.deepcopy(base)
    if spec["amp"]:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    model.eval()
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out = {"rank": rank, "heads_per_rank": spec["cfg"].num_attention_heads
           // 2}
    flags.set_flags({"use_pallas_norm": True})
    try:
        eng = DecodeEngine(model, num_slots=len(prompts), max_len=256,
                           tp=2, device=device)
        counters.reset()
        t0 = time.perf_counter()
        toks, logits = greedy_logits(eng, prompts, spec["new_tokens"])
        out["serve_seconds"] = time.perf_counter() - t0
        out["serve_launches"] = counters.read()
        out["tokens"] = toks
        out["kv_row_bytes"] = eng.kv_row_bytes()
        out["uncaptured"] = eng.graph_stats()["uncaptured"]
        del eng
        if rank == 0:
            ref = DecodeEngine(model, num_slots=len(prompts), max_len=256,
                               device=device)
            ref_toks, ref_logits = greedy_logits(ref, prompts,
                                                 spec["new_tokens"])
            out["tp1_kv_row_bytes"] = ref.kv_row_bytes()
            del ref
            out["ref_tokens"] = ref_toks
            out["first_logit_err"] = max(
                float((a[0] - b[0]).abs().max())
                for a, b in zip(logits, ref_logits))
            parts = []
            for i, (a, b) in enumerate(zip(toks, ref_toks)):
                diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
                if diff.size:
                    j = int(diff[0])
                    top2 = torch.topk(ref_logits[i][j], 2).values
                    parts.append({"request": i, "step": j,
                                  "tokens": [a[j], b[j]],
                                  "tp1_top2_margin": float(top2[0]
                                                           - top2[1])})
            out["parted"] = parts
        registry.default_registry().enable()
        chunks = registry.counter("mp.overlap_chunks")
        forwards = len(prompts) + spec["new_tokens"]
        for name, scan in (("per_layer", False), ("scan", True)):
            src = scan_copy(base) if scan else model
            if scan and spec["amp"]:
                src = amp.decorate(src, level="O2", dtype="bfloat16")
            src.eval()
            eng = DecodeEngine(src, num_slots=len(prompts), max_len=256,
                               tp=2, device=device, overlap_comm=True)
            C.reset_counts()
            c0 = chunks.value
            counters.reset()
            t0 = time.perf_counter()
            o_toks, o_logits = greedy_logits(eng, prompts,
                                             spec["new_tokens"])
            issued = C.issued()
            out["overlap_" + name] = {
                "overlap_comm": eng.overlap_comm, "tokens": o_toks,
                "seconds": time.perf_counter() - t0,
                "launches": counters.read(),
                "first_logit_gap_vs_monolithic": max(
                    float((a[0] - b[0]).abs().max())
                    for a, b in zip(o_logits, logits)),
                "ppermute_per_forward": issued.get("ppermute", 0)
                / forwards,
                "overlap_chunks_per_forward": (chunks.value - c0)
                / forwards}
            del eng, src
    finally:
        flags.set_flags({"use_pallas_norm": False})
    del model
    ids = train_ids(torch, spec["cfg"].vocab_size, device)

    def parallel_step():
        tm = train_model(torch, base, amp, device) if spec["amp"] else \
            copy.deepcopy(base).to(device)
        D.parallelize(tm)
        return make_step(tm, device=device,
                         in_shardings=PartitionSpec("dp", None))
    step = parallel_step()
    losses, launches, ms = run_steps(torch, step, ids, counters,
                                     spec["steps"])
    out.update(train_losses=losses, train_launches=launches,
               train_step_host_ms=ms,
               masters=len(step.params),
               sharded_masters=len(step._mp_groups))
    del step
    step = parallel_step()
    del base
    C.reset_counts()
    c0 = chunks.value
    counters.reset()
    with mpo.overlap_scope(True):
        loss = float(step(ids, ids))
    issued = C.issued()
    out["overlap_train"] = {"loss": loss, "launches": counters.read(),
                            "ppermute": issued.get("ppermute", 0),
                            "overlap_chunks": chunks.value - c0}
    return out


def gloo_rank_main(rank, port, job, spec, results, ranks=2):
    """The entry point of a process of a multi-process phase: a gloo world
    of ``ranks`` on the one card, then the function ``job`` of this module
    (:func:`tp2_rank`, :func:`zero_rank`, :func:`serve_tp2_rank`,
    :func:`pp2_rank`, :func:`ring_rank`, :func:`moe_rank`,
    :func:`pp2_sdp2_rank`, :func:`sep_train_rank`); the result (or the
    traceback) goes to ``results``."""
    import datetime
    import traceback
    try:
        import torch
        import torch.distributed as dist

        from paddle_tpu_torch import distributed as D
        from paddle_tpu_torch.kernels import _build, ce_cuda, norm_cuda
        from paddle_tpu_torch.kernels import flash_attention_cuda as fac
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        _build.library()
        dist.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:%d" % port, rank=rank,
            world_size=ranks, timeout=datetime.timedelta(seconds=300))
        D.init_parallel_env(backend="gloo", device="cuda")
        out = globals()[job](torch, spec, Counters(fac, norm_cuda, ce_cuda))
        dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def tp2_hold(outs, spec, steps_forward):
    """tp2_gloo's checks over both ranks' results: the same tokens on
    both ranks; where they part from tp=1's, tp=1's top-2 margin there
    below 2 * LOGIT_TOL (both engines' first-step logits agree within
    LOGIT_TOL, so rounding can swap the top two only inside that
    margin); first-step logits within LOGIT_TOL; each rank's KV row half
    of tp=1's; B 2L + 1 a forward; every train loss within PARITY_LOSS_TOL of
    the default step's and equal on both ranks; the flash forward and the
    split backward 24 a step (at heads / 2 a rank).  Returns the line."""
    r0, r1 = outs
    layers = spec["cfg"].num_hidden_layers
    steps = spec["steps"]
    line = {"phase": "tp2_gloo", "backend": "gloo", "device": "cuda",
            "ranks": 2, "heads_per_rank": r0["heads_per_rank"],
            "tokens_equal_tp1": r0["parted"] == [],
            "parted": r0["parted"], "margin_limit": 2 * LOGIT_TOL,
            "first_logit_err": r0["first_logit_err"],
            "logit_tol": LOGIT_TOL,
            "kv_row_bytes": [r0["kv_row_bytes"], r0["tp1_kv_row_bytes"]],
            "serve_launches": r0["serve_launches"],
            "serve_seconds": r0["serve_seconds"],
            "losses": r0["train_losses"],
            "default_losses": spec["default_losses"][:steps],
            "loss_tol": PARITY_LOSS_TOL,
            "train_launches": r0["train_launches"],
            "train_step_host_ms_over_gloo": r0["train_step_host_ms"],
            "masters": r0["masters"],
            "sharded_masters": r0["sharded_masters"],
            "uncaptured": r0["uncaptured"],
            # the mp_overlap islands over gloo, which stages each permute
            # through the host: no time here is an overlap speed (that
            # needs two cards and NCCL)
            "overlap": {name: {k: v for k, v in r0["overlap_" + name].items()
                               if k != "tokens"}
                        for name in ("per_layer", "scan")},
            "overlap_tokens_equal_monolithic": {
                name: r0["overlap_" + name]["tokens"] == r0["tokens"]
                for name in ("per_layer", "scan")},
            "overlap_train": r0["overlap_train"],
            "overlap_train_loss_diff": abs(r0["overlap_train"]["loss"]
                                           - r0["train_losses"][0]),
            "overlap_speed": "not measured: gloo stages every permute "
                             "through the host (needs two cards and NCCL)"}
    line["max_loss_diff"] = max(abs(a - b) for a, b in zip(
        line["losses"], line["default_losses"]))
    emit(line)
    if r0["tokens"] != r1["tokens"]:
        raise AssertionError("tp2_gloo: the ranks sampled different tokens")
    wide = [p for p in r0["parted"]
            if p["tp1_top2_margin"] >= 2 * LOGIT_TOL]
    if wide:
        raise AssertionError("tp2_gloo: tokens part from tp=1's where its "
                             "top-2 margin is wide: %r" % (wide,))
    if not r0["first_logit_err"] <= LOGIT_TOL:
        raise AssertionError("tp2_gloo: first-step logits %g from tp=1's"
                             % r0["first_logit_err"])
    if 2 * r0["kv_row_bytes"] != r0["tp1_kv_row_bytes"]:
        raise AssertionError("tp2_gloo: KV row %r" % (line["kv_row_bytes"],))
    expect_launches(r0["serve_launches"],
                    {"layer_norm_fwd": (2 * layers + 1) * steps_forward,
                     "flash_fwd_tc": 0}, "tp2_gloo serve")
    if r0["train_losses"] != r1["train_losses"]:
        raise AssertionError("tp2_gloo: the ranks' losses differ")
    if not (all(math.isfinite(x) for x in line["losses"])
            and line["max_loss_diff"] <= PARITY_LOSS_TOL):
        raise AssertionError("tp2_gloo: losses %r, default %r"
                             % (line["losses"], line["default_losses"]))
    expect_launches(r0["train_launches"],
                    {"flash_fwd_tc": layers * steps,
                     "flash_bwd_dq": layers * steps,
                     "flash_bwd_dkv": layers * steps, "flash_bwd": 0},
                    "tp2_gloo train")
    for name in ("per_layer", "scan"):
        o0, o1 = r0["overlap_" + name], r1["overlap_" + name]
        if not (o0["overlap_comm"] and o0["tokens"] == r0["tokens"]
                and o1["tokens"] == r1["tokens"]):
            raise AssertionError("tp2_gloo: the overlapped %s engine's "
                                 "tokens differ from the monolithic tp=2 "
                                 "engine's" % name)
        if not o0["first_logit_gap_vs_monolithic"] <= LOGIT_TOL:
            raise AssertionError("tp2_gloo: overlapped %s first-step logits "
                                 "%g from the monolithic engine's"
                                 % (name, o0["first_logit_gap_vs_monolithic"]))
        if not (o0["ppermute_per_forward"] > 0
                and o0["overlap_chunks_per_forward"] > 0):
            raise AssertionError("tp2_gloo: the overlapped %s engine ran no "
                                 "island: %r" % (name, o0))
        expect_launches(o0["launches"],
                        {"layer_norm_fwd": (2 * layers + 1) * steps_forward,
                         "flash_fwd_tc": 0}, "tp2_gloo serve overlap")
    ot0, ot1 = r0["overlap_train"], r1["overlap_train"]
    if ot0["loss"] != ot1["loss"] or not math.isfinite(ot0["loss"]) \
            or line["overlap_train_loss_diff"] > PARITY_LOSS_TOL \
            or not ot0["ppermute"] > 0:
        raise AssertionError("tp2_gloo: overlapped train step %r against "
                             "the monolithic loss %r"
                             % ((ot0, ot1), r0["train_losses"][0]))
    expect_launches(ot0["launches"],
                    {"flash_fwd_tc": layers, "flash_bwd_dq": layers,
                     "flash_bwd_dkv": layers, "flash_bwd": 0},
                    "tp2_gloo train overlap")
    return line


def tp2_gloo(torch, cfg, default_losses, steps=3, timeout=600.0):
    """Two processes on the one card, a gloo world over CUDA tensors: GPT-2
    345M (``cfg``, the train weights' seed) in bf16, ``DecodeEngine(tp=2)``
    greedy on TP2_PROMPTS prompts against the tp=1 engine, then ``steps``
    train steps at dp1 x mp2 against the default step's losses, and the
    overlapped (``mp_overlap``) engines, per layer and scan-layers, and
    train step against the monolithic ones (:func:`tp2_hold`).  Gloo
    stages every collective through the host: the phase's times are not
    a tensor-parallel speed, nor an overlap speed."""
    rng = np.random.default_rng(17)
    spec = {"cfg": cfg, "seed": 0, "amp": True, "steps": steps,
            "new_tokens": TP2_NEW_TOKENS, "default_losses": default_losses,
            "prompts": [rng.integers(0, cfg.vocab_size, 64).tolist()
                        for _ in range(TP2_PROMPTS)]}
    t0 = time.perf_counter()
    outs = gloo_world("tp2_rank", spec, timeout)
    # a prefill chunk a prompt, then one decode step a new token
    line = tp2_hold(outs, spec, TP2_PROMPTS + TP2_NEW_TOKENS)
    line["seconds"] = time.perf_counter() - t0
    return line


#: processes started ahead of the multi-process phases, each with torch
#: imported, the card's context made and the kernel library loaded, each
#: waiting for the one job :func:`gloo_world` sends it: [(process, pipe)]
WARM = []
#: the queue every process of WARM reports its result to (one, made with
#: the first)
WARM_RESULTS = []
#: the most ranks a phase takes (pp2_sdp2_gloo's)
WARM_RANKS = 4


def gloo_warm_main(conn, results):
    """A process of :data:`WARM`: make ready what every rank needs, then
    run the job :func:`gloo_world` sends (``(rank, port, job, spec,
    ranks)`` for :func:`gloo_rank_main`; None: exit)."""
    import traceback
    failed = None
    try:
        import torch

        from paddle_tpu_torch import distributed  # noqa: F401
        from paddle_tpu_torch.kernels import _build
        torch.cuda.set_device(0)
        torch.cuda.init()
        _build.library()
    except BaseException:
        failed = traceback.format_exc()
    try:
        msg = conn.recv()
    except EOFError:            # the parent is gone
        return
    if msg is None:
        return
    rank, port, job, spec, ranks = msg
    if failed is not None:
        results.put((rank, "error", failed))
        return
    gloo_rank_main(rank, port, job, spec, results, ranks)


def warm_fill(n=WARM_RANKS):
    """Start processes until ``n`` wait in :data:`WARM`."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    if not WARM_RESULTS:
        WARM_RESULTS.append(ctx.Queue())
    while len(WARM) < n:
        here, there = ctx.Pipe()
        p = ctx.Process(target=gloo_warm_main, args=(there, WARM_RESULTS[0]))
        p.start()
        WARM.append((p, here))


def warm_stop():
    """Send every process still waiting in :data:`WARM` away; each is
    joined, or killed."""
    while WARM:
        p, conn = WARM.pop()
        try:
            conn.send(None)
        except OSError:
            pass
        p.join(60)
        if p.is_alive():
            p.kill()
            p.join(10)


def gloo_world(job, spec, timeout, ranks=2):
    """Run ``job`` (:func:`gloo_rank_main`) in ``ranks`` processes on the
    one card, a gloo world over CUDA tensors; the ranks' results in rank
    order, or AssertionError with a failed rank's traceback.  The ranks
    are taken from :data:`WARM`, which is then filled again, so that the
    next phase's processes get ready while this one runs.  Every process
    of the world is joined, or killed, before the call returns."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    warm_fill(ranks)
    taken, WARM[:ranks] = WARM[:ranks], []
    procs = [p for p, _ in taken]
    for rank, (_, conn) in enumerate(taken):
        conn.send((rank, port, job, spec, ranks))
    warm_fill()
    outs, errors = {}, []
    try:
        for _ in procs:
            rank, status, value = WARM_RESULTS[0].get(timeout=timeout)
            if status == "ok":
                outs[rank] = value
            else:
                errors.append("rank %d:\n%s" % (rank, value))
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
    if errors:
        raise AssertionError("%s failed:\n%s" % (job, "\n".join(errors)))
    for rank, p in enumerate(procs):
        outs[rank]["exitcode"] = p.exitcode
    return [outs[r] for r in range(ranks)]


def zero_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``zero_gloo`` in a world of two that is up, on
    the mesh {"sdp": 2}: for each ZeRO stage, ``spec["steps"]`` steps of
    the train step (``spec``: "cfg", "seed", "amp", "steps") with the
    batch sharded over ``sdp`` (4 of the 8 rows a rank) from a fresh copy
    of the weights: the losses, the launches, the collectives a step, the
    bytes of AdamW slots and of f32 masters the rank holds, and the
    peak of the allocator over the stage."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    D.init_mesh({"sdp": 2})
    base = GPTForCausalLM(spec["cfg"],
                          generator=torch.Generator().manual_seed(
                              spec["seed"]))
    ids = train_ids(torch, spec["cfg"].vocab_size, device)
    steps = spec["steps"]
    numel = sum(p.numel() for p in base.parameters())
    out = {"rank": D.get_rank(), "params": numel,
           # AdamW's two f32 moments of every parameter, unsharded
           "full_slots_bytes": 2 * 4 * numel, "stages": {}}
    for stage in (1, 2, 3):
        tm = train_model(torch, base, amp, device) if spec["amp"] else \
            copy.deepcopy(base).to(device)
        if device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        step = make_step(tm, device=device, zero_stage=stage,
                         in_shardings=PartitionSpec("sdp", None))
        C.reset_counts()
        losses, launches, ms = run_steps(torch, step, ids, counters, steps)
        issued = {k: v / steps for k, v in C.issued().items()}
        z = step._zero
        out["stages"][stage] = {
            "losses": losses, "launches": launches,
            "step_host_ms_over_gloo": ms, "collectives_per_step": issued,
            "sliced_masters": sum(d is not None for d in z.dims.values()),
            "masters": len(z.dims),
            "slots_bytes": slots_bytes(step.opt_state),
            "masters_bytes": int(sum(t.numel() * t.element_size()
                                     for t in step.params.values())),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device != "cpu" else None)}
        del step, tm
    return out


def slots_bytes(opt_state):
    """The bytes of the optimizer slot tensors a step holds."""
    return int(sum(v.numel() * v.element_size()
                   for slots in opt_state["slots"].values()
                   for v in slots.values() if hasattr(v, "element_size")))


def zero_hold(outs, spec, default_losses):
    """zero_gloo's checks over both ranks' results: at every stage the
    same losses on both ranks, each within PARITY_LOSS_TOL of the default
    step's (tp2_gloo's train tolerance: the batch's halves summed in
    another order); the slots a rank holds 45-55% of the unsharded
    ones; stage 2 and 3 reduce-scatter, stage 1 does not; stage 3's
    masters about half of stages 1-2's; the flash forward and the split
    backward once a layer a step.  Returns the line."""
    r0, r1 = outs
    layers = spec["cfg"].num_hidden_layers
    steps = spec["steps"]
    line = {"phase": "zero_gloo", "backend": "gloo", "device": "cuda",
            "mesh": {"sdp": 2}, "steps": steps, "params": r0["params"],
            "full_slots_bytes": r0["full_slots_bytes"],
            "default_losses": default_losses[:steps],
            "loss_tol": PARITY_LOSS_TOL, "stages": {}}
    for stage in (1, 2, 3):
        a, b = r0["stages"][stage], r1["stages"][stage]
        line["stages"][stage] = {
            "losses": a["losses"],
            "max_loss_diff": max(abs(x - y) for x, y in zip(
                a["losses"], default_losses)),
            "slots_bytes": [a["slots_bytes"], b["slots_bytes"]],
            "slots_share": [x["slots_bytes"] / r0["full_slots_bytes"]
                            for x in (a, b)],
            "masters_bytes": [a["masters_bytes"], b["masters_bytes"]],
            "max_memory_allocated": [a["max_memory_allocated"],
                                     b["max_memory_allocated"]],
            "sliced_masters": a["sliced_masters"], "masters": a["masters"],
            "collectives_per_step": a["collectives_per_step"],
            "step_host_ms_over_gloo": a["step_host_ms_over_gloo"],
            "launches": a["launches"]}
    emit(line)
    for stage, st in line["stages"].items():
        a, b = r0["stages"][stage], r1["stages"][stage]
        if a["losses"] != b["losses"]:
            raise AssertionError("zero_gloo: stage %d, the ranks' losses "
                                 "differ" % stage)
        if not (all(math.isfinite(x) for x in st["losses"])
                and st["max_loss_diff"] <= PARITY_LOSS_TOL):
            raise AssertionError("zero_gloo: stage %d losses %r, default %r"
                                 % (stage, st["losses"], default_losses))
        if not all(0.45 <= x <= 0.55 for x in st["slots_share"]):
            raise AssertionError("zero_gloo: stage %d slots %r of %d bytes"
                                 % (stage, st["slots_bytes"],
                                    r0["full_slots_bytes"]))
        rs = st["collectives_per_step"].get("reduce_scatter", 0)
        if (rs > 0) != (stage >= 2):
            raise AssertionError("zero_gloo: stage %d issued %r"
                                 % (stage, st["collectives_per_step"]))
        expect_launches(st["launches"],
                        {"flash_fwd_tc": layers * steps,
                         "flash_bwd_dq": layers * steps,
                         "flash_bwd_dkv": layers * steps, "flash_bwd": 0},
                        "zero_gloo stage %d" % stage)
    m3 = line["stages"][3]["masters_bytes"][0]
    m2 = line["stages"][2]["masters_bytes"][0]
    if not 0.45 <= m3 / m2 <= 0.55:
        raise AssertionError("zero_gloo: stage 3 masters %d bytes against "
                             "stage 2's %d" % (m3, m2))
    return line


def zero_gloo(torch, cfg, default_losses, steps=2, timeout=600.0):
    """Two processes on the one card, a gloo world over CUDA tensors on
    the mesh {"sdp": 2}: the train step (GPT-2 345M, ``cfg``, AMP O2,
    AdamW) at ZeRO stages 1, 2 and 3, ``steps`` steps each with the
    batch sharded over ``sdp``, against the default step's losses
    (:func:`zero_hold`).  Gloo stages every collective through the host:
    the phase's times are not a ZeRO speed."""
    spec = {"cfg": cfg, "seed": 0, "amp": True, "steps": steps}
    t0 = time.perf_counter()
    line = zero_hold(gloo_world("zero_rank", spec, timeout), spec,
                     default_losses)
    line["seconds"] = time.perf_counter() - t0
    return line


# serve_http_tp2's traffic: the greedy requests (64 tokens, 32 new), the
# load generator's plan (as many requests, the same shape), the cut request
# (its client leaves after HTTP_CUT_AT events) and the sampled one
SERVE_TP2 = {"requests": 8, "prompt_len": 64, "new_tokens": 32,
             "cut_new_tokens": 128, "qps": 8.0, "seed": 23,
             "temperature": 0.8, "top_k": 40}


def cut_stream(host, port, payload, after=None):
    """POST ``payload`` streamed and close the socket once ``after`` SSE
    events (HTTP_CUT_AT) arrived (a client that leaves mid-stream);
    returns the events seen."""
    import socket
    after = HTTP_CUT_AT if after is None else after
    body = json.dumps(dict(payload, stream=True)).encode()
    with socket.create_connection((host, port), timeout=HTTP_TIMEOUT) as s:
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        buf = b""
        while buf.count(b"data: ") < after:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf.count(b"data: ")


def finished_tokens(sched):
    """{rid: [tokens, finish reason]} of a scheduler's finished requests."""
    return {int(rid): [[int(t) for t in r.tokens], r.finish_reason]
            for rid, r in sched.finished.items()}


def top2_margin(torch, model, prompt, tokens, pos):
    """The top-2 gap of ``model``'s last-position logits over ``prompt``
    and the first ``pos`` generated tokens (a plain forward)."""
    ids = torch.as_tensor(np.concatenate([np.asarray(prompt),
                                          np.asarray(tokens[:pos])])[None]
                          .astype(np.int64),
                          device=next(model.parameters()).device)
    with torch.no_grad():
        top2 = torch.topk(model(ids)[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def serve_tp2_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``serve_http_tp2`` in a world of two that is up
    (``spec``: "cfg", "seed", "amp", "prompts", "cut", "sampled", and
    SERVE_TP2's fields): ``DecodeEngine(tp=2)`` under
    ``use_pallas_norm``; rank 0 serves the traffic through
    ``ServingFrontend`` and then the tp=1 engine over HTTP on the greedy
    requests, rank 1 runs ``serving.follow``.  Returns host values."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving import (DecodeEngine, ServingFrontend,
                                          follow, loadgen)
    from paddle_tpu_torch.utils import flags
    D.init_mesh({"dp": 1, "mp": 2})
    rank = D.get_rank()
    model = GPTForCausalLM(spec["cfg"], generator=torch.Generator()
                           .manual_seed(spec["seed"]))
    if spec["amp"]:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    model.eval()
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    new = spec["new_tokens"]
    out = {"rank": rank}
    flags.set_flags({"use_pallas_norm": True})
    try:
        eng = DecodeEngine(model, num_slots=len(prompts), max_len=256,
                           tp=2, device=device)
        counters.reset()
        t0 = time.perf_counter()
        if rank != 0:
            sched = follow(eng)
            out.update(finished=finished_tokens(sched),
                       forwards=sched.prefill_chunks_total
                       + sched.decode_steps_total,
                       launches=counters.read(), overlap=sched.overlap,
                       seconds=time.perf_counter() - t0)
            return out
        fe = ServingFrontend(eng, queue_limit=64)
        fe.start()
        try:
            replies = post_all(fe.host, fe.port,
                               greedy_payloads(prompts, new))
            out["cut_events"] = cut_stream(fe.host, fe.port, {
                "prompt": spec["cut"], "max_new_tokens":
                spec["cut_new_tokens"], "temperature": 0.0})
            _st, events = http_request(fe.host, fe.port, "POST",
                                       "/v1/generate", {
                "prompt": spec["sampled"], "max_new_tokens": new,
                "temperature": spec["temperature"], "top_k": spec["top_k"],
                "stream": True})
            out["sampled"] = done_event(events)
            out["load"] = loadgen.run_load_sync(
                fe.host, fe.port, spec["qps"], len(prompts),
                mix=((spec["prompt_len"],) * 2, (new, new)),
                vocab=spec["cfg"].vocab_size, temperature=0.0,
                seed=spec["seed"])
        finally:
            fe.stop()
        sched = fe.scheduler
        out.update(tokens=[done_event(ev)["tokens"] for _st, ev in replies],
                   finished=finished_tokens(sched),
                   forwards=sched.prefill_chunks_total
                   + sched.decode_steps_total,
                   launches=counters.read(), records=fe._lockstep.records,
                   uncaptured=eng.graph_stats()["uncaptured"],
                   captures=eng.graph_stats()["captures"],
                   seconds=time.perf_counter() - t0)
        del eng, fe
        ref = DecodeEngine(model, num_slots=len(prompts), max_len=256,
                           device=device)
        fe = ServingFrontend(ref)
        fe.start()
        try:
            replies = post_all(fe.host, fe.port,
                               greedy_payloads(prompts, new))
        finally:
            fe.stop()
        out["tp1_tokens"] = [done_event(ev)["tokens"] for _st, ev in replies]
        del ref, fe
        out["parted"] = []
        for i, (a, b) in enumerate(zip(out["tokens"], out["tp1_tokens"])):
            diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
            if diff.size:
                j = int(diff[0])
                out["parted"].append({
                    "request": i, "step": j, "tokens": [a[j], b[j]],
                    "tp1_top2_margin": top2_margin(torch, model, prompts[i],
                                                   b, j)})
    finally:
        flags.set_flags({"use_pallas_norm": False})
    return out


def serve_tp2_hold(outs, spec):
    """serve_http_tp2's checks over both ranks' results (the module
    docstring, 11h).  Returns the line."""
    r0, r1 = outs
    layers = spec["cfg"].num_hidden_layers
    load = r0["load"]
    cut = [rid for rid, (_t, why) in r0["finished"].items()
           if why == "cancelled"]
    line = {"phase": "serve_http_tp2", "backend": "gloo", "device": "cuda",
            "ranks": 2, "requests": len(r0["finished"]),
            "tokens_equal_tp1": r0["parted"] == [], "parted": r0["parted"],
            "margin_limit": 2 * LOGIT_TOL,
            "follower_same_results": r1["finished"] == r0["finished"],
            "sampled_tokens": len(r0["sampled"]["tokens"]),
            "cut_events_seen": r0["cut_events"], "cancelled_rids": cut,
            "lockstep_records": r0["records"],
            "forwards": [r0["forwards"], r1["forwards"]],
            "launches": [r0["launches"], r1["launches"]],
            "follower_exitcode": r1.get("exitcode"),
            "follower_loop_overlapped": r1["overlap"],
            "uncaptured": r0["uncaptured"], "captures": r0["captures"],
            "seconds_rank0": r0["seconds"],
            "load": load,
            "client_ttft_p50_ms": load["ttft_p50_ms"],
            "client_ttft_p99_ms": load["ttft_p99_ms"],
            "client_tpot_p50_ms": load["tpot_p50_ms"],
            "client_tpot_p99_ms": load["tpot_p99_ms"],
            "speed": "not a tensor-parallel speed: gloo stages every "
                     "collective of the tp=2 step through the host"}
    emit(line)
    wide = [p for p in r0["parted"]
            if p["tp1_top2_margin"] >= 2 * LOGIT_TOL]
    if wide:
        raise AssertionError("serve_http_tp2: tokens part from tp=1's where "
                             "its top-2 margin is wide: %r" % (wide,))
    if r1["finished"] != r0["finished"]:
        raise AssertionError("serve_http_tp2: the follower's results differ "
                             "from rank 0's")
    if r0["finished"][r0["sampled"]["rid"]] != [r0["sampled"]["tokens"],
                                                "length"]:
        raise AssertionError("serve_http_tp2: sampled request %r"
                             % (r0["sampled"],))
    if len(cut) != 1 or r0["finished"][cut[0]][1] != "cancelled":
        raise AssertionError("serve_http_tp2: cut request %r" % (cut,))
    if load["completed"] != spec["requests"] or load["errors"] \
            or load["shed"]:
        raise AssertionError("serve_http_tp2: load %r" % (load,))
    if r1.get("exitcode") != 0:
        raise AssertionError("serve_http_tp2: the follower exited %r"
                             % (r1.get("exitcode"),))
    if r0["captures"] != 0 or r0["forwards"] != r1["forwards"]:
        raise AssertionError("serve_http_tp2: captures %r, forwards %r"
                             % (r0["captures"], line["forwards"]))
    for r in (r0, r1):
        expect_launches(r["launches"],
                        {"layer_norm_fwd": (2 * layers + 1) * r["forwards"]},
                        "serve_http_tp2 rank %d" % r["rank"])
    return line


def serve_http_tp2(torch, cfg, timeout=600.0):
    """Two processes on the one card, a gloo world over CUDA tensors: the
    HTTP front end over ``DecodeEngine(tp=2)`` (GPT-2 345M bf16, the
    serve weights' seed), rank 1 following (:func:`serve_tp2_hold`)."""
    rng = np.random.default_rng(29)
    spec = dict(SERVE_TP2, cfg=cfg, seed=0, amp=True,
                prompts=[rng.integers(0, cfg.vocab_size,
                                      SERVE_TP2["prompt_len"]).tolist()
                         for _ in range(SERVE_TP2["requests"])],
                cut=rng.integers(0, cfg.vocab_size, 64).tolist(),
                sampled=rng.integers(0, cfg.vocab_size, 64).tolist())
    t0 = time.perf_counter()
    line = serve_tp2_hold(gloo_world("serve_tp2_rank", spec, timeout), spec)
    line["seconds"] = time.perf_counter() - t0
    return line


# pp_single / pp2_gloo: 4 microbatches of 2 x 1024 tokens a step, 3 steps
PP_ACC, PP_STEPS = 4, 3
# the trained parameters of pp2_gloo against pp_single's: AdamW moves an
# element about lr a step whatever its gradient, so a gradient that rounds
# otherwise (the 1F1B step sums microbatch grads in f32, the plain loop in
# the parameters' bf16) can move it by 2 lr a step: 3 steps x 2e-4, plus
# a bf16 ulp of |w| <= 0.125 (4.9e-4)
PP_PARAM_TOL = 1.1e-3


def gpt_pipeline_descs(cfg):
    """GPT (``cfg``) as pipeline descs: a ``SharedLayerDesc`` embedding
    (wte + wpe), the port's ``GPTBlock``s, and the head (the final
    LayerNorm, then logits against the tied wte)."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.pipeline import (LayerDesc,
                                                       SharedLayerDesc)
    from paddle_tpu_torch.models.gpt import GPTBlock

    class GPTEmbedPipe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                    cfg.hidden_size)

        @property
        def weight(self):
            return self.wte.weight

        @weight.setter
        def weight(self, value):
            self.wte.weight = value

        def forward(self, ids):
            pos = torch.arange(ids.shape[1], device=ids.device)[None]
            return self.wte(ids) + self.wpe(pos)

    class GPTHeadPipe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ln_f = nn.LayerNorm(cfg.hidden_size,
                                     cfg.layer_norm_epsilon)
            # replaced by the embedding's wte (the tie)
            self.weight = torch.nn.Parameter(torch.empty(0))

        def forward(self, x):
            return self.ln_f(x) @ self.weight.t()

    return [SharedLayerDesc("wte", GPTEmbedPipe),
            *[LayerDesc(GPTBlock, cfg)
              for _ in range(cfg.num_hidden_layers)],
            SharedLayerDesc("wte", GPTHeadPipe)]


def gpt_pipeline(torch, base, num_stages, device="cuda", dtype="bfloat16"):
    """A ``PipelineLayer`` of :func:`gpt_pipeline_descs` holding ``base``'s
    weights (``GPTForCausalLM``), AMP O2 in ``dtype``, on ``device``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.pipeline import PipelineLayer
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    cfg = base.config
    pl = PipelineLayer(gpt_pipeline_descs(cfg), num_stages=num_stages,
                       loss_fn=GPTPretrainingCriterion())
    sd = base.state_dict()
    layers = pl.run_function
    with torch.no_grad():
        layers[0].wte.weight.copy_(sd["gpt.wte.weight"])
        layers[0].wpe.weight.copy_(sd["gpt.wpe.weight"])
        layers[-1].shared.ln_f.weight.copy_(sd["gpt.ln_f.weight"])
        layers[-1].shared.ln_f.bias.copy_(sd["gpt.ln_f.bias"])
        for i in range(cfg.num_hidden_layers):
            pre = "gpt.h.%d." % i
            layers[1 + i].load_state_dict(
                {k[len(pre):]: v for k, v in sd.items()
                 if k.startswith(pre)})
    return amp.decorate(pl, level="O2", dtype=dtype).to(device)


def param_sample(t, n=1 << 16):
    """A parameter's evenly spaced sample of ``n`` elements (all of a
    smaller one) as f32 on the host, and the f64 sum of all of it."""
    import torch
    flat = t.detach().reshape(-1).float()
    k = min(n, flat.numel())
    # integer spacing: an f32 linspace rounds past the end of a large one
    idx = (torch.arange(k, device=flat.device, dtype=torch.int64)
           * (flat.numel() - 1)) // max(k - 1, 1)
    return flat[idx].cpu().numpy(), float(flat.double().sum())


def pp_snapshot(pl):
    """The tied wte and one block of each of two stages (block 0 and
    block L / 2), sampled (:func:`param_sample`)."""
    layers = pl.run_function
    half = (len(layers) - 2) // 2
    out = {"wte": param_sample(layers[0].wte.weight)}
    for i in (1, 1 + half):
        for k, v in layers[i].state_dict().items():
            out["block%d.%s" % (i - 1, k)] = param_sample(v)
    return out


def pp_launches_due(layers_on_stage, head, steps, device="cuda"):
    """The flash forward, C2 / C3, B and D a stage launches in ``steps``
    steps of PP_ACC microbatches (the head's final LayerNorm on the last
    stage); D on a card only (on the CPU the plain LayerNorm's backward
    is autograd's, which no wrapper counts)."""
    per_mb = {"flash_fwd_tc": layers_on_stage,
              "flash_bwd_dq": layers_on_stage,
              "flash_bwd_dkv": layers_on_stage, "flash_bwd": 0,
              "flash_fwd": 0,
              "layer_norm_fwd": 2 * layers_on_stage + int(head)}
    if device != "cpu":
        per_mb["layer_norm_bwd"] = per_mb["layer_norm_fwd"]
    return {k: v * PP_ACC * steps for k, v in per_mb.items()}


def pp_single(torch, base, counters, flags, steps=PP_STEPS, device="cuda"):
    """GPT-2 345M as a ``PipelineLayer`` on one rank (no pp axis; the
    module docstring, 11i): ``train_batch``'s losses against a plain loop
    over the same layers with the same microbatching.  Returns the line
    (with the trained snapshot, for pp2_gloo)."""
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.optimizer import AdamW
    layers = base.config.num_hidden_layers
    ids = train_ids(torch, base.config.vocab_size, device)
    mb = ids.shape[0] // PP_ACC
    flags.set_flags({"use_pallas_norm": True})
    try:
        ref = gpt_pipeline(torch, base, 1, device)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=ref.parameters())
        plain = []
        for _ in range(steps):
            total = None
            for i in range(PP_ACC):
                xi = ids[i * mb:(i + 1) * mb]
                loss = ref.loss_fn(ref(xi), xi)
                (loss / PP_ACC).backward()
                total = loss.detach() if total is None \
                    else total + loss.detach()
            opt.step()
            opt.clear_grad()
            plain.append(float(total / PP_ACC))
        del ref, opt
        if device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        pl = gpt_pipeline(torch, base, 1, device)
        model = PipelineParallel(pl)
        model.accumulate_steps = PP_ACC
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters())
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        losses = [float(model.train_batch((ids, ids), opt))
                  for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        snapshot = pp_snapshot(pl)
        peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                else None)
        prof = (profile_steps(torch, lambda a, b: model.train_batch(
            (a, b), opt), ids, n=1) if device != "cpu"
            else {"step_device_ms": None})
    finally:
        flags.set_flags({"use_pallas_norm": False})
    line = {"phase": "pp_single", "shape": [8, 1024],
            "microbatches": PP_ACC, "steps": steps, "losses": losses,
            "plain_losses": plain,
            "max_loss_diff": max(abs(a - b) for a, b in zip(losses, plain)),
            "step_ms": wall * 1e3 / steps,
            "step_device_ms": prof["step_device_ms"],
            "device_busy_share": prof.get("device_busy_share"),
            "peak_memory_gb": None if peak is None else peak / 1e9,
            "launches": launches}
    emit(line)
    expect_launches(launches, pp_launches_due(layers, True, steps, device),
                    "pp_single")
    if not (all(math.isfinite(x) for x in losses)
            and line["max_loss_diff"] <= 1e-5 and losses[-1] < losses[0]):
        raise AssertionError("pp_single: losses %r, plain loop %r"
                             % (losses, plain))
    line["snapshot"] = snapshot
    return line


def pp2_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``pp2_gloo`` in a world of two that is up
    (``spec``: "cfg", "seed", "steps"): the pp=2 fleet run of
    pp_single's model, data and optimizer, then the fp16 overflow step.
    Returns host values."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import flags
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": PP_ACC}
    fleet.init(is_collective=True, strategy=strategy)
    base = GPTForCausalLM(spec["cfg"], generator=torch.Generator()
                          .manual_seed(spec["seed"]))
    ids = train_ids(torch, spec["cfg"].vocab_size, device)
    steps = spec["steps"]
    flags.set_flags({"use_pallas_norm": True})
    try:
        pl = gpt_pipeline(torch, base, 2, device)
        model = fleet.distributed_model(pl)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters())
        if device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        C.reset_counts()
        counters.reset()
        t0 = time.perf_counter()
        losses = [float(model.train_batch((ids, ids), opt))
                  for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        issued = C.issued()
        comp = model._compiled
        out = {"rank": D.get_rank(), "stage": comp._stage,
               "losses": losses, "launches": launches,
               "step_host_ms_over_gloo": wall * 1e3 / steps,
               "permutes_per_step": issued.get("ppermute", 0) / steps,
               "step_permutes": comp.last_permutes,
               "peak_inflight": comp.last_peak_inflight,
               "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                        if device != "cpu" else None)}
        model.sync_to_layers()
        out["snapshot"] = pp_snapshot(pl)
        del model, pl, opt, comp
        # fp16 under a GradScaler whose scale overflows the cotangents
        pl = gpt_pipeline(torch, base, 2, device, "float16")
        model = fleet.distributed_model(pl)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 40,
                                decr_every_n_nan_or_inf=1)
        before = {k: p.detach().clone() for k, p in pl.named_parameters()}
        model.train_batch((ids, ids), opt, scaler=scaler)
        out["fp16"] = {
            "skipped": scaler.last_step_skipped,
            "unchanged": all(torch.equal(before[k], p)
                             for k, p in pl.named_parameters()),
            "scale_after": scaler.get_loss_scaling()}
    finally:
        flags.set_flags({"use_pallas_norm": False})
    return out


def pp2_hold(outs, spec, single):
    """pp2_gloo's checks over both ranks' results against pp_single's line
    (the module docstring, 11j).  Returns the line."""
    r0, r1 = outs
    layers = spec["cfg"].num_hidden_layers
    steps = spec["steps"]
    n = 2
    gaps = {k: float(np.abs(r0["snapshot"][k][0] - v[0]).max())
            for k, v in single["snapshot"].items()}
    worst = max(gaps, key=gaps.get)
    line = {"phase": "pp2_gloo", "backend": "gloo", "device": "cuda",
            "ranks": 2, "mesh": {"pp": 2}, "blocks_per_stage": layers // n,
            "microbatches": PP_ACC, "steps": steps,
            "losses": r0["losses"], "single_losses": single["losses"],
            "max_loss_diff": max(abs(a - b) for a, b in zip(
                r0["losses"], single["losses"])),
            "loss_tol": PARITY_LOSS_TOL,
            "param_max_diff": gaps[worst], "param_worst": worst,
            "param_tol": PP_PARAM_TOL,
            "ranks_same_params": all(
                np.array_equal(r0["snapshot"][k][0], r1["snapshot"][k][0])
                for k in r0["snapshot"]),
            "permutes_per_step": [r0["permutes_per_step"],
                                  r1["permutes_per_step"]],
            "permutes_due": 2 * (PP_ACC + 2 * (n - 1)),
            "peak_inflight": [r0["peak_inflight"], r1["peak_inflight"]],
            "peak_inflight_bound": [min(PP_ACC, 2 * (n - 1 - s) + 1)
                                    for s in range(n)],
            "max_memory_allocated": [r0["max_memory_allocated"],
                                     r1["max_memory_allocated"]],
            "launches": [r0["launches"], r1["launches"]],
            "step_host_ms_over_gloo": [r0["step_host_ms_over_gloo"],
                                       r1["step_host_ms_over_gloo"]],
            "fp16_overflow": [r0["fp16"], r1["fp16"]],
            "speed": "not a pipeline speed: gloo stages every permute "
                     "through the host, and both stages share one card"}
    emit(line)
    if [r0["stage"], r1["stage"]] != [0, 1]:
        raise AssertionError("pp2_gloo: stages %r" % ([r0["stage"],
                                                      r1["stage"]],))
    if r0["losses"] != r1["losses"] or not (
            all(math.isfinite(x) for x in r0["losses"])
            and line["max_loss_diff"] <= PARITY_LOSS_TOL):
        raise AssertionError("pp2_gloo: losses %r / %r, pp_single %r"
                             % (r0["losses"], r1["losses"],
                                single["losses"]))
    if not (line["ranks_same_params"] and gaps[worst] <= PP_PARAM_TOL):
        raise AssertionError("pp2_gloo: trained parameters %s %g from "
                             "pp_single's (same on both ranks: %r)"
                             % (worst, gaps[worst],
                                line["ranks_same_params"]))
    for r in (r0, r1):
        if r["permutes_per_step"] != line["permutes_due"] \
                or r["step_permutes"] != line["permutes_due"]:
            raise AssertionError("pp2_gloo: %r permutes a step, due %d"
                                 % (line["permutes_per_step"],
                                    line["permutes_due"]))
        if r["peak_inflight"] != line["peak_inflight_bound"][r["stage"]]:
            raise AssertionError("pp2_gloo: in flight %r, bound %r"
                                 % (line["peak_inflight"],
                                    line["peak_inflight_bound"]))
        expect_launches(r["launches"],
                        pp_launches_due(layers // n, r["stage"] == n - 1,
                                        steps, spec.get("device", "cuda")),
                        "pp2_gloo stage %d" % r["stage"])
        f = r["fp16"]
        if not (f["skipped"] and f["unchanged"]
                and f["scale_after"] == 2.0 ** 39):
            raise AssertionError("pp2_gloo: fp16 overflow step %r"
                                 % (line["fp16_overflow"],))
    return line


def pp2_gloo(torch, cfg, single, timeout=900.0):
    """Two processes on the one card, a gloo world over CUDA tensors: the
    1F1B pipeline at pp=2 through the fleet, held to ``single``
    (pp_single's line; :func:`pp2_hold`)."""
    spec = {"cfg": cfg, "seed": 0, "steps": single["steps"]}
    t0 = time.perf_counter()
    line = pp2_hold(gloo_world("pp2_rank", spec, timeout), spec, single)
    line["seconds"] = time.perf_counter() - t0
    return line


# pp2_sdp2_gloo: ZeRO over 'sdp' inside the 1F1B pipeline against the same
# program on {"pp": 2, "dp": 2}, which deals each data index the same rows:
# identical math without ZeRO (a sum of two grads either way, the update
# elementwise on slices), so the losses agree to f32 rounding
PP_SDP_LOSS_REL = 1e-5
# a rank's optimizer-slot bytes over the dp run's: each slot cut in two
# but the few a rank keeps whole (under 4096 elements on the stacked
# (stages, blocks, ...) shape: none at 345M's widths)
PP_SDP_SLOT_SHARE = (0.45, 0.55)
PP_SDP_STEPS = 2


def pp2_sdp2_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``pp2_sdp2_gloo`` in a world of four that is up
    (``spec``: "cfg", "seed", "steps", "stages"): the fleet's 1F1B run of
    pp_single's model, data and optimizer under ``use_pallas_norm``, from
    the same weights, first on {"pp": 2, "dp": 2}, then on {"pp": 2,
    "sdp": 2} at each ZeRO stage of ``spec["stages"]``
    (``sharding_configs.stage``).  For each run: the losses, the rank's
    optimizer-slot bytes, the gradient elements the optimizer took at the
    first step, the collectives a step, the launches, peak allocation.
    Returns host values."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import flags
    cfg, steps = spec["cfg"], spec["steps"]
    base = GPTForCausalLM(cfg, generator=torch.Generator()
                          .manual_seed(spec["seed"]))
    ids = train_ids(torch, cfg.vocab_size, device)
    runs = [("dp", {"pp_degree": 2, "dp_degree": 2}, 1)] + [
        ("sdp_stage%d" % st, {"pp_degree": 2, "sharding_degree": 2}, st)
        for st in spec["stages"]]
    out = {}
    flags.set_flags({"use_pallas_norm": True})
    try:
        for name, hybrid, stage in runs:
            strategy = fleet.DistributedStrategy()
            strategy.hybrid_configs = hybrid
            strategy.pipeline_configs = {"accumulate_steps": PP_ACC}
            strategy.sharding_configs = {"stage": stage}
            fleet.init(is_collective=True, strategy=strategy)
            pl = gpt_pipeline(torch, base, 2, device)
            model = fleet.distributed_model(pl)
            opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                        parameters=model.parameters())
            seen = []
            apply = opt.apply_gradients

            def keep(params, grads, *a, **kw):
                if not seen:
                    seen.append(sum(g.numel() for g in grads.values()))
                return apply(params, grads, *a, **kw)
            opt.apply_gradients = keep
            if device != "cpu":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            C.reset_counts()
            counters.reset()
            t0 = time.perf_counter()
            losses = [float(model.train_batch((ids, ids), opt))
                      for _ in range(steps)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            comp = model._compiled
            out[name] = {
                "stage": comp._stage, "zero_stage": stage,
                "losses": losses, "launches": counters.read(),
                "slot_bytes": slots_bytes(comp.opt_state),
                "first_grad_elements": seen[0],
                "collectives_per_step": {k: v / steps for k, v in
                                         C.issued().items()},
                "step_host_ms_over_gloo": wall * 1e3 / steps,
                "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                         if device != "cpu" else None)}
            del model, pl, opt, comp
    finally:
        flags.set_flags({"use_pallas_norm": False})
    return out


def pp2_sdp2_hold(outs, spec):
    """pp2_sdp2_gloo's checks over the four ranks' results: every rank's
    losses of each ZeRO run within PP_SDP_LOSS_REL (relative) of the dp
    run's; a rank's slot bytes within PP_SDP_SLOT_SHARE of the dp run's;
    stage 2 reduce-scattering its grads (slices reach the optimizer) and
    stage 1 not; each stage's launches (pp_launches_due).  Returns the
    line."""
    layers = spec["cfg"].num_hidden_layers
    steps = spec["steps"]
    runs = ["sdp_stage%d" % st for st in spec["stages"]]
    line = {"phase": "pp2_sdp2_gloo", "backend": "gloo", "device": "cuda",
            "ranks": 4, "mesh": {"pp": 2, "sdp": 2},
            "reference_mesh": {"pp": 2, "dp": 2},
            "layers": layers, "blocks_per_stage": layers // 2,
            "microbatches": PP_ACC, "steps": steps,
            "dp_losses": [o["dp"]["losses"] for o in outs],
            "dp_step_host_ms_over_gloo": [o["dp"]["step_host_ms_over_gloo"]
                                          for o in outs],
            "dp_max_memory_allocated": [o["dp"]["max_memory_allocated"]
                                        for o in outs],
            "loss_rel_tol": PP_SDP_LOSS_REL,
            "slot_share_bounds": list(PP_SDP_SLOT_SHARE),
            "speed": "not a ZeRO or pipeline speed: gloo stages every "
                     "collective through the host, and four ranks share "
                     "one card"}
    bad = []
    for name in runs:
        run = [o[name] for o in outs]
        rel = max(abs(a - b) / abs(b) for o, r in zip(outs, run)
                  for a, b in zip(r["losses"], o["dp"]["losses"]))
        share = [r["slot_bytes"] / o["dp"]["slot_bytes"]
                 for o, r in zip(outs, run)]
        rs = [r["collectives_per_step"].get("reduce_scatter", 0)
              for r in run]
        line[name] = {
            "losses": [r["losses"] for r in run], "max_loss_rel": rel,
            "slot_bytes": [r["slot_bytes"] for r in run],
            "dp_slot_bytes": [o["dp"]["slot_bytes"] for o in outs],
            "slot_share": share,
            "first_grad_elements": [r["first_grad_elements"] for r in run],
            "dp_first_grad_elements": [o["dp"]["first_grad_elements"]
                                       for o in outs],
            "collectives_per_step": [r["collectives_per_step"]
                                     for r in run],
            "step_host_ms_over_gloo": [r["step_host_ms_over_gloo"]
                                       for r in run],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in run],
            "launches": [r["launches"] for r in run]}
        if not (all(math.isfinite(x) for r in run for x in r["losses"])
                and rel <= PP_SDP_LOSS_REL):
            bad.append("%s: losses %r against the dp run's %r"
                       % (name, line[name]["losses"], line["dp_losses"]))
        if not all(PP_SDP_SLOT_SHARE[0] <= x <= PP_SDP_SLOT_SHARE[1]
                   for x in share):
            bad.append("%s: slot bytes %r of the dp run's" % (name, share))
        stage = run[0]["zero_stage"]
        if any((x > 0) != (stage >= 2) for x in rs):
            bad.append("%s: reduce-scatters a step %r at stage %d"
                       % (name, rs, stage))
        for r in run:
            try:
                expect_launches(r["launches"], pp_launches_due(
                    layers // 2, r["stage"] == 1, steps,
                    spec.get("device", "cuda")),
                    "pp2_sdp2_gloo %s stage %d" % (name, r["stage"]))
            except AssertionError as e:
                bad.append(str(e))
    emit(line)
    if bad:
        raise AssertionError("pp2_sdp2_gloo: " + "; ".join(bad))
    return line


def pp2_sdp2_gloo(torch, cfg, timeout=900.0):
    """Four processes on the one card, a gloo world over CUDA tensors: the
    1F1B pipeline at pp=2 with ZeRO stages 1 and 2 over sdp=2 against
    the same program on {"pp": 2, "dp": 2} (:func:`pp2_sdp2_hold`)."""
    spec = {"cfg": cfg, "seed": 0, "steps": PP_SDP_STEPS, "stages": (1, 2)}
    t0 = time.perf_counter()
    line = pp2_sdp2_hold(gloo_world("pp2_sdp2_rank", spec, timeout,
                                    ranks=4), spec)
    line["seconds"] = time.perf_counter() - t0
    return line


# ring_gloo: GPT-2 345M's attention width (16 heads of 64), bf16, causal,
# the global sequence train_long trains (16384 rows), 8192 rows a rank
RING_SHAPE = (1, 16384, 16, 64)
# dist_nccl's one-rank ring (the sep group of a world of one)
RING_SEP1_SHAPE = (1, 2048, 16, 64)
# the CPU's shapes for the same checks (plain versions, narrow)
RING_CPU_SHAPE = (1, 256, 2, 64)


def ring_inputs(torch, shape, seed, device, dtype):
    """q, k, v and the output's cotangent, (B, S, H, D), from ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(4)]


def flash_reference(torch, fa, q, k, v, do):
    """One flash call over the whole sequence, causal: out and (dq, dk,
    dv) for ``do``."""
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_bshd(*ts, causal=True)
    return out.detach(), torch.autograd.grad(out, ts, do)


def traced_calls(torch, fn, n, sums=()):
    """One untraced call of ``fn``, then exactly ``n`` in a profiler
    trace (every rank of a collective makes the same calls): the host ms
    and device ms a call, and for each pattern of ``sums`` the device ms a
    call of the kernels whose names hold it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = [(e.key, float(getattr(e, "self_device_time_total", 0.0)
                            or 0.0)) for e in prof.key_averages()]
    out = {"step_host_ms": wall,
           "step_device_ms": sum(t for _k, t in events) / n / 1e3}
    for pat in sums:
        out[pat + "_device_ms"] = sum(t for k, t in events
                                      if pat in k) / n / 1e3
    return out


def ring_sep1(torch, device):
    """At the dist_nccl world: the mesh {"dp": world, "sep": 1} binds a
    one-rank ``sep`` group, so ``scaled_dot_product_attention`` routes
    through ``ring_attention``; its output and (dq, dk, dv) against
    ``flash_attention_bshd`` on the same inputs, which they equal value for
    value where the ring's inner is the flash kernel (a one-step ring's
    combine multiplies by exactly 1 and 0), else within the flash rule
    (in f32 on the CPU, where the inner is the blockwise one).
    The ring's backward permutes its dK/dV accumulators once (to itself):
    the ppermute counted is the proof that the ring ran."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed import ring_attention as R
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    # the CPU (a rehearsal) takes the blockwise inner, which rounds
    # otherwise than the flash kernels' plain versions: f32 there
    card = device.type == "cuda"
    shape = RING_SEP1_SHAPE if card else RING_CPU_SHAPE
    dtype = torch.bfloat16 if card else torch.float32
    name = dtype_name(dtype)
    q, k, v, do = ring_inputs(torch, shape, 5, device, dtype)
    ref, ref_g = flash_reference(torch, fa, q, k, v, do)
    prev = dmesh.get_mesh()
    D.init_mesh({"dp": D.get_world_size(), "sep": 1})
    try:
        flash = R._flash_inner_ok(q.transpose(1, 2), k.transpose(1, 2), None)
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        C.reset_counts()
        out = F.scaled_dot_product_attention(*ts, is_causal=True,
                                             training=False)
        grads = torch.autograd.grad(out, ts, do)
        issued = C.issued()
    finally:
        dmesh.set_mesh(prev)
    pairs = [("out", out, ref)] + [(n, g, r) for n, g, r in
                                   zip(("dq", "dk", "dv"), grads, ref_g)]
    equal = {n: bool(torch.equal(g, r)) for n, g, r in pairs}
    errs = {n: within(g, r, ULP_REL[name], RMS_FRAC[name])
            for n, g, r in pairs}
    line = {"shape": list(shape), "dtype": name, "flash_inner": flash,
            "equal_to_flash": equal,
            "max_abs_err": {n: e[0] for n, e in errs.items()},
            "ppermutes": issued.get("ppermute", 0)}
    if issued.get("ppermute", 0) != 1:
        raise AssertionError("dist_nccl: the sep=1 SDPA issued %r, not the "
                             "ring's one dK/dV permute" % (issued,))
    if flash and not all(equal.values()):
        raise AssertionError("dist_nccl: the one-rank ring differs from "
                             "flash_attention_bshd: %r" % (line,))
    if not all(e[2] for e in errs.values()):
        raise AssertionError("dist_nccl: the one-rank ring outside the flash "
                             "rule: %r" % (line,))
    return line


def ring_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``ring_gloo`` in a world of two that is up, on
    the mesh {"sep": 2}: the global (B, S, H, D) q/k/v and cotangent from
    one seed, this rank's contiguous S / 2 rows through
    ``scaled_dot_product_attention`` (the ring) forward and backward with
    the launch counts set to 0 just before and read just after; the same
    rows through ``ulysses_attention``; each against one flash call over
    the whole sequence (``flash_reference``) by the flash rule.  Then a
    profiled step (forward and backward) of each: device ms, the flash
    kernels' share and the host ms.  Returns host values."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import ring_attention as R
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    D.init_mesh({"sep": 2})
    g = D.get_mesh().group("sep")
    r, n = g.rank, g.nranks
    shape = tuple(spec["shape"])
    s = shape[1]
    lo, hi = r * s // n, (r + 1) * s // n
    q, k, v, do = ring_inputs(torch, shape, spec["seed"], device,
                              getattr(torch, spec["dtype"]))
    ref, ref_g = flash_reference(torch, fa, q, k, v, do)
    mine = [t[:, lo:hi].contiguous() for t in (q, k, v)]
    do_l = do[:, lo:hi].contiguous()
    refs = [ref[:, lo:hi]] + [t[:, lo:hi] for t in ref_g]

    def ring():
        ts = [t.detach().clone().requires_grad_(True) for t in mine]
        out = F.scaled_dot_product_attention(*ts, is_causal=True,
                                             training=False)
        return [out] + list(torch.autograd.grad(out, ts, do_l))

    def ulysses():
        ts = [t.detach().clone().requires_grad_(True) for t in mine]
        out = R.ulysses_attention(*(t.transpose(1, 2) for t in ts), "sep",
                                  causal=True).transpose(1, 2)
        return [out] + list(torch.autograd.grad(out, ts, do_l))

    out = {"rank": r, "rows": [lo, hi]}
    for name, fn in (("ring", ring), ("ulysses", ulysses)):
        torch.cuda.synchronize()
        counters.reset()
        C.reset_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counters.read()
        issued = C.issued()
        got = [t.detach() for t in got]
        errs = [within(a, b, FLASH_ULP_REL, FLASH_RMS_FRAC)
                for a, b in zip(got, refs)]
        out[name] = {
            "launches": launches, "collectives_issued": issued,
            "max_abs_err": dict(zip(("out", "dq", "dk", "dv"),
                                    (e[0] for e in errs))),
            "ref_rms": dict(zip(("out", "dq", "dk", "dv"),
                                (e[1] for e in errs))),
            "rule_excess": dict(zip(("out", "dq", "dk", "dv"), (
                rule_excess(a, b, FLASH_ULP_REL, FLASH_RMS_FRAC)
                for a, b in zip(got, refs)))),
            "within_flash_rule": all(e[2] for e in errs),
            "equal_to_flash": [bool(torch.equal(a, b))
                               for a, b in zip(got, refs)],
            "first_step_host_ms": wall,
            **traced_calls(torch, fn, 2, ("flash_fwd", "flash_bwd"))}
    out["flash_inner"] = R._flash_inner_ok(
        mine[0].transpose(1, 2), mine[1].transpose(1, 2), None)
    return out


def ring_accumulators(torch, spec, device=None):
    """The kernels' accumulating modes that the ring runs, at its per-rank
    shape (``spec``'s shape with S / 2 rows), causal (the self shard) and
    full (a past shard), outside the counted run: the 16-bit forward's f32
    ``out`` (``out_f32``) rounds to its 16-bit out bit for bit, with the
    same lse, and holds the plain version's f32 out by the flash rule;
    C2's ``dq_acc`` and C3's ``dkv_acc`` into zeros hold the plain
    version's f32 dq, dk and dv by the flash rule and, into a nonzero
    start, add exactly that (the start plus it, bit for bit).  The plain
    versions run two heads at a time.  On a card, the device ms of a
    launch of each in its plain mode and in the ring's.  Returns the
    line's values."""
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    device = device if device is not None else torch.device("cuda")
    b, s, h, d = spec["shape"]
    shape = (b, s // 2, h, d)
    dtype = getattr(torch, spec["dtype"])
    q, k, v, do = ring_inputs(torch, shape, spec["seed"] + 1, device, dtype)
    gen = torch.Generator(device=device).manual_seed(spec["seed"] + 2)
    start = torch.randn((3,) + shape, generator=gen, device=device)
    scale = d ** -0.5
    line = {"shape": list(shape), "dtype": spec["dtype"]}
    ok = True
    for causal in (True, False):
        o16, lse = fac.flash_attention_bshd_with_lse(q, k, v, causal, scale)
        o32, lse32 = fac.flash_attention_bshd_with_lse(q, k, v, causal,
                                                       scale, out_f32=True)
        acc = torch.zeros((3,) + shape, dtype=torch.float32, device=device)
        fac.flash_attention_bwd(q, k, v, o16, lse, do, causal, scale,
                                route="split", dq_acc=acc[0],
                                dkv_acc=acc[1:])
        acc2 = start.clone()
        fac.flash_attention_bwd(q, k, v, o16, lse, do, causal, scale,
                                route="split", dq_acc=acc2[0],
                                dkv_acc=acc2[1:])
        fwd = fac._resolve_fwd(q, k, v, causal)
        errs = {n: 0.0 for n in ("out", "dq", "dk", "dv")}
        within_rule = True
        for h0 in range(0, h, 2):
            hs = slice(h0, h0 + 2)
            sl = [t[:, :, hs] for t in (q, k, v, o16, lse, do)]
            ref_o = fac._flash_tc_reference(*sl[:3], causal, scale,
                                            fwd[1], fwd[2], out_f32=True)[0]
            ref_g = fac._flash_bwd_reference(*sl, causal, scale, f32=True)
            for n, got, ref in zip(errs, (o32[:, :, hs], acc[0][:, :, hs],
                                          acc[1][:, :, hs],
                                          acc[2][:, :, hs]),
                                   (ref_o,) + tuple(ref_g)):
                e, _rms, good = within(got, ref, FLASH_ULP_REL,
                                       FLASH_RMS_FRAC)
                errs[n] = max(errs[n], e)
                within_rule = within_rule and good
            del ref_o, ref_g
        case = {"max_abs_err": errs, "within_flash_rule": within_rule,
                "out_rounds_to_16bit": bool(torch.equal(o32.to(dtype), o16))
                and bool(torch.equal(lse32, lse)),
                "adds_exactly": bool(torch.equal(acc2, start + acc))}
        if device.type == "cuda":
            # device ms a launch of each kernel in its plain mode and in
            # the ring's (f32 out, accumulators)
            delta = (do.float() * o16.float()).sum(-1)
            args = (q, k, v, do, lse, delta, causal, scale)
            case["device_ms"] = {
                name: kernel_ms(device_times(fn, torch, n=5, pattern=pat),
                                pat)
                for name, pat, fn in (
                    ("fwd", "flash_fwd",
                     lambda: fac.flash_attention_bshd_with_lse(
                         q, k, v, causal, scale)),
                    ("fwd_out_f32", "flash_fwd",
                     lambda: fac.flash_attention_bshd_with_lse(
                         q, k, v, causal, scale, out_f32=True)),
                    ("dq", "flash_bwd_dq",
                     lambda: fac._launch_bwd_dq(*args)),
                    ("dq_acc", "flash_bwd_dq",
                     lambda: fac._launch_bwd_dq(*args, dq_acc=acc[0])),
                    ("dkv", "flash_bwd_dkv",
                     lambda: fac._launch_bwd_dkv(*args)),
                    ("dkv_acc", "flash_bwd_dkv",
                     lambda: fac._launch_bwd_dkv(*args, dkv_acc=acc[1:])))}
        line["causal" if causal else "full"] = case
        ok = ok and within_rule and case["out_rounds_to_16bit"] \
            and case["adds_exactly"]
    line["ok"] = ok
    return line


def ring_hold(outs, spec, accumulators=None):
    """ring_gloo's checks over both ranks' results: each rank's ring and
    Ulysses outputs and grads within the flash rule of the whole-sequence
    flash call; the ring's launches (rank r runs r + 1 flash forwards
    and r + 1 C2 / C3 pairs: the causal ring skips strictly-future
    shards), Ulysses' one of each a rank; the permutes (1 forward, 3
    backward at two ranks) and all-to-alls (4) every rank issued alike;
    and :func:`ring_accumulators`' values where given.  Returns the
    line."""
    line = {"phase": "ring_gloo", "backend": "gloo", "ranks": 2,
            "shape": list(spec["shape"]), "dtype": spec["dtype"],
            "causal": True, "rule": [FLASH_ULP_REL, FLASH_RMS_FRAC],
            "flash_inner": [o["flash_inner"] for o in outs]}
    for name in ("ring", "ulysses"):
        line[name] = [{k: o[name][k] for k in (
            "launches", "max_abs_err", "ref_rms", "rule_excess",
            "within_flash_rule", "equal_to_flash",
            "collectives_issued", "first_step_host_ms", "step_host_ms",
            "step_device_ms", "flash_fwd_device_ms", "flash_bwd_device_ms")}
            for o in outs]
        for o in line[name]:
            o["launches"] = {k: o["launches"][k] for k in (
                "flash_fwd_tc", "flash_fwd", "flash_fwd_pipelined",
                "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")}
    line["speed"] = ("not measured: gloo stages every permute and "
                     "all-to-all through the host (needs two cards and "
                     "NCCL)")
    line["accumulators"] = accumulators
    emit(line)
    if accumulators is not None and not accumulators["ok"]:
        raise AssertionError("ring_gloo: the kernels' accumulating modes "
                             "at the ring's shape: %r" % (accumulators,))
    for o in outs:
        r = o["rank"]
        if not o["flash_inner"]:
            raise AssertionError("ring_gloo: rank %d's ring took the "
                                 "blockwise inner" % r)
        for name, due, issued in (
                ("ring", r + 1, {"ppermute": 4}),
                ("ulysses", 1, {"all_to_all_single": 4})):
            got = o[name]
            if not got["within_flash_rule"]:
                raise AssertionError("ring_gloo: rank %d's %s outside the "
                                     "flash rule: %r" % (r, name,
                                                         got["max_abs_err"]))
            expect_launches(got["launches"],
                            {"flash_fwd_tc": due, "flash_fwd": 0,
                             "flash_fwd_pipelined": 0, "flash_bwd": 0,
                             "flash_bwd_dq": due, "flash_bwd_dkv": due},
                            "ring_gloo rank %d %s" % (r, name))
            if got["collectives_issued"] != issued:
                raise AssertionError("ring_gloo: rank %d's %s issued %r, "
                                     "want %r" % (r, name,
                                                  got["collectives_issued"],
                                                  issued))
    return line


def ring_gloo(torch, timeout=600.0, spec=None):
    """The kernels' accumulating modes at the ring's per-rank shape
    (:func:`ring_accumulators`), then two processes on the one card, a
    gloo world over CUDA tensors, the mesh {"sep": 2}: the ring and
    Ulysses at RING_SHAPE bf16 causal against one flash call over the
    whole sequence (:func:`ring_hold`).
    Gloo stages the transfers through the host: the phase's times are not
    a sequence-parallel speed."""
    spec = spec or {"shape": RING_SHAPE, "dtype": "bfloat16", "seed": 11}
    t0 = time.perf_counter()
    acc = ring_accumulators(torch, spec)
    torch.cuda.empty_cache()
    line = ring_hold(gloo_world("ring_rank", spec, timeout), spec, acc)
    line["seconds"] = time.perf_counter() - t0
    return line


# moe_gloo: MoELayer at GPT-2 345M's FFN widths (1024 -> 4096 -> 1024),
# 8 experts, GShard top-2, capacity factor 1.25, f32, on train's step
# batch of (8, 1024) tokens; each (T, E, C) routing tensor is 8192 x 8 x
# 2560 f32, 0.67 GB
MOE_SPEC = {"batch": (8, 1024), "d_model": 1024, "d_hidden": 4096,
            "experts": 8, "top_k": 2, "capacity_factor": 1.25, "seed": 13}
# the card's f32 (TF32 off) against the CPU's, and ep=2 against ep=1 on
# the card: sums in other orders over 8192 tokens and 4096 hidden units
MOE_CPU_REL = 1e-4
MOE_EP_REL = 1e-5
# a token whose top-1 / top-2 (or top-2 / top-3) gate probabilities are
# closer than this may route differently under f32 noise: it is excluded
# from the value comparison and counted, never covered by a looser bar
MOE_MARGIN = 1e-6


def moe_state(spec):
    """The MoE layer's state ({name: np.ndarray}, the JAX package's
    names) and the input tokens and output cotangent, from the seed."""
    rng = np.random.default_rng(spec["seed"])
    d, h, e = spec["d_model"], spec["d_hidden"], spec["experts"]

    def normal(*shape, std=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * std)
    state = {"gate.gate.weight": normal(d, e)}
    for i in range(e):
        state.update({"experts.%d.fc1.weight" % i: normal(d, h),
                      "experts.%d.fc1.bias" % i: normal(h),
                      "experts.%d.fc2.weight" % i: normal(h, d),
                      "experts.%d.fc2.bias" % i: normal(d)})
    b, s = spec["batch"]
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    cot = rng.standard_normal((b, s, d), dtype=np.float32)
    return state, x, cot


def moe_run(torch, spec, state, x, cot, n_local, device):
    """A ``MoELayer`` of ``n_local`` ExpertFFNs holding ``state`` on
    ``device``: out, aux_loss, the grads of sum(out * cot) + aux_loss by
    parameter name and for the input (``x``), and each token's top-k
    experts (host values)."""
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.distributed.moe import ExpertFFN, MoELayer
    layer = MoELayer(spec["d_model"],
                     [ExpertFFN(spec["d_model"], spec["d_hidden"])
                      for _ in range(n_local)], gate="gshard",
                     top_k=spec["top_k"],
                     capacity_factor=spec["capacity_factor"])
    load_paddle_tpu_state(layer, state)
    layer = layer.to(device)
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    out = layer(xt)
    loss = (out * torch.from_numpy(cot).to(device)).sum() + layer.aux_loss
    params = dict(layer.named_parameters(), x=xt)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    with torch.no_grad():
        probs = torch.softmax(layer.gate(xt.reshape(-1, xt.shape[-1])), -1)
        top = probs.topk(spec["top_k"] + 1, -1)
    return {"out": out.detach(), "aux": float(layer.aux_loss.detach()),
            "grads": {k: v.detach() for k, v in grads.items()},
            "route": top.indices[:, :spec["top_k"]].cpu(),
            "probs": top.values.cpu()}


def rel_err(got, ref):
    """max |got - ref| over max |ref| (host f32)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def moe_compare(torch, got, ref, names, scale=None):
    """``got``'s out, aux and grads against ``ref``'s, over the tokens
    that are not near a routing tie (MOE_MARGIN, from ``ref``'s
    probabilities) and routed alike; ``names`` maps got's parameter names
    to ref's, ``scale`` divides got's expert grads (ep).  The out and the
    input's gradient are held on those tokens' rows; the aux loss and the
    parameters' grads, which sum over every token, only where every token
    routed alike (:func:`moe_rank` then runs both sides again over the
    tokens kept).  Returns (errors, near-tie tokens, tokens routed
    differently, the two token masks)."""
    p = ref["probs"]
    near = ((p[:, :-1] - p[:, 1:]) < MOE_MARGIN).any(-1)
    differ = (got["route"] != ref["route"]).any(-1)
    keep = ~(near | differ)
    d = ref["out"].shape[-1]

    def rows(t):
        return t.reshape(-1, d).cpu()[keep]
    errs = {"out": rel_err(rows(got["out"]), rows(ref["out"])),
            "x": rel_err(rows(got["grads"]["x"]), rows(ref["grads"]["x"]))}
    if not bool(differ.any()):
        errs["aux"] = abs(got["aux"] - ref["aux"]) / abs(ref["aux"])
        for name, g in got["grads"].items():
            if name == "x":
                continue
            if scale and name.startswith("experts."):
                g = g / scale
            errs[name] = rel_err(g, ref["grads"][names(name)])
    return errs, int(near.sum()), int(differ.sum()), differ, near


def moe_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``moe_gloo`` in a world of two that is up: the
    layer with all 8 experts local (``ep`` = 1, no exchange) on
    ``device``; then the mesh {"ep": 2}, 4 local experts a rank
    (``convert.shard_moe_state``), held against the ep = 1 run at
    MOE_EP_REL, its all-to-alls and peak allocation counted; then, on rank
    0, the same weights on the CPU against the card's ep = 1 run at
    MOE_CPU_REL.  Returns host values."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.convert import shard_moe_state
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as dmesh
    state, x, cot = moe_state(spec)
    e = spec["experts"]
    dmesh.set_mesh(None)
    C.reset_counts()
    t0 = time.perf_counter()
    ep1 = moe_run(torch, spec, state, x, cot, e, device)
    ep1_a2a = C.issued().get("all_to_all_single", 0)
    ep1_s = time.perf_counter() - t0
    D.init_mesh({"ep": 2})
    g = D.get_mesh().group("ep")
    r, n = g.rank, g.nranks
    nle = e // n
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    C.reset_counts()
    t0 = time.perf_counter()
    ep2 = moe_run(torch, spec, shard_moe_state(state, r, n), x, cot, nle,
                  device)
    issued = C.issued()
    ep2_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device != "cpu"
            else 0.0)

    def global_name(name):
        if not name.startswith("experts."):
            return name
        _, i, rest = name.split(".", 2)
        return "experts.%d.%s" % (int(i) + r * nle, rest)
    errs, near, differ, _d, _n = moe_compare(torch, ep2, ep1, global_name,
                                             scale=n)
    out = {"rank": r, "ep2_vs_ep1": errs, "ep2_near_ties": near,
           "ep2_routed_differently": differ,
           "ep1_all_to_all": ep1_a2a, "ep2_collectives_issued": issued,
           "ep2_peak_gb": peak, "ep1_seconds": ep1_s,
           "ep2_seconds": ep2_s}
    if r == 0:
        dmesh.set_mesh(None)
        t0 = time.perf_counter()
        cpu = moe_run(torch, spec, state, x, cot, e, "cpu")
        out["cpu_seconds"] = time.perf_counter() - t0
        errs, near, differ, dmask, nmask = moe_compare(
            torch, ep1, cpu, lambda name: name)
        out.update(ep1_vs_cpu=errs, cpu_near_ties=near,
                   cpu_routed_differently=differ,
                   differ_not_near=int((dmask & ~nmask).sum()),
                   rerun_tokens=None)
        if differ:
            # the aux loss and the parameters' grads sum over every
            # token: both sides again over the tokens that route alike
            # away from a tie, every value held there
            keep = (~(dmask | nmask)).numpy()
            d = spec["d_model"]
            xs, cs = (a.reshape(-1, d)[keep][None] for a in (x, cot))
            sub = [moe_run(torch, spec, state, xs, cs, e, dev)
                   for dev in (device, "cpu")]
            errs, near, differ, _d, _n = moe_compare(
                torch, sub[0], sub[1], lambda name: name)
            out.update(ep1_vs_cpu=errs, rerun_tokens=int(keep.sum()),
                       rerun_near_ties=near,
                       rerun_routed_differently=differ)
    return out


def moe_hold(outs, spec):
    """moe_gloo's checks: ep = 2 within MOE_EP_REL of ep = 1 on both ranks
    (out, aux and every gradient), ep = 1 on the card within MOE_CPU_REL
    of the CPU; a token may route differently only where it is a near-tie
    (MOE_MARGIN), and those are left out of the values and counted (the
    sums over every token held on a second run over the tokens kept); no
    exchange at ep = 1, and at ep = 2 the dispatch and the combine forward
    and backward (4 all-to-alls).  Returns the line."""
    r0 = outs[0]
    line = {"phase": "moe_gloo", "backend": "gloo", "ranks": 2,
            "layer": {k: spec[k] for k in (
                "d_model", "d_hidden", "experts", "top_k",
                "capacity_factor")},
            "tokens": spec["batch"][0] * spec["batch"][1], "dtype":
            "float32", "gate": "gshard",
            "capacity": max(int(math.ceil(
                spec["top_k"] * spec["capacity_factor"] * spec["batch"][0]
                * spec["batch"][1] / spec["experts"])), 4),
            "tolerance": {"ep2_vs_ep1": MOE_EP_REL,
                          "card_vs_cpu": MOE_CPU_REL,
                          "margin": MOE_MARGIN},
            "ep1_vs_cpu_max": max(r0["ep1_vs_cpu"].values()),
            "ep1_vs_cpu": r0["ep1_vs_cpu"],
            "cpu_near_ties": r0["cpu_near_ties"],
            "cpu_routed_differently": r0["cpu_routed_differently"],
            "cpu_rerun_tokens": r0["rerun_tokens"],
            "ep2_vs_ep1_max": [max(o["ep2_vs_ep1"].values()) for o in outs],
            "ep2_near_ties": [o["ep2_near_ties"] for o in outs],
            "ep2_routed_differently": [o["ep2_routed_differently"]
                                       for o in outs],
            "ep2_collectives_issued": [o["ep2_collectives_issued"]
                                       for o in outs],
            "ep2_peak_gb": [o["ep2_peak_gb"] for o in outs],
            "seconds_by_run": {k: r0[k] for k in (
                "ep1_seconds", "ep2_seconds", "cpu_seconds")}}
    t, e = line["tokens"], spec["experts"]
    line["routing_tensor_gb"] = t * e * line["capacity"] * 4 / 1e9
    emit(line)
    if r0["differ_not_near"] or r0.get("rerun_routed_differently"):
        raise AssertionError("moe_gloo: %d tokens route differently on the "
                             "card and the CPU away from a near-tie (%r in "
                             "the run over the tokens kept)"
                             % (r0["differ_not_near"],
                                r0.get("rerun_routed_differently")))
    if not line["ep1_vs_cpu_max"] <= MOE_CPU_REL:
        raise AssertionError("moe_gloo: ep=1 on the card against the CPU: %r"
                             % (r0["ep1_vs_cpu"],))
    for o in outs:
        if o["ep2_routed_differently"] or \
                not max(o["ep2_vs_ep1"].values()) <= MOE_EP_REL:
            raise AssertionError("moe_gloo: rank %d ep=2 against ep=1: %r "
                                 "(%d routed differently)"
                                 % (o["rank"], o["ep2_vs_ep1"],
                                    o["ep2_routed_differently"]))
        if o["ep1_all_to_all"] or o["ep2_collectives_issued"] != {
                "all_to_all_single": 4}:
            raise AssertionError("moe_gloo: rank %d exchanges %r at ep=1, "
                                 "%r at ep=2" % (o["rank"],
                                                 o["ep1_all_to_all"],
                                                 o["ep2_collectives_issued"]))
    return line


def moe_gloo(torch, timeout=600.0, spec=None):
    """Two processes on the one card, a gloo world over CUDA tensors:
    ``MoELayer`` at MOE_SPEC, ep = 1 on the card against the CPU and ep = 2
    against ep = 1 (:func:`moe_hold`).  Gloo stages each all-to-all
    through the host: no time here is an expert-parallel speed."""
    spec = spec or MOE_SPEC
    t0 = time.perf_counter()
    line = moe_hold(gloo_world("moe_rank", spec, timeout), spec)
    line["seconds"] = time.perf_counter() - t0
    return line


def autotune_warm(torch, at, fac):
    """``warm()`` over the port's standard keys (the four flash families
    at the training shape, the decode attention at the serving shape),
    plus flash_fwd at head dim 256, where the
    shared-memory gate refuses the A' tiles that do not fit.  Writes the
    cache that PADDLE_TPU_AUTOTUNE_CACHE names (main() points it at a
    temporary file).  One line per key: its timing table, the winner and
    the refused candidates."""
    limit = at.smem_limit(torch.device("cuda"))
    # the mp_overlap key times a ring over two ranks: a world of one has
    # no ring to time
    pairs = [(f, k) for f, k in at.standard_keys()
             if f != "mp_overlap"] + [("flash_fwd", fac.autotune_key(
        1, 1024, 1024, 4, 256, torch.bfloat16, True, "cuda"))]
    t0 = time.perf_counter()
    winners = at.warm(pairs, verbose=False)
    seconds = time.perf_counter() - t0
    cache = at._load_cache()["families"]
    lines = []
    for (fam, key), won in zip(pairs, winners):
        entry = cache[fam][at.key_str(key)]
        timings = entry["timings"]
        refused = sorted(sig for sig, t in timings.items()
                         if isinstance(t, str)
                         and t.startswith("rejected: smem"))
        family = at.families()[fam]
        want = sorted(at._cand_sig(c) for c in family.candidates(key)
                      if at._smem_reject(family, c, key, limit))
        line = {"phase": "autotune", "family": fam,
                "key": at.key_str(key), "winner": won, "ms": entry["ms"],
                "samples": entry["samples"], "timings": timings,
                "rejected_smem": refused, "smem_limit": limit}
        emit(line)
        lines.append(line)
        failed = [sig for sig, t in timings.items() if isinstance(t, str)
                  and not t.startswith("rejected: smem")]
        if refused != want or failed or at._cand_sig(won) in refused:
            raise AssertionError("autotune %s: refused %r (want %r), failed "
                                 "%r, winner %r" % (fam, refused, want,
                                                    failed, won))
    emit({"phase": "autotune_seconds", "seconds": seconds,
          "tune_seconds": at.tune_seconds, "keys": len(pairs)})
    return lines


def train_pipelined(torch, base, amp, counters, flags, first_loss, steps=3):
    """The train step for ``steps`` steps under
    ``FLAGS_autotune_pin=PIN_A_PRIME``, from the same weights
    and batch: A' (64 x 64 tiles) on every layer, the tensor-core forward
    and kernel A never, C2 and C3 in the backward; the first loss held
    against the default route's."""
    layers = base.config.num_hidden_layers
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    flags.set_flags({"autotune_pin": PIN_A_PRIME})
    try:
        step = make_step(train_model(torch, base, amp))
        losses, launches, ms = run_steps(torch, step, ids, counters, steps)
        breakdown = step_breakdown(torch, step, ids)
        profile = profile_steps(torch, step, ids)
    finally:
        flags.set_flags({"autotune_pin": ""})
    del step
    torch.cuda.empty_cache()
    line = {"phase": "train_pipelined", "pin": PIN_A_PRIME,
            "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "first_loss_default_route": first_loss,
            "first_loss_diff": abs(losses[0] - first_loss),
            "tolerance": CE_ROUTE_LOSS_TOL, "launches": launches,
            "breakdown": breakdown, "profile": profile}
    emit(line)
    expect_launches(launches, {"flash_fwd_pipelined": layers * steps,
                               "flash_fwd_tc": 0, "flash_fwd": 0,
                               "flash_bwd": 0,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps},
                    "train_pipelined")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - first_loss) > CE_ROUTE_LOSS_TOL:
        raise AssertionError("train_pipelined: losses %r against the default "
                             "route's first %g" % (losses, first_loss))
    return line


def train_autotune(torch, base, amp, counters, flags, at, fac, first_loss,
                   steps=3):
    """The train step for ``steps`` steps with ``FLAGS_autotune=1`` from a
    cold in-process memo, so every flash call reads the cache that the
    autotune phase wrote: nothing is timed again, the launches are the
    winners' and the first loss is held as in train_pipelined."""
    layers = base.config.num_hidden_layers
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    for memo in (at._MEMO, at._MEMO_DEFAULT, at._RESOLVED):
        memo.clear()
    at._CACHE = None
    tuned_s = at.tune_seconds
    flags.set_flags({"autotune": True})
    try:
        step = make_step(train_model(torch, base, amp))
        losses, launches, ms = run_steps(torch, step, ids, counters, steps)
    finally:
        flags.set_flags({"autotune": False})
    del step
    torch.cuda.empty_cache()
    report = at.report()
    ks = at.key_str(fac.autotune_key(8, 1024, 1024, 16, 64, torch.bfloat16,
                                     True, "cuda"))
    cache = at._load_cache()["families"]
    ran = {fam: report[fam][ks] for fam in ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv")}
    line = {"phase": "train_autotune", "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "first_loss_default_route": first_loss,
            "first_loss_diff": abs(losses[0] - first_loss),
            "tolerance": CE_ROUTE_LOSS_TOL, "launches": launches,
            "report": report}
    emit(line)
    # the forward's winner: A' or the tensor-core forward (at one of its
    # tiles); the backward: C2 and C3 at their winners' tiles
    pipelined = ran["flash_fwd"]["variant"] == "pipelined"
    expect_launches(launches, {
        "flash_fwd_pipelined": layers * steps if pipelined else 0,
        "flash_fwd_tc": 0 if pipelined else layers * steps,
        "flash_fwd": 0, "flash_bwd": 0,
        "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps},
        "train_autotune")
    for fam, cand in ran.items():
        entry = cache[fam][ks]
        if cand != {"variant": entry["variant"], "config": entry["config"]}:
            raise AssertionError("train_autotune ran %s %r, the cache holds "
                                 "%r" % (fam, cand, entry))
    if at.tune_seconds != tuned_s:
        raise AssertionError("train_autotune timed candidates again")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - first_loss) > CE_ROUTE_LOSS_TOL:
        raise AssertionError("train_autotune: losses %r against the default "
                             "route's first %g" % (losses, first_loss))
    return line


LONG_S = 16384


def long_step(torch, cfg, amp, device="cuda", s=LONG_S):
    """train_long's step and ids: GPT-2 345M (``cfg``) with
    max_position_embeddings ``s`` from seed 1, AMP O2 bf16, AdamW, and a
    seeded (1, ``s``) batch."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    lcfg = dataclasses.replace(cfg, max_position_embeddings=s)
    base = GPTForCausalLM(lcfg, generator=torch.Generator().manual_seed(1))
    step = make_step(train_model(torch, base, amp, device), device=device)
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, s)), device=device)
    return step, ids


def sep_grad_names(layers):
    """The parameters whose first-step gradients sep_train_gloo holds:
    the tied embedding, the first and last block's qkv and fc2, ln_f."""
    return ["gpt.wte.weight", "gpt.ln_f.weight"] + [
        "gpt.h.%d.%s.weight" % (i, m) for i in (0, layers - 1)
        for m in ("attn.qkv_proj", "mlp.fc2")]


def record_grads(step, names):
    """A dict that the step's first optimizer call fills with the f32
    gradients of ``names``, copied to the host (so that they take no
    card memory from a step whose peak is read)."""
    seen = {}
    apply = step.optimizer.apply_gradients

    def keep(params, grads, *a, **kw):
        if not seen:
            seen.update({n: grads[n].detach().to("cpu", copy=True).float()
                         for n in names})
        return apply(params, grads, *a, **kw)
    step.optimizer.apply_gradients = keep
    return seen


def train_long(torch, cfg, amp, counters, flags, steps=3, grads_to=None):
    """The long-context shape of the JAX package's long-sequence run:
    GPT-2 345M at full width, max_position_embeddings 16384, B=1,
    S=16384: the tensor-core forward, C2 and C3 on every layer, kernel A
    and C1 never.  ``steps``
    steps (ms over all but the first), then one more step timed part by
    part on the stream.  ``grads_to``: a file that takes the first step's
    gradients of :func:`sep_grad_names` (sep_train_gloo's reference)."""
    flags.set_flags({"use_pallas_norm": False})
    s = LONG_S
    step, ids = long_step(torch, cfg, amp)
    seen = record_grads(step, sep_grad_names(cfg.num_hidden_layers))
    torch.cuda.reset_peak_memory_stats()
    losses, launches, ms = run_steps(torch, step, ids, counters, steps)
    del step.optimizer.apply_gradients        # record_grads' wrapper
    if grads_to is not None:
        torch.save(dict(seen), grads_to)
    seen.clear()
    line = {"phase": "train_long", "shape": [1, s], "steps": steps,
            "step_ms": ms, "tokens_per_s": s * 1e3 / ms,
            "losses": losses, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "breakdown": step_breakdown(torch, step, ids)}
    emit(line)
    layers = cfg.num_hidden_layers
    expect_launches(launches, {"flash_fwd_tc": layers * steps,
                               "flash_fwd": 0,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps,
                               "flash_bwd": 0}, "train_long")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train_long: non-finite loss %r" % (losses,))
    return line


# sep_train_gloo: train_long's step on {"sep": 2}, two processes over
# gloo, 8192 rows a rank.  Both runs are bf16 with the flash kernels; the
# ring's out, dq, dk and dv stay within the flash rule of one full call
# (a bf16 ulp of each element, ring_gloo), the gradient shares are
# rounded to bf16 a rank and summed in f32; through 24 bf16 layers that
# stays inside train_parity's bars for bf16 kernels against the f32 CPU
# (measured there at 0.019 relative L2, limit 0.03; loss 0.02), so the
# same relative-L2 bar holds here, and the losses train_long's within
# 0.01, the bar train_norm and train_ce hold two routes of one step to.
# A mean over 'sep' where a sum is due would be 0.5 relative off.
SEP_GRAD_REL_TOL = PARITY_GRAD_REL_TOL
SEP_LOSS_TOL = 0.01
SEP_STEPS = 2


def sep_train_rank(torch, spec, counters, device="cuda"):
    """One rank's part of ``sep_train_gloo`` in a world of two that is up,
    on the mesh {"sep": 2}: train_long's model, weights and ids
    (:func:`long_step` at ``spec["cfg"]``, ``spec["s"]`` rows), each rank
    given the global batch and running its S / 2 rows, the ring inside
    every block's attention; ``spec["steps"]`` steps with the launch
    counts set to 0 just before and read just after.  The first step's
    gradients of :func:`sep_grad_names` (summed over 'sep') against the
    one-rank run's (``spec["ref_grads"]``, a file) as sums the hold
    turns into relative L2 errors: |g|^2, g . ref and |ref|^2 (f64).
    Returns host values."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.utils import flags
    D.init_mesh({"sep": 2})
    g = D.get_mesh().group("sep")
    flags.set_flags({"use_pallas_norm": False})
    step, ids = long_step(torch, spec["cfg"], amp, device, spec["s"])
    names = sep_grad_names(spec["cfg"].num_hidden_layers)
    seen = record_grads(step, names)
    if device != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    C.reset_counts()
    losses, launches, ms = run_steps(torch, step, ids, counters,
                                     spec["steps"])
    issued = C.issued()
    ref = torch.load(spec["ref_grads"])
    sums = {}
    for n in names:
        a = seen[n].double()
        b = ref[n].double()
        sums[n] = [float((a * a).sum()), float((a * b).sum()),
                   float((b * b).sum())]
    return {"rank": g.rank, "rows": [g.rank * spec["s"] // 2,
                                     (g.rank + 1) * spec["s"] // 2],
            "losses": losses, "launches": launches,
            "collectives_per_step": {k: v / spec["steps"]
                                     for k, v in issued.items()},
            "grad_sums": sums, "step_host_ms_over_gloo": ms,
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device != "cpu" else None)}


def grad_rel_l2(sums):
    """|g - ref| / |ref| from (|g|^2, g . ref, |ref|^2)."""
    gg, gr, rr = sums
    return math.sqrt(max(gg - 2.0 * gr + rr, 0.0) / rr)


def sep_train_hold(outs, spec):
    """sep_train_gloo's checks over both ranks' results: the same losses
    on both ranks, each within SEP_LOSS_TOL of train_long's
    (``spec["ref_losses"]``); on each rank the first step's gradients of
    every named parameter and their global norm within SEP_GRAD_REL_TOL
    (relative L2)
    of train_long's; rank r's ring r + 1 flash forwards and C2 / C3
    pairs a layer and step (the causal ring skips future shards), never
    kernel A, A' or C1.  Returns the line."""
    layers = spec["cfg"].num_hidden_layers
    steps = spec["steps"]
    r0 = outs[0]
    rels = [{n: grad_rel_l2(v) for n, v in o["grad_sums"].items()}
            for o in outs]
    norms = [math.sqrt(sum(v[0] for v in o["grad_sums"].values()))
             for o in outs]
    ref_norm = math.sqrt(sum(v[2] for v in r0["grad_sums"].values()))
    line = {"phase": "sep_train_gloo", "backend": "gloo", "device": "cuda",
            "ranks": 2, "mesh": {"sep": 2}, "shape": [1, spec["s"]],
            "rows_per_rank": spec["s"] // 2, "layers": layers,
            "steps": steps, "losses": [o["losses"] for o in outs],
            "ref_losses": spec["ref_losses"][:steps],
            "loss_tol": SEP_LOSS_TOL,
            "max_loss_diff": max(abs(a - b) for o in outs for a, b in zip(
                o["losses"], spec["ref_losses"])),
            "grad_rel_l2": rels, "grad_norm": norms,
            "ref_grad_norm": ref_norm,
            "grad_norm_rel": max(abs(n - ref_norm) / ref_norm
                                 for n in norms),
            "grad_rel_tol": SEP_GRAD_REL_TOL,
            "launches": [o["launches"] for o in outs],
            "collectives_per_step": [o["collectives_per_step"]
                                     for o in outs],
            "step_host_ms_over_gloo": [o["step_host_ms_over_gloo"]
                                       for o in outs],
            "max_memory_allocated": [o["max_memory_allocated"]
                                     for o in outs],
            "speed": "not a sequence-parallel speed: gloo stages every "
                     "permute and all-reduce through the host"}
    emit(line)
    if outs[0]["losses"] != outs[1]["losses"] or not (
            all(math.isfinite(x) for x in r0["losses"])
            and line["max_loss_diff"] <= SEP_LOSS_TOL):
        raise AssertionError("sep_train_gloo: losses %r against "
                             "train_long's %r" % (line["losses"],
                                                  line["ref_losses"]))
    err, worst, rank = max((rel[n], n, r) for r, rel in enumerate(rels)
                           for n in rel)
    if not (err <= SEP_GRAD_REL_TOL
            and line["grad_norm_rel"] <= SEP_GRAD_REL_TOL):
        raise AssertionError("sep_train_gloo: gradients %s %g on rank %d "
                             "and the norm %g (relative L2) from "
                             "train_long's" % (worst, err, rank,
                                               line["grad_norm_rel"]))
    for o in outs:
        r = o["rank"]
        due = layers * (r + 1) * steps
        expect_launches(o["launches"], {
            "flash_fwd_tc": due, "flash_bwd_dq": due, "flash_bwd_dkv": due,
            "flash_fwd": 0, "flash_fwd_pipelined": 0, "flash_bwd": 0},
            "sep_train_gloo rank %d" % r)
    return line


def sep_train_gloo(torch, cfg, run_long, ref_grads, timeout=900.0):
    """Two processes on the one card, a gloo world over CUDA tensors, the
    mesh {"sep": 2}: train_long's step with the GPT's sequence sharding,
    held to train_long's losses and first-step gradients (``ref_grads``,
    the file train_long wrote; :func:`sep_train_hold`)."""
    spec = {"cfg": cfg, "s": LONG_S, "steps": SEP_STEPS,
            "ref_losses": run_long["losses"], "ref_grads": ref_grads}
    t0 = time.perf_counter()
    line = sep_train_hold(gloo_world("sep_train_rank", spec, timeout), spec)
    line["seconds"] = time.perf_counter() - t0
    return line


def train_f32(torch, base, counters, flags, steps=3):
    """bench.py's step in f32: GPT-2 345M at (8, 1024), f32 weights and
    activations (no AMP; TF32 matmuls off, as in every phase), AdamW, the
    seeded batch of train: kernel A and the f32 C1 (the JAX rule's route
    at S = 1024) on every layer.  ``steps`` steps from counts set to 0
    (host ms over all but the first), the stream time of each part of one
    more step, and a profile of 2 steps: device ms a step, and of it the
    f32 backward kernels' and the forward kernel's."""
    flags.set_flags({"use_pallas_norm": False})
    step = make_step(copy.deepcopy(base).cuda())
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses, launches, ms = run_steps(torch, step, ids, counters, steps)
    line = {"phase": "train_f32", "shape": [8, 1024], "dtype": "float32",
            "steps": steps, "step_ms": ms,
            "tokens_per_s": 8 * 1024 * 1e3 / ms, "losses": losses,
            "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "breakdown": step_breakdown(torch, step, ids),
            "profile": profile_steps(torch, step, ids, sums=(
                "flash_bwd_kv_kernel", "flash_bwd_dq_kernel",
                "flash_fwd_kernel"))}
    emit(line)
    layers = base.config.num_hidden_layers
    expect_launches(launches, {"flash_fwd": layers * steps,
                               "flash_bwd": layers * steps,
                               "flash_fwd_tc": 0, "flash_fwd_pipelined": 0,
                               "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                    "train_f32")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train_f32: non-finite loss %r" % (losses,))
    if abs(losses[0] - math.log(base.config.vocab_size)) > FIRST_LOSS_TOL:
        raise AssertionError("train_f32: first loss %g, want ln(%d) +- %g"
                             % (losses[0], base.config.vocab_size,
                                FIRST_LOSS_TOL))
    del step
    torch.cuda.empty_cache()
    return line


def check_train_f32(torch, fac, norm_cuda, ce_cuda, flags, steps=3):
    """:func:`train_f32` alone, on GPT-2 345M with the seeded weights of
    main()'s train phases, for ``tools/torch_checks_ab.py``: host ms a
    step, device ms a step and the f32 flash kernels' share of it from the
    phase's 2-step profile, and the launches a step."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = dataclasses.replace(GPTConfig.gpt2_medium(),
                              hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0)
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    line = train_f32(torch, base, Counters(fac, norm_cuda, ce_cuda), flags,
                     steps)
    prof = line["profile"]
    return {"step_ms": line["step_ms"], "losses": line["losses"],
            "launches_per_step": line["launches_per_step"],
            "step_device_ms": prof["step_device_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms_per_step_of": prof["device_ms_per_step_of"]}


def train_fp16(torch, base, amp, counters, flags, first_loss, steps=3):
    """The fp16 route: GPT-2 345M from the same weights under
    ``amp.decorate(level="O2", dtype="float16")``, ``steps`` eager AdamW
    steps under a ``GradScaler`` on the train batch, once per LayerNorm
    route: the tensor-core forward, C2 and C3 on every layer (kernel A
    and C1 never), B and D under ``use_pallas_norm``; the first loss
    finite and within FIRST_LOSS_TOL of the bf16 step's, no step
    skipped (every gradient finite), ms over steps 2..N."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    layers = base.config.num_hidden_layers
    n_ln = 2 * layers + 1
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.config.vocab_size, (8, 1024)), device="cuda")
    crit = GPTPretrainingCriterion()
    lines = []
    for use_norm in (False, True):
        flags.set_flags({"use_pallas_norm": use_norm})
        try:
            model = amp.decorate(copy.deepcopy(base), level="O2",
                                 dtype="float16").to("cuda")
            opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                        parameters=model.parameters())
            scaler = GradScaler(init_loss_scaling=2.0 ** 12)
            losses, skipped = [], []
            torch.cuda.synchronize()
            counters.reset()
            for i in range(steps):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                loss = crit(model(ids), ids)
                scaler.scale(loss).backward()
                scaler.step(opt)
                opt.clear_grad()
                losses.append(float(loss.detach()))
                skipped.append(scaler.last_step_skipped)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
            launches = counters.read()
        finally:
            flags.set_flags({"use_pallas_norm": False})
        del model, opt
        torch.cuda.empty_cache()
        line = {"phase": "train_fp16", "use_pallas_norm": use_norm,
                "shape": [8, 1024], "steps": steps, "step_ms": ms,
                "losses": losses, "skipped": skipped,
                "loss_scale": scaler.get_loss_scaling(),
                "first_loss_bf16": first_loss,
                "first_loss_diff": abs(losses[0] - first_loss),
                "tolerance": FIRST_LOSS_TOL, "launches": launches}
        emit(line)
        lines.append(line)
        expect_launches(launches, {
            "flash_fwd_tc": layers * steps, "flash_fwd": 0,
            "flash_fwd_pipelined": 0, "flash_bwd": 0,
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "layer_norm_fwd": n_ln * steps if use_norm else 0,
            "layer_norm_bwd": n_ln * steps if use_norm else 0},
            "train_fp16 use_pallas_norm=%s" % use_norm)
        if not all(math.isfinite(x) for x in losses) or any(skipped) or \
                abs(losses[0] - first_loss) > FIRST_LOSS_TOL:
            raise AssertionError("train_fp16 (use_pallas_norm=%s): losses "
                                 "%r, skipped %r, bf16 first loss %g"
                                 % (use_norm, losses, skipped, first_loss))
    return lines


def step_grads(torch, step, ids):
    """One train step; returns (loss, the f32 gradients it handed the
    optimizer, by name, on the CPU)."""
    seen = {}
    apply = step.optimizer.apply_gradients

    def keep(params, grads, state, lr):
        seen.update({k: g.detach().float().cpu() for k, g in grads.items()})
        return apply(params, grads, state, lr)
    step.optimizer.apply_gradients = keep
    try:
        loss = float(step(ids, ids))
    finally:
        del step.optimizer.apply_gradients
    return loss, seen


PARITY_ROUTES = ({}, {"use_pallas_norm": True}, {"use_pallas_ce": True},
                 {"use_pallas_lse": True})


def parity_line(route, loss, grads, cpu_loss, cpu_grads, launches, s,
                loss_tol, grad_tol):
    rel = {k: float((grads[k] - g).norm() / g.norm())
           for k, g in cpu_grads.items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    return {"phase": "train_parity", "flags": route,
            "shape": [1, s], "card_loss": loss, "cpu_loss": cpu_loss,
            "loss_diff": abs(loss - cpu_loss), "loss_tolerance": loss_tol,
            "grad_rel_l2_max": worst[0][1],
            "grad_rel_l2_median": statistics.median(rel.values()),
            "grad_rel_l2_worst": worst, "grad_rel_tolerance": grad_tol,
            "params": len(rel), "launches": launches}


def train_parity(torch, base, amp, flags, counters, s=256):
    """One train step at (1, 256) from the same weights on the card (bf16,
    kernels, each LayerNorm and cross-entropy route; then f32, where the
    forward is kernel A and the backward C1) and on the CPU (f32, plain
    versions): the loss, and every parameter's gradient by its relative
    L2 error."""
    ids = np.random.default_rng(2).integers(0, base.config.vocab_size,
                                            (1, s))
    cpu_loss, cpu_grads = step_grads(
        torch, make_step(copy.deepcopy(base), device="cpu"),
        torch.as_tensor(ids))
    lines = []
    for route in PARITY_ROUTES:
        flags.set_flags(route)
        try:
            counters.reset()
            loss, grads = step_grads(
                torch, make_step(train_model(torch, base, amp)),
                torch.as_tensor(ids, device="cuda"))
            launches = counters.read()
        finally:
            flags.set_flags({k: False for k in route})
        line = parity_line(route, loss, grads, cpu_loss, cpu_grads, launches,
                           s, PARITY_LOSS_TOL, PARITY_GRAD_REL_TOL)
        emit(line)
        lines.append(line)
        on = {"layer_norm_bwd": "use_pallas_norm", "ce_fwd": "use_pallas_ce",
              "ce_bwd": "use_pallas_ce", "ce_lse": "use_pallas_lse"}
        if launches["flash_fwd_tc"] == 0 or launches["flash_bwd_dq"] == 0 \
                or launches["flash_bwd"] or any(
                    bool(launches[k]) != (flag in route) for k, flag in
                    on.items()):
            raise AssertionError("train_parity %r: kernels not on the path: "
                                 "%r" % (route, launches))
        if abs(loss - cpu_loss) > PARITY_LOSS_TOL or \
                line["grad_rel_l2_max"] > PARITY_GRAD_REL_TOL:
            raise AssertionError("train_parity %r: loss %g vs %g, worst "
                                 "grads %r" % (route, loss, cpu_loss,
                                               line["grad_rel_l2_worst"]))
    # f32 on the card: kernel A forward, C1 backward (the JAX rule at
    # S = 256), held to f32 summation-order limits
    counters.reset()
    loss, grads = step_grads(torch, make_step(copy.deepcopy(base).cuda()),
                             torch.as_tensor(ids, device="cuda"))
    launches = counters.read()
    line = parity_line({"dtype": "float32"}, loss, grads, cpu_loss,
                       cpu_grads, launches, s, PARITY_F32_LOSS_TOL,
                       PARITY_F32_GRAD_REL_TOL)
    emit(line)
    lines.append(line)
    layers = base.config.num_hidden_layers
    expect_launches(launches, {"flash_fwd": layers, "flash_bwd": layers,
                               "flash_fwd_tc": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}, "train_parity f32")
    if line["loss_diff"] > PARITY_F32_LOSS_TOL or \
            line["grad_rel_l2_max"] > PARITY_F32_GRAD_REL_TOL:
        raise AssertionError("train_parity f32: loss %g vs %g, worst grads "
                             "%r" % (loss, cpu_loss,
                                     line["grad_rel_l2_worst"]))
    return lines


# the serving loops each serve phase drives its traffic through: the
# default one (overlapped, each decode or verify step replayed from its
# captured CUDA graph) and the eager synchronous one, the A/B baseline
LOOPS = ("overlapped_captured", "sync_eager")


def run_loop(torch, engine, prompts, use_norm_kernel, counters, flags, loop,
             max_new=32):
    """``prompts`` through ``engine`` and the scheduler in ``loop``, greedy,
    ``max_new`` tokens each; launch counts from 0 just before the run,
    read just after.  In the captured loop the step is captured before
    the counts start (a capture inside the run fails).  B's launches are
    the kernel's own count on the card (eager and replayed); the
    wrapper's count holds the eager ones, so the replays' share is their
    difference.  Returns (results, scheduler, wall seconds, launches,
    the loop's fields of the phase's line)."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler, Request
    flags.set_flags({"use_pallas_norm": use_norm_kernel})
    overlapped = loop == LOOPS[0]
    # an engine captures only on a card (a CPU engine runs eagerly in
    # either loop: the CPU rehearsal of the serve phases)
    can_capture = engine._capture
    captured = overlapped and can_capture
    engine._capture = captured
    if captured:
        engine.capture_steps()
    engine.reset()
    engine.reseed(0)
    if engine.paged:
        engine.cow_copies = engine.pages_used_peak = 0
    sched = ContinuousBatchingScheduler(engine, overlap=overlapped)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=max_new,
                             temperature=0.0))
    torch.cuda.synchronize()
    g0 = engine.graph_stats()
    counters.reset()
    t0 = time.perf_counter()
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    on_device = counters.b_on_device()
    g1 = engine.graph_stats()
    flags.set_flags({"use_pallas_norm": False})
    engine._capture = can_capture
    steps = sched.decode_steps_total
    replays = g1["replays"] - g0["replays"]
    kind = "spec" if engine.spec_k else "decode"
    step_replays = (g1["by_kind"][kind]["replays"]
                    - g0["by_kind"][kind]["replays"])
    chunk_replays = (g1["by_kind"]["chunk"]["replays"]
                     - g0["by_kind"]["chunk"]["replays"])
    want_chunks = (sched.prefill_chunks_total
                   if captured and engine._capture_chunk else 0)
    by_wrapper = launches["layer_norm_fwd"]
    launches["layer_norm_fwd"] = on_device
    layers = engine.model.config.num_hidden_layers
    want_replayed = ((2 * layers + 1) * replays
                     if captured and use_norm_kernel else 0)
    if on_device - by_wrapper != want_replayed:
        raise AssertionError("%s: B counted %d launches on the card, %d "
                             "through its wrapper; %d replays want %d "
                             "more" % (loop, on_device, by_wrapper, replays,
                                       want_replayed))
    info = {"loop": loop, "overlap": sched.overlap,
            "host_gap_s": sched.host_gap_seconds,
            "host_gap_ms_per_step": 1e3 * sched.host_gap_seconds
            / max(steps, 1),
            "layer_norm_fwd_launches_by_wrapper": by_wrapper}
    if captured:
        if g1["captures"] != g0["captures"] or step_replays != steps or \
                chunk_replays != want_chunks:
            raise AssertionError("%s: %d captures inside the run, %d "
                                 "step replays for %d steps, %d chunk "
                                 "replays for %d chunks" % (
                                     loop, g1["captures"] - g0["captures"],
                                     step_replays, steps, chunk_replays,
                                     want_chunks))
        info.update(graph_replays=replays, chunk_replays=chunk_replays,
                    layer_norm_fwd_launches_note=(
                        "launches: B's own count on the card, eager and "
                        "replayed; by_wrapper: the eager ones"),
                    graph_captures=g1["captures"], graphs=g1["graphs"],
                    graph_pool_bytes=g1["pool_bytes"])
    return results, sched, wall, launches, info


def check_results(phase, results, prompts, max_new=32):
    if len(results) != len(prompts) or any(
            len(r.tokens) != max_new or r.finish_reason != "length"
            for r in results.values()):
        raise AssertionError("%s: unexpected results %r" % (phase, {
            k: (len(r.tokens), r.finish_reason)
            for k, r in results.items()}))


def p99(values):
    """The 99th percentile (nearest rank) of ``values``."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(0.99 * len(v)) - 1))]


def latency_fields(results, wall):
    toks = sum(len(r.tokens) for r in results.values())
    ttft = [r.ttft for r in results.values() if r.ttft > 0]
    tpot = [r.tpot for r in results.values()]
    return {"requests": len(results), "generated_tokens": toks,
            "wall_s": wall, "tokens_per_s": toks / wall,
            "ttft_p50_ms": 1e3 * statistics.median(ttft),
            "ttft_p99_ms": 1e3 * p99(ttft),
            "tpot_p50_ms": 1e3 * statistics.median(tpot),
            "tpot_p99_ms": 1e3 * p99(tpot)}


def serve(torch, engine, prompts, use_norm_kernel, counters, flags,
          phase="serve", extra=None, loop=LOOPS[0]):
    """The serve traffic through the slotted engine: the tensor-core
    forward once a layer an admission, B (2L + 1) times a forward under
    ``use_pallas_norm``, every request 32 tokens by length."""
    results, sched, wall, launches, info = run_loop(
        torch, engine, prompts, use_norm_kernel, counters, flags, loop)
    launches = {k: launches[k]
                for k in ("flash_fwd_tc", "flash_fwd", "layer_norm_fwd")}
    check_results(phase, results, prompts)
    layers = engine.model.config.num_hidden_layers
    admissions = len(prompts)
    if launches["flash_fwd_tc"] != layers * admissions or \
            launches["flash_fwd"]:
        raise AssertionError("flash_fwd_tc launched %d times, want %d x %d "
                             "(kernel A %d, want 0)"
                             % (launches["flash_fwd_tc"], layers, admissions,
                                launches["flash_fwd"]))
    forwards = admissions + sched.decode_steps_total
    want_ln = (2 * layers + 1) * forwards if use_norm_kernel else 0
    if launches["layer_norm_fwd"] != want_ln:
        raise AssertionError("layer_norm_fwd launched %d times, want %d"
                             % (launches["layer_norm_fwd"], want_ln))
    line = {
        "phase": phase, "use_pallas_norm": use_norm_kernel,
        "kv_dtype": kv_name(engine),
        "decode_steps": sched.decode_steps_total,
        **latency_fields(results, wall),
        "kv_pool_bytes": engine.kv_pool_bytes(),
        "kv_bytes_per_token": engine.kv_bytes_per_token(),
        "launches": launches, **info, **(extra or {})}
    emit(line)
    return line, [results[k].tokens for k in sorted(results)]


def both_loops(fn, *args, **kw):
    """``fn`` (serve or serve_paged) in the default loop, then in the eager
    synchronous one on the same traffic; emits the two side by side.
    Returns the default loop's (line, tokens)."""
    runs = {loop: fn(*args, loop=loop, **kw) for loop in LOOPS}
    (cap, cap_toks), (eager, eager_toks) = runs[LOOPS[0]], runs[LOOPS[1]]
    keys = ("tpot_p50_ms", "ttft_p50_ms", "tokens_per_s", "host_gap_s",
            "host_gap_ms_per_step", "decode_steps", "wall_s")
    emit({"phase": cap["phase"] + "_loops",
          "use_pallas_norm": cap["use_pallas_norm"],
          "kv_dtype": cap["kv_dtype"],
          "engine": cap.get("engine",
                            "paged" if "num_pages" in cap else "slotted"),
          "traffic": cap.get("traffic", "serve"),
          **{k: {loop: runs[loop][0][k] for loop in LOOPS} for k in keys},
          "layer_norm_fwd_launches": {
              loop: runs[loop][0]["launches"].get("layer_norm_fwd", 0)
              for loop in LOOPS},
          "same_greedy_tokens": all(
              np.array_equal(a, b) for a, b in zip(cap_toks, eager_toks))})
    return cap, cap_toks


# serve_paged_tight's pool: each request reaches 160 tokens (3 pages of
# 64, the first one shared), so 8 running requests need 17 pages once the
# shared page is registered; the first wave of 8 admits together and
# shares nothing, so this pool preempts, and every request still ends by
# length (smaller pools preempt some requests past max_preemptions)
TIGHT_PAGES = 17


def serve_paged(torch, engine, prompts, use_norm_kernel, counters, flags,
                phase="serve_paged", traffic="serve", extra=None,
                loop=LOOPS[0]):
    """The serve traffic (or another, named by ``traffic``) through the
    paged engine and the scheduler's chunked prefill in ``loop``: B
    (2L + 1) times a forward (prefill chunks and decode or verify steps)
    under ``use_pallas_norm``, no flash kernel (paged attention is plain
    torch, as in the JAX package), every request 32 tokens by length.  A
    speculative engine's line adds its drafts proposed and accepted; in
    the synchronous loop they equal the requests' sums, in the
    overlapped one the engine's count the stale steps too."""
    results, sched, wall, launches, info = run_loop(
        torch, engine, prompts, use_norm_kernel, counters, flags, loop)
    check_results(phase, results, prompts)
    layers = engine.model.config.num_hidden_layers
    forwards = sched.prefill_chunks_total + sched.decode_steps_total
    want = {k: 0 for k in launches}
    want["layer_norm_fwd"] = ((2 * layers + 1) * forwards
                              if use_norm_kernel else 0)
    expect_launches(launches, want, phase)
    line = {
        "phase": phase, "traffic": traffic,
        "use_pallas_norm": use_norm_kernel,
        "kv_dtype": kv_name(engine), "spec_k": engine.spec_k,
        "num_pages": engine.num_pages, "page_size": engine.page_size,
        "prefill_chunk": engine.prefill_chunk,
        "decode_steps": sched.decode_steps_total,
        "prefill_chunks": sched.prefill_chunks_total,
        **latency_fields(results, wall),
        "prefix_hit_tokens": sum(r.prefix_hit_tokens
                                 for r in results.values()),
        "prefix_hit_pages": sched.prefix_hit_pages,
        "cow_copies": engine.cow_copies,
        "peak_pages_used": engine.pages_used_peak,
        "preemptions": sched.preemptions_total,
        "kv_pool_bytes": engine.kv_pool_bytes(),
        "kv_bytes_per_token": engine.kv_bytes_per_token(),
        "launches": {k: v for k, v in launches.items() if v}, **info}
    if engine.spec_k:
        st = engine.spec_stats
        line.update(verify_steps=st["steps"],
                    drafts_proposed=st["proposed"],
                    drafts_accepted=st["accepted"],
                    accept_rate=st["accepted"] / max(st["proposed"], 1),
                    accepted_per_step=st["accepted"] / max(st["steps"], 1))
        sums = (sum(r.spec_proposed for r in results.values()),
                sum(r.spec_accepted for r in results.values()))
        exact = not sched.overlap
        if st["steps"] != sched.decode_steps_total or (
                sums != (st["proposed"], st["accepted"]) if exact
                else sums[0] > st["proposed"]):
            raise AssertionError("%s: requests' draft counts %r, engine's "
                                 "%r" % (phase, sums, st))
    line.update(extra or {})
    emit(line)
    return line, [results[k].tokens for k in sorted(results)]


def kv_name(engine):
    """The engine's code dtype by name ("int8", "float8_e4m3fn"), or None
    for an unquantized pool."""
    return None if engine.kv_dtype is None else \
        str(engine.kv_dtype).replace("torch.", "")


def max_err(a, b):
    """The largest absolute difference over two lists of logits."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def paged_script(prompt, steps=4):
    """paged_parity's script for an engine: request A (100 tokens, two
    chunks) into slot 0; request B, A's first 64 tokens and 40 of its
    own, into slot 1, whose chunk attends A's page 0, which it did not
    compute; request C, A again once A's prefill is done, into slot 2: it
    maps A's full page and its live, partly filled tail page (99 tokens,
    capped at n - 1), so its one 1-token chunk copies that page first (one
    copy-on-write); then ``steps`` decode steps of the three, fed
    ``inputs`` or, where None, the engine's own greedy tokens.  Returns
    (logits at each point on the host, the tokens fed, what the
    admissions shared)."""
    own = np.random.default_rng(5).integers(0, 50257, (40,)).astype(np.int32)
    reqs = [prompt[:100], np.concatenate([prompt[:64], own]), prompt[:100]]

    def run(torch, eng, inputs=None):
        n = eng.num_slots
        active = [i < len(reqs) for i in range(n)]
        eng.reset()
        eng.cow_copies = 0
        pre, shared = [], []
        for i, ids in enumerate(reqs):
            task = eng.prefill_begin(i, ids, temperature=0.0)
            while not eng.prefill_step(task):
                pass
            pre.append(task.last_logits.float())
            shared.append(task.shared_tokens)
        toks = np.zeros(n, np.int32)
        toks[:len(reqs)] = [int(lg.argmax()) for lg in pre]
        logits, fed = [torch.stack(pre).cpu()], []
        for s in range(steps):
            feed = toks if inputs is None else inputs[s]
            fed.append(feed)
            toks, lg = eng.decode(feed, active, [0.0] * n, [0] * n,
                                  [1.0] * n)
            logits.append(lg[:len(reqs)].float().cpu())
        if shared != [0, 64, 99] or eng.cow_copies != 1:
            raise AssertionError("paged script: shared %r, cow copies %d"
                                 % (shared, eng.cow_copies))
        return logits, fed, {"prompt_lens": [len(r) for r in reqs],
                             "shared_tokens": shared,
                             "cow_copies": eng.cow_copies}
    return run


def slotted_script(prompts, steps=4):
    """decode_parity's script for a slotted engine: every slot prefilled
    with a prompt of its own length (128 down to 100 tokens), then
    ``steps`` batched decode steps fed ``inputs`` or, where None, the
    engine's own greedy tokens."""
    def run(torch, eng, inputs=None):
        n = eng.num_slots
        ctx = [prompts[i][:128 - 4 * i] for i in range(n)]
        eng.reset()
        toks, pre = np.zeros(n, np.int32), []
        for i, c in enumerate(ctx):
            toks[i], lg = eng.prefill(i, c, temperature=0.0)
            pre.append(lg.float())
        logits, fed = [torch.stack(pre).cpu()], []
        for s in range(steps):
            feed = toks if inputs is None else inputs[s]
            fed.append(feed)
            toks, lg = eng.decode(feed, [True] * n, [0.0] * n, [0] * n,
                                  [1.0] * n)
            logits.append(lg.float().cpu())
        return logits, fed, {"prompt_lens": [len(c) for c in ctx]}
    return run


# quant_parity's floor: the card's quantized engine must move the logits
# away from the card's unquantized one by at least this share of what
# quantization moves them on the CPU in f32 (both fed the same tokens).
# An engine that kept bf16 K/V would move them by 0, while the bar on
# logits alone cannot tell it: quantization moves them by less than the
# card's bf16 error does; see PERF.md
QUANT_SHIFT_FLOOR = 0.5


def card_vs_cpu(torch, engine, cpu_model, script, flags, norm_cuda, phase,
                cpu_kw, exact=None, reuse=None):
    """``script`` on the port's CPU f32 engine (the card engine's layout
    and ``kv_dtype``, ``cpu_kw`` for the rest), then on the card's
    engine (bf16, kernels) fed the CPU's greedy tokens, once per
    LayerNorm route: logits held within LOGIT_TOL at every point, B
    launched under ``use_pallas_norm`` and only there.  ``exact`` is
    what this returned for the same script on the unquantized engines:
    then the CPU engine is fed the same tokens, and the card's quantized
    logits must lie at least QUANT_SHIFT_FLOOR of the CPU's quantization
    shift away from the card's unquantized ones.  ``reuse``, what this
    returned for the same script and engine layout, spares the CPU run:
    its CPU logits and tokens are taken.  Returns {"cpu": logits,
    "inputs": tokens fed, "card": {route: logits}}."""
    from paddle_tpu_torch.serving import DecodeEngine
    if reuse is not None:
        cpu, inputs = reuse["cpu"], reuse["inputs"]
    else:
        cpu_engine = DecodeEngine(cpu_model, num_slots=engine.num_slots,
                                  max_len=engine.max_len, device="cpu",
                                  kv_dtype=engine.kv_dtype, **cpu_kw)
        cpu, inputs, _ = script(torch, cpu_engine,
                                None if exact is None else exact["inputs"])
        del cpu_engine
    out = {"cpu": cpu, "inputs": inputs, "card": {}}

    def b_count():
        # on a card B's own count: a captured chunk or step replays B
        # without its wrapper
        if engine.device.type == "cuda":
            return norm_cuda.layer_norm_fwd_device_launches()
        return norm_cuda.layer_norm_fwd_launches
    for use_norm in (False, True):
        flags.set_flags({"use_pallas_norm": use_norm})
        ln_before = b_count()
        try:
            card, _, info = script(torch, engine, inputs)
        finally:
            flags.set_flags({"use_pallas_norm": False})
        ln_launched = b_count() - ln_before
        errs = [float((c - r).abs().max()) for c, r in zip(card, cpu)]
        line = {"phase": phase, "use_pallas_norm": use_norm,
                "engine": "paged" if engine.paged else "slotted",
                "step": "captured" if engine._capture else "eager",
                "kv_dtype": kv_name(engine), **info,
                "decode_steps": len(inputs), "max_abs_err_prefill": errs[0],
                "max_abs_err_per_step": errs[1:], "tolerance": LOGIT_TOL,
                "layer_norm_fwd_launches": ln_launched}
        floor = None
        if exact is not None:
            cpu_shift = max_err(cpu, exact["cpu"])
            floor = QUANT_SHIFT_FLOOR * cpu_shift
            line.update(
                quant_shift_cpu=cpu_shift,
                quant_shift_card=max_err(card, exact["card"][use_norm]),
                quant_shift_floor=floor,
                # the control: the card's unquantized engine held against
                # this CPU quantized one, by the bar on logits alone
                control_unquantized_card_err=max_err(
                    exact["card"][use_norm], cpu))
        emit(line)
        if max(errs) > LOGIT_TOL:
            raise AssertionError("%s %s (use_pallas_norm=%s): card vs CPU "
                                 "logits err %g > %g"
                                 % (phase, line["engine"], use_norm,
                                    max(errs), LOGIT_TOL))
        if bool(ln_launched) != use_norm:
            raise AssertionError("%s: layer_norm_fwd launched %d times with "
                                 "use_pallas_norm=%s"
                                 % (phase, ln_launched, use_norm))
        if floor is not None and not line["quant_shift_card"] >= floor > 0:
            raise AssertionError("%s %s %s: quantization moved the card's "
                                 "logits by %g, the CPU's by %g"
                                 % (phase, line["engine"], line["kv_dtype"],
                                    line["quant_shift_card"], cpu_shift))
        out["card"][use_norm] = card
    engine.reset()
    return out


def serve_compare(torch, cpu_model, prompts, toks_a, toks_b,
                  what="layer_norm_routes"):
    """Where the greedy tokens of two card runs of one traffic part (the
    two LayerNorm routes; paged and slotted; a tight pool and a roomy
    one): for each request that parts, the first step, the two tokens,
    and the gap between them in the CPU's f32 logits at that step.  Both
    runs hold within LOGIT_TOL of the CPU (decode_parity, paged_parity),
    so rounding can part them only where that gap is below 2 * LOGIT_TOL;
    a wider gap fails."""
    parts = []
    for i, (a, b) in enumerate(zip(toks_a, toks_b)):
        diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if diff.size == 0:
            continue
        j = int(diff[0])
        ctx = np.concatenate([prompts[i], np.asarray(a[:j], np.int32)])
        with torch.no_grad():
            lg = cpu_model(torch.as_tensor(ctx[None]))[0, -1]
        top2 = torch.topk(lg, 2).values
        parts.append({"request": i, "step": j,
                      "tokens": [int(a[j]), int(b[j])],
                      "cpu_gap": abs(float(lg[int(a[j])] - lg[int(b[j])])),
                      "cpu_top2_margin": float(top2[0] - top2[1])})
    emit({"phase": "serve_compare", "compared": what,
          "same_greedy_tokens": not parts, "parted": parts,
          "gap_limit": 2 * LOGIT_TOL})
    wide = [p for p in parts if p["cpu_gap"] >= 2 * LOGIT_TOL]
    if wide:
        raise AssertionError("%s part where the CPU's gap is wide: %r"
                             % (what, wide))


# the mark kernel of a trace (``torch.cuda._sleep``, ~5 us)
TRACE_MARK_CYCLES = 10_000


def traced_after_mark(torch, prof):
    """The device events of a ``torch.profiler`` trace that start after
    its one mark kernel (``torch.cuda._sleep``'s ``spin_kernel``), or
    None when the trace lost the mark.  On the H100 machine a trace can
    lose the records of the first kernels it sees, more of them the
    longer the process has run (none at 19 s, 3 at 61 s, 10 at 151 s, now
    and then a whole step), while the later steps of the same trace come
    whole (``tools/torch_trace_loss_probe.py``).  So a counted trace runs
    one step before its mark and reads only what follows it."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.start for e in dev if "spin_kernel" in e.name]
    if len(marks) != 1:
        return None
    return [e for e in dev if e.time_range.start > marks[0]]


def decode_profile(torch, engine, use_norm_kernel, flags, steps=5,
                   emit_line=True):
    """Wall time of a batched decode step (all 8 slots active, host clock
    around a synchronised step) beside the card's kernel time in it
    (profiler trace): the device's busy share of a step, for the step
    replayed from its captured graph (the line's top-level fields) and
    for the eager step (``eager``).  A paged engine maps the pages its
    appends need as it goes; a speculative one runs verify steps
    (``spec_k`` drafts a slot).  B's launches a traced step, by the
    trace and by the kernel's own count on the card: 2L + 1 under
    ``use_pallas_norm``, else 0 (the trace's count is held when the trace
    holds kernels at all).  Only the steps after the trace's mark are
    read (``traced_after_mark``)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import norm_cuda
    flags.set_flags({"use_pallas_norm": use_norm_kernel})
    layers = engine.model.config.num_hidden_layers
    want_b = 2 * layers + 1 if use_norm_kernel else 0
    n = engine.num_slots
    args = (np.zeros(n, np.int32), [True] * n, [0.0] * n, [0] * n,
            [1.0] * n)
    drafts = np.ones((n, engine.spec_k), np.int32)

    def step():
        if engine.spec_k:
            engine.decode_spec(args[0], drafts, *args[1:])
        else:
            engine.decode(*args)

    def measure():
        step()                 # a first captured call captures the step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step()         # the lead-in, before the mark: not counted
                torch.cuda.synchronize()
                norm_cuda.layer_norm_fwd_device_launches(reset=True)
                torch.cuda._sleep(TRACE_MARK_CYCLES)
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
            b_device = norm_cuda.layer_norm_fwd_device_launches() / steps
            ran = traced_after_mark(torch, prof)
            if ran is not None:
                break
        dev_us = sum(e.time_range.elapsed_us() for e in ran or ())
        kernels = len(ran or ())
        b_traced = (sum("layer_norm_fwd" in e.name for e in ran) / steps
                    if kernels else None)
        if b_device != want_b or b_traced not in (None, want_b):
            raise AssertionError("decode_profile: B %r a step by the trace, "
                                 "%r on the card, want %d" % (
                                     b_traced, b_device, want_b))
        return {"layer_norm_fwd_per_step_by_profiler": b_traced,
                "layer_norm_fwd_per_step_on_device": b_device,
                "step_wall_ms": wall_ms,
                "step_device_ms": dev_us / steps / 1e3 if dev_us else None,
                "device_kernels_per_step": kernels / steps,
                "device_busy_share": (dev_us / steps / 1e3 / wall_ms
                                      if dev_us else None)}
    try:
        captured = measure()
        engine._capture = False
        eager = measure()
    finally:
        engine._capture = True
        flags.set_flags({"use_pallas_norm": False})
    line = {"phase": "decode_profile", "use_pallas_norm": use_norm_kernel,
            "engine": "paged" if engine.paged else "slotted",
            "step": "verify" if engine.spec_k else "decode",
            "spec_k": engine.spec_k, "loop": "captured", **captured,
            "eager": eager,
            "captured_wall_share_of_eager": (captured["step_wall_ms"]
                                             / eager["step_wall_ms"])}
    if emit_line:
        emit(line)
    return line


# drafts a verify step in the speculative phases
SPEC_K = 4


def span_prompts(vocab, n=12, span=32, times=4, seed=2):
    """The repeated-span traffic: ``n`` prompts of ``span * times`` tokens,
    each a random ``span``-token span said ``times`` times, so that
    prompt lookup finds drafts in every prompt."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, (span,)), times).astype(np.int32)
            for _ in range(n)]


def serve_spec(torch, spec_engine, paged_engine, cpu_model, traffic,
               plain_runs, counters, flags):
    """The paged engine with ``spec_k`` drafts through the scheduler, each
    LayerNorm route, on each traffic of ``traffic`` ({name: prompts}):
    ``serve_paged``'s counts and checks (B (2L + 1) times a prefill chunk
    or verify step under ``use_pallas_norm``) plus drafts proposed and
    accepted, in the default loop and the eager synchronous one.
    ``plain_runs[(name, route)]`` holds the plain paged engine's tokens
    on that traffic (run here, default loop, for traffic it lacks);
    where spec and plain greedy tokens part, the CPU's logit gap must be
    small (``serve_compare``).  Then the wall and device ms of one verify
    step beside a plain paged decode step, each route.  Fails if the
    repeated-span traffic accepted no draft.  Returns the lines and the
    default loop's tokens, both by (traffic, route)."""
    lines, tokens = {}, {}
    for name, prompts in traffic.items():
        for use_norm in (False, True):
            if (name, use_norm) not in plain_runs:
                plain_runs[(name, use_norm)] = serve_paged(
                    torch, paged_engine, prompts, use_norm, counters, flags,
                    phase="serve_paged_" + name, traffic=name)[1]
            line, toks = both_loops(serve_paged, torch, spec_engine,
                                    prompts, use_norm, counters, flags,
                                    phase="serve_spec", traffic=name)
            lines[(name, use_norm)] = line
            tokens[(name, use_norm)] = toks
            serve_compare(torch, cpu_model, prompts,
                          plain_runs[(name, use_norm)], toks,
                          "spec_vs_plain_paged_%s%s" % (
                              name, "_use_pallas_norm" if use_norm else ""))
    if min(lines[("span", r)]["drafts_accepted"] for r in (False, True)) < 1:
        raise AssertionError("serve_spec: no draft accepted on the "
                             "repeated-span traffic")
    for use_norm in (False, True):
        plain = decode_profile(torch, paged_engine, use_norm, flags,
                               emit_line=False)
        verify = decode_profile(torch, spec_engine, use_norm, flags,
                                emit_line=False)
        emit({"phase": "serve_spec_profile", "use_pallas_norm": use_norm,
              "spec_k": spec_engine.spec_k, "verify_step": verify,
              "plain_paged_step": plain})
    paged_engine.reset()
    spec_engine.reset()
    return lines, tokens


def spec_parity(torch, spec_engine, paged_engine, prompts, flags, counters,
                steps=SPEC_K + 1):
    """The verify step's logits at each of its ``spec_k + 1`` positions
    against sequential paged decode steps fed the same tokens, on the
    card (bf16 both), within LOGIT_TOL; once per LayerNorm route.  Every
    slot holds a prompt of its own length (128 down to 100 tokens); the
    drafts are the sequential engine's greedy tokens.  B must launch on
    the verify step under ``use_pallas_norm``: 2L + 1 times in the
    replay of its captured graph, by the kernel's own count on the
    card."""
    n = spec_engine.num_slots
    ctx = [prompts[i][:128 - 4 * i] for i in range(n)]
    greedy = ([True] * n, [0.0] * n, [0] * n, [1.0] * n)
    lines = []
    for use_norm in (False, True):
        flags.set_flags({"use_pallas_norm": use_norm})
        spec_engine.capture_steps()
        paged_engine.reset()
        spec_engine.reset()
        first = np.asarray([paged_engine.prefill(i, c, temperature=0.0)[0]
                            for i, c in enumerate(ctx)], np.int32)
        fed, seq = [first], []
        for _ in range(steps):
            toks, lg = paged_engine.decode(fed[-1], *greedy)
            seq.append(lg.float())
            fed.append(np.asarray(toks, np.int32))
        for i, c in enumerate(ctx):
            spec_engine.prefill(i, c, temperature=0.0)
        drafts = np.stack(fed[1:steps], axis=1)
        torch.cuda.synchronize()
        g0 = spec_engine.graph_stats()
        counters.reset()
        _e, counts, lg = spec_engine.decode_spec(first, drafts, *greedy)
        torch.cuda.synchronize()
        launched = counters.read()
        on_device = counters.b_on_device()
        g1 = spec_engine.graph_stats()
        replays = g1["replays"] - g0["replays"]
        # the verify step replays its graph: the wrapper sees none of its
        # B launches, the kernel's own count on the card sees them all
        if replays != 1 or g1["captures"] != g0["captures"] or \
                launched["layer_norm_fwd"]:
            raise AssertionError("spec_parity: %d replays, %d captures, %d "
                                 "B launches through the wrapper" % (
                                     replays, g1["captures"] -
                                     g0["captures"],
                                     launched["layer_norm_fwd"]))
        launched["layer_norm_fwd"] = on_device
        flags.set_flags({"use_pallas_norm": False})
        errs = [float((lg[:, j].float() - seq[j]).abs().max())
                for j in range(steps)]
        layers = spec_engine.model.config.num_hidden_layers
        want = {k: 0 for k in launched}
        want["layer_norm_fwd"] = 2 * layers + 1 if use_norm else 0
        expect_launches(launched, want, "spec_parity")
        line = {"phase": "spec_parity", "use_pallas_norm": use_norm,
                "spec_k": spec_engine.spec_k,
                "prompt_lens": [len(c) for c in ctx],
                "max_abs_err_per_position": errs, "tolerance": LOGIT_TOL,
                "counts": counts.tolist(), "graph_replays": replays,
                "launches": {k: v for k, v in launched.items() if v}}
        emit(line)
        lines.append(line)
        if max(errs) > LOGIT_TOL:
            raise AssertionError("spec_parity (use_pallas_norm=%s): verify "
                                 "vs sequential logits err %g > %g"
                                 % (use_norm, max(errs), LOGIT_TOL))
    paged_engine.reset()
    spec_engine.reset()
    return lines


def serve_quant(torch, model, prompts, bf16_row_bytes, vocab, counters,
                flags, seed=0):
    """The serve traffic under ``use_pallas_norm`` through the paged int8,
    paged fp8, slotted int8 and paged int8 + ``SPEC_K`` drafts engines,
    in the default loop and the eager synchronous one: pool bytes, bytes
    a token, TTFT and TPOT, then the wall and device ms of one decode (or
    verify) step, captured and eager; a 1-byte row is (D + 4) / (2 D)
    of the bf16 one, and the pools on the card hold it: 1-byte codes of
    the engine's ``kv_dtype``, f32 scale pools of one scale a (row,
    head), their bytes the row's times the rows allocated; every token id
    in range.  Returns the lines, the paged int8, paged fp8 and slotted
    int8 engines (for quant_parity) and the default loop's tokens, all by
    engine name."""
    from paddle_tpu_torch.serving import DecodeEngine
    cases = (("paged_int8", dict(kv_dtype="int8")),
             ("paged_fp8", dict(kv_dtype="fp8")),
             ("slotted_int8", dict(kv_dtype="int8", paged=False)),
             ("paged_int8_spec", dict(kv_dtype="int8", spec_k=SPEC_K)))
    lines, keep, tokens = {}, {}, {}
    d = model.config.hidden_size // model.config.num_attention_heads
    for name, kw in cases:
        eng = DecodeEngine(model, num_slots=8, max_len=1024, seed=seed,
                           **kw)
        if eng.kv_row_bytes() * 2 * d != bf16_row_bytes * (d + 4):
            raise AssertionError("serve_quant %s: row %d bytes, bf16 %d"
                                 % (name, eng.kv_row_bytes(),
                                    bf16_row_bytes))
        c = eng.cache
        pools = (c.k, c.v, c.k_scale, c.v_scale)
        resident = sum(t.numel() * t.element_size() for t in pools)
        rows = int(c.k.shape[0]) * int(c.k.shape[2])
        if (c.k.dtype, c.v.dtype) != (eng.kv_dtype,) * 2 or \
                c.k.element_size() != 1 or \
                {t.dtype for t in pools[2:]} != {torch.float32} or \
                any(t.shape != c.k.shape[:-1] for t in pools[2:]) or \
                resident != rows * eng.kv_row_bytes():
            raise AssertionError("serve_quant %s: pools %r, %d bytes for %d "
                                 "rows of %d" % (name, [
                                     (t.dtype, tuple(t.shape)) for t in pools],
                                     resident, rows, eng.kv_row_bytes()))
        eng.prefill(0, prompts[0], temperature=0.0)
        eng.reset()
        extra = {"engine": name, "row_bytes": eng.kv_row_bytes(),
                 "row_share_of_bf16": eng.kv_row_bytes() / bf16_row_bytes,
                 # the pools on the card, the sink page included
                 "pool_bytes_allocated": resident}
        line, toks = both_loops(serve_paged if eng.paged else serve, torch,
                                eng, prompts, True, counters, flags,
                                phase="serve_quant", extra=extra)
        lines[name], tokens[name] = line, toks
        for t in toks:
            if not (0 <= int(t.min()) and int(t.max()) < vocab):
                raise AssertionError("serve_quant %s: token ids out of "
                                     "range" % name)
        emit({"phase": "serve_quant_profile", "engine": name,
              "step": decode_profile(torch, eng, True, flags,
                                     emit_line=False)})
        if name != "paged_int8_spec":
            eng.reset()
            keep[name] = eng
        del eng
        torch.cuda.empty_cache()
    return lines, keep, tokens


def first_parting(ref, got):
    """(request, position) of the first token where two runs' greedy
    tokens part, or None."""
    for r, (a, b) in enumerate(zip(ref, got)):
        diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if diff.size:
            return r, int(diff[0])
    return None


def logit_gap(torch, model_a, model_b, prompt, tokens, pos):
    """The largest gap between two models' last-position logits (a plain
    forward on the card) over ``prompt`` and the first ``pos`` tokens
    the runs agreed on."""
    ids = torch.as_tensor(np.concatenate([prompt, tokens[:pos]])[None]
                          .astype(np.int64),
                          device=next(model_a.parameters()).device)
    with torch.no_grad():
        a = model_a(ids)[0, -1].float()
        b = model_b(ids)[0, -1].float()
    return float((a - b).abs().max())


SCAN_ENGINES = (("paged", {}, LOOPS[0]), ("paged", {}, LOOPS[1]),
                ("slotted", dict(paged=False), LOOPS[0]),
                ("spec", dict(spec_k=SPEC_K), LOOPS[0]),
                ("paged_int8", dict(kv_dtype="int8"), LOOPS[0]))


def serve_scan(torch, scan_model, model, prompts, refs, profile_ref,
               counters, flags, device="cuda"):
    """The serve traffic under ``use_pallas_norm`` through engines on the
    scan-layers model ``scan_model`` (the serve model's weights stacked):
    the paged engine in the default loop and the eager synchronous one,
    the slotted engine, the paged engine with SPEC_K drafts and the paged
    int8 engine.  Every run's greedy tokens equal the per-layer engine's
    on the same traffic (``refs[name]`` = its default loop's (line,
    tokens)), and in the default loop B's own count on the card equals
    that run's.  Then the wall and device ms of one captured paged decode
    step beside the per-layer engine's (``profile_ref``).  Where tokens
    part, the phase fails naming the first parting step and the largest
    logit gap there between the two models."""
    from paddle_tpu_torch.serving import DecodeEngine
    engines, runs, bad = {}, [], []
    for name, kw, loop in SCAN_ENGINES:
        eng = engines.get(name)
        if eng is None:
            eng = engines[name] = DecodeEngine(scan_model, num_slots=8,
                                               max_len=1024, seed=0,
                                               device=device, **kw)
            eng.prefill(0, prompts[0], temperature=0.0)
            eng.reset()
        line, toks = (serve_paged if eng.paged else serve)(
            torch, eng, prompts, True, counters, flags, phase="serve_scan",
            extra={"engine": name + "_scan"}, loop=loop)
        ref_line, ref_toks = refs[name]
        part = first_parting(ref_toks, toks)
        b, b_ref = (line["launches"]["layer_norm_fwd"],
                    ref_line["launches"]["layer_norm_fwd"])
        run = {"engine": name, "loop": loop,
               "same_greedy_tokens": part is None, "first_parting": part,
               "layer_norm_fwd_launches": b,
               "per_layer_layer_norm_fwd_launches": b_ref,
               "flash_fwd_tc_launches": line["launches"].get(
                   "flash_fwd_tc", 0),
               "tokens_per_s": line["tokens_per_s"],
               "per_layer_tokens_per_s": ref_line["tokens_per_s"],
               "tpot_p50_ms": line["tpot_p50_ms"],
               "per_layer_tpot_p50_ms": ref_line["tpot_p50_ms"]}
        if part is not None:
            r, pos = part
            run["logit_gap"] = logit_gap(torch, scan_model, model,
                                         prompts[r], ref_toks[r], pos)
            bad.append(run)
        elif loop == LOOPS[0] and b != b_ref:
            bad.append(run)
        runs.append(run)
    profile = decode_profile(torch, engines["paged"], True, flags,
                             emit_line=False)
    keys = ("step_wall_ms", "step_device_ms", "device_busy_share")
    line = {"phase": "serve_scan_parity", "runs": runs,
            "decode_step": {
                "scan": {k: profile[k] for k in keys},
                "per_layer": {k: profile_ref[k] for k in keys},
                "scan_eager": {k: profile["eager"][k] for k in keys},
                "per_layer_eager": {k: profile_ref["eager"][k]
                                    for k in keys}}}
    emit(line)
    del engines
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("serve_scan: runs part from the per-layer "
                             "engines' %r" % (bad,))
    return line


def overlap_parity(torch, engine, cpu_model, script, prompts, parity, flags,
                   norm_cuda, counters):
    """The captured overlapped loop against the eager synchronous one on
    the card, both engines' own prompts (12 of 128 unrelated tokens, 32
    new each), each LayerNorm route: identical greedy tokens, or the
    phase fails.  Then both steps against the CPU: ``parity`` is what
    card_vs_cpu returned for ``script`` on this engine, its steps
    captured (decode_parity, paged_parity); the script runs again with
    the eager step, held to the same CPU logits within LOGIT_TOL, and
    the two card runs' logits are compared (0: the captured step is the
    eager step bit for bit)."""
    toks = {}
    for use_norm in (False, True):
        for loop in LOOPS:
            results = run_loop(torch, engine, prompts, use_norm, counters,
                               flags, loop)[0]
            toks[(use_norm, loop)] = [results[k].tokens.tolist()
                                      for k in sorted(results)]
    engine._capture = False
    try:
        eager = card_vs_cpu(torch, engine, cpu_model, script, flags,
                            norm_cuda, "overlap_parity", {}, reuse=parity)
    finally:
        engine._capture = True
    line = {"phase": "overlap_parity",
            "engine": "paged" if engine.paged else "slotted",
            "requests": len(prompts),
            "same_greedy_tokens": {
                "use_pallas_norm" if r else "default":
                    toks[(r, LOOPS[0])] == toks[(r, LOOPS[1])]
                for r in (False, True)},
            "captured_vs_eager_logits_max_abs_diff": {
                "use_pallas_norm" if r else "default": max_err(
                    parity["card"][r], eager["card"][r])
                for r in (False, True)},
            "tolerance_vs_cpu": LOGIT_TOL}
    emit(line)
    if not all(line["same_greedy_tokens"].values()):
        raise AssertionError("overlap_parity %s: the captured overlapped "
                             "loop's greedy tokens differ from the eager "
                             "synchronous loop's" % line["engine"])
    return line, toks


# the serve_http phase: the HTTP front end (serving.frontend) and the
# load harness (serving.loadgen) over each engine, the default loop
HTTP_TIMEOUT = 120.0          # seconds: every socket and wait of the phase
HTTP_LOAD = {"qps": 4.0, "n_requests": 32, "seed": 0,
             "mix": ((64, 512), (16, 64))}
HTTP_SHED_LIMIT, HTTP_SHED_BURST = 2, 8
HTTP_CUT_AT = 3               # the SSE event the disconnect check cuts


def http_request(host, port, method, path, payload=None, on_event=None,
                 timeout=HTTP_TIMEOUT):
    """One HTTP/1.1 request over a fresh socket, read to the server's
    close.  Returns (status, body): SSE events (a list of dicts) for an
    event stream, else the JSON document.  ``on_event`` sees each SSE
    event as it arrives."""
    import socket
    body = b"" if payload is None else json.dumps(payload).encode()
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(b"%s %s HTTP/1.1\r\nHost: smoke\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n"
                  % (method.encode(), path.encode(), len(body)) + body)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
            if on_event is not None and b"\n\n" in buf:
                on_event()
    head, _, rest = buf.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if b"text/event-stream" in head:
        return status, sse_events(rest)
    return status, json.loads(rest) if rest else None


def sse_events(body):
    """The ``data:`` events of an SSE body, in order."""
    return [json.loads(line[6:]) for line in body.split(b"\n\n")
            if line.startswith(b"data: ")]


def done_event(events):
    """The stream's final ``done`` event, or None for a cut stream."""
    done = [e for e in events if e.get("done")]
    return done[0] if done else None


def post_all(host, port, payloads, on_event=None, gap=0.0):
    """POST every payload at once (a thread each; ``gap`` seconds between
    their starts), streamed; returns [(status, events)] in payload
    order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(payloads)) as pool:
        futures = []
        for i, p in enumerate(payloads):
            if gap and i:
                time.sleep(gap)
            futures.append(pool.submit(http_request, host, port, "POST",
                                       "/v1/generate", dict(p, stream=True),
                                       on_event))
        return [f.result(timeout=HTTP_TIMEOUT) for f in futures]


def greedy_payloads(prompts, max_new):
    return [{"prompt": [int(t) for t in p], "max_new_tokens": max_new,
             "temperature": 0.0} for p in prompts]


def wait_until(pred, what, timeout=HTTP_TIMEOUT):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("serve_http: timed out waiting for %s"
                                 % what)
        time.sleep(0.01)


def idle_pool(engine, sched):
    """(slots occupied, pages mapped, pages with a reference) once the
    scheduler holds nothing: all zero when every slot and page came back
    refcount-exact."""
    pages = ((engine._alloc.pages_used(),
              int((engine._alloc.refcount != 0).sum()))
             if engine.paged else (0, 0))
    return (sum(a is not None for a in sched.slots),) + pages


def http_frontend(engine, tracer, **kw):
    """A started front end over ``engine``, reset first: an earlier run's
    prefix cache would turn a full prompt into a 1-token chunk, whose
    bf16 logits may part from the in-process run's 64-token chunk."""
    from paddle_tpu_torch.serving import ServingFrontend
    engine.reset()
    fe = ServingFrontend(engine, tracer=tracer, **kw)
    fe.start()
    return fe


def http_shed(engine, tracer, prompts, registry):
    """A burst over ``queue_limit``: 429s, each counted by
    ``serving.shed_total``, and only the admitted requests reach the
    scheduler."""
    shed0 = registry.counter("serving.shed_total").value
    fe = http_frontend(engine, tracer, queue_limit=HTTP_SHED_LIMIT)
    try:
        replies = post_all(fe.host, fe.port, greedy_payloads(
            prompts[:HTTP_SHED_BURST], 8))
    finally:
        fe.stop()
    statuses = [st for st, _ in replies]
    admitted = statuses.count(200)
    out = {"queue_limit": HTTP_SHED_LIMIT, "burst": HTTP_SHED_BURST,
           "status_429": statuses.count(429), "status_200": admitted,
           "shed_total": registry.counter("serving.shed_total").value
           - shed0,
           "scheduler_requests": len(fe.scheduler.finished)}
    if (out["status_429"] < 1 or admitted + out["status_429"]
            != HTTP_SHED_BURST or out["shed_total"] != out["status_429"]
            or out["scheduler_requests"] != admitted
            or any(done_event(ev) is None for st, ev in replies
                   if st == 200)):
        raise AssertionError("serve_http shed: %r" % out)
    return out


def http_disconnect(engine, tracer, prompts, ref, registry, max_new):
    """A ``SocketReset`` at the ``serve.stream`` site cuts one stream:
    its slot and pages come back refcount-exact, counted 499, and the
    other requests' tokens are the in-process run's."""
    from paddle_tpu_torch.robustness import FaultPlan, chaos
    from paddle_tpu_torch.robustness.faultpoints import SocketReset
    c499 = registry.counter("serving.http_requests",
                            ("code",)).labels(code="499")
    before = c499.value
    fe = http_frontend(engine, tracer)
    base = idle_pool(engine, fe.scheduler)
    plan = FaultPlan(seed=0).inject("serve.stream", SocketReset(),
                                    at=HTTP_CUT_AT)
    try:
        with chaos(plan):
            replies = post_all(fe.host, fe.port,
                               greedy_payloads(prompts[:4], max_new))
            wait_until(lambda: not fe.scheduler.has_work(),
                       "the scheduler to go idle")
        after = idle_pool(engine, fe.scheduler)
    finally:
        fe.stop()
    plan.assert_all_fired()
    done = [done_event(ev) for _st, ev in replies]
    cut = [i for i, d in enumerate(done) if d is None]
    kept_same = all(d["tokens"] == [int(t) for t in ref[i]]
                    for i, d in enumerate(done) if d is not None)
    cancelled = [r.rid for r in fe.scheduler.finished.values()
                 if r.finish_reason == "cancelled"]
    out = {"cut_at_event": HTTP_CUT_AT, "cut_requests": cut,
           "status_499": c499.value - before, "cancelled": cancelled,
           "slots_pages_refs_before": list(base),
           "slots_pages_refs_after": list(after),
           "others_same_tokens": kept_same}
    if (len(cut) != 1 or out["status_499"] != 1 or len(cancelled) != 1
            or after != base or base != (0, 0, 0) or not kept_same):
        raise AssertionError("serve_http disconnect: %r" % out)
    return out


def http_drain(engine, tracer, prompts, ref, max_new):
    """The preemption guard fires with every request accepted and some
    streaming: each in-flight and queued request finishes with its done
    event (the in-process tokens), the next POST gets 503, and
    ``wait_drained`` returns True."""
    import threading
    from paddle_tpu_torch.robustness import PreemptionGuard
    guard = PreemptionGuard(install=False)
    fe = http_frontend(engine, tracer, guard=guard)
    streaming = threading.Event()
    try:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(post_all, fe.host, fe.port,
                              greedy_payloads(prompts, max_new),
                              streaming.set)
            # accepted: outstanding now, or finished already
            wait_until(lambda: http_request(
                fe.host, fe.port, "GET", "/healthz")[1]["outstanding"]
                + len(fe.scheduler.finished) >= len(prompts),
                "every request accepted")
            if not streaming.wait(HTTP_TIMEOUT):
                raise AssertionError("serve_http drain: no token streamed")
            health = http_request(fe.host, fe.port, "GET", "/healthz")[1]
            guard.set()
            replies = fut.result(timeout=HTTP_TIMEOUT)
        drained = fe.wait_drained(HTTP_TIMEOUT)
        late, _doc = http_request(fe.host, fe.port, "POST", "/v1/generate",
                                  greedy_payloads(prompts[:1], 1)[0])
    finally:
        fe.stop()
        guard.clear()
    done = [done_event(ev) for _st, ev in replies]
    out = {"requests": len(prompts),
           "outstanding_at_fire": health["outstanding"],
           "slots_active_at_fire": health["slots_active"],
           "finished": sum(d is not None and d["finish_reason"] == "length"
                           for d in done),
           "same_tokens": all(d is not None and d["tokens"]
                              == [int(t) for t in ref[i]]
                              for i, d in enumerate(done)),
           "late_status": late, "wait_drained": drained}
    if (out["finished"] != len(prompts) or not out["same_tokens"]
            or late != 503 or not drained
            or out["outstanding_at_fire"] < 1):
        raise AssertionError("serve_http drain: %r" % out)
    return out


def serve_http(torch, engine, tracer, prompts, counters, flags, cpu_model,
               max_new=32, load=None):
    """The serve traffic over HTTP through a :class:`ServingFrontend` on
    ``engine`` (built with ``tracer``; liveness armed by the caller),
    under ``use_pallas_norm``, in the default loop; then the load, shed,
    disconnect and drain checks and ``/healthz``.  Returns the phase's
    line."""
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.serving import loadgen
    t_phase = time.perf_counter()
    name = "paged" if engine.paged else "slotted"
    load = HTTP_LOAD if load is None else load
    # the in-process default loop on the same prompts and engine
    registry.default_registry().reset()
    results, sched, wall, _l, info = run_loop(
        torch, engine, prompts, True, counters, flags, LOOPS[0],
        max_new=max_new)
    check_results("serve_http " + name, results, prompts, max_new)
    ref = [results[k].tokens for k in sorted(results)]
    step_wall = registry.histogram("serving.decode_step_seconds")
    in_process = dict(
        latency_fields(results, wall),
        host_gap_ms_per_step=info["host_gap_ms_per_step"],
        decode_step_wall_p50_ms=1e3 * step_wall.percentile(0.5))

    # -- parity, /healthz and load through one front end ------------------
    flags.set_flags({"use_pallas_norm": True})
    engine.reset()
    engine.reseed(0)
    engine.capture_steps()    # no capture inside the counted run
    tracer.reset()
    registry.default_registry().reset()
    goodput = registry.counter("serving.goodput_tokens")
    torch.cuda.synchronize()
    g0 = engine.graph_stats()
    counters.reset()
    fe = http_frontend(engine, tracer)
    try:
        t0 = time.perf_counter()
        replies = post_all(fe.host, fe.port,
                           greedy_payloads(prompts, max_new))
        http_wall = time.perf_counter() - t0
        goodput_parity = goodput.value
        _st, health = http_request(fe.host, fe.port, "GET", "/healthz")
        # the parity run's step wall and host gap, beside the in-process
        # run's: what the loop thread's SSE fan-out costs the card
        steps0 = fe.scheduler.decode_steps_total
        gap0 = fe.scheduler.host_gap_seconds
        http_step_wall = step_wall.percentile(0.5)
        registry.default_registry().reset()
        summary = loadgen.run_load_sync(
            fe.host, fe.port, load["qps"], load["n_requests"],
            mix=load["mix"], seed=load["seed"],
            vocab=int(engine.model.config.vocab_size), temperature=0.0)
        load_steps = fe.scheduler.decode_steps_total - steps0
        load_gap = fe.scheduler.host_gap_seconds - gap0
    finally:
        fe.stop()
    torch.cuda.synchronize()
    launches = counters.read()
    on_device = counters.b_on_device()
    g1 = engine.graph_stats()
    replays = g1["replays"] - g0["replays"]
    layers = engine.model.config.num_hidden_layers
    by_wrapper = launches["layer_norm_fwd"]
    if g1["captures"] != g0["captures"] or \
            on_device - by_wrapper != (2 * layers + 1) * replays:
        raise AssertionError(
            "serve_http %s: %d captures while serving; B counted %d on the "
            "card, %d through its wrapper, for %d replays"
            % (name, g1["captures"] - g0["captures"], on_device,
               by_wrapper, replays))
    statuses = [st for st, _ev in replies]
    done = [done_event(ev) for _st, ev in replies]
    toks = [np.asarray(d["tokens"] if d else [], np.int32) for d in done]
    same = all(np.array_equal(a, b) for a, b in zip(ref, toks))
    if statuses != [200] * len(prompts) or any(
            d is None or d["finish_reason"] != "length"
            or len(d["tokens"]) != max_new for d in done):
        raise AssertionError("serve_http %s: statuses %r, done events %r"
                             % (name, statuses, done))
    if not same:
        serve_compare(torch, cpu_model, prompts, ref, toks,
                      "http_vs_in_process_" + name)
    if goodput_parity != len(prompts) * max_new:
        raise AssertionError("serve_http %s: goodput rose by %g, want %d"
                             % (name, goodput_parity,
                                len(prompts) * max_new))
    spans = tracer.spans()
    first = min(s["start_ns"] for s in spans if s["name"] == "request")
    recaptures = [s for s in spans if s["trace_id"] == 0
                  and s["start_ns"] >= first
                  and s["attrs"].get("captures", 0) > 0]
    beacons = set(health["beacons"])
    want_beacons = {"serve.frontend_sched", "serve.frontend_loop",
                    "serve.scheduler_step"}
    if recaptures or health["status"] != "ok" or \
            not want_beacons <= beacons:
        raise AssertionError("serve_http %s: %d engine spans with a "
                             "capture, healthz %r"
                             % (name, len(recaptures), health))
    if (summary["completed"] != summary["sent"] or summary["shed"]
            or summary["errors"] or summary["dropped_streams"]):
        raise AssertionError("serve_http %s load: %r" % (name, summary))
    # on a card every slotted admission of a 128-aligned bucket runs the
    # forward once a layer (the parity run's 12 at least); paged prefill
    # never (a CPU engine launches nothing)
    flash = launches["flash_fwd_tc"]
    flash_ok = (flash == 0 if engine.paged or engine.device.type != "cuda"
                else flash >= layers * len(prompts) and flash % layers == 0)
    if not flash_ok:
        raise AssertionError("serve_http %s: the tensor-core forward "
                             "launched %d times" % (name, flash))
    line = {
        "phase": "serve_http", "engine": name, "use_pallas_norm": True,
        "loop": LOOPS[0], "requests": len(prompts), "max_new": max_new,
        "statuses": sorted(set(statuses)),
        "same_greedy_tokens": same, "wall_s": http_wall,
        "tokens_per_s": len(prompts) * max_new / http_wall,
        "ttft_p50_ms": statistics.median(d["ttft_ms"] for d in done),
        "tpot_p50_ms": statistics.median(d["tpot_ms"] for d in done),
        "host_gap_ms_per_step": 1e3 * gap0 / max(steps0, 1),
        "decode_step_wall_p50_ms": 1e3 * http_step_wall,
        "goodput_tokens": goodput_parity,
        "in_process": in_process,
        "load": dict(summary, offered={
            "qps": load["qps"], "requests": load["n_requests"],
            "seed": load["seed"], "mix": load["mix"]}),
        "load_host_gap_ms_per_step": 1e3 * load_gap / max(load_steps, 1),
        "load_decode_steps": load_steps,
        "load_decode_step_wall_p50_ms": 1e3 * step_wall.percentile(0.5),
        "graph_replays": replays,
        "launches": {"layer_norm_fwd": on_device,
                     "layer_norm_fwd_by_wrapper": by_wrapper,
                     "flash_fwd_tc": flash},
        "engine_spans_with_captures": len(recaptures),
        "healthz": {"status": health["status"], "beacons": sorted(beacons)},
    }
    # the checks below compare tokens with the in-process run: the same
    # LayerNorm route
    try:
        line["shed"] = http_shed(engine, tracer, prompts,
                                 registry.default_registry())
        line["disconnect"] = http_disconnect(
            engine, tracer, prompts, ref, registry.default_registry(),
            max_new)
        line["drain"] = http_drain(engine, tracer, prompts, ref, max_new)
    finally:
        flags.set_flags({"use_pallas_norm": False})
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return line


# -- the serving tier's phases: the captured chunk, the host KV tier, the
# disaggregated pair and the fleet -------------------------------------------

def phase_start(torch):
    """Reset the peak-memory statistic; returns the phase's start time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def phase_end(torch, line, t0):
    """The card's name and power limit, the phase's peak memory and its
    seconds, added to ``line``, which is emitted."""
    torch.cuda.synchronize()
    line.update(card=card_line(),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                seconds=time.perf_counter() - t0)
    emit(line)
    return line


def same_or_close(torch, cpu_model, prompts, ref, got, what):
    """True when ``got`` holds ``ref``'s greedy tokens; otherwise
    serve_compare holds each parting to a narrow CPU logit gap (it raises
    on a wide one) and this returns False."""
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(ref, got))
    if not same:
        serve_compare(torch, cpu_model, prompts, ref, got, what)
    return same


def b_launches_due(engine, sched):
    """B's launches a run under ``use_pallas_norm`` owes: 2L + 1 a
    forward (prefill chunks and decode or verify steps) on a card, none
    on the CPU (the plain LayerNorm)."""
    if engine.device.type != "cuda":
        return 0
    layers = engine.model.config.num_hidden_layers
    return (2 * layers + 1) * (sched.prefill_chunks_total
                               + sched.decode_steps_total)


def chunk_admissions(torch, engine, own):
    """Admissions through the paged chunk: two 128-token prompts (two
    chunks each), a 100-token prompt hitting the first one's shared page
    (a partial chunk after a hit), and the first prompt again (a full hit:
    one 1-token chunk).  Returns each one's first token and last
    logits."""
    engine.reset()
    engine.reseed(0)
    out = []
    for slot, p in enumerate((own[0], own[1], own[0][:100], own[0])):
        tok, last = engine.prefill(slot, p, temperature=0.0)
        out.append((tok, last.float()))
    torch.cuda.synchronize()
    engine.reset()
    return out


def chunk_capture(torch, engine, prompts, own, counters, flags, captured,
                  slotted):
    """The paged prefill chunk replayed from its CUDA graph against the
    eager chunk on the same engine: first tokens and last logits bit for
    bit through partial chunks, a prefix hit and a full hit, each
    LayerNorm route; then the serve traffic through the default loop with
    the chunk eager (decode steps captured), its TTFT and TPOT p50 and
    p99 beside ``captured`` (serve_paged's run, chunks captured) and
    ``slotted`` (serve's slotted run), all under ``use_pallas_norm``; the
    graphs by kind.  Returns the phase's line."""
    t0 = phase_start(torch)
    bitwise = {}
    for use_norm in (False, True):
        flags.set_flags({"use_pallas_norm": use_norm})
        runs = []
        try:
            for chunk_graph in (True, False):
                engine._capture_chunk = chunk_graph
                runs.append(chunk_admissions(torch, engine, own))
        finally:
            engine._capture_chunk = True
            flags.set_flags({"use_pallas_norm": False})
        diffs = [float((a[1] - b[1]).abs().max())
                 for a, b in zip(*runs)]
        same = all(a[0] == b[0] and torch.equal(a[1], b[1])
                   for a, b in zip(*runs))
        bitwise["use_pallas_norm" if use_norm else "default"] = {
            "same_bits": same, "max_abs_diff": max(diffs)}
        if not same:
            raise AssertionError("chunk_capture: the captured chunk's "
                                 "logits differ from the eager chunk's "
                                 "(use_pallas_norm=%s): %r"
                                 % (use_norm, diffs))
    engine._capture_chunk = False
    try:
        results, sched, wall, launches, info = run_loop(
            torch, engine, prompts, True, counters, flags, LOOPS[0])
    finally:
        engine._capture_chunk = True
    check_results("chunk_capture", results, prompts)
    eager = latency_fields(results, wall)
    if launches["layer_norm_fwd"] != b_launches_due(engine, sched):
        raise AssertionError("chunk_capture: B launched %d times for %d "
                             "forwards" % (launches["layer_norm_fwd"],
                                           sched.prefill_chunks_total
                                           + sched.decode_steps_total))
    keys = ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
            "tokens_per_s")
    line = {"phase": "chunk_capture", "use_pallas_norm": True,
            "bitwise_captured_vs_eager": bitwise,
            "serve_traffic": {
                "paged_chunk_captured": {k: captured[k] for k in keys},
                "paged_chunk_eager": {k: eager[k] for k in keys},
                "slotted": {k: slotted[k] for k in keys}},
            "eager_chunk_run": {
                "prefill_chunks": sched.prefill_chunks_total,
                "decode_steps": sched.decode_steps_total,
                "layer_norm_fwd_launches": launches["layer_norm_fwd"],
                "host_gap_ms_per_step": info["host_gap_ms_per_step"]},
            "graphs_by_kind": engine.graph_stats()["by_kind"],
            "launches": {"layer_norm_fwd": launches["layer_norm_fwd"]}}
    return phase_end(torch, line, t0)


TIER_HOST_BYTES = 256 << 20     # serve_tier's host budget


def serve_tier(torch, model, prompts, tight_tokens, roomy_tokens, counters,
               flags, cpu_model, device=None):
    """serve_paged_tight's engine (TIGHT_PAGES pages) with a host tier of
    TIER_HOST_BYTES, under ``use_pallas_norm``, in the default loop:
    the serve traffic (its reclaims spill to the host), the cached pages
    spilled and the device cache dropped, the same 12 prompts again
    (fetched back from the host, one 1-token chunk each), then again with
    one ``TornFile`` at ``serve.kv_tier`` (that fetch aborts and
    recomputes).  Each wave's tokens against the tier-off tight run's
    (``tight_tokens``, serve_paged_tight: the same pool, so the same
    preemptions where a wave preempts) and the roomy pool's
    (``roomy_tokens``, serve_paged: no preemption, as a wave whose
    prompts all come back from the host); a parting from the nearer one
    is held by serve_compare.  Spills, host hits and fetch seconds from
    the registry; the digests on a loopback TCPStore through the cluster
    index.  Returns the phase's line."""
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.robustness import faultpoints as fp
    from paddle_tpu_torch.serving import DecodeEngine, prompt_digest_chain
    from paddle_tpu_torch.serving.kv_tier import fetch_index
    t0 = phase_start(torch)
    engine = DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                          num_pages=TIGHT_PAGES, kv_host_bytes=TIER_HOST_BYTES,
                          device=device)
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    index = engine.attach_cluster_index(TCPStore("127.0.0.1", master.port),
                                        host=0, start=False)
    spilled = registry.counter("serving.kv_host_spilled_pages")
    hits = registry.counter("serving.kv_host_hits")
    fetch_s = registry.histogram("serving.kv_tier_fetch_seconds")
    waves = []
    for wave in ("churn", "fetch", "torn_fetch"):
        if wave != "churn":
            # the explicit cold-page policy: every cached page to the host,
            # then the device cache dropped (run_loop resets the engine)
            moved = engine.spill_cached_pages()
        else:
            moved = 0
        s0, h0 = spilled.value, hits.value
        f0, fs0 = fetch_s.count, fetch_s.sum
        plan = fp.FaultPlan().inject("serve.kv_tier", fp.TornFile(), at=0)
        with (fp.chaos(plan) if wave == "torn_fetch"
              else contextlib.nullcontext()):
            results, sched, wall, launches, info = run_loop(
                torch, engine, prompts, True, counters, flags, LOOPS[0])
        if wave == "torn_fetch":
            plan.assert_all_fired()
        check_results("serve_tier " + wave, results, prompts)
        toks = [results[k].tokens for k in sorted(results)]
        if launches["layer_norm_fwd"] != b_launches_due(engine, sched):
            raise AssertionError("serve_tier %s: B launched %d times for "
                                 "%d forwards" % (
                                     wave, launches["layer_norm_fwd"],
                                     sched.prefill_chunks_total
                                     + sched.decode_steps_total))
        same = {name: all(np.array_equal(np.asarray(a), np.asarray(b))
                          for a, b in zip(ref, toks))
                for name, ref in (("tier_off_tight", tight_tokens),
                                  ("roomy", roomy_tokens))}
        if not any(same.values()):
            near = tight_tokens if sched.preemptions_total else roomy_tokens
            same_or_close(torch, cpu_model, prompts, near, toks,
                          "serve_tier_%s" % wave)
        waves.append({
            "wave": wave, "spilled_before": moved,
            "same_greedy_tokens": same,
            "spilled_pages": spilled.value - s0,
            "host_hit_pages": hits.value - h0,
            "fetches": fetch_s.count - f0,
            "fetch_seconds": fetch_s.sum - fs0,
            "prefill_chunks": sched.prefill_chunks_total,
            "preemptions": sched.preemptions_total,
            "decode_steps": sched.decode_steps_total,
            **latency_fields(results, wall),
            "layer_norm_fwd_launches": launches["layer_norm_fwd"],
            "host_tier": engine._host_tier.state()})
    churn, fetch, _torn = waves
    if churn["spilled_pages"] < 1 or fetch["fetches"] < 1 or \
            fetch["host_hit_pages"] < 2:
        raise AssertionError("serve_tier: %d pages spilled while churning; "
                             "%d fetches landed %d pages on the second wave"
                             % (churn["spilled_pages"], fetch["fetches"],
                                fetch["host_hit_pages"]))
    index.publish_once()
    published = fetch_index(TCPStore("127.0.0.1", master.port), 1)
    chain = {d.hex() for p in prompts
             for d in prompt_digest_chain(p, engine.page_size)}
    covered = len(chain & published.get(0, set()))
    if covered == 0:
        raise AssertionError("serve_tier: the cluster index published none "
                             "of the prompts' digests")
    line = {"phase": "serve_tier", "use_pallas_norm": True,
            "num_pages": engine.num_pages, "host_budget_bytes":
            TIER_HOST_BYTES, "waves": waves,
            "cluster_index": {"hosts": sorted(published),
                              "digests_published": len(published.get(0, ())),
                              "prompt_digests_covered": covered,
                              "prompt_digests": len(chain)},
            "graphs_by_kind": engine.graph_stats()["by_kind"],
            "launches": {"layer_norm_fwd": sum(
                w["layer_norm_fwd_launches"] for w in waves)}}
    del engine, index
    master.close()
    torch.cuda.empty_cache()
    return phase_end(torch, line, t0)


def disagg_run(torch, de, pe, prompts, counters, flags, via_host=False,
               plan=None, max_new=32):
    """``prompts`` through a DisaggScheduler over ``de`` (decode) and
    ``pe`` (prefill), reset first, under ``use_pallas_norm``, greedy;
    every graph captured before the counts start.  Returns (tokens,
    scheduler, wall seconds, B's launches on the card)."""
    from paddle_tpu_torch.robustness import faultpoints as fp
    from paddle_tpu_torch.serving import DisaggScheduler, Request
    flags.set_flags({"use_pallas_norm": True})
    try:
        for e in (de, pe):
            e.capture_steps()
            e.reset()
            e.reseed(0)
        sched = DisaggScheduler(de, pe, via_host=via_host)
        for p in prompts:
            sched.submit(Request(prompt=p, max_new_tokens=max_new,
                                 temperature=0.0))
        torch.cuda.synchronize()
        g0 = [e.graph_stats()["captures"] for e in (de, pe)]
        counters.reset()
        t0 = time.perf_counter()
        with (fp.chaos(plan) if plan is not None else contextlib.nullcontext()):
            results = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.read()
        on_device = counters.b_on_device()
    finally:
        flags.set_flags({"use_pallas_norm": False})
    if plan is not None:
        plan.assert_all_fired()
    if [e.graph_stats()["captures"] for e in (de, pe)] != g0:
        raise AssertionError("serve_disagg: a capture inside the run")
    check_results("serve_disagg", results, prompts, max_new)
    if launches["layer_norm_fwd"] or on_device != b_launches_due(de, sched):
        raise AssertionError("serve_disagg: B counted %d on the card (%d "
                             "through its wrapper) for %d forwards"
                             % (on_device, launches["layer_norm_fwd"],
                                sched.prefill_chunks_total
                                + sched.decode_steps_total))
    return ([results[k].tokens for k in sorted(results)], sched, wall,
            on_device, results)


def serve_disagg(torch, model, prompts, colocated_tokens, counters, flags,
                 cpu_model, max_new=32, device=None):
    """A prefill engine and a decode engine (8 slots and the default pool
    each) on the one card, under ``use_pallas_norm``: the serve traffic
    through the device handoff, through host staging, and through host
    staging with one ``TornFile`` at ``serve.handoff`` (that request
    requeues and recomputes), each against the colocated paged engine's
    tokens; handoff chunks and bytes; then the traffic as 12 SSE streams
    through ``ServingFrontend(prefill_engine=)``.  Returns the phase's
    line."""
    from paddle_tpu_torch.robustness import faultpoints as fp
    from paddle_tpu_torch.serving import DecodeEngine, ServingFrontend
    t0 = phase_start(torch)
    de = DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                      device=device)
    pe = DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                      device=device)
    runs = {}
    for name, via_host, plan in (
            ("device", False, None), ("via_host", True, None),
            ("torn_handoff", True, fp.FaultPlan().inject(
                "serve.handoff", fp.TornFile(), at=2))):
        toks, sched, wall, on_device, results = disagg_run(
            torch, de, pe, prompts, counters, flags, via_host, plan,
            max_new)
        same = same_or_close(torch, cpu_model, prompts, colocated_tokens,
                             toks, "serve_disagg_%s_vs_colocated" % name)
        runs[name] = {
            "same_greedy_tokens": same,
            "handoffs": sched.handoffs_total,
            "handoff_chunks": sched.handoff_chunks_total,
            "handoff_bytes": sched.handoff_bytes_total,
            "requeued": sched.preemptions_total,
            "prefill_side_chunks": sched.prefill_side_chunks,
            "decode_side_chunks": sched.decode_side_chunks,
            "decode_steps": sched.decode_steps_total,
            "layer_norm_fwd_launches": on_device,
            **latency_fields(results, wall)}
        if name == "torn_handoff" and runs[name]["requeued"] < 1:
            raise AssertionError("serve_disagg: the torn handoff requeued "
                                 "nothing")
        if runs[name]["handoffs"] != len(prompts) or \
                de._alloc.pages_used() or pe._alloc.pages_used():
            raise AssertionError("serve_disagg %s: %d handoffs, pages left "
                                 "%d / %d" % (name, runs[name]["handoffs"],
                                              de._alloc.pages_used(),
                                              pe._alloc.pages_used()))
    # the HTTP front end over the pair
    flags.set_flags({"use_pallas_norm": True})
    try:
        for e in (de, pe):
            e.reset()
        fe = ServingFrontend(de, prefill_engine=pe)
        fe.start()
        try:
            tw = time.perf_counter()
            replies = post_all(fe.host, fe.port,
                               greedy_payloads(prompts, max_new))
            http_wall = time.perf_counter() - tw
            _st, health = http_request(fe.host, fe.port, "GET", "/healthz")
        finally:
            fe.stop()
    finally:
        flags.set_flags({"use_pallas_norm": False})
    done = [done_event(ev) for _st, ev in replies]
    if [st for st, _ev in replies] != [200] * len(prompts) or any(
            d is None or d["finish_reason"] != "length" for d in done):
        raise AssertionError("serve_disagg http: %r" % (replies,))
    http_toks = [np.asarray(d["tokens"], np.int32) for d in done]
    http_same = same_or_close(torch, cpu_model, prompts, colocated_tokens,
                              http_toks, "serve_disagg_http_vs_colocated")
    line = {"phase": "serve_disagg", "use_pallas_norm": True,
            "engines": {"prefill_slots": pe.num_slots,
                        "decode_slots": de.num_slots,
                        "handoff_pages": de.handoff_pages,
                        "kv_pool_bytes": de.kv_pool_bytes()},
            "runs": runs,
            "http": {"streams": len(prompts), "same_greedy_tokens":
                     http_same, "wall_s": http_wall,
                     "ttft_p50_ms": statistics.median(
                         d["ttft_ms"] for d in done),
                     "tpot_p50_ms": statistics.median(
                         d["tpot_ms"] for d in done),
                     "healthz": {"status": health["status"],
                                 "handoff_depth": health["handoff_depth"]},
                     "handoffs": fe.scheduler.handoffs_total},
            "graphs_by_kind": {"decode_engine":
                               de.graph_stats()["by_kind"],
                               "prefill_engine":
                               pe.graph_stats()["by_kind"]},
            "launches": {"layer_norm_fwd": sum(
                r["layer_norm_fwd_launches"] for r in runs.values())}}
    del de, pe, fe
    torch.cuda.empty_cache()
    return phase_end(torch, line, t0)


FLEET_GAP_S = 0.15    # serve_fleet's first wave: seconds between arrivals


def is_replica_one_decoding(ctx):
    """The kill predicate of serve_fleet: replica 1 holds a request with
    at least two generated tokens."""
    sched = ctx["scheduler"]
    return ctx["replica"] == 1 and any(
        a is not None and len(a.generated) >= 2 for a in sched.slots)


def serve_fleet(torch, model, prompts, ref_tokens, own, own_ref, counters,
                flags, cpu_model, max_new=32, device=None):
    """A Router over 2 replica engines (8 slots and the default pool
    each) behind ``ServingFrontend(router=)``, under ``use_pallas_norm``:
    the first 8 serve requests as SSE streams, a probe, the last 4 (their
    shared prefix routed by affinity to the replica that owns it); then
    the 12 unrelated prompts ``own`` (no prefix to route by), arriving
    FLEET_GAP_S apart so least-loaded routing spreads them, with replica 1
    killed (``HardExit`` at ``serve.replica``) while it decodes.  Every
    stream completes with the colocated paged engine's tokens
    (``ref_tokens``, ``own_ref``), the failover requeues are counted, the
    replica rejoins, and no engine captures again.  Then each replica's
    telemetry published to a loopback TCPStore and merged.  Returns the
    phase's line."""
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.observability import aggregate, registry
    from paddle_tpu_torch.robustness import faultpoints as fp
    from paddle_tpu_torch.serving import (DecodeEngine, Router,
                                          ServingFrontend)
    t0 = phase_start(torch)
    engines = [DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                            device=device) for _ in range(2)]
    routed = registry.counter("router.routed", ("reason",))
    failovers = registry.counter("router.failovers")
    layers = model.config.num_hidden_layers

    def routed_by():
        return {r: routed.labels(reason=r).value
                for r in ("affinity", "least_loaded", "failover")}

    class KillWhen(fp.HardExit):
        def __init__(self):
            super().__init__()
            self.killed = False

        def fire(self, ctx, plan):
            if self.killed or not is_replica_one_decoding(ctx):
                return
            self.killed = True
            super().fire(ctx, plan)

    flags.set_flags({"use_pallas_norm": True})
    router = Router(engines, respawn_delay=0.05, healthy_interval=0.2,
                    probe_interval=0.05)
    fe = ServingFrontend(router=router, queue_limit=64)
    try:
        fe.start()                     # captures both engines, then seals
        captures = [e.graph_captures for e in engines]
        torch.cuda.synchronize()
        g0 = [e.graph_stats()["replays"] for e in engines]
        counters.reset()
        r0, f0 = routed_by(), failovers.value
        tw = time.perf_counter()
        first = post_all(fe.host, fe.port,
                         greedy_payloads(prompts[:8], max_new))
        router.probe_once()            # refresh the replicas' views
        r1 = routed_by()
        second = post_all(fe.host, fe.port,
                          greedy_payloads(prompts[8:], max_new))
        undisturbed_wall = time.perf_counter() - tw
        r2 = routed_by()
        kill = KillWhen()
        plan = fp.FaultPlan().inject("serve.replica", kill, every=1)
        tk = time.perf_counter()
        with fp.chaos(plan):
            # arrivals FLEET_GAP_S apart, so the probe sees each replica's
            # load between them (a burst would route all to one replica)
            killed = post_all(fe.host, fe.port,
                              greedy_payloads(own, max_new),
                              gap=FLEET_GAP_S)
        kill_wall = time.perf_counter() - tk
        r3, f3 = routed_by(), failovers.value
        wait_until(lambda: router.replica_states() == ["healthy"] * 2,
                   "replica 1 to rejoin")
        states = router.replica_states()
        _st, health = http_request(fe.host, fe.port, "GET", "/healthz")
        master = TCPStore("127.0.0.1", 0, is_master=True, world_size=2)
        for host in (0, 1):
            aggregate.HostPublisher(TCPStore("127.0.0.1", master.port),
                                    host=host).publish_once()
        cluster = aggregate.merge_cluster(
            TCPStore("127.0.0.1", master.port), 2)
        master.close()
    finally:
        fe.stop()
        flags.set_flags({"use_pallas_norm": False})
    torch.cuda.synchronize()
    launches = counters.read()
    on_device = counters.b_on_device()
    replays = sum(e.graph_stats()["replays"] for e in engines) - sum(g0)
    if not kill.killed:
        raise AssertionError("serve_fleet: replica 1 was never killed")
    if on_device - launches["layer_norm_fwd"] != \
            (2 * layers + 1) * replays:
        raise AssertionError("serve_fleet: B counted %d on the card, %d "
                             "through its wrapper, for %d replays"
                             % (on_device, launches["layer_norm_fwd"],
                                replays))
    if [e.graph_captures for e in engines] != captures:
        raise AssertionError("serve_fleet: captures %r became %r"
                             % (captures, [e.graph_captures
                                           for e in engines]))
    out = {}
    for name, replies, ps, ref in (
            ("undisturbed", first + second, prompts, ref_tokens),
            ("replica_1_killed", killed, own, own_ref)):
        done = [done_event(ev) for _st, ev in replies]
        if [st for st, _ev in replies] != [200] * len(ps) or any(
                d is None or d["finish_reason"] != "length"
                or len(d["tokens"]) != max_new for d in done):
            raise AssertionError("serve_fleet %s: a stream did not "
                                 "complete: %r" % (name, replies))
        toks = [np.asarray(d["tokens"], np.int32) for d in done]
        out[name] = {"streams": len(ps), "same_greedy_tokens":
                     same_or_close(torch, cpu_model, ps, ref, toks,
                                   "serve_fleet_%s_vs_colocated" % name),
                     "ttft_p50_ms": statistics.median(
                         d["ttft_ms"] for d in done),
                     "ttft_p99_ms": p99([d["ttft_ms"] for d in done])}
    affinity = r2["affinity"] - r1["affinity"]
    if affinity < len(prompts) - 8:
        raise AssertionError("serve_fleet: %d of the second wave's %d "
                             "routed by affinity"
                             % (affinity, len(prompts) - 8))
    requeues = r3["failover"] - r2["failover"]
    if f3 - f0 != 1 or requeues < 1:
        raise AssertionError("serve_fleet: %d failovers, %d requeues"
                             % (f3 - f0, requeues))
    if sorted(cluster["hosts"]) != [0, 1] or cluster["missing"]:
        raise AssertionError("serve_fleet: cluster view %r" % (cluster,))
    line = {"phase": "serve_fleet", "use_pallas_norm": True,
            "replicas": 2, "slots_per_replica": 8, **out,
            "undisturbed_wall_s": undisturbed_wall,
            "kill_drive_wall_s": kill_wall,
            "routed": {"first_wave": {k: r1[k] - r0[k] for k in r0},
                       "second_wave": {k: r2[k] - r1[k] for k in r0},
                       "kill_drive": {k: r3[k] - r2[k] for k in r0}},
            "failovers": f3 - f0, "requeues": requeues,
            "replica_states": states,
            "healthz": {"status": health["status"],
                        "replicas_healthy": health["replicas_healthy"]},
            "graph_captures": captures,
            "graph_replays": replays,
            "cluster": {"hosts": sorted(cluster["hosts"]),
                        "missing": cluster["missing"],
                        "stragglers": cluster["stragglers"]},
            "launches": {"layer_norm_fwd": on_device,
                         "layer_norm_fwd_by_wrapper":
                             launches["layer_norm_fwd"]}}
    del engines, router, fe
    torch.cuda.empty_cache()
    return phase_end(torch, line, t0)


# -- the native runtime, the launcher and elastic restarts -----------------

#: the launched GPT-2 345M: full width (16 heads of 64, hidden 1024), the
#: depth cut to LAUNCH_LAYERS blocks so that three launched jobs, their
#: checkpoints (~1.2 GB each: f32 masters and two AdamW slots) and the
#: dp2 jobs stay within about 150 s and the disk
LAUNCH_LAYERS = 4
LAUNCH_STEPS = 8
LAUNCH_CRASH_AT = 4          # the worker dies after step 3's checkpoint
LAUNCH_SAVE_PROBE = 5        # steps without and with a write in flight
DP2_STEPS = 4
DP2_SAVE_AFTER = 1           # the save after the second step (0-based 1)
# dp2 against one process: the two sum the same rows' gradients in
# another order (3.0e-5 apart on the card at 700 W), while a step moves
# the loss by ~5e-3 there, so a rank that never updates fails
DP2_LOSS_TOL = 1e-3
SHM_PAYLOAD_BYTES = 64 << 20
WORKER = os.path.join("tools", "torch_launch_worker.py")


def launch_model_cfg(layers=LAUNCH_LAYERS, **cfg):
    """GPT-2 345M's published widths at ``layers`` blocks, dropout as
    ``train`` has it (0); ``cfg`` overrides (the CPU rehearsal's tiny
    widths)."""
    base = dict(vocab_size=50304, max_position_embeddings=1024,
                hidden_size=1024, num_hidden_layers=layers,
                num_attention_heads=16, intermediate_size=4096,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    base.update(cfg)
    return base


def launch_spec(workdir, **kw):
    """Write the worker's spec into ``workdir``; returns its path.  The
    card's run: ``train``'s configuration (B = 8, S = 1024, bf16 AMP O2,
    AdamW, ``use_pallas_norm``), weights from seed 0, ids through
    ``io.DataLoader(num_workers=2)``."""
    spec = dict(workdir=workdir, device="cuda", model=launch_model_cfg(),
                seed=0, rows_seed=1, batch=8, seq=1024, steps=LAUNCH_STEPS,
                lr=1e-4, amp=True, use_pallas_norm=True, num_workers=2,
                mode="elastic")
    spec.update(kw)
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def launch_job(spec_path, root=".", **launcher_kw):
    """Run the worker under the port's ``Launcher``; returns (the
    launcher, {(rank, restart): result}).  A job that does not exit 0
    raises with the tails of its workers' logs."""
    from paddle_tpu_torch.distributed.launch_main import Launcher
    workdir = os.path.dirname(spec_path)
    launcher_kw.setdefault("log_dir", os.path.join(workdir, "log"))
    launcher = Launcher(**launcher_kw)
    rc = launcher.run([sys.executable, os.path.join(root, WORKER),
                       spec_path])
    results = {}
    for name in os.listdir(workdir):
        m = re.match(r"result-(\d+)-(\d+)\.json$", name)
        if m:
            with open(os.path.join(workdir, name)) as f:
                results[(int(m.group(1)), int(m.group(2)))] = json.load(f)
    logs = {}
    for name in sorted(os.listdir(launcher_kw["log_dir"])):
        with open(os.path.join(launcher_kw["log_dir"], name), "rb") as f:
            logs[name] = f.read()[-3000:].decode(errors="replace")
    if rc != 0:
        raise AssertionError("launched job %s exited %d:\n%s"
                             % (spec_path, rc, "\n".join(
                                 "%s:\n%s" % kv for kv in logs.items())))
    return launcher, results


def repeat_bar(a, b):
    """0.0 when two runs' losses are bit for bit equal, else their largest
    difference: the bar a resumed run is held to."""
    if a == b:
        return 0.0
    return max(abs(float(a[k]) - float(b[k])) for k in a)


def losses_within(got, ref, steps, bar):
    """The steps of ``got`` whose loss is not ``ref``'s (bit for bit at
    bar 0, else further than ``bar``)."""
    bad = {}
    for s in steps:
        g, r = got.get(str(s)), ref.get(str(s))
        if g is None or r is None or (g != r if bar == 0.0
                                      else abs(float(g) - float(r)) > bar):
            bad[s] = (g, r)
    return bad


def launches_due(layers, use_norm=True):
    """A training step's launches at ``layers`` blocks under AMP O2 bf16:
    the tensor-core forward, C2 and C3 once a block, B and D 2L + 1 under
    ``use_pallas_norm``."""
    n = 2 * layers + 1 if use_norm else 0
    return {"flash_fwd_tc": layers, "flash_fwd": 0, "flash_fwd_pipelined": 0,
            "flash_bwd": 0, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
            "layer_norm_fwd": n, "layer_norm_bwd": n, "ce_lse": 0,
            "ce_fwd": 0, "ce_bwd": 0}


def hold_launches(run, due, what):
    """Every step of ``run`` launched ``due`` (None: not held)."""
    if due is None:
        return
    bad = {s: got for s, got in run["launches"].items() if got != due}
    if bad:
        raise AssertionError("%s: launches a step %r, want %r"
                             % (what, bad, due))


def launch_elastic_hold(ref_a, ref_b, first, resumed, backoff_log, crash_at,
                        steps, due=None):
    """launch_elastic's checks: one respawn; the restarted worker resumed
    at ``crash_at`` from the checkpoint of the step before and from the
    data cursor; its losses equal the uninterrupted job's bit for bit
    (or within the two uninterrupted jobs' largest difference, when they
    differ); every run on the shm route.  Returns the phase's figures."""
    bar = repeat_bar(ref_a["losses"], ref_b["losses"])
    if len(backoff_log) != 1:
        raise AssertionError("launch_elastic: %d respawns (%r), want 1"
                             % (len(backoff_log), backoff_log))
    if resumed["resumed_at"] != crash_at or \
            resumed["restored_epoch"] != crash_at - 1:
        raise AssertionError(
            "launch_elastic: resumed at step %r from the checkpoint of %r, "
            "want %d from %d" % (resumed["resumed_at"],
                                 resumed["restored_epoch"], crash_at,
                                 crash_at - 1))
    if resumed["restored_cursor"] != {"epoch": 0, "batch": crash_at}:
        raise AssertionError("launch_elastic: data cursor %r, want batch %d"
                             % (resumed["restored_cursor"], crash_at))
    if sorted(int(s) for s in resumed["losses"]) != list(range(crash_at,
                                                              steps)):
        raise AssertionError("launch_elastic: the resumed run's steps %r"
                             % sorted(resumed["losses"]))
    bad = losses_within(resumed["losses"], ref_a["losses"],
                        range(crash_at, steps), bar)
    if bad:
        raise AssertionError("launch_elastic: resumed losses against the "
                             "uninterrupted job's (bar %g): %r" % (bar, bad))
    if sorted(int(s) for s in first["losses"]) != list(range(crash_at + 1)):
        raise AssertionError("launch_elastic: the first run's steps %r"
                             % sorted(first["losses"]))
    bad = losses_within(first["losses"], ref_a["losses"],
                        range(crash_at + 1), bar)
    if bad:
        raise AssertionError("launch_elastic: the first run's losses "
                             "against the uninterrupted job's: %r" % bad)
    for run in (ref_a, ref_b, first, resumed):
        if run["route"] != "shm":
            raise AssertionError("launch_elastic: the loader took route %r"
                                 % run["route"])
        hold_launches(run, due, "launch_elastic")
    return {"repeat_bar": bar, "resumed_at": resumed["resumed_at"],
            "restored_cursor": resumed["restored_cursor"],
            "respawns": len(backoff_log), "backoff_log": backoff_log}


def save_cost(run, probe):
    """What async saves cost a step: in ``run``'s loop (a save every
    epoch) the median synced step ms and the median ms a save call held
    the loop (the fetch to host, and the wait for a slot in the bounded
    writer queue); from ``probe`` the median step ms with no write in
    flight and while one is, and the save call's ms alone."""
    busy = [ms for ms, on in zip(probe["busy_step_ms"], probe["in_flight"])
            if on]
    idle = statistics.median(probe["idle_step_ms"])
    busy_ms = statistics.median(busy) if busy else None
    return {
        "loop_step_ms": statistics.median(
            ms for e, ms in run["step_ms"].items() if e != "0"),
        "loop_save_call_ms": statistics.median(run["save_call_ms"].values()),
        "probe_idle_step_ms": idle, "probe_busy_step_ms": busy_ms,
        "probe_busy_steps": len(busy),
        "probe_save_call_ms": probe["save_call_ms"],
        "async_save_adds_ms_a_step": None if busy_ms is None
        else busy_ms - idle}


def launch_elastic(torch, root=".", spec_kw=None, due=None):
    """Three launched jobs of the worker (``Launcher(nproc_per_node=1,
    elastic=True, max_restarts=2)``), all at once: the uninterrupted job
    twice (does the run repeat bit for bit?) and a job whose worker dies
    at ``train.epoch`` of step LAUNCH_CRASH_AT after its checkpoint of the
    step before is on disk, once (a marker file).  Held by
    :func:`launch_elastic_hold`; the line adds the checkpoint's seconds
    and bytes, the seconds from the death to the first resumed step, and
    host ms a batch through the loader and by hand, all taken while the
    three jobs share the card and the host."""
    import threading

    from paddle_tpu_torch.kernels import _build
    spec_kw = dict(spec_kw or {})
    steps = spec_kw.get("steps", LAUNCH_STEPS)
    crash_at = spec_kw.pop("crash_at", LAUNCH_CRASH_AT)
    kw = dict(nproc_per_node=1, elastic=True, max_restarts=2,
              restart_delay=0.05, poll_interval=0.05)
    t0 = time.perf_counter()
    jobs = {}
    with tempfile.TemporaryDirectory(prefix="launch-",
                                     dir=_build.BUILD_DIR) as tmp:
        def run(tag, **extra):
            try:
                jobs[tag] = launch_job(launch_spec(
                    os.path.join(tmp, tag), **spec_kw, **extra), root, **kw)
            except BaseException as e:
                jobs[tag] = e
        # ref_b's probe runs after its last recorded step
        threads = [threading.Thread(target=run, args=(tag,), kwargs=kw)
                   for tag, kw in (
                       ("ref_a", {}),
                       ("ref_b", {"save_probe": LAUNCH_SAVE_PROBE}),
                       ("crash", {"crash_at": crash_at}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for tag, got in jobs.items():
            if isinstance(got, BaseException):
                raise got
        # the dying run's result so far, written as it died
        with open(os.path.join(tmp, "crash", "crashed.json")) as f:
            first = json.load(f)
    launcher, results = jobs["crash"]
    ref_a, ref_b = jobs["ref_a"][1][(0, 0)], jobs["ref_b"][1][(0, 0)]
    resumed = results[(0, 1)]
    model = spec_kw.get("model", launch_model_cfg())
    line = {
        "phase": "launch_elastic", "layers": model["num_hidden_layers"],
        "width": {k: model[k] for k in ("hidden_size",
                                        "num_attention_heads")},
        "depth_cut": "%d of 24 blocks" % model["num_hidden_layers"],
        "steps": steps, "crash_at": crash_at,
        **launch_elastic_hold(ref_a, ref_b, first, resumed,
                              launcher.backoff_log, crash_at, steps, due),
        "losses_uninterrupted": ref_a["losses"],
        "losses_resumed": resumed["losses"],
        "checkpoint_bytes": resumed["write_bytes"]["sum"]
        / max(1, resumed["write_bytes"]["count"]),
        "save_seconds_mean": resumed["write_seconds"]["sum"]
        / max(1, resumed["write_seconds"]["count"]),
        "restore_seconds": resumed["restore_seconds"]["sum"],
        "death_to_first_resumed_step_s":
            resumed["t_first_step"] - first["t_death"],
        "worker_start_to_first_step_s":
            resumed["t_first_step"] - resumed["t_start"],
        **save_cost(ref_a, ref_b["save_probe"]),
        "loader_ms_per_batch": statistics.median(resumed["loader_ms"]),
        "by_hand_ms_per_batch": statistics.median(resumed["by_hand_ms"]),
        "launches_per_step": resumed["launches"][str(crash_at)],
        "launches": {k: sum(s[k] for s in resumed["launches"].values())
                     for k in resumed["launches"][str(crash_at)]},
        "jobs_concurrent": 3,
        "seconds_total": time.perf_counter() - t0}
    if spec_kw.get("device", "cuda") == "cuda":
        line["card"] = card_line()
    emit(line)
    # the holds' inputs, for a rehearsal to perturb (not printed)
    line["runs"] = dict(ref_a=ref_a, ref_b=ref_b, first=first,
                        resumed=resumed, backoff_log=launcher.backoff_log,
                        crash_at=crash_at, steps=steps)
    return line


def launch_dp2_hold(single, job1, job2, save_after, steps, master, bar,
                    repeat, due=None):
    """launch_dp2_gloo's checks: the first job's losses within ``bar`` of
    the one-process run on the global batch; both ranks' host files
    written and rank 0 published; the second job resumed after
    ``save_after`` and its steps equal the first job's bit for bit (or
    within ``repeat``); in each job both ranks' parameters equal bit for
    bit after the last step (the gradient all-reduce ran); each rank's ``PADDLE_*`` environment as the
    launcher's contract says; the shm route."""
    for r, run in enumerate(job1):
        bad = {s: (run["losses"].get(str(s)), single[s])
               for s in range(steps)
               if not abs(float(run["losses"].get(str(s), "nan"))
                          - single[s]) <= bar}
        if bad:
            raise AssertionError("launch_dp2_gloo: rank %d's losses against "
                                 "one process (bar %g): %r" % (r, bar, bad))
    for job in (job1, job2):
        if len({run["params_sha256"] for run in job}) != 1:
            raise AssertionError("launch_dp2_gloo: the ranks' parameters "
                                 "differ after the last step: %r"
                                 % [run["params_sha256"] for run in job])
    if job1[0].get("host_files") != ["host-0.ckpt", "host-1.ckpt"]:
        raise AssertionError("launch_dp2_gloo: published files %r"
                             % (job1[0].get("host_files"),))
    for r, run in enumerate(job2):
        if run["resumed_at"] != save_after + 1 or run["restored_cursor"] \
                != {"epoch": 0, "batch": save_after + 1}:
            raise AssertionError(
                "launch_dp2_gloo: rank %d resumed at %r with cursor %r"
                % (r, run["resumed_at"], run["restored_cursor"]))
        bad = losses_within(run["losses"], job1[r]["losses"],
                            range(save_after + 1, steps), repeat)
        if bad or sorted(int(s) for s in run["losses"]) != list(
                range(save_after + 1, steps)):
            raise AssertionError("launch_dp2_gloo: rank %d's resumed losses "
                                 "against its first job's: %r" % (r, bad))
    for job in (job1, job2):
        eps = ",".join("127.0.0.1:%d" % (6170 + r) for r in range(2))
        for r, run in enumerate(job):
            want = {"PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM": "2",
                    "PADDLE_LOCAL_RANK": str(r),
                    "PADDLE_RANK_IN_NODE": str(r),
                    "PADDLE_CURRENT_ENDPOINT": "127.0.0.1:%d" % (6170 + r),
                    "PADDLE_TRAINER_ENDPOINTS": eps,
                    "PADDLE_RESTART_COUNT": "0"}
            got = {k: run["env"][k] for k in want}
            if got != want or run["env"]["PADDLE_MASTER"] not in master:
                raise AssertionError("launch_dp2_gloo: rank %d's env %r"
                                     % (r, run["env"]))
            if run["route"] != "shm":
                raise AssertionError("launch_dp2_gloo: route %r"
                                     % run["route"])
            hold_launches(run, due, "launch_dp2_gloo")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def single_process_losses(torch, spec, root="."):
    """The worker's model, data and optimizer in this process on the
    global batch: the one-process losses the dp2 run is held against."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(
        os.path.join(root, WORKER))))
    try:
        import importlib
        worker = importlib.import_module("torch_launch_worker")
    finally:
        sys.path.pop(0)
    from paddle_tpu_torch.utils import flags
    # build_step sets the worker's LayerNorm route process-wide: this
    # process's later phases keep theirs
    norm = flags.fast_get("use_pallas_norm")
    try:
        step = worker.build_step(spec, torch, 1)
        rows = worker.token_rows(spec)
        losses = []
        for e in range(spec["steps"]):
            ids = torch.as_tensor(
                rows[e * spec["batch"]:(e + 1) * spec["batch"]],
                device=spec["device"])
            losses.append(float(step(ids, ids)))
    finally:
        flags.set_flags({"use_pallas_norm": norm})
    del step
    return losses


def launch_dp2_gloo(torch, root=".", spec_kw=None, due=None):
    """``Launcher(nproc_per_node=2, master=127.0.0.1:<free port>)``: two
    workers on the one card over gloo, each taking its rows through
    ``DistributedBatchSampler(num_replicas=2)`` and the shm DataLoader,
    DP2_STEPS steps over dp = 2 with a synchronous save of both ranks
    after step DP2_SAVE_AFTER; then a second launch resumes from it.
    Held by :func:`launch_dp2_hold` against a one-process run of the same
    model on the global batch (this process)."""
    from paddle_tpu_torch.kernels import _build
    spec_kw = dict(dict(steps=DP2_STEPS, mode="dp",
                        save_after=DP2_SAVE_AFTER), **(spec_kw or {}))
    bar = DP2_LOSS_TOL
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dp2-",
                                     dir=_build.BUILD_DIR) as tmp:
        spec_path = launch_spec(os.path.join(tmp, "job"), **spec_kw)
        with open(spec_path) as f:
            spec = json.load(f)
        masters = []
        jobs = []
        for resume in (False, True):
            spec["resume"] = resume
            spec["save_after"] = None if resume else spec_kw["save_after"]
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            for name in os.listdir(spec["workdir"]):
                if name.startswith("result-"):
                    os.unlink(os.path.join(spec["workdir"], name))
            masters.append("127.0.0.1:%d" % free_port())
            _, results = launch_job(spec_path, root, nproc_per_node=2,
                                    master=masters[-1], poll_interval=0.05)
            jobs.append([results[(r, 0)] for r in range(2)])
        t_jobs = time.perf_counter() - t0
        spec["device"] = spec_kw.get("device", "cuda")
        single = single_process_losses(torch, spec, root)
    launch_dp2_hold(single, jobs[0], jobs[1], spec_kw["save_after"],
                    spec_kw["steps"], masters, bar, 0.0, due)
    line = {"phase": "launch_dp2_gloo", "ranks": 2, "backend": "gloo",
            "steps": spec_kw["steps"], "save_after": spec_kw["save_after"],
            "loss_bar": bar, "single_process_losses": single,
            "losses": [run["losses"] for run in jobs[0]],
            "resumed_losses": [run["losses"] for run in jobs[1]],
            "host_files": jobs[0][0]["host_files"],
            "save_wall_s": [run["save_wall_s"] for run in jobs[0]],
            "restore_wall_s": [run["restore_wall_s"] for run in jobs[1]],
            "write_bytes": [run["write_bytes"]["sum"] for run in jobs[0]],
            "launches_per_step": [run["launches"][str(spec_kw["steps"] - 1)]
                                  for run in jobs[0]],
            "launches": [{k: sum(s[k] for s in run["launches"].values())
                          for k in run["launches"]["0"]} for run in jobs[0]],
            "env": [run["env"] for run in jobs[0]],
            "jobs_seconds": t_jobs, "seconds_total": time.perf_counter() - t0}
    if spec_kw.get("device", "cuda") == "cuda":
        line["card"] = card_line()
    emit(line)
    line["runs"] = dict(single=single, job1=jobs[0], job2=jobs[1],
                        save_after=spec_kw["save_after"],
                        steps=spec_kw["steps"], master=masters, bar=bar)
    return line


def _store_rank(port, rank, q):
    from paddle_tpu_torch.distributed.store import TCPStore
    try:
        store = TCPStore("127.0.0.1", port, world_size=3)
        store.set("rank%d" % rank, str(rank))
        vals = [store.get("rank%d" % r) for r in range(3)]
        store.barrier("meet", timeout=60)
        q.put((rank, store.backend, vals))
        store.close()
    except BaseException as e:
        q.put((rank, "error", repr(e)))


def _shm_producer(name, nbytes, seed):
    from paddle_tpu_torch.io.shm_queue import ShmQueue
    q = ShmQueue.open(name)
    q.put(np.random.default_rng(seed).integers(0, 256, nbytes,
                                               dtype=np.uint8))
    q.destroy()


def native_runtime(torch, build_seconds=None):
    """The port's native library on this machine: a TCPStore master and
    client on the native backend and a rendezvous of three processes; a
    ShmQueue carrying SHM_PAYLOAD_BYTES from another process intact; no
    ``/dev/shm/ptq_*`` segment left behind."""
    import glob
    import hashlib
    import multiprocessing as mp

    from paddle_tpu_torch.core import native
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.io.shm_queue import ShmQueue
    t0 = time.perf_counter()
    before = set(glob.glob("/dev/shm/ptq_*"))
    if not native.available():
        raise AssertionError("native_runtime: the library did not load: %s"
                             % native.load_error())
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=3)
    client = TCPStore("127.0.0.1", master.port, world_size=3)
    if (master.backend, client.backend) != ("native", "native"):
        raise AssertionError("native_runtime: backends %r"
                             % ((master.backend, client.backend),))
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    t1 = time.perf_counter()
    procs = [ctx.Process(target=_store_rank, args=(master.port, r, q))
             for r in range(3)]
    for p in procs:
        p.start()
    met = sorted(q.get(timeout=60) for _ in procs)
    for p in procs:
        p.join(30)
    rendezvous_s = time.perf_counter() - t1
    if [m[:2] for m in met] != [(r, "native") for r in range(3)] or any(
            m[2] != [b"0", b"1", b"2"] for m in met):
        raise AssertionError("native_runtime: rendezvous %r" % (met,))
    client.close()
    master.close()
    sq = ShmQueue.create(SHM_PAYLOAD_BYTES + (1 << 20))
    try:
        t1 = time.perf_counter()
        p = ctx.Process(target=_shm_producer,
                        args=(sq.name, SHM_PAYLOAD_BYTES, 5))
        p.start()
        got = sq.get()
        shm_s = time.perf_counter() - t1
        p.join(30)
    finally:
        sq.close()
        sq.destroy()
    want = np.random.default_rng(5).integers(0, 256, SHM_PAYLOAD_BYTES,
                                             dtype=np.uint8)
    if got.shape != want.shape or hashlib.sha256(got).digest() != \
            hashlib.sha256(want).digest():
        raise AssertionError("native_runtime: the shm payload changed")
    left = sorted(set(glob.glob("/dev/shm/ptq_*")) - before)
    if left:
        raise AssertionError("native_runtime: segments left: %r" % left)
    line = {"phase": "native_runtime", "library": str(
        native.library_path().name), "build_seconds": build_seconds,
        "store_backends": [master.backend, client.backend],
        "rendezvous_processes": 3, "rendezvous_seconds": rendezvous_s,
        "shm_bytes": SHM_PAYLOAD_BYTES, "shm_seconds": shm_s,
        "shm_mb_per_s": SHM_PAYLOAD_BYTES / 1e6 / shm_s,
        "segments_left": left, "seconds": time.perf_counter() - t0}
    if torch.cuda.is_available():
        line["card"] = card_line()
    emit(line)
    return line


def launch_phases(torch, seconds):
    """launch_elastic and launch_dp2_gloo on the card, at once (five
    workers and their loaders share the card and the host; their seconds
    into ``seconds``); then no ``/dev/shm/ptq_*`` segment of their
    loaders may be left.  Runs before the autotune phase fills this run's
    cache, so the workers, which read it, take the hand-tuned kernels.
    Returns their lines."""
    import glob
    import threading
    before = set(glob.glob("/dev/shm/ptq_*"))
    torch.cuda.empty_cache()
    due = launches_due(LAUNCH_LAYERS)
    out = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            out[name] = fn(torch, due=due)
        except BaseException as e:
            out[name] = e
        seconds[name] = time.perf_counter() - t0
    threads = [threading.Thread(target=run, args=(name, fn)) for name, fn in
               (("launch_elastic", launch_elastic),
                ("launch_dp2_gloo", launch_dp2_gloo))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in out.values():
        if isinstance(got, BaseException):
            raise got
    left = sorted(set(glob.glob("/dev/shm/ptq_*")) - before)
    if left:
        raise AssertionError("launch phases: segments left: %r" % left)
    return out["launch_elastic"], out["launch_dp2_gloo"]


def distributed(torch, base, train_cfg, amp, flags, counters, run_train,
                seconds):
    """The distributed phases, timed into ``seconds``: dist_nccl and
    train_dp on an NCCL world of one, then the two-process gloo phases
    tp2_gloo, zero_gloo and serve_http_tp2, pp_single on one rank, the
    two-process pp2_gloo, the four-process pp2_sdp2_gloo, and the
    two-process ring_gloo and moe_gloo.  Returns their lines (train_dp,
    tp2_gloo, zero_gloo, serve_http_tp2, pp_single, pp2_gloo with
    pp2_sdp2_gloo's under "sdp2", ring_gloo, moe_gloo)."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import mesh as dist_mesh
    t0 = time.perf_counter()
    run_nccl = dist_nccl(torch)
    seconds["dist_nccl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_dp = train_dp(torch, base, amp, counters, run_train["losses"],
                      run_train)
    dist.destroy_process_group()
    dist_mesh.set_mesh(None)
    seconds["train_dp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    run_tp2 = tp2_gloo(torch, train_cfg, run_train["losses"])
    seconds["tp2_gloo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_zero = zero_gloo(torch, train_cfg, run_train["losses"])
    seconds["zero_gloo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_serve_tp2 = serve_http_tp2(torch, train_cfg)
    seconds["serve_http_tp2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    run_pp = pp_single(torch, base, counters, flags)
    torch.cuda.empty_cache()
    seconds["pp_single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_pp2 = pp2_gloo(torch, train_cfg, run_pp)
    seconds["pp2_gloo"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_pp2["sdp2"] = pp2_sdp2_gloo(torch, train_cfg)
    seconds["pp2_sdp2_gloo"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ring = ring_gloo(torch)
    seconds["ring_gloo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_moe = moe_gloo(torch)
    seconds["moe_gloo"] = time.perf_counter() - t0
    run_ring["dist_nccl_sep1"] = run_nccl["ring_sep1"]
    return (run_dp, run_tp2, run_zero, run_serve_tp2, run_pp, run_pp2,
            run_ring, run_moe)


def device_line(torch, kind):
    """The card's name and power limit, then the device line (the last
    line of the output)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def distributed_only(torch, kind, amp, flags, counters):
    """``--distributed``: the train phase (its losses are the reference)
    and :func:`distributed`, then the device line — the distributed
    phases alone, without the kernel checks and serving phases."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    seconds = {}
    t0 = time.perf_counter()
    train_cfg = dataclasses.replace(GPTConfig.gpt2_medium(),
                                    hidden_dropout_prob=0.0,
                                    attention_dropout_prob=0.0)
    base = GPTForCausalLM(train_cfg,
                          generator=torch.Generator().manual_seed(0))
    run_train = train(torch, base, amp, counters, flags)
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0
    distributed(torch, base, train_cfg, amp, flags, counters, run_train,
                seconds)
    del base
    long_and_sep(torch, train_cfg, amp, counters, flags, seconds)
    emit({"phase": "seconds", **seconds})
    device_line(torch, kind)
    return 0


def long_and_sep(torch, train_cfg, amp, counters, flags, seconds):
    """train_long, which writes its first step's gradients to a file of
    the build directory, then sep_train_gloo against it; timed into
    ``seconds``.  Returns (train_long's line, sep_train_gloo's)."""
    from paddle_tpu_torch.kernels import _build
    with tempfile.TemporaryDirectory(prefix="sep-",
                                     dir=_build.BUILD_DIR) as tmp:
        ref_grads = os.path.join(tmp, "train_long_grads.pt")
        t0 = time.perf_counter()
        run_long = train_long(torch, train_cfg, amp, counters, flags,
                              grads_to=ref_grads)
        torch.cuda.empty_cache()
        seconds["train_long"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_sep = sep_train_gloo(torch, train_cfg, run_long, ref_grads)
        seconds["sep_train_gloo"] = time.perf_counter() - t0
    return run_long, run_sep


class NativeBuild:
    """``core.native.load()`` on a thread of its own (g++ beside nvcc);
    :meth:`join` returns the seconds g++ took (None: a fresh library was
    there) and raises if the library did not load."""

    def __init__(self):
        import threading

        from paddle_tpu_torch.core import native
        self._native = native
        self._thread = threading.Thread(target=native.load, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if not self._native.available():
            raise AssertionError("the native library did not build: %s"
                                 % self._native.load_error())
        return self._native.build_seconds()


def main():
    # a fault in native code prints the Python stack of every thread
    faulthandler.enable(all_threads=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import _build, autotune, ce_cuda
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    from paddle_tpu_torch.kernels import norm_cuda
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.utils import flags

    # f32 products on the card stay f32, so f32 comparisons mean what
    # they say
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    # the native host library (g++) builds beside the kernels (nvcc)
    native_build = NativeBuild()
    # a fresh build reports every kernel's registers and spills
    lib_path, log = _build.build(
        ptxas_info="--ptxas" in sys.argv
        or not _build.library_path().is_file())
    _build.library()
    ln_ptxas = ptxas_usage(log, "layer_norm")
    # the 16-bit A' and C1 (registers and spills: PERF.md records them)
    pipe_ptxas = ptxas_usage(log, "pipelined_tc")
    merged_ptxas = ptxas_usage(log, "merged_tc")
    # the f32 forward: kernel A and the f32 A' (3 x TF32)
    f32_fwd_ptxas = (ptxas_usage(log, "flash_fwd_kernel")
                     + ptxas_usage(log, "flash_fwd_pipelined_kernel"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib_path.name), "layer_norm_ptxas": ln_ptxas,
          "flash_fwd_pipelined_tc_ptxas": pipe_ptxas,
          "flash_bwd_merged_tc_ptxas": merged_ptxas,
          "flash_fwd_f32_ptxas": f32_fwd_ptxas})
    if log and "--ptxas" in sys.argv:
        print(log, file=sys.stderr)
    spilled = [r for r in ln_ptxas if r.get("spill_stores")
               or r.get("spill_loads")]
    if spilled:
        raise AssertionError("LayerNorm kernels spill: %r" % spilled)
    # every phase but the autotune ones runs with tuning off, no pin and
    # an autotune cache of this run's own (empty until the autotune phase
    # fills it), so no file of the user's steers or receives anything
    tune_dir = tempfile.TemporaryDirectory(prefix="autotune-",
                                           dir=_build.BUILD_DIR)
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.join(tune_dir.name,
                                                           "autotune.json")
    for var in ("PADDLE_TPU_AUTOTUNE", "PADDLE_TPU_AUTOTUNE_PIN"):
        os.environ.pop(var, None)
    flags.set_flags({"autotune": False, "autotune_pin": ""})
    if "--distributed" in sys.argv:
        return distributed_only(torch, kind, amp, flags,
                                Counters(fac, norm_cuda, ce_cuda))

    seconds = {}
    t0 = time.perf_counter()
    native_runtime(torch, native_build.join())
    seconds["native_runtime"] = time.perf_counter() - t0
    if "--launch" in sys.argv:
        launch_phases(torch, seconds)
        emit({"phase": "seconds", **seconds})
        tune_dir.cleanup()
        device_line(torch, kind)
        return 0
    t0 = time.perf_counter()
    flash_rows = check_flash(torch, fac)
    ln_rows, ln_err = check_layer_norm(torch, norm_cuda)
    ln16_rows, ln16_err = check_layer_norm(torch, norm_cuda, torch.float16,
                                           sizes=(8192,))
    emit({"phase": "checks", "flash_fwd": flash_rows,
          "layer_norm_fwd": ln_rows, "layer_norm_fwd_fp16": ln16_rows})
    bwd_rows, bwd_err = check_flash_bwd(torch, fac)
    ln_bwd_rows, ln_bwd_err = check_layer_norm_bwd(torch, norm_cuda)
    ln16_bwd_rows, ln16_bwd_err = check_layer_norm_bwd(
        torch, norm_cuda, torch.float16, sizes=(8192,))
    f32_tile_rows = check_f32_bwd_tiles(torch, fac)
    emit({"phase": "checks_bwd", "flash_bwd": bwd_rows,
          "flash_bwd_f32_tiles": f32_tile_rows,
          "layer_norm_bwd": ln_bwd_rows,
          "layer_norm_bwd_fp16": ln16_bwd_rows})
    long_plain_row, long_row = check_flash_long(torch, fac)
    f32_long_rows, f32_bwd_long_rows = check_f32_long(torch, fac)
    emit({"phase": "checks_long", "against_plain": long_plain_row,
          "split_vs_merged": long_row, "flash_fwd_f32": f32_long_rows,
          "flash_bwd_f32": f32_bwd_long_rows})
    f32_fwd_rows = check_f32_fwd_tiles(torch, fac, autotune)
    emit({"phase": "checks_f32_fwd", "rows": f32_fwd_rows})
    seconds["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe_rows, pipe_err, pipe_refused = check_pipelined(
        torch, fac, autotune, _build.library())
    pipe_repeat_rows = check_pipelined_repeats(torch, fac)
    emit({"phase": "checks_pipelined", "rows": pipe_rows,
          "refused_smem": pipe_refused, "repeats": pipe_repeat_rows})
    seconds["checks_pipelined"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ce_rows = check_ce(torch, ce_cuda, norm_cuda, flags)
    emit({"phase": "checks_ce", **ce_rows})
    soft = check_softmax(torch, norm_cuda)
    emit({"phase": "checks_softmax", "rows": soft})
    seconds["checks_ce"] = time.perf_counter() - t0

    # -- serve: GPT-2 345M, seeded weights, AMP O2 bf16 -------------------
    t0 = time.perf_counter()
    cfg = GPTConfig.gpt2_medium()
    cpu_model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    cpu_model.eval()
    model = amp.decorate(copy.deepcopy(cpu_model), level="O2",
                         dtype="bfloat16")
    engine = DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                          paged=False)
    # the parity phases take 128-token prompts with nothing in common, so
    # a decode that read another slot's rows could not pass by chance
    rng = np.random.default_rng(0)
    own_prompts = [rng.integers(0, 50257, (128,)).astype(np.int32)
                   for _ in range(12)]
    # the serve traffic: 64 tokens every request shares (one full page of
    # the paged engine) and 64 of its own
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 50257, (64,))
    prompts = [np.concatenate([shared, rng.integers(0, 50257, (64,))])
               .astype(np.int32) for _ in range(12)]
    # warm-up (library handles, allocator) outside the counted runs
    engine.prefill(0, prompts[0], temperature=0.0)
    engine.decode(np.zeros(8, np.int32), [True] * 8, [0.0] * 8, [0] * 8,
                  [1.0] * 8)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "params": sum(p.numel() for p in model.parameters())})
    counters = Counters(fac, norm_cuda, ce_cuda)
    run_default, toks_default = both_loops(serve, torch, engine, prompts,
                                           False, counters, flags)
    run_norm, toks_norm = both_loops(serve, torch, engine, prompts, True,
                                     counters, flags)
    for use_norm in (False, True):
        decode_profile(torch, engine, use_norm, flags)

    # -- serve_paged: the same traffic through the paged engine -----------
    t1 = time.perf_counter()
    paged_engine = DecodeEngine(model, num_slots=8, max_len=1024, seed=0)
    paged_engine.prefill(0, prompts[0], temperature=0.0)
    paged_engine.decode(np.zeros(8, np.int32), [True] * 8, [0.0] * 8,
                        [0] * 8, [1.0] * 8)
    run_paged, toks_paged = both_loops(serve_paged, torch, paged_engine,
                                       prompts, False, counters, flags)
    run_paged_norm, toks_paged_norm = both_loops(
        serve_paged, torch, paged_engine, prompts, True, counters, flags)
    paged_profiles = {use_norm: decode_profile(torch, paged_engine,
                                               use_norm, flags)
                      for use_norm in (False, True)}
    if min(run_paged["prefix_hit_tokens"],
           run_paged_norm["prefix_hit_tokens"]) <= 0:
        raise AssertionError("serve_paged: no prefix hit")
    tight_engine = DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                                num_pages=TIGHT_PAGES)
    run_tight, toks_tight = both_loops(serve_paged, torch, tight_engine,
                                       prompts, True, counters, flags,
                                       phase="serve_paged_tight")
    del tight_engine
    if run_tight["preemptions"] < 1:
        raise AssertionError("serve_paged_tight: no request was preempted")
    for t in toks_default + toks_norm + toks_paged + toks_paged_norm + \
            toks_tight:
        if not (0 <= int(t.min()) and int(t.max()) < cfg.vocab_size):
            raise AssertionError("token ids out of range")
    seconds["serve_paged"] = time.perf_counter() - t1

    # -- chunk_capture: the paged prefill chunk replayed against eager ----
    t1 = time.perf_counter()
    chunk_line = chunk_capture(torch, paged_engine, prompts, own_prompts,
                               counters, flags, run_paged_norm, run_norm)
    seconds["chunk_capture"] = time.perf_counter() - t1

    # -- parity: card (kernels, bf16) vs CPU (plain, f32) -----------------
    flags.set_flags({"use_pallas_norm": True})
    engine.reset()
    before = (fac.flash_fwd_tc_launches, norm_cuda.layer_norm_fwd_launches)
    _tok, card_logits = engine.prefill(0, own_prompts[0], temperature=0.0)
    card_logits = card_logits.float().cpu()
    if (fac.flash_fwd_tc_launches == before[0]
            or norm_cuda.layer_norm_fwd_launches == before[1]):
        raise AssertionError("parity prefill did not run both kernels")
    flags.set_flags({"use_pallas_norm": False})
    with torch.no_grad():
        cpu_logits = cpu_model(torch.as_tensor(own_prompts[0][None]))[0, -1]
    if not bool(torch.isfinite(card_logits).all()):
        raise AssertionError("card logits are not finite")
    err = float((card_logits - cpu_logits).abs().max())
    top2 = torch.topk(cpu_logits, 2).values
    margin = float(top2[0] - top2[1])
    same = int(card_logits.argmax()) == int(cpu_logits.argmax())
    emit({"phase": "parity", "max_abs_err": err, "tolerance": LOGIT_TOL,
          "logit_std": float(cpu_logits.std()), "same_greedy_token": same,
          "cpu_top2_margin": margin})
    if err > LOGIT_TOL or not (same or margin < LOGIT_TOL):
        raise AssertionError("card vs CPU logits disagree: err %g, same "
                             "token %s, margin %g" % (err, same, margin))
    # the same prefill with A' pinned on every layer, counts from 0
    flags.set_flags({"autotune_pin": PIN_A_PRIME})
    engine.reset()
    torch.cuda.synchronize()
    counters.reset()
    try:
        _tok, pinned_logits = engine.prefill(0, own_prompts[0],
                                             temperature=0.0)
    finally:
        flags.set_flags({"autotune_pin": ""})
    pinned_logits = pinned_logits.float().cpu()
    parity_pinned = {k: counters.read()[k]
                     for k in ("flash_fwd_tc", "flash_fwd",
                               "flash_fwd_pipelined")}
    err = float((pinned_logits - cpu_logits).abs().max())
    same = int(pinned_logits.argmax()) == int(cpu_logits.argmax())
    emit({"phase": "parity_pinned", "pin": PIN_A_PRIME,
          "max_abs_err": err, "tolerance": LOGIT_TOL,
          "same_greedy_token": same, "launches": parity_pinned})
    if parity_pinned != {"flash_fwd_tc": 0, "flash_fwd": 0,
                         "flash_fwd_pipelined": cfg.num_hidden_layers}:
        raise AssertionError("pinned prefill launches %r" % parity_pinned)
    if not bool(torch.isfinite(pinned_logits).all()) or err > LOGIT_TOL \
            or not (same or margin < LOGIT_TOL):
        raise AssertionError("pinned prefill vs CPU logits: err %g, same "
                             "token %s" % (err, same))
    exact = {"slotted": card_vs_cpu(torch, engine, cpu_model,
                                    slotted_script(own_prompts), flags,
                                    norm_cuda, "decode_parity",
                                    dict(paged=False))}
    serve_compare(torch, cpu_model, prompts, toks_default, toks_norm)
    t1 = time.perf_counter()
    exact["paged"] = card_vs_cpu(torch, paged_engine, cpu_model,
                                 paged_script(own_prompts[0]), flags,
                                 norm_cuda, "paged_parity",
                                 dict(num_pages=16))
    serve_compare(torch, cpu_model, prompts, toks_default, toks_paged,
                  "paged_vs_slotted")
    serve_compare(torch, cpu_model, prompts, toks_norm, toks_paged_norm,
                  "paged_vs_slotted_use_pallas_norm")
    serve_compare(torch, cpu_model, prompts, toks_paged_norm, toks_tight,
                  "tight_vs_roomy_pool")
    seconds["serve_paged"] += time.perf_counter() - t1

    # -- overlap_parity: captured overlapped loop vs eager synchronous ----
    t1 = time.perf_counter()
    overlap_parity(torch, engine, cpu_model, slotted_script(own_prompts),
                   own_prompts, exact["slotted"], flags, norm_cuda,
                   counters)
    # the paged engine's tokens for the unrelated prompts, default loop
    # under use_pallas_norm: serve_fleet's reference
    own_paged_norm = overlap_parity(
        torch, paged_engine, cpu_model, paged_script(own_prompts[0]),
        own_prompts, exact["paged"], flags, norm_cuda,
        counters)[1][(True, LOOPS[0])]
    seconds["overlap_parity"] = time.perf_counter() - t1

    # -- serve_spec: the paged engine with SPEC_K drafts a verify step ----
    t1 = time.perf_counter()
    spec_engine = DecodeEngine(model, num_slots=8, max_len=1024, seed=0,
                               spec_k=SPEC_K)
    spec_engine.prefill(0, prompts[0], temperature=0.0)
    spec_engine.decode_spec(np.zeros(8, np.int32),
                            np.zeros((8, SPEC_K), np.int32), [True] * 8,
                            [0.0] * 8, [0] * 8, [1.0] * 8)
    spans = span_prompts(cfg.vocab_size)
    spec_runs, spec_toks = serve_spec(
        torch, spec_engine, paged_engine, cpu_model,
        {"serve": prompts, "span": spans},
        {("serve", False): toks_paged, ("serve", True): toks_paged_norm},
        counters, flags)
    spec_parity(torch, spec_engine, paged_engine, own_prompts, flags,
                counters)
    graph_lines = {"slotted_decode": engine.graph_stats(),
                   "paged_decode": paged_engine.graph_stats(),
                   "paged_verify": spec_engine.graph_stats()}
    del spec_engine
    torch.cuda.empty_cache()
    seconds["serve_spec"] = time.perf_counter() - t1

    # -- serve_quant / quant_parity: the int8 and fp8 KV pools ------------
    t1 = time.perf_counter()
    quant_runs, quant_engines, quant_toks = serve_quant(
        torch, model, prompts, paged_engine.kv_row_bytes(), cfg.vocab_size,
        counters, flags)
    for name, eng in quant_engines.items():
        card_vs_cpu(torch, eng, cpu_model,
                    paged_script(own_prompts[0]) if eng.paged
                    else slotted_script(own_prompts), flags, norm_cuda,
                    "quant_parity",
                    dict(num_pages=16) if eng.paged else dict(paged=False),
                    exact=exact["paged" if eng.paged else "slotted"])
    del quant_engines, eng, exact
    torch.cuda.empty_cache()
    seconds["serve_quant"] = time.perf_counter() - t1

    # -- serve_scan: the scan-layers model on every serving route ---------
    t1 = time.perf_counter()
    scan_model = amp.decorate(scan_copy(cpu_model), level="O2",
                              dtype="bfloat16")
    scan_line = serve_scan(
        torch, scan_model, model, prompts,
        {"paged": (run_paged_norm, toks_paged_norm),
         "slotted": (run_norm, toks_norm),
         "spec": (spec_runs[("serve", True)], spec_toks[("serve", True)]),
         "paged_int8": (quant_runs["paged_int8"], quant_toks["paged_int8"])},
        paged_profiles[True], counters, flags)
    del scan_model
    torch.cuda.empty_cache()
    seconds["serve_scan"] = time.perf_counter() - t1

    # -- serve_http: the front end and the load harness on each engine ----
    t1 = time.perf_counter()
    from paddle_tpu_torch.observability import Tracer, liveness
    http_runs = {}
    liveness.enable()
    try:
        for paged in (True, False):
            tracer = Tracer()
            http_engine = DecodeEngine(model, num_slots=8, max_len=1024,
                                       seed=0, paged=paged, tracer=tracer)
            http_runs["paged" if paged else "slotted"] = serve_http(
                torch, http_engine, tracer, prompts, counters, flags,
                cpu_model)
            del http_engine
    finally:
        liveness.disable()
    torch.cuda.empty_cache()
    seconds["serve_http"] = time.perf_counter() - t1

    # -- the host KV tier, the disaggregated pair and the fleet -----------
    t1 = time.perf_counter()
    tier_line = serve_tier(torch, model, prompts, toks_tight,
                           toks_paged_norm, counters, flags, cpu_model)
    seconds["serve_tier"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    disagg_line = serve_disagg(torch, model, prompts, toks_paged_norm,
                               counters, flags, cpu_model)
    seconds["serve_disagg"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    fleet_line = serve_fleet(torch, model, prompts, toks_paged_norm,
                             own_prompts, own_paged_norm, counters, flags,
                             cpu_model)
    seconds["serve_fleet"] = time.perf_counter() - t1
    # the pools of the three captured steps (their graphs for each
    # LayerNorm route) beside the KV pools they serve
    emit({"phase": "captured_steps", "graphs": graph_lines,
          "kv_pool_bytes": {"slotted": engine.kv_pool_bytes(),
                            "paged": paged_engine.kv_pool_bytes()}})
    del engine, paged_engine, model, cpu_model
    torch.cuda.empty_cache()
    seconds["serve"] = (time.perf_counter() - t0 - seconds["serve_paged"]
                        - seconds["overlap_parity"] - seconds["serve_spec"]
                        - seconds["serve_quant"] - seconds["serve_scan"]
                        - seconds["serve_http"]
                        - seconds["chunk_capture"] - seconds["serve_tier"]
                        - seconds["serve_disagg"] - seconds["serve_fleet"])

    # -- train: bench.py's step, GPT-2 345M, AMP O2 bf16, AdamW -----------
    t0 = time.perf_counter()
    train_cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                    attention_dropout_prob=0.0)
    # the serve run's seeded weights (same generator, same draw order)
    base = GPTForCausalLM(train_cfg,
                          generator=torch.Generator().manual_seed(0))
    run_train = train(torch, base, amp, counters, flags)
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_train_norm = train_norm(torch, base, amp, counters, flags,
                                run_train["losses"][0])
    torch.cuda.empty_cache()
    seconds["train_norm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_ce, run_lse = train_ce(torch, base, amp, counters, flags,
                               run_train["losses"][0])
    seconds["train_ce"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_flat = train_flat(torch, base, amp, counters, run_train["losses"])
    seconds["train_flat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_stack = train_stack(torch, base, amp, counters, run_train["losses"],
                            run_train, run_flat)
    seconds["train_stack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_scan = train_scan(torch, base, amp, counters, run_train["losses"])
    seconds["train_scan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_rc = train_recompute(torch, base, amp, counters, run_train["losses"],
                             run_train)
    seconds["train_recompute"] = time.perf_counter() - t0
    (run_dp, run_tp2, run_zero, run_serve_tp2, run_pp, run_pp2, run_ring,
     _run_moe) = distributed(torch, base, train_cfg, amp, flags, counters,
                             run_train, seconds)
    run_elastic, run_dp2 = launch_phases(torch, seconds)
    t0 = time.perf_counter()
    parity = train_parity(torch, base, amp, flags, counters)
    torch.cuda.empty_cache()
    seconds["train_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_f32 = train_f32(torch, base, counters, flags)
    seconds["train_f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_fp16 = train_fp16(torch, base, amp, counters, flags,
                          run_train["losses"][0])
    seconds["train_fp16"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    autotune_lines = autotune_warm(torch, autotune, fac)
    seconds["autotune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_pipe = train_pipelined(torch, base, amp, counters, flags,
                               run_train["losses"][0])
    seconds["train_pipelined"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_tuned = train_autotune(torch, base, amp, counters, flags, autotune,
                               fac, run_train["losses"][0])
    del base
    torch.cuda.empty_cache()
    seconds["train_autotune"] = time.perf_counter() - t0
    run_long, run_sep = long_and_sep(torch, train_cfg, amp, counters, flags,
                                     seconds)
    emit({"phase": "seconds", **seconds})

    tc_prefill = fwd_row(flash_rows, "flash_fwd_tc", [1, 128, 16, 64])
    tc_train = fwd_row(flash_rows, "flash_fwd_tc", [8, 1024, 16, 64])
    a_prefill = fwd_row(flash_rows, "flash_fwd", [1, 128, 16, 64],
                        "float32")
    a_train = fwd_row(flash_rows, "flash_fwd", [8, 1024, 16, 64],
                      "float32")
    # A' on the main path: train_pipelined's (8, 1024) step, 64 x 64 tiles
    pipe_train = [r for r in pipe_rows if r["shape"] == [8, 1024, 16, 64]
                  and r["blocks"] == [64, 64] and r["dtype"] == "bfloat16"][0]
    decode_row = ln_rows[0]                # (8, 1024)
    train_bwd_row = [r for r in bwd_rows
                     if r["shape"] == [8, 1024, 16, 64]
                     and r["dtype"] == "bfloat16"][0]
    f32_bwd_rows = {tuple(r["shape"]): r for r in bwd_rows
                    if r.get("dtype") == "float32"
                    and "flash_bwd_device_ms" in r}
    train_bwd_f32_row = f32_bwd_rows[(8, 1024, 16, 64)]
    d128_row = [r for r in bwd_rows if r["shape"] == [1, 1024, 8, 128]
                and r["dtype"] == "bfloat16"][0]
    d256_row = [r for r in bwd_rows if r["shape"] == [1, 1024, 4, 256]
                and r["dtype"] == "bfloat16"][0]
    ln_bwd_row = ln_bwd_rows[0]            # (8192, 1024)
    ln_cols = ("shape", "kernel_ms", "kernel_device_ms", "plain_ms",
               "plain_device_ms", "bound_ms", "library_ms",
               "library_device_ms")
    ln_bwd_cols = ln_cols + ("rows_pass_device_ms", "reduce_device_ms")
    parity_by = {next(iter(line["flags"]), "default"): line["launches"]
                 for line in parity}
    def layout_launches(kern):
        """``kern``'s launches in the stacked-layout and recompute phases
        (3 steps each; the slotted scan engine's admissions)."""
        out = {"train_stack": run_stack["launches"][kern],
               "train_dp": run_dp["launches"][kern],
               "train_dp_zero2": run_dp["zero2"]["launches"][kern],
               "tp2_gloo_rank0_train": run_tp2["train_launches"][kern],
               "tp2_gloo_rank0_train_overlap":
                   run_tp2["overlap_train"]["launches"][kern]}
        out.update({"zero_gloo_rank0_stage%d" % stage:
                    run_zero["stages"][stage]["launches"][kern]
                    for stage in (1, 2, 3)})
        out["train_scan"] = run_scan[0]["launches"][kern]
        out["pp_single"] = run_pp["launches"][kern]
        out.update({"pp2_gloo_stage%d" % st: run_pp2["launches"][st][kern]
                    for st in (0, 1)})
        # ZeRO x pipeline: each ZeRO stage's run, a rank of each pp stage
        # (ranks 0 and 2 of {"pp": 2, "sdp": 2})
        out.update({"pp2_sdp2_gloo_%s_rank%d" % (run, r):
                    run_pp2["sdp2"][run]["launches"][r][kern]
                    for run in ("sdp_stage1", "sdp_stage2") for r in (0, 2)})
        # the GPT's sequence sharding: the causal ring inside each block
        out.update({"sep_train_gloo_rank%d" % r:
                    run_sep["launches"][r][kern] for r in (0, 1)})
        out.update({"train_recompute_" + r["layout"]: r["launches"][kern]
                    for r in run_rc})
        out.update(launched_launches(kern))
        # the sequence-parallel paths: the causal ring at two ranks (rank
        # r runs r + 1 blocks), Ulysses (one a rank), each a forward and
        # backward
        out.update({"ring_gloo_rank%d" % r: run_ring["ring"][r]["launches"]
                    [kern] for r in (0, 1)})
        out.update({"ulysses_gloo_rank%d" % r:
                    run_ring["ulysses"][r]["launches"][kern]
                    for r in (0, 1)})
        if kern == "flash_fwd_tc":
            out["serve_scan_slotted"] = sum(
                r["flash_fwd_tc_launches"] for r in scan_line["runs"]
                if r["engine"] == "slotted")
        return out
    def launched_launches(kern):
        """``kern``'s launches in the launched workers' runs: the resumed
        elastic run (steps LAUNCH_CRASH_AT..LAUNCH_STEPS - 1) and each dp2
        rank's first job."""
        out = {"launch_elastic_resumed": run_elastic["launches"][kern]}
        out.update({"launch_dp2_gloo_rank%d" % r: run_dp2["launches"][r][kern]
                    for r in (0, 1)})
        return out
    tc_launches = {"serve": run_default["launches"]["flash_fwd_tc"],
                   # paged prefill attends through plain paged attention
                   "serve_paged": run_paged["launches"].get(
                       "flash_fwd_tc", 0),
                   "train": run_train["launches"]["flash_fwd_tc"],
                   "train_long": run_long["launches"]["flash_fwd_tc"],
                   "train_fp16": run_fp16[0]["launches"]["flash_fwd_tc"],
                   # the slotted int8 prefill attends the exact K/V
                   "serve_quant_slotted_int8":
                       quant_runs["slotted_int8"]["launches"]["flash_fwd_tc"],
                   "serve_http_slotted":
                       http_runs["slotted"]["launches"]["flash_fwd_tc"],
                   **layout_launches("flash_fwd_tc")}
    # kernel A and C1 run on the f32 path: train_f32's steps and
    # train_parity's f32 card step
    f32_path = parity_by["dtype"]
    f32_launches = {k: {"train_f32": run_f32["launches"][k],
                        "train_parity_f32": f32_path[k],
                        "train": run_train["launches"][k]}
                    for k in ("flash_fwd", "flash_bwd")}

    f32_fwd_errs = {kern: [t["max_abs_err"] for r in f32_fwd_rows
                           for t in r["tiles"] if t["kernel"] == kern]
                    for kern in ("A", "A'")}

    def f32_fwd_summary(kern):
        """check_f32_fwd_tiles' rows, the tiles of ``kern`` alone."""
        return [dict({k: r[k] for k in (
            "shape", "bound_ms", "bound_fma_ms", "library_device_ms")},
            tiles=[{k: t[k] for k in ("blocks", "device_ms", "bound_share",
                                      "max_abs_err")}
                   for t in r["tiles"] if t["kernel"] == kern])
            for r in f32_fwd_rows]

    def fwd_cols(row):
        return {k: row[k] for k in (
            "shape", "dtype", "blocks", "kernel_ms", "kernel_device_ms",
            "tiles_device_ms", "library_ms", "library_device_ms", "bound_ms",
            "bound_by", "bound_fma_ms", "bound_basis", "bound_share")
            if k in row}

    def bwd_entry(kern, src_row, plain_row, launches, by_path, err):
        entry = {
            "name": kern, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_bwd_tc.cu",
            "source_f32": "paddle_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:%d"
                        % {"flash_bwd": 736, "flash_bwd_dq": 790,
                           "flash_bwd_dkv": 828}[kern],
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": err,
            "shape": src_row["shape"], "ms": src_row[kern + "_ms"],
            "device_ms": src_row[kern + "_device_ms"],
            "plain_ms": plain_row["plain_ms"],
            "plain_device_ms": plain_row["plain_device_ms"],
            "plain_shape": plain_row["shape"],
            # the kernel and SDPA's backward at the plain version's shape,
            # to compare with it
            "ms_at_plain_shape": plain_row[kern + "_ms"],
            "device_ms_at_plain_shape": plain_row[kern + "_device_ms"],
            "library_device_ms_at_plain_shape":
                plain_row["library_device_ms"],
            "bound_ms": src_row[kern + "_bound_ms"],
            "bound_by": src_row[kern + "_bound_by"],
            "library_ms": src_row["library_ms"],
            "library_device_ms": src_row["library_device_ms"],
            "at_d256": {k: d256_row[k] for k in (
                "shape", kern + "_ms", kern + "_device_ms",
                kern + "_bound_ms", "library_ms", "library_device_ms")},
            # f32: the 3 x TF32 C1, C2 and C3 of csrc/flash_bwd.cu, each
            # beside its 3 x TF32 bound and its FMA bound
            "design_f32": "3xTF32 mma.sync m16n8k8, operands split in "
                          "registers, cp.async ring",
            "at_train_f32": {k: train_bwd_f32_row[k] for k in (
                "shape", "dtype", kern + "_ms", kern + "_device_ms",
                kern + "_bound_ms", kern + "_bound_by",
                kern + "_bound_fma_ms", kern + "_bound_basis",
                kern + "_bound_share", "plain_ms", "plain_device_ms",
                "library_ms", "library_device_ms", "split_device_ms",
                "c1_call_device_ms")},
            "other_f32": [{k: r[k] for k in (
                "shape", "dtype", "causal", kern + "_device_ms",
                kern + "_bound_ms", kern + "_bound_fma_ms",
                kern + "_bound_share", "library_device_ms") if k in r}
                for r in list(f32_bwd_rows.values()) + f32_bwd_long_rows
                if r is not train_bwd_f32_row]}
        if kern != "flash_bwd":
            for name, row in (("at_train", train_bwd_row),
                              ("at_d128", d128_row)):
                entry[name] = {k: row[k] for k in (
                    "shape", kern + "_ms", kern + "_device_ms",
                    kern + "_bound_ms", "library_ms", "library_device_ms")}
        else:
            # C1 on the tensor cores: its whole call beside the split
            # route's, its tiles, and fp16, at each timed shape
            cols = ("shape", "dtype", "flash_bwd_ms", "flash_bwd_device_ms",
                    "c1_call_device_ms", "flash_bwd_call_device_ms",
                    "flash_bwd_tiles_device_ms",
                    "split_call_device_ms", "flash_bwd_dq_device_ms",
                    "flash_bwd_dkv_device_ms", "flash_bwd_bound_ms",
                    "library_device_ms")
            entry["by_shape"] = [{k: r[k] for k in cols if k in r}
                                 for r in bwd_rows + [long_row]
                                 if "flash_bwd_call_device_ms" in r
                                 and r.get("dtype", "bfloat16") != "float32"]
            entry["ptxas"] = merged_ptxas
            entry["c1_call_device_ms"] = src_row["c1_call_device_ms"]
            entry["launches_of"] = (
                "the f32 C1 (source_f32) on train_f32's steps; bf16 "
                "and fp16 take the split pair on every path, so the 16-bit "
                "C1 runs only where route='merged' is pinned (the checks)")
        return entry

    def ce_entry(name, replaces, launches, by_path):
        row = ce_rows[name]
        return {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/cross_entropy.cu",
            "replaces": "paddle_tpu/kernels/ce_pallas.py:%d" % replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(row["max_abs_err"],
                               ce_rows["small"][name + "_err"]),
            "shape": row["shape"], "ms": row["kernel_ms"],
            "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"]}
    split_err = max(long_plain_row["split_dq_err"],
                    long_plain_row["split_dk_err"],
                    long_plain_row["split_dv_err"])
    tc_err = max([r["max_abs_err"] for r in flash_rows
                  if r["kernel"] == "flash_fwd_tc"]
                 + [row[k] for row in (long_plain_row, long_row)
                    for k in ("flash_fwd_tc_err", "flash_fwd_tc_f16_err")])
    split_launches = {
        "train": run_train["launches"]["flash_bwd_dq"],
        "train_long": run_long["launches"]["flash_bwd_dq"],
        "train_fp16": run_fp16[0]["launches"]["flash_bwd_dq"],
        **layout_launches("flash_bwd_dq")}
    emit({"kernels": [
        {"name": "flash_fwd_tc", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd_tc.cu",
         "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:382, "
                     ":450 and :519 (bf16 and fp16)",
         "launches": run_train["launches"]["flash_fwd_tc"],
         "launches_by_path": tc_launches,
         "max_abs_err": tc_err, "shape": tc_prefill["shape"],
         "blocks": tc_prefill["blocks"], "ms": tc_prefill["kernel_ms"],
         "device_ms": tc_prefill["kernel_device_ms"],
         "plain_ms": tc_prefill["plain_ms"],
         "plain_device_ms": tc_prefill["plain_device_ms"],
         "bound_ms": tc_prefill["bound_ms"],
         "bound_by": tc_prefill["bound_by"],
         "library_ms": tc_prefill["library_ms"],
         "library_device_ms": tc_prefill["library_device_ms"],
         "at_train": dict(fwd_cols(tc_train),
                          plain_ms=tc_train["plain_ms"],
                          plain_device_ms=tc_train["plain_device_ms"]),
         "at_s16384": {k: long_row[k] for k in (
             "shape", "flash_fwd_tc_blocks", "fwd_flash_fwd_tc_ms",
             "fwd_flash_fwd_tc_device_ms", "fwd_flash_fwd_tc_f16_device_ms",
             "fwd_tiles_device_ms", "fwd_library_ms",
             "fwd_library_device_ms", "fwd_bound_ms", "fwd_bound_by")},
         "at_s16384_h2": {k: long_plain_row[k] for k in (
             "shape", "fwd_flash_fwd_tc_ms", "fwd_flash_fwd_tc_device_ms",
             "fwd_flash_fwd_tc_f16_device_ms", "fwd_plain_ms",
             "fwd_plain_device_ms", "fwd_library_ms",
             "fwd_library_device_ms", "fwd_bound_ms")},
         "other_rows": [fwd_cols(r) for r in flash_rows
                        if r["kernel"] == "flash_fwd_tc"
                        and r not in (tc_prefill, tc_train)]},
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:382 "
                     "and :450 (f32)",
         "launches": run_f32["launches"]["flash_fwd"],
         "launches_by_path": f32_launches["flash_fwd"],
         "max_abs_err": max([a_prefill["max_abs_err"],
                             a_train["max_abs_err"]]
                            + [r["max_abs_err"] for r in f32_long_rows
                               if "max_abs_err" in r]
                            + f32_fwd_errs["A"]),
         "dtype": "float32", "shape": a_prefill["shape"],
         "ms": a_prefill["kernel_ms"],
         "device_ms": a_prefill["kernel_device_ms"],
         "plain_ms": a_prefill["plain_ms"],
         "bound_ms": a_prefill["bound_ms"],
         "bound_by": a_prefill["bound_by"],
         "bound_fma_ms": a_prefill["bound_fma_ms"],
         "library_ms": a_prefill["library_ms"],
         "library_device_ms": a_prefill["library_device_ms"],
         "design": "3xTF32 mma.sync m16n8k8; q split once (registers at "
                   "D 64), K/V by a two-stage cp.async ring",
         "at_train": dict(fwd_cols(a_train), plain_ms=a_train["plain_ms"]),
         "at_s16384": [dict(fwd_cols(r), plain_ms=r.get("plain_ms"),
                            plain_device_ms=r.get("plain_device_ms"))
                       for r in f32_long_rows],
         "by_shape": f32_fwd_summary("A"),
         "ptxas": [r for r in f32_fwd_ptxas
                   if "pipelined" not in r["kernel"]]},
        {"name": "flash_fwd_pipelined", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd_pipelined_tc.cu",
         "source_f32": "paddle_tpu_torch/csrc/flash_fwd_pipelined.cu",
         "replaces": "paddle_tpu/kernels/flash_attention_pallas.py:519",
         "launches": run_pipe["launches"]["flash_fwd_pipelined"],
         "launches_by_path": {
             "train_pipelined": run_pipe["launches"]["flash_fwd_pipelined"],
             "parity_pinned": parity_pinned["flash_fwd_pipelined"],
             "train_autotune":
                 run_tuned["launches"]["flash_fwd_pipelined"]},
         "max_abs_err": max([pipe_err] + f32_fwd_errs["A'"]),
         "shape": pipe_train["shape"],
         "blocks": pipe_train["blocks"], "ms": pipe_train["kernel_ms"],
         "device_ms": pipe_train["kernel_device_ms"],
         "plain_ms": pipe_train["plain_ms"],
         "plain_device_ms": pipe_train["plain_device_ms"],
         "bound_ms": pipe_train["bound_ms"],
         "bound_by": pipe_train["bound_by"],
         "library_ms": pipe_train["library_ms"],
         "library_device_ms": pipe_train["library_device_ms"],
         "default_fwd_device_ms": pipe_train["default_fwd_device_ms"],
         "autotune_winner_at_train": autotune_lines[0]["winner"],
         "by_shape": [{k: r[k] for k in (
             "shape", "dtype", "blocks", "kernel_ms", "kernel_device_ms",
             "plain_ms", "bound_ms", "library_ms", "library_device_ms",
             "default_fwd_blocks", "default_fwd_device_ms") if k in r}
             for r in pipe_rows if r["shape"] in (
                 [1, 128, 16, 64], [8, 1024, 16, 64], [1, 16384, 2, 64],
                 [1, 16384, 16, 64])],
         "ptxas": pipe_ptxas,
         # f32: kernel A's body behind a ring of three stages where they fit
         "f32_by_shape": f32_fwd_summary("A'"),
         "ptxas_f32": [r for r in f32_fwd_ptxas
                       if "pipelined" in r["kernel"]]},
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/layer_norm_fwd.cu",
         "replaces": "paddle_tpu/kernels/norm_pallas.py:118",
         "launches": run_train_norm["launches"]["layer_norm_fwd"],
         "launches_by_path": {
             "serve_use_pallas_norm": run_norm["launches"]["layer_norm_fwd"],
             "serve_paged_use_pallas_norm":
                 run_paged_norm["launches"]["layer_norm_fwd"],
             "serve_paged_tight": run_tight["launches"]["layer_norm_fwd"],
             **{"serve_spec_%s_use_pallas_norm" % name:
                spec_runs[(name, True)]["launches"]["layer_norm_fwd"]
                for name in ("serve", "span")},
             **{"serve_quant_" + name: run["launches"]["layer_norm_fwd"]
                for name, run in quant_runs.items()},
             **{"serve_http_" + name: run["launches"]["layer_norm_fwd"]
                for name, run in http_runs.items()},
             "chunk_capture_eager_chunks":
                 chunk_line["launches"]["layer_norm_fwd"],
             "serve_tier": tier_line["launches"]["layer_norm_fwd"],
             "serve_disagg": disagg_line["launches"]["layer_norm_fwd"],
             "serve_fleet": fleet_line["launches"]["layer_norm_fwd"],
             **{"serve_scan_%s_%s" % (r["engine"], r["loop"]):
                r["layer_norm_fwd_launches"] for r in scan_line["runs"]},
             "tp2_gloo_rank0_serve":
                 run_tp2["serve_launches"]["layer_norm_fwd"],
             **{"tp2_gloo_rank0_serve_overlap_" + name:
                run_tp2["overlap"][name]["launches"]["layer_norm_fwd"]
                for name in ("per_layer", "scan")},
             "train_norm": run_train_norm["launches"]["layer_norm_fwd"],
             "train_fp16_use_pallas_norm":
                 run_fp16[1]["launches"]["layer_norm_fwd"],
             **{"serve_http_tp2_rank%d" % r:
                run_serve_tp2["launches"][r]["layer_norm_fwd"]
                for r in (0, 1)},
             "pp_single": run_pp["launches"]["layer_norm_fwd"],
             **{"pp2_gloo_stage%d" % st:
                run_pp2["launches"][st]["layer_norm_fwd"] for st in (0, 1)},
             **{"pp2_sdp2_gloo_%s_rank%d" % (run, r):
                run_pp2["sdp2"][run]["launches"][r]["layer_norm_fwd"]
                for run in ("sdp_stage1", "sdp_stage2") for r in (0, 2)},
             **launched_launches("layer_norm_fwd")},
         "max_abs_err": max(ln_err, ln16_err), "ms": decode_row["kernel_ms"],
         "device_ms": decode_row["kernel_device_ms"],
         "plain_ms": decode_row["plain_ms"],
         "bound_ms": decode_row["bound_ms"],
         "bound_by": decode_row["bound_by"],
         "library_ms": decode_row["library_ms"],
         "shape": decode_row["shape"],
         "library_device_ms": decode_row["library_device_ms"],
         "at_other_rows": [{k: r[k] for k in ln_cols}
                           for r in ln_rows if r is not decode_row],
         "at_train_fp16": {k: ln16_rows[0][k] for k in ln_cols},
         "ptxas": [r for r in ln_ptxas if "fwd" in r["kernel"]]},
        bwd_entry("flash_bwd", train_bwd_row, train_bwd_row,
                  run_f32["launches"]["flash_bwd"],
                  f32_launches["flash_bwd"], bwd_err["flash_bwd"]),
        bwd_entry("flash_bwd_dq", long_row, long_plain_row,
                  run_train["launches"]["flash_bwd_dq"], split_launches,
                  max(bwd_err["flash_bwd_dq"], split_err)),
        bwd_entry("flash_bwd_dkv", long_row, long_plain_row,
                  run_train["launches"]["flash_bwd_dkv"],
                  dict(split_launches,
                       train=run_train["launches"]["flash_bwd_dkv"],
                       **layout_launches("flash_bwd_dkv")),
                  max(bwd_err["flash_bwd_dkv"], split_err)),
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
         "replaces": "paddle_tpu/kernels/norm_pallas.py:132",
         "launches": run_train_norm["launches"]["layer_norm_bwd"],
         "launches_by_path": {
             "train_norm": run_train_norm["launches"]["layer_norm_bwd"],
             "train_fp16_use_pallas_norm":
                 run_fp16[1]["launches"]["layer_norm_bwd"],
             "pp_single": run_pp["launches"]["layer_norm_bwd"],
             **{"pp2_gloo_stage%d" % st:
                run_pp2["launches"][st]["layer_norm_bwd"] for st in (0, 1)},
             **{"pp2_sdp2_gloo_%s_rank%d" % (run, r):
                run_pp2["sdp2"][run]["launches"][r]["layer_norm_bwd"]
                for run in ("sdp_stage1", "sdp_stage2") for r in (0, 2)},
             **launched_launches("layer_norm_bwd")},
         "max_abs_err": max(ln_bwd_err, ln16_bwd_err),
         "shape": ln_bwd_row["shape"],
         "ms": ln_bwd_row["kernel_ms"],
         "device_ms": ln_bwd_row["kernel_device_ms"],
         "plain_ms": ln_bwd_row["plain_ms"],
         "bound_ms": ln_bwd_row["bound_ms"],
         "bound_by": ln_bwd_row["bound_by"],
         "library_ms": ln_bwd_row["library_ms"],
         "library_device_ms": ln_bwd_row["library_device_ms"],
         "rows_pass_device_ms": ln_bwd_row["rows_pass_device_ms"],
         "reduce_device_ms": ln_bwd_row["reduce_device_ms"],
         "at_other_rows": [{k: r[k] for k in ln_bwd_cols}
                           for r in ln_bwd_rows if r is not ln_bwd_row],
         "at_train_fp16": {k: ln16_bwd_rows[0][k] for k in ln_bwd_cols},
         "ptxas": [r for r in ln_ptxas if "bwd" in r["kernel"]]},
        ce_entry("ce_lse", 188, run_lse["launches"]["ce_lse"],
                 {"train_ce_use_pallas_lse": run_lse["launches"]["ce_lse"],
                  "train_parity_use_pallas_lse":
                      parity_by["use_pallas_lse"]["ce_lse"]}),
        ce_entry("ce_fwd", 44, run_ce["launches"]["ce_fwd"],
                 {"train_ce_use_pallas_ce": run_ce["launches"]["ce_fwd"],
                  "train_parity_use_pallas_ce":
                      parity_by["use_pallas_ce"]["ce_fwd"]}),
        ce_entry("ce_bwd", 56, run_ce["launches"]["ce_bwd"],
                 {"train_ce_use_pallas_ce": run_ce["launches"]["ce_bwd"],
                  "train_parity_use_pallas_ce":
                      parity_by["use_pallas_ce"]["ce_bwd"]}),
        # on no path of either package: only its tests call the JAX
        # softmax_pallas, so no run launches it
        {"name": "softmax_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/softmax_fwd.cu",
         "replaces": "paddle_tpu/kernels/norm_pallas.py:260",
         "launches": run_train["launches"]["softmax_fwd"],
         "launches_by_path": {}, "on_a_path": False,
         "max_abs_err": max(r["max_abs_err"] for r in soft),
         "shape": soft[0]["shape"], "ms": soft[0]["kernel_ms"],
         "device_ms": soft[0]["kernel_device_ms"],
         "plain_ms": soft[0]["plain_ms"],
         "plain_device_ms": soft[0]["plain_device_ms"],
         "bound_ms": soft[0]["bound_ms"], "bound_by": soft[0]["bound_by"],
         "library_ms": soft[0]["library_ms"],
         "library_device_ms": soft[0]["library_device_ms"],
         "design": "rows in registers (a warp, 128 or 256 threads a row "
                   "up to F = 8192), one (max, sum) merge; staged rows "
                   "past that",
         "at_other_shapes": [{k: r[k] for k in (
             "shape", "dtype", "kernel_ms", "kernel_device_ms", "plain_ms",
             "plain_device_ms", "bound_ms", "bound_share", "library_ms",
             "library_device_ms")} for r in soft[1:]]}]})
    tune_dir.cleanup()
    device_line(torch, kind)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        warm_stop()
    sys.exit(code)
