#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` for sm_90a;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving paths' shapes (paged decode and flash at qwen2-0.5b's head dim
     64 and phi4-mini-3.8b's 128; paged decode at qwen2's layout also at
     B=16 and 32, the ``[load:qwen2]`` buckets; both at head dim 128 at the
     three GQA layouts of mistral-nemo-12b, starcoder2-15b and chameleon-34b:
     G = 4, 12 and 8 query heads per KV head; flash at the MoE decoders'
     layouts, G = 2 at D=64 and G = 8 at D=128; flash at whisper-small's,
     12 heads over 12 at D=64: non-causal over 1500 frames at B=1 and 8,
     causal at B=8 over 4 and 448 tokens), and time kernel, plain
     version, the library call where one exists (SDPA, a yardstick the port
     never calls) and the bound.  Attention: bf16 max-abs 2e-2, the reference's own
     tolerance (bf16 flash runs on the tensor cores and rounds P to bf16 for
     P V, where the plain version keeps it in f32); f32 1e-4, because the
     sum order differs.  SSD: max-abs 1e-4 of max|y| (of max|h| for the
     state), for bf16 and f32 B/C alike, since both versions compute to f32
     accuracy from the same converted inputs (the kernels in split TF32) but
     sum in other orders and chunk lengths (the kernels scan in chunks of
     64, the plain version of 256).  RG-LRU: max-abs 1e-5 of max|y|: both
     sides compute in f32 from the same inputs, the kernel in segments of
     its own (held also against ``ref_rglru_segmented``, its order in plain
     PyTorch), the plain version log-depth.  ``[moe]``: the MoE FFN on the
     card against the same function on the CPU in f32 (``moe_cases``):
     routing and dispatch exact, y max-abs 1e-5, aux 1e-6 of max(1, |aux|);
     then ``[shapes]`` (``shapes_phase``): the three kernels at the padded
     instances, each case against its plain version with its phase's
     tolerance and timed beside its bound, plain and SDPA times (flash D =
     16, 40, 80, 96, 112, 160 and the unpadded 64 and 128 at 32 heads over
     8; paged decode hd = 16, 80, 96, 256 and 64, 128 at 8 kv heads of 4;
     SSD (P, N, G) = (16, 16, 1), (64, 64, 1), (32, 64, 2), (64, 128, 8),
     (64, 256, 1) at 24 heads), then the serving CLI's own path,
     ``launch.serve.main --arch mamba2-130m`` at ``--preset tiny``, ``20m``
     and ``100m`` (SSD at P = 64, N = 64; runner and graphs on), each held
     to the same engine on the plain versions' token streams, and
     qwen2-0.5b's ``smoke()`` config (head dim 16) served like phase 4's
     models, paged decode and flash prefill;
  4. serve full-width qwen2-0.5b (24 layers, bf16, seeded random weights)
     through the port's ``ServeEngine`` with paged decode and flash prefill,
     and check that path against its plain version on a small f32 input;
     then ``[serve:churn]``: the same model on a trace profiled at 8
     generated tokens whose live requests ask 32-48, so the pool runs out,
     requests are preempted and the pool is replanned, with graphs against
     eager and at ``replan_interval`` None and 4; then ``[serve:shared]``:
     the same model serving 32 requests (prompts 256-1024, 64 generated
     tokens) beside a fine-tune of the same weights (SGD, its gradient norm
     clipped to 1, on a private bf16 replica, B=2 x S=512, the plain
     attention path) in one
     ``SharedArena``, at a budget halfway between the joint plan's peak and
     the two tenants' standalone sum, so the run fits only because the
     tenants share; the fine-tune steps fire in the valleys the arena
     scheduled (``launch.serve.run_interleaved``), and the token streams
     must equal those of the same engine run with no fine-tune steps; then
     ``[load:qwen2]`` (``load_phase``): the same weights serving the
     ``launch/load.py`` burst cell (32 requests, two priority classes, the
     pool planned from the trace with every generation halved) traced with
     graphs, untraced and traced eagerly, with spans, SLOs, drift and a
     validated Perfetto export; then
     the same serving path for full-width, full-depth phi4-mini-3.8b (32
     layers, head dim 128, 7.7 GB of bf16 weights) on the first trace; then
     the same for the three untied dense decoders at full width and depth
     (``dense_phase``: ``[serve:mistral]`` mistral-nemo-12b, 40 layers, 8 KV
     heads of 4 at head dim 128, attention width 4096 against d_model 5120,
     24.5 GB; ``[serve:starcoder2]`` starcoder2-15b, 40 layers, 4 KV heads of
     12, LayerNorm, the biased tanh-gelu MLP, 31.9 GB; ``[serve:chameleon]``
     chameleon-34b, 48 layers, 8 KV heads of 8, 68.6 GB, with the card's free
     memory after the load, the init peak, the planned and the physical
     pool and ``max_memory_allocated`` over each run), each model freed
     before its f32 2-layer check and before the next model is drawn; then
     the two MoE decoders the same way in gather mode, their prompts
     unpadded (``[serve:granite-moe]`` granite-moe-1b-a400m, 24 layers, 32
     experts top-8, 8 KV heads of 2 at head dim 64, 2.67 GB;
     ``[serve:qwen3-moe]`` qwen3-moe-30b-a3b, 48 layers, 128 experts top-8,
     4 KV heads of 8 at head dim 128, 61.07 GB): launches exactly
     ``n_layers`` per prefill and none of the paged, SSD or RG-LRU kernels,
     one prefill shape per distinct prompt length, and an f32 2-layer check
     of gather+kernel against gather+full (granite-moe's also served on the
     CPU, whose token streams must equal the card's); then
     ``[serve:granite-moe:b16]`` (``moe_b16_phase``): granite-moe at
     max_batch 16 on a burst of 16 requests, so that bucket 16 decodes 16
     rows against an expert capacity of 8, with the eager run's drop share
     printed, graphs against eager, and its f32 2-layer cut at max_batch 16
     on the card and the CPU with identical token streams; then
     ``[serve:whisper]`` (``whisper_phase``): whisper-small, the
     encoder-decoder, at full width and depth (12 + 12 layers) serving 8
     requests through ``runtime.serve_lib``'s prefill over tokens and
     seeded frames (flash non-causal in the encoder, causal in the decoder:
     24 launches a prefill) and its decode step, both eagerly and both
     graphed (equal streams; one decode capture and one prefill capture,
     the prefill replayed with 24 launches; prefill ms graphed and eager at
     B=1 and B=8), with the cross cache's measured bytes beside
     the reference's accounting, an f32 2+2-layer cut on the card and the
     CPU (equal streams, prefill logits within 1e-4) and the full-depth
     bf16 forward against the plain version;
  5. serve full-width mamba2-130m (24 layers, bf16, seeded random weights)
     in gather mode with the SSD kernel in every prefill, then
     ``[load:mamba2]``, the diurnal load cell on the same weights, then
     check it against its plain path: token streams of a 2-layer f32 model, and the
     full-width bf16 ``forward`` logits, within twice what re-chunking the
     plain path moves them;
  6. serve full-width, full-depth recurrentgemma-9b (38 layers, bf16, seeded
     random weights drawn and cast one leaf at a time) in gather mode with
     the RG-LRU kernel in every rec prefill and the D=256 flash kernel in
     every local prefill, on a trace whose two longest prompts pass the
     2048-token window; then check it against its plain path: token streams
     of a 5-layer full-width f32 model (one group and the tail), and the
     bf16 ``forward`` logits over 2600 tokens of the served weights cut to
     one group and the tail, within twice what re-blocking the plain scan
     moves them (at full depth the random-weight stack is chaotic enough
     that the yardstick itself moves most argmaxes: that reading is
     printed, not held);
  7. train full-width qwen2-0.5b cut to 4 of its 24 layers
     (``[train:qwen2]``, ``TRAIN_QWEN2_LAYERS``), then full-width
     granite-moe-1b-a400m cut to 12 of its 24 layers
     (``[train:granite-moe]``, ``TRAIN_MOE_LAYERS``: 32 experts top-8, the
     reference's ``ce + 0.01 aux``, capacity 1280 at T = 4096), each at
     B=8 x S=512, then the patterns beyond the attention decoder
     (``TRAIN_PATTERNS``): ``[train:whisper]`` whisper-small at 12 + 12
     layers, B=8 x S=448 over the pipeline's seeded (8, 1500, 768) frames;
     ``[train:mamba2]`` mamba2-130m cut to 4 of its 24 layers, B=8 x
     S=512; ``[train:recurrentgemma]`` recurrentgemma-9b at full width cut
     to one (rec, rec, local) group and its two rec tail layers (3.1 B
     parameters, 49.6 GB of training state), B=1 x S=2560, past its
     2048-token window; each with bf16 compute over f32 masters, the
     synthetic pipeline from seed 0, through the paper's loop: a
     ``make_fx`` profile of the grad step on fake tensors (blocks, bytes,
     the liveness lower bound, the best-fit and pool-allocator peaks), the
     closed-loop remat plan and the largest batch that fits 80 GB without
     remat (up to 256; granite-moe, whisper and mamba2 up to 64, the hybrid
     up to 8), then 5 AdamW steps each under no remat, full remat and the
     planned policy from the same initial state, with step ms and measured
     against planned peak memory, the step's and the grad step's alone
     (the step's also holds the optimizer update's temporaries), and the
     step-1 batch's loss after 5 no-remat steps at two other learning
     rates, printed (granite-moe: ce and aux apart at the first and last
     step, the dispatch's drop share over the no-remat steps).  Each fails
     unless the no-remat losses are finite, the loss on step 1's batch has
     fallen after the 5 steps (the batch is evaluated again after
     training: each step draws a fresh batch, and at these depths and
     learning rates the step losses of fresh batches move less than the
     batches differ, so their trend is printed, not held), the other two
     policies' losses match them within 1e-3 relative at every step, and
     their grad norms at every step and parameters after the 5 steps
     within 1e-5 relative (L2 over every leaf), no kernel launches, and an
     f32 cut of the same width (2 layers; whisper's 2 + 2; the hybrid's
     same 5) gives the same loss on the card as on the CPU (1e-5
     relative) and gradients no further from a float64 CPU run than twice
     the CPU's own f32 gradients (relative L2 over every leaf), TF32 off;
     granite-moe's cut must first route alike on the card and the CPU
     (every layer's ``keep`` and ``dest``); after each cell a
     after the five cells, one ``[roofline:<tag>]`` line each
     (``roofline_phase``): ``launch/roofline``'s model FLOPs of the cell,
     the dry run's aten dot FLOPs and HBM bytes of the same whole step
     (gradient and AdamW, traced on fake tensors, ``roofline_trace``: one
     worker process a cell, all started once the cells' steps are timed, so
     that nothing runs beside a timed phase) under no and full remat, their compute and memory terms and bound on
     the H100, the measured median step of each policy, MFU (model FLOPs
     over the step time at the compute dtype's peak), measured over bound,
     and the dry run's retained + DSA against the measured peak of the
     same policy; beside those traces, in two more workers of the same
     pool, ``[dryrun:multi]``: qwen2-0.5b's ``train_4k`` (full remat) and
     ``decode_32k`` at full width and 8 of 24 layers
     (``DRYRUN_MULTI_LAYERS``), traced over the reference's (pod 2, data
     16, model 16) mesh as rank 0 of a 512-rank fake process group on fake
     CPU tensors (``dryrun_multi_trace``), each printing per device its dot
     FLOPs, HBM bytes, collective wire bytes by kind, compute, memory and
     collective terms, retained + DSA, whether that fits one H100 and the
     trace's seconds; fails unless the training cell moves collective
     bytes;
  8. the paper's own nets at their registered sizes, f32, TF32 off
     (``paper_cnn_phase``, ``paper_s2s_phase``, through ``launch/paper.py``):
     ``[paper:alexnet]``, ``[paper:resnet50]`` (224x224) and
     ``[paper:inception-resnet]`` (299x299), each profiled (the SGD step's
     Fig. 2 row, naive / pool / DSA, and B=1 inference's), trained 3 SGD
     steps at the largest of 8, 16, 32, 64 whose retained + DSA peak fits
     the card's free memory (Inception-ResNet cut to 4 for the script's
     time) with the measured allocated and reserved peaks over the plan,
     the largest batch each allocator fits in 80 GB (DSA's boundary traced
     at b and b + 1), and a 64x64 B=2 cut held against the CPU; ``[paper:seq2seq]`` (vocab 40,000, d 512, 2
     layers) at B=64 over lengths 10, 30 and 50, a profile per length
     replayed through a signature-mode arena before each step (its replans
     stop once every length has been seen), 100 greedy tokens at B=1, and a
     small cut's greedy tokens on the card and the CPU;
  9. ``[chunked]`` (``chunked_phase``): ``attend_chunked`` against
     ``attend_full`` at qwen2-0.5b's layout over 16384 bf16 tokens, with
     each one's peak, and ``attend_full`` with ``softmax_dtype="bfloat16"``
     (bf16 score storage) against its f32 path, with its peak; then a grad step of full-width qwen2-0.5b cut to 2
     layers under ``attention_impl="auto"`` (chunked past 8192) against
     ``"full"``, without and with full remat, at the largest S of 16384,
     12288, 10240 whose no-remat plans fit the card: losses and gradients;
     then the chunked backward over 8448 tokens held against float64 in
     f32 and bf16 (``chunked_witness``);
  10. ``[mesh:*]`` (``mesh_phase``): the sharded path on the one-card
     mesh (``launch.mesh.one_card_mesh``: a (data=1, model=1)
     ``DeviceMesh`` over a world-size-1 NCCL group that meets through a
     ``HashStore``), where every placement is local and no collective moves
     data: ``[mesh:train]`` runs 3 AdamW steps of qwen2-0.5b at full width,
     4 of its 24 layers, B=8 x S=512, bf16 over f32 masters, full remat,
     through ``build_train_step(model, mesh)`` over DTensor state and the
     same through ``mesh=None`` from the same parameters, and prints both
     median step times, the largest relative loss difference (fails above
     1e-3, bf16's resolution), the parameters' relative L2 difference and
     whether the two are bit-identical; ``[mesh:serve]`` serves qwen2-0.5b
     at full width and depth (the phase-4 trace: 12 requests, 32 generated
     tokens each, max_batch 8, the paged pool) eagerly through
     ``ServeEngine(mesh=...)`` (DTensor parameters and pool, the kernels
     through ``local_map``), with the launch counters set to 0 just before
     it, beside phase 4's eager run without a mesh on the same weights and
     trace, then the same engine with CUDA graphs under the mesh (one
     capture per bucket and per rung at warmup, none in the run, one
     replay per prefill) beside phase 4's graphed run without a mesh and
     the eager mesh run, and fails unless the greedy streams of all of them
     are identical and each run launched the paged and flash kernels;
  11. print the load phases' launches (``[load] launches``), the kernels
     JSON line, the card line, and the result line.

Every serving path runs twice on the same trace and weights, first with the
runner's steps and prefill eager (``graphs=False``), then replaying one CUDA
graph per batch bucket and, for the pure-attention decoders' padded
prompts, one per rung of the prompt ladder (8 at max_len 1024, captured at
warmup, none while serving, one replay per prefill), the engine's default
on the card: a ``[graph:<model>]`` line prints both runs' decode step ms,
tokens/s, prefill ms (and the eager/graphed ratio of both), the decode and
prefill graph pools' bytes and compile counts, and the run fails unless
every request's token stream is the same in both.  The f32 ``[check]``
runs of token streams also hold graphs against eager.  Each run of a path, and the training phase, runs
with every launch counter set to 0 just before it and read just after it
(a captured launch counts once per replay), and each path's models are
freed before the next.

Imports nothing of JAX.  Stdout's last line is the result JSON.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import itertools
import json
import math
import random
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SSD_REL_TOL = 1e-4          # of max|y| / max|h|, both B/C dtypes
RGLRU_REL_TOL = 1e-5        # of max|y|
ARCH = "qwen2-0.5b"
PHI4_ARCH = "phi4-mini-3.8b"
SSM_ARCH = "mamba2-130m"
HYBRID_ARCH = "recurrentgemma-9b"
# the untied dense decoders served at full width and depth: (arch, tag)
DENSE_ARCHS = (("mistral-nemo-12b", "mistral"), ("starcoder2-15b", "starcoder2"),
               ("chameleon-34b", "chameleon"))
# the MoE decoders served at full width and depth in gather mode: (arch, tag)
MOE_ARCHS = (("granite-moe-1b-a400m", "granite-moe"), ("qwen3-moe-30b-a3b", "qwen3-moe"))
MOE_Y_TOL = 1e-5            # [moe]: f32 y, card against CPU, max-abs
MOE_AUX_TOL = 1e-6          # [moe]: f32 aux, card against CPU, of max(1, |aux|)
# [serve:granite-moe:b16]: a burst of 16 short prompts at max_batch 16, so
# that 9 or more requests decode together and bucket 16 runs with T > C
MOE_B16_BATCH, MOE_B16_REQUESTS, MOE_B16_MIN_LIVE = 16, 16, 9
# [serve:whisper]: whisper-small serving 8 requests at once, each a prompt of
# 4 seeded ids (the length of whisper's start-of-transcript sequence) over
# its own seeded frames, in its 448-token text context, 224 greedy tokens
# each (whisper's sample length); the f32 cut generates fewer
WHISPER_ARCH = "whisper-small"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_LEN, WHISPER_GEN = 8, 4, 448, 224
WHISPER_CUT_BATCH, WHISPER_CUT_GEN = 4, 32
MAX_BATCH, MAX_LEN, GEN_LEN, N_REQUESTS, SEED = 8, 1024, 32, 12, 0
CHURN_PROFILED_GEN = 8      # the churn trace's profile; live requests ask 32-48
# [serve:shared]: 32 requests of 256-1024 prompt tokens and 64 generated ones
# (~0.4 GB of KV at full width) beside a fine-tune of B=2 x S=512
# (launch.serve.FULL_FINETUNE_SEQ_BATCH), 2 fine-tune steps per serving round
SHARED_REQUESTS, SHARED_GEN, SHARED_MAX_LEN, SHARED_TRAIN_STEPS = 32, 64, 2048, 2
HYBRID_MAX_LEN = 4096       # room for the 2100-3000-token prompts
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
# [train:qwen2] runs 4 of qwen2-0.5b's 24 layers and [train:granite-moe] 12
# of its 24, so that the five training phases (most of their time the remat
# searches and the batch searches' profiles on the host) fit the script's time
TRAIN_QWEN2_LAYERS = 4
TRAIN_MOE_LAYERS = 12
TRAIN_MOE_BATCH_HI = 64     # [train:granite-moe]'s largest batch tried without remat
# the patterns beyond the attention decoder: (arch, tag, layers (None: all),
# B, S, largest batch tried without remat, f32 cut's layers).  whisper-small
# at its 448-token text context over 1500 frames, 12 + 12 layers;
# mamba2-130m at the other cells' B=8 x S=512 (2 SSD chunks of 256 a layer)
# cut to 4 of its 24 layers, as qwen2 is, for the script's time (at 24 its
# remat search alone takes minutes on the host); recurrentgemma-9b at full
# width cut to one (rec, rec, local) group and its two rec tail layers (full
# depth would hold 154 GB of training state), B=1 x S=2560 so that the
# 2048-token window masks keys; its f32 cut is the same 5 layers
TRAIN_PATTERNS = (("whisper-small", "whisper", None, 8, 448, 64, 2),
                  ("mamba2-130m", "mamba2", 4, 8, 512, 64, 2),
                  ("recurrentgemma-9b", "recurrentgemma", 5, 1, 2560, 8, 5))
# AdamW peak learning rates, each the one of several that lowers the step-1
# batch's loss after 5 steps (random full-width weights).  granite-moe at 24
# layers (gradient norms ~1e13) raised it at 3e-4 and 1e-4 and lowered it at
# 3e-5 and 1e-5; at the 12 layers it runs now it raises it at 3e-4 and 3e-5
# and lowers it at 1e-4.  whisper-small (gradient norms ~1e17) lowers it at
# 1e-3, 3e-4, 1e-4, 3e-5 and 1e-5, most at 1e-5; mamba2-130m (at 24 layers)
# at all five, most at 1e-3, then 3e-4; recurrentgemma-9b's 5 layers most at
# 1e-4, and raise it at 1e-3.  Each phase prints two others beside its own
# (TRAIN_LR_YARDSTICKS)
TRAIN_LR = {"qwen2": 3e-4, "granite-moe": 1e-4, "whisper": 1e-5, "mamba2": 3e-4,
            "recurrentgemma": 1e-4}
TRAIN_LR_YARDSTICKS = {"qwen2": (), "granite-moe": (3e-4, 3e-5), "whisper": (3e-4, 3e-5),
                       "mamba2": (1e-3, 3e-5), "recurrentgemma": (1e-3, 3e-5)}
# the reference's own plan_remat_policy / plan_with_remat parameters; a
# smaller max_evict than the default 256 bounds the search's time (each
# trial repacks ~4400 blocks by best fit)
TRAIN_PLAN = dict(target_ratio=0.5, max_rounds=3, max_evict=32)
TRAIN_LOSS_TOL = 1e-3       # full / planned against no remat, relative
TRAIN_STATE_TOL = 1e-5      # their per-step grad norms and final parameters, relative
CUT_LOSS_TOL = 1e-5         # f32 cut, card against CPU, relative
CUT_GRAD_YARDSTICK = 2.0    # card's gradient distance from float64, over the CPU's
# [paper:*]: the paper's own nets at their registered sizes, each trained at
# the largest of PAPER_BATCHES whose retained + DSA peak fits the card's free
# memory, cut to PAPER_BATCH_CAP for the script's time (Inception-ResNet:
# ~25.6 TFLOP of f32 a sample and step); PAPER_STEPS SGD steps each, at
# ``launch.paper.sgd_lr``'s rate
PAPER_CNNS = (("paper-alexnet", "alexnet"), ("paper-resnet50", "resnet50"),
              ("paper-inception-resnet", "inception-resnet"))
PAPER_BATCHES = (8, 16, 32, 64)
PAPER_BATCH_CAP = {"inception-resnet": 4}
PAPER_STEPS = 3
PAPER_CUT_IMG, PAPER_CUT_BATCH = 64, 2        # the card-against-CPU cut
PAPER_LOGIT_TOL = 1e-4      # of max|logits|, f32, TF32 off
PAPER_PARAM_TOL = 1e-5      # relative L2 of all parameters after one SGD step
# [paper:seq2seq]: B=64 over the three length buckets, then the arena's
# replans; a small cut's greedy tokens on the card and the CPU
S2S_BATCH, S2S_LENGTHS, S2S_STEPS = 64, (10, 30, 50), 6
S2S_CUT = dict(vocab=1000, d_model=128, infer_len=20)
# [chunked]: attention at qwen2-0.5b's layout over 16384 bf16 tokens, then a
# training step of full-width qwen2 cut to 2 layers at the largest of
# CHUNK_SEQS whose no-remat planned peaks fit (auto takes chunked past 8192)
CHUNK_SEQ, CHUNK_SEQS, CHUNK_LAYERS, CHUNK_TOL = 16384, (16384, 12288, 10240), 2, 2e-2
# auto's bf16 gradients (chunked) against full's at that S, relative L2 over
# every leaf, with every wq / wk at std 1/sqrt(d_model): twice the bf16
# witness's distance from float64 (8.3e-3 chunked, 7.4e-3 full), rounded up;
# read 6.8e-3 (one H100, 700 W)
CHUNK_GRAD_TOL = 2e-2
# [mesh:train]: 3 AdamW steps on the one-card mesh against the same unsharded
MESH_TRAIN_STEPS = 3
MESH_LOSS_TOL = 1e-3        # relative, bf16's resolution
# the witness: the same 2 layers with the vocabulary cut to 8192, at 8448
# tokens (8 chunks of 1024 and a padded one of 256), in float64 (full, the
# yardstick), f32 and bf16 (chunked and full); chunked's gradients may be at
# most CUT_GRAD_YARDSTICK times as far from float64's as full's are
CHUNK_WITNESS_SEQ, CHUNK_WITNESS_VOCAB = 8448, 8192


# what each [train:*] cell hands to its [roofline:*] line
TRAIN_CELLS: list = []
# qwen2-0.5b's cells traced over the reference's (pod 2, data 16, model 16)
# mesh in phase 7's roofline pool (``[dryrun:multi]``), at full width and
# DRYRUN_MULTI_LAYERS of its 24 layers (None: all): at 24 the train_4k
# trace took 95 s on the card machine's CPU (torch 2.11), twice the pool's
# 42-47 s, ~3.8 s a layer past the first
DRYRUN_MULTI = ("train_4k", "decode_32k")
DRYRUN_MULTI_LAYERS = 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``.

    Call ms: CUDA events around ``iters`` back-to-back calls — when a call's
    host work (Python, ctypes, allocation) outlasts its kernels, this is the
    host's pace, as the engine sees it.  Device ms: the same calls queued
    behind a GPU sleep long enough to cover their host work, so the kernels
    run back to back and the events time the device alone."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    # hold the stream: ~2e9 cycles/s is at or above the H100's SM clock, so
    # the sleep lasts at least 1.5x the queued calls' host time, which the
    # steady-state pace (call ms, no first-call costs) bounds from above
    torch.cuda._sleep(int(2e9 * (1.5 * iters * call_ms / 1e3 + 2e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, call_ms


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """Least time on an H100 SXM: bytes over HBM bandwidth or operations
    over the dtype's peak rate, whichever is larger.  ``tf32x3`` is the
    split-TF32 datapath: three tensor-core passes per product at the TF32
    rate."""
    from repro_torch.core.planner import (HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                          PEAK_FLOPS_TF32)
    peak = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32,
            "tf32x3": PEAK_FLOPS_TF32 / 3}[dtype]
    t_bytes = n_bytes / HBM_BW
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(name, err, dtype):
    if not math.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"{name}: max_abs_err {err:.3g} > {TOL[dtype]} ({dtype})")


def paged_cases(torch, ops, ref, pt: int, kv: int, group: int, hd: int, layers: int,
                seed: int, bf16_batches=(1, 3, 8), pos_range=(100, 631),
                tag: str = "[paged]"):
    """Paged decode at the engine's pool geometry for a model's head layout
    (``kv`` heads of ``group`` query rows, head dim ``hd``): fragmented
    non-monotonic page tables, partial last pages, zero-padded table tails;
    ``layers`` layer pools cycled so every launch reads K/V from HBM, as
    decode does.  The timed cases run at ``bf16_batches`` (positions drawn
    from ``pos_range``, 100-631 by default, up to B=8 and from the whole
    table past it, as the load cells' batches of up to 32 reach) and at B=8
    in f32.  Besides them, B=1,
    3 and 8 at positions on and across the split-KV kernel's 64-token chunk
    edges, position 0 and the table's last token.  Every case is called
    twice in a row (the completion counters must reset)."""
    F = torch.nn.functional
    maxp = math.ceil(MAX_LEN / pt) + 1
    n_pages = max(MAX_BATCH, *bf16_batches) * maxp
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = random.Random(seed)
    out, worst = {}, {}
    last = maxp * pt - 1
    edges = ([0], [63, 64, 65], [0, 1, 63, 64, 127, 128, last, 500])
    lay = f"hd={hd} KV={kv} G={group}"
    for dtype_name, batches in (("bfloat16", bf16_batches), ("float32", (8,))):
        dt = getattr(torch, dtype_name)
        kp = torch.randn(layers, n_pages, pt, kv, hd, generator=g, device="cuda").to(dt)
        vp = torch.randn(layers, n_pages, pt, kv, hd, generator=g, device="cuda").to(dt)

        def case(pos):
            b = len(pos)
            q = torch.randn(b, kv, group, hd, generator=g, device="cuda").to(dt)
            perm = torch.randperm(n_pages, generator=g, device="cuda").int()
            tables = torch.zeros(b, maxp, dtype=torch.int32, device="cuda")
            for i, p in enumerate(pos):
                used = p // pt + 1
                tables[i, :used] = perm[i * maxp:i * maxp + used]
            positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
            want = ref.ref_paged_attention(q, kp[0], vp[0], tables, positions)
            errs = []
            for _ in range(2):
                got = ops.paged_attention(q, kp[0], vp[0], tables, positions)
                torch.cuda.synchronize()
                errs.append((got.float() - want.float()).abs().max().item())
                check(f"paged {lay} B={b} {dtype_name} positions {pos}", errs[-1],
                      dtype_name)
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), *errs)
            return q, tables, positions, max(errs)

        for pos in edges:
            err = case(pos)[-1]
            print(f"{tag} {lay} edge B={len(pos)} {dtype_name} pt={pt} pos={pos} "
                  f"max_abs_err={err:.3g} (two calls in a row)", flush=True)
        for b in batches:
            pos = [rng.randint(*pos_range) if b <= MAX_BATCH else rng.randint(0, last)
                   for _ in range(b)]
            q, tables, positions, err = case(pos)
            calls = itertools.count()

            def cycled(fn):
                layer = next(calls) % layers
                return fn(q, kp[layer], vp[layer], tables, positions)
            k_ms, k_call = time_ms(torch, lambda: cycled(ops.paged_attention))
            p_ms, _ = time_ms(torch, lambda: cycled(ref.ref_paged_attention))
            # yardstick only: SDPA over an already gathered contiguous copy
            kc = kp[0][tables.long()].reshape(b, -1, kv, hd).transpose(1, 2)
            vc = vp[0][tables.long()].reshape(b, -1, kv, hd).transpose(1, 2)
            mask = (torch.arange(kc.shape[2], device="cuda")[None, :]
                    <= positions[:, None])[:, None, None, :]
            qs = q.reshape(b, kv * group, 1, hd)
            s_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask, enable_gqa=True))
            tok = sum(p + 1 for p in pos)
            isz = q.element_size()
            n_bytes = (2 * q.numel() * isz + tok * 2 * kv * hd * isz
                       + 4 * sum(p // pt + 1 for p in pos) + 4 * b)
            bms, by = bound_ms(n_bytes, 4 * hd * kv * group * tok, dtype_name)
            out[(dtype_name, b)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                        sdpa_ms=s_ms, bound_ms=bms, bound_by=by)
            print(f"{tag} {lay} B={b} {dtype_name} pt={pt} pos={pos} "
                  f"max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
                  f"wrapper_call_ms={k_call:.4f} "
                  f"plain_ms={p_ms:.4f} sdpa_gathered_ms={s_ms:.4f} "
                  f"bound_ms={bms:.5f} ({by})", flush=True)
    return out, worst


def attention_pairs(sq: int, sk: int, q_off: int, window: int, causal: bool = True) -> int:
    """Valid (query, key) pairs of a prefill: causal with an optional
    window, or every one of the Sq x Sk (non-causal, the encoder's)."""
    if not causal:
        return sq * sk
    qp = range(q_off, q_off + sq)
    return sum(min(p + 1, sk) - (max(0, p - window + 1) if window else 0) for p in qp)


def flash_cases(torch, ops, ref, h: int, kv: int, d: int, cases, seed: int,
                iters: int = 20, tag: str = "[flash]"):
    """Flash prefill at a model's head layout against its plain version,
    timed beside SDPA: ``cases`` are (dtype, Sq, window, q_offset[, causal,
    B]), causal at B=1 unless the case says otherwise, and each case is its
    own key of the result.  SDPA gets the causal flag, no mask when
    non-causal, or a boolean mask where a window or an offset needs one."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(seed)
    out, worst = {}, {}
    for case in cases:
        dtype_name, sq, window, q_off, causal, b = (*case, True, 1)[:6]
        dt = getattr(torch, dtype_name)
        sk = sq + q_off
        q = torch.randn(b, sq, kv, h // kv, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, sk, kv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, sk, kv, d, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        qh, kh, vh = q.reshape(b, sq, h, d).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(f"flash D={d} H={h} KV={kv} B={b} Sq={sq} causal={causal} window={window} "
              f"q_offset={q_off} {dtype_name}", err, dtype_name)
        worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
        k_ms, k_call = time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), iters=iters)
        p_ms, _ = time_ms(torch, lambda: ref.ref_attention_bhsd(qh, kh, vh, **kw), iters=5)
        if not causal:
            sdpa = {}
        elif window or q_off:
            qp = torch.arange(sq, device="cuda")[:, None] + q_off
            kp = torch.arange(sk, device="cuda")[None, :]
            mask = (kp <= qp) & ((kp > qp - window) if window else True)
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=True)
        s_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, enable_gqa=True, **sdpa))
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        pairs = b * attention_pairs(sq, sk, q_off, window, causal)
        bms, by = bound_ms(n_bytes, 4 * d * h * pairs, dtype_name)
        out[case] = dict(
            err=err, ms=k_ms, plain_ms=p_ms, sdpa_ms=s_ms, bound_ms=bms, bound_by=by)
        print(f"{tag} D={d} H={h} KV={kv} B={b} Sq={sq} Sk={sk} causal={causal} "
              f"window={window} q_offset={q_off} {dtype_name} max_abs_err={err:.3g} "
              f"kernel_ms={k_ms:.4f} wrapper_call_ms={k_call:.4f} "
              f"plain_ms={p_ms:.4f} sdpa_ms={s_ms:.4f} bound_ms={bms:.5f} ({by})",
              flush=True)
    return out, worst


def ptxas_summary(log: str) -> str:
    """Registers and spills of the (one) kernel in a source's ``-Xptxas=-v``
    output."""
    regs = re.search(r"Used (\d+) registers", log)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    if regs is None or spill is None:
        return "registers=not reported"
    return (f"registers={regs.group(1)} spill_stores={spill.group(1)}B "
            f"spill_loads={spill.group(2)}B")


def rglru_cases(torch, ops, rg, ref, build_info: str):
    """The RG-LRU kernel against its plain version at recurrentgemma-9b's
    width (L=4096): a short prompt, a serving prompt, one past the window
    and a batch of two, with and without h0; beside it, against
    ``ref_rglru_segmented`` (the kernel's own order, on the card).  a and b
    are made as the model's gates make them (a = exp(-8 softplus(1) r),
    b = sqrt(1 - a^2) i x), so y stays O(1).  ``build_info`` (registers and
    spills) is printed beside each time, and so is a yardstick of the
    card's streaming rate for the same bytes: ``torch.add(a, b, out=y)``
    reads a and b and writes y once, 12 B a channel-step, as the scan
    does (it computes another function, so it is no ``library_ms``)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    lru = 4096
    out, worst = {}, 0.0
    for b, s in ((1, 37), (1, 512), (1, 2600), (2, 1024)):
        r = torch.sigmoid(torch.randn(b, s, lru, generator=g, device="cuda"))
        a = torch.exp(-8.0 * math.log1p(math.e) * r)          # softplus(1) = log(1 + e)
        i = torch.sigmoid(torch.randn(b, s, lru, generator=g, device="cuda"))
        x = torch.randn(b, s, lru, generator=g, device="cuda")
        bb = torch.sqrt(torch.clamp(1 - a * a, min=1e-6)) * i * x
        h0 = torch.randn(b, lru, generator=g, device="cuda")
        for with_h0 in (False, True):
            h = h0 if with_h0 else None
            y = ops.rglru_scan(a, bb, h)
            want = ref.ref_rglru(a, bb, h)
            seg = ref.ref_rglru_segmented(a, bb, h, seg=rg.SEG)
            torch.cuda.synchronize()
            err = (y - want).abs().max().item()
            err_seg = (y - seg).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            for what, e in (("plain", err), ("segmented", err_seg)):
                if not (math.isfinite(e) and e <= RGLRU_REL_TOL * scale):
                    raise AssertionError(
                        f"rglru B={b} S={s} h0={with_h0}: max_abs_err against {what} "
                        f"{e:.3g} > {RGLRU_REL_TOL} of max|y| {scale:.3g}")
            worst = max(worst, err)
            k_ms, k_call = time_ms(torch, lambda: rg.rglru_scan_kernel(a, bb, h))
            p_ms, _ = time_ms(torch, lambda: ref.ref_rglru(a, bb, h), iters=5)
            out_buf = torch.empty_like(a)
            add_ms, _ = time_ms(torch, lambda: torch.add(a, bb, out=out_buf))
            n_bytes = 3 * 4 * a.numel() + (4 * h.numel() if with_h0 else 0)
            bms, by = bound_ms(n_bytes, 2 * a.numel(), "float32")
            out[(b, s, with_h0)] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                        bound_by=by)
            print(f"[rglru] B={b} S={s} L={lru} h0={with_h0} max_abs_err={err:.3g} "
                  f"(max|y| {scale:.3g}; against segmented {err_seg:.3g}) "
                  f"tol={RGLRU_REL_TOL} of max "
                  f"kernel_ms={k_ms:.4f} wrapper_call_ms={k_call:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
                  f"share_of_bound={bms / k_ms:.3f} same_bytes_add_ms={add_ms:.4f} "
                  f"{build_info}", flush=True)
            if (b, s, with_h0) == (1, 2600, False):
                # how much of the scan the forward check's yardstick reorders,
                # beside how much the kernel does
                def changed(other):
                    return ((other != want).float().mean().item(),
                            (other.bfloat16() != want.bfloat16()).float().mean().item())
                for name, other in (("kernel", y), ("plain segmented", seg),
                                    *((f"plain block {k}", ref.ref_rglru(a, bb, block=k))
                                      for k in (1, 4, 64))):
                    f32, bf16 = changed(other)
                    print(f"[rglru] S={s} against plain block 256: {name} changes "
                          f"{f32:.4f} of the f32 outputs, {bf16:.2e} of their bf16 casts")
    return out, worst


def ssd_flops(b, s, h, p, g, n) -> float:
    """Operations the SSD needs on these tokens, whatever the kernel's
    chunking: the chunked scan's count at chunk length 1, where it is
    least (it grows with the chunk through the causal C B^T and intra
    terms).  Per token, C B^T per group (G N) and per head the intra term
    (P), the incoming state's term (P N) and the state update (P N);
    multiply-adds count 2."""
    return 2.0 * b * s * (g * n + h * p * (1 + 2 * n))


SSD_LENGTHS = ((1, 37), (1, 256), (1, 512), (1, 600), (1, 1024), (2, 1024))


def ssd_cases(torch, ops, ssd, ssm, ref, h: int = 24, layout=(64, 128, 1),
              lengths=SSD_LENGTHS, seed: int = SEED + 4, tag: str = "[ssd]"):
    """The SSD kernels (three launches a call) against the plain chunked
    scan at H heads of ``layout`` = (P, N, G), mamba2-130m's widths (H=24,
    P=64, N=128, G=1) by default: serving prompt lengths with ragged last
    chunks, one longer prompt and a batch of two; B/C in bf16 (the model's
    compute dtype) and f32.  The bound is the f32 one (the result is
    f32-accurate); beside it, the bound of the datapath the kernels use,
    split TF32 (``tf32x3``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p, n, grp = layout
    out, worst = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        dt_ = getattr(torch, dtype_name)
        for b, s in lengths:
            x = torch.randn(b, s, h, p, generator=g, device="cuda")
            dt = torch.nn.functional.softplus(
                torch.randn(b, s, h, generator=g, device="cuda") - 1.0)
            a_log = torch.linspace(-3.0, 1.0, h, device="cuda")
            bm = torch.randn(b, s, grp, n, generator=g, device="cuda").to(dt_)
            cm = torch.randn(b, s, grp, n, generator=g, device="cuda").to(dt_)
            d = torch.randn(h, generator=g, device="cuda")
            y, hf = ops.ssd_scan(x, dt, a_log, bm, cm, d, chunk=256)
            wy, wh = ssm.ssd_chunked(x, dt, a_log, bm, cm, d, chunk=256)
            torch.cuda.synchronize()
            err_y = (y - wy).abs().max().item()
            err_h = (hf - wh).abs().max().item()
            scale_y = max(1.0, wy.abs().max().item())
            scale_h = max(1.0, wh.abs().max().item())
            ok = (math.isfinite(err_y) and math.isfinite(err_h)
                  and err_y <= SSD_REL_TOL * scale_y and err_h <= SSD_REL_TOL * scale_h)
            if not ok:
                raise AssertionError(
                    f"ssd B={b} S={s} P={p} N={n} G={grp} {dtype_name}: max_abs_err y {err_y:.3g} "
                    f"(max|y| {scale_y:.3g}), h {err_h:.3g} (max|h| {scale_h:.3g}) "
                    f"> {SSD_REL_TOL} of the scale")
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), err_y)
            dta = dt * -torch.exp(a_log)
            xdt = x * dt[..., None]
            k_ms, k_call = time_ms(torch, lambda: ssd.ssd_scan_kernel(xdt, dta, bm, cm))
            p_ms, _ = time_ms(torch, lambda: ref.ssd_chunk_scan(xdt, dta, bm, cm, chunk=256),
                              iters=5)
            n_bytes = (2 * 4 * x.numel() + 4 * dta.numel() + 2 * bm.numel() * bm.element_size()
                       + 4 * hf.numel())
            bms, by = bound_ms(n_bytes, ssd_flops(b, s, h, p, grp, n), "float32")
            tms, tby = bound_ms(n_bytes, ssd_flops(b, s, h, p, grp, n), "tf32x3")
            out[(dtype_name, b, s)] = dict(err=err_y, err_h=err_h, ms=k_ms, plain_ms=p_ms,
                                           bound_ms=bms, bound_by=by, tf32x3_bound_ms=tms)
            print(f"{tag} B={b} S={s} H={h} P={p} N={n} G={grp} B/C {dtype_name} "
                  f"max_abs_err y={err_y:.3g} (max|y| {scale_y:.3g}) h={err_h:.3g} "
                  f"(max|h| {scale_h:.3g}) tol={SSD_REL_TOL} of max "
                  f"kernel_ms={k_ms:.4f} wrapper_call_ms={k_call:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={bms:.5f} ({by}) "
                  f"tf32x3_bound_ms={tms:.5f} ({tby})", flush=True)
    return out, worst


# [shapes]: the kernels at shapes of the reference's own reduced configs and
# of public architectures with such head dims, named for their shapes only:
# phi-2 (D = 80, 32 heads), Phi-3-mini (D = 96, 32 heads), Codestral Mamba
# (P = 64, N = 128, G = 8); D and hd 64 and 128 are the unpadded baselines
SHAPES_FLASH_DIMS = (16, 40, 64, 80, 96, 112, 128, 160)
SHAPES_PAGED_DIMS = (16, 64, 80, 96, 128, 256)
SHAPES_SSD = ((16, 16, 1), (64, 64, 1), (32, 64, 2), (64, 128, 8), (64, 256, 1))
SHAPES_PRESETS = ("tiny", "20m", "100m")


def margin_at(torch, model, params, prompt, stream, i: int) -> float:
    """The top-2 logit gap of ``model`` at the ``i``-th generated token of
    ``stream`` after ``prompt``: how near a tie the token was."""
    toks = torch.cat([prompt, torch.tensor(stream[:i], dtype=torch.int32)])
    with torch.no_grad():
        logits = model.forward(params, toks[None].to(model.device))[0, -1].float()
    top = logits.topk(2).values
    return (top[0] - top[1]).item()


def cli_serve_case(torch, ops, Transformer, RunOpts, card: str, argv: list, tag: str):
    """``launch.serve.main(argv)`` on the card, the CLI's own path, with its
    serving loop driven through ``serve_path`` (launch counters set to 0
    just before the run and read just after; the mamba2 presets' prefills
    must each launch the SSD kernel once a layer), then the same engine
    settings, weights and requests on the plain versions
    (``RunOpts(attention_impl="full", use_kernels=False)``, f32 like the
    presets): the token streams must be equal.  Where they differ, the
    first divergence is printed with both models' top-2 logit gap there,
    and the run fails.  Returns the kernel run (``serve_path``'s dict)."""
    from repro_torch.launch import serve as serve_cli
    seen = {}

    def drive(eng, live):
        layers = eng.model.cfg.n_layers
        seen["live"] = live
        seen["run"] = serve_path(torch, ops, eng, live, lambda steps, prefills: {
            "flash_attention": 0, "paged_attention": 0, "ssd_scan": layers * prefills,
            "rglru_scan": 0}, card, tag)
        return seen["run"]["summary"]
    eng = serve_cli.main(argv, run=drive)
    run, cfg = seen["run"], eng.model.cfg
    plain_model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False))
    args = serve_cli.parse_args(argv)
    plain = serve_cli.make_engine(args, plain_model, eng.params,
                                  serve_cli.sample_trace(args))
    ops.reset_launches()
    plain.run(seen["live"])
    plain_launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    where = first_divergence(plain.completed, run["completed"])
    same = sum(plain.completed[r] == run["completed"].get(r) for r in plain.completed)
    print(f"[shapes] {tag} {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} SSD heads of P={cfg.ssm_head_dim} N={cfg.ssm_state} "
          f"G={cfg.ssm_groups}, {cfg.dtype}): kernel launches {run['launches']}, "
          f"token streams equal to the plain versions' for {same}/{len(plain.completed)} "
          f"requests (plain run's launches {plain_launches}) | {card}", flush=True)
    if where is not None or any(plain_launches.values()):
        if where is not None:
            rid, i = where
            prompt = next(r.prompt for r in seen["live"] if r.rid == rid)
            gaps = [margin_at(torch, m, eng.params, prompt, plain.completed[rid], i)
                    for m in (eng.model, plain_model)]
            print(f"[shapes] {tag} first_divergence rid {rid} token {i}: plain "
                  f"{plain.completed[rid][i:i + 4]} kernels {run['completed'][rid][i:i + 4]}; "
                  f"top-2 logit gap there: kernels {gaps[0]:.3g}, plain {gaps[1]:.3g}",
                  flush=True)
        raise AssertionError(f"{tag}: streams differ at {where} or the plain run "
                             f"launched {plain_launches}")
    return run


def shapes_phase(torch, ops, ref, ssd, ssm, Transformer, RunOpts, ServeEngine,
                 card: str) -> dict:
    """``[shapes]``: the three kernels at the head dims and SSD shapes the
    reference's reduced configs reach and at public layouts that have them,
    each case against its plain version with the tolerance of its own
    phase, timed beside its bound, its plain version and (flash) SDPA;
    then the serving CLI's own path, ``launch.serve.main --arch
    mamba2-130m`` at ``--preset tiny``, ``20m`` and ``100m`` (runner and
    graphs on; SSD at P=64 N=64), and qwen2-0.5b's ``smoke()`` config
    (head dim 16) served with paged decode and flash prefill the way
    ``dense_phase`` serves a registered model.  Returns the cases' results
    and the serving runs' launches."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = {"flash": {}, "paged": {}, "ssd": {}, "worst": {}}
    for i, d in enumerate(SHAPES_FLASH_DIMS):
        cases = [(dt, 512, 0, 0) for dt in ("bfloat16", "float32")]
        if d == 96:
            cases += [(dt, 1024, 0, 0) for dt in ("bfloat16", "float32")]
        if d == 16:
            cases += [(dt, 512, 8, 64) for dt in ("bfloat16", "float32")]
        if d == 80:
            cases += [(dt, 512, 0, 0, False, 1) for dt in ("bfloat16", "float32")]
        res, worst = flash_cases(torch, ops, ref, 32, 8, d, cases, SEED + 90 + i, iters=10,
                                 tag="[shapes] flash")
        out["flash"].update({(d, *case): r for case, r in res.items()})
        out["worst"][f"flash_d{d}"] = worst
    for i, hd in enumerate(SHAPES_PAGED_DIMS):
        res, worst = paged_cases(torch, ops, ref, 16, 8, 4, hd, 16, SEED + 110 + i,
                                 bf16_batches=(8,), pos_range=(1, MAX_LEN - 1),
                                 tag="[shapes] paged")
        out["paged"].update({(hd, *key): r for key, r in res.items()})
        out["worst"][f"paged_hd{hd}"] = worst
    for i, layout in enumerate(SHAPES_SSD):
        lengths = ((1, 512), (1, 37)) if layout == (64, 64, 1) else ((1, 512),)
        res, worst = ssd_cases(torch, ops, ssd, ssm, ref, h=24, layout=layout,
                               lengths=lengths, seed=SEED + 130 + i, tag="[shapes] ssd")
        out["ssd"].update({(*layout, *key): r for key, r in res.items()})
        out["worst"][f"ssd_p{layout[0]}_n{layout[1]}_g{layout[2]}"] = worst
    kernel_s = time.perf_counter() - t0
    runs = {}
    for preset in SHAPES_PRESETS:
        runs[f"mamba2:{preset}"] = cli_serve_case(
            torch, ops, Transformer, RunOpts, card,
            ["--arch", SSM_ARCH, "--preset", preset], f"cli:mamba2:{preset}")["launches"]
        free_cuda(torch)
    runs["qwen2:smoke"] = dense_phase(
        torch, ops, Transformer, RunOpts, ServeEngine, ARCH, "qwen2:smoke", card,
        cfg=get_config(ARCH).smoke())["launches"]
    launches = {fn.__name__: sum(r[fn.__name__] for r in runs.values())
                for fn in ops.WRAPPERS}
    print(f"[shapes] launches {json.dumps(runs)}", flush=True)
    print(f"[shapes] took {time.perf_counter() - t0:.1f}s (kernel cases {kernel_s:.1f}s, "
          f"serving paths {time.perf_counter() - t0 - kernel_s:.1f}s) | {card}", flush=True)
    return dict(out, launches=launches, runs=runs)


def serve_trace(cfg, torch, n: int, seed: int, long_rids=()):
    """Staggered requests with prompts of 100-600 tokens (2100-3000 for the
    rids in ``long_rids``) and GEN_LEN generated tokens; prompts are seeded
    random token ids."""
    from repro_torch.runtime.serve_lib import Request
    from repro_torch.serving import GenRequest
    rng = random.Random(seed)
    g = torch.Generator().manual_seed(seed)
    trace, t = [], 0
    for i in range(n):
        t += rng.randint(0, 3)
        n_prompt = rng.randint(2100, 3000) if i + 1 in long_rids else rng.randint(100, 600)
        trace.append(Request(rid=i + 1, prompt_len=n_prompt, gen_len=GEN_LEN,
                             arrival=t))
    live = [GenRequest(rid=r.rid, prompt=torch.randint(
                0, cfg.vocab_size, (r.prompt_len,), generator=g,
                dtype=torch.int32), gen_len=r.gen_len, arrival=r.arrival)
            for r in trace]
    return trace, live


def stamp(t_start: float, what: str) -> None:
    print(f"[time] {what} done at {time.perf_counter() - t_start:.1f}s", flush=True)


def serve_path(torch, ops, eng, live, expected, card, tag: str,
               around_run=contextlib.nullcontext) -> dict:
    """Drive one serving path through ``eng`` with every launch counter set
    to 0 just before and read just after (the run inside ``around_run()``);
    check completions, tokens, that the launches equal
    ``expected(decode_steps, prefills)`` for every kernel wrapper, and with
    graphs that warmup captured one graph per bucket and, for padded
    prompts, one prefill graph per rung of the ladder, that every prefill
    replayed one, and that the run captured none.  Returns the launches and
    the run's numbers (``ms``: decode step and prefill, ``completed``: the
    token streams, the graph pools' bytes)."""
    from repro_torch.kernels import paged_attention as pa
    t0 = time.perf_counter()
    eng.warmup()
    runner = eng.runner
    warm = runner.n_compiles
    rungs = eng.prefill_rungs()
    pwarm = eng.prefill.stats()
    kv = eng.kv.stats()
    print(f"[serve:{tag}] warmup buckets={list(runner.buckets)} graphs={runner.graphs} "
          f"compiles={warm}, prefill rungs {rungs} graphs={pwarm['n_captures']} "
          f"in {time.perf_counter() - t0:.1f}s; planned pool "
          f"page_tokens={kv['page_tokens']} page_bytes={kv['page_bytes']} "
          f"n_pages={kv['n_pages']} pool={kv['pool_bytes'] / 1e6:.2f}MB "
          f"(planned peak {kv['planned_peak'] / 1e6:.2f}MB)", flush=True)
    if warm != len(runner.buckets):
        raise AssertionError(f"{tag}: warmup made {warm} compiles for "
                             f"{len(runner.buckets)} buckets")
    if pwarm["n_captures"] != (len(rungs) if eng.graphs else 0):
        raise AssertionError(f"{tag}: warmup captured {pwarm['n_captures']} prefill "
                             f"graphs for the rungs {rungs} (graphs={eng.graphs})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps0, prefills0 = eng.decode_steps, eng.prefill_calls
    with around_run():
        summary = eng.run(live)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    n_steps = eng.decode_steps - steps0
    n_prefills = eng.prefill_calls - prefills0
    vocab = eng.model.cfg.padded_vocab
    if summary["n_completed"] != len(live):
        raise AssertionError(f"{tag}: completed {summary['n_completed']}/{len(live)}")
    for r in live:
        toks = eng.completed[r.rid]
        if len(toks) != r.gen_len or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{tag} rid {r.rid}: bad output {toks}")
    want = expected(n_steps, n_prefills)
    if launches != want or n_steps == 0 or n_prefills == 0:
        raise AssertionError(f"{tag}: launches {launches}, expected {want} for "
                             f"{n_steps} decode steps and {n_prefills} prefills")
    if runner.n_compiles != warm:
        raise AssertionError(f"{tag}: {runner.n_compiles - warm} captures during the run")
    pstats = eng.prefill.stats()
    replays = pstats["n_replays"] - pwarm["n_replays"]
    if pstats["n_captures"] != pwarm["n_captures"]:
        raise AssertionError(f"{tag}: {pstats['n_captures'] - pwarm['n_captures']} "
                             "prefill captures during the run")
    if replays != (n_prefills if eng.graphs and rungs else 0):
        raise AssertionError(f"{tag}: {replays} prefill replays for {n_prefills} "
                             f"prefills (graphs={eng.graphs}, rungs {rungs})")
    stats = runner.stats()
    cache_bytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    step_ms = 1e3 * eng.decode_time_s / eng.decode_steps
    prefill_ms = 1e3 * eng.prefill_time_s / eng.prefill_calls
    print(f"[serve:{tag}] steps={n_steps} step_ms={step_ms:.2f} "
          f"prefills={n_prefills} prefill_ms={prefill_ms:.2f} "
          f"prefill_shapes={eng.prefill_compiles} launches={launches} "
          f"graphs={stats['graphs']} compiles={stats['n_compiles']} "
          f"graph_pool={stats['graph_pool_bytes'] / 1e6:.2f}MB "
          f"prefill_replays={replays} "
          f"prefill_graph_pool={pstats['graph_pool_bytes'] / 1e6:.2f}MB "
          f"captured_paged_counters={len(pa._graph_counters)} "
          f"physical_cache={cache_bytes / 1e9:.3f}GB "
          f"peak_mem={torch.cuda.max_memory_allocated() / 1e9:.3f}GB | {card}")
    print(f"[serve:{tag}] completed {summary['n_completed']}/{summary['n_requests']} "
          f"requests, {summary['tokens']} tokens in {summary['wall_s']:.1f}s "
          f"({summary['tokens_per_s']:.1f} tok/s), "
          f"max_concurrent={summary['max_concurrent']}, "
          f"preemptions={summary['n_preemptions']}, reopts={summary['kv_n_reopt']} "
          f"| {card}", flush=True)
    return dict(launches=launches, step_ms=step_ms, prefill_ms=prefill_ms,
                tokens_per_s=summary["tokens_per_s"], pool_bytes=stats["graph_pool_bytes"],
                prefill_pool_bytes=pstats["graph_pool_bytes"],
                n_compiles=stats["n_compiles"], completed=dict(eng.completed),
                summary=summary, prefill_shapes=eng.prefill_compiles, steps=n_steps,
                prefills=n_prefills, prefill_captures=pstats["n_captures"])


def first_divergence(want: dict, got: dict):
    """(rid, step) of the first token where two runs' streams differ, or None."""
    for rid in sorted(want):
        a, b = want[rid], got.get(rid, [])
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return rid, i
    return None


def graph_ab(torch, ops, make_engine, live, expected, card, tag: str,
             around_eager=contextlib.nullcontext) -> dict:
    """The same path run eagerly (``graphs=False``, the run inside
    ``around_eager()``), then with one CUDA graph per bucket and per rung
    of the prompt ladder, on the same trace and weights: print both runs'
    decode step ms, tokens/s, prefill ms, graph pools' bytes and compile
    count, and fail unless every request's token stream is the same.
    Returns the graph run (``serve_path``'s dict), the eager run's under
    ``"eager"``."""
    eager = serve_path(torch, ops, make_engine(graphs=False), live, expected, card,
                       f"{tag}:eager", around_eager)
    free_cuda(torch)
    graph = serve_path(torch, ops, make_engine(graphs=None), live, expected, card, tag)
    where = first_divergence(eager["completed"], graph["completed"])

    def side(r):
        return (f"step_ms={r['step_ms']:.3f} tok/s={r['tokens_per_s']:.1f} "
                f"prefill_ms={r['prefill_ms']:.2f} graph_pool={r['pool_bytes']} "
                f"prefill_graph_pool={r['prefill_pool_bytes']} "
                f"n_compiles={r['n_compiles']}")
    print(f"[graph:{tag}] eager {side(eager)} | graphs {side(graph)} | decode step "
          f"{eager['step_ms'] / graph['step_ms']:.2f}x, prefill "
          f"{eager['prefill_ms'] / graph['prefill_ms']:.2f}x; token streams identical: "
          f"{where is None} | {card}", flush=True)
    if where is not None:
        rid, i = where
        raise AssertionError(f"graph:{tag}: rid {rid} diverges at token {i}: eager "
                             f"{eager['completed'][rid]} graphs {graph['completed'].get(rid)}")
    return dict(graph, eager=eager)


def free_cuda(torch) -> None:
    """Return the freed models' memory to the card before the next path."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def load_model(torch, Transformer, cfg, opts, seed: int, tag: str):
    """A model and its weights drawn from ``seed``, one leaf at a time
    (``init_loaded``): the peak is the loaded weights plus one f32 leaf."""
    from torch.utils._pytree import tree_leaves
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, opts)
    params = model.init_loaded(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    free, total = torch.cuda.mem_get_info()
    print(f"[serve:{tag}] weights {torch.cuda.memory_allocated() / 1e9:.2f}GB "
          f"({n_params} parameters, {cfg.n_layers} layers, {cfg.dtype}), init peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}GB; card free after the load "
          f"{free / 1e9:.2f} of {total / 1e9:.2f}GB, beside "
          f"{torch.cuda.memory_reserved() / 1e9:.2f}GB reserved by the caching allocator",
          flush=True)
    return model, params


def same_streams(torch, small, variants, Transformer, ServeEngine, what: str, *,
                 max_len: int = MAX_LEN, long_rids=(), on_cpu: bool = False,
                 max_batch: int = 4, make_trace=None) -> list:
    """A shallow full-width f32 model serves identical greedy token streams
    through each ``(RunOpts, attn_mode)`` variant with CUDA graphs (the
    kernels' path and the plain path, on the same weights), and through the
    first variant again eagerly (``graphs=False``); with ``on_cpu`` also
    through the last variant on the CPU (the plain versions, the same
    weights copied there).  The trace is ``make_trace(cfg)`` (default: 4
    requests of ``serve_trace``).  Returns each run's summary."""
    from torch.utils._pytree import tree_map
    trace_s, live_s = (make_trace(small) if make_trace is not None
                       else serve_trace(small, torch, 4, SEED + 3, long_rids))
    runs = [*((o, m, None, None) for o, m in variants), (*variants[0], False, None)]
    if on_cpu:
        runs.append((*variants[-1], False, "cpu"))
    streams, summaries = [], []
    params = None
    for opts, mode, graphs, device in runs:
        m = Transformer(small, opts, device=device)
        if params is None:
            params = m.init_loaded(torch.Generator(device="cuda").manual_seed(SEED + 3))
        p = params if device is None else tree_map(lambda t: t.to(device), params)
        e = ServeEngine(m, p, sample_trace=trace_s, max_len=max_len, max_batch=max_batch,
                        attn_mode=mode, graphs=graphs)
        summaries.append(e.run(live_s))
        streams.append(e.completed)
    same = [sum(streams[0][r] == other[r] for r in other) for other in streams[1:]]
    cpu = f", card vs CPU for {same[2]}/{len(live_s)}" if on_cpu else ""
    print(f"[check] {small.name} f32 {small.n_layers}-layer full-width: {what} token "
          f"streams identical for {same[0]}/{len(live_s)} requests, graphs vs eager "
          f"for {same[1]}/{len(live_s)}{cpu} (prompts {[r.prompt_len for r in trace_s]})")
    if same != [len(live_s)] * len(same):
        raise AssertionError(f"token streams differ: {streams}")
    return summaries


def dense_phase(torch, ops, Transformer, RunOpts, ServeEngine, arch: str, tag: str,
                card: str, mode: str = "paged", on_cpu: bool = False, cfg=None) -> dict:
    """``[serve:<tag>]``: a registered dense or MoE decoder at full width and
    depth (seeded random bf16 weights drawn leaf by leaf) serving the
    12-request trace with flash prefill and ``mode`` decode, eagerly and then
    with graphs (``graph_ab``: equal token streams, launches exactly
    ``n_layers`` per prefill and, paged, per decode step).  In gather mode
    (the MoE decoders: prompts unpadded, as the reference's engine takes
    them) the run must also make one prefill shape per distinct prompt
    length.  Then the model is freed and an f32 2-layer cut of the same
    width serves identical token streams through the kernels' path and the
    plain one (``same_streams``; paged+kernels vs gather+plain, or
    gather+kernel vs gather+full), and with ``on_cpu`` on the CPU too.
    Nothing falls back: an out-of-memory error in the load or the serve
    fails the run.  ``cfg`` (default: the registered config of ``arch``)
    serves another config of the family.  Returns the graph run
    (``serve_path``'s dict)."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(arch)
    trace, live = serve_trace(cfg, torch, N_REQUESTS, SEED)
    model, params = load_model(torch, Transformer, cfg, RunOpts(attention_impl="kernel"),
                               SEED, tag)
    paged = mode == "paged"
    run = graph_ab(torch, ops, lambda graphs: ServeEngine(
        model, params, sample_trace=trace, max_len=MAX_LEN, max_batch=MAX_BATCH,
        attn_mode=mode, graphs=graphs), live, lambda steps, prefills: {
        "flash_attention": cfg.n_layers * prefills,
        "paged_attention": cfg.n_layers * steps if paged else 0, "ssd_scan": 0,
        "rglru_scan": 0}, card, tag)
    lengths = len({r.prompt_len for r in trace})
    if not paged and run["prefill_shapes"] != lengths:
        raise AssertionError(f"{tag}: {run['prefill_shapes']} prefill shapes for "
                             f"{lengths} distinct prompt lengths")
    del model, params
    free_cuda(torch)
    variants = ([(RunOpts(attention_impl="kernel"), "paged"),
                 (RunOpts(attention_impl="full"), "gather")] if paged else
                [(RunOpts(attention_impl="kernel"), "gather"),
                 (RunOpts(attention_impl="full"), "gather")])
    same_streams(torch, cfg.with_overrides(n_layers=2, dtype="float32"), variants,
                 Transformer, ServeEngine, "paged+kernels vs gather+plain" if paged
                 else "gather+kernel vs gather+full", on_cpu=on_cpu)
    free_cuda(torch)
    return run


def greedy(torch, prefill, decode, params, batch, gen: int, cache=None) -> dict:
    """``gen`` greedy tokens per row through the serving steps: the
    prefill's argmax, then ``gen - 1`` decode steps.  With ``cache`` the
    prefill's cache is copied into it and decode runs on it, so a graph
    captured on that cache replays.  Returns the (B, gen) streams on the
    host, the prefill logits, the cache, and the host ms of the
    prefill and of a decode step (synchronized around each)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, fresh = prefill(params, batch)
    if cache is None:
        cache = fresh
    else:
        for name, leaf in cache.items():
            leaf.copy_(fresh[name])
    del fresh
    first = logits.clone()
    tok = logits.argmax(-1).int()
    out = [tok]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits.argmax(-1).int()
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(streams=torch.stack(out, 1).cpu(), logits=first, cache=cache,
                prefill_ms=1e3 * (t1 - t0), step_ms=1e3 * (t2 - t1) / max(1, gen - 1),
                wall_s=t2 - t0)


def whisper_phase(torch, ops, Transformer, RunOpts, card: str) -> dict:
    """``[serve:whisper]``: whisper-small at full width and depth (12
    encoder and 12 decoder layers, seeded random bf16 weights) serving
    ``WHISPER_BATCH`` requests through ``runtime.serve_lib``:
    ``build_prefill_step`` over {"tokens", "frames"} (the encoder runs the
    flash kernel non-causally over the 1500 frames, the decoder causally
    over the prompt, 24 launches a prefill) and ``build_decode_step``, both
    run eagerly and then both graphed (one prefill capture and one decode
    capture, on a warmup batch, none after it: the run's prefill replays
    the graph and its decode replays on the prefill graph's static cache),
    each run with every launch counter set to 0 just before and read just
    after.  Fails unless both runs launch flash 24 times and nothing else,
    the graphed run's prefill is one replay, and their streams are equal.
    Prints
    the weights, the measured cross (``xk``/``xv``) and self cache bytes
    beside the reference's accounting (``state_bytes``,
    ``cache_bytes_per_token`` x max_len, which leave the cross cache out),
    prefill ms graphed and eager at B=1 and B=8 (device and call ms, the
    B=1 graph captured in the timing's first call), the prefill graphs'
    captures and pool bytes, decode step ms graphed and eager, tokens/s
    and peak memory.  Then the bf16 ``forward`` with frames through the
    kernel against the plain version, held to 2x the ``full`` attention's
    distance from it at 1 encoder and 1 decoder layer of the served
    weights, and read at full depth, where the yardstick flips every argmax
    (the reference's init makes q and k ~8 an element, so the random
    stack's attention is near one-hot and rounding picks other frames).
    Then an f32 cut of 2 encoder and 2 decoder layers at full width serves
    the same way on the card (graphed and eager) and on the CPU, with equal
    streams, and its prefill logits through the kernel on the card are
    held to 2x the card's plain path's distance from a float64 CPU run
    (the card's f32 GEMMs alone move them ~3x further than the CPU's
    do).  Returns the graphed run's launches."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.runtime import serve_lib
    cfg = get_config(WHISPER_ARCH)
    b, gen, max_len = WHISPER_BATCH, WHISPER_GEN, WHISPER_MAX_LEN
    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    frames = torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=g, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (b, WHISPER_PROMPT), generator=g,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens, "frames": frames}
    model, params = load_model(torch, Transformer, cfg, RunOpts(attention_impl="kernel"),
                               SEED, "whisper")
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    expected = {"flash_attention": cfg.n_layers + cfg.encoder_layers,
                "paged_attention": 0, "ssd_scan": 0, "rglru_scan": 0}
    runs = {}
    for name, graphs in (("eager", False), ("graphs", None)):
        hooks = []
        prefill = serve_lib.build_prefill_step(model, None, max_len=max_len, graphs=graphs)
        decode = serve_lib.build_decode_step(model, None, graphs=graphs,
                                             trace_hook=hooks.append)
        warm = greedy(torch, prefill, decode, params, batch, 3)
        warm_hooks = len(hooks)
        pwarm = prefill.stats()
        free_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        run = greedy(torch, prefill, decode, params, batch, gen, warm["cache"])
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        pstats = prefill.stats()
        replays = pstats["n_replays"] - pwarm["n_replays"]
        run.update(launches=launches, peak=torch.cuda.max_memory_allocated(),
                   hooks=(warm_hooks, len(hooks)), prefill=prefill)
        runs[name] = run
        print(f"[serve:whisper:{name}] B={b} prompt={WHISPER_PROMPT} gen={gen} "
              f"max_len={max_len} prefill_ms={run['prefill_ms']:.2f} "
              f"step_ms={run['step_ms']:.3f} tok/s={b * gen / run['wall_s']:.1f} "
              f"launches={launches} decode captures/traces {warm_hooks} at warmup, "
              f"{len(hooks)} after the run; prefill graphs={pstats['graphs']} captures "
              f"{pwarm['n_captures']} at warmup, {pstats['n_captures']} after the run, "
              f"{replays} replays in it, prefill_graph_pool="
              f"{pstats['graph_pool_bytes']} B; peak_mem={run['peak'] / 1e9:.3f}GB "
              f"| {card}", flush=True)
        if launches != expected:
            raise AssertionError(f"whisper {name}: launches {launches}, expected {expected}")
        if len(hooks) != warm_hooks or warm_hooks != 1:
            raise AssertionError(f"whisper {name}: {warm_hooks} decode traces at warmup, "
                                 f"{len(hooks) - warm_hooks} more in the run")
        want = (1, 1, 1) if graphs is None else (0, 0, 0)
        if (pwarm["n_captures"], pstats["n_captures"], replays) != want:
            raise AssertionError(f"whisper {name}: prefill captures {pwarm['n_captures']} "
                                 f"at warmup, {pstats['n_captures']} after the run, "
                                 f"{replays} replays in it; expected {want}")
        if not torch.isfinite(run["logits"]).all():
            raise AssertionError(f"whisper {name}: prefill logits not finite")
        del warm, decode
    cache = runs["graphs"]["cache"]
    leaf_bytes = {k: t.numel() * t.element_size() for k, t in cache.items()}
    cross = (leaf_bytes["xk"] + leaf_bytes["xv"]) // b
    self_kv = (leaf_bytes["k"] + leaf_bytes["v"]) // b
    acct = serve_lib.cache_bytes_per_token(cfg) * max_len + serve_lib.state_bytes(cfg)
    same = bool(torch.equal(runs["eager"]["streams"], runs["graphs"]["streams"]))
    eager, graph = runs["eager"], runs["graphs"]
    # the graphed step captures B=1 in its timing's first call; each timed
    # call copies the frames into the graph's buffer, then replays
    p_ms = {}
    for name, rows in itertools.product(("eager", "graphs"), (1, b)):
        sub = {"tokens": tokens[:rows], "frames": frames[:rows]}
        step = runs[name]["prefill"]
        p_ms[name, rows] = time_ms(torch, lambda: step(params, sub), iters=5, warmup=1)
    pgraph = graph["prefill"].stats()
    print(f"[serve:whisper] weights {weights} B ({torch.cuda.memory_allocated() / 1e9:.3f}GB "
          f"allocated with the frames and the caches); per request: cross cache "
          f"xk+xv {cross} B measured, self cache k+v {self_kv} B at max_len {max_len}, "
          f"the reference's accounting state_bytes={serve_lib.state_bytes(cfg)} + "
          f"cache_bytes_per_token x max_len="
          f"{serve_lib.cache_bytes_per_token(cfg) * max_len} = {acct} B (the cross "
          f"cache left out); prefill device/call ms graphed / eager B=1 "
          f"{p_ms['graphs', 1][0]:.2f}/{p_ms['graphs', 1][1]:.2f} / "
          f"{p_ms['eager', 1][0]:.2f}/{p_ms['eager', 1][1]:.2f} "
          f"({p_ms['eager', 1][1] / p_ms['graphs', 1][1]:.2f}x call) B={b} "
          f"{p_ms['graphs', b][0]:.2f}/{p_ms['graphs', b][1]:.2f} / "
          f"{p_ms['eager', b][0]:.2f}/{p_ms['eager', b][1]:.2f} "
          f"({p_ms['eager', b][1] / p_ms['graphs', b][1]:.2f}x call); prefill graphs: "
          f"{pgraph['n_captures']} captures (B={b}, B=1), graph_pool_bytes="
          f"{pgraph['graph_pool_bytes']}; decode step_ms graphed "
          f"{graph['step_ms']:.3f} eager {eager['step_ms']:.3f} "
          f"({eager['step_ms'] / graph['step_ms']:.2f}x); tok/s graphed "
          f"{b * gen / graph['wall_s']:.1f} eager {b * gen / eager['wall_s']:.1f}; "
          f"peak_mem graphed {graph['peak'] / 1e9:.3f}GB; streams graphed == eager: "
          f"{same} | {card}", flush=True)
    if not same:
        raise AssertionError("whisper: graphed token streams differ from eager")
    launches = graph["launches"]
    fwd_tokens = tokens[:2].repeat(1, 16)
    del runs, cache, eager, graph, prefill, step
    free_cuda(torch)
    for k, hold in ((1, True), (cfg.n_layers, False)):
        cfg_k = cfg.with_overrides(n_layers=k, encoder_layers=k)
        params_k = {**params, "layers": params["layers"][:k],
                    "encoder": {**params["encoder"],
                                "blocks": params["encoder"]["blocks"][:k]}}
        check_forward(torch, cfg_k, Transformer, params_k, fwd_tokens,
                      RunOpts(attention_impl="kernel"), RunOpts(attention_impl="plain"),
                      RunOpts(attention_impl="full"),
                      f"{k} encoder layers, against the plain version, yardstick "
                      "attend_full", hold=hold, frames=frames[:2])
    del model, params, params_k
    free_cuda(torch)
    # the f32 cut on the same weights: the kernels' path on the card graphed
    # and eager and on the CPU (the plain versions) for streams; the plain
    # path on the card and a float64 CPU run for the prefill logits
    small = cfg.with_overrides(n_layers=2, encoder_layers=2, dtype="float32")
    nb = WHISPER_CUT_BATCH
    cut_batch = {"tokens": tokens[:nb], "frames": frames[:nb]}
    params_c = Transformer(small).init_loaded(
        torch.Generator(device="cuda").manual_seed(SEED + 61))
    reads = {}
    for name, impl, device, dtype, graphs, n_gen in (
            ("graphs", "kernel", None, "float32", None, WHISPER_CUT_GEN),
            ("eager", "kernel", None, "float32", False, WHISPER_CUT_GEN),
            ("cpu", "kernel", "cpu", "float32", False, WHISPER_CUT_GEN),
            ("plain", "plain", None, "float32", False, 1),
            ("cpu64", "kernel", "cpu", "float64", False, 1)):
        m = Transformer(small.with_overrides(dtype=dtype), RunOpts(attention_impl=impl),
                        device=device)
        bt = {k: v.to(m.device) for k, v in cut_batch.items()}
        pre = serve_lib.build_prefill_step(m, None, max_len=max_len, graphs=graphs)
        dec = serve_lib.build_decode_step(m, None, graphs=graphs)
        reads[name] = greedy(torch, pre, dec, m.load(params_c), bt, n_gen)
    off64 = {name: (reads[name]["logits"].double().cpu()
                    - reads["cpu64"]["logits"]).abs().max().item()
             for name in ("graphs", "plain", "cpu")}
    same = [int((reads[k]["streams"] == reads["cpu"]["streams"]).all(1).sum())
            for k in ("graphs", "eager")]
    print(f"[check] {small.name} f32 2+2-layer full-width cut, B={nb}, "
          f"{WHISPER_CUT_GEN} greedy tokens: streams equal to the CPU's for "
          f"{same[0]}/{nb} graphed and {same[1]}/{nb} eager; prefill logits' max-abs "
          f"distance from a float64 CPU run: card kernel {off64['graphs']:.3g}, card "
          f"plain {off64['plain']:.3g} (limit 2x), CPU plain {off64['cpu']:.3g}; "
          f"max|logits|={reads['cpu64']['logits'].abs().max().item():.4g}", flush=True)
    if (not math.isfinite(off64["graphs"]) or off64["graphs"] > 2 * off64["plain"]
            or same != [nb, nb]):
        raise AssertionError(f"whisper cut: logits {off64}, streams equal {same}/{nb}")
    del reads, params_c
    free_cuda(torch)
    return launches


def moe_cases(torch, moe, cfgs: dict) -> dict:
    """``[moe]``: the card's ``moe_groups`` against the same function on the
    CPU, on the same seeded f32 inputs and one layer's f32 weights (TF32
    off), at granite-moe's width for T = 1, 8, 37 and 600 and at
    qwen3-moe's for T = 8 and 37, each with a spread router and once with
    one skewed towards experts 0..k-1 (a direction the inputs share, worth
    ~4 in the logits) so that experts overflow.  ``order``, ``keep``,
    ``dest`` and ``token_of`` must be equal exactly (the card's top-k, stable
    argsort and ``searchsorted`` give the CPU's routing and order), y within
    MOE_Y_TOL and aux within MOE_AUX_TOL of max(1, |aux|).  Prints the share
    of assignments dropped.  Returns {tag: worst y error}."""
    worst = {}
    for tag, ts in (("granite-moe", (1, 8, 37, 600)), ("qwen3-moe", (8, 37))):
        cfg = cfgs[tag]
        e, k, d, f = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
        g = torch.Generator(device="cuda").manual_seed(SEED + 40)
        base = {"w_router": torch.randn(d, e, generator=g, device="cuda") / math.sqrt(d),
                "w_gate": torch.randn(e, d, f, generator=g, device="cuda") / math.sqrt(d),
                "w_up": torch.randn(e, d, f, generator=g, device="cuda") / math.sqrt(d),
                "w_down": torch.randn(e, f, d, generator=g, device="cuda") / math.sqrt(f)}
        for skew in (False, True):
            p = dict(base)
            if skew:
                p["w_router"] = base["w_router"].clone()
                p["w_router"][:, :k] += 8.0 / d
            p_cpu = {name: t.cpu() for name, t in p.items()}
            for t in ts:
                x = torch.randn(1, t, d, generator=g, device="cuda") + (0.5 if skew else 0.0)
                y, aux, disp = moe.moe_groups(x, p, cfg, torch.float32)
                y_c, aux_c, disp_c = moe.moe_groups(x.cpu(), p_cpu, cfg, torch.float32)
                torch.cuda.synchronize()
                same = all(torch.equal(a.cpu(), b) for a, b in zip(disp, disp_c))
                y_err = (y.cpu() - y_c).abs().max().item()
                aux_err = abs(aux.item() - aux_c.item())
                dropped = int((~disp.keep).sum().item())
                cap = moe.capacity(t, k, e, cfg.capacity_factor)
                print(f"[moe] {tag} D={d} E={e} k={k} F={f} T={t} C={cap} router="
                      f"{'skewed' if skew else 'spread'} dropped={dropped}/{t * k} "
                      f"({dropped / (t * k):.3f}) order/keep/dest/token_of equal: {same} "
                      f"y_max_abs_err={y_err:.3g} (|y| max {y_c.abs().max().item():.3g}) "
                      f"aux card={aux.item():.7g} cpu={aux_c.item():.7g}", flush=True)
                if not same:
                    raise AssertionError(f"moe {tag} T={t}: the card's dispatch differs "
                                         "from the CPU's")
                if not (y_err <= MOE_Y_TOL
                        and aux_err <= MOE_AUX_TOL * max(1.0, abs(aux_c.item()))):
                    raise AssertionError(f"moe {tag} T={t}: y err {y_err:.3g}, aux err "
                                         f"{aux_err:.3g}")
                if skew and t >= 37 and dropped == 0:
                    raise AssertionError(f"moe {tag} T={t}: the skewed router dropped "
                                         "nothing")
                worst[tag] = max(worst.get(tag, 0.0), y_err)
        del base, p, p_cpu
    return worst


def burst_trace(cfg, torch, n: int, seed: int):
    """``n`` requests arriving 0 or 1 step apart, prompts of 24-64 tokens
    (longer than any decode bucket, so that a token count tells a prefill
    from a decode step), GEN_LEN generated tokens each: the whole burst
    decodes together."""
    from repro_torch.runtime.serve_lib import Request
    from repro_torch.serving import GenRequest
    rng = random.Random(seed)
    g = torch.Generator().manual_seed(seed)
    trace, t = [], 0
    for i in range(n):
        t += rng.randint(0, 1)
        trace.append(Request(rid=i + 1, prompt_len=rng.randint(24, 64), gen_len=GEN_LEN,
                             arrival=t))
    live = [GenRequest(rid=r.rid, prompt=torch.randint(
                0, cfg.vocab_size, (r.prompt_len,), generator=g,
                dtype=torch.int32), gen_len=r.gen_len, arrival=r.arrival)
            for r in trace]
    return trace, live


@contextlib.contextmanager
def watching_dispatch(moe_lib, seen):
    """``moe_lib.moe_groups`` wrapped to call ``seen(xg, dispatch)`` after
    each call (eager calls only: a capture would be seen once)."""
    inner = moe_lib.moe_groups

    def watched(xg, p, cfg, compute_dtype, need_aux=True):
        y, aux, disp = inner(xg, p, cfg, compute_dtype, need_aux)
        seen(xg, disp)
        return y, aux, disp
    moe_lib.moe_groups = watched
    try:
        yield
    finally:
        moe_lib.moe_groups = inner


def counting_drops(torch, moe_lib, drops: dict):
    """``watching_dispatch`` adding up per token count T: calls, assignments
    (T k) and dropped assignments, the last on the device, read after the
    run."""
    def count(xg, disp):
        row = drops.setdefault(xg.shape[0] * xg.shape[1], [0, 0, torch.zeros(
            (), dtype=torch.int64, device=xg.device)])
        row[0] += 1
        row[1] += disp.keep.numel()
        row[2] += (~disp.keep).sum()
    return watching_dispatch(moe_lib, count)


def moe_b16_phase(torch, ops, moe_lib, Transformer, RunOpts, ServeEngine, card) -> dict:
    """``[serve:granite-moe:b16]``: full-width, full-depth granite-moe-1b-a400m
    (gather decode, flash prefill, prompts unpadded) at max_batch 16 on a
    burst of 16 requests, so that 9 or more decode together and the
    runner's bucket 16 runs: 16 rows (pad rows copy the last slot's) against
    an expert capacity C of 8, so an expert that 9 or more rows pick drops
    assignments.  Eager against graphs (``graph_ab``: equal token streams,
    launches exactly ``n_layers`` flash per prefill), the eager run counting
    the dispatch's drops per token count (decode buckets and prefill
    lengths); then an f32 2-layer cut of the same width serves the burst
    at max_batch 16 through gather+kernel and gather+full with graphs,
    eagerly and on the CPU, all with identical token streams
    (``same_streams``).  Fails unless 9 or more requests ran together in
    every run and bucket 16 ran.  Returns the graph run."""
    from repro_torch.configs import get_config
    arch, tag = MOE_ARCHS[0]
    tag = f"{tag}:b16"
    cfg = get_config(arch)
    trace, live = burst_trace(cfg, torch, MOE_B16_REQUESTS, SEED + 14)
    model, params = load_model(torch, Transformer, cfg, RunOpts(attention_impl="kernel"),
                               SEED, tag)
    drops: dict = {}
    run = graph_ab(torch, ops, lambda graphs: ServeEngine(
        model, params, sample_trace=trace, max_len=MAX_LEN, max_batch=MOE_B16_BATCH,
        attn_mode="gather", graphs=graphs), live, lambda steps, prefills: {
        "flash_attention": cfg.n_layers * prefills, "paged_attention": 0, "ssd_scan": 0,
        "rglru_scan": 0}, card, tag, around_eager=lambda: counting_drops(torch, moe_lib, drops))
    del model, params
    free_cuda(torch)
    cap = moe_lib.capacity(MOE_B16_BATCH, cfg.top_k, cfg.n_experts, cfg.capacity_factor)

    def share(ts):
        calls = sum(drops[t][0] for t in ts)
        n = sum(drops[t][1] for t in ts)
        dropped = sum(int(drops[t][2].item()) for t in ts)
        return f"{dropped}/{n} ({dropped / max(1, n):.4f}) over {calls} calls"
    buckets = sorted(t for t in drops if t <= MOE_B16_BATCH)
    print(f"[serve:{tag}] max_concurrent={run['summary']['max_concurrent']}; eager run's "
          f"MoE drops at decode bucket 16 (T=16, C={cap}): {share([16]) if 16 in drops else 'none'}; "
          f"all decode buckets {buckets}: {share(buckets)}; prefill "
          f"(T {min(t for t in drops if t > MOE_B16_BATCH)}-{max(drops)}): "
          f"{share([t for t in drops if t > MOE_B16_BATCH])} | {card}", flush=True)
    if run["summary"]["max_concurrent"] < MOE_B16_MIN_LIVE or 16 not in drops:
        raise AssertionError(f"{tag}: max_concurrent {run['summary']['max_concurrent']}, "
                             f"decode token counts {buckets}: bucket 16 did not run")
    small = cfg.with_overrides(n_layers=2, dtype="float32")
    summaries = same_streams(
        torch, small, [(RunOpts(attention_impl="kernel"), "gather"),
                       (RunOpts(attention_impl="full"), "gather")],
        Transformer, ServeEngine, "gather+kernel vs gather+full at max_batch 16",
        on_cpu=True, max_batch=MOE_B16_BATCH,
        make_trace=lambda c: burst_trace(c, torch, MOE_B16_REQUESTS, SEED + 15))
    live_max = [s["max_concurrent"] for s in summaries]
    print(f"[check] {small.name} f32 2-layer at max_batch 16: max_concurrent per run "
          f"{live_max}", flush=True)
    if min(live_max) < MOE_B16_MIN_LIVE:
        raise AssertionError(f"{tag} f32 cut: max_concurrent {live_max}")
    return run


def churn_phase(torch, ops, cfg, model, params, card) -> dict:
    """``[serve:churn]``: full-width qwen2-0.5b in paged mode at max_batch 8
    on a trace of short prompts (16-64 tokens, so generated tokens weigh in
    the pages) profiled at CHURN_PROFILED_GEN generated tokens while the
    live requests ask for 32-48: the planned pool runs out, so requests are
    preempted and restarted (slots and page-table rows reused under the
    captured graphs) and the pool is replanned (§4.3).  Graphs against
    eager through ``graph_ab`` (launches held to the formula in both); then
    the graphed engine at ``replan_interval`` None and 4 on the same trace.
    Returns the graph run."""
    from repro_torch.runtime.serve_lib import Request
    from repro_torch.serving import GenRequest, ServeEngine
    rng = random.Random(SEED + 12)
    g = torch.Generator().manual_seed(SEED + 12)
    trace, live, t = [], [], 0
    for i in range(N_REQUESTS):
        t += rng.randint(0, 3)
        n_prompt = rng.randint(16, 64)
        trace.append(Request(rid=i + 1, prompt_len=n_prompt, gen_len=CHURN_PROFILED_GEN,
                             arrival=t))
        live.append(GenRequest(rid=i + 1, prompt=torch.randint(
            0, cfg.vocab_size, (n_prompt,), generator=g, dtype=torch.int32),
            gen_len=rng.randint(32, 48), arrival=t))

    def make(graphs=None, replan_interval=64):
        return ServeEngine(model, params, sample_trace=trace, max_len=MAX_LEN,
                           max_batch=MAX_BATCH, attn_mode="paged", graphs=graphs,
                           replan_interval=replan_interval)
    run = graph_ab(torch, ops, make, live, lambda steps, prefills: {
        "flash_attention": cfg.n_layers * prefills,
        "paged_attention": cfg.n_layers * steps, "ssd_scan": 0,
        "rglru_scan": 0}, card, "churn")
    s = run["summary"]
    if not (s["n_preemptions"] >= 1 and s["kv_n_reopt"] >= 1):
        raise AssertionError(f"churn: preemptions {s['n_preemptions']}, replans "
                             f"{s['kv_n_reopt']}: the trace did not churn")
    reopt = {}
    for interval in (None, 4):
        free_cuda(torch)
        eng = make(replan_interval=interval)
        eng.warmup()
        summ = eng.run(live)
        kv = eng.kv.stats()
        reopt[interval] = (summ["kv_n_reopt"], summ["n_preemptions"], kv["replan_causes"])
        if summ["n_completed"] != len(live):
            raise AssertionError(f"churn replan_interval={interval}: completed "
                                 f"{summ['n_completed']}/{len(live)}")
    print(f"[serve:churn] replans (n_reopt, preemptions, causes) at replan_interval "
          f"None: {reopt[None]}; 4: {reopt[4]}; 64: ({s['kv_n_reopt']}, "
          f"{s['n_preemptions']})", flush=True)
    return run


def shared_phase(torch, ops, cfg, model, params, card) -> dict:
    """``[serve:shared]``: full-width qwen2-0.5b serving (paged decode, flash
    prefill, graphs) and fine-tuning (B=2 x S=512 SGD steps, gradient norm
    clipped to 1, on a private replica of the served bf16 weights, plain
    attention) in one
    ``SharedArena``.  The fine-tune step is profiled as it runs (``make_fx``
    over the replica's dtypes); a probe arena with both tenants gives the
    joint peak and the standalone sum, and the budget is set halfway
    between them (plus the retained bytes), so the plan is feasible only
    because the tenants share.  The shrink hook (the eviction search) is
    not wired here: at full width it takes minutes on the host, and the
    CPU tests drive it.  Fails unless the plan is feasible, a fine-tune step
    fired, every request completed, the launches equal the serving path's
    formula, and the token streams equal those of a second engine built the
    same way and run with ``eng.run(live)``.  Returns the launches and the
    numbers it printed."""
    from repro_torch.core import SharedArena
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime import train_lib
    from repro_torch.runtime.serve_lib import Request
    from repro_torch.serving import GenRequest, ServeEngine
    from repro_torch.serving.pages import choose_page_tokens
    from torch.utils._pytree import tree_leaves
    free_cuda(torch)
    t_phase = time.perf_counter()
    rng = random.Random(SEED + 13)
    g = torch.Generator().manual_seed(SEED + 13)
    trace, live, t = [], [], 0
    for i in range(SHARED_REQUESTS):
        t += rng.randint(0, 3)
        n_prompt = rng.randint(256, 1024)
        trace.append(Request(rid=i + 1, prompt_len=n_prompt, gen_len=SHARED_GEN,
                             arrival=t))
        live.append(GenRequest(rid=i + 1, prompt=torch.randint(
            0, cfg.vocab_size, (n_prompt,), generator=g, dtype=torch.int32),
            gen_len=SHARED_GEN, arrival=t))
    seq, batch = serve_cli.finetune_shape("full")
    ft_model = serve_cli.finetune_model(model)
    t0 = time.perf_counter()
    tprof = train_lib.profile_step(ft_model, {"tokens": ((batch, seq + 1), torch.int32)},
                                   loaded=True)
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = choose_page_tokens(cfg, trace)
    probe = SharedArena(1 << 62)
    probe.register_training(tprof, steps_per_round=SHARED_TRAIN_STEPS)
    probe.register_serving(pool.profile)
    pp = probe.plan()
    if not pp.joint_peak < pp.standalone_sum:
        raise AssertionError(f"shared: joint peak {pp.joint_peak} is no less than the "
                             f"standalone sum {pp.standalone_sum}")
    budget = pp.retained_bytes + (pp.joint_peak + pp.standalone_sum) // 2

    def make():
        arena = SharedArena(budget)
        tview = arena.register_training(tprof, steps_per_round=SHARED_TRAIN_STEPS)
        eng = ServeEngine(model, params, sample_trace=trace, max_len=SHARED_MAX_LEN,
                          max_batch=MAX_BATCH, page_tokens=pool.page_tokens,
                          attn_mode="paged", shared=arena)
        return arena, tview, eng

    arena, tview, eng = make()
    plan = arena.plan()
    plan_s = time.perf_counter() - t0
    account = plan.joint_peak + plan.retained_bytes
    if not (plan.feasible and account <= budget < plan.retained_bytes + plan.standalone_sum):
        raise AssertionError(f"shared: budget {budget} against joint {plan.joint_peak}, "
                             f"sum {plan.standalone_sum}, retained {plan.retained_bytes}, "
                             f"feasible {plan.feasible}")
    print(f"[serve:shared] plan: budget={budget} B ({budget / 1e9:.3f} GB) "
          f"joint_peak={plan.joint_peak} standalone_sum={plan.standalone_sum} "
          f"(serving {plan.standalone['serving']}, training {plan.standalone['training']}) "
          f"win={plan.sharing_win} joint/sum={plan.joint_peak / plan.standalone_sum:.4f} "
          f"retained={plan.retained_bytes} feasible={plan.feasible}; "
          f"profile {tprof.n} blocks in {profile_s:.1f}s, plans in {plan_s:.1f}s; "
          f"page_tokens={pool.page_tokens}", flush=True)
    eng.warmup()
    step = serve_cli.make_train_step(ft_model, params, seq, batch, seed=SEED,
                                     max_grad_norm=serve_cli.FULL_FINETUNE_MAX_GRAD_NORM)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    steps0, prefills0 = eng.decode_steps, eng.prefill_calls
    summary, colo = serve_cli.run_interleaved(eng, live, arena, step)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    n_steps, n_prefills = eng.decode_steps - steps0, eng.prefill_calls - prefills0
    want = {"flash_attention": cfg.n_layers * n_prefills,
            "paged_attention": cfg.n_layers * n_steps, "ssd_scan": 0, "rglru_scan": 0}
    step_ms = 1e3 * eng.decode_time_s / eng.decode_steps
    prefill_ms = 1e3 * eng.prefill_time_s / eng.prefill_calls
    replica = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    prefill_pool = eng.prefill.stats()["graph_pool_bytes"]
    decode_pool = eng.runner.stats()["graph_pool_bytes"]
    print(f"[serve:shared] training phases {colo['phases']} of a "
          f"{colo['window_steps']}-step window, serving_cap={eng.sched.cap} "
          f"serving_budget={eng.kv.tenant.budget} training_budget={tview.budget} "
          f"reserves={plan.reserves}", flush=True)
    print(f"[serve:shared] train_steps={colo['n_train_steps']} "
          f"train_step_ms={colo['train_step_ms_mean']:.2f} loss={colo['train_loss']:.4f} "
          f"| decode steps={n_steps} step_ms={step_ms:.3f} "
          f"tok/s={summary['tokens_per_s']:.1f} prefills={n_prefills} "
          f"prefill_ms={prefill_ms:.2f} completed {summary['n_completed']}/"
          f"{len(live)} max_concurrent={summary['max_concurrent']} "
          f"preemptions={summary['n_preemptions']} reopts={summary['kv_n_reopt']} "
          f"arena_reopts={arena.n_reopt} | {card}", flush=True)
    print(f"[serve:shared] memory: max_allocated={peak} B ({peak / 1e9:.3f} GB) over the "
          f"interleaved run (held before it {held / 1e9:.3f} GB), budget "
          f"{budget / 1e9:.3f} GB, arena account (joint + retained once) "
          f"{account / 1e9:.3f} GB: measured/account {peak / account:.4f}, "
          f"measured - account {(peak - account) / 1e9:.3f} GB against one weight "
          f"replica {replica / 1e9:.3f} GB; graph pools the account does not count "
          f"(held before the run): prefill {prefill_pool / 1e9:.3f} GB "
          f"({prefill_pool / account:.4f} of the account), decode "
          f"{decode_pool / 1e9:.3f} GB | {card}", flush=True)
    print(f"[serve:shared] launches {launches}", flush=True)
    if colo["n_train_steps"] < 1 or not math.isfinite(colo["train_loss"]):
        raise AssertionError(f"shared: fine-tune {colo}")
    if summary["n_completed"] != len(live):
        raise AssertionError(f"shared: completed {summary['n_completed']}/{len(live)}")
    if launches != want or n_steps == 0:
        raise AssertionError(f"shared: launches {launches}, expected {want}")
    got = dict(eng.completed)
    del step, eng
    free_cuda(torch)
    _, _, eng = make()
    eng.warmup()
    eng.run(live)
    where = first_divergence(eng.completed, got)
    print(f"[serve:shared] token streams equal to the same engine without fine-tune "
          f"steps: {where is None}; phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    if where is not None:
        rid, i = where
        raise AssertionError(f"shared: rid {rid} diverges at token {i} beside the "
                             "fine-tune")
    del eng
    return dict(launches=launches, budget=budget, account=account, peak=peak,
                train_step_ms=colo["train_step_ms_mean"], step_ms=step_ms,
                prefill_pool=prefill_pool)


def load_phase(torch, ops, cfg, model, params, cell: str, tag: str, expected,
               card: str) -> dict:
    """``[load:<tag>]``: one ``repro_torch.launch.load`` cell (a seeded
    ``LoadGen`` trace; the pool planned from it with every generation length
    halved) served by the loaded full-width model three ways through
    ``load.run_cell``: traced with graphs (``Tracer(capacity=262_144)``),
    untraced with graphs, traced eagerly.  Launch counters, peak memory and
    the step timers are reset just before each run.  Prints the trace's
    SHA-256 and class counts, then ``load.report``'s lines (TTFT/TPOT/E2E
    p50/p99 in steps and in ms, TTFT ending at the first token on the host;
    SLO attainment and goodput per class; preemptions and stall steps by
    replan cause; the drift report), the physical pool's bytes and
    ``max_memory_allocated``, decode step ms traced and untraced (the
    tracer's cost) and the traced run's launches.  Fails unless every run
    completes every request with launches equal to ``expected``, no span
    breaks conservation, the exported trace validates and its ``kv-pool``
    rectangles pass ``validate_plan``, the untraced and eager token streams
    equal the traced ones, and the eager run's step-clock spans equal the
    graphed run's.  Returns the traced run's launches, preemptions and
    replans."""
    from repro_torch.core.dsa import AllocationPlan, validate_plan
    from repro_torch.core.events import Block, MemoryProfile
    from repro_torch.launch import load
    from repro_torch.obs import load_chrome_trace, plan_rectangles, validate_chrome_trace
    free_cuda(torch)
    t_phase = time.perf_counter()
    lt, sample, live = load.traffic(cell, cfg.vocab_size)
    classes = {}
    for name in lt.class_of.values():
        classes[name] = classes.get(name, 0) + 1
    print(f"[load:{tag}] {cell}: {len(live)} requests, arrivals "
          f"{[r.arrival for r in live]}, classes {classes or 'none'}, prompts "
          f"{min(len(r.prompt) for r in live)}-{max(len(r.prompt) for r in live)}, "
          f"live gen {min(r.gen_len for r in live)}-{max(r.gen_len for r in live)}, "
          f"trace sha256 {hashlib.sha256(lt.to_bytes()).hexdigest()}", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="load_trace_") as tmp:
        path = str(Path(tmp) / f"{cell}.json")
        for name, graphs, traced in (("traced", None, True), ("untraced", None, False),
                                     ("eager", False, True)):
            eng = load.make_engine(model, params, cell, sample, graphs=graphs)
            eng.warmup()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            steps0, prefills0 = eng.decode_steps, eng.prefill_calls
            eng.decode_time_s = eng.prefill_time_s = 0.0
            run = load.run_cell(eng, cell, lt, live, traced=traced,
                                trace_path=path if name == "traced" else "")
            launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
            n_steps, n_prefills = eng.decode_steps - steps0, eng.prefill_calls - prefills0
            r = dict(run=run, launches=launches, completed=dict(eng.completed),
                     step_ms=1e3 * eng.decode_time_s / n_steps,
                     prefill_ms=1e3 * eng.prefill_time_s / n_prefills,
                     peak=torch.cuda.max_memory_allocated(), n_steps=n_steps,
                     n_prefills=n_prefills, engine_steps=eng.step_count)
            if run.summary["n_completed"] != len(live):
                raise AssertionError(f"load:{tag} {name}: completed "
                                     f"{run.summary['n_completed']}/{len(live)}")
            want = expected(n_steps, n_prefills)
            if launches != want:
                raise AssertionError(f"load:{tag} {name}: launches {launches}, "
                                     f"expected {want}")
            if name == "traced":
                bad = run.tracker.conservation_violations()
                if bad or run.tracer.n_dropped or len(run.tracker.finished()) != len(live):
                    raise AssertionError(f"load:{tag}: conservation violated for {bad}, "
                                         f"dropped {run.tracer.n_dropped}, "
                                         f"{len(run.tracker.finished())} finished spans")
                trace = load_chrome_trace(path)
                r["trace_bytes"] = Path(path).stat().st_size
                validate_chrome_trace(trace)
                rects = plan_rectangles(trace, "kv-pool")
                rebuilt = MemoryProfile(
                    blocks=[Block(bid=x["bid"], size=x["size"], start=x["start"],
                                  end=x["end"]) for x in rects],
                    clock_end=max(x["end"] for x in rects))
                validate_plan(rebuilt, AllocationPlan(
                    offsets={x["bid"]: x["offset"] for x in rects}, peak=rects[0]["peak"]))
                r["rects"] = len(rects)
                r["pool_bytes"] = sum(t.numel() * t.element_size()
                                      for t in eng.cache.values())
                r["n_pages"] = eng.kv.stats()["n_pages"]
            runs[name] = r
            del eng, run
            free_cuda(torch)
    tr, un, ea = runs["traced"], runs["untraced"], runs["eager"]
    run = tr["run"]
    print(f"[load:{tag}] traced graphs: engine steps={tr['engine_steps']} decode steps="
          f"{tr['n_steps']} prefills={tr['n_prefills']} wall={run.wall_s:.2f}s "
          f"events={len(run.tracer.events())} (none dropped), trace {tr['trace_bytes']} B "
          f"valid, kv-pool rectangles {tr['rects']} valid; launches {tr['launches']} "
          f"| {card}", flush=True)
    load.report(run, tag, f" | {card}")
    print(f"[load:{tag}] pool n_pages={tr['n_pages']}: physical pool {tr['pool_bytes']} B, "
          f"max_memory_allocated over the run {tr['peak']} B | {card}", flush=True)
    print(f"[load:{tag}] decode step ms traced {tr['step_ms']:.4f} untraced "
          f"{un['step_ms']:.4f} (tracer {tr['step_ms'] - un['step_ms']:+.4f} ms a step), "
          f"eager traced {ea['step_ms']:.4f}; prefill ms traced {tr['prefill_ms']:.3f} "
          f"untraced {un['prefill_ms']:.3f} eager traced {ea['prefill_ms']:.3f}; TTFT ms "
          f"graphs {load.ttft_ms(run)}, eager {load.ttft_ms(ea['run'])}; wall s traced "
          f"{run.wall_s:.3f} untraced {un['run'].wall_s:.3f} | {card}", flush=True)
    for other in ("untraced", "eager"):
        where = first_divergence(tr["completed"], runs[other]["completed"])
        if where is not None:
            raise AssertionError(f"load:{tag}: the {other} run diverges from the traced "
                                 f"graphed one at (rid, token) {where}")
    same_spans = load.step_spans(run.tracker) == load.step_spans(ea["run"].tracker)
    print(f"[load:{tag}] token streams traced = untraced = eager: True; step-clock spans "
          f"graphs = eager: {same_spans}; phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    if not same_spans:
        raise AssertionError(f"load:{tag}: the eager run's step-clock spans differ")
    s = run.summary
    if s["n_preemptions"] + s["kv_n_reopt"] == 0:
        print(f"[load:{tag}] no preemption and no replan: the admission gate absorbed "
              "the undersized pool", flush=True)
    return dict(launches=tr["launches"], preemptions=s["n_preemptions"],
                reopts=s["kv_n_reopt"])


def check_forward(torch, cfg, Transformer, params, tokens, kernel, plain, yardstick,
                  what: str, *, hold: bool = True, slack: int = 0, frames=None) -> None:
    """Full-width bf16 ``forward`` logits through the kernels (RunOpts
    ``kernel``) and through their plain versions (``plain``).  The two sum
    in other orders, so the f32 kernel outputs differ in the last bits, a
    few of their bf16 casts round the other way, and many random-weight
    layers carry it.  The yardstick is the plain path against itself with
    another block or chunk length (``yardstick``), which moves the scan by
    rounding alone: the kernels' max-abs error and their share of argmax
    disagreements may each be at most twice the yardstick's (plus
    ``slack`` positions, for a near-tie that any rounding can flip).
    ``hold=False`` prints the reading with no limit: where the stack is
    deep enough that the yardstick itself is saturated, there is nothing
    to hold it to.  An encoder-decoder reads ``frames`` too."""
    want = Transformer(cfg, plain).forward(params, tokens, frames).float()
    read = {}
    for name, opts in (("kernel", kernel), ("yardstick", yardstick)):
        got = Transformer(cfg, opts).forward(params, tokens, frames).float()
        read[name] = ((got - want).abs().max().item(),
                      (got.argmax(-1) != want.argmax(-1)).float().mean().item())
        del got
    (err, off), (err_y, off_y) = read["kernel"], read["yardstick"]
    n_pos = tokens.numel()
    limit = (f"limits 2x the yardstick's{f' + {slack} position' if slack else ''}"
             if hold else "reading only: the yardstick is saturated at this depth")
    print(f"[check] {cfg.name} {cfg.dtype} {cfg.n_layers}-layer full-width forward "
          f"({' x '.join(map(str, tokens.shape))} tokens) {what}: kernel "
          f"max_abs_err={err:.4g} argmax disagreement {off:.4f}; yardstick "
          f"max_abs_err={err_y:.4g} argmax disagreement {off_y:.4f}; "
          f"max|logits|={want.abs().max().item():.4g}; {limit}", flush=True)
    if not math.isfinite(err) or want.shape[:2] != tokens.shape:
        raise AssertionError(f"forward: logits {tuple(want.shape)}, max_abs_err {err}")
    if hold and not (err <= 2 * err_y and off <= 2 * off_y + slack / n_pos):
        raise AssertionError(f"forward: kernel vs plain max_abs_err {err:.4g}, "
                             f"argmax disagreement {off:.4f}, over 2x the yardstick")


def first_groups(cfg, params, groups: int):
    """The model cut to its first ``groups`` pattern groups and its tail,
    sharing the weights: (config, parameters)."""
    n = len(cfg.block_pattern) * groups
    tail = len(cfg.tail_pattern)
    return (cfg.with_overrides(n_layers=n + tail),
            {**params, "layers": params["layers"][:n] + params["layers"][-tail:]})


def train_phase(torch, ops, card: str, arch: str, short: str, *,
                n_layers: int | None = None, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, batch_hi: int = 256, cut_layers: int = 2) -> dict:
    """The training path on full-width ``arch`` (at ``n_layers`` when given,
    else full depth) at ``batch`` x ``seq`` tokens: profile, plan, train
    under three policies, check.  An encoder-decoder's profiles and steps
    take the pipeline's seeded frames (B, encoder_seq, d_model) f32 beside
    the tokens.  An MoE model also prints ce and aux apart at the first and
    last step and the no-remat run's drop share, and its f32 cut holds the
    routing on the card against the CPU's.  The f32 cut has ``cut_layers``
    layers (the hybrid's first group and its tail: 5) and an
    encoder-decoder's 2 encoder layers.  Appends what the cell's
    ``[roofline:<short>]`` line needs to ``TRAIN_CELLS``.  Returns the kernel launches counted during the phase (all must be 0)."""
    import statistics

    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import get_config
    from repro_torch.core import MemoryPlanner
    from repro_torch.core.planner import HBM_BYTES
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import RunOpts, Transformer
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train_lib

    free_cuda(torch)
    ops.reset_launches()
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_overrides(n_layers=n_layers)
    moe, enc = bool(cfg.n_experts), cfg.is_encoder_decoder
    opts = RunOpts(attention_impl="full", use_kernels=False)
    model = Transformer(cfg, opts)

    def batch_sds(b):       # the pipeline's frames are f32
        return train_lib.batch_specs(cfg, b, seq, torch.float32)
    bsds = batch_sds(batch)
    planner = MemoryPlanner()
    tag = f"[train:{short}] B={batch} S={seq} {cfg.n_layers} layers"
    if enc:
        tag += f" + {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames"
    if moe:
        cap = moe_lib.capacity(batch * seq, cfg.top_k, cfg.n_experts,
                               cfg.capacity_factor)
        tag += f" E={cfg.n_experts} k={cfg.top_k} C={cap}"

    # -- 1. profile: make_fx of grad(loss) on fake tensors --------------------------------
    t0 = time.perf_counter()
    prof = train_lib.profile_step(model, bsds)
    rep = planner.report(prof)
    print(f"{tag} profile blocks={prof.n} n_eqns={prof.meta['n_eqns']} "
          f"total={prof.total_bytes / 1e9:.3f}GB retained={prof.retained_bytes / 1e9:.3f}GB "
          f"lower_bound={prof.liveness_lower_bound() / 1e9:.3f}GB "
          f"bestfit_peak={rep.plan.peak / 1e9:.3f}GB "
          f"pool_peak={rep.baselines['pool_peak'] / 1e9:.3f}GB "
          f"saving_vs_pool={rep.baselines['saving_vs_pool']:.4f} "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 2. plan: the closed remat loop, and the largest batch without remat -------------
    t0 = time.perf_counter()
    policy, ev = train_lib.plan_remat_policy(model, bsds, profile=prof, **TRAIN_PLAN)
    s = ev.summary()
    print(f"{tag} plan {TRAIN_PLAN}: {policy.describe()} evictions={s['n_evicted']} "
          f"peak {s['baseline_peak'] / 1e9:.3f} -> {s['peak'] / 1e9:.3f}GB (verified "
          f"{ev.meta['verified']}, target {ev.target_peak / 1e9:.3f}GB, reached_target "
          f"{ev.reached_target}) rounds={ev.meta['rounds']} "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    # the search starts where the packing peak, scaled with the batch, meets
    # the budget: the same boundary as a bisection from 1, fewer profiles
    max_b = planner.max_feasible_batch_planned(
        lambda b: train_lib.profile_step(model, batch_sds(b)), HBM_BYTES, hi=batch_hi,
        guess=batch * (HBM_BYTES - prof.retained_bytes) // rep.plan.peak)
    print(f"{tag} max_feasible_batch_planned (no remat, {HBM_BYTES / 1e9:.0f}GB, "
          f"batches 1-{batch_hi}) = {max_b} in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    full_peak = planner.plan(train_lib.profile_step(model, bsds, True)).peak
    print(f"{tag} full remat profile: bestfit_peak={full_peak / 1e9:.3f}GB "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    planned_peak = {"none": rep.plan.peak, "full": full_peak, "planned": ev.peak}

    # -- 3. train: 5 steps per policy from the same initial state and batches -------------
    t_train = time.perf_counter()
    acfg = AdamWConfig(lr=TRAIN_LR[short], warmup_steps=2, total_steps=TRAIN_STEPS)
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=0,
                                        frames=cfg.encoder_seq if enc else 0,
                                        frame_dim=cfg.d_model if enc else 0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    losses, gnorms, param_errs = {}, {}, {}
    medians, peaks_abs, peaks_above = {}, {}, {}
    none_final = None

    def param_err(params, base):
        """(relative L2, max abs) difference of ``params`` from ``base``"""
        d2 = w2 = dmax = 0.0
        with torch.no_grad():
            for a, b in zip(params, base):
                b = b.to(a.device)
                d = a - b
                d2 += float(torch.linalg.vector_norm(d, dtype=torch.float64)) ** 2
                w2 += float(torch.linalg.vector_norm(b, dtype=torch.float64)) ** 2
                dmax = max(dmax, float(d.abs().max()))
                del b, d
        return math.sqrt(d2 / w2), dmax
    drops: dict = {}
    for name, remat in (("none", False), ("full", True), ("planned", policy)):
        free_cuda(torch)
        state = train_lib.init_state(model, torch.Generator(device="cuda").manual_seed(SEED),
                                     acfg)
        step, _ = train_lib.build_train_step(model, None, acfg,
                                             train_lib.TrainOpts(remat=remat))
        ls, gn, ms, mem, mem_abs, parts = [], [], [], [], [], []
        # the no-remat run counts the dispatch's drops (a recompute would count twice)
        counting = (counting_drops(torch, moe_lib, drops) if moe and name == "none"
                    else contextlib.nullcontext())
        with counting:
            for b in batches:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                mem.append(torch.cuda.max_memory_allocated() - before)
                mem_abs.append(torch.cuda.max_memory_allocated())
                ls.append(float(m["loss"]))
                gn.append(float(m["grad_norm"]))
                parts.append((float(m["ce"]), float(m["aux"])))
        # the grad step alone (what the plan packs): the step's peak also
        # holds the optimizer update's temporaries
        free_cuda(torch)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = train_lib.grad_step(model, remat)(state["params"], batches[0])
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated() - before
        del grads
        losses[name], gnorms[name] = ls, gn
        # no remat's final parameters wait on the host (the hybrid's would not
        # fit on the card beside another run's training state); each other
        # run is compared with them on the card, a leaf at a time
        if name == "none":
            none_final = [t.detach().cpu() for t in tree_leaves(state["params"])]
        else:
            param_errs[name] = param_err(tree_leaves(state["params"]), none_final)
        if name == "none":
            with torch.no_grad():
                held = float(model.loss_fn(state["params"], batches[0], remat=False)[0])
            print(f"{tag} remat=none lr {acfg.lr:g}: step-1 batch loss {ls[0]:.5f} before "
                  f"training, {held:.5f} after {TRAIN_STEPS} steps; step losses fall from "
                  f"step 1 to {TRAIN_STEPS}: {ls[-1] < ls[0]}", flush=True)
        peak = max(mem)
        medians[name], peaks_abs[name], peaks_above[name] = (statistics.median(ms),
                                                             max(mem_abs), peak)
        split = (f"ce/aux step 1 {parts[0][0]:.5f}/{parts[0][1]:.5f} step {TRAIN_STEPS} "
                 f"{parts[-1][0]:.5f}/{parts[-1][1]:.5f} " if moe else "")
        print(f"{tag} remat={name} losses={[round(x, 5) for x in ls]} {split}"
              f"grad_norms={[round(x, 6) for x in gn]} "
              f"step_ms={[round(x, 1) for x in ms]} median_step_ms={statistics.median(ms):.1f} "
              f"measured_peak={peak / 1e9:.3f}GB planned_peak={planned_peak[name] / 1e9:.3f}GB "
              f"measured/planned={peak / planned_peak[name]:.3f} grad_step_peak="
              f"{grad_peak / 1e9:.3f}GB grad_step/planned="
              f"{grad_peak / planned_peak[name]:.3f} | {card}", flush=True)
        del state, step
    for lr in TRAIN_LR_YARDSTICKS[short]:
        free_cuda(torch)
        other = AdamWConfig(lr=lr, warmup_steps=2, total_steps=TRAIN_STEPS)
        state = train_lib.init_state(model, torch.Generator(device="cuda").manual_seed(SEED),
                                     other)
        step, _ = train_lib.build_train_step(model, None, other,
                                             train_lib.TrainOpts(remat=False))
        for b in batches:
            state, _ = step(state, b)
        with torch.no_grad():
            after = float(model.loss_fn(state["params"], batches[0], remat=False)[0])
        print(f"{tag} remat=none lr {lr:g} (printed, not held): step-1 batch loss "
              f"{losses['none'][0]:.5f} before training, {after:.5f} after {TRAIN_STEPS} "
              "steps", flush=True)
        del state, step
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    if moe:
        (calls, n, dropped), = drops.values()
        dropped = int(dropped.item())
        print(f"{tag} remat=none dispatch drops at T={batch * seq}, C={cap}: "
              f"{dropped}/{n} assignments ({dropped / n:.4f}) over {calls} calls "
              f"({TRAIN_STEPS} steps x {cfg.n_layers} layers) | {card}", flush=True)

    state_errs = {name: (max(abs(x - y) / abs(y) for x, y in zip(gnorms[name], gnorms["none"])),
                         *param_errs[name]) for name in ("full", "planned")}
    for name, (g, p, dmax) in state_errs.items():
        print(f"{tag} remat={name} against none: grad norms' max rel diff {g:.3g}; parameters after {TRAIN_STEPS} steps rel L2 {p:.3g} "
              f"max_abs {dmax:.3g} (tol {TRAIN_STATE_TOL} relative)", flush=True)
    del none_final
    print(f"{tag} training, yardsticks and comparisons took "
          f"{time.perf_counter() - t_train:.1f}s", flush=True)

    # -- 4. check ----------------------------------------------------------------------------
    base = losses["none"]
    if not (all(math.isfinite(x) for x in base) and math.isfinite(held)
            and held < base[0]):
        raise AssertionError(f"train: no-remat losses {base} not finite, or the step-1 "
                             f"batch's loss did not fall ({base[0]} -> {held})")
    for name in ("full", "planned"):
        for i, (x, y) in enumerate(zip(losses[name], base)):
            if not abs(x - y) <= TRAIN_LOSS_TOL * abs(y):
                raise AssertionError(f"train: {name} loss at step {i + 1} {x} against "
                                     f"no remat {y}, over {TRAIN_LOSS_TOL} relative")
        g, p, _ = state_errs[name]
        if not (g <= TRAIN_STATE_TOL and p <= TRAIN_STATE_TOL):
            raise AssertionError(f"train: {name}'s grad norms ({g:.3g}) or parameters after "
                                 f"{TRAIN_STEPS} steps ({p:.3g}) differ from no remat's "
                                 f"by over {TRAIN_STATE_TOL} relative")
    if any(launches.values()):
        raise AssertionError(f"train: kernels launched during training: {launches}")
    del model, batches
    free_cuda(torch)
    # the f32 cut on the card and on the CPU, each held to a float64 CPU run of
    # the same step: f32 rounding alone moves this random-weight step's
    # gradients by ~1e-3 (scores of the reference's init are large), so the
    # card must be at most twice as far from float64 as the CPU is.  An MoE
    # cut must route alike on the card and the CPU first (keep and dest of
    # every layer), or the two compute different functions.  The gradients
    # are compared leaf by leaf, the card's copied to the host one at a time
    # and the float64 ones kept, so that the hybrid's 3.1 B-parameter cut
    # holds no three whole gradient vectors on the host at once.
    t_cut = time.perf_counter()
    cut = get_config(arch).with_overrides(n_layers=cut_layers, dtype="float32",
                                          **({"encoder_layers": 2} if enc else {}))
    first = pipe.batch_at(0)
    cut_batch = {"tokens": torch.from_numpy(first["tokens"][:2, :65].copy())}
    if enc:
        cut_batch["frames"] = torch.from_numpy(first["frames"][:2].copy())
    init = Transformer(cut, opts, device="cpu").init(torch.Generator().manual_seed(SEED + 11))
    losses_cut, grads_cut, routing = {}, {}, {}
    sq = {"card-float64": 0.0, "cpu-float64": 0.0, "card-cpu": 0.0}
    norm2 = {"float64": 0.0, "cpu": 0.0}
    for label, dev, dt in (("float64", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
                           ("card", "cuda", torch.float32)):
        m = Transformer(cut.with_overrides(dtype=str(dt).removeprefix("torch.")), opts,
                        device=dev)
        params = tree_map(lambda t: t.to(dev, dt).detach().requires_grad_(), init)
        if label == "card":
            init = None
        seen = routing.setdefault(label, [])
        with watching_dispatch(moe_lib, lambda xg, d: seen.append((d.keep.cpu(),
                                                                   d.dest.cpu()))):
            loss, _ = m.loss_fn(params, {k: v.to(dev) for k, v in cut_batch.items()},
                                remat=False)
        grads = train_lib.leaf_grads(loss, tree_leaves(params))
        losses_cut[label] = float(loss.detach())
        del params, loss, m
        if label == "float64":
            grads_cut["float64"] = [g.detach() for g in grads]
            norm2["float64"] = sum(float(torch.linalg.vector_norm(g)) ** 2
                                   for g in grads_cut["float64"])
            continue
        for i, g in enumerate(grads):
            d = g.detach().to("cpu", torch.float64)
            if label == "cpu":
                norm2["cpu"] += float(torch.linalg.vector_norm(d)) ** 2
            else:
                sq["card-cpu"] += float(torch.linalg.vector_norm(d - grads_cut["cpu"][i])) ** 2
            d.sub_(grads_cut["float64"][i])
            sq[f"{label}-float64"] += float(torch.linalg.vector_norm(d)) ** 2
            del d
        if label == "cpu":
            grads_cut["cpu"] = [g.detach() for g in grads]
        del grads
    del grads_cut
    free_cuda(torch)

    def same_routes(a, b):
        return len(routing[a]) == len(routing[b]) and all(
            torch.equal(ka, kb) and torch.equal(da, db)
            for (ka, da), (kb, db) in zip(routing[a], routing[b]))
    if moe:
        kept = [int(k.sum()) for k, _ in routing["card"]]
        print(f"[check] {arch} f32 2-layer cut routing (2 x 64 tokens, C="
              f"{moe_lib.capacity(128, cut.top_k, cut.n_experts, cut.capacity_factor)}): "
              f"keep and dest card = CPU: {same_routes('card', 'cpu')}, float64 = CPU: "
              f"{same_routes('float64', 'cpu')}; kept per layer {kept} of "
              f"{routing['card'][0][0].numel()}", flush=True)
        if not same_routes("card", "cpu"):
            raise AssertionError(f"train: the f32 cut of {arch} routes differently on the "
                                 "card and on the CPU (keep or dest differ)")

    def grad_err(pair, ref):
        return math.sqrt(sq[pair] / norm2[ref])
    loss_err = abs(losses_cut["card"] - losses_cut["cpu"]) / abs(losses_cut["cpu"])
    err_card, err_cpu = grad_err("card-float64", "float64"), grad_err("cpu-float64", "float64")
    what = f"{cut.n_layers}-layer" + (f" + {cut.encoder_layers}-encoder-layer" if enc else "")
    print(f"[check] {arch} f32 {what} full-width train step (2 x 64 tokens"
          f"{f' over 2 x {cut.encoder_seq} frames' if enc else ''}, TF32 off): "
          f"loss card {losses_cut['card']:.6f} CPU {losses_cut['cpu']:.6f} "
          f"rel_err={loss_err:.3g} (tol {CUT_LOSS_TOL}); gradients' rel L2 distance from "
          f"float64: card {err_card:.3g}, CPU {err_cpu:.3g} (tol {CUT_GRAD_YARDSTICK}x the "
          f"CPU's), card against CPU {grad_err('card-cpu', 'cpu'):.3g}; "
          f"{time.perf_counter() - t_cut:.1f}s", flush=True)
    if not (loss_err <= CUT_LOSS_TOL and err_card <= CUT_GRAD_YARDSTICK * err_cpu):
        raise AssertionError("train: the f32 cut's loss or gradients on the card are "
                             "further from the CPU's / float64's than allowed")
    TRAIN_CELLS.append({"arch": arch, "n_layers": n_layers, "short": short, "tag": tag,
                        "cfg": cfg, "batch": batch, "seq": seq, "medians": medians,
                        "peaks_abs": peaks_abs, "peaks_above": peaks_above})
    print(f"{tag} launches during training {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


def roofline_trace(arch: str, n_layers, batch: int, seq: int) -> dict:
    """The dry run of one ``[train:*]`` cell, in a worker process:
    ``dryrun.trace_train`` of the phase's whole step (the gradient and AdamW
    over the f32 state and the same batch specs, f32 frames) on fake CPU
    tensors under no and full remat (the counts do not depend on the
    device), each read by ``dryrun.analyze_cell`` -> ``{"none": meta,
    "full": meta, "seconds": s}``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import RunOpts, Transformer
    from repro_torch.runtime import train_lib

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_overrides(n_layers=n_layers)
    model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False), device="cpu")
    bsds = train_lib.batch_specs(cfg, batch, seq, torch.float32)
    out = {name: dryrun.analyze_cell(dryrun.trace_train(model, bsds, remat), {})
           for name, remat in (("none", False), ("full", True))}
    out["seconds"] = time.perf_counter() - t0
    return out


def dryrun_multi_trace(shape_name: str, n_layers) -> dict:
    """The dry run over the reference's multi-pod mesh of one of
    ``DRYRUN_MULTI``'s cells of qwen2-0.5b, in a worker process: the
    registered cell's step (full remat for training) traced over (pod 2,
    data 16, model 16) on fake CPU tensors as rank 0 of a 512-rank fake
    process group (``launch.mesh.make_production_mesh``), on its local
    shards, read by ``dryrun.analyze_cell`` and ``roofline`` -> the
    record, its roofline terms and its seconds."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import describe, end_process_group, make_production_mesh

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    if n_layers is not None:
        cfg = cfg.with_overrides(n_layers=n_layers)
    args = dryrun.build_parser().parse_args(["--device", "cpu", "--mesh", "multi"])
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    try:
        gm, meta = dryrun.trace_step(cfg, SHAPES[shape_name], args, mesh)
        meta.update(arch=ARCH, shape=shape_name, mesh=describe(mesh)["axes"], mesh_tag="multi")
        meta["trace_s"] = time.perf_counter() - t0
        meta = dryrun.analyze_cell(gm, meta)
    finally:
        end_process_group()
    cell = roofline.analyze_cell_json(meta)
    meta["terms"] = {"compute_s": cell.compute_s, "memory_s": cell.memory_s,
                     "coll_s": cell.coll_s, "dominant": cell.dominant}
    meta["seconds"] = time.perf_counter() - t0
    return meta


def dryrun_multi_line(card: str, meta: dict) -> None:
    """``[dryrun:multi]`` for one ``DRYRUN_MULTI`` cell: per device, dot
    FLOPs, HBM bytes, collective wire bytes by kind, the compute, memory and
    collective terms, retained + DSA and whether they fit one H100.  Fails
    unless the training cell moves collective bytes."""
    from repro_torch.launch import roofline as rl
    h, t, f = meta["aten"], meta["terms"], meta["fits"]
    kinds = " ".join(f"{k}={v / 1e9:.4f}GB/{h['coll_counts'][k]}"
                     for k, v in sorted(h["coll_bytes_by_kind"].items()))
    depth = "" if DRYRUN_MULTI_LAYERS is None else f" (depth cut to {DRYRUN_MULTI_LAYERS} layers)"
    print(f"[dryrun:multi] {meta['arch']} {meta['shape']}{depth} mesh={meta['mesh']} rank 0 of "
          f"512 fake ranks, per device: dot_flops={h['dot_flops']:.6g} "
          f"hbm={h['hbm_bytes'] / 1e9:.3f}GB coll={h['coll_bytes'] / 1e9:.4f}GB ({kinds}) "
          f"compute={1e3 * t['compute_s']:.3f}ms memory={1e3 * t['memory_s']:.3f}ms "
          f"collective={1e3 * t['coll_s']:.3f}ms ({t['dominant']}; link {rl.LINK_BW / 1e9:g}GB/s) "
          f"arguments={meta['memory_analysis']['argument_bytes'] / 1e9:.4f}GB "
          f"retained+dsa={f['retained_plus_dsa'] / 1e9:.3f}GB fits={f['fits']} "
          f"trace={meta['trace_s']:.1f}s worker={meta['seconds']:.1f}s | {card}", flush=True)
    if meta["kind"] == "train" and not h["coll_bytes"] > 0:
        raise AssertionError(f"[dryrun:multi] {meta['shape']}: no collective bytes")


def roofline_phase(card: str) -> None:
    """The ``[roofline:*]`` lines of ``TRAIN_CELLS``, after every cell's
    steps are timed: each cell's ``roofline_trace`` in a spawned worker
    process of its own (all at once; the card and the main process wait),
    then ``roofline_line`` in cell order; beside them, one worker each for
    the ``[dryrun:multi]`` traces of ``DRYRUN_MULTI``; and a ``[roofline]``
    line with the phase's seconds on the script's clock."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    n = len(TRAIN_CELLS) + len(DRYRUN_MULTI)
    with concurrent.futures.ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(roofline_trace, c["arch"], c["n_layers"], c["batch"], c["seq"])
                for c in TRAIN_CELLS]
        multi = [pool.submit(dryrun_multi_trace, shape, DRYRUN_MULTI_LAYERS)
                 for shape in DRYRUN_MULTI]
        for c, job in zip(TRAIN_CELLS, jobs):
            roofline_line(card, job.result(), c)
        for job in multi:
            dryrun_multi_line(card, job.result())
    took = time.perf_counter() - t0
    print(f"[roofline] {len(TRAIN_CELLS)} lines and {len(DRYRUN_MULTI)} [dryrun:multi] "
          f"took {took:.1f}s of the script ({n} worker processes, nothing else running) "
          f"| {card}", flush=True)


def roofline_line(card: str, traced: dict, cell: dict) -> None:
    """``[roofline:<short>]`` for a training cell of ``TRAIN_CELLS``:
    ``launch/roofline``'s model FLOPs of its config at its batch x seq; for
    no and full remat,
    from the cell's ``roofline_trace`` (``traced``), the aten dot FLOPs and
    HBM bytes of the whole step, their compute and memory terms and bound
    on the H100, the measured median step, MFU (model FLOPs over the step
    time at the compute dtype's peak), measured over bound, and retained +
    DSA against the measured peak of the same policy (allocated, the step's
    inputs included) beside DSA against the peak above the inputs.  Fails
    unless 0 < MFU < 1."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline as rl

    cfg, short, medians = cell["cfg"], cell["short"], cell["medians"]
    peaks_abs, peaks_above = cell["peaks_abs"], cell["peaks_above"]
    batch, seq = cell["batch"], cell["seq"]
    mf = rl.model_flops(cfg, ShapeConfig("train", seq, batch, "train"))["model_flops"]
    peak = rl.peak_flops(cfg.dtype)
    parts = []
    for name in ("none", "full"):
        h, ma = traced[name]["aten"], traced[name]["memory_analysis"]
        compute_s, memory_s = h["dot_flops"] / peak, h["hbm_bytes"] / rl.HBM_BW
        bound_s, step_s = max(compute_s, memory_s), medians[name] / 1e3
        mfu = mf / (step_s * peak)
        planned = traced[name]["fits"]["retained_plus_dsa"]
        parts.append(
            f"remat={name} aten_flops={h['dot_flops']:.6g} model/aten="
            f"{mf / h['dot_flops']:.4f} hbm={h['hbm_bytes'] / 1e9:.3f}GB "
            f"compute={1e3 * compute_s:.3f}ms memory={1e3 * memory_s:.3f}ms "
            f"bound={1e3 * bound_s:.3f}ms ({'compute' if compute_s >= memory_s else 'memory'}) "
            f"step={medians[name]:.1f}ms mfu={mfu:.4f} measured/bound={step_s / bound_s:.3f} "
            f"retained+dsa={planned / 1e9:.3f}GB measured_peak={peaks_abs[name] / 1e9:.3f}GB "
            f"planned/measured={planned / peaks_abs[name]:.3f} dsa={ma['temp_bytes'] / 1e9:.3f}GB "
            f"above_inputs={peaks_above[name] / 1e9:.3f}GB "
            f"dsa/above={ma['temp_bytes'] / peaks_above[name]:.3f}")
        if not 0 < mfu < 1:
            raise AssertionError(f"roofline: {short} remat={name} MFU {mfu} outside (0, 1)")
    print(f"[roofline:{short}] {cell['tag'].split('] ', 1)[1]} {cfg.dtype} model_flops={mf:.6g} "
          f"peak={peak / 1e12:g}TFLOP/s hbm_bw={rl.HBM_BW / 1e12:g}TB/s | "
          + " | ".join(parts) + f" | traced and planned in a worker in "
          f"{traced['seconds']:.1f}s | {card}", flush=True)


def cudnn_line(torch) -> str:
    c = torch.backends.cudnn
    return (f"cudnn {c.version()} enabled={c.enabled} benchmark={c.benchmark} "
            f"deterministic={c.deterministic} allow_tf32={c.allow_tf32}; "
            f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def rel_l2(got, want) -> float:
    """Relative L2 distance of two lists of tensors (pairs on one device),
    over every element, in float64 a leaf at a time."""
    d2 = w2 = 0.0
    for a, b in zip(got, want):
        b = b.detach().double()
        d2 += float((a.detach().double() - b).norm()) ** 2
        w2 += float(b.norm()) ** 2
    return math.sqrt(d2 / w2)


def paper_cnn_phase(torch, ops, card: str, arch: str, short: str) -> dict:
    """``[paper:<net>]``: one of the paper's CNNs at its registered size
    (224, 224 or 299 pixels, f32, TF32 off) through ``launch.paper.run_cnn``:
    the train step's profile at the largest of ``PAPER_BATCHES`` whose
    retained + DSA peak fits the card's free memory (profiled from the
    largest down), trained at that batch or, for Inception-ResNet, at 4
    (``PAPER_BATCH_CAP``: its 16 would take ~11 s a step), at
    ``paper.sgd_lr``'s rate (the reference's 0.01, Inception-ResNet's 1e-6),
    the Fig. 2 rows of the step and of B=1 inference, the largest batch naive, pool and DSA each
    fit in 80 GB, ``PAPER_STEPS`` SGD steps with the measured allocated and
    reserved peaks over the plan, then a card-against-CPU cut of the same
    widths at 64x64 pixels and B=2.  Fails unless the losses are finite, the
    step-1 batch's loss has fallen after the steps, the B=1 logits are
    finite, the cut's logits agree within ``PAPER_LOGIT_TOL`` of their scale
    and its parameters after one SGD step within ``PAPER_PARAM_TOL``, and no
    kernel launched."""
    import dataclasses

    from repro_torch.launch import paper
    from repro_torch.models import cnn

    free_cuda(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = paper.config(arch)
    free, _ = torch.cuda.mem_get_info()
    fit = None
    for b in sorted(PAPER_BATCHES, reverse=True):
        r = paper.row(paper.cnn_profile(cfg, b, dev))
        print(f"[paper:{short}] B={b}: retained+DSA {(r['retained'] + r['dsa']) / 1e9:.3f}GB "
              f"against {free / 1e9:.3f}GB free", flush=True)
        if r["retained"] + r["dsa"] <= free:
            fit = b
            break
    if fit is None:
        raise AssertionError(f"paper:{short}: no batch of {PAPER_BATCHES} fits the card")
    batch = min(fit, PAPER_BATCH_CAP.get(short, fit))
    print(f"[paper:{short}] trains at B={batch} (largest of {PAPER_BATCHES} that fits: "
          f"{fit}{'; cut for the script time' if batch < fit else ''}) | {cudnn_line(torch)}",
          flush=True)
    res = paper.run_cnn(cfg, batch=batch, steps=PAPER_STEPS, device=dev, seed=SEED,
                        log=lambda line: print(line, flush=True))
    steps = res["steps"]
    if not (all(math.isfinite(x) for x in steps["loss"])
            and steps["first_batch_loss_after"] < steps["loss"][0]
            and res["inference"]["finite"]):
        raise AssertionError(f"paper:{short}: losses {steps['loss']} not finite, the step-1 "
                             f"batch's loss did not fall (-> {steps['first_batch_loss_after']})"
                             f" or B=1 logits not finite")
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    del res, steps
    free_cuda(torch)

    # the cut: the same parameters (drawn on the CPU) and inputs on both
    cut = dataclasses.replace(cfg, img=PAPER_CUT_IMG)
    init = cnn.init_cnn(cut, torch.Generator().manual_seed(SEED + 3))
    x, labels = paper.cnn_batch(cut, PAPER_CUT_BATCH, SEED + 4, torch.device("cpu"))
    out = {}
    for where in ("cpu", "cuda"):
        params = paper.requiring_grad({k: v.to(where) for k, v in init.items()})
        with torch.no_grad():
            logits = cnn.cnn_forward(params, x.to(where), cut).cpu()
        loss, new = cnn.train_step_fn(cut, paper.sgd_lr(cut))(params, x.to(where),
                                                             labels.to(where))
        out[where] = (logits, float(loss), [t.detach().cpu() for t in new.values()])
    scale = float(out["cpu"][0].abs().max())
    logit_err = float((out["cuda"][0] - out["cpu"][0]).abs().max()) / scale
    param_err = rel_l2(out["cuda"][2], out["cpu"][2])
    print(f"[check] {arch} f32 cut {PAPER_CUT_IMG}x{PAPER_CUT_IMG} B={PAPER_CUT_BATCH}: "
          f"logits card vs CPU max-abs {logit_err:.3g} of max|logits| {scale:.4g} "
          f"(tol {PAPER_LOGIT_TOL}); loss {out['cuda'][1]:.6f} / {out['cpu'][1]:.6f}; "
          f"parameters after one SGD step rel L2 {param_err:.3g} (tol {PAPER_PARAM_TOL})",
          flush=True)
    if not (logit_err <= PAPER_LOGIT_TOL and param_err <= PAPER_PARAM_TOL):
        raise AssertionError(f"paper:{short}: the card's cut disagrees with the CPU's")
    if any(launches.values()):
        raise AssertionError(f"paper:{short}: kernels launched: {launches}")
    print(f"[paper:{short}] launches {launches}; phase {time.perf_counter() - t0:.1f}s | "
          f"{card}", flush=True)
    return launches


def paper_s2s_phase(torch, ops, card: str) -> dict:
    """``[paper:seq2seq]``: the LSTM seq2seq at its registered size (vocab
    40,000, d 512, 2 layers, ``infer_len`` 100) through
    ``launch.paper.run_seq2seq``: one train-step profile per length of
    ``S2S_LENGTHS`` at B=64 (profile and plan seconds printed), the largest
    batches at the longest, ``S2S_STEPS`` SGD steps over a seeded order of
    the lengths (every length in the first three), each length's profile
    replayed through one signature-mode arena before its step, with plan and
    measured peaks, then 100 greedy tokens at B=1, timed; then a small cut
    (``S2S_CUT``) whose greedy tokens on the card must equal the CPU's.
    Fails unless the losses are finite, the arena's replans stop once every
    length has been seen (the count after the first three steps' resets is
    len(S2S_LENGTHS) - 1 and stays there) and no kernel launched."""
    import dataclasses

    from torch.utils._pytree import tree_map

    from repro_torch.launch import paper
    from repro_torch.models import seq2seq

    free_cuda(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg = paper.config("paper-seq2seq")
    res = paper.run_seq2seq(cfg, batch=S2S_BATCH, lengths=S2S_LENGTHS, steps=S2S_STEPS,
                            device=torch.device("cuda"), seed=SEED,
                            log=lambda line: print(line, flush=True))
    reopt = [s["n_reopt"] for s in res["steps"]]
    n = len(S2S_LENGTHS)
    if not (all(math.isfinite(s["loss"]) for s in res["steps"])
            and reopt[n:] == [n - 1] * (len(reopt) - n)
            and tuple(res["tokens"].shape) == (1, cfg.infer_len)):
        raise AssertionError(f"paper:seq2seq: losses not finite, replans {reopt} did not "
                             f"stop at {n - 1}, or tokens {tuple(res['tokens'].shape)}")
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    del res
    free_cuda(torch)
    cut = dataclasses.replace(cfg, **S2S_CUT)
    init = seq2seq.init_seq2seq(cut, torch.Generator().manual_seed(SEED + 5))
    src, _ = paper.s2s_batch(cut, 4, 10, SEED + 6, torch.device("cpu"))
    toks = {}
    for where in ("cpu", "cuda"):
        params = paper.requiring_grad(tree_map(lambda t: t.to(where), init))
        toks[where] = seq2seq.infer_fn(cut)(params, src.to(where)).cpu()
    same = torch.equal(toks["cpu"], toks["cuda"])
    print(f"[check] paper-seq2seq f32 cut (vocab {cut.vocab}, d {cut.d_model}, B=4, "
          f"10 source tokens, {cut.infer_len} greedy): tokens card = CPU: {same}", flush=True)
    if not same:
        raise AssertionError("paper:seq2seq: the card's greedy tokens differ from the CPU's")
    if any(launches.values()):
        raise AssertionError(f"paper:seq2seq: kernels launched: {launches}")
    print(f"[paper:seq2seq] launches {launches}; phase {time.perf_counter() - t0:.1f}s | "
          f"{card}", flush=True)
    return launches


def contraction_scaled_qk(torch, params: dict, d_model: int, gen) -> dict:
    """``params`` with every layer's wq and wk redrawn in place to std
    1/sqrt(d_model), the fan-in of their contraction, as the port's tests
    redraw them.  The reference's init takes the heads axis as the fan-in:
    at qwen2-0.5b's layout q and k are ~8 and ~21 an element and the
    scores ~170, a near one-hot softmax whose near ties make bf16
    gradients noise (1.3x their norm away from float64's at 2 layers over
    1152 tokens on the CPU, under full and chunked alike)."""
    with torch.no_grad():
        for layer in params["layers"]:
            for name in ("wq", "wk"):
                w = layer["attn"][name]
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device) / d_model ** 0.5)
    return params


def chunked_witness(torch, cfg, device, seq: int, chunk: int, vocab: int) -> dict:
    """One grad step of ``cfg`` (qwen2-0.5b's layout at its phase depth) with
    its vocabulary cut to ``vocab``, at ``seq`` tokens, under ``"full"`` in
    float64 (the yardstick) and under ``"chunked"`` (``chunk`` keys a
    chunk) and ``"full"`` in f32 and bf16, from one f32 draw: each one's
    loss and the relative L2 distance of its gradients (every leaf) from
    float64's, and chunked's from full's at each dtype.  Raises unless
    chunked's distance from float64 is at most ``CUT_GRAD_YARDSTICK`` times
    full's at each dtype."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.models import RunOpts, Transformer
    from repro_torch.runtime import train_lib

    cut = cfg.with_overrides(vocab_size=vocab)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    init = contraction_scaled_qk(torch, Transformer(
        cut.with_overrides(dtype="float32"), RunOpts(use_kernels=False),
        device=device).init(gen), cut.d_model, gen)
    tokens = torch.randint(0, vocab, (1, seq + 1), device=device, dtype=torch.int32,
                           generator=torch.Generator(device=device).manual_seed(SEED + 10))
    losses, grads = {}, {}
    for dt, impl in (("float64", "full"), ("float32", "chunked"), ("float32", "full"),
                     ("bfloat16", "chunked"), ("bfloat16", "full")):
        m = Transformer(cut.with_overrides(dtype=dt),
                        RunOpts(attention_impl=impl, attn_chunk=chunk, use_kernels=False),
                        device=device)
        master = torch.float64 if dt == "float64" else torch.float32
        params = tree_map(lambda t: t.to(device, master).detach().requires_grad_(), init)
        loss, _ = m.loss_fn(params, {"tokens": tokens}, remat=False)
        grads[(dt, impl)] = [g.detach() for g in
                             train_lib.leaf_grads(loss, tree_leaves(params))]
        losses[(dt, impl)] = float(loss.detach())
        del m, params, loss
        if device.type == "cuda":
            free_cuda(torch)
    ref = grads[("float64", "full")]
    out = {"losses": losses}
    for dt in ("float32", "bfloat16"):
        out[dt] = {impl: rel_l2(grads[(dt, impl)], ref) for impl in ("chunked", "full")}
        out[dt]["chunked_vs_full"] = rel_l2(grads[(dt, "chunked")], grads[(dt, "full")])
        print(f"[chunked] witness S={seq} (chunks of {chunk}) vocab {vocab} {dt}: loss "
              f"chunked {losses[(dt, 'chunked')]:.6f} full {losses[(dt, 'full')]:.6f} "
              f"float64 {losses[('float64', 'full')]:.6f}; gradients' rel L2 from float64: "
              f"chunked {out[dt]['chunked']:.4g}, full {out[dt]['full']:.4g} (tol "
              f"{CUT_GRAD_YARDSTICK}x full's); chunked vs full {out[dt]['chunked_vs_full']:.4g}",
              flush=True)
        if not out[dt]["chunked"] <= CUT_GRAD_YARDSTICK * out[dt]["full"]:
            raise AssertionError(f"chunked: at {dt} the chunked gradients are "
                                 f"{out[dt]['chunked']:.3g} from float64's, full's "
                                 f"{out[dt]['full']:.3g}")
    return out


def chunked_phase(torch, ops, card: str) -> dict:
    """``[chunked]``: the reference's chunked attention on the card.  At
    qwen2-0.5b's layout (14 heads over 2, D=64), bf16, B=1 x S=16384,
    ``attend_chunked`` (chunks of 1024) against ``attend_full`` (max-abs
    within 2e-2), each call's host ms and peak memory; then one grad step of
    full-width qwen2-0.5b cut to 2 layers (every wq / wk redrawn by
    ``contraction_scaled_qk``) at the largest S of ``CHUNK_SEQS`` whose
    no-remat planned peaks (chunked and full) fit the card's free memory,
    under ``"auto"`` (which takes chunked past 8192) and ``"full"``, each
    without and with full remat: the loss under auto
    must equal full's within 2e-2 and its gradients full's within
    ``CHUNK_GRAD_TOL`` (relative L2) at each remat setting, with the
    measured peaks and the planned ones of the no-remat steps printed; then
    ``chunked_witness`` at ``CHUNK_WITNESS_SEQ`` tokens, which holds the
    chunked backward against float64 in f32 and bf16.  No kernel may
    launch."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.core import MemoryPlanner
    from repro_torch.models import RunOpts, Transformer
    from repro_torch.models import attention as attn
    from repro_torch.runtime import train_lib

    free_cuda(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q = torch.randn((1, CHUNK_SEQ, kv, g, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, CHUNK_SEQ, kv, hd), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    outs, peaks = {}, {}
    for impl in ("full", "chunked"):
        free_cuda(torch)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs[impl] = attn.attend(q, k, v, impl=impl, causal=True)
        torch.cuda.synchronize()
        peaks[impl] = (torch.cuda.max_memory_allocated() - before,
                       1e3 * (time.perf_counter() - t1))
    err = float((outs["chunked"].float() - outs["full"].float()).abs().max())
    print(f"[chunked] attend H={cfg.n_heads} KV={kv} D={hd} bf16 B=1 S={CHUNK_SEQ}: chunked "
          f"(chunk 1024) vs full max_abs_err {err:.3g} (tol {CHUNK_TOL}); peak above the "
          f"inputs full {peaks['full'][0] / 1e9:.3f}GB in {peaks['full'][1]:.1f}ms, chunked "
          f"{peaks['chunked'][0] / 1e9:.3f}GB in {peaks['chunked'][1]:.1f}ms", flush=True)
    if not err <= CHUNK_TOL:
        raise AssertionError(f"chunked: attend_chunked against attend_full {err} > {CHUNK_TOL}")
    del outs["chunked"]
    # full attention with bf16 score storage (RunOpts.softmax_dtype) against its f32 path
    free_cuda(torch)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stored = attn.attend(q, k, v, impl="full", causal=True, softmax_dtype="bfloat16")
    torch.cuda.synchronize()
    peak_bf16, ms_bf16 = (torch.cuda.max_memory_allocated() - before,
                          1e3 * (time.perf_counter() - t1))
    err_bf16 = float((stored.float() - outs["full"].float()).abs().max())
    print(f"[chunked] attend H={cfg.n_heads} KV={kv} D={hd} bf16 B=1 S={CHUNK_SEQ}: full "
          f"softmax_dtype=bfloat16 vs the f32 path max_abs_err {err_bf16:.3g} (tol "
          f"{CHUNK_TOL}); peak above the inputs {peak_bf16 / 1e9:.3f}GB in {ms_bf16:.1f}ms, "
          f"f32 path {peaks['full'][0] / 1e9:.3f}GB ({peak_bf16 / peaks['full'][0]:.3f}x)",
          flush=True)
    if not err_bf16 <= CHUNK_TOL:
        raise AssertionError(f"chunked: bf16 score storage against the f32 path {err_bf16} "
                             f"> {CHUNK_TOL}")
    del q, k, v, outs, stored

    # the training step: S decided by the no-remat profiles
    small = cfg.with_overrides(n_layers=CHUNK_LAYERS)
    models = {impl: Transformer(small, RunOpts(attention_impl=impl, use_kernels=False))
              for impl in ("auto", "full")}
    free_cuda(torch)
    free, _ = torch.cuda.mem_get_info()
    planned = {}
    for seq in CHUNK_SEQS:
        planned = {}
        for impl, m in models.items():              # auto first: the larger plan
            prof = train_lib.profile_step(m, {"tokens": ((1, seq + 1), torch.int32)})
            planned[impl] = prof.retained_bytes + MemoryPlanner().plan(prof).peak
            if planned[impl] > free:
                break
        print(f"[chunked] train S={seq}: planned no-remat retained+DSA " + ", ".join(
            f"{impl} ({models[impl]._attn_impl(seq)}) {v / 1e9:.3f}GB"
            for impl, v in planned.items()) + f" against {free / 1e9:.3f}GB free",
            flush=True)
        if len(planned) == len(models) and max(planned.values()) <= free:
            break
    else:
        raise AssertionError(f"chunked: no S of {CHUNK_SEQS} fits the card without remat")
    if models["auto"]._attn_impl(seq) != "chunked":
        raise AssertionError(f"chunked: auto takes {models['auto']._attn_impl(seq)} at {seq}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = contraction_scaled_qk(torch, models["auto"].init(gen), small.d_model, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 8),
                           dtype=torch.int32)
    losses, grad_err = {}, {}
    for remat in (False, True):
        auto_grads = None
        for impl, m in models.items():              # auto first, then full
            free_cuda(torch)
            leaves = [t.requires_grad_() for t in tree_leaves(params)]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, _ = m.loss_fn(params, {"tokens": tokens}, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
            losses[(impl, remat)] = float(loss.detach())
            gnorm = math.sqrt(sum(float(gr.double().norm()) ** 2 for gr in grads))
            peak = torch.cuda.max_memory_allocated()
            plan = (f", planned {planned[impl] / 1e9:.3f}GB "
                    f"({peak / planned[impl]:.3f}x)" if not remat else "")
            print(f"[chunked] train S={seq} {CHUNK_LAYERS} layers attention_impl={impl} "
                  f"({m._attn_impl(seq)}) remat={'full' if remat else 'none'}: loss "
                  f"{losses[(impl, remat)]:.5f} grad norm {gnorm:.6g} in {ms:.1f}ms, "
                  f"peak {peak / 1e9:.3f}GB{plan}", flush=True)
            if auto_grads is None:
                auto_grads = grads
            else:
                grad_err[remat] = rel_l2(auto_grads, grads)
            del loss, grads, leaves
        del auto_grads
    for remat in (False, True):
        diff = abs(losses[("auto", remat)] - losses[("full", remat)])
        print(f"[chunked] train S={seq} remat={'full' if remat else 'none'}: auto vs full "
              f"loss {diff:.3g} (tol {CHUNK_TOL}), gradients rel L2 {grad_err[remat]:.4g} "
              f"(tol {CHUNK_GRAD_TOL})", flush=True)
        if not (diff <= CHUNK_TOL and grad_err[remat] <= CHUNK_GRAD_TOL):
            raise AssertionError(f"chunked: auto's loss {losses[('auto', remat)]} or "
                                 f"gradients (rel L2 {grad_err[remat]:.3g}) against full's "
                                 f"{losses[('full', remat)]} (remat {remat})")
    del params, models
    free_cuda(torch)
    chunked_witness(torch, small, torch.device("cuda"), CHUNK_WITNESS_SEQ, 1024,
                    CHUNK_WITNESS_VOCAB)
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    if any(launches.values()):
        raise AssertionError(f"chunked: kernels launched: {launches}")
    print(f"[chunked] launches {launches}; phase {time.perf_counter() - t0:.1f}s | {card}",
          flush=True)
    return launches


def mesh_phase(torch, ops, card: str, unsharded: dict) -> dict:
    """``[mesh:train]`` and ``[mesh:serve]`` (the module's docstring, phase
    10) over the one-card mesh; the process group ends with the phase.
    ``unsharded`` is phase 4's graphed unsharded run of the same qwen2 path
    (same seeded weights and trace, ``graph_ab``'s result, its eager run
    under ``"eager"``): the mesh runs' streams must equal both.  Returns
    the ``[mesh:serve]`` runs' kernel launches, eager and graphed, by run
    (``"eager"``, ``"graphs"``)."""
    import statistics

    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten_with_path, tree_map

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch.mesh import describe, one_card_mesh
    from repro_torch.models import RunOpts, Transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import sharding_rules, train_lib
    from repro_torch.serving import ServeEngine

    free_cuda(torch)
    t_phase = time.perf_counter()
    mesh = one_card_mesh()
    try:
        print(f"[mesh] {describe(mesh)} {mesh} in {time.perf_counter() - t_phase:.1f}s",
              flush=True)
        # -- [mesh:train] ----------------------------------------------------------
        t0 = time.perf_counter()
        cfg = get_config(ARCH).with_overrides(n_layers=TRAIN_QWEN2_LAYERS)
        model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False))
        acfg = AdamWConfig(lr=TRAIN_LR["qwen2"], warmup_steps=2, total_steps=TRAIN_STEPS)
        pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH, seed=0))
        batches = [{k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(i).items()}
                   for i in range(MESH_TRAIN_STEPS)]
        topts = train_lib.TrainOpts(remat=True)
        init = train_lib.init_state(model, torch.Generator(device="cuda").manual_seed(SEED),
                                    acfg)
        runs = {}
        ops.reset_launches()
        for name, m in (("unsharded", None), ("mesh", mesh)):
            state = tree_map(lambda t: t.detach().clone(), init)
            step, placed = train_lib.build_train_step(model, m, acfg, topts)
            if m is not None:
                state = sharding_rules.distribute_tree(state, placed[0], m)
            losses, ms = [], []
            for b in batches:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, met = step(state, b)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t1))
                losses.append(float(met["loss"]))
            leaves = tree_flatten_with_path(state["params"])[0]
            runs[name] = (losses, ms, [t.to_local() if hasattr(t, "to_local") else t
                                       for _, t in leaves])
            paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
                     for kp, _ in leaves]
            del state
        if any(fn.launches for fn in ops.WRAPPERS):
            raise AssertionError("mesh:train: a kernel launched in training")
        (lu, msu, pu), (lm, msm, pm) = runs["unsharded"], runs["mesh"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lm, lu))
        param_rel = rel_l2(pm, pu)
        differ = [p for p, a, b in zip(paths, pm, pu) if not torch.equal(a, b)]
        same = lu == lm and not differ
        print(f"[mesh:train] {ARCH} {cfg.n_layers} layers B={TRAIN_BATCH} S={TRAIN_SEQ} "
              f"bf16 over f32 masters, full remat, {MESH_TRAIN_STEPS} AdamW steps: median "
              f"step unsharded {statistics.median(msu):.1f}ms mesh "
              f"{statistics.median(msm):.1f}ms (steps {[round(x, 1) for x in msu]} / "
              f"{[round(x, 1) for x in msm]}); losses {lu} / {lm}; max relative loss "
              f"difference {loss_rel:.3e} (limit {MESH_LOSS_TOL:g}); parameters' "
              f"relative L2 difference {param_rel:.3e}; bit-identical {same}"
              f"{'' if same else f' ({len(differ)} of {len(paths)} leaves differ: {differ})'} "
              f"in {time.perf_counter() - t0:.1f}s | {card}", flush=True)
        if not loss_rel <= MESH_LOSS_TOL:
            raise AssertionError(f"mesh:train: loss differs by {loss_rel:.3e} relative")
        del runs, init, pu, pm
        free_cuda(torch)
        # -- [mesh:serve] ----------------------------------------------------------
        t0 = time.perf_counter()
        cfg = get_config(ARCH)
        trace, live = serve_trace(cfg, torch, N_REQUESTS, SEED)
        model, params = load_model(torch, Transformer, cfg, RunOpts(attention_impl="kernel"),
                                   SEED, "mesh:serve")

        def expected(steps, prefills):
            return {"flash_attention": cfg.n_layers * prefills,
                    "paged_attention": cfg.n_layers * steps, "ssd_scan": 0,
                    "rglru_scan": 0}
        eager = unsharded["eager"]
        eng = ServeEngine(model, params, sample_trace=trace, max_len=MAX_LEN,
                          max_batch=MAX_BATCH, attn_mode="paged", graphs=False, mesh=mesh)
        res = {"eager": eager, "mesh": serve_path(torch, ops, eng, live, expected, card,
                                                  "mesh")}
        del eng
        free_cuda(torch)
        where = first_divergence(res["eager"]["completed"], res["mesh"]["completed"])
        la = res["mesh"]["launches"]
        print(f"[mesh:serve] {ARCH} {cfg.n_layers} layers, {len(live)} requests x "
              f"{GEN_LEN} tokens, max_batch {MAX_BATCH}, paged pool, eager: decode step "
              f"{res['eager']['step_ms']:.2f}ms without the mesh (phase 4's "
              f"[serve:qwen2:eager]), "
              f"{res['mesh']['step_ms']:.2f}ms with it "
              f"({res['mesh']['step_ms'] / res['eager']['step_ms']:.2f}x), prefill "
              f"{res['eager']['prefill_ms']:.2f} / {res['mesh']['prefill_ms']:.2f}ms; "
              f"launches under the mesh [paged] {la['paged_attention']} [flash] "
              f"{la['flash_attention']}; greedy streams identical {where is None} "
              f"in {time.perf_counter() - t0:.1f}s | {card}", flush=True)
        if where is not None:
            rid, i = where
            raise AssertionError(f"mesh:serve: rid {rid} diverges at token {i}")
        if not (la["paged_attention"] > 0 and la["flash_attention"] > 0):
            raise AssertionError(f"mesh:serve: launches {la}")
        # -- [mesh:serve:graphs]: the same engine with CUDA graphs under the mesh --
        t0 = time.perf_counter()
        eng = ServeEngine(model, params, sample_trace=trace, max_len=MAX_LEN,
                          max_batch=MAX_BATCH, attn_mode="paged", graphs=None, mesh=mesh)
        rungs, buckets = eng.prefill_rungs(), eng.runner.buckets
        graphed = serve_path(torch, ops, eng, live, expected, card, "mesh:graphs")
        del eng
        lg = graphed["launches"]
        wheres = {name: first_divergence(run["completed"], graphed["completed"])
                  for name, run in (("eager mesh", res["mesh"]),
                                    ("graphed unsharded", unsharded))}
        print(f"[mesh:serve:graphs] {ARCH} {cfg.n_layers} layers, the same trace and "
              f"weights, CUDA graphs under the mesh: decode step "
              f"{graphed['step_ms']:.2f}ms against {unsharded['step_ms']:.2f}ms graphed "
              f"without the mesh (phase 4's [serve:qwen2]; "
              f"{graphed['step_ms'] / unsharded['step_ms']:.2f}x) and "
              f"{res['mesh']['step_ms']:.2f}ms eager with it "
              f"({res['mesh']['step_ms'] / graphed['step_ms']:.2f}x); prefill "
              f"{graphed['prefill_ms']:.2f}ms against {unsharded['prefill_ms']:.2f} / "
              f"{res['mesh']['prefill_ms']:.2f}ms; captures at warmup {len(buckets)} "
              f"buckets + {len(rungs)} rungs, after the run decode {graphed['n_compiles']} "
              f"prefill {graphed['prefill_captures']}; graph_pool_bytes decode "
              f"{graphed['pool_bytes']} prefill {graphed['prefill_pool_bytes']}; launches "
              f"[paged] {lg['paged_attention']} = {lg['paged_attention'] // graphed['steps']}"
              f" x {graphed['steps']} replayed steps, [flash] {lg['flash_attention']} = "
              f"{lg['flash_attention'] // graphed['prefills']} x {graphed['prefills']} "
              f"replayed prefills; greedy streams identical to the eager mesh run "
              f"{wheres['eager mesh'] is None} and to the graphed unsharded run "
              f"{wheres['graphed unsharded'] is None} in {time.perf_counter() - t0:.1f}s "
              f"| {card}", flush=True)
        for name, where in wheres.items():
            if where is not None:
                rid, i = where
                raise AssertionError(f"mesh:serve:graphs: rid {rid} diverges from the "
                                     f"{name} run at token {i}")
        if (graphed["n_compiles"], graphed["prefill_captures"]) != (len(buckets), len(rungs)):
            raise AssertionError(f"mesh:serve:graphs: {graphed['n_compiles']} decode and "
                                 f"{graphed['prefill_captures']} prefill captures for "
                                 f"{len(buckets)} buckets and {len(rungs)} rungs")
        if not (lg["paged_attention"] > 0 and lg["flash_attention"] > 0):
            raise AssertionError(f"mesh:serve:graphs: launches {lg}")
        del model, params
    finally:
        dist.destroy_process_group()
    free_cuda(torch)
    print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return {"eager": la, "graphs": lg}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.planner import MemoryPlanner
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import RunOpts, Transformer
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm
    from repro_torch.runtime.serve_lib import layer_kinds
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.pages import choose_page_tokens

    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ---------------------------------------------------------------------
    secs = build.build_all()
    srcs = [str(s.relative_to(ROOT)) for s in build.sources()]
    print(f"[build] {len(srcs)} kernels {srcs} for sm_90a in {secs:.1f}s", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # mamba2-130m's (P, N) = (64, 128), then the reduced presets' (64, 64),
    # the width-256 instance and smoke()'s (16, 16)
    for (p, n), (i, launch) in itertools.product(((64, 128), (64, 64), (64, 256), (16, 16)),
                                                 enumerate(ssd.LAUNCHES)):
        smem_src = build.library("ssd_scan").ssd_scan_smem_bytes(i, p, n)
        smem_py = MemoryPlanner.smem_footprint(ssd.smem_blocks(launch, p, n))
        print(f"[build] ssd_scan P={p} N={n} (instance {ssd.instance(p, n, 1, 1)}) launch "
              f"{i} ({launch}) dynamic shared memory {smem_src} B per CTA (check_smem "
              f"working set {smem_py} B)")
        if smem_src != smem_py:
            raise AssertionError(f"ssd_scan.smem_blocks({launch!r}, {p}, {n}) disagrees "
                                 "with csrc ssd_scan_smem_bytes")
    for d, (dt, code) in itertools.product((16, 64, 80, 128, 160, 256),
                                           fa.DTYPE_CODES.items()):
        smem_src = build.library("flash_attention").flash_attention_smem_bytes(d, code)
        smem_py = MemoryPlanner.smem_footprint(fa.smem_blocks(d, dt))
        static = dt == torch.float32 and fa.instance(d) < fa.WIDE
        print(f"[build] flash_attention D={d} (instance {fa.instance(d)}) {dt} shared "
              f"memory {smem_src} B per CTA ({'static' if static else 'dynamic'}; "
              f"check_smem working set {smem_py} B)")
        if smem_src != smem_py:
            raise AssertionError(f"flash_attention.smem_blocks({d}, {dt}) disagrees "
                                 "with csrc flash_attention_smem_bytes")
    smem_src = build.library("rglru_scan").rglru_scan_smem_bytes()
    smem_py = MemoryPlanner.smem_footprint(rg.smem_blocks())
    print(f"[build] rglru_scan static shared memory {smem_src} B per CTA (check_smem "
          f"working set {smem_py} B)")
    if smem_src != smem_py:
        raise AssertionError("rglru_scan.smem_blocks() disagrees with csrc "
                             "rglru_scan_smem_bytes")
    # qwen2's and phi4's layouts, then mistral-nemo-12b's, chameleon-34b's and
    # starcoder2-15b's (G = 12: 44,128 B in bf16, under the 48 KB that needs
    # no opt-in; 76,896 B in f32, which opts in), then [shapes]' padded ones
    for (grp, hd), (dt, code) in itertools.product(
            ((7, 64), (3, 128), (4, 128), (8, 128), (12, 128), (4, 16), (4, 80), (4, 256)),
            pa.DTYPE_CODES.items()):
        smem_src = build.library("paged_attention").paged_attention_smem_bytes(grp, hd, code)
        smem_py = MemoryPlanner.smem_footprint(pa.smem_blocks(grp, hd, dt))
        print(f"[build] paged_attention G={grp} hd={hd} (instance {pa.instance(hd)}) {dt} "
              f"dynamic shared memory "
              f"{smem_src} B per CTA (check_smem working set {smem_py} B)")
        if smem_src != smem_py:
            raise AssertionError(f"paged_attention.smem_blocks({grp}, {hd}, {dt}) "
                                 "disagrees with csrc paged_attention_smem_bytes")

    stamp(t_start, "phase 2")
    # -- 3. kernels against their plain versions -------------------------------------
    cfg = get_config(ARCH)
    trace, live = serve_trace(cfg, torch, N_REQUESTS, SEED)
    pt = choose_page_tokens(cfg, trace).page_tokens
    cfg_p = get_config(PHI4_ARCH)
    trace_p, live_p = serve_trace(cfg_p, torch, N_REQUESTS, SEED)
    pt_p = choose_page_tokens(cfg_p, trace_p).page_tokens
    # qwen2's decode layout (2 kv heads of 7, hd 64) and phi4's (8 of 3, hd 128)
    # B=16 and 32: the batch buckets [load:qwen2] decodes at (launch.load.MAX_BATCH)
    paged, paged_worst = paged_cases(torch, ops, ref, pt, 2, 7, 64, cfg.n_layers, SEED + 1,
                                     bf16_batches=(1, 3, 8, 16, 32))
    paged128, paged128_worst = paged_cases(torch, ops, ref, pt_p, 8, 3, 128,
                                           cfg_p.n_layers, SEED + 8)
    # the untied dense decoders' layouts at hd 128, each at its own page size
    # and depth: 8 kv heads of 4, 4 of 12 (the score loop's 8 rows a pass
    # and P V's 4 leave a tail at 12) and 8 of 8
    dense_cfgs = {tag: get_config(arch) for arch, tag in DENSE_ARCHS}
    paged_dense, flash_dense = {}, {}
    for i, (tag, c) in enumerate(dense_cfgs.items()):
        pt_d = choose_page_tokens(c, serve_trace(c, torch, N_REQUESTS, SEED)[0]).page_tokens
        paged_dense[tag] = paged_cases(torch, ops, ref, pt_d, c.n_kv_heads,
                                       c.n_heads // c.n_kv_heads, c.resolved_head_dim,
                                       c.n_layers, SEED + 20 + i)
    stamp(t_start, "[paged]")
    # qwen2's layout (14 heads over 2, D=64) at the padding ladder's shapes,
    # one sliding window and one offset; recurrentgemma's local attention
    # (16 heads over 1, D=256, window 2048) short of the window and past it
    flash, flash_worst = flash_cases(torch, ops, ref, 14, 2, 64, [
        *(("bfloat16", sq, 0, 0) for sq in (8, 37, 512, 1024)),
        ("bfloat16", 512, 128, 0), ("bfloat16", 64, 0, 512), ("float32", 512, 0, 0)],
        SEED + 2)
    # phi4's layout (24 heads over 8, D=128) at the same shapes, both dtypes
    flash128, flash128_worst = flash_cases(torch, ops, ref, 24, 8, 128, [
        *((dt, sq, w, off) for dt in ("bfloat16", "float32")
          for sq, w, off in ((37, 0, 0), (256, 0, 0), (512, 0, 0), (1024, 0, 0),
                             (512, 128, 0), (64, 0, 512)))], SEED + 9)
    # the untied dense decoders' layouts: 32 heads over 8, 48 over 4, 64 over 8
    for i, (tag, c) in enumerate(dense_cfgs.items()):
        flash_dense[tag] = flash_cases(torch, ops, ref, c.n_heads, c.n_kv_heads,
                                       c.resolved_head_dim, [
            (dt, sq, 0, 0) for dt in ("bfloat16", "float32") for sq in (37, 512, 1024)],
            SEED + 30 + i)
    # the MoE decoders' layouts: granite-moe's 16 heads over 8 at D=64 (G = 2)
    # and qwen3-moe's 32 over 4 at D=128 (G = 8), at the unpadded prompt
    # lengths they prefill at, an odd one of the serving trace among them
    moe_cfgs = {tag: get_config(arch) for arch, tag in MOE_ARCHS}
    odd = next(r.prompt_len for r in trace if r.prompt_len % 2)
    flash_moe = {}
    for i, (tag, c) in enumerate(moe_cfgs.items()):
        flash_moe[tag] = flash_cases(torch, ops, ref, c.n_heads, c.n_kv_heads,
                                     c.resolved_head_dim, [
            (dt, sq, 0, 0) for dt in ("bfloat16", "float32") for sq in (37, odd, 512, 1024)],
            SEED + 50 + i)
    # whisper-small's layout (12 heads over 12, D=64, G = 1): the encoder's
    # non-causal attention over its 1500 frames at B=1 and at the served
    # batch, and the decoder's causal one at the prompt and the text context
    flash_whisper, flash_whisper_worst = flash_cases(torch, ops, ref, 12, 12, 64, [
        *((dt, 1500, 0, 0, False, bb) for dt in ("bfloat16", "float32")
          for bb in (1, WHISPER_BATCH)),
        *((dt, sq, 0, 0, True, WHISPER_BATCH) for dt in ("bfloat16", "float32")
          for sq in (WHISPER_PROMPT, WHISPER_MAX_LEN))], SEED + 70, iters=10)
    flash_wide, flash_wide_worst = flash_cases(torch, ops, ref, 16, 1, 256, [
        *((dt, sq, 2048, 0) for dt in ("bfloat16", "float32") for sq in (37, 512, 2600)),
        ("bfloat16", 64, 2048, 2500)], SEED + 6, iters=10)
    stamp(t_start, "[flash]")
    moe_cases(torch, moe_lib, moe_cfgs)
    stamp(t_start, "[moe]")
    ssd_res, ssd_worst = ssd_cases(torch, ops, ssd, ssm, ref)
    stamp(t_start, "[ssd]")
    rglru, rglru_worst = rglru_cases(torch, ops, rg, ref,
                                     ptxas_summary(build.BUILD_LOG.get("rglru_scan", "")))

    stamp(t_start, "phase 3")
    # -- [shapes]: padded instances, the serving CLI's presets, smoke() at head dim 16 --
    shapes = shapes_phase(torch, ops, ref, ssd, ssm, Transformer, RunOpts, ServeEngine, card)
    free_cuda(torch)
    stamp(t_start, "[shapes]")
    # -- 4. the qwen2 path: full-width qwen2-0.5b, paged decode, flash prefill -------
    model, params = load_model(torch, Transformer, cfg, RunOpts(attention_impl="kernel"),
                               SEED, "qwen2")
    qwen2_run = graph_ab(torch, ops, lambda graphs: ServeEngine(
        model, params, sample_trace=trace, max_len=MAX_LEN, max_batch=MAX_BATCH,
        attn_mode="paged", graphs=graphs), live, lambda steps, prefills: {
        "flash_attention": cfg.n_layers * prefills,
        "paged_attention": cfg.n_layers * steps, "ssd_scan": 0,
        "rglru_scan": 0}, card, "qwen2")
    qwen2 = qwen2_run["launches"]
    stamp(t_start, "[graph:qwen2]")
    churn = churn_phase(torch, ops, cfg, model, params, card)
    stamp(t_start, "[serve:churn]")
    shared = shared_phase(torch, ops, cfg, model, params, card)
    stamp(t_start, "[serve:shared]")
    load_q = load_phase(torch, ops, cfg, model, params, "qwen2-burst-tight", "qwen2",
                        lambda steps, prefills: {
                            "flash_attention": cfg.n_layers * prefills,
                            "paged_attention": cfg.n_layers * steps, "ssd_scan": 0,
                            "rglru_scan": 0}, card)
    if load_q["preemptions"] + load_q["reopts"] == 0:
        raise AssertionError("load:qwen2: the tight pool never bit (no preemption, "
                             "no replan)")
    stamp(t_start, "[load:qwen2]")
    del model, params
    same_streams(torch, cfg.with_overrides(n_layers=2, dtype="float32"),
                 [(RunOpts(attention_impl="kernel"), "paged"),
                  (RunOpts(attention_impl="full"), "gather")],
                 Transformer, ServeEngine, "paged+kernels vs gather+plain")
    stamp(t_start, "[serve:qwen2]")
    # -- the phi4 path: full-width phi4-mini-3.8b, head_dim 128, the same trace ------
    model, params = load_model(torch, Transformer, cfg_p, RunOpts(attention_impl="kernel"),
                               SEED, "phi4")
    phi4 = graph_ab(torch, ops, lambda graphs: ServeEngine(
        model, params, sample_trace=trace_p, max_len=MAX_LEN, max_batch=MAX_BATCH,
        attn_mode="paged", graphs=graphs), live_p, lambda steps, prefills: {
        "flash_attention": cfg_p.n_layers * prefills,
        "paged_attention": cfg_p.n_layers * steps, "ssd_scan": 0,
        "rglru_scan": 0}, card, "phi4")["launches"]
    del model, params
    same_streams(torch, cfg_p.with_overrides(n_layers=2, dtype="float32"),
                 [(RunOpts(attention_impl="kernel"), "paged"),
                  (RunOpts(attention_impl="full"), "gather")],
                 Transformer, ServeEngine, "paged+kernels vs gather+plain")
    stamp(t_start, "[serve:phi4]")
    # -- the untied dense decoders at full width and depth, one at a time ----------
    dense = {}
    for arch, tag in DENSE_ARCHS:
        dense[tag] = dense_phase(torch, ops, Transformer, RunOpts, ServeEngine, arch, tag,
                                 card)["launches"]
        stamp(t_start, f"[serve:{tag}]")
    # -- the MoE decoders at full width and depth, gather decode, flash prefill ------
    moe_runs = {}
    for arch, tag in MOE_ARCHS:
        moe_runs[tag] = dense_phase(torch, ops, Transformer, RunOpts, ServeEngine, arch,
                                    tag, card, mode="gather",
                                    on_cpu=tag == "granite-moe")["launches"]
        stamp(t_start, f"[serve:{tag}]")
    moe_b16 = moe_b16_phase(torch, ops, moe_lib, Transformer, RunOpts, ServeEngine,
                            card)["launches"]
    stamp(t_start, "[serve:granite-moe:b16]")
    # -- the encoder-decoder: full-width, full-depth whisper-small through serve_lib --
    whisper = whisper_phase(torch, ops, Transformer, RunOpts, card)
    stamp(t_start, "[serve:whisper]")

    stamp(t_start, "phase 4")
    # -- 5. the mamba2 path: full-width mamba2-130m, gather decode, SSD prefill -------
    cfg_m = get_config(SSM_ARCH)
    trace_m, live_m = serve_trace(cfg_m, torch, N_REQUESTS, SEED)
    model, params = load_model(torch, Transformer, cfg_m, RunOpts(use_kernels=True),
                               SEED, "mamba2")
    mamba2 = graph_ab(torch, ops, lambda graphs: ServeEngine(
        model, params, sample_trace=trace_m, max_len=MAX_LEN, max_batch=MAX_BATCH,
        attn_mode="gather", graphs=graphs), live_m, lambda steps, prefills: {
        "flash_attention": 0, "paged_attention": 0,
        "ssd_scan": cfg_m.n_layers * prefills, "rglru_scan": 0}, card,
        "mamba2")["launches"]
    stamp(t_start, "[serve:mamba2]")
    # the diurnal load cell reuses the loaded mamba2 weights, so it runs here,
    # after the mamba2 serving path, and not beside [load:qwen2]
    load_m = load_phase(torch, ops, cfg_m, model, params, "mamba2-diurnal-tight", "mamba2",
                        lambda steps, prefills: {
                            "flash_attention": 0, "paged_attention": 0,
                            "ssd_scan": cfg_m.n_layers * prefills, "rglru_scan": 0}, card)
    stamp(t_start, "[load:mamba2]")
    del model, params
    same_streams(torch, cfg_m.with_overrides(n_layers=2, dtype="float32"),
                 [(RunOpts(use_kernels=True), "gather"),
                  (RunOpts(use_kernels=False), "gather")],
                 Transformer, ServeEngine, "SSD kernel vs plain prefill")
    stamp(t_start, "mamba2 token streams")
    model, params = load_model(torch, Transformer, cfg_m, RunOpts(), SEED + 5,
                               "mamba2 forward check")
    check_forward(torch, cfg_m, Transformer, params, torch.randint(
        0, cfg_m.vocab_size, (2, 300), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 5)),
        RunOpts(use_kernels=True), RunOpts(use_kernels=False),
        RunOpts(use_kernels=False, ssd_chunk=64),
        "against plain chunk 256, yardstick plain chunk 64")
    del model, params

    stamp(t_start, "phase 5")
    # -- 6. the recurrentgemma path: full-width recurrentgemma-9b, gather decode,
    #       RG-LRU kernel in rec prefill, D=256 flash kernel in local prefill ---------
    cfg_r = get_config(HYBRID_ARCH)
    long_rids = (4, 9)
    trace_r, live_r = serve_trace(cfg_r, torch, N_REQUESTS, SEED, long_rids)
    print(f"[serve:rgemma] prompts {[r.prompt_len for r in trace_r]} against a "
          f"{cfg_r.local_window}-token window", flush=True)
    kinds = layer_kinds(cfg_r)
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    model, params = load_model(torch, Transformer, cfg_r, RunOpts(), SEED, "rgemma")
    rgemma = graph_ab(torch, ops, lambda graphs: ServeEngine(
        model, params, sample_trace=trace_r, max_len=HYBRID_MAX_LEN, max_batch=MAX_BATCH,
        attn_mode="gather", graphs=graphs), live_r, lambda steps, prefills: {
        "flash_attention": n_local * prefills, "paged_attention": 0,
        "ssd_scan": 0, "rglru_scan": n_rec * prefills}, card, "rgemma")["launches"]
    stamp(t_start, "[serve:rgemma]")
    free_cuda(torch)
    # the random-weight stack is chaotic: rounding flips grow with depth until
    # even the yardstick moves most argmaxes, so the limit holds at one group
    # and the tail (every kind of layer, the window acting) and the full
    # depth is read only.  The yardstick re-blocks the plain scan by 1 step,
    # which changes about as large a share of its f32 outputs as the
    # kernel's segmented order does (the [rglru] calibration line prints
    # both); the gates make a ~ e^-5, so only the last few steps carry and
    # coarser blocks leave most sums in the same order.
    tokens = torch.randint(0, cfg_r.vocab_size, (1, 2600), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    plain = RunOpts(attention_impl="plain", use_kernels=False)
    for groups, hold in ((1, True), (cfg_r.n_pattern_groups, False)):
        cfg_g, params_g = first_groups(cfg_r, params, groups)
        check_forward(torch, cfg_g, Transformer, params_g, tokens, RunOpts(), plain,
                      RunOpts(attention_impl="plain", use_kernels=False, rglru_block=1),
                      "against the plain versions (RG-LRU block 256), yardstick "
                      "RG-LRU block 1", hold=hold, slack=1)
    del model, params, params_g
    free_cuda(torch)
    stamp(t_start, "recurrentgemma forward checks")
    same_streams(torch, cfg_r.with_overrides(n_layers=5, dtype="float32"),
                 [(RunOpts(), "gather"),
                  (RunOpts(attention_impl="full", use_kernels=False), "gather")],
                 Transformer, ServeEngine, "RG-LRU + flash kernels vs plain prefill",
                 max_len=HYBRID_MAX_LEN, long_rids=(2,))

    stamp(t_start, "phase 6")
    # -- 7. the training paths: qwen2-0.5b, granite-moe, then the other patterns --------
    train_q = train_phase(torch, ops, card, ARCH, "qwen2", n_layers=TRAIN_QWEN2_LAYERS)
    stamp(t_start, "phase 7 qwen2")
    train_m = train_phase(torch, ops, card, MOE_ARCHS[0][0], MOE_ARCHS[0][1],
                          n_layers=TRAIN_MOE_LAYERS, batch_hi=TRAIN_MOE_BATCH_HI)
    stamp(t_start, "phase 7 granite-moe")
    runs = [train_q, train_m]
    for arch, short, depth, b, s, hi, cut_layers in TRAIN_PATTERNS:
        runs.append(train_phase(torch, ops, card, arch, short, n_layers=depth, batch=b,
                                seq=s, batch_hi=hi, cut_layers=cut_layers))
        stamp(t_start, f"phase 7 {short}")
    train = {k: sum(r[k] for r in runs) for k in train_q}
    roofline_phase(card)
    stamp(t_start, "phase 7 roofline")
    from repro_torch.launch.roofline import HBM_BYTES
    print(f"[roofline] the card's total_memory "
          f"{torch.cuda.get_device_properties(0).total_memory} B, roofline.HBM_BYTES "
          f"{HBM_BYTES} B | {card}", flush=True)
    # -- 8. the paper's own nets at their registered sizes, then the chunked attention ------
    paper_runs = []
    for arch, short in PAPER_CNNS:
        paper_runs.append(paper_cnn_phase(torch, ops, card, arch, short))
        stamp(t_start, f"phase 8 {short}")
    paper_runs.append(paper_s2s_phase(torch, ops, card))
    stamp(t_start, "phase 8 seq2seq")
    paper = {k: sum(r[k] for r in paper_runs) for k in train_q}
    chunked = chunked_phase(torch, ops, card)
    stamp(t_start, "phase 9 chunked")
    mesh_runs = mesh_phase(torch, ops, card, qwen2_run)
    mesh = {k: mesh_runs["eager"][k] + mesh_runs["graphs"][k] for k in mesh_runs["eager"]}
    stamp(t_start, "phase 10 mesh")
    # -- 11. records -----------------------------------------------------------------------
    pk = paged[("bfloat16", MAX_BATCH)]
    pk128 = paged128[("bfloat16", MAX_BATCH)]
    fk = flash[("bfloat16", 512, 0, 0)]
    fk128 = flash128[("bfloat16", 512, 0, 0)]
    fk128l = flash128[("bfloat16", 1024, 0, 0)]
    fw = flash_wide[("bfloat16", 2600, 2048, 0)]
    sk = ssd_res[("bfloat16", 1, 512)]
    rk = rglru[(1, 512, False)]
    rk_long = rglru[(1, 2600, False)]

    def times(r, **library):
        return {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "max_abs_err": r["err"], **library}
    # the dense layouts' times; for paged decode, SDPA over a pre-gathered copy
    # is a yardstick, not a library call that reads a paged pool
    paged_layouts, flash_layouts = {}, {}
    for tag, c in dense_cfgs.items():
        lay = f"hd128_kv{c.n_kv_heads}_g{c.n_heads // c.n_kv_heads}"
        for (dt, b), r in paged_dense[tag][0].items():
            paged_layouts[f"{tag}_{lay}_b{b}_{dt}"] = times(
                r, library_ms=None, sdpa_gathered_ms=r["sdpa_ms"])
        for (dt, sq, _, _), r in flash_dense[tag][0].items():
            flash_layouts[f"{tag}_d128_h{c.n_heads}_kv{c.n_kv_heads}_sq{sq}_{dt}"] = times(
                r, library_ms=r["sdpa_ms"])
    for tag, c in moe_cfgs.items():
        for (dt, sq, _, _), r in flash_moe[tag][0].items():
            flash_layouts[f"{tag}_d{c.resolved_head_dim}_h{c.n_heads}_kv{c.n_kv_heads}"
                          f"_sq{sq}_{dt}"] = times(r, library_ms=r["sdpa_ms"])
    for (dt, sq, _, _, causal, bb), r in flash_whisper.items():
        mask = "causal" if causal else "noncausal"
        flash_layouts[f"whisper_d64_h12_kv12_b{bb}_sq{sq}_{mask}_{dt}"] = times(
            r, library_ms=r["sdpa_ms"])
    # [shapes]: the padded instances' cases and the serving paths' launches
    shape_layouts = {"flash_attention_bhsd": {}, "paged_attention_decode": {},
                     "ssd_scan_kernel": {}}
    for (d, dt, sq, window, q_off, *rest), r in shapes["flash"].items():
        mask = "noncausal" if rest and not rest[0] else f"w{window}_off{q_off}"
        shape_layouts["flash_attention_bhsd"][f"d{d}_h32_kv8_sq{sq}_{mask}_{dt}"] = times(
            r, library_ms=r["sdpa_ms"])
    for (hd, dt, b), r in shapes["paged"].items():
        shape_layouts["paged_attention_decode"][f"hd{hd}_kv8_g4_b{b}_{dt}"] = times(
            r, library_ms=None, sdpa_gathered_ms=r["sdpa_ms"])
    for (pp, nn, gg, dt, b, sl), r in shapes["ssd"].items():
        shape_layouts["ssd_scan_kernel"][f"p{pp}_n{nn}_g{gg}_h24_b{b}_s{sl}_{dt}"] = times(
            r, library_ms=None, tf32x3_bound_ms=r["tf32x3_bound_ms"])
    shapes_worst = {k: max(w["bfloat16"] for n, w in shapes["worst"].items()
                           if n.startswith(k)) for k in ("flash", "paged", "ssd")}
    sl = shapes["launches"]
    dense_paged = sum(d["paged_attention"] for d in dense.values())
    dense_flash = sum(d["flash_attention"] for d in dense.values())
    moe_flash = sum(d["flash_attention"] for d in moe_runs.values())
    kernels = [
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:76",
         "launches": (qwen2["paged_attention"] + phi4["paged_attention"] + dense_paged
                      + sl["paged_attention"]),
         "shapes_launches": {k: r["paged_attention"] for k, r in shapes["runs"].items()},
         "dense_launches": {tag: d["paged_attention"] for tag, d in dense.items()},
         "moe_launches": {tag: d["paged_attention"] for tag, d in moe_runs.items()},
         "churn_launches": churn["launches"]["paged_attention"],
         "shared_launches": shared["launches"]["paged_attention"],
         "train_launches": train["paged_attention"],
         "paper_launches": paper["paged_attention"],
         "chunked_launches": chunked["paged_attention"],
         "mesh_launches": mesh["paged_attention"],
         "mesh_graphs_launches": mesh_runs["graphs"]["paged_attention"],
         "max_abs_err": max(paged_worst["bfloat16"], paged128_worst["bfloat16"],
                            *(w["bfloat16"] for _, w in paged_dense.values()),
                            shapes_worst["paged"]),
         "ms": pk["ms"],
         "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
         "bound_by": pk["bound_by"], "library_ms": None,
         "d128_ms": pk128["ms"], "d128_plain_ms": pk128["plain_ms"],
         "d128_bound_ms": pk128["bound_ms"], "d128_library_ms": None,
         "layouts": paged_layouts,
         "shapes_layouts": shape_layouts["paged_attention_decode"]},
        {"name": "flash_attention_bhsd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73",
         "launches": (qwen2["flash_attention"] + phi4["flash_attention"]
                      + rgemma["flash_attention"] + dense_flash + moe_flash
                      + whisper["flash_attention"] + sl["flash_attention"]),
         "shapes_launches": {k: r["flash_attention"] for k, r in shapes["runs"].items()},
         "whisper_launches": whisper["flash_attention"],
         "dense_launches": {tag: d["flash_attention"] for tag, d in dense.items()},
         "moe_launches": {tag: d["flash_attention"] for tag, d in moe_runs.items()},
         "moe_b16_launches": moe_b16["flash_attention"],
         "churn_launches": churn["launches"]["flash_attention"],
         "shared_launches": shared["launches"]["flash_attention"],
         "train_launches": train["flash_attention"],
         "paper_launches": paper["flash_attention"],
         "chunked_launches": chunked["flash_attention"],
         "mesh_launches": mesh["flash_attention"],
         "mesh_graphs_launches": mesh_runs["graphs"]["flash_attention"],
         "max_abs_err": max(flash_worst["bfloat16"], flash128_worst["bfloat16"],
                            flash_wide_worst["bfloat16"],
                            *(w["bfloat16"] for _, w in flash_dense.values()),
                            *(w["bfloat16"] for _, w in flash_moe.values()),
                            flash_whisper_worst["bfloat16"], shapes_worst["flash"]),
         "ms": fk["ms"],
         "plain_ms": fk["plain_ms"], "bound_ms": fk["bound_ms"],
         "bound_by": fk["bound_by"], "library_ms": fk["sdpa_ms"],
         "d128_sq512_ms": fk128["ms"], "d128_sq512_plain_ms": fk128["plain_ms"],
         "d128_sq512_bound_ms": fk128["bound_ms"],
         "d128_sq512_library_ms": fk128["sdpa_ms"],
         "d128_sq1024_ms": fk128l["ms"], "d128_sq1024_bound_ms": fk128l["bound_ms"],
         "d128_sq1024_library_ms": fk128l["sdpa_ms"],
         "d256_sq2600_ms": fw["ms"], "d256_sq2600_bound_ms": fw["bound_ms"],
         "d256_sq2600_library_ms": fw["sdpa_ms"],
         "layouts": flash_layouts,
         "shapes_layouts": shape_layouts["flash_attention_bhsd"]},
        {"name": "ssd_scan_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:64",
         "launches": mamba2["ssd_scan"] + sl["ssd_scan"],
         "shapes_launches": {k: r["ssd_scan"] for k, r in shapes["runs"].items()},
         "train_launches": train["ssd_scan"],
         "paper_launches": paper["ssd_scan"], "chunked_launches": chunked["ssd_scan"],
         "mesh_launches": mesh["ssd_scan"],
         "mesh_graphs_launches": mesh_runs["graphs"]["ssd_scan"],
         "max_abs_err": max(ssd_worst["bfloat16"], shapes_worst["ssd"]), "ms": sk["ms"],
         "plain_ms": sk["plain_ms"], "bound_ms": sk["bound_ms"],
         "bound_by": sk["bound_by"], "library_ms": None,
         "tf32x3_bound_ms": sk["tf32x3_bound_ms"],
         "shapes_layouts": shape_layouts["ssd_scan_kernel"]},
        {"name": "rglru_scan_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:40",
         "launches": rgemma["rglru_scan"], "train_launches": train["rglru_scan"],
         "paper_launches": paper["rglru_scan"], "chunked_launches": chunked["rglru_scan"],
         "mesh_launches": mesh["rglru_scan"],
         "mesh_graphs_launches": mesh_runs["graphs"]["rglru_scan"],
         "max_abs_err": rglru_worst, "ms": rk["ms"],
         "plain_ms": rk["plain_ms"], "bound_ms": rk["bound_ms"],
         "bound_by": rk["bound_by"], "library_ms": None,
         "s2600_ms": rk_long["ms"], "s2600_bound_ms": rk_long["bound_ms"]},
    ]
    print(f"[load] launches {json.dumps({'qwen2': load_q['launches'], 'mamba2': load_m['launches']})}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
