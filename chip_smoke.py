#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: the eight CUDA kernel sources compiled by nvcc from
   ``src/repro_torch/csrc``, one nvcc per source, all started together;
   ptxas's report per kernel (the paged kernel's D=128 instantiations,
   bf16 and fp32, must be among them, and every D=192 one: flash_tc,
   flash_wide, paged and decode_wide in their dtypes), and no spill in the
   WKV6 kernels (forward and backward), the RG-LRU kernels (forward and
   backward), the wide-head decode kernel, the paged kernel at D=128, any
   D=192 instantiation or the flash backward's kernels (the fp32 D=256
   wide kernels' two instantiations must be reported); ``cuobjdump -sass``
   of the flash library must show HGMMA (Hopper's tensor-core product) in
   the bf16 kernel at every head width, that of the flash backward in both
   bf16 tensor-core kernels at every width of ``HEAD_DIMS_BWD_TC`` (16,
   32, 64 one warpgroup a block; 256 the two-warpgroup kernels), and the
   RG-LRU kernel's fp64 instructions (its exp(2a) near 0) are counted.
3. Kernels against their plain PyTorch versions on the card: flash prefill
   at Qwen1.5-0.5B's heads (B=8, S in {128, 512}, bf16 and fp32), at ragged
   GQA/window shapes (D=32 and 64 with windows, D=16 under MQA), at S=1,
   at head widths 128 and 256 (MQA and GQA, G=3 that does not divide the
   block, ragged S, a window shorter than S), and at RecurrentGemma-9B's
   prefill shape (B=4, S=3072, H=16 on Hk=1, D=256, window 2048) and at
   Qwen3-30B-A3B's (B=8, S=256, H=32 on Hk=4, D=128), at head width 192
   (Nemotron-4-340B's) with G in {1, 12} and S in {1, 37, 256}, every
   case in bf16 (the tensor-core kernel) and most in fp32 (the CUDA-core
   kernels) too; paged decode at B=8, page 16 with shared pages,
   a forked page, sentinel columns and one all-sentinel (retired) row, at
   G=1 and under GQA (G in {2, 4, 8}) and MQA (G=16), and at D=128
   (Qwen1.5-4B's 20 heads at G=1, G in {2, 8}, and Qwen3-30B-A3B's 32
   heads on 4) and D=192 (Nemotron-4-340B's 96 heads on 8); every flash
   and paged case launched twice for identical bits;
   contiguous decode at B=8, H=Hk=16, D=64 with ragged lengths (0 and Smax
   included) on a horizon view of a longer cache, a GQA case, and G=16 at
   head widths 128 and 256 (a 2,048-slot ring among them); both D <= 64
   decode kernels at their design's edges, bf16 and fp32, D=64 at
   G in {1, 2, 4, 8, 16}, D=32 at G=3 and D=16: lengths 0, 1 and page-1,
   warps left empty, each warp-range and sub-tile boundary ±1, exactly the
   cache's capacity and past it, a retired row and a row whose table has a
   hole of sentinel pages under two warps' ranges, and the paged kernel
   alone at D=128, G in {1, 2, 8}, and at D=192, G in {1, 12}, on the
   same edges; the wide-head decode kernel (D in {128, 256},
   bf16 and fp32) at G in {1, 8, 16, 20}, and at D=192 with G in {1, 12},
   on caches of 2,048 and 100 positions with lengths 0, 1, a piece ± 1, the
   whole cache and past it, each launched twice, and at Nemotron-4-340B's
   96 heads on 8 (ragged lengths); WKV6 at H=40, D=64, T in
   {1, 31, 32, 33, 37, 512} (the step, a chunk ± 1 and a short last chunk),
   bf16 and fp32, with a carried state and decays from RWKV6's own range,
   U(1e-12, 1) with a sixteenth at 1e-12, and exp(−exp(U(−6, 3.32))) (as
   many near 1 as near 1e-12, mixed within a chunk), at B=4 and at B·H = 5
   (fewer chunk blocks than SMs, so the chain across chunks runs with no
   other work beside it), and at D=16 and 32; the fp32 ones also held
   against the token-by-token oracle (the plain version's own distance from
   it printed beside); the RG-LRU scan at
   W=4096, T in {1, 37, 3072}, and at W=200 (a part-empty block) with T at
   the chunk blocks' edges (one, two and three chunks ± 1), bf16 and fp32,
   with a carried state and log-gates mild, strong (down to −20) and within
   1e-6 of 0, the fp32 ones also held against the token-by-token oracle, and
   each launched twice (the chain's scratch is left zeroed, so the second
   launch must give the same bits); the flash backward (dq, dk, dv) at
   D in {16, 32, 64}, G in {1, 2, 4}, S in {1, 37, 128, 512}, with a
   window shorter than S, and with B·H·ceil(S/64) below and above the SM
   count, bf16 and fp32, each gradient held row by row (fp32 1e-4, bf16
   2e-2) and each case launched twice with identical bits; flash without
   the causal mask at Sq = Skv in {1, 37, 1,536} (an encoder) and at Sq in
   {1, 37, 64} against Skv in {37, 1,536}, causal (the ends aligned) and
   not (a cross-attention), at D in {64, 128} and G in {1, 8}, bf16 and
   fp32, each launched twice for identical bits; decode over a cross
   cache of 1,536 frames at lengths 1, 1,535 and 1,536, launched twice;
   the flash backward at D=256 with G in {1, 16}, S in {1, 37, 256} and S
   = 300 past a window of 64, S = 130 with a window of 50 (ending inside a
   64-key tile), G = 3 (split 1 + 2 over a cluster of two dkdv blocks),
   and in bf16 at path o's shape (2, 3072, 16 on 1, window 2048); the
   WKV6 backward at D in {16, 32, 64}, T in
   {1, 31, 32, 33} and at RWKV6-3B's (4, 512, 40, 64), decays from 1e-12
   to 1 in one chunk and RWKV6's own, with and without a state and the
   final state's gradient; the RG-LRU backward at T in {1, 15, 16, 17}
   (W=200) and at RecurrentGemma-9B's (2, 3072, 4096), gates mild, strong
   and within 1e-6 of 0; each backward case in bf16 and fp32, launched
   twice for identical bits, every gradient held row by row (fp32 1e-4,
   bf16 2e-2).
4. Sixteen main paths, each driven with every launch count set to 0 just
   before it and read just after; on each, every kernel it runs must have
   launched, no plain version may see a CUDA tensor, and the kernels'
   autograd nodes (``FlashAttention``, ``WKV6``, ``RGLRU``) are built on
   the training paths only.  Each path runs as
   the port runs it, every fused decode dispatch one CUDA-graph replay
   (``serving/graphs.py``: a key's first dispatch eager, the next captured),
   and then again on the same inputs through the eager body (the graphs'
   ``run`` set to call the body), where the kernels' inputs are recorded:
   a. paged serving: Qwen1.5-0.5B at full width in bf16, cut to its first
      12 of 24 layers for the script's time (``PATH_A_LAYERS``), random
      weights from the port's seeded ``Model.init``, 16 batch-prompted
      requests through ``ServingEngine(paged=True)`` (flash prefill, paged
      decode);
   b. contiguous serving: the same model and requests through
      ``ServingEngine(paged=False)`` (flash prefill, contiguous decode);
   c. full-width RWKV6-3B in bf16, random weights: ``Model.prefill`` of 4
      prompts of 512 token ids, then 32 greedy steps through
      ``RecurrentDecoder``, 8 a replay (WKV6 at every layer of every step,
      at least 32 × 33 launches);
   d. full-width RecurrentGemma-9B in bf16 (38 layers, 10.445 B
      parameters), random weights: ``Model.prefill`` of 4 prompts of 3,072
      token ids into caches of max_len 4,096 (2,048-slot rings), then 32
      greedy steps the same way, writing into the wrapped rings: exactly
      26 × 33 RG-LRU, 12 flash and 12 × 32 decode-attention launches;
   e. paged serving of Qwen1.5-4B at full width in bf16 (20 heads of 128),
      cut to its first 16 of 40 layers (``PATH_E_LAYERS``; paths g and the
      fp32 parity take the same cut), as path a serves Qwen1.5-0.5B: the
      paged kernel at D=128;
   f. speculative decoding (``SpeculativeEngine``, paged, K = 4 drafts a
      round, every draft and verify dispatch one graph replay) of the
      half-sampled workload in bf16, Qwen1.5-0.5B at full width cut to its
      first 8 of 24 layers (``PATH_F_LAYERS``) drafting for itself (the
      same weights: the accept-all case) and for Qwen1.5-4B at full width
      cut to 10 of its 40 layers (the reject-most case): graphed against
      eager (streams, counters, launches identical), paged launches =
      rounds × (K+1) × (draft + target layers), the accepted, bonus and
      mismatch tokens counted again from the dispatches' outputs adding
      up to the tokens emitted, and ``decode_span`` bit-equal to K+1
      ``decode_step``s (checked);
      against the target alone the streams are printed, unchecked, with the
      target's top-2 logit gap at each first differing token, and tokens/s
      of both timed in turns.  ``SpanProbe`` prints, unchecked, which
      operator a one-pass verify (one product over the 8·(K+1) rows) would
      round otherwise than the steps: on a random span, and for the
      self-draft in the workload itself, with a one-pass verify's accept
      rate and streams.
   g. RoBatch's control plane over a live pool: ``Gateway`` over two
      ``ServedPoolMember``s of the paths' engines (paged, page 16, graphed,
      max_len 1024), full-width Qwen1.5-0.5B priced as the tiny pool's
      ``tiny-s`` ($0.1/$0.4 per 1M tokens in/out) and path e's
      Qwen1.5-4B as ``tiny-l`` ($0.8/$3.2), on the tiny pool's addition
      task (32 train, 32 test queries), each model's output head cut to the
      byte tokenizer's ids and each answer judged by ``parity_judge`` (random
      weights answer no sum right).  ``fit()`` with the MLP router on the
      card, coreset 8, ``grid_multiple`` 2 (stages timed); ``submit()`` at
      two budgets (the plan within each, its groups the invocations, the
      exact cost equal to the engines' tokens times the prices, every
      utility the judge's verdict on the parsed answers); ``serve()`` of
      Poisson arrivals (8 qps, 6 s virtual, windows of 0.5 s, a fifth
      repeats) through the ``robatch`` policy, the two members dispatched
      on two threads at once (every capture on its set's own stream):
      completed + shed = arrivals, repeats hit the cache, every breaker
      closed, a window dispatched to both members and their invocations
      overlapping in time; the scheduler's router, proxy and greedy time a
      window beside the rest of it, and one window traced (busy share).
      Paged launches = decode dispatches × K × layers and flash launches =
      prefills × layers, summed over the two engines; the first eager flash
      and paged call at each head width (64 and 128) is recorded and held
      against the plain version; one group of each member served again
      gives the same greedy tokens.
   h. training on the card, in four parts, each its own main path:
      h1, full-width Qwen1.5-0.5B in bf16 trained 12 steps of 8 x 512
      tokens (``Trainer``, ``ShardedPipeline`` over ``synthetic_lm_stream``,
      AdamW with the cosine schedule, a checkpoint after step 12): finite
      losses and grad norms, the last 3 losses' mean below the first, flash
      forward and backward launched 12 x 24 times each, a fresh ``Trainer``
      restoring step 12 bit for bit; step times in turns against
      ``remat="block"``, peak memory and one traced step (busy share, the
      backward's share); h2, tiny-m in fp32 trained 3 steps through the
      kernels and through the plain versions (losses within 1e-5 relative,
      step-1 gradients within 1e-4 row-relative) and microbatches 4 against
      1 (1e-4); h3, the tiny pool trained on the card (``build_tiny_pool``,
      300 steps a member; backward launches = steps x layers), then
      ``Gateway.fit`` with the MLP router and ``submit()`` at two budgets
      judged by the task's own judge (plan within budget, invocations =
      groups, exact cost = tokens x prices), with the exact cost over the
      plan's estimate and each member's accuracy at b=1 and at its b_effect
      printed; h4, ``Gateway.serve_http`` over that pool on loopback:
      ``/v1/models``, ``/healthz``, four unary completions equal to
      ``Gateway.serve``'s in-process bodies, a stream equal to its unary
      twin, ``/metrics`` parsed with its request counters equal to the
      requests sent, and a clean ``stop()``.
   i. paged serving of full-width Qwen3-30B-A3B in bf16 (48 layers, 32
      heads on 4 KV heads of 128, QK-norm, 128 experts top-8 of width 768,
      30.53 B parameters by the model's own count, 61.1 GB), random
      weights drawn on the card, as path e (path a's workload; the flash
      and paged kernels at D=128, G=8), with turns of two serves a leg
      and no eager dispatch trace but the MoE split's below (an eager
      serve takes ~20-30 s here); launches exactly prefills x 48
      flash and dispatches x 8 x 48 paged, the final caches bit-equal
      graphed against eager; the (token, expert) pairs layer 0 of the
      first prefill drops (printed), a graphed step against the bound of
      reading every weight but the embedding, and one eager dispatch
      traced with the MoE layers and their expert products in
      ``record_function`` ranges (their share of the device time).
   i2. full-width Qwen1.5-MoE-A2.7B in bf16 (24 layers, 60 experts top-4
      and a gated shared expert, QKV bias, 28.6 GB): 8 requests prefilled
      and 32 greedy steps (4 dispatches) through the graphs and again
      eagerly: identical tokens, final caches and launches.
   j. paged serving of full-width StableLM-2-1.6B in bf16 (24 layers,
      d_model 2048, 32 heads of 64 with a quarter of each rotated,
      LayerNorm, SwiGLU, 1.644 B parameters, 3.29 GB) as path i serves
      Qwen3-30B-A3B: launches exactly prefills x 24 flash and dispatches
      x 8 x 24 paged, final caches bit-equal graphed against eager, a
      graphed step against the bound of every weight but the embedding
      (2.878 GB), one graphed dispatch traced (busy share).
   k. Nemotron-4-340B at full width (d_model 18,432, 96 heads on 8 KV
      heads of 192, half of each rotated, LayerNorm, squared-ReLU MLP of
      73,728), its first 4 of 96 layers (23.25 B parameters, 46.5 GB),
      every earlier model freed first (memory before the init and the
      peak printed): 8 requests prefilled and 32 greedy steps paged,
      graphed against eager (tokens, launches: prefills x 4 flash and
      dispatches x 8 x 4 paged, final caches), a graphed step clocked
      against its bound (37.07 GB) with one dispatch traced, and a
      contiguous leg of 16 steps (the decode kernel at D=192) graphed
      against eager, its streams printed beside the paged ones.
   l. SeamlessM4T-large-v2 at full width and depth (24 encoder and 24
      decoder layers, d_model 1,024, 16 heads of 64, LayerNorm, GELU,
      vocab 256,206 padded to 256,224; 1.632 B parameters, 3.26 GB): 8
      requests of 1,536 stub frame embeddings and a 40-64-token prompt
      right-padded to 64, ``Model.prefill(enc_inputs=, lengths=)`` then 32
      greedy steps through ``RecurrentDecoder`` (the cross K/V in its flat
      cache), graphed against eager (tokens, launches, final caches bit for
      bit); every prefill exactly 24 encoder (not causal, 1,536 x 1,536),
      24 self (causal, 64 x 64) and 24 cross (64 x 1,536) flash calls,
      every step 24 self and 24 cross decode calls; a graphed step clocked
      in turns against its bound (the decoder's weights, the head and the
      cross K/V) and one replay traced.
   m. Qwen2-VL-72B's first 8 of 80 layers at full width (d_model 8,192, 64
      heads on 8 KV heads of 128, M-RoPE sections (16, 24, 24), QKV bias;
      9.51 B parameters, 19.0 GB): ``Model.forward`` of 8 stub sequences
      of patch and text embeddings (16 text, a 16 x 16 image grid, 32 text)
      with their M-RoPE ids (one flash launch a layer, the first held
      against its plain version), then 8 text requests served paged (32
      steps) and contiguous (16 steps), graphed against eager (tokens,
      launches, caches), and a graphed paged step clocked against its bound
      (every weight but the embedding) with one dispatch traced.
   n. training full-width RWKV6-3B at full depth (32 layers, 3.09 B
      parameters) in bf16, 12 steps of 4 x 512 tokens as h1 trains
      (``remat="none"``, one checkpoint after the last step): WKV6 forward
      and backward launched exactly 12 x 32 times each, as many ``WKV6``
      nodes, finite losses whose last 3 average below every loss before
      them (AdamW's cosine schedule to 3e-4 after 2 steps); a fresh ``Trainer`` restoring the checkpoint
      into its fresh state, bit for bit against the live one; one step
      under ``"none"`` and one under ``"block"`` (the forward launched
      twice a layer), each timed with its peak memory, and one traced step.
   o. the same for RecurrentGemma-9B's first 3 of 38 layers at full width
      (one (rglru, rglru, local) group, 2.75 B parameters), 8 steps of 2 x
      3,072 tokens (past the 2,048 window): RG-LRU forward and backward 2
      a step, flash forward and its backward at D=256 one a step.
   Graphed against eager, each path a-e, i and j must give identical streams and
   launches (serving: also identical engine counters and
   ``kv_occupancy()``); the final caches are compared bit for bit and any
   difference printed.  Serving paths time tokens/s of both in turns
   (eager, graphed, graphed, eager, eager, graphed) and trace one whole
   serve of each, for the card's busy share and a count of the decode
   kernel by name against the wrapper's (at most the wrapper's and at
   least one: CUPTI loses records of a long trace, and the records kept
   are printed); paths c and d time a step of both
   in turns, trace 8 eager steps and one replay (busy share a step), and
   count the replay's kernels by name.  The serving paths also serve phase
   6's half-sampled workload in bf16 at K = 1 on 4 slots and at K = 8 on 8
   and print, unchecked, how many streams agree, with the top-2 logit gap
   at each first differing token: other admission batches give the
   prefill other shapes, and bf16 rounds differently with them; beside it,
   whether each operator of a step gives a row the same bits in batches of
   4 and 8 rows.
   Every bf16 flash, decode and paged case of phase 3 and the flash,
   paged, decode and D=256 main-path entries are held row by row as well:
   the error of each output row over the row's largest plain value.  Each
   kernel is then timed, and held against its plain version, on inputs
   recorded from its path (the shapes the main path gives it): CUDA-event
   times after a writing flush, then, after every event timing of the run,
   each kernel's CUPTI device time a call (summed over the call's kernels)
   after a reading flush, and the same for each row's library call (every
   kernel that SDPA runs).
5. Parity in fp32, kernels against plain versions, through the graphs: both
   serving paths (prefill logits within 1e-3, identical greedy streams),
   RWKV6-3B and RecurrentGemma-9B at full depth (prefill logits within
   1e-3, identical greedy streams over 32 steps).
6. Sampled serving, full-width Qwen1.5-0.5B in fp32, paged and contiguous:
   16 requests, half sampled (temperature 0.8, top-k 50, top-p 0.95,
   seeds of their own), half greedy; streams identical at K = 8 and 1, at
   8 slots and 4, graphed and eager.  The port's threefry bits on the card
   equal the same call's on the CPU; the sampling's time a step at (8,
   151,936), eager and as one replay; and 16,384 draws of one row of
   151,936 logits fit the filtered softmax (chi-square under its 1e-6
   tail, no draw outside the kept ranks).
7. Path e in fp32 (prefill logits within 1e-3 of the plain versions',
   identical greedy streams), and path f in fp32: both pairs' streams of
   the half-sampled workload identical to the target alone's, and the
   random span's ``SpanProbe`` report in fp32.  Then path i in fp32 at
   full width, cut to its first 4 of 48 layers (prefill logits within
   1e-3 of the plain versions', identical greedy streams), path j in fp32
   at full width and path k in fp32 on its first layer at full width
   (51.6 GB), the same way, paged and contiguous, its two layouts' greedy
   streams identical; path l in fp32 at full width and depth (prefill
   logits within 1e-3, identical greedy streams) and path m's forward in
   fp32 on Qwen2-VL-72B's first layer at full width (logits within 1e-3);
   the recurrent paths' parity of phase 5; and paths n and o narrowed in
   fp32 (RWKV6-3B at d_model 256, 2 layers, 2 x 512 tokens; the hybrid at
   d_model 512, one group, head width 256, 2 x 2,100 tokens past its
   window), trained 3 steps through the kernels and again through the
   plain versions: losses within 1e-5 relative, the first step's
   gradients within 1e-4 row-relative.

The line before the last is a JSON object with one entry per kernel (time,
CUPTI time, launches, bound, plain and library times, the library's by
CUPTI too; the D=192 entries from path k's first eager calls; the
encoder's and the cross-attention's flash and the cross decode from path
l's), the flash
backward's at h1's and h3's first call, beside the
backward of SDPA on the same tensors, and the WKV6 and RG-LRU backwards'
and the flash backward's at D=256 at paths n's and o's first calls (SDPA's
masked backward beside the last); the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke_results.json``.  Needs a CUDA device and the
repository's ``src/`` beside this file.
"""
import contextlib
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
              torch.float32: 67e12}            # fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # as tests/test_kernels.py
WKV_ORACLE_TOL = 2e-4          # chunked vs token-by-token fp32, as tests/test_kernels.py
RGLRU_ORACLE_TOL = 1e-5        # kernel vs token-by-token fp32, as tests/test_kernels.py
LOGIT_TOL = 1e-3
SEED = 0
DEVICE = "cuda:0"
DECODE_WARPS = 8               # warps a block of the decode body (csrc/decode_body.cuh)
PAGED_D128 = r"paged_decode_kernelI(f|13__nv_bfloat16)Li128E"   # its D=128 paged instantiations
# the D=192 instantiations (Nemotron-4-340B's head) whose ptxas report phase 2
# requires, spill-free: the flash kernels (bf16 tensor-core, fp32 CUDA-core),
# the paged kernel in both dtypes, and the wide-head decode kernel in both
D192 = {"flash_tc_kernelILi192E": "flash_tc<192>",
        "flash_wide_kernelIfLi192E": "flash_wide<float, 192>",
        "paged_decode_kernelIfLi192E": "paged<float, 192>",
        "paged_decode_kernelI13__nv_bfloat16Li192E": "paged<bf16, 192>",
        "decode_wide_kernelIfLi192E": "decode_wide<float, 192>",
        "decode_wide_kernelI13__nv_bfloat16Li192E": "decode_wide<bf16, 192>"}
FLUSH_KERNEL = "ReduceOp<unsigned char"   # the reading flush's kernel: max of a uint8 buffer
SPEC_K = 4                     # the speculative paths' depth
PATH_A_LAYERS = 12             # path a's Qwen1.5-0.5B: its first 12 of 24 layers
PATH_E_LAYERS = 16             # path e's Qwen1.5-4B (also path g's member, its fp32 parity)
SPEC_4B_LAYERS = 10            # path f's Qwen1.5-4B target: its first 10 of 40 layers (bf16)
PATH_F_LAYERS = 8              # path f's Qwen1.5-0.5B (self-draft pair, and the 4B's draft)
MOE_FP32_LAYERS = 4            # path i's fp32 parity: Qwen3-30B-A3B's first 4 of 48 layers
PATH_B_LAYERS = 8              # path b's Qwen1.5-0.5B: its first 8 of 24 layers
NEMOTRON_LAYERS = 4            # path k's Nemotron-4-340B: its first 4 of 96 layers (bf16)
NEMOTRON_FP32_LAYERS = 1       # its fp32 parity: the first layer (51.6 GB)


T_START = time.perf_counter()


STAMPS = []                    # (phase, seconds since the start), into the results file


def stamp(phase):
    at = time.perf_counter() - T_START
    STAMPS.append((phase, round(at, 1)))
    print(f"[time] {phase} done at {at:.1f}s", flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def row_rel_err(got, want):
    """Max over output rows (the last axis) of max|got − want| over the row's
    max|want|, a zero row taken as 1e-6: each row is held on its own scale,
    so rows that average thousands of values, far below one, are held as
    tightly as the rest."""
    d = (got.float() - want.float()).abs().amax(-1)
    return (d / want.float().abs().amax(-1).clamp(min=1e-6)).max().item()


def decode_sub_tile(dtype, D, G):
    """Positions a warp of the decode body loads at once
    (``csrc/decode_body.cuh``: the paged kernel at D <= 192, the contiguous
    one at D <= 64): the rows one load instruction covers (32 lanes over D /
    VEC lanes a row, VEC elements in 16 bytes; at D = 128 two rows in bf16,
    one in fp32; a whole warp a row where D / VEC does not divide 32, as at
    D = 192) times the loads in flight a lane (8 when a block takes at most
    2 query heads, else 4)."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    lanes = D // vec if 32 % (D // vec) == 0 else 32
    return (8 if G <= 2 else 4) * 32 // lanes


def timed_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each after the L2
    cache is evicted by writing ``flush`` (larger than the 50 MB L2), so every
    launch reads its inputs from device memory as the decode loop does."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def device_ms(fn, kernel_substr, iters=50, before=None, records=None):
    """CUPTI device time of one call of ``fn``: the self device time of every
    kernel whose name holds ``kernel_substr`` (or one of a tuple of them),
    summed over ``iters`` calls
    (each after ``before()``, an L2 flush, when it is given) and divided by
    ``iters``, so a call that runs several kernels counts them all.

    A long-lived profiling process loses CUPTI records (half of them, at
    times, late in this script), so a kernel with no more records than
    calls counts its time a record once a call; one with more records than
    calls runs several times a call and counts its total over the calls.
    A dict ``records`` gets {kernel name: (records a call, ms a record)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    frags = kernel_substr if isinstance(kernel_substr, tuple) else (kernel_substr,)
    rows = [e for e in prof.key_averages()
            if e.count and any(f in e.key for f in frags)]
    if records is not None:
        records.update({e.key[:90]: (e.count / iters, e.self_device_time_total / e.count / 1e3)
                        for e in rows})
    total = sum(e.self_device_time_total / min(e.count, iters) for e in rows)
    return None if not rows else total / 1e3


def library_device_ms(fn, iters=50, before=None, records=None):
    """CUPTI device time of one library call ``fn``: every kernel the call
    runs (``before()``, the reading flush run before each call, left out by
    its kernel's name, ``FLUSH_KERNEL``), counted as :func:`device_ms`
    counts them, a kernel's time a record once a call where CUPTI lost
    records; ``records`` as there."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in device_rows(prof) if e.count and FLUSH_KERNEL not in e.key]
    if records is not None:
        records.update({e.key[:90]: (e.count / iters, e.self_device_time_total / e.count / 1e3)
                        for e in rows})
    total = sum(e.self_device_time_total / min(e.count, iters) for e in rows)
    return total / 1e3 if total else None


def bound_ms(n_bytes, n_flops, dtype):
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "F2F.F64", "F2F.F32.F64")


def sass_counts(name, want):
    """Instructions of each kernel (by mangled name) in the SASS of library
    ``name`` whose opcode passes ``want``, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build

    sass = subprocess.run([str(Path(build.find_nvcc()).with_name("cuobjdump")), "-sass",
                           str(build.library_path(name))], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts[fn] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn is not None and m and want(m[1]):
            counts[fn] += 1
    return counts


def flash_work(q, k, window, causal=True):
    """Bytes (q, k, v read once, out written once) and FLOPs (4·D per
    visible (query, key) pair: query i at key position i + Skv − Sq sees
    keys up to it when ``causal``, else all Skv, and with a window only the
    last ``window``) of one flash call."""
    B, S, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    pos = np.arange(S) + (Skv - S)
    hi = np.minimum(pos + 1, Skv) if causal else np.full(S, Skv)
    lo = np.maximum(pos - window + 1, 0) if window else 0
    pairs = int(np.maximum(hi - lo, 0).sum())
    n_bytes = q.element_size() * (2 * B * S * H * D + 2 * B * Skv * Hk * D)
    return n_bytes, 4 * D * pairs * B * H


def paged_work(q, k_pool, table, lengths):
    """Bytes and FLOPs one paged call needs for this data: each distinct
    mapped K/V position below a row's length read once (a shared page once),
    q read and out written once, plus the table and lengths; 4·D FLOPs per
    (query head, visible position)."""
    B, _, H, D = q.shape
    P, ps, Hk, _ = k_pool.shape
    tab, lens = table.cpu().numpy(), lengths.cpu().numpy()
    rows, n_visible = set(), 0
    for b in range(B):
        for pos in range(min(int(lens[b]), tab.shape[1] * ps)):
            page = int(tab[b, pos // ps])
            if page < P:
                rows.add(page * ps + pos % ps)
                n_visible += 1
    n_bytes = (q.element_size() * (2 * B * H * D + 2 * len(rows) * Hk * D)
               + 4 * (table.numel() + lengths.numel()))
    return n_bytes, 4 * D * H * n_visible


def decode_work(q, k, lengths):
    """Bytes and FLOPs one contiguous decode call needs for this data: each
    row's K/V below its length read once, q read and out written once, plus
    the lengths; 4·D FLOPs per (query head, visible position)."""
    B, _, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    n_visible = int(lengths.clamp(max=S).sum())
    n_bytes = q.element_size() * (2 * B * H * D + 2 * n_visible * Hk * D) + 4 * B
    return n_bytes, 4 * D * H * n_visible


def wkv6_work(r, state):
    """Bytes and FLOPs one WKV6 call needs: r, k, v read and out written in
    the model dtype, w read in fp32, u read, the fp32 state read (unless it
    starts at zero, ``state`` None) and written; ~5·D² FLOPs per token and
    head (r·S, the bonus term and S ← w⊙S + kᵀv), done in fp32."""
    B, T, H, D = r.shape
    e = r.element_size()
    n_state = B * H * D * D * (1 if state is None else 2)
    n_bytes = 4 * B * T * H * D * e + 4 * B * T * H * D + H * D * e + 4 * n_state
    return n_bytes, 5 * D * D * B * T * H


def rglru_work(x, state):
    """Bytes and operations one RG-LRU call needs: x read and h written in the
    model dtype, a_log read in fp32, the fp32 state read (unless it starts at
    zero, ``state`` None) and written; 8 operations per token and channel
    (two exp, a sqrt, a max, a subtraction and the three of the update),
    each counted as one fp32 operation."""
    B, T, W = x.shape
    n_state = B * W * (1 if state is None else 2)
    return B * T * W * (2 * x.element_size() + 4) + 4 * n_state, 8 * B * T * W


def wkv6_bwd_work(r, state, d_state):
    """Bytes and FLOPs one WKV6 backward call needs: r, k, v and dO read and
    dr, dk, dv written in the model dtype, w read and dw written in fp32, u
    read and du written, the fp32 state and the final state's gradient read
    where given and the state's gradient written; 12·D² FLOPs per token and
    head (∂r = S·dO and the state's step in the forward sweep, ∂lw, ∂k and
    ∂v against G and G's step in the reverse one), done in fp32."""
    B, T, H, D = r.shape
    e = r.element_size()
    n_state = B * H * D * D * (1 + (state is not None) + (d_state is not None))
    n_bytes = 7 * B * T * H * D * e + 8 * B * T * H * D + 2 * H * D * e + 4 * n_state
    return n_bytes, 12 * D * D * B * T * H


def rglru_bwd_work(x, state, d_state):
    """Bytes and operations one RG-LRU backward call needs: x and dh read and
    dx written in the model dtype, a_log read and da_log written in fp32,
    the state and the final state's gradient read where given and the
    state's gradient written; 16 operations per token and channel (the
    forward's 8 to rebuild the state, and δ, ∂x, ∂a_log and the carry),
    each counted as one fp32 operation."""
    B, T, W = x.shape
    n_state = B * W * (1 + (state is not None) + (d_state is not None))
    return B * T * W * (3 * x.element_size() + 8) + 4 * n_state, 16 * B * T * W


def horizon_view(t, max_len):
    """``t`` (B, S, ...) copied to the start of a (B, max_len, ...) buffer and
    returned as the view ``buf[:, :S]``: the strided layout the contiguous
    engine hands the decode kernel."""
    buf = torch.zeros((t.shape[0], max_len, *t.shape[2:]), dtype=t.dtype, device=t.device)
    buf[:, :t.shape[1]] = t
    return buf[:, :t.shape[1]]


def serving_requests():
    """The serving workload: 16 batch prompts of 6 arithmetic queries behind
    one shared preamble (about 185 tokens each), 64 new tokens each; batch 1
    repeats batch 0, so their pages are shared whole and the first decode
    write forks one."""
    from repro_torch.serving.batcher import BatchPromptFormatter
    from repro_torch.serving.engine import Request

    fmt = BatchPromptFormatter("You are a careful assistant. Answer each of the following "
                               "arithmetic questions with one number, in order, separated "
                               "by semicolons.")
    rng = np.random.default_rng(SEED)
    batches = [[f"{rng.integers(0, 99)}+{rng.integers(0, 99)}" for _ in range(6)]
               for _ in range(16)]
    batches[1] = list(batches[0])
    return [Request(rid=i, tokens=fmt.format(qs), max_new=64) for i, qs in enumerate(batches)]


def sampled_requests():
    """The serving workload with the even requests sampled (temperature 0.8,
    top-k 50, top-p 0.95, seed 1000 + i) and the odd ones greedy; requests
    0 and 1 share their prompt."""
    from repro_torch.serving.generation import GenerationConfig

    reqs = serving_requests()
    for i, r in enumerate(reqs):
        if i % 2 == 0:
            r.gen = GenerationConfig(max_new=64, temperature=0.8, top_k=50, top_p=0.95,
                                     seed=1000 + i)
    return reqs


def switching_requests():
    """A workload whose fused dispatches change key inside one serve: the
    serving workload's first 8 requests (prompts of 184-188 tokens), the
    even ones sampled as in ``sampled_requests`` with 25 new tokens, the
    odd ones greedy with 113.  At K = 8 on 8 slots the sampled ones finish
    after 3 dispatches (sample=True, horizon 256: 16 table columns), the
    greedy ones take 5 more at horizon 256 and 6 past it (512: 32
    columns): three keys, each dispatched at least twice."""
    from repro_torch.serving.generation import GenerationConfig

    reqs = serving_requests()[:8]
    for i, r in enumerate(reqs):
        if i % 2 == 0:
            r.gen = GenerationConfig(max_new=25, temperature=0.8, top_k=50, top_p=0.95,
                                     seed=1000 + i)
        else:
            r.max_new = 113
    return reqs


def first_divergence(a, b):
    """{request index: first token index where streams ``a[i]`` and ``b[i]``
    differ} over the requests whose streams differ."""
    out = {}
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            out[i] = next((t for t, (u, v) in enumerate(zip(x, y)) if u != v),
                          min(len(x), len(y)))
    return out


def top2_gap(model, prompt, prefix):
    """The gap between the two largest logits of ``model`` for the token
    after ``prompt + prefix`` (one prefill of that row, B = 1): how near a
    tie the position where two streams first differ was."""
    toks = torch.tensor([list(prompt) + list(prefix)], dtype=torch.int32, device=model.device)
    top = model.prefill(toks)[0][0, 0].topk(2).values
    return (top[0] - top[1]).item()


def batch_invariance(label, model):
    """Whether each operator of a decode step gives a row the same bits
    whatever the batch: rows 0-3 of 8 against a batch of those 4 (the K = 8
    on 8 slots against K = 1 on 4 comparison).  Printed, not checked."""
    gen = torch.Generator(device=model.device).manual_seed(SEED + 11)
    d = model.cfg.d_model
    x = torch.randn((8, 1, d), generator=gen, device=model.device).to(model.dtype)
    blk = model.blocks[0]
    fns = {"q projection (GEMM)": blk.attn.q, "MLP (3 GEMMs)": blk.mlp, "RMSNorm": blk.n1,
           "lm_head (GEMM)": lambda h: h @ model.lm_head}
    out = {f"{name}, 4 rows of 8": bool(torch.equal(f(x)[:4], f(x[:4]))) for name, f in fns.items()}
    print(f"[{label}] {str(model.dtype)[6:]} batch invariance on the card, not checked (a row's "
          f"bits the same in both batches): {out}")
    return out


class SpanProbe:
    """``Model.decode_span`` written as one pass over the B·S rows of a span
    (one product a weight: the form a verify needs to cost less than K+1
    steps, and the JAX package's form of it), with every row-wise operator
    run both that way and once a position on B rows, as the steps run it.
    The calls where the two differ are counted in ``seen`` (on the device,
    read by ``report``); the one-pass result goes on for the operators
    named in ``one_pass`` (``ALL``: every one), the per-position result for
    the rest.  Called as ``decode_span`` (set on a model
    in its place), it writes the cache as the span does: paged writes to an
    unmapped page go to the drop page, contiguous ones stay inside the
    buffer (the caller keeps them there)."""

    ALL = frozenset(["embedding", "RMSNorm", "q projection", "k projection", "v projection",
                     "RoPE", "o projection", "MLP gate", "MLP up", "MLP down", "lm_head"])

    def __init__(self, model, one_pass=frozenset()):
        self.model, self.one_pass, self.seen = model, one_pass, {}

    def both(self, name, fn, *xs):
        one = fn(*xs)
        per = torch.cat([fn(*(x[:, i:i + 1].contiguous() for x in xs))
                         for i in range(xs[0].shape[1])], dim=1)
        d = (one.float() - per.float()).abs().max()
        n, of, m = self.seen.get(name, (0, 0, d))
        self.seen[name] = (n + (d > 0).int(), of + 1, torch.maximum(m, d))
        return one if name in self.one_pass else per

    def __call__(self, tokens, cache, table=None):
        from repro_torch.kernels import ops
        from repro_torch.models.layers import apply_rope

        model, both = self.model, self.both
        cfg, (B, S) = model.cfg, tokens.shape
        H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        pos = cache["len"]
        positions = pos[:, None] + torch.arange(S, dtype=torch.int32, device=model.device)
        at = positions.long()
        rows = torch.arange(B, device=model.device)[:, None]
        if table is not None:
            P, ps, n_cols = cache["k"].shape[1] - 1, cache["k"].shape[2], table.shape[1]
            page = at // ps
            at = (torch.where(page < n_cols, table[rows, page.clamp(max=n_cols - 1)].long(),
                              P).clamp(max=P), at % ps)
        else:
            at = (rows, at)

        def rope(t, p):
            return apply_rope(t, model._rope(p))

        def head(t):                              # Model._logits after its norm
            logits = (t @ model.lm_head.to(t.dtype)).float()
            logits[..., cfg.vocab_size:] = -1e30
            return logits

        x = both("embedding", model._embed_in, tokens)
        for j, blk in enumerate(model.blocks):
            h = both("RMSNorm", blk.n1, x)
            q = both("q projection", blk.attn.q, h).reshape(B, S, H, hd)
            k = both("k projection", blk.attn.k, h).reshape(B, S, Hk, hd)
            v = both("v projection", blk.attn.v, h).reshape(B, S, Hk, hd)
            q, k = both("RoPE", rope, q, positions), both("RoPE", rope, k, positions)
            kc, vc = cache["k"][j], cache["v"][j]
            kc[at], vc[at] = k, v
            a = (ops.span_attention(q, kc, vc, pos) if table is None else
                 ops.paged_span_attention(q, kc[:P], vc[:P], table, pos))
            x = x + both("o projection", blk.attn.o, a.reshape(B, S, H * hd))
            h = both("RMSNorm", blk.n2, x)
            g, u = both("MLP gate", blk.mlp.gate, h), both("MLP up", blk.mlp.up, h)
            x = x + both("MLP down", blk.mlp.down, blk.mlp.act(g) * u)
        cache["len"] += S
        return both("lm_head", head, both("RMSNorm", model.final_norm, x))

    def report(self):
        return {name: dict(differ=int(n), of=of, max_abs=m.item())
                for name, (n, of, m) in self.seen.items()}

    def text(self):
        return str({name: f"{r['differ']}/{r['of']} (max |d| {r['max_abs']:.3g})"
                    for name, r in self.report().items()})


def span_rounding(label, model):
    """Where a one-pass verify would round a row otherwise than decode steps
    do, from one prefill of 8 random prompts: a span of K+1 positions
    through ``SpanProbe``, carrying the per-position results (whose logits
    must be ``decode_span``'s for the probe to be faithful; printed), then
    again carrying the one-pass results, whose logits are compared with the
    first's.  Printed, not checked."""
    B, S = 8, SPEC_K + 1
    prompts = random_prompts(model.cfg.vocab_size, B, 64, SEED + 5).to(model.device)
    span = random_prompts(model.cfg.vocab_size, B, S, SEED + 6).to(model.device)
    _, cache0 = model.prefill(prompts, max_len=80)
    logits = {}
    for how in ("steps", "per", "one"):
        cache = {k: v.clone() for k, v in cache0.items()}
        probe = SpanProbe(model, SpanProbe.ALL if how == "one" else frozenset())
        logits[how] = (model.decode_span if how == "steps" else probe)(span, cache)
        if how == "per":
            per_probe = probe
    one, per = logits["one"], logits["per"]
    out = dict(operators=per_probe.report(), one_pass_logits_max_abs=(one - per).abs().max().item(),
               one_pass_argmax_differs=int((one.argmax(-1) != per.argmax(-1)).sum()),
               positions=B * S, probe_equals_decode_span=bool(torch.equal(per, logits["steps"])))
    print(f"[{label}] {str(model.dtype)[6:]} span rounding on the card, not checked: calls of "
          f"each operator where one pass over {B * S} rows differs from {S} passes over {B} "
          + per_probe.text()
          + f"; a one-pass span's logits differ by {out['one_pass_logits_max_abs']:.3g}, argmax "
            f"at {out['one_pass_argmax_differs']}/{B * S} positions; the per-position probe "
            f"{'equals' if out['probe_equals_decode_span'] else 'DIFFERS from'} decode_span")
    return out


def span_matches_steps(label, model):
    """``Model.decode_span`` of K+1 tokens against K+1 ``decode_step``s from
    one prefill of 8 random prompts into a contiguous cache: logits and
    cache bit for bit (checked), the JAX package's contract for the span."""
    prompts = random_prompts(model.cfg.vocab_size, 8, 64, SEED + 5).to(model.device)
    span = random_prompts(model.cfg.vocab_size, 8, SPEC_K + 1, SEED + 6).to(model.device)
    _, cache = model.prefill(prompts, max_len=80)
    steps = {k: v.clone() for k, v in cache.items()}
    got = model.decode_span(span, cache)
    want = torch.cat([model.decode_step(span[:, i:i + 1], steps) for i in range(SPEC_K + 1)],
                     dim=1)
    same = bool(torch.equal(got, want)) and all(torch.equal(cache[k], steps[k]) for k in cache)
    print(f"[{label}] {str(model.dtype)[6:]} decode_span of {SPEC_K + 1} tokens vs as many "
          f"decode_steps: logits and cache {'bit-equal' if same else 'DIFFER'} (max |logit "
          f"difference| {(got - want).abs().max().item():.3g})")
    check(same, f"{label}: decode_span differs from sequential decode_steps")
    return same


class RoundLog:
    """Set on a speculative engine's two graph sets: each round's draft
    proposals (copied to the host) and, at the verify, the slot of every
    live request; with ``hook(rid)`` as a request's ``on_tokens``, the block
    each round emitted for it.  ``detach()`` restores the sets' ``run``."""

    def __init__(self, spec):
        self.spec = spec
        self.drafts, self.slots, self.blocks = [], [], []
        self.inner = (spec.draft._graphs.run, spec.target._graphs.run)
        spec.draft._graphs.run, spec.target._graphs.run = self._draft, self._verify

    def _draft(self, key, body):
        out = self.inner[0](key, body)
        self.drafts.append(out.cpu().numpy().copy())
        return out

    def _verify(self, key, body):
        self.slots.append({r.rid: i for i, r in enumerate(self.spec.target.slot_req)
                           if r is not None})
        self.blocks.append({})
        return self.inner[1](key, body)

    def hook(self, rid):
        def on_tokens(block, done):
            del done
            if self.slots and rid in self.slots[-1]:      # not the first token of admission
                self.blocks[-1][rid] = list(block)
        return on_tokens

    def detach(self):
        self.spec.draft._graphs.run, self.spec.target._graphs.run = self.inner

    def tally(self, k):
        """An independent count of each round's block from the dispatches'
        own outputs: its leading tokens equal to the draft's proposals are
        accepted; a token after them is the target's at a mismatch (fewer
        than k matched) or the bonus (all k matched)."""
        acc = bonus = mismatch = emitted = 0
        for d, slots, blocks in zip(self.drafts, self.slots, self.blocks):
            for rid, block in blocks.items():
                a = 0
                while a < min(len(block), k) and block[a] == int(d[a, slots[rid]]):
                    a += 1
                check(len(block) <= a + 1, f"a block of {len(block)} tokens after {a} matches")
                acc += a
                if len(block) > a:
                    mismatch += a < k
                    bonus += a == k
                emitted += len(block)
        return dict(accepted=acc, bonus=bonus, mismatch=mismatch, emitted=emitted)


SERVE_MAX_LEN = 1024


def serving_engine(model, device, paged=True):
    """The engine the serving phases run: 8 slots, max_len 1024, K = 8, and
    (paged) page 16."""
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(model, max_slots=8, max_len=SERVE_MAX_LEN, decode_block=8,
                         paged=paged, page_size=16, device=device)


def random_prompts(vocab, B, T, seed):
    """B rows of T token ids drawn from a numpy seed over the vocab."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (B, T)).astype(np.int32))


def trace_decode(label, model, tokens, step_s, steps=8, **prefill_kw):
    """Profile ``steps`` greedy decode steps after a prefill of ``tokens``:
    the card's busy time a step from torch.profiler's CUDA activity (the self
    device time of every kernel and copy on the card, summed; None when the
    trace holds no device time) beside ``step_s``, the host clock's step
    time of the untraced run, and the ten device entries that take most."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = model.prefill(tokens, **prefill_kw)
    tok = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = model.decode_step(tok, cache)[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
    rows = device_rows(prof)
    total = device_total_ms(rows)
    device_ms = None if total is None else total / steps
    step_ms = 1e3 * step_s
    busy = None if device_ms is None else device_ms / step_ms
    top = top_device(rows, per=steps)
    print(f"[{label}] eager decode trace: device busy "
          + ("not measured (no device time in the trace)" if device_ms is None else
             f"{device_ms:.3f} ms a step of {step_ms:.3f} ms ({100 * busy:.1f}%)"))
    for name, ms in top:
        print(f"[{label}]   {ms:.4f} ms a step: {name}")
    return dict(device_ms_per_step=device_ms, step_ms=step_ms, busy_share=busy, top=top)


def eager_run(key, body):
    """``GraphSet.run`` for the reference leg: every body runs eagerly, as
    the CPU path does; set as an instance's ``run``, made here and visibly,
    never inside the package."""
    del key
    return body()


class FiniteSteps:
    """A model as ``RecurrentDecoder`` sees it, with every decode step's
    logits folded into ``finite``: a device flag made before any capture,
    so a graph replay updates it as an eager step does."""

    def __init__(self, model):
        self.model, self.device = model, model.device
        self.finite = torch.ones((), dtype=torch.bool, device=model.device)

    def decode_step(self, *args, **kwargs):
        logits = self.model.decode_step(*args, **kwargs)
        self.finite.logical_and_(torch.isfinite(logits).all())
        return logits


def greedy(model, tokens, steps=32, graphed=True, **prefill_kw):
    """Prefill ``tokens`` and take ``steps`` greedy steps through
    ``RecurrentDecoder`` (8 a call: on the card one graph replay, or with
    ``graphed=False`` the same body eagerly).  Returns (prefill logits, (B,
    steps + 1) token ids, prefill seconds, decode seconds, the decoder):
    host clock, each span ending in a synchronize.  The tokens stay on the
    card until the end, and the finiteness of every step's logits (a flag on
    the card, ``FiniteSteps``) and of the final state is checked once, so
    no step waits on the host."""
    from repro_torch.serving.graphs import RecurrentDecoder

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, **prefill_kw)
    first = logits[:, 0].argmax(dim=-1).to(torch.int32)
    watch = FiniteSteps(model)
    dec = RecurrentDecoder(watch, decode_block=8)
    if not graphed:
        dec.graphs.run = eager_run
    dec.start(cache, first)
    del cache
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [first[None]] + [dec().clone() for _ in range(steps // dec.decode_block)]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    check(bool(watch.finite), f"{model.cfg.name}: decode logits are not finite")
    state = dec.cache(tokens.shape[0])
    check(all(bool(torch.isfinite(v).all()) for v in state.values() if v.is_floating_point()),
          f"{model.cfg.name}: the decode state is not finite")
    return logits, torch.cat(out).T.cpu(), t1 - t0, decode_s, dec


def states_equal(label, a, b):
    """Bit-equality of two caches (dicts of tensors); prints the largest
    difference of each leaf that differs.  Returns the differing leaves."""
    diff = {}
    for k in a:
        if not torch.equal(a[k], b[k]):
            diff[k] = (a[k].double() - b[k].double()).abs().max().item()
    print(f"[{label}] final state graphed vs eager: "
          + ("bit-equal" if not diff else f"differs, max |difference| by leaf {diff}"))
    return diff


def device_rows(prof):
    """The device entries of a trace (``key_averages()`` taken once: it
    walks every event)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def trace_counts(rows, names):
    """Launches of each kernel name fragment among a trace's device rows."""
    return {n: sum(e.count for e in rows if n in e.key) for n in names}


def device_total_ms(rows):
    """The card's busy time in a trace: the self device time of every kernel
    and copy, summed (None when the trace holds none)."""
    return sum(e.self_device_time_total for e in rows) / 1e3 or None


def top_device(rows, per=1, n=10):
    """The ``n`` device entries of a trace that take most, in ms divided by
    ``per``."""
    return sorted(((e.key[:90], e.self_device_time_total / 1e3 / per) for e in rows
                   if e.self_device_time_total > 0), key=lambda r: -r[1])[:n]


def trace_replay(label, dec, step_ms, names):
    """Profile one replay (``decode_block`` steps) of a warm decoder: the
    card's busy time a step beside ``step_ms`` (the graphed step's host
    clock, untraced), and the launches of each kernel name in ``names`` (a
    fragment of the kernel's name) in the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    dev_ms = device_total_ms(rows)
    per_step = None if dev_ms is None else dev_ms / dec.decode_block
    counts = trace_counts(rows, names)
    busy = None if per_step is None else per_step / step_ms
    top = top_device(rows, per=dec.decode_block)
    print(f"[{label}] graphed replay trace: device busy "
          + ("not measured (no device time in the trace)" if per_step is None else
             f"{per_step:.3f} ms a step of {step_ms:.3f} ms ({100 * busy:.1f}%)")
          + f"; kernels in one replay {counts}")
    for name, ms in top:
        print(f"[{label}]   {ms:.4f} ms a step: {name}")
    return dict(device_ms_per_step=per_step, step_ms=step_ms, busy_share=busy,
                kernels_in_replay=counts, top=top)


class DispatchClock:
    """Set as an engine's ``_graphs.run``: the wall time of every fused
    dispatch (a synchronize before and after) into ``times``, and the
    device rows of a trace of dispatch ``trace_at`` into ``rows``."""

    def __init__(self, engine, trace_at):
        self.inner = engine._graphs.run
        engine._graphs.run = self
        self.trace_at = trace_at
        self.times, self.rows = [], None

    def __call__(self, key, body):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(self.times) == self.trace_at:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = self.inner(key, body)
                torch.cuda.synchronize()
            self.rows = device_rows(prof)
        else:
            out = self.inner(key, body)
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        return out


@contextlib.contextmanager
def first_drops(moe_mod):
    """Wrap ``moe_mod.dispatch_gather``: at its first call (on a serving
    path, layer 0 of the first prefill, never captured), count the (token,
    expert) pairs it drops, from the module's own ``pair_ranks``, into the
    dict yielded.  Later calls (every decode step's among them, captured or
    not) pass straight through."""
    inner = moe_mod.dispatch_gather
    seen = {}

    def wrapper(layer, xt, top_p, top_i, C):
        if not seen:
            _, ranks = moe_mod.pair_ranks(top_i)
            seen.update(tokens=int(xt.shape[0]), pairs=int(ranks.numel()), capacity=int(C),
                        experts=layer.cfg.moe.n_experts, dropped=int((ranks >= C).sum()))
        return inner(layer, xt, top_p, top_i, C)

    moe_mod.dispatch_gather = wrapper
    try:
        yield seen
    finally:
        moe_mod.dispatch_gather = inner


def moe_split(label, engine, moe_mod, requests, trace_at=4):
    """Serve ``requests`` on ``engine`` eagerly (its graphs' ``run`` set to
    call the body) and trace dispatch ``trace_at`` with torch.profiler, CPU
    and CUDA, each MoE layer's forward and its expert products in
    ``record_function`` ranges: the device time of the dispatch's kernels,
    of those launched inside the MoE layers, and of those inside the expert
    products (a CPU range's device time sums its kernels and its
    children's), each a step, and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fwd, ffn = moe_mod.MoE.forward, moe_mod.MoE.expert_ffn

    def fwd_ranged(self, *args, **kwargs):
        with record_function("moe_layer"):
            return fwd(self, *args, **kwargs)

    def ffn_ranged(self, x):
        with record_function("moe_experts"):
            return ffn(self, x)

    n, traced = [0], {}

    def run(key, body):
        n[0] += 1
        if n[0] - 1 != trace_at:
            return body()
        moe_mod.MoE.forward, moe_mod.MoE.expert_ffn = fwd_ranged, ffn_ranged
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = body()
                torch.cuda.synchronize()
        finally:
            moe_mod.MoE.forward, moe_mod.MoE.expert_ffn = fwd, ffn
        traced["prof"] = prof
        return out

    engine._graphs.run = run
    engine.serve(requests)
    K = engine.decode_block
    avgs = traced["prof"].key_averages()
    rows = [e for e in avgs
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total = device_total_ms(rows)

    def range_ms(name):
        return sum(getattr(e, "device_time_total", 0) for e in avgs
                   if e.key == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3

    moe_ms, experts_ms = range_ms("moe_layer"), range_ms("moe_experts")
    top = top_device(rows, per=K, n=12)
    out = dict(device_ms_per_step=None if total is None else total / K,
               moe_ms_per_step=moe_ms / K, experts_ms_per_step=experts_ms / K,
               moe_share=None if not total else moe_ms / total,
               experts_share=None if not total else experts_ms / total, top=top)
    print(f"[{label}] eager dispatch {trace_at} traced (CPU and CUDA): device "
          + ("not measured" if total is None else
             f"{total / K:.3f} ms a step; MoE layers {moe_ms / K:.3f} ms "
             f"({100 * moe_ms / total:.1f}%), of it the expert products {experts_ms / K:.3f} "
             f"ms ({100 * experts_ms / total:.1f}% of the step)"))
    for name, ms in top:
        print(f"[{label}]   {ms:.4f} ms a step: {name}")
    return out


def step_turns(dec_e, dec_g, blocks=2):
    """Host-clock ms a step of the eager and the graphed decoder, in turns
    eager, graphed, graphed, eager (``blocks`` calls each, from where each
    decoder's state stands)."""
    times = {"eager": [], "graphed": []}
    for leg in ("eager", "graphed", "graphed", "eager"):
        dec = dec_e if leg == "eager" else dec_g
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(blocks):
            dec()
        torch.cuda.synchronize()
        times[leg].append(1e3 * (time.perf_counter() - t0) / (blocks * dec.decode_block))
    return times


@contextlib.contextmanager
def recording(module, name, keep):
    """Replace ``module.name`` by a wrapper that clones the arguments of the
    calls whose index is in ``keep`` into ``calls`` and then calls through."""
    orig = getattr(module, name)
    calls = {}
    count = [0]

    def wrapper(*args, **kwargs):
        if count[0] in keep:
            calls[count[0]] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                               dict(kwargs))
        count[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def recording_by_width(module, name):
    """Replace ``module.name`` by a wrapper that clones the arguments of the
    first call at each head width (the first argument's last dimension)
    made outside a CUDA-graph capture into ``calls[width]``, and then calls
    through.  Safe across threads."""
    orig = getattr(module, name)
    calls = {}
    lock = threading.Lock()

    def wrapper(*args, **kwargs):
        q = args[0]
        width = int(q.shape[-1])
        if width not in calls and not (q.is_cuda and torch.cuda.is_current_stream_capturing()):
            with lock:
                if width not in calls:
                    calls[width] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                                    dict(kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def recording_backward(flash_mod):
    """Clone the inputs of the first flash backward at each head width (the
    saved q, k, v, the output's gradient and the mask arguments) into
    ``calls[width]`` by wrapping ``FlashAttention.backward``; the kernel's
    own wrapper, whose launch counter the paths read, is left as it is."""
    cls = flash_mod.FlashAttention
    orig = cls.backward
    calls = {}
    lock = threading.Lock()

    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        with lock:
            if q.shape[-1] not in calls:
                calls[q.shape[-1]] = (
                    [t.detach().clone() for t in (q, k, v, d_out.contiguous())],
                    dict(causal=ctx.causal, window=ctx.window))
        return orig(ctx, d_out)

    cls.backward = staticmethod(backward)
    try:
        yield calls
    finally:
        cls.backward = staticmethod(orig)


def recurrent_compare(label, streams, streams_e, dec, dec_e, counts, eager_counts):
    """Graphed against eager on a recurrent path: identical streams and
    launches (checked), the final state bit-equal (reported), and the
    graphs captured."""
    B = streams.shape[0]
    same = bool(torch.equal(streams, streams_e))
    print(f"[{label}] graphed vs eager: streams {'identical' if same else 'DIFFER'}, launches "
          f"{'equal' if counts == eager_counts else (counts, eager_counts)}; graphs captured "
          f"{len(dec.graphs.graphs)}, {dec.graphs.n_replays} replays")
    check(same, f"{label}: graphed streams differ from the eager body's")
    check(counts == eager_counts, f"{label}: launches {counts} graphed, {eager_counts} eager")
    diff = states_equal(label, dec.cache(B), dec_e.cache(B))
    return dict(streams_identical=same, graphs=len(dec.graphs.graphs),
                replays=dec.graphs.n_replays, final_state_diff=diff)


def short_leg(label, model, dev, main_path, caches_equal, paged=True, max_new=33,
              recorded=None):
    """A short serve of a large model: 8 of the serving requests, ``max_new``
    tokens each (the prefill's, then dispatches of K = 8), through the
    graphs (the main path, counted as ``label``) and again through the eager
    body on a fresh engine (``label``-eager).  Tokens, dispatches, launches
    (prefills x layers flash, dispatches x 8 x layers of the decode kernel,
    graphed = eager) and the final caches must be identical.  ``recorded``:
    a dict that gets the first eager call of each kernel not in it yet.
    Returns (the graphed engine, its streams, its launches, its seconds, the
    eager leg's seconds)."""
    from repro_torch.kernels import ops

    attn = "paged_attention" if paged else "decode_attention"
    L = model.cfg.n_layers

    def leg(graphed):
        eng = serving_engine(model, dev, paged=paged)
        if not graphed:
            eng._graphs.run = eager_run
        reqs = serving_requests()[:8]
        for r in reqs:
            r.max_new = max_new
        with contextlib.ExitStack() as stack:
            counts = stack.enter_context(main_path(label + ("" if graphed else "-eager"),
                                                   ("flash_attention", attn)))
            if not graphed and recorded is not None:
                for n in ("flash_attention", attn):
                    if n not in recorded:
                        recorded[n] = stack.enter_context(recording(ops, n, {0}))
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.serve(reqs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        return eng, [r.out_tokens for r in reqs], counts, secs

    (g_eng, g_streams, g_c, g_s), (e_eng, e_streams, e_c, e_s) = leg(True), leg(False)
    want = {"flash_attention": g_eng.n_prefill_calls * L, attn: g_eng.n_decode_calls * 8 * L}
    print(f"[{label}] graphed vs eager: tokens {'identical' if g_streams == e_streams else 'DIFFER'}"
          f" ({sum(map(len, g_streams))} tokens), {g_eng.n_prefill_calls} prefill, "
          f"{g_eng.n_decode_calls} dispatches ({len(g_eng._graphs.graphs)} graphs, "
          f"{g_eng._graphs.n_replays} replays); {g_s:.2f}s graphed, {e_s:.2f}s eager")
    check(g_streams == e_streams, f"{label}: graphed tokens differ from the eager body's")
    check(g_eng.n_decode_calls == (max_new - 1) // 8 and all(len(t) == max_new for t in g_streams),
          f"{label}: {g_eng.n_decode_calls} dispatches, lengths {[len(t) for t in g_streams]}")
    check({n: g_c[n] for n in want} == want and g_c == e_c,
          f"{label}: launches {g_c} graphed, {e_c} eager, expected {want}")
    check(not caches_equal(label, g_eng, e_eng),
          f"{label}: final caches differ graphed against eager")
    return g_eng, g_streams, dict(g_c), g_s, e_s


def clocked_serve(label, g_eng, model, max_new, streams, dev):
    """One more graphed serve of ``short_leg``'s requests on its engine,
    every dispatch clocked and the second traced: a graphed step against
    the bound of reading every weight but the embedding, and the card's
    busy share of the traced dispatch.  The tokens must be ``streams``."""
    clock = DispatchClock(g_eng, trace_at=1)
    reqs = serving_requests()[:8]
    for r in reqs:
        r.max_new = max_new
    g_eng.serve(reqs)
    g_eng._graphs.run = clock.inner
    check([r.out_tokens for r in reqs] == streams,
          f"{label}: the clocked serve's tokens differ from the first serve's")
    others = [t for i, t in enumerate(clock.times) if i != 1]
    disp_ms = 1e3 * float(np.mean(others))
    dev_ms = device_total_ms(clock.rows)
    step_bytes = (model.param_count() - model.embed.numel()) * model.embed.element_size()
    step_bound = 1e3 * step_bytes / HBM_BYTES_PER_S
    step_ms = disp_ms / 8
    print(f"[{label}] graphed step {step_ms:.3f} ms (clocked dispatches of K = 8, "
          f"{[round(1e3 * t, 3) for t in clock.times]} ms) against a bound of "
          f"{step_bound:.3f} ms ({step_bytes / 1e9:.2f} GB of weights at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {step_ms / step_bound:.2f}x; a traced "
          f"dispatch's device time "
          + ("not measured" if dev_ms is None else
             f"{dev_ms:.3f} ms of {disp_ms:.3f} ({100 * dev_ms / disp_ms:.1f}% busy)"))
    for name, ms in top_device(clock.rows):
        print(f"[{label}]   {ms:.4f} ms a dispatch: {name}")
    check(dev_ms is not None or dev.type != "cuda",
          f"{label}: the dispatch trace holds no device time")
    return dict(step_ms=step_ms, step_bound_ms=step_bound, step_bytes=step_bytes,
                dispatch_ms=disp_ms, device_ms_per_dispatch=dev_ms,
                busy_share=None if dev_ms is None else dev_ms / disp_ms)


# ---- path k: Nemotron-4-340B's first layers at full width -----------------
def nemotron_path(label, dev, main_path, caches_equal, cfg, seed):
    """Path k: ``cfg`` (Nemotron-4-340B cut to its first layers, full width:
    LayerNorm, squared-ReLU MLP, half of each head of 192 rotated, 96 query
    heads on 8 KV heads) drawn on ``dev`` from ``seed``, every earlier
    path's model freed first.  Paged: 8 of the serving requests prefilled,
    then 32 greedy steps (4 dispatches of K = 8) through the graphs and
    again eagerly (the kernels' inputs recorded there): tokens, launches
    (prefills x layers flash, dispatches x 8 x layers paged) and the final
    caches identical.  One more graphed serve clocks every dispatch and
    traces the second (a step against the bound of every weight but the
    embedding, the card's busy share).  Then a short contiguous leg (8
    requests, 16 steps) runs the decode kernel at D=192 graphed against
    eager, its streams printed beside the paged ones.  Returns (what it
    measured, the recorded calls by kernel, the launches by kernel)."""
    from repro_torch.models.transformer import Model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params, init_s = model.param_count(), time.perf_counter() - t0
    print(f"[{label}] {cfg.name} cut to {cfg.n_layers} layers: {n_params / 1e9:.3f} B parameters "
          f"({n_params:,}) in {str(model.dtype)[6:]}, init {init_s:.1f}s; {held_before:.2f} GiB "
          f"held before it, {torch.cuda.memory_allocated() / 2**30:.2f} GiB after, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out = dict(params=n_params, layers=cfg.n_layers, init_s=init_s, held_before_gib=held_before)
    recorded, launches, streams = {}, {}, {}
    # the paged leg: the prefill's token, then 4 dispatches of 8; the
    # contiguous one: the prefill's token, then 2 dispatches of 8
    for paged, max_new in ((True, 33), (False, 17)):
        layout = "paged" if paged else "contiguous"
        g_eng, g_streams, g_c, g_s, e_s = short_leg(f"{label}-{layout}", model, dev, main_path,
                                                    caches_equal, paged, max_new, recorded)
        streams[layout], launches[layout] = g_streams, g_c
        out[layout] = dict(launches=g_c, seconds=g_s, eager_seconds=e_s,
                           prefills=g_eng.n_prefill_calls, dispatches=g_eng.n_decode_calls)
        if paged:
            out.update(clocked_serve(label, g_eng, model, max_new, g_streams, dev))
        del g_eng
    agree = sum(a[:17] == b for a, b in zip(streams["paged"], streams["contiguous"]))
    print(f"[{label}] not checked (bf16; phase 7 holds the two layouts equal in fp32): the "
          f"first 17 tokens of the contiguous leg against the paged one's agree in {agree}/8 "
          f"streams")
    for i in range(2):
        print(f"[{label}]   request {i}: paged {streams['paged'][i][:17]}, contiguous "
              f"{streams['contiguous'][i]}")
    out["layouts_agree_first_17"] = agree
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] peak memory {out['peak_gib']:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return out, {n: calls[0] for n, calls in recorded.items()}, launches


def hold_flash(label, q, k, v, kw):
    """A recorded flash call held against its plain version on the same
    inputs (max abs and row-relative within the dtype's tolerance)."""
    from repro_torch.kernels import flash_attention as flash_mod

    kw = {"causal": kw.get("causal", True), "window": kw.get("window")}
    got = flash_mod.flash_attention_cuda(q, k, v, **kw)
    want = flash_mod.flash_attention_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(err <= TOL[q.dtype] and rel <= TOL[q.dtype],
          f"{label}: flash on main-path inputs: max abs err {err:.3g}, row-relative {rel:.3g}")
    return dict(max_abs_err=err, row_rel_err=rel)


# ---- path l: SeamlessM4T-large-v2 at full width and depth -------------------
ENC_PROMPT_LEN = 64              # path l: decoder prompts right-padded to 64 (40-64 valid)
ENC_MAX_LEN = 128                # path l: the decoder's self-attention cache


@contextlib.contextmanager
def call_kinds(module, name, kind):
    """Wrap ``module.name``: each call made from Python (eager or under a
    capture; a replay runs none) adds one to ``counts[kind(*args,
    **kwargs)]`` and calls through.  The kernels' own counters stay the
    gate; this splits their calls by the shapes a path gives them."""
    orig = getattr(module, name)
    counts = {}

    def wrapper(*args, **kwargs):
        key = kind(*args, **kwargs)
        counts[key] = counts.get(key, 0) + 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield counts
    finally:
        setattr(module, name, orig)


def flash_kind(q, k, v, *, causal=True, **_):
    """A flash call's kind on the encoder-decoder: the encoder's (not
    causal, Sq = Skv), a decoder's self-attention (causal) or its
    cross-attention (not causal over the encoder's frames)."""
    if causal:
        return "self"
    return "encoder" if q.shape[1] == k.shape[1] else "cross"


def decode_kind(q, k, v, lengths):
    """A decode call's kind on the encoder-decoder: over the self cache
    (``ENC_MAX_LEN`` positions) or over the encoder's K/V."""
    return "self" if k.shape[1] == ENC_MAX_LEN else "cross"


def encdec_inputs(cfg, dev, seed, B=8):
    """Path l's workload: B requests, each 1,536 frame embeddings of the
    audio stub and a decoder prompt of 40-64 token ids right-padded to 64,
    all from ``seed``."""
    from repro_torch.launch import specs

    rng = np.random.default_rng(seed)
    lengths = rng.integers(40, ENC_PROMPT_LEN + 1, B).astype(np.int32)
    lengths[0] = ENC_PROMPT_LEN
    tokens = rng.integers(0, cfg.vocab_size, (B, ENC_PROMPT_LEN)).astype(np.int32)
    tokens[np.arange(ENC_PROMPT_LEN)[None, :] >= lengths[:, None]] = 0
    frames = specs.frame_embeddings(cfg, B, seed + 1, device=dev)
    return (torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev), frames)


def encdec_path(label, dev, main_path, cfg, seed):
    """Path l: ``cfg`` (SeamlessM4T-large-v2 at full width and depth) drawn
    on ``dev`` from ``seed``.  ``Model.prefill(enc_inputs=, lengths=)`` of
    ``encdec_inputs``, then 32 greedy steps through ``RecurrentDecoder``
    (its flat cache holds the cross K/V), graphed (the main path) and again
    eagerly (the kernels' inputs recorded there): tokens, launches and the
    final caches identical; every prefill launches exactly 24 encoder, 24
    self and 24 cross flash calls, every step 24 self and 24 cross decode
    calls.  A graphed step is clocked in turns against its bound (the
    decoder's weights, the head and the cross K/V read each step) and one
    replay traced.  Returns (what it measured, the recorded calls by kind,
    the launches by kernel)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models.transformer import Model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params, init_s = model.param_count(), time.perf_counter() - t0
    print(f"[{label}] {cfg.name}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters ({n_params:,}) in {str(model.dtype)[6:]}, init "
          f"{init_s:.1f}s; {held_before:.2f} GiB held before it")
    tokens, lengths, frames = encdec_inputs(cfg, dev, seed)
    L, n_steps = cfg.n_layers, 32
    kw = dict(enc_inputs=frames, lengths=lengths, max_len=ENC_MAX_LEN)
    legs, kinds = {}, {}
    for leg in ("graphed", "eager"):
        with contextlib.ExitStack() as stack:
            counts = stack.enter_context(main_path(label + ("" if leg == "graphed" else "-eager"),
                                                   ("flash_attention", "decode_attention")))
            fk = stack.enter_context(call_kinds(ops, "flash_attention", flash_kind))
            dk = stack.enter_context(call_kinds(ops, "decode_attention", decode_kind))
            if leg == "eager":
                fcalls = stack.enter_context(recording(ops, "flash_attention",
                                                       {0, cfg.n_encoder_layers + 1}))
                dcalls = stack.enter_context(recording(ops, "decode_attention", {1}))
            legs[leg] = greedy(model, tokens, n_steps, graphed=leg == "graphed", **kw)
        kinds[leg] = dict(flash=fk, decode=dk, launches=counts)
    (logits, streams, prefill_s, decode_s, dec), (_, streams_e, _, decode_e, dec_e) = (
        legs["graphed"], legs["eager"])
    want_flash = {"encoder": cfg.n_encoder_layers, "self": L, "cross": L}
    want_decode = {"self": L * n_steps, "cross": L * n_steps}
    launches, eager_launches = kinds["graphed"]["launches"], kinds["eager"]["launches"]
    print(f"[{label}] flash calls by kind {kinds['graphed']['flash']} (graphed leg), decode "
          f"calls by kind {kinds['eager']['decode']} (eager leg)")
    check(kinds["graphed"]["flash"] == want_flash == kinds["eager"]["flash"],
          f"{label}: flash calls by kind {kinds['graphed']['flash']}, expected {want_flash}")
    check(kinds["eager"]["decode"] == want_decode,
          f"{label}: decode calls by kind {kinds['eager']['decode']}, expected {want_decode}")
    check(launches["flash_attention"] == sum(want_flash.values())
          and launches["decode_attention"] == sum(want_decode.values()),
          f"{label}: launches {launches}, expected {sum(want_flash.values())} flash and "
          f"{sum(want_decode.values())} decode")
    cmp = recurrent_compare(label, streams, streams_e, dec, dec_e, launches, eager_launches)
    check(not cmp["final_state_diff"], f"{label}: final caches differ graphed against eager")
    B = tokens.shape[0]
    check(tuple(logits.shape) == (B, 1, model.vocab_padded)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          f"{label}: prefill logits {tuple(logits.shape)} not finite")
    check(bool(((streams >= 0) & (streams < cfg.vocab_size)).all()),
          f"{label}: a token id out of the vocab")
    check(tuple(fcalls[0][0][0].shape) == (B, specs.AUDIO_ENC_FRAMES, cfg.n_heads, cfg.head_dim)
          and tuple(fcalls[cfg.n_encoder_layers + 1][0][1].shape[1:3])
          == (specs.AUDIO_ENC_FRAMES, cfg.n_kv_heads)
          and tuple(dcalls[1][0][1].shape[1:3]) == (specs.AUDIO_ENC_FRAMES, cfg.n_kv_heads),
          f"{label}: the recorded calls are not the encoder's and the cross-attention's")
    turns = step_turns(dec_e, dec)
    step_ms = float(np.mean(turns["graphed"]))
    cache = dec.cache(B)
    w_bytes = (sum(p.numel() for p in model.blocks.parameters()) + model.lm_head.numel()
               + sum(p.numel() for p in model.final_norm.parameters())) * model.embed.element_size()
    kv_bytes = 2 * cache["cross_k"].numel() * cache["cross_k"].element_size()
    step_bound = 1e3 * (w_bytes + kv_bytes) / HBM_BYTES_PER_S
    print(f"[{label}] prefill {B}x{ENC_PROMPT_LEN} over {specs.AUDIO_ENC_FRAMES} frames "
          f"{prefill_s:.3f}s; ms a step in turns: eager {[round(x, 3) for x in turns['eager']]}, "
          f"graphed {[round(x, 3) for x in turns['graphed']]}; a graphed step against a bound "
          f"of {step_bound:.3f} ms ({w_bytes / 1e9:.3f} GB of decoder and head weights, "
          f"{kv_bytes / 1e9:.3f} GB of cross K/V, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): "
          f"{step_ms / step_bound:.2f}x")
    replay = trace_replay(label, dec, step_ms, ["::decode_kernel"])
    n_trace = replay["kernels_in_replay"]["::decode_kernel"]
    check(dev.type != "cuda" or 1 <= n_trace <= 2 * L * dec.decode_block,
          f"{label}: {n_trace} decode kernels in a replay's trace, expected 1 to "
          f"{2 * L * dec.decode_block}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] peak memory {peak:.2f} GiB")
    out = dict(params=n_params, config_param_count=cfg.param_count(), init_s=init_s,
               held_before_gib=held_before, prefill_s=prefill_s, decode_s=decode_s,
               eager_decode_s=decode_e, launches=dict(launches),
               flash_by_kind=kinds["graphed"]["flash"], decode_by_kind=kinds["eager"]["decode"],
               step_ms_turns=turns, step_ms=step_ms, step_bound_ms=step_bound,
               step_weight_bytes=w_bytes, step_cross_kv_bytes=kv_bytes, replay_trace=replay,
               compare=cmp, peak_gib=peak, prompt_lengths=lengths.tolist())
    recorded = {"flash_attention_encoder": fcalls[0],
                "flash_attention_cross": fcalls[cfg.n_encoder_layers + 1],
                "decode_attention_cross": dcalls[1]}
    per_kind = {"flash_attention_encoder": want_flash["encoder"],
                "flash_attention_cross": want_flash["cross"],
                "decode_attention_cross": want_decode["cross"]}
    del model, dec, dec_e, cache
    torch.cuda.empty_cache()
    return out, recorded, per_kind


# ---- path m: Qwen2-VL-72B's first layers at full width ----------------------
QWEN2VL_LAYERS = 8               # path m: Qwen2-VL-72B's first 8 of 80 layers (bf16)
VLM_GRID = (16, 16, 16, 32)      # path m: 16 text tokens, a 16 x 16 patch grid, 32 text tokens


def vlm_positions(B, dev):
    """Path m's M-RoPE ids (B, 3, 304): ``VLM_GRID``'s text, image, text by
    Qwen2-VL's rule, the same for every row."""
    from repro_torch.launch import specs

    pos = specs.mrope_positions(*VLM_GRID)
    return pos[None].expand(B, *pos.shape).contiguous().to(dev)


def vlm_path(label, dev, main_path, caches_equal, cfg, seed):
    """Path m: ``cfg`` (Qwen2-VL-72B cut to its first layers, full width:
    M-RoPE of sections (16, 24, 24), QKV bias, 64 query heads on 8 KV heads
    of 128) drawn on ``dev`` from ``seed``, every earlier path's model
    freed first.  (m1) ``Model.forward`` on 8 stub sequences of patch and
    text embeddings (``VLM_GRID``) with their M-RoPE ids: one flash launch a
    layer, logits finite, the first layer's flash call held against its
    plain version, and the logits at text positions printed beside them.
    (m2) 8 text requests served paged (32 steps) and contiguous (16 steps)
    through ``short_leg``, graphed against eager (tokens, launches,
    caches), and one more graphed paged serve clocked with one dispatch
    traced (``clocked_serve``).  Returns (what it measured, the model's embeddings and
    positions for phase 7)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models.transformer import Model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params, init_s = model.param_count(), time.perf_counter() - t0
    print(f"[{label}] {cfg.name} cut to {cfg.n_layers} layers: {n_params / 1e9:.3f} B parameters "
          f"({n_params:,}) in {str(model.dtype)[6:]}, init {init_s:.1f}s; {held_before:.2f} GiB "
          f"held before it")
    out = dict(params=n_params, layers=cfg.n_layers, init_s=init_s, held_before_gib=held_before)
    B = 8
    pos3 = vlm_positions(B, dev)
    embeds = specs.patch_embeddings(cfg, B, pos3.shape[-1], seed + 1, device=dev)
    with torch.no_grad():
        with main_path(f"{label}-forward", ("flash_attention",)) as counts, \
                recording(ops, "flash_attention", {0}) as fcall:
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = model.forward(embeds, positions=pos3)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t
        check(counts["flash_attention"] == cfg.n_layers,
              f"{label}: {counts['flash_attention']} flash launches in the forward, expected "
              f"{cfg.n_layers}")
        check(tuple(logits.shape) == (B, pos3.shape[-1], model.vocab_padded)
              and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
              f"{label}: forward logits {tuple(logits.shape)} not finite")
        text_logits, _ = model.forward(embeds)
        moved = (text_logits - logits)[..., :cfg.vocab_size].abs().max().item()
        del text_logits
    (q, k, v), fkw = fcall[0]
    check(tuple(q.shape[2:]) == (cfg.n_heads, cfg.head_dim) and k.shape[2] == cfg.n_kv_heads,
          f"{label}: the recorded flash call is not D=128, G=8: {tuple(q.shape)}, {tuple(k.shape)}")
    got = hold_flash(label, q, k, v, fkw)
    print(f"[{label}] forward of {B} x {pos3.shape[-1]} embeddings (text {VLM_GRID[0]}, a "
          f"{VLM_GRID[1]} x {VLM_GRID[2]} image, text {VLM_GRID[3]}) with M-RoPE ids in "
          f"{fwd_s:.3f}s; first layer's flash call {got}; not checked: the same embeddings at "
          f"text positions move the logits by up to {moved:.3g}")
    out.update(forward_s=fwd_s, forward_launches=dict(counts), first_flash=got,
               text_position_logit_shift=moved)
    del logits
    streams = {}
    for paged, max_new in ((True, 33), (False, 17)):
        layout = "paged" if paged else "contiguous"
        g_eng, g_streams, g_c, g_s, e_s = short_leg(f"{label}-{layout}", model, dev, main_path,
                                                    caches_equal, paged, max_new)
        streams[layout] = g_streams
        out[layout] = dict(launches=g_c, seconds=g_s, eager_seconds=e_s,
                           prefills=g_eng.n_prefill_calls, dispatches=g_eng.n_decode_calls)
        if paged:
            out.update(clocked_serve(f"{label}-{layout}", g_eng, model, max_new, g_streams, dev))
        del g_eng
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] peak memory {out['peak_gib']:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return out, embeds, pos3


# ---- path g: RoBatch's control plane over a live pool -------------------
G_PRICES = ("tiny-s", "tiny-l")  # TINY_PRICES of the small and the large member: $0.1/$0.4
#                                  and $0.8/$3.2 per 1M tokens in/out, a ratio of 8 near
#                                  the models' 0.46 B : 3.95 B parameters
G_TRAIN = G_TEST = 32            # the task's queries (build_task_workload)
G_CORESET = 8
G_BUDGETS = (1.5, 4.0)           # submit budgets, times the initial plan's amortized cost
G_QPS, G_SECONDS, G_WINDOW_S, G_REPEAT = 8.0, 6.0, 0.5, 0.2
G_BUDGET_X = 10.0                # serve budget rate: qps x initial-state cost x this
G_TRACE_WINDOW = 4               # the serve's window traced by torch.profiler
BYTE_IDS = 259                   # the byte tokenizer's ids (256 bytes, pad, bos, eos)


def byte_head(model):
    """Zero the output head's columns past the byte tokenizer's 259 ids.  A
    model with random weights then answers the byte-level task in bytes (the
    other ids' logits are 0, below the largest of 259 random ones), as a
    byte-level model would; at full vocab it draws a byte 0.17% of the time,
    so every parsed answer would be empty.  The product stays at full
    width."""
    with torch.no_grad():
        model.lm_head[:, BYTE_IDS:] = 0


def parity_judge(pred, gold):
    """Path g's verdict on a parsed answer: 1 if its byte length is even.
    Random weights answer no sum right, so the task's own judge (the last
    digit) scores every answer 0 and every plan puts all queries on the
    cheaper member; this judge is a pure function of the parsed answer that
    varies from answer to answer, so the router's labels vary and RoBatch
    routes to both members."""
    return float(len(pred.encode()) % 2 == 0)


class Ledger:
    """Every invocation of a pool member: the member, its queries, the
    request its engine served (prompt and generated tokens, the engine's own
    counts), its wall interval and thread, and the member's result."""

    def __init__(self, pool):
        self.calls = []
        self._lock = threading.Lock()
        self._local = threading.local()
        for k, m in enumerate(pool):
            self._wrap(k, m)

    def _wrap(self, k, member):
        serve, invoke = member.engine.serve, member.invoke_batch

        def engine_serve(reqs):
            self._local.reqs = reqs
            return serve(reqs)

        def invoke_batch(wl, batch_idx, **kw):
            t0 = time.perf_counter()
            res = invoke(wl, batch_idx, **kw)
            t1 = time.perf_counter()
            (req,) = self._local.reqs
            with self._lock:
                self.calls.append(dict(k=k, idx=np.asarray(batch_idx).copy(),
                                       tokens=list(req.tokens), out=list(req.out_tokens),
                                       t0=t0, t1=t1, thread=threading.get_ident(), res=res))
            return res

        member.engine.serve = engine_serve
        member.invoke_batch = invoke_batch


@contextlib.contextmanager
def timing(module, name, into):
    """Replace ``module.name`` by a wrapper adding each call's wall time to
    ``into[name]``."""
    orig = getattr(module, name)
    into.setdefault(name, 0.0)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            into[name] += time.perf_counter() - t0

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def submit_checked(label, gw, pool, ledger, fmt, judge, test, budgets, init):
    """``Gateway.submit`` at each of ``budgets`` times ``init`` (the initial
    plan's cost): the plan within the budget, its groups the invocations
    the ledger saw, the exact cost the engines' tokens times the members'
    prices, and every utility ``judge``'s verdict on the parsed answer.
    Returns what each submit gave."""
    task = pool[0].task
    out = []
    for mult in budgets:
        budget = mult * init
        plan = gw.plan(test, budget)
        check(plan.est_cost <= budget + 1e-12,
              f"{label}: plan costs {plan.est_cost} over the budget {budget}")
        n0 = len(ledger.calls)
        got = gw.submit(test, budget)
        calls = ledger.calls[n0:]
        check([(c["k"], c["idx"].tolist()) for c in calls]
              == [(int(st.model), m.tolist()) for st, m in plan.groups]
              and got.n_invocations == len(plan.groups),
              f"{label}: the invocations are not the plan's groups")
        bill = 0.0
        util = {}
        for c in calls:
            member = pool[c["k"]]
            bill += len(c["tokens"]) * member.c_in / 1e6
            bill += len(c["out"]) * member.c_out / 1e6
            ids = c["out"]
            eos = member.engine.eos_id
            ids = ids[:ids.index(eos)] if eos in ids else ids
            answers = fmt.parse(fmt.tokenizer.decode(ids), len(c["idx"]))
            for q, a in zip(c["idx"], answers):
                util[int(q)] = judge(a, task.answers[int(q)])
        check(got.exact_cost == bill,
              f"{label}: exact_cost {got.exact_cost!r}, tokens x prices {bill!r}")
        check(np.array_equal(got.per_query_utility, [util[int(q)] for q in test]),
              f"{label}: a utility is not the judge's verdict on the parsed answer")
        by = {}
        for st, m in plan.groups:
            by.setdefault(pool[int(st.model)].name, []).append(len(m))
        print(f"[{label}] submit at ${budget:.8f} ({mult} x the initial plan): est cost "
              f"${plan.est_cost:.8f}, exact ${got.exact_cost:.8f} (= tokens x prices), "
              f"accuracy {got.accuracy:.4f}, {got.n_invocations} invocations, batch sizes "
              f"by member {by}")
        out.append(dict(budget=budget, est_cost=plan.est_cost, exact_cost=got.exact_cost,
                        accuracy=got.accuracy, invocations=got.n_invocations, groups=by))
    return out


def control_plane(label, dev, models, main_path):
    """Path g: ``Gateway`` fit, submit and serve over ``ServedPoolMember``s of
    the port's engines (paged, page 16, graphed, 8 slots, max_len 1024), one
    a model of ``models``, priced ``G_PRICES``, on the tiny pool's addition
    task judged by ``parity_judge``; the MLP router trains and predicts on
    the card.  The whole of it is the main path: launch counts from 0 before
    fit, read after serve, and held to the engines' own dispatch counts.
    The first eager flash and paged call at each member's head width is
    recorded and, after the path, held against the plain version.  Returns
    what it measured, and those calls by (kernel, head width)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Gateway, RunSpec
    from repro_torch.core import robatch as robatch_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.core.router import MLPRouter
    from repro_torch.serving.batcher import BatchPromptFormatter
    from repro_torch.serving.online import OnlineConfig, OnlineRobatchServer, poisson_arrivals
    from repro_torch.serving.pool import ServedPoolMember
    from repro_torch.serving.tinypool import SYSTEM_PROMPT, TINY_PRICES, build_task_workload

    fmt = BatchPromptFormatter(SYSTEM_PROMPT)
    wl, task = build_task_workload(np.random.default_rng(SEED), fmt, n_train=G_TRAIN,
                                   n_test=G_TEST)
    task.judge = parity_judge
    pool = []
    for model, price in zip(models, G_PRICES):
        byte_head(model)
        c_in, c_out = TINY_PRICES[price]
        pool.append(ServedPoolMember(model.cfg.name, serving_engine(model, dev), fmt, task,
                                     c_in=c_in, c_out=c_out, context_len=SERVE_MAX_LEN))
    ledger = Ledger(pool)
    spec = RunSpec(router="mlp", coreset_size=G_CORESET, grid_multiple=2, seed=SEED)
    test = wl.subset_indices("test")
    out = {"pool": [(m.name, m.c_in, m.c_out) for m in pool]}
    stages = {}
    steps, win = [], {}
    with main_path(label, ("flash_attention", "paged_attention")) as counts, \
            recording_by_width(ops, "flash_attention") as flash_calls, \
            recording_by_width(ops, "paged_attention") as paged_calls:
        # ---- fit: b=1 labels, router, coreset profiling and calibration
        gw = Gateway(pool, wl, spec=spec, device=dev)
        t0 = time.perf_counter()
        with timing(robatch_mod, "collect_router_labels", stages), \
                timing(robatch_mod, "train_mlp_router", stages), \
                timing(robatch_mod, "calibrate_model", stages):
            n_fit0 = len(ledger.calls)
            gw.fit()
        fit_s = time.perf_counter() - t0
        rb = gw.robatch
        label_calls = len(wl.subset_indices("train")) * len(pool)
        profiling = ledger.calls[n_fit0 + label_calls:]
        stages["profiling"] = sum(c["t1"] - c["t0"] for c in profiling)
        stages["calibration"] = stages["calibrate_model"] - stages["profiling"]
        check(isinstance(rb.router, MLPRouter) and rb.router.device == dev,
              f"{label}: the MLP router is not on {dev}")
        print(f"[{label}] fit {fit_s:.2f}s: b=1 labels {stages['collect_router_labels']:.2f}s "
              f"({label_calls} invocations), router {stages['train_mlp_router']:.2f}s on "
              f"{rb.router.device}, profiling {stages['profiling']:.2f}s, calibration "
              f"{stages['calibration']:.3f}s; probes {rb.profile.n_probes}, billed tokens "
              f"{rb.profile.billed_tokens}; labels' mean by member "
              f"{[round(float(x), 4) for x in rb.train_labels.mean(0)]}")
        for c in rb.calibrations:
            print(f"[{label}]   {pool[c.k].name}: b_max {c.b_max}, b_effect {c.b_effect}, "
                  f"grid {c.grid.tolist()}, profiled means "
                  f"{ {b: round(u, 4) for b, u in c.u_mean_at.items()} }")
        out["fit"] = dict(seconds=fit_s, stages=dict(stages), probes=rb.profile.n_probes,
                          billed_tokens=rb.profile.billed_tokens,
                          calibrations=[dict(member=pool[c.k].name, b_max=c.b_max,
                                             b_effect=c.b_effect, grid=c.grid.tolist())
                                        for c in rb.calibrations])

        # ---- submit at two budgets: plan, commit, and the bill recomputed
        n_plans0 = len(ledger.calls)
        pol = gw.policy()
        space = rb.candidate_space(test)
        init = float(space.cost[:, space.initial_state].sum())
        out["submit"] = submit_checked(label, gw, pool, ledger, fmt, parity_judge, test,
                                       G_BUDGETS, init)

        # ---- serve: Poisson arrivals through the robatch policy
        base = float(rb.cost_model.state_cost(0, rb.calibrations[0].b_effect, test).mean())
        cfg = OnlineConfig(budget_per_s=G_QPS * base * G_BUDGET_X, window_s=G_WINDOW_S)
        arrivals = poisson_arrivals(np.random.default_rng(SEED), G_QPS, G_SECONDS, test,
                                    repeat_frac=G_REPEAT)
        orig_ws, orig_pw, orig_step = pol.window_space, pol.plan_window, OnlineRobatchServer.step

        def window_space(query_idx):
            t = {}
            sp = rb.candidate_space(query_idx, timings=t)
            win["router"] += t["router"]
            win["proxy"] += t["proxy"]
            return sp

        def plan_window(sp, query_idx, budget, caps=None):
            t0 = time.perf_counter()
            try:
                return orig_pw(sp, query_idx, budget, caps=caps)
            finally:
                win["greedy"] += time.perf_counter() - t0

        def step(srv, now=None):
            win.update(router=0.0, proxy=0.0, greedy=0.0)
            n0 = len(ledger.calls)
            rows = None
            if len(steps) == G_TRACE_WINDOW:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    rep = orig_step(srv, now)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                rows = device_rows(prof)
            else:
                t0 = time.perf_counter()
                rep = orig_step(srv, now)
                wall = time.perf_counter() - t0
            steps.append(dict(t=rep.t, wall_s=wall, groups=list(rep.group_models),
                              sched_s=win["router"] + win["proxy"] + win["greedy"],
                              split={k: win[k] for k in ("router", "proxy", "greedy")},
                              invocations=len(ledger.calls) - n0, rows=rows))
            return rep

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()            # the profiler's start-up, before the serve
        pol.window_space, pol.plan_window = window_space, plan_window
        OnlineRobatchServer.step = step
        n_serve0 = len(ledger.calls)
        try:
            t0 = time.perf_counter()
            stats = gw.serve(arrivals, cfg)
            serve_s = time.perf_counter() - t0
        finally:
            OnlineRobatchServer.step = orig_step
            pol.window_space, pol.plan_window = orig_ws, orig_pw
    srv = gw.server
    engines = [(m.engine.n_prefill_calls, m.engine.n_decode_calls, m.engine.decode_block,
                m.engine.model.cfg.n_layers) for m in pool]
    want_paged = sum(d * K * L for _, d, K, L in engines)
    want_flash = sum(p * L for p, _, _, L in engines)
    print(f"[{label}] launches: paged {counts['paged_attention']} (decode dispatches x K x "
          f"layers {want_paged}), flash {counts['flash_attention']} (prefills x layers "
          f"{want_flash}); engines' (prefills, dispatches): "
          f"{[(p, d) for p, d, _, _ in engines]}; graphs "
          f"{[len(m.engine._graphs.graphs) for m in pool]}, replays "
          f"{[m.engine._graphs.n_replays for m in pool]}")
    check(counts["paged_attention"] == want_paged > 0,
          f"{label}: {counts['paged_attention']} paged launches, expected {want_paged}")
    check(counts["flash_attention"] == want_flash > 0,
          f"{label}: {counts['flash_attention']} flash launches, expected {want_flash}")
    check(all(m.engine._graphs.n_replays > 0 for m in pool),
          f"{label}: a member's engine replayed no graph")
    widths = {}
    for m, (p, d, K, L) in zip(pool, engines):
        w = widths.setdefault(m.engine.model.cfg.head_dim, dict(flash_attention=0,
                                                                 paged_attention=0))
        w["flash_attention"] += p * L
        w["paged_attention"] += d * K * L
    out["launches_by_width"] = widths

    # ---- each kernel against its plain version on this path's own inputs:
    # the first eager call at each member's head width (a prefill of a b=1
    # label's prompt, a decode dispatch's first layer)
    recorded = {("flash_attention", D): c for D, c in flash_calls.items()}
    recorded |= {("paged_attention", D): c for D, c in paged_calls.items()}
    check(sorted(recorded) == sorted((n, D) for D in widths
                                     for n in ("flash_attention", "paged_attention")),
          f"{label}: inputs recorded at {sorted(recorded)}, widths {sorted(widths)}")
    pair = {"flash_attention": (flash_mod.flash_attention_cuda, flash_mod.flash_attention_plain),
            "paged_attention": (paged_mod.paged_attention_cuda, paged_mod.paged_attention_plain)}
    out["kernels_vs_plain"] = []
    for (name, D), (args, kw) in sorted(recorded.items()):
        kw = {"causal": kw.get("causal", True), "window": kw.get("window")} \
            if name == "flash_attention" else {}
        fn, ref_fn = pair[name]
        got, want = fn(*args, **kw), ref_fn(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        tol = TOL[args[0].dtype]
        print(f"[{label}] {name} at D={D} on this path's inputs, q {list(args[0].shape)} "
              f"{str(args[0].dtype)[6:]}: max|err| {err:.3g}, row-relative {rel:.3g} (tol {tol})")
        check(err <= tol and rel <= tol, f"{label}: {name} at D={D}: max abs err {err:.3g}, "
              f"row-relative {rel:.3g} > {tol}")
        out["kernels_vs_plain"].append(dict(name=name, head_dim=D, q=list(args[0].shape),
                                            max_abs_err=err, row_rel_err=rel, tol=tol))

    # ---- the serve's checks
    shed = sum(w.n_shed for w in srv.windows)
    print(f"[{label}] serve: {stats.summary()}; {len(srv.windows)} windows in {serve_s:.2f}s")
    check(stats.n_submitted == len(arrivals) and stats.n_completed == stats.n_submitted
          and stats.n_dropped == shed, f"{label}: completed + shed != arrivals")
    check(stats.n_cache_hits > 0, f"{label}: no repeat hit the response cache")
    check(all(br.state.value == "closed" for br in srv.breakers),
          f"{label}: a breaker ended {[br.state.value for br in srv.breakers]}")
    check(sum(w.n_failed for w in srv.windows) == 0 and stats.n_reroutes == 0,
          f"{label}: a dispatch failed")
    torch.cuda.synchronize()
    calls = ledger.calls[n_serve0:]
    both = [w for w in srv.windows if set(w.group_models) == {0, 1}]
    overlap = sum(1 for a in calls for b in calls
                  if a["k"] == 0 and b["k"] == 1 and a["thread"] != b["thread"]
                  and a["t0"] < b["t1"] and b["t0"] < a["t1"])
    print(f"[{label}] {len(both)} windows dispatched to both members; {overlap} pairs of a "
          f"Qwen1.5-0.5B and a Qwen1.5-4B invocation overlapped in time on two threads")
    check(both and overlap > 0, f"{label}: the two members never ran concurrently")
    for st in steps:
        sp = st["split"]
        print(f"[{label}]   window t={st['t']:.2f}s groups {st['groups']}: scheduler "
              f"{1e3 * st['sched_s']:.3f} ms (router {1e3 * sp['router']:.3f}, proxy "
              f"{1e3 * sp['proxy']:.3f}, greedy {1e3 * sp['greedy']:.3f}), the rest of the "
              f"window (caches, admission, dispatch) {1e3 * (st['wall_s'] - st['sched_s']):.1f}"
              f" ms" + (" [traced]" if st["rows"] is not None else ""))
    busy = [s for s in steps if s["rows"] is not None]
    if busy:
        st = busy[0]
        dev_ms = device_total_ms(st["rows"])
        print(f"[{label}] traced window t={st['t']:.2f}s (groups {st['groups']}): device busy "
              + ("not measured" if dev_ms is None else
                 f"{dev_ms:.3f} ms of {1e3 * st['wall_s']:.3f} ms "
                 f"({100 * dev_ms / (1e3 * st['wall_s']):.1f}%)"))
        for name, ms in top_device(st["rows"], n=6):
            print(f"[{label}]   {ms:.4f} ms: {name}")
        out["traced_window"] = dict(t=st["t"], groups=st["groups"], wall_ms=1e3 * st["wall_s"],
                                    device_ms=dev_ms, top=top_device(st["rows"], n=6))
    busy_steps = [s for s in steps if s["groups"]]
    sched = [s["sched_s"] for s in busy_steps]
    rest = [s["wall_s"] - s["sched_s"] for s in busy_steps if s["rows"] is None]
    if sched and rest:
        print(f"[{label}] windows that dispatched: scheduler {1e3 * np.mean(sched):.3f} ms a "
              f"window (max {1e3 * max(sched):.3f}), the rest {1e3 * np.mean(rest):.1f} ms "
              f"(untraced): the scheduler {100 * sum(sched) / (sum(sched) + sum(rest)):.2f}% "
              f"of those windows")

    # ---- one plan group of each member served again: the same greedy tokens
    again = []
    for k in range(len(pool)):
        first = next((c for c in ledger.calls[n_plans0:] if c["k"] == k), None)
        check(first is not None, f"{label}: {pool[k].name} served no group")
        n0 = len(ledger.calls)
        pool[k].invoke_batch(wl, first["idx"])
        redo = ledger.calls[n0]
        again.append(redo["out"] == first["out"] and redo["tokens"] == first["tokens"])
    print(f"[{label}] one group of each member served again: greedy tokens identical {again}")
    check(all(again), f"{label}: a group served again gave other tokens")
    out["serve"] = dict(arrivals=len(arrivals), completed=stats.n_completed, shed=shed,
                        cache_hits=stats.n_cache_hits, windows=len(srv.windows),
                        seconds=serve_s, mean_utility=stats.mean_utility,
                        total_cost=stats.total_cost, windows_both_members=len(both),
                        overlapping_pairs=overlap,
                        steps=[{k: v for k, v in s.items() if k != "rows"} for s in steps])
    out["launches"] = dict(counts)
    out["engines"] = engines
    return out, recorded


# ---- path h: training, the trained tiny pool and the HTTP front end -------
H_STEPS, H_BATCH, H_SEQ = 12, 8, 512    # h1: full-width Qwen1.5-0.5B steps of B x S tokens
H_CKPT_EVERY = 6
H_TURN_STEPS = 2                        # steps a leg of the remat turns: none, block, block, none
H_PARITY_STEPS = 3                      # h2: fp32 steps, through the kernels and the plain versions
H_POOL_STEPS = 300                      # h3: the tiny pool's training steps (the JAX default)
H_POOL_QUERIES = 48                     # h3: the task's train and test queries each
H_CORESET = 8
H_BUDGETS = (1.5, 4.0)                  # h3: submit budgets, times the initial plan's cost
H_HTTP_QUERIES = (0, 5, 11, 23)         # h4: positions in the test set asked over HTTP
H_WINDOW_S = 0.05                       # h4: the live server's admission window
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # backward kernel vs plain, row-relative
# name fragments of the recurrences' backward kernels (every launch of one
# call: the forward's chain of chunk states, the reverse chain, WKV6's ∂u)
RECURRENT_BWD_KERNELS = {"wkv6_bwd": ("wkv6_bwd",), "rglru_bwd": ("rglru_bwd",)}
# every __global__ kernel of the recurrences' backwards, each reported by ptxas
RECURRENT_BWD_PTXAS = ("wkv6_bwd_states_kernel", "wkv6_bwd_kernel", "wkv6_bwd_du_kernel",
                       "rglru_bwd_states_kernel", "rglru_bwd_kernel")
BWD_KERNELS = ("bwd_dq_tc_kernel", "bwd_dkdv_tc_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel",
               "bwd_dq_wide_kernel", "bwd_dkdv_wide_kernel", "bwd_dq_wg2_kernel",
               "bwd_dkdv_wg2_kernel")
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
                         r'(,[a-zA-Z0-9_]+="[^"]*")*\})? (-?[0-9.e+-]+|\+Inf|NaN)$')


def bwd_work(q, k, window):
    """Bytes (q, k, v and dO read once, dq, dk, dv written once) and FLOPs
    (five products of 2·D a visible causal pair: S, dP, dV, dK, dQ) of one
    backward call."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    i = np.arange(S)
    pairs = int(np.minimum(i + 1, window).sum() if window else (i + 1).sum())
    n_bytes = q.element_size() * (3 * B * S * H * D + 4 * B * S * Hk * D)
    return n_bytes, 10 * D * pairs * B * H


def parse_prometheus(text):
    """Samples of a Prometheus text page as {line name with labels: value};
    every line is a comment or a well-formed sample, and every sample's
    family is declared."""
    typed, samples = set(), {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        check(PROM_SAMPLE.match(line), f"/metrics: unparseable sample {line!r}")
        key, value = line.rsplit(" ", 1)
        name = re.split(r"[{ ]", key)[0]
        check(name in typed or re.sub(r"_(bucket|sum|count)$", "", name) in typed,
              f"/metrics: sample {name} of no declared family")
        samples[key] = float(value)
    return samples


def train_qwen(label, dev, main_path, ckpt_dir):
    """h1: full-width Qwen1.5-0.5B trained in bf16 for ``H_STEPS`` steps of
    ``H_BATCH`` x ``H_SEQ`` tokens from ``synthetic_lm_stream`` through
    ``ShardedPipeline``, as ``launch/train.py`` builds it (``remat="none"``,
    AdamW with the cosine schedule, clip 1.0), checkpointing every
    ``H_CKPT_EVERY`` steps; a fresh ``Trainer`` restores the last step bit
    for bit.  Then step times in turns against ``remat="block"`` and one
    traced step.  Returns what it measured and the first backward call's
    inputs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShardingConfig, get_arch
    from repro_torch.data.pipeline import ShardedPipeline, synthetic_lm_stream
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw, cosine_schedule
    from repro_torch.training.train_loop import Trainer, make_train_step, train_state

    cfg = get_arch("qwen1.5-0.5b")
    held = torch.cuda.memory_allocated()     # what earlier paths still hold
    model = Model(cfg, ShardingConfig(remat="none"), device=dev)
    opt = adamw(cosine_schedule(3e-3, warmup=10, total=H_STEPS), grad_clip=1.0)
    tr = Trainer(model, opt, ckpt_dir=ckpt_dir, ckpt_every=H_CKPT_EVERY)
    params, state, start = tr.restore_or_init(torch.Generator(device=dev).manual_seed(SEED))
    check(start == 0, f"{label}: a checkpoint was there before training")
    pipe = ShardedPipeline(synthetic_lm_stream(cfg.vocab_size, H_BATCH, H_SEQ, seed=SEED),
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    with main_path(label, ("flash_attention", "flash_attention_bwd"), autograd=True) as counts, \
            recording_backward(flash_mod) as bwd_calls:
        t0 = time.perf_counter()
        params, state, hist = tr.fit(params, state, (b for _, b in zip(range(H_STEPS), pipe)),
                                     log_every=1)
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    step_s = np.diff([0.0] + [h["time"] for h in hist])
    print(f"[{label}] {cfg.name} {model.param_count() / 1e9:.3f} B parameters, bf16, "
          f"{H_STEPS} steps of {H_BATCH} x {H_SEQ} tokens in {fit_s:.1f}s (checkpoints every "
          f"{H_CKPT_EVERY} included): losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}; host-clock step seconds "
          f"{[round(float(x), 3) for x in step_s]}; peak memory {peak / 2**30:.2f} GiB (above "
          f"{held / 2**30:.2f} GiB that earlier paths hold)")
    check(len(hist) == H_STEPS and np.all(np.isfinite(losses)) and np.all(np.isfinite(norms)),
          f"{label}: a loss or grad norm is not finite")
    check(np.mean(losses[-3:]) < losses[0],
          f"{label}: the last 3 losses {losses[-3:]} are not below the first {losses[0]}")
    want = H_STEPS * cfg.n_layers
    check(counts["flash_attention"] == counts["flash_attention_bwd"] == want,
          f"{label}: flash forward {counts['flash_attention']} and backward "
          f"{counts['flash_attention_bwd']} launches, expected {want} each")

    # ---- a fresh trainer restores the last checkpoint bit for bit
    model2 = Model(cfg, ShardingConfig(remat="none"), device=dev)
    tr2 = Trainer(model2, opt, ckpt_dir=ckpt_dir, ckpt_every=H_CKPT_EVERY)
    t0 = time.perf_counter()
    p2, s2, start2 = tr2.restore_or_init(torch.Generator(device=dev).manual_seed(SEED + 1))
    restore_s = time.perf_counter() - t0
    live, back = train_state(params, state), train_state(p2, s2)
    differ = [k for k in live if k not in back or not torch.equal(live[k], back[k])]
    print(f"[{label}] a fresh Trainer restored step {start2} in {restore_s:.1f}s: "
          f"{len(back)} tensors, {len(differ)} differ from the trained state")
    check(start2 == H_STEPS and set(back) == set(live) and not differ,
          f"{label}: restored step {start2}, differing tensors {differ[:5]}")
    del model2, tr2, p2, s2, back, live
    torch.cuda.empty_cache()

    # ---- step time in turns: remat none, block, block, none.  The model's
    # shard is the step's configuration; under remat each block's forward,
    # its flash call included, runs again in the backward
    run = {"params": params, "state": state}
    fwd_k, bwd_k = flash_mod.flash_attention_cuda, flash_mod.flash_attention_backward_cuda

    def leg(remat, steps=H_TURN_STEPS):
        model.shard = dataclasses.replace(model.shard, remat=remat)
        step = make_train_step(model, opt)
        f0, b0 = fwd_k.launches, bwd_k.launches
        r0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            batch = next(pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["params"], run["state"], m = step(run["params"], run["state"], batch)
            check(np.isfinite(float(m["loss"])), f"{label}: remat {remat}: loss not finite")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        per_step = cfg.n_layers * (2 if remat == "block" else 1)
        fwd, bwd = fwd_k.launches - f0, bwd_k.launches - b0
        check(fwd == steps * per_step and bwd == steps * cfg.n_layers,
              f"{label}: remat {remat}: {fwd} forward and {bwd} backward flash launches in "
              f"{steps} steps, expected {per_step} and {cfg.n_layers} a step")
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - r0
        return times, torch.cuda.max_memory_allocated() - held, retries

    # each mode's first step apart (the first under remat pays a one-off
    # cost), then the turns
    first = {}
    for remat in ("none", "block"):
        (t,), _, retries = leg(remat, steps=1)
        first[remat] = dict(seconds=t, alloc_retries=retries)
    turns = {"none": [], "block": []}
    peaks = {}
    for remat in ("none", "block", "block", "none"):
        times, pk, _ = leg(remat)
        turns[remat] += times
        peaks[remat] = max(peaks.get(remat, 0), pk)
    for remat, times in turns.items():
        print(f"[{label}] remat={remat}: {1e3 * np.mean(times):.1f} ms a step (host clock, "
              f"{len(times)} steps in two turns: {[round(1e3 * t, 1) for t in times]}; the "
              f"mode's first step {1e3 * first[remat]['seconds']:.1f} ms, allocator retries "
              f"{first[remat]['alloc_retries']}), peak memory {peaks[remat] / 2**30:.2f} GiB, "
              f"flash forward launches {cfg.n_layers * (2 if remat == 'block' else 1)} a step "
              f"(checked)")

    # ---- one traced step
    model.shard = dataclasses.replace(model.shard, remat="none")
    step = make_train_step(model, opt)
    batch = next(pipe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["params"], run["state"], m = step(run["params"], run["state"], batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    pipe.close()
    rows = device_rows(prof)
    dev_ms = device_total_ms(rows)
    bwd_ms = sum(e.self_device_time_total for e in rows
                 if any(n in e.key for n in BWD_KERNELS)) / 1e3
    print(f"[{label}] traced step: device busy "
          + ("not measured (no device time in the trace)" if dev_ms is None else
             f"{dev_ms:.2f} ms of {wall_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%); the "
             f"backward kernels {bwd_ms:.3f} ms ({100 * bwd_ms / dev_ms:.2f}% of the busy "
             f"time)"))
    top = top_device(rows, n=8)
    for name, ms in top:
        print(f"[{label}]   {ms:.3f} ms: {name}")
    out = dict(params=model.param_count(), losses=losses, grad_norms=norms,
               step_s=step_s.tolist(), fit_s=fit_s, peak_bytes=peak, restore_s=restore_s,
               remat_turns_s=turns, remat_first_step=first, remat_peak_bytes=peaks,
               traced_step=dict(wall_ms=wall_ms, device_ms=dev_ms, backward_ms=bwd_ms,
                                backward_calls=cfg.n_layers, top=top),
               launches=dict(counts))
    return out, bwd_calls[cfg.head_dim]


def train_parity(label, dev, main_path, plain_kernels):
    """h2: tiny-m in fp32 (head width 32) from one seeded init, trained
    ``H_PARITY_STEPS`` steps through the kernels and again through the plain
    versions (``ops`` routed to them, as the fp32 parity phases route them):
    losses within 1e-5 relative, the first step's gradients within 1e-4
    row-relative; and ``microbatches=4`` against 1 on one batch."""
    from repro_torch.config import ShardingConfig, get_arch
    from repro_torch.data.pipeline import synthetic_lm_stream
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import make_train_step, trainable

    cfg = get_arch("tiny-m")
    init = Model(cfg, ShardingConfig(remat="none"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED)).state_dict()
    stream = synthetic_lm_stream(cfg.vocab_size, 8, 128, seed=SEED + 1)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
               for _ in range(H_PARITY_STEPS)]

    def run(micro=1, steps=H_PARITY_STEPS):
        model = Model(cfg, ShardingConfig(remat="none", microbatches=micro), device=dev)
        model.load_state_dict(init)
        opt = adamw(3e-3, grad_clip=1.0)
        params = trainable(model)
        grads = torch.autograd.grad(model.loss(batches[0]), list(params.values()))
        step, st = make_train_step(model, opt), opt.init(list(params.values()))
        losses = []
        for b in batches[:steps]:
            params, st, m = step(params, st, b)
            losses.append(float(m["loss"]))
        return losses, dict(zip(params, grads))

    with main_path(label, ("flash_attention", "flash_attention_bwd"), autograd=True):
        lk, gk = run()
        l1, _ = run(micro=1, steps=1)
        l4, _ = run(micro=4, steps=1)
    with plain_kernels():
        lp, gp = run()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    grad_rel = {n: row_rel_err(gk[n], gp[n]) for n in gk}
    worst = max(grad_rel, key=grad_rel.get)
    micro_rel = abs(l4[0] - l1[0]) / abs(l1[0])
    print(f"[{label}] tiny-m fp32, {H_PARITY_STEPS} steps: losses kernels {lk}, plain {lp}, "
          f"max relative difference {loss_rel:.3g} (tol 1e-5); step-1 gradients row-relative "
          f"max {grad_rel[worst]:.3g} at {worst} (tol 1e-4); microbatches 4 vs 1: losses "
          f"{l4[0]:.6f} vs {l1[0]:.6f}, relative {micro_rel:.3g} (tol 1e-4)")
    check(loss_rel <= 1e-5, f"{label}: kernel and plain losses differ by {loss_rel:.3g}")
    check(grad_rel[worst] <= 1e-4, f"{label}: gradient {worst} differs by {grad_rel[worst]:.3g}")
    check(micro_rel <= 1e-4, f"{label}: microbatches 4 vs 1 differ by {micro_rel:.3g}")
    return dict(losses_kernels=lk, losses_plain=lp, loss_rel=loss_rel,
                grad_row_rel=grad_rel[worst], worst_grad=worst, micro_rel=micro_rel)


N_STEPS, N_BATCH, N_SEQ = 12, 4, 512    # path n: full-width RWKV6-3B, steps of B x S tokens
O_STEPS, O_BATCH, O_SEQ = 8, 2, 3072    # path o: RecurrentGemma-9B's first O_LAYERS layers
O_LAYERS = 3                            # one (rglru, rglru, local) group of its 38 layers
R_PARITY_STEPS = 3                      # phase 7: narrow recurrent models, fp32 steps
R_PEAK_LR, R_WARMUP = 3e-4, 2           # paths n and o: AdamW's cosine schedule
NODE_OF = {"wkv6": "WKV6", "rglru_scan": "RGLRU", "flash_attention": "FlashAttention"}


@contextlib.contextmanager
def recording_first_backward(cls):
    """Clone the saved tensors and the incoming gradients of the first
    backward of the autograd Function ``cls`` into ``calls`` (a list of one
    ``(saved, grads)``) by wrapping ``cls.backward``; the kernel wrapper it
    calls, whose launch counter the paths read, is left as it is."""
    orig = cls.backward
    calls = []

    def backward(ctx, *grads):
        if not calls:
            calls.append(([None if t is None else t.detach().clone() for t in ctx.saved_tensors],
                          [None if g is None else g.detach().contiguous().clone()
                           for g in grads]))
        return orig(ctx, *grads)

    cls.backward = staticmethod(backward)
    try:
        yield calls
    finally:
        cls.backward = staticmethod(orig)


def train_recurrent(label, dev, main_path, cfg, steps, batch, seq, ckpt_dir, per_step):
    """Paths n and o: ``cfg`` (full width, bf16) trained ``steps`` steps of
    ``batch`` x ``seq`` tokens from ``synthetic_lm_stream`` through
    ``ShardedPipeline``, as path h builds its trainer (``remat="none"``,
    AdamW with the cosine schedule to ``R_PEAK_LR`` after ``R_WARMUP``
    steps, clip 1.0), one checkpoint after the last step.  ``per_step``
    gives each kernel's launches a step (the backward kernels' too): every
    count must be exactly ``steps`` times it, and the autograd nodes of each
    forward as many as its launches.  The finite losses must fall: the last
    3's mean below every loss before them (a run that climbs or stalls at
    the end fails).  A fresh ``Trainer`` then restores the checkpoint bit
    for bit (into its fresh state in place: two copies of a ~30 GB state fit
    the card, three would not), and the restored model takes one step under
    ``remat="none"`` and one under ``"block"`` (forward launches twice a
    step, backward as many), and one traced step.  Returns
    what it measured and the first backward call of each kernel, as
    (args, kwargs) of its ``*_cuda`` wrapper, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShardingConfig
    from repro_torch.data.pipeline import ShardedPipeline, synthetic_lm_stream
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import rwkv6_scan as wkv6_mod
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw, cosine_schedule
    from repro_torch.training.train_loop import Trainer, make_train_step, train_state

    gc.collect()                             # engines of earlier paths left in cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()     # what earlier paths still hold
    opt = adamw(cosine_schedule(R_PEAK_LR, warmup=R_WARMUP, total=steps), grad_clip=1.0)
    t0 = time.perf_counter()
    model = Model(cfg, ShardingConfig(remat="none"), device=dev)
    tr = Trainer(model, opt, ckpt_dir=ckpt_dir, ckpt_every=steps)
    params, state, start = tr.restore_or_init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(start == 0, f"{label}: a checkpoint was there before training")
    n_params = model.param_count()
    pipe = ShardedPipeline(synthetic_lm_stream(cfg.vocab_size, batch, seq, seed=SEED),
                           device=dev)
    nodes = {}
    torch.cuda.reset_peak_memory_stats()
    with main_path(label, tuple(per_step), autograd=True, nodes=nodes) as counts, \
            recording_first_backward(wkv6_mod.WKV6) as wkv6_calls, \
            recording_first_backward(rglru_mod.RGLRU) as rglru_calls, \
            recording_backward(flash_mod) as flash_calls:
        t0 = time.perf_counter()
        params, state, hist = tr.fit(params, state, (b for _, b in zip(range(steps), pipe)),
                                     log_every=1)
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    step_s = np.diff([0.0] + [h["time"] for h in hist])
    print(f"[{label}] {cfg.name} ({cfg.n_layers} layers) {n_params / 1e9:.3f} B parameters, "
          f"bf16, init {init_s:.1f}s; {steps} steps of {batch} x {seq} tokens in {fit_s:.1f}s "
          f"(the checkpoint after the last step included): losses "
          f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}; "
          f"host-clock step seconds {[round(float(x), 3) for x in step_s]}; peak memory "
          f"{peak / 2**30:.2f} GiB (above {held / 2**30:.2f} GiB that earlier paths hold)")
    check(len(hist) == steps and np.all(np.isfinite(losses)) and np.all(np.isfinite(norms)),
          f"{label}: a loss or grad norm is not finite")
    check(np.mean(losses[-3:]) < min(losses[:-3]),
          f"{label}: the last 3 losses {losses[-3:]} do not average below the lowest before "
          f"them, {min(losses[:-3])}")
    want = {k: steps * n for k, n in per_step.items()}
    check({k: counts[k] for k in want} == want,
          f"{label}: launches {counts}, expected {want}")
    want_nodes = {NODE_OF[k]: n for k, n in want.items() if k in NODE_OF}
    check({k: nodes[k] for k in want_nodes} == want_nodes and sum(nodes.values())
          == sum(want_nodes.values()), f"{label}: autograd nodes {nodes}, expected {want_nodes}")

    # ---- a fresh trainer restores the checkpoint bit for bit, read into
    # its fresh state in place; the trained one is then freed
    t0 = time.perf_counter()
    model2 = Model(cfg, ShardingConfig(remat="none"), device=dev)
    tr2 = Trainer(model2, opt, ckpt_dir=ckpt_dir, ckpt_every=steps)
    p2, s2, start2 = tr2.restore_or_init(torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live, back = train_state(params, state), train_state(p2, s2)
    differ = [k for k in live if k not in back or not torch.equal(live[k], back[k])]
    print(f"[{label}] a fresh Trainer restored step {start2} in {restore_s:.1f}s: {len(back)} "
          f"tensors, {len(differ)} differ from the trained state")
    check(start2 == steps and set(back) == set(live) and not differ,
          f"{label}: restored step {start2}, differing tensors {differ[:5]}")
    del live, back, params, state, model, tr
    model, tr, params, state = model2, tr2, p2, s2
    del model2, tr2, p2, s2
    torch.cuda.empty_cache()

    # ---- one step under remat "none", one under "block"
    remat_steps = {}
    for remat in ("none", "block"):
        model.shard = dataclasses.replace(model.shard, remat=remat)
        step = make_train_step(model, opt)
        before = {k: main_path.kernel[k].launches for k in per_step}
        b = next(pipe)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        check(np.isfinite(float(m["loss"])), f"{label}: remat {remat}: loss not finite")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        got = {k: main_path.kernel[k].launches - before[k] for k in per_step}
        expect = {k: n * (2 if remat == "block" and not k.endswith("_bwd") else 1)
                  for k, n in per_step.items()}
        check(got == expect, f"{label}: remat {remat}: a step launched {got}, expected {expect}")
        remat_steps[remat] = dict(seconds=took, peak_bytes=torch.cuda.max_memory_allocated()
                                  - held, launches=got)
        print(f"[{label}] remat={remat}: a step {1e3 * took:.1f} ms (host clock), peak memory "
              f"{remat_steps[remat]['peak_bytes'] / 2**30:.2f} GiB, launches {got} (checked)")

    # ---- one traced step
    model.shard = dataclasses.replace(model.shard, remat="none")
    step = make_train_step(model, opt)
    b = next(pipe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    pipe.close()
    rows = device_rows(prof)
    dev_ms = device_total_ms(rows)
    frags = {**RECURRENT_BWD_KERNELS, "flash_attention_bwd": BWD_KERNELS}
    bwd_ms = {k: sum(e.self_device_time_total for e in rows
                     if any(f in e.key for f in frags[k])) / 1e3
              for k in per_step if k in frags}
    print(f"[{label}] traced step: device busy "
          + ("not measured (no device time in the trace)" if dev_ms is None else
             f"{dev_ms:.2f} ms of {wall_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%); the "
             f"backward kernels {bwd_ms} ms"))
    top = top_device(rows, n=8)
    for name, ms in top:
        print(f"[{label}]   {ms:.3f} ms: {name}")
    del params, state, model, tr, step
    torch.cuda.empty_cache()
    calls = {}
    if wkv6_calls:
        (r, k, v, w, u, s0), (d_out, d_state) = wkv6_calls[0]
        calls["wkv6_bwd"] = ((r, k, v, w, u, d_out, s0, d_state), {})
    if rglru_calls:
        (x, a_log, h0), (d_h, d_hT) = rglru_calls[0]
        calls["rglru_bwd"] = ((x, a_log, d_h, h0, d_hT), {})
    for width, (args, kw) in flash_calls.items():
        calls["flash_attention_bwd"] = (tuple(args), kw)
    out = dict(params=n_params, layers=cfg.n_layers, losses=losses, grad_norms=norms,
               step_s=step_s.tolist(), fit_s=fit_s, init_s=init_s, peak_bytes=peak,
               restore_s=restore_s, remat_steps=remat_steps,
               traced_step=dict(wall_ms=wall_ms, device_ms=dev_ms, backward_ms=bwd_ms,
                                backward_calls={k: n for k, n in per_step.items()
                                                if k in frags},
                                top=top),
               launches=dict(counts), nodes=nodes)
    return out, calls


def recurrent_train_parity(label, dev, main_path, plain_kernels, cfg, batch, seq):
    """Phase 7: a narrow ``cfg`` in fp32 from one seeded init, trained
    ``R_PARITY_STEPS`` steps through the kernels and again through the
    plain versions (``ops`` routed to them): losses within 1e-5 relative,
    the first step's gradients within 1e-4 row-relative, as h2."""
    from repro_torch.config import ShardingConfig
    from repro_torch.data.pipeline import synthetic_lm_stream
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import make_train_step, trainable

    init = Model(cfg, ShardingConfig(remat="none"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED)).state_dict()
    stream = synthetic_lm_stream(cfg.vocab_size, batch, seq, seed=SEED + 1)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
               for _ in range(R_PARITY_STEPS)]

    def run():
        model = Model(cfg, ShardingConfig(remat="none"), device=dev)
        model.load_state_dict(init)
        opt = adamw(3e-3, grad_clip=1.0)
        params = trainable(model)
        grads = torch.autograd.grad(model.loss(batches[0]), list(params.values()))
        step, st = make_train_step(model, opt), opt.init(list(params.values()))
        losses = []
        for b in batches:
            params, st, m = step(params, st, b)
            losses.append(float(m["loss"]))
        return losses, dict(zip(params, grads))

    expect = tuple(k for k in ("wkv6", "wkv6_bwd", "rglru_scan", "rglru_bwd", "flash_attention",
                               "flash_attention_bwd")
                   if (k.startswith("wkv6") and cfg.family == "ssm")
                   or (not k.startswith("wkv6") and cfg.family == "hybrid"))
    with main_path(label, expect, autograd=True):
        lk, gk = run()
    with plain_kernels():
        lp, gp = run()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    grad_rel = {n: row_rel_err(gk[n], gp[n]) for n in gk}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[{label}] {cfg.name} narrowed (d_model {cfg.d_model}, {cfg.n_layers} layers) fp32, "
          f"{R_PARITY_STEPS} steps of {batch} x {seq}: losses kernels {lk}, plain {lp}, max "
          f"relative difference {loss_rel:.3g} (tol 1e-5); step-1 gradients row-relative max "
          f"{grad_rel[worst]:.3g} at {worst} (tol 1e-4)")
    check(loss_rel <= 1e-5, f"{label}: kernel and plain losses differ by {loss_rel:.3g}")
    check(grad_rel[worst] <= 1e-4, f"{label}: gradient {worst} differs by {grad_rel[worst]:.3g}")
    return dict(losses_kernels=lk, losses_plain=lp, loss_rel=loss_rel,
                grad_row_rel=grad_rel[worst], worst_grad=worst)


def tiny_pool_path(label, dev, main_path):
    """h3 and h4: the tiny pool trained on the card (``build_tiny_pool``, the
    JAX package's steps, prices and members), ``Gateway.fit`` with the MLP
    router on the card and ``submit()`` at two budgets judged by the task's
    own judge; then the HTTP front end over that pool on loopback, its unary
    answers held to ``Gateway.serve``'s in-process ones.  Returns what it
    measured and the first backward call's inputs."""
    import urllib.request

    from repro_torch.api import RunSpec
    from repro_torch.api.gateway import Gateway
    from repro_torch.core.router import MLPRouter
    from repro_torch.http.protocol import completion_response
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.serving.online import OnlineConfig
    from repro_torch.serving.tinypool import build_tiny_pool

    out = {}
    expect = ("flash_attention", "flash_attention_bwd", "paged_attention")
    with main_path(f"{label}-train-fit-submit", expect, autograd=True) as counts, \
            recording_backward(flash_mod) as bwd_calls:
        t0 = time.perf_counter()
        wl, pool, fmt = build_tiny_pool(np.random.default_rng(SEED), steps=H_POOL_STEPS,
                                        n_train=H_POOL_QUERIES, n_test=H_POOL_QUERIES,
                                        device=dev)
        train_s = time.perf_counter() - t0
        out["members"] = {}
        for m in pool:
            log = m.engine.model.train_log
            ls = log["losses"]
            print(f"[{label}] trained {m.name} ({m.engine.model.param_count() / 1e6:.2f} M "
                  f"parameters, fp32): loss {ls[0]:.4f} -> {np.mean(ls[-20:]):.4f} (mean of "
                  f"the last 20) in {log['seconds']:.1f}s, {len(ls)} steps")
            check(np.all(np.isfinite(ls)) and np.mean(ls[-20:]) < ls[0],
                  f"{label}: {m.name}'s loss is not finite or did not fall")
            out["members"][m.name] = dict(first=ls[0], last20=float(np.mean(ls[-20:])),
                                          seconds=log["seconds"])
        ledger = Ledger(pool)
        test = wl.subset_indices("test")
        gw = Gateway(pool, wl, spec=RunSpec(router="mlp", coreset_size=H_CORESET,
                                            grid_multiple=2, seed=SEED), device=dev)
        t0 = time.perf_counter()
        gw.fit()
        fit_s = time.perf_counter() - t0
        rb = gw.robatch
        check(isinstance(rb.router, MLPRouter) and rb.router.device == dev,
              f"{label}: the MLP router is not on {dev}")
        for c in rb.calibrations:
            u = c.u_mean_at
            print(f"[{label}]   {pool[c.k].name}: accuracy at b=1 {u.get(1, float('nan')):.4f}, "
                  f"at b_effect={c.b_effect} {u.get(c.b_effect, float('nan')):.4f}; profiled "
                  f"means { {b: round(x, 4) for b, x in u.items()} }")
        space = rb.candidate_space(test)
        init = float(space.cost[:, space.initial_state].sum())
        subs = submit_checked(label, gw, pool, ledger, fmt, pool[0].task.judge, test,
                              H_BUDGETS, init)
        for sub in subs:
            print(f"[{label}] exact cost / the plan's estimate at ${sub['budget']:.8f}: "
                  f"{sub['exact_cost'] / sub['est_cost']:.4f}")
    n_layers = sum(m.engine.model.cfg.n_layers for m in pool)
    print(f"[{label}] pool trained in {train_s:.1f}s, fit {fit_s:.1f}s; flash backward "
          f"launches {counts['flash_attention_bwd']} (steps x layers over the three: "
          f"{H_POOL_STEPS * n_layers})")
    check(counts["flash_attention_bwd"] == H_POOL_STEPS * n_layers,
          f"{label}: {counts['flash_attention_bwd']} backward launches, expected "
          f"{H_POOL_STEPS * n_layers}")
    out.update(train_s=train_s, fit_s=fit_s, submit=subs, launches=dict(counts),
               calibrations=[dict(member=pool[c.k].name, b_effect=c.b_effect,
                                  u_mean_at={int(b): float(x) for b, x in c.u_mean_at.items()})
                             for c in rb.calibrations])

    # ---- h4: the HTTP front end over the trained pool, on loopback
    def post(base, body):
        req = urllib.request.Request(base + "/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    cfg = OnlineConfig(budget_per_s=1e6, window_s=H_WINDOW_S, realtime=True)
    with main_path(f"{label}-http", ("flash_attention", "paged_attention")):
        fe = gw.serve_http(cfg, policy="robatch", host="127.0.0.1", port=0)
        try:
            base = f"http://127.0.0.1:{fe.port}"
            with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
                models = [m["id"] for m in json.loads(r.read())["data"]]
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            unary = []
            for q in H_HTTP_QUERIES:       # sequential: each rides its own window
                with post(base, {"messages": [{"role": "user", "content": "x"}],
                                 "query_idx": q}) as r:
                    body = json.loads(r.read())
                body["robatch"].pop("latency_s")
                unary.append(body)
            frames = []
            with post(base, {"messages": [{"role": "user", "content": "x"}],
                             "query_idx": H_HTTP_QUERIES[0], "stream": True}) as r:
                for line in r:
                    line = line.strip()
                    if line.startswith(b"data: "):
                        payload = line[len(b"data: "):]
                        frames.append("DONE" if payload == b"[DONE]" else json.loads(payload))
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                metrics = r.read().decode()
        finally:
            fe.stop()
    check(models == [m.name for m in pool], f"{label}-http: /v1/models lists {models}")
    check(health["status"] == "ok", f"{label}-http: /healthz says {health['status']}")
    check(frames and frames[-1] == "DONE", f"{label}-http: the stream did not end in [DONE]")
    streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in frames[:-1])
    check(streamed == unary[0]["choices"][0]["message"]["content"],
          f"{label}-http: streamed {streamed!r}, unary "
          f"{unary[0]['choices'][0]['message']['content']!r}")
    samples = parse_prometheus(metrics)

    def total(prefix):
        return sum(v for k, v in samples.items() if k.startswith(prefix))

    sent = {"/v1/chat/completions": len(H_HTTP_QUERIES) + 1, "/v1/models": 1, "/healthz": 1}
    counted = {p: total(f'robatch_http_requests_total{{path="{p}"') for p in sent}
    completed = total("robatch_requests_total{")
    print(f"[{label}-http] /v1/models {models}; /healthz {health['status']}; "
          f"{len(H_HTTP_QUERIES)} unary answers "
          f"{[b['choices'][0]['message']['content'] for b in unary]} by "
          f"{[b['model'] for b in unary]}; the stream's {len(frames)} frames give {streamed!r}; "
          f"/metrics: {len(samples)} samples, HTTP requests by path {counted}, completed "
          f"requests {completed}; threads leaked at stop {fe.threads_leaked}")
    check(counted == sent and completed == len(H_HTTP_QUERIES) + 1,
          f"{label}-http: /metrics counts {counted} and {completed} completed, sent {sent}")
    check(not fe.threads_leaked, f"{label}-http: stop() leaked {fe.threads_leaked}")
    # the same queries through Gateway.serve in process, each in its own window
    gw.serve([(i * H_WINDOW_S * 2, int(test[q])) for i, q in enumerate(H_HTTP_QUERIES)],
             OnlineConfig(budget_per_s=1e6, window_s=H_WINDOW_S))
    by_rid = {r.rid: r for r in gw.server.completed}
    same = []
    for rid, body in enumerate(unary):
        req = by_rid[rid]
        want = completion_response(req, pool[req.model].name, wl)
        want["robatch"].pop("latency_s")
        same.append(body == want)
    print(f"[{label}-http] unary bodies equal to Gateway.serve's in process (latency left out): "
          f"{same}")
    check(all(same), f"{label}-http: an HTTP answer differs from the in-process one")
    out["http"] = dict(models=models, unary=[b["choices"][0]["message"]["content"]
                                             for b in unary], streamed=streamed,
                       requests_by_path=counted, completed=completed)
    return out, bwd_calls[pool[0].engine.model.cfg.head_dim], gw


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.config import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import rwkv6_scan as wkv6_mod
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import ServingEngine

    # name -> (module, kernel wrapper, plain version); ops.<name> dispatches
    kern = {"flash_attention": (flash_mod, "flash_attention_cuda", "flash_attention_plain"),
            "paged_attention": (paged_mod, "paged_attention_cuda", "paged_attention_plain"),
            "decode_attention": (decode_mod, "decode_attention_cuda", "decode_attention_plain"),
            "wkv6": (wkv6_mod, "wkv6_cuda", "wkv6_plain"),
            "rglru_scan": (rglru_mod, "rglru_cuda", "rglru_plain")}
    # the backwards are reached through the autograd Functions, not ops entry points
    wrapped = {**kern, "flash_attention_bwd": (flash_mod, "flash_attention_backward_cuda",
                                               "flash_attention_backward_plain"),
               "wkv6_bwd": (wkv6_mod, "wkv6_backward_cuda", "wkv6_backward_plain"),
               "rglru_bwd": (rglru_mod, "rglru_backward_cuda", "rglru_backward_plain")}
    kernel = {n: getattr(m, c) for n, (m, c, _) in wrapped.items()}
    plain = {n: getattr(m, p) for n, (m, _, p) in wrapped.items()}
    flash_kernel, flash_plain = kernel["flash_attention"], plain["flash_attention"]
    paged_kernel, paged_plain = kernel["paged_attention"], plain["paged_attention"]
    decode_kernel, decode_plain = kernel["decode_attention"], plain["decode_attention"]
    wkv6_kernel, wkv6_plain = kernel["wkv6"], plain["wkv6"]
    rglru_kernel, rglru_plain = kernel["rglru_scan"], plain["rglru_scan"]
    bwd_kernel, bwd_plain = kernel["flash_attention_bwd"], plain["flash_attention_bwd"]
    wkv6_bwd_kernel, wkv6_bwd_plain = kernel["wkv6_bwd"], plain["wkv6_bwd"]
    rglru_bwd_kernel, rglru_bwd_plain = kernel["rglru_bwd"], plain["rglru_bwd"]
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False        # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    results = {"cases": []}

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])
    results["nvidia_smi"] = smi[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(f'{n} {s:.1f}s' for n, s in took.items())}; "
          f"wall {build_s:.1f}s")
    d128_seen, d192_seen, wide_bwd_seen, rec_bwd_seen = set(), set(), set(), set()
    for name in build.SOURCES:
        log = Path(f"{build.library_path(name)}.log")
        if log.exists():
            entry = ""
            for line in log.read_text().splitlines():
                m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)",
                              line)
                if m:
                    entry = m[1]
                elif "Used" in line or "spill" in line:
                    line = line.replace("ptxas info    : ", "").strip()
                    print(f"[build] {name}: {entry}: {line}")
                    results.setdefault("ptxas", []).append(f"{entry}: {line}")
                    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                    paged128 = re.search(PAGED_D128, entry)
                    if paged128 and "Used" in line:
                        d128_seen.add(paged128[1])
                    d192 = [v for k, v in D192.items() if k in entry]
                    if d192 and "Used" in line:
                        d192_seen.update(d192)
                    if (name == "flash_attention_bwd" and "wide_kernel" in entry
                            and "Used" in line):
                        wide_bwd_seen.add(entry)
                    rec_bwd_seen.update(k for k in RECURRENT_BWD_PTXAS
                                        if k in entry and "Used" in line)
                    redesigned = (name in ("rwkv6_scan", "rglru_scan", "flash_attention_bwd",
                                           "rwkv6_scan_bwd", "rglru_scan_bwd")
                                  or "decode_wide" in entry or paged128 or d192)
                    check(not redesigned or spill is None or spill[1] == spill[2] == "0",
                          f"ptxas spills in {entry}: {line}")
    check(d128_seen == {"f", "13__nv_bfloat16"},
          f"ptxas reported no D=128 paged instantiation for some dtype: {d128_seen}")
    check(d192_seen == set(D192.values()),
          f"ptxas reported no D=192 instantiation of {set(D192.values()) - d192_seen}")
    check(rec_bwd_seen == set(RECURRENT_BWD_PTXAS),
          f"ptxas reported no {set(RECURRENT_BWD_PTXAS) - rec_bwd_seen} of the recurrences' "
          f"backwards")
    # the fp32 D=256 backward's two CUDA-core kernels
    check(len(wide_bwd_seen) == 2 and all(any(k in e for e in wide_bwd_seen)
                                          for k in ("bwd_dq_wide", "bwd_dkdv_wide")),
          f"ptxas reported {sorted(wide_bwd_seen)} of the fp32 D=256 backward's two kernels")
    results["build_s"] = build_s
    hgmma = sass_counts("flash_attention", lambda op: op.startswith("HGMMA"))
    tc_hgmma = {int(re.search(r"flash_tc_kernelILi(\d+)E", f)[1]): n
                for f, n in hgmma.items() if "flash_tc_kernel" in f}
    print(f"[build] flash_attention SASS: HGMMA instructions in flash_tc_kernel by head width "
          f"{dict(sorted(tc_hgmma.items()))}; in the fp32 kernels "
          f"{sum(n for f, n in hgmma.items() if 'flash_tc_kernel' not in f)}")
    check(sorted(tc_hgmma) == sorted(flash_mod.HEAD_DIMS) and all(tc_hgmma.values()),
          f"flash_tc_kernel lacks HGMMA at some head width: {tc_hgmma}")
    results["flash_tc_hgmma"] = tc_hgmma
    # the bf16 backward's two tensor-core kernels, at every width it is built for
    bwd_sass = sass_counts("flash_attention_bwd", lambda op: op.startswith("HGMMA"))
    bwd_hgmma = {}
    for f, n in bwd_sass.items():
        m = re.search(r"(bwd_(?:dq|dkdv)_(?:tc|wg2)_kernel)ILi(\d+)E", f)
        if m:
            bwd_hgmma[f"{m[1]}<{m[2]}>"] = n
    print(f"[build] flash_attention_bwd SASS: HGMMA instructions in the bf16 kernels "
          f"{dict(sorted(bwd_hgmma.items()))}; in the fp32 kernels "
          f"{sum(n for f, n in bwd_sass.items() if not re.search('_(tc|wg2)_kernel', f))}")
    # one warpgroup a block at D <= 64, two (D split between them) above
    want_bwd = {f"bwd_{k}_{'wg2' if D > 64 else 'tc'}_kernel<{D}>"
                for D in flash_mod.HEAD_DIMS_BWD_TC for k in ("dq", "dkdv")}
    check(set(bwd_hgmma) == want_bwd and all(bwd_hgmma.values()),
          f"the bf16 flash backward lacks HGMMA at some head width: {bwd_hgmma}")
    results["flash_bwd_tc_hgmma"] = bwd_hgmma
    # the RG-LRU kernel's fp64 instructions: its exp(2a) in the band near 0
    fp64 = {("bfloat16" if "bfloat16" in f else "float32"): n
            for f, n in sass_counts("rglru_scan", lambda op: op.startswith(FP64_OPS)).items()
            if "rglru_kernel" in f}
    print(f"[build] rglru_scan SASS: fp64 instructions (DADD, DMUL, DFMA, DSETP, F2F to or from "
          f"f64) in rglru_kernel by dtype {fp64}")
    check(len(fp64) == 2 and all(fp64.values()), f"rglru_kernel lacks its fp64 exp: {fp64}")
    results["rglru_fp64_sass"] = fp64
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    stamp("build")
    # ---- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_case(label, B, S, H, Hk, D, dtype, window=None, Skv=None, causal=True,
                   timed=True):
        """q (B, S, H, D) against k/v (B, Skv, Hk, D) (Skv = S by default),
        the sequence ends aligned; launched twice for identical bits."""
        Skv = S if Skv is None else Skv
        q, k, v = randn(B, S, H, D, dtype=dtype), randn(B, Skv, Hk, D, dtype=dtype), \
            randn(B, Skv, Hk, D, dtype=dtype)
        kw = dict(causal=causal, window=window)
        got = flash_kernel(q, k, v, **kw)
        want = flash_plain(q, k, v, **kw)
        check(bool(torch.equal(got, flash_kernel(q, k, v, **kw))),
              f"flash {label}: a second launch differs from the first")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype], f"flash {label}: max abs err {err:.3g} > {TOL[dtype]}")
        rel = row_rel_err(got, want)
        check(dtype != torch.bfloat16 or rel <= TOL[dtype],
              f"flash {label}: row-relative err {rel:.3g} > {TOL[dtype]}")
        line = dict(kernel="flash_attention", label=label, B=B, S=S, Skv=Skv, H=H, Hk=Hk, D=D,
                    dtype=str(dtype), window=window, causal=causal, max_abs_err=err,
                    row_rel_err=rel)
        if timed:
            line["ms"] = timed_ms(lambda: flash_kernel(q, k, v, **kw), 20, flush)
            line["plain_ms"] = timed_ms(lambda: flash_plain(q, k, v, **kw), 5, flush)
        print(f"[kernels] flash {label} B={B} S={S} Skv={Skv} H={H} Hk={Hk} D={D} "
              f"{str(dtype)[6:]} causal={causal} window={window}: max|err| {err:.3g} (tol "
              f"{TOL[dtype]}), row-relative {rel:.3g}, second launch identical"
              + (f", kernel {line['ms']:.4f} ms, plain {line['plain_ms']:.4f} ms" if timed
                 else ""))
        results["cases"].append(line)

    for S in (128, 512):
        for dtype in (torch.bfloat16, torch.float32):
            flash_case("qwen-heads", 8, S, 16, 16, 64, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        flash_case("ragged-gqa-window", 3, 77, 8, 2, 32, dtype, window=24)
    flash_case("ragged-mqa", 2, 45, 4, 1, 16, torch.bfloat16)
    flash_case("ragged-window-d64", 2, 200, 16, 16, 64, torch.bfloat16, window=64)
    for D in (64, 256):
        flash_case("single-position", 3, 1, 16, 1, D, torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        flash_case("mqa-window-d256", 2, 301, 16, 1, 256, dtype, window=128)
        flash_case("gqa-d128", 2, 177, 8, 2, 128, dtype)
        flash_case("mha-window-d128", 1, 130, 4, 4, 128, dtype, window=100)
        flash_case("rgemma-prefill-d256", 4, 3072, 16, 1, 256, dtype, window=2048)
    flash_case("gqa3-window-d256", 1, 250, 12, 4, 256, torch.bfloat16, window=64)
    for dtype in (torch.bfloat16, torch.float32):      # Qwen3-30B-A3B's prefill: 32 heads on 4
        flash_case("qwen3-moe-prefill-d128-g8", 8, 256, 32, 4, 128, dtype)
    for dtype in (torch.bfloat16, torch.float32):      # Nemotron-4-340B's width
        for G in (1, 12):
            for S in (1, 37, 256):
                flash_case(f"d192-g{G}", 2, S, 24 if G == 12 else 8, 2 if G == 12 else 8, 192,
                           dtype)
    # an encoder (not causal, Sq = Skv, up to SeamlessM4T's 1,536 frames) and
    # a cross-attention (Sq != Skv, not causal), and causal with more keys
    # than queries (the ends aligned), at D in {64, 128} and G in {1, 8}
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            for G in (1, 8):
                H, Hk = (16, 16) if G == 1 else (32, 4)
                for S in (1, 37, 1536):
                    flash_case(f"encoder-d{D}-g{G}", 2, S, H, Hk, D, dtype, causal=False,
                               timed=False)
                for Sq in (1, 37, 64):
                    for Skv in (37, 1536):
                        for causal in (True, False):
                            if Sq == Skv or (causal and Sq > Skv):
                                continue
                            flash_case(f"cross-d{D}-g{G}", 2, Sq, H, Hk, D, dtype, Skv=Skv,
                                       causal=causal, timed=False)

    def bwd_case(label, B, S, H, Hk, D, dtype, window=None):
        """The backward kernel, launched twice (the same bits required: it
        has no atomics), against its plain version, each gradient held row
        by row."""
        q, k, v, do = (randn(B, S, h, D, dtype=dtype) for h in (H, Hk, Hk, H))
        got = bwd_kernel(q, k, v, do, window=window)
        again = bwd_kernel(q, k, v, do, window=window)
        want = bwd_plain(q, k, v, do, window=window)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rel = [row_rel_err(a, b) for a, b in zip(got, want)]
        err = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        tol = BWD_TOL[dtype]
        print(f"[kernels] flash backward {label} B={B} S={S} H={H} Hk={Hk} D={D} "
              f"{str(dtype)[6:]} window={window}: row-relative dq {rel[0]:.3g}, dk {rel[1]:.3g}, "
              f"dv {rel[2]:.3g} (tol {tol}); max|err| {max(err):.3g}; two launches "
              f"{'identical' if same else 'DIFFER'}")
        check(same, f"flash backward {label}: two launches gave different bits")
        check(max(rel) <= tol, f"flash backward {label}: row-relative err {max(rel):.3g} > {tol}")
        results["cases"].append(dict(kernel="flash_attention_bwd", label=label, B=B, S=S, H=H,
                                     Hk=Hk, D=D, dtype=str(dtype), window=window,
                                     row_rel_err=rel, max_abs_err=err, identical=same))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for D in flash_mod.HEAD_DIMS_BWD_TC:
            for G in (1, 2, 4):
                for S in (1, 37, 128, 512):
                    bwd_case(f"G={G}", 2, S, 8, 8 // G, D, dtype)
            bwd_case("window", 2, 300, 8, 2, D, dtype, window=64)
        # B·H·ceil(S/64) below the SM count (a part of the card idle) and above
        # it (more than one wave of blocks)
        for label, B, S, H, Hk, D, window in (("below-sms", 1, 200, 4, 1, 32, 50),
                                              ("above-sms", 4, 320, 8, 2, 64, None)):
            check((B * H * -(-S // 64) < sms) == (label == "below-sms"),
                  f"flash backward {label}: {B * H * -(-S // 64)} blocks on {sms} SMs")
            bwd_case(label, B, S, H, Hk, D, dtype, window=window)
        # D=256 (RecurrentGemma's local attention, 16 heads on one KV head):
        # bf16 the two-warpgroup wgmma kernels, fp32 the wide CUDA-core
        # kernels, at G in {1, 16}, past a window and one ending mid-tile
        for G in (1, 16):
            for S in (1, 37, 256):
                bwd_case(f"d256-G={G}", 2, S, 16, 16 // G, 256, dtype)
            bwd_case(f"d256-G={G}-window", 2, 300, 16, 16 // G, 256, dtype, window=64)
            bwd_case(f"d256-G={G}-mid-tile", 2, 130, 16, 16 // G, 256, dtype, window=50)
        # G = 3: the dkdv grid's group split (GS = 2) takes heads 1 + 2
        bwd_case("d256-G=3", 2, 300, 12, 4, 256, dtype, window=100)
    # path o's shape (RecurrentGemma-9B's local attention, 2 x 3,072 tokens)
    bwd_case("d256-path-o", 2, 3072, 16, 1, 256, torch.bfloat16, window=2048)

    def paged_inputs(dtype, B=8, ps=16, H=16, Hk=16, D=64, max_len=512):
        """Pools and a table with a shared prefix of up to 8 pages (rows 0-3), a CoW
        fork (row 1's boundary page copies row 0's, then diverges), sentinel
        columns past every length, and a retired row 7 (all sentinels)."""
        rng = np.random.default_rng(SEED)
        n_cols = max_len // ps + 2
        lengths = rng.integers(max_len // 2, max_len + 1, B).astype(np.int32)
        lengths[1] = lengths[0]
        pages_of = [-(-int(n) // ps) for n in lengths]
        P = sum(pages_of) + 4
        free = list(rng.permutation(P))
        table = np.full((B, n_cols), P, np.int32)
        n_shared = min(8, *pages_of[:4])
        shared = [free.pop() for _ in range(n_shared)]
        for b in range(B - 1):
            own = [free.pop() for _ in range(pages_of[b] - (n_shared if b < 4 else 0))]
            table[b, :pages_of[b]] = (shared if b < 4 else []) + own
        lengths[B - 1] = 37                                 # stale length, no pages
        k_pool, v_pool = randn(P, ps, Hk, D, dtype=dtype), randn(P, ps, Hk, D, dtype=dtype)
        fork = int(table[1, pages_of[1] - 1])               # row 1's last page: a fork
        src = int(table[0, pages_of[0] - 1])
        k_pool[fork, :ps // 2] = k_pool[src, :ps // 2]
        v_pool[fork, :ps // 2] = v_pool[src, :ps // 2]
        q = randn(B, 1, H, D, dtype=dtype)
        return (q, k_pool, v_pool, torch.from_numpy(table).to(dev),
                torch.from_numpy(lengths).to(dev))

    def paged_case(label, args):
        q = args[0]
        got = paged_kernel(*args)
        want = paged_plain(*args)
        check(bool(torch.equal(got, paged_kernel(*args))),
              f"paged {label}: a second launch differs from the first")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[q.dtype], f"paged {label}: max abs err {err:.3g} > {TOL[q.dtype]}")
        rel = row_rel_err(got, want)
        check(q.dtype != torch.bfloat16 or rel <= TOL[q.dtype],
              f"paged {label}: row-relative err {rel:.3g} > {TOL[q.dtype]}")
        retired = args[3].eq(args[1].shape[0]).all(dim=1)
        check(bool(torch.isfinite(got).all()), f"paged {label}: non-finite output")
        check(bool(got[retired].eq(0).all()), f"paged {label}: retired row is not zero")
        ms = timed_ms(lambda: paged_kernel(*args), 50, flush)
        plain_ms = timed_ms(lambda: paged_plain(*args), 10, flush)
        print(f"[kernels] paged {label} q {tuple(q.shape)} pool {tuple(args[1].shape)} table "
              f"{tuple(args[3].shape)} {str(q.dtype)[6:]}: max|err| {err:.3g} "
              f"(tol {TOL[q.dtype]}), row-relative {rel:.3g}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        results["cases"].append(dict(kernel="paged_attention", label=label,
                                     q=list(q.shape), pool=list(args[1].shape),
                                     table=list(args[3].shape), dtype=str(q.dtype),
                                     max_abs_err=err, row_rel_err=rel, ms=ms,
                                     plain_ms=plain_ms))

    for dtype in (torch.bfloat16, torch.float32):
        paged_case("shared-fork-sentinel", paged_inputs(dtype))
        for G in (2, 4, 8, 16):          # GQA, and MQA at G=16
            paged_case(f"shared-fork-sentinel-g{G}", paged_inputs(dtype, Hk=16 // G))
    paged_case("ragged-gqa", paged_inputs(torch.float32, B=5, ps=8, H=8, Hk=2, D=32,
                                          max_len=100))
    for dtype in (torch.bfloat16, torch.float32):      # Qwen1.5-4B's heads, MHA and GQA
        for G in (1, 2, 8):
            paged_case(f"shared-fork-sentinel-d128-g{G}",
                       paged_inputs(dtype, H=20 if G == 1 else 16, Hk=20 if G == 1 else 16 // G,
                                    D=128))
    for dtype in (torch.bfloat16, torch.float32):      # Qwen3-30B-A3B's decode: 32 heads on 4
        paged_case("shared-fork-sentinel-d128-qwen3-g8", paged_inputs(dtype, H=32, Hk=4, D=128))
    for dtype in (torch.bfloat16, torch.float32):      # Nemotron-4-340B's decode: 96 heads on 8
        paged_case("shared-fork-sentinel-d192-g12", paged_inputs(dtype, H=96, Hk=8, D=192))

    def decode_case(label, B, S, H, Hk, D, dtype, max_len):
        """Ragged lengths with an empty row (zeros) and a full one, on a
        horizon view k[:, :S] of a (B, max_len) cache."""
        q = randn(B, 1, H, D, dtype=dtype)
        k = horizon_view(randn(B, S, Hk, D, dtype=dtype), max_len)
        v = horizon_view(randn(B, S, Hk, D, dtype=dtype), max_len)
        lengths = torch.from_numpy(np.random.default_rng(SEED + B).integers(
            1, S + 1, B).astype(np.int32)).to(dev)
        lengths[0], lengths[-1] = 0, S
        got = decode_kernel(q, k, v, lengths)
        want = decode_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype], f"decode {label}: max abs err {err:.3g} > {TOL[dtype]}")
        rel = row_rel_err(got, want)
        check(dtype != torch.bfloat16 or rel <= TOL[dtype],
              f"decode {label}: row-relative err {rel:.3g} > {TOL[dtype]}")
        check(bool(got[0].eq(0).all()), f"decode {label}: a length-0 row is not zero")
        ms = timed_ms(lambda: decode_kernel(q, k, v, lengths), 50, flush)
        plain_ms = timed_ms(lambda: decode_plain(q, k, v, lengths), 10, flush)
        print(f"[kernels] decode {label} B={B} S={S}/{max_len} H={H} Hk={Hk} D={D} "
              f"{str(dtype)[6:]}: max|err| {err:.3g} (tol {TOL[dtype]}), row-relative "
              f"{rel:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results["cases"].append(dict(kernel="decode_attention", label=label, B=B, S=S,
                                     max_len=max_len, H=H, Hk=Hk, D=D, dtype=str(dtype),
                                     max_abs_err=err, row_rel_err=rel, ms=ms,
                                     plain_ms=plain_ms))

    for dtype in (torch.bfloat16, torch.float32):
        decode_case("qwen-heads-horizon", 8, 512, 16, 16, 64, dtype, 1024)
    decode_case("ragged-gqa", 3, 77, 8, 2, 32, torch.float32, 100)
    decode_case("gqa-split", 2, 70, 20, 2, 64, torch.bfloat16, 80)
    for dtype in (torch.bfloat16, torch.float32):
        decode_case("mqa-ring-d256", 4, 2048, 16, 1, 256, dtype, 2048)
        decode_case("mqa-horizon-d128", 3, 300, 16, 1, 128, dtype, 400)
        decode_case("nemotron-heads-d192-g12", 8, 300, 96, 8, 192, dtype, 400)
    decode_case("gqa-d256", 2, 90, 32, 2, 256, torch.float32, 100)

    def edge_lengths(dtype, D, G, ps, cap):
        """Lengths at the decode body's edges (``csrc/decode_body.cuh``):
        0, 1 and ps - 1; DECODE_WARPS ± 1 (warps left empty); one and two
        sub-tiles a warp ± 1, where the warps' ranges and the sub-tiles
        change; exactly ``cap`` (n_cols·ps or Smax) and past it."""
        w, sub = DECODE_WARPS, decode_sub_tile(dtype, D, G)
        lens = [0, 1, ps - 1, w - 1, w, w + 1]
        for n in (w * sub, 2 * w * sub):
            lens += [x for x in (n - 1, n, n + 1) if x < cap]
        return lens + [cap, cap + 5]

    def edge_check(kind, label, got, want, dtype, zero_rows):
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        check(err <= TOL[dtype] and (dtype != torch.bfloat16 or rel <= TOL[dtype]),
              f"{kind} {label}: max abs err {err:.3g}, row-relative {rel:.3g} > {TOL[dtype]}")
        check(bool(torch.isfinite(got).all()), f"{kind} {label}: non-finite output")
        check(bool(got[zero_rows].eq(0).all()), f"{kind} {label}: an empty row is not zero")
        print(f"[kernels] {kind} {label} q {tuple(got.shape)} {str(dtype)[6:]}: max|err| "
              f"{err:.3g} (tol {TOL[dtype]}), row-relative {rel:.3g}")
        results["cases"].append(dict(kernel=f"{kind}_attention", label=label,
                                     q=list(got.shape), dtype=str(dtype), max_abs_err=err,
                                     row_rel_err=rel))

    def decode_edges(dtype, D, G):
        """Every edge length of ``edge_lengths`` as one row each, on a
        horizon view of a longer cache; Smax leaves the two-sub-tile
        boundary inside it."""
        S = 2 * DECODE_WARPS * decode_sub_tile(dtype, D, G) + 8
        lens = edge_lengths(dtype, D, G, 16, S)
        B, Hk = len(lens), max(1, 16 // G)
        q = randn(B, 1, G * Hk, D, dtype=dtype)
        k = horizon_view(randn(B, S, Hk, D, dtype=dtype), S + 64)
        v = horizon_view(randn(B, S, Hk, D, dtype=dtype), S + 64)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        edge_check("decode", f"edges-d{D}-g{G} S={S} lengths {lens}",
                   decode_kernel(q, k, v, lengths), decode_plain(q, k, v, lengths), dtype,
                   lengths.eq(0))

    def paged_edges(dtype, D, G, ps=16):
        """The edge lengths over pages of their own, plus a retired row (all
        sentinels, length 100) and a row whose table has a hole of sentinel
        pages where warps 2 and 3 read (so those warps find nothing);
        launched again for identical bits."""
        sub = decode_sub_tile(dtype, D, G)
        n_cols = -(-(2 * DECODE_WARPS * sub + 8) // ps)
        lens = edge_lengths(dtype, D, G, ps, n_cols * ps) + [100, DECODE_WARPS * sub]
        B, Hk = len(lens), max(1, 16 // G)
        P = B * n_cols + 2
        pages = np.random.default_rng(SEED + D + G).permutation(P)
        table = np.full((B, n_cols), P, np.int32)
        for b, n in enumerate(lens):
            used = min(-(-n // ps), n_cols)
            table[b, :used] = pages[b * n_cols:b * n_cols + used]
        table[B - 2] = P                                   # retired
        table[B - 1, 2 * sub // ps:-(-4 * sub // ps)] = P  # hole under warps 2 and 3
        q = randn(B, 1, G * Hk, D, dtype=dtype)
        k_pool, v_pool = randn(P, ps, Hk, D, dtype=dtype), randn(P, ps, Hk, D, dtype=dtype)
        table, lengths = torch.from_numpy(table).to(dev), torch.tensor(lens, dtype=torch.int32,
                                                                       device=dev)
        args = (q, k_pool, v_pool, table, lengths)
        empty = lengths.eq(0) | table.eq(P).all(dim=1)
        got = paged_kernel(*args)
        check(bool(torch.equal(got, paged_kernel(*args))),
              f"paged edges D={D} G={G}: a second launch differs from the first")
        edge_check("paged", f"edges-d{D}-g{G} lengths {lens}", got, paged_plain(*args), dtype,
                   empty)

    for dtype in (torch.bfloat16, torch.float32):
        for D, G in ((64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (32, 3), (16, 1)):
            decode_edges(dtype, D, G)
            paged_edges(dtype, D, G)
        for G in (1, 2, 8):             # the paged kernel alone takes D = 128 on this body
            paged_edges(dtype, 128, G)
        for G in (1, 12):               # and D = 192, a whole warp a row, 4 heads a block
            paged_edges(dtype, 192, G)

    def wide_edges(dtype, D, G, S):
        """The wide-head kernel's edges (``decode_wide_kernel``): lengths 0, 1,
        a piece ± 1, the whole cache and past it, one row each, on a horizon
        view of a longer cache; G = 20 takes two slices of 16 query heads, G
        < 16 pads the slice, G = 8 sits on two KV heads.  S = 2048 runs 8
        clusters a row (both merge levels), S = 100 one.  Launched twice: the
        counters are left zero, so the second launch gives the same bits."""
        piece = decode_mod.wide_piece_len(S)
        lens = [0, 1, piece - 1, piece, piece + 1, S, S + 5]
        B, Hk = len(lens), (2 if G == 8 else 1)
        q = randn(B, 1, G * Hk, D, dtype=dtype)
        k = horizon_view(randn(B, S, Hk, D, dtype=dtype), S + 64)
        v = horizon_view(randn(B, S, Hk, D, dtype=dtype), S + 64)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got, again = decode_kernel(q, k, v, lengths), decode_kernel(q, k, v, lengths)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, again)), f"decode wide-edges D={D} G={G} S={S}: a second "
              f"launch differs from the first")
        edge_check("decode", f"wide-edges-d{D}-g{G} S={S} lengths {lens}", got,
                   decode_plain(q, k, v, lengths), dtype, lengths.eq(0))

    for dtype in (torch.bfloat16, torch.float32):
        for D in (128, 256):
            for G in (1, 8, 16, 20):
                for S in (2048, 100):
                    wide_edges(dtype, D, G, S)
        for G in (1, 12):               # Nemotron-4-340B's width: 12 heads of 16 rows live
            for S in (2048, 100):
                wide_edges(dtype, 192, G, S)
    # the cross-attention's decode over SeamlessM4T's encoder K/V (16 heads of
    # 64, 1,536 frames, contiguous): every frame, and the edges 1 and 1,535
    for dtype in (torch.bfloat16, torch.float32):
        lens = [1536, 1, 1535, 1536, 1, 1535, 1536, 1536]
        q = randn(len(lens), 1, 16, 64, dtype=dtype)
        k, v = (randn(len(lens), 1536, 16, 64, dtype=dtype) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got, again = decode_kernel(q, k, v, lengths), decode_kernel(q, k, v, lengths)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, again)), "decode cross-edges: a second launch differs")
        edge_check("decode", f"cross-edges-d64-g1 S=1536 lengths {lens}", got,
                   decode_plain(q, k, v, lengths), dtype, lengths.eq(0))

    def wkv6_inputs(B, T, H, D, dtype, decays="rwkv"):
        """r/k/v ~ N(0, 1), u ~ U(−0.5, 0.5), a carried state, and decays
        from RWKV6's own range exp(−exp(U(−0.5, 0.5))), or (``tiny``)
        U(1e-12, 1) with a sixteenth set to 1e-12, where a chunk's log-decay
        sums run to hundreds, or (``wide``) exp(−exp(U(−6, 3.32))), from
        0.998 down to 1e-12 with as many near 1 as near 1e-12, so that decays
        near 1 sit in a chunk beside sums of hundreds, or (``wide12``) those
        with every channel's decay 1e-12 at token 13 of each chunk, where ∂w
        = ∂lw / w holds its relative precision only if every term of ∂lw
        spans the token."""
        r, k, v = (randn(B, T, H, D, dtype=dtype) for _ in range(3))
        w_raw = torch.rand((B, T, H, D), generator=gen, device=dev)
        if decays == "rwkv":
            w = torch.exp(-torch.exp(w_raw - 0.5))
        elif decays in ("wide", "wide12"):
            w = torch.exp(-torch.exp(-6.0 + 9.32 * w_raw))
            if decays == "wide12":         # every channel's decay 1e-12 inside chunks
                w[:, 13::32] = 1e-12
        else:
            w = w_raw.clamp(1e-12, 1.0)
            w[torch.rand((B, T, H, D), generator=gen, device=dev) < 1 / 16] = 1e-12
        u = (torch.rand((H, D), generator=gen, device=dev) - 0.5).to(dtype)
        return r, k, v, w, u, 0.3 * randn(B, H, D, D, dtype=torch.float32)

    def scaled_err(got, want):
        """Max |got − want| and whether it is within TOL·(1 + |want|): the
        outputs run to tens, so the dtype's tolerance is taken relative
        above one, as ``assert_allclose(atol=rtol=TOL)`` takes it."""
        d = (got.float() - want.float()).abs()
        return d.max().item(), (d / (1 + want.float().abs())).max().item()

    def wkv6_case(B, T, H, D, dtype, decays="rwkv", timed=True):
        args = wkv6_inputs(B, T, H, D, dtype, decays)
        out, st = wkv6_kernel(*args)
        out_p, st_p = wkv6_plain(*args)
        torch.cuda.synchronize()
        err, rel = scaled_err(out, out_p)
        s_err, s_rel = scaled_err(st, st_p)
        tol = TOL[dtype]
        check(rel <= tol and s_rel <= TOL[torch.float32],
              f"wkv6 B={B} T={T} H={H} D={D} {decays} {dtype}: kernel vs plain {err:.3g} "
              f"(scaled {rel:.3g}), state {s_err:.3g} (scaled {s_rel:.3g})")
        line = dict(kernel="wkv6", B=B, T=T, H=H, D=D, dtype=str(dtype), decays=decays,
                    max_abs_err=err, scaled_err=rel, state_err=s_err,
                    out_max=out_p.float().abs().max().item())
        if dtype == torch.float32:
            # the plain version's own distance from the oracle beside the
            # kernel's: the chunked fp32 form's error, which grows as the
            # chunk's log-decay sums do
            out_r, st_r = ref.wkv6_ref(*args)
            _, o_rel = scaled_err(out, out_r)
            _, so_rel = scaled_err(st, st_r)
            _, po_rel = scaled_err(out_p, out_r)
            _, pso_rel = scaled_err(st_p, st_r)
            check(o_rel <= WKV_ORACLE_TOL and so_rel <= WKV_ORACLE_TOL,
                  f"wkv6 B={B} T={T} H={H} D={D} {decays}: kernel vs oracle {o_rel:.3g}, "
                  f"state {so_rel:.3g} (plain {po_rel:.3g}, {pso_rel:.3g})")
            line.update(oracle_err=o_rel, oracle_state_err=so_rel, plain_oracle_err=po_rel,
                        plain_oracle_state_err=pso_rel)
        if timed:
            line["ms"] = timed_ms(lambda: wkv6_kernel(*args), 20, flush)
            line["plain_ms"] = timed_ms(lambda: wkv6_plain(*args), 3, flush)
        print(f"[kernels] wkv6 B={B} T={T} H={H} D={D} {decays} {str(dtype)[6:]}: max|err| "
              f"{err:.3g} (scaled {rel:.3g}, tol {tol}), state {s_err:.3g} (scaled "
              f"{s_rel:.3g}), oracle {line.get('oracle_err', '-')} (plain "
              f"{line.get('plain_oracle_err', '-')})"
              + (f", kernel {line['ms']:.4f} ms, plain {line['plain_ms']:.4f} ms" if timed
                 else ""))
        results["cases"].append(line)

    for T in (1, 37, 512):
        for dtype in (torch.bfloat16, torch.float32):
            wkv6_case(4, T, 40, 64, dtype)
    wkv6_case(2, 45, 3, 16, torch.float32)
    # the design's edges: the step, a chunk ± 1 and a short last chunk, decays
    # down to 1e-12, and B·H = 5, where the 80 chunk blocks of T = 512 fill
    # fewer than the card's SMs and the chain across chunks runs alone
    for T in (1, 31, 32, 33, 37, 512):
        for dtype in (torch.bfloat16, torch.float32):
            if T in (31, 32, 33):
                wkv6_case(4, T, 40, 64, dtype, timed=False)
            for decays in ("tiny", "wide"):
                wkv6_case(4, T, 40, 64, dtype, decays, timed=False)
    for dtype in (torch.bfloat16, torch.float32):
        for decays in ("rwkv", "tiny", "wide"):
            wkv6_case(1, 512, 5, 64, dtype, decays, timed=False)
    for decays in ("tiny", "wide"):
        wkv6_case(2, 33, 3, 32, torch.float32, decays, timed=False)
    wkv6_case(2, 45, 3, 16, torch.float32, decays="wide", timed=False)

    def recurrent_bwd_case(label, got, again, want, names, dtype, line):
        """A recurrence's backward kernel (two launches) against its plain
        version: identical bits across the launches, every gradient held
        row by row (fp32 1e-4, bf16 2e-2)."""
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rel = {n: row_rel_err(a, b) for n, a, b in zip(names, got, want)}
        tol = BWD_TOL[dtype]
        worst = max(rel, key=rel.get)
        print(f"[kernels] {label} {str(dtype)[6:]}: row-relative "
              f"{', '.join(f'{n} {r:.3g}' for n, r in rel.items())} (tol {tol}); two launches "
              f"{'identical' if same else 'DIFFER'}")
        check(same, f"{label}: two launches gave different bits")
        check(rel[worst] <= tol, f"{label}: {worst} row-relative err {rel[worst]:.3g} > {tol}")
        results["cases"].append(dict(line, dtype=str(dtype), row_rel_err=rel, identical=same))

    def wkv6_bwd_case(B, T, H, D, dtype, decays, state):
        r, k, v, w, u, s0 = wkv6_inputs(B, T, H, D, dtype, decays)
        do = randn(B, T, H, D, dtype=dtype)
        s0, ds = (s0, randn(B, H, D, D, dtype=torch.float32)) if state else (None, None)
        args = (r, k, v, w, u, do, s0, ds)
        recurrent_bwd_case(f"wkv6 backward B={B} T={T} H={H} D={D} {decays} state={state}",
                           wkv6_bwd_kernel(*args), wkv6_bwd_kernel(*args), wkv6_bwd_plain(*args),
                           ("dr", "dk", "dv", "dw", "du", "dstate"), dtype,
                           dict(kernel="wkv6_bwd", B=B, T=T, H=H, D=D, decays=decays,
                                state=state))

    # the step, a chunk ± 1 and a long prefill, decays from 1e-12 to 1 in one
    # chunk ("wide") and RWKV6's own, with and without a state
    for dtype in (torch.bfloat16, torch.float32):
        for D in wkv6_mod.HEAD_DIMS:
            for T in (1, 31, 32, 33):
                for state in (False, True):
                    wkv6_bwd_case(2, T, 3, D, dtype, "wide", state)
        for decays in ("rwkv", "wide"):
            for state in (False, True):
                wkv6_bwd_case(4, 512, 40, 64, dtype, decays, state)
        # the chunked backward's edges: chunk boundaries and short last
        # chunks, 1e-12 inside chunks (∂w held row by row), and B·H = 3,
        # where the 12 chunk blocks of T = 97 leave the chain alone on the card
        for D in wkv6_mod.HEAD_DIMS:
            for T in (63, 64, 65, 97):
                for state in (False, True):
                    wkv6_bwd_case(2, T, 3, D, dtype, "wide", state)
        for T in (70, 97):
            for state in (False, True):
                wkv6_bwd_case(2, T, 3, 64, dtype, "wide12", state)
        for decays in ("rwkv", "wide"):
            wkv6_bwd_case(1, 97, 3, 64, dtype, decays, True)

    def rglru_inputs(B, T, W, dtype, gates):
        """x ~ N(0, 1), a carried state ~ N(0, 1), and log-gates ``mild``
        −|N(0, 0.5)|, ``strong`` U(−20, 0) or ``near0`` U(−1e-6, 0), where
        1 − exp(2a) keeps only a few bits."""
        x = randn(B, T, W, dtype=dtype)
        u = torch.rand((B, T, W), generator=gen, device=dev)
        a_log = {"mild": lambda: -(0.5 * torch.randn((B, T, W), generator=gen,
                                                     device=dev)).abs(),
                 "strong": lambda: -20.0 * u, "near0": lambda: -1e-6 * u}[gates]()
        return x, a_log, randn(B, W, dtype=torch.float32)

    def rglru_case(B, T, W, dtype, gates, timed=True):
        args = rglru_inputs(B, T, W, dtype, gates)
        h, st = rglru_kernel(*args)
        h_p, st_p = rglru_plain(*args)
        torch.cuda.synchronize()
        h2, st2 = rglru_kernel(*args)       # again: the chain's scratch was left zeroed
        check(bool(torch.equal(h, h2) and torch.equal(st, st2)),
              f"rglru T={T} {gates} {dtype}: a second launch differs from the first")
        err, rel = scaled_err(h, h_p)
        s_err, s_rel = scaled_err(st, st_p)
        check(rel <= TOL[dtype] and s_rel <= TOL[torch.float32],
              f"rglru T={T} {gates} {dtype}: kernel vs plain {err:.3g} (scaled {rel:.3g}), "
              f"state {s_err:.3g} (scaled {s_rel:.3g})")
        line = dict(kernel="rglru_scan", B=B, T=T, W=W, gates=gates, dtype=str(dtype),
                    max_abs_err=err, scaled_err=rel, state_err=s_err)
        if dtype == torch.float32:
            h_r, st_r = ref.rglru_ref(*args)
            o_err, o_rel = scaled_err(h, h_r)
            so_err, so_rel = scaled_err(st, st_r)
            check(o_rel <= RGLRU_ORACLE_TOL and so_rel <= RGLRU_ORACLE_TOL,
                  f"rglru T={T} {gates}: kernel vs oracle {o_err:.3g}, state {so_err:.3g}")
            line.update(oracle_err=o_err, oracle_state_err=so_err)
        if timed:
            line["ms"] = timed_ms(lambda: rglru_kernel(*args), 20, flush)
            line["plain_ms"] = timed_ms(lambda: rglru_plain(*args), 3, flush)
        print(f"[kernels] rglru B={B} T={T} W={W} {gates} {str(dtype)[6:]}: max|err| "
              f"{err:.3g} (scaled {rel:.3g}, tol {TOL[dtype]}), state {s_err:.3g}, oracle "
              f"{line.get('oracle_err', '-')}"
              + (f", kernel {line['ms']:.4f} ms, plain {line['plain_ms']:.4f} ms" if timed
                 else ""))
        results["cases"].append(line)

    for T in (1, 37, 3072):
        for dtype in (torch.bfloat16, torch.float32):
            for gates in ("mild", "strong", "near0"):
                rglru_case(4, T, 4096, dtype, gates)
    # the chunk blocks' edges: one chunk ± 1 token, two and three chunks ± 1
    # (the chain's first links), at a width that leaves a block part-empty
    C = rglru_mod.CHUNK
    for T in (C - 1, C, C + 1, 2 * C - 1, 2 * C + 1, 3 * C):
        for dtype in (torch.bfloat16, torch.float32):
            for gates in ("mild", "strong", "near0"):
                rglru_case(3, T, 200, dtype, gates, timed=False)

    def rglru_bwd_case(B, T, W, dtype, gates):
        x, a_log, h0 = rglru_inputs(B, T, W, dtype, gates)
        dh, dhT = randn(B, T, W, dtype=dtype), randn(B, W, dtype=torch.float32)
        args = (x, a_log, dh, h0, dhT)
        recurrent_bwd_case(f"rglru backward B={B} T={T} W={W} {gates}",
                           rglru_bwd_kernel(*args), rglru_bwd_kernel(*args),
                           rglru_bwd_plain(*args), ("dx", "da_log", "dstate"), dtype,
                           dict(kernel="rglru_bwd", B=B, T=T, W=W, gates=gates))

    # a chunk of the forward ± 1 and RecurrentGemma-9B's training length, with
    # gates within 1e-6 of 0 (where 1 − exp(2a) keeps a few bits) among them
    # and the chunk blocks' edges, up to three chunks: at B = 3, W = 200 a
    # chunk is 6 blocks, far fewer than the SMs, so each chain runs alone
    for dtype in (torch.bfloat16, torch.float32):
        for T in (1, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1, 3 * C):
            for gates in ("mild", "strong", "near0"):
                rglru_bwd_case(3, T, 200, dtype, gates)
        for gates in ("mild", "near0"):
            rglru_bwd_case(2, 3072, 4096, dtype, gates)

    stamp("kernels against plain versions")
    @contextlib.contextmanager
    def plain_kernels():
        """Swap every ops entry point for its plain version — the reference
        leg, made here and visibly, never inside the package."""
        saved = {n: getattr(ops, n) for n in kern}
        for n in kern:
            setattr(ops, n, plain[n])
        before = sum(fn.launches for fn in kernel.values())
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)
        check(sum(fn.launches for fn in kernel.values()) == before,
              "a kernel launched inside the plain leg")

    # ---- 4. the main paths -----------------------------------------------
    plain_on_cuda = {"n": 0}

    def guard(fn):
        def wrapper(x, *args, **kwargs):
            plain_on_cuda["n"] += x.is_cuda
            return fn(x, *args, **kwargs)
        return wrapper

    node_classes = (flash_mod.FlashAttention, wkv6_mod.WKV6, rglru_mod.RGLRU)

    @contextlib.contextmanager
    def main_path(label, expect, autograd=False, nodes=None):
        """Launch counts to 0 before the path, read after; every kernel of
        ``expect`` must have launched and no plain version may see a CUDA
        tensor.  The autograd nodes of ``FlashAttention``, ``WKV6`` and
        ``RGLRU`` are counted too (into ``nodes``, by class name, when it
        is given): a training path (``autograd``) must build some, a
        serving path none."""
        for fn in kernel.values():
            fn.launches = 0
        plain_on_cuda["n"] = 0
        built = {cls.__name__: 0 for cls in node_classes}

        def counted(cls):
            apply = cls.apply

            def counted_apply(*args):
                built[cls.__name__] += 1
                return apply(*args)
            return counted_apply

        for n, (m, _, p) in wrapped.items():
            setattr(m, p, guard(plain[n]))
        for cls in node_classes:
            cls.apply = counted(cls)
        counts = {}
        try:
            torch.cuda.synchronize()
            yield counts
            torch.cuda.synchronize()
        finally:
            for cls in node_classes:
                del cls.apply
            for n, (m, _, p) in wrapped.items():
                setattr(m, p, plain[n])
        counts.update({n: fn.launches for n, fn in kernel.items()})
        if nodes is not None:
            nodes.update(built)
        print(f"[{label}] launches {counts}; plain calls on CUDA tensors {plain_on_cuda['n']}; "
              f"autograd nodes {built}")
        check(all(counts[n] > 0 for n in expect), f"{label}: a kernel never launched: {counts}")
        check(plain_on_cuda["n"] == 0, f"{label}: a plain version ran on CUDA tensors")
        check((sum(built.values()) > 0) == autograd, f"{label}: autograd nodes {built}")
        results.setdefault("launches", {})[label] = dict(counts)
        results.setdefault("nodes", {})[label] = dict(built)

    main_path.kernel = kernel           # the wrappers, for counts read between paths

    cfg = get_arch("qwen1.5-0.5b")
    t0 = time.perf_counter()
    # path a serves Qwen1.5-0.5B at full width, cut to its first
    # PATH_A_LAYERS of 24 layers for the script's time
    model = Model(dataclasses.replace(cfg, n_layers=PATH_A_LAYERS), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {model.param_count() / 1e9:.3f} B parameters in "
          f"{str(model.dtype)[6:]} ({PATH_A_LAYERS} of its {cfg.n_layers} layers), init "
          f"{time.perf_counter() - t0:.1f}s")

    def serve_once(engine, reqs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.serve(reqs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def sampled_bf16(label, model, paged):
        """The half-sampled workload in bf16 at (K, slots) = (8, 8) and (1,
        4): graphed and eager at the same (K, slots) share admission
        batches and shapes, so their streams must be identical (checked).
        Across (K, slots) the admission batches and prefill shapes differ;
        that comparison is printed, not checked, through the kernels and
        again eagerly through the plain versions, with each differing
        request's first differing token."""
        streams = {}
        for K, slots in ((8, 8), (1, 4)):
            for leg in ("graphed", "eager", "plain"):
                eng = ServingEngine(model, max_slots=slots, max_len=SERVE_MAX_LEN,
                                    decode_block=K, paged=paged, page_size=16, device=dev)
                if leg != "graphed":
                    eng._graphs.run = eager_run
                rs = sampled_requests()
                with plain_kernels() if leg == "plain" else contextlib.nullcontext():
                    eng.serve(rs)
                streams[K, slots, leg] = [r.out_tokens for r in rs]
            same = sum(a == b for a, b in zip(streams[K, slots, "graphed"],
                                              streams[K, slots, "eager"]))
            print(f"[{label}] bf16 sampled workload at K={K}, {slots} slots: graphed vs eager "
                  f"streams identical {same}/16")
            check(same == 16, f"{label}: bf16 sampled streams at K={K}, {slots} slots differ "
                  f"graphed against eager")
        out = {}
        for leg in ("graphed", "plain"):
            div = first_divergence(streams[8, 8, leg], streams[1, 4, leg])
            reqs = sampled_requests()
            out[leg] = {f"request {i} ({'sampled' if i % 2 == 0 else 'greedy'})": dict(
                token=t, top2_gap=top2_gap(model, reqs[i].tokens, streams[8, 8, leg][i][:t]))
                for i, t in div.items()}
            print(f"[{label}] bf16, not checked: K=1, 4 slots vs K=8, 8 slots "
                  f"({'kernels' if leg == 'graphed' else 'plain versions, eager'}): "
                  f"{16 - len(div)}/16 streams identical; first differing token and the "
                  f"top-2 logit gap there {out[leg] or 'none'}")
        return dict(graphed_vs_eager_identical=True, across_k_slots_first_divergence=out,
                    batch_invariance=batch_invariance(label, model))

    def switching(label, model, paged):
        """``switching_requests`` served twice on one engine through the
        graphs and twice through the eager body: three keys, so three
        graphs in one pool, the key changing inside a serve and the second
        serve replaying them in another order than they were captured.
        Streams (each serve), counters, occupancy, launches and the final
        cache must match the eager body's; every dispatch but each key's
        first is a replay."""
        engs = {leg: serving_engine(model, dev, paged=paged) for leg in ("graphed", "eager")}
        engs["eager"]._graphs.run = eager_run
        streams, launches = {}, {}
        for leg, eng in engs.items():
            for fn in kernel.values():
                fn.launches = 0
            streams[leg] = []
            for _ in range(2):
                rs = switching_requests()
                serve_once(eng, rs)
                streams[leg].append([r.out_tokens for r in rs])
            launches[leg] = {n: fn.launches for n, fn in kernel.items()}
        g, e = engs["graphed"], engs["eager"]
        gs = g._graphs
        telemetry = [(x.n_decode_calls, x.n_decode_steps, x.n_prefill_calls, x.kv_occupancy())
                     for x in (g, e)]
        same = [sum(a == b for a, b in zip(*pair))
                for pair in zip(streams["graphed"], streams["eager"])]
        keys = list(gs.graphs)
        print(f"[{label}] key-switching workload: graphs captured {len(keys)} (keys in capture "
              f"order {keys}), {gs.n_replays} replays of {g.n_decode_calls} dispatches over two "
              f"serves; streams identical to eager {same} of 8; counters and kv_occupancy "
              f"{'equal' if telemetry[0] == telemetry[1] else telemetry}; launches "
              f"{'equal' if launches['graphed'] == launches['eager'] else launches}")
        check(len(keys) >= 3, f"{label} switching: {len(keys)} graphs captured, expected >= 3")
        check(gs.n_replays == g.n_decode_calls - len(keys),
              f"{label} switching: {gs.n_replays} replays of {g.n_decode_calls} dispatches "
              f"with {len(keys)} keys")
        check(same == [8, 8], f"{label} switching: streams differ graphed against eager")
        check(telemetry[0] == telemetry[1], f"{label} switching: counters differ: {telemetry}")
        check(launches["graphed"] == launches["eager"],
              f"{label} switching: launches {launches}")
        diff = caches_equal(f"{label} switching", g, e)
        lens = sorted({len(t) for t in streams["graphed"][0]})
        return dict(graphs=len(keys), keys=[list(k) for k in keys], replays=gs.n_replays,
                    dispatches=g.n_decode_calls, stream_lengths=lens, final_cache_diff=diff)

    def caches_equal(label, engine, eager_engine):
        """The final caches of a graphed and an eager engine, bit for bit
        (reported; returns the differing leaves).  Paged: the drop page
        takes every inactive slot's writes at once (index_put_ with repeated
        indices picks no winner), so it is reported apart."""
        P = engine.kv.alloc.n_pages if engine.paged else None
        cut = (lambda t: t[:, :P]) if engine.paged else (lambda t: t)
        diff = states_equal(label, {k: cut(engine.cache[k]) for k in ("k", "v")} | {
            "len": engine.cache["len"]}, {k: cut(eager_engine.cache[k]) for k in ("k", "v")} | {
            "len": eager_engine.cache["len"]})
        if engine.paged:
            drop_same = all(torch.equal(engine.cache[k][:, P:], eager_engine.cache[k][:, P:])
                            for k in ("k", "v"))
            print(f"[{label}] the drop page (inactive slots' writes) "
                  f"{'is' if drop_same else 'is not'} bit-equal too")
        return diff

    def serve(label, model, paged, record, extras=True,
              turns=("eager", "graphed", "graphed", "eager", "eager", "graphed"),
              eager_trace=True):
        """The serving path through the graphs (the main path), then the
        same workload through the eager body on a fresh engine (inputs
        recorded there): streams, counters, occupancy, launches and the
        final cache compared; tokens/s of both in ``turns``; a trace of
        each (of the graphed leg only without ``eager_trace``).
        ``extras``: also the bf16 (K, slots) report and the key-switching
        leg.  The decode kernels counted by name in a dispatch's trace must
        number from 1 to the dispatch's launches: CUPTI loses records of a
        long trace, and the wrappers' launch counts are the exact gate."""
        n_per_dispatch = model.cfg.n_layers * 8
        engine, reqs = serving_engine(model, dev, paged=paged), serving_requests()
        with main_path(label, ("flash_attention", record)) as counts:
            serve_s = serve_once(engine, reqs)
        gs = engine._graphs
        n_prefills, n_dispatches = engine.n_prefill_calls, engine.n_decode_calls
        n_graphs, n_replays = len(gs.graphs), gs.n_replays
        print(f"[{label}] graphs captured {len(gs.graphs)} (keys {sorted(gs.graphs)}), "
              f"{gs.n_replays} replays of {engine.n_decode_calls} dispatches")
        eager_engine, eager_reqs = serving_engine(model, dev, paged=paged), serving_requests()
        eager_engine._graphs.run = eager_run
        with main_path(f"{label}-eager", ("flash_attention", record)) as eager_counts, \
                recording(ops, "flash_attention", {0}) as flash_calls, \
                recording(ops, record, {3 * n_per_dispatch}) as decode_calls:
            eager_s = serve_once(eager_engine, eager_reqs)
        n_done = sum(r.done for r in reqs)
        n_tok = sum(len(r.out_tokens) for r in reqs)
        occ = engine.kv_occupancy()
        check(n_done == len(reqs), f"{label}: served {n_done}/{len(reqs)} requests")
        check(all(len(r.out_tokens) >= 1 for r in reqs), f"{label}: a request produced no token")
        check(0 in flash_calls and decode_calls, f"{label}: main-path inputs were not recorded")
        same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, eager_reqs))
        telemetry = [(e.n_decode_calls, e.n_decode_steps, e.n_prefill_calls, e.kv_occupancy())
                     for e in (engine, eager_engine)]
        print(f"[{label}] graphed vs eager: streams identical {same}/{len(reqs)}, counters and "
              f"kv_occupancy {'equal' if telemetry[0] == telemetry[1] else telemetry}, "
              f"launches {'equal' if counts == eager_counts else (counts, eager_counts)}")
        check(same == len(reqs), f"{label}: graphed streams differ from the eager body's")
        check(telemetry[0] == telemetry[1], f"{label}: engine counters differ: {telemetry}")
        check(counts == eager_counts, f"{label}: launches {counts} graphed, {eager_counts} eager")
        diff = caches_equal(label, engine, eager_engine)
        # tokens/s in turns (eager, graphed, graphed, eager, eager, graphed by
        # default), fresh requests each time on the two warm engines
        tps = {"eager": [], "graphed": []}
        secs = {"eager": [], "graphed": []}
        for leg in turns:
            eng = eager_engine if leg == "eager" else engine
            rs = serving_requests()
            t = serve_once(eng, rs)
            secs[leg].append(t)
            tps[leg].append(sum(len(r.out_tokens) for r in rs) / t)
        print(f"[{label}] tokens/s in turns: eager {[round(x, 1) for x in tps['eager']]}, "
              f"graphed {[round(x, 1) for x in tps['graphed']]}")
        stamp(f"{label}: graphed, eager and turns")
        # one more serve of each leg with every dispatch clocked (a
        # synchronize before and after) and the fifth one traced: the card's
        # busy share of a dispatch (its device time over the mean wall time
        # of the untraced dispatches), the decode kernel counted by name in
        # it, and the dispatches' share of the serve's wall time (the rest
        # is admission and the host's work between dispatches)
        traces = {}
        frag = "paged_decode_kernel" if paged else "::decode_kernel"
        for leg, eng in (("graphed", engine), ("eager", eager_engine))[:2 if eager_trace else 1]:
            clock = DispatchClock(eng, trace_at=4)
            for fn in kernel.values():
                fn.launches = 0
            t = serve_once(eng, serving_requests())
            eng._graphs.run = clock.inner
            dev_ms = device_total_ms(clock.rows)
            others = clock.times[:4] + clock.times[5:]
            disp_ms = 1e3 * float(np.mean(others))
            untraced = t - clock.times[4]        # the profiler's start-up left out
            n_trace = trace_counts(clock.rows, [frag])[frag]
            want = model.cfg.n_layers * engine.decode_block
            top = top_device(clock.rows)
            traces[leg] = dict(device_ms_per_dispatch=dev_ms, dispatch_ms=disp_ms,
                               busy_share=None if dev_ms is None else dev_ms / disp_ms,
                               dispatch_share_of_serve=sum(others) / untraced,
                               decode_kernels_in_trace=n_trace, top=top)
            print(f"[{label}] {leg} dispatch trace: device busy "
                  + ("not measured" if dev_ms is None else
                     f"{dev_ms:.3f} ms of {disp_ms:.3f} ms ({100 * dev_ms / disp_ms:.1f}%)")
                  + f"; the other {len(others)} dispatches take "
                    f"{100 * traces[leg]['dispatch_share_of_serve']:.1f}% of the serve's "
                    f"{1e3 * untraced:.1f} ms without the traced one; {frag} in the trace "
                    f"{n_trace} of the {want} launched ({want - n_trace} CUPTI records lost)")
            for name, ms in top:
                print(f"[{label}]   {ms:.4f} ms a dispatch: {name}")
            check(dev_ms is not None or dev.type != "cuda",
                  f"{label} {leg}: the dispatch trace holds no device time")
            # the trace of a long dispatch loses CUPTI records (5 of 320
            # decode-kernel records in Qwen1.5-4B's eager one, ~13,000
            # kernels; 8 of 384 in Qwen3-30B-A3B's graphed one at 48 layers)
            check(dev_ms is None or 0 < n_trace <= want,
                  f"{label} {leg}: {n_trace} decode kernels in one dispatch's trace, "
                  f"expected 1 to {want}")
        bf16 = sampled_bf16(label, model, paged) if extras else None
        switch = switching(label, model, paged) if extras else None
        print(f"[{label}] {n_done}/{len(reqs)} requests, {n_tok} tokens in {serve_s:.3f}s "
              f"graphed (first run: eager first calls and captures included), "
              f"{eager_s:.3f}s eager; prompts {min(len(r.tokens) for r in reqs)}-"
              f"{max(len(r.tokens) for r in reqs)} tokens; {n_prefills} prefills, "
              f"{n_dispatches} decode dispatches; kv peak "
              f"{occ['peak_kv_bytes'] / 2**20:.1f} MiB")
        results[label] = dict(requests=n_done, tokens=n_tok, seconds=serve_s,
                              eager_seconds=eager_s, tokens_per_s_turns=tps,
                              seconds_turns=secs, launches=counts,
                              launches_per_request={k: v / n_done for k, v in counts.items()},
                              kv=occ, prefills=n_prefills, decode_dispatches=n_dispatches,
                              graphs=n_graphs, graph_keys=[list(k) for k in gs.graphs],
                              replays=n_replays, final_cache_diff=diff, traces=traces,
                              sampled_bf16=bf16, switching=switch)
        del engine, eager_engine
        return occ, counts, flash_calls[0], next(iter(decode_calls.values()))

    occ, paged_counts, flash_call, paged_call = serve("paged", model, True, "paged_attention")
    check(occ["prefix_shares"] > 0 and occ["cow_forks"] > 0,
          "prefix sharing or copy-on-write never engaged")
    stamp("paged serving")
    # path b serves the same model cut to its first PATH_B_LAYERS of 24
    # layers (the same weights), for the script's time
    model_b = Model(dataclasses.replace(cfg, n_layers=PATH_B_LAYERS), device=dev)
    model_b.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("blocks.")
                             or int(k.split(".")[1]) < PATH_B_LAYERS})
    _, contig_counts, _, decode_call = serve("contiguous", model_b, False, "decode_attention")
    del model, model_b
    torch.cuda.empty_cache()

    stamp("contiguous serving")
    rcfg = get_arch("rwkv6-3b")
    t0 = time.perf_counter()
    rmodel = Model(rcfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"[rwkv6] {rcfg.name}: {rmodel.param_count() / 1e9:.3f} B parameters in "
          f"{str(rmodel.dtype)[6:]}, init {time.perf_counter() - t0:.1f}s")
    prompts = random_prompts(rcfg.vocab_size, 4, 512, SEED + 1).to(dev)
    n_steps = 32
    with main_path("rwkv6", ("wkv6",)) as rwkv_counts:
        r_logits, r_streams, r_prefill_s, r_decode_s, r_dec = greedy(rmodel, prompts, n_steps)
        rwkv_s = r_prefill_s + r_decode_s
    check(rwkv_counts["wkv6"] >= rcfg.n_layers * (n_steps + 1),
          f"rwkv6: {rwkv_counts['wkv6']} WKV6 launches < {rcfg.n_layers} x {n_steps + 1}")
    with main_path("rwkv6-eager", ("wkv6",)) as rwkv_eager_counts, \
            recording(ops, "wkv6", {0, rcfg.n_layers}) as wkv6_calls:
        _, r_streams_e, _, r_decode_e, r_dec_e = greedy(rmodel, prompts, n_steps, graphed=False)
    r_cmp = recurrent_compare("rwkv6", r_streams, r_streams_e, r_dec, r_dec_e,
                              rwkv_counts, rwkv_eager_counts)
    want_shape = (prompts.shape[0], 1, rmodel.vocab_padded)
    check(tuple(r_logits.shape) == want_shape and bool(torch.isfinite(r_logits).all()),
          f"rwkv6: prefill logits {tuple(r_logits.shape)} not finite of {want_shape}")
    check(bool(((r_streams >= 0) & (r_streams < rcfg.vocab_size)).all()),
          "rwkv6: a token id out of the vocab")
    print(f"[rwkv6] prefill 4x{prompts.shape[1]} in {r_prefill_s:.3f}s, {n_steps} greedy "
          f"steps in {r_decode_s:.3f}s ({1e3 * r_decode_s / n_steps:.1f} ms a step); "
          f"{rwkv_s:.3f}s in all")
    r_turns = step_turns(r_dec_e, r_dec)
    print(f"[rwkv6] ms a step in turns: eager {[round(x, 3) for x in r_turns['eager']]}, "
          f"graphed {[round(x, 3) for x in r_turns['graphed']]}")
    r_trace = trace_decode("rwkv6", rmodel, prompts, float(np.mean(r_turns["eager"])) / 1e3)
    r_replay = trace_replay("rwkv6", r_dec, float(np.mean(r_turns["graphed"])),
                            ["wkv6_step_kernel"])
    check(r_replay["kernels_in_replay"]["wkv6_step_kernel"] == rcfg.n_layers * 8,
          f"rwkv6: {r_replay['kernels_in_replay']} WKV6 step kernels in one replay, "
          f"expected {rcfg.n_layers * 8}")
    results["rwkv6"] = dict(seconds=rwkv_s, prefill_s=r_prefill_s, decode_s=r_decode_s,
                            eager_decode_s=r_decode_e, launches=rwkv_counts, steps=n_steps,
                            prompt_shape=list(prompts.shape), decode_trace=r_trace,
                            replay_trace=r_replay, step_ms_turns=r_turns, compare=r_cmp)
    del rmodel, r_dec, r_dec_e
    torch.cuda.empty_cache()

    stamp("rwkv6")
    gcfg = get_arch("recurrentgemma-9b")
    kinds = gcfg.layer_kinds()
    n_rec, n_local = kinds.count("rglru"), kinds.count("local")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gmodel = Model(gcfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    g_params = gmodel.param_count()
    print(f"[rgemma] {gcfg.name}: {g_params / 1e9:.3f} B parameters in "
          f"{str(gmodel.dtype)[6:]} (the config's own estimate: "
          f"{gcfg.param_count() / 1e9:.3f} B), init {time.perf_counter() - t0:.1f}s")
    g_prompts = random_prompts(gcfg.vocab_size, 4, 3072, SEED + 2).to(dev)
    g_max_len = 4096
    g_expect = ("rglru_scan", "flash_attention", "decode_attention")
    with main_path("recurrentgemma", g_expect) as g_counts:
        g_logits, g_streams, g_prefill_s, g_decode_s, g_dec = greedy(
            gmodel, g_prompts, n_steps, max_len=g_max_len)
    want_counts = {"rglru_scan": n_rec * (n_steps + 1), "flash_attention": n_local,
                   "decode_attention": n_local * n_steps}
    check(all(g_counts[n] == c for n, c in want_counts.items()),
          f"recurrentgemma: launches {g_counts}, expected {want_counts}")
    with main_path("recurrentgemma-eager", g_expect) as g_eager_counts, \
            recording(ops, "rglru_scan", {0, n_rec}) as rglru_calls, \
            recording(ops, "flash_attention", {0}) as g_flash_calls, \
            recording(ops, "decode_attention", {0}) as g_decode_calls:
        _, g_streams_e, _, g_decode_e, g_dec_e = greedy(gmodel, g_prompts, n_steps,
                                                        graphed=False, max_len=g_max_len)
    g_cmp = recurrent_compare("rgemma", g_streams, g_streams_e, g_dec, g_dec_e, g_counts,
                              g_eager_counts)
    want_shape = (g_prompts.shape[0], 1, gmodel.vocab_padded)
    check(tuple(g_logits.shape) == want_shape and bool(torch.isfinite(g_logits).all()),
          f"recurrentgemma: prefill logits {tuple(g_logits.shape)} not finite of {want_shape}")
    check(bool(((g_streams >= 0) & (g_streams < gcfg.vocab_size)).all()),
          "recurrentgemma: a token id out of the vocab")
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[rgemma] prefill 4x{g_prompts.shape[1]} (max_len {g_max_len}, ring "
          f"{min(gcfg.window, g_max_len)}) in {g_prefill_s:.3f}s, {n_steps} greedy steps in "
          f"{g_decode_s:.3f}s ({1e3 * g_decode_s / n_steps:.1f} ms a step); peak memory "
          f"{g_peak:.1f} GiB")
    g_turns = step_turns(g_dec_e, g_dec)
    print(f"[rgemma] ms a step in turns: eager {[round(x, 3) for x in g_turns['eager']]}, "
          f"graphed {[round(x, 3) for x in g_turns['graphed']]}")
    g_trace = trace_decode("rgemma", gmodel, g_prompts, float(np.mean(g_turns["eager"])) / 1e3,
                           max_len=g_max_len)
    g_replay = trace_replay("rgemma", g_dec, float(np.mean(g_turns["graphed"])),
                            ["rglru_kernel", "decode_wide_kernel"])
    want_replay = {"rglru_kernel": n_rec * 8, "decode_wide_kernel": n_local * 8}
    check(g_replay["kernels_in_replay"] == want_replay,
          f"recurrentgemma: kernels in one replay {g_replay['kernels_in_replay']}, expected "
          f"{want_replay}")
    results["recurrentgemma"] = dict(params=g_params, config_param_estimate=gcfg.param_count(),
                                     prefill_s=g_prefill_s, decode_s=g_decode_s,
                                     eager_decode_s=g_decode_e, launches=g_counts,
                                     steps=n_steps, max_len=g_max_len,
                                     prompt_shape=list(g_prompts.shape), peak_gib=g_peak,
                                     decode_trace=g_trace, replay_trace=g_replay,
                                     step_ms_turns=g_turns, compare=g_cmp)
    del gmodel, g_dec, g_dec_e
    torch.cuda.empty_cache()

    stamp("recurrentgemma")
    # ---- path e: paged serving of full-width Qwen1.5-4B (the paged kernel at D=128)
    # full width, cut to its first PATH_E_LAYERS of 40 layers for the script's time
    qcfg = dataclasses.replace(get_arch("qwen1.5-4b"), n_layers=PATH_E_LAYERS)
    t0 = time.perf_counter()
    model4 = Model(qcfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 3))
    torch.cuda.synchronize()
    print(f"[paged-4b] {qcfg.name}: {model4.param_count() / 1e9:.3f} B parameters in "
          f"{str(model4.dtype)[6:]}, init {time.perf_counter() - t0:.1f}s")
    _, paged4_counts, _, paged4_call = serve("paged-4b", model4, True, "paged_attention",
                                             extras=False)
    check(paged4_call[0][0].shape[-1] == 128, "paged-4b: the recorded paged call is not D=128")
    stamp("paged serving of qwen1.5-4b")

    # ---- path f: speculative decoding, Qwen1.5-0.5B drafting
    def spec_engine(target, draft):
        from repro_torch.serving.speculative import SpeculativeEngine

        return SpeculativeEngine(target, draft, max_slots=8, max_len=SERVE_MAX_LEN,
                                 spec_k=SPEC_K, page_size=16, device=dev)

    def target_only(target):
        """The target alone, with the speculative engine's slots, layout and
        decode_block = K + 1."""
        return ServingEngine(target, max_slots=8, max_len=SERVE_MAX_LEN, decode_block=SPEC_K + 1,
                             paged=True, page_size=16, device=dev)

    def in_serve_span_rounding(label, target, draft, streams):
        """``SpanProbe`` as the target's ``decode_span`` in this workload,
        eager on engines of its own: once carrying every one-pass result
        (the JAX package's verify), counting the operators that differ on
        the serve's own activations, and once carrying them all but the
        RMSNorms' (in bf16 the only operator found to differ).  Each
        leg's accept rate and streams against the speculative ones are
        printed, not checked."""
        out = {}
        for how, one_pass in (("every", SpanProbe.ALL),
                              ("all but RMSNorm's", SpanProbe.ALL - {"RMSNorm"})):
            probe = target.decode_span = SpanProbe(target, one_pass)
            eng = spec_engine(target, draft)
            eng.draft._graphs.run = eng.target._graphs.run = eager_run
            rs = sampled_requests()
            serve_once(eng, rs)
            del target.decode_span
            div = first_divergence(streams, [r.out_tokens for r in rs])
            out[how] = dict(operators=probe.report(), accept_rate=eng.accept_rate(),
                            first_divergence=div)
            print(f"[{label}] bf16 verify carrying {how} one-pass result in this workload, not "
                  f"checked: accept rate {eng.accept_rate():.4f}, streams identical to the "
                  f"speculative ones {16 - len(div)}/16 {div or ''}; calls of each operator where "
                  f"one pass differs from per position {probe.text()}")
        return out

    def speculative(label, target, draft, probe=False):
        """Path f for one pair in bf16: the half-sampled workload through
        ``SpeculativeEngine`` (every draft and verify dispatch a graph
        replay), then through the eager bodies: streams, counters, launches
        identical (checked), caches compared.  Paged launches must be rounds
        × (K+1) × (draft layers + target layers); the accepted, bonus and
        mismatch tokens, counted again from the dispatches' own outputs,
        must add up to the tokens emitted.  Against the target alone the
        streams are reported (other admission times could still split a
        bf16 stream), with the top-2 logit gap at each first differing
        token; tokens/s against the target alone in turns.  ``probe``: also
        ``in_serve_span_rounding``."""
        K = SPEC_K
        span_matches_steps(label, target)
        rounding = span_rounding(label, target)
        runs = {}
        for leg in ("graphed", "eager"):
            eng = spec_engine(target, draft)
            if leg == "eager":
                eng.draft._graphs.run = eng.target._graphs.run = eager_run
            log = RoundLog(eng)
            reqs = sampled_requests()
            for r in reqs:
                r.on_tokens = log.hook(r.rid)
            name = label if leg == "graphed" else f"{label}-eager"
            with main_path(name, ("flash_attention", "paged_attention")) as counts:
                t = serve_once(eng, reqs)
            log.detach()
            runs[leg] = dict(eng=eng, streams=[r.out_tokens for r in reqs], log=log, counts=counts,
                             seconds=t, telemetry=(eng.n_rounds, eng.n_drafted, eng.n_accepted,
                                                   eng.n_bonus, eng.n_decode_calls,
                                                   eng.n_decode_steps, eng.n_prefill_calls,
                                                   eng.kv_occupancy()))
        g, e = runs["graphed"], runs["eager"]
        eng = g["eng"]
        same = sum(a == b for a, b in zip(g["streams"], e["streams"]))
        print(f"[{label}] graphed vs eager: streams identical {same}/16, counters "
              f"{'equal' if g['telemetry'] == e['telemetry'] else (g['telemetry'], e['telemetry'])}"
              f", launches {'equal' if g['counts'] == e['counts'] else (g['counts'], e['counts'])}"
              f"; graphs captured draft {len(eng.draft._graphs.graphs)}, target "
              f"{len(eng.target._graphs.graphs)}, replays {eng.draft._graphs.n_replays} + "
              f"{eng.target._graphs.n_replays} of {eng.n_decode_calls} dispatches")
        check(same == 16, f"{label}: graphed streams differ from the eager bodies'")
        check(g["telemetry"] == e["telemetry"], f"{label}: counters differ graphed against eager")
        check(g["counts"] == e["counts"], f"{label}: launches differ graphed against eager")
        check(eng.draft._graphs.n_replays > 0 and eng.target._graphs.n_replays > 0,
              f"{label}: no dispatch was a graph replay")
        diff = {side: caches_equal(f"{label} {side}", getattr(eng, side),
                                   getattr(e["eng"], side)) for side in ("draft", "target")}
        n_layers = target.cfg.n_layers + draft.cfg.n_layers
        want = eng.n_rounds * (K + 1) * n_layers
        check(g["counts"]["paged_attention"] == want,
              f"{label}: {g['counts']['paged_attention']} paged launches, expected {eng.n_rounds} "
              f"rounds x {K + 1} x {n_layers} layers = {want}")
        tally = g["log"].tally(K)
        n_emitted = sum(len(x) for x in g["streams"]) - len(g["streams"])
        print(f"[{label}] {eng.n_rounds} rounds, {eng.n_drafted} drafted, accepted "
              f"{eng.n_accepted} (recount {tally['accepted']}), bonus {eng.n_bonus} (recount "
              f"{tally['bonus']}), mismatch tokens {tally['mismatch']}: "
              f"{tally['accepted'] + tally['bonus'] + tally['mismatch']} of {n_emitted} tokens "
              f"emitted in rounds; accept rate {eng.accept_rate():.4f}; paged launches "
              f"{g['counts']['paged_attention']} = {eng.n_rounds} x {K + 1} x {n_layers}")
        check(tally["accepted"] == eng.n_accepted and tally["bonus"] == eng.n_bonus
              and tally["accepted"] + tally["bonus"] + tally["mismatch"] == n_emitted
              == tally["emitted"], f"{label}: accepted, bonus and mismatch tokens {tally} do "
              f"not add up to the {n_emitted} emitted")
        accept = eng.accept_rate()
        # against the target alone, bf16: reported, not checked
        tgt, ref_reqs = target_only(target), sampled_requests()
        serve_once(tgt, ref_reqs)
        ref = [r.out_tokens for r in ref_reqs]
        div = first_divergence(ref, g["streams"])
        split = {f"request {i} ({'sampled' if i % 2 == 0 else 'greedy'})": dict(
            token=t, top2_gap=top2_gap(target, ref_reqs[i].tokens, ref[i][:t]))
            for i, t in div.items()}
        print(f"[{label}] bf16, not checked: speculative vs the target alone "
              f"{16 - len(div)}/16 streams identical; first differing token and the target's "
              f"top-2 logit gap there {split or 'none'}")
        in_serve = in_serve_span_rounding(label, target, draft, g["streams"]) if probe else None
        # tokens/s in turns on the two warm engines, fresh requests each time
        tps = {"target_only": [], "speculative": []}
        for leg in ("target_only", "speculative", "speculative", "target_only", "target_only",
                    "speculative"):
            rs = sampled_requests()
            t = serve_once(tgt if leg == "target_only" else eng, rs)
            tps[leg].append(sum(len(r.out_tokens) for r in rs) / t)
        print(f"[{label}] tokens/s in turns: target alone "
              f"{[round(x, 1) for x in tps['target_only']]}, speculative "
              f"{[round(x, 1) for x in tps['speculative']]}")
        # one more serve with every dispatch clocked and the fifth draft and
        # fifth verify traced: the card's busy share of each, and the paged
        # kernel counted by name in each replay
        clocks = {side: DispatchClock(getattr(eng, side), trace_at=4)
                  for side in ("draft", "target")}
        serve_once(eng, sampled_requests())
        traces = {}
        for side, clock in clocks.items():
            getattr(eng, side)._graphs.run = clock.inner
            dev_ms = device_total_ms(clock.rows)
            disp_ms = 1e3 * float(np.mean(clock.times[:4] + clock.times[5:]))
            n_trace = trace_counts(clock.rows, ["paged_decode_kernel"])["paged_decode_kernel"]
            want = (K + 1) * (draft if side == "draft" else target).cfg.n_layers
            traces[side] = dict(device_ms=dev_ms, dispatch_ms=disp_ms, paged_in_trace=n_trace,
                                top=top_device(clock.rows))
            print(f"[{label}] {'draft' if side == 'draft' else 'verify'} dispatch trace: device "
                  f"busy " + ("not measured" if dev_ms is None else
                              f"{dev_ms:.3f} ms of {disp_ms:.3f} ms "
                              f"({100 * dev_ms / disp_ms:.1f}%)")
                  + f"; paged_decode_kernel in the trace {n_trace} (expected {want})")
            for name, ms in traces[side]["top"][:6]:
                print(f"[{label}]   {ms:.4f} ms a dispatch: {name}")
            check(dev_ms is not None or dev.type != "cuda",
                  f"{label} {side}: the dispatch trace holds no device time")
            check(dev_ms is None or n_trace == want,
                  f"{label} {side}: {n_trace} paged kernels in one dispatch, expected {want}")
        stamp(label)
        return dict(telemetry=g["telemetry"][:7],
                    accept_rate=accept, launches=g["counts"], tally=tally,
                    seconds=g["seconds"], eager_seconds=e["seconds"], final_cache_diff=diff,
                    vs_target_only=split, tokens_per_s_turns=tps, traces=traces,
                    span_rounding=rounding, in_serve_span_rounding=in_serve)

    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    # both pairs at full width, their depth cut for the script's time: the
    # Qwen1.5-0.5B to its first PATH_F_LAYERS of 24, the Qwen1.5-4B target
    # to its first SPEC_4B_LAYERS of 40
    model_f = Model(dataclasses.replace(cfg, n_layers=PATH_F_LAYERS), device=dev)
    model_f.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("blocks.")
                             or int(k.split(".")[1]) < PATH_F_LAYERS})
    model4f = Model(dataclasses.replace(qcfg, n_layers=SPEC_4B_LAYERS), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 3))
    results["speculative_bf16"] = {"self": speculative("spec-self", model_f, model_f,
                                                       probe=True),
                                   "4b": speculative("spec-4b", model4f, model_f)}
    del model4f, model_f
    # ---- path g: RoBatch's control plane over a live pool of the two models
    results["control_plane"], g_recorded = control_plane("robatch-pool", dev, (model, model4),
                                                         main_path)
    stamp("robatch control plane")
    del model, model4
    torch.cuda.empty_cache()

    # ---- path h: training on the card, the trained tiny pool, HTTP over it
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    try:
        results["train"], h1_call = train_qwen("train-qwen", dev, main_path, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    stamp("training full-width qwen1.5-0.5b")
    results["train_parity"] = train_parity("train-parity", dev, main_path, plain_kernels)
    results["tiny_pool"], h3_call, h_gw = tiny_pool_path("tiny-pool", dev, main_path)
    del h_gw
    torch.cuda.empty_cache()
    stamp("tiny pool trained, fit, submit and served over HTTP")

    # ---- paths n and o: training the recurrent families on the card
    # (WKV6, RG-LRU and the flash backward at D=256 through their kernels)
    ocfg = dataclasses.replace(gcfg, n_layers=O_LAYERS)
    o_kinds = ocfg.layer_kinds()
    recurrent_calls = {}
    for label, tcfg, steps, batch, seq, per_step in (
            ("train-rwkv6", rcfg, N_STEPS, N_BATCH, N_SEQ,
             {"wkv6": rcfg.n_layers, "wkv6_bwd": rcfg.n_layers}),
            ("train-rgemma", ocfg, O_STEPS, O_BATCH, O_SEQ,
             {"rglru_scan": o_kinds.count("rglru"), "rglru_bwd": o_kinds.count("rglru"),
              "flash_attention": o_kinds.count("local"),
              "flash_attention_bwd": o_kinds.count("local")})):
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
        try:
            results[label], calls = train_recurrent(label, dev, main_path, tcfg, steps, batch,
                                                    seq, ckpt_dir, per_step)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        recurrent_calls.update({k: (v, results[label]) for k, v in calls.items()})
        torch.cuda.empty_cache()
        stamp(f"{label}: {tcfg.name}, {tcfg.n_layers} layers, trained")

    # ---- path i: paged serving of full-width Qwen3-30B-A3B (mixture of
    # experts, QK-norm, GQA 32/4: the flash and paged kernels at D=128, G=8)
    from repro_torch.models import moe as moe_mod

    mcfg = get_arch("qwen3-moe-30b-a3b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    mmodel = Model(mcfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    m_params = mmodel.param_count()
    m_init_s = time.perf_counter() - t0
    print(f"[moe-30b] {mcfg.name}: {m_params / 1e9:.3f} B parameters ({m_params:,}) in "
          f"{str(mmodel.dtype)[6:]}, init {m_init_s:.1f}s; {held_before:.2f} GiB held before it, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after")
    # the model's own count is its tree's: the config's keeps the reference's
    # undercount of the QK-norm scales (2 x head_dim a layer)
    check(m_params == mcfg.param_count() + mcfg.n_layers * 2 * mcfg.head_dim,
          f"moe-30b: {m_params} parameters, config {mcfg.param_count()}")
    with first_drops(moe_mod) as drops:
        # turns of two serves a leg, and no eager dispatch trace here (an eager
        # step's eager operators take ~5x its device time: moe_split below
        # traces an eager dispatch with the MoE layers marked)
        _, moe_counts, moe_flash_call, moe_paged_call = serve(
            "moe-30b", mmodel, True, "paged_attention", extras=False,
            turns=("eager", "graphed", "graphed", "eager"), eager_trace=False)
    r_i = results["moe-30b"]
    want_i = {"paged_attention": r_i["decode_dispatches"] * 8 * mcfg.n_layers,
              "flash_attention": r_i["prefills"] * mcfg.n_layers}
    check({n: moe_counts[n] for n in want_i} == want_i,
          f"moe-30b: launches {moe_counts}, expected {want_i}")
    check(not r_i["final_cache_diff"], "moe-30b: final caches differ graphed against eager")
    check(tuple(moe_paged_call[0][0].shape) == (8, 1, 32, 128)
          and moe_paged_call[0][1].shape[2:] == (4, 128),
          f"moe-30b: the recorded paged call is not D=128, G=8: "
          f"{[tuple(a.shape) for a in moe_paged_call[0][:2]]}")
    print(f"[moe-30b] layer 0 of the first prefill, not checked: {drops['dropped']} of "
          f"{drops['pairs']} (token, expert) pairs dropped ({drops['tokens']} tokens, top-"
          f"{mcfg.moe.top_k} of {drops['experts']} experts, capacity {drops['capacity']})")
    # a decode step reads every weight but the embedding: all 128 experts,
    # exact dispatch
    step_bytes = (m_params - mmodel.embed.numel()) * mmodel.embed.element_size()
    step_bound = 1e3 * step_bytes / HBM_BYTES_PER_S
    step_ms = r_i["traces"]["graphed"]["dispatch_ms"] / 8
    print(f"[moe-30b] graphed step {step_ms:.3f} ms (a clocked dispatch over K = 8) against a "
          f"bound of {step_bound:.3f} ms ({step_bytes / 1e9:.2f} GB of weights at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {step_ms / step_bound:.2f}x")
    split_eng, split_reqs = serving_engine(mmodel, dev), serving_requests()[:8]
    for r in split_reqs:
        r.max_new = 17                          # the prefill's token, then 2 dispatches of 8
    split = moe_split("moe-30b", split_eng, moe_mod, split_reqs, trace_at=1)
    del split_eng
    m_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[moe-30b] peak memory {m_peak:.2f} GiB")
    r_i.update(params=m_params, config_param_count=mcfg.param_count(), init_s=m_init_s,
               held_before_gib=held_before, peak_gib=m_peak, first_prefill_layer0=dict(drops),
               step_ms=step_ms, step_bound_ms=step_bound, step_bytes=step_bytes,
               eager_split=split)
    del mmodel
    torch.cuda.empty_cache()
    stamp("paged serving of qwen3-moe-30b-a3b")

    # ---- path i2: full-width Qwen1.5-MoE-A2.7B (shared expert, QKV bias, 60
    # experts top-4): one prefill of 8 requests and 32 greedy steps
    m2cfg = get_arch("qwen2-moe-a2.7b")
    t0 = time.perf_counter()
    m2model = Model(m2cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 5))
    torch.cuda.synchronize()
    print(f"[moe-a2.7b] {m2cfg.name}: {m2model.param_count() / 1e9:.3f} B parameters in "
          f"{str(m2model.dtype)[6:]}, init {time.perf_counter() - t0:.1f}s")

    g_eng, _, g_c, g_s, e_s = short_leg("moe-a2.7b", m2model, dev, main_path, caches_equal)
    results["moe-a2.7b"] = dict(params=m2model.param_count(), launches=g_c,
                                seconds=g_s, eager_seconds=e_s, dispatches=g_eng.n_decode_calls)
    del g_eng, m2model
    torch.cuda.empty_cache()
    stamp("qwen2-moe-a2.7b prefill and 32 steps")

    # ---- path j: paged serving of full-width StableLM-2-1.6B (LayerNorm, a
    # quarter of each head rotated; the flash and paged kernels at D=64, G=1)
    scfg = get_arch("stablelm-1.6b")
    t0 = time.perf_counter()
    smodel = Model(scfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 6))
    torch.cuda.synchronize()
    s_params = smodel.param_count()
    print(f"[stablelm] {scfg.name}: {s_params / 1e9:.3f} B parameters ({s_params:,}) in "
          f"{str(smodel.dtype)[6:]}, init {time.perf_counter() - t0:.1f}s")
    # the model's own count is its tree's: the config's keeps the reference's
    # undercount of LayerNorm's biases (d for each of the 2 x layers + 1 norms)
    check(s_params == scfg.param_count() + (2 * scfg.n_layers + 1) * scfg.d_model,
          f"stablelm: {s_params} parameters, config {scfg.param_count()}")
    serve("stablelm", smodel, True, "paged_attention", extras=False,
          turns=("eager", "graphed", "graphed", "eager"), eager_trace=False)
    r_j = results["stablelm"]
    want_j = {"paged_attention": r_j["decode_dispatches"] * 8 * scfg.n_layers,
              "flash_attention": r_j["prefills"] * scfg.n_layers}
    check({n: r_j["launches"][n] for n in want_j} == want_j,
          f"stablelm: launches {r_j['launches']}, expected {want_j}")
    check(not r_j["final_cache_diff"], "stablelm: final caches differ graphed against eager")
    s_bytes = (s_params - smodel.embed.numel()) * smodel.embed.element_size()
    s_bound = 1e3 * s_bytes / HBM_BYTES_PER_S
    s_step = r_j["traces"]["graphed"]["dispatch_ms"] / 8
    print(f"[stablelm] graphed step {s_step:.3f} ms (a clocked dispatch over K = 8) against a "
          f"bound of {s_bound:.3f} ms ({s_bytes / 1e9:.3f} GB of weights at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {s_step / s_bound:.2f}x")
    r_j.update(params=s_params, config_param_count=scfg.param_count(), step_ms=s_step,
               step_bound_ms=s_bound, step_bytes=s_bytes)
    del smodel
    torch.cuda.empty_cache()
    stamp("paged serving of stablelm-1.6b")

    # ---- path k: Nemotron-4-340B's first layers at full width (squared ReLU,
    # GQA 96/8; the flash, paged and decode kernels at D=192, G=12)
    ncfg = dataclasses.replace(get_arch("nemotron-4-340b"), n_layers=NEMOTRON_LAYERS)
    results["nemotron"], k_calls, k_launches = nemotron_path(
        "nemotron", dev, main_path, caches_equal, ncfg, SEED + 7)
    check(results["nemotron"]["params"] == Model(ncfg, device="meta").param_count(),
          "nemotron: the model on the card and on meta count different parameters")
    (kq, kk, kv), kkw = k_calls["flash_attention"]
    check(tuple(kq.shape[2:]) == (96, 192) and tuple(kk.shape[2:]) == (8, 192),
          f"nemotron: the recorded flash call is not D=192, G=12: {tuple(kq.shape)}, "
          f"{tuple(kk.shape)}")
    stamp(f"nemotron-4-340b, {NEMOTRON_LAYERS} layers, paged and contiguous")

    # ---- path l: SeamlessM4T-large-v2 at full width and depth (an encoder of
    # 1,536 frames, cross-attention; flash not causal and at Sq != Skv, decode
    # over the encoder's K/V)
    ecfg = get_arch("seamless-m4t-large-v2")
    results["seamless"], l_calls, l_launches = encdec_path("seamless", dev, main_path, ecfg,
                                                           SEED + 8)
    check(results["seamless"]["params"] == Model(ecfg, device="meta").param_count(),
          "seamless: the model on the card and on meta count different parameters")
    stamp("seamless-m4t-large-v2 prefill over 1,536 frames and 32 steps")

    # ---- path m: Qwen2-VL-72B's first layers at full width (M-RoPE; flash,
    # paged and decode at D=128, G=8)
    vcfg = dataclasses.replace(get_arch("qwen2-vl-72b"), n_layers=QWEN2VL_LAYERS)
    results["qwen2-vl"], vlm_embeds, vlm_pos = vlm_path("qwen2-vl", dev, main_path, caches_equal,
                                                        vcfg, SEED + 9)
    check(results["qwen2-vl"]["params"] == Model(vcfg, device="meta").param_count(),
          "qwen2-vl: the model on the card and on meta count different parameters")
    stamp(f"qwen2-vl-72b, {QWEN2VL_LAYERS} layers, forward, paged and contiguous")
    # the kernels on the inputs the main paths gave them
    entries = []
    (fq, fk, fv), fkw = flash_call
    fkw = {"causal": fkw.get("causal", True), "window": fkw.get("window")}
    f_out, f_want = flash_kernel(fq, fk, fv, **fkw), flash_plain(fq, fk, fv, **fkw)
    f_err = (f_out.float() - f_want.float()).abs().max().item()
    f_rel = row_rel_err(f_out, f_want)
    check(f_err <= TOL[fq.dtype] and f_rel <= TOL[fq.dtype], f"flash on main-path inputs: max "
          f"abs err {f_err:.3g}, row-relative {f_rel:.3g} > {TOL[fq.dtype]}")
    f_max = f_want.float().abs().max().item()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f_bound, f_by = bound_ms(*flash_work(fq, fk, fkw["window"]), fq.dtype)
    entries.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=paged_counts["flash_attention"], max_abs_err=f_err, atol=TOL[fq.dtype], rtol=0.0,
        row_rel_err=f_rel, out_max=f_max,
        ms=timed_ms(lambda: flash_kernel(fq, fk, fv, **fkw), 20, flush),
        plain_ms=timed_ms(lambda: flash_plain(fq, fk, fv, **fkw), 5, flush),
        bound_ms=f_bound, bound_by=f_by,
        library_ms=timed_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20, flush),
        shape=dict(q=list(fq.shape), k=list(fk.shape), dtype=str(fq.dtype))))
    pargs, _ = paged_call
    p_out, p_want = paged_kernel(*pargs), paged_plain(*pargs)
    p_err = (p_out.float() - p_want.float()).abs().max().item()
    p_rel = row_rel_err(p_out, p_want)
    check(p_err <= TOL[pargs[0].dtype] and p_rel <= TOL[pargs[0].dtype],
          f"paged on main-path inputs: max abs err {p_err:.3g}, row-relative {p_rel:.3g}")
    p_bound, p_by = bound_ms(*paged_work(pargs[0], pargs[1], pargs[3], pargs[4]),
                             pargs[0].dtype)
    entries.append(dict(
        name="paged_attention", route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:116",
        launches=paged_counts["paged_attention"], max_abs_err=p_err, atol=TOL[pargs[0].dtype],
        rtol=0.0, row_rel_err=p_rel, out_max=p_want.float().abs().max().item(),
        ms=timed_ms(lambda: paged_kernel(*pargs), 50, flush),
        plain_ms=timed_ms(lambda: paged_plain(*pargs), 10, flush),
        bound_ms=p_bound, bound_by=p_by, library_ms=None,
        shape=dict(q=list(pargs[0].shape), pool=list(pargs[1].shape),
                   table=list(pargs[3].shape), lengths=pargs[4].tolist(),
                   dtype=str(pargs[0].dtype))))
    pargs4, _ = paged4_call
    p4_out, p4_want = paged_kernel(*pargs4), paged_plain(*pargs4)
    p4_err = (p4_out.float() - p4_want.float()).abs().max().item()
    p4_rel = row_rel_err(p4_out, p4_want)
    check(p4_err <= TOL[pargs4[0].dtype] and p4_rel <= TOL[pargs4[0].dtype],
          f"paged D=128 on main-path inputs: max abs err {p4_err:.3g}, row-relative {p4_rel:.3g}")
    p4_bound, p4_by = bound_ms(*paged_work(pargs4[0], pargs4[1], pargs4[3], pargs4[4]),
                               pargs4[0].dtype)
    entries.append(dict(
        name="paged_attention_d128", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:116",
        launches=paged4_counts["paged_attention"], max_abs_err=p4_err,
        atol=TOL[pargs4[0].dtype], rtol=0.0, row_rel_err=p4_rel,
        out_max=p4_want.float().abs().max().item(),
        ms=timed_ms(lambda: paged_kernel(*pargs4), 50, flush),
        plain_ms=timed_ms(lambda: paged_plain(*pargs4), 10, flush),
        bound_ms=p4_bound, bound_by=p4_by, library_ms=None,
        span_launches={pair: r["launches"]["paged_attention"]
                       for pair, r in results["speculative_bf16"].items()},
        shape=dict(q=list(pargs4[0].shape), pool=list(pargs4[1].shape),
                   table=list(pargs4[3].shape), lengths=pargs4[4].tolist(),
                   dtype=str(pargs4[0].dtype))))
    # flash at D=128: Qwen1.5-4B's prefill on path g
    (hq, hk, hv), hkw = g_recorded["flash_attention", qcfg.head_dim]
    hkw = {"causal": hkw.get("causal", True), "window": hkw.get("window")}
    h_out, h_want = flash_kernel(hq, hk, hv, **hkw), flash_plain(hq, hk, hv, **hkw)
    h_err = (h_out.float() - h_want.float()).abs().max().item()
    h_rel = row_rel_err(h_out, h_want)
    check(h_err <= TOL[hq.dtype] and h_rel <= TOL[hq.dtype], f"flash d128 on main-path inputs: "
          f"max abs err {h_err:.3g}, row-relative {h_rel:.3g} > {TOL[hq.dtype]}")
    hqt, hkt, hvt = (x.transpose(1, 2).contiguous() for x in (hq, hk, hv))
    h_bound, h_by = bound_ms(*flash_work(hq, hk, hkw["window"]), hq.dtype)
    entries.append(dict(
        name="flash_attention_d128", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=results["control_plane"]["launches_by_width"][qcfg.head_dim][
            "flash_attention"],
        max_abs_err=h_err, atol=TOL[hq.dtype], rtol=0.0, row_rel_err=h_rel,
        out_max=h_want.float().abs().max().item(),
        ms=timed_ms(lambda: flash_kernel(hq, hk, hv, **hkw), 50, flush),
        plain_ms=timed_ms(lambda: flash_plain(hq, hk, hv, **hkw), 10, flush),
        bound_ms=h_bound, bound_by=h_by,
        library_ms=timed_ms(lambda: sdpa(hqt, hkt, hvt, is_causal=True), 50, flush),
        shape=dict(q=list(hq.shape), k=list(hk.shape), dtype=str(hq.dtype))))
    # flash and paged at D=128, G=8: Qwen3-30B-A3B's prefill and decode on path i
    (iq, ik, iv), ikw = moe_flash_call
    ikw = {"causal": ikw.get("causal", True), "window": ikw.get("window")}
    i_out, i_want = flash_kernel(iq, ik, iv, **ikw), flash_plain(iq, ik, iv, **ikw)
    i_err = (i_out.float() - i_want.float()).abs().max().item()
    i_rel = row_rel_err(i_out, i_want)
    check(i_err <= TOL[iq.dtype] and i_rel <= TOL[iq.dtype], f"flash d128 g8 on main-path "
          f"inputs: max abs err {i_err:.3g}, row-relative {i_rel:.3g} > {TOL[iq.dtype]}")
    iG = iq.shape[2] // ik.shape[2]
    iqt = iq.transpose(1, 2).contiguous()
    ikt, ivt = (x.repeat_interleave(iG, dim=2).transpose(1, 2).contiguous() for x in (ik, iv))
    i_bound, i_by = bound_ms(*flash_work(iq, ik, ikw["window"]), iq.dtype)
    entries.append(dict(
        name="flash_attention_d128_g8", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=moe_counts["flash_attention"], max_abs_err=i_err, atol=TOL[iq.dtype],
        rtol=0.0, row_rel_err=i_rel, out_max=i_want.float().abs().max().item(),
        ms=timed_ms(lambda: flash_kernel(iq, ik, iv, **ikw), 50, flush),
        plain_ms=timed_ms(lambda: flash_plain(iq, ik, iv, **ikw), 10, flush),
        bound_ms=i_bound, bound_by=i_by,
        library_ms=timed_ms(lambda: sdpa(iqt, ikt, ivt, is_causal=True), 50, flush),
        shape=dict(q=list(iq.shape), k=list(ik.shape), dtype=str(iq.dtype))))
    del i_out, i_want
    pargs8, _ = moe_paged_call
    p8_out, p8_want = paged_kernel(*pargs8), paged_plain(*pargs8)
    p8_err = (p8_out.float() - p8_want.float()).abs().max().item()
    p8_rel = row_rel_err(p8_out, p8_want)
    check(p8_err <= TOL[pargs8[0].dtype] and p8_rel <= TOL[pargs8[0].dtype],
          f"paged D=128 G=8 on main-path inputs: max abs err {p8_err:.3g}, row-relative "
          f"{p8_rel:.3g}")
    p8_bound, p8_by = bound_ms(*paged_work(pargs8[0], pargs8[1], pargs8[3], pargs8[4]),
                               pargs8[0].dtype)
    entries.append(dict(
        name="paged_attention_d128_g8", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:116",
        launches=moe_counts["paged_attention"], max_abs_err=p8_err,
        atol=TOL[pargs8[0].dtype], rtol=0.0, row_rel_err=p8_rel,
        out_max=p8_want.float().abs().max().item(),
        ms=timed_ms(lambda: paged_kernel(*pargs8), 50, flush),
        plain_ms=timed_ms(lambda: paged_plain(*pargs8), 10, flush),
        bound_ms=p8_bound, bound_by=p8_by, library_ms=None,
        shape=dict(q=list(pargs8[0].shape), pool=list(pargs8[1].shape),
                   table=list(pargs8[3].shape), lengths=pargs8[4].tolist(),
                   dtype=str(pargs8[0].dtype))))
    (dq, dk, dv, dlen), _ = decode_call
    dk, dv = horizon_view(dk, SERVE_MAX_LEN), horizon_view(dv, SERVE_MAX_LEN)
    d_out, d_want = decode_kernel(dq, dk, dv, dlen), decode_plain(dq, dk, dv, dlen)
    d_err = (d_out.float() - d_want.float()).abs().max().item()
    d_rel = row_rel_err(d_out, d_want)
    check(d_err <= TOL[dq.dtype] and d_rel <= TOL[dq.dtype],
          f"decode on main-path inputs: max abs err {d_err:.3g}, row-relative {d_rel:.3g}")
    # the library yardstick: SDPA over (B, H, S, D) with the length mask
    G = dq.shape[2] // dk.shape[2]
    sq = dq.transpose(1, 2).contiguous()
    sk, sv = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() for x in (dk, dv))
    smask = (torch.arange(dk.shape[1], device=dev)[None, :] < dlen[:, None])[:, None, None, :]
    d_bound, d_by = bound_ms(*decode_work(dq, dk, dlen), dq.dtype)
    entries.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:83",
        launches=contig_counts["decode_attention"], max_abs_err=d_err, atol=TOL[dq.dtype],
        rtol=0.0, row_rel_err=d_rel, out_max=d_want.float().abs().max().item(),
        ms=timed_ms(lambda: decode_kernel(dq, dk, dv, dlen), 50, flush),
        plain_ms=timed_ms(lambda: decode_plain(dq, dk, dv, dlen), 10, flush),
        bound_ms=d_bound, bound_by=d_by,
        library_ms=timed_ms(lambda: sdpa(sq, sk, sv, attn_mask=smask), 50, flush),
        shape=dict(q=list(dq.shape), k=list(dk.shape), k_stride=list(dk.stride()),
                   lengths=dlen.tolist(), dtype=str(dq.dtype))))
    wkv6_extra = {}
    for idx, label in ((rcfg.n_layers, "decode"), (0, "prefill")):
        wargs, _ = wkv6_calls[idx]
        w_out, w_st = wkv6_kernel(*wargs)
        w_out_p, w_st_p = wkv6_plain(*wargs)
        w_err, w_rel = scaled_err(w_out, w_out_p)
        w_serr, w_srel = scaled_err(w_st, w_st_p)
        check(w_rel <= TOL[wargs[0].dtype] and w_srel <= TOL[torch.float32],
              f"wkv6 on main-path {label} inputs: {w_err:.3g} (scaled {w_rel:.3g}), state "
              f"{w_serr:.3g}")
        w_bound, w_by = bound_ms(*wkv6_work(wargs[0], wargs[5]), torch.float32)
        wkv6_extra[label] = dict(
            max_abs_err=w_err, scaled_err=w_rel, state_err=w_serr, atol=TOL[wargs[0].dtype],
            rtol=TOL[wargs[0].dtype],
            ms=timed_ms(lambda: wkv6_kernel(*wargs), 20, flush),
            plain_ms=timed_ms(lambda: wkv6_plain(*wargs), 3 if label == "prefill" else 10,
                              flush),
            bound_ms=w_bound, bound_by=w_by,
            shape=dict(r=list(wargs[0].shape), dtype=str(wargs[0].dtype)))
    wp = wkv6_extra["prefill"]
    entries.append(dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:94", launches=rwkv_counts["wkv6"],
        max_abs_err=wp["max_abs_err"], atol=wp["atol"], rtol=wp["rtol"], ms=wp["ms"],
        plain_ms=wp["plain_ms"],
        bound_ms=wp["bound_ms"], bound_by=wp["bound_by"], library_ms=None,
        shape=wp["shape"], decode_step=wkv6_extra["decode"]))
    rglru_extra = {}
    for idx, label in ((n_rec, "decode"), (0, "prefill")):
        gargs, _ = rglru_calls[idx]
        g_out, g_st = rglru_kernel(*gargs)
        g_out_p, g_st_p = rglru_plain(*gargs)
        g_err, g_rel = scaled_err(g_out, g_out_p)
        g_serr, g_srel = scaled_err(g_st, g_st_p)
        check(g_rel <= TOL[gargs[0].dtype] and g_srel <= TOL[torch.float32],
              f"rglru on main-path {label} inputs: {g_err:.3g} (scaled {g_rel:.3g}), state "
              f"{g_serr:.3g}")
        g_bound, g_by = bound_ms(*rglru_work(gargs[0], gargs[2]), torch.float32)
        rglru_extra[label] = dict(
            max_abs_err=g_err, scaled_err=g_rel, state_err=g_serr, atol=TOL[gargs[0].dtype],
            rtol=TOL[gargs[0].dtype],
            ms=timed_ms(lambda: rglru_kernel(*gargs), 20, flush),
            plain_ms=timed_ms(lambda: rglru_plain(*gargs), 3 if label == "prefill" else 10,
                              flush),
            bound_ms=g_bound, bound_by=g_by,
            shape=dict(x=list(gargs[0].shape), dtype=str(gargs[0].dtype),
                       state=gargs[2] is not None))
    gp = rglru_extra["prefill"]
    entries.append(dict(
        name="rglru_scan", route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:69", launches=g_counts["rglru_scan"],
        max_abs_err=gp["max_abs_err"], atol=gp["atol"], rtol=gp["rtol"], ms=gp["ms"],
        plain_ms=gp["plain_ms"], bound_ms=gp["bound_ms"], bound_by=gp["bound_by"],
        library_ms=None, shape=gp["shape"], decode_step=rglru_extra["decode"]))
    (gq, gk, gv), gkw = g_flash_calls[0]
    gkw = {"causal": gkw.get("causal", True), "window": gkw.get("window")}
    check(gkw["window"] == gcfg.window, f"recurrentgemma flash saw window {gkw['window']}")
    gf_out, gf_want = flash_kernel(gq, gk, gv, **gkw), flash_plain(gq, gk, gv, **gkw)
    gf_err = (gf_out.float() - gf_want.float()).abs().max().item()
    gf_rel = row_rel_err(gf_out, gf_want)
    check(gf_rel <= TOL[gq.dtype], f"flash d256 on main-path inputs: max abs err {gf_err:.3g}, "
          f"row-relative {gf_rel:.3g} > {TOL[gq.dtype]}")
    gf_max = gf_want.float().abs().max().item()
    del gf_out, gf_want
    G = gq.shape[2] // gk.shape[2]
    gqt = gq.transpose(1, 2).contiguous()
    gkt, gvt = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() for x in (gk, gv))
    pos = torch.arange(gq.shape[1], device=dev)
    win_mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - gkw["window"])
    gf_bound, gf_by = bound_ms(*flash_work(gq, gk, gkw["window"]), gq.dtype)
    entries.append(dict(
        name="flash_attention_d256", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=g_counts["flash_attention"], max_abs_err=gf_err, atol=0.0,
        rtol=TOL[gq.dtype], scale="row", row_rel_err=gf_rel, out_max=gf_max,
        ms=timed_ms(lambda: flash_kernel(gq, gk, gv, **gkw), 10, flush),
        plain_ms=timed_ms(lambda: flash_plain(gq, gk, gv, **gkw), 3, flush),
        bound_ms=gf_bound, bound_by=gf_by,
        library_ms=timed_ms(lambda: sdpa(gqt, gkt, gvt, attn_mask=win_mask), 10, flush),
        shape=dict(q=list(gq.shape), k=list(gk.shape), window=gkw["window"],
                   dtype=str(gq.dtype))))
    (eq, ek, ev, elen), _ = g_decode_calls[0]
    ge_out, ge_want = decode_kernel(eq, ek, ev, elen), decode_plain(eq, ek, ev, elen)
    ge_err = (ge_out.float() - ge_want.float()).abs().max().item()
    ge_rel = row_rel_err(ge_out, ge_want)
    check(ge_rel <= TOL[eq.dtype], f"decode d256 on main-path inputs: max abs err "
          f"{ge_err:.3g}, row-relative {ge_rel:.3g} > {TOL[eq.dtype]}")
    ge_max = ge_want.float().abs().max().item()
    G = eq.shape[2] // ek.shape[2]
    eqt = eq.transpose(1, 2).contiguous()
    ekt, evt = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() for x in (ek, ev))
    emask = (torch.arange(ek.shape[1], device=dev)[None, :] < elen[:, None])[:, None, None, :]
    ge_bound, ge_by = bound_ms(*decode_work(eq, ek, elen), eq.dtype)
    entries.append(dict(
        name="decode_attention_d256", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:83",
        launches=g_counts["decode_attention"], max_abs_err=ge_err, atol=0.0,
        rtol=TOL[eq.dtype], scale="row", row_rel_err=ge_rel, out_max=ge_max,
        ms=timed_ms(lambda: decode_kernel(eq, ek, ev, elen), 50, flush),
        plain_ms=timed_ms(lambda: decode_plain(eq, ek, ev, elen), 10, flush),
        bound_ms=ge_bound, bound_by=ge_by,
        library_ms=timed_ms(lambda: sdpa(eqt, ekt, evt, attn_mask=emask), 50, flush),
        shape=dict(q=list(eq.shape), k=list(ek.shape), lengths=elen.tolist(),
                   dtype=str(eq.dtype))))
    # flash, paged and decode at D=192, G=12: Nemotron-4-340B's prefill and its
    # paged and contiguous decode on path k
    kkw = {"causal": kkw.get("causal", True), "window": kkw.get("window")}
    k_out, k_want = flash_kernel(kq, kk, kv, **kkw), flash_plain(kq, kk, kv, **kkw)
    k_err = (k_out.float() - k_want.float()).abs().max().item()
    k_rel = row_rel_err(k_out, k_want)
    check(k_err <= TOL[kq.dtype] and k_rel <= TOL[kq.dtype], f"flash d192 g12 on main-path "
          f"inputs: max abs err {k_err:.3g}, row-relative {k_rel:.3g} > {TOL[kq.dtype]}")
    k_max = k_want.float().abs().max().item()
    del k_out, k_want
    kG = kq.shape[2] // kk.shape[2]
    kqt = kq.transpose(1, 2).contiguous()
    kkt, kvt = (x.repeat_interleave(kG, dim=2).transpose(1, 2).contiguous() for x in (kk, kv))
    k_bound, k_by = bound_ms(*flash_work(kq, kk, kkw["window"]), kq.dtype)
    entries.append(dict(
        name="flash_attention_d192_g12", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=sum(c["flash_attention"] for c in k_launches.values()), max_abs_err=k_err,
        atol=TOL[kq.dtype], rtol=0.0, row_rel_err=k_rel, out_max=k_max,
        ms=timed_ms(lambda: flash_kernel(kq, kk, kv, **kkw), 50, flush),
        plain_ms=timed_ms(lambda: flash_plain(kq, kk, kv, **kkw), 5, flush),
        bound_ms=k_bound, bound_by=k_by,
        library_ms=timed_ms(lambda: sdpa(kqt, kkt, kvt, is_causal=True), 50, flush),
        shape=dict(q=list(kq.shape), k=list(kk.shape), dtype=str(kq.dtype))))
    pargs12, _ = k_calls["paged_attention"]
    check(tuple(pargs12[0].shape[2:]) == (96, 192) and pargs12[1].shape[2:] == (8, 192),
          f"nemotron: the recorded paged call is not D=192, G=12: "
          f"{[tuple(a.shape) for a in pargs12[:2]]}")
    p12_out, p12_want = paged_kernel(*pargs12), paged_plain(*pargs12)
    p12_err = (p12_out.float() - p12_want.float()).abs().max().item()
    p12_rel = row_rel_err(p12_out, p12_want)
    check(p12_err <= TOL[pargs12[0].dtype] and p12_rel <= TOL[pargs12[0].dtype],
          f"paged D=192 G=12 on main-path inputs: max abs err {p12_err:.3g}, row-relative "
          f"{p12_rel:.3g}")
    p12_bound, p12_by = bound_ms(*paged_work(pargs12[0], pargs12[1], pargs12[3], pargs12[4]),
                                 pargs12[0].dtype)
    entries.append(dict(
        name="paged_attention_d192_g12", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:116",
        launches=k_launches["paged"]["paged_attention"], max_abs_err=p12_err,
        atol=TOL[pargs12[0].dtype], rtol=0.0, row_rel_err=p12_rel,
        out_max=p12_want.float().abs().max().item(),
        ms=timed_ms(lambda: paged_kernel(*pargs12), 50, flush),
        plain_ms=timed_ms(lambda: paged_plain(*pargs12), 10, flush),
        bound_ms=p12_bound, bound_by=p12_by, library_ms=None,
        shape=dict(q=list(pargs12[0].shape), pool=list(pargs12[1].shape),
                   table=list(pargs12[3].shape), lengths=pargs12[4].tolist(),
                   dtype=str(pargs12[0].dtype))))
    (cq, ck, cv, clen), _ = k_calls["decode_attention"]
    ck, cv = horizon_view(ck, SERVE_MAX_LEN), horizon_view(cv, SERVE_MAX_LEN)
    c_out, c_want = decode_kernel(cq, ck, cv, clen), decode_plain(cq, ck, cv, clen)
    c_err = (c_out.float() - c_want.float()).abs().max().item()
    c_rel = row_rel_err(c_out, c_want)
    check(c_err <= TOL[cq.dtype] and c_rel <= TOL[cq.dtype],
          f"decode D=192 G=12 on main-path inputs: max abs err {c_err:.3g}, row-relative "
          f"{c_rel:.3g}")
    cG = cq.shape[2] // ck.shape[2]
    cqt = cq.transpose(1, 2).contiguous()
    ckt, cvt = (x.repeat_interleave(cG, dim=2).transpose(1, 2).contiguous() for x in (ck, cv))
    cmask = (torch.arange(ck.shape[1], device=dev)[None, :] < clen[:, None])[:, None, None, :]
    c_bound, c_by = bound_ms(*decode_work(cq, ck, clen), cq.dtype)
    entries.append(dict(
        name="decode_attention_d192_g12", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:83",
        launches=k_launches["contiguous"]["decode_attention"], max_abs_err=c_err,
        atol=TOL[cq.dtype], rtol=0.0, row_rel_err=c_rel,
        out_max=c_want.float().abs().max().item(),
        ms=timed_ms(lambda: decode_kernel(cq, ck, cv, clen), 50, flush),
        plain_ms=timed_ms(lambda: decode_plain(cq, ck, cv, clen), 10, flush),
        bound_ms=c_bound, bound_by=c_by,
        library_ms=timed_ms(lambda: sdpa(cqt, ckt, cvt, attn_mask=cmask), 50, flush),
        shape=dict(q=list(cq.shape), k=list(ck.shape), k_stride=list(ck.stride()),
                   lengths=clen.tolist(), dtype=str(cq.dtype))))
    # flash without the causal mask (the encoder) and at Sq != Skv (the
    # cross-attention), and decode over the encoder's K/V: path l's first
    # eager calls; SDPA beside each (not causal, no mask)
    lib_l = {}
    for name, ((lq, lk, lv, *rest), lkw) in l_calls.items():
        if name.startswith("flash"):
            lkw = {"causal": lkw.get("causal", True), "window": lkw.get("window")}
            check(not lkw["causal"], f"{name}: the recorded call is causal")
            run_k = (lambda lq=lq, lk=lk, lv=lv, lkw=lkw: flash_kernel(lq, lk, lv, **lkw))
            run_p = (lambda lq=lq, lk=lk, lv=lv, lkw=lkw: flash_plain(lq, lk, lv, **lkw))
            work = flash_work(lq, lk, lkw["window"], causal=False)
            source, replaces = ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:124")
            shape = dict(q=list(lq.shape), k=list(lk.shape), causal=False, dtype=str(lq.dtype))
            tq = lq.transpose(1, 2).contiguous()
        else:
            llen = rest[0]
            run_k = (lambda lq=lq, lk=lk, lv=lv, llen=llen: decode_kernel(lq, lk, lv, llen))
            run_p = (lambda lq=lq, lk=lk, lv=lv, llen=llen: decode_plain(lq, lk, lv, llen))
            work = decode_work(lq, lk, llen)
            check(bool(llen.eq(lk.shape[1]).all()), f"{name}: not every frame is valid")
            source, replaces = ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:83")
            shape = dict(q=list(lq.shape), k=list(lk.shape), lengths=llen.tolist(),
                         dtype=str(lq.dtype))
            tq = lq.transpose(1, 2).contiguous()
        lG = lq.shape[2] // lk.shape[2]
        tk, tv = (x.repeat_interleave(lG, dim=2).transpose(1, 2).contiguous() for x in (lk, lv))
        lib_l[name] = (lambda tq=tq, tk=tk, tv=tv: sdpa(tq, tk, tv), run_k,
                       "flash_" if name.startswith("flash") else "decode_")
        l_out, l_want = run_k(), run_p()
        l_err = (l_out.float() - l_want.float()).abs().max().item()
        l_rel = row_rel_err(l_out, l_want)
        check(l_err <= TOL[lq.dtype] and l_rel <= TOL[lq.dtype], f"{name} on main-path "
              f"inputs: max abs err {l_err:.3g}, row-relative {l_rel:.3g} > {TOL[lq.dtype]}")
        l_bound, l_by = bound_ms(*work, lq.dtype)
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=l_launches[name], max_abs_err=l_err, atol=TOL[lq.dtype], rtol=0.0,
            row_rel_err=l_rel, out_max=l_want.float().abs().max().item(),
            ms=timed_ms(run_k, 20 if name.endswith("encoder") else 50, flush),
            plain_ms=timed_ms(run_p, 5, flush), bound_ms=l_bound, bound_by=l_by,
            library_ms=timed_ms(lib_l[name][0], 20 if name.endswith("encoder") else 50, flush),
            shape=shape))
        del l_out, l_want
    # the backward kernel at h1's and h3's first call; the library call is
    # SDPA's backward on the same tensors (its gradients' autograd call);
    # ``traced_ms`` is the kernel's time a call in h1's traced training step
    bwd_lib = {}
    h1_trace = results["train"]["traced_step"]
    h1_traced_ms = (None if h1_trace["device_ms"] is None
                    else h1_trace["backward_ms"] / h1_trace["backward_calls"])
    for name, ((bq, bk, bv, bdo), bkw), h_counts, traced in (
            ("flash_attention_bwd", h1_call, results["train"]["launches"], h1_traced_ms),
            ("flash_attention_bwd_d32", h3_call, results["tiny_pool"]["launches"], None)):
        bkw = {"causal": bkw.get("causal", True), "window": bkw.get("window")}
        b_out, b_want = bwd_kernel(bq, bk, bv, bdo, **bkw), bwd_plain(bq, bk, bv, bdo, **bkw)
        b_err = max((a.float() - w.float()).abs().max().item() for a, w in zip(b_out, b_want))
        b_rel = max(row_rel_err(a, w) for a, w in zip(b_out, b_want))
        b_tol = BWD_TOL[bq.dtype]
        check(b_rel <= b_tol, f"{name} on main-path inputs: row-relative {b_rel:.3g} > {b_tol}")
        b_max = max(w.float().abs().max().item() for w in b_want)
        del b_out, b_want
        G = bq.shape[2] // bk.shape[2]
        lq = bq.transpose(1, 2).contiguous().requires_grad_()
        lk, lv = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_()
                  for x in (bk, bv))
        ldo = bdo.transpose(1, 2).contiguous()
        lo = sdpa(lq, lk, lv, is_causal=True)

        def lib_bwd(lo=lo, lq=lq, lk=lk, lv=lv, ldo=ldo):
            return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

        bwd_lib[name] = lib_bwd
        b_bound, b_by = bound_ms(*bwd_work(bq, bk, bkw["window"]), bq.dtype)
        entries.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/ops.py:57 (jax.grad of _flash_jnp; no pallas_call)",
            launches=h_counts["flash_attention_bwd"], max_abs_err=b_err, atol=0.0, rtol=b_tol,
            scale="row", row_rel_err=b_rel, out_max=b_max,
            ms=timed_ms(lambda bq=bq, bk=bk, bv=bv, bdo=bdo, bkw=bkw: bwd_kernel(
                bq, bk, bv, bdo, **bkw), 20, flush),
            plain_ms=timed_ms(lambda bq=bq, bk=bk, bv=bv, bdo=bdo, bkw=bkw: bwd_plain(
                bq, bk, bv, bdo, **bkw), 5, flush),
            bound_ms=b_bound, bound_by=b_by, library_ms=timed_ms(lib_bwd, 20, flush),
            traced_ms=traced,
            shape=dict(q=list(bq.shape), k=list(bk.shape), window=bkw["window"],
                       dtype=str(bq.dtype))))
    # the recurrences' backward kernels and the flash backward at D=256, at
    # paths n's and o's first calls; the library call beside D=256 is SDPA's
    # backward with the causal-and-window mask on the same tensors, and the
    # recurrences have none (no single PyTorch call computes their gradient);
    # ``traced_ms`` is the kernel's time a call in its path's traced step
    new_bwd = {}
    for name, key, frag, source, replaces in (
            ("wkv6_bwd", "wkv6_bwd", RECURRENT_BWD_KERNELS["wkv6_bwd"],
             "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
             "src/repro/kernels/ops.py:271 (jax.grad of _wkv6_jnp; no pallas_call)"),
            ("rglru_bwd", "rglru_bwd", RECURRENT_BWD_KERNELS["rglru_bwd"],
             "src/repro_torch/csrc/rglru_scan_bwd.cu",
             "src/repro/kernels/ops.py:329 (jax.grad of _rglru_jnp; no pallas_call)"),
            ("flash_attention_bwd_d256", "flash_attention_bwd", BWD_KERNELS,
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/ops.py:57 (jax.grad of _flash_jnp; no pallas_call)")):
        (nargs, nkw), path_res = recurrent_calls[key]
        run_k = (lambda f=kernel[key], a=nargs, kw=nkw: f(*a, **kw))
        run_p = (lambda f=plain[key], a=nargs, kw=nkw: f(*a, **kw))
        n_out, n_want = run_k(), run_p()
        n_err = max((a.float() - w.float()).abs().max().item() for a, w in zip(n_out, n_want))
        n_rel = max(row_rel_err(a, w) for a, w in zip(n_out, n_want))
        n_tol = BWD_TOL[nargs[0].dtype]
        check(n_rel <= n_tol, f"{name} on main-path inputs: row-relative {n_rel:.3g} > {n_tol}")
        n_max = max(w.float().abs().max().item() for w in n_want)
        del n_out, n_want
        lib_n = None
        if key == "wkv6_bwd":
            work, shape = wkv6_bwd_work(nargs[0], nargs[6], nargs[7]), dict(
                r=list(nargs[0].shape), state=nargs[6] is not None, dtype=str(nargs[0].dtype))
        elif key == "rglru_bwd":
            work, shape = rglru_bwd_work(nargs[0], nargs[3], nargs[4]), dict(
                x=list(nargs[0].shape), state=nargs[3] is not None, dtype=str(nargs[0].dtype))
        else:
            nq, nk, nv, ndo = nargs
            work = bwd_work(nq, nk, nkw["window"])
            shape = dict(q=list(nq.shape), k=list(nk.shape), window=nkw["window"],
                         dtype=str(nq.dtype))
            G = nq.shape[2] // nk.shape[2]
            lq = nq.transpose(1, 2).contiguous().requires_grad_()
            lk, lv = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                      .requires_grad_() for x in (nk, nv))
            npos = torch.arange(nq.shape[1], device=dev)
            nmask = (npos[None, :] <= npos[:, None]) & (
                npos[None, :] > npos[:, None] - (nkw["window"] or nq.shape[1]))
            lo = sdpa(lq, lk, lv, attn_mask=nmask)
            ldo = ndo.transpose(1, 2).contiguous()

            def lib_n(lo=lo, lq=lq, lk=lk, lv=lv, ldo=ldo):
                return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

            bwd_lib[name] = lib_n
        n_bound, n_by = bound_ms(*work, nargs[0].dtype if key == "flash_attention_bwd"
                                 else torch.float32)
        traced_step = path_res["traced_step"]
        n_traced = (None if traced_step["device_ms"] is None
                    else traced_step["backward_ms"][key] / traced_step["backward_calls"][key])
        iters = 5 if key == "flash_attention_bwd" else 20
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_res["launches"][key], max_abs_err=n_err, atol=0.0, rtol=n_tol,
            scale="row", row_rel_err=n_rel, out_max=n_max,
            ms=timed_ms(run_k, iters, flush), plain_ms=timed_ms(run_p, 2, flush),
            bound_ms=n_bound, bound_by=n_by,
            library_ms=None if lib_n is None else timed_ms(lib_n, iters, flush),
            traced_ms=n_traced, shape=shape))
        new_bwd[name] = (run_k, frag, iters)
    # CUPTI device time a call, read after every event timing of the run (a
    # process that has run the profiler pays more host time a launch), each
    # call after a reading flush of the 128 MB buffer; the name fragment
    # takes in every kernel a call runs
    (wpa, _), (wda, _) = wkv6_calls[0], wkv6_calls[rcfg.n_layers]
    (gpa, _), (gda, _) = rglru_calls[0], rglru_calls[n_rec]
    cupti = {"flash_attention": (lambda: flash_kernel(fq, fk, fv, **fkw), "flash_", 50),
             "paged_attention": (lambda: paged_kernel(*pargs), "paged_decode_kernel", 50),
             "paged_attention_d128": (lambda: paged_kernel(*pargs4), "paged_decode_kernel", 50),
             "flash_attention_d128": (lambda: flash_kernel(hq, hk, hv, **hkw), "flash_", 50),
             "flash_attention_d128_g8": (lambda: flash_kernel(iq, ik, iv, **ikw), "flash_", 50),
             "paged_attention_d128_g8": (lambda: paged_kernel(*pargs8), "paged_decode_kernel",
                                         50),
             "decode_attention": (lambda: decode_kernel(dq, dk, dv, dlen), "decode_", 50),
             "wkv6": (lambda: wkv6_kernel(*wpa), "wkv6_", 50),
             "rglru_scan": (lambda: rglru_kernel(*gpa), "rglru_", 50),
             "flash_attention_d256": (lambda: flash_kernel(gq, gk, gv, **gkw), "flash_", 20),
             "decode_attention_d256": (lambda: decode_kernel(eq, ek, ev, elen), "decode_", 50),
             "flash_attention_d192_g12": (lambda: flash_kernel(kq, kk, kv, **kkw), "flash_", 50),
             "paged_attention_d192_g12": (lambda: paged_kernel(*pargs12), "paged_decode_kernel",
                                          50),
             "decode_attention_d192_g12": (lambda: decode_kernel(cq, ck, cv, clen), "decode_",
                                           50),
             "flash_attention_bwd": (lambda: bwd_kernel(*h1_call[0], **h1_call[1]),
                                     BWD_KERNELS, 20),
             "flash_attention_bwd_d32": (lambda: bwd_kernel(*h3_call[0], **h3_call[1]),
                                         BWD_KERNELS, 50),
             **new_bwd,
             **{n: (run_k, frag, 20 if n.endswith("encoder") else 50)
                for n, (_, run_k, frag) in lib_l.items()}}
    # the library calls the same way, by CUPTI (SDPA's backward: its
    # gradients' autograd call)
    library = {"flash_attention": (lambda: sdpa(qt, kt, vt, is_causal=True), 50),
               "flash_attention_d128": (lambda: sdpa(hqt, hkt, hvt, is_causal=True), 50),
               "flash_attention_d128_g8": (lambda: sdpa(iqt, ikt, ivt, is_causal=True), 50),
               "decode_attention": (lambda: sdpa(sq, sk, sv, attn_mask=smask), 50),
               "flash_attention_d256": (lambda: sdpa(gqt, gkt, gvt, attn_mask=win_mask), 10),
               "decode_attention_d256": (lambda: sdpa(eqt, ekt, evt, attn_mask=emask), 50),
               "flash_attention_d192_g12": (lambda: sdpa(kqt, kkt, kvt, is_causal=True), 50),
               "decode_attention_d192_g12": (lambda: sdpa(cqt, ckt, cvt, attn_mask=cmask), 50),
               **{n: (lib_fn, 20 if n.endswith("encoder") else 50)
                  for n, (lib_fn, _, _) in lib_l.items()}}
    for e in entries:
        fn, frag, iters = cupti[e["name"]]
        records = {}
        e["cupti_ms"] = device_ms(fn, frag, iters, before=flush.max, records=records)
        e["cupti_records"] = records
        e["cupti_records_a_call"] = min((n for n, _ in records.values()), default=0.0)
        e["library_cupti_ms"] = None
        lib_fn, lib_iters = library.get(e["name"], (bwd_lib.get(e["name"]), 20))
        if lib_fn is not None:
            lib_records = {}
            e["library_cupti_ms"] = library_device_ms(lib_fn, lib_iters, before=flush.max,
                                                      records=lib_records)
            e["library_cupti_records"] = lib_records
            e["library_cupti_records_a_call"] = min(
                (n for n, _ in lib_records.values()), default=0.0)
    wkv6_extra["decode"]["cupti_ms"] = device_ms(lambda: wkv6_kernel(*wda), "wkv6_", 50,
                                                 before=flush.max)
    rglru_extra["decode"]["cupti_ms"] = device_ms(lambda: rglru_kernel(*gda), "rglru_", 50,
                                                  before=flush.max)
    for e in entries:
        print(f"[main-path] {e['name']} {e['shape']}: {e['ms']:.4f} ms, CUPTI {e['cupti_ms']} ms "
              f"(bound {e['bound_ms']:.4f} ms by {e['bound_by']}), plain {e['plain_ms']:.4f} ms, "
              f"library {e['library_ms']} (CUPTI {e['library_cupti_ms']}), max|err| "
              f"{e['max_abs_err']:.3g}"
              + (f" (row-relative {e['row_rel_err']:.3g}, max|plain| {e['out_max']:.3g})"
                 if "row_rel_err" in e else "") + f", {e['launches']} launches"
              + f"; CUPTI records {e['cupti_records']}"
              + (f"; library CUPTI records {e['library_cupti_records']}"
                 if "library_cupti_records" in e else "")
              + (f"; traced {e['traced_ms']} ms a call" if "traced_ms" in e else ""))
    for name, wd in (("wkv6", wkv6_extra["decode"]), ("rglru", rglru_extra["decode"])):
        print(f"[main-path] {name} decode step {wd['shape']}: {wd['ms']:.4f} ms, CUPTI "
              f"{wd['cupti_ms']} ms (bound {wd['bound_ms']:.4f} ms by {wd['bound_by']}), plain "
              f"{wd['plain_ms']:.4f} ms, max|err| {wd['max_abs_err']:.3g}")

    stamp("main-path kernel table")
    # ---- 5. parity in fp32: kernels vs plain versions ---------------------
    def parity(label, run):
        before = sum(fn.launches for fn in kernel.values())
        logits_k, streams_k = run()
        check(sum(fn.launches for fn in kernel.values()) > before,
              f"{label}: fp32 run launched no kernel")
        with plain_kernels():
            logits_p, streams_p = run()
        logit_err = (logits_k - logits_p).abs().max().item()
        same = sum(a == b for a, b in zip(streams_k, streams_p))
        print(f"[parity] {label} fp32 prefill logits max|kernel - plain| {logit_err:.3g} "
              f"(tol {LOGIT_TOL}); greedy streams identical {same}/{len(streams_k)} "
              f"({sum(map(len, streams_k))} tokens)")
        check(logit_err <= LOGIT_TOL, f"{label}: fp32 prefill logits differ by {logit_err:.3g}")
        check(same == len(streams_k), f"{label}: fp32 greedy streams differ")
        return streams_k
        results.setdefault("parity", {})[label] = dict(logit_err=logit_err, identical=same,
                                                       n=len(streams_k))

    # ---- 6. sampled serving ----------------------------------------------
    def sampled_phase(model32):
        """Full-width Qwen1.5-0.5B in fp32, both layouts: 16 requests, the
        even ones sampled (temperature 0.8, top-k 50, top-p 0.95, seeds
        1000 + i), the odd ones greedy; streams identical at K = 8 and 1,
        at 8 slots and 4, graphed and eager.  Then the port's threefry bits
        on the card against the CPU, the sampling's time a step, and the
        draws of one full-vocabulary row against the filtered softmax."""
        from repro_torch.serving.engine import _fold_keys, sample_tokens
        from repro_torch.serving.graphs import GraphSet
        from repro_torch.utils import prng

        def run(paged, K, slots, graphed):
            eng = ServingEngine(model32, max_slots=slots, max_len=SERVE_MAX_LEN,
                                decode_block=K, paged=paged, page_size=16, device=dev)
            if not graphed:
                eng._graphs.run = eager_run
            rs = sampled_requests()
            t = serve_once(eng, rs)
            return [r.out_tokens for r in rs], len(eng._graphs.graphs), t

        out = {}
        for paged in (True, False):
            layout = "paged" if paged else "contiguous"
            ref, n_graphs, t_ref = run(paged, 8, 8, True)
            check(ref[0] != ref[1], f"sampled {layout}: request 0 (sampled) gave the stream "
                  f"of request 1 (greedy, the same prompt)")
            legs = {"K=8 slots=8 graphed": dict(graphs=n_graphs, seconds=t_ref)}
            for K, slots, graphed in ((1, 8, True), (8, 4, True), (8, 8, False)):
                got, ng, t = run(paged, K, slots, graphed)
                same = sum(a == b for a, b in zip(ref, got))
                name = f"K={K} slots={slots} {'graphed' if graphed else 'eager'}"
                legs[name] = dict(identical=same, graphs=ng, seconds=t)
                print(f"[sampled] {layout} {name}: streams identical to K=8 slots=8 graphed "
                      f"{same}/{len(ref)}; {ng} graphs; {t:.2f}s")
                check(same == len(ref), f"sampled {layout} {name}: streams differ")
            out[layout] = legs
        # threefry on the card against the same call on the CPU
        V = model32.cfg.vocab_size
        keys_np = np.stack([prng.prng_key(1000 + i) for i in range(8)])
        n_np = (7 * np.arange(8)).astype(np.int32)
        kc = prng.fold_in(prng.as_words(keys_np).to(dev), torch.from_numpy(n_np).to(dev))
        kh = prng.fold_in(prng.as_words(keys_np), torch.from_numpy(n_np))
        bits_same = (torch.equal(kc.cpu(), kh)
                     and torch.equal(prng.random_bits(kc, V).cpu(), prng.random_bits(kh, V))
                     and torch.equal(prng.uniform(kc, V).cpu(), prng.uniform(kh, V)))
        g_c, g_h = prng.gumbel(kc, V).cpu(), prng.gumbel(kh, V)
        g_diff = ((g_c - g_h).abs() / torch.clamp_min(g_h.abs(), 1.0)).max().item()
        print(f"[sampled] threefry on the card vs the CPU: fold_in, bits and uniform "
              f"{'bit-identical' if bits_same else 'DIFFER'} (8 keys x {V}); gumbel max "
              f"|difference| / max(|g|, 1) {g_diff:.3g}")
        check(bits_same, "sampled: threefry bits on the card differ from the CPU's")
        # the sampling's time a step at (8, V): eager, and as one graph replay
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        lg = torch.randn((8, V), generator=gen, device=dev) * 3.0
        temp = torch.full((8,), 0.8, device=dev)
        top_k = torch.full((8,), 50, dtype=torch.int32, device=dev)
        top_p = torch.full((8,), 0.95, device=dev)
        n_dev = torch.from_numpy(n_np).to(dev)
        words = prng.as_words(keys_np).to(dev)

        def body():
            return sample_tokens(lg, _fold_keys(words, n_dev), temp, top_k, top_p)

        gs = GraphSet(dev)
        gs.run("s", body)
        gs.run("s", body)
        samp_eager = timed_ms(body, 20, flush)
        samp_graph = timed_ms(lambda: gs.run("s", body), 20, flush)
        print(f"[sampled] sample_tokens at (8, {V}): {samp_eager:.4f} ms eager, "
              f"{samp_graph:.4f} ms as one graph replay (CUDA events, L2 flushed)")
        # the draws of one row against the filtered softmax (the nucleus of
        # 0.95 keeps 33 ranks, under top-k 50; its edge is 1.27e-5 of mass
        # from the next rank's)
        z = np.random.default_rng(5).standard_normal(V).astype(np.float32)
        row = (z * np.float32(5.0)).astype(np.float32)
        sl = np.sort((torch.from_numpy(row) / torch.tensor(0.8)).double().numpy())[::-1]
        probs = np.exp(sl - sl[0]) / np.exp(sl - sl[0]).sum()
        kept = int(min(50, np.sum(np.cumsum(probs) - probs < 0.95)))
        N, chunk = 16384, 1024
        rank = torch.empty(V, dtype=torch.int64)
        rank[torch.from_numpy(np.argsort(-row, kind="stable"))] = torch.arange(V)
        row_dev = torch.from_numpy(row).to(dev)
        counts = torch.zeros(V, dtype=torch.int64)
        base = prng.as_words(np.tile(prng.prng_key(77), (chunk, 1))).to(dev)
        for c0 in range(0, N, chunk):
            pos = torch.arange(c0, c0 + chunk, dtype=torch.int32, device=dev)
            toks = sample_tokens(row_dev.expand(chunk, V), _fold_keys(base, pos),
                                 torch.full((chunk,), 0.8, device=dev),
                                 torch.full((chunk,), 50, dtype=torch.int32, device=dev),
                                 torch.full((chunk,), 0.95, device=dev))
            counts += torch.bincount(rank[toks.long().cpu()], minlength=V)
        counts = counts.numpy()
        expect = N * probs[:kept] / probs[:kept].sum()
        stat = float(((counts[:kept] - expect) ** 2 / expect).sum())
        df, z6 = kept - 1, 4.753                        # z of the 1e-6 upper tail
        bound = df * (1 - 2 / (9 * df) + z6 * np.sqrt(2 / (9 * df))) ** 3
        outside = int(counts[kept:].sum())
        print(f"[sampled] {N} draws of one row of {V} logits (temperature 0.8, top-k 50, top-p "
              f"0.95: {kept} ranks kept): chi-square {stat:.2f} on {df} degrees of freedom, "
              f"bound {bound:.2f} (the 1e-6 tail); draws outside the kept ranks {outside}")
        check(outside == 0 and stat < bound, "sampled: the draws do not fit the filtered softmax")
        results["sampled"] = dict(streams=out, threefry_bit_identical=bits_same,
                                  gumbel_rel_diff=g_diff, sample_ms_eager=samp_eager,
                                  sample_ms_graph=samp_graph, chi_square=stat,
                                  chi_square_bound=bound, kept=kept, draws=N)

    model32 = Model(dataclasses.replace(cfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    probe = serving_engine(model32, dev)
    first = serving_requests()[:8]
    L = probe._bucket_len(max(len(r.tokens) for r in first))
    tokens, lengths = probe.tok.pad_batch([r.tokens for r in first], -(-L // 16) * 16)
    tokens, lengths = torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev)
    del probe

    def serve_fp32(paged, m=None):
        m = m or model32

        def run():
            logits, _ = m.prefill(tokens, lengths=lengths)
            eng, rs = serving_engine(m, dev, paged=paged), serving_requests()
            eng.serve(rs)
            torch.cuda.synchronize()
            return logits, [r.out_tokens for r in rs]
        return run

    parity("paged", serve_fp32(True))
    parity("contiguous", serve_fp32(False))
    stamp("fp32 serving parity")
    sampled_phase(model32)
    stamp("sampled serving")
    model4_32 = Model(dataclasses.replace(qcfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 3))
    parity("paged-4b", serve_fp32(True, model4_32))

    def speculative_fp32(label, target, draft):
        """Path f in fp32: the half-sampled workload through the speculative
        engine must give the target-only engine's streams, greedy and
        sampled alike (required)."""
        rounding = span_rounding(label, target)
        span_matches_steps(label, target)
        spec, reqs = spec_engine(target, draft), sampled_requests()
        serve_once(spec, reqs)
        tgt, ref = target_only(target), sampled_requests()
        serve_once(tgt, ref)
        div = first_divergence([r.out_tokens for r in ref], [r.out_tokens for r in reqs])
        print(f"[{label}] fp32 speculative vs the target alone: streams identical "
              f"{16 - len(div)}/16 ({sum(len(r.out_tokens) for r in reqs)} tokens; "
              f"{spec.n_rounds} rounds, accept rate {spec.accept_rate():.4f})"
              + (f"; first differing token {div}" if div else ""))
        check(not div, f"{label}: fp32 speculative streams differ from the target alone's: {div}")
        results.setdefault("speculative_fp32", {})[label] = dict(
            identical=16 - len(div), rounds=spec.n_rounds, accept_rate=spec.accept_rate(),
            span_rounding=rounding)

    speculative_fp32("spec-self", model32, model32)
    speculative_fp32("spec-4b", model4_32, model32)
    del model32, model4_32
    torch.cuda.empty_cache()
    stamp("fp32 qwen1.5-4b parity and speculative decoding")
    moe32 = Model(dataclasses.replace(mcfg, n_layers=MOE_FP32_LAYERS, dtype="float32"),
                  device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 4))
    parity("moe-30b-4l", serve_fp32(True, moe32))
    del moe32
    torch.cuda.empty_cache()
    stamp(f"fp32 qwen3-moe-30b-a3b parity ({MOE_FP32_LAYERS} layers)")
    stable32 = Model(dataclasses.replace(scfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 6))
    parity("stablelm", serve_fp32(True, stable32))
    del stable32
    torch.cuda.empty_cache()
    # Nemotron-4-340B's first layer at full width in fp32: 51.6 GB
    nem32 = Model(dataclasses.replace(ncfg, n_layers=NEMOTRON_FP32_LAYERS, dtype="float32"),
                  device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 7))
    nem_label = f"nemotron-{NEMOTRON_FP32_LAYERS}l"
    nem_paged = parity(nem_label, serve_fp32(True, nem32))
    nem_contig = parity(f"{nem_label}-contiguous", serve_fp32(False, nem32))
    same = sum(a == b for a, b in zip(nem_paged, nem_contig))
    print(f"[parity] {nem_label} fp32 greedy streams, paged against contiguous: identical "
          f"{same}/{len(nem_paged)} ({sum(map(len, nem_paged))} tokens)")
    check(same == len(nem_paged), f"{nem_label}: fp32 paged and contiguous streams differ")
    del nem32
    torch.cuda.empty_cache()
    stamp(f"fp32 stablelm-1.6b and nemotron-4-340b ({NEMOTRON_FP32_LAYERS} layer) parity")
    # path l in fp32 at full width and depth: prefill over the 1,536 frames
    # and 32 greedy steps, kernels against plain versions
    ecfg32 = dataclasses.replace(ecfg, dtype="float32")
    enc32 = Model(ecfg32, device=dev).init(torch.Generator(device=dev).manual_seed(SEED + 8))
    e_tokens, e_lengths, e_frames = encdec_inputs(ecfg32, dev, SEED + 8)

    def encdec_fp32():
        logits, streams, _, _, _ = greedy(enc32, e_tokens, n_steps, enc_inputs=e_frames,
                                          lengths=e_lengths, max_len=ENC_MAX_LEN)
        return logits, streams.tolist()

    parity("seamless", encdec_fp32)
    del enc32, e_frames
    torch.cuda.empty_cache()
    # path m's forward in fp32 on Qwen2-VL-72B's first layer at full width:
    # the same embeddings and M-RoPE ids, kernels against plain versions
    vlm32 = Model(dataclasses.replace(vcfg, n_layers=1, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 9))
    vlm_embeds32 = vlm_embeds.float()

    def vlm_fp32():
        with torch.no_grad():
            logits, _ = vlm32.forward(vlm_embeds32, positions=vlm_pos)
        return logits, logits[..., :vcfg.vocab_size].argmax(-1).tolist()

    parity("qwen2-vl-1l", vlm_fp32)
    del vlm32, vlm_embeds, vlm_embeds32
    torch.cuda.empty_cache()
    stamp("fp32 seamless-m4t-large-v2 and qwen2-vl-72b (1 layer) parity")
    rmodel32 = Model(dataclasses.replace(rcfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))

    def rwkv_fp32():
        logits, streams, _, _, _ = greedy(rmodel32, prompts, n_steps)
        return logits, streams.tolist()

    parity("rwkv6", rwkv_fp32)
    del rmodel32
    torch.cuda.empty_cache()
    gmodel32 = Model(dataclasses.replace(gcfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))

    def rgemma_fp32():
        logits, streams, _, _, _ = greedy(gmodel32, g_prompts, n_steps, max_len=g_max_len)
        return logits, streams.tolist()

    parity("recurrentgemma", rgemma_fp32)
    del gmodel32

    stamp("fp32 recurrent parity")
    # paths n and o in fp32 at a narrow width: training through the kernels
    # against training through the plain versions
    narrow_rwkv = dataclasses.replace(rcfg, d_model=256, d_ff=896, n_layers=2,
                                      vocab_size=4096, dtype="float32")
    narrow_hybrid = dataclasses.replace(gcfg, d_model=512, n_heads=2, n_kv_heads=1,
                                        head_dim=256, lru_width=512, d_ff=1024, n_layers=3,
                                        vocab_size=4096, dtype="float32")
    results["train_parity_rwkv6"] = recurrent_train_parity(
        "train-parity-rwkv6", dev, main_path, plain_kernels, narrow_rwkv, 2, N_SEQ)
    results["train_parity_rgemma"] = recurrent_train_parity(
        "train-parity-rgemma", dev, main_path, plain_kernels, narrow_hybrid, 2,
        narrow_hybrid.window + 52)
    stamp("fp32 recurrent training parity")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    results["kernels"] = entries
    results["stamps"] = STAMPS
    (out_dir / "chip_smoke_results.json").write_text(json.dumps(results, indent=1))
    # |kernel − plain| ≤ atol + rtol·|plain| is the check each entry passed, with
    # |plain| taken element by element, or (scale "row") as the max of the
    # output row (the last axis) the element lies in; ``cupti_records_a_call``
    # is the fewest CUPTI records a call of the call's kernels (below 1: records
    # lost, ``cupti_ms`` counts a record a call), and the backward's entries
    # carry their time a call in h1's traced step beside it
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "atol", "rtol",
            "scale", "ms", "cupti_ms", "cupti_records_a_call", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_cupti_ms", "library_cupti_records_a_call",
            "traced_ms")
    for e in entries:
        e.setdefault("scale", "element")
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
